"""NDArray files (counterpart of ``mxtpu/ndarray/utils.py``; ref:
src/ndarray/ndarray.cc Save/Load, python surface mx.nd.save/load).

Two on-disk formats, told apart by their magic on load:

* the REFERENCE format (u64 magic 0x112 and versioned records,
  ``mxnet_format.py``), byte-compatible with the files MXNet and the JAX
  package write and read. ``save`` writes it whenever every array has a
  reference dtype and a rank above 0, so ``.params`` files interchange
  both ways;
* the native format of the JAX package (magic ``MXTPU001``, a JSON header,
  raw buffers), written for bfloat16 (which the reference's dtype table
  lacks: its buffer holds the values as float32, as the JAX package
  writes them) and rank-0 arrays, or on request (``format="mxtpu"``). The
  header and buffers are byte for byte the JAX package's.

Arrays load onto the current context (``with ctx:``; ``cuda:0`` outside
one). Sparse arrays (``row_sparse``, ``csr``) are written and read as
the JAX package writes and reads them: in the reference format, one
record of their parts each; in the native one, an entry whose parts
follow one another.
"""
from __future__ import annotations

import json
import struct

import numpy as _np
import torch

from ..base import MXNetError
from . import mxnet_format
from .ndarray import NDArray, array
from .sparse import BaseSparseNDArray, _deserialize_parts

__all__ = ["save", "load"]

_MAGIC = b"MXTPU001"


def _host(arr):
    """(C-ordered host array, dtype name) of an NDArray; bfloat16 as its
    float32 values."""
    d = arr._data.detach()
    if d.dtype == torch.bfloat16:
        return d.float().cpu().numpy(), "bfloat16"
    a = d.cpu().numpy()
    return _np.ascontiguousarray(a).reshape(a.shape), a.dtype.name


def save(fname, data, format=None):  # noqa: A002 - the reference's name
    """Save NDArrays (one, a list or a dict) to ``fname`` (ref: mx.nd.save).

    ``format``: ``"mxnet"`` the reference byte format (0x112), ``"mxtpu"``
    the native one, ``None`` the reference format unless an array needs a
    dtype it cannot encode (bfloat16) or has rank 0, then native."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        names = [""] * len(data)
        arrays = list(data)
    else:
        raise MXNetError("save expects NDArray, list, or dict")
    if not all(isinstance(a, NDArray) for a in arrays):
        raise MXNetError("save expects NDArrays")
    if format is None:
        format = "mxnet" if all(mxnet_format.ref_encodable(a.dtype)
                                and len(a.shape) > 0
                                for a in arrays) else "mxtpu"
    if format == "mxnet":
        items = []
        for arr in arrays:
            if isinstance(arr, BaseSparseNDArray):
                parts = dict(arr._serialize_parts())
                parts["shape"] = arr.shape
                items.append((arr.stype, parts))
            else:
                items.append(("default", _host(arr)[0]))
        blob = mxnet_format.dumps(
            items, names if isinstance(data, dict) else [])
        with open(fname, "wb") as f:
            f.write(blob)
        return
    if format != "mxtpu":
        raise MXNetError("unknown save format %r" % (format,))
    entries, blobs, offset = [], [], 0
    for name, arr in zip(names, arrays):
        if isinstance(arr, BaseSparseNDArray):
            part_entries = []
            for pname, pa in arr._serialize_parts():
                b = pa.tobytes()
                part_entries.append({"part": pname, "dtype": str(pa.dtype),
                                     "shape": list(pa.shape),
                                     "offset": offset, "nbytes": len(b)})
                blobs.append(b)
                offset += len(b)
            entries.append({"name": name, "stype": arr.stype,
                            "shape": list(arr.shape), "parts": part_entries})
            continue
        a, dt = _host(arr)
        b = a.tobytes()
        entries.append({"name": name, "stype": "default", "dtype": dt,
                        "shape": list(a.shape), "offset": offset,
                        "nbytes": len(b)})
        blobs.append(b)
        offset += len(b)
    header = json.dumps({"entries": entries,
                         "named": isinstance(data, dict)}).encode()
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for b in blobs:
            f.write(b)


def load(fname):
    """Load the NDArrays of ``fname`` (ref: mx.nd.load): a list, or a dict
    when the file names them. Reads both formats."""
    with open(fname, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            if struct.unpack("<Q", magic.ljust(8, b"\0"))[0] == \
                    mxnet_format.LIST_MAGIC:
                return _load_mxnet(magic + f.read())
            raise MXNetError("invalid NDArray file %s (bad magic)" % fname)
        head = f.read(8)
        if len(head) != 8:
            raise MXNetError("truncated NDArray file %s" % fname)
        (hlen,) = struct.unpack("<Q", head)
        header = json.loads(f.read(hlen).decode())
        payload = f.read()
    def part(pe):
        count = int(_np.prod(pe["shape"], dtype=_np.int64)) \
            if pe["shape"] else 1
        np_dt = _np.dtype(pe["dtype"])
        if pe["offset"] + count * np_dt.itemsize > len(payload):
            raise MXNetError("truncated NDArray file %s" % fname)
        return _np.frombuffer(payload, dtype=np_dt, count=count,
                              offset=pe["offset"]).reshape(pe["shape"])

    out = []
    for e in header["entries"]:
        if e["stype"] != "default":
            parts = {pe["part"]: part(pe) for pe in e["parts"]}
            out.append((e["name"], _deserialize_parts(
                e["stype"], tuple(e["shape"]), parts)))
            continue
        dt = e["dtype"]
        np_dt = _np.float32 if dt == "bfloat16" else _np.dtype(dt)
        count = int(_np.prod(e["shape"], dtype=_np.int64)) \
            if e["shape"] else 1
        if e["offset"] + count * _np.dtype(np_dt).itemsize > len(payload):
            raise MXNetError("truncated NDArray file %s" % fname)
        a = _np.frombuffer(payload, dtype=np_dt, count=count,
                           offset=e["offset"]).reshape(e["shape"])
        nd = array(a)
        out.append((e["name"], nd.astype("bfloat16") if dt == "bfloat16"
                    else nd))
    if header["named"]:
        return dict(out)
    return [v for _, v in out]


def _load_mxnet(buf):
    """Reference-format blob -> list or dict of NDArrays."""
    items, names = mxnet_format.loads(buf)
    arrays = []
    for stype, payload in items:
        if stype == "default":
            arrays.append(array(payload))
        else:
            shape = tuple(int(d) for d in payload.pop("shape"))
            arrays.append(_deserialize_parts(stype, shape, payload))
    if names:
        return dict(zip(names, arrays))
    return arrays
