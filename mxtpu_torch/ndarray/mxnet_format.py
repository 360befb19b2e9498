"""Byte-compatible reference NDArray-list serialization (the ``.params``
format real MXNet writes and reads); the port's own copy of
``mxtpu/ndarray/mxnet_format.py``, which it does not import.

Layout (ref: src/ndarray/ndarray.cc:1574-1806):

* file    = u64 magic ``kMXAPINDArrayListMagic`` (0x112) + u64 reserved(0)
            + dmlc vector<NDArray> + dmlc vector<string> names
* vector  = u64 count + elements (strings: u64 length + bytes)
* NDArray = u32 version magic:
    - 0xF993fac9 (V2, ref NDARRAY_V2_MAGIC): i32 storage type, [storage
      shape if sparse], shape, context(i32 dev_type, i32 dev_id), i32
      dtype flag, [per-aux i32 dtype + shape], raw data, [raw aux data]
    - 0xF993fac8 (V1): shape, context, dtype, raw data (dense only)
    - anything else: the magic IS ndim of a u32-dim legacy shape
      (ref LegacyTShapeLoad), then context/dtype/data
* TShape  = u32 ndim + i64 dims (nnvm Tuple::Save; V1 magic marked the
  int64 switch — ndarray.cc:1569)
* dtype flags = mshadow: 0 f32, 1 f64, 2 f16, 3 u8, 4 i32, 5 i8, 6 i64
* storage types (ref include/mxnet/ndarray.h:61): 0 dense, 1 row_sparse
  (1 aux: row indices), 2 csr (2 aux: indptr, indices)

Everything is little-endian (dmlc streams write host byte order; x86/ARM).
bfloat16 has no reference dtype flag — writers upcast it to f32.
"""
from __future__ import annotations

import struct

import numpy as _np

from ..base import MXNetError

LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V1_MAGIC = 0xF993FAC8

_FLAG_TO_DTYPE = {0: _np.float32, 1: _np.float64, 2: _np.float16,
                  3: _np.uint8, 4: _np.int32, 5: _np.int8, 6: _np.int64}
_DTYPE_TO_FLAG = {_np.dtype(v): k for k, v in _FLAG_TO_DTYPE.items()}
_CPU_DEV_TYPE = 1  # Context::kCPU (ref include/mxnet/base.h:90)


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("truncated NDArray file (wanted %d bytes at "
                             "offset %d of %d)" % (n, self.pos,
                                                   len(self.buf)))
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]


def _read_tshape(r, legacy_ndim=None):
    """nnvm Tuple::Save layout; dims are i64 (u32 in the pre-V1 legacy)."""
    if legacy_ndim is not None:
        return tuple(_np.frombuffer(r.take(4 * legacy_ndim),
                                    dtype="<u4").tolist())
    ndim = r.u32()
    return tuple(_np.frombuffer(r.take(8 * ndim), dtype="<i8").tolist())


def _read_raw(r, shape, flag):
    dt = _FLAG_TO_DTYPE.get(flag)
    if dt is None:
        raise MXNetError("unknown mshadow dtype flag %d" % flag)
    n = int(_np.prod(shape, dtype=_np.int64)) if shape else 1
    a = _np.frombuffer(r.take(n * _np.dtype(dt).itemsize), dtype=dt)
    return a.reshape(shape).copy()


def _read_ndarray(r):
    """One NDArray record -> (stype, payload). Dense payload: np array;
    sparse: dict of parts + shape. (ref NDArray::Load / LegacyLoad)"""
    magic = r.u32()
    if magic == _V2_MAGIC:
        stype = r.i32()
        nad = {0: 0, 1: 1, 2: 2}.get(stype)
        if nad is None:
            raise MXNetError("unknown storage type %d" % stype)
        sshape = _read_tshape(r) if nad else None
        shape = _read_tshape(r)
        if len(shape) == 0:
            return "default", _np.zeros((), _np.float32)
        r.i32(), r.i32()  # context (ignored: everything loads to host)
        flag = r.i32()
        aux = [(r.i32(), _read_tshape(r)) for _ in range(nad)]
        data = _read_raw(r, sshape if nad else shape, flag)
        aux_data = [_read_raw(r, ashape, aflag) for aflag, ashape in aux]
        if stype == 0:
            return "default", data
        if stype == 1:
            return "row_sparse", {"values": data, "indices": aux_data[0],
                                  "shape": shape}
        return "csr", {"data": data, "indptr": aux_data[0],
                       "indices": aux_data[1], "shape": shape}
    # legacy dense-only records
    shape = _read_tshape(r) if magic == _V1_MAGIC \
        else _read_tshape(r, legacy_ndim=magic)
    if len(shape) == 0:
        return "default", _np.zeros((), _np.float32)
    r.i32(), r.i32()  # context
    flag = r.i32()
    return "default", _read_raw(r, shape, flag)


def loads(buf):
    """Parse a reference-format NDArray-list blob -> (list of (stype,
    payload), list of names)."""
    r = _Reader(buf)
    if r.u64() != LIST_MAGIC:
        raise MXNetError("not a reference NDArray file (bad 0x112 magic)")
    r.u64()  # reserved
    n = r.u64()
    items = [_read_ndarray(r) for _ in range(n)]
    n_names = r.u64()
    names = [bytes(r.take(r.u64())).decode() for _ in range(n_names)]
    if names and len(names) != len(items):
        raise MXNetError("NDArray file names/data length mismatch")
    return items, names


def _write_tshape(out, shape):
    out.append(struct.pack("<I", len(shape)))
    out.append(_np.asarray(shape, dtype="<i8").tobytes())


def ref_encodable(dtype):
    """True when the reference format stores this dtype losslessly."""
    try:
        return _np.dtype(dtype) in _DTYPE_TO_FLAG
    except TypeError:
        return False  # bfloat16 et al: no numpy name


def _np_for_save(a):
    shape = _np.shape(a)
    # ascontiguousarray promotes 0-d to (1,); reshape restores the rank
    a = _np.ascontiguousarray(a).reshape(shape)
    if a.dtype not in _DTYPE_TO_FLAG:
        if a.dtype.name == "bfloat16" or a.dtype.kind == "f":
            a = a.astype(_np.float32)  # no reference flag: documented upcast
        elif a.dtype.kind in "iub":
            a = a.astype(_np.int64)
        else:
            raise MXNetError("dtype %s has no reference encoding" % a.dtype)
    return a


def _write_dense(out, a):
    a = _np_for_save(a)
    if a.ndim == 0:
        # a 0-ndim TShape means "none" to the reference reader
        # (ndarray.cc Load: shape.ndim()==0 -> empty NDArray, no payload
        # follows); reference scalars are shape (1,)
        raise MXNetError("rank-0 arrays have no reference encoding; "
                         "reshape to (1,) or use format='mxtpu'")
    out.append(struct.pack("<I", _V2_MAGIC))
    out.append(struct.pack("<i", 0))
    _write_tshape(out, a.shape)
    out.append(struct.pack("<ii", _CPU_DEV_TYPE, 0))
    out.append(struct.pack("<i", _DTYPE_TO_FLAG[a.dtype]))
    out.append(a.tobytes())


def _write_sparse(out, stype, parts):
    if stype == "row_sparse":
        vals = _np_for_save(parts["values"])
        aux = [_np_for_save(parts["indices"]).astype(_np.int64)]
        stype_i = 1
    else:
        vals = _np_for_save(parts["data"])
        aux = [_np_for_save(parts["indptr"]).astype(_np.int64),
               _np_for_save(parts["indices"]).astype(_np.int64)]
        stype_i = 2
    shape = tuple(parts["shape"])
    out.append(struct.pack("<I", _V2_MAGIC))
    out.append(struct.pack("<i", stype_i))
    _write_tshape(out, vals.shape)   # storage shape
    _write_tshape(out, shape)
    out.append(struct.pack("<ii", _CPU_DEV_TYPE, 0))
    out.append(struct.pack("<i", _DTYPE_TO_FLAG[vals.dtype]))
    for a in aux:
        out.append(struct.pack("<i", _DTYPE_TO_FLAG[a.dtype]))
        _write_tshape(out, a.shape)
    out.append(vals.tobytes())
    for a in aux:
        out.append(a.tobytes())


def dumps(items, names):
    """Serialize [(stype, payload)] + names to the reference byte format."""
    out = [struct.pack("<QQ", LIST_MAGIC, 0), struct.pack("<Q", len(items))]
    for stype, payload in items:
        if stype == "default":
            _write_dense(out, payload)
        else:
            _write_sparse(out, stype, payload)
    out.append(struct.pack("<Q", len(names)))
    for name in names:
        b = name.encode()
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    return b"".join(out)
