"""mx.recordio: RecordIO file API (counterpart of ``mxtpu/recordio.py``).

Reference: ``python/mxnet/recordio.py`` -- MXRecordIO / MXIndexedRecordIO
over the dmlc recordio reader, plus pack/unpack(+_img) helpers with the
IRHeader struct.

The port reads and writes the wire format in Python only (the JAX
package's pure-Python reader and writer); its ctypes-bound C++ reader is
ROADMAP A10. The files written are byte-identical to the reference's.
``pack_img``/``unpack_img`` import ``cv2`` when called and raise
``MXNetError`` naming it when it is missing.
"""
from __future__ import annotations

import os
import struct
import threading
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _MAGIC)


class _PyWriter:
    def __init__(self, path, mode):
        self._f = open(path, mode)

    def write(self, data):
        cuts = [i for i in range(0, len(data) - 3, 4)
                if data[i:i + 4] == _MAGIC_BYTES]
        if not cuts:
            self._chunk(0, data)
            return
        begin = 0
        for c, end in enumerate(cuts + [len(data)]):
            cflag = 1 if c == 0 else (3 if end == len(data) else 2)
            self._chunk(cflag, data[begin:end])
            begin = end + 4

    def _chunk(self, cflag, data):
        lrec = (cflag << 29) | len(data)
        self._f.write(_MAGIC_BYTES)
        self._f.write(struct.pack("<I", lrec))
        self._f.write(data)
        pad = (4 - (len(data) & 3)) & 3
        self._f.write(b"\x00" * pad)

    def tell(self):
        return self._f.tell()

    def close(self):
        self._f.close()


class _PyReader:
    corrupt = False  # set when a read stops on damage rather than clean EOF

    def __init__(self, path):
        self._f = open(path, "rb")

    def _walk(self, read):
        """One record-framing walk (magic check, the cflag chunk state
        machine, pad skip) shared by the sequential and positioned reads;
        ``read(n)`` supplies the next n bytes and owns its position."""
        out = b""
        started = False
        while True:
            head = read(8)
            if len(head) == 0 and not started:
                return None  # clean EOF at a record boundary
            if len(head) < 8:
                self.corrupt = True  # truncated mid-header
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                self.corrupt = True  # lost sync
                return None
            length, cflag = lrec & ((1 << 29) - 1), lrec >> 29
            data = read(length)
            if len(data) < length:
                self.corrupt = True  # truncated mid-payload
                return None
            pad = (4 - (length & 3)) & 3
            if pad:
                read(pad)
            out += data
            if cflag == 0 or cflag == 3:
                return out
            if cflag == 1:
                started = True
            elif not started:
                return None
            out += _MAGIC_BYTES  # the magic elided between chunks

    def read(self):
        return self._walk(self._f.read)

    def read_at(self, pos):
        """Positioned read of one record at byte ``pos`` (pread: the
        handle's shared offset is never touched, so any number of threads
        share one open file with no lock)."""
        fd = self._f.fileno()
        state = {"pos": pos}

        def pread(n):
            b = os.pread(fd, n, state["pos"])
            state["pos"] += len(b)
            return b

        return self._walk(pread)

    def seek(self, pos):
        self._f.seek(pos)

    def tell(self):
        return self._f.tell()

    def close(self):
        self._f.close()


class MXRecordIO:
    """Sequential RecordIO reader/writer (ref: recordio.py:MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = _PyWriter(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = _PyReader(self.uri)
            self.writable = False
        else:
            raise MXNetError("invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self.handle.close()
        self.is_open = False
        self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter-exit timing
            pass

    def __getstate__(self):
        """Pickling for spawned loader workers: the handle reopens there."""
        d = dict(self.__dict__)
        d["handle"] = None
        d["is_open"] = False
        d.pop("_rw_lock", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if hasattr(self, "idx_path"):
            self._rw_lock = threading.Lock()
        self.open()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self.handle.write(bytes(buf))

    def read(self):
        assert not self.writable
        return self.handle.read()

    def tell(self):
        return self.handle.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Keyed random access through a ``.idx`` sidecar (ref: recordio.py:
    MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        # seek + read must be atomic: thread-pool loader workers share
        # this handle
        self._rw_lock = threading.Lock()
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write("%s\t%d\n" % (str(key), self.idx[key]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        with self._rw_lock:
            self.seek(idx)
            return self.read()

    def pread_idx(self, idx):
        """Positioned keyed read (``_PyReader.read_at``): no shared offset
        moves and no lock is taken, so the stream's shard readers fan
        any number of threads over one open handle."""
        assert not self.writable
        return self.handle.read_at(self.idx[idx])

    def write_idx(self, idx, buf):
        assert self.writable
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.keys.append(key)
        self.idx[key] = pos


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header and raw bytes (ref: recordio.py:pack). A label array
    goes before the payload as float32, its length in ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, (np.ndarray, list, tuple)):
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """Inverse of pack: (IRHeader, payload bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise MXNetError("image encoding and decoding need OpenCV (the cv2 "
                         "module), which is not installed: %s" % e) from e
    return cv2


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """JPEG/PNG-encode an image and pack it (ref: recordio.py:pack_img)."""
    cv2 = _cv2()
    encode_params = None
    if img_fmt.lower() in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt.lower() == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    if not ret:
        raise MXNetError("failed to encode image")
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """Unpack and decode an image record (ref: recordio.py:unpack_img):
    (IRHeader, HWC BGR numpy array, cv2's convention)."""
    cv2 = _cv2()
    header, s = unpack(s)
    img = cv2.imdecode(np.frombuffer(s, dtype=np.uint8), iscolor)
    return header, img
