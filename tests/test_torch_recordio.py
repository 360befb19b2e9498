"""``mxtpu_torch.recordio`` held to ``mxtpu.recordio``: the files the port
writes are byte-equal to the reference's (plain records, records that
hold the magic word and are cut into chunks, the ``.idx`` sidecar), each
package reads the other's files, positioned reads equal sequential ones,
``pack``/``unpack`` agree with scalar and array labels, and the image
helpers raise naming cv2 when it is missing (the image round trip runs
only where cv2 is installed)."""
import pickle
import struct
import sys
import threading

import numpy as np
import pytest

from mxtpu import recordio as jrec
from mxtpu_torch import recordio as trec
from mxtpu_torch.base import MXNetError

_MAGIC = struct.pack("<I", 0xced7230a)


def _payloads(n=17, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        body = rng.randint(0, 256, rng.randint(0, 40)).astype(np.uint8)
        raw = body.tobytes()
        if i % 5 == 1:       # the magic word inside: a chunked record
            raw = raw[:8] + _MAGIC + raw[8:] + _MAGIC
        if i % 7 == 3:
            raw = _MAGIC + raw
        out.append(raw)
    out.append(b"")
    return out


def _write_seq(mod, path, payloads):
    w = mod.MXRecordIO(str(path), "w")
    for p in payloads:
        w.write(p)
    w.close()


def _write_idx(mod, rec, idx, payloads, labels=False):
    w = mod.MXIndexedRecordIO(str(idx), str(rec), "w")
    for i, p in enumerate(payloads):
        if labels:
            label = float(i) if i % 2 else np.arange(i % 4 + 1) * 0.5
            p = mod.pack(mod.IRHeader(0, label, i, i * 3), p)
        w.write_idx(i, p)
    w.close()


def _read_all(mod, path):
    r = mod.MXRecordIO(str(path), "r")
    out = []
    while True:
        b = r.read()
        if b is None:
            break
        out.append(b)
    r.close()
    return out


def test_sequential_files_byte_equal_and_cross_readable(tmp_path):
    pays = _payloads()
    _write_seq(jrec, tmp_path / "j.rec", pays)
    _write_seq(trec, tmp_path / "t.rec", pays)
    assert (tmp_path / "j.rec").read_bytes() == \
        (tmp_path / "t.rec").read_bytes()
    assert _read_all(trec, tmp_path / "j.rec") == pays
    assert _read_all(jrec, tmp_path / "t.rec") == pays


@pytest.mark.parametrize("labels", [False, True])
def test_indexed_files_byte_equal_and_keyed_reads(tmp_path, labels):
    pays = _payloads(seed=1)
    _write_idx(jrec, tmp_path / "j.rec", tmp_path / "j.idx", pays, labels)
    _write_idx(trec, tmp_path / "t.rec", tmp_path / "t.idx", pays, labels)
    for ext in ("rec", "idx"):
        assert (tmp_path / ("j." + ext)).read_bytes() == \
            (tmp_path / ("t." + ext)).read_bytes()
    j = jrec.MXIndexedRecordIO(str(tmp_path / "j.idx"),
                               str(tmp_path / "j.rec"), "r")
    t = trec.MXIndexedRecordIO(str(tmp_path / "j.idx"),
                               str(tmp_path / "j.rec"), "r")
    assert t.keys == j.keys and t.idx == j.idx
    for k in reversed(t.keys):
        assert t.read_idx(k) == j.read_idx(k) == t.pread_idx(k)
    if labels:
        for k in t.keys:
            th, tp = trec.unpack(t.read_idx(k))
            jh, jp = jrec.unpack(j.read_idx(k))
            assert tp == jp and th.id == jh.id and th.id2 == jh.id2
            assert th.flag == jh.flag
            np.testing.assert_array_equal(np.asarray(th.label),
                                          np.asarray(jh.label))
    j.close()
    t.close()


def test_positioned_read_keeps_the_offset_and_shares_one_handle(tmp_path):
    pays = _payloads(40, seed=2)
    _write_idx(trec, tmp_path / "t.rec", tmp_path / "t.idx", pays)
    r = trec.MXIndexedRecordIO(str(tmp_path / "t.idx"),
                               str(tmp_path / "t.rec"), "r")
    first = r.read()
    pos = r.tell()
    assert r.pread_idx(17) == pays[17]
    assert r.tell() == pos and r.read() == pays[1] and first == pays[0]
    got = {}

    def reader(ks):
        for k in ks:
            got[k] = r.pread_idx(k)

    threads = [threading.Thread(target=reader, args=(list(range(i, 41, 4)),))
               for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert all(got[k] == pays[k] for k in range(41))
    r.close()


def test_pack_unpack_match_the_reference():
    for label in (3.5, [1.0, 2.0, 3.0], np.arange(5, dtype=np.float32)):
        for header in ((0, label, 7, 9), (0, label, 1 << 40, 0)):
            tb = trec.pack(trec.IRHeader(*header), b"payload")
            jb = jrec.pack(jrec.IRHeader(*header), b"payload")
            assert tb == jb
            th, tp = trec.unpack(tb)
            jh, jp = jrec.unpack(jb)
            assert tp == jp == b"payload"
            np.testing.assert_array_equal(np.asarray(th.label),
                                          np.asarray(jh.label))
            assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)


def test_truncated_file_stops_as_corrupt(tmp_path):
    pays = _payloads(5, seed=3)
    _write_seq(trec, tmp_path / "t.rec", pays)
    data = (tmp_path / "t.rec").read_bytes()
    (tmp_path / "cut.rec").write_bytes(data[:-3])
    r = trec.MXRecordIO(str(tmp_path / "cut.rec"), "r")
    got = []
    while True:
        b = r.read()
        if b is None:
            break
        got.append(b)
    assert got == pays[:-1] and r.handle.corrupt   # the empty last record


def test_indexed_reader_pickles_and_reopens(tmp_path):
    pays = _payloads(6, seed=4)
    _write_idx(trec, tmp_path / "t.rec", tmp_path / "t.idx", pays)
    r = trec.MXIndexedRecordIO(str(tmp_path / "t.idx"),
                               str(tmp_path / "t.rec"), "r")
    clone = pickle.loads(pickle.dumps(r))
    assert clone.keys == r.keys and clone.read_idx(4) == pays[4]
    with pytest.raises(MXNetError, match="invalid flag"):
        trec.MXRecordIO(str(tmp_path / "x.rec"), "a")


def test_image_helpers_raise_naming_cv2_when_it_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(MXNetError, match="cv2"):
        trec.pack_img(trec.IRHeader(0, 1.0, 0, 0),
                      np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(MXNetError, match="cv2"):
        trec.unpack_img(trec.pack(trec.IRHeader(0, 1.0, 0, 0), b"x"))


def test_image_round_trip_matches_the_reference():
    pytest.importorskip("cv2")
    img = np.random.RandomState(5).randint(0, 256, (6, 5, 3)) \
        .astype(np.uint8)
    hdr = (0, 2.0, 3, 0)
    tb = trec.pack_img(trec.IRHeader(*hdr), img, img_fmt=".png")
    jb = jrec.pack_img(jrec.IRHeader(*hdr), img, img_fmt=".png")
    assert tb == jb
    np.testing.assert_array_equal(trec.unpack_img(tb)[1], img)
