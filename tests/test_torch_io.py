"""``mxtpu_torch.io``'s iterators held to ``mxtpu.io``'s, batch for batch,
across epochs, resets and the ``last_batch`` modes: ``NDArrayIter`` (pad,
discard, roll_over, shuffled under one ``np.random`` seed, dict inputs),
``ResizeIter``, ``PrefetchingIter`` over one and two iterators (reset
after exhaustion, renames), ``CSVIter``, ``LibSVMIter`` (the CSR batch's
data, indices, indptr and dense form), ``MNISTIter`` on idx files written
here, and ``ImageRecordIter`` over raw records (both packages' decode
patched to read raw pixels, so no cv2 is needed). Exact equality: no
arithmetic happens on the way, except MNIST's /256 (exact in float32).
The port's batches are NDArrays on the CPU under ``with mt.cpu():``."""
import gzip
import struct

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu import recordio as jrec
from mxtpu_torch import recordio as trec
from mxtpu_torch.base import MXNetError


def _host(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _batches(it, n=None):
    out = []
    for b in (it if n is None else (it.next() for _ in range(n))):
        out.append(([_host(d) for d in b.data],
                    [_host(lab) for lab in (b.label or [])], b.pad))
    return out


def _same(tb, jb):
    assert len(tb) == len(jb)
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        assert tp == jp
        for a, b in zip(td + tl, jd + jl):
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)


def _data(n=11, dim=3):
    x = np.arange(n * dim, dtype=np.float32).reshape(n, dim)
    y = np.arange(n, dtype=np.float32) * 10
    return x, y


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_the_reference_over_epochs(handle, shuffle):
    x, y = _data()
    np.random.seed(7)
    j = mx.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                          last_batch_handle=handle)
    jb = []
    for _ in range(3):
        jb.append(_batches(j))
        j.reset()
    np.random.seed(7)
    with mt.cpu():
        t = mt.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                              last_batch_handle=handle)
        for epoch in range(3):
            _same(_batches(t), jb[epoch])
            t.reset()
    assert t.provide_data == j.provide_data
    assert t.provide_label == j.provide_label


def test_ndarray_iter_dict_inputs_mid_epoch_reset_and_index():
    x, y = _data(9)
    feeds = ({"a": x, "b": x * 2}, {"lab": y})
    j = mx.io.NDArrayIter(*feeds, batch_size=2, last_batch_handle="roll_over")
    with mt.cpu():
        t = mt.io.NDArrayIter(*feeds, batch_size=2,
                              last_batch_handle="roll_over")
        _same(_batches(t, 2), _batches(j, 2))
        t.reset()
        j.reset()
        _same(_batches(t), _batches(j))
        t.reset()
        j.reset()
        tb, jb = t.next(), j.next()
        np.testing.assert_array_equal(tb.index, jb.index)
    with pytest.raises(MXNetError, match="same length"):
        mt.io.NDArrayIter(x, y[:3])


def test_resize_iter_loops_and_truncates():
    x, y = _data(7)
    j = mx.io.ResizeIter(mx.io.NDArrayIter(x, y, batch_size=3), 5)
    with mt.cpu():
        t = mt.io.ResizeIter(mt.io.NDArrayIter(x, y, batch_size=3), 5)
        _same(_batches(t), _batches(j))
        t.reset()
        j.reset()
        _same(_batches(t), _batches(j))


def test_prefetching_iter_one_source_with_reset_after_exhaustion():
    x, y = _data(10)
    j = mx.io.PrefetchingIter(mx.io.NDArrayIter(x, y, batch_size=3))
    with mt.cpu():
        t = mt.io.PrefetchingIter(mt.io.NDArrayIter(x, y, batch_size=3))
        for _ in range(2):
            got = _batches(t)
            _same(got, _batches(j))
            assert len(got) == 4 and not t.iter_next()
            t.reset()
            j.reset()
        t.close()
    j.close()
    for b in got:
        assert b[0][0].shape == (3, 3)


def test_prefetching_iter_two_sources_merge_and_rename():
    x, y = _data(8)
    ren = [{"data": "a"}, {"data": "b"}]

    def make(pkg):
        return pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(x, y, batch_size=4),
             pkg.io.NDArrayIter(x + 100, y, batch_size=4)], rename_data=ren)

    j = make(mx)
    with mt.cpu():
        t = make(mt)
        assert [d.name for d in t.provide_data] == ["a", "b"] == \
            [d.name for d in j.provide_data]
        _same(_batches(t), _batches(j))
        t.close()
    j.close()


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter(tmp_path, round_batch):
    rng = np.random.RandomState(1)
    data = rng.randint(0, 50, (7, 6)).astype(np.float32)
    label = rng.randint(0, 3, (7, 1)).astype(np.float32)
    dpath, lpath = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    kw = dict(data_csv=str(dpath), data_shape=(2, 3), label_csv=str(lpath),
              batch_size=3, round_batch=round_batch)
    j = mx.io.CSVIter(**kw)
    with mt.cpu():
        t = mt.io.CSVIter(**kw)
        for _ in range(2):
            _same(_batches(t), _batches(j))
            t.reset()
            j.reset()
        assert t.provide_data == j.provide_data


def _libsvm(tmp_path):
    rng = np.random.RandomState(2)
    lines = []
    for i in range(7):
        feats = sorted(rng.choice(10, rng.randint(1, 5), replace=False))
        lines.append("%d %s" % (i % 3, " ".join(
            "%d:%.3f" % (f, rng.rand()) for f in feats)))
    path = tmp_path / "d.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("parts", [(1, 0), (2, 1)])
def test_libsvm_iter_csr_batches(tmp_path, parts):
    path = _libsvm(tmp_path)
    kw = dict(data_libsvm=path, data_shape=(10,), batch_size=3,
              num_parts=parts[0], part_index=parts[1])
    j = mx.io.LibSVMIter(**kw)
    with mt.cpu():
        t = mt.io.LibSVMIter(**kw)
        for _ in range(2):
            for tb, jb in zip(t, j):
                assert tb.pad == jb.pad
                td, jd = tb.data[0], jb.data[0]
                assert td.stype == "csr" and td.shape == jd.shape
                for name in ("data", "indices", "indptr"):
                    np.testing.assert_array_equal(
                        getattr(td, name).asnumpy(),
                        getattr(jd, name).asnumpy())
                np.testing.assert_array_equal(td.asnumpy(),
                                              jd.tostype("default").asnumpy())
                np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                              jb.label[0].asnumpy())
            t.reset()
            j.reset()
    with pytest.raises(MXNetError, match="data_shape"):
        with mt.cpu():
            mt.io.LibSVMIter(path, (5,), 2)


def _mnist(tmp_path, n=13, gz=True):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    ext = ".gz" if gz else ""
    ip = tmp_path / ("img-idx3-ubyte" + ext)
    lp = tmp_path / ("lab-idx1-ubyte" + ext)
    with op(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with op(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())
    return str(ip), str(lp)


@pytest.mark.parametrize("flat,shuffle", [(False, True), (True, False)])
def test_mnist_iter(tmp_path, flat, shuffle):
    ip, lp = _mnist(tmp_path, gz=not flat)
    kw = dict(image=ip, label=lp, batch_size=4, flat=flat, shuffle=shuffle,
              seed=5, silent=True)
    j = mx.io.MNISTIter(**kw)
    with mt.cpu():
        t = mt.io.MNISTIter(**kw)
        _same(_batches(t), _batches(j))
    with pytest.raises(MXNetError, match="unknown options"):
        mt.io.MNISTIter(image=ip, label=lp, bogus=1)


def _raw_decode(self, blob):
    """Raw 8x8x3 pixel records in place of a JPEG decode (both packages)."""
    rec = self._rec_module
    header, payload = rec.unpack(blob)
    img = np.frombuffer(payload, np.uint8).reshape(8, 8, 3)
    return np.asarray(header.label, np.float32).reshape(-1), img


def _raw_records(tmp_path, n=10):
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    rng = np.random.RandomState(4)
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        w.write_idx(i, trec.pack(trec.IRHeader(0, float(i % 4), i, 0),
                                 rng.randint(0, 256, (8, 8, 3))
                                 .astype(np.uint8).tobytes()))
    w.close()
    return rec, idx


@pytest.mark.parametrize("threads", [0, 2])
def test_image_record_iter_over_raw_records(tmp_path, monkeypatch, threads):
    rec, idx = _raw_records(tmp_path)
    import mxtpu.image.image as jimg
    import mxtpu_torch.image.image as timg
    for mod, recmod in ((jimg, jrec), (timg, trec)):
        monkeypatch.setattr(mod.ImageIter, "_rec_module", recmod,
                            raising=False)
        monkeypatch.setattr(mod.ImageIter, "_decode_blob", _raw_decode)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 6, 6),
              batch_size=4, rand_crop=True, rand_mirror=True, mean_r=10.0,
              mean_g=20.0, mean_b=30.0, std_r=2.0, std_g=3.0, std_b=4.0,
              preprocess_threads=threads)
    import random
    random.seed(11)
    j = mx.io.ImageRecordIter(**kw)
    jb = _batches(j)
    random.seed(11)
    with mt.cpu():
        t = mt.io.ImageRecordIter(**kw)
        tb = _batches(t)
    if threads == 0:   # threaded draws interleave in scheduling order
        _same(tb, jb)
    else:
        assert [b[0][0].shape for b in tb] == [b[0][0].shape for b in jb]
        assert [b[2] for b in tb] == [b[2] for b in jb]
    t.close()
    j.close()
    with pytest.raises(MXNetError, match="mean_img"):
        mt.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 6, 6),
                              mean_img="m.bin")
