"""``mxtpu_torch.gluon.data`` held to ``mxtpu.gluon.data``: the samplers
(``RandomSampler`` under one ``np.random`` seed, ``BatchSampler``'s
keep/discard/rollover across epochs), the datasets (``transform``,
``transform_first``, ``RecordFileDataset``), ``DataLoader`` batch for
batch with no workers, two threads and two spawned worker processes, with
``prefetch_to_device`` on the CPU, after a worker killed by the
``worker_death`` fault, and its errors; the vision datasets on small local
files written here (MNIST, Fashion-MNIST, CIFAR-10/100, an image folder of
``.npy`` files, an image record file). Device rules: spawned workers are
other processes and never touch CUDA, and importing the worker module in
a fresh interpreter calls nothing in ``torch.cuda``. Every worker count is
at most 2 and every join has a timeout. Batches are compared exactly."""
import glob
import os
import pickle
import struct
import subprocess
import sys
import gzip

import numpy as np
import pytest
import torch

import mxtpu_torch as mt
from mxtpu import recordio as jrec
from mxtpu.gluon import data as jdata
from mxtpu_torch import recordio as trec
from mxtpu_torch import resilience as tres
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon import data as tdata
from mxtpu_torch.gluon.data import _mp_worker

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _mp_light_datasets import (CrashingDataset, DeviceArrayDataset,  # noqa: E402
                                PidDataset, PlainArrayPairDataset,
                                SlowIOdataset)


@pytest.fixture(autouse=True)
def _fresh():
    tres.reset_faults()
    yield
    tres.reset_faults()


def _host(b):
    if isinstance(b, (list, tuple)):
        return [_host(x) for x in b]
    return b.asnumpy() if hasattr(b, "asnumpy") else np.asarray(b)


def _same(got, ref):
    got, ref = _host(got), _host(ref)
    assert type(got) is type(ref) or not isinstance(got, list)
    if isinstance(ref, list):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
        return
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _shm_segments(pids):
    """The shared-memory segments left by the workers ``pids`` (each
    worker names its segments for its pid)."""
    return {path for pid in pids for path in glob.glob(
        "/dev/shm/%s*" % _mp_worker.segment_prefix(pid))}


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_match_the_reference(last):
    np.random.seed(3)
    jb = jdata.BatchSampler(jdata.RandomSampler(10), 3, last)
    ref = [list(jb) for _ in range(3)] + [len(jb)]
    np.random.seed(3)
    tb = tdata.BatchSampler(tdata.RandomSampler(10), 3, last)
    assert [list(tb) for _ in range(3)] + [len(tb)] == ref
    assert list(tdata.SequentialSampler(4)) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="last_batch"):
        list(tdata.BatchSampler(tdata.SequentialSampler(4), 3, "bogus"))


def test_datasets_and_transforms_match_the_reference():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    y = np.arange(6, dtype=np.float32)
    for lazy in (True, False):
        t = tdata.ArrayDataset(x, y).transform(lambda a, b: (a * 2, b + 1),
                                               lazy=lazy)
        j = jdata.ArrayDataset(x, y).transform(lambda a, b: (a * 2, b + 1),
                                               lazy=lazy)
        assert len(t) == len(j) == 6
        for i in range(6):
            _same(list(t[i]), list(j[i]))
    t = tdata.ArrayDataset(x, y).transform_first(lambda a: a - 1)
    j = jdata.ArrayDataset(x, y).transform_first(lambda a: a - 1)
    _same(list(t[2]), list(j[2]))
    assert tdata.SimpleDataset([5, 6])[1] == 6
    with pytest.raises(MXNetError, match="same length"):
        tdata.ArrayDataset(x, y[:2])


def test_record_file_dataset(tmp_path):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        w.write_idx(i, b"record-%d" % i)
    w.close()
    t, j = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(t) == len(j) == 5
    assert [t[i] for i in range(5)] == [j[i] for i in range(5)]


def _pairs(n=11):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    return x, np.arange(n, dtype=np.int64)


@pytest.mark.parametrize("kw", [
    dict(), dict(shuffle=True), dict(last_batch="discard"),
    dict(last_batch="rollover", shuffle=True),
    dict(num_workers=2, thread_pool=True),
    dict(num_workers=2, thread_pool=True, shuffle=True, prefetch=1),
    dict(prefetch_to_device=mt.cpu(), shuffle=True),
    dict(num_workers=2, thread_pool=True, prefetch_to_device="cpu"),
])
def test_in_process_loaders_match_the_reference(kw):
    x, y = _pairs()
    ref_kw = {k: v for k, v in kw.items() if k != "prefetch_to_device"}
    np.random.seed(5)
    j = jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=4, **ref_kw)
    ref = [[list(b) for b in j] for _ in range(2)]
    np.random.seed(5)
    with mt.cpu():
        t = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                             pin_memory=True, **kw)
        got = [[list(b) for b in t] for _ in range(2)]
    assert len(t) == len(j)
    for g, r in zip(got, ref):
        _same(g, r)
    leaf = got[0][0][0]
    assert isinstance(leaf, mt.nd.NDArray) and leaf.context == mt.cpu()
    assert leaf.dtype == np.float32 and got[0][0][1].dtype == np.int32


def test_loader_stacks_ndarray_samples_and_checks_its_arguments():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    with mt.cpu():
        ds = tdata.SimpleDataset([mt.nd.array(r) for r in x])
        got = [b.asnumpy() for b in tdata.DataLoader(ds, batch_size=4)]
        pre = [b.asnumpy() for b in tdata.DataLoader(
            ds, batch_size=4, prefetch_to_device=True)]
    _same(got, [x[:4], x[4:]])
    _same(pre, got)
    with pytest.raises(ValueError, match="batch_size"):
        tdata.DataLoader(ds)
    with pytest.raises(ValueError, match="batch_sampler"):
        tdata.DataLoader(ds, batch_size=2, batch_sampler=[[0]])


def test_spawned_workers_match_the_reference_and_reuse_the_pool():
    ds = PlainArrayPairDataset(n=30)
    ref = [list(b) for b in jdata.DataLoader(ds, batch_size=8)]
    with mt.cpu():
        dl = tdata.DataLoader(ds, batch_size=8, num_workers=2)
        first = [list(b) for b in dl]
        pool = dl._pool
        second = [list(b) for b in dl]
        assert dl._pool is pool   # persistent across epochs
        pre = tdata.DataLoader(ds, batch_size=8, num_workers=2,
                               prefetch_to_device=mt.cpu())
        third = [list(b) for b in pre]
        pids = {w.pid for w in pool[2]} | {w.pid for w in pre._pool[2]}
        pre.close()
    dl.close()
    for got in (first, second, third):
        _same(got, ref)
    # no segment of these pools' workers is left behind (another
    # process's loaders on this host name theirs for their own pids)
    assert len(pids) == 4 and _shm_segments(pids) == set()


def test_spawned_workers_are_other_processes_and_report_errors():
    with mt.cpu():
        dl = tdata.DataLoader(PidDataset(), batch_size=1, num_workers=2)
        pids = {int(b.asnumpy()[0]) for b in dl}
        workers = dl._pool[2]
        dl.close(timeout=5.0)
    assert os.getpid() not in pids and pids <= {w.pid for w in workers}
    for ds, match in ((CrashingDataset(), "boom at 5"),
                      (DeviceArrayDataset(), "numpy samples")):
        with mt.cpu():
            dl = tdata.DataLoader(ds, batch_size=2, num_workers=1)
            with pytest.raises(RuntimeError, match=match):
                list(dl)
            dl.close(timeout=5.0)


def test_a_killed_worker_is_replaced_and_the_stream_is_unchanged():
    # 50 ms an item, and a first epoch that starts the pool: in the second
    # both workers are busy with queued batches when the fault kills one,
    # so its batch is lost and must be recomputed by the new pool
    ds = SlowIOdataset()
    ref = [b for b in jdata.DataLoader(ds, batch_size=2)]
    with mt.cpu():
        dl = tdata.DataLoader(ds, batch_size=2, num_workers=2)
        _same([b for b in dl], ref)
        tres.set_faults("worker_death@1")
        with pytest.warns(UserWarning, match="worker died"):
            got = [b for b in dl]
        dl.close(timeout=5.0)
    assert tres.FAULT_STATS["fired"] == [("worker_death", 1)]
    assert mt.telemetry.value("dataloader.worker_restarts") >= 1
    _same(got, ref)


def test_worker_batchify_rejects_tensors_and_shm_round_trips():
    with pytest.raises(TypeError, match="numpy samples"):
        _mp_worker.default_mp_batchify_fn([torch.zeros(2), torch.zeros(2)])
    with pytest.raises(TypeError, match="numpy samples"):
        _mp_worker.default_mp_batchify_fn([mt.nd.array(np.zeros(2),
                                                        ctx=mt.cpu())])
    payload = [np.arange(6).reshape(2, 3).astype(np.float32),
               (np.zeros(0, np.int32), np.float64(3.5)), "label"]
    segs = []
    desc = _mp_worker.to_shm(payload, segs)
    for s in segs:
        s.close()
    out = _mp_worker.from_shm(desc, lambda a: a)
    np.testing.assert_array_equal(out[0], payload[0])
    assert out[1][0].shape == (0,) and out[1][1] == 3.5 and out[2] == "label"


def test_worker_import_path_never_touches_cuda():
    """A spawned worker imports the package through ``_mp_worker``: in a
    fresh interpreter nothing on that path may call into ``torch.cuda``
    (each call that initialized CUDA would cost a worker a context)."""
    probe = r"""
import torch, torch.cuda as tc
calls = []
for name in ("_lazy_init", "init", "is_available", "device_count",
             "current_device", "set_device", "get_device_name",
             "current_stream", "synchronize", "Stream", "Event"):
    def wrap(f, name=name):
        def w(*a, **k):
            calls.append(name)
            return f(*a, **k)
        return w
    setattr(tc, name, wrap(getattr(tc, name)))
import mxtpu_torch.gluon.data._mp_worker
import sys
assert "jax" not in sys.modules, "jax imported"
print(calls, tc.is_initialized())
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] False"


# ------------------------------------------------------- vision datasets
def _write_mnist(root, train=True, n=9):
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    names = (("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
             if train else
             ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"))
    os.makedirs(root, exist_ok=True)
    with gzip.open(os.path.join(root, names[0]), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with gzip.open(os.path.join(root, names[1]), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())


def _write_cifar(root, hundred=False):
    rng = np.random.RandomState(7)
    base = os.path.join(root, "cifar-100-python" if hundred
                        else "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    names = ["train", "test"] if hundred else \
        ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]
    for name in names:
        batch = {"data": rng.randint(0, 256, (3, 3072)).astype(np.uint8)}
        if hundred:
            batch["fine_labels"] = list(rng.randint(0, 100, 3))
            batch["coarse_labels"] = list(rng.randint(0, 20, 3))
        else:
            batch["labels"] = list(rng.randint(0, 10, 3))
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(batch, f)


def _same_dataset(t, j):
    assert len(t) == len(j)
    for i in range(len(t)):
        (ti, tl), (ji, jl) = t[i], j[i]
        _same(ti, ji)
        assert tl == jl


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
@pytest.mark.parametrize("train", [True, False])
def test_vision_datasets_read_local_files_like_the_reference(tmp_path, name,
                                                             train):
    root = str(tmp_path / name)
    if "MNIST" in name:
        _write_mnist(root, train)
    else:
        _write_cifar(root, hundred=name == "CIFAR100")
    kw = dict(root=root, train=train)
    j = getattr(jdata.vision, name)(**kw)
    with mt.cpu():
        t = getattr(tdata.vision, name)(**kw)
        _same_dataset(t, j)
        tf = getattr(tdata.vision, name)(
            transform=lambda img, lab: (img, lab + 1), **kw)
        assert tf[0][1] == t[0][1] + 1
    with pytest.raises(MXNetError, match="does not exist"):
        getattr(tdata.vision, name)(root=str(tmp_path / "absent"))


def test_image_folder_of_npy_files(tmp_path):
    rng = np.random.RandomState(8)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / c)
        for i in range(2):
            np.save(tmp_path / c / ("%d.npy" % i),
                    rng.randint(0, 256, (4, 5, 3)).astype(np.uint8))
    (tmp_path / "notes.txt").write_text("not a class")
    j = jdata.vision.ImageFolderDataset(str(tmp_path))
    with mt.cpu():
        t = tdata.vision.ImageFolderDataset(str(tmp_path))
        assert t.synsets == j.synsets == ["cat", "dog"]
        _same_dataset(t, j)


def test_image_record_dataset(tmp_path):
    pytest.importorskip("cv2")
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(9)
    for i in range(3):
        img = rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i), i, 0), img,
                                     img_fmt=".png"))
    w.close()
    j = jdata.vision.ImageRecordDataset(rec)
    t = tdata.vision.ImageRecordDataset(rec)
    for i in range(3):
        (ti, tl), (ji, jl) = t[i], j[i]
        np.testing.assert_array_equal(ti, ji)
        assert tl == jl
