"""``mxtpu_torch.io.stream`` held to ``mxtpu.io.stream``: ``shard_keys``,
``ShardedRecordReader`` (inline and two threads, epochs, shards that do
not divide the index, ``last_batch='discard'``), ``StreamRecordIter``
(epochs, mid-epoch resets, host mode) and ``DevicePrefetcher`` give the
reference's batches exactly, also after an injected ``worker_death`` or
``prefetch_death`` (each fires in its own stage and the stream equals the
unfaulted one). Device rules on the CPU: the prefetcher's default device
is ``cuda:0`` and it raises without a card unless a CPU device is given; a
mesh placement or a Trainer's ``batch_sharding`` raises naming A8; the
reference's environment levers are constructor arguments with its
defaults, and setting the variables changes nothing in the port. The JAX
side's levers are set with ``monkeypatch.setenv`` only."""
import threading
import time

import numpy as np
import pytest
import torch

import mxtpu_torch as mt
from mxtpu import recordio as jrec
from mxtpu import resilience as jres
from mxtpu import telemetry as jtel
from mxtpu.io import stream as js
from mxtpu_torch import recordio as trec
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.base import MXNetError
from mxtpu_torch.io import stream as ts

SHAPE = (3, 4, 4)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("MXTPU_FAULT_INJECT", "MXTPU_PREFETCH_DEPTH",
                "MXTPU_STREAM_THREADS", "MXTPU_DL_WORKER_RESTARTS"):
        monkeypatch.delenv(var, raising=False)
    for res, tel in ((jres, jtel), (tres, ttel)):
        res.reset_faults()
        tel.reset()
    yield
    for res, tel in ((jres, jtel), (tres, ttel)):
        res.reset_faults()
        tel.reset()


def _write_rec(tmp_path, n=23):
    rec, idx = str(tmp_path / "s.rec"), str(tmp_path / "s.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        payload = rng.randint(0, 255, SHAPE).astype(np.uint8)
        w.write_idx(i, trec.pack(trec.IRHeader(0, float(i), i, 0),
                                 payload.tobytes()))
    w.close()
    return rec, idx


def _decode(mod):
    def dec(raw):
        header, payload = mod.unpack(raw)
        return (np.frombuffer(payload, np.uint8).reshape(SHAPE)
                .astype(np.float32), np.float32(header.label))
    return dec


def _host(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same_stream(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g if isinstance(g, (tuple, list)) else (g,)
        r = r if isinstance(r, (tuple, list)) else (r,)
        for a, b in zip(g, r):
            a, b = _host(a), _host(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,shards,shuffle", [(23, 1, True), (23, 4, True),
                                              (10, 3, False), (5, 7, True)])
def test_shard_keys_match_the_reference(n, shards, shuffle):
    keys = list(range(100, 100 + n))
    for epoch in range(3):
        parts = []
        for i in range(shards):
            got = ts.shard_keys(keys, shards, i, epoch, 9, shuffle)
            assert got == js.shard_keys(keys, shards, i, epoch, 9, shuffle)
            parts += got
        assert sorted(parts) == keys
    with pytest.raises(MXNetError):
        ts.shard_keys(keys, 2, 2)


@pytest.mark.parametrize("threads", [0, 2])
@pytest.mark.parametrize("shards,last", [((1, 0), "keep"),
                                         ((3, 2), "keep"),
                                         ((1, 0), "discard")])
def test_reader_streams_equal_the_reference(tmp_path, threads, shards, last):
    rec, _ = _write_rec(tmp_path)
    kw = dict(batch_size=4, num_shards=shards[0], shard_index=shards[1],
              seed=2, last_batch=last, num_threads=threads)
    t = ts.ShardedRecordReader(rec, decode_fn=_decode(trec), **kw)
    j = js.ShardedRecordReader(rec, decode_fn=_decode(jrec), **kw)
    for _ in range(3):   # each pass is one epoch, reshuffled
        assert len(t) == len(j)
        _same_stream(list(t), list(j))
    assert t.epoch == j.epoch == 3
    t.set_epoch(1)
    j.set_epoch(1)
    _same_stream(list(t), list(j))
    t.close()
    j.close()


def test_reader_raw_bytes_and_decode_errors(tmp_path):
    rec, idx = _write_rec(tmp_path, n=6)
    t = ts.ShardedRecordReader(rec, idx, batch_size=4, shuffle=False)
    j = js.ShardedRecordReader(rec, idx, batch_size=4, shuffle=False)
    assert list(t) == list(j)

    def bad(raw):
        raise ValueError("boom")

    with pytest.raises(RuntimeError, match="failed at batch 0"):
        list(ts.ShardedRecordReader(rec, batch_size=4, decode_fn=bad))
    with pytest.raises(MXNetError, match="last_batch"):
        ts.ShardedRecordReader(rec, last_batch="pad")


def test_reader_worker_death_recovers_to_the_reference_stream(
        tmp_path, monkeypatch):
    rec, _ = _write_rec(tmp_path)
    clean = list(ts.ShardedRecordReader(rec, batch_size=4, seed=2,
                                        decode_fn=_decode(trec)))
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "worker_death@2")
    ref = list(js.ShardedRecordReader(rec, batch_size=4, seed=2,
                                      decode_fn=_decode(jrec)))
    tres.set_faults("worker_death@2")
    got = list(ts.ShardedRecordReader(rec, batch_size=4, seed=2,
                                      decode_fn=_decode(trec)))
    assert tres.FAULT_STATS["fired"] == [("worker_death", 2)]
    assert ttel.value("stream.worker_restarts") >= 1
    _same_stream(got, clean)
    _same_stream(got, ref)


def test_reader_worker_death_budget(tmp_path):
    rec, _ = _write_rec(tmp_path)
    tres.set_faults("worker_death@0")
    rd = ts.ShardedRecordReader(rec, batch_size=4, decode_fn=_decode(trec),
                                max_restarts=0)
    with pytest.raises(RuntimeError, match="giving up after 0"):
        list(rd)


def _src(n=7):
    return [(np.full((4, 3), float(i)), np.full((4,), float(i)),
             np.arange(3, dtype=np.int64) + i) for i in range(n)]


def test_prefetcher_on_the_cpu_equals_the_reference():
    src = _src()
    ref = list(js.DevicePrefetcher(iter(src), depth=2))
    pf = ts.DevicePrefetcher(iter(src), depth=2, sharding=mt.cpu())
    got = list(pf)
    pf.close()
    for item in got:
        assert all(isinstance(x, mt.nd.NDArray) and x.context == mt.cpu()
                   for x in item)
    _same_stream(got, ref)   # float64 -> float32, int64 -> int32 in both
    snap = ttel.snapshot()
    assert snap["histograms"]["data.h2d"]["count"] == 7
    assert snap["gauges"]["data.prefetch_depth"] == 2
    assert pf._device == torch.device("cpu") and pf.pinned_bytes == 0


def test_prefetcher_follows_the_callers_cpu_scope_on_its_thread():
    x, y = np.arange(20.0).reshape(10, 2), np.arange(10.0)
    with mt.cpu():
        it = mt.io.NDArrayIter(x, y, batch_size=4)
        pf = ts.DevicePrefetcher(it)
        got = list(pf)
        pf.close()
    assert [b.data[0].context for b in got] == [mt.cpu()] * 3
    np.testing.assert_array_equal(got[1].data[0].asnumpy(), x[4:8])


def test_prefetcher_starvation_is_counted_and_waited():
    gate = threading.Event()

    def slow():
        for i in range(2):
            gate.wait(timeout=10)
            gate.clear()
            yield np.full((2,), float(i))

    pf = ts.DevicePrefetcher(slow(), sharding="cpu")
    out = []
    t = threading.Thread(target=lambda: out.append(next(pf)))
    t.start()
    deadline = time.perf_counter() + 10
    while ttel.value("data.starved") < 1:
        assert time.perf_counter() < deadline
        time.sleep(0.005)
    gate.set()
    t.join(timeout=10)
    assert out and float(out[0].asnumpy()[0]) == 0.0
    assert ttel.snapshot()["histograms"]["data.wait"]["count"] >= 1
    gate.set()
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetch_death_restarts_on_the_same_source(monkeypatch):
    src = [np.full((2,), float(i)) for i in range(5)]
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "prefetch_death@1")
    ref = [float(v.asnumpy()[0]) for v in js.DevicePrefetcher(iter(src))]
    tres.set_faults("prefetch_death@1")
    pf = ts.DevicePrefetcher(iter(src), sharding=mt.cpu())
    vals = [float(v.asnumpy()[0]) for v in pf]
    pf.close()
    assert vals == ref == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert ttel.value("data.prefetch_restarts") == 1
    tres.set_faults("prefetch_death@0")
    pf = ts.DevicePrefetcher(iter(src), sharding=mt.cpu(), max_restarts=0)
    with pytest.raises(RuntimeError, match="giving up after 0"):
        list(pf)
    pf.close()


def test_prefetcher_errors_close_and_depth_clamp():
    def src():
        yield np.zeros(2)
        raise ValueError("decode exploded")

    pf = ts.DevicePrefetcher(src(), sharding=mt.cpu())
    next(pf)
    with pytest.raises(ValueError, match="decode exploded"):
        next(pf)
    pf.close()
    pf = ts.DevicePrefetcher(iter([np.zeros(1)] * 3), depth=0,
                             sharding=mt.cpu())
    assert len(list(pf)) == 3
    pf.close()
    closed = []

    def endless():
        try:
            while True:
                yield np.zeros(2)
        finally:
            closed.append(True)

    pf = ts.DevicePrefetcher(endless(), sharding=mt.cpu())
    next(pf)
    t0 = time.perf_counter()
    pf.close(timeout=5.0)
    assert time.perf_counter() - t0 < 5 and closed == [True]
    with pytest.raises(StopIteration):
        next(pf)


def test_stream_record_iter_epochs_and_resets_equal_the_reference(tmp_path):
    rec, _ = _write_rec(tmp_path)
    kw = dict(batch_size=4, seed=3)

    def labels(it, n=None):
        out = []
        for _ in range(len(it._reader) if n is None else n):
            out.append(_host(it.next().label[0]).copy())
        return out

    j = js.StreamRecordIter(rec, decode_fn=_decode(jrec), **kw)
    t = ts.StreamRecordIter(rec, decode_fn=_decode(trec), sharding="cpu",
                            **kw)
    assert t.provide_data[0].shape == j.provide_data[0].shape == (4,) + SHAPE
    assert t.provide_label[0].shape == (4,)
    for n in (None, 2, None, 5, None):   # whole epochs and abandoned ones
        _same_stream(labels(t, n), labels(j, n))
        t.reset()
        j.reset()
    b = t.next()
    assert b.data[0].context == mt.cpu() and b.pad == 0
    t.close()
    j.close()


@pytest.mark.parametrize("kind,reader_hits", [("worker_death", True),
                                              ("prefetch_death", False)])
def test_composed_faults_fire_in_their_own_stage(tmp_path, monkeypatch,
                                                 kind, reader_hits):
    rec, _ = _write_rec(tmp_path)

    def run(mod, rmod, **kw):
        it = mod.StreamRecordIter(rec, batch_size=4, decode_fn=_decode(rmod),
                                  seed=2, **kw)
        out = [(_host(b.data[0]).copy(), _host(b.label[0]).copy())
               for b in it]
        it.close()
        return out

    clean = run(ts, trec, sharding="cpu")
    monkeypatch.setenv("MXTPU_FAULT_INJECT", "%s@1" % kind)
    ref = run(js, jrec)
    tres.set_faults("%s@1" % kind)
    got = run(ts, trec, sharding="cpu")
    _same_stream(got, clean)
    _same_stream(got, ref)
    assert tres.FAULT_STATS["fired"] == [(kind, 1)]
    if reader_hits:
        assert ttel.value("stream.worker_restarts") >= 1
        assert ttel.value("data.prefetch_restarts") == 0
    else:
        assert ttel.value("data.prefetch_restarts") == 1
        assert ttel.value("stream.worker_restarts") == 0


def test_stream_record_iter_host_mode_and_decode_fn_required(tmp_path):
    rec, _ = _write_rec(tmp_path)
    host = ts.StreamRecordIter(rec, batch_size=4, decode_fn=_decode(trec),
                               seed=3, prefetch_to_device=False)
    ref = js.StreamRecordIter(rec, batch_size=4, decode_fn=_decode(jrec),
                              seed=3, prefetch_to_device=False)
    for hb, rb in zip(host, ref):
        assert isinstance(hb.data[0], np.ndarray)
        np.testing.assert_array_equal(hb.data[0], rb.data[0])
    host.close()
    ref.close()
    with pytest.raises(MXNetError, match="decode_fn"):
        ts.StreamRecordIter(rec, batch_size=4)


# ------------------------------------------------------------ device rules
@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_prefetcher_default_device_is_cuda_and_raises_without_a_card(
        no_cuda, tmp_path):
    with pytest.raises(MXNetError, match="no CUDA device"):
        ts.DevicePrefetcher(iter([np.zeros(2)]))
    with pytest.raises(MXNetError, match="no CUDA device"):
        ts.DevicePrefetcher(iter([np.zeros(2)]), sharding="cuda:0")
    with pytest.raises(MXNetError, match="no CUDA device"):
        ts.DevicePrefetcher(iter([np.zeros(2)]), sharding=mt.gpu(0))
    rec, _ = _write_rec(tmp_path)
    with pytest.raises(MXNetError, match="no CUDA device"):
        ts.StreamRecordIter(rec, batch_size=4, decode_fn=_decode(trec))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.io.PrefetchingIter(mt.io.NDArrayIter(np.zeros((4, 2)),
                                                batch_size=2))
    pf = ts.DevicePrefetcher(iter([np.zeros(2)]), sharding=mt.cpu())
    assert list(pf)[0].context == mt.cpu()
    pf.close()


def test_a_mesh_placement_raises_naming_a8():
    """A placement that is neither a device nor this package's
    ``parallel.Sharding`` (a JAX NamedSharding) raises; a Trainer without
    a mesh has no ``batch_sharding`` (None, as the reference's) and
    prefetches to the current context. A mesh Trainer's rows are held in
    tests/test_torch_mesh_trainer.py."""
    class NamedSharding:       # what a JAX mesh placement looks like
        mesh, spec = object(), ("data",)

    with pytest.raises(MXNetError, match="A8"):
        ts.DevicePrefetcher(iter([np.zeros(2)]), sharding=NamedSharding())
    net = mt.gluon.nn.Dense(2, in_units=2)
    net.initialize(ctx=mt.cpu())
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd")
    assert trainer.batch_sharding is None
    with mt.cpu():
        pf = ts.DevicePrefetcher(iter([np.zeros(2)]), sharding=trainer)
        assert list(pf)[0].context == mt.cpu()
        pf.close()
        loader = mt.gluon.data.DataLoader(
            mt.gluon.data.ArrayDataset(np.zeros(4)), batch_size=2,
            prefetch_to_device=trainer)
        assert next(iter(loader)).context == mt.cpu()


def test_levers_are_arguments_with_the_references_defaults(tmp_path,
                                                           monkeypatch):
    import inspect
    sig = inspect.signature
    assert sig(ts.DevicePrefetcher).parameters["depth"].default == 2
    assert sig(ts.DevicePrefetcher).parameters["max_restarts"].default == 3
    assert sig(ts.ShardedRecordReader).parameters[
        "max_restarts"].default == 3
    assert sig(ts.StreamRecordIter).parameters["depth"].default == 2
    assert sig(mt.gluon.data.DataLoader).parameters[
        "worker_restarts"].default == 3
    rec, _ = _write_rec(tmp_path, n=8)
    # the reference reads these; the port does not
    monkeypatch.setenv("MXTPU_PREFETCH_DEPTH", "5")
    monkeypatch.setenv("MXTPU_STREAM_THREADS", "0")
    monkeypatch.setenv("MXTPU_DL_WORKER_RESTARTS", "0")
    rd = ts.ShardedRecordReader(rec, batch_size=4)
    assert rd.num_threads == 2 and rd.max_restarts == 3
    assert js.ShardedRecordReader(rec, batch_size=4).num_threads == 0
    assert ts.ShardedRecordReader(rec, num_threads=0).num_threads == 0
    pf = ts.DevicePrefetcher(iter([]), sharding="cpu")
    assert pf._depth == 2 and pf._max_restarts == 3
    pf.close()
    assert ttel.gauge_value("data.prefetch_depth") == 2
