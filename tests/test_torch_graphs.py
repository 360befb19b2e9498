"""The capture helper's launch counts and ``CachedOp``'s contract on the
CPU, where no graph can be captured: ``graphs.launched`` keeps a
capture's launches on its own thread and replays add them under one
lock, and a ``CachedOp`` (driven through a stand-in for
``graphs.CapturedGraph`` that replays in the mode it was captured in)
keeps one graph per signature and train/predict mode and serves one call
at a time. Every join has a timeout of its own."""
import threading
import time
import types

import numpy as np
import pytest
import torch

import mxtpu_torch as mt
from mxtpu_torch import graphs
from mxtpu_torch import telemetry as ttel
from mxtpu_torch.gluon import nn as tnn
from mxtpu_torch.gluon.block import CachedOp

IN_DIM = 6
T = 30   # seconds any join may take


@pytest.fixture(autouse=True)
def _fresh():
    ttel.reset()
    FakeGraph.made = []
    yield
    ttel.reset()


class _Counted:
    def __init__(self):
        self.launches = 0


class FakeGraph:
    """``CapturedGraph`` on the CPU: the eager run at capture, as the real
    one's warm-up, then each replay writes ``fn``'s outputs, computed in
    the mode of the capture, into static outputs that the next replay
    overwrites."""

    made = []

    def __init__(self, fn, static_inputs, pool=None, generators=()):
        self.static_inputs = list(static_inputs)
        self._fn = fn
        self._training = mt.autograd.is_training()
        self.outputs = [o.clone() for o in fn(*self.static_inputs)]
        FakeGraph.made.append(self)

    def replay(self):
        time.sleep(0.001)   # the window another thread's call would use
        prev = mt.autograd.set_training(self._training)
        try:
            outs = self._fn(*self.static_inputs)
        finally:
            mt.autograd.set_training(prev)
        for static, o in zip(self.outputs, outs):
            static.copy_(o)
        return self.outputs


def _x(n, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(n, IN_DIM).astype(np.float32))


def _net(batchnorm=False):
    net = tnn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(tnn.Dense(8, in_units=IN_DIM))
        if batchnorm:
            net.add(tnn.BatchNorm(in_channels=8))
    net.initialize(ctx=mt.cpu())
    return net


# --------------------------------------------------------------- launches
def test_a_capture_counts_only_its_own_threads_launches():
    """Launches made on another thread while this one captures stay on
    the shared count; the capture's tally holds only its own."""
    obj = _Counted()
    started = threading.Event()

    def other():
        started.wait(T)
        for _ in range(1000):
            graphs.launched(obj)

    t = threading.Thread(target=other)
    t.start()
    with graphs._tally() as tally:
        started.set()
        for _ in range(11):
            graphs.launched(obj)
        t.join(T)
    assert not t.is_alive()
    assert obj.launches == 1000
    assert list(tally.values()) == [[obj, 11]]
    graphs.launched(obj)         # no capture open: the shared count
    assert obj.launches == 1001


def test_replays_add_their_launches_under_one_lock():
    """Replays on eight threads and eager launches on four more lose no
    count."""
    obj = _Counted()
    graph = graphs.CapturedGraph.__new__(graphs.CapturedGraph)
    graph.graph = types.SimpleNamespace(replay=lambda: None)
    graph.launches = [(obj, 11)]
    graph.outputs = []

    def replays():
        for _ in range(2000):
            graph.replay()

    def eager():
        for _ in range(2000):
            graphs.launched(obj)

    threads = [threading.Thread(target=replays) for _ in range(8)] + \
        [threading.Thread(target=eager) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(T)
    assert not any(t.is_alive() for t in threads)
    assert obj.launches == 8 * 2000 * 11 + 4 * 2000


def test_captured_graph_refuses_cpu_inputs():
    with pytest.raises(mt.MXNetError, match="CUDA inputs"):
        graphs.CapturedGraph(lambda x: [x], [torch.zeros(2)])


# --------------------------------------------------------------- CachedOp
def test_cached_op_keys_its_graphs_on_train_mode(monkeypatch):
    """A call in train mode (not recording) gets a graph of its own: the
    BatchNorm in it normalizes by the batch's statistics, as the eager
    forward does, and a predict-mode call still reads the running ones."""
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    net = _net(batchnorm=True)
    op = CachedOp(net)
    x = _x(4, seed=1)
    with torch.no_grad():
        got = op(x)
        torch.testing.assert_close(got, net._forward_eager(x), rtol=0,
                                   atol=0)
        with mt.autograd.train_mode():
            got_train = op(x)
            want_train = net._forward_eager(x)
        torch.testing.assert_close(got_train, want_train, rtol=0, atol=0)
        assert not torch.equal(got_train, got)
        torch.testing.assert_close(op(x), net._forward_eager(x), rtol=0,
                                   atol=0)
    assert [g._training for g in FakeGraph.made] == [False, True]
    assert ttel.retrace_stats("cached_op")["compiles"] == 2
    assert len(op._graphs) == 2


def test_cached_op_serves_one_call_at_a_time(monkeypatch):
    """Eight threads calling one hybridized block each get the answer to
    their own input: the static-input copy, the replay and the copies of
    its outputs happen under one lock, and one graph is captured."""
    monkeypatch.setattr(graphs, "CapturedGraph", FakeGraph)
    net = _net()
    op = CachedOp(net)
    xs = [_x(4, seed=i) for i in range(8)]
    with torch.no_grad():
        wants = [net._forward_eager(x) for x in xs]
    wrong = []

    def client(i):
        with torch.no_grad():
            for _ in range(10):
                if not torch.equal(op(xs[i]), wants[i]):
                    wrong.append(i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(T)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []
    assert len(FakeGraph.made) == 1
    assert ttel.retrace_stats("cached_op")["compiles"] == 1
