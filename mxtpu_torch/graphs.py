"""CUDA-graph capture: the one helper that the serving Predictor's
buckets, ``HybridBlock.hybridize``'s ``CachedOp`` and the
``FusedUpdater``'s update share (the counterpart of the JAX package's one
jit per bucket, signature or optimizer step), and ``CapturedPair``, a
captured forward with its captured backward for recorded calls.

``CapturedGraph(fn, static_inputs, pool)`` (``fn`` returns a list of
tensors, the flat outputs) runs ``fn`` once eagerly on a
side stream (cuBLAS handles and workspaces come into being there, outside
the capture; one side stream per device serves every capture, since cuBLAS
keeps a workspace for each stream it has run on for as long as the
process lives), then captures one call of ``fn`` on ``static_inputs`` into a
``torch.cuda.CUDAGraph`` in ``capture_error_mode="thread_local"``, holding
``CAPTURE_LOCK``: a capture never overlaps another one, nor a block's
eager forward that the Predictor runs under the same lock. ``replay()``
runs the recorded kernels on the current stream and returns the static
outputs, which the next replay overwrites: a caller copies what it keeps.
A capture that fails raises; nothing falls back to eager.

Launch counts. A kernel wrapper counts its launches in Python
(``fused_conv.launches``, ``flash_attention.launches``, an rtc
``Kernel.launches``) through ``launched(obj)``, and a replay runs no
Python. While this thread captures, ``launched`` adds to the capture's
own tally and not to ``obj.launches`` (the capture ran no kernel); every
replay then adds the tally. Other threads count as before meanwhile, and
every change to a count is made under one lock, so the counts read as if
every forward had run eagerly, whatever the threads.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from .base import MXNetError

__all__ = ["CAPTURE_LOCK", "CapturedGraph", "CapturedPair", "launched",
           "capturing", "captures", "keeping", "keeping_generators",
           "allow_generator"]

# one lock for every capture and every eager forward of a shared block:
# the Predictor's forward swaps its parameter snapshot into the block
# (functional_call), and a block is shared by the Predictors of every
# device, so the lock is per process
CAPTURE_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()
_STATE = threading.local()
_SIDE_STREAMS = {}   # device -> the warm-up stream, used under CAPTURE_LOCK


def launched(obj):
    """Count one launch of ``obj``'s kernel (``obj.launches``, an int); a
    wrapper calls it where it launches. During a capture on this thread
    the launch goes to the capture's tally, which each replay adds."""
    tally = getattr(_STATE, "tally", None)
    if tally is not None:
        tally.setdefault(id(obj), [obj, 0])[1] += 1
        return
    with _COUNT_LOCK:
        obj.launches += 1


@contextlib.contextmanager
def _tally():
    """Collect this thread's ``launched`` calls: yields ``{id: [obj, n]}``."""
    prev = getattr(_STATE, "tally", None)
    _STATE.tally = tally = {}
    try:
        yield tally
    finally:
        _STATE.tally = prev


def capturing():
    """True on a thread that is capturing a graph: a hybridized child
    called inside its parent's capture runs eagerly into that graph."""
    return getattr(_STATE, "depth", 0) > 0


def captures(device):
    """True where a hybridized call and a fused optimizer step run as
    captured graphs: on a CUDA device. (The CPU tests replace it, and
    ``CapturedGraph``, with stand-ins.)"""
    return torch.device(device).type == "cuda"


def allow_generator(gen):
    """Whether a draw from the port's generator ``gen`` may happen on this
    thread now: always outside a capture; inside one only when the graph
    registered it (a replay would otherwise repeat the captured draw)."""
    return not capturing() or id(gen) in getattr(_STATE, "generators", ())


@contextlib.contextmanager
def keeping(tensors):
    """Give ``tensors`` back their values when the block ends: a warm-up
    run must not move the state (BatchNorm's running statistics) that
    every replay moves once."""
    saved = [t.detach().clone() for t in tensors]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)


@contextlib.contextmanager
def keeping_generators(generators):
    """Give each of ``generators`` its state back when the block ends: a
    warm-up run's draws must not move the offset from which the first
    replay draws (each replay then draws as one eager call would)."""
    saved = [g.get_state() for g in generators]
    try:
        yield
    finally:
        for g, st in zip(generators, saved):
            g.set_state(st)


class CapturedGraph:
    """One CUDA graph of ``fn(*static_inputs)`` on the inputs' device.

    ``pool`` is a ``torch.cuda.graph_pool_handle()`` shared by graphs that
    never replay at once (a Predictor's buckets), so their intermediate
    buffers share one private pool; capture the largest first. ``device``
    names the device when ``fn`` takes no input (a decode step reads only
    state it was captured over). ``generators`` (the port's
    ``torch.Generator``s that ``fn`` draws from) are registered with the
    graph: each replay draws from the generator's offset at that time and
    moves it, as an eager call would; the warm-up's draws are given back."""

    def __init__(self, fn, static_inputs, pool=None, device=None,
                 generators=()):
        device = static_inputs[0].device if device is None \
            else torch.device(device)
        if device.type != "cuda":
            raise MXNetError("CapturedGraph needs CUDA inputs, got %s"
                             % device)
        self.static_inputs = list(static_inputs)
        self.device = device
        with CAPTURE_LOCK, torch.cuda.device(device), \
                keeping_generators(generators):
            _STATE.depth = getattr(_STATE, "depth", 0) + 1
            # the registered generators may be drawn from in the warm-up
            # and the capture alike
            prev_gens = getattr(_STATE, "generators", ())
            _STATE.generators = set(prev_gens) | {id(g) for g in generators}
            try:
                cur = torch.cuda.current_stream(device)
                side = _SIDE_STREAMS.get(device)
                if side is None:
                    side = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    fn(*self.static_inputs)
                cur.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                for gen in generators:
                    graph.register_generator_state(gen)
                # a garbage collection during the capture may free another
                # graph, whose teardown invalidates this capture
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with _tally() as tally, \
                            torch.cuda.graph(
                                graph, pool=pool,
                                capture_error_mode="thread_local"):
                        out = fn(*self.static_inputs)
                finally:
                    if collecting:
                        gc.enable()
            finally:
                _STATE.generators = prev_gens
                _STATE.depth -= 1
        self.launches = [tuple(e) for e in tally.values()]
        self.graph = graph
        self.outputs = list(out)

    def replay(self):
        """Run the graph on the current stream; returns the static outputs
        (overwritten by the next replay)."""
        self.graph.replay()
        if self.launches:
            with _COUNT_LOCK:
                for obj, n in self.launches:
                    obj.launches += n
        return self.outputs


class CapturedPair:
    """A captured forward and its captured backward, sharing one private
    pool (the counterpart of the reference's jitted forward and its
    companion jitted backward).

    ``fn(*static_inputs)`` returns the flat outputs, computed with grad
    enabled from the static inputs and the leaves ``params``; the forward
    graph is ``CapturedGraph(fn)``, warmed with ``keep`` (the state a
    forward moves in place) given back its values. The backward graph runs
    ``torch.autograd.grad`` from static cotangents (``cotangents``, one per
    output that requires grad) to the static inputs that require grad and
    to ``params``, keeping the forward's autograd graph for the next
    replay. It is captured after one replay of the forward, so its warm-up
    reads this call's activations (a max-pool's indices among them), and
    ``keep`` is given back its values after that replay too: the caller's
    replay moves the state once. The forward's activations live in the
    pool, so one pair serves one outstanding call: the caller replays the
    backward before the next forward (``CachedOp`` keeps a pair busy until
    then). ``generators`` (what ``fn`` draws from, a Dropout's mask) are
    registered with both graphs and, like ``keep``, given back their state
    after the warm-up and that replay: the caller's replay draws what one
    eager forward would, and the backward reads the mask that the forward
    replay drew (the mask is an activation; nothing draws again)."""

    def __init__(self, fn, static_inputs, params, keep=(), generators=()):
        device = static_inputs[0].device
        pool = torch.cuda.graph_pool_handle() if device.type == "cuda" \
            else None
        self._live = []

        def forward(*xs):
            with torch.enable_grad():
                self._live = list(fn(*xs))
            return self._live

        with keeping(keep), keeping_generators(generators):
            self.forward = CapturedGraph(forward, static_inputs, pool=pool,
                                         generators=generators)
            self.diff_outputs = [k for k, o in enumerate(self._live)
                                 if isinstance(o, torch.Tensor)
                                 and o.requires_grad]
            diff_in = [x for x in self.forward.static_inputs
                       if x.requires_grad] + list(params)
            self.forward.replay()
            cots = [torch.zeros_like(self._live[k])
                    for k in self.diff_outputs]

            def backward(*cts):
                return list(torch.autograd.grad(
                    [self._live[k] for k in self.diff_outputs], diff_in,
                    cts, retain_graph=True, allow_unused=True))

            self.backward = CapturedGraph(backward, cots, pool=pool,
                                          generators=generators)
        self.cotangents = self.backward.static_inputs
