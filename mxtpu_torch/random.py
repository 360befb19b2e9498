"""Random state (counterpart of ``mxtpu/random.py``).

One explicit ``torch.Generator`` per device, made on first use from the
current seed (0 until ``seed`` is called). ``seed(s)`` reseeds every
device; ``seed(s, ctx)`` only that device's generator. A generator is
reseeded in place, so a CUDA graph that registered it (a captured
Dropout) draws from the new seed at its next replay. The state is per
thread, as the JAX package's key is. JAX's keys and torch's generators give
different numbers from one seed: one seed reproduces one stream, nothing
more.

In a process group (``distributed.init``) every generator is seeded with
the seed plus the process's rank, so the ranks of one program draw
different Dropout masks from one seed, as the reference's one global key
gives each shard of a batch its own; rank 0 draws what a lone process
draws.
"""
from __future__ import annotations

import threading

import torch

from . import graphs
from .base import MXNetError
from .context import resolve_device

__all__ = ["seed", "generator"]


class _RngState(threading.local):
    def __init__(self):
        self.seed = 0
        self.gens = {}


_STATE = _RngState()


def _rank():
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _new(device, seed_state):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_state) + _rank())
    return gen


def join_group():
    """Fold this process's rank into the generators made before it
    joined a group (``distributed.init`` calls it once)."""
    if _rank():
        for gen in _STATE.gens.values():
            gen.manual_seed(_STATE.seed + _rank())


def seed(seed_state, ctx="all"):
    """Seed the generators (ref: mx.random.seed): every device's with
    ``ctx="all"``, else only that of ``ctx``."""
    if ctx == "all":
        _STATE.seed = int(seed_state)
        for gen in _STATE.gens.values():
            gen.manual_seed(_STATE.seed + _rank())
    else:
        dev = resolve_device(ctx)
        if dev in _STATE.gens:
            _STATE.gens[dev].manual_seed(int(seed_state) + _rank())
        else:
            _STATE.gens[dev] = _new(dev, seed_state)


def generator(device=None):
    """The generator of ``device`` (default: the CUDA device, or raise).
    Inside a graph capture it raises unless the graph registered it: every
    replay would repeat the captured draw."""
    dev = resolve_device(device)
    gen = _STATE.gens.get(dev)
    if gen is None:
        gen = _STATE.gens[dev] = _new(dev, _STATE.seed)
    if not graphs.allow_generator(gen):
        raise MXNetError(
            "a random draw inside a CUDA-graph capture would repeat on every "
            "replay: register the generator with the graph")
    return gen
