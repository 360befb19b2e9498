"""Parallelism of the port (counterpart of ``mxtpu/parallel``): the
single-device branch of ring attention so far."""
from .ring_attention import ring_attention_nd, ring_self_attention

__all__ = ["ring_self_attention", "ring_attention_nd"]
