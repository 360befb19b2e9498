"""Parallelism of the port (counterpart of ``mxtpu/parallel``): one
process per card over ``torch.distributed``, ranks laid out in a named
``Mesh``; differentiable collectives over one axis; ring attention over a
sequence axis (``sp``); ``ShardedTrainStep``, the data- and
sequence-parallel training step with ZeRO-1."""
from .collectives import (all_gather, axis_index, pmean, ppermute, psum,
                          reduce_scatter)
from .mesh import (Mesh, Sharding, data_parallel_mesh, host_value,
                   is_multiprocess_mesh, make_mesh, place_global)
from .ring_attention import (ring_attention, ring_attention_nd,
                             ring_flash_attention, ring_self_attention,
                             set_ring_flash)
from .train import ShardedTrainStep, pure_forward

__all__ = ["make_mesh", "data_parallel_mesh", "is_multiprocess_mesh",
           "host_value", "place_global", "Mesh", "Sharding",
           "ShardedTrainStep", "pure_forward", "ring_attention",
           "ring_flash_attention", "ring_self_attention",
           "ring_attention_nd", "set_ring_flash", "psum", "pmean",
           "all_gather", "reduce_scatter", "ppermute", "axis_index"]
