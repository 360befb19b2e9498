"""Parallelism of the port (counterpart of ``mxtpu/parallel``): one
process per card over ``torch.distributed``, ranks laid out in a named
``Mesh``; differentiable collectives over one axis (with Megatron's
``copy_to``/``reduce_from``/``gather_from`` for axes whose ranks compute
the same loss); ring attention over a sequence axis (``sp``); the Switch
mixture of experts and its expert-parallel form (``moe``); the GPipe
pipeline (``pipeline_apply``); ``ShardedTrainStep``, the data-, sequence-,
tensor- and expert-parallel training step with ZeRO-1."""
from .collectives import (all_gather, axis_index, copy_to, gather_from,
                          pmean, ppermute, psum, reduce_from, reduce_scatter)
from .mesh import (Mesh, P, Sharding, data_parallel_mesh, host_value,
                   is_multiprocess_mesh, make_mesh, place_global)
from .moe import shard_experts, switch_ffn
from .pipeline import pipeline_apply
from .ring_attention import (ring_attention, ring_attention_nd,
                             ring_flash_attention, ring_self_attention,
                             set_ring_flash)
from .train import ShardedTrainStep, pure_forward

__all__ = ["make_mesh", "data_parallel_mesh", "is_multiprocess_mesh",
           "host_value", "place_global", "Mesh", "P", "Sharding",
           "ShardedTrainStep", "pure_forward", "pipeline_apply",
           "switch_ffn", "shard_experts", "ring_attention",
           "ring_flash_attention", "ring_self_attention",
           "ring_attention_nd", "set_ring_flash", "psum", "pmean",
           "all_gather", "reduce_scatter", "ppermute", "copy_to",
           "reduce_from", "gather_from", "axis_index"]
