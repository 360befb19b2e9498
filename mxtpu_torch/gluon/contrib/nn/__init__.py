"""Contrib layers (counterpart of ``mxtpu/gluon/contrib/nn``):
``Concurrent``, ``HybridConcurrent`` and ``Identity`` are Gluon's own
layers; ``SparseEmbedding`` (row-sparse gradients), ``SyncBatchNorm``
(statistics across devices) and ``SwitchMoE`` are not ported yet and
raise naming their ROADMAP items."""
from ....base import MXNetError
from ...nn import Concurrent, HybridConcurrent, Identity

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "SwitchMoE"]


def _not_ported(name, item, what):
    def __init__(self, *args, **kwargs):
        raise MXNetError("%s is not ported yet: it needs %s (ROADMAP %s)"
                         % (name, what, item))
    return type(name, (), {"__init__": __init__,
                           "__doc__": "Not ported yet (ROADMAP %s)." % item})


SparseEmbedding = _not_ported("SparseEmbedding", "A10",
                              "row-sparse gradients")
SyncBatchNorm = _not_ported("SyncBatchNorm", "A8",
                            "the multi-device collectives")
SwitchMoE = _not_ported("SwitchMoE", "A10", "the mixture-of-experts layers")
