"""Operators of the port; this module is the ``F`` namespace that
``HybridBlock.hybrid_forward`` receives. Importing it registers every op
module with the registry, from which ``mx.nd`` is built. A registered op
that is not named here resolves from the registry by any of its names
(``F.SliceChannel``, ``F.split``), as its tensor function."""
from . import (contrib_ops, control_flow, ctc, elemwise,  # noqa: F401
               image_ops, linalg_ops, optimizer_ops, quantization,
               random_ops, reduce, rnn_ops, subgraph_ops)
from . import registry as _registry
from .registry import (REGISTRY, attach_methods, get_op, invoke, list_ops,
                       register)
from .elemwise import (abs_ as abs, broadcast_add,  # noqa: A004
                       broadcast_mul, broadcast_sub, clip, exp, log, relu,
                       sigmoid, square, tanh, where)
from .init_ops import arange
from .matrix import (Concat, Embedding, Flatten, SliceChannel, pad, reshape,
                     swapaxes, transpose)
from .nn import (Activation, BatchNorm, Convolution, Deconvolution, Dropout,
                 FullyConnected, InstanceNorm, LayerNorm, LeakyReLU, Pooling,
                 SequenceLast, SequenceMask, SequenceReverse, SoftmaxOutput,
                 log_softmax, softmax)
from .reduce import mean, pick, sum_ as sum  # noqa: A004
from .rnn_ops import RNN

concat = Concat
flatten = Flatten
split = SliceChannel

__all__ = ["Activation", "BatchNorm", "Convolution", "Deconvolution",
           "Dropout", "FullyConnected", "InstanceNorm", "LayerNorm",
           "LeakyReLU", "Pooling", "Embedding", "Concat", "concat", "Flatten",
           "flatten", "SoftmaxOutput", "pad", "SliceChannel", "split",
           "SequenceMask", "SequenceLast", "SequenceReverse", "RNN",
           "reshape", "transpose", "swapaxes", "arange", "softmax",
           "log_softmax", "abs", "broadcast_add", "broadcast_mul",
           "broadcast_sub", "clip", "exp", "log", "relu", "sigmoid",
           "square", "tanh", "where", "mean", "pick", "sum", "REGISTRY",
           "register", "get_op", "list_ops", "invoke", "attach_methods"]


def __getattr__(name):
    op = _registry.REGISTRY.get(name)
    if op is None:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    return op.fn
