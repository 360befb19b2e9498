"""Operators of the port; this module is the ``F`` namespace that
``HybridBlock.hybrid_forward`` receives. Importing it registers every op
module with the registry, from which ``mx.nd`` is built."""
from . import (elemwise, image_ops, optimizer_ops,  # noqa: F401
               quantization, reduce, subgraph_ops)
from .elemwise import (abs_ as abs, broadcast_add,  # noqa: A004
                       broadcast_mul, broadcast_sub, clip, exp, log, relu,
                       sigmoid, square, tanh, where)
from .init_ops import arange
from .matrix import (Concat, Embedding, Flatten, pad, reshape, swapaxes,
                     transpose)
from .nn import (Activation, BatchNorm, Convolution, Deconvolution, Dropout,
                 FullyConnected, InstanceNorm, LayerNorm, LeakyReLU, Pooling,
                 SoftmaxOutput, log_softmax, softmax)
from .reduce import mean, pick, sum_ as sum  # noqa: A004

concat = Concat
flatten = Flatten

__all__ = ["Activation", "BatchNorm", "Convolution", "Deconvolution",
           "Dropout", "FullyConnected", "InstanceNorm", "LayerNorm",
           "LeakyReLU", "Pooling", "Embedding", "Concat", "concat", "Flatten",
           "flatten", "SoftmaxOutput", "pad",
           "reshape", "transpose", "swapaxes", "arange", "softmax",
           "log_softmax", "abs", "broadcast_add", "broadcast_mul",
           "broadcast_sub", "clip", "exp", "log", "relu", "sigmoid",
           "square", "tanh", "where", "mean", "pick", "sum"]
