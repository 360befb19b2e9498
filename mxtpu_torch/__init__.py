"""mxtpu_torch: the PyTorch/CUDA port of mxtpu, for NVIDIA Hopper.

The namespace mirrors ``import mxtpu as mx`` for the parts ported so far:
devices and contexts (``with mx.cpu():``), the layout scope, the op
registry and the imperative ``nd`` namespace over ``NDArray`` (with
``.params`` files: ``nd.save``/``nd.load``), ``autograd``, ``random``,
runtime-compiled CUDA
kernels (``rtc``) and the external-kernel hook (``contrib``), Gluon blocks
and layers, the ResNet v1 and transformer model zoo, initializers, the
bucketed Predictor, and training: Gluon losses and ``Trainer``, the
optimizers with their fused updater, lr schedulers and metrics, and the
input path: ``recordio``, ``io`` (iterators, the streaming reader and
the prefetch to the card), ``gluon.data`` and ``image``; and the symbolic
API: ``sym`` (Symbol, the executor, subgraph partitioning), ``mod``
(Module and its variants), ``model`` (checkpoints, FeedForward),
``callback``, ``monitor``, ``name`` and ``AttrScope``; and the
recurrent slice: ``gluon.rnn``, ``gluon.contrib`` and ``rnn`` (the
symbolic cells, the bucketed sentence iterator). Kernels that the JAX package wrote in Pallas are
hand-written CUDA under ``csrc/``, built at first use
(``mxtpu_torch.kernels``). Entry points run on the CUDA device unless the
caller passes a CPU device or opens a CPU context.
"""
from .ops.precision_util import apply_policy as _apply_policy

_apply_policy()   # float32 contractions stay float32 (no TF32), as in mxtpu

from . import base, context  # noqa: E402
from .base import MXNetError  # noqa: E402
from .context import (Context, cpu, current_context, default_device,  # noqa: E402
                      gpu, num_gpus)
from .layout import layout  # noqa: E402
from . import ops  # noqa: E402
from . import autograd  # noqa: E402
from . import ndarray  # noqa: E402
from . import ndarray as nd  # noqa: E402
from .ndarray import NDArray  # noqa: E402
from . import random  # noqa: E402
from . import rtc  # noqa: E402
from . import contrib  # noqa: E402
from . import initializer  # noqa: E402
from . import initializer as init  # noqa: E402
from . import lr_scheduler  # noqa: E402
from . import optimizer  # noqa: E402
from . import metric  # noqa: E402
from . import gluon  # noqa: E402
from . import telemetry  # noqa: E402
from . import resilience  # noqa: E402
from . import serving  # noqa: E402
from . import convert  # noqa: E402
from . import recordio  # noqa: E402
from . import io  # noqa: E402
from . import image  # noqa: E402
from . import symbol  # noqa: E402
from . import symbol as sym  # noqa: E402
from . import executor  # noqa: E402
from . import executor_manager  # noqa: E402
from . import model  # noqa: E402
from . import callback  # noqa: E402
from . import monitor  # noqa: E402
from .monitor import Monitor  # noqa: E402
from . import module  # noqa: E402
from . import module as mod  # noqa: E402
from .module import Module  # noqa: E402
from . import name  # noqa: E402
from . import attribute  # noqa: E402
from .attribute import AttrScope  # noqa: E402
from . import rnn  # noqa: E402
from . import distributed  # noqa: E402
from . import parallel  # noqa: E402
from . import kvstore  # noqa: E402
from . import kvstore as kv  # noqa: E402
from . import kvstore_server  # noqa: E402
from . import gradient_compression  # noqa: E402
from . import optimizer_fused  # noqa: E402

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "default_device", "layout", "ops",
           "autograd", "ndarray", "nd", "random", "rtc", "contrib",
           "initializer", "init", "gluon", "serving", "convert", "base",
           "context", "optimizer", "lr_scheduler", "metric", "telemetry",
           "resilience", "recordio", "io", "image", "symbol", "sym",
           "executor", "executor_manager", "model", "callback", "monitor",
           "Monitor", "module", "mod", "Module", "name", "attribute",
           "AttrScope", "rnn", "NDArray", "distributed", "parallel",
           "kvstore", "kv", "kvstore_server", "gradient_compression",
           "optimizer_fused"]
