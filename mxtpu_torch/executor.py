"""``mx.executor`` namespace (counterpart of ``mxtpu/executor.py``; ref:
python/mxnet/executor.py). The Executor lives with the symbol layer
(symbol/executor.py); this module keeps the ``mx.executor.Executor``
spelling and isinstance checks working for code written against the
reference.
"""
from .symbol.executor import Executor

__all__ = ["Executor"]
