"""mx.mod: the classic symbolic training API (counterpart of
``mxtpu/module/``).

Reference: ``python/mxnet/module/`` — BaseModule.fit training template
(base_module.py:410-528), Module over DataParallelExecutorGroup (module.py),
BucketingModule for variable-length inputs (bucketing_module.py).
"""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule"]
