"""Contributed extensions of the port (counterpart of ``mxtpu/contrib``):
the external-kernel hook, the space-to-depth ResNet stem and the
checkpoints of ``async_checkpoint``."""
from . import async_checkpoint, external_kernel, s2d_stem  # noqa: F401
from .external_kernel import register_external_kernel, register_host_kernel

__all__ = ["async_checkpoint", "external_kernel", "s2d_stem",
           "register_external_kernel", "register_host_kernel"]
