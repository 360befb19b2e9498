"""Parameter-server bootstrap (counterpart of ``mxtpu/kvstore_server.py``).

As in the reference there is no server role: every process is a worker
in the collectives of ``mxtpu_torch.distributed``, and ``dist_async`` is
not supported. ``KVStoreServer.run`` raises with that note; the import
hook reads nothing from the environment (the port reads no variables of
its own), so a process is a worker unless it runs a server and is told
otherwise.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """Kept for import parity; running it raises."""

    def __init__(self, kvstore=None):
        self.kvstore = kvstore

    def run(self):
        raise MXNetError(
            "Parameter-server roles do not exist in this runtime: "
            "distributed training is symmetric collectives over "
            "torch.distributed. Start every process as a worker with "
            "mxtpu_torch.distributed.init() and kvstore.create('dist_sync').")


def _init_kvstore_server_module(role=None):
    """The reference's import hook: ``role`` 'server' or 'scheduler'
    raises (neither exists), a worker passes."""
    if role in ("server", "scheduler"):
        KVStoreServer().run()
