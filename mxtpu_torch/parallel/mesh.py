"""Device meshes over the process group (counterpart of
``mxtpu/parallel/mesh.py``).

The reference lays devices out in a named ``jax.sharding.Mesh`` that one
controller drives. The port runs one process per card, so a mesh lays
the world's *ranks* out in named axes, backed by
``torch.distributed.device_mesh.DeviceMesh``: each axis has one process
group per slice, and this rank's index along it. ``.shape`` maps axis
names to sizes, as a JAX mesh's does (``dict(mesh.shape)``).

Values are per rank. Where the reference places one global array on the
mesh, the port holds the rank's shard of it: ``place_global`` takes the
same host value on every rank and returns this rank's shard, and
``host_value`` all-gathers a sharded value back.
"""
from __future__ import annotations

import collections
import warnings

import numpy as np
import torch
import torch.distributed as dist

from .. import distributed
from ..base import MXNetError

__all__ = ["Mesh", "MeshAxis", "P", "Sharding", "make_mesh", "world_axis",
           "data_parallel_mesh", "is_multiprocess_mesh", "host_value",
           "place_global"]


class MeshAxis:
    """One axis of a mesh as this rank sees it: its size, this rank's
    index along it, the group of the ranks that differ from this one
    along it only, and their global ranks in axis order."""

    __slots__ = ("name", "size", "index", "group", "ranks")

    def __init__(self, name, size, index, group, ranks):
        self.name = name
        self.size = size
        self.index = index
        self.group = group
        self.ranks = ranks

    def __repr__(self):
        return "MeshAxis(%r, size=%d, index=%d)" % (self.name, self.size,
                                                   self.index)


class Mesh:
    """Ranks laid out in named axes (``make_mesh``). ``device_mesh`` is
    the ``DeviceMesh`` behind it."""

    def __init__(self, device_mesh, names, sizes):
        self.device_mesh = device_mesh
        self.axis_names = tuple(names)
        self.shape = collections.OrderedDict(zip(names, sizes))
        self.devices = device_mesh.mesh.numpy()
        self._axes = {}

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))

    def axis(self, name):
        """The ``MeshAxis`` ``name`` as this rank sees it."""
        if name not in self.shape:
            raise MXNetError("mesh has no axis %r (axes: %s)"
                             % (name, tuple(self.shape)))
        ax = self._axes.get(name)
        if ax is None:
            group = self.device_mesh.get_group(name)
            ax = MeshAxis(name, self.shape[name],
                          self.device_mesh.get_local_rank(name), group,
                          dist.get_process_group_ranks(group))
            self._axes[name] = ax
        return ax

    def __repr__(self):
        return "Mesh(%s)" % dict(self.shape)


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``'s counterpart: per
    dimension the mesh axis it is split over, or None (whole);
    ``P("model", None)``. Any tuple of the same entries is taken alike."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


class Sharding:
    """A placement of a value on a mesh: ``spec`` names, per dimension,
    the axis it is split over (None: whole). The rank holds the block of
    its indices along those axes, on ``device`` (the rank's card, or the
    host; None: the current context)."""

    def __init__(self, mesh, spec, device=None):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.device = device

    def shard(self, value):
        """This rank's block of the whole ``value`` (a tensor or a numpy
        array; a scalar passes whole)."""
        for dim, name in enumerate(self.spec):
            if name is None or dim >= np.ndim(value):
                continue
            ax = self.mesh.axis(name)
            n = value.shape[dim]
            if n % ax.size:
                raise MXNetError(
                    "dimension %d (%d) does not divide the %r mesh axis "
                    "(%d)" % (dim, n, name, ax.size))
            k = n // ax.size
            index = [slice(None)] * dim + [slice(ax.index * k,
                                                 (ax.index + 1) * k)]
            value = value[tuple(index)]
        return value

    def __repr__(self):
        return "Sharding(%r, %s)" % (self.mesh, self.spec)


def world_axis():
    """Every rank of the world as one axis (the default group)."""
    n = distributed.num_workers()
    return MeshAxis("world", n, distributed.rank(),
                    dist.group.WORLD if n > 1 else None, list(range(n)))


def make_mesh(axes, devices=None):
    """Lay the ranks out in named axes.

    ``axes``: ordered mapping of axis name to size; one size may be -1,
    which absorbs the remaining ranks. ``devices``: the global ranks to
    lay out (default every rank of the world; a process outside a group
    is a world of one). Ranks left over warn, as the reference's idle
    devices do. Every rank of the world must call it, in the same order
    as its other mesh and group calls."""
    if devices is None:
        devices = list(range(distributed.num_workers()))
    devices = [int(d) for d in devices]
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    n_dev = len(devices)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n_dev % known:
            raise ValueError("cannot infer -1 axis: %d ranks not divisible "
                             "by %d" % (n_dev, known))
        sizes[sizes.index(-1)] = n_dev // known
    total = int(np.prod(sizes))
    if total > n_dev:
        raise ValueError("mesh %s needs %d ranks, only %d available"
                         % (axes, total, n_dev))
    if total < n_dev:
        warnings.warn("mesh %s uses %d of %d ranks; the remaining %d are "
                      "idle (use -1 on one axis to absorb all ranks)"
                      % (dict(zip(names, sizes)), total, n_dev,
                         n_dev - total), stacklevel=2)
    if not distributed.is_initialized():
        raise MXNetError("make_mesh needs the process group: call "
                         "mxtpu_torch.distributed.init() first")
    from torch.distributed.device_mesh import DeviceMesh
    kind = "cuda" if distributed.backend() == "nccl" else "cpu"
    ranks = torch.tensor(devices[:total], dtype=torch.int64).reshape(sizes)
    return Mesh(DeviceMesh(kind, ranks, mesh_dim_names=tuple(names)),
                names, sizes)


def data_parallel_mesh(devices=None, axis="data"):
    """Every rank on one data axis (the KVStore ``device``/``nccl``
    counterpart)."""
    return make_mesh({axis: -1}, devices)


def is_multiprocess_mesh(mesh):
    """True when the mesh spans more than one process."""
    return mesh.size > 1


def place_global(data, sharding):
    """This rank's shard of the host value ``data``, which every rank
    holds whole; ``sharding`` a ``Sharding`` (a tensor or NDArray goes
    back as one on its device, anything else as a CPU tensor)."""
    from ..ndarray import NDArray
    nd = isinstance(data, NDArray)
    t = data._data if nd else data
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(t)))
    out = sharding.shard(t).contiguous()
    return NDArray(out) if nd else out


def host_value(arr, sharding=None):
    """The whole value of ``arr`` on this host as numpy: ``arr`` itself
    when it is whole (``sharding`` None or splitting nothing), else the
    all-gather of every rank's block. A collective: every rank of the
    sharded axes calls it."""
    from ..ndarray import NDArray
    t = arr._data if isinstance(arr, NDArray) else arr
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if sharding is not None:
        from .collectives import all_gather
        for dim, name in reversed(list(enumerate(sharding.spec))):
            if name is not None:
                t = all_gather(t.detach(), sharding.mesh.axis(name), dim=dim)
    return t.detach().cpu().numpy()
