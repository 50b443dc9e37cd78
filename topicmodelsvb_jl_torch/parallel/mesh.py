"""Device meshes over the processes.

The port of the JAX package's ``parallel/mesh.py``.  There, one program
runs over a ``jax.sharding.Mesh``; here, one process runs per device, and
a mesh is a :class:`ProcessMesh`: an N-D grid of the ranks of the process
group whose dimensions are named after the mesh axes.  Rank ``r`` sits at
the row-major coordinate of ``r`` in the mesh's shape (the first axis
major, as JAX lays out its devices), so a process's coordinate on
``("data", "vocab")`` of shape ``(n_d, n_v)`` is ``(r // n_v, r % n_v)``.

* The data axis (``RuntimeConfig.data_axis``) shards documents and their
  per-document variational state: each process holds its own slab of the
  shard-major rows (:func:`local_block`).  A tuple of axes shards over
  their product, the first axis major, as JAX's ``P(("data", "vocab"))``
  does, so rank ``(d, v)`` holds row block ``d·n_v + v``.
* A ``vocab`` (or ``user``) axis shards a parameter's storage: beta's
  columns ``[K, V/n]`` by vocab coordinate (``local_block(..., dim=1)``);
  a ``seq`` axis shards every document's token columns.
* Statistics and bounds are reduced over the sub-mesh of the named axes
  (``parallel/shard``); the process group of every set of axes is made
  once, when the mesh is built, by every rank.

A :class:`LocalMesh` is the one-device mesh that makes no collective
call: what :func:`make_mesh` returns with ``local=True`` (the per-process
mesh of multi-process streaming) or without a process group.  A model
given no mesh and no process group runs exactly the single-device path.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from . import multihost


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A mesh of this process's one device: every axis has size 1, and no
    collective is ever made over it."""

    mesh_dim_names: tuple

    @property
    def shape(self) -> tuple:
        return (1,) * len(self.mesh_dim_names)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1


class ProcessMesh:
    """An N-D mesh over every rank of the default process group.

    ``size(i)`` is axis ``i``'s size (the world size with no argument),
    ``get_local_rank(axis)`` this process's coordinate along ``axis``, and
    ``group(axes)`` the process group of the sub-mesh that varies along
    ``axes`` through this process, its ranks in rank order.  Every group is made in
    ``__init__`` by every rank in one order, as ``new_group`` requires."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], device_type: str):
        import torch.distributed as dist

        self.mesh_dim_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.device_type = device_type
        self.coordinate = tuple(int(c) for c in np.unravel_index(dist.get_rank(), self.shape))
        grid = np.arange(math.prod(self.shape)).reshape(self.shape)
        me, nd = dist.get_rank(), len(self.shape)
        self._groups, made = {}, {}
        for r in range(1, nd + 1):
            for dims in itertools.combinations(range(nd), r):
                rest = [i for i in range(nd) if i not in dims]
                blocks = np.transpose(grid, rest + list(dims)).reshape(
                    -1, math.prod(self.shape[i] for i in dims))
                for ranks in blocks:
                    key = tuple(int(x) for x in ranks)
                    if key not in made:   # axes of size 1 repeat a group
                        made[key] = dist.new_group(list(key))
                    if me in key:
                        self._groups[dims] = made[key]

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return math.prod(self.shape) if mesh_dim is None else self.shape[mesh_dim]

    def get_local_rank(self, axis: str) -> int:
        return self.coordinate[self._dim(axis)]

    def group(self, axes):
        """The process group over ``axes`` (a name or a tuple of names, in
        any order), or None for no axes."""
        dims = tuple(sorted({self._dim(a) for a in axis_tuple(axes)}))
        return self._groups[dims] if dims else None

    def _dim(self, axis: str) -> int:
        if axis not in self.mesh_dim_names:
            raise ValueError(f"the mesh has no axis {axis!r} (its axes: {self.mesh_dim_names})")
        return self.mesh_dim_names.index(axis)

    def __repr__(self) -> str:
        return f"ProcessMesh({dict(zip(self.mesh_dim_names, self.shape))}, at {self.coordinate})"


def axis_tuple(axes) -> tuple:
    """A mesh axis, or a tuple of them (None entries dropped), as a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(a for a in (axes or ()) if a is not None)


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, local: bool = False):
    """Build a mesh over the processes (default: all of them on the first
    axis, the data axis).

    ``local=True``, or no initialised process group, gives the one-device
    :class:`LocalMesh`.  Otherwise the mesh is a :class:`ProcessMesh` over
    every rank of the default group, on CUDA when a CUDA device is
    present: ``n_devices`` and the product of ``shape``, when given, must
    equal the world size.  Every rank must build its meshes in the same
    order (each makes the process groups of its sub-meshes)."""
    axis_names = tuple(axis_names)
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axes {axis_names} repeat a name")
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match the axes {axis_names}")
    n_world = 1 if local else multihost.process_count()
    n = int(n_devices) if n_devices is not None else (
        math.prod(shape) if shape is not None else n_world)
    if shape is not None and math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    if local or not multihost.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} devices needs a process group of {n} ranks "
                             "(multihost.initialize)" if not local else
                             "a local mesh holds this process's one device")
        return LocalMesh(axis_names)
    if n != n_world:
        raise ValueError(f"the mesh spans every rank: n_devices={n}, but the process "
                         f"group has {n_world}")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    return ProcessMesh(axis_names, shape, "cuda" if torch.cuda.is_available() else "cpu")


def data_shape(mesh_shape) -> Optional[tuple]:
    """``RuntimeConfig.mesh_shape`` (the data axis first, then the
    tensor-parallel axes) as the data axis's shape ``(n,)``, or None: the
    api models shard over the data axis alone, as the JAX package's do."""
    if mesh_shape is None:
        return None
    return tuple(int(s) for s in mesh_shape)[:1]


def check_axes(mesh, *axes) -> None:
    """Raise unless ``mesh`` has every named axis (None entries skipped)."""
    names = tuple(mesh.mesh_dim_names or ())
    for ax in axes:
        for a in axis_tuple(ax):
            if a not in names:
                raise ValueError(f"the mesh has no axis {a!r} (its axes: {names})")


def is_local(mesh) -> bool:
    """True for no mesh or a :class:`LocalMesh`: no collective is made."""
    return mesh is None or isinstance(mesh, LocalMesh)


def axis_size(mesh, axis) -> int:
    """The size of ``axis``, or the product of the sizes of a tuple of
    axes (1 with no mesh)."""
    if is_local(mesh):
        return 1
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axis_tuple(axis))


def axis_index(mesh, axis) -> int:
    """This process's coordinate along ``axis``; along a tuple of axes,
    the flattened coordinate, the first axis major (JAX's order)."""
    if is_local(mesh):
        return 0
    i = 0
    for a in axis_tuple(axis):
        i = i * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return i


def local_block(a, mesh, axis, dim: int = 0):
    """This process's block of a host array along ``dim``: block
    ``axis_index`` of ``axis_size`` equal blocks (a view)."""
    a = np.asarray(a)
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if a.shape[dim] % n:
        raise ValueError(f"{a.shape[dim]} entries along dim {dim} do not divide into "
                         f"{n} shards")
    per = a.shape[dim] // n
    return a[(slice(None),) * dim + (slice(i * per, (i + 1) * per),)]


def put_replicated(a, device="cpu", dtype=None) -> torch.Tensor:
    """The whole of a host array, copied to ``device`` (every process holds it)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)
