"""Device meshes for the data axis.

The port of the JAX package's ``parallel/mesh.py``.  There, one program
runs over a ``jax.sharding.Mesh``; here, one process runs per device, and
a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
processes whose dimension is named after the data axis
(``RuntimeConfig.data_axis``):

* documents, and the per-document variational state, are sharded over
  the data axis: each process holds its own slab of the shard-major rows
  (:func:`put_sharded`);
* the sufficient statistics and the bound are reduced over the axis
  (``parallel/shard.psum``, ``utils/numerics.kbn_psum``);
* the global parameters are whole on every process (:func:`put_replicated`),
  and every process computes them identically from the reduced statistics.

A :class:`LocalMesh` is the one-device mesh that makes no collective
call: what :func:`make_mesh` returns with ``local=True`` (the per-process
mesh of multi-process streaming) or without a process group.  A model
given no mesh and no process group runs exactly the single-device path.

The JAX package's ``vocab`` and ``seq`` axes (tensor and sequence
parallelism) are not ported yet: a mesh with an axis other than the first
larger than 1 raises ``NotImplementedError`` (ROADMAP queue 1 item 8b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from . import multihost

_TP_TODO = ("only the data axis is ported: tensor- and sequence-parallel axes "
            "(vocab, seq, user) larger than 1 wait for ROADMAP queue 1 item 8b")


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


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, local: bool = False):
    """Build a mesh over the processes (default: all of them on the first
    axis, the data axis).

    ``local=True``, or no initialised process group, gives the one-device
    :class:`LocalMesh`.  Otherwise the mesh is a ``DeviceMesh`` over every
    rank of the default group, on CUDA when a CUDA device is present:
    ``n_devices`` and the product of ``shape``, when given, must equal the
    world size."""
    axis_names = tuple(axis_names)
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match the axes {axis_names}")
        if any(s > 1 for s in shape[1:]):
            raise NotImplementedError(f"mesh shape {shape} over {axis_names}: {_TP_TODO}")
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
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cuda" if torch.cuda.is_available() else "cpu",
                            (n,) + (1,) * (len(axis_names) - 1), mesh_dim_names=axis_names)


def data_shape(mesh_shape) -> Optional[tuple]:
    """``RuntimeConfig.mesh_shape`` (the data axis first, then the
    tensor-parallel axes) as the data axis's shape ``(n,)``, or None."""
    if mesh_shape is None:
        return None
    shape = tuple(int(s) for s in mesh_shape)
    if any(s > 1 for s in shape[1:]):
        raise NotImplementedError(f"mesh_shape {shape}: {_TP_TODO}")
    return shape[:1]


def check_data_only(mesh, data_axis: str) -> None:
    """Raise unless ``mesh`` has ``data_axis`` and every other axis is of
    size 1."""
    names = tuple(mesh.mesh_dim_names or ())
    if data_axis not in names:
        raise ValueError(f"the mesh has no axis {data_axis!r} (its axes: {names})")
    for i, name in enumerate(names):
        if name != data_axis and mesh.size(i) > 1:
            raise NotImplementedError(f"mesh axis {name!r} of size {mesh.size(i)}: {_TP_TODO}")


def is_local(mesh) -> bool:
    """True for no mesh or a :class:`LocalMesh`: no collective is made."""
    return mesh is None or isinstance(mesh, LocalMesh)


def axis_size(mesh, axis: str) -> int:
    if is_local(mesh):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This process's coordinate along ``axis``."""
    if is_local(mesh):
        return 0
    return mesh.get_local_rank(axis)


def put_sharded(a, mesh, axis: str = "data", device="cpu", dtype=None) -> torch.Tensor:
    """This process's slab of a shard-major host array, copied to ``device``."""
    rows = multihost.local_rows(np.asarray(a), axis_size(mesh, axis), axis_index(mesh, axis))
    return torch.tensor(rows, dtype=dtype, device=device)


def put_replicated(a, device="cpu", dtype=None) -> torch.Tensor:
    """The whole of a host array, copied to ``device`` (every process holds it)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)
