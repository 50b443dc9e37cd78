"""Collectives over a mesh axis, for the model steps and bounds.

The port of the JAX package's ``parallel/shard.py``.  JAX's ``dp_jit``
wraps a step in ``jit(shard_map(...))`` so one program runs on every
device; torch runs eagerly, one process per device, so a step needs no
wrapper: each process calls it on its own slab, and the reductions below
are its ``psum``s.  ``tp_normalize_rows`` waits for the tensor-parallel
axes (ROADMAP queue 1 item 8b).

Every reduction gathers the processes' parts and folds them in rank
order, so every process gets the same bits whatever the backend's
all-reduce algorithm; on two processes the fold is JAX's ``psum`` on a
two-device mesh.  Every process must make the same calls in the same
order.  gloo and NCCL both take CUDA tensors directly (gloo stages them
through the host itself); :data:`STATS` records which backend and
device each call used.  A failed collective raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch
import torch.distributed as dist

from .mesh import is_local


@dataclasses.dataclass
class CollectiveStats:
    """Counts of the collectives made since the last :meth:`reset`:
    ``calls``, ``bytes`` sent by this process, ``routes`` (calls per
    ``"backend:device"``), and with ``timed`` set, ``seconds`` of wall
    time, the device waited for before and after each call."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False
    routes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        self.routes = {}


STATS = CollectiveStats()


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes or ())


def _group(mesh, axes):
    """The process group of the data axis named in ``axes``, or None when
    nothing is reduced (no mesh, a local mesh, no axes)."""
    axes = _axes(axes)
    if is_local(mesh) or not axes:
        return None
    if len(axes) != 1:
        raise NotImplementedError(f"a reduction over the axes {axes}: only the data axis "
                                  "is ported (ROADMAP queue 1 item 8b)")
    return mesh.get_group(axes[0])


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    t0 = None
    if STATS.timed:
        _sync(x)
        t0 = time.perf_counter()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    if t0 is not None:
        _sync(x)
        STATS.seconds += time.perf_counter() - t0
    route = f"{dist.get_backend(group)}:{x.device.type}"
    STATS.calls += 1
    STATS.bytes += x.numel() * x.element_size()
    STATS.routes[route] = STATS.routes.get(route, 0) + 1
    return torch.stack(parts)


def all_gather(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``[n, *x.shape]``: every process's ``x`` along the axis, in rank
    order (``x[None]`` when nothing is reduced)."""
    group = _group(mesh, axes)
    if group is None:
        return x[None]
    return _gather(x, group)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``x`` over the axis: the gathered parts folded in rank
    order, the same bits on every process.  ``x`` itself when nothing is
    reduced; on one process the result equals ``x`` bit for bit."""
    group = _group(mesh, axes)
    if group is None:
        return x
    parts = _gather(x, group)
    out = parts[0]
    for i in range(1, parts.shape[0]):
        out = out + parts[i]
    return out


def barrier(mesh) -> None:
    """Wait for every process of ``mesh`` (nothing to wait for on a local
    mesh)."""
    if not is_local(mesh):
        dist.barrier(group=mesh.get_group(mesh.mesh_dim_names[0]))
