"""Collectives over mesh axes, for the model steps and bounds.

The port of the JAX package's ``parallel/shard.py`` and of the
``jax.lax`` collectives its models call under ``shard_map``.  JAX's
``dp_jit`` wraps a step in ``jit(shard_map(...))`` so one program runs on
every device; torch runs eagerly, one process per device, so a step
needs no wrapper: each process calls it on its own slab, and the
functions below are its ``psum``, ``pmax``, tiled ``all_gather`` and
``psum_scatter``, over one axis or a tuple of axes (the sub-mesh of
those axes through this process), and :func:`tp_normalize_rows`.

Every reduction gathers the processes' parts and folds them in the
group's rank order, so every process of the group gets the same bits
whatever the backend's all-reduce algorithm; on two processes the fold
is JAX's ``psum`` on a two-device mesh.  Every process must make the same calls in the same
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

from .mesh import axis_index, axis_size, axis_tuple, is_local


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


def _group(mesh, axes):
    """The process group of the sub-mesh over ``axes`` (a name or a tuple
    of names), or None when nothing is reduced (no mesh, a local mesh, no
    axes)."""
    axes = axis_tuple(axes)
    if is_local(mesh) or not axes:
        return None
    return mesh.group(axes)


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


def all_gather(x: torch.Tensor, mesh, axes, dim=None) -> torch.Tensor:
    """Every process's ``x`` along the axes, in the group's rank order:
    stacked as ``[n, *x.shape]`` (``x[None]`` when nothing is reduced),
    or with ``dim`` concatenated along it (JAX's tiled ``all_gather``;
    ``x`` itself when nothing is reduced)."""
    group = _group(mesh, axes)
    if group is None:
        return x[None] if dim is None else x
    parts = _gather(x, group)
    return parts if dim is None else torch.cat(tuple(parts), dim=dim)


def _fold(parts: torch.Tensor) -> torch.Tensor:
    out = parts[0]
    for i in range(1, parts.shape[0]):
        out = out + parts[i]
    return out


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``x`` over the axes: the gathered parts folded in rank
    order, the same bits on every process of the group.  ``x`` itself
    when nothing is reduced; on one process the result equals ``x`` bit
    for bit."""
    group = _group(mesh, axes)
    if group is None:
        return x
    return _fold(_gather(x, group))


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the axes."""
    group = _group(mesh, axes)
    if group is None:
        return x
    return torch.amax(_gather(x, group), dim=0)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """JAX's tiled ``psum_scatter``: the sum of ``x`` over ``axis``, of
    which this process keeps block ``axis_index`` of ``dim`` (the parts
    gathered, folded in rank order and cut)."""
    group = _group(mesh, axis)
    if group is None:
        return x
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: {x.shape[dim]} entries along dim {dim} do not "
                         f"divide into {n} shards")
    per = x.shape[dim] // n
    return _fold(_gather(x, group)).narrow(dim, i * per, per).contiguous()


def tp_normalize_rows(stat: torch.Tensor, mesh, vocab_axis: str, axes) -> tuple:
    """Reduce a ``[rows, K]`` sufficient statistic whose parameter storage
    is sharded over ``vocab_axis`` (the JAX package's
    ``parallel/shard.tp_normalize_rows``): the sum over ``vocab_axis``
    with only this process's rows kept, summed over the other ``axes``;
    returns ``(local_stat [rows/n, K], row_sums [K])``, the row sums over
    the FULL row axis, so dividing by them gives the unsharded update's
    stochastic rows."""
    local = psum_scatter(stat, mesh, vocab_axis, dim=0)
    rest = tuple(a for a in axis_tuple(axes) if a != vocab_axis)
    if rest:
        local = psum(local, mesh, rest)
    return local, psum(torch.sum(local, dim=0), mesh, vocab_axis)


def barrier(mesh) -> None:
    """Wait for every process of ``mesh`` (nothing to wait for on a local
    mesh)."""
    if not is_local(mesh):
        dist.barrier(group=mesh.group(mesh.mesh_dim_names))
