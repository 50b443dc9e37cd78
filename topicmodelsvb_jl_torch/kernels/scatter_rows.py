"""M-step scatter: the CUDA kernel's wrapper, its plain version and its plan.

The kernel (``csrc/scatter_rows.cu``) replaces the JAX package's Pallas
kernel ``pallas_once`` (bench_scatter_pallas.py:40): the scatter-accumulate
``acc[ids[t], :] += weights[t, :]`` of a chunk's token rows into a [V, W]
table, the reference's ``beta_temp[:, terms] += phi .* counts'``
(LDA.jl:129-132) and its kappa, alef and he analogues.

The ids of a chunk never change during a run, so a :class:`ScatterPlan`
is built once on the host (:func:`build_plan`) and uploaded with the data:

* only the slots whose weight factor is nonzero are kept (``counts > 0``,
  ``ratings > 0``): the other rows are exact zeros, and adding an exact
  zero changes no bit of a sum of nonnegative rows;
* the kept slots are stably sorted by id and cut into runs of one id;
* each run is cut into pieces of at most ``PIECE_ROWS`` rows, so a long
  run (the Zipf head of the vocabulary) spreads over many warps; the
  pieces of such a split run write partial rows, which a second launch
  adds in a fixed order.

Everything a call needs besides ``acc`` and the weights is set up once per
plan, not once per call: the plan's index tensors are checked when the
plan is built or moved (``ScatterPlan.__post_init__``), the scratch rows
of the split runs' partials are allocated at the first call for a given
width W and dtype and kept on the plan, and the C entry point is looked up once per
process.  A call checks only ``acc`` and the weights.  A plan serves one
stream at a time: two scatters along one plan must not run concurrently,
since they share its scratch rows.

Both versions take ``(acc, weights, plan)`` with acc [V, W] and weights
[T, W], add into ``acc`` in place and return it.  The kernel has a
float32 and a float64 mode; ``acc``'s dtype picks it.  The plain version adds
each id's kept rows in slot order with ``index_add_``; on the CPU that is
bitwise equal to ``index_add_`` over all T rows.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build
from ._build import check, require

PIECE_ROWS = 256   # rows one warp sums before a run is split

_INDEX_FIELDS = ("rows", "ids", "piece_start", "piece_id", "piece_out", "run_start",
                 "run_id")


@dataclasses.dataclass
class ScatterPlan:
    """The kept slots of one chunk, sorted by id and cut into pieces.

    Index tensors are int32.  ``piece_out[p]`` is -1 for a piece that is a
    whole run (it adds into its acc row), else the scratch row its partial
    goes to; the split runs' scratch rows are consecutive, from
    ``run_start[r]`` to ``run_start[r + 1]``."""

    T: int                     # slots of the chunk: rows of the weights
    max_id: int                # largest kept id, -1 when nothing is kept
    n_scratch: int             # pieces of the split runs
    rows: torch.Tensor         # [n] kept slots, stably sorted by id
    ids: torch.Tensor          # [n] their ids
    piece_start: torch.Tensor  # [n_pieces + 1] offsets into rows
    piece_id: torch.Tensor     # [n_pieces]
    piece_out: torch.Tensor    # [n_pieces]
    run_start: torch.Tensor    # [n_runs + 1] offsets into the scratch rows
    run_id: torch.Tensor       # [n_runs] ids of the split runs
    scratch: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False)   # (W, dtype) -> [n_scratch, W]

    def __post_init__(self):
        n, n_pc, n_runs = self.rows.shape[0], self.piece_id.shape[0], self.run_id.shape[0]
        want = {"rows": n, "ids": n, "piece_start": n_pc + 1, "piece_id": n_pc,
                "piece_out": n_pc, "run_start": n_runs + 1, "run_id": n_runs}
        require("ScatterPlan", self.rows.device, {
            f: (getattr(self, f), (want[f],), torch.int32) for f in _INDEX_FIELDS})

    @property
    def n_pieces(self) -> int:
        return self.piece_id.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def to(self, device) -> "ScatterPlan":
        return dataclasses.replace(self, **{f: getattr(self, f).to(device)
                                            for f in _INDEX_FIELDS})

    def scratch_rows(self, W: int, dtype=torch.float32) -> torch.Tensor:
        """The [n_scratch, W] scratch of the split runs' partials, in the
        accumulator's dtype."""
        buf = self.scratch.get((W, dtype))
        if buf is None:
            buf = self.scratch[(W, dtype)] = torch.empty((self.n_scratch, W), dtype=dtype,
                                                         device=self.device)
        return buf


def build_plan(ids, keep, piece_rows: int = PIECE_ROWS) -> ScatterPlan:
    """Plan the scatter of the slots ``keep`` (bool, any shape) by ``ids``
    (same shape), both flattened in row-major order; on the CPU."""
    ids = np.asarray(ids).reshape(-1)
    keep = np.asarray(keep, dtype=bool).reshape(-1)
    if ids.shape != keep.shape:
        raise ValueError(f"ids {ids.shape} and keep {keep.shape} differ")
    if piece_rows < 1:
        raise ValueError("piece_rows must be positive")
    if ids.size >= 2**31:
        raise ValueError("a chunk of 2**31 slots or more does not fit int32")
    slots = np.flatnonzero(keep)
    rows = slots[np.argsort(ids[slots], kind="stable")]
    sid = ids[rows].astype(np.int64)
    n = rows.size
    if n and (sid[0] < 0 or sid[-1] >= 2**31):
        raise ValueError("ids must lie in [0, 2**31)")
    run_lo = np.flatnonzero(np.r_[True, sid[1:] != sid[:-1]]) if n else np.zeros(0, np.int64)
    run_len = np.diff(np.r_[run_lo, n])
    n_pc = -(-run_len // piece_rows)                       # pieces per run
    run_of = np.repeat(np.arange(run_lo.size), n_pc)       # run of each piece
    k = np.arange(n_pc.sum()) - np.repeat(np.cumsum(n_pc) - n_pc, n_pc)
    piece_start = np.r_[run_lo[run_of] + k * piece_rows, n]
    split = n_pc > 1
    piece_out = np.full(run_of.size, -1, np.int64)
    n_scratch = int(n_pc[split].sum())
    piece_out[split[run_of]] = np.arange(n_scratch)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return ScatterPlan(
        T=int(ids.size), max_id=int(sid[-1]) if n else -1, n_scratch=n_scratch,
        rows=i32(rows), ids=i32(sid), piece_start=i32(piece_start),
        piece_id=i32(sid[piece_start[:-1]]), piece_out=i32(piece_out),
        run_start=i32(np.r_[0, np.cumsum(n_pc[split])]), run_id=i32(sid[run_lo[split]]))


def scatter_rows_ref(acc: torch.Tensor, weights: torch.Tensor,
                     plan: ScatterPlan) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return acc.index_add_(0, plan.ids, weights[plan.rows])


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]


def scatter_rows(acc: torch.Tensor, weights: torch.Tensor,
                 plan: ScatterPlan) -> torch.Tensor:
    """``acc[ids[t], :] += weights[t, :]`` for the plan's kept slots, in
    place; returns ``acc``.

    CPU tensors take :func:`scatter_rows_ref`; CUDA tensors launch the
    kernel, in its float32 or float64 mode as ``acc``'s dtype says, with
    ``weights`` of the same dtype, or raise.  A plan that keeps nothing
    launches nothing."""
    if acc.device.type == "cpu":
        return scatter_rows_ref(acc, weights, plan)
    if acc.device.type != "cuda":
        raise ValueError(f"scatter_rows: no kernel for device {acc.device}")
    if acc.dim() != 2:
        raise ValueError("scatter_rows: acc must be 2-D")
    V, W = acc.shape
    if plan.max_id >= V:
        raise ValueError(f"scatter_rows: the plan's ids reach {plan.max_id}, "
                         f"acc has {V} rows")
    if W >= 2**31:
        raise ValueError("scatter_rows: rows of 2**31 columns or more")
    if plan.device != acc.device:
        raise ValueError(f"scatter_rows: the plan's rows is on {plan.device}, "
                         f"expected {acc.device}")
    dtype = acc.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"scatter_rows: acc must be torch.float32 or torch.float64, "
                        f"got {dtype}")
    require("scatter_rows", acc.device, {
        "acc": (acc, (V, W), dtype),
        "weights": (weights, (plan.T, W), dtype)})
    if plan.n_pieces == 0:
        return acc
    scratch = plan.scratch_rows(W, dtype)
    # 16-byte lanes: 4 floats or 2 doubles
    vec = W % (16 // acc.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (acc, weights, scratch))
    err = _build.launch(
        _build.function(_ENTRY[dtype], _ARGTYPES), acc.device,
        *(t.data_ptr() for t in (weights, plan.rows, plan.piece_start, plan.piece_id,
                                 plan.piece_out, plan.run_start, plan.run_id, acc, scratch)),
        plan.n_pieces, plan.run_id.shape[0], W, int(vec))
    check(err, "scatter_rows")
    scatter_rows.launches += 1
    scatter_rows.launches_double += dtype == torch.float64
    return acc


# the C entry point of each mode
_ENTRY = {torch.float32: "tmvb_scatter_rows", torch.float64: "tmvb_scatter_rows_f64"}
scatter_rows.launches = 0   # kernel launches (the plain version is not counted)
scatter_rows.launches_double = 0   # of them, launches of the float64 mode
