"""Dispatch between the CUDA kernels and their plain versions, and the host
side ELL layout builder.

The counterpart of ``repro.kernels.ops``.  A CUDA tensor goes to the kernel,
which launches or raises; only a tensor on the CPU goes to the plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.semiring import INT_INF
from repro_torch.kernels import ref
from repro_torch.kernels.round_block import (
    fused_batch_round_cuda,
    fused_batch_solve_cuda,
    fused_halo_batch_round_cuda,
    fused_halo_round_cuda,
    fused_round_cuda,
    fused_solve_cuda,
    halo_local_step_cuda,
    halo_recv_cuda,
    round_publish_cuda,
    round_rank_step_cuda,
)
from repro_torch.kernels.spmv_ell import spmv_ell_cuda

__all__ = [
    "ell_from_csr",
    "fused_batch_round",
    "fused_batch_solve",
    "fused_halo_batch_round",
    "fused_halo_round",
    "fused_round",
    "fused_solve",
    "halo_local_step",
    "halo_recv",
    "round_publish",
    "round_rank_step",
    "spmv",
]


def _route(x, kernel, plain, what):
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no {what} for device {x.device}")


def fused_round(x_ext, sched, semiring, row_update):
    """One full engine round (all S commit steps) over ``sched``."""
    fn = _route(x_ext, fused_round_cuda, ref.fused_round_ref, "fused round")
    return fn(x_ext, sched, semiring, row_update)


def fused_batch_round(X, sched, semiring, row_update):
    """One round over ``sched`` for a batch of Q queries, ``(n+1, Q)+feat``."""
    fn = _route(X, fused_batch_round_cuda, ref.fused_batch_round_ref, "batch round")
    return fn(X, sched, semiring, row_update)


def round_rank_step(x_ext, sched, semiring, row_update, s):
    """Commit step ``s`` of the workers ``sched`` holds, reading the whole
    ``(n + 1,)+feat`` frontier: their ``(P_r·δ,)+feat`` new rows."""
    fn = _route(x_ext, round_rank_step_cuda, ref.round_rank_step_ref, "rank step")
    return fn(x_ext, sched, semiring, row_update, s)


def round_publish(x_ext, block, rows, s):
    """Step ``s``'s ``(P·δ,)+feat`` rows of every worker into ``x_ext`` at
    ``rows[s]``, in place; returns ``x_ext``."""
    fn = _route(x_ext, round_publish_cuda, ref.round_publish_ref, "publish")
    return fn(x_ext, block, rows, s)


def fused_solve(x_ext, sched, semiring, row_update, residual, tol, max_rounds):
    """Rounds over ``sched`` until ``residual`` ≤ ``float32(tol)`` or
    ``max_rounds``: ``(x, residual, rounds, converged)``."""
    fn = _route(x_ext, fused_solve_cuda, ref.fused_solve_ref, "solve loop")
    return fn(x_ext, sched, semiring, row_update, residual, tol, max_rounds)


def fused_batch_solve(X, sched, semiring, row_update, residual, tol, max_rounds, conv0=None):
    """Rounds of a batch of Q queries until every query's residual is ≤
    ``float32(tol)`` or ``max_rounds`` (``conv0``: an open batch's flags):
    ``(X, residuals, rounds, converged, rounds_per_query)``."""
    fn = _route(X, fused_batch_solve_cuda, ref.fused_batch_solve_ref, "batch solve loop")
    return fn(X, sched, semiring, row_update, residual, tol, max_rounds, conv0)


def fused_halo_round(x_loc, ef, sched, plan, semiring, row_update, halo_dtype="f32", steps=None):
    """The commit steps ``steps`` (default: all) of one halo round over every
    shard of the stacked ``(D, L)`` frontier, in place on ``x_loc`` and (for
    an int8/fp8 wire) on the residuals ``ef``; returns ``(x_loc, ef)``."""
    fn = _route(x_loc, fused_halo_round_cuda, ref.fused_halo_round_ref, "halo round")
    return fn(x_loc, ef, sched, plan, semiring, row_update, halo_dtype, steps)


def fused_halo_batch_round(X_loc, sched, plan, semiring, row_update):
    """One halo round over every shard of a batch frontier ``(D, L,
    Q)+feat``, in place (f32 or int32 wire); returns ``X_loc``."""
    fn = _route(X_loc, fused_halo_batch_round_cuda, ref.fused_halo_batch_round_ref, "halo batch round")
    return fn(X_loc, sched, plan, semiring, row_update)


def halo_local_step(x_loc, ef, sched, plan, semiring, row_update, halo_dtype, s, d0, d1):
    """Commit step ``s`` of shards ``[d0, d1)`` of a halo round, in place on
    their ``(d1 - d0, L)+feat`` frontier (and ``ef``); returns their send
    block ``(rows, scales)`` (scales None for f32)."""
    fn = _route(x_loc, halo_local_step_cuda, ref.halo_local_step_ref, "halo rank step")
    return fn(x_loc, ef, sched, plan, semiring, row_update, halo_dtype, s, d0, d1)


def halo_recv(x_loc, recv_rows, recv_scales, plan, s, e0, e1):
    """Step ``s``'s gathered ``(D, H)+feat`` boundary rows (and int8/fp8
    scales) into the halo slots of shards ``[e0, e1)``; returns ``x_loc``."""
    fn = _route(x_loc, halo_recv_cuda, ref.halo_recv_ref, "halo receive")
    return fn(x_loc, recv_rows, recv_scales, plan, s, e0, e1)


def spmv(x_ext, idx, val, semiring: str = "plus_times"):
    """Semiring SpMV over ELL rows: ``(rows,)+feat``."""
    fn = _route(x_ext, spmv_ell_cuda, ref.spmv_ell_ref, "spmv")
    return fn(x_ext, idx, val, semiring)


#: Rows laid out at a time by :func:`ell_from_csr`: bounds its int64
#: intermediates to ``ELL_CHUNK_ROWS × max_deg`` entries.
ELL_CHUNK_ROWS = 1 << 18
#: :func:`ell_from_csr` pads ``max_deg`` to a multiple of this by default.
ELL_LANE_PAD = 128


def ell_from_csr(graph, rows_slice=None, lane_pad: int = ELL_LANE_PAD):
    """Padded ELL ``(idx, val)`` from a CSRGraph (host side, numpy).

    The same arrays as ``repro.kernels.ops.ell_from_csr``: slot ``(i, j)``
    holds row ``rows_slice[i]``'s ``j``-th in-edge (every row when
    ``rows_slice`` is None); padding gathers vertex 0 and carries the
    semiring's annihilating value (0.0, or ``INT_INF`` for int32), so it
    contributes the ⊕-identity.  ``max_deg``, the longest selected row, is
    padded to a multiple of ``lane_pad``.  Rows are laid out
    :data:`ELL_CHUNK_ROWS` at a time, so the host never holds a full-size
    ``(rows, max_deg)`` int64 intermediate.
    """
    indptr, indices, values = graph.indptr, graph.indices, graph.values
    rows = np.arange(graph.n) if rows_slice is None else np.asarray(rows_slice)
    starts = indptr[rows]
    degs = (indptr[rows + 1] - starts).astype(np.int64)
    max_deg = int(max(degs.max() if degs.size else 0, 1))
    max_deg = -(-max_deg // lane_pad) * lane_pad
    pad_val = np.float32(0.0) if values.dtype.kind == "f" else INT_INF
    idx = np.zeros((len(rows), max_deg), np.int32)
    val = np.full((len(rows), max_deg), pad_val, values.dtype)
    if graph.nnz == 0:
        return idx, val
    offs = np.arange(max_deg, dtype=np.int64)[None, :]
    for r0 in range(0, len(rows), ELL_CHUNK_ROWS):
        r1 = min(r0 + ELL_CHUNK_ROWS, len(rows))
        mask = offs < degs[r0:r1, None]
        pos = (starts[r0:r1][:, None] + offs)[mask]
        idx[r0:r1][mask] = indices[pos]
        val[r0:r1][mask] = values[pos]
    return idx, val
