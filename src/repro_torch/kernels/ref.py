"""The plain PyTorch version of every kernel in this package.

The counterpart of ``repro.kernels.ref``.  The fused round's contract is "the
engine's round, in one kernel", so its plain version is the engine's round
itself (:func:`repro_torch.core.engine.round_fn`): S commit steps of gather,
⊗, per-worker segment-⊕ (``index_add_``, or ``scatter_reduce("amin")`` from
int32 max), row update and publish; the batch round's is the same round
over the ``(n+1, Q)+feat`` batch frontier.  The loop entry's plain versions
iterate those rounds under the reference's stopping test
(:func:`fused_solve_ref`, :func:`fused_batch_solve_ref`).  The halo round's
plain version runs, per commit step, one such step on every shard's local
frontier (:func:`fused_halo_step_ref`), then the quantizer
(:func:`quantize_halo`, int8/fp8 only) and the exchange
(:func:`halo_exchange`); the ELL SpMV's sums column by column, in the
kernel's order.  A rank of a halo solve over processes runs the same step
for its own shards alone (:func:`halo_local_step_ref`, whose quantized
wire ships :func:`quantize_halo_wire`'s 1-byte values and scales) and
writes the gathered boundary rows into its shards' halo slots
(:func:`halo_recv_ref`); the batch halo round is the plain halo round over
a batch frontier (:func:`fused_halo_batch_round_ref`).  A rank of a
replicated solve over processes runs a commit step for its own workers
(:func:`round_rank_step_ref`) and publishes every worker's gathered rows
(:func:`round_publish_ref`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import chunk_reduce, round_fn
from repro_torch.core.semiring import INT_INF

__all__ = [
    "HALO_QUANT",
    "HaloStep",
    "batch_loop",
    "dequantize_halo",
    "fused_batch_round_ref",
    "fused_batch_solve_ref",
    "fused_halo_batch_round_ref",
    "fused_halo_round_ref",
    "fused_halo_step_ref",
    "fused_round_ref",
    "fused_solve_ref",
    "halo_exchange",
    "halo_local_step_ref",
    "halo_recv_ref",
    "halo_step",
    "quantize_halo",
    "quantize_halo_wire",
    "round_publish_ref",
    "round_rank_step_ref",
    "solve_loop",
    "spmv_ell_ref",
]

#: The quantized halo wires: ``halo_dtype -> (wire dtype, qmax)``.
HALO_QUANT = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}


def fused_round_ref(x_ext, sched, semiring, row_update):
    """Plain version of :func:`repro_torch.kernels.round_block.fused_round_cuda`."""
    return round_fn(sched, semiring, row_update)(x_ext)


def fused_batch_round_ref(X, sched, semiring, row_update):
    """Plain version of :func:`repro_torch.kernels.round_block.fused_batch_round_cuda`.

    The plain round over the batch frontier ``(n+1, Q)+feat``: a column of
    a matrix round is a vector round, so each query's columns get the round
    that query alone would, and labelprop's row total (its row update's
    ``_row_sum`` over the last axis) sums only each query's own F columns.
    """
    return round_fn(sched, semiring, row_update)(X)


def round_rank_step_ref(x_ext, sched, semiring, row_update, s: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.round_block.round_rank_step_cuda`.

    Commit step ``s`` of the workers ``sched`` holds (a rank's, or all),
    reading the whole ``(n + 1,)+feat`` frontier and writing nothing: each
    worker's chunk ⊕ over its edges (:func:`chunk_reduce`) and the row
    update, as :func:`repro_torch.core.engine.round_fn`'s step computes
    them.  Returns the ``(P_r·δ,)+feat`` new rows in chunk order."""
    rows_s = sched.rows[s]
    reduced = chunk_reduce(x_ext, sched.src[s], sched.val[s], sched.dst_local[s], sched.delta, semiring)
    new = row_update(x_ext[rows_s], reduced, rows_s)
    return new.reshape((-1,) + tuple(x_ext.shape[1:])).to(x_ext.dtype)


def round_publish_ref(x_ext, block, rows, s: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.round_block.round_publish_cuda`.

    The ``(P·δ,)+feat`` block of every worker into ``x_ext`` at the global
    rows ``rows[s]``, in place; dump rows (``== n``) are skipped, so the
    dump row keeps its value.  Returns ``x_ext``."""
    at = rows[s].reshape(-1).long()
    keep = at < x_ext.shape[0] - 1
    x_ext[at[keep]] = block[keep]
    return x_ext


def solve_loop(rnd, x_ext, residual, tol, max_rounds):
    """The body of the reference's ``make_solve_fn_q`` over a round ``rnd:
    x -> x``: from a residual of ``inf`` and 0 rounds, rounds while
    ``rounds < max_rounds`` and not converged, each round's residual (over
    the frontier's real rows) taken as float32 and compared with
    ``float32(tol)``.  Returns ``(x, residual, rounds, converged)``."""
    tol32 = np.float32(tol)
    res, rounds, converged = np.float32(np.inf), 0, False
    while rounds < max_rounds and not converged:
        x_new = rnd(x_ext)
        res = np.float32(residual(x_ext[:-1], x_new[:-1]).item())
        x_ext = x_new
        rounds += 1
        converged = bool(res <= tol32)
    return x_ext, res, rounds, converged


def fused_solve_ref(x_ext, sched, semiring, row_update, residual, tol, max_rounds):
    """Plain version of :func:`repro_torch.kernels.round_block.fused_solve_cuda`:
    :func:`solve_loop` over plain rounds.  It reads the residual back every
    round; the kernel reads once a call."""
    return solve_loop(round_fn(sched, semiring, row_update), x_ext, residual, tol, max_rounds)


def _batch_residuals(residual, X, X_new) -> np.ndarray:
    """``(Q,)`` float32: ``residual`` of each query of a batch frontier
    ``(n, Q)+feat``, summed over every axis but the query axis 1.  (A
    ``torch.func.vmap`` over axis 1 runs the same sums on a permuted view,
    several times slower.)"""
    dims = (0,) + tuple(range(2, X.dim()))
    return residual(X, X_new, dim=dims).to(torch.float32).cpu().numpy()


def fused_batch_solve_ref(X, sched, semiring, row_update, residual, tol, max_rounds, conv0=None):
    """Plain version of :func:`repro_torch.kernels.round_block.fused_batch_solve_cuda`.

    :func:`batch_loop` over plain batch rounds (:func:`fused_batch_round_ref`).
    Returns ``(X, residuals, rounds, converged, rounds_per_query)``.
    """
    rnd = round_fn(sched, semiring, row_update)
    return batch_loop(rnd, X, residual, tol, max_rounds, conv0)


def batch_loop(rnd, X, residual, tol, max_rounds, conv0=None, residuals=None, axis: int = 1):
    """The reference's batch loops over a batch round ``rnd: X -> X`` of the
    ``(n+1, Q)+feat`` batch frontier ``X``.

    Rounds while ``rounds < max_rounds`` and some query has not converged
    (each query's residual as float32 against ``float32(tol)``).  ``conv0``
    None: the reference's ``_make_batch_solve_fn``, every query iterating to
    the end.  Otherwise its ``_make_open_batch_solve_fn``: rows flagged in
    ``conv0`` start converged, and a row freezes, state and residual, at its
    first convergence.  Returns ``(X, residuals, rounds, converged,
    rounds_per_query)``.

    Any other state whose query axis is ``axis`` (a rank's ``(D/W, L,
    Q)+feat`` shards, ``axis = 2``) runs the same loop given
    ``residuals(X, X_new)``, the ``(Q,)`` float32 residuals of a round.
    """
    tol32 = np.float32(tol)
    Q = X.shape[axis]
    if residuals is None:
        def residuals(old, new):
            return _batch_residuals(residual, old[:-1], new[:-1])
    res = np.full(Q, np.inf, np.float32)
    conv = np.zeros(Q, bool) if conv0 is None else np.array(conv0, dtype=bool)
    rpq = np.zeros(Q, np.int32)
    rounds = 0
    while rounds < max_rounds and not conv.all():
        X_new = rnd(X)
        r = residuals(X, X_new)
        hit = r <= tol32
        rpq[~conv & hit] = rounds + 1  # stamped only at first convergence
        if conv0 is None:
            res = r
        else:
            if conv.any():
                frozen = torch.as_tensor(conv, device=X.device).reshape((1,) * axis + (Q,) + (1,) * (X.dim() - axis - 1))
                X_new = torch.where(frozen, X, X_new)
            res = np.where(conv, res, r)
        conv |= hit
        rounds += 1
        X = X_new
    return X, res, rounds, conv, rpq


@dataclasses.dataclass(frozen=True)
class HaloStep:
    """One shard's inputs to one halo commit step (views into the schedule
    and the plan, never copies).

    ``src`` holds the shard's local frontier slots (owned, then halo; dump
    ``L - 1``) in the schedule's ``(P_loc, M)`` edge order, so the
    schedule's ``dst_local`` for the shard's workers still gives each edge
    its row.  ``rows_g`` are the global row ids the row update sees (dump
    ``n``), ``rows_loc`` the local slots it reads ``old`` from and publishes
    to (dump ``L - 1``), ``send_idx`` the ``(H,)`` positions of the boundary
    rows in the flat ``(P_loc·δ,)`` chunk.
    """

    src: torch.Tensor  # (P_loc, M) int32
    val: torch.Tensor  # (P_loc, M)
    dst_local: torch.Tensor  # (P_loc, M) int32
    rows_g: torch.Tensor  # (P_loc, delta) int32
    rows_loc: torch.Tensor  # (P_loc, delta) int32
    send_idx: torch.Tensor  # (H,) int32


def halo_step(sched, plan, s: int, d: int) -> HaloStep:
    """Shard ``d``'s views for commit step ``s``.  The shard's workers
    ``[d·P_loc, (d+1)·P_loc)`` are contiguous in the schedule, so every view
    is contiguous and nothing is copied.  A rank's schedule and plan
    (``sched.w0``, ``plan.d0``: their first worker and shard) hold only
    their own workers and shards, and are indexed from there."""
    i = d - plan.d0
    w0 = d * plan.P_loc - sched.w0
    w = slice(w0, w0 + plan.P_loc)
    return HaloStep(
        src=plan.src_loc[i, s],
        val=sched.val[s, w],
        dst_local=sched.dst_local[s, w],
        rows_g=sched.rows[s, w],
        rows_loc=plan.rows_loc[i, s],
        send_idx=plan.send_idx[s, i],
    )


def fused_halo_step_ref(x_loc, step, semiring, row_update) -> torch.Tensor:
    """One shard's commit step of the halo round (the reference's
    ``fused_halo_step_fn``).

    One commit step of one shard, in place on its ``(L,)+feat`` frontier:
    the gather reads local slots, ``row_update`` sees the global rows
    ``step.rows_g`` and ``old`` from the local slots ``step.rows_loc``,
    the publish writes the local slots (padded rows land in the dump slot
    ``L - 1``).  Returns the ``(H,)+feat`` committed boundary rows
    ``chunk[step.send_idx]``.
    """
    delta = step.rows_loc.shape[1]
    reduced = chunk_reduce(x_loc, step.src, step.val, step.dst_local, delta, semiring)
    new = row_update(x_loc[step.rows_loc], reduced, step.rows_g)
    chunk = new.reshape((-1,) + tuple(x_loc.shape[1:])).to(x_loc.dtype)
    x_loc[step.rows_loc.reshape(-1)] = chunk
    return chunk[step.send_idx]


def halo_exchange(x_loc, send, recv_s) -> None:
    """All-gather the ``(D, H)+feat`` boundary rows and scatter them into
    every shard's halo slots, in place on the stacked ``(D, L)+feat``
    frontier.  ``recv_s`` indexes the ``D·L`` rows of the flattened frontier:
    ``(D·D·H,)``, shard ``e``'s copy of the gathered buffer at ``e·D·H``.

    Only dump slots are written twice.  Each takes the last entry sent to it
    in ``(d, k)`` order, as the reference's sequential scatter leaves it
    (torch's ``index_put_`` leaves duplicates in no fixed order): a padded
    row that reads ``old`` (``labelprop``) ships the dump's value, and an
    int8/fp8 wire's scale sees it."""
    D, L = x_loc.shape[:2]
    feat = tuple(x_loc.shape[2:])
    flat = x_loc.view((D * L,) + feat)
    rows = send.reshape((-1,) + feat).repeat((D,) + (1,) * len(feat))
    dump = (recv_s + 1) % L == 0
    flat[recv_s[~dump]] = rows[~dump]
    pos = torch.nonzero(dump).reshape(-1)
    if pos.numel():
        shard = recv_s[pos] // L
        last = torch.full((D,), -1, dtype=pos.dtype, device=pos.device)
        last.scatter_reduce_(0, shard, pos, "amax")
        last = last[last >= 0]
        flat[recv_s[last]] = rows[last]


def quantize_halo_wire(send, ef_s, halo_dtype: str):
    """Quantize the ``(D, H)+feat`` boundary rows per shard (and per feature
    column of a matrix frontier) against a max-abs scale over the H rows
    (floored at 1e-30), with error feedback.

    Returns ``(q, scales, new residuals)``: ``q`` the ``(D, H)+feat`` wire
    values (int8, or float8 e4m3), ``scales`` ``(D,)+feat`` float32, the
    dequantized rows being :func:`dequantize_halo` of the two.  ``want =
    send + ef_s`` is rounded then clipped (int8) or clipped then cast (fp8),
    as the reference's fused halo round does.  Its rounding is the
    reference's as XLA compiles it: ``/ qmax`` is a product with the f32
    reciprocal, and ``want - q·scale`` rounds once, as a fused multiply-add
    (``q·scale`` is exact in float64, so one rounding of the float64
    difference is the FMA's).  So the port's residuals equal the
    reference's bit for bit.  A scale is one shard's and one step's, so a
    rank quantizes its own shards' rows alone.
    """
    qdtype, qmax = HALO_QUANT[halo_dtype]
    want = send.to(torch.float32) + ef_s
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) * np.float32(1 / qmax)
    q = want / scale
    if qdtype == torch.int8:
        q = torch.round(q)
    q = q.clamp(-qmax, qmax).to(qdtype)
    ef = (want.double() - q.double() * scale.double()).to(torch.float32)
    return q, scale.squeeze(1), ef


def dequantize_halo(q, scales) -> torch.Tensor:
    """The wire's value ``fl(q · scale)`` of the ``(D, H)+feat`` quantized
    rows ``q`` with their ``(D,)+feat`` scales, as float32."""
    return q.to(torch.float32) * scales.unsqueeze(1)


def quantize_halo(send, ef_s, halo_dtype: str):
    """:func:`quantize_halo_wire` and :func:`dequantize_halo` in one:
    returns ``(dequantized rows, new residuals)``."""
    q, scales, ef = quantize_halo_wire(send, ef_s, halo_dtype)
    return dequantize_halo(q, scales), ef


def fused_halo_round_ref(
    x_loc, ef, sched, plan, semiring, row_update, halo_dtype: str = "f32", steps=None
):
    """Plain version of :func:`repro_torch.kernels.round_block.fused_halo_round_cuda`.

    The commit steps ``steps = (s0, s1)`` (default: all ``S``) of the halo
    round, in place on the stacked ``(D, L)+feat`` frontier ``x_loc`` and,
    for an int8/fp8 wire, on the ``(D, S, H)+feat`` residuals ``ef``: per
    step, every
    shard's :func:`fused_halo_step_ref`, then :func:`quantize_halo` (unless
    f32) and :func:`halo_exchange`.  Returns ``(x_loc, ef)``.
    """
    s0, s1 = (0, sched.S) if steps is None else steps
    offs = torch.arange(plan.D, device=x_loc.device)[:, None] * plan.L
    for s in range(s0, s1):
        send = torch.stack(
            [
                fused_halo_step_ref(x_loc[d], halo_step(sched, plan, s, d), semiring, row_update)
                for d in range(plan.D)
            ]
        )
        if halo_dtype != "f32":
            send, ef[:, s] = quantize_halo(send, ef[:, s], halo_dtype)
        recv = (plan.recv_idx[s].long() + offs).reshape(-1)
        halo_exchange(x_loc, send.to(x_loc.dtype), recv)
    return x_loc, ef


def fused_halo_batch_round_ref(X_loc, sched, plan, semiring, epilogue):
    """Plain version of :func:`repro_torch.kernels.round_block.fused_halo_batch_round_cuda`.

    The plain halo round (f32 wire) over a batch frontier ``(D, L, Q)+feat``,
    in place; ``epilogue`` an ``Epilogue.for_batch`` row update, whose table
    is ``(n + 1, Q)+feat``.  A column of the batch gets the round its query
    alone would (labelprop's row total sums each query's own F columns), so
    it equals Q single plain halo rounds bit for bit.  Returns ``X_loc``.
    """
    return fused_halo_round_ref(X_loc, None, sched, plan, semiring, epilogue)[0]


def halo_local_step_ref(x_loc, ef, sched, plan, semiring, row_update, wire: str, s: int, d0: int, d1: int):
    """Plain version of :func:`repro_torch.kernels.round_block.halo_local_step_cuda`.

    Commit step ``s`` of shards ``[d0, d1)`` alone, in place on their
    ``(d1 - d0, L)+feat`` frontier ``x_loc`` (each shard's
    :func:`fused_halo_step_ref`: its workers' rows, published into its
    owned slots).  Returns the send block ``(rows, scales)``: for the f32
    wire the ``(d1 - d0, H)+feat`` committed boundary rows and ``None``;
    for int8/fp8 :func:`quantize_halo_wire`'s values and ``(d1 - d0,)+feat``
    scales, with ``ef[:, s]`` (``ef`` the shards' ``(d1 - d0, S, H)+feat``
    residuals) updated in place.  ``sched`` and ``plan`` hold at least those
    shards (a rank's, or the whole).
    """
    send = torch.stack(
        [fused_halo_step_ref(x_loc[d - d0], halo_step(sched, plan, s, d), semiring, row_update) for d in range(d0, d1)]
    )
    if wire == "f32":
        return send, None
    q, scales, ef[:, s] = quantize_halo_wire(send, ef[:, s], wire)
    return q, scales


def halo_recv_ref(x_loc, recv_rows, recv_scales, plan, s: int, e0: int, e1: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.round_block.halo_recv_cuda`.

    Writes the gathered ``(D, H)+feat`` boundary rows of step ``s`` (every
    shard's send block, in shard order) into the halo slots of shards
    ``[e0, e1)``, in place on their ``(e1 - e0, L)+feat`` frontier, through
    ``recv_idx[s, e, d·H + k]``.  ``recv_scales`` None: f32 rows, and dump
    slots are skipped.  Otherwise ``recv_rows`` are the quantized values and
    ``recv_scales`` the ``(D,)+feat`` scales: each row is ``fl(q · scale)``
    (:func:`dequantize_halo`), and the dump slot takes the entry
    ``dump_last[s, e]`` names, the last one the plain exchange leaves there
    (as K2's phase C does).  Returns ``x_loc``.
    """
    feat = tuple(x_loc.shape[2:])
    rows = recv_rows if recv_scales is None else dequantize_halo(recv_rows, recv_scales)
    rows = rows.to(x_loc.dtype).reshape((-1,) + feat)
    dump = plan.L - 1
    for e in range(e0, e1):
        i = e - plan.d0
        idx = plan.recv_idx[s, i].long()
        keep = idx < dump
        x_loc[e - e0][idx[keep]] = rows[keep]
        if recv_scales is not None:
            last = plan.dump_last[s, i].long()
            x_loc[e - e0][dump] = torch.where(last >= 0, rows[last.clamp_min(0)], x_loc[e - e0][dump])
    return x_loc


def spmv_ell_ref(x_ext, idx, val, semiring: str) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.spmv_ell.spmv_ell_cuda`.

    ``(rows,)+feat``: ``acc = acc ⊕ (x_ext[idx[:, j]] ⊗ val[:, j])`` for each
    column ``j`` in order, from the ⊕-identity.  Min-plus widens to int64
    and saturates at ``INT_INF``, as ``repro.kernels.ref.spmv_ell_ref`` does.
    """
    rows, max_deg = idx.shape
    feat = tuple(x_ext.shape[1:])
    col = (slice(None),) + (None,) * len(feat)  # val[:, j] broadcast over feat
    if semiring == "plus_times":
        acc = torch.zeros((rows,) + feat, dtype=x_ext.dtype, device=x_ext.device)
        for j in range(max_deg):
            acc = acc + x_ext[idx[:, j]] * val[:, j][col]
        return acc
    if semiring == "min_plus":
        inf = int(INT_INF)
        acc = torch.full((rows,) + feat, inf, dtype=torch.int64, device=x_ext.device)
        for j in range(max_deg):
            relaxed = x_ext[idx[:, j]].long() + val[:, j][col].long()
            acc = torch.minimum(acc, relaxed.clamp_max(inf))
        return acc.to(val.dtype)
    raise ValueError(semiring)
