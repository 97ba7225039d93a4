"""The delayed-asynchronous iterative engine, on torch tensors.

The counterpart of ``repro.core.engine``.  One *round* processes every vertex
once, in ``S`` **commit steps**.  Commit step ``s`` computes, for every worker,
the pull-update of chunk ``s`` (δ rows) of that worker's block reading the
*current committed* frontier, then publishes all workers' chunks at once.
This is a deterministic block Gauss–Seidel schedule with commit period δ:

* ``S == 1``   (δ = block size)  → exact Jacobi          = paper's *synchronous*
* ``S == B/δ_min`` (finest δ)    → finest block GS       = paper's *asynchronous*
* in between                     → *delayed asynchronous* (the hybrid)

:func:`round_fn` is the plain PyTorch round; the CUDA kernel
(:mod:`repro_torch.kernels.round_block`) computes the same round in one
launch, and its loop entry runs rounds to convergence in one launch
(:func:`fused_loop`, the reference's ``execute_solve_fn``).
:func:`host_loop` steps rounds from the host, reading every round's
residual back.  Every function takes its tensors on an explicit device.  The
frontier is a vector ``(n+1,)`` or a matrix ``(n+1, F)`` (F independent
columns sharing the schedule); for a vector every feature-axis reshape here
is the identity, so the vector round is unchanged.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.semiring import Semiring
from repro_torch.ft.inject import fire
from repro_torch.graphs.formats import CSRGraph, build_stripe_schedule
from repro_torch.graphs.partition import balanced_blocks

__all__ = [
    "EngineResult",
    "DeviceSchedule",
    "make_schedule",
    "stripe_schedule_arrays",
    "round_fn",
    "host_loop",
    "fused_loop",
    "extend_frontier",
    "chunk_reduce",
    "MIN_CHUNK",
]

# Finest commit granularity of the reference (one TPU lane row).  Kept as the
# default so that the port's schedules match the reference's.
MIN_CHUNK = 128


def extend_frontier(x0, semiring: Semiring, device) -> torch.Tensor:
    """Append the padding-dump slot: ``(n,)+feat → (n+1,)+feat``, the dump
    row filled with the ⊕-identity.  The frontier is a vector ``(n,)`` or a
    matrix ``(n, F)``."""
    x0 = torch.tensor(np.asarray(x0, dtype=semiring.dtype), device=device)
    pad = torch.full((1,) + x0.shape[1:], semiring.zero.item(), dtype=x0.dtype, device=device)
    return torch.cat([x0, pad])


def _cell_row_ptr(dst_local: torch.Tensor, delta: int) -> torch.Tensor:
    """``(S, P, δ+1)`` int32: row ``r`` of a cell owns edges ``[ptr[r], ptr[r+1])``.

    Edges of a cell are in CSR order, grouped by destination row, with the
    padding (``dst_local == δ``) at the end, so each row's edges are one run
    and ``ptr[δ]`` is the cell's count of real edges.
    """
    S, P, _ = dst_local.shape
    r = torch.arange(delta + 1, dtype=torch.int32, device=dst_local.device)
    r = r.expand(S, P, delta + 1).contiguous()
    return torch.searchsorted(dst_local, r, out_int32=True)


@dataclasses.dataclass(frozen=True)
class DeviceSchedule:
    """The stripe schedule as tensors on one device, plus metadata.

    ``row_ptr`` is derived from ``dst_local``: the CUDA kernel walks each
    row's edges through it and never reads a padding entry.
    """

    n: int
    P: int
    delta: int
    S: int
    M: int
    src: torch.Tensor  # (S, P, M) int32
    val: torch.Tensor  # (S, P, M)
    dst_local: torch.Tensor  # (S, P, M) int32
    rows: torch.Tensor  # (S, P, delta) int32
    row_ptr: torch.Tensor  # (S, P, delta + 1) int32
    edges: int
    padding_overhead: float
    block_bounds: np.ndarray | None = None  # (P + 1,) int64 host-side bounds

    @property
    def n_slots(self) -> int:
        return self.n + 1

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def w0(self) -> int:
        """The first worker of its cells: 0 (a rank's schedule,
        :class:`repro_torch.dist.engine_sharded.RankSchedule`, holds a range)."""
        return 0

    def to_host_arrays(self) -> dict:
        """Flat ``{name: ndarray}`` dict round-trippable through ``np.savez``:
        the reference's keys.  ``row_ptr`` is left out: it is derived."""
        return {
            "n": np.int64(self.n),
            "P": np.int64(self.P),
            "delta": np.int64(self.delta),
            "S": np.int64(self.S),
            "M": np.int64(self.M),
            "src": self.src.cpu().numpy(),
            "val": self.val.cpu().numpy(),
            "dst_local": self.dst_local.cpu().numpy(),
            "rows": self.rows.cpu().numpy(),
            "edges": np.int64(self.edges),
            "padding_overhead": np.float64(self.padding_overhead),
            "block_bounds": np.asarray(self.block_bounds if self.block_bounds is not None else []),
        }

    @classmethod
    def from_host_arrays(cls, arrays, device) -> "DeviceSchedule":
        """Build from :meth:`to_host_arrays` output (or ``repro``'s, which has
        the same keys), shape-validated, with the tensors on ``device`` and
        ``row_ptr`` derived there from ``dst_local``."""
        n, P = int(arrays["n"]), int(arrays["P"])
        delta, S, M = int(arrays["delta"]), int(arrays["S"]), int(arrays["M"])
        src = np.asarray(arrays["src"])
        val = np.asarray(arrays["val"])
        dst_local = np.asarray(arrays["dst_local"])
        rows = np.asarray(arrays["rows"])
        if (
            src.shape != (S, P, M)
            or val.shape != (S, P, M)
            or dst_local.shape != (S, P, M)
            or rows.shape != (S, P, delta)
        ):
            raise ValueError("schedule arrays inconsistent with (S, P, M, delta)")
        bb = np.asarray(arrays["block_bounds"])
        dst_t = torch.tensor(dst_local, device=device)  # copies: never aliases
        return cls(
            n=n,
            P=P,
            delta=delta,
            S=S,
            M=M,
            src=torch.tensor(src, device=device),
            val=torch.tensor(val, device=device),
            dst_local=dst_t,
            rows=torch.tensor(rows, device=device),
            row_ptr=_cell_row_ptr(dst_t, delta),
            edges=int(arrays["edges"]),
            padding_overhead=float(arrays["padding_overhead"]),
            block_bounds=bb.astype(np.int64) if bb.size else None,
        )


def make_schedule(
    graph: CSRGraph,
    P: int,
    delta: int | None,
    semiring: Semiring,
    mode: str = "delayed",
    min_chunk: int = MIN_CHUNK,
    bounds: np.ndarray | None = None,
    device="cpu",
) -> DeviceSchedule:
    """Build the device schedule for ``mode`` ∈ {sync, async, delayed}.

    * ``sync``    → δ = max block size (one commit per round).
    * ``async``   → δ = ``min_chunk`` (finest commit).
    * ``delayed`` → δ as given (the paper's tunable).

    ``bounds`` overrides the default :func:`balanced_blocks` partition.
    """
    if bounds is None:
        bounds = balanced_blocks(graph, P)
    else:
        bounds = np.asarray(bounds, dtype=np.int64)
        if bounds.shape != (P + 1,):
            raise ValueError(f"bounds must have shape ({P + 1},), got {bounds.shape}")
        if bounds[0] != 0 or bounds[-1] != graph.n or (np.diff(bounds) < 0).any():
            raise ValueError("bounds must cover [0, n] with monotone cuts")
    B = int(np.diff(bounds).max())
    if mode == "sync":
        delta_eff = B
    elif mode == "async":
        delta_eff = min(min_chunk, B)
    elif mode == "delayed":
        if delta is None:
            raise ValueError("delayed mode needs δ")
        delta_eff = int(min(max(delta, 1), B))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    host = build_stripe_schedule(graph, bounds, delta_eff, semiring.pad_edge_val)
    return DeviceSchedule.from_host_arrays(stripe_schedule_arrays(host), device)


def stripe_schedule_arrays(host) -> dict:
    """A host :class:`~repro_torch.graphs.formats.StripeSchedule` as the dict
    :meth:`DeviceSchedule.to_host_arrays` gives (the arrays not copied)."""
    return {
        "n": host.n,
        "P": host.P,
        "delta": host.delta,
        "S": host.S,
        "M": host.M,
        "src": host.src,
        "val": host.val,
        "dst_local": host.dst_local,
        "rows": host.rows,
        "edges": host.edges,
        "padding_overhead": host.padding_overhead,
        "block_bounds": host.block_bounds,
    }


def chunk_reduce(x, src_s, val_s, dst_s, delta: int, semiring: Semiring):
    """``(P, δ)+feat``: each worker's chunk of one commit step, ⊕ over its edges.

    Gathers ``x[src_s]``, applies ⊗ with ``val_s`` (one weight per edge,
    broadcast over the feature axis of a matrix frontier) and runs a
    per-worker segment-⊕ into ``δ + 1`` slots (the last is the padding dump,
    dropped).
    """
    P = src_s.shape[0]
    feat = tuple(x.shape[1:])  # () for a vector frontier, (F,) for a matrix
    val_b = val_s.reshape(tuple(val_s.shape) + (1,) * len(feat))
    contrib = semiring.mul(x[src_s], val_b)  # (P, M)+feat
    offs = torch.arange(P, dtype=torch.int32, device=x.device) * (delta + 1)
    seg = dst_s + offs[:, None]
    return semiring.segment_reduce(
        contrib.reshape((-1,) + feat), seg.reshape(-1), P * (delta + 1)
    ).reshape((P, delta + 1) + feat)[:, :delta]


def _commit_step(s: int, x_ext, sched: DeviceSchedule, semiring: Semiring, row_update):
    """One commit step, in place on ``x_ext``: chunk-SpMV for all workers + publish.

    Every read (the gather and ``old``) is taken before the publish, so the
    step sees the commits of the steps before it and none of its own.
    """
    rows_s = sched.rows[s]
    reduced = chunk_reduce(
        x_ext, sched.src[s], sched.val[s], sched.dst_local[s], sched.delta, semiring
    )
    new = row_update(x_ext[rows_s], reduced, rows_s)
    # Publish: the flush.  Padding rows all land on the dump slot (index n),
    # whose value is unspecified.
    x_ext[rows_s.reshape(-1)] = new.reshape((-1,) + tuple(x_ext.shape[1:])).to(x_ext.dtype)


def round_fn(sched: DeviceSchedule, semiring: Semiring, row_update) -> Callable:
    """Return the plain round ``x_ext -> x_ext`` (S commit steps, out of place).

    ``row_update(old, reduced, rows) -> new`` is any torch callable; the
    problems' :class:`repro_torch.kernels.round_block.Epilogue` is one.
    """

    def body(x_ext):
        x = x_ext.clone()
        for s in range(sched.S):
            _commit_step(s, x, sched, semiring, row_update)
        return x

    return body


@dataclasses.dataclass
class EngineResult:
    x: np.ndarray  # (n,)+feat converged vertex values
    rounds: int
    converged: bool
    flushes: int  # total commit steps executed
    flush_bytes: int  # total bytes published to the frontier
    residuals: list  # per-round residuals (host loop), or the final one (fused loop)
    round_times_s: list  # host-measured wall time per round (host loop; fused: [])
    delta: int
    P: int
    compile_time_s: float = 0.0  # build cost paid by this run (0 = warm)
    total_time_s: float = 0.0  # execution wall time

    @classmethod
    def from_run(
        cls,
        sched: DeviceSchedule,
        semiring: Semiring,
        x_ext,
        *,
        rounds: int,
        converged: bool,
        residuals: list,
        round_times_s: list,
        compile_time_s: float = 0.0,
        total_time_s: float | None = None,
    ) -> "EngineResult":
        """Single authority for the counters, as in the reference.

        ``flushes`` counts commit steps executed, ``rounds·S``, including the
        round that detected convergence; every flush publishes ``P·δ`` rows
        of ``F`` values each (``F = 1`` for a vector frontier).
        """
        bytes_per = np.dtype(semiring.dtype).itemsize * int(np.prod(tuple(x_ext.shape[1:])))
        flushes = rounds * sched.S
        if total_time_s is None:
            total_time_s = float(np.sum(round_times_s)) if round_times_s else 0.0
        return cls(
            x=x_ext[:-1].cpu().numpy(),
            rounds=rounds,
            converged=converged,
            flushes=flushes,
            flush_bytes=flushes * sched.P * sched.delta * bytes_per,
            residuals=residuals,
            round_times_s=round_times_s,
            delta=sched.delta,
            P=sched.P,
            compile_time_s=compile_time_s,
            total_time_s=total_time_s,
        )


def host_loop(
    rnd: Callable,
    sched: DeviceSchedule,
    semiring: Semiring,
    x_ext,
    residual_fn: Callable,
    tol: float,
    max_rounds: int,
    compile_time_s: float = 0.0,
    finish: Callable | None = None,
) -> EngineResult:
    """The host-driven convergence loop over a round ``x_ext -> x_ext``.

    Each entry of ``round_times_s`` is the round's wall time up to a device
    synchronise; the residual is read back after it.  With ``finish`` the
    loop's state is any tensor a round maps to the next (a rank's shards,
    :meth:`repro_torch.solve.Solver.solve` with a group):
    ``residual_fn(old, new)`` then reads whole states, and ``finish(state)``
    gives the ``(n + 1,)+feat`` frontier of the result.
    """
    residuals, times = [], []
    converged = False
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        # chaos hook at the natural recovery boundary: between committed
        # rounds, with `round` = rounds already executed (0-based)
        fire("solver.round", round=rounds - 1)
        t0 = time.perf_counter()
        x_new = rnd(x_ext)
        if x_new.is_cuda:
            torch.cuda.synchronize(x_new.device)
        times.append(time.perf_counter() - t0)
        res = float(residual_fn(x_ext, x_new) if finish else residual_fn(x_ext[:-1], x_new[:-1]))
        residuals.append(res)
        x_ext = x_new
        if res <= tol:
            converged = True
            break
    return EngineResult.from_run(
        sched,
        semiring,
        finish(x_ext) if finish else x_ext,
        rounds=rounds,
        converged=converged,
        residuals=residuals,
        round_times_s=times,
        compile_time_s=compile_time_s,
    )


def fused_loop(
    solve: Callable,
    sched: DeviceSchedule,
    semiring: Semiring,
    x_ext,
    tol: float,
    max_rounds: int,
    compile_time_s: float = 0.0,
) -> EngineResult:
    """Run a fused convergence loop and normalise its result: the
    counterpart of the reference's ``execute_solve_fn``.

    ``solve(x_ext, tol, max_rounds) -> (x, residual, rounds, converged)``
    runs every round itself (:func:`repro_torch.kernels.ops.fused_solve`).
    The result holds the final residual alone and no per-round times, as the
    reference's fused loop returns; ``total_time_s`` runs up to one device
    synchronise at the end.
    """
    t0 = time.perf_counter()
    x_out, res, rounds, converged = solve(x_ext, tol, max_rounds)
    if x_out.is_cuda:
        torch.cuda.synchronize(x_out.device)
    total_time_s = time.perf_counter() - t0
    return EngineResult.from_run(
        sched,
        semiring,
        x_out,
        rounds=int(rounds),
        converged=bool(converged),
        residuals=[float(res)],
        round_times_s=[],
        compile_time_s=compile_time_s,
        total_time_s=total_time_s,
    )
