"""Elastic checkpoints of in-flight solves.

The counterpart of ``repro.ft.elastic`` (its solve half; the delayed-commit
training state waits for the port's LM half).  Two restore guarantees:

* **bit-identical** — deterministic rounds replay the exact trajectory from
  the snapshot: resuming at round *k* gives the same ``x`` a round as the
  uninterrupted run, also on a solver with another shard count ``D`` (the
  halo round on the f32 wire is D-invariant for a fixed worker count ``P``);
* **fixed-point-identical** — state the snapshot cannot carry across a
  layout change (the quantized halo wire's per-shard error feedback at
  another ``D``) resets to zeros; the iteration still converges to the same
  fixed point, within tol.

Snapshots ride :mod:`repro_torch.ckpt.checkpoint`'s manifest machinery, so
they are atomic (``_COMMITTED`` rename), written on a background thread, and
elastic (:func:`load_latest_flat` needs no like-tree: shapes come from the
manifest).  The layout on disk is the reference's, so a snapshot that either
package writes, the other resumes.
"""

from __future__ import annotations

import dataclasses
import re
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager, latest_step, load_flat
from repro_torch.core.engine import EngineResult, round_fn
from repro_torch.ft.inject import fire
from repro_torch.kernels import build, ops
from repro_torch.kernels.round_block import Epilogue

__all__ = [
    "CheckpointedSolve",
    "SolveCheckpointer",
    "checkpointed_solve",
    "load_latest_flat",
]

_KEYSTR = re.compile(r"^\['([^']*)'\]$")


def load_latest_flat(directory):
    """``(step, {name: ndarray})`` of the newest committed checkpoint.

    Manifest-driven: no like-tree needed — leaf names, shapes, and dtypes
    come from ``manifest.json``, shards are concatenated elastically.
    Returns ``None`` when the directory holds no committed step.
    """
    step = latest_step(directory)
    if step is None:
        return None
    return step, load_flat(directory, step)


class SolveCheckpointer:
    """Round-indexed snapshots of an in-flight solve (flat dict trees)."""

    def __init__(self, directory, every: int = 8, keep: int = 3):
        self.every = int(every)
        self.mgr = CheckpointManager(directory, keep=keep)

    def save(self, rounds: int, tree: dict, block: bool = False):
        self.mgr.save(rounds, tree, block=block)

    def wait(self):
        self.mgr.wait()

    def restore_latest(self):
        """``(rounds, {key: ndarray})`` of the newest snapshot, or ``None``.

        Any torn/corrupt snapshot reads as absent (cold start), never as an
        exception — the restore path must survive the fault that created it.
        """
        try:
            got = load_latest_flat(self.mgr.directory)
        except Exception:
            return None
        if got is None:
            return None
        step, flat = got
        out = {}
        for name, arr in flat.items():
            m = _KEYSTR.match(name)
            out[m.group(1) if m else name] = arr
        return step, out


@dataclasses.dataclass
class CheckpointedSolve:
    """A fault-tolerant solve's result plus its recovery accounting."""

    result: EngineResult
    rounds_executed: int  # physical rounds run in this call (replays included)
    restores: int  # restore-from-snapshot events in this call
    resumed_at: int | None  # round of the snapshot this call started from


def _snapshot_tree(x_ext, residuals, rnd) -> dict:
    """The snapshot of a solve after a round: the frontier (a tensor; the
    checkpoint copies it to the host before the writer starts), the whole
    residual history, and the halo round's error feedback where it has one."""
    tree = {
        "x_ext": x_ext,
        # the whole residual trajectory rides along, so a resumed solve
        # reports the same per-round history as the uninterrupted one
        "residuals": np.asarray(residuals, np.float32),
    }
    ef_state = getattr(rnd, "ef_state", None)
    if ef_state is not None:
        tree["ef_0"] = ef_state["ef"]
    return tree


def _restore_ef(rnd, tree: dict):
    """Put snapshotted error-feedback residuals back into the round closure.

    On any mismatch (no EF in the snapshot, or shapes changed because the
    shard count did) the residuals reset to zeros: EF only accelerates
    convergence, so zeros preserve the fixed point — the fixed-point-
    identical half of the restore contract.
    """
    state = getattr(rnd, "ef_state", None)
    if state is None:
        return
    init = rnd.ef_init
    arr = tree.get("ef_0")
    if arr is None or tuple(np.shape(arr)) != tuple(init.shape):
        state["ef"] = init
        return
    state["ef"] = torch.as_tensor(np.asarray(arr), dtype=init.dtype).to(init.device)


def _round(solver, sched, backend: str, frontier: str, halo_dtype: str, row_update, feat: tuple):
    """One round ``x_ext -> x_ext`` (a new tensor) of the host-driven loop.

    Replicated: K1's single-round entry (:func:`repro_torch.kernels.ops.fused_round`,
    one launch on CUDA; the reference steps its compiled ``pallas`` round)
    for ``backend="kernel"``, the plain round for ``"torch"``.  Halo: the
    solver's halo round (one K2 launch on CUDA), its error feedback carried
    in the closure."""
    sr = solver.problem.semiring
    if frontier == "halo":
        return solver._halo_round(sched, backend, halo_dtype, row_update, feat)
    if backend == "kernel":
        return lambda x: ops.fused_round(x, sched, sr, row_update)
    return round_fn(sched, sr, row_update)


def checkpointed_solve(
    solver,
    x0=None,
    *,
    q=None,
    delta=None,
    backend: str | None = None,
    frontier: str | None = None,
    halo_dtype: str | None = None,
    tol: float | None = None,
    max_rounds: int | None = None,
    ckpt_dir,
    every: int = 8,
    keep: int = 3,
    resume: bool = True,
    max_restores: int = 8,
) -> CheckpointedSolve:
    """Host-driven solve with periodic background snapshots and
    restore-on-fault.

    Every ``every`` rounds the engine state — the extended frontier
    ``x_ext``, the residual history, the round counter, and (halo) the
    per-shard error-feedback residuals — is snapshotted on a background
    thread.  A fault mid-solve restores the newest committed snapshot and
    replays from there (at most ``every - 1`` recomputed rounds a fault);
    with ``resume=True`` a fresh process, or a solver with another shard
    count, picks up the same way instead of starting cold.

    Each round is one launch of K1's single-round entry (replicated,
    ``backend="kernel"`` on CUDA) or of K2 (halo), or the plain round; the
    residual is ``problem.residual`` of the round's old and new frontier,
    read back each round, against ``tol``.  ``ValueError``, ``TypeError``
    and ``NotImplementedError`` propagate at once; any other exception is a
    fault, and the loop raises after ``max_restores`` of them.
    """
    if solver.group is not None:
        raise NotImplementedError(
            "checkpointed_solve across processes (Solver(group=...)): each rank would write "
            "its shard as host_index = rank; ROADMAP queue A (A9, third part)"
        )
    backend = backend or solver.default_backend
    solver._check_backend(backend)
    frontier = solver.resolve_frontier(frontier)
    halo_dtype = solver.resolve_halo_dtype(halo_dtype, backend, frontier)
    tol = solver.tol if tol is None else tol
    max_rounds = solver.max_rounds if max_rounds is None else max_rounds
    problem = solver.problem
    sr = problem.semiring
    sched = solver.schedule(delta)
    x_ext0 = solver._x_ext(x0)
    feat = tuple(x_ext0.shape[1:])
    row_update = solver.row_update(q)
    if isinstance(row_update, Epilogue):
        row_update = row_update.for_frontier(feat)
    build_s = build.load_seconds(backend, solver.device)
    rnd = _round(solver, sched, backend, frontier, halo_dtype, row_update, feat)
    ck = SolveCheckpointer(ckpt_dir, every=every, keep=keep)

    def load(tree):
        return torch.as_tensor(np.asarray(tree["x_ext"]), dtype=sr.torch_dtype).to(solver.device)

    x_ext = x_ext0
    rounds = 0
    resumed_at = None
    residuals: list[float] = []
    if resume:
        got = ck.restore_latest()
        if got is not None:
            step, tree = got
            if np.shape(tree["x_ext"]) == tuple(x_ext0.shape):
                x_ext = load(tree)
                rounds = resumed_at = step
                residuals = [float(v) for v in tree.get("residuals", ())]
                _restore_ef(rnd, tree)

    times: list[float] = []
    executed = 0
    restores = 0
    converged = False
    try:
        while rounds < max_rounds and not converged:
            try:
                fire("solver.round", round=rounds)
                t0 = time.perf_counter()
                x_new = rnd(x_ext)
                if x_new.is_cuda:
                    torch.cuda.synchronize(x_new.device)
                times.append(time.perf_counter() - t0)
                executed += 1
                res = float(problem.residual(x_ext[:-1], x_new[:-1]))
                residuals.append(res)
                x_ext = x_new
                rounds += 1
                if res <= tol:
                    converged = True
                elif rounds % every == 0:
                    ck.save(rounds, _snapshot_tree(x_ext, residuals, rnd), block=False)
            except (ValueError, TypeError, NotImplementedError):
                raise
            except Exception:
                restores += 1
                if restores > max_restores:
                    raise
                ck.wait()
                got = ck.restore_latest()
                if got is not None:
                    step, tree = got
                    x_ext = load(tree)
                    rounds = step
                    residuals = [float(v) for v in tree.get("residuals", ())]
                    _restore_ef(rnd, tree)
                else:  # nothing committed yet: cold restart
                    x_ext = x_ext0
                    rounds = 0
                    residuals = []
                    if getattr(rnd, "ef_state", None) is not None:
                        rnd.ef_state["ef"] = rnd.ef_init
        ck.save(rounds, _snapshot_tree(x_ext, residuals, rnd), block=True)
    finally:
        # no writer outlives the call, also when a fault ends it
        ck.wait()
    result = EngineResult.from_run(
        sched,
        sr,
        x_ext,
        rounds=rounds,
        converged=converged,
        residuals=residuals,
        round_times_s=times,
        compile_time_s=build_s,
    )
    solver._last_x = np.asarray(result.x)
    return CheckpointedSolve(
        result=result,
        rounds_executed=executed,
        restores=restores,
        resumed_at=resumed_at,
    )
