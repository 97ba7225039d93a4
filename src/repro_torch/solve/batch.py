"""Batched multi-query solving: Q queries, one schedule, one K1 launch a round.

The counterpart of ``repro.solve.batch``.  ``solve_batch`` answers a closed
set of Q queries (multi-source SSSP, personalized PageRank for Q seeds, rwr
embeddings for Q seed sets) over one cached schedule; :class:`BatchStepper`
keeps an open batch of ``capacity`` slots that admits queries between
quanta and retires each at its first convergence.

The reference vmaps its round over a leading Q axis and runs one
``lax.while_loop`` a compaction chunk (closed batch) or a quantum (open
batch).  The port keeps the batch on the device vertex-major,
``(n + 1, Q)+feat``: a vertex's Q·F values are one row, so each chunk or
quantum is one launch of K1's loop entry
(:func:`repro_torch.kernels.ops.fused_batch_solve`), every round of it
walking the edges once for all Q queries, with one read-back at its end;
and the query tables sit side by side in one
``(n + 1, Q)+feat`` table (:meth:`Solver.batch_row_update`).  The batch is
transposed only at entry and exit and at a compaction, on the device (a
host transpose of a full-size batch costs more than its rounds).  Each query's
columns get exactly the round that query alone would, so every query's
bits are its own solve's.

As in the reference, a closed batch runs until every query has converged
(or ``max_rounds``): queries that converge early keep iterating, so their
``x`` is their own solve run for ``rounds`` rounds, and ``residuals`` holds
each query's residual of the last round.  ``rounds_per_query`` records each
query's first convergence.  ``compact_every=k`` drops the converged
queries every k rounds.  An open batch freezes each row at its first
convergence instead, so a retired row equals a fresh one-query
``solve_batch`` of it bit for bit.  Each query's residual is compared as
float32 against ``float32(tol)``, as the reference's loop does.

Batches run on the replicated frontier: the halo round kernel K2 takes no
query axis (the reference's ``pallas`` batch refuses halo too), and the
reference's XLA halo batch (``backend="sharded"``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels import ops, ref

__all__ = ["BatchResult", "BatchStepper", "RetiredQuery", "solve_batch"]


@dataclasses.dataclass
class BatchResult:
    """Result of one batched solve (Q queries sharing one schedule)."""

    x: np.ndarray  # (Q, n) or (Q, n, F) per-query states
    rounds: int  # rounds executed by the shared loop (= max over queries)
    rounds_per_query: np.ndarray  # (Q,) round of first convergence (0 = never)
    converged: np.ndarray  # (Q,) bool
    residuals: np.ndarray  # (Q,) float32, each query's residual of its last round
    flushes: int  # commit steps executed (shared by the batch)
    flush_bytes: int  # bytes published across the whole batch
    delta: int
    P: int
    Q: int
    compile_time_s: float = 0.0  # the kernels' build paid by this call (0 = warm)
    total_time_s: float = 0.0
    compactions: int = 0  # straggler-compaction shrinks performed


@dataclasses.dataclass
class RetiredQuery:
    """One slot retired from a :class:`BatchStepper` quantum."""

    tag: object  # caller's identifier, passed through admit()
    x: np.ndarray  # (n,) or (n, F) final state (frozen at first convergence)
    rounds: int  # rounds to first convergence (total, across quanta)
    converged: bool  # False = retired on the max_rounds budget
    residual: float


def _resolve(solver, backend, frontier) -> tuple:
    """The batch's backend and frontier; only the replicated frontier batches."""
    backend = backend or solver.default_backend
    solver._check_backend(backend)
    frontier = solver.resolve_frontier(frontier)
    if frontier == "halo":
        if backend == "kernel":
            raise ValueError(
                "batched solves run on the replicated frontier: the halo round "
                "kernel K2 takes no query axis"
            )
        raise NotImplementedError(
            "the batched halo solve (the reference's backend='sharded', "
            "frontier='halo') is not ported yet: ROADMAP queue A"
        )
    return backend, frontier


def _solve(sched, semiring, backend: str, epilogue, residual, X, tol, max_rounds, conv0=None):
    """One loop over the batch ``X`` until every query's residual is ≤ tol
    or ``max_rounds`` (``conv0``: an open batch's flags; see
    :func:`repro_torch.kernels.ref.fused_batch_solve_ref`): K1's loop entry,
    or the plain loop.  Returns ``(X, residuals, rounds, converged,
    rounds_per_query)``."""
    loop = ops.fused_batch_solve if backend == "kernel" else ref.fused_batch_solve_ref
    return loop(X, sched, semiring, epilogue, residual, tol, max_rounds, conv0)


def _to_device(x0_batch, semiring, device) -> torch.Tensor:
    """``(Q, n)+feat`` host states → the ``(n + 1, Q)+feat`` batch frontier
    (copied as they are, transposed on the device), the dump row the
    ⊕-identity."""
    X = torch.as_tensor(np.ascontiguousarray(x0_batch)).to(device).movedim(0, 1)
    pad = torch.full((1,) + tuple(X.shape[1:]), semiring.zero.item(), dtype=X.dtype, device=device)
    return torch.cat([X, pad]).contiguous()


def _to_host(X) -> np.ndarray:
    """The ``(n + 1, Q)+feat`` batch frontier → ``(Q, n)+feat`` host states
    (transposed on the device, then copied)."""
    return X[:-1].movedim(1, 0).contiguous().cpu().numpy()


def _columns(epilogue, keep):
    """``epilogue`` for the queries ``keep`` of its batch."""
    if epilogue.table is None:
        return epilogue
    return dataclasses.replace(epilogue, table=epilogue.table[:, keep].contiguous())


def _build_s(solver, backend: str) -> float:
    """Seconds spent loading (building, on first use) K1's library."""
    if backend != "kernel" or solver.device.type != "cuda":
        return 0.0
    from repro_torch.kernels.build import load

    t0 = time.perf_counter()
    load("round_block")
    return time.perf_counter() - t0


class BatchStepper:
    """A fixed-capacity *open* batch: admit mid-flight, retire converged.

    The continuous-batching primitive.  A stepper owns ``capacity`` slots of
    one batch frontier ``(n + 1, capacity)+feat`` on the solver's device and
    interleaves:

    * :meth:`admit` writes a query's initial state (and query) into a free
      slot;
    * :meth:`run` executes one quantum, at most ``quantum`` rounds over
      **all** slots (free slots ride along pre-converged, so the batch's
      width never changes) in one launch of K1's loop entry;
    * converged slots (and slots out of round budget) retire from
      :meth:`run` as :class:`RetiredQuery` rows, freeing their slots.

    Rows freeze at first convergence, so a retired result is bit-identical
    to a fresh ``solve_batch`` of that query alone, whenever it slotted in
    and whoever shared the batch.
    """

    def __init__(
        self,
        solver,
        capacity: int,
        *,
        delta=None,
        backend: str | None = None,
        frontier: str | None = None,
        tol=None,
        max_rounds=None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.backend, self.frontier = _resolve(solver, backend, frontier)
        self.solver = solver
        self.sched = solver.schedule(delta)
        self.capacity = capacity
        self.tol = solver.tol if tol is None else tol
        self.max_rounds = solver.max_rounds if max_rounds is None else max_rounds
        self._sr = solver.problem.semiring
        F = solver.problem.feature_dim
        # matrix problems give every slot an (n, F) state, others an (n,) one
        self._feat = (F,) if F > 1 else ()
        n = solver.graph.n
        self._X = torch.full(
            (n + 1, capacity) + self._feat,
            self._sr.zero.item(),
            dtype=self._sr.torch_dtype,
            device=solver.device,
        )
        self._qb = None  # (capacity,)+q.shape host queries, from the first admit
        self._epilogue = None  # rebuilt when an admission changes the queries
        self._occupied = np.zeros(capacity, bool)
        self._tags: list = [None] * capacity
        self._rounds_in = np.zeros(capacity, np.int64)
        self.flushes = 0
        self.flush_bytes = 0
        self.rounds_executed = 0  # cumulative, across all quanta
        self.quanta = 0

    # -------------------------------------------------------------- slots #
    @property
    def occupancy(self) -> int:
        return int(self._occupied.sum())

    @property
    def free_slots(self) -> int:
        return self.capacity - self.occupancy

    def admit(self, x0, q=None, tag=None) -> int:
        """Write one query into a free slot; returns the slot index."""
        free = np.nonzero(~self._occupied)[0]
        if free.size == 0:
            raise ValueError("no free slots (retire via run() first)")
        slot = int(free[0])
        x0 = np.asarray(x0, dtype=self._sr.dtype)
        n = self.solver.graph.n
        want = (n,) + self._feat
        if x0.shape != want:
            raise ValueError(f"x0 must have shape {want}, got {x0.shape}")
        problem = self.solver.problem
        if problem.takes_query:
            if q is None:
                raise ValueError(f"problem {problem.name!r} needs a per-row q=")
            q = np.asarray(q)
            if self._qb is None:
                self._qb = np.zeros((self.capacity,) + q.shape, q.dtype)
            self._qb[slot] = q
            self._epilogue = None
        elif q is not None:
            raise ValueError(f"problem {problem.name!r} takes no query")
        self._X[:n, slot] = torch.as_tensor(x0).to(self._X.device)
        self._X[n, slot] = self._sr.zero.item()
        self._occupied[slot] = True
        self._tags[slot] = tag
        self._rounds_in[slot] = 0
        return slot

    def evict_all(self) -> list:
        """Clear every occupied slot and return their tags.  The stepper is
        left empty but reusable."""
        tags = [self._tags[slot] for slot in np.nonzero(self._occupied)[0]]
        self._occupied[:] = False
        self._tags = [None] * self.capacity
        return tags

    # ---------------------------------------------------------------- run #
    def run(self, quantum: int) -> list[RetiredQuery]:
        """One scheduling quantum: at most ``quantum`` rounds, then retire.

        Returns the slots that finished this quantum (first convergence, or
        the ``max_rounds`` budget exhausted, at quantum granularity).  No-op
        on an empty batch.
        """
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        occ = self._occupied.copy()
        if not occ.any():
            return []
        t0 = time.perf_counter()
        if self._epilogue is None:
            self._epilogue = self.solver.batch_row_update(self._qb, self.capacity, self._feat)
        _build_s(self.solver, self.backend)
        residual = self.solver.problem.residual
        self._X, res, r, conv, rpq = _solve(
            self.sched, self._sr, self.backend, self._epilogue, residual, self._X, self.tol, quantum, conv0=~occ
        )
        before = self._rounds_in.copy()
        self._rounds_in[occ] += r
        self.rounds_executed += r
        self.quanta += 1
        self.flushes += r * self.sched.S
        F = int(np.prod(self._feat, dtype=np.int64)) if self._feat else 1
        bytes_per = np.dtype(self._sr.dtype).itemsize * F
        per_round = self.sched.S * self.sched.P * self.sched.delta * bytes_per
        self.flush_bytes += r * per_round * self.capacity
        n = self.solver.graph.n
        retired: list[RetiredQuery] = []
        for slot in np.nonzero(occ)[0]:
            done = bool(conv[slot])
            if not done and self._rounds_in[slot] < self.max_rounds:
                continue
            rounds = int(before[slot] + rpq[slot]) if done else int(self._rounds_in[slot])
            retired.append(
                RetiredQuery(
                    tag=self._tags[slot],
                    x=self._X[:n, slot].cpu().numpy().copy(),
                    rounds=rounds,
                    converged=done,
                    residual=float(res[slot]),
                )
            )
            self._occupied[slot] = False
            self._tags[slot] = None
        self.solver.stats["solves"] += len(retired)
        finished = [q.rounds for q in retired if q.converged]
        if finished:
            # one (δ, rounds) datapoint a quantum with retirees, the slowest
            # finisher's — the conservative convention of solve_batch
            self.solver._record_observation(
                self.sched.delta, max(finished), time.perf_counter() - t0, self.backend, kind="batch"
            )
        return retired


def solve_batch(
    solver,
    x0_batch,
    *,
    q=None,
    delta=None,
    backend: str | None = None,
    frontier: str | None = None,
    tol=None,
    max_rounds=None,
    compact_every: int | None = None,
) -> BatchResult:
    """Solve Q queries of ``solver.problem`` together, one round for all.

    * ``x0_batch``      — (Q, n) initial states (e.g. :func:`multi_source_x0`),
      or (Q, n, F) for matrix-frontier problems (e.g. batched rwr).
    * ``q``             — for query problems, the Q queries with a leading Q
      axis (e.g. :func:`ppr_teleport`); must be ``None`` otherwise.
    * ``backend``       — ``"kernel"`` (one launch of K1's loop entry a
      compaction chunk on a CUDA device, its plain loop on the CPU) or
      ``"torch"`` (the plain loop); the replicated frontier only.
    * ``compact_every`` — shrink the active batch to the unconverged subset
      every this many rounds (straggler-aware batching); ``None`` runs until
      the slowest query converges.

    With ``Q == 1`` it gives the single-query ``solve()``'s ``x`` and rounds.
    """
    problem = solver.problem
    sr = problem.semiring
    backend, _ = _resolve(solver, backend, frontier)
    sched = solver.schedule(delta)
    tol = solver.tol if tol is None else tol
    max_rounds = solver.max_rounds if max_rounds is None else max_rounds
    if compact_every is not None and compact_every < 1:
        raise ValueError(f"compact_every must be >= 1, got {compact_every}")
    x0 = np.asarray(x0_batch, dtype=sr.dtype)
    n = solver.graph.n
    if x0.ndim not in (2, 3) or x0.shape[1] != n:
        raise ValueError(f"x0_batch must be (Q, {n}) or (Q, {n}, F), got {x0.shape}")
    Q, feat = x0.shape[0], tuple(x0.shape[2:])
    epilogue = solver.batch_row_update(q, Q, feat)
    X = _to_device(x0, sr, solver.device)
    compile_time_s = _build_s(solver, backend)
    bytes_per = np.dtype(sr.dtype).itemsize * (int(np.prod(feat)) if feat else 1)

    solver.stats["solves"] += 1
    x_out = np.empty((Q, n) + feat, dtype=sr.dtype)
    rpq_all = np.zeros(Q, np.int32)
    conv_all = np.zeros(Q, bool)
    res_all = np.full(Q, np.inf, np.float32)
    active = np.arange(Q)
    rounds_done = flushes = flush_bytes = compactions = 0
    t0 = time.perf_counter()
    while active.size:
        chunk = max_rounds - rounds_done
        if compact_every is not None:
            chunk = min(chunk, compact_every)
        X, res, r, conv, rpq = _solve(sched, sr, backend, epilogue, problem.residual, X, tol, chunk)
        rounds_done += r
        flushes += r * sched.S
        flush_bytes += r * sched.S * sched.P * sched.delta * bytes_per * active.size
        rpq_all[active] = np.where(rpq > 0, rounds_done - r + rpq, 0)
        conv_all[active] = conv
        res_all[active] = res
        if conv.all() or rounds_done >= max_rounds:
            x_out[active] = _to_host(X)
            break
        # Straggler compaction: converged queries leave with their states;
        # the loop goes on over the unconverged ones.
        if conv.any():
            x_out[active[conv]] = _to_host(X[:, torch.as_tensor(np.nonzero(conv)[0], device=X.device)])
            keep = torch.as_tensor(np.nonzero(~conv)[0], device=X.device)
            active = active[~conv]
            X = X[:, keep].contiguous()
            epilogue = _columns(epilogue, keep)
            compactions += 1
    total = time.perf_counter() - t0
    # a batch's rounds are its slowest query's (tagged "batch" for the
    # refit), routed through the solver so that served traffic advances
    # reprobe_every's count: in a serving process, batches are the
    # production observations
    solver._record_observation(sched.delta, rounds_done, total, backend, kind="batch")
    return BatchResult(
        x=x_out,
        rounds=rounds_done,
        rounds_per_query=rpq_all,
        converged=conv_all,
        residuals=res_all,
        flushes=flushes,
        flush_bytes=flush_bytes,
        delta=sched.delta,
        P=sched.P,
        Q=Q,
        compile_time_s=compile_time_s,
        total_time_s=total,
        compactions=compactions,
    )
