"""The :class:`Solver` — the port's entry point.

The counterpart of ``repro.solve.solver.Solver`` on one device.  A solver
binds ``(graph, problem, n_workers)``, caches one :class:`DeviceSchedule` per
resolved δ (and one halo plan per δ), and runs rounds until the residual
meets the tolerance: on the replicated frontier in one fused loop (the
reference's ``jit``/``pallas`` path: an f32 residual against an f32 ``tol``,
one read-back a solve, ``residuals=[final]`` and ``round_times_s=[]``), on
the halo frontier under the host loop (one residual and one time a round),
as the reference's ``_solve_once`` dispatches.

``delta`` takes the paper's disciplines by name (``"sync"``, ``"async"``), an
integer (delayed), or ``"auto"``, which probes the sync and async round
counts and asks the δ cost model (:mod:`repro_torch.core.delta_model`) for
δ*.  ``backend="kernel"`` (the default) runs a replicated solve as one
launch of K1's loop entry on a CUDA device (every round in it), and as its
plain loop on the CPU; ``backend="torch"`` runs the plain loop on either,
for comparison (the port's ``jit``: the same stopping test and result,
reading a residual back each round).

The frontier is a vector ``(n,)`` or a matrix ``(n, F)``: rwr embeddings
and label propagation (``Problem.feature_dim = F``) iterate F columns over
one schedule, and any problem takes an ``(n, F)`` ``x0``.  K1 and K2 take
the feature axis; ``flush_bytes`` counts F values a published row.

``frontier="halo"`` runs the owner-computes sharded frontier
(:mod:`repro_torch.dist.engine_sharded`) over ``n_shards`` shards, all on the
solver's device: each round is one launch of the halo-round kernel K2, all
shards' commit steps and the exchanges between them (``backend="kernel"``),
or the plain halo round (``backend="torch"``), and only boundary rows cross
between shards.  ``halo_dtype`` ∈ ``{"f32",
"int8", "fp8"}`` quantizes those rows with error feedback (``backend=
"kernel"`` only; f32 gives the replicated solve's answer bit for bit).
Both backends run both frontiers.

``solve_batch`` answers Q queries together on the replicated frontier, one
launch of K1's batch entry a round for all Q (:mod:`repro_torch.solve.batch`,
which also holds the open batch :class:`~repro_torch.solve.batch.BatchStepper`).

Evolving graphs: ``apply_updates(batch)`` applies an
:class:`~repro_torch.graphs.updates.EdgeBatch` to the bound graph with the
block bounds pinned, and patches every cached schedule on its device
(into copies of the same shapes): only the touched workers' stripes are
rebuilt, at the schedule's ``(S, M)``, and ``row_ptr`` is re-derived from
the patched ``dst_local`` (the kernels walk the edges through it).  ``resolve(updates=...)`` repairs
the previous fixed point into a warm state (:mod:`repro_torch.evolve`) and
solves from it over the patched schedule: on the replicated frontier one
launch of K1's loop entry, on the halo frontier K2 over a plan rebuilt from
the patched schedule.

The solver runs on CUDA unless it is given ``device="cpu"``; with no CUDA
device and no ``device`` it raises.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.delta_model import fit_delta_model
from repro_torch.core.engine import (
    MIN_CHUNK,
    DeviceSchedule,
    EngineResult,
    _cell_row_ptr,
    extend_frontier,
    fused_loop,
    host_loop,
    make_schedule,
)
from repro_torch.dist import engine_sharded
from repro_torch.evolve.restart import warm_start_state
from repro_torch.graphs.formats import CSRGraph, build_worker_stripe
from repro_torch.graphs.partition import balanced_blocks
from repro_torch.kernels import ops, ref
from repro_torch.kernels.round_block import Epilogue
from repro_torch.solve import batch
from repro_torch.solve.problem import Problem

__all__ = [
    "BACKENDS",
    "FRONTIERS",
    "HALO_DTYPES",
    "Solver",
    "resolve_device",
]

BACKENDS = ("kernel", "torch")
FRONTIERS = ("replicated", "halo")

#: Wire dtypes of the halo exchange (``backend="kernel"``, ``frontier="halo"``).
HALO_DTYPES = engine_sharded.HALO_DTYPES


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; raises if there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to run "
            "the plain PyTorch round on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


class Solver:
    """Reusable single-device solver for one ``(graph, problem)`` pair.

    ``solve()`` answers a query; ``delta=`` / ``backend=`` per call override
    the construction defaults.  Schedules are cached per δ on the instance,
    so a second ``solve()`` at the same δ builds nothing (see ``stats``).
    """

    def __init__(
        self,
        graph: CSRGraph,
        problem: Problem,
        n_workers: int = 8,
        delta="auto",
        backend: str = "kernel",
        frontier: str = "replicated",
        halo_dtype: str = "f32",
        n_shards: int = 1,
        min_chunk: int = MIN_CHUNK,
        tol: float | None = None,
        max_rounds: int | None = None,
        device=None,
    ):
        self._check_backend(backend)
        self._check_frontier(frontier)
        self._check_halo_dtype(halo_dtype)
        self._check_delta(delta)
        if n_shards < 1 or n_workers % n_shards:
            raise ValueError(f"P={n_workers} not divisible by D={n_shards}")
        self.device = resolve_device(device)
        self.graph = graph
        self.problem = problem
        self.n_workers = n_workers
        self.default_delta = delta
        self.default_backend = backend
        self.default_frontier = frontier
        self.default_halo_dtype = halo_dtype
        self.n_shards = n_shards
        self.min_chunk = min_chunk
        self.tol = problem.tol if tol is None else tol
        self.max_rounds = problem.max_rounds if max_rounds is None else max_rounds
        self.delta_model = None  # set by the first δ="auto" probe
        self.delta_model_incremental = None  # per-regime fit (evolving graphs)
        self._sched_graph = (
            graph.with_values(problem.edge_values(graph))
            if problem.edge_values is not None
            else graph
        )
        self._row_update = (
            None
            if problem.takes_query
            else problem.make_row_update(graph, None, self.device)
        )
        self._bounds = None
        self._auto_delta = None
        self._auto_delta_incremental = None
        self._schedules: dict[int, DeviceSchedule] = {}
        self._plans: dict[tuple, engine_sharded.FrontierPlan] = {}
        self._last_x = None  # fixed point of the most recent solve (host copy)
        self._last_report = None  # UpdateReport of the most recent apply_updates
        self.stats = {"solves": 0, "schedule_builds": 0, "plan_builds": 0}

    # ------------------------------------------------------------------ #
    # δ resolution + schedule cache
    # ------------------------------------------------------------------ #
    @property
    def bounds(self) -> np.ndarray:
        """The (P + 1,) contiguous in-degree-balanced block bounds."""
        if self._bounds is None:
            self._bounds = balanced_blocks(self._sched_graph, self.n_workers)
        return self._bounds

    @property
    def block_size(self) -> int:
        """Max worker block size B — the sync δ and the upper clamp."""
        return int(np.diff(self.bounds).max())

    @staticmethod
    def _check_delta(delta):
        if isinstance(delta, str) and delta not in ("sync", "async", "auto"):
            raise ValueError(
                f"delta must be 'sync', 'async', 'auto', or an int, got {delta!r}"
            )

    @staticmethod
    def _check_backend(backend):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")

    @staticmethod
    def _check_frontier(frontier):
        if frontier not in FRONTIERS:
            raise ValueError(f"frontier must be one of {FRONTIERS}, got {frontier!r}")

    @staticmethod
    def _check_halo_dtype(halo_dtype):
        if halo_dtype not in HALO_DTYPES:
            raise ValueError(
                f"halo_dtype must be one of {HALO_DTYPES}, got {halo_dtype!r}"
            )

    def resolve_frontier(self, frontier=None) -> str:
        """Normalize the frontier knob (``None`` → the construction default)."""
        if frontier is None:
            frontier = self.default_frontier
        self._check_frontier(frontier)
        return frontier

    def resolve_halo_dtype(
        self, halo_dtype=None, backend: str | None = None, frontier: str | None = None
    ) -> str:
        """Normalize the halo wire dtype; quantization is kernel + halo only.

        An explicit low-precision ``halo_dtype`` on any other (backend,
        frontier) pair is an error; a low-precision construction default
        resolves to ``"f32"`` there, so exact paths stay exact.
        """
        explicit = halo_dtype is not None
        if halo_dtype is None:
            halo_dtype = self.default_halo_dtype
        self._check_halo_dtype(halo_dtype)
        if halo_dtype != "f32" and not (backend == "kernel" and frontier == "halo"):
            if explicit:
                raise ValueError(
                    f"halo_dtype={halo_dtype!r} requires backend='kernel', "
                    f"frontier='halo'; got backend={backend!r}, "
                    f"frontier={frontier!r}"
                )
            return "f32"
        return halo_dtype

    def resolve_delta(self, delta=None) -> int:
        """Normalize ``delta ∈ {None, 'sync', 'async', 'auto', int}`` to rows."""
        if delta is None:
            delta = self.default_delta
        self._check_delta(delta)
        B = self.block_size
        if delta == "sync":
            return B
        if delta == "async":
            return min(self.min_chunk, B)
        if delta == "auto":
            if self._auto_delta is None:
                self._auto_delta = self._probe_auto_delta()
            return self._auto_delta
        return int(min(max(int(delta), 1), B))

    def _probe_auto_delta(self) -> int:
        """Fit the δ cost model from two measured probes (sync + finest δ)."""
        r_sync = self.solve(delta="sync", frontier="replicated")
        r_async = self.solve(delta="async", frontier="replicated")
        self.delta_model = fit_delta_model(
            self._sched_graph,
            self.n_workers,
            r_sync.rounds,
            r_async.rounds,
            delta_min=min(self.min_chunk, self.block_size),
            bytes_per_elem=np.dtype(self.problem.semiring.dtype).itemsize,
        )
        return min(self.delta_model.best_delta(), self.block_size)

    def schedule(self, delta=None) -> DeviceSchedule:
        """The cached device schedule for ``delta`` (built on first use)."""
        delta_eff = self.resolve_delta(delta)
        sched = self._schedules.get(delta_eff)
        if sched is None:
            sched = make_schedule(
                self._sched_graph,
                self.n_workers,
                delta_eff,
                self.problem.semiring,
                mode="delayed",
                min_chunk=self.min_chunk,
                bounds=self.bounds,
                device=self.device,
            )
            self._schedules[delta_eff] = sched
            self.stats["schedule_builds"] += 1
        return sched

    def frontier_plan(self, sched: DeviceSchedule) -> engine_sharded.FrontierPlan:
        """The cached owner-computes halo plan for ``sched`` over
        ``n_shards`` (built on first use; ``stats["plan_builds"]``)."""
        key = (sched.delta, self.n_shards)
        plan = self._plans.get(key)
        if plan is None:
            plan = engine_sharded.make_frontier_plan(sched, self.n_shards)
            self._plans[key] = plan
            self.stats["plan_builds"] += 1
        return plan

    # ------------------------------------------------------------------ #
    # inputs
    # ------------------------------------------------------------------ #
    def _x_ext(self, x0) -> torch.Tensor:
        """Append the dump slot to ``x0``: a vector ``(n,)`` or a matrix
        ``(n, F)`` (``(n, 1)`` is accepted for any problem, and runs the
        vector round's arithmetic)."""
        if x0 is None:
            x0 = self.problem.x0(self.graph)
        x0 = np.asarray(x0)
        n = self.graph.n
        if not (x0.shape == (n,) or (x0.ndim == 2 and x0.shape[0] == n)):
            raise ValueError(f"x0 must have shape ({n},) or ({n}, F), got {x0.shape}")
        return extend_frontier(x0, self.problem.semiring, self.device)

    def row_update(self, q=None):
        """The problem's row update on this solver's device, for query ``q``."""
        if not self.problem.takes_query:
            if q is not None:
                raise ValueError(f"problem {self.problem.name!r} takes no query")
            return self._row_update
        if q is None:
            if self.problem.default_query is None:
                raise ValueError(f"problem {self.problem.name!r} needs q=")
            q = self.problem.default_query(self.graph)
        q = np.asarray(q)
        n, F = self.graph.n, self.problem.feature_dim
        if q.shape not in ((n,), (n, F)):
            raise ValueError(f"q must have shape ({n},) or ({n}, {F}), got {q.shape}")
        return self.problem.make_row_update(self.graph, q, self.device)

    def batch_row_update(self, q, Q: int, feat: tuple) -> Epilogue:
        """The row update of a batch of Q queries whose frontier rows are
        ``(Q,)+feat`` a vertex.  A query problem's Q queries are copied to
        the device once a batch and laid side by side there, vertex-major,
        ``(n + 1, Q)+feat``; any other problem's one table is every query's."""
        problem = self.problem
        if not problem.takes_query:
            if q is not None:
                raise ValueError(f"problem {problem.name!r} takes no query")
            return self._row_update.for_batch(Q, feat, per_query=False)
        if q is None:
            raise ValueError(f"problem {problem.name!r} needs a batched q=")
        q = np.asarray(q)
        lead = q.shape[0] if q.ndim else None
        if lead != Q:
            raise ValueError(f"q leading axis {lead} != Q {Q}")
        n, F = self.graph.n, problem.feature_dim
        if q.shape[1:] not in ((n,), (n, F)):
            raise ValueError(f"q must have shape (Q, {n}) or (Q, {n}, {F}), got {q.shape}")
        side_by_side = torch.as_tensor(np.ascontiguousarray(q)).to(self.device).movedim(0, 1)
        ep = problem.make_row_update(self.graph, side_by_side, self.device)
        return ep.for_batch(Q, feat, per_query=True)

    # ------------------------------------------------------------------ #
    # solve
    # ------------------------------------------------------------------ #
    def _halo_round(self, sched, backend, halo_dtype, row_update, feat):
        """One halo round ``x_ext -> x_ext`` for the host loop."""
        sr = self.problem.semiring
        plan = self.frontier_plan(sched)
        if backend == "torch":
            return engine_sharded.frontier_round_ext_fn(sched, plan, sr, row_update)
        fn = engine_sharded.frontier_kernel_round_ext_fn(sched, plan, sr, row_update, halo_dtype)
        # The error-feedback residuals are loop state of one solve: fresh
        # zeros per solve, carried from round to round.
        state = {"ef": engine_sharded.frontier_ef_init(plan, feat)}

        def rnd(x):
            x, state["ef"] = fn(x, state["ef"])
            return x

        return rnd

    def solve(
        self,
        x0=None,
        *,
        q=None,
        delta=None,
        backend: str | None = None,
        frontier: str | None = None,
        halo_dtype: str | None = None,
        tol: float | None = None,
        max_rounds: int | None = None,
    ) -> EngineResult:
        """Run to convergence; returns the engine's instrumented result."""
        backend = backend or self.default_backend
        self._check_backend(backend)
        frontier = self.resolve_frontier(frontier)
        halo_dtype = self.resolve_halo_dtype(halo_dtype, backend, frontier)
        tol = self.tol if tol is None else tol
        max_rounds = self.max_rounds if max_rounds is None else max_rounds
        sched = self.schedule(delta)
        x_ext = self._x_ext(x0)
        feat = tuple(x_ext.shape[1:])
        row_update = self.row_update(q)
        if isinstance(row_update, Epilogue):  # fit its table to x's rows
            row_update = row_update.for_frontier(feat)
        sr, residual = self.problem.semiring, self.problem.residual
        build_s = 0.0
        if backend == "kernel" and self.device.type == "cuda":
            from repro_torch.kernels.build import load

            t0 = time.perf_counter()
            load("round_block")  # built once per process; timed apart from rounds
            build_s = time.perf_counter() - t0
        self.stats["solves"] += 1
        if frontier == "halo":
            rnd = self._halo_round(sched, backend, halo_dtype, row_update, feat)
            result = host_loop(rnd, sched, sr, x_ext, residual, tol, max_rounds, compile_time_s=build_s)
        else:
            loop = ops.fused_solve if backend == "kernel" else ref.fused_solve_ref

            def solve(x, tol, max_rounds):
                return loop(x, sched, sr, row_update, residual, tol, max_rounds)

            result = fused_loop(solve, sched, sr, x_ext, tol, max_rounds, compile_time_s=build_s)
        self._last_x = np.asarray(result.x)
        return result

    # ------------------------------------------------------------------ #
    # evolving graphs: apply_updates + incremental resolve
    # ------------------------------------------------------------------ #
    def apply_updates(self, batch):
        """Mutate the bound graph; returns the ``UpdateReport``.

        Rebinds the problem's row update and edge values to the new graph and
        invalidates only what the batch touched: every cached schedule keeps
        each stripe whose worker block the affected rows miss, and is patched
        (same shapes) where they hit; halo plans drop, since their index
        tensors were built from the old schedule.

        The block bounds are **pinned** across updates: recomputing a
        degree-sensitive partition on the mutated graph would shift every
        block boundary and invalidate all stripes for a one-row change.
        """
        bounds = self.bounds  # pin pre-mutation bounds before swapping graphs
        new_graph, report = self.graph.apply_updates(batch)
        self.graph = new_graph
        problem = self.problem
        self._sched_graph = (
            new_graph.with_values(problem.edge_values(new_graph))
            if problem.edge_values is not None
            else new_graph
        )
        self._row_update = (
            None
            if problem.takes_query
            else problem.make_row_update(new_graph, None, self.device)
        )
        self._bounds = bounds
        self._plans = {}
        self._patch_schedules(report)
        self._last_report = report
        return report

    def _touched_workers(self, affected_rows) -> np.ndarray:
        """Worker blocks containing any affected destination row."""
        affected = np.asarray(affected_rows, dtype=np.int64)
        if affected.size == 0:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.searchsorted(self.bounds, affected, side="right") - 1)

    def _patch_schedules(self, report):
        """Rebuild only the touched workers' stripes of every cached schedule.

        A stripe that outgrows the schedule's padded width ``M`` drops that
        δ's schedule for a lazy full rebuild (global re-padding would touch
        every worker anyway).  Otherwise the patched tensors are copies on the
        schedule's device with its shapes, and ``row_ptr`` is derived anew
        from the patched ``dst_local``: the kernels walk each row's edges
        through it, and the plain rounds never read it.
        """
        bounds = self.bounds
        graph = self._sched_graph
        pad_val = self.problem.semiring.pad_edge_val
        touched = self._touched_workers(report.affected_rows)
        for delta_eff, sched in list(self._schedules.items()):
            stripes, fits = {}, True
            for w in touched:
                lo, hi = int(bounds[w]), int(bounds[w + 1])
                st = build_worker_stripe(graph, lo, hi, sched.S, delta_eff, pad_val)
                if st["src"].shape[1] > sched.M:
                    fits = False
                    break
                stripes[int(w)] = st
            if not fits:
                del self._schedules[delta_eff]
                continue
            src, val, dst_local = sched.src.clone(), sched.val.clone(), sched.dst_local.clone()
            for w, st in stripes.items():
                m = st["src"].shape[1]
                src[:, w] = 0
                src[:, w, :m] = torch.from_numpy(st["src"]).to(src.device)
                val[:, w] = pad_val.item()
                val[:, w, :m] = torch.from_numpy(st["val"]).to(val.device, val.dtype)
                dst_local[:, w] = delta_eff
                dst_local[:, w, :m] = torch.from_numpy(st["dst_local"]).to(dst_local.device)
                # rows[:, w] is untouched: it depends only on (lo, hi, δ, n)
            self._schedules[delta_eff] = dataclasses.replace(
                sched,
                src=src,
                val=val,
                dst_local=dst_local,
                row_ptr=_cell_row_ptr(dst_local, delta_eff),
                edges=graph.nnz,
                padding_overhead=src.numel() / max(graph.nnz, 1),
            )

    def resolve(
        self,
        updates=None,
        *,
        x0=None,
        q=None,
        delta=None,
        backend: str | None = None,
        frontier: str | None = None,
        tol: float | None = None,
        max_rounds: int | None = None,
    ) -> EngineResult:
        """Incremental re-solve after ``updates`` (an ``EdgeBatch``), seeded
        from the previous fixed point.

        Applies the batch via :meth:`apply_updates`, repairs the prior fixed
        point into a valid warm state (:mod:`repro_torch.evolve.restart`: the
        delete-edge invalidation cone is re-raised for min-plus problems
        before any re-lowering), and converges on the mutated graph.  The
        result equals a cold :meth:`solve` on the mutated graph within tol
        (bit-exact labels for min-plus) in typically far fewer rounds.

        ``x0=`` overrides the warm seed (defaults to this solver's last
        solve's fixed point).  With ``updates=None`` this is a plain warm
        re-solve.  ``delta=None``/``"auto"`` prefers the incremental-regime
        δ* once one is fitted (``_auto_delta_incremental``).
        """
        if x0 is None and self._last_x is None:
            raise ValueError(
                "resolve() warm-starts from the previous fixed point — "
                "call solve() first or pass x0="
            )
        report = None
        if updates is not None:
            report = self.apply_updates(updates)
        x_prev = np.asarray(x0) if x0 is not None else self._last_x
        y = warm_start_state(
            self.problem,
            self.graph,
            self._sched_graph,
            x_prev,
            batch=updates,
            report=report,
        )
        if (delta is None and self.default_delta == "auto") or delta == "auto":
            if self._auto_delta_incremental is not None:
                delta = self._auto_delta_incremental
        return self.solve(
            y,
            q=q,
            delta=delta,
            backend=backend,
            frontier=frontier,
            tol=tol,
            max_rounds=max_rounds,
        )

    def solve_batch(
        self,
        x0_batch,
        *,
        q=None,
        delta=None,
        backend: str | None = None,
        frontier: str | None = None,
        tol=None,
        max_rounds=None,
        compact_every: int | None = None,
    ) -> batch.BatchResult:
        """Batched multi-query solve — see :func:`repro_torch.solve.batch.solve_batch`."""
        return batch.solve_batch(
            self,
            x0_batch,
            q=q,
            delta=delta,
            backend=backend,
            frontier=frontier,
            tol=tol,
            max_rounds=max_rounds,
            compact_every=compact_every,
        )
