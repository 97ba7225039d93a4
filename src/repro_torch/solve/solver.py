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

``solve_batch`` answers Q queries together, on the replicated frontier in
one launch of K1's loop entry a compaction chunk for all Q
(:mod:`repro_torch.solve.batch`, which also holds the open batch
:class:`~repro_torch.solve.batch.BatchStepper`), on the halo frontier one
launch of K2's batch entry a round.

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

Persistence: ``cache_dir=`` extends the solver's caches across processes
(:mod:`repro_torch.persist`).  Schedules (whole, and each worker's stripe),
halo plans (whole, and each shard's piece) and the fitted δ-model of each
regime go to a content-addressed store, so a second process on the same
directory answers warm: no probe, no schedule or plan build, its first
solve one launch of K1's loop entry over a loaded schedule, bit for bit the
cold answer.  Every solve logs its ``(δ, rounds, time)`` there;
:meth:`Solver.reprobe_delta` refits the δ-model from that log, and
``reprobe_every=N`` does so every N observations.  ``partition_method``
names the block partitioner (:data:`~repro_torch.graphs.partition.PARTITION_METHODS`).

Across processes: ``Solver(..., group=...)`` (a ``torch.distributed``
process group, or a :class:`~repro_torch.dist.comm.HaloGroup`) runs one
rank of a solve.  Every rank constructs the solver on the same graph and
calls ``solve()`` (``solve_batch``, a ``BatchStepper``'s ``admit`` and
``run``) collectively, and every rank returns the one-process answer bit
for bit.  On the halo frontier (``n_shards=D``) a rank keeps on its device
only its own ``D/W`` shards' frontier, plan blocks and workers' schedule
cells (the CSR stays on the host), and each commit step is K2's rank entry,
the group's all-gather of the boundary rows and K2's receive.  On the
replicated frontier a rank keeps the whole frontier and its ``P/W``
workers' cells, and each commit step is K1's rank step over its workers,
the group's all-gather of every worker's new rows and K1's publish; the
residual is taken over the whole frontier, the same bits on every rank, so
the stopping test needs no collective.  ``delta="auto"`` probes on the
replicated frontier across the group, so every rank fits the same δ-model.
``apply_updates`` and ``resolve`` run on every rank: each holds the whole
CSR on the host and applies the same batch, so every rank has the same
report, graph and warm state with no collective, and patches only its own
workers' cells; a δ whose touched stripe outgrows ``M`` drops on every rank
alike (decided from ``indptr`` for every touched worker).  With
``cache_dir`` a rank reads and writes only its own workers' stripes and its
own shards' plan pieces, under the digests a one-process solver uses, so one
store serves both; rank 0 alone writes the δ-models and the observation
log, and hands what it reads of them to the other ranks (constructing such
a solver, ``reprobe_delta`` and a logged solve are collective).
``degrade=True`` and checkpointed solves across processes raise
``NotImplementedError`` (ROADMAP queue A).

Fault tolerance: with ``degrade=True`` a fault that the ``kernel.dispatch``
site raises (:class:`~repro_torch.ft.inject.InjectedFault`) does not
propagate; the solve retries one rung down
:func:`~repro_torch.ft.degrade.degradation_ladder` (halo → replicated, then
``kernel`` → ``torch``) and records a
:class:`~repro_torch.ft.degrade.Degradation` in ``degradations``.  Every
other error raises: a kernel that fails to launch, an out-of-memory error,
a caller's error, ``NotImplementedError``; the kernels' build runs before
the ladder, so a kernel that does not build raises too.  :func:`repro_torch.ft.elastic.checkpointed_solve`
snapshots a solve every few rounds and resumes it after a fault.

The solver runs on CUDA unless it is given ``device="cpu"``; with no CUDA
device and no ``device`` it raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.delta_model import fit_delta_model, refit_delta_models
from repro_torch.core.engine import (
    MIN_CHUNK,
    DeviceSchedule,
    EngineResult,
    _cell_row_ptr,
    extend_frontier,
    fused_loop,
    host_loop,
    make_schedule,
    stripe_schedule_arrays,
)
from repro_torch.dist import engine_sharded
from repro_torch.evolve.restart import warm_start_state
from repro_torch.ft.degrade import Degradation, degradation_ladder
from repro_torch.ft.inject import InjectedFault, fire
from repro_torch.graphs.formats import CSRGraph, assemble_stripe_schedule, build_worker_stripe
from repro_torch.graphs.partition import PARTITION_METHODS
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.round_block import Epilogue
from repro_torch.persist import SolverCache
from repro_torch.persist.keys import plan_cells_fingerprint, plan_shard_fingerprint, stripe_fingerprint
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
    ``cache_dir=`` extends the caches across processes (module docstring).
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
        partition_method: str = "balanced",
        min_chunk: int = MIN_CHUNK,
        tol: float | None = None,
        max_rounds: int | None = None,
        cache_dir=None,
        reprobe_every: int | None = None,
        degrade: bool = False,
        device=None,
        group=None,
    ):
        self._check_backend(backend)
        self._check_frontier(frontier)
        self._check_halo_dtype(halo_dtype)
        if partition_method not in PARTITION_METHODS:
            raise ValueError(
                f"partition_method must be one of {sorted(PARTITION_METHODS)}, "
                f"got {partition_method!r}"
            )
        self._check_delta(delta)
        if n_shards < 1 or n_workers % n_shards:
            raise ValueError(f"P={n_workers} not divisible by D={n_shards}")
        if group is not None:
            if degrade:
                raise NotImplementedError(
                    "Solver(group=..., degrade=True): every rank would have to step down the ladder "
                    "together; ROADMAP queue A (A9, third part)"
                )
            from repro_torch.dist.comm import HaloGroup

            if not isinstance(group, HaloGroup):
                group = HaloGroup(group, n_shards if frontier == "halo" else None)
            if frontier == "halo" and group.n_shards not in (None, n_shards):
                raise ValueError(f"the group splits {group.n_shards} shards, the solver has {n_shards}")
            group.split(n_workers, "workers")
        self.group = group
        self.device = resolve_device(device)
        self.graph = graph
        self.problem = problem
        self.n_workers = n_workers
        self.default_delta = delta
        self.default_backend = backend
        self.default_frontier = frontier
        self.default_halo_dtype = halo_dtype
        self.n_shards = n_shards
        self.partition_method = partition_method
        self.min_chunk = min_chunk
        self.tol = problem.tol if tol is None else tol
        self.max_rounds = problem.max_rounds if max_rounds is None else max_rounds
        # degrade=True climbs down repro_torch.ft.degrade.degradation_ladder on
        # a fault injected at the dispatch site instead of raising; a
        # kernel's own error raises either way.
        self.degrade = degrade
        self.degradations: list[Degradation] = []
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
        self._rank_cells: dict[int, tuple] = {}  # δ -> (RankSchedule, its host arrays)
        self._rank_layouts: dict[tuple, tuple] = {}  # (δ, frontier) -> (RankSchedule, rank plan or None)
        self._last_x = None  # fixed point of the most recent solve (host copy)
        self._last_report = None  # UpdateReport of the most recent apply_updates
        self.stats = {
            "solves": 0,
            "schedule_builds": 0,
            "plan_builds": 0,
            "stripe_builds": 0,
            "stripe_loads": 0,
            "plan_shard_builds": 0,
            "plan_shard_loads": 0,
            "cache_loads": 0,
            "degradations": 0,
        }
        self.reprobe_every = reprobe_every
        self._obs_since_refit = 0
        self._reprobing = False
        self._cache_dir = cache_dir
        self.persist = None
        if cache_dir is not None:
            self.persist = self._make_persist()
            self._warm_from_persist()

    def _make_persist(self) -> SolverCache:
        """The content-addressed store namespace for the *current* graph.

        A query problem's row update is hashed at its template query (the
        default query, as the reference traces at it), on the host."""
        problem = self.problem
        q = None
        if problem.takes_query:
            q = (
                problem.default_query(self.graph)
                if problem.default_query is not None
                else np.zeros(self.graph.n, dtype=problem.semiring.dtype)
            )
        return SolverCache.for_solver(
            self._cache_dir,
            self._sched_graph,
            problem,
            problem.make_row_update(self.graph, q, "cpu"),
            self.n_workers,
            self.partition_method,
            self.min_chunk,
            self.tol,
            self.max_rounds,
        )

    @property
    def _writes_shared(self) -> bool:
        """Whether this process writes the store's shared entries (the
        δ-models, the observation log): across a group, rank 0 alone, since
        W appenders would duplicate or interleave the log's rows."""
        return self.group is None or self.group.rank == 0

    def _from_root(self, read):
        """``read()`` of the store; across a group rank 0's, handed to every
        rank, so that all ranks see one version of an entry rank 0 may be
        rewriting."""
        if self.group is None:
            return read()
        return self.group.broadcast_object(read() if self.group.rank == 0 else None)

    def _stored(self, kind: str, digest: str, build) -> tuple:
        """``(entry, built)``: the store's ``kind`` (``"stripe"`` or
        ``"plan_shard"``) under ``digest``, or ``build()`` saved there;
        counts ``<kind>_loads`` or ``<kind>_builds``."""
        entry = getattr(self.persist, f"load_{kind}")(digest)
        if entry is not None:
            self.stats[f"{kind}_loads"] += 1
            return entry, False
        entry = build()
        getattr(self.persist, f"save_{kind}")(digest, entry)
        self.stats[f"{kind}_builds"] += 1
        return entry, True

    def _warm_from_persist(self):
        """Load the δ-models eagerly — the one entry with no lazy fallback.

        ``delta="auto"`` then resolves to the persisted δ* without a single
        probe solve (across a group, rank 0's read on every rank).
        Schedules and halo plans stay lazy: :meth:`schedule`,
        :meth:`frontier_plan` and :meth:`rank_layout` consult the store on
        an in-memory miss, so a warm process loads only the δ it serves.
        """
        loaded, loaded_inc = self._from_root(
            lambda: (self.persist.load_delta_model(), self.persist.load_delta_model(regime="incremental"))
        )
        if loaded is not None:
            self.delta_model, best = loaded
            self._auto_delta = int(min(best, self.block_size))
            self.stats["cache_loads"] += 1
        if loaded_inc is not None:
            self.delta_model_incremental, best_inc = loaded_inc
            self._auto_delta_incremental = int(min(best_inc, self.block_size))

    # ------------------------------------------------------------------ #
    # δ resolution + schedule cache
    # ------------------------------------------------------------------ #
    @property
    def bounds(self) -> np.ndarray:
        """The (P + 1,) contiguous block bounds of ``partition_method``."""
        if self._bounds is None:
            self._bounds = PARTITION_METHODS[self.partition_method](
                self._sched_graph, self.n_workers
            )
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
        """Fit the δ cost model from two measured probes (sync + finest δ),
        on the replicated frontier (across the group where there is one:
        the model reads round counts alone, so every rank fits the same)."""
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
        best = min(self.delta_model.best_delta(), self.block_size)
        if self.persist is not None and self._writes_shared:
            self.persist.save_delta_model(self.delta_model, best)
        return best

    def reprobe_delta(self) -> tuple[int, int]:
        """Refit the δ-model from logged observations and migrate δ*.

        Pulls every production ``(δ, rounds)`` row of the persistent store —
        single solves and batches alike (a batch's rounds are its slowest
        query's, an upper bound that still orders δ) — refits each regime
        (:func:`~repro_torch.core.delta_model.refit_delta_models`), and
        repoints ``delta="auto"`` at the new δ* (a resolve's at the
        incremental one).  Nothing is dropped: schedules are keyed by
        numeric δ, so the old δ*'s stay warm in memory and on disk.
        Across a group it is collective: every rank refits from rank 0's
        read of the log (the refit reads round counts alone), so all move
        to the same δ*.  Returns ``(old_delta_star, new_delta_star)``.
        """
        if self.persist is None:
            raise ValueError("reprobe_delta requires a Solver(cache_dir=...)")
        self._reprobing = True
        try:
            old = self.resolve_delta("auto")  # probes or loads the base model
            models = refit_delta_models(self.delta_model, self._from_root(self.persist.load_observations))
            self.delta_model = models.get("cold", self.delta_model)
            new = int(min(self.delta_model.best_delta(), self.block_size))
            self._auto_delta = new
            self._obs_since_refit = 0
            if self._writes_shared:
                self.persist.save_delta_model(self.delta_model, new)
            if "incremental" in models:
                inc = models["incremental"]
                self.delta_model_incremental = inc
                self._auto_delta_incremental = int(min(inc.best_delta(), self.block_size))
                if self._writes_shared:
                    self.persist.save_delta_model(inc, self._auto_delta_incremental, regime="incremental")
            return old, new
        finally:
            self._reprobing = False

    def _record_observation(
        self, delta: int, rounds: int, total_time_s: float, backend: str,
        kind: str = "solve", regime: str = "cold",
    ):
        """Log one observed ``(δ, rounds, time)``; maybe trigger a refit.
        Across a group rank 0 logs its time, and every rank counts, so all
        refit at the same solve."""
        if self.persist is None:
            return
        if self._writes_shared:
            self.persist.record_observation(
                delta, rounds, total_time_s, backend=backend, kind=kind, regime=regime
            )
        self._obs_since_refit += 1
        if (
            self.reprobe_every is not None
            and self.default_delta == "auto"
            and self._obs_since_refit >= self.reprobe_every
            # never recurse out of the δ="auto" probe solves (no fitted model
            # yet) or out of a refit already in flight
            and self._auto_delta is not None
            and not self._reprobing
        ):
            self.reprobe_delta()

    def schedule(self, delta=None) -> DeviceSchedule:
        """The cached device schedule for ``delta`` (built on first use).

        Resolution order: in memory → the store's whole schedule at this
        solver's bounds → the store's **per-worker stripes** (after a mutation the namespace
        changes, so the whole schedule misses, but every stripe whose block
        the batch did not touch still hits by its content digest; only the
        touched stripes build) → a fresh build.  ``schedule_builds`` counts
        schedules with at least one built stripe; ``stripe_builds`` and
        ``stripe_loads`` count workers.
        """
        delta_eff = self.resolve_delta(delta)
        sched = self._schedules.get(delta_eff)
        if sched is None and self.persist is not None:
            sched = self.persist.load_schedule(delta_eff, self.bounds, self.device)
            if sched is not None:
                self._schedules[delta_eff] = sched
                self.stats["cache_loads"] += 1
            else:
                sched = self._schedule_from_stripes(delta_eff)
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

    def _schedule_from_stripes(self, delta_eff: int) -> DeviceSchedule:
        """Assemble the schedule stripe by stripe through the shared store,
        and store it whole."""
        bounds = self.bounds
        graph = self._sched_graph
        pad_val = self.problem.semiring.pad_edge_val
        delta_eff = int(min(delta_eff, self.block_size))
        S = -(-self.block_size // delta_eff)  # ceil, as build_stripe_schedule
        stripes, built = [], 0
        for w in range(self.n_workers):
            stripe, fresh = self._stored_stripe(int(bounds[w]), int(bounds[w + 1]), S, delta_eff)
            built += fresh
            stripes.append(stripe)
        arrays = stripe_schedule_arrays(
            assemble_stripe_schedule(graph, bounds, delta_eff, pad_val, stripes)
        )
        sched = DeviceSchedule.from_host_arrays(arrays, self.device)
        self._schedules[delta_eff] = sched
        self.stats["schedule_builds" if built else "cache_loads"] += 1
        self.persist.save_schedule(arrays)
        return sched

    def _stored_stripe(self, lo: int, hi: int, S: int, delta: int) -> tuple:
        """``(stripe, built)`` of the worker block ``[lo, hi)`` through the
        shared store (:meth:`_stored`)."""
        graph, pad_val = self._sched_graph, self.problem.semiring.pad_edge_val
        return self._stored(
            "stripe", stripe_fingerprint(graph, lo, hi, S, delta, pad_val),
            lambda: build_worker_stripe(graph, lo, hi, S, delta, pad_val),
        )

    def frontier_plan(self, sched: DeviceSchedule) -> engine_sharded.FrontierPlan:
        """The cached owner-computes halo plan for ``sched`` over
        ``n_shards`` (built on first use; ``stats["plan_builds"]``).

        Mirrors :meth:`schedule`'s tiers: in memory → the store's whole
        plan over ``sched``'s layout → per-shard pieces from the shared store (only the shards whose
        workers a mutation touched rebuild; the exchange indices are
        assembled again either way) → a fresh build.  ``plan_builds`` counts
        plans with at least one built shard.
        """
        D = self.n_shards
        key = (sched.delta, D)
        plan = self._plans.get(key)
        if plan is None and self.persist is not None:
            plan = self.persist.load_plan(sched, D)
            if plan is not None:
                self._plans[key] = plan
                self.stats["cache_loads"] += 1
            else:
                plan = self._plan_from_shards(sched, D)
        if plan is None:
            plan = engine_sharded.make_frontier_plan(sched, D)
            self._plans[key] = plan
            self.stats["plan_builds"] += 1
        return plan

    def _plan_from_shards(self, sched: DeviceSchedule, D: int) -> engine_sharded.FrontierPlan:
        """Assemble the plan shard by shard through the shared store, and
        store it whole."""
        vb = engine_sharded.plan_shard_bounds(sched, D)
        P_loc = sched.P // D
        pieces, built = [], 0
        for d in range(D):
            lo, hi, w0, w1 = int(vb[d]), int(vb[d + 1]), d * P_loc, (d + 1) * P_loc
            piece, fresh = self._stored(
                "plan_shard", plan_shard_fingerprint(sched, lo, hi, w0, w1),
                lambda: engine_sharded.build_plan_shard(sched, lo, hi, w0, w1),
            )
            built += fresh
            pieces.append(piece)
        plan = engine_sharded.assemble_frontier_plan(sched, D, pieces)
        self._plans[(sched.delta, D)] = plan
        self.stats["plan_builds" if built else "cache_loads"] += 1
        self.persist.save_plan(plan, sched)
        return plan

    def rank_layout(self, delta=None, frontier=None) -> tuple:
        """This rank's layout for ``delta`` on ``frontier`` (a solver with a
        ``group``): on the halo frontier ``(RankSchedule, plan)``, its
        workers' schedule cells and its shards' plan blocks; on the
        replicated frontier ``(RankSchedule, None)``, the same cells with
        their ``src`` and every worker's rows on the device
        (:func:`~repro_torch.dist.engine_sharded.replicated_rank`).  A rank
        holds the same ``P/W`` workers on both, so their cells are built
        once a δ from the graph on the host (its own stripes; the plan from
        every shard's halo), and each layout is cached per δ.  With a store
        the rank loads (or builds and saves) its own workers' stripes and
        its own shards' plan pieces alone; ``schedule_builds`` and
        ``plan_builds`` count layouts with at least one built stripe or
        piece, ``cache_loads`` the others."""
        if self.group is None:
            raise ValueError("rank_layout needs a Solver(group=...)")
        frontier = self.resolve_frontier(frontier)
        delta_eff = self.resolve_delta(delta)
        hit = self._rank_layouts.get((delta_eff, frontier))
        if hit is None:
            cells = self._rank_cells.get(delta_eff)
            if cells is None:
                cells = self._rank_cells[delta_eff] = self._rank_cells_built(delta_eff)
            sched, host = cells
            if frontier == "halo":
                self.group.split(self.n_shards)  # a rank holds whole shards
                piece = None
                if self.persist is not None:
                    def piece(src, dst_local, rows, lo, hi):
                        return self._stored(
                            "plan_shard", plan_cells_fingerprint(sched.n, sched.delta, lo, hi, src, dst_local, rows),
                            lambda: engine_sharded.plan_shard_from_cells(src, dst_local, rows, sched.n, sched.delta,
                                                                         lo, hi),
                        )[0]
                before = self.stats["plan_shard_builds"]
                plan = engine_sharded.rank_plan(self._sched_graph, sched, host, self.n_shards, self.device, piece)
                built = self.persist is None or self.stats["plan_shard_builds"] > before
                self.stats["plan_builds" if built else "cache_loads"] += 1
                hit = (sched, plan)
            else:
                hit = (engine_sharded.replicated_rank(sched, host), None)
            self._rank_layouts[(delta_eff, frontier)] = hit
        return hit

    def _rank_cells_built(self, delta_eff: int) -> tuple:
        """This rank's workers' cells at ``delta_eff``
        (:func:`~repro_torch.dist.engine_sharded.rank_schedule`), their
        stripes through the store where there is one."""
        w0, w1 = self.group.split(self.n_workers, "workers")
        stripe = None
        if self.persist is not None:
            def stripe(lo, hi, S, delta):
                return self._stored_stripe(lo, hi, S, delta)[0]
        before = self.stats["stripe_builds"]
        cells = engine_sharded.rank_schedule(
            self._sched_graph, self.bounds, delta_eff, self.problem.semiring.pad_edge_val, w0, w1, self.device,
            stripe,
        )
        built = self.persist is None or self.stats["stripe_builds"] > before
        self.stats["schedule_builds" if built else "cache_loads"] += 1
        return cells

    # ------------------------------------------------------------------ #
    # inputs
    # ------------------------------------------------------------------ #
    def _x_ext(self, x0) -> torch.Tensor:
        """Append the dump slot to ``x0``: a vector ``(n,)`` or a matrix
        ``(n, F)`` (``(n, 1)`` is accepted for any problem, and runs the
        vector round's arithmetic)."""
        return extend_frontier(self._x0_host(x0), self.problem.semiring, self.device)

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
        # zeros per solve, carried from round to round.  (``fn`` works on a
        # copy of ``ef``, so ``ef_init`` stays zero.)
        ef0 = engine_sharded.frontier_ef_init(plan, feat)
        state = {"ef": ef0}

        def rnd(x):
            x, state["ef"] = fn(x, state["ef"])
            return x

        # exposed so that a checkpointed solve (repro_torch.ft.elastic) can
        # snapshot, restore or reset them between rounds
        rnd.ef_state = state
        rnd.ef_init = ef0
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
        regime: str = "cold",
    ) -> EngineResult:
        """Run to convergence; returns the engine's instrumented result.

        ``regime`` tags the persisted observation row (``"cold"`` for
        from-scratch solves, ``"incremental"`` when :meth:`resolve` seeds
        from a prior fixed point), so the δ-model learns each curve apart.

        With ``degrade=True`` (constructor knob) a fault injected at the
        ``kernel.dispatch`` site does not propagate: the solve retries one
        rung down the degradation ladder (halo → replicated, then ``kernel``
        → ``torch``), recording a :class:`~repro_torch.ft.degrade.Degradation`
        a fallback in ``self.degradations``.  Any other error propagates: a
        kernel's launch error is never answered by the plain round.  A
        degraded solve logs no observation: its time is a lower rung's.
        """
        backend = backend or self.default_backend
        self._check_backend(backend)
        frontier = self.resolve_frontier(frontier)
        halo_dtype = self.resolve_halo_dtype(halo_dtype, backend, frontier)
        tol = self.tol if tol is None else tol
        max_rounds = self.max_rounds if max_rounds is None else max_rounds
        if self.group is not None:
            return self._solve_ranks(x0, q, delta, backend, frontier, halo_dtype, tol, max_rounds, regime)
        sched = self.schedule(delta)
        x_ext = self._x_ext(x0)
        feat = tuple(x_ext.shape[1:])
        row_update = self.row_update(q)
        if isinstance(row_update, Epilogue):  # fit its table to x's rows
            row_update = row_update.for_frontier(feat)
        # the kernels' build stays outside the ladder's fault domain: a
        # kernel that does not build raises, it is never degraded
        build_s = build.load_seconds(backend, self.device)
        self.stats["solves"] += 1
        attempts = degradation_ladder(backend, frontier) if self.degrade else [(backend, frontier)]
        result = None
        for rung, (b, f) in enumerate(attempts):
            hd = halo_dtype if rung == 0 else self.resolve_halo_dtype(None, b, f)
            try:
                result = self._solve_once(b, f, hd, sched, x_ext, row_update, feat, tol, max_rounds, build_s)
                break
            except InjectedFault as err:
                # the fault domain is the dispatch site alone: a kernel's own
                # launch error, an OOM or a caller's error raises, and is
                # never answered by the plain round
                if rung + 1 == len(attempts):
                    raise
                nb, nf = attempts[rung + 1]
                self.degradations.append(
                    Degradation(
                        site="solve",
                        from_backend=b,
                        from_frontier=f,
                        to_backend=nb,
                        to_frontier=nf,
                        error=repr(err),
                        rung=rung + 1,
                    )
                )
                self.stats["degradations"] += 1
        self._last_x = np.asarray(result.x)
        if rung == 0:  # a lower rung's time is not the requested backend's
            self._record_observation(sched.delta, result.rounds, result.total_time_s, backend, regime=regime)
        return result

    def _solve_once(self, backend, frontier, halo_dtype, sched, x_ext, row_update, feat, tol, max_rounds,
                    build_s) -> EngineResult:
        """One dispatch at a fixed (backend, frontier) rung: the fault domain
        the degradation ladder retries.  Neither path writes ``x_ext``."""
        fire("kernel.dispatch", backend=backend, frontier=frontier)
        sr, residual = self.problem.semiring, self.problem.residual
        if frontier == "halo":
            rnd = self._halo_round(sched, backend, halo_dtype, row_update, feat)
            return host_loop(rnd, sched, sr, x_ext, residual, tol, max_rounds, compile_time_s=build_s)
        loop = ops.fused_solve if backend == "kernel" else ref.fused_solve_ref

        def solve(x, tol, max_rounds):
            return loop(x, sched, sr, row_update, residual, tol, max_rounds)

        return fused_loop(solve, sched, sr, x_ext, tol, max_rounds, compile_time_s=build_s)

    def _solve_ranks(self, x0, q, delta, backend, frontier, halo_dtype, tol, max_rounds, regime) -> EngineResult:
        """This rank's share of a solve across processes (collective).

        Replicated: the one-process solve's loop (the reference's
        ``make_solve_fn_q``, an f32 residual against an f32 ``tol``, the
        result holding the final residual alone) over
        :func:`~repro_torch.dist.engine_sharded.replicated_rank_round_fn`;
        every rank holds the whole frontier, so its residual is the
        one-process loop's, with the same bits on every rank and for any
        number of ranks.

        Halo: the host loop of the one-process halo solve over the rank's
        shards: each round :func:`~repro_torch.dist.engine_sharded.frontier_rank_round_fn`
        (S commit steps, each with its all-gather), then every shard's
        residual over its owned vertices, summed in shard order across the
        group (the same bits for any number of ranks), against ``tol``.  The
        owned rows are gathered once at the end, so every rank returns the
        whole answer.  Either way every rank counts the observation, and
        rank 0 logs it (:meth:`_record_observation`)."""
        sched, plan = self.rank_layout(delta, frontier)
        sr, residual, g = self.problem.semiring, self.problem.residual, self.group
        x_host = extend_frontier(self._x0_host(x0), sr, "cpu")
        feat = tuple(x_host.shape[1:])
        row_update = self.row_update(q)
        if isinstance(row_update, Epilogue):
            row_update = row_update.for_frontier(feat)
        build_s = build.load_seconds(backend, self.device)
        self.stats["solves"] += 1
        if frontier == "replicated":
            rnd = engine_sharded.replicated_rank_round_fn(sched, sched.rows_all, sr, row_update, g,
                                                          plain=backend == "torch")

            def loop(x, tol, max_rounds):
                return ref.solve_loop(rnd, x, residual, tol, max_rounds)

            result = fused_loop(loop, sched, sr, x_host.to(self.device), tol, max_rounds, compile_time_s=build_s)
        else:
            result = self._halo_ranks(sched, plan, x_host, feat, row_update, backend, halo_dtype, tol, max_rounds,
                                      build_s)
        self._last_x = np.asarray(result.x)
        self._record_observation(sched.delta, result.rounds, result.total_time_s, backend, regime=regime)
        return result

    def _halo_ranks(self, sched, plan, x_host, feat, row_update, backend, halo_dtype, tol, max_rounds,
                    build_s) -> EngineResult:
        """The halo frontier of :meth:`_solve_ranks`: the host loop over this
        rank's shards."""
        sr, residual, g = self.problem.semiring, self.problem.residual, self.group
        x_loc = x_host[plan.gather_index.cpu().long()].contiguous().to(self.device)
        ef = torch.zeros((plan.d1 - plan.d0, plan.S, plan.H) + feat, dtype=torch.float32, device=self.device)
        rank_round = engine_sharded.frontier_rank_round_fn(
            sched, plan, sr, row_update, g, halo_dtype, plain=backend == "torch"
        )
        owned = plan.owned_sizes

        def rnd(x_loc):
            return rank_round(x_loc.clone(), ef)[0]

        def shard_residuals(old, new):
            return g.sum_partials([float(residual(old[i, : owned[i]], new[i, : owned[i]])) for i in range(owned.size)])

        def finish(x_loc):
            return torch.cat([g.gather_owned(x_loc, plan.vertex_bounds), x_host[-1:]])

        return host_loop(rnd, sched, sr, x_loc, shard_residuals, tol, max_rounds, build_s, finish=finish)

    def _x0_host(self, x0) -> np.ndarray:
        """``x0`` (the problem's default when None), shape-checked, on the host."""
        if x0 is None:
            x0 = self.problem.x0(self.graph)
        x0 = np.asarray(x0)
        n = self.graph.n
        if not (x0.shape == (n,) or (x0.ndim == 2 and x0.shape[0] == n)):
            raise ValueError(f"x0 must have shape ({n},) or ({n}, F), got {x0.shape}")
        return x0

    # ------------------------------------------------------------------ #
    # evolving graphs: apply_updates + incremental resolve
    # ------------------------------------------------------------------ #
    def apply_updates(self, batch):
        """Mutate the bound graph; returns the ``UpdateReport``.

        Rebinds the problem's row update and edge values to the new graph and
        invalidates only what the batch touched: every cached schedule keeps
        each stripe whose worker block the affected rows miss, and is patched
        (same shapes) where they hit; halo plans drop, since their index
        tensors were built from the old schedule.  With a store, the
        namespace is derived again from the new graph, the observation log
        and the fitted δ-models carry over to it, and every patched stripe
        goes to the shared store, so a restarted process on the mutated
        graph builds no stripe the batch did not touch.  Across a group every
        rank applies the batch (no collective) and patches its own workers'
        cells (:meth:`_patch_rank_cells`).

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
        if self.persist is not None:
            self._carry_persist_over()
        if self.group is None:
            self._patch_schedules(report)
        else:
            self._patch_rank_cells(report)
        self._last_report = report
        return report

    def _carry_persist_over(self):
        """Point the store at the mutated graph's namespace, carrying the
        observation log over (``reprobe_delta`` needs rounds-against-δ data
        gathered over many small batches, each of which changes the
        namespace but barely moves the curve) and both fitted δ-models."""
        old_obs = self.persist.dir / "observations.jsonl"
        self.persist = self._make_persist()
        if not self._writes_shared:
            return
        new_obs = self.persist.dir / "observations.jsonl"
        if old_obs.exists() and not new_obs.exists():
            try:
                new_obs.write_bytes(old_obs.read_bytes())
            except OSError:
                pass
        if self.delta_model is not None and self._auto_delta is not None:
            self.persist.save_delta_model(self.delta_model, self._auto_delta)
        if self.delta_model_incremental is not None and self._auto_delta_incremental is not None:
            self.persist.save_delta_model(
                self.delta_model_incremental, self._auto_delta_incremental, regime="incremental"
            )

    def _touched_workers(self, affected_rows) -> np.ndarray:
        """Worker blocks containing any affected destination row."""
        affected = np.asarray(affected_rows, dtype=np.int64)
        if affected.size == 0:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.searchsorted(self.bounds, affected, side="right") - 1)

    def _patch_schedules(self, report):
        """Rebuild only the touched workers' stripes of every cached schedule.

        A stripe that outgrows the schedule's padded width ``M`` (read from
        ``indptr``, :func:`~repro_torch.dist.engine_sharded.outgrows`, as a
        group reads it) drops that δ's schedule for a lazy full rebuild
        (global re-padding would touch every worker anyway).  Otherwise the
        patched tensors (:func:`~repro_torch.dist.engine_sharded.patch_cells`)
        are copies on the schedule's device with its shapes, and ``row_ptr``
        is derived anew from the patched ``dst_local``: the kernels walk each
        row's edges through it, and the plain rounds never read it.  With a
        store, each rebuilt stripe is saved under its digest.
        """
        bounds = self.bounds
        graph = self._sched_graph
        pad_val = self.problem.semiring.pad_edge_val
        touched = self._touched_workers(report.affected_rows)
        for delta_eff, sched in list(self._schedules.items()):
            if engine_sharded.outgrows(graph.indptr, bounds, touched, sched.S, delta_eff, sched.M):
                del self._schedules[delta_eff]
                continue
            stripes = {
                int(w): build_worker_stripe(graph, int(bounds[w]), int(bounds[w + 1]), sched.S, delta_eff, pad_val)
                for w in touched
            }
            # rows[:, w] is untouched: it depends only on (lo, hi, δ, n)
            cells = engine_sharded.patch_cells(
                {"src": sched.src, "val": sched.val, "dst_local": sched.dst_local}, stripes, pad_val, delta_eff
            )
            self._schedules[delta_eff] = dataclasses.replace(
                sched,
                **cells,
                row_ptr=_cell_row_ptr(cells["dst_local"], delta_eff),
                edges=graph.nnz,
                padding_overhead=cells["src"].numel() / max(graph.nnz, 1),
            )
            if self.persist is not None:
                for w, st in stripes.items():
                    lo, hi = int(bounds[w]), int(bounds[w + 1])
                    digest = stripe_fingerprint(graph, lo, hi, sched.S, delta_eff, pad_val)
                    self.persist.save_stripe(digest, st)

    def _patch_rank_cells(self, report):
        """:meth:`_patch_schedules` across a group: every rank rebuilds the
        touched stripes of its own workers ``[w0, w1)`` in each cached δ's
        cells (:func:`~repro_torch.dist.engine_sharded.patch_rank_cells`)
        and saves them to the store; the layouts drop, and come again
        lazily from the patched cells (a halo plan's halos from the mutated
        graph).  Whether a touched stripe outgrows ``M`` is read from
        ``indptr`` for every touched worker, not only the rank's own, so
        all ranks keep or drop a δ alike with no collective: a rank that
        kept its cells while another rebuilt them at a new ``M`` would run
        another schedule and hang in the gather."""
        bounds, graph = self.bounds, self._sched_graph
        pad_val = self.problem.semiring.pad_edge_val
        touched = self._touched_workers(report.affected_rows)
        w0, w1 = self.group.split(self.n_workers, "workers")
        self._rank_layouts = {}
        for delta_eff, (sched, host) in list(self._rank_cells.items()):
            if engine_sharded.outgrows(graph.indptr, bounds, touched, sched.S, delta_eff, sched.M):
                del self._rank_cells[delta_eff]
                continue
            stripes = {}
            for w in touched[(touched >= w0) & (touched < w1)]:
                lo, hi = int(bounds[w]), int(bounds[w + 1])
                stripes[int(w)] = st = build_worker_stripe(graph, lo, hi, sched.S, delta_eff, pad_val)
                if self.persist is not None:
                    self.persist.save_stripe(stripe_fingerprint(graph, lo, hi, sched.S, delta_eff, pad_val), st)
            self._rank_cells[delta_eff] = engine_sharded.patch_rank_cells(sched, host, stripes, pad_val, graph.nnz)

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
        δ* once one is fitted (``_auto_delta_incremental``).  Across a group
        it is collective, and every rank returns the one-process answer.
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
            regime="incremental",
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
