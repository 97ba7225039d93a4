"""Graph-query serving from a warm solver cache, behind a typed API.

The port of ``repro.launch.serve_graph``.  The serving-scale scenario: one
resident graph, many concurrent queries.  :class:`GraphService` keeps one
warm :class:`repro_torch.solve.Solver` per problem family and serves
queries through the continuous-batching tier
(:mod:`repro_torch.launch.service`): requests are typed
:class:`~repro_torch.launch.service.types.QueryRequest` objects, admitted
into a bounded queue and slotted into fixed-capacity in-flight batches as
converged queries retire — the first quantum pays the schedule build (and,
once a process, the kernels' load), every later quantum pays neither, and
nobody waits for a full batch to form.  On a CUDA device each lane quantum
is one launch of K1's loop entry (``backend="kernel"``, the default).

The services run on the card unless given ``device="cpu"``.  The port
traces and compiles nothing per shape (its kernels are built once per
source), so its solvers count no ``traces`` or ``compiles``:
``--assert-warm`` holds the counters the port has, ``schedule_builds``,
``plan_builds``, ``stripe_builds`` and ``plan_shard_builds``, all at zero.

Across processes, ``GraphService(group=...)`` on every rank of a
``torch.distributed`` group serves over the rank rounds (each lane quantum
:class:`~repro_torch.solve.BatchStepper` across the group).  Rank 0 is the
front end: :meth:`GraphService.submit` and :meth:`GraphService.submit_update`
take requests there alone, and :meth:`GraphService.pump`,
:meth:`GraphService.drain` and :meth:`GraphService.advance_clock` are
collective: each first calls :meth:`GraphService.sync`, which hands rank
0's new requests, updates and clock moves to every rank, whose schedulers
then decide alike (their decisions run on the round clock alone) and pump
the same lanes.  :attr:`GraphService.idle` is a plain read: every rank
calls ``sync()`` before it reads it.  Every rank returns the results; only
``latency_s`` differs.

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve_graph --graph twitter \\
        --scale 12 --algo both --queries 8 --repeats 3 --delta auto

(add ``--device cpu`` to run the plain loop on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
import warnings

import numpy as np

from repro_torch.core.engine import MIN_CHUNK
from repro_torch.graphs.formats import CSRGraph
from repro_torch.graphs.generators import make_graph
from repro_torch.launch.service.types import (
    DEFAULT_CLASSES,
    Admission,
    ClassPolicy,
    QueryRequest,
    QueryResult,
)
from repro_torch.solve import (
    BACKENDS,
    Solver,
    label_propagation_problem,
    ppr_problem,
    rwr_embedding_problem,
    sssp_problem,
)
from repro_torch.solve.solver import FRONTIERS, resolve_device

__all__ = ["GraphService", "main"]

#: The cold-work counters ``--assert-warm`` holds at zero.
WARM_GATE_COUNTERS = ("schedule_builds", "plan_builds", "stripe_builds", "plan_shard_builds")


class GraphService:
    """Answers SSSP / PPR / RWR / label-propagation queries on one graph.

    Vector algorithms (``"sssp"``, ``"ppr"``) retire ``(n,)`` rows; matrix
    algorithms (``"rwr"`` — F random-walk-with-restart proximity columns,
    ``"labelprop"`` — F-class semi-supervised labels) retire ``(n, F)``
    matrices, with ``F = feature_dim``.  All four share the continuous-
    batching lanes; a matrix lane's batch frontier simply carries the extra
    trailing feature axis.

    The public surface is the typed request/response API: :meth:`submit` a
    :class:`QueryRequest` (constant-time admission or a reasoned rejection),
    then :meth:`drain` (or :meth:`pump` one quantum at a time) to collect
    :class:`QueryResult` rows as queries converge.  ``batch_size`` slots per
    ``(algo, class)`` lane are the width of its batch frontier; free slots
    ride along pre-converged, so one launch shape serves every occupancy.

    ``damping`` is a property of the *service*, not the request: it must
    match the damping baked into the graph's pagerank edge values
    (``d / outdeg``), so one value covers both the link-follow mass and the
    teleport mass of every PPR query.

    ``backend`` is one of the port's (``"kernel"``: one launch of K1's loop
    entry a lane quantum on a CUDA device, its plain loop on the CPU;
    ``"torch"``: the plain loop) and ``frontier`` is passed through to each
    solver.  A halo lane (``frontier="halo"``, over ``n_shards`` shards of
    the one device; the reference takes its mesh's) runs each quantum's
    rounds as launches of K2's batch entry, one a round.  ``compact_every``
    sets the scheduling quantum in rounds (how often converged queries
    retire and queued ones slot in) for every request class.

    ``cache_dir`` makes the warm state survive the *process*: each solver
    persists its schedules, stripes and δ-model to the content-addressed
    store (:mod:`repro_torch.persist`), so a restarted service pointed at
    the same directory serves its first quantum with zero schedule and
    stripe builds; ``reprobe_every=N`` keeps refitting the δ-model from the
    observations production solves log there, migrating ``delta="auto"``
    services to the measured-best δ* as traffic accumulates.

    ``sssp(sources)`` / ``ppr(seeds)`` remain as deprecated sugar over
    submit/drain (any query count — longer lists split across queue slots).

    ``device`` is each solver's (``None``: the current CUDA device, and an
    error where there is none).  ``degrade=True`` gives each solver the
    degradation ladder (:class:`~repro_torch.solve.Solver` ``degrade``),
    which only a caller's ``svc.solver(name).solve(...)`` climbs: the lanes
    (:class:`~repro_torch.solve.BatchStepper`) have no ladder, and a fault
    in a lane quantum is the scheduler's to retry on the same kernel either
    way.

    ``group`` (a ``torch.distributed`` group or a
    :class:`~repro_torch.dist.comm.HaloGroup`) serves across processes, as
    the module docstring says; ``degrade=True`` is refused there.
    """

    def __init__(
        self,
        graph: CSRGraph,
        n_workers: int = 8,
        delta="auto",
        batch_size: int = 8,
        min_chunk: int = MIN_CHUNK,
        damping: float = 0.85,
        backend: str = "kernel",
        frontier: str = "replicated",
        n_shards: int = 1,
        compact_every: int | None = None,
        cache_dir=None,
        reprobe_every: int | None = None,
        queue_capacity: int = 64,
        per_graph_quota: int | None = None,
        classes: dict[str, ClassPolicy] | None = None,
        algos: tuple[str, ...] = ("sssp", "ppr"),
        feature_dim: int = 4,
        degrade: bool = False,
        device=None,
        group=None,
    ):
        if group is not None:
            if degrade:
                raise NotImplementedError(
                    "GraphService(group=..., degrade=True): every rank would have to step down the ladder "
                    "together; ROADMAP queue A (A9, third part)"
                )
            from repro_torch.dist.comm import HaloGroup

            if not isinstance(group, HaloGroup):
                group = HaloGroup(group)
        self.group = group
        self._outbox: list[tuple] = []  # rank 0's requests, updates and clock moves since the last sync
        self.device = resolve_device(device)
        self.graph = graph
        self.n_workers = n_workers
        self.delta = delta
        self.batch_size = batch_size
        self.min_chunk = min_chunk
        self.damping = damping
        self.backend = backend
        self.frontier = frontier
        self.n_shards = n_shards
        self.compact_every = compact_every
        self.cache_dir = cache_dir
        self.reprobe_every = reprobe_every
        self.queue_capacity = queue_capacity
        self.per_graph_quota = per_graph_quota
        self.classes = classes
        self.algos = tuple(algos)
        self.feature_dim = feature_dim  # F for the matrix algos (rwr/labelprop)
        # reaches the solvers' own solve() alone; lanes retry, never degrade
        self.degrade = degrade
        self._solvers: dict[str, Solver] = {}
        self._scheduler = None
        self._unclaimed: list[QueryResult] = []

    def solver(self, name: str) -> Solver:
        """The warm per-problem solver (built on first use, then cached)."""
        sv = self._solvers.get(name)
        if sv is None:
            problems = {
                "sssp": sssp_problem,
                "ppr": lambda: ppr_problem(damping=self.damping),
                "rwr": lambda: rwr_embedding_problem(
                    feature_dim=self.feature_dim, damping=self.damping
                ),
                "labelprop": lambda: label_propagation_problem(
                    feature_dim=self.feature_dim
                ),
            }
            sv = Solver(
                self.graph,
                problems[name](),
                n_workers=self.n_workers,
                delta=self.delta,
                backend=self.backend,
                frontier=self.frontier,
                n_shards=self.n_shards,
                min_chunk=self.min_chunk,
                cache_dir=self.cache_dir,
                reprobe_every=self.reprobe_every,
                degrade=self.degrade,
                device=self.device,
                group=self.group,
            )
            self._solvers[name] = sv
        return sv

    # ------------------------------------------------------ typed surface #
    @property
    def scheduler(self):
        """The service's own single-tenant :class:`ContinuousScheduler`."""
        if self._scheduler is None:
            from repro_torch.launch.service.scheduler import ContinuousScheduler

            classes = self.classes
            if classes is None and self.compact_every is not None:
                # legacy knob: one quantum length for every request class
                classes = {
                    name: dataclasses.replace(p, slot_rounds=self.compact_every)
                    for name, p in DEFAULT_CLASSES.items()
                }
            self._scheduler = ContinuousScheduler(
                {"default": self},
                classes=classes,
                queue_capacity=self.queue_capacity,
                per_graph_quota=self.per_graph_quota,
                group=self.group,
            )
        return self._scheduler

    # ------------------------------------------------- across processes #
    def _front_end(self, what: str, op) -> None:
        """Log rank 0's ``op`` for the next sync; refuse on any other rank."""
        if self.group is None:
            return
        if self.group.rank != 0:
            raise ValueError(f"{what} on rank {self.group.rank}: a GraphService(group=...) takes requests on rank 0")
        self._outbox.append(op)

    def sync(self) -> None:
        """Across a group (collective: every rank calls it, in the same
        order): hand rank 0's requests, updates and clock moves since the
        last sync to every other rank, which applies them to its scheduler
        in the same order.  :meth:`pump`, :meth:`drain` and
        :meth:`advance_clock` call it first; a caller syncs before reading
        :attr:`idle` on every rank.  Nothing across one process."""
        if self.group is None:
            return
        ops = self.group.broadcast_object(self._outbox)
        self._outbox = []
        if self.group.rank == 0:
            return
        apply = {"submit": self.scheduler.submit, "update": self.scheduler.submit_update,
                 "clock": self.scheduler.advance_clock}
        for kind, arg in ops:
            apply[kind](arg)

    @property
    def clock_rounds(self) -> int:
        """The scheduler's round clock (the same on every rank after a sync)."""
        return self.scheduler.clock_rounds

    @property
    def idle(self) -> bool:
        """Whether queue, lanes and pending updates are empty (a plain read:
        across a group, of what this rank has seen by its last
        :meth:`sync`)."""
        return self.scheduler.idle

    def advance_clock(self, to_rounds: int) -> None:
        """Fast-forward the round clock across an idle gap; collective
        across a group (rank 0's ``to_rounds`` holds)."""
        if self.group is None or self.group.rank == 0:
            self._front_end("advance_clock", ("clock", int(to_rounds)))
            self.scheduler.advance_clock(to_rounds)
        self.sync()

    def submit(self, req: QueryRequest) -> Admission:
        """Admit one request (or reject with a reason) — never blocks.
        Across a group, on rank 0 alone."""
        self._front_end("submit", ("submit", req))
        return self.scheduler.submit(req)

    def submit_update(self, req) -> Admission:
        """Admit one edge-update batch; it applies at a quiesced round
        boundary (see :meth:`ContinuousScheduler.submit_update`).  Across a
        group, on rank 0 alone; every rank applies it."""
        self._front_end("submit_update", ("update", req))
        return self.scheduler.submit_update(req)

    def take_update_results(self) -> list:
        """Applied-update lifecycle records (cleared on read)."""
        return self.scheduler.take_update_results()

    def take_failures(self) -> list:
        """Typed :class:`QueryFailure` tombstones (cleared on read)."""
        return self.scheduler.take_failures()

    def apply_updates(self, batch):
        """Mutate the resident graph in place (synchronous path).

        Every warm solver re-solves incrementally from here on
        (``Solver.resolve`` semantics); schedules are patched stripe-wise
        on their device rather than rebuilt.  The serving tier calls this
        from the scheduler's quiesced round boundary — direct callers must
        ensure no queries are in flight.  Returns the
        :class:`~repro_torch.graphs.updates.UpdateReport` of the applied batch.
        """
        report = None
        for sv in self._solvers.values():
            report = sv.apply_updates(batch)
        if self._solvers:
            self.graph = next(iter(self._solvers.values())).graph
        else:
            self.graph, report = self.graph.apply_updates(batch)
        return report

    def pump(self) -> list[QueryResult]:
        """Run one scheduling quantum; return the queries that retired
        (collective across a group, every rank's results)."""
        self.sync()
        results = self._unclaimed + self.scheduler.pump()
        self._unclaimed = []
        return results

    def drain(self) -> list[QueryResult]:
        """Pump until queue and lanes are empty; return everything retired
        (collective across a group)."""
        self.sync()
        results = self._unclaimed + self.scheduler.drain()
        self._unclaimed = []
        return results

    # ------------------------------------------------- deprecated surface #
    def _legacy_query(self, algo: str, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if ids.ndim != 1:
            raise ValueError(f"expected a 1-D query list, got shape {ids.shape}")
        if ids.size == 0:
            raise ValueError("empty query list")
        wanted: list[str] = []
        collected: dict[str, QueryResult] = {}

        def take(results):
            for r in results:
                if r.request_id in taken_ids:
                    collected[r.request_id] = r
                else:  # a typed-API caller's request — hold for their drain()
                    self._unclaimed.append(r)

        taken_ids: set[str] = set()
        for v in ids:
            while True:
                adm = self.scheduler.submit(QueryRequest(algo=algo, payload=int(v)))
                if adm.accepted:
                    wanted.append(adm.request_id)
                    taken_ids.add(adm.request_id)
                    break
                if adm.reason != "queue_full":
                    raise ValueError(f"query rejected: {adm.reason}")
                take(self.scheduler.pump())  # free queue slots, then retry
        while len(collected) < len(wanted):
            take(self.scheduler.pump())
        return np.stack([collected[rid].x for rid in wanted])

    def sssp(self, sources) -> np.ndarray:
        """(k, n) int32 distance rows, one per source.

        .. deprecated:: use ``submit(QueryRequest(algo="sssp", payload=s))``
           + ``drain()``.
        """
        warnings.warn(
            "GraphService.sssp() is deprecated; use "
            "submit(QueryRequest(algo='sssp', payload=...)) + drain()",
            DeprecationWarning,
            stacklevel=2,
        )
        return self._legacy_query("sssp", sources)

    def ppr(self, seeds) -> np.ndarray:
        """(k, n) float32 personalized-PageRank rows, one per seed.

        .. deprecated:: use ``submit(QueryRequest(algo="ppr", payload=s))``
           + ``drain()``.
        """
        warnings.warn(
            "GraphService.ppr() is deprecated; use "
            "submit(QueryRequest(algo='ppr', payload=...)) + drain()",
            DeprecationWarning,
            stacklevel=2,
        )
        return self._legacy_query("ppr", seeds)

    def stats(self) -> dict:
        return {name: dict(sv.stats) for name, sv in self._solvers.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--graph", default="twitter")
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--efactor", type=int, default=8)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--delta", default="auto", help="'auto', 'sync', 'async', or int")
    ap.add_argument(
        "--algo",
        choices=["sssp", "ppr", "rwr", "labelprop", "both", "all"],
        default="both",
        help="'both' = sssp+ppr (vector algos); 'all' adds the matrix algos",
    )
    ap.add_argument("--queries", type=int, default=8, help="batch capacity Q")
    ap.add_argument(
        "--feature-dim",
        type=int,
        default=4,
        help="F for the matrix-frontier algos (rwr/labelprop)",
    )
    ap.add_argument("--repeats", type=int, default=3, help="waves per algo")
    ap.add_argument("--min-chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=list(BACKENDS), default="kernel")
    ap.add_argument("--frontier", choices=list(FRONTIERS), default="replicated")
    ap.add_argument(
        "--device",
        default=None,
        help="the solvers' device (default: the current CUDA device; 'cpu' "
        "runs the plain loop on the CPU)",
    )
    ap.add_argument(
        "--compact-every",
        type=int,
        default=None,
        help="scheduling quantum in rounds (default: per-class policy)",
    )
    ap.add_argument(
        "--cache-dir",
        default=None,
        help="persistent warm-start cache directory (schedules, stripes and "
        "the δ-model survive restarts)",
    )
    ap.add_argument(
        "--reprobe-every",
        type=int,
        default=None,
        help="refit the δ-model from logged observations every N solves "
        "(requires --cache-dir and --delta auto)",
    )
    ap.add_argument(
        "--assert-warm",
        action="store_true",
        help="fail (exit 1) unless every solver served from the cache: zero "
        "schedule, plan, stripe and plan-shard builds (the warm-restart gate)",
    )
    args = ap.parse_args(argv)

    delta = args.delta if args.delta in ("auto", "sync", "async") else int(args.delta)
    # PPR/RWR queries need weighted pagerank edge values; SSSP needs lengths —
    # one service per edge-value kind, same topology.  (labelprop overrides
    # edge values with unit weights itself, so any kind works.)
    if args.algo == "both":
        algos = ["sssp", "ppr"]
    elif args.algo == "all":
        algos = ["sssp", "ppr", "rwr", "labelprop"]
    else:
        algos = [args.algo]
    rng = np.random.default_rng(args.seed)
    report: dict = {"latency_s": {}, "stats": {}}
    for algo in algos:
        kind = "sssp" if algo == "sssp" else "pagerank"
        g = make_graph(args.graph, scale=args.scale, efactor=args.efactor, kind=kind)
        service = GraphService(
            g,
            n_workers=args.workers,
            delta=delta,
            batch_size=args.queries,
            min_chunk=args.min_chunk,
            backend=args.backend,
            frontier=args.frontier,
            compact_every=args.compact_every,
            cache_dir=args.cache_dir,
            reprobe_every=args.reprobe_every,
            queue_capacity=max(64, args.queries),
            algos=(algo,),
            feature_dim=args.feature_dim,
            device=args.device,
        )
        lat = []
        for rep in range(args.repeats):
            qids = rng.integers(0, g.n, args.queries)
            t0 = time.perf_counter()
            for v in qids:
                adm = service.submit(QueryRequest(algo=algo, payload=int(v)))
                assert adm.accepted, adm.reason
            out = service.drain()
            lat.append(time.perf_counter() - t0)
            assert len(out) == args.queries
            want = (
                (g.n,)
                if algo in ("sssp", "ppr")
                else (g.n, args.feature_dim)
            )
            assert all(r.x.shape == want for r in out)
        sv = service.solver(algo)
        warm = f"{min(lat[1:]) * 1e3:.1f} ms" if len(lat) > 1 else "n/a (1 repeat)"
        print(
            f"{algo}: graph={g.name} n={g.n} δ={sv.resolve_delta():d} "
            f"Q={args.queries} device={service.device}  cold={lat[0] * 1e3:.1f} ms  "
            f"warm={warm}  (schedule builds={sv.stats['schedule_builds']}, "
            f"stripe builds={sv.stats['stripe_builds']}, "
            f"cache loads={sv.stats['cache_loads']})"
        )
        report["latency_s"][algo] = lat
        report["stats"][algo] = service.stats()[algo]
    if args.assert_warm:
        cold = {
            algo: {k: stats[k] for k in WARM_GATE_COUNTERS if stats[k]}
            for algo, stats in report["stats"].items()
        }
        cold = {algo: c for algo, c in cold.items() if c}
        if cold:
            raise SystemExit(
                f"--assert-warm: cold work performed despite the cache: {cold} "
                f"(cache_dir={args.cache_dir!r})"
            )
        print(
            "warm restart verified: zero schedule, plan, stripe and "
            "plan-shard builds across all solvers"
        )
    return report


if __name__ == "__main__":
    main()
