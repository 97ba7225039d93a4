"""Continuous-batching scheduler: admission queue → lanes → retirement.

The port of ``repro.launch.service.scheduler`` (pure Python over the port's
:class:`~repro_torch.solve.batch.BatchStepper`): on a CUDA device each lane
quantum is one launch of K1's loop entry over the lane's
``(n + 1, capacity)+feat`` batch frontier.  Its round clock, rejections,
failures and update records are the reference's for the same request
sequence.

The serving loop the LM-inference playbook prescribes, applied to graph
queries: requests are admitted into a bounded FIFO queue, slotted into
fixed-capacity in-flight batches (*lanes*) as converged queries retire at
scheduling-quantum boundaries, and returned the moment **they** converge —
no barrier on batch boundaries, no slow query stalling the rest (the
non-blocking-PageRank / Maiter insight at the scheduling level).

One :class:`ContinuousScheduler` serves several resident
:class:`~repro_torch.launch.serve_graph.GraphService` solvers (multi-graph
tenancy: ``QueryRequest.graph`` routes), and one *lane* exists per
``(graph, algo, class)`` — a :class:`repro_torch.solve.batch.BatchStepper` whose
δ / backend / frontier / quantum come from the class's
:class:`~repro_torch.launch.service.types.ClassPolicy`, so cheap PPR lookups and
deep SSSP traversals schedule independently while sharing the process.

Time is counted in *rounds* (``clock_rounds``): every quantum advances the
clock by the rounds it actually executed, which makes scheduling behavior —
queue waits, retirement order, backpressure — deterministic and assertable
in CI, independent of wall clock.  Wall-clock latency rides along in
``QueryResult.latency_s``.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from repro_torch.ft.inject import fire
from repro_torch.launch.service.types import (
    DEFAULT_CLASSES,
    Admission,
    ClassPolicy,
    QueryFailure,
    QueryRequest,
    QueryResult,
    UpdateRequest,
    UpdateResult,
    default_class_for,
)
from repro_torch.solve.batch import BatchStepper
from repro_torch.solve.problem import (
    labelprop_anchors,
    multi_source_x0,
    ppr_teleport,
    rwr_restart,
)

__all__ = ["AdmissionQueue", "ContinuousScheduler"]


class AdmissionQueue:
    """Bounded FIFO of ``(request_id, QueryRequest)`` — the backpressure valve.

    One global queue, popped per lane in scan order, preserves FIFO within
    every class; ``push`` on a full queue fails deterministically (the
    caller turns that into a ``"queue_full"`` rejection).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._q: deque[tuple[str, QueryRequest]] = deque()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.capacity

    def push(self, request_id: str, req: QueryRequest) -> bool:
        if self.full:
            return False
        self._q.append((request_id, req))
        return True

    def push_front(self, items) -> None:
        """Requeue already-admitted entries at the head, preserving order.

        Used by fault recovery: evicted in-flight riders go back *ahead* of
        everything queued (they were admitted first).  Deliberately ignores
        ``capacity`` — these entries were already accepted, and dropping them
        would violate the no-silent-loss contract; the overshoot is transient
        (they re-admit before anything behind them).
        """
        self._q.extendleft(reversed(list(items)))

    def items(self) -> tuple[tuple[str, QueryRequest], ...]:
        """FIFO snapshot (for lane materialization / introspection)."""
        return tuple(self._q)

    def pop_where(self, pred, k: int) -> list[tuple[str, QueryRequest]]:
        """Pop up to ``k`` entries matching ``pred(req)``, preserving FIFO."""
        return self.pop_items_where(lambda item: pred(item[1]), k)

    def pop_items_where(
        self, pred, k: int | None = None
    ) -> list[tuple[str, QueryRequest]]:
        """Pop up to ``k`` entries matching ``pred((request_id, req))``."""
        if k is None:
            k = len(self._q)
        taken: list[tuple[str, QueryRequest]] = []
        kept: deque[tuple[str, QueryRequest]] = deque()
        while self._q:
            item = self._q.popleft()
            if len(taken) < k and pred(item):
                taken.append(item)
            else:
                kept.append(item)
        self._q = kept
        return taken


class _PendingUpdate:
    """Book-keeping for one accepted update batch while its graph quiesces."""

    __slots__ = ("req", "submitted_clock", "submit_wall")

    def __init__(self, req: UpdateRequest, clock: int, wall: float):
        self.req = req
        self.submitted_clock = clock
        self.submit_wall = wall


class _Pending:
    """Book-keeping for one accepted request while it waits / runs."""

    __slots__ = (
        "req",
        "submitted_clock",
        "submit_wall",
        "admitted_clock",
        "admit_seq",
        "attempts",
        "retry_at_clock",
    )

    def __init__(self, req: QueryRequest, clock: int, wall: float):
        self.req = req
        self.submitted_clock = clock
        self.submit_wall = wall
        self.admitted_clock = -1
        self.admit_seq = -1
        self.attempts = 0  # faulted lane quanta this request rode
        self.retry_at_clock = 0  # earliest clock it may re-admit (backoff)


class _Breaker:
    """Per-lane circuit breaker: consecutive faults open it for a cooldown."""

    __slots__ = ("consecutive", "open_until")

    def __init__(self):
        self.consecutive = 0
        self.open_until = 0


class _Lane:
    """One in-flight open batch: ``(graph, algo, class)`` → BatchStepper."""

    def __init__(self, service, algo: str, policy: ClassPolicy):
        self.service = service
        self.algo = algo
        self.policy = policy
        self.stepper = BatchStepper(
            service.solver(algo),
            capacity=service.batch_size,
            delta=policy.delta,
            backend=policy.backend,
            frontier=policy.frontier,
            max_rounds=policy.max_rounds,
        )

    def admit(self, request_id: str, req: QueryRequest):
        g = self.service.graph
        if req.algo == "sssp":
            self.stepper.admit(multi_source_x0(g, [req.payload])[0], tag=request_id)
        elif req.algo == "ppr":
            x0 = np.full(g.n, 1.0 / g.n, np.float32)
            q = ppr_teleport(g, [req.payload], self.service.damping)[0]
            self.stepper.admit(x0, q=q, tag=request_id)
        elif req.algo in ("rwr", "labelprop"):
            # matrix-frontier algos: the payload vertex anchors column 0 and
            # the remaining F-1 landmarks are spread evenly around the id
            # space, so one int payload parameterizes an (n, F) query
            F = self.service.solver(req.algo).problem.feature_dim
            seeds = (req.payload + (np.arange(F, dtype=np.int64) * g.n) // F) % g.n
            if req.algo == "rwr":
                x0 = np.full((g.n, F), 1.0 / g.n, np.float32)
                q = rwr_restart(g, seeds, self.service.damping)
            else:
                x0 = np.full((g.n, F), 1.0 / F, np.float32)
                q = labelprop_anchors(g, seeds)
            self.stepper.admit(x0, q=q, tag=request_id)
        else:  # pre-validated in submit(); defensive for direct callers
            raise ValueError(f"unsupported algo {req.algo!r}")

    def run_quantum(self):
        return self.stepper.run(self.policy.slot_rounds)


class ContinuousScheduler:
    """Admission queue + continuous batching over resident graph services.

    * ``services`` — one :class:`GraphService` or a ``{tenant: service}``
      mapping (multi-graph tenancy; requests route by ``req.graph``).
    * ``classes``  — request-class policies, overlaid on
      :data:`~repro_torch.launch.service.types.DEFAULT_CLASSES`.
    * ``queue_capacity`` — bound on queued (not yet slotted-in) requests;
      beyond it :meth:`submit` rejects with ``"queue_full"``.
    * ``per_graph_quota`` — per-tenant admission bound: queued queries plus
      pending update batches for one graph; beyond it :meth:`submit` /
      :meth:`submit_update` reject with ``"quota_exceeded"`` (checked before
      the global ``queue_full``, so one tenant can't starve the rest).

    Edge-update batches travel :meth:`submit_update` →
    :meth:`take_update_results`: accepted :class:`UpdateRequest`\\ s queue
    per graph and apply inside :meth:`pump` only when that graph's lanes are
    quiescent — queries admitted before the update retire on the old
    snapshot, queries submitted after it stay queued until it applies.

    ``submit()`` answers immediately with an :class:`Admission`;
    :meth:`pump` executes one scheduling quantum across all lanes (slot in
    from the queue, run, retire); :meth:`drain` pumps until idle and returns
    every completed :class:`QueryResult`.  All scheduling state advances in
    deterministic round-clock time.

    ``group`` (a :class:`~repro_torch.dist.comm.HaloGroup`, set by a
    ``GraphService(group=...)``) makes a lane fault every rank's: the ranks
    agree on a flag after the ``scheduler.lane`` site, on one in
    :meth:`~repro_torch.solve.BatchStepper.run` after the
    ``kernel.dispatch`` site and the quantum's set-up (both before the
    quantum's first gather, which a faulted rank would never join), and on
    one after the quantum, so that no rank retries a quantum the others
    have finished.  A fault that one rank raises between the quantum's
    gathers (a launch error in its loop) is not agreed on: it leaves the
    others in a gather until the group's timeout raises there too.
    """

    def __init__(
        self,
        services,
        *,
        classes: dict[str, ClassPolicy] | None = None,
        queue_capacity: int = 64,
        per_graph_quota: int | None = None,
        group=None,
    ):
        if not isinstance(services, dict):
            services = {"default": services}
        if not services:
            raise ValueError("at least one resident GraphService is required")
        if per_graph_quota is not None and per_graph_quota < 1:
            raise ValueError(f"per_graph_quota must be >= 1, got {per_graph_quota}")
        self.services = dict(services)
        self.group = group
        self.classes = dict(DEFAULT_CLASSES)
        if classes:
            self.classes.update(classes)
        self.queue = AdmissionQueue(queue_capacity)
        self.per_graph_quota = per_graph_quota
        self._lanes: dict[tuple[str, str, str], _Lane] = {}
        self._pending: dict[str, _Pending] = {}
        self._pending_updates: dict[str, deque[tuple[str, _PendingUpdate]]] = {}
        self._update_results: list[UpdateResult] = []
        self._breakers: dict[tuple[str, str, str], _Breaker] = {}
        self._failures: list[QueryFailure] = []
        self._next_id = 0
        self._next_admit_seq = 0
        self.clock_rounds = 0
        self.counters = {
            "submitted": 0,
            "accepted": 0,
            "rejected": 0,
            "completed": 0,
            "unconverged": 0,
            "failed": 0,
            "lane_faults": 0,
            "retries": 0,
            "pumps": 0,
            "updates_submitted": 0,
            "updates_applied": 0,
        }
        self.rejections: dict[str, int] = {}

    # ------------------------------------------------------------ submit #
    def _reject(self, reason: str) -> Admission:
        self.counters["rejected"] += 1
        self.rejections[reason] = self.rejections.get(reason, 0) + 1
        return Admission(accepted=False, reason=reason, queue_depth=len(self.queue))

    def resolve_class(self, req: QueryRequest) -> str:
        cls = req.request_class
        return default_class_for(req.algo) if cls == "auto" else cls

    def _graph_load(self, graph: str) -> int:
        """Admitted-but-unapplied work for one tenant (the quota metric):
        queued queries plus pending update batches."""
        queued = sum(1 for _, r in self.queue.items() if r.graph == graph)
        return queued + len(self._pending_updates.get(graph, ()))

    def submit(self, req: QueryRequest) -> Admission:
        """Admit or reject one request — constant-time, never blocks."""
        self.counters["submitted"] += 1
        service = self.services.get(req.graph)
        if service is None:
            return self._reject("unknown_graph")
        if req.algo not in getattr(service, "algos", ("sssp", "ppr")):
            return self._reject("unsupported_algo")
        cls = self.resolve_class(req)
        if cls not in self.classes:
            return self._reject("unknown_class")
        breaker = self._breakers.get((req.graph, req.algo, cls))
        if breaker is not None and self.clock_rounds < breaker.open_until:
            return self._reject("lane_open")
        payload = int(req.payload)
        if not 0 <= payload < service.graph.n:
            return self._reject("payload_out_of_range")
        if (
            self.per_graph_quota is not None
            and self._graph_load(req.graph) >= self.per_graph_quota
        ):
            return self._reject("quota_exceeded")
        if self.queue.full:
            return self._reject("queue_full")
        request_id = f"q{self._next_id:06d}"
        self._next_id += 1
        self._pending[request_id] = _Pending(
            req, self.clock_rounds, time.perf_counter()
        )
        self.queue.push(request_id, req)
        self.counters["accepted"] += 1
        return Admission(
            accepted=True, request_id=request_id, queue_depth=len(self.queue)
        )

    # ----------------------------------------------------------- updates #
    def submit_update(self, req: UpdateRequest) -> Admission:
        """Admit one edge-update batch (or reject with a reason).

        Accepted batches join their graph's FIFO update queue and apply at
        the next :meth:`pump` boundary where that graph's lanes are
        quiescent; queries submitted *after* an update stay queued until it
        applies (the snapshot barrier), so results never mix graph versions.
        """
        self.counters["updates_submitted"] += 1
        service = self.services.get(req.graph)
        if service is None:
            return self._reject("unknown_graph")
        verts = req.batch.all_vertices()
        if verts.size and (verts.min() < 0 or verts.max() >= service.graph.n):
            return self._reject("payload_out_of_range")
        if (
            self.per_graph_quota is not None
            and self._graph_load(req.graph) >= self.per_graph_quota
        ):
            return self._reject("quota_exceeded")
        request_id = f"u{self._next_id:06d}"
        self._next_id += 1
        self._pending_updates.setdefault(req.graph, deque()).append(
            (request_id, _PendingUpdate(req, self.clock_rounds, time.perf_counter()))
        )
        self.counters["accepted"] += 1
        return Admission(
            accepted=True, request_id=request_id, queue_depth=len(self.queue)
        )

    def _apply_ready_updates(self):
        """Apply queued update batches whose graph's lanes are all quiescent.

        Runs at the top of every :meth:`pump` — a deterministic round
        boundary: every in-flight query has either retired or sits frozen at
        a quantum edge *on the pre-update snapshot's lanes*, which are
        dropped and lazily rebuilt against the mutated solver only once
        occupancy reaches zero.
        """
        for graph in list(self._pending_updates):
            busy = any(
                lane.stepper.occupancy > 0
                for key, lane in self._lanes.items()
                if key[0] == graph
            )
            if busy:
                continue
            service = self.services[graph]
            queued = self._pending_updates.pop(graph)
            for key in [k for k in self._lanes if k[0] == graph]:
                del self._lanes[key]
            for request_id, pend in queued:
                report = service.apply_updates(pend.req.batch)
                self.counters["updates_applied"] += 1
                self._update_results.append(
                    UpdateResult(
                        request_id=request_id,
                        graph=graph,
                        inserted=int(report.inserted),
                        deleted=int(report.deleted),
                        reweighted=int(report.reweighted),
                        affected_rows=int(report.affected_rows.size),
                        submitted_clock=pend.submitted_clock,
                        applied_clock=self.clock_rounds,
                        latency_s=time.perf_counter() - pend.submit_wall,
                    )
                )

    def take_update_results(self) -> list[UpdateResult]:
        """Applied-update lifecycle records (cleared on read)."""
        out = self._update_results
        self._update_results = []
        return out

    # -------------------------------------------------------------- pump #
    def _lane_for(self, req: QueryRequest) -> _Lane:
        key = (req.graph, req.algo, self.resolve_class(req))
        lane = self._lanes.get(key)
        if lane is None:
            lane = _Lane(self.services[req.graph], req.algo, self.classes[key[2]])
            self._lanes[key] = lane
        return lane

    def _admit_from_queue(self):
        """Slot queued requests into free lane slots, FIFO within class.

        Graphs with pending updates are barriered: their queued queries stay
        in the queue (and no new lanes materialize for them) until the
        update applies, so every admitted query runs on one graph version.
        """
        # Materialize lanes for whatever is queued (deterministic creation
        # order: queue scan order), then fill each lane's free slots.
        for _, req in self.queue.items():
            if req.graph not in self._pending_updates:
                self._lane_for(req)
        for key, lane in self._lanes.items():
            free = lane.stepper.free_slots
            if free == 0:
                continue
            graph, algo, cls = key
            if graph in self._pending_updates:
                continue

            def match(item, g=graph, a=algo, c=cls):
                request_id, r = item
                if r.graph != g or r.algo != a or self.resolve_class(r) != c:
                    return False
                # exponential-backoff wait after a lane fault: stay queued
                # until the retry clock passes
                return self._pending[request_id].retry_at_clock <= self.clock_rounds

            for request_id, req in self.queue.pop_items_where(match, free):
                lane.admit(request_id, req)
                pend = self._pending[request_id]
                pend.admitted_clock = self.clock_rounds
                pend.admit_seq = self._next_admit_seq
                self._next_admit_seq += 1

    def _fail(self, request_id: str, pend: _Pending, reason: str):
        """Retire one admitted request as a typed :class:`QueryFailure`."""
        self._pending.pop(request_id, None)
        self.counters["failed"] += 1
        self._failures.append(
            QueryFailure(
                request_id=request_id,
                algo=pend.req.algo,
                graph=pend.req.graph,
                request_class=self.resolve_class(pend.req),
                payload=int(pend.req.payload),
                reason=reason,
                attempts=pend.attempts,
                submitted_clock=pend.submitted_clock,
                failed_clock=self.clock_rounds,
                latency_s=time.perf_counter() - pend.submit_wall,
            )
        )

    def _expire_deadlines(self):
        """Fail queued requests whose round-clock deadline has passed.

        Deadlines bound *waiting* (queue + retry backoff): once a query is
        slotted in it runs to retirement — its answer exists, delivering it
        is strictly better than discarding work.
        """
        now = self.clock_rounds

        def expired(item):
            request_id, req = item
            if req.deadline_rounds is None:
                return False
            pend = self._pending[request_id]
            return now - pend.submitted_clock > req.deadline_rounds

        for request_id, _ in self.queue.pop_items_where(expired):
            self._fail(request_id, self._pending[request_id], "deadline_exceeded")

    def _on_lane_fault(self, key: tuple[str, str, str], lane: _Lane):
        """Recover from one faulted lane quantum — no admitted query is lost.

        The lane's riders are evicted and requeued at the *head* of the
        admission queue (they were admitted first) with exponential backoff;
        riders whose retry budget is spent fail typed instead.  The lane
        itself is dropped (its batch state is suspect) and will lazily
        rebuild from the solver's still-warm caches; its circuit breaker
        opens after ``breaker_threshold`` consecutive faults.
        """
        self.counters["lane_faults"] += 1
        policy = lane.policy
        requeue = []
        for tag in lane.stepper.evict_all():
            pend = self._pending.get(tag)
            if pend is None:  # defensive: unknown rider, nothing to requeue
                continue
            pend.attempts += 1
            pend.admitted_clock = -1
            if pend.attempts > policy.max_retries:
                self._fail(tag, pend, "retries_exhausted")
                continue
            self.counters["retries"] += 1
            pend.retry_at_clock = self.clock_rounds + policy.backoff_rounds * (
                2 ** (pend.attempts - 1)
            )
            requeue.append((tag, pend.req))
        self.queue.push_front(requeue)
        del self._lanes[key]
        breaker = self._breakers.setdefault(key, _Breaker())
        breaker.consecutive += 1
        if breaker.consecutive >= policy.breaker_threshold:
            breaker.open_until = self.clock_rounds + policy.breaker_cooldown_rounds

    def pump(self) -> list[QueryResult]:
        """One scheduling quantum: apply ready updates, slot in, run, retire.

        A lane quantum that raises (kernel fault, injected chaos) is a
        recoverable event, not a scheduler crash: see :meth:`_on_lane_fault`.
        That includes a kernel that fails to build or launch and a CUDA
        out-of-memory error, whose riders then fail typed; a run on the card
        holds ``counters["lane_faults"] == 0`` to show the kernel served.
        The faulted quantum still advances the round clock by its
        ``slot_rounds`` — burned device time is burned — which also makes
        retry backoff and breaker cooldowns progress deterministically.
        """
        self.counters["pumps"] += 1
        self._apply_ready_updates()
        self._expire_deadlines()
        self._admit_from_queue()
        results: list[QueryResult] = []
        ran = 0
        for key, lane in list(self._lanes.items()):
            if lane.stepper.occupancy == 0:
                continue
            before = lane.stepper.rounds_executed
            faulted = False
            try:
                fire("scheduler.lane", graph=key[0], algo=key[1], request_class=key[2])
            except Exception:
                faulted = True
            if self.group is not None:
                # before the quantum's gathers: a rank faulted here would
                # leave the others waiting in them
                faulted = self.group.any(faulted)
            if not faulted:
                try:
                    retired = lane.run_quantum()
                except (ValueError, TypeError, NotImplementedError):
                    # caller/config errors, and a path the port does not have
                    # yet — not a fault to retry
                    raise
                except Exception:
                    faulted = True
                if self.group is not None:
                    faulted = self.group.any(faulted)  # a fault on any rank is every rank's
            if faulted:
                self.clock_rounds += lane.policy.slot_rounds
                ran += lane.policy.slot_rounds
                self._on_lane_fault(key, lane)
                continue
            breaker = self._breakers.get(key)
            if breaker is not None:
                breaker.consecutive = 0  # a clean quantum closes the breaker
            executed = lane.stepper.rounds_executed - before
            self.clock_rounds += executed
            ran += executed
            for row in retired:
                pend = self._pending.pop(row.tag)
                self.counters["completed"] += 1
                if not row.converged:
                    self.counters["unconverged"] += 1
                results.append(
                    QueryResult(
                        request_id=row.tag,
                        algo=pend.req.algo,
                        graph=pend.req.graph,
                        request_class=self.resolve_class(pend.req),
                        payload=int(pend.req.payload),
                        x=row.x,
                        rounds=row.rounds,
                        converged=row.converged,
                        residual=row.residual,
                        delta=lane.stepper.sched.delta,
                        backend=lane.stepper.backend,
                        admit_seq=pend.admit_seq,
                        submitted_clock=pend.submitted_clock,
                        admitted_clock=pend.admitted_clock,
                        finished_clock=self.clock_rounds,
                        latency_s=time.perf_counter() - pend.submit_wall,
                    )
                )
        if ran == 0 and self.in_flight == 0 and len(self.queue):
            # nothing could run: every queued request is waiting out a retry
            # backoff — fast-forward virtual time to the earliest retry so
            # drain() makes progress instead of spinning
            waits = [
                self._pending[request_id].retry_at_clock
                for request_id, _ in self.queue.items()
            ]
            future = [w for w in waits if w > self.clock_rounds]
            if future:
                self.clock_rounds = min(future)
        return results

    def take_failures(self) -> list[QueryFailure]:
        """Typed tombstones of admitted-but-failed queries (cleared on read).

        Together with :meth:`pump`'s results this closes the accounting
        loop: ``accepted == completed + failed + still-pending`` at every
        quantum boundary — no admitted query is ever silently lost.
        """
        out = self._failures
        self._failures = []
        return out

    def advance_clock(self, to_rounds: int):
        """Fast-forward the round clock across an idle gap (load replay)."""
        self.clock_rounds = max(self.clock_rounds, int(to_rounds))

    # ------------------------------------------------------------- drain #
    @property
    def in_flight(self) -> int:
        return sum(lane.stepper.occupancy for lane in self._lanes.values())

    @property
    def pending_updates(self) -> int:
        return sum(len(q) for q in self._pending_updates.values())

    @property
    def idle(self) -> bool:
        return (
            len(self.queue) == 0 and self.in_flight == 0 and self.pending_updates == 0
        )

    def drain(self, max_pumps: int = 100_000) -> list[QueryResult]:
        """Pump until queue and lanes are empty; return everything retired."""
        results: list[QueryResult] = []
        pumps = 0
        while not self.idle:
            if pumps >= max_pumps:
                raise RuntimeError(
                    f"drain did not settle within {max_pumps} pumps "
                    f"(queue={len(self.queue)}, in_flight={self.in_flight})"
                )
            results.extend(self.pump())
            pumps += 1
        return results

    def stats(self) -> dict:
        return {
            "clock_rounds": self.clock_rounds,
            "queue_depth": len(self.queue),
            "in_flight": self.in_flight,
            "pending_updates": {
                g: len(q) for g, q in self._pending_updates.items() if q
            },
            "counters": dict(self.counters),
            "rejections": dict(self.rejections),
            "breakers": {
                "/".join(key): {
                    "consecutive": b.consecutive,
                    "open": self.clock_rounds < b.open_until,
                    "open_until": b.open_until,
                }
                for key, b in self._breakers.items()
                if b.consecutive or b.open_until
            },
            "lanes": {
                "/".join(key): {
                    "occupancy": lane.stepper.occupancy,
                    "capacity": lane.stepper.capacity,
                    "delta": lane.stepper.sched.delta,
                    "backend": lane.stepper.backend,
                    "rounds_executed": lane.stepper.rounds_executed,
                    "quanta": lane.stepper.quanta,
                }
                for key, lane in self._lanes.items()
            },
        }
