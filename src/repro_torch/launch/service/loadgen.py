"""Open-loop Poisson load generation and deterministic trace replay.

The port of ``repro.launch.service.loadgen``: the same seeded traces and
reports, with :func:`replay_fixed` over the port's
:func:`~repro_torch.solve.batch.solve_batch`.

*Open loop* means arrival times are fixed in advance (a Poisson process at
the offered rate), independent of how the service keeps up — the honest way
to measure a serving tier, since closed-loop generators self-throttle and
hide saturation.  Time is the scheduler's round clock: one unit = one engine
round executed on the device, so a replay is **bit-deterministic** for a
given trace — queue waits, retirement order, rejections, and latency
percentiles can be committed as CI baselines (wall-clock fields ride along
under ``*_s`` names, which the regression guard skips).

Two replay disciplines give the continuous-batching comparison:

* :func:`replay_continuous` — drives a
  :class:`~repro_torch.launch.service.scheduler.ContinuousScheduler`: arrivals
  slot into in-flight batches at quantum boundaries and leave when *they*
  converge.
* :func:`replay_fixed` — the pre-serving-tier discipline: arrivals wait for
  a full fixed-shape padded batch, which runs to *collective* convergence
  before anyone is answered or admitted (one fused ``solve_batch`` call,
  exactly what ``GraphService.sssp()/.ppr()`` did before this tier).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from collections import deque
from pathlib import Path

import numpy as np

from repro_torch.launch.service.types import QueryRequest
from repro_torch.solve.batch import solve_batch
from repro_torch.solve.problem import multi_source_x0, ppr_teleport

__all__ = [
    "Trace",
    "TraceEvent",
    "load_traces",
    "poisson_trace",
    "replay_continuous",
    "replay_fixed",
    "save_traces",
    "summarize",
]


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival: at round-clock ``t``, a query for ``algo`` on ``graph``."""

    t: float
    algo: str
    payload: int
    request_class: str = "auto"
    graph: str = "default"


@dataclasses.dataclass(frozen=True)
class Trace:
    """A reproducible arrival sequence at one offered load."""

    rate: float  # offered load, queries per round
    duration: float  # arrival window, rounds
    seed: int
    events: tuple[TraceEvent, ...]

    def to_dict(self) -> dict:
        return {
            "rate": self.rate,
            "duration": self.duration,
            "seed": self.seed,
            "events": [dataclasses.asdict(e) for e in self.events],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        return cls(
            rate=d["rate"],
            duration=d["duration"],
            seed=d["seed"],
            events=tuple(TraceEvent(**e) for e in d["events"]),
        )


def poisson_trace(
    rate: float,
    duration: float,
    n_vertices,
    *,
    seed: int = 0,
    mix=(("ppr", 0.75), ("sssp", 0.25)),
    graphs=("default",),
    graph_for: dict | None = None,
) -> Trace:
    """Open-loop Poisson arrivals: exp(1/rate) gaps over ``duration`` rounds.

    ``mix`` weights the algorithm of each arrival; each arrival then draws
    its tenant uniformly (seeded) from ``graph_for[algo]`` if given, else
    from ``graphs`` — ``graph_for`` routes algos to the tenants that serve
    them (SSSP needs length-valued edges, PPR needs pagerank-valued ones).
    ``n_vertices`` is an int (shared by all tenants) or a ``{tenant: n}``
    mapping; payload vertices are drawn uniformly per tenant.  Same seed →
    identical trace, always.
    """
    rng = np.random.default_rng(seed)
    algos = [a for a, _ in mix]
    weights = np.asarray([w for _, w in mix], np.float64)
    weights = weights / weights.sum()
    all_graphs = tuple(graphs)
    if graph_for:
        all_graphs = tuple(dict.fromkeys(g for gs in graph_for.values() for g in gs))
    if not isinstance(n_vertices, dict):
        n_vertices = {g: int(n_vertices) for g in all_graphs}
    events = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t > duration:
            break
        algo = algos[int(rng.choice(len(algos), p=weights))]
        pool = tuple(graph_for[algo]) if graph_for else tuple(graphs)
        graph = pool[int(rng.integers(len(pool)))]
        payload = int(rng.integers(n_vertices[graph]))
        events.append(TraceEvent(t=float(t), algo=algo, payload=payload, graph=graph))
    return Trace(rate=rate, duration=duration, seed=seed, events=tuple(events))


def save_traces(path, traces: list[Trace]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        json.dumps({"version": 1, "traces": [t.to_dict() for t in traces]}, indent=1)
    )
    return path


def load_traces(path) -> list[Trace]:
    d = json.loads(Path(path).read_text())
    return [Trace.from_dict(t) for t in d["traces"]]


def summarize(latencies_rounds, *, clock_rounds: int, wall_s: float) -> dict:
    """Aggregate one replay's per-request latencies (round-clock units)."""
    lat = np.asarray(latencies_rounds, np.float64)
    if lat.size == 0:
        p50 = p99 = mean = worst = 0.0
    else:
        p50 = float(np.percentile(lat, 50))
        p99 = float(np.percentile(lat, 99))
        mean = float(lat.mean())
        worst = float(lat.max())
    return {
        "completed": int(lat.size),
        "clock_rounds": int(clock_rounds),
        "p50_rounds": round(p50, 3),
        "p99_rounds": round(p99, 3),
        "mean_rounds": round(mean, 3),
        "worst_rounds": round(worst, 3),
        # queries per 1000 rounds of device work — the deterministic
        # throughput number (wall-clock throughput is runner-dependent)
        "completed_per_kround": (
            round(lat.size / clock_rounds * 1000, 3) if clock_rounds else 0.0
        ),
        "wall_s": wall_s,  # skipped by the regression guard, by name
    }


def replay_continuous(scheduler, trace: Trace) -> dict:
    """Drive ``scheduler`` through ``trace`` in open loop; report the replay.

    Arrivals are submitted the moment the round clock passes their ``t``
    (rejections — queue full — happen then, deterministically); the
    scheduler pumps whenever work is pending, and the clock fast-forwards
    across idle gaps.  Latency of a request = retirement clock − arrival
    ``t``.

    ``scheduler`` may be a
    :class:`~repro_torch.launch.serve_graph.GraphService`, which has the
    scheduler's ``submit``, ``pump``, ``advance_clock``, ``idle`` and
    ``clock_rounds``.  Across processes, pass the ``GraphService(group=...)``
    on every rank with the same trace: rank 0 submits, every rank syncs
    before it reads ``idle`` and pumps, and every rank returns the same
    report and results.
    """
    from repro_torch.launch.serve_graph import GraphService  # serve_graph imports this package

    group = getattr(scheduler, "group", None)
    if group is not None and not isinstance(scheduler, GraphService):
        raise ValueError("across a group, replay through the GraphService(group=...), not its scheduler")
    front = group is None or group.rank == 0

    def idle() -> bool:
        if group is not None:
            scheduler.sync()  # collective: rank 0's requests reach every rank first
        return scheduler.idle

    events = sorted(trace.events, key=lambda e: e.t)
    arrival: dict[str, float] = {}
    results = []
    rejected: dict[str, int] = {}
    i = 0
    wall0 = time.perf_counter()
    while i < len(events) or not idle():
        while i < len(events) and events[i].t <= scheduler.clock_rounds:
            ev = events[i]
            i += 1
            if not front:  # rank 0's requests reach this rank at its next pump
                continue
            adm = scheduler.submit(
                QueryRequest(
                    algo=ev.algo,
                    payload=ev.payload,
                    request_class=ev.request_class,
                    graph=ev.graph,
                )
            )
            if adm.accepted:
                arrival[adm.request_id] = ev.t
            else:
                rejected[adm.reason] = rejected.get(adm.reason, 0) + 1
        if idle():
            if i < len(events):  # idle gap: fast-forward to the next arrival
                scheduler.advance_clock(math.ceil(events[i].t))
            continue
        results.extend(scheduler.pump())
    wall_s = time.perf_counter() - wall0
    if group is not None:
        arrival, rejected = group.broadcast_object((arrival, rejected))
    latencies = [r.finished_clock - arrival[r.request_id] for r in results]
    report = summarize(latencies, clock_rounds=scheduler.clock_rounds, wall_s=wall_s)
    report["offered"] = len(events)
    report["rejected"] = int(sum(rejected.values()))
    report["rejected_by_reason"] = dict(sorted(rejected.items()))
    report["unconverged"] = int(sum(not r.converged for r in results))
    return {"report": report, "results": results, "arrival": arrival}


def replay_fixed(
    services,
    trace: Trace,
    *,
    batch_size: int,
    queue_capacity: int = 64,
) -> dict:
    """The fixed-batch counterfactual: same trace, pre-serving-tier rules.

    Arrivals queue (bounded, same capacity as the scheduler's) until the
    device is free, then the head-of-queue's ``(graph, algo)`` group is
    padded to the fixed batch shape and solved with one fused
    ``solve_batch`` call; **nobody** in the batch is answered — and nobody
    new is admitted to the device — until the whole batch converges.  Clock
    advances by the fused loop's round count (max over the batch).
    """
    if not isinstance(services, dict):
        services = {"default": services}
    events = sorted(trace.events, key=lambda e: e.t)
    queue: deque[TraceEvent] = deque()
    latencies: list[float] = []
    rejected: dict[str, int] = {}
    clock = 0
    i = 0
    wall0 = time.perf_counter()
    while i < len(events) or queue:
        while i < len(events) and events[i].t <= clock:
            ev = events[i]
            i += 1
            if len(queue) >= queue_capacity:
                rejected["queue_full"] = rejected.get("queue_full", 0) + 1
            else:
                queue.append(ev)
        if not queue:
            clock = max(clock, math.ceil(events[i].t))
            continue
        head = queue[0]
        taken: list[TraceEvent] = []
        kept: deque[TraceEvent] = deque()
        while queue:
            ev = queue.popleft()
            same = ev.graph == head.graph and ev.algo == head.algo
            if same and len(taken) < batch_size:
                taken.append(ev)
            else:
                kept.append(ev)
        queue = kept
        service = services[head.graph]
        solver = service.solver(head.algo)
        g = service.graph
        payloads = [ev.payload for ev in taken]
        pad = payloads + [payloads[-1]] * (batch_size - len(payloads))
        if head.algo == "sssp":
            res = solve_batch(solver, multi_source_x0(g, pad))
        else:
            x0 = np.full((batch_size, g.n), 1.0 / g.n, np.float32)
            res = solve_batch(solver, x0, q=ppr_teleport(g, pad, service.damping))
        clock += res.rounds
        latencies.extend(clock - ev.t for ev in taken)
    wall_s = time.perf_counter() - wall0
    report = summarize(latencies, clock_rounds=clock, wall_s=wall_s)
    report["offered"] = len(events)
    report["rejected"] = int(sum(rejected.values()))
    report["rejected_by_reason"] = dict(sorted(rejected.items()))
    report["unconverged"] = 0
    return {"report": report}
