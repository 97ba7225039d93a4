"""The port's serving tier against the JAX reference's, on the CPU.

The same submit, update and fault sequences go through ``repro``'s
``GraphService`` / ``ContinuousScheduler`` (``backend="jit"``) and the
port's (``device="cpu"``, ``backend="kernel"`` and ``"torch"``; on the CPU
both run the plain loop), on the reference's serving graphs (kron s8 SSSP,
twitter s8 PageRank; P = 4, δ = 32, capacity 4, ``min_chunk=8``):

* every ``QueryResult``, ``QueryFailure`` and ``UpdateResult`` field equal
  (``x`` bit for bit; a plus-times residual within ``rtol=1e-5``, as in
  ``tests/test_torch_batch.py``, since the port sums it in another order
  than XLA, ROADMAP queue C item 2; ``latency_s`` is wall time and
  ``backend`` names each package's own), and the scheduler's counters, rejections, breakers and
  lanes, and the solvers' counters;
* ``poisson_trace`` equal to the reference's, ``save_traces`` /
  ``load_traces`` across both packages, and both load replays' reports equal
  on every field but ``wall_s`` (two two-tenant traces, the parameters of
  ``benchmarks/serve_load.py``);
* the update barrier, lane-fault recovery through ``FaultSpec(site=
  "scheduler.lane")``, deadlines, the ``--assert-warm`` gate, a halo lane
  (which once raised, and now serves), ``degrade=True`` (which once
  raised, and now builds), the refusal without a CUDA device, and that
  ``repro_torch.launch`` imports neither jax nor ``repro``.

The round clock advances by each lane quantum's executed rounds, so equal
clocks across lanes, classes and updates mean every port quantum stopped on
the reference's round.
"""

import copy
import dataclasses
import importlib
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.evolve as j_evolve  # noqa: E402
import repro.launch.service as j_service  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
from repro.launch import serve_graph as j_serve  # noqa: E402
import repro_torch.evolve as t_evolve  # noqa: E402
import repro_torch.launch.service as t_service  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.launch import serve_graph as t_serve  # noqa: E402
from repro_torch.solve import Solver, multi_source_x0, ppr_teleport, solve_batch, sssp_problem  # noqa: E402

# the modules themselves: each package's ``ft`` exports a function named inject
j_inject = importlib.import_module("repro.ft.inject")
t_inject = importlib.import_module("repro_torch.ft.inject")
REPO = Path(__file__).resolve().parents[1]
BACKENDS = ("kernel", "torch")
SERVICE_KW = dict(n_workers=4, delta=32, batch_size=4, min_chunk=8)
KINDS = {"sssp": ("kron", "sssp"), "ppr": ("twitter", "pagerank")}


def _side(gen, service, inject, evolve, serve, kw):
    graphs = {algo: gen.make_graph(name, scale=8, efactor=8, kind=kind) for algo, (name, kind) in KINDS.items()}
    return types.SimpleNamespace(
        graphs=graphs, svc=service, inject=inject, EdgeBatch=evolve.EdgeBatch, GraphService=serve.GraphService, kw=kw
    )


@pytest.fixture(scope="module")
def sides():
    """Each package's serving modules and graphs: the reference (``jit``)
    and the port at each backend."""
    ref = _side(j_gen, j_service, j_inject, j_evolve, j_serve, dict(backend="jit"))
    port = {b: _side(t_gen, t_service, t_inject, t_evolve, t_serve, dict(backend=b, device="cpu")) for b in BACKENDS}
    return {"jit": ref, **port}


def service(side, algo, **kw):
    """A fresh single-algorithm service of ``side``'s package."""
    full = dict(SERVICE_KW, algos=(algo,), **side.kw)
    full.update(kw)
    return side.GraphService(side.graphs[algo], **full)


def tenants(side, **kw):
    """The two tenants of ``benchmarks/serve_load.py``: road (SSSP) and social (PPR)."""
    return {"road": service(side, "sssp", **kw), "social": service(side, "ppr", **kw)}


def delete_ops(g, k=1, seed=0):
    """k existing edges of ``g`` as delete pairs (the reference tests' recipe)."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    pick = rng.choice(g.nnz, size=k, replace=False)
    return [(int(g.indices[e]), int(dst[e])) for e in pick]


# --------------------------------------------------------------------------- #
# comparisons
# --------------------------------------------------------------------------- #
def assert_same_records(want, got, backend):
    """Lists of QueryResult / QueryFailure / UpdateResult / Admission equal
    field by field (``x`` bit for bit, an l1 residual within ``rtol=1e-5``),
    but for wall times and backends."""
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert type(g).__name__ == type(w).__name__
        for f in dataclasses.fields(w):
            wv, gv = getattr(w, f.name), getattr(g, f.name)
            if f.name == "latency_s":
                assert gv >= 0.0
            elif f.name == "backend":
                assert (wv, gv) == ("jit", backend)
            elif f.name == "x":
                wv = np.asarray(wv)
                assert gv.shape == wv.shape and gv.dtype == wv.dtype
                np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32))
            elif f.name == "residual" and w.algo != "sssp":
                # an l1 residual: the port sums it in another order than XLA
                # (ROADMAP queue C, item 2), the bar of tests/test_torch_batch.py
                np.testing.assert_allclose(gv, wv, rtol=1e-5)
            else:
                assert gv == wv, (f.name, w, g)


def assert_same_stats(want, got, backend):
    """``ContinuousScheduler.stats()`` equal, each lane's backend its own."""
    want, got = copy.deepcopy(want), copy.deepcopy(got)
    wl, gl = want.pop("lanes"), got.pop("lanes")
    assert got == want
    assert set(gl) == set(wl)
    for key in wl:
        assert gl[key].pop("backend") == backend and wl[key].pop("backend") == "jit"
        assert gl[key] == wl[key]


def assert_same_solver_stats(want, got):
    """``GraphService.stats()``: the port's counters equal the reference's."""
    assert set(got) == set(want)
    for algo, st_ in got.items():
        assert st_ == {k: want[algo][k] for k in st_}


def by_id(results):
    return sorted(results, key=lambda r: r.request_id)


# --------------------------------------------------------------------------- #
# typed surface and scheduling
# --------------------------------------------------------------------------- #
def _submit_drain(side, algo, payloads, **kw):
    svc = service(side, algo, **kw)
    adms = [svc.submit(side.svc.QueryRequest(algo=algo, payload=int(v))) for v in payloads]
    results = svc.drain()
    return svc, adms, results


@pytest.mark.parametrize("algo,payloads", [("sssp", range(11)), ("ppr", [3, 11, 40, 5, 77, 9, 200])])
def test_results_counters_and_clocks_equal_reference(sides, algo, payloads):
    want_svc, want_adms, want = _submit_drain(sides["jit"], algo, payloads, batch_size=2, queue_capacity=32)
    assert len(want) == len(payloads) and all(r.converged for r in want)
    for b in BACKENDS:
        svc, adms, got = _submit_drain(sides[b], algo, payloads, batch_size=2, queue_capacity=32)
        assert_same_records(want_adms, adms, b)
        assert_same_records(by_id(want), by_id(got), b)
        assert_same_stats(want_svc.scheduler.stats(), svc.scheduler.stats(), b)
        assert_same_solver_stats(want_svc.stats(), svc.stats())


def test_results_equal_a_fresh_one_query_batch(sides):
    svc, _, results = _submit_drain(sides["kernel"], "ppr", [3, 11, 40], batch_size=2)
    g = svc.graph
    for r in results:
        x0 = np.full((1, g.n), 1.0 / g.n, np.float32)
        fresh = solve_batch(svc.solver("ppr"), x0, q=ppr_teleport(g, [r.payload]))
        assert r.converged and r.rounds == fresh.rounds
        np.testing.assert_array_equal(r.x.view(np.int32), fresh.x[0].view(np.int32))


def test_backpressure_and_rejections_equal_reference(sides):
    def run(side):
        svc = service(side, "sssp", batch_size=2, queue_capacity=3)
        Q = side.svc.QueryRequest
        adms = [svc.submit(Q(algo="sssp", payload=v)) for v in range(8)]
        sched = side.svc.ContinuousScheduler({"road": service(side, "sssp")}, queue_capacity=4)
        n = side.graphs["sssp"].n
        adms += [
            sched.submit(Q(algo="sssp", payload=0, graph="nope")),
            sched.submit(Q(algo="ppr", payload=0, graph="road")),
            sched.submit(Q(algo="sssp", payload=0, graph="road", request_class="vip")),
            sched.submit(Q(algo="sssp", payload=n, graph="road")),
        ]
        return adms, svc.drain(), svc.scheduler.stats(), sched.stats()

    want = run(sides["jit"])
    assert [a.reason for a in want[0][3:]] == ["queue_full"] * 5 + [
        "unknown_graph", "unsupported_algo", "unknown_class", "payload_out_of_range",
    ]
    for b in BACKENDS:
        got = run(sides[b])
        assert_same_records(want[0], got[0], b)
        assert_same_records(by_id(want[1]), by_id(got[1]), b)
        assert_same_stats(want[2], got[2], b)
        assert_same_stats(want[3], got[3], b)


@pytest.mark.parametrize("backend", BACKENDS)
def test_two_tenants_class_routing_equal_reference(sides, backend):
    def run(side):
        P = side.svc.ClassPolicy
        classes = {"cheap": P(name="cheap", slot_rounds=2, delta=16), "deep": P(name="deep", slot_rounds=8, delta=64)}
        sched = side.svc.ContinuousScheduler(tenants(side, classes=classes), classes=classes, queue_capacity=8)
        Q = side.svc.QueryRequest
        adms = []
        for v in (1, 5, 9):
            adms.append(sched.submit(Q(algo="sssp", payload=v, graph="road")))
            adms.append(sched.submit(Q(algo="ppr", payload=v, graph="social")))
        return adms, sched.drain(), sched.stats()

    want = run(sides["jit"])
    got = run(sides[backend])
    assert {(r.algo, r.request_class, r.delta) for r in got[1]} == {("sssp", "deep", 64), ("ppr", "cheap", 16)}
    assert_same_records(want[0], got[0], backend)
    assert_same_records(by_id(want[1]), by_id(got[1]), backend)
    assert_same_stats(want[2], got[2], backend)
    assert set(got[2]["lanes"]) == {"road/sssp/deep", "social/ppr/cheap"}


def test_per_graph_quota_spans_queries_and_updates(sides):
    def run(side):
        svc = service(side, "sssp", queue_capacity=64, per_graph_quota=3)
        g = svc.graph
        v = int(np.argmax(g.out_degree))
        Q, U = side.svc.QueryRequest, side.svc.UpdateRequest
        adms = [svc.submit(Q(algo="sssp", payload=v)) for _ in range(5)]
        adms.append(svc.submit_update(U(batch=side.EdgeBatch.from_ops(deletes=delete_ops(g)))))
        results = svc.drain()
        adms.append(svc.submit_update(U(batch=side.EdgeBatch.from_ops(deletes=delete_ops(g)))))
        results += svc.drain()
        return adms, results, svc.take_update_results(), svc.scheduler.stats()

    want = run(sides["jit"])
    assert [a.accepted for a in want[0]] == [True] * 3 + [False] * 3 + [True]
    for b in BACKENDS:
        got = run(sides[b])
        for i in range(3):
            assert_same_records(want[i], got[i], b)
        assert_same_stats(want[3], got[3], b)


def test_deprecated_sugar_equals_reference(sides):
    def run(side):
        svc = service(side, "sssp", batch_size=2, queue_capacity=2)
        with pytest.warns(DeprecationWarning, match="deprecated"):
            return svc.sssp([0, 5, 9, 33, 7])

    want = run(sides["jit"])
    for b in BACKENDS:
        got = run(sides[b])
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# the update barrier: BatchStepper across an update
# --------------------------------------------------------------------------- #
def _update_idle(side):
    svc = service(side, "sssp")
    g = svc.graph
    v = int(np.argmax(g.out_degree))
    adm = svc.submit_update(side.svc.UpdateRequest(batch=side.EdgeBatch.from_ops(deletes=delete_ops(g))))
    idle_before = svc.scheduler.idle
    svc.submit(side.svc.QueryRequest(algo="sssp", payload=v))
    results = svc.drain()
    return [adm], results, svc.take_update_results(), svc.scheduler.stats(), idle_before, svc


def _update_in_flight(side):
    # 2-round quanta keep the first query in flight across several pumps
    svc = service(side, "sssp", compact_every=2)
    g = svc.graph
    v = int(np.argmax(g.out_degree))
    Q = side.svc.QueryRequest
    adms = [svc.submit(Q(algo="sssp", payload=v))]
    early = svc.pump()
    in_flight = svc.scheduler.in_flight
    adms.append(svc.submit_update(side.svc.UpdateRequest(batch=side.EdgeBatch.from_ops(deletes=delete_ops(g)))))
    adms.append(svc.submit(Q(algo="sssp", payload=v)))
    adms.append(svc.submit(Q(algo="sssp", payload=3)))
    results = early + svc.drain()
    return adms, results, svc.take_update_results(), svc.scheduler.stats(), in_flight, svc


def _updates_fifo(side):
    svc = service(side, "sssp")
    g = svc.graph
    b1 = delete_ops(g, k=1, seed=0)
    g2, _ = g.apply_updates(side.EdgeBatch.from_ops(deletes=b1))
    b2 = delete_ops(g2, k=2, seed=1)
    U = side.svc.UpdateRequest
    adms = [svc.submit_update(U(batch=side.EdgeBatch.from_ops(deletes=b))) for b in (b1, b2)]
    adms.append(svc.submit(side.svc.QueryRequest(algo="sssp", payload=7)))
    results = svc.drain()
    return adms, results, svc.take_update_results(), svc.scheduler.stats(), svc.graph.nnz, svc


@pytest.mark.parametrize("scenario", [_update_idle, _update_in_flight, _updates_fifo])
def test_update_barrier_equals_reference(sides, scenario):
    want = scenario(sides["jit"])
    assert want[2] and all(u.applied_clock >= u.submitted_clock for u in want[2])
    for b in BACKENDS:
        got = scenario(sides[b])
        for i in range(3):
            assert_same_records(want[i] if i != 1 else by_id(want[i]), got[i] if i != 1 else by_id(got[i]), b)
        assert_same_stats(want[3], got[3], b)
        assert got[4] == want[4]
        assert_same_solver_stats(want[5].stats(), got[5].stats())


def test_in_flight_query_retires_on_the_old_graph_and_the_next_on_the_new(sides):
    """A lane rebuilt after the update sees the patched schedule and the new
    graph: the query submitted after the update equals a fresh solve on the
    mutated graph, the one in flight a fresh solve on the old one."""
    adms, results, (ur,), _, in_flight, svc = _update_in_flight(sides["kernel"])
    assert in_flight == 1
    got = {r.request_id: r for r in results}
    sv = svc.solver("sssp")
    g_old = sides["kernel"].graphs["sssp"]
    g_new = svc.graph
    assert g_new.nnz == g_old.nnz - 1 and sv.graph is g_new
    kw = dict(n_workers=4, delta=32, min_chunk=8, device="cpu")
    for adm, g in ((adms[0], g_old), (adms[2], g_new)):
        r = got[adm.request_id]
        fresh = solve_batch(Solver(g, sssp_problem(), **kw), multi_source_x0(g, [r.payload]))
        assert r.rounds == fresh.rounds
        np.testing.assert_array_equal(r.x, fresh.x[0])
    # the barrier: the update waited for the in-flight query to retire
    assert ur.applied_clock >= got[adms[0].request_id].finished_clock and ur.barrier_rounds > 0
    assert got[adms[2].request_id].admitted_clock >= ur.applied_clock
    # the mutated solver's patched schedule is a fresh build's
    fresh_sched = Solver(g_new, sssp_problem(), **kw).schedule(32)
    for name in ("src", "val", "dst_local", "row_ptr"):
        assert torch.equal(getattr(sv.schedule(32), name), getattr(fresh_sched, name)), name


def test_update_rejection_reasons_equal_reference(sides):
    def run(side):
        svc = service(side, "sssp")
        g = svc.graph
        U = side.svc.UpdateRequest
        return [
            svc.submit_update(U(batch=side.EdgeBatch.from_ops(deletes=delete_ops(g)), graph="nope")),
            svc.submit_update(U(batch=side.EdgeBatch.from_ops(deletes=[(0, g.n + 3)]))),
        ], svc.scheduler.stats()

    want = run(sides["jit"])
    assert [a.reason for a in want[0]] == ["unknown_graph", "payload_out_of_range"]
    for b in BACKENDS:
        got = run(sides[b])
        assert_same_records(want[0], got[0], b)
        assert_same_stats(want[1], got[1], b)


# --------------------------------------------------------------------------- #
# lane faults, breakers and deadlines (tests/test_chaos.py::TestSchedulerFaults)
# --------------------------------------------------------------------------- #
def _faulted(side, specs, payloads, classes=None, deadline=None, extra=None):
    """Submit ``payloads`` under a fault plan of ``specs`` and drain."""
    kw = {"queue_capacity": 16}
    if classes is not None:
        kw["classes"] = classes(side)
    svc = service(side, "sssp", **kw)
    Q = side.svc.QueryRequest
    plan = side.inject.FaultPlan([side.inject.FaultSpec(**s) for s in specs])
    with side.inject.inject(plan):
        adms = [svc.submit(Q(algo="sssp", payload=v)) for v in payloads]
        if deadline is not None:
            adms.append(svc.submit(Q(algo="sssp", payload=9, deadline_rounds=deadline)))
        if extra is not None:
            adms.append(svc.submit(Q(algo="sssp", payload=0, request_class=extra)))
        results = svc.drain()
    return adms, results, svc.take_failures(), svc.scheduler.stats(), plan.events


def _breaker_classes(side):
    return {
        "deep": side.svc.ClassPolicy(
            name="deep", slot_rounds=8, max_retries=1, breaker_threshold=2, breaker_cooldown_rounds=10_000
        )
    }


def _two_classes(side):
    P = side.svc.ClassPolicy
    return {"cheap": P(name="cheap", slot_rounds=2), "deep": P(name="deep", slot_rounds=8)}


FAULT_CASES = {
    "retry_then_deliver": dict(specs=[dict(site="scheduler.lane", at=0, times=1)], payloads=range(6)),
    "poisoned_lane": dict(specs=[dict(site="scheduler.lane", at=0, times=-1)], payloads=range(4)),
    "poisoned_neighbour": dict(
        specs=[dict(site="scheduler.lane", at=0, times=-1, match={"request_class": "cheap"})],
        payloads=[1, 2, 3], classes=_two_classes, extra="cheap",
    ),
    "breaker": dict(specs=[dict(site="scheduler.lane", at=0, times=2)], payloads=[5], classes=_breaker_classes),
    "deadline_exceeded": dict(specs=[], payloads=range(4), deadline=1),
    "deadline_met": dict(specs=[], payloads=range(4), deadline=10_000),
}


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_lane_faults_and_deadlines_equal_reference(sides, case):
    want = _faulted(sides["jit"], **FAULT_CASES[case])
    for b in BACKENDS:
        got = _faulted(sides[b], **FAULT_CASES[case])
        assert_same_records(want[0], got[0], b)
        assert_same_records(by_id(want[1]), by_id(got[1]), b)
        assert_same_records(by_id(want[2]), by_id(got[2]), b)
        assert_same_stats(want[3], got[3], b)
        assert got[4] == want[4]  # the chaos trace
    c = got[3]["counters"]
    assert c["accepted"] == c["completed"] + c["failed"]
    if case == "retry_then_deliver":
        clean = {r.payload: r.x for r in _submit_drain(sides["kernel"], "sssp", range(6))[2]}
        assert c["lane_faults"] == 1 and c["retries"] >= 1 and c["failed"] == 0
        for r in got[1]:
            np.testing.assert_array_equal(r.x, clean[r.payload])
    if case == "poisoned_lane":
        assert got[1] == [] and {(f.reason, f.attempts) for f in got[2]} == {("retries_exhausted", 3)}
    if case == "poisoned_neighbour":
        assert len(got[1]) == 3 and [f.request_id for f in got[2]] == [got[0][-1].request_id]


def test_breaker_opens_then_cools_equal_reference(sides):
    def run(side):
        svc = service(side, "sssp", classes=_breaker_classes(side), queue_capacity=16)
        Q = side.svc.QueryRequest
        plan = side.inject.FaultPlan([side.inject.FaultSpec(site="scheduler.lane", at=0, times=2)])
        with side.inject.inject(plan):
            adms = [svc.submit(Q(algo="sssp", payload=5))]
            svc.drain()
        failures = svc.take_failures()
        adms.append(svc.submit(Q(algo="sssp", payload=6)))  # rejected: the breaker is open
        stats_open = svc.scheduler.stats()
        svc.scheduler.advance_clock(stats_open["breakers"]["default/sssp/deep"]["open_until"])
        adms.append(svc.submit(Q(algo="sssp", payload=6)))
        results = svc.drain()
        return adms, results, failures, stats_open, svc.scheduler.stats()

    want = run(sides["jit"])
    assert want[0][1].reason == "lane_open" and want[3]["breakers"]["default/sssp/deep"]["open"]
    for b in BACKENDS:
        got = run(sides[b])
        for i in range(3):
            assert_same_records(want[i], got[i], b)
        assert_same_stats(want[3], got[3], b)
        assert_same_stats(want[4], got[4], b)
        assert not got[4]["breakers"]["default/sssp/deep"]["open"]


# --------------------------------------------------------------------------- #
# load generation and replays
# --------------------------------------------------------------------------- #
GRAPH_FOR = {"sssp": ("road",), "ppr": ("social",)}


@pytest.mark.parametrize(
    "args,kw",
    [
        ((0.2, 100, 256), dict(seed=3, graph_for=GRAPH_FOR)),
        ((0.12, 400, {"road": 256, "social": 256}), dict(seed=7, graph_for=GRAPH_FOR)),
        ((0.3, 50, 256), dict(seed=1)),
        ((0.15, 80, 256), dict(seed=5, graph_for={"sssp": ("default",)}, mix=(("sssp", 1),))),
    ],
)
def test_poisson_trace_equals_reference(args, kw):
    want = j_service.poisson_trace(*args, **kw)
    got = t_service.poisson_trace(*args, **kw)
    assert got.to_dict() == want.to_dict() and len(got.events) > 0
    assert got == t_service.poisson_trace(*args, **kw)


def test_traces_round_trip_across_packages(tmp_path):
    traces = [t_service.poisson_trace(r, 60, 256, seed=2, graph_for=GRAPH_FOR) for r in (0.1, 0.3)]
    path = t_service.save_traces(tmp_path / "sub" / "t.json", traces)
    assert t_service.load_traces(path) == traces
    assert [t.to_dict() for t in j_service.load_traces(path)] == [t.to_dict() for t in traces]
    j_path = j_service.save_traces(tmp_path / "j.json", j_service.load_traces(path))
    assert path.read_text() == j_path.read_text()
    assert t_service.summarize([], clock_rounds=0, wall_s=0.0) == j_service.summarize([], clock_rounds=0, wall_s=0.0)


REPLAY_RATES = (0.05, 0.12)


@pytest.fixture(scope="module")
def replay(sides):
    """Both replays of the seed-7 two-tenant trace, by package and rate,
    each run once for the module."""
    done = {}

    def run(pkg, rate):
        if (pkg, rate) not in done:
            side = sides[pkg]
            n = {t: side.graphs[a].n for t, a in (("road", "sssp"), ("social", "ppr"))}
            trace = side.svc.poisson_trace(rate, 400, n, seed=7, graph_for=GRAPH_FOR)
            sched = side.svc.ContinuousScheduler(tenants(side), queue_capacity=16)
            cont = side.svc.replay_continuous(sched, trace)
            fixed = side.svc.replay_fixed(tenants(side), trace, batch_size=4, queue_capacity=16)
            done[(pkg, rate)] = (trace, cont, fixed, sched.stats())
        return done[(pkg, rate)]

    return run


def _report(rep):
    rep = dict(rep)
    assert rep.pop("wall_s") >= 0.0
    return rep


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("rate", REPLAY_RATES)
def test_replays_equal_reference(replay, rate, backend):
    trace, cont, fixed, stats = replay("jit", rate)
    t_trace, t_cont, t_fixed, t_stats = replay(backend, rate)
    assert t_trace.to_dict() == trace.to_dict()
    assert _report(t_cont["report"]) == _report(cont["report"])
    assert _report(t_fixed["report"]) == _report(fixed["report"])
    assert t_cont["arrival"] == cont["arrival"]
    assert_same_records(by_id(cont["results"]), by_id(t_cont["results"]), backend)
    assert_same_stats(stats, t_stats, backend)
    rep = t_cont["report"]
    assert rep["completed"] + rep["rejected"] == rep["offered"] > 0 and rep["unconverged"] == 0


@pytest.fixture(scope="module")
def warm_tenants(sides):
    """Tenants whose solvers (and the reference's compiled lanes) stay warm
    across the property's examples; each example has a scheduler of its own."""
    return {pkg: tenants(sides[pkg]) for pkg in ("jit", "kernel")}


@settings(max_examples=6, deadline=None, derandomize=True, database=None)
@given(
    st.lists(
        st.tuples(
            st.sampled_from(["sssp", "ppr", "rwr"]),
            st.integers(-1, 260),
            st.sampled_from(["auto", "cheap", "deep", "vip"]),
            st.sampled_from(["road", "social", "nope"]),
            st.integers(0, 6),
        ),
        min_size=1,
        max_size=10,
    )
)
def test_submit_sequences_equal_reference(sides, warm_tenants, ops):
    """Random submit sequences, pumped now and then: the same admissions,
    results, failures and stats as the reference, over warm tenants."""
    outs = {}
    for pkg in ("jit", "kernel"):
        side = sides[pkg]
        sched = side.svc.ContinuousScheduler(warm_tenants[pkg], queue_capacity=6, per_graph_quota=5)
        adms, results = [], []
        for algo, payload, cls, graph, deadline in ops:
            req = side.svc.QueryRequest(
                algo=algo, payload=payload, request_class=cls, graph=graph,
                deadline_rounds=None if deadline == 0 else deadline,
            )
            adms.append(sched.submit(req))
            if payload % 3 == 0:
                results += sched.pump()
        results += sched.drain()
        outs[pkg] = (adms, by_id(results), by_id(sched.take_failures()), sched.stats())
    want, got = outs["jit"], outs["kernel"]
    for i in range(3):
        assert_same_records(want[i], got[i], "kernel")
    assert_same_stats(want[3], got[3], "kernel")


# --------------------------------------------------------------------------- #
# the CLI, its warm-restart gate, and the refusals
# --------------------------------------------------------------------------- #
def test_assert_warm_gate(tmp_path):
    args = ["--graph", "twitter", "--scale", "8", "--algo", "both", "--queries", "4", "--repeats", "2",
            "--delta", "32", "--min-chunk", "8", "--workers", "4", "--device", "cpu"]
    with pytest.raises(SystemExit, match="cold work performed"):
        t_serve.main(args + ["--cache-dir", str(tmp_path / "empty"), "--assert-warm"])
    cold = t_serve.main(args + ["--cache-dir", str(tmp_path / "store")])
    assert cold["stats"]["sssp"]["schedule_builds"] == 1 and cold["stats"]["ppr"]["stripe_builds"] == 4
    warm = t_serve.main(args + ["--cache-dir", str(tmp_path / "store"), "--assert-warm"])
    for algo, stats in warm["stats"].items():
        assert all(stats[k] == 0 for k in t_serve.WARM_GATE_COUNTERS), (algo, stats)
        assert stats["cache_loads"] >= 1 and stats["solves"] == 8


@pytest.mark.parametrize("backend,exc", [("torch", NotImplementedError), ("kernel", ValueError)])
def test_halo_lane_raises_out_of_pump(sides, backend, exc):
    """A halo lane once raised ``exc`` out of :meth:`pump`; the batched halo
    solve is ported, so it now serves: nothing raised, no lane fault, and
    the answer the reference's ``jit`` lane gives (tests/test_torch_halo_batch.py
    holds the halo lanes in full)."""
    svc = service(sides[backend], "sssp", frontier="halo", n_shards=2)
    assert svc.submit(t_service.QueryRequest(algo="sssp", payload=0)).accepted
    got = svc.drain()
    ref_svc = service(sides["jit"], "sssp")
    assert ref_svc.submit(j_service.QueryRequest(algo="sssp", payload=0)).accepted
    want = ref_svc.drain()
    assert issubclass(exc, Exception) and len(got) == len(want) == 1
    assert_same_records(want, got, backend)
    c = svc.scheduler.counters
    assert (c["lane_faults"], c["failed"], c["retries"]) == (0, 0, 0)


def test_not_implemented_inside_a_quantum_is_not_a_lane_fault(sides, monkeypatch):
    svc = service(sides["kernel"], "sssp")
    assert svc.submit(t_service.QueryRequest(algo="sssp", payload=0)).accepted

    def missing(self, quantum):
        raise NotImplementedError("a path the port does not have")

    monkeypatch.setattr(t_service.scheduler.BatchStepper, "run", missing)
    with pytest.raises(NotImplementedError, match="does not have"):
        svc.pump()
    assert svc.scheduler.counters["lane_faults"] == 0


def test_degrade_and_missing_card_refused(sides, monkeypatch):
    """``degrade=True`` builds and each solver carries it (it once raised:
    the ladder is tests/test_torch_chaos.py's); no card and no ``device``
    is refused."""
    g = sides["kernel"].graphs["sssp"]
    svc = t_serve.GraphService(g, degrade=True, device="cpu", algos=("sssp", "ppr"))
    assert svc.degrade and all(svc.solver(a).degrade for a in ("sssp", "ppr"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.GraphService(g)
    assert t_serve.GraphService(g, device="cpu").backend == "kernel"


def test_launch_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch.launch.serve_graph\n"
        "import repro_torch.launch as L\n"
        "from repro_torch.launch.service import ContinuousScheduler, replay_fixed\n"
        "assert L.GraphService is repro_torch.launch.serve_graph.GraphService\n"
        "assert L.ContinuousScheduler is ContinuousScheduler\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_launch_lazy_names():
    import repro_torch.launch as launch

    assert launch.QueryRequest is t_service.QueryRequest
    with pytest.raises(AttributeError, match="no attribute"):
        launch.train  # noqa: B018 — the LM launchers are not ported
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert launch.GraphService is t_serve.GraphService
