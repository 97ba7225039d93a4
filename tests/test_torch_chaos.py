"""The port's degradation ladder and its kernel faults against the reference.

The reference's ``TestDegradationLadder`` (``tests/test_chaos.py``) on the
port, on the reference's test graph (kron s8 SSSP; twitter s8 PageRank;
P = 4, δ = 32, ``device="cpu"``):

* the ladder drops the halo frontier first, then steps ``kernel`` →
  ``torch``; mapped onto the reference's names (``kernel`` ↔ ``pallas``,
  ``torch`` ↔ ``jit``), it is the reference's ladder without its ``host``
  rung, and a degraded solve's :class:`Degradation` record equals the
  reference's field by field, but for the backends' names;
* a degraded solve (the chaos trace's ``degrade_faults`` plan, matched on
  ``backend="kernel"``) records one ``Degradation`` and returns the
  fault-free answer bit for bit (on the CPU both rungs run the plain round),
  and ``repro``'s; ``degrade=False`` raises; an exhausted ladder re-raises;
  caller errors, ``NotImplementedError``, a kernel's launch error, an
  out-of-memory error and a failed kernel build are never degraded (the
  ladder answers injected dispatch faults alone); a degraded solve logs no
  observation; a grouped solver refuses ``degrade=True``;
* ``BatchStepper.run`` fires ``kernel.dispatch`` before it changes any
  state, and the scheduler evicts and retries the lane's riders: every
  answer delivered, equal to a fault-free service's and to the reference's
  under the same plan (also the trace's ``serving_faults`` plan, with a
  store under ``cache_dir``).
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ft import degrade as j_degrade  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
from repro.launch import serve_graph as j_serve  # noqa: E402
import repro.launch.service as j_service  # noqa: E402
import repro.solve as j_solve  # noqa: E402
from repro_torch.ft import degrade as t_degrade  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.launch import serve_graph as t_serve  # noqa: E402
import repro_torch.launch.service as t_service  # noqa: E402
import repro_torch.solve as t_solve  # noqa: E402
from repro_torch.kernels import build as t_build  # noqa: E402

# the modules themselves: each package's ``ft`` exports a function named inject
j_inject = importlib.import_module("repro.ft.inject")
t_inject = importlib.import_module("repro_torch.ft.inject")
KW = dict(n_workers=4, delta=32, min_chunk=8)
NAMES = {"kernel": "pallas", "torch": "jit"}  # the port's backends by the reference's names
# benchmarks/traces/chaos_smoke.json's degrade_faults plan, on the port's backend
DEGRADE_FAULTS = {"seed": 0, "specs": [{"site": "kernel.dispatch", "match": {"backend": "kernel"}, "times": 1}]}
# ... and its serving_faults plan, as it stands
SERVING_FAULTS = {
    "seed": 0,
    "specs": [
        {"site": "scheduler.lane", "at": 1, "times": 2},
        {"site": "kernel.dispatch", "at": 5, "times": 1},
        {"site": "persist.write", "kind": "torn", "at": 2, "times": 2},
        {"site": "persist.write", "kind": "corrupt", "at": 9, "times": 1},
        {"site": "persist.write", "kind": "eio", "at": 14, "times": 1},
        {"site": "persist.read", "kind": "eio", "at": 0, "times": 1},
    ],
}
GRAPHS = {"sssp": ("kron", "sssp"), "pagerank": ("twitter", "pagerank")}


@pytest.fixture(scope="module")
def graphs():
    return {
        name: (j_gen.make_graph(g, scale=8, efactor=8, kind=k), t_gen.make_graph(g, scale=8, efactor=8, kind=k))
        for name, (g, k) in GRAPHS.items()
    }


def t_solver(graphs, name, **kw):
    return t_solve.Solver(graphs[name][1], getattr(t_solve, f"{name}_problem")(), device="cpu", **KW, **kw)


def t_plan(d):
    return t_inject.FaultPlan.from_json(d)


def test_ladder_orders():
    assert t_degrade.degradation_ladder("kernel", "halo") == [
        ("kernel", "halo"),
        ("kernel", "replicated"),
        ("torch", "replicated"),
    ]
    assert t_degrade.degradation_ladder("kernel", "replicated") == [("kernel", "replicated"), ("torch", "replicated")]
    assert t_degrade.degradation_ladder("torch", "replicated") == [("torch", "replicated")]
    assert t_degrade.degradation_ladder("torch", "halo") == [("torch", "halo"), ("torch", "replicated")]
    assert t_degrade.BACKEND_LADDER["torch"] is None  # the ladder has a floor
    with pytest.raises(ValueError, match="unknown backend"):
        t_degrade.degradation_ladder("host", "replicated")


@pytest.mark.parametrize("frontier", ["replicated", "halo"])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_ladder_is_the_references_without_its_host_rung(backend, frontier):
    want = [(b, f) for b, f in j_degrade.degradation_ladder(NAMES[backend], frontier) if b != "host"]
    got = [(NAMES[b], f) for b, f in t_degrade.degradation_ladder(backend, frontier)]
    assert got == want
    assert [f.name for f in dataclasses.fields(t_degrade.Degradation)] == [
        f.name for f in dataclasses.fields(j_degrade.Degradation)
    ]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_degraded_solve_bit_identical(graphs, name):
    ref = t_solver(graphs, name).solve(backend="kernel")
    jref = j_solve.Solver(graphs[name][0], getattr(j_solve, f"{name}_problem")(), **KW).solve(backend="jit")
    solver = t_solver(graphs, name, degrade=True)
    plan = t_plan(DEGRADE_FAULTS)
    with t_inject.inject(plan):
        out = solver.solve(backend="kernel")
    assert plan.fired == 1
    (d,) = solver.degradations
    assert (d.site, d.from_backend, d.from_frontier, d.to_backend, d.to_frontier, d.rung) == (
        "solve", "kernel", "replicated", "torch", "replicated", 1
    )
    assert solver.stats["degradations"] == 1
    # performance degraded, the answer did not
    assert (out.rounds, out.converged, out.flushes) == (ref.rounds, ref.converged, ref.flushes) == (
        jref.rounds, jref.converged, jref.flushes
    )
    np.testing.assert_array_equal(out.x, ref.x)
    np.testing.assert_array_equal(out.x, np.asarray(jref.x))


def test_degradation_record_matches_the_references(graphs):
    """One fault at the first dispatch: the port's record is the
    reference's, field by field, with the backends named each package's way."""
    j_solver = j_solve.Solver(graphs["sssp"][0], j_solve.sssp_problem(), degrade=True, **KW)
    with j_inject.inject(j_inject.FaultPlan([j_inject.FaultSpec(site="kernel.dispatch", match={"backend": "jit"})])):
        j_solver.solve(backend="jit")
    solver = t_solver(graphs, "sssp", degrade=True)
    with t_inject.inject(t_plan(DEGRADE_FAULTS)):
        solver.solve(backend="kernel")
    (jd,), (td,) = j_solver.degradations, solver.degradations
    for f in dataclasses.fields(jd):
        want, got = getattr(jd, f.name), getattr(td, f.name)
        if f.name == "from_backend":
            assert (want, NAMES[got]) == ("jit", "pallas")  # the rung each package steps down from
        elif f.name == "to_backend":
            assert (want, got) == ("host", "torch")  # and the floor it steps to
        elif f.name == "error":
            assert got == want.replace("'jit'", "'kernel'")
        else:
            assert got == want, f.name


def test_halo_degrades_to_replicated_first(graphs):
    ref = t_solver(graphs, "pagerank", frontier="halo", n_shards=2).solve()
    solver = t_solver(graphs, "pagerank", frontier="halo", n_shards=2, degrade=True)
    plan = t_plan(DEGRADE_FAULTS)
    with t_inject.inject(plan):
        out = solver.solve()
    (d,) = solver.degradations
    assert (d.from_backend, d.from_frontier, d.to_backend, d.to_frontier) == ("kernel", "halo", "kernel", "replicated")
    assert plan.events[0]["frontier"] == "halo"
    assert out.rounds == ref.rounds
    np.testing.assert_array_equal(out.x, ref.x)  # the f32 halo round is the replicated one


def test_degrade_off_raises(graphs):
    solver = t_solver(graphs, "sssp")
    with t_inject.inject(t_inject.FaultPlan([t_inject.FaultSpec(site="kernel.dispatch")])):
        with pytest.raises(t_inject.InjectedFault):
            solver.solve()
    assert solver.degradations == [] and solver.stats["degradations"] == 0


def test_ladder_exhausted_reraises(graphs):
    solver = t_solver(graphs, "sssp", degrade=True)
    with t_inject.inject(t_inject.FaultPlan([t_inject.FaultSpec(site="kernel.dispatch", at=0, times=-1)])):
        with pytest.raises(t_inject.InjectedFault):
            solver.solve(backend="kernel")
    assert len(solver.degradations) == 1  # kernel→torch tried before giving up


def test_caller_errors_never_degraded(graphs):
    solver = t_solver(graphs, "sssp", degrade=True)
    with pytest.raises(ValueError):
        solver.solve(backend="warp")
    assert solver.degradations == []


@pytest.mark.parametrize("exc", [NotImplementedError, ValueError, TypeError])
def test_not_implemented_and_caller_errors_inside_dispatch_propagate(graphs, monkeypatch, exc):
    solver = t_solver(graphs, "sssp", degrade=True)

    def missing(*args, **kwargs):
        raise exc("a path the port does not have")

    monkeypatch.setattr(solver, "_solve_once", missing)
    with pytest.raises(exc, match="does not have"):
        solver.solve()
    assert solver.degradations == []


@pytest.mark.parametrize("exc", [RuntimeError, torch.OutOfMemoryError])
def test_kernel_errors_never_degraded(graphs, monkeypatch, exc):
    """The ladder answers faults injected at ``kernel.dispatch`` alone: a
    kernel's own launch error or an out-of-memory error raises (a departure
    from the reference, whose ladder takes any exception)."""
    solver = t_solver(graphs, "sssp", degrade=True)

    def refused(*args, **kwargs):
        raise exc("round_block_solve launch failed: cudaError 720")

    monkeypatch.setattr(solver, "_solve_once", refused)
    with pytest.raises(exc, match="cudaError 720"):
        solver.solve()
    assert solver.degradations == [] and solver.stats["degradations"] == 0


def test_degraded_solve_logs_no_observation(graphs, tmp_path):
    """A degraded solve's time is a lower rung's: it is not logged as the
    requested backend's, where the δ-model would refit from it."""
    solver = t_solver(graphs, "sssp", degrade=True, cache_dir=tmp_path)
    solver.solve()
    rows = solver.persist.load_observations()
    assert [r["backend"] for r in rows] == ["kernel"]
    with t_inject.inject(t_plan(DEGRADE_FAULTS)):
        solver.solve()
    assert len(solver.degradations) == 1
    assert solver.persist.load_observations() == rows


def test_kernel_build_outside_the_fault_domain(graphs, monkeypatch):
    """A kernel that does not build raises before the ladder is climbed."""
    solver = t_solver(graphs, "sssp", degrade=True)

    def no_build(backend, device, name="round_block"):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(t_build, "load_seconds", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        solver.solve()
    assert solver.degradations == [] and solver.stats["solves"] == 0


def test_grouped_solver_refuses_degrade(graphs):
    with pytest.raises(NotImplementedError, match="A9, third part"):
        t_solver(graphs, "sssp", degrade=True, group=object())


def test_solver_round_site_in_the_host_loop(graphs):
    """The halo solve's host loop fires ``solver.round`` with the rounds run."""
    solver = t_solver(graphs, "pagerank", frontier="halo", n_shards=2)
    plan = t_inject.FaultPlan([t_inject.FaultSpec(site="solver.round", match={"round": 3})])
    with t_inject.inject(plan):
        with pytest.raises(t_inject.InjectedFault, match="round=3"):
            solver.solve()
    assert plan.events == [{"site": "solver.round", "kind": "error", "spec": 0, "visit": 0, "round": 3}]


# --------------------------------------------------------------------------- #
# BatchStepper's kernel.dispatch and the scheduler's retry
# --------------------------------------------------------------------------- #
def test_stepper_fault_leaves_its_state(graphs):
    solver = t_solver(graphs, "sssp")
    st = t_solve.BatchStepper(solver, 2)
    x0 = t_solve.multi_source_x0(graphs["sssp"][1], [0, 5])
    for v in x0:
        st.admit(v)
    X = st._X.clone()
    with t_inject.inject(t_inject.FaultPlan([t_inject.FaultSpec(site="kernel.dispatch")])):
        with pytest.raises(t_inject.InjectedFault):
            st.run(4)
    assert torch.equal(st._X, X) and st.occupancy == 2 and st.rounds_executed == st.quanta == 0
    done = []
    while st.occupancy:
        done += st.run(4)
    for r, v in zip(sorted(done, key=lambda r: r.tag or 0), (0, 5)):
        want = solver.solve(t_solve.multi_source_x0(graphs["sssp"][1], [v])[0])
        np.testing.assert_array_equal(r.x, want.x)


def _serve(side, graph, payloads, plan, **kw):
    svc = side.GraphService(graph, batch_size=4, algos=("sssp",), queue_capacity=16, **KW, **kw)
    pkg = j_inject if side is j_serve else t_inject
    service = j_service if side is j_serve else t_service
    p = pkg.FaultPlan.from_json(plan)
    with pkg.inject(p):
        ids = []
        for v in payloads:
            adm = svc.submit(service.QueryRequest(algo="sssp", payload=v))
            assert adm.accepted, adm.reason
            ids.append(adm.request_id)
        results = svc.drain()
    assert svc.take_failures() == []
    assert sorted(r.request_id for r in results) == sorted(ids)
    return svc, p, {r.payload: r for r in results}


@pytest.mark.parametrize("degrade", [True, False])
def test_stepper_dispatch_fault_retried_bit_identical(graphs, degrade):
    payloads = list(range(6))
    plan = {"specs": [{"site": "kernel.dispatch", "at": 0, "times": 1}]}
    _, _, clean = _serve(t_serve, graphs["sssp"][1], payloads, {}, device="cpu")
    svc, p, got = _serve(t_serve, graphs["sssp"][1], payloads, plan, device="cpu", degrade=degrade)
    jsvc, jp, want = _serve(j_serve, graphs["sssp"][0], payloads, plan, backend="jit", degrade=degrade)
    assert p.fired == jp.fired == 1
    assert all(sv.degrade is degrade for sv in svc._solvers.values())
    for v in payloads:
        np.testing.assert_array_equal(got[v].x, clean[v].x)
        np.testing.assert_array_equal(got[v].x, want[v].x)
        assert got[v].rounds == want[v].rounds
    c, jc = svc.scheduler.stats()["counters"], jsvc.scheduler.stats()["counters"]
    assert c["lane_faults"] == jc["lane_faults"] == 1
    assert c == jc
    assert c["accepted"] == c["completed"] == 6 and c["failed"] == 0


def test_serving_faults_plan_delivers_every_answer(graphs, tmp_path):
    """The chaos trace's serving plan over a service with a store: every
    answer delivered and equal to a fault-free service's, with the
    reference's faults, lane faults and retries (its ``kernel.dispatch``
    spec, at the sixth dispatch, is not reached by these ten queries in
    either package)."""
    payloads = [3, 17, 42, 99, 7, 1, 23, 58, 200, 11]
    _, _, clean = _serve(t_serve, graphs["sssp"][1], payloads, {}, device="cpu")
    svc, p, got = _serve(t_serve, graphs["sssp"][1], payloads, SERVING_FAULTS, device="cpu", degrade=True,
                         cache_dir=tmp_path / "t")
    jsvc, jp, want = _serve(j_serve, graphs["sssp"][0], payloads, SERVING_FAULTS, backend="jit", degrade=True,
                            cache_dir=tmp_path / "j")
    # the same faults at the same visits; the store's keys are each package's
    assert [{k: v for k, v in e.items() if k != "key"} for e in p.events] == [
        {k: v for k, v in e.items() if k != "key"} for e in jp.events
    ]
    assert p.sites_fired() == ["persist.read", "persist.write", "scheduler.lane"]
    for v in payloads:
        np.testing.assert_array_equal(got[v].x, clean[v].x)
        np.testing.assert_array_equal(got[v].x, want[v].x)
    c, jc = svc.scheduler.stats()["counters"], jsvc.scheduler.stats()["counters"]
    assert c == jc
    assert c["lane_faults"] == 2 and c["completed"] == len(payloads)
