"""Batched halo solves in the port (``frontier="halo"``) against the JAX
reference, on the CPU, and ``partition_report``.

The same numpy inputs go through ``repro.solve.batch`` (``backend="jit"``,
whose answers its ``backend="sharded", frontier="halo"`` batch equals, as
``tests/test_frontier_sharded.py::TestShardedBatch`` holds) and the port's
halo batch (K2's batch entry on a card; its plain version here, for both
backends):

* the plain batch halo round equals Q single plain halo rounds bit for bit,
  for every epilogue tag, at C = Q·F = 1, 3 and 8 (labelprop at 4 and 8);
* ``solve_batch(frontier="halo")`` at D = 2 and 4, with and without
  ``compact_every``, for multi-source SSSP and ppr: ``x`` bit for bit, and
  ``rounds``, ``rounds_per_query``, ``converged``, ``flushes``,
  ``flush_bytes`` and ``compactions`` exactly (``residuals`` within
  ``rtol=1e-5``: the port sums them in another order than XLA, ROADMAP
  queue C item 2);
* ``BatchStepper(frontier="halo")`` quanta with staggered admissions, and a
  two-tenant ``GraphService(frontier="halo")`` replay, equal the
  reference's ``jit`` stepper and service;
* a quantized halo batch raises; ``partition_report`` equals the
  reference's on the port's partitions.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.service as j_service  # noqa: E402
import repro.solve as j_solve  # noqa: E402
from repro.core import access_matrix as j_access  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
from repro.graphs import partition as j_partition  # noqa: E402
from repro.launch import serve_graph as j_serve  # noqa: E402
import repro_torch.launch.service as t_service  # noqa: E402
import repro_torch.solve as t_solve  # noqa: E402
from repro_torch.core import access_matrix as t_access  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.semiring import MIN_PLUS, PLUS_TIMES  # noqa: E402
from repro_torch.dist import engine_sharded as es  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.graphs import partition as t_partition  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.round_block import (  # noqa: E402
    ADD_CONST,
    ADD_TABLE,
    LABELPROP,
    MIN_OLD,
    Epilogue,
    fused_halo_batch_round_cuda,
)
from repro_torch.launch import serve_graph as t_serve  # noqa: E402

P = 4
MIN_CHUNK = 8
KINDS = {"sssp": ("kron", "sssp"), "ppr": ("twitter", "pagerank")}


def _graphs(name):
    graph, kind = KINDS[name]
    return (
        j_gen.make_graph(graph, scale=8, efactor=8, kind=kind),
        t_gen.make_graph(graph, scale=8, efactor=8, kind=kind),
    )


def _solvers(name, D):
    jg, tg = _graphs(name)
    factory = f"{name}_problem"
    kw = dict(n_workers=P, min_chunk=MIN_CHUNK)
    js = j_solve.Solver(jg, getattr(j_solve, factory)(), backend="jit", **kw)
    ts = t_solve.Solver(tg, getattr(t_solve, factory)(), device="cpu", n_shards=D, **kw)
    return js, ts


def _inputs(name, graph, seeds):
    if name == "sssp":
        return j_solve.multi_source_x0(graph, seeds), None
    x0 = np.full((len(seeds), graph.n), 1.0 / graph.n, np.float32)
    return x0, j_solve.ppr_teleport(graph, seeds)


def _assert_same_batch(want, got):
    assert (got.rounds, got.flushes, got.flush_bytes, got.delta, got.P, got.Q) == (
        want.rounds, want.flushes, want.flush_bytes, want.delta, want.P, want.Q
    )
    assert got.compactions == want.compactions
    np.testing.assert_array_equal(got.rounds_per_query, np.asarray(want.rounds_per_query))
    np.testing.assert_array_equal(got.converged, np.asarray(want.converged))
    x = np.asarray(want.x)
    assert got.x.shape == x.shape and got.x.dtype == x.dtype
    np.testing.assert_array_equal(got.x.view(np.int32), x.view(np.int32))
    np.testing.assert_allclose(got.residuals, np.asarray(want.residuals), rtol=1e-5)


# --------------------------------------------------------------------------- #
# (a) the plain batch halo round
# --------------------------------------------------------------------------- #
CASES = [(tag, Q, F) for tag in (ADD_CONST, ADD_TABLE, MIN_OLD) for Q, F in ((1, 1), (3, 1), (2, 4))]
CASES += [(LABELPROP, 1, 4), (LABELPROP, 2, 4)]  # labelprop's row total needs F > 1


@pytest.mark.parametrize("tag,Q,F", CASES)
def test_batch_halo_round_equals_single_halo_rounds(tag, Q, F):
    kind = "sssp" if tag == MIN_OLD else "pagerank"
    g = t_gen.make_graph("kron" if kind == "sssp" else "twitter", scale=8, efactor=8, kind=kind)
    sr = MIN_PLUS if tag == MIN_OLD else PLUS_TIMES
    sched = t_engine.make_schedule(g, 8, 24, sr, min_chunk=MIN_CHUNK)
    plan = es.make_frontier_plan(sched, 4)
    rng = np.random.default_rng(Q * 10 + F)
    feat = (F,) if F > 1 else ()
    shape = (g.n + 1, Q) + feat
    if sr is MIN_PLUS:
        X = torch.as_tensor(rng.integers(0, 500, shape).astype(np.int32))
    else:
        X = torch.as_tensor(rng.random(shape).astype(np.float32))
    if tag == ADD_CONST:
        ep = Epilogue(ADD_CONST, const=0.15 / g.n)
    elif tag == MIN_OLD:
        ep = Epilogue(MIN_OLD)
    elif tag == ADD_TABLE:
        ep = Epilogue(ADD_TABLE, table=torch.as_tensor(rng.random(shape).astype(np.float32)))
    else:
        anchors = np.zeros(shape, np.float32)
        hit = rng.choice(g.n, g.n // 8, replace=False)
        anchors[hit, :, rng.integers(0, F, hit.size)] = 1.0
        ep = Epilogue.labelprop(torch.as_tensor(anchors), 0.6)
    got = ref.fused_halo_batch_round_ref(plan.scatter_x(X), sched, plan, sr, ep)
    for i in range(Q):
        one = ep if ep.table is None else dataclasses.replace(ep, table=ep.table[:, i].contiguous())
        want = ref.fused_halo_round_ref(plan.scatter_x(X[:, i].contiguous()), None, sched, plan, sr, one)[0]
        assert torch.equal(got[:, :-1, i], want[:, :-1]), i


# --------------------------------------------------------------------------- #
# (b) closed batches against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("compact_every", [None, 1])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", ["sssp", "ppr"])
def test_halo_batch_matches_reference_jit(name, D, compact_every, backend):
    js, ts = _solvers(name, D)
    x0, q = _inputs(name, js.graph, [0, 7, 33, 90])
    want = j_solve.solve_batch(js, x0, q=q, delta=24, compact_every=compact_every)
    launches = fused_halo_batch_round_cuda.launches
    got = ts.solve_batch(x0, q=q, delta=24, frontier="halo", backend=backend, compact_every=compact_every)
    assert fused_halo_batch_round_cuda.launches == launches  # the CPU never launches
    assert got.rounds > 1 and got.converged.all()
    assert len(set(got.rounds_per_query.tolist())) > 1
    _assert_same_batch(want, got)
    if compact_every is not None:
        assert got.compactions > 0
    assert ts.stats["plan_builds"] == 1


def test_halo_batch_refuses_a_quantized_wire():
    _, ts = _solvers("ppr", 2)
    x0, q = _inputs("ppr", ts.graph, [1, 2])
    for wire in ("int8", "fp8"):
        quant = t_solve.Solver(ts.graph, t_solve.ppr_problem(), n_workers=P, min_chunk=MIN_CHUNK, n_shards=2,
                               halo_dtype=wire, device="cpu")
        with pytest.raises(ValueError, match=f"K2 takes no query axis on an {wire} wire"):
            quant.solve_batch(x0, q=q, delta=24, frontier="halo")
        with pytest.raises(ValueError, match=f"K2 takes no query axis on an {wire} wire"):
            t_solve.BatchStepper(quant, capacity=2, frontier="halo")
        # the replicated batch quantizes nothing: the wire's default does not apply
        got = quant.solve_batch(x0, q=q, delta=24)
        np.testing.assert_array_equal(got.x, ts.solve_batch(x0, q=q, delta=24).x)


# --------------------------------------------------------------------------- #
# (c) the open batch and the serving tier
# --------------------------------------------------------------------------- #
def _drain(stepper, name, graph, keys, quantum):
    done = {}
    for s in keys:
        x0, q = _inputs(name, graph, [s])
        stepper.admit(x0[0], q=None if q is None else q[0], tag=s)
        for row in stepper.run(quantum):
            done[row.tag] = row
    while stepper.occupancy:
        for row in stepper.run(quantum):
            done[row.tag] = row
    return done


@pytest.mark.parametrize("name,keys,quantum", [("sssp", [0, 7, 33], 2), ("ppr", [3, 11, 40], 3)])
def test_halo_stepper_equals_reference_jit(name, keys, quantum):
    js, ts = _solvers(name, 4)
    want = _drain(j_solve.BatchStepper(js, capacity=4, delta=32), name, js.graph, keys, quantum)
    st = t_solve.BatchStepper(ts, capacity=4, delta=32, frontier="halo")
    got = _drain(st, name, ts.graph, keys, quantum)
    assert set(got) == set(want) == set(keys)
    for s in keys:
        assert got[s].converged and want[s].converged and got[s].rounds == want[s].rounds
        np.testing.assert_array_equal(got[s].x.view(np.int32), np.asarray(want[s].x).view(np.int32))
        np.testing.assert_allclose(got[s].residual, want[s].residual, rtol=1e-5)
    assert st.quanta > 0 and st.frontier == "halo"


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_halo_service_two_tenants_equal_reference(backend):
    def run(gen, svc_mod, serve_mod, **kw):
        graphs = {a: gen.make_graph(n, scale=8, efactor=8, kind=k) for a, (n, k) in KINDS.items()}
        common = dict(n_workers=P, delta=32, batch_size=4, min_chunk=MIN_CHUNK, **kw)
        tenants = {
            "road": serve_mod.GraphService(graphs["sssp"], algos=("sssp",), **common),
            "social": serve_mod.GraphService(graphs["ppr"], algos=("ppr",), **common),
        }
        sched = svc_mod.ContinuousScheduler(tenants, queue_capacity=8)
        adms = []
        for v in (1, 5, 9, 70):
            adms.append(sched.submit(svc_mod.QueryRequest(algo="sssp", payload=v, graph="road")))
            adms.append(sched.submit(svc_mod.QueryRequest(algo="ppr", payload=v, graph="social")))
        results = sorted(sched.drain(), key=lambda r: r.request_id)
        return adms, results, sched.stats()

    want = run(j_gen, j_service, j_serve, backend="jit")
    got = run(t_gen, t_service, t_serve, backend=backend, frontier="halo", n_shards=2, device="cpu")
    assert [a.accepted for a in got[0]] == [a.accepted for a in want[0]]
    assert len(got[1]) == len(want[1]) == 8
    for w, g in zip(want[1], got[1]):
        assert (g.request_id, g.algo, g.rounds, g.converged, g.delta) == (w.request_id, w.algo, w.rounds, w.converged, w.delta)
        np.testing.assert_array_equal(g.x.view(np.int32), np.asarray(w.x).view(np.int32))
    for k in ("clock_rounds", "counters"):
        assert got[2][k] == want[2][k], k
    assert got[2]["counters"]["lane_faults"] == 0


# --------------------------------------------------------------------------- #
# (d) partition_report
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("method", sorted(t_partition.PARTITION_METHODS))
@pytest.mark.parametrize("name", ["twitter", "road"])
def test_partition_report_equals_reference(name, method):
    kw = {} if name == "road" else {"efactor": 8}
    jg = j_gen.make_graph(name, scale=9, kind="unit", **kw)
    tg = t_gen.make_graph(name, scale=9, kind="unit", **kw)
    jp = j_partition.make_partition(jg, 8, method=method)
    tp = t_partition.make_partition(tg, 8, method=method)
    np.testing.assert_array_equal(tp.bounds, jp.bounds)
    want = j_access.partition_report(jg, jp)
    got = t_access.partition_report(tg, tp)
    assert got == want
    mat = t_access.access_matrix(tg, tp)
    assert t_access.partition_report(tg, tp, mat) == want
