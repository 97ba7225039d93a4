"""Batched multi-query solves in the port against the JAX reference.

The same numpy inputs go through ``repro.solve.batch`` (``backend="jit"``)
and ``repro_torch.solve.batch`` on the CPU:

* ``solve_batch`` for pagerank, ppr (one teleport a seed), multi-source
  sssp, cc and jacobi at sync, δ = 24 and async, and rwr and labelprop at
  F = 4 (Q = 3) at sync and δ = 16: x bit for bit, and ``rounds``,
  ``rounds_per_query``, ``converged``, ``flushes`` and ``flush_bytes``
  exactly; ``residuals`` with ``rtol=1e-5``, because the port sums each
  query's residual in another order than XLA (ROADMAP queue C, item 2);
* ``compact_every=2`` likewise, ``compactions`` included;
* ``BatchStepper``: the reference's own cases (lone query, free slots, a
  full batch, the round budget, staggered sssp and ppr admissions) against
  the reference's stepper and against a fresh one-query ``solve_batch``;
* a batch of one equals the port's ``solve()``, and each query of a closed
  batch equals its own ``solve(tol=-1.0, max_rounds=batch.rounds)``: a
  closed batch does not freeze its converged queries;
* the plain batch round equals Q single plain rounds at C = Q·F = 1, 3, 8,
  12, 16 and 32 for every epilogue tag;
* the refusals (a quantized halo batch; a batch across processes, here a
  group of one rank), and that ``repro_torch.solve.batch`` imports neither
  jax nor ``repro``.

The graphs are the s9 (and the reference's s8) pairs with n ≥ 32 and
P ≥ 2, where the reference's float bits do not depend on XLA's fusion
(ROADMAP queue C, item 1).
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.solve as j_solve  # noqa: E402
from repro.graphs import formats as j_formats  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
import repro_torch.solve as t_solve  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.semiring import MIN_PLUS, PLUS_TIMES  # noqa: E402
from repro_torch.ft import elastic as t_elastic  # noqa: E402
from repro_torch.graphs import formats as t_formats  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.round_block import (  # noqa: E402
    ADD_CONST,
    ADD_TABLE,
    LABELPROP,
    MIN_OLD,
    Epilogue,
    fused_batch_round_cuda,
    fused_round_cuda,
)

REPO = Path(__file__).resolve().parents[1]
P = 4
MIN_CHUNK = 16
DELTAS = ["sync", 24, "async"]
Q = 4


def _jacobi_pair():
    rng = np.random.default_rng(11)
    n, m = 300, 1500
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.random(rows.size).astype(np.float32)
    diag = (np.bincount(rows, weights=vals, minlength=n) + 1.0).astype(np.float32)
    b = rng.random(n).astype(np.float32)
    w = (-vals / diag[rows]).astype(np.float32)
    jg = j_formats.CSRGraph.from_edges(n, cols, rows, w, dedup=False)
    tg = t_formats.CSRGraph.from_edges(n, cols, rows, w, dedup=False)
    return (jg, j_solve.jacobi_problem(diag, b)), (tg, t_solve.jacobi_problem(diag, b))


GRAPHS = {
    "pagerank": ("twitter", "pagerank", "pagerank_problem"),
    "ppr": ("twitter", "pagerank", "ppr_problem"),
    "sssp": ("kron", "sssp", "sssp_problem"),
    "cc": ("kron", "sssp", "cc_problem"),
    "rwr": ("twitter", "pagerank", "rwr_embedding_problem"),
    "labelprop": ("web", "pagerank", "label_propagation_problem"),
}


def _solvers(name, n_workers=P, **kw):
    """(reference solver, port solver) on the same s9 graph."""
    if name == "jacobi":
        (jg, jp), (tg, tp) = _jacobi_pair()
    else:
        graph, kind, factory = GRAPHS[name]
        jg = j_gen.make_graph(graph, scale=9, efactor=8, kind=kind)
        tg = t_gen.make_graph(graph, scale=9, efactor=8, kind=kind)
        jp, tp = getattr(j_solve, factory)(), getattr(t_solve, factory)()
    common = dict(n_workers=n_workers, min_chunk=MIN_CHUNK)
    js = j_solve.Solver(jg, jp, backend="jit", **common)
    ts = t_solve.Solver(tg, tp, device="cpu", **common, **kw)
    return js, ts


def _batch_inputs(name, graph, n_queries=Q):
    """(x0 (Q, n)+feat, q or None): distinct initial states (and queries)."""
    rng = np.random.default_rng(len(name))
    n = graph.n
    seeds = rng.choice(n, n_queries, replace=False)
    if name in ("sssp",):
        return j_solve.multi_source_x0(graph, seeds), None
    if name == "cc":
        return np.stack([rng.permutation(n) for _ in range(n_queries)]).astype(np.int32), None
    if name == "ppr":
        x0 = np.full((n_queries, n), 1.0 / n, np.float32)
        return x0, j_solve.ppr_teleport(graph, seeds)
    if name == "rwr":
        x0 = np.full((n_queries, n, 4), 1.0 / n, np.float32)
        q = np.stack([j_solve.rwr_restart(graph, rng.choice(n, 4, replace=False)) for _ in range(n_queries)])
        return x0, q
    if name == "labelprop":
        x0 = np.full((n_queries, n, 4), 0.25, np.float32)
        q = np.stack([j_solve.labelprop_anchors(graph, rng.choice(n, 4, replace=False)) for _ in range(n_queries)])
        return x0, q
    scale = 1.0 / n if name == "pagerank" else 1.0
    return (rng.random((n_queries, n)) * scale).astype(np.float32), None


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
    assert got.residuals.dtype == np.float32
    np.testing.assert_allclose(got.residuals, np.asarray(want.residuals), rtol=1e-5)


# --------------------------------------------------------------------------- #
# (a) closed batches against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("name", ["pagerank", "ppr", "sssp", "cc", "jacobi"])
def test_batch_matches_reference_jit(name, delta):
    js, ts = _solvers(name)
    x0, q = _batch_inputs(name, js.graph)
    want = j_solve.solve_batch(js, x0, q=q, delta=delta)
    got = ts.solve_batch(x0, q=q, delta=delta)
    assert got.rounds > 1 and got.converged.all()
    _assert_same_batch(want, got)


@pytest.mark.parametrize("delta", ["sync", 16])
@pytest.mark.parametrize("name", ["rwr", "labelprop"])
def test_matrix_batch_matches_reference_jit(name, delta):
    js, ts = _solvers(name, n_workers=8)
    x0, q = _batch_inputs(name, js.graph, n_queries=3)
    want = j_solve.solve_batch(js, x0, q=q, delta=delta)
    got = ts.solve_batch(x0, q=q, delta=delta)
    assert got.rounds > 1 and got.x.shape == (3, ts.graph.n, 4)
    assert got.flush_bytes == got.flushes * 8 * got.delta * 4 * 4 * 3
    _assert_same_batch(want, got)


@pytest.mark.parametrize("name", ["ppr", "sssp", "rwr"])
def test_compaction_matches_reference_jit(name):
    js, ts = _solvers(name, n_workers=8 if name == "rwr" else P)
    x0, q = _batch_inputs(name, js.graph, n_queries=3 if name == "rwr" else Q)
    want = j_solve.solve_batch(js, x0, q=q, delta=24, compact_every=2)
    got = ts.solve_batch(x0, q=q, delta=24, compact_every=2)
    assert got.compactions > 0
    _assert_same_batch(want, got)


def test_round_budget_matches_reference_jit():
    js, ts = _solvers("ppr")
    x0, q = _batch_inputs("ppr", js.graph)
    for kw in ({"max_rounds": 5}, {"max_rounds": 5, "compact_every": 2}, {"tol": -1.0, "max_rounds": 3}):
        want = j_solve.solve_batch(js, x0, q=q, delta=24, **kw)
        got = ts.solve_batch(x0, q=q, delta=24, **kw)
        assert not got.converged.any()
        _assert_same_batch(want, got)


# --------------------------------------------------------------------------- #
# (b) against the port's own single solves
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["pagerank", "ppr", "sssp", "rwr", "labelprop"])
def test_one_query_batch_equals_solve(name):
    _, ts = _solvers(name, n_workers=8 if name in ("rwr", "labelprop") else P)
    x0, q = _batch_inputs(name, ts.graph, n_queries=1)
    got = ts.solve_batch(x0, q=q, delta=24)
    one = ts.solve(x0[0], q=None if q is None else q[0], delta=24)
    assert got.rounds == one.rounds == got.rounds_per_query[0] > 1
    assert (got.flushes, got.flush_bytes, bool(got.converged[0])) == (one.flushes, one.flush_bytes, one.converged)
    np.testing.assert_array_equal(got.x[0].view(np.int32), one.x.view(np.int32))


@pytest.mark.parametrize("name", ["ppr", "sssp", "rwr"])
def test_each_query_equals_its_own_solve(name):
    """A closed batch runs every query ``batch.rounds`` rounds: each x is its
    own solve stopped there, and ``rounds_per_query`` its own solve's rounds."""
    _, ts = _solvers(name, n_workers=8 if name == "rwr" else P)
    x0, q = _batch_inputs(name, ts.graph, n_queries=3 if name == "rwr" else Q)
    got = ts.solve_batch(x0, q=q, delta="sync")
    assert len(set(got.rounds_per_query.tolist())) > 1  # the queries converge apart
    for i in range(x0.shape[0]):
        qi = None if q is None else q[i]
        own = ts.solve(x0[i], q=qi, delta="sync", tol=-1.0, max_rounds=got.rounds)
        np.testing.assert_array_equal(got.x[i].view(np.int32), own.x.view(np.int32))
        assert ts.solve(x0[i], q=qi, delta="sync").rounds == got.rounds_per_query[i]


def test_kernel_backend_equals_torch_backend_on_cpu():
    _, ts = _solvers("ppr")
    x0, q = _batch_inputs("ppr", ts.graph)
    launches = fused_batch_round_cuda.launches
    a = ts.solve_batch(x0, q=q, delta=24, backend="kernel")
    b = ts.solve_batch(x0, q=q, delta=24, backend="torch")
    assert (a.rounds, a.flushes) == (b.rounds, b.flushes)
    np.testing.assert_array_equal(a.x, b.x)
    assert fused_batch_round_cuda.launches == launches  # the CPU never launches


def test_batch_stats_and_schedule_cache():
    _, ts = _solvers("sssp")
    x0, _ = _batch_inputs("sssp", ts.graph)
    ts.solve_batch(x0, delta=24)
    ts.solve_batch(x0, delta=24)
    ts.solve(x0[0], delta=24)
    ts.solve_batch(x0, delta="async")
    assert ts.stats == {
        "solves": 4,
        "schedule_builds": 2,
        "plan_builds": 0,
        "stripe_builds": 0,  # no store: nothing built in stripes or loaded
        "stripe_loads": 0,
        "plan_shard_builds": 0,
        "plan_shard_loads": 0,
        "cache_loads": 0,
        "degradations": 0,  # the degradation ladder's fallbacks, as the reference counts them
    }


# --------------------------------------------------------------------------- #
# (c) the open batch: the reference's stepper cases
# --------------------------------------------------------------------------- #
def _stepper_pair(name):
    """The reference's test graphs (kron / twitter s8) and solvers."""
    if name == "sssp":
        graph, kind, jp, tp = "kron", "sssp", j_solve.sssp_problem(), t_solve.sssp_problem()
    else:
        graph, kind, jp, tp = "twitter", "pagerank", j_solve.ppr_problem(), t_solve.ppr_problem()
    jg = j_gen.make_graph(graph, scale=8, efactor=8, kind=kind)
    tg = t_gen.make_graph(graph, scale=8, efactor=8, kind=kind)
    kw = dict(n_workers=4, delta=32, min_chunk=8)
    return j_solve.Solver(jg, jp, backend="jit", **kw), t_solve.Solver(tg, tp, device="cpu", **kw)


def _query(name, graph, s):
    if name == "sssp":
        return j_solve.multi_source_x0(graph, [s])[0], None
    return np.full(graph.n, 1.0 / graph.n, np.float32), j_solve.ppr_teleport(graph, [s])[0]


def _drain(stepper, name, graph, keys, quantum):
    """Admit one query a quantum, then run until the batch is empty."""
    done = {}
    for s in keys:
        x0, q = _query(name, graph, s)
        stepper.admit(x0, q=q, tag=s)
        for row in stepper.run(quantum):
            done[row.tag] = row
    while stepper.occupancy:
        for row in stepper.run(quantum):
            done[row.tag] = row
    return done


@pytest.mark.parametrize("name,keys,quantum", [("sssp", [0, 7, 33], 2), ("ppr", [3, 11, 40], 3)])
def test_stepper_staggered_admissions(name, keys, quantum):
    """Rows freeze at first convergence: each retired row equals a fresh
    one-query batch, and the reference's stepper, bit for bit."""
    js, ts = _stepper_pair(name)
    want = _drain(j_solve.BatchStepper(js, capacity=4), name, js.graph, keys, quantum)
    st = t_solve.BatchStepper(ts, capacity=4)
    got = _drain(st, name, ts.graph, keys, quantum)
    assert set(got) == set(want) == set(keys)
    for s in keys:
        x0, q = _query(name, ts.graph, s)
        fresh = ts.solve_batch(x0[None], q=None if q is None else q[None])
        assert got[s].converged and want[s].converged
        assert got[s].rounds == want[s].rounds == fresh.rounds
        np.testing.assert_array_equal(got[s].x.view(np.int32), np.asarray(want[s].x).view(np.int32))
        np.testing.assert_array_equal(got[s].x.view(np.int32), fresh.x[0].view(np.int32))
        np.testing.assert_allclose(got[s].residual, want[s].residual, rtol=1e-5)
    assert (st.flushes, st.flush_bytes, st.rounds_executed, st.quanta) > (0, 0, 0, 0)


def test_stepper_lone_query_and_free_slots():
    js, ts = _stepper_pair("sssp")
    fresh = ts.solve_batch(t_solve.multi_source_x0(ts.graph, [0]))
    for cls, solver in ((j_solve.BatchStepper, js), (t_solve.BatchStepper, ts)):
        st = cls(solver, capacity=4)
        assert st.free_slots == 4
        st.admit(t_solve.multi_source_x0(solver.graph, [0])[0], tag="a")
        (row,) = st.run(1000)  # occupancy 1 of 4: empty slots do not block retirement
        assert row.converged and row.rounds == fresh.rounds and row.tag == "a"
        np.testing.assert_array_equal(row.x, fresh.x[0])
        assert st.occupancy == 0 and st.free_slots == 4


def test_stepper_counters_match_reference():
    js, ts = _stepper_pair("ppr")
    steppers = [j_solve.BatchStepper(js, capacity=3), t_solve.BatchStepper(ts, capacity=3)]
    for st in steppers:
        _drain(st, "ppr", ts.graph, [3, 11], 3)
    want, got = steppers
    assert (got.flushes, got.flush_bytes, got.rounds_executed, got.quanta) == (
        want.flushes, want.flush_bytes, want.rounds_executed, want.quanta
    )
    assert ts.stats["solves"] == js.stats["solves"] == 2


def test_stepper_full_and_budget():
    _, ts = _stepper_pair("sssp")
    st = t_solve.BatchStepper(ts, capacity=2)
    for s in (0, 1):
        st.admit(t_solve.multi_source_x0(ts.graph, [s])[0], tag=s)
    with pytest.raises(ValueError, match="no free slots"):
        st.admit(t_solve.multi_source_x0(ts.graph, [2])[0], tag=2)
    assert sorted(st.evict_all()) == [0, 1] and st.occupancy == 0
    st = t_solve.BatchStepper(ts, capacity=2, max_rounds=1)
    st.admit(t_solve.multi_source_x0(ts.graph, [0])[0], tag="t")
    (row,) = st.run(1)
    assert not row.converged and row.rounds == 1


# --------------------------------------------------------------------------- #
# (d) the plain batch round is Q single plain rounds
# --------------------------------------------------------------------------- #
# C = Q·F: (Q, F), F None for a vector batch (n + 1, Q); labelprop needs a
# matrix batch, so it takes (Q, 1) where the others take a vector.
WIDTHS = {1: (1, None), 3: (3, None), 8: (2, 4), 12: (3, 4), 16: (4, 4), 32: (8, 4)}


@pytest.mark.parametrize("C", list(WIDTHS))
@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD, LABELPROP])
def test_plain_batch_round_is_single_rounds(tag, C):
    nq, F = WIDTHS[C]
    if tag == LABELPROP and F is None:
        F = 1
    feat = () if F is None else (F,)
    rng = np.random.default_rng(C)
    if tag == MIN_OLD:
        g, sr = t_gen.make_graph("kron", scale=9, efactor=8, kind="sssp"), MIN_PLUS
        x = rng.integers(0, 1000, (g.n + 1, nq) + feat).astype(np.int32)
    else:
        g, sr = t_gen.make_graph("twitter", scale=9, efactor=8, kind="pagerank"), PLUS_TIMES
        x = rng.random((g.n + 1, nq) + feat).astype(np.float32)
        if tag == LABELPROP:
            g = g.with_values(np.ones(g.nnz, np.float32))
            x[rng.random(g.n + 1) < 0.2] = 0.0  # rows whose totals are 0 keep old
    table = rng.random((g.n + 1, nq) + feat).astype(np.float32)
    if tag == LABELPROP:
        table = (table < 0.05).astype(np.float32)
    table[-1] = 0.0
    sched = t_engine.make_schedule(g, P, 24, sr, mode="delayed", min_chunk=MIN_CHUNK)

    def epilogue(t):
        if tag == ADD_CONST:
            return Epilogue(ADD_CONST, const=float(np.float32(0.15 / g.n)))
        if tag == ADD_TABLE:
            return Epilogue(ADD_TABLE, table=torch.as_tensor(np.ascontiguousarray(t)))
        if tag == LABELPROP:
            return Epilogue.labelprop(torch.as_tensor(np.ascontiguousarray(t)), 0.9)
        return Epilogue(MIN_OLD)

    X = torch.as_tensor(x)
    launches = fused_batch_round_cuda.launches
    out = ops.fused_batch_round(X, sched, sr, epilogue(table))
    assert fused_batch_round_cuda.launches == launches
    assert torch.equal(out, ref.fused_batch_round_ref(X, sched, sr, epilogue(table)))
    for i in range(nq):
        one = ref.fused_round_ref(X[:, i].contiguous(), sched, sr, epilogue(table[:, i]))
        np.testing.assert_array_equal(out[:-1, i].numpy().view(np.int32), one[:-1].numpy().view(np.int32))


def test_shared_table_spreads_over_the_batch():
    """jacobi's one table serves every query (the reference closes over it)."""
    ep = Epilogue(ADD_TABLE, table=torch.arange(5.0))
    wide = ep.for_batch(3, (2,), per_query=False)
    assert tuple(wide.table.shape) == (5, 3, 2) and wide.table.is_contiguous()
    assert torch.equal(wide.table[:, 2, 1], ep.table)
    per = Epilogue(ADD_TABLE, table=torch.rand(5, 3)).for_batch(3, (2,), per_query=True)
    assert torch.equal(per.table[..., 0], per.table[..., 1])
    with pytest.raises(ValueError, match="does not fit a batch"):
        Epilogue(ADD_TABLE, table=torch.rand(5, 2)).for_batch(3, (), per_query=True)


# --------------------------------------------------------------------------- #
# (e) refusals
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def _one_rank_group(tmp_path):
    """A ``gloo`` process group of this process alone, torn down after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize(
    "name,kwargs,exc,match",
    [
        ("sssp", {"x0": "n_plus_one"}, ValueError, r"x0_batch must be \(Q, 512\)"),
        ("sssp", {"q": "teleport"}, ValueError, "takes no query"),
        ("ppr", {"q": "short"}, ValueError, "q leading axis 3 != Q 4"),
        ("ppr", {"q": None}, ValueError, "needs a batched q="),
        ("sssp", {"compact_every": 0}, ValueError, "compact_every must be >= 1"),
        ("sssp", {"frontier": "halo", "halo_dtype": "int8"}, ValueError, "K2 takes no query axis"),
        ("sssp", {"frontier": "halo", "backend": "torch", "group": "one rank"}, NotImplementedError, "ROADMAP"),
        ("sssp", {"backend": "pallas"}, ValueError, "backend must be one of"),
    ],
)
def test_batch_refusals(name, kwargs, exc, match, tmp_path):
    _, ts = _solvers(name)
    x0, q = _batch_inputs(name, ts.graph)
    kwargs = dict(kwargs)
    wire = kwargs.pop("halo_dtype", None)
    if wire is not None:  # a solver whose default halo wire is quantized
        ts = t_solve.Solver(ts.graph, ts.problem, n_workers=P, min_chunk=MIN_CHUNK, n_shards=2, halo_dtype=wire,
                            device="cpu")
    if kwargs.pop("group", None):  # a solver whose shards span processes: a group of one rank here
        # A batch across processes runs (it gives the one-process batch's
        # answer), and so does a resolve; what such a solver still refuses
        # is a checkpointed solve.
        one = t_solve.Solver(ts.graph, ts.problem, n_workers=P, min_chunk=MIN_CHUNK, frontier="halo", device="cpu")
        want = one.solve_batch(x0, delta=24, **kwargs)
        want_resolve = one.resolve(x0=x0[0], delta=24)
        with _one_rank_group(tmp_path) as pg:
            grouped = t_solve.Solver(ts.graph, ts.problem, n_workers=P, min_chunk=MIN_CHUNK, frontier="halo",
                                     device="cpu", group=pg)
            got = grouped.solve_batch(x0, delta=24, **kwargs)
            assert got.rounds == want.rounds
            np.testing.assert_array_equal(got.x, want.x)
            np.testing.assert_array_equal(got.rounds_per_query, want.rounds_per_query)
            assert t_solve.BatchStepper(grouped, capacity=2).capacity == 2
            got_resolve = grouped.resolve(x0=x0[0], delta=24)
            assert got_resolve.rounds == want_resolve.rounds
            np.testing.assert_array_equal(got_resolve.x, want_resolve.x)
            with pytest.raises(exc, match=match):
                t_elastic.checkpointed_solve(grouped, ckpt_dir=tmp_path / "ckpt")
        return
    if kwargs.pop("x0", None):
        x0 = np.zeros((Q, ts.graph.n + 1), x0.dtype)
    if "q" not in kwargs:
        kwargs["q"] = q
    elif kwargs["q"] == "teleport":
        kwargs["q"] = np.zeros((Q, ts.graph.n), np.float32)
    elif kwargs["q"] == "short":
        kwargs["q"] = q[:3]
    with pytest.raises(exc, match=match):
        ts.solve_batch(x0, delta=24, **kwargs)


def test_stepper_refusals():
    _, ts = _stepper_pair("ppr")
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        t_solve.BatchStepper(ts, capacity=0)
    quantized = t_solve.Solver(ts.graph, ts.problem, n_workers=4, delta=32, min_chunk=8, halo_dtype="int8",
                               device="cpu")
    with pytest.raises(ValueError, match="K2 takes no query axis"):
        t_solve.BatchStepper(quantized, capacity=2, frontier="halo")
    st = t_solve.BatchStepper(ts, capacity=2)
    x0, q = _query("ppr", ts.graph, 3)
    with pytest.raises(ValueError, match="needs a per-row q="):
        st.admit(x0)
    with pytest.raises(ValueError, match="x0 must have shape"):
        st.admit(x0[:-1], q=q)
    with pytest.raises(ValueError, match="quantum must be >= 1"):
        st.run(0)
    assert st.run(3) == []  # an empty batch runs nothing


def _batch_case():
    g = t_gen.make_graph("twitter", scale=9, efactor=8, kind="pagerank")
    sched = t_engine.make_schedule(g, P, 24, PLUS_TIMES, mode="delayed", min_chunk=MIN_CHUNK)
    X = torch.rand((g.n + 1, 2, 4))
    return sched, X, Epilogue(ADD_TABLE, table=torch.rand((g.n + 1, 2, 4)))


@pytest.mark.parametrize(
    "change,err",
    [
        ("cpu", "CUDA tensors"),
        ("four_axes", r"a batch frontier is \(n \+ 1, Q\) or \(n \+ 1, Q, F\)"),
        ("table", r"table: want torch.float32 \("),
        ("labelprop_vector", "needs a matrix batch"),
        ("strided", "X must be contiguous"),
    ],
)
def test_batch_wrapper_refuses_without_launching(change, err):
    sched, X, ep = _batch_case()
    if change == "four_axes":
        X = torch.rand((sched.n_slots, 2, 4, 1))
    elif change == "table":
        ep = Epilogue(ADD_TABLE, table=torch.rand((sched.n_slots, 2)))
    elif change == "labelprop_vector":
        X = torch.rand((sched.n_slots, 2))
        ep = Epilogue.labelprop(torch.zeros((sched.n_slots, 2, 4)), 0.9)
    elif change == "strided":
        X = torch.rand((sched.n_slots, 2, 8))[:, :, ::2]
    launches = (fused_batch_round_cuda.launches, fused_round_cuda.launches)
    with pytest.raises(ValueError, match=err):
        fused_batch_round_cuda(X, sched, PLUS_TIMES, ep)
    assert (fused_batch_round_cuda.launches, fused_round_cuda.launches) == launches


def test_batch_module_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch.solve.batch\n"
        "from repro_torch.solve import solve_batch, BatchStepper, multi_source_x0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
