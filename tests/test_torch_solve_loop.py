"""The fused solve loop of the port against the reference's ``jit`` backend.

The reference runs a replicated solve as one ``lax.while_loop``
(``make_solve_fn_q``): an f32 residual against an f32 ``tol``, and a result
with the final residual alone and no per-round times.  The port's
replicated ``Solver.solve`` runs K1's loop entry on the card and its plain
loop (``ref.fused_solve_ref``) on the CPU.  Here, on the CPU, with the same
numpy inputs in both packages:

* ``Solver.solve`` (``backend="kernel"`` and ``"torch"``) for pagerank, ppr,
  sssp, cc and jacobi at sync, async and δ = 24, and rwr and labelprop at
  F = 4 at sync and δ = 16: x bit for bit; rounds, converged, flushes and
  flush_bytes exactly; one residual, and no round times;
* the round budget (``max_rounds`` 0 and 3), and a Python ``tol`` whose
  float32 rounds up onto a round's residual (the port stops on the
  reference's round; the host loop, comparing in float64, does not);
* the halo path keeps the host loop: one residual and one time a round;
* ``solve_batch`` (with compaction) and ``BatchStepper`` quanta against
  ``repro.solve.batch``, one loop call a compaction chunk and a quantum;
* the plain loop equals the host loop on the same rounds;
* the loop entry's refusals, with no launch counted, and the imports.

The residual: an l1 residual sums n non-negative float32 terms, here in
torch's order and there in XLA's.  Each order's result lies within
(n - 1)·2⁻²⁴ of the exact sum (relative), so the two lie within
2·n·2⁻²⁴ of each other; that is the tolerance (``_res_rtol``).  A
count-changed residual is a sum of ones, exact below 2²⁴, and is compared
exactly.  No residual of these inputs lies within that gap of ``tol``, so the
rounds are compared exactly.
"""

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
from repro_torch.graphs import formats as t_formats  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.round_block import (  # noqa: E402
    ADD_CONST,
    MIN_OLD,
    Epilogue,
    fused_batch_round_cuda,
    fused_batch_solve_cuda,
    fused_round_cuda,
    fused_solve_cuda,
)
from repro_torch.solve.problem import count_changed_residual, l1_residual  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
P = 4
MIN_CHUNK = 16
DELTAS = ["sync", "async", 24]
BACKENDS = ["kernel", "torch"]
# vector problems: (graph, kind, factory); matrix problems at F = 4
VECTOR = {
    "pagerank": ("twitter", "pagerank", "pagerank_problem"),
    "ppr": ("twitter", "pagerank", "ppr_problem"),
    "sssp": ("kron", "sssp", "sssp_problem"),
    "cc": ("kron", "sssp", "cc_problem"),
}
MATRIX = {
    "rwr": ("twitter", "pagerank", "rwr_embedding_problem"),
    "labelprop": ("web", "pagerank", "label_propagation_problem"),
}


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


def _solvers(name, n_workers=P, min_chunk=MIN_CHUNK, scale=9, **kw):
    """(reference ``jit`` solver, port solver on the CPU) on one graph."""
    if name == "jacobi":
        (jg, jp), (tg, tp) = _jacobi_pair()
    else:
        graph, kind, factory = {**VECTOR, **MATRIX}[name]
        jg = j_gen.make_graph(graph, scale=scale, efactor=8, kind=kind)
        tg = t_gen.make_graph(graph, scale=scale, efactor=8, kind=kind)
        jp, tp = getattr(j_solve, factory)(), getattr(t_solve, factory)()
    common = dict(n_workers=n_workers, min_chunk=min_chunk)
    js = j_solve.Solver(jg, jp, backend="jit", **common)
    ts = t_solve.Solver(tg, tp, device="cpu", **common, **kw)
    return js, ts


def _res_rtol(values: int) -> float:
    """Two float32 sums of ``values`` non-negative terms in two orders."""
    return 2 * values * 2.0**-24


def _assert_fused_result(jr, tr, values):
    """The reference's fused result: x bit for bit, the counters exactly,
    one residual (within ``_res_rtol``; exact for a count) and no times."""
    assert (tr.rounds, tr.converged, tr.flushes, tr.flush_bytes, tr.delta, tr.P) == (
        jr.rounds, jr.converged, jr.flushes, jr.flush_bytes, jr.delta, jr.P
    )
    x = np.asarray(jr.x)
    assert tr.x.shape == x.shape
    np.testing.assert_array_equal(tr.x.view(np.int32), x.view(np.int32))
    assert len(jr.residuals) == len(tr.residuals) == 1
    assert tr.round_times_s == jr.round_times_s == []
    if tr.x.dtype == np.int32:
        assert tr.residuals == jr.residuals
    else:
        np.testing.assert_allclose(tr.residuals[0], jr.residuals[0], rtol=_res_rtol(values))


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("name", ["pagerank", "ppr", "sssp", "cc", "jacobi"])
def test_replicated_solve_equals_reference_fused_loop(name, delta):
    js, ts = _solvers(name)
    jr = js.solve(delta=delta)
    for backend in BACKENDS:
        tr = ts.solve(delta=delta, backend=backend)
        assert tr.rounds > 1
        _assert_fused_result(jr, tr, ts.graph.n)


@pytest.mark.parametrize("delta", ["sync", 16])
@pytest.mark.parametrize("name", list(MATRIX))
def test_matrix_solve_equals_reference_fused_loop(name, delta):
    js, ts = _solvers(name, n_workers=8)
    jr = js.solve(delta=delta)
    for backend in BACKENDS:
        tr = ts.solve(delta=delta, backend=backend)
        assert tr.rounds > 1 and tr.x.shape == (ts.graph.n, 4)
        _assert_fused_result(jr, tr, ts.graph.n * 4)


@pytest.mark.parametrize("max_rounds", [0, 3])
@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_round_budget_equals_reference(name, max_rounds):
    """``max_rounds`` 0 runs no round (residual inf, not converged), 3 stops
    unconverged after three, as the reference's while-loop does."""
    js, ts = _solvers(name)
    jr = js.solve(delta=24, max_rounds=max_rounds)
    for backend in BACKENDS:
        tr = ts.solve(delta=24, max_rounds=max_rounds, backend=backend)
        assert tr.rounds == max_rounds and not tr.converged
        _assert_fused_result(jr, tr, ts.graph.n)
        if max_rounds == 0:
            assert tr.residuals == [np.inf]
            np.testing.assert_array_equal(tr.x, ts.problem.x0(ts.graph))


def _tie(residuals):
    """A round j whose residual m is below every earlier one and positive, and
    a Python tol just below m whose float32 is m."""
    for j, m in enumerate(residuals):
        if 0 < m < min(residuals[:j], default=np.inf) and j > 0:
            tol = m * (1 - 2.0**-26)
            assert tol < m and np.float32(tol) == np.float32(m)
            return j + 1, tol
    raise AssertionError(f"no tie round in {residuals}")


@pytest.mark.parametrize("name", ["sssp", "cc"])
def test_float32_tol_stops_on_the_reference_round(name):
    """Queue C item 2: with a Python tol whose float32 rounds up onto a
    round's (count-changed, exact) residual, the reference's fused loop stops
    on that round (``res <= float32(tol)``), and so does the port; the host
    loop compares in float64 and runs on."""
    js, ts = _solvers(name)
    sched = ts.schedule(24)
    host = t_engine.host_loop(
        t_engine.round_fn(sched, ts.problem.semiring, ts.row_update()),
        sched,
        ts.problem.semiring,
        ts._x_ext(None),
        ts.problem.residual,
        -1.0,
        40,
    )
    stop, tol = _tie(host.residuals)
    jr = js.solve(delta=24, tol=tol)
    assert jr.rounds == stop and jr.converged
    for backend in BACKENDS:
        tr = ts.solve(delta=24, tol=tol, backend=backend)
        _assert_fused_result(jr, tr, ts.graph.n)
    again = t_engine.host_loop(
        t_engine.round_fn(sched, ts.problem.semiring, ts.row_update()),
        sched, ts.problem.semiring, ts._x_ext(None), ts.problem.residual, tol, 40,
    )
    assert again.rounds > stop


def test_halo_solve_keeps_the_host_loop():
    """The reference's halo solves run its host loop: one residual and one
    wall time a round."""
    for backend in BACKENDS:
        _, ts = _solvers("pagerank", frontier="halo", n_shards=2)
        r = ts.solve(delta=24, backend=backend)
        assert r.rounds > 1 and len(r.residuals) == len(r.round_times_s) == r.rounds
        rep = ts.solve(delta=24, backend=backend, frontier="replicated")
        assert (r.rounds, r.flushes) == (rep.rounds, rep.flushes)
        np.testing.assert_array_equal(r.x, rep.x)
        np.testing.assert_allclose(r.residuals[-1], rep.residuals[0], rtol=_res_rtol(ts.graph.n))


@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_plain_loop_equals_host_loop(name):
    """Where no residual ties tol, the plain fused loop stops on the host
    loop's round, with its x and its last residual."""
    _, ts = _solvers(name)
    sr, sched = ts.problem.semiring, ts.schedule("async")
    x = ts._x_ext(None)
    host = t_engine.host_loop(
        t_engine.round_fn(sched, sr, ts.row_update()), sched, sr, x, ts.problem.residual, ts.tol, 500
    )
    out, res, rounds, converged = ref.fused_solve_ref(
        x, sched, sr, ts.row_update(), ts.problem.residual, ts.tol, 500
    )
    assert (rounds, converged) == (host.rounds, host.converged) and rounds > 1
    assert isinstance(res, np.float32) and res == np.float32(host.residuals[-1])
    np.testing.assert_array_equal(out[:-1].numpy(), host.x)


def test_solver_makes_one_loop_call_a_solve(monkeypatch):
    """A replicated solve is one call of the loop (the kernel backend through
    ``ops.fused_solve``), never a round at a time; the CPU never launches."""
    _, ts = _solvers("pagerank")
    calls = []
    plain = ref.fused_solve_ref
    monkeypatch.setattr(ref, "fused_solve_ref", lambda *a: calls.append(a[-2:]) or plain(*a))
    monkeypatch.setattr(ref, "fused_round_ref", lambda *a: pytest.fail("a single round ran"))
    launches = (fused_solve_cuda.launches, fused_round_cuda.launches)
    for backend in BACKENDS:
        r = ts.solve(delta=24, backend=backend, tol=1e-3, max_rounds=50)
        assert r.converged
    assert calls == [(1e-3, 50), (1e-3, 50)]
    assert (fused_solve_cuda.launches, fused_round_cuda.launches) == launches


# --------------------------------------------------------------------------- #
# batches: one loop call a compaction chunk, one a quantum
# --------------------------------------------------------------------------- #
def _count_batch_loops(monkeypatch):
    calls = []
    plain = ref.fused_batch_solve_ref
    monkeypatch.setattr(ref, "fused_batch_solve_ref", lambda *a: calls.append(a[6]) or plain(*a))
    return calls


@pytest.mark.parametrize("compact_every", [None, 2])
@pytest.mark.parametrize("name", ["ppr", "sssp"])
def test_solve_batch_equals_reference(monkeypatch, name, compact_every):
    js, ts = _solvers(name)
    rng = np.random.default_rng(4)
    seeds = rng.choice(ts.graph.n, 4, replace=False)
    if name == "sssp":
        x0, q = j_solve.multi_source_x0(js.graph, seeds), None
    else:
        x0, q = np.full((4, ts.graph.n), 1.0 / ts.graph.n, np.float32), j_solve.ppr_teleport(js.graph, seeds)
    want = js.solve_batch(x0, q=q, delta=24, compact_every=compact_every)
    calls = _count_batch_loops(monkeypatch)
    for backend in BACKENDS:
        got = ts.solve_batch(x0, q=q, delta=24, compact_every=compact_every, backend=backend)
        assert (got.rounds, got.flushes, got.flush_bytes, got.compactions) == (
            want.rounds, want.flushes, want.flush_bytes, want.compactions
        )
        np.testing.assert_array_equal(got.rounds_per_query, np.asarray(want.rounds_per_query))
        np.testing.assert_array_equal(got.converged, np.asarray(want.converged))
        np.testing.assert_array_equal(got.x.view(np.int32), np.asarray(want.x).view(np.int32))
        np.testing.assert_allclose(got.residuals, np.asarray(want.residuals), rtol=_res_rtol(ts.graph.n))
    chunks = -(-want.rounds // compact_every) if compact_every else 1
    assert calls == [compact_every or ts.max_rounds] * chunks * 2


def test_stepper_quanta_equal_reference(monkeypatch):
    """Staggered ppr admissions, a quantum of 3 rounds: each retired row
    equals the reference stepper's, and each quantum is one loop call."""
    jg = j_gen.make_graph("twitter", scale=8, efactor=8, kind="pagerank")
    tg = t_gen.make_graph("twitter", scale=8, efactor=8, kind="pagerank")
    kw = dict(n_workers=4, delta=32, min_chunk=8)
    js = j_solve.Solver(jg, j_solve.ppr_problem(), backend="jit", **kw)
    ts = t_solve.Solver(tg, t_solve.ppr_problem(), device="cpu", **kw)
    calls = _count_batch_loops(monkeypatch)
    rows = []
    for cls, solver in ((j_solve.BatchStepper, js), (t_solve.BatchStepper, ts)):
        st = cls(solver, capacity=3)
        done = {}
        for s in (3, 11, 40, 57):
            while not st.free_slots:
                done.update((r.tag, r) for r in st.run(3))
            st.admit(np.full(solver.graph.n, 1.0 / solver.graph.n, np.float32),
                     q=j_solve.ppr_teleport(js.graph, [s])[0], tag=s)
            done.update((r.tag, r) for r in st.run(3))
        while st.occupancy:
            done.update((r.tag, r) for r in st.run(3))
        rows.append((st, done))
    (jst, want), (tst, got) = rows
    assert set(got) == set(want) == {3, 11, 40, 57}
    for s in want:
        assert (got[s].rounds, got[s].converged) == (want[s].rounds, want[s].converged)
        np.testing.assert_array_equal(got[s].x.view(np.int32), np.asarray(want[s].x).view(np.int32))
        np.testing.assert_allclose(got[s].residual, want[s].residual, rtol=_res_rtol(ts.graph.n))
    assert (tst.quanta, tst.rounds_executed, tst.flushes) == (jst.quanta, jst.rounds_executed, jst.flushes)
    assert calls == [3] * tst.quanta


def test_open_batch_freezes_converged_rows():
    """``conv0`` rows never change, and a row stops changing, state and
    residual, at its first convergence; a closed batch iterates it on."""
    _, ts = _solvers("ppr")
    sr, sched = ts.problem.semiring, ts.schedule(24)
    n = ts.graph.n
    seeds = [3, 40, 77]
    ep = ts.batch_row_update(j_solve.ppr_teleport(ts.graph, seeds), 3, ())
    X = t_engine.extend_frontier(np.full((n, 3), 1.0 / n, np.float32), sr, "cpu")
    X[:-1, 1] = torch.rand(n, generator=torch.Generator().manual_seed(0))
    conv0 = np.array([False, True, False])
    Xo, res, rounds, conv, rpq = ref.fused_batch_solve_ref(X, sched, sr, ep, l1_residual, 1e-4, 200, conv0)
    assert torch.equal(Xo[:-1, 1], X[:-1, 1]) and res[1] == np.inf and rpq[1] == 0
    assert conv.all() and rounds == max(rpq)
    Xc, res_c, rounds_c, conv_c, rpq_c = ref.fused_batch_solve_ref(X, sched, sr, ep, l1_residual, 1e-4, 200)
    np.testing.assert_array_equal(rpq_c[[0, 2]], rpq[[0, 2]])
    for i in (0, 2):  # a frozen row is its own solve stopped at its first convergence
        ep_i = ts.row_update(j_solve.ppr_teleport(ts.graph, [seeds[i]])[0])
        own = ref.fused_solve_ref(X[:, i].contiguous(), sched, sr, ep_i, l1_residual, 1e-4, 200)
        assert own[2] == rpq[i]
        np.testing.assert_allclose(own[1], res[i], rtol=_res_rtol(n))
        assert torch.equal(Xo[:-1, i], own[0][:-1])
        if rpq[i] < rounds_c:  # the closed batch ran it further
            assert not torch.equal(Xc[:-1, i], own[0][:-1])


# --------------------------------------------------------------------------- #
# refusals and imports
# --------------------------------------------------------------------------- #
def _loop_case():
    g = t_gen.make_graph("twitter", scale=8, efactor=8, kind="pagerank")
    sched = t_engine.make_schedule(g, P, 24, PLUS_TIMES, min_chunk=MIN_CHUNK)
    x = t_engine.extend_frontier(np.full(g.n, 1.0 / g.n, np.float32), PLUS_TIMES, "cpu")
    return g, sched, x, Epilogue(ADD_CONST, const=float(np.float32(0.15 / g.n)))


@pytest.mark.parametrize(
    "change,err",
    [
        ("cpu", "CUDA tensors"),
        ("residual", "computes l1_residual"),
        ("l1_int", "computes l1_residual"),
        ("table", "no add_const epilogue for torch.int32"),
        ("shape", r"x_ext: want torch.float32"),
    ],
)
def test_loop_entry_refuses_without_launching(change, err):
    g, sched, x, ep = _loop_case()
    sr, residual = PLUS_TIMES, l1_residual
    if change == "residual":
        residual = lambda a, b: torch.sum(torch.abs(b - a))  # noqa: E731
    elif change == "l1_int":
        sr, x = MIN_PLUS, x.to(torch.int32)
    elif change == "table":
        sr, x, residual = MIN_PLUS, x.to(torch.int32), count_changed_residual
    elif change == "shape":
        x = x[:-1]
    launches = (fused_solve_cuda.launches, fused_round_cuda.launches)
    with pytest.raises(ValueError, match=err):
        fused_solve_cuda(x, sched, sr, ep, residual, 1e-4, 10)
    assert (fused_solve_cuda.launches, fused_round_cuda.launches) == launches


@pytest.mark.parametrize(
    "change,err",
    [("cpu", "CUDA tensors"), ("conv0", r"conv0 must have shape \(2,\)"), ("residual", "computes l1_residual")],
)
def test_batch_loop_entry_refuses_without_launching(change, err):
    g, sched, x, ep = _loop_case()
    X = x[:, None].expand(-1, 2).contiguous()
    residual, conv0 = l1_residual, None
    if change == "conv0":
        conv0 = np.zeros(3, bool)
    elif change == "residual":
        residual = lambda a, b, dim=None: torch.sum(b != a, dim=dim)  # noqa: E731
    launches = (fused_batch_solve_cuda.launches, fused_batch_round_cuda.launches)
    with pytest.raises(ValueError, match=err):
        fused_batch_solve_cuda(X, sched, PLUS_TIMES, ep, residual, 1e-4, 10, conv0)
    assert (fused_batch_solve_cuda.launches, fused_batch_round_cuda.launches) == launches


def test_ops_sends_cpu_loops_to_the_plain_versions():
    g, sched, x, ep = _loop_case()
    launches = (fused_solve_cuda.launches, fused_batch_solve_cuda.launches)
    a = ops.fused_solve(x, sched, PLUS_TIMES, ep, l1_residual, 1e-5, 100)
    b = ref.fused_solve_ref(x, sched, PLUS_TIMES, ep, l1_residual, 1e-5, 100)
    assert torch.equal(a[0], b[0]) and a[1:] == b[1:] and a[3]
    X = x[:, None].expand(-1, 2).contiguous()
    c = ops.fused_batch_solve(X, sched, PLUS_TIMES, ep, l1_residual, 1e-5, 100, np.array([True, False]))
    assert torch.equal(c[0][:, 0], X[:, 0]) and torch.equal(c[0][:, 1], b[0])
    assert c[2] == b[2] and c[4].tolist() == [0, b[2]]
    assert (fused_solve_cuda.launches, fused_batch_solve_cuda.launches) == launches
    # MIN_OLD on an int frontier under the count residual, through ops
    xs = t_engine.extend_frontier(np.full(g.n, 5, np.int32), MIN_PLUS, "cpu")
    out = ops.fused_solve(xs, sched_int(g), MIN_PLUS, Epilogue(MIN_OLD), count_changed_residual, 0.5, 10)
    assert out[2] == 1 and out[3] and out[1] == 0


def sched_int(g):
    return t_engine.make_schedule(g.with_values(np.ones(g.nnz, np.int32)), P, 24, MIN_PLUS, min_chunk=MIN_CHUNK)


def test_port_still_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.kernels.ops, repro_torch.solve\n"
        "from repro_torch.core.engine import fused_loop\n"
        "from repro_torch.kernels.round_block import fused_solve_cuda, fused_batch_solve_cuda\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
