"""The port's ``Solver`` against ``repro.solve.Solver(backend="jit")``.

For pagerank, ppr, sssp, cc and jacobi at sync, async and a delayed δ, the
port's solve on the CPU must give the reference's ``x`` bit for bit and the
same rounds, flushes and flush_bytes; ``delta="auto"`` must pick the same δ*.
The residual is summed in another order than XLA's, so a residual within an
ulp of ``tol`` could stop the two on different rounds; these inputs are not
such a case, and the rounds are compared exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.solve as j_solve  # noqa: E402
from repro.graphs import formats as j_formats  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
import repro_torch.solve as t_solve  # noqa: E402
from repro_torch.graphs import formats as t_formats  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.kernels.round_block import fused_round_cuda  # noqa: E402

P = 4
MIN_CHUNK = 16
DELTAS = ["sync", "async", 24]


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


def _pair(name):
    """(reference graph, reference problem), (port graph, port problem)."""
    if name == "jacobi":
        return _jacobi_pair()
    graph, kind = {
        "pagerank": ("twitter", "pagerank"),
        "ppr": ("twitter", "pagerank"),
        "sssp": ("kron", "sssp"),
        "cc": ("kron", "sssp"),
    }[name]
    jg = j_gen.make_graph(graph, scale=9, efactor=8, kind=kind)
    tg = t_gen.make_graph(graph, scale=9, efactor=8, kind=kind)
    factory = {
        "pagerank": "pagerank_problem",
        "ppr": "ppr_problem",
        "sssp": "sssp_problem",
        "cc": "cc_problem",
    }[name]
    return (jg, getattr(j_solve, factory)()), (tg, getattr(t_solve, factory)())


def _solvers(name, **kw):
    (jg, jp), (tg, tp) = _pair(name)
    js = j_solve.Solver(jg, jp, n_workers=P, min_chunk=MIN_CHUNK, backend="jit", **kw)
    ts = t_solve.Solver(tg, tp, n_workers=P, min_chunk=MIN_CHUNK, device="cpu", **kw)
    return js, ts


def _assert_same_result(jr, tr):
    assert (tr.rounds, tr.flushes, tr.flush_bytes, tr.delta, tr.P) == (
        jr.rounds, jr.flushes, jr.flush_bytes, jr.delta, jr.P
    )
    assert tr.converged == jr.converged
    np.testing.assert_array_equal(np.asarray(jr.x), tr.x)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("name", ["pagerank", "ppr", "sssp", "cc", "jacobi"])
def test_solve_matches_reference_jit(name, delta):
    js, ts = _solvers(name)
    jr = js.solve(delta=delta)
    tr = ts.solve(delta=delta)
    assert tr.rounds > 1
    _assert_same_result(jr, tr)


def test_ppr_query_matches_reference():
    js, ts = _solvers("ppr")
    q = j_solve.ppr_teleport(js.graph, [3])[0]
    _assert_same_result(js.solve(q=q, delta=24), ts.solve(q=q, delta=24))


@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_auto_delta_matches_reference(name):
    js, ts = _solvers(name, delta="auto")
    assert ts.resolve_delta() == js.resolve_delta()
    assert ts.delta_model.to_dict() == js.delta_model.to_dict()
    _assert_same_result(js.solve(), ts.solve())


@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_torch_backend_matches_kernel_backend_on_cpu(name):
    _, ts = _solvers(name)
    a = ts.solve(delta=24, backend="kernel")
    b = ts.solve(delta=24, backend="torch")
    assert (a.rounds, a.flushes) == (b.rounds, b.flushes)
    np.testing.assert_array_equal(a.x, b.x)


def test_schedule_cache_and_stats():
    _, ts = _solvers("sssp")
    launches = fused_round_cuda.launches
    ts.solve(delta=24)
    ts.solve(delta=24)
    ts.solve(delta="async")
    assert ts.stats == {
        "solves": 3,
        "schedule_builds": 2,
        "plan_builds": 0,
        "stripe_builds": 0,  # no store: nothing built in stripes or loaded
        "stripe_loads": 0,
        "plan_shard_builds": 0,
        "plan_shard_loads": 0,
        "cache_loads": 0,
        "degradations": 0,  # the degradation ladder's fallbacks, as the reference counts them
    }
    assert fused_round_cuda.launches == launches  # the CPU never launches K1


def test_solver_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    (_, _), (tg, tp) = _pair("pagerank")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_solve.Solver(tg, tp)


@pytest.mark.parametrize(
    "kwargs,solve_kwargs,exc",
    [
        ({"frontier": "halo"}, {"x0": np.zeros((511, 2), np.float32)}, ValueError),
        ({}, {"frontier": "halo", "x0": np.zeros((512, 2, 2), np.float32)}, ValueError),
        ({}, {"x0": np.zeros((2, 512), np.float32)}, ValueError),
        ({}, {"x0": np.zeros(7, np.float32)}, ValueError),
        ({"backend": "pallas"}, {}, ValueError),
        ({"delta": "fast"}, {}, ValueError),
        ({}, {"q": np.zeros(512, np.float32)}, ValueError),
    ],
)
def test_unsupported_arguments_raise(kwargs, solve_kwargs, exc):
    (_, _), (tg, tp) = _pair("pagerank")
    with pytest.raises(exc):
        ts = t_solve.Solver(tg, tp, n_workers=P, device="cpu", **kwargs)
        ts.solve(delta="sync", **solve_kwargs)
