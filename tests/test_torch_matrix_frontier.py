"""Matrix frontiers ``(n, F)`` in the port against the JAX reference.

The same numpy inputs go through both packages:

* an ``(n, 1)`` frontier runs the vector engine's arithmetic: x, rounds,
  flushes and flush_bytes equal the ``(n,)`` solve's, on both frontiers;
* rwr embeddings (``twitter`` scale 9) and label propagation (``web``
  scale 9) at F = 4 equal ``repro.Solver(backend="jit")`` bit for bit at
  sync, δ = 16 and async, and on the halo frontier (D = 4) the reference's
  ``backend="sharded", frontier="halo"`` solve, in x, rounds, flushes and
  flush_bytes;
* rwr with ``feature_dim=1`` is ppr with the matching teleport;
* the plain labelprop row update equals the reference's jitted one on 10⁶
  values: XLA computes ``mix·(reduced/safe) + (1-mix)·old`` as one FMA;
* the plain halo round at F = 4 equals the reference's
  ``frontier_pallas_round_fn`` in interpret mode at D = 4, in x and ef, for
  f32, int8 and fp8 (one scale a feature);
* a matrix round equals F vector rounds, one a column;
* the CUDA wrappers raise on CPU tensors, layouts they do not take and
  wrong shapes, without counting a launch.

The reference at D = 4 runs in a subprocess with four fake CPU devices (the
device count is fixed when jax starts).  Only ``x[:-1]`` and the local
frontiers' non-dump slots are compared: dump values are unspecified.
"""

import os
import subprocess
import sys
import textwrap
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.solve as j_solve  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core.semiring import MIN_PLUS as J_MIN_PLUS  # noqa: E402
from repro.core.semiring import PLUS_TIMES as J_PLUS_TIMES  # noqa: E402
from repro.graphs import formats as j_formats  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
import repro_torch.solve as t_solve  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.semiring import MIN_PLUS, PLUS_TIMES  # noqa: E402
from repro_torch.dist import engine_sharded as t_sharded  # noqa: E402
from repro_torch.graphs import formats as t_formats  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.round_block import (  # noqa: E402
    ADD_CONST,
    ADD_TABLE,
    LABELPROP,
    MIN_OLD,
    Epilogue,
    fma_f32,
    fused_halo_round_cuda,
    fused_round_cuda,
)

REPO = Path(__file__).resolve().parents[1]
P = 8
MIN_CHUNK = 16  # so that async (δ = 16) differs from sync at these sizes
F = 4
DELTAS = ["sync", 16, "async"]
# The graph each matrix problem runs on, and its factory in both packages.
MATRIX = {
    "rwr": ("twitter", "rwr_embedding_problem"),
    "labelprop": ("web", "label_propagation_problem"),
}


def _graph_pair(graph, kind="pagerank"):
    return (
        j_gen.make_graph(graph, scale=9, efactor=8, kind=kind),
        t_gen.make_graph(graph, scale=9, efactor=8, kind=kind),
    )


def _matrix_solvers(name, **kw):
    graph, factory = MATRIX[name]
    jg, tg = _graph_pair(graph)
    js = j_solve.Solver(jg, getattr(j_solve, factory)(), n_workers=P, min_chunk=MIN_CHUNK, backend="jit")
    ts = t_solve.Solver(tg, getattr(t_solve, factory)(), n_workers=P, min_chunk=MIN_CHUNK, device="cpu", **kw)
    return js, ts


def _assert_same_result(want, got):
    """x bit for bit, and the counters; ``want`` may be a reference result or
    the dict the D = 4 subprocess saved."""
    if isinstance(want, dict):
        counters = tuple(int(want[k]) for k in ("rounds", "flushes", "flush_bytes"))
        x = want["x"]
    else:
        counters = (want.rounds, want.flushes, want.flush_bytes)
        x = np.asarray(want.x)
    assert (got.rounds, got.flushes, got.flush_bytes) == counters
    assert got.x.shape == x.shape
    np.testing.assert_array_equal(got.x.view(np.int32), x.view(np.int32))


# --------------------------------------------------------------------------- #
# (a) (n, 1) is the vector engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("delta", ["sync", 24])
@pytest.mark.parametrize("frontier", ["replicated", "halo"])
@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_one_column_frontier_equals_vector_engine(name, frontier, delta):
    graph, kind = ("twitter", "pagerank") if name == "pagerank" else ("kron", "sssp")
    g = t_gen.make_graph(graph, scale=9, efactor=8, kind=kind)
    problem = t_solve.pagerank_problem() if name == "pagerank" else t_solve.sssp_problem()
    solver = t_solve.Solver(g, problem, n_workers=P, min_chunk=MIN_CHUNK, frontier=frontier,
                            n_shards=4, device="cpu")
    vec = solver.solve(delta=delta)
    col = solver.solve(problem.x0(g)[:, None], delta=delta)
    assert vec.rounds > 1 and col.x.shape == (g.n, 1)
    assert (col.rounds, col.flushes, col.flush_bytes) == (vec.rounds, vec.flushes, vec.flush_bytes)
    np.testing.assert_array_equal(col.x[:, 0], vec.x)


# --------------------------------------------------------------------------- #
# (b) rwr and labelprop against the reference's solves
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("name", list(MATRIX))
def test_matrix_solve_equals_reference_jit(name, delta):
    js, ts = _matrix_solvers(name)
    jr, tr = js.solve(delta=delta), ts.solve(delta=delta)
    assert tr.rounds > 1 and tr.x.shape == (ts.graph.n, F)
    assert tr.flush_bytes == tr.flushes * P * tr.delta * 4 * F
    _assert_same_result(jr, tr)


def test_rwr_one_column_equals_ppr():
    """``feature_dim=1`` with a single-seed restart column is ppr with that
    seed's teleport, on both frontiers."""
    g = t_gen.make_graph("twitter", scale=9, efactor=8, kind="pagerank")
    for frontier in ("replicated", "halo"):
        kw = dict(n_workers=P, min_chunk=MIN_CHUNK, frontier=frontier, n_shards=4, device="cpu")
        rwr = t_solve.Solver(g, t_solve.rwr_embedding_problem(feature_dim=1), **kw)
        ppr = t_solve.Solver(g, t_solve.ppr_problem(), **kw)
        a = rwr.solve(q=t_solve.rwr_restart(g, [7]), delta=24)
        b = ppr.solve(q=t_solve.ppr_teleport(g, [7])[0], delta=24)
        assert a.x.shape == (g.n, 1) and a.rounds > 1
        assert (a.rounds, a.flushes, a.flush_bytes) == (b.rounds, b.flushes, b.flush_bytes)
        np.testing.assert_array_equal(a.x[:, 0], b.x)


def test_vector_table_spreads_over_matrix_frontier():
    """ppr's ``(n,)`` teleport on an ``(n, 2)`` x0: the reference broadcasts
    the table over the columns (``_match_features``), the port repeats it
    (``Epilogue.for_frontier``)."""
    jg, tg = _graph_pair("twitter")
    x0 = np.random.default_rng(3).random((tg.n, 2)).astype(np.float32) / tg.n
    js = j_solve.Solver(jg, j_solve.ppr_problem(), n_workers=P, min_chunk=MIN_CHUNK, backend="jit")
    ts = t_solve.Solver(tg, t_solve.ppr_problem(), n_workers=P, min_chunk=MIN_CHUNK, device="cpu")
    _assert_same_result(js.solve(x0, delta=24), ts.solve(x0, delta=24))


def test_query_shape_is_checked():
    _, ts = _matrix_solvers("rwr")
    n = ts.graph.n
    with pytest.raises(ValueError, match=rf"q must have shape \({n},\) or \({n}, {F}\)"):
        ts.solve(q=np.zeros((n, F + 1), np.float32), delta="sync")
    with pytest.raises(ValueError, match="does not fit"):  # a labelprop table on a vector frontier
        t_solve.Solver(ts.graph, t_solve.label_propagation_problem(), n_workers=P,
                       device="cpu").solve(np.full(n, 0.25, np.float32), delta="sync")


# --------------------------------------------------------------------------- #
# (c) the labelprop row update: one FMA, as XLA computes it
# --------------------------------------------------------------------------- #
def _exact_fma_f32(a, b, c) -> np.float32:
    """``a·b + c`` rounded once to float32 (nearest, ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.array(v).view(np.int32)) & 1))


def test_plain_labelprop_row_update_equals_reference_fma():
    """10⁶ values (2¹⁸ rows of F = 4) over 38 binades, with rows whose total
    is 0, anchored rows and dump rows (``rows == n``), plus rows where the
    blend lies next to a float32 midpoint, so that rounding the float64 sum
    of ``mix·q`` and ``(1-mix)·old`` (two roundings) would be wrong there."""
    rng = np.random.default_rng(17)
    n = 1 << 18
    reduced = (rng.random((n, F)) * np.exp2(rng.integers(-30, 8, (n, F)))).astype(np.float32)
    reduced[rng.random(n) < 0.05] = 0.0
    old = (rng.random((n, F)) * np.exp2(rng.integers(-30, 2, (n, F)))).astype(np.float32)
    # mix·0.75 is a float32 midpoint; 1e-30 tips it (0.75 = 3 / (3 + 1))
    reduced[:4] = [[3, 1, 0, 0], [3, 1, 0, 0], [1, 3, 0, 0], [1, 3, 0, 0]]
    old[:4] = [[1e-30, 0, 0, 0], [-1e-30, 0, 0, 0], [0, 1e-30, 0, 0], [0, -1e-30, 0, 0]]
    anchors = np.zeros((n, F), np.float32)
    hit = rng.random(n) < 0.01
    anchors[hit, rng.integers(0, F, hit.sum())] = 1.0
    anchors[-1] = 0.0  # the reference's dump rows read row n - 1 (clamped)
    rows = rng.integers(0, n, n).astype(np.int32)
    rows[rng.random(n) < 0.02] = n  # dump rows
    rows[:4] = np.arange(4) + 8
    anchors[8:12] = 0.0

    j_update = j_solve.label_propagation_problem(feature_dim=F).make_row_update(None)
    want = np.asarray(jax.jit(j_update)(old, reduced, rows, anchors))
    t_update = t_solve.label_propagation_problem(feature_dim=F).make_row_update(None, anchors, "cpu")
    assert t_update.tag == LABELPROP
    got = t_update(torch.as_tensor(old), torch.as_tensor(reduced), torch.as_tensor(rows).long()).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

    # the midpoint rows: one rounding, which two would miss
    mix, rest = t_update.mix, t_update.one_minus_mix * old[:4, :2]
    q = reduced[:4, :2] / reduced[:4, :2].sum(axis=1, keepdims=True)
    once = np.array([[_exact_fma_f32(mix, a, c) for a, c in zip(qr, rr)] for qr, rr in zip(q, rest)])
    twice = (q.astype(np.float64) * np.float64(mix) + rest.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got[:4, :2].view(np.int32), once.view(np.int32))
    assert (twice != once).any()
    emulated = fma_f32(torch.tensor(mix), torch.as_tensor(q), torch.as_tensor(rest)).numpy()
    np.testing.assert_array_equal(emulated.view(np.int32), once.view(np.int32))


def test_labelprop_epilogue_constants_round_from_the_python_double():
    ep = t_solve.label_propagation_problem(mix=0.9).make_row_update(None, np.zeros((5, 2)), "cpu")
    assert ep.mix == np.float32(0.9) and ep.one_minus_mix == np.float32(1 - 0.9)
    assert ep.one_minus_mix != np.float32(1) - np.float32(0.9)
    assert tuple(ep.table.shape) == (6, 2) and not ep.table[-1].any()
    with pytest.raises(ValueError, match="anchors are"):
        Epilogue.labelprop(torch.zeros(6), 0.9)
    with pytest.raises(ValueError, match="mix must be in"):
        t_solve.label_propagation_problem(mix=1.5)


# --------------------------------------------------------------------------- #
# (d) a matrix round is F vector rounds
# --------------------------------------------------------------------------- #
@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(
    n=st.integers(2, 60),
    m=st.integers(0, 160),
    p=st.integers(1, 5),
    delta=st.integers(1, 12),
    feat=st.integers(1, 5),
    tag=st.sampled_from([ADD_CONST, ADD_TABLE, MIN_OLD]),
    seed=st.integers(0, 2**16),
)
def test_matrix_round_is_vector_rounds_property(n, m, p, delta, feat, tag, seed):
    """The plain matrix round against F plain vector rounds, one a column,
    bit for bit.  Against the reference's jitted ``round_fn`` only where
    p ≥ 2 and n ≥ 32: on a one-worker schedule of a few edges XLA may
    contract ``c + x·v`` into one FMA where the port rounds twice, so the
    reference's bits there depend on its fusion (ROADMAP queue C, item 1)."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    if tag == MIN_OLD:
        vals = rng.integers(1, 9, m).astype(np.int32)
        jsr, tsr = J_MIN_PLUS, MIN_PLUS
        x0 = rng.integers(0, 50, (n, feat)).astype(np.int32)
    else:
        vals = rng.random(m).astype(np.float32)
        jsr, tsr = J_PLUS_TIMES, PLUS_TIMES
        x0 = rng.random((n, feat)).astype(np.float32)
    table = rng.random((n + 1, feat)).astype(np.float32)
    table[-1] = 0.0
    c = np.float32(0.15 / n)

    def epilogue(tab):
        if tag == ADD_CONST:
            return Epilogue(ADD_CONST, const=float(c))
        if tag == ADD_TABLE:
            return Epilogue(ADD_TABLE, table=torch.as_tensor(np.ascontiguousarray(tab)))
        return Epilogue(MIN_OLD)

    tg = t_formats.CSRGraph.from_edges(n, src, dst, vals)
    ts = t_engine.make_schedule(tg, p, delta, tsr)
    x = t_engine.extend_frontier(x0, tsr, "cpu")
    out = t_engine.round_fn(ts, tsr, epilogue(table))(x)
    for f in range(feat):
        col = t_engine.round_fn(ts, tsr, epilogue(table[:, f]))(x[:, f].contiguous())
        np.testing.assert_array_equal(out[:-1, f].numpy(), col[:-1].numpy())
    if p >= 2 and n >= 32:
        jg = j_formats.CSRGraph.from_edges(n, src, dst, vals)
        js = j_engine.make_schedule(jg, p, delta, jsr)
        jt = jnp.asarray(table)

        def j_update(old, red, rows):
            if tag == ADD_CONST:
                return c + red
            if tag == ADD_TABLE:
                return jt[rows] + red
            return jnp.minimum(old, red)

        jx = j_engine.extend_frontier(jnp.asarray(x0), jsr)
        want = np.asarray(jax.jit(j_engine.round_fn(js, jsr, j_update))(jx))
        np.testing.assert_array_equal(out.numpy()[:-1], want[:-1])


# --------------------------------------------------------------------------- #
# (e) the halo frontier at D = 4 against the reference, in a subprocess
# --------------------------------------------------------------------------- #
_REFERENCE_D4 = textwrap.dedent(
    """
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    import repro.solve as js
    from repro.core.engine import extend_frontier, make_schedule
    from repro.core.semiring import PLUS_TIMES
    from repro.dist.compat import AxisType, make_mesh
    from repro.dist import engine_sharded as es
    from repro.graphs.generators import make_graph

    out, = sys.argv[1:]
    mesh = make_mesh((4,), ("data",), axis_types=(AxisType.Auto,), devices=jax.devices()[:4])
    res = {}
    for name, graph, factory in (("rwr", "twitter", js.rwr_embedding_problem),
                                 ("labelprop", "web", js.label_propagation_problem)):
        g = make_graph(graph, scale=9, efactor=8, kind="pagerank")
        problem = factory()
        for d in ("sync", 16, "async"):
            s = js.Solver(g, problem, n_workers=8, min_chunk=16, backend="sharded", frontier="halo")
            r = s.solve(delta=d)
            for k in ("rounds", "flushes", "flush_bytes"):
                res[f"{name}_solve_{d}_{k}"] = np.asarray(getattr(r, k))
            res[f"{name}_solve_{d}_x"] = np.asarray(r.x)
        sg = g.with_values(problem.edge_values(g)) if problem.edge_values else g
        sched = make_schedule(sg, 8, 24, PLUS_TIMES, mode="delayed", min_chunk=16)
        plan = es.make_frontier_plan(sched, 4)
        q = jnp.asarray(problem.default_query(g))
        x0 = np.random.default_rng(4).random((g.n, 4)).astype(np.float32)
        args = es.frontier_plan_args(sched, plan)
        for hd in ("f32", "int8", "fp8"):
            rnd = jax.jit(es.frontier_pallas_round_ext_fn(
                sched, plan, PLUS_TIMES, problem.make_row_update(g), mesh,
                halo_dtype=hd, interpret=True, feature_dims=1))
            x, ef = extend_frontier(jnp.asarray(x0), PLUS_TIMES), es.frontier_ef_init(plan, (4,))
            for k in range(3):
                x, ef = rnd(x, ef, q, *args)
                res[f"{name}_{hd}_x{k}"] = np.asarray(x)
                res[f"{name}_{hd}_ef{k}"] = np.asarray(ef)
    np.savez(out, **res)
    """
)


@pytest.fixture(scope="module")
def reference_d4(tmp_path_factory):
    """The reference on a 4-wide mesh of fake CPU devices, in its own
    process: sharded halo solves of rwr and labelprop at each δ, and its
    fused halo round at F = 4 (x and ef after each of three rounds, for
    every wire)."""
    out = tmp_path_factory.mktemp("matrix_reference_d4") / "reference.npz"
    env = dict(
        os.environ,
        PYTHONPATH=str(REPO / "src"),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_D4, str(out)],
        env=env, capture_output=True, text=True, timeout=400,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("name", list(MATRIX))
def test_matrix_halo_solve_equals_reference_sharded_halo(reference_d4, name, delta):
    _, ts = _matrix_solvers(name, frontier="halo", n_shards=4)
    tr = ts.solve(delta=delta)
    want = {k: reference_d4[f"{name}_solve_{delta}_{k}"] for k in ("rounds", "flushes", "flush_bytes", "x")}
    _assert_same_result(want, tr)
    assert ts.stats["plan_builds"] == 1


@pytest.mark.parametrize("name", list(MATRIX))
def test_plain_halo_round_equals_reference_fused_round_on_four_shards(reference_d4, name):
    """K2's plain version on (D, L, F): x and the (D, S, H, F) residuals of
    each wire, three rounds, against the reference's Pallas halo round with
    one scale per (shard, step, feature)."""
    graph, factory = MATRIX[name]
    g = t_gen.make_graph(graph, scale=9, efactor=8, kind="pagerank")
    problem = getattr(t_solve, factory)()
    sg = g.with_values(problem.edge_values(g)) if problem.edge_values else g
    ts = t_engine.make_schedule(sg, P, 24, PLUS_TIMES, mode="delayed", min_chunk=MIN_CHUNK)
    tp = t_sharded.make_frontier_plan(ts, 4)
    ep = problem.make_row_update(g, problem.default_query(g), "cpu")
    x0 = np.random.default_rng(4).random((g.n, F)).astype(np.float32)
    for hd in ("f32", "int8", "fp8"):
        rnd = t_sharded.frontier_kernel_round_ext_fn(ts, tp, PLUS_TIMES, ep, hd)
        x, ef = t_engine.extend_frontier(x0, PLUS_TIMES, "cpu"), t_sharded.frontier_ef_init(tp, (F,))
        for k in range(3):
            x, ef = rnd(x, ef)
            np.testing.assert_array_equal(x.numpy()[:-1], reference_d4[f"{name}_{hd}_x{k}"][:-1], err_msg=hd)
            np.testing.assert_array_equal(ef.numpy(), reference_d4[f"{name}_{hd}_ef{k}"], err_msg=hd)
        assert ef.any() == (hd != "f32")


# --------------------------------------------------------------------------- #
# (f) the wrappers: what the kernels take
# --------------------------------------------------------------------------- #
def _k1_case():
    g = t_gen.make_graph("twitter", scale=9, efactor=8, kind="pagerank")
    ts = t_engine.make_schedule(g, P, 24, PLUS_TIMES, mode="delayed", min_chunk=MIN_CHUNK)
    x = torch.rand((g.n + 1, F))
    ep = Epilogue(ADD_TABLE, table=torch.rand((g.n + 1, F)))
    return ts, x, ep


def _misaligned(shape):
    """A contiguous float32 tensor that starts 4 bytes past a 16-byte line."""
    flat = torch.empty(int(np.prod(shape)) + 4)
    off = (-(flat.data_ptr() // 4) % 4) + 1
    return flat[off : off + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize(
    "change,err",
    [
        ("cpu", "CUDA tensors"),
        ("three_axes", r"rows of shape \(\) or \(F,\)"),
        ("table", r"table: want torch.float32 \("),
        ("labelprop_vector", "needs a matrix frontier"),
        ("misaligned", "16-byte aligned"),
        ("strided", "x_ext must be contiguous"),
    ],
)
def test_round_wrapper_rejects_matrix_layouts_without_launching(change, err):
    ts, x, ep = _k1_case()
    if change == "three_axes":
        x = torch.rand((ts.n_slots, F, 2))
    elif change == "table":
        ep = Epilogue(ADD_TABLE, table=torch.rand((ts.n_slots, F + 1)))
    elif change == "labelprop_vector":
        x = torch.rand(ts.n_slots)
        ep = Epilogue.labelprop(torch.zeros((ts.n_slots, F)), 0.9)
    elif change == "misaligned":
        x = _misaligned((ts.n_slots, F))
    elif change == "strided":
        x = torch.rand((ts.n_slots, 2 * F))[:, ::2]
    launches = fused_round_cuda.launches
    with pytest.raises(ValueError, match=err):
        fused_round_cuda(x, ts, PLUS_TIMES, ep)
    assert fused_round_cuda.launches == launches


@pytest.mark.parametrize(
    "change,err",
    [
        ("cpu", "CUDA tensors"),
        ("ef", r"ef: want torch.float32 \(4, "),
        ("x_loc", r"x_loc: want torch.float32 \(4, "),
        ("scales", "at most 512 scales"),
        ("misaligned", "16-byte aligned"),
    ],
)
def test_halo_round_wrapper_rejects_matrix_layouts_without_launching(change, err):
    ts, x, ep = _k1_case()
    tp = t_sharded.make_frontier_plan(ts, 4)
    feat = (F,)
    x_loc = tp.scatter_x(x)
    ef = t_sharded.frontier_ef_init(tp, feat)
    if change == "ef":
        ef = t_sharded.frontier_ef_init(tp)
    elif change == "x_loc":
        x_loc = x_loc[:, :-1].contiguous()
    elif change == "scales":
        feat = (200,)
        x_loc = torch.rand((tp.D, tp.L) + feat)
        ef = t_sharded.frontier_ef_init(tp, feat)
        ep = Epilogue(ADD_TABLE, table=torch.rand((ts.n_slots,) + feat))
    elif change == "misaligned":
        x_loc = _misaligned(tuple(x_loc.shape))
    launches = fused_halo_round_cuda.launches
    with pytest.raises(ValueError, match=err):
        fused_halo_round_cuda(x_loc, ef, ts, tp, PLUS_TIMES, ep, "int8")
    assert fused_halo_round_cuda.launches == launches


def test_cpu_tensors_take_the_plain_rounds():
    """``ops`` sends a CPU matrix frontier to the plain versions, and the CUDA
    wrappers count no launch."""
    ts, x, ep = _k1_case()
    tp = t_sharded.make_frontier_plan(ts, 4)
    k1, k2 = fused_round_cuda.launches, fused_halo_round_cuda.launches
    assert torch.equal(ops.fused_round(x, ts, PLUS_TIMES, ep), ref.fused_round_ref(x, ts, PLUS_TIMES, ep))
    a, b = tp.scatter_x(x), tp.scatter_x(x)
    ef_a, ef_b = t_sharded.frontier_ef_init(tp, (F,)), t_sharded.frontier_ef_init(tp, (F,))
    ops.fused_halo_round(a, ef_a, ts, tp, PLUS_TIMES, ep, "fp8")
    ref.fused_halo_round_ref(b, ef_b, ts, tp, PLUS_TIMES, ep, "fp8")
    assert torch.equal(a, b) and torch.equal(ef_a, ef_b) and ef_a.any()
    assert (fused_round_cuda.launches, fused_halo_round_cuda.launches) == (k1, k2)


def test_plan_dump_last_is_the_last_dump_entry():
    """``FrontierPlan.dump_last``: per (step, receiving shard), the last
    ``recv_idx`` entry in ``(d, k)`` order that lands in the dump slot."""
    ts, _, _ = _k1_case()
    tp = t_sharded.make_frontier_plan(ts, 4)
    recv = tp.recv_idx.numpy()
    for s in range(tp.S):
        for e in range(tp.D):
            hits = np.flatnonzero(recv[s, e] == tp.L - 1)
            assert tp.dump_last[s, e] == (hits[-1] if hits.size else -1)
    assert tp.dump_last.dtype == torch.int32 and (tp.dump_last >= 0).any()
