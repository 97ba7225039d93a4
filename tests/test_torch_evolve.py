"""Evolving graphs in the port against the JAX reference.

The same numpy inputs go through ``repro`` (``Solver(backend="jit")``, whose
dynamic-schedule loop replays over the patched stripes) and ``repro_torch``
on the CPU, with the reference's own cases (``_Case``: kron scale 7,
P = 4, δ = 16, three edges a batch):

* ``resolve(updates=batch)`` for pagerank, ppr, sssp, cc and jacobi ×
  insert, delete and reweight: x bit for bit (both sides run the same warm
  state over the same patched schedule, in the same order), and rounds,
  converged, flushes and flush_bytes exactly.  No l1 residual of these
  inputs lies within 2·N·2⁻²⁴ of ``tol`` (ROADMAP queue C, item 2), so the
  rounds are compared exactly;
* the port's resolve against a cold port solve on the mutated graph: bit for
  bit for min-plus, L1 ≤ 20·tol for plus-times;
* ``warm_start_state`` and both min-plus repairs against ``repro.evolve`` on
  delete and mixed batches, and the warm state never below the new fixed
  point;
* the patched schedule against a fresh build on the mutated graph with the
  same bounds and δ (padded to the same ``M``), ``row_ptr`` included: the
  kernels walk the edges through it and the plain rounds never read it;
* the caches (``schedule_builds``, ``plan_builds``), the halo resolve, the
  refusals, ``CSRGraph.apply_updates`` and the δ-model refits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.solve as j_solve  # noqa: E402
from repro.algorithms.jacobi import jacobi_graph as j_jacobi_graph  # noqa: E402
from repro.core import delta_model as j_delta_model  # noqa: E402
from repro import evolve as j_evolve  # noqa: E402
from repro.graphs import formats as j_formats  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
import repro_torch.solve as t_solve  # noqa: E402
from repro_torch import evolve as t_evolve  # noqa: E402
from repro_torch.algorithms.jacobi import jacobi_graph as t_jacobi_graph  # noqa: E402
from repro_torch.core import delta_model as t_delta_model  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.graphs import formats as t_formats  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402

NAMES = ["pagerank", "ppr", "sssp", "cc", "jacobi"]
KINDS = ["insert", "delete", "reweight"]


# --------------------------------------------------------------------------- #
# The reference's cases (tests/test_evolve.py), built in both packages from
# the same numpy inputs; a batch is a dict of op lists for ``from_ops``.
# --------------------------------------------------------------------------- #
def _edge_list(g):
    dst = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    return g.indices.astype(np.int64), dst


def _pick_edges(g, k, rng, symmetric=False):
    """k distinct existing edges; with ``symmetric`` both directions exist
    and only the canonical (src < dst) representative is returned."""
    src, dst = _edge_list(g)
    cand = np.flatnonzero(src < dst) if symmetric else np.arange(g.nnz)
    pick = rng.choice(cand, size=k, replace=False)
    return [(int(src[e]), int(dst[e])) for e in pick]


def _fresh_pairs(g, k, rng, forbid_self=True, symmetric=False):
    """k (src, dst) pairs absent from the graph (both directions if
    ``symmetric``)."""
    src, dst = _edge_list(g)
    keys = set((dst * g.n + src).tolist())
    out = []
    while len(out) < k:
        s, d = (int(v) for v in rng.integers(0, g.n, size=2))
        if forbid_self and s == d:
            continue
        if d * g.n + s in keys or (symmetric and s * g.n + d in keys):
            continue
        keys.add(d * g.n + s)
        if symmetric:
            keys.add(s * g.n + d)
        out.append((s, d))
    return out


def _symmetric_graph(formats, gen, scale=7, seed=3):
    base = gen.make_graph("kron", scale=scale, efactor=8, kind="sssp", seed=seed)
    src, dst = _edge_list(base)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return formats.CSRGraph.from_edges(
        base.n,
        np.concatenate([src, dst]),
        np.concatenate([dst, src]),
        np.zeros(2 * src.size, dtype=np.int32),
        name="sym",
    )


def _jacobi_system(n=96, seed=5):
    rng = np.random.default_rng(seed)
    m = 3 * n
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    rows, cols = rows[first], cols[first]
    vals = rng.uniform(-1.0, 1.0, rows.size)
    row_sum = np.zeros(n)
    np.add.at(row_sum, rows, np.abs(vals))
    diag = 2.0 * (row_sum + 1.0)  # strictly diagonally dominant
    b = rng.uniform(-1.0, 1.0, n)
    return rows, cols, vals, diag, b


class _Case:
    """One problem family in both packages: graph, problem, query, batches."""

    def __init__(self, name):
        self.name = name
        rng = np.random.default_rng(17)
        self.q = None
        if name in ("pagerank", "ppr", "sssp"):
            kind = "sssp" if name == "sssp" else "pagerank"
            self.jg = j_gen.make_graph("kron", scale=7, efactor=8, kind=kind, seed=1)
            self.tg = t_gen.make_graph("kron", scale=7, efactor=8, kind=kind, seed=1)
            hub = int(np.argmax(self.jg.out_degree))
            if name == "pagerank":
                self.jp, self.tp = j_solve.pagerank_problem(), t_solve.pagerank_problem()
            elif name == "ppr":
                self.jp, self.tp = j_solve.ppr_problem(), t_solve.ppr_problem()
                self.q = t_solve.ppr_teleport(self.tg, [hub])[0]
            else:
                self.jp, self.tp = j_solve.sssp_problem(source=hub), t_solve.sssp_problem(source=hub)
        elif name == "cc":
            self.jg = _symmetric_graph(j_formats, j_gen)
            self.tg = _symmetric_graph(t_formats, t_gen)
            self.jp, self.tp = j_solve.cc_problem(), t_solve.cc_problem()
        else:  # jacobi
            rows, cols, vals, diag, b = _jacobi_system()
            self.jg = j_jacobi_graph(len(diag), rows, cols, vals, diag)
            self.tg = t_jacobi_graph(len(diag), rows, cols, vals, diag)
            self.jp, self.tp = j_solve.jacobi_problem(diag, b), t_solve.jacobi_problem(diag, b)
        if name in ("pagerank", "ppr"):
            ins_val = rw_val = lambda: 0.05  # noqa: E731
        elif name == "sssp":
            ins_val = rw_val = lambda: int(rng.integers(1, 256))  # noqa: E731
        elif name == "cc":
            ins_val = rw_val = lambda: 0  # noqa: E731
        else:
            ins_val = rw_val = lambda: 0.02  # noqa: E731
        self._rng = rng
        self._ins_val = ins_val
        self._rw_val = rw_val
        self.symmetric = name == "cc"

    def batch(self, kind: str) -> dict:
        rng, g = self._rng, self.tg
        if kind == "insert":
            pairs = _fresh_pairs(g, 3, rng, symmetric=self.symmetric)
            ops = [(s, d, self._ins_val()) for s, d in pairs]
            if self.symmetric:
                ops += [(d, s, v) for s, d, v in ops]
            return {"inserts": ops}
        if kind == "delete":
            pairs = _pick_edges(g, 3, rng, symmetric=self.symmetric)
            if self.symmetric:
                pairs = pairs + [(d, s) for s, d in pairs]
            return {"deletes": pairs}
        pairs = _pick_edges(g, 3, rng, symmetric=self.symmetric)
        ops = [(s, d, self._rw_val()) for s, d in pairs]
        if self.symmetric:
            ops += [(d, s, v) for s, d, v in ops]
        return {"reweights": ops}

    def solvers(self, **kw):
        """(reference ``jit`` solver, port solver on the CPU)."""
        kw = {"n_workers": 4, "delta": 16, **kw}
        return (
            j_solve.Solver(self.jg, self.jp, backend="jit", **kw),
            t_solve.Solver(self.tg, self.tp, device="cpu", **kw),
        )

    def solve(self, solver, method="solve", **kw):
        if self.q is not None:
            kw["q"] = self.q
        return getattr(solver, method)(**kw)


def _assert_fixed_points_match(problem, xi, xc):
    xi, xc = np.asarray(xi), np.asarray(xc)
    if problem.semiring.name == "min_plus":
        np.testing.assert_array_equal(xi, xc)
    else:
        # each run stops within tol of the fixed point in the L1 residual
        # metric; 20·tol bounds the gap between two converged states for
        # every contraction factor used here
        assert np.abs(xi - xc).sum() <= 20 * problem.tol


@pytest.fixture(scope="module")
def resolved():
    """For every (problem, batch kind), in both packages: solve, then
    ``resolve(updates=batch)``; and a cold port solve on the mutated graph.
    ``(case, reference resolve, port resolve, port cold solve)``."""
    out = {}
    for name in NAMES:
        for kind in KINDS:
            case = _Case(name)
            js, ts = case.solvers()
            case.solve(js)
            case.solve(ts)
            ops = case.batch(kind)
            rj = case.solve(js, "resolve", updates=j_evolve.EdgeBatch.from_ops(**ops))
            rt = case.solve(ts, "resolve", updates=t_evolve.EdgeBatch.from_ops(**ops))
            cold = t_solve.Solver(ts.graph, case.tp, n_workers=4, delta=16, device="cpu")
            out[name, kind] = case, rj, rt, case.solve(cold)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_resolve_matches_reference(resolved, name, kind):
    _, rj, rt, _ = resolved[name, kind]
    assert (rt.rounds, rt.converged, rt.flushes, rt.flush_bytes, rt.delta, rt.P) == (
        rj.rounds, rj.converged, rj.flushes, rj.flush_bytes, rj.delta, rj.P
    )
    assert rt.converged
    np.testing.assert_array_equal(rt.x, np.asarray(rj.x))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_resolve_matches_cold(resolved, name, kind):
    case, _, rt, rc = resolved[name, kind]
    assert rt.converged and rc.converged
    _assert_fixed_points_match(case.tp, rt.x, rc.x)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["pagerank", "sssp", "cc"])
def test_patched_schedule_equals_fresh_build(name, kind):
    """Every cached δ's patched schedule against a fresh build on the mutated
    graph with the pinned bounds: src, val, dst_local and rows after padding
    to the same M, and row_ptr equal to the fresh build's and to
    ``_cell_row_ptr`` of the patched dst_local.  A schedule whose touched
    stripe outgrew M was dropped, and is rebuilt once."""
    case = _Case(name)
    _, ts = case.solvers(min_chunk=8)
    deltas = ("sync", 16, "async")
    for d in deltas:
        ts.schedule(d)
    builds = ts.stats["schedule_builds"]
    report = ts.apply_updates(t_evolve.EdgeBatch.from_ops(**case.batch(kind)))
    assert report.size == 3 * (2 if case.symmetric else 1)
    patched = len(ts._schedules)
    assert patched >= 1 if kind == "insert" else patched == len(deltas)
    sr = case.tp.semiring
    for d in deltas:
        got = ts.schedule(d)
        want = t_engine.make_schedule(ts._sched_graph, 4, ts.resolve_delta(d), sr, bounds=ts.bounds)
        assert (got.S, got.delta, got.edges) == (want.S, want.delta, want.edges)
        assert got.M >= want.M
        pad = got.M - want.M
        fills = {"src": 0, "val": sr.pad_edge_val.item(), "dst_local": want.delta}
        for field, fill in fills.items():
            w = torch.nn.functional.pad(getattr(want, field), (0, pad), value=fill)
            assert torch.equal(getattr(got, field), w), field
        assert torch.equal(got.rows, want.rows)
        assert torch.equal(got.row_ptr, want.row_ptr)
        assert torch.equal(got.row_ptr, t_engine._cell_row_ptr(got.dst_local, got.delta))
        assert got.padding_overhead == got.src.numel() / ts._sched_graph.nnz
    assert ts.stats["schedule_builds"] == builds + len(deltas) - patched


def test_patched_schedule_row_ptr_follows_dst_local():
    """A delete moves later rows' edges down a cell: row_ptr must move with
    them, or the kernels walk the wrong edges (the plain round, reading
    dst_local, would not notice)."""
    case = _Case("sssp")
    _, ts = case.solvers()
    before = ts.schedule()
    w = 1
    lo, hi = int(ts.bounds[w]), int(ts.bounds[w + 1])
    src, dst = _edge_list(ts.graph)
    e = int(np.flatnonzero((dst >= lo) & (dst < lo + 2))[0])  # the cell's first rows
    ts.apply_updates(t_evolve.EdgeBatch.from_ops(deletes=[(int(src[e]), int(dst[e]))]))
    after = ts.schedule()
    assert not torch.equal(after.row_ptr[0, w], before.row_ptr[0, w])
    assert torch.equal(after.row_ptr, t_engine._cell_row_ptr(after.dst_local, after.delta))
    assert torch.equal(after.row_ptr[:, :w], before.row_ptr[:, :w])  # untouched workers kept


def test_stripe_outgrowing_m_drops_the_schedule():
    """Inserts that widen one cell past M drop that δ's schedule; the next
    solve rebuilds it once, and equals a cold solve on the mutated graph."""
    case = _Case("sssp")
    js, ts = case.solvers()
    ts.solve()
    js.solve()
    sched = ts.schedule()
    builds = ts.stats["schedule_builds"]
    row = int(ts.bounds[2])  # the first row of worker 2's first cell
    src, dst = _edge_list(ts.graph)
    have = set(src[dst == row].tolist())
    new = [s for s in range(ts.graph.n) if s not in have and s != row][: sched.M + 1]
    ops = {"inserts": [(s, row, 7) for s in new]}
    rt = ts.resolve(updates=t_evolve.EdgeBatch.from_ops(**ops))
    rj = js.resolve(updates=j_evolve.EdgeBatch.from_ops(**ops))
    assert ts.stats["schedule_builds"] == builds + 1
    assert ts.schedule().M > sched.M
    assert (rt.rounds, rt.flushes) == (rj.rounds, rj.flushes)
    np.testing.assert_array_equal(rt.x, np.asarray(rj.x))
    cold = t_solve.Solver(ts.graph, case.tp, n_workers=4, delta=16, device="cpu").solve()
    np.testing.assert_array_equal(rt.x, cold.x)


@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_halo_resolve_equals_replicated(name):
    """The halo resolve runs over a plan rebuilt from the patched schedule
    (``plan_builds`` grows) and equals the replicated resolve."""
    case = _Case(name)
    ops = case.batch("delete")
    rep = t_solve.Solver(case.tg, case.tp, n_workers=4, delta=16, device="cpu")
    halo = t_solve.Solver(case.tg, case.tp, n_workers=4, delta=16, n_shards=2, frontier="halo", device="cpu")
    rep.solve()
    halo.solve()
    plans = halo.stats["plan_builds"]
    plan = halo.frontier_plan(halo.schedule())
    r_rep = rep.resolve(updates=t_evolve.EdgeBatch.from_ops(**ops))
    r_halo = halo.resolve(updates=t_evolve.EdgeBatch.from_ops(**ops))
    assert halo.stats["plan_builds"] == plans + 1
    assert halo.frontier_plan(halo.schedule()) is not plan
    assert len(r_halo.round_times_s) == r_halo.rounds  # the host loop
    assert (r_halo.rounds, r_halo.converged, r_halo.flushes, r_halo.flush_bytes) == (
        r_rep.rounds, r_rep.converged, r_rep.flushes, r_rep.flush_bytes
    )
    np.testing.assert_array_equal(r_halo.x, r_rep.x)


def test_resolve_requires_prior_fixed_point():
    case = _Case("sssp")
    _, ts = case.solvers()
    with pytest.raises(ValueError, match="warm-starts"):
        ts.resolve(updates=t_evolve.EdgeBatch.from_ops(**case.batch("delete")))


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_resolve_without_updates_is_warm_resolve(backend):
    case = _Case("sssp")
    ts = t_solve.Solver(case.tg, case.tp, n_workers=4, delta=16, backend=backend, device="cpu")
    r0 = ts.solve()
    r1 = ts.resolve()
    assert r1.rounds <= 1  # already at the fixed point
    np.testing.assert_array_equal(r0.x, r1.x)


def test_resolve_from_x0_and_incremental_delta():
    """``x0=`` seeds the warm start without a prior solve; ``delta="auto"``
    prefers the incremental regime's δ* once it is set."""
    case = _Case("sssp")
    js, ts = case.solvers(delta="auto")
    x_star = ts.solve(delta=16).x
    ops = case.batch("delete")
    fresh = t_solve.Solver(case.tg, case.tp, n_workers=4, delta="auto", device="cpu")
    fresh._auto_delta_incremental = 16
    r = fresh.resolve(updates=t_evolve.EdgeBatch.from_ops(**ops), x0=x_star)
    assert r.delta == 16 and fresh.delta_model is None  # no probe ran
    rj = js.resolve(updates=j_evolve.EdgeBatch.from_ops(**ops), x0=np.asarray(x_star), delta=16)
    assert (r.rounds, r.flushes) == (rj.rounds, rj.flushes)
    np.testing.assert_array_equal(r.x, np.asarray(rj.x))


def test_apply_updates_keeps_partition_and_patches_schedule():
    case = _Case("sssp")
    _, ts = case.solvers()
    r0 = ts.solve()
    bounds_before = ts.bounds.copy()
    batch = t_evolve.EdgeBatch.from_ops(**case.batch("delete"))
    report = ts.apply_updates(batch)
    assert report.deleted == batch.n_deletes
    assert ts._last_report is report
    np.testing.assert_array_equal(ts.bounds, bounds_before)
    rc = t_solve.Solver(ts.graph, case.tp, n_workers=4, delta=16, device="cpu").solve()
    r1 = ts.solve()  # cold solve on the patched schedule
    np.testing.assert_array_equal(r1.x, rc.x)
    assert r0.converged and r1.converged


# --------------------------------------------------------------------------- #
# warm start: the repairs against repro.evolve
# --------------------------------------------------------------------------- #
def _mixed_ops(case, rng, k=12):
    """The reference property's mixed batch: deletes, reweights, inserts."""
    g = case.tg
    n_del = int(rng.integers(1, k // 2))
    n_rw = int(rng.integers(1, k - n_del))
    n_ins = k - n_del - n_rw
    picked = _pick_edges(g, n_del + n_rw, rng, symmetric=case.symmetric)
    w = (lambda: 0) if case.symmetric else (lambda: int(rng.integers(1, 256)))  # noqa: E731
    deletes = picked[:n_del]
    reweights = [(s, d, w()) for s, d in picked[n_del:]]
    inserts = [(s, d, w()) for s, d in _fresh_pairs(g, n_ins, rng, symmetric=case.symmetric)]
    if case.symmetric:  # CC's weights stay zero: a reweight of 0 changes nothing
        deletes += [(d, s) for s, d in deletes]
        reweights += [(d, s, v) for s, d, v in reweights]
        inserts += [(d, s, v) for s, d, v in inserts]
    return {"inserts": inserts, "deletes": deletes, "reweights": reweights}


def _tree_ops(case, x_prev, k=3):
    """Deletes of k shortest-path tree edges (``x[src] + w == x[dst]``, into
    a reached row other than the source): each strands its row's label below
    the new fixed point unless another in-edge supports it."""
    g = case.tg
    src, dst = _edge_list(g)
    x = x_prev.astype(np.int64)
    tree = np.flatnonzero((x[src] + g.values.astype(np.int64) == x[dst]) & (x[dst] > 0))
    pick = np.random.default_rng(29).choice(tree, size=k, replace=False)
    return {"deletes": [(int(src[e]), int(dst[e])) for e in pick]}


@pytest.mark.parametrize(
    "name,kind", [("sssp", "delete"), ("sssp", "mixed"), ("sssp", "tree"), ("cc", "delete"), ("cc", "mixed")]
)
def test_warm_start_state_matches_reference(name, kind):
    case = _Case(name)
    js, ts = case.solvers()
    x_prev = ts.solve().x
    np.testing.assert_array_equal(x_prev, np.asarray(js.solve().x))
    if kind == "tree":
        ops = _tree_ops(case, x_prev)
    else:
        ops = case.batch("delete") if kind == "delete" else _mixed_ops(case, np.random.default_rng(23))
    tb, jb = t_evolve.EdgeBatch.from_ops(**ops), j_evolve.EdgeBatch.from_ops(**ops)
    tg2, t_report = ts.graph.apply_updates(tb)
    jg2, j_report = js.graph.apply_updates(jb)
    ev_t, ev_j = case.tp.edge_values, case.jp.edge_values
    t_sched = tg2.with_values(ev_t(tg2)) if ev_t is not None else tg2
    j_sched = jg2.with_values(ev_j(jg2)) if ev_j is not None else jg2
    y_t = t_evolve.warm_start_state(case.tp, tg2, t_sched, x_prev, batch=tb, report=t_report)
    y_j = j_evolve.warm_start_state(case.jp, jg2, j_sched, x_prev, batch=jb, report=j_report)
    assert y_t.dtype == y_j.dtype
    np.testing.assert_array_equal(y_t, y_j)
    base = np.asarray(case.tp.x0(tg2))
    if name == "sssp":
        args = (x_prev, base, t_report.affected_rows)
        repaired = t_evolve.minplus_cone_repair(t_sched, *args)
        np.testing.assert_array_equal(repaired, j_evolve.minplus_cone_repair(j_sched, *args))
    else:
        repaired = t_evolve.minplus_certificate_repair(t_sched, x_prev, base)
        np.testing.assert_array_equal(repaired, j_evolve.minplus_certificate_repair(j_sched, x_prev, base))
    np.testing.assert_array_equal(repaired, y_t)
    # never below the new fixed point, which a warm solve from it reaches
    x_new = t_solve.Solver(tg2, case.tp, n_workers=4, delta=16, device="cpu").solve().x
    assert np.all(y_t.astype(np.int64) >= x_new.astype(np.int64))
    if kind == "tree":  # the cone was re-raised
        assert (y_t > x_prev).any()


def test_warm_start_passes_plus_times_and_inserts_through():
    case = _Case("pagerank")
    _, ts = case.solvers()
    x_prev = ts.solve().x
    batch = t_evolve.EdgeBatch.from_ops(**case.batch("delete"))
    g2, report = ts.graph.apply_updates(batch)
    assert t_evolve.warm_start_state(case.tp, g2, g2, x_prev, batch, report) is x_prev
    sssp = _Case("sssp")
    _, ss = sssp.solvers()
    x_prev = ss.solve().x
    batch = t_evolve.EdgeBatch.from_ops(**sssp.batch("insert"))
    g2, report = ss.graph.apply_updates(batch)
    assert t_evolve.warm_start_state(sssp.tp, g2, g2, x_prev, batch, report) is x_prev
    assert t_evolve.warm_start_state(sssp.tp, g2, g2, x_prev) is x_prev


# --------------------------------------------------------------------------- #
# EdgeBatch and CSRGraph.apply_updates against repro.graphs.updates
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["pagerank", "sssp", "cc"])
def test_apply_updates_matches_reference_and_inverts(name):
    case = _Case(name)
    ops = _mixed_ops(case, np.random.default_rng(5))
    if name == "pagerank":
        ops = {k: [(s, d, 0.25) for s, d, *_ in v] if k != "deletes" else v for k, v in ops.items()}
    tb, jb = t_evolve.EdgeBatch.from_ops(**ops), j_evolve.EdgeBatch.from_ops(**ops)
    tg2, tr = case.tg.apply_updates(tb)
    jg2, jr = case.jg.apply_updates(jb)
    for field in ("indptr", "indices", "values"):
        a, b = getattr(tg2, field), getattr(jg2, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for field in dataclasses.fields(tr):
        np.testing.assert_array_equal(getattr(tr, field.name), getattr(jr, field.name))
    back, _ = tg2.apply_updates(tb.inverse(tr))
    for field in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(back, field), getattr(case.tg, field))


def test_apply_updates_is_strict():
    g = _Case("sssp").tg
    src, dst = _edge_list(g)
    s, d = int(src[0]), int(dst[0])
    with pytest.raises(ValueError, match="insert of existing edge"):
        g.apply_updates(t_evolve.EdgeBatch.from_ops(inserts=[(s, d, 1)]))
    absent = _fresh_pairs(g, 1, np.random.default_rng(0))[0]
    with pytest.raises(ValueError, match="delete of missing edge"):
        g.apply_updates(t_evolve.EdgeBatch.from_ops(deletes=[absent]))
    with pytest.raises(ValueError, match="duplicate"):
        g.apply_updates(t_evolve.EdgeBatch.from_ops(deletes=[(s, d)], reweights=[(s, d, 3)]))
    with pytest.raises(ValueError, match="out of range"):
        g.apply_updates(t_evolve.EdgeBatch.from_ops(inserts=[(0, g.n, 1)]))


# --------------------------------------------------------------------------- #
# the δ model's per-regime refits against repro.core.delta_model
# --------------------------------------------------------------------------- #
def test_refit_delta_models_match_reference():
    jg = j_gen.make_graph("kron", scale=7, efactor=8, kind="sssp", seed=6)
    tg = t_gen.make_graph("kron", scale=7, efactor=8, kind="sssp", seed=6)
    jm = j_delta_model.fit_delta_model(jg, P=4, r_sync=8, r_async=12)
    tm = t_delta_model.fit_delta_model(tg, P=4, r_sync=8, r_async=12)
    assert tm.to_dict() == jm.to_dict()
    rows = [
        {"delta": 16, "rounds": 9, "regime": "cold"},
        {"delta": 64, "rounds": 10, "regime": "cold"},
        {"delta": 16, "rounds": 2, "regime": "incremental"},
        {"delta": 32, "rounds": 3, "regime": "incremental"},
        {"delta": 32, "rounds": 0, "regime": "incremental"},
        {"delta": 8, "rounds": 4},
    ]
    t_models = t_delta_model.refit_delta_models(tm, rows)
    j_models = j_delta_model.refit_delta_models(jm, rows)
    assert set(t_models) == set(j_models) == {"cold", "incremental"}
    for regime, model in t_models.items():
        assert model.to_dict() == j_models[regime].to_dict()
        assert model.best_delta() == j_models[regime].best_delta()
    assert t_models["incremental"].rounds(16) < t_models["cold"].rounds(16)
    one = t_delta_model.refit_delta_model(tm, [(16, 5.0)])
    assert one.to_dict() == j_delta_model.refit_delta_model(jm, [(16, 5.0)]).to_dict()
    assert t_delta_model.refit_delta_models(tm, [{"delta": 16, "rounds": 0}]) == {}
