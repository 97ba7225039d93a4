"""The port's replicated frontier and batches across processes
(``Solver(group=...)``) against the JAX reference, and K1's rank entries'
plain versions.

* Four processes (``tests/torch_dist_replicated_ranks.py``, spawned once for
  the module over ``gloo`` with a ``file://`` store, while this process
  computes the reference's answers) run the reference's width-invariance
  cases of ``tests/test_frontier_sharded.py`` at W = 1, 2 and 4 ranks, P = 8:
  PageRank, SSSP, CC and Jacobi at δ = 48 on the replicated frontier equal
  ``repro.Solver(backend="jit")`` and ``backend="sharded",
  frontier="replicated"`` (x, rounds, converged, flushes, flush_bytes) bit
  for bit, and three rounds equal the one-process plain round; ppr's query
  on both frontiers equals the jit solve; ``solve_batch`` on both frontiers
  (multi-source SSSP, ppr, ppr compacting) equals the reference's jit batch
  (x, ``rounds_per_query``), Q = 1 the unbatched solve, and an open batch
  the reference's ``BatchStepper``; ``delta="auto"`` gives ``repro``'s δ*;
  the residual bits do not depend on W; the refusal that still stands
  raises, and a store, ``apply_updates`` and ``resolve`` run and give
  ``repro``'s answers; the ranks load neither ``jax`` nor ``repro``.
* In one process: a rank's replicated cells equal the whole schedule's
  slices, and K1's rank step over any split of the workers, joined in
  worker order and published, equals one step of the plain round, for
  every epilogue, at F = 1 and 4 and over a batch's rows.
"""

import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.solve as j_solve  # noqa: E402
from repro.evolve import EdgeBatch as JEdgeBatch  # noqa: E402
from repro.algorithms.jacobi import jacobi_graph as j_jacobi_graph  # noqa: E402
from repro.graphs.generators import make_graph as j_make_graph  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.semiring import MIN_PLUS, PLUS_TIMES  # noqa: E402
from repro_torch.dist import engine_sharded as es  # noqa: E402
from repro_torch.graphs.generators import make_graph as t_make_graph  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.round_block import ADD_CONST, ADD_TABLE, LABELPROP, MIN_OLD, Epilogue  # noqa: E402
from repro_torch.solve import Solver as TSolver  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("torch_dist_replicated_ranks",
                                               REPO / "tests" / "torch_dist_replicated_ranks.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)
WORLD = 4


@functools.cache
def _j_graphs():
    return R.make_graphs(j_make_graph)


def _j_case(name):
    if name == "jacobi":
        n, rows, cols, vals, diag, b = R.jacobi_case_inputs()
        return j_jacobi_graph(n, rows, cols, vals, diag), j_solve.jacobi_problem(diag, b)
    g = _j_graphs()
    return {"pagerank": (g["pr"], j_solve.pagerank_problem()), "sssp": (g["s"], j_solve.sssp_problem()),
            "cc": (g["u"], j_solve.cc_problem())}[name]


def _reference() -> dict:
    """Every answer of ``repro`` the rank cases are held to."""
    out = {}
    for name in R.PROBLEMS:
        g, prob = _j_case(name)
        sv = j_solve.Solver(g, prob, n_workers=R.P, delta=R.PARITY_DELTA, min_chunk=R.PARITY_MIN_CHUNK)
        out[("parity", name, "jit")] = sv.solve(backend="jit")
        out[("parity", name, "sharded")] = sv.solve(backend="sharded", frontier="replicated")
    gp, gs = _j_graphs()["pr"], _j_graphs()["s"]
    sv = j_solve.Solver(gp, j_solve.ppr_problem(), n_workers=R.P, delta=R.PPR_DELTA, min_chunk=R.PARITY_MIN_CHUNK)
    out["ppr"] = sv.solve(q=j_solve.ppr_teleport(gp, [R.PPR_SEED])[0], backend="jit")
    qb = j_solve.ppr_teleport(gp, list(R.PPR_BATCH_SEEDS))
    x0 = np.tile(np.full(gp.n, 1.0 / gp.n, np.float32), (len(R.PPR_BATCH_SEEDS), 1))
    out["ppr_batch"] = j_solve.solve_batch(sv, x0, q=qb)
    out["compact"] = j_solve.solve_batch(sv, x0, q=qb, compact_every=R.COMPACT_EVERY)
    sv = j_solve.Solver(gs, j_solve.sssp_problem(), n_workers=R.P, delta=R.BATCH_DELTA, min_chunk=R.BATCH_MIN_CHUNK)
    out["batch"] = j_solve.solve_batch(sv, j_solve.multi_source_x0(gs, list(R.BATCH_SOURCES)))
    out["q1"] = j_solve.solve_batch(sv, j_solve.multi_source_x0(gs, [0]))
    out["solve"] = out["cache_dir"] = sv.solve(backend="jit")
    up = j_solve.Solver(gs, j_solve.sssp_problem(), n_workers=R.P, delta=R.BATCH_DELTA, min_chunk=R.BATCH_MIN_CHUNK,
                        backend="jit")
    first, second = (JEdgeBatch.from_ops(**o) for o in R.update_ops(gs))
    up.apply_updates(first)
    out["apply_updates"] = up.solve()
    out["resolve"] = up.resolve(updates=second)
    st = j_solve.BatchStepper(sv, R.STEPPER_CAPACITY)
    pending = list(enumerate(j_solve.multi_source_x0(gs, list(R.STEPPER_SOURCES))))
    retired = []
    while pending or st.occupancy:
        while pending and st.free_slots:
            i, x = pending.pop(0)
            st.admit(x, tag=i)
        retired += st.run(R.STEPPER_QUANTUM)
    out["stepper"] = {rq.tag: rq for rq in retired}
    sv = j_solve.Solver(gp, j_solve.pagerank_problem(), n_workers=R.P, min_chunk=R.PARITY_MIN_CHUNK)
    out["auto"] = (sv.resolve_delta("auto"), sv.solve(backend="jit"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(every rank's results, the reference's answers)``: the ranks run
    while this process computes the reference."""
    out = tmp_path_factory.mktemp("ranks")
    init = f"file://{out / 'store'}"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_dist_replicated_ranks.py"), "--rank", str(r),
             "--world", str(WORLD), "--init", init, "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        reference = _reference()
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)], reference


def _every(ranks, fmt):
    """``(W, rank, arrays of that rank)`` for every width and rank."""
    for W in R.WIDTHS:
        for r in range(W):
            yield W, r, ranks[r], fmt.format(W=W)


# --------------------------------------------------------------------------- #
# across processes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", R.PROBLEMS)
def test_fixed_point_equals_jit_and_sharded_replicated(runs, name):
    ranks, ref_ = runs
    jit, sharded = ref_[("parity", name, "jit")], ref_[("parity", name, "sharded")]
    assert (jit.rounds, jit.flushes, jit.flush_bytes) == (sharded.rounds, sharded.flushes, sharded.flush_bytes)
    for W, r, got, tag in _every(ranks, "parity/{W}/" + name):
        rounds, conv, flushes, fbytes, delta, P = got[tag + "/counts"]
        assert (rounds, flushes, fbytes, delta, P) == (jit.rounds, jit.flushes, jit.flush_bytes, jit.delta, jit.P)
        assert bool(conv) == jit.converged
        np.testing.assert_array_equal(got[tag + "/x"], np.asarray(jit.x))
        np.testing.assert_array_equal(got[tag + "/x"], np.asarray(sharded.x))
        w0, w1, S, Pr, M = got[tag + "/cells"]
        assert (w0, w1, Pr) == (r * R.P // W, (r + 1) * R.P // W, R.P // W)
    assert jit.rounds > 1


@pytest.mark.parametrize("name", R.PROBLEMS)
def test_three_rounds_equal_the_one_process_plain_round(runs, name):
    ranks, _ = runs
    g, prob = R.port_case(name, R.make_graphs(t_make_graph))
    sv = TSolver(g, prob, n_workers=R.P, delta=R.PARITY_DELTA, min_chunk=R.PARITY_MIN_CHUNK, device="cpu")
    rnd = t_engine.round_fn(sv.schedule(), prob.semiring, sv.row_update())
    x = sv._x_ext(None)
    for i in range(R.ROUNDS):
        x = rnd(x)
        for W, r, got, tag in _every(ranks, "parity/{W}/" + name):
            np.testing.assert_array_equal(got[f"{tag}/round/{i}"], x[:-1].numpy())


def test_ppr_query_threading_both_frontiers(runs):
    ranks, ref_ = runs
    jit = ref_["ppr"]
    for frontier in ("replicated", "halo"):
        for W, r, got, tag in _every(ranks, "ppr/{W}/" + frontier):
            assert tuple(got[tag + "/counts"]) == (jit.rounds, jit.flushes, jit.flush_bytes)
            np.testing.assert_array_equal(got[tag + "/x"], np.asarray(jit.x))


@pytest.mark.parametrize("frontier", ["replicated", "halo"])
@pytest.mark.parametrize("case", ["batch", "ppr_batch", "compact", "q1"])
def test_batch_equals_jit_batch(runs, case, frontier):
    ranks, ref_ = runs
    want = ref_[case]
    for W, r, got, tag in _every(ranks, case + "/{W}/" + frontier):
        rounds, flushes, fbytes, compactions = got[tag + "/counts"]
        assert (rounds, flushes, fbytes, compactions) == (want.rounds, want.flushes, want.flush_bytes,
                                                           want.compactions)
        np.testing.assert_array_equal(got[tag + "/x"], np.asarray(want.x))
        np.testing.assert_array_equal(got[tag + "/rpq"], np.asarray(want.rounds_per_query))
        np.testing.assert_array_equal(got[tag + "/converged"], np.asarray(want.converged))
    if case == "compact":
        assert want.compactions > 0


@pytest.mark.parametrize("frontier", ["replicated", "halo"])
def test_q1_batch_equals_the_unbatched_solve(runs, frontier):
    ranks, ref_ = runs
    for W, r, got, tag in _every(ranks, "q1/{W}/" + frontier):
        assert got[tag + "/counts"][0] == got[tag + "/solve_rounds"][0] == ref_["solve"].rounds
        np.testing.assert_array_equal(got[tag + "/x"][0], got[tag + "/solve_x"])
        np.testing.assert_array_equal(got[tag + "/solve_x"], np.asarray(ref_["solve"].x))


@pytest.mark.parametrize("frontier", ["replicated", "halo"])
def test_open_batch_equals_the_reference_stepper(runs, frontier):
    ranks, ref_ = runs
    want = ref_["stepper"]
    assert sorted(want) == list(range(len(R.STEPPER_SOURCES)))
    for W, r, got, tag in _every(ranks, "stepper/{W}/" + frontier):
        for i, rq in want.items():
            assert tuple(got[f"{tag}/{i}/rounds"]) == (rq.rounds, rq.converged)
            np.testing.assert_array_equal(got[f"{tag}/{i}/x"], np.asarray(rq.x))


def test_auto_delta_equals_the_references(runs):
    ranks, ref_ = runs
    dstar, jit = ref_["auto"]
    for W, r, got, tag in _every(ranks, "auto/{W}"):
        assert tuple(got[tag + "/delta"]) == (dstar, jit.rounds)
        np.testing.assert_array_equal(got[tag + "/x"], np.asarray(jit.x))


@pytest.mark.parametrize("name", R.PROBLEMS)
def test_residual_bits_do_not_depend_on_the_ranks(runs, name):
    ranks, _ = runs
    every = [got[tag + "/residuals"] for W, r, got, tag in _every(ranks, "parity/{W}/" + name)]
    for res in every[1:]:
        np.testing.assert_array_equal(res.view(np.int64), every[0].view(np.int64))


def test_refusals_that_still_stand(runs):
    """``P % W != 0`` raises; a store, ``apply_updates`` and ``resolve``,
    refused until they were ported, run and give ``repro``'s answers."""
    ranks, reference = runs
    for r in range(WORLD):
        got = list(ranks[r]["refusals"])
        want = {
            "P % W": "ValueError: P=6 workers do not split evenly over W=4",
            "cache_dir": "ran",
            "apply_updates": "ran",
            "resolve": "ran",
        }
        assert len(got) == len(want)
        for line, (what, start) in zip(got, want.items()):
            assert line.startswith(f"{what}: {start}"), line
            if start == "ran":
                jr = reference[what]
                assert ranks[r][f"lifted/{what}/rounds"][0] == jr.rounds, what
                np.testing.assert_array_equal(ranks[r][f"lifted/{what}/x"], np.asarray(jr.x))


def test_ranks_load_neither_jax_nor_repro(runs):
    ranks, _ = runs
    for r in range(WORLD):
        assert ranks[r]["foreign_modules"].size == 0, ranks[r]["foreign_modules"]


# --------------------------------------------------------------------------- #
# in one process: a rank's cells and K1's rank entries' plain versions
# --------------------------------------------------------------------------- #
SPLITS = {"whole": ((0, 8),), "halves": ((0, 4), (4, 8)), "uneven": ((0, 1), (1, 6), (6, 8))}


@functools.cache
def _graph(kind):
    if kind == "sssp":
        return t_make_graph("kron", scale=9, efactor=8, kind="sssp")
    return t_make_graph("twitter", scale=9, efactor=8, kind="pagerank")


@pytest.mark.parametrize("delta", [16, 48, 1000])
def test_rank_cells_equal_the_whole_schedules_slices(delta):
    g = _graph("sssp")
    sched = t_engine.make_schedule(g, R.P, delta, MIN_PLUS, min_chunk=16)
    for w0, w1 in SPLITS["uneven"]:
        rs, host = es.rank_schedule(g, sched.block_bounds, delta, MIN_PLUS.pad_edge_val, w0, w1, "cpu")
        rep = es.replicated_rank(rs, host)
        cut = es.rank_cells(sched, w0, w1)
        for f in ("src", "val", "dst_local", "rows", "row_ptr"):
            assert torch.equal(getattr(rep, f), getattr(sched, f)[:, w0:w1]), f
            assert torch.equal(getattr(cut, f), getattr(rep, f)), f
        assert torch.equal(rep.rows_all, sched.rows) and torch.equal(cut.rows_all, sched.rows)
        assert (rep.w0, rep.w1, rep.S, rep.M, rep.P) == (w0, w1, sched.S, sched.M, sched.P)


def _k1_inputs(tag, feat, rng):
    """Graph, semiring, ``(n + 1,)+feat`` frontier and epilogue (table rows
    ``feat``)."""
    if tag == MIN_OLD:
        g = _graph("sssp")
        x = rng.integers(0, 1000, (g.n + 1,) + feat).astype(np.int32)
        return g, MIN_PLUS, torch.as_tensor(x), Epilogue(MIN_OLD)
    g = _graph("pagerank")
    x = torch.as_tensor(rng.random((g.n + 1,) + feat).astype(np.float32))
    if tag == ADD_CONST:
        return g, PLUS_TIMES, x, Epilogue(ADD_CONST, const=float(np.float32(0.15 / g.n)))
    if tag == ADD_TABLE:
        return g, PLUS_TIMES, x, Epilogue(ADD_TABLE, table=torch.as_tensor(rng.random((g.n + 1,) + feat).astype(np.float32)))
    anchors = (rng.random((g.n + 1,) + feat) < 0.05).astype(np.float32)
    anchors[-1] = 0.0
    g = g.with_values(np.ones(g.nnz, np.float32))
    return g, PLUS_TIMES, x, Epilogue.labelprop(torch.as_tensor(anchors), 0.7)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("feat", [(), (4,), (3, 2)], ids=["F1", "F4", "Q3-F2"])
@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD, LABELPROP])
def test_rank_steps_joined_and_published_equal_the_plain_round(tag, feat, split):
    """Per step: each range's rank step over the whole frontier, joined in
    worker order and published, equals the plain round's step (x's real
    rows), for single frontiers and a batch's ``(Q, F)`` rows."""
    if tag == LABELPROP and not feat:
        feat = (2,)
    rng = np.random.default_rng(len(feat) + len(tag))
    g, sr, x0, ep = _k1_inputs(tag, feat, rng)
    sched = t_engine.make_schedule(g, R.P, 48, sr, min_chunk=16)
    rnd = t_engine.round_fn(sched, sr, ep)
    want = rnd(x0)
    cells = [es.rank_cells(sched, w0, w1) for w0, w1 in SPLITS[split]]
    got = x0.clone()
    for s in range(sched.S):
        block = torch.cat([ref.round_rank_step_ref(got, c, sr, ep, s) for c in cells])
        assert block.shape == (sched.P * sched.delta,) + feat
        ref.round_publish_ref(got, block, sched.rows, s)
    assert torch.equal(got[:-1], want[:-1])
    assert torch.equal(got[-1], x0[-1])  # the publish skips the dump row
