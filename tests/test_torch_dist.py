"""The port's halo solve across processes (``Solver(group=...)``) against
the JAX reference, and K2's rank entries' plain versions.

* Four processes (``tests/torch_dist_ranks.py``, spawned once for the
  module over ``gloo`` with a ``file://`` store) run PageRank, SSSP, CC,
  Jacobi and rwr at F = 4, at ``sync``, δ = 32 and ``async``, with W = 2
  and 4 ranks at D = 4 and W = 4 at D = 8.  Every rank's ``x``, ``rounds``,
  ``converged``, ``flushes`` and ``flush_bytes`` equal ``repro.Solver(
  backend="jit")``'s and the port's one-process halo solve's, bit for bit;
  the residuals' bits do not depend on W; int8 and fp8 PageRank equal the
  one-process plain K2 solve, and their x and error-feedback residuals
  after three rounds equal the one-process plain K2 rounds'; each rank
  holds only its own shards' arrays; ``D % W != 0`` raises, and the paths
  once refused across processes (the replicated frontier, ``delta="auto"``,
  batches, a store, ``apply_updates`` and ``resolve``) run and give
  ``repro``'s answers; the ranks load neither ``jax`` nor ``repro``.
* In one process: a rank's schedule cells and plan blocks equal the
  whole schedule's and plan's slices, and the local step plus the receive
  over any split of the shards equals ``fused_halo_round_ref`` one step at
  a time, for every epilogue and wire, ``ef`` included.

Only the local frontier's non-dump slots are compared: dump values are
unspecified.
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
from repro.graphs import formats as j_formats  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
import repro_torch.solve as t_solve  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.semiring import MIN_PLUS, PLUS_TIMES  # noqa: E402
from repro_torch.dist import engine_sharded as es  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.round_block import ADD_CONST, ADD_TABLE, LABELPROP, MIN_OLD, Epilogue  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("torch_dist_ranks", REPO / "tests" / "torch_dist_ranks.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)
WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: ``[dict of arrays] * WORLD``."""
    out = tmp_path_factory.mktemp("ranks")
    init = f"file://{out / 'store'}"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_dist_ranks.py"), "--rank", str(r),
             "--world", str(WORLD), "--init", init, "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@functools.cache
def _reference(name, dname):
    """``repro.Solver(backend="jit")``'s solve of a case."""
    if name == "jacobi":
        n, cols, rows, w, diag, b = R.jacobi_inputs()
        g, prob = j_formats.CSRGraph.from_edges(n, cols, rows, w, dedup=False), j_solve.jacobi_problem(diag, b)
    else:
        gname, scale, kind = R.graph_spec(name)
        g = j_gen.make_graph(gname, scale=scale, efactor=8, kind=kind)
        prob = getattr(j_solve, {"rwr": "rwr_embedding_problem"}.get(name, f"{name}_problem"))()
    sv = j_solve.Solver(g, prob, n_workers=R.P, min_chunk=R.MIN_CHUNK, backend="jit")
    return sv.solve(delta=R.DELTAS[dname])


@functools.cache
def _port_case(name):
    return R.port_case(name)


@functools.cache
def _one_process(name, dname, D, **kw):
    g, prob = _port_case(name)
    sv = t_solve.Solver(g, prob, n_workers=R.P, min_chunk=R.MIN_CHUNK, delta=R.DELTAS[dname],
                        frontier="halo", n_shards=D, device="cpu", **kw)
    return sv.solve()


def _tag(W, D, name, dname):
    return f"solve/{W}/{D}/{name}/{dname}"


# --------------------------------------------------------------------------- #
# across processes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("W,D", R.LAYOUTS, ids=[f"W{w}-D{d}" for w, d in R.LAYOUTS])
@pytest.mark.parametrize("dname", list(R.DELTAS))
@pytest.mark.parametrize("name", R.PROBLEMS)
def test_rank_solves_equal_reference_jit(ranks, name, dname, W, D):
    jr = _reference(name, dname)
    one = _one_process(name, dname, D)
    tag = _tag(W, D, name, dname)
    for r in range(W):
        rounds, conv, flushes, fbytes, delta, P = ranks[r][tag + "/counts"]
        assert (rounds, flushes, fbytes, delta, P) == (jr.rounds, jr.flushes, jr.flush_bytes, jr.delta, jr.P)
        assert (rounds, flushes, fbytes) == (one.rounds, one.flushes, one.flush_bytes)
        assert bool(conv) == jr.converged == one.converged
        np.testing.assert_array_equal(ranks[r][tag + "/x"], np.asarray(jr.x))
        np.testing.assert_array_equal(ranks[r][tag + "/x"], one.x)
    assert rounds > 1


@pytest.mark.parametrize("dname", list(R.DELTAS))
@pytest.mark.parametrize("name", R.PROBLEMS)
def test_residual_bits_do_not_depend_on_the_ranks(ranks, name, dname):
    """Each shard's partial is summed in shard order whatever W is: at D = 4
    every rank of W = 2 and W = 4 holds the same residuals."""
    every = [ranks[r][_tag(W, 4, name, dname) + "/residuals"] for W, D in R.LAYOUTS if D == 4 for r in range(W)]
    for res in every[1:]:
        np.testing.assert_array_equal(res.view(np.int64), every[0].view(np.int64))
    one = _one_process(name, dname, 4)
    np.testing.assert_allclose(every[0], one.residuals, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wire,W", R.QUANT)
def test_quantized_rank_solves_equal_the_one_process_plain_k2(ranks, wire, W):
    one = _one_process("pagerank", "32", 4, halo_dtype=wire, max_rounds=R.QUANT_MAX_ROUNDS)
    tag = f"quant/{wire}/{W}"
    g, prob = _port_case("pagerank")
    sched = t_engine.make_schedule(g, R.P, 32, PLUS_TIMES, min_chunk=R.MIN_CHUNK)
    plan = es.make_frontier_plan(sched, 4)
    x_ext = torch.as_tensor(np.append(prob.x0(g), np.float32(0)))
    ef = es.frontier_ef_init(plan)
    ep = prob.make_row_update(g, None, "cpu")
    for _ in range(R.QUANT_ROUNDS):  # the one-process round: scatter, K2's plain round, gather
        x_loc = plan.scatter_x(x_ext)
        ref.fused_halo_round_ref(x_loc, ef, sched, plan, PLUS_TIMES, ep, wire)
        x_ext = plan.gather_x(x_loc, dump=x_ext[-1:])
    for r in range(W):
        rounds, conv, flushes, fbytes = ranks[r][tag + "/counts"]
        assert (rounds, bool(conv), flushes, fbytes) == (one.rounds, one.converged, one.flushes, one.flush_bytes)
        np.testing.assert_array_equal(ranks[r][tag + "/x"], one.x)
        d0, d1 = ranks[r][tag + "/shards"]
        np.testing.assert_array_equal(ranks[r][tag + "/x_loc"][:, :-1], x_loc[d0:d1, :-1].numpy())
        np.testing.assert_array_equal(ranks[r][tag + "/ef"], ef[d0:d1].numpy())
    exact = _one_process("pagerank", "32", 4, max_rounds=R.QUANT_MAX_ROUNDS)
    assert one.rounds == exact.rounds == R.QUANT_MAX_ROUNDS
    assert not np.array_equal(one.x, exact.x)  # the wire did quantize


@pytest.mark.parametrize("W,D", R.LAYOUTS, ids=[f"W{w}-D{d}" for w, d in R.LAYOUTS])
def test_each_rank_holds_only_its_shards(ranks, W, D):
    for name in R.PROBLEMS:
        g, prob = _port_case(name)
        sched = t_engine.make_schedule(
            g.with_values(prob.edge_values(g)) if prob.edge_values is not None else g,
            R.P, 32, prob.semiring, min_chunk=R.MIN_CHUNK,
        )
        plan = es.make_frontier_plan(sched, D)
        Dr, Pr = D // W, R.P // W
        F = () if prob.feature_dim == 1 else (prob.feature_dim,)
        tag = _tag(W, D, name, "32")
        for r in range(W):
            got = ranks[r]
            assert tuple(got[tag + "/shards"]) == (r * Dr, (r + 1) * Dr)
            assert tuple(got[tag + "/val"]) == (sched.S, Pr, sched.M)
            assert tuple(got[tag + "/row_ptr"]) == (sched.S, Pr, sched.delta + 1)
            assert tuple(got[tag + "/src_loc"]) == (Dr, sched.S, plan.P_loc, sched.M)
            assert tuple(got[tag + "/send_idx"]) == (sched.S, Dr, plan.H)
            assert tuple(got[tag + "/recv_idx"]) == (sched.S, Dr, D * plan.H)
            assert tuple(got[tag + "/x_loc"]) == (Dr, plan.L) + F


@functools.cache
def _lifted_reference():
    """``repro``'s jit answers of the paths across processes that once
    raised and now run: SSSP at δ = 32 (replicated, on a halo solver and
    not, and with a store), at ``delta="auto"``, a two-source batch at δ =
    32, a solve after ``apply_updates`` and a ``resolve`` (the batches of
    ``update_ops``)."""
    gname, scale, kind = R.graph_spec("sssp")
    g = j_gen.make_graph(gname, scale=scale, efactor=8, kind=kind)
    sv = j_solve.Solver(g, j_solve.sssp_problem(), n_workers=R.P, min_chunk=R.MIN_CHUNK, backend="jit")
    at32 = sv.solve(delta=32)
    out = {"replicated": at32, "solve replicated": at32, "cache_dir": at32, "auto": sv.solve(delta="auto"),
           "batch": j_solve.solve_batch(sv, j_solve.multi_source_x0(g, [0, 3]), delta=32)}
    up = j_solve.Solver(g, j_solve.sssp_problem(), n_workers=R.P, min_chunk=R.MIN_CHUNK, delta=32, backend="jit")
    first, second = (JEdgeBatch.from_ops(**o) for o in R.update_ops(g))
    up.apply_updates(first)
    out["apply_updates"] = up.solve()
    out["resolve"] = up.resolve(updates=second)
    return out


def test_refusals_across_processes(ranks):
    """The refusals that still stand (``D % W != 0``) raise; the paths a
    later port lifted (the replicated frontier, ``delta="auto"``, batches,
    a store, ``apply_updates`` and ``resolve``) run and give ``repro``'s jit
    answers."""
    lifted = _lifted_reference()
    for r in range(WORLD):
        got = list(ranks[r]["refusals"])
        want = {
            "D % W": "ValueError: D=6 shards do not split evenly over W=4",
            "D % W solver": "ValueError: D=2 shards do not split evenly over W=4",
            "replicated": "ran",
            "cache_dir": "ran",
            "solve replicated": "ran",
            "auto": "ran",
            "batch": "ran",
            "apply_updates": "ran",
            "resolve": "ran",
        }
        assert len(got) == len(want)
        for line, (what, start) in zip(got, want.items()):
            assert line.startswith(f"{what}: {start}"), line
            if start == "ran":
                jr = lifted[what]
                assert ranks[r][f"lifted/{what}/rounds"][0] == jr.rounds, what
                np.testing.assert_array_equal(ranks[r][f"lifted/{what}/x"], np.asarray(jr.x))


def test_ranks_load_neither_jax_nor_repro(ranks):
    for r in range(WORLD):
        assert ranks[r]["foreign_modules"].size == 0, ranks[r]["foreign_modules"]


def test_comm_and_the_port_import_without_jax_or_repro():
    code = (
        "import sys\n"
        "import repro_torch.dist.comm\n"
        "import repro_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# --------------------------------------------------------------------------- #
# in one process: the rank's layout and the plain versions
# --------------------------------------------------------------------------- #
@functools.cache
def _layout(name, delta, D):
    if name == "labelprop":
        g = t_gen.make_graph("twitter", scale=8, efactor=8, kind="unit")
        sr = PLUS_TIMES
    else:
        gname, scale, kind = R.graph_spec(name)
        g = t_gen.make_graph(gname, scale=scale, efactor=8, kind=kind)
        sr = MIN_PLUS if kind == "sssp" else PLUS_TIMES
    sched = t_engine.make_schedule(g, R.P, delta, sr, min_chunk=R.MIN_CHUNK)
    return g, sr, sched, es.make_frontier_plan(sched, D)


SPLITS = {"D4": (4, ((0, 2), (2, 4))), "D4-uneven": (4, ((0, 1), (1, 4))), "D8": (8, ((0, 2), (2, 3), (3, 8)))}


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("delta", [16, 32, 1000])
def test_rank_layout_equals_the_whole_layouts_slices(delta, split):
    D, ranges = SPLITS[split]
    g, sr, sched, whole = _layout("sssp", delta, D)
    P_loc = R.P // D
    for d0, d1 in ranges:
        rs, host = es.rank_schedule(g, sched.block_bounds, delta, sr.pad_edge_val, d0 * P_loc, d1 * P_loc, "cpu")
        w = slice(d0 * P_loc, d1 * P_loc)
        assert (rs.S, rs.M, rs.delta, rs.P, rs.w0) == (sched.S, sched.M, sched.delta, sched.P, d0 * P_loc)
        for f in ("val", "dst_local", "rows", "row_ptr"):
            assert torch.equal(getattr(rs, f), getattr(sched, f)[:, w]), f
        np.testing.assert_array_equal(host["src"], sched.src[:, w].numpy())
        rp = es.rank_plan(g, rs, host, D)
        assert (rp.d0, rp.d1) == (d0, d1)
        for f in ("D", "P_loc", "L", "H", "S", "delta", "n", "boundary_entries_per_round"):
            assert getattr(rp, f) == getattr(whole, f), f
        np.testing.assert_array_equal(rp.halo_sizes, whole.halo_sizes)
        for f in ("src_loc", "rows_loc", "gather_index"):
            assert torch.equal(getattr(rp, f), getattr(whole, f)[d0:d1]), f
        for f in ("send_idx", "recv_idx", "dump_last"):
            assert torch.equal(getattr(rp, f), getattr(whole, f)[:, d0:d1]), f
        flat = whole.owned_flat
        mine = flat[(flat >= d0 * whole.L) & (flat < d1 * whole.L)] - d0 * whole.L
        assert torch.equal(rp.owned_flat, mine)


def _epilogue(tag, g, n, feat, rng):
    if tag == ADD_CONST:
        return Epilogue(ADD_CONST, const=0.15 / n)
    if tag == ADD_TABLE:
        return Epilogue(ADD_TABLE, table=torch.as_tensor(rng.random((n + 1,) + feat).astype(np.float32)))
    if tag == LABELPROP:
        anchors = np.zeros((n + 1,) + feat, np.float32)
        hit = rng.choice(n, n // 10, replace=False)
        anchors[hit, rng.integers(0, feat[0], hit.size)] = 1.0
        return Epilogue.labelprop(torch.as_tensor(anchors), 0.7)
    return Epilogue(MIN_OLD)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize(
    "tag,wire",
    [(ADD_CONST, "f32"), (ADD_CONST, "int8"), (ADD_CONST, "fp8"), (ADD_TABLE, "f32"), (ADD_TABLE, "int8"),
     (MIN_OLD, "f32"), (LABELPROP, "f32"), (LABELPROP, "fp8")],
)
def test_local_step_and_receive_equal_the_halo_round(tag, wire, split):
    """Per step: the local step of each range, the send blocks joined in
    shard order, and the receive into each range equal one step of
    ``fused_halo_round_ref`` (x's non-dump slots; ef; for a quantized wire
    the dump slots too)."""
    D, ranges = SPLITS[split]
    name = {MIN_OLD: "sssp", LABELPROP: "labelprop"}.get(tag, "pagerank")
    g, sr, sched, plan = _layout(name, 32, D)
    rng = np.random.default_rng(5)
    feat = (4,) if tag == LABELPROP else ()
    ep = _epilogue(tag, g, g.n, feat, rng)
    if sr is MIN_PLUS:
        x0 = torch.as_tensor(rng.integers(0, 1000, g.n + 1).astype(np.int32))
    else:
        x0 = torch.as_tensor(rng.random((g.n + 1,) + feat).astype(np.float32))
    xa = plan.scatter_x(x0).clone()
    xb = xa.clone()
    efa = es.frontier_ef_init(plan, feat)
    efb = efa.clone()
    for s in range(sched.S):
        ref.fused_halo_round_ref(xa, efa, sched, plan, sr, ep, wire, steps=(s, s + 1))
        blocks = [
            ref.halo_local_step_ref(xb[d0:d1], efb[d0:d1], sched, plan, sr, ep, wire, s, d0, d1) for d0, d1 in ranges
        ]
        rows = torch.cat([b[0] for b in blocks])
        scales = None if wire == "f32" else torch.cat([b[1] for b in blocks])
        for e0, e1 in reversed(ranges):
            ref.halo_recv_ref(xb[e0:e1], rows, scales, plan, s, e0, e1)
        assert torch.equal(xa[:, :-1], xb[:, :-1]), s
        assert torch.equal(efa, efb), s
        if wire != "f32":
            assert torch.equal(xa[:, -1], xb[:, -1]), s


def test_quantized_wire_dequantizes_to_quantize_halo():
    rng = np.random.default_rng(2)
    send = torch.as_tensor(rng.normal(size=(3, 7, 2)).astype(np.float32))
    ef = torch.as_tensor(rng.normal(scale=1e-3, size=(3, 7, 2)).astype(np.float32))
    for wire in ("int8", "fp8"):
        q, scales, ef_w = ref.quantize_halo_wire(send, ef, wire)
        assert q.dtype == ref.HALO_QUANT[wire][0] and scales.shape == (3, 2)
        deq, ef_q = ref.quantize_halo(send, ef, wire)
        assert torch.equal(ref.dequantize_halo(q, scales), deq)
        assert torch.equal(ef_w, ef_q)
