"""The port's evolving graphs, store and serving across processes
(``Solver(group=...)``'s ``apply_updates``, ``resolve`` and ``cache_dir``;
``GraphService(group=...)``) against the JAX reference and the port's one
process.

Four processes (``tests/torch_dist_evolve_ranks.py``, spawned once for the
module over ``gloo`` with a ``file://`` store, while this process computes
the answers they are held to) run every case at W = 2 and 4 ranks, P = 8:

* SSSP, CC and PageRank ``resolve`` after two random insert-and-delete
  batches on both frontiers (D = 4): x and rounds equal ``repro``'s
  ``Solver(backend="jit").resolve`` on one device bit for bit for SSSP and
  CC; for PageRank rounds equal ``repro``'s and x the port's one-process
  resolve (flushes and flush_bytes equal too);
* a rank's patched cells equal ``engine_sharded.rank_cells`` of a fresh
  schedule of the mutated graph (padded to the patched ``M``);
* a batch that makes a worker of the last rank outgrow ``M`` drops that δ
  on every rank, and the resolve over the rebuilt cells gives ``repro``'s;
* a cold group fills a store and a warm group builds no stripe and no plan
  piece on any rank; a one-process solver loads the group's stripes and
  pieces, a group a one-process solver's; a group restarted on the mutated
  graph builds no stripe;
* δ* is the same on every rank and ``repro``'s, after a reprobe too;
* ``GraphService(group=...)``: two waves around an update batch and a
  continuous replay give every request the one-process service's answer,
  and a lane fault, or a dispatch fault before a quantum's first gather,
  injected on one rank is every rank's;
* what stays refused raises, naming ``A9, third part``; the ranks load
  neither ``jax`` nor ``repro``.
"""

import functools
import importlib.util
import os
import pickle
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
from repro_torch.dist import engine_sharded as es  # noqa: E402
from repro_torch.evolve import EdgeBatch as TEdgeBatch  # noqa: E402
from repro_torch.ft.inject import FaultPlan, FaultSpec, inject  # noqa: E402
from repro_torch.graphs import formats as t_formats  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.launch.serve_graph import GraphService  # noqa: E402
from repro_torch.launch.service import QueryRequest, UpdateRequest, poisson_trace, replay_continuous  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("torch_dist_evolve_ranks", REPO / "tests" / "torch_dist_evolve_ranks.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)
WORLD = 4
STAT = {k: i for i, k in enumerate(R.STORE_STATS)}
BUILDS = ("schedule_builds", "plan_builds", "stripe_builds", "plan_shard_builds")


@functools.cache
def _graph(pkg, name):
    gen, formats = (j_gen, j_formats) if pkg == "j" else (t_gen, t_formats)
    return R.make_case_graph(name, gen, formats)


def _reference() -> dict:
    """Every answer of ``repro`` (``jit``, one device) and of the port in
    one process that the ranks are held to."""
    out = {}
    for name in R.PROBLEMS:
        ops = R.batch_ops(name, _graph("t", name))
        jg, tg = _graph("j", name), _graph("t", name)
        jsv = j_solve.Solver(jg, R.problem_of(name, j_solve, jg), n_workers=R.P, min_chunk=R.MIN_CHUNK,
                             delta=R.DELTA, backend="jit")
        tsv = t_solve.Solver(tg, R.problem_of(name, t_solve, tg), n_workers=R.P, min_chunk=R.MIN_CHUNK,
                             delta=R.DELTA, device="cpu")
        for pkg, sv, Batch in (("jit", jsv, JEdgeBatch), ("port", tsv, TEdgeBatch)):
            out[(pkg, name, "cold")] = sv.solve()
            for b, o in enumerate(ops):
                out[(pkg, name, b)] = sv.resolve(updates=Batch.from_ops(**o))
        out[("mutated", name)] = (tsv._sched_graph, tsv.bounds)
    # the outgrowing batch, over the one-process rebuild
    jg = _graph("j", "sssp")
    jsv = j_solve.Solver(jg, R.problem_of("sssp", j_solve, jg), n_workers=R.P, min_chunk=R.MIN_CHUNK,
                         delta=R.DELTA, backend="jit")
    jsv.solve()
    sched = jsv.schedule()
    jsv.apply_updates(JEdgeBatch.from_ops(**R.outgrow_ops(jg, jsv.bounds, sched.M)))
    out["outgrow_dropped"] = R.DELTA not in jsv._schedules
    out["outgrow"] = jsv.resolve(x0=jsv._last_x)
    out["outgrow_M"] = (sched.M, jsv.schedule().M)
    # δ*: the probe, a logged solve, two resolves, a reprobe
    jg = _graph("j", "pagerank")
    ops = R.batch_ops("pagerank", _graph("t", "pagerank"))
    return out, jg, ops


def _reference_auto(jg, ops, cache_dir) -> list:
    jsv = j_solve.Solver(jg, R.problem_of("pagerank", j_solve, jg), n_workers=R.P, min_chunk=R.MIN_CHUNK,
                         backend="jit", cache_dir=cache_dir)
    jsv.solve()
    first = jsv.resolve_delta("auto")
    assert first == min(jsv.delta_model.best_delta(), jsv.block_size)
    jsv.solve(delta=R.REPROBE_DELTA)
    for o in ops:
        jsv.resolve(updates=JEdgeBatch.from_ops(**o))
    old, new = jsv.reprobe_delta()
    return [first, old, new, jsv._auto_delta_incremental, len(jsv.persist.load_observations())]


def _serve(frontier, plan=None) -> dict:
    """The rank script's service run in one process."""
    g = _graph("t", "serve")
    svc = GraphService(g, algos=("sssp",), frontier=frontier, n_shards=R.SHARDS, device="cpu", **R.SERVE_KW)
    recs = {}
    with inject(plan or FaultPlan([])):
        for wave, sources in enumerate(R.SERVE_WAVES if plan is None else R.SERVE_WAVES[:1]):
            if wave:
                svc.submit_update(UpdateRequest(batch=TEdgeBatch.from_ops(**R.serve_update_ops(g))))
            for s in sources:
                svc.submit(QueryRequest(algo="sssp", payload=s))
            recs.update(R.result_rows(svc.drain()))
    if plan is not None:
        return {"results": recs, "counters": dict(svc.scheduler.counters), "clock": svc.clock_rounds}
    trace = poisson_trace(R.TRACE_RATE, R.TRACE_ROUNDS, g.n, seed=R.TRACE_SEED, mix=(("sssp", 1.0),))
    rep = replay_continuous(svc, trace)
    return {
        "results": recs,
        "updates": [(u.request_id, u.applied_clock, u.affected_rows) for u in svc.take_update_results()],
        "replay": {k: v for k, v in rep["report"].items() if k != "wall_s"},
        "replay_results": R.result_rows(rep["results"]), "counters": dict(svc.scheduler.counters),
        "clock": svc.clock_rounds,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(every rank's arrays, every rank's records, the references)``: the
    ranks run while this process computes the references."""
    out = tmp_path_factory.mktemp("ranks")
    init = f"file://{out / 'store'}"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_dist_evolve_ranks.py"), "--rank", str(r),
             "--world", str(WORLD), "--init", init, "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        reference, jg, ops = _reference()
        reference["auto"] = _reference_auto(jg, ops, tmp_path_factory.mktemp("jstore"))
        reference["serve"] = {f: _serve(f) for f in R.FRONTIERS}
        for name, site, frontier in R.FAULTS:
            reference[name] = _serve(frontier, FaultPlan([FaultSpec(site=site, at=1)]))
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    records = [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    return arrays, records, reference


def _counts(r) -> list:
    return [r.rounds, r.converged, r.flushes, r.flush_bytes, r.delta]


# --------------------------------------------------------------------------- #
# resolve and the patched cells
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("frontier", R.FRONTIERS)
@pytest.mark.parametrize("name", R.PROBLEMS)
@pytest.mark.parametrize("W", R.WIDTHS)
def test_grouped_resolve_equals_reference(runs, W, name, frontier):
    arrays, _, ref = runs
    for r in range(W):
        for step in ("cold", 0, 1):
            tag = f"{'cold' if step == 'cold' else 'resolve'}/{W}/{name}/{frontier}" + ("" if step == "cold" else f"/{step}")
            jr, one = ref[("jit", name, step)], ref[("port", name, step)]
            got = arrays[r][tag + "/counts"].tolist()
            assert got == _counts(jr) == _counts(one), (tag, r)
            np.testing.assert_array_equal(arrays[r][tag + "/x"], one.x)
            if name != "pagerank":
                np.testing.assert_array_equal(arrays[r][tag + "/x"], np.asarray(jr.x))
    assert ref[("jit", name, 1)].rounds < ref[("jit", name, "cold")].rounds or name == "pagerank"


@pytest.mark.parametrize("name", R.PROBLEMS)
@pytest.mark.parametrize("W", R.WIDTHS)
def test_patched_cells_equal_a_fresh_schedule(runs, W, name):
    """After two batches each rank's cells equal its workers' slice of a
    schedule built afresh on the mutated graph at the pinned bounds, padded
    to the patched ``M`` (``row_ptr`` included: only the kernels read it)."""
    arrays, _, ref = runs
    graph, bounds = ref[("mutated", name)]
    sr = R.problem_of(name, t_solve, graph).semiring
    fresh = t_engine.make_schedule(graph, R.P, R.DELTA, sr, min_chunk=R.MIN_CHUNK, bounds=bounds)
    for r in range(W):
        tag = f"cells/{W}/{name}"
        w0, w1, M, _ = arrays[r][tag + "/meta"]
        np.testing.assert_array_equal(arrays[r][tag + "/bounds"], bounds)
        want = es.rank_cells(fresh, int(w0), int(w1))
        assert (w0, w1) == tuple(R.P // W * np.array([r, r + 1])) and M >= fresh.M
        pad = int(M) - fresh.M
        for f, fill in (("val", sr.pad_edge_val.item()), ("dst_local", R.DELTA), ("src", 0)):
            padded = torch.nn.functional.pad(getattr(want, f), (0, pad), value=fill)
            np.testing.assert_array_equal(arrays[r][f"{tag}/{f}"], padded.numpy(), err_msg=f)
        for f in ("rows", "row_ptr"):
            np.testing.assert_array_equal(arrays[r][f"{tag}/{f}"], getattr(want, f).numpy(), err_msg=f)


@pytest.mark.parametrize("W", R.WIDTHS)
def test_outgrowing_m_drops_the_delta_on_every_rank(runs, W):
    """The inserts widen a cell of the last rank's worker past ``M``: every
    rank drops δ's cells (the drop is read from ``indptr`` for every touched
    worker), rebuilds them at the new ``M`` and resolves to ``repro``'s."""
    arrays, _, ref = runs
    M_old, M_new = ref["outgrow_M"]
    assert ref["outgrow_dropped"] and M_new > M_old
    for r in range(W):
        old, dropped, new, builds = arrays[r][f"outgrow/{W}/meta"]
        assert (old, dropped, new, builds) == (M_old, 1, M_new, 2), r
        assert arrays[r][f"outgrow/{W}/counts"].tolist() == _counts(ref["outgrow"])
        np.testing.assert_array_equal(arrays[r][f"outgrow/{W}/x"], np.asarray(ref["outgrow"].x))


# --------------------------------------------------------------------------- #
# the store
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("W", R.WIDTHS)
def test_warm_group_builds_nothing(runs, W):
    arrays, _, _ = runs
    P_r, D_r = R.P // W, R.SHARDS // W
    for r in range(W):
        cold, warm = arrays[r][f"store/{W}/cold/stats"], arrays[r][f"store/{W}/warm/stats"]
        # the probes' δ and δ*: each δ's cells build their P/W stripes once
        assert cold[STAT["stripe_builds"]] == P_r * cold[STAT["schedule_builds"]] > 0
        assert cold[STAT["plan_shard_builds"]] == D_r
        assert cold[STAT["solves"]] == 3  # the δ="auto" probes, then the solve
        assert warm[STAT["solves"]] == 1  # δ* from the store: no probe
        assert all(warm[STAT[k]] == 0 for k in BUILDS), warm
        assert (warm[STAT["stripe_loads"]], warm[STAT["plan_shard_loads"]]) == (P_r, D_r)
        for k in ("x", "counts"):
            np.testing.assert_array_equal(arrays[r][f"store/{W}/warm/{k}"], arrays[r][f"store/{W}/cold/{k}"])
            np.testing.assert_array_equal(arrays[r][f"store/{W}/warm/{k}"], arrays[0][f"store/{W}/cold/{k}"])


@pytest.mark.parametrize("W", R.WIDTHS)
def test_one_store_serves_a_group_and_one_process(runs, W):
    """A one-process solver on the group's store loads every stripe and
    plan piece; a group on a one-process solver's store builds none; a group
    restarted on the mutated graph (equal bounds) builds no stripe, since
    the ranks saved their patched ones, and gives the one-process answer."""
    arrays, _, _ = runs
    one = arrays[0][f"store/{W}/one/stats"]
    assert all(one[STAT[k]] == 0 for k in BUILDS), one
    assert (one[STAT["stripe_loads"]], one[STAT["plan_shard_loads"]]) == (R.P, R.SHARDS)
    np.testing.assert_array_equal(arrays[0][f"store/{W}/one/x"], arrays[0][f"store/{W}/cold/x"])
    g = _graph("t", "sssp")
    mutated, _ = g.apply_updates(TEdgeBatch.from_ops(**R.batch_ops("sssp", g)[0]))
    want = t_solve.Solver(mutated, R.problem_of("sssp", t_solve, g), n_workers=R.P, min_chunk=R.MIN_CHUNK,
                          delta=R.DELTA, partition_method="equal", device="cpu").solve()
    for r in range(W):
        for case in ("from_one", "mutated"):
            st = arrays[r][f"store/{W}/{case}/stats"]
            assert all(st[STAT[k]] == 0 for k in BUILDS), (case, st)
            assert st[STAT["stripe_loads"]] == R.P // W
        np.testing.assert_array_equal(arrays[r][f"store/{W}/from_one/x"], arrays[0][f"store/{W}/cold/x"])
        np.testing.assert_array_equal(arrays[r][f"store/{W}/mutated/x"], want.x)
        assert arrays[r][f"store/{W}/mutated/counts"].tolist() == _counts(want)


@pytest.mark.parametrize("W", R.WIDTHS)
def test_delta_star_and_reprobe_equal_reference(runs, W):
    """δ* after the probe, the reprobe's old and new δ* and the incremental
    δ*: the same on every rank, and ``repro``'s; the store's observation
    log holds ``repro``'s rows, one a solve (rank 0 alone writes it)."""
    arrays, _, ref = runs
    for r in range(W):
        assert arrays[r][f"auto/{W}"].tolist() == ref["auto"], r


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def _assert_same_rows(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        assert g.keys() == w.keys()
        for f, wv in w.items():
            if f == "x":
                np.testing.assert_array_equal(g[f], wv, err_msg=rid)
            else:
                assert g[f] == wv, (rid, f)


@pytest.mark.parametrize("frontier", R.FRONTIERS)
@pytest.mark.parametrize("W", R.WIDTHS)
def test_grouped_service_equals_one_process(runs, W, frontier):
    """Two waves of SSSP around an update batch, then a continuous replay:
    every rank returns every request the one-process service's answer, with
    its round clocks, and the same update record, replay report and
    counters; no lane faulted."""
    _, records, ref = runs
    want = ref["serve"][frontier]
    assert want["counters"]["updates_applied"] == 1 and want["replay"]["completed"] > 0
    for r in range(W):
        got = records[r][f"serve/{W}/{frontier}"]
        _assert_same_rows(got["results"], want["results"])
        _assert_same_rows(got["replay_results"], want["replay_results"])
        for k in ("updates", "replay", "counters", "clock"):
            assert got[k] == want[k], (r, k)
        assert got["counters"]["lane_faults"] == 0


@pytest.mark.parametrize("W", R.WIDTHS)
def test_lane_fault_on_one_rank_is_every_ranks(runs, W):
    """A ``scheduler.lane`` fault injected on the last rank alone: every
    rank evicts and requeues, as the one-process service does under the
    same fault, and all answer alike."""
    _, records, ref = runs
    want = ref["fault"]
    assert want["counters"]["lane_faults"] == 1
    for r in range(W):
        got = records[r][f"fault/{W}"]
        _assert_same_rows(got["results"], want["results"])
        assert (got["counters"], got["clock"]) == (want["counters"], want["clock"]), r


@pytest.mark.parametrize("W", R.WIDTHS)
def test_dispatch_fault_on_one_rank_is_every_ranks(runs, W):
    """A ``kernel.dispatch`` fault injected on the last rank alone, before
    the quantum's first gather, on the halo frontier: every rank raises in
    ``BatchStepper.run``, evicts and requeues, as the one-process service
    does under the same fault, and no rank is left in a gather."""
    _, records, ref = runs
    want = ref["dispatch_fault"]
    assert want["counters"]["lane_faults"] == 1
    for r in range(W):
        got = records[r][f"dispatch_fault/{W}"]
        _assert_same_rows(got["results"], want["results"])
        assert (got["counters"], got["clock"]) == (want["counters"], want["clock"]), r


# --------------------------------------------------------------------------- #
# refusals, imports, the patch in one process
# --------------------------------------------------------------------------- #
def test_what_stays_refused_across_processes(runs):
    arrays, _, _ = runs
    for r in range(WORLD):
        got = list(arrays[r]["refusals"])
        want = ["degrade: NotImplementedError", "service degrade: NotImplementedError",
                "checkpointed: NotImplementedError"] + (["submit: ValueError"] if r else [])
        assert len(got) == len(want)
        for line, start in zip(got, want):
            assert line.startswith(start), line
            if "NotImplementedError" in start:
                assert "A9, third part" in line, line


def test_ranks_load_neither_jax_nor_repro(runs):
    arrays, _, _ = runs
    for r in range(WORLD):
        assert arrays[r]["foreign_modules"].size == 0, arrays[r]["foreign_modules"]


@pytest.mark.parametrize("split", [(0, 8), (0, 4), (4, 8), (2, 6)], ids=lambda s: f"w{s[0]}-{s[1]}")
def test_patch_rank_cells_equals_the_one_process_patch(split):
    """``patch_rank_cells`` over workers ``[w0, w1)`` equals those workers'
    slice of the one-process patched schedule, whichever workers the batch
    touched, and leaves the cells it was given as they were."""
    w0, w1 = split
    g = _graph("t", "sssp")
    prob = R.problem_of("sssp", t_solve, g)
    sv = t_solve.Solver(g, prob, n_workers=R.P, min_chunk=R.MIN_CHUNK, delta=R.DELTA, device="cpu")
    sched = sv.schedule()
    bounds = sv.bounds
    cells, host = es.rank_schedule(g, bounds, R.DELTA, prob.semiring.pad_edge_val, w0, w1, "cpu")
    before = {f: getattr(cells, f).clone() for f in ("val", "dst_local", "row_ptr")}
    sv.apply_updates(TEdgeBatch.from_ops(**R.batch_ops("sssp", g)[0]))
    touched = sv._touched_workers(sv._last_report.affected_rows)
    assert sv.schedule() is not sched and touched.size > 1
    stripes = {int(w): t_formats.build_worker_stripe(sv._sched_graph, int(bounds[w]), int(bounds[w + 1]), sched.S,
                                              R.DELTA, prob.semiring.pad_edge_val)
               for w in touched if w0 <= w < w1}
    patched, phost = es.patch_rank_cells(cells, host, stripes, prob.semiring.pad_edge_val, sv._sched_graph.nnz)
    want = es.rank_cells(sv.schedule(), w0, w1)
    for f in ("val", "dst_local", "rows", "row_ptr"):
        assert torch.equal(getattr(patched, f), getattr(want, f)), f
    np.testing.assert_array_equal(phost["src"], want.src.numpy())
    np.testing.assert_array_equal(phost["dst_local"], want.dst_local.numpy())
    for f, t in before.items():
        assert torch.equal(getattr(cells, f), t), f
    assert patched.edges == sv._sched_graph.nnz
