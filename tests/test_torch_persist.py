"""Persistence in the port (``Solver(cache_dir=...)``) against the reference.

The same numpy inputs go through ``repro`` (``Solver(backend="jit")``) and
``repro_torch`` on the CPU, every store under ``tmp_path``:

* a second solver on the same ``cache_dir`` (a restarted process) builds no
  schedule, stripe or plan and runs no probe, and gives x, rounds,
  converged, flushes and flush_bytes equal bit for bit to the cold run and
  to the reference's ``jit`` solve: PageRank (``delta="auto"``), SSSP
  (int32), rwr (F = 4), a ``solve_batch`` of Q = 3 and a halo plan at
  D = 2; a real subprocess that imports only ``repro_torch`` does the same;
* a loaded schedule and plan equal a fresh build field by field, the
  derived ``row_ptr``, ``owned_flat`` and ``dump_last`` included, and the
  reference's arrays;
* every mismatch (graph, problem constants, ``CACHE_FORMAT`` or version
  bump, a corrupted entry) is a miss, never a wrong answer; the fault
  sites ``persist.write`` and ``persist.read`` read as misses; concurrent
  writers never publish torn bytes;
* the port's graph, stripe and plan-shard fingerprints hash the
  reference's bytes, its namespaces differ, and one shared ``cache_dir``
  serves each package only its own entries;
* ``reprobe_delta`` gives the reference's ``(old, new)``; ``reprobe_every``
  and batch observations drive it;
* evolving graphs: a restart after a one-worker mutation builds one stripe,
  after ``resolve(updates=...)`` none; the per-regime δ-models round-trip;
* the four partitioners give the reference's bounds.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.solve as j_solve  # noqa: E402
from repro import evolve as j_evolve  # noqa: E402
from repro.algorithms.jacobi import jacobi_graph as j_jacobi_graph  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.dist import engine_sharded as j_sharded  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
from repro.graphs import partition as j_partition  # noqa: E402
from repro.persist import keys as j_keys  # noqa: E402
import repro_torch.solve as t_solve  # noqa: E402
from repro_torch import evolve as t_evolve  # noqa: E402
from repro_torch.algorithms.jacobi import jacobi_graph as t_jacobi_graph  # noqa: E402
from repro_torch.core import delta_model as t_delta_model  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.dist import engine_sharded as t_sharded  # noqa: E402
from repro_torch.ft.inject import FaultPlan, FaultSpec, inject  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.graphs import partition as t_partition  # noqa: E402
from repro_torch.persist import SolverCache, keys as t_keys  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
P, MIN_CHUNK = 4, 16
PR_GRAPH = ("twitter", dict(scale=9, efactor=8, kind="pagerank"))
SSSP_GRAPH = ("kron", dict(scale=8, efactor=8, kind="sssp"))
SCHED_FIELDS = ("src", "val", "dst_local", "rows", "row_ptr")
PLAN_FIELDS = ("src_loc", "rows_loc", "send_idx", "recv_idx", "gather_index", "owned_flat", "dump_last")


def _graphs(spec):
    kind, kw = spec
    return t_gen.make_graph(kind, **kw), j_gen.make_graph(kind, **kw)


def _problem(pkg, name):
    if name == "pagerank":
        return pkg.pagerank_problem()
    if name == "sssp":
        return pkg.sssp_problem()
    return pkg.rwr_embedding_problem(feature_dim=4)


CASES = {  # name -> (graph, delta)
    "pagerank": (PR_GRAPH, "auto"),
    "sssp": (SSSP_GRAPH, 32),
    "rwr": (PR_GRAPH, 32),
}


def _port(g, problem, cache_dir, **kw):
    kw.setdefault("n_workers", P)
    kw.setdefault("min_chunk", MIN_CHUNK)
    return t_solve.Solver(g, problem, cache_dir=cache_dir, device="cpu", **kw)


def _ref(g, problem, **kw):
    kw.setdefault("n_workers", P)
    kw.setdefault("min_chunk", MIN_CHUNK)
    return j_solve.Solver(g, problem, backend="jit", **kw)


def _assert_warm(solver, solves=1):
    s = solver.stats
    assert s["schedule_builds"] == 0 and s["stripe_builds"] == 0, s
    assert s["plan_builds"] == 0 and s["plan_shard_builds"] == 0, s
    assert s["cache_loads"] >= 1, s
    assert s["solves"] == solves, s  # no probe solve


def _assert_same(got, want):
    assert (got.rounds, got.converged, got.flushes, got.flush_bytes) == (
        want.rounds,
        want.converged,
        want.flushes,
        want.flush_bytes,
    )
    np.testing.assert_array_equal(np.asarray(got.x), np.asarray(want.x))


# --------------------------------------------------------------------------- #
# warm restarts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(CASES))
def test_warm_restart_equals_cold_and_reference(tmp_path, name):
    spec, delta = CASES[name]
    tg, jg = _graphs(spec)
    cold = _port(tg, _problem(t_solve, name), tmp_path, delta=delta)
    r_cold = cold.solve()
    assert cold.stats["stripe_builds"] >= P and cold.stats["schedule_builds"] >= 1
    warm = _port(tg, _problem(t_solve, name), tmp_path, delta=delta)
    r_warm = warm.solve()
    _assert_warm(warm)
    assert warm.resolve_delta() == r_cold.delta
    _assert_same(r_warm, r_cold)
    r_ref = _ref(jg, _problem(j_solve, name), delta=r_cold.delta).solve()
    _assert_same(r_warm, r_ref)


def test_auto_delta_loads_without_probing_and_equals_reference(tmp_path):
    tg, jg = _graphs(PR_GRAPH)
    cold = _port(tg, t_solve.pagerank_problem(), tmp_path, delta="auto")
    cold.solve()
    assert cold.stats["solves"] == 3  # two probes and the solve
    warm = _port(tg, t_solve.pagerank_problem(), tmp_path, delta="auto")
    assert warm.delta_model == cold.delta_model
    ref = _ref(jg, j_solve.pagerank_problem(), delta="auto")
    assert warm.resolve_delta("auto") == ref.resolve_delta("auto") == cold.resolve_delta("auto")
    assert warm.stats["solves"] == 0 and warm.stats["cache_loads"] == 1
    assert warm.delta_model.to_dict() == ref.delta_model.to_dict()


def test_warm_batch_round_trip(tmp_path):
    tg, jg = _graphs(SSSP_GRAPH)
    sources = [0, 7, 19]
    cold = _port(tg, t_solve.sssp_problem(), tmp_path, delta=32)
    b_cold = cold.solve_batch(t_solve.multi_source_x0(tg, sources))
    warm = _port(tg, t_solve.sssp_problem(), tmp_path, delta=32)
    b_warm = warm.solve_batch(t_solve.multi_source_x0(tg, sources))
    _assert_warm(warm)
    b_ref = j_solve.solve_batch(_ref(jg, j_solve.sssp_problem(), delta=32), j_solve.multi_source_x0(jg, sources))
    for want in (b_cold, b_ref):
        assert (b_warm.rounds, b_warm.flushes, b_warm.flush_bytes) == (want.rounds, want.flushes, want.flush_bytes)
        np.testing.assert_array_equal(b_warm.x, np.asarray(want.x))
        np.testing.assert_array_equal(b_warm.rounds_per_query, np.asarray(want.rounds_per_query))
        np.testing.assert_array_equal(b_warm.converged, np.asarray(want.converged))


def test_warm_halo_plan_round_trip(tmp_path):
    """D = 2: the plan and its shard pieces load; the f32 halo solve equals
    the reference's replicated jit solve bit for bit."""
    tg, jg = _graphs(PR_GRAPH)
    kw = dict(delta=64, frontier="halo", n_shards=2)
    cold = _port(tg, t_solve.pagerank_problem(), tmp_path, **kw)
    r_cold = cold.solve()
    assert cold.stats["plan_builds"] == 1 and cold.stats["plan_shard_builds"] == 2
    warm = _port(tg, t_solve.pagerank_problem(), tmp_path, **kw)
    r_warm = warm.solve()
    _assert_warm(warm)
    assert warm.stats["cache_loads"] >= 2  # the schedule and the plan
    _assert_same(r_warm, r_cold)
    np.testing.assert_array_equal(r_warm.x, np.asarray(_ref(jg, j_solve.pagerank_problem(), delta=64).solve().x))
    # a restart whose whole plan is gone assembles it from the shard pieces
    next((tmp_path / f"v{t_keys.CACHE_FORMAT}").rglob("plan_d*_D2.npz")).unlink()
    pieces = _port(tg, t_solve.pagerank_problem(), tmp_path, **kw)
    _assert_same(pieces.solve(), r_cold)
    assert pieces.stats["plan_shard_loads"] == 2 and pieces.stats["plan_builds"] == 0


def test_subprocess_with_only_the_port_solves_warm(tmp_path):
    tg, _ = _graphs(PR_GRAPH)
    r_cold = _port(tg, t_solve.pagerank_problem(), tmp_path / "cache", delta="auto").solve()
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from repro_torch.graphs.generators import make_graph\n"
        "from repro_torch.solve import Solver, pagerank_problem\n"
        "g = make_graph('twitter', scale=9, efactor=8, kind='pagerank')\n"
        f"s = Solver(g, pagerank_problem(), n_workers={P}, min_chunk={MIN_CHUNK}, delta='auto',\n"
        "           cache_dir=sys.argv[1], device='cpu')\n"
        "r = s.solve()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "np.save(sys.argv[2], r.x)\n"
        "print(json.dumps(dict(s.stats, rounds=r.rounds)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "cache"), str(tmp_path / "x.npy")],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["schedule_builds"] == stats["stripe_builds"] == stats["plan_builds"] == 0, stats
    assert stats["solves"] == 1 and stats["cache_loads"] >= 2 and stats["rounds"] == r_cold.rounds
    np.testing.assert_array_equal(np.load(tmp_path / "x.npy"), r_cold.x)


# --------------------------------------------------------------------------- #
# serialisation: loaded against fresh, port against reference
# --------------------------------------------------------------------------- #
def test_loaded_schedule_and_plan_equal_fresh_builds_and_reference(tmp_path):
    tg, jg = _graphs(PR_GRAPH)
    kw = dict(delta=64, frontier="halo", n_shards=2)
    _port(tg, t_solve.pagerank_problem(), tmp_path, **kw).solve()
    warm = _port(tg, t_solve.pagerank_problem(), tmp_path, **kw)
    sched = warm.schedule()
    plan = warm.frontier_plan(sched)
    _assert_warm(warm, solves=0)
    sr = t_solve.pagerank_problem().semiring
    fresh = t_engine.make_schedule(tg, P, 64, sr, min_chunk=MIN_CHUNK)
    for f in SCHED_FIELDS:
        assert torch.equal(getattr(sched, f), getattr(fresh, f)), f
    assert (sched.S, sched.M, sched.edges, sched.padding_overhead) == (
        fresh.S, fresh.M, fresh.edges, fresh.padding_overhead)
    np.testing.assert_array_equal(sched.block_bounds, fresh.block_bounds)
    fresh_plan = t_sharded.make_frontier_plan(fresh, 2)
    for f in PLAN_FIELDS:
        assert torch.equal(getattr(plan, f), getattr(fresh_plan, f)), f
    for f in ("D", "P_loc", "L", "H", "S", "delta", "n", "boundary_entries_per_round"):
        assert getattr(plan, f) == getattr(fresh_plan, f), f
    np.testing.assert_array_equal(plan.vertex_bounds, fresh_plan.vertex_bounds)
    np.testing.assert_array_equal(plan.halo_sizes, fresh_plan.halo_sizes)
    # the host arrays are the reference's, key for key
    j_sched = j_engine.make_schedule(jg, P, 64, j_solve.pagerank_problem().semiring, min_chunk=MIN_CHUNK)
    want = j_sched.to_host_arrays()
    got = sched.to_host_arrays()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want = j_sharded.make_frontier_plan(j_sched, 2).to_host_arrays()
    got = plan.to_host_arrays()
    assert set(got) == set(want) - {"owned_flat"}
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # and the reference's own arrays load into the port
    again = t_sharded.FrontierPlan.from_host_arrays(want, "cpu")
    for f in PLAN_FIELDS:
        assert torch.equal(getattr(again, f), getattr(fresh_plan, f)), f
    again = t_engine.DeviceSchedule.from_host_arrays(j_sched.to_host_arrays(), "cpu")
    for f in SCHED_FIELDS:
        assert torch.equal(getattr(again, f), getattr(fresh, f)), f


@pytest.mark.parametrize("field", ["gather_index", "recv_idx"])
def test_inconsistent_plan_arrays_are_refused(field):
    tg, _ = _graphs(PR_GRAPH)
    sched = t_engine.make_schedule(tg, P, 64, t_solve.pagerank_problem().semiring, min_chunk=MIN_CHUNK)
    arrays = t_sharded.make_frontier_plan(sched, 2).to_host_arrays()
    if field == "gather_index":  # an owned slot that names another vertex
        arrays[field] = arrays[field].copy()
        arrays[field][0, 0] += 1
    else:  # a wrong shape
        arrays[field] = arrays[field][:, :, :-1]
    with pytest.raises(ValueError):
        t_sharded.FrontierPlan.from_host_arrays(arrays, "cpu")


# --------------------------------------------------------------------------- #
# invalidation: every mismatch is a miss, never a wrong answer
# --------------------------------------------------------------------------- #
def _pr_port(cache_dir, graph=None, problem=None, **kw):
    tg = graph if graph is not None else _graphs(PR_GRAPH)[0]
    return _port(tg, problem or t_solve.pagerank_problem(), cache_dir, delta=kw.pop("delta", 64), **kw)


def test_graph_content_mismatch_is_cold(tmp_path):
    tg, _ = _graphs(PR_GRAPH)
    _pr_port(tmp_path, tg).solve()
    other = _pr_port(tmp_path, tg.with_values((tg.values * np.float32(0.5)).astype(np.float32)))
    other.solve()
    assert other.stats["schedule_builds"] == 1 and other.stats["stripe_builds"] == P


def test_problem_constants_change_the_namespace(tmp_path):
    base = _pr_port(tmp_path)
    base.solve()
    other = _pr_port(tmp_path, problem=t_solve.pagerank_problem(damping=0.9))
    assert other.persist.namespace != base.persist.namespace
    r = other.solve()
    # the schedule holds graph bytes alone: the stripes are shared
    assert other.stats["schedule_builds"] == 0 and other.stats["stripe_loads"] == P
    want = _ref(_graphs(PR_GRAPH)[1], j_solve.pagerank_problem(damping=0.9), delta=64).solve()
    _assert_same(r, want)


def test_jacobi_right_hand_sides_change_the_namespace(tmp_path):
    rng = np.random.default_rng(0)
    n = 128
    rows = np.repeat(np.arange(n), 4)
    cols = (rows + rng.integers(1, n, rows.shape[0])) % n
    vals = rng.normal(size=rows.shape[0]).astype(np.float32) * 0.1
    diag = np.full(n, 4.0, np.float32)
    g = t_jacobi_graph(n, rows, cols, vals, diag)
    b1, b2 = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    s1 = _port(g, t_solve.jacobi_problem(diag, b1), tmp_path, delta=32)
    s2 = _port(g, t_solve.jacobi_problem(diag, b2), tmp_path, delta=32)
    s1b = _port(g, t_solve.jacobi_problem(diag, b1), tmp_path, delta=32)
    assert s1.persist.namespace != s2.persist.namespace
    assert s1.persist.namespace == s1b.persist.namespace
    r = s2.solve()
    jg = j_jacobi_graph(n, rows, cols, vals, diag)
    _assert_same(r, _ref(jg, j_solve.jacobi_problem(diag, b2), delta=32).solve())


@pytest.mark.parametrize("bump", ["CACHE_FORMAT", "_VERSION"])
def test_format_or_version_bump_is_cold(tmp_path, monkeypatch, bump):
    r_cold = _pr_port(tmp_path).solve()
    monkeypatch.setattr(t_keys, bump, 3 if bump == "CACHE_FORMAT" else "bumped")
    other = _pr_port(tmp_path)
    _assert_same(other.solve(), r_cold)
    assert other.stats["schedule_builds"] == 1 and other.stats["stripe_builds"] == P


def test_corrupt_entries_fall_back_cold(tmp_path):
    tg, _ = _graphs(PR_GRAPH)
    kw = dict(delta="auto", frontier="halo", n_shards=2)
    r_cold = _pr_port(tmp_path, tg, **kw).solve()
    corrupted = 0
    for path in tmp_path.rglob("*"):
        if path.suffix in (".npz", ".json", ".jsonl"):
            path.write_bytes(b"\x00corrupt\xff")
            corrupted += 1
    assert corrupted >= 2 * P + 4  # stripes, plan shards, schedules, plan, model, log
    warm = _pr_port(tmp_path, tg, **kw)
    assert warm.delta_model is None  # the model missed too
    _assert_same(warm.solve(), r_cold)
    assert warm.stats["schedule_builds"] >= 1 and warm.stats["plan_builds"] == 1
    assert warm.stats["stripe_loads"] == warm.stats["plan_shard_loads"] == 0


def test_truncated_observation_line_skipped(tmp_path):
    solver = _pr_port(tmp_path)
    solver.solve()
    store = solver.persist
    n_before = len(store.load_observations())
    assert n_before == 1
    with open(store.dir / "observations.jsonl", "a") as f:
        f.write('{"delta": 64, "rou')  # killed mid-write
    assert len(store.load_observations()) == n_before
    store.record_observation(64, 5, 0.1, backend="kernel")
    store.record_observation(64, 6, 0.1, backend="kernel")
    rows = store.load_observations()
    assert len(rows) == n_before + 1 and rows[-1]["rounds"] == 6


def test_observation_log_compacts_to_its_newest_rows(tmp_path, monkeypatch):
    store = SolverCache(tmp_path, "f" * 16)
    monkeypatch.setattr(SolverCache, "_OBS_MAX_BYTES", 2000)
    monkeypatch.setattr(SolverCache, "_OBS_KEEP_ROWS", 5)
    for r in range(40):
        store.record_observation(16, r + 1, 0.0, backend="kernel")
    rows = store.load_observations()
    assert len(rows) < 40 and rows[-1]["rounds"] == 40
    assert [row["rounds"] for row in rows] == list(range(41 - len(rows), 41))


# --------------------------------------------------------------------------- #
# faults at the store's sites
# --------------------------------------------------------------------------- #
def _stripe(fill: int) -> dict:
    return {
        "src": np.full(8, fill, np.int64),
        "val": np.full(8, float(fill), np.float32),
        "dst_local": np.arange(8, dtype=np.int64),
        "rows": np.arange(8, dtype=np.int64),
    }


@pytest.mark.parametrize("kind", ["torn", "corrupt", "eio"])
def test_injected_write_fault_reads_as_miss(tmp_path, kind):
    cache = SolverCache(tmp_path, "f" * 16)
    digest = "a" * 24
    with inject(FaultPlan([FaultSpec(site="persist.write", kind=kind)])) as plan:
        cache.save_stripe(digest, _stripe(3))  # must not raise
    assert plan.sites_fired() == ["persist.write"]
    assert cache.load_stripe(digest) is None  # corruption ⇒ miss
    cache.save_stripe(digest, _stripe(3))  # a clean retry heals
    np.testing.assert_array_equal(cache.load_stripe(digest)["src"], _stripe(3)["src"])


def test_injected_read_fault_is_transient_miss(tmp_path):
    cache = SolverCache(tmp_path, "f" * 16)
    digest = "b" * 24
    cache.save_stripe(digest, _stripe(7))
    with inject(FaultPlan([FaultSpec(site="persist.read", kind="eio")])):
        assert cache.load_stripe(digest) is None
    np.testing.assert_array_equal(cache.load_stripe(digest)["val"], _stripe(7)["val"])


def test_faulted_solver_writes_heal_on_the_next_restart(tmp_path):
    """Every write of a cold solver torn: the next solver misses everything
    and answers the same; its clean writes make the third warm."""
    r_cold = None
    with inject(FaultPlan([FaultSpec(site="persist.write", kind="torn", times=-1, every=1)])):
        r_cold = _pr_port(tmp_path).solve()
    second = _pr_port(tmp_path)
    _assert_same(second.solve(), r_cold)
    assert second.stats["stripe_builds"] == P
    third = _pr_port(tmp_path)
    _assert_same(third.solve(), r_cold)
    _assert_warm(third)


def test_concurrent_writers_never_publish_torn_bytes(tmp_path):
    cache = SolverCache(tmp_path, "f" * 16)
    digest = "c" * 24
    errors = []

    def hammer(fill):
        try:
            for _ in range(30):
                cache.save_stripe(digest, _stripe(fill))
                got = cache.load_stripe(digest)
                if got is None:
                    continue  # a miss is legal mid-race; torn data is not
                v = int(got["src"][0])
                assert v in (1, 2)
                assert (got["src"] == v).all() and (got["val"] == float(v)).all()
        except Exception as err:  # pragma: no cover - failure path
            errors.append(err)

    threads = [threading.Thread(target=hammer, args=(f,)) for f in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    final = cache.load_stripe(digest)
    assert final is not None and int(final["src"][0]) in (1, 2)
    assert not list(cache.version_dir.rglob("*.tmp-*"))


def test_fault_plan_json_round_trip():
    plan = FaultPlan([FaultSpec(site="persist.write", kind="torn", every=2, times=3),
                      FaultSpec(site="persist.read", kind="eio", p=0.5, match={"key": "x"})], seed=7)
    again = FaultPlan.loads(plan.dumps())
    assert again.to_json() == plan.to_json()
    with pytest.raises(ValueError):
        FaultSpec(site="persist.write", kind="melt")


# --------------------------------------------------------------------------- #
# keys against the reference's; one cache_dir shared by both packages
# --------------------------------------------------------------------------- #
def test_fingerprints_hash_the_reference_bytes(monkeypatch):
    tg, jg = _graphs(SSSP_GRAPH)
    assert t_keys.graph_fingerprint(tg) == j_keys.graph_fingerprint(jg)
    t_sr, j_sr = t_solve.sssp_problem().semiring, j_solve.sssp_problem().semiring
    bounds = t_partition.balanced_blocks(tg, P)
    S = -(-int(np.diff(bounds).max()) // 32)
    args = [(int(bounds[w]), int(bounds[w + 1]), S, 32) for w in range(P)]
    ours = [t_keys.stripe_fingerprint(tg, *a, t_sr.pad_edge_val) for a in args]
    theirs = [j_keys.stripe_fingerprint(jg, *a, j_sr.pad_edge_val) for a in args]
    assert not set(ours) & set(theirs)  # the environments differ
    t_sched = t_engine.make_schedule(tg, P, 32, t_sr, min_chunk=MIN_CHUNK)
    j_sched = j_engine.make_schedule(jg, P, 32, j_sr, min_chunk=MIN_CHUNK)
    monkeypatch.setattr(t_keys, "env_fingerprint", j_keys.env_fingerprint)
    assert [t_keys.stripe_fingerprint(tg, *a, t_sr.pad_edge_val) for a in args] == theirs
    for lo, hi, w0, w1 in ((0, int(bounds[2]), 0, 2), (int(bounds[2]), tg.n, 2, 4)):
        assert t_keys.plan_shard_fingerprint(t_sched, lo, hi, w0, w1) == j_keys.plan_shard_fingerprint(
            j_sched, lo, hi, w0, w1)


def test_shared_cache_dir_serves_each_package_its_own_entries(tmp_path):
    tg, jg = _graphs(SSSP_GRAPH)
    j_first = j_solve.Solver(jg, j_solve.sssp_problem(), n_workers=P, min_chunk=MIN_CHUNK, delta=32,
                             backend="jit", cache_dir=tmp_path)
    r_ref = j_first.solve()
    t_first = _port(tg, t_solve.sssp_problem(), tmp_path, delta=32)
    assert t_first.persist.namespace != j_first.persist.namespace
    _assert_same(t_first.solve(), r_ref)
    assert t_first.stats["stripe_builds"] == P and t_first.stats["stripe_loads"] == 0
    t_second = _port(tg, t_solve.sssp_problem(), tmp_path, delta=32)
    _assert_same(t_second.solve(), r_ref)
    _assert_warm(t_second)
    j_second = j_solve.Solver(jg, j_solve.sssp_problem(), n_workers=P, min_chunk=MIN_CHUNK, delta=32,
                              backend="jit", cache_dir=tmp_path)
    j_second.solve()
    assert j_second.stats["schedule_builds"] == 0 and j_second.stats["stripe_builds"] == 0


def test_no_cache_dir_no_persistence(tmp_path):
    tg, _ = _graphs(PR_GRAPH)
    solver = t_solve.Solver(tg, t_solve.pagerank_problem(), n_workers=P, delta=64, device="cpu")
    solver.solve()
    assert solver.persist is None and solver.stats["cache_loads"] == 0
    assert not any(tmp_path.iterdir())
    with pytest.raises(ValueError, match="cache_dir"):
        solver.reprobe_delta()


# --------------------------------------------------------------------------- #
# δ re-probing
# --------------------------------------------------------------------------- #
def test_reprobe_delta_equals_reference(tmp_path):
    """The same explicit-δ solves, then reprobe_delta: the same (old, new),
    the same refitted model, and a restart serves the new δ*."""
    tg, jg = _graphs(PR_GRAPH)
    port = _port(tg, t_solve.pagerank_problem(), tmp_path / "t", delta="auto")
    ref = j_solve.Solver(jg, j_solve.pagerank_problem(), n_workers=P, min_chunk=MIN_CHUNK, delta="auto",
                         backend="jit", cache_dir=tmp_path / "j")
    for d in (16, 48, 96, 16):
        _assert_same(port.solve(delta=d), ref.solve(delta=d))
    got, want = port.reprobe_delta(), ref.reprobe_delta()
    assert got == want
    assert port.delta_model.to_dict() == ref.delta_model.to_dict()
    rows = port.persist.load_observations()
    assert [(r["delta"], r["rounds"]) for r in rows] == [
        (r["delta"], r["rounds"]) for r in ref.persist.load_observations()]
    warm = _port(tg, t_solve.pagerank_problem(), tmp_path / "t", delta="auto")
    assert warm.resolve_delta("auto") == got[1] and warm.stats["solves"] == 0


def test_reprobe_every_refits_inline(tmp_path):
    solver = _pr_port(tmp_path, delta="auto", reprobe_every=1)
    solver.solve()
    # the probes and the solve logged ≥ reprobe_every rows, so a refit ran
    assert solver._obs_since_refit == 0
    assert solver.persist.load_delta_model() is not None


def test_batch_observations_drive_reprobe(tmp_path):
    tg, _ = _graphs(SSSP_GRAPH)
    solver = _port(tg, t_solve.sssp_problem(), tmp_path, delta="auto", reprobe_every=1)
    b = solver.solve_batch(t_solve.multi_source_x0(tg, [0, 7]))
    obs = solver.persist.load_observations()
    assert obs[-1]["kind"] == "batch" and obs[-1]["rounds"] == b.rounds
    assert solver._obs_since_refit == 0  # the batch crossed reprobe_every
    st = t_solve.BatchStepper(solver, capacity=2)
    st.admit(t_solve.multi_source_x0(tg, [3])[0])
    retired = []
    while st.occupancy:
        retired += st.run(2)
    last = solver.persist.load_observations()[-1]
    assert last["kind"] == "batch" and last["rounds"] == retired[0].rounds


# --------------------------------------------------------------------------- #
# evolving graphs
# --------------------------------------------------------------------------- #
def _edge_list(g):
    return g.indices.astype(np.int64), np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))


EVOLVE_KW = dict(n_workers=P, delta=16, partition_method="equal")


def test_restart_after_one_worker_mutation_builds_one_stripe(tmp_path):
    tg, jg = (g for g in _graphs(("kron", dict(scale=7, efactor=8, kind="sssp", seed=6))))
    prob = t_solve.sssp_problem(source=int(np.argmax(tg.out_degree)))
    s1 = t_solve.Solver(tg, prob, cache_dir=tmp_path, device="cpu", **EVOLVE_KW)
    s1.solve()
    assert (s1.stats["stripe_builds"], s1.stats["stripe_loads"]) == (P, 0)
    src, dst = _edge_list(tg)
    pick = np.flatnonzero(dst < s1.bounds[1])[:2]  # rows of worker 0
    ops = dict(deletes=[(int(src[e]), int(dst[e])) for e in pick])
    tg2, report = tg.apply_updates(t_evolve.EdgeBatch.from_ops(**ops))
    assert np.all(report.affected_rows < s1.bounds[1])
    s2 = t_solve.Solver(tg2, prob, cache_dir=tmp_path, device="cpu", **EVOLVE_KW)  # a restarted process
    r2 = s2.solve()
    assert (s2.stats["stripe_builds"], s2.stats["stripe_loads"]) == (1, P - 1)
    jg2, _ = jg.apply_updates(j_evolve.EdgeBatch.from_ops(**ops))
    j_prob = j_solve.sssp_problem(source=int(np.argmax(jg.out_degree)))
    _assert_same(r2, j_solve.Solver(jg2, j_prob, backend="jit", **EVOLVE_KW).solve())


def test_resolve_persists_touched_stripes_and_both_regimes(tmp_path):
    tg, jg = (g for g in _graphs(("kron", dict(scale=7, efactor=8, kind="sssp", seed=6))))
    prob = t_solve.sssp_problem(source=int(np.argmax(tg.out_degree)))
    s1 = t_solve.Solver(tg, prob, cache_dir=tmp_path, device="cpu", **EVOLVE_KW)
    s1.solve()
    ns_before = s1.persist.namespace
    rng = np.random.default_rng(3)
    src, dst = _edge_list(tg)
    pick = rng.choice(tg.nnz, size=2, replace=False)
    ops = dict(deletes=[(int(src[e]), int(dst[e])) for e in pick])
    r1 = s1.resolve(updates=t_evolve.EdgeBatch.from_ops(**ops))
    assert s1.persist.namespace != ns_before
    rows = s1.persist.load_observations()  # the log followed the graph
    assert [r["regime"] for r in rows] == ["cold", "incremental"]
    s2 = t_solve.Solver(s1.graph, prob, cache_dir=tmp_path, device="cpu", **EVOLVE_KW)
    r2 = s2.solve()
    assert (s2.stats["stripe_builds"], s2.stats["stripe_loads"]) == (0, P)
    jg2, _ = jg.apply_updates(j_evolve.EdgeBatch.from_ops(**ops))
    j_prob = j_solve.sssp_problem(source=int(np.argmax(jg.out_degree)))
    cold_ref = j_solve.Solver(jg2, j_prob, backend="jit", **EVOLVE_KW).solve()
    _assert_same(r2, cold_ref)
    np.testing.assert_array_equal(r1.x, np.asarray(cold_ref.x))  # min-plus: exact
    # per-regime models: refit from the tagged rows, saved side by side
    s2.delta_model = t_delta_model.fit_delta_model(s2.graph, P=P, r_sync=8, r_async=12)
    s2._auto_delta = s2.delta_model.best_delta()
    old, new = s2.reprobe_delta()
    assert s2.delta_model_incremental is not None
    cold_model, best = s2.persist.load_delta_model()
    inc_model, inc_best = s2.persist.load_delta_model(regime="incremental")
    assert best == new and cold_model == s2.delta_model
    assert inc_model == s2.delta_model_incremental and inc_best == s2._auto_delta_incremental
    # a restart loads both, and a resolve prefers the incremental δ*
    s3 = t_solve.Solver(s1.graph, prob, cache_dir=tmp_path, device="cpu", **dict(EVOLVE_KW, delta="auto"))
    assert s3._auto_delta_incremental == inc_best and s3.resolve_delta("auto") == new


@pytest.mark.parametrize("entry, k", [("plan", 8), ("schedule", 64)])
def test_restart_at_other_bounds_loads_no_pinned_entry(tmp_path, entry, k):
    """A solver keeps its pre-mutation balanced bounds across apply_updates.
    A whole entry it saves on the mutated graph (k = 8 inserts into row 0:
    the schedule is patched and a halo resolve saves its plan; k = 64: the
    cell outgrows M and the schedule is rebuilt from stripes and saved) is
    keyed by those bounds: a fresh solver on the mutated graph, whose
    balanced bounds differ, answers as a cold one and patches its own
    bounds' stripes on the next update."""
    tg, _ = _graphs(PR_GRAPH)
    kw = dict(delta=64, frontier="halo", n_shards=2) if entry == "plan" else dict(delta=64)
    s1 = _port(tg, t_solve.pagerank_problem(), tmp_path, **kw)
    s1.solve()
    existing = set(tg.indices[tg.indptr[0] : tg.indptr[1]].tolist())
    srcs = [v for v in range(1, tg.n) if v not in existing]
    builds = s1.stats["schedule_builds"]
    s1.resolve(updates=t_evolve.EdgeBatch.from_ops(inserts=[(v, 0, 1.0) for v in srcs[:k]]))
    assert (s1.stats["schedule_builds"] > builds) == (entry == "schedule")  # dropped, or patched
    fresh = _port(s1.graph, t_solve.pagerank_problem(), tmp_path, **kw)
    assert not np.array_equal(fresh.bounds, s1.bounds)
    r = fresh.solve()
    assert fresh.stats["cache_loads"] == 0, fresh.stats
    _assert_same(r, _port(s1.graph, t_solve.pagerank_problem(), None, **kw).solve())
    fresh.apply_updates(t_evolve.EdgeBatch.from_ops(inserts=[(v, 0, 1.0) for v in srcs[k : k + 2]]))
    want = t_engine.make_schedule(fresh._sched_graph, P, 64, t_solve.pagerank_problem().semiring,
                                  min_chunk=MIN_CHUNK, bounds=fresh.bounds, device="cpu")
    got = fresh.schedule()
    for f in SCHED_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_regime_models_round_trip_the_store(tmp_path):
    tg, _ = _graphs(("kron", dict(scale=7, efactor=8, kind="sssp", seed=6)))
    sv = t_solve.Solver(tg, t_solve.sssp_problem(source=0), cache_dir=tmp_path, device="cpu", **EVOLVE_KW)
    model = t_delta_model.fit_delta_model(tg, P=P, r_sync=8, r_async=12)
    inc = t_delta_model.DeltaModel.from_dict(dict(model.to_dict(), r_sync=2.0, r_async=3.0))
    sv.persist.save_delta_model(model, 64)
    sv.persist.save_delta_model(inc, 16, regime="incremental")
    assert sv.persist.load_delta_model() == (model, 64)
    assert sv.persist.load_delta_model(regime="incremental") == (inc, 16)
    sv.persist.save_delta_model(inc, 32, regime="incremental")  # never clobbers cold
    assert sv.persist.load_delta_model()[1] == 64


# --------------------------------------------------------------------------- #
# partitioners
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("method", sorted(t_partition.PARTITION_METHODS))
@pytest.mark.parametrize("spec", [PR_GRAPH, SSSP_GRAPH], ids=["twitter", "kron"])
def test_partitioners_equal_reference(method, spec):
    tg, jg = _graphs(spec)
    for parts in (1, 4, 7):
        np.testing.assert_array_equal(
            t_partition.PARTITION_METHODS[method](tg, parts), j_partition.PARTITION_METHODS[method](jg, parts))
    tp, jp = t_partition.make_partition(tg, 4, method), j_partition.make_partition(jg, 4, method)
    assert tp.stats() == jp.stats()


def test_solver_partition_method(tmp_path):
    tg, jg = _graphs(PR_GRAPH)
    with pytest.raises(ValueError, match="partition_method"):
        t_solve.Solver(tg, t_solve.pagerank_problem(), partition_method="metis", device="cpu")
    a = _port(tg, t_solve.pagerank_problem(), tmp_path, delta=64, partition_method="refine")
    b = _port(tg, t_solve.pagerank_problem(), tmp_path, delta=64)
    assert a.persist.namespace != b.persist.namespace
    r = _ref(jg, j_solve.pagerank_problem(), delta=64, partition_method="refine").solve()
    _assert_same(a.solve(), r)
    # stripes of the same blocks are shared across namespaces; others are not
    assert a.stats["stripe_builds"] == P
