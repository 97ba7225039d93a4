"""Checkpointed solves and checkpoints in the port against the reference.

The same graphs and fault plans go through ``repro.ft.elastic``'s
``checkpointed_solve`` (``backend="jit"``, the reference's host round) and
``repro_torch.ft.elastic``'s (``device="cpu"``, ``backend="torch"`` and
``"kernel"``: on the CPU both run the plain round) on the reference's test
graphs (kron s8 SSSP, twitter s8 PageRank; P = 4, δ = 32, ``min_chunk=8``):

* with no fault, with a ``solver.round`` fault (the chaos trace's
  ``checkpoint_faults`` plan, round 6), with a fault before the first
  snapshot, after a simulated kill and a fresh solver's resume, and with
  the restore budget exhausted: x and rounds bit for bit, ``restores``,
  ``rounds_executed`` and ``resumed_at`` exactly, and the residuals bit for
  bit for SSSP (a count) and within ``2·n·2⁻²⁴`` for PageRank (the port sums
  its l1 residual with ``torch.sum``, the reference with XLA's reduce:
  ROADMAP queue C item 2); within the port, a faulted or resumed solve gives
  the fault-free residuals bit for bit;
* a snapshot that ``repro`` writes, the port resumes, and the reverse, both
  equal to the uninterrupted answer;
* the checkpoint layer: leaf names as ``jax.tree_util.keystr`` gives them,
  trees saved by either package restored by the other, a torn commit
  invisible, an EIO write raising, the GC keeping the last k;
* the halo frontier: a snapshot at D = 4 resumed at D = 2 gives the D = 4
  answer bit for bit on the f32 wire; on the int8 wire at D = 4 resumed at
  D = 4 bit for bit (the error feedback restored), at D = 2 (reset to zeros)
  the same fixed point within tol.
"""

import importlib
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.ft import elastic as j_elastic  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
import repro.solve as j_solve  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.ft import elastic as t_elastic  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
import repro_torch.solve as t_solve  # noqa: E402

# the modules themselves: each package's ``ft`` exports a function named inject
j_inject = importlib.import_module("repro.ft.inject")
t_inject = importlib.import_module("repro_torch.ft.inject")
KW = dict(n_workers=4, delta=32, min_chunk=8)
GRAPHS = {"sssp": ("kron", "sssp"), "pagerank": ("twitter", "pagerank")}
BACKENDS = ("torch", "kernel")
# benchmarks/traces/chaos_smoke.json's checkpoint_faults plan
CHECKPOINT_FAULTS = {"seed": 0, "specs": [{"site": "solver.round", "match": {"round": 6}, "times": 1}]}


@pytest.fixture(scope="module")
def graphs():
    return {
        name: (j_gen.make_graph(g, scale=8, efactor=8, kind=k), t_gen.make_graph(g, scale=8, efactor=8, kind=k))
        for name, (g, k) in GRAPHS.items()
    }


def _problem(pkg, name):
    return getattr(pkg, f"{name}_problem")()


def j_solver(graphs, name, **kw):
    return j_solve.Solver(graphs[name][0], _problem(j_solve, name), **KW, **kw)


def t_solver(graphs, name, **kw):
    return t_solve.Solver(graphs[name][1], _problem(t_solve, name), device="cpu", **KW, **kw)


def j_run(graphs, name, ckpt_dir, plan=None, **kw):
    with j_inject.inject(j_inject.FaultPlan.from_json(plan or {})):
        return j_elastic.checkpointed_solve(j_solver(graphs, name), backend="jit", ckpt_dir=ckpt_dir, **kw)


def t_run(graphs, name, backend, ckpt_dir, plan=None, solver=None, **kw):
    solver = solver or t_solver(graphs, name)
    with t_inject.inject(t_inject.FaultPlan.from_json(plan or {})):
        return t_elastic.checkpointed_solve(solver, backend=backend, ckpt_dir=ckpt_dir, **kw)


def assert_same_residuals(want, got, name, n):
    if name == "sssp":
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=2 * n * 2.0**-24)


def assert_same_result(want, got, name, n):
    """``want`` the reference's (or the port's) ``EngineResult``: x and the
    counters bit for bit, the residuals as ``assert_same_residuals``."""
    assert (got.rounds, got.converged, got.flushes, got.flush_bytes, got.delta, got.P) == (
        want.rounds, want.converged, want.flushes, want.flush_bytes, want.delta, want.P
    )
    np.testing.assert_array_equal(np.asarray(want.x).view(np.int32), got.x.view(np.int32))
    assert len(got.round_times_s) > 0 or got.rounds == 0
    assert_same_residuals(list(want.residuals), list(got.residuals), name, n)


def settle(d):
    """Wait for the reference's background writer of a killed solve: its
    checkpointed_solve does not join it when a fault ends the call."""
    deadline = time.monotonic() + 60
    while j_ckpt.latest_step(d) is None or any(p.name.startswith(".tmp_") for p in d.iterdir()):
        assert time.monotonic() < deadline, sorted(p.name for p in d.iterdir())
        time.sleep(0.01)


def accounting(out):
    return out.restores, out.rounds_executed, out.resumed_at


# --------------------------------------------------------------------------- #
# TestCheckpointedSolve's cases, against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_no_fault_matches_reference(graphs, tmp_path, name, backend):
    want = j_run(graphs, name, tmp_path / "j", every=4)
    host = j_solver(graphs, name).solve(backend="host")
    got = t_run(graphs, name, backend, tmp_path / "t", every=4)
    n = graphs[name][1].n
    assert accounting(got) == accounting(want) == (0, want.result.rounds, None)
    assert_same_result(want.result, got.result, name, n)
    assert_same_result(host, got.result, name, n)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_fault_restores_and_stays_bit_identical(graphs, tmp_path, name, backend):
    clean = t_run(graphs, name, backend, tmp_path / "clean", every=4)
    want = j_run(graphs, name, tmp_path / "j", CHECKPOINT_FAULTS, every=4)
    got = t_run(graphs, name, backend, tmp_path / "t", CHECKPOINT_FAULTS, every=4)
    # killed at round 6, restored to the round-4 snapshot: 2 replayed
    assert accounting(got) == accounting(want) == (1, clean.result.rounds + 2, None)
    assert_same_result(want.result, got.result, name, graphs[name][1].n)
    np.testing.assert_array_equal(clean.result.x, got.result.x)
    assert got.result.residuals == clean.result.residuals


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_cold_restart_before_first_snapshot(graphs, tmp_path, name, backend):
    plan = {"specs": [{"site": "solver.round", "match": {"round": 2}}]}
    clean = t_run(graphs, name, backend, tmp_path / "clean", every=64)
    want = j_run(graphs, name, tmp_path / "j", plan, every=64)
    got = t_run(graphs, name, backend, tmp_path / "t", plan, every=64)
    assert accounting(got) == accounting(want) == (1, clean.result.rounds + 2, None)  # full replay from 0
    assert_same_result(want.result, got.result, name, graphs[name][1].n)
    assert got.result.residuals == clean.result.residuals


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_kill_and_resume_fresh_process(graphs, tmp_path, name, backend):
    """Simulated kill -9 mid-solve; a fresh solver resumes from disk."""
    clean = t_run(graphs, name, backend, tmp_path / "clean", every=4)
    results = {}
    for side, run in (("j", lambda d, **kw: j_run(graphs, name, d, **kw)),
                      ("t", lambda d, **kw: t_run(graphs, name, backend, d, **kw))):
        err = j_inject.InjectedFault if side == "j" else t_inject.InjectedFault
        with pytest.raises(err):
            run(tmp_path / side, plan=CHECKPOINT_FAULTS, every=4, max_restores=0)  # dies on the first fault
        settle(tmp_path / side)
        results[side] = run(tmp_path / side, every=4)
    want, got = results["j"], results["t"]
    R = clean.result.rounds
    assert accounting(got) == accounting(want) == (0, R - 4, 4)
    assert_same_result(want.result, got.result, name, graphs[name][1].n)
    np.testing.assert_array_equal(clean.result.x, got.result.x)
    assert got.result.residuals == clean.result.residuals
    assert len(got.result.round_times_s) == R - 4


@pytest.mark.parametrize("backend", BACKENDS)
def test_max_restores_exhausted_raises(graphs, tmp_path, backend):
    plan = {"specs": [{"site": "solver.round", "at": 0, "times": -1}]}
    fired = {}
    for side in ("j", "t"):
        pkg = j_inject if side == "j" else t_inject
        p = pkg.FaultPlan.from_json(plan)
        with pkg.inject(p):
            with pytest.raises(pkg.InjectedFault):
                if side == "j":
                    j_elastic.checkpointed_solve(j_solver(graphs, "sssp"), backend="jit", ckpt_dir=tmp_path / side,
                                                 every=4, max_restores=2)
                else:
                    t_elastic.checkpointed_solve(t_solver(graphs, "sssp"), backend=backend,
                                                 ckpt_dir=tmp_path / side, every=4, max_restores=2)
        fired[side] = p.fired
    assert fired["t"] == fired["j"] == 3  # initial fault + max_restores failed retries


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_snapshot_crosses_packages(graphs, tmp_path, name, writer):
    """A solve killed in one package resumes in the other from its snapshot,
    and gives the uninterrupted answer."""
    clean = t_run(graphs, name, "kernel", tmp_path / "clean", every=4)
    d = tmp_path / "shared"
    if writer == "repro":
        with pytest.raises(j_inject.InjectedFault):
            j_run(graphs, name, d, CHECKPOINT_FAULTS, every=4, max_restores=0)
        settle(d)
        got = t_run(graphs, name, "kernel", d, every=4)
    else:
        with pytest.raises(t_inject.InjectedFault):
            t_run(graphs, name, "kernel", d, CHECKPOINT_FAULTS, every=4, max_restores=0)
        got = j_run(graphs, name, d, every=4)
    assert accounting(got) == (0, clean.result.rounds - 4, 4)
    assert got.result.rounds == clean.result.rounds
    np.testing.assert_array_equal(clean.result.x, np.asarray(got.result.x))
    assert_same_residuals(clean.result.residuals, list(got.result.residuals), name, graphs[name][1].n)


def test_torn_snapshot_is_skipped_on_resume(graphs, tmp_path):
    """The first snapshot torn (``ckpt.write``), a fault at round 6 restores
    from nothing committed: a cold replay, the same answer."""
    plan = {"specs": [{"site": "ckpt.write", "kind": "torn"}, {"site": "solver.round", "match": {"round": 6}}]}
    clean = t_run(graphs, "pagerank", "kernel", tmp_path / "clean", every=4)
    got = t_run(graphs, "pagerank", "kernel", tmp_path / "t", plan, every=4)
    want = j_run(graphs, "pagerank", tmp_path / "j", plan, every=4)
    assert accounting(got) == accounting(want) == (1, clean.result.rounds + 6, None)
    np.testing.assert_array_equal(clean.result.x, got.result.x)
    assert got.result.residuals == clean.result.residuals


def test_grouped_solver_refused(graphs, tmp_path):
    solver = t_solver(graphs, "sssp")
    solver.group = object()  # stands for a process group: refused before it is used
    with pytest.raises(NotImplementedError, match="A9, third part"):
        t_elastic.checkpointed_solve(solver, ckpt_dir=tmp_path)


# --------------------------------------------------------------------------- #
# the halo frontier: resume at another shard count
# --------------------------------------------------------------------------- #
def _halo(graphs, D, hd="f32", **kw):
    return t_solver(graphs, "pagerank", frontier="halo", n_shards=D, halo_dtype=hd, **kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_halo_resume_at_other_shard_count_f32(graphs, tmp_path, backend):
    clean = t_run(graphs, "pagerank", backend, tmp_path / "clean", solver=_halo(graphs, 4), every=4)
    rep = t_run(graphs, "pagerank", backend, tmp_path / "rep", every=4)
    d = tmp_path / "d"
    with pytest.raises(t_inject.InjectedFault):
        t_run(graphs, "pagerank", backend, d, CHECKPOINT_FAULTS, solver=_halo(graphs, 4), every=4, max_restores=0)
    got = t_run(graphs, "pagerank", backend, d, solver=_halo(graphs, 2), every=4)
    assert accounting(got) == (0, clean.result.rounds - 4, 4)
    assert got.result.rounds == clean.result.rounds == rep.result.rounds
    np.testing.assert_array_equal(clean.result.x, got.result.x)
    np.testing.assert_array_equal(rep.result.x, got.result.x)  # the f32 halo round is the replicated one
    assert got.result.residuals == clean.result.residuals


def test_halo_int8_resume(graphs, tmp_path):
    """int8 wire: the same D resumes bit for bit (the error feedback is in
    the snapshot); another D resets it to zeros and reaches the fixed point
    within tol (one that the int8 wire's noise lets converge)."""
    tol = 3e-3
    clean = t_run(graphs, "pagerank", "kernel", tmp_path / "clean", solver=_halo(graphs, 4, "int8", tol=tol), every=4)
    exact = t_run(graphs, "pagerank", "kernel", tmp_path / "exact", solver=t_solver(graphs, "pagerank", tol=tol),
                  every=4)
    assert clean.result.converged and clean.result.rounds > 6
    for D in (4, 2):
        d = tmp_path / f"d{D}"
        with pytest.raises(t_inject.InjectedFault):
            t_run(graphs, "pagerank", "kernel", d, CHECKPOINT_FAULTS, solver=_halo(graphs, 4, "int8", tol=tol),
                  every=4, max_restores=0)
        snap = t_elastic.load_latest_flat(d)[1]
        assert snap["['ef_0']"].shape[0] == 4 and np.abs(snap["['ef_0']"]).max() > 0
        got = t_run(graphs, "pagerank", "kernel", d, solver=_halo(graphs, D, "int8", tol=tol), every=4)
        assert got.resumed_at == 4 and got.result.converged
        if D == 4:
            np.testing.assert_array_equal(clean.result.x, got.result.x)
            assert got.result.residuals == clean.result.residuals
        else:
            err = np.abs(got.result.x.astype(np.float64) - exact.result.x).sum()
            ref_err = np.abs(clean.result.x.astype(np.float64) - exact.result.x).sum()
            assert err <= max(10 * tol, 2 * ref_err), (err, ref_err)


# --------------------------------------------------------------------------- #
# the checkpoint layer (TestCheckpointFaults) and its layout across packages
# --------------------------------------------------------------------------- #
def test_torn_commit_is_invisible(tmp_path):
    tree = {"x": torch.arange(4.0)}
    with t_inject.inject(t_inject.FaultPlan([t_inject.FaultSpec(site="ckpt.write", kind="torn")])):
        t_ckpt.save_checkpoint(tmp_path, 5, tree)
    # shards + manifest landed but _COMMITTED never did: restart skips it
    assert (tmp_path / "step_000000005" / "manifest.json").exists()
    assert t_ckpt.latest_step(tmp_path) is None
    t_ckpt.save_checkpoint(tmp_path, 7, tree)
    assert t_ckpt.latest_step(tmp_path) == 7
    assert j_ckpt.latest_step(tmp_path) == 7


def test_eio_write_raises(tmp_path):
    tree = {"x": torch.arange(4.0)}
    with t_inject.inject(t_inject.FaultPlan([t_inject.FaultSpec(site="ckpt.write", kind="eio")])):
        with pytest.raises(OSError):
            t_ckpt.save_checkpoint(tmp_path, 5, tree)
    assert t_ckpt.latest_step(tmp_path) is None


def test_manager_gc_keeps_last_k(tmp_path):
    mgr = t_ckpt.CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"x": torch.tensor(float(step))}, block=True)
    assert t_ckpt.latest_step(tmp_path) == 4
    committed = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert committed == ["step_000000003", "step_000000004"]


def test_background_save_copies_the_tensor(tmp_path):
    """``block=False``: the tensor is on the host before ``save`` returns,
    so changing it afterwards does not reach the snapshot."""
    mgr = t_ckpt.CheckpointManager(tmp_path)
    x = torch.arange(6.0)
    mgr.save(3, {"x": x}, block=False)
    x.fill_(-1.0)
    mgr.wait()
    step, back = mgr.restore_latest({"x": x})
    assert step == 3
    np.testing.assert_array_equal(back["x"], np.arange(6.0, dtype=np.float32))


def _tree(xp):
    return {
        "x_ext": xp.arange(12, dtype=xp.float32).reshape(6, 2),
        "residuals": xp.asarray([0.5, 0.25], dtype=xp.float32),
        "nested": {"b": xp.asarray(7, dtype=xp.int32), "a": [xp.ones(4, dtype=xp.int32), xp.zeros(3, dtype=xp.float32)]},
    }


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_layout_crosses_packages(tmp_path, n_hosts):
    """The leaf names are jax's ``keystr``; either package restores what the
    other saved, every host's shard included."""
    j_tree = jax.tree_util.tree_map(jnp.asarray, _tree(np))
    t_tree = {k: v for k, v in _tree(np).items()}
    t_tree["x_ext"] = torch.as_tensor(t_tree["x_ext"])
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(j_tree)[0]]
    assert t_ckpt._flatten_with_names(t_tree)[0] == names
    for h in range(n_hosts):
        t_ckpt.save_checkpoint(tmp_path / "t", 2, t_tree, host_index=h, n_hosts=n_hosts)
        j_ckpt.save_checkpoint(tmp_path / "j", 2, j_tree, host_index=h, n_hosts=n_hosts)
    mt = json.loads((tmp_path / "t" / "step_000000002" / "manifest.json").read_text())
    mj = json.loads((tmp_path / "j" / "step_000000002" / "manifest.json").read_text())
    assert {k: v for k, v in mt.items() if k != "time"} == {k: v for k, v in mj.items() if k != "time"}
    for src, restore in (("t", j_ckpt.restore_checkpoint), ("j", t_ckpt.restore_checkpoint)):
        back = restore(tmp_path / src, 2, j_tree if restore is j_ckpt.restore_checkpoint else t_tree)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(_tree(np))):
            np.testing.assert_array_equal(np.asarray(a), b)
            assert np.asarray(a).dtype == b.dtype
    assert t_elastic.load_latest_flat(tmp_path / "j")[1].keys() == j_elastic.load_latest_flat(tmp_path / "t")[1].keys()


def test_corrupt_snapshot_reads_as_absent(tmp_path):
    ck = t_elastic.SolveCheckpointer(tmp_path, every=2)
    ck.save(2, {"x_ext": torch.arange(3.0), "residuals": np.zeros(2, np.float32)}, block=True)
    assert ck.restore_latest()[0] == 2
    (tmp_path / "step_000000002" / "shard_00000.npz").write_bytes(b"not an npz")
    assert ck.restore_latest() is None
