"""Parity of the port's engine (``repro_torch``) with the JAX reference.

The same numpy inputs go through both packages: generators, partitions and
stripe schedules must give equal arrays, and the plain PyTorch round must
equal ``repro.core.engine.round_fn`` bit for bit, round after round, for both
semirings, all three epilogues and the sync/async/delayed disciplines.  Only
``x[:-1]`` is compared: the dump slot's value is unspecified.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import access_matrix as j_access  # noqa: E402
from repro.core import delta_model as j_delta  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core.semiring import MIN_PLUS as J_MIN_PLUS  # noqa: E402
from repro.core.semiring import PLUS_TIMES as J_PLUS_TIMES  # noqa: E402
from repro.graphs import formats as j_formats  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
from repro.graphs import partition as j_part  # noqa: E402
from repro_torch.core import access_matrix as t_access  # noqa: E402
from repro_torch.core import delta_model as t_delta  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.semiring import INT32_MAX, MIN_PLUS, PLUS_TIMES  # noqa: E402
from repro_torch.graphs import formats as t_formats  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.graphs import partition as t_part  # noqa: E402
from repro_torch.kernels.round_block import (  # noqa: E402
    ADD_CONST,
    ADD_TABLE,
    MIN_OLD,
    Epilogue,
)

REPO = Path(__file__).resolve().parents[1]
P = 4
MIN_CHUNK = 16  # so that async (δ = 16) differs from sync at these sizes


def _graphs(name, scale, kind):
    return (
        j_gen.make_graph(name, scale=scale, efactor=8, kind=kind),
        t_gen.make_graph(name, scale=scale, efactor=8, kind=kind),
    )


def _assert_graph_equal(jg, tg):
    assert jg.n == tg.n and jg.name == tg.name
    np.testing.assert_array_equal(jg.indptr, tg.indptr)
    np.testing.assert_array_equal(jg.indices, tg.indices)
    np.testing.assert_array_equal(jg.values, tg.values)
    assert jg.values.dtype == tg.values.dtype


def _schedules(jg, tg, jsr, tsr, delta, mode="delayed"):
    js = j_engine.make_schedule(jg, P, delta, jsr, mode=mode, min_chunk=MIN_CHUNK)
    ts = t_engine.make_schedule(tg, P, delta, tsr, mode=mode, min_chunk=MIN_CHUNK)
    return js, ts


# The three epilogues, each beside the reference row update it stands for.
def _epilogue_pair(tag, n, rng):
    if tag == ADD_CONST:
        tele = np.float32(0.15 / n)
        return (lambda o, r, w: tele + r), Epilogue(ADD_CONST, const=float(tele))
    if tag == ADD_TABLE:
        q = rng.random(n).astype(np.float32)
        jq = jnp.asarray(q)  # jax clamps q[rows] at the dump row
        table = torch.as_tensor(np.append(q, np.float32(0)))
        return (lambda o, r, w: jq[w] + r), Epilogue(ADD_TABLE, table=table)
    return (lambda o, r, w: jnp.minimum(o, r)), Epilogue(MIN_OLD)


def _case(tag, rng):
    if tag == MIN_OLD:
        jg, tg = _graphs("kron", 8, "sssp")
        x0 = rng.integers(0, 1000, jg.n).astype(np.int32)
        x0[rng.random(jg.n) < 0.3] = 2**30 - 1
        return jg, tg, J_MIN_PLUS, MIN_PLUS, x0
    jg, tg = _graphs("twitter", 9, "pagerank")
    return jg, tg, J_PLUS_TIMES, PLUS_TIMES, rng.random(jg.n).astype(np.float32)


def _x_pair(x0, jsr, tsr):
    return (
        j_engine.extend_frontier(jnp.asarray(x0), jsr),
        t_engine.extend_frontier(x0, tsr, "cpu"),
    )


# --------------------------------------------------------------------------- #
# numpy copies: generators, partitions, schedules, δ-model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["kron", "urand", "road", "twitter", "web"])
@pytest.mark.parametrize("kind", ["pagerank", "sssp"])
def test_generators_give_the_reference_graph(name, kind):
    _assert_graph_equal(*_graphs(name, 8, kind))


def test_generators_honour_the_seed():
    jg = j_gen.make_graph("urand", scale=8, efactor=4, seed=5)
    tg = t_gen.make_graph("urand", scale=8, efactor=4, seed=5)
    _assert_graph_equal(jg, tg)
    other = t_gen.make_graph("urand", scale=8, efactor=4, seed=6)
    assert not np.array_equal(tg.indices, other.indices)


def test_partitions_match_reference():
    jg, tg = _graphs("web", 9, "pagerank")
    jp = j_part.make_partition(jg, P, "balanced")
    tp = t_part.make_partition(tg, P)
    np.testing.assert_array_equal(jp.bounds, tp.bounds)
    np.testing.assert_array_equal(jp.owner, tp.owner)
    assert jp.edge_cut == tp.edge_cut
    for a, b in zip(jp.halo_in + jp.halo_out, tp.halo_in + tp.halo_out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("delta", [1, 7, 32, 10_000])
def test_stripe_schedule_matches_reference(delta):
    jg, tg = _graphs("kron", 8, "sssp")
    bounds = j_part.balanced_blocks(jg, P)
    js = j_formats.build_stripe_schedule(jg, bounds, delta, J_MIN_PLUS.pad_edge_val)
    ts = t_formats.build_stripe_schedule(tg, bounds, delta, MIN_PLUS.pad_edge_val)
    assert (js.S, js.P, js.M, js.delta) == (ts.S, ts.P, ts.M, ts.delta)
    for name in ("src", "val", "dst_local", "rows", "block_bounds"):
        np.testing.assert_array_equal(getattr(js, name), getattr(ts, name))
    assert js.padding_overhead == ts.padding_overhead


@pytest.mark.parametrize("mode,delta", [("sync", None), ("async", None), ("delayed", 24)])
def test_device_schedule_matches_reference(mode, delta):
    jg, tg = _graphs("twitter", 9, "pagerank")
    js, ts = _schedules(jg, tg, J_PLUS_TIMES, PLUS_TIMES, delta, mode)
    via_host = t_engine.DeviceSchedule.from_host_arrays(js.to_host_arrays(), "cpu")
    for sched in (ts, via_host):
        assert (sched.n, sched.P, sched.delta, sched.S, sched.M) == (
            js.n, js.P, js.delta, js.S, js.M
        )
        for name in ("src", "val", "dst_local", "rows"):
            np.testing.assert_array_equal(
                np.asarray(getattr(js, name)), getattr(sched, name).numpy()
            )
        assert sched.edges == js.edges
        assert sched.padding_overhead == js.padding_overhead
        np.testing.assert_array_equal(sched.block_bounds, js.block_bounds)
    # row_ptr[s, w, r] : row_ptr[s, w, r+1] is exactly row r's run of edges
    dst = np.asarray(js.dst_local)
    ptr = ts.row_ptr.numpy()
    assert ptr.shape == (ts.S, ts.P, ts.delta + 1)
    for r in range(ts.delta + 1):
        np.testing.assert_array_equal(ptr[..., r], (dst < r).sum(-1))


def test_from_host_arrays_rejects_inconsistent_shapes():
    jg, tg = _graphs("kron", 8, "pagerank")
    arrays = j_engine.make_schedule(jg, P, 16, J_PLUS_TIMES).to_host_arrays()
    arrays["rows"] = arrays["rows"][:, :, :-1]
    with pytest.raises(ValueError, match="inconsistent"):
        t_engine.DeviceSchedule.from_host_arrays(arrays, "cpu")


def test_delta_model_picks_reference_delta_star():
    jg, tg = _graphs("web", 9, "pagerank")
    bounds = j_part.balanced_blocks(jg, P)
    np.testing.assert_array_equal(
        j_access.access_matrix(jg, bounds), t_access.access_matrix(tg, bounds)
    )
    jm = j_delta.fit_delta_model(jg, P, 30, 12, delta_min=16)
    tm = t_delta.fit_delta_model(tg, P, 30, 12, delta_min=16)
    assert jm.to_dict() == tm.to_dict()
    assert jm.best_delta() == tm.best_delta()


# --------------------------------------------------------------------------- #
# semiring and the plain round
# --------------------------------------------------------------------------- #
def test_empty_segments_read_like_jax():
    seg = np.array([0, 0, 3], np.int32)
    vals_i = np.array([5, 3, 9], np.int32)
    vals_f = np.array([0.5, 0.25, 2.0], np.float32)
    j_min = np.asarray(jax.ops.segment_min(jnp.asarray(vals_i), jnp.asarray(seg), 5))
    t_min = MIN_PLUS.segment_reduce(torch.as_tensor(vals_i), torch.as_tensor(seg), 5)
    np.testing.assert_array_equal(j_min, t_min.numpy())
    assert t_min[1].item() == INT32_MAX  # not INT_INF
    j_sum = np.asarray(jax.ops.segment_sum(jnp.asarray(vals_f), jnp.asarray(seg), 5))
    t_sum = PLUS_TIMES.segment_reduce(torch.as_tensor(vals_f), torch.as_tensor(seg), 5)
    np.testing.assert_array_equal(j_sum, t_sum.numpy())
    # min-plus ⊗ saturates at INT_INF
    x = torch.tensor([2**30 - 1, 5], dtype=torch.int32)
    a = torch.tensor([2**30 - 1, 7], dtype=torch.int32)
    assert MIN_PLUS.mul(x, a).tolist() == [2**30 - 1, 12]


@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("async", None), ("delayed", 40)])
def test_plain_round_bit_identical_to_reference(tag, mode, delta):
    rng = np.random.default_rng(1)
    jg, tg, jsr, tsr, x0 = _case(tag, rng)
    js, ts = _schedules(jg, tg, jsr, tsr, delta, mode)
    j_update, t_update = _epilogue_pair(tag, jg.n, rng)
    j_round = jax.jit(j_engine.round_fn(js, jsr, j_update))
    t_round = t_engine.round_fn(ts, tsr, t_update)
    jx, tx = _x_pair(x0, jsr, tsr)
    for _ in range(3):
        jx, tx = j_round(jx), t_round(tx)
        np.testing.assert_array_equal(np.asarray(jx)[:-1], tx.numpy()[:-1])


def test_plain_round_is_gauss_seidel_not_jacobi():
    """With S > 1, later commit steps read earlier steps' commits."""
    rng = np.random.default_rng(2)
    jg, tg, jsr, tsr, x0 = _case(ADD_CONST, rng)
    _, ts = _schedules(jg, tg, jsr, tsr, 32)
    assert ts.S > 1
    _, update = _epilogue_pair(ADD_CONST, tg.n, rng)
    x = t_engine.extend_frontier(x0, tsr, "cpu")
    gs = t_engine.round_fn(ts, tsr, update)(x)
    jacobi = x.clone()
    for s in range(ts.S):  # every step reads the frozen round-start frontier
        y = x.clone()
        t_engine._commit_step(s, y, ts, tsr, update)
        rows = ts.rows[s].reshape(-1)
        jacobi[rows] = y[rows]
    assert (gs[:-1] - jacobi[:-1]).abs().max().item() > 1e-6


# --------------------------------------------------------------------------- #
# ROADMAP queue C traps: dump-row gathers, empty segments, dump-slot writes
# --------------------------------------------------------------------------- #
def test_table_epilogue_reads_the_dump_row_in_bounds():
    """Padded rows (== n) gather the table at n: the port pads q to n+1 rows
    where the reference relies on jax clamping the gather."""
    rng = np.random.default_rng(3)
    jg, tg, jsr, tsr, x0 = _case(ADD_TABLE, rng)
    js, ts = _schedules(jg, tg, jsr, tsr, 48)  # 48 ∤ block: padded rows exist
    assert (ts.rows == tg.n).any()
    j_update, t_update = _epilogue_pair(ADD_TABLE, jg.n, rng)
    assert t_update.table.shape == (tg.n + 1,)
    jx, tx = _x_pair(x0, jsr, tsr)
    out_j = np.asarray(j_engine.round_fn(js, jsr, j_update)(jx))
    out_t = t_engine.round_fn(ts, tsr, t_update)(tx)
    np.testing.assert_array_equal(out_j[:-1], out_t.numpy()[:-1])


@pytest.mark.parametrize("tag", [ADD_CONST, MIN_OLD])
def test_rows_without_in_edges_match_reference(tag):
    """Empty segments: most rows have no in-edges, so their reduced value is
    the segment fill (0, or int32 max), which the row update must see."""
    rng = np.random.default_rng(4)
    n = 64
    src, dst = rng.integers(0, n, 12), rng.integers(0, n // 2, 12)
    if tag == MIN_OLD:
        vals = rng.integers(1, 50, 12).astype(np.int32)
        jsr, tsr = J_MIN_PLUS, MIN_PLUS
        x0 = rng.integers(0, 100, n).astype(np.int32)
    else:
        vals = rng.random(12).astype(np.float32)
        jsr, tsr = J_PLUS_TIMES, PLUS_TIMES
        x0 = rng.random(n).astype(np.float32)
    jg = j_formats.CSRGraph.from_edges(n, src, dst, vals)
    tg = t_formats.CSRGraph.from_edges(n, src, dst, vals)
    assert (np.diff(tg.indptr) == 0).sum() > n // 2
    js, ts = _schedules(jg, tg, jsr, tsr, 8)
    j_update, t_update = _epilogue_pair(tag, n, rng)
    jx, tx = _x_pair(x0, jsr, tsr)
    out_j = np.asarray(j_engine.round_fn(js, jsr, j_update)(jx))
    out_t = t_engine.round_fn(ts, tsr, t_update)(tx).numpy()
    np.testing.assert_array_equal(out_j[:-1], out_t[:-1])
    if tag == MIN_OLD:  # min(old, int32 max) keeps old on edgeless rows
        edgeless = np.diff(tg.indptr) == 0
        np.testing.assert_array_equal(out_t[:-1][edgeless], x0[edgeless])


def test_dump_slot_takes_duplicate_writes():
    """Every padded row publishes into the dump slot n; the rows before it
    must be unaffected, whatever value the slot ends with."""
    rng = np.random.default_rng(5)
    jg, tg, jsr, tsr, x0 = _case(MIN_OLD, rng)
    js, ts = _schedules(jg, tg, jsr, tsr, 60)
    assert ((ts.rows == tg.n).sum(dim=(1, 2)) > 1).any()
    j_update, t_update = _epilogue_pair(MIN_OLD, jg.n, rng)
    jx, tx = _x_pair(x0, jsr, tsr)
    out_j = np.asarray(j_engine.round_fn(js, jsr, j_update)(jx))
    out_t = t_engine.round_fn(ts, tsr, t_update)(tx)
    np.testing.assert_array_equal(out_j[:-1], out_t.numpy()[:-1])


# --------------------------------------------------------------------------- #
# random graphs × P × δ
# --------------------------------------------------------------------------- #
@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(
    n=st.integers(2, 40),
    m=st.integers(0, 120),
    p=st.integers(1, 5),
    delta=st.integers(1, 12),
    plus_times=st.booleans(),
    seed=st.integers(0, 2**16),
)
def test_plain_round_property(n, m, p, delta, plus_times, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    if plus_times:
        vals, jsr, tsr = rng.random(m).astype(np.float32), J_PLUS_TIMES, PLUS_TIMES
        x0 = rng.random(n).astype(np.float32)
        tag = ADD_CONST
    else:
        vals, jsr, tsr = rng.integers(1, 9, m).astype(np.int32), J_MIN_PLUS, MIN_PLUS
        x0 = rng.integers(0, 50, n).astype(np.int32)
        tag = MIN_OLD
    jg = j_formats.CSRGraph.from_edges(n, src, dst, vals)
    tg = t_formats.CSRGraph.from_edges(n, src, dst, vals)
    js = j_engine.make_schedule(jg, p, delta, jsr)
    ts = t_engine.make_schedule(tg, p, delta, tsr)
    j_update, t_update = _epilogue_pair(tag, n, rng)
    jx, tx = _x_pair(x0, jsr, tsr)
    out_j = np.asarray(jax.jit(j_engine.round_fn(js, jsr, j_update))(jx))
    out_t = t_engine.round_fn(ts, tsr, t_update)(tx)
    np.testing.assert_array_equal(out_j[:-1], out_t.numpy()[:-1])


# --------------------------------------------------------------------------- #
# counters and isolation
# --------------------------------------------------------------------------- #
def test_engine_result_counters_match_reference():
    rng = np.random.default_rng(6)
    jg, tg, jsr, tsr, x0 = _case(ADD_CONST, rng)
    js, ts = _schedules(jg, tg, jsr, tsr, 24)
    j_update, t_update = _epilogue_pair(ADD_CONST, jg.n, rng)
    jr = j_engine.run_host(js, jsr, x0, j_update, lambda a, b: jnp.sum(jnp.abs(b - a)), 1e-5, 50)
    tr = t_engine.host_loop(
        t_engine.round_fn(ts, tsr, t_update),
        ts,
        tsr,
        t_engine.extend_frontier(x0, tsr, "cpu"),
        lambda a, b: torch.sum(torch.abs(b - a)),
        1e-5,
        50,
    )
    assert (tr.rounds, tr.flushes, tr.flush_bytes, tr.delta, tr.P) == (
        jr.rounds, jr.flushes, jr.flush_bytes, jr.delta, jr.P
    )
    assert tr.converged == jr.converged
    np.testing.assert_array_equal(np.asarray(jr.x), tr.x)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.kernels.ops, repro_torch.kernels.build, "
        "repro_torch.core.delta_model, repro_torch.dist.engine_sharded, "
        "repro_torch.kernels.spmv_ell, repro_torch.persist, repro_torch.persist.store, "
        "repro_torch.ft, repro_torch.ft.inject, repro_torch.ckpt, repro_torch.ckpt.checkpoint, "
        "repro_torch.ft.elastic, repro_torch.ft.degrade\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
