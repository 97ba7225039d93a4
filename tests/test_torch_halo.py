"""The port's halo engine (``repro_torch.dist``) against the JAX reference.

The same numpy inputs go through both packages:

* the owner-computes plans equal ``repro.dist.engine_sharded``'s, array for
  array, over shard counts, disciplines and graph families;
* the plain halo step equals the reference's Pallas ``fused_halo_step_fn``
  in interpret mode, bit for bit, for every shard and step and all three
  epilogues;
* the halo rounds equal ``repro.core.engine.round_fn`` (D = 2, 4) and the
  reference's fused halo round (D = 1 here; D = 4 in a subprocess with four
  fake CPU devices), quantized rounds and their residuals included, and K2's
  plain version run over a split step range equals it run over the whole
  round;
* ``Solver(frontier="halo")`` equals ``repro.Solver(backend="jit")``.

Only ``x[:-1]`` and the local frontier's non-dump slots are compared: dump
values are unspecified.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.solve as j_solve  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core.semiring import MIN_PLUS as J_MIN_PLUS  # noqa: E402
from repro.core.semiring import PLUS_TIMES as J_PLUS_TIMES  # noqa: E402
from repro.dist import engine_sharded as j_sharded  # noqa: E402
from repro.dist.compat import make_mesh  # noqa: E402
from repro.graphs import formats as j_formats  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
from repro.kernels.round_block import fused_halo_step_fn  # noqa: E402
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
    MIN_OLD,
    Epilogue,
    fused_halo_round_cuda,
)

REPO = Path(__file__).resolve().parents[1]
P = 8
MIN_CHUNK = 16
DISCIPLINES = {"sync": ("sync", None), "async": ("async", None), "24": ("delayed", 24)}
PLAN_FIELDS = (
    "D", "P_loc", "L", "H", "S", "delta", "n", "vertex_bounds", "halo_sizes",
    "boundary_entries_per_round", "src_loc", "rows_loc", "send_idx", "recv_idx",
    "gather_index", "owned_flat",
)


@functools.cache
def _graphs(name, kind):
    scale = 9
    if name == "road":
        return j_gen.make_graph(name, scale=scale, kind=kind), t_gen.make_graph(
            name, scale=scale, kind=kind
        )
    return (
        j_gen.make_graph(name, scale=scale, efactor=8, kind=kind),
        t_gen.make_graph(name, scale=scale, efactor=8, kind=kind),
    )


@functools.cache
def _schedules(name, kind, disc, sr_name="plus_times"):
    jg, tg = _graphs(name, kind)
    jsr, tsr = (J_MIN_PLUS, MIN_PLUS) if sr_name == "min_plus" else (J_PLUS_TIMES, PLUS_TIMES)
    mode, delta = DISCIPLINES[disc]
    js = j_engine.make_schedule(jg, P, delta, jsr, mode=mode, min_chunk=MIN_CHUNK)
    ts = t_engine.make_schedule(tg, P, delta, tsr, mode=mode, min_chunk=MIN_CHUNK)
    return js, ts


def _plan_array(plan, field):
    v = getattr(plan, field)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# --------------------------------------------------------------------------- #
# (a) plans
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("name,kind", [("twitter", "pagerank"), ("kron", "sssp"), ("road", "unit")])
def test_frontier_plan_equals_reference(name, kind, D):
    for disc in DISCIPLINES:
        js, ts = _schedules(name, kind, disc, "min_plus" if kind == "sssp" else "plus_times")
        jp = j_sharded.make_frontier_plan(js, D)
        tp = t_sharded.make_frontier_plan(ts, D)
        for field in PLAN_FIELDS:
            want, got = _plan_array(jp, field), _plan_array(tp, field)
            assert want.dtype == got.dtype or want.ndim == 0, (disc, field)
            np.testing.assert_array_equal(got, want, err_msg=f"{disc} {field}")


def test_plan_byte_accounting_and_layout_maps():
    js, ts = _schedules("twitter", "pagerank", "24")
    jp, tp = j_sharded.make_frontier_plan(js, 4), t_sharded.make_frontier_plan(ts, 4)
    assert tp.halo_bytes_per_round(1) == jp.halo_bytes_per_round(1)
    assert tp.replicated_bytes_per_round() == jp.replicated_bytes_per_round()
    x = np.random.default_rng(0).random(ts.n_slots).astype(np.float32)
    x_loc = tp.scatter_x(torch.as_tensor(x))
    np.testing.assert_array_equal(x_loc.numpy(), np.asarray(jp.scatter_x(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tp.gather_x(x_loc).numpy(), np.asarray(jp.gather_x(jnp.asarray(x_loc.numpy())))
    )
    np.testing.assert_array_equal(tp.gather_x(x_loc, dump=torch.as_tensor(x[-1:])).numpy(), x)


# --------------------------------------------------------------------------- #
# (b) the plain K2 step against the Pallas kernel in interpret mode
# --------------------------------------------------------------------------- #
def _updates(tag, n, rng):
    """(reference 4-arg row update, port epilogue) for ``tag``."""
    if tag == MIN_OLD:
        return (lambda o, r, w, q: jnp.minimum(o, r)), Epilogue(MIN_OLD)
    if tag == ADD_CONST:
        c = np.float32(0.15 / n)
        return (lambda o, r, w, q: c + r), Epilogue(ADD_CONST, const=float(c))
    table = rng.random(n).astype(np.float32)
    jt = jnp.asarray(table)
    return (lambda o, r, w, q: jt[w] + r), Epilogue(
        ADD_TABLE, table=torch.as_tensor(np.append(table, np.float32(0)))
    )


def _case(tag):
    return ("kron", "sssp", "min_plus") if tag == MIN_OLD else ("twitter", "pagerank", "plus_times")


def _random_x(sr, shape, rng):
    if sr is MIN_PLUS:
        x = rng.integers(0, 5000, shape).astype(np.int32)
        x[rng.random(shape) < 0.3] = 2**30 - 1
        return x
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("disc", ["sync", "24"])
@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD])
def test_plain_halo_step_equals_pallas_step(tag, disc):
    name, kind, sr_name = _case(tag)
    js, ts = _schedules(name, kind, disc, sr_name)
    D = 4
    jp, tp = j_sharded.make_frontier_plan(js, D), t_sharded.make_frontier_plan(ts, D)
    tsr = MIN_PLUS if sr_name == "min_plus" else PLUS_TIMES
    jsr = J_MIN_PLUS if sr_name == "min_plus" else J_PLUS_TIMES
    rng = np.random.default_rng(1)
    j_update, t_update = _updates(tag, ts.n, rng)
    step = jax.jit(
        fused_halo_step_fn(
            jsr, j_update, P_loc=jp.P_loc, M=js.M, delta=js.delta, L=jp.L, H=jp.H, interpret=True
        )
    )
    q = jnp.zeros((), jnp.int32)
    P_loc = jp.P_loc
    for s in range(ts.S):
        for d in range(D):
            x = _random_x(tsr, (tp.L,), rng)
            tx = torch.tensor(x)  # copies: both steps write their frontier in place
            w = slice(d * P_loc, (d + 1) * P_loc)
            jx, jsend = step(
                jnp.array(x), jp.src_loc[d, s], js.val[s, w], js.dst_local[s, w],
                js.rows[s, w], jp.rows_loc[d, s], jp.send_idx[s, d], q,
            )
            st = ref.halo_step(ts, tp, s, d)
            tsend = ref.fused_halo_step_ref(tx, st, tsr, t_update)
            np.testing.assert_array_equal(tx.numpy()[:-1], np.asarray(jx)[:-1])
            real = st.rows_g.reshape(-1)[st.send_idx] < ts.n
            np.testing.assert_array_equal(tsend.numpy()[real.numpy()], np.asarray(jsend)[real.numpy()])


def _dispatch_case():
    js, ts = _schedules("twitter", "pagerank", "24")
    tp = t_sharded.make_frontier_plan(ts, 2)
    ep = Epilogue(ADD_CONST, const=0.01)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(_random_x(PLUS_TIMES, (tp.D, tp.L), rng))
    ef = torch.as_tensor(rng.standard_normal((tp.D, tp.S, tp.H)).astype(np.float32) * 1e-3)
    return ts, tp, ep, x, ef


def test_halo_step_dispatch_and_cuda_wrapper_checks():
    """``ops.fused_halo_round`` sends a CPU tensor to the plain round; the
    CUDA wrapper refuses it."""
    ts, tp, ep, x, ef = _dispatch_case()
    x2, ef2 = x.clone(), ef.clone()
    launches = fused_halo_round_cuda.launches
    got = ops.fused_halo_round(x, ef, ts, tp, PLUS_TIMES, ep, "int8")
    want = ref.fused_halo_round_ref(x2, ef2, ts, tp, PLUS_TIMES, ep, "int8")
    assert got[0] is x and got[1] is ef  # in place
    assert torch.equal(x, want[0]) and torch.equal(ef, want[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_halo_round_cuda(x, ef, ts, tp, PLUS_TIMES, ep)
    with pytest.raises(TypeError, match="Epilogue"):
        fused_halo_round_cuda(x, ef, ts, tp, PLUS_TIMES, lambda o, r, w: r)
    with pytest.raises(ValueError, match="no halo round"):
        ops.fused_halo_round(x.to("meta"), ef, ts, tp, PLUS_TIMES, ep)
    assert fused_halo_round_cuda.launches == launches


@pytest.mark.parametrize(
    "change,err",
    [
        ("x_loc", r"x_loc: want torch.float32 \(2, "),
        ("x_loc_strided", "x_loc must be contiguous"),
        ("ef", r"ef: want torch.float32 \(2, "),
        ("recv_idx", r"recv_idx: want torch.int32 \("),
        ("table", r"table: want torch.float32 \("),
        ("steps", "steps must satisfy"),
        ("halo_dtype", "halo_dtype must be one of"),
        ("plan", "plan built for another schedule"),
    ],
)
def test_halo_round_wrapper_rejects_wrong_shapes_without_launching(change, err):
    """Shapes are checked before the device, so each of these raises on the
    CPU with its own message, and no launch is counted."""
    ts, tp, ep, x, ef = _dispatch_case()
    kw = {"halo_dtype": "int8", "steps": None}
    if change == "x_loc":
        x = x[:, :-1].contiguous()
    elif change == "x_loc_strided":
        x = torch.empty((tp.D, 2 * tp.L), dtype=x.dtype)[:, ::2]
    elif change == "ef":
        ef = ef[:, :, :-1].contiguous()
    elif change == "recv_idx":
        tp = dataclasses.replace(tp, recv_idx=tp.recv_idx[:, :, :-1].contiguous())
    elif change == "table":
        ep = Epilogue(ADD_TABLE, table=torch.zeros(ts.n))
    elif change == "steps":
        kw["steps"] = (1, ts.S + 1)
    elif change == "halo_dtype":
        kw["halo_dtype"] = "bf16"
    else:
        tp = dataclasses.replace(tp, S=tp.S + 1)
    launches = fused_halo_round_cuda.launches
    with pytest.raises(ValueError, match=err):
        fused_halo_round_cuda(x, ef, ts, tp, PLUS_TIMES, ep, **kw)
    assert fused_halo_round_cuda.launches == launches


@pytest.mark.parametrize("disc", ["sync", "24"])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("halo_dtype", ["f32", "int8", "fp8"])
def test_halo_round_over_split_steps_equals_the_whole_round(halo_dtype, D, disc):
    """``[0, k)`` then ``[k, S)`` is the round ``[0, S)``: the kernel's step
    range (the unit a cross-card exchange would launch) carries nothing
    else from step to step."""
    js, ts = _schedules("twitter", "pagerank", disc)
    tp = t_sharded.make_frontier_plan(ts, D)
    n = ts.n
    ep = Epilogue(ADD_CONST, const=float(np.float32(0.15 / n)))
    rng = np.random.default_rng(5)
    x0 = torch.as_tensor(rng.random((tp.D, tp.L)).astype(np.float32) / n)
    ef0 = torch.as_tensor(rng.standard_normal((tp.D, tp.S, tp.H)).astype(np.float32) * 1e-5)
    x_all, ef_all = x0.clone(), ef0.clone()
    ops.fused_halo_round(x_all, ef_all, ts, tp, PLUS_TIMES, ep, halo_dtype)
    k = ts.S // 2
    assert k > 0 or disc == "sync"
    x_split, ef_split = x0.clone(), ef0.clone()
    for steps in ((0, k), (k, ts.S)):
        ops.fused_halo_round(x_split, ef_split, ts, tp, PLUS_TIMES, ep, halo_dtype, steps)
    np.testing.assert_array_equal(x_split.numpy()[:, :-1], x_all.numpy()[:, :-1])
    np.testing.assert_array_equal(ef_split.numpy(), ef_all.numpy())
    assert torch.equal(ef_all, ef0) == (halo_dtype == "f32")


# --------------------------------------------------------------------------- #
# (c) halo rounds against round_fn and the reference's fused halo round
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD])
def test_halo_round_equals_round_fn(tag, D):
    name, kind, sr_name = _case(tag)
    js, ts = _schedules(name, kind, "24", sr_name)
    tsr = MIN_PLUS if sr_name == "min_plus" else PLUS_TIMES
    jsr = J_MIN_PLUS if sr_name == "min_plus" else J_PLUS_TIMES
    rng = np.random.default_rng(3)
    j_update, t_update = _updates(tag, ts.n, rng)
    tp = t_sharded.make_frontier_plan(ts, D)
    plain = t_sharded.frontier_round_ext_fn(ts, tp, tsr, t_update)
    kernel = t_sharded.frontier_kernel_round_ext_fn(ts, tp, tsr, t_update)
    ref_round = jax.jit(j_engine.round_fn(js, jsr, lambda o, r, w: j_update(o, r, w, None)))
    x0 = _random_x(tsr, (ts.n,), rng)
    jx = j_engine.extend_frontier(jnp.asarray(x0), jsr)
    tx = kx = t_engine.extend_frontier(x0, tsr, "cpu")
    ef = t_sharded.frontier_ef_init(tp)
    for _ in range(3):
        jx, tx = ref_round(jx), plain(tx)
        kx, ef = kernel(kx, ef)
        np.testing.assert_array_equal(tx.numpy()[:-1], np.asarray(jx)[:-1])
        np.testing.assert_array_equal(kx.numpy()[:-1], np.asarray(jx)[:-1])
    assert not ef.any()  # the f32 wire never carries residuals


def _quant_case(seed=4):
    js, ts = _schedules("twitter", "pagerank", "24")
    n = ts.n
    c = np.float32(0.15 / n)
    x0 = np.random.default_rng(seed).random(n).astype(np.float32) / n
    return js, ts, (lambda o, r, w, q: c + r), Epilogue(ADD_CONST, const=float(c)), x0


@pytest.mark.parametrize("halo_dtype", ["f32", "int8", "fp8"])
def test_kernel_halo_round_equals_reference_fused_round_on_one_shard(halo_dtype):
    js, ts, j_update, t_update, x0 = _quant_case()
    jp, tp = j_sharded.make_frontier_plan(js, 1), t_sharded.make_frontier_plan(ts, 1)
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    j_rnd = jax.jit(
        j_sharded.frontier_pallas_round_ext_fn(
            js, jp, J_PLUS_TIMES, j_update, mesh, halo_dtype=halo_dtype, interpret=True
        )
    )
    t_rnd = t_sharded.frontier_kernel_round_ext_fn(ts, tp, PLUS_TIMES, t_update, halo_dtype)
    args = j_sharded.frontier_plan_args(js, jp)
    q = jnp.zeros((), jnp.int32)
    jx, jef = j_engine.extend_frontier(jnp.asarray(x0), J_PLUS_TIMES), j_sharded.frontier_ef_init(jp)
    tx, tef = t_engine.extend_frontier(x0, PLUS_TIMES, "cpu"), t_sharded.frontier_ef_init(tp)
    for _ in range(3):
        jx, jef = j_rnd(jx, jef, q, *args)
        tx, tef = t_rnd(tx, tef)
        np.testing.assert_array_equal(tx.numpy()[:-1], np.asarray(jx)[:-1])
        np.testing.assert_array_equal(tef.numpy(), np.asarray(jef))
    assert tef.any() == (halo_dtype != "f32")


_REFERENCE_D4 = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core.engine import extend_frontier, make_schedule
    from repro.core.semiring import PLUS_TIMES
    from repro.dist.compat import AxisType, make_mesh
    from repro.dist import engine_sharded as es
    from repro.graphs.generators import make_graph

    out, = sys.argv[1:]
    g = make_graph("twitter", scale=9, efactor=8, kind="pagerank")
    sched = make_schedule(g, 8, 24, PLUS_TIMES, mode="delayed", min_chunk=16)
    plan = es.make_frontier_plan(sched, 4)
    mesh = make_mesh((4,), ("data",), axis_types=(AxisType.Auto,), devices=jax.devices()[:4])
    c = np.float32(0.15 / g.n)
    x0 = np.random.default_rng(4).random(g.n).astype(np.float32) / g.n
    args = es.frontier_plan_args(sched, plan)
    q = jnp.zeros((), jnp.int32)
    res = {}
    for hd in ("f32", "int8", "fp8"):
        rnd = jax.jit(es.frontier_pallas_round_ext_fn(
            sched, plan, PLUS_TIMES, lambda o, r, w, q: c + r, mesh,
            halo_dtype=hd, interpret=True))
        x, ef = extend_frontier(jnp.asarray(x0), PLUS_TIMES), es.frontier_ef_init(plan)
        for k in range(3):
            x, ef = rnd(x, ef, q, *args)
            res[f"{hd}_x{k}"] = np.asarray(x)
            res[f"{hd}_ef{k}"] = np.asarray(ef)
    np.savez(out, **res)
    """
)


@pytest.fixture(scope="module")
def reference_d4(tmp_path_factory):
    """The reference's fused halo round on a 4-wide mesh of fake CPU devices,
    in its own process (the device count is fixed when jax starts): x and ef
    after each of three rounds, for every wire."""
    out = tmp_path_factory.mktemp("reference_d4") / "reference.npz"
    env = dict(
        os.environ,
        PYTHONPATH=str(REPO / "src"),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE_D4, str(out)],
        env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def test_halo_rounds_equal_reference_fused_round_on_four_shards(reference_d4):
    """The port's K2 round (its plain version here) held bit for bit against
    the reference's, residuals included.  The quantizer is the same f32
    arithmetic in both (max-abs, one division, round-half-even or an RNE fp8
    cast, one product), so no tolerance is needed."""
    want = reference_d4
    js, ts, _, t_update, x0 = _quant_case()
    tp = t_sharded.make_frontier_plan(ts, 4)
    for hd in ("f32", "int8", "fp8"):
        rnd = t_sharded.frontier_kernel_round_ext_fn(ts, tp, PLUS_TIMES, t_update, hd)
        x, ef = t_engine.extend_frontier(x0, PLUS_TIMES, "cpu"), t_sharded.frontier_ef_init(tp)
        for k in range(3):
            x, ef = rnd(x, ef)
            np.testing.assert_array_equal(x.numpy()[:-1], want[f"{hd}_x{k}"][:-1], err_msg=hd)
            np.testing.assert_array_equal(ef.numpy(), want[f"{hd}_ef{k}"], err_msg=hd)
        assert ef.any() == (hd != "f32")


def test_plain_halo_round_over_step_ranges_equals_reference_on_four_shards(reference_d4):
    """:func:`ref.fused_halo_round_ref`, called directly on the ``(D, L)``
    layout one commit step a call (the form a cross-card exchange would
    take), equals the reference's round in x and ef."""
    want = reference_d4
    js, ts, _, t_update, x0 = _quant_case()
    tp = t_sharded.make_frontier_plan(ts, 4)
    cuts = tuple(range(ts.S + 1))
    assert ts.S > 1
    for hd in ("f32", "int8", "fp8"):
        x = t_engine.extend_frontier(x0, PLUS_TIMES, "cpu")
        ef = t_sharded.frontier_ef_init(tp)
        for k in range(3):
            x_loc = tp.scatter_x(x)
            for steps in zip(cuts[:-1], cuts[1:]):
                ref.fused_halo_round_ref(x_loc, ef, ts, tp, PLUS_TIMES, t_update, hd, steps)
            x = tp.gather_x(x_loc, dump=x[-1:])
            np.testing.assert_array_equal(x.numpy()[:-1], want[f"{hd}_x{k}"][:-1], err_msg=hd)
            np.testing.assert_array_equal(ef.numpy(), want[f"{hd}_ef{k}"], err_msg=hd)


# --------------------------------------------------------------------------- #
# (e) Solver(frontier="halo") against repro.Solver(backend="jit")
# --------------------------------------------------------------------------- #
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


def _solvers(name, **kw):
    if name == "jacobi":
        (jg, jp), (tg, tp) = _jacobi_pair()
    else:
        graph, kind = {
            "pagerank": ("twitter", "pagerank"),
            "ppr": ("twitter", "pagerank"),
            "sssp": ("kron", "sssp"),
            "cc": ("kron", "sssp"),
        }[name]
        jg = j_gen.make_graph(graph, scale=9, efactor=8, kind=kind)
        tg = t_gen.make_graph(graph, scale=9, efactor=8, kind=kind)
        factory = f"{name}_problem"
        jp, tp = getattr(j_solve, factory)(), getattr(t_solve, factory)()
    js = j_solve.Solver(jg, jp, n_workers=P, min_chunk=MIN_CHUNK, backend="jit")
    ts = t_solve.Solver(
        tg, tp, n_workers=P, min_chunk=MIN_CHUNK, device="cpu", frontier="halo", n_shards=4, **kw
    )
    return js, ts


def _assert_same_result(jr, tr):
    assert (tr.rounds, tr.flushes, tr.flush_bytes, tr.delta, tr.P) == (
        jr.rounds, jr.flushes, jr.flush_bytes, jr.delta, jr.P
    )
    assert tr.converged == jr.converged
    np.testing.assert_array_equal(np.asarray(jr.x), tr.x)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("name", ["pagerank", "ppr", "sssp", "cc", "jacobi"])
def test_halo_solve_equals_reference_jit(name, backend):
    js, ts = _solvers(name)
    jr = js.solve(delta=24)
    tr = ts.solve(delta=24, backend=backend)
    assert tr.rounds > 1
    _assert_same_result(jr, tr)
    assert ts.stats["plan_builds"] == 1


@pytest.mark.parametrize("delta", ["sync", "async"])
def test_halo_solve_disciplines_equal_reference_jit(delta):
    js, ts = _solvers("sssp")
    _assert_same_result(js.solve(delta=delta), ts.solve(delta=delta))


def test_halo_auto_probes_on_the_replicated_frontier():
    js, ts = _solvers("pagerank", delta="auto")
    assert ts.resolve_delta() == js.resolve_delta()
    assert ts.stats["plan_builds"] == 0  # the probes ran replicated
    _assert_same_result(js.solve(), ts.solve())
    assert ts.stats["plan_builds"] == 1
    ts.solve()
    assert ts.stats["plan_builds"] == 1  # cached per (δ, D)


@pytest.mark.parametrize("halo_dtype", ["int8", "fp8"])
def test_quantized_halo_converges_near_the_exact_answer(halo_dtype):
    js, ts = _solvers("pagerank")
    jr = js.solve(delta=64)
    # The quantization noise floors the per-round residual near the
    # per-commit scale, so the tolerance sits above it, as the reference's
    # own test sets it (tests/test_pallas_halo.py).
    tol = max(ts.tol, 1e-3)
    tr = ts.solve(delta=64, halo_dtype=halo_dtype, tol=tol)
    assert tr.converged
    np.testing.assert_allclose(tr.x, np.asarray(jr.x), atol=1e-3)


def test_jacobi_int8_converges():
    js, ts = _solvers("jacobi")
    jr = js.solve(delta=48)
    tr = ts.solve(delta=48, halo_dtype="int8", tol=max(ts.tol, 1e-3))
    assert tr.converged
    np.testing.assert_allclose(tr.x, np.asarray(jr.x), atol=1e-3)


# --------------------------------------------------------------------------- #
# (f) validation
# --------------------------------------------------------------------------- #
def test_int8_on_min_plus_raises():
    _, ts = _solvers("sssp")
    with pytest.raises(ValueError, match="requires a floating-point semiring, got dtype=int32"):
        ts.solve(delta=24, halo_dtype="int8")


def test_int8_with_the_torch_backend_raises():
    _, ts = _solvers("pagerank")
    with pytest.raises(
        ValueError,
        match="halo_dtype='int8' requires backend='kernel', frontier='halo'; "
        "got backend='torch', frontier='halo'",
    ):
        ts.solve(delta=24, backend="torch", halo_dtype="int8")
    with pytest.raises(ValueError, match="halo_dtype='fp8' requires backend='kernel'"):
        ts.solve(delta=24, frontier="replicated", halo_dtype="fp8")


def test_shards_must_divide_workers():
    (_, _), (tg, tp) = _jacobi_pair()
    with pytest.raises(ValueError, match="P=8 not divisible by D=3"):
        t_solve.Solver(tg, tp, n_workers=8, device="cpu", frontier="halo", n_shards=3)


@pytest.mark.parametrize(
    "kwargs,err",
    [({"frontier": "mesh"}, "frontier must be one of"), ({"halo_dtype": "bf16"}, "halo_dtype must be one of")],
)
def test_unknown_frontier_and_halo_dtype(kwargs, err):
    (_, _), (tg, tp) = _jacobi_pair()
    with pytest.raises(ValueError, match=err):
        t_solve.Solver(tg, tp, device="cpu", **kwargs)


def test_low_precision_default_keeps_exact_paths_exact():
    js, ts = _solvers("pagerank", halo_dtype="int8")
    jr = js.solve(delta=24)
    _assert_same_result(jr, ts.solve(delta=24, backend="torch"))
    _assert_same_result(jr, ts.solve(delta=24, frontier="replicated"))


def test_halo_dtypes_and_backend_table():
    assert t_sharded.HALO_DTYPES == j_sharded.HALO_DTYPES
    assert t_solve.solver.FRONTIERS == j_solve.solver.FRONTIERS
    (_, _), (tg, tp) = _jacobi_pair()
    s = t_solve.Solver(tg, tp, device="cpu", frontier="halo")
    assert s.resolve_frontier() == "halo"
    assert s.resolve_frontier("replicated") == "replicated"
