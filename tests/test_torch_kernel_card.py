"""K1, K2 and K3 on the card against their plain versions, bit for bit,
on vector frontiers and on (n + 1, F) matrix frontiers; K1's batch entry on
(n + 1, Q) and (n + 1, Q, F) batch frontiers; K1's loop entry (whole solves,
closed batches and open-batch quanta in one launch) against its plain loops;
after ``apply_updates``, K1's loop entry on the patched schedule and K2 over
the plan rebuilt from it, and ``resolve`` on the card against the CPU; after
a restart on a ``cache_dir``, K1's loop entry (whole and batch) over a
loaded schedule and K2 over a loaded plan.

Imports neither jax nor ``repro``, so it runs on a machine with a CUDA card
and only the port installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_card.py

Where there is no card every test here skips with its reason.  The plain
version runs on the CPU: on CUDA it would sum with atomics, in no fixed order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine  # noqa: E402
from repro_torch.evolve import EdgeBatch  # noqa: E402
from repro_torch.core.semiring import INT_INF, MIN_PLUS, PLUS_TIMES  # noqa: E402
from repro_torch.dist import engine_sharded  # noqa: E402
from repro_torch.graphs.formats import CSRGraph  # noqa: E402
from repro_torch.graphs.generators import make_graph  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.round_block import (  # noqa: E402
    ADD_CONST,
    ADD_TABLE,
    LABELPROP,
    MIN_OLD,
    Epilogue,
    fused_batch_round_cuda,
    fused_batch_solve_cuda,
    fused_halo_round_cuda,
    fused_round_cuda,
    fused_solve_cuda,
)
from repro_torch.kernels.spmv_ell import spmv_ell_cuda  # noqa: E402
from repro_torch.solve import (  # noqa: E402
    BatchStepper,
    Solver,
    label_propagation_problem,
    labelprop_anchors,
    multi_source_x0,
    pagerank_problem,
    ppr_problem,
    ppr_teleport,
    rwr_embedding_problem,
    rwr_restart,
    sssp_problem,
)
from repro_torch.solve.problem import count_changed_residual, l1_residual  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1, K2 and K3 are CUDA C++ and have no CPU mode")
    return torch.device("cuda")


def _inputs(tag, device):
    rng = np.random.default_rng(0)
    if tag == MIN_OLD:
        g, sr = make_graph("kron", scale=10, efactor=8, kind="sssp"), MIN_PLUS
        x0 = rng.integers(0, 1000, g.n).astype(np.int32)
        ep = Epilogue(MIN_OLD)
    else:
        g, sr = make_graph("twitter", scale=10, efactor=8, kind="pagerank"), PLUS_TIMES
        x0 = rng.random(g.n).astype(np.float32)
        if tag == ADD_CONST:
            ep = Epilogue(ADD_CONST, const=float(np.float32(0.15 / g.n)))
        else:
            table = np.append(rng.random(g.n), 0).astype(np.float32)
            ep = Epilogue(ADD_TABLE, table=torch.as_tensor(table))
    return g, sr, x0, ep


@pytest.mark.gpu
@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("async", None), ("delayed", 96)])
def test_kernel_matches_plain_version(cuda_device, tag, mode, delta):
    g, sr, x0, ep = _inputs(tag, cuda_device)
    cpu = engine.make_schedule(g, 4, delta, sr, mode=mode, min_chunk=32)
    dev = engine.make_schedule(g, 4, delta, sr, mode=mode, min_chunk=32, device=cuda_device)
    x = engine.extend_frontier(x0, sr, "cpu")
    launches = fused_round_cuda.launches
    for _ in range(3):
        want = ops.fused_round(x, cpu, sr, ep)
        got = ops.fused_round(x.to(cuda_device), dev, sr, ep.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu()[:-1], want[:-1])
        x = want
    assert fused_round_cuda.launches == launches + 3


@pytest.mark.gpu
def test_solver_kernel_backend_matches_cpu(cuda_device):
    g = make_graph("urand", scale=11, efactor=8, kind="sssp")
    on_card = Solver(g, sssp_problem(), n_workers=8, delta="async").solve()
    on_cpu = Solver(g, sssp_problem(), n_workers=8, delta="async", device="cpu").solve()
    assert on_card.rounds == on_cpu.rounds
    np.testing.assert_array_equal(on_card.x, on_cpu.x)


@pytest.mark.gpu
@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96)])
def test_halo_kernel_round_matches_plain_round(cuda_device, tag, mode, delta):
    g, sr, x0, ep = _inputs(tag, cuda_device)
    cpu = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32)
    dev = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32, device=cuda_device)
    plain = engine_sharded.frontier_round_ext_fn(
        cpu, engine_sharded.make_frontier_plan(cpu, 4), sr, ep
    )
    plan = engine_sharded.make_frontier_plan(dev, 4)
    kernel = engine_sharded.frontier_kernel_round_ext_fn(dev, plan, sr, ep.to(cuda_device))
    x = engine.extend_frontier(x0, sr, "cpu")
    ef = engine_sharded.frontier_ef_init(plan)
    launches = fused_halo_round_cuda.launches
    for _ in range(3):
        want = plain(x)
        got, ef = kernel(x.to(cuda_device), ef)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu()[:-1], want[:-1])
        x = want
    assert fused_halo_round_cuda.launches == launches + 3  # one launch a round


@pytest.mark.gpu
@pytest.mark.parametrize("halo_dtype", ["f32", "int8", "fp8"])
def test_halo_solver_on_card_matches_cpu(cuda_device, halo_dtype):
    g = make_graph("twitter", scale=10, efactor=8, kind="pagerank")
    kw = dict(n_workers=8, delta=96, min_chunk=32, frontier="halo", n_shards=4)
    on_card = Solver(g, pagerank_problem(), **kw).solve(halo_dtype=halo_dtype, tol=1e-2)
    on_cpu = Solver(g, pagerank_problem(), device="cpu", **kw).solve(
        halo_dtype=halo_dtype, tol=1e-2
    )
    assert on_card.rounds == on_cpu.rounds
    np.testing.assert_array_equal(on_card.x, on_cpu.x)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [None, 4])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_spmv_kernel_matches_plain_version(cuda_device, semiring, F):
    rng = np.random.default_rng(3)
    g = make_graph("kron", scale=11, efactor=8, kind="sssp" if semiring == "min_plus" else "pagerank")
    idx, val = ops.ell_from_csr(g)
    shape = (g.n + 1,) if F is None else (g.n + 1, F)
    if semiring == "min_plus":
        x = rng.integers(0, 1000, shape).astype(np.int32)
        x[rng.random(shape) < 0.3] = INT_INF
    else:
        x = rng.random(shape).astype(np.float32)
    args = [torch.as_tensor(a, device=cuda_device) for a in (x, idx, val)]
    launches = spmv_ell_cuda.launches
    got = ops.spmv(*args, semiring)
    want = ref.spmv_ell_ref(*args, semiring)
    torch.cuda.synchronize()
    assert spmv_ell_cuda.launches == launches + 1
    assert torch.equal(got, want)


def _bits_equal(got, want) -> bool:
    """Equal bit for bit; NaN compared by position (payloads may differ)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype != torch.float32:
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]
    )


def _wide_range(rng, shape):
    """f32 over 48 binades: any other summation order changes the bits."""
    return (rng.random(shape) * np.exp2(rng.integers(-24, 24, shape))).astype(np.float32)


# K1 stages a tile's edges 1,024 at a time (csrc/round_block.cu, kChunk).
K1_CHUNK = 1024


def _hub_graph(kind, n, hub_deg):
    """Row 5 has ``hub_deg`` in-edges, a fifth of the rows have none, the
    rest a few each."""
    rng = np.random.default_rng(11)
    dst = rng.integers(0, n, 4 * n)
    dst = dst[dst % 5 != 2]  # rows with no in-edges
    src = np.concatenate([rng.choice(n, hub_deg, replace=False), rng.integers(0, n, dst.size)])
    dst = np.concatenate([np.full(hub_deg, 5), dst])
    if kind == "sssp":
        vals = rng.integers(1, 256, src.size).astype(np.int32)
    else:
        vals = _wide_range(rng, src.size)
    return CSRGraph.from_edges(n, src, dst, vals, name=f"hub-{kind}")


@pytest.mark.gpu
@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 1), ("delayed", 7), ("delayed", 301), ("delayed", 3001)])
def test_tiled_round_sums_each_row_in_edge_order(cuda_device, tag, mode, delta):
    """K1's tiles: a row of 24 chunks (at δ ≥ 301; at δ = 1 and 7, where
    every (step, worker) cell is padded to the hub's, of 2.4), empty rows,
    δ not a multiple of the tile, S > 1; equal to the plain round bit for
    bit."""
    rng = np.random.default_rng(12)
    n, hub_deg = (30_001, 25_000) if mode == "sync" or delta > 100 else (4_001, 2_500)
    assert hub_deg > K1_CHUNK and (n < 30_001 or hub_deg >= 10 * K1_CHUNK)
    g = _hub_graph("sssp" if tag == MIN_OLD else "pagerank", n, hub_deg)
    if tag == MIN_OLD:
        sr, ep = MIN_PLUS, Epilogue(MIN_OLD)
        x0 = rng.integers(0, 1000, g.n).astype(np.int32)
    else:
        sr, x0 = PLUS_TIMES, _wide_range(rng, g.n)
        if tag == ADD_CONST:
            ep = Epilogue(ADD_CONST, const=float(np.float32(0.15 / g.n)))
        else:
            ep = Epilogue(ADD_TABLE, table=torch.as_tensor(_wide_range(rng, g.n + 1)))
    kw = dict(mode=mode, min_chunk=1)
    cpu = engine.make_schedule(g, 4, delta, sr, **kw)
    dev = engine.make_schedule(g, 4, delta, sr, device=cuda_device, **kw)
    assert mode == "sync" or cpu.S > 1
    x = engine.extend_frontier(x0, sr, "cpu")
    launches = fused_round_cuda.launches
    for _ in range(2):
        want = ref.fused_round_ref(x, cpu, sr, ep)
        got = ops.fused_round(x.to(cuda_device), dev, sr, ep.to(cuda_device))
        torch.cuda.synchronize()
        assert _bits_equal(got.cpu()[:-1], want[:-1])
        x = want
    assert fused_round_cuda.launches == launches + 2


@pytest.mark.gpu
@pytest.mark.parametrize("F", [None, 3, 4, 8])
@pytest.mark.parametrize("max_deg", [1, 7, 128, 4096])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_tiled_spmv_matches_plain_version_bit_for_bit(cuda_device, semiring, max_deg, F):
    """K3's tiles and column chunks at any max_deg, rows not a multiple of a
    tile, F = 3 (scalar gathers), 4 and 8 (16-B gathers; min-plus at F = 8
    takes more than 48 KB of shared memory); x holds -0.0, inf and NaN
    (plus-times), and the plain version runs on the card, where NaN is NaN
    as the kernel makes it."""
    rng = np.random.default_rng(max_deg)
    rows, n = (1001 if max_deg < 4096 else 301), 500
    idx = rng.integers(0, n + 1, (rows, max_deg)).astype(np.int32)
    shape = (n + 1,) if F is None else (n + 1, F)
    if semiring == "min_plus":
        val = rng.integers(1, 200, (rows, max_deg)).astype(np.int32)
        val[rng.random(val.shape) < 0.3] = INT_INF
        x = rng.integers(0, 1000, shape).astype(np.int32)
        x[rng.random(shape) < 0.3] = INT_INF
    else:
        val = _wide_range(rng, (rows, max_deg))
        val[rng.random(val.shape) < 0.3] = 0.0
        x = _wide_range(rng, shape)
        flat = x.reshape(-1)
        flat[0] = -0.0
        for special, count in ((-0.0, 40), (np.inf, 3), (np.nan, 3)):
            flat[rng.integers(1, flat.size, count)] = special
    args = [torch.as_tensor(a, device=cuda_device) for a in (x, idx, val)]
    launches = spmv_ell_cuda.launches
    got = ops.spmv(*args, semiring)
    want = ref.spmv_ell_ref(*args, semiring)
    torch.cuda.synchronize()
    assert spmv_ell_cuda.launches == launches + 1
    assert _bits_equal(got, want)


@pytest.mark.gpu
def test_halo_solve_without_nvcc_raises_instead_of_running_plain(cuda_device, tmp_path, monkeypatch):
    """No fallback: with no built library and no nvcc, the kernel backend's
    halo solve raises and never runs the plain round."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    build.load.cache_clear()
    calls = []
    monkeypatch.setattr(ref, "fused_halo_round_ref", lambda *a: calls.append(a))
    try:
        g = make_graph("twitter", scale=9, efactor=8, kind="pagerank")
        solver = Solver(g, pagerank_problem(), n_workers=8, delta=64, min_chunk=32,
                        frontier="halo", n_shards=4)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            solver.solve(backend="kernel")
        assert not calls
    finally:
        build.load.cache_clear()


# K2: the halo round kernel against its plain round, x_loc (dump slots
# masked) and ef bit for bit.
WIRES = {ADD_CONST: ("f32", "int8", "fp8"), ADD_TABLE: ("f32", "int8", "fp8"), MIN_OLD: ("f32",)}


def _halo_inputs(sched, plan, sr, x0, rng, device):
    """The stacked (D, L) frontier and random residuals, on the CPU and on
    ``device`` (each run in place)."""
    x_loc = plan.scatter_x(engine.extend_frontier(x0, sr, "cpu"))
    ef = torch.as_tensor(rng.standard_normal((plan.D, plan.S, plan.H)).astype(np.float32))
    ef *= float(x_loc.float().abs().mean()) * 1e-2
    return (x_loc, ef), (x_loc.to(device), ef.to(device))


def _assert_halo_equal(got, want):
    (gx, gef), (wx, wef) = got, want
    torch.cuda.synchronize()
    assert _bits_equal(gx.cpu()[:, :-1], wx[:, :-1])
    assert _bits_equal(gef.cpu(), wef)


def _halo_case(g, sr, ep, mode, delta, D, wire, device, rounds=2, min_chunk=32):
    rng = np.random.default_rng(D)
    P = max(8, D)
    cpu = engine.make_schedule(g, P, delta, sr, mode=mode, min_chunk=min_chunk)
    dev = engine.make_schedule(g, P, delta, sr, mode=mode, min_chunk=min_chunk, device=device)
    plan_cpu = engine_sharded.make_frontier_plan(cpu, D)
    plan = engine_sharded.make_frontier_plan(dev, D)
    x0 = rng.random(g.n).astype(np.float32) if sr is PLUS_TIMES else rng.integers(0, 1000, g.n).astype(np.int32)
    want, got = _halo_inputs(cpu, plan_cpu, sr, x0, rng, device)
    ep_dev = ep.to(device)
    launches = fused_halo_round_cuda.launches
    for _ in range(rounds):
        ref.fused_halo_round_ref(*want, cpu, plan_cpu, sr, ep, wire)
        ops.fused_halo_round(*got, dev, plan, sr, ep_dev, wire)
        _assert_halo_equal(got, want)
    assert fused_halo_round_cuda.launches == launches + rounds
    return cpu, dev, plan_cpu, plan


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 1), ("delayed", 7), ("delayed", 96), ("delayed", 3001)])
@pytest.mark.parametrize("tag,wire", [(t, w) for t, ws in WIRES.items() for w in ws])
def test_halo_round_kernel_matches_plain_round(cuda_device, tag, wire, mode, delta, D):
    """One launch a round over all D shards, with the exchange and (int8,
    fp8) the quantizer inside; two rounds from the same x_loc and ef."""
    g, sr, _, ep = _inputs(tag, cuda_device)
    _halo_case(g, sr, ep, mode, delta, D, wire, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 301), ("delayed", 3001)])
@pytest.mark.parametrize("tag,wire", [(t, w) for t, ws in WIRES.items() for w in ws])
def test_halo_round_sums_hub_rows_in_edge_order(cuda_device, tag, wire, mode, delta, D):
    """K1's tile walk inside K2: a row of 25,000 in-edges (24 chunks),
    empty rows and wide-range values, every shard count's split of it."""
    rng = np.random.default_rng(13)
    g = _hub_graph("sssp" if tag == MIN_OLD else "pagerank", 30_001, 25_000)
    if tag == MIN_OLD:
        sr, ep = MIN_PLUS, Epilogue(MIN_OLD)
    else:
        sr = PLUS_TIMES
        ep = Epilogue(ADD_CONST, const=float(np.float32(0.15 / g.n)))
        if tag == ADD_TABLE:
            ep = Epilogue(ADD_TABLE, table=torch.as_tensor(_wide_range(rng, g.n + 1)))
    _halo_case(g, sr, ep, mode, delta, D, wire, cuda_device, min_chunk=1)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["f32", "int8", "fp8"])
def test_halo_round_kernel_over_split_steps(cuda_device, wire):
    """``[0, k)``, ``[k, k + 1)`` and ``[k + 1, S)`` on the card (three
    launches) equal the plain round ``[0, S)``."""
    g, sr, _, ep = _inputs(ADD_CONST, cuda_device)
    cpu, dev, plan_cpu, plan = _halo_case(g, sr, ep, "delayed", 7, 4, wire, cuda_device, rounds=1)
    rng = np.random.default_rng(3)
    x0 = rng.random(g.n).astype(np.float32)
    want, got = _halo_inputs(cpu, plan_cpu, sr, x0, rng, cuda_device)
    ref.fused_halo_round_ref(*want, cpu, plan_cpu, sr, ep, wire)
    k = dev.S // 2
    assert 0 < k < dev.S - 1
    for steps in ((0, k), (k, k + 1), (k + 1, dev.S)):
        ops.fused_halo_round(*got, dev, plan, sr, ep.to(cuda_device), wire, steps)
    _assert_halo_equal(got, want)


# Matrix frontiers (n + 1, F): K1 and K2 against their plain versions by
# bits.  F = 1 runs the vector code on an (n + 1, 1) frontier, F = 2, 4, 8
# the vectorized rows, F = 3 the loop over feature blocks
# (csrc/round_block.cu).
def _matrix_inputs(tag, F, device, g=None):
    """Graph, semiring, (n, F) x0 and epilogue: rwr's add_table over an
    (n + 1, F) table, labelprop's anchors (rows with total 0 and anchored
    rows included) on unit edges, add_const, and min_old on int32."""
    rng = np.random.default_rng(F)
    if tag == MIN_OLD:
        g = g or make_graph("kron", scale=10, efactor=8, kind="sssp")
        return g, MIN_PLUS, rng.integers(0, 1000, (g.n, F)).astype(np.int32), Epilogue(MIN_OLD)
    g = g or make_graph("twitter", scale=10, efactor=8, kind="pagerank")
    x0 = rng.random((g.n, F)).astype(np.float32)
    if tag == ADD_CONST:
        return g, PLUS_TIMES, x0, Epilogue(ADD_CONST, const=float(np.float32(0.15 / g.n)))
    if tag == ADD_TABLE:
        return g, PLUS_TIMES, x0, Epilogue(ADD_TABLE, table=torch.as_tensor(_wide_range(rng, (g.n + 1, F))))
    anchors = np.zeros((g.n + 1, F), np.float32)
    anchors[rng.choice(g.n, 9, replace=False), rng.integers(0, F, 9)] = 1.0
    x0[rng.random(g.n) < 0.2] = 0.0
    g = g.with_values(np.ones(g.nnz, np.float32))
    return g, PLUS_TIMES, x0, Epilogue.labelprop(torch.as_tensor(anchors), 0.9)


MATRIX_K1 = [(1, ADD_TABLE), (1, LABELPROP), (2, MIN_OLD), (2, LABELPROP), (3, ADD_TABLE), (3, LABELPROP),
             (3, MIN_OLD), (4, ADD_CONST), (4, ADD_TABLE), (4, LABELPROP), (8, ADD_TABLE),
             (8, LABELPROP)]
MATRIX_MODES = [("sync", None), ("delayed", 1), ("delayed", 96), ("delayed", 3001)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", MATRIX_MODES)
@pytest.mark.parametrize("F,tag", MATRIX_K1)
def test_matrix_round_kernel_matches_plain_round(cuda_device, F, tag, mode, delta):
    g, sr, x0, ep = _matrix_inputs(tag, F, cuda_device)
    cpu = engine.make_schedule(g, 4, delta, sr, mode=mode, min_chunk=32)
    dev = engine.make_schedule(g, 4, delta, sr, mode=mode, min_chunk=32, device=cuda_device)
    x = engine.extend_frontier(x0, sr, "cpu")
    launches = fused_round_cuda.launches
    for _ in range(2):
        want = ref.fused_round_ref(x, cpu, sr, ep)
        got = ops.fused_round(x.to(cuda_device), dev, sr, ep.to(cuda_device))
        torch.cuda.synchronize()
        assert _bits_equal(got.cpu()[:-1], want[:-1])
        x = want
    assert fused_round_cuda.launches == launches + 2


def _matrix_halo_case(g, sr, x0, ep, mode, delta, D, wire, device, min_chunk=32):
    rng = np.random.default_rng(D)
    cpu = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=min_chunk)
    dev = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=min_chunk, device=device)
    plan_cpu = engine_sharded.make_frontier_plan(cpu, D)
    plan = engine_sharded.make_frontier_plan(dev, D)
    x_loc = plan_cpu.scatter_x(engine.extend_frontier(x0, sr, "cpu"))
    ef = torch.as_tensor(rng.standard_normal((D, plan.S, plan.H) + x0.shape[1:]).astype(np.float32))
    ef *= float(x_loc.float().abs().mean()) * 1e-2
    want, got = (x_loc, ef), (x_loc.to(device), ef.to(device))
    launches = fused_halo_round_cuda.launches
    for _ in range(2):
        ref.fused_halo_round_ref(*want, cpu, plan_cpu, sr, ep, wire)
        ops.fused_halo_round(*got, dev, plan, sr, ep.to(device), wire)
        _assert_halo_equal(got, want)
    assert fused_halo_round_cuda.launches == launches + 2


MATRIX_K2 = [(4, t, w) for t in (ADD_CONST, ADD_TABLE, LABELPROP) for w in ("f32", "int8", "fp8")]
MATRIX_K2 += [(2, MIN_OLD, "f32")]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("mode,delta", MATRIX_MODES)
@pytest.mark.parametrize("F,tag,wire", MATRIX_K2)
def test_matrix_halo_round_kernel_matches_plain_round(cuda_device, F, tag, wire, mode, delta, D):
    """(D, L, F) frontiers, (H, F) boundary blocks, one scale a feature: x_loc
    outside the dump slots and ef, two rounds from the same state."""
    g, sr, x0, ep = _matrix_inputs(tag, F, cuda_device)
    _matrix_halo_case(g, sr, x0, ep, mode, delta, D, wire, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96)])
@pytest.mark.parametrize("wire", ["f32", "int8"])
@pytest.mark.parametrize("F,tag", [(1, ADD_TABLE), (2, LABELPROP), (3, ADD_TABLE), (3, LABELPROP), (8, ADD_TABLE), (8, LABELPROP)])
def test_matrix_halo_round_other_widths(cuda_device, F, tag, wire, mode, delta):
    g, sr, x0, ep = _matrix_inputs(tag, F, cuda_device)
    _matrix_halo_case(g, sr, x0, ep, mode, delta, 4, wire, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 301), ("delayed", 3001)])
@pytest.mark.parametrize("tag", [ADD_TABLE, LABELPROP, MIN_OLD])
def test_matrix_kernels_sum_hub_rows_in_edge_order(cuda_device, tag, mode, delta):
    """F = 4 on the 25,000-edge hub row (24 chunks): K1, and K2 at D = 2 and
    4 (f32, and int8 where the semiring is float)."""
    kind = "sssp" if tag == MIN_OLD else "pagerank"
    g, sr, x0, ep = _matrix_inputs(tag, 4, cuda_device, g=_hub_graph(kind, 30_001, 25_000))
    kw = dict(mode=mode, min_chunk=1)
    cpu = engine.make_schedule(g, 4, delta, sr, **kw)
    dev = engine.make_schedule(g, 4, delta, sr, device=cuda_device, **kw)
    x = engine.extend_frontier(x0, sr, "cpu")
    want = ref.fused_round_ref(x, cpu, sr, ep)
    got = ops.fused_round(x.to(cuda_device), dev, sr, ep.to(cuda_device))
    torch.cuda.synchronize()
    assert _bits_equal(got.cpu()[:-1], want[:-1])
    for D in (2, 4):
        for wire in ("f32",) if tag == MIN_OLD else ("f32", "int8"):
            _matrix_halo_case(g, sr, x0, ep, mode, delta, D, wire, cuda_device, min_chunk=1)


@pytest.mark.gpu
@pytest.mark.parametrize("frontier", ["replicated", "halo"])
@pytest.mark.parametrize("name", ["rwr", "labelprop"])
def test_matrix_solver_on_card_matches_cpu(cuda_device, name, frontier):
    g = make_graph("twitter", scale=10, efactor=8, kind="pagerank")
    problem = rwr_embedding_problem() if name == "rwr" else label_propagation_problem()
    kw = dict(n_workers=8, delta=96, min_chunk=32, frontier=frontier, n_shards=4)
    on_card = Solver(g, problem, **kw).solve()
    on_cpu = Solver(g, problem, device="cpu", **kw).solve()
    assert (on_card.rounds, on_card.flush_bytes) == (on_cpu.rounds, on_cpu.flush_bytes)
    assert on_card.x.shape == (g.n, 4)
    np.testing.assert_array_equal(on_card.x, on_cpu.x)


@pytest.mark.gpu
@pytest.mark.parametrize("frontier", ["replicated", "halo"])
def test_matrix_solve_without_nvcc_raises_instead_of_running_plain(cuda_device, tmp_path, monkeypatch, frontier):
    """No fallback for matrix frontiers either: with no built library and no
    nvcc, the kernel backend's rwr solve raises and never runs the plain
    round."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    build.load.cache_clear()
    calls = []
    monkeypatch.setattr(ref, "fused_round_ref", lambda *a: calls.append(a))
    monkeypatch.setattr(ref, "fused_solve_ref", lambda *a: calls.append(a))
    monkeypatch.setattr(ref, "fused_halo_round_ref", lambda *a: calls.append(a))
    try:
        g = make_graph("twitter", scale=9, efactor=8, kind="pagerank")
        solver = Solver(g, rwr_embedding_problem(), n_workers=8, delta=64, min_chunk=32,
                        frontier=frontier, n_shards=4)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            solver.solve(backend="kernel")
        assert not calls
    finally:
        build.load.cache_clear()


# K1's batch entry: a batch frontier (n + 1, Q)+feat of C = Q·F values a
# row against its plain round on the CPU, bit for bit.  C = 1, 2, 4, 8 take
# the widths of the single-query kernel, 16 and 32 their own builds (edges
# staged once, columns gathered 8 at a time), 3 and 12 the feature-block
# build; labelprop's epilogue runs over each query's own F columns.
BATCH_WIDTHS = (1, 3, 8, 12, 16, 32)
# (tag, layout): "vector" is Q = C queries of (n + 1,) rows (ppr, multi-source
# sssp), "matrix" Q = C / 4 queries of F = 4 (F = 1 where 4 does not divide C).
BATCH_CASES = [(ADD_CONST, "matrix"), (ADD_TABLE, "vector"), (ADD_TABLE, "matrix"), (MIN_OLD, "vector"),
               (LABELPROP, "matrix")]


def _batch_card_inputs(tag, layout, C, g=None):
    """Graph, semiring, the (n + 1, Q)+feat batch frontier (host) and its
    epilogue with an (n + 1, Q)+feat table where the tag reads one."""
    rng = np.random.default_rng(C)
    Q, feat = (C, ()) if layout == "vector" else ((C // 4, (4,)) if C % 4 == 0 else (C, (1,)))
    shape = (Q,) + feat
    if tag == MIN_OLD:
        g = g or make_graph("kron", scale=10, efactor=8, kind="sssp")
        x = rng.integers(0, 1000, (g.n + 1,) + shape).astype(np.int32)
        x[rng.random(x.shape) < 0.3] = INT_INF
        return g, MIN_PLUS, x, Epilogue(MIN_OLD)
    g = g or make_graph("twitter", scale=10, efactor=8, kind="pagerank")
    x = _wide_range(rng, (g.n + 1,) + shape)
    if tag == ADD_CONST:
        return g, PLUS_TIMES, x, Epilogue(ADD_CONST, const=float(np.float32(0.15 / g.n)))
    if tag == ADD_TABLE:
        table = _wide_range(rng, (g.n + 1,) + shape)
        table[-1] = 0.0
        return g, PLUS_TIMES, x, Epilogue(ADD_TABLE, table=torch.as_tensor(table))
    anchors = (rng.random((g.n + 1,) + shape) < 0.01).astype(np.float32)
    anchors[-1] = 0.0
    x[rng.random(g.n + 1) < 0.2] = 0.0
    g = g.with_values(np.ones(g.nnz, np.float32))
    return g, PLUS_TIMES, x, Epilogue.labelprop(torch.as_tensor(anchors), 0.9)


def _batch_round_case(device, g, sr, x, ep, mode, delta, min_chunk=32, rounds=2):
    cpu = engine.make_schedule(g, 4, delta, sr, mode=mode, min_chunk=min_chunk)
    dev = engine.make_schedule(g, 4, delta, sr, mode=mode, min_chunk=min_chunk, device=device)
    X = torch.as_tensor(x)
    launches = (fused_batch_round_cuda.launches, fused_round_cuda.launches)
    for _ in range(rounds):
        want = ref.fused_batch_round_ref(X, cpu, sr, ep)
        got = ops.fused_batch_round(X.to(device), dev, sr, ep.to(device))
        torch.cuda.synchronize()
        assert _bits_equal(got.cpu()[:-1], want[:-1])
        X = want
    assert (fused_batch_round_cuda.launches, fused_round_cuda.launches) == (launches[0] + rounds, launches[1])


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", MATRIX_MODES)
@pytest.mark.parametrize("C", BATCH_WIDTHS)
@pytest.mark.parametrize("tag,layout", BATCH_CASES)
def test_batch_round_kernel_matches_plain_round(cuda_device, tag, layout, C, mode, delta):
    g, sr, x, ep = _batch_card_inputs(tag, layout, C)
    _batch_round_case(cuda_device, g, sr, x, ep, mode, delta)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 301), ("delayed", 3001)])
@pytest.mark.parametrize("tag,layout", BATCH_CASES)
def test_batch_round_sums_hub_rows_in_edge_order(cuda_device, tag, layout, mode, delta):
    """C = 8 on the 25,000-edge hub row (24 chunks), empty rows and
    wide-range values."""
    g = _hub_graph("sssp" if tag == MIN_OLD else "pagerank", 30_001, 25_000)
    g, sr, x, ep = _batch_card_inputs(tag, layout, 8, g=g)
    _batch_round_case(cuda_device, g, sr, x, ep, mode, delta, min_chunk=1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ppr", "sssp", "rwr", "labelprop"])
def test_batch_solve_on_card_matches_cpu(cuda_device, name):
    """``solve_batch`` (one launch of K1's loop entry) and a ``BatchStepper``
    on the card equal the CPU's, query for query."""
    kind = "sssp" if name == "sssp" else "pagerank"
    g = make_graph("kron" if name == "sssp" else "twitter", scale=10, efactor=8, kind=kind)
    rng = np.random.default_rng(5)
    seeds = rng.choice(g.n, 4, replace=False)
    if name == "sssp":
        problem, x0, q = sssp_problem(), multi_source_x0(g, seeds), None
    elif name == "ppr":
        problem, x0, q = ppr_problem(), np.full((4, g.n), 1.0 / g.n, np.float32), ppr_teleport(g, seeds)
    elif name == "rwr":
        problem, x0 = rwr_embedding_problem(), np.full((4, g.n, 4), 1.0 / g.n, np.float32)
        q = np.stack([rwr_restart(g, rng.choice(g.n, 4, replace=False)) for _ in range(4)])
    else:
        problem, x0 = label_propagation_problem(max_rounds=100), np.full((4, g.n, 4), 0.25, np.float32)
        q = np.stack([labelprop_anchors(g, rng.choice(g.n, 4, replace=False)) for _ in range(4)])
    kw = dict(n_workers=8, delta=96, min_chunk=32)
    card, cpu = Solver(g, problem, **kw), Solver(g, problem, device="cpu", **kw)
    launches = (fused_batch_solve_cuda.launches, fused_batch_round_cuda.launches)
    on_card, on_cpu = card.solve_batch(x0, q=q), cpu.solve_batch(x0, q=q)
    assert (fused_batch_solve_cuda.launches, fused_batch_round_cuda.launches) == (launches[0] + 1, launches[1])
    assert (on_card.rounds, on_card.flush_bytes) == (on_cpu.rounds, on_cpu.flush_bytes)
    np.testing.assert_array_equal(on_card.rounds_per_query, on_cpu.rounds_per_query)
    np.testing.assert_array_equal(on_card.x, on_cpu.x)
    rows = {}
    for solver in (card, cpu):
        st = BatchStepper(solver, capacity=3)
        done = {}
        for i in range(4):
            while not st.free_slots:
                done.update((r.tag, r) for r in st.run(5))
            st.admit(x0[i], q=None if q is None else q[i], tag=i)
        while st.occupancy:
            done.update((r.tag, r) for r in st.run(5))
        rows[solver.device.type] = done
    for i in range(4):
        assert rows["cuda"][i].rounds == rows["cpu"][i].rounds
        np.testing.assert_array_equal(rows["cuda"][i].x, rows["cpu"][i].x)


@pytest.mark.gpu
def test_batch_solve_without_nvcc_raises_instead_of_running_plain(cuda_device, tmp_path, monkeypatch):
    """No fallback for batches: with no built library and no nvcc, a kernel
    batch solve raises and never runs the plain round."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    build.load.cache_clear()
    calls = []
    monkeypatch.setattr(ref, "fused_batch_round_ref", lambda *a: calls.append(a))
    monkeypatch.setattr(ref, "fused_batch_solve_ref", lambda *a: calls.append(a))
    monkeypatch.setattr(ref, "fused_round_ref", lambda *a: calls.append(a))
    try:
        g = make_graph("twitter", scale=9, efactor=8, kind="pagerank")
        solver = Solver(g, ppr_problem(), n_workers=8, delta=64, min_chunk=32)
        x0 = np.full((2, g.n), 1.0 / g.n, np.float32)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            solver.solve_batch(x0, q=ppr_teleport(g, [1, 2]), backend="kernel")
        assert not calls
    finally:
        build.load.cache_clear()


# K1's loop entry against its plain loops (ref.fused_solve_ref,
# ref.fused_batch_solve_ref on the CPU): x bit for bit, rounds, flags and
# first-convergence rounds exactly.  The residual sums N non-negative float32
# terms (a query's n·F values) in another order than torch's: each order lies
# within (N - 1)·2⁻²⁴ of the exact sum (relative), so the two within
# 2·N·2⁻²⁴ (_loop_rtol).  Count-changed sums are exact integers and compared
# exactly.
def _loop_rtol(terms: int) -> float:
    return 2 * terms * 2.0**-24


def _assert_loop_equal(got, want, terms, batch):
    assert _bits_equal(got[0].cpu()[:-1], want[0][:-1])
    assert got[2] == want[2]
    if batch:
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[4], want[4])
    else:
        assert got[3] == want[3]
    res_got, res_want = np.atleast_1d(got[1]), np.atleast_1d(want[1])
    assert res_got.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(res_got), np.isfinite(res_want))
    fin = np.isfinite(res_want)
    np.testing.assert_allclose(res_got[fin], res_want[fin], rtol=_loop_rtol(terms))


def _loop_case(device, g, sr, x, ep, residual, mode, delta, tol, max_rounds, batch=False, conv0=None,
               min_chunk=32):
    """One loop on the card (one launch) against the plain loop on the CPU;
    ``x`` is an (n + 1,)+feat frontier, or with ``batch`` an (n + 1, Q)+feat
    batch (``conv0``: an open batch's flags)."""
    cpu = engine.make_schedule(g, 4, delta, sr, mode=mode, min_chunk=min_chunk)
    dev = engine.make_schedule(g, 4, delta, sr, mode=mode, min_chunk=min_chunk, device=device)
    X = torch.as_tensor(x)
    before = (fused_solve_cuda.launches, fused_batch_solve_cuda.launches,
              fused_round_cuda.launches, fused_batch_round_cuda.launches)
    if batch:
        want = ref.fused_batch_solve_ref(X, cpu, sr, ep, residual, tol, max_rounds, conv0)
        got = ops.fused_batch_solve(X.to(device), dev, sr, ep.to(device), residual, tol, max_rounds, conv0)
        terms = g.n * int(np.prod(X.shape[2:], dtype=np.int64))
    else:
        want = ref.fused_solve_ref(X, cpu, sr, ep, residual, tol, max_rounds)
        got = ops.fused_solve(X.to(device), dev, sr, ep.to(device), residual, tol, max_rounds)
        terms = g.n * int(np.prod(X.shape[1:], dtype=np.int64))
    after = (fused_solve_cuda.launches, fused_batch_solve_cuda.launches,
             fused_round_cuda.launches, fused_batch_round_cuda.launches)
    assert after == (before[0] + (not batch), before[1] + batch, before[2], before[3])
    _assert_loop_equal(got, want, terms, batch)
    return got


LOOP_TOL = {ADD_CONST: 1e-6, ADD_TABLE: 1e-3, MIN_OLD: 0.5}


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [False, True])
@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 1), ("delayed", 96), ("delayed", 3001)])
def test_loop_entry_matches_plain_loop(cuda_device, tag, mode, delta, budget):
    """A whole solve in one launch: to convergence (pagerank from a uniform
    start, ppr's table, sssp-like min_old), or over a budget of 3 rounds
    with tol = -1."""
    g, sr, x0, ep = _inputs(tag, cuda_device)
    if tag == ADD_CONST:
        x0 = np.full(g.n, 1.0 / g.n, np.float32)
    residual = count_changed_residual if tag == MIN_OLD else l1_residual
    tol, rounds = (-1.0, 3) if budget else (LOOP_TOL[tag], 300)
    got = _loop_case(cuda_device, g, sr, engine.extend_frontier(x0, sr, "cpu"), ep, residual, mode, delta,
                     tol, rounds)
    assert got[3] != budget and got[2] > 1


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96)])
@pytest.mark.parametrize("F,tag", MATRIX_K1)
def test_matrix_loop_entry_matches_plain_loop(cuda_device, F, tag, mode, delta):
    """F = 1 to 8 (vector rows, the feature-block build at F = 3), 4 rounds."""
    g, sr, x0, ep = _matrix_inputs(tag, F, cuda_device)
    residual = count_changed_residual if tag == MIN_OLD else l1_residual
    _loop_case(cuda_device, g, sr, engine.extend_frontier(x0, sr, "cpu"), ep, residual, mode, delta, -1.0, 4)


def _open_flags(Q):
    return np.arange(Q) % 3 == 1  # every third query starts converged


@pytest.mark.gpu
@pytest.mark.parametrize("closed", [True, False])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96)])
@pytest.mark.parametrize("C", BATCH_WIDTHS)
@pytest.mark.parametrize("tag,layout", BATCH_CASES)
def test_batch_loop_entry_matches_plain_loop(cuda_device, tag, layout, C, mode, delta, closed):
    """A closed batch, and an open one whose flagged queries must not move,
    over 3 rounds (tol = -1)."""
    g, sr, x, ep = _batch_card_inputs(tag, layout, C)
    residual = count_changed_residual if tag == MIN_OLD else l1_residual
    conv0 = None if closed else _open_flags(x.shape[1])
    got = _loop_case(cuda_device, g, sr, x, ep, residual, mode, delta, -1.0, 3, True, conv0)
    if not closed:
        frozen = torch.as_tensor(conv0)
        assert _bits_equal(got[0].cpu()[:-1, frozen], torch.as_tensor(x)[:-1, frozen])


@pytest.mark.gpu
@pytest.mark.parametrize("closed", [True, False])
@pytest.mark.parametrize("name", ["ppr", "sssp"])
def test_batch_loop_entry_stamps_first_convergence(cuda_device, name, closed):
    """Eight queries to convergence: each query's first-convergence round
    (stamped on the card), and, open, each row frozen from then on."""
    rng = np.random.default_rng(2)
    if name == "sssp":
        g = make_graph("kron", scale=10, efactor=8, kind="sssp")
        x = np.ascontiguousarray(np.concatenate([multi_source_x0(g, rng.choice(g.n, 8, replace=False)).T,
                                                 np.full((1, 8), INT_INF, np.int32)]))
        sr, ep, residual, tol = MIN_PLUS, Epilogue(MIN_OLD), count_changed_residual, 0.5
    else:
        g = make_graph("twitter", scale=10, efactor=8, kind="pagerank")
        x = np.full((g.n + 1, 8), 1.0 / g.n, np.float32)
        ep = Solver(g, ppr_problem(), n_workers=4, device="cpu").batch_row_update(
            ppr_teleport(g, rng.choice(g.n, 8, replace=False)), 8, ())
        sr, residual, tol = PLUS_TIMES, l1_residual, 1e-6
    conv0 = None if closed else np.zeros(8, bool)
    got = _loop_case(cuda_device, g, sr, x, ep, residual, "delayed", 96, tol, 500, True, conv0)
    assert got[3].all() and got[2] == got[4].max() and got[4].min() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 301), ("delayed", 3001)])
@pytest.mark.parametrize("tag,layout", BATCH_CASES)
def test_loop_entry_sums_hub_rows_in_edge_order(cuda_device, tag, layout, mode, delta):
    """The 25,000-edge hub row (24 chunks), empty rows and wide-range values,
    3 rounds: one query (the batch's first column) and a batch of C = 8."""
    g = _hub_graph("sssp" if tag == MIN_OLD else "pagerank", 30_001, 25_000)
    g, sr, x, ep = _batch_card_inputs(tag, layout, 8, g=g)
    residual = count_changed_residual if tag == MIN_OLD else l1_residual
    one = x[:, 0].copy()
    ep_one = ep if ep.table is None else dataclasses.replace(ep, table=ep.table[:, 0].contiguous())
    _loop_case(cuda_device, g, sr, one, ep_one, residual, mode, delta, -1.0, 3, min_chunk=1)
    _loop_case(cuda_device, g, sr, x, ep, residual, mode, delta, -1.0, 3, True, min_chunk=1)
    _loop_case(cuda_device, g, sr, x, ep, residual, mode, delta, -1.0, 3, True, _open_flags(x.shape[1]), min_chunk=1)


@pytest.mark.gpu
def test_solves_launch_the_loop_entry_once(cuda_device):
    """A replicated solve is one launch of the loop entry and no round
    launch; a closed batch one a compaction chunk, a stepper one a quantum."""
    g = make_graph("twitter", scale=10, efactor=8, kind="pagerank")
    solver = Solver(g, ppr_problem(), n_workers=8, delta=96, min_chunk=32)
    counts = lambda: (fused_solve_cuda.launches, fused_batch_solve_cuda.launches,  # noqa: E731
                      fused_round_cuda.launches, fused_batch_round_cuda.launches)
    before = counts()
    r = solver.solve(q=ppr_teleport(g, [5])[0])
    assert r.converged and len(r.residuals) == 1 and r.round_times_s == []
    assert counts() == (before[0] + 1,) + before[1:]
    x0 = np.full((4, g.n), 1.0 / g.n, np.float32)
    b = solver.solve_batch(x0, q=ppr_teleport(g, [1, 2, 3, 4]), compact_every=2)
    assert counts() == (before[0] + 1, before[1] + -(-b.rounds // 2), before[2], before[3])
    st = BatchStepper(solver, capacity=2)
    st.admit(x0[0], q=ppr_teleport(g, [9])[0])
    while st.occupancy:
        st.run(4)
    assert counts()[1] == before[1] + -(-b.rounds // 2) + st.quanta


# --------------------------------------------------------------------------- #
# evolving graphs: the kernels over patched schedules and rebuilt plans
# --------------------------------------------------------------------------- #
def _evolve_batch(g, k, rng, weight):
    """k/2 deletes, k/4 reweights, the rest inserts, each value from ``weight``."""
    dst = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    src = g.indices.astype(np.int64)
    n_del, n_rw = k // 2, k // 4
    pick = rng.choice(g.nnz, size=n_del + n_rw, replace=False)
    keys = set((dst * g.n + src).tolist())
    inserts = []
    while len(inserts) < k - n_del - n_rw:
        s, d = (int(v) for v in rng.integers(0, g.n, size=2))
        if s != d and d * g.n + s not in keys:
            keys.add(d * g.n + s)
            inserts.append((s, d, weight()))
    return EdgeBatch.from_ops(
        inserts=inserts,
        deletes=[(int(src[e]), int(dst[e])) for e in pick[:n_del]],
        reweights=[(int(src[e]), int(dst[e]), weight()) for e in pick[n_del:]],
    )


def _evolved(name, device, mode, delta, **kw):
    """A solver on ``device`` after a solve and ``resolve(updates=...)`` of a
    mixed batch of 64 edge operations, and its resolve's result."""
    rng = np.random.default_rng(8)
    if name == "sssp":
        g = make_graph("kron", scale=10, efactor=8, kind="sssp")
        problem, weight = sssp_problem(source=int(np.argmax(g.out_degree))), lambda: int(rng.integers(1, 256))
    else:
        g = make_graph("twitter", scale=10, efactor=8, kind="pagerank")
        problem, weight = pagerank_problem(), lambda: float(np.float32(rng.random() * 0.1))
    d = delta if mode == "delayed" else mode
    solver = Solver(g, problem, n_workers=8, delta=d, min_chunk=32, device=device, **kw)
    solver.solve()
    r = solver.resolve(updates=_evolve_batch(g, 64, rng, weight))
    return solver, r


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96), ("delayed", 3001)])
@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_loop_entry_on_patched_schedule_matches_plain_loop(cuda_device, name, mode, delta):
    """After apply_updates: resolve is one launch of the loop entry and equals
    the CPU solver's resolve; the patched row_ptr is that of the patched
    dst_local; the loop entry on the patched schedule equals the plain loop
    (to convergence, and over a budget of 3 rounds)."""
    before = fused_solve_cuda.launches
    solver, r = _evolved(name, cuda_device, mode, delta)
    assert fused_solve_cuda.launches == before + 2  # the solve and the resolve
    cpu, r_cpu = _evolved(name, "cpu", mode, delta)
    assert (r.rounds, r.converged, r.flushes) == (r_cpu.rounds, r_cpu.converged, r_cpu.flushes)
    np.testing.assert_array_equal(r.x, r_cpu.x)
    sched = solver.schedule()
    assert torch.equal(sched.row_ptr, engine._cell_row_ptr(sched.dst_local, sched.delta))
    assert torch.equal(sched.row_ptr.cpu(), cpu.schedule().row_ptr)
    host = dataclasses.replace(
        sched, **{f: getattr(sched, f).cpu() for f in ("src", "val", "dst_local", "rows", "row_ptr")}
    )
    sr, ep, residual = solver.problem.semiring, solver.row_update(), solver.problem.residual
    x = engine.extend_frontier(solver.problem.x0(solver.graph), sr, "cpu")
    for tol, max_rounds in ((solver.tol, 300), (-1.0, 3)):
        want = ref.fused_solve_ref(x, host, sr, ep.to("cpu"), residual, tol, max_rounds)
        got = ops.fused_solve(x.to(cuda_device), sched, sr, ep, residual, tol, max_rounds)
        _assert_loop_equal(got, want, solver.graph.n, batch=False)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96)])
@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_halo_round_over_rebuilt_plan_matches_plain_round(cuda_device, name, mode, delta):
    """After apply_updates the halo resolve runs K2 over a plan rebuilt from
    the patched schedule, equals the replicated resolve, and K2 over that plan
    equals the plain halo round, 3 rounds."""
    solver, r = _evolved(name, cuda_device, mode, delta, frontier="halo", n_shards=4)
    assert solver.stats["plan_builds"] == 2  # the first solve's plan, and the rebuilt one
    _, r_rep = _evolved(name, cuda_device, mode, delta)
    assert (r.rounds, r.flushes) == (r_rep.rounds, r_rep.flushes)
    np.testing.assert_array_equal(r.x, r_rep.x)
    sched = solver.schedule()
    plan = solver.frontier_plan(sched)
    # the plain side: a fresh schedule of the mutated graph (same bounds, δ)
    # padded to the patched M, on the CPU, equal to the patched one
    c_sched = engine.make_schedule(solver._sched_graph, 8, sched.delta, solver.problem.semiring,
                                   bounds=solver.bounds)
    pad = sched.M - c_sched.M
    c_sched = dataclasses.replace(
        c_sched,
        M=sched.M,
        src=torch.nn.functional.pad(c_sched.src, (0, pad), value=0),
        val=torch.nn.functional.pad(c_sched.val, (0, pad), value=solver.problem.semiring.pad_edge_val.item()),
        dst_local=torch.nn.functional.pad(c_sched.dst_local, (0, pad), value=sched.delta),
    )
    for f in ("src", "val", "dst_local", "rows", "row_ptr"):
        assert torch.equal(getattr(sched, f).cpu(), getattr(c_sched, f)), f
    sr, ep = solver.problem.semiring, solver.row_update()
    plain = engine_sharded.frontier_round_ext_fn(c_sched, engine_sharded.make_frontier_plan(c_sched, 4), sr,
                                                 ep.to("cpu"))
    kernel = engine_sharded.frontier_kernel_round_ext_fn(sched, plan, sr, ep)
    x = engine.extend_frontier(solver.problem.x0(solver.graph), sr, "cpu")
    ef = engine_sharded.frontier_ef_init(plan)
    launches = fused_halo_round_cuda.launches
    for _ in range(3):
        want = plain(x)
        got, ef = kernel(x.to(cuda_device), ef)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu()[:-1], want[:-1])
        x = want
    assert fused_halo_round_cuda.launches == launches + 3



# --------------------------------------------------------------------------- #
# warm restarts: the kernels over a loaded schedule and a loaded plan
# --------------------------------------------------------------------------- #
def _warm_pair(device, cache_dir, **kw):
    """A cold solver's solve on ``device`` with ``cache_dir``, then a second
    solver on the same directory (a restarted process), which must load its
    δ-model, schedule and plan: no probe, no build."""
    g = make_graph("twitter", scale=10, efactor=8, kind="pagerank")
    kw = dict(dict(n_workers=8, delta="auto", min_chunk=32, cache_dir=cache_dir, device=device), **kw)
    cold = Solver(g, pagerank_problem(), **kw)
    r_cold = cold.solve()
    warm = Solver(g, pagerank_problem(), **kw)
    assert warm.stats["solves"] == 0
    assert (warm.delta_model is not None) == (kw["delta"] == "auto")
    return cold, r_cold, warm


def _assert_loaded(solver, loads):
    """No build, and ``loads`` entries loaded (δ-model, schedule, plan)."""
    s = solver.stats
    assert s["schedule_builds"] == s["stripe_builds"] == s["plan_builds"] == s["plan_shard_builds"] == 0, s
    assert s["cache_loads"] == loads, s


def _on_cpu(sched):
    return dataclasses.replace(sched, **{f: getattr(sched, f).cpu() for f in ("src", "val", "dst_local", "rows",
                                                                            "row_ptr")})


@pytest.mark.gpu
def test_warm_solver_runs_the_loop_entry_once_over_a_loaded_schedule(cuda_device, tmp_path):
    """The restarted solver's first solve is one launch of K1's loop entry
    over the schedule it loaded, equal to the cold solve, and the loop entry
    on that schedule equals the plain loop on it (row_ptr derived on the
    card)."""
    cold, r_cold, warm = _warm_pair(cuda_device, tmp_path)
    before = (fused_solve_cuda.launches, fused_round_cuda.launches)
    r = warm.solve()
    assert (fused_solve_cuda.launches, fused_round_cuda.launches) == (before[0] + 1, before[1])
    _assert_loaded(warm, 2)
    assert (r.delta, r.rounds, r.converged, r.flushes, r.flush_bytes) == (
        r_cold.delta, r_cold.rounds, r_cold.converged, r_cold.flushes, r_cold.flush_bytes)
    np.testing.assert_array_equal(r.x, r_cold.x)
    sched = warm.schedule()
    assert torch.equal(sched.row_ptr, engine._cell_row_ptr(sched.dst_local, sched.delta))
    for f in ("src", "val", "dst_local", "rows", "row_ptr"):
        assert torch.equal(getattr(sched, f), getattr(cold.schedule(), f)), f
    sr, ep, residual = warm.problem.semiring, warm.row_update(), warm.problem.residual
    x = engine.extend_frontier(warm.problem.x0(warm.graph), sr, "cpu")
    for tol, max_rounds in ((warm.tol, 300), (-1.0, 3)):
        want = ref.fused_solve_ref(x, _on_cpu(sched), sr, ep.to("cpu"), residual, tol, max_rounds)
        got = ops.fused_solve(x.to(cuda_device), sched, sr, ep, residual, tol, max_rounds)
        _assert_loop_equal(got, want, warm.graph.n, batch=False)


@pytest.mark.gpu
def test_warm_batch_runs_the_batch_entry_over_a_loaded_schedule(cuda_device, tmp_path):
    """A restarted solver's batch is one launch of K1's loop entry in its
    batch form over the loaded schedule, equal to the cold solver's batch
    and to the plain batch loop on that schedule."""
    cold, _, warm = _warm_pair(cuda_device, tmp_path, delta=96)
    g = warm.graph
    x0 = np.full((4, g.n), 1.0 / g.n, np.float32)
    b_cold = cold.solve_batch(x0)
    before = (fused_batch_solve_cuda.launches, fused_batch_round_cuda.launches)
    b = warm.solve_batch(x0)
    assert (fused_batch_solve_cuda.launches, fused_batch_round_cuda.launches) == (before[0] + 1, before[1])
    _assert_loaded(warm, 1)
    assert (b.rounds, b.flush_bytes) == (b_cold.rounds, b_cold.flush_bytes)
    np.testing.assert_array_equal(b.x, b_cold.x)
    sched, sr = warm.schedule(), warm.problem.semiring
    ep, residual = warm.batch_row_update(None, 4, ()), warm.problem.residual
    X = torch.as_tensor(np.concatenate([x0.T, np.zeros((1, 4), np.float32)])).contiguous()
    want = ref.fused_batch_solve_ref(X, _on_cpu(sched), sr, ep.to("cpu"), residual, warm.tol, 300)
    got = ops.fused_batch_solve(X.to(cuda_device), sched, sr, ep, residual, warm.tol, 300)
    _assert_loop_equal(got, want, g.n, batch=True)


@pytest.mark.gpu
def test_warm_halo_solve_runs_k2_over_a_loaded_plan(cuda_device, tmp_path):
    """A restarted halo solver loads its plan (the derived owned_flat and
    dump_last derived on the card) and runs K2 over it, one launch a round,
    bit for bit the cold plan's solve; K2 over the loaded plan equals the
    plain round, 3 rounds."""
    kw = dict(delta=96, frontier="halo", n_shards=4)
    cold, r_cold, warm = _warm_pair(cuda_device, tmp_path, **kw)
    launches = fused_halo_round_cuda.launches
    r = warm.solve()
    assert fused_halo_round_cuda.launches == launches + r.rounds
    _assert_loaded(warm, 2)  # the schedule and the plan
    assert (r.rounds, r.flushes, r.flush_bytes) == (r_cold.rounds, r_cold.flushes, r_cold.flush_bytes)
    np.testing.assert_array_equal(r.x, r_cold.x)
    sched = warm.schedule()
    plan, fresh = warm.frontier_plan(sched), engine_sharded.make_frontier_plan(sched, 4)
    for f in ("src_loc", "rows_loc", "send_idx", "recv_idx", "gather_index", "owned_flat", "dump_last"):
        assert torch.equal(getattr(plan, f), getattr(fresh, f)), f
    sr, ep = warm.problem.semiring, warm.row_update()
    host = _on_cpu(sched)
    plain = engine_sharded.frontier_round_ext_fn(host, engine_sharded.make_frontier_plan(host, 4), sr, ep.to("cpu"))
    kernel = engine_sharded.frontier_kernel_round_ext_fn(sched, plan, sr, ep)
    x = engine.extend_frontier(warm.problem.x0(warm.graph), sr, "cpu")
    ef = engine_sharded.frontier_ef_init(plan)
    launches = fused_halo_round_cuda.launches
    for _ in range(3):
        want = plain(x)
        got, ef = kernel(x.to(cuda_device), ef)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu()[:-1], want[:-1])
        x = want
    assert fused_halo_round_cuda.launches == launches + 3
