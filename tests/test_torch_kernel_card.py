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


# --------------------------------------------------------------------------- #
# the serving tier: lanes of K1's loop entry
# --------------------------------------------------------------------------- #
def _serve_tenants(devices, **kw):
    """The two tenants of ``benchmarks/serve_load.py`` at scale 10: road
    (SSSP, kron) and social (ppr, twitter), lanes of 4 slots."""
    from repro_torch.launch.serve_graph import GraphService

    common = dict(n_workers=4, delta=96, batch_size=4, min_chunk=8, queue_capacity=16, **kw)
    return {
        "road": GraphService(make_graph("kron", scale=10, efactor=8, kind="sssp"), algos=("sssp",),
                             device=devices[0], **common),
        "social": GraphService(make_graph("twitter", scale=10, efactor=8, kind="pagerank"), algos=("ppr",),
                               device=devices[1], **common),
    }


def _serve_trace(services, rate=0.2):
    from repro_torch.launch.service import poisson_trace

    n = {name: svc.graph.n for name, svc in services.items()}
    return poisson_trace(rate, 300, n, seed=7, graph_for={"sssp": ("road",), "ppr": ("social",)})


@pytest.mark.gpu
def test_two_tenant_replay_on_the_card_equals_plain_lanes(cuda_device):
    """A two-tenant continuous replay with kernel lanes on the card equals
    the same replay with ``ClassPolicy(backend="torch")`` lanes in every
    report field but wall time and in every answer bit for bit: SSSP's
    plain lanes on the card (min-plus is order-free), ppr's on the CPU."""
    from repro_torch.launch.service import DEFAULT_CLASSES, ContinuousScheduler, replay_continuous

    kernel = _serve_tenants((cuda_device, cuda_device))
    plain = _serve_tenants((cuda_device, "cpu"))
    trace = _serve_trace(kernel)
    classes = {name: dataclasses.replace(p, backend="torch") for name, p in DEFAULT_CLASSES.items()}
    launches = fused_batch_solve_cuda.launches
    k_sched = ContinuousScheduler(kernel, queue_capacity=16)
    k = replay_continuous(k_sched, trace)
    k_launches = fused_batch_solve_cuda.launches - launches
    p = replay_continuous(ContinuousScheduler(plain, classes=classes, queue_capacity=16), trace)
    assert fused_batch_solve_cuda.launches == launches + k_launches  # the plain lanes launch nothing
    kr, pr = dict(k["report"]), dict(p["report"])
    kr.pop("wall_s"), pr.pop("wall_s")
    assert kr == pr and kr["completed"] > 0 and kr["unconverged"] == 0
    pres = {r.request_id: r for r in p["results"]}
    assert len(pres) == len(k["results"])
    for r in k["results"]:
        q = pres[r.request_id]
        assert (r.backend, q.backend) == ("kernel", "torch")
        for f in ("rounds", "converged", "admit_seq", "submitted_clock", "admitted_clock", "finished_clock"):
            assert getattr(r, f) == getattr(q, f), f
        np.testing.assert_array_equal(r.x.view(np.int32), q.x.view(np.int32))
    lanes = k_sched.stats()["lanes"]
    assert k_launches == sum(lane["quanta"] for lane in lanes.values()) > 0


@pytest.mark.gpu
def test_lane_quanta_equal_loop_entry_launches(cuda_device):
    """Every lane quantum on the card is one launch of K1's loop entry (no
    single-round launch), and a served answer equals a fresh one-query
    batch on the card."""
    services = _serve_tenants((cuda_device, cuda_device))
    sched = services["social"].scheduler
    counts = (fused_batch_solve_cuda.launches, fused_batch_round_cuda.launches, fused_round_cuda.launches)
    from repro_torch.launch.service import QueryRequest

    for v in (3, 11, 40, 5, 77, 9):
        assert sched.submit(QueryRequest(algo="ppr", payload=v)).accepted
    results = sched.drain()
    (lane,) = sched.stats()["lanes"].values()
    assert fused_batch_solve_cuda.launches - counts[0] == lane["quanta"] > 0
    assert (fused_batch_round_cuda.launches, fused_round_cuda.launches) == counts[1:]
    c = sched.stats()["counters"]
    assert (c["completed"], c["lane_faults"], c["failed"]) == (6, 0, 0)
    svc = services["social"]
    g = svc.graph
    r = results[0]
    fresh = svc.solver("ppr").solve_batch(np.full((1, g.n), 1.0 / g.n, np.float32), q=ppr_teleport(g, [r.payload]))
    assert r.converged and r.rounds == fresh.rounds
    np.testing.assert_array_equal(r.x.view(np.int32), fresh.x[0].view(np.int32))


# K2's rank entries (a rank's commit step, the receive) and its batch entry
# against their plain versions, bit for bit; a two-process gloo solve on the
# card against the one-process K2 solve.
RANK_SPLITS = {"whole": ((0, 4),), "halves": ((0, 2), (2, 4)), "uneven": ((0, 1), (1, 4))}
RANK_WIRES = [(ADD_CONST, "f32"), (ADD_CONST, "int8"), (ADD_CONST, "fp8"), (ADD_TABLE, "f32"),
              (ADD_TABLE, "int8"), (ADD_TABLE, "fp8"), (MIN_OLD, "f32"), (LABELPROP, "f32"), (LABELPROP, "fp8")]


def _rank_case_inputs(tag, F, rng):
    if tag == MIN_OLD:
        g, sr = make_graph("kron", scale=10, efactor=8, kind="sssp"), MIN_PLUS
        return g, sr, rng.integers(0, 1000, g.n).astype(np.int32), Epilogue(MIN_OLD)
    g, sr = make_graph("twitter", scale=10, efactor=8, kind="pagerank"), PLUS_TIMES
    shape = (g.n,) if F == 1 else (g.n, F)
    x0 = rng.random(shape).astype(np.float32)
    if tag == ADD_CONST:
        return g, sr, x0, Epilogue(ADD_CONST, const=float(np.float32(0.15 / g.n)))
    if tag == ADD_TABLE:
        table = rng.random((g.n + 1,) + shape[1:]).astype(np.float32)
        table[-1] = 0.0
        return g, sr, x0, Epilogue(ADD_TABLE, table=torch.as_tensor(table))
    anchors = (rng.random((g.n + 1,) + shape[1:]) < 0.01).astype(np.float32)
    anchors[-1] = 0.0
    return g.with_values(np.ones(g.nnz, np.float32)), sr, x0, Epilogue.labelprop(torch.as_tensor(anchors), 0.9)


@pytest.mark.gpu
@pytest.mark.parametrize("split", list(RANK_SPLITS))
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96)])
@pytest.mark.parametrize("F", [1, 4])
@pytest.mark.parametrize("tag,wire", RANK_WIRES)
def test_halo_rank_entries_match_plain_versions(cuda_device, tag, wire, F, mode, delta, split):
    """Each step: K2's rank entry over each range of shards, the send
    blocks joined in shard order, and K2's receive into each range, against
    their plain versions: send blocks, scales, x_loc (dump slots masked but
    for a quantized wire) and ef bit for bit, one launch of each a range a
    step."""
    if tag == LABELPROP and F == 1:
        F = 2  # labelprop's row total needs a matrix frontier
    rng = np.random.default_rng(F)
    g, sr, x0, ep = _rank_case_inputs(tag, F, rng)
    cpu = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32)
    dev = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32, device=cuda_device)
    plan_cpu = engine_sharded.make_frontier_plan(cpu, 4)
    plan = engine_sharded.make_frontier_plan(dev, 4)
    feat = tuple(x0.shape[1:])
    want_x = plan_cpu.scatter_x(engine.extend_frontier(x0, sr, "cpu"))
    want_ef = engine_sharded.frontier_ef_init(plan_cpu, feat)
    got_x, got_ef = want_x.to(cuda_device), want_ef.to(cuda_device)
    ep_dev = ep.to(cuda_device)
    ranges = RANK_SPLITS[split]
    launches = (ops.halo_local_step_cuda.launches, ops.halo_recv_cuda.launches)
    for s in range(cpu.S):
        want = [ref.halo_local_step_ref(want_x[a:b], want_ef[a:b], cpu, plan_cpu, sr, ep, wire, s, a, b) for a, b in ranges]
        got = [ops.halo_local_step(got_x[a:b], got_ef[a:b], dev, plan, sr, ep_dev, wire, s, a, b) for a, b in ranges]
        torch.cuda.synchronize()
        for (wr, ws), (gr, gs) in zip(want, got):
            assert torch.equal(gr.cpu().view(torch.uint8) if wire != "f32" else gr.cpu(),
                               wr.view(torch.uint8) if wire != "f32" else wr)
            assert (ws is None) == (gs is None) and (ws is None or _bits_equal(gs.cpu(), ws))
        rows_w = torch.cat([w[0] for w in want])
        rows_g = torch.cat([w[0] for w in got])
        sc_w = None if wire == "f32" else torch.cat([w[1] for w in want])
        sc_g = None if wire == "f32" else torch.cat([w[1] for w in got])
        for a, b in ranges:
            ref.halo_recv_ref(want_x[a:b], rows_w, sc_w, plan_cpu, s, a, b)
            ops.halo_recv(got_x[a:b], rows_g, sc_g, plan, s, a, b)
        torch.cuda.synchronize()
        cols = slice(None) if wire != "f32" else slice(None, -1)
        assert _bits_equal(got_x.cpu()[:, cols], want_x[:, cols]), s
        assert _bits_equal(got_ef.cpu(), want_ef), s
    n = cpu.S * len(ranges)
    assert (ops.halo_local_step_cuda.launches, ops.halo_recv_cuda.launches) == (launches[0] + n, launches[1] + n)


HALO_BATCH_CASES = [(ADD_CONST, "vector"), (ADD_TABLE, "vector"), (MIN_OLD, "vector"), (ADD_TABLE, "matrix"),
                    (LABELPROP, "matrix")]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96), ("delayed", 7)])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("tag,layout", HALO_BATCH_CASES)
def test_halo_batch_entry_matches_plain_round(cuda_device, tag, layout, C, mode, delta):
    g, sr, x, ep = _batch_card_inputs(tag, layout, C)
    cpu = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32)
    dev = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32, device=cuda_device)
    plan_cpu = engine_sharded.make_frontier_plan(cpu, 4)
    plan = engine_sharded.make_frontier_plan(dev, 4)
    want = plan_cpu.scatter_x(torch.as_tensor(x))
    got = want.to(cuda_device)
    launches = ops.fused_halo_batch_round_cuda.launches
    for _ in range(2):
        ref.fused_halo_batch_round_ref(want, cpu, plan_cpu, sr, ep)
        ops.fused_halo_batch_round(got, dev, plan, sr, ep.to(cuda_device))
        torch.cuda.synchronize()
        assert _bits_equal(got.cpu()[:, :-1], want[:, :-1])
    assert ops.fused_halo_batch_round_cuda.launches == launches + 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ppr", "sssp"])
def test_halo_batch_solve_on_card_matches_cpu(cuda_device, name):
    g = make_graph("twitter" if name == "ppr" else "kron", scale=10, efactor=8,
                   kind="pagerank" if name == "ppr" else "sssp")
    seeds = [0, 5, 17, 99, 300, 512, 700, 1000]
    if name == "ppr":
        prob, x0, q = ppr_problem(), np.full((8, g.n), 1.0 / g.n, np.float32), ppr_teleport(g, seeds)
    else:
        prob, x0, q = sssp_problem(), multi_source_x0(g, seeds), None
    kw = dict(n_workers=8, delta=96, min_chunk=32, n_shards=4)
    launches = ops.fused_halo_batch_round_cuda.launches
    on_card = Solver(g, prob, **kw).solve_batch(x0, q=q, frontier="halo")
    on_cpu = Solver(g, prob, device="cpu", **kw).solve_batch(x0, q=q, frontier="halo")
    assert ops.fused_halo_batch_round_cuda.launches == launches + on_card.rounds
    assert on_card.rounds == on_cpu.rounds
    np.testing.assert_array_equal(on_card.rounds_per_query, on_cpu.rounds_per_query)
    np.testing.assert_array_equal(on_card.x.view(np.int32), on_cpu.x.view(np.int32))


_TWO_RANKS = """
import sys, datetime, numpy as np, torch, torch.distributed as dist
from repro_torch.graphs.generators import make_graph
from repro_torch.kernels import ops
from repro_torch.solve import Solver, pagerank_problem, sssp_problem
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2, timeout=datetime.timedelta(seconds=120))
res = {}
for name, prob, wire in (("pagerank", pagerank_problem(), "f32"), ("sssp", sssp_problem(), "f32"),
                         ("pagerank_int8", pagerank_problem(), "int8")):
    g = make_graph("twitter" if name.startswith("pagerank") else "kron", scale=10, efactor=8,
                   kind="sssp" if name == "sssp" else "pagerank")
    sv = Solver(g, prob, n_workers=8, delta=96, min_chunk=32, frontier="halo", n_shards=4, group=dist.group.WORLD,
                halo_dtype=wire, max_rounds=12 if wire != "f32" else None)
    before = (ops.halo_local_step_cuda.launches, ops.halo_recv_cuda.launches)
    r = sv.solve()
    S = sv.rank_layout()[0].S
    res[name] = r.x
    res[name + "/counts"] = np.array([r.rounds, r.flushes, r.flush_bytes, S,
                                      ops.halo_local_step_cuda.launches - before[0],
                                      ops.halo_recv_cuda.launches - before[1]])
res["transport"] = np.array([sv.group.transport])
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_two_process_gloo_solve_on_the_card_equals_one_process(cuda_device, tmp_path):
    """Two processes share the card over a gloo group (NCCL takes one rank a
    card): each rank's PageRank, SSSP and int8 PageRank equal the one-process
    K2 solve bit for bit, with one rank entry and one receive a step."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r), init, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    for name, prob, wire, kind in (("pagerank", pagerank_problem(), "f32", "pagerank"),
                                   ("sssp", sssp_problem(), "f32", "sssp"),
                                   ("pagerank_int8", pagerank_problem(), "int8", "pagerank")):
        g = make_graph("twitter" if kind == "pagerank" else "kron", scale=10, efactor=8, kind=kind)
        one = Solver(g, prob, n_workers=8, delta=96, min_chunk=32, frontier="halo", n_shards=4,
                     halo_dtype=wire, max_rounds=12 if wire != "f32" else None).solve()
        for r in range(2):
            got = np.load(tmp_path / f"rank{r}.npz")
            rounds, flushes, fbytes, S, local, recv = got[name + "/counts"]
            assert (rounds, flushes, fbytes) == (one.rounds, one.flushes, one.flush_bytes)
            assert local == recv == rounds * S  # one launch of each a step
            np.testing.assert_array_equal(got[name].view(np.int32), one.x.view(np.int32))
            assert str(got["transport"][0]) == "gloo (pinned host)"


_TWO_RANKS_RESOLVE = """
import json, sys, datetime, numpy as np, torch, torch.distributed as dist
from repro_torch.evolve import EdgeBatch
from repro_torch.graphs.generators import make_graph
from repro_torch.kernels import ops
from repro_torch.solve import Solver, pagerank_problem, sssp_problem
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2, timeout=datetime.timedelta(seconds=120))
fns = (ops.round_rank_step_cuda, ops.round_publish_cuda, ops.halo_local_step_cuda, ops.halo_recv_cuda,
       ops.fused_solve_cuda)
res = {}
for name, prob, kind in (("sssp", sssp_problem(), "sssp"), ("pagerank", pagerank_problem(), "pagerank")):
    g = make_graph("kron" if kind == "sssp" else "twitter", scale=10, efactor=8, kind=kind)
    batch = EdgeBatch.from_ops(**json.load(open(f"{out}/{name}.json")))
    for frontier in ("replicated", "halo"):
        sv = Solver(g, prob, n_workers=8, delta=96, min_chunk=32, frontier=frontier, n_shards=4,
                    group=dist.group.WORLD)
        sv.solve()
        before = [f.launches for f in fns]
        r = sv.resolve(updates=batch)
        res[f"{name}/{frontier}"] = r.x
        res[f"{name}/{frontier}/counts"] = np.array([r.rounds, r.flushes, r.flush_bytes, sv.rank_layout()[0].S]
                                                    + [f.launches - b for f, b in zip(fns, before)])
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_two_process_gloo_resolve_on_the_card_equals_one_process(cuda_device, tmp_path):
    """Two processes share the card over a gloo group: after an update
    batch (four deletes and four inserts), each rank's SSSP and PageRank
    ``resolve`` on both frontiers equals the one-process kernel resolve bit
    for bit, with K1's rank step and publish (replicated) or K2's rank entry
    and receive (halo) once a step a rank, and no loop-entry launch."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    rng = np.random.default_rng(29)
    graphs, ops_of = {}, {}
    for name, kind in (("sssp", "sssp"), ("pagerank", "pagerank")):
        g = graphs[name] = make_graph("kron" if kind == "sssp" else "twitter", scale=10, efactor=8, kind=kind)
        dst = np.repeat(np.arange(g.n), np.diff(g.indptr))
        dels = [(int(g.indices[e]), int(dst[e])) for e in rng.choice(g.nnz, size=4, replace=False)]
        have = set((dst * g.n + g.indices).tolist())
        ins = []
        while len(ins) < 4:
            s_, d_ = (int(v) for v in rng.integers(0, g.n, size=2))
            if s_ != d_ and d_ * g.n + s_ not in have:
                have.add(d_ * g.n + s_)
                ins.append((s_, d_, int(rng.integers(1, 256)) if kind == "sssp" else 0.05))
        ops_of[name] = {"inserts": ins, "deletes": dels}
        (tmp_path / f"{name}.json").write_text(json.dumps(ops_of[name]))
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS_RESOLVE, str(r), init, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    for name, prob in (("sssp", sssp_problem()), ("pagerank", pagerank_problem())):
        sv = Solver(graphs[name], prob, n_workers=8, delta=96, min_chunk=32)
        sv.solve()
        one = sv.resolve(updates=EdgeBatch.from_ops(**ops_of[name]))
        for r in range(2):
            got = np.load(tmp_path / f"rank{r}.npz")
            for frontier in ("replicated", "halo"):
                rounds, flushes, fbytes, S, step, publish, local, recv, loop = got[f"{name}/{frontier}/counts"]
                assert (rounds, flushes, fbytes) == (one.rounds, one.flushes, one.flush_bytes), (name, frontier)
                per_step = (step, publish) if frontier == "replicated" else (local, recv)
                assert per_step == (rounds * S, rounds * S) and loop == 0 and step + publish + local + recv == 2 * rounds * S
                np.testing.assert_array_equal(got[f"{name}/{frontier}"].view(np.int32), one.x.view(np.int32))


# K1's rank entries (a rank's commit step over its workers, the publish of
# every worker's rows) and K2's rank entries over a batch's rows, against
# their plain versions, bit for bit; the solves across two cards over nccl.
K1_RANK_SPLITS = {"halves": ((0, 4), (4, 8)), "uneven": ((0, 1), (1, 6), (6, 8))}
K1_RANK_CASES = [(ADD_CONST, "single", 1), (ADD_CONST, "single", 4), (ADD_TABLE, "single", 1),
                 (ADD_TABLE, "single", 4), (MIN_OLD, "single", 1), (LABELPROP, "single", 4)] + [
    (tag, layout, C) for C in (8, 32) for tag, layout in BATCH_CASES]


def _k1_rank_inputs(tag, layout, C):
    """Graph, semiring, the ``(n + 1,)+feat`` frontier on the host and its
    epilogue: a single frontier of F = C columns, or a batch of C values a
    row (:func:`_batch_card_inputs`)."""
    if layout == "single":
        g, sr, x0, ep = _rank_case_inputs(tag, C, np.random.default_rng(C))
        return g, sr, engine.extend_frontier(x0, sr, "cpu"), ep
    g, sr, x, ep = _batch_card_inputs(tag, layout, C)
    return g, sr, torch.as_tensor(x), ep


@pytest.mark.gpu
@pytest.mark.parametrize("split", list(K1_RANK_SPLITS))
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96)])
@pytest.mark.parametrize("tag,layout,C", K1_RANK_CASES)
def test_k1_rank_step_and_publish_match_plain_versions(cuda_device, tag, layout, C, mode, delta, split):
    """Each step: K1's rank step over each range of workers (its real rows)
    and the publish of the joined blocks (x's real rows) against their
    plain versions; one launch of the step a range a step and of the
    publish a step; the round equal to K1's round entry's."""
    g, sr, x, ep = _k1_rank_inputs(tag, layout, C)
    cpu = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32)
    dev = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32, device=cuda_device)
    ranges = K1_RANK_SPLITS[split]
    cells_cpu = [engine_sharded.rank_cells(cpu, a, b) for a, b in ranges]
    cells_dev = [engine_sharded.rank_cells(dev, a, b) for a, b in ranges]
    want, got = x.clone(), x.to(cuda_device)
    ep_dev = ep.to(cuda_device)
    launches = (ops.round_rank_step_cuda.launches, ops.round_publish_cuda.launches)
    for s in range(cpu.S):
        blocks_w = [ref.round_rank_step_ref(want, c, sr, ep, s) for c in cells_cpu]
        blocks_g = [ops.round_rank_step(got, c, sr, ep_dev, s) for c in cells_dev]
        torch.cuda.synchronize()
        for bw, bg, c in zip(blocks_w, blocks_g, cells_cpu):
            real = c.rows[s].reshape(-1) < g.n  # padded rows' values are unspecified
            assert _bits_equal(bg.cpu()[real], bw[real]), s
        ref.round_publish_ref(want, torch.cat(blocks_w), cpu.rows, s)
        ops.round_publish(got, torch.cat(blocks_g), dev.rows, s)
        torch.cuda.synchronize()
        assert _bits_equal(got.cpu()[:-1], want[:-1]), s
    n = cpu.S * len(ranges)
    assert (ops.round_rank_step_cuda.launches, ops.round_publish_cuda.launches) == (launches[0] + n,
                                                                                    launches[1] + cpu.S)
    whole = (fused_round_cuda if layout == "single" else fused_batch_round_cuda)(x.to(cuda_device), dev, sr, ep_dev)
    torch.cuda.synchronize()
    assert _bits_equal(got.cpu()[:-1], whole.cpu()[:-1])


@pytest.mark.gpu
@pytest.mark.parametrize("split", ["halves", "uneven"])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("delayed", 96)])
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("tag,layout", HALO_BATCH_CASES)
def test_halo_rank_entries_take_the_query_axis(cuda_device, tag, layout, C, mode, delta, split):
    """K2's rank entry and receive over a batch's ``(D, L, Q)+feat`` rows (f32
    wire) against their plain versions each step, and the round against
    K2's batch entry's."""
    g, sr, x, ep = _batch_card_inputs(tag, layout, C)
    cpu = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32)
    dev = engine.make_schedule(g, 8, delta, sr, mode=mode, min_chunk=32, device=cuda_device)
    plan_cpu = engine_sharded.make_frontier_plan(cpu, 4)
    plan = engine_sharded.make_frontier_plan(dev, 4)
    start = plan_cpu.scatter_x(torch.as_tensor(x))
    want, got = start.clone(), start.to(cuda_device)
    ep_dev = ep.to(cuda_device)
    ranges = RANK_SPLITS[split]
    for s in range(cpu.S):
        rows_w = torch.cat([ref.halo_local_step_ref(want[a:b], None, cpu, plan_cpu, sr, ep, "f32", s, a, b)[0]
                            for a, b in ranges])
        rows_g = torch.cat([ops.halo_local_step(got[a:b], None, dev, plan, sr, ep_dev, "f32", s, a, b)[0]
                            for a, b in ranges])
        torch.cuda.synchronize()
        assert _bits_equal(rows_g.cpu(), rows_w), s
        for a, b in ranges:
            ref.halo_recv_ref(want[a:b], rows_w, None, plan_cpu, s, a, b)
            ops.halo_recv(got[a:b], rows_g, None, plan, s, a, b)
        torch.cuda.synchronize()
        assert _bits_equal(got.cpu()[:, :-1], want[:, :-1]), s
    whole = ops.fused_halo_batch_round(start.to(cuda_device), dev, plan, sr, ep_dev)
    torch.cuda.synchronize()
    assert _bits_equal(got.cpu()[:, :-1], whole.cpu()[:, :-1])


_TWO_CARDS = """
import sys, datetime, numpy as np, torch, torch.distributed as dist
from repro_torch.graphs.generators import make_graph
from repro_torch.solve import Solver, multi_source_x0, pagerank_problem, sssp_problem
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method=init, rank=rank, world_size=2, timeout=datetime.timedelta(seconds=120))
res = {}
for name, prob in (("pagerank", pagerank_problem()), ("sssp", sssp_problem())):
    g = make_graph("twitter" if name == "pagerank" else "kron", scale=10, efactor=8, kind=name)
    sv = Solver(g, prob, n_workers=8, delta=96, min_chunk=32, n_shards=4, group=dist.group.WORLD)
    for frontier in ("replicated", "halo"):
        r = sv.solve(frontier=frontier)
        res[f"{name}/{frontier}"] = r.x
        res[f"{name}/{frontier}/counts"] = np.array([r.rounds, r.flushes, r.flush_bytes])
    if name == "sssp":
        for frontier in ("replicated", "halo"):
            b = sv.solve_batch(multi_source_x0(g, [0, 5, 17]), frontier=frontier)
            res[f"batch/{frontier}"] = b.x
            res[f"batch/{frontier}/rpq"] = b.rounds_per_query
res["transport"] = np.array([sv.group.transport])
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_two_card_nccl_solves_equal_one_process(cuda_device, tmp_path):
    """Two processes, one card each, over an nccl group (HaloGroup's nccl
    branches: the gathers on the card): PageRank and SSSP on the replicated
    and halo frontiers and an SSSP batch on both equal the one-process
    solves bit for bit."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: an nccl group takes one rank a card")
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_CARDS, str(r), init, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    for name, prob in (("pagerank", pagerank_problem()), ("sssp", sssp_problem())):
        g = make_graph("twitter" if name == "pagerank" else "kron", scale=10, efactor=8, kind=name)
        sv = Solver(g, prob, n_workers=8, delta=96, min_chunk=32, n_shards=4)
        for frontier in ("replicated", "halo"):
            one = sv.solve(frontier=frontier)
            for r in range(2):
                got = np.load(tmp_path / f"rank{r}.npz")
                assert tuple(got[f"{name}/{frontier}/counts"]) == (one.rounds, one.flushes, one.flush_bytes)
                np.testing.assert_array_equal(got[f"{name}/{frontier}"].view(np.int32), one.x.view(np.int32))
                assert str(got["transport"][0]) == "nccl"
        if name == "sssp":
            for frontier in ("replicated", "halo"):
                b = sv.solve_batch(multi_source_x0(g, [0, 5, 17]), frontier=frontier)
                for r in range(2):
                    got = np.load(tmp_path / f"rank{r}.npz")
                    np.testing.assert_array_equal(got[f"batch/{frontier}"], b.x)
                    np.testing.assert_array_equal(got[f"batch/{frontier}/rpq"], b.rounds_per_query)


# --------------------------------------------------------------------------- #
# fault tolerance: checkpointed solves over K1's single-round entry, and the
# degradation ladder
# --------------------------------------------------------------------------- #
def _ft_solver(name, device, **kw):
    g = make_graph("twitter", scale=13, efactor=8, kind=name)
    problem = pagerank_problem() if name == "pagerank" else sssp_problem()
    return Solver(g, problem, n_workers=8, delta=1024, device=device, **kw)


def _plan(*specs):
    from repro_torch.ft.inject import FaultPlan, FaultSpec

    return FaultPlan([FaultSpec(**s) for s in specs])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_checkpointed_solve_on_card_resumes_bit_for_bit(cuda_device, tmp_path, name):
    """No fault, a fault at round 6 and a torn first snapshot give the same
    x, rounds and residuals; one K1 single-round launch a round executed; x
    equals the loop entry's over as many rounds; a fresh solver resumes."""
    from repro_torch.ft.elastic import checkpointed_solve
    from repro_torch.ft.inject import InjectedFault, inject

    sv = _ft_solver(name, cuda_device)
    plans = {
        "clean": (),
        "round": ({"site": "solver.round", "match": {"round": 6}},),
        "torn": ({"site": "ckpt.write", "kind": "torn"},),
    }
    outs = {}
    for key, specs in plans.items():
        before = fused_round_cuda.launches
        with inject(_plan(*specs)):
            outs[key] = checkpointed_solve(sv, ckpt_dir=tmp_path / key, every=4)
        assert fused_round_cuda.launches - before == outs[key].rounds_executed
    R = outs["clean"].result.rounds
    assert R > 6 and outs["clean"].result.converged
    want = {"clean": (0, R, None), "round": (1, R + 2, None), "torn": (0, R, None)}
    for key, out in outs.items():
        assert (out.restores, out.rounds_executed, out.resumed_at) == want[key]
        assert out.result.rounds == R and out.result.residuals == outs["clean"].result.residuals
        np.testing.assert_array_equal(out.result.x, outs["clean"].result.x)
    loop = sv.solve(tol=-1.0, max_rounds=R)
    assert loop.rounds == R
    np.testing.assert_array_equal(loop.x, outs["clean"].result.x)
    with inject(_plan(*plans["round"])):
        with pytest.raises(InjectedFault):
            checkpointed_solve(sv, ckpt_dir=tmp_path / "kill", every=4, max_restores=0)
    fresh = checkpointed_solve(_ft_solver(name, cuda_device), ckpt_dir=tmp_path / "kill", every=4)
    assert (fresh.restores, fresh.rounds_executed, fresh.resumed_at) == (0, R - 4, 4)
    np.testing.assert_array_equal(fresh.result.x, outs["clean"].result.x)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pagerank", "sssp"])
def test_degraded_solve_on_card(cuda_device, name):
    """One kernel.dispatch fault on backend="kernel": one Degradation to the
    plain round on the card; SSSP bit for bit, PageRank within
    ``reorder_ulp_bound`` at the kernel's round count; a halo solve steps to
    the replicated kernel first."""
    from repro_torch.ft.degrade import reorder_ulp_bound
    from repro_torch.ft.inject import inject

    kern = _ft_solver(name, cuda_device).solve()
    sv = _ft_solver(name, cuda_device, degrade=True)
    with inject(_plan({"site": "kernel.dispatch", "match": {"backend": "kernel"}})):
        out = sv.solve(tol=-1.0, max_rounds=kern.rounds) if name == "pagerank" else sv.solve()
    (d,) = sv.degradations
    assert (d.from_backend, d.from_frontier, d.to_backend, d.to_frontier) == ("kernel", "replicated", "torch",
                                                                              "replicated")
    assert out.rounds == kern.rounds
    if name == "sssp":
        np.testing.assert_array_equal(out.x, kern.x)
    else:
        gap = int(np.abs(out.x.view(np.int32).astype(np.int64) - kern.x.view(np.int32)).max())
        assert gap <= reorder_ulp_bound(sv.graph, kern.rounds), gap
    halo = _ft_solver(name, cuda_device, degrade=True, frontier="halo", n_shards=4)
    launches = fused_solve_cuda.launches
    with inject(_plan({"site": "kernel.dispatch", "match": {"backend": "kernel"}})):
        h = halo.solve()
    (d,) = halo.degradations
    assert (d.from_frontier, d.to_backend, d.to_frontier) == ("halo", "kernel", "replicated")
    assert fused_solve_cuda.launches == launches + 1
    np.testing.assert_array_equal(h.x, kern.x)


@pytest.mark.gpu
def test_launch_error_raises_with_degrade_on_card(cuda_device, monkeypatch):
    """A kernel that fails to launch raises through ``Solver(degrade=True)``:
    the ladder answers faults injected at ``kernel.dispatch`` alone, never a
    kernel's own error with the plain round."""
    from repro_torch.kernels import round_block

    lib = round_block._library()

    class Refused:  # the library, its loop entry refusing the launch
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def round_block_solve_launch(*args):
            return 720  # cudaErrorCooperativeLaunchTooLarge

    sv = _ft_solver("pagerank", cuda_device, degrade=True)
    monkeypatch.setattr(round_block, "_library", Refused)
    launches = fused_solve_cuda.launches
    with pytest.raises(RuntimeError, match="cudaError 720"):
        sv.solve()
    assert sv.degradations == [] and sv.stats["degradations"] == 0
    assert fused_solve_cuda.launches == launches
