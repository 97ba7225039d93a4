"""K1 on the card against its plain version, bit for bit.

Imports neither jax nor ``repro``, so it runs on a machine with a CUDA card
and only the port installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_card.py

Where there is no card every test here skips with its reason.  The plain
version runs on the CPU: on CUDA it would sum with atomics, in no fixed order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine  # noqa: E402
from repro_torch.core.semiring import MIN_PLUS, PLUS_TIMES  # noqa: E402
from repro_torch.graphs.generators import make_graph  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.round_block import (  # noqa: E402
    ADD_CONST,
    ADD_TABLE,
    MIN_OLD,
    Epilogue,
    fused_round_cuda,
)
from repro_torch.solve import Solver, sssp_problem  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is CUDA C++ and has no CPU mode")
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
