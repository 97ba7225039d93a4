"""K1, the fused-round kernel of the port, against the reference's Pallas kernel.

On the CPU, ``repro_torch.kernels.ops.fused_round`` runs K1's plain version;
it must equal ``repro.kernels.ops.fused_round`` (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it) bit for bit, for all
three epilogues and the sync/async/delayed disciplines.  The CUDA wrapper's
argument checks run here too; the kernel itself runs only on a card
(``tests/test_torch_kernel_card.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as j_engine  # noqa: E402
from repro.core.semiring import MIN_PLUS as J_MIN_PLUS  # noqa: E402
from repro.core.semiring import PLUS_TIMES as J_PLUS_TIMES  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.semiring import MIN_PLUS, PLUS_TIMES  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.round_block import (  # noqa: E402
    ADD_CONST,
    ADD_TABLE,
    MIN_OLD,
    Epilogue,
    _check_args,
    fused_round_cuda,
)

P = 4
MIN_CHUNK = 16


def _case(tag, delta, mode, seed=0):
    """Reference and port inputs for one round: graph, schedules, updates, x."""
    rng = np.random.default_rng(seed)
    if tag == MIN_OLD:
        name, kind, jsr, tsr = "kron", "sssp", J_MIN_PLUS, MIN_PLUS
    else:
        name, kind, jsr, tsr = "twitter", "pagerank", J_PLUS_TIMES, PLUS_TIMES
    jg = j_gen.make_graph(name, scale=9, efactor=8, kind=kind)
    tg = t_gen.make_graph(name, scale=9, efactor=8, kind=kind)
    js = j_engine.make_schedule(jg, P, delta, jsr, mode=mode, min_chunk=MIN_CHUNK)
    ts = t_engine.make_schedule(tg, P, delta, tsr, mode=mode, min_chunk=MIN_CHUNK)
    if tag == MIN_OLD:
        x0 = rng.integers(0, 1000, jg.n).astype(np.int32)
        j_update, t_update = (lambda o, r, w: jnp.minimum(o, r)), Epilogue(MIN_OLD)
    elif tag == ADD_CONST:
        x0 = rng.random(jg.n).astype(np.float32)
        tele = np.float32(0.15 / jg.n)
        j_update = lambda o, r, w: tele + r
        t_update = Epilogue(ADD_CONST, const=float(tele))
    else:
        x0 = rng.random(jg.n).astype(np.float32)
        q = rng.random(jg.n).astype(np.float32)
        jq = jnp.asarray(q)
        j_update = lambda o, r, w: jq[w] + r
        t_update = Epilogue(ADD_TABLE, table=torch.as_tensor(np.append(q, 0)).float())
    jx = j_engine.extend_frontier(jnp.asarray(x0), jsr)
    tx = t_engine.extend_frontier(x0, tsr, "cpu")
    return (jsr, js, j_update, jx), (tsr, ts, t_update, tx)


@pytest.mark.parametrize("tag", [ADD_CONST, ADD_TABLE, MIN_OLD])
@pytest.mark.parametrize("mode,delta", [("sync", None), ("async", None), ("delayed", 48)])
def test_fused_round_bit_identical_to_pallas(tag, mode, delta):
    (jsr, js, j_update, jx), (tsr, ts, t_update, tx) = _case(tag, delta, mode)
    out_pallas = np.asarray(j_ops.fused_round(jx, js, jsr, j_update, interpret=True))
    out_port = ops.fused_round(tx, ts, tsr, t_update)
    np.testing.assert_array_equal(out_pallas[:-1], out_port.numpy()[:-1])
    assert torch.equal(tx, t_engine.extend_frontier(np.asarray(jx)[:-1], tsr, "cpu"))


def test_fused_round_is_gauss_seidel_not_jacobi():
    """With S > 1 the fused round differs from running every commit step
    against the round-start frontier (test_kernels.py's check, on the port)."""
    _, (tsr, ts, update, x) = _case(ADD_CONST, 32, "delayed")
    assert ts.S > 1
    out_gs = ops.fused_round(x, ts, tsr, update)
    x_j = x.clone()
    for s in range(ts.S):
        one = dataclasses.replace(
            ts,
            S=1,
            src=ts.src[s : s + 1],
            val=ts.val[s : s + 1],
            dst_local=ts.dst_local[s : s + 1],
            rows=ts.rows[s : s + 1],
            row_ptr=ts.row_ptr[s : s + 1],
        )
        rows = ts.rows[s].reshape(-1)
        x_j[rows] = ops.fused_round(x, one, tsr, update)[rows]
    assert (out_gs[:-1] - x_j[:-1]).abs().max().item() > 1e-6


def test_plain_version_is_the_engine_round():
    _, (tsr, ts, update, x) = _case(MIN_OLD, 40, "delayed")
    assert torch.equal(
        ref.fused_round_ref(x, ts, tsr, update)[:-1],
        t_engine.round_fn(ts, tsr, update)(x)[:-1],
    )


def test_plain_row_update_runs_on_cpu_only():
    """A row update with no epilogue tag runs in the plain round; the CUDA
    wrapper refuses it before touching any device."""
    _, (tsr, ts, _, x) = _case(ADD_CONST, 48, "delayed")
    plain = lambda old, red, rows: red * 2
    out = ops.fused_round(x, ts, tsr, plain)
    assert out.shape == x.shape
    with pytest.raises(TypeError, match="Epilogue"):
        _check_args(x, ts, tsr, plain)


def test_cuda_wrapper_rejects_cpu_tensors():
    _, (tsr, ts, update, x) = _case(ADD_CONST, 48, "delayed")
    launches = fused_round_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_round_cuda(x, ts, tsr, update)
    assert fused_round_cuda.launches == launches


def test_fused_round_refuses_other_devices():
    _, (tsr, ts, update, x) = _case(ADD_CONST, 48, "delayed")
    with pytest.raises(ValueError, match="no fused round"):
        ops.fused_round(x.to("meta"), ts, tsr, update)


@pytest.mark.parametrize(
    "tag,kw,err",
    [
        ("fma", {}, "unknown epilogue"),
        (ADD_TABLE, {}, "needs a table"),
        (ADD_CONST, {"table": torch.zeros(3)}, "needs a table"),
    ],
)
def test_epilogue_validates_its_fields(tag, kw, err):
    with pytest.raises(ValueError, match=err):
        Epilogue(tag, **kw)


def test_epilogues_compute_the_reference_row_updates():
    rng = np.random.default_rng(7)
    old_f, red_f = rng.random((2, 4, 8)).astype(np.float32)
    old_i, red_i = rng.integers(0, 100, (2, 4, 8)).astype(np.int32)
    rows = rng.integers(0, 21, (4, 8)).astype(np.int32)
    rows[0, :3] = 20  # dump rows
    table = rng.random(21).astype(np.float32)
    c = np.float32(0.15 / 20)
    t = torch.as_tensor
    cases = [
        (Epilogue(ADD_CONST, const=float(c)), old_f, red_f, c + jnp.asarray(red_f)),
        (
            Epilogue(ADD_TABLE, table=t(table)),
            old_f,
            red_f,
            jnp.asarray(table)[rows] + red_f,
        ),
        (Epilogue(MIN_OLD), old_i, red_i, jnp.minimum(old_i, red_i)),
    ]
    for ep, old, red, want in cases:
        got = ep(t(old), t(red), t(rows)).numpy()
        np.testing.assert_array_equal(np.asarray(want), got)
        assert got.dtype == old.dtype


def test_nvcc_command_targets_hopper_without_contraction():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    flags = " ".join(build.NVCC_FLAGS)
    for want in ("arch=compute_90a,code=sm_90a", "-O3", "--fmad=false", "-shared"):
        assert want in flags
    lib = build.library_path("round_block")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libround_block-")
    gitignore = (build.BUILD_DIR.parents[1] / ".gitignore").read_text().split()
    assert "build/" in gitignore
