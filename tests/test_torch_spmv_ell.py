"""K3, the ELL SpMV of the port, against the reference's Pallas kernel.

On the CPU, ``repro_torch.kernels.ops.spmv`` runs K3's plain version, which
sums column by column in order (the kernel's order on the card).  It must
equal ``repro.kernels.spmv_ell.spmv_ell`` in interpret mode exactly for
min-plus and within ``rtol=1e-5`` for plus-times: the reference's own gate
(``tests/test_kernels.py``), because XLA's ``jnp.sum`` over a row does not
add in column order.  The ELL layout builder must give the reference's
arrays for any ``rows_slice`` and ``lane_pad``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.graphs import generators as j_gen  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.spmv_ell import spmv_ell  # noqa: E402
from repro_torch.core.semiring import INT_INF  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.spmv_ell import spmv_ell_cuda  # noqa: E402


def _ell(rng, rows, max_deg, n_slots, dtype, pad_val):
    idx = rng.integers(0, n_slots - 1, (rows, max_deg)).astype(np.int32)
    if dtype == np.float32:
        val = (rng.random((rows, max_deg)) * 0.1).astype(dtype)
    else:
        val = rng.integers(1, 200, (rows, max_deg)).astype(dtype)
    val[rng.random((rows, max_deg)) < 0.3] = pad_val  # padding entries
    return idx, val


def _pallas(x, idx, val, semiring):
    rows = idx.shape[0]
    out = spmv_ell(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(val),
        semiring=semiring, row_tile=min(8, rows), interpret=True,
    )
    return np.asarray(out)


def _port(x, idx, val, semiring):
    t = torch.as_tensor
    return ops.spmv(t(x), t(idx), t(val), semiring).numpy()


@pytest.mark.parametrize("F", [None, 4])
@pytest.mark.parametrize("rows", [8, 64, 256])
@pytest.mark.parametrize("max_deg", [1, 7, 128])
def test_spmv_plus_times_matches_pallas(rows, max_deg, F):
    rng = np.random.default_rng(rows * 1000 + max_deg)
    n = 500
    idx, val = _ell(rng, rows, max_deg, n, np.float32, 0.0)
    x = rng.random((n + 1,) if F is None else (n + 1, F)).astype(np.float32)
    got = _port(x, idx, val, "plus_times")
    assert got.shape == (rows,) + x.shape[1:] and got.dtype == np.float32
    np.testing.assert_allclose(got, _pallas(x, idx, val, "plus_times"), rtol=1e-5)


@pytest.mark.parametrize("F", [None, 4])
@pytest.mark.parametrize("rows", [8, 128])
@pytest.mark.parametrize("max_deg", [3, 64])
def test_spmv_min_plus_matches_pallas_exactly(rows, max_deg, F):
    rng = np.random.default_rng(rows * 1000 + max_deg + 1)
    n = 300
    idx, val = _ell(rng, rows, max_deg, n, np.int32, INT_INF)
    x = rng.integers(0, 1000, (n + 1,) if F is None else (n + 1, F)).astype(np.int32)
    x[rng.random(x.shape) < 0.5] = INT_INF
    got = _port(x, idx, val, "min_plus")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _pallas(x, idx, val, "min_plus"))


def test_plus_times_sums_columns_in_order():
    """The plain version is the kernel's order: a running f32 sum over j."""
    rng = np.random.default_rng(5)
    idx, val = _ell(rng, 16, 9, 40, np.float32, 0.0)
    x = rng.random(41).astype(np.float32)
    want = np.zeros(16, np.float32)
    for j in range(9):
        want = want + x[idx[:, j]] * val[:, j]
    np.testing.assert_array_equal(_port(x, idx, val, "plus_times"), want)


def _graph_pair(name, kind, scale=9):
    kw = {} if name == "road" else {"efactor": 8}
    return (
        j_gen.make_graph(name, scale=scale, kind=kind, **kw),
        t_gen.make_graph(name, scale=scale, kind=kind, **kw),
    )


@pytest.mark.parametrize("name,kind", [("web", "pagerank"), ("kron", "sssp"), ("road", "unit")])
@pytest.mark.parametrize("chunk_rows", [1 << 18, 37])
def test_ell_from_csr_equals_reference(name, kind, chunk_rows, monkeypatch):
    monkeypatch.setattr(ops, "ELL_CHUNK_ROWS", chunk_rows)
    jg, tg = _graph_pair(name, kind)
    j_idx, j_val = j_ops.ell_from_csr(jg)
    t_idx, t_val = ops.ell_from_csr(tg)
    for want, got in ((j_idx, t_idx), (j_val, t_val)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lane_pad", [8, 32, 128])
@pytest.mark.parametrize("rows", ["all", "range", "permuted"])
@pytest.mark.parametrize("name,kind", [("web", "pagerank"), ("kron", "sssp"), ("road", "unit")])
@pytest.mark.parametrize("chunk_rows", [1 << 18, 37])
def test_ell_from_csr_rows_and_lane_pad_equal_reference(name, kind, chunk_rows, rows, lane_pad, monkeypatch):
    monkeypatch.setattr(ops, "ELL_CHUNK_ROWS", chunk_rows)
    jg, tg = _graph_pair(name, kind)
    n = tg.n
    rows_slice = {
        "all": None,
        "range": np.arange(n // 5, n // 2),
        "permuted": np.random.default_rng(n).permutation(n)[: n // 3],
    }[rows]
    j_idx, j_val = j_ops.ell_from_csr(jg, rows_slice, lane_pad=lane_pad)
    t_idx, t_val = ops.ell_from_csr(tg, rows_slice, lane_pad=lane_pad)
    assert t_idx.shape[1] % lane_pad == 0
    for want, got in ((j_idx, t_idx), (j_val, t_val)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("F", [None, 4])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_spmv_equal_on_lane_pad_8_and_128_layouts(semiring, F):
    """Extra ⊕-identity padding is idempotent: the narrow and the reference
    layout of one graph give the same bits, although every row is padded in
    both (the longest row, 30, is not a multiple of 8)."""
    g = t_gen.make_graph("urand", scale=9, efactor=8, kind="sssp" if semiring == "min_plus" else "pagerank")
    assert int(np.diff(g.indptr).max()) % 8 != 0
    narrow, wide = ops.ell_from_csr(g, lane_pad=8), ops.ell_from_csr(g, lane_pad=128)
    assert narrow[0].shape[1] < wide[0].shape[1]
    rng = np.random.default_rng(8)
    shape = (g.n + 1,) if F is None else (g.n + 1, F)
    if semiring == "min_plus":
        x = rng.integers(0, 1000, shape).astype(np.int32)
        x[rng.random(shape) < 0.3] = INT_INF
    else:  # over many binades, so any change to a sum would show in its bits
        x = (rng.random(shape) * np.exp2(rng.integers(-20, 20, shape))).astype(np.float32)
    got_narrow, got_wide = _port(x, *narrow, semiring), _port(x, *wide, semiring)
    assert got_narrow.dtype == got_wide.dtype
    np.testing.assert_array_equal(got_narrow.view(np.int32), got_wide.view(np.int32))


def test_spmv_on_real_graph_matches_pallas():
    g_j = j_gen.make_graph("kron", scale=9, efactor=8, kind="sssp")
    g_t = t_gen.make_graph("kron", scale=9, efactor=8, kind="sssp")
    idx, val = ops.ell_from_csr(g_t)
    rng = np.random.default_rng(6)
    x = rng.integers(0, 1000, g_t.n + 1).astype(np.int32)
    j_idx, j_val = j_ops.ell_from_csr(g_j)
    pad = (-len(idx)) % 8
    want = _pallas(x, np.pad(j_idx, ((0, pad), (0, 0))), np.pad(j_val, ((0, pad), (0, 0)), constant_values=INT_INF), "min_plus")
    np.testing.assert_array_equal(_port(x, idx, val, "min_plus"), want[: len(idx)])


def test_cuda_wrapper_checks_before_launching():
    rng = np.random.default_rng(7)
    idx, val = _ell(rng, 8, 4, 20, np.float32, 0.0)
    x = torch.as_tensor(rng.random(21).astype(np.float32))
    launches = spmv_ell_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmv_ell_cuda(x, torch.as_tensor(idx), torch.as_tensor(val))
    with pytest.raises(ValueError, match="semiring must be one of"):
        spmv_ell_cuda(x, torch.as_tensor(idx), torch.as_tensor(val), "max_times")
    with pytest.raises(ValueError, match="no spmv"):
        ops.spmv(x.to("meta"), torch.as_tensor(idx), torch.as_tensor(val))
    assert spmv_ell_cuda.launches == launches
