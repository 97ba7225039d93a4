"""The port's algorithm wrappers against ``repro.algorithms``.

The same numpy inputs go through ``repro.algorithms`` (``backend="jit"``) and
``repro_torch.algorithms`` on the CPU (``device="cpu"``; the default
backend, ``"kernel"``, runs the plain loop there, and ``"torch"`` too):
pagerank, sssp, connected_components and jacobi_solve at sync, async, an
integer δ and ``"auto"``, with x bit for bit and rounds, converged,
flushes and flush_bytes exactly; ``jacobi_graph`` array for array.  The
wrappers' CUDA default refuses to run without a card.  ``examples/
quickstart_torch.py`` runs at a tiny scale on the CPU, and the new modules
import neither jax nor ``repro``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import algorithms as j_alg  # noqa: E402
from repro.graphs import formats as j_formats  # noqa: E402
from repro.graphs import generators as j_gen  # noqa: E402
from repro_torch import algorithms as t_alg  # noqa: E402
from repro_torch.graphs import formats as t_formats  # noqa: E402
from repro_torch.graphs import generators as t_gen  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
P, MIN_CHUNK = 4, 16
DELTAS = ["sync", "async", 48, "auto"]


def _assert_same(jr, tr):
    assert (tr.rounds, tr.converged, tr.flushes, tr.flush_bytes, tr.delta, tr.P) == (
        jr.rounds, jr.converged, jr.flushes, jr.flush_bytes, jr.delta, jr.P
    )
    assert tr.converged
    np.testing.assert_array_equal(tr.x, np.asarray(jr.x))


def _graphs(graph, kind, scale=9):
    return (
        j_gen.make_graph(graph, scale=scale, efactor=8, kind=kind),
        t_gen.make_graph(graph, scale=scale, efactor=8, kind=kind),
    )


def _jacobi_system(n=300, seed=4):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 4)
    cols = (rows + rng.integers(1, n, rows.shape[0])) % n
    vals = (rng.normal(size=rows.shape[0]) * 0.15).astype(np.float32)
    diag = np.full(n, 4.0, np.float32)
    b = rng.normal(size=n).astype(np.float32)
    return n, rows, cols, vals, diag, b


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("delta", DELTAS)
def test_pagerank_matches_reference(delta, backend):
    jg, tg = _graphs("twitter", "pagerank")
    jr = j_alg.pagerank(jg, P=P, delta=delta, min_chunk=MIN_CHUNK, backend="jit")
    tr = t_alg.pagerank(tg, P=P, delta=delta, min_chunk=MIN_CHUNK, backend=backend, device="cpu")
    _assert_same(jr, tr)


@pytest.mark.parametrize("delta", DELTAS)
def test_sssp_matches_reference(delta):
    jg, tg = _graphs("kron", "sssp")
    source = int(np.argmax(jg.out_degree))
    jr = j_alg.sssp(jg, source=source, P=P, delta=delta, min_chunk=MIN_CHUNK, backend="jit")
    tr = t_alg.sssp(tg, source=source, P=P, delta=delta, min_chunk=MIN_CHUNK, device="cpu")
    _assert_same(jr, tr)


@pytest.mark.parametrize("delta", DELTAS)
def test_connected_components_matches_reference(delta):
    jg = j_gen.make_graph("road", scale=9, kind="unit")
    tg = t_gen.make_graph("road", scale=9, kind="unit")
    jr = j_alg.connected_components(jg, P=P, delta=delta, min_chunk=MIN_CHUNK, backend="jit")
    tr = t_alg.connected_components(tg, P=P, delta=delta, min_chunk=MIN_CHUNK, device="cpu")
    _assert_same(jr, tr)
    assert len(np.unique(tr.x)) == 1


def test_connected_components_two_components():
    src, dst = np.array([0, 1, 2, 3, 4, 5]), np.array([1, 0, 3, 2, 5, 4])
    jg = j_formats.CSRGraph.from_edges(6, src, dst, np.zeros(6, np.int32))
    tg = t_formats.CSRGraph.from_edges(6, src, dst, np.zeros(6, np.int32))
    jr = j_alg.connected_components(jg, P=2, delta="async", min_chunk=2, backend="jit")
    tr = t_alg.connected_components(tg, P=2, delta="async", min_chunk=2, device="cpu")
    _assert_same(jr, tr)
    assert len(np.unique(tr.x)) == 3


@pytest.mark.parametrize("delta", DELTAS)
def test_jacobi_solve_matches_reference(delta):
    system = _jacobi_system()
    kw = dict(P=P, delta=delta, min_chunk=MIN_CHUNK, tol=1e-6)
    jr = j_alg.jacobi_solve(*system, backend="jit", **kw)
    tr = t_alg.jacobi_solve(*system, device="cpu", **kw)
    _assert_same(jr, tr)
    n, rows, cols, vals, diag, b = system
    A = np.zeros((n, n), np.float64)
    np.add.at(A, (rows, cols), vals)
    np.fill_diagonal(A, diag)
    assert np.abs(tr.x - np.linalg.solve(A, b)).max() < 1e-4


def test_jacobi_graph_matches_reference():
    n, rows, cols, vals, diag, _ = _jacobi_system()
    jg = j_alg.jacobi_graph(n, rows, cols, vals, diag)
    tg = t_alg.jacobi_graph(n, rows, cols, vals, diag)
    assert (tg.n, tg.name) == (jg.n, jg.name)
    for field in ("indptr", "indices", "values"):
        a, b = getattr(tg, field), getattr(jg, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_wrappers_default_to_the_card():
    """The default backend is "kernel" on CUDA: without a card a wrapper
    refuses, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the wrappers would run on it")
    _, tg = _graphs("kron", "sssp", scale=6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_alg.sssp(tg, P=2, delta="sync")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_alg.pagerank(tg.with_values(np.full(tg.nnz, 0.1, np.float32)), P=2, delta="sync")


def test_quickstart_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "quickstart_torch.py"), "--scale", "8", "--workers", "4",
         "--device", "cpu"],
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "same distances" in out.stdout and "patched in place" in out.stdout


def test_new_modules_import_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.algorithms, repro_torch.evolve, "
        "repro_torch.evolve.restart, repro_torch.graphs.updates, repro_torch.core.delta_model, "
        "repro_torch.solve.solver\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
