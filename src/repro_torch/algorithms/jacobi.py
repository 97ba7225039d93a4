"""Jacobi / block Gauss-Seidel linear solver on the delayed-async engine.

Demonstrates that the engine generalises beyond the paper's two workloads to
any fixed-point iteration ``x' = M x + c`` (here: solving ``A x = b`` for
diagonally dominant ``A`` via the splitting ``x'_i = (b_i − Σ_{j≠i} A_ij x_j)
/ A_ii``).  δ interpolates Jacobi (sync) → Gauss-Seidel (async), which is the
numerical-analysis view of the paper's hybrid (§II-A cites exactly this
Jacobi/Gauss-Seidel contrast for PageRank).

The problem spec lives in :func:`repro_torch.solve.jacobi_problem`;
:func:`jacobi_graph` builds the pull-formulation graph from the COO matrix,
and this wrapper is sugar over :class:`repro_torch.solve.Solver`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import MIN_CHUNK, EngineResult
from repro_torch.graphs.formats import CSRGraph
from repro_torch.solve import Solver, jacobi_problem

__all__ = ["jacobi_solve", "jacobi_graph", "jacobi_problem"]


def jacobi_graph(
    n: int,
    offdiag_rows: np.ndarray,
    offdiag_cols: np.ndarray,
    offdiag_vals: np.ndarray,
    diag: np.ndarray,
) -> CSRGraph:
    """Pull formulation of the Jacobi splitting: edge ``(col -> row)`` with
    value ``-A_ij / A_ii``."""
    values = (-offdiag_vals / diag[offdiag_rows]).astype(np.float32)
    return CSRGraph.from_edges(
        n, src=offdiag_cols, dst=offdiag_rows, values=values, name="jacobi", dedup=False
    )


def jacobi_solve(
    n: int,
    offdiag_rows: np.ndarray,
    offdiag_cols: np.ndarray,
    offdiag_vals: np.ndarray,
    diag: np.ndarray,
    b: np.ndarray,
    P: int = 8,
    delta="auto",
    tol: float = 1e-6,
    max_rounds: int = 5000,
    min_chunk: int | None = None,
    backend: str | None = None,
    device=None,
) -> EngineResult:
    """Solve ``A x = b``; A given as off-diagonal COO + diagonal vector."""
    graph = jacobi_graph(n, offdiag_rows, offdiag_cols, offdiag_vals, diag)
    solver = Solver(
        graph,
        jacobi_problem(diag, b, tol=tol, max_rounds=max_rounds),
        n_workers=P,
        delta=delta,
        backend=backend or "kernel",
        min_chunk=MIN_CHUNK if min_chunk is None else min_chunk,
        device=device,
    )
    return solver.solve()
