"""Bellman-Ford SSSP on the delayed-async engine (paper §IV-D).

min-plus pull relaxation with 32-bit integer distances (as in the paper):

``x'[u] = min(x[u], min_{v ∈ in(u)} x[v] + w(v, u))``

Stopping criterion per the paper: no update generated in the last round.

The problem spec lives in :func:`repro_torch.solve.sssp_problem` (the min-label
kernel is shared with connected components); this wrapper is back-compat
sugar over :class:`repro_torch.solve.Solver`.  For multi-source SSSP in one
lowering, use ``solver.solve_batch(multi_source_x0(graph, sources))``.
"""

from __future__ import annotations

from repro_torch.core.engine import MIN_CHUNK, EngineResult
from repro_torch.graphs.formats import CSRGraph
from repro_torch.solve import Solver, sssp_problem

__all__ = ["sssp", "sssp_problem"]


def sssp(
    graph: CSRGraph,
    source: int = 0,
    P: int = 8,
    delta="auto",
    max_rounds: int = 10_000,
    min_chunk: int | None = None,
    backend: str | None = None,
    device=None,
) -> EngineResult:
    """Bellman-Ford from ``source`` with ``P`` workers and commit period δ."""
    solver = Solver(
        graph,
        sssp_problem(source=source, max_rounds=max_rounds),
        n_workers=P,
        delta=delta,
        backend=backend or "kernel",
        min_chunk=MIN_CHUNK if min_chunk is None else min_chunk,
        device=device,
    )
    return solver.solve()
