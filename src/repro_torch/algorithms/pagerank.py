"""Pull-style PageRank on the delayed-async engine (paper §IV-A).

``x'[u] = (1 - d) / n + Σ_{v ∈ in(u)} x[v] · d / outdeg(v)``

Edge values hold ``d / outdeg(v)`` (precomputed by the graph generators), so
the semiring reduction yields the damped sum and ``row_update`` adds the
teleport term.  Convergence follows the paper: total absolute score change
across vertices ≤ 1e-4.

The problem spec lives in :func:`repro_torch.solve.pagerank_problem`; this wrapper
is sugar over :class:`repro_torch.solve.Solver`.  Pass
``delta='sync'|'async'|'auto'|<int>`` and
``backend='kernel'|'torch'`` to pick the schedule and execution path, and
``device='cpu'`` to run the plain rounds on the CPU.
"""

from __future__ import annotations

from repro_torch.core.engine import MIN_CHUNK, EngineResult
from repro_torch.graphs.formats import CSRGraph
from repro_torch.solve import Solver, pagerank_problem

__all__ = ["pagerank", "pagerank_problem"]


def pagerank(
    graph: CSRGraph,
    P: int = 8,
    delta="auto",
    damping: float = 0.85,
    tol: float = 1e-4,
    max_rounds: int = 1000,
    min_chunk: int | None = None,
    backend: str | None = None,
    device=None,
) -> EngineResult:
    """Run PageRank with ``P`` workers and commit period ``delta``."""
    solver = Solver(
        graph,
        pagerank_problem(damping=damping, tol=tol, max_rounds=max_rounds),
        n_workers=P,
        delta=delta,
        backend=backend or "kernel",
        min_chunk=MIN_CHUNK if min_chunk is None else min_chunk,
        device=device,
    )
    return solver.solve()
