"""Connected components via min-label propagation on the delayed-async engine.

min-plus semiring with all-zero edge weights: the reduction is simply
``min over in-neighbour labels``; ``row_update`` keeps the vertex's own label
in the running min.  Converges when no label changes (same criterion family
as SSSP — the two share one kernel pair in :mod:`repro_torch.solve.problem`).
Intended for symmetric graphs.

The problem spec lives in :func:`repro_torch.solve.cc_problem` (its
``edge_values`` hook zeroes the weights, so callers pass the graph as-is);
this wrapper is sugar over :class:`repro_torch.solve.Solver`.
"""

from __future__ import annotations

from repro_torch.core.engine import MIN_CHUNK, EngineResult
from repro_torch.graphs.formats import CSRGraph
from repro_torch.solve import Solver, cc_problem

__all__ = ["connected_components", "cc_problem"]


def connected_components(
    graph: CSRGraph,
    P: int = 8,
    delta="auto",
    max_rounds: int = 10_000,
    min_chunk: int | None = None,
    backend: str | None = None,
    device=None,
) -> EngineResult:
    """Label propagation with ``P`` workers and commit period ``delta``."""
    solver = Solver(
        graph,
        cc_problem(max_rounds=max_rounds),
        n_workers=P,
        delta=delta,
        backend=backend or "kernel",
        min_chunk=MIN_CHUNK if min_chunk is None else min_chunk,
        device=device,
    )
    return solver.solve()
