"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

A package of its own beside the JAX reference ``repro``: it imports ``torch``
and numpy, never ``jax``, and nothing of ``repro``.  Its modules mirror
``repro``'s (``repro_torch/core/engine.py`` ↔ ``repro/core/engine.py``, and so
on).  Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from repro_torch.algorithms import (
    connected_components,
    jacobi_graph,
    jacobi_solve,
    pagerank,
    sssp,
)
from repro_torch.evolve import EdgeBatch, UpdateReport
from repro_torch.solve import (
    Problem,
    Solver,
    cc_problem,
    jacobi_problem,
    label_propagation_problem,
    pagerank_problem,
    ppr_problem,
    rwr_embedding_problem,
    sssp_problem,
)

__all__ = [
    "EdgeBatch",
    "Problem",
    "Solver",
    "UpdateReport",
    "cc_problem",
    "connected_components",
    "jacobi_graph",
    "jacobi_problem",
    "jacobi_solve",
    "label_propagation_problem",
    "pagerank",
    "pagerank_problem",
    "ppr_problem",
    "rwr_embedding_problem",
    "sssp",
    "sssp_problem",
]
