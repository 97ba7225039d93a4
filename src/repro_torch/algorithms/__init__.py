# The algorithm wrappers of the port over its Solver (counterparts of
# repro.algorithms): each builds a Solver and solves once, on CUDA unless it
# is given device="cpu".  New code should use repro_torch.solve.Solver with
# the *_problem factories.
from repro_torch.algorithms.cc import cc_problem, connected_components
from repro_torch.algorithms.jacobi import jacobi_graph, jacobi_problem, jacobi_solve
from repro_torch.algorithms.pagerank import pagerank, pagerank_problem
from repro_torch.algorithms.sssp import sssp, sssp_problem

__all__ = [
    "pagerank",
    "pagerank_problem",
    "sssp",
    "sssp_problem",
    "connected_components",
    "cc_problem",
    "jacobi_solve",
    "jacobi_graph",
    "jacobi_problem",
]
