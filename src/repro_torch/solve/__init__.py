# The single-device Problem/Solver API of the port (counterpart of repro.solve).
from repro_torch.solve.batch import BatchResult, BatchStepper, RetiredQuery, solve_batch
from repro_torch.solve.problem import (
    Problem,
    cc_problem,
    count_changed_residual,
    default_landmarks,
    jacobi_problem,
    l1_residual,
    label_propagation_problem,
    labelprop_anchors,
    multi_source_x0,
    pagerank_problem,
    ppr_problem,
    ppr_teleport,
    rwr_embedding_problem,
    rwr_restart,
    sssp_problem,
)
from repro_torch.solve.solver import BACKENDS, Solver

__all__ = [
    "BACKENDS",
    "BatchResult",
    "BatchStepper",
    "Problem",
    "RetiredQuery",
    "Solver",
    "cc_problem",
    "count_changed_residual",
    "default_landmarks",
    "jacobi_problem",
    "l1_residual",
    "label_propagation_problem",
    "labelprop_anchors",
    "multi_source_x0",
    "pagerank_problem",
    "ppr_problem",
    "ppr_teleport",
    "rwr_embedding_problem",
    "rwr_restart",
    "solve_batch",
    "sssp_problem",
]
