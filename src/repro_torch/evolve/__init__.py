"""Incremental solving on evolving graphs (the port of ``repro.evolve``).

Two layers, each living with the machinery it extends, re-exported here as
one façade:

1. **mutation** — :class:`~repro_torch.graphs.updates.EdgeBatch` +
   ``CSRGraph.apply_updates``: typed insert/delete/reweight batches applied
   incrementally, reporting the affected-vertex frontier;
   ``Solver.apply_updates`` rebuilds only the touched workers' stripes of
   each cached schedule on the device;
2. **restart** — :mod:`repro_torch.evolve.restart`: repair the previous fixed
   point into a valid warm state (passed through for plus-times, monotone
   repair with the deletion cone re-raised for min-plus), consumed by
   ``Solver.resolve(updates=...)``.
"""

from repro_torch.evolve.restart import (
    minplus_certificate_repair,
    minplus_cone_repair,
    warm_start_state,
)
from repro_torch.graphs.updates import EdgeBatch, UpdateReport, apply_edge_batch

__all__ = [
    "EdgeBatch",
    "UpdateReport",
    "apply_edge_batch",
    "minplus_certificate_repair",
    "minplus_cone_repair",
    "warm_start_state",
]
