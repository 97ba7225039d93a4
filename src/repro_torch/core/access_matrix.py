"""Worker-to-worker access instrumentation (paper Fig 5).

A numpy copy of ``repro.core.access_matrix``.

For a given partition, counts how many reads worker ``r`` (owner of the
destination vertex) makes into vertex data owned by worker ``o`` (owner of the
source vertex) in one pull round.  The paper uses the resulting P×P matrix to
explain *when delaying helps*: diagonal-clustered topologies (Web) consume
their own updates and gain nothing from buffering.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import CSRGraph
from repro_torch.graphs.partition import Partition

__all__ = [
    "access_matrix",
    "locality_fraction",
    "partition_report",
    "remote_read_fraction",
]


def _bounds_of(block_bounds) -> np.ndarray:
    if isinstance(block_bounds, Partition):
        return block_bounds.bounds
    return np.asarray(block_bounds)


def access_matrix(graph: CSRGraph, block_bounds) -> np.ndarray:
    """P×P matrix: ``A[r, o]`` = reads by worker r of worker o's data.

    ``block_bounds`` is a (P + 1,) bounds array or a :class:`Partition`.
    """
    bounds = _bounds_of(block_bounds)
    P = bounds.shape[0] - 1
    # owner of each vertex id (contiguous blocks → searchsorted)
    dst_of_edge = np.repeat(np.arange(graph.n, dtype=np.int64), np.diff(graph.indptr))
    r = np.searchsorted(bounds, dst_of_edge, side="right") - 1
    o = np.searchsorted(bounds, graph.indices.astype(np.int64), side="right") - 1
    mat = np.zeros((P, P), dtype=np.int64)
    np.add.at(mat, (r, o), 1)
    return mat


def locality_fraction(mat: np.ndarray) -> float:
    """Fraction of reads that hit the reader's own block (diagonal mass)."""
    total = mat.sum()
    return float(np.trace(mat) / total) if total else 0.0


def remote_read_fraction(mat: np.ndarray) -> float:
    """Fraction of reads crossing shards — the edge-cut mass the halo pays."""
    return 1.0 - locality_fraction(mat)


def partition_report(
    graph: CSRGraph, partition: Partition, mat: np.ndarray | None = None
) -> dict:
    """Fig-5 locality numbers + the halo/cut stats of the same partition.

    ``off_diagonal_reads`` from the access matrix equals ``partition.edge_cut``
    by construction (each edge is one read) — asserted here so the two
    instrumentation paths can never drift apart.  Pass a precomputed ``mat``
    (from :func:`access_matrix` on the same partition) to skip the edge scan.
    """
    if mat is None:
        mat = access_matrix(graph, partition)
    off_diag = int(mat.sum() - np.trace(mat))
    assert off_diag == partition.edge_cut, (off_diag, partition.edge_cut)
    report = {
        "locality_fraction": round(locality_fraction(mat), 4),
        "remote_read_fraction": round(remote_read_fraction(mat), 4),
    }
    report.update(partition.stats())
    return report
