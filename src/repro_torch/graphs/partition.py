"""Static work partitioning (paper §III-A, "Blocked partitioning of work").

A numpy copy of ``repro.graphs.partition``, so the port imports nothing of
``repro``.

Vertices are assigned to workers in contiguous blocks by vertex id, sized so
the aggregate number of in-neighbours per worker is as balanced as possible.
The partition is static across all rounds, exactly as in the paper.

Beyond the raw block bounds, :class:`Partition` materializes everything the
distribution layer needs to go from a *replicated* frontier to an
*owner-computes* one: the owner map, local↔global index maps, per-shard halo
in/out sets (the cut-edge endpoints a shard reads from / publishes to remote
shards), and edge-cut statistics.  The reference's sharded engine builds
its per-commit-step halo-exchange plan on top of these sets; the Fig-5/Table-II
benchmarks report the same numbers to quantify the paper's "clustered on the
main diagonal" insight.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from repro_torch.graphs.formats import CSRGraph

__all__ = [
    "Partition",
    "balanced_blocks",
    "make_partition",
]


def balanced_blocks(graph: CSRGraph, P: int) -> np.ndarray:
    """Contiguous blocks balancing aggregate in-degree (paper's policy).

    Greedy prefix-sum split: cut points at multiples of nnz / P in the
    cumulative in-degree.  Returns bounds of shape (P + 1,).
    """
    cum = graph.indptr  # cumulative in-degree by construction
    total = cum[-1]
    targets = (np.arange(1, P) * total) // P
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [graph.n]]).astype(np.int64)
    # Guarantee monotonicity (degenerate graphs can collapse cuts).
    bounds = np.maximum.accumulate(bounds)
    return bounds


@dataclasses.dataclass(frozen=True)
class Partition:
    """A contiguous P-way vertex partition plus its distribution metadata.

    * ``bounds``   — (P + 1,) block bounds; shard ``p`` owns ``[bounds[p],
      bounds[p+1])``.
    * ``owner``    — (n,) int32 owner shard of every vertex.
    * ``halo_in``  — per shard, the sorted global ids of *remote* vertices the
      shard reads (sources of its cut in-edges).  These are the entries an
      owner-computes engine must receive at each commit.
    * ``halo_out`` — per shard, the sorted global ids of *owned* vertices some
      other shard reads — what the shard must publish beyond its boundary.
    * ``edge_cut`` — number of edges whose source owner ≠ destination owner.

    Local index layout of shard ``p`` (used by the frontier-sharded engine):
    slots ``[0, owned_p)`` hold the owned block in vertex order, slots
    ``[owned_p, owned_p + |halo_in[p]|)`` hold the halo copies in sorted
    global order.  :meth:`local_index` / :meth:`global_index` are inverse maps
    over exactly that layout.
    """

    n: int
    P: int
    bounds: np.ndarray  # (P + 1,) int64
    owner: np.ndarray  # (n,) int32
    halo_in: tuple  # P × sorted int64 arrays
    halo_out: tuple  # P × sorted int64 arrays
    edge_cut: int
    edges: int

    @staticmethod
    def from_bounds(graph: CSRGraph, bounds: np.ndarray) -> "Partition":
        """Materialize owner/halo/cut metadata for contiguous ``bounds``."""
        bounds = np.asarray(bounds, dtype=np.int64)
        P = bounds.shape[0] - 1
        assert bounds[0] == 0 and bounds[-1] == graph.n
        owner = np.searchsorted(bounds[1:], np.arange(graph.n), side="right").astype(
            np.int32
        )
        dst_of_edge = np.repeat(
            np.arange(graph.n, dtype=np.int64), np.diff(graph.indptr)
        )
        src = graph.indices.astype(np.int64)
        o_src = owner[src] if graph.n else np.zeros(0, np.int32)
        o_dst = owner[dst_of_edge] if graph.n else np.zeros(0, np.int32)
        cut = o_src != o_dst
        halo_in = tuple(np.unique(src[cut & (o_dst == p)]) for p in range(P))
        halo_out = tuple(np.unique(src[cut & (o_src == p)]) for p in range(P))
        return Partition(
            n=graph.n,
            P=P,
            bounds=bounds,
            owner=owner,
            halo_in=halo_in,
            halo_out=halo_out,
            edge_cut=int(cut.sum()),
            edges=graph.nnz,
        )

    # ------------------------------------------------------------------ #
    # Index maps
    # ------------------------------------------------------------------ #
    @cached_property
    def owned_sizes(self) -> np.ndarray:
        return np.diff(self.bounds)

    @cached_property
    def local_sizes(self) -> np.ndarray:
        """Owned + halo slots per shard (without padding/dump)."""
        return self.owned_sizes + np.array(
            [h.shape[0] for h in self.halo_in], dtype=np.int64
        )

    def global_index(self, p: int) -> np.ndarray:
        """Local slot → global vertex id for shard ``p`` (owned then halo)."""
        return np.concatenate(
            [np.arange(self.bounds[p], self.bounds[p + 1]), self.halo_in[p]]
        )

    def local_index(self, p: int, vertices: np.ndarray) -> np.ndarray:
        """Global vertex ids → shard-``p`` local slots (-1 if not resident)."""
        v = np.asarray(vertices, dtype=np.int64)
        lo, hi = self.bounds[p], self.bounds[p + 1]
        out = np.full(v.shape, -1, dtype=np.int64)
        owned = (v >= lo) & (v < hi)
        out[owned] = v[owned] - lo
        halo = self.halo_in[p]
        if halo.size:
            pos = np.searchsorted(halo, v)
            pos_c = np.minimum(pos, halo.size - 1)
            hit = ~owned & (halo[pos_c] == v)
            out[hit] = (hi - lo) + pos_c[hit]
        return out

    # ------------------------------------------------------------------ #
    # Stats
    # ------------------------------------------------------------------ #
    @property
    def cut_fraction(self) -> float:
        return self.edge_cut / max(self.edges, 1)

    @property
    def halo_total(self) -> int:
        """Total halo copies across shards (remote reads deduplicated)."""
        return int(sum(h.shape[0] for h in self.halo_in))

    @property
    def halo_max(self) -> int:
        return int(max((h.shape[0] for h in self.halo_in), default=0))

    @property
    def replication_factor(self) -> float:
        """Resident vertex copies / vertices (1.0 = no halo at all)."""
        return (self.n + self.halo_total) / max(self.n, 1)

    def stats(self) -> dict:
        return {
            "P": self.P,
            "edge_cut": self.edge_cut,
            "cut_fraction": round(self.cut_fraction, 4),
            "halo_total": self.halo_total,
            "halo_max": self.halo_max,
            "replication_factor": round(self.replication_factor, 4),
        }


def make_partition(graph: CSRGraph, P: int) -> Partition:
    """Build the :class:`Partition` of :func:`balanced_blocks`."""
    return Partition.from_bounds(graph, balanced_blocks(graph, P))
