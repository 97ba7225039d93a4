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
    "PARTITION_METHODS",
    "balanced_blocks",
    "equal_blocks",
    "greedy_degree_blocks",
    "make_partition",
    "refine_blocks",
]


def equal_blocks(n: int, P: int) -> np.ndarray:
    """Equal vertex-count contiguous blocks: bounds of shape (P + 1,)."""
    return np.linspace(0, n, P + 1).astype(np.int64)


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


def greedy_degree_blocks(graph: CSRGraph, P: int, alpha: float = 0.5) -> np.ndarray:
    """Degree-aware greedy contiguous blocks: bounds of shape (P + 1,).

    Balances per-vertex cost ``in_degree + alpha · out_degree`` — in-degree is
    the pull-update compute a block owns, out-degree is how often its values
    are read (and therefore shipped) by other blocks.  Unlike
    :func:`balanced_blocks`' fixed prefix targets, each cut re-targets the
    *remaining* cost over the *remaining* blocks, so one hub vertex inflates
    only its own block instead of skewing every later cut.
    """
    if not 0 <= alpha:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    cost = graph.in_degree.astype(np.float64) + alpha * graph.out_degree
    cum = np.concatenate([[0.0], np.cumsum(cost)])
    bounds = np.zeros(P + 1, dtype=np.int64)
    bounds[P] = graph.n
    lo = 0
    for p in range(1, P):
        remaining = cum[-1] - cum[lo]
        target = cum[lo] + remaining / (P - p + 1)
        # first cut whose prefix cost reaches the adaptive target, keeping at
        # least the empty block (lo) admissible for degenerate graphs
        cut = int(np.searchsorted(cum, target, side="left"))
        bounds[p] = min(max(cut, lo), graph.n)
        lo = bounds[p]
    return np.maximum.accumulate(bounds)


def refine_blocks(
    graph: CSRGraph, P: int, alpha: float = 0.5, passes: int = 4
) -> np.ndarray:
    """Boundary-refined contiguous blocks: bounds of shape (P + 1,).

    Seeds with :func:`greedy_degree_blocks`, then runs Fiduccia–Mattheyses-
    style single-vertex moves restricted to the contiguous layout: each cut
    point may shift by one vertex at a time (the boundary vertex changes
    block), accepted only when the move *strictly* reduces the directed edge
    cut.  The gain of moving ``v`` from block A to adjacent block B is
    ``|neighbors(v) ∩ A| − |neighbors(v) ∩ B|`` over in- and out-edges
    (self-loops excluded): edges into the abandoned block become cut, edges
    into the destination block heal.  Strict improvement guarantees both
    termination (each move is −1 cut edge at least) and the invariant the
    tests pin: **edge cut ≤ the greedy_degree seed's**.  Per pass, each cut
    point walks at most a quarter of its span so one hub cannot drag a
    boundary across the whole graph; blocks never shrink below one vertex
    (empty seed blocks stay empty).
    """
    bounds = np.array(greedy_degree_blocks(graph, P, alpha), dtype=np.int64)
    if graph.n == 0 or P <= 1:
        return bounds
    indptr = graph.indptr
    in_nbrs = graph.indices.astype(np.int64)
    # Reverse adjacency (out-edges), built once: edge e is (indices[e] →
    # dst_of_edge[e]); stable-sorting by source groups each vertex's outs.
    dst_of_edge = np.repeat(np.arange(graph.n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(in_nbrs, kind="stable")
    out_nbrs = dst_of_edge[order]
    out_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(in_nbrs, minlength=graph.n))]
    ).astype(np.int64)

    def neighbors(v: int) -> np.ndarray:
        nb = np.concatenate(
            [
                in_nbrs[indptr[v] : indptr[v + 1]],
                out_nbrs[out_ptr[v] : out_ptr[v + 1]],
            ]
        )
        return nb[nb != v]

    def count_in(nb: np.ndarray, lo: int, hi: int) -> int:
        return int(np.count_nonzero((nb >= lo) & (nb < hi)))

    for _ in range(max(passes, 0)):
        improved = False
        for p in range(1, P):
            max_shift = max(1, int(bounds[p + 1] - bounds[p - 1]) // 4)
            for _ in range(max_shift):
                b = int(bounds[p])
                moved = False
                if b - bounds[p - 1] >= 2:  # v = b−1 leaves block p−1 for p
                    nb = neighbors(b - 1)
                    gain = count_in(nb, int(bounds[p - 1]), b - 1) - count_in(
                        nb, b, int(bounds[p + 1])
                    )
                    if gain < 0:
                        bounds[p] = b - 1
                        improved = moved = True
                if not moved and bounds[p + 1] - b >= 2:  # v = b joins p−1
                    nb = neighbors(b)
                    gain = count_in(nb, b, int(bounds[p + 1])) - count_in(
                        nb, int(bounds[p - 1]), b
                    )
                    if gain < 0:
                        bounds[p] = b + 1
                        improved = moved = True
                if not moved:
                    break
        if not improved:
            break
    return bounds


PARTITION_METHODS = {
    "equal": lambda g, P: equal_blocks(g.n, P),
    "balanced": balanced_blocks,
    "greedy_degree": greedy_degree_blocks,
    "refine": refine_blocks,
}


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


def make_partition(
    graph: CSRGraph, P: int, method: str = "balanced", **kwargs
) -> Partition:
    """Build a :class:`Partition` with one of :data:`PARTITION_METHODS`."""
    try:
        blocks = PARTITION_METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown partition method {method!r}; "
            f"choose from {sorted(PARTITION_METHODS)}"
        ) from None
    return Partition.from_bounds(graph, blocks(graph, P, **kwargs))
