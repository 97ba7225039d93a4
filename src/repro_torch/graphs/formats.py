"""Graph storage formats (numpy; a copy of ``repro.graphs.formats``).

The port keeps its own copy so that it imports nothing of ``repro``.

Two layouts:

* :class:`CSRGraph` — host-side (numpy) pull-oriented CSR: for each destination
  vertex ``u`` we store its *in*-neighbours ``v`` and per-edge values.  This is
  the canonical format produced by the generators and consumed by analysis
  tools (access matrices, partitioning).

* :class:`StripeSchedule` — the TPU execution layout.  The delayed-async
  engine processes vertices in ``S`` *commit steps* per round; commit step
  ``s`` covers chunk ``s`` (of size ``delta``) of every worker's block
  simultaneously (see DESIGN.md §5).  The schedule stores, for every
  ``(step, worker)`` cell, a padded edge list so each commit step is a single
  static-shape gather / segment-reduce / scatter.  Padding entries carry the
  semiring's annihilating edge value so they contribute the ⊕-identity.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = [
    "CSRGraph",
    "StripeSchedule",
    "assemble_stripe_schedule",
    "build_stripe_schedule",
    "build_worker_stripe",
]


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Pull-oriented CSR graph (host side, numpy).

    ``indptr[u] : indptr[u + 1]`` slices the in-edges of destination ``u``;
    ``indices`` holds the source vertex of each in-edge and ``values`` the
    edge value (e.g. ``1 / outdeg(src)`` for PageRank, a positive length for
    SSSP).
    """

    n: int
    indptr: np.ndarray  # (n + 1,) int64
    indices: np.ndarray  # (nnz,) int32 — source vertex per in-edge
    values: np.ndarray  # (nnz,) float32 or int32 — edge values
    name: str = "graph"

    # ------------------------------------------------------------------ #
    # Constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_edges(
        n: int,
        src: np.ndarray,
        dst: np.ndarray,
        values: np.ndarray | None = None,
        name: str = "graph",
        dedup: bool = True,
    ) -> "CSRGraph":
        """Build pull-CSR from a directed edge list ``src -> dst``."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if values is None:
            values = np.ones(src.shape[0], dtype=np.float32)
        values = np.asarray(values)
        if dedup:
            key = dst * n + src
            order = np.argsort(key, kind="stable")
            key = key[order]
            keep = np.ones(key.shape[0], dtype=bool)
            keep[1:] = key[1:] != key[:-1]
            order = order[keep]
            src, dst, values = src[order], dst[order], values[order]
        else:
            order = np.argsort(dst * n + src, kind="stable")
            src, dst, values = src[order], dst[order], values[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, dst + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRGraph(
            n=n,
            indptr=indptr,
            indices=src.astype(np.int32),
            values=values,
            name=name,
        )

    # ------------------------------------------------------------------ #
    # Stats
    # ------------------------------------------------------------------ #
    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @cached_property
    def in_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @cached_property
    def out_degree(self) -> np.ndarray:
        deg = np.zeros(self.n, dtype=np.int64)
        np.add.at(deg, self.indices, 1)
        return deg

    def with_values(self, values: np.ndarray, name: str | None = None) -> "CSRGraph":
        assert values.shape[0] == self.nnz
        return dataclasses.replace(self, values=values, name=name or self.name)

    def apply_updates(self, batch):
        """Apply an :class:`repro_torch.graphs.updates.EdgeBatch` incrementally.

        Returns ``(new_graph, report)`` where ``report`` is an
        :class:`repro_torch.graphs.updates.UpdateReport` carrying the
        affected-vertex frontier and the displaced old values (so
        ``batch.inverse(report)`` is the exact undo).  The vertex set is
        immutable — only edges change.
        """
        from repro_torch.graphs.updates import apply_edge_batch

        return apply_edge_batch(self, batch)

    def stats(self) -> dict:
        ind = self.in_degree
        return {
            "name": self.name,
            "vertices": self.n,
            "edges": self.nnz,
            "avg_in_degree": float(ind.mean()) if self.n else 0.0,
            "max_in_degree": int(ind.max()) if self.n else 0,
        }


@dataclasses.dataclass(frozen=True)
class StripeSchedule:
    """Execution schedule for the delayed-async engine.

    Shapes (``S`` commit steps, ``P`` workers, ``M`` padded edges per cell,
    ``delta`` rows per cell):

    * ``src[S, P, M]``       — source vertex gathered from the frontier.
    * ``val[S, P, M]``       — edge value (``pad_val`` on padding entries).
    * ``dst_local[S, P, M]`` — destination row *within the cell*, in
      ``[0, delta]`` where ``delta`` is the dump slot for padding.
    * ``rows[S, P, delta]``  — global row id of each cell row (``n_slots - 1``
      = dump slot for rows beyond the worker's block).

    The frontier vector used by the engine has length ``n_slots = n + 1``;
    index ``n`` is a write-only dump slot.
    """

    n: int
    P: int
    delta: int
    S: int
    M: int
    src: np.ndarray  # (S, P, M) int32
    val: np.ndarray  # (S, P, M) value dtype
    dst_local: np.ndarray  # (S, P, M) int32
    rows: np.ndarray  # (S, P, delta) int32
    block_bounds: np.ndarray  # (P + 1,) int64 — contiguous vertex blocks
    edges: int  # true edge count (before padding)

    @property
    def n_slots(self) -> int:
        return self.n + 1

    @property
    def padded_edges(self) -> int:
        return int(self.src.size)

    @property
    def padding_overhead(self) -> float:
        return self.padded_edges / max(self.edges, 1)

    @property
    def flushes_per_round(self) -> int:
        """Commit collectives per round (sync ⇒ 1)."""
        return self.S

    def flush_bytes_per_round(self, bytes_per_elem: int = 4) -> int:
        """Bytes published to the global store per round (all workers)."""
        return self.S * self.P * self.delta * bytes_per_elem


def build_stripe_schedule(
    graph: CSRGraph,
    block_bounds: np.ndarray,
    delta: int,
    pad_val,
) -> StripeSchedule:
    """Precompute the static-shape stripe schedule for ``(graph, blocks, δ)``.

    ``block_bounds`` is the contiguous partition of vertices into ``P`` worker
    blocks (see :func:`repro_torch.graphs.partition.balanced_blocks`).  ``delta`` is
    the paper's δ in vertex elements; chunk ``s`` of worker ``w`` covers rows
    ``block_bounds[w] + [s·δ, (s+1)·δ)`` clipped to the block.

    ``pad_val`` must be the semiring's annihilating edge value
    (``x ⊗ pad_val = ⊕-identity``): ``0`` for plus-times, ``+INF`` for
    min-plus.
    """
    block_bounds = np.asarray(block_bounds, dtype=np.int64)
    B = int(np.diff(block_bounds).max())
    delta = int(min(delta, B))
    assert delta >= 1
    S = -(-B // delta)  # ceil
    stripes = [
        build_worker_stripe(
            graph, int(block_bounds[w]), int(block_bounds[w + 1]), S, delta, pad_val
        )
        for w in range(block_bounds.shape[0] - 1)
    ]
    return assemble_stripe_schedule(graph, block_bounds, delta, pad_val, stripes)


def build_worker_stripe(
    graph: CSRGraph, lo: int, hi: int, S: int, delta: int, pad_val
) -> dict:
    """One worker's stripe arrays for block ``[lo, hi)`` at natural width.

    The unit of targeted schedule invalidation: its content depends only on
    the block's own rows (``indptr[lo:hi+1]`` relative slices, the in-edge
    sources/values of those rows), ``n``, ``S``, ``delta``, and ``pad_val`` —
    so a stripe can be content-addressed and reused across graph mutations
    that never touch this block.  Arrays are ``(S, M_w)`` with the worker's
    own padded width ``M_w``; :func:`assemble_stripe_schedule` pads to the
    global ``M`` with the same fill convention, bit-identically to a
    monolithic build.
    """
    indptr = graph.indptr
    r0s = [min(lo + s * delta, hi) for s in range(S)]
    r1s = [min(lo + (s + 1) * delta, hi) for s in range(S)]
    counts = [int(indptr[r1] - indptr[r0]) for r0, r1 in zip(r0s, r1s)]
    M_w = max(counts) if counts else 0

    src = np.zeros((S, M_w), dtype=np.int32)
    val = np.full((S, M_w), pad_val, dtype=graph.values.dtype)
    dst_local = np.full((S, M_w), delta, dtype=np.int32)  # dump slot
    rows = np.full((S, delta), graph.n, dtype=np.int32)  # dump slot of frontier
    for s, (r0, r1) in enumerate(zip(r0s, r1s)):
        if r1 <= r0:
            continue
        e0, e1 = indptr[r0], indptr[r1]
        m = e1 - e0
        src[s, :m] = graph.indices[e0:e1]
        val[s, :m] = graph.values[e0:e1]
        # destination row within the cell for each edge
        row_of_edge = np.repeat(np.arange(r0, r1), np.diff(indptr[r0 : r1 + 1])) - r0
        dst_local[s, :m] = row_of_edge.astype(np.int32)
        rows[s, : r1 - r0] = np.arange(r0, r1, dtype=np.int32)
    return {"src": src, "val": val, "dst_local": dst_local, "rows": rows}


def assemble_stripe_schedule(
    graph: CSRGraph, block_bounds: np.ndarray, delta: int, pad_val, stripes: list
) -> StripeSchedule:
    """Pad per-worker stripes to the global ``M`` and stack the schedule.

    ``stripes[w]`` is :func:`build_worker_stripe`'s dict for worker ``w``
    (freshly built or loaded from the content-addressed store); the output is
    bit-identical to the monolithic :func:`build_stripe_schedule`.
    """
    block_bounds = np.asarray(block_bounds, dtype=np.int64)
    P = block_bounds.shape[0] - 1
    n = graph.n
    S = stripes[0]["src"].shape[0] if stripes else 1
    M = max(1, max(st["src"].shape[1] for st in stripes)) if stripes else 1

    val_dtype = graph.values.dtype
    src = np.zeros((S, P, M), dtype=np.int32)
    val = np.full((S, P, M), pad_val, dtype=val_dtype)
    dst_local = np.full((S, P, M), delta, dtype=np.int32)  # dump slot
    rows = np.full((S, P, delta), n, dtype=np.int32)
    for w, st in enumerate(stripes):
        m = st["src"].shape[1]
        src[:, w, :m] = st["src"]
        val[:, w, :m] = st["val"]
        dst_local[:, w, :m] = st["dst_local"]
        rows[:, w, :] = st["rows"]

    return StripeSchedule(
        n=n,
        P=P,
        delta=delta,
        S=S,
        M=M,
        src=src,
        val=val,
        dst_local=dst_local,
        rows=rows,
        block_bounds=block_bounds,
        edges=graph.nnz,
    )
