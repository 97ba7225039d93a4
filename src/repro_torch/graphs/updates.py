"""Typed edge-update batches for evolving graphs (numpy; a copy of
``repro.graphs.updates``, so that the port imports nothing of ``repro``).

An :class:`EdgeBatch` is the mutation unit of ``repro_torch.evolve``: a set of
edge **inserts**, **deletes**, and **reweights**, all expressed against the
*pre-batch* graph and applied atomically by
:meth:`repro_torch.graphs.formats.CSRGraph.apply_updates`.  Application is strict —
inserting an edge that exists, or deleting/reweighting one that doesn't, is a
``ValueError`` (silent upserts would hide producer bugs and make the inverse
batch ill-defined) — and incremental: the CSR is rebuilt by merging the kept
edge list with the sorted inserts, never by re-sorting from a raw edge list.

The returned :class:`UpdateReport` carries the **affected-vertex frontier**
(every destination row whose in-edge list changed — what schedule-stripe
invalidation and warm-restart repair key off) plus the displaced old values,
so ``batch.inverse(report)`` is the exact undo batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EdgeBatch", "UpdateReport", "apply_edge_batch"]


def _as_edge_arrays(pairs, n_vals: int | None):
    """Normalize ``[(src, dst[, val]), ...]`` into flat int64/value arrays."""
    src = np.asarray([p[0] for p in pairs], dtype=np.int64)
    dst = np.asarray([p[1] for p in pairs], dtype=np.int64)
    if n_vals is None:
        return src, dst, None
    val = np.asarray([p[2] for p in pairs])
    return src, dst, val


@dataclasses.dataclass(frozen=True)
class EdgeBatch:
    """One atomic set of edge mutations against a :class:`CSRGraph`.

    All six arrays are host-side; ``insert_val`` may be ``None`` (defaults to
    ones in the graph's value dtype).  A single ``(src, dst)`` pair may appear
    in **at most one** operation across the whole batch — mixed semantics
    (delete *and* insert the same edge to "move" its weight) must be expressed
    as a reweight, otherwise apply order would be ambiguous.
    """

    insert_src: np.ndarray
    insert_dst: np.ndarray
    insert_val: np.ndarray | None
    delete_src: np.ndarray
    delete_dst: np.ndarray
    reweight_src: np.ndarray
    reweight_dst: np.ndarray
    reweight_val: np.ndarray

    @classmethod
    def from_ops(cls, inserts=(), deletes=(), reweights=()) -> "EdgeBatch":
        """Build from op lists: ``inserts``/``reweights`` are ``(src, dst,
        val)`` triples, ``deletes`` are ``(src, dst)`` pairs."""
        ins_s, ins_d, ins_v = _as_edge_arrays(inserts, 3)
        del_s, del_d, _ = _as_edge_arrays(deletes, None)
        rw_s, rw_d, rw_v = _as_edge_arrays(reweights, 3)
        return cls(
            insert_src=ins_s,
            insert_dst=ins_d,
            insert_val=ins_v,
            delete_src=del_s,
            delete_dst=del_d,
            reweight_src=rw_s,
            reweight_dst=rw_d,
            reweight_val=rw_v,
        )

    @property
    def n_inserts(self) -> int:
        return int(self.insert_src.shape[0])

    @property
    def n_deletes(self) -> int:
        return int(self.delete_src.shape[0])

    @property
    def n_reweights(self) -> int:
        return int(self.reweight_src.shape[0])

    @property
    def size(self) -> int:
        """Total edge operations in the batch."""
        return self.n_inserts + self.n_deletes + self.n_reweights

    def all_vertices(self) -> np.ndarray:
        """Every vertex id the batch mentions (validation / quota checks)."""
        return np.concatenate(
            [
                self.insert_src,
                self.insert_dst,
                self.delete_src,
                self.delete_dst,
                self.reweight_src,
                self.reweight_dst,
            ]
        )

    def inverse(self, report: "UpdateReport") -> "EdgeBatch":
        """The exact undo batch, given the report from applying this one.

        Applying ``batch`` then ``batch.inverse(report)`` restores the
        original graph bit-identically (CSR order is canonical, so the
        round-trip is an array-equality check, not a set check).
        """
        return EdgeBatch(
            insert_src=self.delete_src,
            insert_dst=self.delete_dst,
            insert_val=report.deleted_values,
            delete_src=self.insert_src,
            delete_dst=self.insert_dst,
            reweight_src=self.reweight_src,
            reweight_dst=self.reweight_dst,
            reweight_val=report.reweight_old_values,
        )


@dataclasses.dataclass(frozen=True)
class UpdateReport:
    """What one applied :class:`EdgeBatch` changed.

    ``affected_rows`` is the sorted-unique set of destination vertices whose
    in-edge list changed in topology **or** value — the invalidation frontier
    for schedule stripes (rows live in worker blocks) and the seed set for
    min-plus label repair.  ``deleted_values`` / ``reweight_old_values`` are
    aligned to the batch's delete / reweight entries (they make
    :meth:`EdgeBatch.inverse` exact).
    """

    inserted: int
    deleted: int
    reweighted: int
    affected_rows: np.ndarray  # sorted unique int64 destination rows
    deleted_values: np.ndarray
    reweight_old_values: np.ndarray

    @property
    def size(self) -> int:
        return self.inserted + self.deleted + self.reweighted


def _edge_positions(keys: np.ndarray, src, dst, n: int, kind: str) -> np.ndarray:
    """Positions of ``(src, dst)`` in the sorted edge-key array, or raise."""
    want = dst * n + src
    if keys.shape[0] == 0:
        if want.shape[0]:
            raise ValueError(
                f"{kind} of missing edge ({int(src[0])} -> {int(dst[0])})"
            )
        return np.zeros(0, dtype=np.int64)
    pos = np.searchsorted(keys, want)
    ok = (pos < keys.shape[0]) & (keys[np.minimum(pos, keys.shape[0] - 1)] == want)
    if not ok.all():
        i = int(np.nonzero(~ok)[0][0])
        raise ValueError(
            f"{kind} of missing edge ({int(src[i])} -> {int(dst[i])})"
        )
    return pos


def apply_edge_batch(graph, batch: EdgeBatch):
    """Apply ``batch`` to ``graph``; return ``(new_graph, UpdateReport)``.

    Strict semantics (each violation is a ``ValueError``): inserts require the
    edge absent, deletes/reweights require it present, every vertex id must be
    in ``[0, n)``, and no ``(src, dst)`` pair may appear twice in the batch.
    The rebuild is incremental — kept edges are copied in their canonical
    order and sorted inserts are merged in, so the output CSR is bit-identical
    to ``CSRGraph.from_edges`` on the mutated edge list.
    """
    n = graph.n
    verts = batch.all_vertices()
    if verts.size and (verts.min() < 0 or verts.max() >= n):
        raise ValueError(f"edge endpoint out of range [0, {n})")

    op_keys = np.concatenate(
        [
            batch.insert_dst * n + batch.insert_src,
            batch.delete_dst * n + batch.delete_src,
            batch.reweight_dst * n + batch.reweight_src,
        ]
    )
    if np.unique(op_keys).shape[0] != op_keys.shape[0]:
        raise ValueError("duplicate (src, dst) across the batch's operations")

    dst_of_edge = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(graph.indptr)
    )
    keys = dst_of_edge * n + graph.indices.astype(np.int64)

    del_pos = _edge_positions(keys, batch.delete_src, batch.delete_dst, n, "delete")
    rw_pos = _edge_positions(
        keys, batch.reweight_src, batch.reweight_dst, n, "reweight"
    )

    ins_keys = batch.insert_dst * n + batch.insert_src
    if keys.shape[0]:
        ins_pos = np.searchsorted(keys, ins_keys)
        present = (ins_pos < keys.shape[0]) & (
            keys[np.minimum(ins_pos, keys.shape[0] - 1)] == ins_keys
        )
    else:
        present = np.zeros(ins_keys.shape[0], dtype=bool)
    if present.any():
        i = int(np.nonzero(present)[0][0])
        raise ValueError(
            f"insert of existing edge "
            f"({int(batch.insert_src[i])} -> {int(batch.insert_dst[i])})"
        )

    deleted_values = graph.values[del_pos].copy()
    reweight_old = graph.values[rw_pos].copy()

    new_values = graph.values.copy()
    new_values[rw_pos] = np.asarray(batch.reweight_val, dtype=new_values.dtype)
    keep = np.ones(keys.shape[0], dtype=bool)
    keep[del_pos] = False

    ins_val = batch.insert_val
    if ins_val is None:
        ins_val = np.ones(batch.n_inserts, dtype=graph.values.dtype)
    ins_order = np.argsort(ins_keys, kind="stable")

    kept_keys = keys[keep]
    merged_keys = np.concatenate([kept_keys, ins_keys[ins_order]])
    merged_src = np.concatenate(
        [graph.indices[keep], batch.insert_src[ins_order].astype(np.int32)]
    )
    merged_val = np.concatenate(
        [new_values[keep], np.asarray(ins_val, dtype=new_values.dtype)[ins_order]]
    )
    order = np.argsort(merged_keys, kind="stable")

    new_dst = merged_keys[order] // n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, new_dst + 1, 1)
    np.cumsum(indptr, out=indptr)

    new_graph = dataclasses.replace(
        graph,
        indptr=indptr,
        indices=merged_src[order],
        values=merged_val[order],
    )
    affected = np.unique(
        np.concatenate([batch.insert_dst, batch.delete_dst, batch.reweight_dst])
    )
    report = UpdateReport(
        inserted=batch.n_inserts,
        deleted=batch.n_deletes,
        reweighted=batch.n_reweights,
        affected_rows=affected,
        deleted_values=deleted_values,
        reweight_old_values=reweight_old,
    )
    return new_graph, report
