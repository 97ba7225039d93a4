"""Warm-restart state repair: seed an incremental solve from a prior fixed point.

numpy; a copy of ``repro.evolve.restart``, so that the port imports nothing
of ``repro``.

The delayed-async engine's row updates are *monotone in one direction*:
plus-times problems (PageRank / PPR / Jacobi) are contractions that converge
from **any** starting state, and min-plus problems (SSSP / CC) only ever
*lower* labels (``new = min(old, reduced)``).  That asymmetry decides the
warm-start rule per semiring:

* **plus-times** — the previous fixed point passes through unchanged.  For a
  linear fixed point ``x = b + Mx``, iterating the full system from ``x*``
  is round-for-round identical to Maiter's delta-accumulative scheme
  (iterate the perturbation ``e = r + M'e`` from ``e₀ = 0`` and add ``x*``
  back): both start from the same state and apply the same linear operator,
  so the residual sequence coincides and convergence inherits the
  contraction argument.

* **min-plus** — inserts and weight *decreases* only create shorter paths,
  so ``x*`` remains an upper bound and the monotone iteration repairs it
  directly.  Deletes and weight *increases* can strand labels **below** their
  new fixed point, and a min-propagation can never raise them — the
  *deletion invalidation cone* must be re-raised to its base value first:

  - strictly positive weights (SSSP): a support-chain fix-point.  A vertex is
    *supported* if its old label is still attained by its base value or by a
    supported in-neighbour through the **new** graph.  Unsupported vertices
    form exactly the cone of labels that depended on a deleted/raised edge;
    they reset to ``x0``.  Positive weights make support chains strictly
    decreasing in label, so the recursion grounds at the base (no cyclic
    self-support) and the marking is complete.
  - all-zero weights (CC): support chains *can* be cyclic (two stale-label
    vertices supporting each other across a deleted bridge), so supportedness
    must instead be **certified** from the label originators — a multi-source
    BFS from every vertex whose label is its own base value, walking
    same-old-label edges of the new graph.  Uncertified vertices reset.

  Either way the repaired state ``y`` satisfies ``x*_new ≤ y ≤ x0``
  pointwise, and the min-plus iteration from any such ``y`` converges to
  exactly ``x*_new`` — bit-identical labels to a cold solve.

Mixed zero/positive min-plus weights defeat both arguments; those fall back
to a cold start (correct, no speedup) unless the caller forces a repair mode.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.semiring import INT_INF

__all__ = ["warm_start_state", "minplus_cone_repair", "minplus_certificate_repair"]


def _out_adjacency(graph):
    """CSR-by-source view of a pull-CSR graph: who reads vertex ``v``."""
    order = np.argsort(graph.indices, kind="stable")
    out_ptr = np.zeros(graph.n + 1, dtype=np.int64)
    np.add.at(out_ptr, graph.indices.astype(np.int64) + 1, 1)
    np.cumsum(out_ptr, out=out_ptr)
    dst_of_edge = np.repeat(np.arange(graph.n, dtype=np.int64), np.diff(graph.indptr))
    return out_ptr, dst_of_edge[order]


def minplus_cone_repair(graph, x_prev, x0, seed_rows) -> np.ndarray:
    """Re-raise the deletion cone for strictly positive min-plus weights.

    ``graph`` is the *new* (post-update) schedule graph, ``x_prev`` the old
    fixed point, ``x0`` the problem's base state on the new graph, and
    ``seed_rows`` the rows whose in-edge lists changed.  Returns the repaired
    warm state: supported vertices keep their old label, unsupported ones
    reset to ``x0``.  Marking extra vertices unsupported is safe (they just
    re-lower); missing one is not — the worklist therefore recursively
    rechecks every reader of a newly unsupported vertex until no support
    changes, which terminates because vertices are only ever marked once.
    """
    n = graph.n
    x = x_prev.astype(np.int64)
    base = x0.astype(np.int64)
    src = graph.indices.astype(np.int64)
    w = graph.values.astype(np.int64)
    indptr = graph.indptr
    out_ptr, out_dst = _out_adjacency(graph)

    supported = np.ones(n, dtype=bool)
    queued = np.zeros(n, dtype=bool)
    work = deque(int(u) for u in seed_rows)
    queued[np.asarray(seed_rows, dtype=np.int64)] = True
    while work:
        u = work.popleft()
        queued[u] = False
        if not supported[u]:
            continue
        e0, e1 = indptr[u], indptr[u + 1]
        vs = src[e0:e1]
        cand = np.where(
            supported[vs], np.minimum(x[vs] + w[e0:e1], INT_INF), INT_INF
        )
        best = min(int(base[u]), int(cand.min()) if cand.size else INT_INF)
        if best > x[u]:
            supported[u] = False
            for t in out_dst[out_ptr[u] : out_ptr[u + 1]]:
                if supported[t] and not queued[t]:
                    queued[t] = True
                    work.append(int(t))
    y = np.where(supported, x_prev, x0)
    return y.astype(x_prev.dtype)


def minplus_certificate_repair(graph, x_prev, x0) -> np.ndarray:
    """Certify labels from their originators (all-zero weights, e.g. CC).

    A vertex keeps its old label only if it reaches, through new-graph edges
    whose endpoints share that old label, some *originator* — a vertex whose
    old label equals its own base value (for CC: ``x*[r] == r``).  Plain
    support-checking is insufficient here: zero-weight support cycles let two
    stale vertices vouch for each other after the bridge to their label's
    originator was deleted.  Assumes the undirected convention CC requires
    (every edge present in both pull directions), so the pull-CSR in-edges
    double as out-edges for the BFS.
    """
    n = graph.n
    src = graph.indices.astype(np.int64)
    indptr = graph.indptr
    x = np.asarray(x_prev)
    base = np.asarray(x0)

    certified = x == base
    work = deque(int(u) for u in np.nonzero(certified)[0])
    while work:
        u = work.popleft()
        for v in src[indptr[u] : indptr[u + 1]]:
            if not certified[v] and x[v] == x[u]:
                certified[v] = True
                work.append(int(v))
    return np.where(certified, x_prev, x0).astype(x_prev.dtype)


def _has_raises(batch, report) -> bool:
    """Did the batch delete any edge or raise any weight?"""
    if report.deleted:
        return True
    if report.reweighted:
        new = np.asarray(batch.reweight_val)
        old = np.asarray(report.reweight_old_values)
        return bool(np.any(new.astype(np.float64) > old.astype(np.float64)))
    return False


def warm_start_state(problem, graph, sched_graph, x_prev, batch=None, report=None):
    """The warm initial state for re-solving ``problem`` after ``batch``.

    ``graph`` is the post-update base graph (feeds ``problem.x0``),
    ``sched_graph`` the post-update schedule graph (edge-value overrides
    applied — the weights the iteration actually runs on), ``x_prev`` the
    fixed point of the pre-update solve.  With no batch/report (plain warm
    re-solve) or for plus-times problems, ``x_prev`` passes through.
    """
    if batch is None or report is None:
        return x_prev
    if np.dtype(problem.semiring.dtype).kind == "f":
        # plus-times contraction: converges from any x0, and starting at the
        # old fixed point is Maiter's accumulative delta iteration in disguise
        return x_prev
    if not _has_raises(batch, report):
        return x_prev  # inserts/decreases only: x_prev stays an upper bound
    x0 = np.asarray(problem.x0(graph))
    vals = np.asarray(sched_graph.values)
    if vals.size == 0 or (vals == 0).all():
        return minplus_certificate_repair(sched_graph, np.asarray(x_prev), x0)
    if (vals > 0).all():
        # seed with every changed row; inserts are harmless extra rechecks
        return minplus_cone_repair(
            sched_graph, np.asarray(x_prev), x0, report.affected_rows
        )
    return x0  # mixed zero/positive weights: cold start is the safe repair
