"""The :class:`Problem` spec: what an iterative graph computation *is*.

The counterpart of ``repro.solve.problem``.  A pull-style fixed point
``x'[u] = row_update(x[u], ⊕_{v∈in(u)} x[v] ⊗ A[v,u])`` is described by a
semiring, a row update, a residual, an initial-state factory, and a
tolerance; δ, the backend and the schedules are the :class:`Solver`'s
business.

Each factory's row update is an :class:`~repro_torch.kernels.round_block.Epilogue`,
whose tag the CUDA round kernel evaluates itself:

* ``add_const`` — pagerank: ``(1-d)/n + reduced``
* ``add_table`` — ppr (the teleport vector ``q``), jacobi (``b/diag``) and
  rwr (the ``(n, F)`` restart matrix ``q``), with the table padded to
  ``n+1`` rows so the dump row reads in bounds
* ``min_old``   — sssp and cc: ``min(old, reduced)``
* ``labelprop`` — label propagation's row-normalised blend with its
  anchors ``q`` (``(n, F)``, padded likewise)

rwr and labelprop iterate a matrix frontier ``(n, F)``: F columns that share
one schedule (``Problem.feature_dim``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.semiring import INT_INF, MIN_PLUS, PLUS_TIMES, Semiring
from repro_torch.graphs.formats import CSRGraph
from repro_torch.kernels.round_block import ADD_CONST, ADD_TABLE, MIN_OLD, Epilogue

__all__ = [
    "Problem",
    "count_changed_residual",
    "l1_residual",
    "pagerank_problem",
    "ppr_problem",
    "ppr_teleport",
    "multi_source_x0",
    "sssp_problem",
    "cc_problem",
    "jacobi_problem",
    "default_landmarks",
    "rwr_restart",
    "rwr_embedding_problem",
    "labelprop_anchors",
    "label_propagation_problem",
]


@dataclasses.dataclass(frozen=True)
class Problem:
    """Frozen spec of one iterative graph computation.

    * ``semiring``        — ⊕/⊗ algebra (also fixes the state dtype).
    * ``make_row_update`` — ``(graph, q, device) -> row_update``; the row
      update is ``(old, reduced, rows) -> new`` on ``device`` (``rows`` hold
      global row ids, dump slot = n).  ``q`` is the query for
      ``takes_query`` problems and ``None`` otherwise.
    * ``residual``        — ``(x_prev, x_new, dim=None) -> tensor``, summed
      over the axes ``dim`` (all by default: a scalar); converged when
      ``residual ≤ tol``.  A batch passes every axis but its query axis.
    * ``x0``              — ``graph -> (n,) ndarray`` initial state factory
      (``(n, F)`` when ``feature_dim = F > 1``).
    * ``edge_values``     — optional ``graph -> (nnz,) ndarray`` override used
      when building the schedule (CC zeroes the weights so ⊗ is a no-op).
    * ``default_query``   — optional ``graph -> q`` for query problems.
    * ``feature_dim``     — the frontier width F: ``1`` for the vector
      problems; rwr and labelprop iterate ``(n, F)`` (``x0`` returns it).
    """

    name: str
    semiring: Semiring
    make_row_update: Callable
    residual: Callable
    x0: Callable
    tol: float
    max_rounds: int = 1000
    edge_values: Callable | None = None
    takes_query: bool = False
    default_query: Callable | None = None
    feature_dim: int = 1


def _sum(v, dim):
    return torch.sum(v) if dim is None else torch.sum(v, dim=dim)


def count_changed_residual(x_prev, x_new, dim=None):
    """Number of vertices whose value changed this round (paper's stop rule)."""
    return _sum((x_prev != x_new).to(torch.float32), dim)


def l1_residual(x_prev, x_new, dim=None):
    """Total absolute change across vertices (PageRank/Jacobi stop rule)."""
    return _sum(torch.abs(x_new - x_prev), dim)


def _row_table(values, device) -> torch.Tensor:
    """``(n,)+feat`` per-row values → ``(n+1,)+feat`` f32 table with a zero
    dump row; a tensor's rows are joined on ``device`` (a batch's tables)."""
    if isinstance(values, torch.Tensor):
        values = values.to(device=device, dtype=torch.float32)
        pad = torch.zeros((1,) + tuple(values.shape[1:]), dtype=torch.float32, device=device)
        return torch.cat([values, pad]).contiguous()
    values = np.asarray(values, dtype=np.float32)
    pad = np.zeros((1,) + values.shape[1:], dtype=np.float32)
    return torch.as_tensor(np.concatenate([values, pad]), device=device)


def _min_old(graph, q, device):
    del graph, q, device  # state-free: same update for every topology
    return Epilogue(MIN_OLD)


def pagerank_problem(
    damping: float = 0.85, tol: float = 1e-4, max_rounds: int = 1000
) -> Problem:
    """PageRank (paper §IV-A): edge values must hold ``d / outdeg(src)``."""

    def make_row_update(graph, q, device):
        return Epilogue(ADD_CONST, const=float(np.float32((1.0 - damping) / graph.n)))

    return Problem(
        name="pagerank",
        semiring=PLUS_TIMES,
        make_row_update=make_row_update,
        residual=l1_residual,
        x0=lambda g: np.full(g.n, 1.0 / g.n, dtype=np.float32),
        tol=tol,
        max_rounds=max_rounds,
    )


def ppr_teleport(graph: CSRGraph, seeds, damping: float = 0.85) -> np.ndarray:
    """(Q, n) teleport vectors ``(1-d)·e_seed`` for :func:`ppr_problem`."""
    seeds = np.atleast_1d(np.asarray(seeds, dtype=np.int64))
    t = np.zeros((seeds.shape[0], graph.n), dtype=np.float32)
    t[np.arange(seeds.shape[0]), seeds] = np.float32(1.0 - damping)
    return t


def ppr_problem(
    damping: float = 0.85, tol: float = 1e-4, max_rounds: int = 1000
) -> Problem:
    """Personalized PageRank: the teleport vector is a *query parameter*.

    ``q`` is a dense (n,) teleport vector.  The reference gathers ``q[rows]``
    through jax's clamping gather, so the dump rows (``rows == n``) read
    ``q[n-1]``; the port pads ``q`` with a dump row instead.  Either value
    lands only in the dump slot.
    """

    def make_row_update(graph, q, device):
        return Epilogue(ADD_TABLE, table=_row_table(q, device))

    return Problem(
        name="ppr",
        semiring=PLUS_TIMES,
        make_row_update=make_row_update,
        residual=l1_residual,
        x0=lambda g: np.full(g.n, 1.0 / g.n, dtype=np.float32),
        tol=tol,
        max_rounds=max_rounds,
        takes_query=True,
        default_query=lambda g: np.full(g.n, (1.0 - damping) / g.n, dtype=np.float32),
    )


def multi_source_x0(graph: CSRGraph, sources) -> np.ndarray:
    """(Q, n) SSSP initial states, one per source — feed to ``solve_batch``."""
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    x0 = np.full((sources.shape[0], graph.n), INT_INF, dtype=np.int32)
    x0[np.arange(sources.shape[0]), sources] = 0
    return x0


def sssp_problem(source: int = 0, max_rounds: int = 10_000) -> Problem:
    """Bellman-Ford SSSP (paper §IV-D): int32 min-plus relaxation."""

    def x0(graph):
        x = np.full(graph.n, INT_INF, dtype=np.int32)
        x[source] = 0
        return x

    return Problem(
        name="sssp",
        semiring=MIN_PLUS,
        make_row_update=_min_old,
        residual=count_changed_residual,
        x0=x0,
        tol=0.5,  # "no vertex updated last round"
        max_rounds=max_rounds,
    )


def cc_problem(max_rounds: int = 10_000) -> Problem:
    """Connected components via min-label propagation (symmetric graphs)."""
    return Problem(
        name="cc",
        semiring=MIN_PLUS,
        make_row_update=_min_old,
        residual=count_changed_residual,
        x0=lambda g: np.arange(g.n, dtype=np.int32),
        tol=0.5,
        max_rounds=max_rounds,
        edge_values=lambda g: np.zeros(g.nnz, dtype=np.int32),
    )


def jacobi_problem(
    diag: np.ndarray, b: np.ndarray, tol: float = 1e-6, max_rounds: int = 5000
) -> Problem:
    """Jacobi/block-GS fixed point for ``A x = b``.

    The graph must carry the pull splitting ``-A_ij / A_ii`` on edge
    ``(j -> i)``.
    """
    b_over_diag = (np.asarray(b) / np.asarray(diag)).astype(np.float32)

    def make_row_update(graph, q, device):
        return Epilogue(ADD_TABLE, table=_row_table(b_over_diag, device))

    return Problem(
        name="jacobi",
        semiring=PLUS_TIMES,
        make_row_update=make_row_update,
        residual=l1_residual,
        x0=lambda g: np.zeros(g.n, dtype=np.float32),
        tol=tol,
        max_rounds=max_rounds,
    )


# --------------------------------------------------------------------------- #
# Matrix-frontier factories: the engine's (n, F) workloads.
# --------------------------------------------------------------------------- #
def default_landmarks(n: int, feature_dim: int) -> np.ndarray:
    """``feature_dim`` evenly spaced landmark vertices on an ``n``-vertex graph."""
    return (np.arange(int(feature_dim), dtype=np.int64) * int(n)) // int(feature_dim)


def rwr_restart(graph: CSRGraph, seeds, damping: float = 0.85) -> np.ndarray:
    """(n, F) restart-mass matrix for :func:`rwr_embedding_problem`: column
    ``f`` carries ``(1-d)·e_{seeds[f]}``."""
    seeds = np.atleast_1d(np.asarray(seeds, dtype=np.int64))
    r = np.zeros((graph.n, seeds.shape[0]), dtype=np.float32)
    r[seeds, np.arange(seeds.shape[0])] = np.float32(1.0 - damping)
    return r


def rwr_embedding_problem(
    feature_dim: int = 4,
    damping: float = 0.85,
    tol: float = 1e-4,
    max_rounds: int = 1000,
) -> Problem:
    """Random-walk-with-restart embeddings: F restart columns, one solve.

    Each column of the ``(n, F)`` state solves personalized PageRank toward
    one landmark (``q`` is the :func:`rwr_restart` matrix), so a vertex's
    row is its F-dimensional proximity embedding.  Edge values must hold
    ``d / outdeg(src)`` as for :func:`pagerank_problem`.  With
    ``feature_dim=1`` and a single-seed restart column this is
    :func:`ppr_problem`, bit for bit.
    """
    F = int(feature_dim)

    def make_row_update(graph, q, device):
        return Epilogue(ADD_TABLE, table=_row_table(q, device))

    return Problem(
        name="rwr",
        semiring=PLUS_TIMES,
        make_row_update=make_row_update,
        residual=l1_residual,
        x0=lambda g: np.full((g.n, F), 1.0 / g.n, dtype=np.float32),
        tol=tol,
        max_rounds=max_rounds,
        takes_query=True,
        default_query=lambda g: rwr_restart(g, default_landmarks(g.n, F), damping),
        feature_dim=F,
    )


def labelprop_anchors(graph: CSRGraph, seeds) -> np.ndarray:
    """(n, F) one-hot anchor matrix: ``seeds[f]`` is clamped to class ``f``."""
    seeds = np.atleast_1d(np.asarray(seeds, dtype=np.int64))
    a = np.zeros((graph.n, seeds.shape[0]), dtype=np.float32)
    a[seeds, np.arange(seeds.shape[0])] = np.float32(1.0)
    return a


def label_propagation_problem(
    feature_dim: int = 4, mix: float = 0.9, tol: float = 1e-3, max_rounds: int = 2000
) -> Problem:
    """F-class semi-supervised label propagation with a row-normalized ⊕.

    The state is an ``(n, F)`` class-membership matrix.  A commit pulls the
    plus-times ⊕ of neighbour rows over unit edge weights (``edge_values``),
    then row-normalizes it; rows whose in-edges are all padding keep their
    value, and anchored rows (``q`` rows with mass, from
    :func:`labelprop_anchors`) clamp back to their one-hot label.  ``mix``
    damps the update, ``mix·prop + (1-mix)·old`` (:meth:`Epilogue.labelprop`).
    """
    F = int(feature_dim)
    mix = float(mix)
    if not 0.0 < mix <= 1.0:
        raise ValueError(f"mix must be in (0, 1], got {mix}")

    def make_row_update(graph, q, device):
        return Epilogue.labelprop(_row_table(q, device), mix)

    return Problem(
        name="labelprop",
        semiring=PLUS_TIMES,
        make_row_update=make_row_update,
        residual=l1_residual,
        x0=lambda g: np.full((g.n, F), 1.0 / F, dtype=np.float32),
        tol=tol,
        max_rounds=max_rounds,
        edge_values=lambda g: np.ones(g.nnz, dtype=np.float32),
        takes_query=True,
        default_query=lambda g: labelprop_anchors(g, default_landmarks(g.n, F)),
        feature_dim=F,
    )
