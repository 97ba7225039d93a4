"""Content-addressed cache keys: what makes a persisted entry *safe* to reuse.

The counterpart of ``repro.persist.keys``.  The store never trusts a path:
every namespace is derived from the content it caches results for, so a
stale or mismatched entry is a **miss**, never a wrong answer.  A solver
namespace hashes together

* the **graph content** (indptr / indices / values bytes — the schedule
  graph, i.e. after any ``Problem.edge_values`` override);
* the **problem fingerprint** — name, tolerance, semiring, and a digest of
  the row update.  The reference hashes its row update's traced jaxpr with
  the closure constants; the port's row update is an
  :class:`~repro_torch.kernels.round_block.Epilogue`, which is all K1 runs,
  so the digest hashes its tag, its constants and its table's dtype, shape
  and bytes (:func:`epilogue_digest`): two Jacobi problems with different
  right-hand sides, or two PageRanks with different dampings, never share a
  namespace;
* the solver shape knobs (``n_workers``, ``partition_method``,
  ``min_chunk``);
* the solver's effective ``tol``/``max_rounds`` (constructor overrides
  applied), so different convergence regimes never share a δ-model;
* the **environment** (cache format, repro_torch / torch / numpy versions):
  a version bump retires every old namespace, and a ``cache_dir`` shared
  with the reference never loads its entries (its environment names
  ``repro`` and ``jax``).

:func:`graph_fingerprint`, :func:`stripe_fingerprint` and
:func:`plan_shard_fingerprint` hash the reference's parts and bytes, with
this package's environment where the reference hashes its own.

Known limit: *source edits* to schedule or plan construction code are not
content-hashed, so after changing how schedules or plans are *built*, bump
:data:`CACHE_FORMAT` to retire every persisted entry.

Anything not captured by the namespace (δ, frontier, shard count) is keyed
per entry inside the namespace by :mod:`repro_torch.persist.store`; whole
schedules and plans also by :func:`layout_digest`, since a solver's block
bounds need not be the ones its ``partition_method`` gives its graph.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = [
    "CACHE_FORMAT",
    "env_fingerprint",
    "epilogue_digest",
    "graph_fingerprint",
    "layout_digest",
    "plan_cells_fingerprint",
    "plan_shard_fingerprint",
    "problem_fingerprint",
    "solver_namespace",
    "stripe_fingerprint",
]

# Bump to retire every existing cache entry (layout or semantics change).
# 2: FrontierPlan src_loc/rows_loc went shard-major (D, S, P_loc, ·), as in
# the reference.
CACHE_FORMAT = 2

try:  # installed package
    import importlib.metadata

    _VERSION = importlib.metadata.version("repro")
except Exception:  # pragma: no cover - PYTHONPATH runs carry no dist metadata
    _VERSION = "0.1.0"


def env_fingerprint() -> str:
    """The toolchain part of every namespace key (mismatch ⇒ cold build)."""
    return (
        f"format{CACHE_FORMAT}-repro_torch{_VERSION}"
        f"-torch{torch.__version__}-numpy{np.__version__}"
    )


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
        h.update(b"\x00")  # unambiguous part boundaries
    return h.hexdigest()


def _host(a) -> np.ndarray:
    """A tensor's (or array's) host bytes, C-contiguous."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a)


def graph_fingerprint(graph) -> str:
    """Content hash of a :class:`~repro_torch.graphs.formats.CSRGraph` (not
    its name); the reference's bytes."""
    return _digest(
        str(graph.n).encode(),
        str(graph.indptr.dtype).encode(),
        np.ascontiguousarray(graph.indptr).tobytes(),
        str(graph.indices.dtype).encode(),
        np.ascontiguousarray(graph.indices).tobytes(),
        str(graph.values.dtype).encode(),
        np.ascontiguousarray(graph.values).tobytes(),
    )


def stripe_fingerprint(graph, lo: int, hi: int, S: int, delta: int, pad_val) -> str:
    """Content key of one worker stripe — the unit of evolve-aware reuse.

    Hashes exactly what :func:`repro_torch.graphs.formats.build_worker_stripe`
    reads: the block's *relative* indptr slice plus its in-edge sources and
    values, the global ``n``, the shape knobs ``(S, delta)``, the pad
    value and dtype, and the environment.  Two graphs that differ only
    outside ``[lo, hi)`` give the same digest for this block, so a mutated
    graph's schedule reuses every untouched stripe from the shared store.
    """
    indptr = np.asarray(graph.indptr)
    e0, e1 = int(indptr[lo]), int(indptr[hi])
    rel_ptr = indptr[lo : hi + 1] - e0
    return _digest(
        env_fingerprint().encode(),
        str(int(graph.n)).encode(),
        str(int(lo)).encode(),
        str(int(hi)).encode(),
        str(int(S)).encode(),
        str(int(delta)).encode(),
        repr(pad_val).encode(),
        str(graph.values.dtype).encode(),
        np.ascontiguousarray(rel_ptr).tobytes(),
        np.ascontiguousarray(graph.indices[e0:e1]).tobytes(),
        np.ascontiguousarray(graph.values[e0:e1]).tobytes(),
    )


def plan_shard_fingerprint(sched, vb_lo: int, vb_hi: int, w0: int, w1: int) -> str:
    """Content key of one frontier-plan shard piece (workers ``[w0, w1)``).

    Hashes what :func:`repro_torch.dist.engine_sharded.build_plan_shard`
    reads: the host bytes of the shard's slices of the schedule's ``src``,
    ``dst_local`` and ``rows``, its owned vertex interval, and ``(n,
    delta)``.  A mutation that leaves these workers' stripes byte-identical
    reuses the piece.
    """
    return plan_cells_fingerprint(
        sched.n, sched.delta, vb_lo, vb_hi, sched.src[:, w0:w1], sched.dst_local[:, w0:w1], sched.rows[:, w0:w1]
    )


def plan_cells_fingerprint(n: int, delta: int, vb_lo: int, vb_hi: int, src, dst_local, rows) -> str:
    """:func:`plan_shard_fingerprint` from the shard's workers' cells
    ``(S, P_loc, ·)`` themselves, as a rank of a group holds them on the
    host: the same digest for the same cells, so a group and a one-process
    solver share the store's plan pieces."""
    return _digest(
        env_fingerprint().encode(),
        str(int(n)).encode(),
        str(int(delta)).encode(),
        str(int(vb_lo)).encode(),
        str(int(vb_hi)).encode(),
        _host(src).tobytes(),
        _host(dst_local).tobytes(),
        _host(rows).tobytes(),
    )


def layout_digest(block_bounds, M: int | None = None) -> str:
    """Key of the layout a whole schedule (its worker ``block_bounds``) or a
    whole plan (its schedule's bounds and padded width ``M``) was built at.

    A solver pins its bounds across ``apply_updates``, so on the mutated
    graph they need not be what ``partition_method`` gives it, and a patched
    schedule keeps its old ``M``.  A whole entry saved at one layout must
    never load at another: its stripes and halo indices would be another
    partition's.
    """
    parts = [np.ascontiguousarray(block_bounds, dtype=np.int64).tobytes()]
    if M is not None:
        parts.append(str(int(M)).encode())
    return _digest(*parts)


def epilogue_digest(epilogue) -> str:
    """Digest of a row update :class:`~repro_torch.kernels.round_block.Epilogue`:
    its tag, ``const``, ``mix`` and ``one_minus_mix``, and its table's
    dtype, shape and bytes (``-`` where it has none)."""
    table = epilogue.table
    parts = [
        epilogue.tag.encode(),
        repr(float(epilogue.const)).encode(),
        np.float32(epilogue.mix).tobytes(),
        np.float32(epilogue.one_minus_mix).tobytes(),
    ]
    if table is None:
        parts.append(b"-")
    else:
        host = _host(table)
        parts += [str(host.dtype).encode(), str(host.shape).encode(), host.tobytes()]
    return _digest(*parts)


def problem_fingerprint(problem, epilogue) -> str:
    """Fingerprint of a :class:`~repro_torch.solve.problem.Problem` whose
    row update (for a query problem: at its template query) is ``epilogue``.

    The reference's parts, with :func:`epilogue_digest` for the traced row
    update; matrix problems (``feature_dim > 1``) add an ``F<dim>`` part.
    """
    feature_dim = int(getattr(problem, "feature_dim", 1))
    semiring = problem.semiring
    parts = [
        problem.name.encode(),
        repr(float(problem.tol)).encode(),
        str(int(problem.max_rounds)).encode(),
        str(np.dtype(semiring.dtype)).encode(),
        repr(semiring.zero).encode(),
        str(bool(problem.takes_query)).encode(),
        epilogue_digest(epilogue).encode(),
    ]
    if feature_dim > 1:
        parts.append(f"F{feature_dim}".encode())
    return _digest(*parts)


def solver_namespace(
    graph_fp: str,
    problem_fp: str,
    n_workers: int,
    partition_method: str,
    min_chunk: int,
    tol: float,
    max_rounds: int,
) -> str:
    """The namespace key one Solver's persisted entries live under, from its
    graph's :func:`graph_fingerprint` and its problem's
    :func:`problem_fingerprint` (the reference's parts, in its order).

    ``tol``/``max_rounds`` are the solver's *effective* values (constructor
    overrides applied) — two solvers on one problem with different
    convergence regimes must not share a δ-model or observation log.
    """
    return _digest(
        env_fingerprint().encode(),
        graph_fp.encode(),
        problem_fp.encode(),
        str(int(n_workers)).encode(),
        partition_method.encode(),
        str(int(min_chunk)).encode(),
        repr(float(tol)).encode(),
        str(int(max_rounds)).encode(),
    )
