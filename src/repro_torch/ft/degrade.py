"""Graceful-degradation ladder: which (backend, frontier) to fall back to.

The counterpart of ``repro.ft.degrade`` for the port's two backends.  The
ladder first drops the halo frontier exchange (``halo`` → ``replicated`` on
the same backend), then steps down from the CUDA kernels to the plain
PyTorch round: ``kernel`` → ``torch``.  The torch rung runs on the solver's
own device and is the floor; the reference's ``host`` rung (numpy on the
host) has no counterpart.

The ladder answers the faults that the fault sites raise
(:class:`~repro_torch.ft.inject.InjectedFault` at ``kernel.dispatch``);
a kernel's own launch error, an out-of-memory error or a caller's error is
never answered by a lower rung (``Solver.solve``).

Every rung computes the same rounds, so degrading trades *performance*, not
answers, bit for bit wherever the plain round keeps the kernel's order: on
the CPU always, and on a CUDA device for min-plus (SSSP, CC).  A plus-times
plain round on CUDA adds through ``index_add_``, with atomics, so there the
degraded answer agrees with the kernel's within :func:`reorder_ulp_bound`,
not bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BACKEND_LADDER", "Degradation", "degradation_ladder", "reorder_ulp_bound"]

#: Next backend to try after a fault; ``None`` terminates the ladder.
BACKEND_LADDER = {"kernel": "torch", "torch": None}


@dataclasses.dataclass(frozen=True)
class Degradation:
    """One recorded fallback: where the fault hit and where execution moved."""

    site: str  # "solve" (Solver ladder) or "lane" (scheduler)
    from_backend: str
    from_frontier: str
    to_backend: str
    to_frontier: str
    error: str  # repr of the triggering exception
    rung: int  # 1 = first fallback, 2 = second, ...


def degradation_ladder(backend: str, frontier: str) -> list[tuple[str, str]]:
    """``[(backend, frontier), ...]`` from the requested pair down to torch.

    The first element is the requested pair itself; each later element is
    one rung down.  E.g. ``("kernel", "halo")`` → ``[("kernel", "halo"),
    ("kernel", "replicated"), ("torch", "replicated")]``.
    """
    if backend not in BACKEND_LADDER:
        raise ValueError(f"unknown backend {backend!r}")
    steps = [(backend, frontier)]
    if frontier == "halo":
        steps.append((backend, "replicated"))
    b = backend
    while BACKEND_LADDER[b] is not None:
        b = BACKEND_LADDER[b]
        steps.append((b, "replicated"))
    return steps


def reorder_ulp_bound(graph, rounds: int) -> int:
    """A bound on the ulps between two plus-times solves whose rounds sum
    each row's terms in other orders (the plain round on CUDA adds with
    atomics): a sum of k positive terms moves by at most k - 1 ulps of
    itself when reordered, relative errors of positive inputs carry through
    a sum without growing, so each round adds at most the largest in-degree
    (and one ulp for the epilogue); twice that for ulps of either side."""
    return 2 * rounds * (int(np.diff(graph.indptr).max()) + 1)
