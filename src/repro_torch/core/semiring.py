"""Semiring algebra for pull-style iterative graph algorithms, on torch tensors.

The counterpart of ``repro.core.semiring``.  A pull update is
``x'[u] = row_update(x[u], ⊕_{v ∈ in(u)} x[v] ⊗ A[v, u])``; the semiring
supplies ⊕ (as a segment reduction), ⊗, the ⊕-identity, and the annihilating
edge value the schedule pads with (``x ⊗ pad = ⊕-identity``).

The segment reductions reproduce ``jax.ops.segment_sum``/``segment_min``
exactly, empty segments included: an empty sum segment reads ``0`` and an
empty min segment reads ``2147483647`` (int32 max), not ``INT_INF``.  On the
CPU, ``index_add_`` adds in index order, as XLA's CPU scatter does, so the
plus-times sums match the reference bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["Semiring", "PLUS_TIMES", "MIN_PLUS", "INT_INF", "INT32_MAX"]

# Largest "infinity" such that INF ⊗ INF never overflows int32 under min-plus.
INT_INF = np.int32(2**30 - 1)
# What an empty min segment reads (jax.ops.segment_min's fill value).
INT32_MAX = np.int32(2**31 - 1)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (⊕, ⊗) pair plus the identities the schedule padding relies on."""

    name: str
    dtype: np.dtype  # numpy dtype of the state (host arrays, schedules)
    zero: object  # ⊕ identity
    pad_edge_val: object  # annihilator: x ⊗ pad == zero
    mul: Callable  # ⊗(frontier_vals, edge_vals) -> contributions
    segment_reduce: Callable  # ⊕ over segments: (vals, seg_ids, num) -> out

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.from_numpy(np.zeros(0, self.dtype)).dtype


def _segment_sum(vals, seg_ids, num):
    """Leading-axis segment-⊕ for plus-times; empty segments read 0.
    Trailing feature axes ride along: an ``(m, F)`` input is summed one
    column at a time (a vector ``index_add_`` runs a tight loop on the CPU,
    a matrix one a tensor op per index), in the same index order; more
    trailing axes (a batch's ``(m, Q, F)``) are flattened into columns."""
    if vals.dim() > 2:
        flat = _segment_sum(vals.reshape(vals.shape[0], -1), seg_ids, num)
        return flat.reshape((num,) + vals.shape[1:])
    if vals.dim() == 2:
        cols = [_segment_sum(vals[:, f].contiguous(), seg_ids, num) for f in range(vals.shape[1])]
        return torch.stack(cols, dim=1)
    out = torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg_ids, vals)


def _segment_min(vals, seg_ids, num):
    """Leading-axis segment-⊕ for min-plus; empty segments read int32 max.
    Trailing feature axes ride along, as in :func:`_segment_sum`."""
    out = torch.full((num,) + vals.shape[1:], int(INT32_MAX), dtype=vals.dtype, device=vals.device)
    idx = seg_ids.long().reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, "amin", include_self=True)


PLUS_TIMES = Semiring(
    name="plus_times",
    dtype=np.dtype(np.float32),
    zero=np.float32(0.0),
    pad_edge_val=np.float32(0.0),
    mul=lambda x, a: x * a,
    segment_reduce=_segment_sum,
)

# min-plus over saturating int32 (paper's SSSP uses 32-bit integers).  The
# int32 sum wraps on overflow, as the reference's does.
MIN_PLUS = Semiring(
    name="min_plus",
    dtype=np.dtype(np.int32),
    zero=INT_INF,
    pad_edge_val=INT_INF,
    mul=lambda x, a: torch.clamp_max(x + a, int(INT_INF)),
    segment_reduce=_segment_min,
)
