"""The plain PyTorch version of every kernel in this package.

The counterpart of ``repro.kernels.ref``.  The fused round's contract is "the
engine's round, in one kernel", so its plain version is the engine's round
itself (:func:`repro_torch.core.engine.round_fn`): S commit steps of gather,
⊗, per-worker segment-⊕ (``index_add_``, or ``scatter_reduce("amin")`` from
int32 max), row update and publish.  The halo step's plain version is one
such commit step on a shard's local frontier; the ELL SpMV's sums column by
column, in the kernel's order.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import chunk_reduce, round_fn
from repro_torch.core.semiring import INT_INF

__all__ = ["fused_halo_step_ref", "fused_round_ref", "spmv_ell_ref"]


def fused_round_ref(x_ext, sched, semiring, row_update):
    """Plain version of :func:`repro_torch.kernels.round_block.fused_round_cuda`."""
    return round_fn(sched, semiring, row_update)(x_ext)


def fused_halo_step_ref(x_loc, step, semiring, row_update) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.round_block.fused_halo_step_cuda`.

    One commit step of one shard, in place on its ``(L,)`` frontier: the
    gather reads local slots, ``row_update`` sees the global rows
    ``step.rows_g`` and ``old`` from the local slots ``step.rows_loc``,
    the publish writes the local slots (padded rows land in the dump slot
    ``L - 1``).  Returns the ``(H,)`` committed boundary rows
    ``chunk[step.send_idx]``.
    """
    delta = step.rows_loc.shape[1]
    reduced = chunk_reduce(x_loc, step.src, step.val, step.dst_local, delta, semiring)
    new = row_update(x_loc[step.rows_loc], reduced, step.rows_g)
    chunk = new.reshape(-1).to(x_loc.dtype)
    x_loc[step.rows_loc.reshape(-1)] = chunk
    return chunk[step.send_idx]


def spmv_ell_ref(x_ext, idx, val, semiring: str) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.spmv_ell.spmv_ell_cuda`.

    ``(rows,)+feat``: ``acc = acc ⊕ (x_ext[idx[:, j]] ⊗ val[:, j])`` for each
    column ``j`` in order, from the ⊕-identity.  Min-plus widens to int64
    and saturates at ``INT_INF``, as ``repro.kernels.ref.spmv_ell_ref`` does.
    """
    rows, max_deg = idx.shape
    feat = tuple(x_ext.shape[1:])
    col = (slice(None),) + (None,) * len(feat)  # val[:, j] broadcast over feat
    if semiring == "plus_times":
        acc = torch.zeros((rows,) + feat, dtype=x_ext.dtype, device=x_ext.device)
        for j in range(max_deg):
            acc = acc + x_ext[idx[:, j]] * val[:, j][col]
        return acc
    if semiring == "min_plus":
        inf = int(INT_INF)
        acc = torch.full((rows,) + feat, inf, dtype=torch.int64, device=x_ext.device)
        for j in range(max_deg):
            relaxed = x_ext[idx[:, j]].long() + val[:, j][col].long()
            acc = torch.minimum(acc, relaxed.clamp_max(inf))
        return acc.to(val.dtype)
    raise ValueError(semiring)
