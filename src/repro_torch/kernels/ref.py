"""The plain PyTorch version of every kernel in this package.

The counterpart of ``repro.kernels.ref``.  The fused round's contract is "the
engine's round, in one kernel", so its plain version is the engine's round
itself (:func:`repro_torch.core.engine.round_fn`): S commit steps of gather,
⊗, per-worker segment-⊕ (``index_add_``, or ``scatter_reduce("amin")`` from
int32 max), row update and publish.
"""

from __future__ import annotations

from repro_torch.core.engine import round_fn

__all__ = ["fused_round_ref"]


def fused_round_ref(x_ext, sched, semiring, row_update):
    """Plain version of :func:`repro_torch.kernels.round_block.fused_round_cuda`."""
    return round_fn(sched, semiring, row_update)(x_ext)
