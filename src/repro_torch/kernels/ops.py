"""Dispatch between the CUDA kernels and their plain versions.

The counterpart of ``repro.kernels.ops``.  A CUDA tensor goes to the kernel,
which launches or raises; only a tensor on the CPU goes to the plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.round_block import fused_round_cuda

__all__ = ["fused_round"]


def fused_round(x_ext, sched, semiring, row_update):
    """One full engine round (all S commit steps) over ``sched``."""
    if x_ext.device.type == "cuda":
        return fused_round_cuda(x_ext, sched, semiring, row_update)
    if x_ext.device.type == "cpu":
        return ref.fused_round_ref(x_ext, sched, semiring, row_update)
    raise ValueError(f"no fused round for device {x_ext.device}")
