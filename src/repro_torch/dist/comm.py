"""The halo exchange across processes: a rank's shards over ``torch.distributed``.

The counterpart of what ``repro.dist.engine_sharded.frontier_pallas_round_fn``
runs under ``shard_map`` between its per-shard kernel calls: an
``all_gather`` of every shard's ``(H,)+feat`` boundary rows (for an int8 or
fp8 wire, the 1-byte values and a second ``all_gather`` of the per-shard
scales).  Here one process runs each rank, and a rank holds a contiguous
range of the ``D`` shards (:class:`HaloGroup`).

The transport follows the group's backend: ``nccl`` gathers tensors on the
card; ``gloo`` gathers host tensors, so a card's blocks are staged through
pinned host buffers (``HaloGroup.transport`` names which one ran).  Both
gather in rank order, which is shard order, so every rank receives the same
``(D, H)+feat`` block the one-process exchange would.  float8 values cross
as a ``uint8`` view (``gloo`` takes no float8).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["HaloGroup"]


class HaloGroup:
    """A rank's place in a halo solve over a ``torch.distributed`` group.

    ``rank`` and ``world_size`` are the group's; the rank holds shards
    ``[d0, d1) = [r·D/W, (r+1)·D/W)`` of the ``D = n_shards`` (``D % W``
    must be 0).  Every method is a collective: all ranks call it in the same
    order.
    """

    def __init__(self, group=None, n_shards: int = 1):
        self.group = dist.group.WORLD if group is None else group
        self.rank = dist.get_rank(self.group)
        self.world_size = dist.get_world_size(self.group)
        D, W = int(n_shards), self.world_size
        if D < 1 or D % W:
            raise ValueError(
                f"D={D} shards do not split evenly over W={W} ranks: a rank holds "
                f"D/W whole shards, so D % W must be 0"
            )
        self.n_shards = D
        per = D // W
        self.d0, self.d1 = self.rank * per, (self.rank + 1) * per
        self.backend = str(dist.get_backend(self.group))
        self.transport = None  # "nccl", "gloo (pinned host)" or "gloo (host)", set by a gather
        self._pinned: dict = {}

    def _staging(self, key, shape, dtype) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(D/W, ...)`` blocks of every rank → ``(D, ...)``, in shard
        order, on ``t``'s device."""
        t = t.contiguous()
        wire = t.view(torch.uint8) if t.element_size() == 1 else t
        shape = (wire.shape[0] * self.world_size,) + tuple(wire.shape[1:])
        if self.backend == "nccl":
            if wire.device.type != "cuda":
                raise ValueError("an nccl group gathers tensors on the card")
            out = torch.empty(shape, dtype=wire.dtype, device=wire.device)
            dist.all_gather_into_tensor(out, wire, group=self.group)
            self.transport = "nccl"
        elif wire.device.type == "cuda":
            host_in = self._staging(("in", wire.dtype), wire.shape, wire.dtype)
            host_out = self._staging(("out", wire.dtype), shape, wire.dtype)
            host_in.copy_(wire)
            dist.all_gather_into_tensor(host_out, host_in, group=self.group)
            out = host_out.to(wire.device)
            self.transport = "gloo (pinned host)"
        else:
            out = torch.empty(shape, dtype=wire.dtype)
            dist.all_gather_into_tensor(out, wire, group=self.group)
            self.transport = "gloo (host)"
        return out.view(t.dtype) if t.element_size() == 1 else out

    def sum_partials(self, partials) -> float:
        """The sum of every shard's partial (this rank's ``partials``, one a
        held shard), added in shard order in float64: the same bits for any
        ``W``."""
        local = torch.tensor(np.asarray(partials, dtype=np.float64))
        if self.backend == "nccl":
            local = local.to(torch.device("cuda", torch.cuda.current_device()))
        total = 0.0
        for v in self.all_gather(local).cpu().tolist():
            total += v
        return total

    def gather_owned(self, x_loc: torch.Tensor, vertex_bounds) -> torch.Tensor:
        """Every shard's owned rows, in vertex order: ``(n,)+feat`` on the
        host, from this rank's ``(D/W, L)+feat`` frontier (each shard keeps
        its owned block first).  One all-gather, padded to the largest
        block."""
        owned = np.diff(np.asarray(vertex_bounds, dtype=np.int64))
        B = int(owned.max())
        feat = tuple(x_loc.shape[2:])
        buf = torch.zeros((self.d1 - self.d0, B) + feat, dtype=x_loc.dtype, device=x_loc.device)
        for i, d in enumerate(range(self.d0, self.d1)):
            buf[i, : owned[d]] = x_loc[i, : owned[d]]
        every = self.all_gather(buf).cpu()
        return torch.cat([every[d, : owned[d]] for d in range(self.n_shards)])
