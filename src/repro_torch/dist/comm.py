"""A rank's share of a solve over ``torch.distributed``: the gathers between commit steps.

The counterpart of the collectives the reference runs under ``shard_map``
between its per-device kernel calls.  On the halo frontier
(``repro.dist.engine_sharded.frontier_pallas_round_fn``) that is an
``all_gather`` of every shard's ``(H,)+feat`` boundary rows (for an int8 or
fp8 wire, the 1-byte values and a second ``all_gather`` of the per-shard
scales), and a rank holds a contiguous range of the ``D`` shards.  On the
replicated frontier (``sharded_round_fn_q``) it is an ``all_gather`` of
every worker's committed chunk, and a rank holds a contiguous range of the
``P`` workers and the whole frontier.  Here one process runs each rank
(:class:`HaloGroup`).

The transport follows the group's backend: ``nccl`` gathers tensors on the
card; ``gloo`` gathers host tensors, so a card's blocks are staged through
pinned host buffers (``HaloGroup.transport`` names which one ran).  Both
gather in rank order, which is shard (and worker) order, so every rank
receives the same block the one-process exchange would.  float8 values cross
as a ``uint8`` view (``gloo`` takes no float8).

Two small collectives serve what every rank must decide alike:
:meth:`HaloGroup.broadcast_object` hands rank 0's Python object (a δ-model
read from a store, a service's new requests) to every rank, and
:meth:`HaloGroup.any` tells every rank whether some rank raised a flag (a
serving lane's fault).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["HaloGroup"]


class HaloGroup:
    """A rank's place in a solve over a ``torch.distributed`` group.

    ``rank`` and ``world_size`` are the group's.  On the halo frontier the
    rank holds shards ``[d0, d1) = [r·D/W, (r+1)·D/W)`` of the ``D =
    n_shards`` (``D % W`` must be 0; with ``n_shards=None``, ``d0`` and
    ``d1`` are None), on the replicated frontier workers ``split(P,
    "workers")``.  Every gather is a collective: all ranks call it in the
    same order.
    """

    def __init__(self, group=None, n_shards: int | None = None):
        self.group = dist.group.WORLD if group is None else group
        self.rank = dist.get_rank(self.group)
        self.world_size = dist.get_world_size(self.group)
        self.n_shards = self.d0 = self.d1 = None
        if n_shards is not None:
            self.d0, self.d1 = self.split(n_shards)
            self.n_shards = int(n_shards)
        self.backend = str(dist.get_backend(self.group))
        self.transport = None  # "nccl", "gloo (pinned host)" or "gloo (host)", set by a gather
        self._pinned: dict = {}

    def split(self, count: int, what: str = "shards") -> tuple:
        """This rank's contiguous range ``[lo, hi)`` of ``count`` shards (or
        workers) split evenly over the group; raises unless ``count % W ==
        0``."""
        n, W = int(count), self.world_size
        if n < 1 or n % W:
            c = "D" if what == "shards" else "P"
            raise ValueError(
                f"{c}={n} {what} do not split evenly over W={W} ranks: a rank holds "
                f"{c}/W whole {what}, so {c} % W must be 0"
            )
        per = n // W
        return self.rank * per, (self.rank + 1) * per

    def _staging(self, key, shape, dtype) -> torch.Tensor:
        buf = self._pinned.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(k, ...)`` blocks of every rank → ``(W·k, ...)``, in rank order
        (shard order, worker order), on ``t``'s device."""
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

    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` on every rank (pickled; the other ranks' ``obj``
        is ignored)."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0), group=self.group)
        return box[0]

    def any(self, flag: bool) -> bool:
        """Whether any rank's ``flag`` is set (one all-gather of a word)."""
        local = torch.tensor([1 if flag else 0], dtype=torch.int32)
        if self.backend == "nccl":
            local = local.to(torch.device("cuda", torch.cuda.current_device()))
        return bool(self.all_gather(local).any())

    def sum_partials(self, partials):
        """The sum of every shard's partial (this rank's ``partials``, one a
        held shard), added in shard order in float64: the same bits for any
        ``W``.  ``partials`` ``(D/W,)`` gives a float; ``(D/W, Q)``, one
        partial a query, gives the ``(Q,)`` float64 sums."""
        local = torch.tensor(np.asarray(partials, dtype=np.float64))
        if self.backend == "nccl":
            local = local.to(torch.device("cuda", torch.cuda.current_device()))
        every = self.all_gather(local).cpu().numpy()
        total = np.zeros(every.shape[1:], np.float64)
        for v in every:
            total = total + v
        return float(total) if total.ndim == 0 else total

    def gather_owned(self, x_loc: torch.Tensor, vertex_bounds) -> torch.Tensor:
        """Every shard's owned rows, in vertex order: ``(n,)+feat`` on the
        host, from this rank's ``(D/W, L)+feat`` frontier (each shard keeps
        its owned block first; ``D`` from ``vertex_bounds``).  One
        all-gather, padded to the largest block."""
        owned = np.diff(np.asarray(vertex_bounds, dtype=np.int64))
        d0, d1 = self.split(owned.size)
        B = int(owned.max())
        feat = tuple(x_loc.shape[2:])
        buf = torch.zeros((d1 - d0, B) + feat, dtype=x_loc.dtype, device=x_loc.device)
        for i, d in enumerate(range(d0, d1)):
            buf[i, : owned[d]] = x_loc[i, : owned[d]]
        every = self.all_gather(buf).cpu()
        return torch.cat([every[d, : owned[d]] for d in range(owned.size)])
