"""The owner-computes sharded frontier ("halo" engine), on torch tensors.

The counterpart of the halo half of ``repro.dist.engine_sharded``.  The
frontier is split over ``D`` shards, each holding ``P_loc = P / D`` of the
schedule's workers: shard ``d`` keeps a local frontier of ``L`` slots (its
owned vertex block, then halo copies of the remote vertices its workers
read, sorted by global id, then a dump slot at ``L - 1``).  A commit step
runs on every shard against its local frontier, publishes the shard's chunk
locally, and ships only the ``(H,)`` committed rows some other shard keeps a
halo copy of (:class:`FrontierPlan`).  A halo copy always holds its owner's
last committed value, which is what the replicated round reads, so an f32
halo round equals :func:`repro_torch.core.engine.round_fn` bit for bit.

All ``D`` shards live on the solver's one device, stacked as ``(D, L)``
(``(D, L, F)`` for a matrix frontier, whose quantized wire keeps one scale
per feature column), as the reference's tests put ``D`` fake devices on one
CPU.  The exchange
between commit steps is, in the plain round, one function,
:func:`halo_exchange` (the counterpart of ``jax.lax.all_gather(...,
tiled=True)`` followed by each shard's scatter into its halo slots); the
kernel K2 runs it on the card between grid barriers.

Two rounds over the same plan:

* :func:`frontier_sharded_round_fn` — the plain round
  (:func:`repro_torch.kernels.ref.fused_halo_round_ref`); the counterpart
  of the reference's ``frontier_sharded_round_fn``.
* :func:`frontier_kernel_round_fn` — the whole round is one
  :func:`repro_torch.kernels.ops.fused_halo_round` (one K2 launch on CUDA,
  its plain version on the CPU), optionally with the boundary rows
  quantized to int8 or fp8 with error feedback; the counterpart of the
  reference's ``frontier_pallas_round_fn``.

Across processes (:func:`frontier_rank_round_fn`), each rank of a
:class:`repro_torch.dist.comm.HaloGroup` holds only its own contiguous
range of shards: its workers' schedule cells (:class:`RankSchedule`), their
plan blocks (:meth:`FrontierPlan.for_shards`) and their ``(D/W, L)+feat``
frontier.  A commit step is K2's rank entry over those shards
(:func:`repro_torch.kernels.ops.halo_local_step`), an all-gather of the
``(D, H)+feat`` boundary rows across the group (for int8/fp8, the 1-byte
values and the ``(D,)+feat`` scales), and K2's receive
(:func:`repro_torch.kernels.ops.halo_recv`): the reference's
``frontier_pallas_round_fn`` under ``shard_map``, one process a device.

A batch of Q queries runs the halo round over a ``(D, L, Q)+feat`` batch
frontier (:func:`frontier_batch_round_fn`, one K2 launch a round), the
reference's vmapped ``frontier_round_ext_fn``; across processes over the
rank's ``(D/W, L, Q)+feat`` shards (:func:`frontier_rank_batch_round_fn`,
K2's rank entries at C = Q·F).

The replicated frontier across processes (:func:`replicated_rank_round_fn`,
the reference's ``sharded_round_fn_q``) splits the workers instead: a rank
holds the cells of its ``P/W`` workers (:func:`replicated_rank`) and the
whole frontier, and a commit step is K1's rank step over its workers
(:func:`repro_torch.kernels.ops.round_rank_step`), the group's all-gather of
every rank's ``(P/W·δ,)+feat`` rows in worker order, and K1's publish of
them at the schedule's global rows (:func:`repro_torch.kernels.ops.round_publish`).

The plan is built on the host from the schedule's numpy arrays and equals
the reference's plan array for array.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.engine import DeviceSchedule, _cell_row_ptr
from repro_torch.core.semiring import Semiring
from repro_torch.graphs.formats import CSRGraph, build_worker_stripe
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import halo_exchange, quantize_halo

__all__ = [
    "FrontierPlan",
    "HALO_DTYPES",
    "RankSchedule",
    "assemble_frontier_plan",
    "build_plan_shard",
    "frontier_batch_round_fn",
    "frontier_ef_init",
    "frontier_kernel_round_ext_fn",
    "frontier_kernel_round_fn",
    "frontier_rank_batch_round_fn",
    "frontier_rank_round_fn",
    "frontier_round_ext_fn",
    "frontier_sharded_round_fn",
    "halo_exchange",
    "make_frontier_plan",
    "outgrows",
    "patch_cells",
    "plan_shard_bounds",
    "plan_shard_from_cells",
    "quantize_halo",
    "patch_rank_cells",
    "rank_cells",
    "rank_plan",
    "rank_schedule",
    "replicated_rank",
    "replicated_rank_round_fn",
    "resolve_halo_dtype",
    "schedule_rows",
    "shard_halos",
    "stripe_width",
]

#: Wire dtypes of the halo exchange.  ``"f32"`` ships the committed boundary
#: rows as they are (exact rounds); ``"int8"`` / ``"fp8"`` quantize them per
#: (shard, commit step) with an error-feedback residual.
HALO_DTYPES = ("f32", "int8", "fp8")


def resolve_halo_dtype(halo_dtype: str, semiring: Semiring) -> str:
    """Validate ``halo_dtype`` against :data:`HALO_DTYPES` and the semiring.

    Quantization runs in f32, so it is defined for floating-point semirings
    only (rounding a min-plus path length would break exactness).
    """
    if halo_dtype not in HALO_DTYPES:
        raise ValueError(
            f"halo_dtype={halo_dtype!r} not supported; choose from {HALO_DTYPES}"
        )
    if halo_dtype != "f32" and np.dtype(semiring.dtype).kind != "f":
        raise ValueError(
            f"halo_dtype={halo_dtype!r} requires a floating-point semiring, "
            f"got dtype={np.dtype(semiring.dtype).name}"
        )
    return halo_dtype


@dataclasses.dataclass(frozen=True)
class FrontierPlan:
    """Owner-computes layout and halo-exchange indices for one ``(sched, D)``.

    Shard ``d`` owns vertices ``[vertex_bounds[d], vertex_bounds[d+1])``.
    Per commit step ``s`` it ships the ``≤ H`` committed rows of its chunk
    that appear in another shard's halo (``send_idx``, into the flat
    ``(P_loc·δ,)`` chunk; padding entries are 0), and every shard scatters
    the gathered ``(D·H,)`` buffer into its halo slots (``recv_idx``;
    entries it keeps no copy of, and padding, land in its dump slot).

    A rank's plan (:meth:`for_shards`) holds the blocks of shards ``[d0,
    d1)`` alone: the per-shard tensors' shard axis has ``d1 - d0`` entries
    (``src_loc``, ``rows_loc``, ``gather_index``, and the second axis of
    ``send_idx``, ``recv_idx`` and ``dump_last``; ``owned_flat`` the rank's
    owned vertices), while ``D``, ``L``, ``H`` and the bounds stay global.
    A whole plan has ``d0 = 0``.
    """

    D: int
    P_loc: int
    L: int
    H: int
    S: int
    delta: int
    n: int
    vertex_bounds: np.ndarray  # (D + 1,) int64
    halo_sizes: np.ndarray  # (D,) int64 — |halo| per shard
    boundary_entries_per_round: int  # real (unpadded) halo rows shipped a round
    src_loc: torch.Tensor  # (D, S, P_loc, M) int32 — local src slots
    rows_loc: torch.Tensor  # (D, S, P_loc, delta) int32 — local row slots
    send_idx: torch.Tensor  # (S, D, H) int32 into the flat chunk
    recv_idx: torch.Tensor  # (S, D, D·H) int32 into the local frontier
    gather_index: torch.Tensor  # (D, L) int32 — global slot of each local slot
    owned_flat: torch.Tensor  # (n,) int32 — flat (D·L) slot owning each vertex
    # (S, D) int32 — per (step, receiving shard) the last recv_idx entry that
    # lands in the dump slot (-1: none): the value a sequential exchange
    # leaves there, which K2's quantized wire writes
    dump_last: torch.Tensor
    d0: int = 0  # the first shard held (a rank's plan holds [d0, d1))

    @property
    def d1(self) -> int:
        """One past the last shard held."""
        return self.d0 + self.src_loc.shape[0]

    @property
    def owned_sizes(self) -> np.ndarray:
        """``(d1 - d0,)``: the vertices each held shard owns."""
        return np.diff(self.vertex_bounds)[self.d0 : self.d1]

    @classmethod
    def for_shards(
        cls, sched, n_shards: int, d0: int, d1: int, pieces: list, halos: list, device=None
    ) -> "FrontierPlan":
        """The plan of shards ``[d0, d1)`` alone: a rank's.

        ``pieces`` are those shards' :func:`build_plan_shard` pieces (from
        the rank's own schedule cells, :func:`plan_shard_from_cells`),
        ``halos`` every shard's halo (:func:`shard_halos`, from the graph on
        the host); ``sched`` holds at least the shards' workers and the
        global block bounds.  ``L``, ``H`` and the exchange indices are
        computed from the halos and the global rows (:func:`schedule_rows`,
        from the bounds), and only the shards' blocks go to ``device``: the
        arrays equal the whole plan's ``[d0, d1)`` slices.
        """
        D = int(n_shards)
        if not 0 <= d0 < d1 <= D or len(pieces) != d1 - d0:
            raise ValueError(f"need the pieces of shards [{d0}, {d1}) of {D}")
        return _assemble(sched, D, d0, pieces, halos, device)

    # ------------------------------------------------------------------ #
    # persistence (repro_torch.persist stores plans as plain npz archives)
    # ------------------------------------------------------------------ #
    def to_host_arrays(self) -> dict:
        """Flat ``{name: ndarray}`` dict round-trippable through ``np.savez``:
        the reference's keys, without the derived ``owned_flat`` (and the
        port's ``dump_last``)."""
        out = {}
        for f in dataclasses.fields(self):
            if f.name in _DERIVED:
                continue
            v = getattr(self, f.name)
            out[f.name] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return out

    @classmethod
    def from_host_arrays(cls, arrays, device) -> "FrontierPlan":
        """Rebuild from :meth:`to_host_arrays` output (shape-validated), with
        the tensors on ``device`` and ``owned_flat`` and ``dump_last``
        derived there (:func:`_derived_tensors`)."""
        D, S, H, L = (int(arrays[k]) for k in ("D", "S", "H", "L"))
        P_loc, delta, n = int(arrays["P_loc"]), int(arrays["delta"]), int(arrays["n"])
        vb = np.asarray(arrays["vertex_bounds"], dtype=np.int64)
        t = {k: torch.tensor(np.asarray(arrays[k]), device=device)
             for k in ("src_loc", "rows_loc", "send_idx", "recv_idx", "gather_index")}
        if (
            vb.shape != (D + 1,)
            or vb[0] != 0
            or vb[-1] != n
            or t["send_idx"].shape != (S, D, H)
            or t["recv_idx"].shape != (S, D, D * H)
            or t["gather_index"].shape != (D, L)
            or t["src_loc"].shape[:3] != (D, S, P_loc)
            or t["rows_loc"].shape != (D, S, P_loc, delta)
            or any(v.dtype != torch.int32 for v in t.values())
        ):
            raise ValueError("plan arrays inconsistent with (S, D, H, L)")
        owned_flat, dump_last = _derived_tensors(vb, L, t["recv_idx"])
        if not torch.equal(t["gather_index"].reshape(-1)[owned_flat.long()],
                           torch.arange(n, dtype=torch.int32, device=device)):
            raise ValueError("plan gather_index disagrees with its vertex bounds")
        return cls(
            D=D,
            P_loc=P_loc,
            L=L,
            H=H,
            S=S,
            delta=delta,
            n=n,
            vertex_bounds=vb,
            halo_sizes=np.asarray(arrays["halo_sizes"], dtype=np.int64),
            boundary_entries_per_round=int(arrays["boundary_entries_per_round"]),
            owned_flat=owned_flat,
            dump_last=dump_last,
            **t,
        )

    def halo_bytes_per_round(self, bytes_per_elem: int = 4) -> int:
        """Bytes each shard receives a round from the halo exchanges."""
        return self.S * self.D * self.H * bytes_per_elem

    def replicated_bytes_per_round(self, bytes_per_elem: int = 4) -> int:
        """The replicated flush's bytes for the same round (S·P·δ elements)."""
        return self.S * self.D * self.P_loc * self.delta * bytes_per_elem

    def scatter_x(self, x_ext) -> torch.Tensor:
        """Replicated ``(n + 1,)+feat`` frontier → stacked ``(D, L)+feat``
        local view."""
        return _take_rows(x_ext, self.gather_index)

    def gather_x(self, x_loc, dump=None) -> torch.Tensor:
        """Stacked ``(D, L)+feat`` local view → ``(n + 1,)+feat`` global
        frontier.

        The dump row is ``dump`` if given, else the last local slot's."""
        flat = x_loc.reshape((-1,) + tuple(x_loc.shape[2:]))
        if dump is None:
            dump = flat[-1:]
        return torch.cat([_take_rows(flat, self.owned_flat), dump])


# FrontierPlan fields never stored: derived from the others, and the shard
# range (a stored plan is whole).
_DERIVED = ("owned_flat", "dump_last", "d0")


def _derived_tensors(vertex_bounds: np.ndarray, L: int, recv_idx: torch.Tensor, d0: int = 0) -> tuple:
    """A plan's derived tensors, on ``recv_idx``'s device: ``owned_flat``,
    the flat ``(D·L)`` slot owning each vertex (shard ``d`` keeps its owned
    block first), and ``dump_last`` ``(S, D)``, per (step, receiving shard)
    the last ``recv_idx`` entry that lands in the dump slot ``L - 1`` (-1:
    none).  A rank's plan (``recv_idx`` of shards ``[d0, d0 + D_r)``) gets
    those shards' alone."""
    device = recv_idx.device
    owned = np.diff(vertex_bounds)[d0 : d0 + recv_idx.shape[1]]
    owned_flat = torch.cat([
        d * L + torch.arange(int(o), dtype=torch.int32, device=device) for d, o in enumerate(owned)
    ])
    m = torch.arange(recv_idx.shape[-1], dtype=torch.int32, device=device)
    dump_last = torch.where(recv_idx == L - 1, m, torch.full_like(m, -1)).amax(dim=2)
    return owned_flat, dump_last.to(torch.int32)


# One element of these dtypes holds a whole 4-, 8- or 16-byte row.
_ROW_DTYPES = {4: torch.int32, 8: torch.int64, 16: torch.complex128}


def _take_rows(x, idx) -> torch.Tensor:
    """``x[idx]`` for the rows of ``x`` (``(m,)+feat``): ``idx.shape+feat``.

    A matrix row of 4, 8 or 16 bytes (F = 4 float32 values: 16) is gathered
    as one element of a dtype that wide, a bit-exact copy: indexing the rows
    of an ``(m, F)`` tensor, or ``index_select`` on it, runs tens of times
    slower on the card than indexing a vector of as many bytes, and made a
    matrix halo round's scatter and gather several times its kernel.  A
    wider row of a multiple of 16 bytes (a batch's Q·F values) is gathered
    as that many 16-byte elements of a flat vector.
    """
    feat = tuple(x.shape[1:])
    nbytes = x.element_size() * int(np.prod(feat))
    wide = _ROW_DTYPES.get(nbytes)
    if not feat or not x.is_contiguous() or (x.storage_offset() * x.element_size()) % 16:
        return x[idx]
    if wide is not None:
        rows = x.reshape(x.shape[0], -1).view(wide)[:, 0]
        return rows[idx].view(x.dtype).reshape(tuple(idx.shape) + feat)
    if nbytes % 16:
        return x[idx]
    k = nbytes // 16
    flat = x.reshape(-1).view(torch.complex128)
    at = (idx.long().reshape(-1, 1) * k + torch.arange(k, device=idx.device)).reshape(-1)
    return flat[at].view(x.dtype).reshape(tuple(idx.shape) + feat)


def plan_shard_bounds(sched: DeviceSchedule, n_shards: int) -> np.ndarray:
    """Shard vertex bounds ``(D + 1,)``: every ``P_loc``-th worker bound."""
    if sched.block_bounds is None:
        raise ValueError("sched has no block_bounds (rebuild via make_schedule)")
    D = int(n_shards)
    if sched.P % D != 0:
        raise ValueError(f"P={sched.P} not divisible by D={D}")
    vb = np.asarray(sched.block_bounds, dtype=np.int64)[:: sched.P // D]
    assert vb.shape == (D + 1,) and vb[-1] == sched.n
    return vb


def build_plan_shard(
    sched: DeviceSchedule, vb_lo: int, vb_hi: int, w0: int, w1: int
) -> dict:
    """One shard's plan piece (host numpy): its halo and local index arrays.

    Reads only the shard's workers ``[w0, w1)`` of the schedule and its owned
    interval ``[vb_lo, vb_hi)`` (:func:`plan_shard_from_cells`).
    """
    return plan_shard_from_cells(
        sched.src[:, w0:w1].cpu().numpy(),
        sched.dst_local[:, w0:w1].cpu().numpy(),
        sched.rows[:, w0:w1].cpu().numpy(),
        sched.n,
        sched.delta,
        vb_lo,
        vb_hi,
    )


def plan_shard_from_cells(src, dst_local, rows, n: int, delta: int, vb_lo: int, vb_hi: int) -> dict:
    """One shard's plan piece from its workers' host cells ``(S, P_loc, ·)``.

    Dump slots are ``-1``: the real dump index ``L - 1`` depends on every
    shard's halo size and is filled in by :func:`assemble_frontier_plan`.
    Membership goes through tables over the ``n`` vertices, so the cost is
    linear in the shard's edges.
    """
    real = dst_local < delta
    own = real & (src >= vb_lo) & (src < vb_hi)
    rem = real & ~own
    in_halo = np.zeros(n, dtype=bool)
    in_halo[src[rem]] = True
    halo = np.flatnonzero(in_halo)  # sorted global ids, int64
    slot = np.zeros(n, dtype=np.int32)
    slot[halo] = (vb_hi - vb_lo) + np.arange(halo.size, dtype=np.int32)

    loc = np.full(src.shape, -1, dtype=np.int32)
    loc[own] = src[own] - vb_lo
    loc[rem] = slot[src[rem]]
    rows_loc = np.where(rows >= n, -1, rows - vb_lo).astype(np.int32)
    return {"halo": halo, "src_loc": loc, "rows_loc": rows_loc}


def shard_halos(graph: CSRGraph, vertex_bounds) -> list:
    """Every shard's halo (sorted global ids) from the graph on the host: the
    sources of its owned rows' in-edges outside its owned range, which are
    what :func:`build_plan_shard` reads from the schedule's real edges."""
    vb = np.asarray(vertex_bounds, dtype=np.int64)
    indptr, indices = graph.indptr, graph.indices
    halos = []
    for d in range(vb.size - 1):
        lo, hi = int(vb[d]), int(vb[d + 1])
        in_halo = np.zeros(graph.n, dtype=bool)
        in_halo[indices[indptr[lo] : indptr[hi]]] = True
        in_halo[lo:hi] = False
        halos.append(np.flatnonzero(in_halo))
    return halos


def schedule_rows(block_bounds, S: int, delta: int, n: int) -> np.ndarray:
    """The schedule's ``(S, P, δ)`` int32 ``rows`` from its block bounds
    alone (row ``r`` of worker ``w``'s chunk ``s`` is ``lo_w + s·δ + r``
    inside the block, else the dump id ``n``), as the stripe builder lays
    them out."""
    bb = np.asarray(block_bounds, dtype=np.int64)
    lo, hi = bb[:-1][None, :, None], bb[1:][None, :, None]
    base = lo + np.arange(S, dtype=np.int64)[:, None, None] * delta + np.arange(delta, dtype=np.int64)
    return np.where(base < hi, base, n).astype(np.int32)


def make_frontier_plan(sched: DeviceSchedule, n_shards: int, device=None) -> FrontierPlan:
    """The owner-computes halo plan for ``sched`` over ``n_shards``, with its
    tensors on ``device`` (default: the schedule's).

    Shard ``d``'s halo is every real source vertex its workers gather that
    lies outside its owned range, read from the schedule's own edge lists.
    """
    D = int(n_shards)
    vb = plan_shard_bounds(sched, D)
    P_loc = sched.P // D
    pieces = [
        build_plan_shard(sched, int(vb[d]), int(vb[d + 1]), d * P_loc, (d + 1) * P_loc)
        for d in range(D)
    ]
    return assemble_frontier_plan(sched, D, pieces, device)


def assemble_frontier_plan(
    sched: DeviceSchedule, n_shards: int, pieces: list, device=None
) -> FrontierPlan:
    """Stitch the shards' pieces into a :class:`FrontierPlan`.

    ``L``, ``H`` and the send/recv indices are computed here from the halos
    and the schedule's rows.  Which committed rows a shard ships is one
    lookup in a boolean table over ``n + 1`` slots (the dump id ``n`` is
    never a boundary row); the reference's per-(step, shard) ``np.isin``
    gives the same arrays.
    """
    return _assemble(sched, int(n_shards), 0, pieces, [p["halo"] for p in pieces], device)


def _assemble(sched, D: int, d0: int, pieces: list, halos: list, device) -> FrontierPlan:
    """The plan of shards ``[d0, d0 + len(pieces))`` from their pieces and
    every shard's halo; the global ``(S, P, δ)`` rows come from the block
    bounds (:func:`schedule_rows`), which a rank's schedule holds too."""
    S, delta, n = sched.S, sched.delta, sched.n
    rows_all = schedule_rows(sched.block_bounds, S, delta, n)
    P_loc = sched.P // D
    d1 = d0 + len(pieces)
    vb = plan_shard_bounds(sched, D)
    owned = np.diff(vb)
    device = sched.device if device is None else device

    halo = [np.asarray(h, dtype=np.int64) for h in halos]
    halo_sizes = np.array([h.size for h in halo], dtype=np.int64)
    L = int((owned + halo_sizes).max()) + 1
    dump = L - 1

    D_r = d1 - d0
    src_loc = np.empty((D_r, S, P_loc, sched.M), dtype=np.int32)
    rows_loc = np.empty((D_r, S, P_loc, delta), dtype=np.int32)
    for i, p in enumerate(pieces):
        src_loc[i] = np.where(p["src_loc"] < 0, dump, p["src_loc"])
        rows_loc[i] = np.where(p["rows_loc"] < 0, dump, p["rows_loc"])

    # Boundary traffic: per (step, shard), the committed rows some other
    # shard keeps a halo copy of, in chunk order.  H pads to the worst cell.
    is_boundary = np.zeros(n + 1, dtype=bool)
    for h in halo:
        is_boundary[h] = True
    chunks = rows_all.reshape(S, D, P_loc * delta)
    member = is_boundary[chunks]
    counts = member.sum(axis=2)
    H = max(1, int(counts.max()))
    s_i, d_i, pos = np.nonzero(member)  # (s, d)-major, positions ascending
    first = np.cumsum(counts.reshape(-1)) - counts.reshape(-1)
    k = np.arange(s_i.size) - first[s_i * D + d_i]  # rank within its cell

    send_idx = np.zeros((S, D, H), dtype=np.int32)
    send_idx[s_i, d_i, k] = pos
    recv_idx = np.full((S, D_r, D * H), dump, dtype=np.int32)
    shipped = chunks[s_i, d_i, pos]  # global vertex of each shipped row
    for e in range(d0, d1):
        slot = np.full(n + 1, -1, dtype=np.int64)
        slot[halo[e]] = owned[e] + np.arange(halo[e].size)
        hit_slot = slot[shipped]
        hit = (hit_slot >= 0) & (d_i != e)
        recv_idx[s_i[hit], e - d0, d_i[hit] * H + k[hit]] = hit_slot[hit]

    gather_index = np.full((D_r, L), n, dtype=np.int32)  # unused slots → dump
    for e in range(d0, d1):
        gather_index[e - d0, : owned[e]] = np.arange(vb[e], vb[e + 1])
        gather_index[e - d0, owned[e] : owned[e] + halo[e].size] = halo[e]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    recv = t(recv_idx)
    owned_flat, dump_last = _derived_tensors(vb, L, recv, d0)

    return FrontierPlan(
        D=D,
        P_loc=P_loc,
        L=L,
        H=H,
        S=S,
        delta=delta,
        n=n,
        vertex_bounds=vb,
        halo_sizes=halo_sizes,
        boundary_entries_per_round=int(counts.sum()),
        src_loc=t(src_loc),
        rows_loc=t(rows_loc),
        send_idx=t(send_idx[:, d0:d1]),
        recv_idx=recv,
        gather_index=t(gather_index),
        owned_flat=owned_flat,
        dump_last=dump_last,
        d0=d0,
    )


def frontier_ef_init(plan: FrontierPlan, feat: tuple = ()) -> torch.Tensor:
    """Zero error-feedback residuals ``(D, S, H)+feat`` f32, one per (shard,
    commit step, boundary row): what the quantizer could not represent this
    round is added back to the same row's value the next round."""
    return torch.zeros(
        (plan.D, plan.S, plan.H) + tuple(feat),
        dtype=torch.float32,
        device=plan.gather_index.device,
    )


def _check_plan(sched: DeviceSchedule, plan: FrontierPlan) -> None:
    if plan.S != sched.S or plan.delta != sched.delta:
        raise ValueError("plan built for another schedule")


def frontier_sharded_round_fn(
    sched: DeviceSchedule, plan: FrontierPlan, semiring: Semiring, row_update
) -> Callable:
    """The plain owner-computes round ``x_loc -> x_loc`` over the stacked
    ``(D, L)+feat`` frontier, in place.  ``row_update(old, reduced, rows)`` sees
    global rows."""
    _check_plan(sched, plan)
    return lambda x_loc: ref.fused_halo_round_ref(x_loc, None, sched, plan, semiring, row_update)[0]


def frontier_round_ext_fn(
    sched: DeviceSchedule, plan: FrontierPlan, semiring: Semiring, row_update
) -> Callable:
    """Global-frontier view of the plain halo round: ``x_ext -> x_ext``.

    Scatters ``x_ext`` into the owner-computes layout, runs one halo round
    and gathers the owned entries back; the dump slot passes through."""
    rnd = frontier_sharded_round_fn(sched, plan, semiring, row_update)
    return lambda x_ext: plan.gather_x(rnd(plan.scatter_x(x_ext)), dump=x_ext[-1:])


def frontier_kernel_round_fn(
    sched: DeviceSchedule,
    plan: FrontierPlan,
    semiring: Semiring,
    row_update,
    halo_dtype: str = "f32",
) -> Callable:
    """The K2 round ``(x_loc, ef) -> (x_loc, ef)``, in place: the whole
    round is one :func:`repro_torch.kernels.ops.fused_halo_round` (one
    launch on CUDA).  ``halo_dtype="f32"`` equals the plain round bit for
    bit and leaves ``ef`` at zero; ``"int8"`` / ``"fp8"`` quantize the
    shipped rows against the residuals ``ef`` (:func:`frontier_ef_init`),
    which the caller carries across rounds."""
    resolve_halo_dtype(halo_dtype, semiring)
    _check_plan(sched, plan)
    return lambda x_loc, ef: ops.fused_halo_round(
        x_loc, ef, sched, plan, semiring, row_update, halo_dtype
    )


def frontier_kernel_round_ext_fn(
    sched: DeviceSchedule,
    plan: FrontierPlan,
    semiring: Semiring,
    row_update,
    halo_dtype: str = "f32",
) -> Callable:
    """Global-frontier view of the K2 round: ``(x_ext, ef) -> (x_ext, ef)``,
    out of place, with the error-feedback residuals threaded through (``ef``
    from :func:`frontier_ef_init` with the frontier's ``feat``)."""
    rnd = frontier_kernel_round_fn(sched, plan, semiring, row_update, halo_dtype)

    def fn(x_ext, ef):
        x_loc, ef = rnd(plan.scatter_x(x_ext), ef.clone())
        return plan.gather_x(x_loc, dump=x_ext[-1:]), ef

    return fn


# --------------------------------------------------------------------------- #
# a rank's shards: its schedule cells, and the round across processes
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RankSchedule:
    """A rank's view of a schedule: its workers ``[w0, w1)``'s cells.

    ``val``, ``dst_local`` ``(S, P_r, M)``, ``rows`` ``(S, P_r, δ)`` and
    ``row_ptr`` ``(S, P_r, δ + 1)`` with ``P_r = w1 - w0``, on the rank's
    device.  On the halo frontier the gathers read the plan's local slots
    (``src_loc``), so the global ``src`` stays on the host and ``src`` and
    ``rows_all`` are None; on the replicated frontier (:func:`replicated_rank`)
    ``src`` ``(S, P_r, M)`` and every worker's rows ``rows_all`` ``(S, P,
    δ)`` are on the device too.  ``n``, ``P``, ``S``, ``M``, ``δ`` and the
    block bounds are the whole schedule's (:func:`rank_schedule`).
    """

    n: int
    P: int
    delta: int
    S: int
    M: int
    w0: int
    w1: int
    val: torch.Tensor
    dst_local: torch.Tensor
    rows: torch.Tensor
    row_ptr: torch.Tensor
    edges: int
    block_bounds: np.ndarray
    src: torch.Tensor | None = None
    rows_all: torch.Tensor | None = None

    @property
    def n_slots(self) -> int:
        return self.n + 1

    @property
    def device(self) -> torch.device:
        return self.val.device


def stripe_width(indptr, lo: int, hi: int, S: int, delta: int) -> int:
    """A worker's widest cell (its stripe's natural ``M_w``), from ``indptr``."""
    s = np.arange(S, dtype=np.int64)
    r0 = np.minimum(lo + s * delta, hi)
    r1 = np.minimum(lo + (s + 1) * delta, hi)
    return int((indptr[r1] - indptr[r0]).max()) if S else 0


def outgrows(indptr, block_bounds, workers, S: int, delta: int, M: int) -> bool:
    """Whether the stripe of any of ``workers`` is wider than ``M``, read
    from ``indptr`` (no stripe is built, so every process decides alike)."""
    bb = block_bounds
    return any(stripe_width(indptr, int(bb[w]), int(bb[w + 1]), S, delta) > M for w in workers)


def patch_cells(cells: dict, stripes: dict, pad_val, delta: int, w0: int = 0) -> dict:
    """Copies of ``cells`` (any of a schedule's ``src``, ``val`` and
    ``dst_local``, ``(S, P_c, M)`` tensors or host arrays) with the stripe
    of worker ``w`` (``stripes[w]``, :func:`build_worker_stripe`'s arrays)
    written at index ``w - w0`` and its tail padded as the schedule pads it
    (``src`` 0, ``val`` ``pad_val``, ``dst_local`` δ).  Every stripe must
    fit ``M`` and index a worker of the cells."""
    fill = {"src": 0, "val": pad_val.item(), "dst_local": delta}
    out = {f: a.clone() if torch.is_tensor(a) else a.copy() for f, a in cells.items()}
    for w, st in stripes.items():
        i, m = w - w0, st["src"].shape[1]
        for f, a in out.items():
            if not 0 <= i < a.shape[1] or m > a.shape[2]:
                raise ValueError(f"worker {w}'s stripe of width {m} does not fit the cells")
            a[:, i] = fill[f]
            a[:, i, :m] = torch.from_numpy(st[f]).to(a.device, a.dtype) if torch.is_tensor(a) else st[f]
    return out


def rank_schedule(graph: CSRGraph, block_bounds, delta: int, pad_val, w0: int, w1: int, device,
                  stripe: Callable | None = None) -> tuple:
    """The cells of workers ``[w0, w1)`` of the schedule
    :func:`repro_torch.core.engine.make_schedule` builds at ``delta`` over
    ``block_bounds``, built from those workers' stripes alone (the global
    ``M`` from ``indptr``).  ``stripe(lo, hi, S, δ)`` gives a worker's
    stripe (default: :func:`build_worker_stripe` of ``graph``; a solver
    with a store loads it from there).  Returns ``(RankSchedule on device,
    host arrays)``: the host ``src``, ``dst_local`` and ``rows`` of those
    workers, from which the rank's plan pieces are cut."""
    bb = np.asarray(block_bounds, dtype=np.int64)
    B = int(np.diff(bb).max())
    delta = int(min(max(int(delta), 1), B))
    S = -(-B // delta)
    P = bb.size - 1
    M = max(1, max(stripe_width(graph.indptr, int(bb[w]), int(bb[w + 1]), S, delta) for w in range(P)))
    P_r = w1 - w0
    src = np.zeros((S, P_r, M), dtype=np.int32)
    val = np.full((S, P_r, M), pad_val, dtype=graph.values.dtype)
    dst_local = np.full((S, P_r, M), delta, dtype=np.int32)
    rows = np.full((S, P_r, delta), graph.n, dtype=np.int32)
    if stripe is None:
        def stripe(lo, hi, S, delta):
            return build_worker_stripe(graph, lo, hi, S, delta, pad_val)

    for i, w in enumerate(range(w0, w1)):
        st = stripe(int(bb[w]), int(bb[w + 1]), S, delta)
        m = st["src"].shape[1]
        src[:, i, :m] = st["src"]
        val[:, i, :m] = st["val"]
        dst_local[:, i, :m] = st["dst_local"]
        rows[:, i] = st["rows"]
    dst_t = torch.from_numpy(dst_local).to(device)
    sched = RankSchedule(
        n=graph.n,
        P=P,
        delta=delta,
        S=S,
        M=M,
        w0=w0,
        w1=w1,
        val=torch.from_numpy(val).to(device),
        dst_local=dst_t,
        rows=torch.from_numpy(rows).to(device),
        row_ptr=_cell_row_ptr(dst_t, delta),
        edges=graph.nnz,
        block_bounds=bb,
    )
    return sched, {"src": src, "dst_local": dst_local, "rows": rows}


def patch_rank_cells(sched: RankSchedule, host: dict, stripes: dict, pad_val, edges: int) -> tuple:
    """``(sched, host)`` (:func:`rank_schedule`'s) with the stripes of some
    of the rank's workers replaced (:func:`patch_cells`): copies of the
    device ``val`` and ``dst_local`` and of the host ``src`` and
    ``dst_local``, ``row_ptr`` derived again from the patched ``dst_local``
    (the kernels walk the edges through it).  ``rows`` depend on the block
    bounds alone and stay.  The cells of the other workers, and their
    shapes, are unchanged."""
    dev = patch_cells({"val": sched.val, "dst_local": sched.dst_local}, stripes, pad_val, sched.delta, sched.w0)
    host = {**host, **patch_cells({"src": host["src"], "dst_local": host["dst_local"]}, stripes, pad_val,
                                  sched.delta, sched.w0)}
    patched = dataclasses.replace(sched, **dev, row_ptr=_cell_row_ptr(dev["dst_local"], sched.delta),
                                  edges=int(edges), src=None, rows_all=None)
    return patched, host


def replicated_rank(sched: RankSchedule, host: dict) -> RankSchedule:
    """The rank's cells for the replicated frontier: ``sched`` with its
    workers' ``src`` (``host``, :func:`rank_schedule`'s) and every worker's
    rows (:func:`schedule_rows`, from the block bounds) on its device."""
    rows_all = schedule_rows(sched.block_bounds, sched.S, sched.delta, sched.n)
    return dataclasses.replace(
        sched,
        src=torch.from_numpy(np.ascontiguousarray(host["src"])).to(sched.device),
        rows_all=torch.from_numpy(rows_all).to(sched.device),
    )


def rank_cells(sched: DeviceSchedule, w0: int, w1: int) -> RankSchedule:
    """The replicated :class:`RankSchedule` of workers ``[w0, w1)`` cut from
    a whole schedule (contiguous copies on its device): the arrays a rank
    would build for itself (:func:`rank_schedule`, :func:`replicated_rank`)."""
    if not 0 <= w0 < w1 <= sched.P:
        raise ValueError(f"workers [{w0}, {w1}) are not within [0, {sched.P})")
    w = slice(w0, w1)
    return RankSchedule(
        n=sched.n, P=sched.P, delta=sched.delta, S=sched.S, M=sched.M, w0=w0, w1=w1,
        val=sched.val[:, w].contiguous(), dst_local=sched.dst_local[:, w].contiguous(),
        rows=sched.rows[:, w].contiguous(), row_ptr=sched.row_ptr[:, w].contiguous(), edges=sched.edges,
        block_bounds=np.asarray(sched.block_bounds, dtype=np.int64), src=sched.src[:, w].contiguous(),
        rows_all=sched.rows,
    )


def replicated_rank_round_fn(sched: RankSchedule, rows, semiring: Semiring, row_update, group,
                             plain: bool = False) -> Callable:
    """One rank's replicated round ``x_ext -> x_ext`` (out of place) over
    the whole ``(n + 1,)+feat`` frontier (``feat`` may be a batch's ``(Q,)``
    or ``(Q, F)``), collectively over ``group``
    (:class:`repro_torch.dist.comm.HaloGroup`), the counterpart of the
    reference's ``sharded_round_fn_q``.  Each commit step is K1's rank step
    over the rank's workers (:func:`repro_torch.kernels.ops.round_rank_step`,
    ``sched`` a :func:`replicated_rank` layout), the group's all-gather of
    every rank's ``(P/W·δ,)+feat`` new rows in worker order, and K1's
    publish of them at ``rows[s]`` (``rows`` the global ``(S, P, δ)`` rows;
    :func:`repro_torch.kernels.ops.round_publish`); ``plain`` runs the plain
    versions instead.  The reference gathers ``rows`` too; here every rank
    holds them, so only values cross.  Over all ranks a round equals the
    one-process round (:func:`repro_torch.kernels.ref.fused_round_ref`, K1's
    ``round_kernel`` on the card) bit for bit."""
    if sched.src is None:
        raise ValueError("the replicated rank round needs the rank's src (replicated_rank)")
    if (sched.w0, sched.w1) != group.split(sched.P, "workers"):
        raise ValueError(f"the schedule holds workers [{sched.w0}, {sched.w1}), the rank "
                         f"{list(group.split(sched.P, 'workers'))}")
    if tuple(rows.shape) != (sched.S, sched.P, sched.delta):
        raise ValueError(f"rows must be ({sched.S}, {sched.P}, {sched.delta}), got {tuple(rows.shape)}")
    step = ref.round_rank_step_ref if plain else ops.round_rank_step
    publish = ref.round_publish_ref if plain else ops.round_publish

    def rnd(x_ext):
        x = x_ext.clone()
        for s in range(sched.S):
            publish(x, group.all_gather(step(x, sched, semiring, row_update, s)), rows, s)
        return x

    return rnd


def rank_plan(graph: CSRGraph, sched: RankSchedule, host: dict, n_shards: int, device=None,
              piece: Callable | None = None) -> FrontierPlan:
    """The plan of the rank's shards (those of its workers ``[w0, w1)``),
    from its own cells (``host``, :func:`rank_schedule`'s) and every
    shard's halo read from the graph (:meth:`FrontierPlan.for_shards`).
    ``piece(src, dst_local, rows, vb_lo, vb_hi)`` gives a shard's piece from
    its workers' host cells (default: :func:`plan_shard_from_cells`; a
    solver with a store loads it from there)."""
    D = int(n_shards)
    P_loc = sched.P // D
    if sched.w0 % P_loc or sched.w1 % P_loc:
        raise ValueError(f"workers [{sched.w0}, {sched.w1}) are not whole shards of {P_loc}")
    d0, d1 = sched.w0 // P_loc, sched.w1 // P_loc
    vb = plan_shard_bounds(sched, D)
    if piece is None:
        def piece(src, dst_local, rows, vb_lo, vb_hi):
            return plan_shard_from_cells(src, dst_local, rows, sched.n, sched.delta, vb_lo, vb_hi)

    pieces = []
    for d in range(d0, d1):
        w = slice((d - d0) * P_loc, (d - d0 + 1) * P_loc)
        pieces.append(piece(host["src"][:, w], host["dst_local"][:, w], host["rows"][:, w], int(vb[d]), int(vb[d + 1])))
    return FrontierPlan.for_shards(sched, D, d0, d1, pieces, shard_halos(graph, vb), device)


def frontier_rank_round_fn(sched, plan: FrontierPlan, semiring: Semiring, row_update, group,
                           halo_dtype: str = "f32", plain: bool = False) -> Callable:
    """One rank's halo round ``(x_loc, ef) -> (x_loc, ef)``, in place on its
    shards' ``(d1 - d0, L)+feat`` frontier and ``(d1 - d0, S, H)+feat``
    residuals, collectively over ``group``
    (:class:`repro_torch.dist.comm.HaloGroup`).  Each commit step is K2's
    rank entry over the rank's shards
    (:func:`repro_torch.kernels.ops.halo_local_step`), the group's
    all-gather of the send blocks (and scales) in shard order, and K2's
    receive (:func:`repro_torch.kernels.ops.halo_recv`); ``plain`` runs the
    plain versions instead.  Over all ranks a round equals the
    one-process K2 round (:func:`frontier_kernel_round_ext_fn`) bit for
    bit.

    That round starts from the global frontier scattered into the layout,
    so its halo copies start each round at their owners' exact values and
    its dump slots at the frontier's dump row, the ⊕-identity.  On the f32
    wire a rank's halo copies already hold them; an int8/fp8 wire leaves
    them at the dequantized values, so a quantized round starts with one
    more all-gather, of the ``(S, H)+feat`` exact boundary rows of every
    shard, written into the halo slots (and the dump slots reset)."""
    resolve_halo_dtype(halo_dtype, semiring)
    if (plan.S, plan.delta) != (sched.S, sched.delta):
        raise ValueError("plan built for another schedule")
    if (plan.d0, plan.d1) != group.split(plan.D):
        raise ValueError(f"plan holds shards [{plan.d0}, {plan.d1}), the rank {list(group.split(plan.D))}")
    local = ref.halo_local_step_ref if plain else ops.halo_local_step
    recv = ref.halo_recv_ref if plain else ops.halo_recv
    d0, d1 = plan.d0, plan.d1
    refresh = None if halo_dtype == "f32" else _halo_refresh(plan, semiring, group)

    def rnd(x_loc, ef):
        if refresh is not None:
            refresh(x_loc)
        for s in range(sched.S):
            rows, scales = local(x_loc, ef, sched, plan, semiring, row_update, halo_dtype, s, d0, d1)
            rows = group.all_gather(rows)
            if scales is not None:
                scales = group.all_gather(scales)
            recv(x_loc, rows, scales, plan, s, d0, d1)
        return x_loc, ef

    return rnd


def frontier_rank_batch_round_fn(sched, plan: FrontierPlan, semiring: Semiring, epilogue, group,
                                 plain: bool = False) -> Callable:
    """One rank's halo round of a batch, ``X_loc -> X_loc`` (out of place)
    over its shards' ``(d1 - d0, L, Q)+feat`` batch frontier: the f32 round
    of :func:`frontier_rank_round_fn`, K2's rank entry and receive taking a
    row's Q·F values (``epilogue`` an ``Epilogue.for_batch`` row update).
    The reference's vmapped ``frontier_round_ext_fn`` across processes."""
    rnd = frontier_rank_round_fn(sched, plan, semiring, epilogue, group, "f32", plain)
    return lambda X_loc: rnd(X_loc.clone(), None)[0]


def _halo_refresh(plan: FrontierPlan, semiring: Semiring, group) -> Callable:
    """``x_loc -> None``: every held shard's halo slots set to their
    owners' exact values, and its dump slot to the ⊕-identity, in place
    (one all-gather).  Owner ``d``'s boundary row ``(s, k)`` is its owned
    slot ``rows_loc[d, s, send_idx[s, d, k]]``; the receiver writes it where
    step ``s``'s exchange does."""
    D_r, S, H, L = plan.d1 - plan.d0, plan.S, plan.H, plan.L
    chunk = plan.rows_loc.reshape(D_r, S, -1)
    slots = torch.gather(chunk, 2, plan.send_idx.permute(1, 0, 2).long()).long()  # (D_r, S, H)
    dest = plan.recv_idx.permute(1, 0, 2).reshape(D_r, -1).long()  # (D_r, S·D·H)
    keep = dest < L - 1
    zero = semiring.zero.item()

    def refresh(x_loc):
        feat = tuple(x_loc.shape[2:])
        exact = torch.stack([x_loc[i][slots[i].reshape(-1)] for i in range(D_r)])  # (D_r, S·H)+feat
        every = group.all_gather(exact).reshape((plan.D, S, H) + feat)
        rows = every.permute((1, 0, 2) + tuple(range(3, 3 + len(feat)))).reshape((-1,) + feat)  # (S·D·H)+feat
        for i in range(D_r):
            x_loc[i][dest[i][keep[i]]] = rows[keep[i]]
        x_loc[:, L - 1] = zero

    return refresh


def frontier_batch_round_fn(
    sched: DeviceSchedule, plan: FrontierPlan, semiring: Semiring, epilogue, plain: bool = False
) -> Callable:
    """The halo round of a batch, ``X_ext -> X_ext`` over the ``(n + 1,
    Q)+feat`` batch frontier: scattered into the ``(D, L, Q)+feat`` layout
    (:meth:`FrontierPlan.scatter_x`), one round of K2's batch entry
    (:func:`repro_torch.kernels.ops.fused_halo_batch_round`; ``plain``: its
    plain version), gathered back (the dump row passes through).  The
    reference's vmapped ``frontier_round_ext_fn``; f32/int32 wire only."""
    _check_plan(sched, plan)
    rnd = ref.fused_halo_batch_round_ref if plain else ops.fused_halo_batch_round

    def fn(X):
        X_loc = rnd(plan.scatter_x(X), sched, plan, semiring, epilogue)
        return plan.gather_x(X_loc, dump=X[-1:])

    return fn
