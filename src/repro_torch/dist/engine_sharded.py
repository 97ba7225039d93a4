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

The plan is built on the host from the schedule's numpy arrays and equals
the reference's plan array for array.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.engine import DeviceSchedule
from repro_torch.core.semiring import Semiring
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import halo_exchange, quantize_halo

__all__ = [
    "FrontierPlan",
    "HALO_DTYPES",
    "assemble_frontier_plan",
    "build_plan_shard",
    "frontier_ef_init",
    "frontier_kernel_round_ext_fn",
    "frontier_kernel_round_fn",
    "frontier_round_ext_fn",
    "frontier_sharded_round_fn",
    "halo_exchange",
    "make_frontier_plan",
    "plan_shard_bounds",
    "quantize_halo",
    "resolve_halo_dtype",
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


# FrontierPlan fields derived from the others, never stored.
_DERIVED = ("owned_flat", "dump_last")


def _derived_tensors(vertex_bounds: np.ndarray, L: int, recv_idx: torch.Tensor) -> tuple:
    """A plan's derived tensors, on ``recv_idx``'s device: ``owned_flat``
    ``(n,)``, the flat ``(D·L)`` slot owning each vertex (shard ``d`` keeps
    its owned block first), and ``dump_last`` ``(S, D)``, per (step,
    receiving shard) the last ``recv_idx`` entry that lands in the dump slot
    ``L - 1`` (-1: none)."""
    device = recv_idx.device
    owned = np.diff(vertex_bounds)
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
    matrix halo round's scatter and gather several times its kernel.
    """
    feat = tuple(x.shape[1:])
    wide = _ROW_DTYPES.get(x.element_size() * int(np.prod(feat)))
    if not feat or wide is None or not x.is_contiguous():
        return x[idx]
    rows = x.reshape(x.shape[0], -1).view(wide)[:, 0]
    return rows[idx].view(x.dtype).reshape(tuple(idx.shape) + feat)


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
    interval ``[vb_lo, vb_hi)``.  Dump slots are ``-1``: the real dump index
    ``L - 1`` depends on every shard's halo size and is filled in by
    :func:`assemble_frontier_plan`.  Membership goes through tables over the
    ``n`` vertices, so the cost is linear in the shard's edges.
    """
    n = sched.n
    src = sched.src[:, w0:w1].cpu().numpy()
    real = sched.dst_local[:, w0:w1].cpu().numpy() < sched.delta
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
    rows = sched.rows[:, w0:w1].cpu().numpy()
    rows_loc = np.where(rows >= n, -1, rows - vb_lo).astype(np.int32)
    return {"halo": halo, "src_loc": loc, "rows_loc": rows_loc}


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
    S, delta, n, D = sched.S, sched.delta, sched.n, int(n_shards)
    P_loc = sched.P // D
    vb = plan_shard_bounds(sched, D)
    owned = np.diff(vb)
    device = sched.device if device is None else device

    halo = [np.asarray(p["halo"], dtype=np.int64) for p in pieces]
    halo_sizes = np.array([h.size for h in halo], dtype=np.int64)
    L = int((owned + halo_sizes).max()) + 1
    dump = L - 1

    src_loc = np.empty((D, S, P_loc, sched.M), dtype=np.int32)
    rows_loc = np.empty((D, S, P_loc, delta), dtype=np.int32)
    for d, p in enumerate(pieces):
        src_loc[d] = np.where(p["src_loc"] < 0, dump, p["src_loc"])
        rows_loc[d] = np.where(p["rows_loc"] < 0, dump, p["rows_loc"])

    # Boundary traffic: per (step, shard), the committed rows some other
    # shard keeps a halo copy of, in chunk order.  H pads to the worst cell.
    is_boundary = np.zeros(n + 1, dtype=bool)
    for h in halo:
        is_boundary[h] = True
    chunks = sched.rows.cpu().numpy().reshape(S, D, P_loc * delta)
    member = is_boundary[chunks]
    counts = member.sum(axis=2)
    H = max(1, int(counts.max()))
    s_i, d_i, pos = np.nonzero(member)  # (s, d)-major, positions ascending
    first = np.cumsum(counts.reshape(-1)) - counts.reshape(-1)
    k = np.arange(s_i.size) - first[s_i * D + d_i]  # rank within its cell

    send_idx = np.zeros((S, D, H), dtype=np.int32)
    send_idx[s_i, d_i, k] = pos
    recv_idx = np.full((S, D, D * H), dump, dtype=np.int32)
    shipped = chunks[s_i, d_i, pos]  # global vertex of each shipped row
    for e in range(D):
        slot = np.full(n + 1, -1, dtype=np.int64)
        slot[halo[e]] = owned[e] + np.arange(halo[e].size)
        hit_slot = slot[shipped]
        hit = (hit_slot >= 0) & (d_i != e)
        recv_idx[s_i[hit], e, d_i[hit] * H + k[hit]] = hit_slot[hit]

    gather_index = np.full((D, L), n, dtype=np.int32)  # unused slots → dump
    for d in range(D):
        gather_index[d, : owned[d]] = np.arange(vb[d], vb[d + 1])
        gather_index[d, owned[d] : owned[d] + halo[d].size] = halo[d]

    def t(a):
        return torch.from_numpy(a).to(device)

    recv = t(recv_idx)
    owned_flat, dump_last = _derived_tensors(vb, L, recv)

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
        send_idx=t(send_idx),
        recv_idx=recv,
        gather_index=t(gather_index),
        owned_flat=owned_flat,
        dump_last=dump_last,
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
