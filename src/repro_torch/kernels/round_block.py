"""K1 and K2 wrappers: the round kernel and the halo round kernel.

K1 (:func:`fused_round_cuda`) is the counterpart of
``repro.kernels.round_block.fused_round_fn_q``.  Its kernel
(``csrc/round_block.cu``) runs the S commit steps of a round inside one
persistent cooperative launch, with two grid barriers per step; a block
stages a tile of rows' edges and folds each row in edge order, so it
computes exactly what :func:`repro_torch.core.engine.round_fn` computes, bit
for bit.

K2 (:func:`fused_halo_round_cuda`) is the counterpart of
``repro.kernels.round_block.fused_halo_step_fn`` together with the exchange
that ``repro.dist.engine_sharded.frontier_pallas_round_fn`` runs between its
calls: a range of commit steps of the owner-computes halo round, for all D
shards of the stacked ``(D, L)`` frontier, in one cooperative launch, with
the boundary rows' exchange (and, for an int8/fp8 wire, their quantization
with error feedback) between grid barriers.  It is a second entry point of
the same source and walks each step's tiles with K1's code, so an f32 halo
round equals K1's round bit for bit.

Both take a vector frontier ``(n+1,)`` or a matrix frontier ``(n+1, F)``
(``(D, L)`` or ``(D, L, F)`` stacked for K2), row-major, so a vertex's F
values are one contiguous row.

K2 has three more entries.  Its batch entry
(:func:`fused_halo_batch_round_cuda`) takes the query axis over a batch
frontier ``(D, L, Q)+feat`` (f32 or int32 wire), as K1's batch entry does.
Its rank entries run one rank of a halo solve over processes, one commit
step a launch: :func:`halo_local_step_cuda` takes the step for the rank's
own shards and writes their send block (for int8/fp8 the 1-byte values and
the scales), and after the group's all-gather :func:`halo_recv_cuda` writes
the gathered rows into the rank's halo slots.  Both together over every
shard are one step of :func:`fused_halo_round_cuda`, bit for bit.

K1's batch entry (:func:`fused_batch_round_cuda`) is the query axis the
reference gets by vmapping ``fused_round_fn_q`` over Q queries
(``repro.solve.batch``): one launch a round for a batch frontier
``(n+1, Q)`` or ``(n+1, Q, F)``, vertex-major, so a vertex's Q·F values are
one row and a tile's edges are walked once for all Q queries.

K1's rank entries run one rank of a replicated solve over processes, one
commit step in two ordinary launches: :func:`round_rank_step_cuda` takes the
step for the rank's own workers, reading the whole frontier, and after the
group's all-gather of every rank's rows :func:`round_publish_cuda` writes
them into the frontier.  Both together over every worker are one step of
:func:`fused_round_cuda`, bit for bit; both take the query axis.

K1's loop entry (:func:`fused_solve_cuda`, :func:`fused_batch_solve_cuda`)
is the loop the reference wraps around ``fused_round_fn_q``
(``repro.core.engine.make_solve_fn_q``, and the batch loops of
``repro.solve.batch``): one launch runs rounds, with K1's step code, until
every query's residual meets ``tol`` as float32 or the round budget is spent,
and the host reads the result back once.

Pallas evaluated any traced ``row_update`` inside the kernel.  The CUDA kernel
takes a fixed set instead: an :class:`Epilogue` names the row update with a
tag the kernel understands.  An ``Epilogue`` is also an ordinary
``row_update`` callable, so the plain round runs the same problems.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.ref import HALO_QUANT

__all__ = [
    "ADD_CONST",
    "ADD_TABLE",
    "LABELPROP",
    "MIN_OLD",
    "Epilogue",
    "fma_f32",
    "fused_batch_round_cuda",
    "fused_batch_solve_cuda",
    "fused_halo_batch_round_cuda",
    "fused_halo_round_cuda",
    "fused_round_cuda",
    "fused_solve_cuda",
    "halo_local_step_cuda",
    "halo_recv_cuda",
    "round_publish_cuda",
    "round_rank_step_cuda",
]

ADD_CONST = "add_const"  # c + reduced            (pagerank)
ADD_TABLE = "add_table"  # table[row] + reduced   (ppr's q, jacobi's b/diag, rwr's restart)
MIN_OLD = "min_old"  # min(old, reduced)          (sssp, cc)
LABELPROP = "labelprop"  # row-normalised blend, anchored rows clamped (labelprop)

# Tag codes of csrc/round_block.cu, and the tags the kernel takes per dtype.
TAG_CODES = {ADD_CONST: 0, ADD_TABLE: 1, MIN_OLD: 2, LABELPROP: 3}
_KERNEL_TAGS = {torch.float32: (ADD_CONST, ADD_TABLE, LABELPROP), torch.int32: (MIN_OLD,)}
_TABLE_TAGS = (ADD_TABLE, LABELPROP)
_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
# Halo wire codes of csrc/round_block.cu (halo_round_launch), the most
# shards one launch takes (kMaxShards), and the most (shard, feature) scales
# a quantized step keeps (kMaxScales).
_WIRE_CODES = {"f32": 0, "int8": 1, "fp8": 2}
MAX_SHARDS = 64
MAX_SCALES = 512
# Feature widths whose rows the kernels load as 8- or 16-byte vectors
# (csrc/round_block.cu); such a frontier's rows must start 4·min(F, 4)-byte
# aligned.  Any other F runs the kernels' loop over feature blocks.
VECTOR_F = (2, 4, 8)
# The batch entry's widths C = Q·F loaded as vectors (8-, 16-byte loads).
VECTOR_C = (2, 4, 8, 16, 32)
# The loop entry's residuals (csrc/round_block.cu kResL1, kResChanged, and
# kResNone: the publish without the residual, which chip_smoke.py times
# beside it), its state's head (the round count, before the per-query flags,
# rounds and residuals), and the most blocks of a cooperative launch one SM
# holds (Hopper), which sizes the per-block partial sums and flags.
_RESIDUAL_L1, _RESIDUAL_CHANGED, _RESIDUAL_NONE = 0, 1, 2
_STATE_HEAD = 1
_MAX_BLOCKS_PER_SM = 32


def _row_sum(v):
    """``v``'s sum over its last axis, left to right, keeping the axis: the
    order XLA's ``jnp.sum(v, -1)`` adds an ``(…, F)`` row on the CPU, and
    the kernels' (``((v0 + v1) + v2) + …``)."""
    acc = v[..., :1]
    for f in range(1, v.shape[-1]):
        acc = acc + v[..., f : f + 1]
    return acc


def fma_f32(a, b, c):
    """``a·b + c`` rounded once to float32, as a fused multiply-add does.

    The f32 product is exact in float64 and ``s = fl64(a·b + c)`` keeps its
    error ``e`` (TwoSum); ``s`` rounded to odd (moved one ulp towards ``e``
    when inexact and even) has 29 bits beyond float32's, so rounding it to
    float32 is the exact sum's correctly rounded value.  Rounding ``s``
    itself would round twice, and does differ where ``a·b + c`` lies just
    beside a float32 midpoint (``0.9f · 0.75 + 1e-31``).
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    inexact = (e != 0) & torch.isfinite(e) & ((s.view(torch.int64) & 1) == 0)
    towards = torch.where(e > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(inexact, torch.nextafter(s, towards), s).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """A row update ``(old, reduced, rows) -> new`` that K1 evaluates itself.

    ``table`` (``add_table``: the added values; ``labelprop``: the anchors)
    holds one row per frontier slot, the dump row included, so
    ``table[rows]`` never reads past the end where padded rows point at the
    dump slot ``n``: ``(n + 1,)`` or, for a matrix frontier, ``(n + 1, F)``;
    for a batch of Q queries ``(n + 1, Q)+feat`` (:meth:`for_batch`).
    ``labelprop`` carries ``mix`` and ``one_minus_mix`` as float32 values,
    each rounded from the Python double (:meth:`labelprop`).
    """

    tag: str
    const: float = 0.0
    table: torch.Tensor | None = None
    mix: np.float32 = np.float32(1.0)
    one_minus_mix: np.float32 = np.float32(0.0)

    def __post_init__(self):
        if self.tag not in TAG_CODES:
            raise ValueError(f"unknown epilogue tag {self.tag!r}")
        if (self.tag in _TABLE_TAGS) != (self.table is not None):
            raise ValueError("an add_table or labelprop epilogue needs a table; no other does")
        if self.tag == LABELPROP and self.table.dim() not in (2, 3):
            raise ValueError(
                f"labelprop's anchors are (n + 1, F), or (n + 1, Q, F) for a batch, "
                f"got {tuple(self.table.shape)}"
            )

    @classmethod
    def labelprop(cls, anchors: torch.Tensor, mix: float) -> "Epilogue":
        """Label propagation's row update: ``mix·(reduced / total) +
        (1 − mix)·old`` where the row's total is positive (else ``old``), and
        the anchor row where the anchors' row has mass.  ``1 − mix`` is taken
        in the Python double and then rounded, as the reference's weak-typed
        ``(1 - mix) * old`` is."""
        return cls(LABELPROP, table=anchors, mix=np.float32(mix), one_minus_mix=np.float32(1 - mix))

    def to(self, device) -> "Epilogue":
        if self.table is None:
            return self
        return dataclasses.replace(self, table=self.table.to(device))

    def for_frontier(self, feat: tuple) -> "Epilogue":
        """This row update for a frontier whose rows have trailing shape
        ``feat``: a per-row ``(n + 1,)`` table on a matrix frontier repeats
        over its F columns (the reference broadcasts it, ``_match_features``).
        Raises on a table that fits neither."""
        feat = tuple(feat)
        if self.table is None or tuple(self.table.shape[1:]) == feat:
            return self
        if self.tag == ADD_TABLE and self.table.dim() == 1 and len(feat) == 1:
            wide = self.table[:, None].expand(-1, feat[0]).contiguous()
            return dataclasses.replace(self, table=wide)
        raise ValueError(
            f"a {self.tag} table of shape {tuple(self.table.shape)} does not fit "
            f"a frontier with rows of shape {feat}"
        )

    def for_batch(self, Q: int, feat: tuple, per_query: bool) -> "Epilogue":
        """This row update for a batch frontier ``(n + 1, Q)+feat``.  With
        ``per_query`` the table is ``(n + 1, Q)+tfeat``, each query's own
        column(s); otherwise it is the one ``(n + 1,)+tfeat`` table every
        query reads (jacobi's).  A ``(n + 1, Q)`` add_table table on a
        matrix batch repeats over F, as :meth:`for_frontier` does.  Raises
        on a table that fits neither."""
        if self.table is None:
            return self
        feat = tuple(feat)
        t = self.table if per_query else self.table[:, None]
        tfeat = tuple(t.shape[2:])
        fits = tfeat == feat or (self.tag == ADD_TABLE and not tfeat and len(feat) == 1)
        if t.dim() < 2 or t.shape[1] != (Q if per_query else 1) or not fits:
            raise ValueError(
                f"a {self.tag} table of shape {tuple(self.table.shape)} does not fit a batch "
                f"of {Q} queries with rows of shape {feat}"
            )
        if tfeat != feat:
            t = t[..., None]
        return dataclasses.replace(self, table=t.expand((t.shape[0], Q) + feat).contiguous())

    def __call__(self, old, reduced, rows):
        if self.tag == ADD_CONST:
            c = torch.tensor(np.float32(self.const), device=reduced.device)
            return c + reduced
        if self.tag == ADD_TABLE:
            return self.table[rows] + reduced
        if self.tag == LABELPROP:
            return self._labelprop(old, reduced, rows)
        return torch.minimum(old, reduced)

    def _labelprop(self, old, reduced, rows):
        # The reference's jnp.where(total > 0, mix * (reduced / safe) +
        # (1 - mix) * old, old) as XLA compiles it: an IEEE division, the
        # product (1 - mix)·old rounded, then one FMA (fma_f32).
        total = _row_sum(reduced)
        live = total > 0
        safe = torch.where(live, total, torch.ones_like(total))
        mix = torch.tensor(self.mix, device=reduced.device)
        rest = torch.tensor(self.one_minus_mix, device=reduced.device) * old
        prop = torch.where(live, fma_f32(mix, reduced / safe, rest), old)
        anchor = self.table[rows]
        return torch.where(_row_sum(anchor) > 0, anchor, prop)


def _check_cuda(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {x.device}")


def _check_epilogue(x, semiring, epilogue) -> None:
    if not isinstance(epilogue, Epilogue):
        raise TypeError(
            "the CUDA kernels take only an Epilogue row update "
            f"({', '.join(TAG_CODES)}); got {type(epilogue).__name__}"
        )
    if x.dtype != semiring.torch_dtype:
        raise ValueError(f"x is {x.dtype}, semiring wants {semiring.dtype}")
    if epilogue.tag not in _KERNEL_TAGS.get(x.dtype, ()):
        raise ValueError(f"no {epilogue.tag} epilogue for {x.dtype}")


def _check_tensors(expect: dict, device) -> None:
    """``expect[name] = (tensor, shape, dtype)``: raise on any mismatch."""
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def _feature_width(x, lead: int) -> tuple:
    """``(feat, F)`` of a frontier with ``lead`` leading axes: rows of shape
    ``()`` or ``(F,)``; raises on any other layout the kernels do not take."""
    feat = tuple(x.shape[lead:])
    if len(feat) > 1 or (feat and feat[0] < 1):
        raise ValueError(
            f"the kernels take frontier rows of shape () or (F,) with F >= 1, got {feat}"
        )
    return feat, (feat[0] if feat else 1)


def _row_widths(x, lead: int, tag: str) -> tuple:
    """``(feat, C, G)`` of a frontier with ``lead`` leading axes whose rows
    have shape ``feat``: ``()``, ``(F,)``, or a batch's ``(Q,)`` or ``(Q,
    F)``.  C is the values a row, G the epilogue's group width (labelprop:
    each query's own F columns, the last axis; C for every other tag)."""
    feat = tuple(x.shape[lead:])
    if len(feat) > 2 or 0 in feat:
        raise ValueError(f"the kernels take rows of shape (), (F,), (Q,) or (Q, F), got {feat}")
    C = int(np.prod(feat)) if feat else 1
    return feat, C, (feat[-1] if tag == LABELPROP and feat else C)


def _check_aligned(F: int, named: dict, widths=VECTOR_F) -> None:
    """Rows of F in ``widths`` are loaded as vectors: each F-wide tensor
    must start at a multiple of its row's vector width."""
    if F not in widths:
        return
    align = 4 * min(F, 4)
    for name, t in named.items():
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name}: F={F} rows must start {align}-byte aligned")


def _check_args(x_ext, sched, semiring, epilogue) -> int:
    """Raise on anything K1 does not take (runs before any launch); returns F.
    The shapes are checked before the device, so a CPU call with wrong
    shapes says what is wrong with them."""
    _check_epilogue(x_ext, semiring, epilogue)
    feat, F = _feature_width(x_ext, 1)
    if epilogue.tag == LABELPROP and not feat:
        raise ValueError("a labelprop epilogue needs a matrix frontier (n + 1, F)")
    S, P, M, delta = sched.S, sched.P, sched.M, sched.delta
    expect = {
        "x_ext": (x_ext, (sched.n_slots,) + feat, x_ext.dtype),
        "src": (sched.src, (S, P, M), torch.int32),
        "val": (sched.val, (S, P, M), x_ext.dtype),
        "row_ptr": (sched.row_ptr, (S, P, delta + 1), torch.int32),
        "rows": (sched.rows, (S, P, delta), torch.int32),
    }
    if epilogue.table is not None:
        expect["table"] = (epilogue.table, (sched.n_slots,) + feat, x_ext.dtype)
    _check_tensors(expect, x_ext.device)
    if max(sched.n_slots, P * delta) * F >= 2**31:
        raise ValueError("the frontier and the step's rows must hold fewer than 2**31 values")
    _check_aligned(F, {"x_ext": x_ext, "table": epilogue.table})
    _check_cuda(x_ext)
    return F


def _library():
    from repro_torch.kernels.build import load

    lib = load("round_block")
    if lib.round_block_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        f64 = ctypes.c_double
        lib.round_block_launch.argtypes = [i32] + [ptr] * 7 + [f64] * 3 + [i32] * 7 + [ptr]
        lib.round_block_launch.restype = i32
        lib.round_block_batch_launch.argtypes = [i32] + [ptr] * 7 + [f64] * 3 + [i32] * 8 + [ptr]
        lib.round_block_batch_launch.restype = i32
        lib.round_block_solve_launch.argtypes = (
            [i32] + [ptr] * 7 + [f64] * 3 + [i32] * 10 + [f64] + [i32] * 2 + [ptr, ctypes.c_longlong, ptr, ptr]
        )
        lib.round_block_solve_launch.restype = i32
        lib.halo_round_launch.argtypes = [i32] * 2 + [ptr] * 13 + [f64] * 4 + [i32] * 11 + [ptr]
        lib.halo_round_launch.restype = i32
        lib.halo_round_batch_launch.argtypes = [i32] + [ptr] * 10 + [f64] * 3 + [i32] * 10 + [ptr]
        lib.halo_round_batch_launch.restype = i32
        lib.halo_local_launch.argtypes = [i32] * 2 + [ptr] * 13 + [f64] * 4 + [i32] * 13 + [ptr]
        lib.halo_local_launch.restype = i32
        lib.halo_recv_launch.argtypes = [i32] * 2 + [ptr] * 5 + [i32] * 7 + [ptr]
        lib.halo_recv_launch.restype = i32
        lib.round_block_rank_step_launch.argtypes = [i32] + [ptr] * 7 + [f64] * 3 + [i32] * 8 + [ptr]
        lib.round_block_rank_step_launch.restype = i32
        lib.round_block_publish_launch.argtypes = [i32] + [ptr] * 3 + [i32] * 6 + [ptr]
        lib.round_block_publish_launch.restype = i32
        lib.round_block_error_string.argtypes = [i32]
        lib.round_block_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.round_block_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")


def _launch_k1(entry: str, x, sched, epilogue, *widths) -> torch.Tensor:
    """Launch K1 through the library's ``entry`` on a copy of ``x`` and
    return it; ``widths`` are the entry's last arguments (F; or C and G),
    the first of them a row's values."""
    lib = _library()
    out = x.clone()
    scratch = torch.empty(sched.P * sched.delta * widths[0], dtype=out.dtype, device=out.device)
    table = epilogue.table.data_ptr() if epilogue.table is not None else None
    with torch.cuda.device(out.device):
        err = getattr(lib, entry)(
            _DTYPE_CODES[out.dtype],
            out.data_ptr(),
            scratch.data_ptr(),
            sched.src.data_ptr(),
            sched.val.data_ptr(),
            sched.row_ptr.data_ptr(),
            sched.rows.data_ptr(),
            table,
            float(epilogue.const),
            float(epilogue.mix),
            float(epilogue.one_minus_mix),
            TAG_CODES[epilogue.tag],
            sched.n,
            sched.S,
            sched.P,
            sched.M,
            sched.delta,
            *widths,
            torch.cuda.current_stream(out.device).cuda_stream,
        )
    _raise_on(lib, err, entry)
    return out


def fused_round_cuda(x_ext, sched, semiring, epilogue) -> torch.Tensor:
    """One round on the card: returns a new ``(n+1,)+feat`` frontier
    (``x_ext`` is left as it was).  Launches on the current stream and does
    not synchronise.  The dump row's value is unspecified."""
    F = _check_args(x_ext, sched, semiring, epilogue)
    out = _launch_k1("round_block_launch", x_ext, sched, epilogue, F)
    fused_round_cuda.launches += 1
    return out


fused_round_cuda.launches = 0  # kernel launches, for showing a path used K1


def _check_batch_args(X, sched, semiring, epilogue) -> tuple:
    """Raise on anything K1's batch entry does not take (before any launch);
    returns ``(C, G)``: the values a row, Q·F, and the epilogue's group
    width (F for labelprop, each query's own columns; C otherwise).  The
    shapes are checked before the device."""
    _check_epilogue(X, semiring, epilogue)
    if X.dim() not in (2, 3) or 0 in X.shape[1:]:
        raise ValueError(f"a batch frontier is (n + 1, Q) or (n + 1, Q, F), got {tuple(X.shape)}")
    Q, feat = X.shape[1], tuple(X.shape[2:])
    F = feat[0] if feat else 1
    if epilogue.tag == LABELPROP and not feat:
        raise ValueError("a labelprop epilogue needs a matrix batch (n + 1, Q, F)")
    S, P, M, delta = sched.S, sched.P, sched.M, sched.delta
    expect = {
        "X": (X, (sched.n_slots, Q) + feat, X.dtype),
        "src": (sched.src, (S, P, M), torch.int32),
        "val": (sched.val, (S, P, M), X.dtype),
        "row_ptr": (sched.row_ptr, (S, P, delta + 1), torch.int32),
        "rows": (sched.rows, (S, P, delta), torch.int32),
    }
    if epilogue.table is not None:
        expect["table"] = (epilogue.table, (sched.n_slots, Q) + feat, X.dtype)
    _check_tensors(expect, X.device)
    C = Q * F
    if max(sched.n_slots, P * delta) * C >= 2**31:
        raise ValueError("the batch frontier and the step's rows must hold fewer than 2**31 values")
    _check_aligned(C, {"X": X, "table": epilogue.table}, VECTOR_C)
    _check_cuda(X)
    return C, (F if epilogue.tag == LABELPROP else C)


def fused_batch_round_cuda(X, sched, semiring, epilogue) -> torch.Tensor:
    """One round of a batch of Q queries on the card, one launch: returns a
    new ``(n+1, Q)+feat`` frontier (``X`` is left as it was).  An
    ``add_table`` or ``labelprop`` table is ``(n+1, Q)+feat``
    (:meth:`Epilogue.for_batch`).  Launches on the current stream and does
    not synchronise.  The dump row's values are unspecified."""
    C, G = _check_batch_args(X, sched, semiring, epilogue)
    out = _launch_k1("round_block_batch_launch", X, sched, epilogue, C, G)
    fused_batch_round_cuda.launches += 1
    return out


fused_batch_round_cuda.launches = 0  # batch kernel launches, apart from K1's single-query count


def _check_rank_step_args(x_ext, sched, semiring, epilogue, s: int) -> tuple:
    """Raise on anything K1's rank step does not take (before any launch);
    returns ``(C, G)`` as :func:`_check_batch_args` does.  The shapes are
    checked before the device."""
    _check_epilogue(x_ext, semiring, epilogue)
    feat, C, G = _row_widths(x_ext, 1, epilogue.tag)
    if epilogue.tag == LABELPROP and not feat:
        raise ValueError("a labelprop epilogue needs a matrix frontier (n + 1, F)")
    if getattr(sched, "src", None) is None:
        raise ValueError("K1's rank step reads the rank's src: a replicated rank layout holds it")
    if not 0 <= s < sched.S:
        raise ValueError(f"step {s} outside [0, {sched.S})")
    S, M, delta, Pr = sched.S, sched.M, sched.delta, sched.val.shape[1]
    expect = {
        "x_ext": (x_ext, (sched.n_slots,) + feat, x_ext.dtype),
        "src": (sched.src, (S, Pr, M), torch.int32),
        "val": (sched.val, (S, Pr, M), x_ext.dtype),
        "row_ptr": (sched.row_ptr, (S, Pr, delta + 1), torch.int32),
        "rows": (sched.rows, (S, Pr, delta), torch.int32),
    }
    if epilogue.table is not None:
        expect["table"] = (epilogue.table, (sched.n_slots,) + feat, x_ext.dtype)
    _check_tensors(expect, x_ext.device)
    if max(sched.n_slots, Pr * delta) * C >= 2**31:
        raise ValueError("the frontier and the step's rows must hold fewer than 2**31 values")
    _check_aligned(C, {"x_ext": x_ext, "table": epilogue.table}, VECTOR_C)
    _check_cuda(x_ext)
    return C, G


def round_rank_step_cuda(x_ext, sched, semiring, epilogue, s: int) -> torch.Tensor:
    """Commit step ``s`` of a rank's workers on the card, one ordinary
    launch: K1's step over the rank's cells (a replicated
    :class:`~repro_torch.dist.engine_sharded.RankSchedule`, or a whole
    schedule) reading the whole ``(n + 1,)+feat`` frontier ``x_ext``, which
    it does not write.  ``feat`` is ``()``, ``(F,)``, or a batch's ``(Q,)``
    or ``(Q, F)`` (an ``(n + 1,)+feat`` table, :meth:`Epilogue.for_batch`).
    Returns the new rows of the step, ``(P_r·δ,)+feat`` in chunk order
    (padded rows hold unspecified values).  Launches on the current stream
    and does not synchronise."""
    C, G = _check_rank_step_args(x_ext, sched, semiring, epilogue, s)
    lib = _library()
    dev = x_ext.device
    Pr = sched.val.shape[1]
    out = torch.empty((Pr * sched.delta,) + tuple(x_ext.shape[1:]), dtype=x_ext.dtype, device=dev)
    table = epilogue.table.data_ptr() if epilogue.table is not None else None
    with torch.cuda.device(dev):
        err = lib.round_block_rank_step_launch(
            _DTYPE_CODES[x_ext.dtype],
            x_ext.data_ptr(),
            out.data_ptr(),
            sched.src.data_ptr(),
            sched.val.data_ptr(),
            sched.row_ptr.data_ptr(),
            sched.rows.data_ptr(),
            table,
            float(epilogue.const),
            float(epilogue.mix),
            float(epilogue.one_minus_mix),
            TAG_CODES[epilogue.tag],
            s,
            sched.S,
            Pr,
            sched.M,
            sched.delta,
            C,
            G,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "round_block_rank_step")
    round_rank_step_cuda.launches += 1
    return out


round_rank_step_cuda.launches = 0  # K1 rank step launches (one a step a rank)


def round_publish_cuda(x_ext, block, rows, s: int) -> torch.Tensor:
    """Step ``s``'s gathered ``(P·δ,)+feat`` block of every worker into the
    ``(n + 1,)+feat`` frontier at the schedule's global rows ``rows[s]``
    (``rows`` the ``(S, P, δ)`` int32 rows; dump rows, ``== n``, skipped),
    in place, one ordinary launch.  Returns ``x_ext``.  Launches on the
    current stream and does not synchronise."""
    feat, C, _ = _row_widths(x_ext, 1, None)
    if x_ext.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernels take float32 or int32 frontiers, got {x_ext.dtype}")
    if rows.dim() != 3 or not 0 <= s < rows.shape[0]:
        raise ValueError(f"rows must be (S, P, delta) with step {s} inside, got {tuple(rows.shape)}")
    S, P, delta = rows.shape
    _check_tensors(
        {"block": (block, (P * delta,) + feat, x_ext.dtype), "rows": (rows, (S, P, delta), torch.int32)},
        x_ext.device,
    )
    if not x_ext.is_contiguous():
        raise ValueError(f"x_ext must be contiguous on {x_ext.device}")
    if max(x_ext.shape[0], P * delta) * C >= 2**31:
        raise ValueError("the frontier and the step's rows must hold fewer than 2**31 values")
    _check_aligned(C, {"x_ext": x_ext, "block": block}, VECTOR_C)
    _check_cuda(x_ext)
    lib = _library()
    dev = x_ext.device
    with torch.cuda.device(dev):
        err = lib.round_block_publish_launch(
            _DTYPE_CODES[x_ext.dtype],
            x_ext.data_ptr(),
            block.data_ptr(),
            rows.data_ptr(),
            x_ext.shape[0] - 1,
            s,
            S,
            P,
            delta,
            C,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "round_block_publish")
    round_publish_cuda.launches += 1
    return x_ext


round_publish_cuda.launches = 0  # K1 publish launches (one a step a rank)


def _residual_code(residual, dtype) -> int:
    """The loop entry's code of ``residual``, which must be one of the
    problems' two residuals; l1 only on a float32 frontier."""
    from repro_torch.solve.problem import count_changed_residual, l1_residual

    if residual is l1_residual and dtype == torch.float32:
        return _RESIDUAL_L1
    if residual is count_changed_residual:
        return _RESIDUAL_CHANGED
    raise ValueError(
        "K1's loop entry computes l1_residual (float32) or count_changed_residual, "
        f"got {getattr(residual, '__name__', residual)!r} on {dtype}"
    )


def _launch_loop(x, sched, epilogue, code, tol, max_rounds, conv0, freeze, C, G) -> tuple:
    """Launch K1's loop entry on a copy of ``x`` (C values a row, Q =
    ``conv0.size`` queries of C / Q columns), then read its state back once.
    Returns ``(x, rounds, converged (Q,), rounds_per_query (Q,), residuals
    (Q,) float32)``."""
    lib = _library()
    Q = conv0.size
    out = x.clone()
    dev = out.device
    scratch = torch.empty(sched.P * sched.delta * C, dtype=out.dtype, device=dev)
    # each block's partial sums and its own convergence flags, Q of each
    part_cap = 2 * torch.cuda.get_device_properties(dev).multi_processor_count * _MAX_BLOCKS_PER_SM * Q
    part = torch.empty(part_cap, dtype=torch.float32, device=dev)
    head = np.zeros(_STATE_HEAD + 3 * Q, np.int32)
    head[_STATE_HEAD : _STATE_HEAD + Q] = conv0
    head[_STATE_HEAD + 2 * Q :] = np.full(Q, np.inf, np.float32).view(np.int32)
    state = torch.from_numpy(head).to(dev)
    table = epilogue.table.data_ptr() if epilogue.table is not None else None
    with torch.cuda.device(dev):
        err = lib.round_block_solve_launch(
            _DTYPE_CODES[out.dtype],
            out.data_ptr(),
            scratch.data_ptr(),
            sched.src.data_ptr(),
            sched.val.data_ptr(),
            sched.row_ptr.data_ptr(),
            sched.rows.data_ptr(),
            table,
            float(epilogue.const),
            float(epilogue.mix),
            float(epilogue.one_minus_mix),
            TAG_CODES[epilogue.tag],
            sched.n,
            sched.S,
            sched.P,
            sched.M,
            sched.delta,
            C,
            G,
            C // Q,
            code,
            float(tol),
            int(max_rounds),
            int(freeze),
            part.data_ptr(),
            part_cap,
            state.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "round_block_solve")
    st = state.cpu().numpy()  # the call's one read-back
    conv = st[_STATE_HEAD : _STATE_HEAD + Q] != 0
    rpq = st[_STATE_HEAD + Q : _STATE_HEAD + 2 * Q].copy()
    res = st[_STATE_HEAD + 2 * Q :].view(np.float32).copy()
    return out, int(st[0]), conv, rpq, res


def fused_solve_cuda(x_ext, sched, semiring, epilogue, residual, tol, max_rounds) -> tuple:
    """Rounds of K1 on the card until ``residual`` (the problems'
    ``l1_residual`` or ``count_changed_residual``) is ≤ ``float32(tol)`` or
    ``max_rounds`` rounds have run, in one launch: the reference's
    ``make_solve_fn_q``.  Returns ``(x, residual, rounds, converged)``, ``x``
    a new ``(n+1,)+feat`` frontier and the residual the last round's, as
    float32; ``max_rounds`` ≤ 0 launches nothing and returns ``x_ext`` with
    an infinite residual.  Synchronises once, to read the result back.  The
    dump row's value is unspecified."""
    code = _residual_code(residual, x_ext.dtype)
    F = _check_args(x_ext, sched, semiring, epilogue)
    if max_rounds < 1:
        return x_ext, np.float32(np.inf), 0, False
    out, rounds, conv, _, res = _launch_loop(
        x_ext, sched, epilogue, code, tol, max_rounds, np.zeros(1, bool), False, F, F
    )
    fused_solve_cuda.launches += 1
    return out, res[0], rounds, bool(conv[0])


fused_solve_cuda.launches = 0  # loop entry launches for one query


def fused_batch_solve_cuda(X, sched, semiring, epilogue, residual, tol, max_rounds, conv0=None) -> tuple:
    """Rounds of K1's batch entry on the card until every query's residual
    (summed over its own rows and columns) is ≤ ``float32(tol)`` or
    ``max_rounds`` rounds have run, in one launch: the reference's batch
    loops.  With ``conv0`` None a closed batch: every query iterates to the
    end.  Otherwise an open batch: the ``(Q,)`` flags ``conv0`` mark queries
    already converged, and a query freezes, state and residual, at its first
    convergence.  Returns ``(X, residuals (Q,) float32, rounds, converged
    (Q,), rounds_per_query (Q,))``, ``rounds_per_query`` the round of each
    query's first convergence in this call (0: none).  A call with nothing
    to run (``max_rounds`` ≤ 0, or every query converged) launches nothing
    and returns ``X``.  Synchronises once, to read the result back."""
    code = _residual_code(residual, X.dtype)
    Q = X.shape[1] if X.dim() > 1 else 0
    conv = np.zeros(Q, bool) if conv0 is None else np.array(conv0, dtype=bool)
    if conv.shape != (Q,):
        raise ValueError(f"conv0 must have shape ({Q},), got {conv.shape}")
    C, G = _check_batch_args(X, sched, semiring, epilogue)
    if max_rounds < 1 or conv.all():
        return X, np.full(Q, np.inf, np.float32), 0, conv, np.zeros(Q, np.int32)
    out, rounds, conv, rpq, res = _launch_loop(
        X, sched, epilogue, code, tol, max_rounds, conv, conv0 is not None, C, G
    )
    fused_batch_solve_cuda.launches += 1
    return out, res, rounds, conv, rpq


fused_batch_solve_cuda.launches = 0  # loop entry launches for a batch


def _check_halo_args(x_loc, ef, sched, plan, semiring, epilogue, halo_dtype, steps):
    """Raise on anything K2 does not take; returns the step range and F.
    The shapes are checked before the device, so a CPU call with wrong
    shapes says what is wrong with them."""
    _check_epilogue(x_loc, semiring, epilogue)
    feat, F = _feature_width(x_loc, 2)
    if epilogue.tag == LABELPROP and not feat:
        raise ValueError("a labelprop epilogue needs a matrix frontier (D, L, F)")
    if halo_dtype not in _WIRE_CODES:
        raise ValueError(f"halo_dtype must be one of {tuple(_WIRE_CODES)}, got {halo_dtype!r}")
    if halo_dtype != "f32" and x_loc.dtype != torch.float32:
        raise ValueError(f"a {halo_dtype} wire needs a float32 frontier, got {x_loc.dtype}")
    S, P, M, delta = sched.S, sched.P, sched.M, sched.delta
    D, P_loc, L, H = plan.D, plan.P_loc, plan.L, plan.H
    if (plan.S, plan.delta, D * P_loc) != (S, delta, P):
        raise ValueError("plan built for another schedule")
    if not 1 <= D <= MAX_SHARDS:
        raise ValueError(f"K2 takes 1 to {MAX_SHARDS} shards, got {D}")
    s0, s1 = (0, S) if steps is None else (int(steps[0]), int(steps[1]))
    if not 0 <= s0 <= s1 <= S:
        raise ValueError(f"steps must satisfy 0 <= s0 <= s1 <= S={S}, got {(s0, s1)}")
    if halo_dtype != "f32" and D * F > MAX_SCALES:
        raise ValueError(f"a {halo_dtype} wire keeps at most {MAX_SCALES} scales a step, D·F = {D * F}")
    expect = {
        "x_loc": (x_loc, (D, L) + feat, x_loc.dtype),
        "src_loc": (plan.src_loc, (D, S, P_loc, M), torch.int32),
        "val": (sched.val, (S, P, M), x_loc.dtype),
        "row_ptr": (sched.row_ptr, (S, P, delta + 1), torch.int32),
        "rows": (sched.rows, (S, P, delta), torch.int32),
        "rows_loc": (plan.rows_loc, (D, S, P_loc, delta), torch.int32),
        "send_idx": (plan.send_idx, (S, D, H), torch.int32),
        "recv_idx": (plan.recv_idx, (S, D, D * H), torch.int32),
        "dump_last": (plan.dump_last, (S, D), torch.int32),
    }
    if halo_dtype != "f32":
        expect["ef"] = (ef, (D, S, H) + feat, torch.float32)
    if epilogue.table is not None:
        expect["table"] = (epilogue.table, (sched.n_slots,) + feat, x_loc.dtype)
    _check_tensors(expect, x_loc.device)
    if max(D * L * F, P * delta * F, D * D * H, D * S * H * F) >= 2**31:
        raise ValueError("the halo frontier and its indices must stay below 2**31 entries")
    _check_aligned(F, {"x_loc": x_loc, "table": epilogue.table})
    _check_cuda(x_loc)
    return s0, s1, F


def fused_halo_round_cuda(
    x_loc, ef, sched, plan, semiring, epilogue, halo_dtype: str = "f32", steps=None
):
    """The commit steps ``steps = (s0, s1)`` (default: all ``S``) of one halo
    round on the card, in one launch, in place on the stacked ``(D, L)+feat``
    frontier ``x_loc`` and, for an int8/fp8 wire, the ``(D, S, H)+feat``
    residuals ``ef`` (``ef`` is not read for f32; a matrix frontier's wire
    keeps one scale per shard, step and feature).  Returns ``(x_loc, ef)``.
    Launches on the current stream and does not synchronise; an empty range
    launches nothing.  The dump slots ``L - 1`` are never written."""
    s0, s1, F = _check_halo_args(x_loc, ef, sched, plan, semiring, epilogue, halo_dtype, steps)
    if s0 == s1:
        return x_loc, ef
    lib = _library()
    dev = x_loc.device
    scratch = torch.empty(sched.P * sched.delta * F, dtype=x_loc.dtype, device=dev)
    quant = halo_dtype != "f32"
    amax = torch.zeros((s1 - s0, plan.D, F), dtype=torch.int32, device=dev) if quant else None
    inv_qmax = float(np.float32(1 / HALO_QUANT[halo_dtype][1])) if quant else 0.0
    table = epilogue.table.data_ptr() if epilogue.table is not None else None
    with torch.cuda.device(dev):
        err = lib.halo_round_launch(
            _DTYPE_CODES[x_loc.dtype],
            _WIRE_CODES[halo_dtype],
            x_loc.data_ptr(),
            ef.data_ptr() if quant else None,
            scratch.data_ptr(),
            amax.data_ptr() if quant else None,
            plan.src_loc.data_ptr(),
            sched.val.data_ptr(),
            sched.row_ptr.data_ptr(),
            sched.rows.data_ptr(),
            plan.rows_loc.data_ptr(),
            plan.send_idx.data_ptr(),
            plan.recv_idx.data_ptr(),
            plan.dump_last.data_ptr(),
            table,
            float(epilogue.const),
            float(epilogue.mix),
            float(epilogue.one_minus_mix),
            inv_qmax,
            TAG_CODES[epilogue.tag],
            s0,
            s1,
            sched.S,
            plan.D,
            plan.P_loc,
            sched.M,
            sched.delta,
            plan.L,
            plan.H,
            F,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "halo_round")
    fused_halo_round_cuda.launches += 1
    return x_loc, ef


fused_halo_round_cuda.launches = 0  # kernel launches, for showing a path used K2


def _check_plan_fits(sched, plan) -> None:
    """The plan and the schedule must be one layout: the same S and δ, and
    ``D · P_loc`` workers."""
    if (plan.S, plan.delta, plan.D * plan.P_loc) != (sched.S, sched.delta, sched.P):
        raise ValueError("plan built for another schedule")
    if not 1 <= plan.D <= MAX_SHARDS:
        raise ValueError(f"K2 takes 1 to {MAX_SHARDS} shards, got {plan.D}")


def _check_halo_batch_args(X_loc, sched, plan, semiring, epilogue) -> tuple:
    """Raise on anything K2's batch entry does not take (before any launch);
    returns ``(C, G)`` as :func:`_check_batch_args` does.  The shapes are
    checked before the device."""
    _check_epilogue(X_loc, semiring, epilogue)
    if X_loc.dim() not in (3, 4) or 0 in X_loc.shape[2:]:
        raise ValueError(f"a halo batch frontier is (D, L, Q) or (D, L, Q, F), got {tuple(X_loc.shape)}")
    Q, feat = X_loc.shape[2], tuple(X_loc.shape[3:])
    F = feat[0] if feat else 1
    if epilogue.tag == LABELPROP and not feat:
        raise ValueError("a labelprop epilogue needs a matrix batch (D, L, Q, F)")
    _check_plan_fits(sched, plan)
    S, P, M, delta = sched.S, sched.P, sched.M, sched.delta
    D, P_loc, L, H = plan.D, plan.P_loc, plan.L, plan.H
    if plan.d0 != 0 or plan.d1 != D:
        raise ValueError("K2's batch entry runs a whole plan, all D shards")
    expect = {
        "X_loc": (X_loc, (D, L, Q) + feat, X_loc.dtype),
        "src_loc": (plan.src_loc, (D, S, P_loc, M), torch.int32),
        "val": (sched.val, (S, P, M), X_loc.dtype),
        "row_ptr": (sched.row_ptr, (S, P, delta + 1), torch.int32),
        "rows": (sched.rows, (S, P, delta), torch.int32),
        "rows_loc": (plan.rows_loc, (D, S, P_loc, delta), torch.int32),
        "send_idx": (plan.send_idx, (S, D, H), torch.int32),
        "recv_idx": (plan.recv_idx, (S, D, D * H), torch.int32),
    }
    if epilogue.table is not None:
        expect["table"] = (epilogue.table, (sched.n_slots, Q) + feat, X_loc.dtype)
    _check_tensors(expect, X_loc.device)
    C = Q * F
    if max(D * L * C, P * delta * C, D * D * H, sched.n_slots * C) >= 2**31:
        raise ValueError("the halo batch frontier and its indices must stay below 2**31 entries")
    _check_aligned(C, {"X_loc": X_loc, "table": epilogue.table}, VECTOR_C)
    _check_cuda(X_loc)
    return C, (F if epilogue.tag == LABELPROP else C)


def fused_halo_batch_round_cuda(X_loc, sched, plan, semiring, epilogue):
    """One halo round of a batch of Q queries on the card, one launch, in
    place on the ``(D, L, Q)+feat`` batch frontier (f32 or int32 wire; an
    ``add_table`` or ``labelprop`` table is ``(n + 1, Q)+feat``,
    :meth:`Epilogue.for_batch`).  Returns ``X_loc``.  Launches on the
    current stream and does not synchronise; the dump slots are never
    written."""
    C, G = _check_halo_batch_args(X_loc, sched, plan, semiring, epilogue)
    lib = _library()
    dev = X_loc.device
    scratch = torch.empty(sched.P * sched.delta * C, dtype=X_loc.dtype, device=dev)
    table = epilogue.table.data_ptr() if epilogue.table is not None else None
    with torch.cuda.device(dev):
        err = lib.halo_round_batch_launch(
            _DTYPE_CODES[X_loc.dtype],
            X_loc.data_ptr(),
            scratch.data_ptr(),
            plan.src_loc.data_ptr(),
            sched.val.data_ptr(),
            sched.row_ptr.data_ptr(),
            sched.rows.data_ptr(),
            plan.rows_loc.data_ptr(),
            plan.send_idx.data_ptr(),
            plan.recv_idx.data_ptr(),
            table,
            float(epilogue.const),
            float(epilogue.mix),
            float(epilogue.one_minus_mix),
            TAG_CODES[epilogue.tag],
            sched.S,
            plan.D,
            plan.P_loc,
            sched.M,
            sched.delta,
            plan.L,
            plan.H,
            C,
            G,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "halo_round_batch")
    fused_halo_batch_round_cuda.launches += 1
    return X_loc


fused_halo_batch_round_cuda.launches = 0  # K2 batch entry launches


def _check_rank_range(sched, plan, d0: int, d1: int) -> tuple:
    """The launch's shards ``[d0, d1)`` must lie in the plan's and their
    workers in the schedule's; returns ``(first shard's index in the plan's
    arrays, first worker's in the schedule's)``."""
    _check_plan_fits(sched, plan)
    if not plan.d0 <= d0 < d1 <= plan.d1:
        raise ValueError(f"shards [{d0}, {d1}) are not within the plan's [{plan.d0}, {plan.d1})")
    w0 = d0 * plan.P_loc - sched.w0
    if w0 < 0 or w0 + (d1 - d0) * plan.P_loc > sched.val.shape[1]:
        raise ValueError(f"the schedule does not hold the workers of shards [{d0}, {d1})")
    return d0 - plan.d0, w0


def _check_rank_plan(sched, plan) -> None:
    """A plan's and a schedule's tensors, whole or a rank's."""
    S, M, delta = sched.S, sched.M, sched.delta
    Dp, Ps = plan.d1 - plan.d0, sched.val.shape[1]
    _check_tensors(
        {
            "src_loc": (plan.src_loc, (Dp, S, plan.P_loc, M), torch.int32),
            "val": (sched.val, (S, Ps, M), sched.val.dtype),
            "row_ptr": (sched.row_ptr, (S, Ps, delta + 1), torch.int32),
            "rows": (sched.rows, (S, Ps, delta), torch.int32),
            "rows_loc": (plan.rows_loc, (Dp, S, plan.P_loc, delta), torch.int32),
            "send_idx": (plan.send_idx, (S, Dp, plan.H), torch.int32),
            "recv_idx": (plan.recv_idx, (S, Dp, plan.D * plan.H), torch.int32),
            "dump_last": (plan.dump_last, (S, Dp), torch.int32),
        },
        plan.src_loc.device,
    )


def _check_local_args(x_loc, ef, sched, plan, semiring, epilogue, wire, s, d0, d1) -> tuple:
    """Raise on anything K2's rank entry does not take (before any launch);
    returns ``(i0, w0, C, G)``."""
    _check_epilogue(x_loc, semiring, epilogue)
    feat, C, G = _row_widths(x_loc, 2, epilogue.tag)
    if epilogue.tag == LABELPROP and not feat:
        raise ValueError("a labelprop epilogue needs a matrix frontier (D, L, F)")
    if wire not in _WIRE_CODES:
        raise ValueError(f"halo_dtype must be one of {tuple(_WIRE_CODES)}, got {wire!r}")
    if wire != "f32" and (x_loc.dtype != torch.float32 or len(feat) > 1):
        raise ValueError(f"a {wire} wire needs a float32 frontier of (D, L) or (D, L, F), got "
                         f"{x_loc.dtype} {tuple(x_loc.shape)}: a batch runs the f32 wire")
    i0, w0 = _check_rank_range(sched, plan, d0, d1)
    if not 0 <= s < sched.S:
        raise ValueError(f"step {s} outside [0, {sched.S})")
    Dl = d1 - d0
    if wire != "f32" and Dl * C > MAX_SCALES:
        raise ValueError(f"a {wire} wire keeps at most {MAX_SCALES} scales a step, got {Dl * C}")
    _check_rank_plan(sched, plan)
    expect = {"x_loc": (x_loc, (Dl, plan.L) + feat, x_loc.dtype)}
    if wire != "f32":
        expect["ef"] = (ef, (Dl, sched.S, plan.H) + feat, torch.float32)
    if epilogue.table is not None:
        expect["table"] = (epilogue.table, (sched.n_slots,) + feat, x_loc.dtype)
    _check_tensors(expect, x_loc.device)
    if sched.val.dtype != x_loc.dtype:
        raise ValueError(f"val is {sched.val.dtype}, the frontier {x_loc.dtype}")
    if max(Dl * plan.L * C, sched.val.shape[1] * sched.delta * C, sched.S * Dl * plan.H * C,
           sched.n_slots * C) >= 2**31:
        raise ValueError("the rank's frontier and its indices must stay below 2**31 entries")
    _check_aligned(C, {"x_loc": x_loc, "table": epilogue.table}, VECTOR_C)
    _check_cuda(x_loc)
    return i0, w0, C, G


def halo_local_step_cuda(x_loc, ef, sched, plan, semiring, epilogue, halo_dtype: str, s: int, d0: int, d1: int):
    """Commit step ``s`` of shards ``[d0, d1)`` on the card, one launch: a
    rank's step of a halo solve over processes, in place on their
    ``(d1 - d0, L)+feat`` frontier (and, for int8/fp8, their ``(d1 - d0,
    S, H)+feat`` residuals ``ef``).  ``sched`` and ``plan`` hold at least
    those shards (a :class:`~repro_torch.dist.engine_sharded.RankSchedule`
    and a :meth:`~repro_torch.dist.engine_sharded.FrontierPlan.for_shards`
    plan, or whole ones).  On the f32 wire ``feat`` may be a batch's
    ``(Q,)`` or ``(Q, F)`` (an ``(n + 1, Q)+feat`` table,
    :meth:`Epilogue.for_batch`).  Returns the send block ``(rows,
    scales)``: the ``(d1 - d0, H)+feat`` boundary rows and None (f32), or
    their int8/fp8 values and ``(d1 - d0,)+feat`` float32 scales.  Launches
    on the current stream and does not synchronise."""
    i0, w0, C, G = _check_local_args(x_loc, ef, sched, plan, semiring, epilogue, halo_dtype, s, d0, d1)
    lib = _library()
    dev = x_loc.device
    Dl, H, S = d1 - d0, plan.H, sched.S
    Dp, Ps = plan.d1 - plan.d0, sched.val.shape[1]
    feat = tuple(x_loc.shape[2:])
    quant = halo_dtype != "f32"
    scratch = torch.empty(Dl * plan.P_loc * sched.delta * C, dtype=x_loc.dtype, device=dev)
    if quant:
        out = torch.empty((Dl, H) + feat, dtype=HALO_QUANT[halo_dtype][0], device=dev)
        scales = torch.empty((Dl,) + feat, dtype=torch.float32, device=dev)
        amax = torch.zeros(Dl * C, dtype=torch.int32, device=dev)
    else:
        out = torch.empty((Dl, H) + feat, dtype=x_loc.dtype, device=dev)
        scales = amax = None
    inv_qmax = float(np.float32(1 / HALO_QUANT[halo_dtype][1])) if quant else 0.0
    table = epilogue.table.data_ptr() if epilogue.table is not None else None
    isz, M, delta, P_loc = 4, sched.M, sched.delta, plan.P_loc
    with torch.cuda.device(dev):
        err = lib.halo_local_launch(
            _DTYPE_CODES[x_loc.dtype],
            _WIRE_CODES[halo_dtype],
            x_loc.data_ptr(),
            ef.data_ptr() if quant else None,
            scratch.data_ptr(),
            amax.data_ptr() if quant else None,
            out.data_ptr(),
            scales.data_ptr() if quant else None,
            plan.src_loc.data_ptr() + i0 * S * P_loc * M * isz,
            sched.val.data_ptr() + w0 * M * sched.val.element_size(),
            sched.row_ptr.data_ptr() + w0 * (delta + 1) * isz,
            sched.rows.data_ptr() + w0 * delta * isz,
            plan.rows_loc.data_ptr() + i0 * S * P_loc * delta * isz,
            plan.send_idx.data_ptr() + i0 * H * isz,
            table,
            float(epilogue.const),
            float(epilogue.mix),
            float(epilogue.one_minus_mix),
            inv_qmax,
            TAG_CODES[epilogue.tag],
            s,
            S,
            Dl,
            Dp,
            Ps,
            P_loc,
            M,
            delta,
            plan.L,
            H,
            C,
            G,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "halo_local")
    halo_local_step_cuda.launches += 1
    return out, scales


halo_local_step_cuda.launches = 0  # K2 rank entry launches (one a step a rank)


def halo_recv_cuda(x_loc, recv_rows, recv_scales, plan, s: int, e0: int, e1: int):
    """Step ``s``'s gathered ``(D, H)+feat`` boundary rows into the halo
    slots of shards ``[e0, e1)`` on the card, one launch, in place on their
    ``(e1 - e0, L)+feat`` frontier: f32 rows as they are (``recv_scales``
    None; dump slots skipped; ``feat`` may be a batch's ``(Q,)`` or ``(Q,
    F)``), or int8/fp8 values dequantized with the ``(D,)+feat`` scales, the
    dump slot taking the entry ``dump_last`` names.  Returns ``x_loc``.
    Launches on the current stream and does not synchronise."""
    feat, C, _ = _row_widths(x_loc, 2, None)
    D, H = plan.D, plan.H
    if not plan.d0 <= e0 < e1 <= plan.d1:
        raise ValueError(f"shards [{e0}, {e1}) are not within the plan's [{plan.d0}, {plan.d1})")
    if not 0 <= s < plan.S:
        raise ValueError(f"step {s} outside [0, {plan.S})")
    quant = recv_scales is not None
    if quant:
        wire = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}.get(recv_rows.dtype)
        if wire is None or x_loc.dtype != torch.float32 or len(feat) > 1:
            raise ValueError(f"quantized rows are int8 or float8_e4m3fn into float32, got {recv_rows.dtype}")
    else:
        wire = "f32"
        if x_loc.dtype not in _DTYPE_CODES:
            raise ValueError(f"the kernels take float32 or int32 frontiers, got {x_loc.dtype}")
    Dp, El, i0 = plan.d1 - plan.d0, e1 - e0, e0 - plan.d0
    expect = {
        "x_loc": (x_loc, (El, plan.L) + feat, x_loc.dtype),
        "recv_rows": (recv_rows, (D, H) + feat, recv_rows.dtype if quant else x_loc.dtype),
        "recv_idx": (plan.recv_idx, (plan.S, Dp, D * H), torch.int32),
        "dump_last": (plan.dump_last, (plan.S, Dp), torch.int32),
    }
    if quant:
        expect["recv_scales"] = (recv_scales, (D,) + feat, torch.float32)
    _check_tensors(expect, x_loc.device)
    if max(El * plan.L * C, D * H * C, plan.S * Dp * D * H) >= 2**31:
        raise ValueError("the rank's frontier and its indices must stay below 2**31 entries")
    _check_aligned(C, {"x_loc": x_loc, "recv_rows": None if quant else recv_rows}, VECTOR_C)
    _check_cuda(x_loc)
    lib = _library()
    dev = x_loc.device
    with torch.cuda.device(dev):
        err = lib.halo_recv_launch(
            _DTYPE_CODES[x_loc.dtype],
            _WIRE_CODES[wire],
            x_loc.data_ptr(),
            recv_rows.data_ptr(),
            recv_scales.data_ptr() if quant else None,
            plan.recv_idx.data_ptr() + i0 * D * H * 4,
            plan.dump_last.data_ptr() + i0 * 4,
            s,
            El,
            Dp,
            D,
            plan.L,
            H,
            C,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "halo_recv")
    halo_recv_cuda.launches += 1
    return x_loc


halo_recv_cuda.launches = 0  # K2 receive launches (one a step a rank)
