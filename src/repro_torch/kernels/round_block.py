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
    "MIN_OLD",
    "Epilogue",
    "fused_halo_round_cuda",
    "fused_round_cuda",
]

ADD_CONST = "add_const"  # c + reduced            (pagerank)
ADD_TABLE = "add_table"  # table[row] + reduced   (ppr's q, jacobi's b/diag)
MIN_OLD = "min_old"  # min(old, reduced)          (sssp, cc)

# Tag codes of csrc/round_block.cu, and the tags the kernel takes per dtype.
TAG_CODES = {ADD_CONST: 0, ADD_TABLE: 1, MIN_OLD: 2}
_KERNEL_TAGS = {torch.float32: (ADD_CONST, ADD_TABLE), torch.int32: (MIN_OLD,)}
_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
# Halo wire codes of csrc/round_block.cu (halo_round_launch), and the most
# shards one launch takes (kMaxShards).
_WIRE_CODES = {"f32": 0, "int8": 1, "fp8": 2}
MAX_SHARDS = 64


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """A row update ``(old, reduced, rows) -> new`` that K1 evaluates itself.

    ``table`` (``add_table`` only) holds one value per frontier slot, the
    dump row included: ``(n + 1,)``, so ``table[rows]`` never reads past the
    end where padded rows point at the dump slot ``n``.
    """

    tag: str
    const: float = 0.0
    table: torch.Tensor | None = None

    def __post_init__(self):
        if self.tag not in TAG_CODES:
            raise ValueError(f"unknown epilogue tag {self.tag!r}")
        if (self.tag == ADD_TABLE) != (self.table is not None):
            raise ValueError("an add_table epilogue needs a table; no other does")

    def to(self, device) -> "Epilogue":
        if self.table is None:
            return self
        return dataclasses.replace(self, table=self.table.to(device))

    def __call__(self, old, reduced, rows):
        if self.tag == ADD_CONST:
            c = torch.tensor(np.float32(self.const), device=reduced.device)
            return c + reduced
        if self.tag == ADD_TABLE:
            return self.table[rows] + reduced
        return torch.minimum(old, reduced)


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


def _check_args(x_ext, sched, semiring, epilogue) -> None:
    """Raise on anything K1 does not take (runs before any launch)."""
    _check_epilogue(x_ext, semiring, epilogue)
    _check_cuda(x_ext)
    S, P, M, delta = sched.S, sched.P, sched.M, sched.delta
    expect = {
        "x_ext": (x_ext, (sched.n_slots,), x_ext.dtype),
        "src": (sched.src, (S, P, M), torch.int32),
        "val": (sched.val, (S, P, M), x_ext.dtype),
        "row_ptr": (sched.row_ptr, (S, P, delta + 1), torch.int32),
        "rows": (sched.rows, (S, P, delta), torch.int32),
    }
    if epilogue.table is not None:
        expect["table"] = (epilogue.table, (sched.n_slots,), x_ext.dtype)
    _check_tensors(expect, x_ext.device)
    if sched.n_slots >= 2**31:
        raise ValueError("the frontier must have fewer than 2**31 slots")


def _library():
    from repro_torch.kernels.build import load

    lib = load("round_block")
    if lib.round_block_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.round_block_launch.argtypes = (
            [i32] + [ptr] * 7 + [ctypes.c_double] + [i32] * 6 + [ptr]
        )
        lib.round_block_launch.restype = i32
        lib.halo_round_launch.argtypes = (
            [i32] * 2 + [ptr] * 12 + [ctypes.c_double] * 2 + [i32] * 10 + [ptr]
        )
        lib.halo_round_launch.restype = i32
        lib.round_block_error_string.argtypes = [i32]
        lib.round_block_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.round_block_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")


def fused_round_cuda(x_ext, sched, semiring, epilogue) -> torch.Tensor:
    """One round on the card: returns a new ``(n+1,)`` frontier (``x_ext`` is
    left as it was).  Launches on the current stream and does not synchronise.
    The dump slot's value is unspecified."""
    _check_args(x_ext, sched, semiring, epilogue)
    lib = _library()
    out = x_ext.clone()
    scratch = torch.empty(sched.P * sched.delta, dtype=out.dtype, device=out.device)
    table = epilogue.table.data_ptr() if epilogue.table is not None else None
    with torch.cuda.device(out.device):
        err = lib.round_block_launch(
            _DTYPE_CODES[out.dtype],
            out.data_ptr(),
            scratch.data_ptr(),
            sched.src.data_ptr(),
            sched.val.data_ptr(),
            sched.row_ptr.data_ptr(),
            sched.rows.data_ptr(),
            table,
            float(epilogue.const),
            TAG_CODES[epilogue.tag],
            sched.n,
            sched.S,
            sched.P,
            sched.M,
            sched.delta,
            torch.cuda.current_stream(out.device).cuda_stream,
        )
    _raise_on(lib, err, "round_block")
    fused_round_cuda.launches += 1
    return out


fused_round_cuda.launches = 0  # kernel launches, for showing a path used K1




def _check_halo_args(x_loc, ef, sched, plan, semiring, epilogue, halo_dtype, steps):
    """Raise on anything K2 does not take; returns the step range.  The
    shapes are checked before the device, so a CPU call with wrong shapes
    says what is wrong with them."""
    _check_epilogue(x_loc, semiring, epilogue)
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
    expect = {
        "x_loc": (x_loc, (D, L), x_loc.dtype),
        "src_loc": (plan.src_loc, (D, S, P_loc, M), torch.int32),
        "val": (sched.val, (S, P, M), x_loc.dtype),
        "row_ptr": (sched.row_ptr, (S, P, delta + 1), torch.int32),
        "rows": (sched.rows, (S, P, delta), torch.int32),
        "rows_loc": (plan.rows_loc, (D, S, P_loc, delta), torch.int32),
        "send_idx": (plan.send_idx, (S, D, H), torch.int32),
        "recv_idx": (plan.recv_idx, (S, D, D * H), torch.int32),
    }
    if halo_dtype != "f32":
        expect["ef"] = (ef, (D, S, H), torch.float32)
    if epilogue.table is not None:
        expect["table"] = (epilogue.table, (sched.n_slots,), x_loc.dtype)
    _check_tensors(expect, x_loc.device)
    if max(D * L, P * delta, D * D * H) >= 2**31:
        raise ValueError("the halo frontier and its indices must stay below 2**31 entries")
    _check_cuda(x_loc)
    return s0, s1


def fused_halo_round_cuda(
    x_loc, ef, sched, plan, semiring, epilogue, halo_dtype: str = "f32", steps=None
):
    """The commit steps ``steps = (s0, s1)`` (default: all ``S``) of one halo
    round on the card, in one launch, in place on the stacked ``(D, L)``
    frontier ``x_loc`` and, for an int8/fp8 wire, the ``(D, S, H)``
    residuals ``ef`` (``ef`` is not read for f32).  Returns ``(x_loc, ef)``.
    Launches on the current stream and does not synchronise; an empty range
    launches nothing.  The dump slots ``L - 1`` are never written."""
    s0, s1 = _check_halo_args(x_loc, ef, sched, plan, semiring, epilogue, halo_dtype, steps)
    if s0 == s1:
        return x_loc, ef
    lib = _library()
    dev = x_loc.device
    scratch = torch.empty(sched.P * sched.delta, dtype=x_loc.dtype, device=dev)
    quant = halo_dtype != "f32"
    amax = torch.zeros((s1 - s0, plan.D), dtype=torch.int32, device=dev) if quant else None
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
            table,
            float(epilogue.const),
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
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err, "halo_round")
    fused_halo_round_cuda.launches += 1
    return x_loc, ef


fused_halo_round_cuda.launches = 0  # kernel launches, for showing a path used K2
