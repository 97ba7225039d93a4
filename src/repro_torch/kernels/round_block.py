"""K1 and K2 wrappers: the round kernel and the halo commit-step kernel.

K1 (:func:`fused_round_cuda`) is the counterpart of
``repro.kernels.round_block.fused_round_fn_q``.  Its kernel
(``csrc/round_block.cu``) runs the S commit steps of a round inside one
persistent cooperative launch, with two grid barriers per step; a block
stages a tile of rows' edges and folds each row in edge order, so it
computes exactly what :func:`repro_torch.core.engine.round_fn` computes, bit
for bit.

K2 (:func:`fused_halo_step_cuda`) is the counterpart of
``repro.kernels.round_block.fused_halo_step_fn``: one shard's commit step of
the owner-computes halo round, on the shard's local ``(L,)`` frontier, plus
the selection of the ``(H,)`` boundary rows it ships.  It is a second entry
point of the same source, shares K1's epilogues and sums each row in K1's
order (one thread a row).

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

__all__ = [
    "ADD_CONST",
    "ADD_TABLE",
    "MIN_OLD",
    "Epilogue",
    "HaloStep",
    "fused_halo_step_cuda",
    "fused_round_cuda",
]

ADD_CONST = "add_const"  # c + reduced            (pagerank)
ADD_TABLE = "add_table"  # table[row] + reduced   (ppr's q, jacobi's b/diag)
MIN_OLD = "min_old"  # min(old, reduced)          (sssp, cc)

# Tag codes of csrc/round_block.cu, and the tags the kernel takes per dtype.
TAG_CODES = {ADD_CONST: 0, ADD_TABLE: 1, MIN_OLD: 2}
_KERNEL_TAGS = {torch.float32: (ADD_CONST, ADD_TABLE), torch.int32: (MIN_OLD,)}
_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}


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


def _check_epilogue(x, semiring, epilogue) -> None:
    if not isinstance(epilogue, Epilogue):
        raise TypeError(
            "the CUDA kernels take only an Epilogue row update "
            f"({', '.join(TAG_CODES)}); got {type(epilogue).__name__}"
        )
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {x.device}")
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
        lib.halo_step_launch.argtypes = (
            [i32] + [ptr] * 10 + [ctypes.c_double] + [i32] * 6 + [ptr]
        )
        lib.halo_step_launch.restype = i32
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


@dataclasses.dataclass(frozen=True)
class HaloStep:
    """One shard's inputs to one halo commit step (views into the schedule
    and the plan, never copies).

    ``src`` holds the shard's local frontier slots (owned, then halo; dump
    ``L - 1``) in the schedule's ``(P_loc, M)`` edge order, so the
    schedule's ``dst_local`` and ``row_ptr`` for the shard's workers still
    give each row its edges.  ``rows_g`` are the global row ids the row
    update sees (dump ``n``), ``rows_loc`` the local slots it reads ``old``
    from and publishes to (dump ``L - 1``), ``send_idx`` the ``(H,)``
    positions of the boundary rows in the flat ``(P_loc·δ,)`` chunk.
    """

    n: int
    src: torch.Tensor  # (P_loc, M) int32
    val: torch.Tensor  # (P_loc, M)
    dst_local: torch.Tensor  # (P_loc, M) int32
    row_ptr: torch.Tensor  # (P_loc, delta + 1) int32
    rows_g: torch.Tensor  # (P_loc, delta) int32
    rows_loc: torch.Tensor  # (P_loc, delta) int32
    send_idx: torch.Tensor  # (H,) int32


def fused_halo_step_cuda(x_loc, step: HaloStep, semiring, epilogue) -> torch.Tensor:
    """One halo commit step on the card, in place on the shard's ``(L,)``
    frontier ``x_loc``; returns the ``(H,)`` boundary rows it commits.
    Launches on the current stream and does not synchronise.  The dump
    slot ``L - 1`` is never written."""
    _check_epilogue(x_loc, semiring, epilogue)
    P_loc, M = step.src.shape
    delta, H = step.rows_loc.shape[1], step.send_idx.shape[0]
    expect = {
        "x_loc": (x_loc, tuple(x_loc.shape[:1]), x_loc.dtype),
        "src": (step.src, (P_loc, M), torch.int32),
        "val": (step.val, (P_loc, M), x_loc.dtype),
        "row_ptr": (step.row_ptr, (P_loc, delta + 1), torch.int32),
        "rows_g": (step.rows_g, (P_loc, delta), torch.int32),
        "rows_loc": (step.rows_loc, (P_loc, delta), torch.int32),
        "send_idx": (step.send_idx, (H,), torch.int32),
    }
    if epilogue.table is not None:
        expect["table"] = (epilogue.table, (step.n + 1,), x_loc.dtype)
    _check_tensors(expect, x_loc.device)
    lib = _library()
    scratch = torch.empty(P_loc * delta, dtype=x_loc.dtype, device=x_loc.device)
    send = torch.empty(H, dtype=x_loc.dtype, device=x_loc.device)
    table = epilogue.table.data_ptr() if epilogue.table is not None else None
    with torch.cuda.device(x_loc.device):
        err = lib.halo_step_launch(
            _DTYPE_CODES[x_loc.dtype],
            x_loc.data_ptr(),
            scratch.data_ptr(),
            send.data_ptr(),
            step.src.data_ptr(),
            step.val.data_ptr(),
            step.row_ptr.data_ptr(),
            step.rows_g.data_ptr(),
            step.rows_loc.data_ptr(),
            step.send_idx.data_ptr(),
            table,
            float(epilogue.const),
            TAG_CODES[epilogue.tag],
            x_loc.shape[0],
            P_loc,
            M,
            delta,
            H,
            torch.cuda.current_stream(x_loc.device).cuda_stream,
        )
    _raise_on(lib, err, "halo_step")
    fused_halo_step_cuda.launches += 1
    return send


fused_halo_step_cuda.launches = 0  # kernel launches, for showing a path used K2
