"""K1 wrapper: one full engine round (all S commit steps) in one CUDA launch.

The counterpart of ``repro.kernels.round_block.fused_round_fn_q``.  The
kernel (``csrc/round_block.cu``) runs the S commit steps of a round inside one
persistent cooperative launch, with two grid barriers per step, and computes
exactly what :func:`repro_torch.core.engine.round_fn` computes, bit for bit.

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


def _check_args(x_ext, sched, semiring, epilogue) -> None:
    """Raise on anything the kernel does not take (runs before any launch)."""
    if not isinstance(epilogue, Epilogue):
        raise TypeError(
            "the CUDA round takes only an Epilogue row update "
            f"({', '.join(TAG_CODES)}); got {type(epilogue).__name__}"
        )
    if x_ext.device.type != "cuda":
        raise ValueError(f"the CUDA round needs CUDA tensors, got {x_ext.device}")
    if x_ext.dtype != semiring.torch_dtype:
        raise ValueError(f"x_ext is {x_ext.dtype}, semiring wants {semiring.dtype}")
    if epilogue.tag not in _KERNEL_TAGS.get(x_ext.dtype, ()):
        raise ValueError(f"no {epilogue.tag} epilogue for {x_ext.dtype}")
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
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x_ext.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x_ext.device}")
    if sched.n_slots >= 2**31:
        raise ValueError("the frontier must have fewer than 2**31 slots")


def _library():
    from repro_torch.kernels.build import load

    lib = load("round_block")
    fn = lib.round_block_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_double]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.round_block_error_string.argtypes = [ctypes.c_int]
        lib.round_block_error_string.restype = ctypes.c_char_p
    return lib


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
    if err != 0:
        msg = lib.round_block_error_string(err).decode()
        raise RuntimeError(f"round_block launch failed: cudaError {err} ({msg})")
    fused_round_cuda.launches += 1
    return out


fused_round_cuda.launches = 0  # kernel launches, for showing a path used K1
