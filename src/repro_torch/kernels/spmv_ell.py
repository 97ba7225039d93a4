"""K3 wrapper: semiring SpMV over a padded ELL layout, on the card.

The counterpart of ``repro.kernels.spmv_ell.spmv_ell``:
``out[r] = ⊕_j x_ext[idx[r, j]] ⊗ val[r, j]`` for a vector ``x_ext``
``(n_slots,)`` or a matrix ``(n_slots, F)``.  The kernel
(``csrc/spmv_ell.cu``) stages a tile of rows a column chunk at a time
(coalesced loads, the gathers in parallel, products in shared memory) and
folds each ``(row, feature)`` output in column order, so it equals its plain
version (:func:`repro_torch.kernels.ref.spmv_ell_ref`) bit for bit.  Padding
entries gather any slot and carry the annihilating value
(:func:`repro_torch.kernels.ops.ell_from_csr`).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["SEMIRINGS", "spmv_ell_cuda"]

#: semiring name → (code of csrc/spmv_ell.cu, the dtype it takes)
SEMIRINGS = {"plus_times": (0, torch.float32), "min_plus": (1, torch.int32)}


def _library():
    from repro_torch.kernels.build import load

    lib = load("spmv_ell")
    if lib.spmv_ell_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.spmv_ell_launch.argtypes = [ctypes.c_int] + [ptr] * 4 + [
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
            ptr,
        ]
        lib.spmv_ell_launch.restype = ctypes.c_int
        lib.spmv_ell_error_string.argtypes = [ctypes.c_int]
        lib.spmv_ell_error_string.restype = ctypes.c_char_p
    return lib


def spmv_ell_cuda(x_ext, idx, val, semiring: str = "plus_times") -> torch.Tensor:
    """``(rows,)+feat`` SpMV on the card; launches on the current stream and
    does not synchronise."""
    if semiring not in SEMIRINGS:
        raise ValueError(f"semiring must be one of {tuple(SEMIRINGS)}, got {semiring!r}")
    code, dtype = SEMIRINGS[semiring]
    if x_ext.device.type != "cuda":
        raise ValueError(f"the CUDA SpMV needs CUDA tensors, got {x_ext.device}")
    if x_ext.ndim not in (1, 2) or idx.ndim != 2 or val.shape != idx.shape:
        raise ValueError(
            f"want x (n_slots,) or (n_slots, F) and idx, val (rows, max_deg); got "
            f"{tuple(x_ext.shape)}, {tuple(idx.shape)}, {tuple(val.shape)}"
        )
    for name, t, want in (("x_ext", x_ext, dtype), ("idx", idx, torch.int32), ("val", val, dtype)):
        if t.dtype != want:
            raise ValueError(f"{name}: want {want} for {semiring}, got {t.dtype}")
        if t.device != x_ext.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x_ext.device}")
    rows, max_deg = idx.shape
    feat = tuple(x_ext.shape[1:])
    lib = _library()
    out = torch.empty((rows,) + feat, dtype=dtype, device=x_ext.device)
    with torch.cuda.device(x_ext.device):
        err = lib.spmv_ell_launch(
            code,
            x_ext.data_ptr(),
            idx.data_ptr(),
            val.data_ptr(),
            out.data_ptr(),
            rows,
            max_deg,
            feat[0] if feat else 1,
            torch.cuda.current_stream(x_ext.device).cuda_stream,
        )
    if err != 0:
        msg = lib.spmv_ell_error_string(err).decode()
        raise RuntimeError(f"spmv_ell launch failed: cudaError {err} ({msg})")
    spmv_ell_cuda.launches += 1
    return out


spmv_ell_cuda.launches = 0  # kernel launches, for showing a path used K3
