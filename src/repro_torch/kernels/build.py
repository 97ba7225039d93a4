"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles into its own
shared library under ``build/kernels/`` at the root of the checkout, at first
use.  The library's file name carries a digest of its source and flags, so a
changed source is rebuilt and a stale library is never loaded.  Nothing here
runs at import, so the module imports on a machine without ``nvcc``; the
build itself needs ``nvcc`` and targets Hopper (``sm_90a``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "NVCC_FLAGS", "build", "build_log", "load", "load_seconds", "nvcc_command"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("round_block", "spmv_ell")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",  # keep ⊗ and ⊕ unfused: bit-identity with the reference
    "-Xptxas=-v",  # registers and spills, for the build log
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> dict:
    """Compile ``names`` (one ``nvcc`` each, all started together).

    Returns ``{name: (seconds, nvcc's stderr)}``; raises with the compiler's
    output if any build fails.  A library already built is not rebuilt; its
    build's output stays readable through :func:`build_log`.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                nvcc_command(name, tmp),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
            time.perf_counter(),
        )
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        done[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def build_log(name: str) -> str:
    """What ``nvcc`` printed (``-Xptxas=-v``: registers, shared memory,
    spills) when the current library of ``csrc/<name>.cu`` was built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))


def load_seconds(backend: str, device, name: str = "round_block") -> float:
    """Seconds spent loading ``csrc/<name>.cu``'s library (building it on
    first use) for a ``backend="kernel"`` solve on a CUDA ``device``; 0.0
    for any other backend or device, where no kernel runs."""
    if backend != "kernel" or device.type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    load(name)
    return time.perf_counter() - t0
