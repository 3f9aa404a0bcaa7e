"""Build and load the port's CUDA kernels (``ecnf_tpu_torch/csrc/*.cu``).

Each source is compiled with nvcc for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/kernels/`` at the
repository root, keyed by a hash of the source and of every ``.cuh``
header beside it; the library is loaded with ctypes.  Nothing here runs
when a module is imported: the CPU tests import every module and have no
nvcc.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _digest(source: Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_library(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` for sm_90a, once per source hash.

    Returns ``(library path, build seconds, compiler log)``; seconds is 0
    and the log empty when the library was already built.  The log holds
    ptxas's register, shared-memory and spill lines (``-Xptxas -v``).
    """
    source = _CSRC / f"{name}.cu"
    lib = _BUILD_DIR / f"{name}_{_digest(source)}.so"
    if lib.exists():
        return lib, 0.0, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-I", str(_CSRC), "-o", str(tmp), str(source),
    ]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` library, loaded once per process."""
    return ctypes.CDLL(str(build_library(name)[0]))


def check_tensor(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``x`` is a contiguous, 32-byte aligned ``dtype`` tensor
    of exactly ``shape`` on ``device``: what a kernel's pointer takes."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 32:
        raise ValueError(f"{name} must be 32-byte aligned")
