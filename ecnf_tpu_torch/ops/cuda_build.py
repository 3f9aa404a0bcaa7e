"""Build and load the port's CUDA kernels (``ecnf_tpu_torch/csrc/*.cu``).

Each source is compiled with nvcc for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/kernels/`` at the
repository root, keyed by a hash of the source, of every ``.cuh`` header
beside it and of the macros in ``ECNF_CUDA_DEFINES`` (space-separated
names, each passed as ``-D``; `kernel_probe.py` builds with
``ECNF_PROBE``); the library is loaded with ctypes.  Nothing here runs when
a module is imported: the CPU tests import every module and have no nvcc.

It also holds the foreign-call code the kernel wrappers share: the binding
of a library's entry points to their C signatures (`bind`), the pointer
arrays (`pointers`), and the one launch call (`launch`: the device, the
current stream, the cudaError check, the launch counters and the FLOP
count).
"""
import ctypes
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

from ecnf_tpu_torch.ops import flops

PTR, I32 = ctypes.c_void_p, ctypes.c_int
MAX_LAYERS = 8  # csrc/egnn_device.cuh: kMaxLayers, the length of every pointer array
_POINTER_ARRAY = PTR * MAX_LAYERS

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


def _defines() -> Tuple[str, ...]:
    return tuple(f"-D{name}" for name in os.environ.get("ECNF_CUDA_DEFINES", "").split())


def _digest(source: Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_defines()).encode())
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
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", *_defines(),
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


def bind(name: str, signatures: Dict[str, list]) -> Callable[[], ctypes.CDLL]:
    """A loader of ``csrc/<name>.cu``'s library with each entry point of
    ``signatures`` declared: its argument types, and an int result (a
    cudaError, or the value the query returns).  The library is built and
    loaded at the loader's first call, once per process."""

    @functools.lru_cache(maxsize=None)
    def library() -> ctypes.CDLL:
        lib = load_library(name)
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, I32
        return lib

    return library


def pointers(xs: Sequence[torch.Tensor]) -> ctypes.Array:
    """The data pointers of ``xs`` as a kernel's ``[kMaxLayers]`` array."""
    return _POINTER_ARRAY(*[x.data_ptr() for x in xs])


def launch(counter, entry, device: torch.device, args: tuple, flop_fn, shape: tuple,
           also=None) -> None:
    """``entry(*args, stream)`` on ``device``'s current stream, without
    synchronising.  A non-zero result (a cudaError) raises RuntimeError
    naming ``counter`` and ``shape`` by ``flop_fn``'s argument names.  Each
    launch adds one to ``counter.launch_count`` (and to ``also``'s, where
    a second wrapper counts it too) and, while `flops.count_fn_flops` runs,
    ``flop_fn(*shape)`` to the count."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        names = inspect.signature(flop_fn).parameters
        raise RuntimeError(f"{counter.__name__}: kernel launch failed (cudaError {err}) for "
                           + " ".join(f"{n}={v}" for n, v in zip(names, shape)))
    counter.launch_count += 1
    if also is not None:
        also.launch_count += 1
    if flops.counting():
        flops.add(flop_fn(*shape))
