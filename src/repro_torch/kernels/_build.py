"""Builds the hand-written CUDA kernels at first use and loads them.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (all
sources at once, one ``nvcc`` process each) and linked into one shared
library with a plain C interface, which ``ctypes`` loads.  The library
lands in ``build/`` beside this file (listed in ``.gitignore``) under a
name keyed by the hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is not.  A kernel that cannot be built,
loaded or launched raises :class:`KernelError`, which the autotuner lets
through: a broken hand-written kernel must never lose a timing race
quietly.  Each object's ``ptxas`` report (registers, shared memory,
spills) is kept next to it as ``<name>.log``.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types; each returns cudaGetLastError()
SIGNATURES = {
    "repro_gemm_f32": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "repro_conv2d_f32": [_P, _P, _P, _P] + [_I] * 15 + [_P],
    "repro_skinny_gemm": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    "repro_wino_gemm": [_P, _P, _P, _P] + [_I] * 9 + [_P],
}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
                 else None, shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless the current library exists."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{so.stem}_{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, obj, proc in jobs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", NVCC_FLAGS[0], *(str(o) for _, o, _ in jobs),
         "-o", str(tmp)], capture_output=True, text=True)
    if link.returncode:
        raise KernelError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, so)
    for _, obj, _ in jobs:
        obj.unlink()
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' library, built if needed; raises without a card."""
    if not torch.cuda.is_available():
        raise KernelError("the CUDA kernels need a CUDA device")
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise KernelError(f"{what} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as a pointer: the raw
    handle, without the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` builds on every call, a large share of
    a small GEMM's launch time on the host."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
