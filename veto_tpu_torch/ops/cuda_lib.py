"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/`` at the repo
root (git-ignored), then loaded with ``ctypes``.  Nothing is compiled when
a module is imported: a library is built at its first use, or by
:func:`build` (which starts one ``nvcc`` per source, all at once).  The
library name carries a hash of its source, so an edited kernel is rebuilt.

Every kernel wrapper in ``ops/`` launches its kernel for CUDA tensors and
runs its plain PyTorch version for CPU tensors.  :func:`plain_kernels`
switches the wrappers to their plain versions on CUDA too; it exists only
so that a comparison run can hold the kernels against their plain versions
on the card, and no code path enters it on its own.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("roi_align", "encoder_layer", "encoder_layer_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_PLAIN_ON_CUDA = False


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources in parallel; returns seconds per source.

    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) goes to ``build/<name>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    took = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.veto_error_string.restype = ctypes.c_char_p
            lib.veto_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    ``cudaGetLastError()`` after its launches)."""
    if status != 0:
        raise RuntimeError(
            f"{what}: CUDA error {status} "
            f"({lib.veto_error_string(status).decode()})")


def use_kernel(t) -> bool:
    """True when the wrapper must launch its kernel for tensor ``t``."""
    return t.is_cuda and not _PLAIN_ON_CUDA


@contextlib.contextmanager
def plain_kernels():
    """Run every wrapper's plain PyTorch version, also on CUDA tensors
    (for holding the kernels against their plain versions on the card)."""
    global _PLAIN_ON_CUDA
    prev, _PLAIN_ON_CUDA = _PLAIN_ON_CUDA, True
    try:
        yield
    finally:
        _PLAIN_ON_CUDA = prev


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
