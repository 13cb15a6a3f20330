"""The loader's host ops (``host_ops.cpp``), bound with ``ctypes``.

The port's copy of ``veto_tpu/native``: the same C++ (PIL-exact bilinear
resize, BGR255 normalize, depth standardize, and the fused u8 paths that
write straight into a batch slot), the same Python entry points, each of
which returns ``None`` / ``False`` when no library can be had so that the
caller takes its NumPy path.

The library is built by ``g++`` at its first use (never at import) into the
git-ignored ``build/`` at the repo root, named by a hash of the source.  The
build is atomic across processes: under an ``fcntl`` lock on
``build/libveto_host.lock`` the first process compiles to a temporary name
and moves it into place with ``os.replace``; the others wait on the lock
and then load the finished file.  So any number of processes starting at
once all load a whole library.  :data:`PATH_TAKEN` (and the
``veto_tpu_torch.native`` logger) says which path this process took:
``"built"``, ``"loaded"`` or ``"numpy"`` (no compiler or no library).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

log = logging.getLogger(__name__)
PATH_TAKEN: Optional[str] = None  # "built" | "loaded" | "numpy", once tried
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """The library of this source: ``build/libveto_host-<hash>.so``."""
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libveto_host-{digest.hexdigest()[:12]}.so"


def _build_or_find(path: Path) -> str:
    """Make sure ``path`` holds a whole library; returns ``"built"`` or
    ``"loaded"``.  Raises when the compiler fails."""
    if path.exists():
        return "loaded"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "libveto_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if path.exists():  # another process built it while we waited
            return "loaded"
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, path)
        finally:
            if tmp.exists():
                tmp.unlink()
    return "built"


def _declare(lib: ctypes.CDLL) -> None:
    f32p, u8p, i = (ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int)
    lib.resize_bilinear_f32.argtypes = [f32p, i, i, i, f32p, i, i]
    lib.normalize_bgr255_pad.argtypes = [f32p, i, i, f32p, i, i, f32p, f32p, i]
    lib.standardize_pad.argtypes = [f32p, i, i, f32p, i, i]
    lib.resize_normalize_u8_pad.argtypes = [u8p, i, i, f32p, i, i, i, i,
                                            f32p, f32p, i]
    lib.resize_standardize_pad.argtypes = [f32p, i, i, f32p, i, i, i, i]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, PATH_TAKEN
    with _lock:
        if PATH_TAKEN is not None:
            return _lib
        path = library_path()
        t0 = time.perf_counter()
        try:
            taken = _build_or_find(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
        except (OSError, subprocess.SubprocessError) as err:
            PATH_TAKEN = "numpy"
            log.warning("host ops: no library (%s); the loader takes its "
                        "NumPy path", err)
            return None
        PATH_TAKEN, _lib = taken, lib
        log.info("host ops: %s %s in %.1f s", taken, path,
                 time.perf_counter() - t0)
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def resize_bilinear(image: np.ndarray, oh: int, ow: int) -> Optional[np.ndarray]:
    """(H, W, C) float32 → (oh, ow, C) float32, PIL-BILINEAR semantics.
    Returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(image, dtype=np.float32)
    h, w, c = src.shape
    dst = np.empty((oh, ow, c), np.float32)
    lib.resize_bilinear_f32(_fptr(src), h, w, c, _fptr(dst), oh, ow)
    return dst


def normalize_bgr255_pad(image: np.ndarray, ph: int, pw: int, mean, std,
                         to_bgr255: bool = True) -> Optional[np.ndarray]:
    """RGB float[0,1] (H, W, 3) → normalized BGR*255 padded to (ph, pw, 3)."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(image, dtype=np.float32)
    h, w, _ = src.shape
    dst = np.empty((ph, pw, 3), np.float32)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    lib.normalize_bgr255_pad(_fptr(src), h, w, _fptr(dst), ph, pw, _fptr(m),
                             _fptr(s), 1 if to_bgr255 else 0)
    return dst


def standardize_pad(depth: np.ndarray, ph: int, pw: int) -> Optional[np.ndarray]:
    """(H, W, 1) float32 → per-image standardized, padded to (ph, pw, 1)."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(depth[..., 0], dtype=np.float32)
    h, w = src.shape
    dst = np.empty((ph, pw), np.float32)
    lib.standardize_pad(_fptr(src), h, w, _fptr(dst), ph, pw)
    return dst[..., None]


def resize_normalize_u8_into(image_u8: np.ndarray, oh: int, ow: int,
                             dst: np.ndarray, mean, std,
                             to_bgr255: bool = True) -> bool:
    """The loader's fused path: u8 RGB (H, W, 3) → resize (PIL BILINEAR) →
    BGR255-normalize → the (ph, pw, 3) float32 ``dst`` slot, zero-padded.
    Resize is linear, so this matches the [0, 1] float pipeline to float
    rounding.  Returns False when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    src = np.ascontiguousarray(image_u8, dtype=np.uint8)
    h, w, _ = src.shape
    if dst.dtype != np.float32 or not dst.flags.c_contiguous:
        raise ValueError("dst must be a C-contiguous float32 slot")
    ph, pw, _ = dst.shape
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    lib.resize_normalize_u8_pad(_u8ptr(src), h, w, _fptr(dst), oh, ow, ph, pw,
                                _fptr(m), _fptr(s), 1 if to_bgr255 else 0)
    return True


def resize_standardize_into(depth: np.ndarray, oh: int, ow: int,
                            dst: np.ndarray) -> bool:
    """The fused depth path: (H, W[, 1]) float32 → resize → per-image
    standardize of the resized map → the (ph, pw[, 1]) ``dst`` slot."""
    lib = _load()
    if lib is None:
        return False
    src = depth[..., 0] if depth.ndim == 3 else depth
    src = np.ascontiguousarray(src, dtype=np.float32)
    h, w = src.shape
    d2 = dst[..., 0] if dst.ndim == 3 else dst
    if d2.dtype != np.float32 or not d2.flags.c_contiguous:
        raise ValueError("dst must be a C-contiguous float32 slot")
    ph, pw = d2.shape
    lib.resize_standardize_pad(_fptr(src), h, w, _fptr(d2), oh, ow, ph, pw)
    return True
