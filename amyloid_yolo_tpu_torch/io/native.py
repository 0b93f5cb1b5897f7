"""ctypes binding to the port's native tile reader (``csrc/tile_reader.cc``).

Counterpart of the reference package's ``io/native.py``.  The C++ pool
decodes JPEGs with libjpeg on a thread pool and gathers them (nearest) into
a caller-owned NHWC uint8 batch.  The source is the port's own copy of the
reference's; it is compiled with ``g++`` at first use, with the reference
Makefile's flags, into ``<package>/_build/tile_reader-<hash>.so`` (git-
ignored).  The hash covers the source, the flags and the host CPU (the
flags include ``-march=native``), so an edited source or another machine
rebuilds.  One build is attempted per process; where it fails (no ``g++``,
no libjpeg headers) :func:`available` is false and every caller falls back
to PIL, as the reference's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "tile_reader.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_build_attempted = False
_lock = threading.Lock()


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = {l for l in fh if l.startswith(("model name", "flags"))}
        return "".join(sorted(lines)).encode()
    except OSError:
        return platform.processor().encode()


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + _host_cpu())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"tile_reader-{digest.hexdigest()[:16]}.so")


def _build(target: str) -> bool:
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                              capture_output=True, timeout=240)
        if proc.returncode != 0:
            return False
        os.replace(tmp, target)  # atomic: a concurrent process never sees half a file
        return True
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not os.path.exists(target):
            if _build_attempted:
                return None
            _build_attempted = True
            try:
                if not _build(target):
                    return None
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(target)
        except OSError:
            return None
        lib.tile_pool_create.restype = ctypes.c_void_p
        lib.tile_pool_create.argtypes = [ctypes.c_int]
        lib.tile_pool_destroy.restype = None
        lib.tile_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.tile_pool_decode_batch.restype = None
        lib.tile_pool_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.tile_decode_one.restype = ctypes.c_int
        lib.tile_decode_one.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int,
        ]
        lib.tile_decode_mem.restype = ctypes.c_int
        lib.tile_decode_mem.argtypes = [
            ctypes.c_char_p, ctypes.c_ulong, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it on the first call)."""
    return _load() is not None


def _u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class TilePool:
    """Threaded native JPEG batch decoder."""

    def __init__(self, n_threads: Optional[int] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("the tile reader library is unavailable (no g++ or "
                               "no libjpeg headers)")
        self._lib = lib
        self._pool = lib.tile_pool_create(n_threads or max(os.cpu_count() or 1, 1))

    def decode_batch(self, paths: Sequence[str], tile_size: int = 1536,
                     resize_to: int = 0, scale_denom: int = 1) -> tuple:
        """Decode JPEGs → (batch (N, side, side, 3) uint8, ok mask, dims
        (N, 2) int32 of each ORIGINAL source (h, w)); side = ``resize_to``
        or ``tile_size``.

        ``scale_denom > 1`` turns on libjpeg's DCT-domain scaled decode for
        the ``resize_to`` path: the pixels are the scaled rendition, not
        bit-identical to a full decode.
        """
        if self._pool is None:
            raise RuntimeError("TilePool is closed")
        if tile_size <= 0 or resize_to < 0 or scale_denom < 1:
            raise ValueError(f"bad geometry: tile_size={tile_size} resize_to={resize_to} "
                             f"scale_denom={scale_denom}")
        n = len(paths)
        side = resize_to or tile_size
        out = np.empty((n, side, side, 3), np.uint8)
        statuses = (ctypes.c_int * n)()
        dims = np.zeros((n, 2), np.int32)
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        self._lib.tile_pool_decode_batch(
            self._pool, c_paths, n, _u8_ptr(out), tile_size, resize_to, scale_denom,
            statuses, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        ok = np.array([statuses[i] == 0 for i in range(n)], dtype=bool)
        return out, ok, dims

    def close(self) -> None:
        if self._pool:
            self._lib.tile_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):  # pragma: no cover
        if getattr(self, "_pool", None):
            self.close()


def decode_one(path: str, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """Decode one JPEG into an (out_h, out_w, 3) frame: a smaller image is
    zero-filled right and below, a larger one cropped.  ``None`` when the
    library is unavailable or the file is unreadable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.tile_decode_one(path.encode(), _u8_ptr(out), out_h, out_w)
    return out if rc == 0 else None


def decode_tile_bytes(data: bytes, tile_size: int, resize_to: int = 0,
                      scale_denom: int = 1):
    """Decode an in-memory JPEG that is EXACTLY (tile_size, tile_size) →
    (img uint8 (side, side, 3), (src_h, src_w)), side = ``resize_to`` or
    ``tile_size``.

    ``None`` when the library is unavailable, the JPEG is corrupt, or its
    geometry is not the tile's (rejected right after the header).
    ``resize_to`` applies the nearest gather (bit-identical to
    :func:`~amyloid_yolo_tpu_torch.ops.preprocess.nearest_indices`);
    ``scale_denom > 1`` opts into the DCT-scaled decode.  The C call runs
    without the GIL, so request threads decode in parallel.
    """
    lib = _load()
    if lib is None:
        return None
    side = resize_to or tile_size
    out = np.empty((side, side, 3), np.uint8)
    src_h = ctypes.c_int(0)
    src_w = ctypes.c_int(0)
    rc = lib.tile_decode_mem(data, ctypes.c_ulong(len(data)), _u8_ptr(out), tile_size,
                             resize_to, scale_denom, ctypes.byref(src_h),
                             ctypes.byref(src_w))
    if rc != 0:
        return None
    return out, (src_h.value, src_w.value)


__all__ = ["TilePool", "available", "decode_one", "decode_tile_bytes", "library_path",
           "SOURCE", "BUILD_DIR"]
