"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``<package>/_build/<name>-<hash>.so`` (a git-ignored directory);
the hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source rebuilds and an unchanged one loads the
existing library.  :func:`build_all` starts one
``nvcc`` per source, all at once.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC``, and deliberately no ``--use_fast_math`` (K1 needs IEEE division).
nvcc still contracts ``a*b+c`` into an FMA; K3's epilogue and the conv
epilogue ``bias_leaky``, which must not, spell out their roundings with
``__fmul_rn``/``__fadd_rn``.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises if
it is not 0.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("resize_normalize", "conv_block", "int8_block", "bias_leaky", "spp_pool")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    return _target(name)


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(process, tmp_path, target)`` or ``None``."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out.decode(errors='replace')}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every listed source that is not built yet, in parallel."""
    started = {n: _start(n) for n in names}
    errors = []
    for n, s in started.items():
        try:
            _finish(n, s)
        except RuntimeError as e:  # wait for every nvcc before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(_target(name))
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


__all__ = ["build_all", "load", "check", "library_path", "BUILD_DIR", "CSRC", "SOURCES"]
