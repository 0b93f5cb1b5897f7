"""K1: fused nearest resize + scale, uint8 NHWC tiles → bf16 NHWC model input.

Replaces the reference package's Pallas kernel
``pallas/preprocess_kernel.py:resize_normalize`` (``pl.pallas_call`` at
``:90``).  The CUDA source is ``csrc/resize_normalize.cu``: a direct gather,
one thread per output pixel, with the row/column index tables computed here
by :func:`~amyloid_yolo_tpu_torch.ops.preprocess.nearest_indices` and passed
in as int32 device arrays.

Bound on an H100: memory — per 1536² tile 416·1536·3 = 1.92 MB read (every
sector of the selected rows is touched) and 416²·3·2 = 1.04 MB written,
~0.88 µs at 3.35 TB/s.

The kernel writes bf16 directly: the executor casts its input to the
compute dtype on entry, so fusing that cast changes nothing.  Its IEEE
``u8 / 255`` rounded to bf16 equals ``bf16(u8 · float32(1/255))`` — the
reference's compiled ``preprocess_tiles`` — for all 256 values, so K1 is
bit-exact to :func:`resize_normalize_plain`.

:func:`resize_normalize` launches the kernel for a CUDA tensor and counts
the launch in ``resize_normalize.launches``; for a CPU tensor it runs the
plain version; any other input raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.preprocess import RECIP_255, nearest_indices
from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("resize_normalize")
    fn = lib.amyolo_resize_normalize
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=8)
def _tables(hs: int, ws: int, dst: int, device: torch.device):
    ri = torch.from_numpy(nearest_indices(dst, hs)).to(device)
    ci = torch.from_numpy(nearest_indices(dst, ws)).to(device)
    return ri, ci


def _index_tables(tiles_u8: torch.Tensor, dst: int):
    """int32 row/column index tables on the tiles' device, made once per
    shape (a host→device copy per batch would stall the launch queue)."""
    return _tables(tiles_u8.shape[1], tiles_u8.shape[2], dst, tiles_u8.device)


def resize_normalize_plain(tiles_u8: torch.Tensor, dst: int) -> torch.Tensor:
    """Plain PyTorch K1: gather, scale in f32, round to bf16."""
    ri, ci = _index_tables(tiles_u8, dst)
    x = tiles_u8.index_select(1, ri).index_select(2, ci)
    return (x.to(torch.float32) * RECIP_255).to(torch.bfloat16)


def resize_normalize(tiles_u8: torch.Tensor, dst: int = 416) -> torch.Tensor:
    """(B, Hs, Ws, 3) uint8 → (B, dst, dst, 3) bf16 in [0, 1]."""
    if tiles_u8.dtype != torch.uint8 or tiles_u8.dim() != 4 or tiles_u8.shape[3] != 3:
        raise ValueError("resize_normalize takes (B, H, W, 3) uint8 tiles, got "
                         f"{tuple(tiles_u8.shape)} {tiles_u8.dtype}")
    if tiles_u8.device.type == "cpu":
        return resize_normalize_plain(tiles_u8, dst)
    if tiles_u8.device.type != "cuda":
        raise ValueError(f"resize_normalize: unsupported device {tiles_u8.device}")
    if not tiles_u8.is_contiguous():
        raise ValueError("resize_normalize: tiles must be contiguous NHWC")
    b, hs, ws, _ = tiles_u8.shape
    ri, ci = _index_tables(tiles_u8, dst)
    out = torch.empty((b, dst, dst, 3), dtype=torch.bfloat16, device=tiles_u8.device)
    lib = _lib()
    with torch.cuda.device(tiles_u8.device):
        err = lib.amyolo_resize_normalize(
            tiles_u8.data_ptr(), ri.data_ptr(), ci.data_ptr(), out.data_ptr(),
            b, hs, ws, dst, dst, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "resize_normalize kernel launch")
    resize_normalize.launches += 1
    return out


resize_normalize.launches = 0

__all__ = ["resize_normalize", "resize_normalize_plain"]
