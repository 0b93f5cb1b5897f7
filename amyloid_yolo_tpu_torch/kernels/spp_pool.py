"""SPP: the stride-1 max-pools of a spatial pyramid pooling block and the
route that joins them with their input, in one pass.

Replaces no Pallas kernel: on the TPU XLA ran each pool and the
concatenate.  In YOLOv4 (``[maxpool]`` 5, 9 and 13 at stride 1, then
``[route] layers=-1,-3,-5,-6``) the block takes a (B, 512, 19, 19) map at
608 and writes the 2048-channel map ``[max13, max9, max5, input]``.  The
plain version :func:`spp_pool_plain` is what the layers compute one by
one: a ``F.max_pool2d`` of each kernel with ``(k - 1) // 2`` of implicit
-inf padding, then ``torch.cat`` in the route's order.  The CUDA source is
``csrc/spp_pool.cu``: one block per image, tile of the map and run of 16
bf16 (8 float32) channels copies its tile into shared memory, folds each
window along its rows and then down its columns in ``max_pool2d``'s order,
doubling the windows' reach a step (radius 1, 2, 4, 6) and keeping the row
folds from one pool to the next wider one, and writes every slice of the
joined map with 16-byte stores.  A map of up to 512 pixels is one tile; a
larger one is cut into tiles that carry a halo of the widest pool's radius.

Bound on an H100: memory, the input read once and the joined map written
once.  At B=64 and 608 that is 23.66 MB and 94.63 MB in bf16, 0.035 ms at
3.35 TB/s; the three library pools re-read 25, 81 and 169 inputs an output
and the cat moves the four maps again.

A max selects one of its inputs, so the kernel and the plain version agree
bit for bit: a window holding a NaN gives a NaN, and among equal maxima
(``-0.0`` and ``+0.0``) the first in the window's raster order, as
``max_pool2d`` does.

:func:`spp_pool` takes 1 to :data:`MAX_POOLS` pools of odd kernels from 3
to :data:`MAX_KERNEL`, the widest whose halo a tile of 512 pixels holds on
any map.  It launches the kernel for a CUDA tensor and counts the launch in
``spp_pool.launches``; on the card an input other than bf16 or float32, or
with channels that do not fill 16-byte vectors, raises.  For a CPU tensor
it returns the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_POOLS = 4     # csrc/spp_pool.cu's kMaxPools
MAX_KERNEL = 21   # a 1-pixel tile and its halo of 10 fill the kernel's 512 pixels
_VEC = {torch.bfloat16: 8, torch.float32: 4}   # elements in 16 bytes


def _lib() -> ctypes.CDLL:
    lib = _build.load("spp_pool")
    fn = lib.amyolo_spp_pool
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P]
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, kernels: Sequence[int], order: Sequence[int]) -> None:
    if x.dim() != 4:
        raise ValueError(f"spp_pool takes (B, C, H, W), got {tuple(x.shape)}")
    if (not 1 <= len(kernels) <= MAX_POOLS
            or any(k < 3 or k > MAX_KERNEL or k % 2 == 0 for k in kernels)):
        raise ValueError(f"spp_pool takes 1 to {MAX_POOLS} odd pool kernels from 3 to "
                         f"{MAX_KERNEL}, got {tuple(kernels)}")
    if sorted(order) != [-1, *range(len(kernels))]:
        raise ValueError(f"the route's order {tuple(order)} must name each of the "
                         f"{len(kernels)} pools and the input (-1) once")


def spp_pool_plain(x: torch.Tensor, kernels: Sequence[int],
                   order: Sequence[int]) -> torch.Tensor:
    """The block layer by layer: each stride-1 ``F.max_pool2d`` of
    ``kernels`` over the NCHW map ``x``, then the route's ``torch.cat``
    over ``order`` (a pool's position in ``kernels``, ``-1`` for ``x``
    itself), in channels_last memory."""
    _check(x, kernels, order)
    return _plain(x, kernels, order)


def _plain(x, kernels, order):
    pools = [F.max_pool2d(x, k, 1, padding=(k - 1) // 2) for k in kernels]
    joined = torch.cat([x if o < 0 else pools[o] for o in order], dim=1)
    return joined.contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=64)
def _pool_args(kernels: Tuple[int, ...], order: Tuple[int, ...], c: int):
    """The pools' radii, ascending, with their slices' channel offsets,
    and the input's offset, as the C entry takes them."""
    slot = {o: pos * c for pos, o in enumerate(order)}
    by_size = sorted(range(len(kernels)), key=lambda j: kernels[j])
    radius = (_I * MAX_POOLS)(*[(kernels[j] - 1) // 2 for j in by_size])
    offset = (_I * MAX_POOLS)(*[slot[j] for j in by_size])
    return radius, offset, slot[-1]


def spp_pool(x: torch.Tensor, kernels: Sequence[int], order: Sequence[int]) -> torch.Tensor:
    """:func:`spp_pool_plain` of ``x`` (B, C, H, W), ``kernels`` and
    ``order``: a new (B, len(order)·C, H, W) tensor in channels_last
    memory, on the card from one launch of the kernel.  ``x`` does not
    require grad (the kernel has no backward)."""
    kernels, order = tuple(kernels), tuple(order)
    _check(x, kernels, order)
    if x.device.type != "cuda":
        return _plain(x, kernels, order)
    if x.dtype not in _VEC:
        raise ValueError(f"spp_pool takes bf16 or float32 on the card, got {x.dtype}")
    if x.requires_grad:
        raise ValueError("spp_pool has no backward: x requires grad")
    b, c, h, w = x.shape
    if c % _VEC[x.dtype]:
        raise ValueError(f"spp_pool on the card takes channels in 16-byte vectors "
                         f"({_VEC[x.dtype]} of {x.dtype}), got {c}")
    out = torch.empty((b, len(order) * c, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % 16:
        x = x.clone(memory_format=torch.channels_last)
    radius, offset, in_offset = _pool_args(kernels, order, c)
    with torch.cuda.device(x.device):
        err = _lib().amyolo_spp_pool(
            x.data_ptr(), out.data_ptr(), b, c, h, w, len(order) * c, len(kernels), radius,
            offset, in_offset, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "spp_pool kernel launch")
    spp_pool.launches += 1
    return out


spp_pool.launches = 0

__all__ = ["MAX_KERNEL", "MAX_POOLS", "spp_pool", "spp_pool_plain"]
