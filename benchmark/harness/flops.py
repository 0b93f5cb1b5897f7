"""Operations and bytes, from the frozen ``.cfg`` and the cell's shapes, and
the table of peaks they are held against.

The per-layer metric readers compute their bounds here from what the run
hands them (the layers, the model size, the batch), and find the port's
kernels in the trace by the names of :data:`KERNELS`.

The conv FLOP count walks the layers as ``tools/mfu_torch.py`` walks the
port's graph (multiply-adds × 2 of every convolution at its output size;
BN, activations, decode and NMS are not counted).  The peaks are NVIDIA's
data sheet for one H100 SXM, dense, at the 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..reference.cfg import residual_units

PEAKS: Dict[str, float] = {
    "bf16_flops": 989e12,
    "f32_flops": 67e12,       # outside the tensor cores: the f32 step runs with TF32 off
    "hbm_bytes_per_s": 3.35e12,
}


# the port's kernels as the device trace names them (a part of the name)
KERNELS: Dict[str, str] = {
    "K1": "resize_normalize_kernel",
    "K2": "fused_residual_block_kernel",
}


def kernel_seconds(trace: dict, kernel: str) -> float:
    """Device seconds of the traced kernels whose name holds ``KERNELS[kernel]``."""
    part = KERNELS[kernel]
    return sum(s for n, s in trace["by_name"].items() if part in n)


def spatial_sizes(layers: List[dict], img: int) -> List[int]:
    """The output side of every layer for an ``img``² input."""
    sizes: List[int] = []
    cur = img
    for i, layer in enumerate(layers):
        t = layer["type"]
        if t == "conv" or t == "maxpool":
            cur = cur // layer["stride"]
        elif t == "upsample":
            cur = cur * layer["factor"]
        elif t == "route":
            cur = sizes[layer["srcs"][0]]
        sizes.append(cur)
    return sizes


def conv_flops(layers: List[dict], img: int) -> float:
    """Forward conv FLOPs of one image at ``img``²."""
    sizes = spatial_sizes(layers, img)
    return 2.0 * sum(sizes[i] ** 2 * l["cout"] * l["cin"] * l["k"] ** 2
                     for i, l in enumerate(layers) if l["type"] == "conv")


def train_flops(layers: List[dict], img: int) -> float:
    """A training image's conv FLOPs: 3 × the forward (the backward's data
    and weight gradients are each a forward's worth)."""
    return 3.0 * conv_flops(layers, img)


def residual_unit_shapes(layers: List[dict], img: int) -> List[Tuple[int, int]]:
    """``(side, channels)`` of the input of every residual unit."""
    sizes = spatial_sizes(layers, img)
    return [(sizes[i - 1] if i else img, layers[i]["cin"]) for i in residual_units(layers)]


def residual_unit_bound(layers: List[dict], img: int, batch: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of the residual units at the cell's shapes, in
    bf16: a 1×1 conv from C to C/2 and a 3×3 conv back to C per unit; the
    input read and the output written once each, the weights read once."""
    flops = nbytes = 0.0
    for side, c in residual_unit_shapes(layers, img):
        flops += 2.0 * batch * side * side * (c * (c // 2) + 9 * (c // 2) * c)
        nbytes += 2.0 * (2 * batch * side * side * c + c * (c // 2) + 9 * (c // 2) * c)
    return flops, nbytes


def preprocess_bytes(batch: int, model: int) -> float:
    """The nearest resize's bytes: the uint8 pixels it samples read once
    (``model``² of each tile: the rest of the tile is not needed), the
    bf16 model input written once."""
    return batch * (model * model * 3 + 2 * model * model * 3)
