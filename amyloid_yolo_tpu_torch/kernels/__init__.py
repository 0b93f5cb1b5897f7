"""Hand-written Hopper kernels of the port and their launch counters.

* K1 :func:`.preprocess_kernel.resize_normalize` (``csrc/resize_normalize.cu``);
* K2 :func:`.conv_block.fused_residual_block` (``csrc/conv_block.cu``);
* K3 :func:`.int8_block.fused_residual_block_int8` (``csrc/int8_block.cu``).

Each wrapper counts its launches in an integer attribute ``launches``;
:func:`launch_counts` reads them and :func:`reset_launch_counts` sets them
to 0.
"""

from __future__ import annotations

from typing import Dict

from .conv_block import fused_residual_block
from .int8_block import fused_residual_block_int8
from .preprocess_kernel import resize_normalize

WRAPPERS = {
    "resize_normalize": resize_normalize,
    "fused_residual_block": fused_residual_block,
    "fused_residual_block_int8": fused_residual_block_int8,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts",
           "resize_normalize", "fused_residual_block", "fused_residual_block_int8"]
