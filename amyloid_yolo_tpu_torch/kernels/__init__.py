"""Hand-written Hopper kernels of the port and their launch counters.

* K1 :func:`.preprocess_kernel.resize_normalize` (``csrc/resize_normalize.cu``);
* K2 :func:`.conv_block.fused_residual_block` (``csrc/conv_block.cu``);
* K3 :func:`.int8_block.fused_residual_block_int8` (``csrc/int8_block.cu``);
* the library convs' epilogue :func:`.bias_leaky.bias_leaky`, and for
  Mish convs :func:`.bias_leaky.bias_mish` (``csrc/bias_leaky.cu``), which
  replace no Pallas kernel;
* the SPP block's pools and route :func:`.spp_pool.spp_pool`
  (``csrc/spp_pool.cu``), which replaces no Pallas kernel either.

Each wrapper counts its launches in an integer attribute ``launches``;
:func:`launch_counts` reads and :func:`reset_launch_counts` zeroes those of
the three ports of the JAX package's Pallas kernels (K1, K2, K3), which the
checks of every path compare; the epilogue's and SPP's counts are read
from ``bias_leaky.launches``, ``bias_mish.launches`` and
``spp_pool.launches`` themselves, and the Mish epilogue's launches that
wrote into a route's slice from ``bias_mish.into_route``.
"""

from __future__ import annotations

from typing import Dict

from .bias_leaky import bias_leaky, bias_mish
from .conv_block import fused_residual_block
from .int8_block import fused_residual_block_int8
from .preprocess_kernel import resize_normalize
from .spp_pool import spp_pool

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
           "resize_normalize", "fused_residual_block", "fused_residual_block_int8",
           "bias_leaky", "spp_pool"]
