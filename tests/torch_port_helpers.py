"""Shared fixtures of the PyTorch-port parity tests (``test_torch_*.py``).

``port_mini_spec`` builds ``minispec.mini_spec``'s graph with the port's own
builder; ``jax_params_np`` makes JAX reference-scheme weights and hands them
over as numpy, the form both packages take.
"""

import jax
import numpy as np

from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu_torch.graphspec import NetInfo, YOLOV3_MASKS, _Builder, _finish


def port_mini_spec(num_classes: int = 2, img_size: int = 64):
    """``tests/minispec.py:mini_spec`` through the port's ``_Builder``."""
    b = _Builder(NetInfo(width=img_size, height=img_size))
    hf = 3 * (5 + num_classes)

    def res(f):
        b.conv(f // 2, 1)
        b.conv(f, 3)
        b.shortcut(-3)

    b.conv(4, 3)
    b.conv(8, 3, stride=2)
    res(8)
    b.conv(16, 3, stride=2)
    res(16)
    r8 = b.i - 1
    b.conv(32, 3, stride=2)
    res(32)
    r16 = b.i - 1
    b.conv(64, 3, stride=2)
    res(64)

    b.conv(32, 1)
    b.conv(64, 3)
    b.conv(hf, 1, bn=False, act="linear")
    b.yolo(YOLOV3_MASKS[0], num_classes)

    b.route([-4])
    b.conv(16, 1)
    b.upsample(2)
    b.route([-1, r16])
    b.conv(16, 1)
    b.conv(32, 3)
    b.conv(hf, 1, bn=False, act="linear")
    b.yolo(YOLOV3_MASKS[1], num_classes)

    b.route([-4])
    b.conv(8, 1)
    b.upsample(2)
    b.route([-1, r8])
    b.conv(8, 1)
    b.conv(16, 3)
    b.conv(hf, 1, bn=False, act="linear")
    b.yolo(YOLOV3_MASKS[2], num_classes)
    return _finish(b.net, b.layers, b.out_channels)


def jax_params_np(spec, seed: int, bn_noise: bool = False):
    """JAX ``init_params`` weights as numpy.  ``bn_noise`` randomises the BN
    shift and running stats (numpy seed ``seed``) so folding is exercised."""
    params = jax.tree.map(np.asarray,
                          jax_darknet.init_params(jax.random.PRNGKey(seed), spec))
    if bn_noise:
        rng = np.random.RandomState(seed)
        for k, v in params.items():
            if k.startswith("bn_"):
                n = v["bias"].shape[0]
                v["bias"] = (0.1 * rng.randn(n)).astype(np.float32)
                v["mean"] = (0.1 * rng.randn(n)).astype(np.float32)
                v["var"] = (0.5 + rng.rand(n)).astype(np.float32)
    return params
