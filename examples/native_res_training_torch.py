"""Native-resolution training on a (dp, sp) grid of devices, on the PyTorch
port: the counterpart of ``examples/native_res_training.py``.

The original downsamples every 1536² tile to 416² before training, because
one GPU cannot hold native-resolution activations.  This example runs the
port's train step with the image height sharded over the ``sp`` columns of
a (dp, sp) mesh and the batch over its ``dp`` rows
(:func:`amyloid_yolo_tpu_torch.parallel.spatial.shard_spatial_train_step`):
one process drives every shard layer by layer, copying the halo rows
between devices; the BN statistics and the gradients are the global
batch's, the one-device step's up to the order of the sums
(``tests/test_torch_spatial.py``).

The mesh is ``cuda:0 ..`` with one entry a card where there are enough
cards, and repeats the cards otherwise (several shards on one card);
``--device cpu`` makes every entry the CPU.

Usage:
  python examples/native_res_training_torch.py [--sp 4 --dp 2] [--img_size 512]
      [--steps 2] [--batch 2] [--mini] [--device cpu]

The equivalent training command is::

  python -m amyloid_yolo_tpu_torch.cli train --spatial_shard 4 --data_parallel 2 \\
      --img_size 1536 --multiscale_training False ...
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from amyloid_yolo_tpu_torch import graphspec  # noqa: E402
from amyloid_yolo_tpu_torch.models import darknet  # noqa: E402
from amyloid_yolo_tpu_torch.parallel import steps as S  # noqa: E402
from amyloid_yolo_tpu_torch.parallel.spatial import (  # noqa: E402
    make_spatial_mesh, shard_spatial_train_step)


def mini_spec(num_classes: int = 2, img_size: int = 64) -> graphspec.GraphSpec:
    """A four-stage YOLOv3 with narrow widths and one residual unit a
    stage (the test suite's ``mini_spec``)."""
    b = graphspec._Builder(graphspec.NetInfo(width=img_size, height=img_size))
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
    b.yolo(graphspec.YOLOV3_MASKS[0], num_classes)
    for width, skip, mask in ((16, r16, 1), (8, r8, 2)):
        b.route([-4])
        b.conv(width, 1)
        b.upsample(2)
        b.route([-1, skip])
        b.conv(width, 1)
        b.conv(2 * width, 3)
        b.conv(hf, 1, bn=False, act="linear")
        b.yolo(graphspec.YOLOV3_MASKS[mask], num_classes)
    return graphspec._finish(b.net, b.layers, b.out_channels)


def mesh_devices(n: int, device: str) -> list:
    """``n`` mesh entries: the CPU n times, or the cards in turn."""
    if device == "cpu":
        return ["cpu"] * n
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return [f"cuda:{i % cards}" for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sp", type=int, default=4)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--img_size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--mini", action="store_true",
                    help="tiny test architecture instead of the full YOLOv3")
    ap.add_argument("--device", default="cuda", help="cuda (the cards) or cpu")
    args = ap.parse_args(argv)

    spec = (mini_spec(img_size=args.img_size) if args.mini
            else graphspec.yolov3_spec(num_classes=2, img_size=args.img_size))
    mesh = make_spatial_mesh(args.sp, args.dp,
                             devices=mesh_devices(args.sp * args.dp, args.device))
    first = mesh.devices[0]
    params = darknet.init_params(torch.Generator().manual_seed(0), spec)
    opt = S.make_optimizer(1e-3, grad_clip_norm=10.0)
    state = S.init_train_state(params, opt, device=first)
    print(f"mesh: {mesh.shape} over {[str(d) for d in mesh.devices]}")
    step = shard_spatial_train_step(
        S.make_train_step(spec, opt, augment=True, compute_dtype=torch.float32), mesh)

    rng = np.random.RandomState(0)
    gen = torch.Generator(device=first).manual_seed(0)
    B, cap = args.batch, 8
    targets = np.zeros((B * cap, 6), np.float32)
    mask = np.zeros((B * cap,), bool)
    for b in range(B):
        targets[b * cap] = [b, b % 2, 0.5, 0.5, 0.2, 0.2]
        mask[b * cap] = True

    for i in range(args.steps):
        imgs = rng.randint(0, 255, (B, args.img_size, args.img_size, 3)).astype(np.uint8)
        state, metrics = step(state, imgs, targets, mask, gen, args.img_size)
        print(f"step {i}: loss={float(metrics['loss']):.4f}")
    print("ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
