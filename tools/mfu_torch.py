"""Model FLOP accounting and MFU of the PyTorch port on an NVIDIA H100.

Walks the port's GraphSpec and counts conv multiply-adds at the inference
resolution (the model's compute is almost all convs), then reports model
FLOPs utilization against the H100's published peak for each measured
ms/batch you pass.  The counts equal ``tools/mfu.py``'s.

Usage:
    python tools/mfu_torch.py [--img 416] [--batch 32] [--ms 14.8 107.1]
        [--int8] [--train] [--imgs_per_sec ...]

With no ``--ms`` and no ``--imgs_per_sec`` it prints the FLOP count alone:
a utilization needs a time measured on the card (``bench_torch.py``,
``tools/bench_trainstep_torch.py``).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W power limit
H100_BF16_TFLOPS = 989.0
H100_INT8_TOPS = 1979.0
H100_HBM_TBPS = 3.35


def conv_gflops(spec, img: int) -> float:
    """Forward conv GFLOPs per image (MACs × 2)."""
    from amyloid_yolo_tpu_torch.graphspec import (ConvSpec, MaxPoolSpec, RouteSpec,
                                                  UpsampleSpec)

    sizes = {}
    total_macs = 0
    cur = img
    for i, layer in enumerate(spec.layers):
        if isinstance(layer, ConvSpec):
            cur = cur // layer.stride
            total_macs += (cur * cur) * layer.out_ch * layer.in_ch \
                * layer.kernel * layer.kernel
        elif isinstance(layer, MaxPoolSpec):
            cur = cur // layer.stride  # tiny-YOLO cfgs downsample by pooling
        elif isinstance(layer, UpsampleSpec):
            cur = cur * layer.factor
        elif isinstance(layer, RouteSpec):
            cur = sizes[layer.layers[0]]
        sizes[i] = cur
    return 2.0 * total_macs / 1e9


def train_gflops(spec, img: int) -> float:
    """Train-step conv GFLOPs per image: forward + backward.

    The backward of a conv is two conv-shaped contractions of the forward's
    MAC count each (dL/dx and dL/dw), so forward + backward ≈ 3× forward,
    less layer 0's dL/dx, which is never needed (x is the input).  BN,
    leaky and the loss are elementwise and not counted.
    """
    from amyloid_yolo_tpu_torch.graphspec import ConvSpec

    fwd = conv_gflops(spec, img)
    l0 = spec.layers[0]
    l0_g = 0.0
    if isinstance(l0, ConvSpec):
        cur = img // l0.stride
        l0_g = 2.0 * (cur * cur) * l0.out_ch * l0.in_ch \
            * l0.kernel * l0.kernel / 1e9
    return 3.0 * fwd - l0_g


def utilization(gflop_per_image: float, batch: int, ms: float) -> dict:
    """Achieved TFLOP/s of ``batch`` images in ``ms`` and its share of the
    bf16 and the int8 peak."""
    tflops = gflop_per_image * batch / (ms / 1e3) / 1e3
    return {"tflops": tflops, "mfu_bf16": tflops / H100_BF16_TFLOPS,
            "mfu_int8": tflops / H100_INT8_TOPS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", type=int, default=416)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ms", type=float, nargs="*", default=[],
                    help="ms/batch (or ms/step with --train) measured on the card")
    ap.add_argument("--train", action="store_true",
                    help="account a train step (fwd+bwd ≈ 3× fwd conv FLOPs) "
                         "instead of inference")
    ap.add_argument("--imgs_per_sec", type=float, nargs="*", default=[],
                    help="throughputs measured on the card, in place of --ms")
    ap.add_argument("--int8", action="store_true",
                    help="report against the int8 peak (1979 TOP/s) instead of bf16")
    args = ap.parse_args(argv)

    from amyloid_yolo_tpu_torch.graphspec import yolov3_spec

    spec = yolov3_spec(num_classes=2)
    if args.train:
        g = train_gflops(spec, args.img)
        print(f"train-step conv GFLOPs/image @ {args.img}² (fwd+bwd): "
              f"{g:.1f}  (batch {args.batch}: {g * args.batch / 1e3:.3f} TFLOP)")
    else:
        g = conv_gflops(spec, args.img)
        print(f"conv GFLOPs/image @ {args.img}²: {g:.1f}  "
              f"(batch {args.batch}: {g * args.batch / 1e3:.3f} TFLOP)")
    rates = list(args.ms) + [args.batch / ips * 1e3 for ips in args.imgs_per_sec]
    peak, key = ((H100_INT8_TOPS, "H100 int8") if args.int8
                 else (H100_BF16_TFLOPS, "H100 bf16"))
    for ms in rates:
        u = utilization(g, args.batch, ms)
        print(f"  {ms:6.2f} ms/batch → {u['tflops']:6.1f} TFLOP/s "
              f"= {u['tflops'] / peak * 100:5.2f}% of the {key} peak")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
