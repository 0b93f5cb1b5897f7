"""IoU-distance k-means anchor estimation over the training ground truth,
for the PyTorch port (``tools/estimate_anchors.py``'s counterpart: the same
k-means, seeds and report over the port's ``graphspec``; numpy only, so
the anchors equal that tool's exactly).

The standard YOLO anchor-tuning procedure (YOLOv2 paper §"Dimension
Clusters"; darknet `calc_anchors`) that the reference SKIPS: its
``config/create_custom_model.sh`` hardcodes the COCO anchor table
``10,13, 16,30, ... 373,326`` for every experiment, so its anchors are
tuned for COCO objects at 416², not amyloid plaques at any scale; this
tool fits them to the training boxes at the training scale.

Method: cluster GT (w, h) at the target ``--img_size`` with k-means under
``d(box, centroid) = 1 - IoU(box, centroid)`` (both boxes centered at the
origin), seeded k-means++ with ``--restarts`` deterministic restarts, best
mean-IoU clustering wins.  Anchors are emitted area-ascending so
``yolov3_spec``'s standard masks (6-8 → stride 32) keep largest-to-coarsest
assignment, and rounded to ints (darknet cfg convention).

Usage:
    python tools/estimate_anchors_torch.py --train_list /tmp/prospective_data/train.txt \
        --img_size 512 [--k 9] \
        [--emit_cfg amyloid_yolo_tpu_torch/config/yolov3-amyloid-512a.cfg] \
        [--out bench_artifacts/anchors_512.json]

Label files are derived from image paths exactly like the loader
(reference ``utils/datasets.py:65-82``: images→labels, extension→.txt).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from amyloid_yolo_tpu_torch.graphspec import YOLOV3_ANCHORS  # noqa: E402


def label_path(img_path: str) -> str:
    base = img_path.replace("/images/", "/labels/", 1)
    return base.rsplit(".", 1)[0] + ".txt"


def load_wh(train_list: str, img_size: int) -> np.ndarray:
    """GT (w, h) in pixels at ``img_size`` scale, all boxes in the list."""
    wh = []
    with open(train_list) as fh:
        paths = [l.strip() for l in fh if l.strip()]
    for p in paths:
        lp = label_path(p)
        if not os.path.exists(lp):
            continue
        rows = np.loadtxt(lp, ndmin=2)
        if rows.size:
            wh.append(rows[:, 3:5] * float(img_size))
    if not wh:
        raise SystemExit(f"no labels found via {train_list}")
    return np.concatenate(wh, axis=0)


def wh_iou(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """(N, K) IoU of origin-centered boxes."""
    inter = (np.minimum(wh[:, None, 0], centroids[None, :, 0])
             * np.minimum(wh[:, None, 1], centroids[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] + (
        centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def kmeans_iou(wh: np.ndarray, k: int, rng: np.random.RandomState,
               iters: int = 300) -> tuple[np.ndarray, float]:
    # k-means++ seeding under the IoU distance
    centroids = wh[rng.randint(len(wh))][None]
    while len(centroids) < k:
        d = 1.0 - wh_iou(wh, centroids).max(axis=1)
        probs = d / max(d.sum(), 1e-9)
        centroids = np.concatenate(
            [centroids, wh[rng.choice(len(wh), p=probs)][None]])
    assign = None
    for _ in range(iters):
        iou = wh_iou(wh, centroids)
        new_assign = iou.argmax(axis=1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            members = wh[assign == j]
            if len(members):
                # median minimizes robustly under the IoU metric (darknet
                # uses means; median is stabler on 520 boxes)
                centroids[j] = np.median(members, axis=0)
    mean_iou = float(wh_iou(wh, centroids).max(axis=1).mean())
    return centroids, mean_iou


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_list", default="/tmp/prospective_data/train.txt")
    ap.add_argument("--img_size", type=int, default=512)
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--restarts", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--emit_cfg", default=None,
                    help="write a full yolov3 cfg with these anchors")
    ap.add_argument("--out", default=None, help="write a JSON summary")
    args = ap.parse_args()

    wh = load_wh(args.train_list, args.img_size)
    best, best_iou = None, -1.0
    for r in range(args.restarts):
        rng = np.random.RandomState(args.seed + r)
        c, miou = kmeans_iou(wh.copy(), args.k, rng)
        if miou > best_iou:
            best, best_iou = c, miou
    order = np.argsort(best[:, 0] * best[:, 1])
    anchors = [(int(round(w)), int(round(h))) for w, h in best[order]]

    # comparison baseline: the COCO table the reference hardcodes
    coco = np.asarray(YOLOV3_ANCHORS, np.float64)
    coco_iou = float(wh_iou(wh, coco).max(axis=1).mean())
    report = {
        "img_size": args.img_size,
        "n_boxes": int(len(wh)),
        "anchors": anchors,
        "mean_best_iou": round(best_iou, 4),
        "coco_mean_best_iou": round(coco_iou, 4),
        "wh_px_quantiles": {q: [round(float(v), 1) for v in
                                np.quantile(wh, float(q), axis=0)]
                            for q in ("0.05", "0.5", "0.95")},
    }
    print(json.dumps(report, indent=1))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    if args.emit_cfg:
        from amyloid_yolo_tpu_torch.graphspec import emit_cfg, yolov3_spec

        spec = yolov3_spec(num_classes=2, img_size=args.img_size,
                           anchors=anchors)
        with open(args.emit_cfg, "w") as fh:
            fh.write(emit_cfg(spec))
        print(f"cfg -> {args.emit_cfg}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
