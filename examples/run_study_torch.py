"""The prospective study, end to end, on the PyTorch port.

The executable form of the original's commented recipe
(``prospective.py:884-916``), through ``amyloid_yolo_tpu_torch``: the
model's predictions over a validation folder → the consensus benchmark of
the annotator sets → PRC tables at every IoU threshold → AP maps and the
study's figures → interrater statistics.  Point it at real artifacts
(annotator pickles, images, weights) or run it on synthetic data with
``--synthetic``.  The model runs on the card unless ``--device cpu`` is
given; without matplotlib the figures are left out and the AP maps still
written.

Usage:
  python examples/run_study_torch.py --synthetic --workdir /tmp/study
  python examples/run_study_torch.py --synthetic --workdir /tmp/study --device cpu
  python examples/run_study_torch.py --images prospective_validation_images/ \
      --weights yolov3_ckpt_105.pth \
      --annotations NP1=NP1_annotations.pkl NP2=... --workdir study_out/
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from amyloid_yolo_tpu_torch.analysis import plots, prospective as P  # noqa: E402
from amyloid_yolo_tpu_torch.detectors import Detector  # noqa: E402
from amyloid_yolo_tpu_torch.domain import CAAFilter  # noqa: E402
from amyloid_yolo_tpu_torch.graphspec import yolov3_spec  # noqa: E402
from amyloid_yolo_tpu_torch.io import weights as W  # noqa: E402


def make_synthetic(workdir: str, n_images: int = 8, seed: int = 0):
    """Images with class-coloured blobs and two annotator sets: NP1 the
    blobs, NP2 NP1 jittered by up to 12 px, about 1 in 4 dropped."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(workdir, "images")
    os.makedirs(img_dir, exist_ok=True)
    annotations = {"NP1": {}, "NP2": {}}
    for i in range(n_images):
        img = rng.randint(0, 90, (1536, 1536, 3)).astype(np.uint8)
        name = f"img_{i}.jpg"
        entries = []
        for _ in range(rng.randint(1, 4)):
            w, h = rng.randint(120, 320, 2)
            x1 = int(rng.randint(0, 1536 - w))
            y1 = int(rng.randint(0, 1536 - h))
            cls = "Cored" if rng.rand() < 0.5 else "CAA"
            img[y1:y1 + h, x1:x1 + w] = (220, 180, 150) if cls == "Cored" else (60, 90, 220)
            entries.append(({"x1": x1, "y1": y1, "x2": x1 + w, "y2": y1 + h}, cls))
        Image.fromarray(img).save(os.path.join(img_dir, name), quality=90)
        annotations["NP1"][name] = entries
        # NP2: jittered copy of NP1 (drops ~1 in 4)
        annotations["NP2"][name] = [
            ({k: int(v + rng.randint(-12, 12)) for k, v in d.items()}, c)
            for d, c in entries if rng.rand() > 0.25
        ]
    return img_dir, annotations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="study_out")
    ap.add_argument("--images", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--annotations", nargs="*", default=[],
                    help="NAME=path_to_pickle pairs")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--conf_thres", type=float, default=0.8)
    ap.add_argument("--caa_filter", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the model (default cuda; raises "
                         "without CUDA unless 'cpu' is given)")
    args = ap.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    if args.synthetic:
        img_dir, annotations_by_np = make_synthetic(args.workdir)
        conf = 0.3  # random weights produce ~0.5-conf detections
    else:
        img_dir = args.images
        annotations_by_np = {}
        for pair in args.annotations:
            name, path = pair.split("=", 1)
            with open(path, "rb") as fh:
                annotations_by_np[name] = pickle.load(fh)
        conf = args.conf_thres

    spec = yolov3_spec(num_classes=2)
    params = W.load_pretrained(spec, args.weights) if args.weights else None
    det = Detector(spec, params, conf_thres=conf, nms_thres=0.4, device=args.device)
    caa = CAAFilter(device=args.device) if args.caa_filter else None

    # 1. model predictions (prospective.py:32-93)
    pred_pkl = os.path.join(args.workdir, "prospective_validation_predictions.pkl")
    predictions = P.run_model_on_validation_images(
        det, img_dir, pred_pkl, caa_filter=caa, merge=True)
    n_det = sum(len(v) for v in predictions.values())
    print(f"[1/5] predictions: {len(predictions)} images, {n_det} detections")

    # 2. consensus benchmark at every IoU threshold (prospective.py:766-874)
    ann_dir = os.path.join(args.workdir, "prospective_annotations")
    os.makedirs(ann_dir, exist_ok=True)
    thresholds = [round(t, 2) for t in np.arange(0.1, 1.0, 0.1)]
    for t in thresholds:
        consensus = P.create_merged_or_consensus_benchmark(
            annotations_by_np, "consensus", t)
        with open(os.path.join(ann_dir, f"consensus_annotations_iou_thresh_{t}.pkl"),
                  "wb") as fh:
            pickle.dump(consensus, fh)
    print(f"[2/5] consensus benchmarks at {len(thresholds)} IoU thresholds")

    # 3. PRC tables per annotator x IoU (prospective.py:126-249)
    prc_dir = os.path.join(args.workdir, "PRC_tables")
    maps_dir = os.path.join(args.workdir, "pickles", "img_precision_maps")
    annotators = ["consensus"] + sorted(annotations_by_np)
    for annotator in annotators:
        for t in thresholds:
            if annotator == "consensus":
                with open(os.path.join(
                        ann_dir, f"consensus_annotations_iou_thresh_{t}.pkl"), "rb") as fh:
                    ann = pickle.load(fh)
            else:
                ann = annotations_by_np[annotator]
            P.compare_annotations_to_predictions(
                ann, predictions, t, annotator, "prospective",
                prc_dir=prc_dir, precision_maps_dir=maps_dir)
    print(f"[3/5] PRC tables for {annotators}")

    # 4. AP maps + figures (prospective.py:251-520, 565-660); without
    # matplotlib, the AP maps and no figures
    figures = os.path.join(args.workdir, "figures")
    ap_pkl = os.path.join(args.workdir, "pickles", "APs_per_annotator.pkl")
    draw = importlib.util.find_spec("matplotlib") is not None
    precisions = P.get_precisions_of_annotators_relative_to_each_other(
        annotations_by_np)
    if draw:
        summary = plots.plot_precisions_relative_to_each_other(
            precisions, figures_dir=figures)
        ap_map = plots.plot_aps_for_prospective(
            prc_dir, figures_dir=figures, annotators=annotators,
            overlay_summary=summary, ap_map_pickle=ap_pkl)
        for annotator in annotators:
            plots.plot_prc(prc_dir, annotator, figures_dir=figures)
        print(f"[4/5] figures -> {figures}")
    else:
        ap_map = P.ap_map_from_tables(prc_dir, annotators, "prospective",
                                      list(np.arange(0.1, 1.0, 0.1)))
        with open(ap_pkl, "wb") as fh:
            pickle.dump(ap_map, fh)
        print(f"[4/5] AP maps -> {ap_pkl} (no figures: matplotlib is not installed)")

    # 5. interrater analytics (prospective.py:340-478)
    pair_map = P.get_interrater_agreement(annotations_by_np, 0.5)
    if draw:
        plots.plot_interrater_agreement(pair_map, figures_dir=figures,
                                        annotators=sorted(annotations_by_np))
    for (a1, a2), v in pair_map.items():
        print(f"[5/5] agreement {a1}-{a2}: "
              + ", ".join(f"{c}={v[c]:.3f}" for c in v))
    print("AP@0.5:", {a: {c: round(ap_map[a][c][0.5], 3) for c in ap_map[a]}
                      for a in annotators})
    return 0


if __name__ == "__main__":
    sys.exit(main())
