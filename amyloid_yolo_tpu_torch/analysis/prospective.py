"""The prospective-validation study: the model against neuropathologists.

Counterpart of the reference package's ``analysis/prospective.py``, after
the original ``prospective.py``: the model's run over the validation
images, annotation conversion, the PRC tables and AP, the consensus and
merged human benchmarks, and the interrater statistics.  Annotation and
prediction dictionaries keep the original's pickle shapes, ``{image name:
[({'x1', 'y1', 'x2', 'y2', ...}, class name), ...]}``, and the PRC tables
its CSV columns and file names, so the artifacts of either package read in
the other.

Host analysis by design; the device work is the detector's run in
:func:`run_model_on_validation_images` (``Detector.detect_folder``, on the
``Detector``'s card).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..detectors import Detector
from ..domain import CAAFilter, get_accuracy, get_tps, iou_xyxy
from ..ops.merge import combine_overlapping_bboxes

AMYLOID_CLASSES = ("Cored", "CAA")


# ---------------------------------------------------------------------------
# Prediction runner (prospective.py:32-93)
# ---------------------------------------------------------------------------

def run_model_on_validation_images(
    detector: Detector,
    image_folder: str,
    out_pickle: str,
    caa_filter: Optional[CAAFilter] = None,
    merge: bool = True,
    classes: Sequence[str] = ("CAA", "Cored"),
    batch_size: int = 8,
) -> Dict[str, list]:
    """Run the detector over a validation folder; save the predictions dict.

    ``merge``/``caa_filter`` correspond to the reference's phase2/
    prospective treatment (``prospective.py:85-87``); phase1 passes
    ``merge=False, caa_filter=None``.
    """
    results = detector.detect_folder(
        image_folder, batch_size=batch_size, merge_boxes=merge,
        caa_filter=(caa_filter.filter_path if caa_filter else None),
    )
    out: Dict[str, list] = {}
    prefix = image_folder if image_folder.endswith("/") else image_folder + "/"
    for path, dets in results.items():
        key = path.replace(prefix, "")
        out[key] = []
        if dets is None:
            continue
        for x1, y1, x2, y2, conf, cls_conf, cls_pred in np.asarray(dets):
            out[key].append((
                {"x1": float(x1), "x2": float(x2), "y1": float(y1), "y2": float(y2),
                 "conf": float(conf), "cls_conf": float(cls_conf),
                 "cls_pred": float(cls_pred)},
                classes[int(cls_pred)],
            ))
    os.makedirs(os.path.dirname(out_pickle) or ".", exist_ok=True)
    with open(out_pickle, "wb") as fh:
        pickle.dump(out, fh)
    return out


def convert_yolo_annotations_to_pickle(labels_dir: str, out_pickle: str,
                                       img_dim: int = 1536) -> Dict[str, list]:
    """YOLO-txt labels → annotation pickle (``prospective.py:95-124``);
    class idx 1 = Cored, else CAA, coords scaled to pixels."""
    annotation_dict: Dict[str, list] = {}
    for label_txt in sorted(os.listdir(labels_dir)):
        img_name = label_txt.replace(".txt", ".jpg")
        annotation_dict[img_name] = []
        with open(os.path.join(labels_dir, label_txt)) as fh:
            for line in fh.read().splitlines():
                if not line.strip():
                    continue
                idx, xc, yc, w, h = [float(x) for x in line.split(" ")]
                xc, yc, w, h = xc * img_dim, yc * img_dim, w * img_dim, h * img_dim
                entry = ({
                    "x1": int(xc - w / 2), "x2": int(xc + w / 2),
                    "y1": int(yc - h / 2), "y2": int(yc + h / 2),
                }, "Cored" if idx == 1 else "CAA")
                annotation_dict[img_name].append(entry)
    with open(out_pickle, "wb") as fh:
        pickle.dump(annotation_dict, fh)
    return annotation_dict


# ---------------------------------------------------------------------------
# PRC tables (prospective.py:126-249)
# ---------------------------------------------------------------------------

def _entries_to_outputs(pred_entries) -> List[list]:
    outputs = []
    for entry in pred_entries:
        if len(entry) == 0:
            continue
        d, _cls = entry[0], entry[1]
        outputs.append([d["x1"], d["y1"], d["x2"], d["y2"], d["conf"],
                        d["cls_conf"], d["cls_pred"]])
    return outputs


def _entries_to_labels(ann_entries) -> List[list]:
    labels = []
    for entry in ann_entries:
        d, cls = entry[0], entry[1]
        labels.append([d["x1"], d["y1"], d["x2"], d["y2"], 1 if cls == "Cored" else 0])
    return labels


def compare_annotations_to_predictions(
    annotations: Dict[str, list],
    predictions: Dict[str, list],
    iou_threshold: float,
    annotator: str,
    val_type: str = "prospective",
    prc_dir: str = "PRC_tables",
    precision_maps_dir: Optional[str] = "pickles/img_precision_maps",
):
    """Build per-class cumulative TP/FP PRC tables and per-image precision
    maps (``prospective.py:126-249``); returns {class: dataframe}."""
    import pandas as pd

    table_cored: List[Tuple[float, int, int]] = []
    table_caa: List[Tuple[float, int, int]] = []
    num_caa_labels = 0
    num_cored_labels = 0
    precision_img_cored: Dict[str, float] = {}
    precision_img_caa: Dict[str, float] = {}

    for img_name in predictions.keys():
        outputs = _entries_to_outputs(predictions[img_name])
        labels = _entries_to_labels(annotations[img_name])
        num_cored_labels += sum(1 for l in labels if l[-1] == 1)
        num_caa_labels += sum(1 for l in labels if l[-1] == 0)
        tps = get_tps(outputs, labels, iou_threshold, pascal_voc_scheme=True)
        c_tp = c_fp = a_tp = a_fp = 0
        for i, flag in enumerate(tps):
            conf = outputs[i][4]
            cls_pred = outputs[i][6]
            row = (conf, 1, 0) if flag == 1 else (conf, 0, 1)
            if cls_pred == 1:
                table_cored.append(row)
                c_tp += flag
                c_fp += 1 - flag
            else:
                table_caa.append(row)
                a_tp += flag
                a_fp += 1 - flag
        precision_img_cored[img_name] = c_tp / float(c_tp + c_fp) if c_tp + c_fp else -1
        precision_img_caa[img_name] = a_tp / float(a_tp + a_fp) if a_tp + a_fp else -1

    if precision_maps_dir:
        os.makedirs(precision_maps_dir, exist_ok=True)
        for amyloid_class, mapp in [("Cored", precision_img_cored), ("CAA", precision_img_caa)]:
            with open(os.path.join(
                    precision_maps_dir,
                    f"{val_type}_precision_img_map_{amyloid_class}_{annotator}_"
                    f"{round(iou_threshold, 2)}.pkl"),
                    "wb") as fh:
                pickle.dump(mapp, fh)

    os.makedirs(prc_dir, exist_ok=True)
    frames = {}
    for amyloid_class, table, n_gt in [("Cored", table_cored, num_cored_labels),
                                       ("CAA", table_caa, num_caa_labels)]:
        table = sorted(table, key=lambda x: x[0], reverse=True)
        df = pd.DataFrame.from_records(table, columns=["Conf", "TP", "FP"])
        df["cumTP"] = df["TP"].cumsum()
        df["cumFP"] = df["FP"].cumsum()
        n = len(df)
        df["Precision"] = [df["cumTP"][i] / float(i + 1) for i in range(n)]
        df["Recall"] = [df["cumTP"][i] / float(n_gt) if n_gt else 0.0 for i in range(n)]
        df.to_csv(os.path.join(
            prc_dir,
            f"{val_type}_PRC_table_{annotator}_iou_{round(iou_threshold, 1)}_{amyloid_class}.csv"))
        frames[amyloid_class] = df
    return frames


def average_precision_from_table(df) -> float:
    """sklearn's ``average_precision_score(TP, Conf)`` of a PRC table
    (``prospective.py:264,299``); where sklearn is absent, the same sum of
    precision times recall steps in numpy."""
    try:
        from sklearn.metrics import average_precision_score

        return float(average_precision_score(list(df["TP"]), list(df["Conf"])))
    except Exception:
        y = np.asarray(df["TP"], float)
        s = np.asarray(df["Conf"], float)
        order = np.argsort(-s, kind="mergesort")
        y = y[order]
        tp = np.cumsum(y)
        precision = tp / (np.arange(len(y)) + 1)
        recall = tp / max(y.sum(), 1e-16)
        r_prev = np.concatenate([[0.0], recall[:-1]])
        return float(np.sum((recall - r_prev) * precision))


def ap_map_from_tables(prc_dir: str, annotators: Sequence[str],
                       val_type: str = "prospective",
                       iou_thresholds: Optional[Sequence[float]] = None) -> Dict:
    """AP per (annotator, class, IoU) from saved PRC tables
    (``plotAPsForProspective``, ``prospective.py:285-301``)."""
    import pandas as pd

    if iou_thresholds is None:
        iou_thresholds = list(np.arange(0.1, 1.0, 0.1))
    ap_map: Dict = {}
    for annotator in annotators:
        ap_map[annotator] = {}
        for amyloid_class in AMYLOID_CLASSES:
            ap_map[annotator][amyloid_class] = {}
            for t in iou_thresholds:
                path = os.path.join(
                    prc_dir,
                    f"{val_type}_PRC_table_{annotator}_iou_{round(t, 1)}_{amyloid_class}.csv")
                df = pd.read_csv(path)
                ap_map[annotator][amyloid_class][t] = average_precision_from_table(df)
    return ap_map


# ---------------------------------------------------------------------------
# Consensus / merged benchmarks (prospective.py:751-874)
# ---------------------------------------------------------------------------

def add_np_label(annotations: Dict[str, list], np_id: str) -> Dict[str, list]:
    """Append the annotator id to each entry (``prospective.py:751-764``)."""
    return {
        img: [(d, cls, np_id) for d, cls in entries]
        for img, entries in annotations.items()
    }


def create_merged_or_consensus_benchmark(
    annotations_by_np: Dict[str, Dict[str, list]],
    benchmark: str = "consensus",
    iou_threshold: float = 0.5,
) -> Dict[str, list]:
    """Build the consensus-of-2 or merged human benchmark
    (``createMergedOrConsensusBenchmark``, ``prospective.py:766-874``).

    consensus: drop boxes with no same-class IoU≥t partner from another
    entry, then for each same-class overlapping pair from different
    annotators drop the larger box.
    merged: union-merge all overlapping same-class boxes
    (:func:`~amyloid_yolo_tpu_torch.ops.merge.combine_overlapping_bboxes`).
    """
    nps = sorted(annotations_by_np.keys())
    merged_dict: Dict[str, list] = {}
    for np_id in nps:
        labeled = add_np_label(annotations_by_np[np_id], np_id)
        for img, entries in labeled.items():
            merged_dict.setdefault(img, [])
            merged_dict[img] += entries

    if benchmark == "consensus":
        for img, entries in merged_dict.items():
            kept = []
            for e1 in entries:
                c1 = e1[0]
                box1 = (c1["x1"], c1["y1"], c1["x2"], c1["y2"])
                for e2 in entries:
                    if e1 == e2:
                        continue
                    c2 = e2[0]
                    box2 = (c2["x1"], c2["y1"], c2["x2"], c2["y2"])
                    if iou_xyxy(box1, box2) >= iou_threshold and e1[1] == e2[1]:
                        kept.append(e1)
                        break
            merged_dict[img] = kept
        for img, entries in merged_dict.items():
            to_remove = []
            for e1 in entries:
                c1 = e1[0]
                box1 = (c1["x1"], c1["y1"], c1["x2"], c1["y2"])
                area1 = (c1["x2"] - c1["x1"]) * (c1["y2"] - c1["y1"])
                for e2 in entries:
                    if e1 == e2:
                        continue
                    c2 = e2[0]
                    box2 = (c2["x1"], c2["y1"], c2["x2"], c2["y2"])
                    area2 = (c2["x2"] - c2["x1"]) * (c2["y2"] - c2["y1"])
                    if (iou_xyxy(box1, box2) >= iou_threshold and e1[1] == e2[1]
                            and area2 > area1 and e1[2] != e2[2]):
                        to_remove.append(e2)
            merged_dict[img] = [e for e in entries if not any(e is r for r in to_remove)]

    elif benchmark == "merged":
        reformatted = {}
        for img, entries in merged_dict.items():
            lst = []
            for d, cls, np_id in entries:
                x1, y1 = int(d["x1"]), int(d["y1"])
                w, h = int(d["x2"]) - x1, int(d["y2"]) - y1
                label = (1, 0, 0) if cls == "Cored" else (0, 0, 1)
                lst.append(((x1, y1, w, h), label))
            reformatted[img] = lst
        combined = combine_overlapping_bboxes(reformatted)
        out = {}
        for img, entries in combined.items():
            lst = []
            for (x1, y1, w, h), label in entries:
                cls = "CAA" if label[2] == 1 else "Cored"
                lst.append(({"x1": x1, "y1": y1, "x2": x1 + w, "y2": y1 + h}, cls, "merged"))
            out[img] = lst
        merged_dict = out

    return {img: [(d, cls) for d, cls, _np in entries]
            for img, entries in merged_dict.items()}


# ---------------------------------------------------------------------------
# Interrater analytics (prospective.py:340-660)
# ---------------------------------------------------------------------------

def get_annotation_overlaps(annotation: Dict[str, list], iou_threshold: float = 0.5) -> int:
    """Self-overlap count within one annotator's set (``prospective.py:340-360``)."""
    overlaps = 0
    for img, entries in annotation.items():
        flat = [[d["x1"], d["y1"], d["x2"], d["y2"], cls] for d, cls in entries]
        for i in range(len(flat)):
            for j in range(i + 1, len(flat)):
                if flat[i][4] == flat[j][4] and iou_xyxy(flat[i][:4], flat[j][:4]) >= iou_threshold:
                    overlaps += 1
    return overlaps


def get_interrater_agreement(
    annotations_by_np: Dict[str, Dict[str, list]], iou_threshold: float = 0.5,
) -> Dict[Tuple[str, str], Dict[str, float]]:
    """Pairwise agreement accuracies (``getInterraterAgreement``,
    ``prospective.py:362-441``), including its one-overlap-per-box rule."""
    nps = sorted(annotations_by_np.keys())
    pairs = []
    for a1 in nps:
        for a2 in nps:
            if a1 != a2 and (a1, a2) not in pairs and (a2, a1) not in pairs:
                pairs.append((a1, a2))
    pair_map: Dict = {}
    for a1, a2 in pairs:
        ann1 = annotations_by_np[a1]
        ann2 = annotations_by_np[a2]
        final1 = {c: [] for c in AMYLOID_CLASSES}
        final2 = {c: [] for c in AMYLOID_CLASSES}
        for img in ann1.keys():
            e1 = [[d["x1"], d["y1"], d["x2"], d["y2"], cls] for d, cls in ann1[img]]
            e2 = [[d["x1"], d["y1"], d["x2"], d["y2"], cls] for d, cls in ann2.get(img, [])]
            for cls in AMYLOID_CLASSES:
                c1 = [x for x in e1 if x[4] == cls]
                c2 = [x for x in e2 if x[4] == cls]
                used = []
                overlaps = 0
                for x1_ in c1:
                    for x2_ in c2:
                        if (iou_xyxy(x1_[:4], x2_[:4]) >= iou_threshold
                                and not any(x1_ is u for u in used)
                                and not any(x2_ is u for u in used)):
                            used += [x1_, x2_]
                            overlaps += 1
                only1, only2 = len(c1) - overlaps, len(c2) - overlaps
                final1[cls] += [1] * overlaps + [1] * only1 + [0] * only2
                final2[cls] += [1] * overlaps + [0] * only1 + [1] * only2
        pair_map[(a1, a2)] = {
            cls: (get_accuracy(final1[cls], final2[cls]) if final1[cls]
                  else float("nan"))  # class absent from both annotators
            for cls in AMYLOID_CLASSES
        }
    return pair_map


def get_precisions_of_annotators_relative_to_each_other(
    annotations_by_np: Dict[str, Dict[str, list]],
    iou_thresholds: Optional[Sequence[float]] = None,
) -> Dict:
    """Merry-go-round precision: each annotator evaluated against each other
    as ground truth (``prospective.py:522-563``)."""
    if iou_thresholds is None:
        iou_thresholds = list(np.arange(0.1, 1.0, 0.1))
    nps = sorted(annotations_by_np.keys())
    out: Dict = {cls: {a1: {a2: {} for a2 in nps if a2 != a1} for a1 in nps}
                 for cls in AMYLOID_CLASSES}
    for t in iou_thresholds:
        for gt_np in nps:
            ann_gt = annotations_by_np[gt_np]
            for pred_np in nps:
                if pred_np == gt_np:
                    continue
                ann_pred = annotations_by_np[pred_np]
                for cls in AMYLOID_CLASSES:
                    tps = fps = 0
                    for img in ann_gt.keys():
                        gt = [[d["x1"], d["y1"], d["x2"], d["y2"], c]
                              for d, c in ann_gt[img] if c == cls]
                        pred = [[d["x1"], d["y1"], d["x2"], d["y2"], c]
                                for d, c in ann_pred.get(img, []) if c == cls]
                        for p in pred:
                            matched = None
                            for g in gt:
                                if iou_xyxy(p[:4], g[:4]) >= t:
                                    matched = g
                                    break
                            if matched is not None:
                                gt.remove(matched)  # one TP per label (VOC)
                                tps += 1
                            else:
                                fps += 1
                    out[cls][gt_np][pred_np][t] = tps / float(tps + fps) if tps + fps else 0.0
    return out


def find_low_performance_images(precision_img_map: Dict[str, float]) -> List[Tuple[str, float]]:
    """Images sorted worst→best precision, -1 (no prediction) excluded
    (``prospective.py:330-338``)."""
    items = sorted(precision_img_map.items(), key=lambda kv: kv[1])
    return [kv for kv in items if kv[1] != -1]


ANNOTATION_TIME_HOURS = {"NP1": 4.3, "NP2": 1.5, "NP3": 2.1, "NP4": 2.2}


__all__ = [
    "run_model_on_validation_images", "convert_yolo_annotations_to_pickle",
    "compare_annotations_to_predictions", "average_precision_from_table",
    "ap_map_from_tables", "add_np_label", "create_merged_or_consensus_benchmark",
    "get_annotation_overlaps", "get_interrater_agreement",
    "get_precisions_of_annotators_relative_to_each_other",
    "find_low_performance_images", "ANNOTATION_TIME_HOURS", "AMYLOID_CLASSES",
]
