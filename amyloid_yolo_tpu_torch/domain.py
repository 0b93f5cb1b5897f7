"""Domain layer: the study metrics, the consensus-model CAA filter, the
weak-label maps and the helpers of the CLI.

Counterpart of the reference package's ``domain.py``:

* :func:`iou_xyxy` (alias :data:`IOU`), :func:`get_accuracy` and
  :func:`get_tps` (its ``:39-95``), the study metrics of the original
  ``core.py:497-571``, host Python like the reference's;
* :class:`CAAFilter`, :func:`_crop` (its ``:102-197``), which reproduce the
  original ``filterDetectionsByCAAModel`` (``core.py:425-452``) with one
  resident classifier and one batched call per tile;
* :func:`write_caa_detections` (its ``:200``), the original
  ``writeCAADetectionsToPickle`` (``core.py:454-480``) with its centre
  quirk: centres are (x2-x1)/2, relative to the box, not absolute;
* :func:`pre_process` and :func:`filter_map_to_get_cored_or_caa` (its
  ``:228``, ``:272``), the weak-label maps of ``core.py:25-78, 223-246``;
  weak labels come from :meth:`CAAFilter.predict_crops` on its device;
* :func:`draw_bboxes` and :func:`draw_detections` (its ``:297``, ``:330``),
  PIL rendering pixel-equal to the reference package's;
* :func:`seed_folder_from_list` and :func:`compare_premerge_with_postmerge`
  (its ``:349``, ``:364``);
* :func:`wsis_with_most_caas` (its ``:396``), :func:`device_memory_stats`
  (its ``:411``, the original's ``nvidia-smi`` call, from torch's per-card
  statistics here) and :func:`clear_output_dir` (its ``:429``, the original
  ``clear.py``).
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .io.datasets import load_image_rgb
from .io.native import decode_one
from .models import classifier
from .ops.preprocess import crop256_window, normalize_crops
from .utils.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# Study metrics (core.py:497-571)
# ---------------------------------------------------------------------------

def iou_xyxy(boxA: Sequence[float], boxB: Sequence[float]) -> float:
    """Scalar IoU with the +1-pixel convention (``core.py:497-518``)."""
    xA = max(boxA[0], boxB[0])
    yA = max(boxA[1], boxB[1])
    xB = min(boxA[2], boxB[2])
    yB = min(boxA[3], boxB[3])
    inter = max(0, xB - xA + 1) * max(0, yB - yA + 1)
    areaA = (boxA[2] - boxA[0] + 1) * (boxA[3] - boxA[1] + 1)
    areaB = (boxB[2] - boxB[0] + 1) * (boxB[3] - boxB[1] + 1)
    return inter / float(areaA + areaB - inter)


# the original's spelling
IOU = iou_xyxy


def get_accuracy(l1: Sequence, l2: Sequence) -> float:
    """Elementwise match rate of two equal-length lists (``core.py:520-525``)."""
    assert len(l1) == len(l2)
    return sum(1 for a, b in zip(l1, l2) if a == b) / float(len(l1))


def get_tps(predictions: Sequence[Sequence[float]], labels: Sequence[Sequence[float]],
            iou_threshold: float, pascal_voc_scheme: bool = True) -> List[int]:
    """TP flags per prediction (``getTPs``, ``core.py:527-571``).

    Predictions ``[x1, y1, x2, y2, conf, cls_conf, cls_pred]``, labels
    ``[x1, y1, x2, y2, class]``; the class is the last entry of each.
    Predictions are visited by confidence, highest first; under the
    Pascal-VOC-2012 scheme each label justifies at most one TP.

    The original sorts ascending, then reverses (``core.py:543-546``), so
    predictions of equal confidence are visited in *reversed* order: the
    later row claims a label first.  Labels equal by value count as one.
    """
    order = sorted(range(len(predictions)), key=lambda k: predictions[k][4])
    order.reverse()
    tp_labels: List = []
    flag_by_index: Dict[int, int] = {}
    for oi in order:
        prediction = predictions[oi]
        is_tp = False
        for label in labels:
            if label[-1] != prediction[-1]:
                continue
            if pascal_voc_scheme and _in(label, tp_labels):
                continue
            if iou_xyxy(prediction[0:4], label[0:4]) >= iou_threshold:
                is_tp = True
                tp_labels.append(label)
                break
        flag_by_index[oi] = 1 if is_tp else 0
    return [flag_by_index[i] for i in range(len(predictions))]


def _in(item, seq) -> bool:
    """``item in seq`` of the original: identity, then equality."""
    return any(item is x or item == x for x in seq)


class CAAFilter:
    """Consensus-of-2 model filter for CAA detections.

    Cored detections are never touched; a CAA detection survives iff the
    classifier's CAA probability exceeds 0.5 (the original's
    ``unit_test.py:243-288``).  The classifier lives on the filter's device
    (``cuda`` unless ``device="cpu"`` is passed) and all crops of a tile run
    as one batch.

    Args:
      params: a :class:`~.models.classifier.Net` state dict; else the
        pickled module at ``model_pickle`` when it exists, else random
        weights from ``seed``.
      mean, std: per-channel normalization; else ``normalization``'s file,
        else the identity.
      classes: class names by ``cls_pred``; index 0 is CAA, 1 Cored.
    """

    #: crop batches are padded up to these sizes (the reference compiles one
    #: program per size; here they keep the classifier's shapes few)
    CROP_BUCKETS = (8, 32, 128)

    def __init__(self, params: Optional[Mapping[str, torch.Tensor]] = None,
                 mean=None, std=None, classes: Sequence[str] = ("CAA", "Cored"),
                 model_pickle: Optional[str] = None,
                 normalization: Optional[str] = None, device: DeviceLike = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        if params is None:
            if model_pickle is not None and os.path.exists(model_pickle):
                params = classifier.from_torch_pickle(model_pickle)
            else:
                params = classifier.init_params(torch.Generator().manual_seed(seed))
        self.net = classifier.Net()
        self.net.load_state_dict(params)
        self.net.to(self.device).eval()
        if mean is None or std is None:
            mean, std = classifier.load_normalization(normalization)
        self.mean = torch.as_tensor(mean, dtype=torch.float32).to(self.device)
        self.std = torch.as_tensor(std, dtype=torch.float32).to(self.device)
        self.classes = list(classes)

    def predict_crops(self, crops_u8: np.ndarray) -> np.ndarray:
        """(K, 256, 256, 3) uint8 RGB → (K, 3) sigmoid probabilities."""
        k = crops_u8.shape[0]
        bucket = next((b for b in self.CROP_BUCKETS if b >= k), None)
        if bucket is not None and bucket != k:
            pad = np.zeros((bucket - k,) + crops_u8.shape[1:], crops_u8.dtype)
            crops_u8 = np.concatenate([crops_u8, pad], axis=0)
        x = normalize_crops(torch.from_numpy(crops_u8).to(self.device), self.mean, self.std)
        return classifier.predict_probs(self.net, x).cpu().numpy()[:k]

    def __call__(self, img: np.ndarray, detections: np.ndarray) -> np.ndarray:
        """Filter (N, 7) detections against the tile's HWC uint8 ``img``."""
        dets = np.asarray(detections)
        if dets.shape[0] == 0:
            return dets
        probs = self.predict_crops(np.stack([_crop(img, row) for row in dets]))
        keep = [row for row, p in zip(dets, probs)
                if not (self.classes[int(row[6])] == "CAA" and p[2] <= 0.5)]
        return np.asarray(keep, dets.dtype) if keep else np.zeros((0, 7), dets.dtype)

    def filter_path(self, img_path: str, detections: np.ndarray) -> np.ndarray:
        """:meth:`__call__` on the image at ``img_path``: a JPEG through the
        native reader into a 1536² frame when it is built, else PIL."""
        if len(np.asarray(detections)) == 0:
            return np.asarray(detections)
        img = None
        if img_path.lower().endswith((".jpg", ".jpeg")):
            img = decode_one(img_path, 1536, 1536)
        if img is None:
            img = load_image_rgb(img_path)
        return self(img, detections)


def _crop(img: np.ndarray, row: np.ndarray) -> np.ndarray:
    """The 256² crop around a detection row; zero-filled where the image is
    smaller than the window (WSI border tiles)."""
    x1, y1, x2, y2 = row[:4]
    x0, y0 = crop256_window((int(x1), int(y1), int(x2 - x1), int(y2 - y1)))
    crop = img[y0:y0 + 256, x0:x0 + 256]
    if crop.shape[:2] != (256, 256):
        out = np.zeros((256, 256, 3), img.dtype)
        out[:crop.shape[0], :crop.shape[1]] = crop
        crop = out
    return crop


def write_caa_detections(pickle_path: str, img_name: str, detections: np.ndarray,
                         classes: Sequence[str] = ("CAA", "Cored")) -> None:
    """Append an image's CAA detections to a pickle ``{image name: [(0,
    x_centre, y_centre, width, height), ...]}``, with the original's quirks:
    the centre is computed from the box size alone, (x2-x1)/2, and width
    and height are in pixels of the int-truncated corners."""
    store: Dict[str, list] = {}
    if os.path.exists(pickle_path):
        with open(pickle_path, "rb") as fh:
            store = pickle.load(fh)
    img_name = img_name[img_name.rfind("/") + 1:]
    new_rows = []
    for x1, y1, x2, y2, conf, cls_conf, cls_pred in np.asarray(detections):
        if classes[int(cls_pred)] != "CAA":
            continue
        x_center = (int(x2) - int(x1)) / 2.0
        y_center = (int(y2) - int(y1)) / 2.0
        new_rows.append((0, x_center, y_center, int(x2) - int(x1), int(y2) - int(y1)))
    store[img_name] = store.get(img_name, []) + new_rows
    with open(pickle_path, "wb") as fh:
        pickle.dump(store, fh)


# ---------------------------------------------------------------------------
# Weak-label maps (core.py:25-78, 223-246)
# ---------------------------------------------------------------------------

def pre_process(image_details_csv: str, consensus_csv: str,
                images_dir: str = "data/custom/images/",
                weak_label: bool = False,
                caa_filter: Optional[CAAFilter] = None) -> Dict[str, list]:
    """``{1536² image path: [(bbox_xywh, (cored, diffuse, CAA)), ...]}``.

    The human labels of the consensus-of-2 CSV take precedence; with
    ``weak_label=True`` and a ``caa_filter``, the other boxes get the
    classifier's probabilities, one crop a box through
    :meth:`CAAFilter.predict_crops` on the filter's device
    (``core.py:25-78``).  pandas is imported here, not with the module.
    """
    import pandas as pd

    consensus = pd.read_csv(consensus_csv)
    mapp: Dict[str, tuple] = {}
    for _, row in consensus.iterrows():
        full = row["imagename"]
        img_name = full[full.find("/") + 1:]
        mapp[img_name] = (int(row["cored"]), int(row["diffuse"]), int(row["CAA"]))

    df = pd.read_csv(image_details_csv)
    final_mapp: Dict[str, list] = {}
    for _, row in df.iterrows():
        img_path_1536 = (images_dir + row["source"] + "_0_" + str(row["tile_row"])
                         + "_" + str(row["tile_column"]) + ".jpg")
        bbox_coord = row["blob coordinates (xywh)"]
        bbox_coord = bbox_coord.replace("[", "").replace("]", "").split(" ")
        bbox_coord = [int(x) for x in bbox_coord if x != ""]
        if row["imagename"] in mapp:
            label = mapp[row["imagename"]]
        elif weak_label and caa_filter is not None:
            img = load_image_rgb(img_path_1536)
            crop = _crop(img, np.array(bbox_coord[:2] + [
                bbox_coord[0] + bbox_coord[2], bbox_coord[1] + bbox_coord[3],
            ], float))
            probs = caa_filter.predict_crops(crop[None])[0]
            label = tuple(float(p) for p in probs)
        else:
            continue
        final_mapp.setdefault(img_path_1536, []).append((bbox_coord, label))
    return final_mapp


def filter_map_to_get_cored_or_caa(mapp: Dict[str, list], just_CAA: bool = False,
                                   just_Cored: bool = False) -> Dict[str, list]:
    """The images of a weak-label map with a cored or CAA label (>= 0.5),
    or with just one of them (``core.py:223-246``)."""
    new_mapp = {}
    for img, pairs in mapp.items():
        for _, preds in pairs:
            has_cored = preds[0] >= 0.5
            has_caa = preds[2] >= 0.5
            if just_CAA == just_Cored:
                if has_cored or has_caa:
                    new_mapp[img] = pairs
                    break
            elif just_CAA and has_caa:
                new_mapp[img] = pairs
                break
            elif just_Cored and has_cored:
                new_mapp[img] = pairs
                break
    return new_mapp


def draw_bboxes(img: np.ndarray, bbox_class_preds, color_by_class: bool = False) -> np.ndarray:
    """Draw ``(bbox_xywh, (cored, diffuse, CAA))`` entries on an RGB array
    (the original ``drawBBox``, ``core.py:602-633``, in PIL): entries with
    neither cored nor CAA >= 0.5 are skipped; by class, CAA is blue and
    Cored red."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(img))
    d = ImageDraw.Draw(im)
    for bbox, preds in bbox_class_preds:
        if preds[2] < 0.5 and preds[0] < 0.5:
            continue
        color = (0, 0, 0)
        if color_by_class:
            if preds[2] >= 0.5:
                color = (0, 0, 255)
            if preds[0] >= 0.5:
                color = (255, 0, 0)
        x1, y1 = bbox[0], bbox[1]
        x2, y2 = bbox[0] + bbox[2], bbox[1] + bbox[3]
        d.rectangle([x1, y1, x2, y2], outline=color, width=2)
        if preds[2] >= 0.5 and preds[0] >= 0.5:
            text = "Cored and CAA"
        elif preds[2] >= 0.5:
            text = "CAA"
        else:
            text = "Cored"
        d.text((x1, max(0, y1 - 12)), text, fill=(0, 0, 0))
    return np.asarray(im)


def draw_detections(img: np.ndarray, detections: np.ndarray,
                    classes: Sequence[str] = ("CAA", "Cored")) -> np.ndarray:
    """Render (N, 7) detection rows with class-coloured boxes and labels."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(img))
    d = ImageDraw.Draw(im)
    palette = {"CAA": (0, 0, 255), "Cored": (255, 0, 0)}
    for x1, y1, x2, y2, conf, cls_conf, cls_pred in np.asarray(detections):
        name = classes[int(cls_pred)]
        d.rectangle([x1, y1, x2, y2], outline=palette.get(name, (0, 0, 0)), width=2)
        d.text((x1, max(0, y1 - 12)), f"{name} {conf:.2f}", fill=palette.get(name))
    return np.asarray(im)


def seed_folder_from_list(list_path: str, dest_dir: str) -> None:
    """Copy the images a train or valid list names into a fresh flat folder
    (the original's ``seedTestFolder``/``seedTrainFolder``,
    ``core.py:80-106``, as one function)."""
    if os.path.isdir(dest_dir):
        shutil.rmtree(dest_dir)
    os.makedirs(dest_dir)
    with open(list_path) as fh:
        for line in fh.read().splitlines():
            line = line.strip()
            if not line:
                continue
            shutil.copy(line, os.path.join(dest_dir, os.path.basename(line)))


def compare_premerge_with_postmerge(premerge: Dict[str, list],
                                    postmerge: Dict[str, list],
                                    output_dir: str = "output",
                                    sample_size: int = 100,
                                    seed: int = 0) -> None:
    """Render pre- and post-merge label maps of the same images into
    ``<output_dir>/premerge`` and ``/postmerge``
    (``comparePreMergeLabelsWithPostMerge``, ``core.py:573-600``): images
    with a CAA label only, ``sample_size`` of them in an order shuffled by
    ``seed``, boxes drawn uncoloured."""
    import random as _random

    from PIL import Image

    assert set(premerge.keys()) == set(postmerge.keys())
    pre = filter_map_to_get_cored_or_caa(premerge, just_CAA=True)
    post = filter_map_to_get_cored_or_caa(postmerge, just_CAA=True)
    images = list(pre.keys())
    _random.Random(seed).shuffle(images)
    images = images[:sample_size]
    for mapp, l_type in [(pre, "premerge"), (post, "postmerge")]:
        save_dir = os.path.join(output_dir, l_type)
        os.makedirs(save_dir, exist_ok=True)
        for img_name in images:
            if img_name not in mapp:
                continue
            img = load_image_rgb(img_name)
            annotated = draw_bboxes(img, mapp[img_name], color_by_class=False)
            save_name = l_type + "_" + img_name.replace("/", "_")
            Image.fromarray(annotated).save(os.path.join(save_dir, save_name))


def wsis_with_most_caas(counts_pickle: str, n: int = 12) -> List[str]:
    """The ``n`` WSIs with the most CAA of a plaque-counts pickle.  The
    original calls ``getWSIsWithMostCAAs(n=12)`` (``validation.py:79``)
    without defining it; this is its evident intent, as in the reference
    package."""
    with open(counts_pickle, "rb") as fh:
        counts = pickle.load(fh)
    ranked = sorted(counts.items(), key=lambda kv: kv[1].get("CAA", 0), reverse=True)
    return [wsi for wsi, _ in ranked[:n]]


def device_memory_stats(devices: Optional[Sequence[DeviceLike]] = None
                        ) -> Dict[int, Dict[str, int]]:
    """``{i: {"bytes_in_use", "bytes_limit"}}`` for each device, in place of
    the original's ``nvidia-smi`` call (``core.py:482-495``).

    A card reports ``torch.cuda.memory_allocated`` and the card's total
    memory (``torch.cuda.mem_get_info``); a CPU device reports zeros, as the
    reference package's CPU devices do.  ``devices`` defaults to every card,
    and then raises without one, as :func:`~.utils.device.resolve_device`
    does."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = {}
    for i, d in enumerate(devices):
        dev = resolve_device(d)
        if dev.type == "cuda":
            out[i] = {"bytes_in_use": int(torch.cuda.memory_allocated(dev)),
                      "bytes_limit": int(torch.cuda.mem_get_info(dev)[1])}
        else:
            out[i] = {"bytes_in_use": 0, "bytes_limit": 0}
    return out


def clear_output_dir(path: str = "output/") -> None:
    """Reset an output directory (the original ``clear.py``)."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


__all__ = [
    "iou_xyxy", "IOU", "get_accuracy", "get_tps", "CAAFilter",
    "write_caa_detections", "pre_process", "filter_map_to_get_cored_or_caa",
    "draw_bboxes", "draw_detections", "device_memory_stats", "clear_output_dir",
    "seed_folder_from_list", "compare_premerge_with_postmerge",
    "wsis_with_most_caas",
]
