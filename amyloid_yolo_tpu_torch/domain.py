"""Domain layer: the consensus-model CAA filter of ``detect``.

Counterpart of the reference package's ``domain.py:102-197``
(:class:`CAAFilter`, :func:`_crop`), which reproduces the original
``filterDetectionsByCAAModel`` (``core.py:425-452``) with one resident
classifier and one batched call per tile.  The study metrics, the weak-label
maps, ``write_caa_detections`` and the drawing helpers are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .io.datasets import load_image_rgb
from .io.native import decode_one
from .models import classifier
from .ops.preprocess import crop256_window, normalize_crops
from .utils.device import DeviceLike, resolve_device


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


__all__ = ["CAAFilter"]
