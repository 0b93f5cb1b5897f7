"""Validation-set mAP (reference package ``evaluate.py:38-121``, after the
reference's ``test.py evaluate``).

Parity with ``test.py:24-66``: a :class:`ListDataset` without augmentation
or multiscale; the eval-mode forward over unfolded parameters, the dense
decode and the merging NMS at the given thresholds on the device; greedy
TP matching per batch, then per-class P/R/AP/F1 with ``ap_per_class`` on
the host.  In float32 on the card the convolutions run in full float32
(TF32 off).  A short last batch is padded to the batch size by repeating
its last image, so every call has one shape.

The reference package memoises its compiled eval program
(``utils/memo.py``); PyTorch runs eagerly and has nothing to memoise.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from .graphspec import GraphSpec
from .io.datasets import ListDataset
from .models import darknet, heads
from .ops import nms as nms_ops
from .ops.boxes import xywh2xyxy_np
from .ops.metrics import ap_per_class, get_batch_statistics
from .ops.preprocess import preprocess_tiles
from .utils.device import DeviceLike, no_tf32, resolve_device


def make_eval_fn(spec: GraphSpec, conf_thres: float, nms_thres: float, capacity: int = 128,
                 compute_dtype: torch.dtype = torch.float32) -> Callable:
    """``fwd(params, images_u8, img_size) -> (dets, valid, n_candidates)``:
    resize to float32 /255, unfolded eval-mode forward, dense decode and
    NMS with a pool of ``capacity`` (reference ``make_eval_fn``)."""

    @torch.no_grad()
    def fwd(params: Mapping[str, torch.Tensor], images_u8: torch.Tensor, img_size: int):
        x = preprocess_tiles(images_u8, img_size)
        f32_card = compute_dtype == torch.float32 and x.device.type == "cuda"
        with no_tf32() if f32_card else contextlib.nullcontext():
            maps = darknet.apply(params, spec, x, compute_dtype=compute_dtype)
        pred = heads.decode_all(maps, spec, img_size)
        return nms_ops.non_max_suppression(pred, conf_thres, nms_thres, capacity,
                                           return_count=True)

    return fwd


def evaluate(spec: GraphSpec, params: Mapping[str, torch.Tensor], path: str,
             iou_thres: float = 0.5, conf_thres: float = 0.5, nms_thres: float = 0.5,
             img_size: int = 416, batch_size: int = 8,
             compute_dtype: torch.dtype = torch.float32, nms_capacity: int = 128,
             dataset: Optional[ListDataset] = None, device: DeviceLike = None
             ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """``(precision, recall, AP, f1, ap_class)`` over the list at ``path``,
    or ``None`` when the model detects nothing.  ``params`` is a reference-
    layout state dict, copied to ``device`` (default ``cuda``) where it is
    not there already.

    When an image has more conf-passing candidates than ``nms_capacity``
    (the fixed NMS pool; the reference's host loop is uncapped) a
    ``UserWarning`` gives the image count, since the truncation lowers mAP.
    ``dataset`` lets a repeated caller (the Trainer, every epoch) reuse one
    ``ListDataset`` and its decode cache.
    """
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    if dataset is None:
        dataset = ListDataset(path, img_size=img_size, multiscale=False, augment=False)
    fwd = make_eval_fn(spec, conf_thres, nms_thres, capacity=nms_capacity,
                       compute_dtype=compute_dtype)

    labels: list = []
    sample_metrics: list = []
    overflow_images = 0
    n_images = 0
    for batch in dataset.iter_epoch(batch_size, shuffle=False):
        imgs = batch["images"]
        targets = batch["targets"][batch["target_mask"]]
        labels += targets[:, 1].tolist()
        # normalized xywh -> model-input-pixel xyxy (test.py:50-51)
        t = targets.copy()
        t[:, 2:] = xywh2xyxy_np(t[:, 2:]) * img_size
        n_real = len(batch["paths"])
        if imgs.shape[0] < batch_size:
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], batch_size - imgs.shape[0], 0)])
        dets, valid, n_cand = fwd(params, torch.from_numpy(imgs).to(dev), img_size)
        ragged = nms_ops.dense_to_ragged(dets, valid)[:n_real]
        overflow_images += int((n_cand[:n_real] > nms_capacity).sum())
        n_images += n_real
        sample_metrics += get_batch_statistics(ragged, t, iou_thres)
    if overflow_images:
        warnings.warn(
            f"evaluate: {overflow_images}/{n_images} images had more than "
            f"nms_capacity={nms_capacity} conf-passing candidates — the NMS pool "
            f"truncated them and mAP is depressed vs the reference's uncapped NMS.  "
            f"Re-run with a larger nms_capacity.", UserWarning, stacklevel=2)
    if not sample_metrics:
        return None
    tp, scores, pred_labels = [np.concatenate(x, 0) for x in zip(*sample_metrics)]
    return ap_per_class(tp, scores, pred_labels, labels)


__all__ = ["evaluate", "make_eval_fn"]
