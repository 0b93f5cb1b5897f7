"""End-to-end tile inference: the port's main path.

    uint8 (B, 1536, 1536, 3)
      → nearest resize to 416² + scale, bf16 NHWC       (K1, kernels.preprocess_kernel)
      → BN-folded Darknet-53 + heads, residual units in K2  (models.darknet)
      → score → top-k → sparse decode                   (models.heads.decode_topk)
      → class-aware merging NMS over the pool           (ops.nms)
      → rescale to tile pixels                          (ops.boxes)
    → (B, capacity, 7) boxes + (B, capacity) validity

Counterpart of the reference package's ``detectors.py:Detector``
(``:86-303``, ``:507-561``) at its default ``precision="bf16"``, with BN
folded.  The int8 precisions, ``detect_folder``, the merge/CAA post-passes,
meshes and the TPU-only options are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from .graphspec import GraphSpec, yolov3_spec
from .kernels.preprocess_kernel import resize_normalize
from .models import darknet, heads
from .ops import nms as nms_ops
from .ops.boxes import rescale_boxes
from .ops.preprocess import preprocess_tiles
from .utils.device import DeviceLike, resolve_device


class Detector:
    """Batched tile detector.

    Args:
      spec: model graph (defaults to the 2-class YOLOv3 at 416).
      params: *unfolded* parameters as a state dict in the reference
        ``.pth`` layout (:mod:`amyloid_yolo_tpu_torch.io.weights`); random
        reference-scheme weights from ``seed`` when ``None``.
      conf_thres / nms_thres: reference operating point is 0.8 / 0.4.
      capacity: detections returned per tile; ``nms_pool`` (default
        ``capacity``) conf-passing candidates take part in suppression and
        merging.  :meth:`account_overflow` counts images that had more.
      compute_dtype: ``torch.bfloat16`` (the main path, kernels K1 and K2)
        or ``torch.float32`` (CPU only: K2 takes bf16 on the card).
      host_resize: the caller already resized tiles to ``model_size`` on the
        host (checked); the preprocess then only scales, its index tables
        being the identity.
      lazy_decode: score → top-k → sparse decode (default) instead of the
        dense decode of every anchor row; same outputs.
      device: ``"cuda"`` when ``None``; raises when CUDA is absent unless
        ``device="cpu"`` is passed.
    """

    def __init__(
        self,
        spec: Optional[GraphSpec] = None,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        *,
        conf_thres: float = 0.8,
        nms_thres: float = 0.4,
        model_size: int = 416,
        tile_size: int = 1536,
        capacity: int = 64,
        nms_pool: Optional[int] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        fold_bn: bool = True,
        host_resize: bool = False,
        precision: str = "bf16",
        lazy_decode: bool = True,
        device: DeviceLike = None,
        seed: int = 0,
    ):
        if precision != "bf16":
            raise ValueError(f"precision {precision!r} is not ported yet: the int8 "
                             "precisions wait for ROADMAP.md Queue 1 item 8")
        if not fold_bn:
            raise ValueError("fold_bn=False is not ported yet (the unfolded "
                             "executor, ROADMAP.md Queue 1 item 3)")
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"unsupported compute_dtype {compute_dtype}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and compute_dtype != torch.bfloat16:
            raise ValueError("on CUDA the Detector computes in bf16 (K2 takes bf16 "
                             "only); float32 runs on the CPU (ROADMAP.md Queue 2, K2)")
        self.spec = spec or yolov3_spec(num_classes=2)
        if params is None:
            params = darknet.init_params(torch.Generator().manual_seed(seed), self.spec)
        folded = darknet.fold_batchnorm(params, self.spec)
        self.params = {
            k: {"w": v["w"].to(self.device, compute_dtype).contiguous(
                    memory_format=torch.channels_last),
                "b": v["b"].to(self.device, compute_dtype)}
            for k, v in folded.items()}
        self.packs = {i: tuple(t.to(self.device) for t in p) for i, p in
                      darknet.pack_residual_blocks(folded, self.spec, compute_dtype).items()}
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres
        self.model_size = model_size
        self.tile_size = tile_size
        self.capacity = capacity
        self.nms_pool = nms_pool or capacity
        self.compute_dtype = compute_dtype
        self.host_resize = host_resize
        self.lazy_decode = lazy_decode
        self.fold_bn = fold_bn
        self.precision = precision
        self._last_ncand: Optional[torch.Tensor] = None
        self.overflow_images = 0
        self.images_seen = 0
        self.max_candidates_seen = 0

    def preprocess(self, tiles_u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC tiles on the device → NHWC model input."""
        if self.host_resize and tuple(tiles_u8.shape[1:3]) != (self.model_size,) * 2:
            raise ValueError(f"host_resize=True expects {self.model_size}² tiles, "
                             f"got {tuple(tiles_u8.shape[1:3])}")
        if self.compute_dtype == torch.bfloat16:
            return resize_normalize(tiles_u8, self.model_size)  # K1
        return preprocess_tiles(tiles_u8, self.model_size)

    def head_maps(self, tiles_u8: torch.Tensor) -> List[torch.Tensor]:
        """The f32 NHWC head maps for a batch of uint8 tiles on the device."""
        x = self.preprocess(tiles_u8)
        return darknet.apply_folded(self.params, self.spec, x,
                                    compute_dtype=self.compute_dtype, packs=self.packs)

    @torch.inference_mode()
    def __call__(self, tiles_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """tiles (B, tile, tile, 3) uint8 (numpy or tensor) → ``(dets
        (B, capacity, 7), valid (B, capacity))`` on the device.

        The per-image conf-passing candidate count stays on the device as
        ``self._last_ncand`` until :meth:`account_overflow` reads it.
        """
        tiles = torch.as_tensor(tiles_u8).to(self.device)
        maps = self.head_maps(tiles)
        pool = self.nms_pool
        if self.lazy_decode:
            det, scores, n_cand = heads.decode_topk(
                maps, self.spec, self.model_size, self.conf_thres, pool)
            dets, valid = nms_ops.non_max_suppression_pooled(
                det, scores, self.nms_thres, self.capacity)
        else:
            pred = heads.decode_all(maps, self.spec, self.model_size)
            dets, valid, n_cand = nms_ops.non_max_suppression(
                pred, self.conf_thres, self.nms_thres, self.capacity, pool=pool,
                return_count=True)
        dets = rescale_boxes(dets, self.model_size, self.tile_size, self.tile_size)
        self._last_ncand = n_cand
        return dets, valid

    def account_overflow(self, n_valid: Optional[int] = None, n_cand=None) -> int:
        """Fold the latest batch's candidate counts into the counters; return
        how many of its first ``n_valid`` images had more conf-passing
        candidates than ``nms_pool`` (candidates the reference's uncapped
        loop would have kept)."""
        nc = torch.as_tensor(self._last_ncand if n_cand is None else n_cand)
        nc = nc.cpu().numpy()
        if n_valid is not None:
            nc = nc[:n_valid]
        over = int((nc > self.nms_pool).sum())
        self.overflow_images += over
        self.images_seen += int(nc.size)
        self.max_candidates_seen = max(self.max_candidates_seen,
                                       int(nc.max()) if nc.size else 0)
        return over

    def detect_batch_ragged(self, tiles_u8, n_valid: Optional[int] = None
                            ) -> List[Optional[np.ndarray]]:
        """Ragged per-image detections; ``n_valid`` leading rows are real
        images (padding rows do not count in the overflow counters)."""
        dets, valid = self(tiles_u8)
        out = nms_ops.dense_to_ragged(dets, valid)
        self.account_overflow(n_valid)
        return out


__all__ = ["Detector"]
