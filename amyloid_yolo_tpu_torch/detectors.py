"""End-to-end tile inference: the port's main path.

    uint8 (B, 1536, 1536, 3)
      → nearest resize to 416² + scale, bf16 NHWC       (K1, kernels.preprocess_kernel)
      → BN-folded Darknet-53 + heads, residual units in K2  (models.darknet)
      → score → top-k → sparse decode                   (models.heads.decode_topk)
      → class-aware merging NMS over the pool           (ops.nms)
      → rescale to tile pixels                          (ops.boxes)
    → (B, capacity, 7) boxes + (B, capacity) validity

Counterpart of the reference package's ``detectors.py``: the precisions
``bf16`` (BN folded or not), ``int8_early`` and ``int8_full`` (int8
executors in ``models.darknet``, no K2), calibration and its sidecars, and
:meth:`Detector.detect_folder`, the path of ``detect``: a folder of tiles
through the reader (:mod:`.io.datasets`, :mod:`.io.native`), the call
above, the border rescale, the union merge (:mod:`.ops.merge`) and the CAA
filter (:mod:`.domain`).  With ``mesh=`` (:mod:`.parallel.mesh`) a call
splits its batch over several devices.  The reference's layout options
``s2d_stem``, ``s2d_downsample`` and ``pallas_blocks`` are accepted where
it accepts them.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import warnings
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .graphspec import GraphSpec, yolov3_spec
from .io.datasets import ImageFolder
from .io.tissue import prefilter_tile_paths
from .kernels.preprocess_kernel import resize_normalize
from .models import darknet, heads
from .ops import nms as nms_ops
from .ops.boxes import rescale_boxes_batched, rescale_from_tile_frame
from .ops.merge import merge_detections
from .ops.preprocess import f32_from_bf16_input, preprocess_tiles
from .parallel.mesh import Mesh, normalize_device, replicate, split_batch, to_device
from .utils import spans
from .utils.device import DeviceLike, no_tf32, resolve_device


def resolve_batch_size(batch_size, n_images: int) -> int:
    """A ``batch_size`` that may be ``"auto"``: batch 32 when the queue
    fills at least two of them (``n_images >= 64``), else 16, as the
    reference chooses.  Integers and numeric strings pass through."""
    if isinstance(batch_size, str) and batch_size.strip().lower() == "auto":
        return 32 if n_images >= 64 else 16
    return int(batch_size)


class Route(NamedTuple):
    """What a call runs: K1 for the preprocess (else the plain
    ``preprocess_tiles``), K2 for the residual units (else each unit's two
    convolutions), and TF32 off around the call."""
    k1: bool
    k2: bool
    tf32_off: bool


def route(device_type: str, compute_dtype: torch.dtype, precision: str = "bf16",
          fold_bn: bool = True) -> Route:
    """The :class:`Route` of a ``Detector``.  bfloat16 runs K1 and, for the
    folded bf16 precision, K2 on every residual unit.  float32 runs neither
    (K1 writes bf16 and K2 takes bf16), as the reference ``Detector``'s
    default path runs its units through XLA and never its preprocess
    kernel; on the card its convolutions run in full float32, TF32 off."""
    bf16 = compute_dtype == torch.bfloat16
    return Route(k1=bf16, k2=bf16 and precision == "bf16" and fold_bn,
                 tf32_off=device_type == "cuda" and not bf16)


class _Replica(NamedTuple):
    """The weights one device runs with."""
    params: Dict
    packs: Optional[darknet.Packs]
    qparams: Optional[darknet.QParams]
    s2d: Optional[Dict] = None                       # the s2d stem
    s2d_downs: Optional[Dict[int, torch.Tensor]] = None


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
        or ``torch.float32`` (the plain preprocess and every convolution
        unfused, in full float32: TF32 is off for the duration of a call on
        the card; see :func:`route`).
      fold_bn: fold BN into the convs (default); ``False`` runs the
        unfolded executor :func:`~.models.darknet.apply` (bf16 precision
        only, no K2).
      host_resize: the caller already resized tiles to ``model_size`` on the
        host (checked); the preprocess then only scales, its index tables
        being the identity.
      precision: ``"bf16"``; ``"int8_early"`` — the high-resolution backbone
        prefix (input maps at downsample <= ``int8_downsample``) runs on int8
        activations, with int8 convs unless ``int8_compute=False``; or
        ``"int8_full"`` — int8 through the whole graph, the RGB stem and the
        three head convs in ``compute_dtype``.  The int8 precisions use
        static activation scales from :meth:`calibrate` (lazily on the first
        batch) or :meth:`load_calibration`; ``int32_accum_max_hw`` and
        ``calib_percentile`` as in the reference.
      lazy_decode: score → top-k → sparse decode (default) instead of the
        dense decode of every anchor row; same outputs.
      device: ``"cuda"`` when ``None``; raises when CUDA is absent unless
        ``device="cpu"`` is passed.
      mesh: a :class:`~.parallel.mesh.Mesh`: the weights are copied onto
        each of its devices, and a call splits its batch evenly over them
        (one shard a device, all issued from the calling thread without a
        sync between them) and gathers the outputs on the mesh's first
        device, which is the Detector's ``device``.  The int8 precisions
        calibrate once, on the first device, and every shard uses those
        scales.

      s2d_stem: layers 0-1 on the space-to-depth grid
        (:func:`~.models.darknet.s2d_stem_forward`; for ``int8_full``
        :func:`~.models.darknet.make_s2d_stem_int8`): the same function up
        to summation order.  bf16 (BN folded) and ``int8_full`` only.
      s2d_downsample: ``int8_full`` with ``s2d_stem`` only: the narrow
        3x3/s2 convs after the stem on the s2d grid too
        (:func:`~.models.darknet.make_s2d_down_int8`; the same integer
        sums).
      pallas_blocks: accepted for the folded bf16 precision, where the
        reference takes it, and raises elsewhere as it does.  It changes
        nothing here: the folded bf16 path always runs every residual unit
        in K2 (all 23 of YOLOv3, the 208² one included, where the
        reference's Pallas blocks leave that unit to XLA), and float32 runs
        none (:func:`route`).

    It raises ``ValueError`` where the reference ``Detector`` raises
    (``detectors.py:141-196``).
    """

    #: at or below this an activation scale came from an all-zero layer
    #: (the calibrators floor every scale at stat/127 + 1e-12)
    DEGENERATE_SCALE = 2e-12
    #: calibration sidecar format tag (:meth:`save_calibration`)
    CALIBRATION_FORMAT = "amyolo-int8-calibration-v1"

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
        int8_compute: bool = True,
        int8_downsample: int = 4,
        pallas_blocks: bool = False,
        lazy_decode: bool = True,
        s2d_stem: bool = False,
        s2d_downsample: bool = False,
        int32_accum_max_hw: int = 0,
        calib_percentile: float = 100.0,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
        seed: int = 0,
    ):
        if precision not in ("bf16", "int8_early", "int8_full"):
            raise ValueError(f"unknown precision {precision!r}")
        if precision.startswith("int8") and not fold_bn:
            raise ValueError(f"{precision} requires fold_bn=True")
        if pallas_blocks and precision != "bf16":
            raise ValueError("pallas_blocks currently supports precision='bf16'")
        if pallas_blocks and not fold_bn:
            raise ValueError("pallas_blocks requires fold_bn=True")
        if s2d_stem and precision == "int8_early":
            raise ValueError("s2d_stem supports precision 'bf16' (fold_bn) and 'int8_full'")
        if s2d_stem and not fold_bn:
            raise ValueError("s2d_stem requires fold_bn=True")
        if s2d_downsample and not (s2d_stem and precision == "int8_full"):
            raise ValueError("s2d_downsample requires s2d_stem=True and "
                             "precision='int8_full'")
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"unsupported compute_dtype {compute_dtype}")
        if mesh is not None:
            if device is not None and normalize_device(resolve_device(device)) \
                    != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        self.route = route(self.device.type, compute_dtype, precision, fold_bn)
        self.spec = spec or yolov3_spec(num_classes=2)
        if precision != "bf16":
            darknet.refuse_grid_sensitive(self.spec, precision)
        if params is None:
            params = darknet.init_params(torch.Generator().manual_seed(seed), self.spec)
        dev, cd = self.device, compute_dtype
        self._int8_upto = (darknet.int8_region(self.spec, int8_downsample)
                           if precision == "int8_early" else 0)
        self.packs: Optional[darknet.Packs] = None
        self.spp = darknet.spp_blocks(self.spec)   # the folded forward's SPP blocks
        self.routes = darknet.route_slices(self.spec)  # and its routes joined in place
        self._qparams: Optional[darknet.QParams] = None
        self._folded_cpu: Optional[darknet.Folded] = None
        s2d = s2d_downs = None
        if not fold_bn:
            # conv weights in compute_dtype, BN statistics and biases in f32
            self.params = {k: (v.to(dev, cd).contiguous(memory_format=torch.channels_last)
                               if k.endswith(".weight") and v.dim() == 4 else v.to(dev))
                           for k, v in params.items()}
        else:
            folded = darknet.fold_batchnorm(params, self.spec)
            # the int8 executors add the f32 biases, the bf16 path its own dtype's
            bias_dtype = cd if precision == "bf16" else torch.float32
            self.params = {
                k: {"w": v["w"].to(dev, cd).contiguous(memory_format=torch.channels_last),
                    "b": v["b"].to(dev, bias_dtype)}
                for k, v in folded.items()}
            if self.route.k2:
                self.packs = {i: tuple(t.to(dev) for t in p) for i, p in
                              darknet.pack_residual_blocks(folded, self.spec, cd).items()}
            else:
                self._folded_cpu = folded  # f32 weights of the calibration probe
                qp = (darknet.quantize_folded_int8(folded, self.spec, self._int8_upto)
                      if precision == "int8_early"
                      else darknet.quantize_folded_int8_full(folded, self.spec))
                self._qparams = {k: {n: t.to(dev) for n, t in v.items()}
                                 for k, v in qp.items()}
            if s2d_stem and precision == "int8_full":
                s2d = darknet.make_s2d_stem_int8(folded, qp, self.spec)
                if s2d_downsample:
                    s2d_downs = {i: w.to(dev)
                                 for i, w in darknet.make_s2d_down_int8(qp, self.spec).items()}
            elif s2d_stem:
                s2d = darknet.make_s2d_stem(folded, self.spec)
            if s2d is not None:
                # the float weights in compute_dtype and channels_last, as the
                # convs'; the biases in the dtype the executor adds them in
                s2d = {k: (v.to(dev, cd).contiguous(memory_format=torch.channels_last)
                           if k in ("wa", "wb") else
                           v.to(dev, bias_dtype) if k in ("ba", "bb") else v.to(dev))
                       for k, v in s2d.items()}
        replica = _Replica(self.params, self.packs, self._qparams, s2d, s2d_downs)
        self._replicas = replicate(replica, mesh) if mesh is not None else [replica]
        self._act_scales: Optional[Dict[str, float]] = None
        self._calib_meta: Dict = {}
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
        self.int8_compute = int8_compute
        self.pallas_blocks = pallas_blocks
        self.s2d_stem = s2d_stem
        self.int32_accum_max_hw = int32_accum_max_hw
        self.calib_percentile = float(calib_percentile)
        self._last_ncand: Optional[torch.Tensor] = None
        self.overflow_images = 0
        self.images_seen = 0
        self.max_candidates_seen = 0

    def preprocess(self, tiles_u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC tiles on the device → NHWC model input."""
        if self.host_resize and tuple(tiles_u8.shape[1:3]) != (self.model_size,) * 2:
            raise ValueError(f"host_resize=True expects {self.model_size}² tiles, "
                             f"got {tuple(tiles_u8.shape[1:3])}")
        if self.route.k1:
            return resize_normalize(tiles_u8, self.model_size)  # K1
        return preprocess_tiles(tiles_u8, self.model_size)

    def model_input(self, tiles_u8: torch.Tensor) -> torch.Tensor:
        """The input the executors take: :meth:`preprocess`, and for the int8
        precisions the exact f32 image (:func:`~.ops.preprocess.
        f32_from_bf16_input` undoes K1's bf16 rounding)."""
        x = self.preprocess(tiles_u8)
        if self.precision != "bf16" and x.dtype == torch.bfloat16:
            x = f32_from_bf16_input(x)
        return x

    def _tf32_scope(self):
        return no_tf32() if self.route.tf32_off else contextlib.nullcontext()

    def head_maps(self, tiles_u8: torch.Tensor) -> List[torch.Tensor]:
        """The f32 NHWC head maps for a batch of uint8 tiles on the device."""
        with self._tf32_scope():
            return self._head_maps(tiles_u8, self._replicas[0])

    def _head_maps(self, tiles_u8: torch.Tensor, rep: _Replica) -> List[torch.Tensor]:
        if self.precision != "bf16" and self._act_scales is None:
            raise ValueError(f"{self.precision} needs activation scales: "
                             "calibrate() or load_calibration() first")
        with spans.span(spans.DETECT_PREPROCESS):
            x = self.model_input(tiles_u8)
        cd = self.compute_dtype
        with spans.span(spans.DETECT_BACKBONE):
            if self.precision == "int8_full":
                return darknet.apply_folded_int8_full(
                    rep.params, rep.qparams, self._act_scales, self.spec, x,
                    compute_dtype=cd, s2d_stem=rep.s2d, s2d_downs=rep.s2d_downs,
                    int32_accum_max_hw=self.int32_accum_max_hw)
            if self.precision == "int8_early":
                return darknet.apply_folded_int8(
                    rep.params, rep.qparams, self._act_scales, self.spec, x,
                    upto=self._int8_upto, compute_dtype=cd, int8_compute=self.int8_compute)
            if not self.fold_bn:
                return darknet.apply(rep.params, self.spec, x, compute_dtype=cd)
            return darknet.apply_folded(rep.params, self.spec, x, compute_dtype=cd,
                                        packs=rep.packs, s2d_stem=rep.s2d, spp=self.spp,
                                        routes=self.routes)

    @torch.inference_mode()
    def calibrate(self, tiles_u8, *, accumulate: bool = False,
                  rebuild: bool = True) -> Dict[str, float]:
        """Static int8 activation scales from a representative batch (no-op
        for bf16): an f32 probe forward with TF32 off.

        ``accumulate=True`` takes the elementwise max with the scales held,
        so calibration can run over several batches (with ``calib_percentile
        < 100`` that is the max of the per-batch percentiles).  ``rebuild``
        is the reference's signature: PyTorch runs eagerly, nothing is
        compiled.  Degenerate scales (a layer the batch never excited) warn.
        """
        if not self.precision.startswith("int8"):
            return {}
        x = self.model_input(torch.as_tensor(tiles_u8).to(self.device))
        folded = {k: {"w": v["w"].to(self.device), "b": v["b"].to(self.device)}
                  for k, v in self._folded_cpu.items()}
        if self.precision == "int8_full":
            scales = darknet.calibrate_act_scales_full(
                folded, self.spec, x, percentile=self.calib_percentile)
        else:
            scales = darknet.calibrate_act_scales(
                folded, self.spec, x, self._int8_upto, percentile=self.calib_percentile)
        if accumulate and self._act_scales is not None:
            scales = {k: max(v, self._act_scales.get(k, 0.0)) for k, v in scales.items()}
        degenerate = sorted(k for k, v in scales.items() if v < self.DEGENERATE_SCALE)
        if degenerate:
            warnings.warn(
                f"int8 calibration produced degenerate (≈0) activation scales for "
                f"layer(s) {degenerate}: the calibration batch never excited them "
                "(blank tile?).  Detections will be garbage — calibrate() with a "
                "representative batch, or accumulate=True over several.",
                UserWarning, stacklevel=2)
        self._act_scales = scales
        return scales

    def save_calibration(self, path: str, *, meta: Optional[dict] = None) -> str:
        """Write the activation scales as a JSON sidecar in the reference's
        format, with the keys :meth:`load_calibration` checks."""
        if not self.precision.startswith("int8"):
            raise ValueError(f"precision {self.precision!r} has no activation "
                             "scales to save")
        if self._act_scales is None:
            raise ValueError("no calibration to save — run calibrate() first")
        payload = {
            "format": self.CALIBRATION_FORMAT,
            "precision": self.precision,
            "int8_upto": self._int8_upto,
            "calib_percentile": self.calib_percentile,
            "model_size": self.model_size,
            "tile_size": self.tile_size,
            "host_resize": bool(self.host_resize),
            "n_layers": len(self.spec.layers),
            "scales": {k: float(v) for k, v in self._act_scales.items()},
            "meta": dict(meta if meta is not None else self._calib_meta),
        }
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        return path

    def load_calibration(self, path: str, *, rebuild: bool = True) -> Dict[str, float]:
        """Read a sidecar (this package's or the reference's).  Refuses
        scales recorded under another quantized graph (precision, int8
        region, layer count, percentile); warns on another input geometry
        (model size, tile size, host resize)."""
        with open(path) as fh:
            d = json.load(fh)
        if d.get("format") != self.CALIBRATION_FORMAT:
            raise ValueError(f"{path}: not a calibration sidecar "
                             f"(format={d.get('format')!r})")
        for key, want in [("precision", self.precision),
                          ("int8_upto", self._int8_upto),
                          ("n_layers", len(self.spec.layers)),
                          ("calib_percentile", self.calib_percentile)]:
            if d.get(key) != want:
                raise ValueError(
                    f"{path}: calibration was recorded with {key}={d.get(key)!r}, "
                    f"this detector has {want!r} — the scales do not correspond "
                    "to this quantized graph")
        for key, want in [("model_size", self.model_size),
                          ("tile_size", self.tile_size),
                          ("host_resize", bool(self.host_resize))]:
            if d.get(key) != want:
                warnings.warn(
                    f"{path}: calibration was recorded with {key}={d.get(key)!r} but "
                    f"this detector has {want!r}; scales remain valid but were "
                    "measured on a different input geometry", UserWarning, stacklevel=2)
        self._act_scales = {k: float(v) for k, v in d["scales"].items()}
        self._calib_meta = {**d.get("meta", {}), "loaded_from": path}
        return self._act_scales

    #: tiles a folder run calibrates on (one batch of 8 under-covers the
    #: activation range)
    CALIB_TILES = 48

    def _calibrate_from_folder(self, folder_ds: ImageFolder, batch_size: int) -> None:
        """int8 scales from the first ~:attr:`CALIB_TILES` tiles of a folder
        (amax accumulated batch by batch), with their provenance (tile
        names, an order-sensitive sha256, the first four) in the sidecar's
        ``meta``."""
        chunks, got, used = [], 0, []
        for paths, batch, n_valid in folder_ds.iter_batches(batch_size):
            take = min(n_valid, self.CALIB_TILES - got)
            used.extend(paths[:take])
            c = np.asarray(batch)[:take]
            if len(c) < batch_size:
                # pad by cycling the chunk's real tiles, so a percentile
                # statistic weighs every real tile about equally
                c = np.concatenate([c, c[np.arange(batch_size - len(c)) % len(c)]], axis=0)
            chunks.append(c)
            got += take
            if got >= self.CALIB_TILES:
                break
        if not chunks:
            return
        names = [os.path.basename(str(p)) for p in used]
        self._calib_meta = {
            "source": "folder",
            "n_tiles": len(names),
            "tiles_sha256": hashlib.sha256("\n".join(names).encode()).hexdigest(),
            "first_tiles": names[:4],
        }
        for c in chunks[:-1]:
            self.calibrate(c, accumulate=True, rebuild=False)
        self.calibrate(chunks[-1], accumulate=True)

    @torch.inference_mode()
    def __call__(self, tiles_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """tiles (B, tile, tile, 3) uint8 (numpy or tensor) → ``(dets
        (B, capacity, 7), valid (B, capacity))`` on the device.

        The per-image conf-passing candidate count stays on the device as
        ``self._last_ncand`` until :meth:`account_overflow` reads it.
        """
        tiles = torch.as_tensor(tiles_u8)
        if self.precision != "bf16" and self._act_scales is None:
            self.calibrate(tiles.to(self.device))  # lazily, on the whole first batch
        with self._tf32_scope():
            if self.mesh is None:
                dets, valid, n_cand = self._detect(tiles.to(self.device), self._replicas[0])
            else:
                outs = [self._detect(part, rep) for part, rep in
                        zip(split_batch(tiles, self.mesh), self._replicas)]
                dets, valid, n_cand = (torch.cat([to_device(o[i], self.device) for o in outs])
                                       for i in range(3))
        self._last_ncand = n_cand
        return dets, valid

    def _detect(self, tiles: torch.Tensor, rep: _Replica):
        """One device's share of a call: ``(dets, valid, n_cand)`` there, its
        stages in the ``detect/*`` spans (:mod:`.utils.spans`)."""
        maps = self._head_maps(tiles, rep)
        pool = self.nms_pool
        if self.lazy_decode:
            with spans.span(spans.DETECT_DECODE):
                det, scores, n_cand = heads.decode_topk(
                    maps, self.spec, self.model_size, self.conf_thres, pool)
            with spans.span(spans.DETECT_NMS):
                dets, valid = nms_ops.non_max_suppression_pooled(
                    det, scores, self.nms_thres, self.capacity)
        else:
            with spans.span(spans.DETECT_DECODE):
                pred = heads.decode_all(maps, self.spec, self.model_size)
            with spans.span(spans.DETECT_NMS):
                dets, valid, n_cand = nms_ops.non_max_suppression(
                    pred, self.conf_thres, self.nms_thres, self.capacity, pool=pool,
                    return_count=True)
        with spans.span(spans.DETECT_RESCALE):
            dets = rescale_boxes_batched(dets, self.model_size, self.tile_size, self.tile_size)
        return dets, valid, n_cand

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

    def detect_folder(self, folder: str, batch_size=16, merge_boxes: bool = False,
                      caa_filter=None, pipeline_depth: int = 2, fast_decode: bool = False,
                      background_skip: bool = False) -> Dict[str, Optional[np.ndarray]]:
        """Detections for every image of a folder: ``{path: (N, 7) rows in
        the image's own pixels, or None}``.  Unreadable files are reported
        and left out.

        ``fast_decode``: the native reader's DCT-scaled decode with
        ``host_resize`` (:class:`~.io.datasets.ImageFolder`).
        ``background_skip``: drop background tiles before decoding them
        (:func:`~.io.tissue.prefilter_tile_paths`); they come back as
        ``None``.  The other options are :meth:`detect_dataset`'s.
        """
        folder_ds = ImageFolder(folder, tile_size=self.tile_size,
                                resize_to=self.model_size if self.host_resize else None,
                                fast_decode=fast_decode)
        results: Dict[str, Optional[np.ndarray]] = {}
        if background_skip:
            folder_ds.files, skipped = prefilter_tile_paths(folder_ds.files)
            for p in skipped:
                results[p] = None
            if skipped:
                print(f"background prefilter skipped {len(skipped)}/"
                      f"{len(skipped) + len(folder_ds.files)} tiles", flush=True)
            if not folder_ds.files:
                return results
        results.update(self.detect_dataset(folder_ds, batch_size, merge_boxes=merge_boxes,
                                           caa_filter=caa_filter,
                                           pipeline_depth=pipeline_depth))
        return results

    def detect_dataset(self, folder_ds: ImageFolder, batch_size=16, merge_boxes: bool = False,
                       caa_filter=None, pipeline_depth: int = 2
                       ) -> Dict[str, Optional[np.ndarray]]:
        """:meth:`detect_folder` over an :class:`~.io.datasets.ImageFolder`
        whose file list the caller may have cut (the whole-slide sweep's
        prefilter).

        ``batch_size``: an int or ``"auto"`` (:func:`resolve_batch_size`).
        ``merge_boxes``: union-merge overlapping same-class boxes
        (:func:`~.ops.merge.merge_detections`).  ``caa_filter``: a callable
        ``(path, dets) -> dets``, e.g. :meth:`.domain.CAAFilter.filter_path`;
        a tile it empties comes back as ``None``.  The int8 precisions
        calibrate on the folder's first tiles (:meth:`_calibrate_from_folder`)
        when they have no scales.

        Up to ``pipeline_depth`` batches are on the device while the host
        merges and filters earlier ones: launches are asynchronous, and the
        only sync is :func:`~.ops.nms.dense_to_ragged` in the drain.
        """
        results: Dict[str, Optional[np.ndarray]] = {}
        inflight: "collections.deque" = collections.deque()

        def drain_one():
            paths, n_valid, (dets, valid), n_cand = inflight.popleft()
            ragged = nms_ops.dense_to_ragged(dets, valid)  # the sync point
            self.account_overflow(n_valid, n_cand)
            for path, det in list(zip(paths, ragged))[:n_valid]:
                if det is not None:
                    orig = folder_ds.orig_shapes.get(path)
                    if orig is not None:  # WSI borders: back to the image's pixels
                        det = rescale_from_tile_frame(det, self.tile_size, orig)
                if det is not None and merge_boxes:
                    det = merge_detections(det)
                if det is not None and caa_filter is not None:
                    det = caa_filter(path, det)
                    if det is not None and len(det) == 0:
                        det = None
                results[path] = det

        batch_size = resolve_batch_size(batch_size, len(folder_ds))
        if self.precision.startswith("int8") and self._act_scales is None:
            self._calibrate_from_folder(folder_ds, batch_size)
        for paths, batch, n_valid in folder_ds.iter_batches(batch_size):
            inflight.append((paths, n_valid, self(batch), self._last_ncand))
            if len(inflight) > pipeline_depth:
                drain_one()
        while inflight:
            drain_one()
        return results


__all__ = ["Detector", "Route", "route", "resolve_batch_size"]
