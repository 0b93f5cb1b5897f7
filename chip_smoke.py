#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``amyloid_yolo_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. versions, and the card's name and power limit from ``nvidia-smi``;
2. build every kernel from ``amyloid_yolo_tpu_torch/csrc`` (one ``nvcc``
   per source, in parallel); count the ``HGMMA`` (``wgmma``) and ``HMMA``
   (``mma.sync``) instructions in K2's library (``cuobjdump -sass``): none
   of the first fails the run;
3. K1 (``resize_normalize``) against its plain version at B=4, 1536² → 416²:
   bit-exact;
4. K2 (``fused_residual_block``) against its plain version in bf16 at the
   five stage shapes of YOLOv3-416 and a ragged unit (20², 128 channels),
   at B=1, 4, 8 and 32 (the tiling depends on B: 8 and 32 are the batches
   phases 6 and 9 run), within one bf16 ulp; each launch plan's shared memory
   from Python (``smem_bytes``) must equal the C side's, and its blocks per
   SM the ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` count; then
   the same on units whose tiles leave partial m64 blocks in the ``wgmma``
   3×3, one at each C/2 it takes (``K2_RAGGED``: 20²×128, 7²×256,
   11²×512, 13²×1024 at B=1), each through ``plan_launch``'s tiling and
   the best-modelled feasible tiling of every other kernel variant (warp
   width, block tile width): all four ``wgmma`` variants must be checked;
5. K3 (``fused_residual_block_int8``) against its plain version at the five
   stage shapes and the ragged unit, at B=1, 4, 8 and 32 (its tiling, too,
   depends on B), random int8 inputs with the reference tool's weight and
   scale ranges (``tools/bench_int8_block.py``): bit-exact; shared memory
   and blocks per SM of each plan, Python against C, as in phase 4;
6. the main path: ``Detector(conf_thres=0.3)`` at the full width of
   ``yolov3_spec(num_classes=2)``, 416 on 1536² tiles, random weights from a
   numpy seed carried over with ``params_from_jax``, 3 batches of 8 tiles.
   Launch counts must be 3 (K1), 69 (K2) and 0 (K3), and 87 of the library
   convs' epilogue (29 a call); head maps through the kernels must match the
   plain path on the card; outputs finite, (8, 64, 7) and (8, 64).  Then
   one call of a bf16 ``Detector`` of YOLOv4 at 608
   (``benchmark/configs/yolov4-amyloid-608.cfg``, weights from the
   Detector's seed) on the first batch, both epilogue counters set to 0
   just before: 72 launches of the Mish epilogue, 10 of them into a CSP
   route's slice (``darknet.route_slices``; none in the YOLOv3 calls), 38
   of the leaky one and 1 of the SPP block's kernel (none in the YOLOv3
   calls before it), K1 once, K2 and K3 never, outputs as above;
7. the int8 Detectors, ``precision="int8_full"`` and ``"int8_early"``, on
   the same weights, calibrated on the first batch, then 3 batches of 8:
   launch counts 3 (K1), 0 (K2), 0 (K3); outputs finite and shaped as
   above; the ``int8_full`` head maps of one tile on the card against the
   CPU with the same scales (through a calibration sidecar), within
   ``HEAD_TOL``; and the unfolded bf16 ``Detector(fold_bn=False)`` on one
   batch: launches 1/0/0, outputs finite and shaped.  A record, not a gate:
   on one batch each, the int8 levels that ``ops/int8.py:quant`` (the
   product with ``f32(1/s)`` that the compiled reference computes) sets
   otherwise than the true division by ``s`` would on the same values
   (:func:`division_flips`);
8. K3's path: the 23 residual units of the calibrated ``int8_full`` model
   (``pack_model_int8_units``), chained stage by stage from a random int8
   stage input at B=8: 23 launches, each unit bit-exact against the plain
   version; then the same chain at B=4, bit-exact;
9. timings on the card: the three Detectors at B=8 and B=32 (tiles already
   on the card), a ``torch.profiler`` breakdown of the bf16 and
   ``int8_full`` device time at B=8, and each kernel's time beside its plain
   version, a PyTorch library yardstick where one exists, and its bound
   (H100 SXM peaks: 989 TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s); K2 and
   K3 per stage at B=8 and B=32 with their launch plans (grid, blocks per
   SM, waves, executed-work ratio), achieved TFLOP/s or TOP/s, and which
   3×3 each K2 stage ran (``conv3x3_path``: ``wgmma`` or ``mma.sync``); the
   library convs' epilogue (``kernels/bias_leaky.py``) at the 29 conv
   outputs of a B=64 call, bit-exact to its plain version on each and timed
   beside it and its bytes bound (:func:`epilogue_rows`); its Mish form
   (``bias_mish``) at the 72 Mish conv outputs of a B=64 YOLOv4 call at
   608, within one bf16 ulp of its plain version on each (the share of
   elements that differ recorded) and timed the same way, and at the ten
   members of the CSP routes joined in place also into the member's slice
   of the route's map, bit for bit the in-place kernel with the map's other
   channels untouched, timed beside the in-place form (:func:`mish_rows`);
   YOLOv4's SPP block (``kernels/spp_pool.py``) on its B=64 input at 608,
   bit-exact to its plain version (the pools and the cat) and timed beside
   it and its bytes bound (:func:`spp_rows`).  Every
   trace behind a printed device-busy, idle-share or launch figure (here
   and in phases 10, 11, 16, 17 and the BN tool of 18 (e)) is warmed (a
   dropped warm-up step) and checked complete: it must keep a device record
   for each launch call of the host but ``TRACE_UNRECORDED_PER_CALL`` a
   Detector call or step (``trace_summary_torch.checked_trace``, taken
   again up to ``TRACE_TRIES`` times, each try's counts printed);
   phase 12 (d)'s device-only trace cannot be checked and says so;
10. the folder path (``Detector.detect_folder``, the path of ``detect``): a
   temporary folder that PIL writes (37 synthetic stain tiles of 1536², one
   1536×1000 border tile, two near-blank tiles, one corrupt ``.jpg``); the
   decoder is the port's native tile reader where the libjpeg headers are
   present (then it must build) and PIL where they are absent.  The bf16
   Detector of phase 6 runs ``detect_folder(batch_size=8, merge_boxes=True,
   caa_filter=CAAFilter(...).filter_path)`` with a random classifier from a
   numpy seed: K1 launches = K2 launches / 23 = the batch count; every
   readable path in the result, the corrupt one reported and absent; the
   border tile's boxes in its own pixels; the result equal, box for box, to
   an explicit recomputation (reader, ``Detector.__call__``,
   ``dense_to_ragged``, ``rescale_from_tile_frame``, ``merge_detections``,
   the filter); the classifier on the card within ``CAA_TOL`` of its CPU
   float32 run; ``background_skip=True`` returns the blank tiles as
   ``None``; an ``int8_full`` Detector calibrates from the folder and its
   sidecar records the 40 readable tiles.  Then tiles/s of
   ``detect_folder`` at B=8 and B=32 from the JPEGs on disk to the filtered
   boxes, beside the reader alone and ``Detector.__call__`` on the same
   tiles already on the card, and a ``torch.profiler`` trace of one B=8
   folder run (one batch of it in the dropped warm-up step) for the
   device's busy time and idle share;
11. the training path, at the full width of ``yolov3_spec(num_classes=2)``
   at 416 on 1536² tiles, with the weights of phase 6: (a) one float32
   micro-step at B=2 (augment off) on the card and on the CPU — loss and new
   BN running statistics within ``STEP_RTOL``; the gradients' relative
   2-norm differences, median and worst over the tensors (the worst
   printed), each within ``STEP_GRAD_NOISE_FACTOR`` times what swapping the
   batch's two images does on the CPU (see ``STEP_GRAD_NOISE_FACTOR``);
   (b) K1/K2/K3 launch 0/0/0 over the whole phase; (c) ``OVERFIT_APPLIES``
   bf16 applies on one fixed augmented batch of 8: the loss falls below
   half its first value, finite throughout; (d) the ``Trainer`` on a
   temporary set that PIL writes (48 train and 16 valid stain tiles with
   1-4 labels): 2 epochs of 6 micro-batches of 8 with accumulation 2,
   multiscale and augmentation on — ``step`` 12, ``seen`` 96, every loss
   finite, parameters moving exactly on the 6 applies, the multiscale size
   changing at global batch 10, a finite validation mAP in [0, 1] logged
   for both epochs, one checkpoint per epoch, and the last checkpoint
   evaluating to the same AP in a fresh ``Trainer``; (e) the B=8 micro-step
   in float32 (TF32 off) and bf16 (median, min, max of 10 after 3) with a
   ``torch.profiler`` breakdown by part from a trace that kept a device
   record for each of the host's launch calls but one a step (taken again
   until one did), and one traced ``Trainer`` epoch's wall time, device
   busy time and idle share, held to the same rule;
12. the serving path and the CLI, at the same width with the weights of
   phase 6: (a) ``cli export`` of the weights to a ``.pth`` that reads back
   equal; (b) a ``DetectionServer`` at the serve CLI's defaults (batch 16,
   ``max_wait_ms`` 5) around a bf16 ``Detector(conf_thres=0.3)`` with the
   random CAA filter of phase 10, warmed up; (c) 24 requests from 8 client
   threads (exact-tile JPEG stain tiles, raw RGB with ``X-Image-Shape``, a
   1536×1000 border PNG, ``merge=0&caa_filter=0``): all 200, K1/K2/K3
   launching 1/23/0 per dispatch, and each answer equal to its explicit
   recomputation (``_to_tile_frame``, ``detect_batch_ragged`` at B=16, the
   rescale, the merge, the CAA filter alone) within ``SERVE_TOL``, the
   native decode asserted where libjpeg is present; (d) a closed loop of 16
   clients in a process of their own, ~10 s of raw and ~5 s of JPEG bodies:
   requests/s, p50/p99, dispatches and ``batched_ratio``, then ~5 s of raw
   bodies again with 3 s of it traced by ``torch.profiler`` (the device's
   busy share); beside them ``Detector.__call__`` at B=16 on the card, the
   pageable upload's share of a dispatch (``np.stack`` and
   ``detect_batch_ragged``), PIL's decode and the CAA filter, each alone;
   (e) a burst of 48 at ``max_queue`` 16:
   answers 200 or 503 with ``Retry-After``, ``/stats`` ``shed`` equal to the
   503s, an oversize ``Content-Length`` answered 413; (f) ``cli detect``
   over phase 10's folder at B=8 (its label rows equal ``detect_folder``'s,
   one image a tile with boxes), ``cli serve`` in a subprocess (its
   ``serving on`` line, one POST answered as this process's server answers,
   ``/healthz`` naming the card, exit 0 within 30 s of SIGINT) and ``cli
   sweep`` over two WSIs of phase 10's tiles in row directories with the
   cross-tile merge (its pickles equal a recomputation from
   ``detect_folder`` over each row), its set-up timed alone; (g)
   ``calculate_plaque_counts_per_wsi`` alone, the Detector and filter
   built, over 296 tiles (phase 10's 37 in 4 WSIs of 2 rows): tiles/s and
   K1/K2/K3 launching 1/23/0 per batch;
13. data parallelism, at the same width with the weights of phase 6, on a
   mesh over every card (two entries on one card where there is one):
   (a) the float32 ``Detector`` on the card (the plain preprocess and
   cuDNN's units, TF32 off for the call) against the CPU on 8 tiles: K1/K2
   launch 0/0, the TF32 flags off inside the call and as they were after
   it, head maps within ``F32_HEAD_TOL``; (b) ``Detector(mesh=...)`` at
   B=32: K1 = shards and K2 = 23 x shards launches, outputs equal to the
   one-device ``Detector`` on the same shards within ``SERVE_TOL``, tiles/s
   of both; (c) the in-process data-parallel train step
   (``shard_train_step``, 2 shards) at B=8, float32, one apply, against
   the one-device step: loss within ``DP_LOSS_RTOL``, parameters within
   rtol 1e-4 / atol 2.05 lr, BN running statistics within ``STEP_RTOL``;
   one bf16 step finite; (d) the multi-process step
   (``shard_train_step_multiprocess``) in child processes, each with a
   timeout, against (c)'s one-device step with the same bounds: two gloo
   ranks with CUDA tensors on one card, NCCL at world size 1, and NCCL
   over every card where there are two or more, one group after another; the step
   times of (c) and (d) are means over ``DP_TIMED_STEPS`` steps after the
   checked one, on the host clock; (e) ``cli sweep --data_parallel 2``
   over two WSIs of phase 10's tiles: the one-device sweep's counts at the
   same batch a device; (f) where there are two or more cards, ``python -m
   torch.distributed.run --standalone --nproc_per_node=<cards> -m
   amyloid_yolo_tpu_torch.cli train --distributed True`` for one epoch of
   ``DP_TR_BATCHES`` batches of ``DP_TRAIN_B`` synthetic tiles at 416, augment
   off, against the one-device ``Trainer`` on the same data and seed: the
   first batch's logged loss within ``DP_LOSS_RTOL``, the checkpoint's
   parameters within rtol 1e-4 / atol 2.05 lr after its one apply and its
   BN running statistics within ``STEP_RTOL`` (``tests/test_parallel.py``'s
   bounds); on one card it prints that it did not run and why;
14. spatial sharding (``parallel/spatial.py``), at the same width with the
   weights of phase 6, at the tiles' native 1536² (no resize), float32 with
   TF32 off, ``sp=2`` over cuda:0,1 (two entries on cuda:0 where there is
   one card): (a) ``spatial_forward`` and ``spatial_detect`` (conf 0.8, NMS
   0.4, capacity 64) on B=2 stain tiles against the unsharded forward on
   the card: decoded predictions within rtol 1e-4 / atol 1e-5,
   ``n_candidates`` and ``valid`` equal, dets within 1e-4
   (``tests/test_spatial.py``'s bounds); ms a call and peak memory per
   card; (b) the height-sharded train step at B=2, one apply, augment off,
   against the one-device step: loss within ``DP_LOSS_RTOL``, parameters
   within rtol 1e-4 / atol 2.05 lr, BN running statistics within
   ``STEP_RTOL``; step ms (host clock, mean of ``DP_TIMED_STEPS`` after
   the checked one) and peak memory per card of both; one bf16 sharded
   step finite; (c) ``Trainer(spatial_shard=2)`` for one epoch of 2
   batches of 2 augmented 1536² tiles: losses finite; (d) where there are
   four cards, ``sp=4`` over cuda:0-3 at B=8: loss, step ms and peak
   memory per card, and whether the unsharded B=8 step fits one card (an
   out-of-memory error there is reported, not fatal; where it fits, its
   loss within ``DP_LOSS_RTOL``); (e) the s2d stem on the row shards: the
   height-sharded s2d grad step (B=2, float32, TF32 off) against the
   unsharded s2d step and against the height-sharded plain-stem step, and
   (f) ``bn_form="matmul"``: the sharded matmul step against the unsharded
   matmul step and the sharded reduce step, each compared on the loss,
   every gradient and the new BN statistics with the bounds of
   :func:`sp_form_checks`; (g) the sharded train step's ms and peak GiB per
   card in the plain, s2d and matmul forms; (h) where there are two cards,
   four probes, one process each, of a gradient crossing from cuda:1 into
   a tensor on cuda:0 (:data:`GRAD_PROBES`), naming the ones PyTorch warns
   of with its AccumulateGrad stream mismatch; that warning is an error
   throughout the phase; K1/K2/K3 launch 0/0/0 over the phase.
   (a) first raises the objectness biases of the three head convs by one
   constant (:func:`raise_objectness`), so that ``SP_OBJ_SHARE`` of the
   unsharded forward's rows pass conf 0.8, and both confs must compare a
   nonzero number of candidates;
15. the study path (``analysis/prospective.py``, ``plots.py``,
   ``validation.speed_check``, ``domain.pre_process``), at the same width
   with the weights of phase 6, the bf16 ``Detector`` at conf 0.3 and NMS
   0.4 and phase 10's random CAA filter, on a folder like phase 10's:
   (a) ``run_model_on_validation_images`` at B=8 with merge and filter:
   K1/K2/K3 launch 1/23/0 per batch, the pickle equal to
   ``recompute_folder``'s rows, wall and tiles/s of two runs; (b) annotator
   sets made from those predictions (:func:`study_annotators`): the TPs at
   IoU 0.5 equal the rows NP1 copies, the interrater agreement of NP1 and
   NP2 is 1.0 for each class present; where pandas is installed the PRC
   tables at IoU 0.1-0.9, precision 1.0 on the copied images and the AP
   maps (sklearn's branch or the numpy one); the PIL overlays, and the
   matplotlib figures where it is installed; (c) ``speed_check`` at B=1
   and 8 over a two-WSI tree of the folder's tiles: every tile counted,
   model time, down time and seconds a tile; (d) ``pre_process(weak_label=
   True)`` on a synthetic CSV pair, the filter on the card within
   ``PREPROCESS_TOL`` of the CPU; (e) ``examples/run_study_torch.py
   --synthetic`` in a process of its own: exit 0 and its five stages;
16. the layout options (``Detector(s2d_stem=, s2d_downsample=)``, the train
   steps' ``s2d_stem`` and ``image_layout``, ``bn_form``), at the same width
   with the weights of phase 6, conf 0.3, every float32 reference with TF32
   off: (a) ``Detector(s2d_stem=True)`` on 3 batches of 8: K1/K2/K3
   3/69/0, head maps within ``HEAD_TOL`` of the plain-stem Detector's;
   float32 Detectors, s2d against plain, within ``S2D_F32_TOL``; (b)
   ``int8_full`` with the s2d stem, and with ``s2d_downsample`` too, on one
   calibration (a sidecar): 3/0/0 each over 3 batches, the stem's head
   maps within ``HEAD_TOL`` of the plain ``int8_full``'s and no further
   from them than they lie from the float32 Detector's, the s2d downsample
   bit-exact against the plain conv 5 at ``int32_accum_max_hw=416``; (c)
   one float32 micro-step at B=8 (augment off), s2d against plain: loss
   within ``S2D_LOSS_RTOL``, the whole gradient's cosine above ``S2D_GRAD_COS`` (see there), and the
   gradients of a float64 forward at B=2 within ``S2D_F64_GRAD_RTOL``; an
   augmented batch planar against nhwc within
   ``PLANAR_TOL``, targets equal; the train forward with ``bn_form=
   "matmul"`` against ``"reduce"``: loss within ``BN_FORM_LOSS_RTOL``;
   the new BN statistics of the s2d and the matmul train forwards within
   ``STEP_RTOL`` and ``BN_FORM_STAT_RTOL``, or phase 11's noise rule where
   that is wider (see there); 0/0/0 launches over (c); (d)
   times with their spread (``TIME_RUNS`` runs): the bf16 Detector at B=8
   and 32 with and without the s2d stem, ``int8_full`` at B=32 with the
   CLI's fast-path kwargs (s2d stem) and without the stem, layers 0-1
   alone at B=32 (plain and s2d, device time), and the bf16 B=8 micro-step
   plain or s2d, reduce or matmul, each with the host's enqueue and a
   ``torch.profiler`` breakdown;
17. the bench and the measurement tools, at the same width: (a)
   ``python3 bench_torch.py`` in a process of its own with ``BENCH_ITERS``
   10: exit 0, exactly two stdout lines with ``bench.py``'s keys, order and
   metric names, the headline last, its stderr naming the card and giving
   each repetition's time, and the launches per call it prints (K1 1 on
   both lines, K2 23 on the bf16 parity line and 0 on the ``int8_full``
   headline, K3 0; the host-resized variant's K1 recorded); (b) ``python
   -m amyloid_yolo_tpu_torch.cli bench`` with ``BENCH_BATCH=8
   BENCH_ITERS=3``: the same; (c) ``tools/bench_int8_block_torch.py`` at
   its four unit shapes, B=16: K3 bit-exact to its plain version on the
   first application, the three arms' times, K3's plan and bound; (d)
   ``tools/bench_trainstep_torch.py``'s bf16 and f32 step at B=8, against
   phase 11's range (a record: the tool applies Adam every step); (e)
   ``tools/serve_bench_torch.py`` around a bf16 server, raw bodies, 8
   clients for ``SERVE_TOOL_S``: no errors, ``queue_depth_max <=
   max_queue``; (f) ``tools/trace_summary_torch.py`` over the Chrome trace
   of one bf16 B=8 Detector call: K2 23 and K1 1 launches in its table,
   its busy share within ``SHARE_TOL`` of :func:`profile_detector`'s; (g)
   ``tools/mfu_torch.py`` over (a)'s and (d)'s times.  Every kernel of the
   phase's path launches in (c), (e) and (f), counted from 0 before (c);
18. the last modules of the JAX package, at the same width with the
   weights of phase 6, counted from 0 ((a) is left out: the port has no
   dense targets form, ROADMAP.md); (b) the exact bilinear warp
   (``ops/augment.py:_affine_one``) at B=8, 416²: card against CPU and
   planar against NHWC within ``WARP_TOL``, for pure translation against
   the shear warp within ``WARP_TOL`` at the JAX test's 64² and shifts,
   and inside the image at 416² (the border there recorded), both warps'
   ms; (c) the overlapped checkpoint save: a 2-epoch ``Trainer`` at B=8
   with EMA, its epoch walls, and in a second one each epoch's file bit
   for bit the host copy taken right after its dispatch (epoch 1's steps
   run before epoch 0's join), one more dispatch with a train step before
   its join, a write into an unwritable directory raised at the join, no
   save in flight after ``train()``; each dispatch (with
   ``Trainer.save_walls``' parts, the collector's pauses and the
   allocator's new segments in it), the join, a synchronous save and the
   snapshot's peak extra device memory recorded; (d)
   ``non_max_suppression_np`` on the host copy of phase 6's first batch's
   decoded rows against the device NMS (every candidate in its pool) at
   one threshold: the same boxes within ``NMS_TOL``, rows of equal score
   paired by box (K1 once and K2 23 times, the phase's launches); (e)
   ``tools/bench_trainstep_torch.py --warp-ab --forms-ab``,
   ``bench_bn_stats_torch.py`` and ``bench_s2d_down_b32_torch.py``, each
   in a process of its own: exit 0, their lines, the card named on
   stderr; (f) the last helpers: ``ops/preprocess.py:pad_to_square`` on the
   card against ``np.pad``, bit for bit, uint8 HWC and NHWC and float32
   with ``pad_value`` 0.5, the result left on the card; (d)'s host NMS rows
   mapped to tile pixels by the host ``ops/boxes.py:rescale_boxes`` and by
   ``rescale_boxes_batched`` on the card, within ``RESCALE_TOL``; and a
   ``Trainer(distributed=True)`` in a one-process NCCL group, in a process
   of its own, for one epoch of (c)'s set: its save overlapped (the
   dispatch's and the worker's parts in ``save_walls``) and its file equal
   to the live state;
19. one JSON line ``{"kernels": [...]}`` (with each kernel's launches on
   every path above; the epilogue's on phase 6's, the Mish epilogue's on
   its YOLOv4 call), the ``nvidia-smi`` line,
   and last
   ``{"ok": true, "device": {...}}``.

f32 references run with TF32 off.  It exits non-zero when CUDA is absent.
``python3 chip_smoke.py --dp-child ...`` is phase 13 (d)'s child process
(:func:`dp_child`), which the phase starts itself.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "tools"))  # the measurement tools of phase 17

from bench_int8_block_torch import k3_bound  # noqa: E402
from mfu_torch import H100_BF16_TFLOPS, H100_HBM_TBPS  # noqa: E402
from trace_summary_torch import checked_trace, warmed_profile  # noqa: E402

PEAK_BF16_FLOPS = H100_BF16_TFLOPS * 1e12
PEAK_BYTES = H100_HBM_TBPS * 1e12
STAGES = ((208, 64, 1), (104, 128, 2), (52, 256, 8), (26, 512, 8), (13, 1024, 4))
DETECTOR_BATCHES = (8, 32)                   # phases 6 (the first) and 9
CHECK_BATCHES = (1, 4) + DETECTOR_BATCHES  # K2's and K3's plans depend on B
RAGGED_UNIT = (20, 128)                    # H = W = 20: no tile size divides it
# (B, H, C) of units whose tiles leave partial m64 blocks, one at each C/2
# that K2's wgmma 3x3 takes, run through every (warp_n, block_n) variant
K2_RAGGED = ((1, 20, 128), (1, 7, 256), (1, 11, 512), (1, 13, 1024))
K2_RTOL, K2_ATOL = 2.0 ** -7, 2.0 ** -6      # one bf16 ulp, relative
HEAD_TOL = 5e-2                              # max |Δ| / max |plain| per head
SEED = 0
K3_SCALES = (0.011, 0.017, 0.023)            # sx, s1, s_out of the reference tool
CAA_TOL = 1e-3                               # classifier probabilities, card vs CPU f32
FOLDER = dict(n_tiles=37, side=1536, border=(1000, 1536), blank=2)
EPILOGUE_BATCH = 64                          # the detect-416-b64 cell's batch
MISH_BATCH = 64                              # the detect-v4-608-b64 cell's batch
V4_CFG = os.path.join(REPO, "benchmark", "configs", "yolov4-amyloid-608.cfg")
# A trace is complete when it kept a device record for each of the host's
# launch calls but this many a Detector call or train micro-step: the
# cudaMemsetAsync that one cuDNN convolution of each bf16 Detector call
# makes left no device record in every trace (3 of 54 memset calls over
# 3 calls, 5 of 90 over a 5-batch folder run, in each of 8 tries), as did
# one launch call of each bf16 train step; int8_full calls and f32 steps
# left none.
TRACE_UNRECORDED_PER_CALL = 1


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, hold: bool = True) -> float:
    """Mean ms per call between CUDA events.  ``hold`` first queues a ~20 ms
    sleep on the stream, so the host enqueues every timed launch before the
    device reaches them: the result is device time, not the host's launch
    rate.  Without it (the Detector) the host's cost per call counts too."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(40_000_000)  # cycles, ~20 ms at 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profile_detector(det, tiles, calls: int = 3, trace_path=None) -> dict:
    """Device time per call from a ``torch.profiler`` trace of ``calls``
    Detector calls: busy ms, the share of the traced span the device sat
    idle (the profiler's own host cost inflates it), and the launches and
    device ms of each kernel group (:func:`kernel_group`).  ``trace_path``
    also writes the trace there as Chrome JSON.  One call runs first in the
    profiler's warm-up step, whose events it drops: tracing starts late on
    the card, and without it the first kernels of a trace may be missing
    (the first K1 and 8 K2 launches of one call were, once, in phase 17).
    The trace must keep a device record for each launch call of the host
    but ``TRACE_UNRECORDED_PER_CALL`` a call
    (:func:`~trace_summary_torch.checked_trace`: taken again until it does,
    each try's counts in ``trace_tries``)."""
    import torch
    from torch.profiler import ProfilerActivity
    from trace_summary_torch import busy_and_span

    def take():
        with warmed_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            det(tiles)
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                det(tiles)
            torch.cuda.synchronize()
        return prof

    prof, tries = checked_trace(take, unrecorded=TRACE_UNRECORDED_PER_CALL * calls)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not events:
        return {"device_busy_ms": "not measured"}
    busy_us, span_us = busy_and_span((e.time_range.start, e.time_range.end) for e in events)
    groups, names = {}, {}
    for e in events:
        for table, key in ((groups, kernel_group(e.name)), (names, e.name[:90])):
            g = table.setdefault(key, [0, 0.0])
            g[0] += 1
            g[1] += e.time_range.elapsed_us()

    def per_call(table, n=None):
        rows = sorted(table.items(), key=lambda kv: -kv[1][1])[:n]
        return {k: {"launches": c / calls, "ms": us / calls / 1e3} for k, (c, us) in rows}

    return {"device_busy_ms": busy_us / calls / 1e3,
            "idle_share_traced": 1.0 - busy_us / span_us,
            "launches_per_call": len(events) / calls, "trace_tries": tries,
            "by_group": per_call(groups), "top_kernels": per_call(names, 6)}


def warm_up_kernels(dev) -> None:
    """A few small kernels and a synchronise: the warm-up step of a trace
    whose own work cannot run twice."""
    import torch
    torch.ones(1 << 20, device=dev).mul_(2).sum()
    torch.cuda.synchronize(dev)


def kernel_group(name: str) -> str:
    if "fused_residual_block_int8" in name:
        return "K3 fused_residual_block_int8"
    if "fused_residual_block" in name:
        return "K2 fused_residual_block"
    if "resize_normalize" in name:
        return "K1 resize_normalize"
    if any(s in name for s in ("fprop", "implicit_gemm", "cudnn", "conv")):
        return "cuDNN convolutions"
    if any(s in name.lower() for s in ("gemm", "imma", "xmma", "cutlass")):
        return "GEMMs (int8 _int_mm; cuDNN 1x1 convs as GEMMs)"
    if "elementwise" in name:
        return "elementwise"
    if "reduce" in name:
        return "reductions"
    if "sort" in name.lower() or "radix" in name.lower():
        return "sort"
    return "other"


def random_jax_params(spec, seed: int):
    """Reference-scheme weights (conv N(0, 0.02), BN scale N(1, 0.02)) with
    random BN shift and running stats, as the JAX package's numpy pytree."""
    import numpy as np
    rng = np.random.RandomState(seed)
    params = {}
    for i in spec.conv_indices:
        l = spec.layers[i]
        entry = {"w": (0.02 * rng.randn(l.kernel, l.kernel, l.in_ch, l.out_ch)).astype(np.float32)}
        if l.batch_normalize:
            n = l.out_ch
            params[f"bn_{i}"] = {
                "scale": (1.0 + 0.02 * rng.randn(n)).astype(np.float32),
                "bias": (0.1 * rng.randn(n)).astype(np.float32),
                "mean": (0.1 * rng.randn(n)).astype(np.float32),
                "var": (0.5 + rng.rand(n)).astype(np.float32),
            }
        else:
            entry["b"] = (0.1 * rng.randn(l.out_ch)).astype(np.float32)
        params[f"conv_{i}"] = entry
    return params


def k2_bound(b: int, h: int, c: int):
    flops = b * 20 * h * h * c * (c // 2)
    nbytes = b * 4 * h * h * c + 20 * c * (c // 2)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k2_stage_inputs(b, h, c, dev, gen):
    """Random bf16 unit at (b, h, h, c): x ~ N(0, 1), weights of variance
    1/fan-in, f32 biases 0.1·N(0, 1); (x, w1t, b1, w2t, b2) in the kernel's
    layouts."""
    import torch
    c2 = c // 2
    x = torch.randn(b, h, h, c, device=dev, generator=gen).to(torch.bfloat16)
    w1t = (torch.randn(c2, c, device=dev, generator=gen) / c ** 0.5).to(torch.bfloat16)
    w2t = (torch.randn(9, c, c2, device=dev, generator=gen) / (9 * c2) ** 0.5).to(torch.bfloat16)
    b1 = 0.1 * torch.randn(c2, device=dev, generator=gen)
    b2 = 0.1 * torch.randn(c, device=dev, generator=gen)
    return x, w1t, b1, w2t, b2


def sass_counts(name: str, opcodes=("HGMMA", "HMMA")) -> dict:
    """Instructions of each opcode in the built library of ``csrc/<name>.cu``
    (``cuobjdump -sass``, from the toolkit beside ``nvcc``)."""
    from amyloid_yolo_tpu_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.library_path(name)], capture_output=True,
                          text=True, check=True).stdout
    words = [line.split() for line in sass.splitlines()]
    return {op: sum(1 for w in words for t in w if t.split(".")[0] == op) for op in opcodes}


def checked_plan(b, h, c, kernel, sms, plan=None):
    """The launch plan of K2 or K3 (``plan_launch``'s unless given), its
    statistics, and the C side's blocks per SM; Python's and C's shared
    memory and blocks per SM must agree."""
    from amyloid_yolo_tpu_torch.kernels import conv_block, int8_block
    from amyloid_yolo_tpu_torch.kernels.conv_block import blocks_per_sm, plan_launch, plan_stats
    lib = int8_block if kernel is int8_block.K3 else conv_block
    plan = plan or plan_launch(b, h, h, c, sms, kernel)
    stats = plan_stats(b, h, h, c, plan, sms, kernel)
    c_smem = lib.c_smem_bytes(h, h, c, plan)
    c_bps = lib.c_blocks_per_sm(c, plan, stats.smem)
    if c_smem != stats.smem or c_bps != blocks_per_sm(stats.smem, plan):
        raise AssertionError(f"{kernel.name} plan {plan} at B={b} {h}x{h}x{c}: shared "
                             f"memory {stats.smem} (Python) vs {c_smem} (C), blocks "
                             f"per SM {blocks_per_sm(stats.smem, plan)} vs {c_bps}")
    return plan, stats, c_bps


def k2_variant_plans(b, h, c, sms) -> list:
    """``plan_launch``'s plan for (b, h, h, c), then for each other kernel
    variant (warp_n, block_n) the feasible plan of least modelled time."""
    from amyloid_yolo_tpu_torch.kernels.conv_block import (
        feasible_plans, modelled_seconds, plan_launch)
    pick = plan_launch(b, h, h, c, sms)
    best = {}
    for plan in feasible_plans(h, h, c):
        key = (plan.warp_n, plan.block_n)
        if key != (pick.warp_n, pick.block_n) and (
                key not in best or modelled_seconds(b, h, h, c, plan, sms)
                < modelled_seconds(b, h, h, c, best[key], sms)):
            best[key] = plan
    return [pick, *best.values()]


def partial_m64(b, h, c, plan) -> bool:
    """Whether some tile of ``plan`` leaves a partial m64 block in the 3x3."""
    from amyloid_yolo_tpu_torch.kernels.conv_block import tiles
    return any((rows * cols) % 64 for _, _, rows, _, cols, _ in tiles(b, h, h, c, plan))


def k2_check(b, h, c, dev, gen, sms, plan=None) -> float:
    """K2 against its plain version at (b, h, h, c) within one bf16 ulp, on
    ``plan`` (``plan_launch``'s unless given); returns max |diff|."""
    import torch
    from amyloid_yolo_tpu_torch.kernels.conv_block import (
        K2, conv3x3_path, fused_residual_block, fused_residual_block_plain)
    plan, stats, _ = checked_plan(b, h, c, K2, sms, plan)
    args = k2_stage_inputs(b, h, c, dev, gen)
    y, r = fused_residual_block(*args, plan=plan), fused_residual_block_plain(*args)
    torch.cuda.synchronize()
    err = (y.float() - r.float()).abs().max().item()
    print(f"K2 fused_residual_block B={b} {h}x{h}x{c}: max|diff| {err} "
          f"(tolerance: rtol {K2_RTOL} atol {K2_ATOL}; max|plain| "
          f"{r.float().abs().max().item()}); plan {tuple(plan)}, 3x3 {conv3x3_path(c)}, "
          f"partial m64 blocks {partial_m64(b, h, c, plan)}, shared memory {stats.smem} B "
          "(Python = C)")
    torch.testing.assert_close(y.float(), r.float(), rtol=K2_RTOL, atol=K2_ATOL)
    return err


def epilogue_rows(spec, dev, gen, card: str, batch: int = EPILOGUE_BATCH) -> list:
    """The library convs' epilogue at each conv output outside the residual
    units, at ``batch`` and 416 in bf16 channels_last: the kernel on a copy
    of a random map, bit for bit against the plain version (NaN by mask),
    then the kernel's time (in place, over and over), the plain version's
    and the bound (the map read and written once at 3.35 TB/s)."""
    import torch
    from amyloid_yolo_tpu_torch.graphspec import ConvSpec
    from amyloid_yolo_tpu_torch.kernels.bias_leaky import bias_leaky, bias_leaky_plain
    from amyloid_yolo_tpu_torch.models.darknet import fusible_residual_blocks
    from amyloid_yolo_tpu_torch.parallel.spatial import layer_strides
    inside = {j for i in fusible_residual_blocks(spec) for j in (i, i + 1)}
    rows = []
    for i, (layer, stride) in enumerate(zip(spec.layers, layer_strides(spec))):
        if not isinstance(layer, ConvSpec) or i in inside:
            continue
        side = 416 // stride
        c, leaky = layer.out_ch, layer.activation == "leaky"
        x = torch.randn(batch, c, side, side, device=dev, generator=gen).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        b = torch.randn(c, device=dev, generator=gen).to(torch.bfloat16)
        want = bias_leaky_plain(x, b, leaky)
        got = bias_leaky(x.clone(memory_format=torch.channels_last), b, leaky)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        exact = (torch.equal(nan, torch.isnan(got))
                 and torch.equal(want[~nan].view(torch.int16), got[~nan].view(torch.int16)))
        del want, got
        ms = cuda_ms(lambda: bias_leaky(x, b, leaky))
        plain_ms = cuda_ms(lambda: bias_leaky_plain(x, b, leaky))
        bound = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
        rows.append({"conv": i, "shape": f"{batch}x{c}x{side}x{side}", "leaky": leaky,
                     "bit_exact": exact, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound})
        print(f"epilogue conv {i} B={batch} {c}x{side}x{side} {'leaky' if leaky else 'linear'}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes); bit-exact {exact} [{card}]", flush=True)
        if not exact:
            raise AssertionError(f"the epilogue kernel differs from its plain version at "
                                 f"conv {i}, B={batch}")
        del x
    return rows


def bf16_ulps(got, want):
    """The distance of two bf16 tensors in bf16 steps (the sign-magnitude
    order of their bits)."""
    import torch

    def order(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (order(got) - order(want)).abs()


def mish_rows(dev, gen, card: str, batch: int = MISH_BATCH) -> list:
    """The bias-and-Mish epilogue at each of YOLOv4's 72 Mish conv outputs,
    at ``batch`` and 608 in bf16 channels_last: the kernel on a copy of a
    random map against the plain version, within one bf16 ulp (the share
    of elements that differ at all is recorded), then the kernel's time (in
    place, over and over), the plain version's and the bound (the map read
    and written once at 3.35 TB/s).  At the ten members of the CSP routes
    that the folded forward joins in place (``darknet.route_slices``) the
    kernel also writes into the member's slice of a NaN-filled route map:
    the slice bit for bit the in-place kernel's values, every other channel
    of the map still NaN, and its time beside the in-place form's."""
    import torch
    from amyloid_yolo_tpu_torch.graphspec import ConvSpec, from_cfg
    from amyloid_yolo_tpu_torch.kernels.bias_leaky import bias_mish, bias_mish_plain
    from amyloid_yolo_tpu_torch.models.darknet import route_slices
    from amyloid_yolo_tpu_torch.parallel.spatial import layer_strides
    spec = from_cfg(V4_CFG)
    slots = {m: (spec.out_channels[r], off) for r, offs in route_slices(spec).items()
             for m, off in zip(spec.layers[r].layers, offs)}
    rows = []
    for i, (layer, stride) in enumerate(zip(spec.layers, layer_strides(spec))):
        if not (isinstance(layer, ConvSpec) and layer.activation == "mish"):
            continue
        side, c = 608 // stride, layer.out_ch
        x = (3 * torch.randn(batch, c, side, side, device=dev, generator=gen)).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        b = torch.randn(c, device=dev, generator=gen).to(torch.bfloat16)
        want = bias_mish_plain(x, b)
        got = bias_mish(x.clone(memory_format=torch.channels_last), b)
        torch.cuda.synchronize()
        ulps = bf16_ulps(got, want)
        max_ulps, differ = int(ulps.max()), int((ulps > 0).sum())
        max_abs = (got.float() - want.float()).abs().max().item()
        del want, ulps
        row = {"conv": i, "shape": f"{batch}x{c}x{side}x{side}", "elements": x.numel(),
               "differ": differ, "max_ulps": max_ulps, "max_abs_diff": max_abs}
        if i in slots:
            c_route, off = slots[i]
            m = torch.full((batch, c_route, side, side), float("nan"), dtype=torch.bfloat16,
                           device=dev).contiguous(memory_format=torch.channels_last)
            into = m[:, off:off + c]
            bias_mish(x, b, into)
            torch.cuda.synchronize()
            exact = torch.equal(into.view(torch.int16), got.view(torch.int16))
            untouched = bool(torch.isnan(m[:, :off]).all() and torch.isnan(m[:, off + c:]).all())
            into_ms = cuda_ms(lambda: bias_mish(x, b, into))
            row["into_route"] = {"route_channels": c_route, "offset": off, "bit_exact": exact,
                                 "others_untouched": untouched, "ms": into_ms}
            print(f"Mish epilogue conv {i} into channels {off}..{off + c} of a {c_route}-channel "
                  f"route map: {into_ms:.4f} ms; bit for bit the in-place kernel {exact}, "
                  f"other channels untouched {untouched} [{card}]", flush=True)
            if not (exact and untouched):
                raise AssertionError(f"the Mish epilogue into a route's slice differs from the "
                                     f"in-place kernel or writes outside its slice at conv {i}, "
                                     f"B={batch}")
            del m, into
        del got
        ms = cuda_ms(lambda: bias_mish(x, b))
        plain_ms = cuda_ms(lambda: bias_mish_plain(x, b))
        bound = 2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound)
        rows.append(row)
        print(f"Mish epilogue conv {i} B={batch} {c}x{side}x{side}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes); {differ} of {x.numel()} "
              f"elements differ, at most {max_ulps} bf16 ulp [{card}]", flush=True)
        if max_ulps > 1:
            raise AssertionError(f"the Mish epilogue is {max_ulps} bf16 ulps from its plain "
                                 f"version at conv {i}, B={batch}")
        del x
    return rows


def spp_rows(dev, gen, card: str, batch: int = MISH_BATCH) -> list:
    """YOLOv4's SPP block (``kernels/spp_pool.py``) at each of its blocks'
    inputs at ``batch`` and 608 in bf16 channels_last: the kernel against
    the plain version (its pools and the route's cat) bit for bit, on
    random values and on values that tie ``-0.0`` with ``+0.0`` among
    ``-inf`` and NaN; then the kernel's time, the plain version's and the
    bound (the input read once and the joined map written once at
    3.35 TB/s)."""
    import torch
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    from amyloid_yolo_tpu_torch.kernels.spp_pool import spp_pool, spp_pool_plain
    from amyloid_yolo_tpu_torch.models.darknet import spp_blocks
    from amyloid_yolo_tpu_torch.parallel.spatial import layer_strides
    spec = from_cfg(V4_CFG)
    strides = layer_strides(spec)
    rows = []
    for i, blk in spp_blocks(spec).items():
        side, c = 608 // strides[blk.input], spec.out_channels[blk.input]
        x = (3 * torch.randn(batch, c, side, side, device=dev, generator=gen)).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        u = torch.rand(x.shape, device=dev, generator=gen)
        ties = torch.where(u < 0.3, torch.where(u < 0.15, -0.0, 0.0), -u)
        ties = torch.where(u > 0.995, float("nan"), torch.where(
            (u > 0.5) & (u < 0.52), float("-inf"), ties)).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        exact = all(torch.equal(spp_pool(v, blk.kernels, blk.order).view(torch.int16),
                                spp_pool_plain(v, blk.kernels, blk.order).view(torch.int16))
                    for v in (x, ties))
        del ties, u
        ms = cuda_ms(lambda: spp_pool(x, blk.kernels, blk.order))
        plain_ms = cuda_ms(lambda: spp_pool_plain(x, blk.kernels, blk.order))
        bound = (1 + len(blk.order)) * x.numel() * x.element_size() / PEAK_BYTES * 1e3
        rows.append({"pools": i, "shape": f"{batch}x{c}x{side}x{side}",
                     "kernels": list(blk.kernels), "bit_exact": exact, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound})
        print(f"SPP layers {i}-{blk.route} B={batch} {c}x{side}x{side} pools "
              f"{list(blk.kernels)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound:.4f} ms (bytes); bit-exact {exact} [{card}]", flush=True)
        if not exact:
            raise AssertionError(f"the SPP kernel differs from its plain version at layers "
                                 f"{i}-{blk.route}, B={batch}")
        del x
    return rows


def detector_ms(det, b, dev, gen) -> float:
    """ms per call of ``det`` on b random uint8 1536² tiles already on the
    card: 5 calls after 2, host cost included."""
    import torch
    tiles = torch.randint(0, 256, (b, 1536, 1536, 3), dtype=torch.uint8, device=dev,
                          generator=gen)
    with torch.inference_mode():
        return cuda_ms(lambda: det(tiles), iters=5, warmup=2, hold=False)


def k3_stage_inputs(b, h, c, dev, gen):
    """Random int8 unit at (b, h, h, c) with the reference tool's ranges:
    weights uniform in ±127, weight scales in [1e-3, 2e-2), biases in ±1."""
    import torch
    from amyloid_yolo_tpu_torch.kernels.int8_block import pack_int8_block
    c2 = c // 2
    sx, s1, _ = K3_SCALES

    def ri(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)

    def ru(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, device=dev, generator=gen)

    w1t, ws1, b1, w2t, ws2, b2 = pack_int8_block(
        ri(c2, c, 1, 1), ru(1e-3, 2e-2, c2), ru(-1, 1, c2),
        ri(c, c2, 3, 3), ru(1e-3, 2e-2, c), ru(-1, 1, c))
    return ri(b, h, h, c), (w1t, ws1 * sx, b1, w2t, ws2 * s1, b2)


def libjpeg_present() -> bool:
    """Whether ``g++`` compiles and links a program against libjpeg, which
    is what the port's tile reader needs to build."""
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cxx, "-x", "c++", "-", "-o", os.path.join(tmp, "probe"), "-ljpeg"],
            input="#include <cstdio>\n#include <jpeglib.h>\n"
                  "int main() { jpeg_error_mgr e; return jpeg_std_error(&e) == nullptr; }\n",
            capture_output=True, text=True, timeout=120)
    return proc.returncode == 0


def stain_tile(rng, h: int, w: int):
    """A smooth synthetic stained-tissue tile, uint8 (h, w, 3): dark stain
    blobs over a bright background at quarter resolution, upsampled, plus
    grain, so its JPEG has a real tile's size (0.1-1 MB at 1536²)."""
    import numpy as np
    hq, wq = -(-h // 4), -(-w // 4)
    yy, xx = np.mgrid[0:hq, 0:wq] / float(max(hq, wq))
    img = np.full((hq, wq, 3), 236.0)
    for _ in range(10):
        cy, cx = rng.rand(2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / rng.uniform(0.002, 0.03))
        img -= blob[..., None] * rng.uniform([50, 80, 100], [110, 150, 170])
    img = np.repeat(np.repeat(img, 4, axis=0), 4, axis=1)[:h, :w]
    img += rng.randint(-5, 6, (h, w, 1))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_folder(folder: str, seed: int, n_tiles: int, side: int, border, blank: int):
    """The phase-10 folder; returns (readable paths, border path, blank
    paths, corrupt path)."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    tiles = [os.path.join(folder, f"t{i:03d}.jpg") for i in range(n_tiles)]
    for p in tiles:
        Image.fromarray(stain_tile(rng, side, side)).save(p, quality=90)
    border_p = os.path.join(folder, "u_border.jpg")
    Image.fromarray(stain_tile(rng, *border)).save(border_p, quality=90)
    blanks = [os.path.join(folder, f"v_blank{i}.jpg") for i in range(blank)]
    for p in blanks:
        img = np.full((side, side, 3), 243, np.uint8) + rng.randint(0, 3, (side, side, 1)).astype(np.uint8)
        Image.fromarray(img).save(p, quality=90)
    corrupt = os.path.join(folder, "c_bad.jpg")
    with open(corrupt, "wb") as fh:
        fh.write(b"not a jpeg")
    return sorted(tiles + [border_p] + blanks), border_p, blanks, corrupt


def random_classifier_params(seed: int):
    """The CAA classifier's weights in the reference package's layout
    (numpy): He-normal HWIO convs, random BN statistics, a linear layer
    N(0, 0.01²)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    params, in_ch = {}, 3
    for i, w in enumerate((16, 32, 48, 64, 80, 96)):
        params[f"conv_{i}"] = {
            "w": (rng.randn(3, 3, in_ch, w) * np.sqrt(2.0 / (9 * in_ch))).astype(np.float32),
            "b": (0.05 * rng.randn(w)).astype(np.float32)}
        params[f"bn_{i}"] = {"scale": (1 + 0.1 * rng.randn(w)).astype(np.float32),
                             "bias": (0.1 * rng.randn(w)).astype(np.float32),
                             "mean": (0.05 * rng.randn(w)).astype(np.float32),
                             "var": (0.5 + rng.rand(w)).astype(np.float32)}
        in_ch = w
    params["fc"] = {"w": (0.01 * rng.randn(96 * 16, 3)).astype(np.float32),
                    "b": np.zeros(3, np.float32)}
    return params


def recompute_folder(det, folder: str, batch_size: int, caa):
    """``detect_folder(merge_boxes=True, caa_filter=caa.filter_path)``
    spelled out, one stage after another: the reader, ``Detector.__call__``,
    ``dense_to_ragged``, ``rescale_from_tile_frame``, ``merge_detections``,
    the filter.  Returns (results, batches, host seconds per stage)."""
    from amyloid_yolo_tpu_torch.io.datasets import ImageFolder
    from amyloid_yolo_tpu_torch.ops.boxes import rescale_from_tile_frame
    from amyloid_yolo_tpu_torch.ops.merge import merge_detections
    from amyloid_yolo_tpu_torch.ops.nms import dense_to_ragged
    ds = ImageFolder(folder, tile_size=det.tile_size)
    out, n_batches = {}, 0
    secs = {"waiting for the reader": 0.0, "Detector call + dense_to_ragged": 0.0,
            "rescale + merge": 0.0, "CAA filter (decode + crops + classifier)": 0.0}
    stages = list(secs)
    batches = ds.iter_batches(batch_size)
    while True:
        t0 = time.perf_counter()
        item = next(batches, None)
        t1 = time.perf_counter()
        secs[stages[0]] += t1 - t0
        if item is None:
            break
        paths, batch, n_valid = item
        n_batches += 1
        ragged = dense_to_ragged(*det(batch))
        secs[stages[1]] += time.perf_counter() - t1
        for p, d in list(zip(paths, ragged))[:n_valid]:
            if d is not None:
                t0 = time.perf_counter()
                d = merge_detections(rescale_from_tile_frame(d, det.tile_size,
                                                             ds.orig_shapes[p]))
                t1 = time.perf_counter()
                d = caa.filter_path(p, d)
                secs[stages[2]] += t1 - t0
                secs[stages[3]] += time.perf_counter() - t1
                d = d if len(d) else None
            out[p] = d
    return out, n_batches, secs


def folder_phase(det, spec, params, card: str) -> dict:
    """Phase 10 (see the module docstring); returns its JSON record."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.domain import CAAFilter, _crop
    from amyloid_yolo_tpu_torch.io import native
    from amyloid_yolo_tpu_torch.io.datasets import ImageFolder, load_image_rgb
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.models import classifier

    record = {}
    if libjpeg_present():
        t0 = time.perf_counter()
        if not native.available():
            raise AssertionError("libjpeg is present but the port's tile reader did not build")
        record["decoder"] = "native"
        print(f"decoder: native (amyloid_yolo_tpu_torch/csrc/tile_reader.cc, built and "
              f"loaded in {time.perf_counter() - t0:.2f} s)", flush=True)
    else:
        record["decoder"] = "pil"
        print("decoder: pil (no libjpeg headers or library for g++ on this machine)",
              flush=True)
    cparams = classifier.from_jax_params(random_classifier_params(SEED))
    caa = CAAFilter(cparams)
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        readable, border, blanks, corrupt = write_folder(folder, SEED, **FOLDER)
        sizes = [os.path.getsize(p) for p in readable]
        print(f"folder: {len(readable)} readable tiles + 1 corrupt written in "
              f"{time.perf_counter() - t0:.2f} s; JPEG sizes {min(sizes)}-{max(sizes)} B, "
              f"median {int(np.median(sizes))} B", flush=True)

        # the run, with its launch counts and the reader's report
        log = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(log):
            res = det.detect_folder(folder, batch_size=8, merge_boxes=True,
                                    caa_filter=caa.filter_path)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(log.getvalue().strip())
        print(f"detect_folder B=8 launches: {counts}", flush=True)
        with contextlib.redirect_stdout(io.StringIO()):
            want, n_batches, secs = recompute_folder(det, folder, 8, caa)
        record["recompute_b8_host_s"] = secs
        print(f"recomputation B=8, host seconds by stage (run in turn, the reader "
              f"decoding ahead): {json.dumps({k: round(v, 4) for k, v in secs.items()})} "
              f"[{card}]", flush=True)
        if counts != {"resize_normalize": n_batches, "fused_residual_block": 23 * n_batches,
                      "fused_residual_block_int8": 0}:
            raise AssertionError(f"detect_folder launches {counts} over {n_batches} batches")
        if sorted(res) != readable:
            raise AssertionError(f"result keys {sorted(res)} are not the readable tiles")
        if corrupt in res or not ("Could not read image" in log.getvalue()
                                  and corrupt in log.getvalue()):
            raise AssertionError("the corrupt file was not reported and left out")
        if sorted(want) != sorted(res) or any(
                (want[p] is None) != (res[p] is None)
                or (res[p] is not None and not np.array_equal(res[p], want[p])) for p in res):
            raise AssertionError("detect_folder differs from its explicit recomputation")
        rows = [len(v) for v in res.values() if v is not None]
        n_caa = sum(int((v[:, 6] == 0).sum()) for v in res.values() if v is not None)
        print(f"detect_folder = recomputation, box for box: {len(res)} tiles, "
              f"{sum(rows)} boxes after merge and filter ({n_caa} CAA), "
              f"{sum(v is None for v in res.values())} tiles without boxes", flush=True)
        b = res[border]
        if b is not None:
            h, w = FOLDER["border"]
            pad = (w - h) // 2
            cx, cy = (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2
            if not ((cx >= 0).all() and (cx <= w).all() and (cy >= -pad).all()
                    and (cy <= h + pad).all()):
                raise AssertionError("border boxes are not in the border tile's own pixels")
            print(f"border tile {h}x{w}: {len(b)} boxes, centres x {cx.min():.1f}-"
                  f"{cx.max():.1f}, y {cy.min():.1f}-{cy.max():.1f} (its own pixels; the "
                  f"padded square spans y -{pad}..{h + pad})")

        # the classifier on the card against its CPU float32 run
        img = load_image_rgb(readable[0])
        rng = np.random.RandomState(SEED)
        xy = rng.randint(0, det.tile_size, (8, 2))
        crops = np.stack([_crop(img, np.array([x, y, x + 64, y + 64], np.float32))
                          for x, y in xy])
        p_card = caa.predict_crops(crops)
        p_cpu = CAAFilter(cparams, device="cpu").predict_crops(crops)
        caa_err = float(np.abs(p_card - p_cpu).max())
        print(f"CAA classifier card vs CPU f32 on 8 crops: max|diff| {caa_err} "
              f"(tolerance {CAA_TOL}); p(CAA) {np.round(p_cpu[:, 2], 4).tolist()}", flush=True)
        if caa_err > CAA_TOL:
            raise AssertionError("the CAA classifier on the card disagrees with the CPU")

        skipped = det.detect_folder(folder, batch_size=8, background_skip=True)
        if sorted(skipped) != readable or any(skipped[p] is not None for p in blanks):
            raise AssertionError("background_skip did not return the blank tiles as None")
        print(f"background_skip: {[os.path.basename(p) for p in blanks]} -> None", flush=True)

        d8 = Detector(spec, params, conf_thres=0.3, precision="int8_full")
        reset_launch_counts()
        res8 = d8.detect_folder(folder, batch_size=8)
        torch.cuda.synchronize()
        counts8 = launch_counts()
        with tempfile.TemporaryDirectory() as tmp:
            with open(d8.save_calibration(os.path.join(tmp, "int8_full.json"))) as fh:
                meta = json.load(fh)["meta"]
        print(f"int8_full detect_folder: launches {counts8}, {len(res8)} tiles; calibration "
              f"meta {meta}", flush=True)
        if meta["n_tiles"] != len(readable) or meta["source"] != "folder" or sorted(res8) != readable:
            raise AssertionError("int8_full did not calibrate on the folder's readable tiles")
        if counts8["fused_residual_block"] or counts8["fused_residual_block_int8"]:
            raise AssertionError(f"int8_full launched K2 or K3: {counts8}")
        del d8

        # timings: from the JPEGs on disk to the filtered boxes
        n = len(readable)
        record.update({"tiles": n, "batches_b8": n_batches, "caa_err": caa_err,
                       "launches_b8": counts})
        for bs in DETECTOR_BATCHES:
            reader_s = []
            for _ in range(2):
                with contextlib.redirect_stdout(io.StringIO()):
                    t0 = time.perf_counter()
                    batches = list(ImageFolder(folder, tile_size=det.tile_size).iter_batches(bs))
                    reader_s.append(time.perf_counter() - t0)
            folder_s = []
            for _ in range(2):
                with contextlib.redirect_stdout(io.StringIO()):
                    t0 = time.perf_counter()
                    det.detect_folder(folder, batch_size=bs, merge_boxes=True,
                                      caa_filter=caa.filter_path)
                    torch.cuda.synchronize()
                    folder_s.append(time.perf_counter() - t0)
            on_card = [torch.from_numpy(b).cuda() for _, b, _ in batches]
            with torch.inference_mode():
                call_ms = sum(cuda_ms(lambda: det(t), iters=5, warmup=2, hold=False)
                              for t in on_card)
            best = min(folder_s)
            record[f"b{bs}"] = {
                "folder_s": folder_s, "folder_tiles_per_s": [n / t for t in folder_s],
                "reader_s": reader_s, "reader_tiles_per_s": [n / t for t in reader_s],
                "call_ms_on_card": call_ms, "call_tiles_per_s": n / call_ms * 1e3,
                "host_share": 1.0 - call_ms / 1e3 / best}
            print(f"detect_folder B={bs} ({record['decoder']} decoder, merge + CAA filter, "
                  f"{n} tiles, {len(on_card)} batches): {[round(t, 3) for t in folder_s]} s = "
                  f"{[round(n / t, 1) for t in folder_s]} tiles/s; reader alone "
                  f"{[round(n / t, 1) for t in reader_s]} tiles/s; Detector.__call__ on the "
                  f"same tiles on the card {call_ms:.2f} ms = {n / call_ms * 1e3:.1f} tiles/s; "
                  f"host share {record[f'b{bs}']['host_share']:.4f} [{card}]", flush=True)
            del on_card, batches

        # the trace: one batch of the same run in the profiler's dropped
        # warm-up step, then the whole folder, taken again until complete
        walls = []

        def take(warm):
            with warmed_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with contextlib.redirect_stdout(io.StringIO()):
                    det.detect_folder(warm, batch_size=8, merge_boxes=True,
                                      caa_filter=caa.filter_path)
                    torch.cuda.synchronize()
                    prof.step()
                    t0 = time.perf_counter()
                    det.detect_folder(folder, batch_size=8, merge_boxes=True,
                                      caa_filter=caa.filter_path)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
            return prof

        with tempfile.TemporaryDirectory() as warm:
            for p in readable[:8]:
                shutil.copy(p, warm)
            prof, tries = checked_trace(lambda: take(warm),
                                        unrecorded=TRACE_UNRECORDED_PER_CALL * n_batches)
        wall_ms = walls[-1]
        # the warmed profile draws its step as a range on the device's
        # timeline too: not a kernel, left out
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
        busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        groups = {}
        for e in events:
            g = groups.setdefault("copies and fills" if "Mem" in e.name[:6]
                                  else kernel_group(e.name), [0, 0.0])
            g[0] += 1
            g[1] += e.time_range.elapsed_us() / 1e3
        record["traced_b8"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                               "idle_share": 1.0 - busy_ms / wall_ms,
                               "device_launches": len(events), "trace_tries": tries,
                               "by_group": {k: {"launches": c, "ms": ms}
                                            for k, (c, ms) in sorted(groups.items())}}
        print(f"detect_folder B=8 traced (warmed; [records, launch calls] of each try "
              f"{tries}): wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} ms in {len(events)} "
              f"launches, idle share {1.0 - busy_ms / wall_ms:.4f}; by group "
              f"{json.dumps(record['traced_b8']['by_group'])} [{card}]", flush=True)
    return record


# --------------------------------------------------------------------------
# phase 11: the training path
# --------------------------------------------------------------------------

TRAIN_DATA = dict(n_train=48, n_valid=16, side=1536)
TRAIN_SIZE = 416
# (a) card vs CPU, one float32 micro-step (TF32 off on the card): loss and new
# BN running statistics to a relative 1e-4.  Gradients: at this random init
# the backward through 72 batch-normalised layers is ill-conditioned (each
# layer subtracts its batch mean of the gradient, a cancellation), so the
# relative error of a tensor's gradient grows from ~1e-6 at the heads to
# percents at the stem, under ANY reordering of the same float32 sums: on
# the CPU, swapping the batch's two images moved them by a median 1.9% and
# at most 3.4% on this phase's inputs.  So the phase measures that
# noise in the run (the CPU step again with the batch swapped) and bounds
# the card: the median and the largest ||g_card - g_cpu|| / ||g_cpu|| over
# the tensors each within STEP_GRAD_NOISE_FACTOR x the swap's median and
# largest.  The parity tests hold the same gradients against JAX to 1e-4 on
# the mini spec, where the chain is short.
STEP_RTOL = 1e-4
STEP_GRAD_NOISE_FACTOR = 2.0
OVERFIT_APPLIES = 30
# (d) trains at lr 1e-4.  The validation mAP is scored at conf 0.5; at the
# default lr 1e-3 the no-object term (weight 100) drives every objectness of
# the random-init model under 0.5 within 3-6 applies, and evaluate() then
# finds no detection and returns None, as the reference package's does
# ("mAP not measured"): a 224^2 run of this Trainer on the CPU measured
# mAP after epoch 0 and none after epoch 1.  At 1e-4 both epochs are scored.
TRAIN_LR = 1e-4
STEP_ITERS, STEP_WARMUP = 10, 3


def write_train_set(root: str, seed: int, n_train: int, n_valid: int, side: int) -> str:
    """A YOLO training set that PIL writes under ``root``: synthetic stain
    tiles with 1-4 labels each, ``train.txt``, ``valid.txt``,
    ``classes.names`` and ``custom.data``; returns the ``.data`` path."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    paths = []
    for i in range(n_train + n_valid):
        p = os.path.join(root, "images", f"tile{i:03d}.jpg")
        Image.fromarray(stain_tile(rng, side, side)).save(p, quality=90)
        rows = [f"{rng.randint(0, 2)} {rng.uniform(0.1, 0.9):.5f} {rng.uniform(0.1, 0.9):.5f} "
                f"{rng.uniform(0.02, 0.1):.5f} {rng.uniform(0.02, 0.1):.5f}"
                for _ in range(rng.randint(1, 5))]
        with open(os.path.join(root, "labels", f"tile{i:03d}.txt"), "w") as fh:
            fh.write("\n".join(rows) + "\n")
        paths.append(p)
    for name, part in (("train.txt", paths[:n_train]), ("valid.txt", paths[n_train:])):
        with open(os.path.join(root, name), "w") as fh:
            fh.write("\n".join(part) + "\n")
    with open(os.path.join(root, "classes.names"), "w") as fh:
        fh.write("CAA\nCored\n")
    data = os.path.join(root, "custom.data")
    with open(data, "w") as fh:
        fh.write(f"classes=2\ntrain={root}/train.txt\nvalid={root}/valid.txt\n"
                 f"names={root}/classes.names\n")
    return data


def train_batch(rng, b: int, side: int, per_image: int = 4):
    """Fixed inputs of one micro-batch: b stain tiles (uint8 NHWC) and
    ``per_image`` labels each, padded as ``ListDataset.collate`` pads them."""
    import numpy as np
    imgs = np.stack([stain_tile(rng, side, side) for _ in range(b)])
    n = b * per_image
    t = np.zeros((n, 6), np.float32)
    t[:, 0] = np.repeat(np.arange(b), per_image)
    t[:, 1] = rng.randint(0, 2, n)
    t[:, 2:4] = rng.uniform(0.1, 0.9, (n, 2))
    t[:, 4:6] = rng.uniform(0.02, 0.1, (n, 2))
    return imgs, t, np.ones(n, bool)


def step_vs_cpu(spec, params, dev, rng, size: int, side: int) -> dict:
    """(a): one float32 micro-step at B=2 (augment off) on the card and on
    the CPU from the same weights and inputs, and on the CPU once more with
    the two images swapped (the same sums in another order)."""
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.parallel.steps import make_grad_step
    grad_step = make_grad_step(spec)
    imgs, t, m = train_batch(rng, 2, side)
    card = grad_step({k: v.to(dev) for k, v in params.items()}, imgs, t, m, size)
    host_params = {k: v.cpu() for k, v in params.items()}
    host = grad_step(host_params, imgs, t, m, size)
    t_swapped = t.copy()
    t_swapped[:, 0] = 1 - t_swapped[:, 0]
    swapped = grad_step(host_params, imgs[::-1].copy(), t_swapped, m, size)

    def rel(grads):
        return {k: float(torch.linalg.vector_norm(g.cpu() - host[1][k])
                         / torch.linalg.vector_norm(host[1][k]).clamp(min=1e-30))
                for k, g in grads.items()}

    grad_rel, noise = rel(card[1]), rel(swapped[1])
    loss_rel = abs(float(card[0]) - float(host[0])) / abs(float(host[0]))
    stat_rel = {k: float((v.cpu() - host[2][k]).abs().max() / host[2][k].abs().max())
                for k, v in card[2].items()}
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_s = max(stat_rel, key=stat_rel.get)
    med, noise_med = float(np.median(list(grad_rel.values()))), float(np.median(list(noise.values())))
    noise_max = max(noise.values())
    rec = {"loss_card": float(card[0]), "loss_cpu": float(host[0]), "loss_rel": loss_rel,
           "grad_rel_worst": [worst_g, grad_rel[worst_g]], "grad_rel_median": med,
           "swap_noise_median": noise_med, "swap_noise_max": noise_max,
           "grad_rel_heads": {k: v for k, v in grad_rel.items() if ".conv_" in k
                              and k.endswith(".bias")},
           "stat_rel_worst": [worst_s, stat_rel[worst_s]], "tensors": len(grad_rel)}
    print(f"train step card vs CPU (f32, B=2, {size}, TF32 off on the card): loss "
          f"{rec['loss_card']} vs {rec['loss_cpu']} (rel {loss_rel:.3g}, tolerance {STEP_RTOL}); "
          f"gradients of {len(grad_rel)} tensors, ||card-cpu||/||cpu|| median {med:.3g}, worst "
          f"{grad_rel[worst_g]:.3g} ({worst_g}); the CPU with the batch swapped: median "
          f"{noise_med:.3g}, worst {noise_max:.3g} (tolerance {STEP_GRAD_NOISE_FACTOR}x each); "
          f"head-conv biases {json.dumps({k: round(v, 9) for k, v in rec['grad_rel_heads'].items()})}; "
          f"new BN stats worst rel {stat_rel[worst_s]:.3g} ({worst_s}, tolerance {STEP_RTOL})",
          flush=True)
    if (loss_rel > STEP_RTOL or stat_rel[worst_s] > STEP_RTOL
            or med > STEP_GRAD_NOISE_FACTOR * noise_med
            or grad_rel[worst_g] > STEP_GRAD_NOISE_FACTOR * noise_max):
        raise AssertionError("the train step on the card disagrees with the CPU")
    return rec


def overfit(spec, params, dev, rng, size: int, side: int) -> dict:
    """(c): OVERFIT_APPLIES bf16 applies on one fixed augmented batch of 8
    (the augmentation generator re-seeded before each step, so every step
    sees the same draws)."""
    import torch
    from amyloid_yolo_tpu_torch.parallel import steps
    opt = steps.make_optimizer()
    state = steps.init_train_state(params, opt, device=dev)
    step = steps.make_train_step(spec, opt, augment=True, compute_dtype=torch.bfloat16)
    imgs, t, m = (torch.as_tensor(a).to(dev) for a in train_batch(rng, 8, side))
    gen = torch.Generator(device=dev)
    losses = []
    for _ in range(OVERFIT_APPLIES):
        gen.manual_seed(SEED)
        state, metrics = step(state, imgs, t, m, gen, size)
        losses.append(metrics["loss"])
    losses = torch.stack(losses).cpu().tolist()
    print(f"overfit, {OVERFIT_APPLIES} bf16 applies on one augmented batch of 8 at {size}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; every loss {[round(l, 3) for l in losses]}",
          flush=True)
    if not all(math.isfinite(l) for l in losses) or not losses[-1] < 0.5 * losses[0]:
        raise AssertionError("the overfit loss did not fall below half its first value")
    return {"first": losses[0], "last": losses[-1], "losses": losses}


def trainer_run(spec, data: str, root: str, dev, size: int) -> dict:
    """(d): the Trainer for two epochs of 6 micro-batches of 8 (3 applies
    each), then its last checkpoint in a fresh Trainer."""
    import torch
    from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer
    cfg = TrainConfig(data_config=data, epochs=2, batch_size=8, gradient_accumulations=2,
                      img_size=size, multiscale=True, augment=True, max_batches_per_epoch=6,
                      learning_rate=TRAIN_LR, checkpoint_dir=os.path.join(root, "ckpts"),
                      logdir=os.path.join(root, "logs"))
    tr = Trainer(cfg, spec=spec, device=dev)
    watch = [k for k in tr.state.params if k.endswith(".weight")][:1] + [
        k for k in tr.state.params if k.endswith(".bias")][-1:]
    prev = {k: tr.state.params[k].detach().clone() for k in watch}
    rows = []

    def on_step(epoch, bi, metrics):
        moved = any(not torch.equal(tr.state.params[k], prev[k]) for k in watch)
        rows.append({"epoch": epoch, "batch": bi, "loss": metrics["loss"],
                     "applied": metrics["applied"], "moved": moved,
                     "grid": int(metrics["head0/grid_size"])})
        for k in watch:
            prev[k].copy_(tr.state.params[k].detach())

    t0 = time.perf_counter()
    tr.train(callback=on_step)
    wall = time.perf_counter() - t0
    losses = torch.stack([r["loss"] for r in rows]).cpu().tolist()
    with open(tr.logger.path) as fh:
        events = [json.loads(line) for line in fh]
    maps = {e["step"]: e["validation/mAP"] for e in events if "validation/mAP" in e}
    ckpts = sorted(os.listdir(cfg.checkpoint_dir))
    rec = {"wall_s": wall, "epoch_walls": tr.epoch_walls, "losses": losses,
           "applied": [r["applied"] for r in rows], "head0_grids": [r["grid"] for r in rows],
           "step": tr.state.step, "seen": tr.state.seen, "val_mAP": maps,
           "checkpoints": ckpts, "best": tr.best}
    print(f"Trainer, 2 epochs x 6 micro-batches of 8 (lr {TRAIN_LR}): wall {wall:.2f} s, "
          f"epochs {json.dumps(tr.epoch_walls)}; step {tr.state.step} seen {tr.state.seen}; "
          f"head-0 grids {rec['head0_grids']}; applied {rec['applied']}; losses "
          f"{[round(l, 3) for l in losses]}; validation mAP {maps}; checkpoints {ckpts}",
          flush=True)
    if (tr.state.step, tr.state.seen) != (12, 96):
        raise AssertionError(f"step {tr.state.step} seen {tr.state.seen}, want 12 and 96")
    if len(losses) != 12 or not all(math.isfinite(l) for l in losses):
        raise AssertionError("a Trainer loss is not finite")
    if any(r["moved"] != bool(r["applied"]) for r in rows):
        raise AssertionError("parameters moved on a micro-batch that did not apply, or not "
                             "on one that did")
    if rec["applied"] != [1.0, 0.0] * 6 or rec["head0_grids"][9] == rec["head0_grids"][8]:
        raise AssertionError("the apply schedule or the multiscale change at batch 10 is off")
    if sorted(maps) != [0, 1] or not all(0.0 <= v <= 1.0 for v in maps.values()):
        raise AssertionError(f"validation mAP not logged finite in [0, 1] for both epochs: {maps}")
    if ckpts != ["yolov3_ckpt_0.pt", "yolov3_ckpt_1.pt"]:
        raise AssertionError(f"checkpoints {ckpts}, want one per epoch")
    out = tr.evaluate()
    tr2 = Trainer(cfg, spec=spec, device=dev)
    tr2.load_checkpoint(tr.checkpoint_path(1))
    out2 = tr2.evaluate()
    if out is None or out2 is None or any(
            not (a.shape == b.shape and (a == b).all()) for a, b in zip(out, out2)):
        raise AssertionError("the reloaded checkpoint evaluates differently")
    rec["reload_ap"] = out2[2].tolist()
    print(f"reloaded checkpoint {tr.checkpoint_path(1)}: AP {out2[2].tolist()} = the live "
          f"model's", flush=True)
    return rec


def step_times(spec, params, dev, rng, size: int, side: int, dtype, s2d_stem: bool = False,
               bn_form: str = "reduce") -> dict:
    """(e): ms per B=8 micro-step (accumulation 2, augment on, inputs on the
    card) between CUDA events, 3 warm-up steps then 10 timed one by one;
    ``s2d_stem`` and the BN form as phase 16 (d) sets them; and the step's
    profile (:func:`profile_train_step`)."""
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.models import darknet
    from amyloid_yolo_tpu_torch.parallel import steps
    opt = steps.make_optimizer()
    astate = steps.init_accum_state(steps.init_train_state(params, opt, device=dev))
    step = steps.make_accum_train_step(spec, opt, 2, augment=True, compute_dtype=dtype,
                                       s2d_stem=s2d_stem)
    batch = [torch.as_tensor(a).to(dev) for a in train_batch(rng, 8, side)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    form, darknet.BN_FORM = darknet.BN_FORM, bn_form
    try:
        for _ in range(STEP_WARMUP):
            step(astate, *batch, gen, size)
        torch.cuda.synchronize()
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(STEP_ITERS)]
        host_ms = []
        for a, b in marks:
            t0 = time.perf_counter()
            a.record()
            step(astate, *batch, gen, size)
            b.record()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in marks]
        torch.cuda.reset_peak_memory_stats()
        step(astate, *batch, gen, size)
        torch.cuda.synchronize()
        prof = profile_train_step(step, astate, batch, gen, size)
    finally:
        darknet.BN_FORM = form
    return {"ms": ms, "median_ms": float(np.median(ms)), "min_ms": min(ms), "max_ms": max(ms),
            "host_enqueue_ms": host_ms, "host_enqueue_median_ms": float(np.median(host_ms)),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "profile": prof}


CONV_MARKS = ("fprop", "dgrad", "wgrad", "implicit", "xmma", "cutlass", "gemm", "conv",
              "cudnn", "winograd", "fft")


def _train_top(name: str) -> bool:
    """A micro-step's own range: ``train/targets`` lies inside ``train/loss``."""
    return name.startswith("train/") and name != "train/targets"


def _train_group(scope: str, name: str) -> str:
    conv = any(s in name.lower() for s in CONV_MARKS)
    if scope == "train/forward":
        return "conv forward" if conv else "BN and elementwise (forward)"
    if scope == "train/loss":
        return "targets and loss"
    if scope == "train/augment":
        return "augment (resize + policy)"
    if scope == "train/optimizer":
        return "optimizer (Adam, BN stats)"
    # the backward runs on autograd's device thread, outside every range
    if "dgrad" in name.lower():
        return "conv backward (dgrad)"
    if "wgrad" in name.lower():
        return "conv backward (wgrad)"
    return "conv backward (other)" if conv else "BN and elementwise (backward)"


def profile_train_step(step, astate, batch, gen, size: int, calls: int = 2) -> dict:
    """Device time by group over ``calls`` micro-steps (as many applies as
    steps without), from a ``torch.profiler`` trace after one warm-up step
    whose events are dropped: kernels launched inside the step's
    ``train/*`` ranges go to that part, the rest (the backward) by kernel
    name.  The trace must keep a device record for each launch call of the
    host but ``TRACE_UNRECORDED_PER_CALL`` a step
    (:func:`~trace_summary_torch.checked_trace`; each try's counts in
    ``trace_tries``)."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity

    def take():
        with warmed_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(astate, *batch, gen, size)
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                step(astate, *batch, gen, size)
            torch.cuda.synchronize()
        return prof

    prof, tries = checked_trace(take, unrecorded=TRACE_UNRECORDED_PER_CALL * calls)
    events = prof.events()
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    # the profiler also draws each record_function range on the device's
    # timeline (its span, not a kernel): kept apart from the kernels
    spans = collections.defaultdict(float)
    for e in on_device:
        if e.is_user_annotation:
            spans[e.name] += e.time_range.elapsed_us() / calls / 1e3
    device = [e for e in on_device if not e.is_user_annotation]
    if not device:
        return {"device_busy_ms": "not measured"}
    left = collections.Counter()
    for e in device:
        left[e.name] += e.time_range.elapsed_us()
    groups = collections.defaultdict(lambda: [0, 0.0])

    def under(e):
        yield from e.kernels
        for c in e.cpu_children:
            yield from under(c)

    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and _train_top(e.name):
            for k in under(e):
                g = groups[_train_group(e.name, k.name)]
                g[0] += 1
                g[1] += k.duration
                left[k.name] -= k.duration
    counts = collections.Counter(e.name for e in device)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and _train_top(e.name):
            for k in under(e):
                counts[k.name] -= 1
    for name, us in left.items():
        if counts[name] > 0 or us > 1e-3:
            g = groups[_train_group("", name)]
            g[0] += max(counts[name], 0)
            g[1] += max(us, 0.0)
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    span_us = max(e.time_range.end for e in device) - min(e.time_range.start for e in device)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in device:
        by_name[e.name[:90]][0] += 1
        by_name[e.name[:90]][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_busy_ms": busy_us / calls / 1e3, "idle_share_traced": 1 - busy_us / span_us,
            "launches_per_step": len(device) / calls,
            "launch_calls_per_step": tries[-1][1] / calls, "trace_tries": tries,
            "by_group": {k: {"launches": c / calls, "ms": us / calls / 1e3}
                         for k, (c, us) in sorted(groups.items(), key=lambda kv: -kv[1][1])},
            "top_kernels": {k: {"launches": c / calls, "ms": us / calls / 1e3}
                            for k, (c, us) in top},
            "range_spans_ms": dict(spans)}


def traced_epoch(spec, data: str, root: str, dev, size: int) -> dict:
    """(e): one Trainer epoch (6 micro-batches, evaluation, checkpoint)
    under ``torch.profiler``, after a warm-up step whose events are dropped:
    its wall time (``train()`` returns after joining the checkpoint's
    write), the device's busy time and the idle share.  The trace must keep
    a device record for each launch call of the host but
    ``TRACE_UNRECORDED_PER_CALL`` a micro-step; each try is a new
    ``Trainer`` from the same seed (``trace_tries``: each try's counts)."""
    import torch
    from torch.profiler import ProfilerActivity
    from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer
    cfg = TrainConfig(data_config=data, epochs=1, batch_size=8, gradient_accumulations=2,
                      img_size=size, multiscale=True, augment=True, max_batches_per_epoch=6,
                      learning_rate=TRAIN_LR, checkpoint_dir=os.path.join(root, "ckpts_traced"),
                      logdir=os.path.join(root, "logs_traced"))
    runs = []

    def take():
        tr = Trainer(cfg, spec=spec, device=dev)
        with warmed_profile([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm_up_kernels(dev)
            prof.step()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                tr.train()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, tr.epoch_walls))
        return prof

    prof, tries = checked_trace(take, unrecorded=TRACE_UNRECORDED_PER_CALL
                                * cfg.max_batches_per_epoch)
    wall, epoch_walls = runs[-1]
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e6
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "launches": len(device), "trace_tries": tries, "epoch_walls": epoch_walls}


def training_phase(spec, params, card: str, dev, size: int = TRAIN_SIZE,
                   data_kw=None) -> dict:
    """Phase 11 (see the module docstring); returns its JSON record."""
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.io import native
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    data_kw = dict(TRAIN_DATA, **(data_kw or {}))
    side = data_kw["side"]
    rng = np.random.RandomState(SEED)
    record = {"decoder": "native" if native.available() else "pil"}
    reset_launch_counts()
    record["step_vs_cpu"] = step_vs_cpu(spec, params, dev, rng, size, side)
    record["overfit"] = overfit(spec, params, dev, rng, size, side)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        data = write_train_set(root, SEED, **data_kw)
        print(f"training set: {data_kw['n_train']} + {data_kw['n_valid']} stain tiles of "
              f"{side}^2 written in {time.perf_counter() - t0:.2f} s; decoder: "
              f"{record['decoder']}", flush=True)
        record["trainer"] = trainer_run(spec, data, root, dev, size)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            rec = step_times(spec, params, dev, rng, size, side, dtype)
            record[f"step_{name}"] = rec
            print(f"train micro-step B=8 {size} {name} (accumulation 2, augment on, inputs on "
                  f"the card): median {rec['median_ms']:.3f} ms, min {rec['min_ms']:.3f}, max "
                  f"{rec['max_ms']:.3f} over {STEP_ITERS}; the host's enqueue, median "
                  f"{rec['host_enqueue_median_ms']:.3f} ms a step; peak memory "
                  f"{rec['peak_mem_gb']:.2f} GB; profile {json.dumps(rec['profile'])} [{card}]",
                  flush=True)
        ep = traced_epoch(spec, data, root, dev, size)
        record["traced_epoch"] = ep
        steps_ms = 6 * record["step_f32"]["median_ms"]
        train_s = sum(w["train_s"] for w in record["trainer"]["epoch_walls"]) / 2
        print(f"Trainer epoch (f32, 6 micro-batches of 8, {record['decoder']} decoder): train "
              f"loop {train_s:.3f} s per epoch against 6 x the f32 micro-step = "
              f"{steps_ms / 1e3:.3f} s (host share {1 - steps_ms / 1e3 / train_s:.3f}); traced "
              f"epoch (train + evaluation + checkpoint) wall {ep['wall_s']:.3f} s, device busy "
              f"{ep['device_busy_s']:.3f} s in {ep['launches']} launches, idle share "
              f"{ep['idle_share']:.4f} ([records, launch calls] of each try "
              f"{ep['trace_tries']}) [{card}]", flush=True)
        record["host_share_train_loop"] = 1 - steps_ms / 1e3 / train_s
    counts = launch_counts()
    print(f"training phase launches of K1/K2/K3: {counts}", flush=True)
    if any(counts.values()):
        raise AssertionError(f"the training path launched an inference kernel: {counts}")
    record["launches"] = counts
    return record


# --------------------------------------------------------------------------
# phase 12: the serving path and the CLI
# --------------------------------------------------------------------------

SERVE = dict(batch=16, max_wait_ms=5.0, conf=0.3)  # the serve CLI's defaults, conf 0.3
SERVE_TOL = dict(box=0.01, score=1e-4)            # served answer vs its recomputation
SERVE_CLIENTS = 8                                 # (c) correctness
LOAD_CLIENTS = 16                                 # (d) closed loop, in a process of its own
LOAD_SECONDS = {"raw": 10.0, "jpeg": 5.0, "traced": 5.0}
TRACE_WINDOW = (1.0, 3.0)  # (d) the trace: after 1 s of the traced load, for 3 s
SWEEP_TREE = dict(wsis=4, rows=2)  # (g) phase 10's 37 tiles in rows of 37: 296 tiles
# (e) overload: the clients send their bodies after HEADERS_WAIT_S, and the
# device is held past that, so the queue fills while the first batch waits
HEADERS_WAIT_S = 2.0
BURST = dict(requests=48, max_queue=16, hold_s=HEADERS_WAIT_S + 1.0)
HTTP_TIMEOUT = 120


def _http(port, method, path, body=None, headers=None):
    """(status, headers, JSON answer) of one request; HTTP errors are
    answers too."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _post_headers_first(port, body: bytes, headers: dict):
    """POST that sends its headers, waits up to ``HEADERS_WAIT_S`` for an
    answer, and only then its body.  The server sheds a request on its
    headers when the queue is already full (503, connection closed, body
    unread); a client still sending the body then meets a reset instead of
    the 503.  Returns (status, headers, JSON answer)."""
    import http.client
    import select
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
    try:
        conn.putrequest("POST", "/v1/detect")
        if "Content-Length" not in headers:
            conn.putheader("Content-Length", str(len(body)))
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        if not select.select([conn.sock], [], [], HEADERS_WAIT_S)[0]:
            conn.send(body)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def hold_device(dev, seconds: float) -> None:
    """Queue ``seconds`` of sleep on the card's stream: the next dispatch
    waits behind it, as behind another tenant's work."""
    import torch
    torch.cuda._sleep(int(seconds * 1.98e9))  # cycles at the H100's boost clock


def _encode(img, fmt: str) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _run_clients(n: int, fn, items):
    """``fn(item)`` for every item over ``n`` threads; returns the results
    in item order.  Any exception fails the phase."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(n) as pool:
        return list(pool.map(fn, items))


LOAD_CLIENT = ("import json, sys, chip_smoke; "
               "print(json.dumps(chip_smoke.closed_loop(**json.loads(sys.argv[1]))))")


def closed_loop(port: int, bodies, clients: int, seconds: float) -> dict:
    """``clients`` threads that each POST a body, wait for its answer and
    POST the next, for ``seconds``; ``bodies`` are (file, headers) pairs,
    taken in turn.  Runs in a process of its own (:func:`run_load`), so the
    clients share neither the server's interpreter nor its lock."""
    payload = []
    for path, hdr in bodies:
        with open(path, "rb") as fh:
            payload.append((fh.read(), hdr))
    lat, errs = [], []
    stop_at = time.perf_counter() + seconds

    def client(i):
        k = i
        while time.perf_counter() < stop_at:
            body, hdr = payload[k % len(payload)]
            k += clients
            t = time.perf_counter()
            code, _, ans = _http(port, "POST", "/v1/detect", body, hdr)
            lat.append((time.perf_counter() - t) * 1e3)
            if code != 200:
                errs.append([code, ans])

    t0 = time.perf_counter()
    _run_clients(clients, client, range(clients))
    return {"latencies_ms": lat, "wall_s": time.perf_counter() - t0,
            "errors": errs[:3], "n_errors": len(errs)}


def run_load(port: int, bodies, seconds: float, root: str, during=None):
    """:func:`closed_loop` of ``LOAD_CLIENTS`` in a child process; this
    process calls ``during()`` meanwhile.  Returns (the loop's record,
    ``during()``'s result).  A failed child or any error answer fails the
    phase."""
    args = json.dumps({"port": port, "bodies": bodies, "clients": LOAD_CLIENTS,
                       "seconds": seconds})
    proc = subprocess.Popen([sys.executable, "-c", LOAD_CLIENT, args], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        extra = during() if during is not None else None
        out, err = proc.communicate(timeout=seconds + 120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if proc.returncode != 0:
        raise AssertionError(f"load client exited {proc.returncode}: {err[-2000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    if rec["n_errors"]:
        raise AssertionError(f"load: {rec['n_errors']} errors, first {rec['errors'][0]}")
    return rec, extra


def trace_device(start_s: float, seconds: float) -> dict:
    """After ``start_s``, a ``torch.profiler`` trace (device activity only,
    after a warm-up step whose events are dropped) of ``seconds`` of
    whatever runs on the card: the union of its kernels' and copies'
    intervals over the window's wall time, and device ms and launches by
    group (:func:`kernel_group`; host-to-device copies apart).  The trace
    records the device's activity alone, so it holds no launch calls of the
    host to check it against: its record says ``"trace_complete":
    "unchecked"``."""
    import torch
    from torch.profiler import ProfilerActivity
    from trace_summary_torch import busy_and_span
    time.sleep(start_s)
    with warmed_profile([ProfilerActivity.CUDA]) as prof:
        warm_up_kernels(torch.device("cuda"))
        prof.step()
        t0 = time.perf_counter()
        time.sleep(seconds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    if not events:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured",
                "trace_complete": "unchecked"}
    busy_us, _ = busy_and_span((e.time_range.start, e.time_range.end) for e in events)
    groups = {}
    for e in events:
        name = ("host-to-device copies" if "HtoD" in e.name else "other copies and fills"
                if "Mem" in e.name[:6] else kernel_group(e.name))
        g = groups.setdefault(name, [0, 0.0])
        g[0] += 1
        g[1] += e.time_range.elapsed_us() / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms, "device_launches": len(events),
            "trace_complete": "unchecked",
            "by_group": {k: {"launches": c, "ms": ms} for k, (c, ms) in
                         sorted(groups.items(), key=lambda kv: -kv[1][1])}}


def _rows_of(answer):
    import numpy as np
    return np.array([[d["x1"], d["y1"], d["x2"], d["y2"], d["conf"], d["cls_conf"], d["cls"]]
                     for d in answer["detections"]], np.float64).reshape(-1, 7)


def recompute_served(server, requests):
    """Each request's answer spelled out: the decoded image through
    ``_to_tile_frame``, ``detect_batch_ragged`` at the server's batch (16
    distinct tiles a call, padded by repeating the last as the executor
    does), the rescale to the image's pixels, the merge and the CAA filter,
    run alone in this thread."""
    import numpy as np
    from PIL import Image
    from amyloid_yolo_tpu_torch.ops.boxes import rescale_from_tile_frame
    from amyloid_yolo_tpu_torch.ops.merge import merge_detections
    det, b = server.detector, server.executor.batch_size
    imgs, frames = [], []
    for _, query, body, headers in requests:
        if "X-Image-Shape" in headers:
            h, w = (int(v) for v in headers["X-Image-Shape"].split(","))
            img = np.frombuffer(body, np.uint8).reshape(h, w, 3)
        else:
            img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
        imgs.append(img)
        frames.append(server._to_tile_frame(img))
    dets = []
    for i in range(0, len(frames), b):
        chunk = frames[i:i + b]
        dets += det.detect_batch_ragged(np.stack(chunk + [chunk[-1]] * (b - len(chunk))),
                                        n_valid=len(chunk))[:len(chunk)]
    out = []
    for (_, query, _, _), img, d in zip(requests, imgs, dets):
        merge, caa = "merge=0" not in query, "caa_filter=0" not in query
        if d is not None and img.shape[:2] != (det.tile_size,) * 2:
            d = rescale_from_tile_frame(d, det.tile_size, img.shape[:2])
        if d is not None and merge:
            d = merge_detections(d)
        if d is not None and len(d) and caa:
            d = server.caa_filter(img, d)
        out.append((list(img.shape[:2]), np.zeros((0, 7)) if d is None else d))
    return out


def serve_subprocess(args, backend: str, card_name: str, body: bytes, root: str) -> dict:
    """``python -m amyloid_yolo_tpu_torch.cli serve --port 0 ...`` in its own
    process: its ``serving on`` line, one POST, ``/healthz`` on the card,
    then SIGINT and an exit with code 0 within 30 s."""
    import queue
    import signal
    import threading
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "amyloid_yolo_tpu_torch.cli", "serve",
                             "--port", "0", *args], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(l) for l in proc.stdout], daemon=True)
    reader.start()
    try:
        port, ready, log = None, False, []
        deadline = time.time() + 300
        while not ready:
            try:
                line = lines.get(timeout=5)
            except queue.Empty:
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(f"serve subprocess not ready: {log}") from None
                continue
            log.append(line.rstrip())
            if line.startswith("serving on http://"):
                port = int(line.split()[2].rsplit(":", 1)[1])
            ready = "ready" in line
        start_s = time.perf_counter() - t0
        code, _, answer = _http(port, "POST", "/v1/detect", body)
        hcode, _, health = _http(port, "GET", "/healthz")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=30)
    print(f"serve subprocess: {log[:2]}; ready after {start_s:.2f} s; POST {code}, "
          f"/healthz {hcode} {health}; exit code {rc} after SIGINT", flush=True)
    if code != 200 or hcode != 200 or rc != 0:
        raise AssertionError(f"serve subprocess: POST {code}, /healthz {hcode}, exit {rc}")
    if health["backend"] != backend or health["device_name"] != card_name:
        raise AssertionError(f"serve subprocess /healthz does not show the card: {health}")
    return {"answer": answer, "health": health, "ready_s": start_s}


def write_wsi_tree(root: str, layout) -> list:
    """WSIs in the google layout (``<WSI>/0/<row>/<col>.jpg``), hard links
    to existing tiles: ``layout`` holds (WSI name, tiles, tiles a row).
    Returns the tree's tile paths."""
    paths = []
    for wsi, part, cols in layout:
        for i, src in enumerate(part):
            d = os.path.join(root, wsi, "0", str(i // cols))
            os.makedirs(d, exist_ok=True)
            paths.append(os.path.join(d, f"{i % cols}.jpg"))
            os.link(src, paths[-1])
    return paths


def recompute_sweep(det, caa, root: str, batch_size: int):
    """The sweep with the cross-tile merge, spelled out: ``detect_folder``
    (the per-tile rescale, merge and CAA filter) over each row directory,
    then ``merge_wsi_detections`` per WSI and the counts; returns (per-WSI
    counts, per-tile counts) in the sweep's pickles' shapes."""
    from amyloid_yolo_tpu_torch.io.tiles import iter_wsi_tile_dirs, tile_origin
    from amyloid_yolo_tpu_torch.ops.merge import merge_wsi_detections
    classes = ("CAA", "Cored")
    wsis = sorted(os.listdir(root))
    wsi_counts = {w: {"Cored": 0, "CAA": 0} for w in wsis}
    tile_counts = {w: {} for w in wsis}
    by_wsi = {}
    for wsi, tile_dir in iter_wsi_tile_dirs(root):
        found = det.detect_folder(tile_dir, batch_size=batch_size, merge_boxes=True,
                                  caa_filter=caa.filter_path)
        for p, d in found.items():
            tile_counts[wsi][p] = {"Cored": 0, "CAA": 0}
            if d is not None:
                by_wsi.setdefault(wsi, {})[p] = d
    for wsi, dets in by_wsi.items():
        rows, owners = merge_wsi_detections(
            dets, {p: tile_origin(p, det.tile_size) for p in dets}, tile_size=det.tile_size)
        for row, owner in zip(rows, owners):
            wsi_counts[wsi][classes[int(row[6])]] += 1
            tile_counts[wsi][owner][classes[int(row[6])]] += 1
    return wsi_counts, tile_counts


def serving_phase(spec, params, card: str, dev, size: int = 416,
                  load_seconds=None, folder_kw=None, sweep_tree=None) -> dict:
    """Phase 12 (see the module docstring); returns its JSON record.
    ``size``, ``load_seconds``, ``folder_kw`` and ``sweep_tree`` cut it down
    for a rehearsal
    on the CPU with a mini spec (``torch.cuda.synchronize``, ``cuda_ms`` and
    ``hold_device`` then need host stand-ins)."""
    import pickle
    import threading
    import warnings
    import numpy as np
    import torch
    from PIL import Image
    from amyloid_yolo_tpu_torch.analysis.validation import calculate_plaque_counts_per_wsi
    from amyloid_yolo_tpu_torch.cli.main import main as cli_main
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.domain import CAAFilter
    from amyloid_yolo_tpu_torch.graphspec import emit_cfg
    from amyloid_yolo_tpu_torch.io import native
    from amyloid_yolo_tpu_torch.io.weights import load_pretrained, params_to_torch_state_dict
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.models import classifier
    from amyloid_yolo_tpu_torch.serving import DetectionServer

    load_seconds = dict(LOAD_SECONDS, **(load_seconds or {}))
    folder_kw = dict(FOLDER, **(folder_kw or {}))
    cuda = dev.type == "cuda"
    card_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    root = os.path.dirname(os.path.abspath(__file__))
    dev_args = ["--device", dev.type]
    record = {}
    tmp = tempfile.mkdtemp(prefix="phase12_")
    server = burst_server = None
    try:
        # (a) export the weights through the CLI and read them back
        cfg = os.path.join(tmp, "model.cfg")
        with open(cfg, "w") as fh:
            fh.write(emit_cfg(spec))
        src, pth = os.path.join(tmp, "src.pth"), os.path.join(tmp, "weights.pth")
        torch.save(params_to_torch_state_dict(spec, params), src)
        with contextlib.redirect_stdout(io.StringIO()):
            if cli_main(["export", "--model_def", cfg, "--src", src, "--dst", pth, *dev_args]):
                raise AssertionError("export returned non-zero")
        loaded = load_pretrained(spec, pth)
        if sorted(loaded) != sorted(k for k in params if not k.endswith("num_batches_tracked")) \
                or any(not torch.equal(loaded[k], params[k].float()) for k in loaded):
            raise AssertionError("the exported .pth does not read back equal")
        print(f"(a) export: {len(loaded)} tensors through `cli export` to .pth, read back "
              f"equal", flush=True)

        # (b) the server: the serve CLI's defaults around a bf16 Detector
        det = Detector(spec, loaded, conf_thres=SERVE["conf"], model_size=size, device=dev)
        # on the card one K1 and one K2 a residual unit (23 in YOLOv3) per
        # dispatch; CPU tensors take the plain versions, which count nothing
        per_dispatch = {"resize_normalize": int(cuda),
                        "fused_residual_block": len(det.packs) if cuda else 0,
                        "fused_residual_block_int8": 0}
        record["per_dispatch"] = per_dispatch
        caa = CAAFilter(classifier.from_jax_params(random_classifier_params(SEED)), device=dev)
        server = DetectionServer(det, ["CAA", "Cored"], batch_size=SERVE["batch"],
                                 max_wait_ms=SERVE["max_wait_ms"], caa_filter=caa).start()
        t0 = time.perf_counter()
        if not server.warmup():
            raise AssertionError("warmup refused on a bf16 Detector")
        record["warmup_s"] = time.perf_counter() - t0
        print(f"(b) server on port {server.port}, batch {SERVE['batch']}, max_wait "
              f"{SERVE['max_wait_ms']} ms, conf {SERVE['conf']}, CAA filter on; warmup "
              f"{record['warmup_s']:.2f} s", flush=True)

        # (c) correctness under 8 client threads
        rng = np.random.RandomState(SEED + 12)
        side = det.tile_size
        jpeg = [_encode(stain_tile(rng, side, side), "JPEG") for _ in range(12)]
        raw = [stain_tile(rng, side, side) for _ in range(10)]
        border = stain_tile(rng, *folder_kw["border"])
        shape = {"X-Image-Shape": f"{side},{side}"}
        requests = ([("jpeg", "", b, {}) for b in jpeg[:8]]
                    + [("jpeg, caa_filter=0", "?caa_filter=0", b, {}) for b in jpeg[8:]]
                    + [("raw", "", r.tobytes(), shape) for r in raw[:8]]
                    + [("png border", "", _encode(border, "PNG"), {})] * 2
                    + [("raw, merge=0 caa_filter=0", "?merge=0&caa_filter=0", r.tobytes(), shape)
                       for r in raw[8:]])
        d0 = server.executor.n_dispatches
        reset_launch_counts()
        answers = _run_clients(SERVE_CLIENTS, lambda r: _http(
            server.port, "POST", "/v1/detect" + r[1], r[2], r[3]), requests)
        torch.cuda.synchronize()
        counts, dispatches = launch_counts(), server.executor.n_dispatches - d0
        want_counts = {k: v * dispatches for k, v in per_dispatch.items()}
        print(f"(c) {len(requests)} requests from {SERVE_CLIENTS} threads: {dispatches} "
              f"dispatches, launches {counts} (want {want_counts}); native decodes "
              f"{server._n_native}, raw {server._n_raw}", flush=True)
        if any(code != 200 for code, _, _ in answers):
            raise AssertionError(f"served errors: {[(c, a) for c, _, a in answers if c != 200]}")
        if counts != want_counts:
            raise AssertionError(f"serving launches {counts} over {dispatches} dispatches")
        if libjpeg_present() and not (native.available() and server._n_native == 4):
            raise AssertionError("libjpeg is present but exact-tile JPEGs did not decode natively")
        want = recompute_served(server, requests)
        box_err = score_err = 0.0
        n_rows = 0
        for (name, *_), (_, _, got), (hw, rows) in zip(requests, answers, want):
            g = _rows_of(got)
            if got["image_hw"] != hw or g.shape != rows.shape or (g[:, 6] != rows[:, 6]).any():
                raise AssertionError(f"{name}: served {got['image_hw']} {g.shape}, recomputed "
                                     f"{hw} {rows.shape}")
            if len(g):
                box_err = max(box_err, float(np.abs(g[:, :4] - rows[:, :4]).max()))
                score_err = max(score_err, float(np.abs(g[:, 4:6] - rows[:, 4:6]).max()))
            n_rows += len(g)
        print(f"(c) served = recomputation (_to_tile_frame, detect_batch_ragged at B="
              f"{SERVE['batch']}, rescale, merge, CAA filter alone): {n_rows} boxes, max|box "
              f"diff| {box_err} px (tolerance {SERVE_TOL['box']}), max|score diff| {score_err} "
              f"(tolerance {SERVE_TOL['score']})", flush=True)
        if box_err > SERVE_TOL["box"] or score_err > SERVE_TOL["score"] or n_rows == 0:
            raise AssertionError("served answers disagree with their recomputation")
        record.update({"correctness": {"requests": len(requests), "dispatches": dispatches,
                                       "launches": counts, "boxes": n_rows,
                                       "max_box_diff": box_err, "max_score_diff": score_err}})

        # (d) load: a closed loop of 16 clients in a process of their own, raw
        # then JPEG bodies, then raw bodies again with a slice traced
        body_dir = os.path.join(tmp, "bodies")
        os.makedirs(body_dir)
        bodies = {"raw": [], "jpeg": []}
        for kind, items, hdr in (("raw", [r.tobytes() for r in raw], shape),
                                 ("jpeg", jpeg, {})):
            for i, body in enumerate(items):
                path = os.path.join(body_dir, f"{kind}{i}")
                with open(path, "wb") as fh:
                    fh.write(body)
                bodies[kind].append((path, hdr))
        for kind in ("raw", "jpeg", "traced"):
            s0 = server._stats()
            during = (lambda: trace_device(*TRACE_WINDOW)) if kind == "traced" and cuda else None
            loop, trace = run_load(server.port, bodies["jpeg" if kind == "jpeg" else "raw"],
                                   load_seconds[kind], root, during)
            s1 = server._stats()
            lat, wall = loop["latencies_ms"], loop["wall_s"]
            n_req, n_disp = s1["requests"] - s0["requests"], s1["dispatches"] - s0["dispatches"]
            rec = {"requests": len(lat), "wall_s": wall, "requests_per_s": len(lat) / wall,
                   "p50_ms": float(np.percentile(lat, 50)),
                   "p99_ms": float(np.percentile(lat, 99)), "dispatches": n_disp,
                   "batched_ratio": n_req / max(n_disp, 1),
                   "ms_per_dispatch": wall * 1e3 / max(n_disp, 1)}
            if trace is not None:
                rec["trace"] = trace
            record[f"load_{kind}"] = rec
            print(f"(d) load {kind}, {LOAD_CLIENTS} closed-loop clients in their own process, "
                  f"{wall:.2f} s: {rec['requests']} requests = {rec['requests_per_s']:.2f} req/s, "
                  f"p50 {rec['p50_ms']:.1f} ms, p99 {rec['p99_ms']:.1f} ms, {n_disp} dispatches "
                  f"(one every {rec['ms_per_dispatch']:.1f} ms), batched_ratio "
                  f"{rec['batched_ratio']:.2f} [{card}]", flush=True)
            if trace is not None:
                print(f"(d) trace of {trace['wall_ms']:.0f} ms of the raw load: device busy "
                      f"{trace['device_busy_ms']} ms, share {trace.get('busy_share')} "
                      f"(\"trace_complete\": \"{trace['trace_complete']}\"); by group "
                      f"{json.dumps(trace.get('by_group'))} [{card}]", flush=True)

        # where a request's time goes, each part alone
        b = SERVE["batch"]
        batch = np.stack([raw[i % len(raw)] for i in range(b)])
        on_card = torch.from_numpy(batch).to(dev)
        with torch.inference_mode():
            call_ms = cuda_ms(lambda: det(on_card), iters=5, warmup=2, hold=False)
            upload_ms = cuda_ms(lambda: torch.from_numpy(batch).to(dev), iters=5, warmup=2,
                                hold=False)
            dispatch_ms = cuda_ms(lambda: det.detect_batch_ragged(batch, b), iters=5, warmup=2,
                                  hold=False)
        t0 = time.perf_counter()
        for _ in range(5):
            np.stack([raw[i % len(raw)] for i in range(b)])
        stack_ms = (time.perf_counter() - t0) * 1e3 / 5
        t0 = time.perf_counter()
        for body in jpeg:
            np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(jpeg)
        some = [(raw[i], d) for i, d in enumerate(det.detect_batch_ragged(batch[:b], b)[:8])
                if d is not None]
        t0 = time.perf_counter()
        for img, d in some:
            caa(img, d)
        caa_ms = (time.perf_counter() - t0) * 1e3 / max(len(some), 1)
        parts = {"call_b16_on_card_ms": call_ms, "call_tiles_per_s": b / call_ms * 1e3,
                 "upload_b16_ms": upload_ms, "detect_batch_ragged_b16_ms": dispatch_ms,
                 "upload_share_of_detect_batch_ragged": upload_ms / dispatch_ms,
                 "upload_share_of_dispatch": upload_ms / (stack_ms + dispatch_ms),
                 "stack_b16_ms": stack_ms, "pil_decode_ms_per_tile": decode_ms,
                 "caa_filter_ms_per_request": caa_ms}
        record["parts"] = parts
        print(f"(d) parts: Detector.__call__ B={b} on the card {call_ms:.3f} ms = "
              f"{parts['call_tiles_per_s']:.1f} tiles/s; pageable upload of the B={b} batch "
              f"({batch.nbytes / 1e6:.1f} MB) {upload_ms:.3f} ms; detect_batch_ragged from "
              f"host numpy (upload, call, copy back) {dispatch_ms:.3f} ms; np.stack of the "
              f"batch {stack_ms:.3f} ms; the upload {parts['upload_share_of_dispatch']:.3f} of "
              f"a dispatch (stack + detect_batch_ragged), "
              f"{parts['upload_share_of_detect_batch_ragged']:.3f} of detect_batch_ragged; PIL "
              f"decode {decode_ms:.2f} ms a tile; CAA filter {caa_ms:.2f} ms a request "
              f"[{card}]", flush=True)
        del on_card

        # (e) overload: a burst of 48 against max_queue 16; an oversize body
        burst_server = DetectionServer(det, ["CAA", "Cored"], batch_size=SERVE["batch"],
                                       max_wait_ms=SERVE["max_wait_ms"], caa_filter=caa,
                                       max_queue=BURST["max_queue"]).start()
        gate = threading.Barrier(BURST["requests"])

        def burst(i):
            gate.wait(timeout=HTTP_TIMEOUT)
            return _post_headers_first(burst_server.port, raw[i % len(raw)].tobytes(), shape)

        hold_device(dev, BURST["hold_s"])
        got = _run_clients(BURST["requests"], burst, range(BURST["requests"]))
        codes = [c for c, _, _ in got]
        shed = [h for c, h, _ in got if c == 503]
        stats = burst_server._stats()
        big = _post_headers_first(burst_server.port, b"x" * 10,
                                  {"Content-Length": str(burst_server.max_body_bytes + 1)})[0]
        record["burst"] = {"ok": codes.count(200), "shed": len(shed), "stats_shed": stats["shed"],
                           "oversize": big}
        print(f"(e) burst of {BURST['requests']} at max_queue {BURST['max_queue']}, the device "
              f"held {BURST['hold_s']} s: {codes.count(200)} answered 200, {len(shed)} answered "
              f"503 (Retry-After {sorted({h.get('Retry-After') for h in shed})}), /stats shed "
              f"{stats['shed']}; oversize Content-Length -> {big}", flush=True)
        if (set(codes) != {200, 503} or stats["shed"] != len(shed)
                or any(h.get("Retry-After") != "1" for h in shed) or big != 413):
            raise AssertionError(f"overload: codes {sorted(set(codes))}, shed {len(shed)}, "
                                 f"/stats shed {stats['shed']}, oversize {big}")
        burst_server.stop()
        burst_server = None

        # (f) the CLI on the card: detect, serve in a subprocess, sweep
        folder = os.path.join(tmp, "folder")
        os.makedirs(folder)
        readable, *_ = write_folder(folder, SEED, **folder_kw)
        out_dir = os.path.join(tmp, "detect_out")
        log = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli_main(["detect", "--model_def", cfg, "--weights_path", pth,
                           "--image_folder", folder, "--output_dir", out_dir, "--batch_size",
                           "8", "--conf_thres", str(SERVE["conf"]), "--img_size", str(size),
                           *dev_args])
        torch.cuda.synchronize()
        detect_s, detect_counts = time.perf_counter() - t0, launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            res = det.detect_folder(folder, batch_size=8)
        want_lines = ["\t+ Label: %s, Conf: %.5f" % (("CAA", "Cored")[int(r[6])], r[5])
                      for d in res.values() if d is not None for r in d]
        got_lines = [l for l in log.getvalue().splitlines() if "+ Label:" in l]
        n_batches = -(-len(readable) // 8)
        with_boxes = sum(d is not None for d in res.values())
        print(f"(f) cli detect over {len(readable)} readable tiles at B=8: rc {rc}, "
              f"{len(got_lines)} label rows (detect_folder: {len(want_lines)}), "
              f"{len(os.listdir(out_dir))} images for {with_boxes} tiles with boxes, launches "
              f"{detect_counts} over {n_batches} batches, {detect_s:.2f} s", flush=True)
        if rc != 0 or got_lines != want_lines or not want_lines \
                or len(os.listdir(out_dir)) != with_boxes:
            raise AssertionError("cli detect differs from detect_folder")
        if detect_counts != {k: v * n_batches for k, v in per_dispatch.items()}:
            raise AssertionError(f"cli detect launches {detect_counts}")

        sub = serve_subprocess(["--model_def", cfg, "--weights_path", pth, "--conf_thres",
                                str(SERVE["conf"]), "--img_size", str(size), *dev_args],
                               dev.type, card_name, jpeg[0], root)
        _, _, here = _http(server.port, "POST", "/v1/detect?caa_filter=0", jpeg[0])
        g, w = _rows_of(sub["answer"]), _rows_of(here)
        if g.shape != w.shape or (len(g) and (np.abs(g[:, :4] - w[:, :4]).max() > SERVE_TOL["box"]
                                              or np.abs(g[:, 4:6] - w[:, 4:6]).max()
                                              > SERVE_TOL["score"])):
            raise AssertionError("the serve subprocess answers otherwise than this server")
        record["serve_subprocess"] = {"ready_s": sub["ready_s"], "boxes": len(g),
                                      "health": sub["health"]}

        t0s = [p for p in readable if os.path.basename(p).startswith("t0")]
        tree = os.path.join(tmp, "wsis")
        half = len(t0s) // 2
        swept = write_wsi_tree(tree, [("CERAD_4G8_A", t0s[:half], 6),
                                      ("CERAD_4G8_B", t0s[half:], 5)])
        pk = os.path.join(tmp, "pickles")
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as sweep_log:
            rc = cli_main(["sweep", "--model_def", cfg, "--weights_path", pth, "--directory",
                           tree, "--conf_thres", str(SERVE["conf"]), "--cross_tile_merge",
                           "True", "--pickles_dir", pk, "--prefix", "P_", *dev_args])
        torch.cuda.synchronize()
        sweep_s, sweep_counts = time.perf_counter() - t0, launch_counts()
        with open(os.path.join(pk, "P_WSI_plaque_counts_dictionary.pkl"), "rb") as fh:
            wsi_counts = pickle.load(fh)
        with open(os.path.join(pk, "P_1536_plaque_counts_dictionary.pkl"), "rb") as fh:
            tile_counts = pickle.load(fh)
        t0 = time.perf_counter()  # the sweep command's set-up, alone
        sweep_det = Detector(spec, load_pretrained(spec, pth), conf_thres=SERVE["conf"],
                             device=dev)
        sweep_caa = CAAFilter(device=dev)
        setup_s = time.perf_counter() - t0
        with contextlib.redirect_stdout(io.StringIO()):
            want_wsi, want_tiles = recompute_sweep(sweep_det, sweep_caa, tree, 8)
        print(f"(f) cli sweep, cross_tile_merge on, {len(swept)} tiles in 2 WSIs: rc {rc}, "
              f"{wsi_counts} (recomputation from detect_folder {want_wsi}); the command "
              f"{sweep_s:.2f} s with its set-up (Detector from the .pth and CAA filter "
              f"{setup_s:.2f} s alone); launches {sweep_counts}; "
              f"{sweep_log.getvalue().strip()!r} [{card}]", flush=True)
        if rc != 0 or wsi_counts != want_wsi or tile_counts != want_tiles:
            raise AssertionError("cli sweep counts differ from their recomputation")
        if sum(c["Cored"] + c["CAA"] for c in wsi_counts.values()) == 0:
            raise AssertionError("the sweep counted nothing")

        # (g) the sweep's rate: calculate_plaque_counts_per_wsi alone, on a
        # slide tree of several hundred tiles, the Detector and filter built
        big = os.path.join(tmp, "wsis_big")
        tree_kw = dict(SWEEP_TREE, **(sweep_tree or {}))
        n_big = len(write_wsi_tree(big, [(f"CERAD_4G8_{w}", t0s * tree_kw["rows"], len(t0s))
                                         for w in range(tree_kw["wsis"])]))
        big_batches = tree_kw["wsis"] * tree_kw["rows"] * -(-len(t0s) // 8)
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the overflow warning: random weights
            big_counts = calculate_plaque_counts_per_wsi(
                big, sweep_det, sweep_caa, prefix="G_", pickles_dir=pk, batch_size=8,
                cross_tile_merge=True)
        torch.cuda.synchronize()
        big_s, big_launches = time.perf_counter() - t0, launch_counts()
        print(f"(g) calculate_plaque_counts_per_wsi alone, B=8, CAA filter and cross-tile "
              f"merge on: {n_big} tiles in {tree_kw['wsis']} WSIs of {tree_kw['rows']} rows of "
              f"{len(t0s)} in {big_s:.2f} s = {n_big / big_s:.2f} tiles/s; launches "
              f"{big_launches} over {big_batches} batches; counts {big_counts} [{card}]",
              flush=True)
        if big_launches != {k: v * big_batches for k, v in per_dispatch.items()}:
            raise AssertionError(f"sweep launches {big_launches} over {big_batches} batches")
        if any(c["Cored"] + c["CAA"] == 0 for c in big_counts.values()):
            raise AssertionError("the sweep counted nothing on a slide")
        record.update({"cli_detect": {"tiles": len(readable), "seconds": detect_s,
                                      "label_rows": len(got_lines), "launches": detect_counts},
                       "cli_sweep": {"tiles": len(swept), "command_s": sweep_s,
                                     "setup_s": setup_s, "counts": wsi_counts,
                                     "launches": sweep_counts},
                       "sweep": {"tiles": n_big, "batches": big_batches, "seconds": big_s,
                                 "tiles_per_s": n_big / big_s, "launches": big_launches}})
    finally:
        for s in (burst_server, server):
            if s is not None:
                s.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return record


# --------------------------------------------------------------------------
# phase 13: data parallelism
# --------------------------------------------------------------------------

F32_HEAD_TOL = 1e-4  # (a) max |card - cpu| / max |cpu| per head, float32 both, TF32 off
DP_TILES = 32        # (b) the mesh call's batch
DP_TRAIN_B = 8       # (c), (d) the global batch of the train step
DP_LR = 1e-3         # (c), (d) parameters after one apply: rtol 1e-4, atol 2.05 x lr
DP_LOSS_RTOL = 1e-5
DP_TIMED_STEPS = 3   # (c), (d) steps timed after the checked one
CHILD_TIMEOUT_S = 300
DP_TR_BATCHES = 1    # (f) batches of the torchrun epoch: one apply, the bounds of one


def host_ms(fn, iters: int, devices, warmup: int = 0) -> float:
    """Mean ms per call of ``fn`` on the host clock, after ``warmup`` calls,
    with ``devices`` synchronized before and after (a step that spans cards,
    threads or processes has no one stream to put events on)."""
    import torch

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def _params_close(got, want, lr: float = DP_LR) -> dict:
    """The JAX suite's bound on parameters after one Adam apply (rtol 1e-4,
    atol 2.05 x lr) and STEP_RTOL on the BN running statistics; returns the
    worst of each, raising when a bound is broken."""
    import torch
    worst_p, worst_s = ("", 0.0), ("", 0.0)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w = got[k].detach().float().cpu(), w.detach().float().cpu()
        if k.endswith(("running_mean", "running_var")):
            rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            worst_s = max(worst_s, (k, rel), key=lambda kv: kv[1])
            if rel > STEP_RTOL:
                raise AssertionError(f"{k}: BN running statistics differ by {rel} (rel)")
        else:
            excess = float(((g - w).abs() - (1e-4 * w.abs() + 2.05 * lr)).max())
            worst_p = max(worst_p, (k, excess), key=lambda kv: kv[1])
            if excess > 0:
                raise AssertionError(f"{k}: parameters differ past rtol 1e-4 / atol 2.05 lr")
    return {"param_worst_excess": list(worst_p), "stat_worst_rel": list(worst_s)}


def dp_child(argv) -> int:
    """(d)'s child: ``python3 chip_smoke.py --dp-child <backend> <rank> <world>
    <port> <work dir> <device>``.  Joins the process group, checks one
    all-reduce, runs one float32 train step on its rows of the parent's batch
    (``shard_train_step_multiprocess``), then ``DP_TIMED_STEPS`` more,
    timed; prints a JSON line, and rank 0 saves the parameters after the
    first step."""
    import torch
    import torch.distributed as dist
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    from amyloid_yolo_tpu_torch.parallel import distributed as D
    from amyloid_yolo_tpu_torch.parallel import steps
    backend, rank, world, port, work, device = argv[0], int(argv[1]), int(argv[2]), \
        argv[3], argv[4], argv[5]
    D.initialize(f"127.0.0.1:{port}", world, rank, backend=backend, device=device,
                 timeout=CHILD_TIMEOUT_S)
    dev = D.local_device()
    probe = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(probe)
    if probe.cpu().tolist() != [world * (world + 1) / 2] * 4:
        raise AssertionError(f"all-reduce gave {probe.tolist()}")
    setup = torch.load(os.path.join(work, "setup.pt"), weights_only=False)
    spec = from_cfg(os.path.join(work, "model.cfg"))
    mesh = D.global_mesh()
    imgs, t, m, per = setup["imgs"], setup["targets"], setup["mask"], setup["per_image"]
    b = D.local_batch_size(len(imgs), mesh)
    lo, hi = rank * b, (rank + 1) * b
    mine = (imgs[lo:hi], t[lo * per:hi * per], m[lo * per:hi * per])
    opt = steps.make_optimizer(DP_LR)
    state = steps.init_train_state(setup["params"], opt, device=dev)
    step = D.shard_train_step_multiprocess(steps.make_train_step(spec, opt, augment=False),
                                           mesh)
    state, metrics = step(state, *mine, None, setup["size"])
    loss = float(metrics["loss"])
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in state.params.items()},
                   os.path.join(work, f"params_{backend}{world}.pt"))

    def again():
        nonlocal state
        state, metrics = step(state, *mine, None, setup["size"])
        float(metrics["loss"])

    D.barrier()  # every rank starts its clock after rank 0's save
    step_ms = host_ms(again, DP_TIMED_STEPS, [dev])
    print(json.dumps({"dp_child": True, "backend": backend, "rank": rank, "world": world,
                      "device": str(dev), "loss": loss, "step_ms": step_ms}), flush=True)
    dist.destroy_process_group()
    return 0


def _run_dp_children(tag: str, backend: str, devices, work: str, root: str) -> list:
    """Run one group of (d)'s children, one a rank, each with its timeout;
    returns their JSON records in rank order."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-child", backend, str(rank),
         str(len(devices)), str(port), work, device],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank, device in enumerate(devices)]
    out, failures = [], []
    try:
        for rank, p in enumerate(procs):
            try:
                log = p.communicate(timeout=CHILD_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                log = p.communicate()[0]
                failures.append(f"{tag} rank {rank} timed out after {CHILD_TIMEOUT_S} s")
            recs = [json.loads(l) for l in log.splitlines() if l.startswith('{"dp_child"')]
            if p.returncode != 0 or len(recs) != 1:
                failures.append(f"{tag} rank {rank} rc {p.returncode}:\n{log[-3000:]}")
            else:
                out.append(recs[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failures:
        raise AssertionError("data-parallel children failed: " + "\n".join(failures))
    return out


def parallel_phase(spec, params, card: str, dev, size: int = 416, side: int = 1536,
                   folder_kw=None) -> dict:
    """Phase 13 (see the module docstring); returns its JSON record.  On the
    CPU (a rehearsal with a mini spec: ``size``, ``side`` and ``folder_kw``
    cut it down) the meshes are CPU entries, the children run gloo on the
    CPU and the NCCL runs are left out; ``torch.cuda.synchronize`` and
    ``cuda_ms`` then need host stand-ins."""
    import pickle
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.cli.main import main as cli_main
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import emit_cfg
    from amyloid_yolo_tpu_torch.io.weights import params_to_torch_state_dict
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.models import darknet
    from amyloid_yolo_tpu_torch.parallel import steps
    from amyloid_yolo_tpu_torch.parallel.mesh import make_mesh

    cuda = dev.type == "cuda"
    n_cards = torch.cuda.device_count() if cuda else 0
    if n_cards >= 2:
        mesh = make_mesh(2)
        mesh32 = make_mesh()
    else:  # one card (or the CPU): two shards on one device
        mesh = mesh32 = make_mesh(devices=[dev, dev])
    root = os.path.dirname(os.path.abspath(__file__))
    record = {"cards": n_cards, "mesh_devices": [str(d) for d in mesh32.devices],
              "train_mesh_devices": [str(d) for d in mesh.devices]}
    print(f"phase 13 on {n_cards} card(s): the Detector's mesh {record['mesh_devices']}, the "
          f"train step's {record['train_mesh_devices']}; the per-device shared-memory limit "
          f"of K2/K3 {'runs on a second card here' if n_cards >= 2 else 'is not exercised (one card)'}",
          flush=True)
    rng = np.random.RandomState(SEED + 13)

    # (a) the float32 Detector on the card against the CPU
    tiles8 = rng.randint(0, 256, (8, side, side, 3)).astype(np.uint8)
    det32 = Detector(spec, params, conf_thres=0.3, compute_dtype=torch.float32,
                     model_size=size, device=dev)
    cpu32 = Detector(spec, params, conf_thres=0.3, compute_dtype=torch.float32,
                     model_size=size, device="cpu")
    seen = []
    apply_folded = darknet.apply_folded

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                     k.get("packs") is None))
        return apply_folded(*a, **k)

    flags0 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    darknet.apply_folded = spy
    try:
        reset_launch_counts()
        dets, valid = det32(tiles8)
        torch.cuda.synchronize()
        f32_counts = launch_counts()
        flags_after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        darknet.apply_folded = apply_folded
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags0
    with torch.inference_mode():
        card_maps = det32.head_maps(torch.from_numpy(tiles8).to(dev))
        cpu_maps = cpu32.head_maps(torch.from_numpy(tiles8))
    head_rel = [((m.cpu() - p).abs().max() / p.abs().max()).item()
                for m, p in zip(card_maps, cpu_maps)]
    cd, cv = cpu32(tiles8)
    same = [i for i in range(8) if torch.equal(valid[i].cpu(), cv[i])]
    box = max([float((dets[i].cpu() - cd[i])[cv[i]][:, :4].abs().max()) for i in same
               if cv[i].any()] or [0.0])
    print(f"(a) float32 Detector, 8 tiles: launches {f32_counts} (want K1 0, K2 0); TF32 flags "
          f"inside the call (cuDNN, matmul, no K2 packs) {seen}, after it {flags_after} (set "
          f"True before); head maps max|card-cpu|/max|cpu| {[f'{r:.3g}' for r in head_rel]} "
          f"(tolerance {F32_HEAD_TOL}); detections: {len(same)} of 8 tiles with the CPU's valid "
          f"mask, max |box diff| {box:.4g} px on them (not a check: the pool of 64 is picked "
          f"among {int(det32._last_ncand.min())}+ candidates a tile)", flush=True)
    if any(f32_counts.values()):
        raise AssertionError(f"the float32 Detector launched kernels: {f32_counts}")
    if seen != [(not cuda, not cuda, True)] or flags_after != (True, True):
        raise AssertionError("TF32 was not off inside the float32 call, or not restored")
    if max(head_rel) > F32_HEAD_TOL or not torch.isfinite(dets).all():
        raise AssertionError("float32 head maps on the card disagree with the CPU")
    record["f32"] = {"launches": f32_counts, "head_rel": head_rel, "tiles_same_valid": len(same),
                     "max_box_diff_px": box, "flags_inside": seen, "flags_after": flags_after}
    del det32, cpu32, card_maps, cpu_maps

    # (b) Detector(mesh=) at B=32 against the one-device Detector
    tiles32 = torch.randint(0, 256, (DP_TILES, side, side, 3), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(SEED)).to(dev)
    one = Detector(spec, params, conf_thres=0.3, model_size=size, device=dev)
    dpd = Detector(spec, params, conf_thres=0.3, model_size=size, mesh=mesh32)
    shards = mesh32.size
    with torch.inference_mode():
        reset_launch_counts()
        md, mv = dpd(tiles32)
        torch.cuda.synchronize()
        mesh_counts = launch_counts()
        parts = [one(p) for p in tiles32.chunk(shards)]
        rd, rv = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        bd, bv = one(tiles32)
    # one K1 and one K2 a residual unit (23 in YOLOv3) on each shard; CPU
    # tensors take the plain versions, which count nothing
    want_counts = {"resize_normalize": shards * cuda,
                   "fused_residual_block": len(dpd.packs) * shards * cuda,
                   "fused_residual_block_int8": 0}
    v = rv.cpu()
    box_err = float((md.cpu() - rd.cpu())[v][:, :4].abs().max()) if v.any() else 0.0
    score_err = float((md.cpu() - rd.cpu())[v][:, 4:6].abs().max()) if v.any() else 0.0
    b32_same = int(sum(torch.equal(bv[i].cpu(), mv[i].cpu()) for i in range(DP_TILES)))
    print(f"(b) Detector(mesh over {mesh32.devices}) B={DP_TILES}: launches {mesh_counts} (want "
          f"{want_counts}); against the one-device Detector on the same {shards} shards: valid "
          f"equal {torch.equal(mv.cpu(), rv.cpu())}, max|box diff| {box_err} px (tolerance "
          f"{SERVE_TOL['box']}), max|score diff| {score_err} (tolerance {SERVE_TOL['score']}); "
          f"against one B={DP_TILES} call: {b32_same} of {DP_TILES} tiles with the same valid "
          f"mask (not a check: other batch shapes round bf16 otherwise)", flush=True)
    if mesh_counts != want_counts:
        raise AssertionError(f"mesh launches {mesh_counts}, want {want_counts}")
    if not torch.equal(mv.cpu(), rv.cpu()) or box_err > SERVE_TOL["box"] \
            or score_err > SERVE_TOL["score"] or not torch.isfinite(md).all():
        raise AssertionError("the mesh Detector disagrees with the one-device Detector")
    with torch.inference_mode():
        mesh_ms = cuda_ms(lambda: dpd(tiles32), iters=5, warmup=1, hold=False)
        one_ms = cuda_ms(lambda: one(tiles32), iters=5, warmup=1, hold=False)
    print(f"(b) B={DP_TILES}, tiles on the card: mesh of {shards} {mesh_ms:.3f} ms = "
          f"{DP_TILES / mesh_ms * 1e3:.1f} tiles/s; one device {one_ms:.3f} ms = "
          f"{DP_TILES / one_ms * 1e3:.1f} tiles/s [{card}]", flush=True)
    record["mesh_detector"] = {
        "shards": shards, "launches": mesh_counts, "box_err": box_err, "score_err": score_err,
        "b32_same_valid": b32_same, "mesh_ms": mesh_ms, "one_ms": one_ms,
        "mesh_tiles_per_s": DP_TILES / mesh_ms * 1e3, "one_tiles_per_s": DP_TILES / one_ms * 1e3}
    del one, dpd, tiles32, md, rd, bd, parts

    # (c) the in-process data-parallel train step against the one-device step
    imgs, t, m = train_batch(rng, DP_TRAIN_B, side)
    runs = {}
    for name, shard_mesh in (("one", None), ("dp", mesh)):
        opt = steps.make_optimizer(DP_LR)
        state = steps.init_train_state(params, opt, device=dev)
        step = steps.make_train_step(spec, opt, augment=False)
        if shard_mesh is not None:
            step = steps.shard_train_step(step, shard_mesh)
        state, metrics = step(state, imgs, t, m, None, size)
        loss = float(metrics["loss"])
        after = {k: v.detach().clone() for k, v in state.params.items()}

        def again():
            nonlocal state
            state, metrics = step(state, imgs, t, m, None, size)
            float(metrics["loss"])

        runs[name] = (loss, after,
                      host_ms(again, DP_TIMED_STEPS, shard_mesh.devices if shard_mesh else [dev]))
        del state, opt
    ref_loss, ref_params, one_ms = runs["one"]
    loss_rel = abs(runs["dp"][0] - ref_loss) / abs(ref_loss)
    close = _params_close(runs["dp"][1], ref_params)
    opt = steps.make_optimizer(DP_LR)
    state = steps.init_train_state(params, opt, device=dev)
    bf16_step = steps.shard_train_step(
        steps.make_train_step(spec, opt, augment=False, compute_dtype=torch.bfloat16), mesh)
    state, metrics = bf16_step(state, imgs, t, m, None, size)
    bf16_loss = float(metrics["loss"])
    bf16_finite = all(bool(torch.isfinite(v).all()) for v in state.params.values()
                      if v.is_floating_point())
    del state, opt
    print(f"(c) in-process data-parallel step over {mesh.devices}, B={DP_TRAIN_B} at {size}, "
          f"float32 with TF32 off, one apply: loss {runs['dp'][0]} vs the one-device step "
          f"{ref_loss} (rel {loss_rel:.3g}, tolerance {DP_LOSS_RTOL}); parameters within rtol "
          f"1e-4 / atol 2.05 lr (worst excess {close['param_worst_excess']}); BN running stats "
          f"worst rel {close['stat_worst_rel']} (tolerance {STEP_RTOL}); the next "
          f"{DP_TIMED_STEPS} steps {runs['dp'][2]:.1f} ms each against {one_ms:.1f} ms on one "
          f"device (host clock, mean); bf16 step loss {bf16_loss}, parameters finite {bf16_finite} [{card}]",
          flush=True)
    if loss_rel > DP_LOSS_RTOL or not (math.isfinite(bf16_loss) and bf16_finite):
        raise AssertionError("the data-parallel train step disagrees with the one-device step")
    record["dp_step"] = {"loss": runs["dp"][0], "loss_one": ref_loss, "loss_rel": loss_rel,
                         **close, "step_ms": runs["dp"][2], "one_step_ms": one_ms,
                         "bf16_loss": bf16_loss}

    # (d) two processes against the one-process step at the global batch
    groups = [("gloo2", "gloo", [str(dev)] * 2)]
    if cuda:
        groups.append(("nccl1", "nccl", ["cuda:0"]))
        if n_cards >= 2:
            groups.append((f"nccl{n_cards}", "nccl", [f"cuda:{i}" for i in range(n_cards)]))
    work = tempfile.mkdtemp(prefix="phase13_")
    try:
        with open(os.path.join(work, "model.cfg"), "w") as fh:
            fh.write(emit_cfg(spec))
        torch.save({"params": params, "imgs": imgs, "targets": t, "mask": m,
                    "per_image": len(t) // DP_TRAIN_B, "size": size},
                   os.path.join(work, "setup.pt"))
        if cuda:
            torch.cuda.empty_cache()
        record["processes"] = {}
        for tag, backend, devices in groups:  # one group at a time: the card is theirs
            t0 = time.perf_counter()
            recs = _run_dp_children(tag, backend, devices, work, root)
            wall = time.perf_counter() - t0
            losses = [r["loss"] for r in recs]
            got = torch.load(os.path.join(work, f"params_{tag}.pt"))
            rel = abs(losses[0] - ref_loss) / abs(ref_loss)
            if len(set(losses)) != 1 or rel > DP_LOSS_RTOL:
                raise AssertionError(f"{tag}: losses {losses} against {ref_loss}")
            close = _params_close(got, ref_params)
            record["processes"][tag] = {"losses": losses, "loss_rel": rel, **close,
                                        "step_ms": [r["step_ms"] for r in recs],
                                        "devices": [r["device"] for r in recs],
                                        "wall_s": wall}
            print(f"(d) {tag} on {[r['device'] for r in recs]}: loss {losses[0]} on every rank "
                  f"(rel {rel:.3g} to the one-process step, tolerance {DP_LOSS_RTOL}); "
                  f"parameters within rtol 1e-4 / atol 2.05 lr (worst excess "
                  f"{close['param_worst_excess']}), BN stats worst rel "
                  f"{close['stat_worst_rel']}; the next {DP_TIMED_STEPS} steps "
                  f"{[round(r['step_ms'], 1) for r in recs]} ms each by rank (host clock, mean; "
                  f"the group ran alone, {wall:.1f} s with start-up) [{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (e) cli sweep --data_parallel 2 against the one-device sweep
    tmp = tempfile.mkdtemp(prefix="phase13_sweep_")
    try:
        cfg = os.path.join(tmp, "model.cfg")
        with open(cfg, "w") as fh:
            fh.write(emit_cfg(spec))
        pth = os.path.join(tmp, "weights.pth")
        torch.save(params_to_torch_state_dict(spec, params), pth)
        folder = os.path.join(tmp, "folder")
        os.makedirs(folder)
        readable, *_ = write_folder(folder, SEED, **dict(FOLDER, **(folder_kw or {})))
        t0s = [p for p in readable if os.path.basename(p).startswith("t0")]
        half = len(t0s) // 2
        tree = os.path.join(tmp, "wsis")
        write_wsi_tree(tree, [("CERAD_4G8_A", t0s[:half], 6), ("CERAD_4G8_B", t0s[half:], 5)])
        dp_device = ",".join(str(d) for d in mesh.devices) if n_cards < 2 else dev.type
        common = ["sweep", "--model_def", cfg, "--weights_path", pth, "--directory", tree,
                  "--conf_thres", "0.3", "--cross_tile_merge", "True", "--prefix", "P_"]
        sweeps = {}
        for name, extra in (("one", ["--batch_size", "4", "--device", dev.type]),
                            ("dp", ["--batch_size", "8", "--data_parallel", "2",
                                    "--device", dp_device])):
            pk = os.path.join(tmp, f"pickles_{name}")
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli_main(common + ["--pickles_dir", pk] + extra)
            torch.cuda.synchronize()
            counts = {"launches": launch_counts(), "seconds": time.perf_counter() - t0}
            for kind in ("WSI", "1536"):
                with open(os.path.join(pk, f"P_{kind}_plaque_counts_dictionary.pkl"), "rb") as fh:
                    counts[kind] = pickle.load(fh)
            if rc != 0:
                raise AssertionError(f"cli sweep ({name}) returned {rc}")
            sweeps[name] = counts
        print(f"(e) cli sweep --data_parallel 2 --device {dp_device} at --batch_size 8 over "
              f"{len(t0s)} tiles in 2 WSIs: {sweeps['dp']['WSI']} in "
              f"{sweeps['dp']['seconds']:.2f} s, launches {sweeps['dp']['launches']}; the "
              f"one-device sweep at --batch_size 4 (the same batch a device): "
              f"{sweeps['one']['WSI']} in {sweeps['one']['seconds']:.2f} s, launches "
              f"{sweeps['one']['launches']} [{card}]", flush=True)
        if sweeps["dp"]["WSI"] != sweeps["one"]["WSI"] \
                or sweeps["dp"]["1536"] != sweeps["one"]["1536"]:
            raise AssertionError("the data-parallel sweep counts otherwise than one device")
        if sum(c["Cored"] + c["CAA"] for c in sweeps["one"]["WSI"].values()) == 0:
            raise AssertionError("the sweep counted nothing")
        if cuda and sweeps["dp"]["launches"]["fused_residual_block"] != \
                23 * sweeps["dp"]["launches"]["resize_normalize"]:
            raise AssertionError(f"sweep launches {sweeps['dp']['launches']}")
        record["sweep"] = {k: {"wsi": v["WSI"], "launches": v["launches"], "seconds": v["seconds"]}
                           for k, v in sweeps.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (f) train --distributed True under torchrun, one process a card
    if n_cards >= 2:
        record["torchrun"] = torchrun_train(spec, dev, n_cards, root, card)
    else:
        record["torchrun"] = {"ran": False, "why": f"{n_cards} card(s): one process a card "
                                                   "needs two or more"}
        print(f"(f) train --distributed True under torchrun not run: {n_cards} card(s), and "
              "NCCL refuses two ranks on one card", flush=True)
    return record


def _event_losses(logdir: str) -> list:
    """(epoch, batch, loss) of every logged step under ``logdir``."""
    import glob
    recs = [json.loads(line) for f in sorted(glob.glob(os.path.join(logdir, "*", "events.jsonl")))
            for line in open(f)]
    return [(r["epoch"], r["batch"], r["loss"]) for r in recs if "loss" in r]


def torchrun_train(spec, dev, n_cards: int, root: str, card: str) -> dict:
    """(f): ``cli train --distributed True`` in ``n_cards`` processes under
    ``torch.distributed.run`` (NCCL, ``cuda:LOCAL_RANK``) against the
    one-device ``Trainer`` on the same synthetic set and seed."""
    import torch
    from amyloid_yolo_tpu_torch.graphspec import emit_cfg
    from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer
    work = tempfile.mkdtemp(prefix="phase13_torchrun_")
    try:
        data = write_train_set(work, SEED + 131, n_train=DP_TR_BATCHES * DP_TRAIN_B, n_valid=2,
                               side=512)
        model = os.path.join(work, "model.cfg")
        with open(model, "w") as fh:
            fh.write(emit_cfg(spec))
        common = dict(epochs=1, batch_size=DP_TRAIN_B, gradient_accumulations=1, img_size=416,
                      evaluation_interval=0, learning_rate=DP_LR)
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={n_cards}", "-m", "amyloid_yolo_tpu_torch.cli", "train",
                "--distributed", "True", "--data_config", data, "--model_def", model,
                "--multiscale_training", "False", "--no_augment",
                "--checkpoint_dir", os.path.join(work, "mp_ckpt"),
                "--logdir", os.path.join(work, "mp_logs"),
                *(f"--{k}={v}" for k, v in common.items()),
                *(["--device", "cpu"] if dev.type == "cpu" else [])]  # a CPU rehearsal: gloo
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=CHILD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torchrun train returned {proc.returncode}:\n"
                                 f"{proc.stdout[-4000:]}")
        mp_losses = _event_losses(os.path.join(work, "mp_logs"))
        got = torch.load(os.path.join(work, "mp_ckpt", "yolov3_ckpt_0.pt"), weights_only=False)

        cfg = TrainConfig(data_config=data, multiscale=False, augment=False,
                          checkpoint_dir=os.path.join(work, "one_ckpt"),
                          logdir=os.path.join(work, "one_logs"), **common)
        Trainer(cfg, spec=spec, device=dev).train()
        one_losses = _event_losses(os.path.join(work, "one_logs"))
        want = torch.load(os.path.join(work, "one_ckpt", "yolov3_ckpt_0.pt"), weights_only=False)
        if not mp_losses or [l[:2] for l in mp_losses] != [l[:2] for l in one_losses]:
            raise AssertionError(f"logged steps {mp_losses} against {one_losses}")
        rel = abs(mp_losses[0][2] - one_losses[0][2]) / abs(one_losses[0][2])
        applies = (got["step"], want["step"])
        close = _params_close(got["params"], want["params"])
        rec = {"ran": True, "processes": n_cards, "losses": mp_losses, "one_losses": one_losses,
               "loss_rel": rel, "steps": list(applies), **close, "wall_s": wall,
               "ranks_printing": proc.stdout.count("loss=")}
        print(f"(f) torchrun --nproc_per_node={n_cards} cli train --distributed True "
              f"({'NCCL' if dev.type == 'cuda' else 'gloo'}), one "
              f"epoch of {DP_TR_BATCHES} batches of {DP_TRAIN_B} at 416, augment off: logged "
              f"losses {mp_losses} against the one-device Trainer's {one_losses} (first rel "
              f"{rel:.3g}, tolerance {DP_LOSS_RTOL}); steps {applies}; checkpoint parameters "
              f"within rtol 1e-4 / atol 2.05 lr (worst excess "
              f"{close['param_worst_excess']}), BN stats worst rel {close['stat_worst_rel']}; "
              f"{wall:.1f} s with start-up [{card}]", flush=True)
        if rel > DP_LOSS_RTOL or applies[0] != applies[1]:
            raise AssertionError("the torchrun Trainer disagrees with the one-device Trainer")
        return rec
    finally:
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 14: spatial sharding
# --------------------------------------------------------------------------

SP_B = 2                  # (a)-(c): the batch, at the tiles' native resolution
SP_B4 = 8                 # (d): the reference recipe's batch, over four cards
SP_DETECT = dict(conf_thres=0.8, nms_thres=0.4, capacity=64)  # spatial_detect's defaults
# phase 6's random weights put no objectness at 0.8 (0 candidates, measured on
# the card), so (a) raises the three head convs' objectness biases by one
# constant, chosen from the unsharded forward's objectness logits so that
# SP_OBJ_SHARE of the rows pass 0.8; the pipeline is also compared at 0.5,
# where the pool of 64 overflows
SP_CONFS = (0.8, 0.5)
SP_OBJ_SHARE = 0.005
SP_PRED_RTOL, SP_PRED_ATOL = 1e-4, 1e-5  # decoded predictions (tests/test_spatial.py:26)
SP_DET_TOL = 1e-4         # dets, rtol and atol (tests/test_spatial.py:58-61)
SP_TRAIN_SET = dict(n_train=4, n_valid=2)  # (c)
# (e), (f): the forms on the row shards.  Against the unsharded step of the
# same form only the sums over the shards reassociate, and cuDNN picks its
# algorithms for the shards' shapes: loss within the CPU tests' 1e-6
# (tests/test_torch_spatial_s2d.py).  Through YOLOv3's 72 BN layers any
# reordering moves the gradients by percents at the stem (phase 11), so the
# whole gradient is held to the JAX suite's cosine (S2D_GRAD_COS,
# tests/test_s2d_train.py:152) and each tensor's ||Δ|| / ||ref|| is printed
# beside the unsharded step's with the batch swapped (the same sums in
# another order); the new BN statistics within the larger of the stated
# bound and STEP_GRAD_NOISE_FACTOR times that swap's worst (phase 16's
# rule).  Against the other form on the shards, the form's own bounds
# (phase 16 (c)): :func:`sp_form_checks`
SP_LOSS_RTOL = 1e-6
SP_STAT_RTOL = 1e-5
SP_FORMS = {"plain": (False, "reduce"), "s2d": (True, "reduce"), "matmul": (False, "matmul")}
ACCUMULATE_GRAD_WARNING = r".*AccumulateGrad node's stream does not match.*"


def _reset_peaks(devices) -> None:
    import torch
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def _peak_gib(devices) -> dict:
    """``torch.cuda.max_memory_allocated`` of each card, GiB ({} on the CPU)."""
    import torch
    return {str(d): torch.cuda.max_memory_allocated(d) / 2 ** 30
            for d in dict.fromkeys(devices) if d.type == "cuda"}


def _sync(devices) -> None:
    import torch
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _free(devices) -> None:
    import gc
    import torch
    gc.collect()
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()


def _step_run(spec, params, dev, batch, size: int, mesh=None, dtype=None,
              form: str = "plain") -> dict:
    """One float32 (or ``dtype``) train step of ``SP_FORMS[form]``, one
    apply, augment off, on ``dev`` or height-sharded over ``mesh``: its
    loss, launches, parameters after, peak memory per card, then
    ``DP_TIMED_STEPS`` more on the host clock."""
    import torch
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.parallel import spatial, steps
    devices = list(mesh.devices) if mesh is not None else [dev]
    _free(devices)
    _reset_peaks(devices)
    opt = steps.make_optimizer(DP_LR)
    state = steps.init_train_state(params, opt, device=dev)
    s2d, form_name = SP_FORMS[form]
    step = steps.make_train_step(spec, opt, augment=False,
                                 compute_dtype=dtype or torch.float32, s2d_stem=s2d)
    if mesh is not None:
        step = spatial.shard_spatial_train_step(step, mesh)
    with bn_form(form_name):
        reset_launch_counts()
        state, metrics = step(state, *batch, None, size)
        loss = float(metrics["loss"])
        _sync(devices)
        rec = {"loss": loss, "launches": launch_counts(), "peak_gib": _peak_gib(devices),
               "after": {k: v.detach().clone() for k, v in state.params.items()}}
        if dtype is None:

            def again():
                nonlocal state
                state, m = step(state, *batch, None, size)
                float(m["loss"])

            rec["step_ms"] = host_ms(again, DP_TIMED_STEPS, devices)
    del state, opt, step
    _free(devices)
    return rec


def sp_form_checks() -> tuple:
    """(e), (f): (name, form, reference, loss rtol, stat rtol) of each
    comparison (see ``SP_LOSS_RTOL``)."""
    return (("s2d vs unsharded s2d", "s2d", "s2d_one", SP_LOSS_RTOL, SP_STAT_RTOL),
            ("s2d vs sharded plain", "s2d", "plain", S2D_LOSS_RTOL, STEP_RTOL),
            ("matmul vs unsharded matmul", "matmul", "matmul_one", SP_LOSS_RTOL, SP_STAT_RTOL),
            ("matmul vs sharded reduce", "matmul", "plain", BN_FORM_LOSS_RTOL,
             BN_FORM_STAT_RTOL))


@contextlib.contextmanager
def bn_form(form: str):
    """``darknet.BN_FORM`` (what ``AMYOLO_BN_FORM`` sets) for the block."""
    from amyloid_yolo_tpu_torch.models import darknet
    old, darknet.BN_FORM = darknet.BN_FORM, form
    try:
        yield
    finally:
        darknet.BN_FORM = old


def _grad_run(spec, params, dev, batch, size: int, form: str, mesh=None) -> dict:
    """One float32 grad step (TF32 off) of ``SP_FORMS[form]``, height-sharded
    over ``mesh`` or on ``dev``: loss, gradients, new BN statistics."""
    from amyloid_yolo_tpu_torch.parallel import spatial, steps
    s2d, form_name = SP_FORMS[form]
    devices = list(mesh.devices) if mesh is not None else [dev]
    _free(devices)
    with bn_form(form_name):
        loss, grads, stats = steps.make_grad_step(spec, s2d_stem=s2d)(
            {k: v.to(dev) for k, v in params.items()}, *batch, size,
            shards=None if mesh is None else spatial.SpatialShards(mesh))
    _sync(devices)
    return {"loss": float(loss), "grads": {k: v.detach() for k, v in grads.items()},
            "stats": stats}


def _swapped(batch):
    """The batch with its images in the other order (targets renumbered)."""
    imgs, t, m = batch
    t = t.copy()
    t[:, 0] = len(imgs) - 1 - t[:, 0]
    return imgs[::-1].copy(), t, m


def sharded_forms(spec, params, dev, mesh, batch, side: int, card: str) -> dict:
    """(e), (f): the s2d stem and the matmul BN form on the row shards."""
    import numpy as np
    import torch
    runs = {form: _grad_run(spec, params, dev, batch, side, form, mesh) for form in SP_FORMS}
    for form in ("s2d", "matmul"):
        runs[f"{form}_one"] = _grad_run(spec, params, dev, batch, side, form)
        runs[f"{form}_swap"] = _grad_run(spec, params, dev, _swapped(batch), side, form)

    def rel(grads, ref):
        return {k: float(torch.linalg.vector_norm(g - ref[k])
                         / torch.linalg.vector_norm(ref[k]).clamp(min=1e-30))
                for k, g in grads.items()}

    def cosine(grads, ref):
        a, b = (torch.cat([g[k].double().flatten() for k in ref]) for g in (grads, ref))
        return float(a @ b / (a.norm() * b.norm()))

    out = {}
    for name, form, ref_name, loss_tol, stat_tol in sp_form_checks():
        got, ref = runs[form], runs[ref_name]
        noise_ref = runs[f"{form}_one"]
        loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        g_rel = rel(got["grads"], ref["grads"])
        noise = rel(runs[f"{form}_swap"]["grads"], noise_ref["grads"])
        s_worst = _stat_rel(got["stats"], ref["stats"])
        s_noise = _stat_rel(runs[f"{form}_swap"]["stats"], noise_ref["stats"])
        s_bound = max(stat_tol, STEP_GRAD_NOISE_FACTOR * s_noise[1])
        cos = cosine(got["grads"], ref["grads"])
        worst = max(g_rel, key=g_rel.get)
        rec = {"loss": got["loss"], "loss_ref": ref["loss"], "loss_rel": loss_rel,
               "grad_cosine": cos, "grad_rel_median": float(np.median(list(g_rel.values()))),
               "grad_rel_worst": [worst, g_rel[worst]],
               "swap_noise_median": float(np.median(list(noise.values()))),
               "swap_noise_max": max(noise.values()), "stat_rel_worst": list(s_worst),
               "stat_bound": s_bound, "tensors": len(g_rel)}
        out[name] = rec
        print(f"({'e' if form == 's2d' else 'f'}) {name}, B={len(batch[0])} at {side}, f32 "
              f"(TF32 off) over {[str(d) for d in mesh.devices]}: loss {got['loss']} vs "
              f"{ref['loss']} (rel {loss_rel:.3g}, tolerance {loss_tol}); gradients of "
              f"{len(g_rel)} tensors, cosine {cos:.9f} (tolerance > {S2D_GRAD_COS}), "
              f"||Δ||/||ref|| median {rec['grad_rel_median']:.3g}, worst "
              f"{g_rel[worst]:.3g} ({worst}), beside the unsharded {form} step with the "
              f"batch swapped: median {rec['swap_noise_median']:.3g}, worst "
              f"{rec['swap_noise_max']:.3g} (not a check); new BN stats worst max|Δ|/max "
              f"{s_worst[1]:.3g} ({s_worst[0]}; tolerance {s_bound:.3g}, the larger of "
              f"{stat_tol} and {STEP_GRAD_NOISE_FACTOR}x the swap's {s_noise[1]:.3g}) [{card}]",
              flush=True)
        if loss_rel > loss_tol or cos <= S2D_GRAD_COS or s_worst[1] > s_bound:
            raise AssertionError(f"phase 14, {name}: the sharded step disagrees")
    del runs
    return out


GRAD_PROBES = ("parameter replica, a differentiable copy", "parameter replica, a leaf copy",
               "halo copy", "BN sum")


def grad_probe(name: str) -> int:
    """(h)'s child: ``python3 chip_smoke.py --grad-probe <name>``.  Two
    iterations of one gradient crossing from cuda:1 back to cuda:0 in the
    way ``name`` says, with the AccumulateGrad stream-mismatch warning made
    an error (PyTorch gives it once a process, hence a process a probe);
    prints one JSON line."""
    import warnings
    import torch
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    w = torch.randn(64, 64, device=d0, requires_grad=True)

    def once():
        x = torch.randn(32, 64, device=d1)
        if name == "parameter replica, a differentiable copy":
            (x @ w.to(d1)).square().sum().backward()
        elif name == "parameter replica, a leaf copy":  # the port's train step
            w1 = w.detach().to(d1).requires_grad_(True)
            (x @ w1).square().sum().backward()
            w.grad = w1.grad.to(d0) if w.grad is None else w.grad + w1.grad.to(d0)
        elif name == "halo copy":
            (torch.randn(32, 64, device=d0) @ w).to(d1).square().sum().backward()
        elif name == "BN sum":
            v = torch.randn(64, device=d1, requires_grad=True)
            (x * v).sum(0).to(d0).square().sum().backward()
        else:
            raise ValueError(f"unknown probe {name!r}")
        torch.cuda.synchronize()

    rec = {"grad_probe": name, "warned": False}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=ACCUMULATE_GRAD_WARNING)
        for it in range(2):
            try:
                once()
            except UserWarning as e:
                rec.update(warned=True, iteration=it, message=str(e)[:200])
                break
    print(json.dumps(rec), flush=True)
    return 0


def accumulate_grad_check(spec, params, dev, mesh, batch, side: int, n_cards: int,
                          root: str) -> dict:
    """(h): where there are two cards, each of ``GRAD_PROBES`` in a process
    of its own (:func:`grad_probe`); then, here, the sharded s2d grad step
    (the AccumulateGrad stream-mismatch warning is an error throughout
    phase 14)."""
    probes = {}
    if n_cards >= 2:
        for name in GRAD_PROBES:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--grad-probe", name],
                                 cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True, timeout=CHILD_TIMEOUT_S).stdout
            recs = [json.loads(l) for l in out.splitlines() if l.startswith('{"grad_probe"')]
            if len(recs) != 1:
                raise AssertionError(f"grad probe {name!r} failed:\n{out[-3000:]}")
            probes[name] = recs[0]
    run = _grad_run(spec, params, dev, batch, side, "s2d", mesh)
    rec = {"probes": probes, "sharded_backward_loss": run["loss"],
           "mesh_devices": [str(d) for d in mesh.devices]}
    print(f"(h) AccumulateGrad stream mismatch, one process a probe, two iterations each, "
          f"the warning an error: "
          f"{json.dumps({k: v['warned'] for k, v in probes.items()}) if probes else 'probes not run (one card)'}"
          f"; the sharded s2d backward over {rec['mesh_devices']} with the warning an error: "
          f"ran, loss {run['loss']}", flush=True)
    return rec


def raise_objectness(folded, spec, maps, share: float, conf: float):
    """Add one constant to the objectness bias (channel 4 of each anchor's
    5 + C) of the head conv before each ``yolo`` layer of the folded weights,
    in place: the constant that puts ``share`` (within a quarter of it) of
    the rows of the head maps ``maps`` (the forward of ``folded`` as given)
    above ``conf``, the threshold halfway across the widest gap between
    two consecutive objectness logits there, so that no row sits near it.
    Returns the constant."""
    import torch
    from amyloid_yolo_tpu_torch.graphspec import ConvSpec
    nch = 5 + spec.num_classes
    logits = torch.cat([m.reshape(-1, nch)[:, 4].float() for m in maps])
    k0 = max(4, int(share * logits.numel()))
    top = torch.topk(logits, k0 + k0 // 4 + 1).values  # descending
    lo = k0 - k0 // 4
    k = lo + int(torch.argmax(top[lo - 1:-1] - top[lo:]))  # top[k - 1] passes, top[k] not
    shift = math.log(conf / (1 - conf)) - float(top[k - 1] + top[k]) / 2
    for i in spec.yolo_indices:
        head = spec.layers[i - 1]
        if not isinstance(head, ConvSpec) or head.batch_normalize:
            raise AssertionError(f"layer {i - 1} before yolo layer {i} is not a head conv")
        folded[f"conv_{i - 1}"]["b"][4::nch] += shift
    return shift


def spatial_phase(spec, params, card: str, dev, side: int = 1536) -> dict:
    """Phase 14 (see the module docstring); returns its JSON record.  The
    AccumulateGrad stream-mismatch warning is an error throughout.  On the
    CPU (a rehearsal with a mini spec and a small ``side``) the meshes are
    CPU entries, memory is not read and (d) is left out;
    ``torch.cuda.synchronize`` and ``cuda_ms`` then need host stand-ins."""
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=ACCUMULATE_GRAD_WARNING)
        return _spatial_phase(spec, params, card, dev, side)


def _spatial_phase(spec, params, card: str, dev, side: int) -> dict:
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.models import darknet, heads
    from amyloid_yolo_tpu_torch.ops.nms import non_max_suppression
    from amyloid_yolo_tpu_torch.ops.preprocess import RECIP_255
    from amyloid_yolo_tpu_torch.parallel import spatial
    from amyloid_yolo_tpu_torch.parallel.mesh import tree_to
    from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer
    from amyloid_yolo_tpu_torch.utils.device import no_tf32

    cuda = dev.type == "cuda"
    n_cards = torch.cuda.device_count() if cuda else 0
    pair = [torch.device("cuda", i) for i in range(2)] if n_cards >= 2 else [dev, dev]
    mesh = spatial.make_spatial_mesh(2, devices=pair)
    plan = spatial.row_plan(spec, side, 2)
    rows = [int(n) for n in np.diff(plan.bounds)]
    record = {"cards": n_cards, "mesh_devices": [str(d) for d in mesh.devices],
              "side": side, "batch": SP_B, "coarsest_rows": rows}
    print(f"phase 14 on {n_cards} card(s): sp=2 over {record['mesh_devices']}, {side}x{side} "
          f"at B={SP_B}; the coarsest map's {sum(rows)} rows split {rows} (stride {plan.step})",
          flush=True)
    rng = np.random.RandomState(SEED + 14)
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # (a) spatial_forward and spatial_detect against the unsharded forward,
    # with objectness biases that put SP_OBJ_SHARE of the rows at conf 0.8
    folded = tree_to(darknet.fold_batchnorm(params, spec), dev)
    tiles = torch.from_numpy(np.stack([stain_tile(rng, side, side) for _ in range(SP_B)])).to(dev)
    x = tiles.to(torch.float32) * RECIP_255
    with torch.no_grad(), no_tf32():
        maps = darknet.apply_folded(folded, spec, x, compute_dtype=torch.float32)
    shift = raise_objectness(folded, spec, maps, SP_OBJ_SHARE, SP_DETECT["conf_thres"])
    del maps
    record["objectness_shift"] = shift
    print(f"(a) objectness biases of the head convs raised by {shift:.4f}, so that "
          f"{SP_OBJ_SHARE} of the unsharded forward's rows pass conf "
          f"{SP_DETECT['conf_thres']}", flush=True)

    def sharded_forward():
        return spatial.spatial_forward(folded, spec, x, mesh)

    def sharded_detect(conf_thres=SP_DETECT["conf_thres"]):
        return spatial.spatial_detect(folded, spec, tiles, mesh,
                                      **dict(SP_DETECT, conf_thres=conf_thres))

    def one_forward():
        with torch.no_grad(), no_tf32():
            maps = darknet.apply_folded(folded, spec, x, compute_dtype=torch.float32)
            return heads.decode_all(maps, spec, side)

    _free(mesh.devices)
    _reset_peaks(mesh.devices)
    reset_launch_counts()
    pred = sharded_forward()
    detected = {t: sharded_detect(t) for t in SP_CONFS}
    _sync(mesh.devices)
    add(launch_counts())
    sp_peak = _peak_gib(mesh.devices)
    _free([dev])
    _reset_peaks([dev])
    ref = one_forward()
    _sync([dev])
    one_peak = _peak_gib([dev])
    conf = ref[..., 4]
    passing = {t: (conf >= t).sum(1).cpu().tolist() for t in (0.3, 0.5, 0.8, 0.9)}
    diff = (pred - ref).abs()
    pred_excess = float((diff - (SP_PRED_ATOL + SP_PRED_RTOL * ref.abs())).max())
    nms = {}
    for t, (dets, valid, ncand) in detected.items():
        rd, rv, rn = non_max_suppression(ref, t, SP_DETECT["nms_thres"], SP_DETECT["capacity"],
                                         return_count=True)
        nms[t] = {"n_candidates": ncand.cpu().tolist(), "n_candidates_one": rn.cpu().tolist(),
                  "valid": valid.sum(1).cpu().tolist(),
                  "counts_equal": bool(torch.equal(ncand, rn)),
                  "valid_equal": bool(torch.equal(valid, rv)),
                  "det_excess": float(((dets - rd).abs() - SP_DET_TOL * (1 + rd.abs())).max()),
                  "nearest_conf_to_thres": float((conf - t).abs().min())}
    fwd_ms = cuda_ms(sharded_forward, iters=5, warmup=1, hold=False)
    det_ms = cuda_ms(sharded_detect, iters=5, warmup=1, hold=False)
    one_ms = cuda_ms(one_forward, iters=5, warmup=1, hold=False)
    record["forward"] = {
        "pred_shape": list(pred.shape), "max_abs_diff": float(diff.max()),
        "pred_excess": pred_excess, "passing_by_conf": passing, "detect": nms,
        "forward_ms": fwd_ms, "detect_ms": det_ms, "one_forward_ms": one_ms,
        "peak_gib": sp_peak, "one_peak_gib": one_peak}
    print(f"(a) spatial_forward f32 (TF32 off), {side}x{side} B={SP_B}, against the unsharded "
          f"forward on {dev}: predictions {tuple(pred.shape)}, max|diff| {float(diff.max()):.4g} "
          f"(tolerance rtol {SP_PRED_RTOL} atol {SP_PRED_ATOL}; worst excess {pred_excess:.3g}); "
          f"rows at conf >= t, unsharded: {passing}; spatial_detect {SP_DETECT} at conf "
          f"{list(SP_CONFS)} against the unsharded pipeline (n_candidates and valid equal, dets "
          f"within rtol/atol {SP_DET_TOL}): {json.dumps(nms)}; ms a call (CUDA events, "
          f"5 after 1, host included): spatial_forward {fwd_ms:.2f}, spatial_detect "
          f"{det_ms:.2f}, unsharded forward {one_ms:.2f}; peak GiB {sp_peak} (unsharded "
          f"{one_peak}) [{card}]", flush=True)
    if pred_excess > 0 or not torch.isfinite(pred).all():
        raise AssertionError("spatial_forward disagrees with the unsharded forward")
    if not all(r["counts_equal"] and r["valid_equal"] and r["det_excess"] <= 0
               for r in nms.values()):
        raise AssertionError("spatial_detect disagrees with the unsharded pipeline")
    if not all(sum(r["n_candidates_one"]) > 0 for r in nms.values()):
        raise AssertionError(f"a conf of {list(SP_CONFS)} has no candidates: the comparison "
                             "there is empty")
    del folded, pred, ref, detected, x

    # (b) the height-sharded train step against the one-device step
    batch = train_batch(rng, SP_B, side)
    one = _step_run(spec, params, dev, batch, side)
    sp = _step_run(spec, params, dev, batch, side, mesh)
    add(sp["launches"])
    loss_rel = abs(sp["loss"] - one["loss"]) / abs(one["loss"])
    close = _params_close(sp.pop("after"), one.pop("after"))
    bf16 = _step_run(spec, params, dev, batch, side, mesh, torch.bfloat16)
    bf16_finite = math.isfinite(bf16["loss"]) and all(
        bool(torch.isfinite(v).all()) for v in bf16.pop("after").values()
        if v.is_floating_point())
    add(bf16["launches"])
    per_image = {k: v / SP_B for k, v in one["peak_gib"].items()}
    record["step"] = {"loss": sp["loss"], "loss_one": one["loss"], "loss_rel": loss_rel, **close,
                      "step_ms": sp["step_ms"], "one_step_ms": one["step_ms"],
                      "peak_gib": sp["peak_gib"], "one_peak_gib": one["peak_gib"],
                      "one_peak_gib_per_image": per_image, "bf16_loss": bf16["loss"],
                      "bf16_peak_gib": bf16["peak_gib"]}
    print(f"(b) height-sharded train step over {record['mesh_devices']}, B={SP_B} at {side}, "
          f"float32 with TF32 off, one apply: loss {sp['loss']} vs the one-device step "
          f"{one['loss']} (rel {loss_rel:.3g}, tolerance {DP_LOSS_RTOL}); parameters within "
          f"rtol 1e-4 / atol 2.05 lr (worst excess {close['param_worst_excess']}); BN running "
          f"stats worst rel {close['stat_worst_rel']} (tolerance {STEP_RTOL}); the next "
          f"{DP_TIMED_STEPS} steps {sp['step_ms']:.1f} ms each against {one['step_ms']:.1f} ms "
          f"on one device (host clock, mean); peak GiB {sp['peak_gib']} against "
          f"{one['peak_gib']} ({per_image} an image); bf16 sharded step loss {bf16['loss']}, "
          f"parameters finite {bf16_finite}, peak GiB {bf16['peak_gib']} [{card}]", flush=True)
    if loss_rel > DP_LOSS_RTOL or not bf16_finite:
        raise AssertionError("the height-sharded train step disagrees with the one-device step")

    # (c) Trainer(spatial_shard=2): one short epoch on synthetic tiles
    root = tempfile.mkdtemp(prefix="phase14_")
    try:
        data = write_train_set(root, SEED + 14, side=side, **SP_TRAIN_SET)
        cfg = TrainConfig(data_config=data, epochs=1, batch_size=SP_B, gradient_accumulations=1,
                          img_size=side, multiscale=False, augment=True, spatial_shard=2,
                          learning_rate=TRAIN_LR, evaluation_interval=0,
                          checkpoint_dir=os.path.join(root, "ckpts"),
                          logdir=os.path.join(root, "logs"))
        tr = Trainer(cfg, spec=spec, device=",".join(str(d) for d in mesh.devices))
        losses = []
        t0 = time.perf_counter()
        tr.train(callback=lambda epoch, bi, m: losses.append(m["loss"]))
        wall = time.perf_counter() - t0
        losses = torch.stack(losses).cpu().tolist()
        want_steps = SP_TRAIN_SET["n_train"] // SP_B
        record["trainer"] = {"losses": losses, "step": tr.state.step, "seen": tr.state.seen,
                             "wall_s": wall, "checkpoints": sorted(os.listdir(cfg.checkpoint_dir))}
        print(f"(c) Trainer(spatial_shard=2, device={','.join(record['mesh_devices'])}), one "
              f"epoch of {want_steps} batches of {SP_B} at {side}, augment on: losses "
              f"{losses}, step {tr.state.step}, seen {tr.state.seen}, {wall:.2f} s with the "
              f"checkpoint [{card}]", flush=True)
        if len(losses) != want_steps or not all(math.isfinite(l) for l in losses) \
                or tr.state.step != want_steps:
            raise AssertionError("the spatially sharded Trainer did not train")
        del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (e), (f) the s2d stem and the matmul BN form on the row shards
    form_counts = {}
    reset_launch_counts()
    record["forms"] = sharded_forms(spec, params, dev, mesh, batch, side, card)
    form_counts.update(launch_counts())

    # (g) step ms and peak GiB per card, plain, s2d and matmul, sharded
    times = {"plain": {"step_ms": sp["step_ms"], "peak_gib": sp["peak_gib"]}}
    for form in ("s2d", "matmul"):
        run = _step_run(spec, params, dev, batch, side, mesh, form=form)
        run.pop("after")
        form_counts = {k: form_counts.get(k, 0) + v for k, v in run["launches"].items()}
        times[form] = {"step_ms": run["step_ms"], "peak_gib": run["peak_gib"],
                       "loss": run["loss"]}
    record["form_times"] = times
    print(f"(g) height-sharded f32 train step over {record['mesh_devices']}, B={SP_B} at "
          f"{side}, one apply then {DP_TIMED_STEPS} timed (host clock, mean), peak GiB a "
          f"card: " + "; ".join(f"{k} {v['step_ms']:.1f} ms, {v['peak_gib']}"
                                for k, v in times.items()) + f" [{card}]", flush=True)

    # (h) the AccumulateGrad stream mismatch
    reset_launch_counts()
    record["accumulate_grad"] = accumulate_grad_check(spec, params, dev, mesh, batch, side,
                                                      n_cards, os.path.dirname(
                                                          os.path.abspath(__file__)))
    form_counts = {k: form_counts.get(k, 0) + v for k, v in launch_counts().items()}
    add(form_counts)
    record["forms_launches"] = form_counts

    # (d) four cards: sp=4 at the reference recipe's batch
    if n_cards >= 4:
        mesh4 = spatial.make_spatial_mesh(4)
        batch8 = train_batch(rng, SP_B4, side)
        sp4 = _step_run(spec, params, dev, batch8, side, mesh4)
        add(sp4["launches"])
        sp4.pop("after")
        probe = {}
        try:
            one8 = _step_run(spec, params, dev, batch8, side)
            one8.pop("after")
            probe = {"fits": True, "peak_gib": one8["peak_gib"], "step_ms": one8["step_ms"],
                     "loss": one8["loss"],
                     "loss_rel": abs(sp4["loss"] - one8["loss"]) / abs(one8["loss"])}
        except torch.cuda.OutOfMemoryError as e:
            probe = {"fits": False, "error": str(e).splitlines()[0]}
        _free([dev])
        record["four_cards"] = {"mesh_devices": [str(d) for d in mesh4.devices],
                                "loss": sp4["loss"], "step_ms": sp4["step_ms"],
                                "peak_gib": sp4["peak_gib"], "unsharded_b8": probe}
        print(f"(d) sp=4 over {record['four_cards']['mesh_devices']}, B={SP_B4} at {side}, f32: "
              f"loss {sp4['loss']}, the next {DP_TIMED_STEPS} steps {sp4['step_ms']:.1f} ms "
              f"each (host clock, mean); peak GiB a card {sp4['peak_gib']} (the unsharded B="
              f"{SP_B} step: {per_image} an image); the unsharded B={SP_B4} step on {dev}: "
              f"{probe} [{card}]", flush=True)
        if probe.get("fits") and probe["loss_rel"] > DP_LOSS_RTOL:
            raise AssertionError("sp=4 and the unsharded B=8 step disagree")
    record["launches"] = counts
    print(f"phase 14 launches of K1/K2/K3 on the spatial path: {counts} (want 0 each)", flush=True)
    if any(counts.values()):
        raise AssertionError(f"the spatial path launched kernels: {counts}")
    return record


# --------------------------------------------------------------------------
# phase 15: the study path
# --------------------------------------------------------------------------

STUDY_CONF = 0.3           # random weights put no detection at the reference's 0.8
STUDY_B = 8                # (a) the validation run's batch
STUDY_SPEED_BATCHES = (1, 8)  # (c) speed_check's batches
STUDY_JITTER = 2           # (b) NP2: NP1's boxes moved by at most this many pixels
STUDY_IOU = 0.5            # (b) the TP, precision and interrater checks
PREPROCESS_TOL = 1e-4      # (d) weak labels, card vs CPU float32
STUDY_LIBS = ("pandas", "matplotlib", "sklearn")


def _prediction_entries(dets, classes=("CAA", "Cored")) -> list:
    """(N, 7) rows as the predictions pickle holds them
    (``run_model_on_validation_images``)."""
    return [({"x1": float(r[0]), "x2": float(r[2]), "y1": float(r[1]), "y2": float(r[3]),
              "conf": float(r[4]), "cls_conf": float(r[5]), "cls_pred": float(r[6])},
             classes[int(r[6])]) for r in dets]


def study_annotators(preds, seed: int) -> tuple:
    """Annotator sets built from the predictions: NP1 an exact copy of the
    boxes of the first half of the images (class from ``cls_pred``), empty on
    the rest; NP2 NP1 moved by at most ``STUDY_JITTER`` px; NP3 NP2 emptied
    on two of the copied images.  Returns (sets, copied image names)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    names = sorted(preds)
    copied = names[: len(names) // 2]
    np1 = {n: ([({k: d[k] for k in ("x1", "y1", "x2", "y2")}, ("CAA", "Cored")[int(d["cls_pred"])])
                for d, _ in preds[n]] if n in copied else []) for n in names}
    np2 = {n: [({k: v + int(rng.randint(-STUDY_JITTER, STUDY_JITTER + 1)) for k, v in d.items()},
                c) for d, c in e] for n, e in np1.items()}
    emptied = [n for n in copied if np1[n]][:2]
    np3 = {n: ([] if n in emptied else e) for n, e in np2.items()}
    return {"NP1": np1, "NP2": np2, "NP3": np3}, copied


def write_study_csvs(root: str, tiles, seed: int) -> str:
    """The two CSVs of ``pre_process`` over ``tiles`` (hard-linked under
    ``root/images`` with the names it builds): 12 boxes, 4 of them labelled
    in the consensus CSV.  Returns the images directory."""
    import numpy as np
    import pandas as pd
    rng = np.random.RandomState(seed)
    images = os.path.join(root, "images")
    os.makedirs(images)
    names = []
    for k, src in enumerate(tiles):
        names.append((f"S{k}", k, 2 * k + 1))
        os.link(src, os.path.join(images, f"S{k}_0_{k}_{2 * k + 1}.jpg"))
    details, consensus = [], []
    for k in range(12):
        source, r, c = names[k % len(names)]
        x, y = rng.randint(0, 1400, 2)
        w, h = rng.randint(20, 200, 2)
        name = f"{source}/blob_{k}.jpg"
        details.append({"imagename": name, "source": source, "tile_row": r, "tile_column": c,
                        "blob coordinates (xywh)": f"[{x} {y} {w} {h}]"})
        if k % 3 == 0:
            consensus.append({"imagename": f"set/{name}", "cored": k % 2, "diffuse": 1,
                              "CAA": 1 - k % 2})
    pd.DataFrame(details).to_csv(os.path.join(root, "details.csv"), index=False)
    pd.DataFrame(consensus).to_csv(os.path.join(root, "consensus.csv"), index=False)
    return images + "/"


def study_phase(spec, params, card: str, dev, size: int = 416, folder_kw=None) -> dict:
    """Phase 15 (see the module docstring); returns its JSON record.
    ``size`` and ``folder_kw`` cut it down for a rehearsal on the CPU, where
    ``torch.cuda.synchronize`` needs a host stand-in and the launch counts
    are 0."""
    import importlib.util
    import pickle

    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.analysis import plots, prospective
    from amyloid_yolo_tpu_torch.analysis.validation import speed_check
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.domain import CAAFilter, get_tps, pre_process
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.models import classifier

    cuda = dev.type == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    libs = {m: importlib.util.find_spec(m) is not None for m in STUDY_LIBS}
    print(f"phase 15, the study path: host libraries found {libs}", flush=True)
    record = {"libraries": libs}
    det = Detector(spec, params, conf_thres=STUDY_CONF, nms_thres=0.4, model_size=size,
                   device=dev)
    cparams = classifier.from_jax_params(random_classifier_params(SEED))
    caa = CAAFilter(cparams, device=dev)
    folder_kw = dict(FOLDER, **(folder_kw or {}))
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "images")
        os.makedirs(folder)
        readable, *_ = write_folder(folder, SEED + 15, **folder_kw)

        # (a) the predictions, through Detector.detect_folder
        n_batches = -(-len(readable) // STUDY_B)
        pkl = os.path.join(tmp, "pickles", "prospective_validation_predictions.pkl")
        walls = []
        for run in range(2):
            reset_launch_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                preds = prospective.run_model_on_validation_images(
                    det, folder, pkl, caa_filter=caa, merge=True, batch_size=STUDY_B)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            if run == 0:
                counts = launch_counts()
        with open(pkl, "rb") as fh:
            stored = pickle.load(fh)
        with contextlib.redirect_stdout(io.StringIO()):
            want, _, _ = recompute_folder(det, folder, STUDY_B, caa)
        want = {os.path.basename(p): ([] if d is None else _prediction_entries(d))
                for p, d in want.items()}
        n_rows = sum(len(v) for v in preds.values())
        record["predictions"] = {"tiles": len(readable), "batches": n_batches, "rows": n_rows,
                                 "launches": counts, "wall_s": walls,
                                 "tiles_per_s": [len(readable) / w for w in walls]}
        print(f"(a) run_model_on_validation_images over {len(readable)} tiles at B={STUDY_B} "
              f"(merge, CAA filter; conf {STUDY_CONF}): {n_rows} rows in {len(preds)} images; "
              f"launches {counts} over {n_batches} batches; wall {[round(w, 3) for w in walls]} "
              f"s = {[round(len(readable) / w, 1) for w in walls]} tiles/s (the first run "
              f"checked, host clock) [{card}]", flush=True)
        want_counts = {"resize_normalize": n_batches if cuda else 0,
                       "fused_residual_block": 23 * n_batches if cuda else 0,
                       "fused_residual_block_int8": 0}
        if counts != want_counts:
            raise AssertionError(f"the study path launched {counts}, want {want_counts}")
        if stored != preds or preds != want:
            raise AssertionError("the predictions pickle differs from detect_folder's "
                                 "explicit recomputation")
        if n_rows == 0 or sorted(preds) != sorted(os.path.basename(p) for p in readable):
            raise AssertionError("the study's predictions are empty or miss an image")

        # (b) the analysis, on annotator sets with known content
        by_np, copied = study_annotators(preds, SEED + 15)
        n_copied = sum(len(by_np["NP1"][n]) for n in copied)
        flags = {n: get_tps([[d["x1"], d["y1"], d["x2"], d["y2"], d["conf"], d["cls_conf"],
                               d["cls_pred"]] for d, _ in preds[n]],
                              [[d["x1"], d["y1"], d["x2"], d["y2"], int(c == "Cored")]
                               for d, c in by_np["NP1"][n]], STUDY_IOU) for n in preds}
        n_tp = sum(sum(f) for f in flags.values())
        pair = prospective.get_interrater_agreement(by_np, STUDY_IOU)[("NP1", "NP2")]
        present = {c for e in by_np["NP1"].values() for _, c in e}
        consensus = prospective.create_merged_or_consensus_benchmark(by_np, "consensus",
                                                                     STUDY_IOU)
        relative = prospective.get_precisions_of_annotators_relative_to_each_other(
            by_np, iou_thresholds=[STUDY_IOU])
        record["analysis"] = {"copied_rows": n_copied, "tp_at_0.5": n_tp,
                              "interrater_np1_np2": pair,
                              "consensus_rows": sum(len(v) for v in consensus.values()),
                              "relative_precision": {c: relative[c]["NP1"]["NP2"][STUDY_IOU]
                                                     for c in present}}
        print(f"(b) NP1 copies {n_copied} rows of {len(copied)} images: TPs at IoU {STUDY_IOU} "
              f"{n_tp}; interrater NP1-NP2 {pair}; consensus {record['analysis']['consensus_rows']}"
              f" boxes; NP2's precision against NP1 {record['analysis']['relative_precision']}",
              flush=True)
        if n_tp != n_copied or n_copied == 0:
            raise AssertionError(f"{n_tp} TPs at IoU {STUDY_IOU}, want the {n_copied} copied rows")
        if not all(all(flags[n]) for n in copied):
            raise AssertionError("a copied image has a prediction that is not a TP")
        if any(pair[c] != 1.0 for c in present):
            raise AssertionError(f"NP2 (NP1 moved by <= {STUDY_JITTER} px) disagrees with NP1")
        if libs["pandas"]:
            prc_dir, maps_dir = os.path.join(tmp, "PRC_tables"), os.path.join(tmp, "maps")
            ious = [round(t, 2) for t in np.arange(0.1, 1.0, 0.1)]
            annotators = ["consensus"] + sorted(by_np)
            for t in ious:
                sets = dict(by_np, consensus=prospective.create_merged_or_consensus_benchmark(
                    by_np, "consensus", t))
                for a in annotators:
                    frames = prospective.compare_annotations_to_predictions(
                        sets[a], preds, t, a, prc_dir=prc_dir, precision_maps_dir=maps_dir)
                    if a == "NP1" and t == STUDY_IOU:
                        table_tp = sum(int(f["TP"].sum()) for f in frames.values())
            ap_map = prospective.ap_map_from_tables(prc_dir, annotators, iou_thresholds=ious)
            precision = {}
            for cls in prospective.AMYLOID_CLASSES:
                with open(os.path.join(maps_dir, f"prospective_precision_img_map_{cls}_NP1_"
                                                 f"{STUDY_IOU}.pkl"), "rb") as fh:
                    precision[cls] = {n: v for n, v in pickle.load(fh).items() if n in copied}
            record["analysis"].update({
                "prc_tables": len(os.listdir(prc_dir)), "tp_in_table_at_0.5": table_tp,
                "ap_np1_at_0.5": {c: ap_map["NP1"][c][STUDY_IOU] for c in ap_map["NP1"]},
                "ap_branch": "sklearn" if libs["sklearn"] else "numpy"})
            print(f"(b) PRC tables {len(os.listdir(prc_dir))} (IoU 0.1-0.9 x {annotators} x 2 "
                  f"classes): NP1's TPs at {STUDY_IOU} {table_tp}; NP1's AP at {STUDY_IOU} "
                  f"{record['analysis']['ap_np1_at_0.5']} ({record['analysis']['ap_branch']} "
                  f"branch); precision of the copied images {precision}", flush=True)
            if table_tp != n_copied:
                raise AssertionError(f"the PRC table counts {table_tp} TPs, want {n_copied}")
            if any(v not in (1.0, -1) for m in precision.values() for v in m.values()) \
                    or not any(v == 1.0 for m in precision.values() for v in m.values()):
                raise AssertionError("precision is not 1.0 on the copied images")
        figures = os.path.join(tmp, "figures")
        plots.plot_all_annotations(by_np, folder, output_dir=os.path.join(figures, "all"))
        plots.plot_image_comparisons(by_np["NP1"], preds, folder, os.path.join(figures, "cmp"))
        if libs["matplotlib"] and libs["pandas"]:
            plots.plot_aps_for_prospective(prc_dir, figures_dir=figures, annotators=annotators)
            plots.plot_interrater_agreement(
                prospective.get_interrater_agreement(by_np, STUDY_IOU), figures_dir=figures,
                annotators=sorted(by_np))
        n_figures = sum(len(files) for _, _, files in os.walk(figures))
        record["analysis"]["figures"] = n_figures
        print(f"(b) figures written: {n_figures} (the PIL overlays"
              f"{' and the matplotlib plots' if libs['matplotlib'] and libs['pandas'] else ''})",
              flush=True)

        # (c) speed_check over a two-WSI tree of the folder's tiles
        tree = os.path.join(tmp, "wsis")
        half = len(readable) // 2
        n_tree = len(write_wsi_tree(tree, [("WSI_A", readable[:half], -(-half // 2)),
                                           ("WSI_B", readable[half:],
                                            -(-(len(readable) - half) // 2))]))
        t0 = time.perf_counter()
        times = speed_check(tree, det, caa_filter=caa, include_merge_and_filter=True,
                            batch_sizes=STUDY_SPEED_BATCHES,
                            pickles_dir=os.path.join(tmp, "pickles"))
        speed_wall = time.perf_counter() - t0
        record["speed_check"] = {str(b): {k: v for k, v in t.items()
                                          if k not in ("machine", "time spent")}
                                 for b, t in times.items()}
        record["speed_check"]["wall_s"] = speed_wall
        for b, t in times.items():
            print(f"(c) speed_check B={b}, merge and CAA filter on, {n_tree} tiles in 2 WSIs: "
                  f"model time {t['model time spent']:.3f} s, down time {t['down time']:.3f} s, "
                  f"{t['avg time / 1536 img']:.4f} s a tile, {t['avg time / WSI']:.3f} s a WSI "
                  f"(host clock) [{card}]", flush=True)
            if t["num 1536 images"] != n_tree:
                raise AssertionError(f"speed_check counted {t['num 1536 images']} tiles of "
                                     f"{n_tree}")
        if not any(n.startswith("run_times_") for n in os.listdir(os.path.join(tmp, "pickles"))):
            raise AssertionError("speed_check wrote no pickle")

        # (d) pre_process with weak labels from the CAA filter on the card
        csv_root = os.path.join(tmp, "csvs")
        images_dir = write_study_csvs(csv_root, readable[:3], SEED + 15)
        csvs = (os.path.join(csv_root, "details.csv"), os.path.join(csv_root, "consensus.csv"))
        t0 = time.perf_counter()
        weak = pre_process(*csvs, images_dir=images_dir, weak_label=True, caa_filter=caa)
        weak_s = time.perf_counter() - t0
        ref = pre_process(*csvs, images_dir=images_dir, weak_label=True,
                          caa_filter=CAAFilter(cparams, device="cpu"))
        rows = [(g, w) for k in ref for g, w in zip(weak.get(k, []), ref[k])]
        err = max((abs(a - b) for (gb, gl), (wb, wl) in rows for a, b in zip(gl, wl)),
                  default=float("inf"))
        n_weak = sum(1 for _, (_, wl) in rows if not isinstance(wl[0], int))
        record["pre_process"] = {"rows": len(rows), "weak_rows": n_weak, "max_abs_err": err,
                                 "s": weak_s}
        print(f"(d) pre_process(weak_label=True): {len(rows)} boxes, {n_weak} weak labels from "
              f"the CAA filter on {dev}; max |card - CPU f32| {err:.3g} (tolerance "
              f"{PREPROCESS_TOL}); {weak_s:.2f} s", flush=True)
        if list(weak) != list(ref) or len(rows) != 12 or n_weak != 8 or err > PREPROCESS_TOL \
                or any(gb != wb for (gb, _), (wb, _) in rows):
            raise AssertionError("pre_process on the card disagrees with the CPU")

        # (e) the study script, in a process of its own
        work = os.path.join(tmp, "study")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join("examples", "run_study_torch.py"),
                               "--synthetic", "--workdir", work, "--device", str(dev)],
                              capture_output=True, text=True, timeout=600, cwd=root)
        script_s = time.perf_counter() - t0
        stages = [l for l in proc.stdout.splitlines() if l.startswith("[")]
        record["script"] = {"rc": proc.returncode, "s": script_s, "stages": stages}
        print(f"(e) examples/run_study_torch.py --synthetic: exit {proc.returncode} in "
              f"{script_s:.1f} s; {stages}", flush=True)
        if proc.returncode != 0 or not all(any(l.startswith(f"[{k}/5]") for l in stages)
                                           for k in range(1, 6)):
            raise AssertionError(f"the study script failed:\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
    record["launches"] = counts
    return record


# --------------------------------------------------------------------------
# phase 16: the layout options (space-to-depth stem and downsample, planar
# images, BN statistics as products)
# --------------------------------------------------------------------------

S2D_F32_TOL = 1e-4        # (a) max |s2d - plain| / max |plain| per head, float32, TF32 off
# (b) the int8_full s2d stem against the plain stem: conv 0's float32 sums in
# another order flip some of its int8 levels, and YOLOv3's 70 int8 layers
# carry the flips to the heads.  The mini spec's bound (0.02 of the map,
# tests/test_s2d_stem.py:133) does not hold at full depth: the first run on
# the card (H100, 416, B=8) measured 0.0437, 0.0139, 0.00487.  So each head
# must lie within HEAD_TOL (phase 7's bound on the int8 maps, card against
# CPU) and no further from the plain stem's map than that map lies from the
# float32 Detector's (the int8 path's own error)
S2D_LOSS_RTOL = 2e-4      # (c) loss, s2d against the plain stem (tests/test_s2d_train.py:64)
PLANAR_TOL = 1e-5         # (c) augmented images, planar against nhwc
BN_FORM_LOSS_RTOL = 1e-4  # (c) loss, bn_form "matmul" against "reduce"
BN_FORM_STAT_RTOL = 1e-5  # (c) new BN statistics, the same (tests/test_bnstats.py:95-108)
# (c) The statistics' bounds come from the mini spec.  Through YOLOv3's 72 BN
# layers each layer's reordered sums move the next one's input, and a CPU
# rehearsal at 64², B=2 put s2d and matmul at 6.0e-5 of a tensor's largest
# value, with three other orders of the batch at up to 3.3e-5: so each bound
# is the larger of the stated one and STEP_GRAD_NOISE_FACTOR times the worst
# of those orders (phase 11's noise rule)
TIME_RUNS = 3             # (d) timings: runs of cuda_ms, their spread printed
# (c) gradients, s2d against plain.  In float32 the stem's other summation
# order flips leaky slopes of units near zero downstream, and the gradients
# move by more than phase 11's noise rule allows (a CPU rehearsal at 64², B=2:
# median 1.1e-3 and worst 2.3e-2 against 1.3e-4 and 2.6e-3 for the plain step
# with the batch reversed), so float32 is held to the JAX suite's rule for
# this pair, the cosine of the whole gradient (tests/test_s2d_train.py:152),
# and the reparameterization itself in float64, where no slope flips (the
# rehearsal: 1.2e-13)
S2D_GRAD_COS = 0.999
S2D_F64_GRAD_RTOL = 1e-9


def _head_rel(maps, ref) -> list:
    return [float((m.float() - r.float()).abs().max() / r.float().abs().max())
            for m, r in zip(maps, ref)]


def _stat_rel(stats, ref) -> tuple:
    rel = {k: float((v - ref[k]).abs().max() / ref[k].abs().max().clamp(min=1e-30))
           for k, v in stats.items()}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def _spread(fn, **kw) -> dict:
    import numpy as np
    runs = [cuda_ms(fn, **kw) for _ in range(TIME_RUNS)]
    return {"runs_ms": runs, "median_ms": float(np.median(runs)), "min_ms": min(runs),
            "max_ms": max(runs)}


def _f64_grads(spec, params, dev, imgs, size: int, s2d: bool) -> dict:
    """Gradients of a smooth loss of the head maps (``Σ m² + m·r``, ``r``
    seeded noise) through the float64 train forward, for ``imgs`` (uint8
    NHWC) resized to ``size``."""
    import torch
    from amyloid_yolo_tpu_torch.models import darknet
    from amyloid_yolo_tpu_torch.ops.preprocess import preprocess_tiles
    from amyloid_yolo_tpu_torch.parallel import steps
    f64 = torch.float64
    p = {k: (v.to(dev, f64).requires_grad_(True) if k.endswith((".weight", ".bias"))
             else v.to(dev, f64) if v.is_floating_point() else v.to(dev))
         for k, v in params.items()}
    x = preprocess_tiles(torch.as_tensor(imgs).to(dev), size).to(f64)
    maps, _ = darknet.apply(p, spec, x, train=True, s2d_stem=s2d, compute_dtype=f64,
                            bn_form="reduce")
    gen = torch.Generator().manual_seed(SEED)
    total = sum((m * m + m * torch.randn(m.shape, generator=gen, dtype=f64).to(dev)).sum()
                for m in maps)
    keys = steps.trainable_keys(p)
    return dict(zip(keys, torch.autograd.grad(total, [p[k] for k in keys])))


def layout_phase(spec, params, card: str, dev, size: int = 416, side: int = 1536,
                 batch: int = 8, big: int = 32) -> dict:
    """Phase 16: the reference's layout options on the main path's entry
    points, at the full width with phase 6's weights (see the module
    docstring); returns its JSON record.  ``size``, ``side``, ``batch`` and
    ``big`` cut it down for a rehearsal on the CPU, where ``torch.cuda``'s
    events and ``synchronize`` need host stand-ins and the launch counts
    are 0."""
    import argparse

    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.cli.main import _fast_path_kwargs
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.models import darknet
    from amyloid_yolo_tpu_torch.ops.loss import yolo_loss
    from amyloid_yolo_tpu_torch.parallel import steps
    from amyloid_yolo_tpu_torch.utils.device import no_tf32

    cuda = dev.type == "cuda"
    want = ({"resize_normalize": 3, "fused_residual_block": 69, "fused_residual_block_int8": 0}
            if cuda else {"resize_normalize": 0, "fused_residual_block": 0,
                          "fused_residual_block_int8": 0})
    want_int8 = dict(want, fused_residual_block=0)
    record = {"card": card}
    rng = np.random.RandomState(SEED + 16)
    batches = [rng.randint(0, 256, (batch, side, side, 3)).astype(np.uint8) for _ in range(3)]
    kw = dict(conf_thres=0.3, model_size=size, device=dev)
    print(f"phase 16, the layout options, at {size} on {side}² tiles [{card}]", flush=True)

    # (a) the bf16 Detector with the s2d stem, and float32 s2d against plain
    plain = Detector(spec, params, **kw)
    s2d = Detector(spec, params, s2d_stem=True, **kw)
    drive(s2d, batches, want)
    record["bf16_launches"] = launch_counts()
    tiles = torch.from_numpy(batches[0]).to(dev)
    with torch.inference_mode():
        bf16_rel = _head_rel(s2d.head_maps(tiles), plain.head_maps(tiles))
        f32 = [Detector(spec, params, compute_dtype=torch.float32, s2d_stem=flag, **kw)
               for flag in (True, False)]
        f32_rel = _head_rel(f32[0].head_maps(tiles), f32[1].head_maps(tiles))
    record.update(bf16_head_rel=bf16_rel, f32_head_rel=f32_rel)
    print(f"(a) bf16 s2d Detector head maps max|s2d-plain|/max|plain| "
          f"{[f'{r:.3g}' for r in bf16_rel]} (tolerance {HEAD_TOL}); float32 (TF32 off) "
          f"{[f'{r:.3g}' for r in f32_rel]} (tolerance {S2D_F32_TOL}) [{card}]", flush=True)
    if max(bf16_rel) > HEAD_TOL or max(f32_rel) > S2D_F32_TOL:
        raise AssertionError("the s2d stem's head maps disagree with the plain stem's")
    del f32

    # (b) int8_full with the s2d stem, then the s2d downsample, on one calibration
    full = Detector(spec, params, precision="int8_full", **kw)
    full.calibrate(batches[0])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_layout_")
    sidecar = full.save_calibration(os.path.join(tmp, "int8_full.json"))
    int8 = {}
    for name, opts in (("s2d", dict(s2d_stem=True)),
                       ("s2d_down", dict(s2d_stem=True, s2d_downsample=True)),
                       ("s2d_i32", dict(s2d_stem=True, int32_accum_max_hw=416)),
                       ("s2d_down_i32", dict(s2d_stem=True, s2d_downsample=True,
                                             int32_accum_max_hw=416))):
        int8[name] = Detector(spec, params, precision="int8_full", **opts, **kw)
        int8[name].load_calibration(sidecar)
    record["int8_launches"] = {}
    for name in ("s2d", "s2d_down"):
        drive(int8[name], batches, want_int8)
        record["int8_launches"][name] = launch_counts()
    with torch.inference_mode():
        ref = full.head_maps(tiles)
        stem_rel = _head_rel(int8["s2d"].head_maps(tiles), ref)
        f32 = Detector(spec, params, compute_dtype=torch.float32, **kw)
        quant_rel = _head_rel(ref, f32.head_maps(tiles))
        del f32
        down_rel = _head_rel(int8["s2d_down"].head_maps(tiles), int8["s2d"].head_maps(tiles))
        exact = [torch.equal(a, b) for a, b in zip(int8["s2d_down_i32"].head_maps(tiles),
                                                   int8["s2d_i32"].head_maps(tiles))]
    record.update(int8_stem_rel=stem_rel, int8_plain_vs_f32_rel=quant_rel,
                  int8_down_rel_bf16_accum=down_rel,
                  int8_down_bitexact_int32_accum=exact)
    print(f"(b) int8_full s2d stem head maps max|s2d-plain|/max|plain| "
          f"{[f'{r:.3g}' for r in stem_rel]} (tolerance {HEAD_TOL}, and each within the plain "
          f"int8_full's own distance from the float32 Detector: "
          f"{[f'{r:.3g}' for r in quant_rel]}); the s2d downsample "
          f"against the plain conv 5: bit-exact at int32_accum_max_hw=416 {exact} (tolerance: "
          f"bit-exact), at the default bf16 rounding {[f'{r:.3g}' for r in down_rel]} (not a "
          f"check) [{card}]", flush=True)
    if (max(stem_rel) > HEAD_TOL or any(a > b for a, b in zip(stem_rel, quant_rel))
            or not all(exact)):
        raise AssertionError("the int8_full s2d options disagree with the plain int8_full")
    del int8["s2d_i32"], int8["s2d_down_i32"]

    # (c) training: s2d against plain, planar against nhwc, matmul against reduce
    reset_launch_counts()
    imgs, t, m = train_batch(np.random.RandomState(SEED + 17), batch, side)
    grad = {name: steps.make_grad_step(spec, s2d_stem=flag)(
        {k: v.to(dev) for k, v in params.items()}, imgs, t, m, size)
        for name, flag in (("s2d", True), ("plain", False))}
    t_swapped = t.copy()
    t_swapped[:, 0] = batch - 1 - t_swapped[:, 0]
    swapped = steps.make_grad_step(spec)({k: v.to(dev) for k, v in params.items()},
                                         imgs[::-1].copy(), t_swapped, m, size)
    ref_g = grad["plain"][1]

    def grad_rel(grads):
        return {k: float(torch.linalg.vector_norm(g - ref_g[k])
                         / torch.linalg.vector_norm(ref_g[k]).clamp(min=1e-30))
                for k, g in grads.items()}

    g_rel, noise = grad_rel(grad["s2d"][1]), grad_rel(swapped[1])
    flat = [torch.cat([g[k].double().flatten() for k in ref_g])
            for g in (grad["s2d"][1], ref_g)]
    cos = float(flat[0] @ flat[1] / (flat[0].norm() * flat[1].norm()))
    loss_rel = abs(float(grad["s2d"][0]) - float(grad["plain"][0])) / abs(float(grad["plain"][0]))
    worst_s, stat_rel = _stat_rel(grad["s2d"][2], grad["plain"][2])
    worst_g = max(g_rel, key=g_rel.get)
    g_med, n_med, n_max = (float(np.median(list(g_rel.values()))),
                           float(np.median(list(noise.values()))), max(noise.values()))
    g64 = {flag: _f64_grads(spec, params, dev, imgs[:2], size, flag) for flag in (False, True)}
    f64_worst = max(float((g64[True][k] - g).abs().max() / g.abs().max().clamp(min=1e-300))
                    for k, g in g64[False].items())
    train_rec = {"s2d_loss": float(grad["s2d"][0]), "plain_loss": float(grad["plain"][0]),
                 "loss_rel": loss_rel, "stat_rel_worst": [worst_s, stat_rel],
                 "grad_cosine": cos, "f64_grad_rel_worst": f64_worst,
                 "grad_rel_median": g_med, "grad_rel_worst": [worst_g, g_rel[worst_g]],
                 "swap_noise_median": n_med, "swap_noise_max": n_max}
    print(f"(c) f32 micro-step B={batch} (TF32 off), s2d against the plain stem: loss "
          f"{train_rec['s2d_loss']} vs {train_rec['plain_loss']} (rel {loss_rel:.3g}, tolerance "
          f"{S2D_LOSS_RTOL}); new BN stats worst rel {stat_rel:.3g} ({worst_s}, checked "
          f"below); gradient cosine {cos:.9f} (tolerance > {S2D_GRAD_COS}); "
          f"||s2d-plain||/||plain|| median {g_med:.3g}, worst {g_rel[worst_g]:.3g} "
          f"({worst_g}), beside the plain step with the batch reversed: median {n_med:.3g}, "
          f"worst {n_max:.3g} (not a check); float64 B=2, a smooth loss of the head maps: "
          f"worst max|s2d-plain|/max|plain| over the gradients {f64_worst:.3g} (tolerance "
          f"{S2D_F64_GRAD_RTOL}) [{card}]", flush=True)
    if loss_rel > S2D_LOSS_RTOL or cos <= S2D_GRAD_COS or f64_worst > S2D_F64_GRAD_RTOL:
        raise AssertionError("the s2d train step disagrees with the plain stem's")
    del g64
    del grad, swapped, ref_g

    prepared = {layout: steps.prepare_batch(imgs, t, m, size, dev, True,
                                            torch.Generator(device=dev).manual_seed(SEED),
                                            layout) for layout in ("nhwc", "planar")}
    (n_img, n_t, n_m), (p_img, p_t, p_m) = prepared["nhwc"], prepared["planar"]
    planar_err = float((p_img - n_img.permute(0, 3, 1, 2)).abs().max())
    targets_equal = bool(torch.equal(p_t, n_t) and torch.equal(p_m, n_m))
    print(f"(c) augmented B={batch} batch, planar against nhwc: images max|diff| "
          f"{planar_err:.3g} (tolerance {PLANAR_TOL}), targets and mask equal {targets_equal}",
          flush=True)
    if planar_err > PLANAR_TOL or not targets_equal or not p_img.is_contiguous():
        raise AssertionError("the planar batch disagrees with the nhwc batch")
    del p_img, prepared

    # the new BN statistics of the train forward (augmented batch): s2d and
    # matmul against the plain reduce form, beside three other orders of the
    # batch (the same BN sums in other orders)
    sd = {k: v.to(dev) for k, v in params.items()}
    forms = {}
    orders = {"reversed": torch.arange(batch - 1, -1, -1), "rolled_1": torch.arange(batch).roll(1),
              "rolled_half": torch.arange(batch).roll(batch // 2)}
    with torch.no_grad(), (no_tf32() if cuda else contextlib.nullcontext()):
        for name, opts, order in (("reduce", {}, None), ("matmul", {"bn_form": "matmul"}, None),
                                  ("s2d", {"s2d_stem": True}, None),
                                  *((k, {}, v) for k, v in orders.items())):
            maps, stats = darknet.apply(sd, spec, n_img if order is None else n_img[order.to(dev)],
                                        train=True, **{"bn_form": "reduce", **opts})
            forms[name] = (float(yolo_loss(maps, spec, size, n_t, n_m)[0])
                           if order is None else None, stats)
            del maps
    ref_stats = forms["reduce"][1]
    noise = max((_stat_rel(forms[k][1], ref_stats) for k in orders), key=lambda r: r[1])
    stats_rec = {}
    for name, loss_tol, stat_tol in (("s2d", S2D_LOSS_RTOL, STEP_RTOL),
                                     ("matmul", BN_FORM_LOSS_RTOL, BN_FORM_STAT_RTOL)):
        lrel = abs(forms[name][0] - forms["reduce"][0]) / abs(forms["reduce"][0])
        worst = _stat_rel(forms[name][1], ref_stats)
        bound = max(stat_tol, STEP_GRAD_NOISE_FACTOR * noise[1])
        stats_rec[name] = {"loss_rel": lrel, "stat_rel_worst": list(worst), "stat_bound": bound}
        print(f"(c) f32 train forward B={batch}, {name} against the plain reduce form: loss "
              f"{forms[name][0]} vs {forms['reduce'][0]} (rel {lrel:.3g}, tolerance {loss_tol}); "
              f"new BN stats worst max|Δ|/max {worst[1]:.3g} ({worst[0]}; tolerance {bound:.3g}, "
              f"the larger of {stat_tol} and {STEP_GRAD_NOISE_FACTOR}x the other batch orders' "
              f"worst {noise[1]:.3g} at {noise[0]})", flush=True)
        if lrel > loss_tol or worst[1] > bound:
            raise AssertionError(f"the {name} train forward disagrees with the plain reduce form")
    if cuda:
        torch.cuda.synchronize()
    train_rec.update(planar_max_diff=planar_err, planar_targets_equal=targets_equal,
                     forward_stats=stats_rec, batch_order_stat_rel_worst=list(noise),
                     launches=launch_counts())
    record["training"] = train_rec
    print(f"(c) training launches of K1/K2/K3: {train_rec['launches']} (want 0 each)", flush=True)
    if any(train_rec["launches"].values()):
        raise AssertionError("the training checks launched a kernel")
    del forms, n_img, sd

    # (d) times, with their spread; no claim
    times = {}
    with torch.inference_mode():
        for b in sorted({batch, big}):
            tb = torch.randint(0, 256, (b, side, side, 3), dtype=torch.uint8, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(SEED))
            for name, d in (("bf16_plain", plain), ("bf16_s2d", s2d)):
                times[f"{name}_b{b}"] = _spread(lambda: d(tb), iters=5, warmup=2, hold=False)
            if b == big:
                fast = _fast_path_kwargs(argparse.Namespace(fast_path=True,
                                                            precision="int8_full"))
                for name, opts in (("int8_full_fast_path", fast),
                                   ("int8_full_plain_stem", dict(fast, s2d_stem=False))):
                    d8 = Detector(spec, params, **opts, **kw)
                    d8.load_calibration(sidecar)
                    times[f"{name}_b{b}"] = _spread(lambda: d8(tb), iters=5, warmup=2,
                                                    hold=False)
                    del d8
            del tb
        # the stem alone at B=big: layers 0-1 folded, plain and s2d, bf16
        folded = darknet.fold_batchnorm(params, spec)
        stem = {k: (v.to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
                    if v.dim() == 4 else v.to(dev, torch.bfloat16))
                for k, v in darknet.make_s2d_stem(folded, spec).items()}
        fp = {k: {n: t.to(dev, torch.bfloat16) for n, t in folded[k].items()}
              for k in ("conv_0", "conv_1")}
        xs = torch.rand(big, size, size, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
        x_cl = xs.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        l0, l1 = spec.layers[0], spec.layers[1]
        times[f"stem_plain_b{big}"] = _spread(lambda: darknet.folded_conv(
            fp, 1, l1, darknet.folded_conv(fp, 0, l0, x_cl, torch.bfloat16), torch.bfloat16))
        times[f"stem_s2d_b{big}"] = _spread(
            lambda: darknet.s2d_stem_forward(stem, xs, torch.bfloat16))
        del folded, stem, fp, xs, x_cl
    for s2d_flag in (False, True):
        for form in ("reduce", "matmul"):
            times[f"train_bf16_b8_{'s2d' if s2d_flag else 'plain'}_{form}"] = step_times(
                spec, params, dev, np.random.RandomState(SEED), size, side, torch.bfloat16,
                s2d_flag, form)
    record["times"] = times
    shutil.rmtree(tmp)
    for k, v in times.items():
        prof = v.get("profile", {})
        extra = ("" if "profile" not in v else
                 f"; host enqueue median {v['host_enqueue_median_ms']:.3f} ms, device busy "
                 f"{prof.get('device_busy_ms')} ms in {prof.get('launches_per_step')} launches "
                 f"a step, top kernels {json.dumps(prof.get('top_kernels'))}")
        print(f"(d) {k}: median {v['median_ms']:.3f} ms, min {v['min_ms']:.3f}, max "
              f"{v['max_ms']:.3f}{extra} [{card}]", flush=True)
    return record


# --------------------------------------------------------------------------
# phase 17: the bench and the measurement tools
# --------------------------------------------------------------------------

BENCH_SMOKE_ENV = {"BENCH_ITERS": "10"}              # (a): bench_torch.py at B=32
CLI_BENCH_ENV = {"BENCH_BATCH": "8", "BENCH_ITERS": "3"}  # (b)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]   # bench.py's lines, in order
INT8_TOOL = dict(batch=16, chain=24, iters=2)        # (c): the tool's four shapes
TOOL_STEP = dict(B=8, S=416, iters=5)                # (d)
SERVE_TOOL_S = 3.0                                   # (e): seconds a phase
SHARE_TOL = 1e-4  # (f): busy share, the tool's (Chrome JSON) against profile_detector's


def run_bench(argv, env: dict, root: str, card_name: str, batch: int) -> dict:
    """(a), (b): a bench process; its two stdout lines checked against
    ``bench.py``'s shape, its stderr against the card; the launches per
    call and the repetitions it printed."""
    proc = subprocess.run([sys.executable, *argv], cwd=root, capture_output=True, text=True,
                          timeout=900, env=dict(os.environ, **env))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(argv)} exited {proc.returncode}: {proc.stderr[-3000:]}")
    sys.stderr.write(proc.stderr)
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    if len(lines) != 2:
        raise AssertionError(f"{' '.join(argv)}: {len(lines)} stdout lines, want 2: {lines}")
    recs = [json.loads(l, object_pairs_hook=list) for l in lines]
    names = [f"wsi_tiles_per_sec_per_chip_1536px_b{batch}_bf16_parity",
             f"wsi_tiles_per_sec_per_chip_1536px_b{batch}"]
    for rec, name in zip(recs, names):
        if [k for k, _ in rec] != BENCH_KEYS or dict(rec)["metric"] != name \
                or dict(rec)["unit"] != "tiles/s":
            raise AssertionError(f"bench line {rec} is not bench.py's {name} line")
    if card_name not in proc.stderr:
        raise AssertionError(f"the bench's stderr does not name the card {card_name}")
    reps = [l for l in proc.stderr.splitlines() if "ms/batch over 2 reps" in l]
    if not reps:
        raise AssertionError("the bench printed no spread of its repetitions")
    launches = {}
    for l in proc.stderr.splitlines():
        if l.startswith("# launches per call ("):
            label, counts = l[len("# launches per call ("):].split("): ", 1)
            launches[label] = json.loads(counts)
    parity, head = (dict(r) for r in recs)
    return {"parity": parity, "headline": head, "launches_per_call": launches,
            "reps": reps}


def bench_tools_phase(spec, params, card: str, dev, training: dict, size: int = 416,
                      subprocesses: bool = True, int8_kw=None, step_kw=None,
                      serve_argv=(), trace_batch: int = 8) -> dict:
    """Phase 17: the bench and the measurement tools (see the module
    docstring); returns its JSON record.  ``subprocesses=False`` leaves
    (a) and (b) out and the other arguments cut the rest down for a
    rehearsal on the CPU, where ``torch.cuda.synchronize`` and the
    profiler's device events need host stand-ins and the launch counts
    are 0."""
    import contextlib as ctx

    import numpy as np
    import torch
    import bench_int8_block_torch
    import bench_trainstep_torch
    import mfu_torch
    import serve_bench_torch
    import trace_summary_torch
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import emit_cfg
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts

    cuda = dev.type == "cuda"
    card_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    record = {"card": card}
    print(f"phase 17, the bench and the measurement tools [{card}]", flush=True)

    # (a), (b): the bench, and the CLI's bench, each a process of its own
    if subprocesses:
        bench = run_bench(["bench_torch.py"], BENCH_SMOKE_ENV, REPO, card_name, 32)
        cli = run_bench(["-m", "amyloid_yolo_tpu_torch.cli", "bench"], CLI_BENCH_ENV, REPO,
                        card_name, 8)
        for label, per_call in (*bench["launches_per_call"].items(),
                                *cli["launches_per_call"].items()):
            want_k2 = 23.0 if label == "bf16 parity" else 0.0
            if (per_call["fused_residual_block"] != want_k2
                    or per_call["fused_residual_block_int8"] != 0
                    or (label != "host-resized 416² input"
                        and per_call["resize_normalize"] != 1.0)):
                raise AssertionError(f"bench {label}: launches per call {per_call}")
        record["bench"], record["cli_bench"] = bench, cli
        print(f"(a) bench_torch.py B=32: {json.dumps(bench)} [{card}]", flush=True)
        print(f"(b) cli bench B=8: {json.dumps(cli)} [{card}]", flush=True)

    reset_launch_counts()
    # (c): the int8-block tool, K3 against the executor's unit and its plain version
    rows = bench_int8_block_torch.run(device=dev, **dict(INT8_TOOL, **(int8_kw or {})))
    record["int8_block"] = rows
    record["int8_block_launches"] = launch_counts()

    # (d): the train-step tool, bf16 and f32 at B=8, against phase 11's step
    sk = dict(TOOL_STEP, **(step_kw or {}))
    steps_rec = {}
    for dtype in ("bf16", "f32"):
        rec = bench_trainstep_torch.bench_step(sk["B"], sk["S"], sk["iters"], dtype,
                                               device=dev, spec=spec)
        ref = training.get(f"step_{dtype}")
        if ref:
            lo, hi = ref["min_ms"], ref["max_ms"]
            ms = rec["ms_per_step"]
            rec["phase11_range_ms"] = [lo, hi]
            rec["vs_phase11"] = ("within" if lo <= ms <= hi else
                                 f"{ms - (lo if ms < lo else hi):+.3f} ms outside")
            print(f"(d) train step tool {dtype} B={sk['B']}: {ms:.3f} ms a step (apply every "
                  f"step) against phase 11's micro-step {lo:.3f}-{hi:.3f} ms (accumulation 2, "
                  f"other weights and images): {rec['vs_phase11']} [{card}]", flush=True)
        steps_rec[dtype] = rec
    record["train_step"] = steps_rec

    # (e): the load tool, raw bodies, the bf16 parity server in this process
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "model.cfg")
        with open(cfg, "w") as fh:
            fh.write(emit_cfg(spec))
        out = io.StringIO()
        with ctx.redirect_stdout(out):
            rc = serve_bench_torch.main(
                ["--fast_path", "False", "--raw", "True", "--concurrency", "8",
                 "--duration", str(SERVE_TOOL_S), "--model_def", cfg,
                 "--device", str(dev), *serve_argv])
    print(out.getvalue(), end="", flush=True)
    served = [json.loads(l) for l in out.getvalue().splitlines() if l.startswith("{")]
    if rc != 0 or not served:
        raise AssertionError(f"serve_bench_torch exited {rc} with {served}")
    for r in served:
        if r["errors"] or r["queue_depth_max"] > r["max_queue"] or r["device"] != card_name:
            raise AssertionError(f"serve_bench_torch phase {r}")
    record["serve"] = served

    # (f): the trace tool over one bf16 Detector call, against profile_detector
    det = Detector(spec, params, conf_thres=0.3, model_size=size, device=dev)
    tiles = torch.randint(0, 256, (trace_batch, 1536, 1536, 3), dtype=torch.uint8,
                          device=dev)
    with torch.inference_mode():
        det(tiles)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "detector.json")
        with torch.inference_mode():
            prof = profile_detector(det, tiles, calls=1, trace_path=path)
        summary = trace_summary_torch.summarize(path, top=1000)
    launches = {k: sum(n for name, _, n in summary["rows"] if k in name and (
        k != "fused_residual_block" or "int8" not in name))
        for k in ("resize_normalize", "fused_residual_block")}
    want = {"resize_normalize": 1, "fused_residual_block": 23} if cuda else \
        {"resize_normalize": 0, "fused_residual_block": 0}
    share = 1.0 - prof.get("idle_share_traced", float("nan"))
    print(f"(f) trace_summary_torch on one bf16 B={trace_batch} call: launches {launches} "
          f"(want {want}); busy share {summary['busy_share']} against profile_detector's "
          f"{share} (tolerance {SHARE_TOL}) [{card}]", flush=True)
    if launches != want or not abs(summary["busy_share"] - share) <= SHARE_TOL:
        raise AssertionError("the trace tool disagrees with the trace")
    record["trace"] = {"launches": launches, "busy_share": summary["busy_share"],
                       "profile_detector_busy_share": share, "busy_ms": summary["busy_ms"],
                       "top": summary["rows"][:8]}
    del det, tiles
    counts = launch_counts()
    record["launches"] = counts
    print(f"phase 17 launches in this process ((c), (e), (f)): {counts}", flush=True)
    if cuda and not all(counts.values()):
        raise AssertionError(f"phase 17 launched a kernel of its path no time: {counts}")

    # (g): MFU of (a)'s lines and (d)'s steps
    g_inf = mfu_torch.conv_gflops(spec, size)
    g_train = mfu_torch.train_gflops(spec, sk["S"])
    mfu = {f"train_{k}": mfu_torch.utilization(g_train, sk["B"], r["ms_per_step"])
           for k, r in steps_rec.items()}
    if subprocesses:
        for key in ("parity", "headline"):
            tps = record["bench"][key]["value"]
            mfu[f"bench_{key}"] = mfu_torch.utilization(g_inf, 32, 32 / tps * 1e3)
    record["mfu"] = mfu
    print(f"(g) MFU (conv GFLOPs {g_inf:.2f} an image, train {g_train:.2f}): "
          f"{json.dumps(mfu)} [{card}]", flush=True)
    return record


# --------------------------------------------------------------------------
# phase 18: the last modules of the JAX package
# --------------------------------------------------------------------------

WARP_TOL = 1e-5                     # (b): card vs CPU, and the shear warp against the bilinear
                                    # warp for pure translation (tests/test_augment.py:81-90)
SAVE_SET = dict(n_train=16, n_valid=4)  # (c): 2 micro-batches of 8 an epoch, 4 to evaluate
SAVE_EMA = 0.999                    # (c): the EMA on, so the checkpoint holds all four states
NMS_SHARE = 0.005                   # (d): the share of phase 6's rows above the threshold
NMS_THRES = 0.4
NMS_TOL = dict(box=0.1, score=1e-3)  # (d): tests/test_torch_detector.py:163
PAD_CASES = (((1000, 1536, 3), "uint8", 0.0), ((2, 1536, 1000, 3), "uint8", 0.0),
             ((1000, 1536, 3), "float32", 0.5))  # (f): pad_to_square, shape, dtype, value
RESCALE_TOL = 1e-3                  # (f): px at 1536, float32 on the card against float64
SAVE_CHILD_TIMEOUT_S = 120          # (f): the one-process group's Trainer
OVERLAPPED_SAVE_KEYS = ["epoch", "host_copy_s", "join_s", "snapshot_s", "start_s", "write_s"]
TOOL_ARGV = {                       # (e): each tool in a process of its own
    "bench_trainstep_torch.py": ["--warp-ab", "--forms-ab", "--iters", "3"],
    "bench_bn_stats_torch.py": ["--iters", "5"],
    "bench_s2d_down_b32_torch.py": ["--iters", "10"],
}


def timed_calls(fn, n: int, dev) -> list:
    """ms of each of ``n`` calls of ``fn``: CUDA events on the card, the
    host clock on the CPU."""
    import torch
    if dev.type != "cuda":
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(n)]
    for a, b in marks:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in marks]


def same_bits(a, b) -> bool:
    """Equal dtype, values and signs of zero (tensors in nested dicts and
    lists; anything else by ``==``)."""
    import torch
    if isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu())
                and (not b.is_floating_point()
                     or torch.equal(torch.signbit(a.cpu()), torch.signbit(b.cpu()))))
    if isinstance(b, dict):
        return isinstance(a, dict) and set(a) == set(b) and all(same_bits(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a == b


def warp_input(dev, size: int, side: int):
    """(b)'s images: the model input of a B=8 batch like phase 11's."""
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.parallel import steps
    imgs, t, m = train_batch(np.random.RandomState(SEED), 8, side)
    with torch.no_grad():
        x, _, _ = steps.prepare_batch(*(torch.as_tensor(a).to(dev) for a in (imgs, t, m)),
                                      size, dev)
    return x


def warp_checks(x, dev, card: str) -> dict:
    """(b): the exact bilinear warp on the card against the CPU, in both
    layouts; for pure translation against the shear warp, at the JAX
    test's shape and shifts (``tests/test_augment.py:81-90``: 64², 0.15,
    -0.1) over every pixel, and at ``x``'s size with the draws' shifts
    over the pixels whose samples lie a pixel or more inside the image;
    each warp's ms a batch."""
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.ops import augment as aug
    r = np.random.RandomState(SEED + 18)
    b, s = x.shape[0], x.shape[1]
    ang, tx, ty = (torch.from_numpy(r.uniform(lo, hi, b).astype(np.float32))
                   for lo, hi in ((-20, 20), (-0.2, 0.2), (-0.2, 0.2)))
    on = [a.to(dev) for a in (ang, tx, ty)]
    got = aug._affine_one(x, *on)
    want = aug._affine_one(x.cpu(), ang, tx, ty)
    planar = aug._affine_one(x.permute(0, 3, 1, 2).contiguous(), *on, planar=True)
    zero = torch.zeros(b, device=dev)
    small = x[:, :64, :64].contiguous()
    jax_tx, jax_ty = torch.full((b,), 0.15, device=dev), torch.full((b,), -0.1, device=dev)
    diff_64 = (aug._affine_one(small, zero, jax_tx, jax_ty)
               - aug._affine_shear3(small, zero, jax_tx, jax_ty)).abs()
    diff = (aug._affine_one(x, zero, on[1], on[2])
            - aug._affine_shear3(x, zero, on[1], on[2])).abs().amax(dim=-1).cpu()
    # a pure translation samples pixel (i, j) at (i - ty·s, j - tx·s)
    idx = np.arange(s, dtype=np.float64)
    inside = [(idx[None] - t.numpy().astype(np.float64)[:, None] * s >= 1)
              & (idx[None] - t.numpy().astype(np.float64)[:, None] * s <= s - 2)
              for t in (ty, tx)]
    interior = torch.from_numpy(inside[0][:, :, None] & inside[1][:, None, :])
    rec = {"card_vs_cpu": float((got.cpu() - want).abs().max()),
           "planar_vs_nhwc": float((planar.permute(0, 2, 3, 1) - got).abs().max()),
           "translation_shear3_vs_bilinear_64": float(diff_64.max()),
           "translation_shear3_vs_bilinear_interior": float(diff[interior].max()),
           "translation_shear3_vs_bilinear_all": float(diff.max()),
           "zero_share": float((want == 0).float().mean())}

    def ms(fn):
        return cuda_ms(fn, iters=10) if dev.type == "cuda" else float(np.median(
            timed_calls(fn, 3, dev)))

    rec["bilinear_ms"] = ms(lambda: aug._affine_one(x, *on))
    rec["shear3_ms"] = ms(lambda: aug._affine_shear3(x, *on))
    print(f"(b) _affine_one B={b} {s}^2: card vs CPU max|diff| {rec['card_vs_cpu']} "
          f"(tolerance {WARP_TOL}), planar vs NHWC {rec['planar_vs_nhwc']}; pure translation, "
          f"shear3 vs bilinear: {rec['translation_shear3_vs_bilinear_64']} at 64^2 with the "
          f"JAX test's shifts, {rec['translation_shear3_vs_bilinear_interior']} inside at "
          f"{s}^2 (tolerance {WARP_TOL} each); {rec['translation_shear3_vs_bilinear_all']} "
          f"over all pixels at {s}^2 (a record: at the zero-filled border a float32 "
          f"coordinate's ulp, {float(np.spacing(np.float32(0.7 * s))):.1e} px near "
          f"{0.7 * s:.0f}, meets a jump of ~0.9); "
          f"{rec['zero_share']:.4f} of the outputs zero-filled; bilinear "
          f"{rec['bilinear_ms']:.4f} ms, shear3 {rec['shear3_ms']:.4f} ms a batch [{card}]",
          flush=True)
    if max(rec["card_vs_cpu"], rec["planar_vs_nhwc"], rec["translation_shear3_vs_bilinear_64"],
           rec["translation_shear3_vs_bilinear_interior"]) > WARP_TOL:
        raise AssertionError("(b) the bilinear warp disagrees")
    return rec


def checkpoint_copy(tr) -> dict:
    """What a checkpoint of ``tr`` holds, copied to the host synchronously."""
    from amyloid_yolo_tpu_torch.io import weights
    from amyloid_yolo_tpu_torch.training import _map_tensors
    st = tr.state
    opt = _map_tensors(st.optimizer.state_dict(), lambda t: t.detach().to("cpu", copy=True))
    out = {"params": weights.params_to_torch_state_dict(tr.spec, st.params),
           "optimizer": opt, "step": st.step, "seen": st.seen}
    if st.ema is not None:
        out["ema"] = weights.params_to_torch_state_dict(tr.spec, st.ema)
    return out


class GcPauses:
    """Seconds the cyclic garbage collector ran, and its runs, by
    generation, while registered (``with GcPauses() as gc_pauses:``); each
    run of ``LONG_GC_MS`` or more in ``long``: its generation, ms, the
    objects it collected and its start in seconds from the registration."""
    LONG_GC_MS = 20.0

    def __init__(self):
        self.s, self.n, self.long, self._t0 = [0.0] * 3, [0] * 3, [], None
        self._start = time.perf_counter()

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.s[info["generation"]] += dt
            self.n[info["generation"]] += 1
            if dt * 1e3 >= self.LONG_GC_MS:
                self.long.append({"generation": info["generation"], "ms": dt * 1e3,
                                  "collected": info["collected"],
                                  "at_s": self._t0 - self._start})
            self._t0 = None

    def __enter__(self):
        import gc
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self)


ALLOCATOR_COUNTS = {"new_segments": "num_device_alloc", "freed_segments": "num_device_free",
                    "alloc_retries": "num_alloc_retries"}


def observe_dispatches(tr, dev, gc_pauses: GcPauses) -> list:
    """Wrap ``tr.save_checkpoint`` so that each call appends its wall ms,
    the collector's pauses in it and the device allocator's counts in it
    (``ALLOCATOR_COUNTS``: its ``cudaMalloc`` and ``cudaFree`` calls, and
    the allocations it retried after freeing its cache) to the returned
    list, with the memory the allocator held before the call."""
    import torch
    inner, log = tr.save_checkpoint, []

    def counts():
        stats = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
        return {k: stats.get(v, 0) for k, v in ALLOCATOR_COUNTS.items()}

    def save(epoch):
        gc0, c0 = (list(gc_pauses.s), list(gc_pauses.n)), counts()
        reserved = torch.cuda.memory_reserved(dev) / 2 ** 30 if dev.type == "cuda" else 0.0
        t0 = time.perf_counter()
        path = inner(epoch)
        log.append({"epoch": epoch, "ms": (time.perf_counter() - t0) * 1e3,
                    "gc_ms": [(a - b) * 1e3 for a, b in zip(gc_pauses.s, gc0[0])],
                    "gc_runs": [a - b for a, b in zip(gc_pauses.n, gc0[1])],
                    **{k: v - c0[k] for k, v in counts().items()},
                    "reserved_gib_before": reserved})
        return path

    tr.save_checkpoint = save
    return log


def overlapped_save(spec, dev, size: int, side: int, root: str, card: str,
                    save_set: dict) -> dict:
    with GcPauses() as gc_pauses:
        return _overlapped_save(spec, dev, size, side, root, card, save_set, gc_pauses)


def _overlapped_save(spec, dev, size: int, side: int, root: str, card: str,
                     save_set: dict, gc_pauses: GcPauses) -> dict:
    """(c): a 2-epoch ``Trainer`` at B=8 whose every dispatched checkpoint
    is compared, after the join, with a synchronous host copy taken right
    after the dispatch (the next epoch's steps run in between for epoch 0);
    one more dispatch with a train step before its join; a failed write
    raised at the join; the dispatch, the write and a synchronous save
    timed; the snapshot's extra device memory."""
    import threading
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch import training
    from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer
    data = write_train_set(root, SEED, side=side, **save_set)

    def trainer(name):
        cfg = TrainConfig(data_config=data, epochs=2, batch_size=8, gradient_accumulations=1,
                          img_size=size, multiscale=False, augment=True,
                          learning_rate=TRAIN_LR, ema_decay=SAVE_EMA,
                          checkpoint_dir=os.path.join(root, f"ckpts_{name}"),
                          logdir=os.path.join(root, f"logs_{name}"))
        return Trainer(cfg, spec=spec, device=dev)

    def train(tr):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tr.train()
        live = [t.name for t in threading.enumerate() if t.name.startswith("ckpt-save-")]
        if tr._save_thread is not None or live:
            raise AssertionError(f"(c) train() returned with a save in flight: {live}")
        return time.perf_counter() - t0

    # the epoch walls as a user's run has them
    clean = trainer("clean")
    observed = {"clean": observe_dispatches(clean, dev, gc_pauses)}
    wall = train(clean)
    # the same run, each dispatch followed by a synchronous host copy of the state
    tr = trainer("checked")
    cfg = tr.cfg
    copies, dispatch_ms = {}, {}
    observed["checked"] = observe_dispatches(tr, dev, gc_pauses)
    dispatch = tr.save_checkpoint

    def save_and_copy(epoch):
        t0 = time.perf_counter()
        path = dispatch(epoch)
        dispatch_ms[epoch] = (time.perf_counter() - t0) * 1e3
        copies[epoch] = checkpoint_copy(tr)
        return path

    tr.save_checkpoint = save_and_copy
    train(tr)
    for epoch in (0, 1):
        got = torch.load(tr.checkpoint_path(epoch), map_location="cpu", weights_only=True)
        if not same_bits(got, copies[epoch]):
            raise AssertionError(f"(c) checkpoint {epoch} is not the state at its dispatch")

    # one more dispatch, a train step before its join
    rng = np.random.RandomState(SEED + 18)
    imgs, t, m = train_batch(rng, 8, side)
    key = next(k for k in tr.state.params if k.endswith(".weight"))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    path = dispatch(2)
    dispatch_ms[2] = (time.perf_counter() - t0) * 1e3
    peak_gib = "not measured"
    if cuda:  # the snapshot's copies, before the step below allocates its own
        torch.cuda.synchronize(dev)
        peak_gib = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    copies[2] = checkpoint_copy(tr)
    tr.state, _ = tr.step_fn(tr.state, imgs, t, m, tr.rng, size)
    moved = not torch.equal(tr.state.params[key].detach().cpu(), copies[2]["params"][key])
    t0 = time.perf_counter()
    tr.join_pending_save()
    join_ms = (time.perf_counter() - t0) * 1e3
    got = torch.load(path, map_location="cpu", weights_only=True)
    if not moved or not same_bits(got, copies[2]):
        raise AssertionError(f"(c) the dispatched checkpoint is not the state at its dispatch "
                             f"(the step moved the live state: {moved})")

    # the write alone, synchronous: the save as it stood on the epoch path
    times, sync_gc_ms = [], []
    for epoch in (3, 4):
        if cuda:
            torch.cuda.synchronize(dev)
        gc0 = sum(gc_pauses.s)
        t0 = time.perf_counter()
        tr._write_checkpoint(tr.checkpoint_path(epoch), training._state_tree(tr.state), epoch,
                             tr._best_epochs())
        times.append((time.perf_counter() - t0) * 1e3)
        sync_gc_ms.append((sum(gc_pauses.s) - gc0) * 1e3)
    nbytes = os.path.getsize(tr.checkpoint_path(4))

    # a write that fails surfaces at the join
    blocker = os.path.join(root, "a_file")
    open(blocker, "w").close()
    cfg.checkpoint_dir = os.path.join(blocker, "ckpts")
    dispatch(5)
    raised = None
    try:
        tr.join_pending_save()
    except RuntimeError as e:
        raised = f"{e} ({type(e.__cause__).__name__}: {e.__cause__})"
    if raised is None or "async checkpoint write failed" not in raised:
        raise AssertionError("(c) a write into an unwritable directory did not raise at the join")
    import gc
    rec = {"trainer_wall_s": wall, "epoch_walls": clean.epoch_walls,
           "dispatch_ms": dispatch_ms, "join_after_step_ms": join_ms,
           "sync_save_ms": times, "checkpoint_bytes": nbytes,
           "snapshot_peak_extra_gib": peak_gib, "failed_write": raised,
           "dispatches": observed,
           "save_walls": {"clean": clean.save_walls, "checked": tr.save_walls},
           "sync_save_gc_ms": sync_gc_ms,
           "gc_pauses_ms": [t * 1e3 for t in gc_pauses.s], "gc_runs": gc_pauses.n,
           "gc_long_runs": gc_pauses.long, "heap_objects": len(gc.get_objects())}
    for name, log in observed.items():
        for d, w in zip(log, rec["save_walls"][name]):
            print(f"(c) {name} dispatch of epoch {d['epoch']}: {d['ms']:.2f} ms = join "
                  f"{w.get('join_s', 0) * 1e3:.2f} + device copy "
                  f"{w.get('snapshot_s', 0) * 1e3:.2f} + worker start "
                  f"{w.get('start_s', 0) * 1e3:.2f} ms; collector "
                  f"{[round(g, 2) for g in d['gc_ms']]} ms in {d['gc_runs']} runs (gen 0-2); "
                  f"the allocator {d['new_segments']} cudaMalloc, {d['freed_segments']} "
                  f"cudaFree, {d['alloc_retries']} retries, "
                  f"{d['reserved_gib_before']:.2f} GiB held before; the worker's host copy "
                  f"{w.get('host_copy_s', float('nan')) * 1e3:.1f} ms, write "
                  f"{w.get('write_s', float('nan')) * 1e3:.1f} ms [{card}]", flush=True)
    print(f"(c) the collector's runs of {GcPauses.LONG_GC_MS} ms or more in (c): "
          f"{json.dumps(gc_pauses.long)}; in the synchronous saves {sync_gc_ms} ms; "
          f"{rec['heap_objects']} objects tracked at the end [{card}]", flush=True)
    ep = clean.epoch_walls[0]
    print(f"(c) overlapped save, Trainer 2 epochs x 2 micro-batches of 8 with EMA: each "
          f"checkpoint equals the host copy taken at its dispatch; dispatch "
          f"{json.dumps({k: round(v, 3) for k, v in dispatch_ms.items()})} ms, the write after a "
          f"train step joined in {join_ms:.1f} ms, a synchronous save {times[0]:.1f} and "
          f"{times[1]:.1f} ms ({nbytes / 2 ** 30:.3f} GiB file); the snapshot's peak extra "
          f"device memory {peak_gib} GiB; a run without the copies: epoch 0 train "
          f"{ep['train_s']:.3f} s, eval {ep['eval_s']:.3f} s, save-dispatch {ep['save_s']:.4f} "
          f"s, the 2 epochs {wall:.3f} s with the last join; the failed write raised "
          f"{raised!r} [{card}]", flush=True)
    return rec


def gap_threshold(values, share: float) -> float:
    """A threshold with about ``share`` of ``values`` above it, halfway
    across the widest gap between two consecutive values near that rank, so
    that no value sits near it (as :func:`raise_objectness` picks one)."""
    import torch
    v = torch.sort(values.flatten().double(), descending=True).values
    k0 = max(4, int(share * v.numel()))
    lo, hi = k0 - k0 // 4, k0 + k0 // 4 + 1
    k = lo + int(torch.argmax(v[lo - 1:hi - 1] - v[lo:hi]))  # v[k - 1] passes, v[k] not
    return float(v[k - 1] + v[k]) / 2


def matched_box_diff(a, b) -> float:
    """The largest box difference when each row of ``b`` is paired with the
    nearest unpaired row of ``a`` of the same class and a score within
    ``NMS_TOL``; infinite where a row has none.  The rows of one image are
    in score order on both sides, but the reference leaves the order of
    equal scores open (``amyloid_yolo_tpu/ops/nms.py:9-11``): a stable sort
    on the card, numpy's quicksort on the host."""
    import numpy as np
    free = np.ones(len(a), bool)
    worst = 0.0
    for row in b:
        cand = np.flatnonzero(free & (a[:, 6] == row[6])
                              & (np.abs(a[:, 4:6] - row[4:6]).max(axis=1) <= NMS_TOL["score"]))
        if not len(cand):
            return float("inf")
        d = np.abs(a[cand, :4] - row[:4]).max(axis=1)
        free[cand[d.argmin()]] = False
        worst = max(worst, float(d.min()))
    return worst


def host_nms_check(spec, params, dev, size: int, side: int, card: str) -> tuple:
    """(d): phase 6's bf16 ``Detector`` maps of its first batch, decoded,
    through the device NMS (every candidate in its pool) and through
    ``non_max_suppression_np`` on the host copy, at one threshold: the same
    detections within ``NMS_TOL``.  Returns the record and the host rows."""
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.models import heads
    from amyloid_yolo_tpu_torch.ops import nms
    det = Detector(spec, params, conf_thres=0.3, model_size=size, tile_size=side, device=dev)
    tiles = np.random.RandomState(SEED).randint(0, 256, (8, side, side, 3)).astype(np.uint8)
    with torch.inference_mode():
        maps = det.head_maps(torch.from_numpy(tiles).to(dev))
        pred = heads.decode_all([m.float() for m in maps], spec, size)
    conf = gap_threshold(pred[..., 4], NMS_SHARE)
    n_cand = (pred[..., 4] >= conf).sum(dim=1)
    pool = int(n_cand.max())
    with torch.inference_mode():
        dets, valid = nms.non_max_suppression(pred, conf, NMS_THRES, capacity=pool, pool=pool)
    t0 = time.perf_counter()
    host = nms.non_max_suppression_np(pred.cpu().numpy(), conf, NMS_THRES)
    host_ms = (time.perf_counter() - t0) * 1e3
    got = nms.dense_to_ragged(dets, valid)
    box = score = 0.0
    tied = 0
    for i, (a, b) in enumerate(zip(got, host)):
        if (a is None) != (b is None) or (a is not None and a.shape != b.shape):
            raise AssertionError(f"(d) image {i}: the device NMS keeps other boxes than the "
                                 f"host mirror ({None if a is None else a.shape} vs "
                                 f"{None if b is None else b.shape})")
        if a is not None:
            score = max(score, float(np.abs(a[:, 4:6] - b[:, 4:6]).max()))
            box = max(box, matched_box_diff(a, b))
            tied += len(b) - len(np.unique(b[:, 4] * b[:, 5]))
    kept = [0 if h is None else len(h) for h in host]
    rec = {"conf_thres": conf, "nms_thres": NMS_THRES, "candidates": n_cand.tolist(),
           "kept": kept, "tied_score_rows": tied, "max_box_diff_px": box,
           "max_score_diff": score, "host_ms": host_ms}
    print(f"(d) non_max_suppression_np against the device NMS on phase 6's first batch "
          f"(conf {conf:.6f}, NMS {NMS_THRES}): candidates {rec['candidates']}, kept {kept}, "
          f"{tied} kept rows tied in score with another (matched by box: the two sorts may "
          f"order a tie otherwise); max|box diff| {box} px (tolerance {NMS_TOL['box']}), "
          f"max|score diff| {score} "
          f"(tolerance {NMS_TOL['score']}); the host loop {host_ms:.1f} ms [{card}]", flush=True)
    if not sum(kept) or box > NMS_TOL["box"] or score > NMS_TOL["score"]:
        raise AssertionError("(d) the host NMS mirror disagrees with the device NMS")
    return rec, host


def pad_checks(dev, card: str) -> dict:
    """(f): ``ops/preprocess.py:pad_to_square`` on ``dev`` against ``np.pad``
    of the same array, bit for bit, for each of ``PAD_CASES``; the result
    stays on ``dev``."""
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.ops.preprocess import pad_to_square
    rng = np.random.RandomState(SEED)
    out = []
    for shape, dtype, value in PAD_CASES:
        x = (rng.randint(0, 256, shape) if dtype == "uint8" else rng.rand(*shape)).astype(dtype)
        got, pads = pad_to_square(torch.from_numpy(x).to(dev), pad_value=value)
        top, bottom, left, right = pads
        want = np.pad(x, [(0, 0)] * (x.ndim - 3) + [(top, bottom), (left, right), (0, 0)],
                      constant_values=value)
        host = got.cpu().numpy()
        same = (got.device.type == dev.type and host.dtype == want.dtype
                and host.shape == want.shape and host.tobytes() == want.tobytes())
        out.append({"shape": list(shape), "dtype": dtype, "pad_value": value,
                    "pads": list(pads), "device": str(got.device), "bit_equal": same})
    print(f"(f) pad_to_square on {dev.type} against np.pad, bit for bit: "
          f"{json.dumps(out)} [{card}]", flush=True)
    if not all(r["bit_equal"] for r in out):
        raise AssertionError("(f) pad_to_square differs from np.pad or left the device")
    return {"cases": out}


def rescale_checks(rows, dev, size: int, side: int, card: str) -> dict:
    """(f): (d)'s host NMS rows in the ``size`` frame mapped to tile pixels
    by the host ``rescale_boxes`` (float64) and by ``rescale_boxes_batched``
    on ``dev`` (float32, the rows padded to one length): the largest
    difference in px, within ``RESCALE_TOL``, for the square tile and a
    1000-row border tile."""
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.ops.boxes import rescale_boxes, rescale_boxes_batched
    rows = [r for r in rows if r is not None]
    k = max(len(r) for r in rows)
    padded = np.zeros((len(rows), k, 7), np.float32)
    for i, r in enumerate(rows):
        padded[i, :len(r)] = r
    on_dev = torch.from_numpy(padded).to(dev)
    out = {}
    for orig in ((side, side), (side * 1000 // 1536, side)):
        got = rescale_boxes_batched(on_dev, size, *orig)
        if got.device.type != dev.type:
            raise AssertionError(f"(f) rescale_boxes_batched left {dev}")
        got = got.cpu().numpy()
        diff = max(float(np.abs(got[i, :len(r)] - rescale_boxes(r, size, orig)).max())
                   for i, r in enumerate(rows))
        out[f"{orig[0]}x{orig[1]}"] = diff
    print(f"(f) rescale_boxes (host, float64) against rescale_boxes_batched ({dev.type}, "
          f"float32) on (d)'s {sum(len(r) for r in rows)} host NMS rows, {size} -> tile "
          f"pixels: max|diff| px {json.dumps(out)} (tolerance {RESCALE_TOL}) [{card}]",
          flush=True)
    if not all(d <= RESCALE_TOL for d in out.values()):
        raise AssertionError("(f) the host and the batched rescale disagree")
    return {"max_diff_px": out, "rows": sum(len(r) for r in rows)}


SAVE_CHILD = ("import json, sys, chip_smoke; "
              "print(json.dumps(chip_smoke.one_process_group_save(**json.loads(sys.argv[1]))))")


def one_process_group_save(data: str, root: str, model_def: str, size: int,
                           device: str) -> dict:
    """(f)'s child process: a ``Trainer(distributed=True)`` in a process
    group of one (NCCL on the card, gloo on the CPU) trains one epoch of
    ``SAVE_SET`` with EMA and saves; returns its save's parts, and whether
    the file equals the live state after ``train()`` joined the write."""
    import socket
    import torch
    import torch.distributed as dist
    from amyloid_yolo_tpu_torch.graphspec import from_cfg
    from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = TrainConfig(data_config=data, epochs=1, batch_size=8, gradient_accumulations=1,
                      img_size=size, multiscale=False, augment=True, learning_rate=TRAIN_LR,
                      ema_decay=SAVE_EMA, checkpoint_dir=os.path.join(root, "ckpts"),
                      logdir=os.path.join(root, "logs"), distributed=True,
                      coordinator_address=f"127.0.0.1:{port}", num_processes=1, process_id=0)
    t0 = time.perf_counter()
    tr = Trainer(cfg, spec=from_cfg(model_def), device=device)
    with contextlib.redirect_stdout(io.StringIO()):
        tr.train()
    wall = time.perf_counter() - t0
    got = torch.load(tr.checkpoint_path(0), map_location="cpu", weights_only=True)
    rec = {"backend": dist.get_backend(), "world": dist.get_world_size(), "nproc": tr.nproc,
           "device": str(tr.device), "trainer_wall_s": wall, "save_walls": tr.save_walls,
           "epoch_walls": tr.epoch_walls,
           "file_equals_state": same_bits(got, checkpoint_copy(tr))}
    dist.destroy_process_group()
    return rec


def one_process_save_check(spec, dev, size: int, side: int, card: str, save_set: dict) -> dict:
    """(f): :func:`one_process_group_save` in a process of its own: the
    save overlapped (``OVERLAPPED_SAVE_KEYS`` in its ``save_walls``), its
    file equal to the live state, in a group of one process."""
    from amyloid_yolo_tpu_torch.graphspec import emit_cfg
    with tempfile.TemporaryDirectory() as root:
        data = write_train_set(root, SEED, side=side, **save_set)
        model_def = os.path.join(root, "model.cfg")
        with open(model_def, "w") as fh:
            fh.write(emit_cfg(spec))
        args = json.dumps({"data": data, "root": root, "model_def": model_def, "size": size,
                           "device": "cuda" if dev.type == "cuda" else "cpu"})
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", SAVE_CHILD, args], cwd=REPO,
                              capture_output=True, text=True, timeout=SAVE_CHILD_TIMEOUT_S)
        wall = time.perf_counter() - t0
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"(f) the one-process save exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    rec = json.loads(lines[-1])
    rec["process_wall_s"] = wall
    last = rec["save_walls"][-1]
    dispatch_ms = (last.get("join_s", 0) + last.get("snapshot_s", 0)
                   + last.get("start_s", 0)) * 1e3
    rec["dispatch_ms"] = dispatch_ms
    rec["write_ms"] = last["write_s"] * 1e3
    print(f"(f) Trainer(distributed=True) in a {rec['backend']} group of {rec['world']} on "
          f"{rec['device']}, one epoch, in a process of its own ({wall:.1f} s): save parts "
          f"{sorted(last)}; dispatch {dispatch_ms:.2f} ms, the worker's host copy "
          f"{last.get('host_copy_s', float('nan')) * 1e3:.1f} ms and write "
          f"{rec['write_ms']:.1f} ms; the file equals the live state: "
          f"{rec['file_equals_state']} [{card}]", flush=True)
    if (rec["world"] != 1 or sorted(last) != OVERLAPPED_SAVE_KEYS
            or not rec["file_equals_state"]):
        raise AssertionError(f"(f) the one-process group did not overlap its save, or its "
                             f"file is not the state: {rec}")
    return rec


def run_tool(name: str, argv, card_name: str) -> dict:
    """(e): ``tools/<name>`` in a process of its own: exit 0, the card named
    on its stderr; its stdout lines and the JSON ones among them."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join("tools", name), *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(e) {name} exited {proc.returncode}: {proc.stderr[-3000:]}")
    if f"# card: {card_name}" not in proc.stderr:
        raise AssertionError(f"(e) {name}'s stderr does not name the card {card_name}")
    lines = proc.stdout.splitlines()
    return {"wall_s": wall, "lines": lines,
            "json": [json.loads(l) for l in lines if l.startswith("{")]}


def tool_checks(card_name: str, tool_argv) -> dict:
    """(e): the three tools, each line they must print."""
    runs = {name: run_tool(name, argv, card_name) for name, argv in tool_argv.items()}
    step = runs["bench_trainstep_torch.py"]
    warps = [l.split()[1] for l in step["lines"] if l.startswith("  warp ")]
    tags = [r["tag"] for r in step["json"]]
    if warps != ["shear3_per_row", "bilinear"] or tags != ["bn=reduce", "bn=matmul"]:
        raise AssertionError(f"(e) bench_trainstep_torch.py printed warps {warps}, arms {tags}")
    cuda = card_name != "cpu"
    bn = runs["bench_bn_stats_torch.py"]["json"]
    if [r["form"] for r in bn] != ["reduce", "matmul"] or (
            cuda and not all(isinstance(r["trace_tries"], list) for r in bn)):
        raise AssertionError(f"(e) bench_bn_stats_torch.py: {bn}")
    s2d = runs["bench_s2d_down_b32_torch.py"]["json"]
    if [r["s2d_downsample"] for r in s2d] != [False, True]:
        raise AssertionError(f"(e) bench_s2d_down_b32_torch.py: {s2d}")
    for r in s2d:
        want = {"resize_normalize": 1.0 * cuda, "fused_residual_block": 0.0,
                "fused_residual_block_int8": 0.0}
        if r["launches_per_call"] != want:
            raise AssertionError(f"(e) bench_s2d_down_b32_torch.py launches {r}, want {want}")
    rec = {"bench_trainstep_warps": [l.strip() for l in step["lines"] if "warp " in l],
           "bench_trainstep_forms": step["json"], "bench_bn_stats": bn,
           "bench_s2d_down_b32": s2d,
           "wall_s": {k: v["wall_s"] for k, v in runs.items()}}
    print(f"(e) the tools: {json.dumps(rec)}", flush=True)
    return rec


def last_slice_phase(spec, params, card: str, dev, size: int = 416, side: int = 1536,
                     save_set=None, tool_argv=None) -> dict:
    """Phase 18 (see the module docstring); returns its JSON record.  A CPU
    rehearsal passes a mini spec, small ``size`` and ``side``, and tool
    arguments with ``--device cpu``."""
    import numpy as np
    import torch
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    cuda = dev.type == "cuda"
    card_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(f"phase 18, the last modules of the JAX package [{card}]", flush=True)
    t_phase = time.perf_counter()
    reset_launch_counts()
    record = {}
    record["warp"] = warp_checks(warp_input(dev, size, side), dev, card)
    with tempfile.TemporaryDirectory() as root:
        record["save"] = overlapped_save(spec, dev, size, side, root, card,
                                         save_set or SAVE_SET)
    record["nms"], nms_rows = host_nms_check(spec, params, dev, size, side, card)
    record["tools"] = tool_checks(card_name, tool_argv or TOOL_ARGV)
    record["pad"] = pad_checks(dev, card)
    record["rescale"] = rescale_checks(nms_rows, dev, size, side, card)
    record["one_process_save"] = one_process_save_check(spec, dev, size, side, card,
                                                        save_set or SAVE_SET)
    counts = launch_counts()
    record["launches"] = counts
    print(f"phase 18 launches in this process: {counts}", flush=True)
    if cuda and not (counts["resize_normalize"] and counts["fused_residual_block"]):
        raise AssertionError(f"phase 18 launched a kernel of its path no time: {counts}")
    record["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 18 wall {record['wall_s']:.1f} s [{card}]", flush=True)
    return record


def division_flips(det, tiles) -> dict:
    """The int8 levels of one ``det.head_maps`` call that ``quant`` (``y ·
    f32(1/s)``) sets otherwise than ``clip(round(y / f32(s)))``, counted on
    the same ``y`` at every quantization: ``{"differ", "levels", "calls"}``.
    A record of what the quantization repair changes on the card."""
    import torch
    from amyloid_yolo_tpu_torch.ops import int8 as q8
    scales, counts = {}, {"differ": 0, "levels": 0, "calls": 0}
    inverse_scales, quant = q8.inverse_scales, q8.quant

    def inverse_scales_kept(values, device):
        inv = inverse_scales(values, device)
        for k, t in inv.items():
            scales[id(t)] = torch.tensor(values[k], dtype=torch.float32, device=device)
        return inv

    def quant_counted(y, inv):
        q = quant(y, inv)
        divided = torch.clamp(torch.round(y / scales[id(inv)]), -q8.QMAX, q8.QMAX).to(q.dtype)
        counts["differ"] += int((q != divided).sum())
        counts["levels"] += q.numel()
        counts["calls"] += 1
        return q

    q8.inverse_scales, q8.quant = inverse_scales_kept, quant_counted
    try:
        with torch.inference_mode():
            det.head_maps(torch.as_tensor(tiles).to(det.device))
    finally:
        q8.inverse_scales, q8.quant = inverse_scales, quant
    return counts


def drive(det, batches, want_counts: dict) -> None:
    """One Detector over the batches with the launch counters set to 0
    just before: the counts must be ``want_counts``, the outputs finite
    and shaped (B, 64, 7) and (B, 64)."""
    import torch
    from amyloid_yolo_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    outs = []
    for tiles in batches:
        dets, valid = det(tiles)
        outs.append((dets, valid, det._last_ncand))
    torch.cuda.synchronize()
    counts = launch_counts()
    name = det.precision if det.fold_bn else "unfolded bf16"
    print(f"{name} Detector launches: {counts}", flush=True)
    if counts != want_counts:
        raise AssertionError(f"{name} launch counts {counts}, want {want_counts}")
    for (dets, valid, ncand), tiles in zip(outs, batches):
        b = len(tiles)
        if tuple(dets.shape) != (b, 64, 7) or tuple(valid.shape) != (b, 64):
            raise AssertionError(f"output shapes {tuple(dets.shape)} {tuple(valid.shape)}")
        if not torch.isfinite(dets).all():
            raise AssertionError("non-finite detections")
        det.account_overflow(n_cand=ncand)
        print(f"n_candidates {ncand.tolist()} valid {valid.sum(dim=1).tolist()}")
    print(f"overflow images {det.overflow_images} of {det.images_seen}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from amyloid_yolo_tpu_torch.detectors import Detector
    from amyloid_yolo_tpu_torch.graphspec import from_cfg, yolov3_spec
    from amyloid_yolo_tpu_torch.io.weights import params_from_jax
    from amyloid_yolo_tpu_torch.kernels import _build, launch_counts, reset_launch_counts
    from amyloid_yolo_tpu_torch.kernels import bias_leaky, bias_mish, conv_block, spp_pool
    from amyloid_yolo_tpu_torch.kernels.conv_block import (
        K2, conv3x3_path, fused_residual_block, fused_residual_block_plain, unit_flops)
    from amyloid_yolo_tpu_torch.kernels import int8_block
    from amyloid_yolo_tpu_torch.kernels.int8_block import (
        K3, fused_residual_block_int8, fused_residual_block_int8_plain, pack_model_int8_units)
    from amyloid_yolo_tpu_torch.kernels.preprocess_kernel import (
        resize_normalize, resize_normalize_plain)
    from amyloid_yolo_tpu_torch.models import darknet

    # 1. versions and card
    starts = {"1-9": time.perf_counter()}  # each phase's start, for its wall
    card = nvidia_smi_line()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"card: {card}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    k2_sass = sass_counts("conv_block")
    print(f"K2 library: {k2_sass['HGMMA']} HGMMA (wgmma), {k2_sass['HMMA']} HMMA (mma.sync) "
          "instructions (cuobjdump -sass)", flush=True)
    if k2_sass["HGMMA"] == 0:
        raise AssertionError("K2's library has no HGMMA instruction: its 3x3 is not on wgmma")

    # 3. K1 against its plain version: bit-exact
    tiles4 = torch.randint(0, 256, (4, 1536, 1536, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    k1, k1_plain = resize_normalize(tiles4, 416), resize_normalize_plain(tiles4, 416)
    torch.cuda.synchronize()
    k1_err = (k1.float() - k1_plain.float()).abs().max().item()
    print(f"K1 resize_normalize B=4 1536->416: max|diff| {k1_err} (tolerance: bit-exact)")
    if not torch.equal(k1, k1_plain):
        raise AssertionError("K1 is not bit-exact to its plain version")

    # 4. K2 against its plain version at the five stage shapes, then on units
    # with partial m64 blocks through every kernel variant
    k2_err = 0.0
    for b in CHECK_BATCHES:
        for h, c in [s[:2] for s in STAGES] + [RAGGED_UNIT]:
            k2_err = max(k2_err, k2_check(b, h, c, dev, gen, sms))
    variants = set()
    for b, h, c in K2_RAGGED:
        plans = k2_variant_plans(b, h, c, sms)
        if not any(partial_m64(b, h, c, p) for p in plans):
            raise AssertionError(f"no plan of {b}x{h}x{h}x{c} leaves a partial m64 block")
        for plan in plans:
            k2_err = max(k2_err, k2_check(b, h, c, dev, gen, sms, plan))
            variants.add((plan.warp_n, plan.block_n))
    print(f"K2 ragged units {K2_RAGGED}: kernel variants (warp_n, block_n) "
          f"{sorted(variants)} within tolerance", flush=True)
    if variants != {(32, 64), (32, 128), (64, 128), (64, 256)}:
        raise AssertionError(f"K2's ragged units missed a wgmma variant: {sorted(variants)}")

    # 5. K3 against its plain version at the five stage shapes: bit-exact
    sx, s1, s_out = K3_SCALES
    k3_err = 0
    for b in CHECK_BATCHES:
        for h, c in [s[:2] for s in STAGES] + [RAGGED_UNIT]:
            plan, stats, _ = checked_plan(b, h, c, K3, sms)
            xq, pack = k3_stage_inputs(b, h, c, dev, gen)
            y = fused_residual_block_int8(xq, *pack, sx=sx, s1=s1, s_out=s_out)
            r = fused_residual_block_int8_plain(xq, *pack, sx=sx, s1=s1, s_out=s_out)
            torch.cuda.synchronize()
            err = (y.int() - r.int()).abs().max().item()
            k3_err = max(k3_err, err)
            print(f"K3 fused_residual_block_int8 B={b} {h}x{h}x{c}: max|diff| {err}, "
                  f"{(y != r).sum().item()} of {y.numel()} differ (tolerance: bit-exact); "
                  f"{(r.abs() == 127).float().mean().item():.4f} of the outputs saturate; "
                  f"plan {tuple(plan)}, shared memory {stats.smem} B (Python = C)", flush=True)
            if not torch.equal(y, r):
                raise AssertionError(f"K3 is not bit-exact to its plain version at "
                                     f"B={b} {h}x{h}x{c}")
            del xq, pack, y, r

    # 6. the main path
    spec = yolov3_spec(num_classes=2)
    params = params_from_jax(random_jax_params(spec, SEED), spec)
    det = Detector(spec, params, conf_thres=0.3)
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, 256, (DETECTOR_BATCHES[0], 1536, 1536, 3)).astype(np.uint8)
               for _ in range(3)]
    epilogue0 = bias_leaky.launches
    drive(det, batches, {"resize_normalize": 3, "fused_residual_block": 69,
                         "fused_residual_block_int8": 0})
    counts = launch_counts()
    epilogue_launches = bias_leaky.launches - epilogue0
    print(f"bf16 Detector epilogue launches: {epilogue_launches} (want 87, 29 a call)",
          flush=True)
    if epilogue_launches != 87:
        raise AssertionError(f"the epilogue ran {epilogue_launches} times over 3 calls, want 87")
    if spp_pool.launches != 0:
        raise AssertionError(f"the YOLOv3 calls ran the SPP kernel {spp_pool.launches} times")
    if bias_mish.into_route:
        raise AssertionError("the YOLOv3 calls wrote an epilogue into a route's slice")
    det_v4 = Detector(from_cfg(V4_CFG), model_size=608, seed=SEED)
    bias_leaky.launches = bias_mish.launches = bias_mish.into_route = 0
    drive(det_v4, batches[:1], {"resize_normalize": 1, "fused_residual_block": 0,
                                "fused_residual_block_int8": 0})
    v4_epilogues = {"bias_mish": bias_mish.launches, "bias_leaky": bias_leaky.launches,
                    "spp_pool": spp_pool.launches, "into_route": bias_mish.into_route}
    print(f"YOLOv4 bf16 Detector epilogue and SPP launches over one call: {v4_epilogues} "
          "(want 72, 38, 1 and 10 of the Mish epilogues into a CSP route's slice)", flush=True)
    if v4_epilogues != {"bias_mish": 72, "bias_leaky": 38, "spp_pool": 1, "into_route": 10}:
        raise AssertionError(f"a YOLOv4 call ran {v4_epilogues}, want 72 Mish epilogues, "
                             "38 leaky ones, 1 SPP pass and 10 Mish epilogues into a route")
    del det_v4

    with torch.inference_mode():
        tiles = torch.from_numpy(batches[0]).to(dev)
        maps = det.head_maps(tiles)
        plain_maps = darknet.apply_folded(
            det.params, spec, resize_normalize_plain(tiles, 416),
            compute_dtype=torch.bfloat16, packs=det.packs,
            block_fn=fused_residual_block_plain)
    for m, p in zip(maps, plain_maps):
        rel = ((m - p).abs().max() / p.abs().max()).item()
        print(f"head {tuple(m.shape)}: max|kernel-plain| / max|plain| = {rel} "
              f"(tolerance {HEAD_TOL}); max|plain| {p.abs().max().item()}")
        if not (torch.isfinite(m).all() and rel <= HEAD_TOL):
            raise AssertionError("head maps through the kernels disagree with the plain path")

    # 7. the int8 Detectors
    int8_dets, int8_flips = {}, {}
    for precision in ("int8_full", "int8_early"):
        d8 = Detector(spec, params, conf_thres=0.3, precision=precision)
        t0 = time.perf_counter()
        d8.calibrate(batches[0])
        torch.cuda.synchronize()
        print(f"{precision} calibration on 8 tiles: {time.perf_counter() - t0:.2f} s")
        drive(d8, batches, {"resize_normalize": 3, "fused_residual_block": 0,
                            "fused_residual_block_int8": 0})
        int8_dets[precision] = d8
        flips = division_flips(d8, batches[1])
        int8_flips[precision] = flips
        print(f"{precision} B=8: {flips['differ']} of {flips['levels']} int8 levels over "
              f"{flips['calls']} quantizations differ between y * f32(1/s) and y / s on the "
              "same values (a record, not a gate)", flush=True)
    drive(Detector(spec, params, conf_thres=0.3, fold_bn=False), batches[:1],
          {"resize_normalize": 1, "fused_residual_block": 0, "fused_residual_block_int8": 0})
    full = int8_dets["int8_full"]
    with tempfile.TemporaryDirectory() as tmp:
        sidecar = full.save_calibration(os.path.join(tmp, "int8_full.json"))
        cpu = Detector(spec, params, conf_thres=0.3, precision="int8_full", device="cpu")
        cpu.load_calibration(sidecar)
    with torch.inference_mode():
        one = torch.from_numpy(batches[1][:1])
        card_maps = full.head_maps(one.to(dev))
        cpu_maps = cpu.head_maps(one)
    for m, p in zip(card_maps, cpu_maps):
        rel = ((m.cpu() - p).abs().max() / p.abs().max()).item()
        print(f"int8_full head {tuple(m.shape)}: max|card-cpu| / max|cpu| = {rel} "
              f"(tolerance {HEAD_TOL}); max|cpu| {p.abs().max().item()}", flush=True)
        if not (torch.isfinite(m).all() and rel <= HEAD_TOL):
            raise AssertionError("int8_full head maps on the card disagree with the CPU")

    # 8. K3's path: the calibrated model's 23 units, chained stage by stage
    units = pack_model_int8_units(full._qparams, full._act_scales, spec, dev)
    if len(units) != 23:
        raise AssertionError(f"{len(units)} int8 units, want 23")

    def stage_input(b, i):
        h = 416 // (2 ** sum(1 for j in range(i) if getattr(spec.layers[j], "stride", 1) == 2))
        c = spec.layers[i].in_ch
        # leaky activations: mostly small, positive, with a negative tail
        z = 24 * torch.randn(b, h, h, c, device=dev, generator=gen)
        return torch.clamp(torch.round(torch.where(z >= 0, z, 0.1 * z)), -127, 127).to(torch.int8)

    def chain(b, fn):
        x, outs = None, []
        for i, u in units.items():
            if x is None or (i - 3) not in units:
                x = stage_input(b, i)
            y = fn(x, *u.pack, sx=u.sx, s1=u.s1, s_out=u.s_out)
            outs.append((i, x, y))
            x = y
        return outs

    def check_chain(b, outs):
        nonlocal k3_err
        n_diff = n_sat = n_all = 0
        for i, x, y in outs:
            u = units[i]
            r = fused_residual_block_int8_plain(x, *u.pack, sx=u.sx, s1=u.s1, s_out=u.s_out)
            n_diff += (y != r).sum().item()
            n_sat += (r.abs() == 127).sum().item()
            n_all += r.numel()
            k3_err = max(k3_err, (y.int() - r.int()).abs().max().item())
        print(f"K3 on the model's 23 units (B={b}): {n_diff} of {n_all} values differ from "
              f"the plain version (tolerance: bit-exact); {n_sat / n_all:.4f} of the outputs "
              "saturate", flush=True)
        if n_diff:
            raise AssertionError(f"K3 is not bit-exact on the model's units at B={b}")

    reset_launch_counts()
    outs8 = chain(8, fused_residual_block_int8)
    torch.cuda.synchronize()
    k3_launches = launch_counts()["fused_residual_block_int8"]
    print(f"K3 path (23 units of the int8_full model, B=8): {launch_counts()}")
    if k3_launches != 23:
        raise AssertionError(f"K3 path launched K3 {k3_launches} times, want 23")
    check_chain(8, outs8)
    del outs8
    check_chain(4, chain(4, fused_residual_block_int8))

    # 9. timings
    detector = {}
    with torch.inference_mode():
        for name, d in (("bf16", det), *int8_dets.items()):
            for b in DETECTOR_BATCHES:
                ms = detector_ms(d, b, dev, gen)
                detector[f"{name}_b{b}"] = {"ms_per_batch": ms, "tiles_per_s": b / ms * 1e3}
                print(f"Detector {name} B={b} (tiles on the card): {ms:.3f} ms/batch, "
                      f"{b / ms * 1e3:.1f} tiles/s [{card}]", flush=True)

        tiles8 = torch.randint(0, 256, (8, 1536, 1536, 3), dtype=torch.uint8, device=dev,
                               generator=gen)
        for name, d in (("bf16", det), ("int8_full", full)):
            detector[f"{name}_b8"].update(profile_detector(d, tiles8))
            print(f"Detector {name} B=8 device time by kernel: "
                  f"{json.dumps(detector[f'{name}_b8'])} [{card}]", flush=True)
        k1_ms = cuda_ms(lambda: resize_normalize(tiles8, 416))
        k1_plain_ms = cuda_ms(lambda: resize_normalize_plain(tiles8, 416))
        k1_bound = 8 * (416 * 1536 * 3 + 416 * 416 * 3 * 2) / PEAK_BYTES * 1e3
        print(f"K1 B=8: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, "
              f"bound {k1_bound:.4f} ms (bytes) [{card}]")

        k2_rows = {}
        for b in DETECTOR_BATCHES:
            k2_rows[b] = []
            for h, c, n in STAGES:
                plan, stats, c_bps = checked_plan(b, h, c, K2, sms)
                x, w1t, b1, w2t, b2 = k2_stage_inputs(b, h, c, dev, gen)
                ms = cuda_ms(lambda: fused_residual_block(x, w1t, b1, w2t, b2))
                plain_ms = (cuda_ms(lambda: fused_residual_block_plain(x, w1t, b1, w2t, b2))
                            if b == 8 else None)
                xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
                w1c = w1t[:, :, None, None].contiguous(memory_format=torch.channels_last)
                w2c = w2t.reshape(3, 3, c, c // 2).permute(2, 3, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                hc = torch.randn(b, c // 2, h, h, device=dev, generator=gen).to(
                    torch.bfloat16).contiguous(memory_format=torch.channels_last)
                lib_ms = (cuda_ms(lambda: F.conv2d(xc, w1c))
                          + cuda_ms(lambda: F.conv2d(hc, w2c, padding=1)))
                bound, by = k2_bound(b, h, c)
                tflops = b * unit_flops(h, h, c) / ms / 1e9
                k2_rows[b].append({
                    "shape": f"{b}x{h}x{h}x{c}", "units": n, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                    "plan": list(plan), "grid": stats.grid, "blocks_per_sm": c_bps,
                    "waves": stats.grid / (sms * c_bps), "work_ratio": stats.work_ratio,
                    "tflops": tflops, "conv3x3": conv3x3_path(c)})
                plain = f"{plain_ms:.4f} ms" if plain_ms is not None else "not measured"
                print(f"K2 B={b} {h}x{h}x{c} (3x3 on {conv3x3_path(c)}): grid {stats.grid}, "
                      f"{c_bps} blocks/SM, "
                      f"{stats.grid / (sms * c_bps):.2f} waves, executed-work ratio "
                      f"{stats.work_ratio:.3f}, {tflops:.1f} TFLOP/s; kernel {ms:.4f} ms, "
                      f"plain {plain}, cuDNN 1x1+3x3 {lib_ms:.4f} ms, bound {bound:.4f} ms "
                      f"({by}) [{card}]", flush=True)
                del x, xc, hc
        stages = k2_rows[8]
        print(f"K2 23 units: B=8 {sum(s['ms'] * s['units'] for s in stages):.4f} ms, "
              f"B=32 {sum(s['ms'] * s['units'] for s in k2_rows[32]):.4f} ms [{card}]")

        k3_rows = {}
        for b in DETECTOR_BATCHES:
            k3_rows[b] = []
            for h, c, n in STAGES:
                plan, stats, c_bps = checked_plan(b, h, c, K3, sms)
                xq, pack = k3_stage_inputs(b, h, c, dev, gen)
                ms = cuda_ms(lambda: fused_residual_block_int8(xq, *pack, sx=sx, s1=s1,
                                                               s_out=s_out))
                plain_ms = (cuda_ms(lambda: fused_residual_block_int8_plain(
                    xq, *pack, sx=sx, s1=s1, s_out=s_out)) if b == 8 else None)
                # yardstick: the two GEMMs alone, epilogues left out — the 1x1
                # on the map, the 3x3 as one GEMM on a prebuilt im2col matrix
                a1x1 = xq.reshape(-1, c)
                w1 = pack[0].t()
                hq = torch.randint(-127, 128, (b, h + 2, h + 2, c // 2), dtype=torch.int8,
                                   device=dev, generator=gen)
                cols = torch.cat([hq[:, di:di + h, dj:dj + h].reshape(-1, c // 2)
                                  for di in range(3) for dj in range(3)], dim=1)
                del hq
                w2 = pack[3].permute(1, 0, 2).reshape(c, 9 * (c // 2)).t()
                lib_ms = (cuda_ms(lambda: torch._int_mm(a1x1, w1))
                          + cuda_ms(lambda: torch._int_mm(cols, w2)))
                bound, by = k3_bound(b, h, c)
                tops = b * unit_flops(h, h, c) / ms / 1e9
                k3_rows[b].append({
                    "shape": f"{b}x{h}x{h}x{c}", "units": n, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                    "plan": list(plan), "grid": stats.grid, "blocks_per_sm": c_bps,
                    "waves": stats.grid / (sms * c_bps), "work_ratio": stats.work_ratio,
                    "tops": tops})
                plain = f"{plain_ms:.4f} ms" if plain_ms is not None else "not measured"
                print(f"K3 B={b} {h}x{h}x{c}: grid {stats.grid}, {c_bps} blocks/SM, "
                      f"{stats.grid / (sms * c_bps):.2f} waves, executed-work ratio "
                      f"{stats.work_ratio:.3f}, {tops:.1f} TOP/s; kernel {ms:.4f} ms, "
                      f"plain {plain}, _int_mm 1x1 + im2col 3x3 (GEMMs only) {lib_ms:.4f} ms, "
                      f"bound {bound:.4f} ms ({by}) [{card}]", flush=True)
                del xq, pack, cols
        stages3 = k3_rows[8]
        print(f"K3 23 units: B=8 {sum(s['ms'] * s['units'] for s in stages3):.4f} ms, "
              f"B=32 {sum(s['ms'] * s['units'] for s in k3_rows[32]):.4f} ms [{card}]")

        epilogue = epilogue_rows(spec, dev, gen, card)
        print(f"epilogue {len(epilogue)} convs of a B={EPILOGUE_BATCH} call: kernel "
              f"{sum(r['ms'] for r in epilogue):.4f} ms, plain "
              f"{sum(r['plain_ms'] for r in epilogue):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in epilogue):.4f} ms (bytes) [{card}]", flush=True)
        mish = mish_rows(dev, gen, card)
        mish_differ = sum(r["differ"] for r in mish) / sum(r["elements"] for r in mish)
        print(f"Mish epilogue {len(mish)} convs of a B={MISH_BATCH} call at 608: kernel "
              f"{sum(r['ms'] for r in mish):.4f} ms, plain "
              f"{sum(r['plain_ms'] for r in mish):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in mish):.4f} ms (bytes); "
              f"{100 * mish_differ:.6f}% of the elements differ, by one bf16 ulp [{card}]",
              flush=True)
        joined = [r for r in mish if "into_route" in r]
        print(f"Mish epilogue of the {len(joined)} CSP route members: into the routes' slices "
              f"{sum(r['into_route']['ms'] for r in joined):.4f} ms, in place "
              f"{sum(r['ms'] for r in joined):.4f} ms [{card}]", flush=True)
        spp = spp_rows(dev, gen, card)

    # 10. the folder path
    starts["10"] = time.perf_counter()
    folder = folder_phase(det, spec, params, card)
    del det, full, int8_dets, units

    # 11. the training path
    starts["11"] = time.perf_counter()
    training = training_phase(spec, params, card, dev)

    # 12. the serving path and the CLI
    starts["12"] = time.perf_counter()
    serving = serving_phase(spec, params, card, dev)
    served = serving["correctness"]

    # 13. data parallelism
    starts["13"] = time.perf_counter()
    parallel = parallel_phase(spec, params, card, dev)
    mesh_rec = parallel["mesh_detector"]

    # 14. spatial sharding
    starts["14"] = time.perf_counter()
    spatial = spatial_phase(spec, params, card, dev)

    # 15. the study path
    starts["15"] = time.perf_counter()
    study = study_phase(spec, params, card, dev)

    # 16. the layout options
    starts["16"] = time.perf_counter()
    layout = layout_phase(spec, params, card, dev)
    int8_s2d = layout["int8_launches"]["s2d"]

    # 17. the bench and the measurement tools
    starts["17"] = time.perf_counter()
    tools = bench_tools_phase(spec, params, card, dev, training)
    bench_calls = {**{f"bench {k}": v for k, v in tools["bench"]["launches_per_call"].items()},
                   **{f"cli bench {k}": v
                      for k, v in tools["cli_bench"]["launches_per_call"].items()}}
    k3_tool = [{"shape": r["shape"], "ms": r["ms"]["k3"], "bound_ms": r["k3_bound_ms"],
                "bound_by": r["k3_bound_by"], "plain_ms": r["ms"]["plain_int32"],
                "executor_ms": r["ms"]["executor_int8 (bf16 sums)"], "plan": r["k3_plan"]}
               for r in tools["int8_block"]]

    # 18. the last modules of the JAX package
    starts["18"] = time.perf_counter()
    last = last_slice_phase(spec, params, card, dev)
    s2d_tool = {f"s2d_downsample={r['s2d_downsample']}": r["launches_per_call"]
                for r in last["tools"]["bench_s2d_down_b32"]}

    def tool_launches(name):
        return {"bench_tools_launches": tools["launches"][name],
                "bench_launches_per_call": {k: v[name] for k, v in bench_calls.items()},
                "last_slice_launches": last["launches"][name],
                "s2d_down_tool_launches_per_call": {k: v[name] for k, v in s2d_tool.items()}}

    def total(rows, key):
        return sum(s[key] * s["units"] for s in rows)

    def bound_by(rows):
        ops = sum(s["bound_ms"] * s["units"] for s in rows if s["bound_by"] == "operations")
        return "operations" if ops >= total(rows, "bound_ms") / 2 else "bytes"

    kernels = [
        {"name": "resize_normalize", "route": "cuda",
         "source": "amyloid_yolo_tpu_torch/csrc/resize_normalize.cu",
         "replaces": "amyloid_yolo_tpu/pallas/preprocess_kernel.py:90",
         "launches": counts["resize_normalize"], "max_abs_err": k1_err,
         "max_abs_diff": k1_err, "tol": "bit-exact",
         "ms": k1_ms, "kernel_ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None,
         "shape": "8x1536x1536x3 u8 -> 8x416x416x3 bf16",
         "serving_launches": served["launches"]["resize_normalize"],
         "serving_dispatches": served["dispatches"],
         "mesh_launches": mesh_rec["launches"]["resize_normalize"],
         "mesh_shards": mesh_rec["shards"],
         "spatial_launches": spatial["launches"].get("resize_normalize", 0),
         "spatial_forms_launches": spatial["forms_launches"].get("resize_normalize", 0),
         "study_launches": study["launches"]["resize_normalize"],
         "s2d_bf16_launches": layout["bf16_launches"]["resize_normalize"],
         "s2d_int8_full_launches": int8_s2d["resize_normalize"],
         "layout_training_launches": layout["training"]["launches"]["resize_normalize"],
         **tool_launches("resize_normalize")},
        {"name": "fused_residual_block", "route": "cuda",
         "source": "amyloid_yolo_tpu_torch/csrc/conv_block.cu",
         "replaces": "amyloid_yolo_tpu/pallas/conv_block.py:107",
         "launches": counts["fused_residual_block"], "max_abs_err": k2_err,
         "max_abs_diff": k2_err, "tol": f"rtol {K2_RTOL} atol {K2_ATOL}",
         "ms": total(stages, "ms"), "kernel_ms": total(stages, "ms"),
         "plain_ms": total(stages, "plain_ms"), "bound_ms": total(stages, "bound_ms"),
         "bound_by": bound_by(stages), "library_ms": total(stages, "library_ms"),
         "shape": "the 23 units of one B=8 batch", "stages": stages,
         "stages_b32": k2_rows[32], "sass": k2_sass,
         "serving_launches": served["launches"]["fused_residual_block"],
         "serving_dispatches": served["dispatches"],
         "mesh_launches": mesh_rec["launches"]["fused_residual_block"],
         "mesh_shards": mesh_rec["shards"],
         "spatial_launches": spatial["launches"].get("fused_residual_block", 0),
         "spatial_forms_launches": spatial["forms_launches"].get("fused_residual_block", 0),
         "study_launches": study["launches"]["fused_residual_block"],
         "s2d_bf16_launches": layout["bf16_launches"]["fused_residual_block"],
         "s2d_int8_full_launches": int8_s2d["fused_residual_block"],
         "layout_training_launches": layout["training"]["launches"]["fused_residual_block"],
         **tool_launches("fused_residual_block")},
        {"name": "fused_residual_block_int8", "route": "cuda",
         "source": "amyloid_yolo_tpu_torch/csrc/int8_block.cu",
         "replaces": "amyloid_yolo_tpu/pallas/int8_block.py:150",
         "launches": k3_launches, "max_abs_err": k3_err,
         "max_abs_diff": k3_err, "tol": "bit-exact",
         "ms": total(stages3, "ms"), "kernel_ms": total(stages3, "ms"),
         "plain_ms": total(stages3, "plain_ms"), "bound_ms": total(stages3, "bound_ms"),
         "bound_by": bound_by(stages3), "library_ms": total(stages3, "library_ms"),
         "shape": "the 23 units of one B=8 batch", "stages": stages3,
         "stages_b32": k3_rows[32],
         "serving_launches": served["launches"]["fused_residual_block_int8"],
         "serving_dispatches": served["dispatches"],
         "spatial_launches": spatial["launches"].get("fused_residual_block_int8", 0),
         "spatial_forms_launches": spatial["forms_launches"].get("fused_residual_block_int8", 0),
         "study_launches": study["launches"]["fused_residual_block_int8"],
         "s2d_bf16_launches": layout["bf16_launches"]["fused_residual_block_int8"],
         "s2d_int8_full_launches": int8_s2d["fused_residual_block_int8"],
         "layout_training_launches":
             layout["training"]["launches"]["fused_residual_block_int8"],
         **tool_launches("fused_residual_block_int8"), "int8_block_tool": k3_tool},
        {"name": "bias_leaky", "route": "cuda",
         "source": "amyloid_yolo_tpu_torch/csrc/bias_leaky.cu",
         "replaces": None,  # XLA fused the bias and the leaky into each conv
         "launches": epilogue_launches, "launches_per_call": epilogue_launches / 3,
         "max_abs_err": 0, "max_abs_diff": 0, "tol": "bit-exact",
         "ms": sum(r["ms"] for r in epilogue), "kernel_ms": sum(r["ms"] for r in epilogue),
         "plain_ms": sum(r["plain_ms"] for r in epilogue),
         "bound_ms": sum(r["bound_ms"] for r in epilogue), "bound_by": "bytes",
         "library_ms": None,
         "shape": f"the {len(epilogue)} conv outputs outside the residual units of one "
                  f"B={EPILOGUE_BATCH} call", "convs": epilogue},
        {"name": "bias_mish", "route": "cuda",
         "source": "amyloid_yolo_tpu_torch/csrc/bias_leaky.cu",
         "replaces": None,  # the Mish form of the epilogue, for YOLOv4's CSPDarknet53
         "launches": v4_epilogues["bias_mish"],
         "launches_per_call": v4_epilogues["bias_mish"],
         "max_abs_err": max(r["max_abs_diff"] for r in mish),
         "max_abs_diff": max(r["max_abs_diff"] for r in mish),
         "max_ulps": max(r["max_ulps"] for r in mish), "differ_share": mish_differ,
         "tol": "one bf16 ulp",
         "ms": sum(r["ms"] for r in mish), "kernel_ms": sum(r["ms"] for r in mish),
         "plain_ms": sum(r["plain_ms"] for r in mish),
         "bound_ms": sum(r["bound_ms"] for r in mish), "bound_by": "bytes",
         "library_ms": None,
         "shape": f"the {len(mish)} Mish conv outputs of one B={MISH_BATCH} YOLOv4 call at 608",
         "convs": mish},
        {"name": "spp_pool", "route": "cuda",
         "source": "amyloid_yolo_tpu_torch/csrc/spp_pool.cu",
         "replaces": None,  # XLA ran YOLOv4's pools and their concatenate
         "launches": v4_epilogues["spp_pool"], "launches_per_call": v4_epilogues["spp_pool"],
         "max_abs_err": 0, "max_abs_diff": 0, "tol": "bit-exact",
         "ms": sum(r["ms"] for r in spp), "kernel_ms": sum(r["ms"] for r in spp),
         "plain_ms": sum(r["plain_ms"] for r in spp),
         "bound_ms": sum(r["bound_ms"] for r in spp), "bound_by": "bytes",
         "library_ms": sum(r["plain_ms"] for r in spp),
         "shape": f"the SPP block of one B={MISH_BATCH} YOLOv4 call at 608", "blocks": spp},
    ]
    detector["int8_division_flips"] = int8_flips
    ends = [*list(starts.values())[1:], time.perf_counter()]
    walls = {k: round(e - t, 1) for (k, t), e in zip(starts.items(), ends)}
    print(f"phase walls s {json.dumps(walls)}; the script "
          f"{ends[-1] - starts['1-9']:.1f} s [{card}]", flush=True)
    print(json.dumps({"detector": detector, "card": card}))
    print(json.dumps({"folder": folder, "card": card}))
    print(json.dumps({"training": training, "card": card}))
    print(json.dumps({"serving": serving, "card": card}))
    print(json.dumps({"parallel": parallel, "card": card}))
    print(json.dumps({"spatial": spatial, "card": card}))
    print(json.dumps({"study": study, "card": card}))
    print(json.dumps({"layout": layout, "card": card}))
    print(json.dumps({"bench_tools": tools, "card": card}))
    print(json.dumps({"last_slice": last, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-child"]:
        sys.exit(dp_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--grad-probe"]:
        sys.exit(grad_probe(sys.argv[2]))
    sys.exit(main())
