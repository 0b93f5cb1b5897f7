"""Command-line entry points of the port: the reference package's CLI on the
GPU.

``python -m amyloid_yolo_tpu_torch.cli <command>`` (or the ``amyolo-torch``
script) with the reference package's commands, options and defaults:

* ``train``  — the ``Trainer`` (the original ``train.py:27-210``);
* ``test``   — mAP evaluation (``test.py:69-115``);
* ``detect`` — folder inference with the merge, CAA-filter and CAA-pickle
  flags (``detect.py:30-171``); boolean flags take real booleans and the
  original's ``"True"`` strings;
* ``serve``  — the HTTP detection service (:mod:`..serving`);
* ``sweep``  — the whole-slide sweep (:mod:`..analysis.validation`);
* ``crop``   — WSI tiling (``crop.py``);
* ``export`` — weight conversion between ``.pth`` and darknet ``.weights``;
* ``clear``  — output reset (``clear.py``);
* ``bench``  — runs ``bench_torch.py`` at the repo root, the port's
  counterpart of ``bench.py`` (its ``BENCH_*`` environment); it measures
  the card and raises without one, ``--device`` or not.

Where the port differs:

* every command takes ``--device`` (default ``cuda``); a command that builds
  a model raises without CUDA unless ``--device cpu`` is passed;
* ``--fast_path`` leaves out one of the reference's Detector options, its
  ``approx_topk=True``: the GPU has no approximate top-k, and the port
  selects the candidate pool exactly;
* ``export`` reads and writes ``.pth`` and darknet ``.weights`` and reads the
  port's ``Trainer`` checkpoints (``path#ema`` for the EMA); orbax
  directories are not ported and raise;
* ``sweep --data_parallel N`` splits each batch over a mesh of N devices
  (:mod:`..parallel.mesh`): ``cuda:0 .. N-1`` by default, N CPU entries
  with ``--device cpu``, or the N devices that ``--device`` lists,
  comma-separated (``cuda:0,cuda:0`` runs two shards on one card);
* ``train --distributed True`` runs one process a device: under
  ``torchrun`` without ``--coordinator_address`` (``env://``), or with
  ``--coordinator_address host:port --num_processes N --process_id i`` in
  each process;
* ``train --spatial_shard N`` splits the image height over N devices
  (:mod:`..parallel.spatial`), with ``--data_parallel M`` over M rows of N;
  ``--device`` names them as for the sweep (``cpu``: CPU entries;
  ``cuda:0,cuda:0``: two shards on one card).  It refuses ``--distributed``,
  and runs the s2d stem where the spec qualifies, as without it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _truthy(v) -> bool:
    """Accept bools and the original's ``--flag True`` strings
    (``detect.py:132``)."""
    if isinstance(v, bool):
        return v
    return str(v) == "True" or str(v).lower() == "true" or str(v) == "1"


def _fast_path_kwargs(args) -> dict:
    """Detector kwargs for ``--fast_path True``: the int8 fast stack (int8,
    lazy sparse decode).  Off by default: the box-for-box parity pipeline.

    ``--precision`` selects the int8 flavour: ``int8_early`` (the default,
    the backbone prefix in int8) or ``int8_full``, which adds
    ``s2d_stem=True`` as the reference does.  The reference's
    ``approx_topk=True`` is left out: the port always selects the candidate
    pool exactly (:func:`~..ops.nms.topk_stable`)."""
    if not _truthy(getattr(args, "fast_path", False)):
        ignored = [f"--{n}" for n in ("precision", "calib_percentile")
                   if getattr(args, n, None) is not None]
        if ignored:
            import warnings

            warnings.warn(
                f"{' and '.join(ignored)} only take effect with "
                f"--fast_path True — running the box-for-box parity "
                f"(bf16, amax) pipeline instead.", UserWarning,
                stacklevel=2)
        return {}
    precision = getattr(args, "precision", None) or "int8_early"
    kw = {"precision": precision, "lazy_decode": True}
    if precision == "int8_early":
        kw["int8_downsample"] = 32
    elif precision == "int8_full":
        kw["s2d_stem"] = True
    pct = getattr(args, "calib_percentile", None)
    if pct is not None:
        kw["calib_percentile"] = float(pct)
    return kw


def _capacity_kwargs(args) -> dict:
    """``--nms_pool N``: raise BOTH the pre-NMS candidate pool and the
    returned-detection capacity to N (the original loop is uncapped; the
    overflow counters report when the default 64 truncated)."""
    pool = getattr(args, "nms_pool", None)
    if pool:
        return {"capacity": int(pool), "nms_pool": int(pool)}
    return {}


def _spec_from_args(args):
    """Graph spec for the commands other than ``train``: ``--model_def
    <cfg>`` (the original's ``--model_def``) or the 2-class YOLOv3.  A
    checkpoint trained with re-estimated anchors has the same parameter
    layout but decodes garbage under the wrong table, so every command that
    loads one takes the cfg."""
    from ..graphspec import from_cfg, yolov3_spec

    md = getattr(args, "model_def", None)
    return from_cfg(md) if md else yolov3_spec(num_classes=2)


def _classes(args):
    from ..parsecfg import load_classes

    return load_classes(args.class_path) if os.path.exists(args.class_path) \
        else ["CAA", "Cored"]


def _train_config(args):
    """The ``TrainConfig`` of a ``train`` command line (the reference
    package's fields, filled as its CLI fills them)."""
    from ..training import TrainConfig

    return TrainConfig(
        data_config=args.data_config,
        epochs=args.epochs,
        batch_size=args.batch_size,
        gradient_accumulations=args.gradient_accumulations,
        img_size=args.img_size,
        multiscale=_truthy(args.multiscale_training),
        pretrained_weights=args.pretrained_weights,
        checkpoint_interval=args.checkpoint_interval,
        evaluation_interval=args.evaluation_interval,
        logdir=args.logdir,
        verbose=args.verbose,
        data_parallel=args.data_parallel,
        spatial_shard=args.spatial_shard,
        checkpoint_dir=args.checkpoint_dir,
        augment=not args.no_augment,
        max_batches_per_epoch=args.max_batches_per_epoch,
        grad_clip_norm=args.grad_clip_norm,
        learning_rate=args.learning_rate,
        burn_in=args.burn_in,
        compute_dtype=args.compute_dtype,
        cache_images=_truthy(args.cache_images),
        host_resize=_truthy(args.host_resize),
        s2d_stem=(None if args.s2d_stem == "auto" else _truthy(args.s2d_stem)),
        image_layout=args.image_layout,
        ema_decay=args.ema_decay,
        eval_nms_capacity=args.eval_nms_capacity,
        keep_checkpoints=args.keep_checkpoints,
        distributed=_truthy(args.distributed),
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )


def cmd_train(args) -> int:
    from ..graphspec import from_cfg
    from ..training import Trainer

    # the original's train.py:31 --model_def: the graph from a darknet cfg
    spec = from_cfg(args.model_def) if getattr(args, "model_def", None) else None
    trainer = Trainer(_train_config(args), spec=spec, device=args.device)
    if args.resume:
        # a Trainer checkpoint, the optimizer state included (the original's
        # --pretrained_weights reloads weights only, train.py:64-68)
        trainer.load_checkpoint(args.resume)
    trainer.train()
    return 0


def cmd_test(args) -> int:
    from ..evaluate import evaluate
    from ..io import weights as W
    from ..parsecfg import load_classes, parse_data_config

    spec = _spec_from_args(args)
    data = parse_data_config(args.data_config)
    params = W.load_pretrained(spec, args.weights_path)
    out = evaluate(spec, params, data["valid"], iou_thres=args.iou_thres,
                   conf_thres=args.conf_thres, nms_thres=args.nms_thres,
                   img_size=args.img_size, batch_size=args.batch_size,
                   nms_capacity=args.nms_capacity, device=args.device)
    if out is None:
        print("no detections")
        return 1
    precision, recall, ap, f1, ap_class = out
    class_names = load_classes(data["names"]) if os.path.exists(data["names"]) else None
    print("Average Precisions:")
    for i, c in enumerate(ap_class):
        name = class_names[int(c)] if class_names else str(c)
        print(f"+ Class '{c}' ({name}) - AP: {ap[i]}")
    print(f"mAP: {ap.mean()}")
    return 0


def cmd_detect(args) -> int:
    from PIL import Image

    from ..detectors import Detector
    from ..domain import CAAFilter, clear_output_dir, draw_detections, write_caa_detections
    from ..io import weights as W
    from ..io.datasets import load_image_rgb

    spec = _spec_from_args(args)
    params = W.load_pretrained(spec, args.weights_path) if args.weights_path else None
    classes = _classes(args)
    det = Detector(spec, params, conf_thres=args.conf_thres, nms_thres=args.nms_thres,
                   model_size=args.img_size, device=args.device,
                   **_fast_path_kwargs(args), **_capacity_kwargs(args))
    if getattr(args, "calibration", None):
        det.load_calibration(args.calibration)
    caa_filter = None
    if _truthy(args.filter_CAA_detections_by_model):
        caa_filter = CAAFilter(model_pickle=args.caa_model_pickle,
                               normalization=args.caa_normalization, classes=classes,
                               device=args.device)
    clear_output_dir(args.output_dir)
    write_pickle = _truthy(args.write_CAA_detections_to_pickle)
    if write_pickle:
        import pickle

        os.makedirs("pickles", exist_ok=True)
        with open("pickles/CAA_detections.pkl", "wb") as fh:
            pickle.dump({}, fh)
    results = det.detect_folder(
        args.image_folder, batch_size=args.batch_size,
        merge_boxes=_truthy(args.merge_boxes),
        caa_filter=(caa_filter.filter_path if caa_filter else None),
        fast_decode=_truthy(args.fast_decode),
        background_skip=_truthy(args.background_skip),
    )
    if getattr(args, "save_calibration", None) and det._act_scales is not None:
        print(f"calibration -> {det.save_calibration(args.save_calibration)}",
              flush=True)
    if det.overflow_images:
        print(f"WARNING: {det.overflow_images}/{det.images_seen} images "
              f"exceeded the NMS candidate pool (nms_pool={det.nms_pool}, "
              f"max seen {det.max_candidates_seen}); detections were "
              f"truncated on them — raise --nms_pool.", flush=True)
    for path, dets in results.items():
        if dets is None:
            continue
        if write_pickle:
            write_caa_detections("pickles/CAA_detections.pkl", path, dets, classes)
        out = draw_detections(load_image_rgb(path), dets, classes)
        Image.fromarray(out).save(os.path.join(args.output_dir, path.replace("/", "_")))
        for row in dets:
            print("\t+ Label: %s, Conf: %.5f" % (classes[int(row[6])], row[5]))
    return 0


def cmd_serve(args) -> int:
    """The HTTP detection service (:class:`..serving.DetectionServer`):
    micro-batched dispatch of one batch shape, ``POST /v1/detect`` (an
    encoded image, or raw uint8 RGB with ``X-Image-Shape: H,W``),
    ``/healthz`` and ``/stats``.  Runs until interrupted (SIGINT)."""
    from ..detectors import Detector
    from ..domain import CAAFilter
    from ..io import weights as W
    from ..serving import DetectionServer

    spec = _spec_from_args(args)
    params = W.load_pretrained(spec, args.weights_path) if args.weights_path else None
    classes = _classes(args)
    det = Detector(spec, params, conf_thres=args.conf_thres,
                   nms_thres=args.nms_thres, model_size=args.img_size,
                   host_resize=_truthy(args.host_resize), device=args.device,
                   **_fast_path_kwargs(args), **_capacity_kwargs(args))
    if getattr(args, "calibration", None):
        # persisted scales before the socket opens: no early request can
        # race an uncalibrated detector
        det.load_calibration(args.calibration)
    caa_filter = None
    if _truthy(args.filter_CAA_detections_by_model):
        caa_filter = CAAFilter(model_pickle=args.caa_model_pickle,
                               normalization=args.caa_normalization,
                               classes=classes, device=args.device)
    server = DetectionServer(
        det, classes, host=args.host, port=args.port,
        batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        merge_boxes=_truthy(args.merge_boxes), caa_filter=caa_filter,
        native_decode=_truthy(args.native_decode),
        fast_decode=_truthy(args.fast_decode),
        max_queue=args.max_queue,
        max_body_bytes=int(args.max_body_mb * 1024 * 1024),
        max_side=args.max_side,
        request_timeout_s=args.request_timeout_s)
    server.start()
    print(f"serving on http://{args.host}:{server.port} "
          f"(batch {server.executor.batch_size}, precision {det.precision}, "
          f"device {det.device})", flush=True)
    try:
        if _truthy(args.warmup):
            if (det.precision.startswith("int8") and args.calibration_folder
                    and det._act_scales is None):
                from ..io.datasets import ImageFolder

                # the folder calibrator gathers ~CALIB_TILES tiles at the
                # executor's batch size, in the frame inference sees
                folder = ImageFolder(
                    args.calibration_folder, tile_size=det.tile_size,
                    resize_to=det.model_size if det.host_resize else None)
                det._calibrate_from_folder(folder, server.executor.batch_size)
                if getattr(args, "save_calibration", None):
                    print(f"calibration -> "
                          f"{det.save_calibration(args.save_calibration)}",
                          flush=True)
            if server.warmup():
                print("pipeline warmed up; ready", flush=True)
            else:
                print("warmup skipped (uncalibrated int8 — pass "
                      "--calibration_folder); the first request calibrates",
                      flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def _sweep_mesh(n, device: str):
    """The mesh of ``sweep --data_parallel n`` (``None`` for one device):
    ``--device`` names one device type (``cuda``: cards 0 .. n-1; ``cpu``:
    n CPU entries) or lists the n devices, comma-separated."""
    from ..parallel.mesh import make_mesh

    if not n or n <= 1:
        if "," in device:
            raise ValueError(f"--device {device} lists several devices: pass "
                             "--data_parallel with their count")
        return None
    if "," in device:
        return make_mesh(n, devices=[d.strip() for d in device.split(",")])
    if device == "cpu":
        return make_mesh(devices=["cpu"] * n)
    if device != "cuda":
        raise ValueError(f"--data_parallel {n} takes --device cuda, cpu or a list of "
                         f"{n} devices, not {device!r}")
    return make_mesh(n)


def cmd_sweep(args) -> int:
    """Whole-slide sweep: per-WSI and per-tile plaque counts (the original
    ``validation.py`` ``calculatePlaqueCountsPerWSI``)."""
    from ..analysis.validation import calculate_plaque_counts_per_wsi
    from ..detectors import Detector
    from ..domain import CAAFilter, wsis_with_most_caas
    from ..io import weights as W

    spec = _spec_from_args(args)
    params = W.load_pretrained(spec, args.weights_path) if args.weights_path else None
    mesh = _sweep_mesh(args.data_parallel, args.device)
    device = mesh.devices[0] if mesh is not None else args.device
    det = Detector(spec, params, conf_thres=args.conf_thres,
                   nms_thres=args.nms_thres, device=device, mesh=mesh,
                   **_fast_path_kwargs(args), **_capacity_kwargs(args))
    caa_filter = None
    if _truthy(args.filter_CAA_detections_by_model):
        caa_filter = CAAFilter(model_pickle=args.caa_model_pickle,
                               normalization=args.caa_normalization, device=device)
    whitelist = None
    if args.top_caa_wsis and args.top_caa_counts_pickle:
        whitelist = wsis_with_most_caas(args.top_caa_counts_pickle, args.top_caa_wsis)
    counts = calculate_plaque_counts_per_wsi(
        args.directory, det, caa_filter=caa_filter, prefix=args.prefix,
        pickles_dir=args.pickles_dir, batch_size=args.batch_size,
        save_images=_truthy(args.save_images), wsi_whitelist=whitelist,
        cross_tile_merge=_truthy(args.cross_tile_merge),
        background_skip=_truthy(args.background_skip),
        background_max_bpp=args.background_max_bpp,
        background_min_tissue=args.background_min_tissue,
    )
    for wsi, c in counts.items():
        print(f"{wsi}: Cored={c['Cored']} CAA={c['CAA']}")
    return 0


def cmd_crop(args) -> int:
    from ..io import tiles

    failed = tiles.crop_wsis(args.wsi_dirs, args.save_dir,
                             temp_map_pickle=args.temp_map_pickle,
                             min_tissue_fraction=args.min_tissue_fraction)
    if failed:
        print("failed to tile: {}".format(failed))
    tiles.merge_1536_subdirectories(args.save_dir)
    if args.temp_map_pickle and os.path.exists(args.temp_map_pickle):
        tiles.rename_temp_directories(args.save_dir, args.temp_map_pickle)
    return 0


def _orbax_not_ported(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path!r}: orbax checkpoints are not ported to the PyTorch package; "
        "use a .pth or darknet .weights file (the reference package's CLI "
        "exports an orbax checkpoint to either)")


def cmd_export(args) -> int:
    """Convert between weight formats: a ``.pth`` state dict, a darknet
    ``.weights`` binary (the original ``models.py:257-336`` formats) or a
    checkpoint of the port's ``Trainer`` (``path#ema`` for its EMA) to a
    ``.pth`` or ``.weights`` file."""
    import torch

    from ..io import weights as W

    spec = _spec_from_args(args)
    src, dst = args.src, args.dst
    if os.path.isdir(src.removesuffix("#ema")):
        raise _orbax_not_ported(src)
    if dst.endswith(".pth"):
        params = W.load_pretrained(spec, src)
        torch.save(W.params_to_torch_state_dict(spec, params), dst)
    elif dst.endswith(".weights") or "darknet" in os.path.basename(dst):
        W.save_darknet_weights(spec, W.load_pretrained(spec, src), dst, seen=args.seen)
    else:
        raise _orbax_not_ported(dst)
    print(f"exported {src} -> {dst}")
    return 0


def cmd_clear(args) -> int:
    from ..domain import clear_output_dir

    clear_output_dir(args.output_dir)
    return 0


def cmd_bench(args) -> int:
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(os.path.dirname(__file__), "../../bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    return 0


CFG_HELP = ("darknet cfg to build the graph from (e.g. a re-anchored cfg; "
            "default: the native 2-class builder)")
PERCENTILE_HELP = ("int8 activation-scale statistic for --fast_path: omit = amax; "
                   "e.g. 99.9 = that percentile of |acts|, computed per probe batch "
                   "and max-combined")
BG_SKIP_HELP = ("skip background tiles before full-size decode (file-size stage + "
                "decode-confirm stage; the host decode is the sweep bottleneck)")
NMS_POOL_HELP = ("raise the NMS candidate pool + detection capacity (default 64); "
                 "overflow warnings tell you when to")


def build_parser() -> argparse.ArgumentParser:
    """The reference package's parser, option for option and default for
    default, plus ``--device`` on every command."""
    p = argparse.ArgumentParser(prog="amyolo-torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train")
    t.add_argument("--model_def", type=str, default=None,
                   help="darknet cfg to build the model from (default: the "
                        "native yolov3_spec builder); the original train.py:31")
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--batch_size", type=int, default=8)
    t.add_argument("--gradient_accumulations", type=int, default=2)
    t.add_argument("--data_config", type=str, default="config/custom.data")
    t.add_argument("--pretrained_weights", type=str)
    t.add_argument("--img_size", type=int, default=416)
    t.add_argument("--checkpoint_interval", type=int, default=1)
    t.add_argument("--evaluation_interval", type=int, default=1)
    t.add_argument("--multiscale_training", default=True)
    t.add_argument("--verbose", "-v", default=False, action="store_true")
    t.add_argument("--logdir", type=str, default="logs")
    t.add_argument("--data_parallel", type=int, default=None,
                   help="N shards in one process, one device each (--device cpu: "
                        "N CPU entries)")
    t.add_argument("--spatial_shard", type=int, default=None,
                   help="N devices the image height splits over (with --data_parallel M: "
                        "M rows of N; --device cpu: CPU entries)")
    t.add_argument("--distributed", type=str, default="False",
                   help="one process a device (NCCL); under torchrun, or with "
                        "--coordinator_address, --num_processes and --process_id")
    t.add_argument("--coordinator_address", type=str, default=None)
    t.add_argument("--num_processes", type=int, default=None)
    t.add_argument("--process_id", type=int, default=None)
    t.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    t.add_argument("--no_augment", action="store_true")
    t.add_argument("--max_batches_per_epoch", type=int, default=None)
    t.add_argument("--grad_clip_norm", type=float, default=None)
    t.add_argument("--learning_rate", type=float, default=1e-3)
    t.add_argument("--burn_in", type=int, default=0,
                   help="darknet LR warmup steps (the cfg declares 1000; "
                        "the original trainer ignores it — opt-in)")
    t.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="training compute dtype (bfloat16: convs in bf16; "
                        "params/optimizer/BN stats stay f32)")
    t.add_argument("--cache_images", type=str, default="False",
                   help="RAM-cache decoded training images across epochs")
    t.add_argument("--host_resize", type=str, default="False",
                   help="apply the (bit-identical) nearest multiscale resize "
                        "on the host before the upload")
    t.add_argument("--s2d_stem", type=str, default="auto",
                   help="space-to-depth training stem (auto/True/False): layers "
                        "0-1 on the s2d grid, gradients mapped back to the 3x3 "
                        "weights; auto = on where the stem qualifies, "
                        "--spatial_shard N included")
    t.add_argument("--keep_checkpoints", type=int, default=None,
                   help="retention: keep only the most recent N epoch "
                        "checkpoints plus every tracked best epoch "
                        "(default: keep all, the original behaviour)")
    t.add_argument("--eval_nms_capacity", type=int, default=128,
                   help="NMS candidate pool for the in-training eval")
    t.add_argument("--ema_decay", type=float, default=None,
                   help="track an exponential moving average of the weights "
                        "(e.g. 0.999) and evaluate it beside the raw weights")
    t.add_argument("--image_layout", type=str, default="planar",
                   choices=["planar", "nhwc"],
                   help="in-step image layout: planar runs the resize and the "
                        "augmentation on (B, 3, H, W) images; the same results")
    t.add_argument("--resume", type=str, default=None,
                   help="a checkpoint of the port's Trainer to resume from "
                        "(restores the optimizer state too)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("test")
    e.add_argument("--model_def", type=str, default=None, help=CFG_HELP)
    e.add_argument("--batch_size", type=int, default=8)
    e.add_argument("--data_config", type=str, default="config/custom.data")
    e.add_argument("--weights_path", type=str, required=True)
    e.add_argument("--iou_thres", type=float, default=0.5)
    e.add_argument("--conf_thres", type=float, default=0.5)
    e.add_argument("--nms_thres", type=float, default=0.5)
    e.add_argument("--img_size", type=int, default=416)
    e.add_argument("--nms_capacity", type=int, default=128,
                   help="NMS candidate pool; evaluate warns when any image "
                        "overflows it (truncation depresses mAP)")
    e.set_defaults(fn=cmd_test)

    d = sub.add_parser("detect")
    d.add_argument("--model_def", type=str, default=None, help=CFG_HELP)
    d.add_argument("--image_folder", type=str, default="data/samples")
    d.add_argument("--weights_path", type=str)
    d.add_argument("--class_path", type=str, default="data/custom/classes.names")
    d.add_argument("--conf_thres", type=float, default=0.8)
    d.add_argument("--nms_thres", type=float, default=0.4)
    d.add_argument("--batch_size", default="8",
                   help="int, or 'auto' (32 for deep queues, else 16)")
    d.add_argument("--img_size", type=int, default=416)
    d.add_argument("--output_dir", type=str, default="output")
    d.add_argument("--merge_boxes", type=str, default="False")
    d.add_argument("--write_CAA_detections_to_pickle", type=str, default="False")
    d.add_argument("--filter_CAA_detections_by_model", type=str, default="False")
    d.add_argument("--caa_model_pickle", type=str,
                   default="pickles/model_all_fold_3_thresholding_2_l2.pkl")
    d.add_argument("--caa_normalization", type=str, default="pickles/normalization.npy")
    d.add_argument("--fast_decode", type=str, default="False",
                   help="DCT-scaled JPEG decode on the native host path "
                        "(pixels are the scaled rendition, not bit-identical)")
    d.add_argument("--precision", type=str, default=None,
                   choices=["int8_early", "int8_full"],
                   help="int8 flavor for --fast_path (default int8_early)")
    d.add_argument("--calib_percentile", type=float, default=None, help=PERCENTILE_HELP)
    d.add_argument("--fast_path", type=str, default="False",
                   help="int8 + lazy decode + approx top-k (selected exactly on "
                        "the GPU); non-parity")
    d.add_argument("--background_skip", type=str, default="False", help=BG_SKIP_HELP)
    d.add_argument("--calibration", type=str, default=None,
                   help="int8 scale sidecar (Detector.save_calibration) — "
                        "skips the lazy 48-tile folder calibration")
    d.add_argument("--save_calibration", type=str, default=None,
                   help="write the int8 scales used for this run (with "
                        "tile-list provenance) to this JSON sidecar")
    d.add_argument("--nms_pool", type=int, default=None, help=NMS_POOL_HELP)
    d.set_defaults(fn=cmd_detect)

    sv = sub.add_parser("serve")
    sv.add_argument("--model_def", type=str, default=None, help=CFG_HELP)
    sv.add_argument("--host", type=str, default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8498)
    sv.add_argument("--weights_path", type=str)
    sv.add_argument("--class_path", type=str, default="data/custom/classes.names")
    sv.add_argument("--conf_thres", type=float, default=0.8)
    sv.add_argument("--nms_thres", type=float, default=0.4)
    sv.add_argument("--img_size", type=int, default=416)
    sv.add_argument("--batch_size", type=int, default=16,
                    help="fixed micro-batch shape")
    sv.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="how long a lone request waits for company")
    sv.add_argument("--merge_boxes", type=str, default="True")
    sv.add_argument("--host_resize", type=str, default="False",
                    help="resize tiles on the host before the upload")
    sv.add_argument("--warmup", type=str, default="True",
                    help="run one dispatch before reporting ready")
    sv.add_argument("--calibration_folder", type=str, default=None,
                    help="representative tiles for int8 scale calibration "
                         "(int8 precisions; without it warmup is skipped — "
                         "never noise-calibrated — and the first real "
                         "request calibrates)")
    sv.add_argument("--filter_CAA_detections_by_model", type=str, default="False")
    sv.add_argument("--caa_model_pickle", type=str,
                    default="pickles/model_all_fold_3_thresholding_2_l2.pkl")
    sv.add_argument("--caa_normalization", type=str, default="pickles/normalization.npy")
    sv.add_argument("--precision", type=str, default=None,
                    choices=["int8_early", "int8_full"],
                    help="int8 flavor for --fast_path (default int8_early)")
    sv.add_argument("--calib_percentile", type=float, default=None, help=PERCENTILE_HELP)
    sv.add_argument("--fast_path", type=str, default="False",
                    help="int8 + lazy decode + approx top-k (selected exactly "
                         "on the GPU); non-parity")
    sv.add_argument("--native_decode", type=str, default="True",
                    help="C++ in-memory JPEG decode for exact-tile requests "
                         "(bit-identical, GIL-free; PIL fallback otherwise)")
    sv.add_argument("--fast_decode", type=str, default="False",
                    help="DCT-scaled native decode when --host_resize True "
                         "(non-parity pixels)")
    sv.add_argument("--max_queue", type=int, default=None,
                    help="bounded executor queue depth (default 8x batch); "
                         "bursts past it are shed with 503 + Retry-After")
    sv.add_argument("--max_body_mb", type=float, default=32.0,
                    help="reject request bodies larger than this (413, "
                         "checked on the Content-Length header)")
    sv.add_argument("--calibration", type=str, default=None,
                    help="int8 scale sidecar — start calibrated with no "
                         "--calibration_folder")
    sv.add_argument("--save_calibration", type=str, default=None,
                    help="write the folder-calibrated int8 scales to this "
                         "JSON sidecar for future --calibration starts")
    sv.add_argument("--max_side", type=int, default=None,
                    help="reject images whose longer side exceeds this "
                         "(default: the detector tile size; guards the "
                         "pad-to-square allocation)")
    sv.add_argument("--request_timeout_s", type=float, default=120.0,
                    help="per-request queue+device timeout (503 on expiry)")
    sv.add_argument("--nms_pool", type=int, default=None, help=NMS_POOL_HELP)
    sv.set_defaults(fn=cmd_serve)

    s = sub.add_parser("sweep")
    s.add_argument("--model_def", type=str, default=None, help=CFG_HELP)
    s.add_argument("--directory", type=str, required=True,
                   help="tiled WSI root (e.g. data/CERAD/1536_tiles/)")
    s.add_argument("--weights_path", type=str)
    s.add_argument("--prefix", type=str, default="CERAD_")
    s.add_argument("--pickles_dir", type=str, default="pickles")
    s.add_argument("--conf_thres", type=float, default=0.8)
    s.add_argument("--nms_thres", type=float, default=0.4)
    s.add_argument("--batch_size", default="8",
                   help="int, or 'auto' (32 for deep queues, else 16)")
    s.add_argument("--save_images", type=str, default="False")
    s.add_argument("--filter_CAA_detections_by_model", type=str, default="True")
    s.add_argument("--caa_model_pickle", type=str,
                   default="pickles/model_all_fold_3_thresholding_2_l2.pkl")
    s.add_argument("--caa_normalization", type=str, default="pickles/normalization.npy")
    s.add_argument("--top_caa_wsis", type=int, default=None)
    s.add_argument("--top_caa_counts_pickle", type=str, default=None)
    s.add_argument("--cross_tile_merge", type=str, default="False",
                   help="merge detections across adjacent tile boundaries "
                        "(the original double-counts boundary-straddling "
                        "plaques)")
    s.add_argument("--data_parallel", type=int, default=None,
                   help="split each batch over N devices (see --device)")
    s.add_argument("--precision", type=str, default=None,
                   choices=["int8_early", "int8_full"],
                   help="int8 flavor for --fast_path (default int8_early)")
    s.add_argument("--calib_percentile", type=float, default=None, help=PERCENTILE_HELP)
    s.add_argument("--fast_path", type=str, default="False",
                   help="int8 + lazy decode + approx top-k (selected exactly on "
                        "the GPU); non-parity")
    s.add_argument("--background_skip", type=str, default="False", help=BG_SKIP_HELP)
    s.add_argument("--background_max_bpp", type=float, default=None,
                   help="stage-1 candidate threshold, bytes/pixel (default 0.05)")
    s.add_argument("--background_min_tissue", type=float, default=None,
                   help="stage-2 skip threshold, tissue fraction (default 0.02)")
    s.add_argument("--nms_pool", type=int, default=None, help=NMS_POOL_HELP)
    s.set_defaults(fn=cmd_sweep)

    c = sub.add_parser("crop")
    c.add_argument("--wsi_dirs", nargs="+", required=True)
    c.add_argument("--save_dir", type=str, default="data/CERAD/1536_tiles/")
    c.add_argument("--temp_map_pickle", type=str, default="pickles/temporary_WSI_map.pkl")
    c.add_argument("--min_tissue_fraction", type=float, default=0.0,
                   help="crop-time background suppression: tiles below this "
                        "tissue fraction are never written (0 = the original "
                        "behaviour; PIL tiler path only)")
    c.set_defaults(fn=cmd_crop)

    x = sub.add_parser("export")
    x.add_argument("--model_def", type=str, default=None, help=CFG_HELP)
    x.add_argument("--src", type=str, required=True,
                   help=".pth | darknet .weights | the port's Trainer checkpoint "
                        "(path#ema for its EMA)")
    x.add_argument("--dst", type=str, required=True, help=".pth | darknet .weights")
    x.add_argument("--seen", type=int, default=0)
    x.set_defaults(fn=cmd_export)

    cl = sub.add_parser("clear")
    cl.add_argument("--output_dir", type=str, default="output/")
    cl.set_defaults(fn=cmd_clear)

    b = sub.add_parser("bench")
    b.set_defaults(fn=cmd_bench)

    for sp in sub.choices.values():
        sp.add_argument("--device", type=str, default="cuda",
                        help="torch device of the model (default cuda; raises "
                             "without CUDA unless 'cpu' is given)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
