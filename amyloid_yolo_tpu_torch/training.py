"""The training loop (reference package ``training.py:113-512``, after the
reference's ``train.py`` loop).

Behaviour kept (the reference's ``train.py:27-210``):

* Adam at torch's defaults, gradient accumulation every N batches on
  summed gradients, the multiscale size every 10 batches, evaluation each
  epoch at iou/conf/nms 0.5, a checkpoint each epoch, and the best mAP
  tracked overall and per class (Cored, CAA), ``train.py:187-197``;
* ``seen``, the image count the darknet export records;
* beyond the reference, as the reference package: an optional EMA scored
  beside the raw weights each epoch (``validation/mAP_ema``), checkpoint
  retention (``keep_checkpoints``) and checkpoints that carry the
  optimizer state.

A checkpoint is a torch file ``yolov3_ckpt_<epoch>.pt`` holding
``params`` (the state dict in the reference ``.pth`` layout),
``optimizer`` (Adam's ``state_dict``), ``step``, ``seen`` and, when EMA is
on, ``ema``; :func:`~amyloid_yolo_tpu_torch.io.weights.load_pretrained`
reads its weights.  The reference package's checkpoints are orbax
directories, which the port does not read.

In one process (a process group of one included) the save overlaps the
next epoch, as the reference's single host (``training.py:372-459``):
:meth:`Trainer.save_checkpoint` copies the state on its device and returns,
a worker thread moves the copy to the host and writes it, and
:meth:`Trainer.join_pending_save` waits for the write and raises its
failure.  Each save joins the one before, and ``train`` joins the last
before it returns.  ``epoch_walls``' ``save_s`` is the
dispatch, and ``save_walls`` splits each save into its parts.
Across processes, the save stays synchronous.

Several devices (the reference's ``training.py:113-205``):

* ``data_parallel=N``: one process over a mesh of N devices
  (``parallel.steps.shard_train_step``), numerically the one-device step
  on the global batch; with ``device="cpu"`` the mesh is N CPU entries,
  and ``device`` may list the mesh's devices (``"cuda:0,cuda:0"`` or a
  list: two shards on one card);
* ``distributed=True``: one process a device (``parallel.distributed``).
  ``batch_size`` is the global batch; every rank derives the same shuffle
  and collates its own rows of each batch (``ListDataset.iter_epoch
  (shard=...)``).  Only rank 0 prints, logs, evaluates and saves; the
  other ranks wait for it at a barrier after each epoch's evaluation and
  save, so their next collective does not time out meanwhile.

* ``spatial_shard=N``: the activations height-sharded over N devices
  (``parallel.spatial.shard_spatial_train_step``), on a (dp, sp) mesh of
  ``data_parallel or 1`` rows of N devices; ``device`` as for
  ``data_parallel``.  It does not compose with ``distributed``
  (``ValueError``, as the reference's ``training.py:188-191``).

``s2d_stem`` (``None``: on where the spec has the YOLOv3 stem with BN, as
the reference's ``training.py:165-173`` decides, so off for YOLOv4's Mish
stem; ``True`` on a graph without that stem raises; ``Trainer.s2d_stem`` is
the resolved value) and ``image_layout`` (``"planar"`` by default) are the
reference's layout options of the step (``parallel.steps``): the same
function up to summation order.  They hold under ``spatial_shard > 1`` too,
where the shards run the s2d stem on their rows
(``parallel.spatial._s2d_stem``), as the reference's GSPMD partitions it.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Set

import torch

from .evaluate import evaluate
from .graphspec import GraphSpec, yolov3_spec
from .io import weights as weights_io
from .io.datasets import ListDataset
from .models import darknet
from .parallel import steps as steps_mod
from .parallel.mesh import make_mesh
from .parallel.spatial import make_spatial_mesh, shard_spatial_train_step
from .parsecfg import load_classes, parse_data_config
from .utils.device import DeviceLike, resolve_device
from .utils.logging import MetricsLogger

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainConfig:
    """The reference package's ``TrainConfig``: same fields, same defaults."""
    data_config: str = "config/custom.data"
    epochs: int = 100
    batch_size: int = 8
    gradient_accumulations: int = 2
    img_size: int = 416
    multiscale: bool = True
    augment: bool = True
    pretrained_weights: Optional[str] = None
    checkpoint_dir: str = "checkpoints"
    checkpoint_interval: int = 1
    evaluation_interval: int = 1
    learning_rate: float = 1e-3
    grad_clip_norm: Optional[float] = None  # None = reference behaviour
    burn_in: int = 0                        # darknet LR warm-up applies; 0 = reference
    compute_dtype: str = "float32"          # "bfloat16": convs in bf16, the rest f32
    num_classes: int = 2
    logdir: str = "logs"
    seed: int = 0
    data_parallel: Optional[int] = None     # devices of the in-process mesh (None = 1)
    spatial_shard: Optional[int] = None     # devices the image height splits over (None = 1)
    distributed: bool = False               # one process a device; batch_size is global
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    verbose: bool = False
    max_batches_per_epoch: Optional[int] = None  # for smoke runs
    eval_nms_capacity: int = 128            # NMS pool of the in-training eval
    cache_images: bool = False              # keep decoded images in RAM across epochs
    host_resize: bool = False               # nearest resize on the host, bit-identical
    s2d_stem: Optional[bool] = None         # space-to-depth stem; None = where the spec has it
    keep_checkpoints: Optional[int] = None  # keep the last N epochs and every best
    ema_decay: Optional[float] = None       # EMA of all parameters, on applies
    image_layout: str = "planar"            # "planar" (B, 3, H, W) or "nhwc" in-step images


class Trainer:
    """``Trainer(cfg, spec=None, device=None)``: ``spec`` defaults to
    ``yolov3_spec(num_classes=cfg.num_classes)``, ``device`` to ``cuda``
    (it raises without a card unless ``device="cpu"`` is passed; under
    ``distributed`` a bare ``cuda`` is the rank's card).  Initial weights
    come from :func:`~..models.darknet.init_params` with a generator
    seeded by ``cfg.seed`` (then ``pretrained_weights``); the augmentation
    draws from a generator on the device seeded by ``cfg.seed + 1``."""

    def __init__(self, cfg: TrainConfig, spec: Optional[GraphSpec] = None,
                 device: DeviceLike = None):
        n_sp, n_dp = cfg.spatial_shard or 1, cfg.data_parallel or 1
        if n_sp > 1 and cfg.distributed:
            raise ValueError("spatial_shard does not compose with distributed "
                             "(one process a device)")
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of {list(COMPUTE_DTYPES)}")
        self.cfg = cfg
        self._dist = None
        self.pid, self.nproc = 0, 1
        if cfg.distributed:
            from .parallel import distributed as dist_mod
            # a bare cuda is the rank's card; without a card only "cpu" (gloo) runs
            dev = None if device is None or str(device) == "cuda" else device
            dist_mod.initialize(cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                                device=dev)  # returns when a launcher initialized it
            self._dist = dist_mod
            self.pid = dist_mod.dist.get_rank()
            self.nproc = dist_mod.dist.get_world_size()
            if cfg.num_processes is not None and self.nproc != cfg.num_processes:
                raise RuntimeError(
                    f"the process group has {self.nproc} processes but num_processes="
                    f"{cfg.num_processes} was requested: refusing to train on a partial world")
            device = dev if dev is not None else dist_mod.local_device()
        self.is_main = self.pid == 0
        mesh = None
        if self.nproc > 1:
            if n_dp > 1:
                raise ValueError("distributed training drives one device a process; "
                                 "data_parallel > 1 does not compose with it")
        elif n_dp > 1 or n_sp > 1:
            listed = (device.split(",") if isinstance(device, str) and "," in device
                      else list(device) if isinstance(device, (list, tuple)) else None)
            dev = resolve_device(listed[0] if listed else device)
            if listed is None and dev.type == "cpu":  # N CPU entries stand for N devices
                listed = [dev] * (n_dp * n_sp)
            mesh = (make_spatial_mesh(n_sp, n_dp, devices=listed) if n_sp > 1
                    else make_mesh(n_dp, devices=listed))
            if dev.index is not None and dev != mesh.devices[0]:
                raise ValueError(f"device {dev} is not the mesh's first device "
                                 f"{mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        # the loss and targets follow each head's spec: YOLOv3's MSE terms, or
        # YOLOv4's CIoU term and darknet's targets (``ops/loss.py``)
        self.spec = spec or yolov3_spec(num_classes=cfg.num_classes)
        data = parse_data_config(cfg.data_config)
        self.train_path = data["train"]
        self.valid_path = data["valid"]
        self.class_names = (load_classes(data["names"]) if os.path.exists(data["names"])
                            else [f"class{i}" for i in range(cfg.num_classes)])

        params = darknet.init_params(torch.Generator().manual_seed(cfg.seed), self.spec)
        if cfg.pretrained_weights:
            params = {**params, **weights_io.load_pretrained(self.spec, cfg.pretrained_weights,
                                                             params)}
        self.optimizer = steps_mod.make_optimizer(cfg.learning_rate, cfg.grad_clip_norm,
                                                  burn_in=cfg.burn_in)
        self.state = steps_mod.init_train_state(params, self.optimizer,
                                                ema=cfg.ema_decay is not None,
                                                device=self.device)
        self.accum = max(1, int(cfg.gradient_accumulations or 1))
        self.compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        s2d = cfg.s2d_stem
        if s2d is None:  # auto, as the reference; never a Mish stem (YOLOv4's)
            s2d = darknet.s2d_train_stem_qualifies(self.spec)
        elif s2d:  # asked for: refuse a graph without the YOLOv3 stem now
            darknet._check_s2d_spec(self.spec)
        self.s2d_stem = bool(s2d)
        kw = dict(augment=cfg.augment, compute_dtype=self.compute_dtype,
                  s2d_stem=self.s2d_stem, image_layout=cfg.image_layout,
                  ema_decay=cfg.ema_decay)
        self.step_fn = (
            steps_mod.make_accum_train_step(self.spec, self.optimizer, self.accum, **kw)
            if self.accum > 1 else steps_mod.make_train_step(self.spec, self.optimizer, **kw))
        if self.nproc > 1:
            self.step_fn = self._dist.shard_train_step_multiprocess(
                self.step_fn, self._dist.global_mesh())
        elif n_sp > 1:
            self.step_fn = shard_spatial_train_step(self.step_fn, mesh)
        elif mesh is not None:
            self.step_fn = steps_mod.shard_train_step(self.step_fn, mesh)
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.logger = MetricsLogger(cfg.logdir) if self.is_main else None
        self.best = {"map": (-1.0, -1), "Cored": (-1.0, -1), "CAA": (-1.0, -1)}
        if cfg.ema_decay is not None:
            self.best["map_ema"] = (-1.0, -1)
        #: wall seconds of each epoch's train loop, evaluation and save
        self.epoch_walls: list = []
        #: wall seconds of each save's parts: the join of the save before,
        #: the device copy, the worker's start; then, from the worker, its
        #: copy to the host and the write (across processes: the write alone)
        self.save_walls: list = []
        self._saved_epochs: list = []
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[Exception] = None
        self._eval_dataset: Optional[ListDataset] = None

    def train(self, callback: Optional[Callable[[int, int, Dict], None]] = None
              ) -> steps_mod.TrainState:
        """Run ``cfg.epochs`` epochs; ``callback(epoch, batch_index,
        metrics)``, when given, runs after every micro-batch's step was
        enqueued."""
        cfg = self.cfg
        if self.is_main:
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        dataset = ListDataset(self.train_path, img_size=cfg.img_size, multiscale=cfg.multiscale,
                              augment=cfg.augment, seed=cfg.seed,
                              cache_images=cfg.cache_images, host_resize=cfg.host_resize)
        shard = (self.pid, self.nproc) if self.nproc > 1 else None
        if shard is not None and not cfg.host_resize:
            # every rank's fallback side for a batch it could not read at
            # all, so all ranks collate one shape
            dataset.probe_native_side()
        # the accumulation counter lives for this run, as the reference's
        # batches_done (the reference never checkpoints .grad either)
        run_state = (steps_mod.init_accum_state(self.state) if self.accum > 1
                     else self.state)
        for epoch in range(cfg.epochs):
            t0 = time.time()
            n_batches = 0
            for bi, batch in enumerate(dataset.iter_epoch(cfg.batch_size, shard=shard)):
                if cfg.max_batches_per_epoch and bi >= cfg.max_batches_per_epoch:
                    break
                run_state, metrics = self.step_fn(
                    run_state, batch["images"], batch["targets"], batch["target_mask"],
                    self.rng, int(batch["img_size"]))
                self.state = run_state.inner if self.accum > 1 else run_state
                n_batches += 1
                if callback is not None:
                    callback(epoch, bi, metrics)
                if bi % 10 == 0 and self.is_main:  # fetching the metrics waits for the step
                    host = {k: float(self._fetch(v)) for k, v in metrics.items()}
                    host["epoch"] = epoch
                    host["batch"] = bi
                    self.logger.log(host, step=self.state.step)
                    if cfg.verbose:
                        print(f"[epoch {epoch} batch {bi}] loss={host['loss']:.4f}")
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            epoch_time = time.time() - t0
            t_eval0 = time.time()
            if cfg.evaluation_interval and epoch % cfg.evaluation_interval == 0 \
                    and self.is_main:
                self._evaluate_epoch(epoch, epoch_time)
            t_save0 = time.time()
            if epoch % cfg.checkpoint_interval == 0 and self.is_main:
                self.save_checkpoint(epoch)
            if self._dist is not None:
                self._dist.barrier()  # the other ranks wait out rank 0's eval and save
            self.epoch_walls.append({"epoch": epoch, "batches": n_batches,
                                     "train_s": epoch_time, "eval_s": t_save0 - t_eval0,
                                     "save_s": time.time() - t_save0})
            if cfg.verbose and self.is_main:
                # the write itself overlaps the next epoch in one process
                print(f"[epoch {epoch} wall] train {epoch_time:.1f}s "
                      f"eval {t_save0 - t_eval0:.1f}s "
                      f"save-dispatch {time.time() - t_save0:.1f}s")
        if cfg.epochs and (cfg.epochs - 1) % cfg.checkpoint_interval != 0 and self.is_main:
            # the reference's modulo rule (train.py:205) never saves the last
            # epoch unless it lands on the interval; always keep it
            self.save_checkpoint(cfg.epochs - 1)
        self.join_pending_save()
        if self._dist is not None:
            self._dist.barrier()
        if self.is_main:
            print("Best mAP: {} @ epoch: {}".format(*self.best["map"]))
            print("Best Cored mAP: {} @ epoch: {}".format(*self.best["Cored"]))
            print("Best CAA mAP: {} @ epoch: {}".format(*self.best["CAA"]))
            if "map_ema" in self.best:
                print("Best EMA mAP: {} @ epoch: {}".format(*self.best["map_ema"]))
        return self.state

    def _fetch(self, x):
        """Host value of a replicated value (every rank holds the same)."""
        return self._dist.fetch_replicated(x) if self._dist is not None else x

    def evaluate(self, params=None):
        """The in-training evaluation (iou/conf/nms 0.5 at ``img_size``) of
        ``params`` (default: the current parameters)."""
        cfg = self.cfg
        if self._eval_dataset is None:  # one dataset, one decode cache, every epoch
            self._eval_dataset = ListDataset(
                self.valid_path, img_size=cfg.img_size, multiscale=False, augment=False,
                cache_images=cfg.cache_images, host_resize=cfg.host_resize)
        return evaluate(self.spec, self.state.params if params is None else params,
                        self.valid_path, iou_thres=0.5, conf_thres=0.5, nms_thres=0.5,
                        img_size=cfg.img_size, batch_size=8,
                        nms_capacity=cfg.eval_nms_capacity, dataset=self._eval_dataset,
                        device=self.device)

    def _evaluate_epoch(self, epoch: int, epoch_time: float) -> None:
        out = self.evaluate()
        if out is not None:
            precision, recall, ap, f1, ap_class = out
            self.logger.log({"validation/precision": float(precision.mean()),
                             "validation/recall": float(recall.mean()),
                             "validation/mAP": float(ap.mean()),
                             "validation/f1": float(f1.mean())}, step=epoch)
            for i, c in enumerate(ap_class):
                name = self.class_names[int(c)] if int(c) < len(self.class_names) else str(c)
                if name in self.best and ap[i] > self.best[name][0]:
                    self.best[name] = (float(ap[i]), epoch)
            if ap.mean() > self.best["map"][0]:
                self.best["map"] = (float(ap.mean()), epoch)
            print(f"---- epoch {epoch}: mAP {float(ap.mean()):.5f} ({epoch_time:.1f}s)")
        else:
            print("---- mAP not measured (no detections found by model)")
        if self.cfg.ema_decay is not None and self.state.ema is not None:
            out_ema = self.evaluate(self.state.ema)
            if out_ema is not None:
                m = float(out_ema[2].mean())
                self.logger.log({"validation/mAP_ema": m}, step=epoch)
                print(f"---- epoch {epoch}: mAP_ema {m:.5f}")
                if m > self.best["map_ema"][0]:
                    self.best["map_ema"] = (m, epoch)
            else:
                print("---- mAP_ema not measured (no detections)")

    def checkpoint_path(self, epoch: int) -> str:
        return os.path.join(self.cfg.checkpoint_dir, f"yolov3_ckpt_{epoch}.pt")

    def save_checkpoint(self, epoch: int) -> str:
        """Save the epoch's checkpoint and apply the retention rule; returns
        its path.  In one process, a group of one included, it returns
        before the write lands: the pending save is joined, then parameters,
        Adam's state and the EMA are copied on their device, and a worker
        thread moves the copy to the host and writes it
        (:meth:`join_pending_save` waits for it).  The copy holds a second
        state on the device until it reaches the host.  Across processes,
        it writes synchronously (reference ``training.py:379``,
        ``:421-433``)."""
        path = self.checkpoint_path(epoch)
        best = self._best_epochs()  # as of the dispatch: the next epoch may change it
        walls = {"epoch": epoch}
        self.save_walls.append(walls)
        t0 = time.perf_counter()
        if self.nproc > 1:
            self._write_checkpoint(path, _state_tree(self.state), epoch, best)
            walls["write_s"] = time.perf_counter() - t0
            return path
        self.join_pending_save()
        t1 = time.perf_counter()
        with torch.no_grad():
            # copies, not x + 0, so that -0.0 survives; the optimizer's
            # state_dict holds its live tensors
            snap = _map_tensors(_state_tree(self.state), lambda t: t.detach().clone())
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        t2 = time.perf_counter()
        self._save_thread = threading.Thread(
            target=self._write_snapshot, args=(path, snap, epoch, best, ready, walls),
            name=f"ckpt-save-{epoch}", daemon=False)
        self._save_thread.start()
        walls.update(join_s=t1 - t0, snapshot_s=t2 - t1, start_s=time.perf_counter() - t2)
        return path

    def _write_snapshot(self, path: str, snap: Dict[str, Any], epoch: int, best: Set[int],
                        ready: Optional["torch.cuda.Event"], walls: Dict[str, Any]) -> None:
        """The worker: the device copy to pinned host memory on a side
        stream, ordered after the copy's ``ready`` event and beside the
        training stream, then the write; a failure waits for the join."""
        try:
            t0 = time.perf_counter()
            tree = snap
            if ready is not None:
                with torch.cuda.device(self.device):
                    stream = torch.cuda.Stream()
                    with torch.cuda.stream(stream):
                        stream.wait_event(ready)
                        tree = _map_tensors(snap, _to_pinned_host)
                    stream.synchronize()
                snap.clear()  # the device copy is free from here
            t1 = time.perf_counter()
            self._write_checkpoint(path, tree, epoch, best)
            walls.update(host_copy_s=t1 - t0, write_s=time.perf_counter() - t1)
        except Exception as e:  # re-raised by join_pending_save
            self._save_error = e

    def join_pending_save(self) -> None:
        """Wait for the checkpoint write in flight, if any; a write that
        failed raises ``RuntimeError`` here, from its cause."""
        thread, self._save_thread = self._save_thread, None
        if thread is not None:
            thread.join()
        err, self._save_error = self._save_error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def _write_checkpoint(self, path: str, tree: Dict[str, Any], epoch: int,
                          best: Set[int]) -> None:
        out = dict(tree, params=weights_io.params_to_torch_state_dict(self.spec, tree["params"]))
        if tree.get("ema") is not None:
            out["ema"] = weights_io.params_to_torch_state_dict(self.spec, tree["ema"])
        tmp = path + ".tmp"
        torch.save(out, tmp)
        os.replace(tmp, path)  # a reader never sees half a file
        if epoch not in self._saved_epochs:
            self._saved_epochs.append(epoch)
        self._prune_checkpoints(best)

    def _best_epochs(self) -> Set[int]:
        return {ep for _, ep in self.best.values() if ep >= 0}

    def _prune_checkpoints(self, best: Set[int]) -> None:
        """``keep_checkpoints``: drop saved epochs beyond the most recent N,
        never one of the ``best`` epochs."""
        n = self.cfg.keep_checkpoints
        if not n:
            return
        keep = set(self._saved_epochs[-n:]) | best
        for ep in list(self._saved_epochs):
            if ep not in keep:
                path = self.checkpoint_path(ep)
                if os.path.exists(path):
                    os.remove(path)
                self._saved_epochs.remove(ep)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint: parameters, Adam's state, ``step`` and
        ``seen``; the EMA from the checkpoint when this run tracks one (a
        copy of the parameters when the checkpoint has none).  A save in
        flight is joined first."""
        self.join_pending_save()
        tree = torch.load(path, map_location="cpu", weights_only=True)
        st = self.state
        with torch.no_grad():
            for k, v in tree["params"].items():
                if k in st.params:
                    st.params[k].copy_(v)
        try:
            st.optimizer.load_state_dict(tree["optimizer"])
        except ValueError as e:
            # another optimizer layout wrote it: resume the parameters with a
            # fresh optimizer, the reference's resume (it never saves one)
            print(f"[resume] optimizer state mismatch ({e}): params restored, "
                  f"optimizer state reset")
            st.optimizer = self.optimizer.init(
                [st.params[k] for k in steps_mod.trainable_keys(st.params)])
        st.step, st.seen = int(tree["step"]), int(tree["seen"])
        if self.cfg.ema_decay is not None:
            src = tree.get("ema") or tree["params"]
            st.ema = {k: src[k].to(self.device, torch.float32, copy=True)
                      for k in st.ema}
        else:
            st.ema = None


def _state_tree(st: steps_mod.TrainState) -> Dict[str, Any]:
    """What a checkpoint holds, as live references to the state."""
    tree = {"params": st.params, "optimizer": st.optimizer.state_dict(), "step": st.step,
            "seen": st.seen}
    if st.ema is not None:
        tree["ema"] = st.ema
    return tree


def _map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor in its dicts, lists and
    tuples (an optimizer's ``state_dict`` among them)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _to_pinned_host(t: torch.Tensor) -> torch.Tensor:
    if not t.is_cuda:
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


__all__ = ["Trainer", "TrainConfig"]
