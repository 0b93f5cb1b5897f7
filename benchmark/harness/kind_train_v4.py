"""Cells of kind ``train_v4``: YOLOv4 trained through the port's accumulating
step (``parallel/steps.py:make_accum_train_step``) with the graph that
``graphspec.from_cfg`` reads from the frozen ``.cfg``, as :mod:`.kind_train`
runs YOLOv3, against YOLOv4's own plain training reference
(:mod:`..reference.yolov4_train`: Mish, SPP, PAN, darknet's targets, CIoU).

Set-up, window and trace are :mod:`.kind_train`'s, with its ``_Program``:
weights from the seed, ``warm_per_size`` micro-batches at each size of the
cycle, the first :data:`~.kind_train.FOLLOWED` of them followed by the
reference; then micro-batches until ``--seconds`` have passed.  Set-up also
reads, from the reference's targets of the first followed micro-step (one
sync), the positives a box of each head and in all (``info``).  The traced
run takes the ranges of :mod:`.kind_train` and ``train/targets``, and puts
the rise of the program's ``loss.ciou_heads`` over the traced micro-steps
into ``info``.

The comparison is :func:`.compare.train_numbers`' over other losses: the
first micro-step's total and each head's box term in it (the program's
``head<i>/iou``, or its four MSE terms' sum).  At the seeded weights the
no-object term (scale 100 over every cell) is most of the loss, and the box
term and the positives it is taken over move the total by less than the
heads' rounding does; each head's box term alone moves by whole percents
with them.  The later micro-steps' losses are not compared: they follow an
Adam apply, whose steps of ``lr·sign(g)`` turn the rounding of gradients
near 0 into steps of either sign, and on sound seeds their totals part by
up to 1.1% and their box terms by up to 11% (``PERF.md`` §2), more than a
wrong target moves them.  For the same reason the BN running statistics
are compared after the first micro-step (its forward's update), where
:mod:`.kind_train` takes them after the third: after the apply their worst
leaf parted by up to 0.0515 on sound seeds, against 0.068 under TF32.  The
first gradient and the parameters' change over the three micro-steps are
compared as in :mod:`.kind_train`.

Planted faults (the tests' and the readings tool's, never the
benchmark's): ``mse_box`` (YOLOv3's four box terms), ``best_only``
(``iou_thresh`` at the largest float under 1: darknet's best of the nine
alone, which is what its own ``iou_thresh=1`` does), ``v3_targets``
(``iou_thresh`` 1: the best of the head's three anchors, YOLOv3's rule),
each on the program's graph; ``mish_as_silu`` (the program's Mish,
``F.mish``, answered by ``x·σ(x)`` through a ``TorchFunctionMode`` around
its calls); ``half_batch`` and ``unchanged`` (:mod:`.kind_train`'s).  The
control is the reference with TF32 on in the program's place.  Nothing of
:mod:`.kind_train` or of the program is assigned.

A program whose ``YoloSpec`` lacks ``iou_loss``, or reads ``mse`` on the
frozen cfg, would train YOLOv4 with YOLOv3's loss: the run refuses it
before any set-up, with one line and a non-zero exit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from ..reference import yolov4_train as ref
from ..reference.draws import draw_augment_params
from ..reference.model import full_f32
from ..reference.train import augment, resize
from . import compare, trace, traffic, weights
from .cell import steady_heap
from .kind_train import FOLLOWED, _changes, _norms, _Program, _stat_keys

RANGES = ("train/augment", "train/loss", "train/optimizer", "train/targets")
SPEC_FAULTS = {"mse_box": {"iou_loss": "mse"},
               "best_only": {"iou_thresh": math.nextafter(1.0, 0.0)},
               "v3_targets": {"iou_thresh": 1.0}}
FAULTS = tuple(SPEC_FAULTS) + ("mish_as_silu", "half_batch", "unchanged")


def _program_spec(cfg_path: str, variant: Optional[str]):
    """The program's graph of the frozen ``.cfg``, with a planted fault's
    keys; exits at once where the program would take YOLOv3's loss."""
    from amyloid_yolo_tpu_torch.graphspec import YoloSpec, from_cfg
    spec = from_cfg(cfg_path)
    heads = [l for l in spec.layers if isinstance(l, YoloSpec)]
    got = [getattr(h, "iou_loss", None) for h in heads]
    if any(g != "ciou" for g in got):
        raise SystemExit(f"error: the program's YoloSpec reads iou_loss {got} on "
                         f"{cfg_path.rsplit('/', 1)[-1]}, which states ciou on every head: it "
                         f"would train YOLOv4 with YOLOv3's loss")
    change = SPEC_FAULTS.get(variant)
    if change:
        spec = dataclasses.replace(spec, layers=tuple(
            dataclasses.replace(l, **change) if isinstance(l, YoloSpec) else l
            for l in spec.layers))
    return spec


class _SiluForMish(torch.overrides.TorchFunctionMode):
    """``F.mish`` answered by ``F.silu`` while active (``mish_as_silu``);
    ``hits`` counts the calls it answered."""

    def __init__(self):
        super().__init__()
        self.hits = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.nn.functional.mish:
            self.hits += 1
            return torch.nn.functional.silu(*args, **kwargs)
        return func(*args, **kwargs)


def _box_terms(metrics: Dict[str, torch.Tensor], n_heads: int) -> List[torch.Tensor]:
    """Each head's box term from the step's metrics: ``iou``, or the sum of
    ``x``, ``y``, ``w``, ``h``; 0 where the step reported no head."""
    out = []
    for h in range(n_heads):
        m = {k.split("/", 1)[1]: v for k, v in metrics.items() if k.startswith(f"head{h}/")}
        if "iou" in m:
            out.append(m["iou"])
        elif "x" in m:
            out.append(m["x"] + m["y"] + m["w"] + m["h"])
        else:
            out.append(torch.zeros(()))
    return out


def _positives(layers, mix, seed, device, pool, targets, valid, size, on) -> dict:
    """The positives a box of the first followed micro-step, by the
    reference's targets of its augmented boxes (one sync)."""
    t, m = targets[0], valid[0]
    if on:
        draws = draw_augment_params(traffic.generator(seed, "augment", device), mix["batch"],
                                    size, device)
        _, t, m = augment(resize(pool[0], size), t, m, draws)
    t, m = t.cpu(), m.cpu()
    per_head = ref.positives(layers, size, t, m, mix["batch"])
    boxes = max(int(m.sum()), 1)
    return {"positives_a_box": sum(per_head) / boxes,
            "positives_a_box_by_head": [p / boxes for p in per_head],
            "boxes_first_step": int(m.sum())}


def _reference_steps(layers, cfg, mix, seed, device, pool, targets, valid, sizes,
                     allow_tf32: bool = False) -> dict:
    """The reference's first :data:`FOLLOWED` micro-steps from the seed;
    ``losses`` holds the first one's total and its box term of each head,
    ``stats`` the BN statistics' change over the first."""
    st = cfg["step"]
    sd0 = weights.reference_scheme(layers, traffic.generator(seed, "weights", device), device)
    r = ref.Trainer(sd0, layers, st["learning_rate"])
    rng = traffic.generator(seed, "augment", device)
    losses, grad, stats = [], None, None
    with full_f32(allow_tf32):
        for k in range(FOLLOWED):
            draws = (draw_augment_params(rng, mix["batch"], sizes[k], device)
                     if st["augment"] else None)
            loss, g = r.micro(pool[k], targets[k], valid[k], draws, sizes[k],
                              apply=k % st["accum"] == 0)
            if k == 0:
                losses = [float(loss)] + [float(b) for b in r.box_terms]
                grad = dict(zip(r.keys, _norms([g[kk] for kk in r.keys])))
                stats = _changes(r.p, sd0, _stat_keys(sd0))
    out = {"losses": losses, "grad": grad, "change": _changes(r.p, sd0, r.keys),
           "stats": stats}
    del r, sd0
    return out


def run(opts, cell: dict, cfg: dict, device: torch.device, t0: float,
        variant: Optional[str] = None) -> dict:
    if variant not in (None, "control") + FAULTS:
        raise ValueError(f"no variant {variant!r} in the train_v4 kind (faults {FAULTS})")
    spec = _program_spec(cfg["cfg_path"], variant)
    mix, seed = cell["mix"], opts.seed
    _, layers = ref.layers(cfg["cfg_path"])
    n_heads = sum(l["type"] == "yolo" for l in layers)
    classes = [l for l in layers if l["type"] == "yolo"][0]["classes"]
    b, n_pool = mix["batch"], mix["pool_batches"]
    pool = traffic.tile_pool(mix, seed, device)
    targets, valid = traffic.boxes(mix, seed, device, classes)
    warm = [s for s in traffic.size_cycle(mix) for _ in range(mix["warm_per_size"])]
    info = _positives(layers, mix, seed, device, pool, targets, valid, warm[0],
                      cfg["step"]["augment"])

    if variant == "control":
        # the reference in the lower precision in the program's place: no window
        prog = _reference_steps(layers, cfg, mix, seed, device, pool, targets, valid, warm,
                                allow_tf32=cfg["control"]["allow_tf32"])
        return _judge(layers, cfg, mix, seed, device, pool, targets, valid, warm, prog,
                      {"attempted": 0, "failed": 0, "setup_s": time.perf_counter() - t0,
                       "peak_bytes": 0, "info": info, "end_to_end": {}})

    from amyloid_yolo_tpu_torch.ops import loss as loss_mod
    from amyloid_yolo_tpu_torch.parallel import steps
    sd = weights.reference_scheme(layers, traffic.generator(seed, "weights", device), device)
    program = _Program(cfg, sd, device, variant)
    st = cfg["step"]
    if variant in SPEC_FAULTS:
        program.step = steps.make_accum_train_step(
            spec, program.opt, st["accum"], augment=st["augment"],
            compute_dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[st["dtype"]])
    silu = _SiluForMish() if variant == "mish_as_silu" else None

    def call(pb, size):
        with silu if silu is not None else contextlib.nullcontext():
            return program(pool[pb], targets[pb], valid[pb], rng, size)

    rng = traffic.generator(seed, "augment", device)
    losses, grad, change, stats = [], None, None, None
    for k, size in enumerate(warm):
        metrics = call(k % n_pool, size)
        if k == 0:
            losses = [metrics["loss"]] + _box_terms(metrics, n_heads)
            grad = program.first_moment_norms()
            stats = _changes(program.state.params, sd, _stat_keys(sd))
        if k == FOLLOWED - 1:
            change = _changes(program.state.params, sd, program.keys)
            del sd
    prog = {"losses": [float(x) for x in losses], "grad": grad, "change": change,
            "stats": stats}
    if silu is not None:
        info["mish_calls_answered"] = silu.hits
        if not silu.hits:
            raise RuntimeError("mish_as_silu answered no F.mish call: the fault did not land")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    steady_heap()
    setup_s = time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sched_sizes = traffic.schedule(mix, 1 << 16)
    enq, window_losses, sizes_run = [], [], []
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < opts.seconds:
        size = sched_sizes[i % len(sched_sizes)]
        ts = time.perf_counter()
        metrics = call((len(warm) + i) % n_pool, size)
        enq.append(time.perf_counter() - ts)
        window_losses.append(metrics["loss"])
        sizes_run.append(size)
        i += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finite = torch.isfinite(torch.stack(window_losses)).tolist() if window_losses else []
    images = b * len(sizes_run)
    info.update({"micro_steps": len(sizes_run), "images": images,
                 "enqueue_ms_mean": sum(enq) / len(enq) * 1e3 if enq else None})
    result = {"attempted": len(sizes_run), "failed": finite.count(False), "setup_s": setup_s,
              "peak_bytes": peak, "info": info,
              "end_to_end": {"train_images_per_s": images / window_s, "setup_s": setup_s}}
    print(f"# window {window_s:.3f} s: {len(sizes_run)} micro-batches of {b}", flush=True,
          file=sys.stderr)

    if opts.trace:
        k_steps = mix["traced_steps"]
        size = mix["traced_size"]
        applies, ciou = [], []

        def run_steps(n):
            nonlocal i
            for _ in range(n):
                applies.append(program.astate.micro % st["accum"] == 0)
                call((len(warm) + i) % n_pool, size)
                i += 1

        def take():
            with trace.warmed_profile() as prof:
                run_steps(1)
                torch.cuda.synchronize(device)
                prof.step()
                applies.clear()
                before = loss_mod.ciou_heads
                run_steps(k_steps)
                torch.cuda.synchronize(device)
                ciou.append(loss_mod.ciou_heads - before)
            return prof

        prof, tries = trace.checked_trace(take, unrecorded=mix["unrecorded_per_call"] * k_steps)
        red = trace.reduce(prof, RANGES)
        del prof
        result["trace"] = red
        info["ciou_heads_traced"] = ciou[-1]
        result["ctx"] = {"kind": "train", "trace": red, "steps_traced": k_steps,
                         "applies_traced": list(applies), "layers": layers, "batch": b,
                         "window": {"seconds": window_s, "calls": len(sizes_run),
                                    "items": images, "sizes": sizes_run, "enqueue_s": enq,
                                    "peak_bytes": peak}}
        print(f"# trace tries [records, calls]: {tries}; traced at {size}², applies "
              f"{applies}; {red['kinds']}", file=sys.stderr, flush=True)

    del program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return _judge(layers, cfg, mix, seed, device, pool, targets, valid, warm, prog, result)


def _judge(layers, cfg, mix, seed, device, pool, targets, valid, warm, prog, result):
    refs = _reference_steps(layers, cfg, mix, seed, device, pool, targets, valid, warm)
    result["numbers"], diagnostics = compare.train_numbers(prog, refs)
    result["info"].update(diagnostics)
    result["info"].update({"losses_program": prog["losses"], "losses_reference": refs["losses"],
                           "sizes_followed": warm[:FOLLOWED]})
    return result
