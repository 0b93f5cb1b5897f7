"""Cells of kind ``train``: the port's accumulating training step
(``parallel/steps.py:make_accum_train_step``) on a seeded pool of images
already on the device, with the multiscale schedule of the traffic file.

Set-up builds one object, the step with its model and Adam's state, from
weights made from the seed (the reference scheme, :mod:`.weights`), and
drives it through ``warm_per_size`` micro-batches of every size, in the
cycle's order: the window's own call and feed, every micro-batch on a pool
batch of its own.  The first three of them are the ones the reference
follows: their losses, the first gradient as Adam holds it after one apply
(its first moment over ``1 − β1``), and each leaf's change over the three.
Then the same object runs the window: micro-batches over the schedule
until ``--seconds`` have passed, then a synchronise.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import torch

from ..reference import cfg as ref_cfg
from ..reference.draws import draw_augment_params
from ..reference.model import full_f32
from ..reference.train import Trainer as RefTrainer
from . import compare, trace, traffic, weights
from .cell import steady_heap

RANGES = ("train/augment", "train/loss", "train/optimizer")
FOLLOWED = 3   # micro-steps the reference follows


def _norms(tensors: List[torch.Tensor]) -> List[float]:
    return torch.stack(torch._foreach_norm(tensors)).tolist() if tensors else []


class _Program:
    """The port's step and its state, with the readings the comparison
    takes of its first three micro-steps."""

    def __init__(self, cfg: dict, sd: Dict[str, torch.Tensor], device, variant: Optional[str]):
        from amyloid_yolo_tpu_torch.graphspec import from_cfg
        from amyloid_yolo_tpu_torch.parallel import steps
        st = cfg["step"]
        self.opt = steps.make_optimizer(st["learning_rate"])
        self.state = steps.init_train_state(sd, self.opt, device=device)
        self.astate = steps.init_accum_state(self.state)
        self.step = steps.make_accum_train_step(
            from_cfg(cfg["cfg_path"]), self.opt, st["accum"], augment=st["augment"],
            compute_dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[st["dtype"]])
        self.variant = variant
        self.keys = [k for k in self.state.params if k.endswith((".weight", ".bias"))]

    def __call__(self, images, targets, mask, rng, size):
        if self.variant == "unchanged":
            return {"loss": torch.zeros((), device=images.device)}
        if self.variant == "half_batch":
            half = images.shape[0] // 2
            mask = mask & (targets[:, 0] < half)
            images = images[:half]
        self.astate, metrics = self.step(self.astate, images, targets, mask, rng, size)
        return metrics

    def first_moment_norms(self) -> Dict[str, float]:
        st = self.state.optimizer.state
        b1 = self.state.optimizer.param_groups[0]["betas"][0]
        m = [st[self.state.params[k]]["exp_avg"] if self.state.params[k] in st
             else torch.zeros_like(self.state.params[k]) for k in self.keys]
        return {k: n / (1 - b1) for k, n in zip(self.keys, _norms(m))}


def _changes(now: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor],
             keys) -> Dict[str, float]:
    keys = list(keys)
    with torch.no_grad():
        return dict(zip(keys, _norms([now[k].detach().float() - start[k].float()
                                      for k in keys])))


def _stat_keys(sd) -> List[str]:
    return [k for k in sd if k.endswith((".running_mean", ".running_var"))]


def _reference_steps(layers, cfg, mix, seed, device, pool, targets, valid, sizes,
                     allow_tf32: bool = False) -> dict:
    """The reference's first :data:`FOLLOWED` micro-steps from the seed."""
    st = cfg["step"]
    sd0 = weights.reference_scheme(layers, traffic.generator(seed, "weights", device), device)
    ref = RefTrainer(sd0, layers, st["learning_rate"])
    rng = traffic.generator(seed, "augment", device)
    losses, grad = [], None
    with full_f32(allow_tf32):
        for k in range(FOLLOWED):
            draws = (draw_augment_params(rng, mix["batch"], sizes[k], device)
                     if st["augment"] else None)
            loss, g = ref.micro(pool[k], targets[k], valid[k], draws, sizes[k],
                                apply=k % st["accum"] == 0)
            losses.append(float(loss))
            if k == 0:
                grad = dict(zip(ref.keys, _norms([g[kk] for kk in ref.keys])))
    out = {"losses": losses, "grad": grad,
           "change": _changes(ref.p, sd0, ref.keys),
           "stats": _changes(ref.p, sd0, _stat_keys(sd0))}
    del ref, sd0
    return out


def run(opts, cell: dict, cfg: dict, device: torch.device, t0: float,
        variant: Optional[str] = None) -> dict:
    mix, seed = cell["mix"], opts.seed
    net, layers = ref_cfg.layers(cfg["cfg_path"])
    classes = [l for l in layers if l["type"] == "yolo"][0]["classes"]
    b, n_pool = mix["batch"], mix["pool_batches"]
    pool = traffic.tile_pool(mix, seed, device)
    targets, valid = traffic.boxes(mix, seed, device, classes)
    warm = [s for s in traffic.size_cycle(mix) for _ in range(mix["warm_per_size"])]

    if variant == "control":
        # the reference in the lower precision in the program's place: no window
        prog = _reference_steps(layers, cfg, mix, seed, device, pool, targets, valid, warm,
                                allow_tf32=cfg["control"]["allow_tf32"])
        return _judge(layers, cfg, mix, seed, device, pool, targets, valid, warm, prog,
                      {"attempted": 0, "failed": 0, "setup_s": time.perf_counter() - t0,
                       "peak_bytes": 0, "info": {}, "end_to_end": {}})

    sd = weights.reference_scheme(layers, traffic.generator(seed, "weights", device), device)
    program = _Program(cfg, sd, device, variant)
    rng = traffic.generator(seed, "augment", device)
    losses, grad, change, stats = [], None, None, None
    for k, size in enumerate(warm):
        metrics = program(pool[k % n_pool], targets[k % n_pool], valid[k % n_pool], rng, size)
        if k < FOLLOWED:
            losses.append(metrics["loss"])
        if k == 0:
            grad = program.first_moment_norms()
        if k == FOLLOWED - 1:
            change = _changes(program.state.params, sd, program.keys)
            stats = _changes(program.state.params, sd, _stat_keys(sd))
            del sd
    prog = {"losses": [float(x) for x in losses], "grad": grad, "change": change,
            "stats": stats}
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
        size = sched_sizes[i]
        pb = (len(warm) + i) % n_pool
        ts = time.perf_counter()
        metrics = program(pool[pb], targets[pb], valid[pb], rng, size)
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
    result = {"attempted": len(sizes_run), "failed": finite.count(False), "setup_s": setup_s,
              "peak_bytes": peak,
              "info": {"micro_steps": len(sizes_run), "images": images,
                       "cycles": len(sizes_run) / (mix["per_size"] * len(mix["order"])),
                       "enqueue_ms_mean": sum(enq) / len(enq) * 1e3 if enq else None},
              "end_to_end": {"train_images_per_s": images / window_s, "setup_s": setup_s}}
    print(f"# window {window_s:.3f} s: {len(sizes_run)} micro-batches of {b} "
          f"({result['info']['cycles']:.2f} cycles of the schedule)", flush=True,
          file=sys.stderr)

    if opts.trace:
        k_steps = mix["traced_steps"]
        size = mix["traced_size"]
        applies = []

        def run_steps(n):
            nonlocal i
            for _ in range(n):
                applies.append(program.astate.micro % cfg["step"]["accum"] == 0)
                pb = (len(warm) + i) % n_pool
                program(pool[pb], targets[pb], valid[pb], rng, size)
                i += 1

        def take():
            with trace.warmed_profile() as prof:
                run_steps(1)
                torch.cuda.synchronize(device)
                prof.step()
                applies.clear()
                run_steps(k_steps)
                torch.cuda.synchronize(device)
            return prof

        prof, tries = trace.checked_trace(take, unrecorded=mix["unrecorded_per_call"] * k_steps)
        red = trace.reduce(prof, RANGES)
        del prof
        result["trace"] = red
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
    ref = _reference_steps(layers, cfg, mix, seed, device, pool, targets, valid, warm)
    result["numbers"], diagnostics = compare.train_numbers(prog, ref)
    result["info"].update(diagnostics)
    result["info"].update({"losses_program": prog["losses"], "losses_reference": ref["losses"],
                           "sizes_followed": warm[:FOLLOWED]})
    return result

