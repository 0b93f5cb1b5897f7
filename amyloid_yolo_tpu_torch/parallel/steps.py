"""Train and eval steps on one device (reference package ``parallel/steps.py``).

One micro-step is::

    uint8 batch → nearest resize and /255 → augment → forward (train BN) →
    YOLO loss → backward → [Adam apply] → BN running stats → [EMA]

Semantics kept from the reference (``parallel/steps.py:82-331``, after the
reference trainer ``train.py:81``, ``:104-156``):

* Adam with torch's defaults: lr 1e-3, betas (0.9, 0.999), eps 1e-8
  (``torch.optim.Adam``);
* optional burn-in, ``lr·min((count + 1)/burn_in, 1)^4`` where ``count`` is
  the number of applies before this one (optax's count);
* optional global-norm clipping as optax does it, ``(g/‖g‖)·max`` when
  ``‖g‖ ≥ max`` (``clip_grad_norm_`` adds 1e-6 to the norm, so it is not
  used);
* gradient accumulation: gradients sum in ``.grad`` across micro-batches
  and the optimizer applies when ``micro % N == 0`` — batch 0 alone, then
  every N — and clears them; BN running statistics and ``seen`` update on
  every micro-batch;
* an EMA of the full parameter set (weights and BN statistics), updated
  only on applies, with TensorFlow's ramp ``min(decay, (1 + t)/(10 + t))``
  on ``t = state.step``.

The state is updated in place (PyTorch's idiom): parameters are leaf
tensors of a state dict in the reference layout, the trainable ones with
``requires_grad``.  In float32 on the card the convolutions run in full
float32 (TF32 off); bfloat16 runs the convolutions in bfloat16 and keeps
BN statistics, the loss and Adam in float32.

Data parallelism, spatial sharding and multi-host training (the reference's
``shard_train_step``, ``parallel/spatial.py``, ``parallel/distributed.py``)
are not ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..graphspec import GraphSpec
from ..io.weights import StateDict
from ..models import darknet, heads
from ..ops.augment import augment_batch, draw_augment_params
from ..ops.loss import yolo_loss
from ..ops.preprocess import preprocess_tiles
from ..utils.device import DeviceLike, no_tf32, resolve_device

record_function = torch.profiler.record_function

TRAINABLE_SUFFIXES = (".weight", ".bias")
STAT_SUFFIXES = (".running_mean", ".running_var")


def trainable_keys(params: StateDict) -> List[str]:
    """Conv weights and biases and BN scales and shifts, in state-dict order."""
    return [k for k in params if k.endswith(TRAINABLE_SUFFIXES)]


def _float_keys(params: StateDict) -> List[str]:
    return [k for k in params if k.endswith(TRAINABLE_SUFFIXES + STAT_SUFFIXES)]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam with torch's defaults, optional clipping and burn-in
    (:func:`make_optimizer`)."""
    learning_rate: float = 1e-3
    grad_clip_norm: Optional[float] = None
    burn_in: int = 0
    burn_in_power: float = 4.0

    def init(self, params: Iterable[torch.Tensor]) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def lr_at(self, count: int) -> float:
        """Learning rate of the apply that follows ``count`` applies."""
        if not self.burn_in or self.burn_in <= 0:
            return self.learning_rate
        frac = np.minimum((np.float32(count) + np.float32(1.0)) / np.float32(self.burn_in),
                          np.float32(1.0))
        return float(np.float32(self.learning_rate) * frac ** np.float32(self.burn_in_power))

    def apply(self, opt: torch.optim.Adam) -> None:
        """Clip, set the learning rate, take one Adam step and clear the
        gradients.  Nothing waits for the device."""
        params = [p for g in opt.param_groups for p in g["params"] if p.grad is not None]
        if self.grad_clip_norm is not None and params:
            grads = [p.grad for p in params]
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.grad_clip_norm
            # (g / ‖g‖) · max where ‖g‖ ≥ max; g / 1 · 1 = g exactly otherwise
            torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0, norm.new_full(
                (), self.grad_clip_norm)))
        lr = self.lr_at(applies_done(opt))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)


def make_optimizer(learning_rate: float = 1e-3, grad_clip_norm: Optional[float] = None,
                   burn_in: int = 0, burn_in_power: float = 4.0) -> Optimizer:
    """Reference ``make_optimizer`` (``parallel/steps.py:82-113``): plain
    Adam by default; ``grad_clip_norm`` adds global-norm clipping;
    ``burn_in > 0`` darknet's LR burn-in, counted in optimizer applies."""
    return Optimizer(learning_rate, grad_clip_norm, burn_in, burn_in_power)


def applies_done(opt: torch.optim.Adam) -> int:
    """Adam steps taken so far (its per-parameter ``step`` count, a host
    tensor, so reading it does not wait for the device)."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                return int(st["step"])
    return 0


@dataclasses.dataclass
class TrainState:
    params: StateDict           # reference-layout state dict on the device
    optimizer: torch.optim.Adam
    step: int = 0               # micro-batches taken
    seen: int = 0               # images seen (the reference's Darknet.seen)
    ema: Optional[StateDict] = None


def init_train_state(params: StateDict, optimizer: Optimizer, ema: bool = False,
                     device: DeviceLike = None) -> TrainState:
    """Copy ``params`` onto ``device`` (default ``cuda``; it raises without
    a card unless ``device="cpu"``) as leaf tensors, the trainable ones
    requiring gradients, and build Adam over them; ``ema`` starts the
    average from a copy of the parameters.  The steps run where the state
    is."""
    dev = resolve_device(device)
    p = {k: v.detach().to(dev, copy=True) for k, v in params.items()}
    keys = trainable_keys(p)
    for k in keys:
        p[k] = p[k].to(torch.float32).requires_grad_(True)
    return TrainState(params=p, optimizer=optimizer.init([p[k] for k in keys]),
                      ema={k: p[k].detach().clone() for k in _float_keys(p)} if ema else None)


@dataclasses.dataclass
class AccumState:
    """Train state plus the micro-batch counter (the reference's
    ``batches_done``); the summed gradients live in the parameters' ``.grad``."""
    inner: TrainState
    micro: int = 0


def init_accum_state(state: TrainState) -> AccumState:
    state.optimizer.zero_grad(set_to_none=True)
    return AccumState(inner=state)


@torch.no_grad()
def _ema_update(ema: StateDict, params: StateDict, decay: float, step: int) -> None:
    """``e ← e + (1 − d)·(p − e)`` over every float parameter, with
    ``d = min(decay, (1 + t)/(10 + t))`` in float32 (reference
    ``_ema_update``, ``parallel/steps.py:131-143``)."""
    t = np.float32(step)
    d = np.minimum(np.float32(decay), (np.float32(1) + t) / (np.float32(10) + t))
    keys = list(ema)
    diff = torch._foreach_sub([params[k] for k in keys], [ema[k] for k in keys])
    torch._foreach_mul_(diff, float(np.float32(1) - d))
    torch._foreach_add_([ema[k] for k in keys], diff)


def _precision(compute_dtype: torch.dtype, device: torch.device):
    """Full float32 convolutions on the card for float32 training."""
    if compute_dtype == torch.float32 and device.type == "cuda":
        return no_tf32()
    return contextlib.nullcontext()


def _device(params: StateDict) -> torch.device:
    return next(iter(params.values())).device


def prepare_batch(images_u8, targets, target_mask, img_size: int, device: torch.device,
                  augment: bool = False, rng: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host or device uint8 NHWC batch and padded targets → the float32
    model input at ``img_size`` (nearest resize, /255), augmented with draws
    from ``rng`` when ``augment``."""
    images_u8 = torch.as_tensor(images_u8).to(device)
    targets = torch.as_tensor(targets).to(device, torch.float32)
    target_mask = torch.as_tensor(target_mask).to(device, torch.bool)
    images = preprocess_tiles(images_u8, img_size)
    if augment:
        draws = draw_augment_params(rng, images.shape[0], img_size, device)
        images, targets, target_mask = augment_batch(images, targets, target_mask, draws)
    return images, targets, target_mask


def _loss(params: StateDict, spec: GraphSpec, images, targets, target_mask, img_size: int,
          compute_dtype: torch.dtype):
    with record_function("train/forward"):
        maps, new_stats = darknet.apply(params, spec, images, compute_dtype=compute_dtype,
                                        train=True)
    with record_function("train/loss"):
        total, per_head = yolo_loss(maps, spec, img_size, targets, target_mask)
    return total, new_stats, per_head


def _micro_step(state: TrainState, spec: GraphSpec, optimizer: Optimizer, batch, rng,
                img_size: int, augment: bool, compute_dtype: torch.dtype,
                ema_decay: Optional[float], do_apply: bool) -> Dict[str, torch.Tensor]:
    """One micro-batch: forward and backward (gradients add into ``.grad``),
    the apply when ``do_apply``, the BN running statistics, the EMA on an
    apply, the counters.  The ``train/*`` ranges name its parts in a
    ``torch.profiler`` trace (the backward's kernels run on autograd's
    device thread, outside them)."""
    dev = _device(state.params)
    with record_function("train/augment"):
        images, targets, target_mask = prepare_batch(*batch, img_size, dev, augment, rng)
    with _precision(compute_dtype, dev):
        total, new_stats, per_head = _loss(state.params, spec, images, targets, target_mask,
                                           img_size, compute_dtype)
        with record_function("train/backward"):
            total.backward()
    with record_function("train/optimizer"):
        if do_apply:
            optimizer.apply(state.optimizer)
        _set_stats(state.params, new_stats)
        if ema_decay is not None and do_apply:
            _ema_update(state.ema, state.params, ema_decay, state.step)
    state.step += 1
    state.seen += images.shape[0]
    return _metrics(total, per_head)


@torch.no_grad()
def _set_stats(params: StateDict, new_stats: StateDict) -> None:
    for k, v in new_stats.items():
        params[k].copy_(v)


def _metrics(total: torch.Tensor, per_head) -> Dict[str, torch.Tensor]:
    out = {"loss": total.detach()}
    for hi, m in enumerate(per_head):
        for name, v in m.items():
            out[f"head{hi}/{name}"] = v
    return out


StepFn = Callable[..., Tuple[object, Dict[str, torch.Tensor]]]


def make_train_step(spec: GraphSpec, optimizer: Optimizer, *, augment: bool = True,
                    compute_dtype: torch.dtype = torch.float32,
                    ema_decay: Optional[float] = None) -> StepFn:
    """``step(state, images_u8 (B, S0, S0, 3), targets (T, 6), target_mask
    (T,), rng, img_size) -> (state, metrics)``: one micro-batch and one
    Adam apply (reference ``make_train_step``, ``parallel/steps.py:146-214``).
    ``rng`` is a ``torch.Generator`` on the device (read only when
    ``augment``)."""

    def step(state: TrainState, images_u8, targets, target_mask, rng, img_size: int):
        metrics = _micro_step(state, spec, optimizer, (images_u8, targets, target_mask), rng,
                              img_size, augment, compute_dtype, ema_decay, do_apply=True)
        return state, metrics

    return step


def make_accum_train_step(spec: GraphSpec, optimizer: Optimizer, accum_steps: int, *,
                          augment: bool = True, compute_dtype: torch.dtype = torch.float32,
                          ema_decay: Optional[float] = None) -> StepFn:
    """The reference's accumulation schedule (``parallel/steps.py:217-331``,
    ``train.py:113-119``): every micro-batch runs forward and backward
    (gradients sum, BN running statistics and ``seen`` update); the
    optimizer applies the sum when ``micro % accum_steps == 0`` and clears
    it, and the EMA follows the applies.  ``step(astate, ...) -> (astate,
    metrics)``, the arguments as :func:`make_train_step`'s; ``metrics
    ["applied"]`` is 1.0 on an apply."""

    def step(astate: AccumState, images_u8, targets, target_mask, rng, img_size: int):
        do_apply = astate.micro % accum_steps == 0
        metrics = _micro_step(astate.inner, spec, optimizer, (images_u8, targets, target_mask),
                              rng, img_size, augment, compute_dtype, ema_decay, do_apply)
        astate.micro += 1
        metrics["applied"] = float(do_apply)
        return astate, metrics

    return step


def make_grad_step(spec: GraphSpec, *, augment: bool = False,
                   compute_dtype: torch.dtype = torch.float32) -> Callable:
    """``grad_step(params, images_u8, targets, target_mask, img_size, rng=None)
    -> (loss, grads, new_stats)``: the gradient of the loss with respect to
    every trainable parameter, no optimizer (reference ``make_grad_step``)."""

    def grad_step(params: StateDict, images_u8, targets, target_mask, img_size: int,
                  rng: Optional[torch.Generator] = None):
        dev = _device(params)
        images, targets, target_mask = prepare_batch(images_u8, targets, target_mask,
                                                     img_size, dev, augment, rng)
        p = {k: v.detach() for k, v in params.items()}
        keys = trainable_keys(p)
        for k in keys:
            p[k].requires_grad_(True)
        with _precision(compute_dtype, dev):
            total, new_stats, _ = _loss(p, spec, images, targets, target_mask, img_size,
                                        compute_dtype)
            grads = torch.autograd.grad(total, [p[k] for k in keys])
        return total.detach(), dict(zip(keys, grads)), new_stats

    return grad_step


def make_eval_forward(spec: GraphSpec, *, compute_dtype: torch.dtype = torch.float32
                      ) -> Callable:
    """``fwd(params, images_u8, img_size)``: eval-mode forward and the dense
    decode, ``(B, N, 5 + C)`` (reference ``make_eval_forward``)."""

    @torch.no_grad()
    def fwd(params: StateDict, images_u8, img_size: int) -> torch.Tensor:
        dev = _device(params)
        x = preprocess_tiles(torch.as_tensor(images_u8).to(dev), img_size)
        with _precision(compute_dtype, dev):
            maps = darknet.apply(params, spec, x, compute_dtype=compute_dtype)
        return heads.decode_all(maps, spec, img_size)

    return fwd


__all__ = ["TrainState", "AccumState", "Optimizer", "make_optimizer", "applies_done",
           "init_train_state", "init_accum_state", "make_train_step",
           "make_accum_train_step", "make_grad_step", "make_eval_forward",
           "prepare_batch", "trainable_keys"]
