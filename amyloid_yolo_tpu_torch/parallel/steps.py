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

Data parallelism (the reference's ``shard_train_step``,
``parallel/steps.py:380-395``): the reference's data-parallel step is one
global program, so its BN statistics are the global batch's (sync-BN) and
its loss's masked means divide by global counts.  Averaging per-device
losses with per-device BN would compute another function, so every step
here takes ``shards``, which splits the global batch and sums each partial
statistic over the shards at the point where it is needed (the
``reducer`` of ``darknet.apply`` and ``ops.loss``):

* :class:`MeshShards` (:func:`shard_train_step`): the shards of one
  process on the devices of a :class:`~.mesh.Mesh`, one thread each; the
  sums go to the first device with ``.to()``, which is differentiable, and
  back, so one ``backward()`` of the global loss fills the master
  parameters' gradients;
* ``distributed.ProcessShards``: one shard a process, the sums through
  an autograd-aware all-reduce.

Either way the augmentation draws for the global batch from the one
generator and each shard takes its rows, and a shard's target rows carry
shard-local batch indices.  In one process the host issues every device's
launches, so :class:`MeshShards` is the semantic counterpart of the
reference's ``data_parallel``; the multi-process form is the one that
scales.  Spatial sharding (``parallel/spatial.py``) is not ported
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graphspec import GraphSpec
from ..io.weights import StateDict
from ..models import darknet, heads
from ..ops.augment import augment_batch, draw_augment_params
from ..ops.loss import yolo_loss
from ..ops.preprocess import preprocess_tiles
from ..utils.device import DeviceLike, no_tf32, resolve_device
from .mesh import Mesh, shard_size, to_device

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
          compute_dtype: torch.dtype, reducer=None):
    with record_function("train/forward"):
        maps, new_stats = darknet.apply(params, spec, images, compute_dtype=compute_dtype,
                                        train=True, reducer=reducer)
    with record_function("train/loss"):
        total, per_head = yolo_loss(maps, spec, img_size, targets, target_mask, reducer)
    return total, new_stats, per_head


def shard_batch(images_u8, targets, target_mask, row0: int, img_size: int,
                device: torch.device, draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's model input: its uint8 images (the global batch's rows
    ``row0 ..``) resized and scaled on ``device``, augmented with its rows
    of the global ``draws``, and the target rows with shard-local batch
    indices (``batch_idx − row0``); rows of other shards leave the mask."""
    images_u8 = torch.as_tensor(images_u8).to(device)
    targets = torch.as_tensor(targets).to(device, torch.float32)
    target_mask = torch.as_tensor(target_mask).to(device, torch.bool)
    local = targets[:, :1] - row0
    target_mask = target_mask & (local[:, 0] >= 0) & (local[:, 0] < images_u8.shape[0])
    targets = torch.cat([local, targets[:, 1:]], dim=1)
    images = preprocess_tiles(images_u8, img_size)
    if draws is not None:
        images, targets, target_mask = augment_batch(images, targets, target_mask, draws)
    return images, targets, target_mask


def flat_cat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def flat_split(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return tuple(out)


class _ShardReducer:
    """Sums partial statistics over the shards of one in-process step, each
    shard in a thread of its own.  At a reduction every shard hands in its
    tensors (flattened into one) and waits at a barrier; the last to arrive
    adds them on the first device in shard order, and each shard takes the
    sums back onto its own device.  Every copy is a differentiable
    :func:`~.mesh.to_device`."""

    def __init__(self, devices: Sequence[torch.device], timeout: float):
        self.devices = tuple(devices)
        self.world = len(self.devices)
        self._parts: List[Optional[torch.Tensor]] = [None] * self.world
        self._sum: Optional[torch.Tensor] = None
        self.barrier = threading.Barrier(self.world, action=self._combine, timeout=timeout)

    def _combine(self) -> None:
        first = self.devices[0]
        total = to_device(self._parts[0], first)
        for part in self._parts[1:]:
            total = total + to_device(part, first)
        self._sum = total

    def view(self, k: int) -> Callable[..., Tuple[torch.Tensor, ...]]:
        def reduce(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
            self._parts[k] = flat_cat(tensors)
            self.barrier.wait()
            return flat_split(to_device(self._sum, self.devices[k]), tensors)

        reduce.world = self.world
        return reduce


#: seconds a shard waits at a reduction for the others before the step fails
SHARD_WAIT_S = 300.0


class MeshShards:
    """Data parallelism in one process over a :class:`~.mesh.Mesh` whose
    first device holds the parameters (see the module docstring)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def run(self, params: StateDict, spec: GraphSpec, batch, rng, img_size: int,
            augment: bool, compute_dtype: torch.dtype):
        """The global batch's loss, its gradient added into ``params``'
        ``.grad``: ``(loss, new_stats, per_head, images)``."""
        devices = self.mesh.devices
        if _device(params) != devices[0]:
            raise ValueError(f"the parameters are on {_device(params)}, not on the mesh's "
                             f"first device {devices[0]}")
        images_u8, targets, target_mask = (torch.as_tensor(a) for a in batch)
        n = images_u8.shape[0]
        b = shard_size(n, self.mesh)
        with record_function("train/augment"):
            draws = (draw_augment_params(rng, n, img_size, devices[0]) if augment else None)
        reducer = _ShardReducer(devices, SHARD_WAIT_S)

        def shard(k: int):
            dev = devices[k]
            rows = slice(k * b, (k + 1) * b)
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                p = {key: to_device(v, dev) for key, v in params.items()}
                with record_function("train/augment"):
                    d = ({key: to_device(v[rows], dev) for key, v in draws.items()}
                         if augment else None)
                    shard_in = shard_batch(images_u8[rows], targets, target_mask, k * b,
                                           img_size, dev, d)
                return _loss(p, spec, *shard_in, img_size, compute_dtype, reducer.view(k))

        total, new_stats, per_head = _run_threads(shard, len(devices), reducer.barrier)[0]
        with record_function("train/backward"):
            total.backward()
        return total, new_stats, per_head, n


def _run_threads(fn: Callable[[int], object], n: int, barrier: threading.Barrier) -> list:
    """``[fn(0), …, fn(n − 1)]``, each in a thread of its own; a failing
    shard breaks the barrier, so the others stop waiting, and its error is
    raised here."""
    results: list = [None] * n
    errors: list = []

    def target(k: int) -> None:
        try:
            results[k] = fn(k)
        except BaseException as e:  # raised below, in the caller's thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=target, args=(k,), name=f"dp-shard-{k}")
               for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # a shard's own error, not the broken barrier it left the others
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return results


def _micro_step(state: TrainState, spec: GraphSpec, optimizer: Optimizer, batch, rng,
                img_size: int, augment: bool, compute_dtype: torch.dtype,
                ema_decay: Optional[float], do_apply: bool, shards=None
                ) -> Dict[str, torch.Tensor]:
    """One micro-batch: forward and backward (gradients add into ``.grad``),
    the apply when ``do_apply``, the BN running statistics, the EMA on an
    apply, the counters.  ``shards`` (:class:`MeshShards`,
    ``distributed.ProcessShards``) runs the forward and backward data
    parallel.  The ``train/*`` ranges name its parts in a
    ``torch.profiler`` trace (the backward's kernels run on autograd's
    device thread, outside them)."""
    dev = _device(state.params)
    if shards is None:
        with record_function("train/augment"):
            images, targets, target_mask = prepare_batch(*batch, img_size, dev, augment, rng)
        with _precision(compute_dtype, dev):
            total, new_stats, per_head = _loss(state.params, spec, images, targets,
                                               target_mask, img_size, compute_dtype)
            with record_function("train/backward"):
                total.backward()
        n_images = images.shape[0]
    else:
        with _precision(compute_dtype, dev):
            total, new_stats, per_head, n_images = shards.run(
                state.params, spec, batch, rng, img_size, augment, compute_dtype)
    with record_function("train/optimizer"):
        if do_apply:
            optimizer.apply(state.optimizer)
        _set_stats(state.params, new_stats)
        if ema_decay is not None and do_apply:
            _ema_update(state.ema, state.params, ema_decay, state.step)
    state.step += 1
    state.seen += n_images
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
    ``augment``); ``shards`` runs it data parallel (:func:`shard_train_step`)."""

    def step(state: TrainState, images_u8, targets, target_mask, rng, img_size: int,
             shards=None):
        metrics = _micro_step(state, spec, optimizer, (images_u8, targets, target_mask), rng,
                              img_size, augment, compute_dtype, ema_decay, do_apply=True,
                              shards=shards)
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

    def step(astate: AccumState, images_u8, targets, target_mask, rng, img_size: int,
             shards=None):
        do_apply = astate.micro % accum_steps == 0
        metrics = _micro_step(astate.inner, spec, optimizer, (images_u8, targets, target_mask),
                              rng, img_size, augment, compute_dtype, ema_decay, do_apply,
                              shards=shards)
        astate.micro += 1
        metrics["applied"] = float(do_apply)
        return astate, metrics

    return step


def make_grad_step(spec: GraphSpec, *, augment: bool = False,
                   compute_dtype: torch.dtype = torch.float32) -> Callable:
    """``grad_step(params, images_u8, targets, target_mask, img_size, rng=None,
    shards=None) -> (loss, grads, new_stats)``: the gradient of the loss with
    respect to every trainable parameter, no optimizer (reference
    ``make_grad_step``); ``shards`` as the train steps take it."""

    def grad_step(params: StateDict, images_u8, targets, target_mask, img_size: int,
                  rng: Optional[torch.Generator] = None, shards=None):
        dev = _device(params)
        p = {k: v.detach() for k, v in params.items()}
        keys = trainable_keys(p)
        for k in keys:
            p[k].requires_grad_(True)
        if shards is not None:
            with _precision(compute_dtype, dev):
                total, new_stats, _, _ = shards.run(p, spec, (images_u8, targets, target_mask),
                                                    rng, img_size, augment, compute_dtype)
            return total.detach(), {k: p[k].grad for k in keys}, new_stats
        images, targets, target_mask = prepare_batch(images_u8, targets, target_mask,
                                                     img_size, dev, augment, rng)
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


def shard_train_step(step_fn: StepFn, mesh: Mesh) -> StepFn:
    """A step of :func:`make_train_step` or :func:`make_accum_train_step`
    run data parallel over ``mesh`` (reference ``shard_train_step``): the
    same arguments, with the global batch; the state stays on the mesh's
    first device, and every shard takes copies of its parameters."""
    shards = MeshShards(mesh)

    def sharded(state, images_u8, targets, target_mask, rng, img_size: int):
        return step_fn(state, images_u8, targets, target_mask, rng, img_size, shards=shards)

    return sharded


__all__ = ["TrainState", "AccumState", "Optimizer", "make_optimizer", "applies_done",
           "init_train_state", "init_accum_state", "make_train_step",
           "make_accum_train_step", "make_grad_step", "make_eval_forward",
           "prepare_batch", "shard_batch", "trainable_keys", "MeshShards", "SHARD_WAIT_S",
           "shard_train_step"]
