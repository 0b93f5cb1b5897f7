"""Multi-process data parallelism (reference package ``parallel/distributed.py``).

The reference joins JAX's distributed runtime and runs its one global
data-parallel program over every process's devices.  Here each process
(rank) drives one device, holds a full copy of the train state and runs
its rows of the global batch; :class:`ProcessShards` sums each partial
statistic over the ranks with an autograd-aware all-reduce
(``torch.distributed.nn.functional.all_reduce``), so BN normalises with
the global batch's statistics and the loss's means divide by global
counts, as in the reference's program.

Gradients.  Every rank computes the same global loss.  The all-reduce's
backward sums the incoming gradients over the ranks, so each rank's
backward yields the gradient of ``world × loss`` through its own rows; the
ranks' gradients are therefore averaged (summed, then divided by
``world``), which gives the global loss's gradient exactly.  A reducer
whose backward were the identity, followed by a sum, would lose the
cross-rank terms of the chained BN statistics (a rank's activations move
every rank's later layers through the statistics).  Every rank then takes
the same Adam step, so the copies stay equal.

Backends: NCCL on the card, gloo on the CPU (or with CUDA tensors where
NCCL cannot run, such as two ranks on one card, when asked for by name).
Nothing falls back from one to the other.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from .mesh import Mesh, normalize_device
from .steps import Layout, _loss, _device, flat_cat, flat_split, shard_batch, trainable_keys
from ..ops.augment import draw_augment_params
from ..utils.device import resolve_device
from ..utils.spans import TRAIN_AUGMENT, TRAIN_BACKWARD, span

#: seconds a collective (a barrier included) waits for the other ranks
DEFAULT_TIMEOUT_S = 1800.0

_local_device: Optional[torch.device] = None


def _default_device(device, process_id: Optional[int]) -> torch.device:
    if device is not None:
        return normalize_device(resolve_device(device))
    resolve_device("cuda")  # raises without a card: the CPU is asked for by name
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
        local = rank % torch.cuda.device_count()
    return torch.device("cuda", int(local))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               device=None,
               timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join (or start) the process group.  Idempotent: a second call in the
    same process (a launcher, then ``Trainer(distributed=True)``) returns.

    ``coordinator_address`` ``"host:port"`` (rank 0 listens there) with
    ``num_processes`` and ``process_id``; ``None`` reads torchrun's
    variables (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  The rank drives ``device``, by default
    ``cuda:LOCAL_RANK`` (without ``LOCAL_RANK``, the rank modulo the card
    count); it raises where there is no card unless ``device="cpu"`` is
    passed.  ``backend`` defaults to
    NCCL for a CUDA device and gloo for the CPU.  ``timeout`` bounds every
    collective, in seconds."""
    global _local_device
    if dist.is_initialized():
        if _local_device is None:
            _local_device = _default_device(device, dist.get_rank())
        return
    dev = _default_device(device, process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout))
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        kwargs["init_method"] = (coordinator_address if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs.update(world_size=num_processes, rank=process_id)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL needs a CUDA device, got {dev}")
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev  # NCCL connects now: a failure shows here
    dist.init_process_group(**kwargs)
    _local_device = dev


def local_device() -> torch.device:
    """The device this rank drives (:func:`initialize`)."""
    if _local_device is None:
        raise RuntimeError("initialize() the process group first")
    return _local_device


def global_mesh() -> Mesh:
    """One entry per rank, in rank order, each the device its rank drives;
    this process's entry is its local one."""
    if not dist.is_initialized():
        raise RuntimeError("initialize() the process group first")
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, str(local_device()))
    return Mesh(tuple(torch.device(d) for d in devices), local=(dist.get_rank(),))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """This process's share of a global batch split over the mesh."""
    n_local, n_total = len(mesh.local_devices), mesh.size
    if global_batch % n_total:
        raise ValueError(f"global batch {global_batch} must divide over {n_total} devices")
    return global_batch // n_total * n_local


class _GroupReducer:
    """Sums tensors over the ranks, flattened into one autograd-aware
    all-reduce."""

    def __init__(self, world: int):
        self.world = world

    def __call__(self, *tensors: torch.Tensor):
        total = dist_nn.all_reduce(flat_cat(tensors), op=dist.ReduceOp.SUM)
        return flat_split(total, tensors)


class ProcessShards:
    """Data parallelism over the ranks of a :func:`global_mesh`, one local
    device each (see the module docstring).  A rank passes its own rows of
    the global batch, their targets with global batch indices, as
    ``ListDataset.iter_epoch(shard=...)`` collates them; every rank's
    generator must draw the same values (the same seed on the same kind of
    device)."""

    def __init__(self, mesh: Mesh):
        if mesh.local is None or len(mesh.local) != 1:
            raise ValueError("a multi-process mesh has one local device a process")
        self.mesh = mesh
        self.rank = mesh.local[0]
        self.world = mesh.size

    def run(self, params, spec, batch, rng, img_size: int, augment: bool,
            compute_dtype: torch.dtype, layout: Layout = Layout()):
        """The global batch's loss, with the global loss's gradient added
        into ``params``' ``.grad`` on every rank: ``(loss, new_stats,
        per_head, images)``, ``images`` counting the global batch."""
        dev = _device(params)
        images_u8, targets, target_mask = batch
        b = len(images_u8)
        row0 = self.rank * b
        with span(TRAIN_AUGMENT):
            draws = None
            if augment:  # the global batch's draws, this rank's rows
                draws = {k: v[row0:row0 + b] for k, v in
                         draw_augment_params(rng, b * self.world, img_size, dev).items()}
            shard_in = shard_batch(images_u8, targets, target_mask, row0, img_size, dev, draws,
                                   layout.image_layout)
        total, new_stats, per_head = _loss(params, spec, *shard_in, img_size, compute_dtype,
                                           _GroupReducer(self.world), layout)
        keys = trainable_keys(params)
        tensors = [params[k] for k in keys]
        with span(TRAIN_BACKWARD):
            grads = torch.autograd.grad(total, tensors)
            flat = flat_cat(grads)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat /= self.world
        with torch.no_grad():
            for p, g in zip(tensors, flat_split(flat, grads)):
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.add_(g)
        return total, new_stats, per_head, b * self.world


def shard_train_step_multiprocess(step_fn, mesh: Mesh):
    """A step of ``steps.make_train_step`` or ``make_accum_train_step`` run
    over the ranks of ``mesh`` (reference ``shard_train_step_multiprocess``).
    Each process passes its own rows of the global batch; the state is
    replicated (the same initial values on every rank, kept equal by equal
    updates)."""
    shards = ProcessShards(mesh)

    def sharded(state, images_u8, targets, target_mask, rng, img_size: int):
        return step_fn(state, images_u8, targets, target_mask, rng, img_size, shards=shards)

    return sharded


def process_shard(items: list, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> list:
    """Per-process file sharding: process ``i`` owns every
    ``num_processes``-th item; the uneven tail is dropped so every process
    takes the same count (collectives run in lockstep).  The defaults are
    this process's rank and the world size (0 and 1 without a group)."""
    if process_id is None:
        process_id = dist.get_rank() if dist.is_initialized() else 0
    if num_processes is None:
        num_processes = dist.get_world_size() if dist.is_initialized() else 1
    if num_processes <= 1:
        return list(items)
    usable = len(items) - (len(items) % num_processes)
    return [items[i] for i in range(process_id, usable, num_processes)]


def fetch_replicated(x: Any) -> np.ndarray:
    """A replicated value (a loss, a metric, a parameter) on the host."""
    return torch.as_tensor(x).detach().cpu().numpy()


def barrier() -> None:
    """Wait for every rank (on this rank's device under NCCL)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[local_device().index])
    else:
        dist.barrier()


__all__ = ["initialize", "local_device", "global_mesh", "local_batch_size", "ProcessShards",
           "shard_train_step_multiprocess", "process_shard", "fetch_replicated", "barrier",
           "DEFAULT_TIMEOUT_S"]
