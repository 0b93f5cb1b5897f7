"""Device meshes for data parallelism (reference package ``parallel/mesh.py``).

A :class:`Mesh` is an ordered tuple of torch devices along one axis,
``dp``.  Its first device is where parameters live and results gather.
The reference's ``batch_sharding`` becomes :func:`split_batch`, an even
split of the leading dimension with one part on each device, and its
``replicated`` becomes :func:`replicate`, a copy of a tensor tree on each
device.  PyTorch has no compiler to derive the collectives, so the
callers do the rest: ``Detector(mesh=)`` runs one shard a device and
gathers, ``parallel.steps.shard_train_step`` sums the partial statistics
of every shard (sync-BN and the loss's global means).

A mesh may name one device more than once (two shards on one card) and
may be a list of CPU entries, which stand for the reference suite's
virtual CPU devices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along the data-parallel axis.  ``local`` holds the indices of
    the entries this process drives: all of them for a mesh of one process
    (:func:`make_mesh`), one for the global mesh of a multi-process run
    (:func:`~.distributed.global_mesh`)."""
    axis: ClassVar[str] = "dp"
    devices: Tuple[torch.device, ...]
    local: Optional[Tuple[int, ...]] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        idx = range(self.size) if self.local is None else self.local
        return tuple(self.devices[i] for i in idx)


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a bare ``cuda`` with the current
    card's index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``cuda:0 .. n-1`` (all cards when ``n_devices`` is
    ``None``); it raises when more are asked for than there are.  Or over
    an explicit ``devices`` list, whose entries may repeat (``["cuda:0",
    "cuda:0"]``, ``["cpu"] * 8``)."""
    if devices is not None:
        devs = tuple(normalize_device(d) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"requested {n_devices} devices, listed {len(devs)}")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        for d in devs:
            if d.type == "cuda" and d.index >= have:
                raise ValueError(f"{d} requested, have {have} CUDA devices")
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        if n < 1 or n > have:
            raise ValueError(f"requested {n} devices, have {have} CUDA devices")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh's devices are of one type, got {devs}")
    return Mesh(devs)


def shard_size(batch: int, mesh: Mesh) -> int:
    """Rows a shard takes of a leading dimension of ``batch``; it raises on
    a remainder, as the reference's batch sharding does."""
    if batch % mesh.size:
        raise ValueError(f"batch {batch} must divide over the {mesh.size} devices "
                         f"of the dp axis")
    return batch // mesh.size


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: a differentiable copy across devices, ``t``
    itself where it is already there.  Every move between the devices of a
    mesh goes through here (the CPU tests make it copy always, so that the
    paths across cards run on one device)."""
    return t.to(device)


def split_batch(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``x``'s leading dimension in even parts, part ``k`` on device ``k``
    (the counterpart of ``batch_sharding``).  No part waits for another."""
    b = shard_size(x.shape[0], mesh)
    return [to_device(x[k * b:(k + 1) * b], d) for k, d in enumerate(mesh.devices)]


def tree_to(tree: Any, device: torch.device) -> Any:
    """A tree of dicts, lists and tuples with its tensors on ``device``
    (tensors already there are shared, not copied)."""
    if isinstance(tree, torch.Tensor):
        return to_device(tree, device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_to(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def replicate(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of ``tree`` on each device of the mesh (the counterpart of
    ``replicated``); entries that name one device share its copy."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = tree_to(tree, d)
    return [copies[d] for d in mesh.devices]


__all__ = ["Mesh", "make_mesh", "normalize_device", "shard_size", "to_device", "split_batch",
           "replicate", "tree_to"]
