"""The general generators: a traffic file's parameters and the seed in,
the cell's inputs out, made on the device in a few large calls.

Two kinds of traffic:

* ``detect``: a pool of ``pool_batches`` batches of ``batch`` uint8
  ``tile``² RGB tiles (uniform noise), cycled in order through the
  window with ``in_flight`` batches on the device at a time.
* ``train``: a pool of ``pool_batches`` batches of ``batch`` uint8
  ``tile``² images, each with ``boxes`` = [lo, hi] boxes (class, centre,
  size drawn uniformly; ``box_size`` bounds the normalized sides) in a
  block of ``max_objects`` target rows, as the port's loader pads them, and
  the multiscale schedule: the size changes every ``per_size``
  micro-batches, through the sizes of ``order`` in that order, each once a
  cycle.  The order is the same for every seed: a window ends inside a
  cycle, and an order drawn from the seed made the work of that last part
  cycle, and with it the rate, depend on the seed.  Small and large sizes
  alternate in it, so that any part of a cycle is near its mean.

Every seed gives the same sizes, shapes and counts of work; only the
values change.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import torch


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one stream of the run, from ``--seed`` and a name."""
    digest = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, what: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, what))


def tile_pool(mix: dict, seed: int, device) -> torch.Tensor:
    """``(pool_batches, batch, tile, tile, 3)`` uint8."""
    shape = (mix["pool_batches"], mix["batch"], mix["tile"], mix["tile"], 3)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                         generator=generator(seed, "tiles", device))


def boxes(mix: dict, seed: int, device, classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded targets ``(pool_batches, batch·cap, 6)`` rows ``(image, class,
    cx, cy, w, h)`` (normalized) and their ``(pool_batches, batch·cap)``
    validity, ``cap`` = ``max_objects``: image ``i`` of a batch owns rows
    ``i·cap …`` and the first ``n_i`` of them are its boxes."""
    g = generator(seed, "boxes", device)
    p, b = mix["pool_batches"], mix["batch"]
    lo, hi = mix["boxes"]
    cap = mix["max_objects"]
    if hi > cap:
        raise ValueError(f"boxes {mix['boxes']} exceed max_objects {cap}")
    s_lo, s_hi = mix["box_size"]
    n = torch.randint(lo, hi + 1, (p, b), generator=g, device=device)
    u = torch.rand((p, b, cap, 5), generator=g, device=device)
    wh = s_lo + (s_hi - s_lo) * u[..., 2:4]
    centre = wh / 2 + (1 - wh) * u[..., 0:2]
    cls = torch.floor(u[..., 4] * classes).clamp(max=classes - 1)
    image = torch.arange(b, device=device)[None, :, None].expand(p, b, cap).to(torch.float32)
    targets = torch.cat([image[..., None], cls[..., None], centre, wh], dim=-1)
    valid = torch.arange(cap, device=device)[None, None, :] < n[..., None]
    return targets.reshape(p, b * cap, 6), valid.reshape(p, b * cap)


def size_cycle(mix: dict) -> List[int]:
    """One cycle's sizes in order: ``per_size`` micro-batches of each."""
    return list(mix["order"])


def schedule(mix: dict, n: int) -> List[int]:
    """The size of each of the window's first ``n`` micro-batches."""
    cyc, per = size_cycle(mix), mix["per_size"]
    return [cyc[(i // per) % len(cyc)] for i in range(n)]


def draw_order(n_items: int, k: int, seed: int, what: str) -> List[int]:
    """``k`` distinct indices of ``range(n_items)`` drawn from the seed."""
    g = torch.Generator().manual_seed(sub_seed(seed, what))
    return sorted(torch.randperm(n_items, generator=g)[:k].tolist())
