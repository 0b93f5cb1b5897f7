"""The augmentation policy's random draws: a frozen copy of the port's
``ops/augment.py:draw_augment_params``, so that the reference, given a
generator seeded as the program's is, draws the same numbers in the same
order.  Everything the draws then do to the images and boxes the
reference computes itself (:mod:`.train`)."""

from __future__ import annotations

from typing import Dict

import torch


def draw_augment_params(generator: torch.Generator, batch: int, size: int,
                        device) -> Dict[str, torch.Tensor]:
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {
        "drop_rate": u(batch) * 0.01,
        "sharp_alpha": u(batch) * 0.2,
        "angle": u(batch) * 40.0 - 20.0,
        "trans": u(batch, 2) * 0.4 - 0.2,
        "bright": (u(batch) * 60.0 - 30.0) / 255.0,
        "hue": (u(batch) * 40.0 - 20.0) * 2.0 / 360.0,
        "flip": u(batch) < 0.5,
        "drop_u": u(batch, size, size),
    }
