"""Device resolution for the port's entry points.

The port runs on the GPU.  The CPU is used only when a caller asks for it
explicitly (the CPU tests do); a missing GPU never silently turns into a
CPU run.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise when the resolved device is CUDA and no
    CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved = (True, True)


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls in full float32 on the card.

    The two TF32 flags are process-wide, so sections that overlap (in one
    thread or several: a float32 ``Detector`` call beside the CAA filter
    of a request thread) share one save and restore: the first section to
    enter saves the flags and turns TF32 off, the last to leave restores
    them.  A float32 convolution that another thread runs meanwhile, outside
    any section, runs in full float32 too."""
    global _tf32_depth, _tf32_saved
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved


__all__ = ["resolve_device", "DeviceLike", "no_tf32"]
