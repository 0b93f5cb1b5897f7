"""Named host ranges around the port's layers, for a ``torch.profiler`` trace.

Every range the port opens goes through :func:`span` under one of the
names below; a trace reader matches them by these strings.  Outside an
active profiler :func:`span` costs one flag read: an idle
``record_function`` still costs several microseconds a range, which a
micro-step's handful and a ``Detector`` call's five would pay on every
untraced call.  The flag is the calling thread's and is false in a
profiler's warm-up phase, where a range would not be kept anyway.
"""

from __future__ import annotations

import contextlib

import torch

# the Detector's call, one range a call and a replica (``detectors.py``)
DETECT_PREPROCESS = "detect/preprocess"
DETECT_BACKBONE = "detect/backbone"
DETECT_DECODE = "detect/decode"
DETECT_NMS = "detect/nms"
DETECT_RESCALE = "detect/rescale"

# the train step's micro-batch (``parallel/steps.py``, ``distributed.py``,
# ``spatial.py``)
TRAIN_AUGMENT = "train/augment"
TRAIN_FORWARD = "train/forward"
TRAIN_LOSS = "train/loss"
#: inside ``train/loss``: each head's target building (``ops/loss.py``)
TRAIN_TARGETS = "train/targets"
TRAIN_BACKWARD = "train/backward"
TRAIN_OPTIMIZER = "train/optimizer"

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while this thread's profiler
    records, else a context that does nothing."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
