"""The port's spans (``utils/spans.py``): ``record_function`` only while a
profiler records, the five ``detect/*`` spans of a ``Detector`` call and
the five ``train/*`` spans of a micro-step (with ``train/targets`` a head
inside ``train/loss``), on the CPU."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from amyloid_yolo_tpu_torch.detectors import Detector
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.parallel import steps
from amyloid_yolo_tpu_torch.parallel.spatial import make_spatial_mesh, shard_spatial_train_step
from amyloid_yolo_tpu_torch.utils import spans

from torch_port_helpers import port_mini_spec

DETECT = [spans.DETECT_PREPROCESS, spans.DETECT_BACKBONE, spans.DETECT_DECODE, spans.DETECT_NMS,
          spans.DETECT_RESCALE]
TRAIN = [spans.TRAIN_AUGMENT, spans.TRAIN_FORWARD, spans.TRAIN_LOSS, spans.TRAIN_BACKWARD,
         spans.TRAIN_OPTIMIZER]


@pytest.fixture
def opened(monkeypatch):
    """The names ``span`` hands to ``record_function``."""
    names = []
    real = torch.profiler.record_function

    def counting(name, *args):
        names.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return names


def _spans_of(prof, prefix):
    """``(name, start, end)`` of the CPU events named ``prefix…``, by start."""
    rows = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(prefix)]
    return sorted(rows, key=lambda r: r[1])


def test_span_calls_no_record_function_without_a_profiler(opened):
    for name in DETECT + TRAIN:
        with spans.span(name):
            pass
    assert opened == []


def test_span_records_only_in_the_profilers_active_phase(opened):
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        with spans.span(spans.TRAIN_LOSS):   # the warm-up phase keeps nothing
            pass
        prof.step()
        with spans.span(spans.TRAIN_FORWARD):
            torch.ones(4).add_(1)
    assert opened == [spans.TRAIN_FORWARD]
    assert [r[0] for r in _spans_of(prof, "train/")] == [spans.TRAIN_FORWARD]


def _tiles():
    return np.random.RandomState(7).randint(0, 255, (2, 256, 256, 3)).astype(np.uint8)


@pytest.mark.parametrize("lazy", [True, False])
def test_detector_call_opens_the_five_detect_spans_in_order(lazy):
    det = Detector(port_mini_spec(), compute_dtype=torch.float32, device="cpu",
                   conf_thres=0.3, nms_thres=0.4, model_size=64, tile_size=256, capacity=16,
                   lazy_decode=lazy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det(_tiles())
    rows = _spans_of(prof, "detect/")
    assert [r[0] for r in rows] == DETECT
    # one after another: none nested in another
    assert all(a[2] <= b[1] for a, b in zip(rows, rows[1:]))


def _batch(b=2, side=96):
    r = np.random.RandomState(3)
    imgs = r.randint(0, 256, (b, side, side, 3)).astype(np.uint8)
    t = np.zeros((4 * b, 6), np.float32)
    t[:, 0] = np.repeat(np.arange(b), 4)
    t[:, 1] = r.randint(0, 2, 4 * b)
    t[:, 2:4] = r.rand(4 * b, 2) * 0.8 + 0.1
    t[:, 4:6] = r.rand(4 * b, 2) * 0.3 + 0.05
    return imgs, t, np.ones(4 * b, bool)


@pytest.mark.parametrize("sharded", [False, True], ids=["one_device", "spatial_sp2"])
def test_micro_step_opens_the_five_train_spans(sharded):
    spec = port_mini_spec()
    params = darknet.init_params(torch.Generator().manual_seed(0), spec)
    opt = steps.make_optimizer(1e-3)
    state = steps.init_train_state(params, opt, device="cpu")
    step = steps.make_train_step(spec, opt, augment=True)
    if sharded:
        step = shard_spatial_train_step(step, make_spatial_mesh(2, devices=["cpu", "cpu"]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, *_batch(), torch.Generator().manual_seed(1), 64)
    every = _spans_of(prof, "train/")
    rows = [r for r in every if r[0] != spans.TRAIN_TARGETS]
    assert [r[0] for r in rows] == TRAIN
    assert all(a[2] <= b[1] for a, b in zip(rows, rows[1:]))
    # each head's target building, inside the loss
    loss = rows[TRAIN.index(spans.TRAIN_LOSS)]
    inner = [r for r in every if r[0] == spans.TRAIN_TARGETS]
    assert len(inner) == len(spec.yolo_indices)
    assert all(loss[1] <= r[1] and r[2] <= loss[2] for r in inner)
