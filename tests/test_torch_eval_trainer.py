"""The port's evaluation, metrics, weight files and ``Trainer`` on the CPU:

* ``ops/metrics.py`` (a numpy copy) equal to the JAX package's;
* ``evaluate`` on a tiny dataset equal to the JAX package's with the same
  weights (P/R/AP/F1 within 1e-6: the detections are the same boxes up to
  float32 rounding, and the statistics are counted from them), with the
  NMS-pool overflow warning;
* weight files across the two packages, bit-equal: a reference-layout
  ``.pth`` the port writes loads through the JAX package's
  ``load_torch_state_dict``; darknet binaries in both directions;
* a ``Trainer`` smoke run: two epochs, checkpoints and retention, resume,
  best tracking and EMA evaluation logging;
* the entry points run on ``cuda`` unless told otherwise.
"""

import json
import os
import socket
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from amyloid_yolo_tpu.evaluate import evaluate as jax_evaluate
from amyloid_yolo_tpu.io import weights as jax_weights
from amyloid_yolo_tpu.ops import metrics as jax_metrics
from amyloid_yolo_tpu_torch.evaluate import evaluate
from amyloid_yolo_tpu_torch.io import weights
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.ops import metrics
from amyloid_yolo_tpu_torch.parallel import steps
from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec, stain_tile

STAT_TOL = 1e-6
MINI = mini_spec()


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """``tests/test_evaluate_train.py``'s layout: 128² JPEG tiles with YOLO
    labels, ``train.txt``, ``valid.txt``, ``classes.names``, ``custom.data``."""
    root = tmp_path_factory.mktemp("ds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.RandomState(0)
    paths = []
    for i in range(6):
        p = root / "images" / f"t{i}.jpg"
        Image.fromarray(stain_tile(rng, 128, 128)).save(p, quality=90)
        # the last box spans the tile, as the random model's merged boxes do,
        # so the evaluation below counts true positives
        (root / "labels" / f"t{i}.txt").write_text(
            f"1 0.5 0.5 0.2 0.2\n0 {0.2 + 0.1 * i:.2f} 0.3 0.15 0.1\n1 0.5 0.5 1.0 1.0\n")
        paths.append(str(p))
    (root / "train.txt").write_text("\n".join(paths[:3]) + "\n")
    (root / "valid.txt").write_text("\n".join(paths[3:]) + "\n")
    (root / "classes.names").write_text("CAA\nCored\n")
    (root / "custom.data").write_text(
        f"classes=2\ntrain={root}/train.txt\nvalid={root}/valid.txt\n"
        f"names={root}/classes.names\n")
    return root


def test_metrics_equal_jax():
    r = np.random.RandomState(0)
    outputs = []
    for i in range(4):
        n = r.randint(0, 6)
        xy = r.rand(n, 2) * 50
        rows = np.concatenate([xy, xy + 5 + r.rand(n, 2) * 20, r.rand(n, 2),
                               r.randint(0, 2, (n, 1))], axis=1).astype(np.float32)
        outputs.append(rows if n else None)
    t = np.concatenate([np.repeat(np.arange(4), 3)[:, None], r.randint(0, 2, (12, 1)),
                        r.rand(12, 2) * 50, r.rand(12, 2) * 50 + 60], axis=1).astype(np.float32)
    t[:, 4:] = t[:, 2:4] + 10 + r.rand(12, 2) * 10
    for thr in (0.1, 0.5):
        got = metrics.get_batch_statistics(outputs, t, thr)
        want = jax_metrics.get_batch_statistics(outputs, t, thr)
        assert len(got) == len(want) == sum(o is not None for o in outputs)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    tp = r.rand(40) > 0.5
    conf, cls = r.rand(40), r.randint(0, 3, 40)
    target_cls = r.randint(0, 3, 25)
    for a, b in zip(metrics.ap_per_class(tp, conf, cls, target_cls),
                    jax_metrics.ap_per_class(tp, conf, cls, target_cls)):
        np.testing.assert_array_equal(a, b)
    rec, prec = np.sort(r.rand(10)), r.rand(10)
    assert metrics.compute_ap(rec, prec) == jax_metrics.compute_ap(rec, prec)


def test_evaluate_matches_jax(tiny_dataset):
    params = jax_params_np(MINI, 0, bn_noise=True, jit=True)
    kw = dict(iou_thres=0.1, conf_thres=0.5, nms_thres=0.5, img_size=64, batch_size=2)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jax_evaluate(MINI, jax.tree.map(np.asarray, params),
                            str(tiny_dataset / "valid.txt"), nms_capacity=16, **kw)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = evaluate(port_mini_spec(), params_from_jax(params, port_mini_spec()),
                       str(tiny_dataset / "valid.txt"), nms_capacity=16, device="cpu", **kw)
    assert want is not None and got is not None
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a, b, rtol=0, atol=STAT_TOL)
    np.testing.assert_array_equal(got[4], want[4])
    assert float(np.max(want[2])) > 0  # some true positives: the counts compared mean something
    overflow = [str(w.message) for w in pw if issubclass(w.category, UserWarning)
                and "nms_capacity=16" in str(w.message)]
    jax_overflow = [str(w.message) for w in jw if "nms_capacity=16" in str(w.message)]
    assert overflow and jax_overflow
    assert overflow[0].split(" images")[0] == jax_overflow[0].split(" images")[0]  # "evaluate: 3/3"


def test_pth_written_by_the_port_loads_in_jax(tmp_path):
    params = jax_params_np(MINI, 1, bn_noise=True, jit=True)
    sd = weights.params_to_torch_state_dict(port_mini_spec(), params_from_jax(params, port_mini_spec()))
    assert all(v.device.type == "cpu" for v in sd.values())
    torch.save(sd, tmp_path / "w.pth")
    back = jax_weights.load_torch_state_dict(MINI, str(tmp_path / "w.pth"))
    for k, entry in params.items():
        for kk, v in entry.items():
            np.testing.assert_array_equal(np.asarray(back[k][kk]), v, err_msg=f"{k}.{kk}")
    again = weights.load_pretrained(port_mini_spec(), str(tmp_path / "w.pth"))
    assert set(again) | {k for k in sd if k.endswith("num_batches_tracked")} == set(sd)
    for k, v in again.items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(ValueError, match="#ema"):
        weights.load_pretrained(port_mini_spec(), str(tmp_path / "w.pth") + "#ema")
    with pytest.raises(FileNotFoundError):
        weights.load_pretrained(port_mini_spec(), str(tmp_path / "missing.pth"))


def test_darknet_binaries_both_ways(tmp_path):
    params = jax_params_np(MINI, 2, bn_noise=True, jit=True)
    sd = params_from_jax(params, port_mini_spec())
    weights.save_darknet_weights(port_mini_spec(), sd, str(tmp_path / "port.weights"), seen=96)
    back, header = jax_weights.load_darknet_weights(MINI, str(tmp_path / "port.weights"))
    assert int(header[3]) == 96
    for k, entry in params.items():
        for kk, v in entry.items():
            np.testing.assert_array_equal(np.asarray(back[k][kk]), v, err_msg=f"{k}.{kk}")
    jax_weights.save_darknet_weights(MINI, params, str(tmp_path / "jax.weights"), seen=7)
    port_back, header = weights.load_darknet_weights(port_mini_spec(), str(tmp_path / "jax.weights"))
    assert int(header[3]) == 7
    for k, v in sd.items():
        assert torch.equal(port_back[k], v), k
    via_dispatch = weights.load_pretrained(port_mini_spec(), str(tmp_path / "jax.weights"))
    for k, v in via_dispatch.items():
        assert torch.equal(v, sd[k]), k
    assert (tmp_path / "port.weights").read_bytes()[20:] == \
        (tmp_path / "jax.weights").read_bytes()[20:]


def _events(logdir):
    (run,) = os.listdir(logdir)
    with open(os.path.join(logdir, run, "events.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def test_trainer_smoke_resume_and_retention(tiny_dataset, tmp_path, capsys, monkeypatch):
    # no TensorBoard writer (importing it loads TensorFlow where that is
    # installed, ~15 s): the logger's JSONL stream alone, which is read below
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = TrainConfig(data_config=str(tiny_dataset / "custom.data"), epochs=2, batch_size=2,
                      img_size=64, multiscale=False, augment=True, gradient_accumulations=2,
                      checkpoint_dir=str(tmp_path / "ckpts"), logdir=str(tmp_path / "logs"),
                      ema_decay=0.9, keep_checkpoints=1)
    tr = Trainer(cfg, spec=port_mini_spec(), device="cpu")
    seen = []
    state = tr.train(callback=lambda ep, bi, m: seen.append((ep, bi, float(m["loss"]),
                                                             m["applied"])))
    # 3 images at batch 2: two micro-batches (2 + 1 images) per epoch
    assert [(e, b) for e, b, _, _ in seen] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [a for *_, a in seen] == [1.0, 0.0, 1.0, 0.0]
    assert all(np.isfinite(l) for _, _, l, _ in seen)
    assert (state.step, state.seen) == (4, 6)
    out = capsys.readouterr().out
    assert "Best mAP" in out and "Best EMA mAP" in out
    ev = _events(cfg.logdir)
    maps = [e["validation/mAP"] for e in ev if "validation/mAP" in e]
    ema_maps = [e["validation/mAP_ema"] for e in ev if "validation/mAP_ema" in e]
    assert len(maps) == len(ema_maps) == 2 and all(0.0 <= m <= 1.0 for m in maps + ema_maps)
    assert tr.best["map"][1] in (0, 1) and tr.best["map_ema"][1] in (0, 1)
    assert [w["batches"] for w in tr.epoch_walls] == [2, 2]
    # retention: the newest epoch and every best epoch survive
    kept = sorted(os.listdir(cfg.checkpoint_dir))
    want = {1} | {ep for _, ep in tr.best.values() if ep >= 0}
    assert kept == sorted(f"yolov3_ckpt_{ep}.pt" for ep in want)

    last = tr.checkpoint_path(1)
    ck = torch.load(last, weights_only=True)
    assert set(ck) == {"params", "optimizer", "step", "seen", "ema"}
    assert (ck["step"], ck["seen"]) == (4, 6)
    ema = weights.load_pretrained(port_mini_spec(), last + "#ema")
    for k, v in ema.items():
        assert torch.equal(v, tr.state.ema[k].float()), k

    tr2 = Trainer(cfg, spec=port_mini_spec(), device="cpu")
    tr2.load_checkpoint(last)
    for k, v in tr.state.params.items():
        if v.is_floating_point():
            assert torch.equal(tr2.state.params[k], v), k
    opt_a, opt_b = tr.state.optimizer.state_dict(), tr2.state.optimizer.state_dict()
    for i, st in opt_a["state"].items():
        for kk in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_b["state"][i][kk], st[kk])
    assert tr2.evaluate() is not None
    np.testing.assert_allclose(tr2.evaluate()[2], tr.evaluate()[2], rtol=0, atol=0)
    state2 = tr2.train()  # the restored state steps
    assert (state2.step, state2.seen) == (8, 12)
    assert all(torch.isfinite(v).all() for v in state2.params.values()
               if v.is_floating_point())


def test_entry_points_default_to_cuda(tiny_dataset, tmp_path):
    cfg = TrainConfig(data_config=str(tiny_dataset / "custom.data"),
                      logdir=str(tmp_path / "logs"))
    if torch.cuda.is_available():
        assert Trainer(cfg, spec=port_mini_spec()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(cfg, spec=port_mini_spec())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            evaluate(port_mini_spec(), {}, str(tiny_dataset / "valid.txt"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            steps.init_train_state({}, steps.make_optimizer())
        # distributed: no quiet gloo run on the CPU; no group is joined
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ddp = TrainConfig(data_config=str(tiny_dataset / "custom.data"), distributed=True,
                          coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                          process_id=0, logdir=str(tmp_path / "logs"))
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                Trainer(ddp, spec=port_mini_spec(), device=device)
        assert not torch.distributed.is_initialized()
    bad = TrainConfig(data_config=str(tiny_dataset / "custom.data"), spatial_shard=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        Trainer(bad, spec=port_mini_spec(), device="cpu")
    # data_parallel is ported: with device="cpu" its mesh is CPU entries
    dp = TrainConfig(data_config=str(tiny_dataset / "custom.data"), data_parallel=2,
                     logdir=str(tmp_path / "logs"))
    assert Trainer(dp, spec=port_mini_spec(), device="cpu").device.type == "cpu"
