"""The port's overlapped checkpoint save (``training.py:Trainer.save_checkpoint``,
the reference package's ``training.py:372-459``) on the CPU:

* the save returns before its write lands, and the file holds the state as
  it was at the dispatch, bit for bit (``-0.0`` included), though a train
  step runs between the dispatch and the join;
* a failed write raises ``RuntimeError`` at the next join, once;
* ``train()`` returns with no save in flight; retention
  (``keep_checkpoints``) and the files read back through
  ``io/weights.py:load_pretrained`` and ``path#ema``;
* a Trainer across processes saves synchronously, and one in a process
  group of one overlaps its save, as the reference (``training.py:379``);
* ``save_walls`` times each save's parts.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from amyloid_yolo_tpu_torch import training
from amyloid_yolo_tpu_torch.io import weights
from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer

from torch_port_helpers import port_mini_spec, stain_tile

JOIN_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.RandomState(1)
    paths = []
    for i in range(4):
        p = root / "images" / f"t{i}.jpg"
        Image.fromarray(stain_tile(rng, 96, 96)).save(p, quality=90)
        (root / "labels" / f"t{i}.txt").write_text("1 0.5 0.5 0.3 0.3\n0 0.3 0.6 0.2 0.1\n")
        paths.append(str(p))
    (root / "train.txt").write_text("\n".join(paths[:2]) + "\n")
    (root / "valid.txt").write_text("\n".join(paths[2:]) + "\n")
    (root / "classes.names").write_text("CAA\nCored\n")
    (root / "custom.data").write_text(
        f"classes=2\ntrain={root}/train.txt\nvalid={root}/valid.txt\n"
        f"names={root}/classes.names\n")
    return root


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    # the JSONL stream alone: importing TensorBoard loads TensorFlow (~15 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _trainer(dataset, tmp_path, **kw):
    cfg = TrainConfig(**{**dict(
        data_config=str(dataset / "custom.data"), epochs=1, batch_size=2, img_size=64,
        multiscale=False, augment=False, gradient_accumulations=1,
        checkpoint_dir=str(tmp_path / "ckpts"), logdir=str(tmp_path / "logs"),
        ema_decay=0.9, evaluation_interval=0), **kw})
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    return Trainer(cfg, spec=port_mini_spec(), device="cpu")


def _step(tr, seed):
    """One train step on a random batch, straight through the Trainer's step."""
    r = np.random.RandomState(seed)
    imgs = r.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    t = np.array([[0, 1, 0.5, 0.5, 0.3, 0.3], [1, 0, 0.4, 0.6, 0.2, 0.2]], np.float32)
    tr.state, _ = tr.step_fn(tr.state, imgs, t, np.ones(2, bool), tr.rng, 64)


def _host_copy(tr):
    """The checkpoint's contents, taken synchronously from the live state."""
    st = tr.state
    opt = training._map_tensors(st.optimizer.state_dict(), lambda t: t.detach().clone())
    return {"params": weights.params_to_torch_state_dict(tr.spec, st.params),
            "ema": weights.params_to_torch_state_dict(tr.spec, st.ema),
            "optimizer": opt, "step": st.step, "seen": st.seen}


def _assert_same(got, want, where=""):
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
        assert torch.equal(torch.signbit(got), torch.signbit(want)), where
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}/{i}")
    else:
        assert got == want, where


def _gate_writes(tr, monkeypatch):
    """Hold every write of ``tr`` until the returned event is set."""
    gate = threading.Event()
    real = tr._write_checkpoint

    def held(*args):
        assert gate.wait(JOIN_TIMEOUT_S)
        real(*args)

    monkeypatch.setattr(tr, "_write_checkpoint", held)
    return gate


def test_file_is_the_state_at_dispatch(dataset, tmp_path, monkeypatch):
    tr = _trainer(dataset, tmp_path)
    _step(tr, 0)
    _step(tr, 1)
    key = next(k for k in tr.state.params if k.endswith(".weight"))
    with torch.no_grad():
        tr.state.params[key].view(-1)[0] = -0.0
    gate = _gate_writes(tr, monkeypatch)
    path = tr.save_checkpoint(7)
    assert tr._save_thread.is_alive() and not tr._save_thread.daemon
    assert not os.path.exists(path)  # returned before the write
    want = _host_copy(tr)
    _step(tr, 2)  # the live state moves on while the write waits
    assert not torch.equal(tr.state.params[key], want["params"][key])
    gate.set()
    tr.join_pending_save()
    assert tr._save_thread is None
    got = torch.load(path, weights_only=True)
    assert set(got) == set(want)
    _assert_same(got, want)
    assert torch.signbit(got["params"][key].view(-1)[0])
    assert tr._saved_epochs == [7]


def test_failed_write_raises_at_the_next_join(dataset, tmp_path):
    tr = _trainer(dataset, tmp_path)
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    tr.cfg.checkpoint_dir = str(blocker / "ckpts")  # a directory under a file: unwritable
    tr.save_checkpoint(0)  # the dispatch itself does not fail
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as info:
        tr.join_pending_save()
    assert "ckpts" in str(info.value.__cause__)  # torch.save's own error, chained
    tr.join_pending_save()  # raised once
    tr.cfg.checkpoint_dir = str(tmp_path / "ckpts")
    tr.save_checkpoint(1)
    tr.join_pending_save()
    assert tr._saved_epochs == [1] and os.path.exists(tr.checkpoint_path(1))


def test_train_joins_retains_and_files_read_back(dataset, tmp_path):
    tr = _trainer(dataset, tmp_path, epochs=3, keep_checkpoints=1)
    state = tr.train()
    assert tr._save_thread is None
    assert not [t for t in threading.enumerate() if t.name.startswith("ckpt-save-")]
    assert [sorted(w) for w in tr.epoch_walls][0] == ["batches", "epoch", "eval_s", "save_s",
                                                      "train_s"]
    # each save's parts: the dispatch's, then the worker's
    assert [w["epoch"] for w in tr.save_walls] == [0, 1, 2]
    assert all(sorted(w) == ["epoch", "host_copy_s", "join_s", "snapshot_s", "start_s",
                             "write_s"] for w in tr.save_walls)
    assert sorted(os.listdir(tr.cfg.checkpoint_dir)) == ["yolov3_ckpt_2.pt"]
    last = tr.checkpoint_path(2)
    raw = weights.load_pretrained(tr.spec, last)
    ema = weights.load_pretrained(tr.spec, last + "#ema")
    assert raw.keys() == ema.keys()
    for k in raw:
        assert torch.equal(raw[k], state.params[k].detach().float()), k
        assert torch.equal(ema[k], state.ema[k].float()), k
    tr2 = _trainer(dataset, tmp_path / "two")
    tr2.load_checkpoint(last)
    assert (tr2.state.step, tr2.state.seen) == (state.step, state.seen) == (3, 6)


def test_distributed_save_is_synchronous(dataset, tmp_path, monkeypatch):
    tr = _trainer(dataset, tmp_path)
    tr._dist, tr.nproc = object(), 2  # one rank of a two-process group
    started = []
    monkeypatch.setattr(threading.Thread, "start", lambda self: started.append(self))
    path = tr.save_checkpoint(4)
    assert not started and tr._save_thread is None
    assert list(tr.save_walls[-1]) == ["epoch", "write_s"]
    _assert_same(torch.load(path, weights_only=True), _host_copy(tr))


def test_one_process_group_save_is_overlapped(dataset, tmp_path, monkeypatch):
    tr = _trainer(dataset, tmp_path)
    tr._dist, tr.nproc = object(), 1  # a Trainer in a process group of one
    gate = _gate_writes(tr, monkeypatch)
    path = tr.save_checkpoint(4)
    thread = tr._save_thread
    assert thread is not None and thread.is_alive() and not os.path.exists(path)
    gate.set()
    tr.join_pending_save()
    assert not thread.is_alive() and tr._save_thread is None
    assert sorted(tr.save_walls[-1]) == ["epoch", "host_copy_s", "join_s", "snapshot_s",
                                         "start_s", "write_s"]
    _assert_same(torch.load(path, weights_only=True), _host_copy(tr))
