"""The port's multi-process data parallelism (``parallel/distributed.py``),
the counterpart of ``tests/test_distributed.py``.

Two real processes (``torch_mp_child.py``) join a gloo process group over
loopback on the CPU and run one global train step on their halves of
``test_torch_parallel.py``'s batch; the parent holds the result against
the one-process step at the global batch and the JAX data-parallel step.
Then ``Trainer(distributed=True)`` in two processes against the
one-process ``Trainer(data_parallel=2)``.  Each child has a 120 s timeout
and its process group a 60 s collective timeout.

Tolerances are ``test_torch_parallel.py``'s (loss 1e-5; parameters after
one apply rtol 1e-4 / atol 2.05·lr); after the Trainer's four applies the
parameters within rtol 1e-3 / atol 4 × 2.05·lr, as ``test_distributed.py``
holds its two-process Trainer.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.parallel import steps as jax_steps
from amyloid_yolo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from amyloid_yolo_tpu_torch.graphspec import emit_cfg
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.parallel import distributed as dist_mod
from amyloid_yolo_tpu_torch.parallel import steps
from amyloid_yolo_tpu_torch.parallel.mesh import Mesh, make_mesh
from amyloid_yolo_tpu_torch.training import Trainer, TrainConfig

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LR = 1e-3
B, CAP = 8, 4
CHILD_TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_children(mode: str, work: str, world: int = 2):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mp_child.py"), mode,
                               str(r), str(world), str(port), work],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0] or "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "MP_OK" in log, f"rank {r} rc={p.returncode}\n{log[-4000:]}"
    return logs


def _batch():
    r = np.random.RandomState(5)
    imgs = r.randint(0, 255, (B, 64, 64, 3)).astype(np.uint8)
    targets = np.zeros((B * CAP, 6), np.float32)
    mask = np.zeros((B * CAP,), bool)
    for b in range(B):
        targets[b * CAP] = [b, b % 2, 0.4 + 0.05 * b / B, 0.5, 0.2, 0.25]
        mask[b * CAP] = True
    return imgs, targets, mask


@pytest.fixture(scope="module")
def mp_step(tmp_path_factory):
    """The two-process step, once, without and with augmentation."""
    work = str(tmp_path_factory.mktemp("mp_step"))
    params = jax_params_np(mini_spec(), 0, jit=True)
    imgs, targets, mask = _batch()
    with open(os.path.join(work, "mini.cfg"), "w") as fh:
        fh.write(emit_cfg(port_mini_spec()))
    torch.save({"params": params_from_jax(params, port_mini_spec()), "imgs": imgs,
                "targets": targets, "mask": mask, "cap": CAP, "lr": LR},
               os.path.join(work, "setup.pt"))
    logs = _run_children("step", work)
    losses = [{line.split()[1]: float(line.split()[2]) for line in log.splitlines()
               if line.startswith("MP_LOSS ")} for log in logs]
    return params, (imgs, targets, mask), losses, work


def _one_process(params, batch, augment):
    opt = steps.make_optimizer(LR)
    state = steps.init_train_state(params_from_jax(params, port_mini_spec()), opt,
                                   device="cpu")
    step = steps.make_train_step(port_mini_spec(), opt, augment=augment)
    state, m = step(state, *batch, torch.Generator().manual_seed(3), 64)
    return float(m["loss"]), state.params


def _assert_params_close(got, want, rtol=1e-4, atol=2.05 * LR):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].float().numpy(), w.detach().float().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("augment", [False, True])
def test_two_process_step_matches_one_process(mp_step, augment):
    params, batch, losses, work = mp_step
    key = str(augment)
    assert losses[0][key] == losses[1][key]  # every rank holds the same global loss
    loss, want = _one_process(params, batch, augment)
    np.testing.assert_allclose(losses[0][key], loss, rtol=1e-5)
    _assert_params_close(torch.load(os.path.join(work, f"params_{augment}.pt")), want)


def test_two_process_step_matches_jax(mp_step):
    params, batch, losses, work = mp_step
    opt = jax_steps.make_optimizer(LR)
    jstep = jax_steps.shard_train_step(
        jax_steps.make_train_step(mini_spec(), opt, augment=False, image_layout="nhwc"),
        jax_make_mesh(4))
    jstate = jax_steps.init_train_state(jax.tree.map(jnp.asarray, params), opt)
    jstate, jm = jstep(jstate, *(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0), 64)
    np.testing.assert_allclose(losses[0]["False"], float(jm["loss"]), rtol=1e-5)
    want = {k: torch.as_tensor(np.asarray(v)) for k, v in params_from_jax(
        jax.tree.map(np.asarray, jstate.params), port_mini_spec()).items()}
    _assert_params_close(torch.load(os.path.join(work, "params_False.pt")), want)


def test_process_shard_partitions_evenly():
    items = list(range(11))
    shards = [dist_mod.process_shard(items, pid, 4) for pid in range(4)]
    # the uneven tail (11 % 4 = 3 items) is dropped so processes stay in lockstep
    assert all(len(s) == 2 for s in shards)
    assert sorted(x for s in shards for x in s) == list(range(8))
    assert dist_mod.process_shard(items, 0, 1) == items
    assert dist_mod.process_shard(items) == items  # no process group: one process


def test_local_batch_size_validates():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert dist_mod.local_batch_size(8, mesh) == 8  # one process: every entry is local
    with pytest.raises(ValueError, match="divide"):
        dist_mod.local_batch_size(6, mesh)
    ranks = Mesh(mesh.devices, local=(1,))  # the global mesh as rank 1 sees it
    assert dist_mod.local_batch_size(8, ranks) == 2
    with pytest.raises(ValueError, match="one local device"):
        dist_mod.ProcessShards(mesh)


def _write_tiny_dataset(root: str, n_train: int = 8, n_valid: int = 2) -> str:
    """64² PNG tiles (lossless, so every process decodes the same pixels)
    with YOLO labels and a ``.data`` file (``test_distributed.py``'s)."""
    from PIL import Image

    rng = np.random.RandomState(7)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    paths = []
    for i in range(n_train + n_valid):
        p = os.path.join(root, "images", f"t{i}.png")
        Image.fromarray(rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)).save(p)
        with open(os.path.join(root, "labels", f"t{i}.txt"), "w") as fh:
            fh.write(f"{i % 2} 0.5 0.5 0.25 0.25\n0 0.3 0.3 0.2 0.2\n")
        paths.append(p)
    with open(os.path.join(root, "train.txt"), "w") as fh:
        fh.write("\n".join(paths[:n_train]) + "\n")
    with open(os.path.join(root, "valid.txt"), "w") as fh:
        fh.write("\n".join(paths[n_train:]) + "\n")
    with open(os.path.join(root, "classes.names"), "w") as fh:
        fh.write("CAA\nCored\n")
    data = os.path.join(root, "custom.data")
    with open(data, "w") as fh:
        fh.write(f"classes=2\ntrain={root}/train.txt\nvalid={root}/valid.txt\n"
                 f"names={root}/classes.names\n")
    return data


def _logged_losses(logdir: str):
    events = sorted(glob.glob(os.path.join(logdir, "*", "events.jsonl")))
    assert events, logdir
    recs = [json.loads(line) for f in events for line in open(f)]
    return [(r["epoch"], r["batch"], r["loss"]) for r in recs if "loss" in r]


def test_two_process_trainer_matches_data_parallel(tmp_path):
    """``Trainer(distributed=True)`` in two processes (global batch 4, two
    epochs with evaluation) against ``Trainer(data_parallel=2)`` in one:
    the same logged losses and final checkpoint; only rank 0 prints, logs
    and saves."""
    work = str(tmp_path)
    data = _write_tiny_dataset(os.path.join(work, "data"))
    with open(os.path.join(work, "mini.cfg"), "w") as fh:
        fh.write(emit_cfg(port_mini_spec()))
    logs = _run_children("trainer", work)
    assert "loss=" in logs[0] and "loss=" not in logs[1]
    assert "Best mAP" in logs[0] and "Best mAP" not in logs[1]
    assert not os.path.exists(os.path.join(work, "rank1"))
    ckpts = sorted(os.listdir(os.path.join(work, "rank0", "ckpt")))
    assert ckpts == ["yolov3_ckpt_0.pt", "yolov3_ckpt_1.pt"], ckpts

    ref = os.path.join(work, "ref")
    cfg = TrainConfig(data_config=data, epochs=2, batch_size=4, gradient_accumulations=1,
                      img_size=64, multiscale=False, augment=False, evaluation_interval=1,
                      checkpoint_dir=os.path.join(ref, "ckpt"), logdir=os.path.join(ref, "logs"),
                      seed=0, data_parallel=2)
    Trainer(cfg, spec=port_mini_spec(), device="cpu").train()
    mp_losses = _logged_losses(os.path.join(work, "rank0", "logs"))
    dp_losses = _logged_losses(os.path.join(ref, "logs"))
    assert len(mp_losses) == len(dp_losses) == 2  # batch 0 of each epoch
    for (e1, b1, l1), (e2, b2, l2) in zip(mp_losses, dp_losses):
        assert (e1, b1) == (e2, b2)
        np.testing.assert_allclose(l1, l2, rtol=1e-5)
    got = torch.load(os.path.join(work, "rank0", "ckpt", "yolov3_ckpt_1.pt"))
    want = torch.load(os.path.join(ref, "ckpt", "yolov3_ckpt_1.pt"))
    assert (got["step"], got["seen"]) == (want["step"], want["seen"]) == (4, 16)
    _assert_params_close(got["params"], want["params"], rtol=1e-3, atol=4 * 2.05 * LR)
