"""The port's data-parallel train step (``parallel/steps.py:shard_train_step``,
``MeshShards``) against its one-device step and the JAX package's
``shard_train_step`` (the counterpart of ``tests/test_parallel.py``).

The JAX data-parallel step is one global program: BN statistics over the
global batch, the loss's masked means over global counts.  The port's
shards sum their partial statistics through the ``reducer`` of
``darknet.apply`` and ``ops.loss``.  Mini spec, 8 images of 64², one
labelled box each (``test_parallel.py``'s set-up), float32, a mesh of 2 or
4 CPU entries.

Tolerances are ``test_parallel.py``'s: losses within a relative 1e-5;
parameters after one Adam apply within rtol 1e-4 / atol 2.05·lr (Adam's
first update is about ``−lr·sign(g)``, so reordering noise on a gradient
element near 0 can move that weight by up to 2·lr); raw gradients within
2e-2 of each tensor's largest value.  BN running statistics within a
relative 1e-4.  Without a reducer the arithmetic of the one-device step is
the one it had before data parallelism (bit for bit, checked below on the
parts the reducer touches).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amyloid_yolo_tpu.parallel import steps as jax_steps
from amyloid_yolo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from amyloid_yolo_tpu_torch.graphspec import NetInfo, _Builder, _finish
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.ops import loss as loss_mod
from amyloid_yolo_tpu_torch.parallel import steps
from amyloid_yolo_tpu_torch.parallel import mesh as mesh_mod
from amyloid_yolo_tpu_torch.parallel.mesh import make_mesh

from minispec import mini_spec
from torch_port_helpers import copy_always, jax_params_np, port_mini_spec

LR = 1e-3
MINI = mini_spec()
B, CAP = 8, 4


@pytest.fixture(scope="module")
def setup():
    params = jax_params_np(MINI, 0, jit=True)
    r = np.random.RandomState(5)
    imgs = r.randint(0, 255, (B, 64, 64, 3)).astype(np.uint8)
    targets = np.zeros((B * CAP, 6), np.float32)
    mask = np.zeros((B * CAP,), bool)
    for b in range(B):
        targets[b * CAP] = [b, b % 2, 0.4 + 0.05 * b / B, 0.5, 0.2, 0.25]
        mask[b * CAP] = True
    return params, imgs, targets, mask


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _port_step(params, batch, n, augment=False, seed=3):
    """One port train step on one device (``n`` = 1) or over ``n`` shards:
    ``(loss, metrics, params after)``."""
    opt = steps.make_optimizer(LR)
    state = steps.init_train_state(params_from_jax(params, port_mini_spec()), opt,
                                   device="cpu")
    step = steps.make_train_step(port_mini_spec(), opt, augment=augment)
    if n > 1:
        step = steps.shard_train_step(step, _cpu_mesh(n))
    state, m = step(state, *batch, torch.Generator().manual_seed(seed), 64)
    return float(m["loss"]), {k: float(v) for k, v in m.items()}, \
        {k: v.detach().clone() for k, v in state.params.items()}


def _jax_as_port(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in
            params_from_jax(jax.tree.map(np.asarray, tree), port_mini_spec()).items()}


def _assert_params_close(got, want):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got[k].float()
        if k.endswith(("running_mean", "running_var")):
            rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            assert rel <= 1e-4, (k, rel)
        else:
            np.testing.assert_allclose(g.numpy(), w.float().numpy(), rtol=1e-4,
                                       atol=2.05 * LR, err_msg=k)


@pytest.fixture(scope="module")
def one_device(setup):
    params, *batch = setup
    return _port_step(params, batch, 1)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_equals_one_device_and_jax(setup, one_device, n):
    params, *batch = setup
    loss, metrics, after = _port_step(params, batch, n)
    loss1, metrics1, after1 = one_device
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    assert set(metrics) == set(metrics1)
    for k in metrics1:  # every metric is the global batch's
        np.testing.assert_allclose(metrics[k], metrics1[k], rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_params_close(after, after1)

    opt = jax_steps.make_optimizer(LR)
    jstep = jax_steps.shard_train_step(
        jax_steps.make_train_step(MINI, opt, augment=False, image_layout="nhwc"),
        jax_make_mesh(n))
    jstate = jax_steps.init_train_state(jax.tree.map(jnp.asarray, params), opt)
    jstate, jm = jstep(jstate, *(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0), 64)
    np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-5)
    _assert_params_close(after, _jax_as_port(jstate.params))


def _to_port_grads(tree):
    """A JAX gradient tree → the port's state-dict keys (OIHW)."""
    out = {}
    for i in MINI.conv_indices:
        out[f"module_list.{i}.conv_{i}.weight"] = np.asarray(
            tree[f"conv_{i}"]["w"]).transpose(3, 2, 0, 1)
        if MINI.layers[i].batch_normalize:
            out[f"module_list.{i}.batch_norm_{i}.weight"] = np.asarray(tree[f"bn_{i}"]["scale"])
            out[f"module_list.{i}.batch_norm_{i}.bias"] = np.asarray(tree[f"bn_{i}"]["bias"])
        else:
            out[f"module_list.{i}.conv_{i}.bias"] = np.asarray(tree[f"conv_{i}"]["b"])
    return out


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        a, b = np.asarray(w, np.float32), got[k].numpy()
        scale = max(float(np.abs(a).max()), 1e-12)
        assert np.abs(a - b).max() < 2e-2 * scale, k


@pytest.mark.parametrize("n", [2, 4])
def test_dp_grads_equal_one_device_and_jax(setup, n):
    """The sharp form: raw gradients over the shards against the one-device
    gradients and the JAX ``make_grad_step``'s, to reordering noise (the
    failures this guards against, per-shard BN or means, are far larger)."""
    params, *batch = setup
    port = params_from_jax(params, port_mini_spec())
    gstep = steps.make_grad_step(port_mini_spec())
    loss1, g1, stats1 = gstep(port, *batch, 64)
    loss_n, g_n, stats_n = gstep(port, *batch, 64, shards=steps.MeshShards(_cpu_mesh(n)))
    np.testing.assert_allclose(float(loss_n), float(loss1), rtol=1e-5)
    _assert_grads_close({k: v for k, v in g_n.items()}, {k: v.numpy() for k, v in g1.items()})
    for k, v in stats1.items():
        rel = float((stats_n[k] - v).abs().max() / v.abs().max())
        assert rel <= 1e-4, (k, rel)

    jgrad = jax_steps.make_grad_step(MINI, augment=False)
    jloss, jg, _ = jgrad(jax.tree.map(jnp.asarray, params),
                         *(jnp.asarray(a) for a in batch), 64)
    np.testing.assert_allclose(float(loss_n), float(jloss), rtol=1e-5)
    _assert_grads_close(g_n, _to_port_grads(jg))


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_through_copies_equals_one_device(setup, one_device, monkeypatch, n):
    """With copies between the devices, as on several cards, each shard
    runs on its own copy of the parameters and the sums go to the first
    device and back: the gradients still reach the master parameters
    through the copies, and the step is the one-device step."""
    params, *batch = setup
    moved = copy_always(monkeypatch, mesh_mod, steps)
    loss, metrics, after = _port_step(params, batch, n)
    n_params = len(params_from_jax(params, port_mini_spec()))
    assert len(moved) > n * n_params  # every shard's parameters, then the sums
    loss1, metrics1, after1 = one_device
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    for k in metrics1:
        np.testing.assert_allclose(metrics[k], metrics1[k], rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_params_close(after, after1)

    port = params_from_jax(params, port_mini_spec())
    gstep = steps.make_grad_step(port_mini_spec())
    _, g1, _ = gstep(port, *batch, 64)
    _, g_n, _ = gstep(port, *batch, 64, shards=steps.MeshShards(_cpu_mesh(n)))
    _assert_grads_close(g_n, {k: v.numpy() for k, v in g1.items()})


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_with_augment_equals_one_device(setup, n):
    """Augmentation draws for the global batch from the one generator and
    each shard takes its rows, so the shards see the one-device step's
    images and boxes."""
    params, *batch = setup
    loss1, _, after1 = _port_step(params, batch, 1, augment=True)
    loss, _, after = _port_step(params, batch, n, augment=True)
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    _assert_params_close(after, after1)


@pytest.mark.parametrize("row0", [0, 4])
def test_shard_batch_has_shard_local_batch_idx(setup, row0):
    _, imgs, targets, mask = setup
    images, t, m = steps.shard_batch(imgs[row0:row0 + 4], targets, mask, row0, 64,
                                     torch.device("cpu"))
    assert images.shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(t[:, 0].numpy(), targets[:, 0] - row0)
    np.testing.assert_array_equal(t[:, 1:].numpy(), targets[:, 1:])
    mine = (targets[:, 0] >= row0) & (targets[:, 0] < row0 + 4)
    np.testing.assert_array_equal(m.numpy(), mask & mine)


def test_mesh_shards_pass_each_shard_its_local_targets(setup, monkeypatch):
    params, *batch = setup
    seen = []
    real = steps._loss

    def spy(p, spec, images, targets, target_mask, *a, **k):
        seen.append((images.shape[0], targets[target_mask][:, 0].tolist()))
        return real(p, spec, images, targets, target_mask, *a, **k)

    monkeypatch.setattr(steps, "_loss", spy)
    gstep = steps.make_grad_step(port_mini_spec())
    gstep(params_from_jax(params, port_mini_spec()), *batch, 64,
          shards=steps.MeshShards(_cpu_mesh(4)))
    assert sorted(seen) == [(2, [0.0, 1.0])] * 4


def test_a_failing_shard_raises_its_own_error(setup, monkeypatch):
    params, *batch = setup

    def boom(*a, **k):
        raise RuntimeError("shard failed")

    monkeypatch.setattr(steps, "shard_batch", boom)
    with pytest.raises(RuntimeError, match="shard failed"):
        steps.make_grad_step(port_mini_spec())(params_from_jax(params, port_mini_spec()),
                                               *batch, 64,
                                               shards=steps.MeshShards(_cpu_mesh(2)))


def test_shard_reducer_sums_under_thread_switches():
    """16 shard threads (more than the cores), a 1 µs switch interval, 200
    reductions each: every reduction hands every shard the sum of that
    round's inputs (a round that read another's would break it)."""
    n, rounds = 16, 200
    red = steps._ShardReducer([torch.device("cpu")] * n, timeout=60)
    bad = []

    def shard(k):
        view = red.view(k)
        for i in range(rounds):
            got, = view(torch.tensor([float(k + i)]))
            if float(got) != sum(j + i for j in range(n)):
                bad.append((k, i, float(got)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        steps._run_threads(shard, n, red.barrier)
    finally:
        sys.setswitchinterval(old)
    assert not bad


# -- without a reducer: the one-device arithmetic as before -----------------

def _bn_spec():
    b = _Builder(NetInfo(width=16, height=16))
    b.conv(4, 3)
    return _finish(b.net, b.layers, b.out_channels)


@pytest.mark.parametrize("part", ["bn", "masked_mean", "ratio"])
def test_no_reducer_is_the_one_device_arithmetic(part):
    """The expressions the reducer touches, without one, equal bit for bit
    the one-device formulas: BN's one-pass batch statistics (mean and
    ``E[x²]`` as ``.mean``) and the masked means and ratios of the loss.
    With a one-shard reducer the results agree to rounding."""
    g = torch.Generator().manual_seed(0)

    class One:
        world = 1

        def __call__(self, *t):
            return t

    if part == "bn":
        spec = _bn_spec()
        p = darknet.init_params(g, spec)
        x = torch.rand(2, 16, 16, 3, generator=g)
        _, stats = darknet.apply(p, spec, x, train=True)
        out = F.conv2d(x.permute(0, 3, 1, 2), p["module_list.0.conv_0.weight"], padding=1)
        n = out.shape[0] * out.shape[2] * out.shape[3]
        mean = out.mean(dim=(0, 2, 3))
        var = torch.clamp((out * out).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        m = darknet.BN_MOMENTUM
        want = {"module_list.0.batch_norm_0.running_mean":
                (1 - m) * p["module_list.0.batch_norm_0.running_mean"] + m * mean,
                "module_list.0.batch_norm_0.running_var":
                (1 - m) * p["module_list.0.batch_norm_0.running_var"]
                + m * (var * (n / max(n - 1, 1)))}
        assert set(stats) == set(want)
        for k in want:
            assert torch.equal(stats[k], want[k]), k
        _, reduced = darknet.apply(p, spec, x, train=True, reducer=One())
        for k in want:
            torch.testing.assert_close(reduced[k], want[k], rtol=1e-6, atol=1e-7)
        return
    x = torch.rand(5, 7, generator=g)
    mask = (torch.rand(5, 7, generator=g) > 0.5).to(torch.float32)
    if part == "masked_mean":
        cnt = mask.sum()
        want = torch.where(cnt > 0, (x * mask).sum() / cnt.clamp(min=1), 0.0)
        got, one = loss_mod._masked_mean(x, mask), loss_mod._masked_mean(x, mask, One())
    else:
        want = (x * mask).sum() / (mask.sum() + 1e-16)
        got = loss_mod._ratio((x * mask).sum(), mask.sum())
        one = loss_mod._ratio((x * mask).sum(), mask.sum(), One())
    assert torch.equal(got, want) and torch.equal(one, want)
