"""The port's BN statistics as matrix products (``ops/bnstats.py``,
``darknet.apply(bn_form="matmul")``) against numpy, the JAX package's
``ops/bnstats.py`` and the reduction form (``tests/test_bnstats.py``'s
bounds).

* ``channel_sums``: float32 within rtol 1e-5 of numpy's float64 sums and of
  JAX's; bf16 input within 2e-4 (``Σx``) and 2e-3 (``Σx²``, squared in
  bf16 as the reference squares it).
* ``bn_normalize``: its value equal to the inline form's; its five
  gradients against autograd of the inline form within rtol 2e-5, atol
  1e-5.
* ``apply`` train mode on the mini spec: the matmul form against the reduce
  form and against JAX's matmul form, head maps within rtol 1e-4 / atol
  1e-5 and statistics within rtol 1e-5 / atol 1e-6; gradients against the
  reduce form's within rtol 2e-3 / atol 1e-3 (the one-pass variance
  amplifies the reordering, ``tests/test_bnstats.py:95-108``).
* ``AMYOLO_BN_FORM`` sets the module default, which ``bn_form=None`` reads
  at each call; the data-parallel step's shards sum their products.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu.ops import bnstats as jax_bnstats
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.ops import bnstats
from amyloid_yolo_tpu_torch.parallel import steps
from amyloid_yolo_tpu_torch.parallel.mesh import make_mesh

from minispec import mini_spec
from torch_port_helpers import numpy_params, port_mini_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = mini_spec()


def test_channel_sums_f32_matches_numpy_and_jax():
    x = np.random.RandomState(0).randn(4 * 13 * 13, 32).astype(np.float32)
    s, sq = bnstats.channel_sums(torch.from_numpy(x))
    assert s.dtype == sq.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), x.astype(np.float64).sum(0), rtol=1e-5)
    np.testing.assert_allclose(sq.numpy(), (x.astype(np.float64) ** 2).sum(0), rtol=1e-5)
    js, jsq = jax_bnstats.channel_sums(jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=1e-5)


def test_channel_sums_bf16_precision_bound():
    x = (np.random.RandomState(1).randn(4 * 13 * 13, 64) * 0.5 + 0.2).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    s, sq = bnstats.channel_sums(xb)
    ref = xb.to(torch.float64).numpy()
    np.testing.assert_allclose(s.numpy(), ref.sum(0), rtol=2e-4)
    np.testing.assert_allclose(sq.numpy(), (ref ** 2).sum(0), rtol=2e-3)


def test_bn_normalize_value_and_grads_match_autograd():
    r = np.random.RandomState(2)
    c = 16
    args = [torch.from_numpy(a) for a in (
        r.randn(2, c, 9, 9).astype(np.float32), r.randn(c).astype(np.float32) * 0.1,
        r.rand(c).astype(np.float32) + 0.5, r.rand(c).astype(np.float32) + 0.5,
        r.randn(c).astype(np.float32) * 0.1)]

    def inline(x, mean, inv, gamma, beta):
        return ((x.to(torch.float32) - mean[None, :, None, None])
                * (gamma * inv)[None, :, None, None] + beta[None, :, None, None]).to(x.dtype)

    assert torch.equal(bnstats.bn_normalize(*args), inline(*args))
    weight = torch.arange(c, dtype=torch.float32)[None, :, None, None]

    def grads(fn):
        leaves = [a.clone().requires_grad_(True) for a in args]
        (torch.sin(fn(*leaves)) * weight).sum().backward()
        return [a.grad for a in leaves]

    for got, want, name in zip(grads(bnstats.bn_normalize), grads(inline),
                               ["x", "mean", "inv", "gamma", "beta"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=1e-5,
                                   err_msg=name)


@pytest.fixture(scope="module")
def model():
    spec = port_mini_spec()
    params = numpy_params(MINI, 0)
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    return spec, params, params_from_jax(params, spec), x


def test_apply_matmul_form_matches_reduce_and_jax(model):
    spec, params, sd, x = model
    xt = torch.from_numpy(x)
    maps_r, stats_r = darknet.apply(sd, spec, xt, train=True, bn_form="reduce")
    maps_m, stats_m = darknet.apply(sd, spec, xt, train=True, bn_form="matmul")
    want_maps, want_stats = jax.jit(lambda p, v: jax_darknet.apply(
        p, MINI, v, train=True, bn_form="matmul"))(params, jnp.asarray(x))
    for a, b, w in zip(maps_m, maps_r, want_maps):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    for k in stats_r:
        np.testing.assert_allclose(stats_m[k].numpy(), stats_r[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for key, st in want_stats.items():
        i = key.split("_")[1]
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                stats_m[f"module_list.{i}.batch_norm_{i}.{ours}"].numpy(),
                np.asarray(st[theirs]), rtol=1e-5, atol=1e-6, err_msg=f"{key}.{theirs}")


def test_apply_matmul_form_grads_match_reduce(model):
    spec, _, sd, x = model
    keys = steps.trainable_keys(sd)

    def grads(form):
        p = {k: (v.clone().requires_grad_(True) if k in keys else v) for k, v in sd.items()}
        maps, _ = darknet.apply(p, spec, torch.from_numpy(x), train=True, bn_form=form)
        return torch.autograd.grad(sum((m ** 2).sum() for m in maps), [p[k] for k in keys])

    for k, a, b in zip(keys, grads("matmul"), grads("reduce")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=1e-3, err_msg=k)


def test_bn_form_default_and_environment(model, monkeypatch):
    spec, _, sd, x = model
    xt = torch.from_numpy(x[:1])
    monkeypatch.setattr(darknet, "BN_FORM", "matmul")
    got, _ = darknet.apply(sd, spec, xt, train=True)
    want, _ = darknet.apply(sd, spec, xt, train=True, bn_form="matmul")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    proc = subprocess.run(
        [sys.executable, "-c", "from amyloid_yolo_tpu_torch.models import darknet; "
                               "print(darknet.BN_FORM)"],
        cwd=REPO, env={**os.environ, "AMYOLO_BN_FORM": "matmul"}, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "matmul", proc.stderr


def test_matmul_form_under_the_data_parallel_step(model, monkeypatch):
    """The shards of the in-process data-parallel step hand their products'
    sums to the reducer: loss, statistics and gradients those of one device."""
    spec, _, sd, x = model
    monkeypatch.setattr(darknet, "BN_FORM", "matmul")
    u8 = (x * 255).astype(np.uint8)
    t = np.zeros((4, 6), np.float32)
    t[0] = [0, 0, 0.5, 0.5, 0.2, 0.3]
    t[1] = [1, 1, 0.3, 0.6, 0.1, 0.2]
    mask = np.arange(4) < 2
    grad_step = steps.make_grad_step(spec)
    one = grad_step(sd, u8, t, mask, 64)
    two = grad_step(sd, u8, t, mask, 64, shards=steps.MeshShards(make_mesh(devices=["cpu"] * 2)))
    np.testing.assert_allclose(float(two[0]), float(one[0]), rtol=1e-5)
    for k in one[2]:
        np.testing.assert_allclose(two[2][k].numpy(), one[2][k].numpy(), rtol=1e-5, atol=1e-6)
    for k in one[1]:
        a, b = two[1][k].numpy(), one[1][k].numpy()
        assert np.linalg.norm(a - b) <= 1e-4 * max(np.linalg.norm(b), 1e-12), k
