"""The port's train-mode forward (``models/darknet.py:apply(train=True)``)
and the gradients of loss∘apply against the JAX package's (``BN_FORM=
"reduce"``, NHWC, no space-to-depth stem), on the mini spec at 64².

Tolerances: float32 head maps and new BN running statistics within a
relative 1e-5 of each tensor's largest value (two libraries sum the
convolutions and the batch statistics in other orders).  In bfloat16 the
two libraries round their convolutions at the same points but sum in other
orders, so values near a bf16 rounding boundary land on neighbours and the
drift grows along the graph; each library's bf16 result lies 1.5-3.5 % (of
the largest value) from the float32 one on this spec.  So each bf16 map
must lie within ``BF16_TOL`` of JAX's bf16 map, and no further from JAX's
float32 map than ``BF16_NOISE_RATIO`` times JAX's own bf16 map does; the
new statistics (float32 reductions of the same bf16 convolutions) within
``BF16_TOL`` of JAX's.  Each parameter's float32 gradient lies within a relative
1e-4 in the 2-norm, ``‖g_port − g_jax‖ / ‖g_jax‖``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu.ops.loss import yolo_loss as jax_yolo_loss
from amyloid_yolo_tpu.parallel import steps as jax_steps
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.ops.loss import yolo_loss

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec

F32_RTOL = 1e-5
BF16_TOL = 5e-2
BF16_NOISE_RATIO = 2.0
GRAD_RTOL = 1e-4
MINI = mini_spec()


@functools.partial(jax.jit, static_argnames=("dtype",))
def _jax_train_forward(params, x, dtype):
    return jax_darknet.apply(params, MINI, x, train=True, compute_dtype=jnp.dtype(dtype),
                             bn_form="reduce", s2d_stem=False, input_layout="nhwc")


def _inputs(seed, b=2, size=64):
    r = np.random.RandomState(seed)
    x = r.rand(b, size, size, 3).astype(np.float32)
    t = np.zeros((b * 4, 6), np.float32)
    t[:, 0] = np.repeat(np.arange(b), 4)
    t[:, 1] = r.randint(0, 2, b * 4)
    t[:, 2:4] = r.rand(b * 4, 2) * 0.8 + 0.1
    t[:, 4:6] = r.rand(b * 4, 2) * 0.3 + 0.05
    mask = r.rand(b * 4) > 0.25
    return x, t, mask


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _stat_pairs(stats, ref_stats):
    """(port tensor, JAX array, name) of every new running statistic."""
    assert len(stats) == 2 * len(ref_stats)
    for key, st in ref_stats.items():
        i = key.split("_")[1]
        p = f"module_list.{i}.batch_norm_{i}"
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            yield stats[f"{p}.{ours}"], np.asarray(st[theirs]), f"{key}.{theirs}"


def _port_train_forward(params, x, dtype):
    spec = port_mini_spec()
    return darknet.apply(params_from_jax(params, spec), spec, torch.from_numpy(x),
                         compute_dtype=getattr(torch, dtype), train=True)


@pytest.fixture(scope="module")
def f32_case():
    """One float32 case through JAX, compiled once: the loss, its gradient
    with respect to the trainable parameters, the head maps and the new BN
    statistics of the train-mode forward."""
    params = jax_params_np(MINI, 1, bn_noise=True, jit=True)
    x, t, mask = _inputs(1)

    @jax.jit
    def jax_value_and_grad(train, stats):
        def loss(tp):
            maps, new_stats = jax_darknet.apply(jax_steps._merge(tp, stats), MINI,
                                                jnp.asarray(x), train=True, bn_form="reduce")
            total = jax_yolo_loss(maps, MINI, 64, jnp.asarray(t), jnp.asarray(mask))[0]
            return total, (maps, new_stats)
        return jax.value_and_grad(loss, has_aux=True)(train)

    (total, (maps, stats)), grads = jax_value_and_grad(*jax_steps._split(params))
    return params, (x, t, mask), total, maps, stats, grads


def test_train_forward_f32_maps_and_stats_match_jax(f32_case):
    params, (x, _, _), _, ref_maps, ref_stats, _ = f32_case
    maps, stats = _port_train_forward(params, x, "float32")
    assert len(maps) == len(ref_maps) == 3
    for m, r in zip(maps, ref_maps):
        assert m.dtype == torch.float32 and tuple(m.shape) == r.shape
        assert _rel(m.detach().numpy(), np.asarray(r)) <= F32_RTOL
    for got, want, name in _stat_pairs(stats, ref_stats):
        assert not got.requires_grad
        assert _rel(got.numpy(), want) <= F32_RTOL, name


@pytest.mark.parametrize("seed", [0, 1])
def test_train_forward_bf16_maps_and_stats_match_jax(seed):
    params = jax_params_np(MINI, seed, bn_noise=True, jit=True)
    x, _, _ = _inputs(seed)
    ref_maps, ref_stats = _jax_train_forward(params, jnp.asarray(x), "bfloat16")
    f32_maps, _ = _jax_train_forward(params, jnp.asarray(x), "float32")
    maps, stats = _port_train_forward(params, x, "bfloat16")
    for m, r, r32 in zip(maps, ref_maps, f32_maps):
        m, r, r32 = m.detach().numpy(), np.asarray(r), np.asarray(r32)
        assert m.dtype == np.float32 and m.shape == r.shape
        assert _rel(m, r) <= BF16_TOL
        assert _rel(m, r32) <= BF16_NOISE_RATIO * _rel(r, r32)
    for got, want, name in _stat_pairs(stats, ref_stats):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= BF16_TOL, name


def _jax_grad_to_port(grads, spec):
    """JAX trainable-gradient tree → the port's state-dict keys (OIHW)."""
    out = {}
    for i in spec.conv_indices:
        out[f"module_list.{i}.conv_{i}.weight"] = np.asarray(
            grads[f"conv_{i}"]["w"]).transpose(3, 2, 0, 1)
        if spec.layers[i].batch_normalize:
            out[f"module_list.{i}.batch_norm_{i}.weight"] = np.asarray(grads[f"bn_{i}"]["scale"])
            out[f"module_list.{i}.batch_norm_{i}.bias"] = np.asarray(grads[f"bn_{i}"]["bias"])
        else:
            out[f"module_list.{i}.conv_{i}.bias"] = np.asarray(grads[f"conv_{i}"]["b"])
    return out


def test_loss_of_apply_gradients_match_jax(f32_case):
    params, (x, t, mask), ref_total, _, _, ref_grads = f32_case
    spec = port_mini_spec()
    sd = params_from_jax(params, spec)
    keys = [k for k in sd if k.endswith((".weight", ".bias"))]
    for k in keys:
        sd[k].requires_grad_(True)
    maps, _ = darknet.apply(sd, spec, torch.from_numpy(x), train=True)
    total, _ = yolo_loss(maps, spec, 64, torch.from_numpy(t), torch.from_numpy(mask))
    grads = torch.autograd.grad(total, [sd[k] for k in keys])
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=F32_RTOL)
    want = _jax_grad_to_port(ref_grads, spec)
    assert set(want) == set(keys)
    worst = 0.0
    for k, g in zip(keys, grads):
        g, w = g.numpy(), want[k]
        assert g.shape == w.shape, k
        rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        worst = max(worst, rel)
        assert rel <= GRAD_RTOL, (k, rel)
    assert worst > 0.0  # two libraries: the sums differ somewhere
