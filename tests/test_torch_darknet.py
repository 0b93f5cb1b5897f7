"""Port executor (``apply_folded``) against the JAX package's.

f32: the head maps agree to 1e-4.  bf16: the reference is JAX's
``apply_folded`` with every residual unit in its Pallas kernel
(``pack_pallas_blocks`` at ``min_ch=0``, interpret mode) — the port's
contract, K2 on all units.  Both round to bf16 at the same points, but sum
in another order, so single values may land on the neighbouring bf16 and
the drift grows along the graph: maps are held to ``BF16_TOL`` × the
largest value of each map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.graphspec import yolov3_spec as jax_yolov3_spec
from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.kernels.conv_block import fused_residual_block
from amyloid_yolo_tpu_torch.models import darknet as port_darknet

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec

F32_TOL = 1e-4
BF16_TOL = 2e-2


def _setup(port_spec, ref_spec, seed):
    params = jax_params_np(ref_spec, seed, bn_noise=True)
    ref_folded = jax_darknet.fold_batchnorm(params, ref_spec)
    folded = port_darknet.fold_batchnorm(params_from_jax(params, port_spec), port_spec)
    return ref_folded, folded


def _image(b, size, seed):
    return np.random.RandomState(seed).rand(b, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("with_packs", [False, True])
def test_mini_head_maps_f32(with_packs):
    port_spec, ref_spec = port_mini_spec(), mini_spec()
    ref_folded, folded = _setup(port_spec, ref_spec, 3)
    x = _image(2, 64, 0)
    want = jax_darknet.apply_folded(ref_folded, ref_spec, jnp.asarray(x),
                                    compute_dtype=jnp.float32)
    packs = (port_darknet.pack_residual_blocks(folded, port_spec, torch.float32)
             if with_packs else None)
    got = port_darknet.apply_folded(folded, port_spec, torch.from_numpy(x),
                                    compute_dtype=torch.float32, packs=packs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL)


def test_mini_head_maps_bf16_against_pallas_composition():
    port_spec, ref_spec = port_mini_spec(), mini_spec()
    ref_folded, folded = _setup(port_spec, ref_spec, 4)
    x = _image(2, 64, 1)
    jax_packs = jax_darknet.pack_pallas_blocks(ref_folded, ref_spec, min_ch=0)
    assert len(jax_packs) == 4
    want = jax_darknet.apply_folded(ref_folded, ref_spec, jnp.asarray(x),
                                    compute_dtype=jnp.bfloat16, pallas_packs=jax_packs,
                                    pallas_interpret=True)
    packs = port_darknet.pack_residual_blocks(folded, port_spec, torch.bfloat16)
    got = port_darknet.apply_folded(folded, port_spec, torch.from_numpy(x),
                                    compute_dtype=torch.bfloat16, packs=packs)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - w).max() <= BF16_TOL * np.abs(w).max()
    assert fused_residual_block.launches == 0


def test_yolov3_small_input_f32():
    """Full YOLOv3 graph (75 convs, 23 residual units) at 64², B=1; JAX runs
    eagerly, op by op."""
    port_spec, ref_spec = yolov3_spec(num_classes=2, img_size=64), jax_yolov3_spec(
        num_classes=2, img_size=64)
    ref_folded, folded = _setup(port_spec, ref_spec, 0)
    x = _image(1, 64, 2)
    want = jax_darknet.apply_folded(ref_folded, ref_spec, jnp.asarray(x),
                                    compute_dtype=jnp.float32)
    packs = port_darknet.pack_residual_blocks(folded, port_spec, torch.float32)
    assert len(packs) == 23
    got = port_darknet.apply_folded(folded, port_spec, torch.from_numpy(x),
                                    compute_dtype=torch.float32, packs=packs)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL, atol=F32_TOL * np.abs(w).max())


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_unfolded_apply_matches_jax_apply(dtype, tol):
    """Eval-mode ``apply`` over unfolded params (BN from running statistics)
    against JAX ``apply(train=False)``.  f32: within 1e-4 of the largest
    value; bf16: both round at the same points (measured identical on this
    model; held to ``BF16_TOL`` like the folded path)."""
    port_spec, ref_spec = port_mini_spec(), mini_spec()
    params = jax_params_np(ref_spec, 6, bn_noise=True)
    x = _image(2, 64, 3)
    want, stats = jax_darknet.apply(params, ref_spec, jnp.asarray(x),
                                    compute_dtype=getattr(jnp, dtype))
    assert stats is None
    got = port_darknet.apply(params_from_jax(params, port_spec), port_spec,
                             torch.from_numpy(x), compute_dtype=getattr(torch, dtype))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - w).max() <= tol * np.abs(w).max()


def test_maxpool_matches_reference():
    """MaxPool layers (tiny-YOLO cfgs): the zero-padded k2/s1 form and the
    symmetric -inf form."""
    x = np.random.RandomState(0).randn(2, 9, 9, 3).astype(np.float32) - 1.0
    for k, s in ((2, 1), (2, 2), (3, 1)):
        want = np.asarray(jax_darknet._maxpool(jnp.asarray(x), k, s))
        got = port_darknet._maxpool(torch.from_numpy(x).permute(0, 3, 1, 2), k, s)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
