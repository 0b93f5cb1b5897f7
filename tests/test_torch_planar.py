"""The port's planar image layout (``image_layout="planar"``: contiguous
(B, 3, H, W) images in the train step) against the JAX package's planar
path (``ops/preprocess.py:36-55``, ``ops/augment.py:238-406``,
``parallel/steps.py:150-190``) and against the port's NHWC path.

* The planar helpers, op by op against the reference's run eagerly: the
  resize, the shear passes, the 3-shear affine, the HSV planes and the s2d
  feed bit-exact; the sharpen within 2e-6 (its taps in another order,
  ``tests/test_augment_planar.py:72-78``).
* ``augment_batch(layout="planar")``: against the NHWC form on the same
  draws within 1e-5, targets and mask equal
  (``tests/test_augment_planar.py:89-106``); against the reference's
  compiled planar policy on its own draws within ``test_torch_augment.py``'s
  ``POLICY_TOL``.
* ``darknet.apply(input_layout="planar")``: equal to the NHWC input, with
  and without the s2d stem; one augmented train step planar against NHWC:
  the losses within 1e-4 (``tests/test_augment_planar.py:109-130``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu.ops import augment as jax_augment
from amyloid_yolo_tpu.ops.preprocess import resize_nearest as jax_resize_nearest
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.ops import augment
from amyloid_yolo_tpu_torch.ops.preprocess import resize_nearest
from amyloid_yolo_tpu_torch.parallel import steps

from minispec import mini_spec
from test_torch_augment import POLICY_TOL, _batch, _jax_draws
from torch_port_helpers import numpy_params, port_mini_spec

B = 3


def _planar(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def imgs():
    return np.random.RandomState(0).rand(B, 64, 64, 3).astype(np.float32)


def test_resize_nearest_planar_bitexact():
    u8 = np.random.RandomState(1).randint(0, 256, (2, 100, 100, 3), dtype=np.uint8)
    want = np.asarray(jax_resize_nearest(jnp.asarray(_planar(u8)), 64, layout="planar"))
    got = resize_nearest(torch.from_numpy(_planar(u8)), 64, layout="planar")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _planar(resize_nearest(torch.from_numpy(u8),
                                                                      64).numpy()))


@pytest.mark.parametrize("group", [1, 16])
def test_shear_rows_planar_bitexact(imgs, group):
    shift = np.stack([np.linspace(-3.3, 2.7, 64), np.linspace(5.1, -1.2, 64),
                      np.linspace(0.4, 0.6, 64)]).astype(np.float32)
    want = np.stack([np.asarray(jax_augment._shear_rows_planar(
        jnp.asarray(_planar(imgs)[i]), jnp.asarray(shift[i]), group=group)) for i in range(B)])
    got = augment._shear_rows(torch.from_numpy(_planar(imgs)), torch.from_numpy(shift), True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_affine_shear3_planar_bitexact(imgs):
    d = _jax_draws(jax.random.PRNGKey(3))
    ang, tr = d["angle"].numpy(), d["trans"].numpy()
    want = np.stack([np.asarray(jax_augment._affine_shear3_planar(
        jnp.asarray(_planar(imgs)[i]), jnp.asarray(ang[i]), jnp.asarray(tr[i, 0]),
        jnp.asarray(tr[i, 1]))) for i in range(B)])
    got = augment._affine_shear3(torch.from_numpy(_planar(imgs)), d["angle"], d["trans"][:, 0],
                                 d["trans"][:, 1], planar=True)
    np.testing.assert_array_equal(got.numpy(), want)
    nhwc = augment._affine_shear3(torch.from_numpy(imgs), d["angle"], d["trans"][:, 0],
                                  d["trans"][:, 1])
    np.testing.assert_array_equal(got.numpy(), _planar(nhwc.numpy()))


def test_sharpen_planar_within_2e6(imgs):
    alpha = np.array([0.0, 0.15, 0.2], np.float32)
    want = np.stack([np.asarray(jax_augment._sharpen_planar(jnp.asarray(_planar(imgs)[i]),
                                                            jnp.asarray(alpha[i])))
                     for i in range(B)])
    got = augment._sharpen(torch.from_numpy(_planar(imgs)), torch.from_numpy(alpha), True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    nhwc = augment._sharpen(torch.from_numpy(imgs), torch.from_numpy(alpha))
    np.testing.assert_array_equal(got.numpy(), _planar(nhwc.numpy()))


def test_hsv_planes_bitexact(imgs):
    p = _planar(imgs)[0]
    hu = np.float32(0.07)
    h, s, v = jax_augment._rgb_to_hsv_planes(*(jnp.asarray(c) for c in p))
    want = np.stack([np.asarray(c) for c in
                     jax_augment._hsv_to_rgb_planes((h + hu) % 1.0, s, v)])
    gh, gs, gv = augment._rgb_to_hsv(*torch.from_numpy(p).unbind(0))
    got = torch.stack(augment._hsv_to_rgb(torch.remainder(gh + hu, 1.0), gs, gv))
    np.testing.assert_array_equal(got.numpy(), want)


def test_space_to_depth_planar_bitexact(imgs):
    want = np.asarray(jax_darknet._space_to_depth_planar(jnp.asarray(_planar(imgs))))
    got = darknet._space_to_depth_planar(torch.from_numpy(_planar(imgs)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  darknet._space_to_depth(torch.from_numpy(imgs)).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_batch_planar_matches_nhwc_and_jax(seed):
    img, t, mask = _batch(seed)
    key = jax.random.PRNGKey(seed)
    draws = _jax_draws(key)
    args = (torch.from_numpy(t), torch.from_numpy(mask), draws)
    n_img, n_t, n_m = augment.augment_batch(torch.from_numpy(img), *args)
    p_img, p_t, p_m = augment.augment_batch(torch.from_numpy(_planar(img)), *args,
                                            layout="planar")
    assert p_img.is_contiguous()
    np.testing.assert_allclose(p_img.numpy(), _planar(n_img.numpy()), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(p_t.numpy(), n_t.numpy())
    np.testing.assert_array_equal(p_m.numpy(), n_m.numpy())
    ref_img, ref_t, ref_mask = jax.jit(jax_augment.augment_batch, static_argnames=("layout",))(
        key, jnp.asarray(_planar(img)), jnp.asarray(t), jnp.asarray(mask), layout="planar")
    np.testing.assert_allclose(p_img.numpy(), np.asarray(ref_img), rtol=0, atol=POLICY_TOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(ref_t), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p_m.numpy(), np.asarray(ref_mask))


@pytest.fixture(scope="module")
def model():
    spec = port_mini_spec()
    return spec, params_from_jax(numpy_params(mini_spec(), 0), spec)


@pytest.mark.parametrize("s2d", [False, True])
def test_apply_planar_input_equals_nhwc(model, imgs, s2d):
    spec, sd = model
    x = torch.from_numpy(imgs[:2])
    maps, stats = darknet.apply(sd, spec, x, train=True, s2d_stem=s2d)
    p_maps, p_stats = darknet.apply(sd, spec, torch.from_numpy(_planar(imgs[:2])), train=True,
                                    s2d_stem=s2d, input_layout="planar")
    for a, b in zip(maps, p_maps):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for k in stats:
        np.testing.assert_array_equal(stats[k].numpy(), p_stats[k].numpy())


@pytest.mark.parametrize("s2d", [False, True])
def test_train_step_planar_matches_nhwc(model, s2d):
    """One augmented Adam step from the same generator seed, planar against
    NHWC (``tests/test_augment_planar.py:109-130``): the losses within a
    relative 1e-4, and the model input within 1e-5 (``prepare_batch``)."""
    spec, sd = model
    u8 = np.random.RandomState(4).randint(0, 256, (2, 80, 80, 3), dtype=np.uint8)
    t = np.zeros((8, 6), np.float32)
    t[0] = [0, 0, 0.5, 0.5, 0.2, 0.3]
    t[1] = [1, 1, 0.3, 0.6, 0.1, 0.2]
    mask = np.arange(8) < 2
    opt = steps.make_optimizer(1e-3)
    losses, inputs = [], []
    for layout in ("nhwc", "planar"):
        inputs.append(steps.prepare_batch(u8, t, mask, 64, torch.device("cpu"), True,
                                          torch.Generator().manual_seed(3), layout))
        state = steps.init_train_state(sd, opt, device="cpu")
        step = steps.make_train_step(spec, opt, augment=True, s2d_stem=s2d,
                                     image_layout=layout)
        state, m = step(state, u8, t, mask, torch.Generator().manual_seed(3), 64)
        losses.append(float(m["loss"]))
    (n_img, n_t, n_m), (p_img, p_t, p_m) = inputs
    np.testing.assert_allclose(p_img.numpy(), _planar(n_img.numpy()), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(p_t.numpy(), n_t.numpy())
    np.testing.assert_array_equal(p_m.numpy(), n_m.numpy())
    assert abs(losses[0] - losses[1]) < 1e-4 * max(1.0, abs(losses[0]))
