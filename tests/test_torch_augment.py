"""The port's training augmentation against the JAX package's
(``ops/augment.py``, NHWC layout).

The draws: ``jax.random`` cannot be reproduced in PyTorch, so the test
makes the eight draws of the reference's ``augment_batch``
(``augment.py:373-381``) with JAX from its own ``jax.random.split(rng, 8)``
and hands them to the port; the reference runs from the same key.

Tolerances: op by op, against the reference's ops run one at a time
(eagerly), the 3-shear affine, the boxes and the masks are exact (the same
float32 operations in the same order); the sharpen's nine taps are summed
in another order (1e-6); HSV within ``IMG_TOL`` = 2e-6 (a few float32 ulps
at values <= 1).  The full policy is held against the reference compiled
with ``jax.jit``, as its train step runs it: XLA contracts the lerps'
multiply-adds into FMAs and reorders the shear constants, which moves
each resample position by ~1e-6 pixel and the pixel values by up to 9e-6
on this data, so images agree within ``POLICY_TOL`` = 2e-5; the box
coordinates within 1e-6 (an FMA's one or two ulps) and the mask exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.ops import augment as jax_augment
from amyloid_yolo_tpu_torch.ops import augment

IMG_TOL = 2e-6
POLICY_TOL = 2e-5
B, S = 3, 64
_jax_augment_batch = jax.jit(jax_augment.augment_batch, static_argnames=("layout",))


def _jax_draws(key, b=B, s=S):
    """The reference's draws, in its order (``augment.py:373-381``)."""
    k = jax.random.split(key, 8)
    d = {
        "drop_rate": jax.random.uniform(k[0], (b,)) * 0.01,
        "sharp_alpha": jax.random.uniform(k[1], (b,)) * 0.2,
        "angle": jax.random.uniform(k[2], (b,), minval=-20.0, maxval=20.0),
        "trans": jax.random.uniform(k[3], (b, 2), minval=-0.2, maxval=0.2),
        "bright": jax.random.uniform(k[4], (b,), minval=-30.0, maxval=30.0) / 255.0,
        "hue": jax.random.uniform(k[5], (b,), minval=-20.0, maxval=20.0) * 2.0 / 360.0,
        "flip": jax.random.bernoulli(k[6], 0.5, (b,)),
        "drop_u": jax.random.uniform(k[7], (b, s, s)),
    }
    return {n: torch.from_numpy(np.array(v)) for n, v in d.items()}


def _batch(seed, b=B, s=S):
    r = np.random.RandomState(seed)
    img = r.rand(b, s, s, 3).astype(np.float32)
    n = 4 * b
    t = np.zeros((n, 6), np.float32)
    t[:, 0] = np.repeat(np.arange(b), 4)
    t[:, 1] = r.randint(0, 2, n)
    t[:, 2:4] = r.rand(n, 2) * 0.9 + 0.05
    t[:, 4:6] = r.rand(n, 2) * 0.2 + 0.02
    t[3, 2:6] = (0.99, 0.5, 0.01, 0.05)  # a box at the right edge
    mask = np.ones(n, bool)
    mask[-1] = False
    return img, t, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_batch_matches_jax(seed):
    img, t, mask = _batch(seed)
    key = jax.random.PRNGKey(seed)
    ref_img, ref_t, ref_mask = _jax_augment_batch(
        key, jnp.asarray(img), jnp.asarray(t), jnp.asarray(mask), layout="nhwc")
    draws = _jax_draws(key)
    got_img, got_t, got_mask = augment.augment_batch(
        torch.from_numpy(img), torch.from_numpy(t), torch.from_numpy(mask), draws)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(ref_img), rtol=0, atol=POLICY_TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(ref_t), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    assert got_img.min() >= 0.0 and got_img.max() <= 1.0


def _per_image(fn, *args):
    """The reference's single-image op over the batch, op by op."""
    return np.stack([np.asarray(fn(*[a[i] for a in args])) for i in range(B)])


def test_affine_shear3_is_exact_to_jax():
    img, _, _ = _batch(3)
    d = _jax_draws(jax.random.PRNGKey(3))
    ang, tr = d["angle"].numpy(), d["trans"].numpy()
    ref = _per_image(jax_augment._affine_shear3, jnp.asarray(img), jnp.asarray(ang),
                     jnp.asarray(tr[:, 0]), jnp.asarray(tr[:, 1]))
    got = augment._affine_shear3(torch.from_numpy(img), d["angle"], d["trans"][:, 0],
                                 d["trans"][:, 1])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sharpen_matches_jax():
    img, _, _ = _batch(4)
    alpha = np.array([0.0, 0.1, 0.2], np.float32)
    ref = _per_image(jax_augment._sharpen, jnp.asarray(img), jnp.asarray(alpha))
    got = augment._sharpen(torch.from_numpy(img), torch.from_numpy(alpha))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0].numpy(), img[0])  # alpha 0: unchanged


def test_hsv_round_trip_matches_jax():
    img, _, _ = _batch(5)
    img[0, :4, :4] = 0.5    # grey pixels: zero spread
    img[0, 4:8, :4] = 0.0   # black: zero max
    rgb = [torch.from_numpy(img[..., c]) for c in range(3)]
    h, s, v = augment._rgb_to_hsv(*rgb)
    ref_h, ref_s, ref_v = jax.jit(jax_augment._rgb_to_hsv_planes)(
        *[jnp.asarray(img[..., c]) for c in range(3)])
    for got, ref in ((h, ref_h), (s, ref_s), (v, ref_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=IMG_TOL)
    hh = torch.remainder(h + 0.05, 1.0)
    back = augment._hsv_to_rgb(hh, s, v)
    ref_back = jax.jit(jax_augment._hsv_to_rgb_planes)(jnp.asarray(hh.numpy()), ref_s, ref_v)
    for got, ref in zip(back, ref_back):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=IMG_TOL)


def test_affine_boxes_and_alive_mask():
    """Boxes through the forward affine exactly as the reference; a box moved
    off the image leaves the mask, the flip mirrors cx."""
    t = np.array([[0, 0, 0.5, 0.5, 0.2, 0.1],
                  [1, 1, 0.95, 0.3, 0.04, 0.05],
                  [1, 0, 0.02, 0.7, 0.03, 0.03]], np.float32)
    ang = np.array([10.0, -15.0], np.float32)
    tr = np.array([[0.1, -0.05], [0.2, 0.0]], np.float32)
    bidx = t[:, 0].astype(int)
    ref = jax_augment._affine_boxes(jnp.asarray(t[:, 2:6]), jnp.asarray(ang[bidx]),
                                    jnp.asarray(tr[bidx, 0]), jnp.asarray(tr[bidx, 1]))
    got = augment._affine_boxes(torch.from_numpy(t[:, 2:6]), torch.from_numpy(ang[bidx]),
                                torch.from_numpy(tr[bidx, 0]), torch.from_numpy(tr[bidx, 1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got[1, 2]) == 0.0  # pushed off the right edge: no width left

    draws = {"drop_rate": torch.zeros(2), "sharp_alpha": torch.zeros(2),
             "angle": torch.from_numpy(ang), "trans": torch.from_numpy(tr),
             "bright": torch.zeros(2), "hue": torch.zeros(2),
             "flip": torch.tensor([True, False]), "drop_u": torch.ones(2, 16, 16)}
    img = torch.full((2, 16, 16, 3), 0.5)
    _, new_t, alive = augment.augment_batch(img, torch.from_numpy(t),
                                            torch.ones(3, dtype=torch.bool), draws)
    np.testing.assert_array_equal(alive.numpy(), [True, False, True])
    np.testing.assert_allclose(new_t[0, 2].item(), 1.0 - got[0, 0].item(), atol=1e-7)
    np.testing.assert_array_equal(new_t[1:, 2].numpy(), got[1:, 0].numpy())
    np.testing.assert_array_equal(new_t[:, :2].numpy(), t[:, :2])


def test_draws_lie_in_the_policy_ranges():
    gen = torch.Generator().manual_seed(0)
    d = augment.draw_augment_params(gen, 512, 32, "cpu")
    ranges = {"drop_rate": (0.0, 0.01), "sharp_alpha": (0.0, 0.2), "angle": (-20.0, 20.0),
              "trans": (-0.2, 0.2), "bright": (-30 / 255, 30 / 255),
              "hue": (-40 / 360, 40 / 360), "drop_u": (0.0, 1.0)}
    for k, (lo, hi) in ranges.items():
        v = d[k]
        assert v.dtype == torch.float32, k
        assert lo <= float(v.min()) and float(v.max()) <= hi, k
        # each range is covered, not a corner of it
        assert float(v.max()) - float(v.min()) > 0.9 * (hi - lo), k
    assert d["trans"].shape == (512, 2) and d["drop_u"].shape == (512, 32, 32)
    assert d["flip"].dtype == torch.bool and 0.4 < d["flip"].float().mean() < 0.6
    again = augment.draw_augment_params(torch.Generator().manual_seed(0), 512, 32, "cpu")
    for k in d:
        assert torch.equal(d[k], again[k]), k


@pytest.mark.parametrize("layout", ["nhwc", "planar"])
def test_affine_one_matches_jax(layout):
    """The exact 2-D warp (``_affine_one`` over ``_bilinear_sample``) against
    the reference's, image by image, within 1e-5, in both layouts; and
    ``_bilinear_sample`` alone at coordinates that leave the image."""
    img, _, _ = _batch(6)
    ang = np.array([0.0, 13.0, -19.0], np.float32)
    tr = np.array([[0.15, -0.1], [0.0, 0.2], [-0.2, 0.05]], np.float32)
    ref = _per_image(jax_augment._affine_one, jnp.asarray(img), jnp.asarray(ang),
                     jnp.asarray(tr[:, 0]), jnp.asarray(tr[:, 1]))
    planar = layout == "planar"
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).copy() if planar else img)
    got = augment._affine_one(x, torch.from_numpy(ang), torch.from_numpy(tr[:, 0]),
                              torch.from_numpy(tr[:, 1]), planar=planar).numpy()
    if planar:
        got = got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (ref == 0).any()  # corners rotated in from outside

    r = np.random.RandomState(7)
    ys = (r.rand(B, 9, 11) * (S + 8) - 4).astype(np.float32)
    xs = (r.rand(B, 9, 11) * (S + 8) - 4).astype(np.float32)
    ref = _per_image(jax_augment._bilinear_sample, jnp.asarray(img), jnp.asarray(ys),
                     jnp.asarray(xs))
    got = augment._bilinear_sample(x, torch.from_numpy(ys), torch.from_numpy(xs),
                                   planar=planar).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1) if planar else got, ref, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("angle,sin_rounded", [(-19.0, False), (13.0, False), (-20.0, True)])
def test_affine_one_at_416(angle, sin_rounded):
    """At the training size the two packages' maps part most.  The port
    takes cos/sin in float64 and rounds them; JAX's float32 ``sin`` is not
    the correctly rounded value for some of the policy's angles, -19 and 13
    among them (``sin_rounded`` False).  On smooth, stain-like
    content, inside the image (all four taps inside) the warps agree within
    1e-5; where a tap falls in the zero fill a coordinate's float32 ulp
    near 416 (3.05e-5 px) meets a step from the image to 0, so there they
    agree within that ulp times the largest pixel value."""
    s = 416
    th = np.asarray(jnp.deg2rad(jnp.float32(angle)))
    assert (np.asarray(jnp.sin(th)) == np.float32(np.sin(np.float64(th)))) == sin_rounded
    yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    img = (np.stack([np.sin(xx / 9.0) + 1, np.cos(yy / 7.0) + 1, (xx + yy) / (2.0 * s)], -1)
           / 2).astype(np.float32)
    for tx, ty in ((0.15, -0.1), (-0.2, 0.2)):
        ref = np.asarray(jax_augment._affine_one(jnp.asarray(img), jnp.float32(angle),
                                                 jnp.float32(tx), jnp.float32(ty)))
        args = (torch.tensor([angle]), torch.tensor([tx]), torch.tensor([ty]))
        got = augment._affine_one(torch.from_numpy(img[None]), *args)[0].numpy()
        ys, xs = (c[0].numpy() for c in augment._affine_coords(s, *args))
        inside = (ys >= 0) & (ys < s - 1) & (xs >= 0) & (xs < s - 1)
        diff = np.abs(got - ref).max(axis=-1)
        assert inside.any() and (~inside).any()
        assert diff[inside].max() <= 1e-5
        assert diff[~inside].max() <= np.spacing(np.float32(s)) * img.max()


def test_shear3_equals_bilinear_for_translation():
    """``tests/test_augment.py:81-102``'s check on the port: the shear warp
    equals the bilinear warp for pure translation (1e-5) and stays within
    5e-3 of it on smooth content rotated 9° (interior pixels)."""
    img, _, _ = _batch(8)
    zero = torch.zeros(B)
    tx, ty = torch.full((B,), 0.15), torch.full((B,), -0.1)
    x = torch.from_numpy(img)
    np.testing.assert_allclose(augment._affine_shear3(x, zero, tx, ty).numpy(),
                               augment._affine_one(x, zero, tx, ty).numpy(), rtol=0, atol=1e-5)
    yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    smooth = (np.stack([np.sin(xx / 9.0) + 1, np.cos(yy / 7.0) + 1, (xx + yy) / 126.0], -1)
              .astype(np.float32) / 2)[None]
    nine = torch.full((1,), 9.0)
    a = augment._affine_one(torch.from_numpy(smooth), nine, zero[:1], zero[:1]).numpy()
    b = augment._affine_shear3(torch.from_numpy(smooth), nine, zero[:1], zero[:1]).numpy()
    assert np.abs(a - b)[0, 8:-8, 8:-8].max() < 5e-3
