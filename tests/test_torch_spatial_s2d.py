"""The height-sharded train step (``parallel/spatial.py``) with the s2d
training stem and with the BN statistics as products, against the port's
unsharded step and the JAX package's GSPMD step.

Meshes of CPU entries with every move between them a copy
(``copy_always``), as ``tests/test_torch_spatial.py`` runs them.  Mini spec
(coarsest stride 16): 64² splits into 2/2 coarsest rows at ``sp=2``, 80²
into 3/2.

* The sharded s2d step against the unsharded s2d step, where only the sums
  over the shards reassociate (the BN sums, and each weight gradient, a sum
  over every shard's pixels): loss rtol 1e-6, every new BN statistic rtol
  1e-5 / atol 1e-6, every gradient within 1e-4 of its tensor's largest
  magnitude, the bound ``tests/test_torch_spatial.py`` holds the plain
  stem's sharded gradients to (measured: up to 7e-6 of the largest, 2.3e-5
  in the matmul form, on BN 0's scale and shift, sums over every pixel
  that cancel; elementwise, conv 0's weight gradient differs by 1.6e-4 of
  an element); even and uneven splits, ``sp=2, dp=2`` with the planar
  image layout.
* Against the JAX grad step with ``s2d_stem=True`` under
  ``spatial_image_sharding`` (GSPMD partitions the s2d stem like any conv),
  at ``tests/test_spatial.py``'s bounds: loss rtol 1e-5, gradients rtol
  1e-2 / atol 1e-3, statistics rtol 1e-5 / atol 1e-6.
* The halos of the s2d stem: conv_a moves one s2d row each way, conv_b one
  row of conv_a's output up, counted on the copies against the plain
  stem's.
* ``bn_form="matmul"`` (``AMYOLO_BN_FORM``) sharded against unsharded, at
  the bounds above, and against JAX's ``"matmul"`` form; an unknown form
  raises.
* The train step's parameter copies on the other devices are leaves whose
  gradients are added to the first device's after the backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu.parallel import spatial as jax_spatial
from amyloid_yolo_tpu.parallel import steps as jax_steps
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.parallel import mesh as mesh_mod
from amyloid_yolo_tpu_torch.parallel import spatial, steps
from amyloid_yolo_tpu_torch.parallel.spatial import SpatialShards, apply_sharded, \
    make_spatial_mesh

from minispec import mini_spec
from test_torch_spatial import _batch, _port_key, _to_port_grads
from torch_port_helpers import copy_always, numpy_params, port_mini_spec


@pytest.fixture(autouse=True)
def moved(monkeypatch):
    return copy_always(monkeypatch, mesh_mod, steps, spatial)


@pytest.fixture(scope="module")
def weights():
    p = numpy_params(mini_spec(), 4)
    return {"jax": p, "port": params_from_jax(p, port_mini_spec())}


def _mesh(n_sp, n_dp=1):
    return make_spatial_mesh(n_sp, n_dp, devices=["cpu"] * (n_sp * n_dp))


def _grad(weights, size, mesh=None, **kw):
    gstep = steps.make_grad_step(port_mini_spec(img_size=size), **kw)
    shards = None if mesh is None else SpatialShards(mesh)
    return gstep(weights["port"], *_batch(size), size, shards=shards)


def _assert_close(got, want, loss_rtol, grad_rtol, grad_atol, per_tensor=False):
    """Loss, gradients and new BN statistics; ``per_tensor``: each gradient
    within ``grad_rtol`` of its tensor's largest magnitude plus
    ``grad_atol``, where an element whose sum over every pixel cancels
    would fail a bound relative to itself on float32 reassociation alone."""
    (loss, grads, stats), (wloss, wgrads, wstats) = got, want
    np.testing.assert_allclose(float(loss), float(wloss), rtol=loss_rtol)
    assert set(grads) == set(wgrads) and set(stats) == set(wstats)
    for k, v in wgrads.items():
        g, v = grads[k].numpy(), np.asarray(v)
        if per_tensor:
            err = float(np.abs(g - v).max())
            assert err <= grad_rtol * float(np.abs(v).max()) + grad_atol, (k, err)
        else:
            np.testing.assert_allclose(g, v, rtol=grad_rtol, atol=grad_atol, err_msg=k)
    for k, v in wstats.items():
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("size, n_sp, n_dp, layout", [(64, 2, 1, "nhwc"), (80, 2, 1, "nhwc"),
                                                      (64, 2, 2, "planar")],
                         ids=["even_sp2", "uneven_sp2", "sp2_dp2_planar"])
def test_s2d_step_equals_unsharded(weights, moved, size, n_sp, n_dp, layout):
    kw = dict(s2d_stem=True, image_layout=layout)
    got = _grad(weights, size, _mesh(n_sp, n_dp), **kw)
    assert len(moved) > 0
    _assert_close(got, _grad(weights, size, **kw), 1e-6, 1e-4, 0.0, per_tensor=True)


def _jax_grad(weights, size, n_sp, n_dp, **kw):
    """The JAX grad step under ``spatial_image_sharding``, as
    ``tests/test_torch_spatial.py:jax_grads`` runs it."""
    imgs, targets, mask = _batch(size)
    mesh = jax_spatial.make_spatial_mesh(n_sp, n_dp)
    x = jax.device_put(jnp.asarray(imgs), jax_spatial.spatial_image_sharding(mesh))
    t = jax.device_put(jnp.asarray(targets), NamedSharding(mesh, P("dp")))
    mk = jax.device_put(jnp.asarray(mask), NamedSharding(mesh, P("dp")))
    params = jax.device_put(jax.tree.map(jnp.asarray, weights["jax"]), NamedSharding(mesh, P()))
    loss, g, st = jax_steps.make_grad_step(mini_spec(img_size=size), **kw)(
        params, x, t, mk, size)
    return (float(loss), _to_port_grads(g, mini_spec(img_size=size)),
            {_port_key(int(k[3:]), kk): np.asarray(v) for k, e in st.items()
             for kk, v in e.items()})


def test_s2d_step_matches_jax(weights):
    got = _grad(weights, 80, _mesh(2), s2d_stem=True)
    _assert_close(got, _jax_grad(weights, 80, 2, 1, s2d_stem=True), 1e-5, 1e-2, 1e-3)


def test_s2d_stem_moves_its_halo_rows(weights, moved):
    """The s2d run moves what the plain run moves, except the stem's halos:
    on ``sp=2``, conv_a's one s2d row (4·Cin channels, S/2 wide) each way
    and conv_b's one row of conv_a's output (4·C0 channels) up, against
    the plain stem's one image row each way and one row of layer 0's
    output up.  BN sums, parameter replicas, input slabs and head maps
    are the same on both."""
    spec = port_mini_spec()
    x = torch.from_numpy(_batch(64)[0][:2].astype(np.float32) / 255.0)
    counts = {}
    for s2d in (False, True):
        moved.clear()
        apply_sharded(weights["port"], spec, x, _mesh(2), train=True, s2d_stem=s2d)
        counts[s2d] = sum(moved)
    b, w = 2, 64
    cin, c0 = spec.layers[0].in_ch, spec.layers[0].out_ch
    s2d_halos = 2 * b * 4 * cin * (w // 2) + b * 4 * c0 * (w // 2)
    plain_halos = 2 * b * cin * w + b * c0 * w
    assert counts[True] - counts[False] == s2d_halos - plain_halos


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
def test_matmul_bn_form_equals_unsharded_and_jax(weights, monkeypatch, s2d):
    """``AMYOLO_BN_FORM=matmul`` reaches the sharded step (the stem's BNs
    reduce under the s2d stem, as unsharded); its sums differ from the
    reduce form's in order only."""
    monkeypatch.setattr(darknet, "BN_FORM", "matmul")
    monkeypatch.setattr(jax_darknet, "BN_FORM", "matmul")
    calls = []
    sums = spatial.bnstats.channel_sums
    monkeypatch.setattr(spatial.bnstats, "channel_sums",
                        lambda x2d: calls.append(x2d.shape) or sums(x2d))
    got = _grad(weights, 80, _mesh(2), s2d_stem=s2d)
    n_bn = sum(1 for i in port_mini_spec().conv_indices
               if port_mini_spec().layers[i].batch_normalize)
    assert len(calls) == 2 * (n_bn - (2 if s2d else 0))
    _assert_close(got, _grad(weights, 80, s2d_stem=s2d), 1e-6, 1e-4, 0.0, per_tensor=True)
    if s2d:
        _assert_close(got, _jax_grad(weights, 80, 2, 1, s2d_stem=True), 1e-5, 1e-2, 1e-3)


def test_train_step_replicas_are_leaves(weights, monkeypatch):
    """The train step gives each other device leaf copies of the parameters
    and adds their gradients into the first device's after the backward,
    so no gradient crosses devices into a parameter inside autograd (the
    AccumulateGrad stream mismatch of a cross-card backward).  Two device
    keys on one CPU (``cpu``, ``cpu:0``) make one such copy; the result
    is the unsharded step's, at the bounds above."""
    made = []
    leaf_replicas = spatial.leaf_replicas
    monkeypatch.setattr(spatial, "leaf_replicas",
                        lambda p, m: made.append(leaf_replicas(p, m)) or made[-1])
    got = _grad(weights, 64, make_spatial_mesh(2, devices=["cpu", "cpu:0"]), s2d_stem=True)
    (reps,) = made
    other = reps[torch.device("cpu", 0)]
    trainable = [k for k, v in other.items() if v.requires_grad]
    assert trainable and all(other[k].grad_fn is None and other[k].grad is not None
                             for k in trainable)
    _assert_close(got, _grad(weights, 64, s2d_stem=True), 1e-6, 1e-4, 0.0, per_tensor=True)


def test_unknown_bn_form_raises(weights, monkeypatch):
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="unknown BN form"):
        apply_sharded(weights["port"], port_mini_spec(), x, _mesh(2), train=True,
                      bn_form="fused")
    monkeypatch.setattr(darknet, "BN_FORM", "matmull")
    with pytest.raises(ValueError, match="unknown BN form"):
        apply_sharded(weights["port"], port_mini_spec(), x, _mesh(2), train=True)
    with pytest.raises(ValueError, match="unknown BN form"):
        darknet.apply(weights["port"], port_mini_spec(), x, train=True)
