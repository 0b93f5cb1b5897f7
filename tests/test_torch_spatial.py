"""The port's spatial (height) sharding (``parallel/spatial.py``) against the
JAX package's ``parallel/spatial.py`` and the port's unsharded path (the
counterpart of ``tests/test_spatial.py``).

Meshes of CPU entries stand for the JAX suite's virtual CPU devices, and
every move between their entries is a copy (``copy_always``), as it is
across cards, so the halo rows, the parameter replicas, the BN sums and
the gathered head maps all travel through differentiable copies.  Weights
come from JAX ``init_params`` through ``params_from_jax``.  Mini spec
(coarsest stride 16): 64² gives 4 coarsest rows (one a shard at ``sp=4``),
80² gives 5 (an uneven 3/2 split at ``sp=2``), 32² gives 2 (fewer rows
than the 4 shards: the last two own none and idle, where the JAX package's
GSPMD pads).

Tolerances, stated in each test: the JAX suite's own bounds against the
JAX package (``test_spatial.py``), and tighter ones against the port's
unsharded path, where the sharded forward does the same arithmetic per
element (the eval forwards measured bit-equal on the CPU) and only the BN
sums over the shards reassociate in training.

``test_spatial.py``'s two memoization tests (``_FN_CACHE``, ``_memoized``)
have no counterpart: PyTorch runs eagerly, compiles nothing per call, and
the port's module has no program cache to bound.
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
from amyloid_yolo_tpu_torch.graphspec import yolov3_spec
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import darknet, heads
from amyloid_yolo_tpu_torch.ops.nms import non_max_suppression
from amyloid_yolo_tpu_torch.parallel import mesh as mesh_mod
from amyloid_yolo_tpu_torch.parallel import spatial, steps
from amyloid_yolo_tpu_torch.parallel.spatial import (
    SpatialShards, make_spatial_mesh, row_plan, shard_spatial_train_step, spatial_detect,
    spatial_forward)

from minispec import mini_spec
from torch_port_helpers import copy_always, jax_params_np, port_mini_spec, port_pool_spec

LR = 1e-3
B, CAP = 4, 4


@pytest.fixture(autouse=True)
def moved(monkeypatch):
    """Every move between mesh entries is a copy; the list counts them."""
    return copy_always(monkeypatch, mesh_mod, steps, spatial)


def _cpu_mesh(n_sp, n_dp=1):
    return make_spatial_mesh(n_sp, n_dp, devices=["cpu"] * (n_sp * n_dp))


@pytest.fixture(scope="module")
def weights():
    """JAX weights with random BN statistics (so folding matters) as numpy,
    and the JAX and port folded forms."""
    p = jax_params_np(mini_spec(), 0, bn_noise=True, jit=True)
    spec = mini_spec()
    return {"jax": p, "jax_folded": jax.tree.map(np.asarray,
                                                 jax_darknet.fold_batchnorm(p, spec)),
            "port": params_from_jax(p, port_mini_spec())}


# -- the mesh and the row plan ----------------------------------------------

def test_spatial_mesh_shape():
    m = _cpu_mesh(4, 2)
    assert m.shape == {"dp": 2, "sp": 4} == dict(jax_spatial.make_spatial_mesh(4, 2).shape)
    assert len(m.devices) == 8 and m.device(1, 3) == torch.device("cpu")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError):
        make_spatial_mesh(n_sp=16, n_dp=have + 1)
    with pytest.raises(ValueError):  # a list of the wrong length
        make_spatial_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        make_spatial_mesh(0)


@pytest.mark.parametrize("spec, height, n_sp, sizes", [
    (yolov3_spec(num_classes=2), 416, 2, (7, 6)),
    (yolov3_spec(num_classes=2), 416, 4, (4, 3, 3, 3)),
    (yolov3_spec(num_classes=2), 1536, 2, (24, 24)),
    (port_mini_spec(), 64, 4, (1, 1, 1, 1)),
    (port_mini_spec(img_size=80), 80, 2, (3, 2)),
    (port_mini_spec(img_size=32), 32, 4, (1, 1, 0, 0)),
])
def test_row_plan_splits_the_coarsest_rows(spec, height, n_sp, sizes):
    """The coarsest map's rows split as evenly as possible, the first
    shards taking one more; every level owns them times ``D/stride``, so
    the levels of one shard tile the map and the shards tile it in order."""
    plan = row_plan(spec, height, n_sp)
    assert plan.step == (32 if height in (416, 1536) else 16)
    assert tuple(np.diff(plan.bounds)) == sizes
    assert plan.active == tuple(c for c, n in enumerate(sizes) if n)
    for s in set(spatial.layer_strides(spec)):
        rows = [plan.rows(c, s) for c in range(n_sp)]
        assert rows[0][0] == 0 and rows[-1][1] == height // s
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


def test_row_plan_refuses_a_height_off_the_coarsest_stride():
    with pytest.raises(ValueError, match="coarsest stride 16"):
        row_plan(port_mini_spec(), 72, 2)


def test_image_sharding_split_rows(moved):
    """Shard (r, c) takes batch rows r·b .. and image rows of the plan."""
    mesh = _cpu_mesh(2, 2)
    sh = spatial.spatial_image_sharding(mesh)
    plan = sh.plan(port_mini_spec(img_size=80), 80)
    x = torch.arange(4 * 80 * 2 * 1, dtype=torch.float32).reshape(4, 80, 2, 1)
    parts = sh.split(x, plan)
    assert sh.shards(plan) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [tuple(p.shape) for p in parts] == [(2, 48, 2, 1), (2, 32, 2, 1)] * 2
    assert torch.equal(parts[3], x[2:, 48:])
    assert len(moved) == 4
    with pytest.raises(ValueError, match="batch 3"):
        sh.split(x[:3], plan)


# -- the forward and the detection pipeline ---------------------------------

@pytest.fixture(scope="module")
def tiles():
    return {s: (np.random.RandomState(s).rand(4, s, s, 3) * 255).astype(np.uint8)
            for s in (32, 64, 80)}


@pytest.mark.parametrize("folded", [True, False], ids=["folded", "unfolded"])
@pytest.mark.parametrize("size, n_sp, n_dp", [(64, 4, 2), (80, 2, 1), (32, 4, 2)],
                         ids=["even_sp4_dp2", "uneven_sp2", "too_few_rows_sp4_dp2"])
def test_spatial_forward_matches_jax_and_unsharded(weights, tiles, size, n_sp, n_dp, folded):
    """float32 ``spatial_forward`` against the JAX ``spatial_forward`` on a
    mesh of the same shape (rtol 1e-4, atol 1e-5: ``test_spatial.py``'s),
    and against the port's unsharded forward plus ``decode_all`` (atol
    1e-6; bit-equal as measured on the CPU, the per-element arithmetic
    being the same).  At 32² the last two shards own no rows."""
    x = tiles[size][:2 * n_dp].astype(np.float32) / 255.0
    jspec, pspec = mini_spec(img_size=size), port_mini_spec(img_size=size)
    jp = weights["jax_folded"] if folded else weights["jax"]
    want_jax = np.asarray(jax_spatial.spatial_forward(
        jax.tree.map(jnp.asarray, jp), jspec, jnp.asarray(x),
        jax_spatial.make_spatial_mesh(n_sp, n_dp)))
    pp = darknet.fold_batchnorm(weights["port"], pspec) if folded else weights["port"]
    got = spatial_forward(pp, pspec, torch.from_numpy(x), _cpu_mesh(n_sp, n_dp))
    np.testing.assert_allclose(got.numpy(), want_jax, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        maps = (darknet.apply_folded(pp, pspec, torch.from_numpy(x),
                                     compute_dtype=torch.float32) if folded
                else darknet.apply(pp, pspec, torch.from_numpy(x)))
    want = heads.decode_all(maps, pspec, size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_spatial_forward_moves_only_halo_rows(weights, tiles, moved):
    """On ``sp=2`` the rows that cross from one shard to the other are the
    3×3 convs' halos: one row each way for stride 1, one row up for
    stride 2; 1×1 convs, routes, upsamples and shortcuts move nothing.
    Every other copy is a parameter replica, an input slab or a head map."""
    spec = port_mini_spec()
    folded = darknet.fold_batchnorm(weights["port"], spec)
    x = torch.from_numpy(tiles[64][:2].astype(np.float32) / 255.0)
    spatial_forward(folded, spec, x, _cpu_mesh(2))
    strides = spatial.layer_strides(spec)
    halos = []
    for i, layer in enumerate(spec.layers):
        if getattr(layer, "kernel", 1) == 3:
            s_in = strides[i - 1] if i else 1
            rows = 2 if layer.stride == 1 else 1  # per shard pair: down + up, or up only
            halos += [2 * (64 // s_in) * layer.in_ch] * rows
    # the two CPU entries share one replica of the parameters
    n_params = sum(t.numel() for v in folded.values() for t in v.values())
    n_in, n_heads = x.numel(), sum(2 * 3 * 7 * (64 // s) ** 2 for s in (16, 8, 4))
    assert sum(moved) == n_params + n_in + sum(halos) + n_heads


@pytest.mark.parametrize("size, n_sp, n_dp", [(64, 4, 2), (80, 2, 1)],
                         ids=["even_sp4_dp2", "uneven_sp2"])
def test_spatial_detect_matches_jax(weights, tiles, size, n_sp, n_dp):
    """``spatial_detect`` (uint8 tiles, ``× float32(1/255)``, sharded
    backbone, decode, merging NMS with its overflow count, boxes in the
    tile's pixels) against the JAX ``spatial_detect``: ``n_candidates`` and
    ``valid`` equal, dets within 1e-4 (``test_spatial.py``'s), and against
    the port's unsharded pipeline exactly."""
    t = tiles[size][:2 * n_dp]
    jspec, pspec = mini_spec(img_size=size), port_mini_spec(img_size=size)
    want = [np.asarray(a) for a in jax_spatial.spatial_detect(
        jax.tree.map(jnp.asarray, weights["jax_folded"]), jspec, jnp.asarray(t),
        jax_spatial.make_spatial_mesh(n_sp, n_dp), conf_thres=0.3, nms_thres=0.4,
        capacity=16)]
    folded = darknet.fold_batchnorm(weights["port"], pspec)
    got_d, got_v, got_n = spatial_detect(folded, pspec, torch.from_numpy(t),
                                         _cpu_mesh(n_sp, n_dp), conf_thres=0.3,
                                         nms_thres=0.4, capacity=16)
    assert want[2].min() > 0  # candidates to merge
    np.testing.assert_array_equal(got_n.numpy(), want[2])
    np.testing.assert_array_equal(got_v.numpy(), want[1])
    np.testing.assert_allclose(got_d.numpy(), want[0], rtol=1e-4, atol=1e-4)

    x = torch.from_numpy(t).to(torch.float32) * spatial.RECIP_255
    with torch.no_grad():
        pred = heads.decode_all(darknet.apply_folded(folded, pspec, x,
                                                     compute_dtype=torch.float32), pspec, size)
    ref = non_max_suppression(pred, 0.3, 0.4, 16, return_count=True)
    for g, r in zip((got_d, got_v, got_n), ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("n_sp", [2, 3])
def test_pools_match_unsharded(n_sp):
    """Max pools read their halo rows with the layer's own padding (the
    YOLOv3 graph has none; yolov3-tiny has 2/2 and 2/1): equal to the
    unsharded forward, eval and train, on a spec whose pools sit at the
    shard edges."""
    spec = port_pool_spec(24)
    params = darknet.init_params(torch.Generator().manual_seed(0), spec)
    x = torch.rand(2, 24, 24, 3, generator=torch.Generator().manual_seed(1)) - 0.5
    mesh = _cpu_mesh(n_sp)
    folded = darknet.fold_batchnorm(params, spec)
    got = spatial.apply_sharded(folded, spec, x, mesh)
    want = darknet.apply_folded(folded, spec, x, compute_dtype=torch.float32)
    assert torch.equal(got[0], want[0])
    (gm, gs), (wm, ws) = (spatial.apply_sharded(params, spec, x, mesh, train=True),
                          darknet.apply(params, spec, x, train=True))
    torch.testing.assert_close(gm[0], wm[0], rtol=1e-5, atol=1e-5)
    for k in ws:
        torch.testing.assert_close(gs[k], ws[k], rtol=1e-5, atol=1e-6)


# -- the train step ---------------------------------------------------------

def _batch(size, seed=5):
    r = np.random.RandomState(seed)
    imgs = r.randint(0, 255, (B, size, size, 3)).astype(np.uint8)
    targets = np.zeros((B * CAP, 6), np.float32)
    mask = np.zeros((B * CAP,), bool)
    for b in range(B):
        targets[b * CAP] = [b, 1 - b % 2, 0.5, 0.45, 0.3, 0.2]
        mask[b * CAP] = True
    return imgs, targets, mask


def _port_key(i, kk):
    return f"module_list.{i}.batch_norm_{i}.running_{kk}"


def _to_port_grads(tree, spec):
    out = {}
    for i in spec.conv_indices:
        out[f"module_list.{i}.conv_{i}.weight"] = np.asarray(
            tree[f"conv_{i}"]["w"]).transpose(3, 2, 0, 1)
        if spec.layers[i].batch_normalize:
            out[f"module_list.{i}.batch_norm_{i}.weight"] = np.asarray(tree[f"bn_{i}"]["scale"])
            out[f"module_list.{i}.batch_norm_{i}.bias"] = np.asarray(tree[f"bn_{i}"]["bias"])
        else:
            out[f"module_list.{i}.conv_{i}.bias"] = np.asarray(tree[f"conv_{i}"]["b"])
    return out


@pytest.fixture(scope="module")
def jax_grads(weights):
    """The JAX grad step under ``spatial_image_sharding`` (as
    ``test_spatial.py:143-189`` runs it), one result per configuration."""
    out = {}
    for size, n_sp, n_dp in ((64, 4, 2), (80, 2, 1)):
        imgs, targets, mask = _batch(size)
        mesh = jax_spatial.make_spatial_mesh(n_sp, n_dp)
        rep = NamedSharding(mesh, P())
        x = jax.device_put(jnp.asarray(imgs), jax_spatial.spatial_image_sharding(mesh))
        t = jax.device_put(jnp.asarray(targets), NamedSharding(mesh, P("dp")))
        mk = jax.device_put(jnp.asarray(mask), NamedSharding(mesh, P("dp")))
        gstep = jax_steps.make_grad_step(mini_spec(img_size=size))
        loss, g, st = gstep(jax.device_put(jax.tree.map(jnp.asarray, weights["jax"]), rep),
                            x, t, mk, size)
        out[size] = (float(loss), _to_port_grads(g, mini_spec(img_size=size)),
                     {_port_key(int(k[3:]), kk): np.asarray(v)
                      for k, e in st.items() for kk, v in e.items()})
    return out


@pytest.mark.parametrize("size, n_sp, n_dp", [(64, 4, 2), (80, 2, 1)],
                         ids=["even_sp4_dp2", "uneven_sp2"])
def test_grad_step_matches_jax_and_unsharded(weights, jax_grads, moved, size, n_sp, n_dp):
    """``make_grad_step`` through ``SpatialShards`` against the JAX grad step
    under ``spatial_image_sharding``, at ``test_spatial.py``'s bounds: loss
    rtol 1e-5, gradients rtol 1e-2 / atol 1e-3, new BN statistics rtol 1e-5
    / atol 1e-6.  Against the port's unsharded grad step, where only the BN
    sums over the shards reassociate: loss rtol 1e-6, each gradient within
    1e-4 of its tensor's largest value (measured ≤ 8e-6), BN statistics
    rtol 1e-5 / atol 1e-6.  The uneven split (80²: 48/32 input rows) counts
    the true elements of each shard, as a BN count that assumed equal
    shards would not."""
    pspec = port_mini_spec(img_size=size)
    batch = _batch(size)
    gstep = steps.make_grad_step(pspec)
    loss, grads, stats = gstep(weights["port"], *batch, size,
                               shards=SpatialShards(_cpu_mesh(n_sp, n_dp)))
    assert len(moved) > 0
    jloss, jg, jst = jax_grads[size]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert set(grads) == set(jg)
    for k, v in jg.items():
        np.testing.assert_allclose(grads[k].numpy(), v, rtol=1e-2, atol=1e-3, err_msg=k)
    assert set(stats) == set(jst)
    for k, v in jst.items():
        np.testing.assert_allclose(stats[k].numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)

    loss1, g1, st1 = gstep(weights["port"], *batch, size)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-6)
    for k, v in g1.items():
        assert float((grads[k] - v).abs().max()) <= 1e-4 * float(v.abs().max()), k
    for k, v in st1.items():
        np.testing.assert_allclose(stats[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _train(params, batch, size, mesh=None, augment=False, seed=3):
    opt = steps.make_optimizer(LR)
    state = steps.init_train_state(params, opt, device="cpu")
    step = steps.make_train_step(port_mini_spec(img_size=size), opt, augment=augment)
    if mesh is not None:
        step = shard_spatial_train_step(step, mesh)
    state, m = step(state, *batch, torch.Generator().manual_seed(seed), size)
    return float(m["loss"]), {k: float(v) for k, v in m.items()}, \
        {k: v.detach().clone() for k, v in state.params.items()}


def _assert_params_close(got, want):
    """The JAX suite's bound after one Adam apply (rtol 1e-4, atol 2.05·lr:
    Adam's first update is about −lr·sign(g)), BN running statistics within
    a relative 1e-5."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got[k].float()
        if k.endswith(("running_mean", "running_var")):
            rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            assert rel <= 1e-5, (k, rel)
        else:
            np.testing.assert_allclose(g.numpy(), w.float().numpy(), rtol=1e-4,
                                       atol=2.05 * LR, err_msg=k)


@pytest.mark.parametrize("size, n_sp, n_dp", [(64, 4, 2), (80, 2, 1)],
                         ids=["even_sp4_dp2", "uneven_sp2"])
def test_train_step_equals_unsharded(weights, size, n_sp, n_dp):
    """The height-sharded train step against the one-device step: loss
    rtol 1e-5, every logged metric rtol 1e-5 / atol 1e-6 (the global
    batch's), post-Adam parameters and BN running statistics as
    :func:`_assert_params_close` holds them."""
    batch = _batch(size)
    loss1, m1, after1 = _train(weights["port"], batch, size)
    loss, m, after = _train(weights["port"], batch, size, _cpu_mesh(n_sp, n_dp))
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    assert set(m) == set(m1)
    for k in m1:
        np.testing.assert_allclose(m[k], m1[k], rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_params_close(after, after1)


def test_train_step_equals_jax_spatial_step(weights):
    """Against the JAX ``shard_spatial_train_step`` on a (2, 4) mesh, at
    ``test_spatial.py``'s bounds: loss rtol 1e-5, post-Adam parameters
    rtol 1e-4 / atol 2.05·lr."""
    batch = _batch(64)
    loss, _, after = _train(weights["port"], batch, 64, _cpu_mesh(4, 2))
    opt = jax_steps.make_optimizer(LR)
    jstep = jax_spatial.shard_spatial_train_step(
        jax_steps.make_train_step(mini_spec(), opt, augment=False, image_layout="nhwc"),
        jax_spatial.make_spatial_mesh(4, 2))
    jstate, jm = jstep(jax_steps.init_train_state(jax.tree.map(jnp.asarray, weights["jax"]),
                                                  opt),
                       *(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0), 64)
    np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-5)
    want = {k: torch.as_tensor(np.asarray(v)) for k, v in params_from_jax(
        jax.tree.map(np.asarray, jstate.params), port_mini_spec()).items()}
    for k, w in want.items():
        if not k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            np.testing.assert_allclose(after[k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=2.05 * LR, err_msg=k)


def test_augmented_sharded_step_equals_unsharded_and_is_finite(weights):
    """With augmentation the global batch is drawn and augmented on the
    first device before the split, so the sharded step sees the one-device
    step's images and boxes: loss rtol 1e-5, parameters as above, all
    finite (the JAX suite checks its augmented step for finiteness)."""
    batch = _batch(64)
    loss1, _, after1 = _train(weights["port"], batch, 64, augment=True)
    loss, _, after = _train(weights["port"], batch, 64, _cpu_mesh(4), augment=True)
    assert np.isfinite(loss)
    assert all(bool(torch.isfinite(v).all()) for v in after.values() if v.is_floating_point())
    np.testing.assert_allclose(loss, loss1, rtol=1e-5)
    _assert_params_close(after, after1)


def test_spatial_shards_refuse_params_off_the_first_device(weights):
    mesh = make_spatial_mesh(2, devices=["meta", "meta"])
    with pytest.raises(ValueError, match="first device"):
        steps.make_grad_step(port_mini_spec())(weights["port"], *_batch(64), 64,
                                               shards=SpatialShards(mesh))


def test_native_res_training_example_runs_mini(capsys):
    """``examples/native_res_training_torch.py --mini`` at 64² over a (1, 2)
    grid of CPU entries: two augmented height-sharded steps, finite losses;
    its mini spec is the suite's."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "native_res_training_torch.py")
    spec = importlib.util.spec_from_file_location("native_res_training_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.mini_spec(img_size=64).layers == port_mini_spec().layers
    assert mod.main(["--mini", "--sp", "2", "--dp", "1", "--img_size", "64", "--steps", "2",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1]) for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses)) and out.rstrip().endswith("ok")
