"""The port's space-to-depth training stem (``darknet.apply(s2d_stem=True)``)
against the JAX package's (``models/darknet.py:215-240``, ``:663-765``) and
against the port's plain stem, on the mini spec at 64².

* ``_s2d_relabel``: bit-exact to the fold-time transforms and to JAX's
  relabel (the port's OIHW weights transposed to HWIO).
* The train forward and its new BN running statistics: head maps within a
  relative 2e-4, statistics within 1e-4 (``tests/test_s2d_train.py:60-69``),
  of JAX's s2d forward and of the port's plain one; eval mode 2e-5 of the
  plain one.
* Gradients of loss∘apply: s2d against plain in float64 within a relative
  1e-9 (the reparameterization is exact; float64 keeps the summation-order
  noise from flipping a leaky slope; a smooth loss of the head maps, since
  the YOLO loss builds float32 targets), and the float32 s2d gradients of
  the YOLO loss against JAX's within ``GRAD_RTOL`` in the 2-norm
  (``tests/test_torch_train_forward.py``'s bound).
* The steps and the ``Trainer``: ``s2d_stem`` reaches the forward (the
  step's loss is the s2d forward's), the in-process data-parallel step
  takes it, and ``Trainer(s2d_stem=None)`` resolves as JAX's does, under
  ``spatial_shard > 1`` too, where an explicit ``True`` trains
  (``tests/test_torch_spatial_s2d.py`` holds the height-sharded s2d step).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu.ops.loss import yolo_loss as jax_yolo_loss
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import darknet
from amyloid_yolo_tpu_torch.ops.loss import yolo_loss
from amyloid_yolo_tpu_torch.ops.preprocess import preprocess_tiles
from amyloid_yolo_tpu_torch.parallel import steps
from amyloid_yolo_tpu_torch.parallel.mesh import make_mesh
from amyloid_yolo_tpu_torch.training import TrainConfig, Trainer

from minispec import mini_spec
from torch_port_helpers import numpy_params, port_mini_spec

MAP_RTOL = 2e-4
STAT_RTOL = 1e-4
EVAL_RTOL = 2e-5
GRAD_RTOL = 1e-4
MINI = mini_spec()


@pytest.fixture(scope="module")
def setup():
    spec = port_mini_spec()
    params = numpy_params(MINI, 0)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    t = np.zeros((8, 6), np.float32)
    t[0] = [0, 0, 0.5, 0.5, 0.2, 0.3]
    t[1] = [1, 1, 0.3, 0.6, 0.1, 0.2]
    return spec, params, x, t, np.arange(8) < 2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def test_relabel_bitexact(setup):
    spec, params, *_ = setup
    sd = params_from_jax(params, spec)
    l0, l1 = spec.layers[0], spec.layers[1]
    for i, idx, jidx, transform in (
            (0, darknet._s2d_gather_indices_a(l0.in_ch, l0.out_ch),
             jax_darknet._s2d_gather_indices_a(l0.in_ch, l0.out_ch),
             lambda w: darknet._s2d_transform_conv_a(w)[0]),
            (1, darknet._s2d_gather_indices_b(l1.in_ch, l1.out_ch),
             jax_darknet._s2d_gather_indices_b(l1.in_ch, l1.out_ch),
             darknet._s2d_transform_conv_b)):
        w = sd[f"module_list.{i}.conv_{i}.weight"]
        got = darknet._s2d_relabel(w, idx)
        np.testing.assert_array_equal(got.numpy(), transform(w.numpy()))
        want = np.asarray(jax_darknet._s2d_relabel(jnp.asarray(params[f"conv_{i}"]["w"]), jidx))
        np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


def test_train_forward_and_stats_match_jax_and_plain(setup):
    spec, params, x, *_ = setup
    sd = params_from_jax(params, spec)
    want_maps, want_stats = jax.jit(lambda p, v: jax_darknet.apply(
        p, MINI, v, train=True, s2d_stem=True, bn_form="reduce"))(params, jnp.asarray(x))
    xt = torch.from_numpy(x)
    maps, stats = darknet.apply(sd, spec, xt, train=True, s2d_stem=True, bn_form="reduce")
    plain_maps, plain_stats = darknet.apply(sd, spec, xt, train=True, bn_form="reduce")
    for m, w, p in zip(maps, want_maps, plain_maps):
        assert _rel(m.numpy(), w) < MAP_RTOL
        assert _rel(m.numpy(), p.numpy()) < MAP_RTOL
    assert len(stats) == len(plain_stats) == 2 * len(want_stats)
    for key, st in want_stats.items():
        i = key.split("_")[1]
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            k = f"module_list.{i}.batch_norm_{i}.{ours}"
            assert _rel(stats[k].numpy(), st[theirs]) < STAT_RTOL, k
            assert _rel(stats[k].numpy(), plain_stats[k].numpy()) < STAT_RTOL, k


def test_eval_forward_matches_plain(setup):
    spec, params, x, *_ = setup
    sd = params_from_jax(params, spec)
    xt = torch.from_numpy(x)
    for m, p in zip(darknet.apply(sd, spec, xt, s2d_stem=True), darknet.apply(sd, spec, xt)):
        assert _rel(m.numpy(), p.numpy()) < EVAL_RTOL


def _grads(sd, spec, x, t, mask, s2d, dtype):
    """Loss and gradients: the YOLO loss in float32; in float64 a smooth
    loss of the head maps (``yolo_loss`` builds float32 targets)."""
    p = {k: (v.to(dtype).requires_grad_(True) if k.endswith((".weight", ".bias")) else
             v.to(dtype) if v.is_floating_point() else v) for k, v in sd.items()}
    maps, _ = darknet.apply(p, spec, torch.from_numpy(x).to(dtype), train=True, s2d_stem=s2d,
                            compute_dtype=dtype, bn_form="reduce")
    if dtype == torch.float64:
        w = torch.Generator().manual_seed(1)
        total = sum((m * m + m * torch.randn(m.shape, generator=w, dtype=dtype)).sum()
                    for m in maps)
    else:
        total, _ = yolo_loss(maps, spec, 64, torch.from_numpy(t), torch.from_numpy(mask))
    keys = steps.trainable_keys(p)
    return total, dict(zip(keys, torch.autograd.grad(total, [p[k] for k in keys])))


def test_gradients_match_plain_parameterization_f64(setup):
    spec, params, x, t, mask = setup
    sd = params_from_jax(params, spec)
    l0, g0 = _grads(sd, spec, x, t, mask, False, torch.float64)
    l1, g1 = _grads(sd, spec, x, t, mask, True, torch.float64)
    assert abs(float(l0) - float(l1)) <= 1e-12 * abs(float(l0))
    worst = max(_rel(g1[k].numpy(), g0[k].numpy()) for k in g0)
    assert worst < 1e-9, worst


def test_f32_gradients_match_jax(setup):
    spec, params, x, t, mask = setup

    def loss(p):
        maps, _ = jax_darknet.apply(p, MINI, jnp.asarray(x), train=True, s2d_stem=True,
                                    bn_form="reduce")
        return jax_yolo_loss(maps, MINI, 64, jnp.asarray(t), jnp.asarray(mask))[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    total, got = _grads(params_from_jax(params, spec), spec, x, t, mask, True, torch.float32)
    assert _rel(float(total), float(want_loss)) < MAP_RTOL
    ref = {}
    for key, entry in want.items():
        i = key.split("_")[1]
        if key.startswith("conv_"):
            ref[f"module_list.{i}.conv_{i}.weight"] = np.asarray(entry["w"]).transpose(3, 2, 0, 1)
            if "b" in entry:
                ref[f"module_list.{i}.conv_{i}.bias"] = np.asarray(entry["b"])
        else:
            ref[f"module_list.{i}.batch_norm_{i}.weight"] = np.asarray(entry["scale"])
            ref[f"module_list.{i}.batch_norm_{i}.bias"] = np.asarray(entry["bias"])
    assert set(ref) == set(got)
    for k, w in ref.items():
        err = np.linalg.norm(got[k].numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err < GRAD_RTOL, (k, err)


def test_train_step_runs_the_s2d_forward(setup, monkeypatch):
    """One Adam step, augmentation off: the step runs the s2d stem (once a
    step, only when asked) and its loss is the s2d forward's; through a
    two-entry CPU mesh (the in-process data-parallel step, one stem a
    shard) within 1e-5 of the one-device step."""
    spec, params, x, t, mask = setup
    xu8 = (x * 255).astype(np.uint8)
    xin = preprocess_tiles(torch.from_numpy(xu8), 64)
    opt = steps.make_optimizer(1e-3)
    stems = []
    stem = darknet._s2d_train_stem
    monkeypatch.setattr(darknet, "_s2d_train_stem", lambda *a: stems.append(1) or stem(*a))
    losses = {}
    for s2d, shards in ((True, None), (False, None),
                        (True, steps.MeshShards(make_mesh(devices=["cpu", "cpu"])))):
        sd = params_from_jax(params, spec)
        with torch.no_grad():
            maps, _ = darknet.apply(sd, spec, xin, train=True, s2d_stem=s2d)
            direct = float(yolo_loss(maps, spec, 64, torch.from_numpy(t),
                                     torch.from_numpy(mask))[0])
        state = steps.init_train_state(sd, opt, device="cpu")
        step = steps.make_train_step(spec, opt, augment=False, s2d_stem=s2d)
        del stems[:]
        state, m = step(state, xu8, t, mask, None, 64, shards=shards)
        assert len(stems) == (0 if not s2d else 1 if shards is None else 2)
        losses[s2d, shards is None] = float(m["loss"])
        assert state.step == 1 and all(torch.isfinite(v).all() for v in state.params.values()
                                       if v.is_floating_point())
        if shards is None:
            assert losses[s2d, True] == direct
    assert _rel(losses[True, False], losses[True, True]) < 1e-5


def test_rejects_bnless_stem():
    spec = port_mini_spec()
    object.__setattr__(spec.layers[0], "batch_normalize", False)
    sd = darknet.init_params(torch.Generator().manual_seed(0), spec)
    assert not darknet.s2d_train_stem_qualifies(spec)
    with pytest.raises(ValueError, match="requires BN on layers 0-1"):
        darknet.apply(sd, spec, torch.zeros(1, 64, 64, 3), train=True, s2d_stem=True)


@pytest.fixture
def data_config(tmp_path, monkeypatch):
    # no TensorBoard writer (it imports TensorFlow where installed)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    (tmp_path / "train.txt").write_text("")
    (tmp_path / "names").write_text("CAA\nCored\n")
    cfg = tmp_path / "custom.data"
    cfg.write_text(f"classes=2\ntrain={tmp_path / 'train.txt'}\n"
                   f"valid={tmp_path / 'train.txt'}\nnames={tmp_path / 'names'}\n")
    return str(cfg)


@pytest.mark.parametrize("s2d,spatial,want", [(None, None, True), (False, None, False),
                                              (True, None, True), (None, 2, True),
                                              (True, 2, "trains")])
def test_trainer_resolves_s2d_stem(data_config, tmp_path, s2d, spatial, want):
    """The reference's rule, whatever ``spatial_shard`` is; with ``True``
    on two row shards the Trainer's step trains one finite step."""
    cfg = TrainConfig(data_config=data_config, s2d_stem=s2d, spatial_shard=spatial,
                      logdir=str(tmp_path / "logs"))
    tr = Trainer(cfg, spec=port_mini_spec(), device="cpu")
    if want == "trains":
        assert tr.s2d_stem is True
        imgs = np.random.RandomState(0).randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)
        targets = np.array([[0, 1, 0.5, 0.5, 0.3, 0.2], [1, 0, 0.4, 0.6, 0.2, 0.2]],
                           np.float32)
        run = steps.init_accum_state(tr.state) if tr.accum > 1 else tr.state
        _, m = tr.step_fn(run, imgs, targets, np.ones(2, bool),
                          torch.Generator().manual_seed(0), 64)
        assert tr.state.step == 1 and np.isfinite(float(m["loss"]))
        return
    assert tr.s2d_stem is want
    # the reference's rule on the same spec
    assert want is (s2d if s2d is not None else jax_darknet._check_s2d_spec(MINI) is None)
