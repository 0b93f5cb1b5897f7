"""The port's train steps (``parallel/steps.py``) against the JAX package's:
the optimizer against optax, one ``make_train_step``, five micro-batches of
``make_accum_train_step`` with N = 2, the EMA recurrence, and the
parameters held between applies.  Mini spec, 96² uint8 tiles resized to
64, augmentation off, float32.

Tolerances:

* the optimizer alone (same gradients in): parameters within 1e-6 (Adam's
  float32 arithmetic in two orders);
* losses within a relative 1e-5 (``test_torch_train_forward.py``'s
  forward tolerance), BN running statistics within a relative 1e-4 of
  each tensor's largest value;
* parameters after an Adam apply: Adam's step ``lr·m̂/√v̂`` does not
  depend on the gradient's scale, so an element whose gradient (or whose
  m̂, where this step's gradient cancels the last ones) is ~0 next to the
  tensor's others, and so known to the two libraries only to their
  rounding, still moves by up to ~lr, and the two copies part by up to
  ``2·lr``.  So each parameter must agree within 1e-5 on all but
  ``FLIP_SHARE`` (0.1 %) of its elements, and within ``2·lr`` per apply
  everywhere.

Over several applies those parted elements change the next gradients, and
the two runs drift apart (on this spec 70 % of one layer's weights differ
by more than 1e-5 after three applies, though each gradient agrees to a
relative 8e-6).  So the five accumulation micro-batches are held one
transition at a time: before each, the port's tensors (parameters, Adam's
moments and count, the gradient sum) are set to the JAX run's, and the
transition is compared; the counters (``step``, ``seen``, the micro-batch
and apply counts) run free.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amyloid_yolo_tpu.parallel import steps as jax_steps
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.parallel import steps

from minispec import mini_spec
from torch_port_helpers import jax_params_np, port_mini_spec

LR = 1e-3
LOSS_RTOL = 1e-5
STAT_RTOL = 1e-4
PARAM_ATOL = 1e-5
FLIP_SHARE = 1e-3
MINI = mini_spec()


def _batch(seed, b=2, side=96):
    r = np.random.RandomState(seed)
    imgs = r.randint(0, 256, (b, side, side, 3)).astype(np.uint8)
    n = 4 * b
    t = np.zeros((n, 6), np.float32)
    t[:, 0] = np.repeat(np.arange(b), 4)
    t[:, 1] = r.randint(0, 2, n)
    t[:, 2:4] = r.rand(n, 2) * 0.8 + 0.1
    t[:, 4:6] = r.rand(n, 2) * 0.3 + 0.05
    mask = r.rand(n) > 0.2
    return imgs, t, mask


def _jax_params_as_port(params):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in
            params_from_jax(jax.tree.map(np.asarray, params), port_mini_spec()).items()}


def _assert_params(got, jax_params, applies):
    want = _jax_params_as_port(jax_params)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got[k].detach().cpu()
        if k.endswith(("running_mean", "running_var")):
            rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
            assert rel <= STAT_RTOL, (k, rel)
            continue
        diff = (g - w).abs()
        assert float(diff.max()) <= 2 * LR * applies * 1.001, (k, float(diff.max()))
        far = int((diff > PARAM_ATOL).sum())
        assert far <= FLIP_SHARE * diff.numel(), (k, far, diff.numel())


def _states(seed, optimizer_kw=None, ema=False):
    params = jax_params_np(MINI, seed, bn_noise=True, jit=True)
    jopt = jax_steps.make_optimizer(LR, **(optimizer_kw or {}))
    jstate = jax_steps.init_train_state(jax.tree.map(jnp.asarray, params), jopt, ema=ema)
    opt = steps.make_optimizer(LR, **(optimizer_kw or {}))
    state = steps.init_train_state(params_from_jax(params, port_mini_spec()), opt, ema=ema,
                                   device="cpu")
    return jopt, jstate, opt, state


def test_make_train_step_matches_jax():
    jopt, jstate, opt, state = _states(0, ema=True)
    jstep = jax_steps.make_train_step(MINI, jopt, augment=False, image_layout="nhwc",
                                      ema_decay=0.99)
    step = steps.make_train_step(port_mini_spec(), opt, augment=False, ema_decay=0.99)
    imgs, t, mask = _batch(0)
    jstate, jm = jstep(jstate, jnp.asarray(imgs), jnp.asarray(t), jnp.asarray(mask),
                       jax.random.PRNGKey(0), 64)
    state, m = step(state, imgs, t, mask, None, 64)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    assert set(m) == set(jm)
    assert (state.step, state.seen) == (int(jstate.step), int(jstate.seen)) == (1, 2)
    _assert_params(state.params, jstate.params, applies=1)
    _assert_params(state.ema, jstate.ema, applies=1)
    assert all(p.grad is None for p in state.optimizer.param_groups[0]["params"])


def _to_port_tree(tree):
    """A JAX trainable-parameter tree (gradients, Adam moments) → the
    port's state-dict keys (OIHW)."""
    out = {}
    for i in MINI.conv_indices:
        out[f"module_list.{i}.conv_{i}.weight"] = np.asarray(
            tree[f"conv_{i}"]["w"]).transpose(3, 2, 0, 1)
        if MINI.layers[i].batch_normalize:
            out[f"module_list.{i}.batch_norm_{i}.weight"] = np.asarray(tree[f"bn_{i}"]["scale"])
            out[f"module_list.{i}.batch_norm_{i}.bias"] = np.asarray(tree[f"bn_{i}"]["bias"])
        else:
            out[f"module_list.{i}.conv_{i}.bias"] = np.asarray(tree[f"conv_{i}"]["b"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


@torch.no_grad()
def _sync(astate, jastate):
    """Set the port's parameters, Adam state and gradient sum to the JAX
    run's; counters are left alone."""
    st, jst = astate.inner, jastate.inner
    for k, v in _jax_params_as_port(jst.params).items():
        st.params[k].copy_(v)
    adam = jst.opt_state[0]
    mu, nu, grads = _to_port_tree(adam.mu), _to_port_tree(adam.nu), _to_port_tree(
        jastate.grad_sum)
    for k in steps.trainable_keys(st.params):
        p = st.params[k]
        if int(adam.count):
            st.optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                     "exp_avg": mu[k].clone(), "exp_avg_sq": nu[k].clone()}
        p.grad = grads[k].clone()


@pytest.fixture(scope="module")
def accum_runs():
    """Five micro-batches with N = 2, one synced transition each: per step
    the two losses and ``applied`` flags, the port's parameters before and
    after, and the JAX state after."""
    jopt, jstate, opt, state = _states(1)
    jstep = jax_steps.make_accum_train_step(MINI, jopt, 2, augment=False,
                                            image_layout="nhwc")
    step = steps.make_accum_train_step(port_mini_spec(), opt, 2, augment=False)
    jastate = jax_steps.init_accum_state(jstate)
    astate = steps.init_accum_state(state)
    rows = []
    for i in range(5):
        _sync(astate, jastate)
        before = {k: v.detach().clone() for k, v in astate.inner.params.items()}
        imgs, t, mask = _batch(10 + i)
        jastate, jm = jstep(jastate, jnp.asarray(imgs), jnp.asarray(t), jnp.asarray(mask),
                            jax.random.PRNGKey(i), 64)
        astate, m = step(astate, imgs, t, mask, None, 64)
        rows.append({"loss": (float(m["loss"]), float(jm["loss"])),
                     "applied": (m["applied"], float(jm["applied"])),
                     "before": before,
                     "after": {k: v.detach().clone() for k, v in astate.inner.params.items()},
                     "jax": jax.tree.map(np.asarray, jastate.inner.params),
                     "counters": ((astate.inner.step, astate.inner.seen, astate.micro),
                                  (int(jastate.inner.step), int(jastate.inner.seen),
                                   int(jastate.micro)))})
    return rows, jastate, astate


def test_accum_steps_losses_and_schedule_match_jax(accum_runs):
    rows, _, _ = accum_runs
    assert [r["applied"][0] for r in rows] == [1.0, 0.0, 1.0, 0.0, 1.0]
    assert [r["applied"][1] for r in rows] == [1.0, 0.0, 1.0, 0.0, 1.0]
    for i, r in enumerate(rows):
        np.testing.assert_allclose(r["loss"][0], r["loss"][1], rtol=LOSS_RTOL)
        assert r["counters"][0] == r["counters"][1] == (i + 1, 2 * (i + 1), i + 1)


def test_accum_steps_transitions_match_jax(accum_runs):
    rows, jastate, astate = accum_runs
    for r in rows:
        _assert_params(r["after"], r["jax"], applies=1)
    st = astate.inner
    assert steps.applies_done(st.optimizer) == int(jastate.inner.opt_state[0].count) == 3
    # micro-batch 4 applied: nothing left in the sum, as the reference's buffer
    assert all(p.grad is None for p in st.optimizer.param_groups[0]["params"])
    assert all(float(jnp.abs(g).max()) == 0.0 for g in jax.tree.leaves(jastate.grad_sum))


def test_params_held_between_applies(accum_runs):
    """Micro-batches 1 and 3 do not apply: trainable parameters stay, BN
    running statistics move; 0, 2 and 4 apply."""
    rows, _, _ = accum_runs
    for r in rows:
        for k, v in r["after"].items():
            same = torch.equal(v, r["before"][k])
            if k.endswith((".weight", ".bias")) and r["applied"][0] == 0.0:
                assert same, k
            elif k.endswith("running_mean"):
                assert not same, k  # every micro-batch
    for r in rows[::2]:
        moved = sum(not torch.equal(r["after"][k], r["before"][k])
                    for k in steps.trainable_keys(r["after"]))
        assert moved == len(steps.trainable_keys(r["after"]))


@pytest.mark.parametrize("kw", [{}, {"grad_clip_norm": 0.05}, {"grad_clip_norm": 1e3},
                                {"burn_in": 4}])
def test_optimizer_matches_optax(kw):
    """Three applies on the same gradients: plain Adam, clipping that
    triggers and one that does not, and burn-in."""
    r = np.random.RandomState(0)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    p0 = [r.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(0.1 * r.randn(*s)).astype(np.float32) for s in shapes] for _ in range(3)]
    tx = jax_steps.make_optimizer(LR, **kw)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    opt_cfg = steps.make_optimizer(LR, **kw)
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
    opt = opt_cfg.init(tp)
    for gs in grads:
        upd, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g.copy())
        opt_cfg.apply(opt)
    for p, q in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=0, atol=1e-6)
    assert steps.applies_done(opt) == 3
    if "burn_in" in kw:
        assert opt_cfg.lr_at(0) == pytest.approx(LR * (1 / 4) ** 4, rel=1e-6)
        assert opt_cfg.lr_at(3) == opt_cfg.lr_at(10) == pytest.approx(LR, rel=1e-6)


def test_ema_recurrence_matches_jax():
    r = np.random.RandomState(0)
    ema = {"a": r.randn(5).astype(np.float32), "b": r.randn(2, 3).astype(np.float32)}
    for t in (0, 3, 50, 10_000):
        params = {k: v + r.randn(*v.shape).astype(np.float32) for k, v in ema.items()}
        ref = jax.jit(functools.partial(jax_steps._ema_update, decay=0.999))(
            {k: jnp.asarray(v) for k, v in ema.items()},
            {k: jnp.asarray(v) for k, v in params.items()}, step=t)
        got = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
        steps._ema_update(got, {k: torch.from_numpy(v) for k, v in params.items()}, 0.999, t)
        for k in ema:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6)
        ema = {k: v.numpy() for k, v in got.items()}
    # the ramp: at t = 0 the decay is 1/10, late it is the configured one
    e = {"x": torch.zeros(1)}
    steps._ema_update(e, {"x": torch.ones(1)}, 0.999, 0)
    np.testing.assert_allclose(e["x"].numpy(), [0.9], rtol=1e-6)


def test_grad_step_and_eval_forward():
    """``make_grad_step`` gives the gradient sum the accumulation step builds
    in ``.grad`` on a micro-batch that does not apply (bit for bit), and
    leaves the parameters alone; ``make_eval_forward`` decodes the
    eval-mode maps."""
    params = params_from_jax(jax_params_np(MINI, 2, bn_noise=True, jit=True), port_mini_spec())
    imgs, t, mask = _batch(2)
    loss, grads, new_stats = steps.make_grad_step(port_mini_spec())(params, imgs, t, mask, 64)
    assert set(grads) == set(steps.trainable_keys(params))
    assert not any(v.requires_grad for v in params.values())
    astate = steps.init_accum_state(steps.init_train_state(params, steps.make_optimizer(),
                                                           device="cpu"))
    astate.micro = 1  # a micro-batch between applies
    astate, m = steps.make_accum_train_step(port_mini_spec(), steps.make_optimizer(), 2,
                                            augment=False)(astate, imgs, t, mask, None, 64)
    assert m["applied"] == 0.0 and float(m["loss"]) == float(loss)
    for k, g in grads.items():
        assert torch.equal(astate.inner.params[k].grad, g), k
    for k, v in new_stats.items():
        assert torch.equal(astate.inner.params[k], v), k
    dec = steps.make_eval_forward(port_mini_spec())(params, imgs, 64)
    assert tuple(dec.shape) == (2, 3 * (4 ** 2 + 8 ** 2 + 16 ** 2), 7)
    assert torch.isfinite(dec).all()
