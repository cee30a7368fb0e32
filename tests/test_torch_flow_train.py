"""GMFlow training and evaluation (``fresco_torch.parallel.flow_train``,
``flow_eval``) against ``fresco_tpu``'s on the CPU.

Tolerances.  The three losses and their metrics: 1e-5 relative (float32,
summation order).  The one-cycle schedule: within 1e-6 of the peak of
optax's at every update count (optax evaluates it in float32: 1.5e-6
relative at the start, where the value is peak / 25).  The clip:
1e-6 relative to ``optax.clip_by_global_norm`` above, below and at the
threshold.  ``flow_train_step`` on the tiny GMFlow (16 channels, 2
layers, 32x32, the same weights through ``from_jax_params``), two steps
of the driver's optimizer, supervised and unsupervised: the losses to
1e-4 relative (the flows agree to ~5e-4 px, tests/test_torch_gmflow.py),
the parameters to 1e-6 absolute.  Where Adam's second moment is under
100·eps the direction g/(sqrt(v) + eps) follows the gradient's rounding
(the downsample convs' biases, which the instance norm after them
cancels, have gradients of pure rounding noise, ~1e-10): there each of
the two updates may take either sign, so those elements are held to
2·(lr_0 + lr_1).  ``validate`` on the tiny GMFlow: epe
to 1e-3 px, the rate metrics to one pixel's share.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.models.convert import from_jax_params
from fresco_torch.models.gmflow import model as tg
from fresco_torch.parallel import flow_eval as te
from fresco_torch.parallel import flow_train as tf
from fresco_tpu.models.gmflow import model as jg
from fresco_tpu.parallel import flow_eval as je
from fresco_tpu.parallel import flow_train as jf

HW = (32, 32)
STEPS, LR = 10, 4e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _flows(rng, b=2, h=12, w=10, n=3):
    gt = (rng.standard_normal((b, h, w, 2)) * 5).astype(np.float32)
    gt[0, 0, 0] = (500.0, 0.0)  # beyond max_flow: masked
    preds = [(gt + rng.standard_normal(gt.shape) * s).astype(np.float32) for s in (4.0, 2.0, 1.0)[:n]]
    valid = (rng.uniform(0, 1, (b, h, w)) > 0.2).astype(np.float32)
    return preds, gt, valid


def test_losses_match_jax(rng):
    preds, gt, valid = _flows(rng)
    for v in (None, valid):
        np.testing.assert_allclose(
            float(tf.epe_loss(_t(preds[-1]), _t(gt), None if v is None else _t(v))),
            float(jf.epe_loss(jnp.asarray(preds[-1]), jnp.asarray(gt), None if v is None else jnp.asarray(v))),
            rtol=1e-5)
        for p in (preds, preds[-1]):
            tl, tm = tf.flow_sequence_loss([_t(x) for x in p] if isinstance(p, list) else _t(p), _t(gt),
                                           None if v is None else _t(v), gamma=0.8)
            jl, jm = jf.flow_sequence_loss([jnp.asarray(x) for x in p] if isinstance(p, list) else jnp.asarray(p),
                                           jnp.asarray(gt), None if v is None else jnp.asarray(v), gamma=0.8)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
            assert set(tm) == set(jm) == {"epe", "1px", "3px", "5px"}
            for k in tm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    img0, img1 = (rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32) for _ in range(2))
    flow = (rng.standard_normal((2, 12, 10, 2)) * 2).astype(np.float32)
    np.testing.assert_allclose(float(tf.photometric_smoothness_loss(_t(img0), _t(img1), _t(flow))),
                               float(jf.photometric_smoothness_loss(jnp.asarray(img0), jnp.asarray(img1),
                                                                    jnp.asarray(flow))), rtol=1e-5)


@pytest.mark.parametrize("steps,pct", [(10, 0.1), (10, 0.3), (7, 0.5)])
def test_onecycle_schedule_matches_optax(steps, pct):
    ours = tf.cosine_onecycle_schedule(steps, 4e-4, pct_start=pct)
    ref = optax.cosine_onecycle_schedule(transition_steps=steps, peak_value=4e-4, pct_start=pct)
    for count in range(steps + 3):
        np.testing.assert_allclose(ours(count), float(ref(jnp.int32(count))), rtol=0, atol=1e-6 * 4e-4,
                                   err_msg=str(count))


@pytest.mark.parametrize("max_norm", [0.5, 3.0, "at"])
def test_clip_matches_optax(rng, max_norm):
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    if max_norm == "at":
        max_norm = float(np.float32(norm))  # not below: scaled by max_norm / norm, as optax does
    ref = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)[0]
    ours = [_t(g) for g in grads]
    got = tf.clip_by_global_norm_(ours, max_norm)
    np.testing.assert_allclose(float(got), norm, rtol=1e-6)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    if max_norm > norm:
        for a, g in zip(ours, grads):
            np.testing.assert_array_equal(a.numpy(), g)


@pytest.fixture(scope="module")
def tiny_gmflow():
    jm = jg.GMFlow(jg.GMFlowConfig.tiny())
    img = jnp.zeros((1, *HW, 3))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), img, img)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.normal(0, 0.1, s.shape) + (1.0 if "scale" in jax.tree_util.keystr(p) else 0.0))
        .astype(np.float32), shapes)
    return jm, params


def _torch_gmflow(params):
    m = tg.GMFlow(tg.GMFlowConfig.tiny())
    from_jax_params(params, m)
    return m


def _pair(seed, b=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]]
    base = 127 + 80 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
    a = np.stack([base, 255 - base, np.roll(base, 5, 0)], -1)[None].repeat(b, 0) + rng.normal(0, 3, (b, *HW, 3))
    img0 = np.clip(a, 0, 255).astype(np.float32)
    img1 = np.clip(np.roll(a, (1, 2), (1, 2)), 0, 255).astype(np.float32)
    flow = np.broadcast_to(np.array([-2.0, -1.0], np.float32), (b, *HW, 2)).copy()
    valid = (rng.uniform(0, 1, (b, *HW)) > 0.1).astype(np.float32)
    return img0, img1, flow, valid


@pytest.mark.parametrize("supervised", [True, False])
def test_flow_train_step_matches_jax(tiny_gmflow, supervised):
    jm, params = tiny_gmflow
    img0, img1, flow, valid = _pair(3)
    steps = max(STEPS, 2)
    sched = optax.cosine_onecycle_schedule(transition_steps=steps, peak_value=LR,
                                           pct_start=min(max(0.05, 1.0 / steps), 0.5))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-4))
    jstate = jf.make_flow_train_state(jax.tree.map(jnp.asarray, params), tx)
    gt = (jnp.asarray(flow), jnp.asarray(valid)) if supervised else (None, None)
    jstep = jax.jit(lambda s, a, b: jf.flow_train_step(jm, tx, s, a, b, *gt))
    m = _torch_gmflow(params)
    state = tf.make_flow_train_state(m, steps=STEPS, lr=LR, warmup_frac=0.05)
    tgt = (_t(flow), _t(valid)) if supervised else (None, None)
    for _ in range(2):
        jstate, jloss = jstep(jstate, jnp.asarray(img0), jnp.asarray(img1))
        state, loss = tf.flow_train_step(state, _t(img0), _t(img1), *tgt)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert state.step == 2 and int(jstate.step) == 2
    want = from_jax_params(jax.tree.map(np.asarray, jstate.params))
    nu = from_jax_params(jax.tree.map(np.asarray, jstate.opt_state[1][0].nu))
    for name, p in m.named_parameters():
        near_eps = np.sqrt(nu[name].numpy() / (1 - 0.999 ** 2)) < 100 * 1e-8
        tol = np.where(near_eps, 2 * (state.schedule(0) + state.schedule(1)), 1e-6)
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert (d <= tol).all(), (name, d.max())


def test_pad_to_multiple_and_metrics_match_jax(rng):
    x = rng.standard_normal((1, 5, 7, 3)).astype(np.float32)
    for mode in ("sintel", "kitti"):
        for factor in (8, 16):
            a, ca = te.pad_to_multiple(x, factor, mode)
            b, cb = je.pad_to_multiple(x, factor, mode)
            np.testing.assert_array_equal(a, b)
            assert ca == cb
            np.testing.assert_array_equal(a[:, ca[0], ca[1]], x)
    pred = (rng.standard_normal((9, 11, 2)) * 20).astype(np.float32)
    gt = (rng.standard_normal((9, 11, 2)) * 20).astype(np.float32)
    valid = (rng.uniform(0, 1, (9, 11)) > 0.3).astype(np.float32)
    for v in (None, valid):
        assert te.flow_metrics(pred, gt, v, speed_buckets=True) == je.flow_metrics(pred, gt, v, speed_buckets=True)


def test_validate_and_flow_fn_match_jax(tiny_gmflow):
    jm, params = tiny_gmflow
    rng = np.random.default_rng(8)
    samples = []
    for i in range(2):
        img = rng.uniform(0, 255, (30, 34, 3)).astype(np.float32)
        gt = (rng.standard_normal((30, 34, 2)) * 8).astype(np.float32)
        valid = None if i == 0 else (rng.uniform(0, 1, (30, 34)) > 0.5).astype(np.float32)
        samples.append((img, np.roll(img, 1, axis=1), gt, valid))
    m = _torch_gmflow(params).eval()
    for kw in ({}, {"speed_buckets": True, "pad_mode": "kitti"}, {"max_samples": 1}):
        ours = te.validate(m, iter(samples), **kw)
        ref = je.validate(jm, params, iter(samples), **kw)
        assert set(ours) == set(ref) and ours["n_pairs"] == ref["n_pairs"]
        n_px = 30 * 34 * ours["n_pairs"]
        for k in ours:
            if np.isnan(ref[k]):  # an empty speed bucket in both
                assert np.isnan(ours[k]), k
            elif k in ("1px", "3px", "5px", "f1_all"):
                assert abs(ours[k] - ref[k]) <= (100.0 if k == "f1_all" else 1.0) / n_px + 1e-9, k
            else:
                assert abs(ours[k] - ref[k]) <= 1e-3, k
    a = np.stack([s[0] for s in samples])
    b = np.stack([s[1] for s in samples])
    got = te.make_flow_fn(m)(a, b)
    ref = je.make_flow_fn(jm, params)(a, b)
    assert got.shape == (2, 30, 34, 2)
    np.testing.assert_allclose(got, ref, atol=2e-3)
