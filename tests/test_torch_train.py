"""The UNet fine-tuning step (``fresco_torch.parallel.train``) against
``fresco_tpu.parallel.train`` on the CPU.

The tiny UNet (float32) carries the same weights through
``from_jax_params``; both packages take one AdamW step on the same
latents, context, ``t`` and noise (JAX's own draws, fed to the port).
The loss agrees to 1e-5 relative (summation order).  The step is held in
three parts, each with a bound that does not depend on the machine's
summation order:

- the gradients (read back through the first Adam moment, (1 - b1)·g
  after one step) against JAX's, per tensor, to 2e-5 of that tensor's
  largest |g| (float32 summation order reads at most 5.5e-6 of it);
- the update rule: the port's parameters after the step against AdamW
  applied in float64 numpy to the port's own gradient, with optax's
  defaults, p - lr·(g/(|g| + eps) + wd·p) on the first step, to 1e-6;
- the step against JAX: the port's new parameters against JAX's,
  elementwise, to 1e-6 + lr·δ·eps/(|g| + eps)², with δ the gradient
  bound above.  That is the first step's own sensitivity to the gradient:
  the quotient g/(|g| + eps) has slope eps/(|g| + eps)², about 1/(19·eps)
  at |g| = 3·eps, so a gradient gap far inside δ moves an element whose
  |g| is a few eps by more than 1e-5 of lr (|g| is the smaller of the two
  gradients, 0 where their signs differ).

The decoupled weight decay is held against optax on one tensor over
three steps at lr 0.1 and wd 0.5 to 1e-5 (float32 rounding in another
order reads 2e-6; the decay coupled into the gradient, as Adam's L2
does, moves the result by 0.31); bf16 compute over float32
parameters (``set_compute_dtype``) against the float32 loss to 5e-2
relative.
"""
import inspect

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.diffusion.scheduler import DDPMScheduler as TSched
from fresco_torch.models import unet as tunet
from fresco_torch.models.convert import from_jax_params
from fresco_torch.models.layers import set_compute_dtype
from fresco_torch.parallel import TrainState, make_train_state, train_step
from fresco_tpu.diffusion.scheduler import DDPMScheduler as JSched
from fresco_tpu.models import unet as junet
from fresco_tpu.parallel.train import make_train_state as jmake_train_state
from fresco_tpu.parallel.train import train_step as jtrain_step

LR = 1e-3
CTX = 32  # the tiny text encoder's width (F2: Flax infers the context width)


@pytest.fixture(scope="module")
def tiny():
    """Flax tiny UNet params drawn in numpy (shapes from eval_shape: no
    init compile), norm scales around 1, every other leaf N(0, 0.05)."""
    ju = junet.UNet2DCondition(junet.UNetConfig.tiny(), dtype=jnp.float32)
    shapes = jax.eval_shape(ju.init, jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.int32(0),
                            jnp.zeros((1, 77, CTX)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.normal(0, 0.05, s.shape) + (1.0 if "scale" in jax.tree_util.keystr(p) else 0.0))
        .astype(np.float32), shapes)
    return ju, params


def _torch_unet(params):
    cfg = tunet.UNetConfig.tiny()
    cfg = type(cfg)(**{**cfg.__dict__, "cross_attention_dim": CTX})
    m = tunet.UNet2DCondition(cfg)
    from_jax_params(params, m)
    return m


def _inputs(seed=1, b=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
            rng.standard_normal((b, 77, CTX)).astype(np.float32))


def test_train_step_matches_jax(tiny):
    ju, params = tiny
    lat, ctx = _inputs()
    tx = optax.adamw(LR)
    jstate = jmake_train_state(jax.tree.map(jnp.asarray, params), tx)
    key = jax.random.key(3)
    jstate2, jloss = jax.jit(lambda s, l, c, r: jtrain_step(ju, tx, JSched(), s, l, c, r))(
        jstate, jnp.asarray(lat), jnp.asarray(ctx), key)
    # JAX's own draws for this step (train.py:45-48), fed to the port
    rng_t, rng_n = jax.random.split(jax.random.fold_in(key, jstate.step))
    t = np.asarray(jax.random.randint(rng_t, (2,), 0, 1000))
    noise = np.asarray(jax.random.normal(rng_n, lat.shape, jnp.float32))

    m = _torch_unet(params)
    state = make_train_state(m, lr=LR)
    state2, loss = train_step(state, TSched(), torch.from_numpy(lat), torch.from_numpy(ctx),
                              t=torch.from_numpy(t.copy()), noise=torch.from_numpy(noise.copy()))
    assert state2.step == 1 and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    want = from_jax_params(jax.tree.map(np.asarray, jstate2.params))
    jmu = from_jax_params(jax.tree.map(np.asarray, jstate2.opt_state[0].mu))
    before = from_jax_params(params)
    got = m.state_dict()
    assert set(got) == set(want)
    sig = inspect.signature(optax.adamw).parameters
    b1, eps, wd = sig["b1"].default, sig["eps"].default, sig["weight_decay"].default
    opt_state = state.optimizer.state
    for name, p in m.named_parameters():
        # the first moment after one step is (1 - b1)·g in both packages
        g = opt_state[p]["exp_avg"].numpy().astype(np.float64) / (1 - b1)
        gj = jmu[name].numpy().astype(np.float64) / (1 - b1)
        delta = 2e-5 * np.abs(gj).max()
        assert np.abs(g - gj).max() <= delta, (name, np.abs(g - gj).max(), delta)
        # the update rule on the port's own gradient, in float64
        p0 = before[name].numpy().astype(np.float64)
        rule = p0 - LR * (g / (np.abs(g) + eps) + wd * p0)
        new = got[name].detach().numpy().astype(np.float64)
        assert np.abs(new - rule).max() <= 1e-6, (name, np.abs(new - rule).max())
        # the step against JAX, within the quotient's sensitivity to δ
        gmin = np.where(np.sign(g) == np.sign(gj), np.minimum(np.abs(g), np.abs(gj)), 0.0)
        tol = 1e-6 + LR * delta * eps / (gmin + eps) ** 2
        d = np.abs(new - want[name].numpy())
        assert (d <= tol).all(), (name, (d - tol).max())


def test_adamw_defaults_and_decay_match_optax():
    """optax.adamw's defaults, and its decoupled decay p - lr·(u + wd·p),
    over three steps with a large lr and weight decay."""
    sig = inspect.signature(optax.adamw).parameters
    m = torch.nn.Linear(3, 5)
    opt = make_train_state(m, lr=0.1).optimizer.param_groups[0]
    assert opt["betas"] == (sig["b1"].default, sig["b2"].default)
    assert opt["eps"] == sig["eps"].default and opt["weight_decay"] == sig["weight_decay"].default

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal(p0.shape).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(0.1, weight_decay=0.5)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.AdamW([tp], lr=0.1, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.5)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)


def test_drawn_t_and_noise_follow_seed_and_step(tiny):
    """Without t and noise the step draws them from fold_in(seed, step):
    the same seed and step give the same loss, another step another."""
    _, params = tiny
    lat, ctx = (torch.from_numpy(a) for a in _inputs())
    losses = []
    for step in (0, 0, 1):
        m = _torch_unet(params)
        st = TrainState(m, torch.optim.SGD(m.parameters(), lr=0.0), step)
        losses.append(float(train_step(st, TSched(), lat, ctx, seed=7)[1]))
    assert losses[0] == losses[1] != losses[2]


def test_bf16_compute_over_float32_params(tiny):
    """set_compute_dtype(bf16): float32 parameters, bf16 activations, the
    gradient reaching every float32 parameter; None restores the float32
    forward bit for bit (the serving path has no compute dtype)."""
    _, params = tiny
    lat, ctx = (torch.from_numpy(a) for a in _inputs())
    t = torch.tensor([10, 900])
    noise = torch.from_numpy(np.random.default_rng(2).standard_normal(lat.shape).astype(np.float32))
    m = _torch_unet(params)
    with torch.no_grad():
        ref = m(lat, t, ctx)
    f32_loss = float(train_step(TrainState(m, torch.optim.SGD(m.parameters(), lr=0.0)), TSched(), lat, ctx,
                                t=t, noise=noise)[1])
    set_compute_dtype(m, torch.bfloat16)
    assert m.dtype == torch.bfloat16 and m.conv_in.weight.dtype == torch.float32
    with torch.no_grad():
        assert m(lat, t, ctx).dtype == torch.bfloat16
    st = TrainState(m, torch.optim.SGD(m.parameters(), lr=0.0))
    _, loss = train_step(st, TSched(), lat, ctx, t=t, noise=noise)
    assert abs(float(loss) - f32_loss) <= 5e-2 * f32_loss
    for name, p in m.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, name
    assert float(m.conv_in.weight.grad.abs().sum()) > 0
    set_compute_dtype(m, None)
    with torch.no_grad():
        assert torch.equal(m(lat, t, ctx), ref)
