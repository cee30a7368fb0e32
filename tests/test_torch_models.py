"""The port's models against fresco_tpu's at tiny widths on the CPU, with
the same weights carried across by ``from_jax_params``; the full-width
key / shape bijection of that map, checked on the meta device.

Weights are Flax's random init plus seeded numpy noise (so the ControlNet
zero convs are not zero).  Everything runs in float32; tolerance 1e-4
absolute (1e-3 relative) on outputs of O(1): the same math, with
convolution and matmul summation orders that differ between XLA and
PyTorch's CPU kernels.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fresco_torch.attention.fresco_attention import FrescoAttnParams as TAttn
from fresco_torch.models import clip_text as tclip
from fresco_torch.models import controlnet as tcn
from fresco_torch.models import unet as tunet
from fresco_torch.models import vae as tvae
from fresco_torch.models.convert import flax_items, from_jax_params, torch_key, torch_shape
from fresco_tpu.attention.fresco_attention import FrescoAttnParams as JAttn
from fresco_tpu.models import clip_text as jclip
from fresco_tpu.models import controlnet as jcn
from fresco_tpu.models import unet as junet
from fresco_tpu.models import vae as jvae

ATOL, RTOL = 1e-4, 1e-3
TINY_COND = (4, 4, 8, 8)


def jax_tiny_models(seed: int = 0):
    """Flax tiny models (float32) and their params as numpy trees, with
    every leaf perturbed by N(0, 0.05)."""
    ucfg, vcfg, ccfg = junet.UNetConfig.tiny(), jvae.VAEConfig.tiny(), jclip.CLIPTextConfig.tiny()
    mods = dict(
        unet=junet.UNet2DCondition(ucfg, dtype=jnp.float32),
        vae=jvae.AutoencoderKL(vcfg, dtype=jnp.float32),
        controlnet=jcn.ControlNet(ucfg, dtype=jnp.float32, cond_embed_channels=TINY_COND),
        text=jclip.CLIPTextEncoder(ccfg, dtype=jnp.float32),
    )
    ks = jax.random.split(jax.random.key(seed), 4)
    latent, img = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 64, 64, 3))
    ctx = jnp.zeros((1, 77, ccfg.hidden_size))
    params = dict(
        unet=jax.jit(mods["unet"].init)(ks[0], latent, jnp.int32(0), ctx),
        vae=jax.jit(mods["vae"].init)(ks[1], img),
        controlnet=jax.jit(mods["controlnet"].init)(ks[2], latent, jnp.int32(0), ctx, img),
        text=jax.jit(mods["text"].init)(ks[3], jnp.zeros((1, 77), jnp.int32)),
    )
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(np.float32), params)
    return mods, params


def torch_tiny_models(params):
    """The port's tiny models (float32, CPU) loaded from Flax params."""
    ccfg = tclip.CLIPTextConfig.tiny()
    ucfg = tunet.UNetConfig.tiny()
    ucfg = type(ucfg)(**{**ucfg.__dict__, "cross_attention_dim": ccfg.hidden_size})
    mods = dict(unet=tunet.UNet2DCondition(ucfg), vae=tvae.AutoencoderKL(tvae.VAEConfig.tiny()),
                controlnet=tcn.ControlNet(ucfg, TINY_COND), text=tclip.CLIPTextEncoder(ccfg))
    for name, m in mods.items():
        from_jax_params(params[name], m)
        m.eval()
    return mods


@pytest.fixture(scope="module")
def models():
    jm, params = jax_tiny_models()
    return jm, params, torch_tiny_models(params)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b.detach() if isinstance(b, torch.Tensor) else b),
                               np.asarray(a), atol=atol, rtol=RTOL)


def test_clip_text(models):
    jm, params, tm = models
    ids = np.random.default_rng(1).integers(0, 1000, (3, 77)).astype(np.int32)
    for skip in (0, 1):
        ref = jm["text"].apply(params["text"], jnp.asarray(ids), clip_skip=skip)
        out = tm["text"](_t(ids).long(), clip_skip=skip)
        _close(ref, out)


def test_vae_encode_decode(models):
    jm, params, tm = models
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jmean, jlogvar = jm["vae"].apply(params["vae"], jnp.asarray(x), method=jm["vae"].encode_moments)
    tmean, tlogvar = tm["vae"].encode_moments(_t(x))
    _close(jmean, tmean)
    _close(jlogvar, tlogvar)
    # posterior noise: the one JAX draws, handed to the port
    rng_enc = jax.random.key(5)
    noise = jax.random.normal(rng_enc, jmean.shape, jnp.float32)
    ref = jm["vae"].apply(params["vae"], jnp.asarray(x), rng=rng_enc, method=jm["vae"].encode)
    out = tm["vae"].encode(_t(x), _t(noise))
    _close(ref, out)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    _close(jm["vae"].apply(params["vae"], jnp.asarray(z), method=jm["vae"].decode),
           tm["vae"].decode(_t(z)), atol=5e-4)


def test_controlnet(models):
    jm, params, tm = models
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    cond = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jdown, jmid = jm["controlnet"].apply(params["controlnet"], jnp.asarray(lat), jnp.int32(500),
                                         jnp.asarray(ctx), jnp.asarray(cond), 0.7)
    emb = tcn.embed_cond(tm["controlnet"], _t(cond))
    _close(jcn.embed_cond(jm["controlnet"], params["controlnet"], jnp.asarray(cond)), emb)
    with torch.no_grad():
        tdown, tmid = tm["controlnet"](_t(lat), 500, _t(ctx), emb, 0.7, cond_is_embedded=True)
    assert len(jdown) == len(tdown)
    for a, b in zip(jdown, tdown):
        _close(a, b)
    _close(jmid, tmid)


def _fresco_params(rng, chunk, f, hw, c, n_layers, jax_side: bool):
    mask = np.concatenate([np.ones((1, hw), bool), rng.uniform(0, 1, (f - 1, hw)) > 0.5])
    refs = [rng.standard_normal((chunk * f, hw, c)).astype(np.float32) for _ in range(n_layers)]
    fwd = np.stack([rng.permutation(hw) for _ in range(f)])
    bwd = np.argsort(fwd, axis=1)
    tmask = rng.uniform(0, 1, (hw, f, f)) > 0.3
    tmask[:, np.arange(f), np.arange(f)] = True
    flat = mask.reshape(-1)
    perm = np.argsort(~flat, kind="stable")[: 2 * hw]
    if jax_side:
        return JAttn(cf_masks={hw: jnp.asarray(mask)},
                     cf_perms={hw: (jnp.asarray(perm.astype(np.int32)), jnp.asarray(flat[perm]))},
                     ref_features=tuple(jnp.asarray(r) for r in refs),
                     trajectories={hw: (jnp.asarray(fwd.astype(np.int32)), jnp.asarray(bwd.astype(np.int32)),
                                        jnp.asarray(tmask))},
                     use_intra=jnp.array(True), use_inter=jnp.array(True))
    return TAttn(cf_masks={hw: _t(mask)}, cf_perms={hw: (_t(perm), _t(flat[perm]))},
                 ref_features=tuple(_t(r) for r in refs),
                 trajectories={hw: (_t(fwd), _t(bwd), _t(tmask))}, use_intra=True, use_inter=True)


@pytest.mark.parametrize("with_fresco", [False, True])
def test_unet_hooks(models, with_fresco):
    """FRESCO attention params, the guidance hook, return_up_features and
    the reference-feature capture."""
    jm, params, tm = models
    chunk, f = 2, 3
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((chunk * f, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((chunk * f, 77, 32)).astype(np.float32)
    ctrl = jm["controlnet"].apply(params["controlnet"], jnp.asarray(lat), jnp.int32(900),
                                  jnp.asarray(ctx), jnp.asarray(rng.uniform(0, 1, (chunk * f, 64, 64, 3))))
    n_layers = junet.UNet2DCondition.num_fresco_layers(jm["unet"].cfg)
    fresco_seed = int(rng.integers(1 << 30))
    jf = _fresco_params(np.random.default_rng(fresco_seed), chunk, f, 64, 8, n_layers, True) \
        if with_fresco else None
    tf = _fresco_params(np.random.default_rng(fresco_seed), chunk, f, 64, 8, n_layers, False) \
        if with_fresco else None

    def jguide(stage, x):
        return x * 1.1 + 0.01 * stage

    (jeps, jup), state = jm["unet"].apply(
        params["unet"], jnp.asarray(lat), jnp.int32(900), jnp.asarray(ctx),
        controlnet_residuals=ctrl, fresco=jf, guidance_fn=jguide, return_up_features=True,
        mutable=["intermediates"])
    refs = []
    with torch.no_grad():
        teps, tup = tm["unet"](_t(lat), 900, _t(ctx),
                               controlnet_residuals=(tuple(_t(r) for r in ctrl[0]), _t(ctrl[1])),
                               fresco=tf, guidance_fn=lambda s, x: x * 1.1 + 0.01 * s,
                               return_up_features=True, capture_refs=refs)
    _close(jeps, teps, atol=5e-4)
    assert len(jup) == len(tup)
    for a, b in zip(jup, tup):
        _close(a, b)
    jrefs = [v[0] for _, v in sorted(
        jax.tree_util.tree_flatten_with_path(state["intermediates"], is_leaf=lambda x: isinstance(x, tuple))[0],
        key=lambda kv: jax.tree_util.keystr(kv[0]))]
    assert len(refs) == len(jrefs) == n_layers
    for a, b in zip(jrefs, refs):
        _close(a, b)


FULL = dict(
    unet=lambda: (junet.UNet2DCondition(junet.UNetConfig()),
                  lambda m, k: m.init(k, jnp.zeros((1, 8, 8, 4)), jnp.int32(0), jnp.zeros((1, 77, 768))),
                  lambda: tunet.UNet2DCondition(tunet.UNetConfig())),
    controlnet=lambda: (jcn.ControlNet(junet.UNetConfig()),
                        lambda m, k: m.init(k, jnp.zeros((1, 8, 8, 4)), jnp.int32(0), jnp.zeros((1, 77, 768)),
                                            jnp.zeros((1, 64, 64, 3))),
                        lambda: tcn.ControlNet(tunet.UNetConfig())),
    vae=lambda: (jvae.AutoencoderKL(jvae.VAEConfig()),
                 lambda m, k: m.init(k, jnp.zeros((1, 64, 64, 3))),
                 lambda: tvae.AutoencoderKL(tvae.VAEConfig())),
    text=lambda: (jclip.CLIPTextEncoder(jclip.CLIPTextConfig()),
                  lambda m, k: m.init(k, jnp.zeros((1, 77), jnp.int32)),
                  lambda: tclip.CLIPTextEncoder(tclip.CLIPTextConfig())),
)


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_key_bijection(name):
    """Every full-width Flax parameter maps to exactly one state-dict entry
    of the right shape (abstract shapes only: nothing is materialized)."""
    jmod, init, tmod = FULL[name]()
    shapes = jax.eval_shape(lambda k: init(jmod, k), jax.random.key(0))
    with torch.device("meta"):
        module = tmod()
    sd = {torch_key(p): torch.empty(torch_shape(p, tuple(leaf.shape)), device="meta")
          for p, leaf in flax_items(shapes)}
    own = module.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    module.load_state_dict(sd, strict=True, assign=True)
    n = sum(int(np.prod(v.shape)) for v in own.values())
    assert n > {"unet": 8e8, "controlnet": 3e8, "vae": 8e7, "text": 1.2e8}[name]
