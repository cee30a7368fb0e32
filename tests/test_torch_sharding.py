"""The port's tensor-parallel split table against the JAX rules: for every
parameter of the tiny UNet, ControlNet, VAE, CLIP text encoder and GMFlow
(the five models of the JAX runner's ``b.params``), the torch dim that
``parallel.sharding.split_table`` splits over ``model`` equals the JAX
``_spec_for`` of its Flax path (``fresco_tpu/parallel/sharding.py:37-68``,
with the divisibility skip) after the kernel transpose: a Flax Dense
``[in, out]`` with ``P(None, "model")`` is torch dim 0, ``P("model", None)``
dim 1, an HWIO conv's ``P(None, None, None, "model")`` OIHW dim 0.  The
Flax tree comes from ``jax.eval_shape`` of the JAX modules' ``init`` (no
parameter is computed).  Exact: a table.

Then ``shard_model_params`` on a one-process view of each model rank: the
ranks' parts put back together give the whole weight (the GEGLU
projection's value and gate halves split alike), and each attention keeps
whole heads."""
import jax
import jax.numpy as jnp
import pytest
import torch

from fresco_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from fresco_torch.models.controlnet import ControlNet
from fresco_torch.models.convert import flax_items, torch_key
from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
from fresco_torch.models.layers import init_flax_default_
from fresco_torch.models.unet import UNet2DCondition, UNetConfig
from fresco_torch.models.vae import AutoencoderKL, VAEConfig
from fresco_torch.core import comm
from fresco_torch.parallel.sharding import shard_model_params, split_table, tp_plan
from fresco_tpu.models import clip_text as jclip
from fresco_tpu.models import controlnet as jcn
from fresco_tpu.models import unet as junet
from fresco_tpu.models import vae as jvae
from fresco_tpu.models.gmflow import model as jgm
from fresco_tpu.parallel.sharding import _spec_for

TINY_COND = (4, 4, 8, 8)
CTX = 32


def _jax_tree(name):
    key, img = jax.random.key(0), jnp.zeros((1, 64, 64, 3))
    if name == "vae":
        return jax.eval_shape(jvae.AutoencoderKL(jvae.VAEConfig.tiny(), dtype=jnp.float32).init, key, img)
    if name == "text":
        mod = jclip.CLIPTextEncoder(jclip.CLIPTextConfig.tiny(), dtype=jnp.float32)
        return jax.eval_shape(mod.init, key, jnp.zeros((1, 77), jnp.int32))
    if name == "gmflow":
        return jax.eval_shape(jgm.GMFlow(jgm.GMFlowConfig.tiny()).init, key, img, img)
    ucfg = junet.UNetConfig.tiny()
    latent, ctx = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 77, CTX))
    if name == "unet":
        mod = junet.UNet2DCondition(ucfg, dtype=jnp.float32)
        return jax.eval_shape(mod.init, jax.random.key(0), latent, jnp.int32(0), ctx)
    mod = jcn.ControlNet(ucfg, dtype=jnp.float32, cond_embed_channels=TINY_COND)
    return jax.eval_shape(mod.init, jax.random.key(0), latent, jnp.int32(0), ctx, jnp.zeros((1, 64, 64, 3)))


def _port(name):
    if name == "vae":
        return AutoencoderKL(VAEConfig.tiny())
    if name == "text":
        return CLIPTextEncoder(CLIPTextConfig.tiny())
    if name == "gmflow":
        return GMFlow(GMFlowConfig.tiny())
    cfg = UNetConfig.tiny()
    cfg = type(cfg)(**{**cfg.__dict__, "cross_attention_dim": CTX})
    return UNet2DCondition(cfg) if name == "unet" else ControlNet(cfg, TINY_COND)


def _table_against_jax(name, model):
    """Assert the port's split table equal to the JAX rule, leaf by leaf;
    returns the table."""
    port = _port(name)
    table = split_table(port, name, model)
    kernels = 0
    for path, leaf in flax_items(_jax_tree(name)):
        key = torch_key(path)
        w = port.get_parameter(key)
        if path[-1] != "kernel":
            assert key not in table
            continue
        kernels += 1
        shape = tuple(leaf.shape)
        spec = tuple(_spec_for(path, leaf))
        want = None
        if "model" in spec:
            ax = spec.index("model")
            if shape[ax] % model == 0:
                want = {(2, 1): 0, (2, 0): 1, (4, 3): 0}[(len(shape), ax)]
        assert table[key] == want, (path, spec, table[key])
        if want is not None:
            assert w.shape[want] == shape[ax]
    assert kernels == len(table)
    return table


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", ["unet", "controlnet"])
def test_split_table_equals_jax_spec_for(name, model):
    table = _table_against_jax(name, model)
    assert len(table) > 20
    assert any(d is not None for d in table.values())


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", ["vae", "text", "gmflow"])
def test_split_table_of_vae_text_gmflow_equals_jax_spec_for(name, model):
    """The VAE's, the text encoder's and GMFlow's tables, JAX's
    ``_spec_for`` walked over their tiny Flax trees: the row rule's
    ``mlp_fc2`` and ``merge`` / ``mlp_2`` split by input features, the
    decoder's 3-channel ``conv_out`` and GMFlow's ``downsample`` and
    ``upsampler`` convs whole.  Then the forms as applied: row forms where
    the rule splits by rows, ``row_scatter`` behind a single-head attention
    whose ``q/k/v`` stay whole."""
    _table_against_jax(name, model)
    table, forms = tp_plan(_port(name), model, name)
    rows = {k.rsplit(".", 1)[0] for k, d in table.items() if d == 1}
    assert rows == {n for n, (mode, _) in forms.items() if mode.startswith("row")}
    if name == "text":
        assert table["layers_0.mlp_fc2.weight"] == 1 and forms["layers_0.mlp_fc2"][0] == "row"
        assert forms["layers_0.self_attn.out_proj"][0] == "row" and table["layers_0.self_attn.q_proj.weight"] == 0
    if name == "vae":
        assert table["decoder.conv_out.weight"] is None and table["encoder.conv_out.weight"] == 0
        assert table["decoder.mid_attn.to_q.weight"] is None and forms["decoder.mid_attn.to_out"][0] == "row_scatter"
    if name == "gmflow":
        layer = "transformer.layers_0_cross_attn_ffn"
        assert table[f"{layer}.q_proj.weight"] is None and forms[f"{layer}.merge"][0] == "row_scatter"
        assert forms[f"{layer}.mlp_0"][0] == "column" and forms[f"{layer}.mlp_2"][0] == "row"
        assert table["backbone.layer2_0.downsample.weight"] is None and table["upsampler_0.weight"] is None


@pytest.mark.parametrize("name", ["unet", "controlnet"])
def test_shard_model_params_parts_rebuild_the_whole(name):
    whole = init_flax_default_(_port(name), torch.Generator().manual_seed(0))
    full = {k: v.detach().clone() for k, v in whole.state_dict().items()}
    parts = []
    for r in range(2):
        m = _port(name)
        m.load_state_dict(full)
        table = shard_model_params(m, comm.Mesh(1, 2, r), name)
        parts.append({k: v.detach() for k, v in m.state_dict().items()})
        assert m.down_0_attn_0.block.attn1.heads == 1 and m.down_0_attn_0.block.attn2.heads == 1
    for key, dim in table.items():
        if dim is None:
            assert torch.equal(parts[0][key], full[key]) and torch.equal(parts[1][key], full[key])
            continue
        if key.endswith("ff_geglu.proj.weight"):
            val, gate = full[key].chunk(2, 0)
            for r in range(2):
                want = torch.cat([val.chunk(2, 0)[r], gate.chunk(2, 0)[r]])
                assert torch.equal(parts[r][key], want)
            continue
        assert torch.equal(torch.cat([parts[0][key], parts[1][key]], dim), full[key]), key
