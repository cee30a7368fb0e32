"""The port's checkpoint reader and key maps against the JAX package's.

Converters: the same checkpoint-layout state dict goes to
``fresco_tpu.models.convert`` (a Flax tree) and to the port's converter
(a state dict); ``from_jax_params`` of the Flax tree must equal the
port's state dict bit for bit, in the checkpoint's dtype.  The SD-family
dicts come from the reduced-width, full-SD1.5-topology torch mini-models
of ``tests/test_convert_golden.py`` and ``transformers.CLIPTextModel``;
GMFlow, HED and EGNet (whose reference models are not here) are written
from a seeded port module through the port's inverse map and read back
by the JAX converter, which thereby judges the layout.  Every tensor
value is drawn with numpy from a fixed seed.

Reader: ``read_safetensors`` against ``safetensors.numpy.load_file`` for
F32, F16, BF16 and I64, bit for bit; ``.bin`` with ``state_dict`` /
``model`` wrappers against the JAX ``load_torch_state_dict``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_convert_golden as golden
from fresco_torch.models import convert as TC
from fresco_torch.models.clip_text import CLIPTextConfig as TCLIPConfig
from fresco_torch.models.egnet import EGNet, convert_egnet, egnet_map
from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
from fresco_torch.models.gmflow.convert import convert_gmflow, gmflow_map
from fresco_torch.models.hed import HED, convert_hed, hed_map
from fresco_torch.models.unet import UNetConfig as TUNetConfig
from fresco_torch.models.vae import VAEConfig as TVAEConfig
from fresco_tpu.models import convert as JC
from fresco_tpu.models.egnet import convert_egnet as jax_convert_egnet
from fresco_tpu.models.gmflow.convert import convert_gmflow as jax_convert_gmflow
from fresco_tpu.models.hed import convert_hed as jax_convert_hed

_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(_INT_VIEW[t.element_size()])


def assert_same_state_dict(got: dict, want: dict):
    """Same keys, dtypes, shapes and bits."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(bits(got[k]), bits(want[k])), k


def seeded(sd: dict, dtype=np.float32, seed: int = 0) -> dict:
    """``sd``'s keys and shapes with seeded N(0, 0.1) values in ``dtype``."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(tuple(v.shape), dtype=np.float32) * 0.1).astype(dtype))
            for k, v in sd.items()}


def port_cfg(cls, jax_cfg):
    return cls(**dataclasses.asdict(jax_cfg))


SD_CASES = {
    "unet": (lambda: golden.TUNet(golden.FULL_UCFG), JC.convert_unet, TC.convert_unet,
             lambda: port_cfg(TUNetConfig, golden.FULL_UCFG), golden.FULL_UCFG),
    "controlnet": (lambda: golden.TControlNet(golden.FULL_UCFG, golden.FULL_COND_EMBED), JC.convert_controlnet,
                   lambda sd, cfg, strict: TC.convert_controlnet(sd, cfg, strict, cond_embed=golden.FULL_COND_EMBED),
                   lambda: port_cfg(TUNetConfig, golden.FULL_UCFG), golden.FULL_UCFG),
    "vae": (lambda: golden.TVAE(golden.FULL_VCFG), JC.convert_vae, TC.convert_vae,
            lambda: port_cfg(TVAEConfig, golden.FULL_VCFG), golden.FULL_VCFG),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
@pytest.mark.parametrize("name", sorted(SD_CASES))
def test_sd_converters_match_jax(name, dtype):
    """UNet / ControlNet / VAE at the full SD1.5 topology, reduced widths."""
    make, jax_fn, port_fn, make_cfg, jcfg = SD_CASES[name]
    sd = seeded(make().state_dict(), dtype)
    got = port_fn(sd, make_cfg(), strict=True)
    assert_same_state_dict(got, TC.from_jax_params({"params": jax_fn(sd, jcfg, strict=True)}))


def test_vae_converter_reads_old_attention_names():
    """Pre-0.14 diffusers VAE files name the mid attention query / key /
    value / proj_attn; both packages read them."""
    sd = seeded(golden.TVAE(golden.FULL_VCFG).state_dict())
    old = {}
    for k, v in sd.items():
        for new, legacy in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"), ("to_out.0", "proj_attn")):
            k = k.replace(f"attentions.0.{new}.", f"attentions.0.{legacy}.")
        old[k] = v
    assert any(".proj_attn." in k for k in old)
    got = TC.convert_vae(old, port_cfg(TVAEConfig, golden.FULL_VCFG), strict=True)
    assert_same_state_dict(got, TC.convert_vae(sd, port_cfg(TVAEConfig, golden.FULL_VCFG)))
    assert_same_state_dict(got, TC.from_jax_params({"params": JC.convert_vae(old, golden.FULL_VCFG)}))


def test_strict_mode_raises_only_when_asked():
    """An unused checkpoint key raises in strict mode only, in both packages."""
    sd = seeded(golden.TUNet(golden.FULL_UCFG).state_dict())
    sd["extra.unused.weight"] = torch.zeros(3)
    cfg = port_cfg(TUNetConfig, golden.FULL_UCFG)
    with pytest.raises(ValueError, match="not consumed"):
        TC.convert_unet(sd, cfg, strict=True)
    with pytest.raises(ValueError, match="not consumed"):
        JC.convert_unet(sd, golden.FULL_UCFG, strict=True)
    assert "extra.unused.weight" not in TC.convert_unet(sd, cfg)
    del sd["conv_in.weight"]
    with pytest.raises(KeyError):
        TC.convert_unet(sd, cfg)


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_clip_text_converter_matches_jax(dtype):
    """transformers.CLIPTextModel's layout (``text_model.`` prefix, the
    int64 ``position_ids`` buffer left unused) and the bare layout."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=100, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=77, hidden_act="quick_gelu"))
    raw = hf.state_dict()
    sd = {**seeded({k: v for k, v in raw.items() if v.is_floating_point()}, dtype),
          **{k: v for k, v in raw.items() if not v.is_floating_point()}}
    cfg = TCLIPConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
    jcfg = golden_clip_cfg(cfg)
    want = TC.from_jax_params({"params": JC.convert_clip_text(sd, jcfg)})
    assert_same_state_dict(TC.convert_clip_text(sd, cfg), want)
    bare = {k.removeprefix("text_model."): v for k, v in sd.items()}
    assert_same_state_dict(TC.convert_clip_text(bare, cfg), want)


def golden_clip_cfg(cfg):
    from fresco_tpu.models.clip_text import CLIPTextConfig

    return CLIPTextConfig(**dataclasses.asdict(cfg))


AUX_CASES = {
    "gmflow": (lambda: GMFlow(GMFlowConfig()), gmflow_map, jax_convert_gmflow,
               lambda sd: convert_gmflow(sd, GMFlowConfig(), strict=True)),
    "hed": (HED, hed_map, jax_convert_hed, lambda sd: convert_hed(sd, strict=True)),
    "egnet": (EGNet, egnet_map, jax_convert_egnet, convert_egnet),
}


@pytest.mark.parametrize("name", sorted(AUX_CASES))
def test_aux_inverse_map_read_by_jax(name):
    """A seeded full-width port module, written in the checkpoint layout
    by the port's inverse map, read back by the JAX converter: its tree
    (through ``from_jax_params``) and the port's converter both give the
    module's state dict back, bit for bit."""
    make, key_map, jax_fn, port_fn = AUX_CASES[name]
    with torch.device("meta"):
        m = make()
    own = seeded(m.state_dict(), seed=1)
    ckpt = TC.to_checkpoint(own, key_map)
    if name == "egnet":
        # unused by the forward (trans[0]) and BatchNorm's counter: present in the real file
        ckpt["merge1.trans.0.0.weight"] = torch.zeros(128, 64, 1, 1)
        ckpt["base.bn1.num_batches_tracked"] = torch.tensor(0)
    assert_same_state_dict(TC.from_jax_params({"params": jax_fn(ckpt)}), own)
    assert_same_state_dict(port_fn(ckpt), own)


def test_egnet_strict_sees_the_unused_keys():
    with torch.device("meta"):
        m = EGNet()
    ckpt = TC.to_checkpoint(seeded(m.state_dict(), np.float16), egnet_map)
    ckpt["merge1.trans.0.0.weight"] = torch.zeros(128, 64, 1, 1)
    with pytest.raises(ValueError, match="merge1.trans.0"):
        convert_egnet(ckpt, strict=True)


# ---------------------------------------------------------------- reader
def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5), dtype=np.float32)),
        "f16": torch.from_numpy(rng.standard_normal((7,)).astype(np.float16)),  # odd size: next one unaligned
        "bf16": torch.from_numpy(rng.standard_normal((2, 3, 5), dtype=np.float32)).to(torch.bfloat16),
        "i64": torch.from_numpy(rng.integers(-9, 9, (1, 77))),
        "scalar": torch.tensor(4.0),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = TC.read_safetensors(path)
    want = load_file(path)
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape
        if k == "bf16":
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(bits(got[k]).numpy(), v.view(np.int16))
        else:
            assert got[k].numpy().dtype == v.dtype
            np.testing.assert_array_equal(got[k].numpy(), v)
    assert TC.load_torch_state_dict(path).keys() == got.keys()
    # the port's writer, read back by the package and by the port's reader
    path2 = str(tmp_path / "y.safetensors")
    TC.write_safetensors(path2, tensors)
    again = load_file(path2)
    for k, v in want.items():
        np.testing.assert_array_equal(again[k].reshape(-1).view(np.uint8), v.reshape(-1).view(np.uint8))
        assert torch.equal(bits(TC.read_safetensors(path2)[k]), bits(got[k]))


@pytest.mark.parametrize("wrap", ["plain", "state_dict", "model"])
def test_bin_reader_matches_jax(tmp_path, wrap):
    rng = np.random.default_rng(2)
    sd = {"a.weight": torch.from_numpy(rng.standard_normal((4, 3), dtype=np.float32)),
          "a.bias": torch.from_numpy(rng.standard_normal((4,)).astype(np.float16)),
          "ids": torch.arange(5)}
    obj = {"plain": sd, "state_dict": {"state_dict": sd, "epoch": 3}, "model": {"model": sd, "step": 7}}[wrap]
    path = str(tmp_path / "x.pth")
    torch.save(obj, path)
    got = TC.load_torch_state_dict(path)
    want = JC.load_torch_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert got[k].numpy().dtype == want[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])


class _NotATensor:
    pass


def test_bin_reader_refuses_arbitrary_pickles(tmp_path):
    """``weights_only=True``: a pickle holding an arbitrary object is
    refused (the JAX package's loader would unpickle it)."""
    path = str(tmp_path / "x.bin")
    torch.save({"w": torch.zeros(2), "obj": _NotATensor()}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        TC.load_torch_state_dict(path)
