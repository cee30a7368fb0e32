"""Weights in through the port's entry points, against the JAX package.

* ``_maybe_load_pretrained`` on a directory in ``scripts/fetch_weights.py``'s
  layout (SD1.5 UNet as float16 ``.safetensors``, VAE as ``.bin``, CLIP
  text with its int64 ``position_ids``, ``sd-controlnet-hed``, GMFlow
  wrapped in ``{"model": ...}``), at the reduced widths of
  ``tests/test_convert_golden.py``, against the JAX ``_maybe_load_pretrained``
  with the same configs: the same models load, bit for bit
  (``from_jax_params`` of the JAX trees); ``vae_path`` overrides
  ``sd_path/vae``; a missing file leaves that model's random weights.
* LoRA: ``merge_lora`` against the JAX ``merge_lora`` on the same kohya
  dict (UNet attention, feed-forward and mid block, the text encoder,
  ``alpha`` present and absent, float32 and float16 weights).  The delta is
  a float32 product, summed in another order by numpy and torch: float32
  weights agree to 1e-6 absolute, float16 ones to one float16 ulp.
  ``build_models(lora_path=...)`` moves exactly the targeted weights, by
  the delta (bit for bit against the same arithmetic).
* The control detector: HED, EGNet, MiDaS, M-LSD and OpenPose load from
  their checkpoints, bit for bit; the detectors fall back to canny (or
  none) where their checkpoint is absent.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import test_convert_golden as golden
from fresco_torch.core.config import FrescoConfig
from fresco_torch.models import convert as TC
from fresco_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from fresco_torch.models.controlnet import ControlNet
from fresco_torch.models.gmflow import GMFlow, GMFlowConfig
from fresco_torch.models.gmflow.convert import gmflow_map
from fresco_torch.models.lora import merge_lora
from fresco_torch.models.unet import UNet2DCondition, UNetConfig
from fresco_torch.models.vae import AutoencoderKL, VAEConfig
from fresco_torch.pipeline import runner
from test_torch_convert import assert_same_state_dict, bits, seeded

UCFG = UNetConfig(**dataclasses.asdict(golden.FULL_UCFG))
VCFG = VAEConfig(**dataclasses.asdict(golden.FULL_VCFG))
CCFG = CLIPTextConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
GCFG = GMFlowConfig.tiny()


def _meta_mods():
    with torch.device("meta"):
        return {"unet": UNet2DCondition(UCFG), "vae": AutoencoderKL(VCFG),
                "controlnet": ControlNet(UCFG, golden.FULL_COND_EMBED), "text": CLIPTextEncoder(CCFG),
                "gmflow": GMFlow(GCFG)}


def _save(sd: dict, path: str) -> None:
    from safetensors.torch import save_file

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".safetensors"):
        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    else:
        torch.save(sd, path)


def _write_weights(root, with_vae_override: bool, missing=()):
    """Checkpoints in the fetch_weights layout; returns {model: checkpoint dict}."""
    mods = _meta_mods()
    ck = {
        "unet": seeded(golden.TUNet(golden.FULL_UCFG).state_dict(), np.float16, seed=1),
        "vae": seeded(golden.TVAE(golden.FULL_VCFG).state_dict(), seed=2),
        "controlnet": seeded(golden.TControlNet(golden.FULL_UCFG, golden.FULL_COND_EMBED).state_dict(), seed=3),
        "gmflow": TC.to_checkpoint(seeded(mods["gmflow"].state_dict(), seed=4), gmflow_map),
        # transformers' CLIPTextModel layout, with its int64 position_ids buffer
        "text": {**TC.to_checkpoint(seeded(mods["text"].state_dict(), seed=5), TC.sd_key_map("text", CCFG)),
                 "text_model.embeddings.position_ids": torch.arange(77)[None]},
    }
    sd15 = os.path.join(root, "stable-diffusion-v1-5")
    paths = {"unet": f"{sd15}/unet/diffusion_pytorch_model.safetensors",
             "vae": f"{sd15}/vae/diffusion_pytorch_model.bin",
             "text": f"{sd15}/text_encoder/model.safetensors",
             "controlnet": f"{root}/sd-controlnet-hed/diffusion_pytorch_model.safetensors",
             "gmflow": f"{root}/gmflow_sintel-0c07dcb3.pth"}
    for name, path in paths.items():
        if name not in missing:
            _save({"model": ck[name]} if name == "gmflow" else ck[name], path)
    if with_vae_override:
        ck["vae"] = seeded(golden.TVAE(golden.FULL_VCFG).state_dict(), seed=6)
        _save(ck["vae"], f"{root}/sd-vae-ft-mse/diffusion_pytorch_model.safetensors")
    return ck


def _configs(root, **kw):
    from fresco_tpu.core.config import FrescoConfig as JConfig

    kw = {"sd_path": "runwayml/stable-diffusion-v1-5", "controlnet_type": "hed",
          "gmflow_path": os.path.join(str(root), "gmflow_sintel-0c07dcb3.pth"), **kw}
    return FrescoConfig(**kw), JConfig(**kw)


@pytest.mark.parametrize("case", ["all", "vae_path", "missing"])
def test_maybe_load_pretrained_matches_jax(tmp_path, case):
    from fresco_tpu.models.clip_text import CLIPTextConfig as JCLIP
    from fresco_tpu.pipeline import runner as jrunner

    missing = ("vae", "text", "gmflow") if case == "missing" else ()
    _write_weights(str(tmp_path), with_vae_override=case == "vae_path", missing=missing)
    tcfg, jcfg = _configs(tmp_path)
    got = runner._maybe_load_pretrained(tcfg, _meta_mods())
    sentinel = object()
    jparams = jrunner._maybe_load_pretrained(
        dict.fromkeys(("unet", "vae", "text", "controlnet", "gmflow"), sentinel), jcfg,
        golden.FULL_UCFG, golden.FULL_VCFG, JCLIP(**dataclasses.asdict(CCFG)))
    loaded = sorted(k for k, v in jparams.items() if v is not sentinel)
    assert sorted(got) == loaded
    assert loaded == sorted({"unet", "vae", "text", "controlnet", "gmflow"} - set(missing))
    for name in loaded:
        assert_same_state_dict(got[name], TC.from_jax_params(jparams[name]))
    assert got["unet"]["conv_in.weight"].dtype == torch.float16  # the checkpoint's dtype, before any cast


def test_vae_path_overrides_sd_path(tmp_path):
    ck = _write_weights(str(tmp_path), with_vae_override=True)
    tcfg, _ = _configs(tmp_path)
    got = runner._maybe_load_pretrained(tcfg, _meta_mods())
    assert torch.equal(got["vae"]["quant_conv.weight"], ck["vae"]["quant_conv.weight"][:, :, 0, 0])
    tcfg, _ = _configs(tmp_path, vae_path=None)
    got = runner._maybe_load_pretrained(tcfg, _meta_mods())
    assert not torch.equal(got["vae"]["quant_conv.weight"], ck["vae"]["quant_conv.weight"][:, :, 0, 0])


# ---------------------------------------------------------------- LoRA
def _kohya(sd_unet: dict, sd_text: dict, rank: int = 4, seed: int = 0, dtype=torch.float32) -> dict:
    """A kohya LoRA over the tiny UNet (attention, feed-forward, mid block)
    and text encoder, some modules with ``alpha``; plus modules that map to
    nothing (a resnet conv) or to no weight of these models (up_blocks_3)."""
    rng = np.random.default_rng(seed)
    targets = {
        "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q": sd_unet["down_0_attn_0.block.attn1.to_q.weight"],
        "lora_unet_up_blocks_1_attentions_1_transformer_blocks_0_attn2_to_out_0": sd_unet["up_1_attn_1.block.attn2.to_out.weight"],
        "lora_unet_up_blocks_1_attentions_0_transformer_blocks_0_ff_net_0_proj": sd_unet["up_1_attn_0.block.ff_geglu.proj.weight"],
        "lora_unet_up_blocks_1_attentions_0_transformer_blocks_0_ff_net_2": sd_unet["up_1_attn_0.block.ff_out.weight"],
        "lora_unet_mid_block_attentions_0_transformer_blocks_0_attn2_to_k": sd_unet["mid_attn.block.attn2.to_k.weight"],
        "lora_te_text_model_encoder_layers_0_self_attn_q_proj": sd_text["layers_0.self_attn.q_proj.weight"],
        "lora_te_text_model_encoder_layers_1_mlp_fc1": sd_text["layers_1.mlp_fc1.weight"],
        "lora_unet_up_blocks_3_attentions_0_transformer_blocks_0_attn1_to_q": torch.zeros(8, 8),
        "lora_unet_down_blocks_0_resnets_0_conv1": torch.zeros(8, 8),
    }
    out = {}
    for i, (mod, w) in enumerate(targets.items()):
        o, n = w.shape
        out[f"{mod}.lora_down.weight"] = torch.from_numpy(rng.standard_normal((rank, n), dtype=np.float32)).to(dtype)
        out[f"{mod}.lora_up.weight"] = torch.from_numpy(rng.standard_normal((o, rank), dtype=np.float32)).to(dtype)
        if i % 2 == 0:
            out[f"{mod}.alpha"] = torch.tensor(float(rank) / 2)
    return out


def _tiny_state_dicts(dtype):
    """The port's tiny UNet and text encoder, seeded, in ``dtype``."""
    with torch.device("meta"):
        u = UNet2DCondition(UNetConfig.tiny())
        t = CLIPTextEncoder(CLIPTextConfig.tiny())
    return seeded(u.state_dict(), dtype, seed=9), seeded(t.state_dict(), dtype, seed=10)


def _dense_tree(sd: dict) -> dict:
    """The Flax tree of ``sd``'s Dense kernels ([in, out]), which is all the
    JAX ``merge_lora`` reads or writes."""
    tree: dict = {}
    for k, v in sd.items():
        if v.ndim == 2 and k.endswith(".weight"):
            *scopes, _ = k.split(".")
            node = tree
            for p in scopes:
                node = node.setdefault(p, {})
            node["kernel"] = v.numpy().T.copy()
    return tree


@pytest.mark.parametrize("dtype", [np.float32, np.float16], ids=["f32", "f16"])
def test_merge_lora_matches_jax(dtype):
    from fresco_tpu.models.lora import merge_lora as jax_merge

    usd, tsd = _tiny_state_dicts(dtype)
    lora = _kohya(usd, tsd, dtype=torch.float16 if dtype == np.float16 else torch.float32)
    lora_np = {k: v.numpy() for k, v in lora.items()}
    for sd, target, n_want in ((usd, "lora_unet_", 5), (tsd, "lora_te_", 2)):
        got, n = merge_lora(dict(sd), lora, 0.75, target=target)
        want_tree, n_jax = jax_merge({"params": _dense_tree(sd)}, lora_np, 0.75, target=target)
        assert n == n_jax == n_want
        want = TC.from_jax_params(want_tree)
        assert sorted(k for k in got if not torch.equal(got[k], sd[k])) == sorted(
            k for k in want if not torch.equal(want[k], sd[k]))
        assert len([k for k in want if not torch.equal(want[k], sd[k])]) == n_want
        for k in want:
            assert got[k].dtype == want[k].dtype
            if dtype == np.float32:
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)
            else:  # at most one float16 ulp apart
                d = (bits(got[k]).to(torch.int32) - bits(want[k]).to(torch.int32)).abs()
                assert int(d.max()) <= 1, k


def test_build_models_merges_lora_into_random_weights(tmp_path):
    from safetensors.torch import save_file

    cfg = FrescoConfig(dtype="float32")
    base = runner.build_models(cfg, tiny=True, device="cpu")
    usd, tsd = base.unet.state_dict(), base.text_encoder.state_dict()
    lora = _kohya(usd, tsd, seed=3)
    path = str(tmp_path / "style.safetensors")
    save_file(lora, path)
    merged = runner.build_models(cfg.replace(lora_path=path, lora_scale=0.5), tiny=True, device="cpu")
    for m0, m1, target in ((base.unet, merged.unet, "lora_unet_"), (base.text_encoder, merged.text_encoder, "lora_te_")):
        want, n = merge_lora(dict(m0.state_dict()), lora, 0.5, target=target)
        got = m1.state_dict()
        moved = [k for k in got if not torch.equal(got[k], m0.state_dict()[k])]
        assert len(moved) == n > 0
        assert_same_state_dict(dict(got), want)
    for a, b in ((base.vae, merged.vae), (base.controlnet, merged.controlnet), (base.gmflow, merged.gmflow)):
        assert_same_state_dict(dict(b.state_dict()), dict(a.state_dict()))
    # load_weights=False: the LoRA file is ignored, the random weights stay
    plain = runner.build_models(cfg.replace(lora_path=path), tiny=True, device="cpu", load_weights=False)
    assert_same_state_dict(dict(plain.unet.state_dict()), dict(base.unet.state_dict()))


# ---------------------------------------------------------------- detectors
def _gen():
    return torch.Generator().manual_seed(0)


def test_hed_and_egnet_load_from_their_checkpoints(tmp_path):
    from fresco_torch.models.egnet import EGNet, egnet_map
    from fresco_torch.models.hed import HED, hed_map

    with torch.device("meta"):
        hed_sd = seeded(HED().state_dict(), seed=7)
        eg_sd = seeded(EGNet().state_dict(), np.float16, seed=8)
    torch.save(TC.to_checkpoint(hed_sd, hed_map), str(tmp_path / "ControlNetHED.pth"))
    torch.save(TC.to_checkpoint(eg_sd, egnet_map), str(tmp_path / "epoch_resnet.pth"))
    cfg, _ = _configs(tmp_path, sod_path=str(tmp_path / "epoch_resnet.pth"), use_saliency=True)
    det = runner._build_detector(cfg, False, torch.device("cpu"), _gen(), False)
    assert det.func.__name__ == "hed_detector"
    assert_same_state_dict(dict(det.args[0].state_dict()), hed_sd)  # float32, as the JAX detector
    sal = runner._build_saliency(cfg, torch.device("cpu"), _gen(), False)
    assert sal is not None
    assert isinstance(sal.args[0], EGNet)
    assert_same_state_dict(dict(sal.args[0].state_dict()), {k: v.to(torch.bfloat16) for k, v in eg_sd.items()})


@pytest.fixture(scope="module")
def detector_checkpoints(tmp_path_factory):
    """Seeded checkpoints of the three detectors: MiDaS at a tiny config
    (``test_torch_midas.TINY``), M-LSD and the OpenPose body model at full
    width; {file name: (path, the port's state dict from it)}."""
    import test_torch_midas
    import test_torch_mlsd
    import test_torch_openpose
    from fresco_torch.models import midas, mlsd, openpose

    root = tmp_path_factory.mktemp("detectors")
    tiny = midas.DPTHybridDepth(**test_torch_midas.TINY)
    sds = {midas.CHECKPOINT: (test_torch_midas.timm_checkpoint(0),
                              lambda sd: midas.convert_dpt_hybrid(sd, model=tiny)),
           mlsd.CHECKPOINT: (test_torch_mlsd.mlsd_checkpoint(0), mlsd.convert_mlsd),
           openpose.CHECKPOINT: (test_torch_openpose.pose_checkpoint(openpose.BodyPose, 0, flat=True),
                                 openpose.convert_openpose)}
    out = {}
    for fname, (sd, convert) in sds.items():
        torch.save(sd, str(root / fname))
        out[fname] = (str(root / fname), convert(sd))
    return out


@pytest.mark.parametrize("ctype,fname,what", [
    ("depth", "dpt_hybrid-midas-501f0c75.pt", "MiDaS"),
    ("mlsd", "mlsd_large_512_fp32.pth", "MLSD"),
    ("openpose", "body_pose_model.pth", "OpenPose"),
    ("pose", "body_pose_model.pth", "OpenPose"),
])
def test_unported_detectors_raise_where_their_checkpoint_is(tmp_path, ctype, fname, what, detector_checkpoints,
                                                            monkeypatch, capsys):
    """Once unported (they raised where their checkpoint was), the three
    detectors now load it, as the JAX package's ``_build_detector`` does;
    without it they fall back to canny (or none), and tiny bundles never
    load one.  OpenPose raises only without OpenCV."""
    import functools

    import test_torch_midas
    from fresco_torch.models import midas, mlsd, openpose

    detect = {"depth": midas.depth_detector, "mlsd": mlsd.mlsd_detector, "openpose": openpose.openpose_detector,
              "pose": openpose.openpose_detector}[ctype]
    monkeypatch.setattr(midas, "DPTHybridDepth", functools.partial(midas.DPTHybridDepth, **test_torch_midas.TINY))
    cfg, _ = _configs(tmp_path, controlnet_type=ctype)
    det = runner._build_detector(cfg, False, torch.device("cpu"), _gen(), False)
    want = runner._canny_detector if runner._have_cv2() else runner._no_detector
    assert getattr(det, "func", det) is want  # absent: the JAX package's canny fallback
    assert f"{what} weights not found" in capsys.readouterr().out
    path, sd = detector_checkpoints[fname]
    os.symlink(path, str(tmp_path / fname))
    if ctype in ("openpose", "pose") and not runner._have_cv2():
        with pytest.raises(ImportError, match="cv2"):
            runner._build_detector(cfg, False, torch.device("cpu"), _gen(), False)
        return
    times = {}
    det = runner._build_detector(cfg, False, torch.device("cpu"), _gen(), False, times)
    assert det.func is detect
    assert_same_state_dict(dict(det.args[0].state_dict()), sd)  # float32, as the JAX detectors
    assert times[what.lower()]["path"] == str(tmp_path / fname)
    tiny = runner._build_detector(cfg, True, torch.device("cpu"), _gen(), False)
    assert getattr(tiny, "func", tiny) is want


def test_hashed_prompts_are_announced_after_loading_a_text_encoder(tmp_path, capsys):
    from fresco_torch.pipeline.text import HashTokenizer

    cfg, _ = _configs(tmp_path)
    (tmp_path / "stable-diffusion-v1-5").mkdir()
    tok = runner._make_tokenizer(cfg, CCFG, text_loaded=True)
    assert isinstance(tok, HashTokenizer)
    assert "HashTokenizer" in capsys.readouterr().out
    runner._make_tokenizer(cfg, CCFG, text_loaded=False)
    assert capsys.readouterr().out == ""
