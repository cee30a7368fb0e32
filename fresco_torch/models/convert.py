"""Weights in: checkpoint files and Flax trees -> state dicts of the
PyTorch modules.

The port's modules carry the Flax module names (``down_0_res_0.conv1``,
``up_2_attn_1.block.attn1.to_q``), so a Flax tree maps mechanically
(``from_jax_params``, ``torch_key``):

  * the wrapper scopes ``Conv_0`` / ``GroupNorm_0`` (Flax modules inside
    the ``Conv2d`` / ``GroupNorm32`` wrappers) fold into their parent;
  * ``kernel`` HWIO -> ``weight`` OIHW; ``kernel`` [in, out] -> ``weight``
    [out, in]; ``scale`` and ``embedding`` -> ``weight``; ``bias`` stays.

Checkpoints (diffusers / transformers / the reference's ``.pth`` files)
map through key maps, counterparts of the ``_Builder`` code of
``fresco_tpu/models/convert.py``: a map is a function that names, for
each tensor of the port's module, its Flax path (hence its state-dict
key, through ``torch_key``) and its checkpoint key and layout.  One map
serves both directions: ``convert`` reads a checkpoint into a state
dict, ``to_checkpoint`` writes a state dict in the checkpoint's layout
(verification tooling for the tests and ``chip_smoke.py``).  Which
optional tensors exist (shortcut convolutions, the number of ControlNet
blocks, of GMFlow layers, ...) is read off the port's module, so the map
is a table computed from its config; only naming variants of the
checkpoint (old diffusers VAE attention names, CLIP's ``text_model.``
prefix) are read off the file.

``load_torch_state_dict`` reads ``.safetensors`` itself (the header and
raw bytes: F32, F16, BF16, I64; the ``safetensors`` package is not
needed) and ``.bin`` / ``.pth`` through ``torch.load(weights_only=True)``.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Callable, Iterable, Iterator, Mapping

import numpy as np
import torch

_WRAPPER_SCOPES = ("Conv_0", "GroupNorm_0")


def _walk(tree: Mapping[str, Any], path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def torch_key(path: tuple[str, ...]) -> str:
    """Flax path (without the leading 'params') -> state-dict key."""
    *scopes, leaf = path
    scopes = [s for s in scopes if s not in _WRAPPER_SCOPES]
    name = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(leaf, leaf)
    return ".".join([*scopes, name])


def torch_shape(path: tuple[str, ...], shape: tuple[int, ...]) -> tuple[int, ...]:
    if path[-1] == "kernel":
        if len(shape) == 4:
            return (shape[3], shape[2], shape[0], shape[1])
        return (shape[1], shape[0])
    return tuple(shape)


def _convert_leaf(path: tuple[str, ...], value: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    return np.ascontiguousarray(value)


def flax_items(params: Mapping[str, Any]) -> Iterator[tuple[tuple[str, ...], Any]]:
    """(path, leaf) pairs under the ``params`` collection."""
    return _walk(params["params"] if "params" in params else params)


def load_into(module: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Load ``sd`` into ``module`` with ``strict=True`` (a missed or extra
    key raises), each tensor cast to the module's dtype for it."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"state dict: missing {missing[:8]} extra {extra[:8]}")
    module.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()}, strict=True)


def from_jax_params(params: Mapping[str, Any], module=None) -> dict:
    """State dict for ``module`` from a Flax ``{"params": ...}`` tree of
    numpy leaves.  With ``module`` given, loads it (``load_into``)."""
    sd = {torch_key(p): torch.from_numpy(_convert_leaf(p, np.asarray(v)))
          for p, v in flax_items(params)}
    if module is not None:
        load_into(module, sd)
    return sd


# ---------------------------------------------------------------- files
_SAFETENSORS_DTYPES = {"F32": (np.float32, None), "F16": (np.float16, None),
                       "BF16": (np.uint16, torch.bfloat16), "I64": (np.int64, None)}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> CPU tensors: an 8-byte little-endian
    header length, a JSON header of ``dtype`` / ``shape`` /
    ``data_offsets`` (relative to the end of the header), the raw bytes."""
    raw = np.fromfile(path, dtype=np.uint8)
    (n,) = struct.unpack("<Q", raw[:8].tobytes())
    header = json.loads(raw[8:8 + n].tobytes())
    base = 8 + n
    out = {}
    for key, meta in header.items():
        if key == "__metadata__":
            continue
        if meta["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {key} has dtype {meta['dtype']}, not one of "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        np_dtype, view = _SAFETENSORS_DTYPES[meta["dtype"]]
        lo, hi = meta["data_offsets"]
        arr = raw[base + lo:base + hi].view(np_dtype).reshape(meta["shape"])
        if not arr.flags.aligned:
            arr = arr.copy()
        t = torch.from_numpy(arr)
        out[key] = t.view(view) if view is not None else t
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write ``tensors`` as a ``.safetensors`` file (F32, F16, BF16, I64),
    the inverse of ``read_safetensors`` (for tests and ``chip_smoke.py``)."""
    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.int64: "I64"}
    header, arrays, offset = {}, [], 0
    for key, t in tensors.items():
        t = t.detach().cpu().contiguous()
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + arr.nbytes]}
        arrays.append(arr)
        offset += arr.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for arr in arrays:
            arr.tofile(f)


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` / ``.bin`` / ``.pth`` checkpoint -> CPU tensors
    (``fresco_tpu/models/convert.py:load_torch_state_dict``).  Pickles load
    with ``weights_only=True``: tensors and plain containers only, never
    arbitrary objects.  A ``state_dict`` entry, then a ``model`` entry of
    tensors, is unwrapped, as in the JAX package."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(str(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd and all(
            isinstance(v, torch.Tensor) for v in sd["model"].values()):
        sd = sd["model"]
    return {k: v.detach() for k, v in sd.items()}


# ---------------------------------------------------------------- key maps
class KeyMap:
    """Records a checkpoint key map: entries (state-dict key, checkpoint
    key, layout), the layout being ``same``, ``conv1x1`` (checkpoint
    [O, I, 1, 1], port [O, I]), ``linear`` (either, port [O, I]) or
    ``nchw`` (checkpoint [1, C, 1, 1], port [1, 1, 1, C]).

    ``own``: the port module's state-dict keys (what exists is read off
    them); ``ckpt``: the checkpoint's keys when reading one, None when
    writing one (then every naming variant is the modern one)."""

    def __init__(self, own: Iterable[str], ckpt: Iterable[str] | None = None):
        self.own = set(own)
        self.ckpt = None if ckpt is None else set(ckpt)
        self.entries: list[tuple[str, str, str]] = []

    def leaf(self, path: str, src: str, layout: str = "same") -> None:
        self.entries.append((torch_key(tuple(path.split("/"))), src, layout))

    def has(self, dst: str) -> bool:
        """Whether the port's module has the Dense / Conv / norm at ``dst``."""
        return torch_key(tuple(dst.split("/")) + ("kernel",)) in self.own

    def pick(self, src: str, *names: str) -> str:
        """The first of ``names`` whose ``{src}.{name}.weight`` the
        checkpoint has (the first when writing one)."""
        if self.ckpt is not None:
            for n in names:
                if f"{src}.{n}.weight" in self.ckpt:
                    return n
        return names[0]

    def prefix(self, p: str) -> str:
        """``p`` if any checkpoint key starts with it (always when writing)."""
        if self.ckpt is None or any(k.startswith(p) for k in self.ckpt):
            return p
        return ""

    def _weight_bias(self, dst: str, src: str, layout: str) -> None:
        self.leaf(f"{dst}/kernel", f"{src}.weight", layout)
        if torch_key(tuple(dst.split("/")) + ("bias",)) in self.own:
            self.leaf(f"{dst}/bias", f"{src}.bias")

    def conv(self, dst: str, src: str) -> None:
        """A ``Conv2d`` wrapper (Flax params under ``dst/Conv_0``)."""
        self._weight_bias(f"{dst}/Conv_0", src, "same")

    def raw_conv(self, dst: str, src: str) -> None:
        self._weight_bias(dst, src, "same")

    def dense(self, dst: str, src: str, from_conv1x1: bool = False) -> None:
        self._weight_bias(dst, src, "conv1x1" if from_conv1x1 else "linear")

    def norm(self, dst: str, src: str, wrapped: bool = True) -> None:
        sub = f"{dst}/GroupNorm_0" if wrapped else dst
        self.leaf(f"{sub}/scale", f"{src}.weight")
        self.leaf(f"{sub}/bias", f"{src}.bias")

    def embed(self, dst: str, src: str) -> None:
        self.leaf(f"{dst}/embedding", f"{src}.weight")

    def batch_norm(self, dst: str, src: str) -> None:
        """A frozen BatchNorm: weight, bias and the running statistics."""
        for leaf, name in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                           ("var", "running_var")):
            self.leaf(f"{dst}/{leaf}", f"{src}.{name}")


def _to_port(t: torch.Tensor, layout: str) -> torch.Tensor:
    if layout in ("conv1x1", "linear") and t.ndim == 4:
        return t[:, :, 0, 0]
    if layout == "nchw":
        return t.permute(0, 2, 3, 1)
    return t


def _to_checkpoint(t: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "conv1x1":
        return t[:, :, None, None]
    if layout == "nchw":
        return t.permute(0, 3, 1, 2)
    return t


def convert(sd: Mapping[str, Any], key_map: Callable[[KeyMap], None], own: Iterable[str],
            strict: bool = False) -> dict[str, torch.Tensor]:
    """Checkpoint ``sd`` -> the port module's state dict (tensors in the
    checkpoint's dtypes).  A key the map needs and ``sd`` lacks raises
    ``KeyError``; with ``strict``, a checkpoint key the map leaves unused
    raises ``ValueError`` (``_Builder.check_all_used``)."""
    b = KeyMap(own, sd.keys())
    key_map(b)
    out = {key: _to_port(torch.as_tensor(sd[src]), layout).contiguous() for key, src, layout in b.entries}
    if strict:
        left = sorted(set(sd) - {src for _, src, _ in b.entries})
        if left:
            raise ValueError(f"{len(left)} checkpoint keys not consumed by the converter, e.g. {left[:8]}")
    return out


def to_checkpoint(state_dict: Mapping[str, torch.Tensor],
                  key_map: Callable[[KeyMap], None]) -> dict[str, torch.Tensor]:
    """The port module's state dict -> the checkpoint's layout (the
    inverse of ``convert``; for tests and ``chip_smoke.py``)."""
    b = KeyMap(state_dict.keys())
    key_map(b)
    return {src: _to_checkpoint(state_dict[key], layout).contiguous() for key, src, layout in b.entries}


def _meta_keys(cls, *args) -> list[str]:
    with torch.device("meta"):
        return list(cls(*args).state_dict())


# ---------------------------------------------------------------- SD family
def _resnet(b: KeyMap, dst: str, src: str) -> None:
    b.norm(f"{dst}/norm1", f"{src}.norm1")
    b.conv(f"{dst}/conv1", f"{src}.conv1")
    b.dense(f"{dst}/time_emb_proj", f"{src}.time_emb_proj")
    b.norm(f"{dst}/norm2", f"{src}.norm2")
    b.conv(f"{dst}/conv2", f"{src}.conv2")
    if b.has(f"{dst}/conv_shortcut"):
        b.dense(f"{dst}/conv_shortcut", f"{src}.conv_shortcut", from_conv1x1=True)


def _vae_resnet(b: KeyMap, dst: str, src: str) -> None:
    b.norm(f"{dst}/norm1", f"{src}.norm1")
    b.conv(f"{dst}/conv1", f"{src}.conv1")
    b.norm(f"{dst}/norm2", f"{src}.norm2")
    b.conv(f"{dst}/conv2", f"{src}.conv2")
    if b.has(f"{dst}/conv_shortcut"):
        sc = b.pick(src, "conv_shortcut", "nin_shortcut")
        b.dense(f"{dst}/conv_shortcut", f"{src}.{sc}", from_conv1x1=True)


def _transformer2d(b: KeyMap, dst: str, src: str) -> None:
    """SD1.5's Transformer2DModel: 1x1-conv projections
    (``use_linear_projection`` false); linear ones read as well."""
    b.norm(f"{dst}/norm", f"{src}.norm")
    b.dense(f"{dst}/proj_in", f"{src}.proj_in", from_conv1x1=True)
    blk = f"{src}.transformer_blocks.0"
    d = f"{dst}/block"
    for ln in ("norm1", "norm2", "norm3"):
        b.norm(f"{d}/{ln}", f"{blk}.{ln}", wrapped=False)
    for attn in ("attn1", "attn2"):
        for proj, name in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
            b.dense(f"{d}/{attn}/{proj}", f"{blk}.{attn}.{name}")
    b.dense(f"{d}/ff_geglu/proj", f"{blk}.ff.net.0.proj")
    b.dense(f"{d}/ff_out", f"{blk}.ff.net.2")
    b.dense(f"{dst}/proj_out", f"{src}.proj_out", from_conv1x1=True)


def _unet_encoder(b: KeyMap, cfg) -> None:
    """Shared by the UNet and the ControlNet: conv_in, time embedding,
    down blocks, mid block."""
    b.conv("conv_in", "conv_in")
    b.dense("time_embedding/linear_1", "time_embedding.linear_1")
    b.dense("time_embedding/linear_2", "time_embedding.linear_2")
    n_blocks = len(cfg.block_out_channels)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            _resnet(b, f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}")
            if i < n_blocks - 1:
                _transformer2d(b, f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}")
        if i < n_blocks - 1:
            b.conv(f"down_{i}_downsample/conv", f"down_blocks.{i}.downsamplers.0.conv")
    _resnet(b, "mid_res_0", "mid_block.resnets.0")
    _transformer2d(b, "mid_attn", "mid_block.attentions.0")
    _resnet(b, "mid_res_1", "mid_block.resnets.1")


def unet_map(b: KeyMap, cfg) -> None:
    """diffusers UNet2DConditionModel (``convert_unet``, fresco_tpu convert.py:167)."""
    _unet_encoder(b, cfg)
    n_blocks = len(cfg.block_out_channels)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block + 1):
            _resnet(b, f"up_{i}_res_{j}", f"up_blocks.{i}.resnets.{j}")
            if i > 0:
                _transformer2d(b, f"up_{i}_attn_{j}", f"up_blocks.{i}.attentions.{j}")
        if i < n_blocks - 1:
            b.conv(f"up_{i}_upsample/conv", f"up_blocks.{i}.upsamplers.0.conv")
    b.norm("conv_norm_out", "conv_norm_out")
    b.conv("conv_out", "conv_out")


def controlnet_map(b: KeyMap, cfg) -> None:
    """diffusers ControlNetModel (``convert_controlnet``, convert.py:192)."""
    _unet_encoder(b, cfg)
    ce = "controlnet_cond_embedding"
    b.conv(f"{ce}/conv_in", f"{ce}.conv_in")
    i = 0
    while b.has(f"{ce}/blocks_{i}"):
        b.conv(f"{ce}/blocks_{i}", f"{ce}.blocks.{i}")
        i += 1
    b.raw_conv(f"{ce}/conv_out", f"{ce}.conv_out")
    i = 0
    while b.has(f"controlnet_down_blocks_{i}"):
        b.dense(f"controlnet_down_blocks_{i}", f"controlnet_down_blocks.{i}", from_conv1x1=True)
        i += 1
    b.dense("controlnet_mid_block", "controlnet_mid_block", from_conv1x1=True)


def vae_map(b: KeyMap, cfg) -> None:
    """diffusers AutoencoderKL (``convert_vae``, convert.py:216)."""
    n_blocks = len(cfg.block_out_channels)
    for side, blocks in (("encoder", "down_blocks"), ("decoder", "up_blocks")):
        b.conv(f"{side}/conv_in", f"{side}.conv_in")
        layers = cfg.layers_per_block if side == "encoder" else cfg.layers_per_block + 1
        kind = "down" if side == "encoder" else "up"
        for i in range(n_blocks):
            for j in range(layers):
                _vae_resnet(b, f"{side}/{kind}_{i}_res_{j}", f"{side}.{blocks}.{i}.resnets.{j}")
            if i < n_blocks - 1:
                if side == "encoder":
                    b.raw_conv(f"{side}/down_{i}_downsample/conv", f"{side}.{blocks}.{i}.downsamplers.0.conv")
                else:
                    b.conv(f"{side}/up_{i}_upsample/conv", f"{side}.{blocks}.{i}.upsamplers.0.conv")
        _vae_resnet(b, f"{side}/mid_res_0", f"{side}.mid_block.resnets.0")
        dst, src = f"{side}/mid_attn", f"{side}.mid_block.attentions.0"
        b.norm(f"{dst}/group_norm", f"{src}.group_norm")
        # diffusers >= 0.14 names to_q / ... / to_out.0; older files query / key / value / proj_attn
        modern = b.pick(src, "to_q", "query") == "to_q"
        for proj, new, old in (("to_q", "to_q", "query"), ("to_k", "to_k", "key"),
                               ("to_v", "to_v", "value"), ("to_out", "to_out.0", "proj_attn")):
            b.dense(f"{dst}/{proj}", f"{src}.{new if modern else old}")
        _vae_resnet(b, f"{side}/mid_res_1", f"{side}.mid_block.resnets.1")
        b.norm(f"{side}/conv_norm_out", f"{side}.conv_norm_out")
        b.conv(f"{side}/conv_out", f"{side}.conv_out")
    b.dense("quant_conv", "quant_conv", from_conv1x1=True)
    b.dense("post_quant_conv", "post_quant_conv", from_conv1x1=True)


def clip_text_map(b: KeyMap, cfg) -> None:
    """transformers CLIPTextModel (``convert_clip_text``, convert.py:265);
    its ``position_ids`` buffer is left unused."""
    p = b.prefix("text_model.")
    b.embed("token_embedding", f"{p}embeddings.token_embedding")
    b.embed("position_embedding", f"{p}embeddings.position_embedding")
    for i in range(cfg.num_layers):
        s, d = f"{p}encoder.layers.{i}", f"layers_{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            b.norm(f"{d}/{ln}", f"{s}.{ln}", wrapped=False)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            b.dense(f"{d}/self_attn/{proj}", f"{s}.self_attn.{proj}")
        b.dense(f"{d}/mlp_fc1", f"{s}.mlp.fc1")
        b.dense(f"{d}/mlp_fc2", f"{s}.mlp.fc2")
    b.norm("final_layer_norm", f"{p}final_layer_norm", wrapped=False)


def clip_vision_map(b: KeyMap, cfg) -> None:
    """transformers CLIPVisionModel, or the vision half of a CLIPModel with
    its ``visual_projection`` (``convert_clip_vision``, convert.py:286).
    The projection is mapped where the port's module holds one."""
    p = b.prefix("vision_model.")
    b.raw_conv("patch_embedding", f"{p}embeddings.patch_embedding")
    b.leaf("class_embedding", f"{p}embeddings.class_embedding")
    b.embed("position_embedding", f"{p}embeddings.position_embedding")
    b.norm("pre_layrnorm", f"{p}pre_layrnorm", wrapped=False)
    for i in range(cfg.num_layers):
        s, d = f"{p}encoder.layers.{i}", f"layers_{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            b.norm(f"{d}/{ln}", f"{s}.{ln}", wrapped=False)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            b.dense(f"{d}/self_attn/{proj}", f"{s}.self_attn.{proj}")
        b.dense(f"{d}/mlp_fc1", f"{s}.mlp.fc1")
        b.dense(f"{d}/mlp_fc2", f"{s}.mlp.fc2")
    b.norm("post_layernorm", f"{p}post_layernorm", wrapped=False)
    if b.has("visual_projection"):
        b.dense("visual_projection", "visual_projection")


def sd_key_map(name: str, cfg) -> Callable[[KeyMap], None]:
    """The key map of the UNet / ControlNet / VAE / text encoder at ``cfg``."""
    fn = {"unet": unet_map, "controlnet": controlnet_map, "vae": vae_map, "text": clip_text_map}[name]
    return lambda b: fn(b, cfg)


def convert_unet(sd, cfg=None, strict: bool = False) -> dict[str, torch.Tensor]:
    from fresco_torch.models.unet import UNet2DCondition, UNetConfig

    cfg = cfg or UNetConfig()
    return convert(sd, sd_key_map("unet", cfg), _meta_keys(UNet2DCondition, cfg), strict)


def convert_controlnet(sd, cfg=None, strict: bool = False,
                       cond_embed: tuple[int, ...] = (16, 32, 96, 256)) -> dict[str, torch.Tensor]:
    from fresco_torch.models.controlnet import ControlNet
    from fresco_torch.models.unet import UNetConfig

    cfg = cfg or UNetConfig()
    return convert(sd, sd_key_map("controlnet", cfg), _meta_keys(ControlNet, cfg, cond_embed), strict)


def convert_vae(sd, cfg=None, strict: bool = False) -> dict[str, torch.Tensor]:
    from fresco_torch.models.vae import AutoencoderKL, VAEConfig

    cfg = cfg or VAEConfig()
    return convert(sd, sd_key_map("vae", cfg), _meta_keys(AutoencoderKL, cfg), strict)


def convert_clip_text(sd, cfg=None, strict: bool = False) -> dict[str, torch.Tensor]:
    from fresco_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder

    cfg = cfg or CLIPTextConfig()
    return convert(sd, sd_key_map("text", cfg), _meta_keys(CLIPTextEncoder, cfg), strict)


def convert_clip_vision(sd, cfg=None, strict: bool = False) -> dict[str, torch.Tensor]:
    """A CLIPVisionModel / CLIPModel checkpoint -> the state dict of
    ``CLIPVisionEncoder(cfg, projection=<the file has visual_projection>)``."""
    from fresco_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder

    cfg = cfg or CLIPVisionConfig()
    own = _meta_keys(CLIPVisionEncoder, cfg, "visual_projection.weight" in sd)
    return convert(sd, lambda b: clip_vision_map(b, cfg), own, strict)
