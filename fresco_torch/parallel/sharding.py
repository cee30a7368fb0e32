"""The ``(data, model)`` mesh: frames over ``data``, Megatron tensor
parallelism over ``model``.

Counterpart of ``fresco_tpu/parallel/sharding.py`` on ``torch.distributed``
(divergence F23).  The JAX package places parameters and frames with
shardings and lets GSPMD insert every collective; the port runs one process
per rank and places each collective by hand (``core/comm.py``).

``make_mesh(data, model)`` needs a process group of exactly ``data *
model`` ranks (``parallel/distributed.initialize``, or ``torchrun
--nproc-per-node N``) and raises otherwise; ``make_mesh(1, 1)`` without one
is the single-process mesh.  Nothing falls back to one device.

Tensor parallelism reads the JAX rules (``_COLUMN_PAT``, ``_ROW_PAT``,
``_spec_for``, and the skip where the axis does not divide) on each
parameter's Flax path, which the port's key maps give
(``models/convert.py``, ``models/gmflow/convert.py``): a Flax Dense kernel
is ``[in, out]``, so ``P(None, "model")`` splits torch ``weight`` dim 0 and
``P("model", None)`` dim 1; an HWIO conv's ``P(None, None, None, "model")``
splits OIHW dim 0.  ``shard_model_params`` applies the table to the five
models the JAX runner splits (its ``b.params``: the UNet, the ControlNet,
the VAE, the CLIP text encoder and GMFlow); each split layer then runs its
Megatron form (``models/layers.py``): column-parallel ``to_q/k/v`` and
``q/k/v_proj`` (whole heads), ``linear_1``, ``mlp_fc1``, ``mlp_0`` and
``ff_geglu`` (value and gate halves split alike) feed row-parallel
``to_out``, ``out_proj``, ``linear_2``, ``ff_out``, ``mlp_fc2`` and
``mlp_2`` (an all-reduce, then the bias once); ``proj_in`` and every split
conv all-gather their output channels before the norm that follows;
``proj_out`` takes its part of a whole input and all-reduces.

One placement departs from the JAX package's: an attention whose heads do
not divide by ``model`` (the VAE's mid-block attention, GMFlow's
single-head transformer and flow-propagation attentions) keeps its
``q/k/v`` projections whole, and its output projection (``to_out``,
``merge``) takes its part of the whole attention output (``row_scatter``).
The JAX package splits such an attention's channels and lets GSPMD sum the
partial scores; either placement gives the same numbers.  EGNet and the
control detectors stay whole on every rank, as in the JAX package, where
they are closures outside ``b.params``.

A split model is run by every rank of its model group together.  A rank
that goes on alone (rank 0's propagation and metrics) takes a whole copy
made by ``whole_state_dict`` while the ranks are still together.
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist
import torch.nn as nn

from fresco_torch.core.comm import Mesh, all_gather_cat

_GROUPS: dict = {}

F23_LAUNCH = ("launch one process per rank: `torchrun --nproc-per-node N ...`, or call "
              "fresco_torch.parallel.distributed.initialize(address, N, rank) in each of N processes "
              "(parallel.distributed.launch spawns them)")


def make_mesh(data: int, model: int = 1) -> Mesh:
    """This rank's mesh over a process group of ``data * model`` ranks."""
    n = data * model
    if not dist.is_initialized():
        if n == 1:
            return Mesh()
        raise RuntimeError(f"mesh {data}x{model} needs {n} processes and no process group is initialized "
                           f"(F23: one process per rank): {F23_LAUNCH}")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {data}x{model} needs a process group of {n} ranks; this one has {world}")
    if n == 1:
        return Mesh()
    key = (id(dist.group.WORLD), data, model)
    if key not in _GROUPS:
        # every rank creates every group, in the same order (new_group is collective)
        by_model = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
        by_data = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
        _GROUPS[key] = (by_model, by_data)
    by_model, by_data = _GROUPS[key]
    rank = dist.get_rank()
    return Mesh(data, model, rank, by_model[rank % model], by_data[rank // model])


# Megatron split: column-parallel for QKV / up-projections, row-parallel
# for output / down-projections (fresco_tpu/parallel/sharding.py:37-55)
_COLUMN_PAT = re.compile(
    r"(to_q|to_k|to_v|q_proj|k_proj|v_proj|proj_in|linear_1|ff_geglu|mlp_fc1|mlp_0)"
)
_ROW_PAT = re.compile(r"(to_out|out_proj|proj_out|linear_2|ff_out|mlp_fc2|mlp_2|merge)")


def _spec_for(path: tuple[str, ...], shape: tuple[int, ...]) -> tuple:
    """The JAX PartitionSpec of a Flax leaf, as a tuple of axis names."""
    name = "/".join(path)
    if len(shape) == 2:
        if _COLUMN_PAT.search(name):
            return (None, "model")
        if _ROW_PAT.search(name):
            return ("model", None)
    if len(shape) == 4 and shape[-1] % 2 == 0 and "conv" in name.lower():
        return (None, None, None, "model")
    return ()


MODELS = ("unet", "controlnet", "vae", "text", "gmflow")  # the JAX runner's b.params
_QKV = ("to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj")
_OUT = ("to_out", "out_proj", "merge")


def bundle_models(bundle) -> dict[str, nn.Module]:
    """{name: module} of a ``ModelBundle``'s ``MODELS`` that it holds."""
    mods = zip(MODELS, (bundle.unet, bundle.controlnet, bundle.vae, bundle.text_encoder, bundle.gmflow))
    return {name: mod for name, mod in mods if mod is not None}


def flax_paths(module: nn.Module, name: str) -> dict[str, tuple[str, ...]]:
    """{state-dict key: Flax path} of one of ``MODELS`` (``name``), through
    the port's key maps."""
    from fresco_torch.models import convert
    from fresco_torch.models.gmflow.convert import gmflow_map

    paths: dict[str, tuple[str, ...]] = {}

    class _Paths(convert.KeyMap):
        def leaf(self, path, src, layout="same"):
            p = tuple(path.split("/"))
            paths[convert.torch_key(p)] = p

    key_map = gmflow_map if name == "gmflow" else convert.sd_key_map(name, module.cfg)
    key_map(_Paths(module.state_dict().keys()))
    return paths


def split_table(module: nn.Module, name: str, model: int) -> dict[str, int | None]:
    """{weight key: the torch dim split over ``model``, or None} for every
    Dense / Conv kernel: the JAX spec of its Flax path, transposed, with the
    JAX rule's skip where the axis does not divide by ``model``."""
    table = {}
    for key, path in flax_paths(module, name).items():
        if path[-1] != "kernel":
            continue
        w = module.get_parameter(key)
        jshape = (tuple(w.shape[2:]) + (w.shape[1], w.shape[0])) if w.ndim == 4 else (w.shape[1], w.shape[0])
        spec = _spec_for(path, jshape)
        dim = None
        if "model" in spec:
            ax = spec.index("model")
            if jshape[ax] % model == 0:
                dim = (len(jshape) - 1 - ax) if len(jshape) == 2 else {3: 0, 2: 1}[ax]
        table[key] = dim
    return table


def _attentions(mods: dict) -> list[str]:
    """The names of the attention modules (those holding a ``to_q`` or
    ``q_proj``; each names its ``heads``)."""
    return [n for n, m in mods.items() if hasattr(m, "to_q") or hasattr(m, "q_proj")]


def tp_plan(module: nn.Module, model: int, name: str) -> tuple[dict[str, int | None], dict]:
    """(the split table as applied, {layer name: (Megatron form, geglu)})
    for ``module``, the model ``name`` of ``MODELS``, over a model axis of
    ``model``: ``split_table``, except that an attention whose heads do not
    divide by ``model`` keeps ``q/k/v`` whole and its output projection
    takes the ``row_scatter`` form."""
    table = split_table(module, name, model)
    mods = dict(module.named_modules())
    whole_heads = {p for p in _attentions(mods) if mods[p].heads % model}
    for parent in whole_heads:
        for n in _QKV:
            if f"{parent}.{n}.weight" in table:
                table[f"{parent}.{n}.weight"] = None
    forms = {}
    for key, dim in table.items():
        if dim is not None:
            mod_name = key.rsplit(".", 1)[0]
            parent, _, leaf = mod_name.rpartition(".")
            mode = "row_scatter" if parent in whole_heads and leaf in _OUT else _mode(mod_name, mods[mod_name])
            forms[mod_name] = (mode, mod_name.endswith("ff_geglu.proj"))
    return table, forms


def shard_model_params(module: nn.Module, mesh: Mesh, name: str) -> dict[str, int | None]:
    """Split the parameters of ``module``, the model ``name`` of ``MODELS``,
    over ``mesh``'s ``model`` axis in place, each layer switched to its
    Megatron form, whole heads to a rank.  Returns the split table as
    applied (``tp_plan``)."""
    from fresco_torch.models import layers

    table, forms = tp_plan(module, mesh.model, name)
    if mesh.model == 1:
        return table
    mods = dict(module.named_modules())
    for parent in _attentions(mods):
        if mods[parent].heads % mesh.model == 0:  # tp_plan split its q/k/v
            mods[parent].heads //= mesh.model
    for mod_name, (mode, geglu) in forms.items():
        layers.make_tensor_parallel(mods[mod_name], mode, mesh, geglu=geglu)
    return table


def is_split(module: nn.Module) -> bool:
    """Whether ``shard_model_params`` split ``module`` (a module, or any
    other callable, which it cannot have split) over a model axis."""
    return isinstance(module, nn.Module) and any(getattr(m, "tp", None) is not None for m in module.modules())


def whole_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """The whole state dict of a model that ``shard_model_params`` split:
    every split layer's parts all-gathered from the ranks of its model group
    and put back in place.  A collective: every rank of the group calls it
    together."""
    from fresco_torch.models.layers import column_part

    sd = dict(module.state_dict())
    for name, layer in module.named_modules():
        if getattr(layer, "tp", None) is None:
            continue
        mode, mesh = layer.tp
        if mode in ("column", "column_gather"):
            n = layer.weight.shape[0] * mesh.model
            order = torch.argsort(torch.cat([column_part(n, mesh.model, r, name.endswith("ff_geglu.proj"))
                                             for r in range(mesh.model)])).to(layer.weight.device)
            for p in ("weight", "bias"):
                if getattr(layer, p) is not None:
                    sd[f"{name}.{p}"] = all_gather_cat(getattr(layer, p), mesh.model_group, mesh.model, 0)[order]
        else:
            sd[f"{name}.weight"] = all_gather_cat(layer.weight, mesh.model_group, mesh.model, 1)
    return sd


def split_report(bundle) -> dict[str, dict[str, int]]:
    """{model: {"split": layers split over model, "layers": Dense / Conv
    layers, "bytes": parameter bytes on this rank}} of a ``ModelBundle``'s
    five models."""
    from fresco_torch.models.layers import Conv2d

    out = {}
    for name, mod in bundle_models(bundle).items():
        dense = [m for m in mod.modules() if isinstance(m, (Conv2d, nn.Linear))]
        out[name] = {"split": sum(getattr(m, "tp", None) is not None for m in dense), "layers": len(dense),
                     "bytes": sum(p.numel() * p.element_size() for p in mod.parameters())}
    return out


def _mode(mod_name: str, layer: nn.Module) -> str:
    """The Megatron form of a split layer (``layers.make_tensor_parallel``)
    whose attention, if it is in one, keeps whole heads."""
    from fresco_torch.models.layers import Conv2d

    leaf = mod_name.rsplit(".", 1)[-1]
    if isinstance(layer, Conv2d) or leaf == "proj_in":
        return "column_gather"
    if leaf == "proj_out":
        return "row_scatter"
    if _ROW_PAT.fullmatch(leaf):
        return "row"
    return "column"
