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
(``models/convert.py``): a Flax Dense kernel is ``[in, out]``, so
``P(None, "model")`` splits torch ``weight`` dim 0 and ``P("model", None)``
dim 1; an HWIO conv's ``P(None, None, None, "model")`` splits OIHW dim 0.
``shard_model_params`` applies the table to the UNet and the ControlNet
(the modules of the denoise loop); each split layer then runs its Megatron
form (``models/layers.py``): column-parallel ``to_q/k/v`` (whole heads;
where ``heads % model`` is not 0 the attention stays whole), ``linear_1``
and ``ff_geglu`` (value and gate halves split alike) feed row-parallel
``to_out``, ``linear_2`` and ``ff_out`` (an all-reduce, then the bias
once); ``proj_in`` and every split conv all-gather their output channels
before the norm that follows; ``proj_out`` takes its part of a whole input
and all-reduces.  The VAE, the text encoder, GMFlow, EGNet and the
detectors stay whole on every rank: the JAX runner puts all of its
parameters through the rules, but a placement changes no number.
"""
from __future__ import annotations

import re

import torch.distributed as dist
import torch.nn as nn

from fresco_torch.core.comm import Mesh

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
_ROW_PAT = re.compile(r"(to_out|out_proj|proj_out|linear_2|ff_out|mlp_2|merge)")


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


def flax_paths(module: nn.Module, name: str) -> dict[str, tuple[str, ...]]:
    """{state-dict key: Flax path} of the UNet (``name`` "unet") or the
    ControlNet ("controlnet"), through the port's key maps."""
    from fresco_torch.models import convert

    paths: dict[str, tuple[str, ...]] = {}

    class _Paths(convert.KeyMap):
        def leaf(self, path, src, layout="same"):
            p = tuple(path.split("/"))
            paths[convert.torch_key(p)] = p

    convert.sd_key_map(name, module.cfg)(_Paths(module.state_dict().keys()))
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


def tp_plan(module: nn.Module, model: int, name: str | None = None) -> tuple[dict[str, int | None], dict]:
    """(the split table as applied, {layer name: (Megatron form, geglu)})
    for ``module`` (the UNet or the ControlNet) over a model axis of
    ``model``: ``split_table``, except that an attention whose heads do not
    divide by ``model`` stays whole."""
    from fresco_torch.models.controlnet import ControlNet

    name = name or ("controlnet" if isinstance(module, ControlNet) else "unet")
    table = split_table(module, name, model)
    mods = dict(module.named_modules())
    for parent in {n.rpartition(".")[0] for n in mods if n.endswith(".to_q")}:
        if mods[parent].heads % model:
            for n in ("to_q", "to_k", "to_v", "to_out"):
                table[f"{parent}.{n}.weight"] = None
    forms = {}
    for key, dim in table.items():
        if dim is not None:
            mod_name = key.rsplit(".", 1)[0]
            forms[mod_name] = (_mode(mod_name, mods[mod_name]), mod_name.endswith("ff_geglu.proj"))
    return table, forms


def shard_model_params(module: nn.Module, mesh: Mesh, name: str | None = None) -> dict[str, int | None]:
    """Split ``module``'s (the UNet's or the ControlNet's) parameters over
    ``mesh``'s ``model`` axis in place, each layer switched to its Megatron
    form, whole heads to a rank.  Returns the split table as applied
    (``tp_plan``)."""
    from fresco_torch.models import layers

    table, forms = tp_plan(module, mesh.model, name)
    if mesh.model == 1:
        return table
    mods = dict(module.named_modules())
    for parent in {n.rpartition(".")[0] for n in mods if n.endswith(".to_q")}:
        if table[f"{parent}.to_q.weight"] is not None:
            mods[parent].heads //= mesh.model
    for mod_name, (mode, geglu) in forms.items():
        layers.make_tensor_parallel(mods[mod_name], mode, mesh, geglu=geglu)
    return table


def _mode(mod_name: str, layer: nn.Module) -> str:
    """The Megatron form of a split layer (``layers.make_tensor_parallel``)."""
    from fresco_torch.models.layers import Conv2d

    leaf = mod_name.rsplit(".", 1)[-1]
    if isinstance(layer, Conv2d) or leaf == "proj_in":
        return "column_gather"
    if leaf == "proj_out":
        return "row_scatter"
    if leaf in ("to_out", "linear_2", "ff_out"):
        return "row"
    return "column"
