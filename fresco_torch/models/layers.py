"""Shared building blocks for the SD model family (PyTorch, NHWC).

Counterpart of ``fresco_tpu/models/layers.py``.  Activations stay NHWC
at every module boundary, as in the JAX package; ``Conv2d`` hands
``F.conv2d`` the NCHW *view* of an NHWC tensor (channels-last memory), so
no layout copy is made.  Norms compute in at least float32 and keep
float32 parameters; everything else runs in the module dtype.

Parameter names follow the Flax modules (``weight`` for ``kernel`` /
``scale`` / ``embedding``), so ``models/convert.py`` maps a Flax tree to
a state dict mechanically.  ``init_flax_default_`` draws the Flax
default initializers (lecun-normal kernels, zero biases, unit norm
scales, Flax's embedding init) from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from fresco_torch.core import comm


class Conv2d(nn.Module):
    """NHWC convolution, symmetric padding (Flax ``Conv2d`` wrapper);
    ``groups`` as Flax's ``feature_group_count``.  ``compute_dtype``
    (``set_compute_dtype``) as for ``Dense``."""

    compute_dtype: torch.dtype | None = None
    tp: tuple | None = None  # (mode, mesh): see make_tensor_parallel

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = True, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return _tensor_parallel(self, x, self._conv)
        w, b = _in_compute_dtype(self)
        return self._conv(x, w, b)

    def _conv(self, x, w, b):
        xc = x.permute(0, 3, 1, 2).to(w.dtype)
        if xc.device.type == "cpu" and torch.is_grad_enabled() and (xc.requires_grad or w.requires_grad):
            # PyTorch's CPU backward of a strided 1x1 convolution over this
            # channels-last view corrupts the heap with 8 threads (GMFlow's
            # downsample convs); it runs safely on contiguous NCHW
            xc = xc.contiguous()
        y = F.conv2d(xc, w, b, self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """``nn.Linear`` that casts its input to the parameter dtype (Flax
    ``Dense(dtype=...)`` semantics), or to ``compute_dtype`` where one is
    set: then the weight and bias are cast inside ``forward`` too, so
    autograd carries the gradient to parameters of another dtype (Flax's
    ``param_dtype`` float32 under a bf16 ``dtype``)."""

    compute_dtype: torch.dtype | None = None
    tp: tuple | None = None  # (mode, mesh): see make_tensor_parallel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return _tensor_parallel(self, x, _linear)
        w, b = _in_compute_dtype(self)
        return F.linear(x.to(w.dtype), w, b)


def _linear(x, w, b):
    return F.linear(x.to(w.dtype), w, b)


def _tensor_parallel(layer: nn.Module, x: torch.Tensor, op) -> torch.Tensor:
    """``op(x, weight, bias)`` in the layer's Megatron form."""
    mode, mesh = layer.tp
    w, b = _in_compute_dtype(layer)
    if mode == "column":
        return op(comm.copy_to_model(x, mesh), w, b)
    if mode == "column_gather":
        return comm.gather_from_model(op(comm.copy_to_model(x, mesh), w, b), mesh)
    if mode == "row_scatter":
        x = comm.scatter_to_model(x, mesh)
    y = comm.reduce_from_model(op(x, w, None), mesh)
    return y if b is None else y + b


@torch.no_grad()
def make_tensor_parallel(layer: nn.Module, mode: str, mesh, geglu: bool = False) -> None:
    """Keep this model rank's part of a ``Dense`` / ``Conv2d`` and switch it
    to its Megatron form over ``mesh.model``:

      * ``column``: output features split (weight dim 0), output local;
        with ``geglu`` the value and gate halves are split alike;
      * ``column_gather``: the same, then the whole output all-gathered
        along the channel (last) axis;
      * ``row``: input features split (weight dim 1) for an input that
        is already local; the partial products all-reduced, then the
        whole bias added once;
      * ``row_scatter``: the same on a whole input, of which each rank
        takes its part."""
    m, r = mesh.model, mesh.model_rank
    w, b = layer.weight, layer.bias
    if mode in ("column", "column_gather"):
        idx = column_part(w.shape[0], m, r, geglu).to(w.device)
        new_w, new_b = w.index_select(0, idx), None if b is None else b.index_select(0, idx)
    elif mode in ("row", "row_scatter"):
        n = w.shape[1] // m
        new_w, new_b = w[:, r * n:(r + 1) * n], b
    else:
        raise ValueError(f"make_tensor_parallel: unknown mode {mode!r}")
    layer.weight = nn.Parameter(new_w.contiguous(), requires_grad=w.requires_grad)
    if b is not None:
        layer.bias = nn.Parameter(new_b.contiguous(), requires_grad=b.requires_grad)
    layer.tp = (mode, mesh)


def column_part(n_out: int, m: int, r: int, geglu: bool = False) -> torch.Tensor:
    """The output features model rank ``r`` of ``m`` holds of a
    column-parallel layer; with ``geglu`` the same slice of the value and of
    the gate half, so that each rank gates its own values."""
    if geglu:
        n = n_out // 2 // m
        return torch.cat([torch.arange(r * n, (r + 1) * n), n_out // 2 + torch.arange(r * n, (r + 1) * n)])
    n = n_out // m
    return torch.arange(r * n, (r + 1) * n)


def _in_compute_dtype(m: nn.Module):
    """(weight, bias) of a Conv2d / Dense in its compute dtype; without
    one, the parameters themselves."""
    if m.compute_dtype is None or m.compute_dtype == m.weight.dtype:
        return m.weight, m.bias
    return m.weight.to(m.compute_dtype), None if m.bias is None else m.bias.to(m.compute_dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Compute every ``Conv2d`` / ``Dense`` of ``module`` in ``dtype``
    whatever its parameters' dtype (``None``: the parameter dtype again).
    Norms compute in at least float32 either way, as under ``cast_model``."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Dense)):
            m.compute_dtype = dtype
    return module


class GroupNorm32(nn.Module):
    """GroupNorm over NHWC computed in at least float32, returned in the
    input dtype (``unet.py:20`` convention)."""

    def __init__(self, channels: int, num_groups: int = 32, epsilon: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        work = torch.promote_types(x.dtype, torch.float32)
        y = F.group_norm(x.permute(0, 3, 1, 2).to(work), self.num_groups,
                         self.weight.to(work), self.bias.to(work), self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class LayerNorm32(nn.Module):
    """LayerNorm over the last axis in at least float32."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.eps = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        work = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(work), x.shape[-1:], self.weight.to(work),
                         self.bias.to(work), self.eps)
        return y.to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0, *,
                       flip_sin_to_cos: bool = True, downscale_freq_shift: float = 0.0):
    """Sinusoidal timestep embedding (diffusers semantics for SD1.5)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - downscale_freq_shift)
    )
    args = t.to(torch.float32)[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """2-layer SiLU MLP over the sinusoidal embedding."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Dense(in_dim, dim)
        self.linear_2 = Dense(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


NORMS = (GroupNorm32, LayerNorm32)


def cast_model(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast parameters to ``dtype`` except those of norms, which stay
    float32 (the JAX package keeps f32 norm parameters under a bf16
    compute dtype)."""
    for m in module.modules():
        if isinstance(m, NORMS):
            continue
        for name, p in m.named_parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Standard normal truncated to [-2, 2], times ``std`` (inverse CDF)."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def init_flax_default_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Flax's default initializers, in place: lecun-normal (truncated,
    fan-in) kernels and zero biases for Dense/Conv, ones/zeros for norms,
    N(0, 1/features) embeddings.  Modules flagged ``zero_init`` (the
    ControlNet zero convs) get zero kernels, as their Flax twins do; a
    module's own ``flax_init(gen)`` initializes its other parameters."""
    for m in module.modules():
        if isinstance(m, (Conv2d, nn.Linear)):
            if getattr(m, "zero_init", False):
                m.weight.zero_()
            else:
                fan_in = m.weight[0].numel()
                _trunc_normal_(m.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, NORMS):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[1]), generator=gen)
        if hasattr(m, "flax_init"):
            m.flax_init(gen)
    return module
