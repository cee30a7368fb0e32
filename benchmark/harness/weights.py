"""Seeded random weights for both sides of a run, made on the device.

One generator per model, seeded from the run's seed and the model's name,
draws one standard-normal vector for all of the model's parameters in a
single call; each parameter takes its slice in the order of its name, so
the program's module and the reference's get the same values by name:

- a matrix or convolution kernel (2 or 4 dims): N(0, 1/fan_in), fan_in
  the product of all but the first dim; the ControlNet's zero
  convolutions (modules flagged ``zero_init``) a tenth of that, so that
  the ControlNet's residuals are small but not nought;
- a norm's scale (a 1-dim ``weight``) 1 + 0.02 N, a bias 0.02 N;
- a frozen BatchNorm's ``mean`` 0.1 N and ``var`` exp(0.1 N) > 0;
- anything else (a class token, positions, HED's pixel mean) 0.02 N.

Weights are drawn in float32 and then cast by each side as its own model
code casts them.
"""
from __future__ import annotations

import zlib

import torch


def model_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for model ``name`` of run ``seed``."""
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (1 << 63)


def weight_plan(module: torch.nn.Module) -> list[tuple[str, tuple, str]]:
    """(name, shape, rule) of every parameter of ``module`` (which may sit
    on the meta device), sorted by name."""
    zero_init = set()
    for mname, m in module.named_modules():
        if getattr(m, "zero_init", False):
            zero_init.update(f"{mname}.{p}" if mname else p for p, _ in m.named_parameters(recurse=False))
    plan = []
    for name, p in sorted(module.named_parameters(), key=lambda kv: kv[0]):
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim in (2, 4) and leaf == "weight":
            rule = "zero_conv" if name in zero_init else "fan_in"
        elif p.ndim == 1 and leaf in ("weight", "bias", "mean", "var"):
            rule = leaf
        else:
            rule = "small"
        plan.append((name, tuple(p.shape), rule))
    return plan


@torch.no_grad()
def fill_(module: torch.nn.Module, plan: list, seed: int, name: str) -> torch.nn.Module:
    """Overwrite ``module``'s parameters (float32, on one device) from
    ``plan`` and the generator of (``seed``, ``name``)."""
    params = dict(module.named_parameters())
    if set(params) != {n for n, _, _ in plan}:
        missing = sorted({n for n, _, _ in plan} ^ set(params))[:5]
        raise KeyError(f"{name}: parameters differ from the weight plan, e.g. {missing}")
    dev = next(iter(params.values())).device
    total = sum(int(torch.Size(shape).numel()) for _, shape, _ in plan)
    gen = torch.Generator(device=dev).manual_seed(model_seed(seed, name))
    z = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    off = 0
    for pname, shape, rule in plan:
        n = int(torch.Size(shape).numel())
        v = z[off : off + n].view(shape)
        off += n
        if rule in ("fan_in", "zero_conv"):
            v = v * ((n // shape[0]) ** -0.5 * (0.1 if rule == "zero_conv" else 1.0))
        elif rule == "weight":
            v = 1.0 + 0.02 * v
        elif rule == "var":
            v = torch.exp(0.1 * v)
        elif rule == "mean":
            v = 0.1 * v
        else:
            v = 0.02 * v
        params[pname].copy_(v)
    del z
    return module


def materialize(module: torch.nn.Module, plan: list, seed: int, name: str, device) -> torch.nn.Module:
    """A meta-device ``module`` made real on ``device`` in float32 and filled."""
    module = module.to_empty(device=device).float()
    return fill_(module, plan, seed, name)
