"""Flax parameter trees -> state dicts of the PyTorch modules.

The port's modules carry the Flax module names (``down_0_res_0.conv1``,
``up_2_attn_1.block.attn1.to_q``), so the map is a mechanical walk:

  * the wrapper scopes ``Conv_0`` / ``GroupNorm_0`` (Flax modules inside
    the ``Conv2d`` / ``GroupNorm32`` wrappers) fold into their parent;
  * ``kernel`` HWIO -> ``weight`` OIHW; ``kernel`` [in, out] -> ``weight``
    [out, in]; ``scale`` and ``embedding`` -> ``weight``; ``bias`` stays.

numpy only: leaves are numpy arrays, as ``jax.tree.map(np.asarray, ...)``
gives.  Loading real diffusers checkpoints is a later step:
``fresco_tpu/models/convert.py``'s key map composed with this one.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np

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


def from_jax_params(params: Mapping[str, Any], module=None) -> dict:
    """State dict for ``module`` from a Flax ``{"params": ...}`` tree of
    numpy leaves.  With ``module`` given, loads it with ``strict=True``
    (a missed or extra key raises), casting to the module's dtypes."""
    import torch

    sd = {torch_key(p): torch.from_numpy(_convert_leaf(p, np.asarray(v)))
          for p, v in flax_items(params)}
    if module is not None:
        own = module.state_dict()
        missing = sorted(set(own) - set(sd))
        extra = sorted(set(sd) - set(own))
        if missing or extra:
            raise KeyError(f"from_jax_params: missing {missing[:8]} extra {extra[:8]}")
        sd = {k: v.to(own[k].dtype) for k, v in sd.items()}
        module.load_state_dict(sd, strict=True)
    return sd
