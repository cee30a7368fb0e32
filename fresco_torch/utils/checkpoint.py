"""Checkpoint / resume for pipeline state and model parameters.

Counterpart of ``fresco_tpu/utils/checkpoint.py``, with ``torch.save`` in
place of orbax.  The translated-batch state (record latents, batch
index, keys) can be saved so a long run resumes mid-sequence, and a
module's parameters (a state dict) so training resumes or converted
weights are cached.  Files are read back with ``weights_only=True``
(plain containers, numbers and tensors only), as the port reads every
``.pth`` / ``.bin``.  Tensors are saved from the host and load onto it;
a path that does not exist loads as ``None``.
"""
from __future__ import annotations

import os
from typing import Any, Mapping

import torch


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, Mapping):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _save(path: str, obj) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_host(obj), tmp)
    os.replace(tmp, path)  # a crash mid-write leaves the old file, never half a new one


def _load(path: str):
    if not os.path.exists(path):
        return None
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def save_pipeline_state(path: str, state: dict[str, Any]) -> None:
    """state: {'batch_ind': int, 'keys': list[int], 'record': tensor | None}."""
    _save(path, {"batch_ind": int(state["batch_ind"]), "keys": [int(k) for k in state["keys"]],
                 "record": state.get("record")})


def load_pipeline_state(path: str) -> dict[str, Any] | None:
    return _load(path)


def save_params(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """``params``: a state dict (``module.state_dict()``)."""
    _save(path, dict(params))


def load_params(path: str) -> dict[str, torch.Tensor] | None:
    return _load(path)
