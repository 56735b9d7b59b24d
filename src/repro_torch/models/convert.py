"""Carry the reference's LM parameters into the port.

``lm_params_from_reference(cfg, params)`` takes the pytree of the
reference's ``LM.init_params`` with numpy (or array-like) leaves and returns
the state dict that the port's ``LM.load_state_dict(..., strict=True)``
takes: the leading layer axis of ``blocks`` is unstacked into
``blocks.<i>.<...>``.  bf16 arrives as numpy's ``bfloat16`` extension dtype,
which ``torch.from_numpy`` refuses; it is recognised by name and carried
bit for bit through ``uint16``, so this module needs no extension package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


def to_tensor(a) -> torch.Tensor:
    """A numpy array (or array-like) as a CPU tensor of the same dtype and bits."""
    a = np.array(a)  # a writable copy: reference arrays are read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def lm_params_from_reference(cfg: ArchConfig, params: dict) -> dict[str, torch.Tensor]:
    if cfg.family != "dense":
        raise NotImplementedError(f"only the dense family is ported, not {cfg.family!r}")
    out = {}
    for name, leaf in _flatten({k: v for k, v in params.items() if k != "blocks"}):
        out[name] = to_tensor(leaf)
    for name, leaf in _flatten(params["blocks"]):
        stacked = to_tensor(leaf)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks.{name}: {stacked.shape[0]} layers, config has "
                             f"{cfg.n_layers}")
        for i in range(cfg.n_layers):
            out[f"blocks.{i}.{name}"] = stacked[i].clone()
    return out
