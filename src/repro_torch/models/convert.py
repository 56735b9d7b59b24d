"""Carry the reference's LM parameters into the port.

``lm_params_from_reference(cfg, params)`` takes the pytree of the
reference's ``LM.init_params`` with numpy (or array-like) leaves and returns
the state dict that the port's ``LM.load_state_dict(..., strict=True)``
takes: the leading layer axis of ``blocks`` (and of the MoE family's
``dense0``) is unstacked into ``blocks.<i>.<...>``; the hybrid family's
``blocks``, stacked (groups, layers a group, ...), into
``blocks.<g>.<j>.<...>``, and its ``shared`` block passes through as the
top-level leaves do; the audio family's ``enc_blocks`` and ``dec_blocks``
into ``enc_blocks.<i>`` and ``dec_blocks.<i>`` (``enc_norm`` passes
through).  The VLM family's parameters are the dense family's.  Leaves keep their dtype: the MoE router, MLA's
``kv_norm``, the Mamba layers' ``dt_bias``, ``A_log`` and ``D`` and
Mamba2's ``norm_w`` stay fp32, the expert stacks
(E, d_in, d_out) are one tensor a layer as in the port, and MLA's ``wq``,
``w_dkv``, ``w_uk``, ``w_uv`` and ``wo`` keep the reference's names.  bf16 arrives as numpy's ``bfloat16``
extension dtype, which ``torch.from_numpy`` refuses; it is recognised by
name and carried bit for bit through ``uint16``, so this module needs no
extension package.

``shard_params(cfg, full_params, mesh)`` cuts such a state dict (whole, the
tp = 1 weights) to this rank's slices on a ``("data", "model")`` mesh, by
``models/sharding.py``'s rules (every family: dense, MoE with GQA or MLA,
SSM, hybrid, VLM and audio; the Mamba layers' parted leaves by
``sharding.cut``, as ``LM(cfg, mesh=mesh)`` cuts them), for such an LM's
``load_state_dict``; at tp = 1 each slice is the tensor itself.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.models import sharding
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import not_ported


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
    why = not_ported(cfg)
    if why:
        raise ValueError(why)
    n_dense = cfg.moe.first_k_dense if cfg.moe else 0
    # the leading stacked axes of each layer group
    if cfg.family == "hybrid":
        layers = {"blocks": (cfg.n_layers // cfg.attn_every, cfg.attn_every)}
    elif cfg.family == "audio":
        layers = {"enc_blocks": (cfg.n_encoder_layers,), "dec_blocks": (cfg.n_layers,)}
    else:
        layers = {"dense0": (n_dense,), "blocks": (cfg.n_layers - n_dense,)}
    out = {}
    for name, leaf in _flatten({k: v for k, v in params.items() if k not in layers}):
        out[name] = to_tensor(leaf)
    for group, lead in layers.items():
        for name, leaf in _flatten(params.get(group, {})):
            stacked = to_tensor(leaf)
            if tuple(stacked.shape[:len(lead)]) != lead:
                raise ValueError(f"{group}.{name}: stacked {tuple(stacked.shape)}, config has "
                                 f"{lead} layers")
            for idx in itertools.product(*map(range, lead)):
                out[".".join(map(str, (group, *idx, name)))] = stacked[idx].clone()
    return out


def shard_params(cfg: ArchConfig, full_params: dict[str, torch.Tensor], mesh
                 ) -> dict[str, torch.Tensor]:
    """This rank's slices of ``full_params`` (``lm_params_from_reference``'s
    output, or a mesh-less ``LM``'s state dict) on ``mesh``.  ``embed``'s
    rows and ``lm_head``'s columns are first padded with zeros to
    ``vocab_padded`` where ``full_params`` holds fewer (the reference draws
    its padding; its logits past ``vocab`` are never read).  At tp = 1 every
    entry of an unpadded vocabulary is the tensor itself."""
    _, tp, rank = sharding.mesh_sizes(mesh)
    vp = sharding.vocab_padded(cfg.vocab, mesh)
    out = {}
    for name, t in full_params.items():
        if name in ("embed", "lm_head"):
            short = vp - t.shape[0 if name == "embed" else 1]
            if short > 0:
                t = torch.nn.functional.pad(t, (0, 0, 0, short) if name == "embed" else (0, short))
        out[name] = sharding.cut(cfg, name, t, sharding.split_dim(name), rank, tp)
    return out
