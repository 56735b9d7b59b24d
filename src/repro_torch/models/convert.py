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
``lm_shardings`` gives the same cuts as functions, for
``checkpoint.load_checkpoint(..., shardings=)``.

The optimizer's state and the trainer's checkpoints: ``opt_state_from_reference``
takes the reference's ``OptState`` (numpy leaves) to the port's (``mu``,
``nu`` unstacked as the parameters); ``trainer_state_from_reference`` maps
the leaves of a checkpoint that the reference's ``Trainer`` wrote, by their
keys (its tree paths: ``params/<path>``, ``opt/.step``, ``opt/.mu/<path>``,
``opt/.nu/<path>``, the layer groups stacked), to the port's ``Trainer``
state (``{"params": {name: tensor}, "opt": OptState}``), so that the port
resumes the reference's run.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.models import sharding
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import not_ported


def to_tensor(a) -> torch.Tensor:
    """A numpy array (or array-like, or tensor) as a CPU tensor of the same
    dtype and bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().clone()
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


def _stacked_groups(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """The reference's layer groups and the leading stacked axes of each."""
    if cfg.family == "hybrid":
        return {"blocks": (cfg.n_layers // cfg.attn_every, cfg.attn_every)}
    if cfg.family == "audio":
        return {"enc_blocks": (cfg.n_encoder_layers,), "dec_blocks": (cfg.n_layers,)}
    n_dense = cfg.moe.first_k_dense if cfg.moe else 0
    return {"dense0": (n_dense,), "blocks": (cfg.n_layers - n_dense,)}


def decays_in_reference(cfg: ArchConfig, name: str, p: torch.Tensor) -> bool:
    """Whether the reference's AdamW decays the port's leaf ``name``: it
    decays every leaf of rank >= 2 in its tree, where a layer group's leaves
    carry the stacked layer axes, so a layer's norm weights and biases are
    decayed and the top-level ``final_norm`` is not."""
    lead = _stacked_groups(cfg).get(name.split(".")[0])
    return p.ndim + (len(lead) if lead else 0) >= 2


def lm_params_from_reference(cfg: ArchConfig, params: dict) -> dict[str, torch.Tensor]:
    why = not_ported(cfg)
    if why:
        raise ValueError(why)
    layers = _stacked_groups(cfg)  # the leading stacked axes of each layer group
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


def lm_shardings(cfg: ArchConfig, mesh, names) -> dict:
    """{name: function of a whole leaf to this rank's slice on ``mesh``} for
    the state-dict ``names`` (the cuts of ``shard_params``; ``embed`` and
    ``lm_head`` must hold ``vocab_padded`` already).  The Trainer of an LM
    on a mesh cuts its parameters and both moments of a checkpoint so."""
    _, tp, rank = sharding.mesh_sizes(mesh)
    return {name: (lambda t, name=name: sharding.cut(cfg, name, t, sharding.split_dim(name),
                                                     rank, tp))
            for name in names}


def opt_state_from_reference(cfg: ArchConfig, opt_state):
    """The reference's ``OptState(step, mu, nu)`` (numpy or array-like
    leaves) as the port's: ``step`` an int32 scalar, ``mu`` and ``nu`` keyed
    by the port's parameter names."""
    from repro_torch.optim import OptState

    step, mu, nu = opt_state
    return OptState(to_tensor(step).to(torch.int32).reshape(()),
                    lm_params_from_reference(cfg, mu), lm_params_from_reference(cfg, nu))


def _nest(flat: dict, prefix: str) -> dict:
    """The leaves of ``flat`` under ``prefix/`` as a nested dict of their
    remaining path."""
    out = {}
    for key, leaf in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, last = key[len(prefix) + 1:].split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def trainer_state_from_reference(cfg: ArchConfig, flat: dict) -> dict:
    """A reference ``Trainer`` checkpoint's leaves ``{key: tensor}`` as the
    port's ``Trainer`` state ``{"params": {name: tensor}, "opt":
    OptState}``."""
    return {"params": lm_params_from_reference(cfg, _nest(flat, "params")),
            "opt": opt_state_from_reference(cfg, (flat["opt/.step"], _nest(flat, "opt/.mu"),
                                                  _nest(flat, "opt/.nu")))}
