"""Architecture registry: the 10 assigned archs + the paper's FFT configs.

``get(name)`` returns the exact published ArchConfig; ``smoke(name)`` a
reduced same-family variant for CPU tests.  ``SHAPES`` are the assigned
input-shape cells; ``cells(name)`` enumerates the applicable (arch, shape)
pairs (long_500k only for sub-quadratic archs — skip recorded in DESIGN.md).

A copy of the reference's registry and config files (data only).  Every
config loads; the port's ``LM`` runs the dense, MoE (GQA or MLA), SSM
(Mamba1) and hybrid (Mamba2 with a shared attention block) ones.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace
from importlib import import_module

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig, SSMConfig

ARCH_NAMES = (
    "glm4_9b",
    "stablelm_12b",
    "nemotron_4_15b",
    "qwen2_72b",
    "deepseek_v2_lite_16b",
    "phi35_moe_42b",
    "seamless_m4t_medium",
    "llava_next_34b",
    "zamba2_2p7b",
    "falcon_mamba_7b",
)

# assigned shapes: name -> (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def get(name: str) -> ArchConfig:
    name = name.replace("-", "_").replace(".", "p")
    mod = import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def smoke(name: str) -> ArchConfig:
    """Reduced same-family config: tiny widths, 2-ish layers, tiny vocab."""
    cfg = get(name)
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=256, head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, n_experts=8, top_k=2, d_ff_expert=32,
                            dense_ff=96, capacity_factor=8.0,
                            first_k_dense=min(cfg.moe.first_k_dense, 1))
        kw["n_layers"] = 2 + kw["moe"].first_k_dense
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                              v_head_dim=16)
        kw["head_dim"] = 0
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=8, headdim=8, chunk=16)
    if cfg.family == "hybrid":
        kw["n_layers"] = 4
        kw["attn_every"] = 2
        kw["n_kv_heads"] = 4
    if cfg.family == "audio":
        kw["n_encoder_layers"] = 2
    if cfg.family == "vlm":
        kw["n_frontend_tokens"] = 8
    return replace(cfg, **kw)


def cells(name: str) -> list[str]:
    """Applicable shape cells for an arch (the 40-cell table)."""
    cfg = get(name)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_NAMES for s in cells(a)]
