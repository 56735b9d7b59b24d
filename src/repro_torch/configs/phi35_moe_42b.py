"""Phi-3.5-MoE 42B (A6.6B) [hf:microsoft/Phi-3.5-MoE-instruct] — 16e top-2."""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064, head_dim=128,
    rope_theta=1e4, mlp="swiglu", norm="layernorm",
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_ff_expert=6400),
)
