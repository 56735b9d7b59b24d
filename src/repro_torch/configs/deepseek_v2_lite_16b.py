"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — MLA kv_lora=512, MoE 64e top-6
(+2 shared), first layer dense.  (Assignment note: the line says both
"64e top-6" and "160 routed"; 160 routed is full V2 — Lite is 64, used here.)"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    rope_theta=1e4, mlp="swiglu", norm="rmsnorm",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  first_k_dense=1, dense_ff=10944),
)
