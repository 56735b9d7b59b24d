"""LLaVA-NeXT-34B [hf:llava-hf family] — VLM backbone; anyres vision
frontend is a stub providing 2048 precomputed patch-embedding tokens."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    rope_theta=5e6, mlp="swiglu", norm="rmsnorm",
    frontend="vision", n_frontend_tokens=2048,
)
