"""SeamlessM4T-medium [arXiv:2308.11596] — enc-dec backbone; audio frontend
is a stub (input_specs provides precomputed frame embeddings per the
assignment).  12 encoder + 12 decoder layers at d=1024."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, n_encoder_layers=12, encdec=True,
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    rope_theta=1e4, mlp="gelu", norm="layernorm",
    frontend="audio",
)
