"""Zamba2-2.7B [arXiv:2411.15242] — 54 Mamba2 layers + ONE shared
attention+MLP block invoked every 6 layers (input = concat(x, emb));
sub-quadratic => long_500k runs."""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    attn_every=6, rope_theta=1e4, mlp="gelu", norm="layernorm",
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                  headdim=64, chunk=128),
    subquadratic=True,
)
