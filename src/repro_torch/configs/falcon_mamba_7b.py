"""Falcon-Mamba-7B [arXiv:2410.05355] — pure Mamba1, attention-free;
sub-quadratic => long_500k runs.  TP shards d_inner (no heads axis — the
paper's seq<->head redistribution is inapplicable; see DESIGN.md)."""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024,
    mlp="swiglu", norm="rmsnorm",
    ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2, chunk=128),
    subquadratic=True,
)
