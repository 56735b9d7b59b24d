"""Nemotron-4-15B [arXiv:2402.16819] — dense GQA kv=8, squared-ReLU MLP."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000, head_dim=128,
    rope_theta=1e4, mlp="relu2", norm="layernorm",
)
