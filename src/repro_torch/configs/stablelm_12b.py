"""StableLM-2-12B [hf:stabilityai/stablelm-2-1_6b family] — dense GQA kv=8."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352, head_dim=160,
    rope_theta=1e4, mlp="swiglu", norm="layernorm",
)
