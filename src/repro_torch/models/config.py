"""Architecture configuration schema covering all assigned families.

One ``ArchConfig`` describes any of: dense decoder LMs, MoE LMs (top-k,
shared experts, MLA), encoder–decoder (audio backbone), VLM backbones,
hybrid Mamba2+shared-attention, and pure-SSM models.  Concrete instances
live in ``repro_torch/configs/<arch>.py``.

A copy of the reference's ``repro/models/config.py``: plain dataclasses and
the parameter counts, kept here so that the port imports nothing of the
reference.  The port's ``LM`` runs the ``dense``, ``moe`` and ``ssm`` families.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0           # always-on shared experts (DeepSeekMoE)
    d_ff_expert: int = 0        # per-expert hidden size
    router_dtype: str = "float32"
    capacity_factor: float = 1.25
    first_k_dense: int = 0      # leading layers use a dense FFN instead
    dense_ff: int = 0           # its hidden size (0 = cfg.d_ff)
    aux_coef: float = 1e-2
    zloss_coef: float = 1e-3


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba1"        # mamba1 | mamba2
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64           # mamba2 only
    dt_rank: int = 0            # mamba1 only; 0 = ceil(d_model/16)
    chunk: int = 128            # scan chunk length


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 = d_model // n_heads
    rope_theta: float = 1e4
    qkv_bias: bool = False
    mlp: str = "swiglu"         # swiglu | relu2 | geglu | gelu
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (zamba-style): one *shared* attn+MLP block invoked every
    # ``attn_every`` layers; n_layers counts mamba layers + invocations.
    attn_every: int = 0
    encdec: bool = False        # seamless-style encoder-decoder
    n_encoder_layers: int = 0
    frontend: str | None = None  # None | audio | vision (stub embeddings)
    n_frontend_tokens: int = 0   # vision tokens prepended (anyres stub)
    dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced-config variant for CPU smoke tests."""
        return replace(self, **kw)


def param_count(cfg: ArchConfig) -> int:
    """Total parameters (exact for our implementation; used for 6ND)."""
    d, v, L = cfg.d_model, cfg.vocab, cfg.n_layers
    hd = cfg.resolved_head_dim
    total = v * d  # embedding
    if not cfg.tie_embeddings:
        total += v * d

    def attn_params() -> int:
        if cfg.mla is not None:
            m = cfg.mla
            p = d * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim)          # q
            p += d * (m.kv_lora_rank + m.qk_rope_dim)                       # kv_a
            p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)  # kv_b
            p += m.kv_lora_rank                                             # kv_a norm
            p += cfg.n_heads * m.v_head_dim * d                             # o
            return p
        p = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
        if cfg.qkv_bias:
            p += cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd
        return p

    def mlp_params(ff: int) -> int:
        mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        return mult * d * ff

    def moe_params() -> int:
        m = cfg.moe
        assert m is not None
        mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        p = d * m.n_experts                                   # router
        p += m.n_experts * mult * d * m.d_ff_expert           # routed
        p += m.n_shared * mult * d * m.d_ff_expert            # shared
        return p

    def mamba_params() -> int:
        s = cfg.ssm
        assert s is not None
        di = s.expand * d
        if s.kind == "mamba1":
            dtr = s.dt_rank or -(-d // 16)
            p = d * 2 * di                      # in_proj
            p += di * s.d_conv + di             # conv + bias
            p += di * (dtr + 2 * s.d_state)     # x_proj
            p += dtr * di + di                  # dt_proj
            p += di * s.d_state + di            # A_log, D
            p += di * d                         # out_proj
            return p
        nh = di // s.headdim
        p = d * (2 * di + 2 * s.d_state + nh)   # in_proj (x,z,B,C,dt)
        p += (di + 2 * s.d_state) * s.d_conv + (di + 2 * s.d_state)
        p += nh + nh                            # A_log, D per head
        p += di + di * d                        # norm gate + out_proj
        return p

    if cfg.family in ("dense", "vlm"):
        per_layer = attn_params() + mlp_params(cfg.d_ff) + 2 * d
        total += L * per_layer
    elif cfg.family == "moe":
        m = cfg.moe
        assert m is not None
        total += m.first_k_dense * (attn_params() + mlp_params(m.dense_ff or cfg.d_ff) + 2 * d)
        total += (L - m.first_k_dense) * (attn_params() + moe_params() + 2 * d)
    elif cfg.family == "audio":
        enc_layer = attn_params() + mlp_params(cfg.d_ff) + 2 * d
        dec_layer = 2 * attn_params() + mlp_params(cfg.d_ff) + 3 * d  # +cross
        total += cfg.n_encoder_layers * enc_layer + L * dec_layer
    elif cfg.family == "ssm":
        total += L * (mamba_params() + d)
    elif cfg.family == "hybrid":
        n_shared_blocks = L // cfg.attn_every
        n_mamba = L - n_shared_blocks
        total += n_mamba * (mamba_params() + d)
        total += attn_params() + mlp_params(cfg.d_ff) + 2 * d  # ONE shared block
    else:
        raise ValueError(cfg.family)
    total += d  # final norm
    return total


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: only top-k + shared experts).
    Drives MODEL_FLOPS = 6 * N_active * D in the roofline (DESIGN.md §8)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    per_expert = mult * cfg.d_model * m.d_ff_expert
    inactive = (m.n_experts - m.top_k) * per_expert * (cfg.n_layers - m.first_k_dense)
    return total - inactive
