"""The LM for serving and training, every family of the reference: dense,
MoE, SSM, hybrid, VLM and audio, GQA or MLA attention (the port of
``repro/models/lm.py``).

``LM`` is an ``nn.Module`` that holds the parameters of one card:
``embed``, ``final_norm``, ``lm_head`` (unless tied), ``dense0`` (the MoE
family's ``first_k_dense`` leading dense blocks, width ``dense_ff or
d_ff``) and ``blocks``, one per layer, each with an ``mlp`` or, in the MoE
family, a ``moe`` (the reference stacks each group on a leading axis and
scans).  Its entry points:

  ``prefill(batch, *, max_len)``          -> (cache, last-token fp32 logits (B, 1, V))
  ``decode_step(cache, token, cur_len)``  -> (cache, fp32 logits (B, V))

The cache is ``{"blocks": {"k": ..., "v": ...}}`` (and ``"dense0"`` alike
where the model has leading dense blocks) with a leading layer axis,
(L, B, Hkv, M, dh) under ``hmajor_cache`` and (L, B, M, Hkv, dh) otherwise;
with MLA (DeepSeek-V2) it is the latents, ``{"ckv": (L, B, M, r), "krope":
(L, B, M, dr)}`` under either setting, as in the reference.  It is
allocated at ``max_len`` by the prefill and written in place by each decode
step at ``cur_len`` (the reference donates it instead).  Without a mesh
one card holds the model and the vocabulary is not padded (``vocab_padded
== vocab``); on a mesh see the end of this docstring.  Under ``exact_causal_prefill`` the prefill's attention is the
flash kernel (K6); MLA's prefill expands its latents to per-head K and V
(q and k of dn + dr, v of dv: K6 at (192, 128) for DeepSeek-V2-Lite), and
its decode step attends in the latent space (``mla_decode_absorbed``), or
with ``absorbed=False`` over the expanded cache, as the reference has both.
An expert block's prefill runs the capacity dispatch
(``moe.moe_apply_capacity``, which drops assignments past capacity) and a
decode step every expert on its tokens (``moe.moe_apply_local``), as the
reference does at tp = 1.

The SSM family (Falcon-Mamba) holds ``embed``, ``final_norm``, ``lm_head``
and ``blocks`` of ``ln`` and ``mamba`` (Mamba1, ``models/ssm.py``); its cache
is the reference's bare ``{"ssm": (L, B, Di, N) fp32, "conv": (L, B, K-1,
Di)}``, which has no position axis: ``max_len`` does not size it and
``cur_len`` does not bound it, and each decode step writes it in place.

The hybrid family (Zamba2) holds ``embed``, ``final_norm``, ``lm_head``,
``blocks``, ``n_layers // attn_every`` groups of ``attn_every`` pre-norm
Mamba2 layers (``blocks.<g>.<j>``), and one ``shared`` attention+MLP block
(a ``Block`` with ``w_in`` (2d, d)) that runs once before each group on
``cat(x, x0) @ w_in``, x0 the token embeddings, its output added to x.  Its
cache is the reference's ``{"k", "v": (G, B, Hkv, M, dh) or (G, B, M, Hkv,
dh), "states": {"ssm": (G, J, B, H, P, N) fp32, "conv": (G, J, B, K-1, di
+ 2N)}}``: the shared block's keys and values of each group beside the
groups' Mamba2 states.

The VLM family (LLaVA-NeXT) is the dense stack; its prefill takes
``batch["frontend"]`` (B, F, D), the vision frontend's embeddings, and puts
it before the token embeddings: positions run 0 .. F + S - 1, the cache
holds F + S of its positions, and a decode step's ``cur_len`` counts them.

The audio family (SeamlessM4T) is an encoder–decoder: ``enc_blocks``
(``n_encoder_layers`` pre-norm blocks, non-causal plain attention) and
``enc_norm`` over ``batch["frontend"]`` (B, Se, D), the audio frontend's
frames at positions 0 .. Se - 1; then ``dec_blocks``, each a ``Block`` with
``ln_x`` and a ``cross`` GQA (no qkv bias) between its causal
self-attention (K6 under ``exact_causal_prefill``) and its MLP: queries of
``ln_x(x)`` at the decoder positions, keys and values of the encoder's
output at the frame positions, both rotated, as in the reference.  Its
cache is the reference's top-level ``{"k", "v", "ck", "cv"}`` with a
leading layer axis (an ``EncDecCache``, a dict that also carries Se):
``k``, ``v`` of ``max_len`` positions, ``ck``, ``cv`` of Se, unpadded, in
the layout ``hmajor_cache`` sets; a decode step attends over all Se frames.

``not_ported`` is None for every config of the registry.

Training (``loss``, mesh-less: one card or one data-parallel rank) runs the
reference's training forward of each family, without a cache, each layer
under the ``remat_policy``: the decoder layers' attention through the
blockwise form (MLA's K and V expanded from its latents), the MoE's
capacity dispatch (``moe_apply_dense`` in ``local_mode``, the reference's
compressed-gradient path) with the aux and z terms summed over its expert
layers, the Mamba layers' scans in their training form, the hybrid's shared
block once a group, the VLM's frontend before the tokens, and the audio
encoder and then the decoder with a causal cross-attention (the reference's
training semantics; its serving cross-attention is not causal).

Training on a mesh (``LM(cfg, mesh=, sp_mode=)``, the dense family; every
other family's ``loss_not_ported`` names ROADMAP §1) is the reference's
``loss`` on a ``("data", "model")`` mesh, in four forms: ``sp_mode``
"none" (Megatron tensor parallelism: the rank's q heads and the kv heads
they read, its ``d_ff`` columns) or "ulysses" (the rank's block of the
sequence projected with every head through ``wq`` and ``wo`` gathered
inside the block, redistributed to head blocks by
``attention.ulysses_attention``, the MLP tensor-parallel), each with the residual stream whole on every model rank
or, under ``PerfFlags.seq_sharded_residual``, split by sequence position
between blocks.  The placement of every leaf, and which gradients are
partial sums over "model", is ``models/sharding.py``'s table; the
vocabulary-parallel lookup and cross-entropy are ``layers.vocab_lookup``
and ``layers.chunked_xent(shard=)``.  Each data rank passes its rows and
the whole batch's mask count, as a data-parallel rank does; its model
ranks compute the same loss.  The collectives of one ``loss`` and its
backward (``LM.collectives_per_step``), L layers, c = 2 under a remat
policy (the layer's forward again in the backward, up to its closing sum
or reduce-scatter, which no saved tensor needs) or 1 under "none", n
cross-entropy chunks (two all_reduces each, twice: the chunk is always
recomputed):

  none, residual whole:     all_reduce (c + 3) L + 2 + 4n
  none, seq-sharded:        all_gather (2c + 2) L + 2, reduce_scatter (c + 3) L + 2,
                            all_reduce 4n
  ulysses, residual whole:  all_to_all (2c + 2) L, all_gather (2c + 1) L,
                            reduce_scatter L, all_reduce 2 L + 2 + 4n
  ulysses, seq-sharded:     all_to_all (2c + 2) L, all_gather (2c + 1) L + 2,
                            reduce_scatter 3 L + 2, all_reduce 4n

(Ulysses' c all_gathers and one reduce_scatter a layer are its ``wq``,
``bq`` and ``wo``'s), and a ``Trainer`` step in ``run`` adds three
all_reduces (the partial gradients, the split leaves' squared norm, the
ranks' stop flag).  At one rank every form computes the
mesh-less loss and gradients bit for bit.

On a mesh (``LM(cfg, mesh=launch.mesh.make_host_mesh(tp))``, every family;
one process a rank) the LM is the reference's ``LM`` on a ``("data",
"model")`` mesh, its rules (``models/sharding.py``) and collectives issued
by each rank:

* tensor parallelism over ``"model"``: Megatron column/row attention and
  MLP, each rank on its Hq / tp q heads and the kv heads they read
  ([h0 // G, h_last // G], one kv head where Hq / tp < G: K6 runs on them),
  ``o @ wo`` and the MLP's ``h @ w_down`` summed with an ``all_reduce``;
  MLA's latents computed whole on every rank (``w_dkv`` is whole) and
  expanded to the rank's own heads (its ``w_uk``, ``w_uv`` columns: K6 at
  Hkv = Hq / tp); the audio encoder's attention and MLP alike, and the
  decoder's cross-attention on the rank's q heads over ``ck``, ``cv``
  computed whole;
* the Mamba layers over ``"model"``: Mamba1 on the rank's Di / tp channels
  (``x @ x_proj``, a sum over every channel, reduced before dt, B and C
  are split; dt, the scan and its ``ssm`` and ``conv`` states the rank's
  own), Mamba2 on its H / tp heads with B and C computed whole on every
  rank (the gated norm's mean square reduced over the whole di), and
  ``out_proj``'s partial sums reduced; the hybrid's shared block runs as a
  GQA layer does, on ``cat(x, x0) @ w_in`` with ``w_in`` whole;
* the batch split over ``"data"`` where it divides, and with it the VLM's
  frontend rows and the audio encoder's frames; every rank takes the whole
  batch and returns the whole logits;
* every cache's positions split over ``"model"``: each rank holds blocks of
  ``ceil(M / tp)`` positions (the tail past M is padding, masked) of the
  KV cache (the VLM's M counts its F frontend positions), of MLA's latent
  cache and of the audio decoder's cross cache of Se frames (an
  ``EncDecCache``, which carries Se); the prompt's positions are written by
  the ranks that hold them, a new token's by the rank that holds
  ``cur_len``, and a decode step attends with the reference's schedule over
  the split axis (``attention.decode_attention``; MLA's absorbed form
  ``attention.mla_decode_absorbed``; the cross-attention with every valid
  frame and no causal limit);
* MLA's expanded decode (``absorbed=False``, the check path) all-gathers
  the latent cache's positions (one gather of ``ckv || krope``), since a
  rank can expand its own heads only, and attends on them whole;
* the MoE prefill's expert-parallel dispatch (``moe.moe_apply_a2a``, two
  ``all_to_all_single`` and a gather along S) where S divides by tp and S
  >= tp, else, and in every decode step, each rank's experts on every token
  summed with an ``all_reduce`` (``moe.moe_apply_local``);
* the embedding a masked lookup in the rank's vocabulary rows and an
  ``all_reduce``, the logits the rank's vocabulary columns and an
  ``all_gather`` (and one over ``"data"`` where the batch is split).

Each ``all_reduce`` sums fp32 (``models/sharding.py``).  The collectives a
call issues, counted by kind in ``collectives`` (the formula is
``LM.collectives_per_call``), with L layers of which L_e have experts and
L_d = L - L_e an MLP, s = 1 where the MoE has shared experts, g = 1 where
the batch is split over ``"data"``, a = 4 (GQA, MLA's absorbed step) or 1
(MLA's expanded step):

  prefill, S % tp == 0 and S >= tp:  all_reduce 1 + L + L_d + s L_e,
                                     all_to_all 2 L_e, all_gather L_e + 1 + g
  prefill otherwise:                 all_reduce 1 + L + L_d + (1 + s) L_e,
                                     all_gather 1 + g
  decode step:                       all_reduce 1 + a L + L_d + (1 + s) L_e,
                                     all_gather L + 1 + g

(S counts the VLM's frontend positions; it has no experts.)  A decode
step's attention issues four all-reduces and one all-gather a layer (q's
heads gathered, MLA's absorbed queries; the max, the sum and o reduced;
then ``wo``); MLA's expanded step one all-gather (the latents) and one
all-reduce (``wo``).  The audio family, L_enc encoder and L decoder layers:

  prefill:      all_reduce 1 + 2 L_enc + 3 L (the encoder's wo and MLP; the
                decoder's self wo, cross wo and MLP), all_gather 1 + g
  decode step:  all_reduce 1 + 9 L (the self- and the cross-attention's
                four each, the MLP), all_gather 2 L + 1 + g

The SSM family (L Mamba1 layers: ``x_proj`` and ``out_proj``) and the
hybrid (G groups, L_m Mamba2 layers: the norm and ``out_proj``; the shared
block as a GQA layer's attention and MLP, once a group):

  ssm, prefill and decode step:  all_reduce 1 + 2 L, all_gather 1 + g
  hybrid, prefill:               all_reduce 1 + 2 G + 2 L_m, all_gather 1 + g
  hybrid, decode step:           all_reduce 1 + 5 G + 2 L_m, all_gather G + 1 + g

At one rank (tp = dp = 1) these collectives are copies and the LM computes
the mesh-less one bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import Counter

import torch
from torch import nn

from repro_torch.core.meshutil import mesh_device
from repro_torch.models import attention as attn
from repro_torch.models import moe, sharding, ssm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (chunked_xent, dense_init, layernorm, mlp_apply,
                                      mlp_init, rmsnorm, vocab_lookup)
from repro_torch.models.sharding import collectives  # noqa: F401  (counted here)


@dataclasses.dataclass(frozen=True)
class PerfFlags:
    """Beyond-baseline optimizations; the defaults are the baseline.

    bf16_attention       — the attention contractions keep the weights'
                           dtype for p (see ``models/attention.py``).
    exact_causal_prefill — the serving prefill's attention is the flash
                           kernel (K6, exact causal FLOPs) instead of the
                           masked blockwise form.
    remat_policy         — the training forward's per-layer remat
                           (``LM.loss``): "full" recomputes the layer in the
                           backward; "dots" saves the outputs of the
                           products with no batch dimension (``aten.mm``,
                           ``addmm``) and recomputes the rest (the
                           reference's ``dots_with_no_batch_dims_saveable``);
                           "none", the port's own, keeps every activation.
                           No effect on serving.
    hmajor_cache         — head-major (B, Hkv, S, dh) KV cache.
    seq_sharded_residual — the training forward on a mesh keeps the
                           residual stream split over "model" by sequence
                           position between blocks (the reference's
                           ``act_btd_sp``): a reduce-scatter after each
                           row-parallel product and an all-gather before
                           each column-parallel one instead of the
                           all-reduces; the same function.  No effect
                           without a mesh or on serving.
    """

    bf16_attention: bool = False
    exact_causal_prefill: bool = False
    remat_policy: str = "full"
    hmajor_cache: bool = False
    seq_sharded_residual: bool = False


OPTIMIZED = PerfFlags(bf16_attention=True, exact_causal_prefill=True,
                      remat_policy="dots", hmajor_cache=True)

REMAT_POLICIES = ("full", "dots", "none")

#: the products whose outputs the "dots" policy saves: no batch dimension
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _params(tensors: dict) -> nn.ParameterDict:
    """A (nested) dict of tensors as frozen parameters, indexed as the dict."""
    return nn.ParameterDict({k: _params(t) if isinstance(t, dict)
                             else nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


def _kept(keep, prefix: str, tensors: dict) -> dict:
    return {k: keep(f"{prefix}.{k}", t) for k, t in tensors.items()}


def _norm_init(cfg: ArchConfig, d: int, device) -> nn.ParameterDict:
    p = {"w": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return _params(p)


def _norm_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


class Block(nn.Module):
    """One pre-norm decoder layer: ``ln1``, ``attn`` (GQA, or MLA where the
    config has it), ``ln2``, and ``mlp`` of width ``ff`` (default ``d_ff``)
    or, with ``use_moe``, ``moe``; with ``cross`` (the audio decoder) also
    ``ln_x`` and ``cross``, a GQA without qkv bias.  ``keep(name,
    tensor)``, if given, takes each drawn leaf (``"attn.wq"``, ...) and
    returns what the block holds: on a mesh, this rank's slice."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, dtype: torch.dtype, *,
                 use_moe: bool = False, ff: int | None = None, cross: bool = False,
                 keep=None):
        super().__init__()
        d = cfg.d_model
        keep = keep or (lambda name, t: t)
        self.ln1 = _norm_init(cfg, d, gen.device)
        self.ln2 = _norm_init(cfg, d, gen.device)
        self.attn = _params(_kept(keep, "attn", (
            attn.mla_init(gen, d, cfg.n_heads, cfg.mla, dtype) if cfg.mla is not None
            else attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                               qkv_bias=cfg.qkv_bias, dtype=dtype))))
        if cross:
            self.ln_x = _norm_init(cfg, d, gen.device)
            self.cross = _params(_kept(keep, "cross", attn.gqa_init(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, qkv_bias=False,
                dtype=dtype)))
        if use_moe:
            self.moe = _params(moe.moe_init(gen, d, cfg.moe, cfg.mlp, dtype,
                                            keep=lambda name, t: keep("moe." + name, t)))
        else:
            self.mlp = _params(_kept(keep, "mlp", mlp_init(gen, d, ff or cfg.d_ff, cfg.mlp,
                                                          dtype)))


class SSMBlock(nn.Module):
    """One pre-norm Mamba1 or Mamba2 layer (``cfg.ssm.kind``): ``ln`` and
    ``mamba``.  ``keep`` as ``Block``'s (``"mamba.in_proj"``, ...)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, dtype: torch.dtype, *,
                 keep=None):
        super().__init__()
        keep = keep or (lambda name, t: t)
        init = ssm.mamba2_init if cfg.ssm.kind == "mamba2" else ssm.mamba1_init
        self.ln = _norm_init(cfg, cfg.d_model, gen.device)
        self.mamba = _params(_kept(keep, "mamba", init(gen, cfg.d_model, cfg.ssm, dtype)))


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class EncDecCache(dict):
    """The audio family's cache, ``{"k", "v", "ck", "cv"}``, which also
    carries ``enc_len``: the encoder frames its cross keys and values hold
    (on a mesh a rank's ``ck``, ``cv`` are its block of ``ceil(enc_len /
    tp)`` positions, the tail padding, so that their shape does not tell)."""

    def __init__(self, leaves: dict, enc_len: int):
        super().__init__(leaves)
        self.enc_len = enc_len


def not_ported(cfg: ArchConfig) -> str | None:
    """Why the port cannot run ``cfg``, or None: it runs every family of the
    reference (``FAMILIES``)."""
    if cfg.family not in FAMILIES:
        return f"{cfg.name} is {cfg.family!r}, not a family of the reference"
    return None


class LM(nn.Module):
    """An LM of any family of the reference, weights drawn from ``seed``:
    on one device, or with ``mesh`` (``launch.mesh.make_host_mesh``) this
    rank's part of it.

    ``device`` defaults to CUDA and raises without a card; pass ``"cpu"``
    to run on the CPU (every kernel then takes its plain version).  With a
    mesh the device is the mesh's (this rank's card, or the CPU for a gloo
    mesh), and ``device`` must name its type.  On a mesh every leaf is drawn
    whole, in the order it is drawn without one, and the rank keeps its
    slice, so that any tp holds slices of the tp = 1 weights wherever
    ``vocab_padded`` is the same (the embedding is drawn first, at that
    size); at most one whole leaf is held beside the slices.  ``sp_mode``
    ("none" or "ulysses") sets the attention of the dense family's training
    on a mesh; the leaves lie alike in both, and serving ignores it.
    """

    def __init__(self, cfg: ArchConfig, *, mesh=None, q_block: int = 512,
                 xent_chunks: int = 8, perf: PerfFlags | None = None,
                 device: str | torch.device = "cuda", seed: int = 0, sp_mode: str = "none"):
        super().__init__()
        self.local_mode = False  # see ``local``
        if sp_mode not in sharding.SP_MODES:
            raise ValueError(f"sp_mode {sp_mode!r} is not one of {sharding.SP_MODES}")
        if sp_mode == "ulysses" and mesh is not None and cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: Ulysses sequence parallelism of the {cfg.family!r} family is not "
                "ported yet (ROADMAP §1); the dense family's is")
        self.sp_mode = sp_mode
        device = torch.device(device)
        if mesh is not None:
            if device.type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's ({mesh.device_type})")
            device = mesh_device(mesh)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LM defaults to CUDA and no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        self.cfg, self.q_block, self.xent_chunks = cfg, q_block, xent_chunks
        self.perf = perf if perf is not None else PerfFlags()
        if self.perf.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.perf.remat_policy!r} is not one of "
                             f"{REMAT_POLICIES}")
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self._place(mesh)
        if self.shard is None:
            bkeep = None

            def keep(name, t):
                return t
        else:
            tp, rank = self.shard.tp, self.shard.rank

            def keep(name, t):
                return sharding.cut(cfg, name, t, sharding.split_dim(name), rank, tp)

            def bkeep(name, t):
                return sharding.cut(cfg, name, t, sharding.block_split_dim(name), rank, tp)
        gen = torch.Generator(device=device).manual_seed(seed)
        d = cfg.d_model
        self.embed = nn.Parameter(
            keep("embed", dense_init(gen, self.vocab_padded, d, self.dtype, scale=1.0)),
            requires_grad=False)
        self.final_norm = _norm_init(cfg, d, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                keep("lm_head", dense_init(gen, d, self.vocab_padded, self.dtype)),
                requires_grad=False)
        n_dense = cfg.moe.first_k_dense if cfg.moe else 0
        ff0 = (cfg.moe.dense_ff or cfg.d_ff) if cfg.moe else cfg.d_ff
        self.dense0 = nn.ModuleList(Block(cfg, gen, self.dtype, ff=ff0, keep=bkeep)
                                    for _ in range(n_dense))
        if cfg.family == "ssm":
            self.blocks = nn.ModuleList(SSMBlock(cfg, gen, self.dtype, keep=bkeep)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            self.blocks = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, gen, self.dtype, keep=bkeep)
                              for _ in range(cfg.attn_every))
                for _ in range(cfg.n_layers // cfg.attn_every))
            self.shared = Block(cfg, gen, self.dtype,
                                keep=lambda name, t: keep("shared." + name, t))
            self.shared.w_in = nn.Parameter(keep("shared.w_in", dense_init(gen, 2 * d, d,
                                                                           self.dtype)),
                                            requires_grad=False)
        elif cfg.family == "audio":
            self.enc_blocks = nn.ModuleList(Block(cfg, gen, self.dtype, keep=bkeep)
                                            for _ in range(cfg.n_encoder_layers))
            self.enc_norm = _norm_init(cfg, d, device)
            self.dec_blocks = nn.ModuleList(Block(cfg, gen, self.dtype, cross=True, keep=bkeep)
                                            for _ in range(cfg.n_layers))
        elif cfg.family in ("dense", "vlm", "moe"):
            self.blocks = nn.ModuleList(Block(cfg, gen, self.dtype, use_moe=cfg.moe is not None,
                                              keep=bkeep)
                                        for _ in range(cfg.n_layers - n_dense))
        else:
            raise ValueError(not_ported(cfg))

    def _place(self, mesh):
        """This LM's place on ``mesh`` (None: no mesh): its ``shard``, the
        padded vocabulary, and its q heads (``n_q`` from head ``h0``) and the
        kv heads [kv0, kv1) they read (MLA's expanded kv heads are one a q
        head: the rank's own).  Raises where the widths the family splits
        do not divide by tp: Hq, E or d_ff (the audio encoder's too), the
        SSM's d_inner, the hybrid's SSD heads, Hq and d_ff (the reference's
        GSPMD pads them instead)."""
        cfg = self.cfg
        self.vocab_padded = sharding.vocab_padded(cfg.vocab, mesh)
        self.n_q, self.h0, self.kv0, self.kv1 = cfg.n_heads, 0, 0, cfg.n_kv_heads
        if mesh is None:
            self.shard = None
            return
        self.shard = sharding.Shard(mesh)
        tp = self.shard.tp
        attention = cfg.family != "ssm"
        widths = {"n_heads": cfg.n_heads} if attention else {}
        if cfg.ssm is not None:
            di = cfg.ssm.expand * cfg.d_model
            widths.update({"d_inner": di} if cfg.ssm.kind == "mamba1"
                          else {"ssm heads": di // cfg.ssm.headdim})
        if attention and cfg.moe is None:
            widths["d_ff"] = cfg.d_ff
        elif attention:
            widths["n_experts"] = cfg.moe.n_experts
            if cfg.moe.first_k_dense:
                widths["dense_ff"] = cfg.moe.dense_ff or cfg.d_ff
            if cfg.moe.n_shared:
                widths["shared d_ff"] = cfg.moe.n_shared * cfg.moe.d_ff_expert
        bad = {k: n for k, n in widths.items() if n % tp}
        if bad:
            raise ValueError(f"{cfg.name}: {bad} do not divide by tp = {tp} (the reference's "
                             "GSPMD pads them; here they must divide)")
        if attention:
            self.n_q, self.h0, self.kv0, self.kv1 = self.shard.heads(
                cfg.n_heads, cfg.n_heads if cfg.mla is not None else cfg.n_kv_heads)

    def sharded(self, mesh) -> LM:
        """This mesh-less LM on ``mesh``: a new LM holding this rank's slices
        of this one's weights (``convert.shard_params``); at tp = 1 the very
        tensors, so nothing is drawn or copied."""
        if self.shard is not None:
            raise ValueError("the LM is on a mesh already")
        from repro_torch.models.convert import shard_params  # convert imports this module

        params = dict(self.named_parameters())
        cut = shard_params(self.cfg, {k: p.detach() for k, p in params.items()}, mesh)
        memo = {id(p): nn.Parameter(cut[k], requires_grad=False) for k, p in params.items()}
        new = copy.deepcopy(self, memo)
        new._place(mesh)
        return new

    @property
    def head_dim(self) -> int:
        return self.cfg.resolved_head_dim

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- pieces ---------------------------------------------------------------

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums summed over the model group
        (``t`` itself without a mesh)."""
        return t if self.shard is None else self.shard.reduce(t)

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch (all of them without a mesh or
        where the batch does not split over "data")."""
        rows = None if self.shard is None else self.shard.rows(t.shape[0])
        return t if rows is None else t[rows[0]:rows[1]]

    def _positions(self, n: int) -> int:
        """The positions of a cache of ``n`` that this rank holds: all of
        them without a mesh, else its block of ``ceil(n / tp)``."""
        return n if self.shard is None else self.shard.positions(n)

    def _block(self, c: torch.Tensor, hmajor: bool) -> tuple[int, int]:
        """(the first global position, the number of positions) of the
        layer's cache leaf ``c`` (B, m, ...) or, ``hmajor``, (B, H, m, d)
        that this rank holds."""
        m = c.shape[2] if hmajor else c.shape[1]
        return (0 if self.shard is None else self.shard.rank * m), m

    def _write_prompt(self, cache: dict, new: dict, hmajor: bool):
        """Write each ``new[key]`` (B, S, ...) of positions 0 .. S - 1 into
        the positions of the layer's ``cache[key]`` that this rank holds;
        ``hmajor`` leaves are head-major (B, H, m, d)."""
        for key, t in new.items():
            c = cache[key]
            lo, m = self._block(c, hmajor)
            n = max(0, min(t.shape[1], lo + m) - lo)
            if n and hmajor:
                c[:, :, :n] = t[:, lo:lo + n].transpose(1, 2)
            elif n:
                c[:, :n] = t[:, lo:lo + n]

    def _write_token(self, cache: dict, new: dict, cur_len: int, hmajor: bool) -> int:
        """Write each ``new[key]`` (B, 1, ...) at global position
        ``cur_len`` of the layer's ``cache[key]``, on the rank that holds it;
        returns the first global position this rank holds."""
        for key, t in new.items():
            c = cache[key]
            lo, m = self._block(c, hmajor)
            j = cur_len - lo  # the position in this rank's block, if it holds it
            if 0 <= j < m and hmajor:
                c[:, :, j] = t[:, 0]
            elif 0 <= j < m:
                c[:, j] = t[:, 0]
        return lo

    def _kv_heads(self, k: torch.Tensor, v: torch.Tensor):
        """The kv heads (B, S, Hkv, d) that the rank's q heads read."""
        if (self.kv0, self.kv1) == (0, k.shape[2]):
            return k, v
        return k[:, :, self.kv0:self.kv1], v[:, :, self.kv0:self.kv1]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The tokens' embeddings; on a mesh, a lookup in the rank's
        vocabulary rows, zero where another rank holds the row, summed over
        the model group (exact: one rank adds its row to zeros)."""
        if self.shard is None:
            return self.embed[tokens]
        n = self.embed.shape[0]
        local = tokens - self.shard.rank * n
        e = self.embed[local.clamp(0, n - 1)]
        return self.shard.reduce(torch.where(((local >= 0) & (local < n))[..., None], e, 0))

    def _last_logits(self, x: torch.Tensor, batch: int = 0) -> torch.Tensor:
        """fp32 logits of the last position; on a mesh the rank's vocabulary
        columns gathered over "model", and the rows over "data" where the
        ``batch`` of the call was split."""
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        h = _norm_apply(self.cfg, self.final_norm, x[:, -1:])
        lg = (h @ w).float()
        if self.shard is None:
            return lg
        lg = self.shard.gather(lg, dim=-1)
        if self.shard.rows(batch) is not None:
            lg = self.shard.gather(lg, dim=0, axis="data")
        return lg

    def _serving_causal(self, q, k, v):
        if self.perf.exact_causal_prefill:
            return attn.triangular_causal_attention(q, k, v, q_block=self.q_block,
                                                    bf16_compute=self.perf.bf16_attention)
        return attn.blockwise_attention(q, k, v, causal=True, q_block=self.q_block,
                                        bf16_compute=self.perf.bf16_attention)

    def _qkv(self, p, h, positions):
        cfg = self.cfg
        return attn.gqa_qkv(p.attn, h, n_heads=self.n_q, n_kv=cfg.n_kv_heads,
                            head_dim=self.head_dim, positions=positions,
                            rope_theta=cfg.rope_theta)

    def _mla_latents(self, p, h, positions):
        cfg = self.cfg
        return attn.mla_latents(p.attn, h, mla=cfg.mla, positions=positions,
                                rope_theta=cfg.rope_theta)

    def _mla_qkv(self, p, h, positions, ckv, krope):
        """MLA's q (nope || rope) of the rank's heads at ``positions`` and
        their K, V expanded from the latents ``ckv`` (B, S, r), ``krope``
        (B, S, 1, dr)."""
        cfg = self.cfg
        qn, qr = attn.mla_queries(p.attn, h, n_heads=self.n_q, mla=cfg.mla,
                                  positions=positions, rope_theta=cfg.rope_theta)
        k, v = attn.mla_expand_kv(p.attn, ckv, krope, n_heads=self.n_q, mla=cfg.mla)
        return torch.cat([qn, qr], -1), k, v

    def _attn_prefill(self, p, x, positions, cache: dict):
        """Attention sub-block; writes its keys and values (MLA: its
        latents, which every rank computes whole) to the rank's positions
        of the layer's ``cache``."""
        B, S = x.shape[:2]
        h = _norm_apply(self.cfg, p.ln1, x)
        if self.cfg.mla is not None:
            ckv, krope = self._mla_latents(p, h, positions)
            o = self._serving_causal(*self._mla_qkv(p, h, positions, ckv, krope))
            self._write_prompt(cache, {"ckv": ckv, "krope": krope[:, :, 0]}, hmajor=False)
        else:
            q, k, v = self._qkv(p, h, positions)
            o = self._serving_causal(q, *self._kv_heads(k, v))
            self._write_prompt(cache, {"k": k, "v": v}, self.perf.hmajor_cache)
        return x + self._reduce(o.reshape(B, S, -1) @ p.attn["wo"])

    def _enc_attn(self, p, x, positions):
        """The encoder's attention sub-block: non-causal plain attention on
        the rank's heads."""
        B, S = x.shape[:2]
        q, k, v = self._qkv(p, _norm_apply(self.cfg, p.ln1, x), positions)
        o = attn.blockwise_attention(q, *self._kv_heads(k, v), causal=False,
                                     q_block=self.q_block, bf16_compute=self.perf.bf16_attention)
        return x + self._reduce(o.reshape(B, S, -1) @ p.attn["wo"])

    def _cross_prefill(self, p, x, enc, positions, enc_positions, cache: dict):
        """Cross-attention sub-block of the prefill: queries of ``ln_x(x)``
        at ``positions`` (the rank's heads), keys and values of the
        encoder's output ``enc`` at ``enc_positions`` (whole on every rank),
        written to the rank's positions of the layer's ``ck``, ``cv``.  The
        reference contracts it in fp32 whatever ``bf16_attention`` says."""
        cfg, (B, S) = self.cfg, x.shape[:2]
        ck, cv = attn.gqa_kv(p.cross, enc, n_kv=cfg.n_kv_heads, head_dim=self.head_dim,
                             positions=enc_positions, rope_theta=cfg.rope_theta)
        q = attn.gqa_q(p.cross, _norm_apply(cfg, p.ln_x, x), n_heads=self.n_q,
                       head_dim=self.head_dim, positions=positions, rope_theta=cfg.rope_theta)
        o = attn.blockwise_attention(q, *self._kv_heads(ck, cv), causal=False,
                                     q_block=self.q_block)
        self._write_prompt(cache, {"ck": ck, "cv": cv}, self.perf.hmajor_cache)
        return x + self._reduce(o.reshape(B, S, -1) @ p.cross["wo"])

    def _cross_decode(self, p, x, cache: dict, cur_len: int, enc_len: int):
        """One token's cross-attention over the ``enc_len`` encoder positions
        of the layer's ``ck``, ``cv`` (on a mesh the rank's block of them,
        its padding masked); its query rotated at ``cur_len``."""
        cfg, B = self.cfg, x.shape[0]
        pos = torch.full((B, 1), cur_len, dtype=torch.int64, device=x.device)
        q = attn.gqa_q(p.cross, _norm_apply(cfg, p.ln_x, x), n_heads=self.n_q,
                       head_dim=self.head_dim, positions=pos, rope_theta=cfg.rope_theta)
        hmajor = self.perf.hmajor_cache
        o = attn.decode_attention(q, cache["ck"], cache["cv"], enc_len,
                                  layout="bhsd" if hmajor else "bskd",
                                  bf16_compute=self.perf.bf16_attention, shard=self.shard,
                                  pos0=self._block(cache["ck"], hmajor)[0])
        return x + self._wo(p.cross, o)

    def _wo(self, p, o: torch.Tensor) -> torch.Tensor:
        """A decode step's attention output ``o`` (B, 1, Hq, d) through
        ``wo``: on a mesh the rank's heads of every rank's ``o`` through its
        rows of ``wo``, the partials summed."""
        if self.shard is not None:
            o = o[:, :, self.h0:self.h0 + self.n_q]
        return self._reduce(o.reshape(o.shape[0], 1, -1) @ p["wo"])

    def _mla_decode(self, p, x, h, pos, cache: dict, cur_len: int, absorbed: bool):
        """MLA's one-token attention: the token's latents written at
        ``cur_len`` (by the rank that holds it), then the absorbed decode
        over the latent cache, or the attention over K and V of the rank's
        heads expanded from the whole cache (on a mesh every rank's
        positions of it all-gathered first)."""
        cfg = self.cfg
        ckv_new, krope_new = self._mla_latents(p, h, pos)
        ckv, krope = cache["ckv"], cache["krope"]
        lo = self._write_token(cache, {"ckv": ckv_new, "krope": krope_new[:, :, 0]}, cur_len,
                               hmajor=False)
        if absorbed:
            return x + self._reduce(attn.mla_decode_absorbed(
                p.attn, h, ckv, krope, cur_len + 1, n_heads=self.n_q, mla=cfg.mla,
                positions=pos, rope_theta=cfg.rope_theta, bf16_compute=self.perf.bf16_attention,
                shard=self.shard, pos0=lo, h0=self.h0))
        if self.shard is not None:  # one gather of both latents' positions
            r = cfg.mla.kv_lora_rank
            lat = self.shard.gather(torch.cat([ckv, krope], -1), dim=1)
            ckv, krope = lat[..., :r].contiguous(), lat[..., r:].contiguous()
        q, k, v = self._mla_qkv(p, h, pos, ckv, krope[:, :, None])
        o = attn.decode_attention(q, k, v, cur_len + 1, bf16_compute=self.perf.bf16_attention)
        return x + self._reduce(o.reshape(x.shape[0], 1, -1) @ p.attn["wo"])

    def _attn_decode(self, p, x, cache: dict, cur_len: int, absorbed: bool = True):
        """One-token attention; writes the token's key and value (MLA: its
        latents) at ``cur_len``."""
        B = x.shape[0]
        pos = torch.full((B, 1), cur_len, dtype=torch.int64, device=x.device)
        h = _norm_apply(self.cfg, p.ln1, x)
        if self.cfg.mla is not None:
            return self._mla_decode(p, x, h, pos, cache, cur_len, absorbed)
        q, k_new, v_new = self._qkv(p, h, pos)
        hmajor = self.perf.hmajor_cache
        lo = self._write_token(cache, {"k": k_new, "v": v_new}, cur_len, hmajor)
        o = attn.decode_attention(q, cache["k"], cache["v"], cur_len + 1,
                                  layout="bhsd" if hmajor else "bskd",
                                  bf16_compute=self.perf.bf16_attention, shard=self.shard,
                                  pos0=lo)
        return x + self._wo(p.attn, o)

    def _ffn_block(self, p, x, *, use_moe: bool, decode: bool):
        """The FFN sub-block: the layer's MLP (column/row-parallel on a mesh,
        its partials summed), or its experts through the capacity dispatch
        (prefill) or all of them on each token (decode).  On a mesh the
        prefill dispatches expert-parallel where S divides over the model
        group and S >= tp, and takes the decode's path otherwise (the
        reference's rule)."""
        h = _norm_apply(self.cfg, p.ln2, x)
        if not use_moe:
            return x + self._reduce(mlp_apply(p.mlp, h, self.cfg.mlp))
        kw = {"cfg": self.cfg.moe, "mlp_kind": self.cfg.mlp}
        if self.shard is None:
            fn = moe.moe_apply_local if decode else moe.moe_apply_capacity
            y, _, _ = fn(p.moe, h, **kw)
        elif decode or not self._expert_parallel(h.shape[1]):
            y, _, _ = moe.moe_apply_local(p.moe, h, shard=self.shard, **kw)
        else:
            y, _, _ = moe.moe_apply_a2a(p.moe, h, self.shard, **kw)
        return x + y

    def _expert_parallel(self, seq: int) -> bool:
        """Whether a prefill of ``seq`` positions dispatches its experts
        through the all-to-all (the reference's rule)."""
        return seq % self.shard.tp == 0 and seq >= self.shard.tp

    def _ssm_block(self, p, x, state: dict, *, decode: bool):
        """The Mamba1 or Mamba2 sub-block, its prefill form or (``decode``)
        its one-token form on the layer's ``state``; writes the new state
        into ``state``.  On a mesh the rank's channels or heads, ``out_proj``'s
        partial sums summed."""
        h = _norm_apply(self.cfg, p.ln, x)
        apply = ssm.mamba2_apply if self.cfg.ssm.kind == "mamba2" else ssm.mamba1_apply
        y, new = apply(p.mamba, h, cfg=self.cfg.ssm, state=state if decode else None,
                       shard=self.shard)
        state["ssm"].copy_(new["ssm"])
        state["conv"].copy_(new["conv"])
        return x + self._reduce(y)

    def _groups(self):
        """(cache key, blocks, whether they hold experts) in the order the
        layers run."""
        return [(name, g, use_moe) for name, g, use_moe in (
            ("dense0", self.dense0, False), ("blocks", self.blocks, self.cfg.moe is not None))
            if len(g)]

    def _new_states(self, lead: tuple, batch: int) -> dict:
        """Zeroed SSM states with the leading layer axes ``lead``: Mamba1's
        ssm (B, di, N), Mamba2's (B, H, P, N), both fp32, and the conv's
        last K-1 inputs (B, K-1, di, or di + 2N for Mamba2); on a mesh di
        and H are the rank's 1 / tp (B and C whole)."""
        s = self.cfg.ssm
        di = s.expand * self.cfg.d_model // (1 if self.shard is None else self.shard.tp)
        if s.kind == "mamba2":
            ssm_shape, conv_dim = (di // s.headdim, s.headdim, s.d_state), di + 2 * s.d_state
        else:
            ssm_shape, conv_dim = (di, s.d_state), di
        return {"ssm": torch.zeros((*lead, batch, *ssm_shape), dtype=torch.float32,
                                   device=self.device),
                "conv": torch.zeros((*lead, batch, s.d_conv - 1, conv_dim), dtype=self.dtype,
                                    device=self.device)}

    def _kv_shape(self, batch: int, n: int) -> tuple:
        """One layer's keys or values of ``n`` positions, in the layout
        ``hmajor_cache`` sets."""
        return ((batch, self.cfg.n_kv_heads, n, self.head_dim) if self.perf.hmajor_cache
                else (batch, n, self.cfg.n_kv_heads, self.head_dim))

    def _new_cache(self, batch: int, max_len: int, enc_len: int = 0) -> dict:
        """A zeroed cache of ``max_len`` positions (on a mesh the rank's
        block of them) for every layer group (an SSM's states, which have no
        position axis; the hybrid's shared-block keys and values a group
        beside its groups' states; the audio decoder's keys and values
        beside its cross keys and values of ``enc_len`` positions, an
        ``EncDecCache``)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return self._new_states((len(self.blocks),), batch)
        max_len = self._positions(max_len)
        if cfg.family == "audio":
            return EncDecCache(
                {key: torch.zeros((len(self.dec_blocks), *self._kv_shape(batch, n)),
                                  dtype=self.dtype, device=self.device)
                 for key, n in (("k", max_len), ("v", max_len), ("ck", self._positions(enc_len)),
                                ("cv", self._positions(enc_len)))}, enc_len)
        if cfg.mla is not None:  # one layout whatever hmajor_cache says
            per_layer = {"ckv": (batch, max_len, cfg.mla.kv_lora_rank),
                         "krope": (batch, max_len, cfg.mla.qk_rope_dim)}
        else:
            shape = self._kv_shape(batch, max_len)
            per_layer = {"k": shape, "v": shape}
        if cfg.family == "hybrid":
            G = len(self.blocks)
            return {**{key: torch.zeros((G, *shape), dtype=self.dtype, device=self.device)
                       for key, shape in per_layer.items()},
                    "states": self._new_states((G, cfg.attn_every), batch)}
        return {name: {key: torch.zeros((len(g), *shape), dtype=self.dtype, device=self.device)
                       for key, shape in per_layer.items()}
                for name, g, _ in self._groups()}

    def _hybrid(self, x, cache: dict, *, positions=None, cur_len: int | None = None):
        """The hybrid stack over the embeddings x (the prefill with
        ``positions``, a decode step at ``cur_len``): per group g, the shared
        block on ``cat(x, x0) @ w_in``, writing group g's keys and values,
        added to x; then the group's Mamba2 layers, each writing its states
        in ``cache["states"]``."""
        sh, x0, decode = self.shared, x, cur_len is not None
        for g, group in enumerate(self.blocks):
            xin = torch.cat([x, x0], dim=-1) @ sh.w_in
            kv = {k: cache[k][g] for k in ("k", "v")}
            xin = (self._attn_decode(sh, xin, kv, cur_len) if decode
                   else self._attn_prefill(sh, xin, positions, kv))
            x = x + self._ffn_block(sh, xin, use_moe=False, decode=decode)
            for j, p in enumerate(group):
                x = self._ssm_block(p, x, {k: t[g, j] for k, t in cache["states"].items()},
                                    decode=decode)
        return x

    def _audio(self, x, cache: dict, *, enc=None, positions=None, cur_len: int | None = None):
        """The audio decoder over the token embeddings x (the prefill, on the
        encoder's output ``enc``, at ``positions``; a decode step at
        ``cur_len``): per layer its self-attention, writing ``k``, ``v``,
        the cross-attention (the prefill writes ``ck``, ``cv``, a decode
        step reads them), the MLP."""
        decode = cur_len is not None
        if decode:
            enc_len = getattr(cache, "enc_len", None)
            if enc_len is None and self.shard is not None:
                raise ValueError("a decode step on a mesh needs the prefill's EncDecCache, "
                                 "which carries the encoder frames its padded ck, cv hold")
            if enc_len is None:  # a plain dict: ck holds exactly the frames
                enc_len = cache["ck"].shape[3 if self.perf.hmajor_cache else 2]
        else:
            B, Se = enc.shape[:2]
            enc_positions = torch.arange(Se, device=self.device).expand(B, Se)
        for i, p in enumerate(self.dec_blocks):
            c = {k: t[i] for k, t in cache.items()}
            if decode:
                x = self._cross_decode(p, self._attn_decode(p, x, c, cur_len), c, cur_len,
                                       enc_len)
            else:
                x = self._cross_prefill(p, self._attn_prefill(p, x, positions, c), enc,
                                        positions, enc_positions, c)
            x = self._ffn_block(p, x, use_moe=False, decode=decode)
        return x

    def _encode(self, frames):
        """The audio encoder over ``frames`` (B, Se, D) at positions 0 .. Se - 1:
        pre-norm blocks of non-causal attention and MLP, then ``enc_norm``."""
        B, Se = frames.shape[:2]
        positions = torch.arange(Se, device=self.device).expand(B, Se)
        h = frames
        for p in self.enc_blocks:
            h = self._ffn_block(p, self._enc_attn(p, h, positions), use_moe=False, decode=False)
        return _norm_apply(self.cfg, self.enc_norm, h)

    # -- training ---------------------------------------------------------------

    def trainable_params(self) -> dict[str, nn.Parameter]:
        """Every parameter, by its state-dict name, with ``requires_grad``
        set (the serving entry points run under ``torch.no_grad`` and are
        unaffected)."""
        params = dict(self.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        return params

    def _ckpt(self, fn, *args):
        """``fn(*args)`` under the ``remat_policy``: a non-reentrant
        ``torch.utils.checkpoint`` ("full"), the same with selective
        checkpointing that saves the no-batch-dim products ("dots"), or
        plainly ("none").  None of them changes a value."""
        from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

        policy = self.perf.remat_policy
        if policy == "none" or not torch.is_grad_enabled():
            return fn(*args)
        if policy == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=lambda: create_selective_checkpoint_contexts(
                                  _dots_policy))
        return checkpoint(fn, *args, use_reentrant=False)

    def _train_attn(self, p, x, positions, *, causal: bool = True):
        """The attention sub-block of the training forward, without a cache:
        GQA, or MLA's latents, queries and K, V expanded from the latents
        (the reference's ``mla_attention_train``), through the blockwise
        attention with each q block rematerialized."""
        cfg, (B, S) = self.cfg, x.shape[:2]
        h = _norm_apply(cfg, p.ln1, x)
        if cfg.mla is not None:
            q, k, v = self._mla_qkv(p, h, positions, *self._mla_latents(p, h, positions))
        else:
            q, k, v = self._qkv(p, h, positions)
        o = attn.blockwise_attention(q, k, v, causal=causal, q_block=self.q_block,
                                     bf16_compute=self.perf.bf16_attention, remat=True)
        return x + o.reshape(B, S, -1) @ p.attn["wo"]

    def _train_cross(self, p, x, enc, positions, enc_positions):
        """The audio decoder's cross-attention in the training forward:
        queries of ``ln_x(x)`` at ``positions``, keys and values of the
        encoder's output at ``enc_positions``, both rotated, and the mask
        causal, as the reference's ``_decoder_stack`` calls it (serving's
        cross-attention is not causal: ROADMAP §3)."""
        cfg, (B, S) = self.cfg, x.shape[:2]
        q = attn.gqa_q(p.cross, _norm_apply(cfg, p.ln_x, x), n_heads=cfg.n_heads,
                       head_dim=self.head_dim, positions=positions, rope_theta=cfg.rope_theta)
        k, v = attn.gqa_kv(p.cross, enc, n_kv=cfg.n_kv_heads, head_dim=self.head_dim,
                           positions=enc_positions, rope_theta=cfg.rope_theta)
        o = attn.blockwise_attention(q, k, v, causal=True, q_block=self.q_block,
                                     bf16_compute=self.perf.bf16_attention, remat=True)
        return x + o.reshape(B, S, -1) @ p.cross["wo"]

    def _train_ffn(self, p, x, use_moe: bool):
        """The FFN sub-block of the training forward: (x + y, aux, z), the
        MLP's aux and z None; the experts through the capacity dispatch, or
        in ``local_mode`` every expert on every token (``moe_apply_dense``)."""
        cfg = self.cfg
        h = _norm_apply(cfg, p.ln2, x)
        if not use_moe:
            return x + mlp_apply(p.mlp, h, cfg.mlp), None, None
        fn = moe.moe_apply_dense if self.local_mode else moe.moe_apply_capacity
        y, aux, z = fn(p.moe, h, cfg=cfg.moe, mlp_kind=cfg.mlp)
        return x + y, aux, z

    def _train_layer(self, p, x, positions, *, use_moe: bool = False, enc=None,
                     enc_positions=None):
        """One decoder layer of the training forward: its attention, the
        cross-attention on ``enc`` (the audio decoder), the MLP or experts.
        Returns (x, aux, z), zeros for an MLP."""
        x = self._train_attn(p, x, positions)
        if enc is not None:
            x = self._train_cross(p, x, enc, positions, enc_positions)
        x, aux, z = self._train_ffn(p, x, use_moe)
        if aux is None:
            aux = z = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux, z

    def _train_decoder(self, x, positions, *, enc=None):
        """The decoder stack of the training forward, each layer under the
        remat policy: the leading dense blocks, then ``blocks`` (the audio
        decoder's ``dec_blocks``, with the encoder's output ``enc``).  Returns
        (x, aux, z), aux and z summed over the expert layers (the reference's
        ``_decoder_stack``)."""
        cfg, dev = self.cfg, x.device
        aux = z = torch.zeros((), dtype=torch.float32, device=dev)
        enc_positions = None
        if enc is not None:
            B, Se = enc.shape[:2]
            enc_positions = torch.arange(Se, device=dev).expand(B, Se)
        for p in self.dense0:
            x = self._ckpt(lambda x, p=p: self._train_layer(p, x, positions)[0], x)
        blocks = self.dec_blocks if cfg.family == "audio" else self.blocks
        for p in blocks:
            x, a, zz = self._ckpt(lambda x, p=p: self._train_layer(
                p, x, positions, use_moe=cfg.moe is not None, enc=enc,
                enc_positions=enc_positions), x)
            aux, z = aux + a, z + zz
        return x, aux, z

    def _train_encoder(self, frames):
        """The audio encoder of the training forward: each layer (non-causal
        attention, the MLP) under the remat policy, then ``enc_norm``."""
        B, Se = frames.shape[:2]
        positions = torch.arange(Se, device=self.device).expand(B, Se)

        def layer(h, p):
            return self._train_ffn(p, self._train_attn(p, h, positions, causal=False),
                                   False)[0]

        h = frames
        for p in self.enc_blocks:
            h = self._ckpt(lambda h, p=p: layer(h, p), h)
        return _norm_apply(self.cfg, self.enc_norm, h)

    def _train_mamba(self, p, x):
        """One pre-norm Mamba1 or Mamba2 layer of the training forward (its
        scan's training form: ``ssm.selective_scan``)."""
        apply = ssm.mamba2_apply if self.cfg.ssm.kind == "mamba2" else ssm.mamba1_apply
        return x + apply(p.mamba, _norm_apply(self.cfg, p.ln, x), cfg=self.cfg.ssm)[0]

    def _train_hybrid(self, x, positions):
        """The hybrid stack of the training forward: per group the shared
        block on ``cat(x, x0) @ w_in`` (x0 the embeddings) added to x, then
        the group's Mamba2 layers, each under the remat policy (the
        reference's ``_hybrid_stack``, which rematerializes the Mamba layers
        and leaves the shared block to its attention's own)."""
        sh, x0 = self.shared, x
        for group in self.blocks:
            xin = self._train_attn(sh, torch.cat([x, x0], dim=-1) @ sh.w_in, positions)
            x = x + self._train_ffn(sh, xin, False)[0]
            for p in group:
                x = self._ckpt(lambda x, p=p: self._train_mamba(p, x), x)
        return x

    # -- training on a mesh (the dense family) ----------------------------------

    def _mesh_attn(self, p, x, positions):
        """The attention sub-block of the training forward on a mesh (the
        placement of ``models/sharding.py``'s table).  ``"none"``: the rank's
        q heads and the kv heads they read, on the whole sequence (gathered
        from the blocks, or entered whole), its rows of ``wo``, the partials
        summed (reduce-scattered back to the blocks).  ``"ulysses"``: the
        rank's block of the sequence (its own, or split off the whole) with
        every q head, through ``wq``, ``bq`` and ``wo`` gathered whole
        (``Shard.gather_leaves``) and the whole ``wk``, ``wv``;
        ``ulysses_attention``; the block through the gathered ``wo``
        (joined back to the whole sequence)."""
        sh, cfg = self.shard, self.cfg
        B, S = positions.shape
        seq = self.perf.seq_sharded_residual
        h = _norm_apply(cfg, p.ln1, x)
        if self.sp_mode == "ulysses":
            s0, s = sh.seq_block(S)
            names = [k for k in ("wq", "bq", "wo") if k in p.attn]
            w = dict(p.attn, **dict(zip(names, sh.gather_leaves(
                [p.attn[k] for k in names], [sharding.block_split_dim(f"attn.{k}")
                                             for k in names]))))
            q, k, v = attn.gqa_qkv(w, h if seq else sh.split_seq(h, 1),
                                   n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                                   head_dim=self.head_dim, positions=positions[:, s0:s0 + s],
                                   rope_theta=cfg.rope_theta)
            o = attn.ulysses_attention(q, k, v, sh, causal=True, q_block=self.q_block)
            y = o.reshape(B, s, -1) @ w["wo"]
            return x + (y if seq else sh.join_seq(y, 1))
        q, k, v = self._qkv(p, sh.gather_seq(h, 1) if seq else sh.enter(h), positions)
        o = attn.blockwise_attention(q, *self._kv_heads(k, v), causal=True, q_block=self.q_block,
                                     bf16_compute=self.perf.bf16_attention, remat=True)
        y = o.reshape(B, S, -1) @ p.attn["wo"]
        return x + (sh.scatter_seq(y, 1) if seq else sh.sum(y))

    def _mesh_ffn(self, p, x):
        """The MLP sub-block on a mesh: the rank's columns and rows, on the
        whole sequence (gathered or entered), the partials summed
        (reduce-scattered)."""
        sh, seq = self.shard, self.perf.seq_sharded_residual
        h = _norm_apply(self.cfg, p.ln2, x)
        y = mlp_apply(p.mlp, sh.gather_seq(h, 1) if seq else sh.enter(h), self.cfg.mlp)
        return x + (sh.scatter_seq(y, 1) if seq else sh.sum(y))

    def _mesh_loss(self, batch, denom):
        """``loss`` of the dense family on a mesh: the vocabulary-parallel
        lookup summed (reduce-scattered to the rank's block of the sequence
        under ``seq_sharded_residual``), each layer under the remat policy,
        the final norm, and ``chunked_xent`` over the rank's columns of the
        head."""
        cfg, sh, dev = self.cfg, self.shard, self.device
        tokens = batch["tokens"].to(dev)
        B, S = tokens.shape
        seq = self.perf.seq_sharded_residual
        if seq or self.sp_mode == "ulysses":
            sh.seq_block(S)  # raises where tp does not divide S
        e = vocab_lookup(self.embed, tokens, sh.rank * self.embed.shape[0])
        x = (sh.scatter_seq(e, 1) if seq else sh.sum(e)).to(self.dtype)
        positions = torch.arange(S, device=dev).expand(B, S)
        for p in self.blocks:
            x = self._ckpt(lambda x, p=p: self._mesh_ffn(p, self._mesh_attn(p, x, positions)), x)
        h = _norm_apply(cfg, self.final_norm, x)
        h = sh.gather_seq(h, 1) if seq else sh.enter(h)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        xent = chunked_xent(h, w, batch["targets"].to(dev), batch["mask"].to(dev),
                            self.xent_chunks, denom, shard=sh, v0=sh.rank * w.shape[1])
        return xent, {"xent": xent, "aux": torch.zeros((), dtype=torch.float32, device=dev)}

    def summed_over_model(self, name: str) -> bool:
        """Whether the training gradient of the leaf ``name`` is a partial
        sum over "model" (``sharding.grad_summed_over_model``)."""
        return sharding.grad_summed_over_model(name, self.perf.seq_sharded_residual)

    def split_over_model(self, name: str) -> bool:
        """Whether this LM holds a slice of the leaf ``name`` (on a mesh)."""
        return self.shard is not None and sharding.split_dim(name) is not None

    def sum_partial_grads(self, grads: dict) -> None:
        """Sum over "model", in place, the gradients of the leaves
        ``summed_over_model`` (one fp32 all_reduce of them all, cast back
        once), so that every model rank holds each whole leaf's gradient."""
        names = [k for k in grads if self.summed_over_model(k)]
        if self.shard is None or not names:
            return
        flat = self.shard.reduce(torch.cat([grads[k].float().reshape(-1) for k in names]))
        for k, piece in zip(names, flat.split([grads[k].numel() for k in names])):
            grads[k].copy_(piece.view_as(grads[k]))

    def loss_not_ported(self) -> str | None:
        """Why ``loss`` cannot train this LM, or None (any family on one
        device or one data-parallel rank; the dense family on a mesh)."""
        if self.shard is not None and self.cfg.family != "dense":
            return (f"{self.cfg.name}: the loss of a {self.cfg.family!r} LM on a mesh "
                    "(tensor-parallel training) is not ported yet (ROADMAP §1); data-parallel "
                    "training takes a mesh-less LM on each rank and a mesh for the Trainer")
        return None

    def local(self) -> LM:
        """This LM in ``local_mode``, its parameters the same tensors: the
        reference's per-shard LM of its compressed-gradient Trainer, whose
        expert layers train through ``moe_apply_dense`` (every expert on
        every token, nothing dropped).  No other family changes."""
        new = copy.copy(self)
        new.local_mode = True
        return new

    def loss(self, batch: dict, *, denom: torch.Tensor | None = None, n_ranks: int = 1):
        """The training loss of ``batch`` (``tokens``, ``targets`` (B, S)
        int64, ``mask`` (B, S) fp32; the VLM and audio families also
        ``frontend`` (B, F, D)): returns (total, {"xent", "aux"}), the
        reference's ``LM.loss``: the mean token cross-entropy, plus for the
        MoE family ``aux_coef`` times the load-balance loss and
        ``zloss_coef`` times the router z-loss, each summed over the expert
        layers ("aux" is that sum).  The VLM's frontend embeddings go before
        the tokens, at positions 0 .. F - 1, and leave before the
        cross-entropy; the audio family encodes ``frontend`` as its frames.
        ``denom`` divides the masked sum instead of this batch's mask count,
        and ``n_ranks`` divides the aux and z terms: a data-parallel rank
        passes the whole batch's count and the group's size, so that the
        ranks' summed totals and gradients are the whole batch's mean
        cross-entropy plus the mean of the ranks' terms (the gradient the
        reference takes: ROADMAP §3).  Each layer runs under the
        ``remat_policy``; gradients reach the parameters of
        ``trainable_params``.  On a mesh (the dense family) ``batch`` is
        this data rank's rows, the same on each of its model ranks, which
        return the same loss; the gradients of the leaves
        ``summed_over_model`` are partial sums (``sum_partial_grads``)."""
        why = self.loss_not_ported()
        if why:
            raise NotImplementedError(why)
        if self.shard is not None:
            return self._mesh_loss(batch, denom)
        cfg, dev = self.cfg, self.device
        tokens = batch["tokens"].to(dev)
        B, S = tokens.shape
        x = torch.nn.functional.embedding(tokens, self.embed).to(self.dtype)
        aux = z = torch.zeros((), dtype=torch.float32, device=dev)
        positions = torch.arange(S, device=dev).expand(B, S)
        if cfg.family == "vlm":
            fe = batch["frontend"].to(device=dev, dtype=self.dtype)
            n = fe.shape[1]
            x = torch.cat([fe, x], dim=1)
            x, aux, z = self._train_decoder(x, torch.arange(n + S, device=dev).expand(B, n + S))
            x = x[:, n:]
        elif cfg.family == "audio":
            enc = self._train_encoder(batch["frontend"].to(device=dev, dtype=self.dtype))
            x, aux, z = self._train_decoder(x, positions, enc=enc)
        elif cfg.family == "ssm":
            for p in self.blocks:
                x = self._ckpt(lambda x, p=p: self._train_mamba(p, x), x)
        elif cfg.family == "hybrid":
            x = self._train_hybrid(x, positions)
        else:
            x, aux, z = self._train_decoder(x, positions)
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        xent = chunked_xent(_norm_apply(cfg, self.final_norm, x), w, batch["targets"].to(dev),
                            batch["mask"].to(dev), self.xent_chunks, denom)
        total = xent
        if cfg.moe is not None:
            total = (xent + cfg.moe.aux_coef / n_ranks * aux
                     + cfg.moe.zloss_coef / n_ranks * z)
        return total, {"xent": xent, "aux": aux}

    # -- serving ----------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch: dict, *, max_len: int | None = None):
        """Process a prompt batch (``tokens`` (B, S); the VLM and audio
        families also ``frontend`` (B, F, D), put before the tokens or
        encoded); returns (cache of ``max_len`` or S positions (the VLM's
        F + S), or an SSM's states, and last-token fp32 logits (B, 1, V)).
        On a mesh every rank takes the whole batch and returns the whole
        logits (V the padded vocabulary); its cache holds its rows and its
        block of ``ceil(max_len / tp)`` positions."""
        tokens = batch["tokens"].to(self.device)
        n_rows = tokens.shape[0]
        x = self._embed(self._rows(tokens))
        if self.cfg.family in ("vlm", "audio"):  # its rows split with the tokens'
            frontend = self._rows(batch["frontend"].to(device=self.device, dtype=self.dtype))
            if self.cfg.family == "vlm":
                x = torch.cat([frontend, x], dim=1)
        B, S = x.shape[:2]
        M = max_len or S
        if M < S:
            raise ValueError(f"max_len {M} is shorter than the prompt ({S})")
        positions = torch.arange(S, device=self.device).expand(B, S)
        if self.cfg.family == "audio":
            cache = self._new_cache(B, M, frontend.shape[1])
            x = self._audio(x, cache, enc=self._encode(frontend), positions=positions)
            return cache, self._last_logits(x, n_rows)
        cache = self._new_cache(B, M)
        if self.cfg.family == "ssm":
            for i, p in enumerate(self.blocks):
                x = self._ssm_block(p, x, {k: t[i] for k, t in cache.items()}, decode=False)
            return cache, self._last_logits(x, n_rows)
        if self.cfg.family == "hybrid":
            return cache, self._last_logits(self._hybrid(x, cache, positions=positions), n_rows)
        for name, group, use_moe in self._groups():
            for i, p in enumerate(group):
                x = self._attn_prefill(p, x, positions, {k: t[i] for k, t in cache[name].items()})
                x = self._ffn_block(p, x, use_moe=use_moe, decode=False)
        return cache, self._last_logits(x, n_rows)

    @torch.no_grad()
    def decode_step(self, cache: dict, token: torch.Tensor, cur_len, *, absorbed: bool = True):
        """token: (B,) ids; cur_len: the cache's current length (the VLM's
        counts its frontend positions).  Returns
        (the cache, written in place, and fp32 logits (B, V)).  ``absorbed``
        picks MLA's decode form (no effect on GQA).  An SSM's states have no
        position axis: ``cur_len`` does not bound them.  On a mesh ``token``
        and the logits are the whole batch's; the cache holds ``tp`` times
        its blocks' positions."""
        n_rows = token.shape[0]
        x = self._embed(self._rows(token.to(self.device))[:, None])
        if self.cfg.family == "ssm":
            for i, p in enumerate(self.blocks):
                x = self._ssm_block(p, x, {k: t[i] for k, t in cache.items()}, decode=True)
            return cache, self._last_logits(x, n_rows)[:, 0]
        cur_len = int(cur_len)
        # the hybrid's and the audio decoder's k and v lie at the top of the
        # cache, the others' in a group
        kv = cache if self.cfg.family in ("hybrid", "audio") else next(iter(cache.values()))
        max_len = (kv["k"].shape[-2] if self.perf.hmajor_cache else kv["k"].shape[-3]
                   ) if "k" in kv else kv["ckv"].shape[2]
        max_len *= 1 if self.shard is None else self.shard.tp
        if not 0 <= cur_len < max_len:
            raise ValueError(f"cur_len {cur_len} outside a cache of {max_len} positions")
        if self.cfg.family == "hybrid":
            return cache, self._last_logits(self._hybrid(x, cache, cur_len=cur_len),
                                            n_rows)[:, 0]
        if self.cfg.family == "audio":
            return cache, self._last_logits(self._audio(x, cache, cur_len=cur_len), n_rows)[:, 0]
        for name, group, use_moe in self._groups():
            for i, p in enumerate(group):
                x = self._attn_decode(p, x, {k: t[i] for k, t in cache[name].items()}, cur_len,
                                      absorbed)
                x = self._ffn_block(p, x, use_moe=use_moe, decode=True)
        return cache, self._last_logits(x, n_rows)[:, 0]

    def collectives_per_step(self, *, trainer: bool = False) -> Counter:
        """The collectives, by kind, of one ``loss`` and its backward on a
        mesh (nothing without one): the module docstring's training formula,
        the recomputation of each layer under a remat policy (which stops
        before the layer's closing sum or reduce-scatter: no saved tensor
        needs it) and of each cross-entropy chunk counted; with ``trainer``
        also the three all_reduces of a step of ``Trainer.run`` (the partial
        gradients and the split leaves' squared norm over "model", the
        ranks' stop flag over the mesh)."""
        if self.shard is None:
            return Counter()
        c = 1 if self.perf.remat_policy == "none" else 2
        seq = self.perf.seq_sharded_residual
        if self.sp_mode == "ulysses":
            layer = Counter({"all_to_all": 2 * c + 2, "all_gather": 2 * c + 1,
                             "reduce_scatter": 1})
            layer.update({("reduce_scatter" if seq else "all_reduce"): 2})
        elif seq:
            layer = Counter(all_gather=2 * c + 2, reduce_scatter=c + 3)
        else:
            layer = Counter(all_reduce=c + 3)
        n = Counter(all_reduce=4 * self.xent_chunks + 3 * trainer)
        n.update(Counter(reduce_scatter=2, all_gather=2) if seq else Counter(all_reduce=2))
        for _ in self.blocks:
            n.update(layer)
        return n

    def collectives_per_call(self, batch: int, seq: int | None = None, *,
                             absorbed: bool = True) -> Counter:
        """The collectives, by kind, that a prefill of ``batch`` x ``seq``
        positions (the VLM's F + S; a decode step where ``seq`` is None, of
        MLA's ``absorbed`` form) issues: the module docstring's formula
        (nothing without a mesh)."""
        if self.shard is None:
            return Counter()
        g = int(self.shard.rows(batch) is not None)
        if self.cfg.family == "ssm":
            return Counter(all_reduce=1 + 2 * len(self.blocks), all_gather=1 + g)
        if self.cfg.family == "hybrid":
            G = len(self.blocks)
            L_m = G * self.cfg.attn_every
            if seq is None:
                return Counter(all_reduce=1 + 5 * G + 2 * L_m, all_gather=G + 1 + g)
            return Counter(all_reduce=1 + 2 * G + 2 * L_m, all_gather=1 + g)
        if self.cfg.family == "audio":
            L, L_enc = len(self.dec_blocks), len(self.enc_blocks)
            if seq is None:
                return Counter(all_reduce=1 + 9 * L, all_gather=2 * L + 1 + g)
            return Counter(all_reduce=1 + 2 * L_enc + 3 * L, all_gather=1 + g)
        L_e = len(self.blocks) if self.cfg.moe is not None else 0
        L = len(self.dense0) + len(self.blocks)
        L_d, s = L - L_e, int(bool(self.cfg.moe and self.cfg.moe.n_shared))
        a = 4 if absorbed or self.cfg.mla is None else 1  # a decode layer's attention reduces
        if seq is None:
            counts = Counter(all_reduce=1 + a * L + L_d + (1 + s) * L_e, all_gather=L + 1 + g)
        elif self._expert_parallel(seq):
            counts = Counter(all_reduce=1 + L + L_d + s * L_e, all_to_all=2 * L_e,
                             all_gather=L_e + 1 + g)
        else:
            counts = Counter(all_reduce=1 + L + L_d + (1 + s) * L_e, all_gather=1 + g)
        return +counts  # the kinds it issues
