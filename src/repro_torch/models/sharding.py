"""Tensor, expert and sequence parallelism of the serving LM over a
``("data", "model")`` mesh (the port of ``repro/models/sharding.py`` and of
the leaf rules of the reference's ``LM.param_specs`` and ``cache_specs``).

The reference names a ``PartitionSpec`` for each leaf and lets GSPMD place
the collectives; here each rank holds its slice of each tensor and issues
the collectives itself.  The rules, by leaf name (a state-dict key):

* column-parallel, the output dim split over ``"model"``: ``attn.wq``,
  ``attn.bq``, ``mlp.w_gate``, ``mlp.w_up`` (and a MoE's ``shared`` MLP's),
  MLA's ``attn.w_uk`` and ``attn.w_uv`` (r, H * d; the reference's
  ``P(None, tp)``); ``wq`` is head-major (MLA's (H, dn + dr) too), so that a
  rank's columns are whole heads;
* row-parallel, the input dim split: ``attn.wo``, ``mlp.w_down``;
* whole on every rank: ``attn.wk``, ``wv``, ``bk``, ``bv`` (the reference
  leaves the kv heads unsharded), MLA's ``attn.w_dkv`` and ``attn.kv_norm``
  (the latents), ``moe.router``, the norms;
* the audio family's ``enc_blocks`` by the same rules, and its
  ``dec_blocks``' ``cross`` by ``attn``'s (``wq`` by column, ``wo`` by row,
  ``wk``, ``wv`` whole); ``ln_x`` and ``enc_norm`` whole;
* the expert stacks (E, d_in, d_out): E split over ``"model"``;
* ``embed`` (V, D) split on vocabulary rows and ``lm_head`` (D, V) on
  vocabulary columns, V padded to a multiple of model x data as the
  reference pads it (``vocab_padded``);
* every cache's positions split over ``"model"`` in contiguous blocks of
  ``ceil(M / tp)``, the last block's tail padding (``Shard.positions``):
  the KV cache, MLA's latent cache ``ckv``/``krope``, the audio decoder's
  cross cache ``ck``/``cv`` of Se encoder frames;
* the batch split over ``"data"`` where it divides (``Shard.rows``), and
  with it the VLM's frontend rows and the audio encoder's frames.

* the Mamba layers (``blocks.<i>.mamba``; the hybrid's
  ``blocks.<g>.<j>.mamba``) by whole channels (Mamba1) or whole heads
  (Mamba2), each rank its contiguous 1/tp of each split part: Mamba1's
  ``in_proj`` (D, 2 Di) of parts [x | z], both split by channel, ``conv_w``,
  ``conv_b``, ``dt_bias``, ``A_log`` and ``D`` split on Di, ``x_proj`` (Di,
  dtr + 2N) by rows (its product summed with an ``all_reduce`` before dt, B
  and C are split) and ``dt_proj`` (dtr, Di) by output columns, so that dt
  is the rank's own (the reference splits dtr); Mamba2's ``in_proj`` (D, 2
  di + 2N + H) of parts [z | x | B | C | dt], z, x and dt split by head, B
  and C whole, ``conv_w``, ``conv_b`` of parts [x | B | C], x split by head,
  B and C whole (every rank convolves B and C whole), ``dt_bias``, ``A_log``,
  ``D`` split on H and ``norm_w`` by head (the gated norm's mean square is
  over the whole di: one ``all_reduce``); ``out_proj`` by rows for both;
  the layer's ``ln`` whole.  ``leaf_parts`` names each parted leaf's parts
  and ``cut`` takes a rank's slice of any leaf;
* the hybrid's ``shared`` block by the attention's and the MLP's rules,
  its ``ln1``, ``ln2`` whole and its ``w_in`` (2d, d) whole (the reference
  splits its columns; the block's norm reads all of them);
* the SSM states: Mamba1's ``ssm`` (B, Di / tp, N) and ``conv`` (B, K-1,
  Di / tp), the reference's contiguous blocks; Mamba2's ``ssm`` (B, H / tp,
  P, N), the reference's block, and ``conv`` (B, K-1, di / tp + 2N), the
  rank's x channels beside B and C whole (the reference's is a contiguous
  block of di + 2N).

The reference also shards every weight over ``"data"`` (FSDP), a storage
layout with the same results; here the weights are whole over ``"data"``.
Every family has rules; a leaf without one raises ``NotImplementedError``.

Training the dense family on a mesh (``LM.loss``) places its leaves as
serving does, in both ``sp_mode``s: the placement does not depend on the
mode, so a checkpoint, an optimizer state or a served LM is the same under
either.  "own": the rank's gradient of its slice is the whole gradient of
that slice; "summed": the leaf is whole on every rank, each rank's
gradient of it a partial sum (its kv heads' share, or its sequence
positions'), which the Trainer sums over ``"model"``
(``grad_summed_over_model``); "whole": whole, its gradient the same on
every rank.  Every gradient is then summed over ``"data"``.

  residual:                 whole        seq-sharded
  embed (V, D) by rows      own          own
  lm_head (D, V) by cols    own          own
  attn.wq, bq by cols       own          own
  attn.wo by rows           own          own
  attn.wk, wv, bk, bv       summed       summed
  mlp.w_gate, w_up by cols  own          own
  mlp.w_down by rows        own          own
  ln1, ln2, final_norm      whole        summed

("seq-sharded": ``seq_sharded_residual``, the residual stream between
blocks split over "model" by sequence position.)

Under ``"none"`` a rank's attention runs its own q heads on the whole
sequence.  Under ``"ulysses"`` a rank projects its own block of the
sequence with every q head: its block's sub-block all-gathers ``wq``,
``bq`` and ``wo`` (``gather_leaves``: one all_gather of the three slices
forward, one reduce_scatter of their gradients backward, so that each
rank's gradient is again its slice's whole one), the all-to-all regroups
the block by head (``attention.ulysses_attention``), and the block of the
output leaves through the gathered ``wo``.  So a card holds 1/tp of the
attention's weights and moments in both modes, and one layer's whole
``wq`` and ``wo`` at a time under Ulysses.  The MLP is column/row-parallel
in every form.  Where tp does not divide Hq the LM cannot be built on the
mesh (``LM._place``), so the reference's fallback to the blockwise
attention there has no counterpart (ROADMAP §3).

The training collectives autograd goes through (each a ``Shard`` method,
counted as the serving ones, a reduce-scatter as ``"reduce_scatter"``; sums
in fp32, cast back once):

* ``sum`` — all_reduce forward, identity backward (Megatron's g: a
  row-parallel product's partial sums);
* ``enter`` — identity forward, all_reduce backward (Megatron's f: a whole
  input into each rank's own columns);
* ``gather_seq`` — all_gather of the sequence forward, reduce_scatter
  backward (a sequence block into each rank's own columns), and its
  converse ``scatter_seq``;
* ``split_seq`` — the rank's block of a whole sequence forward, all_gather
  backward, and its converse ``join_seq``;
* ``swap`` — the all_to_all, whose adjoint is the reverse all_to_all (the
  same exchange: chunk r of rank s goes to chunk s of rank r);
* ``gather_leaves`` — the whole leaves of several slices, one all_gather
  of them packed forward, one reduce_scatter backward.

``gather_to_lead`` (no gradient) sends a leaf's slices to the model
group's first rank alone, one ``dist.gather``, counted as ``"gather"``:
the Trainer's checkpoint.

Every collective goes through a ``Shard`` (``reduce``, ``gather``,
``exchange`` and ``reduce_scatter``: ``torch.distributed``'s ``all_reduce``,
``all_gather``, ``all_to_all_single`` and ``reduce_scatter_tensor``) and
is counted in ``collectives`` by kind (``"all_reduce"``, ``"all_gather"``,
``"all_to_all"``, ``"reduce_scatter"``).  ``reduce`` and
``reduce_scatter`` reduce fp32 on every backend: a bf16
partial sum is cast to fp32, reduced and cast back once.  gloo does reduce
bf16 (torch 2.13 on the CPU), but a ring reduction in bf16 rounds at every
hop, and the fp32 sum of one rank's bf16 value casts back to itself bit for
bit, so that at one rank the sharded LM computes the mesh-less one exactly.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from repro_torch.core.meshutil import axis_size

#: collectives issued by a ``Shard``, by kind
collectives: Counter = Counter()

#: the dim of a block leaf split over "model" (None: whole on every rank), by
#: the sub-block and the leaf's name
_ATTN = {"wq": 1, "bq": 0, "wo": 0, "wk": None, "wv": None, "bk": None, "bv": None,
         "w_uk": 1, "w_uv": 1, "w_dkv": None, "kv_norm": None}
_MLP = {"w_gate": 1, "w_up": 1, "w_down": 0}
_EXPERTS = {"router": None, "w_gate": 0, "w_up": 0, "w_down": 0}
_MAMBA = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj": 1, "dt_bias": 0,
          "A_log": 0, "D": 0, "norm_w": 0, "out_proj": 0}

_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def mesh_sizes(mesh) -> tuple[int, int, int]:
    """(data size, model size, this rank's index on "model")."""
    return axis_size(mesh, "data"), axis_size(mesh, "model"), mesh.get_local_rank("model")


def vocab_padded(vocab: int, mesh) -> int:
    """The vocabulary rounded up to a multiple of model x data (the
    reference's ``LM.vocab_padded``); ``vocab`` without a mesh."""
    if mesh is None:
        return vocab
    dp, tp, _ = mesh_sizes(mesh)
    return -(-vocab // (tp * dp)) * (tp * dp)


SP_MODES = ("none", "ulysses")


def block_split_dim(name: str) -> int | None:
    """The dim of a block's leaf (``"attn.wq"``, ``"moe.w_up"``,
    ``"moe.shared.w_down"``, ``"cross.wq"``, ...) split over "model"; None
    where it is whole."""
    sub, *rest = name.split(".")
    leaf = rest[-1] if rest else ""
    if sub in ("ln1", "ln2", "ln_x", "ln"):
        return None
    rules = {"attn": _ATTN, "cross": _ATTN, "mlp": _MLP, "mamba": _MAMBA,
             "moe": _MLP if rest[:1] == ["shared"] else _EXPERTS}.get(sub, {})
    if len(rest) == (2 if rest[:1] == ["shared"] else 1) and leaf in rules:
        return rules[leaf]
    raise NotImplementedError(f"no tensor-parallel rule for the leaf {name!r}")


def split_dim(name: str) -> int | None:
    """The dim of the state-dict entry ``name`` split over "model"."""
    head, *rest = name.split(".")
    if name == "embed":
        return 0
    if name == "lm_head":
        return 1
    if head in ("final_norm", "enc_norm") or name == "shared.w_in":
        return None
    if head == "shared":
        return block_split_dim(".".join(rest))
    while rest[:1] and rest[0].isdigit():  # a layer's index (the hybrid's: two)
        rest = rest[1:]
    if head in ("blocks", "dense0", "enc_blocks", "dec_blocks") and rest:
        return block_split_dim(".".join(rest))
    raise NotImplementedError(f"no tensor-parallel rule for {name!r}")


def grad_summed_over_model(name: str, seq_sharded: bool) -> bool:
    """Whether the training gradient that a rank computes for the dense
    leaf ``name`` is a partial sum over "model" (the module docstring's
    table): a whole attention leaf (the kv heads'), and a norm where the
    residual stream is sequence-sharded."""
    if split_dim(name) is not None:
        return False
    head, *rest = name.split(".")
    sub = next((r for r in rest if not r.isdigit()), None)
    return (head == "blocks" and sub == "attn") or seq_sharded


def leaf_parts(cfg, name: str) -> tuple[tuple[int, bool], ...] | None:
    """The parts (size, split over "model") along the split dim of the
    Mamba leaf ``name`` (a state-dict key, or a block's ``"mamba.in_proj"``)
    where it is made of parts, each split alone; None for any other leaf."""
    *_, sub, leaf = ("", *name.split("."))
    if sub != "mamba" or cfg.ssm is None:
        return None
    s = cfg.ssm
    di, N = s.expand * cfg.d_model, s.d_state
    if s.kind != "mamba2":
        return ((di, True), (di, True)) if leaf == "in_proj" else None
    if leaf == "in_proj":
        return ((di, True), (di, True), (N, False), (N, False), (di // s.headdim, True))
    if leaf in ("conv_w", "conv_b"):
        return ((di, True), (N, False), (N, False))
    return None


def cut(cfg, name: str, t: torch.Tensor, dim: int | None, rank: int, n: int) -> torch.Tensor:
    """Part ``rank`` of ``n`` of the leaf ``name`` along ``dim`` (its
    ``split_dim``): ``take`` of a leaf cut as one, and of a parted leaf
    (``leaf_parts``) each split part's slice beside each whole part,
    concatenated in the parts' order; ``t`` itself where ``n`` is 1 or
    ``dim`` None."""
    parts = leaf_parts(cfg, name)
    if parts is None or n == 1 or dim is None:
        return take(t, dim, rank, n)
    if sum(size for size, _ in parts) != t.shape[dim]:
        raise ValueError(f"{name}: parts {parts} do not make dim {dim} of {tuple(t.shape)}")
    pieces = t.split([size for size, _ in parts], dim)
    return torch.cat([_part(p, dim, rank, n) if split else p
                      for p, (_, split) in zip(pieces, parts)], dim)


def take(t: torch.Tensor, dim: int | None, rank: int, n: int) -> torch.Tensor:
    """Part ``rank`` of ``n`` of ``t`` along ``dim``: ``t`` itself where
    ``n`` is 1 or ``dim`` None, else a contiguous copy, so that the whole
    tensor can be freed."""
    if n == 1 or dim is None:
        return t
    return _part(t, dim, rank, n).clone(memory_format=torch.contiguous_format)


def _part(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    """Part ``rank`` of ``n`` of ``t`` along ``dim``, a view."""
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {n} ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size)


class Shard:
    """This rank's place in a ``("data", "model")`` mesh, and the counted
    collectives over its groups.  ``tp``, ``rank``: the model group's size
    and this rank's index in it; ``dp``, ``drank``: the data group's."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp, self.tp, self.rank = mesh_sizes(mesh)
        self.drank = mesh.get_local_rank("data")
        self.group, self.dgroup = mesh.get_group("model"), mesh.get_group("data")

    # -- layouts ----------------------------------------------------------------

    def heads(self, n_heads: int, n_kv: int) -> tuple[int, int, int, int]:
        """(q heads of this rank, its first q head, its kv heads' range
        [kv0, kv1)): q head h reads kv head h // G.  A rank's heads must
        cover whole GQA groups or lie within one."""
        if n_heads % self.tp:
            raise ValueError(f"{n_heads} q heads do not split over {self.tp} ranks")
        n, G = n_heads // self.tp, n_heads // n_kv
        if n % G and G % n:
            raise ValueError(f"{n} q heads a rank straddle GQA groups of {G}")
        h0 = self.rank * n
        return n, h0, h0 // G, (h0 + n - 1) // G + 1

    def positions(self, m: int) -> int:
        """Cache positions a rank holds of ``m``: ``ceil(m / tp)``; rank r
        holds global positions r * that onwards."""
        return -(-m // self.tp)

    def seq_block(self, n: int) -> tuple[int, int]:
        """(first position, positions) of this rank's block of a sequence of
        ``n`` split over "model"; raises where tp does not divide n (as the
        reference's ``shard_map`` does)."""
        if n % self.tp:
            raise ValueError(f"a sequence of {n} does not split over {self.tp} model ranks")
        s = n // self.tp
        return self.rank * s, s

    def rows(self, batch: int) -> tuple[int, int] | None:
        """This rank's rows [b0, b1) of a batch split over "data", or None
        where the batch is whole on every rank (one data rank, or a batch
        that does not divide)."""
        if self.dp == 1 or batch % self.dp:
            return None
        b = batch // self.dp
        return self.drank * b, (self.drank + 1) * b

    # -- collectives -------------------------------------------------------------

    def reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The sum (or ``op``) of ``t`` over the model group, reduced in fp32
        and returned in ``t``'s dtype (an fp32 ``t`` is reduced in place)."""
        buf = t.float().contiguous()
        dist.all_reduce(buf, op=op, group=self.group)
        collectives["all_reduce"] += 1
        return buf.to(t.dtype)

    def gather(self, t: torch.Tensor, dim: int, axis: str = "model") -> torch.Tensor:
        """The ranks' ``t`` of the ``axis`` group concatenated along ``dim``."""
        group, n = (self.group, self.tp) if axis == "model" else (self.dgroup, self.dp)
        t = t.contiguous()
        out = t.new_empty((n * t.shape[0], *t.shape[1:]))
        _all_gather(out, t, group=group)
        collectives["all_gather"] += 1
        dim %= t.ndim
        if dim == 0:
            return out
        return out.view(n, *t.shape).movedim(0, dim).flatten(dim, dim + 1)

    def exchange(self, t: torch.Tensor) -> torch.Tensor:
        """One ``all_to_all_single`` over the model group: dim 0's chunk r
        goes to rank r.  ``t`` is sent as it lies (it must be contiguous)."""
        if not t.is_contiguous():
            raise ValueError("all_to_all sends a contiguous buffer as it lies")
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        collectives["all_to_all"] += 1
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the model group of ``t``, this rank's block of it
        along ``dim``; summed in fp32 and returned in ``t``'s dtype."""
        dim %= t.ndim
        self.seq_block(t.shape[dim])  # raises where it does not split
        n = self.tp
        x = t.float()
        if dim:  # the blocks concatenated along dim 0
            x = x.unflatten(dim, (n, -1)).movedim(dim, 0).flatten(0, 1)
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        _reduce_scatter(out, x, group=self.group)
        collectives["reduce_scatter"] += 1
        return out.to(t.dtype)

    def gather_to_lead(self, t: torch.Tensor, dim: int) -> torch.Tensor | None:
        """The model group's slices ``t`` concatenated along ``dim`` on its
        first rank (None on the others), one ``dist.gather``: the slices
        travel to that rank alone."""
        t = t.contiguous()
        lead = self.rank == 0
        buf = t.new_empty((self.tp, *t.shape)) if lead else None
        dist.gather(t, list(buf.unbind(0)) if lead else None,
                    dst=dist.get_global_rank(self.group, 0), group=self.group)
        collectives["gather"] += 1
        if not lead:
            return None
        return buf.movedim(0, dim % t.ndim).flatten(dim % t.ndim, dim % t.ndim + 1)

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (a contiguous copy)."""
        s0, s = self.seq_block(t.shape[dim])
        return t.narrow(dim, s0, s).contiguous()

    # -- collectives autograd goes through (training) ---------------------------

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """all_reduce forward, identity backward (Megatron's g)."""
        return _Sum.apply(t, self)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """Identity forward, all_reduce backward (Megatron's f)."""
        return _Enter.apply(t, self)

    def gather_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """all_gather along ``dim`` forward, reduce_scatter backward."""
        return _GatherSeq.apply(t, self, dim)

    def scatter_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """reduce_scatter along ``dim`` forward, all_gather backward."""
        return _ScatterSeq.apply(t, self, dim)

    def split_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` forward, all_gather backward."""
        return _SplitSeq.apply(t, self, dim)

    def join_seq(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """all_gather along ``dim`` forward, this rank's block backward."""
        return _JoinSeq.apply(t, self, dim)

    def swap(self, t: torch.Tensor) -> torch.Tensor:
        """``exchange`` forward and backward (the all_to_all is its own
        adjoint)."""
        return _Swap.apply(t, self)

    def gather_leaves(self, leaves: list[torch.Tensor], dims: list[int]) -> list[torch.Tensor]:
        """The whole leaves of which ``leaves`` (one dtype) are this rank's
        slices along ``dims``: one all_gather of the slices packed in one
        buffer forward, one reduce_scatter of the whole leaves' gradients
        backward (each rank's gradient of its slice, summed over the
        model group)."""
        return list(_GatherLeaves.apply(self, tuple(dims), *leaves))

    def _sum_copy(self, t: torch.Tensor) -> torch.Tensor:
        """``reduce`` of a copy: autograd may hold ``t`` (a saved product)."""
        return self.reduce(t.to(torch.float32, copy=True).contiguous()).to(t.dtype)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shard):
        return shard._sum_copy(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shard):
        ctx.shard = shard
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._sum_copy(g), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard.gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.reduce_scatter(g, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard.reduce_scatter(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.gather(g, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard.block(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.gather(g, ctx.dim), None, None


class _JoinSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard.gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.block(g, ctx.dim), None, None


class _Swap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shard):
        ctx.shard = shard
        return shard.exchange(t.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.exchange(g.contiguous()), None


class _GatherLeaves(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dims, *slices):
        if len({t.dtype for t in slices}) != 1:
            raise ValueError("gather_leaves packs slices of one dtype")
        ctx.shard, ctx.dims, ctx.shapes = shard, dims, [t.shape for t in slices]
        ctx.like = slices[0].new_empty(())
        tp = shard.tp
        flat = torch.cat([t.reshape(-1) for t in slices])
        got = shard.gather(flat, 0).view(tp, -1)  # rank r's slices in row r
        return tuple(piece.reshape(tp, *shape).movedim(0, d).flatten(d, d + 1)
                     for piece, shape, d in zip(got.split([s.numel() for s in ctx.shapes], 1),
                                                ctx.shapes, dims))

    @staticmethod
    def backward(ctx, *grads):
        tp = ctx.shard.tp
        rows = [(ctx.like.new_zeros((*shape[:d], tp * shape[d], *shape[d + 1:])) if g is None
                 else g)
                .unflatten(d, (tp, -1)).movedim(d, 0).reshape(tp, -1)
                for g, shape, d in zip(grads, ctx.shapes, ctx.dims)]
        flat = ctx.shard.reduce_scatter(torch.cat(rows, 1).reshape(-1), 0)
        return (None, None, *(piece.view(shape) for piece, shape in
                              zip(flat.split([s.numel() for s in ctx.shapes]), ctx.shapes)))
