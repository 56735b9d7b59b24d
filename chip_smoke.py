#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in one process (any failed check raises and the script exits
non-zero):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, started together), print the SASS census of K4's general design
   (``fourstep_kernel``: instructions, loops, shared loads, FFMAs, called
   subroutines) and of K5's two designs (``rows_kernel``, ``tile_kernel``:
   instructions a 16-byte vector or an element, divisions; one
   ``{"sass_census"}`` line) and the card's name and power limit;
2. whether cuFFT along each axis rounds by the other axes' extents, what
   ``fftcore``'s copy to a contiguous last axis costs, and the DCT/DST
   matmul's blocks of rows against one matmul (one ``{"strided_fft"}``
   line, after the sweep below); every kernel mode
   against its plain torch version on seeded inputs, with
   CUDA-event times (one ``{"kernel_sweep": [...]}`` line; ``cuda_ms``
   times runs of back-to-back calls): K4 (each record names the design that
   ran: ``"tc"``, 3xTF32 tensor cores, or ``"general"``), K1 (both layouts,
   both codecs, guard mode and the saturation divisor; each record names the
   design that ran: ``"vec"``, 16-byte accesses, or ``"scalar"``; both must
   run), K2/K3 (each decode by its wrapper and into a block at an odd
   storage offset, which runs ``"scalar"``; each record names its design,
   both must run, all bitwise), K5 (each record names the design that
   ran: ``"rows"``, 16-byte vectors straight from x to y, or ``"tile"``,
   through shared memory; both must run, one input at an odd storage offset;
   all bitwise), and K6 (flash attention) over dtype x
   causal x GQA group x S x head dims (one for q, k and v, and MLA's 192
   for q and k beside 128 for v; each record names the design that ran:
   ``"tc"``, bf16 mma.sync, for bf16; ``"fma"`` for fp32, and the backend
   SDPA picked);
3. the port's paths on a 1-rank NCCL group and a (1, 1) mesh, each driven
   with the launch counters set to 0 just before it and read just after
   (one ``{"paths": ...}`` line, K1's and K3's launches also by design,
   K3's keyed ``"decode:<design>:<codec>"``; at 512^3 every K4 launch of a
   plan must have run the tensor-core design, and every K1 and K3 launch
   of the FFT paths the vec design):
   "slice" — (a) the quickstart plan ``(42, 63, 64)``, ``method="fused"``,
   against ``np.fft.fftn``; (b) the slice configuration (``impl="matmul"``,
   ``exchange_impl="cuda"``, ``comm_dtype="bf16"``) at ``(42, 63, 64)`` and
   at 512^3 complex64, forward and backward timed; (c) 512^3 with int8;
   "composed" — the slab plan over the composed groups ``(("p0", "p1"),)``
   and ``(("p1", "p0"),)`` beside the one-name slab ``("p0",)`` under the
   slice configuration with bf16, at 512^3 and the quickstart shape: each
   forward and backward bitwise the slab's, within the bf16 limits of
   ``torch.fft.fftn``, K1/K3/K4 launches per call exact; the 512^3
   forwards timed (one ``{"composed": [...]}`` line);
   "engines" — the traditional and pipelined (``chunks=4``) engines at 512^3
   for each ``comm_dtype``, lossless ones bitwise equal to the fused engine,
   plus each engine's single exchange timed alone; then under
   ``impl="torch"`` (cuFFT) the lossless engines bitwise equal to fused at
   512^3 and 384^3, and the 512^3 forward with and without ``fftcore``'s
   copy to a contiguous last axis (one ``{"engines_torch"}`` line);
   "guard" — ``guard="strict"`` clean runs at 512^3 (bitwise equal to the
   unguarded plan, guarded and unguarded times), then faults under
   ``guard="degrade"`` and ``"strict"`` that must end as the reference's do;
   "many" — batched multi-field execution: examples/navier_stokes.py's plan
   at 384^3 (256 retained modes), a 3-field ``forward_many`` and a 9-field
   ``backward_many`` under each ``batch_fusion`` with complex64 (bitwise
   equal to the per-field loop) and bf16 wires, each call's K4 designs,
   K1/K3 designs (``ref.tile_design`` on the plan's views) and
   ``all_to_all_single`` calls (``model_collective_launches``) checked and
   its time set beside N single-field calls, one across-fields call
   traced; the same calls under ``impl="torch"``, every mode bitwise equal
   to the loop; 3 stacked 512^3 fields through an int8 wire (field 1 at 1e3);
   the traditional engine's int8 exchange of stacked fields against the
   plain codec; guarded batches (one ``{"many": [...]}`` line, each record
   with the card's name and power limit);
   "dns" — the example twins (``repro_torch.examples``): the Navier-Stokes
   twin's RK2 Taylor-Green DNS at 256 modes on the 384^3 grid, 8 steps of
   dt 5e-4 (the example's 5e-3 is outside RK2's viscous bound there), in
   the example's configuration (cuFFT, no kernel), the slice configuration
   (K4) and with a bf16 wire (K1, K3, K4): the example's checks, the slice
   run's energies within 1e-5 of the example's at every step and the bf16
   run's within the bound of its wire's roundings, one step's launches and
   collectives exactly as the plan counts, a step's ms and a RHS's three
   batched transforms timed; the quickstart twin in the example's and the
   slice configuration; the Poisson twin at (64, 512, 512) (one ``{"dns":
   [...]}`` line); then "audit" — the run-time plan audit
   (``repro_torch.analysis.planlint``) of every example plan, any violation
   failing the run (one ``{"audit": [...]}`` line);
   then the time model's constants measured on this card (one
   ``{"coeffs"}`` line: a 1 GiB device copy, ``torch.fft.fft`` on 262144
   rows of 512, one 4 KiB ``all_to_all_single`` on the device alone, by the
   host clock and by events, each the median of 7 rounds beside their least
   and greatest; core/hardware.py holds them);
   "tune" — the schedule tuner (``method="auto"``) with its own cache
   directory: the quickstart with an int8 budget and the exchange kernels
   swept, against ``np.fft.fftn`` and replayed by a second plan with no
   timing, bitwise; 512^3 with a bf16 budget, its forward and backward
   timed beside every uniform explicit config (fused, traditional,
   pipelined(4) x complex64, bf16 x torch, cuda; those with the kernels as
   the slice and engines paths timed them) and ``model_time_s`` at this
   card's constants, and no slower than 1.25 x the fastest uniform; the DNS
   plan at 384^3, bf16 budget, 3 fields, its ``all_to_all_single`` calls
   against ``model_collective_launches``; a poisoned pipelined cache entry
   under a pipelined compile fault, ``guard="degrade"``: one quarantine, a
   retune, ok (one ``{"tune": [...]}`` line); K1, K3 and K4 must each launch,
   and their launches are logged by the arguments of each call;
   "serve" — the spectral server (``repro_torch.serve``): (a) 12 seeded
   float32 fields alternating 512^3 and the quickstart shape through the
   bf16 guarded server plan (``impl="matmul"``, ``exchange_impl="cuda"``),
   coalesced up to 4, all ``ok``, each bitwise equal to the plan's own
   ``forward`` and within 3e-3 of ``torch.fft.fftn``, then one coalesced
   4 x 512^3 group timed beside ``forward_many_padded``; (b) a strict plan
   under a bf16 wire fault: the breaker trips, every request ``degraded``
   through the lossless fallback; (c) a crash after a stall: ``ok`` after
   one retry; (d) overload: instant sheds; (e) an auto plan whose cache is
   torn under a 2x burst: all resolve, the cache is rebuilt (one
   ``{"serve": [...]}`` line); its launches are the server's own, read
   around each wave (the harness's checks and timings between waves not
   counted), logged by the arguments of each call; the group's warm
   dispatches alone must launch K1 (guard mode), K3 and K4 (both designs);
   "lm" — after the FFT paths' buffers are freed, LM serving through
   ``repro_torch.launch.serve_lm.main``: GLM-4-9B at full width and depth
   (40 layers, bf16, seeded weights), 4 prompts of 2048 tokens and 32 greedy
   decode steps under the optimized flags; K6 must launch exactly once per
   layer per prefill and never in decode, every launch on its tensor-core
   design, the prefill's logits must match
   the same weights' prefill with the plain attention, and 3 teacher-forced
   decode steps must match a prefill of S + 3 tokens (one ``{"lm": ...}``
   line);
   "moe" — after the lm path's model is freed, Phi-3.5-MoE at full width
   (d 4096, 16 experts of 6400, top-2, GQA 32/8 heads of 128, bf16, seeded
   weights), 28 of its 32 layers (the weights of 32 do not fit the card),
   served through ``serve_lm.serve`` with the lm path's traffic; K6 exactly
   once per layer per prefill, never in decode, all tc; two prefills
   bitwise equal; the prefill against the same prefill with the plain
   attention, and 3 teacher-forced decode steps against a prefill of S + 3,
   both at a capacity that drops nothing and with the second run's expert
   choices pinned to the first's, each within the limit (and unpinned,
   reported with the choices that differ); the timed prefill's dropped share
   of assignments per layer (one ``{"moe": ...}`` line);
   "parallel" — the moe path's model on a 1-rank NCCL group through
   ``make_host_mesh(1)``: ``LM.sharded`` holds its very tensors (no second
   model), served through ``serve_lm.serve`` with the same traffic (prefill
   and decode times beside the moe path's); K6 exactly once per layer per
   prefill, never in decode; the collectives of each call by kind equal to
   ``LM.collectives_per_call``; a greedy run of the sharded LM bitwise the
   mesh-less LM's in logits, ids and every cache leaf, and its ids the
   served ones; 4 decode steps of each LM timed interleaved, the sharded
   steps' device time by class and each LM's host operations, and one
   all-reduce and one all-gather alone (one ``{"parallel": ...}`` line);
   "mla" — after that model is freed, DeepSeek-V2-Lite whole (27
   layers at full width: MLA of rank 512 with heads of 128 + 64 and values
   of 128, 64 experts of 1408, top-6, beside 2 shared, one leading dense
   block, bf16, seeded weights) through ``serve_lm.main`` with the lm path's
   traffic; K6 exactly once per layer per prefill at q (4, 2048, 16, 192)
   and v (4, 2048, 16, 128), never in decode, all tc; two prefills bitwise
   equal (logits and the latent cache); the moe path's pinned comparisons;
   one absorbed decode step against the expanded one, routing pinned; the
   dropped share per layer (one ``{"mla": ...}`` line); then the model's
   one-rank twin (``twin_path``: ``LM.sharded`` on a 1-rank NCCL group,
   bitwise the mesh-less LM, the expanded decode step too; one
   ``{"mla_parallel": ...}`` line);
   "ssm" — after the mla path's model is freed, Falcon-Mamba-7B at full
   width (d 4096, d_inner 8192, d_state 16, dt_rank 256, scan chunk 128,
   bf16, seeded weights), 16 of its 64 Mamba1 layers (cut for the run's
   time), through ``serve_lm.serve`` with the lm path's traffic; no kernel of K1-K6 launches (the model has no
   attention); two prefills bitwise equal (logits, ``ssm`` and ``conv``);
   3 teacher-forced decode steps against a prefill of S + 3 tokens (a padded
   last chunk), logits within the limit, the final ``ssm`` state's rel. L2
   beside them; one layer's ``selective_scan`` at full width (B 1, T 256,
   d_inner 8192, d_state 16) against a float64 recurrence on the card at
   1e-4, and timed at the prefill's shape (one ``{"ssm": ...}`` line);
   then the model's one-rank twin (``twin_path``: no K6 launch; one
   ``{"ssm_parallel": ...}`` line);
   "hybrid" — after the ssm path's model is freed, Zamba2-2.7B whole (54
   Mamba2 layers in 9 groups of 6 at full width: d 2560, d_inner 5120, 80
   SSD heads of 64, d_state 64, chunk 128; one shared attention+MLP block,
   32 / 32 heads of 80, MLP 10240, run on concat(x, embeddings) @ w_in once
   before each group; bf16, seeded weights) through ``serve_lm.main`` with
   the lm path's traffic; K6 exactly once a group per prefill at (80, 80),
   never in decode, all tc; two prefills bitwise equal (logits, ``k``,
   ``v``, ``states.ssm``, ``states.conv``); the prefill against the same
   prefill with the plain attention; 3 teacher-forced decode steps against
   a prefill of S + 3 tokens, the final ``states.ssm``'s rel. L2 beside
   them; one layer's ``ssd_scan`` at full width (B 1, T 256, 80 heads of
   64, d_state 64) against a float64 recurrence on the card at 1e-4, and
   timed at the prefill's shape (one ``{"hybrid": ...}`` line); then the
   model's one-rank twin (``twin_path``: K6 once a group per prefill; one
   ``{"hybrid_parallel": ...}`` line);
   "vlm" — after the hybrid path's model is freed, LLaVA-NeXT-34B whole (60
   layers at full width: d 7168, 56 / 8 heads of 128, swiglu of 20480,
   vocabulary 64000, bf16, seeded weights, 64.05 GiB) through
   ``serve_lm.main`` with the lm path's traffic and 2048 seeded frontend
   embeddings before each prompt (F + S = 4096 positions, a cache of 4128);
   K6 exactly once a layer per prefill at (4, 4096, 56 / 8, 128), never in
   decode, all tc; the prefill against the same prefill with the plain
   attention (a batch row and kv head at a time); 3 teacher-forced decode
   steps against a prefill of F + S + 3 positions (one ``{"vlm": ...}``
   line); then the model's one-rank twin (``twin_path``, the mesh-less
   run's cache held on the host while the twin's is on the card; one
   ``{"vlm_parallel": ...}`` line);
   "audio" — after the vlm path's model is freed, SeamlessM4T-medium whole
   (12 encoder and 12 decoder layers at d 1024, 16 / 16 heads of 64, gelu of
   4096, layernorm, vocabulary 256,206, bf16, seeded weights) through
   ``serve_lm.main`` with the lm path's traffic and 2048 seeded frames a
   prompt for the encoder; K6 exactly once a decoder layer per prefill at
   (4, 2048, 16 / 16, 64), never in decode, all tc (the encoder and the
   cross-attention are plain attention, as in the reference); two prefills
   bitwise equal (logits, ``k``, ``v``, ``ck``, ``cv``); the vlm path's two
   comparisons (one ``{"audio": ...}`` line); then the model's one-rank twin
   (``twin_path``; one ``{"audio_parallel": ...}`` line);
   "train" — last, every family's training (``repro_torch.runtime.
   Trainer``; no kernel of K1-K6 may launch in it): one fp32 step of each
   family's smoke config on the card against the same step on the CPU (the
   loss, the grad norm and each gradient leaf within 1e-5 relative, an
   MoE's expert choices compared first; for GLM-4 also the optimizer alone
   on the CPU's gradients bitwise the CPU's update); 4 steps, a stop and 2
   resumed steps bitwise 6 uninterrupted ones (bf16, the optimized flags)
   for the smoke GLM-4, DeepSeek-V2-Lite and Zamba2; 2 steps with int8
   gradient compression on a 1-rank NCCL group (GLM-4, and Phi-3.5-MoE's
   local-mode LM); then each family at full width, cut in depth only
   (``TRAIN_AT_WIDTH``: bf16, seeded weights, "dots" remat, 4 x 2048
   tokens a step, lr 3e-4): GLM-4-9B's 12 of 40 layers take the Trainer's
   4 steps and its final checkpoint (~36.9 GB, written where there is more
   room and removed at the end), a second Trainer resumes at step 4 and
   takes a step, one more is traced; DeepSeek-V2-Lite's 10 of 27 take 4
   steps and one traced (aux, z and the dropped share a layer beside
   them); Zamba2-2.7B, Falcon-Mamba-7B, LLaVA-NeXT-34B and
   SeamlessM4T-medium take 3: step times, tokens/s, the model-FLOP share
   of 989 TFLOP/s, peak memory by phase, the first loss beside ln V, a
   traced step's device time by class and its idle share (one
   ``{"train_full"}``, ``{"train_moe_full"}`` or ``{"train_width"}`` line
   each, the whole path's ``{"train"}`` line after the kernels');
   "train_tp" — after it, the dense family's tensor-parallel and Ulysses
   training on a 1-rank NCCL mesh (``make_host_mesh(1)``; no kernel of
   K1-K6 may launch in it): the smoke GLM-4 in fp32 in each of the four
   forms (``sp_mode`` "none" / "ulysses" x ``seq_sharded_residual`` off /
   on), its loss and every gradient leaf (the partial ones summed) within
   1e-6 relative of the mesh-less LM on the card (and whether bitwise) and
   1e-5 of the CPU's, a Trainer step's collectives exactly
   ``LM.collectives_per_step(trainer=True)``; then GLM-4-9B at full width cut
   to ``TRAIN_TP_LAYERS`` (bf16, "dots", 4 x 2048 tokens, lr 3e-4), Ulysses
   with the sequence-sharded residual: 3 Trainer steps on the mesh and 3
   mesh-less from the same seeded weights, each step's loss and grad norm
   within 1e-5 relative, step seconds, tokens/s, peak memory (one
   ``{"train_tp"}`` line);
   ``python3 chip_smoke.py --only train`` runs these two paths alone (no
   kernel is built);
4. the kernels at the main path's shapes (512^3, where K4 runs its
   tensor-core design and K1-K3 their vec designs, as at the pipelined slice;
   K4's general design at the quickstart shape; K5 at three 1 GiB
   complex64 shapes: 512^3, the traditional pack of 512^3 into 4 chunks and
   a 2-D transpose; K1/K3 at the composed slab's exchange and K4 at its
   rows; K1/K3 on 3 stacked 512^3 fields and K4 at the DNS
   plan's rows, the many path's shapes; K6 at the six serving prefills'
   (GLM-4-9B's 2 kv heads, Phi-3.5-MoE's 8, DeepSeek-V2-Lite's MLA at
   (192, 128), Zamba2's 32 kv heads of 80, LLaVA-NeXT's 56 / 8 over 4096
   positions, SeamlessM4T's 16 / 16 of 64), and once at the prefill_32k
   length, and its fp32 design at the first prefill's shape; K1, K3 and K4 at every shape the tune path launched them at, one
   record per call signature with that signature's launches, and so at
   every shape the dns path's bf16 run launched them at): launches
   from their path,
   error against the plain version, kernel / plain / library times and the
   bound (one ``{"kernels": [...]}`` line; before it, K4's general design at
   n = 64 by row count against ``torch.fft.fft``, one
   ``{"k4_general_rows"}`` line; K1, K3 and K4 also at every shape the
   serve path launched them at), the serving times beside their
   bounds (one ``{"lm_breakdown": ...}``, one ``{"moe_breakdown": ...}``,
   one ``{"mla_breakdown": ...}``, one ``{"ssm_breakdown": ...}`` line,
   with the selective scan's share of the prefill in place of K6's, and one
   ``{"hybrid_breakdown": ...}`` line with both K6's and the SSD scan's,
   one ``{"vlm_breakdown": ...}`` and one ``{"audio_breakdown": ...}``),
   the seconds of each phase
   (one ``{"phase_s"}`` line), then the result line.

Without a CUDA device, or outside a checkout of the repository, it prints no
result and exits non-zero.
"""

import contextlib
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, fp32 (non-tensor) flop/s,
# bf16 and TF32 tensor-core flop/s (dense)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12

TOL_K4 = 1e-5          # max |kernel - plain| / max |plain|: f32 FMA or 3xTF32, another order
SHAPE_BIG = (512, 512, 512)
SHAPE_QS = (42, 63, 64)
# relative L2 of the 512^3 forward vs torch.fft.fftn, and of the round trip:
# one bf16 rounding of normal data is 1.7e-3, the forward rounds twice and
# the round trip four times; int8 with one scale per block of 2^28 values
# (max ~6.2 sigma) is ~1.4e-2 per rounding; lossless is the four-step DFT's
# fp32 error
TOL_FWD = {"complex64": 1e-5, "bf16": 3e-3, "int8": 3e-2}
TOL_BACK = {"complex64": 1e-5, "bf16": 5e-3, "int8": 4e-2}
COMM_DTYPES = ("complex64", "bf16", "int8")

# the LM path: GLM-4-9B at full width and depth, served as a user would call it
LM_ARGV = ["--arch", "glm4_9b", "--preset", "full", "--opt", "--batch", "4",
           "--prompt-len", "2048", "--gen", "32"]
# rel. L2 of last-token logits: the reference's serving tolerance under the
# optimized flags (tests/test_models.py, 6e-2 elementwise there); a wrong
# mask, RoPE pairing or cache slot gives a rel. L2 of order 1
TOL_LM = 6e-2
# the moe path: Phi-3.5-MoE at full width, its 32 layers cut to 28 (73.3 GB
# of bf16 weights; 32 are 83.8 GB), with the lm path's traffic
MOE_ARCH, MOE_LAYERS = "phi35_moe_42b", 28
# the train path's smoke checks take GLM-4 unless they name another family
TRAIN_ARCH = "glm4_9b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 2048, 3e-4
# the smoke checks: card against CPU, one fp32 step (allow_tf32 off): the
# loss, the grad norm and each gradient leaf (rel. L2), relative
TOL_TRAIN_REL = 1e-5
SMOKE_TRAIN_LR = 1e-3
# the other families' training: each smoke config's fp32 step card vs CPU,
# a bitwise resume of two of them, int8 compression of the MoE
TRAIN_FAMILIES = ("phi35_moe_42b", "deepseek_v2_lite_16b", "falcon_mamba_7b", "zamba2_2p7b",
                  "llava_next_34b", "seamless_m4t_medium")
TRAIN_RESUME_ARCHS = ("deepseek_v2_lite_16b", "zamba2_2p7b")
TRAIN_INT8_ARCH = "phi35_moe_42b"
# every family's training at full width: seeded weights, the optimized
# flags, TRAIN_BATCH x TRAIN_SEQ tokens a step, cut in depth only, to what
# the card's memory (TRAIN_PEAK_GIB) and the run's time take (PERF.md §4):
# (its JSON line, arch, layers, steps, the checkpoint and a resume, a traced
# step).  GLM-4-9B writes the full-width checkpoint; the others' leaves go
# through the store in the smoke resumes
TRAIN_AT_WIDTH = (
    ("train_full", "glm4_9b", 12, 4, True, True),
    ("train_moe_full", "deepseek_v2_lite_16b", 10, 4, False, True),
    ("train_width", "zamba2_2p7b", 54, 3, False, False),
    ("train_width", "falcon_mamba_7b", 4, 3, False, False),
    ("train_width", "llava_next_34b", 6, 3, False, False),
    ("train_width", "seamless_m4t_medium", 12, 3, False, False),
)
# the depth rule: the card's 79.1 GiB less 8 GiB of headroom
TRAIN_PEAK_GIB = 79.1 - 8
# the train_tp path: the four forms of training on a mesh, (sp_mode,
# seq_sharded_residual); GLM-4-9B at full width cut to TRAIN_TP_LAYERS
# (~26 GiB a run, PERF.md §4), TRAIN_TP_STEPS steps on the mesh and as many
# without one; the smoke forms against the mesh-less LM on the card
TRAIN_TP_FORMS = (("none", False), ("none", True), ("ulysses", False), ("ulysses", True))
TRAIN_TP_LAYERS, TRAIN_TP_STEPS = 4, 3
TOL_TP_CARD = 1e-6
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 2048, 32
#: greedy decode steps of each LM path's one-rank twin (``twin_path``)
TWIN_STEPS = 3
# the mla path: DeepSeek-V2-Lite whole (27 layers, 29.3 GiB of bf16 weights),
# served through serve_lm as a user calls it, with the lm path's traffic
MLA_ARGV = ["--arch", "deepseek_v2_lite_16b", "--preset", "full", "--opt", "--batch", "4",
            "--prompt-len", "2048", "--gen", "32"]
# the ssm path: Falcon-Mamba-7B at full width through serve_lm, with the lm
# path's traffic, its 64 layers cut to SSM_LAYERS for the run's time (the
# path's first depth cut, PERF.md §4; every layer is alike and the path
# holds each against its own reference)
SSM_ARCH, SSM_LAYERS = "falcon_mamba_7b", 16
# one layer's selective scan at full width against a float64 recurrence:
# (B, T, d_inner, d_state), inputs in tests/test_ssm.py's ranges, held to
# that file's limit
SSM_SCAN_SHAPE = (1, 256, 8192, 16)
TOL_SCAN = 1e-4
# the hybrid path: Zamba2-2.7B whole (54 Mamba2 layers in 9 groups of 6, one
# shared attention+MLP block run once a group, 4.49 GiB of bf16 weights)
# through serve_lm, with the lm path's traffic
HYBRID_ARGV = ["--arch", "zamba2_2p7b", "--preset", "full", "--opt", "--batch", "4",
               "--prompt-len", "2048", "--gen", "32"]
# one layer's SSD scan at full width against a float64 recurrence:
# (B, T, heads, headdim, d_state), inputs in tests/test_ssm.py's ranges
SSD_SCAN_SHAPE = (1, 256, 80, 64, 64)
# the vlm path: LLaVA-NeXT-34B whole (60 layers, 64.05 GiB of bf16 weights),
# 2048 seeded frontend embeddings before each prompt of 2048 tokens, through
# serve_lm with the lm path's traffic
VLM_ARGV = ["--arch", "llava_next_34b", "--preset", "full", "--opt", "--batch", "4",
            "--prompt-len", "2048", "--gen", "32"]
# the audio path: SeamlessM4T-medium whole (12 encoder and 12 decoder layers,
# 1.63 GiB of bf16 weights), 2048 seeded frames a prompt for its encoder,
# through serve_lm with the lm path's traffic
AUDIO_ARGV = ["--arch", "seamless_m4t_medium", "--preset", "full", "--opt", "--batch", "4",
              "--prompt-len", "2048", "--gen", "32"]
# the plain attention a batch row at a time past this many bytes of fp32
# scores (LLaVA's prefill: 15 GB for the whole batch)
PLAIN_SCORE_BYTES = 2**32
# K4's general design at the quickstart's last axis by row count: the
# quickstart's 42 * 63 rows, the sweep's 4096 and eight times that
K4_GENERAL_CASES = ((64, 2646), (64, 4096), (64, 32768))
# K6 at the serving prefills' shapes (GLM-4-9B's 2 kv heads, Phi-3.5-MoE's 8,
# DeepSeek-V2-Lite's MLA: 16 heads, q and k of 192, v of 128; Zamba2's shared
# block: 32 / 32 heads of 80; LLaVA-NeXT-34B's 56 / 8 heads over 2048 frontend
# and 2048 prompt positions; SeamlessM4T's decoder, 16 / 16 heads of 64) and
# at the prefill_32k length (batch cut): ((B, S, Hq, Hkv, dqk, dv), path, cut)
K6_SHAPES = (((4, 2048, 32, 2, 128, 128), "lm", None), ((4, 2048, 32, 8, 128, 128), "moe", None),
             ((4, 2048, 16, 16, 192, 128), "mla", None),
             ((4, 2048, 32, 32, 80, 80), "hybrid", None),
             ((4, 4096, 56, 8, 128, 128), "vlm", None),
             ((4, 2048, 16, 16, 64, 64), "audio", None),
             ((1, 32768, 32, 2, 128, 128), None, "batch 32->1"))
# K5's sweep: the old sweep's shapes, then 131072 rows of 32 to 256 bytes
# (float32 and complex64 at C = 8, 16, 24, 32) across the rows design's least
# row of 128 bytes
K5_SWEEP = ((24, 24, 8), (7, 13, 3), (64, 48, 40), (512, 33, 1), (4096, 32, 8), (4096, 32, 16),
            (4096, 32, 24), (4096, 32, 32))
# the many path: examples/navier_stokes.py's plan at a size one card holds,
# 256 retained modes per axis on the 3/2-rule grid of 384
DNS_N, DNS_M = 256, 384
BATCH_FUSIONS = ("stacked", "pipelined-across-fields", "per-field")
# the dns path: the Navier-Stokes twin's RK2 Taylor-Green DNS on the many path's
# plan, DNS_STEPS steps in three configurations: the example's own (cuFFT, no
# kernel), the slice configuration (K4) and it with a bf16 wire (K1, K3, K4)
DNS_STEPS = 8
# explicit RK2 is stable for the viscous term while dt nu k_max^2 <= 2, k_max^2
# = 3 (DNS_N / 2)^2: the example's dt = 5e-3 (0.19 of the bound at its 32
# modes) is 12.3 at 256 modes, and the round-off in the highest modes grows
# 64x a step; 5e-4 is 0.61 of the bound
DNS_DT = 5e-4
DNS_NU = 0.05  # the example's viscosity
DNS_CONFIGS = {"example": {"method": "fused"},
               "slice": {"method": "fused", "impl": "matmul", "exchange_impl": "cuda"},
               "slice_bf16": {"method": "fused", "impl": "matmul", "exchange_impl": "cuda",
                              "comm_dtype": "bf16"}}
# energies, relative: a lossless run against E0 = 0.125 (analytic) and K4's
# against cuFFT's at every step (fp32 rounding); the bf16 run against the
# lossless one: a coherent bound of its wire's roundings, written in PERF.md
# before its first card run: the initial forward rounds each value twice (two
# exchanges) and the energy is quadratic, 2 x 2 x 2^-9; each step adds dt x 2
# (dE/dt = 2 u . rhs) x 2 (|conv| / |u| <= 2 on Taylor-Green's lowest modes) x
# 4 roundings (two exchanges there and back) x 2^-9.  (bf16's unit roundoff is
# 2^-8, not the 2^-9 written then: the limit stays as written, not loosened.)
TOL_DNS = 1e-5
TOL_DNS_BF16 = 2 * 2 * 2.0 ** -9 + DNS_STEPS * DNS_DT * 2 * 2 * 4 * 2.0 ** -9
# the bf16 run's energy decrements E_k - E_0 against the example run's,
# relative, at every step (a frozen step gives 1): with bf16's unit roundoff
# u = 2^-8, (a) the initial forward rounds each value at two exchanges and a
# decrement is proportional to the energy (Taylor-Green's sits at k^2 = 3):
# 2 x 2 u; (b) a RHS's convective term passes six roundings (two exchanges in
# each of its three batched transforms), so its error in dE/dt is at most
# 6 u |conv| |u| = 6 u sqrt(3/8) |u|^2 (|conv| / |u| = sqrt(3/8) for
# Taylor-Green at t = 0, mean-square norms), against the viscous decay
# nu k^2 |u|^2 = 3 nu |u|^2: 6 u sqrt(3/8) / (3 nu)
TOL_DNS_BF16_DECAY = 4 * 2.0 ** -8 + 6 * 2.0 ** -8 * math.sqrt(3 / 8) / (3 * DNS_NU)
# the twins beside it: the quickstart at its own size in the example's and the
# slice configuration, Poisson at (64, 512, 512) in the slice configuration
POISSON_SHAPE = (64, 512, 512)
# the per-signature records of the tune and serve paths (several hundred, most
# at the quickstart's microsecond shapes, where a timing run is host-bound):
# the median of SHAPE_REPS runs each
SHAPE_REPS = 3
# the serve path: the server plan's shapes, alternating 512^3 (K4 tc) and the
# quickstart's (K4 general), 12 requests coalesced up to 4
SERVE_SHAPES = (SHAPE_BIG, SHAPE_QS)
SERVE_REQUESTS = 12
SERVE_MAX_BATCH = 4
# the coalesced 4 x 512^3 group and its _apply_many, host clock: the median of
SERVE_GROUP_REPS = 3
# the strided-FFT check: the slice's n = 512, the DNS grid's n = 384 = 128 * 3
# (one field, as the many path's FFT stages see it) and n = 12 = 4 * 3, along
# every axis a stage transforms; the DCT/DST matmul at the DNS grid's rows
STRIDED_FFT_CASES = ((512, SHAPE_BIG), (384, (384, 384, 384)), (12, (12, 10, 6)))
TRIG_TIMING_ROWS = 384 * 384
# the coeffs phase: a copy of 1 GiB of complex64, torch.fft.fft on 262144 rows of 512,
# each reading taken in COEFF_ROUNDS rounds
COEFF_COPY_ELEMS = 2**27
COEFF_FFT_ROWS = 262144
COEFF_ROUNDS = 7
# K5 at 1 GiB of complex64: 512^3, the traditional pack of 512^3 into M = 4
# chunks along its last axis, and a 2-D transpose
K5_BIG = ((SHAPE_BIG, ""), ((262144, 4, 128), ",traditional_pack"), ((16384, 8192, 1), ",2d"))


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def cuda_ms(torch, fn, reps=5):
    """Device ms of one call of ``fn``: the median over ``reps`` runs of n
    back-to-back calls between two CUDA events, divided by n, after one
    warm-up.  n makes a run span ~2 ms of device time (at most 200).  Each
    run is enqueued behind a spin kernel (``torch.cuda._sleep``) that lasts
    longer than the host takes to enqueue the run, so the device runs the n
    calls without waiting on the host: a small shape measures the device,
    not the enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    n = max(1, min(200, math.ceil(2.0 / max(_run_ms(torch, fn, 1, host_s), 1e-3))))
    return statistics.median(_run_ms(torch, fn, n, host_s) / n for _ in range(reps))


def one_call_ms(torch, fn, reps=5):
    """Median of ``reps`` CUDA-event times of one call of ``fn`` after a
    warm-up, the host's enqueue inside: beside ``cuda_ms`` on a few records,
    it shows what the enqueue adds to one call."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(_events_ms(torch, fn) for _ in range(reps))


_SPIN_HZ = []  # torch.cuda._sleep's cycles per second, measured once


def _run_ms(torch, fn, n, host_s):
    """Event ms of ``n`` calls of ``fn`` enqueued behind a spin of 1.5 times
    the host time ``host_s`` of n calls (at most 0.2 s)."""
    if not _SPIN_HZ:
        torch.cuda._sleep(1000)
        _SPIN_HZ.append(1e7 / (_events_ms(torch, lambda: torch.cuda._sleep(10**7)) / 1e3))
    torch.cuda._sleep(int(min(1.5 * host_s * n + 1e-4, 0.2) * _SPIN_HZ[0]))
    return _events_ms(torch, lambda: [fn() for _ in range(n)])


def _events_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bound_ms(nbytes, flops, peak=FP32_FLOPS):
    """Least time for ``nbytes`` of HBM traffic and ``flops`` operations at
    ``peak`` (fp32 unless given)."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or argv[1] != "train":
            print("usage: chip_smoke.py [--only train]", file=sys.stderr)
            return 2
        only = argv[1]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    if only == "train":
        return train_alone(torch)

    from repro_torch import _build

    t0 = time.perf_counter()
    logs = _build.build(["fourstep", "exchange", "transpose", "flash"])
    build_s = time.perf_counter() - t0
    print(f"built {sorted(logs) or 'nothing (cached)'} in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:  # the kernel the next two lines are of
                print(f"  {name}: {line.split(' for ', 1)[1].strip()[:100]}")
            elif "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    from repro_torch import sass_census

    print(json.dumps({"sass_census": sass_census.select(
        sass_census.library_sass(_build.library_path("fourstep")), "fourstep_kernel")
        + k5_census(sass_census, _build)}))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phases = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phases[name] = round(time.perf_counter() - t, 1)
        return out

    sweep = phase("kernel_sweep", kernel_sweep, torch)
    print(json.dumps({"kernel_sweep": sweep}))
    print(json.dumps({"strided_fft": {**phase("strided_fft", strided_fft_check, torch),
                                      "card": card}}))

    lm_info, moe_info, mla_info, ssm_info, hybrid_info, vlm_info, audio_info = (
        {}, {}, {}, {}, {}, {}, {})
    many, tune, tune_shapes, serve, serve_shapes, dns_shapes = [], [], {}, [], {}, {}
    train_info = {}
    paths = phase("paths", run_paths, torch, lm_info, moe_info, mla_info, ssm_info, hybrid_info,
                  vlm_info, audio_info, many, tune, tune_shapes, serve, serve_shapes, dns_shapes,
                  card, train_info)
    print(json.dumps({"paths": paths}))
    print(json.dumps({"many": [{**r, "card": card} for r in many]}))
    print(json.dumps({"tune": [{**r, "card": card} for r in tune]}))
    print(json.dumps({"serve": [{**r, "card": card} for r in serve]}))

    kernels = phase("kernels", main_path_kernels, torch, paths, tune_shapes, serve_shapes,
                    dns_shapes)
    print(json.dumps({"k4_general_rows": phase("k4_general_rows", k4_general_rows, torch)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"train": {**train_info, "card": card}}))
    print(json.dumps({"lm_breakdown": lm_breakdown(kernels, lm_info, "lm")}))
    print(json.dumps({"moe_breakdown": {**lm_breakdown(kernels, moe_info, "moe"),
                                        "card": card}}))
    print(json.dumps({"mla_breakdown": {**lm_breakdown(kernels, mla_info, "mla"),
                                        "card": card}}))
    print(json.dumps({"ssm_breakdown": {**lm_breakdown(kernels, ssm_info, "ssm"),
                                        "card": card}}))
    print(json.dumps({"hybrid_breakdown": {**lm_breakdown(kernels, hybrid_info, "hybrid"),
                                           "card": card}}))
    for name, info in (("vlm", vlm_info), ("audio", audio_info)):
        print(json.dumps({f"{name}_breakdown": {**lm_breakdown(kernels, info, name),
                                                "card": card}}))
    print(json.dumps({"phase_s": {"build": round(build_s, 1), **phases,
                                  "total": round(time.perf_counter() - t0, 1)}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 2: every kernel mode against its plain version
# ---------------------------------------------------------------------------


def _randn(torch, shape, seed, iscomplex=True):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if iscomplex:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.from_numpy(x).cuda()


def _max_err(torch, got, want, nan_to_num=False):
    """Max abs difference of two tensors (complex as re/im pairs; with
    ``nan_to_num`` non-finite values compared as torch.nan_to_num maps them)."""
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    got, want = got.float(), want.float()
    if nan_to_num:
        got, want = got.nan_to_num(), want.nan_to_num()
    return float((got - want).abs().max()) if got.numel() else 0.0


def _check_codec(torch, name, got, want, codec):
    """bf16 (and any decode of one payload): bitwise; int8 payloads within
    one quantum, i.e. 1 in q.  Returns the max abs error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    err = _max_err(torch, got, want)
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    if codec == "bf16" and not torch.equal(got, want):
        fail(f"{name}: bf16 not bitwise equal to the plain version (max err {err})")
    if codec == "int8" and err > 1.0:
        fail(f"{name}: int8 payload {err} quanta from the plain version")
    return err


def kernel_sweep(torch):
    from repro_torch.kernels.exchange import ops as xops, ref as xref
    from repro_torch.kernels.fft import ops as fops, ref as fref

    out = []
    for n in (42, 63, 64, 97, 251, 256, 512, 1024, 4096, 8192):
        n1, n2 = fops.plan_factors(n)
        x = _randn(torch, (4096, n), n)
        xr = x.real.contiguous()
        modes = {
            "fft": (lambda: fops.fft_matmul(x), lambda: fref.fourstep_ref(x, n1, n2),
                    lambda: torch.fft.fft(x, dim=-1)),
            "ifft": (lambda: fops.fft_matmul(x, inverse=True),
                     lambda: fref.fourstep_ref(x.conj(), n1, n2).conj() / n,
                     lambda: torch.fft.ifft(x, dim=-1)),
            "rfft": (lambda: fops.rfft_matmul(xr),
                     lambda: fref.fourstep_ref(xr.to(torch.complex64), n1, n2)[:, : n // 2 + 1],
                     lambda: torch.fft.rfft(xr, dim=-1)),
        }
        for mode, (kern, plain, lib) in modes.items():
            (got, design), want = _ran_design(fops.design_launches, kern, "K4"), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err > TOL_K4 * float(want.abs().max()):
                fail(f"fourstep {mode} n={n}: max err {err} above {TOL_K4} of max |y|")
            out.append({"name": f"fourstep:{mode}:n{n}", "design": design, "max_abs_err": err,
                        "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                        "library_ms": cuda_ms(torch, lib)})

    # complex64 blocks over F, M and both scatter orders, two float32 blocks
    # (one plane, as an r2c plan's real stages ship), and K1's two designs:
    # (64, 48, 35) along axis 2 has odd S (the scalar design), and along
    # axis 1 a scale block of 30 tiles gets its max |x| in the last tile
    cases = [(F, M, vw, True, (64, 48, 40)) for F in (1, 3) for M in (1, 4)
             for vw in ((0, 2), (2, 0))]
    cases += [(1, 4, (2, 0), False, (64, 48, 40)), (3, 4, (0, 2), False, (64, 48, 40)),
              (1, 1, (2, 0), True, (64, 48, 35)), (1, 1, (1, 0), True, (64, 48, 40))]
    for codec in ("bf16", "int8"):
        for F, M, (v, w), iscomplex, tail in cases:
            nb = 1 if F > 1 else 0
            shape = ((F,) if nb else ()) + tail
            y = _randn(torch, shape, 7 * F + M + v, iscomplex)
            tag = (f"{codec}:F{F}:M{M}:{'w>v' if w > v else 'w<v'}"
                   f"{'' if iscomplex else ':f32'}{'' if tail[-1] == 40 else ':S35'}")
            if (M, v) == (1, 1):
                y.view(-1)[-2] = 50.0
                tag += ":max_last_tile"
            out += _exchange_modes(torch, xops, xref, y, codec, v, w, v + nb, M, nb, tag)
    for what in ("encode", "decode"):
        if not {r["design"] for r in out if r["name"].startswith(what)} >= {"vec", "scalar"}:
            fail(f"the codec sweep did not run both {what} designs")

    k5 = k5_cases(torch)
    if {r["design"] for r in k5} != {"rows", "tile"}:
        fail("the K5 sweep did not run both designs")
    return out + k5 + _flash_sweep(torch)


def k5_cases(torch, shapes=K5_SWEEP, offset_shape=(64, 48, 40)):
    """K5 (``ops.transpose01``) at each of ``shapes`` in complex64 and
    float32, and at ``offset_shape`` with x one element off its storage's
    start, held bitwise to the plain version: each record's name, design
    (``"rows"`` or ``"tile"``; None where the wrapper counts no design, as
    in a tree from before the two designs), ``cuda_ms`` and the library
    call's and the plain version's.  It imports the port from ``sys.path``,
    so an older tree's archive put first there is timed alike."""
    from repro_torch.kernels.transpose import ops as tops, ref as tref

    counter = getattr(tops, "design_launches", None)
    cases = [(shape, iscomplex, 0) for shape in shapes for iscomplex in (True, False)]
    cases += [(offset_shape, True, 1), (offset_shape, False, 1)]
    out = []
    for shape, iscomplex, offset in cases:
        x0 = _randn(torch, shape, sum(shape), iscomplex)
        x = torch.empty(x0.numel() + offset, dtype=x0.dtype, device="cuda")[offset:].view(shape)
        x.copy_(x0)
        kern = lambda: tops.transpose01(x)
        got, design = _ran_design(counter, kern, "K5", field=1) if counter is not None \
            else (kern(), None)
        torch.cuda.synchronize()
        if not torch.equal(got, x0.transpose(0, 1).contiguous()):
            fail(f"transpose01 {shape} {x.dtype} offset {offset}: not bitwise equal to the plain "
                 "version")
        out.append({"name": f"transpose01:{'c64' if iscomplex else 'f32'}:{shape}"
                            f"{':offset1' if offset else ''}",
                    "replaces": "transpose/kernel.py:24", "design": design,
                    "max_abs_err": _max_err(torch, got, x0.transpose(0, 1)),
                    "ms": cuda_ms(torch, kern),
                    "plain_ms": cuda_ms(torch, lambda: tref.transpose01_ref(x)),
                    "library_ms": cuda_ms(torch, lambda: x.transpose(0, 1).contiguous())})
        del got, x, x0
    return out


def k5_census(sass_census, _build):
    """The SASS census of K5's kernels, with the instructions a thread
    issues for each 16-byte vector (rows: ``ROW_VECS`` a thread) or element
    (tile: ``TILE_THREAD_BYTES / size`` a thread) it moves; neither kernel
    has a loop."""
    from repro_torch.kernels.transpose import ref as tref

    out = sass_census.select(sass_census.library_sass(_build.library_path("transpose")),
                             "rows_kernel,tile_kernel")
    for rec in out:
        if "rows_kernel" in rec["kernel"]:
            rec["instructions_per_vector"] = rec["instructions"] / tref.ROW_VECS
        else:
            elem = 4 if "tile_kernelIj" in rec["kernel"] else 8
            rec["instructions_per_element"] = rec["instructions"] / (tref.TILE_THREAD_BYTES // elem)
    return out


def k4_general_rows(torch, cases=K4_GENERAL_CASES):
    """K4's general design (forward) at each ``(n, rows)`` of ``cases``, held
    to the plain version: kernel and ``torch.fft.fft`` ``cuda_ms``."""
    from repro_torch.kernels.fft import ops as fops, ref as fref

    out = []
    for n, rows in cases:
        n1, n2 = fops.plan_factors(n)
        x = _randn(torch, (rows, n), rows + n)
        kern = lambda: fops.fft_matmul(x)
        (got, design), want = _ran_design(fops.design_launches, kern, "K4"), \
            fref.fourstep_ref(x, n1, n2)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > TOL_K4 * float(want.abs().max()) or design != "general":
            fail(f"fourstep fft n={n} rows={rows}: max err {err}, design {design}")
        out.append({"n": n, "rows": rows, "design": design, "max_abs_err": err,
                    "ms": cuda_ms(torch, kern),
                    "library_ms": cuda_ms(torch, lambda: torch.fft.fft(x, dim=-1))})
        del x, got, want
    return out


def _ran_design(counter, fn, what, field=0):
    """``(fn(), design)``: the design that each launch of one call of ``fn``
    ran, read from the kernel's ``design_launches`` ``counter`` at the
    ``field``-th ``:``-separated place of its keys (K4: ``"tc"`` or
    ``"general"``; K6: ``"tc"`` or ``"fma"``; K1: ``"vec"`` or ``"scalar"``;
    K5, field 1: ``"rows"`` or ``"tile"``); fails on a mix."""
    before = dict(counter)
    out = fn()
    ran = {d.split(":")[field] for d, k in counter.items() if k != before.get(d, 0)}
    if len(ran) != 1:
        fail(f"one {what} call ran the designs {ran}")
    return out, ran.pop()


def _check_attention(torch, name, got, want, v):
    """Max abs error of K6 against its plain version; fails past the limit.
    fp32: tests/test_flash.py's 2e-4.  bf16, elementwise: one bf16 ulp of the
    output (2^-7 relative: a rounding that fell the other way) plus twice the
    bound 2^-9 max|v| of the kernel's rounding of p to bf16, which the plain
    version does not round."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        limit = 2e-4 + 2e-4 * want.abs()
    else:
        limit = 2.0 ** -7 * want.float().abs() + 2.0 ** -8 * float(v.float().abs().max())
    if not bool((err <= limit).all()):
        fail(f"{name}: max err {float(err.max())} past the limit")
    return float(err.max())


def _sdpa_ms(torch, q, k, v, causal, reps=5):
    """The library call K6 is timed against, one SDPA call on (B, H, S, dh)
    copies, GQA by ``enable_gqa``: (its ms, the backend it picks) on K6's
    inputs; (None, why) where it refuses them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    try:
        choice = torch._fused_sdp_choice(qt, kt, vt, None, 0.0, causal, scale=None,
                                         enable_gqa=True)
        backend = {int(b): n for n, b in SDPBackend.__members__.items()}.get(int(choice),
                                                                           str(choice))
    except (AttributeError, RuntimeError, TypeError) as e:
        backend = f"unknown ({type(e).__name__})"
    try:
        fn()
    except RuntimeError as e:
        return None, f"refused: {str(e).splitlines()[0][:160]}"
    return cuda_ms(torch, fn, reps), backend


def _flash_sweep(torch):
    from repro_torch.kernels.flash import ops as flops, ref as flref

    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            for G in (1, 2, 16):
                for S in (50, 64, 257):  # S <= block_k: the reference takes non-causal too
                    # (q/k, v) head dims: one for all three (Zamba2's 80
                    # among them), and MLA's (192, 128)
                    for dh, dv in ((16, 16), (64, 64), (80, 80), (128, 128), (160, 160),
                                   (192, 128)):
                        gen = torch.Generator(device="cuda").manual_seed(S * dh + G)
                        q, k, v = (torch.randn((2, S, h, d), generator=gen, device="cuda")
                                   .to(dtype) for h, d in ((2 * G, dh), (2, dh), (2, dv)))
                        kern = lambda: flops.flash_attention(q, k, v, causal=causal)
                        plain = lambda: flref.attention_gqa_ref(q, k, v, causal=causal)
                        name = (f"flash:{'bf16' if dtype == torch.bfloat16 else 'f32'}:"
                                f"{'causal' if causal else 'full'}:G{G}:S{S}:dh{dh}"
                                + (f":dv{dv}" if dv != dh else ""))
                        got, design = _ran_design(flops.design_launches, kern, "K6")
                        if design != flops.design(dtype):
                            fail(f"{name}: ran the {design} design")
                        err = _check_attention(torch, name, got, plain(), v)
                        lib_ms, lib = _sdpa_ms(torch, q, k, v, causal, reps=3)
                        out.append({"name": name, "replaces": "flash/kernel.py:80",
                                    "design": design, "max_abs_err": err,
                                    "ms": cuda_ms(torch, kern, reps=3),
                                    "plain_ms": cuda_ms(torch, plain, reps=3),
                                    "library_ms": lib_ms, "library": lib})
    return out


def _exchange_modes(torch, xops, xref, y, codec, v, w, bv, M, nb, tag):
    """Both encode layouts and both decode layouts of one block ``y``."""
    from repro_torch.kernels.exchange import kernel as xkernel

    iscomplex = y.is_complex()
    kw = dict(m=M, nbatch=nb, codec=codec)
    recs = []

    def rec(name, replaces, err, kern, plain, lib, **extra):
        recs.append({"name": f"{name}:{tag}", "replaces": replaces, "max_abs_err": err,
                     "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                     "library_ms": cuda_ms(torch, lib) if lib is not None else None, **extra})

    flat = torch.view_as_real(y) if iscomplex else y
    cast = (lambda: flat.to(torch.bfloat16)) if codec == "bf16" else None
    for wrapper, plain_fn, replaces in (
            (xops.pack_chunks, xref.pack_chunks_ref, "kernel.py:89 (pack=True)"),
            (xops.encode_payload, xref.encode_payload_ref, "kernel.py:89")):
        (q, s, _), design = _ran_design(xops.design_launches,
                                        lambda wrapper=wrapper: wrapper(y, axis=bv, **kw), "K1")
        qr, sr, _ = plain_fn(y, axis=bv, **kw)
        err = _check_codec(torch, f"{wrapper.__name__}:{tag}", q, qr, codec)
        if codec == "int8" and not torch.equal(s, sr):
            fail(f"{wrapper.__name__}:{tag}: int8 scales differ from the plain version")
        rec(f"encode:{wrapper.__name__}", replaces, err,
            lambda wrapper=wrapper: wrapper(y, axis=bv, **kw),
            lambda plain_fn=plain_fn: plain_fn(y, axis=bv, **kw), cast, design=design)
        # guard mode (and for int8 the saturation fault's divisor): the same
        # payload as above where undivided, and the plain version's counts
        for sd in ((None, 64.0) if codec == "int8" else (None,)):
            gkw = dict(axis=bv, guard=True, scale_div=sd, **kw)
            (q, s, st), gdesign = _ran_design(xops.design_launches,
                                              lambda wrapper=wrapper, gkw=gkw: wrapper(y, **gkw),
                                              "K1")
            qr, sr, str_ = plain_fn(y, **gkw)
            err = _check_codec(torch, f"{wrapper.__name__}:guard:{tag}", q, qr, codec)
            if codec == "int8" and not torch.equal(s, sr):
                fail(f"{wrapper.__name__}:guard:{tag}: int8 scales differ from the plain version")
            if [float(st[k]) for k in st] != [float(str_[k]) for k in st]:
                fail(f"{wrapper.__name__}:guard:{tag}: counts {st} != plain {str_}")
            rec(f"encode:{wrapper.__name__}:guard{'' if sd is None else ':sat64'}",
                replaces + " (guard=True)", err,
                lambda wrapper=wrapper, gkw=gkw: wrapper(y, **gkw),
                lambda plain_fn=plain_fn, gkw=gkw: plain_fn(y, **gkw), cast, design=gdesign)

    def decodes(name, replaces, kern, plain, q, s, axis, layout):
        """The decode by its wrapper (the rule's design) and into a block at
        an odd storage offset (the scalar design), each bitwise the plain
        version."""
        want = plain()
        got, design = _ran_design(xops.decode_design_launches, kern, "K3")
        widen = (lambda: q.float()) if codec == "bf16" else None
        rec(name, replaces, _check_codec(torch, f"{name}:{tag}", got, want, "bf16"), kern, plain,
            widen, design=design)
        out = torch.empty(want.numel() + 1, dtype=want.dtype, device=want.device)[1:]
        out = out.view(want.shape)
        view = xops._chunk_view(want.shape, axis, M, nb)
        qc = q.contiguous()
        odd = lambda: xkernel.decode(qc, s, out, *view, codec=codec, layout=layout)
        got, design = odd()
        if design != "scalar":
            fail(f"{name}:{tag}: a decode into an odd offset ran the {design} design")
        rec(f"{name}:odd_offset", replaces,
            _check_codec(torch, f"{name}:odd_offset:{tag}", got, want, "bf16"), odd, plain, widen,
            design=design)

    qr, sr, _ = xref.pack_chunks_ref(y, axis=bv, **kw)
    dkw = dict(v=v, w=w, scale=sr, iscomplex=iscomplex, **kw)
    decodes("decode:unpack_chunks", "kernel.py:173", lambda: xops.unpack_chunks(qr, **dkw),
            lambda: xref.unpack_chunks_ref(qr, **dkw), qr, sr, w + nb, xkernel.CHUNK_MAJOR)
    qr2, sr2, _ = xref.encode_payload_ref(y, axis=bv, **kw)
    dkw2 = dict(axis=bv, scale=sr2, iscomplex=iscomplex, **kw)
    decodes("decode:decode_payload", "kernel.py:144", lambda: xops.decode_payload(qr2, **dkw2),
            lambda: xref.decode_payload_ref(qr2, **dkw2), qr2, sr2, bv, xkernel.IN_PLACE)
    return recs


# ---------------------------------------------------------------------------
# phase 3: the main path on the card
# ---------------------------------------------------------------------------


def _counters():
    """Every launch counter, by the prefix its keys take in a path's counts
    (the decode's designs under "decode:", apart from the encode's)."""
    from repro_torch.kernels.exchange import ops as xops
    from repro_torch.kernels.fft import ops as fops
    from repro_torch.kernels.flash import ops as flops
    from repro_torch.kernels.transpose import ops as tops

    return [("", c) for c in (fops.launches, fops.design_launches, xops.launches,
                              xops.design_launches, tops.launches, tops.design_launches,
                              flops.launches, flops.design_launches)] + [
        ("decode:", xops.decode_design_launches)]


def _drive(torch, name, fn, *args):
    """Run one path with every launch counter at 0 just before it; returns
    the counts read just after."""
    counters = _counters()
    torch.cuda.synchronize()
    for _, c in counters:
        c.clear()
    t0 = time.perf_counter()
    fn(torch, *args)
    torch.cuda.synchronize()
    counts = {pre + k: v for pre, c in counters for k, v in c.items()}
    print(f"path {name}: {time.perf_counter() - t0:.1f} s, launches {counts}")
    return counts


def _count_snapshot():
    return {pre + k: v for pre, c in _counters() for k, v in c.items()}


class _ServerLaunches:
    """While active, the launches of the server's own work: the growth of
    every counter over the window goes into each dict of ``counts``, and
    K1, K3 and K4's launches by their call's arguments into ``calls``
    (``_LaunchesByShape``).  A window holds a wave's submits, its results
    and the worker's drain, so the harness's checks and timings between
    windows are not counted."""

    def __init__(self, torch, calls, *counts):
        self.torch, self.calls, self.counts = torch, calls, counts

    def __enter__(self):
        self.torch.cuda.synchronize()
        self._before = _count_snapshot()
        self._log = _LaunchesByShape(self.calls).__enter__()
        return self

    def __exit__(self, *exc):
        self._log.__exit__(*exc)
        self.torch.cuda.synchronize()
        for k, v in _count_snapshot().items():
            if v != self._before.get(k, 0):
                for c in self.counts:
                    c[k] = c.get(k, 0) + v - self._before.get(k, 0)


def _by_call(paths, shapes, name):
    """Check that a path's K1, K3 and K4 each launched and that its launches
    by call (``_LaunchesByShape``) add up to its counters."""
    counts = paths[name]
    k1 = sum(n for k, n in counts.items() if k.startswith("pack_chunks:"))
    k3 = sum(n for k, n in counts.items() if k.startswith("unpack_chunks:"))
    k4 = sum(n for k, n in counts.items() if k.startswith(("tc:", "general:")))
    if min(k1, k3, k4) < 1:
        fail(f"{name}: K1 {k1}, K3 {k3}, K4 {k4} launches; each must be >= 1")
    by_call = [sum(r["launches"] for (k, *_), r in shapes.items() if k == kern)
               for kern in ("K1", "K3", "K4")]
    if by_call != [k1, k3, k4]:
        fail(f"{name}: launches by call {by_call} != the counters' {[k1, k3, k4]}")


@contextlib.contextmanager
def _nccl_world_one():
    """A 1-rank NCCL default process group for the span of the block."""
    import torch.distributed as dist

    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    try:
        dist.init_process_group("nccl", init_method=f"file://{pg_dir}/pg", rank=0, world_size=1)
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)


def run_paths(torch, lm_info, moe_info, mla_info, ssm_info, hybrid_info, vlm_info, audio_info,
              many, tune, tune_shapes, serve, serve_shapes, dns_shapes, card, train_info):
    """Drive the five FFT paths on a 1-rank NCCL group (the composed path
    prints its records, the many path fills ``many`` with its), the dns path
    (its K1, K3 and K4 launches by call into ``dns_shapes``) and the audit
    of the example plans, measure the time model's coefficients (one
    ``{"coeffs"}`` line), drive the tune path on the same group (it fills
    ``tune`` and, with its launches by call, ``tune_shapes``), the serve path
    (``serve``, ``serve_shapes`` likewise), then the LM paths (which fill
    ``lm_info``, ``moe_info``, ``mla_info``, ``ssm_info``, ``hybrid_info``,
    ``vlm_info`` and ``audio_info``; the parallel path runs on the moe
    path's model, on a 1-rank NCCL group again), and last the train path
    (``train_info``) and the train_tp path (its own ``{"train_tp"}``
    line), which must launch no kernel;
    returns each path's kernel launch counts."""
    from repro_torch.core.meshutil import make_mesh

    with _nccl_world_one():
        mesh = make_mesh((1, 1), ("p0", "p1"))
        uniform = {}  # 512^3 forward ms of each uniform explicit config, by the paths
        composed = []
        paths = {"slice": _drive(torch, "slice", slice_path, mesh, uniform)}
        torch.cuda.empty_cache()
        paths["composed"] = _drive(torch, "composed", composed_path, mesh, composed)
        print(json.dumps({"composed": [{**r, "card": card} for r in composed]}))
        torch.cuda.empty_cache()
        paths["engines"] = _drive(torch, "engines", engines_path, mesh, uniform)
        torch.cuda.empty_cache()
        paths["guard"] = _drive(torch, "guard", guard_path, mesh)
        torch.cuda.empty_cache()
        paths["many"] = _drive(torch, "many", many_path, mesh, many)
        gc.collect()
        torch.cuda.empty_cache()
        dns = []
        paths["dns"] = _drive(torch, "dns", dns_path, mesh, dns, dns_shapes)
        print(json.dumps({"dns": [{**r, "card": card} for r in dns]}))
        gc.collect()
        torch.cuda.empty_cache()
        ran = {k for (k, *_), r in dns_shapes.items() if r["launches"]}
        if ran != {"K1", "K3", "K4"}:
            fail(f"dns: the bf16 run launched {sorted(ran)}, want K1, K3 and K4")
        audit = []
        paths["audit"] = _drive(torch, "audit", audit_path, mesh, audit)
        print(json.dumps({"audit": [{**r, "card": card} for r in audit]}))
        print(json.dumps({"coeffs": {**measure_coeffs(torch), "card": card}}))
        torch.cuda.empty_cache()
        paths["tune"] = _drive(torch, "tune", tune_path, mesh, tune, uniform, tune_shapes)
        gc.collect()
        torch.cuda.empty_cache()
        _by_call(paths, tune_shapes, "tune")
        # the serve path's launches are the server's own (``_ServerLaunches``)
        paths["serve"] = {}
        _drive(torch, "serve", serve_path, mesh, serve, serve_shapes, paths["serve"])
        print(f"path serve: the server's own launches {paths['serve']}")
        gc.collect()
        torch.cuda.empty_cache()
        _by_call(paths, serve_shapes, "serve")
        designs = {k.split(":")[0] for k, n in paths["serve"].items()
                   if k.startswith(("tc:", "general:")) and n}
        guard = sum(n for k, n in paths["serve"].items()
                    if k.startswith("pack_chunks:") and k.endswith(":guard"))
        if designs != {"tc", "general"} or guard < 1:
            fail(f"serve: K4 ran the designs {designs}, want both; K1 guard launches {guard}")
        # every exchange of these paths has S % 4 == 0: K1 and K3 run their
        # vec designs, every launch
        for name in ("slice", "composed", "engines", "guard"):
            counts = paths[name]
            scalar = {k: n for k, n in counts.items()
                      if k.startswith(("scalar:", "decode:scalar:"))}
            if scalar:
                fail(f"{name}: K1 or K3 ran the scalar design {scalar}")
            dec = sum(n for k, n in counts.items() if k.startswith("unpack_chunks:"))
            vec = sum(n for k, n in counts.items() if k.startswith("decode:vec:"))
            if dec < 1 or vec != dec:
                fail(f"{name}: {vec} of {dec} K3 launches ran the vec design")
    paths["lm"] = _drive(torch, "lm", lm_path, lm_info)
    gc.collect()
    torch.cuda.empty_cache()
    handoff = {}  # the moe path's model, prompts and served ids, for the parallel path
    paths["moe"] = _drive(torch, "moe", moe_path, moe_info, handoff)
    with _nccl_world_one():
        paths["parallel"] = _drive(torch, "parallel", parallel_path, moe_info, handoff)
    handoff.clear()
    gc.collect()
    torch.cuda.empty_cache()
    paths["mla"] = _drive(torch, "mla", mla_path, mla_info)
    gc.collect()
    torch.cuda.empty_cache()
    paths["ssm"] = _drive(torch, "ssm", ssm_path, ssm_info)
    gc.collect()
    torch.cuda.empty_cache()
    paths["hybrid"] = _drive(torch, "hybrid", hybrid_path, hybrid_info)
    gc.collect()
    torch.cuda.empty_cache()
    paths["vlm"] = _drive(torch, "vlm", frontend_path, vlm_info, "vlm", VLM_ARGV)
    gc.collect()
    torch.cuda.empty_cache()
    paths["audio"] = _drive(torch, "audio", frontend_path, audio_info, "audio", AUDIO_ARGV)
    gc.collect()
    torch.cuda.empty_cache()
    paths["train"] = _drive(torch, "train", train_path, train_info)
    _no_launches(paths["train"])
    gc.collect()
    torch.cuda.empty_cache()
    paths["train_tp"] = _drive(torch, "train_tp", train_tp_path, card)
    _no_launches(paths["train_tp"])
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def slice_path(torch, mesh, uniform):
    """The slice path: the quickstart, and the slice configuration
    at the quickstart shape and at 512^3 (bf16, int8); the 512^3 forward
    times go into ``uniform``."""
    import numpy as np

    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.kernels.exchange import ops as xops
    from repro_torch.kernels.fft import ops as fops

    slice_cfg = PlanConfig(method="fused", impl="matmul", exchange_impl="cuda",
                           comm_dtype="bf16")

    # (a) the quickstart, default config
    rng = np.random.default_rng(0)
    u = (rng.standard_normal(SHAPE_QS) + 1j * rng.standard_normal(SHAPE_QS)).astype(np.complex64)
    plan = ParallelFFT(mesh, SHAPE_QS, ("p0", "p1"), config=PlanConfig(method="fused"))
    uh = plan.forward(u)
    ub = plan.backward(uh)
    np.testing.assert_allclose(ub.cpu().numpy(), u, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(uh.cpu().numpy(), np.fft.fftn(u), rtol=1e-4, atol=1e-2)
    print(json.dumps({"plan": "quickstart", "shape": SHAPE_QS, "config": "default",
                      "rel_l2_fwd": rel_l2(torch, uh, torch.from_numpy(np.fft.fftn(u)).cuda()),
                      "rel_l2_roundtrip": rel_l2(torch, ub, torch.from_numpy(u).cuda())}))

    # (b) the slice at the quickstart shape and at 512^3; (c) int8 at 512^3
    for shape, cfg in ((SHAPE_QS, slice_cfg), (SHAPE_BIG, slice_cfg),
                       (SHAPE_BIG, slice_cfg.replace(comm_dtype="int8"))):
        fwd_ms = _run_plan(torch, mesh, shape, cfg, ParallelFFT, fops, xops)
        if shape == SHAPE_BIG:
            uniform[f"fused@{cfg.comm_dtype}@cuda"] = fwd_ms


def composed_path(torch, mesh, records):
    """The composed path: the slab plan over the composed groups
    ``(("p0", "p1"),)`` and ``(("p1", "p0"),)`` beside the one-name slab
    ``("p0",)``, under the slice configuration with bf16, at 512^3 and the
    quickstart shape.  On one rank the three are the same work, so each
    forward and backward must be bitwise the slab's; each within the bf16
    limits of ``torch.fft.fftn``, with K1/K3/K4 launches per call exactly as
    ``_want_launches`` gives; the 512^3 forwards timed (slab, composed,
    reversed, slab), one record each into ``records``."""
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig

    cfg = PlanConfig(method="fused", impl="matmul", exchange_impl="cuda", comm_dtype="bf16")
    grids = {"slab": ("p0",), "composed": (("p0", "p1"),), "reversed": (("p1", "p0"),)}
    for shape in (SHAPE_BIG, SHAPE_QS):
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn(shape, dtype=torch.complex64, device="cuda", generator=gen)
        ref = torch.fft.fftn(x)
        plans, outs = {}, {}
        for name, grid in grids.items():
            plan = plans[name] = ParallelFFT(mesh, shape, grid, config=cfg)
            y, per_fwd = _launches_of(torch, "bf16", lambda: plan.forward_padded(x), shape)
            b, per_back = _launches_of(torch, "bf16", lambda: plan.backward_padded(y), shape)
            want = _want_launches(plan, "bf16")
            if per_fwd != want or per_back != want:
                fail(f"composed {name} {shape}: forward launched {per_fwd}, backward "
                     f"{per_back}, want {want} each")
            _check_finite(torch, f"composed {name} {shape}", y, shape)
            fwd_err, back_err = rel_l2(torch, y, ref), rel_l2(torch, b, x)
            if fwd_err > TOL_FWD["bf16"] or back_err > TOL_BACK["bf16"]:
                fail(f"composed {name} {shape}: rel L2 forward {fwd_err}, round trip {back_err}")
            if name != "slab" and not (torch.equal(y, outs["slab"][0])
                                       and torch.equal(b, outs["slab"][1])):
                fail(f"composed {name} {shape}: not bitwise the slab plan's")
            outs[name] = (y, b)
            records.append({"grid": name, "groups": grid, "shape": list(shape), "comm_dtype": "bf16",
                            "rel_l2_fwd_vs_fftn": fwd_err, "rel_l2_roundtrip": back_err,
                            "bitwise_vs_slab": None if name == "slab" else True,
                            "launches_per_forward": per_fwd, "launches_per_backward": per_back})
        if shape == SHAPE_BIG:
            ms = {}
            for name in ("slab", "composed", "reversed", "slab"):
                ms.setdefault(name, []).append(
                    cuda_ms(torch, lambda p=plans[name]: p.forward_padded(x), reps=7))
            for r in records[-3:]:
                r["forward_ms"] = ms[r["grid"]]
        del x, ref, outs, plans


def _launches_of(torch, comm, fn, shape):
    """``(fn(), launches)``: the K4, encode (K1) and decode (K3) kernel
    launches at ``comm`` that one call of ``fn`` made.  At ``SHAPE_BIG``
    every K4 launch must have run the tensor-core design."""
    from repro_torch.kernels.exchange import ops as xops
    from repro_torch.kernels.fft import ops as fops

    def totals():
        return (sum(fops.launches.values()), xops.launches[f"pack_chunks:{comm}"],
                xops.launches[f"unpack_chunks:{comm}"],
                sum(k for d, k in fops.design_launches.items() if d.startswith("tc:")))

    before = totals()
    out = fn()
    torch.cuda.synchronize()
    k4, enc, dec, tc = (b - a for a, b in zip(before, totals()))
    if tuple(shape) == SHAPE_BIG and tc != k4:
        fail(f"{shape} {comm}: {k4 - tc} of {k4} K4 launches ran the general design, not 'tc'")
    return out, {"fourstep": k4, "encode": enc, "decode": dec}


def _want_launches(plan, comm):
    """Launches of one forward (or backward): a K4 per FFT stage, the stage
    after an exchange once per pipelined slice, and per exchange collective
    one encode (an int8 encode is two kernels) and one decode on a lossy
    wire."""
    from repro_torch.core.pfft import FFTStage
    from repro_torch.kernels.exchange import ops as xops

    colls = sum(e.chunks if e.method == "pipelined" else 1 for e in plan.schedule)
    ffts = sum(isinstance(st, FFTStage) for st in plan.stages)
    lossy = comm != "complex64"
    return {"fourstep": ffts - plan.n_exchanges + colls,
            "encode": colls * xops.ENCODE_KERNELS[comm] if lossy else 0,
            "decode": colls if lossy else 0}


def _run_plan(torch, mesh, shape, cfg, ParallelFFT, fops, xops):
    plan = ParallelFFT(mesh, shape, ("p0", "p1"), config=cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, dtype=torch.complex64, device="cuda", generator=gen)
    ref = torch.fft.fftn(x)
    y, per_fwd = _launches_of(torch, cfg.comm_dtype, lambda: plan.forward_padded(x), shape)
    # two exchanges per 3-D pencil forward; an int8 encode is two kernel launches
    if per_fwd != _want_launches(plan, cfg.comm_dtype):
        fail(f"{shape} {cfg.comm_dtype}: one forward launched {per_fwd}")
    back = plan.backward_padded(y)
    if not (torch.isfinite(torch.view_as_real(y)).all() and y.shape == x.shape):
        fail(f"{shape}: forward output not finite or of the wrong shape")
    fwd_err, back_err = rel_l2(torch, y, ref), rel_l2(torch, back, x)
    d = cfg.comm_dtype
    if fwd_err > TOL_FWD[d] or back_err > TOL_BACK[d]:
        fail(f"{shape} {d}: rel L2 forward {fwd_err} (<= {TOL_FWD[d]}), "
             f"round trip {back_err} (<= {TOL_BACK[d]})")
    del ref, back
    fwd_ms = cuda_ms(torch, lambda: plan.forward_padded(x), reps=7)
    bwd_ms = cuda_ms(torch, lambda: plan.backward_padded(y), reps=7)
    print(json.dumps({"plan": "slice", "shape": shape, "comm_dtype": d, "impl": cfg.impl,
                      "exchange_impl": cfg.exchange_impl, "rel_l2_fwd_vs_fftn": fwd_err,
                      "rel_l2_roundtrip": back_err, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
                      "forward_one_call_ms": one_call_ms(torch, lambda: plan.forward_padded(x),
                                                         reps=7),
                      "launches_per_forward": per_fwd,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}))
    return fwd_ms


def _big_input(torch, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(SHAPE_BIG, dtype=torch.complex64, device="cuda", generator=gen)


def _check_finite(torch, name, y, shape):
    torch.cuda.synchronize()
    if tuple(y.shape) != tuple(shape) or not torch.isfinite(torch.view_as_real(y)).all():
        fail(f"{name}: output not finite or of the wrong shape")


def engines_path(torch, mesh, uniform):
    """The traditional and pipelined engines at 512^3 for each comm_dtype,
    against torch.fft.fftn and (lossless) bitwise against the fused engine,
    their forward times into ``uniform``; then each engine's first forward
    exchange timed alone."""
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.core.redistribute import exchange_shard

    x = _big_input(torch)
    ref = torch.fft.fftn(x)
    base = PlanConfig(method="fused", impl="matmul", exchange_impl="cuda", chunks=4)
    fused = ParallelFFT(mesh, SHAPE_BIG, ("p0", "p1"), config=base)
    y_fused = fused.forward_padded(x)
    b_fused = fused.backward_padded(y_fused)
    for method in ("fused", "traditional", "pipelined"):
        for comm in COMM_DTYPES:
            if method == "fused" and comm != "complex64":
                continue  # the slice path times the lossy fused plans
            plan = ParallelFFT(mesh, SHAPE_BIG, ("p0", "p1"),
                               config=base.replace(method=method, comm_dtype=comm))
            name = f"{method}@{comm}"
            # each engine runs the path's kernels: K4 per stage and slice,
            # K1 and K3 per collective on a lossy wire
            y, per_fwd = _launches_of(torch, comm, lambda: plan.forward_padded(x), SHAPE_BIG)
            back, per_bwd = _launches_of(torch, comm, lambda: plan.backward_padded(y), SHAPE_BIG)
            want = _want_launches(plan, comm)
            if per_fwd != want or per_bwd != want:
                fail(f"{name}: forward launched {per_fwd}, backward {per_bwd}, want {want} each")
            _check_finite(torch, name, y, SHAPE_BIG)
            fwd_err, back_err = rel_l2(torch, y, ref), rel_l2(torch, back, x)
            if fwd_err > TOL_FWD[comm] or back_err > TOL_BACK[comm]:
                fail(f"{name}: rel L2 forward {fwd_err} (<= {TOL_FWD[comm]}), "
                     f"round trip {back_err} (<= {TOL_BACK[comm]})")
            bitwise = None
            if comm == "complex64":
                bitwise = torch.equal(y, y_fused) and torch.equal(back, b_fused)
                if not bitwise:
                    fail(f"{name}: lossless output is not bitwise equal to the fused engine's")
            del back
            fwd_ms = cuda_ms(torch, lambda: plan.forward_padded(x))
            bwd_ms = cuda_ms(torch, lambda: plan.backward_padded(y))
            uniform[f"{method}@{comm}@cuda"] = fwd_ms
            print(json.dumps({"plan": "engine", "method": method,
                              "chunks": plan.schedule[0].chunks, "comm_dtype": comm,
                              "shape": SHAPE_BIG, "rel_l2_fwd_vs_fftn": fwd_err,
                              "rel_l2_roundtrip": back_err, "bitwise_equal_fused": bitwise,
                              "launches_per_forward": per_fwd,
                              "forward_ms": fwd_ms, "backward_ms": bwd_ms}))
            del y
    del ref, y_fused, b_fused

    # the first forward exchange (v = 2 -> w = 1 over "p1", M = 1) alone, and
    # the pack copy a lossless exchange pays at M = 4 (at M = 1 the moved
    # chunk axis has extent 1 and movedim(...).contiguous() copies nothing)
    alone = {}
    for comm in COMM_DTYPES:
        for method in ("fused", "traditional", "pipelined"):
            alone[f"{method}@{comm}"] = cuda_ms(torch, lambda: exchange_shard(
                x, 2, 1, "p1", mesh=mesh, method=method, chunks=4, comm_dtype=comm,
                impl="cuda"))
    n0, n1, n2 = SHAPE_BIG
    pack_m4 = cuda_ms(torch, lambda: torch.movedim(x.reshape(n0, n1, 4, n2 // 4), 2, 0)
                      .contiguous())
    print(json.dumps({"exchange_alone_ms": alone, "movedim_pack_copy_m4_ms": pack_m4}))
    print(json.dumps({"engines_torch": _engines_torch_bitwise(torch, mesh, x)}))


def _engines_torch_bitwise(torch, mesh, x):
    """Under ``impl="torch"`` (cuFFT), the lossless traditional and
    pipelined (4 slices) engines against the fused one, forward and
    backward, bitwise, at 512^3 and at n = 384; and the 512^3 fused
    forward's ms."""
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig

    base = PlanConfig(method="fused", impl="torch", chunks=4)
    out = {"bitwise_equal_fused": {}}
    for shape in (SHAPE_BIG, (DNS_M,) * 3):
        xs = x if shape == SHAPE_BIG else torch.randn(
            shape, dtype=torch.complex64, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(7))
        fused = ParallelFFT(mesh, shape, ("p0", "p1"), config=base)
        y = fused.forward_padded(xs)
        b = fused.backward_padded(y)
        for method in ("traditional", "pipelined"):
            plan = ParallelFFT(mesh, shape, ("p0", "p1"), config=base.replace(method=method))
            same = (torch.equal(plan.forward_padded(xs), y)
                    and torch.equal(plan.backward_padded(y), b))
            out["bitwise_equal_fused"][f"{method}@{shape[0]}"] = same
            if not same:
                fail(f"engines impl=torch {shape} {method}: lossless output is not bitwise "
                     f"equal to the fused engine's")
        if shape == SHAPE_BIG:
            if rel_l2(torch, y, torch.fft.fftn(xs)) > TOL_FWD["complex64"]:
                fail("engines impl=torch 512^3: forward off torch.fft.fftn")
            out["forward_ms"] = cuda_ms(torch, lambda: fused.forward_padded(xs))
        del xs, y, b
    return out


def _fft_along(torch, x, axis, inverse, contiguous):
    """torch.fft's (i)fft of ``x`` along ``axis``: in place of a strided
    axis, or of ``axis`` moved last and made contiguous (and moved back)."""
    op = torch.fft.ifft if inverse else torch.fft.fft
    if not contiguous:
        return op(x, dim=axis)
    return torch.movedim(op(torch.movedim(x, axis, -1).contiguous(), dim=-1), -1, axis)


def strided_fft_check(torch):
    """Whether ``torch.fft`` (cuFFT) on the card rounds a transform by the
    other axes' extents: at each of ``STRIDED_FFT_CASES``, fft and ifft
    along every axis of one block against the same axis of a stack of two
    blocks and of a half slice along another axis (a batched and a
    pipelined engine's views), in place and on a contiguous last axis
    (``fftcore``'s copy); along each leading axis, the ms of that copy, of
    the ``fft`` in place and of the ``fft`` through the copy.  Then whether
    the DCT/DST matmul (fixed blocks of rows) gives a row the same bits
    whatever rows share the call, and whether one plain matmul does; and
    at the DNS grid's rows the ms of both, on the device alone and with the
    host's enqueue (the blocks are a loop of calls)."""
    from repro_torch.kernels.fft import ops as fops, ref as fref

    out = {"cases": []}
    for n, shape in STRIDED_FFT_CASES:
        gen = torch.Generator(device="cuda").manual_seed(11)
        a = torch.randn(shape, dtype=torch.complex64, device="cuda", generator=gen)
        s = torch.stack([a, torch.randn(shape, dtype=torch.complex64, device="cuda",
                                        generator=gen)])
        rec = {"n": n, "shape": list(shape)}
        for contiguous in (False, True):
            same = {}
            for axis in range(a.dim()):
                cut = a.dim() - 1 if axis != a.dim() - 1 else 0
                half = torch.narrow(a, cut, 0, shape[cut] // 2)
                for inverse in (False, True):
                    one = _fft_along(torch, a, axis, inverse, contiguous)
                    tag = f"{'ifft' if inverse else 'fft'}:axis{axis}"
                    same[f"{tag}:stacked"] = torch.equal(
                        one, _fft_along(torch, s, axis + 1, inverse, contiguous)[0])
                    same[f"{tag}:slice"] = torch.equal(
                        torch.narrow(one, cut, 0, shape[cut] // 2),
                        _fft_along(torch, half, axis, inverse, contiguous))
                    del one
            rec["contiguous" if contiguous else "strided"] = same
        for axis in range(a.dim() - 1):
            rec[f"axis{axis}_ms"] = {
                "copy": cuda_ms(torch, lambda: torch.movedim(a, axis, -1).contiguous()),
                "fft_in_place": cuda_ms(torch, lambda: torch.fft.fft(a, dim=axis)),
                "fft_through_copy": cuda_ms(torch, lambda: _fft_along(torch, a, axis, False,
                                                                      True))}
        out["cases"].append(rec)
        del a, s, half
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = torch.randn(5000, 384, device="cuda", generator=gen)
    m = torch.randn(384, 384, device="cuda", generator=gen)
    whole = fops.dct_matmul(rows, axis=-1)
    parts = ((0, 1), (3, 700), (1000, 5000), (4999, 5000))
    out["trig_matmul_rows_bitwise"] = all(
        torch.equal(fops.dct_matmul(rows[lo:hi], axis=-1), whole[lo:hi]) for lo, hi in parts)
    full = rows @ m.T
    out["plain_matmul_rows_bitwise"] = all(torch.equal(rows[lo:hi] @ m.T, full[lo:hi])
                                           for lo, hi in parts)
    rows = torch.randn(TRIG_TIMING_ROWS, 384, device="cuda", generator=gen)
    mt = torch.from_numpy(fref.dct_matrix(384, 2)).to("cuda").T
    if not torch.equal(fops.dct_matmul(rows, axis=-1), fops._trig_rows(rows, mt)):
        fail("dct_matmul: not the blocked product of its matrix")
    out["trig_matmul"] = {
        "rows": TRIG_TIMING_ROWS, "n": 384, "block_rows": fops.TRIG_ROWS,
        "blocks_ms": cuda_ms(torch, lambda: fops._trig_rows(rows, mt)),
        "one_call_ms": cuda_ms(torch, lambda: rows @ mt),
        "blocks_enqueued_ms": one_call_ms(torch, lambda: fops._trig_rows(rows, mt)),
        "one_call_enqueued_ms": one_call_ms(torch, lambda: rows @ mt),
        "bound_ms": bound_ms(2 * rows.numel() * 4, 2 * rows.numel() * 384)[0]}
    return out


def guard_path(torch, mesh):
    """Guarded execution at 512^3: clean strict runs (bitwise equal to the
    unguarded plan, guarded and unguarded forward times), then faults that
    must end as the reference's matrix says."""
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.robustness import FaultPlan, GuardError

    x = _big_input(torch)
    base = PlanConfig(method="fused", impl="matmul", exchange_impl="cuda")

    def plan(**kw):
        return ParallelFFT(mesh, SHAPE_BIG, ("p0", "p1"), config=base.replace(**kw))

    clean = {}
    for comm in ("int8", "complex64"):
        pu, pg = plan(comm_dtype=comm), plan(comm_dtype=comm, guard="strict")
        yu = pu.forward(x)
        yg, rep = pg.forward(x)
        if not rep.ok or rep.transitions:
            fail(f"guard strict {comm}: clean run tripped {rep.tripped}")
        if not torch.equal(yg, yu):
            fail(f"guard strict {comm}: guarded output differs from the unguarded one")
        del yg
        guarded = pg.guarded_padded("forward")
        u_ms = cuda_ms(torch, lambda: pu.forward_padded(x))
        g_ms = cuda_ms(torch, lambda: guarded(x))
        print(json.dumps({"guard": "strict", "comm_dtype": comm, "shape": SHAPE_BIG,
                          "ok": rep.ok, "transitions": len(rep.transitions),
                          "bitwise_equal_unguarded": True, "forward_ms": u_ms,
                          "guarded_forward_ms": g_ms, "parseval_rel_err": rep.parseval_rel_err,
                          "stages": [st.to_dict() for st in rep.stages]}))
        clean[comm] = yu

    def degrade(fp, comm):
        with fp:
            return plan(comm_dtype=comm, guard="degrade").forward(x)

    def record(case, y, rep, want, tol):
        err = rel_l2(torch, y, want)
        if not rep.ok or not rep.transitions or err > tol:
            fail(f"guard {case}: ok={rep.ok} transitions={rep.transitions} rel L2 {err} (<= {tol})")
        print(json.dumps({"guard": "degrade", "case": case, "ok": rep.ok,
                          "attempts": rep.attempts, "schedule": [list(e) for e in rep.schedule],
                          "transitions": [t.get("tripped") for t in rep.transitions],
                          "rel_l2_vs_unguarded": err}))

    y, rep = degrade(FaultPlan().saturate(engine="fused"), "int8")
    if any(e[2] == "int8" for e in rep.schedule):
        fail(f"guard saturate: final schedule still on int8: {rep.schedule}")
    record("saturate", y, rep, clean["complex64"], TOL_FWD["bf16"])
    y, rep = degrade(FaultPlan().corrupt_wire(engine="fused", codec="complex64"), "complex64")
    if not any(e[0] != "fused" for e in rep.schedule):
        fail(f"guard corrupt_wire complex64: no engine rung moved: {rep.schedule}")
    record("corrupt_wire_complex64", y, rep, clean["complex64"], 1e-5)
    y, rep = degrade(FaultPlan().corrupt_wire(engine="fused", codec="int8", label="scale"), "int8")
    record("corrupt_wire_int8_scale", y, rep, clean["complex64"], TOL_FWD["bf16"])
    del y
    try:
        degrade(FaultPlan().nan_input(), "complex64")
        fail("guard nan_input (wildcard): no GuardError")
    except GuardError as e:
        print(json.dumps({"guard": "degrade", "case": "nan_input_wildcard", "raised": True,
                          "tripped": list(e.report.tripped)}))
    with FaultPlan().saturate(engine="fused"):
        try:
            plan(comm_dtype="int8", guard="strict").forward(x)
            fail("guard strict saturate: no GuardError")
        except GuardError as e:
            if not any("saturation" in t for t in e.report.tripped):
                fail(f"guard strict saturate: tripped {e.report.tripped}, no saturation")
            print(json.dumps({"guard": "strict", "case": "saturate", "raised": True,
                              "tripped": list(e.report.tripped)}))


def _dns_plan(mesh, comm, fusion, **config):
    """The DNS twin's plan (``navier_stokes.dns_plan``) at DNS_N modes on
    the DNS_M^3 grid: pruned(DNS_N) on the first two axes, r2c keeping
    DNS_N / 2 + 1 bins on the last (``config`` overrides the plan's other
    fields)."""
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.examples.navier_stokes import dns_plan

    cfg = {"method": "fused", "impl": "matmul", "exchange_impl": "cuda", **config}
    return dns_plan(mesh, DNS_N, PlanConfig(comm_dtype=comm, batch_fusion=fusion, **cfg))


def _codec_designs(torch, plan, direction, nfields, codec):
    """The K1 and K3 launches by design that one ``nfields``-field call of
    ``plan`` must make: per exchange, the design ``ref.tile_design`` gives
    the encode's and the decode's ``(F, O, M, S)`` view (fresh, aligned
    storage), once for the stack or once per field by the plan's
    ``batch_fusion``; keyed as the path's counts."""
    from collections import Counter

    from repro_torch.core.pencil import group_size
    from repro_torch.core.pfft import ExchangeStage
    from repro_torch.kernels.exchange import ops as xops, ref as xref

    stages, pencils, _, _ = plan._walk(direction)
    dtypes = plan.dtype_trace if direction == "forward" else plan.dtype_trace[::-1]
    stacked = plan.config.batch_fusion == "stacked" or nfields == 1
    nb, calls = (1, 1) if stacked else (0, nfields)
    want = Counter()
    for i, st in enumerate(stages):
        if not isinstance(st, ExchangeStage):
            continue
        m = group_size(plan.mesh, st.group)
        shape = ((nfields,) if nb else ()) + pencils[i].local_shape
        P = 2 if dtypes[i] == torch.complex64 else 1
        F, O, M, S = xops._chunk_view(shape, st.v + nb, m, nb)
        chunk = list(shape)
        chunk[st.v + nb] //= m
        bw = st.w + nb
        dec = xref.tile_design(math.prod(chunk[:nb]), math.prod(chunk[nb:bw]), m,
                               math.prod(chunk[bw:]), P, 1, 0, 0)
        want[f"{xref.tile_design(F, O, M, S, P, 1, 0, 0)}:{codec}"] += (
            calls * xops.ENCODE_KERNELS[codec])
        want[f"decode:{dec}:{codec}"] += calls
    return want


class _LaunchesByShape:
    """While active, the launches of K1 (``pack_chunks``), K3
    (``unpack_chunks``) and K4 (``fops._run``, under every FFT wrapper) by
    the arguments of the call that made them: ``calls`` maps ``(kernel,
    signature)`` to ``{"launches": n, "designs": {...}}``, each read from
    the wrappers' own counters around the call."""

    def __init__(self, calls):
        self.calls = calls

    def _wrap(self, module, name, counter, designs, key):
        real = getattr(module, name)

        def logged(*args, **kwargs):
            before, dbefore = sum(counter.values()), dict(designs)
            out = real(*args, **kwargs)
            n = sum(counter.values()) - before
            if n:
                rec = self.calls.setdefault(key(*args, **kwargs),
                                            {"launches": 0, "designs": set()})
                rec["launches"] += n
                rec["designs"] |= {d.split(":")[0] for d, k in designs.items()
                                   if k != dbefore.get(d, 0)}
            return out

        self._saved.append((module, name, real))
        setattr(module, name, logged)

    def __enter__(self):
        from repro_torch.kernels.exchange import ops as xops
        from repro_torch.kernels.fft import ops as fops

        self._saved = []
        self._wrap(xops, "pack_chunks", xops.launches, xops.design_launches,
                   lambda y, *, axis, m, nbatch=0, codec, guard=False, scale_div=None: (
                       "K1", tuple(y.shape), str(y.dtype), axis, m, nbatch, codec, guard,
                       scale_div))
        self._wrap(xops, "unpack_chunks", xops.launches, xops.decode_design_launches,
                   lambda p, *, v, w, m, nbatch=0, scale, codec, iscomplex: (
                       "K3", tuple(p.shape), v, w, m, nbatch, codec, iscomplex))
        self._wrap(fops, "_run", fops.launches, fops.design_launches,
                   lambda rows, *, inverse, nout, mode: (
                       "K4", tuple(rows.shape), str(rows.dtype), inverse, nout, mode))
        return self

    def __exit__(self, *exc):
        for module, name, real in self._saved:
            setattr(module, name, real)


def _many_call(torch, fn, want_designs, want_collectives, k4_design, what):
    """``(fn(), launches)``: one batched call with its K4 launches (each on
    ``k4_design``), its K1/K3 launches by design (exactly
    ``want_designs``) and its ``all_to_all_single`` calls (exactly
    ``want_collectives``) checked."""
    from repro_torch.kernels.exchange import ops as xops
    from repro_torch.kernels.fft import ops as fops

    k4, designs = dict(fops.design_launches), {k: dict(c) for k, c in (
        ("enc", xops.design_launches), ("dec", xops.decode_design_launches))}
    from repro_torch.analysis.planlint import CollectiveRecorder

    with CollectiveRecorder() as cc:
        out = fn()
        torch.cuda.synchronize()
    k4_ran = {k: n - k4.get(k, 0) for k, n in fops.design_launches.items() if n != k4.get(k, 0)}
    ran = {k: n - designs["enc"].get(k, 0) for k, n in xops.design_launches.items()
           if n != designs["enc"].get(k, 0)}
    ran.update({f"decode:{k}": n - designs["dec"].get(k, 0)
                for k, n in xops.decode_design_launches.items()
                if n != designs["dec"].get(k, 0)})
    if not k4_ran or any(not k.startswith(f"{k4_design}:") for k in k4_ran):
        fail(f"{what}: K4 ran {k4_ran}, want every launch on the {k4_design} design")
    if ran != dict(want_designs):
        fail(f"{what}: K1/K3 ran {ran}, the tile rule gives {dict(want_designs)}")
    if cc.n != want_collectives:
        fail(f"{what}: {cc.n} all_to_all_single calls, want {want_collectives}")
    return out, {"fourstep": k4_ran, "codec": ran, "collectives": cc.n}


def many_path(torch, mesh, records):
    """Batched multi-field execution: (a) examples/navier_stokes.py's plan
    at DNS_M^3, a 3-field forward_many and a 9-field backward_many under
    each batch_fusion, bitwise equal to the per-field loop of the same wire
    (lossless and bf16) and bf16 within tolerance of the lossless loop, each
    timed against N single-field calls, one across-fields call traced; (b) 3
    stacked fields at 512^3 with an int8 wire, field 1 at 1e3, each bitwise
    equal to its own single-field forward and within tolerance of
    torch.fft.fftn, and the traditional engine's int8
    exchange of stacked fields (plain and transposed out) against the plain
    codec; (c) guarded batches."""
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.kernels.fft import ops as fops

    k4_dns = "tc" if fops.tensor_core_design(*fops.plan_factors(DNS_M)) else "general"
    gen = torch.Generator(device="cuda").manual_seed(5)
    u3 = torch.randn((3,) + (DNS_M,) * 3, device="cuda", generator=gen)
    s9 = torch.randn((9, DNS_N, DNS_N, DNS_N // 2 + 1), dtype=torch.complex64, device="cuda",
                     generator=gen)
    lossless = {}
    for comm in ("complex64", "bf16"):
        base = _dns_plan(mesh, comm, "stacked")
        loop = {"forward": torch.stack([base.forward(u) for u in u3]),
                "backward": torch.stack([base.backward(s) for s in s9])}
        single_ms = {"forward": cuda_ms(torch, lambda: base.forward_padded(u3[0])),
                     "backward": cuda_ms(torch, lambda: base.backward_padded(s9[0]))}
        if comm == "complex64":
            lossless = loop
        for fusion in BATCH_FUSIONS:
            plan = _dns_plan(mesh, comm, fusion)
            for direction, x, tol in (("forward", u3, TOL_FWD), ("backward", s9, TOL_BACK)):
                nf = x.shape[0]
                what = f"many dns {direction} {comm} {fusion}"
                many = getattr(plan, f"{direction}_many")
                y, launches = _many_call(
                    torch, lambda: many(x), _codec_designs(torch, plan, direction, nf, comm)
                    if comm != "complex64" else {},
                    plan.model_collective_launches(nfields=nf, direction=direction), k4_dns, what)
                bitwise = torch.equal(y, loop[direction])
                errs = [rel_l2(torch, a, b) for a, b in zip(y, lossless[direction])]
                if not bitwise:  # bf16 too: one codec per element, the same per field
                    fail(f"{what}: not bitwise equal to the per-field loop")
                if max(errs) > tol[comm]:
                    fail(f"{what}: rel L2 vs the lossless loop {max(errs)} (<= {tol[comm]})")
                del y
                fn = getattr(plan, f"{direction}_many_padded")(nf)
                ms = cuda_ms(torch, lambda: fn(x))
                records.append({"case": "dns", "direction": direction, "comm_dtype": comm,
                                "batch_fusion": fusion, "nfields": nf,
                                "shape": [DNS_M] * 3, "spectral": [DNS_N, DNS_N, DNS_N // 2 + 1],
                                "bitwise_equal_loop": bitwise, "max_rel_l2_vs_lossless": max(errs),
                                "launches_per_call": launches,
                                "model_collective_launches": plan.model_collective_launches(
                                    nfields=nf, direction=direction),
                                "ms": ms, "single_ms": single_ms[direction],
                                "n_x_single_ms": nf * single_ms[direction],
                                "over_n_x_single": ms / (nf * single_ms[direction])})
        del loop
    records.append({"case": "dns_trace", **_across_fields_trace(torch, mesh, u3)})
    # impl="torch" (cuFFT): every batch_fusion bitwise equal to the per-field loop
    base = _dns_plan(mesh, "complex64", "stacked", impl="torch")
    loop = {"forward": torch.stack([base.forward(u) for u in u3]),
            "backward": torch.stack([base.backward(s) for s in s9])}
    same = {}
    for fusion in BATCH_FUSIONS:
        plan = _dns_plan(mesh, "complex64", fusion, impl="torch")
        for direction, x in (("forward", u3), ("backward", s9)):
            same[f"{direction}:{fusion}"] = torch.equal(getattr(plan, f"{direction}_many")(x),
                                                        loop[direction])
    if not all(same.values()):
        fail(f"many dns impl=torch: not bitwise equal to the per-field loop: {same}")
    records.append({"case": "dns_impl_torch", "comm_dtype": "complex64",
                    "bitwise_equal_loop": same})
    del u3, s9, lossless, loop
    torch.cuda.empty_cache()

    # (b) 3 stacked fields at 512^3 through an int8 wire, field 1 at 1e3
    x3 = torch.randn((3,) + SHAPE_BIG, dtype=torch.complex64, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(6))
    x3[1] *= 1e3
    cfg = PlanConfig(method="fused", impl="matmul", exchange_impl="cuda", comm_dtype="int8")
    plan = ParallelFFT(mesh, SHAPE_BIG, ("p0", "p1"), config=cfg)
    fn = plan.forward_many_padded(3)
    y3, launches = _many_call(torch, lambda: fn(x3), _codec_designs(torch, plan, "forward", 3, "int8"),
                              2 * plan.model_collective_launches(nfields=3), "tc",
                              "many 512^3 int8 stacked")
    errs, exact, same = [], [], []
    for f in range(3):
        single = plan.forward_padded(x3[f])
        errs.append(rel_l2(torch, y3[f], single))
        same.append(torch.equal(y3[f], single))
        del single
        exact.append(rel_l2(torch, y3[f], torch.fft.fftn(x3[f])))
    # one scale per (field, chunk): each field is quantized as in its own
    # single-field call, so the stack is bitwise equal to the three calls
    if not all(same) or max(exact) > TOL_FWD["int8"]:
        fail(f"many 512^3 int8 stacked: bitwise equal to each field's single forward {same} "
             f"(rel L2 {errs}), rel L2 vs fftn {exact} (<= {TOL_FWD['int8']})")
    del y3
    many_ms = cuda_ms(torch, lambda: fn(x3))
    single_ms = cuda_ms(torch, lambda: plan.forward_padded(x3[0]))
    records.append({"case": "stacked_int8", "shape": list(SHAPE_BIG), "nfields": 3,
                    "field_scales": [1.0, 1e3, 1.0], "launches_per_call": launches,
                    "rel_l2_vs_single_forward": errs, "bitwise_equal_single_forward": same,
                    "rel_l2_vs_fftn": exact, "ms": many_ms,
                    "single_ms": single_ms, "n_x_single_ms": 3 * single_ms,
                    "over_n_x_single": many_ms / (3 * single_ms)})
    records.append({"case": "traditional_int8_stacked", **_traditional_int8_stacked(torch, mesh)})

    # (c) guarded batches: strict clean = unguarded; bf16 corrupted wire degrades
    yu = fn(x3)
    strict = ParallelFFT(mesh, SHAPE_BIG, ("p0", "p1"), config=cfg.replace(guard="strict"))
    yg, rep = strict.forward_many(x3)
    if not rep.ok or rep.transitions or rep.nfields != 3 or not torch.equal(yg, yu):
        fail(f"many guard strict: ok={rep.ok} nfields={rep.nfields} transitions="
             f"{rep.transitions} equal={torch.equal(yg, yu)}")
    del yg
    guarded = strict.guarded_padded("forward", nfields=3)
    g_ms = cuda_ms(torch, lambda: guarded(x3))
    records.append({"case": "guard_strict", "comm_dtype": "int8", "nfields": rep.nfields,
                    "ok": rep.ok, "bitwise_equal_unguarded": True, "guarded_ms": g_ms,
                    "unguarded_ms": many_ms, "stages": [st.to_dict() for st in rep.stages]})
    clean = ParallelFFT(mesh, SHAPE_BIG, ("p0", "p1"), config=cfg.replace(comm_dtype="complex64"))
    yc = clean.forward_many_padded(3)(x3)
    from repro_torch.robustness import FaultPlan

    deg = ParallelFFT(mesh, SHAPE_BIG, ("p0", "p1"),
                      config=cfg.replace(comm_dtype="bf16", guard="degrade"))
    with FaultPlan().corrupt_wire(engine="fused", codec="bf16"):
        yd, rep = deg.forward_many(x3)
    err = rel_l2(torch, yd, yc)
    if not rep.ok or not rep.transitions or rep.nfields != 3 or err > 1e-5:
        fail(f"many guard degrade: ok={rep.ok} transitions={rep.transitions} "
             f"nfields={rep.nfields} rel L2 vs lossless {err}")
    records.append({"case": "guard_degrade_corrupt_wire_bf16", "nfields": rep.nfields,
                    "ok": rep.ok, "attempts": rep.attempts,
                    "schedule": [list(e) for e in rep.schedule],
                    "transitions": [t.get("tripped") for t in rep.transitions],
                    "rel_l2_vs_lossless": err})
    del x3, yu, yc, yd


def _energies_within(a, b, tol):
    """Largest relative difference of two energy histories, and whether it is
    within ``tol``."""
    worst = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    return worst, worst <= tol


def _decrements(energies):
    """An energy history's decrements ``E_k - E_0``, k >= 1."""
    return [e - energies[0] for e in energies[1:]]


def dns_path(torch, mesh, records, shapes):
    """The example twins on the card: (a) the Navier-Stokes twin's RK2
    Taylor-Green DNS (``repro_torch.examples.navier_stokes.run``) at DNS_N
    modes on the DNS_M^3 grid, DNS_STEPS steps of DNS_DT, in each of DNS_CONFIGS, the
    example's checks held (E0 = 0.125 within TOL_DNS on the lossless runs, a
    monotone decay, max|div| < 1e-3 sqrt(E0), the initial rate within 10 %
    of 6 nu, the batched forward bitwise the per-field loop on the lossless
    runs, the guarded demo's recovery on them), the slice run's energies
    within TOL_DNS of the example's at every step and the bf16 run's within
    TOL_DNS_BF16, its decrements E_k - E_0 within TOL_DNS_BF16_DECAY; one step's K1/K3/K4 launches and collectives exactly as
    the plan counts; a step's ms and a RHS's split into its three batched
    transforms and the rest (``cuda_ms``); the bf16 run's K1, K3 and K4
    launches by call into ``shapes``; (b) the quickstart twin in the
    example's and the slice configuration; (c) the Poisson twin at
    POISSON_SHAPE in the slice configuration, max|u - u*| < 1e-3.  One
    record each into ``records``."""
    from repro_torch.analysis.planlint import CollectiveRecorder
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.examples import navier_stokes as ns, poisson, quickstart

    energies = {}
    for name, fields in DNS_CONFIGS.items():
        cfg = PlanConfig(**fields)
        lossless = cfg.comm_dtype == "complex64"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        log = _LaunchesByShape(shapes) if name == "slice_bf16" else contextlib.nullcontext()
        with log:
            out = ns.run(mesh, DNS_N, nu=DNS_NU, dt=DNS_DT, steps=DNS_STEPS, config=cfg,
                         guard_demo=lossless)
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        energies[name] = out["energies"]
        what = f"dns {name}"
        checks = dict(out["checks"])
        if lossless:
            checks["E0"] = abs(out["E0"] - 0.125) <= TOL_DNS * 0.125
        else:
            checks.pop("bitwise_batched")  # reported, not required of a lossy wire
        if not all(checks.values()):
            fail(f"{what}: checks {checks} (E0 {out['E0']}, div {out['div']}, rate {out['rate']}, "
                 f"guarded {out.get('guarded')})")

        # one step: launches and collectives exactly as the plan counts them
        plan = ns.dns_plan(mesh, DNS_N, cfg)
        tg = ns.TaylorGreen(plan, DNS_N, nu=DNS_NU, dt=DNS_DT)
        u_hat = tg.project(tg.fwd3(tg.initial()))
        tg.step(u_hat)
        torch.cuda.synchronize()
        before = _count_snapshot()
        with CollectiveRecorder() as cc:
            tg.step(u_hat)
            torch.cuda.synchronize()
        after = _count_snapshot()
        grew = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        got = {"fourstep": sum(n for k, n in grew.items() if k.startswith(("tc:", "general:"))),
               "encode": sum(n for k, n in grew.items() if k.startswith("pack_chunks:")),
               "decode": sum(n for k, n in grew.items() if k.startswith("unpack_chunks:"))}
        one = _want_launches(plan, cfg.comm_dtype) if cfg.impl == "matmul" else {
            "fourstep": 0, "encode": 0, "decode": 0}
        if cfg.exchange_impl != "cuda" or lossless:
            one = {**one, "encode": 0, "decode": 0}
        want = {k: 6 * v for k, v in one.items()}  # 2 RHS x 3 batched calls a step
        want_colls = 2 * sum(plan.model_collective_launches(nfields=nf, direction=d)
                             for nf, d in ((3, "backward"), (9, "backward"), (3, "forward")))
        if got != want or cc.n != want_colls:
            fail(f"{what}: a step launched {got} with {cc.n} collectives, the plan counts "
                 f"{want} and {want_colls}")

        # a step, and a RHS split into its three batched transforms and the rest
        step_ms = cuda_ms(torch, lambda: tg.step(u_hat), reps=3)
        rhs_ms = cuda_ms(torch, lambda: tg.rhs(u_hat), reps=3)
        u = tg.bwd3(u_hat)
        ik = tg.gradient_hat(u_hat)
        grads = tg.bwd9(ik).reshape(3, 3, *u.shape[1:])
        conv = tg.convection(u, grads)
        calls = {"bwd3": cuda_ms(torch, lambda: tg.bwd3(u_hat), reps=3),
                 "bwd9": cuda_ms(torch, lambda: tg.bwd9(ik), reps=3),
                 "fwd3": cuda_ms(torch, lambda: tg.fwd3(conv), reps=3)}
        conv_ms = cuda_ms(torch, lambda: tg.convection(u, grads), reps=3)
        del grads
        records.append({"case": "taylor_green", "config": name, "plan_config": fields,
                        "N": DNS_N, "M": DNS_M, "steps": DNS_STEPS, "nu": out["nu"],
                        "dt": out["dt"], "energies": out["energies"], "E0": out["E0"],
                        "div": out["div"], "rate": out["rate"],
                        "bitwise_batched": out["bitwise_batched"], "checks": checks,
                        "guarded": out.get("guarded"), "launches_per_step": got,
                        "collectives_per_step": cc.n, "step_ms": step_ms, "rhs_ms": rhs_ms,
                        "rhs_calls_ms": calls, "rhs_rest_ms": rhs_ms - sum(calls.values()),
                        "convection_ms": conv_ms,
                        "run_s": run_s, "peak_gib": peak})
        del tg, plan, u_hat, u, ik, conv
        gc.collect()
        torch.cuda.empty_cache()
    worst, ok = _energies_within(energies["slice"], energies["example"], TOL_DNS)
    worst16, ok16 = _energies_within(energies["slice_bf16"], energies["example"], TOL_DNS_BF16)
    decay16, okd = _energies_within(*(_decrements(energies[k]) for k in ("slice_bf16", "example")),
                                    TOL_DNS_BF16_DECAY)
    records.append({"case": "taylor_green_vs_example", "slice_max_rel": worst, "limit": TOL_DNS,
                    "slice_bf16_max_rel": worst16, "limit_bf16": TOL_DNS_BF16,
                    "slice_bf16_decrement_max_rel": decay16,
                    "limit_bf16_decrement": TOL_DNS_BF16_DECAY})
    if not (ok and ok16 and okd):
        fail(f"dns: energies vs the example's run: slice {worst} (<= {TOL_DNS}), bf16 {worst16} "
             f"(<= {TOL_DNS_BF16}), bf16 decrements {decay16} (<= {TOL_DNS_BF16_DECAY})")

    for name in ("example", "slice"):
        cfg = PlanConfig(**DNS_CONFIGS[name])
        out = quickstart.run(mesh, cfg)
        out.pop("plan")
        if not out["ok"]:
            fail(f"quickstart {name}: outside the example's limits {out}")
        records.append({"case": "quickstart", "config": name, **out})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = poisson.run(mesh, PlanConfig(**DNS_CONFIGS["slice"]), shape=POISSON_SHAPE)
    torch.cuda.synchronize()
    out.pop("plan")
    if not out["ok"]:
        fail(f"poisson {POISSON_SHAPE}: max|u - u*| = {out['err']} (< {poisson.TOL})")
    records.append({"case": "poisson", "config": "slice", **out,
                    "seconds": time.perf_counter() - t0,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    torch.cuda.empty_cache()


def audit_path(torch, mesh, records):
    """The run-time plan audit (``repro_torch.analysis.planlint``) of every
    example plan on this rank: any violation fails the run.  At M = 1 the
    wire bytes are 0 and the lossless pack of a contiguous block is a
    view."""
    from repro_torch.analysis import planlint

    for label, (plan, nfields) in planlint.example_plans(mesh).items():
        rep = planlint.audit_plan(plan, nfields=nfields, label=label)
        records.append({"plan": label, "nfields": nfields, **rep.summary(),
                        "schedule": [list(e) for e in rep.schedule]})
        if not rep.ok:
            fail(f"audit {label}: {[v.to_dict() for v in rep.violations]}")
    torch.cuda.synchronize()


def _traditional_int8_stacked(torch, mesh):
    """The traditional engine's int8 exchange of 3 stacked fields (field 1
    at 1e3), plain and transposed out, through the kernels (K1, K3) against
    the plain codec: within one quantum of each field."""
    from repro_torch.core.redistribute import exchange_shard
    from repro_torch.kernels.exchange import ops as xops

    x = _randn(torch, (3, 64, 48, 40), 8)
    x[1] *= 1e3
    out = {}
    for tout in (False, True):
        before = sum(xops.launches.values())
        kw = dict(mesh=mesh, method="traditional", comm_dtype="int8", nbatch=1,
                  transposed_out=tout)
        got = exchange_shard(x, 2, 1, "p1", impl="cuda", **kw)
        torch.cuda.synchronize()
        kernels = sum(xops.launches.values()) - before
        want = exchange_shard(x, 2, 1, "p1", impl="torch", **kw)
        fa = 1 if tout else 0
        errs = []
        for f in range(3):
            xf = x[f]
            quantum = float(torch.view_as_real(xf).abs().max()) / 127.0
            errs.append(_max_err(torch, got.select(fa, f), want.select(fa, f)) / quantum)
        if got.shape != want.shape or max(errs) > 1.0 or kernels != 3:
            fail(f"traditional int8 stacked (transposed_out={tout}): shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)}, {max(errs)} quanta from the plain codec, "
                 f"{kernels} kernel launches (want 3)")
        out[f"transposed_out={tout}"] = {"shape": list(got.shape), "max_quanta": max(errs)}
    return out


def _across_fields_trace(torch, mesh, u3):
    """One traced 3-field bf16 forward_many of the DNS plan under
    "pipelined-across-fields" and under "per-field": each exchange stage's
    collective of field f against field f - 1's K4 launch.  On one rank
    the all-to-all is NCCL's self-copy, a device-to-device copy (or an NCCL
    kernel), on the collective's stream when issued with ``async_op=True``.
    Across fields, field f's collective can start before field f - 1's
    FFT starts; per field it comes after.  ``order`` spells the device
    events in time order: F a K4, E a K1, D a K3, A a collective's copy or
    kernel, . anything else.  A record, not a check: the host's issue order
    is held on the CPU (tests/test_torch_many.py)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for fusion in ("pipelined-across-fields", "per-field"):
        fn = _dns_plan(mesh, "bf16", fusion).forward_many_padded(3)
        fn(u3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(u3)
            torch.cuda.synchronize()
        path = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_")) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy")]
        shutil.rmtree(path.parent, ignore_errors=True)
        events.sort(key=lambda e: e["ts"])

        def label(e):
            if "nccl" in e["name"].lower() or e["cat"] == "gpu_memcpy":
                return "A"
            return ("F" if "fourstep" in e["name"] else "E" if "enc_" in e["name"]
                    else "D" if "decode" in e["name"] else ".")

        order = "".join(label(e) for e in events)
        coll = [e for e, c in zip(events, order) if c == "A"]
        k4 = [e for e in events if "fourstep" in e["name"]][1:]  # after the stacked first stage
        rec = {"collectives": len(coll), "k4_after_first_stage": len(k4),
               "collective_streams": sorted({str(e.get("tid")) for e in coll}),
               "k4_streams": sorted({str(e.get("tid")) for e in k4}), "order": order}
        if len(coll) == len(k4) == 6:
            # stage s, field f: collective 3s + f against K4 3s + f - 1
            lead = [coll[3 * st + f]["ts"] - k4[3 * st + f - 1]["ts"]
                    for st in range(2) for f in (1, 2)]
            rec["collective_start_minus_prev_fft_start_us"] = lead
            rec["collective_before_prev_fft"] = all(t < 0 for t in lead)
        else:
            rec["collective_before_prev_fft"] = None  # the trace does not show them all
        out[fusion] = rec
    return out


def measure_coeffs(torch, rounds=COEFF_ROUNDS):
    """The time model's constants on this card (core/hardware.py holds
    them), each the median of ``rounds`` readings with their least and
    greatest beside it: HBM bytes/s of a device-to-device copy of 1 GiB of
    complex64 (its read and write counted); the local FFT's flop/s,
    ``torch.fft.fft`` on 262144 rows of n = 512 counted 5 n log2 n a row as
    the plan counts; and the per-call cost of one ``all_to_all_single`` of
    4 KiB on the 1-rank NCCL group, three ways: the host clock over 200
    calls to a synchronize, CUDA events around 200 calls enqueued as the
    host goes (both host-bound: they should agree), and the device's own
    time of one call (``cuda_ms``, the calls queued behind a spin).  The
    model's latency constant is the device's reading: the host-bound ones
    spread several-fold between processes.  One card cannot measure a
    collective across cards or their bandwidth.  The SM and memory clocks
    are read before and after."""
    import torch.distributed as dist

    from repro_torch.core import hardware

    def spread(xs):
        return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "n": len(xs)}

    def clocks():
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
                               "clocks.max.mem", "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()

    clock_before = clocks()
    n = COEFF_COPY_ELEMS
    src = torch.randn(n, dtype=torch.complex64, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = [cuda_ms(torch, lambda: dst.copy_(src)) for _ in range(rounds)]
    del src, dst
    rows = torch.randn((COEFF_FFT_ROWS, 512), dtype=torch.complex64, device="cuda")
    fft_ms = [cuda_ms(torch, lambda: torch.fft.fft(rows, dim=-1)) for _ in range(rounds)]
    flops = 5.0 * 512 * math.log2(512) * rows.shape[0]
    del rows
    t = torch.zeros(512, dtype=torch.float64, device="cuda")
    out = torch.empty_like(t)

    def a2a():
        dist.all_to_all_single(out, t)

    for _ in range(20):
        a2a()
    torch.cuda.synchronize()
    host, events = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(200):
            a2a()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) / 200)
        events.append(_events_ms(torch, lambda: [a2a() for _ in range(200)]) / 200 / 1e3)
    device = [cuda_ms(torch, a2a) / 1e3 for _ in range(rounds)]
    hbm = [2 * n * 8 / (ms / 1e3) for ms in copy_ms]
    fft = [flops / (ms / 1e3) for ms in fft_ms]
    return {"hbm_bw": statistics.median(hbm), "hbm_bw_rounds": spread(hbm),
            "copy_1gib_ms": spread(copy_ms),
            "peak_flops": statistics.median(fft), "peak_flops_rounds": spread(fft),
            "fft_262144x512_ms": spread(fft_ms), "fft_flops": flops,
            "ici_latency_s": statistics.median(device), "a2a_4kib_device_s": spread(device),
            "a2a_4kib_host_s": spread(host), "a2a_4kib_events_s": spread(events),
            "clocks_sm_max_mem_max": [clock_before, clocks()],
            "ici_bw": hardware.ICI_BW, "ici_bw_source": "NVLink 4 data sheet, unmeasured: one card",
            "code_constants": {"hbm_bw": hardware.HBM_BW, "peak_flops": hardware.PEAK_FLOPS,
                               "ici_latency_s": hardware.ICI_LATENCY_S,
                               "ici_bw": hardware.ICI_BW, "card": hardware.CARD}}


def _lossiest(schedule):
    return max((e.comm_dtype for e in schedule), key=COMM_DTYPES.index)


def _timings_ms(cache, plan, nfields=1):
    """The tuned entry's stage times in ms (refusals and pruned keys kept as
    written)."""
    from repro_torch.core import tuner

    entry = tuner.load_cache(cache)[tuner.plan_key(plan, nfields=nfields)]
    return {st: {k: (v * 1e3 if isinstance(v, float) else v) for k, v in per.items()}
            for st, per in entry["timings"].items()}


def tune_path(torch, mesh, records, uniform, shapes):
    """The schedule tuner (``method="auto"``) on the card, with its own
    cache directory: (a) the quickstart with an int8 budget and the
    exchange kernels swept (25 candidates a stage), checked against
    ``np.fft.fftn`` and replayed by a second plan with no timing, bitwise;
    (b) 512^3 with a bf16 budget (15 a stage), its forward and backward
    timed beside every uniform explicit config (``uniform``: the earlier
    paths' times of the exchange_impl="cuda" ones) and the model's time; (c)
    the DNS plan at 384^3, bf16 budget, 3 fields (45 batch-aware candidates
    a stage), its collectives counted against the model; (d) a poisoned
    pipelined entry under a pipelined compile fault, guard="degrade":
    quarantined once, retuned, ok.  ``shapes`` gets the path's K1, K3 and
    K4 launches by the arguments of each call (``_LaunchesByShape``)."""
    import numpy as np

    from repro_torch.analysis.planlint import CollectiveRecorder
    from repro_torch.core import modelfit, tuner
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.robustness import FaultPlan

    cache_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
    timed = [0]
    real_time_stage = tuner._time_stage

    def counted(*args, **kwargs):
        timed[0] += 1
        return real_time_stage(*args, **kwargs)

    def resolve(fn):
        """``(fn(), _time_stage calls, seconds)`` of one schedule resolve."""
        timed[0] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, timed[0], time.perf_counter() - t0

    tuner._time_stage = counted
    try:
        with _LaunchesByShape(shapes):
            base = dict(method="auto", impl="matmul", exchange_impl="cuda")

            # (a) the quickstart, int8 budget
            cache = cache_dir / "quickstart.json"
            cfg = PlanConfig(comm_dtype="int8", tuner_cache=str(cache), **base)
            rng = np.random.default_rng(0)
            u = (rng.standard_normal(SHAPE_QS) + 1j * rng.standard_normal(SHAPE_QS)).astype(
                np.complex64)
            want = torch.from_numpy(np.fft.fftn(u)).cuda()
            plan = ParallelFFT(mesh, SHAPE_QS, ("p0", "p1"), config=cfg)
            sched, n_timed, tune_s = resolve(lambda: plan.schedule)
            per_stage = len(tuner.candidates_for("int8", "cuda"))
            if n_timed != plan.n_exchanges * per_stage:
                fail(f"tune quickstart: {n_timed} stage timings, want {plan.n_exchanges} x {per_stage}")
            uh = plan.forward(u)
            _check_finite(torch, "tune quickstart", uh, SHAPE_QS)
            worst = _lossiest(sched)
            err = rel_l2(torch, uh, want)
            if err > TOL_FWD[worst]:
                fail(f"tune quickstart: rel L2 vs fftn {err} (<= {TOL_FWD[worst]}, {worst})")
            tuner._MEMO.clear()
            again = ParallelFFT(mesh, SHAPE_QS, ("p0", "p1"), config=cfg)
            sched2, replay_timed, _ = resolve(lambda: again.schedule)
            uh2 = again.forward(u)
            if replay_timed or sched2 != sched or not torch.equal(uh2, uh):
                fail(f"tune quickstart replay: {replay_timed} timings, schedule {sched2} vs {sched}, "
                     f"bitwise {torch.equal(uh2, uh)}")
            records.append({"case": "quickstart", "shape": list(SHAPE_QS), "budget": "int8",
                            "exchange_impl": "cuda", "candidates_a_stage": per_stage,
                            "schedule": [list(e) for e in sched], "timings_ms": _timings_ms(cache, plan),
                            "time_stage_calls": n_timed, "tune_s": tune_s,
                            "rel_l2_fwd_vs_fftn": err, "tol": TOL_FWD[worst],
                            "replay_time_stage_calls": replay_timed, "replay_bitwise_equal": True})
            del want, uh, uh2

            # (b) 512^3, bf16 budget, against every uniform explicit config
            cache = cache_dir / "big.json"
            x = _big_input(torch)
            plan = ParallelFFT(mesh, SHAPE_BIG, ("p0", "p1"),
                               config=PlanConfig(comm_dtype="bf16", tuner_cache=str(cache), **base))
            sched, n_timed, tune_s = resolve(lambda: plan.schedule)
            per_stage = len(tuner.candidates_for("bf16", "cuda"))
            if n_timed != plan.n_exchanges * per_stage:
                fail(f"tune 512^3: {n_timed} stage timings, want {plan.n_exchanges} x {per_stage}")
            y = plan.forward_padded(x)
            _check_finite(torch, "tune 512^3", y, SHAPE_BIG)
            worst = _lossiest(sched)
            err = rel_l2(torch, y, torch.fft.fftn(x))
            if err > TOL_FWD[worst]:
                fail(f"tune 512^3: rel L2 vs fftn {err} (<= {TOL_FWD[worst]}, {worst})")
            fwd_ms = cuda_ms(torch, lambda: plan.forward_padded(x))
            bwd_ms = cuda_ms(torch, lambda: plan.backward_padded(y))
            del y
            model = {"forward": plan.model_time_s() * 1e3,
                     "backward": plan.model_time_s(direction="backward") * 1e3}
            # the slice and engines paths timed every exchange_impl="cuda"
            # config in this run; a lossless exchange runs no codec, so its
            # time stands for both impls; the torch codec is timed here
            configs = {}
            for method in ("fused", "traditional", "pipelined"):
                for comm, impl in (("complex64", "cuda"), ("bf16", "cuda"), ("bf16", "torch")):
                    p = ParallelFFT(mesh, SHAPE_BIG, ("p0", "p1"), config=PlanConfig(
                        method=method, chunks=4, impl="matmul", exchange_impl=impl,
                        comm_dtype=comm))
                    if impl == "cuda":
                        ms, timed_by = uniform[f"{method}@{comm}@cuda"], (
                            "slice" if method == "fused" and comm != "complex64" else "engines")
                    else:
                        ms, timed_by = cuda_ms(torch, lambda: p.forward_padded(x)), "tune"
                    m_ms = p.model_time_s() * 1e3
                    configs[f"{method}@{comm}" + ("" if comm == "complex64" else f"@{impl}")] = {
                        "forward_ms": ms, "timed_by": timed_by, "model_ms": m_ms,
                        "measured_over_model": ms / m_ms}
            best = min(configs, key=lambda k: configs[k]["forward_ms"])
            if fwd_ms > 1.25 * configs[best]["forward_ms"]:
                fail(f"tune 512^3: tuned forward {fwd_ms} ms > 1.25 x the fastest uniform "
                     f"{best} {configs[best]['forward_ms']} ms")
            records.append({"case": "512^3", "shape": list(SHAPE_BIG), "budget": "bf16",
                            "exchange_impl": "cuda", "candidates_a_stage": per_stage,
                            "schedule": [list(e) for e in sched],
                            "timings_ms": _timings_ms(cache, plan), "time_stage_calls": n_timed,
                            "tune_s": tune_s, "rel_l2_fwd_vs_fftn": err, "tol": TOL_FWD[worst],
                            "forward_ms": fwd_ms, "backward_ms": bwd_ms, "model_ms": model,
                            "measured_over_model": {"forward": fwd_ms / model["forward"],
                                                    "backward": bwd_ms / model["backward"]},
                            "uniform_forward": configs, "fastest_uniform": best,
                            # modelfit's flag: a point the model misses by more than 2x
                            "model_misses_2x": sorted(
                                k for k, v in configs.items()
                                if not 1 / modelfit.DEFAULT_MISS_FACTOR <= v["measured_over_model"]
                                <= modelfit.DEFAULT_MISS_FACTOR),
                            "tuned_over_fastest_uniform": fwd_ms / configs[best]["forward_ms"]})
            del x
            torch.cuda.empty_cache()

            # (c) the DNS plan, bf16 budget, 3 fields
            cache = cache_dir / "dns.json"
            plan = _dns_plan(mesh, "bf16", "stacked", method="auto", tuner_cache=str(cache))
            u3 = torch.randn((3,) + (DNS_M,) * 3, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(5))
            bsched, n_timed, tune_s = resolve(lambda: plan.batched_schedule(3))
            cands = tuner.batched_candidates_for("bf16", "cuda")
            if n_timed != plan.n_exchanges * len(cands) or any(e not in cands for e in bsched):
                fail(f"tune dns: {n_timed} stage timings (want {plan.n_exchanges} x {len(cands)}), "
                     f"schedule {bsched}")
            with CollectiveRecorder() as cc:
                y3 = plan.forward_many(u3)
                torch.cuda.synchronize()
            want_colls = plan.model_collective_launches(nfields=3)
            if cc.n != want_colls:
                fail(f"tune dns: {cc.n} all_to_all_single calls, the model counts {want_colls}")
            lossless = _dns_plan(mesh, "complex64", "stacked").forward_many(u3)
            worst = _lossiest(bsched)
            errs = [rel_l2(torch, a, b) for a, b in zip(y3, lossless)]
            if max(errs) > TOL_FWD[worst]:
                fail(f"tune dns: rel L2 vs the lossless stacked forward {errs} (<= {TOL_FWD[worst]})")
            del y3, lossless
            fn = plan.forward_many_padded(3)
            ms = cuda_ms(torch, lambda: fn(u3))
            m_ms = plan.model_time_s(nfields=3) * 1e3
            records.append({"case": "dns_3_fields", "shape": [DNS_M] * 3, "budget": "bf16",
                            "nfields": 3, "candidates_a_stage": len(cands),
                            "schedule": [list(e) for e in bsched],
                            "timings_ms": _timings_ms(cache, plan, 3), "time_stage_calls": n_timed,
                            "tune_s": tune_s, "collectives": cc.n,
                            "model_collective_launches": want_colls,
                            "max_rel_l2_vs_lossless": max(errs), "forward_many_ms": ms,
                            "model_ms": m_ms, "measured_over_model": ms / m_ms})
            del u3
            torch.cuda.empty_cache()

            # (d) the reference's poison_auto case on the card
            cache = cache_dir / "poisoned.json"
            p = ParallelFFT(mesh, SHAPE_QS, ("p0", "p1"), config=PlanConfig(
                method="auto", impl="matmul", exchange_impl="cuda", guard="degrade",
                tuner_cache=str(cache)))
            poisoned = (("pipelined", 2, "complex64", "torch", "stacked"),) * p.n_exchanges
            FaultPlan.poison_cache(cache, p, poisoned)
            clean = ParallelFFT(mesh, SHAPE_QS, ("p0", "p1"),
                                config=PlanConfig(impl="matmul", exchange_impl="cuda")).forward(u)
            with FaultPlan().fail_compile(engine="pipelined"):
                yq, rep = p.forward(u)
            disk = tuner.load_cache(cache)
            quarantines = [e.get("quarantines") for e in disk.values()
                           if isinstance(e, dict) and e.get("quarantines")]
            kinds = [t["kind"] for t in rep.transitions]
            err = rel_l2(torch, yq, clean)
            if not rep.ok or "retune" not in kinds or quarantines != [1] or err > TOL_FWD["complex64"]:
                fail(f"tune poison: ok={rep.ok} transitions={kinds} quarantines={quarantines} "
                     f"rel L2 {err}")
            records.append({"case": "poison_auto", "ok": rep.ok, "transitions": kinds,
                            "quarantines": quarantines, "schedule": [list(e) for e in rep.schedule],
                            "rel_l2_vs_clean": err, "attempts": rep.attempts})
    finally:
        tuner._time_stage = real_time_stage
        shutil.rmtree(cache_dir, ignore_errors=True)


def _serve_wave(torch, srv, waves, grace, window):
    """Submit each wave of fields in turn to ``srv`` (a wave's results are
    awaited before the next is submitted) inside ``window`` (the server's
    launches), then drain the worker; returns the outcomes and the seconds
    to the last result."""
    with window:
        t0 = time.perf_counter()
        outs = []
        for fields in waves:
            futs = [srv.submit(x) for x in fields]
            outs += [f.result(grace=grace) for f in futs]
        secs = time.perf_counter() - t0
        srv.drain()
    return outs, secs


def _serve_record(name, outs, seconds, stats):
    lat = sorted(o.latency_s for o in outs)
    return {"wave": name, "statuses": [o.status for o in outs], "trips": [o.trip for o in outs],
            "retries": [o.retries for o in outs], "batch_sizes": [o.batched for o in outs],
            "latency_p50_s": statistics.median(lat), "latency_max_s": lat[-1],
            "seconds": seconds, "stats": {k: v for k, v in stats.items() if k != "registry"},
            "registry": stats["registry"]}


def serve_path(torch, mesh, records, shapes, served):
    """The spectral server (``repro_torch.serve``) on the 1-rank group: (a)
    a clean wave of 12 float32 fields, alternating 512^3 (K4 tc) and the
    quickstart shape (K4 general), through the bf16 guarded server plan
    (K1 in its guard mode, K3, K4), coalesced up to 4, each served value
    bitwise equal to the plan's own forward of that field and within the
    bf16 limit of ``torch.fft.fftn``; then the time of one coalesced group
    of 4 x 512^3 beside ``forward_many_padded`` and the guarded executor of
    the same stack; (b) a strict bf16 plan under a bf16 wire fault: the
    breaker trips and every request is served, degraded, through the
    lossless fallback; (c) a crash after a stall: one retry; (d) overload:
    a queue of 2 sheds at once; (e) an auto plan (quickstart, int8 budget)
    whose cache is torn mid-flight under a 2x burst: every request resolves
    and the cache is rebuilt.  ``served`` gets the launches the server made
    while it served the waves and the group, ``shapes`` its K1, K3 and K4
    launches by the arguments of each call (``_ServerLaunches``); the
    group's dispatches on warm plans alone must launch K1 in its guard
    mode, K3 and both designs of K4."""
    from repro_torch.core import tuner
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.robustness import FaultPlan, faults
    from repro_torch.serve import ServeConfig, SpectralServer

    grid = ("p0", "p1")
    cfg = PlanConfig(method="fused", impl="matmul", exchange_impl="cuda", comm_dtype="bf16",
                     guard="degrade")
    gen = torch.Generator(device="cuda").manual_seed(31)
    cache_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))

    def window(*more):
        return _ServerLaunches(torch, shapes, served, *more)

    try:
        # (a) the clean wave
        fields = [torch.randn(SERVE_SHAPES[i % len(SERVE_SHAPES)], device="cuda",
                              generator=gen) for i in range(SERVE_REQUESTS)]
        sc = ServeConfig(deadline_s=120.0, max_batch=SERVE_MAX_BATCH)
        with SpectralServer(mesh, grid, plan_config=cfg, config=sc) as srv:
            outs, secs = _serve_wave(torch, srv, [fields], sc.grace_s, window())
            stats = srv.stats()
            if [o.status for o in outs] != ["ok"] * len(outs) or stats["coalesced_batches"] < 1:
                fail(f"serve clean: {[o.status for o in outs]}, {stats['coalesced_batches']} "
                     f"coalesced batches")
            rec = _serve_record("clean", outs, secs, stats)
            errs, bitwise = [], []
            for x, o in zip(fields, outs):
                _, plan = srv.registry.get(tuple(x.shape))
                y, _ = plan.forward(x)
                bitwise.append(torch.equal(o.value, y))
                errs.append(rel_l2(torch, o.value, torch.fft.fftn(x)))
                del y
            if not all(bitwise) or max(errs) > TOL_FWD["bf16"]:
                fail(f"serve clean: bitwise equal to the plan's forward {bitwise}, "
                     f"rel L2 vs fftn {errs} (<= {TOL_FWD['bf16']})")
            rec.update(bitwise_equal_plan_forward=bitwise, rel_l2_vs_fftn=errs)
            records.append(rec)
            del outs, fields
            torch.cuda.empty_cache()

            # one coalesced group of 4 x 512^3, held behind a stalled
            # quickstart request so that the four queue together; the
            # group's time runs from the blocker's resolve to the last
            # of the four's (monotonic clock), SERVE_GROUP_REPS times
            group = [torch.randn(SHAPE_BIG, device="cuda", generator=gen)
                     for _ in range(SERVE_MAX_BATCH)]
            blocker_x = torch.randn(SHAPE_QS, device="cuda", generator=gen)
            group_ms, dispatch = [], {}
            for _ in range(SERVE_GROUP_REPS):
                with FaultPlan().slow_collective(seconds=0.3, times=1), window(dispatch):
                    blocker = srv.submit(blocker_x)
                    futs = [srv.submit(x) for x in group]
                    b = blocker.result()
                    outs = [f.result() for f in futs]
                    srv.drain()
                if [o.batched for o in outs] != [SERVE_MAX_BATCH] * SERVE_MAX_BATCH or any(
                        o.status != "ok" for o in outs + [b]):
                    fail(f"serve group: batched {[o.batched for o in outs]}, statuses "
                         f"{[o.status for o in outs + [b]]}")
                done = max(f.submitted + o.latency_s for f, o in zip(futs, outs))
                group_ms.append((done - blocker.submitted - b.latency_s) * 1e3)
                del outs
            # the dispatches of warm plans (the blocker's quickstart, the
            # group's 512^3) alone launch every kernel of the path
            k4 = {k.split(":")[0] for k, v in dispatch.items()
                  if k.startswith(("tc:", "general:")) and v}
            if (k4 != {"tc", "general"} or min(
                    sum(v for k, v in dispatch.items() if k.startswith(pre) and k.endswith(end))
                    for pre, end in (("pack_chunks:", ":guard"), ("unpack_chunks:", ""))) < 1):
                fail(f"serve group: the dispatches' launches {dispatch}: want K1 guard mode, "
                     f"K3 and K4 tc and general each >= 1")
            _, plan = srv.registry.get(SHAPE_BIG)
            stack = torch.stack(group).to(torch.complex64)
            del group
            many = plan.forward_many_padded(SERVE_MAX_BATCH)
            guarded = plan.guarded_padded("forward", nfields=SERVE_MAX_BATCH)
            apply_ms = []
            for _ in range(SERVE_GROUP_REPS):
                t0 = time.perf_counter()
                plan._apply_many(stack, "forward")
                torch.cuda.synchronize()
                apply_ms.append((time.perf_counter() - t0) * 1e3)
            records.append({"wave": "group_4x512", "nfields": SERVE_MAX_BATCH,
                            "shape": list(SHAPE_BIG),
                            "server_group_ms": statistics.median(group_ms),
                            "server_group_ms_runs": group_ms,
                            "apply_many_ms": statistics.median(apply_ms),
                            "apply_many_ms_runs": apply_ms,
                            "guarded_padded_ms": cuda_ms(torch, lambda: guarded(stack)),
                            "forward_many_padded_ms": cuda_ms(torch, lambda: many(stack)),
                            "stack_ms": cuda_ms(torch, lambda: stack.clone()),
                            "dispatch_launches": dispatch})
            del stack, many, guarded
        torch.cuda.empty_cache()

        # (b) the breaker: a strict bf16 plan under a bf16 wire fault
        x = torch.randn(SHAPE_QS, device="cuda", generator=gen)
        want = torch.fft.fftn(x)
        sc = ServeConfig(deadline_s=120.0, breaker_threshold=2, breaker_cooldown_s=60.0,
                         max_retries=0, grace_s=5.0)
        with FaultPlan().corrupt_wire(codec="bf16"):
            with SpectralServer(mesh, grid, plan_config=cfg.replace(guard="strict"),
                                config=sc) as srv:
                outs, secs = _serve_wave(torch, srv, [[x]] * 4, sc.grace_s, window())
                stats = srv.stats()
        errs = [rel_l2(torch, o.value, want) for o in outs if o.value is not None]
        trips = [o.trip for o in outs]
        if ([o.status for o in outs] != ["degraded"] * 4 or trips[0] != "guard-error"
                or set(trips[2:]) != {"circuit-open"} or len(errs) != 4
                or max(errs) > TOL_FWD["complex64"]):
            fail(f"serve breaker: {[o.status for o in outs]} trips {trips} rel L2 {errs}")
        records.append({**_serve_record("breaker", outs, secs, stats), "rel_l2_vs_fftn": errs})

        # (c) a crash after a stall: one retry recovers
        with FaultPlan().executor_crash(times=1).slow_collective(seconds=0.05, times=2):
            with SpectralServer(mesh, grid, plan_config=cfg,
                                config=ServeConfig(deadline_s=120.0,
                                                   backoff_base_s=0.01)) as srv:
                outs, secs = _serve_wave(torch, srv, [[x]], 0.25, window())
                stats = srv.stats()
        if [o.status for o in outs] != ["ok"] or outs[0].retries != 1:
            fail(f"serve transient: {[o.status for o in outs]} retries {outs[0].retries}")
        records.append(_serve_record("transient", outs, secs, stats))

        # (d) overload: a queue of 2 while each dispatch stalls
        with FaultPlan().slow_collective(seconds=0.2, times=100):
            with SpectralServer(mesh, grid, plan_config=cfg,
                                config=ServeConfig(deadline_s=120.0, max_queue=2,
                                                   max_batch=1)) as srv:
                outs, secs = _serve_wave(torch, srv, [[x] * 8], 0.25, window())
                stats = srv.stats()
        shed = [o.latency_s for o in outs if o.status == "shed"]
        if not shed or max(shed) >= 0.1 or any(o.status not in ("ok", "shed") for o in outs):
            fail(f"serve overload: {[o.status for o in outs]}, shed latencies {shed}")
        records.append(_serve_record("overload", outs, secs, stats))

        # (e) an auto plan whose cache is torn mid-flight, under a 2x burst
        cache = cache_dir / "serve.json"
        auto = PlanConfig(method="auto", impl="matmul", exchange_impl="cuda",
                          comm_dtype="int8", guard="degrade", tuner_cache=str(cache))
        xs = [torch.randn(SHAPE_QS, device="cuda", generator=gen) for _ in range(6)]
        with FaultPlan().cache_corruption(mode="garbage").request_burst(factor=2):
            n = 3 * faults.serve_burst()
            # groups of at most 2: the plan sweeps at 1 and 2 fields
            with SpectralServer(mesh, grid, plan_config=auto,
                                config=ServeConfig(deadline_s=120.0, max_batch=2)) as srv:
                outs, secs = _serve_wave(torch, srv, [xs[:n]], 0.25, window())
                stats = srv.stats()
        disk = tuner.load_cache(cache)
        # every request resolves, served: an ``error`` (a kernel that failed
        # to build or launch ends there) or a missed deadline fails the run
        if (len(outs) != 6 or any(o.status not in ("ok", "degraded") for o in outs)
                or not disk):
            fail(f"serve cache corruption: {[o.status for o in outs]}, cache entries "
                 f"{len(disk)}")
        records.append({**_serve_record("cache_corruption", outs, secs, stats),
                        "cache_entries": len(disk)})
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def lm_path(torch, info):
    """GLM-4-9B served through ``serve_lm.main`` (one warm-up round, then a
    timed prefill and 32 decode steps), then on the same weights: the K6
    launches of one prefill and of each decode step, the prefill against the
    same prefill with the plain attention, and 3 teacher-forced decode steps
    against a prefill of S + 3 tokens.  Fills ``info`` for the breakdown."""
    from repro_torch.kernels.flash import ops as flops, ref as flref
    from repro_torch.launch import serve_lm

    def k6():
        return sum(flops.launches.values())

    torch.cuda.reset_peak_memory_stats()
    res = serve_lm.main(LM_ARGV)
    peak = torch.cuda.max_memory_allocated()
    lm, prompts = res.lm, res.prompts
    B, S = prompts.shape
    L, n_gen = lm.cfg.n_layers, res.ids.shape[1] - 1
    if k6() != 2 * L:  # the warm-up and the timed prefill; decode launches none
        fail(f"lm: serve_lm launched K6 {k6()} times, want {2 * L} (two prefills)")

    extra = res.ids[:, :3].to(prompts.device)  # the first three generated ids
    c0 = k6()
    cache, lg = lm.prefill({"tokens": prompts}, max_len=S + 3)
    per_prefill = k6() - c0
    lg_prefill = lg[:, 0]
    per_decode = []
    for t in range(3):
        c0 = k6()
        cache, lg_dec = lm.decode_step(cache, extra[:, t], S + t)
        per_decode.append(k6() - c0)
    del cache
    lg_full = lm.prefill({"tokens": torch.cat([prompts, extra], 1)})[1][:, 0]
    lm._serving_causal = lambda q, k, v: flref.attention_gqa_ref(q, k, v, causal=True)
    try:
        lg_plain = lm.prefill({"tokens": prompts})[1][:, 0]
    finally:
        del lm._serving_causal
    if per_prefill != L or any(per_decode):
        fail(f"lm: K6 launches per prefill {per_prefill} (want {L}), per decode step "
             f"{per_decode} (want 0)")
    if dict(flops.design_launches) != {"tc:bfloat16": k6()}:
        fail(f"lm: K6 launches by design {dict(flops.design_launches)}, want all "
             f"{k6()} on the tensor-core design")
    finite = bool(torch.isfinite(lg_prefill).all() and torch.isfinite(lg_dec).all())
    rel_plain, rel_dec = rel_l2(torch, lg_prefill, lg_plain), rel_l2(torch, lg_dec, lg_full)
    agree_plain = float((lg_prefill.argmax(-1) == lg_plain.argmax(-1)).float().mean())
    agree_dec = float((lg_dec.argmax(-1) == lg_full.argmax(-1)).float().mean())
    cfg = lm.cfg
    out = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab, "dtype": cfg.dtype, "params": sum(p.numel() for p in lm.parameters()),
           "batch": B, "prompt_len": S, "gen": n_gen,
           "prefill_ms": res.prefill_s * 1e3, "prefill_tok_s": B * S / res.prefill_s,
           "decode_ms_per_step": res.decode_s * 1e3 / n_gen,
           "decode_tok_s": B * n_gen / res.decode_s,
           "max_memory_allocated_gib": peak / 2**30, "ids": res.ids[0][:12].tolist(),
           "k6_launches_per_prefill": per_prefill, "k6_launches_per_decode_step": per_decode,
           "rel_l2_k6_vs_plain_prefill": rel_plain, "limit": TOL_LM,
           "argmax_agree_k6_vs_plain": agree_plain,
           "rel_l2_teacher_forced_decode_vs_prefill": rel_dec,
           "argmax_agree_teacher_forced": agree_dec, "finite": finite}
    print(json.dumps({"lm": out}))
    if not finite or rel_plain > TOL_LM or rel_dec > TOL_LM:
        fail(f"lm: finite {finite}, rel L2 K6 vs plain prefill {rel_plain}, teacher-forced "
             f"decode vs prefill {rel_dec} (limit {TOL_LM})")
    info.update(out, **_serving_bounds(lm, B, S, n_gen))
    del lg, lg_dec, lg_full, lg_plain, lg_prefill
    _profile_serving(torch, lm, prompts, res.ids, info)
    del res, lm, prompts


def _profile_serving(torch, lm, prompts, ids, info, frontend=None):
    """Device time of one prefill and of 4 decode steps, by kernel class
    (with the ``frontend`` where the family takes one; the VLM's positions
    after its F)."""
    S = prompts.shape[1] + (frontend.shape[1] if lm.cfg.family == "vlm" else 0)
    n_gen = ids.shape[1] - 1
    batch = {"tokens": prompts} if frontend is None else {"tokens": prompts,
                                                          "frontend": frontend}
    info["prefill_device"] = _device_time(torch, lambda: lm.prefill(batch, max_len=S + n_gen))
    cache = lm.prefill(batch, max_len=S + n_gen)[0]
    tok = ids[:, 0].to(prompts.device)
    info["decode_device_4_steps"] = _device_time(
        torch, lambda: [lm.decode_step(cache, tok, S + t) for t in range(4)])


def _bytes(params):
    return sum(p.numel() * p.element_size() for p in params)


def _serving_bounds(lm, B, S, n_gen):
    """What a prefill of B x S tokens and a decode step must move and
    compute: a decode step reads every weight once (every expert's: the
    decode path runs them all; of an untied embedding only B rows; the
    hybrid's shared block once a group, since its 183.5 MB do not stay in
    the 50 MB L2; of the audio family the decoder's alone) and the valid
    cache at its last step (an SSM's states, read and written; the audio
    decoder's cross keys and values of S frames beside its own); a prefill
    reads every weight once (and the audio family's B x S bf16 frames),
    writes its cache (an SSM's states), and does the operations of
    ``_prefill_flops``.  The VLM's S counts its frontend positions."""
    cfg = lm.cfg
    param_bytes = _bytes(lm.parameters())
    step_weight_bytes = param_bytes if cfg.tie_embeddings else (
        param_bytes - (lm.embed.shape[0] - B) * lm.embed.shape[1] * lm.embed.element_size())
    if cfg.family == "audio":
        el = lm.embed.element_size()
        kv = len(lm.dec_blocks) * B * 2 * cfg.n_kv_heads * lm.head_dim * el  # a position
        enc = _bytes(lm.enc_blocks.parameters()) + _bytes(lm.enc_norm.parameters())
        return {"step_weight_bytes": step_weight_bytes - enc, "kv_bytes": kv * (S + n_gen),
                "cross_kv_bytes": kv * S, "cache_bytes": kv * (S + n_gen) + kv * S,
                "prefill_bytes": param_bytes + B * S * cfg.d_model * 2 + 2 * kv * S,
                "prefill_flops": _prefill_flops(lm, B, S)}
    if cfg.family == "hybrid":  # fp32 ssm (B, H, P, N), conv (B, K-1, di + 2N) a layer
        s, G = cfg.ssm, len(lm.blocks)
        di = s.expand * cfg.d_model
        state = G * cfg.attn_every * B * (di * s.d_state * 4 + (s.d_conv - 1) * (
            di + 2 * s.d_state) * lm.embed.element_size())
        kv = G * B * 2 * cfg.n_kv_heads * lm.head_dim * lm.embed.element_size()
        return {"step_weight_bytes": step_weight_bytes + (G - 1) * _bytes(lm.shared.parameters()),
                "state_bytes": state, "kv_bytes": kv * (S + n_gen),
                "cache_bytes": kv * (S + n_gen) + 2 * state,
                "prefill_bytes": param_bytes + kv * S + state,
                "prefill_flops": _prefill_flops(lm, B, S)}
    if cfg.family == "ssm":  # fp32 ssm (B, Di, N) and conv (B, K-1, Di) a layer
        di = cfg.ssm.expand * cfg.d_model
        state = len(lm.blocks) * B * di * (cfg.ssm.d_state * 4
                                          + (cfg.ssm.d_conv - 1) * lm.embed.element_size())
        return {"step_weight_bytes": step_weight_bytes, "state_bytes": state,
                "cache_bytes": 2 * state, "prefill_bytes": param_bytes + state,
                "prefill_flops": _prefill_flops(lm, B, S)}
    layers = len(lm.dense0) + len(lm.blocks)
    # a token's cache a layer: K and V of every kv head, or MLA's latents
    width = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim if cfg.mla is not None
             else 2 * cfg.n_kv_heads * lm.head_dim)
    kv = layers * B * width * lm.embed.element_size()
    return {"step_weight_bytes": step_weight_bytes, "cache_bytes": kv * (S + n_gen),
            "prefill_bytes": param_bytes + kv * S, "prefill_flops": _prefill_flops(lm, B, S)}


def _prefill_flops(lm, B, S):
    """Operations of one prefill of B x S tokens, two a multiply-add: the
    projections, causal attention over the triangle, each FFN (the experts
    over their whole capacity buffer, as they run, the router and any shared
    experts beside them), the last token's head.  An SSM layer: ``in_proj``,
    ``x_proj``, ``dt_proj`` and ``out_proj`` (the scan's elementwise
    operations, ~0.4 TFLOP of fp32 over the whole prefill, aside).  The
    hybrid: each Mamba2 layer's ``in_proj``, ``out_proj`` and SSD
    contractions (``_ssd_flops``), and the shared block once a group
    (``w_in``, attention, MLP).  The audio family: the encoder's layers
    over S frames (non-causal attention over the whole square), the
    decoder's over S tokens, each with its cross-attention (queries and
    output of the tokens, keys and values of the frames, the S x S
    rectangle).  The VLM's S counts its frontend positions."""
    cfg = lm.cfg
    N, d, dh, H = B * S, cfg.d_model, lm.head_dim, cfg.n_heads
    if cfg.family == "audio":  # S frames and S tokens
        proj = 2 * N * d * dh * 2 * (H + cfg.n_kv_heads)  # q, k, v, o
        mlp = 2 * N * d * cfg.d_ff * (3 if cfg.mlp in ("swiglu", "geglu") else 2)
        enc = proj + 4 * dh * B * H * S * S + mlp
        dec = proj + 4 * dh * B * H * S * (S + 1) / 2 + proj + 4 * dh * B * H * S * S + mlp
        return (len(lm.enc_blocks) * enc + len(lm.dec_blocks) * dec
                + 2 * B * d * lm.embed.shape[0])
    if cfg.family == "ssm":
        p = lm.blocks[0].mamba
        di, dtr, xw = p["D"].shape[0], p["dt_proj"].shape[0], p["x_proj"].shape[1]
        per_layer = 2 * N * (d * 2 * di + di * xw + dtr * di + di * d)
        return len(lm.blocks) * per_layer + 2 * B * d * lm.embed.shape[0]
    mult = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    if cfg.family == "hybrid":
        p = lm.blocks[0][0].mamba
        di = p["norm_w"].shape[0]
        mamba = (2 * N * (d * p["in_proj"].shape[1] + di * d)
                 + _ssd_flops(B, S, di // cfg.ssm.headdim, cfg.ssm.headdim, cfg.ssm.d_state,
                              cfg.ssm.chunk))
        shared = (2 * N * 2 * d * d + 2 * N * d * dh * 2 * (H + cfg.n_kv_heads)
                  + 4 * dh * B * H * S * (S + 1) / 2
                  + 2 * N * d * lm.shared.mlp["w_up"].shape[1] * mult)
        return (len(lm.blocks) * (cfg.attn_every * mamba + shared)
                + 2 * B * d * lm.embed.shape[0])
    if cfg.mla is not None:  # wq, w_dkv, w_uk, w_uv, wo; q.k over dn + dr, p.v over dv
        m = cfg.mla
        dqk = m.qk_nope_dim + m.qk_rope_dim
        attn = (2 * N * (d * H * dqk + d * (m.kv_lora_rank + m.qk_rope_dim)
                         + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
                         + H * m.v_head_dim * d)
                + 2 * (dqk + m.v_head_dim) * B * H * S * (S + 1) / 2)
    else:
        attn = (2 * N * d * dh * 2 * (H + cfg.n_kv_heads)
                + 4 * dh * B * H * S * (S + 1) / 2)

    def ffn(p):
        if not hasattr(p, "moe"):
            return 2 * N * d * p.mlp["w_up"].shape[1] * mult
        m = cfg.moe
        cap = max(1, math.ceil(N * m.top_k * m.capacity_factor / m.n_experts))
        return (2 * N * d * m.n_experts + 2 * m.n_experts * cap * d * m.d_ff_expert * mult
                + 2 * N * d * m.n_shared * m.d_ff_expert * mult)

    return (sum(attn + ffn(p) for p in (*lm.dense0, *lm.blocks))
            + 2 * B * d * lm.embed.shape[0])


def _ssd_flops(B, T, H, Pd, N, chunk):
    """Operations of ``ssd_scan``'s contractions over B x T (T padded to a
    multiple of the chunk Lc), per chunk: C B^T (B Lc Lc N), the masked
    (Lc, Lc) product with x dt (B H Lc Lc P), the inter-chunk term and the
    state update (B Lc H P N each); two a multiply-add."""
    Lc = min(chunk, T)
    return -(-T // Lc) * 2 * B * (Lc * Lc * N + H * Lc * Lc * Pd + 2 * Lc * H * Pd * N)


def moe_path(torch, info, handoff=None):
    """Phi-3.5-MoE, 28 of its 32 layers at full width, served through
    ``serve_lm.serve`` (one warm-up round, then a timed prefill and 32
    decode steps), then on the same weights: the K6 launches of one prefill
    and of each decode step; the dropped share of assignments per layer of a
    prefill of the same prompts (the timed one's function: the dispatch is
    deterministic); a second prefill bitwise equal to it.  Then, at a
    capacity that drops nothing (a decode step never drops): the prefill
    against the same prefill with the plain attention, and 3 teacher-forced
    decode steps against a prefill of S + 3 tokens.  Routing is a step
    function of the router's margins, and at this depth with random weights
    a rounding apart moves some of them across: each pair is compared once
    as it routes itself, with its expert choices that differ counted, and
    once with the second run's choices pinned to the first's (gated by its
    own probabilities), which is the comparison held to the limit.  Fills
    ``info``; puts the model, the prompts and the served ids in ``handoff``
    where one is given (the parallel path's)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash import ops as flops
    from repro_torch.launch import serve_lm
    from repro_torch.models import moe
    from repro_torch.models.lm import LM, OPTIMIZED

    def k6():
        return sum(flops.launches.values())

    cfg = dataclasses.replace(configs.get(MOE_ARCH), n_layers=MOE_LAYERS)
    mcfg = cfg.moe
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, q_block=512, perf=OPTIMIZED, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s, weights = time.perf_counter() - t0, torch.cuda.memory_allocated()
    prompts = serve_lm.make_prompts(cfg.vocab, MOE_BATCH, MOE_PROMPT, "cuda", 0)
    moe.assignments.clear()
    res = serve_lm.serve(lm, prompts, MOE_GEN)
    peak = torch.cuda.max_memory_allocated()
    B, S = prompts.shape
    L, n_gen = cfg.n_layers, res.ids.shape[1] - 1
    served = (moe.assignments["routed"], int(moe.assignments["dropped"]))
    if k6() != 2 * L:  # the warm-up and the timed prefill; decode launches none
        fail(f"moe: serve launched K6 {k6()} times, want {2 * L} (two prefills)")

    cache1, lg1, per_layer, per_prefill, _ = _counted_prefill(torch, lm, prompts, served, "moe")
    routed, dropped = (sum(n for n, _ in per_layer), sum(n for _, n in per_layer))
    bitwise = _prefill_repeats_bitwise(torch, lm, prompts, cache1, lg1)
    del cache1

    extra = res.ids[:, :3].to(prompts.device)  # the first three generated ids
    pc = _pinned_comparisons(torch, lm, prompts, extra)
    per_decode = pc["k6_launches_per_decode_step"]
    if per_prefill != L or any(per_decode):
        fail(f"moe: K6 launches per prefill {per_prefill} (want {L}), per decode step "
             f"{per_decode} (want 0)")
    if dict(flops.design_launches) != {"tc:bfloat16": k6()}:
        fail(f"moe: K6 launches by design {dict(flops.design_launches)}, want all "
             f"{k6()} on the tensor-core design")
    finite = bool(torch.isfinite(lg1).all() and torch.isfinite(pc["decode"]).all())
    out = {"arch": cfg.name, "layers": L, "published_layers": configs.get(MOE_ARCH).n_layers,
           "reduced": f"n_layers {configs.get(MOE_ARCH).n_layers}->{L}: the weights of all "
                      f"layers do not fit the card",
           "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.resolved_head_dim, "n_experts": mcfg.n_experts, "top_k": mcfg.top_k,
           "d_ff_expert": mcfg.d_ff_expert, "capacity_factor": mcfg.capacity_factor,
           "capacity": max(1, math.ceil(B * S * mcfg.top_k * mcfg.capacity_factor
                                        / mcfg.n_experts)),
           "vocab": cfg.vocab, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in lm.parameters()), "weights_gib": weights / 2**30,
           "init_s": init_s, "batch": B, "prompt_len": S, "gen": n_gen,
           "prefill_ms": res.prefill_s * 1e3, "prefill_tok_s": B * S / res.prefill_s,
           "decode_ms_per_step": res.decode_s * 1e3 / n_gen,
           "decode_tok_s": B * n_gen / res.decode_s,
           "max_memory_allocated_gib": peak / 2**30, "ids": res.ids[0][:12].tolist(),
           "k6_launches_per_prefill": per_prefill, "k6_launches_per_decode_step": per_decode,
           "dropped_share": dropped / routed,
           "dropped_share_per_layer": [n / r for r, n in per_layer],
           "two_prefills_bitwise": bitwise, **pc["report"], "finite": finite}
    print(json.dumps({"moe": out}))
    if not (finite and bitwise) or pc["failed"]:
        fail(f"moe: finite {finite}, two prefills bitwise {bitwise}, {pc['failed']}")
    info.update(out, **_serving_bounds(lm, B, S, n_gen))
    del lg1, pc
    _profile_serving(torch, lm, prompts, res.ids, info)
    if handoff is not None:
        handoff.update(lm=lm, prompts=prompts, ids=res.ids)
    del res, lm, prompts


def parallel_path(torch, moe_info, handoff):
    """The moe path's Phi-3.5-MoE (28 layers, full width) on the 1-rank NCCL
    group through ``make_host_mesh(1)``: ``LM.sharded`` holds the very
    tensors (two copies of the weights would not fit the card).  Served
    through ``serve_lm.serve`` with the moe path's traffic (one warm-up
    round, then a timed prefill and 32 decode steps; times beside the moe
    path's), then a greedy run of the mesh-less LM and one of the sharded
    LM on the same prompts: K6 exactly once a layer per prefill and never in
    decode, each call's collectives by kind ``LM.collectives_per_call``'s
    (the mesh-less LM's none), and logits, ids and every cache leaf bitwise
    equal; the sharded run's ids are the served ones.  Then 4 decode steps
    of each LM timed, interleaved twice (host clock), and the sharded LM's
    device time of 4 steps by class (NCCL's kernels apart), each LM's host
    operations of 2 steps by their own CPU time, and one
    all-reduce and one all-gather of a decode step's (B, 1, D) alone, each
    timed over 200 calls beside the all-reduce's casts."""
    from collections import Counter

    from repro_torch.kernels.flash import ops as flops
    from repro_torch.launch import serve_lm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding

    def k6():
        return sum(flops.launches.values())

    lm, prompts, moe_ids = handoff.pop("lm"), handoff.pop("prompts"), handoff.pop("ids")
    B, S = prompts.shape
    L, V = len(lm.blocks), lm.cfg.vocab
    par = lm.sharded(make_host_mesh(1))
    shares = all(a.data_ptr() == b.data_ptr() for a, b in zip(lm.parameters(), par.parameters()))
    torch.cuda.reset_peak_memory_stats()
    sharding.collectives.clear()
    c0 = k6()
    res = serve_lm.serve(par, prompts, MOE_GEN)
    peak = torch.cuda.max_memory_allocated()
    served = Counter(sharding.collectives)
    per_prefill, per_step = par.collectives_per_call(B, S), par.collectives_per_call(B)
    want_served = Counter({k: 2 * (per_prefill[k] + MOE_GEN * per_step[k])
                           for k in per_prefill | per_step})
    served_k6 = k6() - c0

    def greedy(m):
        sharding.collectives.clear()
        c0 = k6()
        cache, lg = m.prefill({"tokens": prompts}, max_len=S + MOE_GEN)
        counts, k6s = [Counter(sharding.collectives)], [k6() - c0]
        logits, tok = [lg[:, -1]], lg[:, -1, :V].argmax(-1)
        ids = [tok]
        for step in range(MOE_GEN):
            sharding.collectives.clear()
            c0 = k6()
            cache, lg = m.decode_step(cache, tok, S + step)
            counts.append(Counter(sharding.collectives))
            k6s.append(k6() - c0)
            tok = lg[:, :V].argmax(-1)
            logits.append(lg)
            ids.append(tok)
        return cache, torch.stack(logits), torch.stack(ids, 1), counts, k6s

    c_a, lg_a, ids_a, counts_a, k6_a = greedy(lm)
    c_b, lg_b, ids_b, counts_b, k6_b = greedy(par)
    bitwise = {"logits": torch.equal(lg_a, lg_b), "ids": torch.equal(ids_a, ids_b),
               "cache": all(torch.equal(c_a[g][k], c_b[g][k]) for g in c_a for k in c_a[g])}

    def steps(m, cache, n=4):  # n decode steps over the run's cache, its last positions rewritten
        return [m.decode_step(cache, ids_a[:, t], S + MOE_GEN - n + t) for t in range(n)]

    walls = {"meshless": [], "sharded": []}
    for _ in range(2):  # interleaved: the host's speed drifts
        for name, m, cache in (("sharded", par, c_b), ("meshless", lm, c_a)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(m, cache)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3 / 4)
    device = _device_time(torch, lambda: steps(par, c_b))
    host = {"sharded": _host_top(torch, lambda: steps(par, c_b, 2)),
            "meshless": _host_top(torch, lambda: steps(lm, c_a, 2))}
    del c_a, c_b
    # one collective of a decode step's size alone, host clock over 200 calls
    x = torch.ones((B, 1, lm.cfg.d_model), dtype=lm.dtype, device=lm.device)

    def per_call_ms(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    call_ms = {"all_reduce": per_call_ms(lambda: par.shard.reduce(x)),
               "all_gather": per_call_ms(lambda: par.shard.gather(x, dim=2)),
               "casts_alone": per_call_ms(lambda: x.float().contiguous().to(x.dtype))}
    ids_b = ids_b.cpu()
    collectives_ok = (served == want_served and counts_a == [Counter()] * (MOE_GEN + 1)
                      and counts_b == [per_prefill] + [per_step] * MOE_GEN)
    k6_ok = (served_k6 == 2 * L and k6_a == k6_b == [L] + [0] * MOE_GEN)
    out = {"arch": lm.cfg.name, "layers": L, "mesh": {"data": 1, "model": 1},
           "shares_tensors": shares, "batch": B, "prompt_len": S, "gen": MOE_GEN,
           "prefill_ms": res.prefill_s * 1e3, "decode_ms_per_step": res.decode_s * 1e3 / MOE_GEN,
           "moe_prefill_ms": moe_info["prefill_ms"],
           "moe_decode_ms_per_step": moe_info["decode_ms_per_step"],
           "max_memory_allocated_gib": peak / 2**30,
           "collectives_per_prefill": dict(per_prefill), "collectives_per_decode_step":
               dict(per_step), "collectives_served": dict(served),
           "k6_launches_per_prefill": k6_b[0], "k6_launches_per_decode_step": max(k6_b[1:]),
           "bitwise_vs_meshless": bitwise,
           "decode_step_wall_ms_interleaved": walls,
           "decode_device_4_steps": device,
           "one_collective_ms": call_ms,
           "host_top_2_steps": host,
           "moe_decode_device_4_steps": moe_info.get("decode_device_4_steps"),
           "served_ids_are_the_moe_paths": torch.equal(res.ids, moe_ids),
           "served_ids_are_the_greedy_runs": torch.equal(res.ids, ids_b),
           "ids": res.ids[0][:12].tolist()}
    print(json.dumps({"parallel": out}))
    if not (shares and all(bitwise.values()) and collectives_ok and k6_ok
            and out["served_ids_are_the_greedy_runs"]):
        fail(f"parallel: shares tensors {shares}, bitwise {bitwise}, collectives served "
             f"{dict(served)} (want {dict(want_served)}), per call {counts_b[:2]} (want "
             f"{per_prefill}, {per_step}), K6 served {served_k6}, per call {k6_a[:2]} / "
             f"{k6_b[:2]}, served ids = greedy {out['served_ids_are_the_greedy_runs']}")


def _leaves(cache) -> dict:
    """A cache's leaves by path (``blocks.k``, ``dense0.ckv``, ``ck``, ...)."""
    out = {}
    for key, t in cache.items():
        if isinstance(t, dict):
            out.update({f"{key}.{k}": v for k, v in t.items()})
        else:
            out[key] = t
    return out


def twin_path(torch, name, lm, prompts, frontend=None):
    """A path's mesh-less ``lm`` (the card's only copy of its weights)
    beside its one-rank twin: ``LM.sharded`` on a 1-rank NCCL group through
    ``make_host_mesh(1)``, which holds the very tensors.  A greedy run of
    each on ``prompts`` (and the ``frontend``): a prefill of max_len F + S +
    ``TWIN_STEPS``, MLA's expanded decode step (``absorbed=False``) on a copy
    of the prefill's cache, then ``TWIN_STEPS`` decode steps; the mesh-less
    run's logits, ids and cache go to the host and its cache is freed before
    the twin's prefill (two of LLaVA's caches would not fit beside its
    weights).  Checks K6 once a causal layer per prefill (the hybrid's
    shared block once a group; the SSM has none) and never in decode, each
    launch on the tensor-core design, each call's collectives by kind
    against ``LM.collectives_per_call`` (the mesh-less LM's none), and
    logits, ids, every cache leaf and the expanded step's logits bitwise
    equal.  Prints one ``{"<name>_parallel": ...}`` line."""
    from collections import Counter

    from repro_torch.kernels.flash import ops as flops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding

    cfg, (B, S) = lm.cfg, prompts.shape
    F = frontend.shape[1] if cfg.family == "vlm" else 0
    # L: K6's causal layers
    L = (0 if cfg.family == "ssm" else cfg.n_layers // cfg.attn_every
         if cfg.family == "hybrid" else cfg.n_layers)
    V, mla = cfg.vocab, cfg.mla is not None
    batch = {"tokens": prompts} if frontend is None else {"tokens": prompts,
                                                          "frontend": frontend}

    def greedy(m):
        counts, k6s = [], []

        def call(fn, *args, **kw):
            sharding.collectives.clear()
            c0 = sum(flops.launches.values())
            out = fn(*args, **kw)
            counts.append(Counter(sharding.collectives))
            k6s.append(sum(flops.launches.values()) - c0)
            return out

        cache, lg = call(m.prefill, batch, max_len=F + S + TWIN_STEPS)
        tok = lg[:, -1, :V].argmax(-1)
        expanded = None
        if mla:
            spare = {g: {k: t.clone() for k, t in c.items()} for g, c in cache.items()}
            expanded = call(m.decode_step, spare, tok, F + S, absorbed=False)[1].cpu()
            del spare
        logits, ids = [lg[:, -1].cpu()], [tok.cpu()]
        for step in range(TWIN_STEPS):
            cache, lg = call(m.decode_step, cache, tok, F + S + step)
            tok = lg[:, :V].argmax(-1)
            logits.append(lg.cpu())
            ids.append(tok.cpu())
        host = {k: t.cpu() for k, t in _leaves(cache).items()}
        del cache, lg
        torch.cuda.empty_cache()
        return torch.stack(logits), torch.stack(ids, 1), expanded, host, counts, k6s

    t0 = time.perf_counter()
    designs0 = Counter(flops.design_launches)
    lg_a, ids_a, exp_a, cache_a, counts_a, k6_a = greedy(lm)
    with _nccl_world_one():
        par = lm.sharded(make_host_mesh(1))
        shares = all(a.data_ptr() == b.data_ptr()
                     for a, b in zip(lm.parameters(), par.parameters()))
        torch.cuda.reset_peak_memory_stats()
        lg_b, ids_b, exp_b, cache_b, counts_b, k6_b = greedy(par)
        peak = torch.cuda.max_memory_allocated()
        want = ([par.collectives_per_call(B, F + S)]
                + [par.collectives_per_call(B, absorbed=False)] * mla
                + [par.collectives_per_call(B)] * TWIN_STEPS)
        del par
    designs = dict(Counter(flops.design_launches) - designs0)
    bitwise = {"logits": torch.equal(lg_a, lg_b), "ids": torch.equal(ids_a, ids_b),
               "cache": set(cache_a) == set(cache_b) and all(
                   torch.equal(cache_a[k], cache_b[k]) for k in cache_a)}
    if mla:
        bitwise["expanded_step"] = torch.equal(exp_a, exp_b)
    want_k6 = [L] + [0] * (len(want) - 1)
    collectives_ok = counts_b == want and counts_a == [Counter()] * len(want)
    k6_ok = k6_a == k6_b == want_k6 and all(k.startswith("tc:") for k in designs)
    out = {"arch": cfg.name, "mesh": {"data": 1, "model": 1}, "shares_tensors": shares,
           "batch": B, "prompt_len": S, "frontend_positions": F, "steps": TWIN_STEPS,
           "calls": ["prefill"] + ["expanded_step"] * mla + ["decode_step"] * TWIN_STEPS,
           "collectives_by_call": [dict(c) for c in counts_b],
           "collectives_per_call": [dict(c) for c in want],
           "k6_launches_by_call": k6_b, "k6_designs": designs,
           "bitwise_vs_meshless": bitwise,
           "cache": {k: list(t.shape) for k, t in cache_b.items()},
           "max_memory_allocated_gib": peak / 2**30, "seconds": time.perf_counter() - t0,
           "ids": ids_b[0].tolist()}
    print(json.dumps({f"{name}_parallel": out}))
    if not (shares and all(bitwise.values()) and collectives_ok and k6_ok):
        fail(f"{name}_parallel: shares tensors {shares}, bitwise {bitwise}, collectives "
             f"{[dict(c) for c in counts_b]} (want {[dict(c) for c in want]}; mesh-less "
             f"{[dict(c) for c in counts_a]}), K6 by call {k6_a} / {k6_b} (want {want_k6}), "
             f"K6 designs {designs} (want tc)")


def mla_path(torch, info):
    """DeepSeek-V2-Lite whole (27 layers at full width: MLA, 64 experts of
    1408, top-6, beside 2 shared, one leading dense block of 10944) served
    through ``serve_lm.main`` with the lm path's traffic (one warm-up round,
    then a timed prefill and 32 decode steps), then on the same weights:
    K6's launches and input shapes in one prefill (one a layer, q and k of
    192, v of 128, all on the tensor-core design) and in each decode step
    (none); the dropped share of assignments per expert layer; a second
    prefill bitwise equal (logits, ``ckv``, ``krope``); the moe path's
    comparisons at capacity N, routing pinned and unpinned
    (``_pinned_comparisons``); one absorbed decode step against the expanded
    one (``absorbed=False``) on copies of one cache, the expanded step's
    routing pinned to the absorbed step's (and unpinned beside it).  Fills
    ``info``; then the model's one-rank twin (``twin_path``)."""
    from repro_torch.kernels.flash import ops as flops
    from repro_torch.launch import serve_lm
    from repro_torch.models import moe

    def k6():
        return sum(flops.launches.values())

    torch.cuda.reset_peak_memory_stats()
    moe.assignments.clear()
    res = serve_lm.main(MLA_ARGV)
    peak = torch.cuda.max_memory_allocated()
    lm, prompts = res.lm, res.prompts
    cfg, mcfg, mla = lm.cfg, lm.cfg.moe, lm.cfg.mla
    B, S = prompts.shape
    L, n_gen = cfg.n_layers, res.ids.shape[1] - 1
    served = (moe.assignments["routed"], int(moe.assignments["dropped"]))
    if k6() != 2 * L:  # the warm-up and the timed prefill; decode launches none
        fail(f"mla: serve_lm launched K6 {k6()} times, want {2 * L} (two prefills)")

    cache1, lg1, per_layer, per_prefill, shapes = _counted_prefill(torch, lm, prompts, served,
                                                                   "mla")
    routed, dropped = (sum(n for n, _ in per_layer), sum(n for _, n in per_layer))
    dqk, H = mla.qk_nope_dim + mla.qk_rope_dim, cfg.n_heads
    want_shapes = [((B, S, H, dqk), (B, S, H, dqk), (B, S, H, mla.v_head_dim))] * L
    if shapes != want_shapes:
        fail(f"mla: K6's shapes in a prefill {sorted(set(shapes))} x {len(shapes)}, want "
             f"{want_shapes[0]} x {L}")
    bitwise = _prefill_repeats_bitwise(torch, lm, prompts, cache1, lg1)
    cache_keys = {g: sorted(c) for g, c in cache1.items()}
    del cache1

    extra = res.ids[:, :3].to(prompts.device)  # the first three generated ids
    pc = _pinned_comparisons(torch, lm, prompts, extra)

    # one decode step in both forms on copies of one cache
    cache, _ = lm.prefill({"tokens": prompts}, max_len=S + 1)
    copies = [{g: {k: v.clone() for k, v in c.items()} for g, c in cache.items()}
              for _ in range(2)]
    c0 = k6()
    (_, lg_abs), ids_abs = _routed_by(torch, moe, lambda: lm.decode_step(cache, extra[:, 0], S))
    (_, lg_exp), ids_exp = _routed_by(torch, moe, lambda: lm.decode_step(
        copies[0], extra[:, 0], S, absorbed=False))
    lg_exp_pinned = _routed_by(torch, moe, lambda: lm.decode_step(
        copies[1], extra[:, 0], S, absorbed=False), ids_abs)[0][1]
    forms_k6 = k6() - c0
    del cache, copies
    rel_forms = rel_l2(torch, lg_abs, lg_exp_pinned)

    per_decode = pc["k6_launches_per_decode_step"]
    if per_prefill != L or any(per_decode) or forms_k6:
        fail(f"mla: K6 launches per prefill {per_prefill} (want {L}), per decode step "
             f"{per_decode} and over both decode forms {forms_k6} (want 0)")
    if dict(flops.design_launches) != {"tc:bfloat16": k6()}:
        fail(f"mla: K6 launches by design {dict(flops.design_launches)}, want all "
             f"{k6()} on the tensor-core design")
    finite = bool(torch.isfinite(lg1).all() and torch.isfinite(pc["decode"]).all()
                  and torch.isfinite(lg_abs).all())
    bounds = _serving_bounds(lm, B, S, n_gen)
    out = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model, "n_heads": H,
           "kv_lora_rank": mla.kv_lora_rank, "qk_nope_dim": mla.qk_nope_dim,
           "qk_rope_dim": mla.qk_rope_dim, "v_head_dim": mla.v_head_dim,
           "n_experts": mcfg.n_experts, "top_k": mcfg.top_k, "n_shared": mcfg.n_shared,
           "d_ff_expert": mcfg.d_ff_expert, "first_k_dense": mcfg.first_k_dense,
           "dense_ff": mcfg.dense_ff, "capacity_factor": mcfg.capacity_factor,
           "capacity": max(1, math.ceil(B * S * mcfg.top_k * mcfg.capacity_factor
                                        / mcfg.n_experts)),
           "vocab": cfg.vocab, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in lm.parameters()),
           "weights_gib": sum(p.numel() * p.element_size() for p in lm.parameters()) / 2**30,
           "batch": B, "prompt_len": S, "gen": n_gen,
           "prefill_ms": res.prefill_s * 1e3, "prefill_tok_s": B * S / res.prefill_s,
           "decode_ms_per_step": res.decode_s * 1e3 / n_gen,
           "decode_tok_s": B * n_gen / res.decode_s,
           "max_memory_allocated_gib": peak / 2**30, "ids": res.ids[0][:12].tolist(),
           "cache": cache_keys, "cache_bytes": bounds["cache_bytes"],
           "k6_launches_per_prefill": per_prefill, "k6_launches_per_decode_step": per_decode,
           "k6_shapes_qkv": [list(t) for t in shapes[0]],
           "dropped_share": dropped / routed,
           "dropped_share_per_layer": [n / r for r, n in per_layer],
           "two_prefills_bitwise": bitwise, **pc["report"],
           "rel_l2_absorbed_vs_expanded_decode": rel_forms,
           "argmax_agree_absorbed_vs_expanded": _agree(lg_abs, lg_exp_pinned),
           "unpinned_absorbed_vs_expanded": {
               "rel_l2": rel_l2(torch, lg_abs, lg_exp), "argmax_agree": _agree(lg_abs, lg_exp),
               "expert_choices_differ": _choices_differ(ids_abs, ids_exp),
               "expert_choices": len(ids_abs) * B},
           "finite": finite}
    print(json.dumps({"mla": out}))
    if not (finite and bitwise) or pc["failed"] or rel_forms > TOL_LM:
        fail(f"mla: finite {finite}, two prefills bitwise {bitwise}, {pc['failed']}; absorbed "
             f"vs expanded decode {rel_forms} (routing pinned; limit {TOL_LM})")
    info.update(out, **bounds)
    del lg1, lg_abs, lg_exp, lg_exp_pinned, pc
    _profile_serving(torch, lm, prompts, res.ids, info)
    twin_path(torch, "mla", lm, prompts)
    del res, lm, prompts


def ssm_path(torch, info):
    """Falcon-Mamba-7B at full width, ``SSM_LAYERS`` of its 64 Mamba1
    layers, served through ``serve_lm.serve`` with the lm path's traffic (one warm-up round, then a
    timed prefill and 32 decode steps), then on the same weights: a second
    prefill bitwise equal (logits, ``ssm``, ``conv``); 3 teacher-forced
    decode steps against a prefill of S + 3 tokens (the last chunk padded),
    logits within ``TOL_LM`` and the final ``ssm`` state's rel. L2 beside
    them; ``_ssm_scan`` (one layer's scan at full width against float64, and
    timed at the prefill's shape); no launch of K1-K6 in the whole path.
    Fills ``info``; then the model's one-rank twin (``twin_path``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve_lm
    from repro_torch.models.lm import LM, OPTIMIZED

    published = configs.get(SSM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    lm = LM(dataclasses.replace(published, n_layers=SSM_LAYERS), q_block=512, perf=OPTIMIZED,
            device="cuda", seed=0)
    res = serve_lm.serve(lm, serve_lm.make_prompts(published.vocab, MOE_BATCH, MOE_PROMPT,
                                                   "cuda", 0), MOE_GEN)
    peak = torch.cuda.max_memory_allocated()
    lm, prompts = res.lm, res.prompts
    cfg, scfg = lm.cfg, lm.cfg.ssm
    B, S = prompts.shape
    L, n_gen = cfg.n_layers, res.ids.shape[1] - 1

    cache, lg1 = lm.prefill({"tokens": prompts})
    cache2, lg2 = lm.prefill({"tokens": prompts})
    bitwise = torch.equal(lg1, lg2) and all(torch.equal(cache[k], cache2[k])
                                            for k in ("ssm", "conv"))
    cache_shapes = {k: list(v.shape) for k, v in cache.items()}
    del cache2, lg2
    extra = res.ids[:, :3].to(prompts.device)  # the first three generated ids
    for t in range(3):
        cache, lg_dec = lm.decode_step(cache, extra[:, t], S + t)
    full, lg_full = lm.prefill({"tokens": torch.cat([prompts, extra], 1)})
    rel_dec = rel_l2(torch, lg_dec, lg_full[:, 0])
    rel_state = rel_l2(torch, cache["ssm"], full["ssm"])
    agree = _agree(lg_dec, lg_full[:, 0])
    finite = bool(torch.isfinite(lg1).all() and torch.isfinite(lg_dec).all())
    del cache, full, lg_full
    scan = _ssm_scan(torch, lm, B, S)
    launched = {k: n for k, n in _count_snapshot().items() if n}

    di = scfg.expand * cfg.d_model
    bounds = _serving_bounds(lm, B, S, n_gen)
    out = {"arch": cfg.name, "layers": L, "published_layers": published.n_layers,
           "reduced": f"n_layers {published.n_layers}->{L}: the run's time (PERF.md §4)",
           "d_model": cfg.d_model, "d_inner": di,
           "d_state": scfg.d_state, "d_conv": scfg.d_conv,
           "dt_rank": lm.blocks[0].mamba["dt_proj"].shape[0], "chunk": scfg.chunk,
           "vocab": cfg.vocab, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in lm.parameters()),
           "weights_gib": sum(p.numel() * p.element_size() for p in lm.parameters()) / 2**30,
           "batch": B, "prompt_len": S, "gen": n_gen,
           "prefill_ms": res.prefill_s * 1e3, "prefill_tok_s": B * S / res.prefill_s,
           "decode_ms_per_step": res.decode_s * 1e3 / n_gen,
           "decode_tok_s": B * n_gen / res.decode_s,
           "max_memory_allocated_gib": peak / 2**30, "ids": res.ids[0][:12].tolist(),
           "cache": cache_shapes, "state_bytes": bounds["state_bytes"],
           "kernel_launches": launched, "two_prefills_bitwise": bitwise,
           "rel_l2_teacher_forced_decode_vs_prefill": rel_dec, "limit": TOL_LM,
           "argmax_agree_teacher_forced": agree,
           "rel_l2_ssm_state_decode_vs_prefill": rel_state, **scan, "finite": finite}
    print(json.dumps({"ssm": out}))
    if launched or not (finite and bitwise and scan["scan_ok"]) or rel_dec > TOL_LM:
        fail(f"ssm: launches {launched} (want none), finite {finite}, two prefills bitwise "
             f"{bitwise}, teacher-forced decode vs prefill {rel_dec} (limit {TOL_LM}), "
             f"scan vs float64 max excess {scan['scan_max_excess']} (limit rtol = atol = "
             f"{TOL_SCAN})")
    info.update(out, **bounds)
    del lg1, lg_dec
    _profile_serving(torch, lm, prompts, res.ids, info)
    twin_path(torch, "ssm", lm, prompts)
    del res, lm, prompts


def _ssm_scan(torch, lm, B, S):
    """One layer's ``selective_scan`` on the card: at ``SSM_SCAN_SHAPE``
    with fp32 inputs in tests/test_ssm.py's ranges (numpy seed 0) against
    the recurrence in float64, step by step, at rtol = atol = ``TOL_SCAN``;
    then timed (``one_call_ms``) at the prefill's shape (B, S and the
    model's d_inner and d_state; x, B and C in the activations' dtype, dt
    fp32, as the model gives them), beside the bytes it must move (x, dt,
    B, C read, y and the state written)."""
    import numpy as np

    from repro_torch.models import ssm

    Bn, T, Di, N = SSM_SCAN_SHAPE
    chunk = lm.cfg.ssm.chunk
    rng = np.random.default_rng(0)
    host = (rng.standard_normal((Bn, T, Di), dtype=np.float32),
            rng.uniform(0.01, 0.2, (Bn, T, Di)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (Di, N)).astype(np.float32),
            rng.standard_normal((Bn, T, N), dtype=np.float32),
            rng.standard_normal((Bn, T, N), dtype=np.float32))
    x, dt, A, Bm, Cm = (torch.from_numpy(a).cuda() for a in host)
    y, h = ssm.selective_scan(x, dt, A, Bm, Cm, chunk=chunk)
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    h64 = torch.zeros((Bn, Di, N), dtype=torch.float64, device="cuda")
    y64 = torch.empty((Bn, T, Di), dtype=torch.float64, device="cuda")
    for t in range(T):
        h64 = (torch.exp(dt[:, t, :, None] * A) * h64
               + dt[:, t, :, None] * Bm[:, t, None, :] * x[:, t, :, None])
        y64[:, t] = (h64 * Cm[:, t, None, :]).sum(-1)
    excess = max(float(((got.double() - want).abs() - TOL_SCAN * (1 + want.abs())).max())
                 for got, want in ((y, y64), (h, h64)))
    rel = rel_l2(torch, y.double(), y64)
    del x, dt, A, Bm, Cm, y, h, h64, y64

    gen = torch.Generator(device="cuda").manual_seed(1)
    act = lm.dtype
    Di, N = lm.blocks[0].mamba["A_log"].shape
    xs = torch.randn((B, S, Di), generator=gen, device="cuda").to(act)
    dts = torch.rand((B, S, Di), generator=gen, device="cuda") * 0.19 + 0.01
    As = -torch.exp(lm.blocks[0].mamba["A_log"])
    Bs, Cs = (torch.randn((B, S, N), generator=gen, device="cuda").to(act) for _ in range(2))
    ms = one_call_ms(torch, lambda: ssm.selective_scan(xs, dts, As, Bs, Cs, chunk=chunk))
    nbytes = (sum(t.numel() * t.element_size() for t in (xs, dts, Bs, Cs))
              + B * S * Di * 4 + B * Di * N * 4)
    del xs, dts, Bs, Cs
    return {"scan_shape_checked": list(SSM_SCAN_SHAPE), "scan_max_excess": excess,
            "scan_ok": excess <= 0, "scan_rel_l2_vs_float64": rel, "scan_limit": TOL_SCAN,
            "scan_prefill_shape": [B, S, Di, N], "scan_ms_per_layer": ms,
            "scan_bytes_per_layer": nbytes, "scan_bound_ms_per_layer": nbytes / HBM_BPS * 1e3}


def _hybrid_leaves(cache):
    """The hybrid cache's leaves by path: the shared block's ``k`` and
    ``v`` a group, and the Mamba2 ``states``."""
    return {"k": cache["k"], "v": cache["v"],
            **{f"states.{k}": v for k, v in cache["states"].items()}}


def hybrid_path(torch, info):
    """Zamba2-2.7B whole (54 Mamba2 layers in 9 groups of 6 at full width,
    the one shared attention+MLP block run once a group) served through
    ``serve_lm.main`` with the lm path's traffic (one warm-up round, then a
    timed prefill and 32 decode steps), then on the same weights: K6's
    launches in one prefill (once a group, all on the tensor-core design)
    and in each decode step (none); a second prefill bitwise equal (logits
    and every cache leaf); 3 teacher-forced decode steps against a prefill
    of S + 3 tokens, logits within ``TOL_LM``, the final ``states.ssm``'s
    rel. L2 beside them; the K6 prefill's logits against the same prefill
    with the plain attention; ``_ssd_scan`` (one layer's scan at full width
    against float64, and timed at the prefill's shape).  Fills ``info``; then
    the model's one-rank twin (``twin_path``)."""
    from repro_torch.kernels.flash import ops as flops, ref as flref
    from repro_torch.launch import serve_lm
    from repro_torch.models.config import param_count

    def k6():
        return sum(flops.launches.values())

    torch.cuda.reset_peak_memory_stats()
    res = serve_lm.main(HYBRID_ARGV)
    peak = torch.cuda.max_memory_allocated()
    lm, prompts = res.lm, res.prompts
    cfg, scfg = lm.cfg, lm.cfg.ssm
    B, S = prompts.shape
    G, n_gen = len(lm.blocks), res.ids.shape[1] - 1
    L = G * cfg.attn_every
    if k6() != 2 * G:  # the warm-up and the timed prefill; decode launches none
        fail(f"hybrid: serve_lm launched K6 {k6()} times, want {2 * G} (two prefills)")

    c0 = k6()
    cache, lg1 = lm.prefill({"tokens": prompts}, max_len=S + 3)
    per_prefill = k6() - c0
    cache2, lg2 = lm.prefill({"tokens": prompts}, max_len=S + 3)
    leaves, leaves2 = _hybrid_leaves(cache), _hybrid_leaves(cache2)
    bitwise = torch.equal(lg1, lg2) and all(torch.equal(leaves[k], leaves2[k]) for k in leaves)
    cache_shapes = {k: list(v.shape) for k, v in leaves.items()}
    del cache2, lg2, leaves2
    extra = res.ids[:, :3].to(prompts.device)  # the first three generated ids
    per_decode = []
    for t in range(3):
        c0 = k6()
        cache, lg_dec = lm.decode_step(cache, extra[:, t], S + t)
        per_decode.append(k6() - c0)
    full, lg_full = lm.prefill({"tokens": torch.cat([prompts, extra], 1)})
    rel_dec = rel_l2(torch, lg_dec, lg_full[:, 0])
    rel_state = rel_l2(torch, cache["states"]["ssm"], full["states"]["ssm"])
    agree_dec = _agree(lg_dec, lg_full[:, 0])
    del cache, full, lg_full, leaves
    lm._serving_causal = lambda q, k, v: flref.attention_gqa_ref(q, k, v, causal=True)
    try:
        lg_plain = lm.prefill({"tokens": prompts})[1][:, 0]
    finally:
        del lm._serving_causal
    rel_plain, agree_plain = rel_l2(torch, lg1[:, 0], lg_plain), _agree(lg1[:, 0], lg_plain)
    if per_prefill != G or any(per_decode):
        fail(f"hybrid: K6 launches per prefill {per_prefill} (want {G}, one a group), per "
             f"decode step {per_decode} (want 0)")
    if dict(flops.design_launches) != {"tc:bfloat16": k6()}:
        fail(f"hybrid: K6 launches by design {dict(flops.design_launches)}, want all "
             f"{k6()} on the tensor-core design")
    finite = bool(torch.isfinite(lg1).all() and torch.isfinite(lg_dec).all())
    scan = _ssd_scan(torch, lm, B, S)

    di = scfg.expand * cfg.d_model
    bounds = _serving_bounds(lm, B, S, n_gen)
    out = {"arch": cfg.name, "layers": L, "groups": G, "layers_a_group": cfg.attn_every,
           "d_model": cfg.d_model, "d_inner": di, "ssm_heads": di // scfg.headdim,
           "ssm_headdim": scfg.headdim, "d_state": scfg.d_state, "d_conv": scfg.d_conv,
           "chunk": scfg.chunk, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "dtype": cfg.dtype, "params": sum(p.numel() for p in lm.parameters()),
           "param_count": param_count(cfg), "weights_gib": _bytes(lm.parameters()) / 2**30,
           "shared_block_bytes": _bytes(lm.shared.parameters()),
           "batch": B, "prompt_len": S, "gen": n_gen,
           "prefill_ms": res.prefill_s * 1e3, "prefill_tok_s": B * S / res.prefill_s,
           "decode_ms_per_step": res.decode_s * 1e3 / n_gen,
           "decode_tok_s": B * n_gen / res.decode_s,
           "max_memory_allocated_gib": peak / 2**30, "ids": res.ids[0][:12].tolist(),
           "cache": cache_shapes, "kv_bytes": bounds["kv_bytes"],
           "state_bytes": bounds["state_bytes"],
           "k6_launches_per_prefill": per_prefill, "k6_launches_per_decode_step": per_decode,
           "two_prefills_bitwise": bitwise, "rel_l2_k6_vs_plain_prefill": rel_plain,
           "argmax_agree_k6_vs_plain": agree_plain,
           "rel_l2_teacher_forced_decode_vs_prefill": rel_dec, "limit": TOL_LM,
           "argmax_agree_teacher_forced": agree_dec,
           "rel_l2_ssm_state_decode_vs_prefill": rel_state, **scan, "finite": finite}
    print(json.dumps({"hybrid": out}))
    if (not (finite and bitwise and scan["scan_ok"]) or rel_plain > TOL_LM
            or rel_dec > TOL_LM):
        fail(f"hybrid: finite {finite}, two prefills bitwise {bitwise}, K6 vs plain prefill "
             f"{rel_plain}, teacher-forced decode vs prefill {rel_dec} (limit {TOL_LM}), scan "
             f"vs float64 max excess {scan['scan_max_excess']} (limit rtol = atol = "
             f"{TOL_SCAN})")
    info.update(out, **bounds)
    del lg1, lg_dec, lg_plain
    _profile_serving(torch, lm, prompts, res.ids, info)
    twin_path(torch, "hybrid", lm, prompts)
    del res, lm, prompts


def frontend_path(torch, info, name, argv):
    """LLaVA-NeXT-34B (``name`` "vlm": 60 layers, 2048 frontend embeddings
    before each prompt) or SeamlessM4T-medium ("audio": 12 encoder and 12
    decoder layers, 2048 frames a prompt) whole, served through
    ``serve_lm.main(argv)`` with the lm path's traffic (one warm-up round,
    then a timed prefill and 32 decode steps), then on the same weights and
    frontend: K6's launches in one prefill (once a causal layer, all on the
    tensor-core design) and in each decode step (none); the audio family's
    second prefill bitwise equal (logits and every cache leaf); 3
    teacher-forced decode steps against a prefill of S + 3 tokens (the VLM's
    positions after its F); the K6 prefill's logits against the same
    prefill with the plain attention, a batch row and kv head at a time (the
    VLM's whole (4 x 56, 4096, 4096) fp32 scores are 15 GB beside 64 GiB of
    weights).  Each cache is freed before the next prefill.  Fills
    ``info``; then the model's one-rank twin (``twin_path``)."""
    from repro_torch.kernels.flash import ops as flops, ref as flref
    from repro_torch.launch import serve_lm
    from repro_torch.models.config import param_count

    def k6():
        return sum(flops.launches.values())

    torch.cuda.reset_peak_memory_stats()
    res = serve_lm.main(argv)
    peak = torch.cuda.max_memory_allocated()
    lm, prompts, frontend = res.lm, res.prompts, res.frontend
    cfg = lm.cfg
    B, S = prompts.shape
    F = frontend.shape[1] if cfg.family == "vlm" else 0
    L, n_gen = cfg.n_layers, res.ids.shape[1] - 1  # the causal layers, K6's
    if k6() != 2 * L:  # the warm-up and the timed prefill; decode launches none
        fail(f"{name}: serve_lm launched K6 {k6()} times, want {2 * L} (two prefills)")

    def prefill(toks, max_len=None):
        return lm.prefill({"tokens": toks, "frontend": frontend}, max_len=max_len)

    def leaves(cache):
        return cache.get("blocks", cache)

    c0 = k6()
    cache, lg1 = prefill(prompts, F + S + 3)
    per_prefill = k6() - c0
    cache_shapes = {k: list(v.shape) for k, v in leaves(cache).items()}
    cache_bytes = sum(v.numel() * v.element_size() for v in leaves(cache).values())
    bitwise = None
    if cfg.family == "audio":  # two caches of LLaVA's would not fit beside its weights
        cache2, lg2 = prefill(prompts, F + S + 3)
        bitwise = torch.equal(lg1, lg2) and all(
            torch.equal(v, leaves(cache2)[k]) for k, v in leaves(cache).items())
        del cache2, lg2
    extra = res.ids[:, :3].to(prompts.device)  # the first three generated ids
    per_decode = []
    for t in range(3):
        c0 = k6()
        cache, lg_dec = lm.decode_step(cache, extra[:, t], F + S + t)
        per_decode.append(k6() - c0)
    del cache
    lg_full = prefill(torch.cat([prompts, extra], 1))[1][:, 0]
    rel_dec, agree_dec = rel_l2(torch, lg_dec, lg_full), _agree(lg_dec, lg_full)
    del lg_full

    def plain(q, k, v):  # a batch row and kv head at a time
        G = q.shape[2] // k.shape[2]
        return torch.cat([torch.cat([flref.attention_gqa_ref(
            q[b:b + 1, :, h * G:(h + 1) * G], k[b:b + 1, :, h:h + 1], v[b:b + 1, :, h:h + 1],
            causal=True) for h in range(k.shape[2])], 2) for b in range(q.shape[0])])

    lm._serving_causal = plain
    try:
        lg_plain = prefill(prompts)[1][:, 0]
    finally:
        del lm._serving_causal
    rel_plain, agree_plain = rel_l2(torch, lg1[:, 0], lg_plain), _agree(lg1[:, 0], lg_plain)
    if per_prefill != L or any(per_decode):
        fail(f"{name}: K6 launches per prefill {per_prefill} (want {L}, one a causal layer), "
             f"per decode step {per_decode} (want 0)")
    if dict(flops.design_launches) != {"tc:bfloat16": k6()}:
        fail(f"{name}: K6 launches by design {dict(flops.design_launches)}, want all "
             f"{k6()} on the tensor-core design")
    finite = bool(torch.isfinite(lg1).all() and torch.isfinite(lg_dec).all())

    bounds = _serving_bounds(lm, B, F + S, n_gen)
    out = {"arch": cfg.name, "family": cfg.family, "layers": L,
           "encoder_layers": cfg.n_encoder_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff, "mlp": cfg.mlp,
           "vocab": cfg.vocab, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in lm.parameters()), "param_count": param_count(cfg),
           "weights_gib": _bytes(lm.parameters()) / 2**30,
           "batch": B, "prompt_len": S, "frontend": list(frontend.shape), "gen": n_gen,
           "prefill_ms": res.prefill_s * 1e3, "prefill_tok_s": B * S / res.prefill_s,
           "decode_ms_per_step": res.decode_s * 1e3 / n_gen,
           "decode_tok_s": B * n_gen / res.decode_s,
           "max_memory_allocated_gib": peak / 2**30, "ids": res.ids[0][:12].tolist(),
           "cache": cache_shapes, "cache_gib_at_s_plus_3": cache_bytes / 2**30,
           "k6_launches_per_prefill": per_prefill, "k6_launches_per_decode_step": per_decode,
           "two_prefills_bitwise": bitwise, "rel_l2_k6_vs_plain_prefill": rel_plain,
           "argmax_agree_k6_vs_plain": agree_plain,
           "rel_l2_teacher_forced_decode_vs_prefill": rel_dec, "limit": TOL_LM,
           "argmax_agree_teacher_forced": agree_dec, "finite": finite}
    print(json.dumps({name: out}))
    if not finite or bitwise is False or rel_plain > TOL_LM or rel_dec > TOL_LM:
        fail(f"{name}: finite {finite}, two prefills bitwise {bitwise}, K6 vs plain prefill "
             f"{rel_plain}, teacher-forced decode vs prefill {rel_dec} (limit {TOL_LM})")
    info.update(out, **bounds)
    del lg1, lg_dec, lg_plain
    _profile_serving(torch, lm, prompts, res.ids, info, frontend)
    twin_path(torch, name, lm, prompts, frontend)
    del res, lm, prompts, frontend


def _ssd_scan(torch, lm, B, S):
    """One layer's ``ssd_scan`` on the card: at ``SSD_SCAN_SHAPE`` with fp32
    inputs in tests/test_ssm.py's ranges (numpy seed 0) against the
    recurrence in float64, step by step, at rtol = atol = ``TOL_SCAN``; then
    timed at the prefill's shape (B, S and the model's heads, headdim and
    d_state; x, B and C in the activations' dtype, dt fp32, as the model
    gives them): its device time (``cuda_ms``: the ~300 small kernels of
    one call queued behind a spin, so the host's enqueue, which alone takes
    longer, is not in it) and one call with the enqueue (``one_call_ms``),
    beside its bound: the bytes it must move (x, dt, B, C read, y and the
    state written) and its contractions' operations (``_ssd_flops``) at the
    fp32 peak, which it runs at."""
    import numpy as np

    from repro_torch.models import ssm

    Bn, T, H, Pd, N = SSD_SCAN_SHAPE
    chunk = lm.cfg.ssm.chunk
    rng = np.random.default_rng(0)
    host = (rng.standard_normal((Bn, T, H, Pd), dtype=np.float32),
            rng.uniform(0.01, 0.3, (Bn, T, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((Bn, T, N), dtype=np.float32),
            rng.standard_normal((Bn, T, N), dtype=np.float32))
    xh, dt, a_log, Bm, Cm = (torch.from_numpy(a).cuda() for a in host)
    y, s = ssm.ssd_scan(xh, dt, a_log, Bm, Cm, chunk=chunk)
    xh, dt, a_log, Bm, Cm = (t.double() for t in (xh, dt, a_log, Bm, Cm))
    s64 = torch.zeros((Bn, H, Pd, N), dtype=torch.float64, device="cuda")
    y64 = torch.empty((Bn, T, H, Pd), dtype=torch.float64, device="cuda")
    for t in range(T):
        s64 = (s64 * torch.exp(dt[:, t] * a_log)[..., None, None]
               + (xh[:, t] * dt[:, t, :, None])[..., None] * Bm[:, t, None, None, :])
        y64[:, t] = (s64 * Cm[:, t, None, None, :]).sum(-1)
    excess = max(float(((got.double() - want).abs() - TOL_SCAN * (1 + want.abs())).max())
                 for got, want in ((y, y64), (s, s64)))
    rel = rel_l2(torch, y.double(), y64)
    del xh, dt, a_log, Bm, Cm, y, s, s64, y64

    gen = torch.Generator(device="cuda").manual_seed(1)
    act, scfg = lm.dtype, lm.cfg.ssm
    H = lm.blocks[0][0].mamba["A_log"].shape[0]
    Pd, N = scfg.headdim, scfg.d_state
    xs = torch.randn((B, S, H, Pd), generator=gen, device="cuda").to(act)
    dts = torch.rand((B, S, H), generator=gen, device="cuda") * 0.29 + 0.01
    a_logs = -torch.exp(lm.blocks[0][0].mamba["A_log"])
    Bs, Cs = (torch.randn((B, S, N), generator=gen, device="cuda").to(act) for _ in range(2))
    scan = lambda: ssm.ssd_scan(xs, dts, a_logs, Bs, Cs, chunk=chunk)
    ms, one_ms = cuda_ms(torch, scan, reps=3), one_call_ms(torch, scan, reps=3)
    nbytes = (sum(t.numel() * t.element_size() for t in (xs, dts, Bs, Cs))
              + B * S * H * Pd * 4 + B * H * Pd * N * 4)
    flop = _ssd_flops(B, S, H, Pd, N, chunk)
    bound, by = bound_ms(nbytes, flop, FP32_FLOPS)
    del xs, dts, Bs, Cs
    return {"scan_shape_checked": list(SSD_SCAN_SHAPE), "scan_max_excess": excess,
            "scan_ok": excess <= 0, "scan_rel_l2_vs_float64": rel, "scan_limit": TOL_SCAN,
            "scan_prefill_shape": [B, S, H, Pd, N], "scan_ms_per_layer": ms,
            "scan_one_call_ms_per_layer": one_ms,
            "scan_bytes_per_layer": nbytes, "scan_flops_per_layer": flop,
            "scan_bound_ms_per_layer": bound, "scan_bound_by": by}


def _counted_prefill(torch, lm, prompts, served, name):
    """An untimed prefill of ``prompts`` (the timed one's function: the
    dispatch is deterministic) with each expert layer's dispatch counted
    around it and K6's launches and (q, k, v) shapes recorded; fails unless
    its dispatches add up to half of ``served`` (serve's two prefills).
    Returns (cache, logits, [(routed, dropped)] an expert layer, K6
    launches, K6's shapes)."""
    from repro_torch.kernels.flash import ops as flops
    from repro_torch.models import moe

    dispatch, kern, per_layer, shapes = moe.moe_apply_capacity, flops.flash_attention, [], []

    def counted(*args, **kw):
        r0, d0 = moe.assignments["routed"], int(moe.assignments["dropped"])
        out = dispatch(*args, **kw)
        per_layer.append((moe.assignments["routed"] - r0, int(moe.assignments["dropped"]) - d0))
        return out

    def shaped(q, k, v, **kw):
        shapes.append(tuple(tuple(t.shape) for t in (q, k, v)))
        return kern(q, k, v, **kw)

    moe.moe_apply_capacity, flops.flash_attention = counted, shaped
    try:
        c0 = sum(flops.launches.values())
        cache, lg = lm.prefill({"tokens": prompts}, max_len=prompts.shape[1])
        launches = sum(flops.launches.values()) - c0
    finally:
        moe.moe_apply_capacity, flops.flash_attention = dispatch, kern
    routed, dropped = (sum(n for n, _ in per_layer), sum(n for _, n in per_layer))
    if len(per_layer) != len(lm.blocks) or 2 * routed != served[0] or 2 * dropped != served[1]:
        fail(f"{name}: {len(per_layer)} dispatches counted {routed} routed, {dropped} dropped; "
             f"serve's two prefills {served}")
    return cache, lg, per_layer, launches, shapes


def _prefill_repeats_bitwise(torch, lm, prompts, cache, lg):
    """Whether a second prefill of ``prompts`` gives ``lg`` and every entry
    of ``cache`` bit for bit."""
    cache2, lg2 = lm.prefill({"tokens": prompts}, max_len=prompts.shape[1])
    return torch.equal(lg, lg2) and all(torch.equal(cache[g][key], cache2[g][key])
                                        for g in cache for key in cache[g])


def _routed_by(torch, moe, fn, pinned=None, key=None):
    """(fn(), the expert ids of each ``moe.route`` call); with ``pinned``, each
    call's ids are taken from that list and gated by the call's own
    probabilities, renormalised.  Calls are told apart by their order, or
    with ``key`` by ``key(router_w)`` (a layer's index), of which the first
    call counts: so the backward's recomputation of a layer finds its own."""
    route, seen = moe.route, {}

    def hook(router_w, x, top_k):
        gates, idx, aux, z = route(router_w, x, top_k)
        i = len(seen) if key is None else key(router_w)
        if pinned is not None:
            idx = pinned[i]
            probs = torch.softmax(x.float() @ router_w.float(), dim=-1).gather(1, idx)
            gates = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
        seen.setdefault(i, idx)
        return gates, idx, aux, z

    moe.route = hook
    try:
        return fn(), [seen[i] for i in sorted(seen)]
    finally:
        moe.route = route


def _choices_differ(a, b):
    """Expert choices (a token's set in one layer) that differ between two
    lists of per-layer ids."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))


def _agree(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def _pinned_comparisons(torch, lm, prompts, extra):
    """The MoE serving paths' numerics, at a capacity of N (E / k: nothing
    dropped, the function a decode step computes): the prefill against the
    same prefill with the plain attention (a batch row at a time), and 3
    teacher-forced decode steps (tokens ``extra``) against a prefill of
    S + 3 tokens.  Routing is a step function of the router's margins, so
    each pair is compared once as it routes itself, with its expert choices
    that differ counted, and once with the second run's choices pinned to
    the first's (``_routed_by``), which is the comparison held to
    ``TOL_LM``.  Returns the decode's logits, its K6 launches per step, the
    report and what failed (empty if nothing)."""
    import dataclasses

    from repro_torch.kernels.flash import ops as flops, ref as flref
    from repro_torch.models import moe

    B, S = prompts.shape
    cfg, mcfg = lm.cfg, lm.cfg.moe

    def routed_by(fn, pinned=None):
        return _routed_by(torch, moe, fn, pinned)

    def plain(q, k, v):  # the plain attention, a batch row at a time
        return torch.cat([flref.attention_gqa_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                                  causal=True) for b in range(q.shape[0])])

    def prefill(toks, max_len=None):
        return lm.prefill({"tokens": toks}, max_len=max_len)

    full_toks = torch.cat([prompts, extra], 1)
    per_step_ids = []

    def decode(pinned=None):
        """3 teacher-forced decode steps after a prefill of S; with
        ``pinned`` (the S + 3 prefill's ids, (B (S + 3), k) a layer), the
        prefill and each step route as the S + 3 prefill did."""
        per_step, logits = [], []
        cache, _ = routed_by(lambda: prefill(prompts, S + 3), pinned and [
            p.view(B, S + 3, -1)[:, :S].reshape(B * S, -1) for p in pinned])[0]
        for t in range(3):
            c0 = sum(flops.launches.values())
            step = pinned and [p.view(B, S + 3, -1)[:, S + t] for p in pinned]
            (cache, lg), ids = routed_by(lambda: lm.decode_step(cache, extra[:, t], S + t), step)
            per_step.append(sum(flops.launches.values()) - c0)
            logits.append(lg)
            if pinned is None:
                per_step_ids.append(ids)
        return logits[-1], per_step

    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        mcfg, capacity_factor=mcfg.n_experts / mcfg.top_k))
    lm.cfg, d0 = nodrop, int(moe.assignments["dropped"])
    try:
        (_, lg_k6), ids_k6 = routed_by(lambda: prefill(prompts))
        lm._serving_causal = plain
        try:
            (_, lg_plain), ids_plain = routed_by(lambda: prefill(prompts))
            lg_plain_pinned = routed_by(lambda: prefill(prompts), ids_k6)[0][1]
        finally:
            del lm._serving_causal
        (_, lg_full), ids_full = routed_by(lambda: prefill(full_toks))
        lg_dec, per_decode = decode()
        lg_dec_pinned, _ = decode(ids_full)
    finally:
        lm.cfg = cfg
    nodrop_dropped = int(moe.assignments["dropped"]) - d0
    lg_k6, lg_plain, lg_plain_pinned, lg_full = (x[:, 0] for x in (lg_k6, lg_plain,
                                                                    lg_plain_pinned, lg_full))
    # the decode steps' choices against the S + 3 prefill's at positions S .. S + 2
    dec_differ = _choices_differ([i for step in per_step_ids for i in step],
                                 [f.view(B, S + 3, -1)[:, S + t] for t in range(3)
                                  for f in ids_full])
    L = len(ids_k6)  # the expert layers
    rel_plain = rel_l2(torch, lg_k6, lg_plain_pinned)
    rel_dec = rel_l2(torch, lg_dec_pinned, lg_full)
    report = {
        "nodrop_dropped": nodrop_dropped,
        "rel_l2_k6_vs_plain_prefill": rel_plain, "limit": TOL_LM,
        "argmax_agree_k6_vs_plain": _agree(lg_k6, lg_plain_pinned),
        "rel_l2_teacher_forced_decode_vs_nodrop_prefill": rel_dec,
        "argmax_agree_teacher_forced": _agree(lg_dec_pinned, lg_full),
        "unpinned": {
            "rel_l2_k6_vs_plain_prefill": rel_l2(torch, lg_k6, lg_plain),
            "argmax_agree_k6_vs_plain": _agree(lg_k6, lg_plain),
            "expert_choices_differ_k6_vs_plain_by_layer": [
                _choices_differ([a], [b]) for a, b in zip(ids_k6, ids_plain)],
            "expert_choices_k6_vs_plain": L * B * S,
            "rel_l2_teacher_forced_decode_vs_nodrop_prefill": rel_l2(torch, lg_dec, lg_full),
            "argmax_agree_teacher_forced": _agree(lg_dec, lg_full),
            "expert_choices_differ_decode_vs_prefill": dec_differ,
            "expert_choices_decode_vs_prefill": 3 * L * B}}
    failed = ""
    if nodrop_dropped or rel_plain > TOL_LM or rel_dec > TOL_LM:
        failed = (f"dropped at capacity N {nodrop_dropped}, rel L2 K6 vs plain prefill "
                  f"{rel_plain}, teacher-forced decode vs prefill {rel_dec} (routing pinned; "
                  f"limit {TOL_LM})")
    return {"decode": lg_dec, "k6_launches_per_decode_step": per_decode, "report": report,
            "failed": failed}


def _device_time(torch, fn):
    """Device time of ``fn`` from a torch.profiler trace: the sum of kernel
    and copy times on the card (one stream, so no overlap), split into
    K6, matrix products, indexing and sorting (the MoE dispatch's and
    combine's gathers, scatters, sorts and searches; the embedding lookup)
    and the rest, and the five largest kernels.  None where the trace holds
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type.name == "CUDA"]
    if not kernels:
        return None
    classes = {"k6": 0.0, "matmul": 0.0, "index_sort": 0.0, "nccl": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        low = name.lower()
        cls = ("k6" if "flash_tc_kernel" in low or "flash_kernel" in low else
               "nccl" if "nccl" in low else
               "matmul" if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass"))
               else "index_sort" if any(w in low for w in ("sort", "index", "gather", "scatter",
                                                           "searchsorted"))
               else "other")
        classes[cls] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:5]
    return {"device_ms": sum(classes.values()), "by_class_ms": classes,
            "kernels": sum(n for _, _, n in kernels),
            "top": [{"name": n[:80], "ms": ms, "count": c} for n, ms, c in top]}


def _host_top(torch, fn, n=10):
    """The host's own time of ``fn`` in ms (a CPU-only torch.profiler trace)
    and its ``n`` operations of the largest own CPU time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"self_cpu_ms": sum(e.self_cpu_time_total for e in ops) / 1e3,
            "top": [{"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                     "count": e.count} for e in ops[:n]]}


def lm_breakdown(kernels, info, path):
    """A serving path's times beside K6's share (where the path runs K6,
    once a layer, or once a group in the hybrid) and the scan's (the ssm
    and hybrid paths: the selective or SSD scan timed alone at the
    prefill's shape, once a layer), the prefill's bound and the decode
    step's byte bound."""
    k6 = next((k for k in kernels if k["name"].startswith("flash_attention")
               and k["path"] == path), None)
    pre_bound, pre_by = bound_ms(info["prefill_bytes"], info["prefill_flops"], BF16_TC_FLOPS)
    decode_bytes = info["step_weight_bytes"] + info["cache_bytes"]
    out = {"prefill_ms": info["prefill_ms"]}
    rest = info["prefill_ms"]
    for name, ms in (("k6", k6 and k6["ms"]), ("scan", info.get("scan_ms_per_layer"))):
        if ms is not None:
            per = "groups" if name == "k6" and "groups" in info else "layers"
            total = ms * info[per]
            rest -= total
            out.update({f"{name}_ms_x_{per}": total,
                        f"{name}_share_of_prefill": total / info["prefill_ms"],
                        "prefill_rest_ms": rest})
    if "scan_bound_ms_per_layer" in info:
        out["scan_bound_ms_x_layers"] = info["scan_bound_ms_per_layer"] * info["layers"]
    out.update({"prefill_tflop": info["prefill_flops"] / 1e12, "prefill_bound_ms": pre_bound,
                "prefill_bound_by": pre_by,
                "decode_ms_per_step": info["decode_ms_per_step"],
                "decode_bound_ms": decode_bytes / HBM_BPS * 1e3, "decode_bound_by": "bytes",
                "decode_bytes": decode_bytes,
                "prefill_device": info["prefill_device"],
                "decode_device_4_steps": info["decode_device_4_steps"]})
    # the device's idle share against the unprofiled wall times of serve_lm
    if info["prefill_device"]:
        out["prefill_idle_share"] = 1 - info["prefill_device"]["device_ms"] / info["prefill_ms"]
    if info["decode_device_4_steps"]:
        out["decode_idle_share"] = (1 - info["decode_device_4_steps"]["device_ms"] / 4
                                    / info["decode_ms_per_step"])
    return out


# ---------------------------------------------------------------------------
# the train path: the dense family's training on the card
# ---------------------------------------------------------------------------


def train_alone(torch):
    """``--only train``: the train and train_tp paths alone (no kernel is
    built; they launch none), their lines, the card and the result line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    info = {}
    t0 = time.perf_counter()
    counts = _drive(torch, "train", train_path, info)
    _no_launches(counts)
    print(json.dumps({"train": {**info, "card": card}}))
    t1 = time.perf_counter()
    _no_launches(_drive(torch, "train_tp", train_tp_path, card))
    print(card)
    print(json.dumps({"phase_s": {"train": round(t1 - t0, 1),
                                  "train_tp": round(time.perf_counter() - t1, 1)}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _no_launches(counts):
    if any(counts.values()):
        fail(f"train: a train step launched kernels of K1-K6: {counts}")


def train_path(torch, info):
    """The training of every family: (a) one fp32 step of each smoke config
    (GLM-4 and ``TRAIN_FAMILIES``) on the card against the same step on the
    CPU; (b) 4 steps, a preemption and 2 resumed steps against 6
    uninterrupted ones (bf16, optimized flags), bitwise, for GLM-4 and
    ``TRAIN_RESUME_ARCHS``; (c) 2 steps with int8 gradient compression on a
    1-rank NCCL group, GLM-4 and the MoE (``moe_apply_dense``); (d) each
    family at full width (``TRAIN_AT_WIDTH``, ``_train_at_width``).  Fills
    ``info``; every check fails the run."""
    info.update(_train_vs_cpu(torch))
    info["families_card_vs_cpu"] = {arch: _family_vs_cpu(torch, arch) for arch in TRAIN_FAMILIES}
    info.update(_train_resume(torch))
    info["families_resume"] = {arch: _train_resume(torch, arch)["smoke_resume"]
                               for arch in TRAIN_RESUME_ARCHS}
    info.update(_train_int8(torch))
    info["moe_int8"] = _train_int8(torch, TRAIN_INT8_ARCH)["smoke_int8"]
    for line, arch, layers, steps, ckpt, traced in TRAIN_AT_WIDTH:
        gc.collect()
        torch.cuda.empty_cache()
        info.setdefault("at_width", {})[arch] = _train_at_width(
            torch, arch, layers, steps, line=line, checkpoint=ckpt, traced=traced)


def _smoke_train_cfg(dtype, arch=TRAIN_ARCH):
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.smoke(arch), dtype=dtype)


def _smoke_data(cfg):
    """The smoke steps' data: seq 16, batch 4, with the family's frontend."""
    from repro_torch.launch.train import data_for

    return data_for(cfg, 16, 4)


def _family_vs_cpu(torch, arch):
    """One fp32 step of ``arch``'s smoke config on the card and on the CPU
    from the same weights: the loss, the grad norm and every gradient leaf
    within ``TOL_TRAIN_REL``.  An MoE's expert choices are compared first;
    where any differ, the card's step is taken again with the CPU's choices
    pinned (routing is a step function of the router's margins)."""
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = _smoke_train_cfg("float32", arch)
    data = _smoke_data(cfg)
    init = LM(cfg, q_block=8, xent_chunks=2, device="cpu").state_dict()

    def step(device, d, pinned=None):
        lm = LM(cfg, q_block=8, xent_chunks=2, device=device)
        lm.load_state_dict(init)
        layer = {id(p.moe["router"]): i for i, p in enumerate(getattr(lm, "blocks", []))
                 if hasattr(p, "moe")}
        tr = Trainer(lm, data, TrainConfig(steps=1, ckpt_dir=d, lr=SMOKE_TRAIN_LR, warmup=1))
        params, opt, _ = tr.init_state()
        batch = {k: v.to(lm.device) for k, v in data.batch(0).items()}
        (params, opt, m), ids = _routed_by(
            torch, moe, lambda: tr.train_step(params, opt, batch),
            None if pinned is None else [i.to(lm.device) for i in pinned],
            key=lambda w: layer[id(w)])
        return (float(m["loss"]), float(m["grad_norm"]),
                {k: p.grad.detach().cpu() for k, p in params.items()}, [i.cpu() for i in ids])

    with tempfile.TemporaryDirectory() as d:
        (l0, g0, gr0, ids0) = step("cpu", f"{d}/cpu")
        (l1, g1, gr1, ids1) = step("cuda", f"{d}/cuda")
        differ = _choices_differ(ids0, ids1)
        if differ:
            (l1, g1, gr1, _) = step("cuda", f"{d}/pinned", pinned=ids0)
    rel_loss, rel_gnorm = abs(l1 - l0) / abs(l0), abs(g1 - g0) / abs(g0)
    rel_grad = max(float(torch.linalg.vector_norm(gr1[k] - gr0[k])
                         / torch.linalg.vector_norm(gr0[k])) for k in gr0 if gr0[k].any())
    res = {"arch": arch, "loss_cpu": l0, "loss_card": l1, "rel_loss": rel_loss,
           "grad_norm_cpu": g0, "grad_norm_card": g1, "rel_grad_norm": rel_gnorm,
           "max_rel_l2_grad_leaf": rel_grad, "limit": TOL_TRAIN_REL}
    if ids0:
        n = sum(int(i.shape[0]) for i in ids0)
        res.update({"expert_choices_differ": differ, "expert_choices": n,
                    "differ_share": differ / n, "card_pinned_to_cpu": bool(differ)})
    print(json.dumps({"family_card_vs_cpu": res}))
    if max(rel_loss, rel_gnorm, rel_grad) > TOL_TRAIN_REL:
        fail(f"train: the card's step against the CPU's: {res}")
    return res


def _train_vs_cpu(torch):
    """One fp32 step on the card and on the CPU from the same weights: the
    loss, the grad norm and every (clipped) gradient leaf within
    ``TOL_TRAIN_REL``; then the optimizer alone on the card, from the same
    weights and the CPU's gradients, bitwise the CPU's updated weights and
    moments.  (The updated weights themselves differ where a gradient is
    near AdamW's eps: its first step divides g by |g| + 1e-8.)"""
    import functools

    from repro_torch.models.convert import decays_in_reference
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = _smoke_train_cfg("float32")
    data = _smoke_data(cfg)
    cpu = LM(cfg, q_block=8, xent_chunks=2, device="cpu")
    gpu = LM(cfg, q_block=8, xent_chunks=2, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    init = {k: t.clone() for k, t in cpu.state_dict().items()}
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, lm in (("cpu", cpu), ("cuda", gpu)):
            tr = Trainer(lm, data, TrainConfig(steps=1, ckpt_dir=f"{d}/{name}", lr=SMOKE_TRAIN_LR,
                                               warmup=1))
            params, opt, _ = tr.init_state()
            batch = {k: v.to(lm.device) for k, v in data.batch(0).items()}
            params, opt, m = tr.train_step(params, opt, batch)
            out[name] = (float(m["loss"]), float(m["grad_norm"]),
                         {k: p.grad.detach().cpu() for k, p in params.items()},
                         {k: p.detach().cpu() for k, p in params.items()}, opt)
    (l0, g0, gr0, p0, o0), (l1, g1, gr1, p1, _) = out["cpu"], out["cuda"]
    rel_loss, rel_gnorm = abs(l1 - l0) / abs(l0), abs(g1 - g0) / abs(g0)
    rel_grad = max(float(torch.linalg.vector_norm(gr1[k] - gr0[k])
                         / torch.linalg.vector_norm(gr0[k])) for k in gr0 if gr0[k].any())
    # the optimizer alone: the CPU's clipped gradients, no further clip
    adam = AdamW(lr=cosine_schedule(SMOKE_TRAIN_LR, 1, 1), max_grad_norm=1e30,
                 decays=functools.partial(decays_in_reference, cfg))
    params = {k: t.cuda() for k, t in init.items()}
    params, st, _ = adam.update({k: g.cuda() for k, g in gr0.items()}, adam.init(params), params)
    opt_bitwise = all(torch.equal(params[k].cpu(), p0[k]) and torch.equal(st.mu[k].cpu(), o0.mu[k])
                      and torch.equal(st.nu[k].cpu(), o0.nu[k]) for k in p0)
    res = {"smoke_card_vs_cpu": {
        "loss_cpu": l0, "loss_card": l1, "rel_loss": rel_loss, "grad_norm_cpu": g0,
        "grad_norm_card": g1, "rel_grad_norm": rel_gnorm, "max_rel_l2_grad_leaf": rel_grad,
        "limit": TOL_TRAIN_REL, "optimizer_on_the_cpu_grads_bitwise": opt_bitwise,
        "max_abs_updated_param": max(float((p1[k] - p0[k]).abs().max()) for k in p0)}}
    print(json.dumps(res))
    if max(rel_loss, rel_gnorm, rel_grad) > TOL_TRAIN_REL or not opt_bitwise:
        fail(f"train: the card's step against the CPU's: {res}")
    return res


def _train_resume(torch, arch=TRAIN_ARCH):
    """4 steps, the stop flag SIGTERM sets, 2 resumed steps against 6
    uninterrupted ones: weights, moments and losses bitwise (an MoE's
    backward has no atomics: ``moe._Fill``)."""
    from repro_torch.models.lm import LM, OPTIMIZED
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = _smoke_train_cfg("bfloat16", arch)
    data = _smoke_data(cfg)

    def trainer(d):
        lm = LM(cfg, q_block=8, xent_chunks=2, perf=OPTIMIZED, device="cuda")
        return Trainer(lm, data, TrainConfig(steps=6, ckpt_every=100, ckpt_dir=d,
                                             lr=SMOKE_TRAIN_LR, warmup=2))

    with tempfile.TemporaryDirectory() as d:
        first = trainer(f"{d}/a")

        def stop(m):
            if m["step"] == 3:
                first._stop = True

        _, _, h1 = first.run(on_metrics=stop)
        p2, o2, h2 = trainer(f"{d}/a").run()
        p3, o3, h3 = trainer(f"{d}/b").run()
    same = {"losses": [h["loss"] for h in h1 + h2] == [h["loss"] for h in h3],
            "params": all(torch.equal(p2[k], p3[k]) for k in p3),
            "moments": all(torch.equal(o2.mu[k], o3.mu[k]) and torch.equal(o2.nu[k], o3.nu[k])
                           for k in p3)}
    res = {"smoke_resume": {"arch": arch,
                            "steps": [[h["step"] for h in h1], [h["step"] for h in h2]],
                            "bitwise": same,
                            "max_abs_param": max(float((p2[k] - p3[k]).detach().float().abs().max())
                                                 for k in p3)}}
    print(json.dumps(res))
    if res["smoke_resume"]["steps"] != [[0, 1, 2, 3], [4, 5]] or not all(same.values()):
        fail(f"train: 4 + 2 resumed steps against 6: {res}")
    return res


def _train_int8(torch, arch=TRAIN_ARCH):
    """2 steps with int8 error-feedback compression on a 1-rank NCCL group
    (an MoE trains its local-mode LM: ``moe_apply_dense``)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = _smoke_train_cfg("float32", arch)
    with _nccl_world_one(), tempfile.TemporaryDirectory() as d:
        mesh = make_host_mesh(1, device="cuda")
        tr = Trainer(LM(cfg, q_block=8, xent_chunks=2, device="cuda"), _smoke_data(cfg),
                     TrainConfig(steps=2, ckpt_every=100, ckpt_dir=d, lr=SMOKE_TRAIN_LR, warmup=1,
                                 grad_compression="int8"), mesh=mesh)
        _, _, hist = tr.run()
    res = {"smoke_int8": {"arch": arch, "local_mode": tr.loss_lm.local_mode,
                          "loss": [h["loss"] for h in hist],
                          "grad_norm": [h["grad_norm"] for h in hist]}}
    print(json.dumps(res))
    if len(hist) != 2 or not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                                 for h in hist) or not tr.loss_lm.local_mode:
        fail(f"train: int8 compression: {res}")
    return res


def _train_flops(lm, B, S):
    """Model operations of one step at full width, two a multiply-add: 6 T
    for each weight that multiplies, T the tokens it multiplies (the
    embedding table is a lookup, a tied one is also the head), and the
    attention's two products, forward (1) and backward (2); the recomputed
    forward of remat and the scans' elementwise recurrences are not counted.
    T is B S, the VLM's layers take its F + S positions a row (the head S),
    the audio encoder's its S frames, the hybrid's shared block runs once
    a group.  The MoE family counts its own (``_moe_train_flops``)."""
    cfg, H, dh = lm.cfg, lm.cfg.n_heads, lm.head_dim
    S_dec = S + (cfg.n_frontend_tokens if cfg.family == "vlm" else 0)
    groups = len(lm.blocks) if cfg.family == "hybrid" else 1
    tokens = {"embed": B * S if cfg.tie_embeddings else 0, "lm_head": B * S,
              "shared": B * S * groups, "enc_blocks": B * S}
    tp = 1 if lm.shard is None else lm.shard.tp  # an LM on a mesh: the whole model's
    n = sum(p.numel() * (tp if lm.split_over_model(k) else 1) * tokens.get(k.split(".")[0],
                                                                           B * S_dec)
            for k, p in lm.trainable_params().items())

    def pairs(q, k, causal=True):  # the (query, key) pairs of one head
        return q * (q + 1) / 2 if causal else q * k

    if cfg.family == "ssm":
        att = 0
    elif cfg.family == "hybrid":
        att = groups * pairs(S, S)
    elif cfg.family == "audio":  # the encoder's, the decoder's self and (causal) cross
        att = len(lm.enc_blocks) * pairs(S, S, False) + 2 * len(lm.dec_blocks) * pairs(S, S)
    else:
        att = len(lm.blocks) * pairs(S_dec, S_dec)
    return {"model_flops_per_step": 6 * n + 3 * 2 * 2 * B * H * dh * att}


def _moe_train_flops(lm, B, S):
    """Model operations of one step of an MoE with MLA (two a multiply-add,
    6 N_active T over the weights a token passes through, the recomputed
    forward of remat not counted): the head; each layer's attention (wq,
    w_dkv, w_uk, w_uv, wo) and its MLP (the dense first layers) or its
    router, shared experts and top-k routed experts; plus the causal
    attention's two products (q k of dn + dr, p v of dv) x 3.  Beside it
    the capacity slots' expert operations: every expert runs on its whole
    (capacity, d) slice, E cap rows a layer against the N k routed."""
    cfg = lm.cfg
    m, d, H = cfg.moe, cfg.d_model, cfg.n_heads
    la = cfg.mla
    attn = (d * H * (la.qk_nope_dim + la.qk_rope_dim) + d * (la.kv_lora_rank + la.qk_rope_dim)
            + la.kv_lora_rank * H * (la.qk_nope_dim + la.v_head_dim) + H * la.v_head_dim * d)
    gated = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    expert = gated * d * m.d_ff_expert
    n_dense = m.first_k_dense
    n_moe = cfg.n_layers - n_dense
    dense_layer = attn + gated * d * (m.dense_ff or cfg.d_ff)
    moe_layer = attn + d * m.n_experts + m.n_shared * expert + m.top_k * expert
    n_active = d * cfg.vocab + n_dense * dense_layer + n_moe * moe_layer
    T = B * S
    pairs = B * H * S * (S + 1) / 2
    attn_ops = 2 * pairs * (la.qk_nope_dim + la.qk_rope_dim + la.v_head_dim) * cfg.n_layers
    cap = max(1, math.ceil(T * m.top_k * m.capacity_factor / m.n_experts))
    return {"n_active": n_active, "model_flops_per_step": 6 * n_active * T + 3 * attn_ops,
            "capacity": cap, "capacity_slots": m.n_experts * cap,
            "routed_assignments": T * m.top_k,
            "routed_expert_flops": 6 * expert * T * m.top_k * n_moe,
            "capacity_slot_expert_flops": 6 * expert * m.n_experts * cap * n_moe}


@contextlib.contextmanager
def _moe_probe(cfg):
    """While active, ``moe.route`` and ``moe._dispatch`` note each call's
    aux, z and dropped assignments; yields the Trainer's ``on_metrics``,
    which adds to a step's record the sums of aux and z over the expert
    layers and each layer's dropped share, from the forward's calls (the
    backward's recomputation calls them again)."""
    from repro_torch.models import moe

    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    route, dispatch, calls = moe.route, moe._dispatch, []

    def routed(router_w, x, top_k):
        out = route(router_w, x, top_k)
        calls.append({"aux": out[2].detach(), "z": out[3].detach()})
        return out

    def dispatched(*args, **kwargs):
        before = moe.assignments["dropped"]
        out = dispatch(*args, **kwargs)
        calls[-1]["dropped"] = moe.assignments["dropped"] - before
        calls[-1]["routed"] = args[1].shape[0] * cfg.moe.top_k
        return out

    def on_metrics(h):
        fwd = calls[:n_moe]
        h.update({"aux": float(sum(c["aux"] for c in fwd)), "z": float(sum(c["z"] for c in fwd)),
                  "dropped_share_by_layer": [int(c["dropped"]) / c["routed"] for c in fwd]})
        calls.clear()

    moe.route, moe._dispatch = routed, dispatched
    try:
        yield on_metrics
    finally:
        moe.route, moe._dispatch = route, dispatch


def _train_at_width(torch, arch, layers, steps, *, line=None, checkpoint=False, traced=False,
                    perf=None, lm_kw=None, why=None):
    """``arch`` at full width cut to ``layers`` (PERF.md §4), seeded weights,
    ``perf`` (the optimized flags, "dots" remat, unless given), on the mesh
    of ``lm_kw`` (``LM``'s ``mesh`` and ``sp_mode``) where given: the
    Trainer's ``steps`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens (the
    family's frontend embeddings with them), timed by its own loop; with
    ``checkpoint`` its final checkpoint, then a second Trainer on a fresh
    model that resumes and takes a step (else the Trainer writes none); with
    ``traced`` one more step under the profiler.  The MoE family's steps
    also give their aux, z and dropped shares (``_moe_probe``); an LM on a
    mesh its collectives, ``steps`` x ``LM.collectives_per_step(trainer=
    True)`` (the checkpoint's gathers beside them).  Every rank of a mesh
    calls it; rank 0 prints one ``{line: ...}`` line where ``line`` is
    given.  Returns the record; fails on a non-finite loss or grad norm, a
    launch of K1-K6, collectives off the formula or a peak above
    ``TRAIN_PEAK_GIB``.  ``why``: the reason for the cut in depth."""
    import dataclasses
    from collections import Counter

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.train import data_for
    from repro_torch.models import sharding
    from repro_torch.models.lm import LM, OPTIMIZED
    from repro_torch.runtime import TrainConfig, Trainer
    from repro_torch.runtime import trainer as trainer_mod

    full = configs.get(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    is_moe = cfg.moe is not None
    data = data_for(cfg, TRAIN_SEQ, TRAIN_BATCH)
    lm_kw = lm_kw or {}
    ranks = dist.is_initialized()
    lead = not ranks or dist.get_rank() == 0
    if checkpoint:  # where there is more room: the temporary directory or the checkout
        base = max((tempfile.gettempdir(), str(ROOT)), key=lambda d: shutil.disk_usage(d).free)
        ckpt_dir = [tempfile.mkdtemp(prefix="chip_smoke_train_", dir=base) if lead else None]
    else:
        ckpt_dir = [tempfile.mkdtemp(prefix="chip_smoke_train_") if lead else None]
    if ranks:  # one directory for every rank: rank 0's
        dist.broadcast_object_list(ckpt_dir, src=0)
    ckpt_dir = ckpt_dir[0]

    def model():
        return LM(cfg, q_block=min(512, TRAIN_SEQ), xent_chunks=min(8, TRAIN_SEQ),
                  perf=perf or OPTIMIZED, device="cuda", **lm_kw)

    def trainer(lm, n):
        tr = Trainer(lm, data, TrainConfig(steps=n, ckpt_every=10**9, ckpt_dir=ckpt_dir,
                                           lr=TRAIN_LR, warmup=2))
        if not checkpoint:
            tr._save = lambda *_: None
        return tr

    out, peaks, resumed = {}, {}, None
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lm = model()
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        peaks["built"] = torch.cuda.max_memory_allocated() / 2**30
        n_cards = 1 if lm.shard is None else lm.shard.tp * lm.shard.dp
        n_params = sum(p.numel() * (lm.shard.tp if lm.split_over_model(k) else 1)
                       for k, p in lm.named_parameters())  # the whole model's
        flops = (_moe_train_flops if is_moe else _train_flops)(lm, TRAIN_BATCH, TRAIN_SEQ)
        if checkpoint:
            # bf16 weights and fp32 moments, 10 bytes a parameter, on disk
            # and (the async snapshot) in host memory
            du = shutil.disk_usage(ckpt_dir)
            host = {"disk_free_gib": du.free / 2**30, "ram_free_gib": _ram_available_gib()}
            if lead:
                print(json.dumps({"train_host": {**host, "ckpt_dir": ckpt_dir}}))
            need = 10 * n_params / 2**30
            if host["disk_free_gib"] < 1.1 * need or (host["ram_free_gib"] or 0) < 1.1 * need:
                fail(f"train: the checkpoint takes {need:.1f} GiB; free disk "
                     f"{host['disk_free_gib']:.1f}, RAM {host['ram_free_gib']} GiB: cut {arch}'s "
                     "layers in TRAIN_AT_WIDTH")
            out.update(host)
        tr = trainer(lm, steps)
        want = lm.collectives_per_step(trainer=True)
        sharding.collectives.clear()
        with _moe_probe(cfg) if is_moe else contextlib.nullcontext() as on_metrics:
            def on_step(m):  # the steps' peak, before the final checkpoint's
                if on_metrics:
                    on_metrics(m)
                if m["step"] == steps - 1:
                    torch.cuda.synchronize()
                    peaks["steps"] = torch.cuda.max_memory_allocated() / 2**30
                    torch.cuda.reset_peak_memory_stats()

            t0 = time.perf_counter()
            params, opt, hist = tr.run(on_metrics=on_step)
            out["run_s"] = time.perf_counter() - t0
            if lm.shard is not None:
                counts = Counter(sharding.collectives)
                out["collectives"] = dict(counts)
                out["collectives_formula"] = {k: steps * v for k, v in want.items()}
                out["collectives_ok"] = all(
                    counts[k] == out["collectives_formula"].get(k, 0)
                    for k in set(counts) | set(want) if k != "gather")
            if checkpoint:
                peaks["checkpoint"] = torch.cuda.max_memory_allocated() / 2**30
                out.update({"ckpt_snapshot_s": tr.snapshot_s, "ckpt_write_s": tr.ckpt.write_s,
                            "ckpt_bytes": sum(f.stat().st_size
                                              for f in Path(ckpt_dir).rglob("*.npy"))
                            if lead else None})
                saved = _state_digest(torch, params, opt)
                del tr, lm, params, opt
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                tr = trainer(model(), steps + 1)
                read = []  # the store's read (np.load and sha1 of every leaf) in the restore
                real_load = trainer_mod.load_checkpoint

                def timed_load(*args, **kwargs):
                    t = time.perf_counter()
                    try:
                        return real_load(*args, **kwargs)
                    finally:
                        read.append(time.perf_counter() - t)

                trainer_mod.load_checkpoint = timed_load
                t0 = time.perf_counter()
                try:
                    params, opt, start = tr.restore_or_init()
                finally:
                    trainer_mod.load_checkpoint = real_load
                torch.cuda.synchronize()
                out.update({"resume_load_s": time.perf_counter() - t0, "resume_read_s": sum(read),
                            "restored_bitwise": torch.equal(_state_digest(torch, params, opt),
                                                            saved)})
                t0 = time.perf_counter()
                params, opt, m = tr.train_step(params, opt, tr.stage_batch(start))
                resumed = {"step": start, "loss": float(m["loss"]),
                           "grad_norm": float(m["grad_norm"]), "time": time.perf_counter() - t0}
                peaks["resume"] = torch.cuda.max_memory_allocated() / 2**30
            if traced:
                batch = tr.stage_batch(steps + (resumed is not None))
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out["step_device"] = _device_time(torch, lambda: tr.train_step(params, opt, batch))
                out["traced_step_s"] = time.perf_counter() - t0
                peaks["traced_step"] = torch.cuda.max_memory_allocated() / 2**30
        del tr, params, opt
    finally:
        if lead:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    launches = sum(_count_snapshot().values())
    step_s = statistics.median(h["time"] for h in hist[1:])
    bound_s = flops["model_flops_per_step"] / (BF16_TC_FLOPS * n_cards)
    losses = [h["loss"] for h in hist] + ([resumed["loss"]] if resumed else [])
    norms = [h["grad_norm"] for h in hist] + ([resumed["grad_norm"]] if resumed else [])
    device = out.get("step_device")
    out = {"arch": cfg.name, "layers": layers, "published_layers": full.n_layers,
           "reduced": None if layers == full.n_layers else
           f"n_layers {full.n_layers}->{layers}: " + (
               why or "the weights, gradients and fp32 moments of every layer do not fit the "
               "card, or the run's time (PERF.md §4)"),
           **({"mesh": [lm_kw["mesh"].size(0), lm_kw["mesh"].size(1)],
               "sp_mode": lm_kw.get("sp_mode", "none"),
               "seq_sharded_residual": (perf or OPTIMIZED).seq_sharded_residual}
              if "mesh" in lm_kw else {}),
           "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype, "params": n_params,
           **({"moe": dataclasses.asdict(cfg.moe)} if is_moe else {}),
           **({"mla": dataclasses.asdict(cfg.mla)} if cfg.mla else {}),
           "remat_policy": "dots", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "frontend": data.frontend, "lr": TRAIN_LR, **out,
           "steps": [h["step"] for h in hist], "step_times_s": [h["time"] for h in hist],
           "first_step_s": hist[0]["time"], "step_s_median_after_first": step_s,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, **flops, "bound_s": bound_s,
           "model_flop_share": bound_s / step_s, "peak_gib_by_phase": peaks,
           "max_memory_allocated_gib": max(peaks.values()), "resumed": resumed,
           "losses": losses, "xents": [h["xent"] for h in hist], "grad_norms": norms,
           "first_loss": losses[0], "ln_vocab": math.log(cfg.vocab),
           "step_idle_share": (1 - device["device_ms"] / 1e3 / step_s) if device else None,
           "k1_k6_launches": launches}
    if is_moe:
        out.update({"aux": [h["aux"] for h in hist], "z": [h["z"] for h in hist],
                    "dropped_share_by_layer": {f"step{h['step'] + 1}": h["dropped_share_by_layer"]
                                               for h in (hist[0], hist[-1])}})
    if line and lead:
        print(json.dumps({line: out}))
    finite = all(math.isfinite(x) for x in losses + norms + out.get("aux", []) + out.get("z", []))
    if (not finite or out["steps"] != list(range(steps)) or launches
            or (resumed and (resumed["step"] != steps or not out["restored_bitwise"]))
            or not out.get("collectives_ok", True)):
        fail(f"train: {arch} at full width: finite {finite}, steps {out['steps']}, "
             f"resumed {resumed}, launches {launches}, collectives {out.get('collectives')} "
             f"against {out.get('collectives_formula')}")
    if out["max_memory_allocated_gib"] > TRAIN_PEAK_GIB:
        fail(f"train: {arch} at full width peaks at {out['max_memory_allocated_gib']:.2f} GiB, "
             f"above {TRAIN_PEAK_GIB}: cut its layers in TRAIN_AT_WIDTH")
    return out


def train_tp_path(torch, card):
    """The dense family's training on a mesh, on a 1-rank NCCL group: the
    four forms of the smoke GLM-4 (``_train_tp_forms``), then GLM-4-9B at
    full width (``_train_tp_width``).  Prints one ``{"train_tp"}`` line;
    every check fails the run."""
    t0 = time.perf_counter()
    with _nccl_world_one():
        info = {"forms": _train_tp_forms(torch)}
        gc.collect()
        torch.cuda.empty_cache()
        info["at_width"] = _train_tp_width(torch)
    info["seconds"] = time.perf_counter() - t0
    print(json.dumps({"train_tp": {**info, "card": card}}))


def _rel(a, b):
    return abs(a - b) / abs(b)


def _max_rel_leaf(torch, got, want):
    """The largest rel. L2 over the gradient leaves (those not all zero)."""
    return max(float(torch.linalg.vector_norm(got[k].float() - want[k].float())
                     / torch.linalg.vector_norm(want[k].float())) for k in want if want[k].any())


def _train_tp_forms(torch):
    """The smoke GLM-4 in fp32 (TF32 off) from one set of weights: the loss
    and every gradient leaf (``LM.sum_partial_grads`` applied) of each of
    ``TRAIN_TP_FORMS`` on the 1-rank mesh against the mesh-less LM's on the
    card (``TOL_TP_CARD``, and whether bitwise) and on the CPU
    (``TOL_TRAIN_REL``); then a step of each Trainer's ``run``: its grad norm
    against the mesh-less Trainer's on the card (``TOL_TP_CARD``) and the
    collectives it issues against ``LM.collectives_per_step(trainer=True)``,
    exactly."""
    from collections import Counter

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding
    from repro_torch.models.convert import shard_params
    from repro_torch.models.lm import LM, PerfFlags
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = _smoke_train_cfg("float32")
    data = _smoke_data(cfg)
    batch = data.batch(0)
    init = LM(cfg, q_block=8, xent_chunks=2, device="cpu").state_dict()
    mesh = make_host_mesh(1, device="cuda")

    def model(device, form=None):
        sp, ssr = form or ("none", False)
        kw = {} if form is None else {"mesh": mesh, "sp_mode": sp}
        lm = LM(cfg, q_block=8, xent_chunks=2, perf=PerfFlags(seq_sharded_residual=ssr),
                device=device, **kw)
        lm.load_state_dict(init if form is None else shard_params(cfg, init, mesh))
        return lm

    def loss_and_grads(lm):
        params = lm.trainable_params()
        loss, _ = lm.loss({k: v.to(lm.device) for k, v in batch.items()})
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in params.items()}
        lm.sum_partial_grads(grads)
        return loss.detach().cpu(), {k: g.cpu() for k, g in grads.items()}

    def step(lm, d):
        tr = Trainer(lm, data, TrainConfig(steps=1, ckpt_dir=d, lr=SMOKE_TRAIN_LR, warmup=1))
        sharding.collectives.clear()
        hist = tr.run()[2]
        return hist[0]["grad_norm"], Counter(sharding.collectives)

    with tempfile.TemporaryDirectory() as d:
        cpu_loss, cpu_grads = loss_and_grads(model("cpu"))
        card = model("cuda")
        card_loss, card_grads = loss_and_grads(card)
        card_gnorm, _ = step(card, f"{d}/card")
        out = []
        for form in TRAIN_TP_FORMS:
            lm = model("cuda", form)
            loss, grads = loss_and_grads(lm)
            gnorm, counts = step(lm, f"{d}/{form[0]}-{form[1]}")
            want = lm.collectives_per_step(trainer=True)
            rec = {"sp_mode": form[0], "seq_sharded_residual": form[1], "loss": float(loss),
                   "rel_loss_card": _rel(float(loss), float(card_loss)),
                   "max_rel_l2_grad_leaf_card": _max_rel_leaf(torch, grads, card_grads),
                   "bitwise_card": bool(torch.equal(loss, card_loss)
                                        and all(torch.equal(grads[k], card_grads[k])
                                                for k in card_grads)),
                   "rel_loss_cpu": _rel(float(loss), float(cpu_loss)),
                   "max_rel_l2_grad_leaf_cpu": _max_rel_leaf(torch, grads, cpu_grads),
                   "grad_norm": gnorm, "rel_grad_norm_card": _rel(gnorm, card_gnorm),
                   "collectives": dict(counts), "collectives_formula": dict(want),
                   "limits": {"card": TOL_TP_CARD, "cpu": TOL_TRAIN_REL}}
            out.append(rec)
            if (max(rec["rel_loss_card"], rec["max_rel_l2_grad_leaf_card"],
                    rec["rel_grad_norm_card"]) > TOL_TP_CARD
                    or max(rec["rel_loss_cpu"], rec["max_rel_l2_grad_leaf_cpu"]) > TOL_TRAIN_REL
                    or counts != want):
                fail(f"train_tp: the {form} form against the mesh-less LM: {rec}")
            del lm
    return out


def _train_tp_width(torch):
    """GLM-4-9B at full width cut to ``TRAIN_TP_LAYERS`` (bf16, seeded
    weights, "dots", the sequence-sharded residual, fp32 attention,
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, lr ``TRAIN_LR``):
    ``TRAIN_TP_STEPS`` Trainer steps of the LM on the 1-rank mesh with
    Ulysses, then as many of the mesh-less LM drawn from the same seed
    (``_train_at_width`` both); each step's loss and grad norm within
    ``TOL_TRAIN_REL`` relative."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import PerfFlags

    perf = PerfFlags(remat_policy="dots", seq_sharded_residual=True)
    mesh = make_host_mesh(1, device="cuda")
    runs = {name: _train_at_width(torch, TRAIN_ARCH, TRAIN_TP_LAYERS, TRAIN_TP_STEPS, perf=perf,
                                  lm_kw=kw, why="two runs a phase of ~40 s (PERF.md §4)")
            for name, kw in (("mesh", {"mesh": mesh, "sp_mode": "ulysses"}), ("mesh_less", {}))}
    m, ref = runs["mesh"], runs["mesh_less"]
    out = {**runs,
           "rel_loss": [_rel(a, b) for a, b in zip(m["losses"], ref["losses"])],
           "rel_grad_norm": [_rel(a, b) for a, b in zip(m["grad_norms"], ref["grad_norms"])],
           "bitwise": m["losses"] == ref["losses"] and m["grad_norms"] == ref["grad_norms"],
           "limit": TOL_TRAIN_REL}
    if max(out["rel_loss"] + out["rel_grad_norm"]) > TOL_TRAIN_REL:
        fail(f"train_tp: GLM-4-9B on the mesh against the mesh-less run: {out}")
    return out


def _state_digest(torch, params, opt):
    """Each leaf's fp64 sum, of the weights, both moments and the step (a
    restored state equals the saved one where these are equal, bit for
    bit: the same sums in the same order)."""
    leaves = [*params.values(), *opt.mu.values(), *opt.nu.values(), opt.step]
    return torch.stack([t.detach().sum(dtype=torch.float64).cpu() for t in leaves])


def _ram_available_gib():
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return None


# ---------------------------------------------------------------------------
# phase 4: the main path's kernels at its shapes
# ---------------------------------------------------------------------------


def _launched(paths, key):
    """Launches of ``key`` over every path (a kernel no path runs: 0)."""
    return sum(counts.get(key, 0) for counts in paths.values())


def _record(name, source, replaces, path, launches, err, ms, plain_ms, bound, library_ms,
            **extra):
    b, by = bound
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "path": path, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": library_ms, **extra}


def main_path_kernels(torch, paths, tune_shapes, serve_shapes, dns_shapes):
    from repro_torch.kernels.exchange import ops as xops, ref as xref
    from repro_torch.kernels.fft import ops as fops, ref as fref

    n = SHAPE_BIG[-1]
    n1, n2 = fops.plan_factors(n)
    x = _big_input(torch, seed=2)
    rows = x.reshape(-1, n)
    batch = rows.shape[0]
    kernels = []
    counts = paths["slice"]

    # the tensor-core design: 3 TF32 products of (2 n1)^2 n2 and (2 n2)^2 n1
    # multiply-adds a row (the twiddle's 6 n fp32 flops are below 1 %)
    if not fops.tensor_core_design(n1, n2):
        fail(f"K4 at n = {n}: the path's length is not on the tensor-core design")
    k4_flops = batch * 3 * 2.0 * ((2 * n1) ** 2 * n2 + (2 * n2) ** 2 * n1)
    k4_bytes = 2 * rows.numel() * 8
    for mode, kern, plain, lib in (
            ("fft", lambda: fops.fft_matmul(rows), lambda: fref.fourstep_ref(rows, n1, n2),
             lambda: torch.fft.fft(rows, dim=-1)),
            ("ifft", lambda: fops.fft_matmul(rows, inverse=True),
             lambda: fref.fourstep_ref(rows.conj(), n1, n2).conj() / n,
             lambda: torch.fft.ifft(rows, dim=-1))):
        (got, design), want = _ran_design(fops.design_launches, kern, "K4"), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > TOL_K4 * float(want.abs().max()):
            fail(f"fourstep {mode} at {SHAPE_BIG}: max err {err}")
        if design != "tc":
            fail(f"fourstep {mode} at {SHAPE_BIG}: ran the {design} design")
        del got, want
        kernels.append(_record(f"fourstep_dft[{mode}]", "fourstep.cu",
                               "src/repro/kernels/fft/kernel.py:87", "slice",
                               counts.get(f"tc:{mode}", 0),
                               err, cuda_ms(torch, kern), cuda_ms(torch, plain),
                               bound_ms(k4_bytes, k4_flops, TF32_TC_FLOPS), cuda_ms(torch, lib),
                               design=design, one_call_ms=one_call_ms(torch, kern)))

    # the general design on the slice path: the quickstart shape's last axis
    # (42 * 63 rows of n = 64), fp32 FMA over its own split (8 * 8): bound by
    # 16 bytes and 8 n (g1 + g2) + 6 n fp32 operations a row
    qn = SHAPE_QS[-1]
    q1, q2 = fops.plan_factors(qn)
    g1, g2 = fref.general_split(qn)
    qrows = _randn(torch, (SHAPE_QS[0] * SHAPE_QS[1], qn), 3)
    (got, design), want = _ran_design(fops.design_launches, lambda: fops.fft_matmul(qrows),
                                      "K4"), fref.fourstep_ref(qrows, q1, q2)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > TOL_K4 * float(want.abs().max()) or design != "general":
        fail(f"fourstep fft at {SHAPE_QS}: max err {err}, design {design}")
    kernels.append(_record("fourstep_dft[fft,quickstart]", "fourstep.cu",
                           "src/repro/kernels/fft/kernel.py:87", "slice",
                           counts.get("general:fft", 0), err,
                           cuda_ms(torch, lambda: fops.fft_matmul(qrows)),
                           cuda_ms(torch, lambda: fref.fourstep_ref(qrows, q1, q2)),
                           bound_ms(2 * qrows.numel() * 8,
                                    qrows.shape[0] * (8.0 * qn * (g1 + g2) + 6.0 * qn)),
                           cuda_ms(torch, lambda: torch.fft.fft(qrows, dim=-1)),
                           design=design, shape=list(qrows.shape), split=[g1, g2],
                           one_call_ms=one_call_ms(torch, lambda: fops.fft_matmul(qrows)),
                           library_one_call_ms=one_call_ms(
                               torch, lambda: torch.fft.fft(qrows, dim=-1))))
    del got, want, qrows

    # the first forward exchange: v = 2 -> w = 1 over a group of 1
    v, w, m = 2, 1, 1
    elems = x.numel()
    flat = torch.view_as_real(x)
    for codec, wire in (("bf16", 2), ("int8", 1)):
        enc = lambda: xops.pack_chunks(x, axis=v, m=m, codec=codec)
        enc_plain = lambda: xref.pack_chunks_ref(x, axis=v, m=m, codec=codec)
        (q, s, _), design = _vec(xops.design_launches, enc, f"K1 {codec} {SHAPE_BIG}")
        qr, sr, _ = enc_plain()
        err = _check_codec(torch, f"pack_chunks {codec} {SHAPE_BIG}", q, qr, codec)
        if codec == "int8" and not torch.equal(s, sr):
            fail("pack_chunks int8 at 512^3: scales differ from the plain version")
        cast = (cuda_ms(torch, lambda: flat.to(torch.bfloat16)) if codec == "bf16" else None)
        kernels.append(_record(f"exchange_encode[chunk_major,{codec}]", "exchange.cu",
                               "src/repro/kernels/exchange/kernel.py:89", "slice",
                               counts.get(f"pack_chunks:{codec}", 0), err, cuda_ms(torch, enc),
                               cuda_ms(torch, enc_plain),
                               bound_ms(elems * 8 + elems * 2 * wire, 0), cast, design=design,
                               one_call_ms=one_call_ms(torch, enc)))
        del q, s
        dkw = dict(v=v, w=w, m=m, scale=sr, codec=codec, iscomplex=True)
        dec = lambda: xops.unpack_chunks(qr, **dkw)
        dec_plain = lambda: xref.unpack_chunks_ref(qr, **dkw)
        got, design = _vec(xops.decode_design_launches, dec, f"K3 {codec} {SHAPE_BIG}")
        err = _check_codec(torch, f"unpack_chunks {codec} {SHAPE_BIG}", got, dec_plain(), "bf16")
        del got
        kernels.append(_record(f"exchange_decode[scatter_w,{codec}]", "exchange.cu",
                               "src/repro/kernels/exchange/kernel.py:173", "slice",
                               counts.get(f"unpack_chunks:{codec}", 0), err, cuda_ms(torch, dec),
                               cuda_ms(torch, dec_plain),
                               bound_ms(elems * 2 * wire + elems * 8, 0),
                               cuda_ms(torch, lambda: qr.float()) if codec == "bf16" else None,
                               design=design, one_call_ms=one_call_ms(torch, dec)))
        del qr, sr

    kernels += _composed_records(torch, x, xops, xref, kernels, paths["composed"])
    kernels += _pipelined_slice_records(torch, x, xops, xref, paths["engines"])
    kernels += _guard_mode_records(torch, x, xops, xref, paths["guard"])
    kernels += _in_place_decode_records(torch, x, xops, xref, paths)

    del x, rows
    torch.cuda.empty_cache()
    kernels += _many_records(torch, paths["many"])
    x = _big_input(torch, seed=2)
    kernels += _transpose_records(torch, x, paths)
    del x
    torch.cuda.empty_cache()
    kernels += _flash_records(torch, paths)
    kernels.append(_flash_fp32_record(torch, paths))
    kernels += _shape_records(torch, tune_shapes, "tune")
    kernels += _shape_records(torch, serve_shapes, "serve")
    kernels += _shape_records(torch, dns_shapes, "dns")

    for k in kernels:
        if k["path"] is not None and k["launches"] < 1:
            fail(f"{k['name']} was never launched on the {k['path']} path")
    return kernels


def _shape_records(torch, shapes, path):
    """A path's kernels at every shape it launched them at (``shapes`` from
    ``_LaunchesByShape``: the tune path's candidate stage views, each plan's
    full block and every pipelined slice; the serve path's coalesced
    stacks), one record per call signature with that signature's launches:
    a seeded input of the shape through the wrapper, on the design the path
    ran there, against the plain version and, where one exists, the library
    call."""
    recs = []
    for key in sorted(shapes, key=str):
        rec = shapes[key]
        if len(rec["designs"]) != 1:
            fail(f"{path} {key}: the path ran the designs {rec['designs']}")
        maker = {"K1": _shape_encode, "K3": _shape_decode, "K4": _shape_fourstep}[key[0]]
        recs.append(maker(torch, key, rec["launches"], next(iter(rec["designs"])), path))
        torch.cuda.empty_cache()
    return recs


def _tag(shape):
    return "x".join(map(str, shape))


def _dev_randn(torch, shape, seed, iscomplex):
    return torch.randn(shape, dtype=torch.complex64 if iscomplex else torch.float32,
                       device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))


def _shape_ms(torch, fn):
    return cuda_ms(torch, fn, reps=SHAPE_REPS)


def _shape_encode(torch, key, launches, want, path):
    from repro_torch.kernels.exchange import ops as xops, ref as xref

    _, shape, dtype, axis, m, nbatch, codec, guard, scale_div = key
    y = _dev_randn(torch, shape, 21, dtype == "torch.complex64")
    kw = dict(axis=axis, m=m, nbatch=nbatch, codec=codec, guard=guard, scale_div=scale_div)
    name = f"K1 {codec} {path} {shape} axis {axis}"
    (q, s, _), design = _vec(xops.design_launches, lambda: xops.pack_chunks(y, **kw), name, want)
    qr, sr, _ = xref.pack_chunks_ref(y, **kw)
    err = _check_codec(torch, name, q, qr, codec)
    if codec == "int8" and not torch.equal(s, sr):
        fail(f"{name}: scales differ from the plain version")
    del q, s
    wire = 2 if codec == "bf16" else 1
    planes = 2 if y.is_complex() else 1
    scale_bytes = 0 if sr is None else sr.numel() * sr.element_size()
    cast = (_shape_ms(torch, lambda: torch.view_as_real(y).to(torch.bfloat16) if y.is_complex()
                    else y.to(torch.bfloat16)) if codec == "bf16" else None)
    guarded = ",guard" if guard else ""
    return _record(f"exchange_encode[chunk_major,{codec}{guarded},{path},{_tag(shape)},a{axis}]",
                   "exchange.cu", "src/repro/kernels/exchange/kernel.py:89", path, launches,
                   err, _shape_ms(torch, lambda: xops.pack_chunks(y, **kw)),
                   _shape_ms(torch, lambda: xref.pack_chunks_ref(y, **kw)),
                   bound_ms(y.numel() * y.element_size() + planes * y.numel() * wire
                            + scale_bytes, 0), cast, design=design, shape=list(shape))


def _shape_decode(torch, key, launches, want, path):
    from repro_torch.kernels.exchange import ops as xops, ref as xref

    _, pshape, v, w, m, nbatch, codec, iscomplex = key
    block = list(pshape[2:])
    block[v + nbatch] *= m
    y = _dev_randn(torch, block, 22, iscomplex)
    qr, sr, _ = xref.pack_chunks_ref(y, axis=v + nbatch, m=m, nbatch=nbatch, codec=codec)
    elems = y.numel()
    del y
    dkw = dict(v=v, w=w, m=m, nbatch=nbatch, scale=sr, codec=codec, iscomplex=iscomplex)
    name = f"K3 {codec} {path} {pshape} v {v} w {w}"
    got, design = _vec(xops.decode_design_launches, lambda: xops.unpack_chunks(qr, **dkw), name,
                       want)
    err = _check_codec(torch, name, got, xref.unpack_chunks_ref(qr, **dkw), "bf16")
    del got
    scale_bytes = 0 if sr is None else sr.numel() * sr.element_size()
    return _record(f"exchange_decode[scatter_w,{codec},{path},{_tag(pshape)},v{v}w{w}]",
                   "exchange.cu", "src/repro/kernels/exchange/kernel.py:173", path, launches,
                   err, _shape_ms(torch, lambda: xops.unpack_chunks(qr, **dkw)),
                   _shape_ms(torch, lambda: xref.unpack_chunks_ref(qr, **dkw)),
                   bound_ms(qr.numel() * qr.element_size() + scale_bytes
                            + elems * (8 if iscomplex else 4), 0),
                   _shape_ms(torch, lambda: qr.float()) if codec == "bf16" else None,
                   design=design, shape=list(pshape))


def _shape_fourstep(torch, key, launches, want, path):
    from repro_torch.kernels.fft import ops as fops, ref as fref

    _, shape, dtype, inverse, nout, mode = key
    batch, n = shape
    n1, n2 = fops.plan_factors(n)
    rows = _dev_randn(torch, shape, 23, dtype == "torch.complex64")
    if mode == "rfft":
        kern = lambda: fops.rfft_matmul(rows)
        plain = lambda: fref.fourstep_ref(rows.to(torch.complex64), n1, n2)[:, :nout]
        lib = lambda: torch.fft.rfft(rows, dim=-1)
    elif inverse:
        kern = lambda: fops.fft_matmul(rows, inverse=True)
        plain = lambda: fref.fourstep_ref(rows.conj(), n1, n2).conj() / n
        lib = lambda: torch.fft.ifft(rows, dim=-1)
    else:
        kern = lambda: fops.fft_matmul(rows)
        plain = lambda: fref.fourstep_ref(rows, n1, n2)
        lib = lambda: torch.fft.fft(rows, dim=-1)
    if mode not in ("fft", "ifft", "rfft") or (mode != "rfft" and nout != n):
        fail(f"K4 {path} {shape}: no record for mode {mode} with nout {nout}")
    (got, design), wanted = _ran_design(fops.design_launches, kern, f"K4 {path} {shape}"), plain()
    torch.cuda.synchronize()
    err = float((got - wanted).abs().max())
    if err > TOL_K4 * float(wanted.abs().max()) or design != want:
        fail(f"fourstep {mode} {path} at {shape}: max err {err}, design {design} (path: {want})")
    del got, wanted
    nbytes = rows.numel() * rows.element_size() + batch * nout * 8
    if design == "tc":  # three TF32 products a row
        bound = bound_ms(nbytes, batch * 3 * 2.0 * ((2 * n1) ** 2 * n2 + (2 * n2) ** 2 * n1),
                         TF32_TC_FLOPS)
    else:  # fp32 FMA over the general design's own split
        g1, g2 = fref.general_split(n)
        bound = bound_ms(nbytes, batch * (8.0 * n * (g1 + g2) + 6.0 * n))
    return _record(f"fourstep_dft[{mode},{path},{_tag(shape)}]", "fourstep.cu",
                   "src/repro/kernels/fft/kernel.py:87", path, launches, err,
                   _shape_ms(torch, kern), _shape_ms(torch, plain), bound, _shape_ms(torch, lib),
                   design=design, shape=list(shape))


def _many_records(torch, counts):
    """The many path's kernels at its shapes, launches from the many path:
    K4 (tensor-core design) on 3 stacked 512^3 fields' rows; K1 and K3 on 3
    stacked 512^3 fields through an int8 wire (F = 3 scale blocks, field 1
    at 1e3); the bf16 codec at the DNS plan's views, where the rule gives
    the scalar design to the S = 129 side (the first forward exchange's
    encode, the last backward exchange's decode) and vec to the other; and
    K4 at n = DNS_M on the DNS plan's rows: the first forward stage's r2c,
    the next stage's c2c of 3 fields, the 9-field backward's middle ifft
    and its c2r stage."""
    from repro_torch.kernels.exchange import ops as xops, ref as xref
    from repro_torch.kernels.fft import ops as fops, ref as fref

    recs = []
    n = SHAPE_BIG[-1]
    n1, n2 = fops.plan_factors(n)
    rows = torch.randn((3 * n * n, n), dtype=torch.complex64, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(7))
    recs.append(_k4_record(torch, fops, fref, "fft,F3", rows, counts, lambda: fops.fft_matmul(rows),
                           lambda: fref.fourstep_ref(rows, n1, n2),
                           lambda: torch.fft.fft(rows, dim=-1), 2 * rows.numel() * 8))
    del rows
    torch.cuda.empty_cache()

    x3 = torch.randn((3,) + SHAPE_BIG, dtype=torch.complex64, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(6))
    x3[1] *= 1e3
    elems = x3.numel()
    kw = dict(axis=3, m=1, nbatch=1, codec="int8")
    (q, s, _), design = _vec(xops.design_launches, lambda: xops.pack_chunks(x3, **kw),
                             "K1 int8 stacked")
    qr, sr, _ = xref.pack_chunks_ref(x3, **kw)
    err = _check_codec(torch, "pack_chunks int8 stacked", q, qr, "int8")
    if s.shape != (1, 3) or not torch.equal(s, sr):
        fail(f"pack_chunks int8 stacked: scales {tuple(s.shape)} differ from the plain version's")
    del q, s
    recs.append(_record("exchange_encode[chunk_major,int8,F3]", "exchange.cu",
                        "src/repro/kernels/exchange/kernel.py:89", "many",
                        counts.get("pack_chunks:int8", 0), err,
                        cuda_ms(torch, lambda: xops.pack_chunks(x3, **kw)),
                        cuda_ms(torch, lambda: xref.pack_chunks_ref(x3, **kw)),
                        bound_ms(elems * 8 + elems * 2 + 12, 0), None, design=design,
                        shape=list(x3.shape)))
    del x3
    dkw = dict(v=2, w=1, m=1, nbatch=1, scale=sr, codec="int8", iscomplex=True)
    got, design = _vec(xops.decode_design_launches, lambda: xops.unpack_chunks(qr, **dkw),
                       "K3 int8 stacked")
    err = _check_codec(torch, "unpack_chunks int8 stacked", got,
                       xref.unpack_chunks_ref(qr, **dkw), "bf16")
    del got
    recs.append(_record("exchange_decode[scatter_w,int8,F3]", "exchange.cu",
                        "src/repro/kernels/exchange/kernel.py:173", "many",
                        counts.get("unpack_chunks:int8", 0), err,
                        cuda_ms(torch, lambda: xops.unpack_chunks(qr, **dkw)),
                        cuda_ms(torch, lambda: xref.unpack_chunks_ref(qr, **dkw)),
                        bound_ms(elems * 2 + 12 + elems * 8, 0), None, design=design))
    del qr, sr
    torch.cuda.empty_cache()

    # the bf16 codec at the DNS plan's exchanges (a stacked block, M = 1):
    # the first forward exchange (v = 2 -> w = 1) of 3 fields after the r2c
    # stage, the last backward exchange (v = 1 -> w = 2) of 9 fields
    nr = DNS_N // 2 + 1
    for tag, nf, v, w, enc_design, dec_design in (
            ("dns_fwd_first", 3, 2, 1, "scalar", "vec"),
            ("dns_back_last", 9, 1, 2, "vec", "scalar")):
        y = torch.randn((nf, DNS_M, DNS_M, nr), dtype=torch.complex64, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(10 + nf))
        elems = y.numel()
        kw = dict(axis=v + 1, m=1, nbatch=1, codec="bf16")
        (q, _, _), design = _vec(xops.design_launches, lambda kw=kw: xops.pack_chunks(y, **kw),
                                 f"K1 bf16 {tag}", enc_design)
        qr, _, _ = xref.pack_chunks_ref(y, **kw)
        err = _check_codec(torch, f"pack_chunks bf16 {tag}", q, qr, "bf16")
        del q
        recs.append(_record(f"exchange_encode[chunk_major,bf16,{tag}]", "exchange.cu",
                            "src/repro/kernels/exchange/kernel.py:89", "many",
                            counts.get(f"{enc_design}:bf16", 0), err,
                            cuda_ms(torch, lambda kw=kw: xops.pack_chunks(y, **kw)),
                            cuda_ms(torch, lambda kw=kw: xref.pack_chunks_ref(y, **kw)),
                            bound_ms(elems * 8 + elems * 4, 0),
                            cuda_ms(torch, lambda: torch.view_as_real(y).to(torch.bfloat16)),
                            design=design, shape=list(y.shape)))
        del y
        dkw = dict(v=v, w=w, m=1, nbatch=1, scale=None, codec="bf16", iscomplex=True)
        got, design = _vec(xops.decode_design_launches,
                           lambda dkw=dkw: xops.unpack_chunks(qr, **dkw), f"K3 bf16 {tag}",
                           dec_design)
        err = _check_codec(torch, f"unpack_chunks bf16 {tag}", got,
                           xref.unpack_chunks_ref(qr, **dkw), "bf16")
        del got
        recs.append(_record(f"exchange_decode[scatter_w,bf16,{tag}]", "exchange.cu",
                            "src/repro/kernels/exchange/kernel.py:173", "many",
                            counts.get(f"decode:{dec_design}:bf16", 0), err,
                            cuda_ms(torch, lambda dkw=dkw: xops.unpack_chunks(qr, **dkw)),
                            cuda_ms(torch, lambda dkw=dkw: xref.unpack_chunks_ref(qr, **dkw)),
                            bound_ms(elems * 4 + elems * 8, 0), cuda_ms(torch, lambda: qr.float()),
                            design=design))
        del qr
        torch.cuda.empty_cache()

    n = DNS_M
    n1, n2 = fops.plan_factors(n)
    nh = n // 2 + 1

    def c2r_plain(x):  # irfft_matmul's Hermitian extension, then the plain inverse
        full = torch.cat([x, torch.flip(torch.conj(x[:, 1: n - n // 2]), dims=(-1,))], dim=-1)
        return (fref.fourstep_ref(full.conj(), n1, n2).conj() / n).real

    for mode, shape, iscomplex in (("rfft", (3 * n * n, n), False),
                                   ("fft", (3 * n * nr, n), True),
                                   ("ifft", (9 * n * nr, n), True),
                                   ("c2r", (9 * n * n, nh), True)):
        rows = torch.randn(shape, dtype=torch.complex64 if iscomplex else torch.float32,
                           device="cuda", generator=torch.Generator(device="cuda").manual_seed(9))
        if mode == "rfft":
            kern = lambda: fops.rfft_matmul(rows)
            plain = lambda: fref.fourstep_ref(rows.to(torch.complex64), n1, n2)[:, :nh]
            lib = lambda: torch.fft.rfft(rows, dim=-1)
            nbytes = rows.numel() * 4 + shape[0] * nh * 8
        elif mode == "fft":
            kern = lambda: fops.fft_matmul(rows)
            plain = lambda: fref.fourstep_ref(rows, n1, n2)
            lib = lambda: torch.fft.fft(rows, dim=-1)
            nbytes = 2 * rows.numel() * 8
        elif mode == "ifft":
            kern = lambda: fops.fft_matmul(rows, inverse=True)
            plain = lambda: fref.fourstep_ref(rows.conj(), n1, n2).conj() / n
            lib = lambda: torch.fft.ifft(rows, dim=-1)
            nbytes = 2 * rows.numel() * 8
        else:  # the c2r stage: the Hermitian extension and K4's inverse
            kern = lambda: fops.irfft_matmul(rows, n=n)
            plain = lambda: c2r_plain(rows)
            lib = lambda: torch.fft.irfft(rows, n=n, dim=-1)
            nbytes = rows.numel() * 8 + shape[0] * n * 4
        recs.append(_k4_record(torch, fops, fref, f"{mode},dns", rows, counts, kern, plain, lib,
                               nbytes, length=n))
        del rows
    return recs


def _k4_record(torch, fops, fref, tag, rows, counts, kern, plain, lib, nbytes, length=None):
    """K4's record on the many path: one call of ``kern`` on the
    tensor-core design within TOL_K4 of ``plain``; the bound counts the
    design's three TF32 products a row of ``length``."""
    n = length or rows.shape[-1]
    n1, n2 = fops.plan_factors(n)
    (got, design), want = _ran_design(fops.design_launches, kern, "K4"), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if err > TOL_K4 * float(want.abs().max()) or design != "tc":
        fail(f"fourstep {tag} at {tuple(rows.shape)}: max err {err}, design {design}")
    del got, want
    mode = tag.split(",")[0]
    tc_ops = 3 * 2.0 * ((2 * n1) ** 2 * n2 + (2 * n2) ** 2 * n1)
    return _record(f"fourstep_dft[{tag}]", "fourstep.cu", "src/repro/kernels/fft/kernel.py:87",
                   "many", counts.get(f"tc:{'ifft' if mode == 'c2r' else mode}", 0), err,
                   cuda_ms(torch, kern), cuda_ms(torch, plain),
                   bound_ms(nbytes, rows.shape[0] * tc_ops, TF32_TC_FLOPS), cuda_ms(torch, lib),
                   design=design, shape=list(rows.shape))


def _flash_records(torch, paths):
    """K6 at the serving prefills' shapes (launches from the lm, moe, mla,
    hybrid, vlm and audio paths; the mla path's q and k of 192, v of 128;
    the hybrid's 80; the vlm's 7 q heads a kv head over 4096 positions; the
    audio decoder's 64) and at the prefill_32k
    length, bf16, causal, against the plain version (a batch row at a time
    past ``PLAIN_SCORE_BYTES`` of scores; at 32k one q head at a
    time: the whole (S, S) fp32 score matrix of 32 heads would not fit) and
    SDPA (its time and the backend it picks, or its refusal)."""
    from repro_torch.kernels.flash import ops as flops, ref as flref

    recs = []
    for (B, S, Hq, Hkv, dh, dv), path, reduced in K6_SHAPES:
        t0 = time.perf_counter()
        G = Hq // Hkv
        gen = torch.Generator(device="cuda").manual_seed(S)
        q, k, v = (torch.randn((B, S, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for h, d in ((Hq, dh), (Hkv, dh), (Hkv, dv)))
        kern = lambda: flops.flash_attention(q, k, v, causal=True)

        def head(h):  # the plain version of q head h
            return flref.attention_gqa_ref(q[:, :, h:h + 1], k[:, :, h // G:h // G + 1],
                                           v[:, :, h // G:h // G + 1], causal=True)
        shape = (B, S, Hq, Hkv, dh, dv)
        got, design = _ran_design(flops.design_launches, kern, "K6")
        if design != "tc":
            fail(f"flash at {shape}: ran the {design} design")
        if reduced is None:
            by_row = B * Hq * S * S * 4 > PLAIN_SCORE_BYTES
            plain = ((lambda: _plain_by_row(torch, flref, q, k, v)) if by_row
                     else (lambda: flref.attention_gqa_ref(q, k, v, causal=True)))
            err = _check_attention(torch, f"flash at {shape}", got, plain(), v)
        else:
            plain = lambda: [head(h) for h in range(Hq)]
            err = max(_check_attention(torch, f"flash at {shape} head {h}",
                                       got[:, :, h:h + 1].contiguous(), head(h), v)
                      for h in range(Hq))
        del got
        # q . k over dh and p . v over dv for each (query, key) pair of the triangle;
        # q, k, v read once, o written once
        flop = 2.0 * (dh + dv) * B * Hq * S * (S + 1) / 2
        nbytes = 2 * (B * S * Hq * (dh + dv) + B * S * Hkv * (dh + dv))
        reps = 5 if reduced is None else 3
        ms = cuda_ms(torch, kern, reps)
        extra = {"shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "dh": dh, "dv": dv,
                           "dtype": "bf16", "causal": True}, "design": design,
                 "tflops": flop / (ms * 1e9), "one_call_ms": one_call_ms(torch, kern, reps)}
        plain_ms = cuda_ms(torch, plain, reps)
        lib_ms, extra["library"] = _sdpa_ms(torch, q, k, v, True, reps)
        if reduced is not None:
            extra["reduced"] = reduced
        extra["record_s"] = time.perf_counter() - t0
        dims = f",dqk{dh},dv{dv}" if dv != dh else ""
        recs.append(_record(f"flash_attention[causal,bf16,B{B},S{S},Hkv{Hkv}{dims}]", "flash.cu",
                            "src/repro/kernels/flash/kernel.py:80", path,
                            paths[path].get("flash_attention:bfloat16", 0) if path
                            else _launched(paths, "flash_attention:bfloat16"), err, ms, plain_ms,
                            bound_ms(nbytes, flop, BF16_TC_FLOPS), lib_ms, **extra))
        del q, k, v
        torch.cuda.empty_cache()
    return recs


def _plain_by_row(torch, flref, q, k, v):
    """The plain causal attention a batch row at a time."""
    return torch.cat([flref.attention_gqa_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True)
                      for b in range(q.shape[0])])


def _transpose_records(torch, x, paths):
    """K5 at ``K5_BIG``'s 1 GiB complex64 shapes (views of the 512^3 block
    ``x``) against the plain version and the library call; on no path, in
    either package."""
    from repro_torch.kernels.transpose import ops as tops, ref as tref

    recs = []
    for shape, tag in K5_BIG:
        xs = x.view(shape)
        (got, design), want = (_ran_design(tops.design_launches, lambda: tops.transpose01(xs),
                                           "K5", field=1), tref.transpose01_ref(xs))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"transpose01 at {shape}: not bitwise equal to the plain version")
        err = _max_err(torch, got, want)
        del got, want
        recs.append(_record(f"transpose01[complex64{tag}]", "transpose.cu",
                            "src/repro/kernels/transpose/kernel.py:24", None,
                            _launched(paths, "transpose01:complex64"), err,
                            cuda_ms(torch, lambda: tops.transpose01(xs)),
                            cuda_ms(torch, lambda: tref.transpose01_ref(xs)),
                            bound_ms(2 * xs.numel() * 8, 0),
                            cuda_ms(torch, lambda: xs.transpose(0, 1).contiguous()),
                            design=design, shape=list(shape)))
    return recs


def _flash_fp32_record(torch, paths):
    """K6's fp32 design (``flash_kernel``, FMA) at the serving prefill's
    shape in fp32, causal, against the plain version and SDPA in fp32; on
    no path (the serving path is bf16).  Bound: its operations at the fp32
    (non-tensor) peak."""
    from repro_torch.kernels.flash import ops as flops, ref as flref

    (B, S, Hq, Hkv, dh, _), _, _ = K6_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(S + 1)
    q, k, v = (torch.randn((B, S, h, dh), generator=gen, device="cuda") for h in (Hq, Hkv, Hkv))
    kern = lambda: flops.flash_attention(q, k, v, causal=True)
    plain = lambda: flref.attention_gqa_ref(q, k, v, causal=True)
    got, design = _ran_design(flops.design_launches, kern, "K6")
    if design != "fma":
        fail(f"flash fp32 at {(B, S, Hq, Hkv, dh)}: ran the {design} design")
    err = _check_attention(torch, f"flash fp32 at {(B, S, Hq, Hkv, dh)}", got, plain(), v)
    del got
    flop = 4.0 * dh * B * Hq * S * (S + 1) / 2
    nbytes = 4 * (2 * B * S * Hq * dh + 2 * B * S * Hkv * dh)
    ms = cuda_ms(torch, kern, 3)
    lib_ms, lib = _sdpa_ms(torch, q, k, v, True, 3)
    rec = _record(f"flash_attention[causal,f32,B{B},S{S}]", "flash.cu",
                  "src/repro/kernels/flash/kernel.py:80", None,
                  _launched(paths, "flash_attention:float32"), err, ms, cuda_ms(torch, plain, 3),
                  bound_ms(nbytes, flop, FP32_FLOPS), lib_ms, library=lib,
                  shape={"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "dh": dh, "dtype": "f32",
                         "causal": True}, design=design, tflops=flop / (ms * 1e9))
    del q, k, v
    torch.cuda.empty_cache()
    return rec


def _vec(counter, fn, what, want="vec"):
    """``(fn(), want)``; fails unless the kernel ran its ``want`` design
    (K1: ``counter`` is ``xops.design_launches``; K2/K3:
    ``xops.decode_design_launches``)."""
    out, design = _ran_design(counter, fn, what)
    if design != want:
        fail(f"{what}: ran the {design} design, want {want}")
    return out, design


def _composed_records(torch, x, xops, xref, slice_records, counts):
    """The composed path's kernels: K4 at the slice records' shapes (its
    plans transform the same rows), copied with the composed path's
    launches; K1 and K3 with bf16 at the slab's exchange, v = 1 -> w = 0
    over M = 1 at 512^3, against the plain version."""
    recs = []
    for rec in slice_records:
        if rec["name"].startswith("fourstep_dft["):
            mode = rec["name"][len("fourstep_dft["):-1]
            key = "general:fft" if mode == "fft,quickstart" else f"tc:{mode}"
            recs.append({**rec, "name": rec["name"][:-1] + ",composed]", "path": "composed",
                         "launches": counts.get(key, 0)})
    elems = x.numel()
    flat = torch.view_as_real(x)
    enc = lambda: xops.pack_chunks(x, axis=1, m=1, codec="bf16")
    enc_plain = lambda: xref.pack_chunks_ref(x, axis=1, m=1, codec="bf16")
    (q, _, _), design = _ran_design(xops.design_launches, enc, "K1 bf16 composed")
    qr, _, _ = enc_plain()
    err = _check_codec(torch, "pack_chunks bf16 composed", q, qr, "bf16")
    del q
    recs.append(_record("exchange_encode[chunk_major,bf16,composed]", "exchange.cu",
                        "src/repro/kernels/exchange/kernel.py:89", "composed",
                        counts.get("pack_chunks:bf16", 0), err, cuda_ms(torch, enc),
                        cuda_ms(torch, enc_plain), bound_ms(elems * 8 + elems * 4, 0),
                        cuda_ms(torch, lambda: flat.to(torch.bfloat16)), design=design))
    dkw = dict(v=1, w=0, m=1, scale=None, codec="bf16", iscomplex=True)
    dec = lambda: xops.unpack_chunks(qr, **dkw)
    dec_plain = lambda: xref.unpack_chunks_ref(qr, **dkw)
    got, design = _ran_design(xops.decode_design_launches, dec, "K3 bf16 composed")
    err = _check_codec(torch, "unpack_chunks bf16 composed", got, dec_plain(), "bf16")
    del got
    recs.append(_record("exchange_decode[scatter_w,bf16,composed]", "exchange.cu",
                        "src/repro/kernels/exchange/kernel.py:173", "composed",
                        counts.get("unpack_chunks:bf16", 0), err, cuda_ms(torch, dec),
                        cuda_ms(torch, dec_plain), bound_ms(elems * 4 + elems * 8, 0),
                        cuda_ms(torch, lambda: qr.float()), design=design))
    del qr
    return recs


def _pipelined_slice_records(torch, x, xops, xref, counts):
    """K1 and K3 at the pipelined engine's shapes: slice 0 of 4 of the first
    forward exchange (v = 2 -> w = 1, M = 1), ``(512, 512, 1, 128)`` made
    contiguous as the engine makes it, against the plain version."""
    n0, n1, n2 = SHAPE_BIG
    piece = x.reshape(n0, n1, 1, n2).narrow(3, 0, n2 // 4).contiguous()
    elems = piece.numel()
    flat = torch.view_as_real(piece)
    recs = []
    for codec, wire in (("bf16", 2), ("int8", 1)):
        kw = dict(axis=2, m=1, codec=codec)
        enc = lambda kw=kw: xops.pack_chunks(piece, **kw)
        enc_plain = lambda kw=kw: xref.pack_chunks_ref(piece, **kw)
        (q, s, _), design = _vec(xops.design_launches, enc, f"K1 {codec} pipelined slice")
        qr, sr, _ = enc_plain()
        err = _check_codec(torch, f"pack_chunks {codec} pipelined slice", q, qr, codec)
        if codec == "int8" and not torch.equal(s, sr):
            fail("pack_chunks int8 at the pipelined slice: scales differ from the plain version")
        cast = cuda_ms(torch, lambda: flat.to(torch.bfloat16)) if codec == "bf16" else None
        recs.append(_record(f"exchange_encode[chunk_major,{codec},pipelined_slice]",
                            "exchange.cu", "src/repro/kernels/exchange/kernel.py:89", "engines",
                            counts.get(f"pack_chunks:{codec}", 0), err, cuda_ms(torch, enc),
                            cuda_ms(torch, enc_plain), bound_ms(elems * 8 + elems * 2 * wire, 0),
                            cast, design=design))
        del q, s
        dkw = dict(v=2, w=1, m=1, scale=sr, codec=codec, iscomplex=True)
        dec = lambda dkw=dkw: xops.unpack_chunks(qr, **dkw)
        dec_plain = lambda dkw=dkw: xref.unpack_chunks_ref(qr, **dkw)
        got, design = _vec(xops.decode_design_launches, dec, f"K3 {codec} pipelined slice")
        err = _check_codec(torch, f"unpack_chunks {codec} pipelined slice", got, dec_plain(),
                           "bf16")
        del got
        recs.append(_record(f"exchange_decode[scatter_w,{codec},pipelined_slice]",
                            "exchange.cu", "src/repro/kernels/exchange/kernel.py:173", "engines",
                            counts.get(f"unpack_chunks:{codec}", 0), err, cuda_ms(torch, dec),
                            cuda_ms(torch, dec_plain), bound_ms(elems * 2 * wire + elems * 8, 0),
                            cuda_ms(torch, lambda: qr.float()) if codec == "bf16" else None,
                            design=design))
        del qr, sr
    return recs


def _guard_mode_records(torch, x, xops, xref, counts):
    """K1's guard mode at 512^3: payload bitwise equal to the plain
    version's, scales equal, counts equal to an exact count of the plain
    payload, with and without the saturation fault's divisor."""
    xg = x.clone()
    xg.view(-1)[[0, xg.numel() // 3, xg.numel() // 2]] = torch.tensor(
        [float("nan"), float("inf"), -float("inf")], dtype=torch.complex64, device=x.device)
    elems = xg.numel()
    want_nonfinite = int((~torch.isfinite(torch.view_as_real(xg))).sum())
    recs = []
    for codec, wire, sd in (("bf16", 2, None), ("int8", 1, None), ("int8", 1, 64.0)):
        kw = dict(axis=2, m=1, codec=codec, guard=True, scale_div=sd)
        ((q, s, st), design), (qr, sr, _) = (
            _vec(xops.design_launches, lambda kw=kw: xops.pack_chunks(xg, **kw),
                 f"K1 guard {codec} {sd}"),
            xref.pack_chunks_ref(xg, **kw))
        torch.cuda.synchronize()
        if codec == "int8":
            same = torch.equal(q, qr) and torch.equal(s, sr)
            want_sat = int(((qr == 127) | (qr == -127)).sum())
        else:
            same = torch.equal(q.float().nan_to_num(), qr.float().nan_to_num())
            want_sat = 0
        err = _max_err(torch, q, qr, nan_to_num=True)
        # the kernel's counts are exact integers rounded once to f32
        got = (float(st["nonfinite"]), float(st["saturated"]))
        want = (float(torch.tensor(float(want_nonfinite), dtype=torch.float32)),
                float(torch.tensor(float(want_sat), dtype=torch.float32)))
        if not same or got != want:
            fail(f"pack_chunks guard {codec} scale_div={sd} at 512^3: payload equal {same}, "
                 f"counts {got} != exact {want}")
        print(json.dumps({"guard_counts": {"codec": codec, "scale_div": sd, "nonfinite": got[0],
                                           "saturated": got[1], "exact": [want_nonfinite,
                                                                          want_sat]}}))
        del q, s, qr, sr
        tag = f"{codec}{'' if sd is None else ',sat64'}"
        cast = (cuda_ms(torch, lambda: torch.view_as_real(xg).to(torch.bfloat16))
                if codec == "bf16" else None)
        recs.append(_record(f"exchange_encode[chunk_major,{tag},guard]", "exchange.cu",
                            "src/repro/kernels/exchange/kernel.py:89 (guard=True)", "guard",
                            counts.get(f"pack_chunks:{codec}:guard", 0), err,
                            cuda_ms(torch, lambda kw=kw: xops.pack_chunks(xg, **kw)),
                            cuda_ms(torch, lambda kw=kw: xref.pack_chunks_ref(xg, **kw)),
                            bound_ms(elems * 8 + elems * 2 * wire, 0), cast, design=design))
    return recs


def _in_place_decode_records(torch, x, xops, xref, paths):
    """K2 (in-place decode) at the reference fused engine's 512^3 shapes:
    the received payload of the first forward exchange, decoded along w = 1.
    On no path of the port, whose exchanges decode with K3's scatter."""
    recs = []
    elems = x.numel()
    for codec, wire in (("bf16", 2), ("int8", 1)):
        qr, sr, _ = xref.encode_payload_ref(x, axis=2, m=1, codec=codec)
        dkw = dict(axis=1, m=1, scale=sr, codec=codec, iscomplex=True)
        got, design = _vec(xops.decode_design_launches, lambda: xops.decode_payload(qr, **dkw),
                           f"K2 {codec} {SHAPE_BIG}")
        err = _check_codec(torch, f"decode_payload {codec} {SHAPE_BIG}", got,
                           xref.decode_payload_ref(qr, **dkw), "bf16")
        del got
        recs.append(_record(f"exchange_decode[in_place,{codec}]", "exchange.cu",
                            "src/repro/kernels/exchange/kernel.py:144", None,
                            _launched(paths, f"decode_payload:{codec}"), err,
                            cuda_ms(torch, lambda: xops.decode_payload(qr, **dkw)),
                            cuda_ms(torch, lambda: xref.decode_payload_ref(qr, **dkw)),
                            bound_ms(elems * 2 * wire + elems * 8, 0),
                            cuda_ms(torch, lambda: qr.float()) if codec == "bf16" else None,
                            design=design))
        del qr, sr
    return recs


if __name__ == "__main__":
    sys.exit(main())
