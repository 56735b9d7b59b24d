"""LM serving CLI (the port of ``repro/launch/serve_lm.py``): one batched
prefill, then greedy decode steps, with per-phase timings.

  python -m repro_torch.launch.serve_lm --arch glm4_9b --preset full --opt \\
      --batch 4 --prompt-len 2048 --gen 32

Runs on the CUDA card unless ``--device cpu`` is given (and raises without
one).  Weights and prompts are drawn from ``--seed``.  ``--opt`` selects the
optimized flags (the flash kernel K6 in the prefill, the head-major cache);
``--flags`` names single ones as the reference's dry-run does.  One untimed
round of prefill and decode comes first, so that the times are of warm code
(the reference's include its compilation).  ``main(argv)`` returns the
generated ids and the times; ``serve(lm, prompts, n_gen, frontend)`` is its
loop on an ``LM`` built elsewhere (a depth-cut model, say), and
``make_prompts`` and ``make_frontend`` its inputs: the VLM family takes
``n_frontend_tokens`` vision embeddings a prompt, put before its tokens
(the cache and the decode positions count them), the audio family S
frames a prompt for its encoder, both bf16 from ``--seed``, as the
reference draws them.

``--model-parallel N`` serves every family across ranks (dense, MoE with
GQA or MLA, SSM, hybrid, VLM, audio), one process a rank, as the
reference's does: with N > 1, or with ``torch.distributed`` already
initialized, the LM is built on ``launch.mesh.make_host_mesh(N)`` (tensor
and expert parallelism over N ranks of ``"model"``, the Mamba layers'
channels or heads among them, the batch over the world / N ranks of
``"data"``, every cache's positions over ``"model"``; ``models/lm.py``).  Under ``torchrun`` each rank serves on
``cuda:LOCAL_RANK`` over NCCL (``--device cpu``: gloo), draws the same
weights, prompts and frontend from ``--seed`` (the LM keeps its rows of
both), and rank 0 alone prints:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve_lm \\
      --arch llava_next_34b --preset full --opt --model-parallel 4 \\
      --batch 4 --prompt-len 2048 --gen 32
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.meshutil import mesh_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM, OPTIMIZED, PerfFlags

FLAG_MAP = {  # --flags shorthand -> PerfFlags field
    "bf16": {"bf16_attention": True},
    "tri": {"exact_causal_prefill": True},
    "dots": {"remat_policy": "dots"},
    "spres": {"seq_sharded_residual": True},
    "hmaj": {"hmajor_cache": True},
}


def resolve_flags(opt: bool, flags: str) -> PerfFlags:
    if opt:
        return OPTIMIZED
    kw = {}
    for f in (flags or "").split(","):
        f = f.strip()
        if f:
            kw.update(FLAG_MAP[f])
    return PerfFlags(**kw)


@dataclasses.dataclass
class ServeResult:
    ids: torch.Tensor        # (B, gen + 1) generated ids, on the CPU
    prefill_s: float
    decode_s: float
    prompts: torch.Tensor    # (B, prompt_len) on the model's device
    lm: LM
    frontend: torch.Tensor | None = None  # (B, F, D) bf16, the VLM and audio families


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(vocab: int, batch: int, prompt_len: int, device, seed: int) -> torch.Tensor:
    """(batch, prompt_len) random token ids on ``device``, from ``seed + 1``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, vocab, (batch, prompt_len), generator=gen, device=device)


def make_frontend(cfg, batch: int, prompt_len: int, device, seed: int) -> torch.Tensor | None:
    """The frontend's embeddings of the VLM family, (batch,
    ``n_frontend_tokens``, d_model), or the audio family's frames, (batch,
    prompt_len, d_model): bf16 normals on ``device`` from ``seed + 2``; None
    for the other families."""
    if cfg.family not in ("vlm", "audio"):
        return None
    n = cfg.n_frontend_tokens if cfg.family == "vlm" else prompt_len
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    return torch.randn((batch, n, cfg.d_model), generator=gen,
                       device=device).to(torch.bfloat16)


def serve(lm: LM, prompts: torch.Tensor, n_gen: int,
          frontend: torch.Tensor | None = None) -> ServeResult:
    """One untimed round of a batched prefill of ``prompts`` (with the
    ``frontend`` where the family takes one) and ``n_gen`` greedy decode
    steps, then the timed round; prints the reference's three lines.  The
    VLM's frontend tokens take cache positions before the prompt's."""
    cfg, device = lm.cfg, lm.device
    B, S = prompts.shape
    batch = {"tokens": prompts}
    if frontend is not None:
        batch["frontend"] = frontend
    off = frontend.shape[1] if cfg.family == "vlm" else 0
    M = S + off + n_gen

    def one_round():
        t0 = time.perf_counter()
        cache, logits = lm.prefill(batch, max_len=M)
        tok = logits[:, -1, :cfg.vocab].argmax(-1)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for step in range(n_gen):
            cache, logits = lm.decode_step(cache, tok, S + off + step)
            tok = logits[:, :cfg.vocab].argmax(-1)
            out.append(tok)
        _sync(device)
        return torch.stack(out, dim=1).cpu(), t_prefill, time.perf_counter() - t0

    one_round()  # warm-up
    ids, t_prefill, t_decode = one_round()
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"arch={cfg.name} batch={B} prompt={S} gen={n_gen}")
        print(f"prefill: {t_prefill:.3f}s ({B * S / t_prefill:.0f} tok/s)  "
              f"decode: {t_decode:.3f}s ({B * n_gen / max(t_decode, 1e-9):.0f} tok/s)")
        print("sample generated ids:", ids[0][:12].tolist())
    return ServeResult(ids, t_prefill, t_decode, prompts, lm, frontend)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--opt", action="store_true", help="all optimized flags")
    ap.add_argument("--flags", default="", help=f"comma list of {sorted(FLAG_MAP)}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of the mesh's \"model\" axis (tensor and expert parallelism; "
                         "every family but ssm and hybrid)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve_lm runs on a CUDA card and none is available; "
                           "pass --device cpu to run on the CPU")
    cfg = configs.smoke(args.arch) if args.preset == "smoke" else configs.get(args.arch)
    mesh, started = None, False
    if args.model_parallel > 1 or dist.is_initialized():
        if not dist.is_initialized():  # torchrun's environment names the rank
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
            started = True
        mesh = make_host_mesh(args.model_parallel, device=device.type)
        device = mesh_device(mesh)
    try:
        lm = LM(cfg, mesh=mesh, q_block=min(512, args.prompt_len),
                perf=resolve_flags(args.opt, args.flags), device=device, seed=args.seed)
        prompts = make_prompts(cfg.vocab, args.batch, args.prompt_len, device, args.seed)
        return serve(lm, prompts, args.gen,
                     make_frontend(cfg, args.batch, args.prompt_len, device, args.seed))
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
