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
generated ids and the times; ``serve(lm, prompts, n_gen)`` is its loop on
an ``LM`` built elsewhere (a depth-cut model, say), and ``make_prompts`` its
prompts.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
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


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(vocab: int, batch: int, prompt_len: int, device, seed: int) -> torch.Tensor:
    """(batch, prompt_len) random token ids on ``device``, from ``seed + 1``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, vocab, (batch, prompt_len), generator=gen, device=device)


def serve(lm: LM, prompts: torch.Tensor, n_gen: int) -> ServeResult:
    """One untimed round of a batched prefill of ``prompts`` and ``n_gen``
    greedy decode steps, then the timed round; prints the reference's three
    lines."""
    cfg, device = lm.cfg, lm.device
    B, S = prompts.shape
    M = S + n_gen

    def one_round():
        t0 = time.perf_counter()
        cache, logits = lm.prefill({"tokens": prompts}, max_len=M)
        tok = logits[:, -1, :cfg.vocab].argmax(-1)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for step in range(n_gen):
            cache, logits = lm.decode_step(cache, tok, S + step)
            tok = logits[:, :cfg.vocab].argmax(-1)
            out.append(tok)
        _sync(device)
        return torch.stack(out, dim=1).cpu(), t_prefill, time.perf_counter() - t0

    one_round()  # warm-up
    ids, t_prefill, t_decode = one_round()
    print(f"arch={cfg.name} batch={B} prompt={S} gen={n_gen}")
    print(f"prefill: {t_prefill:.3f}s ({B * S / t_prefill:.0f} tok/s)  "
          f"decode: {t_decode:.3f}s ({B * n_gen / max(t_decode, 1e-9):.0f} tok/s)")
    print("sample generated ids:", ids[0][:12].tolist())
    return ServeResult(ids, t_prefill, t_decode, prompts, lm)


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
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve_lm runs on a CUDA card and none is available; "
                           "pass --device cpu to run on the CPU")
    cfg = configs.smoke(args.arch) if args.preset == "smoke" else configs.get(args.arch)
    lm = LM(cfg, q_block=min(512, args.prompt_len), perf=resolve_flags(args.opt, args.flags),
            device=device, seed=args.seed)
    prompts = make_prompts(cfg.vocab, args.batch, args.prompt_len, device, args.seed)
    return serve(lm, prompts, args.gen)


if __name__ == "__main__":
    main()
