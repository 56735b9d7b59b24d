"""Train an LM across ranks and report each rank's step time and peak memory.

  torchrun --nproc-per-node 4 scripts/train_ranks.py --arch glm4_9b \\
      --model-parallel 4 --sp-mode ulysses --seq-sharded-residual --layers 40 --steps 4 \\
      --checkpoint

Starts the process group (NCCL, one card a rank by ``LOCAL_RANK``) and
runs ``chip_smoke._train_at_width`` on every rank: ``LM(cfg, mesh=
make_host_mesh(N), sp_mode=)`` of the published config cut to
``--layers`` (seeded weights, "dots" remat, fp32 attention), ``--steps``
steps of ``repro_torch.runtime.Trainer`` on chip_smoke's 4 x 2048 tokens
of the seeded stream at lr 3e-4, the collectives of each step against
``LM.collectives_per_step(trainer=True)``; with ``--checkpoint`` the
Trainer's final checkpoint (whole leaves, written by rank 0), then a
second Trainer on a fresh LM that restores it (each rank's state checked
bitwise against the saved one) and takes one more step.  Rank 0 prints
one JSON line: chip_smoke's record (losses, grad norms, step seconds,
tokens/s, the checkpoint's seconds and bytes), each rank's peak allocated
device memory in GiB by phase, and the cards' name and power limit as
``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.lm import PerfFlags  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--sp-mode", default="none", choices=["none", "ulysses"])
    ap.add_argument("--seq-sharded-residual", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--checkpoint", action="store_true")
    args = ap.parse_args(argv)
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl")
    try:
        mesh = make_host_mesh(args.model_parallel)
        rec = chip_smoke._train_at_width(
            torch, args.arch, args.layers, args.steps, checkpoint=args.checkpoint,
            perf=PerfFlags(remat_policy="dots", seq_sharded_residual=args.seq_sharded_residual),
            lm_kw={"mesh": mesh, "sp_mode": args.sp_mode}, why="the call's time")
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, rec["peak_gib_by_phase"])
        if dist.get_rank() == 0:
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip().splitlines()
            print(json.dumps({**rec, "peak_gib_by_rank": peaks, "cards": card}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
