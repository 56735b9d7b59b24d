"""Serve an LM across ranks and report each rank's peak device memory.

  torchrun --nproc-per-node 4 scripts/serve_lm_ranks.py --arch llava_next_34b \\
      --preset full --opt --model-parallel 4 --batch 4 --prompt-len 2048 --gen 32

Starts the process group (NCCL, one card a rank by ``LOCAL_RANK``; gloo with
``--device cpu``), runs ``repro_torch.launch.serve_lm.main`` with the
arguments given (rank 0 prints its three lines), then prints on rank 0 one
JSON line: each rank's peak allocated device memory in GiB (the CPU's:
null) and the card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.launch import serve_lm  # noqa: E402


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    known = argparse.ArgumentParser(add_help=False)
    known.add_argument("--device", default="cuda")
    cuda = known.parse_known_args(argv)[0].device != "cpu"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo")
    try:
        res = serve_lm.main(argv)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, peak)
        if dist.get_rank() == 0:
            card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True,
                                   text=True).stdout.strip().splitlines() if cuda else [])
            print(json.dumps({"arch": res.lm.cfg.name, "mesh": [res.lm.shard.dp, res.lm.shard.tp],
                              "prefill_s": res.prefill_s, "decode_s": res.decode_s,
                              "max_memory_allocated_gib": peaks, "cards": card}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
