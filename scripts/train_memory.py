"""Where a training step's device memory goes, on the card: an arch at full
width (GLM-4-9B unless ``--arch`` names another), a few layers, 4 x 2048
tokens, each remat policy.

  python scripts/train_memory.py [--arch glm4_9b] [--layers 2,4]
                                 [--policies none,full,dots] [--trainer-steps N]

The layers count the MoE family's leading dense layers (DeepSeek-V2-Lite:
``--layers 2,4`` is the dense layer and 1 or 3 expert layers).

Prints one JSON line a (policy, depth): the memory allocated after the
model and its moments are built, after the loss's forward (what the
backward will read: the saved activations), the peak of the forward, of
the backward and of the optimizer's update, in GiB, beside the card's name
and power limit; with ``--trainer-steps N``, the ``Trainer``'s own N steps
at each depth ("dots"), each step's peak and seconds.  The difference
between two depths is a layer's share.  The VLM's and the audio family's
batches carry their frontend embeddings (``launch.train.data_for``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch.train import data_for  # noqa: E402
from repro_torch.models.lm import LM, OPTIMIZED  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

GIB = 2**30


def measure(layers: int, policy: str, batch: int, seq: int, arch: str = "glm4_9b") -> dict:
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    lm = LM(cfg, q_block=min(512, seq), xent_chunks=min(8, seq),
            perf=dataclasses.replace(OPTIMIZED, remat_policy=policy), device="cuda")
    params = lm.trainable_params()
    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    data = {k: v.cuda() for k, v in data_for(cfg, seq, batch).batch(0).items()}
    torch.cuda.synchronize()
    out = {"arch": arch, "layers": layers, "policy": policy,
           "built": torch.cuda.memory_allocated() / GIB}
    torch.cuda.reset_peak_memory_stats()
    loss, _ = lm.loss(data)
    torch.cuda.synchronize()
    out["after_forward"] = torch.cuda.memory_allocated() / GIB
    out["forward_peak"] = torch.cuda.max_memory_allocated() / GIB
    torch.cuda.reset_peak_memory_stats()
    loss.backward()
    torch.cuda.synchronize()
    out["backward_peak"] = torch.cuda.max_memory_allocated() / GIB
    out["after_backward"] = torch.cuda.memory_allocated() / GIB
    torch.cuda.reset_peak_memory_stats()
    opt.update({k: p.grad for k, p in params.items()}, state, params)
    torch.cuda.synchronize()
    out["update_peak"] = torch.cuda.max_memory_allocated() / GIB
    del lm, params, state, loss, data
    torch.cuda.empty_cache()
    return out


def measure_trainer(layers: int, batch: int, seq: int, steps: int,
                    arch: str = "glm4_9b") -> list[dict]:
    """The Trainer's own steps (``train_step``), "dots": the memory allocated
    and the peak of each step, in GiB."""
    import tempfile

    from repro_torch.runtime import TrainConfig, Trainer

    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    lm = LM(cfg, q_block=min(512, seq), xent_chunks=min(8, seq), perf=OPTIMIZED, device="cuda")
    data = data_for(cfg, seq, batch)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(lm, data, TrainConfig(steps=steps, ckpt_dir=d))
        params, opt, _ = tr.init_state()
        out = []
        for step in range(steps):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt, _ = tr.train_step(params, opt, tr.stage_batch(step))
            torch.cuda.synchronize()
            out.append({"arch": arch, "layers": layers, "trainer_step": step,
                        "seconds": time.perf_counter() - t0,
                        "allocated": torch.cuda.memory_allocated() / GIB,
                        "peak": torch.cuda.max_memory_allocated() / GIB})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--layers", default="2,4")
    ap.add_argument("--policies", default="none,full,dots")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--trainer-steps", type=int, default=0,
                    help="also run the Trainer's own steps at each depth")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_memory: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for policy in args.policies.split(","):
        for layers in map(int, args.layers.split(",")):
            print(json.dumps({"train_memory": {
                **measure(layers, policy, args.batch, args.seq, args.arch), "card": card}}),
                flush=True)
    for layers in map(int, args.layers.split(",")) if args.trainer_steps else ():
        for rec in measure_trainer(layers, args.batch, args.seq, args.trainer_steps, args.arch):
            print(json.dumps({"train_memory": {**rec, "card": card}}), flush=True)


if __name__ == "__main__":
    main()
