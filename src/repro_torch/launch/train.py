"""Training CLI (the port of ``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch glm4_9b --preset smoke --steps 20 --device cpu
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch glm4_9b --preset smoke \\
      --steps 20 --device cpu

``--preset smoke`` trains the reduced config of the family, ``--preset
full`` the published one (seq 4096, batch 256 unless given).  The run is
the port's ``Trainer`` (``runtime/trainer.py``): atomic and async
checkpoints in ``--ckpt-dir`` (a resumed run continues from the newest),
SIGTERM-clean preemption, the heartbeat log with its straggler events.  It
runs on the CUDA card unless ``--device cpu`` is given, and raises without
one.  Under ``torchrun`` the ranks train data-parallel (``launch/mesh.
make_host_mesh``, ``"data"`` the world, each rank on ``cuda:LOCAL_RANK``
over NCCL, or gloo with ``--device cpu``); rank 0 alone prints.  Every
family trains (``--arch`` any of ``configs.ARCH_NAMES``): the VLM's batches
carry its ``n_frontend_tokens`` seeded frontend embeddings and the audio
family's ``--seq`` seeded frames (``data_for``).  ``--model-parallel N``
and ``--sp-mode ulysses`` train the dense family on a ``(world / N, N)``
mesh (``LM(cfg, mesh=make_host_mesh(N), sp_mode=)``: tensor parallelism
over ``"model"``, Ulysses sequence parallelism inside the attention; a
lone process trains on a one-rank group) and raise for every other family
(ROADMAP §1):

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch glm4_9b --preset smoke \
      --model-parallel 2 --sp-mode ulysses --device cpu

``main(argv)`` returns the history of the run.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.meshutil import default_group, mesh_device
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM
from repro_torch.runtime import TrainConfig, Trainer


def under_ranks() -> bool:
    """Whether the process is one rank of several (an initialized group, or
    ``torchrun``'s environment)."""
    return dist.is_initialized() or ("WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ)


def data_for(cfg, seq: int, global_batch: int) -> SyntheticLMData:
    """The seeded token stream of ``cfg``'s family: with frontend
    embeddings before the tokens for the VLM (``n_frontend_tokens`` a row)
    and ``seq`` frames a row for the audio encoder."""
    n = {"vlm": cfg.n_frontend_tokens, "audio": seq}.get(cfg.family)
    return SyntheticLMData(vocab=cfg.vocab, seq_len=seq, global_batch=global_batch,
                           frontend=None if n is None else (n, cfg.d_model))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--sp-mode", default="none", choices=["none", "ulysses"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.preset == "smoke" else configs.get(args.arch)
    on_mesh = args.model_parallel > 1 or args.sp_mode == "ulysses"
    if on_mesh and cfg.family != "dense":
        raise NotImplementedError(f"--model-parallel {args.model_parallel} --sp-mode "
                                  f"{args.sp_mode}: tensor- and sequence-parallel training of "
                                  f"the {cfg.family!r} family is not ported yet (ROADMAP §1); "
                                  "the dense family's is")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train runs on a CUDA card and none is available; "
                           "pass --device cpu to run on the CPU")
    seq = args.seq or (32 if args.preset == "smoke" else 4096)
    gbs = args.global_batch or (4 if args.preset == "smoke" else 256)
    ranks = under_ranks() or on_mesh
    with default_group(device.type) if ranks else contextlib.nullcontext():
        mesh = make_host_mesh(args.model_parallel, device=device.type) if ranks else None
        # an LM on the mesh, or a mesh-less one (data-parallel where ranks run)
        kw = ({"mesh": mesh, "sp_mode": args.sp_mode, "device": device.type} if on_mesh
              else {"device": mesh_device(mesh) if mesh is not None else device})
        lm = LM(cfg, q_block=min(512, seq), xent_chunks=min(8, seq), **kw)
        data = data_for(cfg, seq, gbs)
        tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                                f"repro_torch_train_{args.arch}"),
                         lr=args.lr, warmup=max(2, args.steps // 10))
        trainer = Trainer(lm, data, tc, mesh=mesh)

        def log(m):
            if trainer.lead:
                print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                      f"gnorm {m['grad_norm']:.2f}  {m['time']:.2f}s", flush=True)

        _, _, hist = trainer.run(on_metrics=log)
        if trainer.lead and hist:
            print(f"trained {len(hist)} steps; loss {hist[0]['loss']:.3f} -> "
                  f"{hist[-1]['loss']:.3f}")
    return hist


if __name__ == "__main__":
    main()
