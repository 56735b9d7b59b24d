#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in one process (any failed check raises and the script exits
non-zero):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, started together) and print the card's name and power limit;
2. every kernel mode against its plain torch version on seeded inputs, with
   CUDA-event times (one ``{"kernel_sweep": [...]}`` line);
3. the port's main path on a 1-rank NCCL group and a (1, 1) mesh:
   (a) the quickstart plan ``(42, 63, 64)``, ``method="fused"``, against
   ``np.fft.fftn``; (b) the slice configuration (``impl="matmul"``,
   ``exchange_impl="cuda"``, ``comm_dtype="bf16"``) at ``(42, 63, 64)`` and at
   512^3 complex64, forward and backward timed; (c) 512^3 with int8;
4. the kernels of the main path at its 512^3 shapes: launches counted over
   phase 3, error against the plain version, kernel / plain / library times
   and the bound (one ``{"kernels": [...]}`` line), then the result line.

Without a CUDA device, or outside a checkout of the repository, it prints no
result and exits non-zero.
"""

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, fp32 (non-tensor) flop/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12

TOL_K4 = 1e-5          # max |kernel - plain| / max |plain|, f32 FMA in another order
SHAPE_BIG = (512, 512, 512)
SHAPE_QS = (42, 63, 64)
# relative L2 of the 512^3 forward vs torch.fft.fftn, and of the round trip:
# one bf16 rounding of normal data is 1.7e-3, the forward rounds twice and
# the round trip four times; int8 with one scale per block of 2^28 values
# (max ~6.2 sigma) is ~1.4e-2 per rounding
TOL_FWD = {"bf16": 3e-3, "int8": 3e-2}
TOL_BACK = {"bf16": 5e-3, "int8": 4e-2}


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def cuda_ms(torch, fn, reps=5):
    """Median of ``reps`` CUDA-event times of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, flops):
    """Least time for ``nbytes`` of HBM traffic and ``flops`` fp32 operations."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main():
    import torch

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

    from repro_torch import _build

    t0 = time.perf_counter()
    logs = _build.build(["fourstep", "exchange"])
    print(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    sweep = kernel_sweep(torch)
    print(json.dumps({"kernel_sweep": sweep}))

    counts = plan_phase(torch)

    kernels = main_path_kernels(torch, counts)
    print(json.dumps({"kernels": kernels}))
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


def _check_codec(torch, name, got, want, codec):
    """bf16 (and any decode of one payload): bitwise; int8 payloads within
    one quantum, i.e. 1 in q.  Returns the max abs error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if codec == "bf16" and not torch.equal(got, want):
        fail(f"{name}: bf16 not bitwise equal to the plain version (max err {err})")
    if codec == "int8" and err > 1.0:
        fail(f"{name}: int8 payload {err} quanta from the plain version")
    return err


def kernel_sweep(torch):
    from repro_torch.kernels.exchange import ops as xops, ref as xref
    from repro_torch.kernels.fft import ops as fops, ref as fref

    out = []
    for n in (42, 63, 64, 256, 512):
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
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err > TOL_K4 * float(want.abs().max()):
                fail(f"fourstep {mode} n={n}: max err {err} above {TOL_K4} of max |y|")
            out.append({"name": f"fourstep:{mode}:n{n}", "max_abs_err": err,
                        "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                        "library_ms": cuda_ms(torch, lib)})

    # complex64 blocks over F, M and both scatter orders, and two float32
    # blocks (one plane, as an r2c plan's real stages ship)
    cases = [(F, M, vw, True) for F in (1, 3) for M in (1, 4) for vw in ((0, 2), (2, 0))]
    cases += [(1, 4, (2, 0), False), (3, 4, (0, 2), False)]
    for codec in ("bf16", "int8"):
        for F, M, (v, w), iscomplex in cases:
            nb = 1 if F > 1 else 0
            shape = ((F,) if nb else ()) + (64, 48, 40)
            y = _randn(torch, shape, 7 * F + M + v, iscomplex)
            tag = (f"{codec}:F{F}:M{M}:{'w>v' if w > v else 'w<v'}"
                   f"{'' if iscomplex else ':f32'}")
            out += _exchange_modes(torch, xops, xref, y, codec, v, w, v + nb, M, nb, tag)
    return out


def _exchange_modes(torch, xops, xref, y, codec, v, w, bv, M, nb, tag):
    """Both encode layouts and both decode layouts of one block ``y``."""
    iscomplex = y.is_complex()
    kw = dict(m=M, nbatch=nb, codec=codec)
    recs = []

    def rec(name, replaces, err, kern, plain, lib):
        recs.append({"name": f"{name}:{tag}", "replaces": replaces, "max_abs_err": err,
                     "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                     "library_ms": cuda_ms(torch, lib) if lib is not None else None})

    flat = torch.view_as_real(y) if iscomplex else y
    cast = (lambda: flat.to(torch.bfloat16)) if codec == "bf16" else None
    for wrapper, plain_fn, replaces in (
            (xops.pack_chunks, xref.pack_chunks_ref, "kernel.py:89 (pack=True)"),
            (xops.encode_payload, xref.encode_payload_ref, "kernel.py:89")):
        q, s = wrapper(y, axis=bv, **kw)
        qr, sr = plain_fn(y, axis=bv, **kw)
        err = _check_codec(torch, f"{wrapper.__name__}:{tag}", q, qr, codec)
        if codec == "int8" and not torch.equal(s, sr):
            fail(f"{wrapper.__name__}:{tag}: int8 scales differ from the plain version")
        rec(f"encode:{wrapper.__name__}", replaces, err,
            lambda wrapper=wrapper: wrapper(y, axis=bv, **kw),
            lambda plain_fn=plain_fn: plain_fn(y, axis=bv, **kw), cast)

    qr, sr = xref.pack_chunks_ref(y, axis=bv, **kw)
    dkw = dict(v=v, w=w, scale=sr, iscomplex=iscomplex, **kw)
    got = xops.unpack_chunks(qr, **dkw)
    want = xref.unpack_chunks_ref(qr, **dkw)
    err = _check_codec(torch, f"unpack_chunks:{tag}", got, want, "bf16")
    widen = (lambda: qr.float()) if codec == "bf16" else None
    rec("decode:unpack_chunks", "kernel.py:173", err, lambda: xops.unpack_chunks(qr, **dkw),
        lambda: xref.unpack_chunks_ref(qr, **dkw), widen)

    qr, sr = xref.encode_payload_ref(y, axis=bv, **kw)
    dkw = dict(axis=bv, scale=sr, iscomplex=iscomplex, **kw)
    got = xops.decode_payload(qr, **dkw)
    want = xref.decode_payload_ref(qr, **dkw)
    err = _check_codec(torch, f"decode_payload:{tag}", got, want, "bf16")
    widen = (lambda: qr.float()) if codec == "bf16" else None
    rec("decode:decode_payload", "kernel.py:144", err, lambda: xops.decode_payload(qr, **dkw),
        lambda: xref.decode_payload_ref(qr, **dkw), widen)
    return recs


# ---------------------------------------------------------------------------
# phase 3: the main path on the card
# ---------------------------------------------------------------------------


def plan_phase(torch):
    """Drive the plans; returns the kernel launch counts of this phase."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.core.meshutil import make_mesh
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig
    from repro_torch.kernels.exchange import ops as xops
    from repro_torch.kernels.fft import ops as fops

    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    try:
        dist.init_process_group("nccl", init_method=f"file://{pg_dir}/pg", rank=0, world_size=1)
        mesh = make_mesh((1, 1), ("p0", "p1"))
        slice_cfg = PlanConfig(method="fused", impl="matmul", exchange_impl="cuda",
                               comm_dtype="bf16")

        fops.launches.clear()
        xops.launches.clear()

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
            _run_plan(torch, mesh, shape, cfg, ParallelFFT, fops, xops)
        counts = {**fops.launches, **xops.launches}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    return counts


def _run_plan(torch, mesh, shape, cfg, ParallelFFT, fops, xops):
    plan = ParallelFFT(mesh, shape, ("p0", "p1"), config=cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, dtype=torch.complex64, device="cuda", generator=gen)
    ref = torch.fft.fftn(x)
    k4, enc, dec = (sum(fops.launches.values()), xops.launches[f"pack_chunks:{cfg.comm_dtype}"],
                    xops.launches[f"unpack_chunks:{cfg.comm_dtype}"])
    y = plan.forward_padded(x)
    torch.cuda.synchronize()
    per_fwd = {"fourstep": sum(fops.launches.values()) - k4,
               "encode": xops.launches[f"pack_chunks:{cfg.comm_dtype}"] - enc,
               "decode": xops.launches[f"unpack_chunks:{cfg.comm_dtype}"] - dec}
    # two exchanges per 3-D pencil forward; an int8 encode is two kernel launches
    want = {"fourstep": 3, "encode": 2 * xops.ENCODE_KERNELS[cfg.comm_dtype], "decode": 2}
    if per_fwd != want:
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
                      "launches_per_forward": per_fwd,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}))


# ---------------------------------------------------------------------------
# phase 4: the main path's kernels at its 512^3 shapes
# ---------------------------------------------------------------------------


def main_path_kernels(torch, counts):
    from repro_torch.kernels.exchange import ops as xops, ref as xref
    from repro_torch.kernels.fft import ops as fops, ref as fref

    n = SHAPE_BIG[-1]
    n1, n2 = fops.plan_factors(n)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(SHAPE_BIG, dtype=torch.complex64, device="cuda", generator=gen)
    rows = x.reshape(-1, n)
    batch = rows.shape[0]
    kernels = []

    k4_flops = batch * (8.0 * n * (n1 + n2) + 6.0 * n)
    k4_bytes = 2 * rows.numel() * 8
    for mode, kern, plain, lib in (
            ("fft", lambda: fops.fft_matmul(rows), lambda: fref.fourstep_ref(rows, n1, n2),
             lambda: torch.fft.fft(rows, dim=-1)),
            ("ifft", lambda: fops.fft_matmul(rows, inverse=True),
             lambda: fref.fourstep_ref(rows.conj(), n1, n2).conj() / n,
             lambda: torch.fft.ifft(rows, dim=-1))):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err > TOL_K4 * float(want.abs().max()):
            fail(f"fourstep {mode} at {SHAPE_BIG}: max err {err}")
        del got, want
        b, by = bound_ms(k4_bytes, k4_flops)
        kernels.append({"name": f"fourstep_dft[{mode}]", "route": "cuda",
                        "source": "src/repro_torch/csrc/fourstep.cu",
                        "replaces": "src/repro/kernels/fft/kernel.py:87",
                        "launches": counts.get(mode, 0), "max_abs_err": err,
                        "ms": cuda_ms(torch, kern), "plain_ms": cuda_ms(torch, plain),
                        "bound_ms": b, "bound_by": by, "library_ms": cuda_ms(torch, lib)})

    # the first forward exchange: v = 2 -> w = 1 over a group of 1
    v, w, m = 2, 1, 1
    elems = x.numel()
    for codec, wire in (("bf16", 2), ("int8", 1)):
        enc = lambda: xops.pack_chunks(x, axis=v, m=m, codec=codec)
        enc_plain = lambda: xref.pack_chunks_ref(x, axis=v, m=m, codec=codec)
        (q, s), (qr, sr) = enc(), enc_plain()
        err = _check_codec(torch, f"pack_chunks {codec} {SHAPE_BIG}", q, qr, codec)
        if codec == "int8" and not torch.equal(s, sr):
            fail("pack_chunks int8 at 512^3: scales differ from the plain version")
        flat = torch.view_as_real(x)
        b, by = bound_ms(elems * 8 + elems * 2 * wire, 0)
        kernels.append({"name": f"exchange_encode[chunk_major,{codec}]", "route": "cuda",
                        "source": "src/repro_torch/csrc/exchange.cu",
                        "replaces": "src/repro/kernels/exchange/kernel.py:89",
                        "launches": counts.get(f"pack_chunks:{codec}", 0), "max_abs_err": err,
                        "ms": cuda_ms(torch, enc), "plain_ms": cuda_ms(torch, enc_plain),
                        "bound_ms": b, "bound_by": by,
                        "library_ms": (cuda_ms(torch, lambda: flat.to(torch.bfloat16))
                                       if codec == "bf16" else None)})
        del q, s
        dkw = dict(v=v, w=w, m=m, scale=sr, codec=codec, iscomplex=True)
        dec = lambda: xops.unpack_chunks(qr, **dkw)
        dec_plain = lambda: xref.unpack_chunks_ref(qr, **dkw)
        err = _check_codec(torch, f"unpack_chunks {codec} {SHAPE_BIG}", dec(), dec_plain(), "bf16")
        b, by = bound_ms(elems * 2 * wire + elems * 8, 0)
        kernels.append({"name": f"exchange_decode[scatter_w,{codec}]", "route": "cuda",
                        "source": "src/repro_torch/csrc/exchange.cu",
                        "replaces": "src/repro/kernels/exchange/kernel.py:173",
                        "launches": counts.get(f"unpack_chunks:{codec}", 0), "max_abs_err": err,
                        "ms": cuda_ms(torch, dec), "plain_ms": cuda_ms(torch, dec_plain),
                        "bound_ms": b, "bound_by": by,
                        "library_ms": (cuda_ms(torch, lambda: qr.float())
                                       if codec == "bf16" else None)})
        del qr, sr
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was never launched on the main path")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
