"""ctypes binding of the flash-attention kernel (``csrc/flash.cu``).
The library is built and loaded at the first launch, never at import."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build

_c = ctypes.c_void_p
_i = ctypes.c_int

#: (query/key head dim, value head dim) pairs the kernel is compiled for:
#: one head dim for q, k and v (Zamba2's 80 among them), and MLA's 192 for
#: q and k beside 128 for v
PAIRS = ((16, 16), (32, 32), (64, 64), (80, 80), (128, 128), (160, 160), (192, 128))
#: the query/key head dims among them
HEAD_DIMS = tuple(dqk for dqk, _ in PAIRS)


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash")
    lib.flash_attention_fwd.argtypes = [_c, _c, _c, _c] + [_i] * 9 + [_c]
    lib.flash_attention_fwd.restype = _i
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Attention of CUDA (B, Sq, Hq, dqk) queries over (B, Skv, Hkv, dqk)
    keys and (B, Skv, Hkv, dv) values, all float32 (the FMA design) or all
    bfloat16 (the tensor-core design), into a new (B, Sq, Hq, dv) tensor of
    v's dtype.  Non-contiguous or misaligned inputs are copied.  A pair of
    head dims not in ``PAIRS`` raises before anything is built."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if (dqk, dv) not in PAIRS:
        raise ValueError(f"flash_attention has no kernel for head dims (q/k {dqk}, v {dv}) "
                         f"(has {PAIRS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dim() != 4:
            raise ValueError(f"flash_attention needs 4-D CUDA tensors, got {name} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v of one "
                             f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, Hq, _ = q.shape
    _, Skv, Hkv, _ = k.shape
    if (k.shape != (B, Skv, Hkv, dqk) or v.shape != (B, Skv, Hkv, dv) or Hq % Hkv
            or Skv < 1):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, S, H, d) GQA tensors")
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    o = torch.empty((B, Sq, Hq, dv), dtype=v.dtype, device=v.device)
    rc = _lib().flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    B, Sq, Skv, Hq, Hkv, dqk, dv, int(causal),
                                    int(q.dtype == torch.bfloat16),
                                    torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd failed with CUDA error {rc} at q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                           f"{q.dtype}")
    return o
