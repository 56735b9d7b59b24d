"""The port's flash attention (K6) against the reference's, on the CPU.

The port's wrapper takes its plain version for CPU tensors; the reference's
runs its Pallas kernel in interpret mode.  Inputs come from numpy seeds.
fp32 is held to ``tests/test_flash.py``'s own 2e-4.  bf16: the reference's
kernel rounds p to bf16 before p . v and the plain version does not, and
both round their fp32 result to bf16 once; so |got - want| <= 2^-7 |want|
(one bf16 ulp, a rounding that fell the other way) + 2^-8 max|v| (twice the
bound 2^-9 max|v| of p's rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.ops import flash_attention as ref_flash
from repro_torch.kernels.flash import ops, ref

# tests/test_flash.py's cases: (B, S, Hq, Hkv, dh, block_q, block_k, causal)
CASES = [
    (2, 64, 4, 2, 16, 16, 16, True),
    (1, 48, 2, 2, 8, 16, 16, True),
    (2, 32, 4, 1, 16, 8, 8, True),      # MQA
    (1, 64, 2, 2, 16, 32, 32, False),
    (1, 50, 2, 2, 16, 16, 16, True),    # ragged: the reference pads q and kv
    (1, 64, 8, 2, 32, 64, 16, True),    # uneven blocks
    (1, 48, 4, 4, 80, 16, 16, True),    # Zamba2's head dim, 4 of its 32 heads
]


def _inputs(B, S, Hq, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, dh)).astype(np.float32))


def bf16_limit(want: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Elementwise bf16 limit of the module docstring."""
    return 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * float(np.abs(v).max())


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,bq,bk,causal", CASES)
def test_flash_matches_reference_f32(B, S, Hq, Hkv, dh, bq, bk, causal):
    q, k, v = _inputs(B, S, Hq, Hkv, dh, B * 1000 + S)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     block_q=bq, block_k=bk)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == torch.float32 and got.shape == (B, S, Hq, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,bq,bk", [
    (1, 32, 4, 2, 16, 8, 8),        # tests/test_flash.py's bf16 case
    (1, 50, 32, 2, 64, 16, 16),     # GLM-4's group of 16, ragged
])
def test_flash_matches_reference_bf16(B, S, Hq, Hkv, dh, bq, bk):
    q, k, v = _inputs(B, S, Hq, Hkv, dh, 7 + S)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(ref_flash(qj, kj, vj, causal=True, block_q=bq, block_k=bk), np.float32)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(qt, kt, vt, causal=True, block_q=bq, block_k=bk)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= bf16_limit(want, vt.float().numpy())).all(), float(err.max())


def test_noncausal_ragged_raises_like_reference():
    q, k, v = _inputs(1, 50, 2, 2, 16, 0)
    with pytest.raises(ValueError, match="Skv % block_k"):
        ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                  block_q=16, block_k=16)
    with pytest.raises(ValueError, match="Skv % block_k"):
        ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            causal=False, block_q=16, block_k=16)
    # Skv within one block is taken whole, in both
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=False)
    assert got.shape == (1, 50, 2, 16)


def test_wrapper_refuses_other_devices_and_counts_no_cpu_launch():
    q = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q, q, q)
    before = sum(ops.launches.values())
    x = torch.zeros(1, 8, 2, 16)
    ops.flash_attention(x, x, x)
    assert sum(ops.launches.values()) == before


def test_gqa_fold_matches_per_head_reference():
    """The plain GQA fold: q head h attends kv head h // G."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 24, 6, 2, 16, 3))
    got = ref.attention_gqa_ref(q, k, v, causal=True)
    for h in range(6):
        want = ref.attention_ref(q[:, :, h], k[:, :, h // 3], v[:, :, h // 3], causal=True)
        torch.testing.assert_close(got[:, :, h], want, rtol=1e-6, atol=1e-6)
