"""The arithmetic and fragment layout of K6's tensor-core design on the CPU
(no kernel here).

The design (``csrc/flash.cu``, ``flash_tc_kernel``) runs both products of
the flash attention on ``mma.sync`` m16n8k16 bf16 tiles with fp32
accumulation, 64-key tiles, the online softmax in registers and p rounded
to bf16 straight into the A fragments of p . v.  Here:

(a) the plain emulation of that order of work (``ref.attention_tiles_ref``)
    matches the reference's Pallas kernel in interpret mode at
    ``block_k=64`` and the plain attention (``ref.attention_gqa_ref``)
    within the bf16 limit of ``tests/test_torch_flash.py``;
(b) the m16n8k16 fragment maps (PTX ISA), the ldmatrix row addresses the
    kernel gives each lane, and the reuse of two n8 score tiles' C
    fragments as one k16 A fragment assemble q . k^T and p . v exactly;
(c) the padded rows put the 8 rows of every ldmatrix 8x8 on 8 distinct
    16-byte bank groups at every head dim (q and k at ``kernel.HEAD_DIMS``,
    MLA's 192 among them; v at the same dims, 128 the value head dim of
    the pair (192, 128)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.ops import flash_attention as ref_flash
from repro_torch.kernels.flash import kernel, ref

# (B, S, Hkv, G, dh, causal): dh over the kernel's head dims, G 1/2/16, ragged S
CASES = [
    (1, 50, 2, 1, 16, True),
    (2, 100, 1, 2, 64, True),
    (1, 130, 1, 16, 128, True),
    (1, 77, 1, 2, 160, True),
    (1, 64, 2, 2, 32, False),
    (1, 128, 1, 16, 64, False),
]


def _inputs(B, S, Hkv, G, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, dh)).astype(np.float32)
                 for h in (Hkv * G, Hkv, Hkv))


def _bf16_limit(want, v):
    """tests/test_torch_flash.py's bf16 limit: one bf16 ulp of the output plus
    twice the bound of p's rounding."""
    return 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * float(np.abs(v).max())


@pytest.mark.parametrize("B,S,Hkv,G,dh,causal", CASES)
def test_tile_emulation_matches_reference_kernel_and_plain(B, S, Hkv, G, dh, causal):
    q, k, v = _inputs(B, S, Hkv, G, dh, S * dh + G)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ref.attention_tiles_ref(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, Hkv * G, dh)
    got = got.float().numpy()
    vf = vt.float().numpy()
    qj, kj, vj = (jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (qt, kt, vt))
    want = np.asarray(ref_flash(qj, kj, vj, causal=causal, block_q=64, block_k=64), np.float32)
    err = np.abs(got - want)
    assert (err <= _bf16_limit(want, vf)).all(), float(err.max())
    plain = ref.attention_gqa_ref(qt, kt, vt, causal=causal).float().numpy()
    err = np.abs(got - plain)
    assert (err <= _bf16_limit(plain, vf)).all(), float(err.max())


def test_tile_emulation_fp32_is_the_plain_attention():
    """Without p's rounding the tiles change only the order of the sums."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 150, 2, 2, 32, 5))
    got = ref.attention_tiles_ref(q, k, v, causal=True)
    want = ref.attention_gqa_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# m16n8k16 fragments (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t;
# a register holds two consecutive elements, ``half`` 0 in the low 16 bits
# ---------------------------------------------------------------------------


def a_map(lane, reg, half):
    """A (16 x 16, row-major), 4 registers: (row, col)."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg % 2), 2 * t + half + 8 * (reg // 2)


def b_map(lane, reg, half):
    """B (16 x 8, k x n), 2 registers: (k, n)."""
    g, t = divmod(lane, 4)
    return 2 * t + half + 8 * reg, g


def c_map(lane, i):
    """C and D (16 x 8, fp32), 4 values: (row, col)."""
    g, t = divmod(lane, 4)
    return g + 8 * (i // 2), 2 * t + i % 2


def mma(a, b, c):
    """One warp's ``mma.sync.m16n8k16``: a (32, 4, 2), b (32, 2, 2), c (32, 4)
    per-lane fragments -> d (32, 4)."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        for r in range(4):
            for h in range(2):
                A[a_map(lane, r, h)] = a[lane, r, h]
        for r in range(2):
            for h in range(2):
                B[b_map(lane, r, h)] = b[lane, r, h]
    D = A @ B
    return c + np.array([[D[c_map(lane, i)] for i in range(4)] for lane in range(32)])


def ldmatrix_x4(tile, addrs, trans=False):
    """``ldmatrix.m8n8.x4[.trans]``: lanes 8i .. 8i+7 give the (row, col)
    starts of the 8 rows of matrix i; lane l receives, of each matrix, the
    elements (l // 4, 2 (l % 4) + half), or transposed (2 (l % 4) + half,
    l // 4).  Returns (32, 4, 2)."""
    out = np.zeros((32, 4, 2))
    for lane in range(32):
        for i in range(4):
            for h in range(2):
                r, c = (2 * (lane % 4) + h, lane // 4) if trans else (lane // 4,
                                                                     2 * (lane % 4) + h)
                row, col = addrs[8 * i + r]
                out[lane, i, h] = tile[row, col + c]
    return out


# the kernel's per-lane ldmatrix starts (flash_tc_kernel's offQ, offK, offV)
def q_addr(lane, warp, kk):
    return warp * 16 + lane % 16, kk * 16 + lane // 16 * 8


def k_addr(lane, kk, jj):
    return jj * 16 + lane // 16 * 8 + lane % 8, kk * 16 + lane // 8 % 2 * 8


def v_addr(lane, kk, jj):
    return kk * 16 + lane // 8 % 2 * 8 + lane % 8, jj * 16 + lane // 16 * 8


def test_fragment_maps_cover_their_tiles():
    for fn, regs, halves, shape in ((a_map, 4, 2, (16, 16)), (b_map, 2, 2, (16, 8)),
                                    (lambda l, r, h: c_map(l, 2 * r + h), 2, 2, (16, 8))):
        seen = {fn(lane, r, h) for lane in range(32) for r in range(regs) for h in range(halves)}
        assert seen == {(i, j) for i in range(shape[0]) for j in range(shape[1])}


def cvt_rn_bf16x2(a, b):
    """``cvt.rn.bf16x2.f32 d, a, b``: a to the high half, b to the low."""
    bits = torch.tensor([b, a], dtype=torch.float32).to(torch.bfloat16).view(torch.int16)
    lo, hi = (int(x) & 0xFFFF for x in bits)
    return hi << 16 | lo


def pack_bf16(lo, hi):
    """The kernel's ``pack_bf16(lo, hi)``: ``cvt.rn.bf16x2.f32 r, hi, lo``."""
    return cvt_rn_bf16x2(hi, lo)


def test_pack_puts_the_lower_column_in_the_low_half():
    r = pack_bf16(1.0, -2.0)
    halves = torch.tensor([r & 0xFFFF, r >> 16], dtype=torch.int32).to(torch.int16)
    assert halves.view(torch.bfloat16).tolist() == [1.0, -2.0]


@pytest.mark.parametrize("dh", kernel.HEAD_DIMS)
def test_warp_products_from_fragments(dh):
    """One warp's 16 query rows of a 64-query tile against a 64-key tile:
    q . k^T from ldmatrix'd A and B fragments, then p . v with p taken from
    the score C fragments as the kernel reuses them (score tiles 2kk and
    2kk + 1 are A fragment kk: registers (2kk: c0 c1, 2kk: c2 c3, 2kk+1:
    c0 c1, 2kk+1: c2 c3)) and V's B fragments by ldmatrix.trans, V of the
    value head dim the kernel pairs with ``dh``.  Small integers, so every
    sum is exact."""
    rng = np.random.default_rng(dh)
    dv = dict(kernel.PAIRS)[dh]
    warp = 2
    Q = rng.integers(-3, 4, (64, dh)).astype(np.float64)
    K = rng.integers(-3, 4, (64, dh)).astype(np.float64)
    V = rng.integers(-3, 4, (64, dv)).astype(np.float64)
    qf = [ldmatrix_x4(Q, [q_addr(lane, warp, kk) for lane in range(32)])
          for kk in range(dh // 16)]
    s = np.zeros((8, 32, 4))
    for kk in range(dh // 16):
        for jj in range(4):
            bk = ldmatrix_x4(K, [k_addr(lane, kk, jj) for lane in range(32)])
            s[2 * jj] = mma(qf[kk], bk[:, :2], s[2 * jj])
            s[2 * jj + 1] = mma(qf[kk], bk[:, 2:], s[2 * jj + 1])
    S = Q[warp * 16:warp * 16 + 16] @ K.T
    for j in range(8):
        for lane in range(32):
            for i in range(4):
                r, c = c_map(lane, i)
                assert s[j, lane, i] == S[r, 8 * j + c]

    P = s  # any values in the score layout: the reuse is a relabelling
    pa = np.zeros((4, 32, 4, 2))
    for j in range(8):
        pa[j // 2, :, j % 2 * 2] = P[j][:, 0:2]
        pa[j // 2, :, j % 2 * 2 + 1] = P[j][:, 2:4]
    acc = np.zeros((dv // 8, 32, 4))
    for kk in range(4):
        for jj in range(dv // 16):
            bv = ldmatrix_x4(V, [v_addr(lane, kk, jj) for lane in range(32)], trans=True)
            acc[2 * jj] = mma(pa[kk], bv[:, :2], acc[2 * jj])
            acc[2 * jj + 1] = mma(pa[kk], bv[:, 2:], acc[2 * jj + 1])
    O = S @ V
    for n in range(dv // 8):
        for lane in range(32):
            for i in range(4):
                r, c = c_map(lane, i)
                assert acc[n, lane, i] == O[r, 8 * n + c]


@pytest.mark.parametrize("dh", kernel.HEAD_DIMS)
def test_padded_rows_make_ldmatrix_conflict_free(dh):
    """Rows of dh + 8 bf16: each 8-lane phase of an ldmatrix reads 8 rows of
    16 bytes that fall on 8 distinct 16-byte bank groups (128 bytes a
    wavefront); unpadded rows do not, from dh 64 up."""
    def groups(stride, addrs):
        return {((row * stride + col) * 2 // 16) % 8 for row, col in addrs}

    loads = ([q_addr(lane, w, kk) for lane in range(32)]
             for w in range(4) for kk in range(dh // 16))
    loads = list(loads) + [[k_addr(lane, kk, jj) for lane in range(32)]
                           for kk in range(dh // 16) for jj in range(4)]
    loads += [[v_addr(lane, kk, jj) for lane in range(32)]
              for kk in range(4) for jj in range(dh // 16)]
    for addrs in loads:
        for i in range(4):
            assert len(groups(dh + 8, addrs[8 * i:8 * i + 8])) == 8
    if dh >= 64:
        assert len(groups(dh, [k_addr(lane, 0, 0) for lane in range(8)])) < 8
