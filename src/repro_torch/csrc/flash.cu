// Causal (or full) attention with online softmax over (B, S, H, d) GQA
// tensors, one pass, no (S, S) score matrix in device memory.  q and k share
// one head dim DQK, v and the output have their own, DV (MLA: 192 and 128;
// every other attention: DQK == DV, Zamba2's 80 among them).
//
// Replaces: the Pallas TPU kernel of flash_pallas_call
// (src/repro/kernels/flash/kernel.py, _flash_kernel), the serving prefill's
// attention under exact_causal_prefill.  It computes what _flash_kernel
// computes: s = (q . k) accumulated in fp32, times 1/sqrt(DQK) in fp32; a
// top-left causal mask (q_pos >= k_pos, both from 0) with masked scores
// -1e30; the online softmax m_new = max(m, rowmax s), p = exp(s - m_new),
// alpha = exp(m - m_new), l = l * alpha + sum p, acc = acc * alpha + p . v
// with p rounded to v's dtype first; out = acc / max(l, 1e-30) in v's dtype.
// Differences of form, not of result: q head h reads kv head h / G where the
// reference repeats k and v G times; keys past Skv and queries past Sq are
// masked here where the reference pads; the tiles are this kernel's own.
// Both designs below visit no tile strictly above the diagonal, so the work
// is the triangular one at 64 x 64 granularity, heaviest causal tiles
// first; neither allocates memory or synchronises the device.
//
// What bounds it on the H100: operations.  At the serving prefill's shape
// (B 4, S 2048, 32 q heads, dh 128, bf16) the exact causal product is
// 4 * dh * B * Hq * S (S + 1) / 2 = 1.375e11 FLOP, 0.139 ms at the dense
// bf16 tensor rate, against 0.043 ms for the 143 MB it must move.
//
// bf16: the tensor-core design (flash_tc_kernel), mma.sync m16n8k16 bf16
// with fp32 accumulation for both products.  A bf16 product is exact in
// fp32, so this is the reference's mixed precision up to summation order.
//  - Tiles: one block of 4 warps per (64-query tile, batch x q head); warp w
//    owns query rows 16w .. 16w+15 and the block loops over 64-key tiles.
//  - Shared memory holds bf16, rows padded by 16 bytes (a row of D + 8
//    elements) so that the 8 rows of every ldmatrix 8x8 fall on 8 distinct
//    16-byte bank groups at each head dim (a padded row is an odd number of
//    16-byte units): the Q tile and two buffers each of K and V,
//    (3 * (DQK + 8) + 2 * (DV + 8)) * 64 * 2 bytes: 85 KB at dh 128, where
//    ptxas gives 238 registers a thread, so shared memory and registers each
//    allow two blocks (8 warps) an SM; 105 KB and 255 registers (52 bytes
//    spilled) at dh 160, two blocks; 109 KB at (DQK, DV) = (192, 128), two
//    blocks; 55 KB and 190 registers, no spill, at dh 80 (Zamba2), two
//    blocks; 7.5-25 KB below.  Tiles arrive by
//    cp.async, 16 bytes a thread, rows past Sq or Skv zero-filled (source
//    size 0, never read); the next tile's K and V are in flight while the
//    current one computes, so one __syncthreads a tile suffices.
//  - S = Q K^T: Q's A fragments are read once (ldmatrix.x4) and stay in
//    registers (DQK / 16 k-steps) up to DQK 160; at 192 the twelve k-steps'
//    48 registers spilled 120 bytes (255 registers), so there each k-step of
//    each key tile reads its fragment from the Q tile again, which stays in
//    shared memory until the epilogue.  K's B fragments by ldmatrix.x4 (K is
//    [key][d], already the col-major B operand), two n8 key tiles a load.
//    Scale, and mask only where the tile crosses the diagonal or Skv.
//  - The online softmax stays in registers: a row's 64 scores lie in one
//    quad of lanes, so its max and sum take two __shfl_xor_sync; expf as
//    the reference writes it (no fast math, no exp2 folding).  l sums the
//    fp32 p per lane and is finished over the quad at the end.
//  - p is rounded to bf16 in registers (cvt.rn.bf16x2.f32, round to nearest
//    even as the reference's dtype cast) straight into A fragments: the C
//    fragments of two adjacent n8 score tiles are the A fragment of one
//    k16 step of P V, so p never touches shared memory.
//  - O += P V: V's B fragments by ldmatrix.x4.trans (V is [key][d]), the
//    fp32 accumulator 16 x DV a warp in registers (DV / 2 floats a lane).
//  - Epilogue: out = acc / max(l, 1e-30) rounded to bf16, staged through
//    the warp's own rows of the Q tile (DV <= DQK) and stored 16 bytes a
//    lane; rows past Sq are not stored.
//  It runs at about a fifth of the dense bf16 peak (PERF.md).  What it
//  lacks against that peak: wgmma (mma.sync does not reach the full
//  tensor rate), and overlap of one tile's softmax (expf between the two
//  products) with another tile's products; wgmma, TMA and warp
//  specialisation are the next step.
//
// fp32: the FMA design (flash_kernel), fp32 FMA on fp32 operands.  The
// reference's fp32 kernel does fp32 dots; TF32 tensor cores would leave the
// 2e-4 fp32 limit, so fp32 stays off the tensor cores.  One block of 128
// threads per (64-query tile, batch x q head).  The query tile is staged
// once in shared memory transposed (Qt[d][row]); each 64-key tile of K is
// staged transposed (Kt[d][key]) and then V (Vs[key][d]) into the same
// buffer, max(DQK, DV) * 64 floats.  Thread (r, c), r = tid / 16, c = tid % 16, owns query rows
// 8r .. 8r+7: for the scores, keys c + 16 j (j < 4); for the accumulator,
// the head-dim columns c * W + 16 W j; its m and partial l stay in
// registers, and a row's max is reduced over the 16 lanes that share it.
// At dh 80 a thread's 5 accumulator columns are scalar loads (W = 1); ptxas
// gives 210 registers, no spill.
// p goes through shared memory (Pt[key][row]) to the p . v product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 8 row groups x 16 column lanes
constexpr int kRows = 8;        // query rows per thread
constexpr int kCols = kBK / 16; // score columns per thread
constexpr int kPStride = kBQ + 4;  // Pt row stride: float4 stores land on distinct banks
constexpr float kNegInf = -1e30f;

// 16 bytes of fp32 (zeros where !valid)
struct Vec {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, bool valid, float* out) {
    const float4 t = valid ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  }
};

// W consecutive fp32 of shared memory
template <int W>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (W == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (W == 2) {
    float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int Hq,
             int Hkv, int causal, float scale) {
  constexpr int DC = DV / 16;                               // accumulator columns per thread
  constexpr int W = DC % 4 == 0 ? 4 : (DC % 2 == 0 ? 2 : 1);  // their vector width
  constexpr int NV = DQK / Vec::n;                          // 16-byte vectors per q or k row
  constexpr int NVV = DV / Vec::n;                          // ... per v row
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);              // [DQK][kBQ]
  float* KV = Qt + DQK * kBQ;                               // Kt [DQK][kBK], then Vs [kBK][DV]
  float* Pt = KV + (DQK > DV ? DQK : DV) * kBK;             // [kBK][kPStride]

  const int tid = threadIdx.x;
  const int r = tid / 16, c = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int n_qt = gridDim.y;
  const int qt = n_qt - 1 - (int)blockIdx.y;                // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const long long q_row = (long long)Hq * DQK, kv_row = (long long)Hkv * DQK;
  const long long v_row = (long long)Hkv * DV;
  const float* qb = q + ((long long)b * Sq * Hq + h) * DQK;
  const float* kb = k + ((long long)b * Skv * Hkv + hk) * DQK;
  const float* vb = v + ((long long)b * Skv * Hkv + hk) * DV;

  // stage the query tile: row fastest across threads, so the transposed
  // stores of one instruction fall on consecutive words
  for (int i = tid; i < kBQ * NV; i += kThreads) {
    const int row = i % kBQ, vi = i / kBQ;
    float e[Vec::n];
    Vec::load(qb + (q0 + row) * q_row + vi * Vec::n, q0 + row < Sq, e);
#pragma unroll
    for (int j = 0; j < Vec::n; ++j) Qt[(vi * Vec::n + j) * kBQ + row] = e[j];
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int n_kt_all = (Skv + kBK - 1) / kBK;
  const int n_kt = causal ? min(n_kt_all, (q0 + kBQ - 1) / kBK + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's V and P are no longer read
    for (int i = tid; i < kBK * NV; i += kThreads) {
      const int row = i % kBK, vi = i / kBK;
      float e[Vec::n];
      Vec::load(kb + (k0 + row) * kv_row + vi * Vec::n, k0 + row < Skv, e);
#pragma unroll
      for (int j = 0; j < Vec::n; ++j) KV[(vi * Vec::n + j) * kBK + row] = e[j];
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      float qv[kRows], kv[kCols];
      lds<4>(Qt + d * kBQ + r * kRows, qv);
      lds<4>(Qt + d * kBQ + r * kRows + 4, qv + 4);
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = KV[d * kBK + c + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, mask, online softmax; p to shared memory (fp32 v: p is not rounded)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + c + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= Skv || (causal && kpos > qpos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        s[i][j] = p;
      }
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float* dst = Pt + (c + 16 * j) * kPStride + r * kRows;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();  // scores done with Kt; P complete

    for (int i = tid; i < kBK * NVV; i += kThreads) {
      const int row = i / NVV, vi = i % NVV;
      float e[Vec::n];
      Vec::load(vb + (k0 + row) * v_row + vi * Vec::n, k0 + row < Skv, e);
      float4* dst = reinterpret_cast<float4*>(KV + row * DV + vi * Vec::n);
#pragma unroll
      for (int j = 0; j < Vec::n / 4; ++j)
        dst[j] = make_float4(e[4 * j], e[4 * j + 1], e[4 * j + 2], e[4 * j + 3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[DC];
      lds<4>(Pt + kk * kPStride + r * kRows, pv);
      lds<4>(Pt + kk * kPStride + r * kRows + 4, pv + 4);
#pragma unroll
      for (int j = 0; j < DC / W; ++j) lds<W>(KV + kk * DV + c * W + 16 * W * j, vv + j * W);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // l: this thread's partial sums -> the row's sum over its 16 lanes
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qpos = q0 + r * kRows + i;
    if (qpos >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * Sq + qpos) * Hq + h) * DV;
#pragma unroll
    for (int j = 0; j < DC / W; ++j)
#pragma unroll
      for (int w = 0; w < W; ++w)
        orow[c * W + 16 * W * j + w] = acc[i][j * W + w] * inv_l;
  }
}


// ---------------------------------------------------------------------------
// bf16: the tensor-core design
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;                 // 16 query rows each
constexpr int kTcThreads = 32 * kTcWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled (nothing read) where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b on one m16n8k16 tile: bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// rows r0 .. r0+63 of one head (rows `stride` elements apart) into a padded
// [64][D + 8] tile at shared address dst; rows at or past n are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long stride,
                                          int r0, int n, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < kBQ * CH / kTcThreads; ++it) {
    const int i = tid + it * kTcThreads;
    const int r = i / CH, c = i % CH;
    const bool valid = r0 + r < n;
    cp_async16(dst + (uint32_t)((r * (D + 8) + c * 8) * sizeof(bf16)),
               src + (valid ? r0 + r : 0) * stride + c * 8, valid);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv, int Hq,
                int Hkv, int causal, float scale) {
  static_assert(kBQ == 16 * kTcWarps && kBK == 64, "a warp owns 16 rows; 8 n8 key tiles");
  static_assert(DV <= DQK, "the epilogue stages a row of O in a row of the Q tile");
  constexpr int STR = DQK + 8;             // padded Q or K row, elements
  constexpr int STRV = DV + 8;             // padded V row
  constexpr uint32_t TILE = kBQ * STR * sizeof(bf16);    // bytes of one Q or K tile
  constexpr uint32_t TILEV = kBK * STRV * sizeof(bf16);  // ... of one V tile
  constexpr int KS = DQK / 16;             // k16 steps of Q K^T
  constexpr int ND = DV / 8;               // n8 tiles of O
  constexpr bool QREG = DQK <= 160;        // Q's A fragments held in registers
  extern __shared__ uint4 smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  const uint32_t aQ = smem_addr(sQ), aK = aQ + TILE, aV = aQ + 3 * TILE;  // K, V: 2 tiles each

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;    // a fragment's row group, column pair
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const long long q_row = (long long)Hq * DQK, kv_row = (long long)Hkv * DQK;
  const long long v_row = (long long)Hkv * DV;
  const bf16* qb = q + ((long long)b * Sq * Hq + h) * DQK;
  const bf16* kb = k + ((long long)b * Skv * Hkv + hk) * DQK;
  const bf16* vb = v + ((long long)b * Skv * Hkv + hk) * DV;

  const int n_kt_all = (Skv + kBK - 1) / kBK;
  const int n_kt = causal ? min(n_kt_all, (q0 + kBQ - 1) / kBK + 1) : n_kt_all;

  load_tile<DQK>(aQ, qb, q_row, q0, Sq, tid);
  load_tile<DQK>(aK, kb, kv_row, 0, Skv, tid);
  load_tile<DV>(aV, vb, v_row, 0, Skv, tid);
  asm volatile("cp.async.commit_group;\n" ::);

  // this lane's ldmatrix row addresses (bytes from a tile's start):
  // Q, A fragment: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
  const uint32_t offQ = ((warp * 16 + lane % 16) * STR + lane / 16 * 8) * sizeof(bf16);
  // K, B fragments of two n8 key tiles: (keys 0-7, d 0-7 | 8-15), (keys 8-15, ...)
  const uint32_t offK = ((lane / 16 * 8 + lane % 8) * STR + lane / 8 % 2 * 8) * sizeof(bf16);
  // V, transposed B fragments of two n8 d tiles: (keys 0-7 | 8-15) x (d 0-7 | 8-15)
  const uint32_t offV = ((lane / 8 % 2 * 8 + lane % 8) * STRV + lane / 16 * 8) * sizeof(bf16);

  uint32_t qf[QREG ? KS : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const uint32_t buf = (uint32_t)(kt % 2) * TILE, bufv = (uint32_t)(kt % 2) * TILEV;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile kt has landed; tile kt - 1's buffers are no longer read
    if (kt + 1 < n_kt) {
      load_tile<DQK>(aK + (TILE - buf), kb, kv_row, k0 + kBK, Skv, tid);
      load_tile<DV>(aV + (TILEV - bufv), vb, v_row, k0 + kBK, Skv, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (QREG && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) ldsm_x4(aQ + offQ + kk * 32, qf[QREG ? kk : 0]);
    }

    // s = q . k^T: 8 n8 tiles of 64 keys; C fragment: rows g, g + 8, keys 8j + 2t, +1
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (!QREG) ldsm_x4(aQ + offQ + kk * 32, qf[0]);
      const uint32_t(&qa)[4] = qf[QREG ? kk : 0];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bk[4];
        ldsm_x4(aK + buf + offK + (jj * 16 * STR + kk * 16) * sizeof(bf16), bk);
        mma_bf16(s[2 * jj], qa, bk[0], bk[1]);
        mma_bf16(s[2 * jj + 1], qa, bk[2], bk[3]);
      }
    }

    // scale, mask where the tile crosses the diagonal or Skv, row max
    const bool masked = k0 + kBK > Skv || (causal && k0 + kBK - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int kpos = k0 + 8 * j + 2 * t + e % 2;
          const int qpos = q0 + warp * 16 + g + e / 2 * 8;
          if (kpos >= Skv || (causal && kpos > qpos)) x = kNegInf;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }

    // p = exp(s - m_new), rounded to bf16 into the A fragments of P . V:
    // score tiles 2kk and 2kk + 1 are k16 step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = expf(s[j][0] - m[0]), p1 = expf(s[j][1] - m[0]);
      const float p2 = expf(s[j][2] - m[1]), p3 = expf(s[j][3] - m[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pa[j / 2][j % 2 * 2] = pack_bf16(p0, p1);
      pa[j / 2][j % 2 * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += p . v
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < ND / 2; ++jj) {
        uint32_t bv[4];
        ldsm_x4_trans(aV + bufv + offV + (kk * 16 * STRV + jj * 16) * sizeof(bf16), bv);
        mma_bf16(acc[2 * jj], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * jj + 1], pa[kk], bv[2], bv[3]);
      }
  }

  // l over the quad; out = acc / max(l, 1e-30) in bf16, staged through this
  // warp's own rows of the Q tile (only this warp read them), then 16 bytes
  // a lane to rows below Sq
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  uint32_t* row0 = reinterpret_cast<uint32_t*>(sQ + (warp * 16 + g) * STR + 2 * t);
  uint32_t* row8 = reinterpret_cast<uint32_t*>(sQ + (warp * 16 + g + 8) * STR + 2 * t);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    row0[4 * j] = pack_bf16(acc[j][0] / den[0], acc[j][1] / den[0]);
    row8[4 * j] = pack_bf16(acc[j][2] / den[1], acc[j][3] / den[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < ND / 2; ++it) {
    const int i = lane + 32 * it;
    const int r = i / ND, c = i % ND;
    const int qpos = q0 + warp * 16 + r;
    if (qpos < Sq)
      *reinterpret_cast<uint4*>(o + (((long long)b * Sq + qpos) * Hq + h) * DV + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + (warp * 16 + r) * STR + c * 8);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int Hq,
           int Hkv, int causal, int is_bf16, cudaStream_t st) {
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  // the division here matches the reference's 1.0 / math.sqrt(dh), rounded once to fp32
  const float scale = (float)(1.0 / sqrt((double)DQK));
  cudaError_t err;
  if (is_bf16) {
    // Q, 2 K, 2 V tiles
    const size_t smem = sizeof(bf16) * (size_t)kBQ * (3 * (DQK + 8) + 2 * (DV + 8));
    auto kern = flash_tc_kernel<DQK, DV>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kTcThreads, smem, st>>>(static_cast<const bf16*>(q),
                                         static_cast<const bf16*>(k),
                                         static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                         Sq, Skv, Hq, Hkv, causal, scale);
  } else {
    const size_t smem = sizeof(float) * ((size_t)DQK * kBQ + (size_t)(DQK > DV ? DQK : DV) * kBK +
                                         (size_t)kBK * kPStride);
    auto kern = flash_kernel<DQK, DV>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, kThreads, smem, st>>>(static_cast<const float*>(q),
                                       static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<float*>(o), Sq,
                                       Skv, Hq, Hkv, causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, dqk), k (B, Skv, Hkv, dqk), v (B, Skv, Hkv, dv), o (B, Sq, Hq,
// dv): contiguous, 16-byte aligned, all float32 (is_bf16 = 0: the FMA design)
// or all bfloat16 (is_bf16 = 1: the tensor-core design); Hq a multiple of
// Hkv; (dqk, dv) one of (16, 16), (32, 32), (64, 64), (80, 80), (128, 128),
// (160, 160) and (192, 128).  Returns a CUDA error code (cudaGetLastError() after the
// launch).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int dqk, int dv, int causal,
                                   int is_bf16, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if ((Sq + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_PAIR(DQK, DV)                                                                 \
  if (dqk == DQK && dv == DV)                                                               \
    return launch<DQK, DV>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, is_bf16, st)
  FLASH_PAIR(16, 16);
  FLASH_PAIR(32, 32);
  FLASH_PAIR(64, 64);
  FLASH_PAIR(80, 80);
  FLASH_PAIR(128, 128);
  FLASH_PAIR(160, 160);
  FLASH_PAIR(192, 128);
#undef FLASH_PAIR
  return (int)cudaErrorInvalidValue;
}
