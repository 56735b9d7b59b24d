// Causal (or full) attention with online softmax over (B, S, H, dh) GQA
// tensors, one pass, no (S, S) score matrix in device memory.
//
// Replaces: the Pallas TPU kernel of flash_pallas_call
// (src/repro/kernels/flash/kernel.py, _flash_kernel), the serving prefill's
// attention under exact_causal_prefill.  It computes what _flash_kernel
// computes: s = (q . k) accumulated in fp32, times 1/sqrt(dh) in fp32; a
// top-left causal mask (q_pos >= k_pos, both from 0) with masked scores
// -1e30; the online softmax m_new = max(m, rowmax s), p = exp(s - m_new),
// alpha = exp(m - m_new), l = l * alpha + sum p, acc = acc * alpha + p . v
// with p rounded to v's dtype first; out = acc / max(l, 1e-30) in v's dtype.
// Differences of form, not of result: q head h reads kv head h / G where the
// reference repeats k and v G times; keys past Skv and queries past Sq are
// masked here where the reference pads; the tiles are this kernel's own.
//
// What bounds it on the H100: operations.  At the serving prefill's shape
// (B 4, S 2048, 32 q heads, dh 128, bf16) the exact causal product is
// 4 * dh * B * Hq * S (S + 1) / 2 = 1.4e11 FLOP, 0.14 ms at the bf16 tensor
// rate, against 0.04 ms for the 143 MB it must move.
//
// Design (simple and right first; the tensor cores, TMA and warp
// specialisation are for a later change): one block of 128 threads per
// (64-query tile, batch x q head), heaviest causal tiles first.  The query
// tile is staged once in shared memory as fp32, transposed (Qt[d][row]); each
// 64-key tile of K is staged transposed (Kt[d][key]) and then V (Vs[key][d])
// into the same buffer.  Products of bf16 values are exact in fp32, so
// fp32 FMA arithmetic on the widened operands is the reference's mixed
// precision up to summation order.  Thread (r, c), r = tid / 16, c = tid % 16,
// owns query rows 8r .. 8r+7: for the scores, keys c + 16 j (j < 4); for the
// accumulator, the head-dim columns c * W + 16 W j; its m and partial l
// stay in registers, and a row's max is reduced over the 16 lanes that share
// it.  p goes through shared memory (Pt[key][row]) to the p . v product.
// Tiles strictly above the diagonal are never visited, so the work is the
// triangular one at 64 x 64 granularity.  The kernel allocates nothing and
// does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 8 row groups x 16 column lanes
constexpr int kRows = 8;        // query rows per thread
constexpr int kCols = kBK / 16; // score columns per thread
constexpr int kPStride = kBQ + 4;  // Pt row stride: float4 stores land on distinct banks
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p rounded to the value dtype (round to nearest even, as a dtype cast)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// 16 bytes of T widened to fp32
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, bool valid, float* out) {
    if (!valid) {
#pragma unroll
      for (int j = 0; j < n; ++j) out[j] = 0.f;
      return;
    }
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < n; ++j) out[j] = to_f(e[j]);
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Sq, int Skv, int Hq, int Hkv, int causal, float scale) {
  constexpr int DC = DH / 16;                               // accumulator columns per thread
  constexpr int W = DC % 4 == 0 ? 4 : (DC % 2 == 0 ? 2 : 1);  // their vector width
  constexpr int NV = DH / Vec<T>::n;                        // 16-byte vectors per row
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);              // [DH][kBQ]
  float* KV = Qt + DH * kBQ;                                // Kt [DH][kBK], then Vs [kBK][DH]
  float* Pt = KV + DH * kBK;                                // [kBK][kPStride]

  const int tid = threadIdx.x;
  const int r = tid / 16, c = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int n_qt = gridDim.y;
  const int qt = n_qt - 1 - (int)blockIdx.y;                // heaviest causal tiles first
  const int q0 = qt * kBQ;
  const long long q_row = (long long)Hq * DH, kv_row = (long long)Hkv * DH;
  const T* qb = q + ((long long)b * Sq * Hq + h) * DH;
  const T* kb = k + ((long long)b * Skv * Hkv + hk) * DH;
  const T* vb = v + ((long long)b * Skv * Hkv + hk) * DH;

  // stage the query tile: row fastest across threads, so the transposed
  // stores of one instruction fall on consecutive words
  for (int i = tid; i < kBQ * NV; i += kThreads) {
    const int row = i % kBQ, vi = i / kBQ;
    float e[Vec<T>::n];
    Vec<T>::load(qb + (q0 + row) * q_row + vi * Vec<T>::n, q0 + row < Sq, e);
#pragma unroll
    for (int j = 0; j < Vec<T>::n; ++j) Qt[(vi * Vec<T>::n + j) * kBQ + row] = e[j];
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
      float e[Vec<T>::n];
      Vec<T>::load(kb + (k0 + row) * kv_row + vi * Vec<T>::n, k0 + row < Skv, e);
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j) KV[(vi * Vec<T>::n + j) * kBK + row] = e[j];
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
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

    // scale, mask, online softmax; p (rounded to T) to shared memory
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
        s[i][j] = round_to<T>(p);
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

    for (int i = tid; i < kBK * NV; i += kThreads) {
      const int row = i / NV, vi = i % NV;
      float e[Vec<T>::n];
      Vec<T>::load(vb + (k0 + row) * kv_row + vi * Vec<T>::n, k0 + row < Skv, e);
      float4* dst = reinterpret_cast<float4*>(KV + row * DH + vi * Vec<T>::n);
#pragma unroll
      for (int j = 0; j < Vec<T>::n / 4; ++j)
        dst[j] = make_float4(e[4 * j], e[4 * j + 1], e[4 * j + 2], e[4 * j + 3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[DC];
      lds<4>(Pt + kk * kPStride + r * kRows, pv);
      lds<4>(Pt + kk * kPStride + r * kRows + 4, pv + 4);
#pragma unroll
      for (int j = 0; j < DC / W; ++j) lds<W>(KV + kk * DH + c * W + 16 * W * j, vv + j * W);
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
    T* orow = o + (((long long)b * Sq + qpos) * Hq + h) * DH;
#pragma unroll
    for (int j = 0; j < DC / W; ++j)
#pragma unroll
      for (int w = 0; w < W; ++w)
        orow[c * W + 16 * W * j + w] = from_f<T>(acc[i][j * W + w] * inv_l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int Hq,
           int Hkv, int causal, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)DH * kBQ + (size_t)DH * kBK + (size_t)kBK * kPStride);
  auto kern = flash_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  // the division here matches the reference's 1.0 / math.sqrt(dh), rounded once to fp32
  const float scale = (float)(1.0 / sqrt((double)DH));
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq,
                                     Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int Hq,
             int Hkv, int dh, int causal, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, st);
    case 160: return launch<T, 160>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh), o (B, Sq, Hq, dh): contiguous,
// 16-byte aligned, all float32 (is_bf16 = 0) or all bfloat16 (is_bf16 = 1);
// Hq a multiple of Hkv; dh in {16, 32, 64, 128, 160}.  Returns a CUDA error
// code (cudaGetLastError() after the launch).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Skv, int Hq, int Hkv, int dh, int causal,
                                   int is_bf16, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if ((Sq + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, dh, causal, st)
                 : dispatch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, dh, causal, st);
}
