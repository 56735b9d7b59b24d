// Exchange codec kernels: bf16/int8 encode of a block straight into its wire
// layout, and decode of a received payload straight into the block.
//
// Replaces: the Pallas TPU kernels of encode_pallas_call (with _encode_block),
// decode_pallas_call and unpack_decode_pallas_call of
// src/repro/kernels/exchange/kernel.py.
//
// Views.  The block is read (encode) or written (decode) as
// (F, O, M, S, P) floats: F stacked fields, O the axes before the chunked
// axis, M the chunks of that axis, S everything after the chunk index
// (chunk extent times trailing axes), P the interleaved re/im pair (2 for
// complex64, 1 for float32).  The wire payload is one of two layouts:
//   layout 0, in place:    (P, F, O, M, S)  - the reference's fused payload
//   layout 1, chunk-major: (M, P, F, O, S)  - what all_to_all_single splits
// Encoding with layout 1 is the pack of the reference's traditional engine
// (K1, pack=True); decoding layout 1 scatters chunk m into slot m of the
// concat axis (K3, unpack_decode); decoding layout 0 is K2.  Scales are one
// f32 per (f, m): (F, M) for layout 0 and (M, F) for layout 1.
//
// Arithmetic (bit for bit the reference codec, repro/core/quant.py): int8
// takes the finite-only max |x| of each (f, m) block, scale =
// max(amax, 1e-12f) / 127.0f (IEEE division; never built with fast math),
// q = clip(rint(x / scale), -127, 127) with non-finite x as 0; bf16 is
// __float2bfloat16_rn; decode is float(q) * scale or the bf16 widening.
//
// What bounds it on the H100: bytes.  Encode reads 4 bytes and writes 1
// (int8) or 2 (bf16) per float: at 512^3 complex64 (2^28 floats) that is
// 1.5 GiB (bf16), 0.48 ms at 3.35 TB/s; int8 reads the block twice, once for
// the max-abs and once to quantize, and a block larger than the 50 MB L2
// comes from HBM both times.  Decode reads 1-2 bytes and writes 4 per float.
//
// Encode design.  One CUDA block takes one tile of kEncTile = 8192 floats
// (32 KiB read) of one scale block (f, m), whose O * S * P floats are
// indexed e = o * S * P + s * P + p.  The grid is (scale block, tile): the
// card fills whatever F and M are, a tile spans many runs where runs are
// short (the pipelined slice's S * P = 256) and part of one where they are
// long, and each block adds its max-abs (int8) and its guard counts to its
// one (f, m) with one atomic.  8192 floats are 4 steps of 256 threads x 8
// floats (P = 2) or 8 steps x 4 (P = 1): all of a thread's loads are issued
// before its first store, and 2^28 floats make 32768 blocks, ~31 waves of
// 8 resident blocks on 132 SMs, with 32768 same-address atomics (int8).
//  - Where M = 1 or O = 1 ("contiguous"), both sides of the scale block are
//    one span: the block side at (f O M + m) S P + e and the wire side of
//    plane p at its plane base + e / P, a shift.  Every exchange of a plan
//    on one card has M = 1.
//  - Otherwise the block side is O runs of S * P floats M * S * P apart and
//    the in-place wire has runs M * S apart: the run o and its offset j
//    come from one 32-bit division per vector (the 64-bit (f, m) bases and
//    the tile's first run are computed once per block), so no element pays
//    a division, a modulo or 64-bit index arithmetic.
// Two designs, both on this grid and chosen by the caller
// (ops.encode_design, the same rule), never switched here:
//  - "vec": a thread moves 4 complex (two 16-byte loads) or 4 reals (one)
//    a step and stores 4 values per plane, 8 bytes (bf16) or 4 (int8).  It
//    needs S % 4 == 0 (so vectors never straddle a run and every run and
//    wire-plane start is aligned), the block 16-byte and the payload 8-byte
//    aligned; asked for elsewhere, exchange_encode returns
//    cudaErrorInvalidValue.
//  - "scalar": the same grid at one float a step (odd S, short runs, an
//    unaligned block), with the same index map.
// The int8 max-abs pass (enc_amax_kernel) reads with the same grid and
// vectors and ends each block with one atomicMax on the float bits (the
// values are >= 0, so their bit patterns order like the floats); the
// quantize pass reads the finished max, and block 0 of each (f, m) writes
// its scale.  The kernels allocate nothing (the wrapper zeroes the max-abs
// scratch) and do not synchronise.
//
// Decode design (unchanged until its own redesign): a run is one (f, o, m)
// row of S * P contiguous floats; every run is cut into tiles of kTile
// floats and every tile is a block, one float per thread a step.
//
// Guard mode (the reference's encode_pallas_call(guard=True)): with a
// non-null `counts`, the encode also counts, per (f, m) scale block, the
// non-finite elements and (int8) the elements quantized to +-127.  Each count
// rides the pass that already reads the element: the max-abs pass for int8
// non-finites, the encode pass for bf16 non-finites and int8 saturation.  A
// block sums its counts with warp shuffles and adds them with one integer
// atomicAdd per (f, m) into unsigned 64-bit scratch (exact at any size; the
// wrapper converts to f32).  Counts are laid out like the scales, with a
// trailing (nonfinite, saturated) pair.  `scale_div` divides the int8 scale
// after the /127 (the saturation fault); 1.0 leaves every bit unchanged.
// The counting is a template parameter, so an unguarded encode runs the
// same instructions as one without guard mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = 4096;  // the decode's floats per block

// The decode's view: a run is one (f, o, m) row of S * P floats.
struct View {
  long long F, O, M, S;
  int P;
  long long tiles;  // tiles per run
};

__device__ __forceinline__ long long wire_index(const View& v, int layout, long long f,
                                                long long o, long long m, long long s, int p) {
  if (layout == 1) return (((m * v.P + p) * v.F + f) * v.O + o) * v.S + s;
  return (((p * v.F + f) * v.O + o) * v.M + m) * v.S + s;
}

__device__ __forceinline__ void run_of(const View& v, long long& f, long long& o, long long& m,
                                       long long& tile) {
  const long long b = blockIdx.x;
  const long long run = b / v.tiles;
  tile = b - run * v.tiles;
  m = run % v.M;
  const long long fo = run / v.M;
  o = fo % v.O;
  f = fo / v.O;
}

__device__ __forceinline__ long long stat_index(const View& v, int layout, long long f,
                                                long long m) {
  return layout == 1 ? m * v.F + f : f * v.M + m;
}

// Sum of every thread's `c` over the block, in thread 0.
__device__ __forceinline__ unsigned int block_count(unsigned int c) {
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  __shared__ unsigned int warp_count[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) c += warp_count[i];
  return c;
}

// --- encode --------------------------------------------------------------

constexpr int kEncTile = 8192;  // floats of one scale block per encode block
constexpr int kVecDesign = 1;   // exchange_encode's `design`: 0 scalar, 1 vec

// The encode's view: scale block (f, m) is n = O * S * P floats.
struct EncView {
  long long F, O, M, S;
  long long L;        // S * P, floats per run
  long long n;        // floats per scale block
  long long pstride;  // wire elements from plane 0 to plane 1
  int bstride;        // block-side floats from run o to o + 1 (M * L; not contiguous only)
  int wstride;        // wire elements from run o to o + 1: S (chunk-major) or M * S
  int tiles;          // tiles per scale block
  int layout;
};

// One block's tile: scale block (f, m), tile t.
struct EncTile {
  const float* x;  // block side: the tile's first float, or (not contiguous) its first run's
  long long w;     // wire element of plane 0 at the same place
  int j0;          // the tile's first float within that run (contiguous: 0)
  int len;         // floats in the tile
  int f, m, t;
};

template <int P, bool kContig>
__device__ __forceinline__ EncTile enc_tile(const float* x, const EncView& v) {
  EncTile tl;
  const int b = (int)blockIdx.x;
  const int fm = b / v.tiles;
  tl.t = b - fm * v.tiles;
  tl.f = fm / (int)v.M;
  tl.m = fm - tl.f * (int)v.M;
  const long long f = tl.f, m = tl.m;
  const long long e0 = (long long)tl.t * kEncTile;
  tl.len = (int)min((long long)kEncTile, v.n - e0);
  const long long bbase = (f * v.O * v.M + m) * v.L;
  const long long wbase =
      v.layout == 1 ? (m * P * v.F + f) * v.O * v.S : (f * v.O * v.M + m) * v.S;
  if (kContig) {
    tl.j0 = 0;
    tl.x = x + bbase + e0;
    tl.w = wbase + e0 / P;
  } else {
    const long long o0 = e0 / v.L;
    tl.j0 = (int)(e0 - o0 * v.L);
    tl.x = x + bbase + o0 * v.bstride;
    tl.w = wbase + o0 * v.wstride;
  }
  return tl;
}

// The vector at tile float i (a multiple of its width): its block-side
// offset from tl.x, its wire offset in plane 0 from tl.w, and the plane of
// its first float.  Contiguous: a shift.  Otherwise one 32-bit division
// gives the run d after the tile's first and the offset j within it.
template <int P, bool kContig>
__device__ __forceinline__ void enc_locate(const EncView& v, int j0, int i, long long& xo,
                                           long long& wo, int& p0) {
  if (kContig) {
    xo = i;
    wo = (unsigned)i / P;
    p0 = (unsigned)i % P;
    return;
  }
  const unsigned e = (unsigned)(j0 + i);
  const unsigned d = e / (unsigned)v.L;
  const unsigned j = e - d * (unsigned)v.L;
  xo = (long long)d * v.bstride + j;
  wo = (long long)d * v.wstride + j / P;
  p0 = j % P;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&a)[V]) {
  if constexpr (V == 1) {
    a[0] = *p;
  } else {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 r = reinterpret_cast<const float4*>(p)[h];
      a[4 * h] = r.x;
      a[4 * h + 1] = r.y;
      a[4 * h + 2] = r.z;
      a[4 * h + 3] = r.w;
    }
  }
}

__device__ __forceinline__ unsigned int bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned int*>(&r);
}

template <bool kGuard>
__device__ __forceinline__ unsigned int quantize(float a, float scale, unsigned int& hits) {
  const float xf = isfinite(a) ? a : 0.0f;
  const float r = fminf(fmaxf(rintf(xf / scale), -127.0f), 127.0f);
  if (kGuard) hits += fabsf(r) == 127.0f;
  return (unsigned int)(int)r & 0xffu;
}

__device__ __forceinline__ long long enc_stat(const EncView& v, long long f, long long m) {
  return v.layout == 1 ? m * v.F + f : f * v.M + m;
}

// A tile's steps: kEncTile / (kThreads * V) vectors a thread, loaded
// kBatch at a time before any is used.
template <int V>
struct Steps {
  static constexpr int kSteps = kEncTile / (kThreads * V);
  static constexpr int kBatch = kSteps < 8 ? kSteps : 8;
};

// int8 pass 1: the finite max |x| of each tile into amax[f * M + m]; guard
// mode also counts the non-finite floats.
template <int P, int V, bool kContig, bool kGuard>
__global__ void __launch_bounds__(kThreads)
    enc_amax_kernel(const float* __restrict__ x, unsigned int* __restrict__ amax,
                    unsigned long long* __restrict__ counts, EncView v) {
  constexpr int kSteps = Steps<V>::kSteps, kBatch = Steps<V>::kBatch;
  const EncTile tl = enc_tile<P, kContig>(x, v);
  float best = 0.0f;
  unsigned int bad = 0;
  for (int s0 = 0; s0 < kSteps; s0 += kBatch) {
    float a[kBatch][V];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = ((s0 + u) * kThreads + (int)threadIdx.x) * V;
      long long xo, wo;
      int p0;
      if (i < tl.len) {
        enc_locate<P, kContig>(v, tl.j0, i, xo, wo, p0);
        load_vec<V>(tl.x + xo, a[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) a[u][k] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (isfinite(a[u][k])) best = fmaxf(best, fabsf(a[u][k]));
        else if (kGuard) ++bad;
      }
  }
  for (int off = 16; off > 0; off >>= 1) best = fmaxf(best, __shfl_down_sync(0xffffffffu, best, off));
  __shared__ float warp_best[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) best = fmaxf(best, warp_best[i]);
    atomicMax(amax + tl.f * v.M + tl.m, __float_as_uint(best));
  }
  if (kGuard) {
    bad = block_count(bad);
    if (threadIdx.x == 0 && bad != 0)
      atomicAdd(counts + 2 * enc_stat(v, tl.f, tl.m), (unsigned long long)bad);
  }
}

// The encode pass: bf16 (kCodec 0) or int8 with the finished max (kCodec 1).
template <int P, int V, bool kContig, int kCodec, bool kGuard>
__global__ void __launch_bounds__(kThreads)
    enc_kernel(const float* __restrict__ x, void* __restrict__ q,
               const unsigned int* __restrict__ amax, float* __restrict__ scales,
               unsigned long long* __restrict__ counts, float scale_div, EncView v) {
  constexpr int kSteps = Steps<V>::kSteps, kBatch = Steps<V>::kBatch;
  const EncTile tl = enc_tile<P, kContig>(x, v);
  const long long sidx = enc_stat(v, tl.f, tl.m);
  float scale = 0.0f;
  if (kCodec == 1) {
    scale = fmaxf(__uint_as_float(amax[tl.f * v.M + tl.m]), 1e-12f) / 127.0f / scale_div;
    if (tl.t == 0 && threadIdx.x == 0) scales[sidx] = scale;
  }
  unsigned int hits = 0;  // bf16: non-finite floats; int8: floats at +-127
  for (int s0 = 0; s0 < kSteps; s0 += kBatch) {
    float a[kBatch][V];
    long long wo[kBatch];
    int p0[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = ((s0 + u) * kThreads + (int)threadIdx.x) * V;
      long long xo;
      if (i < tl.len) {
        enc_locate<P, kContig>(v, tl.j0, i, xo, wo[u], p0[u]);
        load_vec<V>(tl.x + xo, a[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = ((s0 + u) * kThreads + (int)threadIdx.x) * V;
      if (i >= tl.len) continue;
      const long long w = tl.w + wo[u];
      if (kCodec == 0) {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(q) + w;
        if (kGuard) {
#pragma unroll
          for (int k = 0; k < V; ++k) hits += !isfinite(a[u][k]);
        }
        if constexpr (V == 1) {
          out[p0[u] * v.pstride] = __float2bfloat16_rn(a[u][0]);
        } else {
          // plane p holds floats p, P + p, 2P + p, 3P + p of the vector
#pragma unroll
          for (int p = 0; p < P; ++p) {
            uint2 packed;
            packed.x = bf16x2_bits(a[u][p], a[u][P + p]);
            packed.y = bf16x2_bits(a[u][2 * P + p], a[u][3 * P + p]);
            *reinterpret_cast<uint2*>(out + p * v.pstride) = packed;
          }
        }
      } else {
        signed char* out = static_cast<signed char*>(q) + w;
        if constexpr (V == 1) {
          out[p0[u] * v.pstride] = (signed char)quantize<kGuard>(a[u][0], scale, hits);
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const unsigned int packed = quantize<kGuard>(a[u][p], scale, hits) |
                                        quantize<kGuard>(a[u][P + p], scale, hits) << 8 |
                                        quantize<kGuard>(a[u][2 * P + p], scale, hits) << 16 |
                                        quantize<kGuard>(a[u][3 * P + p], scale, hits) << 24;
            *reinterpret_cast<unsigned int*>(out + p * v.pstride) = packed;
          }
        }
      }
    }
  }
  if (kGuard) {
    hits = block_count(hits);
    if (threadIdx.x == 0 && hits != 0)
      atomicAdd(counts + 2 * sidx + kCodec, (unsigned long long)hits);
  }
}

// --- decode --------------------------------------------------------------

__global__ void decode_kernel(const void* __restrict__ q, const float* __restrict__ scales,
                              float* __restrict__ y, int codec, int layout, View v) {
  long long f, o, m, tile;
  run_of(v, f, o, m, tile);
  const long long len = v.S * v.P;
  float* base = y + ((f * v.O + o) * v.M + m) * len;
  const long long end = min(len, (tile + 1) * kTile);
  if (codec == 0) {
    const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(q);
    for (long long i = tile * kTile + threadIdx.x; i < end; i += blockDim.x) {
      const long long s = i / v.P;
      const int p = (int)(i - s * v.P);
      base[i] = __bfloat162float(in[wire_index(v, layout, f, o, m, s, p)]);
    }
    return;
  }
  const float scale = scales[stat_index(v, layout, f, m)];
  const signed char* in = static_cast<const signed char*>(q);
  for (long long i = tile * kTile + threadIdx.x; i < end; i += blockDim.x) {
    const long long s = i / v.P;
    const int p = (int)(i - s * v.P);
    base[i] = (float)in[wire_index(v, layout, f, o, m, s, p)] * scale;
  }
}

int make_view(long long F, long long O, long long M, long long S, int P, View& v,
              long long& blocks) {
  if (F < 1 || O < 1 || M < 1 || S < 0 || (P != 1 && P != 2)) return (int)cudaErrorInvalidValue;
  v.F = F;
  v.O = O;
  v.M = M;
  v.S = S;
  v.P = P;
  v.tiles = (S * P + kTile - 1) / kTile;
  blocks = F * O * M * v.tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaSuccess;
}


int make_enc_view(long long F, long long O, long long M, long long S, int P, int layout,
                  EncView& v, long long& blocks) {
  if (F < 1 || O < 1 || M < 1 || S < 0 || (P != 1 && P != 2) || (layout != 0 && layout != 1))
    return (int)cudaErrorInvalidValue;
  v.F = F;
  v.O = O;
  v.M = M;
  v.S = S;
  v.L = S * P;
  v.n = O * v.L;
  v.layout = layout;
  v.pstride = layout == 1 ? F * O * S : F * O * M * S;
  const long long tiles = (v.n + kEncTile - 1) / kEncTile;
  blocks = F * M * tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  v.tiles = (int)tiles;
  // not contiguous: the in-tile offsets are 32-bit
  if (M > 1 && O > 1 && M * v.L + kEncTile > 2147483647LL) return (int)cudaErrorInvalidValue;
  v.bstride = (int)(M * v.L);
  v.wstride = (int)(layout == 1 ? S : M * S);
  return (int)cudaSuccess;
}

// The vec design's conditions (ops.encode_design applies the same rule).
bool vec_design_ok(const EncView& v, const void* x, const void* q) {
  return v.S % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 8 == 0;
}

template <int P, int V, bool kContig>
int launch_encode(const float* x, void* q, float* scales, unsigned int* amax,
                  unsigned long long* counts, int codec, float scale_div, const EncView& v,
                  unsigned blocks, cudaStream_t st) {
  const bool guard = counts != nullptr;
  if (codec == 1) {
    if (guard)
      enc_amax_kernel<P, V, kContig, true><<<blocks, kThreads, 0, st>>>(x, amax, counts, v);
    else
      enc_amax_kernel<P, V, kContig, false><<<blocks, kThreads, 0, st>>>(x, amax, counts, v);
    const int err = (int)cudaGetLastError();
    if (err != (int)cudaSuccess) return err;
    if (guard)
      enc_kernel<P, V, kContig, 1, true><<<blocks, kThreads, 0, st>>>(x, q, amax, scales, counts,
                                                                     scale_div, v);
    else
      enc_kernel<P, V, kContig, 1, false><<<blocks, kThreads, 0, st>>>(x, q, amax, scales,
                                                                      counts, scale_div, v);
  } else if (guard) {
    enc_kernel<P, V, kContig, 0, true><<<blocks, kThreads, 0, st>>>(x, q, amax, scales, counts,
                                                                   scale_div, v);
  } else {
    enc_kernel<P, V, kContig, 0, false><<<blocks, kThreads, 0, st>>>(x, q, amax, scales, counts,
                                                                    scale_div, v);
  }
  return (int)cudaGetLastError();
}

template <int P>
int launch_encode_p(bool vec, bool contig, const float* x, void* q, float* scales,
                    unsigned int* amax, unsigned long long* counts, int codec, float scale_div,
                    const EncView& v, unsigned blocks, cudaStream_t st) {
  if (vec)
    return contig ? launch_encode<P, 4 * P, true>(x, q, scales, amax, counts, codec, scale_div,
                                                   v, blocks, st)
                  : launch_encode<P, 4 * P, false>(x, q, scales, amax, counts, codec, scale_div,
                                                    v, blocks, st);
  return contig ? launch_encode<P, 1, true>(x, q, scales, amax, counts, codec, scale_div, v,
                                             blocks, st)
                : launch_encode<P, 1, false>(x, q, scales, amax, counts, codec, scale_div, v,
                                              blocks, st);
}

}  // namespace

// x: the block, (F, O, M, S, P) floats.  q: the payload, bf16 (codec 0) or
// int8 (codec 1) in `layout`.  int8 also writes `scales` and needs `amax`,
// F * M zeroed words of scratch.  `counts` (guard mode, else null): F * M * 2
// zeroed 64-bit counters.  `design`: 1 the vec design (cudaErrorInvalidValue
// where its conditions fail), 0 the scalar design.  Returns cudaGetLastError().
extern "C" int exchange_encode(const float* x, void* q, float* scales, unsigned int* amax,
                               unsigned long long* counts, int codec, int layout, long long F,
                               long long O, long long M, long long S, int P, float scale_div,
                               int design, void* stream) {
  EncView v;
  long long blocks;
  int err = make_enc_view(F, O, M, S, P, layout, v, blocks);
  if (err != (int)cudaSuccess) return err;
  if ((codec != 0 && codec != 1) || (design != 0 && design != kVecDesign))
    return (int)cudaErrorInvalidValue;
  const bool vec = design == kVecDesign;
  if (vec && !vec_design_ok(v, x, q)) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const bool contig = M == 1 || O == 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (P == 2)
    return launch_encode_p<2>(vec, contig, x, q, scales, amax, counts, codec, scale_div, v,
                              (unsigned)blocks, st);
  return launch_encode_p<1>(vec, contig, x, q, scales, amax, counts, codec, scale_div, v,
                            (unsigned)blocks, st);
}

// q: the received payload in `layout`; y: the block, (F, O, M, S, P) floats.
// int8 (codec 1) multiplies chunk m of field f by its sender's scale.
extern "C" int exchange_decode(const void* q, const float* scales, float* y, int codec,
                               int layout, long long F, long long O, long long M, long long S,
                               int P, void* stream) {
  View v;
  long long blocks;
  int err = make_view(F, O, M, S, P, v, blocks);
  if (err != (int)cudaSuccess) return err;
  if (codec != 0 && codec != 1) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  decode_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(q, scales, y, codec,
                                                                          layout, v);
  return (int)cudaGetLastError();
}
