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
// f32 per (f, m): (F, M) for layout 0 and (M, F) for layout 1.  The decode
// takes the same view as the encode, cut at the scatter axis w where the
// encode cuts at v, so both directions share one map.
//
// Arithmetic (bit for bit the reference codec, repro/core/quant.py): int8
// takes the finite-only max |x| of each (f, m) block, scale =
// max(amax, 1e-12f) / 127.0f (IEEE division; never built with fast math),
// q = clip(rint(x / scale), -127, 127) with non-finite x as 0; bf16 is
// __float2bfloat16_rn.  The decode is float(q) * scale, one IEEE multiply,
// or the bf16 widening, the 16 bits shifted up (what __bfloat162float does).
//
// What bounds it on the H100: bytes.  Encode reads 4 bytes and writes 1
// (int8) or 2 (bf16) per float: at 512^3 complex64 (2^28 floats) that is
// 1.5 GiB (bf16), 0.48 ms at 3.35 TB/s; int8 reads the block twice, once for
// the max-abs and once to quantize, and a block larger than the 50 MB L2
// comes from HBM both times.  Decode reads 1-2 bytes and writes 4 per float,
// the same 1.5 GiB (bf16) or 1.25 GiB (int8).
//
// The tile map, both directions.  One CUDA block takes one tile of kTile =
// 8192 floats (32 KiB of the block) of one scale block (f, m), whose O * S
// * P floats are indexed e = o * S * P + s * P + p.  The grid is (scale
// block, tile): the card fills whatever F and M are, a tile spans many runs
// where runs are short (the pipelined slice's S * P = 256) and part of one
// where they are long.  8192 floats are 4 steps of 256 threads x 8 floats
// (P = 2) or 8 steps x 4 (P = 1): all of a thread's loads for a batch of
// steps are issued before its first store, and 2^28 floats make 32768
// blocks, ~31 waves of 8 resident blocks on 132 SMs.
//  - Where M = 1 or O = 1 ("contiguous"), both sides of the scale block are
//    one span: the block side at (f O M + m) S P + e and the wire side of
//    plane p at its plane base + e / P, a shift.  Every exchange of a plan
//    on one card has M = 1.
//  - Otherwise the block side is O runs of S * P floats M * S * P apart and
//    the in-place wire has runs M * S apart: the run o and its offset j
//    come from one 32-bit division per vector (the 64-bit (f, m) bases and
//    the tile's first run are computed once per block), so no element pays
//    a division, a modulo or 64-bit index arithmetic.
// Two designs, both on this map and chosen by the caller (ref.tile_design,
// the same rule for both directions), never switched here:
//  - "vec": a thread moves 4 complex or 4 reals a step.  The block side is
//    one 16-byte access per 4 floats (two for 4 complex); the wire side is
//    4 values a plane, 8 bytes (bf16) or 4 (int8).  It needs S % 4 == 0 (so
//    vectors never straddle a run and every run and wire-plane start is
//    aligned), the block 16-byte and the payload 8-byte aligned; asked for
//    elsewhere, exchange_encode and exchange_decode return
//    cudaErrorInvalidValue.
//  - "scalar": the same map at one float a step (odd S, short runs, an
//    unaligned block or payload).
//
// Encode.  The int8 max-abs pass (enc_amax_kernel) reads with the map and
// ends each block with one atomicMax on the float bits (the values are >= 0,
// so their bit patterns order like the floats) into its (f, m); the quantize
// pass (enc_kernel) reads the finished max, and block 0 of each (f, m)
// writes its scale.  The kernels allocate nothing (the wrapper zeroes the
// max-abs scratch) and do not synchronise.
//
// Decode (decode_kernel).  Each block reads the scale of its (f, m) once
// (int8); a vec step reads the 4 wire values of each plane as one word,
// widens them and writes the interleaved 4 P floats as P 16-byte stores.
// With P = 2 a lane's two 16-byte pieces are 32 bytes apart, so a warp's
// store would fill only half of each 32-byte sector it touches: the warp's
// 64 pieces are dealt out again through 1 KiB of shared memory, and each
// store instruction writes 32 pieces in order, whole sectors.  The same 32 vectors a warp step, each float
// written once; only which lane stores a piece changes.
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
constexpr int kTile = 8192;     // floats of one scale block per CUDA block
constexpr int kVecDesign = 1;   // the `design` argument: 0 scalar, 1 vec

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

// --- the tile map ----------------------------------------------------------

// Scale block (f, m) is n = O * S * P floats.
struct TileView {
  long long F, O, M, S;
  long long L;        // S * P, floats per run
  long long n;        // floats per scale block
  long long pstride;  // wire elements from plane 0 to plane 1
  int bstride;        // block-side floats from run o to o + 1 (M * L; not contiguous only)
  int wstride;        // wire elements from run o to o + 1: S (chunk-major) or M * S
  int tiles;          // tiles per scale block
  int layout;
};

// One CUDA block's tile: scale block (f, m), tile t.
template <class T>
struct Tile {
  T* x;        // block side: the tile's first float, or (not contiguous) its first run's
  long long w;  // wire element of plane 0 at the same place
  int j0;       // the tile's first float within that run (contiguous: 0)
  int len;      // floats in the tile
  int f, m, t;
};

template <int P, bool kContig, class T>
__device__ __forceinline__ Tile<T> tile_of(T* x, const TileView& v) {
  Tile<T> tl;
  const int b = (int)blockIdx.x;
  const int fm = b / v.tiles;
  tl.t = b - fm * v.tiles;
  tl.f = fm / (int)v.M;
  tl.m = fm - tl.f * (int)v.M;
  const long long f = tl.f, m = tl.m;
  const long long e0 = (long long)tl.t * kTile;
  tl.len = (int)min((long long)kTile, v.n - e0);
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
__device__ __forceinline__ void locate(const TileView& v, int j0, int i, long long& xo,
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

// The scale (and guard count) index of (f, m): (F, M) in place, (M, F) chunk-major.
__device__ __forceinline__ long long stat_index(const TileView& v, long long f, long long m) {
  return v.layout == 1 ? m * v.F + f : f * v.M + m;
}

// A tile's steps: kTile / (kThreads * V) vectors a thread, loaded
// kBatch at a time before any is used.
template <int V>
struct Steps {
  static constexpr int kSteps = kTile / (kThreads * V);
  static constexpr int kBatch = kSteps < 8 ? kSteps : 8;
};

// --- encode --------------------------------------------------------------

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

// int8 pass 1: the finite max |x| of each tile into amax[f * M + m]; guard
// mode also counts the non-finite floats.
template <int P, int V, bool kContig, bool kGuard>
__global__ void __launch_bounds__(kThreads)
    enc_amax_kernel(const float* __restrict__ x, unsigned int* __restrict__ amax,
                    unsigned long long* __restrict__ counts, TileView v) {
  constexpr int kSteps = Steps<V>::kSteps, kBatch = Steps<V>::kBatch;
  const Tile<const float> tl = tile_of<P, kContig>(x, v);
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
        locate<P, kContig>(v, tl.j0, i, xo, wo, p0);
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
      atomicAdd(counts + 2 * stat_index(v, tl.f, tl.m), (unsigned long long)bad);
  }
}

// The encode pass: bf16 (kCodec 0) or int8 with the finished max (kCodec 1).
template <int P, int V, bool kContig, int kCodec, bool kGuard>
__global__ void __launch_bounds__(kThreads)
    enc_kernel(const float* __restrict__ x, void* __restrict__ q,
               const unsigned int* __restrict__ amax, float* __restrict__ scales,
               unsigned long long* __restrict__ counts, float scale_div, TileView v) {
  constexpr int kSteps = Steps<V>::kSteps, kBatch = Steps<V>::kBatch;
  const Tile<const float> tl = tile_of<P, kContig>(x, v);
  const long long sidx = stat_index(v, tl.f, tl.m);
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
        locate<P, kContig>(v, tl.j0, i, xo, wo[u], p0[u]);
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

// The wire values at element w of the payload: 4 (vec: one 8-byte bf16 or
// 4-byte int8 word) or 1, in the low bits of .x (and .y).
template <int kCodec, int N>
__device__ __forceinline__ uint2 load_wire(const void* __restrict__ q, long long w) {
  uint2 r = make_uint2(0u, 0u);
  if constexpr (kCodec == 0 && N == 4)
    r = *reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(q) + w);
  else if constexpr (kCodec == 0)
    r.x = static_cast<const unsigned short*>(q)[w];
  else if constexpr (N == 4)
    r.x = *reinterpret_cast<const unsigned int*>(static_cast<const unsigned char*>(q) + w);
  else
    r.x = static_cast<const unsigned char*>(q)[w];
  return r;
}

// Wire value k of a loaded word as a float: bf16 shifted up 16 bits (the
// widening, bit for bit), int8 sign-extended times the scale (one multiply).
template <int kCodec>
__device__ __forceinline__ float widen(uint2 r, int k, float scale) {
  if constexpr (kCodec == 0) {
    const unsigned int h = k < 2 ? r.x : r.y;
    return __uint_as_float((k & 1) ? h & 0xffff0000u : h << 16);
  } else {
    return (float)((int)(r.x << (24 - 8 * k)) >> 24) * scale;
  }
}

// Stores the warp's 32 vectors of 4 complex (lane l's 8 floats `a`, at tile
// float i, x0 + xo) as 16-byte pieces l and 32 + l, piece c being half c & 1
// of lane c >> 1's vector.  Every lane of the warp takes part; a piece of a
// vector past the tile is not stored.  Not contiguous, a piece's offset is
// read from lane c >> 1.
template <bool kContig>
__device__ __forceinline__ void store_dealt(float4 (&stage)[64], const float (&a)[8], float* x0,
                                            long long xo, int i, int len) {
  const int lane = threadIdx.x & 31;
  stage[2 * lane] = make_float4(a[0], a[1], a[2], a[3]);
  stage[2 * lane + 1] = make_float4(a[4], a[5], a[6], a[7]);
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 32 * h + lane, src = c >> 1;
    const int isrc = i + 8 * (src - lane);  // the tile float of lane src's vector
    float* dst = x0 + (kContig ? (long long)isrc : __shfl_sync(0xffffffffu, xo, src));
    if (isrc < len) reinterpret_cast<float4*>(dst)[c & 1] = stage[c];
  }
  __syncwarp();
}

// Decode bf16 (kCodec 0) or int8 (kCodec 1) into the block, on the encode's map.
template <int P, int V, bool kContig, int kCodec>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const void* __restrict__ q, const float* __restrict__ scales,
                  float* __restrict__ y, TileView v) {
  constexpr int kSteps = Steps<V>::kSteps, kBatch = Steps<V>::kBatch;
  constexpr int kWords = V == 1 ? 1 : P;  // wire loads a step
  const Tile<float> tl = tile_of<P, kContig>(y, v);
  const float scale = kCodec == 1 ? scales[stat_index(v, tl.f, tl.m)] : 1.0f;
  for (int s0 = 0; s0 < kSteps; s0 += kBatch) {
    uint2 r[kBatch][kWords] = {};
    long long xo[kBatch] = {};
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = ((s0 + u) * kThreads + (int)threadIdx.x) * V;
      if (i < tl.len) {
        long long wo;
        int p0;
        locate<P, kContig>(v, tl.j0, i, xo[u], wo, p0);
        const long long w = tl.w + wo;
        if constexpr (V == 1) {
          r[u][0] = load_wire<kCodec, 1>(q, w + p0 * v.pstride);
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) r[u][p] = load_wire<kCodec, 4>(q, w + p * v.pstride);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = ((s0 + u) * kThreads + (int)threadIdx.x) * V;
      float* out = tl.x + xo[u];
      if constexpr (V == 1) {
        if (i < tl.len) *out = widen<kCodec>(r[u][0], 0, scale);
      } else {
        // float k of the vector is value k / P of plane k % P
        float a[V];
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = widen<kCodec>(r[u][k % P], k / P, scale);
        if constexpr (P == 2) {
          __shared__ float4 stage[kThreads / 32][64];
          store_dealt<kContig>(stage[threadIdx.x >> 5], a, tl.x, xo[u], i, tl.len);
        } else if (i < tl.len) {
          *reinterpret_cast<float4*>(out) = make_float4(a[0], a[1], a[2], a[3]);
        }
      }
    }
  }
}

// --- launch --------------------------------------------------------------

int make_tile_view(long long F, long long O, long long M, long long S, int P, int layout,
                   TileView& v, long long& blocks) {
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
  const long long tiles = (v.n + kTile - 1) / kTile;
  blocks = F * M * tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  v.tiles = (int)tiles;
  // not contiguous: the in-tile offsets are 32-bit
  if (M > 1 && O > 1 && M * v.L + kTile > 2147483647LL) return (int)cudaErrorInvalidValue;
  v.bstride = (int)(M * v.L);
  v.wstride = (int)(layout == 1 ? S : M * S);
  return (int)cudaSuccess;
}

// The vec design's conditions (ref.tile_design applies the same rule):
// x the block, q the payload.
bool vec_design_ok(const TileView& v, const void* x, const void* q) {
  return v.S % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 8 == 0;
}

// Calls run.template go<P, V, kContig>() with the design's template arguments.
template <class Run>
int by_design(int P, bool vec, bool contig, const Run& run) {
  if (P == 2) {
    if (vec) return contig ? run.template go<2, 8, true>() : run.template go<2, 8, false>();
    return contig ? run.template go<2, 1, true>() : run.template go<2, 1, false>();
  }
  if (vec) return contig ? run.template go<1, 4, true>() : run.template go<1, 4, false>();
  return contig ? run.template go<1, 1, true>() : run.template go<1, 1, false>();
}

struct EncodeRun {
  const float* x;
  void* q;
  float* scales;
  unsigned int* amax;
  unsigned long long* counts;
  int codec;
  float scale_div;
  TileView v;
  unsigned blocks;
  cudaStream_t st;

  template <int P, int V, bool kContig>
  int go() const {
    const bool guard = counts != nullptr;
    if (codec == 1) {
      if (guard)
        enc_amax_kernel<P, V, kContig, true><<<blocks, kThreads, 0, st>>>(x, amax, counts, v);
      else
        enc_amax_kernel<P, V, kContig, false><<<blocks, kThreads, 0, st>>>(x, amax, counts, v);
      const int err = (int)cudaGetLastError();
      if (err != (int)cudaSuccess) return err;
      if (guard)
        enc_kernel<P, V, kContig, 1, true><<<blocks, kThreads, 0, st>>>(x, q, amax, scales,
                                                                       counts, scale_div, v);
      else
        enc_kernel<P, V, kContig, 1, false><<<blocks, kThreads, 0, st>>>(x, q, amax, scales,
                                                                        counts, scale_div, v);
    } else if (guard) {
      enc_kernel<P, V, kContig, 0, true><<<blocks, kThreads, 0, st>>>(x, q, amax, scales, counts,
                                                                     scale_div, v);
    } else {
      enc_kernel<P, V, kContig, 0, false><<<blocks, kThreads, 0, st>>>(x, q, amax, scales,
                                                                      counts, scale_div, v);
    }
    return (int)cudaGetLastError();
  }
};

struct DecodeRun {
  const void* q;
  const float* scales;
  float* y;
  int codec;
  TileView v;
  unsigned blocks;
  cudaStream_t st;

  template <int P, int V, bool kContig>
  int go() const {
    if (codec == 1)
      decode_kernel<P, V, kContig, 1><<<blocks, kThreads, 0, st>>>(q, scales, y, v);
    else
      decode_kernel<P, V, kContig, 0><<<blocks, kThreads, 0, st>>>(q, scales, y, v);
    return (int)cudaGetLastError();
  }
};

// The view, codec and design checks both entry points make.
int check(long long F, long long O, long long M, long long S, int P, int layout, int codec,
          int design, const void* x, const void* q, TileView& v, long long& blocks) {
  const int err = make_tile_view(F, O, M, S, P, layout, v, blocks);
  if (err != (int)cudaSuccess) return err;
  if ((codec != 0 && codec != 1) || (design != 0 && design != kVecDesign))
    return (int)cudaErrorInvalidValue;
  if (design == kVecDesign && !vec_design_ok(v, x, q)) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
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
  TileView v;
  long long blocks;
  const int err = check(F, O, M, S, P, layout, codec, design, x, q, v, blocks);
  if (err != (int)cudaSuccess || blocks == 0) return err;
  const EncodeRun run{x, q, scales, amax, counts, codec, scale_div, v, (unsigned)blocks,
                      (cudaStream_t)stream};
  return by_design(P, design == kVecDesign, M == 1 || O == 1, run);
}

// q: the received payload in `layout`; y: the block, (F, O, M, S, P) floats.
// int8 (codec 1) multiplies chunk m of field f by its sender's scale.
// `design` as exchange_encode's, with y as the block.
extern "C" int exchange_decode(const void* q, const float* scales, float* y, int codec,
                               int layout, long long F, long long O, long long M, long long S,
                               int P, int design, void* stream) {
  TileView v;
  long long blocks;
  const int err = check(F, O, M, S, P, layout, codec, design, y, q, v, blocks);
  if (err != (int)cudaSuccess || blocks == 0) return err;
  const DecodeRun run{q, scales, y, codec, v, (unsigned)blocks, (cudaStream_t)stream};
  return by_design(P, design == kVecDesign, M == 1 || O == 1, run);
}
