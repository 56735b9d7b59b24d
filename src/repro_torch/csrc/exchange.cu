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
// (int8) or 2 (bf16) per float; int8 reads the block twice, once for the
// max-abs and once to quantize (the second read mostly hits L2 only for
// small blocks).  Decode reads 1-2 bytes and writes 4 per float.
//
// Design: the TPU grid (F, M) runs one program per scale block, which on
// one card with F = M = 1 would leave one SM doing all the work.  Here a
// run is one (f, o, m) row of S * P contiguous floats; every run is cut
// into tiles of kTile floats and every tile is a block, so the grid covers
// the whole card whatever F and M are.  The int8 max-abs is a per-tile
// reduction finished by one atomicMax per tile on the float bits (the
// values are >= 0, so their bit patterns order like the floats), and the
// quantize pass reads the finished max.  Reads of the block side are
// coalesced; the wire side is two contiguous streams (re and im planes).
// The kernels allocate nothing (the wrapper zeroes the max-abs scratch)
// and do not synchronise.
//
// Guard mode (the reference's encode_pallas_call(guard=True)): with a
// non-null `counts`, the encode also counts, per (f, m) scale block, the
// non-finite elements and (int8) the elements quantized to +-127.  Each count
// rides the pass that already reads the element: the max-abs pass for int8
// non-finites, the encode pass for bf16 non-finites and int8 saturation.  A
// tile sums its counts with warp shuffles and adds them with one integer
// atomicAdd per (f, m) into unsigned 64-bit scratch (exact at any size; the
// wrapper converts to f32).  Counts are laid out like the scales, with a
// trailing (nonfinite, saturated) pair.  `scale_div` divides the int8 scale
// after the /127 (the saturation fault); 1.0 leaves every bit unchanged.
// The counting is a template parameter, so an unguarded encode runs the
// same instructions as one without guard mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = 4096;

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

template <bool kGuard>
__global__ void amax_kernel(const float* __restrict__ x, unsigned int* __restrict__ amax,
                            unsigned long long* __restrict__ counts, int layout, View v) {
  long long f, o, m, tile;
  run_of(v, f, o, m, tile);
  const long long len = v.S * v.P;
  const float* base = x + ((f * v.O + o) * v.M + m) * len;
  const long long end = min(len, (tile + 1) * kTile);
  float best = 0.0f;
  unsigned int bad = 0;
  for (long long i = tile * kTile + threadIdx.x; i < end; i += blockDim.x) {
    const float a = base[i];
    if (isfinite(a)) best = fmaxf(best, fabsf(a));
    else if (kGuard) ++bad;
  }
  for (int off = 16; off > 0; off >>= 1) best = fmaxf(best, __shfl_down_sync(0xffffffffu, best, off));
  __shared__ float warp_best[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) best = fmaxf(best, warp_best[i]);
    atomicMax(amax + f * v.M + m, __float_as_uint(best));
  }
  if (kGuard) {
    bad = block_count(bad);
    if (threadIdx.x == 0 && bad != 0)
      atomicAdd(counts + 2 * stat_index(v, layout, f, m), (unsigned long long)bad);
  }
}

template <bool kGuard>
__global__ void encode_kernel(const float* __restrict__ x, void* __restrict__ q,
                              const unsigned int* __restrict__ amax, float* __restrict__ scales,
                              unsigned long long* __restrict__ counts, float scale_div,
                              int codec, int layout, View v) {
  long long f, o, m, tile;
  run_of(v, f, o, m, tile);
  const long long len = v.S * v.P;
  const float* base = x + ((f * v.O + o) * v.M + m) * len;
  const long long end = min(len, (tile + 1) * kTile);
  unsigned int hits = 0;  // bf16: non-finite elements; int8: elements at +-127
  if (codec == 0) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(q);
    for (long long i = tile * kTile + threadIdx.x; i < end; i += blockDim.x) {
      const long long s = i / v.P;
      const int p = (int)(i - s * v.P);
      const float a = base[i];
      if (kGuard) hits += !isfinite(a);
      out[wire_index(v, layout, f, o, m, s, p)] = __float2bfloat16_rn(a);
    }
  } else {
    const float scale = fmaxf(__uint_as_float(amax[f * v.M + m]), 1e-12f) / 127.0f / scale_div;
    if (o == 0 && tile == 0 && threadIdx.x == 0) scales[stat_index(v, layout, f, m)] = scale;
    signed char* out = static_cast<signed char*>(q);
    for (long long i = tile * kTile + threadIdx.x; i < end; i += blockDim.x) {
      const long long s = i / v.P;
      const int p = (int)(i - s * v.P);
      const float a = base[i];
      const float xf = isfinite(a) ? a : 0.0f;
      const float r = fminf(fmaxf(rintf(xf / scale), -127.0f), 127.0f);
      if (kGuard) hits += fabsf(r) == 127.0f;
      out[wire_index(v, layout, f, o, m, s, p)] = (signed char)(int)r;
    }
  }
  if (kGuard) {
    hits = block_count(hits);
    if (threadIdx.x == 0 && hits != 0)
      atomicAdd(counts + 2 * stat_index(v, layout, f, m) + codec, (unsigned long long)hits);
  }
}

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

}  // namespace

// x: the block, (F, O, M, S, P) floats.  q: the payload, bf16 (codec 0) or
// int8 (codec 1) in `layout`.  int8 also writes `scales` and needs `amax`,
// F * M zeroed words of scratch.  `counts` (guard mode, else null): F * M * 2
// zeroed 64-bit counters.  Returns cudaGetLastError().
extern "C" int exchange_encode(const float* x, void* q, float* scales, unsigned int* amax,
                               unsigned long long* counts, int codec, int layout, long long F,
                               long long O, long long M, long long S, int P, float scale_div,
                               void* stream) {
  View v;
  long long blocks;
  int err = make_view(F, O, M, S, P, v, blocks);
  if (err != (int)cudaSuccess) return err;
  if (blocks == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (codec == 1) {
    if (counts != nullptr)
      amax_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(x, amax, counts, layout, v);
    else
      amax_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(x, amax, counts, layout, v);
    err = (int)cudaGetLastError();
    if (err != (int)cudaSuccess) return err;
  } else if (codec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (counts != nullptr)
    encode_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(x, q, amax, scales, counts,
                                                              scale_div, codec, layout, v);
  else
    encode_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(x, q, amax, scales, counts,
                                                               scale_div, codec, layout, v);
  return (int)cudaGetLastError();
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
