// Local transpose (A, B, C) -> (B, A, C) of 4-byte (float32) or 8-byte
// (complex64 as one interleaved re/im pair) elements.
//
// Replaces: the Pallas TPU kernel of transpose01_pallas_call
// (src/repro/kernels/transpose/kernel.py, _transpose_kernel), the
// traditional redistribution's pack/unpack hot-spot (paper Eq. 16).  The
// reference splits complex input into re/im planes and transposes each; here
// a complex64 element is moved whole, as 8 bytes, with no plane split.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once (2 * A * B * C * size bytes); there is no arithmetic.  So the design
// keeps enough loads in flight to cover HBM's latency and spends few
// instructions on each element.  Two designs, one rule (design_of, twin of
// ref.transpose_design), picked per call by the wrapper:
//
// rows: a row (a, b) of C elements is contiguous in x and in y.  Where its
//   L = C * size bytes are a multiple of 16 and at least kRowsMinBytes, x
//   and y are 16-byte aligned and y has fewer than 2^31 16-byte vectors,
//   the rows go straight from x to y in 16-byte vectors, no shared memory.
//   A block writes kRowVecs * 256 consecutive vectors of y (16 KB), vector
//   o = blockIdx.x * 1024 + k * 256 + threadIdx.x for k < kRowVecs: a
//   warp's every store is 512 contiguous bytes, and so is its every load
//   where a row holds 32 vectors or more (else it spans whole rows of x).
//   Each thread loads its kRowVecs vectors before its first store: 64 bytes
//   a thread in flight.  o splits into y's row r = b * A + a and the vector
//   in it by two multiply-shifts (FastDiv), with the 64-bit offset of x
//   formed from them.  Vectors past y are masked.  Walking y in order
//   keeps a warp's accesses whole at short rows, where a thread group per
//   row of x would touch eight rows' half lines a load at 256-byte rows,
//   and it measured faster than walking x in order at 512^3 (PERF.md).
//
// tile: everything else (short rows: the pure 2-D transpose C = 1, C = 2,
//   3, 5, 35; row bytes off a multiple of 16; unaligned storage).  A block
//   moves a TA x TB x TC tile of x (TC <= C; TA and TB powers of two, sized
//   so a thread holds kTileThreadBytes) through shared memory.  Slot
//   i = threadIdx.x + s * 256 of the read is (ia, ib, c) with c fastest,
//   so a warp reads row a0 + ia of the tile, TB * TC contiguous elements
//   when TC == C; slot o of the write is (ib, ia, c), a contiguous run of
//   row b0 + ib of y.  A thread loads all its slots into registers before
//   any shared-memory store.  The tile sits at smem[ia * stride + ib * TC + c]
//   with stride = TB * TC + pad and pad such that stride = TC (mod 32): the
//   write's lanes, consecutive in (ia, c), then fall on consecutive banks.
//   A read slot splits by one multiply-shift (by TB * TC), a write slot by
//   two (by TA * TC, then TC); edges are masked.
//
// Neither kernel has a loop or divides by a runtime value: the FastDiv
// multipliers are made on the host.  The kernels allocate nothing and do
// not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kRowVecs = 4;             // rows: 16-byte vectors a thread loads before storing
constexpr long long kRowsMinBytes = 128;  // rows: the least row length
constexpr int kTileThreadBytes = 32;    // tile: bytes a thread holds in registers
constexpr int kBanks = 32;

enum Design { kTile = 0, kRows = 1 };

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31: (n * m) >> s with s = 31 +
// ceil(log2 d) and m = ceil(2^s / d), which is below 2^32 (the round-up
// method of Granlund and Montgomery, 1994).  Made on the host.
struct FastDiv {
  uint32_t d, m, s;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (uint32_t)(((uint64_t)n * m) >> s);
  }
};

FastDiv fast_div(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint32_t s = 31 + l;
  return {d, (uint32_t)(((1ull << s) + d - 1) / d), s};
}

struct RowsArgs {
  uint32_t total, B;  // A * B * vecs 16-byte vectors of y; B
  FastDiv vecs, A;    // a row's vectors; y's row r = b * A + a -> (b, a)
};

__global__ void __launch_bounds__(kThreads)
rows_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, RowsArgs g) {
  const uint32_t g0 = blockIdx.x * (kThreads * kRowVecs) + threadIdx.x;
  uint4 v[kRowVecs];
#pragma unroll
  for (int k = 0; k < kRowVecs; ++k) {
    const uint32_t o = g0 + k * kThreads;
    const uint32_t r = g.vecs.div(o), i = o - r * g.vecs.d;
    const uint32_t b = g.A.div(r), a = r - b * g.A.d;
    if (o < g.total) v[k] = __ldg(x + ((uint64_t)a * g.B + b) * g.vecs.d + i);
  }
#pragma unroll
  for (int k = 0; k < kRowVecs; ++k) {
    const uint32_t o = g0 + k * kThreads;
    if (o < g.total) y[o] = v[k];
  }
}

struct TileArgs {
  uint64_t A, B, C;           // x is (A, B, C), y is (B, A, C)
  uint32_t ta_bits, tb_bits;  // TA = 2^ta_bits, TB = 2^tb_bits
  FastDiv tc;                 // TC
  FastDiv row_in, row_out;    // a tile row of x (TB * TC slots), of y (TA * TC)
  FastDiv nc, nb;             // c and b tiles; blockIdx.x = (ka * nb + kb) * nc + kc
  uint32_t stride;            // the padded shared-memory row of one ia
  uint64_t skip_in, skip_out;  // B * C - TB * TC, A * C - TA * TC
};

// Either TC == C, so a tile row of x, (ib, c) for ib < TB, is TB * TC
// contiguous elements, or C > TC and TA = TB = 1, so it is TC of them: in
// both cases slot i of the read, in row ia = i / (TB * TC) at j = i - ia * TB
// * TC, sits at ia * B * C + j = ia * skip_in + i of the tile's corner in x,
// and at ia * stride + j in shared memory.  Likewise slot o of the write, in
// row ib = o / (TA * TC) at k = ia * TC + c, goes to ib * skip_out + o of
// the corner in y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ x, T* __restrict__ y, TileArgs g) {
  constexpr int kSlots = kTileThreadBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const uint32_t TC = g.tc.d;
  const uint32_t kab = g.nc.div(blockIdx.x), kc = blockIdx.x - kab * g.nc.d;
  const uint32_t ka = g.nb.div(kab), kb = kab - ka * g.nb.d;
  const uint64_t a0 = (uint64_t)ka << g.ta_bits, b0 = (uint64_t)kb << g.tb_bits;
  const uint64_t c0 = (uint64_t)kc * TC;
  const uint32_t ta = (uint32_t)min(g.A - a0, (uint64_t)1 << g.ta_bits);
  const uint32_t tb = (uint32_t)min(g.B - b0, (uint64_t)1 << g.tb_bits);
  const uint32_t tc = (uint32_t)min(g.C - c0, (uint64_t)TC);
  const uint32_t live_in = tb * tc, live_out = ta * tc;  // live slots of a tile row
  const T* src = x + (a0 * g.B + b0) * g.C + c0;
  T* dst = y + (b0 * g.A + a0) * g.C + c0;

  T v[kSlots];
  uint32_t at[kSlots];  // each read slot's shared-memory index, or ~0 past the tile
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const uint32_t i = threadIdx.x + s * kThreads;
    const uint32_t ia = g.row_in.div(i), j = i - ia * g.row_in.d;
    const T* p = src + ((uint64_t)ia * g.skip_in + i);
    const bool in = ia < ta && j < live_in;
    at[s] = in ? ia * g.stride + j : ~0u;
    if (in) v[s] = __ldg(p);
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (at[s] != ~0u) smem[at[s]] = v[s];
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const uint32_t o = threadIdx.x + s * kThreads;
    const uint32_t ib = g.row_out.div(o), k = o - ib * g.row_out.d;
    const uint32_t ia = g.tc.div(k), c = k - ia * TC;
    T* p = dst + ((uint64_t)ib * g.skip_out + o);
    if (ib < tb && k < live_out) *p = smem[ia * g.stride + ib * TC + c];
  }
}

// The launch of one design: grid, block extents and the kernel's arguments.
struct Plan {
  long long grid;
  long long p[4];  // rows: vecs, 0, 0, 0; tile: TA, TB, TC, stride
  size_t smem;
};

int design_of(long long A, long long B, long long C, int elem, long long x_mod16,
              long long y_mod16) {
  const long long L = C * elem;
  return (L % 16 == 0 && L >= kRowsMinBytes && x_mod16 == 0 && y_mod16 == 0 &&
          A * B * (L / 16) < (1LL << 31))
             ? kRows
             : kTile;
}

Plan plan_of(long long A, long long B, long long C, int elem, int design) {
  Plan pl = {0, {0, 0, 0, 0}, 0};
  if (design == kRows) {
    const long long vecs = C * elem / 16, per_block = (long long)kThreads * kRowVecs;
    pl.grid = (A * B * vecs + per_block - 1) / per_block;
    pl.p[0] = vecs;
    return pl;
  }
  const long long cap = (long long)kThreads * (kTileThreadBytes / elem);
  const long long tc = std::min(C, cap);
  long long t = 1;
  while (4 * t * t * tc <= cap) t *= 2;
  const long long ta = 2 * t * t * tc <= cap ? 2 * t : t, tb = t;
  const long long pad = ((tc - tb * tc) % kBanks + kBanks) % kBanks;
  pl.grid = ((A + ta - 1) / ta) * ((B + tb - 1) / tb) * ((C + tc - 1) / tc);
  pl.p[0] = ta;
  pl.p[1] = tb;
  pl.p[2] = tc;
  pl.p[3] = tb * tc + pad;
  pl.smem = (size_t)(ta * pl.p[3] * elem);
  return pl;
}

int log2_of(long long p) {
  int b = 0;
  while ((1LL << b) < p) ++b;
  return b;
}

}  // namespace

// The design (0 tile, 1 rows) that transpose01 takes for an (A, B, C) x of
// `elem_bytes` elements whose x and y addresses are x_mod16, y_mod16 mod 16.
extern "C" int transpose01_design(long long A, long long B, long long C, int elem_bytes,
                                  long long x_mod16, long long y_mod16) {
  return design_of(A, B, C, elem_bytes, x_mod16, y_mod16);
}

// The launch of `design` for that x: out = {blocks, p0, p1, p2, p3, shared
// bytes} (rows: a row's 16-byte vectors; tile: TA, TB, TC, stride).
extern "C" void transpose01_plan(long long A, long long B, long long C, int elem_bytes,
                                 int design, long long* out) {
  const Plan pl = plan_of(A, B, C, elem_bytes, design);
  out[0] = pl.grid;
  for (int i = 0; i < 4; ++i) out[1 + i] = pl.p[i];
  out[5] = (long long)pl.smem;
}

// x: (A, B, C) contiguous elements of `elem_bytes` (4 or 8); y: (B, A, C).
// `design` is transpose01_design's; rows off its rule is refused
// (cudaErrorInvalidValue).  Returns cudaGetLastError().
extern "C" int transpose01(const void* x, void* y, long long A, long long B, long long C,
                           int elem_bytes, int design, void* stream) {
  if (A < 0 || B < 0 || C < 0 || (elem_bytes != 4 && elem_bytes != 8) ||
      (design != kTile && design != kRows))
    return (int)cudaErrorInvalidValue;
  if (design == kRows &&
      design_of(A, B, C, elem_bytes, (long long)((uintptr_t)x % 16),
                (long long)((uintptr_t)y % 16)) != kRows)
    return (int)cudaErrorInvalidValue;
  if (A == 0 || B == 0 || C == 0) return (int)cudaSuccess;
  const Plan pl = plan_of(A, B, C, elem_bytes, design);
  if (pl.grid > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (design == kRows) {
    const RowsArgs g = {(uint32_t)(A * B * pl.p[0]), (uint32_t)B, fast_div((uint32_t)pl.p[0]),
                        fast_div((uint32_t)A)};
    rows_kernel<<<(unsigned)pl.grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(y), g);
    return (int)cudaGetLastError();
  }
  const long long ta = pl.p[0], tb = pl.p[1], tc = pl.p[2];
  TileArgs g;
  g.A = A;
  g.B = B;
  g.C = C;
  g.ta_bits = log2_of(ta);
  g.tb_bits = log2_of(tb);
  g.tc = fast_div((uint32_t)tc);
  g.row_in = fast_div((uint32_t)(tb * tc));
  g.row_out = fast_div((uint32_t)(ta * tc));
  g.nc = fast_div((uint32_t)((C + tc - 1) / tc));
  g.nb = fast_div((uint32_t)((B + tb - 1) / tb));
  g.stride = (uint32_t)pl.p[3];
  g.skip_in = B * C - tb * tc;
  g.skip_out = A * C - ta * tc;
  if (elem_bytes == 4) {
    tile_kernel<unsigned int><<<(unsigned)pl.grid, kThreads, pl.smem, st>>>(
        static_cast<const unsigned int*>(x), static_cast<unsigned int*>(y), g);
  } else {
    tile_kernel<unsigned long long><<<(unsigned)pl.grid, kThreads, pl.smem, st>>>(
        static_cast<const unsigned long long*>(x), static_cast<unsigned long long*>(y), g);
  }
  return (int)cudaGetLastError();
}
