// Batched four-step DFT along the last axis of a contiguous complex64 (or
// float32, rfft) tensor: y[b, k] = sum_j x[b, j] exp(-+2 pi i j k / n).
//
// Replaces: the Pallas TPU kernel of fourstep_pallas_call (with
// fourstep_kernel, _cmatmul and _cmatmul2) in src/repro/kernels/fft/kernel.py.
//
// Algorithm: n = n1 * n2.  Step 1 contracts n1 with the DFT-n1 matrix, step
// 2 multiplies by the twiddles, step 3 contracts n2 with the DFT-n2 matrix,
// and step 4 is the output index k = k1 + n1 * k2, so the result lands in
// natural order.  The inverse uses the conjugate roots and multiplies by
// 1/n at the end, which is the reference's conj(fft(conj(x))) / n.  Two
// designs, chosen by the caller's split (plan_factors; ops.tensor_core_design
// applies the same rule):
//
// Tensor-core design (fourstep_tc_kernel), for n1, n2 multiples of 8 and at
// most 64 (512 = 32 * 16, 1024, 2048, 4096).  The least time it could take
// is HBM's, 16 n bytes a row (0.64 ms for 2^27 complex64 at 3.35 TB/s):
// its 3 * 2 * ((2 n1)^2 n2 + (2 n2)^2 n1) TF32 operations a row take 0.31 ms
// at 512^3 at the dense TF32 peak.  mma.sync does not reach that peak:
// the three passes' mma issue sets its pace (PERF.md), and wgmma is the
// next step.  Both contractions are one shape, a constant real matrix F
// (the DFT matrix in block form [[Fr, -Fi], [Fi, Fr]]) times a tile
// already in shared memory, so one warp routine (contract) serves both on
// mma.sync m16n8k8 TF32:
//  - 3xTF32: the caller splits F on the host (float64 -> fp32 -> big =
//    tf32(f), small = tf32(f - big)) and the kernel splits each data value
//    as it reads it, big = its truncation to TF32 (one op, NaN and Inf
//    kept non-finite), small = tf32(x - big); big.small + small.big +
//    big.big summed in fp32 keeps fp32 accuracy (1xTF32 is ~3e-4 off, over
//    the 1e-5 limit).  The split's integer ops, not the mma, are a large
//    share of the issue slots.
//  - The contracted index j of F's columns is ordered (Re j0..j0+3,
//    Im j0..j0+3) within a k-step of 8 and F's rows (Re k0..k0+7,
//    Im k0..k0+7) within an m-tile of 16, so a thread's B fragment is one
//    complex value (one 8-byte load) and its accumulators hold the real and
//    imaginary parts of the same outputs: the twiddle multiply and the
//    output stores happen in registers.
//  - A persistent block (as many as fit on the SMs) first gathers F1's
//    and F2's fragments from the caller's block-form tables into shared
//    memory in fragment order (one 16-byte load a fragment, 16 (n1^2 +
//    n2^2) bytes), then walks groups of R whole rows (R <= 8, about 110 KB
//    of shared memory, so two blocks share an SM at n <= 1024).  A group
//    is copied with cp.async, all in flight at once, into a padded
//    (row, j, column) tile (4 complex of pad a j-line spread the fragment
//    loads over all banks); step 1 writes the twiddled (row, i2, k1) tile;
//    the next group's copy is issued into the freed input tile and
//    overlaps step 3, which writes y[row][k1 + n1 k2] straight from its
//    accumulators, the first nout bins only (the inverse times 1/n).  A
//    warp carries 8 n-tiles per A fragment (4 where the n-tiles are not a
//    multiple of 8).  The twiddles are read through the read-only cache.
//  - The kernel computes no roots: the tables come from the caller.
//
// General design (fourstep_kernel), every other length, on the FMA cores in
// fp32, with its own split (general_split: n2 the largest divisor of n at
// most sqrt(n), so 64 = 8 * 8 and a prime stays one direct DFT; for n > 256
// that is plan_factors' split), so a length up to 256 costs n (n1 + n2)
// complex multiply-adds a row, not n^2.  What it is built around:
//  - Registers: a thread owns one column and accumulates 8 bins in
//    registers (dft_bins), 16 independent FMA chains, so one data read
//    serves 8 bins.
//  - Warp-uniform roots: the lanes of a warp take the rows of one column
//    (then the next), so they all need the same root at once and its read
//    is a broadcast: a float4 of two roots from the DFT matrices in shared
//    memory for n1 <= 32, else the n-th root at an index carried from one
//    term to the next (no division); the twiddle w[k1 i2] once a bin.
//  - Conflict-free data: rows innermost in shared memory, (j, r) at
//    j * (rows | 1) + r, so steps 1 and 3 read and write consecutive words
//    and the copies in (cp.async, in flight while the roots are computed)
//    and out (coalesced) stride an odd number of words.
//  - Parallelism: up to 16 rows a block, fewer while the grid would hold
//    under two blocks an SM (the quickstart's 2646 rows: 8 rows a block,
//    331 blocks) or a block would pass 48 KB, and a thread a work item;
//    a row of up to 9685 (3 * 8n bytes with the roots) fits in a block.
//  - The n roots of unity are computed once a block in double (sincospi,
//    n a block), amortised over its rows, and the DFT matrices gathered
//    from them; no runtime division is left in a loop over terms.
//
// Neither design allocates memory or synchronises the device.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 232448;  // 227 KB, the most one block may use

// an asynchronous copy of 8 bytes (or 4) from global to shared memory
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool eight) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (eight)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// i / d for 0 <= i < 2^16 and 1 <= d < 2^16: __umulhi(i, ceil(2^32 / d)) is
// exact there (its error i / 2^32 stays below 1 / d).
struct FastDiv {
  uint32_t d, m;
  __device__ explicit FastDiv(uint32_t d_) : d(d_), m(0xFFFFFFFFu / d_ + 1u) {}
  __device__ uint32_t operator()(uint32_t i) const { return d == 1 ? i : __umulhi(i, m); }
};


// ---------------------------------------------------------------------------
// general design
// ---------------------------------------------------------------------------

constexpr int kBins = 8;          // bins a thread accumulates in registers
constexpr int kTableMax = 32;     // n1 up to this reads whole root matrices
constexpr int kLogRowsMax = 4;    // at most 16 rows a block
constexpr int kGenThreads = 256;

// The general design's split n = n1 * n2: n2 the largest divisor of n at
// most sqrt(n), so n1 >= n2 and both as near sqrt(n) as n's divisors allow
// (64 = 8 * 8, 63 = 9 * 7, 42 = 7 * 6; a prime gives (n, 1)).  For n > 256
// it is plan_factors' split; ref.general_split is its Python twin.
void general_split(int n, int* n1, int* n2) {
  int d = 1;
  while ((long long)(d + 1) * (d + 1) <= n) ++d;
  while (n % d != 0) --d;
  *n1 = n / d;
  *n2 = d;
}

// the n-th roots w[t] = exp(-+2 pi i t / n), t < n, in float32 from sincospi
// in double (its argument t * (2 / n): one division a thread)
__device__ __forceinline__ void roots_of_unity(float2* w, int n, int inverse) {
  const double step = 2.0 / (double)n;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    double s, c;
    sincospi((double)t * step, &s, &c);
    w[t] = make_float2((float)c, inverse ? (float)s : (float)-s);
  }
}

// acc += a * (fr + i fi): four FMAs in a fixed order (ref.fourstep_general_ref
// repeats it)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float fr, float fi) {
  acc.x = fmaf(a.x, fr, acc.x);
  acc.x = fmaf(-a.y, fi, acc.x);
  acc.y = fmaf(a.x, fi, acc.y);
  acc.y = fmaf(a.y, fr, acc.y);
}

// acc[j] = sum_{i < m} src[i * step] * F[k0 + j][i] for j < kBins, F the
// DFT-m matrix: with kTable its rows k0.. of the table f[i * ld + k]
// (roots = f + k0), else the n-th roots w = roots at (k i mod m) * ld
// (ld = n / m), the index carried from one i to the next.  Every lane of a
// warp runs the same i and, but where a warp spans two bin blocks, the
// same k0, so a root read is a broadcast.
template <bool kTable>
__device__ __forceinline__ void dft_bins(float2 (&acc)[kBins], const float2* src, int step,
                                         int m, const float2* roots, int ld, int k0, int n) {
#pragma unroll
  for (int j = 0; j < kBins; ++j) acc[j] = make_float2(0.0f, 0.0f);
  if constexpr (kTable) {
    const float4* f = reinterpret_cast<const float4*>(roots);
#pragma unroll 2
    for (int i = 0; i < m; ++i, src += step, f += ld / 2) {
      const float2 a = *src;
#pragma unroll
      for (int h = 0; h < kBins / 2; ++h) {
        const float4 w = f[h];
        cmac(acc[2 * h], a, w.x, w.y);
        cmac(acc[2 * h + 1], a, w.z, w.w);
      }
    }
  } else {
    int e[kBins], inc[kBins];
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      inc[j] = (k0 + j < m ? k0 + j : 0) * ld;  // < n; a bin past m reads w[0]
      e[j] = 0;
    }
#pragma unroll 2
    for (int i = 0; i < m; ++i, src += step) {
      const float2 a = *src;
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        const float2 w = roots[e[j]];
        cmac(acc[j], a, w.x, w.y);
        const unsigned s = (unsigned)(e[j] + inc[j]);  // < 2n: one wrap, no division
        e[j] = (int)min(s, s - (unsigned)n);
      }
    }
  }
}

// A block transforms 2^log_rows whole rows.  Shared memory holds the roots,
// then the input xs and step 1's output cs, both (j, r) at j * rs + r with
// rs = rows | 1: rows innermost, so a warp's lanes (the rows of one column,
// then the next column) read and write consecutive words in steps 1 and 3,
// and the odd stride keeps the copies in and out (lanes along j) off one
// bank.  Step 3 writes the output over xs in the same layout.  The roots:
// the n-th roots w[t] (n sincospi a block), the twiddles T[k1][i2] =
// w[k1 i2], and
//  - kTable (n1 <= kTableMax): the matrices F1[i1][k1] = w[(k1 i1 mod n1)
//    n2] (n1 x ld1) and F2[i2][k2] = w[(k2 i2 mod n2) n1] (n2 x ld2)
//    gathered from w, ld = the factor rounded up to kBins, 0 past it;
//  - else F1 and F2 read from w at an index carried from term to term.
// Step 1: a thread owns one column (r, i2) and kBins bins k1, and writes
// cs[(i2 n1 + k1) rs + r] = T[k1][i2] sum_i1 F1[k1][i1] x[r][i1 n2 + i2].
// Step 3: a thread owns (r, k1) and kBins bins k2, and writes
// y[r][k1 + n1 k2] = sum_i2 F2[k2][i2] cs[.][k1] (times 1/n for the inverse).
template <bool kTable>
__global__ void __launch_bounds__(kGenThreads)
    fourstep_kernel(const float* __restrict__ x, float2* __restrict__ y, long long batch, int n,
                    int n1, int n2, int log_rows, int inverse, int real_input, int nout) {
  extern __shared__ float4 smem_general[];
  const int rows = 1 << log_rows, rs = rows | 1;
  const int ld1 = (n1 + kBins - 1) / kBins * kBins, ld2 = (n2 + kBins - 1) / kBins * kBins;
  float2* f1 = reinterpret_cast<float2*>(smem_general);  // kTable: F1, F2
  float2* f2 = f1 + (kTable ? n1 * ld1 : 0);
  float2* w = f2 + (kTable ? n2 * ld2 : 0);
  float2* xs = w + n;
  float2* cs = xs + n * rs;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, batch - row0);

  // the rows into xs, every copy in flight while the roots are computed;
  // a ragged block's missing rows as zeros (rows * n < 2^16: 16 bytes of
  // shared memory an element)
  const FastDiv div_n(n), div_n1(n1), div_n2(n2);
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    const int r = div_n(i), j = i - r * n;
    float2* dst = xs + j * rs + r;
    if (r >= nrows) {
      *dst = make_float2(0.0f, 0.0f);
    } else if (real_input) {
      cp_async(&dst->x, x + row0 * n + i, false);
      dst->y = 0.0f;
    } else {
      cp_async(dst, reinterpret_cast<const float2*>(x) + row0 * n + i, true);
    }
  }
  roots_of_unity(w, n, inverse);
  if constexpr (kTable) {
    __syncthreads();
    const FastDiv div_ld1(ld1), div_ld2(ld2);  // operands < 2^16
    for (int t = threadIdx.x; t < n1 * ld1 + n2 * ld2; t += blockDim.x) {
      float2 v = make_float2(0.0f, 0.0f);
      if (t < n1 * ld1) {
        const int i = div_ld1(t), k = t - i * ld1, e = i * k - div_n1(i * k) * n1;
        if (k < n1) v = w[e * n2];
      } else {
        const int u = t - n1 * ld1, i = div_ld2(u), k = u - i * ld2;
        const int e = i * k - div_n2(i * k) * n2;
        if (k < n2) v = w[e * n1];
      }
      f1[t] = v;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // steps 1-2; a work item is (bin block, i2, r), r fastest
  const int nb1 = ld1 / kBins, nb2 = ld2 / kBins;
  for (int it = threadIdx.x; it < (rows * n2 * nb1); it += blockDim.x) {
    const int r = it & (rows - 1), col = it >> log_rows;
    const int kb = div_n2(col), i2 = col - kb * n2, k0 = kb * kBins;
    float2 acc[kBins];
    dft_bins<kTable>(acc, xs + i2 * rs + r, n2 * rs, n1, kTable ? f1 + k0 : w,
                     kTable ? ld1 : n2, k0, n);
    float2 t[kBins];  // the twiddles, all read before any store
#pragma unroll
    for (int j = 0; j < kBins; ++j) t[j] = w[k0 + j < n1 ? (k0 + j) * i2 : 0];
    float2* out = cs + (i2 * n1 + k0) * rs + r;
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      float2 c = make_float2(0.0f, 0.0f);
      cmac(c, acc[j], t[j].x, t[j].y);
      if (k0 + j < n1) out[j * rs] = c;
    }
  }
  __syncthreads();

  // steps 3-4; a work item is (bin block, k1, r), r fastest; the output
  // (k, r) over xs
  const float scale = inverse ? 1.0f / (float)n : 1.0f;
  for (int it = threadIdx.x; it < (rows * n1 * nb2); it += blockDim.x) {
    const int r = it & (rows - 1), col = it >> log_rows;
    const int kb = div_n1(col), k1 = col - kb * n1, k0 = kb * kBins;
    float2 acc[kBins];
    dft_bins<kTable>(acc, cs + k1 * rs + r, n1 * rs, n2, kTable ? f2 + k0 : w,
                     kTable ? ld2 : n1, k0, n);
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      const int k = k1 + n1 * (k0 + j);
      if (k0 + j < n2 && k < nout)
        xs[k * rs + r] = make_float2(acc[j].x * scale, acc[j].y * scale);
    }
  }
  __syncthreads();

  // the output rows out, coalesced
  const FastDiv div_out(nout);
  float2* yr = y + row0 * nout;
#pragma unroll 4
  for (int i = threadIdx.x; i < nrows * nout; i += blockDim.x) {
    const int r = div_out(i), k = i - r * nout;
    yr[i] = xs[k * rs + r];
  }
}

int launch_general(const void* x, void* y, long long batch, int n, int inverse, int real_input,
                   int nout, cudaStream_t stream) {
  int n1, n2;
  general_split(n, &n1, &n2);
  const bool table = n1 <= kTableMax;
  const size_t ld1 = (n1 + kBins - 1) / kBins * kBins, ld2 = (n2 + kBins - 1) / kBins * kBins;
  const size_t roots = (table ? n1 * ld1 + n2 * ld2 : 0) + (size_t)n;
  auto smem_of = [&](int log_rows) {
    return (roots + 2 * (size_t)n * ((1 << log_rows) | 1)) * sizeof(float2);
  };
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  // rows a block: at most 16, halved while a block would pass 48 KB or the
  // grid would hold fewer than two blocks an SM
  int log_rows = kLogRowsMax;
  while (log_rows > 0 && (smem_of(log_rows) > kSmemDefault ||
                          ((batch + (1 << log_rows) - 1) >> log_rows) < 2LL * sms))
    --log_rows;
  const size_t smem = smem_of(log_rows);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const long long blocks = (batch + (1 << log_rows) - 1) >> log_rows;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const int items = (1 << log_rows) * (int)std::max(n2 * (ld1 / kBins), n1 * (ld2 / kBins));
  const int threads = std::min(kGenThreads, (items + 31) / 32 * 32);
  auto kernel = table ? fourstep_kernel<true> : fourstep_kernel<false>;
  if (smem > kSmemDefault) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float2*>(y), batch, n, n1, n2, log_rows, inverse,
      real_input, nout);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// tensor-core design
// ---------------------------------------------------------------------------

constexpr int kPad = 4;      // complex pad after each j-line of a tile
constexpr int kTcThreads = 256;
constexpr int kTcRowsMax = 8;
constexpr size_t kTcSmemTarget = 110 * 1024;  // two blocks an SM where the tables allow

// f rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 does for finite f (and ref.tf32_round), in two
// integer ops.  For the small parts only: a NaN there may carry into the
// sign and come out as -0, but then the big part holds the NaN or Inf.
__device__ __forceinline__ uint32_t to_tf32(float f) {
  return (__float_as_uint(f) + 0x1000u) & 0xFFFFE000u;
}

// f truncated to TF32 (ref.tf32_trunc), one op: the big part of a data
// value.  NaN and Inf stay non-finite and keep their sign; f - big is exact
// and below 2^-10 |f|, and its rounding to TF32 keeps the split's error
// near 2^-21 |f|.
__device__ __forceinline__ uint32_t tf32_trunc(float f) {
  return __float_as_uint(f) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of the m x m DFT matrix in real block form (2m x 2m,
// split into TF32 big and small), gathered into fragment order:
// fa[(mt * m / 4 + ks) * 32 + lane] = {Fr, Fi big; Fr, Fi small} at
// k = 8 mt + lane / 4, j = 4 ks + lane % 4.  The fragment is
// {Fr, Fi, -Fi, Fr}: rows k (real) and k + 8 (imaginary) of the m-tile,
// columns j (real part of the input) and j + 4 (imaginary).
__device__ void gather_fragments(float4* fa, const float* __restrict__ big,
                                 const float* __restrict__ small, int m) {
  const int ld = 2 * m, ksteps = m / 4;
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
    const int lane = e & 31, ks = (e >> 5) % ksteps, mt = (e >> 5) / ksteps;
    const int k = 8 * mt + (lane >> 2), j = 4 * ks + (lane & 3);
    fa[e] = make_float4(big[k * ld + j], big[(m + k) * ld + j], small[k * ld + j],
                        small[(m + k) * ld + j]);
  }
}

// out[k][c] = sum_j F[k][j] src[c][j] over a tile of `rows` rows: F is the
// complex m x m matrix whose fragments fa holds (gather_fragments),
// src[r * m * stride + j * stride + cc] the complex input of column
// c = r * inner + cc.  Each warp takes work items of one m-tile (outputs
// k0..k0+7, real and imaginary) by kTileN n-tiles and calls
// ep(acc, k, r, cc) with acc = {Re out[k][cc], Re out[k][cc + 1],
// Im out[k][cc], Im out[k][cc + 1]}.  The products have no branch, so the
// tiles' mma chains interleave: an n-tile past the last is computed from
// column 0 and dropped.
template <int kTileN, class Epilogue>
__device__ __forceinline__ void contract(const float4* fa, int m, const float2* src, int inner,
                                         int stride, int rows, Epilogue ep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int ntiles = rows * inner / 8, groups = (ntiles + kTileN - 1) / kTileN;
  const int mtiles = m / 8, ksteps = m / 4;
  const FastDiv div_inner(inner), div_groups(groups);  // operands < 2^16
  for (int item = warp; item < mtiles * groups; item += nwarps) {
    const int mt = div_groups(item), j0 = (item - mt * groups) * kTileN;
    float acc[kTileN][4];
    int boff[kTileN];
#pragma unroll
    for (int t = 0; t < kTileN; ++t) {
      const int c = j0 + t < ntiles ? 8 * (j0 + t) : 0, r = div_inner(c);
      boff[t] = r * m * stride + (c - r * inner) + g;
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
    }
    const float4* fm = fa + mt * ksteps * 32 + lane;
#pragma unroll 4
    for (int ks = 0; ks < ksteps; ++ks) {
      const float4 f = fm[ks * 32];
      const uint32_t rb = __float_as_uint(f.x), ib = __float_as_uint(f.y);
      const uint32_t rs = __float_as_uint(f.z), is = __float_as_uint(f.w);
      const uint32_t ab[4] = {rb, ib, ib ^ 0x80000000u, rb};
      const uint32_t as[4] = {rs, is, is ^ 0x80000000u, rs};
      const int j = ks * 4 + q;
#pragma unroll
      for (int t = 0; t < kTileN; ++t) {
        const float2 v = src[boff[t] + j * stride];
        const uint32_t br = tf32_trunc(v.x), bi = tf32_trunc(v.y);
        const uint32_t sr = to_tf32(v.x - __uint_as_float(br));
        const uint32_t si = to_tf32(v.y - __uint_as_float(bi));
        mma_tf32(acc[t], as, br, bi);
        mma_tf32(acc[t], ab, sr, si);
        mma_tf32(acc[t], ab, br, bi);
      }
    }
#pragma unroll
    for (int t = 0; t < kTileN; ++t) {
      if (j0 + t < ntiles) {
        const int c = 8 * (j0 + t) + 2 * q, r = div_inner(c);
        ep(acc[t], mt * 8 + g, r, c - r * inner);
      }
    }
  }
}

// mats: F1 big, F1 small (2 n1 x 2 n1), F2 big, F2 small (2 n2 x 2 n2), the
// twiddles T[k1][i2] (n1 x n2 complex), all float32.  A persistent block
// walks groups of `rows` rows blockIdx.x, + gridDim.x, ...; the next
// group's copy overlaps step 3 of the current one.
__global__ void __launch_bounds__(kTcThreads)
    fourstep_tc_kernel(const float* __restrict__ x, float2* __restrict__ y,
                       const float* __restrict__ mats, long long batch, int n, int n1, int n2,
                       int rows, int inverse, int real_input, int nout) {
  extern __shared__ float4 smem4[];
  const int sx = n2 + kPad, sc = n1 + kPad;
  float4* fa1 = smem4;                  // n1^2 fragments of F1
  float4* fa2 = fa1 + n1 * n1;          // n2^2 fragments of F2
  float2* xs = reinterpret_cast<float2*>(fa2 + n2 * n2);  // rows x (i1, i2), j-lines of sx
  float2* cs = xs + rows * n1 * sx;     // rows x (i2, k1), j-lines of sc
  const float* f1b = mats;
  const float* f1s = f1b + 4 * n1 * n1;
  const float* f2b = f1s + 4 * n1 * n1;
  const float* f2s = f2b + 4 * n2 * n2;
  const float2* tw = reinterpret_cast<const float2*>(f2s + 4 * n2 * n2);
  const long long ngroups = (batch + rows - 1) / rows;
  const FastDiv div_n(n), div_n2(n2);
  const float scale = inverse ? 1.0f / (float)n : 1.0f;

  // the rows of one group into the padded tile, every copy in flight at
  // once; the missing rows of the last group as zeros
  auto load = [&](long long grp) {
    const long long row0 = grp * rows;
    const int nrows = (int)min((long long)rows, batch - row0);
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {  // rows * n < 2^16
      const int r = div_n(i), rem = i - r * n;
      const int i1 = div_n2(rem), i2 = rem - i1 * n2;
      float2* dst = xs + (r * n1 + i1) * sx + i2;
      if (r >= nrows) {
        *dst = make_float2(0.0f, 0.0f);
      } else if (real_input) {
        cp_async(&dst->x, x + row0 * n + i, false);
        dst->y = 0.0f;
      } else {
        cp_async(dst, reinterpret_cast<const float2*>(x) + row0 * n + i, true);
      }
    }
  };

  if ((long long)blockIdx.x < ngroups) load(blockIdx.x);
  gather_fragments(fa1, f1b, f1s, n1);
  gather_fragments(fa2, f2b, f2s, n2);
  for (long long grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    const long long row0 = grp * rows;
    const int nrows = (int)min((long long)rows, batch - row0);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();

    // steps 1-2: cs[r][i2][k1] = T[k1][i2] * sum_i1 F1[k1][i1] x[r][i1][i2]
    auto twiddle = [&](const float (&a)[4], int k1, int r, int i2) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(tw + k1 * n2 + i2));
      cs[(r * n2 + i2) * sc + k1] =
          make_float2(a[0] * t.x - a[2] * t.y, a[0] * t.y + a[2] * t.x);
      cs[(r * n2 + i2 + 1) * sc + k1] =
          make_float2(a[1] * t.z - a[3] * t.w, a[1] * t.w + a[3] * t.z);
    };
    if (rows * n2 % 64 == 0)  // n-tiles a multiple of 8: no tile is wasted
      contract<8>(fa1, n1, xs, n2, sx, rows, twiddle);
    else
      contract<4>(fa1, n1, xs, n2, sx, rows, twiddle);
    __syncthreads();
    if (grp + gridDim.x < ngroups) load(grp + gridDim.x);  // xs is free again

    // steps 3-4: y[r][k1 + n1 k2] = sum_i2 F2[k2][i2] cs[r][i2][k1]
    auto store = [&](const float (&a)[4], int k2, int r, int k1) {
      if (r >= nrows) return;
      float v[4] = {a[0], a[2], a[1], a[3]};  // (re, im) of bins k and k + 1
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] *= scale;
      const int k = k1 + n1 * k2;
      float2* yr = y + (row0 + r) * nout;
      if (nout == n) {
        *reinterpret_cast<float4*>(yr + k) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        if (k < nout) yr[k] = make_float2(v[0], v[1]);
        if (k + 1 < nout) yr[k + 1] = make_float2(v[2], v[3]);
      }
    };
    if (rows * n1 % 64 == 0)
      contract<8>(fa2, n2, cs, n1, sc, rows, store);
    else
      contract<4>(fa2, n2, cs, n1, sc, rows, store);
  }
}

bool tc_shape(int n1, int n2) {
  return n2 > 1 && n1 % 8 == 0 && n2 % 8 == 0 && n1 <= 64 && n2 <= 64;
}

int launch_tc(const void* x, void* y, const void* mats, long long batch, int n, int n1, int n2,
              int inverse, int real_input, int nout, cudaStream_t stream) {
  const size_t tables = ((size_t)n1 * n1 + (size_t)n2 * n2) * sizeof(float4);
  const size_t row_bytes = ((size_t)n1 * (n2 + kPad) + (size_t)n2 * (n1 + kPad)) * sizeof(float2);
  long long rows = kTcSmemTarget > tables ? (long long)((kTcSmemTarget - tables) / row_bytes) : 0;
  if (rows > kTcRowsMax) rows = kTcRowsMax;
  if (rows < 1) rows = 1;
  if (rows > batch) rows = batch;
  const size_t smem = tables + (size_t)rows * row_bytes;
  if (smem > kSmemMax || rows * n >= 65536) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fourstep_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fourstep_tc_kernel, kTcThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (batch + rows - 1) / rows;
  const long long blocks = groups < (long long)sms * per_sm ? groups : (long long)sms * per_sm;
  fourstep_tc_kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float2*>(y), static_cast<const float*>(mats),
      batch, n, n1, n2, (int)rows, inverse, real_input, nout);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch, n) complex64, or float32 when real_input; y: (batch, nout)
// complex64 with nout <= n (the first nout bins).  (n1, n2): the caller's
// split (plan_factors), which picks the design; the general design then
// runs its own (general_split).  mats: the tensor-core design's tables (see
// fourstep_tc_kernel) when tc_shape(n1, n2), else null; a mismatch is
// refused.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue when the arguments are refused or one row does not
// fit in a block's shared memory.
extern "C" int fourstep_dft(const void* x, void* y, long long batch, int n, int n1, int n2,
                            int inverse, int real_input, int nout, const void* mats,
                            void* stream) {
  if (n1 * n2 != n || nout < 1 || nout > n) return (int)cudaErrorInvalidValue;
  if (tc_shape(n1, n2) != (mats != nullptr)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  if (mats != nullptr)
    return launch_tc(x, y, mats, batch, n, n1, n2, inverse, real_input, nout,
                     (cudaStream_t)stream);
  return launch_general(x, y, batch, n, inverse, real_input, nout, (cudaStream_t)stream);
}

// The general design's split of n (general_split), for the tests.
extern "C" void fourstep_general_split(int n, int* n1, int* n2) { general_split(n, n1, n2); }
