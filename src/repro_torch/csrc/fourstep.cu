// Batched four-step DFT along the last axis of a contiguous complex64 (or
// float32, rfft) tensor: y[b, k] = sum_j x[b, j] exp(-+2 pi i j k / n).
//
// Replaces: the Pallas TPU kernel of fourstep_pallas_call (with
// fourstep_kernel, _cmatmul and _cmatmul2) in src/repro/kernels/fft/kernel.py.
//
// Algorithm: n = n1 * n2 (plan_factors; n <= 256 gives (n, 1), one direct
// DFT).  Step 1 contracts n1 with the DFT-n1 matrix, step 2 multiplies by
// the twiddles, step 3 contracts n2 with the DFT-n2 matrix, and step 4 is
// the output index k = k1 + n1 * k2, so the result lands in natural order.
// The inverse uses the conjugate roots and divides by n at the end, which
// is the reference's conj(fft(conj(x))) / n.
//
// What bounds it on the H100: fp32 FMA (no tensor cores, no TF32), about
// 8 n (n1 + n2) flops per row against 16 n bytes moved: for n = 512 that is
// ~24 flops per byte, above the card's fp32 ridge (~20), so the kernel is
// bound by operations, and at n <= 256 (a direct DFT) much more so.  This
// first version reaches ~5 % of that bound: each complex FMA reads two
// float2 values from shared memory, so shared-memory loads limit it.
//
// Design: the Pallas kernel holds F1, F2 and the twiddles whole in VMEM; at
// n = 256 F1 alone would be 512 KB, more than a block's shared memory.  Here
// every entry of F1, F2 and the twiddle matrix is a power of one root of
// unity, so a block keeps only the table w[t] = exp(-2 pi i t / n) of n
// complex values (computed in double, rounded to float) and indexes it with
// (k1 * i1 mod n1) * n2, (i2 * k2 mod n2) * n1 and k1 * i2.  A block
// transforms `rows` whole rows held in shared memory (input tile, step-1
// tile, table); odd and prime lengths need no padding because each thread
// loops over exact extents.  Input and output are interleaved re/im
// (complex64 as float2), so no plane split or merge pass is needed.
// Karatsuba is not used: fp32 FMA has no reason to trade a multiply for
// two adds.  The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

namespace {

__global__ void fourstep_kernel(const float* __restrict__ x, float2* __restrict__ y,
                                long long batch, int n, int n1, int n2, int rows,
                                int inverse, int real_input, int nout) {
  extern __shared__ float2 smem[];
  float2* w = smem;             // n roots
  float2* xs = w + n;           // rows x n input
  float2* cs = xs + rows * n;   // rows x (n2, n1) after steps 1-2
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, batch - row0);

  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    double s, c;
    sincospi(2.0 * (double)t / (double)n, &s, &c);
    w[t] = make_float2((float)c, inverse ? (float)s : (float)-s);
  }
  const int total = nrows * n;
  if (real_input) {
    const float* xr = x + row0 * n;
    for (int i = threadIdx.x; i < total; i += blockDim.x) xs[i] = make_float2(xr[i], 0.0f);
  } else {
    const float2* xc = reinterpret_cast<const float2*>(x) + row0 * n;
    for (int i = threadIdx.x; i < total; i += blockDim.x) xs[i] = xc[i];
  }
  __syncthreads();

  // steps 1-2: cs[r][i2 * n1 + k1] = T[k1, i2] * sum_i1 F1[k1, i1] x[r][i1 * n2 + i2]
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / n;
    const int rem = idx - r * n;
    const int i2 = rem / n1;
    const int k1 = rem - i2 * n1;
    const float2* xr = xs + r * n + i2;
    float ar = 0.0f, ai = 0.0f;
    int e = 0;  // k1 * i1 mod n1
    for (int i1 = 0; i1 < n1; ++i1) {
      const float2 a = xr[i1 * n2];
      const float2 f = w[e * n2];
      ar = fmaf(a.x, f.x, ar);
      ar = fmaf(-a.y, f.y, ar);
      ai = fmaf(a.x, f.y, ai);
      ai = fmaf(a.y, f.x, ai);
      e += k1;
      if (e >= n1) e -= n1;
    }
    const float2 t = w[k1 * i2];
    cs[r * n + i2 * n1 + k1] = make_float2(ar * t.x - ai * t.y, ar * t.y + ai * t.x);
  }
  __syncthreads();

  // steps 3-4: y[r][k1 + n1 * k2] = sum_i2 cs[r][i2 * n1 + k1] F2[i2, k2]
  const int ototal = nrows * nout;
  float2* yr = y + row0 * nout;
  for (int idx = threadIdx.x; idx < ototal; idx += blockDim.x) {
    const int r = idx / nout;
    const int k = idx - r * nout;
    const int k2 = k / n1;
    const int k1 = k - k2 * n1;
    const float2* cr = cs + r * n + k1;
    float br = 0.0f, bi = 0.0f;
    int e = 0;  // i2 * k2 mod n2
    for (int i2 = 0; i2 < n2; ++i2) {
      const float2 c = cr[i2 * n1];
      const float2 f = w[e * n1];
      br = fmaf(c.x, f.x, br);
      br = fmaf(-c.y, f.y, br);
      bi = fmaf(c.x, f.y, bi);
      bi = fmaf(c.y, f.x, bi);
      e += k2;
      if (e >= n2) e -= n2;
    }
    if (inverse) {
      br = br / (float)n;
      bi = bi / (float)n;
    }
    yr[idx] = make_float2(br, bi);
  }
}

constexpr int kThreads = 256;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 232448;  // 227 KB, the most one block may use

}  // namespace

// x: (batch, n) complex64, or float32 when real_input; y: (batch, nout)
// complex64 with nout <= n (the first nout bins).  Returns cudaGetLastError(),
// or cudaErrorInvalidValue when one row of length n does not fit in a block's
// shared memory.
extern "C" int fourstep_dft(const void* x, void* y, long long batch, int n, int n1, int n2,
                            int inverse, int real_input, int nout, void* stream) {
  if (n1 * n2 != n || nout < 1 || nout > n) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const size_t row_bytes = 2 * (size_t)n * sizeof(float2);
  const size_t table = (size_t)n * sizeof(float2);
  long long rows = kSmemDefault > table ? (long long)((kSmemDefault - table) / row_bytes) : 0;
  if (rows > 16) rows = 16;
  if (rows < 1) rows = 1;
  if (rows > batch) rows = batch;
  const size_t smem = table + (size_t)rows * row_bytes;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(fourstep_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (batch + rows - 1) / rows;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  fourstep_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float2*>(y), batch, n, n1, n2, (int)rows,
      inverse, real_input, nout);
  return (int)cudaGetLastError();
}
