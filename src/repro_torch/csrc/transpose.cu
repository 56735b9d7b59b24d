// Tiled local transpose (A, B, C) -> (B, A, C) of 4-byte (float32) or 8-byte
// (complex64 as one interleaved re/im pair) elements.
//
// Replaces: the Pallas TPU kernel of transpose01_pallas_call
// (src/repro/kernels/transpose/kernel.py, _transpose_kernel), the
// traditional redistribution's pack/unpack hot-spot (paper Eq. 16).  The
// reference splits complex input into re/im planes and transposes each; here
// a complex64 element is moved whole, as 8 bytes, with no plane split.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once (2 * A * B * C * size bytes); there is no arithmetic.
//
// Design: a block moves one (TA, TB, TC) tile through shared memory.  It
// reads rows (a, b0 .. b0+TB, c0 .. c0+TC) of the input, whose TB * TC
// elements are contiguous when TC == C, and writes rows (b, a0 .. a0+TA,
// c0 .. c0+TC) of the output, likewise contiguous, so neighbouring threads
// touch neighbouring addresses on both sides whatever C is.  The tile is
// staged as smem[ta][tb * TC + c] with a row stride S = TB * TC + pad, the
// pad chosen so that S = TC (mod 32): the write side then reads
// smem[ta * S + tb * TC + c], which for consecutive (ta, c) in a warp falls
// on consecutive banks.  The wrapper picks TC = min(C, 1024) and the largest
// TA = TB (a power of two, at most 32) whose tile fits in 32 KB.  Ragged
// edges are masked.  The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSmemBytes = 32 * 1024;
constexpr int kMaxTile = 32;
constexpr int kMaxTC = 1024;

struct Tiling {
  long long A, B, C;
  int ta, tb, tc, stride;  // tile extents and the padded shared-memory row
  long long na, nb, nc;    // tiles along each axis
};

template <typename T>
__global__ void transpose_kernel(const T* __restrict__ x, T* __restrict__ y, Tiling t) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  long long blk = blockIdx.x;
  const long long kc = blk % t.nc;
  blk /= t.nc;
  const long long kb = blk % t.nb;
  const long long ka = blk / t.nb;
  const long long a0 = ka * t.ta, b0 = kb * t.tb, c0 = kc * t.tc;
  const int ta = (int)min((long long)t.ta, t.A - a0);
  const int tb = (int)min((long long)t.tb, t.B - b0);
  const int tc = (int)min((long long)t.tc, t.C - c0);

  // read: i -> (ia, r = ib * tc + c), row ia of the tile is contiguous in x
  const int row_in = tb * tc;
  for (int i = threadIdx.x; i < ta * row_in; i += blockDim.x) {
    const int ia = i / row_in;
    const int r = i - ia * row_in;
    const int ib = r / tc;
    const int c = r - ib * tc;
    smem[ia * t.stride + ib * t.tc + c] = x[((a0 + ia) * t.B + b0 + ib) * t.C + c0 + c];
  }
  __syncthreads();
  // write: i -> (ib, r = ia * tc + c), row ib of the tile is contiguous in y
  const int row_out = ta * tc;
  for (int i = threadIdx.x; i < tb * row_out; i += blockDim.x) {
    const int ib = i / row_out;
    const int r = i - ib * row_out;
    const int ia = r / tc;
    const int c = r - ia * tc;
    y[((b0 + ib) * t.A + a0 + ia) * t.C + c0 + c] = smem[ia * t.stride + ib * t.tc + c];
  }
}

}  // namespace

// x: (A, B, C) contiguous elements of `elem_bytes` (4 or 8); y: (B, A, C).
// Returns cudaGetLastError().
extern "C" int transpose01(const void* x, void* y, long long A, long long B, long long C,
                           int elem_bytes, void* stream) {
  if (A < 0 || B < 0 || C < 0 || (elem_bytes != 4 && elem_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (A == 0 || B == 0 || C == 0) return (int)cudaSuccess;
  Tiling t;
  t.A = A;
  t.B = B;
  t.C = C;
  t.tc = (int)min(C, (long long)kMaxTC);
  int tile = kMaxTile;
  while (tile > 1 && (long long)tile * (tile * t.tc + 31) * elem_bytes > kSmemBytes) tile >>= 1;
  t.ta = t.tb = tile;
  t.stride = tile * t.tc + (((t.tc - tile * t.tc) % 32) + 32) % 32;
  t.na = (A + t.ta - 1) / t.ta;
  t.nb = (B + t.tb - 1) / t.tb;
  t.nc = (C + t.tc - 1) / t.tc;
  const long long blocks = t.na * t.nb * t.nc;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)t.ta * t.stride * elem_bytes;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    transpose_kernel<unsigned int><<<(unsigned)blocks, kThreads, smem, st>>>(
        static_cast<const unsigned int*>(x), static_cast<unsigned int*>(y), t);
  } else {
    transpose_kernel<unsigned long long><<<(unsigned)blocks, kThreads, smem, st>>>(
        static_cast<const unsigned long long*>(x), static_cast<unsigned long long*>(y), t);
  }
  return (int)cudaGetLastError();
}
