// K2: one periodized wavelet analysis level, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wpd/kernel.py::wpd_level
// (_wpd_level_kernel). For rows x (R, N):
//     a[r, m] = sum_k h[k] * x[r, (2m + k) mod N]
//     d[r, m] = sum_k g[k] * x[r, (2m + k) mod N]     (m < N/2)
// It serves every analysis level of the port: the WPD features (R = B*D*60*3
// rows, N = 2048 -> 256 over 4 levels) and MSPCA's DWT (R = B*D*P rows,
// N = 2048 -> 64 over 5 levels).
//
// Bound on this card: memory. Each input float is read once and each output
// float written once (2 * taps flops per output pair for 12 bytes moved), so
// the level runs at HBM rate: 2 x 47 MB at B=8, D=4 on WPD level 1.
//
// Design: a block stages whole rows in shared memory with coalesced loads
// (one 2048-sample row is 8 KB; shorter rows are packed several to a block so
// every block moves about 16 KB), then each thread computes (a[m], d[m]) pairs
// from TAPS circular taps out of shared memory, so the stride-2 window reads
// never touch device memory. Writes are coalesced. Taps accumulate in
// ascending k with fmaf.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 4096;  // rows packed per block up to this many samples
constexpr int kMaxTaps = 16;
constexpr int kMaxRowFloats = 12288;  // 48 KB: one row must fit the default smem

struct Filters {
  float h[kMaxTaps];
  float g[kMaxTaps];
};

template <int TAPS>
__global__ void __launch_bounds__(kThreads)
wpd_level_kernel(const float* __restrict__ x, float* __restrict__ a,
                 float* __restrict__ d, int rows, int n, int rows_per_block,
                 Filters f) {
  extern __shared__ float tile[];
  const int half = n / 2;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int nrows = min(rows_per_block, static_cast<int>(rows - row0));
  const int count = nrows * n;
  const float* src = x + row0 * n;
  for (int i = threadIdx.x; i < count; i += kThreads) tile[i] = src[i];
  __syncthreads();

  float* a_dst = a + row0 * half;
  float* d_dst = d + row0 * half;
  const int outs = nrows * half;
  for (int i = threadIdx.x; i < outs; i += kThreads) {
    const int r = i / half;
    const int m = i - r * half;
    const float* row = tile + r * n;
    float acc_a = 0.f;
    float acc_d = 0.f;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      int idx = 2 * m + k;
      while (idx >= n) idx -= n;
      const float v = row[idx];
      acc_a = fmaf(f.h[k], v, acc_a);
      acc_d = fmaf(f.g[k], v, acc_d);
    }
    a_dst[i] = acc_a;
    d_dst[i] = acc_d;
  }
}

template <int TAPS>
cudaError_t launch(const float* x, float* a, float* d, int rows, int n,
                   const Filters& f, cudaStream_t stream) {
  const int rows_per_block = n >= kTileFloats ? 1 : kTileFloats / n;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(rows_per_block) * n * sizeof(float);
  wpd_level_kernel<TAPS><<<blocks, kThreads, smem, stream>>>(
      x, a, d, rows, n, rows_per_block, f);
  return cudaGetLastError();
}

}  // namespace

// x (rows, n) contiguous float32 -> a, d (rows, n/2) contiguous float32.
// h, g are HOST arrays of `taps` floats. Returns a cudaError_t.
extern "C" int repro_wpd_level(const float* x, float* a, float* d, int rows,
                               int n, const float* h, const float* g, int taps,
                               int device, void* stream) {
  if (rows <= 0 || n <= 0 || n % 2 != 0 || n > kMaxRowFloats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Filters f = {};
  for (int k = 0; k < taps && k < kMaxTaps; ++k) {
    f.h[k] = h[k];
    f.g[k] = g[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (taps) {
    case 2: return static_cast<int>(launch<2>(x, a, d, rows, n, f, s));
    case 4: return static_cast<int>(launch<4>(x, a, d, rows, n, f, s));
    case 6: return static_cast<int>(launch<6>(x, a, d, rows, n, f, s));
    case 8: return static_cast<int>(launch<8>(x, a, d, rows, n, f, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
