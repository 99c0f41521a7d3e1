// K3: batched Gram matrix G[b] = X[b]^T X[b] in float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram/kernel.py::gram
// (_gram_kernel). In the port it is the covariance of core/pca.py::fit_T:
// MSPCA fits one PCA per wavelet scale over P = 180 (+3 per halo window)
// variables and n = 1024 ... 64 coefficients, batched over the B*D chunks
// of an engine step. X[b] is read through arbitrary element strides
// (sb, sn, sp), so fit_T's variable-major (P, n) block goes in as a
// transposed view without a copy.
//
// Bound on this card: operations. G is symmetric, so the function needs
// P (P + 1) / 2 sums of n products: n * P * (P + 1) flops per matrix against
// 4 * n * P bytes read, about 45 flops per byte at P = 180, far above the
// float32 CUDA-core ridge, so it is bound by the 67 TFLOP/s float32 rate
// (true float32: TF32 would perturb the eigenvectors that follow). The
// kernel computes both triangles (all tiles), twice the needed work.
//
// Design: one block per 64 x 64 output tile per batch entry. The reduction
// axis is walked in slabs of 16 samples staged in shared memory (padded by
// one column against bank conflicts, with the staging order chosen so
// neighbouring threads read neighbouring addresses for either layout), and
// each of the 256 threads keeps a 4 x 4 register tile of sums, accumulated
// in ascending sample order with fmaf. No wgmma/TMA yet: simple first.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kSlab = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int p,
            long long sb, long long sn, long long sp) {
  __shared__ float xi_s[kSlab][kTile + 1];
  __shared__ float xj_s[kSlab][kTile + 1];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const float* xb = x + b * sb;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool sample_fast = (sn == 1);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kSlab) {
    for (int e = threadIdx.x; e < kSlab * kTile; e += kThreads) {
      int kk, vv;
      if (sample_fast) {
        kk = e % kSlab;
        vv = e / kSlab;
      } else {
        vv = e % kTile;
        kk = e / kTile;
      }
      const int k = k0 + kk;
      const int vi = i0 + vv;
      const int vj = j0 + vv;
      const bool k_ok = k < n;
      xi_s[kk][vv] = (k_ok && vi < p) ? xb[k * sn + vi * sp] : 0.f;
      xj_s[kk][vv] = (k_ok && vj < p) ? xb[k * sn + vj * sp] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      float a[4];
      float c4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = xi_s[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) c4[c] = xj_s[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], c4[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* ob = out + static_cast<long long>(b) * p * p;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= p) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < p) ob[static_cast<long long>(i) * p + j] = acc[r][c];
    }
  }
}

}  // namespace

// x: batch x (n, p) float32 at element strides (sb, sn, sp); out: contiguous
// (batch, p, p) float32. Returns a cudaError_t.
extern "C" int repro_gram(const float* x, float* out, int batch, int n, int p,
                          long long sb, long long sn, long long sp, int device,
                          void* stream) {
  if (batch <= 0 || n <= 0 || p <= 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, batch);
  gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, p, sb, sn, sp);
  return static_cast<int>(cudaGetLastError());
}
