// K3: batched Gram matrix G[b] = X[b]^T X[b] in float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram/kernel.py::gram
// (_gram_kernel). In the port it is the covariance of core/pca.py::fit_T:
// MSPCA fits one PCA per wavelet scale over P = 180 (+3 per halo window)
// variables and n = 1024 ... 64 coefficients, batched over the B*D chunks
// of an engine step (32 at the scoring path's full batch) and one chunk at a
// time in a fit. X[b] is read through arbitrary element strides (sb, sn,
// sp), so fit_T's variable-major (P, n) block goes in as a transposed view
// without a copy.
//
// Bound on this card: operations. G is symmetric, so the function needs
// P (P + 1) / 2 sums of n products: n * P * (P + 1) flops per matrix against
// 4 * n * P bytes read, about 45 flops per byte at P = 180, far above the
// float32 CUDA-core ridge, so it is bound by the 67 TFLOP/s float32 rate
// (true float32 FMAs: TF32, even split into 3xTF32, would perturb the
// eigenvectors that eigh computes next). At the fit's batch of one it is
// bound by latency: 0.5 us of arithmetic on six 64 x 64 tiles.
//
// Design:
//   - Upper triangle only: one block per 64 x 64 tile (ti <= tj) of G; the
//     block writes its tile and its mirror (the diagonal tiles compute both
//     halves and write no mirror). P = 180 needs 6 tiles, not 9.
//   - Split over samples: when batch x tiles would leave SMs idle or
//     unevenly loaded, the sample axis is cut into n_split ranges of whole
//     32-sample slabs (the wrapper's split_plan), each block writes its
//     partial tile to scratch, and a second small pass sums the partials of
//     each element in split order. No float atomics: G is the same bit for
//     bit from run to run.
//   - Each of the 128 threads keeps an 8 x 4 register tile; its operands are
//     16-byte shared-memory loads (4 samples of one variable, or 4
//     variables of one sample), 128 FMAs per 12 such loads. (An 8 x 8 tile
//     on 64 threads measured slower on the card at every shape of the path:
//     fewer warps hide less latency.)
//   - The next 32-sample slab is staged by cp.async (double-buffered) while
//     this one is multiplied, in 16-byte copies along whichever axis is
//     contiguous: samples (sn = 1, the main path: smem [variable][sample])
//     or variables (sp = 1: smem [sample][variable]); other strides take
//     4-byte copies into the first layout. Rows past P and samples past the
//     block's range are zero-filled by the copy's source size.
//   - Each thread sums its products in ascending sample order with fmaf.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kSlab = 32;
constexpr int kThreads = 128;          // 8 (ty) x 16 (tx), 8 x 4 sums each
constexpr int kLdVK = kSlab + 4;       // [variable][sample] rows, padded a 16-byte word
constexpr int kStage = kTile * kLdVK;  // floats per operand and stage (>= kSlab * kTile)
constexpr int kReduceThreads = 256;

enum Mode { kSampleFast = 0, kVarFast = 1, kScalar = 2 };

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage samples [k0, k0 + kSlab) of variables [v0, v0 + 64) into dst; zeros
// past p and past k_stop.
template <int MODE>
__device__ __forceinline__ void load_slab(float* dst, const float* xb, int v0, int k0,
                                          int k_stop, int p, long long sn, long long sp) {
  if constexpr (MODE == kSampleFast) {
    // 8 chunks of 4 samples per variable: neighbouring threads, neighbouring chunks.
    for (int e = threadIdx.x; e < kTile * (kSlab / 4); e += kThreads) {
      const int v = e / (kSlab / 4);
      const int k = k0 + 4 * (e % (kSlab / 4));
      const int bytes = v0 + v < p ? min(max(4 * (k_stop - k), 0), 16) : 0;
      const float* src = bytes ? xb + k + (v0 + v) * sp : xb;
      cp_async16(dst + v * kLdVK + (k - k0), src, bytes);
    }
  } else if constexpr (MODE == kVarFast) {
    // 16 chunks of 4 variables per sample.
    for (int e = threadIdx.x; e < kSlab * (kTile / 4); e += kThreads) {
      const int kk = e / (kTile / 4);
      const int v = 4 * (e % (kTile / 4));
      const int bytes = k0 + kk < k_stop ? min(max(4 * (p - v0 - v), 0), 16) : 0;
      const float* src = bytes ? xb + (k0 + kk) * sn + v0 + v : xb;
      cp_async16(dst + kk * kTile + v, src, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kSlab; e += kThreads) {
      const int v = e / kSlab;
      const int kk = e % kSlab;
      const bool ok = v0 + v < p && k0 + kk < k_stop;
      cp_async4(dst + v * kLdVK + kk, ok ? xb + (k0 + kk) * sn + (v0 + v) * sp : xb, ok ? 4 : 0);
    }
  }
}

// Row and column (within the tile) of sum acc[r][c] of thread (ty, tx):
// strided by the thread count in [variable][sample] smem (neighbouring
// threads read neighbouring rows), in runs of 4 in [sample][variable] smem
// (one 16-byte load each).
template <int MODE>
__device__ __forceinline__ int tile_row(int ty, int r) {
  return MODE == kVarFast ? 4 * ty + (r & 3) + 32 * (r >> 2) : ty + 8 * r;
}

template <int MODE>
__device__ __forceinline__ int tile_col(int tx, int c) {
  return MODE == kVarFast ? 4 * tx + c : tx + 16 * c;
}

// grid (upper tiles, n_split, batch). With n_split == 1 the block writes G
// (its tile and the mirror); otherwise its partial tile, (64, 64) at
// partial[b][split][tile].
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gram_tile_kernel(const float* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ partial, int n, int p, long long sb, long long sn,
                 long long sp, int tiles, int chunk) {
  __shared__ __align__(16) float xs[2][2][kStage];  // [stage][rows i, rows j]
  int ti = 0;
  int t = blockIdx.x;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const bool diag = ti == tj;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int k_begin = split * chunk;
  const int k_stop = min(n, k_begin + chunk);
  const float* xb = x + b * sb;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  auto stage_in = [&](int st, int k0) {
    load_slab<MODE>(xs[st][0], xb, i0, k0, k_stop, p, sn, sp);
    if (!diag) load_slab<MODE>(xs[st][1], xb, j0, k0, k_stop, p, sn, sp);
    cp_async_commit();
  };

  stage_in(0, k_begin);
  int st = 0;
  for (int k0 = k_begin; k0 < k_stop; k0 += kSlab, st ^= 1) {
    if (k0 + kSlab < k_stop) {
      stage_in(st ^ 1, k0 + kSlab);
    } else {
      cp_async_commit();  // an empty group keeps "all but the newest" exact
    }
    cp_async_wait_prev();
    __syncthreads();
    const float* xi = xs[st][0];
    const float* xj = diag ? xs[st][0] : xs[st][1];
    if constexpr (MODE == kVarFast) {
#pragma unroll 4
      for (int kk = 0; kk < kSlab; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(xi + kk * kTile + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(xi + kk * kTile + 32 + 4 * ty);
        const float4 b4 = *reinterpret_cast<const float4*>(xj + kk * kTile + 4 * tx);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
      }
    } else {
#pragma unroll 2
      for (int kq = 0; kq < kSlab; kq += 4) {
        float4 a[8];
        float4 bv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          a[r] = *reinterpret_cast<const float4*>(xi + (ty + 8 * r) * kLdVK + kq);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          bv[c] = *reinterpret_cast<const float4*>(xj + (tx + 16 * c) * kLdVK + kq);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(a[r].x, bv[c].x, acc[r][c]);
            acc[r][c] = fmaf(a[r].y, bv[c].y, acc[r][c]);
            acc[r][c] = fmaf(a[r].z, bv[c].z, acc[r][c]);
            acc[r][c] = fmaf(a[r].w, bv[c].w, acc[r][c]);
          }
      }
    }
    __syncthreads();  // this stage is refilled two slabs on
  }

  if (gridDim.y == 1) {
    float* ob = out + static_cast<long long>(b) * p * p;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + tile_row<MODE>(ty, r);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tile_col<MODE>(tx, c);
        if (i < p && j < p) {
          ob[static_cast<long long>(i) * p + j] = acc[r][c];
          if (!diag) ob[static_cast<long long>(j) * p + i] = acc[r][c];
        }
      }
    }
  } else {
    float* pt = partial +
                ((static_cast<long long>(b) * gridDim.y + split) * gridDim.x + blockIdx.x) *
                    (kTile * kTile);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pt[tile_row<MODE>(ty, r) * kTile + tile_col<MODE>(tx, c)] = acc[r][c];
      }
  }
}

// grid (upper tiles, 64 * 64 / kReduceThreads, batch): each thread sums one
// element's partials in split order and writes it and its mirror.
__global__ void __launch_bounds__(kReduceThreads)
gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int p,
                   int tiles, int n_split) {
  int ti = 0;
  int t = blockIdx.x;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int b = blockIdx.z;
  const int e = blockIdx.y * kReduceThreads + threadIdx.x;
  const int i = ti * kTile + e / kTile;
  const int j = tj * kTile + e % kTile;
  const long long stride = static_cast<long long>(gridDim.x) * kTile * kTile;
  const float* src =
      partial + static_cast<long long>(b) * n_split * stride +
      static_cast<long long>(blockIdx.x) * kTile * kTile + e;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += src[s * stride];
  if (i < p && j < p) {
    float* ob = out + static_cast<long long>(b) * p * p;
    ob[static_cast<long long>(i) * p + j] = sum;
    if (ti != tj) ob[static_cast<long long>(j) * p + i] = sum;
  }
}

template <int MODE>
int launch(const float* x, float* out, float* partial, int batch, int n, int p, long long sb,
           long long sn, long long sp, int n_split, int chunk, cudaStream_t stream) {
  const int tiles = (p + kTile - 1) / kTile;
  const int upper = tiles * (tiles + 1) / 2;
  gram_tile_kernel<MODE><<<dim3(upper, n_split, batch), kThreads, 0, stream>>>(
      x, out, partial, n, p, sb, sn, sp, tiles, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  gram_reduce_kernel<<<dim3(upper, kTile * kTile / kReduceThreads, batch), kReduceThreads, 0,
                       stream>>>(partial, out, p, tiles, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: batch x (n, p) float32 at element strides (sb, sn, sp); out: contiguous
// (batch, p, p) float32. The sample axis is cut into n_split ranges of chunk
// samples (a multiple of 32, n_split * chunk >= n); with n_split > 1, partial
// is scratch of batch * n_split * upper-tiles * 64 * 64 floats. mode: 0 when
// sn = 1 and the rows of every variable start on 16 bytes, 1 when sp = 1 and
// every sample's row does, else 2 (kernels/gram/kernel.py::load_mode).
// Returns a cudaError_t.
extern "C" int repro_gram(const float* x, float* out, float* partial, int batch, int n, int p,
                          long long sb, long long sn, long long sp, int n_split, int chunk,
                          int mode, int device, void* stream) {
  if (batch <= 0 || n <= 0 || p <= 0 || batch > 65535 || n_split <= 0 || n_split > 65535 ||
      chunk <= 0 || chunk % kSlab != 0 || static_cast<long long>(n_split) * chunk < n ||
      (n_split > 1 && partial == nullptr) || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSampleFast:
      return launch<kSampleFast>(x, out, partial, batch, n, p, sb, sn, sp, n_split, chunk, st);
    case kVarFast:
      return launch<kVarFast>(x, out, partial, batch, n, p, sb, sn, sp, n_split, chunk, st);
    default:
      return launch<kScalar>(x, out, partial, batch, n, p, sb, sn, sp, n_split, chunk, st);
  }
}
