// K1: packed rotation-forest traversal, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/forest/kernel.py::
// forest_traverse (_forest_kernel). For x (B, F) and a packed forest
// proj (T, F, L), thr (T, L) (+inf = dead node), leaf (T, L, C):
//     per tree t: val = x @ proj[t]; go-right bits = val > thr[t];
//     the bits pick one leaf (heap walk from root 1); out += leaf[t, leaf]
// with trees accumulated in ascending order, so the sums equal the
// reference's sequential one-hot sums bit for bit once the leaves agree.
//
// Bound on this card: the function needs only the depth log2(L) node values
// on each row's path (fewer where a dead node ends it), 2 * B * F * depth * T
// flops (66 MFLOP at B = 1920, F = 288, depth 6, T = 10), against ~3 MB of
// inputs: ~1 us either way, so operations and bytes bound it about equally.
// The kernel computes all L node values per tree (10x the needed flops at
// L = 64) to keep the dot loop dense; computing only the path's columns is
// the next step. True float32 throughout (a TF32 rounding near thr flips a
// route).
//
// Design: the TPU kernel's sequential tree grid axis carried the (rows, C)
// sum between grid steps; Hopper blocks carry nothing between them, so the
// tree loop runs INSIDE one block per 32-row tile and the sum stays in
// registers. Per tree the block stages proj[t] (288 x 64 x 4 = 72 KB, hence
// dynamic shared memory above 48 KB) next to its x tile, computes all L node
// values with 4 rows per thread sharing each proj load, and then one thread
// per row walks its depth log2(L) path: node = 2 * node + (val > thr).
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;
constexpr int kRowsPerThread = 4;
constexpr int kThreads = 256;
constexpr int kMaxClasses = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in limit per block
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
forest_kernel(const float* __restrict__ x, const float* __restrict__ proj,
              const float* __restrict__ thr, const float* __restrict__ leaf,
              float* __restrict__ out, int batch, int f_dim, int n_trees,
              int n_leaves, int n_classes, int depth) {
  extern __shared__ float smem[];
  float* proj_s = smem;                      // (F, L)
  float* x_s = proj_s + f_dim * n_leaves;    // (kRows, F)
  float* val_s = x_s + kRows * f_dim;        // (kRows, L)
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int nrows = min(kRows, static_cast<int>(batch - row0));

  for (int e = tid; e < kRows * f_dim; e += kThreads) {
    const int r = e / f_dim;
    x_s[e] = r < nrows ? x[row0 * f_dim + e] : 0.f;
  }

  float acc[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) acc[c] = 0.f;

  const int groups = kRows / kRowsPerThread;
  const int fl = f_dim * n_leaves;
  for (int t = 0; t < n_trees; ++t) {
    __syncthreads();  // the previous tree is done with proj_s and val_s
    const float* proj_t = proj + static_cast<long long>(t) * fl;
    for (int e = tid; e < fl; e += kThreads) proj_s[e] = proj_t[e];
    __syncthreads();

    for (int q = tid; q < groups * n_leaves; q += kThreads) {
      const int l = q % n_leaves;
      const int g = q / n_leaves;
      const float* xr = x_s + g * kRowsPerThread * f_dim;
      float v[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) v[i] = 0.f;
      for (int f = 0; f < f_dim; ++f) {
        const float w = proj_s[f * n_leaves + l];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          v[i] = fmaf(xr[i * f_dim + f], w, v[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        val_s[(g * kRowsPerThread + i) * n_leaves + l] = v[i];
      }
    }
    __syncthreads();

    if (tid < nrows) {
      const float* thr_t = thr + static_cast<long long>(t) * n_leaves;
      const float* val_r = val_s + tid * n_leaves;
      int node = 1;
      for (int j = 0; j < depth; ++j) {
        node = 2 * node + (val_r[node] > thr_t[node] ? 1 : 0);
      }
      const float* lp =
          leaf + (static_cast<long long>(t) * n_leaves + (node - n_leaves)) *
                     n_classes;
#pragma unroll
      for (int c = 0; c < kMaxClasses; ++c) {
        if (c < n_classes) acc[c] += lp[c];
      }
    }
  }

  if (tid < nrows) {
    float* o = out + (row0 + tid) * n_classes;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < n_classes) o[c] = acc[c];
    }
  }
}

}  // namespace

// All pointers are contiguous float32 device buffers. Returns a cudaError_t.
extern "C" int repro_forest_traverse(const float* x, const float* proj,
                                     const float* thr, const float* leaf,
                                     float* out, int batch, int f_dim,
                                     int n_trees, int n_leaves, int n_classes,
                                     int depth, int device, void* stream) {
  const size_t smem =
      (static_cast<size_t>(f_dim) * n_leaves + static_cast<size_t>(kRows) * f_dim +
       static_cast<size_t>(kRows) * n_leaves) * sizeof(float);
  if (batch <= 0 || f_dim <= 0 || n_trees <= 0 || n_leaves <= 0 ||
      (1 << depth) != n_leaves || n_classes <= 0 || n_classes > kMaxClasses ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The opt-in above 48 KB is a property of the kernel on this device:
  // set it once per device and size, not on every launch.
  static size_t smem_set[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (smem_set[device] < smem) {
    err = cudaFuncSetAttribute(forest_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = smem;
  }
  const int blocks = static_cast<int>((batch + kRows - 1) / kRows);
  forest_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, proj, thr, leaf, out, batch, f_dim, n_trees, n_leaves, n_classes,
      depth);
  return static_cast<int>(cudaGetLastError());
}
