// K4: the tree grower's weighted class histogram, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/histogram/kernel.py::
// class_histogram (_hist_kernel). For bucket ids codes (T, N, F) int32 and
// class masses wy (T, N, C) float32:
//     hist[t, f, b, c] = sum_n [codes[t, n, f] == b] * wy[t, n, c]
// with codes outside [0, n_buckets) skipped. The grower
// (core/decision_tree.py::fit_forest_binned) calls it once per level with
// b = node-local * n_bins + bin, so n_buckets grows from n_bins at the root
// to 2^(depth-1) * n_bins (1024 at depth 6, 32 bins).
//
// Bound on this card: bytes. The function reads codes and wy once and writes
// the (T, F, n_buckets, C) output once (17 MB at T = 5, N = 960, F = 288,
// level 5: ~5 us at 3.35 TB/s) and does one add per sample, feature and
// class (2.8 M adds, nothing next to the bytes).
//
// Design: the TPU kernel densified the scatter into a one-hot (block_n,
// n_buckets) matrix contracted on the MXU, and carried the output tile
// across a sequential grid axis over sample slabs. Hopper blocks run in no
// order, so here one block owns one (tree, feature) pair: it zeroes an
// n_buckets x C histogram in shared memory (8 KB at n_buckets = 1024, C = 2),
// its threads stride over the samples and atomicAdd each sample's nonzero
// class masses into it, and it stores the histogram with one coalesced pass.
// Where n_buckets x C floats exceed one block's 227 KB (depth 11 and deeper
// at 32 bins, C = 2), a third grid axis splits the buckets into slices that
// fit, and each slice's block reads all of its (tree, feature)'s samples.
// Skipping zero masses changes no sum (the histogram starts at +0.0) and
// halves the atomics for one-hot masses. In the grower every mass is 0 or 1,
// so every partial sum is an integer below 2^24 and the atomics' order
// cannot change the result; for general weights the order varies from run
// to run.
//
// What holds it back (left for a later PR): codes is (T, N, F) with F
// innermost, so a (t, f) block reads its column at a stride of F * 4 bytes
// (each warp load touches 32 sectors; the 288 blocks of one tree share them
// through L2); and the caller rebuilds the whole (T, N, F) codes tensor at
// every level although only the node-local part changes. A feature-major
// layout, or fusing the code arithmetic into the kernel, removes both.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in limit per block
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ codes, const float* __restrict__ wy,
            float* __restrict__ out, int n, int f_dim, int n_classes,
            int n_buckets, int slice) {
  extern __shared__ float hist[];
  const int f = blockIdx.x;
  const int t = blockIdx.y;
  const int lo = blockIdx.z * slice;
  const int hi = min(lo + slice, n_buckets);
  const int size = (hi - lo) * n_classes;
  for (int i = threadIdx.x; i < size; i += kThreads) hist[i] = 0.f;
  __syncthreads();

  const int* col = codes + static_cast<long long>(t) * n * f_dim + f;
  const float* mass = wy + static_cast<long long>(t) * n * n_classes;
  for (int s = threadIdx.x; s < n; s += kThreads) {
    const int b = col[static_cast<long long>(s) * f_dim];
    if (b < lo || b >= hi) continue;
    const float* m = mass + static_cast<long long>(s) * n_classes;
    for (int c = 0; c < n_classes; ++c) {
      const float v = m[c];
      if (v != 0.f) atomicAdd(&hist[(b - lo) * n_classes + c], v);
    }
  }
  __syncthreads();

  float* o = out + ((static_cast<long long>(t) * f_dim + f) * n_buckets + lo) *
                       n_classes;
  for (int i = threadIdx.x; i < size; i += kThreads) o[i] = hist[i];
}

}  // namespace

// codes: contiguous (T, N, F) int32; wy: contiguous (T, N, C) float32; out:
// contiguous (T, F, n_buckets, C) float32, every entry written. Returns a
// cudaError_t.
extern "C" int repro_class_histogram(const int* codes, const float* wy,
                                     float* out, int n_trees, int n, int f_dim,
                                     int n_classes, int n_buckets, int device,
                                     void* stream) {
  if (n_trees <= 0 || n_trees > 65535 || n <= 0 || f_dim <= 0 ||
      n_classes <= 0 || n_buckets <= 0 ||
      static_cast<size_t>(n_classes) * sizeof(float) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The largest bucket slice whose histogram fits one block's shared memory;
  // one slice (one block per (tree, feature)) whenever the whole fits.
  const int max_slice =
      static_cast<int>(kMaxSmem / (static_cast<size_t>(n_classes) * sizeof(float)));
  const int slice = n_buckets < max_slice ? n_buckets : max_slice;
  const int n_slices = (n_buckets + slice - 1) / slice;
  if (n_slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(slice) * n_classes * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Above 48 KB the opt-in is a property of the kernel on this device: set
  // it once per device and size, not on every launch.
  static size_t smem_set[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (smem > kDefaultSmem && smem_set[device] < smem) {
    err = cudaFuncSetAttribute(hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = smem;
  }
  dim3 grid(f_dim, n_trees, n_slices);
  hist_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      codes, wy, out, n, f_dim, n_classes, n_buckets, slice);
  return static_cast<int>(cudaGetLastError());
}
