// K2: periodized wavelet analysis, for Hopper (sm_90a): one level, a whole
// packet tree, or a whole DWT, in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wpd/kernel.py::wpd_level
// (_wpd_level_kernel). One analysis level of rows x (R, N) is
//     a[r, m] = sum_k h[k] * x[r, (2m + k) mod N]
//     d[r, m] = sum_k g[k] * x[r, (2m + k) mod N]     (m < N/2)
// The port runs it over several levels: the WPD features split every node
// (level 4, (R = B*D*60*3, 2048) -> 16 nodes of 128 a row, Paley order: node
// 2i is the low branch of node i), MSPCA's DWT splits only the approximation
// (level 5: D1 .. D5 and A5). Two modes of one kernel do that:
//   kTree  -- every segment splits; only the last level's nodes are written;
//   kChain -- only the approximation splits; each level's detail is written
//             to its own scale, the last approximation after them.
// The single-level function (kernel.py::wpd_level) is kChain at one level.
//
// Bound on this card: memory. Whatever the levels, the function reads each
// input float once and writes each kept coefficient once (N floats a row
// either way): 2 x 47 MB at R = 5760, N = 2048, 0.0282 ms at 3.35 TB/s; the
// 2 * taps flops per coefficient pair and level are far below it.
//
// Design: a block stages its rows in shared memory with 16-byte loads (one
// 2048-sample row is 8 KB; shorter rows are packed several to a block), runs
// every level between two shared-memory buffers, and writes to device memory
// only what the caller keeps, with coalesced stores. A thread computes two
// neighbouring (a[m], d[m]) pairs from 16-byte reads of their shared 10-tap
// window (conflict-free: neighbouring threads read neighbouring 16 bytes),
// wrapping to the segment's start by a select; segments shorter than the
// filter, or of a length that is not a multiple of 4, take a one-pair path
// that wraps by a modulo. Shared memory, not device memory, bounds the
// levels after the first: each moves a row through it twice. Taps
// accumulate in ascending k with fmaf on every path, so each level's values
// equal the single-level mode's bit for bit and a tree equals the chained
// single-level launches.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;
constexpr int kTileFloats = 2048;  // rows packed per block up to this many samples
constexpr int kMaxTaps = 8;
constexpr int kMaxLevels = 16;
constexpr int kMaxRowFloats = 12288;  // two 48 KB buffers at most
constexpr int kMaxDevices = 64;

enum Mode { kTree = 0, kChain = 1 };

struct Plan {
  float h[kMaxTaps];
  float g[kMaxTaps];
  // kChain: where D_{j+1} starts in out for level j, in floats; off[levels]
  // is where the last approximation starts.
  long long off[kMaxLevels + 1];
};

// One coefficient pair of the segment at seg (length len, even), for the
// segments the two-pair path does not take (shorter than the filter, or of a
// length that is not a multiple of 4): taps come in float2 pairs (len is
// even, so a pair never straddles the wrap), wrapped as often as it takes.
template <int TAPS>
__device__ __forceinline__ void analysis_pair(const float* seg, int len, int m,
                                              const Plan& p, float& a, float& d) {
  float acc_a = 0.f;
  float acc_d = 0.f;
#pragma unroll
  for (int k = 0; k < TAPS / 2; ++k) {
    const float2 v = *reinterpret_cast<const float2*>(seg + (2 * m + 2 * k) % len);
    acc_a = fmaf(p.h[2 * k], v.x, acc_a);
    acc_d = fmaf(p.g[2 * k], v.x, acc_d);
    acc_a = fmaf(p.h[2 * k + 1], v.y, acc_a);
    acc_d = fmaf(p.g[2 * k + 1], v.y, acc_d);
  }
  a = acc_a;
  d = acc_d;
}

// Two neighbouring pairs m = 2q, 2q + 1 of the segment at seg (length len, a
// multiple of 4 and at least TAPS): their windows x[4q .. 4q + TAPS + 1]
// come as 16-byte reads (neighbouring threads on neighbouring 16 bytes) and
// one trailing 8-byte read, each wrapped once. Each pair sums its taps in
// the order analysis_pair does.
template <int TAPS>
__device__ __forceinline__ void analysis_two_pairs(const float* seg, int len, int q,
                                                   const Plan& p, float2& a, float2& d) {
  constexpr int kPieces = TAPS / 2 + 1;  // float2 pieces of the two windows
  float2 v[kPieces];
#pragma unroll
  for (int k = 0; k < kPieces; k += 2) {
    int idx = 4 * q + 2 * k;
    idx = idx >= len ? idx - len : idx;
    if (k + 1 < kPieces) {
      const float4 w = *reinterpret_cast<const float4*>(seg + idx);
      v[k] = make_float2(w.x, w.y);
      v[k + 1] = make_float2(w.z, w.w);
    } else {
      v[k] = *reinterpret_cast<const float2*>(seg + idx);
    }
  }
  float a0 = 0.f, d0 = 0.f, a1 = 0.f, d1 = 0.f;
#pragma unroll
  for (int k = 0; k < TAPS / 2; ++k) {
    a0 = fmaf(p.h[2 * k], v[k].x, a0);
    d0 = fmaf(p.g[2 * k], v[k].x, d0);
    a0 = fmaf(p.h[2 * k + 1], v[k].y, a0);
    d0 = fmaf(p.g[2 * k + 1], v[k].y, d0);
    a1 = fmaf(p.h[2 * k], v[k + 1].x, a1);
    d1 = fmaf(p.g[2 * k], v[k + 1].x, d1);
    a1 = fmaf(p.h[2 * k + 1], v[k + 1].y, a1);
    d1 = fmaf(p.g[2 * k + 1], v[k + 1].y, d1);
  }
  a = make_float2(a0, a1);
  d = make_float2(d0, d1);
}

// One level over the block's segments, two pairs a thread: (a, d) of pairs
// i, i + 1 go to a_at(i) and d_at(i) as 8-byte stores.
template <int TAPS, typename A, typename D>
__device__ __forceinline__ void level_two_pairs(const float* src, int len, int segs,
                                                const Plan& p, A a_at, D d_at) {
  const int quads = len / 4;  // pair couples a segment
  const int shift = (quads & (quads - 1)) == 0 ? __ffs(quads) - 1 : -1;
  const int units = segs * quads;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int s = shift >= 0 ? u >> shift : u / quads;
    const int q = u - s * quads;
    float2 a, d;
    analysis_two_pairs<TAPS>(src + s * len, len, q, p, a, d);
    const int i = 2 * u;  // the first pair's index in the level: s * half + 2q
    *reinterpret_cast<float2*>(a_at(i, s, 2 * q)) = a;
    *reinterpret_cast<float2*>(d_at(i, s, 2 * q)) = d;
  }
}

// One level over the block's segments, one pair a thread: (a, d) of pair i
// go to a_at(i) and d_at(i).
template <int TAPS, typename A, typename D>
__device__ __forceinline__ void level_pairs(const float* src, int len, int segs,
                                            const Plan& p, A a_at, D d_at) {
  const int half = len / 2;
  const int pairs = segs * half;
  for (int i = threadIdx.x; i < pairs; i += kThreads) {
    const int s = i / half;
    const int m = i - s * half;
    float a, d;
    analysis_pair<TAPS>(src + s * len, len, m, p, a, d);
    *a_at(i, s, m) = a;
    *d_at(i, s, m) = d;
  }
}

template <int TAPS, int MODE>
__global__ void __launch_bounds__(kThreads)
wpd_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int n,
           int levels, int rows_per_block, int buf_floats,
           const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) float smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int nrows = min(rows_per_block, static_cast<int>(rows - row0));

  // The block's rows, read from device memory once.
  const int count = nrows * n;
  const float* xs = x + row0 * n;
  if ((reinterpret_cast<uintptr_t>(xs) & 15) == 0 && (count & 3) == 0) {
    const float4* xs4 = reinterpret_cast<const float4*>(xs);
    for (int i = threadIdx.x; i < count / 4; i += kThreads) {
      reinterpret_cast<float4*>(smem)[i] = __ldg(xs4 + i);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads) smem[i] = __ldg(xs + i);
  }
  __syncthreads();

  int src = 0;                   // this level's input in smem, in floats
  int dst = buf_floats;  // its output, unless it is the last level
  int len = n;       // segment length at this level's input
  int segs = nrows;  // segments in the block
  for (int lev = 0; lev < levels; ++lev) {
    const int half = len / 2;
    float* d_scale = out + p.off[lev] + row0 * half;  // kChain: D_{lev+1}
    // The level into o: shared memory, or device memory at the last level
    // (two inlined calls, so each store knows its memory).
    auto run = [&](float* o) {
      // kTree: a segment's two children take its place, so the tree stays
      // in Paley order and the last level's layout is the output row's.
      auto tree_a = [=](int, int s, int m) { return o + s * len + m; };         // node 2i: the low branch
      auto tree_d = [=](int, int s, int m) { return o + s * len + half + m; };  // node 2i + 1: the high branch
      auto chain_a = [=](int i, int, int) { return o + i; };
      auto chain_d = [=](int i, int, int) { return d_scale + i; };
      if (len >= TAPS && len % 4 == 0) {
        if (MODE == kTree) level_two_pairs<TAPS>(smem + src, len, segs, p, tree_a, tree_d);
        else level_two_pairs<TAPS>(smem + src, len, segs, p, chain_a, chain_d);
      } else {
        if (MODE == kTree) level_pairs<TAPS>(smem + src, len, segs, p, tree_a, tree_d);
        else level_pairs<TAPS>(smem + src, len, segs, p, chain_a, chain_d);
      }
    };
    if (lev < levels - 1) {
      run(smem + dst);
    } else {
      run(MODE == kTree ? out + row0 * n : out + p.off[levels] + row0 * half);
    }
    __syncthreads();  // this level's output is the next level's input
    const int t = src; src = dst; dst = t;
    if (MODE == kTree) segs *= 2;
    len = half;
  }
}

template <int TAPS, int MODE>
cudaError_t launch(const float* x, float* out, int rows, int n, int levels,
                   const Plan& p, int device, cudaStream_t stream) {
  const int rows_per_block = n >= kTileFloats ? 1 : kTileFloats / n;
  const int buf_floats = rows_per_block * n;
  // One buffer for a single level (it writes device memory directly), two
  // to run levels between.
  const size_t smem =
      static_cast<size_t>(levels > 1 ? 2 : 1) * buf_floats * sizeof(float);
  // The opt-in above 48 KB is a property of the kernel on this device: set
  // it once per device and size, not on every launch.
  static size_t smem_set[kMaxDevices] = {};
  if (smem > 48 * 1024 && smem_set[device] < smem) {
    cudaError_t err = cudaFuncSetAttribute(wpd_kernel<TAPS, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set[device] = smem;
  }
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  wpd_kernel<TAPS, MODE><<<blocks, kThreads, smem, stream>>>(
      x, out, rows, n, levels, rows_per_block, buf_floats, p);
  return cudaGetLastError();
}

template <int TAPS>
cudaError_t launch_mode(int mode, const float* x, float* out, int rows, int n,
                        int levels, const Plan& p, int device, cudaStream_t s) {
  return mode == kTree ? launch<TAPS, kTree>(x, out, rows, n, levels, p, device, s)
                       : launch<TAPS, kChain>(x, out, rows, n, levels, p, device, s);
}

}  // namespace

// x (rows, n) contiguous float32 -> out, contiguous float32 on the same
// device: kTree (mode 0) (rows, 2^levels, n / 2^levels); kChain (mode 1) the
// detail scales D1 .. D_levels and then A_levels, D_{j+1} at offsets[j] and
// A at offsets[levels] (floats, each scale (rows, n / 2^(j+1))). h, g and
// offsets are HOST arrays (taps floats; levels + 1 int64). n must be a
// multiple of 2^levels. Returns a cudaError_t.
extern "C" int repro_wpd_levels(const float* x, float* out, int rows, int n,
                                int levels, int mode, const float* h, const float* g,
                                int taps, const long long* offsets, int device,
                                void* stream) {
  if (rows <= 0 || n <= 0 || n > kMaxRowFloats || levels < 1 || levels > kMaxLevels ||
      n % (1 << levels) != 0 || (mode != kTree && mode != kChain) ||
      (mode == kChain && offsets == nullptr) || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p = {};
  for (int k = 0; k < taps && k < kMaxTaps; ++k) {
    p.h[k] = h[k];
    p.g[k] = g[k];
  }
  if (mode == kChain) {
    for (int j = 0; j <= levels; ++j) p.off[j] = offsets[j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (taps) {
    case 2: return static_cast<int>(launch_mode<2>(mode, x, out, rows, n, levels, p, device, s));
    case 4: return static_cast<int>(launch_mode<4>(mode, x, out, rows, n, levels, p, device, s));
    case 6: return static_cast<int>(launch_mode<6>(mode, x, out, rows, n, levels, p, device, s));
    case 8: return static_cast<int>(launch_mode<8>(mode, x, out, rows, n, levels, p, device, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
