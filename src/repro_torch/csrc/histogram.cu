// K4: the tree grower's weighted class histogram, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/histogram/kernel.py::
// class_histogram (_hist_kernel), which computes, for bucket ids codes
// (T, N, F) and class masses wy (T, N, C),
//     hist[t, f, b, c] = sum_n [codes[t, n, f] == b] * wy[t, n, c]
// with codes outside [0, n_buckets) skipped. The grower
// (core/decision_tree.py::fit_forest_binned) calls it once per level through
// level_histogram, with b = local * n_bins + bin and wy = w * onehot(y), so
// n_buckets grows from n_bins at the root to 2^(depth-1) * n_bins (1024 at
// depth 6, 32 bins).
//
// One source, two modes of one kernel:
//   level (repro_level_histogram): the grower's level_histogram itself. It
//     takes the fit's bin codes feature-major, (T, F, N) uint8 (n_bins <=
//     256) or int32, the node-local ids local (T, N), the labels y (N,) and
//     the weights w (T, N), and computes each bucket id in registers; the
//     caller builds no (T, N, F) codes tensor and no class masses.
//   class (repro_class_histogram): the TPU kernel's own contract, codes
//     (T, N, F) int32 with out-of-range ids skipped and general float wy.
//
// Bound on this card: bytes. The level mode reads its codes once (1.38 MB
// at T = 5, N = 960, F = 288 in uint8), local, y and w once (~42 KB) and
// writes the (T, F, n_buckets, C) output once (11.8 MB at level 5 of a
// depth-6 tree: ~0.0039 ms at 3.35 TB/s; 1.75 MB and ~0.0005 ms at level 0);
// it does one add per live (sample, feature).
//
// Design. The TPU kernel densified the scatter into a one-hot matmul on the
// MXU and carried the output tile across a sequential grid axis over sample
// slabs. Here a block owns one tree, a group of features and a slice of the
// buckets (one slice unless n_buckets * C floats exceed shared memory:
// depth >= 12 at 32 bins), and holds their histograms in shared memory. It
// walks the samples in passes of `tile` (1024 in the level mode: one pass at
// a shard's 960). Each pass stages
//   * the pass's live (sample, class) records, read once and coalesced from
//     local, y and w (or wy) and shared by the whole feature group: zero
//     masses (a quarter of the samples under the 0.75 bootstrap) are dropped
//     by a warp ballot, so they cost no atomic and no lane later;
//   * the group's codes of the pass, read along n (neighbouring threads on
//     neighbouring bytes) with 16-byte loads where the rows are aligned;
// with every load of the pass in flight at once (a thread holds its samples'
// local, y and w in registers while its codes arrive). Then every thread
// adds record masses into the histogram with shared-memory atomics, the
// bucket computed in a register. At shallow levels all of a
// feature's samples fall into a few dozen words (32 buckets x 2 classes at
// level 0), and same-address atomics from different warps serialize: where
// n_buckets * C * warps fits kCopyBudget (levels 0-2 at 32 bins), each warp
// adds into its own copy, and the copies are summed in a fixed order at the
// end. The output is written once, zeros included, with 16-byte stores.
// Sums are float32. For the grower's 0/1 masses every partial sum is an
// integer below 2^24, so the result is exact whatever the atomics' order; for
// general weights it agrees with an ordered sum to float32 rounding.
//
// What bounds it now: latency more than bytes. On an H100 SXM (700 W) a
// launch at the fit's shapes takes ~0.009 ms of device time at level 0 and
// ~0.012 ms at level 5 (PERF.md kernel table), of which writing level 5's
// 11.8 MB is ~0.0035: each block's chain of loads, barriers, adds and
// stores sets the rest. Fewer passes (one at a shard's 960 samples), 4
// features a block (2 or 8 were slower) and per-warp copies (warp-aggregated
// atomics were slower at every level) were measured with
// tools/histogram_faults.py. The call through the Python wrapper (~0.016
// ms) exceeds the device time; the grower around it is host-bound.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;       // 227 KB opt-in limit per block
constexpr size_t kCopyBudget = 64 * 1024;  // per-warp copies only below this
constexpr int kTile = 1024;                // samples staged per pass (level mode)
constexpr int kMaxClasses = 256;           // bounds a pass's staged records
constexpr int kMaxDevices = 64;

struct Args {
  const void* codes;   // level: (T, F, N) Code; class: (T, N, F) int32
  const int* local;    // level: (T, N) node-local ids
  const int* y;        // level: (N,) labels
  const float* mass;   // level: w (T, N); class: wy (T, N, C)
  float* out;          // (T, F, n_buckets, C)
  int n, f_dim, n_classes, n_bins, n_buckets;
  int group;           // features per block
  int copies;          // histogram copies per block: 1, or one per warp
  int slice;           // buckets per block
  int tile;            // samples per pass
  int hist_bytes;      // shared-memory bytes before the staged codes
  int code_bytes;      // shared-memory bytes of the staged codes
  int vec_codes;       // level mode: codes rows are 16-byte aligned
  int vec_out;         // output feature rows and slices are 16-byte aligned
};

// Sum the copies of V consecutive histogram floats at `at`, in copy order.
template <int V>
__device__ __forceinline__ void merge_store(const float* hist, int span, int copies, int at,
                                            float* dst) {
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = hist[at + v];
  for (int k = 1; k < copies; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] += hist[k * span + at + v];
  }
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
  } else {
    dst[0] = s[0];
  }
}

template <typename Code, bool kLevel>
__global__ void __launch_bounds__(kThreads) hist_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.y;
  const int f0 = blockIdx.x * a.group;
  const int gn = min(a.group, a.f_dim - f0);  // features of this block
  const int lo = blockIdx.z * a.slice;
  const int hi = min(lo + a.slice, a.n_buckets);
  const int c_dim = a.n_classes;
  const int width = (hi - lo) * c_dim;  // floats of one feature's slice
  const int span = gn * width;          // floats of one copy
  const int per_pass = kLevel ? a.tile : a.tile * c_dim;  // records a pass may stage

  float* hist = reinterpret_cast<float*>(smem);
  Code* codes_s = reinterpret_cast<Code*>(smem + a.hist_bytes);  // [group][tile]
  int* rec_base = reinterpret_cast<int*>(smem + a.hist_bytes + a.code_bytes);
  int* rec_key = rec_base + per_pass;  // sample in the pass | class << 16
  float* rec_w = reinterpret_cast<float*>(rec_key + per_pass);
  int* counter = reinterpret_cast<int*>(rec_w + per_pass);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < a.hist_bytes / 16; i += kThreads) {
    reinterpret_cast<float4*>(hist)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) *counter = 0;
  float* mine = hist + (a.copies > 1 ? warp * span : 0);  // this warp's copy
  int taken = 0;  // records staged by the earlier passes

  // Every lane of a warp calls this once per round: the live records take
  // the next slots, in lane order.
  auto stage = [&](bool keep, int base, int s, int cls, float m) {
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    int at = 0;
    if (lane == 0 && ballot != 0u) at = atomicAdd(counter, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0) - taken + __popc(ballot & ((1u << lane) - 1u));
    if (keep) {
      rec_base[at] = base;
      rec_key[at] = s | (cls << 16);
      rec_w[at] = m;
    }
  };

  for (int n0 = 0; n0 < a.n; n0 += a.tile) {
    const int len = min(a.tile, a.n - n0);
    __syncthreads();  // the zeroing, or the previous pass's reads, are done

    if constexpr (kLevel) {
      // This thread's samples of the pass first, into registers, so that
      // their loads and the codes' below are all in flight together.
      constexpr int kPer = kTile / kThreads;
      int base[kPer], cls[kPer];
      float m[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int p = k * kThreads + tid;
        const long long i = static_cast<long long>(t) * a.n + n0 + p;
        const bool in = p < len;
        cls[k] = in ? a.y[n0 + p] : -1;
        m[k] = in ? a.mass[i] : 0.f;
        base[k] = in ? a.local[i] * a.n_bins : 0;
      }
      // The group's codes of the pass: codes_s[g * tile + s] for sample n0 + s.
      const Code* src = static_cast<const Code*>(a.codes) +
                        (static_cast<long long>(t) * a.f_dim + f0) * a.n + n0;
      auto row = [&](int g) { return src + static_cast<long long>(g) * a.n; };
      int done = 0;
      if (a.vec_codes) {
        constexpr int kV = 16 / sizeof(Code);
        const int vecs = len / kV;
        for (int i = tid; i < gn * vecs; i += kThreads) {
          const int g = i / vecs, j = i - g * vecs;
          reinterpret_cast<uint4*>(codes_s + g * a.tile)[j] =
              reinterpret_cast<const uint4*>(row(g))[j];
        }
        done = vecs * kV;
      }
      const int rest = len - done;
      for (int i = tid; i < gn * rest; i += kThreads) {
        const int g = i / rest, j = done + (i - g * rest);
        codes_s[g * a.tile + j] = row(g)[j];
      }
      // Zero weights (the bootstrap's left-out samples) stage nothing.
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        stage(m[k] != 0.f && cls[k] >= 0 && cls[k] < c_dim, base[k], k * kThreads + tid,
              cls[k], m[k]);
      }
    } else {
      const int* src = static_cast<const int*>(a.codes) +
                       (static_cast<long long>(t) * a.n + n0) * a.f_dim + f0;
      for (int i = tid; i < len * gn; i += kThreads) {
        const int s = i / gn, g = i - s * gn;
        codes_s[g * a.tile + s] = src[static_cast<long long>(s) * a.f_dim + g];
      }
      const int n_pairs = len * c_dim;  // (sample, class) pairs, zero masses staging nothing
      for (int p0 = warp * 32; p0 < n_pairs; p0 += kThreads) {
        const int p = p0 + lane, s = p / c_dim, cls = p - s * c_dim;
        const float m =
            p < n_pairs ? a.mass[(static_cast<long long>(t) * a.n + n0 + s) * c_dim + cls] : 0.f;
        stage(m != 0.f, 0, s, cls, m);
      }
    }
    __syncthreads();  // the records and codes are staged
    const int n_rec = *counter - taken;
    taken += n_rec;

    // Every (feature, record) pair of the pass: one add each.
    const int total = gn * n_rec;
    for (int i = tid; i < total; i += kThreads) {
      const int g = i / n_rec, r = i - g * n_rec;
      const int key = rec_key[r];
      const int b = rec_base[r] + static_cast<int>(codes_s[g * a.tile + (key & 0xffff)]);
      if (b >= lo && b < hi) atomicAdd(&mine[g * width + (b - lo) * c_dim + (key >> 16)], rec_w[r]);
    }
  }
  __syncthreads();  // every copy is complete

  // Sum the copies and write each feature's slice once, zeros included.
  float* o = a.out + ((static_cast<long long>(t) * a.f_dim + f0) * a.n_buckets + lo) * c_dim;
  const long long stride = static_cast<long long>(a.n_buckets) * c_dim;
  if (a.vec_out) {
    const int w4 = width / 4;
    for (int i = tid; i < gn * w4; i += kThreads) {
      const int g = i / w4, j = 4 * (i - g * w4);
      merge_store<4>(hist, span, a.copies, g * width + j, o + g * stride + j);
    }
  } else {
    for (int i = tid; i < span; i += kThreads) {
      const int g = i / width, j = i - g * width;
      merge_store<1>(hist, span, a.copies, i, o + g * stride + j);
    }
  }
}

size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// The launch plan: features per block, copies, bucket slice, pass size and
// shared memory. Returns false if no plan fits one block.
bool plan(Args* a, size_t* smem, int* n_slices, int n_trees, int code_size, bool level,
          int sms) {
  const int c_dim = a->n_classes;
  a->tile = level ? kTile : std::max(32, (kTile / c_dim) / 32 * 32);
  const int per_pass = level ? a->tile : a->tile * c_dim;
  const size_t rec_bytes = static_cast<size_t>(per_pass) * 12 + 16;
  // Features per block: the most that still give two blocks per SM.
  int group = 8;
  while (group > 1 && static_cast<long long>(n_trees) * ((a->f_dim + group - 1) / group) <
                          2LL * sms) {
    group /= 2;
  }
  group = std::min(group, a->f_dim);
  const size_t feature = static_cast<size_t>(a->n_buckets) * c_dim * sizeof(float);
  for (;;) {
    const size_t code_bytes = round16(static_cast<size_t>(group) * a->tile * code_size);
    const size_t staging = code_bytes + rec_bytes;
    a->group = group;
    a->code_bytes = static_cast<int>(code_bytes);
    a->slice = a->n_buckets;
    if (kWarps * group * feature + staging <= kCopyBudget) {
      a->copies = kWarps;
    } else if (group * feature + staging <= kMaxSmem) {
      a->copies = 1;
    } else if (group > 1) {
      group = 1;
      continue;
    } else {
      // One feature's histogram exceeds a block: slices of the buckets, a
      // multiple of 4 so that slices keep 16-byte alignment.
      a->copies = 1;
      if (staging + 4 * c_dim * sizeof(float) > kMaxSmem) return false;
      a->slice = static_cast<int>((kMaxSmem - staging) / (c_dim * sizeof(float)) / 4 * 4);
    }
    a->hist_bytes = static_cast<int>(
        round16(static_cast<size_t>(a->copies) * group * a->slice * c_dim * sizeof(float)));
    *smem = a->hist_bytes + staging;
    *n_slices = (a->n_buckets + a->slice - 1) / a->slice;
    return *smem <= kMaxSmem;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int launch(Args a, int n_trees, int code_size, bool level, int device, void* stream) {
  if (n_trees <= 0 || n_trees > 65535 || a.n <= 0 || a.f_dim <= 0 || a.n_classes <= 0 ||
      a.n_classes > kMaxClasses || a.n_buckets <= 0 || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Per device, once: its SM count, and the shared-memory opt-in above
  // 48 KB for every instantiation.
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* kernels[] = {reinterpret_cast<const void*>(hist_kernel<uint8_t, true>),
                             reinterpret_cast<const void*>(hist_kernel<int, true>),
                             reinterpret_cast<const void*>(hist_kernel<int, false>)};
    for (const void* fn : kernels) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxSmem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sms[device] = count;
  }
  size_t smem = 0;
  int n_slices = 0;
  if (!plan(&a, &smem, &n_slices, n_trees, code_size, level, sms[device]) ||
      n_slices > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.vec_codes = level && aligned16(a.codes) &&
                (static_cast<size_t>(a.n) * code_size) % 16 == 0;
  a.vec_out = aligned16(a.out) && (static_cast<long long>(a.n_buckets) * a.n_classes) % 4 == 0 &&
              (static_cast<long long>(a.slice) * a.n_classes) % 4 == 0;
  dim3 grid((a.f_dim + a.group - 1) / a.group, n_trees, n_slices);
  auto s = static_cast<cudaStream_t>(stream);
  if (!level) {
    hist_kernel<int, false><<<grid, kThreads, smem, s>>>(a);
  } else if (code_size == 1) {
    hist_kernel<uint8_t, true><<<grid, kThreads, smem, s>>>(a);
  } else {
    hist_kernel<int, true><<<grid, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Level mode. codes: contiguous (T, F, N) of code_size bytes (1: uint8, 4:
// int32); local: contiguous (T, N) int32; y: (N,) int32; w: contiguous (T, N)
// float32; out: contiguous (T, F, n_buckets, C) float32, every entry written.
// Bucket local * n_bins + code, skipped outside [0, n_buckets); a label
// outside [0, C) adds nothing. Returns a cudaError_t.
extern "C" int repro_level_histogram(const void* codes, int code_size, const int* local,
                                     const int* y, const float* w, float* out, int n_trees,
                                     int n, int f_dim, int n_classes, int n_bins,
                                     int n_buckets, int device, void* stream) {
  if (code_size != 1 && code_size != 4) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.codes = codes;
  a.local = local;
  a.y = y;
  a.mass = w;
  a.out = out;
  a.n = n;
  a.f_dim = f_dim;
  a.n_classes = n_classes;
  a.n_bins = n_bins;
  a.n_buckets = n_buckets;
  return launch(a, n_trees, code_size, true, device, stream);
}

// Class mode (the TPU kernel's contract). codes: contiguous (T, N, F) int32;
// wy: contiguous (T, N, C) float32; out: contiguous (T, F, n_buckets, C)
// float32, every entry written. Returns a cudaError_t.
extern "C" int repro_class_histogram(const int* codes, const float* wy, float* out,
                                     int n_trees, int n, int f_dim, int n_classes,
                                     int n_buckets, int device, void* stream) {
  Args a{};
  a.codes = codes;
  a.mass = wy;
  a.out = out;
  a.n = n;
  a.f_dim = f_dim;
  a.n_classes = n_classes;
  a.n_buckets = n_buckets;
  return launch(a, n_trees, 4, false, device, stream);
}
