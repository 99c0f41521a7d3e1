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
// Bound on this card: the function needs one F-long dot product per live
// node on each row's path (at most depth = log2(L) a tree; a dead node needs
// none: it routes left whatever the value), 2 * F flops each, and reads, once
// each, x, the column, thr and next_node entry of every distinct live node
// the rows visit (and each tree's first next_node entry), the class row of
// every leaf reached, and writes (B, C):
//     bytes = 4 (B F + (F + 3) nodes + 2 T + C leaves + B C)
//     flops = 2 F visits
// At x (1920, 288) on the committed program that is ~54k visits (31 MFLOP)
// of its 81 live nodes (94 KB of columns beside x's 2.2 MB): bytes bound
// it, at about 0.7 us. chip_smoke.py counts nodes, leaves and visits from
// the run's own rows.
//
// Design: the TPU kernel computed all L node values of a tree as one matmul
// and then picked the path; here a warp walks one row's paths and computes
// only the live node values on them. The warp holds the row's x in
// registers (F / 32 floats a lane) and reads each live path node's column of
// proj from proj_nodes, a node-major (T, L, F) copy, so a column is one
// contiguous, coalesced read (the TPU layout strides it by L). A dead node
// routes left whatever its value, so the walk skips it: next_node gives each
// node's next live node on either side (or the leaf), and both tables are
// derived from the forest once, where the program reaches the card. Each
// lane sums its features' products, and a butterfly of __shfl_xor_sync
// gives every lane the same node value (a + b == b + a, so the lanes agree
// bit for bit and branch alike). The steps of a path depend on each other,
// the trees do not: the warp walks kGroup trees side by side and issues all
// their loads of a step before any product waits on one, so a row pays
// about (live path length) * T / kGroup load latencies. The rows' shared
// top-level columns stay in L1. Values are true float32 fmaf sums (a TF32
// rounding near thr flips a route); they add in another order than the
// plain version's matmul, so a route may differ only where |x . proj - thr|
// is within rounding.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rows per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 5;       // trees a warp walks side by side
constexpr int kMaxChunks = 16;  // F <= 512: 32 features a chunk, one chunk a register
constexpr int kMaxClasses = 8;

template <int CHUNKS>
__global__ void __launch_bounds__(kThreads)
forest_kernel(const float* __restrict__ x, const float* __restrict__ proj_nodes,
              const float* __restrict__ thr, const int2* __restrict__ next_node,
              const float* __restrict__ leaf, float* __restrict__ out, int batch,
              int f_dim, int n_trees, int n_leaves, int n_classes, int depth) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= batch) return;  // warps share nothing: a warp past the end leaves

  float xr[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int f = lane + 32 * c;
    xr[c] = f < f_dim ? __ldg(x + row * f_dim + f) : 0.f;
  }

  float acc[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) acc[c] = 0.f;

  for (int t0 = 0; t0 < n_trees; t0 += kGroup) {
    // Each tree's first live node (entry 0 of its table), or its leaf.
    int node[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      node[u] = t0 + u < n_trees
                    ? __ldg(next_node + static_cast<long long>(t0 + u) * n_leaves).x
                    : n_leaves;
    }
    for (int lev = 0; lev < depth; ++lev) {
      bool walking = false;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) walking |= node[u] < n_leaves;
      if (!walking) break;  // the same on every lane: node values are warp-wide
      // Every walking tree's column, threshold and successors at its node,
      // all in flight at once.
      float w[kGroup][CHUNKS];
      float th[kGroup];
      int2 nx[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        th[u] = 0.f;
        nx[u] = make_int2(node[u], node[u]);
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) w[u][c] = 0.f;
        if (node[u] < n_leaves) {
          const long long at = static_cast<long long>(t0 + u) * n_leaves + node[u];
          th[u] = __ldg(thr + at);
          nx[u] = __ldg(next_node + at);
          const float* col = proj_nodes + at * f_dim;
#pragma unroll
          for (int c = 0; c < CHUNKS; ++c) {
            const int f = lane + 32 * c;
            if (f < f_dim) w[u][c] = __ldg(col + f);
          }
        }
      }
      float v[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        v[u] = 0.f;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) v[u] = fmaf(xr[c], w[u][c], v[u]);
      }
      // Butterfly sum over the lanes: every lane ends with the node value.
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) v[u] += __shfl_xor_sync(0xffffffffu, v[u], off);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        node[u] = v[u] > th[u] ? nx[u].y : nx[u].x;
      }
    }

#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (t0 + u < n_trees) {  // trees in ascending order, as the plain version sums
        const float* lp = leaf + (static_cast<long long>(t0 + u) * n_leaves +
                                  (node[u] & (n_leaves - 1))) * n_classes;
#pragma unroll
        for (int c = 0; c < kMaxClasses; ++c) {
          if (c < n_classes) acc[c] += __ldg(lp + c);
        }
      }
    }
  }

  if (lane == 0) {
    float* o = out + row * n_classes;
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < n_classes) o[c] = acc[c];
    }
  }
}

template <int CHUNKS>
cudaError_t launch(const float* x, const float* proj_nodes, const float* thr,
                   const int2* next_node, const float* leaf, float* out, int batch,
                   int f_dim, int n_trees, int n_leaves, int n_classes, int depth,
                   cudaStream_t stream) {
  const int blocks = (batch + kWarps - 1) / kWarps;
  forest_kernel<CHUNKS><<<blocks, kThreads, 0, stream>>>(
      x, proj_nodes, thr, next_node, leaf, out, batch, f_dim, n_trees, n_leaves,
      n_classes, depth);
  return cudaGetLastError();
}

}  // namespace

// All pointers are contiguous device buffers, float32 but for next_node:
// proj_nodes is the node-major (T, L, F) copy of proj, next_node the
// (T, L, 2) int32 table of each node's next live node left and right (a
// value >= L is the leaf L + l; entry 0 is the first live node from the
// root). Returns a cudaError_t.
extern "C" int repro_forest_traverse(const float* x, const float* proj_nodes,
                                     const float* thr, const int* next_node,
                                     const float* leaf,
                                     float* out, int batch, int f_dim,
                                     int n_trees, int n_leaves, int n_classes,
                                     int depth, int device, void* stream) {
  if (batch <= 0 || f_dim <= 0 || f_dim > 32 * kMaxChunks || n_trees <= 0 ||
      n_leaves <= 0 || (1 << depth) != n_leaves || n_classes <= 0 ||
      n_classes > kMaxClasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FOREST_CASE(K)                                                        \
  case K:                                                                           \
    return static_cast<int>(launch<K>(x, proj_nodes, thr,                          \
                                      reinterpret_cast<const int2*>(next_node), leaf, \
                                      out, batch, f_dim, n_trees, n_leaves, n_classes, \
                                      depth, s));
  switch ((f_dim + 31) / 32) {
    REPRO_FOREST_CASE(1) REPRO_FOREST_CASE(2) REPRO_FOREST_CASE(3) REPRO_FOREST_CASE(4)
    REPRO_FOREST_CASE(5) REPRO_FOREST_CASE(6) REPRO_FOREST_CASE(7) REPRO_FOREST_CASE(8)
    REPRO_FOREST_CASE(9) REPRO_FOREST_CASE(10) REPRO_FOREST_CASE(11) REPRO_FOREST_CASE(12)
    REPRO_FOREST_CASE(13) REPRO_FOREST_CASE(14) REPRO_FOREST_CASE(15) REPRO_FOREST_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FOREST_CASE
}
