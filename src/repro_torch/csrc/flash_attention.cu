// K5: flash attention forward (online softmax), causal or not, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention
// (_flash_kernel). In the port it is the prefill attention of
// models/layers.py::attn_apply for full attention without a prefix, whenever
// the width is a multiple of 512 and head_dim a multiple of 128 (the
// reference's gate): 28 launches per prefill of qwen3-0.6b, q, k, v of
// (B*H, S, 128) bf16 after the GQA expansion in kernels/flash_attention/ops.py.
//
// What it computes, as the TPU kernel does: s = (q . k) * 1/sqrt(hd) in f32,
// masked logits -1e30 (causal: key > query; also keys past a ragged S), a
// running max m, sum l and f32 accumulator per query row, p = exp(s - m)
// rounded to the input type before the P.V product (the reference's
// p.astype(v.dtype)) while l sums the unrounded p, and one division by
// max(l, 1e-30) and one rounding to the input type at the end.
//
// Bound on this card at the main path's shape (BH = 128, S = 2048, hd = 128,
// bf16, causal): the causal half of 4 * BH * S^2 * hd = 1.37e11 flop at the
// 989 TFLOP/s bf16 tensor-core rate is 0.139 ms (operations-bound); the bytes
// floor, q, k, v read and o written once, 268 MB at 3.35 TB/s, is 0.080 ms.
//
// Design (simple first): one block per (q tile of 64 rows, batch*head), the
// k-tile loop inside the block, heaviest causal q tiles launched first; each
// 64-key K and V tile is staged in shared memory, tiles above the causal
// diagonal are never loaded, and the running max and sum of each row stay in
// registers, reduced across the lanes that share the row with shuffles.
//   bf16 (the main path): four warps of 16 query rows, the products on the
//   tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The S
//   fragments of Q K^T are rounded to bf16 in registers and reused as the A
//   operand of P V, so P never touches shared memory. Tiles are bf16 rows
//   padded by 16 bytes, so a warp's fragment loads hit 32 distinct banks.
//   f32 (the reference kernel takes f32 too, and the reduced configs compute
//   in f32; on the card only chip_smoke.py's f32 check sends it today): 256
//   threads, each with a 4 x 4 tile of the scores and the matching 4 rows x
//   hd/16 columns of the accumulator, f32 FMAs on the CUDA cores (tiles
//   staged as f32, rows padded by one word), P through shared memory; the
//   same tile schedule as bf16 in a second body, bounded by the 67 TFLOP/s
//   f32 rate (2.05 ms at the shape above).
// No TMA, no wgmma, no overlap of loads with products yet: the next PRs' work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per k tile
constexpr int kThreads = 256; // f32 path: 16 x 16 threads (ty, tx)
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

template <int HD>
constexpr size_t smem_bytes() {
  // q_s, k_s: (64, HD + 1); v_s: (64, HD); p_s: (64, 65); all f32.
  return sizeof(float) *
         (2 * kBQ * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int s,
                     float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int LP = kBK + 1;
  constexpr int NC = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * HD;

  const int n_qt = (s + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const long long base = static_cast<long long>(blockIdx.y) * s * HD;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  for (int e = threadIdx.x; e < kBQ * HD; e += kThreads) {
    const int r = e / HD;
    const int c = e % HD;
    const int row = q0 + r;
    q_s[r * LD + c] =
        row < s ? qb[static_cast<long long>(row) * HD + c] : 0.f;
  }

  float m[4];
  float l[4];
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  // Keys below k_end can reach a row of this tile; causal tiles past the
  // diagonal are skipped.
  const int k_end = causal ? min(s, q0 + kBQ) : s;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < kBK * HD; e += kThreads) {
      const int r = e / HD;
      const int c = e % HD;
      const int key = k0 + r;
      const bool ok = key < s;
      const long long off = static_cast<long long>(key) * HD + c;
      k_s[r * LD + c] = ok ? kb[off] : 0.f;
      v_s[r * HD + c] = ok ? vb[off] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4];
      float b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float val = sc[i][j] * scale;
        if (col >= s || (causal && col > row)) val = kNegInf;
        sc[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * LP + tx + 16 * j] = p;  // f32 input: no rounding
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
      float vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = v_s[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  float* ob = out + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      ob[static_cast<long long>(row) * HD + tx + 16 * j] = acc[i][j] / denom;
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh,
               int s, int causal, int device, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // The opt-in above 48 KB is a property of the kernel on this device: set
  // it once per device.
  static bool smem_set[kMaxDevices] = {};
  if (!smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_fwd_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the same schedule on the tensor cores (mma.sync m16n8k16, f32
// accumulate). Four warps, 16 query rows each; the S = Q K^T fragments are
// reused as the A operand of P V after rounding P to bf16, so P never
// leaves registers. Q, K and V tiles are staged in shared memory as bf16,
// rows padded by 8 elements (16 bytes) so the fragment loads of one warp
// hit 32 distinct banks.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows = kBQ

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(unsigned short) * 3 * kBQ * (HD + 8);
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<unsigned*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int s, float scale,
                     int causal) {
  constexpr int LDS = HD + 8;      // padded row, in bf16 elements
  constexpr int KS = HD / 16;      // k-steps of Q K^T
  constexpr int NT = kBK / 8;      // 8-key n-tiles of S
  constexpr int NO = HD / 8;       // 8-column n-tiles of O
  constexpr int V16 = HD / 8;      // 16-byte chunks per row
  extern __shared__ uint4 smem_mma[];
  unsigned short* q_s = reinterpret_cast<unsigned short*>(smem_mma);
  unsigned short* k_s = q_s + kBQ * LDS;
  unsigned short* v_s = k_s + kBK * LDS;

  const int n_qt = (s + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const long long base = static_cast<long long>(blockIdx.y) * s * HD;
  const uint4* qb = reinterpret_cast<const uint4*>(q + base);
  const uint4* kb = reinterpret_cast<const uint4*>(k + base);
  const uint4* vb = reinterpret_cast<const uint4*>(v + base);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and B column) group
  const int t = lane % 4;  // thread in the group
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int e = threadIdx.x; e < kBQ * V16; e += kMmaThreads) {
    const int r = e / V16;
    const int c = e % V16;
    const int row = q0 + r;
    reinterpret_cast<uint4*>(q_s + r * LDS)[c] =
        row < s ? qb[static_cast<long long>(row) * V16 + c] : zero;
  }
  __syncthreads();

  // This warp's 16 rows of Q as A fragments, kept for the whole k loop.
  unsigned qf[KS][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c0 = kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const unsigned*>(q_s + r0 * LDS + c0);
    qf[kk][1] = *reinterpret_cast<const unsigned*>(q_s + (r0 + 8) * LDS + c0);
    qf[kk][2] = *reinterpret_cast<const unsigned*>(q_s + r0 * LDS + c0 + 8);
    qf[kk][3] = *reinterpret_cast<const unsigned*>(q_s + (r0 + 8) * LDS + c0 + 8);
  }

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows r0 and r0 + 8
  float l[2] = {0.f, 0.f};
  const int row_a = q0 + r0;
  const int row_b = row_a + 8;

  const int k_end = causal ? min(s, q0 + kBQ) : s;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < kBK * V16; e += kMmaThreads) {
      const int r = e / V16;
      const int c = e % V16;
      const int key = k0 + r;
      const bool ok = key < s;
      const long long off = static_cast<long long>(key) * V16 + c;
      reinterpret_cast<uint4*>(k_s + r * LDS)[c] = ok ? kb[off] : zero;
      reinterpret_cast<uint4*>(v_s + r * LDS)[c] = ok ? vb[off] : zero;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const unsigned short* krow = k_s + (j * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const unsigned b0 = *reinterpret_cast<const unsigned*>(krow + kk * 16);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(krow + kk * 16 + 8);
        mma_bf16(sc[j], qf[kk], b0, b1);
      }
    }

    // Scale, mask, online softmax. sc[j][0..1] are row_a, keys
    // k0 + 8j + 2t + {0, 1}; sc[j][2..3] the same keys of row_b.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float val = sc[j][e] * scale;
        if (key >= s || (causal && key > row)) val = kNegInf;
        sc[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
    unsigned pa[kBK / 16][4];  // P as A fragments, rounded to bf16
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(sc[j][e] - m[e >> 1]);
        sum[e >> 1] += p[e];
      }
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: the B operand pairs two keys of one V column.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned short* v0 = v_s + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const unsigned short* vc = v0 + j * 8;
        const unsigned b0 = static_cast<unsigned>(vc[0]) |
                            (static_cast<unsigned>(vc[LDS]) << 16);
        const unsigned b1 = static_cast<unsigned>(vc[8 * LDS]) |
                            (static_cast<unsigned>(vc[9 * LDS]) << 16);
        mma_bf16(o[j], pa[kk], b0, b1);
      }
    }
  }

  const float da = fmaxf(l[0], 1e-30f);
  const float db = fmaxf(l[1], 1e-30f);
  __nv_bfloat16* ob = out + base;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + 2 * t;
    if (row_a < s) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row_a) * HD + col) =
          __floats2bfloat162_rn(o[j][0] / da, o[j][1] / da);
    }
    if (row_b < s) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row_b) * HD + col) =
          __floats2bfloat162_rn(o[j][2] / db, o[j][3] / db);
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int bh,
               int s, int causal, int device, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  static bool smem_set[kMaxDevices] = {};
  if (!smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_fwd_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), s,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: contiguous (bh, s, hd) of one type, bf16 (is_bf16 = 1) or
// f32 (is_bf16 = 0); hd 64 or 128. Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int bh, int s,
                                     int hd, int causal, int is_bf16,
                                     int device, void* stream) {
  if (bh <= 0 || bh > 65535 || s <= 0 || (hd != 64 && hd != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return hd == 128 ? launch_mma<128>(q, k, v, out, bh, s, causal, device, st)
                     : launch_mma<64>(q, k, v, out, bh, s, causal, device, st);
  }
  return hd == 128 ? launch_f32<128>(q, k, v, out, bh, s, causal, device, st)
                   : launch_f32<64>(q, k, v, out, bh, s, causal, device, st);
}
