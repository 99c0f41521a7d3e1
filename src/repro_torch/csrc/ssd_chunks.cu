// K6: the SSD intra-chunk step (Mamba2's chunked scan) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py::ssd_chunks
// (_ssd_chunk_kernel). In the port it is the chunk step of
// kernels/ssd/ops.py::ssd_scan, which models/ssm.py::_ssm_inner calls for
// every Mamba2 block whose activations are on the card, with no initial
// state and S a multiple of the chunk (chunk = min(256, S)): twice per block
// (pass 1 with h_in = 0 for the chunk states, pass 2 with the true h_in), so
// 162 launches per zamba2-7b prefill; the static prefill's launch is
// q, k, v (8 * 112, 8, 256, 64) bf16.
//
// What it computes for one chunk of L rows, as the TPU kernel does:
//   cum   = inclusive float32 cumsum of ld
//   P     = (q k^T, f32) * exp(cum_i - cum_j) for j <= i, else 0, rounded to
//           the input type (the TPU kernel's scores.astype(v.dtype))
//   y     = P v (f32 accumulate) + (q * exp(cum)) h_in (f32 operands),
//           rounded once to the input type
//   state = sum_l exp(cum_L - cum_l) k_l v_l^T + exp(cum_L) h_in, float32
// The decay is selected before its exponent is taken: above the diagonal
// cum_i - cum_j is positive and may overflow, and inf * 0 is NaN.
//
// Bound on this card at the static prefill's shape (BH * NC = 7168 chunks,
// L = 256, D = 64, bf16): the bytes, q, k, v, ld and h_in read and y and the
// state written once, 7168 * (4 * 256 * 64 * 2 + 256 * 2 + 2 * 64 * 64 * 4)
// = 1.18 GB, 0.35 ms at 3.35 TB/s; the products, the causal half of q k^T
// and P v on the tensor cores, 7168 * 2 * 2 * 64 * 256 * 257 / 2 = 60.4
// GFLOP, 0.061 ms at 989 TFLOP/s, and q h_in and the state on the CUDA
// cores in float32, 7168 * 2 * 2 * 256 * 64 * 64 = 30.1 GFLOP, 0.45 ms at
// 67 TFLOP/s: operations-bound, by the float32 products (chip_smoke.py
// reckons the bound from each run's shapes).
//
// Design (simple first): one block of 8 warps per (bh, chunk); q, k, v of
// the chunk, h_in, cum and exp(cum_L - cum) are staged in shared memory once
// and read by three phases.
//   bf16 (the main path): each warp owns two 16-row slabs of y (slab w and
//   15 - w, so every warp does the same causal work). A slab starts from its
//   (q * exp(cum)) h_in term, float32 FMAs laid out as the mma accumulator;
//   then for each 16-key block up to the diagonal, S = Q K^T on the tensor
//   cores (mma.sync m16n8k16, bf16 in, f32 accumulate), the decay applied in
//   registers, rounded to bf16 and fed back as the A operand of the P V mma
//   (K5's register layout), so P never touches shared memory. Tiles are bf16
//   rows padded by 16 bytes, so a warp's fragment loads hit 32 distinct banks.
//   f32 (the reference kernel takes f32 too; on the card only chip_smoke.py's
//   f32 check sends it): the same three phases on the CUDA cores, per 64-row
//   tile, with P through shared memory (f32 rows padded by one word).
//   The state: each thread owns a 4 x 4 tile of the 64 x 64 state and sums
//   the L rows in float32.
// No TMA, no wgmma, no overlap of loads with products; pass 1 still writes y,
// and the head-broadcast B and C are read as copies (kernels/ssd/ops.py
// receives them expanded): the next PRs' work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;         // Dk = Dv
constexpr int kMaxL = 256;     // chunk length
constexpr int kThreads = 256;  // 8 warps
constexpr int kLdb = kD + 8;   // bf16 row stride in shared memory (elements)
constexpr int kLdf = kD + 1;   // f32 row stride in shared memory (words)
constexpr int kTile = 64;      // f32 body: rows per tile, keys per tile
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// cum_s[p] = ld[0] + ... + ld[p] for p < 256 (ld read as 0 past L), and
// dte_s[p] = exp(cum_{L-1} - cum_p). Warp 0 scans: each lane sums 8
// consecutive positions, then the lanes' totals are scanned with shuffles.
template <typename T>
__device__ void chunk_cumsum(const T* __restrict__ ld, int L, float* cum_s,
                             float* dte_s) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    float vals[8];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = lane * 8 + i;
      run += p < L ? to_float(ld[p]) : 0.f;
      vals[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    const float excl = incl - run;
#pragma unroll
    for (int i = 0; i < 8; ++i) cum_s[lane * 8 + i] = vals[i] + excl;
  }
  __syncthreads();
  const float last = cum_s[L - 1];
  for (int p = threadIdx.x; p < kMaxL; p += kThreads) dte_s[p] = expf(last - cum_s[p]);
}

__device__ __forceinline__ void load4(const unsigned short* p, float* out) {
  // four bf16 values at an 8-byte-aligned address
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(w.x << 16);
  out[1] = __uint_as_float(w.x & 0xffff0000u);
  out[2] = __uint_as_float(w.y << 16);
  out[3] = __uint_as_float(w.y & 0xffff0000u);
}

__device__ __forceinline__ void load4(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = p[i];
}

// state = sum_l dte_l k_l^T v_l + exp(cum_{L-1}) h_in, each thread a 4 x 4
// tile: state rows 4 * (tid / 16) + i, columns 4 * (tid % 16) + j.
template <typename S, int LD>
__device__ void chunk_state(const S* k_s, const S* v_s, const float* h_s,
                            const float* cum_s, const float* dte_s, int L,
                            float* __restrict__ state) {
  const int d0 = 4 * (threadIdx.x / 16);
  const int c0 = 4 * (threadIdx.x % 16);
  float acc[4][4] = {};
  for (int l = 0; l < L; ++l) {
    const float w = dte_s[l];
    float kd[4];
    float vv[4];
    load4(k_s + l * LD + d0, kd);
    load4(v_s + l * LD + c0, vv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      kd[i] *= w;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kd[i], vv[j], acc[i][j]);
    }
  }
  const float et = expf(cum_s[L - 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 h = *reinterpret_cast<const float4*>(h_s + (d0 + i) * kD + c0);
    *reinterpret_cast<float4*>(state + (d0 + i) * kD + c0) =
        make_float4(acc[i][0] + et * h.x, acc[i][1] + et * h.y,
                    acc[i][2] + et * h.z, acc[i][3] + et * h.w);
  }
}

__device__ __forceinline__ void load_h(const float* __restrict__ hb, float* h_s) {
  const float4* src = reinterpret_cast<const float4*>(hb);
  float4* dst = reinterpret_cast<float4*>(h_s);
  for (int e = threadIdx.x; e < kD * kD / 4; e += kThreads) dst[e] = src[e];
}

// ---------------------------------------------------------------------------
// bf16: tensor cores for q k^T and P v.
// Shared memory: cum (256 f32), dte (256 f32), h_in (64 x 64 f32), then q, k,
// v as Lp rows of kLdb bf16 (Lp = L rounded up to 64, rows past L zero).
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ float bf16_at(const unsigned short* p) {
  return __uint_as_float(static_cast<unsigned>(*p) << 16);
}

size_t bf16_smem_bytes(int lp) {
  return sizeof(float) * (2 * kMaxL + kD * kD) + sizeof(unsigned short) * 3 * lp * kLdb;
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ ld,
                      const float* __restrict__ h_in, __nv_bfloat16* __restrict__ y,
                      float* __restrict__ state, int L) {
  constexpr int V16 = kD / 8;  // 16-byte chunks per row
  extern __shared__ uint4 smem_bf16[];
  float* cum_s = reinterpret_cast<float*>(smem_bf16);
  float* dte_s = cum_s + kMaxL;
  float* h_s = dte_s + kMaxL;
  unsigned short* q_s = reinterpret_cast<unsigned short*>(h_s + kD * kD);
  const int lp = (L + kTile - 1) / kTile * kTile;
  unsigned short* k_s = q_s + lp * kLdb;
  unsigned short* v_s = k_s + lp * kLdb;

  const long long chunk = blockIdx.x;
  const long long base = chunk * L * kD;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  {
    const uint4* qb = reinterpret_cast<const uint4*>(q + base);
    const uint4* kb = reinterpret_cast<const uint4*>(k + base);
    const uint4* vb = reinterpret_cast<const uint4*>(v + base);
    for (int e = threadIdx.x; e < lp * V16; e += kThreads) {
      const int r = e / V16;
      const int c = e % V16;
      const bool ok = r < L;
      reinterpret_cast<uint4*>(q_s + r * kLdb)[c] = ok ? qb[e] : zero;
      reinterpret_cast<uint4*>(k_s + r * kLdb)[c] = ok ? kb[e] : zero;
      reinterpret_cast<uint4*>(v_s + r * kLdb)[c] = ok ? vb[e] : zero;
    }
  }
  load_h(h_in + chunk * kD * kD, h_s);
  chunk_cumsum(ld + chunk * L, L, cum_s, dte_s);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and B column) group
  const int t = lane % 4;  // thread in the group
  const int n_slabs = (L + 15) / 16;
  __nv_bfloat16* yb = y + base;

  for (int pass = 0; pass < 2; ++pass) {
    const int slab = pass == 0 ? warp : 15 - warp;
    if (slab >= n_slabs) continue;
    const int row_a = slab * 16 + g;
    const int row_b = row_a + 8;

    // The incoming-state term, (q * exp(cum)) h_in in float32, laid out as
    // the accumulator: o[j][0..1] row_a, columns 8j + 2t + {0, 1};
    // o[j][2..3] the same columns of row_b.
    float o[kD / 8][4];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    const float ea = expf(cum_s[row_a]);
    const float eb = expf(cum_s[row_b]);
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const float qa = bf16_at(q_s + row_a * kLdb + d) * ea;
      const float qb = bf16_at(q_s + row_b * kLdb + d) * eb;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const float2 h = *reinterpret_cast<const float2*>(h_s + d * kD + j * 8 + 2 * t);
        o[j][0] = fmaf(qa, h.x, o[j][0]);
        o[j][1] = fmaf(qa, h.y, o[j][1]);
        o[j][2] = fmaf(qb, h.x, o[j][2]);
        o[j][3] = fmaf(qb, h.y, o[j][3]);
      }
    }

    // This slab's 16 rows of Q as A fragments.
    unsigned qf[kD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      qf[kk][0] = *reinterpret_cast<const unsigned*>(q_s + row_a * kLdb + c0);
      qf[kk][1] = *reinterpret_cast<const unsigned*>(q_s + row_b * kLdb + c0);
      qf[kk][2] = *reinterpret_cast<const unsigned*>(q_s + row_a * kLdb + c0 + 8);
      qf[kk][3] = *reinterpret_cast<const unsigned*>(q_s + row_b * kLdb + c0 + 8);
    }
    const float cum_a = cum_s[row_a];
    const float cum_b = cum_s[row_b];

    // Key blocks of 16 up to the diagonal block.
    for (int kb = 0; kb <= slab; ++kb) {
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
        const unsigned short* krow = k_s + (kb * 16 + j * 8 + g) * kLdb + 2 * t;
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const unsigned b0 = *reinterpret_cast<const unsigned*>(krow + kk * 16);
          const unsigned b1 = *reinterpret_cast<const unsigned*>(krow + kk * 16 + 8);
          mma_bf16(sc[j], qf[kk], b0, b1);
        }
      }
      // Decay, selected before the exponent; P rounded to bf16 as the A
      // operand: a[0] row_a keys 2t..2t+1, a[1] row_b, a[2] and a[3] the
      // keys 8 further.
      unsigned pa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb * 16 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          const float cr = e < 2 ? cum_a : cum_b;
          p[e] = key <= row ? sc[j][e] * expf(cr - cum_s[key]) : 0.f;
        }
        pa[j * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[j * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      // O += P V: the B operand pairs two keys of one V column.
      const unsigned short* v0 = v_s + (kb * 16 + 2 * t) * kLdb + g;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const unsigned short* vc = v0 + j * 8;
        const unsigned b0 = static_cast<unsigned>(vc[0]) |
                            (static_cast<unsigned>(vc[kLdb]) << 16);
        const unsigned b1 = static_cast<unsigned>(vc[8 * kLdb]) |
                            (static_cast<unsigned>(vc[9 * kLdb]) << 16);
        mma_bf16(o[j], pa, b0, b1);
      }
    }

#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (row_a < L) {
        *reinterpret_cast<__nv_bfloat162*>(yb + row_a * kD + col) =
            __floats2bfloat162_rn(o[j][0], o[j][1]);
      }
      if (row_b < L) {
        *reinterpret_cast<__nv_bfloat162*>(yb + row_b * kD + col) =
            __floats2bfloat162_rn(o[j][2], o[j][3]);
      }
    }
  }

  chunk_state<unsigned short, kLdb>(k_s, v_s, h_s, cum_s, dte_s, L,
                                    state + chunk * kD * kD);
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores throughout, per 64-row tile. 256 threads as 16 x 16
// (ty, tx), each with rows ty + 16i and keys (or columns) tx + 16j, i, j < 4.
// Shared memory: cum, dte, h_in as above, then k and v (Lp rows of kLdf
// words), one q tile and one P tile (64 rows of kLdf words each).
// ---------------------------------------------------------------------------

size_t f32_smem_bytes(int lp) {
  return sizeof(float) * (2 * kMaxL + kD * kD + 2 * lp * kLdf + 2 * kTile * kLdf);
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ ld,
                     const float* __restrict__ h_in, float* __restrict__ y,
                     float* __restrict__ state, int L) {
  extern __shared__ uint4 smem_f32[];
  float* cum_s = reinterpret_cast<float*>(smem_f32);
  float* dte_s = cum_s + kMaxL;
  float* h_s = dte_s + kMaxL;
  float* k_s = h_s + kD * kD;
  const int lp = (L + kTile - 1) / kTile * kTile;
  float* v_s = k_s + lp * kLdf;
  float* q_t = v_s + lp * kLdf;
  float* p_t = q_t + kTile * kLdf;

  const long long chunk = blockIdx.x;
  const long long base = chunk * L * kD;
  const float* qb = q + base;
  for (int e = threadIdx.x; e < lp * kD; e += kThreads) {
    const int r = e / kD;
    const int c = e % kD;
    const bool ok = r < L;
    k_s[r * kLdf + c] = ok ? k[base + e] : 0.f;
    v_s[r * kLdf + c] = ok ? v[base + e] : 0.f;
  }
  load_h(h_in + chunk * kD * kD, h_s);
  chunk_cumsum(ld + chunk * L, L, cum_s, dte_s);
  __syncthreads();

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float* yb = y + base;
  for (int r0 = 0; r0 < L; r0 += kTile) {
    __syncthreads();  // the previous tile's readers of q_t are done
    for (int e = threadIdx.x; e < kTile * kD; e += kThreads) {
      const int r = e / kD;
      const int c = e % kD;
      q_t[r * kLdf + c] = r0 + r < L ? qb[static_cast<long long>(r0) * kD + e] : 0.f;
    }
    __syncthreads();

    float acc[4][4];
    float cr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cr[i] = cum_s[r0 + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    // (q * exp(cum)) h_in
    float er[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) er[i] = expf(cr[i]);
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float a[4];
      float h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_t[(ty + 16 * i) * kLdf + d] * er[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = h_s[d * kD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], h[j], acc[i][j]);
    }

    for (int k0 = 0; k0 <= r0; k0 += kTile) {
      float sc[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < kD; ++d) {
        float a[4];
        float b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q_t[(ty + 16 * i) * kLdf + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = k_s[(k0 + tx + 16 * j) * kLdf + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          p_t[(ty + 16 * i) * kLdf + tx + 16 * j] =
              key <= row ? sc[i][j] * expf(cr[i] - cum_s[key]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kTile; ++kk) {
        float p[4];
        float vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = p_t[(ty + 16 * i) * kLdf + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = v_s[(k0 + kk) * kLdf + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
      }
      __syncthreads();  // p_t is rewritten by the next key tile
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row >= L) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) yb[static_cast<long long>(row) * kD + tx + 16 * j] = acc[i][j];
    }
  }

  chunk_state<float, kLdf>(k_s, v_s, h_s, cum_s, dte_s, L, state + chunk * kD * kD);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, bool* done, int device) {
  // The opt-in above 48 KB is a property of the kernel on this device: set
  // it once per device, to the largest chunk's size.
  if (!done[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    done[device] = true;
  }
  return 0;
}

}  // namespace

// q, k, v, y: contiguous (n_chunks, L, 64) of one type, bf16 (is_bf16 = 1)
// or f32 (is_bf16 = 0); ld: (n_chunks, L) of that type; h_in, state:
// (n_chunks, 64, 64) f32; 1 <= L <= 256. Returns a cudaError_t.
extern "C" int repro_ssd_chunks(const void* q, const void* k, const void* v,
                                const void* ld, const void* h_in, void* y,
                                void* state, long long n_chunks, int L, int is_bf16,
                                int device, void* stream) {
  if (n_chunks <= 0 || n_chunks > 2147483647LL || L <= 0 || L > kMaxL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lp = (L + kTile - 1) / kTile * kTile;
  const dim3 grid(static_cast<unsigned>(n_chunks));
  if (is_bf16) {
    static bool done[kMaxDevices] = {};
    int e = set_smem(ssd_chunk_bf16_kernel, bf16_smem_bytes(kMaxL), done, device);
    if (e) return e;
    ssd_chunk_bf16_kernel<<<grid, kThreads, bf16_smem_bytes(lp), st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(ld),
        static_cast<const float*>(h_in), static_cast<__nv_bfloat16*>(y),
        static_cast<float*>(state), L);
  } else {
    static bool done[kMaxDevices] = {};
    int e = set_smem(ssd_chunk_f32_kernel, f32_smem_bytes(kMaxL), done, device);
    if (e) return e;
    ssd_chunk_f32_kernel<<<grid, kThreads, f32_smem_bytes(lp), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(ld),
        static_cast<const float*>(h_in), static_cast<float*>(y),
        static_cast<float*>(state), L);
  }
  return static_cast<int>(cudaGetLastError());
}
