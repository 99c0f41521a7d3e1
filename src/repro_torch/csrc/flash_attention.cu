// K5: flash attention forward (online softmax), causal or not, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention
// (_flash_kernel). In the port it is the prefill attention of
// models/layers.py::attn_apply for full attention without a prefix, whenever
// the width is a multiple of 512 and head_dim a multiple of 128 (the
// reference's gate): 28 launches per prefill of qwen3-0.6b, q (8, 2048, 16,
// 128) and k, v (8, 2048, 8, 128) bf16 at the static prefill; 8 per prefill
// of qwen3-moe-30b-a3b cut to 8 layers, q (8, 2048, 32, 128) over k, v (8,
// 2048, 4, 128).
//
// Layout: q (B, S, H, hd) and k, v (B, S, KV, hd) in the model's own layout,
// read in place at their strides (last dimension contiguous, every other
// stride a multiple of 16 bytes, bases 16-byte aligned); head h reads KV head
// h / (H / KV), so the GQA groups are never expanded. out: (B, S, H, hd)
// contiguous, so attn_apply's reshape to (B, S, H * hd) is free.
//
// What it computes, as the TPU kernel does: s = (q . k) * 1/sqrt(hd) in f32,
// masked logits -1e30 (causal: key > query; also keys past a ragged S), a
// running max m, sum l and f32 accumulator per query row, p = exp(s - m)
// rounded to the input type before the P.V product (the reference's
// p.astype(v.dtype)) while l sums the unrounded p, and one division by
// max(l, 1e-30) and one rounding to the input type at the end. (The bf16 body
// masks the raw scores and takes exp2 of s * log2(e) / sqrt(hd) - m in one FMA
// on the SFU, subnormal results flushed: the same function up to a rounding
// of the scale.)
//
// Bound on this card at the main path's shape (B*H = 128, S = 2048, hd = 128,
// bf16, causal): the causal half of 4 * BH * S^2 * hd = 1.37e11 flop at the
// 989 TFLOP/s bf16 tensor-core rate is 0.139 ms (operations-bound); the bytes
// floor, q, k, v read and o written once, 201 MB at 3.35 TB/s, is 0.060 ms.
//
// bf16 design (FlashAttention-3's shape): one CTA per (128-row q tile, batch *
// head), three warpgroups; the blocks run in groups of one KV head of one
// batch entry (its K and V stay in L2 while the group's H / KV x S / 128
// CTAs run: 2 x 16 for qwen3-0.6b's prefill at S = 2048, 8 x 16 for
// qwen3-moe-30b-a3b's), heaviest causal tiles first within a group.
//   - Warpgroup 0 is the producer: one thread starts TMA loads through 4-D
//     tensor maps (dims hd, heads, S, B, encoded on the host), Q once and K
//     and V into a ring of three stages, each stage guarded by a "full"
//     mbarrier (TMA completes its transaction bytes) and an "empty" one (the
//     consumers release it). setmaxnreg hands its registers to the consumers.
//   - Warpgroups 1 and 2 each own 64 q rows. S = Q K^T is wgmma (m64n128k16,
//     both operands read from shared memory through descriptors, 128-byte
//     swizzle: an hd-128 row is loaded as two 64-column boxes); the softmax
//     runs on the accumulator registers; the S fragments, rounded to bf16,
//     are the A operand of O += P V, a register-A wgmma whose B is the V
//     tile read MN-major through the descriptor's transpose bit (no
//     transposed copy of V).
//   - Within a warpgroup, tile i's S and tile i-1's P V go out as one wgmma
//     stage, and tile i's softmax runs while P V is on the tensor cores
//     (FlashAttention-3's intra-warpgroup overlap; P alternates between two
//     register sets, so no register is redefined inside a stage and ptxas
//     keeps the wgmmas asynchronous). The third stage of the ring gives the
//     producer a tile of slack, since a stage is released only after its P V.
//   - Causal k tiles wholly above the diagonal are never loaded; the mask is
//     applied only on the tiles that straddle the diagonal or the ragged end
//     (rows and keys past S are zero-filled by TMA and masked or not stored).
// What still separates it from its bound and from F.scaled_dot_product_attention
// on the card is in PERF.md (no persistent scheduling, so each CTA's prologue
// and epilogue stand alone; no ping-pong between the warpgroups).
// f32 design (the reference kernel takes f32 too and the reduced configs
// compute in f32; on the card only chip_smoke.py's f32 check sends it): 256
// threads per 64-row q tile, each with a 4 x 4 tile of the scores and the
// matching 4 rows x hd/16 columns of the accumulator, f32 FMAs on the CUDA
// cores (tiles staged as f32, rows padded by one word), P through shared
// memory, bounded by the 67 TFLOP/s f32 rate (2.05 ms at the shape above).
// It reads the same layout at the same strides as the bf16 body.
#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;       // f32 body: query rows per block
constexpr int kBK = 64;       // f32 body: keys per k tile
constexpr int kThreads = 256; // f32 body: 16 x 16 threads (ty, tx)
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

// Where the f32 body reads q, k, v and writes out: element strides of (B, S,
// heads) for each input (the last dimension is contiguous); out is (B, S, H,
// HD) contiguous.
struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

template <int HD>
constexpr size_t smem_bytes() {
  // q_s, k_s: (64, HD + 1); v_s: (64, HD); p_s: (64, 65); all f32.
  return sizeof(float) *
         (2 * kBQ * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, Strides st,
                     int s, int heads, int group, int n_bh, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int LP = kBK + 1;
  constexpr int NC = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * HD;

  // Heaviest causal q tiles first: all (batch, head) pairs of the last tile,
  // then of the one before.
  const int n_qt = (s + kBQ - 1) / kBQ;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * kBQ;
  const int b = bh / heads;
  const int h = bh % heads;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + (h / group) * st.kh;
  const float* vb = v + b * st.vb + (h / group) * st.vh;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  for (int e = threadIdx.x; e < kBQ * HD; e += kThreads) {
    const int r = e / HD;
    const int c = e % HD;
    const int row = q0 + r;
    q_s[r * LD + c] = row < s ? qb[row * st.qs + c] : 0.f;
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
      k_s[r * LD + c] = ok ? kb[key * st.ks + c] : 0.f;
      v_s[r * HD + c] = ok ? vb[key * st.vs + c] : 0.f;
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
      float b4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b4[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b4[j], sc[i][j]);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + ((static_cast<long long>(b) * s + row) * heads + h) * HD;
#pragma unroll
    for (int j = 0; j < NC; ++j) orow[tx + 16 * j] = acc[i][j] / denom;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, const Strides& st,
               int batch, int s, int heads, int group, int causal, int device,
               cudaStream_t stream) {
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
  const int n_bh = batch * heads;
  const long long blocks = static_cast<long long>((s + kBQ - 1) / kBQ) * n_bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_f32_kernel<HD><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), st, s, heads, group, n_bh,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one producer warpgroup and two consumer warpgroups.
// ---------------------------------------------------------------------------

constexpr int kTQ = 128;         // q rows per CTA: two consumer warpgroups of 64
constexpr int kTK = 128;         // keys per k tile
constexpr int kStages = 3;       // K/V ring
constexpr int kBox = 64;         // columns per TMA box: 128 bytes, the swizzle width
constexpr int kWg = 128;         // threads per warpgroup
constexpr int kTmaThreads = 3 * kWg;

// Shared memory, in bytes from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): Q as HD/64 boxes of (kTQ rows, 128 B);
// per stage K and V as HD/64 boxes of (kTK rows, 128 B); then the barriers.
template <int HD>
struct TmaSmem {
  static constexpr int kQBytes = kTQ * HD * 2;
  static constexpr int kKVBytes = kTK * HD * 2;  // one K (or V) tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;  // q_full, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// 2^x on the SFU, subnormal results flushed to zero (p and alpha below 2^-126
// are zero in bf16 and in the sums alike).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128, f32) (+)= A (64 x 16, K-major in shared memory) B (128 x 16, K-major
// in shared memory); scale_d = 0 ignores D's old value.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16 bf16, registers) B (16 x 128, MN-major in shared
// memory: the descriptor's transpose bit reads a row-major (keys, hd) tile).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ out, int s, int heads, int group,
                     float scale_log2, int causal) {
  using L = TmaSmem<HD>;
  constexpr int CB = HD / kBox;  // 64-column boxes per row
  extern __shared__ uint8_t smem_tma[];
  const uint32_t base = (smem_addr(smem_tma) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full_bar = q_full + 8;                // [kStages]
  const uint32_t empty_bar = full_bar + 8 * kStages;   // [kStages]

  // Blocks in groups of one KV head of one batch entry (its K and V stay in
  // L2 while the group runs); within a group the heaviest causal q tiles
  // first, the group's q heads side by side.
  const int n_qt = (s + kTQ - 1) / kTQ;
  const int per_group = n_qt * group;
  const int gi = static_cast<int>(blockIdx.x) / per_group;
  const int r = static_cast<int>(blockIdx.x) % per_group;
  const int q0 = (n_qt - 1 - r / group) * kTQ;
  const int kv_heads = heads / group;
  const int b = gi / kv_heads;
  const int h = (gi % kv_heads) * group + r % group;
  const int k_end = causal ? min(s, q0 + kTQ) : s;
  const int n_kt = (k_end + kTK - 1) / kTK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, 2 * kWg);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(q_full, L::kQBytes);
      for (int cb = 0; cb < CB; ++cb) {
        tma_load(base + L::kQ + cb * kTQ * 128, &tm_q, q_full, cb * kBox, h, q0, b);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        mbar_wait(empty_bar + 8 * st, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * st, 2 * L::kKVBytes);
        for (int cb = 0; cb < CB; ++cb) {
          const int off = st * L::kKVBytes + cb * kTK * 128;
          tma_load(base + L::kK + off, &tm_k, full_bar + 8 * st, cb * kBox, kvh, it * kTK, b);
          tma_load(base + L::kV + off, &tm_v, full_bar + 8 * st, cb * kBox, kvh, it * kTK, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns q rows q0 + 64c ... q0 + 64c + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWg;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // accumulator row (and row + 8) within the warp's 16
    const int t = lane % 4;  // thread in the row's quad: columns 2t, 2t + 1 of each 8
    const int row_lo = q0 + 64 * c;
    const int row_a = row_lo + 16 * warp + g;
    const int row_b = row_a + 8;
    const uint32_t q_s = base + L::kQ + c * 64 * 128;

    float o[HD / 2];  // O (64 x HD): o[4j + e] is column 8j + 2t + (e & 1), row a (e < 2) or b
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of rows a, b (log2 units)
    float l[2] = {0.f, 0.f};          // this thread's share of the running sums

    // S = Q K^T of k tile `it` (64 x 128 keys), K-major operands: each k16
    // step is 32 bytes into a 128-byte swizzled row, each 64 columns a new
    // box. Started, not waited for.
    auto mma_scores = [&](int it, float (&sc)[kTK / 2]) {
      const uint32_t k_s = base + L::kK + (it % kStages) * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n128(sc, sw128_desc(q_s + (kk / 4) * kTQ * 128 + col, 16, 1024),
                      sw128_desc(k_s + (kk / 4) * kTK * 128 + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of k tile `it`: V's (keys, hd) tile is the B operand read
    // MN-major; each k16 step is 16 key rows (2 KB) further on. Started,
    // not waited for.
    auto mma_pv = [&](int it, uint32_t (&pa)[kTK / 16][4]) {
      const uint32_t v_s = base + L::kV + (it % kStages) * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        const uint64_t desc_v = sw128_desc(v_s + kk * 16 * 128, kTK * 128, 1024);
        if constexpr (HD == 128) {
          wgmma_rs_n128(o, pa[kk], desc_v);
        } else {
          wgmma_rs_n64(o, pa[kk], desc_v);
        }
      }
      wgmma_commit();
    };
    // Online softmax of k tile `it`'s scores in log2 units (the scale folded
    // into the exponent's FMA; it is positive, so the row max of the raw
    // scores scales to the row max), masked where the tile reaches past a
    // row's diagonal or past S. sc[4j + e]: key k0 + 8j + 2t + (e & 1), row a
    // (e < 2) or b. P, rounded to bf16, as the A fragments of P V: k16 step kk
    // takes key chunks 2kk (a0 row a, a1 row b) and 2kk + 1 (a2 row a, a3 row
    // b); l sums the unrounded p.
    auto softmax = [&](int it, float (&sc)[kTK / 2], uint32_t (&pa)[kTK / 16][4],
                       float (&alpha)[2]) {
      const int k0 = it * kTK;
      if (k0 + kTK > s || (causal && k0 + kTK - 1 > row_lo)) {
#pragma unroll
        for (int i = 0; i < kTK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = (i & 2) ? row_b : row_a;
          if (key >= s || (causal && key > row)) sc[i] = kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kTK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kTK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -m[e >> 1]));
          sum[e >> 1] += p[e];
        }
        pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
    };
    // K tile `it` (>= 1): its scores and the previous tile's P V (from
    // p_prev) go out as one wgmma stage; the softmax of tile it (into
    // p_next) runs while P V is on the tensor cores; then the previous tile's
    // stage is released and O is rescaled to the new row max.
    auto step = [&](int it, uint32_t (&p_prev)[kTK / 16][4],
                    uint32_t (&p_next)[kTK / 16][4]) {
      mbar_wait(full_bar + 8 * (it % kStages), (it / kStages) & 1);
      float sc[kTK / 2];
      fence_regs(sc);
      fence_regs(o);
      fence_regs(p_prev);
      wgmma_fence();
      mma_scores(it, sc);
      mma_pv(it - 1, p_prev);
      wgmma_wait<1>();
      fence_regs(sc);
      float alpha[2];
      softmax(it, sc, p_next, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p_prev);
      mbar_arrive(empty_bar + 8 * ((it - 1) % kStages));
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    };
    // The last tile's P V.
    auto finish = [&](uint32_t (&p_last)[kTK / 16][4]) {
      fence_regs(o);
      fence_regs(p_last);
      wgmma_fence();
      mma_pv(n_kt - 1, p_last);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty_bar + 8 * ((n_kt - 1) % kStages));
    };

    // Tile 0: its scores, then its softmax (O is still zero). Then the
    // tiles two at a time, P alternating between two register sets.
    uint32_t pa[kTK / 16][4];
    uint32_t pb[kTK / 16][4];
    mbar_wait(q_full, 0);
    {
      float sc[kTK / 2];
      float alpha[2];
      mbar_wait(full_bar, 0);
      fence_regs(sc);
      wgmma_fence();
      mma_scores(0, sc);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(0, sc, pa, alpha);
    }
    int it = 1;
    for (; it + 1 < n_kt; it += 2) {
      step(it, pa, pb);
      step(it + 1, pb, pa);
    }
    if (it < n_kt) {
      step(it, pa, pb);
      finish(pb);
    } else {
      finish(pa);
    }

    // The row sums live spread over the quad; one division, one rounding.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float da = fmaxf(l[0], 1e-30f);
    const float db = fmaxf(l[1], 1e-30f);
    __nv_bfloat16* oa = out + ((static_cast<long long>(b) * s + row_a) * heads + h) * HD;
    __nv_bfloat16* ob = out + ((static_cast<long long>(b) * s + row_b) * heads + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (row_a < s) {
        *reinterpret_cast<__nv_bfloat162*>(oa + col) =
            __floats2bfloat162_rn(o[4 * j + 0] / da, o[4 * j + 1] / da);
      }
      if (row_b < s) {
        *reinterpret_cast<__nv_bfloat162*>(ob + col) =
            __floats2bfloat162_rn(o[4 * j + 2] / db, o[4 * j + 3] / db);
      }
    }
  }
}

// map: dims[4] (hd, heads, S, B), byte strides[3] (heads, S, B), box[4],
// as kernels/flash_attention/kernel.py::tensor_maps computes them.
int encode(CUtensorMap* out, const void* ptr, const unsigned long long* map) {
  const cuuint64_t dims[4] = {map[0], map[1], map[2], map[3]};
  const cuuint64_t strides[3] = {map[4], map[5], map[6]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(map[7]), static_cast<cuuint32_t>(map[8]),
                             static_cast<cuuint32_t>(map[9]), static_cast<cuuint32_t>(map[10])};
  return encode_bf16_map(out, ptr, 4, dims, strides, box);
}

template <int HD>
int launch_tma(const void* q, const void* k, const void* v, void* out,
               const unsigned long long* q_map, const unsigned long long* k_map,
               const unsigned long long* v_map, int causal, int device, cudaStream_t stream) {
  constexpr int smem = TmaSmem<HD>::kBytes;
  static bool smem_set[kMaxDevices] = {};
  if (!smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = true;
  }
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, q_map);
  if (err == 0) err = encode(&tk, k, k_map);
  if (err == 0) err = encode(&tv, v, v_map);
  if (err != 0) return err;
  const int s = static_cast<int>(q_map[2]);
  const int heads = static_cast<int>(q_map[1]);
  const int n_bh = static_cast<int>(q_map[3]) * heads;
  const long long blocks = static_cast<long long>((s + kTQ - 1) / kTQ) * n_bh;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  flash_fwd_tma_kernel<HD><<<static_cast<unsigned>(blocks), kTmaThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), s, heads,
      heads / static_cast<int>(k_map[1]), scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, S, H, hd) and k, v: (B, S, KV, hd), each described by a map of 11
// values: dims (hd, heads, S, B), byte strides of (heads, S, B), the TMA box
// (64, 1, 128, 1). bf16 (is_bf16 = 1) or f32; hd 64 or 128; H % KV == 0.
// out: (B, S, H, hd) contiguous. Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     const unsigned long long* q_map,
                                     const unsigned long long* k_map,
                                     const unsigned long long* v_map, int causal, int is_bf16,
                                     int device, void* stream) {
  const unsigned long long hd = q_map[0], heads = q_map[1], s = q_map[2], batch = q_map[3];
  bool ok = (hd == 64 || hd == 128) && heads > 0 && s > 0 && batch > 0 && s < (1u << 30);
  for (const unsigned long long* kv : {k_map, v_map}) {
    ok = ok && kv[0] == hd && kv[1] > 0 && heads % kv[1] == 0 && kv[2] == s && kv[3] == batch &&
         kv[7] == kBox && kv[8] == 1 && kv[9] == kTK && kv[10] == 1;
  }
  ok = ok && k_map[1] == v_map[1] && q_map[7] == kBox && q_map[8] == 1 && q_map[9] == kTQ &&
       q_map[10] == 1;
  for (const unsigned long long* mp : {q_map, k_map, v_map}) {
    for (int i = 4; i < 7; ++i) ok = ok && mp[i] % 16 == 0;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return hd == 128 ? launch_tma<128>(q, k, v, out, q_map, k_map, v_map, causal, device, st)
                     : launch_tma<64>(q, k, v, out, q_map, k_map, v_map, causal, device, st);
  }
  const Strides str{static_cast<long long>(q_map[6] / 4), static_cast<long long>(q_map[5] / 4),
                    static_cast<long long>(q_map[4] / 4), static_cast<long long>(k_map[6] / 4),
                    static_cast<long long>(k_map[5] / 4), static_cast<long long>(k_map[4] / 4),
                    static_cast<long long>(v_map[6] / 4), static_cast<long long>(v_map[5] / 4),
                    static_cast<long long>(v_map[4] / 4)};
  const int b = static_cast<int>(batch), sq = static_cast<int>(s), hh = static_cast<int>(heads);
  const int group = hh / static_cast<int>(k_map[1]);
  return hd == 128 ? launch_f32<128>(q, k, v, out, str, b, sq, hh, group, causal, device, st)
                   : launch_f32<64>(q, k, v, out, str, b, sq, hh, group, causal, device, st);
}
