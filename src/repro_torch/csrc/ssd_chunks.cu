// K6: the SSD intra-chunk step (Mamba2's chunked scan) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py::ssd_chunks
// (_ssd_chunk_kernel). What it computes for one chunk of L rows of one head,
// as the TPU kernel does:
//   cum   = inclusive float32 cumsum of ld
//   P     = (q k^T, f32) * exp(cum_i - cum_j) for j <= i, else 0, rounded to
//           the input type (the TPU kernel's scores.astype(v.dtype))
//   y     = P v (f32 accumulate) + (q * exp(cum)) h_in (f32 operands),
//           rounded once to the input type
//   state = sum_l exp(cum_L - cum_l) k_l v_l^T + exp(cum_L) h_in, float32
// The decay is selected before it multiplies: above the diagonal
// cum_i - cum_j is positive and its exponent may be inf, and inf * 0 is NaN.
//
// Three modes of one source (kernels/ssd/kernel.py):
//   full     (ssd_chunks): y and the state, as the TPU kernel;
//   states   (ssd_chunk_states, pass 1 of kernels/ssd/ops.py): the state of a
//            chunk entering with h_in = 0; reads no q and no h_in, computes
//            no q k^T, P v or q h_in, writes no y;
//   outputs  (ssd_chunk_outputs, pass 2): y given the true h_in; writes no
//            state (the scan's loop already holds the one state it keeps).
// models/ssm.py::_ssm_inner runs states, the chunk loop and outputs for every
// Mamba2 block of a prefill whose activations are on the card: 162 launches
// per zamba2-7b prefill.
//
// Layout (the model's own, nothing expanded or transposed): q = C and k = B
// as (G, NC, L, Dk), one row per batch row (zamba2 has one B/C group), read
// once per block; v and y as (G, NC, L, Hg, Dv), ld as (G, NC, L, Hg), at
// their strides (models/ssm.py holds them as (B, S, H, P) and (B, S, H));
// h_in and the state contiguous (G, Hg, NC, Dk, Dv) float32. Hg = 1 with
// contiguous strides is the TPU kernel's (BH, NC, L, D) layout. Dk = N and
// Dv = P are 64 at the published widths (the bf16 body below); any sizes up
// to 64 take the CUDA-core body.
//
// Bound on this card at the static prefill's shape (G = 8, NC = 8, L = 256,
// Hg = 112, bf16; chip_smoke.py::ssd_bound reckons it from each run's
// shapes): bytes. States: B read once per group, v, ld read and the state
// written once, 0.36 GB, 0.107 ms at 3.35 TB/s. Outputs: C and B, v, ld and
// h_in read, y written, 0.60 GB, 0.178 ms. The products are 15 GFLOP (states)
// and 91 GFLOP (outputs) at the 989 TFLOP/s bf16 tensor-core rate, with each
// float32 product counted as three bf16 products: under 0.1 ms.
//
// bf16 design (Dk = Dv = 64): one block per (group, chunk, a run of ~14 heads), a producer
// warpgroup and two consumer warpgroups.
//   - TMA loads through tensor maps (4-D for q, k: 64, L, NC, G; 5-D for v
//     and y: 64, Hg, L, NC, G; built on the host from the strides), 128-byte
//     swizzled: q and k once per block, v once per head into a ring of stages
//     (full / empty mbarriers), so the next heads' v arrive under this head's
//     products. A box is L rounded up to 64 rows of the chunk's own
//     dimension, so the rows past L are zero-filled, not the next chunk's.
//   - One producer warp per stage writes each of its heads' decay tables
//     (kTabFloats) into the stage, ahead of the consumers.
//   - The float32 products run on the tensor cores at float32 accuracy, no
//     TF32: one operand is exact in bf16 (q in q h_in, v in the state), the
//     other (h_in, dte * k) is split into three bf16 terms whose sum is the
//     float32 value exactly, and the three bf16 products accumulate in f32.
//   - Outputs: each head's h_in is split into three bf16 (64 x 64) tiles in
//     shared memory; warpgroup 0 owns the 64-row slabs 0 and 3 of y,
//     warpgroup 1 slabs 1 and 2 (equal causal work). A slab starts from
//     q h_in (three wgmma of q from shared memory against the h_in terms,
//     read MN-major), scaled by exp(cum) per row; then for each key tile up
//     to the diagonal, S = q k^T (wgmma), the head's decay applied in
//     registers (below the diagonal a product of two table entries, no
//     exponent), rounded to bf16 and fed back as the A operand of P v
//     (wgmma, v read MN-major through the descriptor's transpose bit); the
//     next tile's S and this tile's P v go out together, and the next decay
//     runs under P v. The slab leaves through shared memory and one TMA
//     store (per-thread stores into the (B, S, H, P) layout cost more than
//     the products).
//   - States: the state's rows are the 64 components of k; warpgroup 0 sums
//     the first half of the chunk's rows, warpgroup 1 the second, each k-step
//     (dte * k)^T loaded as transposed A fragments (ldmatrix.trans), scaled by
//     dte in registers and split into three bf16 A operands against v, the
//     next k-step split under this one's products; the halves meet through
//     shared memory.
//   q k^T is computed once per head, not once per group: sharing it across
//   the heads would hold every head's accumulator or every key tile's scores
//   in registers at once (PERF.md).
// CUDA-core design, for float32, and for bf16 at other sizes than Dk = Dv =
// 64 (the Pallas kernel takes any Dk and Dv; the reduced configs' SSD is N =
// 16, P = 32 in float32): one 8-warp block per (group, chunk, head), all
// products in float32 FMAs on the CUDA cores, per 64-row tile, with P through
// shared memory, rounded to the input type as above; Dk, Dv <= 64, the same
// three modes and layout (with Dk and Dv for 64).
#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;          // Dk = Dv of the bf16 body; the most of either elsewhere
constexpr int kMaxL = 256;      // chunk length
constexpr int kMaxHeads = 16;   // heads of one group per block (bf16 body)
constexpr int kMaxDevices = 64;
constexpr int kFull = 0;        // modes
constexpr int kStates = 1;
constexpr int kOutputs = 2;

// Where a launch reads and writes: element strides of (g, c, l) for q and k,
// of (g, c, l, h) for v, y and ld, the last dimension (Dk or Dv) contiguous.
struct Layout {
  long long q[3], k[3], v[4], y[4], ld[4];
  int groups, heads, n_chunks, len;  // G, Hg, NC, L
  int dk, dv;                        // q and k's last dimension, v and y's
  int heads_per_block, box_rows;     // bf16 body: heads a block runs, TMA box rows
};

struct Work {
  int g, c, h0, n;  // group, chunk, first head, heads
};

__device__ __forceinline__ Work block_work(const Layout& lay) {
  const int n_hb = (lay.heads + lay.heads_per_block - 1) / lay.heads_per_block;
  const int b = static_cast<int>(blockIdx.x);
  const int gc = b / n_hb;
  Work w;
  w.c = gc % lay.n_chunks;
  w.g = gc / lay.n_chunks;
  w.h0 = (b % n_hb) * lay.heads_per_block;
  w.n = min(lay.heads_per_block, lay.heads - w.h0);
  return w;
}

__device__ __forceinline__ long long state_offset(const Layout& lay, int g, int h, int c) {
  return ((static_cast<long long>(g) * lay.heads + h) * lay.n_chunks + c) * lay.dk * lay.dv;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x) { return static_cast<T>(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T's precision (the TPU kernel's scores.astype(v.dtype)).
template <typename T>
__device__ __forceinline__ float round_as(float x) { return to_float(from_float<T>(x)); }

// One warp: cum[p] = ld[0] + ... + ld[p] for p < 256 (ld read as 0 past L).
// Each lane sums 8 consecutive positions, then the lanes' totals are scanned
// with shuffles.
template <typename T>
__device__ void warp_cumsum(const T* __restrict__ ld, long long stride, int L, float* cum) {
  const int lane = threadIdx.x % 32;
  float vals[8];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = lane * 8 + i;
    run += p < L ? to_float(ld[p * stride]) : 0.f;
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
  for (int i = 0; i < 8; ++i) cum[lane * 8 + i] = vals[i] + excl;
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one producer warpgroup and two consumer warpgroups.
// ---------------------------------------------------------------------------

constexpr int kWg = 128;              // threads per warpgroup
constexpr int kTmaThreads = 3 * kWg;
constexpr int kTile = kMaxL * 128;    // 256 rows of 64 bf16: a q, k or v tile
constexpr int kSplit = 3 * kD * 128;  // h_in as three bf16 (64 x 64) terms
constexpr int kRed = kD * kD * 4;     // a float32 (64 x 64) partial state
constexpr int kYSlab = 64 * 128;      // a 64-row slab of y on its way out
constexpr int kBarSplit = 1;          // named barriers: both consumer warpgroups,
constexpr int kBarRed = 2;
constexpr int kBarY = 3;              // and one per consumer warpgroup (3, 4)

// Each head's decay tables (floats), written by a producer warp into the
// head's ring stage: cum; dte = exp(cum_{L-1} - cum); ecum = exp(cum); and
// for the key tiles below a slab's diagonal the decay split through the
// slab's first row r0 = 64 s: rf[i] = exp(cum_i - cum_r0) for the rows,
// kf_s[j] = exp(cum_r0 - cum_j) for the keys j < r0 (both at most 1, so
// neither overflows, and neither underflows where their product does not).
constexpr int kTabCum = 0;
constexpr int kTabDte = kMaxL;
constexpr int kTabEcum = 2 * kMaxL;
constexpr int kTabRf = 3 * kMaxL;
constexpr int kTabKf = 4 * kMaxL;           // kf_s at kTabKf + 32 s (s - 1), s = 1, 2, 3
constexpr int kTabFloats = kTabKf + 384;

// One warp: a head's decay tables (see kTabFloats) from its log-decays.
__device__ void head_tables(const __nv_bfloat16* __restrict__ ld, long long stride, int L,
                            float* tab) {
  const int lane = threadIdx.x % 32;
  float* cum = tab + kTabCum;
  warp_cumsum(ld, stride, L, cum);
  __syncwarp();
  const float cl = cum[L - 1];
  for (int p = lane; p < kMaxL; p += 32) {
    tab[kTabDte + p] = expf(cl - cum[p]);
    tab[kTabEcum + p] = expf(cum[p]);
    tab[kTabRf + p] = expf(cum[p] - cum[p & ~63]);
  }
  for (int s = 1; s < kMaxL / 64; ++s) {
    for (int j = lane; j < 64 * s; j += 32) tab[kTabKf + 32 * s * (s - 1) + j] = expf(cum[64 * s] - cum[j]);
  }
}

// Shared memory, in bytes from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): k, q (outputs), the v ring, two
// buffers of split h_in (outputs), two partial states (states), the decay
// tables of each stage's head, two y slabs per consumer warpgroup (outputs),
// then the barriers.
template <int MODE>
struct TmaSmem {
  static constexpr bool kY = MODE != kStates;
  static constexpr bool kS = MODE != kOutputs;
  static constexpr int kStages = MODE == kFull ? 1 : (MODE == kStates ? 3 : 2);
  static constexpr int kK = 0;
  static constexpr int kQ = kK + kTile;
  static constexpr int kV = kQ + (kY ? kTile : 0);
  static constexpr int kH = kV + kStages * kTile;
  static constexpr int kRedOff = kH + (kY ? 2 * kSplit : 0);
  static constexpr int kTab = kRedOff + (kS ? 2 * kRed : 0);
  static constexpr int kYst = (kTab + kStages * kTabFloats * 4 + 1023) / 1024 * 1024;
  static constexpr int kBar = kYst + (kY ? 4 * kYSlab : 0);  // qk_full, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// D (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory) B (16 x 64 in
// shared memory: K-major, or MN-major with TRANS_B); scale_d = 0 ignores D.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// Four 8 x 8 bf16 matrices, transposed: lanes 8m..8m+7 give the row
// addresses of matrix m, whose transpose lands in r[m] as an A fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + mid + lo exactly, each term a pair of bf16: the
// remainders are exact in float32 and the last has at most 8 significant bits.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h);
  const float r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m)));
}

// f(integral_constant<int, I>) for I = B ... E - 1, unrolled at compile time.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <int MODE>
__global__ void __launch_bounds__(kTmaThreads, 1)
ssd_chunk_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_y,
                     const __nv_bfloat16* __restrict__ ld, const float* __restrict__ h_in,
                     float* __restrict__ state, const Layout lay) {
  using S = TmaSmem<MODE>;
  extern __shared__ uint8_t smem_ssd[];
  const uint32_t raw = smem_addr(smem_ssd);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_ssd + (base - raw);  // the same bytes, generic address
  float* tab_all = reinterpret_cast<float*>(sm + S::kTab);
  const uint32_t qk_full = base + S::kBar;
  const uint32_t full_bar = qk_full + 8;                 // [kStages]
  const uint32_t empty_bar = full_bar + 8 * S::kStages;  // [kStages]
  const Work w = block_work(lay);
  const int L = lay.len;
  const uint32_t tile_bytes = static_cast<uint32_t>(lay.box_rows) * 128u;

  if (threadIdx.x == 0) {
    mbar_init(qk_full, 1);
    for (int st = 0; st < S::kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1 + 32);    // the v load and a table warp's lanes
      mbar_init(empty_bar + 8 * st, 2 * kWg);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 0) {
    // Producer: thread 0 loads k (and q) once and each head's v into the
    // ring; warp 1 + s writes the decay tables of the heads of stage s, in
    // order (a parity wait may run at most one phase ahead of its barrier).
    // No setmaxnreg: the kernel is compiled for 168 registers a thread, which
    // the consumers' code fits, and the table code needs more than a
    // producer's share.
    const int pw = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      mbar_expect_tx(qk_full, (S::kY ? 2 : 1) * tile_bytes);
      tma_load(base + S::kK, &tm_k, qk_full, 0, 0, w.c, w.g);
      if (S::kY) tma_load(base + S::kQ, &tm_q, qk_full, 0, 0, w.c, w.g);
      for (int i = 0; i < w.n; ++i) {
        const int st = i % S::kStages;
        mbar_wait(empty_bar + 8 * st, ((i / S::kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * st, tile_bytes);
        tma_load(base + S::kV + st * kTile, &tm_v, full_bar + 8 * st, 0, w.h0 + i, 0, w.c,
                 w.g);
      }
    } else if (pw > 0 && pw <= S::kStages) {
      const __nv_bfloat16* ldb = ld + w.g * lay.ld[0] + w.c * lay.ld[1];
      for (int i = pw - 1; i < w.n; i += S::kStages) {
        const int st = i % S::kStages;
        mbar_wait(empty_bar + 8 * st, ((i / S::kStages) & 1) ^ 1);
        head_tables(ldb + (w.h0 + i) * lay.ld[3], lay.ld[2], L, tab_all + st * kTabFloats);
        mbar_arrive(full_bar + 8 * st);  // each lane, after its own writes
      }
    }
    return;
  }
  const int wc = wg - 1;                 // consumer warpgroup 0 or 1
  const int tid = threadIdx.x - wg * kWg;
  const int ctid = threadIdx.x - kWg;    // 0 ... 255 over both consumers
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;  // accumulator row (and row + 8) within the warp's 16
  const int t = lane % 4;   // thread in the row's quad: columns 2t, 2t + 1 of each 8
  const uint32_t k_s = base + S::kK;

  // This thread's 16 values of a head's h_in: row ctid / 4, columns
  // 16 (ctid % 4) ... + 15.
  float4 hreg[4];
  auto load_h = [&](int i) {
    const float4* src = reinterpret_cast<const float4*>(
        h_in + state_offset(lay, w.g, w.h0 + i, w.c)) + 4 * ctid;
#pragma unroll
    for (int e = 0; e < 4; ++e) hreg[e] = src[e];
  };
  if (S::kY) load_h(0);
  [[maybe_unused]] int y_stores = 0;  // TMA stores of y this warpgroup has started
  mbar_wait(qk_full, 0);

  for (int i = 0; i < w.n; ++i) {
    const int h = w.h0 + i;
    const int st = i % S::kStages;
    const float* tab = tab_all + st * kTabFloats;  // this head's decay tables
    const float* cum = tab + kTabCum;
    const uint32_t v_s = base + S::kV + st * kTile;
    const long long hoff = state_offset(lay, w.g, h, w.c);

    if constexpr (S::kY) {
      // h_in as three bf16 (64 x 64) tiles, MN-major for the B operand of
      // q h_in: row d is 128 bytes, its 16-byte chunk j stored at j ^ (d % 8).
      const int d = ctid / 4;
      const float* hv = reinterpret_cast<const float*>(hreg);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          split3(hv[8 * half + 2 * p], hv[8 * half + 2 * p + 1], hi[p], mid[p], lo[p]);
        }
        const int chunk = 2 * (ctid % 4) + half;
        uint8_t* dst = sm + S::kH + (i & 1) * kSplit + d * 128 + ((chunk ^ (d & 7)) << 4);
        *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(dst + kD * 128) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
        *reinterpret_cast<uint4*>(dst + 2 * kD * 128) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma
      bar_sync(kBarSplit, 2 * kWg);
      if (i + 1 < w.n) load_h(i + 1);  // in flight under this head's products
    }

    mbar_wait(full_bar + 8 * st, (i / S::kStages) & 1);

    if constexpr (S::kS) {
      // state = sum_l (dte_l k_l) v_l^T: rows d (the warpgroup's 64), columns
      // c; this warpgroup's half of the 16-row k-steps.
      const int n_ks = (L + 15) / 16;
      const int half = (n_ks + 1) / 2;
      const int ks0 = wc == 0 ? 0 : half;
      const int ks1 = wc == 0 ? half : n_ks;
      const float cl = cum[L - 1];
      float acc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[r] = 0.f;
      // A = (dte k)^T of k-step ks as three bf16 terms: matrix m of the x4
      // load is k rows 16 ks + 8 (m / 2) ... + 7, components 16 warp +
      // 8 (m % 2) ... + 7, so kr[e] holds components 16 warp + gq (+ 8 for
      // e odd) of rows la, la + 1 with la = 16 ks + 2t (+ 8 for e >= 2).
      auto split_k = [&](int ks, uint32_t (&a)[3][4]) {
        const int l0 = ks * 16;
        const int m = lane / 8;
        const int row = l0 + lane % 8 + 8 * (m / 2);
        const int chunk = 2 * warp + m % 2;
        uint32_t kr[4];
        ldmatrix_x4_trans(kr, k_s + row * 128 + ((chunk ^ (row & 7)) << 4));
        float dte[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) dte[e] = tab[kTabDte + l0 + 2 * t + 8 * (e / 2) + e % 2];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = 2 * (e / 2);
          split3(bf16_lo(kr[e]) * dte[l], bf16_hi(kr[e]) * dte[l + 1], a[0][e], a[1][e], a[2][e]);
        }
      };
      // One k-step's three products against v, the next k-step split while
      // they run (the fragments alternate between two register sets).
      auto step = [&](int ks, uint32_t (&cur)[3][4], uint32_t (&nxt)[3][4]) {
        const uint64_t desc_v = sw128_desc(v_s + ks * 16 * 128, kTile, 1024);
        fence_regs(acc);
        fence_regs(cur);
        wgmma_fence();
        wgmma_rs_n64(acc, cur[0], desc_v);
        wgmma_rs_n64(acc, cur[1], desc_v);
        wgmma_rs_n64(acc, cur[2], desc_v);
        wgmma_commit();
        if (ks + 1 < ks1) split_k(ks + 1, nxt);
        wgmma_wait<0>();
        fence_regs(acc);
      };
      uint32_t fa[3][4], fb[3][4];
      if (ks0 < ks1) split_k(ks0, fa);
      int ks = ks0;
      for (; ks + 1 < ks1; ks += 2) {
        step(ks, fa, fb);
        step(ks + 1, fb, fa);
      }
      if (ks < ks1) step(ks, fa, fb);
      // The halves meet: warpgroup 1 hands its partial sums to warpgroup 0
      // through shared memory (two buffers: head i + 2 waits for this one's
      // reader at head i + 1's barrier).
      float* red = reinterpret_cast<float*>(sm + S::kRedOff) + (i & 1) * kD * kD;
      if (wc == 1) {
#pragma unroll
        for (int r = 0; r < 32; ++r) red[r * kWg + tid] = acc[r];
      }
      bar_sync(kBarRed, 2 * kWg);
      if (wc == 0) {
        const float et = expf(cl);
        const int d_a = 16 * warp + gq;
        float* sb = state + hoff;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t;
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = acc[4 * j + e] + red[(4 * j + e) * kWg + tid];
          if (MODE == kFull) {  // + exp(cum_L) h_in
            const float2 ha = *reinterpret_cast<const float2*>(h_in + hoff + d_a * kD + col);
            const float2 hb = *reinterpret_cast<const float2*>(h_in + hoff + (d_a + 8) * kD + col);
            o[0] += et * ha.x;
            o[1] += et * ha.y;
            o[2] += et * hb.x;
            o[3] += et * hb.y;
          }
          *reinterpret_cast<float2*>(sb + d_a * kD + col) = make_float2(o[0], o[1]);
          *reinterpret_cast<float2*>(sb + (d_a + 8) * kD + col) = make_float2(o[2], o[3]);
        }
      }
    }

    if constexpr (S::kY) {
      const uint32_t hs = base + S::kH + (i & 1) * kSplit;
      // One 64-row slab of y with NT = slab + 1 key tiles, unrolled: S of
      // key tile kt + 1 and P v of tile kt go out together, and tile kt + 1's
      // decay runs while P v is on the tensor cores (P alternates between
      // two register sets; S has one, read before the next S is issued).
      auto slab_y = [&](auto nt) {
        constexpr int NT = decltype(nt)::value;
        constexpr int slab = NT - 1;
        const uint32_t q_s = base + S::kQ + slab * 64 * 128;
        const int row_a = slab * 64 + 16 * warp + gq;
        const int row_b = row_a + 8;
        const float cum_a = cum[row_a];
        const float cum_b = cum[row_b];
        float acc[32];
        float sc[32];
        uint32_t pa[2][4][4];
        auto issue_s = [&](int kt) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss_n64<0>(sc, sw128_desc(q_s + kk * 32, 16, 1024),
                            sw128_desc(k_s + kt * 64 * 128 + kk * 32, 16, 1024), kk > 0);
          }
          wgmma_commit();
        };
        // sc[4j + e]: key 64 kt + 8j + 2t + (e & 1), row a (e < 2) or b. P
        // rounded to bf16 as the A fragments of P v: k16 step kk takes key
        // chunks 2kk (a0 row a, a1 row b) and 2kk + 1 (a2 row a, a3 row b).
        // Below the diagonal the decay is rf[row] kf_s[key]; on the diagonal
        // it is selected and exponentiated per element, and the key chunks
        // past the warp's last row are zero.
        const float rf_a = tab[kTabRf + row_a];
        const float rf_b = tab[kTabRf + row_b];
        auto decay = [&](auto kt_c, uint32_t (&p4)[4][4]) {
          constexpr int kt = decltype(kt_c)::value;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = kt * 64 + 8 * j + 2 * t;
            float p[4];
            if constexpr (kt < slab) {
              const float2 kf =
                  *reinterpret_cast<const float2*>(tab + kTabKf + 32 * slab * (slab - 1) + key);
              p[0] = sc[4 * j + 0] * (rf_a * kf.x);
              p[1] = sc[4 * j + 1] * (rf_a * kf.y);
              p[2] = sc[4 * j + 2] * (rf_b * kf.x);
              p[3] = sc[4 * j + 3] * (rf_b * kf.y);
            } else if (8 * j <= 16 * warp + 15) {
              const float2 ck = *reinterpret_cast<const float2*>(cum + key);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int kx = key + (e & 1);
                const int rx = e < 2 ? row_a : row_b;
                const float dx = (e < 2 ? cum_a : cum_b) - ((e & 1) ? ck.y : ck.x);
                p[e] = kx <= rx ? sc[4 * j + e] * __expf(dx) : 0.f;
              }
            } else {
              p[0] = p[1] = p[2] = p[3] = 0.f;
            }
            p4[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
            p4[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
          }
        };

        // S of key tile 0, then acc = q h_in (h_in as three bf16 terms),
        // tile 0's decay under the latter; each row of acc times exp(cum).
        fence_regs(sc);
        fence_regs(acc);
        wgmma_fence();
        issue_s(0);
#pragma unroll
        for (int term = 0; term < 3; ++term) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss_n64<1>(acc, sw128_desc(q_s + kk * 32, 16, 1024),
                            sw128_desc(hs + term * kD * 128 + kk * 16 * 128, kD * 128, 1024),
                            term > 0 || kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        decay(std::integral_constant<int, 0>{}, pa[0]);
        wgmma_wait<0>();
        fence_regs(acc);
        const float ea = tab[kTabEcum + row_a];
        const float eb = tab[kTabEcum + row_b];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j + 0] *= ea;
          acc[4 * j + 1] *= ea;
          acc[4 * j + 2] *= eb;
          acc[4 * j + 3] *= eb;
        }

        static_for<0, NT>([&](auto kt_c) {
          constexpr int kt = decltype(kt_c)::value;
          fence_regs(acc);
          fence_regs(sc);
          fence_regs(pa[kt % 2]);
          wgmma_fence();
          if constexpr (kt + 1 < NT) issue_s(kt + 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs_n64(acc, pa[kt % 2][kk],
                         sw128_desc(v_s + (kt * 64 + kk * 16) * 128, kTile, 1024));
          }
          wgmma_commit();
          if constexpr (kt + 1 < NT) {
            wgmma_wait<1>();
            fence_regs(sc);
            decay(std::integral_constant<int, kt + 1>{}, pa[(kt + 1) % 2]);
          }
        });
        wgmma_wait<0>();
        fence_regs(acc);

        // y leaves through shared memory and one TMA store (the map clips
        // rows past L): the warpgroup's stores alternate its two buffers, so
        // this one is free once the store before the last has read it. (By
        // the warpgroup's own count of stores, not by slab: a warpgroup that
        // owns one slab of a short chunk stores it once for every head.)
        const int buf = 2 * wc + (y_stores++ & 1);
        const uint32_t ys = base + S::kYst + buf * kYSlab;
        uint8_t* yg = sm + S::kYst + buf * kYSlab;
        if (tid == 0) bulk_wait_read<1>();
        bar_sync(kBarY + wc, kWg);
        const int ra = 16 * warp + gq;
        const int rb = ra + 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(yg + ra * 128 + ((j ^ (ra & 7)) << 4) + 4 * t) =
              pack_bf16(acc[4 * j + 0], acc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(yg + rb * 128 + ((j ^ (rb & 7)) << 4) + 4 * t) =
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the TMA store
        bar_sync(kBarY + wc, kWg);
        if (tid == 0) {
          tma_store(ys, &tm_y, 0, h, slab * 64, w.c, w.g);
          bulk_commit();
        }
      };
      // Warpgroup 0 owns slabs 0 and 3, warpgroup 1 slabs 1 and 2: equal
      // causal work.
      const int n_slabs = (L + 63) / 64;
      if (wc == 0) {
        slab_y(std::integral_constant<int, 1>{});
        if (n_slabs > 3) slab_y(std::integral_constant<int, 4>{});
      } else {
        if (n_slabs > 1) slab_y(std::integral_constant<int, 2>{});
        if (n_slabs > 2) slab_y(std::integral_constant<int, 3>{});
      }
    }

    mbar_arrive(empty_bar + 8 * st);  // this head's v tile is no longer read
  }
  if (S::kY && tid == 0) bulk_wait_all();  // shared memory outlives the y stores
}

// ---------------------------------------------------------------------------
// The CUDA cores throughout (float32, or bf16 off Dk = Dv = 64), one block per
// (group, chunk, head), per 64-row tile. 256 threads as 16 x 16 (ty, tx), each
// with rows ty + 16i and keys (or columns) tx + 16j, i, j < 4. Shared memory,
// float32: cum, dte (256 each), h_in (64 x 64, zero past Dk x Dv), then k and
// v (Lp rows of kLdf words, zero past Dk or Dv), one q tile and one P tile (64
// rows of kLdf words each).
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 8 warps
constexpr int kLdf = kD + 1;   // f32 row stride in shared memory (words)
constexpr int kTileF = 64;     // rows per tile, keys per tile

size_t simt_smem_bytes(int lp) {
  return sizeof(float) * (2 * kMaxL + kD * kD + 2 * lp * kLdf + 2 * kTileF * kLdf);
}

// state = sum_l dte_l k_l^T v_l (+ exp(cum_{L-1}) h_in with the h_in term),
// each thread a 4 x 4 tile: state rows 4 * (tid / 16) + i, columns
// 4 * (tid % 16) + j, those below (Dk, Dv) written to the (Dk, Dv) state.
__device__ void chunk_state_simt(const float* k_s, const float* v_s, const float* h_s,
                                 const float* cum_s, const float* dte_s, int L, int dk, int dv,
                                 bool with_h, float* __restrict__ out) {
  const int d0 = 4 * (threadIdx.x / 16);
  const int c0 = 4 * (threadIdx.x % 16);
  if (d0 >= dk || c0 >= dv) return;
  float acc[4][4] = {};
  for (int l = 0; l < L; ++l) {
    const float w = dte_s[l];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float kd = k_s[l * kLdf + d0 + i] * w;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kd, v_s[l * kLdf + c0 + j], acc[i][j]);
    }
  }
  const float et = with_h ? expf(cum_s[L - 1]) : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (d0 + i >= dk || c0 + j >= dv) continue;
      const float hv = with_h ? h_s[(d0 + i) * kD + c0 + j] : 0.f;
      out[(d0 + i) * dv + c0 + j] = acc[i][j] + et * hv;
    }
  }
}

template <int MODE, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ ld,
                      const float* __restrict__ h_in, T* __restrict__ y,
                      float* __restrict__ state, const Layout lay) {
  extern __shared__ uint4 smem_simt[];
  const int L = lay.len;
  const int dk = lay.dk;
  const int dv = lay.dv;
  const int lp = (L + kTileF - 1) / kTileF * kTileF;
  float* cum_s = reinterpret_cast<float*>(smem_simt);
  float* dte_s = cum_s + kMaxL;
  float* h_s = dte_s + kMaxL;
  float* k_s = h_s + kD * kD;
  float* v_s = k_s + lp * kLdf;
  float* q_t = v_s + lp * kLdf;
  float* p_t = q_t + kTileF * kLdf;

  const Work w = block_work(lay);  // heads_per_block is 1
  const int h = w.h0;
  const long long hoff = state_offset(lay, w.g, h, w.c);
  const T* kb = k + w.g * lay.k[0] + w.c * lay.k[1];
  const T* vb = v + w.g * lay.v[0] + w.c * lay.v[1] + h * lay.v[3];
  for (int e = threadIdx.x; e < lp * kD; e += kThreads) {
    const int r = e / kD;
    const int c = e % kD;
    const bool ok = r < L;
    k_s[r * kLdf + c] = ok && c < dk ? to_float(kb[r * lay.k[2] + c]) : 0.f;
    v_s[r * kLdf + c] = ok && c < dv ? to_float(vb[r * lay.v[2] + c]) : 0.f;
  }
  if (MODE != kStates) {
    for (int e = threadIdx.x; e < kD * kD; e += kThreads) {
      const int r = e / kD;
      const int c = e % kD;
      h_s[e] = r < dk && c < dv ? h_in[hoff + r * dv + c] : 0.f;
    }
  }
  if (threadIdx.x < 32) {
    warp_cumsum(ld + w.g * lay.ld[0] + w.c * lay.ld[1] + h * lay.ld[3], lay.ld[2], L, cum_s);
  }
  __syncthreads();
  const float last = cum_s[L - 1];
  for (int p = threadIdx.x; p < kMaxL; p += kThreads) dte_s[p] = expf(last - cum_s[p]);
  __syncthreads();

  if (MODE != kStates) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const T* qb = q + w.g * lay.q[0] + w.c * lay.q[1];
    T* yb = y + w.g * lay.y[0] + w.c * lay.y[1] + h * lay.y[3];
    for (int r0 = 0; r0 < L; r0 += kTileF) {
      __syncthreads();  // the previous tile's readers of q_t are done
      for (int e = threadIdx.x; e < kTileF * kD; e += kThreads) {
        const int r = e / kD;
        const int c = e % kD;
        q_t[r * kLdf + c] = r0 + r < L && c < dk ? to_float(qb[(r0 + r) * lay.q[2] + c]) : 0.f;
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
      for (int d = 0; d < dk; ++d) {
        float a[4];
        float hh[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q_t[(ty + 16 * i) * kLdf + d] * er[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) hh[j] = h_s[d * kD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], hh[j], acc[i][j]);
      }

      for (int k0 = 0; k0 <= r0; k0 += kTileF) {
        float sc[4][4] = {};
#pragma unroll 4
        for (int d = 0; d < dk; ++d) {
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
            const float pk = key <= row ? sc[i][j] * expf(cr[i] - cum_s[key]) : 0.f;
            p_t[(ty + 16 * i) * kLdf + tx + 16 * j] = round_as<T>(pk);
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kTileF; ++kk) {
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
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          if (col < dv) yb[row * lay.y[2] + col] = from_float<T>(acc[i][j]);
        }
      }
    }
  }

  if (MODE != kOutputs) {
    chunk_state_simt(k_s, v_s, h_s, cum_s, dte_s, L, dk, dv, MODE == kFull, state + hoff);
  }
}

// The opt-in above 48 KB is a property of the kernel on this device: set it
// once per device, to the largest size the kernel is launched with.
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, bool* done, int device) {
  if (!done[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    done[device] = true;
  }
  return 0;
}

int sm_count(int device) {
  static int count[kMaxDevices] = {};
  if (count[device] == 0) {
    cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device);
  }
  return count[device] > 0 ? count[device] : 1;
}

template <int MODE>
int launch_tma(const void* q, const void* k, const void* v, const void* ld, const void* h_in,
               void* y, void* state, Layout lay, int device, cudaStream_t stream) {
  using S = TmaSmem<MODE>;
  static bool done[kMaxDevices] = {};
  int err = set_smem(ssd_chunk_tma_kernel<MODE>, S::kBytes, done, device);
  if (err) return err;
  // Heads per block: about four waves of blocks over the SMs, at most
  // kMaxHeads, the same count in every block of a group where it divides.
  const long long items = static_cast<long long>(lay.groups) * lay.n_chunks * lay.heads;
  const long long want = (items + 4LL * sm_count(device) - 1) / (4LL * sm_count(device));
  int hb = static_cast<int>(std::min<long long>(std::max<long long>(want, 1),
                                                std::min(lay.heads, kMaxHeads)));
  const int n_hb = (lay.heads + hb - 1) / hb;
  lay.heads_per_block = (lay.heads + n_hb - 1) / n_hb;
  lay.box_rows = (lay.len + 63) / 64 * 64;
  const long long blocks = static_cast<long long>(lay.groups) * lay.n_chunks * n_hb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  const cuuint32_t box_qk[4] = {kD, static_cast<cuuint32_t>(lay.box_rows), 1, 1};
  const cuuint32_t box_v[5] = {kD, 1, static_cast<cuuint32_t>(lay.box_rows), 1, 1};
  auto qk_map = [&](CUtensorMap* out, const void* ptr, const long long* st) {
    const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(lay.len),
                                static_cast<cuuint64_t>(lay.n_chunks),
                                static_cast<cuuint64_t>(lay.groups)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                   static_cast<cuuint64_t>(st[1]) * 2,
                                   static_cast<cuuint64_t>(st[0]) * 2};
    return encode_bf16_map(out, ptr, 4, dims, strides, box_qk);
  };
  // v and y: (64, Hg, L, NC, G); v in boxes of the chunk's rows, y in 64-row slabs.
  const cuuint32_t box_y[5] = {kD, 1, 64, 1, 1};
  auto vy_map = [&](CUtensorMap* out, const void* ptr, const long long* st,
                    const cuuint32_t* box) {
    const cuuint64_t dims[5] = {kD, static_cast<cuuint64_t>(lay.heads),
                                static_cast<cuuint64_t>(lay.len),
                                static_cast<cuuint64_t>(lay.n_chunks),
                                static_cast<cuuint64_t>(lay.groups)};
    const cuuint64_t strides[4] = {
        static_cast<cuuint64_t>(st[3]) * 2, static_cast<cuuint64_t>(st[2]) * 2,
        static_cast<cuuint64_t>(st[1]) * 2, static_cast<cuuint64_t>(st[0]) * 2};
    return encode_bf16_map(out, ptr, 5, dims, strides, box);
  };
  CUtensorMap tq = {}, tk = {}, tv = {}, ty = {};
  err = qk_map(&tk, k, lay.k);
  if (err == 0) err = vy_map(&tv, v, lay.v, box_v);
  if (err == 0 && MODE != kStates) err = qk_map(&tq, q, lay.q);
  if (err == 0 && MODE != kStates) err = vy_map(&ty, y, lay.y, box_y);
  if (err) return err;
  ssd_chunk_tma_kernel<MODE><<<static_cast<unsigned>(blocks), kTmaThreads, S::kBytes, stream>>>(
      tq, tk, tv, ty, static_cast<const __nv_bfloat16*>(ld), static_cast<const float*>(h_in),
      static_cast<float*>(state), lay);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename T>
int launch_simt(const void* q, const void* k, const void* v, const void* ld, const void* h_in,
                void* y, void* state, Layout lay, int device, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  int err = set_smem(ssd_chunk_simt_kernel<MODE, T>, simt_smem_bytes(kMaxL), done, device);
  if (err) return err;
  lay.heads_per_block = 1;
  const long long blocks = static_cast<long long>(lay.groups) * lay.n_chunks * lay.heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int lp = (lay.len + kTileF - 1) / kTileF * kTileF;
  ssd_chunk_simt_kernel<MODE, T><<<static_cast<unsigned>(blocks), kThreads, simt_smem_bytes(lp),
                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ld), static_cast<const float*>(h_in), static_cast<T*>(y),
      static_cast<float*>(state), lay);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt_mode(int mode, const void* q, const void* k, const void* v, const void* ld,
                     const void* h_in, void* y, void* state, Layout lay, int device,
                     cudaStream_t st) {
  switch (mode) {
    case kFull: return launch_simt<kFull, T>(q, k, v, ld, h_in, y, state, lay, device, st);
    case kStates: return launch_simt<kStates, T>(q, k, v, ld, h_in, y, state, lay, device, st);
    default: return launch_simt<kOutputs, T>(q, k, v, ld, h_in, y, state, lay, device, st);
  }
}

}  // namespace

// dims: G, Hg, NC, L, Dk, Dv (1 <= L <= 256, 1 <= Dk, Dv <= 64). strides
// (elements, 18 values): q and k of (g, c, l), v, y and ld of (g, c, l, h); q,
// k: (G, NC, L, Dk), v, y: (G, NC, L, Hg, Dv), ld: (G, NC, L, Hg), one type,
// bf16 (is_bf16 = 1; at Dk = Dv = 64 the strides of q, k and v multiples of 8
// elements and their bases 16-byte aligned, for TMA) or f32; h_in, state:
// contiguous (G, Hg, NC, Dk, Dv) f32. mode: 0 full (reads q, h_in; writes y,
// state), 1 states (reads neither q nor h_in; writes state), 2 outputs (writes
// y). bf16 at Dk = Dv = 64 runs the TMA + wgmma body, everything else the
// CUDA-core body. Returns a cudaError_t.
extern "C" int repro_ssd_chunks(const void* q, const void* k, const void* v, const void* ld,
                                const void* h_in, void* y, void* state, const long long* dims,
                                const long long* strides, int mode, int is_bf16, int device,
                                void* stream) {
  const long long G = dims[0], Hg = dims[1], NC = dims[2], L = dims[3], Dk = dims[4],
                  Dv = dims[5];
  bool ok = G > 0 && Hg > 0 && NC > 0 && L > 0 && L <= kMaxL && Dk > 0 && Dk <= kD && Dv > 0 &&
            Dv <= kD && G < (1LL << 31) &&
            Hg < (1LL << 31) && NC < (1LL << 31) && mode >= kFull && mode <= kOutputs &&
            k != nullptr && v != nullptr && ld != nullptr;
  if (mode != kStates) ok = ok && q != nullptr && h_in != nullptr && y != nullptr;
  if (mode != kOutputs) ok = ok && state != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Layout lay{};
  for (int i = 0; i < 3; ++i) {
    lay.q[i] = strides[i];
    lay.k[i] = strides[3 + i];
  }
  for (int i = 0; i < 4; ++i) {
    lay.v[i] = strides[6 + i];
    lay.y[i] = strides[10 + i];
    lay.ld[i] = strides[14 + i];
  }
  lay.groups = static_cast<int>(G);
  lay.heads = static_cast<int>(Hg);
  lay.n_chunks = static_cast<int>(NC);
  lay.len = static_cast<int>(L);
  lay.dk = static_cast<int>(Dk);
  lay.dv = static_cast<int>(Dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && Dk == kD && Dv == kD) {
    switch (mode) {
      case kFull: return launch_tma<kFull>(q, k, v, ld, h_in, y, state, lay, device, st);
      case kStates: return launch_tma<kStates>(q, k, v, ld, h_in, y, state, lay, device, st);
      default: return launch_tma<kOutputs>(q, k, v, ld, h_in, y, state, lay, device, st);
    }
  }
  if (is_bf16) {
    return launch_simt_mode<__nv_bfloat16>(mode, q, k, v, ld, h_in, y, state, lay, device, st);
  }
  return launch_simt_mode<float>(mode, q, k, v, ld, h_in, y, state, lay, device, st);
}
