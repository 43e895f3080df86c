// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py (pallas_call at :100).
// Same function: GQA attention of q (b, s, nq, hd) over k/v (b, S, nkv, hd)
// with masking by position arrays (-1 = padding), causal by position,
// optional sliding window, causal=0 for cross-attention, fully masked
// query rows giving 0, f32 accumulation, output in q's dtype.
//
// What bounds it on the card: operations. Each valid (query, key) pair
// costs 4*hd flops per q head. At the serving path's prefill (s = S = 3072,
// 2960 valid, 32 q heads, hd 128) that is 71.8 GFLOP after the causal
// half, while q, k, v and the output are ~30 MB: over 2,000 flops a byte,
// far above the ~295 at which the H100's bf16 tensor cores, not its
// memory, are the limit. Bound: 71.8 GFLOP / 989 TFLOP/s = 0.073 ms.
//
// bf16 runs on the tensor cores (flash_tc_kernel):
// * Block shape: one block per (q head, batch, 128-query tile), 384
//   threads in three warpgroups. Warpgroup 0 is the producer: one warp of
//   it issues every load. Warpgroups 1 and 2 are consumers, each owning
//   64 query rows, the M of wgmma. Register budget: ptxas compiles every
//   thread of a 384-thread block within 168 registers (65,536 / 384), and
//   a setmaxnreg that moves registers from the producer to the consumers
//   at run time does not raise that limit for the consumers' code, so the
//   kernel has none. The tiles are sized for 168: BK = 64 keys a tile,
//   and a consumer thread at hd 128 holds the 64 x 64 f32 scores (32
//   registers), the probabilities as bf16 pairs (16) and the 64 x 128 f32
//   output (64); ptxas reports 160, 110 and 94 registers at hd 128, 64
//   and 32, no spills. (With BK = 128 the hd-128 kernel spilled 184 bytes
//   and ptxas serialised its wgmma.)
// * Loads (producer/consumer split): every tile moves by TMA, one thread
//   issuing it, completion counted in bytes on an mbarrier. The tensor
//   maps see q, k, v as 4-D (hd, heads, seq, batch) with boxes of one
//   head and one batch row, so a tile never crosses into the next batch
//   row and rows past s or S arrive as zeros (finite: a masked p is 0,
//   and 0 * NaN would not be). Q is loaded once; K and V of each 64-key
//   tile go through a ring of 4 stages (hd 128: 32 KB of Q plus 4 x 32
//   KB), with full barriers for K and for V and an empty barrier that
//   both consumers release after their P V product has read the stage.
//   Shared memory: 161 KB at hd 128, 81 KB at hd 64, 41 KB at hd 32.
// * Swizzle: a box spans 64 columns with the 128-byte swizzle (hd 128 is
//   two boxes side by side, hd 64 one) or 32 columns with the 64-byte
//   swizzle (hd 32). The wgmma descriptors name the same swizzle (see
//   sm90.cuh), so the tensor cores read shared memory without bank
//   conflicts and no thread rearranges a tile.
// * Products: S = Q Kᵀ is wgmma m64n64k16 with both operands in shared
//   memory (K is K-major for it). P, converted to bf16 pairs in
//   registers, is the A operand of O += P V (wgmma m64n{hd}k16, V as the
//   MN-major, transposed B operand): the accumulator layout of S is the A
//   fragment layout, so P never touches shared memory. Each consumer
//   issues the scores of tile j+1 and the P V of tile j together and runs
//   the softmax of tile j+1 while P V runs.
// * Softmax, in registers, exact masks: the producer stages each tile's
//   kv positions, its smallest and largest valid position and whether
//   all of its keys are valid. A warp whose rows all lie inside the
//   tile's causal (and window) band skips the mask; otherwise each score
//   is tested against its row's bounds, and a masked score becomes -inf
//   against a running max that starts at -1e30: the max is the
//   reference's (masked scores at -1e30) and p = exp(-inf) = 0 exactly
//   where masked, which is the reference's explicit re-masking (needed
//   there because exp(s - max) = 1 while every key so far is masked). A
//   row with l = 0 writes 0.
// * Log-sum-exp: where the caller passes an lse pointer (training: the
//   gradient kernel reads it, csrc/flash_attention_bwd.cu), the epilogue
//   also writes each row's m * scale + log(l), +inf for a row with l = 0;
//   serving passes null, so its launches write nothing more.
// * Tile skipping: the producer scans kv positions four tiles at a time
//   and loads only the tiles that hold a valid (query, key) pair for the
//   block: not all padding, not entirely above the block's last query
//   position (causal), not entirely at or below its first minus the
//   window. That skips the causal upper half, the padded tail of the
//   dense prefill and the -1 gaps of a gathered prefix; a tile of
//   queries that are all padding loads no K/V and writes zeros. The
//   element mask stays exact, so the skip test costs time, never
//   correctness. The last query tiles, the heaviest under the causal
//   mask, are scheduled first.
//
// f32 keeps the CUDA-core kernel below (flash_fwd_kernel): its callers
// (the CPU-vs-GPU parity of chip_smoke.py, the f32 kernel tests at 1e-4)
// need full f32 products, and the tensor cores' TF32 keeps about three
// decimal digits. Serving runs bf16, so every serving call takes the
// tensor-core kernel. The CUDA-core kernel: one block per (batch, q head,
// 64-query tile), a 16x16 thread grid, products as f32 FMAs, key tiles
// without a valid pair skipped before their loads; it writes the lse as the
// tensor-core kernel does.

#include "common.cuh"
#include "sm90.cuh"

#include <climits>
#include <cmath>

namespace {

using rt::Cvt;
using rt::NEG_INF;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using namespace sm90;

constexpr int BQ = 128;        // queries a block: two consumer warpgroups
constexpr int BK = 64;         // keys a tile
constexpr int STAGES = 4;
constexpr int NT = 384;
constexpr int SCAN = 4;        // kv tiles the producer scans at a time

template <int HD>
struct Cfg {
  static constexpr int PANEL = HD < 64 ? HD : 64;   // columns of a TMA box
  static constexpr int NPANEL = HD / PANEL;
  static constexpr int ROWB = PANEL * 2;            // bytes of a panel row
  static constexpr uint32_t SWIZZLE = ROWB == 128 ? 1 : 2;
  static constexpr int ATOM = 8 * ROWB;             // 8 rows of the swizzle
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_KPOS = OFF_V + STAGES * KV_BYTES;
  static constexpr int OFF_META = OFF_KPOS + STAGES * BK * 4;
  static constexpr int OFF_BAR = OFF_META + 16 * STAGES;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 3 * STAGES);
  static constexpr int SMEM = BYTES + 1024;          // room to align to 1 KB
};

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n32(o, a, db);
}

// The producer warp: Q once, then the K/V tiles that hold a valid pair.
template <int HD>
__device__ __forceinline__ void produce(
    const CUtensorMap& tmq, const CUtensorMap& tmk, const CUtensorMap& tmv,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    unsigned char* sQ, unsigned char* sK, unsigned char* sV, int* sKpos,
    int* sMeta, uint64_t* barQ, uint64_t* fullK, uint64_t* fullV,
    uint64_t* empty, int lane, int h, int bi, int kvh, int q0, int s, int S,
    int causal, int window) {
  using C = Cfg<HD>;
  if (lane == 0) {
    mbar_arrive_expect_tx(barQ, C::Q_BYTES);
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p)
      tma_load_4d(sQ + p * BQ * C::ROWB, &tmq, barQ, p * C::PANEL, h, q0, bi);
  }
  // the block's smallest and largest valid query position
  int qmin = INT_MAX, qmax = -1;
#pragma unroll
  for (int e = 0; e < BQ / 32; ++e) {
    const int row = q0 + 32 * e + lane;
    const int p = row < s ? qpos[(size_t)bi * s + row] : -1;
    if (p >= 0) {
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
  qmin = warp_min(qmin);
  qmax = warp_max(qmax);
  const int* kp_row = kpos + (size_t)bi * S;
  const int ntk = (S + BK - 1) / BK;
  int st = 0;
  uint32_t ph = 0;
  for (int t0 = 0; qmax >= 0 && t0 < ntk; t0 += SCAN) {
    int kmn[SCAN], kmx[SCAN];
    bool full[SCAN];
#pragma unroll
    for (int g = 0; g < SCAN; ++g) {
      kmn[g] = INT_MAX;
      kmx[g] = -1;
      full[g] = true;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int i = (t0 + g) * BK + 32 * e + lane;
        const int p = i < S ? kp_row[i] : -1;
        if (p >= 0) {
          kmn[g] = min(kmn[g], p);
          kmx[g] = max(kmx[g], p);
        } else {
          full[g] = false;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < SCAN; ++g) {
      kmn[g] = warp_min(kmn[g]);
      kmx[g] = warp_max(kmx[g]);
      full[g] = __all_sync(0xffffffffu, full[g]);
    }
#pragma unroll
    for (int g = 0; g < SCAN; ++g) {
      bool use = kmx[g] >= 0;
      if (causal)
        use = use && kmn[g] <= qmax && (window <= 0 || kmx[g] > qmin - window);
      if (!use) continue;
      const int k0 = (t0 + g) * BK;
      mbar_wait(&empty[st], ph ^ 1);
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int i = k0 + 32 * e + lane;
        sKpos[st * BK + 32 * e + lane] = i < S ? kp_row[i] : -1;
      }
      if (lane == 0) {
        sMeta[4 * st] = k0;
        sMeta[4 * st + 1] = kmn[g];
        sMeta[4 * st + 2] = kmx[g];
        sMeta[4 * st + 3] = full[g];
        mbar_arrive_expect_tx(&fullK[st], C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NPANEL; ++p)
          tma_load_4d(sK + st * C::KV_BYTES + p * BK * C::ROWB, &tmk,
                      &fullK[st], p * C::PANEL, kvh, k0, bi);
        mbar_arrive_expect_tx(&fullV[st], C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NPANEL; ++p)
          tma_load_4d(sV + st * C::KV_BYTES + p * BK * C::ROWB, &tmv,
                      &fullV[st], p * C::PANEL, kvh, k0, bi);
      } else {
        mbar_arrive(&fullK[st]);
      }
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
  }
  // end of the tile list: a stage that carries no tile
  mbar_wait(&empty[st], ph ^ 1);
  if (lane == 0) sMeta[4 * st] = -1;
  mbar_arrive(&fullK[st]);
}

// S = Q Kᵀ of one stage into sc, issued and committed, not waited for.
template <int HD>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t q_base,
                                         uint32_t k_base) {
  using C = Cfg<HD>;
  fence_regs<BK / 2>(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk * 16 / C::PANEL;             // 64-column panel
    const int col_b = (kk * 16 % C::PANEL) * 2;   // byte offset in its row
    const uint64_t da = make_desc(q_base + p * BQ * C::ROWB + col_b, 16,
                                  C::ATOM, C::SWIZZLE);
    const uint64_t db = make_desc(k_base + p * BK * C::ROWB + col_b, 16,
                                  C::ATOM, C::SWIZZLE);
    wgmma_ss_n64(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V of one stage, issued and committed, not waited for.
template <int HD>
__device__ __forceinline__ void issue_pv(float* o, uint32_t* pa,
                                         uint32_t v_base) {
  using C = Cfg<HD>;
  fence_regs<HD / 2>(o);
  fence_regs<BK / 4>(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = make_desc(v_base + kk * 16 * C::ROWB, BK * C::ROWB,
                                  C::ATOM, C::SWIZZLE);
    wgmma_pv<HD>(o, &pa[4 * kk], db);
  }
  wgmma_commit();
}

// Online softmax of one score tile, in place: raw scores in, unnormalised
// probabilities out. m (raw units) and l of the thread's two rows are
// updated; alpha[i] is the factor by which row i of O must be rescaled.
// meta: the tile's first key, its smallest and largest valid position,
// and whether every key of it is valid; kp: its kv positions.
//
// A masked score enters the row max as -inf against a running max that
// starts at NEG_INF (-1e30), so the max is the reference's, and its p is
// exp(-inf) = 0 exactly: the reference's explicit zeroing of masked p
// (needed there because exp(s - max) = 1 while every key so far is
// masked) happens in the exponential itself.
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l,
                                             float* alpha, const int* meta,
                                             const int* kp, const int* klo,
                                             const int* khi, float scale_log2,
                                             int lane) {
  // Inside the causal (and window) band for both rows of every thread of
  // the warp: nothing to mask. Otherwise the mask is exact per element.
  const bool inside = meta[3] && meta[1] >= klo[0] && meta[2] <= khi[0] &&
                      meta[1] >= klo[1] && meta[2] <= khi[1];
  if (!__all_sync(0xffffffffu, inside)) {
    kp += 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int2 key = *reinterpret_cast<const int2*>(kp + 8 * j);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (key.x < klo[i] || key.x > khi[i]) sc[4 * j + 2 * i] = -INFINITY;
        if (key.y < klo[i] || key.y > khi[i]) sc[4 * j + 2 * i + 1] = -INFINITY;
      }
    }
  }
  float mx[2] = {m[0], m[1]}, mb[2];
#pragma unroll
  for (int r = 0; r < BK / 2; ++r) mx[(r / 2) % 2] = fmaxf(mx[(r / 2) % 2], sc[r]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the 4 lanes of a quad share a row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2_approx((m[i] - mx[i]) * scale_log2);
    m[i] = mx[i];
    mb[i] = mx[i] * scale_log2;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int r = 0; r < BK / 2; ++r) {
    const int i = (r / 2) % 2;
    sc[r] = exp2_approx(fmaf(sc[r], scale_log2, -mb[i]));
    l[i] += sc[r];
  }
}

// A consumer warpgroup: 64 query rows against every tile the producer
// sends. The P V product of one tile runs while the scores of the next
// are computed and put through the softmax.
template <int HD>
__device__ __forceinline__ void consume(
    const int* __restrict__ qpos, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, unsigned char* sQ, unsigned char* sK,
    unsigned char* sV, int* sKpos, int* sMeta, uint64_t* barQ, uint64_t* fullK, uint64_t* fullV,
    uint64_t* empty, int tid, int h, int bi, int q0, int s, int nq,
    int causal, int window, float scale_log2) {
  using C = Cfg<HD>;
  const int t = tid % 128;
  const int c = tid / 128 - 1;                 // consumer 0 or 1
  const int w = t / 32, lane = t % 32;
  const int r0 = 64 * c + 16 * w + lane / 4;   // this thread's rows r0, r0+8
  // valid keys of each row: klo <= kpos <= khi
  int klo[2], khi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const int qp = row < s ? qpos[(size_t)bi * s + row] : -1;
    if (qp < 0) {
      klo[i] = 1;
      khi[i] = 0;
    } else if (!causal) {
      klo[i] = 0;
      khi[i] = INT_MAX;
    } else {
      klo[i] = window > 0 ? max(0, qp - window + 1) : 0;
      khi[i] = qp;
    }
  }

  float o[HD / 2];
  float sc[BK / 2];
  uint32_t pa[BK / 4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  const uint32_t q_base = smem_u32(sQ) + 64 * c * C::ROWB;
  const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
  mbar_wait(barQ, 0);
  int st = 0;
  uint32_t ph = 0;
  mbar_wait(&fullK[0], 0);
  if (sMeta[0] >= 0) {
    issue_qk<HD>(sc, q_base, k_base);
    wgmma_wait<0>();
    fence_regs<BK / 2>(sc);
    softmax_tile(sc, m, l, alpha, sMeta, sKpos, klo, khi, scale_log2, lane);
#pragma unroll
    for (int r = 0; r < BK / 4; ++r) pa[r] = pack_bf16(sc[2 * r], sc[2 * r + 1]);
    for (;;) {
      const int pst = st;               // the stage whose P V is next
      const uint32_t pph = ph;
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
      mbar_wait(&fullK[st], ph);
      if (sMeta[4 * st] < 0) {          // no more tiles: the last P V
        mbar_wait(&fullV[pst], pph);
        issue_pv<HD>(o, pa, v_base + pst * C::KV_BYTES);
        wgmma_wait<0>();
        fence_regs<HD / 2>(o);
        fence_regs<BK / 4>(pa);
        break;
      }
      issue_qk<HD>(sc, q_base, k_base + st * C::KV_BYTES);
      mbar_wait(&fullV[pst], pph);
      issue_pv<HD>(o, pa, v_base + pst * C::KV_BYTES);
      wgmma_wait<1>();                  // the scores, not yet P V
      fence_regs<BK / 2>(sc);
      softmax_tile(sc, m, l, alpha, sMeta + 4 * st, sKpos + st * BK, klo,
                   khi, scale_log2, lane);
      wgmma_wait<0>();
      fence_regs<HD / 2>(o);
      fence_regs<BK / 4>(pa);
      if (t == 0) mbar_arrive(&empty[pst]);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= alpha[i];
          o[4 * j + 2 * i + 1] *= alpha[i];
        }
      }
#pragma unroll
      for (int r = 0; r < BK / 4; ++r) pa[r] = pack_bf16(sc[2 * r], sc[2 * r + 1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + r0 + 8 * i;
    if (row >= s) continue;
    // the row's log-sum-exp of its scaled scores, natural units (m is raw,
    // so in log2 units first); +inf for a row without a valid key, so that
    // every exp(s - lse) of that row is 0
    if (lse != nullptr && lane % 4 == 0)
      lse[((size_t)bi * nq + h) * s + row] =
          l[i] > 0.f ? (m[i] * scale_log2 + log2f(l[i])) * 0.6931471805599453f
                     : INFINITY;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;   // padded rows -> 0
    __nv_bfloat16* orow = out + (((size_t)bi * s + row) * nq + h) * HD +
                          2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const int* __restrict__ qpos, const int* __restrict__ kpos,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int s, int S, int nq, int nkv, int causal, int window,
                float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sm;
  unsigned char* sK = sm + C::OFF_K;
  unsigned char* sV = sm + C::OFF_V;
  int* sKpos = reinterpret_cast<int*>(sm + C::OFF_KPOS);
  int* sMeta = reinterpret_cast<int*>(sm + C::OFF_META);
  uint64_t* barQ = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* fullK = barQ + 1;
  uint64_t* fullV = fullK + STAGES;
  uint64_t* empty = fullV + STAGES;

  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest tiles first
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(barQ, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&fullK[st], 32);     // the producer warp's lanes
      mbar_init(&fullV[st], 1);
      mbar_init(&empty[st], 2);      // the two consumer warpgroups
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------- producer ----------------
    if (tid < 32) produce<HD>(tmq, tmk, tmv, qpos, kpos, sQ, sK, sV, sKpos,
                              sMeta, barQ, fullK, fullV, empty, tid, h, bi,
                              kvh, q0, s, S, causal, window);
  } else {
    // ---------------- consumers ----------------
    consume<HD>(qpos, out, lse, sQ, sK, sV, sKpos, sMeta, barQ, fullK, fullV,
                empty, tid, h, bi, q0, s, nq, causal, window, scale_log2);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, float* lse, int b, int s, int S,
           int nq, int nkv, int causal, int window, float scale,
           cudaStream_t stream) {
  if (S == 0)       // no key at all: every row is fully masked, so 0
    return (int)cudaMemsetAsync(out, 0, (size_t)b * s * nq * HD * 2, stream);
  if (encode_fn() == nullptr) return ENCODE_MISSING;
  CUtensorMap mq, mk, mv;
  constexpr int P = Cfg<HD>::PANEL;
  CUresult r = encode_heads(&mq, q, HD, b, s, nq, P, BQ);
  if (r == CUDA_SUCCESS) r = encode_heads(&mk, k, HD, b, S, nkv, P, BK);
  if (r == CUDA_SUCCESS) r = encode_heads(&mv, v, HD, b, S, nkv, P, BK);
  if (r != CUDA_SUCCESS) return -(int)r;
  const int smem = Cfg<HD>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nq, b, (s + BQ - 1) / BQ);
  flash_tc_kernel<HD><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<const int*>(qpos), static_cast<const int*>(kpos),
      static_cast<__nv_bfloat16*>(out), lse, s, S, nq, nkv, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
namespace cc {


constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <typename T, int HD>
constexpr size_t smem_bytes() {
  constexpr int LD = HD + 4 / (int)sizeof(T);
  return (size_t)(BQ + BK) * LD * sizeof(T) + (size_t)BK * HD * sizeof(T) +
         (size_t)BQ * (BK + 1) * sizeof(float) + 2 * BQ * sizeof(int);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, T* __restrict__ out,
                 float* __restrict__ lse, int s, int S, int nq, int nkv,
                 int causal, int window, float scale) {
  constexpr int LD = HD + 4 / (int)sizeof(T);   // odd count of 32-bit words
  constexpr int NC = HD / 16;                   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + BQ * LD;
  T* sv = sk + BK * LD;
  float* sp = reinterpret_cast<float*>(sv + BK * HD);
  int* sqp = reinterpret_cast<int*>(sp + BQ * (BK + 1));
  int* skp = sqp + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (nq / nkv);               // GQA: kv head of q head h
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const T zero = Cvt<T>::from_f(0.f);

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, row = q0 + r;
    sq[r * LD + d] =
        row < s ? q[(((size_t)bi * s + row) * nq + h) * HD + d] : zero;
  }
  if (tid < BQ) {
    const int row = q0 + tid;
    sqp[tid] = row < s ? qpos[(size_t)bi * s + row] : -1;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();
  int myq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) myq[i] = sqp[ty + 16 * i];

  for (int k0 = 0; k0 < S; k0 += BK) {
    if (tid < BK) {
      const int t = k0 + tid;
      skp[tid] = t < S ? kpos[(size_t)bi * S + t] : -1;
    }
    __syncthreads();
    unsigned vmask = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = skp[tx + 16 * j], qp = myq[i];
        bool ok = kp >= 0 && qp >= 0;
        if (causal) {
          ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
        }
        vmask |= (unsigned)ok << (i * 4 + j);
      }
    }
    // whole tile masked for every query of the block: skip it unread
    if (!__syncthreads_or(vmask != 0)) continue;

    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int r = idx / HD, d = idx % HD, t = k0 + r;
      const size_t off = (((size_t)bi * S + t) * nkv + kvh) * HD + d;
      sk[r * LD + d] = t < S ? k[off] : zero;
      sv[r * HD + d] = t < S ? v[off] : zero;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Cvt<T>::ld2(&sq[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Cvt<T>::ld2(&sk[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] = fmaf(qa[i].y, kb[j].y, fmaf(qa[i].x, kb[j].x, sc[i][j]));
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = (vmask >> (i * 4 + j)) & 1u;
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 threads sharing a row are the 16 lanes of one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mnew = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = (vmask >> (i * 4 + j)) & 1u;
        const float p = ok ? expf(sc[i][j] - mnew) : 0.f;   // re-mask
        sp[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float alpha = expf(m[i] - mnew);
      l[i] = l[i] * alpha + rs;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Cvt<T>::to_f(sv[j * HD + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];   // padded query rows -> 0
    // the row's log-sum-exp (m is in scaled units here); +inf without keys
    if (lse != nullptr && tx == 0)
      lse[((size_t)bi * nq + h) * s + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    T* o = out + (((size_t)bi * s + row) * nq + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = Cvt<T>::from_f(acc[i][c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, float* lse, int b, int s, int S,
           int nq, int nkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + BQ - 1) / BQ, nq, b);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<T*>(out), lse, s, S, nq,
      nkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace cc

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* qpos, const void* kpos, void* out, float* lse,
              int b, int s, int S, int nq, int nkv, int causal, int window,
              float scale, cudaStream_t st) {
  if (dtype == rt::DTYPE_BF16)
    return tc::launch<HD>(q, k, v, qpos, kpos, out, lse, b, s, S, nq, nkv,
                          causal, window, scale, st);
  if (dtype == rt::DTYPE_F32)
    return cc::launch<float, HD>(q, k, v, qpos, kpos, out, lse, b, s, S, nq,
                                 nkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (b, s, nq, hd), k/v (b, S, nkv, hd), qpos (b, s), kpos (b, S) int32,
// out (b, s, nq, hd); all contiguous, on the current device, q/k/v 16-byte
// aligned (TMA). lse: null (serving), or (b, nq, s) f32 that receives each
// row's log-sum-exp of its scaled scores for the gradient (not written when
// S == 0). window <= 0 means no window. Returns 0, a CUDA error code of the
// launch, or a negative code for a tensor map that did not encode.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* qpos,
                                   const void* kpos, void* out, void* lse,
                                   int b, int s, int S, int nq, int nkv,
                                   int hd, int dtype, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 32: return launch_hd<32>(dtype, q, k, v, qpos, kpos, out, l, b, s, S, nq, nkv, causal, window, scale, st);
    case 64: return launch_hd<64>(dtype, q, k, v, qpos, kpos, out, l, b, s, S, nq, nkv, causal, window, scale, st);
    case 128: return launch_hd<128>(dtype, q, k, v, qpos, kpos, out, l, b, s, S, nq, nkv, causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
