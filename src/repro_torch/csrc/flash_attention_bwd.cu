// The gradient of flash attention for Hopper, sm_90a: dq, dk and dv of
// out = softmax(scale * q kᵀ + mask) v.
//
// Replaces no TPU kernel. The reference cannot differentiate its Pallas
// flash kernel (jax.grad through it fails in pallas_call), so it trains
// through its jnp path (attention_ref) and takes the gradient JAX derives
// from that. The port dispatches by device only: on the card attention is
// the hand-written forward kernel, which needs a gradient of its own. This
// is it; its parity target is the autograd gradient of the plain version
// (kernels/flash_attention/ref.py:attention_ref), and ref.py's
// attention_bwd_from_lse spells out the arithmetic below.
//
// Same masks as the forward (csrc/flash_attention.cu): kv_pos >= 0 and
// q_pos >= 0; causal kv_pos <= q_pos; window q_pos - kv_pos < window; GQA
// (query head h reads kv head h / (nq / nkv), so dk and dv sum over the
// group); causal = 0 for cross-attention. A query row without a valid key
// has a zero output and gets zero gradients, as the plain version's.
//
// Inputs beside the forward's: its output, dout, and lse (b, nq, s) f32,
// each row's log-sum-exp of its scaled scores, which the forward kept (+inf
// for a row without a valid key). With them P = exp(scale s - lse) needs
// no pass of its own; D = Σ dO·O is the one row quantity left to find.
//
// What bounds it on the card: operations. Five products of the forward's
// size (the scores recomputed, dP = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS
// K), 2.5 times the forward's two; at smollm-135m's training shape (b 4,
// s = S = 2048 causal, 9 q heads, hd 64) 48 GFLOP a layer, 0.049 ms on
// the bf16 tensor cores. The bf16 design does seven (the scores and dP in
// both of its product kernels), so it can reach at most 5/7 of the bound.
//
// Three device kernels a call, launched in order on the caller's stream,
// no atomics (each output has one writer), so two calls on the same inputs
// are bitwise equal:
// * flash_bwd_prep_kernel (both dtypes): D = Σ dO·O of each row, a
//   bandwidth pass; 16-byte loads, the lanes of a row summing by shuffles.
// * bf16, on the tensor cores (namespace tc), two kernels of one shape:
//   160 threads, one consumer warpgroup that owns a 64-row tile (the M of
//   wgmma) and one producer warp that streams 64-row tiles through a ring
//   of shared-memory stages by TMA, completion counted in bytes on
//   mbarriers, and skips every tile without a valid pair for the block
//   (the forward's tile test). Tiles and swizzles are the forward's (see
//   sm90.cuh): 64-column panels with the 128-byte swizzle, 32 with the
//   64-byte one. Register budget: a 160-thread block may take 255
//   registers a thread, where the forward's 384 threads had 168.
//   - flash_bwd_dkdv_kernel, one block per (kv head, batch row, 64-key
//     tile), the key tile the slowest grid index so that the first key
//     tiles (the most query tiles under the causal mask) go first. K and V
//     are loaded once; the producer streams (Q, dO) tiles with their q_pos,
//     lse and D, query tiles outer and the GQA group's heads inner, so the
//     block sums the whole group and dk, dv have one writer. Per tile:
//     Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (wgmma, both operands in shared memory,
//     Q and dO K-major); Pᵀ = exp2(scale_log2 Sᵀ - lse log2 e) and dSᵀ =
//     Pᵀ (dPᵀ - D) in registers, masked per element (rows are keys,
//     columns queries), packed to bf16 pairs, which by the accumulator =
//     A-fragment rule are the A operands of dV += Pᵀ dO and dK += dSᵀ Q
//     (wgmma from registers, dO and Q read MN-major from the same stage).
//     A thread at hd 128 holds dK and dV (128 f32), Sᵀ and dPᵀ (64) and
//     the two packed tiles (32): one block a multiprocessor at hd 128, two
//     at hd 64 and 32. dk is scaled once at the end.
//   - flash_bwd_dq_kernel, one block per (q head, batch row, 64-query
//     tile), the last query tiles (the heaviest under the causal mask)
//     first: the forward's structure with one more product. Q and dO are
//     loaded once; K and V tiles stream. S = Q Kᵀ and dP = dO Vᵀ (shared
//     memory operands), dS = P (dP - D) in registers, packed to bf16, then
//     dQ += dS K (K read MN-major, as the forward reads V). Two blocks a
//     multiprocessor.
//   Each tile's two score products are issued together; the sums of tile j
//   run while the producer's next stage lands and the scores of tile j+1
//   are issued, and a stage is released when the sums that read it are
//   done. ptxas: dK/dV 250, 165 and 154 registers at hd 128, 64 and 32,
//   dQ 158, 140 and 124; no spills.
// * f32, on the CUDA cores: flash_bwd_kv_kernel (dk, dv) and
//   flash_bwd_q_kernel (dq), FMAs in f32 on 64 x 64 tiles: the f32 parity
//   checks need full-f32 products, as the forward's f32 kernel does. Tiles
//   on a 16 x 16 thread grid: thread (ty, tx) holds the scores of rows
//   ty + 16a and columns tx + 16b, and the sums of rows ty + 16a at
//   columns tx + 16c. Shared rows are padded to an odd number of 32-bit
//   words, so a warp's column reads fall on distinct banks.

#include "common.cuh"
#include "sm90.cuh"

#include <climits>
#include <cmath>

namespace {

using rt::Cvt;
using rt::Vec;

constexpr int BQ = 64;      // queries a tile
constexpr int BK = 64;      // keys a tile
constexpr int NT = 256;     // a 16 x 16 thread grid
constexpr int LP = BK + 1;  // row stride of the P and dS tiles (floats)
template <typename T, int HD>
struct Tile {
  static constexpr int LD = HD + 4 / (int)sizeof(T);   // odd word count
  static constexpr int NC = HD / 16;                    // columns a thread
  static constexpr int ELEMS = 64 * LD;
};

__device__ __forceinline__ bool valid_pair(int qp, int kp, int causal,
                                           int window) {
  bool ok = kp >= 0 && qp >= 0;
  if (causal) {
    ok = ok && kp <= qp;
    if (window > 0) ok = ok && kp > qp - window;
  }
  return ok;
}

// 64 rows of x (b, rows, heads, HD) from row0 into shared dst (row stride
// LD), zeros past nrows. src points at (batch row, 0, head, 0).
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int nrows, int heads, int tid) {
  constexpr int V = 4;
  constexpr int LD = Tile<T, HD>::LD;
  for (int idx = tid; idx < 64 * HD / V; idx += NT) {
    const int r = idx / (HD / V), c = (idx % (HD / V)) * V;
    const int row = row0 + r;
    Vec<T, V> x;
    if (row < nrows) {
      x = *reinterpret_cast<const Vec<T, V>*>(
          src + (size_t)row * heads * HD + c);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x.v[e] = Cvt<T>::from_f(0.f);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * LD + c + e] = x.v[e];
  }
}

// a[i][j] += sum_d x[ty+16i][d] y[tx+16j][d] and b[i][j] the same of u, w:
// two 64 x 64 products of shared row tiles, one pass over d.
template <typename T, int HD>
__device__ __forceinline__ void dot2(float (&a)[4][4], float (&b)[4][4],
                                     const T* x, const T* y, const T* u,
                                     const T* w, int ty, int tx) {
  constexpr int LD = Tile<T, HD>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 2) {
    float2 xa[4], ua[4], yb[4], wb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xa[i] = Cvt<T>::ld2(&x[(ty + 16 * i) * LD + d]);
      ua[i] = Cvt<T>::ld2(&u[(ty + 16 * i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yb[j] = Cvt<T>::ld2(&y[(tx + 16 * j) * LD + d]);
      wb[j] = Cvt<T>::ld2(&w[(tx + 16 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] = fmaf(xa[i].y, yb[j].y, fmaf(xa[i].x, yb[j].x, a[i][j]));
        b[i][j] = fmaf(ua[i].y, wb[j].y, fmaf(ua[i].x, wb[j].x, b[i][j]));
      }
  }
}

// P and dS of the thread's 4 x 4 pairs from the scores s and dP = dO vᵀ:
// P = exp(scale s - lse) where the pair is valid, else 0; dS = P (dP - D).
// Written to the shared tiles sp and sds (row stride LP).
__device__ __forceinline__ void probs(const float (&s)[4][4],
                                      const float (&dp)[4][4], unsigned vmask,
                                      const float* slse, const float* sdel,
                                      float* sp, float* sds, float scale,
                                      int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float lse = slse[r], del = sdel[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = (vmask >> (i * 4 + j)) & 1u;
      const float p = ok ? expf(fmaf(s[i][j], scale, -lse)) : 0.f;
      sp[r * LP + tx + 16 * j] = p;
      sds[r * LP + tx + 16 * j] = p * (dp[i][j] - del);
    }
  }
}

// ---------------------------------------------------------------------------
// D = Σ dO·O of each query row
// ---------------------------------------------------------------------------
// rows = b * s * nq rows of (b, s, nq, HD); delta is (b, nq, s). Each thread
// reads 16 bytes of O and of dO; the L lanes of a row are neighbours in
// their warp and sum by shuffles.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int rows, int s, int nq) {
  constexpr int V = 16 / (int)sizeof(T);   // elements of one 16-byte load
  constexpr int L = HD / V;                // lanes a row: 4 to 32
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = gt / L, c = (gt % L) * V;
  float acc = 0.f;
  if (r < rows) {
    float a[V], d[V];
    rt::load_vec<T, V>(o + (size_t)r * HD + c, a);
    rt::load_vec<T, V>(dout + (size_t)r * HD + c, d);
#pragma unroll
    for (int e = 0; e < V; ++e) acc = fmaf(a[e], d[e], acc);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && gt % L == 0) {
    const int h = r % nq, i = (r / nq) % s, bi = r / (nq * s);
    delta[((size_t)bi * nq + h) * s + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one key tile against every query tile of the group's heads
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kpos,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int s, int S, int nq, int nkv,
                    int causal, int window, float scale) {
  using C = Tile<T, HD>;
  constexpr int LD = C::LD, NC = C::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + C::ELEMS;
  T* sq = sv + C::ELEMS;
  T* sdo = sq + C::ELEMS;
  float* sp = reinterpret_cast<float*>(sdo + C::ELEMS);
  float* sds = sp + BQ * LP;
  float* slse = sds + BQ * LP;
  float* sdel = slse + BQ;
  int* sqp = reinterpret_cast<int*>(sdel + BQ);
  int* skp = sqp + BQ;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, bi = blockIdx.z;
  const int g = nq / nkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_rows<T, HD>(sk, k + ((size_t)bi * S * nkv + kvh) * HD, k0, S, nkv, tid);
  load_rows<T, HD>(sv, v + ((size_t)bi * S * nkv + kvh) * HD, k0, S, nkv, tid);
  if (tid < BK) skp[tid] = k0 + tid < S ? kpos[(size_t)bi * S + k0 + tid] : -1;
  __syncthreads();
  int myk[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) myk[j] = skp[tx + 16 * j];

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[a][c] = adv[a][c] = 0.f;

  for (int h = kvh * g; h < (kvh + 1) * g; ++h) {
    for (int q0 = 0; q0 < s; q0 += BQ) {
      if (tid < BQ) {
        const int row = q0 + tid;
        const size_t r = ((size_t)bi * nq + h) * s + row;
        sqp[tid] = row < s ? qpos[(size_t)bi * s + row] : -1;
        slse[tid] = row < s ? lse[r] : 0.f;
        sdel[tid] = row < s ? delta[r] : 0.f;
      }
      __syncthreads();
      unsigned vmask = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = sqp[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          vmask |= (unsigned)valid_pair(qp, myk[j], causal, window) << (i * 4 + j);
      }
      if (!__syncthreads_or(vmask != 0)) continue;
      load_rows<T, HD>(sq, q + ((size_t)bi * s * nq + h) * HD, q0, s, nq, tid);
      load_rows<T, HD>(sdo, dout + ((size_t)bi * s * nq + h) * HD, q0, s, nq,
                       tid);
      __syncthreads();

      float sc[4][4], dp[4][4];
      dot2<T, HD>(sc, dp, sq, sk, sdo, sv, ty, tx);
      probs(sc, dp, vmask, slse, sdel, sp, sds, scale, ty, tx);
      __syncthreads();

      // dV[j][d] += Σ_i P[i][j] dO[i][d], dK[j][d] += Σ_i dS[i][j] Q[i][d]
      // for the thread's keys j = ty + 16a and columns d = tx + 16c
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pa[4], da[4], doc[NC], qc[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = sp[i * LP + ty + 16 * a];
          da[a] = sds[i * LP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          doc[c] = Cvt<T>::to_f(sdo[i * LD + tx + 16 * c]);
          qc[c] = Cvt<T>::to_f(sq[i * LD + tx + 16 * c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            adv[a][c] = fmaf(pa[a], doc[c], adv[a][c]);
            adk[a][c] = fmaf(da[a], qc[c], adk[a][c]);
          }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= S) continue;
    const size_t base = (((size_t)bi * S + row) * nkv + kvh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[base + tx + 16 * c] = Cvt<T>::from_f(adk[a][c] * scale);
      dv[base + tx + 16 * c] = Cvt<T>::from_f(adv[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one query tile against every key tile with a valid pair
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const int* __restrict__ qpos, const int* __restrict__ kpos,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int s, int S, int nq, int nkv, int causal, int window,
                   float scale) {
  using C = Tile<T, HD>;
  constexpr int LD = C::LD, NC = C::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + C::ELEMS;
  T* sk = sdo + C::ELEMS;
  T* sv = sk + C::ELEMS;
  float* sp = reinterpret_cast<float*>(sv + C::ELEMS);
  float* sds = sp + BQ * LP;
  float* slse = sds + BQ * LP;
  float* sdel = slse + BQ;
  int* sqp = reinterpret_cast<int*>(sdel + BQ);
  int* skp = sqp + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_rows<T, HD>(sq, q + ((size_t)bi * s * nq + h) * HD, q0, s, nq, tid);
  load_rows<T, HD>(sdo, dout + ((size_t)bi * s * nq + h) * HD, q0, s, nq, tid);
  if (tid < BQ) {
    const int row = q0 + tid;
    const size_t r = ((size_t)bi * nq + h) * s + row;
    sqp[tid] = row < s ? qpos[(size_t)bi * s + row] : -1;
    slse[tid] = row < s ? lse[r] : 0.f;
    sdel[tid] = row < s ? delta[r] : 0.f;
  }
  __syncthreads();
  int myq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) myq[i] = sqp[ty + 16 * i];

  float adq[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) adq[a][c] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    if (tid < BK) skp[tid] = k0 + tid < S ? kpos[(size_t)bi * S + k0 + tid] : -1;
    __syncthreads();
    unsigned vmask = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vmask |= (unsigned)valid_pair(myq[i], skp[tx + 16 * j], causal,
                                      window) << (i * 4 + j);
    if (!__syncthreads_or(vmask != 0)) continue;
    load_rows<T, HD>(sk, k + ((size_t)bi * S * nkv + kvh) * HD, k0, S, nkv,
                     tid);
    load_rows<T, HD>(sv, v + ((size_t)bi * S * nkv + kvh) * HD, k0, S, nkv,
                     tid);
    __syncthreads();

    float sc[4][4], dp[4][4];
    dot2<T, HD>(sc, dp, sq, sk, sdo, sv, ty, tx);
    probs(sc, dp, vmask, slse, sdel, sp, sds, scale, ty, tx);
    __syncthreads();

    // dQ[i][d] += Σ_j dS[i][j] K[j][d] for rows i = ty + 16a, d = tx + 16c
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float da[4], kc[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) da[a] = sds[(ty + 16 * a) * LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kc[c] = Cvt<T>::to_f(sk[j * LD + tx + 16 * c]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) adq[a][c] = fmaf(da[a], kc[c], adq[a][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= s) continue;
    const size_t base = (((size_t)bi * s + row) * nq + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[base + tx + 16 * c] = Cvt<T>::from_f(adq[a][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using namespace sm90;

constexpr int BM = 64;          // rows of the block's own tile: wgmma's M
constexpr int BN = 64;          // rows of a streamed tile
constexpr int NTC = 160;        // one consumer warpgroup, one producer warp
constexpr int SCAN = 4;         // key tiles the dQ producer scans at a time
constexpr float LOG2E = 1.4426950408889634f;

// A 64-row tile of HD bf16 columns as TMA writes it: panels of 64 (or 32)
// columns, 64 rows apart.
template <int HD>
struct Geo {
  static constexpr int PANEL = HD < 64 ? HD : 64;   // columns of a TMA box
  static constexpr int NPANEL = HD / PANEL;
  static constexpr int ROWB = PANEL * 2;            // bytes of a panel row
  static constexpr uint32_t SWIZZLE = ROWB == 128 ? 1 : 2;
  static constexpr int ATOM = 8 * ROWB;             // 8 rows of the swizzle
  static constexpr int TILE = BN * HD * 2;          // bytes of a 64-row tile
};

// Shared memory of a block: its two own 64-row tiles (K, V or Q, dO), a
// ring of ST stages of two streamed tiles each, then per stage 64 ints
// and two rows of 64 floats (positions; lse and D, dK/dV kernel only),
// four ints of tile facts and the barriers.
template <int HD, int ST>
struct Cfg : Geo<HD> {
  using Geo<HD>::TILE;
  static constexpr int STAGES = ST;
  static constexpr int OFF_RING = 2 * TILE;
  static constexpr int OFF_VEC = OFF_RING + ST * 2 * TILE;
  static constexpr int OFF_META = OFF_VEC + ST * 3 * BN * 4;
  static constexpr int OFF_BAR = OFF_META + 16 * ST;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * ST);
  static constexpr int SMEM = BYTES + 1024;          // room to align to 1 KB
};

// dK/dV: three stages; one block a multiprocessor at hd 128 (its registers),
// two below. dQ: two blocks a multiprocessor, so two stages at hd 128.
template <int HD>
using KvCfg = Cfg<HD, 3>;
template <int HD>
using QCfg = Cfg<HD, HD == 128 ? 2 : 3>;

template <int HD>
__device__ __forceinline__ void wgmma_sum(float* acc, const uint32_t* a,
                                          uint64_t db) {
  if constexpr (HD == 128) wgmma_rs_n128(acc, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(acc, a, db);
  else wgmma_rs_n32(acc, a, db);
}

// D (64 x 64) = A Bᵀ over HD: A and B 64-row tiles, both K-major, with
// their panels 64 rows apart. Issued, not committed.
template <int HD>
__device__ __forceinline__ void issue_ss(float* d, uint32_t a_base,
                                         uint32_t b_base) {
  using C = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk * 16 / C::PANEL;             // 64-column panel
    const int col_b = (kk * 16 % C::PANEL) * 2;   // byte offset in its row
    const uint64_t da = make_desc(a_base + p * BN * C::ROWB + col_b, 16,
                                  C::ATOM, C::SWIZZLE);
    const uint64_t db = make_desc(b_base + p * BN * C::ROWB + col_b, 16,
                                  C::ATOM, C::SWIZZLE);
    wgmma_ss_n64(d, da, db, kk > 0);
  }
}

// acc (64 x HD) += A (64 x 64, bf16 pairs in registers) B (64 x HD tile in
// shared memory, read MN-major). Issued, not committed.
template <int HD>
__device__ __forceinline__ void issue_rs(float* acc, const uint32_t* a,
                                         uint32_t b_base) {
  using C = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = make_desc(b_base + kk * 16 * C::ROWB, BN * C::ROWB,
                                  C::ATOM, C::SWIZZLE);
    wgmma_sum<HD>(acc, &a[4 * kk], db);
  }
}

// Pᵀ and dSᵀ of one tile of the dK/dV kernel, from Sᵀ (sc) and dPᵀ (dp),
// packed to bf16 pairs. Rows are keys (this thread's two: valid queries
// qlo..qhi each), columns queries: their q_pos, lse in log2 units and D
// come from the stage. meta: the tile's first query, smallest and largest
// valid q_pos, and whether all 64 are valid. A warp whose rows all take
// every query of the tile skips the mask; otherwise a masked pair's P is 0.
__device__ __forceinline__ void grads_t(const float* sc, const float* dp,
                                        uint32_t* pp, uint32_t* pd,
                                        const int* meta, const int* qp,
                                        const float* l2, const float* dd,
                                        const int* qlo, const int* qhi,
                                        float scale_log2, int lane) {
  const bool inside = meta[3] && meta[1] >= qlo[0] && meta[2] <= qhi[0] &&
                      meta[1] >= qlo[1] && meta[2] <= qhi[1];
  const bool mask = !__all_sync(0xffffffffu, inside);
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * j + c0);
    const float2 d = *reinterpret_cast<const float2*>(dd + 8 * j + c0);
    const int2 q = *reinterpret_cast<const int2*>(qp + 8 * j + c0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p0 = exp2_approx(fmaf(sc[4 * j + 2 * i], scale_log2, -l.x));
      float p1 = exp2_approx(fmaf(sc[4 * j + 2 * i + 1], scale_log2, -l.y));
      if (mask) {
        if (q.x < qlo[i] || q.x > qhi[i]) p0 = 0.f;
        if (q.y < qlo[i] || q.y > qhi[i]) p1 = 0.f;
      }
      pp[2 * j + i] = pack_bf16(p0, p1);
      pd[2 * j + i] = pack_bf16(p0 * (dp[4 * j + 2 * i] - d.x),
                                p1 * (dp[4 * j + 2 * i + 1] - d.y));
    }
  }
}

// dS of one tile of the dQ kernel, packed to bf16 pairs. Rows are queries
// (this thread's two: valid keys klo..khi, lse in log2 units and D each),
// columns keys, whose kv_pos come from the stage. meta: the tile's first
// key, smallest and largest valid kv_pos, and whether all 64 are valid.
__device__ __forceinline__ void grads(const float* sc, const float* dp,
                                      uint32_t* pd, const int* meta,
                                      const int* kp, const int* klo,
                                      const int* khi, const float* l2,
                                      const float* dd, float scale_log2,
                                      int lane) {
  const bool inside = meta[3] && meta[1] >= klo[0] && meta[2] <= khi[0] &&
                      meta[1] >= klo[1] && meta[2] <= khi[1];
  const bool mask = !__all_sync(0xffffffffu, inside);
  kp += 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int2 key = *reinterpret_cast<const int2*>(kp + 8 * j);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p0 = exp2_approx(fmaf(sc[4 * j + 2 * i], scale_log2, -l2[i]));
      float p1 = exp2_approx(fmaf(sc[4 * j + 2 * i + 1], scale_log2, -l2[i]));
      if (mask) {
        if (key.x < klo[i] || key.x > khi[i]) p0 = 0.f;
        if (key.y < klo[i] || key.y > khi[i]) p1 = 0.f;
      }
      pd[2 * j + i] = pack_bf16(p0 * (dp[4 * j + 2 * i] - dd[i]),
                                p1 * (dp[4 * j + 2 * i + 1] - dd[i]));
    }
  }
}

// 64 rows x HD of an f32 accumulator (this thread's rows r0, r0 + 8 of the
// tile starting at row0, of `rows`), times `mul`, into x (b, rows, heads,
// HD) bf16 at (batch row bi, head h).
template <int HD>
__device__ __forceinline__ void store_rows(const float* acc, float mul,
                                           __nv_bfloat16* __restrict__ x,
                                           int bi, int h, int heads,
                                           int row0, int rows, int lane,
                                           int r0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= rows) continue;
    __nv_bfloat16* xr = x + (((size_t)bi * rows + row) * heads + h) * HD +
                        2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(xr + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  }
}

// ---- dK, dV ---------------------------------------------------------------

// The producer warp: K and V once, then (Q, dO, q_pos, lse, D) of every
// (query tile, head of the group) with a valid pair for the block's keys.
template <int HD>
__device__ __forceinline__ void produce_kv(
    const CUtensorMap& tmq, const CUtensorMap& tmk, const CUtensorMap& tmv,
    const CUtensorMap& tmdo, const int* __restrict__ qpos,
    const int* __restrict__ kpos, const float* __restrict__ lse,
    const float* __restrict__ delta, unsigned char* sm, uint64_t* barKV,
    uint64_t* full, uint64_t* empty, int lane, int kvh, int bi, int k0,
    int s, int S, int nq, int nkv, int causal, int window) {
  using C = KvCfg<HD>;
  constexpr int ST = C::STAGES;
  int* sQpos = reinterpret_cast<int*>(sm + C::OFF_VEC);
  float* sLse = reinterpret_cast<float*>(sQpos + ST * BN);
  float* sD = sLse + ST * BN;
  int* sMeta = reinterpret_cast<int*>(sm + C::OFF_META);
  if (lane == 0) {
    mbar_arrive_expect_tx(barKV, 2 * C::TILE);
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p) {
      tma_load_4d(sm + p * BM * C::ROWB, &tmk, barKV, p * C::PANEL, kvh, k0,
                  bi);
      tma_load_4d(sm + C::TILE + p * BM * C::ROWB, &tmv, barKV, p * C::PANEL,
                  kvh, k0, bi);
    }
  }
  // the block's smallest and largest valid key position
  int kmn = INT_MAX, kmx = -1;
#pragma unroll
  for (int e = 0; e < BM / 32; ++e) {
    const int i = k0 + 32 * e + lane;
    const int p = i < S ? kpos[(size_t)bi * S + i] : -1;
    if (p >= 0) {
      kmn = min(kmn, p);
      kmx = max(kmx, p);
    }
  }
  kmn = warp_min(kmn);
  kmx = warp_max(kmx);
  const int g = nq / nkv;
  const int* qp_row = qpos + (size_t)bi * s;
  int st = 0;
  uint32_t ph = 0;
  for (int q0 = 0; kmx >= 0 && q0 < s; q0 += BN) {
    int qp[BN / 32], qmn = INT_MAX, qmx = -1;
    bool all = true;
#pragma unroll
    for (int e = 0; e < BN / 32; ++e) {
      const int row = q0 + 32 * e + lane;
      qp[e] = row < s ? qp_row[row] : -1;
      if (qp[e] >= 0) {
        qmn = min(qmn, qp[e]);
        qmx = max(qmx, qp[e]);
      } else {
        all = false;
      }
    }
    qmn = warp_min(qmn);
    qmx = warp_max(qmx);
    all = __all_sync(0xffffffffu, all);
    // a valid pair needs kv_pos <= q_pos and q_pos - kv_pos < window
    bool use = qmx >= 0;
    if (causal)
      use = use && qmx >= kmn && (window <= 0 || qmn - window < kmx);
    if (!use) continue;
    for (int h = kvh * g; h < (kvh + 1) * g; ++h) {
      mbar_wait(&empty[st], ph ^ 1);
      const float* lrow = lse + ((size_t)bi * nq + h) * s;
      const float* drow = delta + ((size_t)bi * nq + h) * s;
#pragma unroll
      for (int e = 0; e < BN / 32; ++e) {
        const int row = q0 + 32 * e + lane, i = st * BN + 32 * e + lane;
        sQpos[i] = qp[e];
        sLse[i] = row < s ? lrow[row] * LOG2E : 0.f;
        sD[i] = row < s ? drow[row] : 0.f;
      }
      if (lane == 0) {
        sMeta[4 * st] = q0;
        sMeta[4 * st + 1] = qmn;
        sMeta[4 * st + 2] = qmx;
        sMeta[4 * st + 3] = all;
        unsigned char* sQ = sm + C::OFF_RING + st * 2 * C::TILE;
        mbar_arrive_expect_tx(&full[st], 2 * C::TILE);
#pragma unroll
        for (int p = 0; p < C::NPANEL; ++p) {
          tma_load_4d(sQ + p * BN * C::ROWB, &tmq, &full[st], p * C::PANEL,
                      h, q0, bi);
          tma_load_4d(sQ + C::TILE + p * BN * C::ROWB, &tmdo, &full[st],
                      p * C::PANEL, h, q0, bi);
        }
      } else {
        mbar_arrive(&full[st]);
      }
      if (++st == ST) {
        st = 0;
        ph ^= 1;
      }
    }
  }
  // end of the tile list: a stage that carries no tile
  mbar_wait(&empty[st], ph ^ 1);
  if (lane == 0) sMeta[4 * st] = -1;
  mbar_arrive(&full[st]);
}

// The consumer warpgroup: 64 keys against every tile the producer sends.
template <int HD>
__device__ __forceinline__ void consume_kv(
    const int* __restrict__ kpos, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, unsigned char* sm, uint64_t* barKV,
    uint64_t* full, uint64_t* empty, int t, int kvh, int bi, int k0, int S,
    int nkv, int causal, int window, float scale, float scale_log2) {
  using C = KvCfg<HD>;
  constexpr int ST = C::STAGES;
  const int* sQpos = reinterpret_cast<const int*>(sm + C::OFF_VEC);
  const float* sLse = reinterpret_cast<const float*>(sQpos + ST * BN);
  const float* sD = sLse + ST * BN;
  const int* sMeta = reinterpret_cast<const int*>(sm + C::OFF_META);
  const int w = t / 32, lane = t % 32;
  const int r0 = 16 * w + lane / 4;     // this thread's key rows r0, r0 + 8
  // valid queries of each key row: qlo <= q_pos <= qhi
  int qlo[2], qhi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + 8 * i;
    const int kp = row < S ? kpos[(size_t)bi * S + row] : -1;
    if (kp < 0) {
      qlo[i] = 1;
      qhi[i] = 0;
    } else if (!causal) {
      qlo[i] = 0;
      qhi[i] = INT_MAX;
    } else {
      qlo[i] = kp;
      qhi[i] = window > 0 && kp <= INT_MAX - window ? kp + window - 1
                                                     : INT_MAX;
    }
  }

  float adk[HD / 2], adv[HD / 2], sc[BN / 2], dp[BN / 2];
  uint32_t pp[BN / 4], pd[BN / 4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) adk[i] = adv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) pp[i] = pd[i] = 0u;

  const uint32_t k_base = smem_u32(sm), v_base = k_base + C::TILE;
  const uint32_t ring = k_base + C::OFF_RING;
  mbar_wait(barKV, 0);
  int st = 0, pst = -1;
  uint32_t ph = 0;
  for (;;) {
    mbar_wait(&full[st], ph);
    if (sMeta[4 * st] < 0) break;
    const uint32_t q_base = ring + st * 2 * C::TILE, do_base = q_base + C::TILE;
    fence_regs<BN / 2>(sc);
    fence_regs<BN / 2>(dp);
    wgmma_fence();
    issue_ss<HD>(sc, k_base, q_base);     // Sᵀ = K Qᵀ
    issue_ss<HD>(dp, v_base, do_base);    // dPᵀ = V dOᵀ
    wgmma_commit();
    wgmma_wait<0>();                      // and the last tile's dV, dK sums
    fence_regs<BN / 2>(sc);
    fence_regs<BN / 2>(dp);
    fence_regs<HD / 2>(adk);
    fence_regs<HD / 2>(adv);
    fence_regs<BN / 4>(pp);
    fence_regs<BN / 4>(pd);
    if (pst >= 0 && t == 0) mbar_arrive(&empty[pst]);
    grads_t(sc, dp, pp, pd, sMeta + 4 * st, sQpos + st * BN, sLse + st * BN,
            sD + st * BN, qlo, qhi, scale_log2, lane);
    fence_regs<HD / 2>(adk);
    fence_regs<HD / 2>(adv);
    fence_regs<BN / 4>(pp);
    fence_regs<BN / 4>(pd);
    wgmma_fence();
    issue_rs<HD>(adv, pp, do_base);       // dV += Pᵀ dO
    issue_rs<HD>(adk, pd, q_base);        // dK += dSᵀ Q
    wgmma_commit();
    pst = st;
    if (++st == ST) {
      st = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs<HD / 2>(adk);
  fence_regs<HD / 2>(adv);
  fence_regs<BN / 4>(pp);
  fence_regs<BN / 4>(pd);
  store_rows<HD>(adk, scale, dk, bi, kvh, nkv, k0, S, lane, r0);
  store_rows<HD>(adv, 1.f, dv, bi, kvh, nkv, k0, S, lane, r0);
}

template <int HD>
__global__ void __launch_bounds__(NTC, HD == 128 ? 1 : 2)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const __grid_constant__ CUtensorMap tmdo,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int s, int S, int nq,
                      int nkv, int causal, int window, float scale,
                      float scale_log2) {
  using C = KvCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* barKV = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = barKV + 1;
  uint64_t* empty = full + C::STAGES;
  const int kvh = blockIdx.x, bi = blockIdx.y, k0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(barKV, 1);
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 32);      // the producer warp's lanes
      mbar_init(&empty[st], 1);      // the consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid >= 128)
    produce_kv<HD>(tmq, tmk, tmv, tmdo, qpos, kpos, lse, delta, sm, barKV,
                   full, empty, tid - 128, kvh, bi, k0, s, S, nq, nkv, causal,
                   window);
  else
    consume_kv<HD>(kpos, dk, dv, sm, barKV, full, empty, tid, kvh, bi, k0, S,
                   nkv, causal, window, scale, scale_log2);
}

// ---- dQ --------------------------------------------------------------------

// The producer warp: Q and dO once, then K, V and kv_pos of every key tile
// with a valid pair for the block's queries (the forward's test).
template <int HD>
__device__ __forceinline__ void produce_q(
    const CUtensorMap& tmq, const CUtensorMap& tmk, const CUtensorMap& tmv,
    const CUtensorMap& tmdo, const int* __restrict__ qpos,
    const int* __restrict__ kpos, unsigned char* sm, uint64_t* barQ,
    uint64_t* full, uint64_t* empty, int lane, int h, int bi, int kvh,
    int q0, int s, int S, int causal, int window) {
  using C = QCfg<HD>;
  constexpr int ST = C::STAGES;
  int* sKpos = reinterpret_cast<int*>(sm + C::OFF_VEC);
  int* sMeta = reinterpret_cast<int*>(sm + C::OFF_META);
  if (lane == 0) {
    mbar_arrive_expect_tx(barQ, 2 * C::TILE);
#pragma unroll
    for (int p = 0; p < C::NPANEL; ++p) {
      tma_load_4d(sm + p * BM * C::ROWB, &tmq, barQ, p * C::PANEL, h, q0, bi);
      tma_load_4d(sm + C::TILE + p * BM * C::ROWB, &tmdo, barQ, p * C::PANEL,
                  h, q0, bi);
    }
  }
  // the block's smallest and largest valid query position
  int qmin = INT_MAX, qmax = -1;
#pragma unroll
  for (int e = 0; e < BM / 32; ++e) {
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
  const int ntk = (S + BN - 1) / BN;
  int st = 0;
  uint32_t ph = 0;
  for (int t0 = 0; qmax >= 0 && t0 < ntk; t0 += SCAN) {
    int kmn[SCAN], kmx[SCAN];
    bool all[SCAN];
#pragma unroll
    for (int g = 0; g < SCAN; ++g) {
      kmn[g] = INT_MAX;
      kmx[g] = -1;
      all[g] = true;
#pragma unroll
      for (int e = 0; e < BN / 32; ++e) {
        const int i = (t0 + g) * BN + 32 * e + lane;
        const int p = i < S ? kp_row[i] : -1;
        if (p >= 0) {
          kmn[g] = min(kmn[g], p);
          kmx[g] = max(kmx[g], p);
        } else {
          all[g] = false;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < SCAN; ++g) {
      kmn[g] = warp_min(kmn[g]);
      kmx[g] = warp_max(kmx[g]);
      all[g] = __all_sync(0xffffffffu, all[g]);
    }
#pragma unroll
    for (int g = 0; g < SCAN; ++g) {
      bool use = kmx[g] >= 0;
      if (causal)
        use = use && kmn[g] <= qmax && (window <= 0 || kmx[g] > qmin - window);
      if (!use) continue;
      const int k0 = (t0 + g) * BN;
      mbar_wait(&empty[st], ph ^ 1);
#pragma unroll
      for (int e = 0; e < BN / 32; ++e) {
        const int i = k0 + 32 * e + lane;
        sKpos[st * BN + 32 * e + lane] = i < S ? kp_row[i] : -1;
      }
      if (lane == 0) {
        sMeta[4 * st] = k0;
        sMeta[4 * st + 1] = kmn[g];
        sMeta[4 * st + 2] = kmx[g];
        sMeta[4 * st + 3] = all[g];
        unsigned char* sK = sm + C::OFF_RING + st * 2 * C::TILE;
        mbar_arrive_expect_tx(&full[st], 2 * C::TILE);
#pragma unroll
        for (int p = 0; p < C::NPANEL; ++p) {
          tma_load_4d(sK + p * BN * C::ROWB, &tmk, &full[st], p * C::PANEL,
                      kvh, k0, bi);
          tma_load_4d(sK + C::TILE + p * BN * C::ROWB, &tmv, &full[st],
                      p * C::PANEL, kvh, k0, bi);
        }
      } else {
        mbar_arrive(&full[st]);
      }
      if (++st == ST) {
        st = 0;
        ph ^= 1;
      }
    }
  }
  mbar_wait(&empty[st], ph ^ 1);
  if (lane == 0) sMeta[4 * st] = -1;
  mbar_arrive(&full[st]);
}

// The consumer warpgroup: 64 queries against every key tile it is sent.
template <int HD>
__device__ __forceinline__ void consume_q(
    const int* __restrict__ qpos, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    unsigned char* sm, uint64_t* barQ, uint64_t* full, uint64_t* empty,
    int t, int h, int bi, int q0, int s, int nq, int causal, int window,
    float scale, float scale_log2) {
  using C = QCfg<HD>;
  constexpr int ST = C::STAGES;
  const int* sKpos = reinterpret_cast<const int*>(sm + C::OFF_VEC);
  const int* sMeta = reinterpret_cast<const int*>(sm + C::OFF_META);
  const int w = t / 32, lane = t % 32;
  const int r0 = 16 * w + lane / 4;    // this thread's query rows r0, r0 + 8
  // valid keys of each row, klo <= kv_pos <= khi; lse (log2 units) and D
  int klo[2], khi[2];
  float l2[2], dd[2];
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
    const size_t r = ((size_t)bi * nq + h) * s + row;
    l2[i] = row < s ? lse[r] * LOG2E : 0.f;
    dd[i] = row < s ? delta[r] : 0.f;
  }

  float adq[HD / 2], sc[BN / 2], dp[BN / 2];
  uint32_t pd[BN / 4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) adq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) pd[i] = 0u;

  const uint32_t q_base = smem_u32(sm), do_base = q_base + C::TILE;
  const uint32_t ring = q_base + C::OFF_RING;
  mbar_wait(barQ, 0);
  int st = 0, pst = -1;
  uint32_t ph = 0;
  for (;;) {
    mbar_wait(&full[st], ph);
    if (sMeta[4 * st] < 0) break;
    const uint32_t k_base = ring + st * 2 * C::TILE, v_base = k_base + C::TILE;
    fence_regs<BN / 2>(sc);
    fence_regs<BN / 2>(dp);
    wgmma_fence();
    issue_ss<HD>(sc, q_base, k_base);     // S = Q Kᵀ
    issue_ss<HD>(dp, do_base, v_base);    // dP = dO Vᵀ
    wgmma_commit();
    wgmma_wait<0>();                      // and the last tile's dQ sum
    fence_regs<BN / 2>(sc);
    fence_regs<BN / 2>(dp);
    fence_regs<HD / 2>(adq);
    fence_regs<BN / 4>(pd);
    if (pst >= 0 && t == 0) mbar_arrive(&empty[pst]);
    grads(sc, dp, pd, sMeta + 4 * st, sKpos + st * BN, klo, khi, l2, dd,
          scale_log2, lane);
    fence_regs<HD / 2>(adq);
    fence_regs<BN / 4>(pd);
    wgmma_fence();
    issue_rs<HD>(adq, pd, k_base);        // dQ += dS K
    wgmma_commit();
    pst = st;
    if (++st == ST) {
      st = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs<HD / 2>(adq);
  fence_regs<BN / 4>(pd);
  store_rows<HD>(adq, scale, dq, bi, h, nq, q0, s, lane, r0);
}

template <int HD>
__global__ void __launch_bounds__(NTC, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const __grid_constant__ CUtensorMap tmdo,
                    const int* __restrict__ qpos,
                    const int* __restrict__ kpos,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int s, int S, int nq,
                    int nkv, int causal, int window, float scale,
                    float scale_log2) {
  using C = QCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* barQ = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = barQ + 1;
  uint64_t* empty = full + C::STAGES;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;   // heaviest tiles first
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(barQ, 1);
#pragma unroll
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 32);
      mbar_init(&empty[st], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid >= 128)
    produce_q<HD>(tmq, tmk, tmv, tmdo, qpos, kpos, sm, barQ, full, empty,
                  tid - 128, h, bi, kvh, q0, s, S, causal, window);
  else
    consume_q<HD>(qpos, lse, delta, dq, sm, barQ, full, empty, tid, h, bi, q0,
                  s, nq, causal, window, scale, scale_log2);
}

}  // namespace tc

// four row tiles, P and dS, lse, D and two position rows
template <typename T, int HD>
constexpr size_t main_smem() {
  return 4 * (size_t)Tile<T, HD>::ELEMS * sizeof(T) +
         2 * (size_t)BQ * LP * sizeof(float) + 2 * BQ * sizeof(float) +
         2 * 64 * sizeof(int);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// D of every row of o and dout (b, s, nq, HD) into delta (b, nq, s).
template <typename T, int HD>
cudaError_t launch_prep(const void* o, const void* dout, float* delta, int b,
                        int s, int nq, cudaStream_t st) {
  const int rows = b * s * nq;
  const long long threads = (long long)rows * (HD * (int)sizeof(T) / 16);
  flash_bwd_prep_kernel<T, HD><<<(unsigned)((threads + 255) / 256), 256, 0,
                                 st>>>(static_cast<const T*>(o),
                                       static_cast<const T*>(dout), delta,
                                       rows, s, nq);
  return cudaGetLastError();
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, const void* qpos_,
              const void* kpos_, void* dq, void* dk, void* dv, float* delta,
              int b, int s, int S, int nq, int nkv, int causal, int window,
              float scale, cudaStream_t st) {
  using KC = tc::KvCfg<HD>;
  using QC = tc::QCfg<HD>;
  if (sm90::encode_fn() == nullptr) return sm90::ENCODE_MISSING;
  CUtensorMap mq, mk, mv, mdo;
  CUresult r = sm90::encode_heads(&mq, q, HD, b, s, nq, KC::PANEL, tc::BN);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_heads(&mk, k, HD, b, S, nkv, KC::PANEL, tc::BN);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_heads(&mv, v, HD, b, S, nkv, KC::PANEL, tc::BN);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_heads(&mdo, dout, HD, b, s, nq, KC::PANEL, tc::BN);
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaError_t e = allow_smem(tc::flash_bwd_dkdv_kernel<HD>, KC::SMEM);
  if (e == cudaSuccess) e = allow_smem(tc::flash_bwd_dq_kernel<HD>, QC::SMEM);
  if (e == cudaSuccess)
    e = launch_prep<__nv_bfloat16, HD>(o, dout, delta, b, s, nq, st);
  if (e != cudaSuccess) return (int)e;
  const int* qpos = static_cast<const int*>(qpos_);
  const int* kpos = static_cast<const int*>(kpos_);
  const float scale_log2 = scale * tc::LOG2E;
  tc::flash_bwd_dkdv_kernel<HD>
      <<<dim3(nkv, b, (S + tc::BM - 1) / tc::BM), tc::NTC, KC::SMEM, st>>>(
          mq, mk, mv, mdo, qpos, kpos, lse, delta,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), s,
          S, nq, nkv, causal, window, scale, scale_log2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tc::flash_bwd_dq_kernel<HD>
      <<<dim3(nq, b, (s + tc::BM - 1) / tc::BM), tc::NTC, QC::SMEM, st>>>(
          mq, mk, mv, mdo, qpos, kpos, lse, delta,
          static_cast<__nv_bfloat16*>(dq), s, S, nq, nkv, causal, window,
          scale, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_cc(const void* q_, const void* k_, const void* v_, const void* o,
              const void* dout, const float* lse, const void* qpos_,
              const void* kpos_, void* dq_, void* dk_, void* dv_,
              float* delta, int b, int s, int S, int nq, int nkv, int causal,
              int window, float scale, cudaStream_t st) {
  using T = float;
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* d = static_cast<const T*>(dout);
  const int* qpos = static_cast<const int*>(qpos_);
  const int* kpos = static_cast<const int*>(kpos_);
  constexpr size_t sm = main_smem<T, HD>();
  cudaError_t e = allow_smem(flash_bwd_kv_kernel<T, HD>, sm);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_q_kernel<T, HD>, sm);
  if (e == cudaSuccess) e = launch_prep<T, HD>(o, dout, delta, b, s, nq, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 gq((s + BQ - 1) / BQ, nq, b), gk((S + BK - 1) / BK, nkv, b);
  flash_bwd_kv_kernel<T, HD><<<gk, NT, sm, st>>>(
      q, k, v, d, qpos, kpos, lse, delta, static_cast<T*>(dk_),
      static_cast<T*>(dv_), s, S, nq, nkv, causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_q_kernel<T, HD><<<gq, NT, sm, st>>>(
      q, k, v, d, qpos, kpos, lse, delta, static_cast<T*>(dq_), s, S, nq,
      nkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse,
              const void* qpos, const void* kpos, void* dq, void* dk,
              void* dv, float* delta, int b, int s, int S, int nq, int nkv,
              int causal, int window, float scale, cudaStream_t st) {
  if (dtype == rt::DTYPE_BF16)
    return launch_tc<HD>(q, k, v, o, dout, lse, qpos, kpos, dq, dk, dv,
                         delta, b, s, S, nq, nkv, causal, window, scale, st);
  if (dtype == rt::DTYPE_F32)
    return launch_cc<HD>(q, k, v, o, dout, lse, qpos, kpos, dq, dk, dv,
                         delta, b, s, S, nq, nkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq (b, s, nq, hd); k, v, dk, dv (b, S, nkv, hd); lse (b, nq,
// s) f32 from the forward; qpos (b, s) and kpos (b, S) int32; delta (b, nq,
// s) f32 scratch. All contiguous on the current device, the data 16-byte
// aligned (TMA in bf16), s and S > 0. window <= 0 means no window. Returns
// 0, a CUDA error code, or a negative code for a tensor map that did not
// encode.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   const void* qpos, const void* kpos,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int b, int s, int S, int nq, int nkv,
                                   int hd, int dtype, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (hd) {
    case 32: return launch_hd<32>(dtype, q, k, v, o, dout, l, qpos, kpos, dq, dk, dv, d, b, s, S, nq, nkv, causal, window, scale, st);
    case 64: return launch_hd<64>(dtype, q, k, v, o, dout, l, qpos, kpos, dq, dk, dv, d, b, s, S, nq, nkv, causal, window, scale, st);
    case 128: return launch_hd<128>(dtype, q, k, v, o, dout, l, qpos, kpos, dq, dk, dv, d, b, s, S, nq, nkv, causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
