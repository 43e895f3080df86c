// The gradient of flash attention for Hopper, sm_90a: dq, dk and dv of
// out = softmax(scale * q kᵀ + mask) v.
//
// Replaces no TPU kernel. The reference cannot differentiate its Pallas
// flash kernel (jax.grad through it fails in pallas_call), so it trains
// through its jnp path (attention_ref) and takes the gradient JAX derives
// from that. The port dispatches by device only: on the card attention is
// the hand-written forward kernel, which needs a gradient of its own. This
// is it; its parity target is the autograd gradient of the plain version
// (kernels/flash_attention/ref.py:attention_ref).
//
// Same masks as the forward (csrc/flash_attention.cu): kv_pos >= 0 and
// q_pos >= 0; causal kv_pos <= q_pos; window q_pos - kv_pos < window; GQA
// (query head h reads kv head h / (nq / nkv), so dk and dv sum over the
// group); causal = 0 for cross-attention. A query row without a valid key
// has a zero output and gets zero gradients, as the plain version's.
//
// What bounds it on the card: operations. Five products of the forward's
// size (the scores recomputed, dP = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS
// K), 2.5 times the forward's two; at smollm-135m's training shape (b 4,
// s = S = 2048 causal, 9 q heads, hd 64) 48 GFLOP a layer, 0.049 ms on
// the bf16 tensor cores.
//
// The design is the simple one, right first; speed is later work. CUDA-core
// FMAs in f32 for bf16 and f32 alike (f32 accumulation everywhere), no
// atomics, so two calls on the same inputs are bitwise equal. Three
// kernels, launched in order on the caller's stream:
// * flash_bwd_prep_kernel, one block per (64-query tile, q head, batch
//   row): each row's log-sum-exp of its scaled, masked scores (the
//   forward does not keep it) and D = Σ dO·O;
// * flash_bwd_kv_kernel, one block per (64-key tile, kv head, batch row):
//   holds its K and V tile, loops over the group's query heads and their
//   query tiles, skipping a tile without a valid pair, recomputes P =
//   exp(scale qkᵀ - lse) and dS = P (dO vᵀ - D), and sums dV += Pᵀ dO and
//   dK += dSᵀ Q in registers; writes dk and dv once;
// * flash_bwd_q_kernel, one block per (64-query tile, q head, batch row):
//   loops over the key tiles with a valid pair, recomputes P and dS and
//   sums dQ += dS K; writes dq once.
// Tiles of 64 x 64 on a 16 x 16 thread grid: thread (ty, tx) holds the
// scores of rows ty + 16a and columns tx + 16b, and the sums of rows
// ty + 16a at columns tx + 16c. Shared rows are padded to an odd number
// of 32-bit words, so a warp's column reads fall on distinct banks.

#include "common.cuh"

namespace {

using rt::Cvt;
using rt::NEG_INF;
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
// lse and D of each query row
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ o, const T* __restrict__ dout,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos, float* __restrict__ lse,
                      float* __restrict__ delta, int s, int S, int nq,
                      int nkv, int causal, int window, float scale) {
  using C = Tile<T, HD>;
  constexpr int LD = C::LD, NC = C::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + C::ELEMS;
  int* sqp = reinterpret_cast<int*>(sk + C::ELEMS);
  int* skp = sqp + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_rows<T, HD>(sq, q + ((size_t)bi * s * nq + h) * HD, q0, s, nq, tid);
  if (tid < BQ) sqp[tid] = q0 + tid < s ? qpos[(size_t)bi * s + q0 + tid] : -1;

  // D = Σ dO·O of rows ty + 16i; the 16 lanes of a half-warp share a row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float acc = 0.f;
    if (row < s) {
      const size_t base = (((size_t)bi * s + row) * nq + h) * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc = fmaf(Cvt<T>::to_f(dout[base + tx + 16 * c]),
                   Cvt<T>::to_f(o[base + tx + 16 * c]), acc);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (tx == 0 && row < s) delta[((size_t)bi * nq + h) * s + row] = acc;
  }

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  __syncthreads();
  int myq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) myq[i] = sqp[ty + 16 * i];

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
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = (vmask >> (i * 4 + j)) & 1u;
        rs += ok ? expf(sc[i][j] - mnew) : 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * expf(m[i] - mnew) + rs;
      m[i] = mnew;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    // a row without a valid key: every pair is masked in the other two
    // kernels, so its lse is never read
    if (tx == 0 && row < s)
      lse[((size_t)bi * nq + h) * s + row] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
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

template <typename T, int HD>
constexpr size_t prep_smem() {
  return 2 * (size_t)Tile<T, HD>::ELEMS * sizeof(T) + 2 * 64 * sizeof(int);
}

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

template <typename T, int HD>
int launch(const void* q_, const void* k_, const void* v_, const void* o_,
           const void* do_, const void* qpos_, const void* kpos_, void* dq_,
           void* dk_, void* dv_, float* lse, float* delta, int b, int s,
           int S, int nq, int nkv, int causal, int window, float scale,
           cudaStream_t st) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* o = static_cast<const T*>(o_);
  const T* dout = static_cast<const T*>(do_);
  const int* qpos = static_cast<const int*>(qpos_);
  const int* kpos = static_cast<const int*>(kpos_);
  constexpr size_t sp = prep_smem<T, HD>(), sm = main_smem<T, HD>();
  cudaError_t e = allow_smem(flash_bwd_prep_kernel<T, HD>, sp);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_kv_kernel<T, HD>, sm);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_q_kernel<T, HD>, sm);
  if (e != cudaSuccess) return (int)e;
  const dim3 gq((s + BQ - 1) / BQ, nq, b), gk((S + BK - 1) / BK, nkv, b);
  flash_bwd_prep_kernel<T, HD><<<gq, NT, sp, st>>>(
      q, k, o, dout, qpos, kpos, lse, delta, s, S, nq, nkv, causal, window,
      scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_kv_kernel<T, HD><<<gk, NT, sm, st>>>(
      q, k, v, dout, qpos, kpos, lse, delta, static_cast<T*>(dk_),
      static_cast<T*>(dv_), s, S, nq, nkv, causal, window, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_q_kernel<T, HD><<<gq, NT, sm, st>>>(
      q, k, v, dout, qpos, kpos, lse, delta, static_cast<T*>(dq_), s, S, nq,
      nkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const void* qpos,
              const void* kpos, void* dq, void* dk, void* dv, float* lse,
              float* delta, int b, int s, int S, int nq, int nkv, int causal,
              int window, float scale, cudaStream_t st) {
  if (dtype == rt::DTYPE_BF16)
    return launch<__nv_bfloat16, HD>(q, k, v, o, dout, qpos, kpos, dq, dk, dv,
                                     lse, delta, b, s, S, nq, nkv, causal,
                                     window, scale, st);
  if (dtype == rt::DTYPE_F32)
    return launch<float, HD>(q, k, v, o, dout, qpos, kpos, dq, dk, dv, lse,
                             delta, b, s, S, nq, nkv, causal, window, scale,
                             st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq (b, s, nq, hd); k, v, dk, dv (b, S, nkv, hd); qpos (b, s)
// and kpos (b, S) int32; lse and delta (b, nq, s) f32 scratch. All
// contiguous on the current device, the data 16-byte aligned, s and S > 0.
// window <= 0 means no window. Returns 0 or a CUDA error code.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* qpos,
                                   const void* kpos, void* dq, void* dk,
                                   void* dv, void* lse, void* delta, int b,
                                   int s, int S, int nq, int nkv, int hd,
                                   int dtype, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (hd) {
    case 32: return launch_hd<32>(dtype, q, k, v, o, dout, qpos, kpos, dq, dk, dv, l, d, b, s, S, nq, nkv, causal, window, scale, st);
    case 64: return launch_hd<64>(dtype, q, k, v, o, dout, qpos, kpos, dq, dk, dv, l, d, b, s, S, nq, nkv, causal, window, scale, st);
    case 128: return launch_hd<128>(dtype, q, k, v, o, dout, qpos, kpos, dq, dk, dv, l, d, b, s, S, nq, nkv, causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
