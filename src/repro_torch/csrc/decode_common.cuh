// Split-K flash-decode shared by the dense and the paged decode kernels.
//
// One query token per batch row attends over its KV. The device code is
// one template over a KV source: the dense ring-buffer cache (kv_pos marks
// empty slots) or the paged pool read through the block table. The source
// maps token t of row b to a (token, kv head) row of K/V and says whether
// it is a valid key for the query.
//
// What bounds it on the card: bytes. Each K/V element read is used for
// g multiply-adds per product (g = q heads per kv head, 4 on the serving
// path), far below the ~295 flops a byte at which the H100 stops being
// memory-bound, so the least time is the K/V bytes over 3.35 TB/s.
//
// What the design does about it:
// * Pass 1 (decode_partial_kernel): one block per (batch, kv head, split of
//   `split_len` tokens), so a batch of 4 x 8 kv heads still puts hundreds of
//   blocks on the 132 SMs. The g query heads of a kv head are handled
//   together: each K/V row is read once from memory for all of them. A
//   warp takes DEC_U tokens at a time with the 32 lanes across hd (one
//   vector load per lane), so several rows are in flight per warp; invalid
//   tokens (empty ring slots, keys past the window, pages past the slot's
//   length) are never read. Each warp keeps an online softmax in
//   registers; the warps of a block merge in shared memory and write one
//   partial (max, sum, accumulator) per split.
// * Pass 2 (decode_combine_kernel): per (batch, kv head), merges the
//   splits' partials with the usual max-rescaling and divides by the sum
//   (a sum of 0, no valid key at all, gives 0 as the TPU kernel does).
#pragma once

#include "common.cuh"

namespace rt {

constexpr int DEC_WARPS = 4;
constexpr int DEC_U = 4;      // tokens per warp per step
constexpr int MAXG = 8;       // largest q-heads-per-kv-head group handled

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// partials: m/l (b, nkv, nsplit, MAXG), acc (b, nkv, nsplit, MAXG, HD), f32
template <typename T, int HD, class KV>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, KV kv,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      float* __restrict__ acc_part, int nq, int nkv,
                      int nsplit, int split_len, int window, float scale) {
  constexpr int EPL = HD / 32;               // elements of hd per lane
  __shared__ float s_m[DEC_WARPS][MAXG];
  __shared__ float s_l[DEC_WARPS][MAXG];
  __shared__ float s_acc[DEC_WARPS][MAXG][HD];

  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int g = nq / nkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qp = kv.qpos_of(bi);
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, kv.end(bi));

  float qf[MAXG][EPL], m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qf[gi][e] = 0.f;
      acc[gi][e] = 0.f;
    }
    if (gi < g)
      load_vec<T, EPL>(q + ((size_t)bi * nq + kvh * g + gi) * HD + lane * EPL,
                       qf[gi]);
  }

  for (int t0 = t_begin + warp * DEC_U; t0 < t_end;
       t0 += DEC_WARPS * DEC_U) {
    bool ok[DEC_U];
    size_t row[DEC_U];
    float kf[DEC_U][EPL], vf[DEC_U][EPL];
#pragma unroll
    for (int u = 0; u < DEC_U; ++u) {
      const int t = t0 + u;
      ok[u] = t < t_end && kv.valid(bi, t, qp, window);   // warp-uniform
      row[u] = ok[u] ? kv.row(bi, t, kvh) * HD + lane * EPL : 0;
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      if (ok[u]) {
        load_vec<T, EPL>(kc + row[u], kf[u]);
        load_vec<T, EPL>(vc + row[u], vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < DEC_U; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        if (gi >= g) break;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qf[gi][e], kf[u][e], part);
        const float sc = warp_sum(part) * scale;
        const float mnew = fmaxf(m[gi], sc);
        const float alpha = expf(m[gi] - mnew);
        const float p = expf(sc - mnew);
        l[gi] = l[gi] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[gi][e] = fmaf(p, vf[u][e], acc[gi][e] * alpha);
        m[gi] = mnew;
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    if (gi >= g) break;
    if (lane == 0) {
      s_m[warp][gi] = m[gi];
      s_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][gi][lane * EPL + e] = acc[gi][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * HD; idx += blockDim.x) {
    const int gi = idx / HD, d = idx % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, s_m[w][gi]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float c = expf(s_m[w][gi] - M);
      L = fmaf(s_l[w][gi], c, L);
      A = fmaf(s_acc[w][gi][d], c, A);
    }
    const size_t base = ((size_t)(bi * nkv + kvh) * nsplit + split) * MAXG + gi;
    if (d == 0) {
      m_part[base] = M;
      l_part[base] = L;
    }
    acc_part[base * HD + d] = A;
  }
}

// out (b, nq, HD) in T; one block of HD threads per (kv head, batch row)
template <typename T, int HD>
__global__ void decode_combine_kernel(const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      const float* __restrict__ acc_part,
                                      T* __restrict__ out, int nq, int nkv,
                                      int nsplit) {
  const int kvh = blockIdx.x, bi = blockIdx.y, d = threadIdx.x;
  const int g = nq / nkv;
  for (int gi = 0; gi < g; ++gi) {
    const size_t base = (size_t)(bi * nkv + kvh) * nsplit * MAXG + gi;
    float M = NEG_INF;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, m_part[base + (size_t)s * MAXG]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t i = base + (size_t)s * MAXG;
      const float c = expf(m_part[i] - M);
      L = fmaf(l_part[i], c, L);
      A = fmaf(acc_part[i * HD + d], c, A);
    }
    out[((size_t)bi * nq + kvh * g + gi) * HD + d] =
        Cvt<T>::from_f(A / (L == 0.f ? 1.f : L));
  }
}

template <typename T, int HD, class KV>
int decode_launch(const void* q, const void* k, const void* v, const KV& kv,
                  void* out, void* m_part, void* l_part, void* acc_part,
                  int b, int nq, int nkv, int nsplit, int split_len,
                  int window, float scale, cudaStream_t st) {
  dim3 g1(nsplit, nkv, b);
  decode_partial_kernel<T, HD, KV><<<g1, DEC_WARPS * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv, static_cast<float*>(m_part),
      static_cast<float*>(l_part), static_cast<float*>(acc_part), nq, nkv,
      nsplit, split_len, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2(nkv, b);
  decode_combine_kernel<T, HD><<<g2, HD, 0, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), nq, nkv,
      nsplit);
  return (int)cudaGetLastError();
}

template <class KV>
int decode_dispatch(int dtype, int hd, const void* q, const void* k,
                    const void* v, const KV& kv, void* out, void* m_part,
                    void* l_part, void* acc_part, int b, int nq, int nkv,
                    int nsplit, int split_len, int window, float scale,
                    cudaStream_t st) {
#define REPRO_DECODE_CASE(TT, HH)                                            \
  return decode_launch<TT, HH, KV>(q, k, v, kv, out, m_part, l_part,         \
                                   acc_part, b, nq, nkv, nsplit, split_len,  \
                                   window, scale, st)
  if (dtype == DTYPE_F32) {
    switch (hd) {
      case 32: REPRO_DECODE_CASE(float, 32);
      case 64: REPRO_DECODE_CASE(float, 64);
      case 128: REPRO_DECODE_CASE(float, 128);
    }
  } else if (dtype == DTYPE_BF16) {
    switch (hd) {
      case 32: REPRO_DECODE_CASE(__nv_bfloat16, 32);
      case 64: REPRO_DECODE_CASE(__nv_bfloat16, 64);
      case 128: REPRO_DECODE_CASE(__nv_bfloat16, 128);
    }
  }
#undef REPRO_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt
