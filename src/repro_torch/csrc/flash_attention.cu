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
// costs 4*hd flops per head. At the serving path's prefill (s = S = 3072,
// 32 heads, hd 128) that is ~77 GFLOP a layer after the causal half, while
// q, k, v and the output are ~30 MB: over 2,000 flops a byte, far above the
// ~295 at which the H100's bf16 math, not its memory, is the limit.
//
// What the design does about it:
// * One block per (batch, q head, 64-query tile). 256 threads as a 16x16
//   grid; thread (ty, tx) owns query rows ty+16i and key columns tx+16j
//   (i, j < 4) of the 64x64 score tile, and rows ty+16i x output columns
//   tx+16c of the accumulator, so the same rows meet in both products and
//   the online-softmax state (max, sum, accumulator) stays in registers
//   across key tiles. (The TPU kernel kept it in VMEM scratch across
//   sequential grid steps; here a loop inside the block replaces them.)
// * Key tiles with no valid (query, key) pair -- future keys under the
//   causal mask, padding -- are detected from the position arrays and
//   skipped before their K/V are loaded. That removes half the work of a
//   causal prefill and all the work of the engine's padded tail.
// * K/V tiles sit in shared memory in their own dtype with rows padded to
//   an odd number of 32-bit words, so the column-strided reads of the QK^T
//   product hit distinct banks.
// * Products run as f32 FMAs on the CUDA cores. Moving them onto the tensor
//   cores (wgmma, TMA-fed tiles) is the next step for speed.
// * Probabilities are re-masked to 0 after the exponential: while every key
//   seen so far is masked, the running max is -1e30 and exp(s - max) = 1.

#include "common.cuh"

namespace {

using rt::Cvt;
using rt::NEG_INF;

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
                 const int* __restrict__ kpos, T* __restrict__ out, int s,
                 int S, int nq, int nkv, int causal, int window,
                 float scale) {
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
    T* o = out + (((size_t)bi * s + row) * nq + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = Cvt<T>::from_f(acc[i][c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, int b, int s, int S, int nq, int nkv,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>();
  cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((s + BQ - 1) / BQ, nq, b);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<T*>(out), s, S, nq, nkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* qpos, const void* kpos, void* out, int b, int s,
              int S, int nq, int nkv, int causal, int window, float scale,
              cudaStream_t st) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, qpos, kpos, out, b, s, S, nq, nkv, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, qpos, kpos, out, b, s, S, nq, nkv, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, qpos, kpos, out, b, s, S, nq, nkv, causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (b, s, nq, hd), k/v (b, S, nkv, hd), qpos (b, s), kpos (b, S) int32,
// out (b, s, nq, hd); all contiguous, on the current device. window <= 0
// means no window. Returns the CUDA error code of the launch (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* qpos,
                                   const void* kpos, void* out, int b, int s,
                                   int S, int nq, int nkv, int hd, int dtype,
                                   int causal, int window, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_F32)
    return launch_hd<float>(hd, q, k, v, qpos, kpos, out, b, s, S, nq, nkv, causal, window, scale, st);
  if (dtype == rt::DTYPE_BF16)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, qpos, kpos, out, b, s, S, nq, nkv, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
