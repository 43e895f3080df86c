// Mamba2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the TPU kernel `ssd_scan` of src/repro/kernels/ssd_scan/kernel.py
// (pallas_call at :99). For each (batch, head) the chunks of the sequence
// run in order and carry a (P, N) f32 state; within a chunk
//   y     = (C·Bᵀ ∘ tril exp(cum_i − cum_j)) @ (x·dt)
//           + (C·exp(cum)) @ stateᵀ + D·x
//   state = state·exp(cum_L) + xᵀ @ (B·exp(cum_L − cum)·dt)
// with cum the prefix sum of dt·a over the chunk. B and C are shared by
// all heads. x, B, C and y are f32 or bf16; dt, a, D and the state f32.
//
// What bounds it on the card: at the serving shape (B 1, S 2048, H 32,
// P 64, N 128, bf16) the bytes, ≈ 20 MB (x and y 8.4 MB each, B and C,
// dt, the initial and final state), ≈ 6 µs at 3.35 TB/s; the operations,
// ≈ 2.4 GFLOP counted over 64-token sub-chunks, take ≈ 2.5 µs at
// 989 TFLOP/s. What keeps a simple kernel far from either roof is the
// dependence between chunks: the scan is a loop of short, synchronised
// steps, each small enough to be bound by shared-memory traffic.
//
// What the design does about it:
// - Order. A TPU grid runs its chunk axis in order with the state in
//   VMEM scratch; CUDA blocks run in no order. So one block owns a
//   (batch, head, slice of PB = 16 state rows) and walks the chunks
//   itself with its slice of the state in shared memory. The P rows of
//   the state are independent (y[:, p] and state[p, :] read only
//   x[:, p]), so the split gives B·H·P/16 = 128 blocks at the serving
//   shape instead of B·H = 32, on a 132-SM card.
// - C·Bᵀ. It does not depend on the head, and every one of the H·P/16
//   blocks of a batch row would otherwise recompute it (it is the largest
//   single term of the work). A first pass (`cb_kernel`) writes it once
//   per (batch, sub-chunk), lower triangle only; the scan reads its tile
//   back from L2.
// - Shared memory. A 256 × 256 f32 score tile is 256 KB, over the 227 KB
//   a block may have. The kernel walks the sequence in its own sub-chunks
//   of SUB = 64 tokens whatever the caller's chunk: the SSD result does
//   not depend on the chunk length, apart from rounding. A last,
//   shorter sub-chunk is masked, so S need not be a multiple of 64.
// - Never exp of a positive segment sum: exp(cum_i − cum_j) is formed
//   only where j ≤ i (0 elsewhere, never a 0/1 mask times inf).
// - Simple and right first: f32 FMAs on the CUDA cores, rows of B, C and
//   the state padded to an odd number of words so column reads hit
//   distinct banks. Tensor cores (wgmma) and TMA are later work.

#include "common.cuh"

namespace {

using rt::Cvt;

constexpr int SUB = 64;   // tokens per sub-chunk
constexpr int PB = 16;    // state rows (of head_dim P) per block
constexpr int NT = 256;   // threads per block
constexpr int ROWS = NT / PB;          // 16 output rows per pass
constexpr int RPT = SUB / ROWS;        // 4 output rows per thread

template <int N>
constexpr size_t cb_smem() {
  return sizeof(float) * 2 * SUB * (N + 1);
}

template <int N>
constexpr size_t scan_smem() {
  return sizeof(float) * (2 * SUB * (N + 1) + PB * (N + 1) +
                          SUB * (SUB + 1) + SUB * PB + 4 * SUB);
}

// Pass 1: cb[bi][s][i][j] = C_i · B_j over sub-chunk s for j ≤ i, 0 above
// the diagonal and outside the sequence. Grid (nsub, B).
template <typename T, int N>
__global__ void __launch_bounds__(NT)
    cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
              float* __restrict__ cb, int S, int nsub) {
  constexpr int LD = N + 1;
  extern __shared__ float smem[];
  float* sB = smem;
  float* sC = sB + SUB * LD;
  const int sub = blockIdx.x, bi = blockIdx.y;
  const int t0 = sub * SUB;
  const int len = min(SUB, S - t0);
  const size_t base = ((size_t)bi * S + t0) * N;
  for (int e = threadIdx.x; e < SUB * N; e += NT) {
    const int i = e / N, n = e % N;
    const bool in = i < len;
    sB[i * LD + n] = in ? Cvt<T>::to_f(bm[base + e]) : 0.f;
    sC[i * LD + n] = in ? Cvt<T>::to_f(cm[base + e]) : 0.f;
  }
  __syncthreads();
  float* out = cb + ((size_t)bi * nsub + sub) * SUB * SUB;
  for (int e = threadIdx.x; e < SUB * SUB; e += NT) {
    const int i = e / SUB, j = e % SUB;
    float acc = 0.f;
    if (j <= i) {
#pragma unroll 8
      for (int n = 0; n < N; ++n) acc += sC[i * LD + n] * sB[j * LD + n];
    }
    out[e] = acc;
  }
}

// Pass 2: the scan. Grid (B·H, P / PB); one block walks all sub-chunks
// of its (batch, head, row slice) in order.
template <typename T, int N>
__global__ void __launch_bounds__(NT)
    scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dskip,
                const float* __restrict__ init,
                const float* __restrict__ cb, T* __restrict__ y,
                float* __restrict__ fin, int S, int H, int P, int nsub) {
  constexpr int LD = N + 1;        // odd row stride: distinct banks
  constexpr int LDS = SUB + 1;
  constexpr int G = NT / N;        // state-update row groups
  constexpr int R = PB / G;        // state rows per thread
  static_assert(NT % N == 0 && PB % G == 0, "N must divide 256, >= 16");
  extern __shared__ float smem[];
  float* sB = smem;                // SUB x LD
  float* sC = sB + SUB * LD;       // SUB x LD
  float* sSt = sC + SUB * LD;      // PB x LD: this block's state rows
  float* sS = sSt + PB * LD;       // SUB x LDS: decayed, dt-scaled C·Bᵀ
  float* sX = sS + SUB * LDS;      // SUB x PB
  float* sDt = sX + SUB * PB;      // SUB
  float* sCum = sDt + SUB;         // SUB: prefix sum of dt·a
  float* sW = sCum + SUB;          // SUB: exp(cum_last − cum_j)·dt_j
  float* sE = sW + SUB;            // SUB: exp(cum_i)

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / H, h = blockIdx.x % H;
  const int p0 = blockIdx.y * PB;
  const float ah = a[h], dh = dskip[h];
  const size_t st_base = (((size_t)bi * H + h) * P + p0) * N;

  for (int e = tid; e < PB * N; e += NT)
    sSt[(e / N) * LD + e % N] = init ? init[st_base + e] : 0.f;

  const int pcol = tid % PB, r0 = tid / PB;    // output mapping
  const int ncol = tid % N, g0 = tid / N;      // state-update mapping

  for (int sub = 0; sub < nsub; ++sub) {
    const int t0 = sub * SUB;
    const int len = min(SUB, S - t0);
    const size_t bc_base = ((size_t)bi * S + t0) * N;
    for (int e = tid; e < SUB * N; e += NT) {
      const int i = e / N, n = e % N;
      const bool in = i < len;
      sB[i * LD + n] = in ? Cvt<T>::to_f(bm[bc_base + e]) : 0.f;
      sC[i * LD + n] = in ? Cvt<T>::to_f(cm[bc_base + e]) : 0.f;
    }
    for (int e = tid; e < SUB * PB; e += NT) {
      const int i = e / PB, p = e % PB;
      sX[e] = i < len ? Cvt<T>::to_f(
                            x[(((size_t)bi * S + t0 + i) * H + h) * P + p0 + p])
                      : 0.f;
    }
    if (tid < SUB)
      sDt[tid] = tid < len ? dt[((size_t)bi * S + t0 + tid) * H + h] : 0.f;
    __syncthreads();

    // prefix sum of dt·a over the sub-chunk (warp 0, two halves of 32);
    // steps past the sequence add 0, so cum[SUB-1] is the last real one
    if (tid < 32) {
      float v0 = sDt[tid] * ah, v1 = sDt[tid + 32] * ah;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (tid >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      sCum[tid] = v0;
      sCum[tid + 32] = v1;
    }
    __syncthreads();

    const float cum_last = sCum[SUB - 1];
    if (tid < SUB) {
      sW[tid] = expf(cum_last - sCum[tid]) * sDt[tid];
      sE[tid] = expf(sCum[tid]);
    }
    const float* cbt = cb + ((size_t)bi * nsub + sub) * SUB * SUB;
    for (int e = tid; e < SUB * SUB; e += NT) {
      const int i = e / SUB, j = e % SUB;
      sS[i * LDS + j] =
          j <= i ? cbt[e] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
    }
    __syncthreads();

    // y rows r0 + ROWS·k, column pcol: intra-chunk term (sS is 0 above
    // the diagonal, so j runs to this thread's last row), the carried
    // state's term, and the skip
    {
      float diag[RPT], off[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k) diag[k] = off[k] = 0.f;
      const int jend = r0 + ROWS * (RPT - 1) + 1;
      for (int j = 0; j < jend; ++j) {
        const float xv = sX[j * PB + pcol];
#pragma unroll
        for (int k = 0; k < RPT; ++k)
          diag[k] += sS[(r0 + ROWS * k) * LDS + j] * xv;
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float s = sSt[pcol * LD + n];
#pragma unroll
        for (int k = 0; k < RPT; ++k) off[k] += sC[(r0 + ROWS * k) * LD + n] * s;
      }
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int i = r0 + ROWS * k;
        if (i < len)
          y[(((size_t)bi * S + t0 + i) * H + h) * P + p0 + pcol] =
              Cvt<T>::from_f(diag[k] + sE[i] * off[k] +
                             dh * sX[i * PB + pcol]);
      }
    }
    __syncthreads();   // every read of the old state is done

    // state rows g0 + G·k, column ncol: decay the carried state and add
    // this sub-chunk's inputs; each thread writes only its own entries
    {
      const float decay = expf(cum_last);
      float acc[R];
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = sSt[(g0 + G * k) * LD + ncol] * decay;
      for (int j = 0; j < SUB; ++j) {
        const float bw = sB[j * LD + ncol] * sW[j];
#pragma unroll
        for (int k = 0; k < R; ++k) acc[k] += sX[j * PB + g0 + G * k] * bw;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) sSt[(g0 + G * k) * LD + ncol] = acc[k];
    }
    __syncthreads();
  }

  for (int e = tid; e < PB * N; e += NT)
    fin[st_base + e] = sSt[(e / N) * LD + e % N];
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, const void* d,
                   const void* init, void* y, void* fin, void* cb, int B,
                   int S, int H, int P, cudaStream_t stream) {
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err = cudaFuncSetAttribute(
        cb_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cb_smem<N>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(scan_kernel<T, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)scan_smem<N>());
    if (err != cudaSuccess) return err;
    attrs_set = true;
  }
  const int nsub = (S + SUB - 1) / SUB;
  cb_kernel<T, N><<<dim3(nsub, B), NT, cb_smem<N>(), stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<float*>(cb), S, nsub);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<T, N><<<dim3(B * H, P / PB), NT, scan_smem<N>(), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<const float*>(init), static_cast<const float*>(cb),
      static_cast<T*>(y), static_cast<float*>(fin), S, H, P, nsub);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int N, const void* x, const void* dt, const void* a,
                       const void* b, const void* c, const void* d,
                       const void* init, void* y, void* fin, void* cb, int B,
                       int S, int H, int P, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, 16>(x, dt, a, b, c, d, init, y, fin, cb, B, S, H, P,
                           stream);
    case 64:
      return launch<T, 64>(x, dt, a, b, c, d, init, y, fin, cb, B, S, H, P,
                           stream);
    case 128:
      return launch<T, 128>(x, dt, a, b, c, d, init, y, fin, cb, B, S, H, P,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, S, H, P), dt (B, S, H) f32, a (H,) f32, b/c (B, S, N), d (H,) f32,
// init (B, H, P, N) f32 or null, y (B, S, H, P), fin (B, H, P, N) f32,
// cb scratch (B, ceil(S/64), 64, 64) f32; x/b/c/y share `dtype`
// (0 f32, 1 bf16); P a multiple of 16, N in {16, 64, 128}. Returns
// the CUDA error code of the launches (0 = ok).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* d,
                            const void* init, void* y, void* fin, void* cb,
                            int B, int S, int H, int P, int N, int dtype,
                            void* stream) {
  if (P % PB != 0 || S <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DTYPE_F32)
    return dispatch_n<float>(N, x, dt, a, b, c, d, init, y, fin, cb, B, S,
                             H, P, s);
  if (dtype == rt::DTYPE_BF16)
    return dispatch_n<__nv_bfloat16>(N, x, dt, a, b, c, d, init, y, fin, cb,
                                     B, S, H, P, s);
  return cudaErrorInvalidValue;
}
