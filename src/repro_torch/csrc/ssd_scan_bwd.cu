// Gradient of the Mamba2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces no TPU kernel: the reference trains through its jnp
// `ssd_chunked` (src/repro/models/ssm.py:57), whose gradient JAX derives,
// and its Pallas `ssd_scan` has no VJP. This is the card's counterpart of
// that gradient, for the forward kernel of ssd_scan.cu. Its plain version,
// step for step, is `ssd_chunked_bwd` in kernels/ssd_scan/ref.py.
//
// Per batch row, head and state chunk of L tokens (the forward's chunks:
// the state before each chunk, S, is the forward's `prev` scratch), with
// l_t = dt_t·a, cum the prefix sum of l over the chunk, xdt_j = dt_j·x_j
// and G the gradient of the state after the chunk:
//   G before     = exp(cum_last)·G + Σ_i exp(cum_i)·dy_i ⊗ C_i
//   dxdt_j       = Σ_{i≥j} (C_i·B_j) exp(cum_i − cum_j) dy_i
//                  + exp(cum_last − cum_j)·G B_j
//   dC_i         = Σ_{j≤i} exp(cum_i − cum_j)(dy_i·xdt_j) B_j
//                  + exp(cum_i)·Sᵀ dy_i                  (summed over heads)
//   dB_j         = Σ_{i≥j} exp(cum_i − cum_j)(dy_i·xdt_j) C_i
//                  + exp(cum_last − cum_j)·Gᵀ xdt_j      (summed over heads)
//   dcum_i       = Σ_j w_ij − Σ_i' w_i'i + off-diagonal and chunk-end terms,
//                  w_ij = (C_i·B_j) exp(cum_i − cum_j)(dy_i·xdt_j)
//   dl           = reverse cumulative sum of dcum over the chunk;
//   dx = dt·dxdt + D·dy, ddt = x·dxdt + a·dl, da = Σ dt·dl, dD = Σ dy·x.
//
// What bounds it on the card: at mamba2-370m's training shape (B 4,
// S 2048, H 32, P 64, N 128, bf16) the bytes, ≈ 120 MB (x, dy and dx
// 33.5 MB each, the forward's states, B, C and their gradients, dt and
// ddt), ≈ 0.04 ms at 3.35 TB/s; its products over 64-token tiles are
// ≈ 25 GFLOP, ≈ 0.03 ms at 989 TFLOP/s. This first version is simple and
// right, not fast: every product is recomputed where a pass needs it
// (C·Bᵀ and dy·xᵀ tiles in three passes), and scratch crosses device
// memory between the passes.
//
// Seven kernels a call, in order on the caller's stream:
//  1. `ssd_dstate_kernel`, one block per (batch, chunk, head): the chunk's
//     own state gradient Σ_i exp(cum_i)·dy_i ⊗ C_i (P × N) and its sum of
//     dt·a, like the forward's state pass.
//  2. `ssd_drecur_kernel`, elementwise over (batch, head, P, N), in reverse
//     over the chunks: G after each chunk, and the initial state's
//     gradient.
//  3. `ssd_drow_kernel`, one block per (batch, chunk, head, 64-token tile
//     of rows i): the row sums of the pair weights and the off-diagonal
//     term exp(cum_i)·dy_i·(S C_i), a first part of dcum.
//  4. `ssd_dcol_kernel`, one block per (batch, chunk, head, tile of keys
//     j): dxdt (the scores' transpose times dy, and G's term), hence dx and
//     x·dxdt; the column sums of the pair weights and the chunk-end terms,
//     the second part of dcum; the tile's sums of u_j and of dy·x.
//  5. `ssd_dc_kernel` and 6. `ssd_db_kernel`, one block per (batch, chunk,
//     tile) walking every head in order: dC and dB of the tile's tokens,
//     each head's terms in registers, their sum over the heads in shared
//     memory in f64.
//  7. `ssd_dfinish_kernel`, one block per head walking the batch and the
//     chunks in order: dl by a reverse scan of dcum, ddt, and da and dD.
// No float atomics: every result is written by one thread, every sum is
// taken in a fixed order, and two calls give the same bits. The long sums
// (over the heads, the chunk's tokens, a state's P × N elements, the batch
// and the sequence: the pair weights' row and column sums, dl, da, dD)
// are taken in f64, the products of a tile in f32: in f32 at the training
// shape the plain version's own sums round up to 3x the 1e-4 of the card's
// check away from an f64 run, and this kernel's stay within it.
//
// Numbers: the decays exp(cum_i − cum_j) are formed only where j ≤ i,
// with the exponent clamped at 0, as in the forward; tokens past the
// sequence are zero-filled (x, dy, B, C, dt), so the last chunk may be
// ragged. Products, bf16: mma.sync m16n8k16 on the tensor cores with f32
// accumulators, the operands read from shared memory held as f32; an
// operand that is not exact in bf16 (a decayed score, a scaled row, the
// states) is split into a bf16 high and low part and both are multiplied
// (≈ 16 bits of mantissa), as the forward does. x, dy, B and C are exact
// in bf16. Products, f32: the same tiles with FMAs on the CUDA cores.

#include <type_traits>

#include "decode_common.cuh"

namespace {

using rt::Cvt;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;       // tokens a tile
constexpr int NT = 128;        // threads of a tile block: 4 warps of 16 rows
constexpr int MAX_L = 256;     // longest state chunk (the forward's)
constexpr int PS = 64;         // head-dim columns a slice
constexpr int PADF = 4;        // floats of padding a shared-memory row
constexpr int LDP = PS + PADF;      // row stride of a head-dim slice
constexpr int LDT = TILE + PADF;    // row stride of a warp's score tile
constexpr int RT_THREADS = 256;     // threads of a recurrence block
constexpr int FIN_THREADS = MAX_L;  // threads of the finishing block

template <typename T>
constexpr bool IS_BF16 = std::is_same<T, bf16>::value;

// two floats as packed bf16 pairs: the rounded values and what rounding
// left, so that hi + lo keeps ≈ 16 bits of mantissa
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = rt::pack_bf16(a - f.x, b - f.y);
}

template <int NT8>
__device__ __forceinline__ void zero(float (&acc)[NT8][4]) {
#pragma unroll
  for (int t = 0; t < NT8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
}

// fn(v, t, e) on this lane's elements of a TILE × N array in the m16n8
// accumulator layout, rows r0 and r0 + 8: v is element (r0 + 8 (e / 2),
// 8 t + q2 + e % 2), as acc[t][e] is; no lane touches another's
template <int N, typename F>
__device__ __forceinline__ void for_own(double* tot, int r0, int q2, F fn) {
#pragma unroll
  for (int t = 0; t < N / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      fn(tot[(r0 + 8 * (e >> 1)) * N + 8 * t + q2 + (e & 1)], t, e);
}

// acc (16 rows × 8·nt8 columns, the m16n8 accumulator layout: a lane holds
// rows g and g + 8, columns 8t + 2q and 8t + 2q + 1, g = lane / 4,
// q = lane % 4) += A · B over K (a multiple of 16), both in shared memory
// as f32: A(m, k) = a[m·sam + k·sak] times s0 on row g and s1 on row g + 8,
// B(k, n) = b[k·sbk + n·sbn]. TC: bf16 on the tensor cores, an operand
// split into a high and a low part where SA / SB; else f32 FMAs.
template <bool TC, bool SA, bool SB, int NT8>
__device__ __forceinline__ void mm(float (&acc)[NT8][4], int nt8,
                                   const float* a, int sam, int sak, float s0,
                                   float s1, const float* b, int sbk, int sbn,
                                   int K) {
  const int l = threadIdx.x & 31, g = l >> 2, q2 = 2 * (l & 3);
  const float* a0 = a + g * sam;
  const float* a1 = a + (g + 8) * sam;
  if constexpr (TC) {
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int k = k0 + q2;
      uint32_t ah[4], al[4];
      split2(a0[k * sak] * s0, a0[(k + 1) * sak] * s0, ah[0], al[0]);
      split2(a1[k * sak] * s1, a1[(k + 1) * sak] * s1, ah[1], al[1]);
      split2(a0[(k + 8) * sak] * s0, a0[(k + 9) * sak] * s0, ah[2], al[2]);
      split2(a1[(k + 8) * sak] * s1, a1[(k + 9) * sak] * s1, ah[3], al[3]);
#pragma unroll
      for (int t = 0; t < NT8; ++t) {
        if (t < nt8) {
          const float* bn = b + (8 * t + g) * sbn;
          uint32_t bh[2], bl[2];
          split2(bn[k * sbk], bn[(k + 1) * sbk], bh[0], bl[0]);
          split2(bn[(k + 8) * sbk], bn[(k + 9) * sbk], bh[1], bl[1]);
          rt::mma_16816(acc[t], ah, bh);
          if constexpr (SA) rt::mma_16816(acc[t], al, bh);
          if constexpr (SB) rt::mma_16816(acc[t], ah, bl);
        }
      }
    }
  } else {
    for (int k = 0; k < K; ++k) {
      const float v0 = a0[k * sak] * s0, v1 = a1[k * sak] * s1;
#pragma unroll
      for (int t = 0; t < NT8; ++t) {
        if (t < nt8) {
          const float* bk = b + k * sbk + (8 * t + q2) * sbn;
          const float w0 = bk[0], w1 = bk[sbn];
          acc[t][0] = fmaf(v0, w0, acc[t][0]);
          acc[t][1] = fmaf(v0, w1, acc[t][1]);
          acc[t][2] = fmaf(v1, w0, acc[t][2]);
          acc[t][3] = fmaf(v1, w1, acc[t][3]);
        }
      }
    }
  }
}

// `rows` rows of `cols` elements (a multiple of 16 bytes) from global rows
// `gs` elements apart, 16-byte aligned, into shared f32 rows `lds` apart;
// rows at or past `nvalid` are zero, and row r is multiplied by scale[r]
// where `scale` is given. All NT threads of the block.
template <typename T>
__device__ __forceinline__ void load_f(float* s, int lds, const T* g,
                                       size_t gs, int rows, int nvalid,
                                       int cols,
                                       const float* scale = nullptr) {
  constexpr int CH = 16 / (int)sizeof(T);
  const int cpr = cols / CH;
  for (int e = threadIdx.x; e < rows * cpr; e += NT) {
    const int r = e / cpr, k = (e % cpr) * CH;
    float v[CH];
    if (r < nvalid) {
      rt::load_vec<T, CH>(g + r * gs + k, v);
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) v[i] = 0.f;
    }
    const float sc = scale ? scale[r] : 1.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) s[r * lds + k + i] = v[i] * sc;
  }
}

// `rows` rows of a state (rows of N) as f32 into shared rows `lds` apart:
// bf16 keeps a high and a low part (the forward's two planes), summed
template <typename T>
__device__ __forceinline__ void load_state(float* s, int lds, const T* hi,
                                           const T* lo, int rows, int N) {
  constexpr int CH = 16 / (int)sizeof(T);
  const int cpr = N / CH;
  for (int e = threadIdx.x; e < rows * cpr; e += NT) {
    const int r = e / cpr, k = (e % cpr) * CH;
    float v[CH];
    rt::load_vec<T, CH>(hi + r * N + k, v);
    if (lo != nullptr) {
      float w[CH];
      rt::load_vec<T, CH>(lo + r * N + k, w);
#pragma unroll
      for (int i = 0; i < CH; ++i) v[i] += w[i];
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) s[r * lds + k + i] = v[i];
  }
}

// dt of the chunk's tokens (global rows from `row0`, `n` of them) of head
// h into sDt (0 past n) and the inclusive prefix sums of dt·a over the
// chunk into sCum, in f64 (MAX_L each; constant past n): a decay is the
// exponential of a difference of two of them, which f32 prefix sums of
// some 50 would round by 3e-6. sW: 4 doubles. All NT threads, two tokens
// each; synchronises the block before and after.
__device__ __forceinline__ void chunk_cums(const float* __restrict__ dt,
                                           size_t row0, int n, int H, int h,
                                           float ah, float* sDt, double* sCum,
                                           double* sW) {
  static_assert(2 * NT == MAX_L, "two tokens a thread");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = 2 * tid;
  const float d0 = t < n ? dt[(row0 + t) * H + h] : 0.f;
  const float d1 = t + 1 < n ? dt[(row0 + t + 1) * H + h] : 0.f;
  const double v0 = (double)d0 * ah, v1 = (double)d1 * ah;
  double f = v0 + v1;   // inclusive scan over the warp's pairs
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, f, o);
    if (lane >= o) f += u;
  }
  const double fb = __shfl_up_sync(0xffffffffu, f, 1);
  __syncthreads();   // the last call's readers are done
  if (lane == 31) sW[warp] = f;
  __syncthreads();
  double before = lane > 0 ? fb : 0.;
  for (int w = 0; w < warp; ++w) before += sW[w];
  sDt[t] = d0;
  sDt[t + 1] = d1;
  sCum[t] = before + v0;
  sCum[t + 1] = before + v0 + v1;
  __syncthreads();
}

// exp(d) for a log-decay d ≤ 0 (a difference of two prefix sums, taken in
// f64), clamped at 0
__device__ __forceinline__ float decay(double d) {
  return expf((float)fmin(d, 0.));
}

// sum over a warp's 8 row groups (lanes of one quad hold the same value)
__device__ __forceinline__ double rows_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// sum over a quad (the four lanes of one row pair)
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the block's sum of v (NT threads), in a fixed order; valid everywhere
__device__ __forceinline__ double block_sum(double v, double* sRed) {
  v = quad_sum(v);
  v = rows_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sRed[warp] = v;
  __syncthreads();
  return sRed[0] + sRed[1] + sRed[2] + sRed[3];
}

// where a block's (batch, chunk) lies: blockIdx `bc` of B·nc
struct Chunk {
  int bi, c, nc, c0, n;
  size_t row0;   // global token row of the chunk's first token
};

__device__ __forceinline__ Chunk chunk_of(int bc, int S, int L) {
  Chunk k;
  k.nc = (S + L - 1) / L;
  k.bi = bc / k.nc;
  k.c = bc % k.nc;
  k.c0 = k.c * L;
  k.n = min(L, S - k.c0);
  k.row0 = (size_t)k.bi * S + k.c0;
  return k;
}

// -- 1: each chunk's own state gradient --------------------------------------
// Grid (H, n_chunks, B). dstates (B, nc, H, P, N) f32 receives
// Σ_i exp(cum_i)·dy_i ⊗ C_i; dec (B, nc, H) the chunk's sum of dt·a.
template <typename T, int N>
__global__ void __launch_bounds__(NT)
    ssd_dstate_kernel(const T* __restrict__ dy, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ cm,
                      float* __restrict__ dstates, float* __restrict__ dec,
                      int S, int H, int P, int L) {
  constexpr bool TC = IS_BF16<T>;
  constexpr int LDN = N + PADF;
  extern __shared__ __align__(16) float smem[];
  double* sCum = reinterpret_cast<double*>(smem);
  float* sDt = reinterpret_cast<float*>(sCum + MAX_L);
  float* sEx = sDt + MAX_L;
  float* sY = sEx + MAX_L;       // TILE × LDP: dy, a slice of P
  float* sC = sY + TILE * LDP;   // TILE × LDN: C·exp(cum)
  __shared__ double sW[4];
  const int h = blockIdx.x, c = blockIdx.y, bi = blockIdx.z, nc = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const int c0 = c * L, n = min(L, S - c0);
  const size_t row0 = (size_t)bi * S + c0;
  const size_t xs = (size_t)H * P;
  chunk_cums(dt, row0, n, H, h, a[h], sDt, sCum, sW);
  for (int t = threadIdx.x; t < MAX_L; t += NT) sEx[t] = decay(sCum[t]);
  const T* dyh = dy + row0 * xs + (size_t)h * P;
  const size_t chunk_row = ((size_t)bi * nc + c) * H + h;
  for (int p0 = 0; p0 < P; p0 += PS) {
    const int pw = min(PS, P - p0);
    const bool active = 16 * warp < pw;
    float acc[N / 8][4];
    zero(acc);
    for (int k0 = 0; k0 < n; k0 += TILE) {
      __syncthreads();   // the last tile's products are done; sEx is written
      load_f<T>(sY, LDP, dyh + (size_t)k0 * xs + p0, xs, TILE, n - k0, pw);
      load_f<T>(sC, LDN, cm + (row0 + k0) * N, N, TILE, n - k0, N, sEx + k0);
      __syncthreads();
      // A(p, i) = dy_i[p], B(i, n) = exp(cum_i)·C_i[n]
      if (active)
        mm<TC, false, true, N / 8>(acc, N / 8, sY + 16 * warp, 1, LDP, 1.f, 1.f,
                                   sC, LDN, 1, TILE);
    }
    if (active) {
      float* out = dstates + (chunk_row * P + p0 + 16 * warp) * N;
#pragma unroll
      for (int t = 0; t < N / 8; ++t) {
        *reinterpret_cast<float2*>(out + g * N + 8 * t + q2) =
            make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(out + (g + 8) * N + 8 * t + q2) =
            make_float2(acc[t][2], acc[t][3]);
      }
    }
  }
  if (threadIdx.x == 0) dec[chunk_row] = (float)sCum[MAX_L - 1];
}

// -- 2: the reverse recurrence over chunks -----------------------------------
// One thread per four consecutive (p, n) of a (batch, head). gnext (B, nc,
// H, P, N) receives the gradient of the state after chunk c; dinit the
// gradient of the state before the first. dfinal (B, H, P, N) or null.
// (T: the call's dtype, so that each kernel of a call names it.)
template <typename T>
__global__ void __launch_bounds__(RT_THREADS)
    ssd_drecur_kernel(const float* __restrict__ dfinal,
                      const float* __restrict__ dstates,
                      const float* __restrict__ dec, float* __restrict__ gnext,
                      float* __restrict__ dinit, int B, int H, int PN, int nc) {
  const size_t e = 4 * ((size_t)blockIdx.x * RT_THREADS + threadIdx.x);
  const size_t hpn = (size_t)H * PN;
  if (e >= (size_t)B * hpn) return;
  const int bi = (int)(e / hpn), h = (int)((e % hpn) / PN);
  const size_t in_b = e % hpn;
  float4 g = dfinal ? *reinterpret_cast<const float4*>(dfinal + e)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    const size_t row = (size_t)bi * nc + c;
    *reinterpret_cast<float4*>(gnext + row * hpn + in_b) = g;
    const float d = expf(dec[row * H + h]);
    const float4 s = *reinterpret_cast<const float4*>(dstates + row * hpn + in_b);
    g.x = g.x * d + s.x;
    g.y = g.y * d + s.y;
    g.z = g.z * d + s.z;
    g.w = g.w * d + s.w;
  }
  *reinterpret_cast<float4*>(dinit + e) = g;
}

// -- 3: dcum's row part -------------------------------------------------------
// Grid (H, L / TILE, B·nc): the block's tile of rows i. dcum plane 0 (B,
// nc, H, L) receives Σ_{j≤i} w_ij + exp(cum_i)·dy_i·(S C_i).
template <typename T, int N>
__global__ void __launch_bounds__(NT)
    ssd_drow_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const T* __restrict__ prev, double* __restrict__ dcum,
                    int B, int S, int H, int P, int L) {
  constexpr bool TC = IS_BF16<T>;
  constexpr int LDN = N + PADF;
  extern __shared__ __align__(16) float smem[];
  double* sCum = reinterpret_cast<double*>(smem);
  float* sDt = reinterpret_cast<float*>(sCum + MAX_L);
  float* sC = sDt + MAX_L;        // TILE × LDN: C of the block's rows
  float* sB = sC + TILE * LDN;    // TILE × LDN: B of a key tile, or S rows
  float* sDy = sB + TILE * LDN;   // TILE × LDP: dy of the block's rows
  float* sX = sDy + TILE * LDP;   // TILE × LDP: x of a key tile
  __shared__ double sW[4];
  const Chunk k = chunk_of(blockIdx.z, S, L);
  const int h = blockIdx.x, t = blockIdx.y;
  const int i0 = t * TILE;
  if (i0 >= k.n) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const size_t xs = (size_t)H * P;
  const T* xh = x + k.row0 * xs + (size_t)h * P;
  const T* dyh = dy + k.row0 * xs + (size_t)h * P;
  const size_t chunk_row = ((size_t)k.bi * k.nc + k.c) * H + h;
  const T* s_hi = prev + chunk_row * P * N;
  const T* s_lo = IS_BF16<T> ? s_hi + (size_t)B * k.nc * H * P * N : nullptr;
  chunk_cums(dt, k.row0, k.n, H, h, a[h], sDt, sCum, sW);
  load_f<T>(sC, LDN, cm + (k.row0 + i0) * N, N, TILE, k.n - i0, N);
  const float* cw = sC + 16 * warp * LDN;
  double off[2] = {0., 0.}, row[2] = {0., 0.};

  // dy_i·(S C_i), a slice of P at a time
  for (int p0 = 0; p0 < P; p0 += PS) {
    const int pw = min(PS, P - p0);
    __syncthreads();
    load_f<T>(sDy, LDP, dyh + (size_t)i0 * xs + p0, xs, TILE, k.n - i0, pw);
    load_state<T>(sB, LDN, s_hi + (size_t)p0 * N,
                  s_lo ? s_lo + (size_t)p0 * N : nullptr, pw, N);
    __syncthreads();
    float sc[8][4];
    zero(sc);
    // A(i, n) = C_i[n], B(n, p) = S[p][n]
    mm<TC, false, true, 8>(sc, pw / 8, cw, LDN, 1, 1.f, 1.f, sB, 1, LDN, N);
#pragma unroll
    for (int tt = 0; tt < 8; ++tt) {
      if (tt < pw / 8) {
        const float* d0 = sDy + (16 * warp + g) * LDP + 8 * tt + q2;
        const float* d1 = d0 + 8 * LDP;
        off[0] += (double)sc[tt][0] * d0[0] + (double)sc[tt][1] * d0[1];
        off[1] += (double)sc[tt][2] * d1[0] + (double)sc[tt][3] * d1[1];
      }
    }
  }

  // the pair weights' row sums over the key tiles up to the block's own
  for (int kt = 0; kt <= t; ++kt) {
    const int j0 = kt * TILE;
    float dxy[8][4];
    zero(dxy);
    for (int p0 = 0; p0 < P; p0 += PS) {
      const int pw = min(PS, P - p0);
      __syncthreads();
      load_f<T>(sDy, LDP, dyh + (size_t)i0 * xs + p0, xs, TILE, k.n - i0, pw);
      load_f<T>(sX, LDP, xh + (size_t)j0 * xs + p0, xs, TILE, k.n - j0, pw);
      if (p0 == 0) load_f<T>(sB, LDN, bm + (k.row0 + j0) * N, N, TILE, k.n - j0, N);
      __syncthreads();
      // A(i, p) = dy_i[p], B(p, j) = x_j[p]
      mm<TC, false, false, 8>(dxy, 8, sDy + 16 * warp * LDP, LDP, 1, 1.f, 1.f,
                              sX, 1, LDP, pw);
    }
    float cb[8][4];
    zero(cb);
    // A(i, n) = C_i[n], B(n, j) = B_j[n]
    mm<TC, false, false, 8>(cb, 8, cw, LDN, 1, 1.f, 1.f, sB, 1, LDN, N);
#pragma unroll
    for (int tt = 0; tt < 8; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 16 * warp + g + 8 * (e >> 1);
        const int j = j0 + 8 * tt + q2 + (e & 1);
        if (j <= i)
          row[e >> 1] += (double)(cb[tt][e] * dxy[tt][e] * sDt[j] *
                                  decay(sCum[i] - sCum[j]));
      }
  }
  for (int r = 0; r < 2; ++r) {
    off[r] = quad_sum(off[r]);
    row[r] = quad_sum(row[r]);
  }
  if ((lane & 3) == 0) {
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 16 * warp + g + 8 * r;
      if (i < k.n)
        dcum[chunk_row * L + i] = row[r] + (double)decay(sCum[i]) * off[r];
    }
  }
}

// -- 4: dx, x·dxdt and dcum's column part -----------------------------------
// Grid (H, L / TILE, B·nc): the block's tile of keys j. dx; ddt receives
// x·dxdt (pass 7 adds a·dl); dcum plane 1 −dt_j Σ_{i≥j} scores_ij
// (dy_i·x_j) − u_j with u_j = exp(cum_last − cum_j) dt_j x_j·(G B_j);
// upart and ddpart (B, nc, L / TILE, H) the tile's sums of u and of dy·x;
// gs (B, nc, H), from the chunk's last tile, exp(cum_last)·<G, S>.
template <typename T, int N>
__global__ void __launch_bounds__(NT)
    ssd_dcol_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ dskip, const T* __restrict__ prev,
                    const float* __restrict__ gnext, T* __restrict__ dx,
                    float* __restrict__ ddt, double* __restrict__ dcum,
                    double* __restrict__ upart, double* __restrict__ ddpart,
                    double* __restrict__ gs, int B, int S, int H, int P,
                    int L) {
  constexpr bool TC = IS_BF16<T>;
  constexpr int LDN = N + PADF;
  extern __shared__ __align__(16) float smem[];
  double* sCum = reinterpret_cast<double*>(smem);
  float* sDt = reinterpret_cast<float*>(sCum + MAX_L);
  float* sE = sDt + MAX_L;         // exp(cum_last − cum_j)
  float* sBo = sE + MAX_L;         // TILE × LDN: B of the block's keys
  float* sC = sBo + TILE * LDN;    // TILE × LDN: C of a query tile, or G rows
  float* sXo = sC + TILE * LDN;    // TILE × LDP: x of the block's keys
  float* sDq = sXo + TILE * LDP;   // TILE × LDP: dy of a query tile
  float* sSc = sDq + TILE * LDP;   // 4 × 16 × LDT: each warp's scores
  __shared__ double sW[4];
  __shared__ double sRed[4];
  const Chunk k = chunk_of(blockIdx.z, S, L);
  const int h = blockIdx.x, t = blockIdx.y;
  const int j0 = t * TILE;
  if (j0 >= k.n) return;
  const int nq = (k.n + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const size_t xs = (size_t)H * P;
  const T* xh = x + k.row0 * xs + (size_t)h * P;
  const T* dyh = dy + k.row0 * xs + (size_t)h * P;
  T* dxh = dx + k.row0 * xs + (size_t)h * P;
  const size_t chunk_row = ((size_t)k.bi * k.nc + k.c) * H + h;
  const float* gh = gnext + chunk_row * P * N;
  const float dh = dskip[h];
  chunk_cums(dt, k.row0, k.n, H, h, a[h], sDt, sCum, sW);
  for (int tt = threadIdx.x; tt < MAX_L; tt += NT)
    sE[tt] = decay(sCum[MAX_L - 1] - sCum[tt]);
  load_f<T>(sBo, LDN, bm + (k.row0 + j0) * N, N, TILE, k.n - j0, N);
  const float* bw = sBo + 16 * warp * LDN;
  float* sw = sSc + warp * 16 * LDT;
  double col[2] = {0., 0.}, u[2] = {0., 0.}, dir[2] = {0., 0.},
         dd[2] = {0., 0.};

  for (int p0 = 0; p0 < P; p0 += PS) {
    const int pw = min(PS, P - p0);
    float dxdt[8][4];
    zero(dxdt);
    __syncthreads();
    load_f<T>(sXo, LDP, xh + (size_t)j0 * xs + p0, xs, TILE, k.n - j0, pw);
    for (int q = t; q < nq; ++q) {
      const int i0 = q * TILE;
      __syncthreads();
      load_f<T>(sC, LDN, cm + (k.row0 + i0) * N, N, TILE, k.n - i0, N);
      load_f<T>(sDq, LDP, dyh + (size_t)i0 * xs + p0, xs, TILE, k.n - i0, pw);
      __syncthreads();
      float s[8][4], xd[8][4];
      zero(s);
      zero(xd);
      // A(j, n) = B_j[n], B(n, i) = C_i[n]: the scores' transpose
      mm<TC, false, false, 8>(s, 8, bw, LDN, 1, 1.f, 1.f, sC, 1, LDN, N);
      // A(j, p) = x_j[p], B(p, i) = dy_i[p]
      mm<TC, false, false, 8>(xd, 8, sXo + 16 * warp * LDP, LDP, 1, 1.f, 1.f,
                              sDq, 1, LDP, pw);
#pragma unroll
      for (int tt = 0; tt < 8; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1), cc = 8 * tt + q2 + (e & 1);
          const int J = j0 + 16 * warp + r, I = i0 + cc;
          const float v = I >= J ? s[tt][e] * decay(sCum[I] - sCum[J])
                                 : 0.f;
          col[e >> 1] += (double)(v * xd[tt][e]);
          sw[r * LDT + cc] = v;
        }
      __syncwarp();
      // A(j, i) = the decayed scores, B(i, p) = dy_i[p]
      mm<TC, true, false, 8>(dxdt, pw / 8, sw, LDT, 1, 1.f, 1.f, sDq, LDP, 1,
                             TILE);
      __syncwarp();
    }
    // the state gradient's term: exp(cum_last − cum_j)·G B_j
    __syncthreads();
    load_f<float>(sC, LDN, gh + (size_t)p0 * N, N, pw, pw, N);
    __syncthreads();
    float gb[8][4];
    zero(gb);
    // A(j, n) = B_j[n], B(n, p) = G[p][n]
    mm<TC, false, true, 8>(gb, pw / 8, bw, LDN, 1, 1.f, 1.f, sC, 1, LDN, N);
#pragma unroll
    for (int tt = 0; tt < 8; ++tt) {
      if (tt >= pw / 8) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + g + 8 * half, J = j0 + r;
        const int pc = 8 * tt + q2;
        const float ej = sE[J], dtj = sDt[J];
        const float x0 = sXo[r * LDP + pc], x1 = sXo[r * LDP + pc + 1];
        const float g0 = gb[tt][2 * half], g1 = gb[tt][2 * half + 1];
        const float v0 = dxdt[tt][2 * half] + ej * g0;
        const float v1 = dxdt[tt][2 * half + 1] + ej * g1;
        u[half] += (double)(ej * dtj) * ((double)x0 * g0 + (double)x1 * g1);
        dir[half] += (double)x0 * v0 + (double)x1 * v1;
        if (J < k.n) {
          const size_t at = (size_t)J * xs + p0 + pc;
          const float2 dv = Cvt<T>::ld2(dyh + at);
          dd[half] += (double)dv.x * x0 + (double)dv.y * x1;
          const float o0 = dtj * v0 + dh * dv.x, o1 = dtj * v1 + dh * dv.y;
          if constexpr (IS_BF16<T>) {
            *reinterpret_cast<__nv_bfloat162*>(dxh + at) = __floats2bfloat162_rn(o0, o1);
          } else {
            dxh[at] = o0;
            dxh[at + 1] = o1;
          }
        }
      }
    }
  }
  for (int r = 0; r < 2; ++r) {
    col[r] = quad_sum(col[r]);
    u[r] = quad_sum(u[r]);
    dir[r] = quad_sum(dir[r]);
  }
  if ((lane & 3) == 0) {
    const size_t plane = (size_t)B * k.nc * H * L;
    for (int r = 0; r < 2; ++r) {
      const int J = j0 + 16 * warp + g + 8 * r;
      if (J < k.n) {
        ddt[(k.row0 + J) * H + h] = (float)dir[r];
        dcum[plane + chunk_row * L + J] = -(double)sDt[J] * col[r] - u[r];
      }
    }
  }
  // u and dy·x of each row are quad sums already: add a quad's lane 0 only
  const bool lead = (lane & 3) == 0;
  const double us = block_sum(lead ? u[0] + u[1] : 0., sRed);
  const double ds = block_sum(dd[0] + dd[1], sRed);
  const size_t tile_row = (((size_t)k.bi * k.nc + k.c) * (L / TILE) + t) * H + h;
  if (threadIdx.x == 0) {
    upart[tile_row] = us;
    ddpart[tile_row] = ds;
  }
  if (t == nq - 1) {   // exp(cum_last)·<G, S> of the chunk
    const T* s_hi = prev + chunk_row * P * N;
    const T* s_lo = IS_BF16<T> ? s_hi + (size_t)B * k.nc * H * P * N : nullptr;
    double acc = 0.;
    for (int e = threadIdx.x; e < P * N; e += NT) {
      float sv = Cvt<T>::to_f(s_hi[e]);
      if (s_lo != nullptr) sv += Cvt<T>::to_f(s_lo[e]);
      acc += (double)gh[e] * sv;
    }
    const double tot = block_sum(acc, sRed);
    if (threadIdx.x == 0)
      gs[chunk_row] = (double)decay(sCum[MAX_L - 1]) * tot;
  }
}

// -- 5: dC -------------------------------------------------------------------
// Grid (L / TILE, B·nc): the block's tile of rows i, every head in order.
template <typename T, int N>
__global__ void __launch_bounds__(NT)
    ssd_dc_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ dt, const float* __restrict__ a,
                  const T* __restrict__ bm, const T* __restrict__ prev,
                  T* __restrict__ dc, int B, int S, int H, int P, int L) {
  constexpr bool TC = IS_BF16<T>;
  constexpr int LDN = N + PADF;
  extern __shared__ __align__(16) float smem[];
  double* sCum = reinterpret_cast<double*>(smem);
  float* sDt = reinterpret_cast<float*>(sCum + MAX_L);
  float* sEx = sDt + MAX_L;       // exp(cum_i)
  float* sDy = sEx + MAX_L;       // TILE × LDP: dy of the block's rows
  float* sX = sDy + TILE * LDP;   // TILE × LDP: x of a key tile
  float* sB = sX + TILE * LDP;    // TILE × LDN: B of a key tile, or S rows
  float* sM = sB + TILE * LDN;    // 4 × 16 × LDT: each warp's weights
  double* sTot = reinterpret_cast<double*>(sM + 4 * 16 * LDT);   // TILE × N
  __shared__ double sW[4];
  const Chunk k = chunk_of(blockIdx.y, S, L);
  const int t = blockIdx.x, i0 = t * TILE;
  if (i0 >= k.n) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const int r0 = 16 * warp + g;
  const size_t xs = (size_t)H * P;
  float* mw = sM + warp * 16 * LDT;
  float acc[N / 8][4];
  for_own<N>(sTot, r0, q2, [](double& v, int, int) { v = 0.; });
  for (int h = 0; h < H; ++h) {
    zero(acc);
    const T* xh = x + k.row0 * xs + (size_t)h * P;
    const T* dyh = dy + k.row0 * xs + (size_t)h * P;
    const size_t chunk_row = ((size_t)k.bi * k.nc + k.c) * H + h;
    const T* s_hi = prev + chunk_row * P * N;
    const T* s_lo = IS_BF16<T> ? s_hi + (size_t)B * k.nc * H * P * N : nullptr;
    chunk_cums(dt, k.row0, k.n, H, h, a[h], sDt, sCum, sW);
    for (int tt = threadIdx.x; tt < MAX_L; tt += NT) sEx[tt] = decay(sCum[tt]);
    // exp(cum_i)·Sᵀ dy_i
    for (int p0 = 0; p0 < P; p0 += PS) {
      const int pw = min(PS, P - p0);
      __syncthreads();
      load_f<T>(sDy, LDP, dyh + (size_t)i0 * xs + p0, xs, TILE, k.n - i0, pw);
      load_state<T>(sB, LDN, s_hi + (size_t)p0 * N,
                    s_lo ? s_lo + (size_t)p0 * N : nullptr, pw, N);
      __syncthreads();
      // A(i, p) = exp(cum_i)·dy_i[p], B(p, n) = S[p][n]
      mm<TC, true, true, N / 8>(acc, N / 8, sDy + 16 * warp * LDP, LDP, 1,
                                sEx[i0 + r0], sEx[i0 + r0 + 8], sB, LDN, 1, pw);
    }
    // Σ_{j≤i} exp(cum_i − cum_j) dt_j (dy_i·x_j) B_j, a key tile at a time
    for (int kt = 0; kt <= t; ++kt) {
      const int j0 = kt * TILE;
      float m[8][4];
      zero(m);
      for (int p0 = 0; p0 < P; p0 += PS) {
        const int pw = min(PS, P - p0);
        __syncthreads();
        load_f<T>(sDy, LDP, dyh + (size_t)i0 * xs + p0, xs, TILE, k.n - i0, pw);
        load_f<T>(sX, LDP, xh + (size_t)j0 * xs + p0, xs, TILE, k.n - j0, pw);
        if (p0 == 0) load_f<T>(sB, LDN, bm + (k.row0 + j0) * N, N, TILE, k.n - j0, N);
        __syncthreads();
        // A(i, p) = dy_i[p], B(p, j) = x_j[p]
        mm<TC, false, false, 8>(m, 8, sDy + 16 * warp * LDP, LDP, 1, 1.f, 1.f,
                                sX, 1, LDP, pw);
      }
#pragma unroll
      for (int tt = 0; tt < 8; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1), cc = 8 * tt + q2 + (e & 1);
          const int i = i0 + 16 * warp + r, j = j0 + cc;
          mw[r * LDT + cc] =
              j <= i ? m[tt][e] * sDt[j] * decay(sCum[i] - sCum[j]) : 0.f;
        }
      __syncwarp();
      // A(i, j) = the weights, B(j, n) = B_j[n]
      mm<TC, true, false, N / 8>(acc, N / 8, mw, LDT, 1, 1.f, 1.f, sB, LDN, 1,
                                 TILE);
      __syncwarp();
    }
    // this head's terms join the sum over the heads, in double
    for_own<N>(sTot, r0, q2, [&](double& v, int tt, int e) { v += acc[tt][e]; });
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + r0 + 8 * half;
    if (i >= k.n) continue;
    T* out = dc + (k.row0 + i) * N;
#pragma unroll
    for (int tt = 0; tt < N / 8; ++tt) {
      const double* tot = sTot + (r0 + 8 * half) * N + 8 * tt + q2;
      const float o0 = (float)tot[0], o1 = (float)tot[1];
      if constexpr (IS_BF16<T>) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * tt + q2) = __floats2bfloat162_rn(o0, o1);
      } else {
        out[8 * tt + q2] = o0;
        out[8 * tt + q2 + 1] = o1;
      }
    }
  }
}

// -- 6: dB -------------------------------------------------------------------
// Grid (L / TILE, B·nc): the block's tile of keys j, every head in order.
template <typename T, int N>
__global__ void __launch_bounds__(NT)
    ssd_db_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ dt, const float* __restrict__ a,
                  const T* __restrict__ cm, const float* __restrict__ gnext,
                  T* __restrict__ db, int S, int H, int P, int L) {
  constexpr bool TC = IS_BF16<T>;
  constexpr int LDN = N + PADF;
  extern __shared__ __align__(16) float smem[];
  double* sCum = reinterpret_cast<double*>(smem);
  float* sDt = reinterpret_cast<float*>(sCum + MAX_L);
  float* sE = sDt + MAX_L;        // exp(cum_last − cum_j)·dt_j
  float* sX = sE + MAX_L;         // TILE × LDP: x of the block's keys
  float* sDq = sX + TILE * LDP;   // TILE × LDP: dy of a query tile
  float* sC = sDq + TILE * LDP;   // TILE × LDN: C of a query tile, or G rows
  float* sM = sC + TILE * LDN;    // 4 × 16 × LDT: each warp's weights
  double* sTot = reinterpret_cast<double*>(sM + 4 * 16 * LDT);   // TILE × N
  __shared__ double sW[4];
  const Chunk k = chunk_of(blockIdx.y, S, L);
  const int t = blockIdx.x, j0 = t * TILE;
  if (j0 >= k.n) return;
  const int nq = (k.n + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const int r0 = 16 * warp + g;
  const size_t xs = (size_t)H * P;
  float* mw = sM + warp * 16 * LDT;
  float acc[N / 8][4];
  for_own<N>(sTot, r0, q2, [](double& v, int, int) { v = 0.; });
  for (int h = 0; h < H; ++h) {
    zero(acc);
    const T* xh = x + k.row0 * xs + (size_t)h * P;
    const T* dyh = dy + k.row0 * xs + (size_t)h * P;
    const float* gh = gnext + (((size_t)k.bi * k.nc + k.c) * H + h) * P * N;
    chunk_cums(dt, k.row0, k.n, H, h, a[h], sDt, sCum, sW);
    for (int tt = threadIdx.x; tt < MAX_L; tt += NT)
      sE[tt] = decay(sCum[MAX_L - 1] - sCum[tt]) * sDt[tt];
    // exp(cum_last − cum_j)·Gᵀ xdt_j
    for (int p0 = 0; p0 < P; p0 += PS) {
      const int pw = min(PS, P - p0);
      __syncthreads();
      load_f<T>(sX, LDP, xh + (size_t)j0 * xs + p0, xs, TILE, k.n - j0, pw);
      load_f<float>(sC, LDN, gh + (size_t)p0 * N, N, pw, pw, N);
      __syncthreads();
      // A(j, p) = exp(cum_last − cum_j) dt_j x_j[p], B(p, n) = G[p][n]
      mm<TC, true, true, N / 8>(acc, N / 8, sX + 16 * warp * LDP, LDP, 1,
                                sE[j0 + r0], sE[j0 + r0 + 8], sC, LDN, 1, pw);
    }
    // Σ_{i≥j} exp(cum_i − cum_j) dt_j (dy_i·x_j) C_i, a query tile at a time
    for (int q = t; q < nq; ++q) {
      const int i0 = q * TILE;
      float m[8][4];
      zero(m);
      for (int p0 = 0; p0 < P; p0 += PS) {
        const int pw = min(PS, P - p0);
        __syncthreads();
        load_f<T>(sX, LDP, xh + (size_t)j0 * xs + p0, xs, TILE, k.n - j0, pw);
        load_f<T>(sDq, LDP, dyh + (size_t)i0 * xs + p0, xs, TILE, k.n - i0, pw);
        if (p0 == 0) load_f<T>(sC, LDN, cm + (k.row0 + i0) * N, N, TILE, k.n - i0, N);
        __syncthreads();
        // A(j, p) = x_j[p], B(p, i) = dy_i[p]
        mm<TC, false, false, 8>(m, 8, sX + 16 * warp * LDP, LDP, 1, 1.f, 1.f,
                                sDq, 1, LDP, pw);
      }
#pragma unroll
      for (int tt = 0; tt < 8; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1), cc = 8 * tt + q2 + (e & 1);
          const int j = j0 + 16 * warp + r, i = i0 + cc;
          mw[r * LDT + cc] =
              i >= j ? m[tt][e] * sDt[j] * decay(sCum[i] - sCum[j]) : 0.f;
        }
      __syncwarp();
      // A(j, i) = the weights, B(i, n) = C_i[n]
      mm<TC, true, false, N / 8>(acc, N / 8, mw, LDT, 1, 1.f, 1.f, sC, LDN, 1,
                                 TILE);
      __syncwarp();
    }
    // this head's terms join the sum over the heads, in double
    for_own<N>(sTot, r0, q2, [&](double& v, int tt, int e) { v += acc[tt][e]; });
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + r0 + 8 * half;
    if (j >= k.n) continue;
    T* out = db + (k.row0 + j) * N;
#pragma unroll
    for (int tt = 0; tt < N / 8; ++tt) {
      const double* tot = sTot + (r0 + 8 * half) * N + 8 * tt + q2;
      const float o0 = (float)tot[0], o1 = (float)tot[1];
      if constexpr (IS_BF16<T>) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * tt + q2) = __floats2bfloat162_rn(o0, o1);
      } else {
        out[8 * tt + q2] = o0;
        out[8 * tt + q2 + 1] = o1;
      }
    }
  }
}

// -- 7: dl, ddt, da and dD ------------------------------------------------------
// Grid (H), a thread a token of a chunk, walking the batch rows and the
// chunks in order: dl_t = Σ_{i≥t} dcum_i plus the chunk-end terms (the
// tiles' sums of u and gs), ddt += a·dl; da = Σ dt·dl and dD = Σ of the
// tiles' dy·x, each summed in a fixed order.
template <typename T>
__global__ void __launch_bounds__(FIN_THREADS)
    ssd_dfinish_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                       const double* __restrict__ dcum,
                       const double* __restrict__ upart,
                       const double* __restrict__ ddpart,
                       const double* __restrict__ gs, float* __restrict__ ddt,
                       float* __restrict__ da, float* __restrict__ dd, int B,
                       int S, int H, int L) {
  constexpr int WARPS = FIN_THREADS / 32;
  __shared__ double sW[WARPS], sRed[2 * WARPS];
  const int h = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nc = (S + L - 1) / L, ntm = L / TILE;
  const size_t plane = (size_t)B * nc * H * L;
  const double ah = a[h];
  double da_acc = 0., dd_acc = 0.;
  for (int bi = 0; bi < B; ++bi) {
    for (int c = 0; c < nc; ++c) {
      const int c0 = c * L, n = min(L, S - c0);
      const size_t row = ((size_t)bi * nc + c) * H + h;
      const size_t tiles = ((size_t)bi * nc + c) * ntm;
      double end = gs[row];
      for (int kt = 0; kt < ntm && kt * TILE < n; ++kt)
        end += upart[(tiles + kt) * H + h];
      if (tid < ntm && tid * TILE < n) dd_acc += ddpart[(tiles + tid) * H + h];
      const double v = tid < n ? dcum[row * L + tid] + dcum[plane + row * L + tid]
                               : 0.;
      double r = v;   // inclusive suffix sums within the warp
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double w = __shfl_down_sync(0xffffffffu, r, o);
        if (lane + o < 32) r += w;
      }
      __syncthreads();   // the last chunk's readers of sW are done
      if (lane == 0) sW[warp] = r;
      __syncthreads();
      double after = 0.;
      for (int w = warp + 1; w < WARPS; ++w) after += sW[w];
      if (tid < n) {
        const double dl = r + after + end;
        const size_t at = ((size_t)bi * S + c0 + tid) * H + h;
        ddt[at] = (float)(ddt[at] + ah * dl);
        da_acc += (double)dt[at] * dl;
      }
    }
  }
  double va = da_acc, vd = dd_acc;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    va += __shfl_xor_sync(0xffffffffu, va, o);
    vd += __shfl_xor_sync(0xffffffffu, vd, o);
  }
  if (lane == 0) {
    sRed[warp] = va;
    sRed[WARPS + warp] = vd;
  }
  __syncthreads();
  if (tid == 0) {
    double sa = 0., sd = 0.;
    for (int w = 0; w < WARPS; ++w) {
      sa += sRed[w];
      sd += sRed[WARPS + w];
    }
    da[h] = (float)sa;
    dd[h] = (float)sd;
  }
}

// -- launch -------------------------------------------------------------------

struct Args {
  const void *x, *dt, *a, *b, *c, *d, *prev, *dy, *dfinal;
  void *dx, *ddt, *da, *db, *dc, *dd, *dinit;
  void *dstates, *gnext, *dec, *dcum, *upart, *ddpart, *gs;
  int B, S, H, P, L;
  cudaStream_t stream;
};

// dynamic shared memory (bytes) of each tile kernel at state dim N
template <int N>
struct Smem {
  static constexpr int LDN = N + PADF;
  static constexpr size_t f = sizeof(float);
  // sCum: MAX_L doubles
  static constexpr size_t dstate = f * (4 * MAX_L + TILE * LDP + TILE * LDN);
  static constexpr size_t row = f * (3 * MAX_L + 2 * TILE * LDN + 2 * TILE * LDP);
  static constexpr size_t col =
      f * (4 * MAX_L + 2 * TILE * LDN + 2 * TILE * LDP + 4 * 16 * LDT);
  static constexpr size_t dcdb =
      f * (4 * MAX_L + 2 * TILE * LDP + TILE * LDN + 4 * 16 * LDT) +
      sizeof(double) * TILE * N;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int N>
cudaError_t launch(const Args& g) {
  using Sm = Smem<N>;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err;
    if ((err = allow_smem(ssd_dstate_kernel<T, N>, Sm::dstate)) != cudaSuccess ||
        (err = allow_smem(ssd_drow_kernel<T, N>, Sm::row)) != cudaSuccess ||
        (err = allow_smem(ssd_dcol_kernel<T, N>, Sm::col)) != cudaSuccess ||
        (err = allow_smem(ssd_dc_kernel<T, N>, Sm::dcdb)) != cudaSuccess ||
        (err = allow_smem(ssd_db_kernel<T, N>, Sm::dcdb)) != cudaSuccess)
      return err;
    attrs_set = true;
  }
  const int nc = (g.S + g.L - 1) / g.L, ntm = g.L / TILE;
  const T* x = static_cast<const T*>(g.x);
  const T* dy = static_cast<const T*>(g.dy);
  const float* dt = static_cast<const float*>(g.dt);
  const float* a = static_cast<const float*>(g.a);
  const T* bm = static_cast<const T*>(g.b);
  const T* cm = static_cast<const T*>(g.c);
  const T* prev = static_cast<const T*>(g.prev);
  float* dstates = static_cast<float*>(g.dstates);
  float* gnext = static_cast<float*>(g.gnext);
  float* dec = static_cast<float*>(g.dec);
  double* dcum = static_cast<double*>(g.dcum);
  double* upart = static_cast<double*>(g.upart);
  double* ddpart = static_cast<double*>(g.ddpart);
  double* gsum = static_cast<double*>(g.gs);
  float* ddt = static_cast<float*>(g.ddt);
  ssd_dstate_kernel<T, N><<<dim3(g.H, nc, g.B), NT, Sm::dstate, g.stream>>>(
      dy, dt, a, cm, dstates, dec, g.S, g.H, g.P, g.L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)g.B * g.H * g.P * N / 4;
  ssd_drecur_kernel<T><<<(unsigned)((n4 + RT_THREADS - 1) / RT_THREADS),
                         RT_THREADS, 0, g.stream>>>(
      static_cast<const float*>(g.dfinal), dstates, dec, gnext,
      static_cast<float*>(g.dinit), g.B, g.H, g.P * N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 tiles(g.H, ntm, g.B * nc);
  ssd_drow_kernel<T, N><<<tiles, NT, Sm::row, g.stream>>>(
      x, dy, dt, a, bm, cm, prev, dcum, g.B, g.S, g.H, g.P, g.L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dcol_kernel<T, N><<<tiles, NT, Sm::col, g.stream>>>(
      x, dy, dt, a, bm, cm, static_cast<const float*>(g.d), prev, gnext,
      static_cast<T*>(g.dx), ddt, dcum, upart, ddpart, gsum, g.B, g.S, g.H,
      g.P, g.L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 rows(ntm, g.B * nc);
  ssd_dc_kernel<T, N><<<rows, NT, Sm::dcdb, g.stream>>>(
      x, dy, dt, a, bm, prev, static_cast<T*>(g.dc), g.B, g.S, g.H, g.P, g.L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_db_kernel<T, N><<<rows, NT, Sm::dcdb, g.stream>>>(
      x, dy, dt, a, cm, gnext, static_cast<T*>(g.db), g.S, g.H, g.P, g.L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dfinish_kernel<T><<<g.H, FIN_THREADS, 0, g.stream>>>(
      dt, a, dcum, upart, ddpart, gsum, ddt, static_cast<float*>(g.da),
      static_cast<float*>(g.dd), g.B, g.S, g.H, g.L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int N, const Args& g) {
  switch (N) {
    case 16:
      return launch<T, 16>(g);
    case 64:
      return launch<T, 64>(g);
    case 128:
      return launch<T, 128>(g);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The gradient of ssd_scan_fwd's y and final state. Inputs as the
// forward's: x (B, S, H, P), dt (B, S, H) f32, a (H,) f32, b/c (B, S, N),
// d (H,) f32; prev (planes, B, n, H, P, N), the forward's states before
// each of its n = ceil(S / L) chunks of L tokens (bf16: two planes, a high
// and a low part; f32: one); dy (B, S, H, P) in x's dtype; dfinal (B, H,
// P, N) f32 or null. Outputs: dx (B, S, H, P), ddt (B, S, H) f32, da (H,)
// f32, db/dc (B, S, N), dd (H,) f32, dinit (B, H, P, N) f32. Scratch: f32
// dstates and gnext (B, n, H, P, N) and dec (B, n, H); f64 gs (B, n, H),
// dcum (2, B, n, H, L), upart and ddpart (B, n, L / 64, H). x/b/c/dy/dx/db/dc/prev share
// `dtype` (0 f32, 1 bf16); x, dy, b, c, prev, dfinal 16-byte aligned; P a
// multiple of 16, N in {16, 64, 128}, L the forward's (a multiple of 64 up
// to 256). Seven kernels on `stream`; returns the CUDA error code of the
// launches (0 = ok).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* d,
                            const void* prev, const void* dy,
                            const void* dfinal, void* dx, void* ddt, void* da,
                            void* db, void* dc, void* dd, void* dinit,
                            void* dstates, void* gnext, void* dec, void* dcum,
                            void* upart, void* ddpart, void* gs, int B, int S,
                            int H, int P, int N, int L, int dtype,
                            void* stream) {
  if (P % 16 != 0 || P <= 0 || S <= 0 || B <= 0 || H <= 0 ||
      L % TILE != 0 || L <= 0 || L > MAX_L)
    return cudaErrorInvalidValue;
  const Args g{x,  dt,    a,       b,     c,   d,    prev,  dy,
               dfinal, dx, ddt, da,  db,      dc,    dd,  dinit,
               dstates, gnext, dec, dcum, upart, ddpart, gs,
               B,  S,     H,       P,     L,   static_cast<cudaStream_t>(stream)};
  if (dtype == rt::DTYPE_F32) return dispatch_n<float>(N, g);
  if (dtype == rt::DTYPE_BF16) return dispatch_n<bf16>(N, g);
  return cudaErrorInvalidValue;
}
