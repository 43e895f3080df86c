// Gradient of the Mamba2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces no TPU kernel: the reference trains through its jnp
// `ssd_chunked` (src/repro/models/ssm.py:57), whose gradient JAX derives,
// and its Pallas `ssd_scan` has no VJP. This is the card's counterpart of
// that gradient, for the forward kernel of ssd_scan.cu. Its plain version,
// step for step, is `ssd_chunked_bwd` in kernels/ssd_scan/ref.py.
//
// Per batch row, head h and state chunk of L tokens (the forward's chunks:
// the state before each chunk, S, is the forward's `prev` scratch), with
// l_t = dt_t·a, cum the prefix sum of l over the chunk, G the gradient of
// the state after the chunk and, for j ≤ i,
//   M_ij = exp(cum_i − cum_j)·dt_j·(dy_i·x_j),  scores_ij = (C_i·B_j)·
//   exp(cum_i − cum_j),  w_ij = (C_i·B_j)·M_ij:
//   G before = exp(cum_last)·G + Σ_i exp(cum_i)·dy_i ⊗ C_i
//   dxdt_j   = Σ_{i≥j} scores_ij dy_i + exp(cum_last − cum_j)·G B_j
//   dC_i     = Σ_j (Σ_h M_ij) B_j + Σ_h exp(cum_i)·Sᵀ dy_i
//   dB_j     = Σ_i (Σ_h M_ij) C_i + Σ_h exp(cum_last − cum_j) dt_j·Gᵀ x_j
//   dcum_i   = Σ_j w_ij − Σ_i' w_i'i + exp(cum_i)·C_i·(Sᵀ dy_i) − u_i,
//              u_j = exp(cum_last − cum_j) dt_j x_j·(G B_j), and at the
//              chunk's last token Σ_j u_j + exp(cum_last)·<G, S>;
//   dl = reverse cumulative sum of dcum over the chunk;
//   dx = dt·dxdt + D·dy, ddt = x·dxdt + a·dl, da = Σ dt·dl, dD = Σ dy·x.
// B and C are shared by every head, so the head sums of dC and dB go
// inside the products: the head-summed M is formed once a chunk and dC and
// dB take one product over L from it; their state terms are products
// whose contraction runs over H·P, each head's rows scaled.
//
// What bounds it on the card: at mamba2-370m's training shape (B 4,
// S 2048, H 32, P 64, N 128, bf16) the bytes, ≈ 145 MB (x, dy and dx
// 33.5 MB each, the forward's states, B, C and their gradients, dt and
// ddt), ≈ 0.04 ms at 3.35 TB/s; its products over 64-token tiles are
// ≈ 20 GFLOP, ≈ 0.02 ms at 989 TFLOP/s. The first version ran at 0.9 % of
// that bound. What held it back, and what this design does about each:
//  1. Its products read f32 operands from shared memory a scalar at a
//     time and split each fragment into bf16 high and low parts inside the
//     k loop, in every warp. Here tiles are staged as bf16 by cp.async into
//     rows padded by 16 bytes (conflict-free for ldmatrix), read by
//     ldmatrix and multiplied by mma.sync. x, dy, B and C are exact in
//     bf16; an operand that is not (the decayed scores, the head-summed M,
//     e^cum·C, the states S and G) is split once: where it is staged (S by
//     the forward, G by pass 2, M and e^cum·C as their tiles are written),
//     or in registers by the one warp that forms it (the scores).
//  2. It recomputed the C·Bᵀ and dy·xᵀ tiles in four passes. Here pass 3
//     forms each dy·xᵀ tile once, and C·Bᵀ once a block for all its heads;
//     from them it produces dx, x·dxdt, dcum's row and column sums, u and
//     the head-summed M.
//  3. Its dC and dB blocks walked every head one after another, redoing
//     the prefix sums and reloading tiles for every head and partner tile.
//     Here the prefix sums of dt·a are taken once a (row, chunk, head), in
//     f64, into scratch (pass 1); dC and dB read the head-summed M, and
//     their state terms stream a head's dy or x and S or G through a
//     three-stage cp.async ring, 512 blocks at the training shape.
//  4. Its shared-memory tiles were f32, 123 KB a block. Here they are
//     bf16: pass 4 holds 92 KB (two blocks an SM); pass 3 keeps its f32
//     C·Bᵀ and M sums (32 KB a query tile, 218 KB in all at 256-token
//     chunks) and runs one 8-warp block an SM.
//  5. Its finish ran one block a head over every batch row and chunk.
//     Here dl, ddt and da are spread over (row, chunk, head) blocks and a
//     last pass sums da and dD in a fixed order.
//
// Six kernels a call, in order on the caller's stream:
//  1. `ssd_dstate_kernel`, one block per (row, chunk, head), 4 warps: the
//     prefix sums cum in f64 (scratch), the chunk's sum of dt·a, and its
//     own state gradient Σ_i exp(cum_i)·dy_i ⊗ C_i (P × N, f32).
//  2. `ssd_drecur_kernel`, elementwise over (row, head, P, N), in reverse
//     over the chunks: G after each chunk in x's type (bf16 as a high and a
//     low plane), the initial state's gradient, and each block's part of
//     <G, S> a chunk.
//  3. `ssd_dpair_kernel`, one block per (row, chunk, key tile j, group of
//     8 heads), 8 warps: warp (r, c) owns keys 16r.. of the tile and query
//     columns 32c.. of each query tile i ≥ j. It forms C·Bᵀ for its query
//     tiles once, then for each head dy·xᵀ (transposed: keys as rows), and
//     from them M, w's row sums (a partial per key tile) and column sums,
//     the scores (split in registers) times dy: dxdt; then G·B_j, dx, x·dxdt,
//     u and dy·x; the group's sum of M (in shared memory, f32) goes to
//     scratch per group.
//  4. `ssd_dcdb_kernel`, one block per (row, chunk, tile, 64 columns of N,
//     dC or dB), 4 warps: the groups' M summed and split, times B or C
//     tiles; then the state term over H·P, a head at a time (dy·S for dC,
//     x·G for dB), each head's rows scaled, and for dC its part of
//     exp(cum_i)·C_i·(Sᵀ dy_i).
//  5. `ssd_dfinish_kernel`, one block per (row, chunk, head), a thread a
//     token: dcum from its parts, dl by a reverse scan, ddt += a·dl, the
//     block's part of da.
//  6. `ssd_dsum_kernel`, one block per head: da and dD from their parts.
// No float atomics: every result is written by one thread, every sum is
// taken in a fixed order, and two calls give the same bits. The long sums
// (over the chunk's tokens, a state's P × N elements, the batch and the
// sequence: dcum's row and column sums, dl, da, dD) are taken in f64, the
// products of a tile in f32: in f32 at the training shape the plain
// version's own sums round up to 3x the 1e-4 of the card's check away from
// an f64 run, and this kernel's stay within it.
//
// Numbers: the decays exp(cum_i − cum_j) are formed only where j ≤ i, from
// a difference of two f64 prefix sums (f32 sums of some 50 would round it
// by 3e-6), with the exponent clamped at 0; tokens past the sequence are
// zero-filled (x, dy, B, C) and their dt is 0, so the last chunk may be
// ragged. Products, f32: the same tiles with FMAs on the CUDA cores (TF32
// would miss the 1e-4 agreement with the plain version).

#include <type_traits>

#include "decode_common.cuh"

namespace {

using rt::Cvt;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;       // tokens a tile
constexpr int MAX_L = 256;     // longest state chunk (the forward's)
constexpr int PS = 64;         // head-dim columns a slice
constexpr int NT = 128;        // threads of a 4-warp block
constexpr int PT = 256;        // threads of a pair block: 8 warps
constexpr int HG = 8;          // heads a pair block walks
constexpr int STAGES = 3;      // depth of the dC / dB ring
constexpr int RT_THREADS = 256;     // threads of a recurrence block
constexpr int FIN_THREADS = MAX_L;  // threads of a finishing block
constexpr int SUM_THREADS = 256;    // threads of the summing block
constexpr int FRAG = 16 * PT;  // floats of a 64 × 64 tile held by a pair block
constexpr int LDS = 36;        // row stride of a warp's 16 × 32 scores (f32)

template <typename T>
constexpr bool IS_BF16 = std::is_same<T, bf16>::value;

// planes of an operand that T does not hold exactly: bf16 keeps a high
// and a low part, f32 the value
template <typename T>
constexpr int PLANES = IS_BF16<T> ? 2 : 1;

// row padding (elements): 16 bytes, so that rows shift banks
template <typename T>
constexpr int PAD = 16 / (int)sizeof(T);

// columns of N a dC / dB block computes
template <int N>
constexpr int NB = N < 64 ? N : 64;

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

// acc (16 × 8·NT8 in the m16n8 accumulator layout: a lane holds rows g
// and g + 8, columns 8t + 2q and 8t + 2q + 1, g = lane / 4, q = lane % 4;
// the first nt8 n-tiles computed, nt8 even) += A · B over K (a multiple of
// 16), both in shared memory as E: A(m, k) = a[m·lda + k] (AK false) or
// a[k·lda + m] (AK true); B(k, n) = b[n·ldb + k] (BK false) or b[k·ldb + n]
// (BK true). bf16: ldmatrix and mma.sync m16n8k16; f32: FMAs.
template <bool AK, bool BK, int NT8, typename E>
__device__ __forceinline__ void mm(float (&acc)[NT8][4], int nt8, const E* a,
                                   int lda, const E* b, int ldb, int K) {
  const int l = threadIdx.x & 31;
  if constexpr (IS_BF16<E>) {
    static_assert(NT8 % 2 == 0, "n-tiles come in pairs");
    const int r = l & 7, mat = l >> 3;
    for (int k = 0; k < K; k += 16) {
      uint32_t af[4];
      if constexpr (AK)
        rt::ldsm_x4_trans(af, a + (k + r + (mat >> 1) * 8) * lda + (mat & 1) * 8);
      else
        rt::ldsm_x4(af, a + (r + (mat & 1) * 8) * lda + k + (mat >> 1) * 8);
#pragma unroll
      for (int t = 0; t < NT8; t += 2) {
        if (t < nt8) {
          uint32_t bf[4];
          if constexpr (BK)
            rt::ldsm_x4_trans(bf, b + (k + r + (mat & 1) * 8) * ldb + 8 * t + (mat >> 1) * 8);
          else
            rt::ldsm_x4(bf, b + (8 * t + r + (mat >> 1) * 8) * ldb + k + (mat & 1) * 8);
          rt::mma_16816(acc[t], af, bf);
          rt::mma_16816(acc[t + 1], af, bf + 2);
        }
      }
    }
  } else {
    const int g = l >> 2, q2 = 2 * (l & 3);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = AK ? a[k * lda + g] : a[g * lda + k];
      const float a1 = AK ? a[k * lda + g + 8] : a[(g + 8) * lda + k];
#pragma unroll
      for (int t = 0; t < NT8; ++t) {
        if (t < nt8) {
          const int n = 8 * t + q2;
          const float b0 = BK ? b[k * ldb + n] : b[n * ldb + k];
          const float b1 = BK ? b[k * ldb + n + 1] : b[(n + 1) * ldb + k];
          acc[t][0] = fmaf(a0, b0, acc[t][0]);
          acc[t][1] = fmaf(a0, b1, acc[t][1]);
          acc[t][2] = fmaf(a1, b0, acc[t][2]);
          acc[t][3] = fmaf(a1, b1, acc[t][3]);
        }
      }
    }
  }
}

// acc (16 × 8·NT8) += A · B, A the 16 × 32 tile s (the accumulator layout)
// as two k-steps of bf16 fragments split into a high and a low part, B(k,
// n) = b[k·ldb + n] (32 rows) in shared memory
template <int NT8>
__device__ __forceinline__ void mm_scores(float (&acc)[NT8][4], int nt8,
                                          const float (&s)[4][4],
                                          const bf16* b, int ldb) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    split2(s[2 * kk][0], s[2 * kk][1], ah[kk][0], al[kk][0]);
    split2(s[2 * kk][2], s[2 * kk][3], ah[kk][1], al[kk][1]);
    split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[kk][2], al[kk][2]);
    split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[kk][3], al[kk][3]);
  }
  const int l = threadIdx.x & 31, r = l & 7, mat = l >> 3;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int t = 0; t < NT8; t += 2) {
      if (t < nt8) {
        uint32_t bf[4];
        rt::ldsm_x4_trans(bf, b + (16 * kk + r + (mat & 1) * 8) * ldb + 8 * t + (mat >> 1) * 8);
        rt::mma_16816(acc[t], ah[kk], bf);
        rt::mma_16816(acc[t], al[kk], bf);
        rt::mma_16816(acc[t + 1], ah[kk], bf + 2);
        rt::mma_16816(acc[t + 1], al[kk], bf + 2);
      }
    }
}

// `rows` rows of `cols` elements (a multiple of 16 bytes) from global rows
// `gs` elements apart, 16-byte aligned, into shared rows `lds` apart by
// 16-byte cp.async; rows at or past `nvalid` are zero-filled without a
// load. All THREADS threads of the block.
template <int THREADS, typename E>
__device__ __forceinline__ void stage(E* s, int lds, const E* g, size_t gs,
                                      int rows, int nvalid, int cols) {
  constexpr int CH = 16 / (int)sizeof(E);
  const int cpr = cols / CH;
  for (int e = threadIdx.x; e < rows * cpr; e += THREADS) {
    const int r = e / cpr, k = (e % cpr) * CH;
    const bool in = r < nvalid;
    rt::cp_async16(s + r * lds + k, in ? g + r * gs + k : g, in);
  }
}

// dt of the chunk's tokens (global rows from `row0`, `n` of them) of head
// h into sDt (0 past n) and the inclusive prefix sums of dt·a over the
// chunk into sCum, in f64 (MAX_L each; constant past n). sW: 4 doubles.
// All NT threads, two tokens each; synchronises the block before and
// after.
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

// sum over a quad (the four lanes of one row pair)
__device__ __forceinline__ double quad_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// sum over a warp's 8 row groups (lanes of one quad position)
__device__ __forceinline__ double rows_sum(double v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over the block's first `threads` threads (a multiple of
// 32), in a fixed order, in thread 0; every thread of the block calls it.
// sRed: threads / 32 doubles.
__device__ __forceinline__ double block_sum(double v, int threads,
                                            double* sRed) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();   // the last call's reader is done
  if (lane == 0 && (int)threadIdx.x < threads) sRed[warp] = v;
  __syncthreads();
  double s = 0.;
  if (threadIdx.x == 0)
    for (int w = 0; w < threads / 32; ++w) s += sRed[w];
  return s;
}

// where a block's (batch row, chunk) lies: `bc` of B·nc
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

// a pair block's 64 × 64 f32 tile in its threads' accumulator layout:
// thread t's n-tile u at float4 [u][t], so that each access is one
// conflict-free 16-byte load or store
__device__ __forceinline__ void frag_load(float (&v)[4][4], const float* f) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 w = reinterpret_cast<const float4*>(f)[u * PT + threadIdx.x];
    v[u][0] = w.x;
    v[u][1] = w.y;
    v[u][2] = w.z;
    v[u][3] = w.w;
  }
}

__device__ __forceinline__ void frag_store(float* f, const float (&v)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    reinterpret_cast<float4*>(f)[u * PT + threadIdx.x] =
        make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
}

// -- 1: prefix sums and each chunk's own state gradient ----------------------
// Grid (H, n_chunks, B). cum (B, nc, H, L) f64 receives the prefix sums
// of dt·a; dec (B, nc, H) their last; dstates (B, nc, H, P, N) f32
// Σ_i exp(cum_i)·dy_i ⊗ C_i.
template <typename T, int N>
struct StateSmem {
  static constexpr int LDP = PS + PAD<T>, LDN = N + PAD<T>;
  static constexpr size_t y = sizeof(T) * TILE * LDP;
  static constexpr size_t c = sizeof(T) * PLANES<T> * TILE * LDN;
  static constexpr size_t bytes = (8 + 4 + 4) * MAX_L + y + c;
};

template <typename T, int N>
__global__ void __launch_bounds__(NT)
    ssd_dstate_kernel(const T* __restrict__ dy, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ cm,
                      double* __restrict__ cum, float* __restrict__ dstates,
                      float* __restrict__ dec, int S, int H, int P, int L) {
  using Sm = StateSmem<T, N>;
  constexpr int LDP = Sm::LDP, LDN = Sm::LDN;
  constexpr int CH = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  double* sCum = reinterpret_cast<double*>(smem);
  float* sDt = reinterpret_cast<float*>(sCum + MAX_L);
  float* sEx = sDt + MAX_L;
  T* sY = reinterpret_cast<T*>(sEx + MAX_L);   // TILE × LDP: dy, a slice of P
  T* sC = sY + TILE * LDP;                     // planes × TILE × LDN: e^cum·C
  __shared__ double sW[4];
  const int h = blockIdx.x, c = blockIdx.y, bi = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const int c0 = c * L, n = min(L, S - c0);
  const size_t row0 = (size_t)bi * S + c0;
  const size_t xs = (size_t)H * P;
  const size_t chunk_row = ((size_t)bi * nc + c) * H + h;
  chunk_cums(dt, row0, n, H, h, a[h], sDt, sCum, sW);
  for (int t = tid; t < L; t += NT) cum[chunk_row * L + t] = sCum[t];
  for (int t = tid; t < MAX_L; t += NT) sEx[t] = decay(sCum[t]);
  const T* dyh = dy + row0 * xs + (size_t)h * P;
  for (int p0 = 0; p0 < P; p0 += PS) {
    const int pw = min(PS, P - p0);
    const bool active = 16 * warp < pw;
    float acc[N / 8][4];
    zero(acc);
    for (int k0 = 0; k0 < n; k0 += TILE) {
      __syncthreads();   // the last tile's products are done; sEx is written
      stage<NT>(sY, LDP, dyh + (size_t)k0 * xs + p0, xs, TILE, n - k0, pw);
      rt::cp_async_commit();
      // exp(cum_i)·C_i, split once where it is staged
      for (int e = tid; e < TILE * (N / CH); e += NT) {
        const int r = e / (N / CH), col = (e % (N / CH)) * CH;
        float v[CH];
        if (r < n - k0) {
          rt::load_vec<T, CH>(cm + (row0 + k0 + r) * N + col, v);
        } else {
#pragma unroll
          for (int i = 0; i < CH; ++i) v[i] = 0.f;
        }
        const float sc = sEx[k0 + r];
        rt::Vec<T, CH> hi, lo;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const float w = v[i] * sc;
          hi.v[i] = Cvt<T>::from_f(w);
          lo.v[i] = Cvt<T>::from_f(w - Cvt<T>::to_f(hi.v[i]));
        }
        *reinterpret_cast<rt::Vec<T, CH>*>(sC + r * LDN + col) = hi;
        if constexpr (IS_BF16<T>)
          *reinterpret_cast<rt::Vec<T, CH>*>(sC + TILE * LDN + r * LDN + col) = lo;
      }
      rt::cp_async_wait<0>();
      __syncthreads();
      // A(p, i) = dy_i[p], B(i, n) = exp(cum_i)·C_i[n]
      if (active) {
        mm<true, true, N / 8>(acc, N / 8, sY + 16 * warp, LDP, sC, LDN, TILE);
        if constexpr (IS_BF16<T>)
          mm<true, true, N / 8>(acc, N / 8, sY + 16 * warp, LDP, sC + TILE * LDN,
                                LDN, TILE);
      }
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
  if (tid == 0) dec[chunk_row] = (float)sCum[MAX_L - 1];
}

// -- 2: the reverse recurrence over chunks -----------------------------------
// Grid (B·H, blocks of a head's P·N / 4). One thread per four consecutive
// (p, n) of a (row, head). gst (planes, B, nc, H, P, N) in T receives the
// gradient of the state after chunk c (bf16: a high and a low plane),
// dinit the gradient of the state before the first; gspart (B, nc, H,
// blocks) f64 each block's part of <G after c, S before c>. dfinal (B, H,
// P, N) or null.
template <typename T>
__global__ void __launch_bounds__(RT_THREADS)
    ssd_drecur_kernel(const float* __restrict__ dfinal,
                      const float* __restrict__ dstates,
                      const float* __restrict__ dec, const T* __restrict__ prev,
                      T* __restrict__ gst, float* __restrict__ dinit,
                      double* __restrict__ gspart, int B, int H, int PN,
                      int nc) {
  __shared__ double sRed[RT_THREADS / 32];
  const int bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int blk = blockIdx.y, nblk = gridDim.y;
  const int e = 4 * (blk * RT_THREADS + threadIdx.x);
  const bool on = e < PN;
  const size_t hpn = (size_t)H * PN;
  const size_t plane = (size_t)B * nc * hpn;
  float4 g = on && dfinal != nullptr
                 ? *reinterpret_cast<const float4*>(dfinal + (size_t)bh * PN + e)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    const size_t row = (size_t)bi * nc + c;
    const size_t at = row * hpn + (size_t)h * PN + e;
    double gs = 0.;
    if (on) {
      float4 s;
      if constexpr (IS_BF16<T>) {
        uint2 hi, lo;
        split2(g.x, g.y, hi.x, lo.x);
        split2(g.z, g.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(gst + at) = hi;
        *reinterpret_cast<uint2*>(gst + plane + at) = lo;
        float v[4], w[4];
        rt::load_vec<T, 4>(prev + at, v);
        rt::load_vec<T, 4>(prev + plane + at, w);
        s = make_float4(v[0] + w[0], v[1] + w[1], v[2] + w[2], v[3] + w[3]);
      } else {
        *reinterpret_cast<float4*>(gst + at) = g;
        s = *reinterpret_cast<const float4*>(prev + at);
      }
      gs = (double)g.x * s.x + (double)g.y * s.y + (double)g.z * s.z +
           (double)g.w * s.w;
      const float d = expf(dec[row * H + h]);
      const float4 ds = *reinterpret_cast<const float4*>(dstates + at);
      g.x = g.x * d + ds.x;
      g.y = g.y * d + ds.y;
      g.z = g.z * d + ds.z;
      g.w = g.w * d + ds.w;
    }
    gs = block_sum(gs, RT_THREADS, sRed);
    if (threadIdx.x == 0) gspart[(row * H + h) * nblk + blk] = gs;
  }
  if (on) *reinterpret_cast<float4*>(dinit + (size_t)bh * PN + e) = g;
}

// -- 3: the pair pass -----------------------------------------------------------
// Grid (ceil(H / HG), B·nc, L / TILE): the block's group of heads and key
// tile j. For each head: dx; ddt receives x·dxdt (pass 5 adds a·dl); colp
// (B, nc, H, L) f64 −Σ_{i≥j} w_ij − u_j; rowp (B, nc,
// H, L / TILE, L) f64 the key tile's part of Σ_{j≤i} w_ij; upart and ddpart
// (B, nc, H, L / TILE) the tile's sums of u and of dy·x. mpart (groups, B,
// nc, pairs, 64, 64) f32 receives Σ over the group's heads of Mᵀ (keys as
// rows) for each query tile i ≥ j, pair (i, j) at i (i + 1) / 2 + j.
template <typename T, int N>
struct PairSmem {
  static constexpr int LDP = PS + PAD<T>, LDN = N + PAD<T>;
  static constexpr size_t lines = (8 + 4) * MAX_L;   // sCum, sDt
  static constexpr size_t bj = sizeof(T) * TILE * LDN;
  static constexpr size_t x = sizeof(T) * TILE * LDP;
  // two dy tiles, or the dxdt exchange (64 × 68 f32)
  static constexpr size_t dy2 = 2 * x > 4 * TILE * 68 ? 2 * x : 4 * TILE * 68;
  static constexpr size_t g = sizeof(T) * PLANES<T> * PS * LDN;   // also a C tile
  static constexpr size_t red = 8 * (8 * TILE + 8);   // 8 rows of 64, 4 more
  static constexpr size_t sc = IS_BF16<T> ? 0 : 4 * 8 * 16 * LDS;
  static constexpr size_t fixed = lines + bj + x + dy2 + g + red + sc;
  // C·Bᵀ and the group's M sum of each query tile: 2 f32 tiles each
  static size_t bytes(int tiles) { return fixed + 2 * 4 * (size_t)FRAG * tiles; }
};

template <typename T, int N>
__global__ void __launch_bounds__(PT, 1)
    ssd_dpair_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ dt, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ dskip,
                     const T* __restrict__ gst, const double* __restrict__ cum,
                     T* __restrict__ dx, float* __restrict__ ddt,
                     double* __restrict__ colp, double* __restrict__ rowp,
                     double* __restrict__ upart, double* __restrict__ ddpart,
                     float* __restrict__ mpart, int B, int S, int H, int P,
                     int L) {
  using Sm = PairSmem<T, N>;
  constexpr bool BF = IS_BF16<T>;
  constexpr int LDP = Sm::LDP, LDN = Sm::LDN, LDX = 68;
  const int hg = blockIdx.x, bc = blockIdx.y, kj = blockIdx.z;
  const Chunk k = chunk_of(bc, S, L);
  const int j0 = kj * TILE;
  if (j0 >= k.n) return;
  const int nq = (k.n + TILE - 1) / TILE, ntq = nq - kj, ntm = L / TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const int jr0 = 16 * (warp & 3);   // this warp's first key of the tile
  const int ih = warp >> 2, ic0 = 32 * ih;   // its half of a query tile
  const size_t xs = (size_t)H * P;
  const int nps = (P + PS - 1) / PS;
  extern __shared__ __align__(16) unsigned char smem[];
  double* sCum = reinterpret_cast<double*>(smem);
  float* sDt = reinterpret_cast<float*>(sCum + MAX_L);
  T* sBj = reinterpret_cast<T*>(smem + Sm::lines);
  T* sX = reinterpret_cast<T*>(smem + Sm::lines + Sm::bj);
  T* sDy = reinterpret_cast<T*>(smem + Sm::lines + Sm::bj + Sm::x);
  float* sXch = reinterpret_cast<float*>(sDy);   // 64 × LDX, after the tiles
  T* sG = reinterpret_cast<T*>(smem + Sm::lines + Sm::bj + Sm::x + Sm::dy2);
  double* sRed = reinterpret_cast<double*>(smem + Sm::lines + Sm::bj + Sm::x +
                                           Sm::dy2 + Sm::g);
  float* sSc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sRed) +
                                        Sm::red) + warp * 16 * LDS;
  float* sCB = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sRed) +
                                        Sm::red + Sm::sc);
  float* sMacc = sCB + (size_t)FRAG * ntm;
  const size_t gplane = (size_t)B * k.nc * H * P * N;

  // B of the key tile; C·Bᵀ of each query tile, once for every head
  stage<PT>(sBj, LDN, bm + (k.row0 + j0) * N, N, TILE, k.n - j0, N);
  for (int u = 0; u < ntq; ++u) {
    const int i0 = (kj + u) * TILE;
    __syncthreads();   // the last tile's product is done with sG
    stage<PT>(sG, LDN, cm + (k.row0 + i0) * N, N, TILE, k.n - i0, N);
    rt::cp_async_commit();
    rt::cp_async_wait<0>();
    __syncthreads();
    float cb[4][4];
    zero(cb);
    // A(j, n) = B_j[n], B(n, i) = C_i[n]
    mm<false, false, 4>(cb, 4, sBj + jr0 * LDN, LDN, sG + ic0 * LDN, LDN, N);
    frag_store(sCB + (size_t)FRAG * u, cb);
    zero(cb);
    frag_store(sMacc + (size_t)FRAG * u, cb);
  }

  const int h_end = min(H, (hg + 1) * HG);
  for (int h = hg * HG; h < h_end; ++h) {
    const size_t chunk_row = ((size_t)k.bi * k.nc + k.c) * H + h;
    const T* xh = x + k.row0 * xs + (size_t)h * P;
    const T* dyh = dy + k.row0 * xs + (size_t)h * P;
    const T* gh = gst + chunk_row * P * N;
    auto stage_x = [&](int s) {
      stage<PT>(sX, LDP, xh + (size_t)j0 * xs + s * PS, xs, TILE, k.n - j0,
                min(PS, P - s * PS));
    };
    auto stage_dy = [&](int slot, int u, int s) {
      const int i0 = (kj + u) * TILE;
      stage<PT>(sDy + slot * TILE * LDP, LDP, dyh + (size_t)i0 * xs + s * PS,
                xs, TILE, k.n - i0, min(PS, P - s * PS));
    };
    auto stage_g = [&](int s) {
      const int pw = min(PS, P - s * PS);
      for (int pl = 0; pl < PLANES<T>; ++pl)
        stage<PT>(sG + pl * PS * LDN, LDN, gh + pl * gplane + (size_t)s * PS * N,
                  N, pw, pw, N);
    };
    __syncthreads();   // the last head is done with every tile
    if (nps == 1) {   // x, G and the first dy tile; the second behind them
      stage_x(0);
      stage_g(0);
      stage_dy(0, 0, 0);
      rt::cp_async_commit();
      if (ntq > 1) stage_dy(1, 1, 0);
      rt::cp_async_commit();
    }
    for (int t = tid; t < MAX_L; t += PT) {
      sCum[t] = cum[chunk_row * L + min(t, L - 1)];
      sDt[t] = t < k.n ? dt[(k.row0 + t) * H + h] : 0.f;
    }
    __syncthreads();
    const int ja = j0 + jr0 + g;   // this lane's two keys, chunk-relative
    const double cum_a = sCum[ja], cum_b = sCum[ja + 8];
    const float dt_a = sDt[ja], dt_b = sDt[ja + 8];
    const double cum_last = sCum[L - 1];
    double col[2] = {0., 0.};
    float dxdt[8][4];
    zero(dxdt);

    // the scores' transpose of query tile u in place of C·Bᵀ, and, where
    // xd is given, Mᵀ (returned in xd), w's row sums into sRed and its
    // column sums into col
    auto decays = [&](float (&s)[4][4], float (*xd)[4], int u) {
      const int i0 = (kj + u) * TILE + ic0;
      double rs[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c1 = 0; c1 < 2; ++c1) {
          const int i = i0 + 8 * t + q2 + c1;
          const double ci = sCum[i];
          const float da = i >= ja ? decay(ci - cum_a) : 0.f;
          const float db = i >= ja + 8 ? decay(ci - cum_b) : 0.f;
          s[t][c1] *= da;
          s[t][2 + c1] *= db;
          if (xd != nullptr) {
            // w_ij rounded once: the row and the column sums take the
            // same value, so each diagonal w_ii cancels exactly in dl
            const float wa = s[t][c1] * xd[t][c1] * dt_a;
            const float wb = s[t][2 + c1] * xd[t][2 + c1] * dt_b;
            col[0] += (double)wa;
            col[1] += (double)wb;
            rs[t][c1] = (double)wa + (double)wb;
            xd[t][c1] *= da * dt_a;
            xd[t][2 + c1] *= db * dt_b;
          }
        }
      if (xd != nullptr) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int c1 = 0; c1 < 2; ++c1) {
            const double v = rows_sum(rs[t][c1]);
            if (g == 0) sRed[(warp & 3) * TILE + ic0 + 8 * t + q2 + c1] = v;
          }
      }
    };
    // dxdt += scoresᵀ · dy of query tile u's half (slot, pw columns)
    auto add_dxdt = [&](const float (&s)[4][4], int slot, int pw) {
      const T* dyq = sDy + slot * TILE * LDP + ic0 * LDP;
      if constexpr (BF) {
        mm_scores<8>(dxdt, pw / 8, s, dyq, LDP);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          *reinterpret_cast<float2*>(sSc + g * LDS + 8 * t + q2) =
              make_float2(s[t][0], s[t][1]);
          *reinterpret_cast<float2*>(sSc + (g + 8) * LDS + 8 * t + q2) =
              make_float2(s[t][2], s[t][3]);
        }
        __syncwarp();
        mm<false, true, 8>(dxdt, pw / 8, sSc, LDS, dyq, LDP, 32);
        __syncwarp();
      }
    };

    // every query tile: dy·xᵀ once, then M, w's sums and, with one slice
    // of P, the scores' product with dy
    for (int u = 0; u < ntq; ++u) {
      float xd[4][4];
      zero(xd);
      int slot = u & 1;
      if (nps == 1) {
        rt::cp_async_wait<1>();
        __syncthreads();
        // A(j, p) = x_j[p], B(p, i) = dy_i[p]
        mm<false, false, 4>(xd, 4, sX + jr0 * LDP, LDP,
                            sDy + slot * TILE * LDP + ic0 * LDP, LDP, P);
      } else {
        slot = 0;
        for (int s = 0; s < nps; ++s) {
          __syncthreads();
          stage_x(s);
          stage_dy(0, u, s);
          rt::cp_async_commit();
          rt::cp_async_wait<0>();
          __syncthreads();
          mm<false, false, 4>(xd, 4, sX + jr0 * LDP, LDP, sDy + ic0 * LDP, LDP,
                              min(PS, P - s * PS));
        }
      }
      float s[4][4];
      frag_load(s, sCB + (size_t)FRAG * u);
      decays(s, xd, u);
      float m[4][4];
      frag_load(m, sMacc + (size_t)FRAG * u);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[t][e] += xd[t][e];
      frag_store(sMacc + (size_t)FRAG * u, m);
      if (nps == 1) add_dxdt(s, slot, P);
      __syncthreads();   // the tile's readers are done; sRed is written
      if (tid < TILE) {
        const int i = (kj + u) * TILE + tid;
        if (i < k.n)
          rowp[(chunk_row * ntm + kj) * L + i] =
              sRed[tid] + sRed[TILE + tid] + sRed[2 * TILE + tid] +
              sRed[3 * TILE + tid];
      }
      if (nps == 1) {
        if (u + 2 < ntq) stage_dy(slot, u + 2, 0);
        rt::cp_async_commit();
      }
    }

    // per slice of P: dxdt (with more than one slice, the scores again),
    // G·B_j, dx and the row sums over P
    const float dh = dskip[h];
    double xv[2] = {0., 0.}, uu[2] = {0., 0.}, dd[2] = {0., 0.};
    const float ea = decay(cum_last - cum_a), eb = decay(cum_last - cum_b);
    for (int s = 0; s < nps; ++s) {
      const int p0 = s * PS, pw = min(PS, P - p0);
      if (nps > 1) {
        zero(dxdt);
        for (int u = 0; u < ntq; ++u) {
          __syncthreads();
          stage_dy(0, u, s);
          rt::cp_async_commit();
          rt::cp_async_wait<0>();
          __syncthreads();
          float sc[4][4];
          frag_load(sc, sCB + (size_t)FRAG * u);
          decays(sc, nullptr, u);
          add_dxdt(sc, 0, pw);
        }
        __syncthreads();
        stage_x(s);
        stage_g(s);
        rt::cp_async_commit();
        rt::cp_async_wait<0>();
        __syncthreads();
      }
      // this warp's columns of the slice: its 16-column pairs alternate
      // with those of the other warp of its keys
      float gb[8][4];
      zero(gb);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if ((pp & 1) != ih || 16 * pp >= pw) continue;
        float two[2][4];
        zero(two);
        // A(j, n) = B_j[n], B(n, p) = G[p][n]
        mm<false, false, 2>(two, 2, sBj + jr0 * LDN, LDN, sG + 16 * pp * LDN,
                            LDN, N);
        if constexpr (BF)
          mm<false, false, 2>(two, 2, sBj + jr0 * LDN, LDN,
                              sG + (PS + 16 * pp) * LDN, LDN, N);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gb[2 * pp][e] = two[0][e];
          gb[2 * pp + 1][e] = two[1][e];
        }
      }
      // the two warps of these keys swap the parts of dxdt they summed
      // over their own query columns: each column is the sum of both
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (8 * t >= pw || ((t >> 1) & 1) == ih) continue;
        const int c = 8 * t + q2;
        *reinterpret_cast<float2*>(sXch + (jr0 + g) * LDX + c) =
            make_float2(dxdt[t][0], dxdt[t][1]);
        *reinterpret_cast<float2*>(sXch + (jr0 + g + 8) * LDX + c) =
            make_float2(dxdt[t][2], dxdt[t][3]);
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (8 * t >= pw || ((t >> 1) & 1) != ih) continue;
        const int c = 8 * t + q2;   // slice-relative column
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = jr0 + g + 8 * half, J = j0 + r;
          const float2 o = *reinterpret_cast<const float2*>(sXch + r * LDX + c);
          const float e = half ? eb : ea, dtj = half ? dt_b : dt_a;
          const float g0 = gb[t][2 * half], g1 = gb[t][2 * half + 1];
          const float v0 = (dxdt[t][2 * half] + o.x) + e * g0;
          const float v1 = (dxdt[t][2 * half + 1] + o.y) + e * g1;
          const float2 xv2 = Cvt<T>::ld2(sX + r * LDP + c);
          uu[half] += (double)(e * dtj) * ((double)xv2.x * g0 + (double)xv2.y * g1);
          xv[half] += (double)xv2.x * v0 + (double)xv2.y * v1;
          if (J < k.n) {
            const size_t at = (size_t)J * xs + p0 + c;
            const float2 dv = Cvt<T>::ld2(dyh + at);
            dd[half] += (double)dv.x * xv2.x + (double)dv.y * xv2.y;
            const float o0 = dtj * v0 + dh * dv.x, o1 = dtj * v1 + dh * dv.y;
            T* dxo = dx + k.row0 * xs + (size_t)h * P + at;
            if constexpr (BF)
              *reinterpret_cast<__nv_bfloat162*>(dxo) = __floats2bfloat162_rn(o0, o1);
            else
              *reinterpret_cast<float2*>(dxo) = make_float2(o0, o1);
          }
        }
      }
    }

    // the key rows' sums: over a quad, then the two warps of these keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      col[r] = quad_sum(col[r]);
      xv[r] = quad_sum(xv[r]);
      uu[r] = quad_sum(uu[r]);
      dd[r] = quad_sum(dd[r]);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int jr = jr0 + g + 8 * r;
        sRed[(0 * 2 + ih) * TILE + jr] = col[r];
        sRed[(1 * 2 + ih) * TILE + jr] = xv[r];
        sRed[(2 * 2 + ih) * TILE + jr] = uu[r];
        sRed[(3 * 2 + ih) * TILE + jr] = dd[r];
      }
    }
    __syncthreads();
    double us = 0., ds = 0.;
    if (tid < TILE) {
      const int J = j0 + tid;
      const double cv = sRed[0 * TILE + tid] + sRed[1 * TILE + tid];
      const double xvv = sRed[2 * TILE + tid] + sRed[3 * TILE + tid];
      us = sRed[4 * TILE + tid] + sRed[5 * TILE + tid];
      ds = sRed[6 * TILE + tid] + sRed[7 * TILE + tid];
      if (J < k.n) {
        ddt[(k.row0 + J) * H + h] = (float)xvv;
        colp[chunk_row * L + J] = -cv - us;
      }
    }
    double* sTwo = sRed + 8 * TILE;   // past the 8 planes above
    us = warp_sum(us);
    ds = warp_sum(ds);
    if (lane == 0 && warp < 2) {
      sTwo[warp] = us;
      sTwo[2 + warp] = ds;
    }
    __syncthreads();
    if (tid == 0) {
      upart[chunk_row * ntm + kj] = sTwo[0] + sTwo[1];
      ddpart[chunk_row * ntm + kj] = sTwo[2] + sTwo[3];
    }
  }

  // the group's M sums, keys as rows, in f32
  const int npairs = ntm * (ntm + 1) / 2;
  for (int u = 0; u < ntq; ++u) {
    const int qi = kj + u;
    float m[4][4];
    frag_load(m, sMacc + (size_t)FRAG * u);
    float* out = mpart + (((size_t)hg * B * k.nc + bc) * npairs +
                          qi * (qi + 1) / 2 + kj) * TILE * TILE;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = ic0 + 8 * t + q2;
      *reinterpret_cast<float2*>(out + (jr0 + g) * TILE + c) =
          make_float2(m[t][0], m[t][1]);
      *reinterpret_cast<float2*>(out + (jr0 + g + 8) * TILE + c) =
          make_float2(m[t][2], m[t][3]);
    }
  }
}

// -- 4: dC and dB ---------------------------------------------------------------
// Grid (2 · L / TILE · N / NB, B·nc): dC of query tile t or dB of key tile
// t, NB columns of N from n0. The pair term from the groups' M sums, split
// where they are staged; the state term over every head and slice of P
// through a ring of STAGES (the head's dy or x tile and its S or G rows);
// offp (B, nc, H, N / NB, L) f64 receives dC's part of
// exp(cum_i)·C_i·(Sᵀ dy_i).
template <typename T, int N>
struct CdbSmem {
  static constexpr int LDA = PS + PAD<T>, LDB = NB<N> + PAD<T>;
  static constexpr size_t a = sizeof(T) * TILE * LDA;   // also an M plane
  static constexpr size_t b = sizeof(T) * PS * LDB;     // one plane
  static constexpr size_t stage = a + PLANES<T> * b;
  static constexpr size_t co = sizeof(T) * TILE * LDB;
  static constexpr size_t bytes = STAGES * stage + co;
};

template <typename T, int N>
__global__ void __launch_bounds__(NT)
    ssd_dcdb_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ dt, const T* __restrict__ bm,
                    const T* __restrict__ cm, const T* __restrict__ prev,
                    const T* __restrict__ gst, const double* __restrict__ cum,
                    const float* __restrict__ mpart, T* __restrict__ dc,
                    T* __restrict__ db, double* __restrict__ offp, int B,
                    int S, int H, int P, int L, int groups) {
  using Sm = CdbSmem<T, N>;
  constexpr bool BF = IS_BF16<T>;
  constexpr int W = NB<N>, NW8 = W / 8, LDA = Sm::LDA, LDB = Sm::LDB;
  constexpr int NBLK = N / W;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntm = L / TILE;
  const int which = blockIdx.x / (ntm * NBLK);   // 0: dC, 1: dB
  const int t = (blockIdx.x / NBLK) % ntm, nb = blockIdx.x % NBLK;
  const int bc = blockIdx.y;
  const Chunk k = chunk_of(bc, S, L);
  const int r0 = t * TILE;
  if (r0 >= k.n) return;
  const bool is_db = which == 1;
  const int nq = (k.n + TILE - 1) / TILE, n0 = nb * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const size_t xs = (size_t)H * P;
  const int nps = (P + PS - 1) / PS, npairs = ntm * (ntm + 1) / 2;
  const size_t plane = (size_t)B * k.nc * H * P * N;
  auto slot_a = [&](int sl) {
    return reinterpret_cast<T*>(smem + sl * Sm::stage);
  };
  auto slot_b = [&](int sl, int pl) {
    return reinterpret_cast<T*>(smem + sl * Sm::stage + Sm::a + pl * Sm::b);
  };
  T* sCo = reinterpret_cast<T*>(smem + STAGES * Sm::stage);
  float tot[NW8][4];
  zero(tot);

  // the pair term: the groups' M sums (keys as rows) times B or C tiles
  const int p_lo = is_db ? t : 0, p_hi = is_db ? nq - 1 : t;
  T* sMh = slot_a(0);
  T* sMl = slot_a(1);
  T* sOp = slot_b(0, 0);
  for (int p = p_lo; p <= p_hi; ++p) {
    const int pair = is_db ? p * (p + 1) / 2 + t : t * (t + 1) / 2 + p;
    const T* op = (is_db ? cm : bm) + (k.row0 + (size_t)p * TILE) * N + n0;
    __syncthreads();   // the last partner's product is done
    stage<NT>(sOp, LDB, op, N, TILE, k.n - p * TILE, W);
    rt::cp_async_commit();
    const float* mp = mpart + ((size_t)bc * npairs + pair) * TILE * TILE;
    const size_t gstride = (size_t)B * k.nc * npairs * TILE * TILE;
    for (int e = tid; e < TILE * TILE / 4; e += NT) {
      float4 v = reinterpret_cast<const float4*>(mp)[e];
      for (int gi = 1; gi < groups; ++gi) {
        const float4 w = reinterpret_cast<const float4*>(mp + gi * gstride)[e];
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      const int r = (4 * e) / TILE, c = (4 * e) % TILE;
      if constexpr (BF) {
        uint2 hi, lo;
        split2(v.x, v.y, hi.x, lo.x);
        split2(v.z, v.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(sMh + r * LDA + c) = hi;
        *reinterpret_cast<uint2*>(sMl + r * LDA + c) = lo;
      } else {
        *reinterpret_cast<float4*>(sMh + r * LDA + c) = v;
      }
    }
    rt::cp_async_wait<0>();
    __syncthreads();
    if (is_db) {   // A(j, i) = Mᵀ[j][i], B(i, n) = C_i[n]
      mm<false, true, NW8>(tot, NW8, sMh + 16 * warp * LDA, LDA, sOp, LDB, TILE);
      if constexpr (BF)
        mm<false, true, NW8>(tot, NW8, sMl + 16 * warp * LDA, LDA, sOp, LDB, TILE);
    } else {       // A(i, j) = Mᵀ[j][i], B(j, n) = B_j[n]
      mm<true, true, NW8>(tot, NW8, sMh + 16 * warp, LDA, sOp, LDB, TILE);
      if constexpr (BF)
        mm<true, true, NW8>(tot, NW8, sMl + 16 * warp, LDA, sOp, LDB, TILE);
    }
  }

  // the state term, a head at a time: dC: exp(cum_i)·dy_i·S, dB:
  // exp(cum_last − cum_j) dt_j·x_j·G
  const T* rows = (is_db ? x : dy) + (k.row0 + r0) * xs;
  const T* st = is_db ? gst : prev;
  const int steps = H * nps;
  auto issue = [&](int step) {
    if (step < steps) {
      const int h = step / nps, s = step % nps, sl = step % STAGES;
      const int pw = min(PS, P - s * PS);
      stage<NT>(slot_a(sl), LDA, rows + (size_t)h * P + s * PS, xs, TILE,
                k.n - r0, pw);
      const T* src = st + ((((size_t)k.bi * k.nc + k.c) * H + h) * P + s * PS) * N + n0;
      for (int pl = 0; pl < PLANES<T>; ++pl)
        stage<NT>(slot_b(sl, pl), LDB, src + pl * plane, N, pw, pw, W);
    }
    rt::cp_async_commit();
  };
  __syncthreads();   // the pair term is done with slots 0 and 1
  if (!is_db) stage<NT>(sCo, LDB, cm + (k.row0 + r0) * N + n0, N, TILE, k.n - r0, W);
  issue(0);
  issue(1);
  const int ia = r0 + 16 * warp + g;   // this lane's two rows, chunk-relative
  float acc[NW8][4];
  for (int step = 0; step < steps; ++step) {
    const int h = step / nps, s = step % nps, sl = step % STAGES;
    rt::cp_async_wait<1>();
    __syncthreads();
    issue(step + 2);
    if (s == 0) zero(acc);
    // A(r, p) = dy_i[p] or x_j[p], B(p, n) = S[p][n] or G[p][n]
    const int pw = min(PS, P - s * PS);
    mm<false, true, NW8>(acc, NW8, slot_a(sl) + 16 * warp * LDA, LDA,
                         slot_b(sl, 0), LDB, pw);
    if constexpr (BF)
      mm<false, true, NW8>(acc, NW8, slot_a(sl) + 16 * warp * LDA, LDA,
                           slot_b(sl, 1), LDB, pw);
    if (s < nps - 1) continue;
    const size_t cr = ((size_t)k.bi * k.nc + k.c) * H + h;
    float sc[2];
    if (is_db) {
      const double last = cum[cr * L + L - 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = ia + 8 * r;
        sc[r] = j < k.n ? decay(last - cum[cr * L + j]) * dt[(k.row0 + j) * H + h]
                        : 0.f;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = ia + 8 * r;
        sc[r] = i < k.n ? decay(cum[cr * L + i]) : 0.f;
      }
      // exp(cum_i)·C_i·(Sᵀ dy_i) over this block's columns
      double off[2] = {0., 0.};
#pragma unroll
      for (int tt = 0; tt < NW8; ++tt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 cv = Cvt<T>::ld2(sCo + (ia - r0 + 8 * r) * LDB + 8 * tt + q2);
          off[r] += (double)acc[tt][2 * r] * cv.x + (double)acc[tt][2 * r + 1] * cv.y;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        off[r] = quad_sum(off[r]);
        const int i = ia + 8 * r;
        if ((lane & 3) == 0 && i < k.n)
          offp[(cr * NBLK + nb) * L + i] = (double)sc[r] * off[r];
      }
    }
#pragma unroll
    for (int tt = 0; tt < NW8; ++tt) {
      tot[tt][0] = fmaf(sc[0], acc[tt][0], tot[tt][0]);
      tot[tt][1] = fmaf(sc[0], acc[tt][1], tot[tt][1]);
      tot[tt][2] = fmaf(sc[1], acc[tt][2], tot[tt][2]);
      tot[tt][3] = fmaf(sc[1], acc[tt][3], tot[tt][3]);
    }
  }
  rt::cp_async_wait<0>();

  T* out = is_db ? db : dc;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ia + 8 * r;
    if (i >= k.n) continue;
    T* o = out + (k.row0 + i) * N + n0;
#pragma unroll
    for (int tt = 0; tt < NW8; ++tt) {
      const float o0 = tot[tt][2 * r], o1 = tot[tt][2 * r + 1];
      if constexpr (BF)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * tt + q2) = __floats2bfloat162_rn(o0, o1);
      else
        *reinterpret_cast<float2*>(o + 8 * tt + q2) = make_float2(o0, o1);
    }
  }
}

// -- 5: dl, ddt and da's parts ----------------------------------------------------
// Grid (H, B·nc), a thread a token of the chunk: dcum from its parts, dl_t =
// Σ_{i≥t} dcum_i plus the chunk-end terms (the key tiles' sums of u and
// exp(cum_last)·<G, S>), ddt += a·dl; dapart (B, nc, H) Σ dt·dl.
template <typename T>
__global__ void __launch_bounds__(FIN_THREADS)
    ssd_dfinish_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                       const double* __restrict__ colp,
                       const double* __restrict__ rowp,
                       const double* __restrict__ offp,
                       const double* __restrict__ upart,
                       const double* __restrict__ gspart,
                       const float* __restrict__ dec, float* __restrict__ ddt,
                       double* __restrict__ dapart, int S, int H, int L,
                       int nblk, int ngs) {
  constexpr int WARPS = FIN_THREADS / 32;
  __shared__ double sW[WARPS];
  const int h = blockIdx.x, bc = blockIdx.y;
  const Chunk k = chunk_of(bc, S, L);
  const size_t cr = (size_t)bc * H + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntm = L / TILE, nq = (k.n + TILE - 1) / TILE;
  double v = 0.;
  if (tid < k.n) {
    v = colp[cr * L + tid];
    for (int kj = 0; kj <= tid / TILE; ++kj) v += rowp[(cr * ntm + kj) * L + tid];
    for (int nb = 0; nb < nblk; ++nb) v += offp[(cr * nblk + nb) * L + tid];
  }
  double gs = 0., end = 0.;
  for (int b = 0; b < ngs; ++b) gs += gspart[cr * ngs + b];
  for (int kj = 0; kj < nq; ++kj) end += upart[cr * ntm + kj];
  end += (double)expf(fminf(dec[cr], 0.f)) * gs;
  double r = v;   // inclusive suffix sums within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double w = __shfl_down_sync(0xffffffffu, r, o);
    if (lane + o < 32) r += w;
  }
  if (lane == 0) sW[warp] = r;
  __syncthreads();
  double after = 0.;
  for (int w = warp + 1; w < WARPS; ++w) after += sW[w];
  double da = 0.;
  if (tid < k.n) {
    const double dl = r + after + end;
    const size_t at = (k.row0 + tid) * H + h;
    ddt[at] = (float)(ddt[at] + (double)a[h] * dl);
    da = (double)dt[at] * dl;
  }
  __shared__ double sRed[WARPS];
  da = block_sum(da, FIN_THREADS, sRed);
  if (tid == 0) dapart[cr] = da;
}

// -- 6: da and dD -------------------------------------------------------------------
// Grid (H): the sums of dapart over the batch rows and chunks, and of
// ddpart over them and the key tiles, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
    ssd_dsum_kernel(const double* __restrict__ dapart,
                    const double* __restrict__ ddpart, float* __restrict__ da,
                    float* __restrict__ dd, int B, int S, int H, int L) {
  __shared__ double sRed[SUM_THREADS / 32];
  const int h = blockIdx.x, nc = (S + L - 1) / L, ntm = L / TILE;
  double va = 0., vd = 0.;
  for (int r = threadIdx.x; r < B * nc; r += SUM_THREADS) {
    const int n = min(L, S - (r % nc) * L);
    va += dapart[(size_t)r * H + h];
    for (int kj = 0; kj * TILE < n; ++kj) vd += ddpart[((size_t)r * H + h) * ntm + kj];
  }
  va = block_sum(va, SUM_THREADS, sRed);
  vd = block_sum(vd, SUM_THREADS, sRed);
  if (threadIdx.x == 0) {
    da[h] = (float)va;
    dd[h] = (float)vd;
  }
}

// -- launch -------------------------------------------------------------------

struct Args {
  const void *x, *dt, *a, *b, *c, *d, *prev, *dy, *dfinal;
  void *dx, *ddt, *da, *db, *dc, *dd, *dinit;
  void *cum, *dstates, *dec, *gst, *gspart, *mpart, *colp, *rowp, *upart,
      *ddpart, *offp, *dapart;
  int B, S, H, P, L;
  cudaStream_t stream;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int N>
cudaError_t launch(const Args& g) {
  const int nc = (g.S + g.L - 1) / g.L, ntm = g.L / TILE;
  const size_t smem1 = StateSmem<T, N>::bytes;
  const size_t smem3 = PairSmem<T, N>::bytes(ntm);
  const size_t smem4 = CdbSmem<T, N>::bytes;
  static size_t set3 = 0;
  static bool attrs_set = false;
  cudaError_t err;
  if (!attrs_set) {
    if ((err = allow_smem(ssd_dstate_kernel<T, N>, smem1)) != cudaSuccess ||
        (err = allow_smem(ssd_dcdb_kernel<T, N>, smem4)) != cudaSuccess)
      return err;
    attrs_set = true;
  }
  if (smem3 > set3) {
    if ((err = allow_smem(ssd_dpair_kernel<T, N>, smem3)) != cudaSuccess) return err;
    set3 = smem3;
  }
  const int PN = g.P * N;
  const int ngs = (PN / 4 + RT_THREADS - 1) / RT_THREADS;
  const int groups = (g.H + HG - 1) / HG, nblk = N / NB<N>;
  const T* x = static_cast<const T*>(g.x);
  const T* dy = static_cast<const T*>(g.dy);
  const float* dt = static_cast<const float*>(g.dt);
  const float* a = static_cast<const float*>(g.a);
  const T* bm = static_cast<const T*>(g.b);
  const T* cm = static_cast<const T*>(g.c);
  const T* prev = static_cast<const T*>(g.prev);
  double* cum = static_cast<double*>(g.cum);
  float* dstates = static_cast<float*>(g.dstates);
  float* dec = static_cast<float*>(g.dec);
  T* gst = static_cast<T*>(g.gst);
  double* gspart = static_cast<double*>(g.gspart);
  float* mpart = static_cast<float*>(g.mpart);
  double* colp = static_cast<double*>(g.colp);
  double* rowp = static_cast<double*>(g.rowp);
  double* upart = static_cast<double*>(g.upart);
  double* ddpart = static_cast<double*>(g.ddpart);
  double* offp = static_cast<double*>(g.offp);
  double* dapart = static_cast<double*>(g.dapart);
  float* ddt = static_cast<float*>(g.ddt);
  ssd_dstate_kernel<T, N><<<dim3(g.H, nc, g.B), NT, smem1, g.stream>>>(
      dy, dt, a, cm, cum, dstates, dec, g.S, g.H, g.P, g.L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_drecur_kernel<T><<<dim3(g.B * g.H, ngs), RT_THREADS, 0, g.stream>>>(
      static_cast<const float*>(g.dfinal), dstates, dec, prev, gst,
      static_cast<float*>(g.dinit), gspart, g.B, g.H, PN, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dpair_kernel<T, N><<<dim3(groups, g.B * nc, ntm), PT, smem3, g.stream>>>(
      x, dy, dt, bm, cm, static_cast<const float*>(g.d), gst, cum,
      static_cast<T*>(g.dx), ddt, colp, rowp, upart, ddpart, mpart, g.B, g.S,
      g.H, g.P, g.L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dcdb_kernel<T, N><<<dim3(2 * ntm * nblk, g.B * nc), NT, smem4, g.stream>>>(
      x, dy, dt, bm, cm, prev, gst, cum, mpart, static_cast<T*>(g.dc),
      static_cast<T*>(g.db), offp, g.B, g.S, g.H, g.P, g.L, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dfinish_kernel<T><<<dim3(g.H, g.B * nc), FIN_THREADS, 0, g.stream>>>(
      dt, a, colp, rowp, offp, upart, gspart, dec, ddt, dapart, g.S, g.H, g.L,
      nblk, ngs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_dsum_kernel<T><<<g.H, SUM_THREADS, 0, g.stream>>>(
      dapart, ddpart, static_cast<float*>(g.da), static_cast<float*>(g.dd),
      g.B, g.S, g.H, g.L);
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
// f32, db/dc (B, S, N), dd (H,) f32, dinit (B, H, P, N) f32. Scratch, with
// T = L / 64 tiles a chunk, G = ceil(H / 8) head groups, K = N / min(N, 64)
// column blocks and R = ceil(P·N / 1024) recurrence blocks a head: cum
// (B, n, H, L) f64, dstates (B, n, H, P, N) f32, dec (B, n, H) f32, gst
// (planes, B, n, H, P, N) in x's dtype, gspart (B, n, H, R) f64, mpart (G,
// B, n, T (T + 1) / 2, 64, 64) f32, colp (B, n, H, L) f64, rowp (B, n, H,
// T, L) f64, upart and ddpart (B, n, H, T) f64, offp (B, n, H, K, L) f64,
// dapart (B, n, H) f64. x/b/c/dy/dx/db/dc/prev/gst share `dtype` (0 f32, 1
// bf16); x, dy, b, c, prev, gst, mpart, dstates and dfinal 16-byte
// aligned; P a multiple of 16, N in {16, 64, 128}, L the forward's (a
// multiple of 64, up to 256 in bf16 and 64 in f32). Six kernels on
// `stream`; returns the CUDA error code of the launches (0 = ok).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* d,
                            const void* prev, const void* dy,
                            const void* dfinal, void* dx, void* ddt, void* da,
                            void* db, void* dc, void* dd, void* dinit,
                            void* cum, void* dstates, void* dec, void* gst,
                            void* gspart, void* mpart, void* colp, void* rowp,
                            void* upart, void* ddpart, void* offp,
                            void* dapart, int B, int S, int H, int P, int N,
                            int L, int dtype, void* stream) {
  if (P % 16 != 0 || P <= 0 || S <= 0 || B <= 0 || H <= 0 ||
      L % TILE != 0 || L <= 0 || L > MAX_L ||
      (dtype == rt::DTYPE_F32 && L > TILE))
    return cudaErrorInvalidValue;
  const Args g{x,      dt,      a,     b,      c,     d,     prev,   dy,
               dfinal, dx,      ddt,   da,     db,    dc,    dd,     dinit,
               cum,    dstates, dec,   gst,    gspart, mpart, colp,  rowp,
               upart,  ddpart,  offp,  dapart, B,     S,     H,      P,
               L,      static_cast<cudaStream_t>(stream)};
  if (dtype == rt::DTYPE_F32) return dispatch_n<float>(N, g);
  if (dtype == rt::DTYPE_BF16) return dispatch_n<bf16>(N, g);
  return cudaErrorInvalidValue;
}
