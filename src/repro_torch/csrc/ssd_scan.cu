// Mamba2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the TPU kernel `ssd_scan` of src/repro/kernels/ssd_scan/kernel.py
// (pallas_call at :99). For each (batch, head) the sequence is cut into
// chunks that carry a (P, N) f32 state; within a chunk
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
// 989 TFLOP/s. Only the recurrence between chunks is serial, and it is an
// elementwise update of B·H·P·N values; every product depends on one
// chunk alone. So the products run chunk-parallel and only the
// recurrence runs in order.
//
// Three kernels a call, in order on the caller's stream (passes 2 and 3
// by programmatic dependent launch, so each starts its loads that do not
// depend on the pass before while that pass runs):
//  1. `state_kernel`, chunk-parallel, one block per (batch, chunk of L
//     tokens, head, slice of PB state rows): the chunk's own state
//     S_k = xᵀ·(B·exp(cum_L − cum)·dt) and its sum of dt·a, streamed in
//     64-token pieces (B by cp.async, x through registers, both one piece
//     ahead) on mma.sync.
//  2. `recur_kernel`, elementwise over (batch, head, P, N), in order over
//     the chunks: state_k = state_{k-1}·exp(cum_L) + S_k; it writes the
//     state before each chunk in the type pass 3 multiplies it in, and
//     the final state. Its loads do not depend on the carry, so eight
//     chunks' loads are in flight at once.
//  3. `out_kernel`, chunk-parallel, one block per (batch, chunk, head,
//     slice of PB columns of y), two warpgroups: the block loads the
//     chunk's key tiles (B and x) and the state before it once; each
//     warpgroup then takes query tiles (of four: 3 and 0, or 2 and 1, five
//     tile pairs each), computing exp(cum_i)·C_i·stateᵀ, the intra-chunk
//     term over key tiles 0..q, and D·x.
// Why three and why L = 256 tokens (the wrapper's `STATE_CHUNK`): the
// states cross device memory between the passes, H·P·N·4 = 1.05 MB a
// chunk at the serving shape, written by 1, read by 2, written by 2 in two
// bf16 parts, read by 3: ≈ 4 × 8 × 1.05 ≈ 34 MB at 256-token chunks
// against 134 MB at 64 (most of it stays in the 50 MB L2), and pass 3
// loads each chunk's prior state once for four query tiles. Fusing 2
// into 3 would have every block sum all earlier chunks' states (≈ 120 MB
// of L2 reads); fusing 1 and 2 needs blocks that wait on each other. Two
// more launches cost less, and dependent launch hides most of their
// start. The score tiles stay 64 × 64 whatever L: a 256 × 256 f32 tile
// would not fit in shared memory. The SSD result does not depend on the
// chunk length, apart from rounding, so L is the kernel's own, not the
// caller's `chunk`; f32 chunks are one tile (64), since pass 3 holds all
// of a chunk's tiles and f32 ones are twice the bytes.
//
// Numbers: the sums of dt·a are taken within each 64-token tile (tile
// totals added for longer segments), never as a difference of two prefix
// sums over the chunk, so exp of a segment keeps f32 accuracy however
// long the chunk. Never exp of a positive segment sum: exp(cum_i − cum_j)
// is formed only where j ≤ i (0 elsewhere, never a 0/1 mask times inf),
// with the exponent clamped at 0, so strong decay underflows to 0. Tokens
// past the sequence are zero-filled (x, B, C, dt), so S need not be a
// multiple of 64 or L, and dt = 0 leaves the state as it is.
//
// Products, bf16, on the tensor cores with f32 accumulators. Pass 1:
// mma.sync m16n8k16 from shared memory rows padded by 16 bytes (ldmatrix).
// Pass 3: wgmma, B and x tiles and the prior state in 128-byte-swizzled
// panels (cp.async), each warp's 16 rows of C in registers for every
// product, the score accumulators fed back as the A operand of scores·x.
// Where bf16 would round a factor that is not exact in bf16 (x·exp·dt in
// pass 1, the scores, the prior state) the factor is split into a bf16
// high and low part and both are multiplied (≈ 16 bits of mantissa): the
// final state is held to 1e-4 like the f32 path, and y keeps its margin
// where large terms cancel. B, C and x are exact in bf16.
// Products, f32: the same fragments computed with FMAs on the CUDA cores
// (TF32 would miss the 1e-4 agreement with the plain version).
//
// Tried and dropped, each slower on the card or short of the tolerance:
// one block per (batch, head, 16 state rows) walking every 64-token
// sub-chunk in order with f32 FMAs (32 synchronised steps: 94× the
// bound); pass 3 with one block per query tile (every block reloads its
// chunk's state and key tiles) on mma.sync; state chunks of 64 or 128
// tokens; pass 1 split over column slices of the state; pass 3 with the
// next tile's scores issued before this tile's decays (more registers,
// no overlap gained), or with the high and low parts in separate
// accumulators (spills); rounding the scores to bf16 without the low
// part (y within tolerance, but with less than half the margin).

#include <type_traits>

#include "decode_common.cuh"
#include "sm90.cuh"

namespace {

using rt::Cvt;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;    // tokens per score tile and per pass-1 piece
constexpr int NT = 128;     // threads of a chunk-parallel block (4 warps)
constexpr int MAX_L = 256;  // longest state chunk
constexpr int OUT_WARPS = 8;     // pass 3: two groups of four warps
constexpr int OUT_THREADS = 32 * OUT_WARPS;
constexpr int RT_THREADS = 256;  // threads of a recurrence block
constexpr int RT_UNROLL = 8;     // chunks whose loads are in flight at once
// a tile whose decays sum to no less than this takes the diagonal tile's
// decays as products exp(lf_i)·exp(-lf_j), both factors normal floats
constexpr float SEPARABLE = -80.f;

template <typename T>
constexpr int PAD = 16 / (int)sizeof(T);   // row padding: rows shift banks

template <typename T>
constexpr bool IS_BF16 = std::is_same<T, bf16>::value;

// planes of the carried states that pass 3 multiplies: bf16 keeps a high
// and a low part (≈ 16 bits of mantissa), f32 the value
template <typename T>
constexpr int PLANES = IS_BF16<T> ? 2 : 1;

// -- shared-memory layouts (bytes), from the template parameters alone ------

template <typename T, int N, int PB>
struct StateSmem {
  static constexpr int LDN = N + PAD<T>, LDP = PB + PAD<T>;
  static constexpr size_t b = sizeof(T) * 2 * TILE * LDN;     // 2 stages
  static constexpr size_t xw = sizeof(T) * (IS_BF16<T> ? 2 : 1) * TILE * LDP;
  static constexpr size_t bytes = b + xw + sizeof(float) * 4 * MAX_L;
};

// Pass 3 holds every key tile of its chunk: bf16 chunks of up to MAX_L
// tokens; f32 tiles are twice the bytes and its C rows and scores go
// through shared memory too, so its chunks are one tile
template <typename T>
constexpr int OUT_TILES = IS_BF16<T> ? MAX_L / TILE : 1;

// bf16: operands of wgmma in 128-byte-swizzled panels of 64 columns (see
// sm90.cuh), each 1024-byte aligned: B tiles (keys × state dim, the state
// dim padded to KP), x tiles (keys × 64 columns of y), and the high and
// low parts of the state before the chunk (64 rows of y × KP)
template <int N>
struct TcSmem {
  static constexpr int KP = N < 64 ? 64 : N;   // state dim, padded
  static constexpr size_t panel = TILE * 128;  // 64 rows of 128 bytes
  static constexpr size_t btile = (KP / 64) * panel;
  static constexpr size_t xtile = panel;
  static constexpr size_t b = OUT_TILES<bf16> * btile;
  static constexpr size_t x = OUT_TILES<bf16> * xtile;
  static constexpr size_t prev = 2 * btile;
  static constexpr size_t bytes = b + x + prev + sizeof(float) * 6 * MAX_L;
  static constexpr size_t alloc = bytes + 1024;   // room to align to 1 KB
};

// f32: rows padded by 16 bytes; a group's query rows of C and each warp's
// scores go through shared memory as well
template <int N, int PB>
struct F32Smem {
  static constexpr int LDN = N + PAD<float>, LDP = PB + PAD<float>;
  static constexpr int LDS = TILE + 4;
  static constexpr size_t b = sizeof(float) * TILE * LDN;
  static constexpr size_t x = sizeof(float) * TILE * LDP;
  static constexpr size_t prev = sizeof(float) * PB * LDN;
  static constexpr size_t c = sizeof(float) * 2 * TILE * LDN;
  static constexpr size_t scores = sizeof(float) * OUT_WARPS * 16 * LDS;
  static constexpr size_t alloc =
      b + x + prev + c + sizeof(float) * 6 * MAX_L + scores;
};

template <typename T, int N, int PB>
constexpr size_t out_smem() {
  if constexpr (IS_BF16<T>)
    return TcSmem<N>::alloc;
  else
    return F32Smem<N, PB>::alloc;
}

// -- warp-level products in the m16n8 accumulator layout --------------------
//
// A lane holds acc[t][0..3] = D(g, 8t + 2q), D(g, 8t + 2q + 1),
// D(g + 8, 8t + 2q), D(g + 8, 8t + 2q + 1) with g = lane / 4, q = lane % 4.
// A operands: element (m, k) at a[m·lda + k] (KM false) or a[k·lda + m]
// (KM true). B operands: element (k, n) at b[n·ldb + k] (KN false) or
// b[k·ldb + n] (KN true).

// bf16 A fragment of the 16 × 16 block at (m0, k0) of A stored [k][m]
__device__ __forceinline__ void lda_frag_km(uint32_t* f, const bf16* a,
                                            int lda, int m0, int k0) {
  const int l = threadIdx.x & 31, r = l & 7, mat = l >> 3;
  rt::ldsm_x4_trans(f, a + (k0 + r + (mat >> 1) * 8) * lda + m0 + (mat & 1) * 8);
}

// bf16 B fragments of the n-tiles at n0 and n0 + 8, depth k0..k0+15, of
// B stored [k][n]: f[0..1] and f[2..3]
__device__ __forceinline__ void ldb_frag_kn(uint32_t* f, const bf16* b,
                                            int ldb, int n0, int k0) {
  const int l = threadIdx.x & 31, r = l & 7, mat = l >> 3;
  rt::ldsm_x4_trans(f, b + (k0 + r + (mat & 1) * 8) * ldb + n0 + (mat >> 1) * 8);
}

// acc (16 × 8·NT8 at (m0, n0)) += A[m0:m0+16, k0:k1] · B[k0:k1, n0:...];
// bf16 on the tensor cores (k in steps of 16; pass 1's layouts, A and B
// both stored with k as the row), f32 with FMAs
template <bool KM, bool KN, int NT8, typename T>
__device__ __forceinline__ void warp_mm(float (&acc)[NT8][4], const T* a,
                                        int lda, int m0, const T* b, int ldb,
                                        int n0, int k0, int k1) {
  if constexpr (IS_BF16<T>) {
    static_assert(NT8 % 2 == 0, "n-tiles come in pairs");
    static_assert(KM && KN, "bf16: A stored [k][m], B stored [k][n]");
    for (int k = k0; k < k1; k += 16) {
      uint32_t af[4];
      lda_frag_km(af, a, lda, m0, k);
#pragma unroll
      for (int t = 0; t < NT8; t += 2) {
        uint32_t bfr[4];
        ldb_frag_kn(bfr, b, ldb, n0 + 8 * t, k);
        rt::mma_16816(acc[t], af, bfr);
        rt::mma_16816(acc[t + 1], af, bfr + 2);
      }
    }
  } else {
    const int l = threadIdx.x & 31, g = l >> 2, q2 = 2 * (l & 3);
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float a0 = KM ? a[k * lda + m0 + g] : a[(m0 + g) * lda + k];
      const float a1 =
          KM ? a[k * lda + m0 + g + 8] : a[(m0 + g + 8) * lda + k];
#pragma unroll
      for (int t = 0; t < NT8; ++t) {
        const int n = n0 + 8 * t + q2;
        const float b0 = KN ? b[k * ldb + n] : b[n * ldb + k];
        const float b1 = KN ? b[k * ldb + n + 1] : b[(n + 1) * ldb + k];
        acc[t][0] = fmaf(a0, b0, acc[t][0]);
        acc[t][1] = fmaf(a0, b1, acc[t][1]);
        acc[t][2] = fmaf(a1, b0, acc[t][2]);
        acc[t][3] = fmaf(a1, b1, acc[t][3]);
      }
    }
  }
}

// -- block helpers ----------------------------------------------------------

// Programmatic dependent launch: a kernel launched with
// `launch_after` may start while the kernel before it on the stream runs;
// it calls grid_dependency_wait before it reads what that kernel wrote,
// and the kernel before lets it start with allow_dependents.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// barrier `id` (1..15) over `count` threads, for one group of warps
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// two floats as packed bf16 pairs: the rounded values and what rounding
// left, so that hi + lo keeps ≈ 16 bits of mantissa
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = rt::pack_bf16(a - f.x, b - f.y);
}

// ROWS rows of W elements from global rows `gstride` elements apart into
// shared rows `lds` apart, by 16-byte cp.async; rows at or past `nvalid`
// are zero-filled without a load
template <typename T, int W, int ROWS = TILE, int THREADS = NT>
__device__ __forceinline__ void load_rows(T* s, int lds, const T* g,
                                          size_t gstride, int nvalid) {
  constexpr int CH = 16 / (int)sizeof(T);
  constexpr int CPR = W / CH;
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
    const int r = e / CPR, k = (e % CPR) * CH;
    const bool in = r < nvalid;
    rt::cp_async16(s + r * lds + k, in ? g + r * gstride + k : g, in);
  }
}

// The decays of the MAX_L tokens from t0, cut into four 64-token tiles
// (one a warp, two neighbouring tokens a lane): dt into sDt (0 at or past
// `tend`) and, with v = dt·a ≤ 0, the sums within each tile: sLf[t] of v up
// to and including t, sLs[t] of v after t, sT[k] of the whole tile k. Each
// adds only terms of its own tile and no difference of two sums is taken,
// so a sum is exact to a few ulps of itself, not of the chunk's prefix sum:
// exp of it keeps f32 accuracy however long the chunk. Run by threads
// 0..NT-1; the caller synchronises before reading.
__device__ __forceinline__ void tile_sums(const float* __restrict__ dt,
                                          size_t row0, int t0, int tend,
                                          int H, int h, float ah, float* sDt,
                                          float* sLf, float* sLs, float* sT) {
  static_assert(2 * NT == MAX_L && NT / 32 * TILE == MAX_L, "tile a warp");
  const int tid = threadIdx.x, lane = tid & 31;
  const int t = t0 + 2 * tid;
  const float d0 = t < tend ? dt[(row0 + t) * H + h] : 0.f;
  const float d1 = t + 1 < tend ? dt[(row0 + t + 1) * H + h] : 0.f;
  const float v0 = d0 * ah, v1 = d1 * ah;
  float f = v0 + v1, r = v0 + v1;   // inclusive scans, forward and back
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float uf = __shfl_up_sync(0xffffffffu, f, o);
    const float ur = __shfl_down_sync(0xffffffffu, r, o);
    if (lane >= o) f += uf;
    if (lane + o < 32) r += ur;
  }
  const float fb = __shfl_up_sync(0xffffffffu, f, 1);
  const float ra = __shfl_down_sync(0xffffffffu, r, 1);
  const float before = lane > 0 ? fb : 0.f, after = lane < 31 ? ra : 0.f;
  sDt[2 * tid] = d0;
  sDt[2 * tid + 1] = d1;
  sLf[2 * tid] = before + v0;
  sLf[2 * tid + 1] = f;
  sLs[2 * tid] = v1 + after;
  sLs[2 * tid + 1] = after;
  if (lane == 31) sT[tid >> 5] = f;
}

// -- pass 1: each chunk's own state ----------------------------------------
// Grid (H·P/PB, n_chunks, B): one block per (batch, chunk, head, slice of
// PB state rows). states (B, n_chunks, H, P, N) f32 receives S_k; dec
// (B, n_chunks, H) the chunk's sum of dt·a.
template <typename T, int N, int PB>
__global__ void __launch_bounds__(NT)
    state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 float* __restrict__ states, float* __restrict__ dec, int S,
                 int H, int P, int L) {
  using Sm = StateSmem<T, N, PB>;
  constexpr int LDN = Sm::LDN, LDP = Sm::LDP;
  constexpr int RT = PB / 16, CT = N / 8;
  constexpr int WPR = (4 / RT) < (CT / 2) ? (4 / RT) : (CT / 2);
  constexpr int NT8 = CT / WPR;   // n-tiles of a warp
  constexpr int CH = 16 / (int)sizeof(T);     // elements a 16-byte load
  constexpr int XIT = TILE * PB / (CH * NT);  // x loads a thread a piece
  static_assert(XIT * CH * NT == TILE * PB, "x piece in whole loads");
  using V = rt::Vec<T, CH>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sB = reinterpret_cast<T*>(smem);                       // 2 × TILE × LDN
  T* sXh = reinterpret_cast<T*>(smem + Sm::b);              // TILE × LDP
  T* sXl = sXh + TILE * LDP;                                // bf16 only
  float* sDt = reinterpret_cast<float*>(smem + Sm::b + Sm::xw);   // MAX_L
  float* sLf = sDt + MAX_L;
  float* sLs = sLf + MAX_L;
  float* sW = sLs + MAX_L;
  __shared__ float sT[4];

  const int pblocks = P / PB;
  const int h = blockIdx.x / pblocks, p0 = (blockIdx.x % pblocks) * PB;
  const int c = blockIdx.y, bi = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int c0 = c * L, n = min(L, S - c0);
  const int npieces = (n + TILE - 1) / TILE;
  const size_t row0 = (size_t)bi * S;
  const T* xh = x + (row0 + c0) * H * P + h * P + p0;
  const T* bs = bm + (row0 + c0) * N;

  // this thread's part of x piece k, raw, zero past the sequence
  auto load_x = [&](V (&raw)[XIT], int k) {
#pragma unroll
    for (int it = 0; it < XIT; ++it) {
      const int e = tid + it * NT;
      const int r = e / (PB / CH), col = (e % (PB / CH)) * CH;
      const int t = k * TILE + r;
      if (t < n) {
        raw[it] = *reinterpret_cast<const V*>(xh + (size_t)t * H * P + col);
      } else {
#pragma unroll
        for (int i = 0; i < CH; ++i) raw[it].v[i] = Cvt<T>::from_f(0.f);
      }
    }
  };

  load_rows<T, N>(sB, LDN, bs, N, n);
  rt::cp_async_commit();
  V raw[XIT];
  load_x(raw, 0);
  tile_sums(dt, row0, c0, c0 + n, H, h, a[h], sDt, sLf, sLs, sT);
  __syncthreads();
  // w_t = exp(sum of v after t up to the chunk's end)·dt_t
  for (int t = tid; t < MAX_L; t += NT) {
    float later = sLs[t];
    for (int k = t / TILE + 1; k < 4; ++k) later += sT[k];
    sW[t] = expf(fminf(later, 0.f)) * sDt[t];
  }

  float acc[NT8][4];
#pragma unroll
  for (int t = 0; t < NT8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  const int m0 = 16 * (warp / WPR), n0 = 8 * NT8 * (warp % WPR);
  const bool active = warp < RT * WPR;

  for (int k = 0; k < npieces; ++k) {
    __syncthreads();   // sW is written; the last piece's products are done
    // x·w of this piece, split into a bf16 high and low part
#pragma unroll
    for (int it = 0; it < XIT; ++it) {
      const int e = tid + it * NT;
      const int r = e / (PB / CH), col = (e % (PB / CH)) * CH;
      const float w = sW[k * TILE + r];
      V hi, lo;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float xw = Cvt<T>::to_f(raw[it].v[i]) * w;
        hi.v[i] = Cvt<T>::from_f(xw);
        lo.v[i] = Cvt<T>::from_f(xw - Cvt<T>::to_f(hi.v[i]));
      }
      *reinterpret_cast<V*>(sXh + r * LDP + col) = hi;
      if constexpr (IS_BF16<T>) *reinterpret_cast<V*>(sXl + r * LDP + col) = lo;
    }
    if (k + 1 < npieces) {   // the next piece's loads run under these products
      load_x(raw, k + 1);
      load_rows<T, N>(sB + ((k + 1) & 1) * TILE * LDN, LDN,
                      bs + (size_t)(k + 1) * TILE * N, N, n - (k + 1) * TILE);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const T* b = sB + (k & 1) * TILE * LDN;
      warp_mm<true, true, NT8>(acc, sXh, LDP, m0, b, LDN, n0, 0, TILE);
      if constexpr (IS_BF16<T>)
        warp_mm<true, true, NT8>(acc, sXl, LDP, m0, b, LDN, n0, 0, TILE);
    }
  }

  allow_dependents();
  const size_t chunk_row = ((size_t)bi * nc + c) * H + h;
  if (active) {
    const int l = tid & 31, g = l >> 2, q2 = 2 * (l & 3);
    float* out = states + (chunk_row * P + p0 + m0) * N + n0;
#pragma unroll
    for (int t = 0; t < NT8; ++t) {
      *reinterpret_cast<float2*>(out + g * N + 8 * t + q2) =
          make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(out + (g + 8) * N + 8 * t + q2) =
          make_float2(acc[t][2], acc[t][3]);
    }
  }
  if (p0 == 0 && tid == 0) dec[chunk_row] = sT[0] + sT[1] + sT[2] + sT[3];
}

// -- pass 2: the recurrence over chunks -------------------------------------
// One thread per four consecutive (p, n) of a (batch, head). prev
// (PLANES, B, n_chunks, H, P, N) in T receives the state before chunk k,
// in the type pass 3 multiplies it in (bf16: high part, then the low
// part); fin the state after the last chunk.
template <typename T>
__global__ void __launch_bounds__(RT_THREADS)
    recur_kernel(const float* __restrict__ init,
                 const float* __restrict__ states,
                 const float* __restrict__ dec, T* __restrict__ prev,
                 float* __restrict__ fin, int B, int H, int PN, int nc) {
  allow_dependents();   // pass 3's loads of its inputs may start
  grid_dependency_wait();   // pass 1 has written the chunks' states
  const size_t e = 4 * ((size_t)blockIdx.x * RT_THREADS + threadIdx.x);
  const size_t hpn = (size_t)H * PN;
  if (e >= (size_t)B * hpn) return;
  const int bi = (int)(e / hpn), h = (int)((e % hpn) / PN);
  const size_t in_b = e % hpn;
  float4 carry = init ? *reinterpret_cast<const float4*>(init + e)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < nc; k0 += RT_UNROLL) {
    float4 s[RT_UNROLL];
    float d[RT_UNROLL];
#pragma unroll
    for (int u = 0; u < RT_UNROLL; ++u) {
      const size_t row = (size_t)bi * nc + k0 + u;
      if (k0 + u < nc) {
        s[u] = *reinterpret_cast<const float4*>(states + row * hpn + in_b);
        d[u] = expf(dec[row * H + h]);
      }
    }
#pragma unroll
    for (int u = 0; u < RT_UNROLL; ++u) {
      if (k0 + u < nc) {
        T* out = prev + ((size_t)bi * nc + k0 + u) * hpn + in_b;
        if constexpr (IS_BF16<T>) {
          uint2 hi, lo;
          split_bf16(carry.x, carry.y, hi.x, lo.x);
          split_bf16(carry.z, carry.w, hi.y, lo.y);
          *reinterpret_cast<uint2*>(out) = hi;
          *reinterpret_cast<uint2*>(out + (size_t)B * nc * hpn) = lo;
        } else {
          *reinterpret_cast<float4*>(out) = carry;
        }
        carry.x = carry.x * d[u] + s[u].x;
        carry.y = carry.y * d[u] + s[u].y;
        carry.z = carry.z * d[u] + s[u].z;
        carry.w = carry.w * d[u] + s[u].w;
      }
    }
  }
  *reinterpret_cast<float4*>(fin + e) = carry;
}

// -- pass 3: y -------------------------------------------------------------

// bf16: ROWS rows of W columns from global rows `gstride` apart into
// 128-byte-swizzled panels of 64 columns (panel stride ROWS × 128 bytes),
// padded with zeros to WP columns and past row `nvalid`; 16-byte cp.async
template <int W, int WP, int ROWS>
__device__ __forceinline__ void load_swizzled(unsigned char* s, const bf16* g,
                                              size_t gstride, int nvalid) {
  constexpr int CPR = WP / 8;   // 16-byte chunks a row
  for (int e = threadIdx.x; e < ROWS * CPR; e += OUT_THREADS) {
    const int r = e / CPR, ch = e % CPR;
    const bool in = r < nvalid && ch * 8 < W;
    rt::cp_async16(s + (ch >> 3) * ROWS * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
                   in ? g + r * gstride + ch * 8 : g, in);
  }
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (64 x 16, smem)ᵀ,
// B K-major: the rows of B are the output columns
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float* d, const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc (64 × 64) += A · Bᵀ for A in registers (KS k-steps of 16) and B
// K-major in swizzled panels at shared address `b` (64 rows a panel)
template <int KS>
__device__ __forceinline__ void tc_times_kmajor(float* acc, uint32_t (*a)[4],
                                                uint32_t b) {
  sm90::fence_regs<32>(acc);
  sm90::fence_regs<4 * KS>(&a[0][0]);
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_rs_n64_kmajor(
        acc, a[ks],
        sm90::make_desc(b + (16 * ks / 64) * TILE * 128 + (16 * ks % 64) * 2,
                        16, 1024, 1));
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs<32>(acc);
}

// The decay from key j to query i times dt_j, for j ≤ i only, applied to
// the score tile of this lane's rows i0 and i0 + 8 against key tile kt of
// the chunk (query tile qi); all indices chunk-relative. sWj[j] =
// exp(sum after j in its tile)·dt_j; where the tile's sum is at least
// SEPARABLE, sEf[t] = exp(lf_t) and sEr[t] = exp(-lf_t)·dt_t.
__device__ __forceinline__ void decay_scores(float (&s)[TILE / 8][4], int kt,
                                             int qi, int i0, int q2,
                                             const float* sLf,
                                             const float* sDt,
                                             const float* sWj,
                                             const float* sEf,
                                             const float* sEr,
                                             const float* sT) {
  const int i1 = i0 + 8, j0 = kt * TILE + q2;
  if (kt < qi) {
    // separable: exp(sum up to i in its tile + whole tiles between)
    // · exp(sum after j in its tile)·dt_j
    float mid = 0.f;
    for (int k = kt + 1; k < qi; ++k) mid += sT[k];
    const float e0 = expf(fminf(sLf[i0] + mid, 0.f));
    const float e1 = expf(fminf(sLf[i1] + mid, 0.f));
#pragma unroll
    for (int t = 0; t < TILE / 8; ++t) {
      const float w0 = sWj[j0 + 8 * t], w1 = sWj[j0 + 8 * t + 1];
      s[t][0] *= e0 * w0;
      s[t][1] *= e0 * w1;
      s[t][2] *= e1 * w0;
      s[t][3] *= e1 * w1;
    }
  } else if (sT[qi] >= SEPARABLE) {
    const float f0 = sEf[i0], f1 = sEf[i1];
#pragma unroll
    for (int t = 0; t < TILE / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i0 : i1, j = j0 + 8 * t + (e & 1);
        s[t][e] = j <= i ? s[t][e] * (e < 2 ? f0 : f1) * sEr[j] : 0.f;
      }
  } else {
#pragma unroll
    for (int t = 0; t < TILE / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i0 : i1, j = j0 + 8 * t + (e & 1);
        s[t][e] = j <= i ? s[t][e] * expf(fminf(sLf[i] - sLf[j], 0.f)) * sDt[j]
                         : 0.f;
      }
  }
}

// Grid (H·P/PB, n_chunks, B), one block per (batch, chunk, head, slice of
// PB columns of y). The block loads every key tile of its chunk, the
// state before it and the chunk's decays once; then each group of four
// warps takes query tiles in turn (of four: 3 and 0, and 2 and 1, five
// tile pairs each), warp w of a group owning query rows 16w..16w+15.
// bf16: a group is a warpgroup and its products are wgmma with C in
// registers (y 64 columns wide, of which PB are stored); f32: FMAs in the
// same accumulator layout.
template <typename T, int N, int PB>
__global__ void __launch_bounds__(OUT_THREADS, 1)
    out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dskip,
               const T* __restrict__ prev, T* __restrict__ y, int S, int H,
               int P, int L) {
  constexpr bool BF = IS_BF16<T>;
  using Tc = TcSmem<N>;
  using Fs = F32Smem<N, PB>;
  constexpr int NY8 = BF ? TILE / 8 : PB / 8;   // n-tiles of y computed
  constexpr int KS = N / 16;                    // k-steps over the state dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // bf16: 1 KB aligned for the swizzle
  unsigned char* smem =
      BF ? smem_raw + (1024 - sm90::smem_u32(smem_raw) % 1024) % 1024 : smem_raw;
  unsigned char* sB = smem;
  unsigned char* sX = sB + (BF ? Tc::b : Fs::b);
  unsigned char* sPrev = sX + (BF ? Tc::x : Fs::x);
  float* sCf = reinterpret_cast<float*>(sPrev + Fs::prev);   // f32 only
  float* sDt = reinterpret_cast<float*>(BF ? sPrev + Tc::prev
                                           : reinterpret_cast<unsigned char*>(sCf) + Fs::c);
  float* sLf = sDt + MAX_L;
  float* sLs = sLf + MAX_L;
  float* sWj = sLs + MAX_L;
  float* sEf = sWj + MAX_L;
  float* sEr = sEf + MAX_L;
  float* sP = sEr + MAX_L;   // f32: OUT_WARPS × 16 × LDS scores
  __shared__ float sT[4];

  const int pblocks = P / PB;
  const int h = blockIdx.x / pblocks, p0 = (blockIdx.x % pblocks) * PB;
  const int c = blockIdx.y, bi = blockIdx.z, nc = gridDim.y;
  const int c0 = c * L, n = min(L, S - c0);
  const int ntiles = (n + TILE - 1) / TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 2, wg = warp & 3;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const size_t row0 = (size_t)bi * S;
  const size_t xs = (size_t)H * P;   // x / y row stride
  const T* xh = x + (row0 + c0) * xs + h * P + p0;
  const T* src = prev + ((((size_t)bi * nc + c) * H + h) * P + p0) * N;
  const size_t plane = (size_t)gridDim.z * nc * H * P * N;

  // every key tile of the chunk; the state before it once pass 2 is done
  if constexpr (BF) {
    for (int kt = 0; kt < ntiles; ++kt) {
      const int t0 = kt * TILE;
      load_swizzled<N, Tc::KP, TILE>(sB + kt * Tc::btile,
                                     bm + (row0 + c0 + t0) * N, N, n - t0);
      load_swizzled<PB, 64, TILE>(sX + kt * Tc::xtile, xh + t0 * xs, xs, n - t0);
    }
  } else {
    load_rows<T, N, TILE, OUT_THREADS>(reinterpret_cast<T*>(sB), Fs::LDN,
                                       bm + (row0 + c0) * N, N, n);
    load_rows<T, PB, TILE, OUT_THREADS>(reinterpret_cast<T*>(sX), Fs::LDP, xh, xs, n);
  }
  rt::cp_async_commit();

  // this group's query tiles, the heavier first: of n tiles, group 0
  // takes n-1 and n-4, group 1 n-2 and n-3
  const int qis[2] = {grp == 0 ? ntiles - 1 : ntiles - 2,
                      grp == 0 ? ntiles - 4 : ntiles - 3};
  // bf16: this warp's 16 rows of C in each of them as the A fragments of
  // every product below, loaded straight from global memory (lane: row
  // g / g + 8, columns 2q, 2q + 1 / 2q + 8, 2q + 9 of each 16-column step)
  uint32_t cf[2][BF ? KS : 1][4];
  if constexpr (BF) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r0 = qis[u] * TILE + 16 * wg + g;   // chunk-relative
      const bool in0 = qis[u] >= 0 && r0 < n, in1 = qis[u] >= 0 && r0 + 8 < n;
      const uint32_t* p0r = reinterpret_cast<const uint32_t*>(
                                cm + (row0 + c0 + (in0 ? r0 : 0)) * N) + q2 / 2;
      const uint32_t* p1r = reinterpret_cast<const uint32_t*>(
                                cm + (row0 + c0 + (in1 ? r0 + 8 : 0)) * N) + q2 / 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        cf[u][ks][0] = in0 ? p0r[8 * ks] : 0u;
        cf[u][ks][1] = in1 ? p1r[8 * ks] : 0u;
        cf[u][ks][2] = in0 ? p0r[8 * ks + 4] : 0u;
        cf[u][ks][3] = in1 ? p1r[8 * ks + 4] : 0u;
      }
    }
  }
  if (tid < NT) tile_sums(dt, row0, c0, c0 + n, H, h, a[h], sDt, sLf, sLs, sT);
  __syncthreads();
  // a key's weight toward any later tile, and the diagonal tile's factors
  for (int t = tid; t < MAX_L; t += OUT_THREADS) {
    sWj[t] = expf(fminf(sLs[t], 0.f)) * sDt[t];
    const bool sep = sT[t / TILE] >= SEPARABLE;
    sEf[t] = sep ? expf(fminf(sLf[t], 0.f)) : 0.f;
    sEr[t] = sep ? expf(-fminf(sLf[t], 0.f)) * sDt[t] : 0.f;
  }
  grid_dependency_wait();   // pass 2 has written the states
  if constexpr (BF) {
    for (int k = 0; k < 2; ++k)
      load_swizzled<N, Tc::KP, TILE>(sPrev + k * Tc::btile, src + k * plane, N, PB);
  } else {
    load_rows<T, N, PB, OUT_THREADS>(reinterpret_cast<T*>(sPrev), Fs::LDN, src, N, PB);
  }
  rt::cp_async_commit();
  rt::cp_async_wait<0>();
  if constexpr (BF)   // the copies are read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const float dh = dskip[h];
  const uint32_t aB = sm90::smem_u32(sB), aX = sm90::smem_u32(sX);
  const uint32_t aPrev = sm90::smem_u32(sPrev);

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int qi = qis[u];
    if (qi < 0) continue;
    const int q0 = qi * TILE;   // chunk-relative
    float* sCg = sCf + grp * TILE * Fs::LDN;
    if constexpr (!BF) {   // stage this group's query rows of C
      named_sync(1 + grp, 128);   // the group is done with the last ones
      for (int e = 32 * wg + lane; e < TILE * (N / 4); e += 128) {
        const int r = e / (N / 4), k = (e % (N / 4)) * 4;
        const bool in = q0 + r < n;
        rt::cp_async16(sCg + r * Fs::LDN + k,
                       in ? cm + (row0 + c0 + q0 + r) * N + k : cm, in);
      }
      rt::cp_async_commit();
      rt::cp_async_wait<0>();
      named_sync(1 + grp, 128);
    }
    // this lane's two rows, chunk-relative, and the sum of v over the
    // whole tiles of the chunk before the query tile
    const int i0 = q0 + 16 * wg + g, i1 = i0 + 8;
    float before = 0.f;
    for (int k = 0; k < qi; ++k) before += sT[k];

    // the carried state's term: exp(cum_i)·C_i·stateᵀ
    float acc[NY8][4];
#pragma unroll
    for (int t = 0; t < NY8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    if constexpr (BF) {
      tc_times_kmajor<KS>(&acc[0][0], cf[u], aPrev);
      tc_times_kmajor<KS>(&acc[0][0], cf[u], aPrev + Tc::btile);   // low part
    } else {
      warp_mm<false, false, NY8>(acc, reinterpret_cast<const T*>(sCg), Fs::LDN,
                                 16 * wg, reinterpret_cast<const T*>(sPrev),
                                 Fs::LDN, 0, 0, N);
    }
    {
      const float e0 = expf(fminf(before + sLf[i0], 0.f));
      const float e1 = expf(fminf(before + sLf[i1], 0.f));
#pragma unroll
      for (int t = 0; t < NY8; ++t) {
        acc[t][0] *= e0;
        acc[t][1] *= e0;
        acc[t][2] *= e1;
        acc[t][3] *= e1;
      }
    }

    // the intra-chunk term, one 64-token key tile at a time
    for (int kt = 0; kt <= qi; ++kt) {
      float s[TILE / 8][4];
#pragma unroll
      for (int t = 0; t < TILE / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      if constexpr (BF) {
        tc_times_kmajor<KS>(&s[0][0], cf[u], aB + kt * Tc::btile);
      } else {
        warp_mm<false, false, TILE / 8>(s, reinterpret_cast<const T*>(sCg), Fs::LDN,
                                        16 * wg, reinterpret_cast<const T*>(sB),
                                        Fs::LDN, 0, 0, N);
      }
      decay_scores(s, kt, qi, i0, q2, sLf, sDt, sWj, sEf, sEr, sT);
      if constexpr (BF) {
        // the score accumulators are the A fragments of scores·x, split
        // into a high and a low bf16 part
        uint32_t hi[TILE / 16][4], lo[TILE / 16][4];
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          split_bf16(s[2 * kk][0], s[2 * kk][1], hi[kk][0], lo[kk][0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], hi[kk][1], lo[kk][1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
        }
        sm90::fence_regs<32>(&acc[0][0]);
        sm90::fence_regs<TILE / 4>(&hi[0][0]);
        sm90::fence_regs<TILE / 4>(&lo[0][0]);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          // x tile: 16 keys of 128-byte rows a step, MN-major
          const uint64_t db = sm90::make_desc(aX + kt * Tc::xtile + kk * 16 * 128,
                                              TILE * 128, 1024, 1);
          sm90::wgmma_rs_n64(&acc[0][0], hi[kk], db);
          sm90::wgmma_rs_n64(&acc[0][0], lo[kk], db);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs<32>(&acc[0][0]);
        sm90::fence_regs<TILE / 4>(&hi[0][0]);
        sm90::fence_regs<TILE / 4>(&lo[0][0]);
      } else {
        float* sPw = sP + warp * 16 * Fs::LDS;
#pragma unroll
        for (int t = 0; t < TILE / 8; ++t) {
          sPw[g * Fs::LDS + 8 * t + q2] = s[t][0];
          sPw[g * Fs::LDS + 8 * t + q2 + 1] = s[t][1];
          sPw[(g + 8) * Fs::LDS + 8 * t + q2] = s[t][2];
          sPw[(g + 8) * Fs::LDS + 8 * t + q2 + 1] = s[t][3];
        }
        __syncwarp();
        warp_mm<false, true, NY8>(acc, sPw, Fs::LDS, 0,
                                  reinterpret_cast<const T*>(sX), Fs::LDP, 0, 0, TILE);
        __syncwarp();
      }
    }

    // D·x (x of the query tile is key tile qi) and the store of the PB
    // columns of y
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rt = 16 * wg + g + 8 * half, r = q0 + rt;
      if (r >= n) continue;
      T* out = y + (row0 + c0 + r) * xs + h * P + p0;
#pragma unroll
      for (int t = 0; t < NY8; ++t) {
        const int col = 8 * t + q2;
        if (col >= PB) continue;
        const float2 xv =
            BF ? Cvt<T>::ld2(reinterpret_cast<const T*>(
                     sX + qi * Tc::xtile + rt * 128 + ((t ^ (rt & 7)) << 4)) +
                 q2)
               : Cvt<T>::ld2(reinterpret_cast<const T*>(sX) + rt * Fs::LDP + col);
        const float v0 = acc[t][2 * half] + dh * xv.x;
        const float v1 = acc[t][2 * half + 1] + dh * xv.y;
        if constexpr (BF)
          *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
      }
    }
  }
}

// -- launch -------------------------------------------------------------------

// Launch `kernel` so that it may start before the kernel ahead of it on
// `stream` ends (programmatic stream serialization): its blocks run their
// independent loads, then wait in grid_dependency_wait.
template <typename... K, typename... A>
cudaError_t launch_after(void (*kernel)(K...), dim3 grid, dim3 block,
                         size_t smem, cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

struct Args {
  const void *x, *dt, *a, *b, *c, *d, *init;
  void *y, *fin, *states, *dec, *prev;
  int B, S, H, P, L;
  cudaStream_t stream;
};

template <typename T, int N, int PB>
cudaError_t launch(const Args& g) {
  if (g.L > OUT_TILES<T> * TILE) return cudaErrorInvalidValue;
  constexpr size_t smem1 = StateSmem<T, N, PB>::bytes;
  constexpr size_t smem3 = out_smem<T, N, PB>();
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err = cudaFuncSetAttribute(
        state_kernel<T, N, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(out_kernel<T, N, PB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
    if (err != cudaSuccess) return err;
    attrs_set = true;
  }
  const int nc = (g.S + g.L - 1) / g.L;
  const T* x = static_cast<const T*>(g.x);
  const float* dt = static_cast<const float*>(g.dt);
  const float* a = static_cast<const float*>(g.a);
  const T* bm = static_cast<const T*>(g.b);
  float* states = static_cast<float*>(g.states);
  float* dec = static_cast<float*>(g.dec);
  T* prev = static_cast<T*>(g.prev);
  state_kernel<T, N, PB><<<dim3(g.H * (g.P / PB), nc, g.B), NT, smem1,
                           g.stream>>>(x, dt, a, bm, states, dec, g.S, g.H,
                                       g.P, g.L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)g.B * g.H * g.P * N / 4;
  err = launch_after(recur_kernel<T>,
                     dim3((unsigned)((n4 + RT_THREADS - 1) / RT_THREADS)),
                     dim3(RT_THREADS), 0, g.stream,
                     static_cast<const float*>(g.init),
                     static_cast<const float*>(states),
                     static_cast<const float*>(dec), prev,
                     static_cast<float*>(g.fin), g.B, g.H, g.P * N, nc);
  if (err != cudaSuccess) return err;
  return launch_after(out_kernel<T, N, PB>, dim3(g.H * (g.P / PB), nc, g.B),
                      dim3(OUT_THREADS), smem3, g.stream, x, dt, a, bm,
                      static_cast<const T*>(g.c),
                      static_cast<const float*>(g.d),
                      static_cast<const T*>(prev), static_cast<T*>(g.y), g.S,
                      g.H, g.P, g.L);
}

// the widest slice of state rows, of 64, 32 or 16, that divides P
int p_block(int P) { return P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16; }

template <typename T, int N>
cudaError_t dispatch_pb(const Args& g) {
  switch (p_block(g.P)) {
    case 64:
      return launch<T, N, 64>(g);
    case 32:
      return launch<T, N, 32>(g);
    default:
      return launch<T, N, 16>(g);
  }
}

template <typename T>
cudaError_t dispatch_n(int N, const Args& g) {
  switch (N) {
    case 16:
      return dispatch_pb<T, 16>(g);
    case 64:
      return dispatch_pb<T, 64>(g);
    case 128:
      return dispatch_pb<T, 128>(g);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int N>
long smem_of(int PB, int pass) {
  switch (PB) {
    case 64:
      return pass == 1 ? StateSmem<T, N, 64>::bytes : out_smem<T, N, 64>();
    case 32:
      return pass == 1 ? StateSmem<T, N, 32>::bytes : out_smem<T, N, 32>();
    default:
      return pass == 1 ? StateSmem<T, N, 16>::bytes : out_smem<T, N, 16>();
  }
}

template <typename T>
long smem_n(int N, int PB, int pass) {
  switch (N) {
    case 16:
      return smem_of<T, 16>(PB, pass);
    case 64:
      return smem_of<T, 64>(PB, pass);
    case 128:
      return smem_of<T, 128>(PB, pass);
    default:
      return -1;
  }
}

}  // namespace

// x (B, S, H, P), dt (B, S, H) f32, a (H,) f32, b/c (B, S, N), d (H,) f32,
// init (B, H, P, N) f32 or null, y (B, S, H, P), fin (B, H, P, N) f32;
// scratch, with n = ceil(S/L): states (B, n, H, P, N) f32, dec (B, n, H)
// f32 and prev (planes, B, n, H, P, N) in `dtype`, 2 planes for bf16 and 1
// for f32; x/b/c/y/prev share `dtype`
// (0 f32, 1 bf16); x, b, c, init and prev are 16-byte aligned; P a
// multiple of 16, N in {16, 64, 128}, L (tokens a state chunk) a multiple
// of 64 up to 256. Three kernels on `stream`; returns the CUDA error code
// of the launches (0 = ok).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* d,
                            const void* init, void* y, void* fin,
                            void* states, void* dec, void* prev, int B, int S,
                            int H, int P, int N, int L, int dtype,
                            void* stream) {
  if (P % 16 != 0 || P <= 0 || S <= 0 || B <= 0 || H <= 0 ||
      L % TILE != 0 || L <= 0 || L > MAX_L)
    return cudaErrorInvalidValue;
  const Args g{x, dt, a, b, c, d, init, y, fin, states, dec, prev,
               B, S, H, P, L, static_cast<cudaStream_t>(stream)};
  if (dtype == rt::DTYPE_F32) return dispatch_n<float>(N, g);
  if (dtype == rt::DTYPE_BF16) return dispatch_n<bf16>(N, g);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory in bytes of pass 1 (`pass` 1) or pass 3 (3) for
// state dim N, head dim P and `dtype`; -1 for a shape the kernel does not
// take.
extern "C" long ssd_scan_smem(int N, int P, int dtype, int pass) {
  if (P % 16 != 0 || P <= 0 || (pass != 1 && pass != 3)) return -1;
  if (dtype == rt::DTYPE_F32) return smem_n<float>(N, p_block(P), pass);
  if (dtype == rt::DTYPE_BF16) return smem_n<bf16>(N, p_block(P), pass);
  return -1;
}
