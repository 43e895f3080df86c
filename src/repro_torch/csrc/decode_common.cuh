// Split-K flash-decode shared by the dense and the paged decode kernels.
//
// One query token per batch row attends over its KV. The device code is
// one template over a KV source: the dense ring-buffer cache (kv_pos marks
// empty slots) or the paged pool read through the block table. For one
// split of a row, the source fills a table in shared memory with the K/V
// row of each token, or -1 where the token is no valid key for the query.
//
// What bounds it on the card: bytes. Each K/V element read is used for
// g multiply-adds per product (g = q heads per kv head: 4 for llava, 16
// for glm4-9b), far below the ~295 flops a byte at which the H100 stops being
// memory-bound, so the least time is the K/V bytes over 3.35 TB/s. The
// card reaches that rate only with megabytes in flight at once (tens of
// KB on every SM) and with the math of a tile hidden behind the loads of
// the next ones.
//
// What the design does about it:
// * One block of 256 threads per (batch row, kv head, split of
//   `split_len` tokens); the wrapper sizes the splits from shapes alone
//   so that the grid puts about two blocks on every SM. The g q heads of
//   a kv head share every K/V row read. A split first builds a table of
//   its tokens' K/V rows in shared memory (-1 for a token that is no valid
//   key: an empty ring slot, a key outside the window, past the slot's
//   length) and walks only the 64-token tiles from its first to its last
//   valid key, through a DEC_STAGES-deep ring filled by cp.async 16-byte
//   copies: all stages are in flight before the first tile's math starts,
//   and a stage is refilled as soon as its tile is consumed. Invalid
//   tokens are zero-filled without a load. Rows are padded by 16 bytes in
//   shared memory, so the column reads below hit distinct banks.
// * bf16: Q.K^T and P.V on the tensor cores with mma.sync, the q heads
//   on M (padded to 16; G = 16 fills rows 8-15 as well, the instruction's
//   natural width), 8 tokens a warp: S = Q K^T (m16n8k16, K rows by
//   ldmatrix), each warp's own online softmax over the 4 lanes of a row,
//   then O += P V (m16n8k8, P straight from S's registers, rounded to bf16
//   as the TPU kernel rounds p, V by ldmatrix.trans). No block barrier
//   between a tile's two products; the warps' (m, l, O) merge once at
//   the end.
// * K/V in e4m3 (an fp8 KV cache or pool, the reference's
//   kv_dtype=float8_e4m3fn): the storage type KT is a template parameter
//   apart from q's and out's type T, so the ring holds the bytes as they
//   are (16 elements a 16-byte cp.async chunk: half the bytes a tile) and
//   each value is widened exactly where it is used (every e4m3 value,
//   subnormals and NaN included, is exact in f16, bf16 and f32). The
//   bf16 products take their fragments from 4-byte reads of the rows:
//   Q.K^T permutes its k order inside each 16-dim step (q's fragments
//   are loaded in the same order), P.V takes dims 32m + 4n + j as column
//   n of n-block j and puts them back in order at the end.
// * f32 (no tensor-core path at this precision): CUDA cores, threads
//   across tokens for Q.K^T (four threads a token, each a quarter of hd
//   inside the thread against q in shared memory), one warp per q head for
//   the softmax (two heads a warp at G = 16), rescaled once a tile,
//   threads across hd for P.V, 4 elements a thread (one 16-byte chunk of
//   f32, one 4-byte word of e4m3), so a thread holds G x 4 sums.
// * The group size is a template parameter G in {1, 2, 4, 8, 16} (a g
//   below G runs as G with the extra heads idle), so g = 4 carries 4-wide
//   arrays. A group above 16 (the TPU kernel takes any) runs in parts of
//   16 along the grid's y: block (split, kv head x part, row) takes q
//   heads [16 part, 16 part + 16) of its kv head and reads its K/V once a
//   part.
// * Partials are sized to G and to the splits of the launch: a split with
//   no valid key writes only m = -1e30 and l = 0, no accumulator. The last
//   block of a (row, kv head) to finish, found with a counter that it
//   resets for the next launch, merges the splits' partials in the same
//   launch, eight splits' loads in flight at once. A launch of one split
//   writes its output directly. A row with no valid key gives 0, as the
//   TPU kernel does (l == 0 -> 1).
#pragma once

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace rt {

constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_TILE = 64;       // tokens per ring stage
constexpr int DEC_PARTS = DEC_THREADS / DEC_TILE;   // hd parts of Q.K^T
constexpr int DEC_STAGES = 2;      // ring depth: tiles in flight
constexpr int DEC_SEG = 1024;      // tokens a row table covers
constexpr float DEC_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes global -> shared, bypassing L1; zero-filled without a read when
// `pred` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* d, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* d, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16x8, f32) += a (16x8, bf16, row) * b (8x8, bf16, col)
__device__ __forceinline__ void mma_1688(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two e4m3 values (the low 16 bits, lowest byte first) widened to float:
// e4m3 -> f16 (cvt.rn.f16x2.e4m3x2) -> f32, both exact
__device__ __forceinline__ float2 f8x2_to_float2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// four e4m3 values (the bytes of w, lowest first) widened to float
__device__ __forceinline__ void f8x4_to_f32(uint32_t w, float* f) {
  const float2 a = f8x2_to_float2(w), b = f8x2_to_float2(w >> 16);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// two e4m3 values (the low 16 bits) as a bf16x2 mma operand, exact
__device__ __forceinline__ uint32_t f8x2_to_bf16x2(uint32_t two) {
  const float2 f = f8x2_to_float2(two);
  return pack_bf16(f.x, f.y);
}

// dot[gi] += q[gi][d0 .. d0 + N) . kf for the G q heads (q in shared
// memory, f32, HD a head), as two FMA chains a head
template <int G, int HD, int N>
__device__ __forceinline__ void dot_q(float (&dot)[G][2], const float* s_q,
                                      const float* kf, int d0) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const float4* qv = reinterpret_cast<const float4*>(s_q + gi * HD + d0);
#pragma unroll
    for (int e4 = 0; e4 < N / 4; ++e4) {
      const float4 x = qv[e4];
      dot[gi][0] = fmaf(x.x, kf[4 * e4], dot[gi][0]);
      dot[gi][1] = fmaf(x.y, kf[4 * e4 + 1], dot[gi][1]);
      dot[gi][0] = fmaf(x.z, kf[4 * e4 + 2], dot[gi][0]);
      dot[gi][1] = fmaf(x.w, kf[4 * e4 + 3], dot[gi][1]);
    }
  }
}

// one 16-byte chunk of a K/V row, widened to float
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Chunk<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f8x4_to_f32(u.x, f);
    f8x4_to_f32(u.y, f + 4);
    f8x4_to_f32(u.z, f + 8);
    f8x4_to_f32(u.w, f + 12);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

// Shared-memory layout of one block (dynamic), in this order: the K/V
// ring, q (G x HD, f32, pre-scaled), the score sums of the hd parts
// (DEC_PARTS x G x TILE), the probabilities (TILE x G), alpha (G), final m
// and l (2G), the row table of a segment (DEC_SEG ints) and the source's
// own table (DEC_SEG + 2). The ring, once drained, holds the per-warp sums
// (DEC_WARPS x G x HD f32); where they outgrow it (e4m3 at G = 16, whose
// ring holds half the bytes of bf16's), the first region is sized to them,
// which leaves two blocks an SM all the same.
// KT is the K/V storage type.
template <typename KT, int HD, int G>
struct DecLayout {
  static constexpr int C = HD * (int)sizeof(KT) / 16;  // chunks in a row
  static constexpr int RS = C + 1;                     // padded row stride
  static constexpr int TILE_CH = DEC_TILE * RS;        // chunks a K/V tile
  static constexpr size_t RING = (size_t)DEC_STAGES * 2 * TILE_CH * 16;
  static constexpr size_t RED = (size_t)4 * DEC_WARPS * G * HD;
  static constexpr size_t STAGE = RING > RED ? RING : RED;
  static constexpr size_t BYTES =
      STAGE + 4 * ((size_t)G * HD + DEC_PARTS * G * DEC_TILE + DEC_TILE * G +
                   3 * G + 2 * DEC_SEG + 2);
};

// One block per (split, kv head x part, batch row); q and out in T, K/V
// stored in KT (T, or e4m3). Partials, f32, one buffer: acc (rows,
// nsplit, G, HD) then m and l (rows, nsplit, 2, G), rows = b * nkv *
// parts; counters (rows,) int32, 0 between launches.
template <typename T, typename KT, int HD, int G, class KV>
__global__ void __launch_bounds__(DEC_THREADS)
decode_split_kernel(const T* __restrict__ q, const KT* __restrict__ kc,
                    const KT* __restrict__ vc, KV kv, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters,
                    int nq, int g, int parts, int split_len, int window,
                    float qscale) {
  using L = DecLayout<KT, HD, G>;
  constexpr int C = L::C, RS = L::RS, TILE_CH = L::TILE_CH;
  constexpr int EPC = Chunk<KT>::N;         // elements a chunk
  constexpr int PV = 4;                     // elements a thread, P.V
  constexpr int U = HD / PV;                // P.V units in a row
  constexpr int NTG = DEC_THREADS / U;      // token groups of P.V
  // tokens a thread a tile, P.V
  constexpr int TPT = NTG >= DEC_TILE ? 1 : DEC_TILE / NTG;
  constexpr int HD4 = HD / 4;
  constexpr int CP = C / DEC_PARTS;         // chunks a thread, Q.K^T
  constexpr int NCP = (DEC_TILE * C + DEC_THREADS - 1) / DEC_THREADS;
  // a row of two chunks (e4m3, hd 32) runs Q.K^T on half a chunk a thread
  static_assert((C % DEC_PARTS == 0 || 2 * C == DEC_PARTS) && C <= 32,
                "row chunks");
  constexpr bool kF8 = std::is_same<KT, __nv_fp8_e4m3>::value;
  static_assert(kF8 || std::is_same<KT, T>::value, "K/V in T or e4m3");
  // bf16 runs Q.K^T and P.V on the tensor cores, 8 tokens a warp
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static_assert(!kMma || DEC_TILE == 8 * DEC_WARPS, "8 tokens a warp");
  static_assert(U <= 32 && NTG <= DEC_TILE && DEC_TILE % NTG == 0 &&
                    (G <= 8 || G == 16),
                "P.V units, group width");
  // mma rows in use: heads 0-7 in rows r, heads 8-15 in rows r + 8
  constexpr int MR = G > 8 ? 2 : 1;

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* s_q = reinterpret_cast<float*>(smem + L::STAGE);
  float* s_s = s_q + G * HD;               // [DEC_PARTS][G][TILE]
  float* s_p = s_s + DEC_PARTS * G * DEC_TILE;   // [TILE][G]
  float* s_alpha = s_p + DEC_TILE * G;     // [G]
  float* s_ml = s_alpha + G;               // m [G], l [G]
  int* s_row = reinterpret_cast<int*>(s_ml + 2 * G);
  int* s_aux = s_row + DEC_SEG;
  __shared__ int s_lohi[2][DEC_WARPS];
  __shared__ int s_last;

  const int split = blockIdx.x, bi = blockIdx.z;
  // parts exist only at G = 16 (the wrapper sends g <= 8 to G <= 8), so
  // the narrower instances keep one block row a kv head and all g heads
  constexpr bool kParts = G == 16;
  const int kvh = kParts ? blockIdx.y / parts : blockIdx.y;
  const int hp = kParts ? blockIdx.y - kvh * parts : 0;
  const int h0 = kvh * g + hp * G;          // this block's first q head
  const int gp = kParts ? min(G, g - hp * G) : g;   // and its count
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t_begin = split * split_len;
  // tokens of this split; none past a paged slot's length (no load then)
  const int n_tok = max(0, min(split_len, kv.end(bi) - t_begin));
  const int qp = kv.qpos_of(bi);
  // the first segment's table entries (paged: its pages), in flight with
  // the row's length
  kv.prefetch(bi, t_begin, min(split_len, DEC_SEG), s_aux);

  // q: bf16 as mma A fragments (row = q head, padded to 16), f32 in s_q
  constexpr int KS = HD / 16;                // k-steps of Q.K^T (mma)
  uint32_t qa[KS][2 * MR];                   // [ks][2 mr + k half]
  const int r = lane >> 2, cq = lane & 3;    // mma fragment row and column
  if (n_tok > 0) {
    if constexpr (kMma) {
      // k order of a 16-dim step: bf16 K the mma's own (2cq, 2cq + 8);
      // e4m3 K dims 4cq .. 4cq + 3, one 4-byte read of the row
      const int i0 = kF8 ? 2 * cq : cq, i1 = kF8 ? 2 * cq + 1 : cq + 4;
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        const int row = r + 8 * mr;
        const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
            q + ((size_t)bi * nq + h0 + row) * HD);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          qa[ks][2 * mr] = row < gp ? qrow[ks * 8 + i0] : 0u;
          qa[ks][2 * mr + 1] = row < gp ? qrow[ks * 8 + i1] : 0u;
        }
      }
    } else {
      for (int i = tid; i < G * HD; i += DEC_THREADS)
        s_q[i] = i / HD < gp ? Cvt<T>::to_f(
                                   q[((size_t)bi * nq + h0) * HD + i]) *
                                   qscale
                             : 0.f;
    }
  }
  // the A fragment of k-step ks: rows r (heads 0-7) and, at G = 16, r + 8
  auto afrag = [&](int ks, uint32_t* a) {
    a[0] = qa[ks][0];
    a[2] = qa[ks][1];
    if constexpr (MR > 1) {
      a[1] = qa[ks][2];
      a[3] = qa[ks][3];
    } else {
      a[1] = a[3] = 0u;
    }
  };

  // running softmax: mma path, per warp and q head row r (its 8 tokens
  // of every tile); CUDA-core path, per q head in the warp that owns it
  constexpr int GW = (G + DEC_WARPS - 1) / DEC_WARPS;
  static_assert(GW >= MR, "a running (m, l) per mma row");
  float m_run[GW], l_run[GW];
#pragma unroll
  for (int k = 0; k < GW; ++k) {
    m_run[k] = NEG_INF;
    l_run[k] = 0.f;
  }
  float acc[G][PV];                        // CUDA-core P.V
  // mma P.V: rows r (and r + 8), 2 columns an n-block: [n][2 mr + e]
  float oacc[HD / 8][2 * MR];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < PV; ++e) acc[gi][e] = 0.f;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2 * MR; ++e) oacc[n][e] = 0.f;

  // the split in segments of DEC_SEG tokens (one for the serving shapes)
  bool any = false;
  for (int seg = 0; seg < n_tok; seg += DEC_SEG) {
    const int n_seg = min(DEC_SEG, n_tok - seg);
    // the row table, and the tiles from the first to the last valid key
    int lo = INT_MAX, hi = -1;
    __syncthreads();              // the last segment's tables are read
    kv.fill_rows(bi, kvh, t_begin + seg, n_seg,
                 (n_seg + DEC_TILE - 1) / DEC_TILE * DEC_TILE, qp, window,
                 s_row, s_aux, seg == 0, lo, hi);
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      s_lohi[0][warp] = lo;
      s_lohi[1][warp] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      lo = min(lo, s_lohi[0][w]);
      hi = max(hi, s_lohi[1][w]);
    }
    if (hi < 0) continue;         // no valid key in the segment
    any = true;
    const int tile0 = lo / DEC_TILE;
    const int n_tiles = hi / DEC_TILE - tile0 + 1;

    auto issue = [&](int it) {
      uint4* kd = ring + (it % DEC_STAGES) * 2 * TILE_CH;
      uint4* vd = kd + TILE_CH;
      const int* rows = s_row + (tile0 + it) * DEC_TILE;
#pragma unroll
      for (int j = 0; j < NCP; ++j) {
        const int c = tid + j * DEC_THREADS;
        if (DEC_TILE * C % DEC_THREADS != 0 && c >= DEC_TILE * C) break;
        const int tok = c / C, col = c % C;
        const int rw = rows[tok];
        const size_t off = (size_t)max(rw, 0) * HD + col * EPC;
        cp_async16(kd + tok * RS + col, kc + off, rw >= 0);
        cp_async16(vd + tok * RS + col, vc + off, rw >= 0);
      }
    };
#pragma unroll
    for (int st = 0; st < DEC_STAGES; ++st) {
      if (st < n_tiles) issue(st);
      cp_async_commit();
    }

    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<DEC_STAGES - 1>();
      __syncthreads();            // tile `it` landed
      const uint4* kt = ring + (it % DEC_STAGES) * 2 * TILE_CH;
      const uint4* vt = kt + TILE_CH;
      const int* rows = s_row + (tile0 + it) * DEC_TILE;

      if constexpr (kMma) {
        // warp w: tokens 8w..8w+7 of the tile. S (16 x 8) = Q K^T with
        // m16n8k16 (K rows by ldmatrix), the online softmax of row r over
        // the lanes of a row, then O += P V with m16n8k8 (P from S's
        // registers, V by ldmatrix.trans).
        const int tw = warp * 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (kF8) {
          // this lane's 4 bytes of each 16-dim step of token tw + r's K
          // row, dims 16ks + 4cq .. +3 (the order q's fragments hold)
          const uint32_t* krow =
              reinterpret_cast<const uint32_t*>(kt + (tw + r) * RS);
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const uint32_t w = krow[4 * ks + cq];
            const uint32_t kb[2] = {f8x2_to_bf16x2(w),
                                    f8x2_to_bf16x2(w >> 16)};
            uint32_t a[4];
            afrag(ks, a);
            mma_16816(s, a, kb);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < KS; ks += 2) {
            uint32_t kb[4];
            ldsm_x4(kb, kt + (tw + (lane & 7)) * RS + 2 * ks + (lane >> 3));
            uint32_t a[4];
            afrag(ks, a);
            mma_16816(s, a, kb);
            if (ks + 1 < KS) {
              afrag(ks + 1, a);
              mma_16816(s, a, kb + 2);
            }
          }
        }
        const bool ok0 = rows[tw + 2 * cq] >= 0;
        const bool ok1 = rows[tw + 2 * cq + 1] >= 0;
        // the online softmax of rows r and (G = 16) r + 8: S's registers
        // 2 mr and 2 mr + 1
        float alpha[MR];
        uint32_t pa[MR];
#pragma unroll
        for (int mr = 0; mr < MR; ++mr) {
          const float s0 = ok0 ? s[2 * mr] * qscale : NEG_INF;
          const float s1 = ok1 ? s[2 * mr + 1] * qscale : NEG_INF;
          float mt = fmaxf(s0, s1);
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float mn = fmaxf(m_run[mr], mt);
          alpha[mr] = exp2f(m_run[mr] - mn);
          const float p0 = ok0 ? exp2f(s0 - mn) : 0.f;
          const float p1 = ok1 ? exp2f(s1 - mn) : 0.f;
          float ps = p0 + p1;
          ps += __shfl_xor_sync(0xffffffffu, ps, 1);
          ps += __shfl_xor_sync(0xffffffffu, ps, 2);
          l_run[mr] = l_run[mr] * alpha[mr] + ps;
          m_run[mr] = mn;
          pa[mr] = pack_bf16(p0, p1);
        }
        // O (rows r, r + 8) = alpha O + P V, one n-block of 8 columns
        auto pv = [&](float* d, uint32_t vb) {
          float c[4] = {d[0] * alpha[0], d[1] * alpha[0], 0.f, 0.f};
          if constexpr (MR > 1) {
            c[2] = d[2] * alpha[MR - 1];
            c[3] = d[3] * alpha[MR - 1];
          }
          mma_1688(c, pa[0], MR > 1 ? pa[MR - 1] : 0u, vb);
#pragma unroll
          for (int e = 0; e < 2 * MR; ++e) d[e] = c[e];
        };
        if constexpr (kF8) {
          // V rows of tokens tw + 2cq and tw + 2cq + 1: lane r reads bytes
          // 4r .. 4r + 3 of each 32-dim group m of both, so n-block 4m + j
          // holds dims 32m + 4n + j as its column n (n = 0..7)
          const uint32_t* v0 =
              reinterpret_cast<const uint32_t*>(vt + (tw + 2 * cq) * RS);
          const uint32_t* v1 = v0 + 4 * RS;
#pragma unroll
          for (int m = 0; m < HD / 32; ++m) {
            const uint32_t w0 = v0[8 * m + r], w1 = v1[8 * m + r];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              pv(oacc[4 * m + j],
                 f8x2_to_bf16x2(__byte_perm(w0, w1, j | (4 + j) << 4)));
          }
        } else {
#pragma unroll
          for (int n4 = 0; n4 < HD / 32; ++n4) {
            uint32_t vb[4];
            ldsm_x4_trans(vb,
                          vt + (tw + (lane & 7)) * RS + 4 * n4 + (lane >> 3));
#pragma unroll
            for (int j = 0; j < 4; ++j) pv(oacc[4 * n4 + j], vb[j]);
          }
        }
      } else {
        {   // Q.K^T: token tid % 64, part tid / 64 of hd
          const int t = tid & (DEC_TILE - 1), h = tid / DEC_TILE;
          float dot[G][2];          // two chains a head
#pragma unroll
          for (int gi = 0; gi < G; ++gi) dot[gi][0] = dot[gi][1] = 0.f;
          if constexpr (C >= DEC_PARTS) {
#pragma unroll
            for (int j = 0; j < CP; ++j) {
              const int col = h * CP + j;
              float kf[EPC];
              Chunk<KT>::unpack(kt[t * RS + col], kf);
              dot_q<G, HD, EPC>(dot, s_q, kf, col * EPC);
            }
          } else {
            // a row of two chunks: the half of chunk h / 2 at dims 8h..
            const uint4 u = kt[t * RS + (h >> 1)];
            float kf[8];
            f8x4_to_f32((h & 1) ? u.z : u.x, kf);
            f8x4_to_f32((h & 1) ? u.w : u.y, kf + 4);
            dot_q<G, HD, 8>(dot, s_q, kf, 8 * h);
          }
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
            s_s[(h * G + gi) * DEC_TILE + t] = dot[gi][0] + dot[gi][1];
        }
        __syncthreads();

        // softmax: warp w owns q heads w, w + DEC_WARPS
#pragma unroll
        for (int k = 0; k < GW; ++k) {
          const int gi = warp + DEC_WARPS * k;
          if (gi < G) {
            float sc[2];
            bool ok[2];
            float mt = NEG_INF;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int t = lane + 32 * u;
              ok[u] = rows[t] >= 0;
              float x = 0.f;
#pragma unroll
              for (int h = 0; h < DEC_PARTS; ++h)
                x += s_s[(h * G + gi) * DEC_TILE + t];
              sc[u] = ok[u] ? x : NEG_INF;
              mt = fmaxf(mt, sc[u]);
            }
            const float mn = fmaxf(m_run[k], warp_max(mt));
            const float alpha = exp2f(m_run[k] - mn);
            float ps = 0.f;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float p = ok[u] ? exp2f(sc[u] - mn) : 0.f;
              s_p[(lane + 32 * u) * G + gi] = p;
              ps += p;
            }
            l_run[k] = l_run[k] * alpha + warp_sum(ps);
            m_run[k] = mn;
            if (lane == 0) s_alpha[gi] = alpha;
          }
        }
        __syncthreads();

        {   // P.V: dims 4u .. 4u + 3 (u = tid % U; one chunk of f32, one
            // word of e4m3), tokens tid / U + i * NTG
          const int u = tid % U, tg = tid / U;
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            const float a = s_alpha[gi];
#pragma unroll
            for (int e = 0; e < PV; ++e) acc[gi][e] *= a;
          }
#pragma unroll
          for (int i = 0; i < TPT; ++i) {
            const int t = tg + i * NTG;
            float vf[PV], p[G];
            if constexpr (kF8)
              f8x4_to_f32(reinterpret_cast<const uint32_t*>(vt + t * RS)[u],
                          vf);
            else
              Chunk<KT>::unpack(vt[t * RS + u], vf);
#pragma unroll
            for (int gi = 0; gi < G; ++gi) p[gi] = s_p[t * G + gi];
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
#pragma unroll
              for (int e = 0; e < PV; ++e)
                acc[gi][e] = fmaf(p[gi], vf[e], acc[gi][e]);
          }
        }
      }
      __syncthreads();            // every thread is done with tile `it`
      if (it + DEC_STAGES < n_tiles) issue(it + DEC_STAGES);
      cp_async_commit();
    }
    cp_async_wait<0>();
  }

  float4* red = reinterpret_cast<float4*>(smem);   // [WARPS][G][HD4], ring
  if (any) {
    // the block's (m, l) per q head, and its accumulator as a sum over the
    // warps in shared memory (on the ring, now free)
    if constexpr (kMma) {
      // each warp ran its own softmax: rescale to the block's max first
      float* s_wm = s_s;                    // [WARPS][G] m, then l
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        const int row = r + 8 * mr;
        if (cq == 0 && row < G) {
          s_wm[warp * G + row] = m_run[mr];
          s_wm[(DEC_WARPS + warp) * G + row] = l_run[mr];
        }
      }
      __syncthreads();
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        const int row = r + 8 * mr;
        if (row >= G) continue;
        float M = NEG_INF;
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, s_wm[w * G + row]);
        const float sc = exp2f(m_run[mr] - M);
        float* dst = reinterpret_cast<float*>(red) + (warp * G + row) * HD;
        if constexpr (kF8) {      // column n of n-block 4m + j: 32m + 4n + j
#pragma unroll
          for (int m = 0; m < HD / 32; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                dst[32 * m + 4 * (2 * cq + e) + j] =
                    oacc[4 * m + j][2 * mr + e] * sc;
        } else {
#pragma unroll
          for (int n = 0; n < HD / 8; ++n) {
            dst[8 * n + 2 * cq] = oacc[n][2 * mr] * sc;
            dst[8 * n + 2 * cq + 1] = oacc[n][2 * mr + 1] * sc;
          }
        }
      }
      if (tid < G) {
        float M = NEG_INF, Lsum = 0.f;
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, s_wm[w * G + tid]);
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w)
          Lsum += s_wm[(DEC_WARPS + w) * G + tid] *
                  exp2f(s_wm[w * G + tid] - M);
        s_ml[tid] = M;
        s_ml[G + tid] = Lsum;
      }
    } else {
      // token groups of one chunk inside a warp by shuffles, then warps
#pragma unroll
      for (int k = 0; k < GW; ++k) {
        const int gi = warp + DEC_WARPS * k;
        if (gi < G && lane == 0) {
          s_ml[gi] = m_run[k];
          s_ml[G + gi] = l_run[k];
        }
      }
#pragma unroll
      for (int o = U; o < 32; o <<= 1)
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int e = 0; e < PV; ++e)
            acc[gi][e] += __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
      if (lane < U) {
        float* dst = reinterpret_cast<float*>(red) + warp * G * HD + lane * PV;
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int e = 0; e < PV; ++e) dst[gi * HD + e] = acc[gi][e];
      }
    }
  } else if (tid < G) {
    s_ml[tid] = NEG_INF;
    s_ml[G + tid] = 0.f;
  }
  __syncthreads();

  // the block's accumulator: the sum of its warps' (one split only: the
  // output); else its partial, and the last block of the (row, kv head)
  // to arrive merges every split's
  const int nsplit = gridDim.x, rowkv = bi * gridDim.y + blockIdx.y;
  const size_t rec = (size_t)rowkv * nsplit + split;
  float4* acc_part = reinterpret_cast<float4*>(part);
  float* ml_part = part + (size_t)gridDim.z * gridDim.y * nsplit * G * HD;
  auto store = [&](int i, float4 a, float l) {   // i: (q head, 4 of hd)
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* p = out + ((size_t)bi * nq + h0) * HD + 4 * i;
    p[0] = Cvt<T>::from_f(a.x * inv);
    p[1] = Cvt<T>::from_f(a.y * inv);
    p[2] = Cvt<T>::from_f(a.z * inv);
    p[3] = Cvt<T>::from_f(a.w * inv);
  };
  for (int i = tid; i < G * HD4; i += DEC_THREADS) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (any) {
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float4 x = red[w * G * HD4 + i];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
    }
    if (nsplit == 1) {
      if (i < gp * HD4) store(i, a, s_ml[G + i / HD4]);
    } else if (any) {             // a split with no valid key writes no acc
      acc_part[rec * G * HD4 + i] = a;
    }
  }
  if (nsplit == 1) return;
  if (tid < 2 * G) ml_part[rec * 2 * G + tid] = s_ml[tid];

  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counters + rowkv, 1);
    s_last = prev == nsplit - 1;
    if (s_last) counters[rowkv] = 0;       // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the merge, MB splits' loads in flight at once; l == 0 marks a split
  // with no valid key, and a row with none at all gives 0; a split whose
  // l is NaN (a NaN key, as an e4m3 cache stores past its range) makes
  // the row NaN, as in the plain version
  constexpr int MB = 8;
  const float4* ap = acc_part + (size_t)rowkv * nsplit * G * HD4;
  const float* mp = ml_part + (size_t)rowkv * nsplit * 2 * G;
  for (int i = tid; i < gp * HD4; i += DEC_THREADS) {
    const int gi = i / HD4;
    float M = NEG_INF, Lsum = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < nsplit; s0 += MB) {
      float ms[MB], ls[MB];
      float4 x[MB];
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const int sp = min(s0 + j, nsplit - 1);
        ms[j] = __ldcg(mp + sp * 2 * G + gi);
        ls[j] = s0 + j < nsplit ? __ldcg(mp + sp * 2 * G + G + gi) : 0.f;
        x[j] = __ldcg(ap + (size_t)sp * G * HD4 + i);
      }
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        if (ls[j] != 0.f) {         // a NaN (an e4m3 NaN key) carries on
          const float mn = fmaxf(M, ms[j]);
          const float ca = exp2f(M - mn), cb = exp2f(ms[j] - mn);
          Lsum = Lsum * ca + ls[j] * cb;
          A.x = A.x * ca + x[j].x * cb;
          A.y = A.y * ca + x[j].y * cb;
          A.z = A.z * ca + x[j].z * cb;
          A.w = A.w * ca + x[j].w * cb;
          M = mn;
        }
      }
    }
    store(i, A, Lsum);
  }
}

template <typename T, typename KT, int HD, int G, class KV>
int decode_launch(const void* q, const void* k, const void* v, const KV& kv,
                  void* out, void* part, void* counters, int b, int nq,
                  int nkv, int parts, int nsplit, int split_len, int window,
                  float scale, cudaStream_t st) {
  auto kern = decode_split_kernel<T, KT, HD, G, KV>;
  const size_t smem = DecLayout<KT, HD, G>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(nsplit, nkv * parts, b), DEC_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), kv, static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), nq, nq / nkv,
      parts, split_len, window, scale * DEC_LOG2E);
  return (int)cudaGetLastError();
}

// g = nq / nkv runs on the smallest G in {1, 2, 4, 8, 16} that holds it,
// a g above 16 in ceil(g / 16) parts of 16; K/V in q's dtype or in e4m3
// (kv_dtype DTYPE_FP8).
template <class KV>
int decode_dispatch(int dtype, int kv_dtype, int hd, const void* q,
                    const void* k, const void* v, const KV& kv, void* out,
                    void* part, void* counters, int b, int nq, int nkv,
                    int nsplit, int split_len, int window, float scale,
                    cudaStream_t st) {
  if (nsplit < 1 || split_len % DEC_TILE || nkv < 1 || nq % nkv)
    return (int)cudaErrorInvalidValue;
  const int g = nq / nkv;
  const int G = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : g <= 8 ? 8 : 16;
  const int parts = (g + G - 1) / G;
#define REPRO_DECODE_CASE(TT, KK, HH, GG)                                   \
  if (G == GG)                                                              \
    return decode_launch<TT, KK, HH, GG, KV>(q, k, v, kv, out, part,        \
                                             counters, b, nq, nkv, parts,   \
                                             nsplit, split_len, window,     \
                                             scale, st)
#define REPRO_DECODE_HD(TT, KK, HH)                                         \
  case HH: {                                                                \
    REPRO_DECODE_CASE(TT, KK, HH, 1);                                       \
    REPRO_DECODE_CASE(TT, KK, HH, 2);                                       \
    REPRO_DECODE_CASE(TT, KK, HH, 4);                                       \
    REPRO_DECODE_CASE(TT, KK, HH, 8);                                       \
    REPRO_DECODE_CASE(TT, KK, HH, 16);                                      \
    break;                                                                  \
  }
#define REPRO_DECODE_TYPES(TT, KK)                                          \
  switch (hd) {                                                             \
    REPRO_DECODE_HD(TT, KK, 32)                                             \
    REPRO_DECODE_HD(TT, KK, 64)                                             \
    REPRO_DECODE_HD(TT, KK, 128)                                            \
  }
  if (dtype == DTYPE_F32 && kv_dtype == DTYPE_F32) {
    REPRO_DECODE_TYPES(float, float)
  } else if (dtype == DTYPE_F32 && kv_dtype == DTYPE_FP8) {
    REPRO_DECODE_TYPES(float, __nv_fp8_e4m3)
  } else if (dtype == DTYPE_BF16 && kv_dtype == DTYPE_BF16) {
    REPRO_DECODE_TYPES(__nv_bfloat16, __nv_bfloat16)
  } else if (dtype == DTYPE_BF16 && kv_dtype == DTYPE_FP8) {
    REPRO_DECODE_TYPES(__nv_bfloat16, __nv_fp8_e4m3)
  }
#undef REPRO_DECODE_TYPES
#undef REPRO_DECODE_HD
#undef REPRO_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt
