// Dense decode attention for Hopper, sm_90a.
//
// Replaces the TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention/kernel.py (pallas_call at :92): one
// query token per batch row against a dense ring-buffer cache
// k/v (b, S, nkv, hd), in q's dtype or e4m3 (an fp8 cache, read as it is
// instead of widened whole before the call, as the reference's layer
// does), whose kv_pos (b, S) marks empty slots with -1, with
// the query at q_pos (b,), an optional sliding window, and the g query
// heads of a kv head handled together.
//
// What bounds it on the card: the K/V bytes of the valid slots (each
// element feeds only g multiply-adds per product, 4 for llava and 16 for
// glm4-9b), so the least time is those bytes over 3.35 TB/s.
// What the design does about it (details in decode_common.cuh): the TPU
// kernel walked the KV blocks as its sequential innermost grid axis; here
// the walk is split across blocks so the whole card streams K/V at once,
// each block keeping its next 64-token tiles in flight through a cp.async
// ring in shared memory, and the last block of a (row, kv head) merges the
// splits in the same launch. A block reads kv_pos for its split first,
// copies only the rows of valid slots and walks only the tiles between its
// first and last valid key, so a short row, a ring whose live slots are
// rotated against slot order (written at cur_len % S) or a window costs
// only the bytes of the keys the query sees.

#include "decode_common.cuh"

namespace {

struct DenseKV {
  const int* qpos;   // (b,)
  const int* kpos;   // (b, S)
  int S;
  int nkv;
  __device__ __forceinline__ int qpos_of(int bi) const { return qpos[bi]; }
  __device__ __forceinline__ int end(int bi) const { return S; }
  __device__ __forceinline__ void prefetch(int, int, int, int*) const {}
  // rows of tokens t_begin + [0, n_fill): (b, S, nkv) row index, or -1 past
  // the split's n_tok tokens or where kv_pos says the slot is no valid key;
  // lo and hi take the thread's first and last valid index
  __device__ __forceinline__ void fill_rows(int bi, int kvh, int t_begin,
                                            int n_tok, int n_fill, int qp,
                                            int window, int* rows, int*,
                                            bool, int& lo, int& hi) const {
    for (int i = threadIdx.x; i < n_fill; i += blockDim.x) {
      const int t = t_begin + i;
      bool ok = false;
      if (i < n_tok) {
        const int p = kpos[(size_t)bi * S + t];
        ok = p >= 0 && p <= qp && (window <= 0 || p > qp - window);
      }
      rows[i] = ok ? (bi * S + t) * nkv + kvh : -1;
      if (ok) {
        lo = min(lo, i);
        hi = i;
      }
    }
  }
};

}  // namespace

// q (b, nq, hd) and out (b, nq, hd) in dtype, k/v (b, S, nkv, hd) in
// kv_dtype (dtype or DTYPE_FP8, e4m3), qpos (b,), kpos (b, S) int32;
// nsplit splits of split_len tokens a row (a multiple of 64); part and
// counters as in decode_common.cuh (unused for one split).
// Returns the CUDA error code of the launch (0 = ok).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* qpos,
                                    const void* kpos, void* out, void* part,
                                    void* counters, int b, int S, int nq,
                                    int nkv, int hd, int dtype,
                                    int kv_dtype, int window, int split_len,
                                    int nsplit, float scale, void* stream) {
  DenseKV kv{static_cast<const int*>(qpos), static_cast<const int*>(kpos), S,
             nkv};
  return rt::decode_dispatch(dtype, kv_dtype, hd, q, k, v, kv, out, part,
                             counters, b, nq, nkv, nsplit, split_len, window,
                             scale, static_cast<cudaStream_t>(stream));
}
