// Dense decode attention for Hopper, sm_90a.
//
// Replaces the TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention/kernel.py (pallas_call at :92): one
// query token per batch row against a dense ring-buffer cache
// k/v (b, S, nkv, hd) whose kv_pos (b, S) marks empty slots with -1, with
// the query at q_pos (b,), an optional sliding window, and the g query
// heads of a kv head handled together.
//
// What bounds it on the card: the K/V bytes it reads (each element feeds
// only g = 4 multiply-adds per product on the serving path), so the least
// time is those bytes over 3.35 TB/s; details in decode_common.cuh.
// What the design does about it: the TPU kernel walked the KV blocks as
// its sequential innermost grid axis; here the walk is split across
// blocks (split-K flash-decode, the shape its docstring names for CUDA)
// so the whole card streams K/V at once, the g query heads of a kv head
// share every row read, a second pass merges the splits, and slots whose
// kv_pos is -1 or outside the window are never read.

#include "decode_common.cuh"

namespace {

struct DenseKV {
  const int* qpos;   // (b,)
  const int* kpos;   // (b, S)
  int S;
  int nkv;
  __device__ __forceinline__ int qpos_of(int bi) const { return qpos[bi]; }
  __device__ __forceinline__ int end(int bi) const { return S; }
  __device__ __forceinline__ bool valid(int bi, int t, int qp,
                                        int window) const {
    const int p = kpos[(size_t)bi * S + t];
    return p >= 0 && p <= qp && (window <= 0 || p > qp - window);
  }
  __device__ __forceinline__ size_t row(int bi, int t, int kvh) const {
    return ((size_t)bi * S + t) * nkv + kvh;
  }
};

}  // namespace

// q (b, nq, hd), k/v (b, S, nkv, hd), qpos (b,), kpos (b, S) int32,
// out (b, nq, hd); partials as in decode_common.cuh. Returns the CUDA
// error code of the launches (0 = ok).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* qpos,
                                    const void* kpos, void* out, void* m_part,
                                    void* l_part, void* acc_part, int b,
                                    int S, int nq, int nkv, int hd, int dtype,
                                    int window, int split_len, int nsplit,
                                    float scale, void* stream) {
  DenseKV kv{static_cast<const int*>(qpos), static_cast<const int*>(kpos), S,
             nkv};
  return rt::decode_dispatch(dtype, hd, q, k, v, kv, out, m_part, l_part,
                             acc_part, b, nq, nkv, nsplit, split_len, window,
                             scale, static_cast<cudaStream_t>(stream));
}
