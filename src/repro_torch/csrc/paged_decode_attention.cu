// Paged decode attention for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_decode_attention` of
// src/repro/kernels/paged_decode_attention/kernel.py (pallas_call at
// :122): one query token per slot against a shared pool
// k/v (P, page, nkv, hd) read through a block table (b, max_pages);
// lengths (b,) counts the slot's tokens including the current one, so
// the query sits at position length-1; optional sliding window; a slot
// of length 0 gives 0.
//
// What bounds it on the card: the K/V bytes of the slots' real tokens
// (g = 4 multiply-adds per element read on the serving path), over
// 3.35 TB/s; details in decode_common.cuh, whose split-K device code this
// kernel shares with the dense one. What the design does about it: the
// kernel reads the block table itself (the TPU kernel took it by scalar
// prefetch) and stops at the slot's length: splits past a slot's last
// token load nothing, so memory traffic follows each slot's actual
// length, not the table's width.

#include "decode_common.cuh"

namespace {

struct PagedKV {
  const int* tbl;    // (b, max_pages)
  const int* lens;   // (b,)
  int page;
  int max_pages;
  int nkv;
  __device__ __forceinline__ int qpos_of(int bi) const { return lens[bi] - 1; }
  __device__ __forceinline__ int end(int bi) const {
    return min(lens[bi], max_pages * page);
  }
  __device__ __forceinline__ bool valid(int bi, int t, int qp,
                                        int window) const {
    return window <= 0 || t > qp - window;     // t < length by end()
  }
  __device__ __forceinline__ size_t row(int bi, int t, int kvh) const {
    const int phys = tbl[(size_t)bi * max_pages + t / page];
    return ((size_t)phys * page + t % page) * nkv + kvh;
  }
};

}  // namespace

// q (b, nq, hd), pools (P, page, nkv, hd), tbl (b, max_pages) and
// lens (b,) int32, out (b, nq, hd); partials as in decode_common.cuh.
// Returns the CUDA error code of the launches (0 = ok).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tbl,
    const void* lens, void* out, void* m_part, void* l_part, void* acc_part,
    int b, int page, int max_pages, int nq, int nkv, int hd, int dtype,
    int window, int split_len, int nsplit, float scale, void* stream) {
  PagedKV kv{static_cast<const int*>(tbl), static_cast<const int*>(lens),
             page, max_pages, nkv};
  return rt::decode_dispatch(dtype, hd, q, k_pool, v_pool, kv, out, m_part,
                             l_part, acc_part, b, nq, nkv, nsplit, split_len,
                             window, scale,
                             static_cast<cudaStream_t>(stream));
}
