// Paged decode attention for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_decode_attention` of
// src/repro/kernels/paged_decode_attention/kernel.py (pallas_call at
// :122): one query token per slot against a shared pool
// k/v (P, page, nkv, hd), in q's dtype or in e4m3 as the TPU kernel reads
// the reference's fp8 pools (kernel.py:51-52 widens them in the kernel),
// read through a block table (b, max_pages);
// lengths (b,) counts the slot's tokens including the current one, so
// the query sits at position length-1; optional sliding window; a slot
// of length 0 gives 0.
//
// What bounds it on the card: the K/V bytes of the slots' real tokens
// (g multiply-adds per element read: 4 for llava, 16 for glm4-9b), over
// 3.35 TB/s. What the design does about it (details in
// decode_common.cuh, whose device code this kernel shares with the dense
// one): the reads are a gather, page by page, so each block first takes
// the physical pages of its split from the block table (once a page; the
// TPU kernel took the table by scalar prefetch) and then streams the
// pages' K/V rows through the same cp.async ring. A split past a slot's
// last token reads no table entry and no K/V row (it only reports an
// empty partial), so memory traffic follows each slot's length, not the
// table's width.

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
  // the physical pages of tokens t_begin + [0, span), clipped to the
  // table; read before the slot's length is known
  __device__ __forceinline__ void prefetch(int bi, int t_begin, int span,
                                           int* pages) const {
    const int p0 = t_begin / page;
    const int np = min((t_begin + span - 1) / page, max_pages - 1) - p0 + 1;
    for (int i = threadIdx.x; i < np; i += blockDim.x)
      pages[i] = tbl[(size_t)bi * max_pages + p0 + i];
  }
  // rows of tokens t_begin + [0, n_fill): (P, page, nkv) row index, or -1
  // past the split's n_tok tokens or before the window, through the pages
  // in `pages` (read once a page, here unless `fetched`); lo and hi take
  // the thread's first and last valid index
  __device__ __forceinline__ void fill_rows(int bi, int kvh, int t_begin,
                                            int n_tok, int n_fill, int qp,
                                            int window, int* rows,
                                            int* pages, bool fetched,
                                            int& lo, int& hi) const {
    const int p0 = t_begin / page;
    if (!fetched) {
      prefetch(bi, t_begin, n_tok, pages);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < n_fill; i += blockDim.x) {
      const int t = t_begin + i;
      const bool ok = i < n_tok && (window <= 0 || t > qp - window);
      rows[i] = ok ? (pages[t / page - p0] * page + t % page) * nkv + kvh
                   : -1;
      if (ok) {
        lo = min(lo, i);
        hi = i;
      }
    }
  }
};

}  // namespace

// q (b, nq, hd) and out (b, nq, hd) in dtype, pools (P, page, nkv, hd) in
// kv_dtype (dtype or DTYPE_FP8, e4m3), tbl (b, max_pages) and lens (b,)
// int32; nsplit splits of split_len tokens a slot (a multiple of 64);
// part and counters as in decode_common.cuh (unused for one split).
// Returns the CUDA error code of the launch (0 = ok).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* tbl,
    const void* lens, void* out, void* part, void* counters, int b, int page,
    int max_pages, int nq, int nkv, int hd, int dtype, int kv_dtype,
    int window, int split_len, int nsplit, float scale, void* stream) {
  PagedKV kv{static_cast<const int*>(tbl), static_cast<const int*>(lens),
             page, max_pages, nkv};
  return rt::decode_dispatch(dtype, kv_dtype, hd, q, k_pool, v_pool, kv, out,
                             part, counters, b, nq, nkv, nsplit, split_len,
                             window, scale,
                             static_cast<cudaStream_t>(stream));
}
