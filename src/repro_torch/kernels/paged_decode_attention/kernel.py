"""Wrapper of the hand-written paged decode-attention kernel
(``csrc/paged_decode_attention.cu``, device code shared with the dense
decode kernel), the Hopper replacement of the TPU kernel
``repro/kernels/paged_decode_attention/kernel.py:paged_decode_attention``.

CPU tensors take the plain PyTorch version
(``ref.paged_decode_attention_ref``); CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.decode_attention.kernel import (check_group,
                                                         launch_scratch, ptr)
from repro_torch.kernels.paged_decode_attention.ref import (
                                                            paged_decode_attention_ref)

LAUNCHES = 0          # kernel launches since the last reset
DEVICE_KERNELS = 1    # device kernels one launch issues
# the device kernel, by parts of its mangled name (decode_common.cuh's
# template over this source of K/V rows)
SYMBOLS = (("19decode_split_kernelI", "7PagedKV"),)


def paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """q: (b, nq, hd); k_pool, v_pool: (P, page, nkv, hd) in q's dtype
    or both float8_e4m3fn (an fp8 pool, read as it is); block_tbl:
    (b, max_pages) int32; lengths: (b,) int32 valid tokens including the
    current one. Returns (b, nq, hd) in q's dtype."""
    global LAUNCHES
    if B.is_plain(q, k_pool, v_pool, block_tbl, lengths):
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tbl,
                                          lengths, window=window)
    B.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    B.require(q.dim() == 3 and k_pool.dim() == 4
              and k_pool.shape == v_pool.shape,
              f"paged_decode_attention: bad shapes q{tuple(q.shape)} "
              f"pool{tuple(k_pool.shape)}")
    b, nq, hd = q.shape
    n_pages, page, nkv, _ = k_pool.shape
    B.require(k_pool.shape[3] == hd,
              f"paged_decode_attention: q{tuple(q.shape)} vs "
              f"pool{tuple(k_pool.shape)}")
    check_group("paged_decode_attention", nq, nkv)
    B.require(block_tbl.dim() == 2 and block_tbl.shape[0] == b
              and tuple(lengths.shape) == (b,),
              "paged_decode_attention: block_tbl (b, max_pages), lengths (b,)")
    B.require(n_pages * page * nkv < 2 ** 31,
              "paged_decode_attention: the kernel indexes K/V rows in int32")
    code = B.check_operands("paged_decode_attention", (q, k_pool, v_pool),
                            (block_tbl, lengths), hd, fp8_kv=True)
    win = B.check_window(window)
    max_pages = block_tbl.shape[1]
    out = torch.empty_like(q)
    split_len, nsplit, part, cnt = launch_scratch(
        b, nkv, nq // nkv, hd, max_pages * page, q.device)
    B.launch("paged_decode_attention", q.device, q.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(), block_tbl.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), ptr(part), ptr(cnt), b, page,
             max_pages, nq, nkv, hd, code, B.kv_code(k_pool), win,
             split_len, nsplit, hd ** -0.5)
    LAUNCHES += 1
    return out
