"""Wrapper of the hand-written dense decode-attention kernel
(``csrc/decode_attention.cu``), the Hopper replacement of the TPU kernel
``repro/kernels/decode_attention/kernel.py:decode_attention``.

CPU tensors take the plain PyTorch version (``ref.decode_attention_ref``);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

LAUNCHES = 0          # kernel launches since the last reset
DEVICE_KERNELS = 1    # device kernels one launch issues
# the device kernel, by parts of its mangled name (decode_common.cuh's
# template over this source of K/V rows)
SYMBOLS = (("19decode_split_kernelI", "7DenseKV"),)
MAX_SPLITS = 16       # splits a row, which the last block to finish merges
# q heads per kv head the kernel is built for; a larger group runs in parts
# of the widest, one block row of the grid a part
GROUPS = (1, 2, 4, 8, 16)
MAX_GROUP = GROUPS[-1]

COUNTERS = 1 << 16     # merge counters a stream holds: b * nkv * parts

# per (device, stream): int32 counters the last block of each (row, kv
# head) uses to find itself; they start at 0 and the kernel resets them,
# so they outlive every launch. They are made once, at full size, while
# the stream is not capturing: a CUDA graph captured over them keeps
# their address, so they must neither be born in the graph's memory pool
# nor be replaced while the graph lives.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def group_width(g: int) -> int:
    """The kernel's group width for g q heads per kv head: the smallest
    of GROUPS that holds g (the extra heads idle), else MAX_GROUP."""
    return next((w for w in GROUPS if w >= g), MAX_GROUP)


def group_parts(g: int) -> int:
    """Parts of MAX_GROUP q heads that a group of g runs in: one for
    g <= MAX_GROUP. Each part is a block of its own and reads the kv
    head's K/V once."""
    return -(-g // MAX_GROUP)


def split_plan(b: int, nkv: int, n_tokens: int, n_sm: int) -> Tuple[int, int]:
    """(split_len, nsplit) of a launch over rows of ``n_tokens`` slots (the
    cache's S, or max_pages * page), from shapes alone: the wrapper never
    reads lengths back. Enough splits for two blocks an SM where the b * nkv
    rows leave room, at most MAX_SPLITS, each a whole number of the
    kernel's 64-token tiles."""
    n_tokens = max(n_tokens, 1)
    want = max(1, min(MAX_SPLITS, -(-2 * n_sm // (b * nkv)),
                      -(-n_tokens // 64)))
    split_len = 64 * -(-n_tokens // (64 * want))
    return split_len, -(-n_tokens // split_len)


def partial_floats(b: int, nkv: int, g: int, hd: int, nsplit: int) -> int:
    """f32 scratch of the split partials: acc (b, nkv * parts, nsplit, G,
    hd) and m, l (b, nkv * parts, nsplit, 2, G), G = group_width(g),
    parts = group_parts(g); none for one split."""
    if nsplit == 1:
        return 0
    return b * nkv * group_parts(g) * nsplit * group_width(g) * (hd + 2)


def launch_scratch(b: int, nkv: int, g: int, hd: int, n_tokens: int,
                   device: torch.device):
    """(split_len, nsplit, partials, counters) of one launch on
    ``device``: the partials are one ``torch.empty`` (inside a CUDA graph
    capture it comes from the graph's pool), the counters are kept per
    stream; None, None for a launch of one split. A group in parts
    counts as that many kv heads."""
    rows = nkv * group_parts(g)
    split_len, nsplit = split_plan(
        b, rows, n_tokens,
        torch.cuda.get_device_properties(device).multi_processor_count)
    n = partial_floats(b, nkv, g, hd, nsplit)
    if not n:
        return split_len, nsplit, None, None
    B.require(b * rows <= COUNTERS,
              f"decode attention: {b} rows x {rows} kv heads (x parts) "
              f"exceed the {COUNTERS} merge counters of a stream")
    part = torch.empty(n, dtype=torch.float32, device=device)
    return split_len, nsplit, part, merge_counters(device)


def merge_counters(device: torch.device) -> torch.Tensor:
    """The merge counters of ``device``'s current stream, made at the
    first launch on that stream. Raises when that launch is being
    captured into a CUDA graph: run it once on the stream first (the
    graph runner's warm-up does)."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    cnt = _counters.get(key)
    if cnt is None:
        B.require(not torch.cuda.is_current_stream_capturing(),
                  "decode attention: the merge counters of a stream must "
                  "exist before a CUDA graph is captured on it; launch "
                  "once on that stream first")
        cnt = _counters[key] = torch.zeros(COUNTERS, dtype=torch.int32,
                                           device=device)
    return cnt


def ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def check_group(name: str, nq: int, nkv: int) -> None:
    B.require(nkv > 0 and nq % nkv == 0,
              f"{name}: {nq} q heads over {nkv} kv heads (the q heads must "
              f"be a whole multiple of the kv heads)")


def decode_attention(q, k, v, q_pos, kv_pos, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (b, nq, hd); k, v: (b, S, nkv, hd) in q's dtype or both
    float8_e4m3fn (an fp8 cache, read as it is); q_pos: (b,); kv_pos:
    (b, S) int32, -1 = empty slot. Returns (b, nq, hd) in q's dtype."""
    global LAUNCHES
    if B.is_plain(q, k, v, q_pos, kv_pos):
        return decode_attention_ref(q, k, v, q_pos, kv_pos, window=window)
    B.refuse_grad("decode_attention", q, k, v)
    B.require(q.dim() == 3 and k.dim() == 4 and k.shape == v.shape,
              f"decode_attention: bad shapes q{tuple(q.shape)} "
              f"k{tuple(k.shape)}")
    b, nq, hd = q.shape
    _, S, nkv, _ = k.shape
    B.require(k.shape[0] == b and k.shape[3] == hd,
              f"decode_attention: q{tuple(q.shape)} vs k{tuple(k.shape)}")
    check_group("decode_attention", nq, nkv)
    B.require(tuple(q_pos.shape) == (b,) and tuple(kv_pos.shape) == (b, S),
              "decode_attention: positions must be (b,) and (b, S)")
    B.require(b * S * nkv < 2 ** 31,
              "decode_attention: the kernel indexes K/V rows in int32")
    code = B.check_operands("decode_attention", (q, k, v), (q_pos, kv_pos),
                            hd, fp8_kv=True)
    win = B.check_window(window)
    out = torch.empty_like(q)
    split_len, nsplit, part, cnt = launch_scratch(b, nkv, nq // nkv, hd, S,
                                                  q.device)
    B.launch("decode_attention", q.device, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
             out.data_ptr(), ptr(part), ptr(cnt), b, S, nq, nkv, hd, code,
             B.kv_code(k), win, split_len, nsplit, hd ** -0.5)
    LAUNCHES += 1
    return out
