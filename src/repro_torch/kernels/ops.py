"""Kernel dispatch used by the model layers.

Keeps the routing of ``repro/kernels/ops.py``: a single-token causal
query goes to the decode kernel, any other query to the flash kernel,
decode against a paged pool to the paged kernel, and the SSD prefill
scan to the ssd_scan kernel. Each wrapper runs its CUDA kernel on CUDA
tensors and its plain PyTorch version on CPU tensors (and on ``meta``
tensors, where the dry-run computes shapes only); there is no other
switch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels._build import FP8
from repro_torch.kernels.decode_attention import kernel as _decode
from repro_torch.kernels.flash_attention import backward as _flash_bwd
from repro_torch.kernels.flash_attention import kernel as _flash
from repro_torch.kernels.paged_decode_attention import kernel as _paged
from repro_torch.kernels.ssd_scan import backward as _ssd_bwd
from repro_torch.kernels.ssd_scan import kernel as _ssd

_WRAPPERS = {"flash_attention": _flash,
             "flash_attention_bwd": _flash_bwd,
             "decode_attention": _decode,
             "paged_decode_attention": _paged, "ssd_scan": _ssd,
             "ssd_scan_bwd": _ssd_bwd}


def attention(q, k, v, q_pos, kv_pos, *, window: Optional[int] = None,
              causal: bool = True) -> torch.Tensor:
    """q: (b, s, nq, hd); k, v: (b, S, nkv, hd). See flash_attention/ref.py.

    K/V in float8_e4m3fn (an fp8 KV cache) are read as they are by the
    decode kernel only; flash never receives fp8, as in the reference,
    whose callers widen a gathered fp8 pool first."""
    if q.shape[1] == 1 and causal:
        out = _decode.decode_attention(q[:, 0], k, v, q_pos[:, 0].contiguous(),
                                       kv_pos, window=window)
        return out[:, None]
    if FP8 in (k.dtype, v.dtype):
        raise ValueError("attention: fp8 K/V are read only by the decode "
                         "kernel (one causal query token); widen them to "
                         f"q's dtype first, got q{tuple(q.shape)}, "
                         f"causal={causal}")
    return _flash.flash_attention(q, k, v, q_pos, kv_pos, window=window,
                                  causal=causal)


def attention_with_lse(q, k, v, q_pos, kv_pos, *,
                       window: Optional[int] = None):
    """Causal attention (any number of queries, flash) and each query
    row's log-sum-exp (b, nq, s) f32, +inf for a row without a valid key:
    a decode step over a cache cut over its sequence combines the ranks'
    partial results by it (``layers._decode_seq_cut``)."""
    return _flash.flash_attention_with_lse(q, k, v, q_pos, kv_pos,
                                           window=window)


def paged_attention(q, k_pool, v_pool, block_tbl, lengths, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a paged KV pool.

    q: (b, nq, hd); k_pool, v_pool: (P, page, nkv, hd);
    block_tbl: (b, max_pages) int32; lengths: (b,) valid tokens
    (including the current one). See paged_decode_attention/ref.py.
    """
    return _paged.paged_decode_attention(q, k_pool, v_pool, block_tbl,
                                         lengths, window=window)


def ssd(x, dt, a, b, c, d_skip, chunk: int, init_state=None):
    """Chunked SSD scan. See ssd_scan/ref.py for shapes."""
    return _ssd.ssd_scan(x, dt, a, b, c, d_skip, chunk, init_state)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {name: mod.LAUNCHES for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.LAUNCHES = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (launches per wrapper) to the launch counts. A CUDA
    graph replay launches the kernels its capture recorded without
    calling their wrappers, so the graph runner adds them here."""
    for name, n in counts.items():
        _WRAPPERS[name].LAUNCHES += n


def symbols() -> Dict[str, tuple]:
    """Each wrapper's ``SYMBOLS``: tuples of parts of a mangled name, all
    of which one of its device kernels' names holds."""
    return {name: mod.SYMBOLS for name, mod in _WRAPPERS.items()}


def device_kernels() -> Dict[str, int]:
    """Device kernels one launch of each wrapper issues."""
    return {name: mod.DEVICE_KERNELS for name, mod in _WRAPPERS.items()}


def wrapper_of(symbol: str) -> Optional[str]:
    """The wrapper whose device kernel ``symbol`` (a mangled name, as the
    CUDA driver gives it) is, or None for any other kernel."""
    for name, mod in _WRAPPERS.items():
        if any(all(part in symbol for part in parts)
               for parts in mod.SYMBOLS):
            return name
    return None
