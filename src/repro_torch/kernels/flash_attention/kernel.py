"""Wrapper of the hand-written flash-attention kernel
(``csrc/flash_attention.cu``), the Hopper replacement of the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention``.

CPU tensors take the plain PyTorch version (``ref.attention_ref``);
CUDA tensors launch the kernel or raise. By dtype: bf16 runs the
tensor-core kernel (wgmma on tiles that TMA loads, which needs q, k and v
16-byte aligned), f32 the CUDA-core kernel, whose full-f32 products the
f32 parity checks need. Head dims 32, 64 and 128 in both.

Where autograd needs the gradient (grad enabled and q, k or v requiring
it), a CUDA call goes through ``_Flash``, a ``torch.autograd.Function``
whose forward also keeps each row's log-sum-exp and whose backward is the
hand-written gradient kernel (``backward.flash_attention_bwd``); any
other call launches the forward alone and asks for no log-sum-exp, as
serving does. Positions get no gradient.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)

LAUNCHES = 0          # kernel launches since the last reset
DEVICE_KERNELS = 1    # device kernels one launch issues
# the device kernels, by parts of their mangled names: bf16, f32
SYMBOLS = (("15flash_tc_kernelI",), ("16flash_fwd_kernelI",))


def flash_attention(q, k, v, q_pos, kv_pos, *, window: Optional[int] = None,
                    causal: bool = True) -> torch.Tensor:
    """q: (b, s, nq, hd); k, v: (b, S, nkv, hd); q_pos (b, s), kv_pos
    (b, S) int32 with -1 for padding. Returns (b, s, nq, hd) in q's dtype."""
    if B.is_plain(q, k, v, q_pos, kv_pos):
        return attention_ref(q, k, v, q_pos, kv_pos, window=window,
                             causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, q_pos, kv_pos, window, causal)
    return _forward(q, k, v, q_pos, kv_pos, window, causal)[0]


def flash_attention_with_lse(q, k, v, q_pos, kv_pos, *,
                             window: Optional[int] = None, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention``'s output and each query row's log-sum-exp of its
    scaled, masked scores, (b, nq, s) f32 in natural units, +inf for a row
    without a valid key: what the gradient kernel reads. No autograd."""
    if B.is_plain(q, k, v, q_pos, kv_pos):
        return (attention_ref(q, k, v, q_pos, kv_pos, window=window,
                              causal=causal),
                attention_lse_ref(q, k, q_pos, kv_pos, window=window,
                                  causal=causal))
    return _forward(q, k, v, q_pos, kv_pos, window, causal, with_lse=True)


class _Flash(torch.autograd.Function):
    """The forward kernel, keeping each row's log-sum-exp, differentiated
    by the gradient kernel."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, window, causal):
        out, lse = _forward(q, k, v, q_pos, kv_pos, window, causal,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:
            dout = dout.clone()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, q_pos,
                                         kv_pos, window=ctx.window,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None, None, None


def _forward(q, k, v, q_pos, kv_pos, window, causal, with_lse=False):
    """Checks and launches the forward kernel on CUDA tensors: (out, lse),
    lse None unless ``with_lse``."""
    global LAUNCHES
    B.require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
              f"flash_attention: bad shapes q{tuple(q.shape)} "
              f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, s, nq, hd = q.shape
    _, S, nkv, _ = k.shape
    B.require(k.shape[0] == b and k.shape[3] == hd and nkv > 0
              and nq % nkv == 0,
              f"flash_attention: q{tuple(q.shape)} vs k{tuple(k.shape)}")
    B.require(tuple(q_pos.shape) == (b, s) and tuple(kv_pos.shape) == (b, S),
              "flash_attention: positions must be (b, s) and (b, S)")
    code = B.check_operands("flash_attention", (q, k, v), (q_pos, kv_pos), hd)
    win = B.check_window(window)
    out = torch.empty_like(q)
    lse = (torch.empty((b, nq, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return out, lse
    if lse is not None and S == 0:     # no key: every row's lse is +inf
        lse.fill_(float("inf"))
    B.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
             out.data_ptr(), None if lse is None else lse.data_ptr(), b, s,
             S, nq, nkv, hd, code, int(causal), win, hd ** -0.5)
    LAUNCHES += 1
    return out, lse
