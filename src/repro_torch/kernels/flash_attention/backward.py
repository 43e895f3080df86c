"""Wrapper of the hand-written flash-attention gradient
(``csrc/flash_attention_bwd.cu``): dq, dk and dv of the forward kernel's
function. It replaces no TPU kernel: the reference trains through its
jnp attention (its Pallas kernel has no gradient), and this is the
card's counterpart of the gradient JAX derives from ``attention_ref``.

It reads the forward's output and each row's log-sum-exp, which the
forward keeps when autograd asks for it (``kernel._Flash``). CPU tensors
take the plain version of its arithmetic (``ref.attention_bwd_from_lse``);
CUDA tensors launch the kernel or raise. A call issues three device
kernels and counts as one launch: D = dO·O a row, then dk and dv a key
tile, then dq a query tile (bf16 on the tensor cores, f32 on the CUDA
cores).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.flash_attention.ref import attention_bwd_from_lse

LAUNCHES = 0          # calls that launched the kernel since the last reset
DEVICE_KERNELS = 3    # device kernels one call issues
# the device kernels, by parts of their mangled names: D of each row (both
# dtypes), then dk/dv and dq in bf16, then dk/dv and dq in f32
SYMBOLS = (("21flash_bwd_prep_kernelI",), ("21flash_bwd_dkdv_kernelI",),
           ("19flash_bwd_dq_kernelI",), ("19flash_bwd_kv_kernelI",),
           ("18flash_bwd_q_kernelI",))


def flash_attention_bwd(q, k, v, out, dout, lse, q_pos, kv_pos, *,
                        window: Optional[int] = None, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention(q, k, v, q_pos, kv_pos)`` whose
    output was ``out`` and log-sum-exp ``lse`` (b, nq, s) f32 (the
    forward's, ``kernel.flash_attention_with_lse``), for the output
    gradient ``dout``: (dq, dk, dv) in the dtypes of q, k and v. Shapes as
    the forward's; ``out`` and ``dout`` are (b, s, nq, hd) in q's dtype."""
    global LAUNCHES
    if B.is_plain(q, k, v, out, dout, lse, q_pos, kv_pos):
        return attention_bwd_from_lse(q, k, v, out, dout, lse, q_pos, kv_pos,
                                      window=window, causal=causal)
    B.require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
              f"flash_attention_bwd: bad shapes q{tuple(q.shape)} "
              f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, s, nq, hd = q.shape
    _, S, nkv, _ = k.shape
    B.require(k.shape[0] == b and k.shape[3] == hd and nkv > 0
              and nq % nkv == 0,
              f"flash_attention_bwd: q{tuple(q.shape)} vs k{tuple(k.shape)}")
    B.require(out.shape == q.shape and dout.shape == q.shape,
              f"flash_attention_bwd: out{tuple(out.shape)} and "
              f"dout{tuple(dout.shape)} must be q's shape {tuple(q.shape)}")
    B.require(tuple(q_pos.shape) == (b, s) and tuple(kv_pos.shape) == (b, S),
              "flash_attention_bwd: positions must be (b, s) and (b, S)")
    B.require(tuple(lse.shape) == (b, nq, s) and lse.dtype == torch.float32
              and lse.is_contiguous(),
              f"flash_attention_bwd: lse must be contiguous (b, nq, s) = "
              f"{(b, nq, s)} float32, got {tuple(lse.shape)} {lse.dtype}")
    code = B.check_operands("flash_attention_bwd", (q, k, v, out, dout),
                            (q_pos, kv_pos), hd)
    win = B.check_window(window)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:     # no pair at all: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, nq, s), dtype=torch.float32, device=q.device)
    B.launch("flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
             q_pos.data_ptr(), kv_pos.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, s, S, nq,
             nkv, hd, code, int(causal), win, hd ** -0.5)
    LAUNCHES += 1
    return dq, dk, dv
