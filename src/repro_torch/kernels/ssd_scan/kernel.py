"""Wrapper of the hand-written SSD scan kernel (``csrc/ssd_scan.cu``),
the Hopper replacement of the TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_scan``.

CPU tensors take the plain PyTorch version (``ref.ssd_chunked``); CUDA
tensors launch the kernel or raise. The kernel walks the sequence in its
own sub-chunks of ``SUB`` tokens, so ``chunk`` only has to divide the
sequence, as the reference kernel requires.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

LAUNCHES = 0          # kernel launches since the last reset
SUB = 64              # tokens per sub-chunk of the kernel
P_BLOCK = 16          # state rows (of head_dim) per block
STATE_DIMS = (16, 64, 128)


def ssd_scan(x, dt, a, b, c, d_skip, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dt (B, S, H) f32; a, d_skip (H,) f32; b, c
    (B, S, N) in x's dtype; init_state (B, H, P, N) f32 or None. Returns
    y (B, S, H, P) in x's dtype and the final state (B, H, P, N) f32."""
    global LAUNCHES
    operands = [x, dt, a, b, c, d_skip]
    if init_state is not None:
        operands.append(init_state)
    if B.is_plain(*operands):
        return ssd_chunked(x, dt, a, b, c, d_skip, chunk, init_state)
    B.require(x.dim() == 4, f"ssd_scan: x must be (B, S, H, P), got "
              f"{tuple(x.shape)}")
    bsz, S, H, P = x.shape
    N = b.shape[-1]
    B.require(tuple(dt.shape) == (bsz, S, H)
              and tuple(a.shape) == (H,) and tuple(d_skip.shape) == (H,)
              and tuple(b.shape) == (bsz, S, N) and c.shape == b.shape,
              f"ssd_scan: shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
              f"a{tuple(a.shape)} b{tuple(b.shape)} c{tuple(c.shape)} "
              f"d{tuple(d_skip.shape)} do not agree")
    B.require(init_state is None
              or tuple(init_state.shape) == (bsz, H, P, N),
              f"ssd_scan: init_state must be {(bsz, H, P, N)}")
    B.require(bsz > 0 and H > 0, f"ssd_scan: empty x {tuple(x.shape)}")
    B.require(chunk > 0 and S > 0 and S % chunk == 0,
              f"ssd_scan: seq {S} % chunk {chunk} != 0")
    B.require(x.dtype in B.DTYPE_CODES,
              f"ssd_scan: dtype {x.dtype} not supported (float32, bfloat16)")
    B.require(b.dtype == x.dtype and c.dtype == x.dtype,
              f"ssd_scan: b/c dtypes {b.dtype}/{c.dtype} differ from x's "
              f"{x.dtype}")
    B.require(all(t.dtype == torch.float32
                  for t in [dt, a, d_skip, *operands[6:]]),
              "ssd_scan: dt, a, d_skip and init_state must be float32")
    B.require(all(t.is_contiguous() for t in operands),
              "ssd_scan: every operand must be contiguous")
    B.require(P % P_BLOCK == 0,
              f"ssd_scan: head_dim {P} not a multiple of {P_BLOCK}")
    B.require(N in STATE_DIMS, f"ssd_scan: state_dim {N} not in {STATE_DIMS}")
    y = torch.empty_like(x)
    fin = torch.empty((bsz, H, P, N), dtype=torch.float32, device=x.device)
    cb = torch.empty((bsz, -(-S // SUB), SUB, SUB), dtype=torch.float32,
                     device=x.device)
    B.launch("ssd_scan", x.device, x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
             init_state.data_ptr() if init_state is not None else None,
             y.data_ptr(), fin.data_ptr(), cb.data_ptr(),
             bsz, S, H, P, N, B.DTYPE_CODES[x.dtype])
    LAUNCHES += 1
    return y, fin
