"""Wrapper of the hand-written SSD scan kernel (``csrc/ssd_scan.cu``),
the Hopper replacement of the TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_scan``.

CPU tensors take the plain PyTorch version (``ref.ssd_chunked``); CUDA
tensors launch the kernel or raise. A call issues three device kernels
(each chunk's own state, the recurrence over chunks, then y), and counts
as one launch. The kernel cuts the sequence into its own state chunks of
``plan(...).chunk`` tokens, so ``chunk`` only has to divide the
sequence, as the reference kernel requires.

Where autograd needs the gradient (grad enabled and an operand requiring
it), a CUDA call goes through ``_SSD``, a ``torch.autograd.Function``
whose forward keeps the launch's states before each chunk (the ``prev``
scratch, which any launch fills) and whose backward is the hand-written
gradient kernel (``backward.ssd_scan_bwd``); any other call launches the
forward alone, as serving does, and drops that scratch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.ssd_scan.backward import ssd_scan_bwd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_chunked_states

LAUNCHES = 0          # calls that launched the kernel since the last reset
DEVICE_KERNELS = 3    # device kernels one call issues
# the device kernels, by parts of their mangled names
SYMBOLS = (("12state_kernelI",), ("12recur_kernelI",), ("10out_kernelI",))
TILE = 64             # tokens per score tile of the kernel
# tokens per state chunk, at most (a multiple of TILE): the output pass
# holds a whole chunk's key tiles in shared memory, four in bf16, one in f32
STATE_CHUNK = {torch.bfloat16: 256, torch.float32: 64}
STATE_DIMS = (16, 64, 128)
HEAD_DIM_STEP = 16    # P must be a multiple of this


class Plan(NamedTuple):
    """What one launch needs, from shapes alone: the state chunk length,
    the number of chunks, and the scratch: the chunks' own states and
    their log-decays in f32, and the state before each chunk in x's
    dtype (bf16 keeps a high and a low part, so twice the elements)."""
    chunk: int
    n_chunks: int
    state_floats: int
    decay_floats: int
    prev_elems: int


def plan(bsz: int, S: int, H: int, P: int, N: int,
         dtype: torch.dtype) -> Plan:
    """State chunks of STATE_CHUNK[dtype] tokens, or of the sequence
    rounded up to whole tiles when it is shorter; the last chunk may be
    ragged."""
    chunk = min(STATE_CHUNK[dtype], TILE * -(-S // TILE))
    n = -(-S // chunk)
    states = bsz * n * H * P * N
    planes = 2 if dtype == torch.bfloat16 else 1
    return Plan(chunk, n, states, bsz * n * H, planes * states)


def smem_bytes(N: int, P: int, dtype: torch.dtype) -> Tuple[int, int]:
    """Dynamic shared memory (bytes) of the chunk-state and the output
    kernels at state dim N, head dim P and ``dtype`` (builds the library)."""
    fn = B.symbol("ssd_scan", "ssd_scan_smem", [ctypes.c_int] * 4,
                  ctypes.c_long)
    code = B.DTYPE_CODES[dtype]
    return fn(N, P, code, 1), fn(N, P, code, 3)


def ssd_scan(x, dt, a, b, c, d_skip, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dt (B, S, H) f32; a, d_skip (H,) f32; b, c
    (B, S, N) in x's dtype; init_state (B, H, P, N) f32 or None. Returns
    y (B, S, H, P) in x's dtype and the final state (B, H, P, N) f32.
    On the card: P a multiple of 16, N in STATE_DIMS, x, b, c and
    init_state 16-byte aligned."""
    operands = [x, dt, a, b, c, d_skip]
    if init_state is not None:
        operands.append(init_state)
    if B.is_plain(*operands):
        return ssd_chunked(x, dt, a, b, c, d_skip, chunk, init_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _SSD.apply(x, dt, a, b, c, d_skip, chunk, init_state)
    return _forward(x, dt, a, b, c, d_skip, chunk, init_state)[:2]


def ssd_scan_with_states(x, dt, a, b, c, d_skip, chunk: int,
                         init_state: Optional[torch.Tensor] = None):
    """``ssd_scan``'s y and final state, and the states before each chunk
    that the gradient reads (``backward.ssd_scan_bwd``'s ``prev``): on the
    CPU the plain version's (B, S / chunk, H, P, N) f32, on the card the
    kernel's own scratch (planes, B, n, H, P, N) in x's dtype. No
    autograd."""
    operands = [x, dt, a, b, c, d_skip]
    if init_state is not None:
        operands.append(init_state)
    if B.is_plain(*operands):
        return ssd_chunked_states(x, dt, a, b, c, d_skip, chunk, init_state)
    return _forward(x, dt, a, b, c, d_skip, chunk, init_state)


class _SSD(torch.autograd.Function):
    """The forward kernel, keeping the states before each chunk,
    differentiated by the gradient kernel."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip, chunk, init_state):
        y, fin, prev = ssd_scan_with_states(x, dt, a, b, c, d_skip, chunk,
                                            init_state)
        ctx.save_for_backward(x, dt, a, b, c, d_skip, init_state, prev)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b, c, d_skip, init_state, prev = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dy.data_ptr() % 16:
            dy = dy.clone()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
            if dfinal.data_ptr() % 16:
                dfinal = dfinal.clone()
        dx, ddt, da, db, dc, dd, dinit = ssd_scan_bwd(
            x, dt, a, b, c, d_skip, ctx.chunk, init_state, prev, dy, dfinal)
        return (dx, ddt, da, db, dc, dd, None,
                dinit if init_state is not None else None)


def check_operands(name: str, x, dt, a, b, c, d_skip, chunk: int,
                   init_state) -> Plan:
    """The kernels' checks of the forward's operands on the card; returns
    the launch's plan."""
    B.require(x.dim() == 4, f"{name}: x must be (B, S, H, P), got "
              f"{tuple(x.shape)}")
    bsz, S, H, P = x.shape
    N = b.shape[-1]
    B.require(tuple(dt.shape) == (bsz, S, H)
              and tuple(a.shape) == (H,) and tuple(d_skip.shape) == (H,)
              and tuple(b.shape) == (bsz, S, N) and c.shape == b.shape,
              f"{name}: shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
              f"a{tuple(a.shape)} b{tuple(b.shape)} c{tuple(c.shape)} "
              f"d{tuple(d_skip.shape)} do not agree")
    B.require(init_state is None
              or tuple(init_state.shape) == (bsz, H, P, N),
              f"{name}: init_state must be {(bsz, H, P, N)}")
    B.require(bsz > 0 and H > 0, f"{name}: empty x {tuple(x.shape)}")
    B.require(chunk > 0 and S > 0 and S % chunk == 0,
              f"{name}: seq {S} % chunk {chunk} != 0")
    B.require(x.dtype in B.DTYPE_CODES,
              f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    B.require(b.dtype == x.dtype and c.dtype == x.dtype,
              f"{name}: b/c dtypes {b.dtype}/{c.dtype} differ from x's "
              f"{x.dtype}")
    extra = [] if init_state is None else [init_state]
    B.require(all(t.dtype == torch.float32 for t in [dt, a, d_skip, *extra]),
              f"{name}: dt, a, d_skip and init_state must be float32")
    B.require(all(t.is_contiguous()
                  for t in [x, dt, a, b, c, d_skip, *extra]),
              f"{name}: every operand must be contiguous")
    B.require(all(t.data_ptr() % 16 == 0 for t in (x, b, c, *extra)),
              f"{name}: x, b, c and init_state must be 16-byte aligned")
    B.require(P % HEAD_DIM_STEP == 0,
              f"{name}: head_dim {P} not a multiple of {HEAD_DIM_STEP}")
    B.require(N in STATE_DIMS, f"{name}: state_dim {N} not in {STATE_DIMS}")
    return plan(bsz, S, H, P, N, x.dtype)


def _forward(x, dt, a, b, c, d_skip, chunk, init_state):
    """Checks and launches the forward kernel on CUDA tensors: y, the
    final state and the states before each chunk (the launch's ``prev``
    scratch, (planes, B, n, H, P, N) in x's dtype)."""
    global LAUNCHES
    pl = check_operands("ssd_scan", x, dt, a, b, c, d_skip, chunk,
                        init_state)
    bsz, S, H, P = x.shape
    N = b.shape[-1]
    y = torch.empty_like(x)
    fin = torch.empty((bsz, H, P, N), dtype=torch.float32, device=x.device)
    scratch = torch.empty(pl.state_floats + pl.decay_floats,
                          dtype=torch.float32, device=x.device)
    planes = pl.prev_elems // pl.state_floats
    prev = torch.empty((planes, bsz, pl.n_chunks, H, P, N), dtype=x.dtype,
                       device=x.device)
    B.launch("ssd_scan", x.device, x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
             init_state.data_ptr() if init_state is not None else None,
             y.data_ptr(), fin.data_ptr(), scratch.data_ptr(),
             scratch[pl.state_floats:].data_ptr(), prev.data_ptr(),
             bsz, S, H, P, N, pl.chunk, B.DTYPE_CODES[x.dtype])
    LAUNCHES += 1
    return y, fin, prev
