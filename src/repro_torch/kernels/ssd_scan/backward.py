"""Wrapper of the hand-written SSD scan gradient (``csrc/ssd_scan_bwd.cu``):
dx, ddt, da, db, dc, dd_skip and the initial state's gradient of the
forward kernel's function. It replaces no TPU kernel: the reference
trains through its jnp ``ssd_chunked`` (its Pallas ``ssd_scan`` has no
gradient), and this is the card's counterpart of the gradient JAX derives
from it.

It reads the forward's states before each of its chunks, which the
forward keeps when autograd asks for them (``kernel._SSD``). CPU tensors
take the plain version of its arithmetic (``ref.ssd_chunked_bwd``); CUDA
tensors launch the kernel or raise. A call issues seven device kernels
and counts as one launch: each chunk's own state gradient, the reverse
recurrence over the chunks, the pair weights' row sums, dx and the column
sums, dC, dB, then ddt, da and dd_skip.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd

LAUNCHES = 0          # calls that launched the kernel since the last reset
DEVICE_KERNELS = 7    # device kernels one call issues
# the device kernels, by parts of their mangled names
SYMBOLS = (("17ssd_dstate_kernelI",), ("17ssd_drecur_kernelI",),
           ("15ssd_drow_kernelI",), ("15ssd_dcol_kernelI",),
           ("13ssd_dc_kernelI",), ("13ssd_db_kernelI",),
           ("18ssd_dfinish_kernelI",))
TILE = 64             # tokens a tile of the kernel
MAX_BLOCK_ROWS = 65535   # batch x chunks: a grid dimension of the kernel


def ssd_scan_bwd(x, dt, a, b, c, d_skip, chunk: int,
                 init_state: Optional[torch.Tensor], prev: torch.Tensor, dy,
                 dfinal: Optional[torch.Tensor]):
    """The gradient of ``ssd_scan(x, dt, a, b, c, d_skip, chunk,
    init_state)`` for the gradients ``dy`` of y and ``dfinal`` of the
    final state (None: zeros): (dx, ddt, da, db, dc, dd_skip, dinit), dx,
    db and dc in x's dtype, the rest f32. ``prev``: the states before each
    chunk that the forward kept (``kernel.ssd_scan_with_states``): on the
    CPU (B, S / chunk, H, P, N) f32 at ``chunk``; on the card the forward
    kernel's own (planes, B, n, H, P, N) in x's dtype at its chunk
    ``kernel.plan(...).chunk``, bf16 as a high and a low plane."""
    global LAUNCHES
    from repro_torch.kernels.ssd_scan import kernel as fwd
    operands = [x, dt, a, b, c, d_skip, prev, dy]
    extra = [t for t in (init_state, dfinal) if t is not None]
    if B.is_plain(*operands, *extra):
        return ssd_chunked_bwd(x, dt, a, b, c, d_skip, chunk, init_state,
                               prev, dy, dfinal)
    pl = fwd.check_operands("ssd_scan_bwd", x, dt, a, b, c, d_skip, chunk,
                            init_state)
    bsz, S, H, P = x.shape
    N = b.shape[-1]
    planes = 2 if x.dtype == torch.bfloat16 else 1
    B.require(tuple(prev.shape) == (planes, bsz, pl.n_chunks, H, P, N)
              and prev.dtype == x.dtype and prev.is_contiguous(),
              f"ssd_scan_bwd: prev must be the forward's states "
              f"{(planes, bsz, pl.n_chunks, H, P, N)} {x.dtype}, got "
              f"{tuple(prev.shape)} {prev.dtype}")
    B.require(dy.shape == x.shape and dy.dtype == x.dtype
              and dy.is_contiguous() and dy.data_ptr() % 16 == 0,
              f"ssd_scan_bwd: dy must be x's shape and dtype, contiguous and "
              f"16-byte aligned, got {tuple(dy.shape)} {dy.dtype}")
    B.require(dfinal is None or (
        tuple(dfinal.shape) == (bsz, H, P, N)
        and dfinal.dtype == torch.float32 and dfinal.is_contiguous()
        and dfinal.data_ptr() % 16 == 0),
        f"ssd_scan_bwd: dfinal must be contiguous, 16-byte aligned "
        f"{(bsz, H, P, N)} float32")
    B.require(bsz * pl.n_chunks <= MAX_BLOCK_ROWS,
              f"ssd_scan_bwd: batch x chunks {bsz * pl.n_chunks} above "
              f"{MAX_BLOCK_ROWS}")
    f32 = dict(dtype=torch.float32, device=x.device)
    f64 = dict(dtype=torch.float64, device=x.device)
    dx, db, dc = (torch.empty_like(t) for t in (x, b, c))
    ddt = torch.empty((bsz, S, H), **f32)
    da = torch.empty((H,), **f32)
    dd = torch.empty((H,), **f32)
    dinit = torch.empty((bsz, H, P, N), **f32)
    tiles = pl.chunk // TILE
    dstates = torch.empty(pl.state_floats, **f32)
    gnext = torch.empty(pl.state_floats, **f32)
    dec = torch.empty(pl.decay_floats, **f32)
    gs = torch.empty(pl.decay_floats, **f64)
    dcum = torch.empty(2 * pl.decay_floats * pl.chunk, **f64)
    upart = torch.empty(pl.decay_floats * tiles, **f64)
    ddpart = torch.empty(pl.decay_floats * tiles, **f64)
    B.launch("ssd_scan_bwd", x.device, x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
             prev.data_ptr(), dy.data_ptr(),
             dfinal.data_ptr() if dfinal is not None else None,
             dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
             dc.data_ptr(), dd.data_ptr(), dinit.data_ptr(),
             dstates.data_ptr(), gnext.data_ptr(), dec.data_ptr(),
             dcum.data_ptr(), upart.data_ptr(), ddpart.data_ptr(),
             gs.data_ptr(), bsz, S, H, P, N, pl.chunk,
             B.DTYPE_CODES[x.dtype])
    LAUNCHES += 1
    return dx, ddt, da, db, dc, dd, dinit
