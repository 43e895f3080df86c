"""Wrapper of the hand-written SSD scan gradient (``csrc/ssd_scan_bwd.cu``):
dx, ddt, da, db, dc, dd_skip and the initial state's gradient of the
forward kernel's function. It replaces no TPU kernel: the reference
trains through its jnp ``ssd_chunked`` (its Pallas ``ssd_scan`` has no
gradient), and this is the card's counterpart of the gradient JAX derives
from it.

It reads the forward's states before each of its chunks, which the
forward keeps when autograd asks for them (``kernel._SSD``). CPU tensors
take the plain version of its arithmetic (``ref.ssd_chunked_bwd``); CUDA
tensors launch the kernel or raise. A call issues six device kernels and
counts as one launch: the prefix sums and each chunk's own state
gradient, the reverse recurrence over the chunks, the pair pass (dx, the
sums of the pair weights, the heads' sum of M), dC and dB, dl and ddt,
then da and dd_skip. Its scratch is sized from the shapes alone
(``workspace``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd

LAUNCHES = 0          # calls that launched the kernel since the last reset
DEVICE_KERNELS = 6    # device kernels one call issues
# the device kernels, by parts of their mangled names
SYMBOLS = (("17ssd_dstate_kernelI",), ("17ssd_drecur_kernelI",),
           ("16ssd_dpair_kernelI",), ("15ssd_dcdb_kernelI",),
           ("18ssd_dfinish_kernelI",), ("15ssd_dsum_kernelI",))
TILE = 64             # tokens a tile of the kernel
MAX_BLOCK_ROWS = 65535   # batch x chunks: a grid dimension of the kernel
HEAD_GROUP = 8        # heads a pair block walks
COL_BLOCK = 64        # columns of the state dim a dC or dB block computes
RECUR_ELEMS = 1024    # (p, n) elements a recurrence block carries


class Workspace(NamedTuple):
    """The launch's scratch, in elements, from shapes alone: ``tiles``
    64-token tiles a chunk of ``n_chunks``, ``groups`` of HEAD_GROUP heads,
    ``col_blocks`` of the state dim, ``recur_blocks`` a head's state.
    f64: the prefix sums of dt·a (``cum``), the recurrence blocks' parts of
    <G, S> (``gspart``), dcum's column part, the key tiles' parts of its
    row sums, their sums of u and dy·x, dC's off-diagonal parts, each
    (row, chunk, head)'s part of da. f32: each chunk's own state gradient,
    its decay and the head groups' sums of M a tile pair. In x's dtype:
    G after each chunk (bf16 as a high and a low plane)."""
    chunk: int
    n_chunks: int
    tiles: int
    groups: int
    col_blocks: int
    recur_blocks: int
    cum: int
    gspart: int
    colp: int
    rowp: int
    upart: int
    ddpart: int
    offp: int
    dapart: int
    dstates: int
    dec: int
    mpart: int
    gstates: int


def workspace(bsz: int, S: int, H: int, P: int, N: int,
              dtype: torch.dtype) -> Workspace:
    """The scratch of one launch at the forward's state chunks
    (``kernel.plan``)."""
    from repro_torch.kernels.ssd_scan import kernel as fwd
    pl = fwd.plan(bsz, S, H, P, N, dtype)
    L, n = pl.chunk, pl.n_chunks
    rows = bsz * n * H                       # (row, chunk, head) triples
    tiles = L // TILE
    groups = -(-H // HEAD_GROUP)
    cols = N // min(N, COL_BLOCK)
    recur = -(-(P * N) // RECUR_ELEMS)
    return Workspace(
        chunk=L, n_chunks=n, tiles=tiles, groups=groups, col_blocks=cols,
        recur_blocks=recur, cum=rows * L, gspart=rows * recur,
        colp=rows * L, rowp=rows * tiles * L, upart=rows * tiles,
        ddpart=rows * tiles, offp=rows * cols * L, dapart=rows,
        dstates=pl.state_floats, dec=rows,
        mpart=groups * bsz * n * tiles * (tiles + 1) // 2 * TILE * TILE,
        gstates=pl.prev_elems)


def _carve(buf: torch.Tensor, sizes):
    """Consecutive views of ``buf`` of ``sizes`` elements, each starting
    on a 16-byte boundary."""
    per16 = 16 // buf.element_size()
    views, at = [], 0
    for n in sizes:
        views.append(buf[at:at + n])
        at += -(-n // per16) * per16
    return views


def _total16(sizes, element_size: int) -> int:
    per16 = 16 // element_size
    return sum(-(-n // per16) * per16 for n in sizes)


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
    ws = workspace(bsz, S, H, P, N, x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, db, dc = (torch.empty_like(t) for t in (x, b, c))
    ddt = torch.empty((bsz, S, H), **f32)
    da = torch.empty((H,), **f32)
    dd = torch.empty((H,), **f32)
    dinit = torch.empty((bsz, H, P, N), **f32)
    n64 = (ws.cum, ws.gspart, ws.colp, ws.rowp, ws.upart, ws.ddpart,
           ws.offp, ws.dapart)
    n32 = (ws.mpart, ws.dstates, ws.dec)
    s64 = _carve(torch.empty(_total16(n64, 8), dtype=torch.float64,
                             device=x.device), n64)
    s32 = _carve(torch.empty(_total16(n32, 4), **f32), n32)
    gst = torch.empty(ws.gstates, dtype=x.dtype, device=x.device)
    cum, gspart, colp, rowp, upart, ddpart, offp, dapart = s64
    mpart, dstates, dec = s32
    B.launch("ssd_scan_bwd", x.device, x.data_ptr(), dt.data_ptr(),
             a.data_ptr(), b.data_ptr(), c.data_ptr(), d_skip.data_ptr(),
             prev.data_ptr(), dy.data_ptr(),
             dfinal.data_ptr() if dfinal is not None else None,
             dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
             dc.data_ptr(), dd.data_ptr(), dinit.data_ptr(),
             cum.data_ptr(), dstates.data_ptr(), dec.data_ptr(),
             gst.data_ptr(), gspart.data_ptr(), mpart.data_ptr(),
             colp.data_ptr(), rowp.data_ptr(), upart.data_ptr(),
             ddpart.data_ptr(), offp.data_ptr(), dapart.data_ptr(),
             bsz, S, H, P, N, ws.chunk, B.DTYPE_CODES[x.dtype])
    LAUNCHES += 1
    return dx, ddt, da, db, dc, dd, dinit
