"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports neither ``jax`` nor ``repro``, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each test skips without a CUDA device (the kernels have no CPU mode).
Small shapes with the cases of ``tests/test_torch_kernels.py``: padded
queries, ragged caches, windows, GQA groups 1-32 (16 is glm4-9b's, 32
runs in two parts of 16), head dims 32-128; for
flash also lengths that are no multiple of its 128-row tiles, a gathered
prefix whose -1 gap covers whole key tiles, a query tile that is all
padding, a window inside one tile and cross-attention with S < s; for
the SSD scan the cases of ``tests/test_torch_ssm.py`` plus a padded tail
(on one row of two), sequences over several of the kernel's state chunks
that are no multiple of its 64-token tile, state chunks of 64 and 128,
every state dim at every head-dim slice, strong decay, an initial state
and the serving shape. The other serving shapes are checked by
``chip_smoke.py``. The CUDA-graph steps (``serving/graphs.py``) on small
engines: every replay equals the eager step on a copy of the caches
bitwise, a held dense-prefill payload survives later replays, replays
count their launches, a replay over reallocated state raises, no garbage
collection runs inside a capture, and the decode kernels' merge counters
exist before the first capture. The
decode pair also reads K/V stored in float8_e4m3fn (an fp8 cache or
pool) under f32 and bf16 queries, at the same cases; its wrappers refuse
any other mixed pairing, and flash refuses fp8. The MoE feed-forward
(``models/moe.py``, plain PyTorch) on the card equals its CPU run where
routing agrees, captures into a graph, and a mixtral engine's steps
replay bitwise with the window binding. Flash at whisper-base's two
non-causal forms (the encoder's 1500 frames, one decode query a slot
against 1500 cross-attention keys) equals its plain version, and a
whisper engine's steps replay bitwise over the cross cache. Flash's
gradient kernel (``flash_attention_bwd``) equals the autograd gradient
of the plain version over the mask forms in both dtypes (also at lengths
no multiple of its 64-row tiles, a single query tile, a -1 gap between
valid keys and a window across tile edges), bitwise deterministic (hd 64
and 128); the forward's log-sum-exp equals the plain version's; autograd
reaches the gradient through ``flash_attention``; serving with autograd
on launches what it launches without, and asks the forward for no
log-sum-exp; a reduced smollm
train step on the card equals the CPU's (remat bitwise equal). The SSD
scan's gradient kernel (``ssd_scan_bwd``) equals the plain version of its
arithmetic, bitwise deterministic, and autograd reaches it through
``ssd_scan``; a reduced mamba2 train step on the card equals the CPU's.
"""
import dataclasses
import functools
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402
from repro_torch.kernels.flash_attention import backward as FB  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention, flash_attention_with_lse)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref)
from repro_torch.kernels.paged_decode_attention.kernel import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.paged_decode_attention.ref import (  # noqa: E402
    paged_decode_attention_ref)
from repro_torch.kernels.ssd_scan import backward as SB  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SSD  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked,  # noqa: E402
                                              ssd_chunked_bwd)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import frontend as FE  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.layers import to_kv  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.transformer import cache_tensors, clone_caches  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.graphs import GraphStep, held_to_eager  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.steps import make_encode_fn  # noqa: E402

pytestmark = pytest.mark.cuda

# bf16: 8-bit mantissa on the outputs; f32: summation order only
TOL = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
       torch.float32: dict(atol=1e-4, rtol=1e-4)}
DTYPES = [torch.float32, torch.bfloat16]
F8 = torch.float8_e4m3fn


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("case", [
    # b, s, S, nq, nkv, hd, window, causal[, extra]
    (2, 64, 64, 4, 2, 64, None, True),
    (1, 100, 100, 8, 8, 32, None, True),
    (2, 128, 128, 4, 1, 64, 32, True),
    (1, 50, 70, 4, 2, 64, None, False),
    (1, 33, 33, 2, 2, 128, 16, True),
    # s and S no multiple of 64 or 128, at each head dim and GQA group 1/4/8
    (1, 200, 200, 4, 4, 32, None, True),
    (2, 300, 300, 8, 2, 64, None, True),
    (1, 333, 333, 16, 2, 128, None, True),
    # suffix prefill: a gathered prefix of 450 slots, 100 valid, then the
    # 100 new keys; the -1 gap covers key tiles 1 and 2 whole
    (2, 100, 550, 8, 2, 128, None, True, dict(pfx=(450, 100))),
    # query rows 150.. are padding: the 128-query tile 256..299 is all
    # padding
    (1, 300, 300, 4, 2, 64, None, True, dict(pad_from=150)),
    # a window smaller than one 128-key tile
    (1, 400, 400, 8, 2, 128, 50, True),
    # cross-attention with fewer keys than queries
    (1, 300, 77, 8, 2, 64, None, False),
    (2, 129, 65, 4, 4, 128, None, False),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(dev, case, dtype):
    b, s, S, nq, nkv, hd, win, causal = case[:8]
    extra = case[8] if len(case) > 8 else {}
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (b, s, nq, hd), dtype, dev)
    k = _randn(gen, (b, S, nkv, hd), dtype, dev)
    v = _randn(gen, (b, S, nkv, hd), dtype, dev)
    qi = torch.arange(s, dtype=torch.int32, device=dev)
    pad_from = extra.get("pad_from", s - 3)
    if "pfx" in extra:         # positions continue after the valid prefix
        span, valid = extra["pfx"]
        qp = torch.where(qi < pad_from, qi + valid, torch.full_like(qi, -1))
        t = torch.arange(span, dtype=torch.int32, device=dev)
        kp = torch.cat([torch.where(t < valid, t, torch.full_like(t, -1)),
                        qi + valid]).repeat(b, 1)
        qp = qp.repeat(b, 1)
    else:
        qp = torch.where(qi < pad_from, qi, torch.full_like(qi, -1)).repeat(
            b, 1)
        kp = torch.arange(S, dtype=torch.int32, device=dev).repeat(b, 1)
    ops.reset_launch_counts()
    out = flash_attention(q, k, v, qp, kp, window=win, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(
        out, attention_ref(q, k, v, qp, kp, window=win, causal=causal),
        **TOL[dtype])
    assert torch.all(out[:, pad_from:] == 0)   # fully masked query rows


@pytest.mark.parametrize("case", [
    (2, 64, 4, 2, 64, None),
    (1, 100, 8, 1, 32, None),
    (2, 48, 4, 4, 64, 16),
    (3, 37, 6, 2, 128, None),
    (2, 300, 24, 3, 128, None),                 # g = 8, several splits
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(dev, case, dtype):
    b, S, nq, nkv, hd, win = case
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _randn(gen, (b, nq, hd), dtype, dev)
    k = _randn(gen, (b, S, nkv, hd), dtype, dev)
    v = _randn(gen, (b, S, nkv, hd), dtype, dev)
    t = torch.arange(S, dtype=torch.int32, device=dev).repeat(b, 1)
    kp = torch.where(t < S - 5, t, torch.full_like(t, -1))
    qp = torch.full((b,), S - 6, dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        decode_attention(q, k, v, qp, kp, window=win),
        decode_attention_ref(q, k, v, qp, kp, window=win), **TOL[dtype])


@pytest.mark.parametrize("case", [
    # b, page, max_pages, nq, nkv, hd, window
    (2, 16, 4, 4, 2, 64, None),
    (3, 8, 6, 8, 1, 32, None),
    (2, 16, 8, 4, 4, 64, 20),
    (1, 32, 3, 6, 2, 128, None),
    (2, 8, 5, 8, 2, 64, 12),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_matches_plain(dev, case, dtype):
    b, page, max_pages, nq, nkv, hd, win = case
    gen = torch.Generator(device=dev).manual_seed(2)
    n_pages = b * max_pages + 1
    kpool = _randn(gen, (n_pages, page, nkv, hd), dtype, dev)
    vpool = _randn(gen, (n_pages, page, nkv, hd), dtype, dev)
    q = _randn(gen, (b, nq, hd), dtype, dev)
    cap = max_pages * page
    lens = [cap, 1, page][:b] if b > 1 else [cap - 1]
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tbl = torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
    off = 0
    for i, n in enumerate(lens):
        used = -(-n // page)
        tbl[i, :used] = perm[off:off + used].to(torch.int32)
        off += used
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        paged_decode_attention(q, kpool, vpool, tbl, ln, window=win),
        paged_decode_attention_ref(q, kpool, vpool, tbl, ln, window=win),
        **TOL[dtype])


@pytest.mark.parametrize("case", [
    # B, S, H, P, N, chunk, init, padded tail[, options]
    (2, 64, 4, 32, 16, 16, False, 0),
    (1, 128, 2, 64, 128, 32, True, 0),
    (2, 96, 3, 32, 64, 32, True, 0),          # 96 = 64 + a 32-token rest
    (1, 200, 2, 16, 64, 40, True, 30),        # dt = 0 over the last 30
    (1, 256, 4, 64, 128, 256, True, 0),       # the model's chunk
    # several of the kernel's 256-token state chunks, the last tile ragged
    (1, 600, 2, 32, 64, 40, True, 0),
    (2, 520, 3, 64, 128, 40, False, 0),
    # shorter state chunks than the wrapper plans for bf16: 64 and 128
    (1, 600, 2, 32, 64, 40, True, 0, dict(state_chunk=128)),
    (2, 200, 2, 16, 16, 40, True, 30, dict(state_chunk=64)),
    # B = 2 with the dt = 0 tail on the second row only, across chunks
    (2, 700, 2, 32, 64, 70, True, 300, dict(pad_rows=[1])),
    # every state dim at every head-dim slice; P 48 and 128 take several
    *[(1, 160, 2, P, N, 32, False, 0) for N in (16, 64, 128)
      for P in (16, 32, 64)],
    (1, 130, 2, 48, 64, 26, True, 0),
    (1, 192, 1, 128, 16, 64, True, 0),
    # strong decay: a ≈ -8, dt ≈ 5, exp(cum) underflows to 0
    (1, 300, 2, 32, 64, 100, True, 0, dict(strong=True)),
    # the serving shape (mamba2-370m's padded prefill)
    (1, 2048, 32, 64, 128, 256, False, 0),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_kernel_matches_plain(dev, monkeypatch, case, dtype):
    B, S, H, P, N, chunk, init, n_pad = case[:8]
    opt = case[8] if len(case) > 8 else {}
    if "state_chunk" in opt:
        monkeypatch.setitem(SSD.STATE_CHUNK, dtype, min(
            opt["state_chunk"], SSD.STATE_CHUNK[dtype]))
    gen = torch.Generator(device=dev).manual_seed(3)
    f32 = torch.float32
    x = _randn(gen, (B, S, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(_randn(gen, (B, S, H), f32, dev))
    if opt.get("strong"):
        dt = 5 + dt.clamp(max=1)
    if n_pad:
        dt[opt.get("pad_rows", slice(None)), -n_pad:] = 0
    a = -torch.exp(0.3 * _randn(gen, (H,), f32, dev))
    if opt.get("strong"):
        a = 8 * a / a.abs().max()
    b = (0.3 * _randn(gen, (B, S, N), f32, dev)).to(dtype)
    c = (0.3 * _randn(gen, (B, S, N), f32, dev)).to(dtype)
    d = torch.ones((H,), device=dev)
    s0 = 0.1 * _randn(gen, (B, H, P, N), f32, dev) if init else None
    ops.reset_launch_counts()
    y, fin = ssd_scan(x, dt, a, b, c, d, chunk, s0)
    assert ops.launch_counts()["ssd_scan"] == 1
    yr, fr = ssd_chunked(x, dt, a, b, c, d, chunk, s0)
    assert y.dtype == dtype and fin.dtype == f32
    assert torch.isfinite(y.float()).all() and torch.isfinite(fin).all()
    torch.testing.assert_close(y, yr, **TOL[dtype])
    # the state is f32 on both sides from the same (rounded) inputs
    torch.testing.assert_close(fin, fr, **TOL[f32])


@pytest.mark.parametrize("case", [
    # B, S, H, P, N, chunk, init and a final-state gradient[, options]
    (2, 64, 4, 32, 16, 16, False),
    (1, 320, 3, 64, 128, 64, True),           # a ragged last bf16 chunk
    (2, 200, 2, 16, 64, 40, True, dict(pad=30)),   # dt = 0 over the last 30
    (1, 160, 2, 48, 64, 32, True),            # one slice of 48
    (1, 192, 1, 128, 16, 64, True),           # two head-dim slices
    (1, 600, 2, 32, 64, 40, True, dict(state_chunk=128)),
    (1, 300, 2, 32, 64, 100, True, dict(strong=True)),
    # head counts no head group of the pair pass divides, one of them
    # over fewer tokens than a 64-token tile
    (1, 40, 1, 32, 64, 8, True),
    (2, 320, 3, 64, 128, 64, True),
    (1, 256, 5, 64, 16, 128, False),
    # jamba-v0.1-52b's heads on one card: the heads' sum over 128
    (1, 2048, 128, 64, 128, 256, False),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_gradient_kernel_matches_plain(dev, monkeypatch, case, dtype):
    """ssd_scan_bwd, fed the forward kernel's states, against the plain
    version of its arithmetic (bf16; in f32 against it run in f64, which
    the plain f32 run's own sums would miss at 1e-4), two calls bitwise
    equal; autograd reaches it through ssd_scan, one launch a backward."""
    B, S, H, P, N, chunk, ends = case[:7]
    opt = case[7] if len(case) > 7 else {}
    if "state_chunk" in opt:
        monkeypatch.setitem(SSD.STATE_CHUNK, dtype, min(
            opt["state_chunk"], SSD.STATE_CHUNK[dtype]))
    gen = torch.Generator(device=dev).manual_seed(5)
    f32 = torch.float32
    x = _randn(gen, (B, S, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(_randn(gen, (B, S, H), f32, dev))
    if opt.get("strong"):
        dt = 5 + dt.clamp(max=1)
    if opt.get("pad"):
        dt[:, -opt["pad"]:] = 0
    a = -torch.exp(0.3 * _randn(gen, (H,), f32, dev))
    if opt.get("strong"):
        a = 8 * a / a.abs().max()
    b = (0.3 * _randn(gen, (B, S, N), f32, dev)).to(dtype)
    c = (0.3 * _randn(gen, (B, S, N), f32, dev)).to(dtype)
    d = torch.ones((H,), device=dev)
    s0 = 0.1 * _randn(gen, (B, H, P, N), f32, dev) if ends else None
    dy = _randn(gen, (B, S, H, P), dtype, dev)
    dfin = 0.1 * _randn(gen, (B, H, P, N), f32, dev) if ends else None
    args = (x, dt, a, b, c, d, chunk, s0)
    prev = SSD.ssd_scan_with_states(*args)[2]
    ops.reset_launch_counts()
    got = SB.ssd_scan_bwd(*args, prev, dy, dfin)
    again = SB.ssd_scan_bwd(*args, prev, dy, dfin)
    assert ops.launch_counts()["ssd_scan_bwd"] == 2
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    own = SSD.plan(B, S, H, P, N, dtype).chunk
    plain = [t.double() if dtype == f32 and isinstance(t, torch.Tensor)
             else t for t in (*args, None, dy, dfin)]
    plain[6] = own if S % own == 0 else chunk
    want = ssd_chunked_bwd(*plain)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.double(), w.double(), **TOL[dtype])
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c, d)]
    y, fin = ssd_scan(*leaves, chunk, s0)
    ops.reset_launch_counts()
    grads = torch.autograd.grad((y.float() * dy.float()).sum(), leaves)
    assert ops.launch_counts()["ssd_scan_bwd"] == 1
    direct = SB.ssd_scan_bwd(*args, prev, dy, None)
    for g, w in zip(grads, direct):
        assert torch.equal(g, w)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(dev):
    def args(B=1, S=64, H=2, P=32, N=16, dtype=torch.float32):
        z = torch.zeros
        return [z((B, S, H, P), dtype=dtype, device=dev),
                z((B, S, H), device=dev), z((H,), device=dev),
                z((B, S, N), dtype=dtype, device=dev),
                z((B, S, N), dtype=dtype, device=dev), z((H,), device=dev)]

    with pytest.raises(ValueError, match="state_dim"):
        ssd_scan(*args(N=48), 32)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_scan(*args(P=24), 32)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(*args(), 48)
    with pytest.raises(ValueError, match="empty"):
        ssd_scan(*args(B=0), 32)
    x, dt, a, b, c, d = args(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="differ"):
        ssd_scan(x, dt, a, b.float(), c, d, 32)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(x, dt.bfloat16(), a, b, c, d, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, b, c,
                 d, 32)
    # a contiguous view one element into its storage: the kernel's
    # 16-byte copies need aligned rows
    xa = torch.zeros(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(
        x.shape)
    assert xa.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_scan(xa, dt, a, b, c, d, 32)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 8, 4, 48), device=dev)          # head_dim 48
    pos = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q, pos, pos)
    q = torch.zeros((1, 8, 4, 64), device=dev)
    with pytest.raises(ValueError, match="int32"):
        flash_attention(q, q, q, pos.long(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                        q, q, pos, pos)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, q.cpu(), q, pos, pos)
    # a contiguous view one element into its storage: TMA needs 16 bytes
    qb = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                     device=dev)[1:].view(q.shape)
    assert qb.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(qb, q.bfloat16(), q.bfloat16(), pos, pos)


# -- the split-K decode pair: 64-token tiles, splits merged by the last
# block of a (row, kv head) to finish, group widths 1/2/4/8/16 (a larger
# group in parts of 16)

def _ring_pos(S, cur):
    """kv_pos of a ring buffer of S slots after writing positions 0..cur
    at slot p % S (models/layers.py writes at cur_len % S)."""
    j = torch.arange(S, dtype=torch.int32)
    if cur < S:
        return torch.where(j <= cur, j, torch.full_like(j, -1))
    return cur - (cur - j) % S


def _dense_inputs(dev, dtype, S, nq, nkv, hd, kv_rows, q_pos, seed=5,
                  kv_dtype=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(kv_rows)
    q = _randn(gen, (b, nq, hd), dtype, dev)
    k = to_kv(_randn(gen, (b, S, nkv, hd), dtype, dev), kv_dtype or dtype)
    v = to_kv(_randn(gen, (b, S, nkv, hd), dtype, dev), kv_dtype or dtype)
    kp = torch.stack(kv_rows).to(dev).contiguous()
    qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    return q, k, v, qp, kp


def _prefix_rows(S, lens):
    t = torch.arange(S, dtype=torch.int32)
    return [torch.where(t < n, t, torch.full_like(t, -1)) for n in lens]


def _check_dense(dev, dtype, S, nq, nkv, hd, kv_rows, q_pos, window=None,
                 kv_dtype=None):
    args = _dense_inputs(dev, dtype, S, nq, nkv, hd, kv_rows, q_pos,
                         kv_dtype=kv_dtype)
    ops.reset_launch_counts()
    out = decode_attention(*args, window=window)
    assert ops.launch_counts()["decode_attention"] == 1
    torch.testing.assert_close(out, decode_attention_ref(*args, window=window),
                               **TOL[dtype])
    return out


@pytest.mark.parametrize("case", [
    # lengths no multiple of the 64-token tile or of the split
    dict(S=700, nq=8, nkv=2, hd=128, lens=[700, 333, 65]),
    # one row spanning many splits
    dict(S=2500, nq=4, nkv=1, hd=64, lens=[2500, 2431]),
    # a window that starts inside a tile (keys 924..1023)
    dict(S=1024, nq=4, nkv=2, hd=64, lens=[1024, 700], window=100),
    # wrapped ring buffers: live slots rotated against slot order
    dict(S=300, nq=8, nkv=2, hd=128, cur=[1000, 299, 450]),
    dict(S=600, nq=4, nkv=1, hd=32, cur=[1500, 2000], window=200),
    # glm4-9b's group of 16 (32/2 heads of 128), ragged, windowed, wrapped
    dict(S=700, nq=32, nkv=2, hd=128, lens=[700, 333, 65]),
    dict(S=1024, nq=32, nkv=2, hd=128, lens=[1024, 700], window=100),
    dict(S=300, nq=32, nkv=2, hd=64, cur=[1000, 299, 450]),
    # MQA, a group of 32 in two parts of 16
    dict(S=2500, nq=32, nkv=1, hd=128, lens=[2500, 2431]),
    dict(S=1024, nq=32, nkv=1, hd=64, lens=[1024, 700], window=100),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_split_edges(dev, case, dtype):
    S = case["S"]
    if "cur" in case:
        rows, qp = [_ring_pos(S, c) for c in case["cur"]], case["cur"]
    else:
        rows, qp = _prefix_rows(S, case["lens"]), [n - 1 for n in case["lens"]]
    _check_dense(dev, dtype, S, case["nq"], case["nkv"], case["hd"], rows, qp,
                 case.get("window"))


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_group_widths(dev, dtype, g, hd):
    S, nkv = 600, 2
    _check_dense(dev, dtype, S, g * nkv, nkv, hd,
                 _prefix_rows(S, [600, 257]), [599, 256])


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_splits_longer_than_a_row_table(dev, dtype, window):
    """128 (row, kv head) pairs leave 3 splits of 1216 tokens over S 3500,
    so each split walks two segments of its row table (1024 + 192); one
    ring wraps, and the window starts in a split's second segment."""
    S, b = 3500, 8
    assert DK.split_plan(b, 16, S, 132) == (1216, 3)
    rows = _prefix_rows(S, [3500, 3001, 2300, 1100, 1025, 1024, 64, 1])
    rows[7], qp = _ring_pos(S, 9000), [3499, 3000, 2299, 1099, 1024, 1023,
                                       63, 9000]
    _check_dense(dev, dtype, S, 32, 16, 64, rows, qp, window)


@pytest.mark.parametrize("heads", [(8, 2), (32, 2), (32, 1)])
@pytest.mark.parametrize("S", [100, 600])          # one split, several
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_row_without_keys_is_zero(dev, dtype, S, heads):
    """The TPU kernel's l == 0 -> 1 gives 0 (the plain version does not:
    its softmax over all-masked scores is uniform); also at groups of 16
    and 32 (two parts)."""
    rows = _prefix_rows(S, [0, S - 7, S])
    args = _dense_inputs(dev, dtype, S, *heads, 64, rows, [5, S - 8, -1])
    out = decode_attention(*args)
    assert torch.all(out[0] == 0) and torch.all(out[2] == 0)
    torch.testing.assert_close(out[1], decode_attention_ref(*args)[1],
                               **TOL[dtype])


def _paged_inputs(dev, dtype, page, max_pages, nq, nkv, hd, lens, seed=6,
                  kv_dtype=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lens)
    n_pages = b * max_pages + 1
    kpool = to_kv(_randn(gen, (n_pages, page, nkv, hd), dtype, dev),
                  kv_dtype or dtype)
    vpool = to_kv(_randn(gen, (n_pages, page, nkv, hd), dtype, dev),
                  kv_dtype or dtype)
    q = _randn(gen, (b, nq, hd), dtype, dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tbl = torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
    off = 0
    for i, n in enumerate(lens):               # scattered physical pages
        used = -(-n // page)
        tbl[i, :used] = perm[off:off + used].to(torch.int32)
        off += used
    return q, kpool, vpool, tbl, torch.tensor(lens, dtype=torch.int32,
                                              device=dev)


def _check_paged(dev, dtype, page, max_pages, nq, nkv, hd, lens,
                 window=None, kv_dtype=None):
    args = _paged_inputs(dev, dtype, page, max_pages, nq, nkv, hd, lens,
                         kv_dtype=kv_dtype)
    ops.reset_launch_counts()
    out = paged_decode_attention(*args, window=window)
    assert ops.launch_counts()["paged_decode_attention"] == 1
    torch.testing.assert_close(
        out, paged_decode_attention_ref(*args, window=window), **TOL[dtype])
    return out


@pytest.mark.parametrize("case", [
    # page-multiple lengths, and lengths no multiple of 64 or the split
    dict(page=16, max_pages=40, nq=8, nkv=2, hd=128, lens=[640, 256, 333]),
    # one slot spanning many splits, one of a single token
    dict(page=16, max_pages=160, nq=4, nkv=1, hd=64, lens=[2555, 1]),
    # pages no divisor of the tile; a window starting inside a tile
    dict(page=24, max_pages=50, nq=4, nkv=2, hd=64, lens=[1200, 999],
         window=150),
    dict(page=8, max_pages=100, nq=8, nkv=4, hd=32, lens=[800, 555],
         window=70),
    # glm4-9b's group of 16; MQA's 32 in two parts, windowed
    dict(page=16, max_pages=40, nq=32, nkv=2, hd=128, lens=[640, 256, 333]),
    dict(page=16, max_pages=64, nq=32, nkv=2, hd=64, lens=[1000, 17],
         window=150),
    dict(page=16, max_pages=160, nq=32, nkv=1, hd=128, lens=[2555, 1]),
    dict(page=24, max_pages=50, nq=32, nkv=1, hd=64, lens=[1200, 999],
         window=150),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_split_edges(dev, case, dtype):
    _check_paged(dev, dtype, case["page"], case["max_pages"], case["nq"],
                 case["nkv"], case["hd"], case["lens"], case.get("window"))


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_group_widths(dev, dtype, g, hd):
    _check_paged(dev, dtype, 16, 40, g * 2, 2, hd, [640, 300])


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_splits_longer_than_a_row_table(dev, dtype, window):
    """As the dense case: splits of 1216 tokens over 219 pages of 16, two
    segments of the row table each."""
    _check_paged(dev, dtype, 16, 219, 32, 16, 64,
                 [3504, 3001, 2300, 1100, 1025, 1024, 64, 1], window)


@pytest.mark.parametrize("heads", [(8, 2), (32, 2), (32, 1)])
@pytest.mark.parametrize("max_pages", [4, 40])     # one split, several
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_slot_without_keys_is_zero(dev, dtype, max_pages,
                                                heads):
    lens = [0, max_pages * 16 - 3, 0]
    args = _paged_inputs(dev, dtype, 16, max_pages, *heads, 64, lens)
    out = paged_decode_attention(*args)
    assert torch.all(out[0] == 0) and torch.all(out[2] == 0)
    torch.testing.assert_close(out[1], paged_decode_attention_ref(*args)[1],
                               **TOL[dtype])


def test_decode_merge_counters_reset_between_launches(dev):
    """The last block of each (row, kv head) resets its counter, so
    launch after launch on one stream merges its own splits."""
    S = 1500
    for seed in range(3):
        args = _dense_inputs(dev, torch.float32, S, 8, 2, 64,
                             _prefix_rows(S, [1500, 900]), [1499, 899],
                             seed=seed)
        torch.testing.assert_close(decode_attention(*args),
                                   decode_attention_ref(*args),
                                   **TOL[torch.float32])


def test_decode_wrappers_reject_what_the_kernels_do_not_take(dev):
    q, k, v, qp, kp = _dense_inputs(dev, torch.bfloat16, 64, 4, 2, 64,
                                    _prefix_rows(64, [64]), [63])
    # a contiguous view one element into its storage: 16-byte copies
    kb = torch.zeros(k.numel() + 1, dtype=k.dtype, device=dev)[1:].view(
        k.shape)
    assert kb.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(q, kb, v, qp, kp)
    with pytest.raises(ValueError, match="whole multiple"):
        decode_attention(torch.zeros((1, 5, 64), dtype=q.dtype, device=dev),
                         k, v, qp, kp)
    args = _paged_inputs(dev, torch.bfloat16, 16, 4, 4, 2, 64, [50])
    pool = args[1]
    pb = torch.zeros(pool.numel() + 1, dtype=pool.dtype, device=dev)[1:].view(
        pool.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(args[0], args[1], pb, *args[3:])


# -- the decode pair on fp8 K/V (an fp8 cache or pool, read as it is): the
# cases above with K/V in float8_e4m3fn under f32 and bf16 queries; the
# plain versions widen K/V to q's dtype, so the tolerances are q's

DENSE_CASES = [
    dict(S=64, nq=4, nkv=2, hd=64, lens=[60, 64]),
    dict(S=100, nq=8, nkv=1, hd=32, lens=[95]),
    dict(S=48, nq=4, nkv=4, hd=64, lens=[43, 48], window=16),
    dict(S=37, nq=6, nkv=2, hd=128, lens=[32, 37, 1]),
    dict(S=300, nq=24, nkv=3, hd=128, lens=[300, 295]),     # g = 8
    dict(S=700, nq=8, nkv=2, hd=128, lens=[700, 333, 65]),
    dict(S=2500, nq=4, nkv=1, hd=64, lens=[2500, 2431]),
    dict(S=1024, nq=4, nkv=2, hd=64, lens=[1024, 700], window=100),
    dict(S=300, nq=8, nkv=2, hd=128, cur=[1000, 299, 450]),
    dict(S=600, nq=4, nkv=1, hd=32, cur=[1500, 2000], window=200),
    dict(S=700, nq=32, nkv=2, hd=128, lens=[700, 333, 65]),     # g = 16
    dict(S=1024, nq=32, nkv=2, hd=64, lens=[1024, 700], window=100),
    dict(S=2500, nq=32, nkv=1, hd=128, lens=[2500, 2431]),      # g = 32
]


@pytest.mark.parametrize("case", DENSE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_fp8_matches_plain(dev, case, dtype):
    S = case["S"]
    if "cur" in case:
        rows, qp = [_ring_pos(S, c) for c in case["cur"]], case["cur"]
    else:
        rows, qp = _prefix_rows(S, case["lens"]), [n - 1 for n in case["lens"]]
    _check_dense(dev, dtype, S, case["nq"], case["nkv"], case["hd"], rows, qp,
                 case.get("window"), kv_dtype=F8)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_fp8_group_widths(dev, dtype, g, hd):
    S, nkv = 600, 2
    _check_dense(dev, dtype, S, g * nkv, nkv, hd,
                 _prefix_rows(S, [600, 257]), [599, 256], kv_dtype=F8)


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_fp8_splits_longer_than_a_row_table(dev, dtype,
                                                          window):
    S, b = 3500, 8
    rows = _prefix_rows(S, [3500, 3001, 2300, 1100, 1025, 1024, 64, 1])
    rows[7], qp = _ring_pos(S, 9000), [3499, 3000, 2299, 1099, 1024, 1023,
                                       63, 9000]
    _check_dense(dev, dtype, S, 32, 16, 64, rows, qp, window, kv_dtype=F8)


@pytest.mark.parametrize("heads", [(8, 2), (32, 2), (32, 1)])
@pytest.mark.parametrize("S", [100, 600])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_fp8_row_without_keys_is_zero(dev, dtype, S, heads):
    rows = _prefix_rows(S, [0, S - 7, S])
    args = _dense_inputs(dev, dtype, S, *heads, 64, rows, [5, S - 8, -1],
                         kv_dtype=F8)
    out = decode_attention(*args)
    assert torch.all(out[0] == 0) and torch.all(out[2] == 0)
    torch.testing.assert_close(out[1], decode_attention_ref(*args)[1],
                               **TOL[dtype])


PAGED_CASES = [
    dict(page=16, max_pages=4, nq=4, nkv=2, hd=64, lens=[64, 1]),
    dict(page=8, max_pages=6, nq=8, nkv=1, hd=32, lens=[48, 1, 8]),
    dict(page=16, max_pages=8, nq=4, nkv=4, hd=64, lens=[128, 9], window=20),
    dict(page=32, max_pages=3, nq=6, nkv=2, hd=128, lens=[95]),
    dict(page=16, max_pages=40, nq=8, nkv=2, hd=128, lens=[640, 256, 333]),
    dict(page=16, max_pages=160, nq=4, nkv=1, hd=64, lens=[2555, 1]),
    dict(page=24, max_pages=50, nq=4, nkv=2, hd=64, lens=[1200, 999],
         window=150),
    dict(page=8, max_pages=100, nq=8, nkv=4, hd=32, lens=[800, 555],
         window=70),
    dict(page=16, max_pages=40, nq=32, nkv=2, hd=128, lens=[640, 256, 333]),
    dict(page=16, max_pages=64, nq=32, nkv=2, hd=64, lens=[1000, 17],
         window=150),
    dict(page=16, max_pages=160, nq=32, nkv=1, hd=128, lens=[2555, 1]),
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_fp8_matches_plain(dev, case, dtype):
    _check_paged(dev, dtype, case["page"], case["max_pages"], case["nq"],
                 case["nkv"], case["hd"], case["lens"], case.get("window"),
                 kv_dtype=F8)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_fp8_group_widths(dev, dtype, g, hd):
    _check_paged(dev, dtype, 16, 40, g * 2, 2, hd, [640, 300], kv_dtype=F8)


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_fp8_splits_longer_than_a_row_table(dev, dtype,
                                                         window):
    _check_paged(dev, dtype, 16, 219, 32, 16, 64,
                 [3504, 3001, 2300, 1100, 1025, 1024, 64, 1], window,
                 kv_dtype=F8)


@pytest.mark.parametrize("heads", [(8, 2), (32, 2), (32, 1)])
@pytest.mark.parametrize("max_pages", [4, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_fp8_slot_without_keys_is_zero(dev, dtype, max_pages,
                                                    heads):
    lens = [0, max_pages * 16 - 3, 0]
    args = _paged_inputs(dev, dtype, 16, max_pages, *heads, 64, lens,
                         kv_dtype=F8)
    out = paged_decode_attention(*args)
    assert torch.all(out[0] == 0) and torch.all(out[2] == 0)
    torch.testing.assert_close(out[1], paged_decode_attention_ref(*args)[1],
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_to_kv_on_the_card_equals_the_cpu_cast(dev, dtype):
    """The cast into an fp8 cache gives the same bytes on the card as on
    the CPU (held bitwise to JAX's there): NaN with x's sign past 464 and
    for +-inf, round-to-nearest-even elsewhere, from f32 and from bf16."""
    edges = torch.tensor([0.0, 448.0, 463.9, 464.0, 465.0, 480.0, 1e4,
                          float("inf"), float("nan"), 2.0 ** -9,
                          1.5 * 2.0 ** -9, 0.3, 1.7])
    gen = torch.Generator().manual_seed(5)
    x = torch.cat([edges, -edges, 300 * torch.randn(20_000, generator=gen)])
    x = x.to(dtype)
    got = to_kv(x.to(dev), F8).cpu().view(torch.uint8)
    assert torch.equal(got, to_kv(x, F8).view(torch.uint8))


@pytest.mark.parametrize("S", [64, 1500])          # one split, several
def test_fp8_kernels_read_nan_as_the_plain_versions_do(dev, S):
    """A K value past e4m3's range is stored as NaN (to_kv); the row it
    is a key of gives NaN, in the kernel as in the plain version."""
    args = _dense_inputs(dev, torch.bfloat16, S, 4, 2, 64,
                         _prefix_rows(S, [S, S]), [S - 1, S - 1])
    k = args[1].clone()
    k[0, 10, 1, 5] = 1e4
    k = to_kv(k, F8)
    v = to_kv(args[2], F8)
    out = decode_attention(args[0], k, v, *args[3:])
    ref = decode_attention_ref(args[0], k, v, *args[3:])
    assert torch.isnan(out[0, 2:]).all() and torch.isnan(ref[0, 2:]).all()
    torch.testing.assert_close(out[1], ref[1], **TOL[torch.bfloat16])
    assert not torch.isnan(out[0, :2]).any()


def test_wrappers_refuse_mixed_kv_pairings(dev):
    """K/V in q's dtype or in e4m3 for the decode pair: q f32 with bf16
    K/V (not ported) and K and V of two dtypes raise; flash takes no
    fp8, directly or through ops.attention."""
    q, k, v, qp, kp = _dense_inputs(dev, torch.float32, 64, 4, 2, 64,
                                    _prefix_rows(64, [64]), [63])
    with pytest.raises(ValueError, match="not supported"):
        decode_attention(q, k.bfloat16(), v.bfloat16(), qp, kp)
    with pytest.raises(ValueError, match="not supported"):
        decode_attention(q, to_kv(k, F8), v, qp, kp)
    args = _paged_inputs(dev, torch.float32, 16, 4, 4, 2, 64, [50])
    with pytest.raises(ValueError, match="not supported"):
        paged_decode_attention(args[0], args[1].bfloat16(),
                               args[2].bfloat16(), *args[3:])
    qf = q[:, None].expand(1, 8, 4, 64).contiguous()
    pos = torch.arange(8, dtype=torch.int32, device=dev)[None]
    with pytest.raises(ValueError, match="not supported"):
        flash_attention(qf, to_kv(k, F8), to_kv(v, F8), pos, kp)
    with pytest.raises(ValueError, match="fp8"):
        ops.attention(qf, to_kv(k, F8), to_kv(v, F8), pos, kp)


# -- CUDA-graph steps -----------------------------------------------------

def _graph_engine(dev, kind, dtype, kv_dtype=None):
    """A small engine of two slots on the card: reduced llava (dense, or
    paged on pages of 16 with preemption), mamba2 with the kernel's state
    dim 64, or reduced glm4-9b at its true heads (32/2 of 128, a group of
    16; "glm4" dense, "glm4 paged")."""
    if kind == "mamba2":
        cfg = get_config("mamba2-370m").reduced()
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               state_dim=64))
    elif kind.startswith("glm4"):
        cfg = dataclasses.replace(get_config("glm4-9b").reduced(),
                                  n_heads=32, n_kv_heads=2, head_dim=128)
    else:
        cfg = get_config("llava-next-mistral-7b").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=dtype)
    opts = (dict(paged=True, page_size=16, preemption=True)
            if kind.endswith("paged") else {})
    return Engine(cfg, params, max_batch=2, max_len=64, device=dev,
                  kv_dtype=kv_dtype, **opts)


def _prefill(eng, req):
    if req.mm_payload is None:
        return eng.prefill_request(req)
    feats = FE.stub_embeddings(eng.cfg, req.mm_payload, req.mm_tokens)
    return eng.prefill_request(
        req, mm_feats=make_encode_fn(eng.cfg)(eng.params, feats)[None],
        mm_key=FE.content_hash(req.mm_payload))


def _requests(eng, image):
    """Three requests through two slots: the second ends first and its
    slot takes the third; lengths cross the 16-token pages."""
    n_img = eng.cfg.frontend.tokens_per_item if image else 0
    out = []
    for i, (n, new) in enumerate([(9, 20), (5, 4), (12, 8)]):
        out.append(Request(
            prompt_tokens=[(7 * i + 3 * j + 1) % eng.cfg.vocab
                           for j in range(n)], max_new_tokens=new,
            mm_payload=b"graph-test image" if image and i < 2 else None,
            mm_tokens=n_img if image and i < 2 else 0, mm_pos=2))
    return out


def _serve(eng, reqs, preempt_at=None):
    queue = list(reqs)
    step = 0
    while queue or any(s is not None for s in eng.slots) or eng.preempted:
        while queue and eng.free_slots():
            r = queue.pop(0)
            first, payload = _prefill(eng, r)
            eng.insert(r, payload, first)
        if step == preempt_at:
            eng.preempt_slot(eng.slots.index(reqs[0]))
        eng.decode_step()
        step += 1
        assert step < 200
    assert [len(r.output_tokens) for r in reqs] == [r.max_new_tokens
                                                     for r in reqs]


@pytest.fixture
def replay_checks():
    """Run every graph step also eagerly on a copy of its caches, before
    the real call, and hold the two bitwise (``graphs.held_to_eager``);
    counts the comparisons in which the real call was a replay, per
    step."""
    with held_to_eager() as replays:
        yield replays


@pytest.mark.parametrize("kind,steps", [
    ("dense", {"decode", "dense_prefill"}),
    ("paged", {"decode"}),
    ("mamba2", {"decode", "dense_prefill"}),
    # glm4-9b's group of 16 in the decode graph
    ("glm4", {"decode", "dense_prefill"}),
    ("glm4 paged", {"decode"}),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_replay_equals_eager_bitwise(dev, replay_checks, kind, steps,
                                          dtype):
    """Each captured step (dense, paged and mamba2 decode, glm4-9b's
    dense and paged decode at its group of 16; llava dense prefill with
    an image and without; mamba2 and glm4 prefill) replays to what
    the eager step computes, bitwise, across page boundaries, a released
    and re-inserted slot and, on the paged engine, a swap-out and in."""
    eng = _graph_engine(dev, kind, dtype)
    paged = kind.endswith("paged")
    _serve(eng, _requests(eng, image=kind == "dense"),
           preempt_at=3 if paged else None)
    assert set(replay_checks) == steps and min(replay_checks.values()) >= 1
    assert replay_checks["decode"] >= 15
    if kind.startswith("glm4"):     # the group of 16 inside the graph
        wrapper = "paged_decode_attention" if paged else "decode_attention"
        assert eng.graph_census()["decode"][f"{wrapper} nodes"] == \
            eng.cfg.n_layers
    if paged:
        assert eng.preempt_count == 1 and eng.resume_count == 1
        eng.assert_no_page_leaks()


@pytest.mark.parametrize("kind,steps", [
    ("dense", {"decode", "dense_prefill"}),
    ("paged", {"decode"}),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fp8_graph_replay_equals_eager_bitwise(dev, replay_checks, kind,
                                              steps, dtype):
    """The decode steps and the dense prefill over fp8 caches replay to
    what the eager step computes, bitwise (fp8 caches compared as bytes),
    across page boundaries and a swap-out and in; the decode kernel reads
    the fp8 cache or pool."""
    eng = _graph_engine(dev, kind, dtype, kv_dtype=F8)
    assert all(t.dtype == F8 for e in eng.caches["attn"] for t in e[:2])
    ops.reset_launch_counts()
    _serve(eng, _requests(eng, image=kind == "dense"),
           preempt_at=3 if kind == "paged" else None)
    assert set(replay_checks) == steps and replay_checks["decode"] >= 15
    wrapper = ("paged_decode_attention" if kind == "paged"
               else "decode_attention")
    assert ops.launch_counts()[wrapper] > 0
    assert eng.graph_census()["decode"][f"{wrapper} nodes"] == \
        eng.cfg.n_layers
    if kind == "paged":
        assert eng.preempt_count == 1 and eng.resume_count == 1
        eng.assert_no_page_leaks()


@pytest.mark.parametrize("kind", ["dense", "mamba2"])
def test_held_dense_prefill_payload_survives_replays(dev, kind):
    eng = _graph_engine(dev, kind, torch.bfloat16)
    reqs = _requests(eng, image=False)
    f0, p0 = eng.prefill_request(reqs[0])
    held = clone_caches(p0)
    for r in reqs[1:]:
        eng.prefill_request(r)
    assert eng._prefill.graph.replays == 2
    for a, b in zip(cache_tensors(p0), cache_tensors(held)):
        assert torch.equal(a, b)
    eng.insert(reqs[0], p0, f0)
    while eng.n_active:
        eng.decode_step()
    fresh = _graph_engine(dev, kind, torch.bfloat16)
    alone = _requests(fresh, image=False)[0]
    f, p = fresh.prefill_request(alone)
    fresh.insert(alone, p, f)
    while fresh.n_active:
        fresh.decode_step()
    assert reqs[0].output_tokens == alone.output_tokens


def test_launch_counts_after_replays(dev):
    """N replays count what N eager calls count: one flash launch a layer
    a prefill, one decode launch a layer a step."""
    eng = _graph_engine(dev, "dense", torch.bfloat16)
    reqs = _requests(eng, image=False)
    ops.reset_launch_counts()
    for r in reqs:
        eng.run_request(r)
    torch.cuda.synchronize()
    n_layers = eng.cfg.n_layers
    steps = sum(r.max_new_tokens - 1 for r in reqs)
    census = eng.graph_census()
    assert census["decode"]["replays"] == steps - 1
    assert census["prefill"]["replays"] == len(reqs) - 1
    assert ops.launch_counts() == {
        "flash_attention": n_layers * len(reqs), "flash_attention_bwd": 0,
        "decode_attention": n_layers * steps,
        "paged_decode_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}
    # one graph each; our kernel is one node a layer among many, named
    # in the graph by its device function
    assert census["prefill"]["flash_attention nodes"] == n_layers
    assert census["decode"]["decode_attention nodes"] == n_layers
    for step in ("prefill", "decode"):
        c = census[step]
        assert c["graphs"] == 1 and c["kernel_nodes"] > n_layers
        assert sum(v for k, v in c.items() if k.endswith(" nodes")) \
            == n_layers


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_replay_over_reallocated_state_raises(dev, kind):
    eng = _graph_engine(dev, kind, torch.bfloat16)
    r = _requests(eng, image=False)[0]
    first, payload = eng.prefill_request(r)
    eng.insert(r, payload, first)
    eng.decode_step()                  # capture
    eng.decode_step()                  # replay
    eng.caches["len"] = eng.caches["len"].clone()
    with pytest.raises(RuntimeError, match="reallocated"):
        eng.decode_step()


def test_no_garbage_collection_inside_a_capture(dev):
    """The collector could free a dropped engine's CUDA graph inside a
    capture, which invalidates it: the runner keeps it off there (and
    only there)."""
    seen = []

    def fn(x, y):
        seen.append(gc.isenabled())
        return x * y

    step = GraphStep(fn)
    x = torch.ones(4, device=dev)
    assert gc.isenabled()
    step((x,), torch.full((4,), 2.0, device=dev))      # eager, then capture
    out = step((x,), torch.full((4,), 3.0, device=dev))    # replay
    assert seen == [True, False] and gc.isenabled()
    assert torch.equal(out, torch.full((4,), 3.0, device=dev))


def test_merge_counters_exist_before_the_first_capture(dev):
    """The runner's warm-up launches the decode kernel on its own stream
    before it captures there, so the counters are made outside the
    capture; a capture that would make them raises."""
    args = _dense_inputs(dev, torch.bfloat16, 1500, 8, 2, 64,
                         _prefix_rows(1500, [1500, 900]), [1499, 899])
    assert DK.split_plan(2, 2, 1500, torch.cuda.get_device_properties(
        dev).multi_processor_count)[1] > 1
    step = GraphStep(lambda k, v, qp, kp, q: decode_attention(q, k, v, qp,
                                                              kp))
    first = step(args[1:], args[0])
    key = (dev.index or 0, step._stream.cuda_stream)
    assert key in DK._counters and step.captures == 1
    counters = DK._counters[key]
    again = step(args[1:], args[0])
    assert torch.equal(first, again) and step.replays == 1
    assert DK._counters[key] is counters
    assert not torch.any(counters)
    fresh = torch.cuda.Stream(dev)
    with pytest.raises(ValueError, match="before a CUDA graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            decode_attention(*args)


# -- the MoE feed-forward (models/moe.py) on the card ----------------------

def _moe_inputs(dev, dtype):
    """Reduced mixtral's first MoE layer at capacity factor 1.25 in
    ``dtype``, on the CPU and on the card, and two rows of 24 tokens whose
    first 10 are one embedding (the dummies of a suffix window): they
    fill an expert first, so the rows drop selections."""
    cfg = get_config("mixtral-8x7b").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                         device=dev, dtype=dtype)
    p = {k: v[0] for k, v in params["blocks"][0]["moe"].items()}
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((2, 24, cfg.d_model), generator=gen, device=dev)
    x[:, :10] = torch.randn((cfg.d_model,), generator=gen, device=dev)
    x = x.to(dtype)
    return cfg, ({k: v.cpu() for k, v in p.items()}, x.cpu()), (p, x)


def _routing(cfg, p, x):
    """(top-k experts, kept mask in token order, the smallest gap between
    neighbouring probabilities of each token's top k + 1 experts)."""
    h = MOE.rms_norm(x, p["norm"], cfg.norm_eps)
    probs, _, eidx = MOE.route(p, h, cfg)
    sort_idx, _, pos, _, _ = MOE.dispatch(eidx, cfg.moe.n_experts)
    keep = torch.zeros_like(pos, dtype=torch.bool).scatter_(
        1, sort_idx, pos < MOE.capacity(cfg, x.shape[1]))
    top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
    margin = (top[..., :-1] - top[..., 1:]).min(-1).values
    return eidx.cpu(), keep.reshape(eidx.shape).cpu(), margin.cpu()


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_block_on_the_card_matches_cpu(dev, dtype):
    """moe_block on the card against its CPU run in the same dtype: the
    same experts except at a near-tie of the router's probabilities (1e-5
    in f32; 1e-2 in bf16, whose normed input may round the other way), the
    same dropped selections unless such a flip moved them, and the output
    and aux within TOL at every token whose routing agrees."""
    cfg, (pc, xc), (pg, xg) = _moe_inputs(dev, dtype)
    out_c, aux_c = MOE.moe_block(pc, xc, cfg)
    out_g, aux_g = MOE.moe_block(pg, xg, cfg)
    e_c, k_c, margin = _routing(cfg, pc, xc)
    e_g, k_g, _ = _routing(cfg, pg, xg)
    assert not k_c.all()                           # the case drops
    tie = 1e-5 if dtype == torch.float32 else 1e-2
    e_flip = (e_c != e_g).any(-1)
    k_flip = (k_c != k_g).any(-1)
    assert bool((margin[e_flip] < tie).all()), margin[e_flip]
    assert bool(e_flip.any()) or not bool(k_flip.any())
    agree = ~(e_flip | k_flip)
    torch.testing.assert_close(out_g.cpu()[agree], out_c[agree],
                               **TOL[dtype])
    assert aux_g.dtype == torch.float32
    if not e_flip.any():
        torch.testing.assert_close(aux_g.cpu(), aux_c, **TOL[torch.float32])


def test_moe_block_replays_as_a_graph(dev):
    """moe_block syncs nothing with the host: it captures into a CUDA
    graph, and the replay on new input equals the eager block, bitwise."""
    cfg, _, (p, x) = _moe_inputs(dev, torch.bfloat16)
    step = GraphStep(lambda params, xx: MOE.moe_block(params, xx, cfg))
    step((p,), x)                                   # eager, then capture
    x2 = torch.flip(x, dims=[1]).contiguous()
    out, aux = step((p,), x2)                       # replay
    assert step.captures == 1 and step.replays == 1
    want, want_aux = MOE.moe_block(p, x2, cfg)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)


def _moe_engine(dev, kind, dtype):
    """Reduced mixtral on the card with a 16-token window, so that
    ``_requests`` decodes past it: dense, or paged on pages of 16 with
    preemption."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              sliding_window=16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=dtype)
    opts = (dict(paged=True, page_size=16, preemption=True)
            if kind == "paged" else {})
    return Engine(cfg, params, max_batch=2, max_len=64, device=dev, **opts)


@pytest.mark.parametrize("kind,steps", [
    ("dense", {"decode", "dense_prefill"}),
    ("paged", {"decode"}),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_graph_replay_equals_eager_bitwise(dev, replay_checks, kind,
                                              steps, dtype):
    """A mixtral engine's captured steps replay to what the eager step
    computes, bitwise, with the window binding; the graphs hold the
    wrappers' kernels as a dense model's do (one decode or flash node a
    layer, nothing else of ours)."""
    eng = _moe_engine(dev, kind, dtype)
    _serve(eng, _requests(eng, image=False),
           preempt_at=3 if kind == "paged" else None)
    assert set(replay_checks) == steps and replay_checks["decode"] >= 15
    census = eng.graph_census()
    wrapper = ("paged_decode_attention" if kind == "paged"
               else "decode_attention")
    n = eng.cfg.n_layers
    ours = {k: v for k, v in census["decode"].items() if k.endswith(" nodes")}
    assert ours == {f"{wrapper} nodes": n}
    if kind == "dense":
        ours = {k: v for k, v in census["prefill"].items()
                if k.endswith(" nodes")}
        assert ours == {"flash_attention nodes": n}
    else:
        assert eng.preempt_count == 1 and eng.resume_count == 1
        eng.assert_no_page_leaks()


# ---------------------------------------------------------------------------
# the encoder-decoder (whisper-base): flash in its non-causal forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    # b, s, S: the encoder's self-attention over 1500 frames; one decode
    # token a slot against 1500 cross-attention keys (slots 2, 3: a
    # request's keys end early, and an empty slot with no key at all)
    (1, 1500, 1500), (4, 1, 1500)], ids=["encoder", "cross-decode"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_at_whisper_shapes(dev, shape, dtype):
    b, s, S = shape
    nq = nkv = 8
    hd = 64
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (b, s, nq, hd), dtype, dev)
    k = _randn(gen, (b, S, nkv, hd), dtype, dev)
    v = _randn(gen, (b, S, nkv, hd), dtype, dev)
    qp = (torch.arange(s, dtype=torch.int32, device=dev)
          + torch.arange(b, dtype=torch.int32, device=dev)[:, None] * 7
          ).contiguous()
    kp = torch.arange(S, dtype=torch.int32, device=dev).repeat(b, 1)
    if b == 4:
        kp[2, 1000:] = -1
        kp[3] = -1
    ops.reset_launch_counts()
    out = flash_attention(q, k, v, qp, kp, causal=False)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(
        out, attention_ref(q, k, v, qp, kp, causal=False), **TOL[dtype])
    if b == 4:
        assert torch.all(out[3] == 0)          # a slot without keys


def _whisper_engine(dev, kind, dtype):
    cfg = get_config("whisper-base").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=dtype)
    opts = (dict(paged=True, page_size=16, preemption=True)
            if kind == "paged" else {})
    return Engine(cfg, params, max_batch=2, max_len=64, device=dev, **opts)


@pytest.mark.parametrize("kind,steps", [
    ("dense", {"decode", "dense_prefill"}),
    ("paged", {"decode"}),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_whisper_graph_replay_equals_eager_bitwise(dev, replay_checks, kind,
                                                  steps, dtype):
    """A whisper engine's captured steps replay to what the eager step
    computes, bitwise: the decode step reads each slot's cross-KV, which
    inserts (and, on the paged engine, a swap-in) write in place, and the
    dense prefill runs the encoder inside its graph. The decode graph
    holds one self-attention decode node and one cross-attention flash
    node a layer; the dense prefill one flash node a decoder layer for
    each attention and one an encoder layer."""
    eng = _whisper_engine(dev, kind, dtype)
    reqs = [Request(prompt_tokens=[(7 * i + 3 * j + 1) % eng.cfg.vocab
                                   for j in range(n)], max_new_tokens=new,
                    mm_payload=b"audio-%d" % i, mm_tokens=0)
            for i, (n, new) in enumerate([(9, 20), (5, 4), (12, 8)])]
    queue = list(reqs)
    step = 0
    while queue or any(s is not None for s in eng.slots) or eng.preempted:
        while queue and eng.free_slots():
            r = queue.pop(0)
            frames = FE.stub_embeddings(eng.cfg, r.mm_payload)[None]
            first, payload = eng.prefill_request(r, None, frames)
            eng.insert(r, payload, first)
        if kind == "paged" and step == 3:
            eng.preempt_slot(eng.slots.index(reqs[0]))
        eng.decode_step()
        step += 1
        assert step < 200
    assert [len(r.output_tokens) for r in reqs] == [20, 4, 8]
    assert set(replay_checks) == steps and replay_checks["decode"] >= 15
    census = eng.graph_census()
    wrapper = ("paged_decode_attention" if kind == "paged"
               else "decode_attention")
    n, n_enc = eng.cfg.n_layers, eng.cfg.encoder.n_layers
    ours = {k: v for k, v in census["decode"].items() if k.endswith(" nodes")}
    assert ours == {f"{wrapper} nodes": n, "flash_attention nodes": n}
    if kind == "dense":
        ours = {k: v for k, v in census["prefill"].items()
                if k.endswith(" nodes")}
        assert ours == {"flash_attention nodes": 2 * n + n_enc}
    else:
        assert eng.preempt_count == 1 and eng.resume_count == 1
        eng.assert_no_page_leaks()


# ---------------------------------------------------------------------------
# flash attention's gradient (csrc/flash_attention_bwd.cu) and training
# ---------------------------------------------------------------------------

def _bwd_case(dev, dtype, b, s, S, nq, nkv, hd, q_pad=None, k_pad=None,
              pfx=None, causal=True, seed=0):
    """q, k, v, dout and positions: queries at the end of the keys'
    span when causal (a suffix over S - s earlier keys), query rows from
    ``q_pad`` and key slots from ``k_pad`` padding (-1). ``pfx = (span,
    valid)``: a gathered prefix, S = span + s keys of which the first
    ``valid`` and the s new ones are valid, a run of -1 between them, and
    the queries' positions continuing after the valid prefix."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = _randn(gen, (b, s, nq, hd), dtype, dev)
    k = _randn(gen, (b, S, nkv, hd), dtype, dev)
    v = _randn(gen, (b, S, nkv, hd), dtype, dev)
    dout = _randn(gen, (b, s, nq, hd), dtype, dev)
    qi = torch.arange(s, dtype=torch.int32, device=dev)
    ki = torch.arange(S, dtype=torch.int32, device=dev)
    if pfx is not None:
        span, valid = pfx
        assert S == span + s
        qp = qi + valid
        kp = torch.cat([torch.where(ki[:span] < valid, ki[:span],
                                    torch.full_like(ki[:span], -1)), qp])
    else:
        qp = qi + (S - s if causal else 0)
        kp = torch.where(ki < (S if k_pad is None else k_pad), ki,
                         torch.full_like(ki, -1))
    qp = torch.where(qi < (s if q_pad is None else q_pad), qp,
                     torch.full_like(qi, -1)).repeat(b, 1)
    return q, k, v, dout, qp.contiguous(), kp.repeat(b, 1).contiguous()


BWD_CASES = [
    # b, s, S, nq, nkv, hd, window, causal, extra
    (2, 64, 64, 4, 2, 64, None, True, {}),
    (1, 100, 100, 8, 8, 32, None, True, {}),
    (2, 128, 128, 4, 1, 64, 32, True, {}),
    (1, 96, 160, 4, 2, 128, None, True, {}),           # suffix: S > s
    (1, 50, 70, 4, 2, 64, None, False, {}),             # cross
    (1, 300, 77, 8, 2, 64, None, False, {}),            # cross, S < s
    (1, 200, 200, 9, 3, 64, None, True, dict(q_pad=150)),
    (2, 129, 129, 16, 2, 128, 50, True, dict(k_pad=100)),
    (1, 70, 90, 4, 4, 32, None, False, dict(q_pad=60, k_pad=80)),
    (1, 64, 64, 2, 2, 32, None, True, dict(q_pad=0)),   # no valid row
    # lengths no multiple of the 64-row tiles (a suffix, then hd 128)
    (1, 190, 250, 6, 3, 64, None, True, {}),
    (2, 333, 333, 8, 2, 128, None, True, {}),
    # a single query tile: causal at hd 32 with GQA 4, and cross
    (3, 40, 40, 4, 1, 32, None, True, {}),
    (1, 48, 300, 4, 2, 64, None, False, {}),
    # a gathered prefix: 100 valid keys, a run of 350 -1 slots (key tiles
    # 2 to 6 whole), then the 100 new keys
    (2, 100, 550, 8, 2, 128, None, True, dict(pfx=(450, 100))),
    # a window across the 64-key tile edges at hd 128, GQA 4
    (1, 300, 300, 16, 4, 128, 100, True, {}),
]


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_matches_plain_autograd(dev, case, dtype):
    """dq, dk, dv of the kernel against autograd of the plain version,
    over causal, windowed, suffix, cross, padded and GQA forms; rows
    without a valid key get zero gradients."""
    b, s, S, nq, nkv, hd, win, causal, extra = case
    q, k, v, dout, qp, kp = _bwd_case(dev, dtype, b, s, S, nq, nkv, hd,
                                      causal=causal, **extra)
    out, lse = flash_attention_with_lse(q, k, v, qp, kp, window=win,
                                        causal=causal)
    ops.reset_launch_counts()
    got = FB.flash_attention_bwd(q, k, v, out, dout, lse, qp, kp, window=win,
                                 causal=causal)
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    want = attention_bwd_ref(q, k, v, qp, kp, dout, window=win,
                             causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g, w, **TOL[dtype])
    q_pad = extra.get("q_pad")
    if q_pad is not None:
        assert torch.all(got[0][:, q_pad:] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_is_deterministic(dev, dtype):
    """No atomics: two calls on the same inputs are bitwise equal."""
    q, k, v, dout, qp, kp = _bwd_case(dev, dtype, 2, 300, 300, 9, 3, 64)
    out, lse = flash_attention_with_lse(q, k, v, qp, kp)
    a = FB.flash_attention_bwd(q, k, v, out, dout, lse, qp, kp)
    b = FB.flash_attention_bwd(q, k, v, out, dout, lse, qp, kp)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_is_deterministic_at_hd128(dev, dtype):
    """The same at head dim 128 (one dK/dV block a multiprocessor), with a
    window and GQA 4: two calls bitwise equal."""
    q, k, v, dout, qp, kp = _bwd_case(dev, dtype, 2, 333, 333, 16, 4, 128)
    out, lse = flash_attention_with_lse(q, k, v, qp, kp, window=100)
    a = FB.flash_attention_bwd(q, k, v, out, dout, lse, qp, kp, window=100)
    b = FB.flash_attention_bwd(q, k, v, out, dout, lse, qp, kp, window=100)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_forward_lse_matches_plain(dev, case, dtype):
    """The log-sum-exp the forward keeps for the gradient equals the plain
    version's (f32 from the same rounded inputs on both sides, so the f32
    tolerance), +inf on the same rows (no valid key); the output is the
    call's without it, bitwise."""
    b, s, S, nq, nkv, hd, win, causal, extra = case
    q, k, v, _, qp, kp = _bwd_case(dev, dtype, b, s, S, nq, nkv, hd,
                                   causal=causal, **extra)
    ops.reset_launch_counts()
    out, lse = flash_attention_with_lse(q, k, v, qp, kp, window=win,
                                        causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    want = attention_lse_ref(q, k, qp, kp, window=win, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (b, nq, s)
    assert torch.equal(torch.isposinf(lse), torch.isposinf(want))
    torch.testing.assert_close(lse, want, **TOL[torch.float32])
    assert torch.equal(out, flash_attention(q, k, v, qp, kp, window=win,
                                            causal=causal))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_autograd_goes_through_the_kernels(dev, dtype):
    """With an input requiring a gradient, flash's output carries the
    gradient kernel: backward launches it once, with the plain version's
    gradients; the forward's bytes equal a call without autograd."""
    q, k, v, dout, qp, kp = _bwd_case(dev, dtype, 2, 130, 130, 8, 2, 64,
                                      q_pad=120)
    with torch.no_grad():
        plain_out = flash_attention(q, k, v, qp, kp, window=40)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launch_counts()
    out = flash_attention(*leaves, qp, kp, window=40)
    assert torch.equal(out, plain_out)
    out.backward(dout)
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    want = attention_bwd_ref(q, k, v, qp, kp, dout, window=40)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, **TOL[dtype])


def test_serving_launches_no_backward_with_grad_enabled(dev):
    """A serving run with autograd on launches what it launches under
    torch.no_grad(): no gradient kernel, the same graphs and nodes."""
    runs = []
    for grad in (False, True):
        eng = _graph_engine(dev, "dense", torch.bfloat16)
        reqs = _requests(eng, image=True)
        ops.reset_launch_counts()
        with torch.set_grad_enabled(grad):
            _serve(eng, reqs)
        torch.cuda.synchronize()
        runs.append((ops.launch_counts(), eng.graph_census(),
                     [r.output_tokens for r in reqs]))
        del eng
        gc.collect()
    assert runs[0] == runs[1]
    assert runs[0][0]["flash_attention_bwd"] == 0


def test_serving_forward_passes_no_lse(dev, monkeypatch):
    """Serving, with autograd on, asks the forward for no log-sum-exp:
    every flash launch passes a null lse pointer; the graph census is the
    one of the same run under torch.no_grad(), one flash node a layer in
    each dense prefill graph (with an image and without) and one decode
    node a layer in each decode graph."""
    from repro_torch.kernels import _build
    real = _build.launch
    lse_args = []

    def spy(name, device, *args):
        if name == "flash_attention":
            lse_args.append(args[6])     # q, k, v, q_pos, kv_pos, out, lse
        return real(name, device, *args)

    monkeypatch.setattr(_build, "launch", spy)
    censuses = []
    for grad in (False, True):
        eng = _graph_engine(dev, "dense", torch.bfloat16)
        reqs = _requests(eng, image=True)
        with torch.set_grad_enabled(grad):
            _serve(eng, reqs)
        torch.cuda.synchronize()
        censuses.append(eng.graph_census())
        n = eng.cfg.n_layers
        del eng
        gc.collect()
    assert lse_args and all(a is None for a in lse_args)
    assert censuses[0] == censuses[1]
    for step, wrapper in (("decode", "decode_attention"),
                          ("prefill", "flash_attention")):
        census = censuses[1][step]
        ours = {k: v for k, v in census.items() if k.endswith(" nodes")}
        assert census["graphs"] >= 1
        assert ours == {f"{wrapper} nodes": n * census["graphs"]}


def _train_setup(dev, arch="smollm-135m"):
    from repro_torch.training.data import synthetic_batches
    from repro_torch.training.optimizer import AdamW
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator(device="cpu").manual_seed(0),
                         device="cpu")
    batch = next(synthetic_batches(cfg, 2, 96, 1, seed=5, device="cpu"))
    return cfg, params, batch, AdamW(lr=1e-3, warmup_steps=1)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One f32 train step of reduced smollm on the card (flash and its
    gradient kernel) against the CPU's (plain versions): loss, updated
    params; remat=True equals remat=False on the card."""
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training.train import make_train_step
    cfg, params, batch, opt = _train_setup(dev)
    p_cpu, _, m_cpu = make_train_step(cfg, opt, remat=False)(
        params, opt.init(params), batch)
    to = functools.partial(map_tree, lambda t: t.to(dev))
    gp, gb = to(params), to(batch)
    ops.reset_launch_counts()
    p_gpu, _, m_gpu = make_train_step(cfg, opt, remat=False)(
        gp, opt.init(gp), gb)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    assert ops.launch_counts()["flash_attention_bwd"] == cfg.n_layers
    p_rem, _, m_rem = make_train_step(cfg, opt, remat=True)(
        gp, opt.init(gp), gb)
    assert abs(float(m_cpu["loss"]) - float(m_gpu["loss"])) < 1e-4
    for a, b, c in zip(leaves(p_cpu), leaves(p_gpu), leaves(p_rem)):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
        assert torch.equal(b, c)


def test_mamba2_training_raises_on_the_card(dev):
    """One f32 train step of reduced mamba2 (state dim 64, which the
    kernels take) on the card (ssd_scan and its gradient kernel,
    ssd_scan_bwd) against the CPU's (plain versions): the loss and the
    updated params; one forward and one gradient launch a layer; remat
    equals no remat on the card, bitwise."""
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.training.train import make_train_step
    cfg, params, batch, opt = _train_setup(dev, "mamba2-370m")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           state_dim=64))
    params = init_params(cfg, torch.Generator(device="cpu").manual_seed(0),
                         device="cpu")
    p_cpu, _, m_cpu = make_train_step(cfg, opt, remat=False)(
        params, opt.init(params), batch)
    to = functools.partial(map_tree, lambda t: t.to(dev))
    gp, gb = to(params), to(batch)
    ops.reset_launch_counts()
    p_gpu, _, m_gpu = make_train_step(cfg, opt, remat=False)(
        gp, opt.init(gp), gb)
    assert ops.launch_counts()["ssd_scan"] == cfg.n_layers
    assert ops.launch_counts()["ssd_scan_bwd"] == cfg.n_layers
    p_rem, _, m_rem = make_train_step(cfg, opt, remat=True)(
        gp, opt.init(gp), gb)
    assert abs(float(m_cpu["loss"]) - float(m_gpu["loss"])) < 1e-4
    for a, b, c in zip(leaves(p_cpu), leaves(p_gpu), leaves(p_rem)):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
        assert torch.equal(b, c)