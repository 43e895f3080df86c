"""The port's attention kernels against the JAX package's.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version; these tests hold it against the JAX oracles on the reference's
own case lists, and one case per kernel against the Pallas kernel in
interpret mode. Inputs are made with numpy from a seed and handed to both
packages. The CUDA kernels themselves are tested on a card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as JD  # noqa: E402
from repro.kernels import flash_attention as JF  # noqa: E402
from repro.kernels import paged_decode_attention as JP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import backward as flash_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention, flash_attention_with_lse)
from repro_torch.kernels.paged_decode_attention.kernel import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402

# the JAX oracles compiled whole (one compile per shape is far cheaper
# than eager op-by-op dispatch); the Pallas wrappers are jitted already
jax_attention_ref = jax.jit(JF.attention_ref,
                            static_argnames=("window", "causal"))
jax_decode_ref = jax.jit(JD.decode_attention_ref, static_argnames=("window",))
jax_paged_ref = jax.jit(JP.paged_decode_attention_ref,
                        static_argnames=("window",))
jax_flash_kernel = JF.flash_attention
jax_decode_kernel = JD.decode_attention
jax_paged_kernel = JP.paged_decode_attention

# f32: both sides compute the same f32 math in another summation order;
# bf16: inputs and outputs round to 8 bits of mantissa.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = ["float32", "bfloat16"]


def _pair(x, dtype):
    """One numpy array as (jax array, torch tensor) of the same values."""
    if x.dtype.kind in "iu":
        return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = getattr(torch, dtype)
    return jnp.asarray(x, jt), torch.from_numpy(x.astype(np.float32)).to(tt)


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# flash attention (repro/kernels/flash_attention, tests/test_kernels.py)
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # b, s, S, nq, nkv, hd, window, causal
    (2, 64, 64, 4, 2, 64, None, True),
    (1, 100, 100, 8, 8, 32, None, True),       # MHA, ragged seq
    (2, 128, 128, 4, 1, 64, 32, True),         # MQA + sliding window
    (1, 50, 70, 4, 2, 64, None, False),        # cross attention
    (1, 33, 33, 2, 2, 128, 16, True),          # odd seq, window
]


def _flash_inputs(case, dtype, seed=0):
    b, s, S, nq, nkv, hd, win, causal = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, nq, hd), dtype=np.float32)
    k = rng.standard_normal((b, S, nkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, S, nkv, hd), dtype=np.float32)
    qp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    qp = np.where(qp < s - 3, qp, -1).astype(np.int32)   # padded queries
    kp = np.broadcast_to(np.arange(S, dtype=np.int32), (b, S)).copy()
    return [_pair(a, dtype) for a in (q, k, v, qp, kp)]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_matches_jax_oracle(case, dtype):
    win, causal = case[6], case[7]
    args = _flash_inputs(case, dtype)
    ref = jax_attention_ref(*(a for a, _ in args), window=win, causal=causal)
    out = flash_attention(*(t for _, t in args), window=win, causal=causal)
    assert out.dtype == args[0][1].dtype and out.shape == args[0][1].shape
    _close(out, ref, dtype)


def test_flash_plain_matches_pallas_interpret():
    case = FLASH_CASES[2]
    args = _flash_inputs(case, "float32", seed=1)
    ref = jax_flash_kernel(*(a for a, _ in args), window=case[6],
                           causal=case[7], block_q=32, block_k=32,
                           interpret=True)
    out = flash_attention(*(t for _, t in args), window=case[6],
                          causal=case[7])
    _close(out, ref, "float32")


def test_flash_plain_chunked_path_matches_jax_oracle(monkeypatch):
    """Above the threshold the plain version runs in query chunks."""
    monkeypatch.setattr(flash_ref, "_CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(flash_ref, "_Q_CHUNK", 16)
    case = (1, 70, 70, 4, 2, 32, None, True)
    args = _flash_inputs(case, "float32", seed=2)
    ref = jax_attention_ref(*(a for a, _ in args))
    _close(flash_attention(*(t for _, t in args)), ref, "float32")


def test_flash_plain_zeroes_fully_masked_rows():
    args = _flash_inputs(FLASH_CASES[0], "float32")
    out = flash_attention(*(t for _, t in args))
    assert torch.all(out[:, -3:] == 0)


# ---------------------------------------------------------------------------
# flash's gradient from the forward's log-sum-exp: the arithmetic of
# csrc/flash_attention_bwd.cu in plain ops, held against JAX
# ---------------------------------------------------------------------------

# the forms of tests/test_torch_cuda.py's BWD_CASES: causal, window,
# suffix (S > s), cross with S > s and S < s, padded queries and keys, a
# row table without any valid row, GQA groups 1, 2, 3, 4 and 8, head dims
# 32, 64 and 128
BWD_CASES = [
    # b, s, S, nq, nkv, hd, window, causal, extra
    (2, 64, 64, 4, 2, 64, None, True, {}),
    (1, 100, 100, 8, 8, 32, None, True, {}),
    (2, 128, 128, 4, 1, 64, 32, True, {}),
    (1, 96, 160, 4, 2, 128, None, True, {}),            # suffix: S > s
    (1, 50, 70, 4, 2, 64, None, False, {}),              # cross, S > s
    (1, 120, 77, 8, 2, 64, None, False, {}),             # cross, S < s
    (1, 80, 80, 9, 3, 64, None, True, dict(q_pad=60)),
    (2, 70, 70, 16, 2, 128, 20, True, dict(k_pad=50)),
    (1, 40, 50, 4, 4, 32, None, False, dict(q_pad=30, k_pad=44)),
    (1, 32, 32, 2, 2, 32, None, True, dict(q_pad=0)),    # no valid row
]
# f32 on both sides; the sums run in another order (the softmax's
# normalisation against the lse's subtraction), so a few ulps of the
# largest gradient
BWD_TOL = dict(atol=2e-5, rtol=1e-4)


def _bwd_inputs(case, seed=0):
    """numpy q, k, v, dout and positions: queries at the end of the keys'
    span when causal, query rows from ``q_pad`` and key slots from
    ``k_pad`` padding (-1)."""
    b, s, S, nq, nkv, hd, _, causal, extra = case
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal(sh, dtype=np.float32) for sh in (
        (b, s, nq, hd), (b, S, nkv, hd), (b, S, nkv, hd), (b, s, nq, hd)))
    qi = np.arange(s, dtype=np.int32)
    qp = qi + (S - s if causal else 0)
    qp = np.where(qi < extra.get("q_pad", s), qp, -1).astype(np.int32)
    ki = np.arange(S, dtype=np.int32)
    kp = np.where(ki < extra.get("k_pad", S), ki, -1).astype(np.int32)
    return (q, k, v, dout, np.tile(qp, (b, 1)), np.tile(kp, (b, 1)))


def _jax_masked_scores(q, k, qp, kp, window, causal):
    """The reference's scaled scores and masks (its ref.py), in jnp:
    (b, nq, s, S) with -inf where a pair is masked, and the valid rows."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = jnp.asarray(q).reshape(b, s, nkv, nq // nkv, hd)
    sc = jnp.einsum("bskgh,bTkh->bkgsT", qg, jnp.asarray(k)) * hd ** -0.5
    qp, kp = jnp.asarray(qp), jnp.asarray(kp)
    valid = (kp[:, None, :] >= 0) & (qp[:, :, None] >= 0)
    if causal:
        valid &= kp[:, None, :] <= qp[:, :, None]
        if window is not None:
            valid &= kp[:, None, :] > qp[:, :, None] - window
    sc = jnp.where(valid[:, None, None], sc, -jnp.inf).reshape(b, nq, s, -1)
    return sc, np.asarray(valid.any(-1))


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_lse_plain_matches_jax_logsumexp(case):
    """attention_lse_ref, and flash_attention_with_lse on the CPU, equal
    jax.nn.logsumexp of the reference's scaled, masked scores; +inf where
    a row has no valid key."""
    win, causal = case[6], case[7]
    q, k, v, _, qp, kp = _bwd_inputs(case)
    sc, rows = _jax_masked_scores(q, k, qp, kp, win, causal)
    want = np.asarray(jax.nn.logsumexp(sc, axis=-1))          # (b, nq, s)
    tq, tk, tv, tqp, tkp = (torch.from_numpy(x) for x in (q, k, v, qp, kp))
    got = flash_ref.attention_lse_ref(tq, tk, tqp, tkp, window=win,
                                      causal=causal)
    assert got.dtype == torch.float32 and got.shape == want.shape
    has = np.broadcast_to(rows[:, None, :], want.shape)
    np.testing.assert_allclose(got.numpy()[has], want[has], atol=1e-5,
                               rtol=1e-6)
    assert np.all(np.isposinf(got.numpy()[~has]))
    _, lse = flash_attention_with_lse(tq, tk, tv, tqp, tkp, window=win,
                                      causal=causal)
    assert torch.equal(lse, got)


_jax_attention_vjp = jax.jit(
    lambda q, k, v, dout, qp, kp, window, causal: jax.vjp(
        lambda a, b, c: JF.attention_ref(a, b, c, qp, kp, window=window,
                                         causal=causal), q, k, v)[1](dout),
    static_argnames=("window", "causal"))


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_from_lse_matches_jax_grad(case):
    """attention_bwd_from_lse (the gradient kernel's arithmetic: lse and D,
    P and dS from them, the GQA sums), fed the plain forward's output and
    lse, equals the reference's gradient of attention_ref (jax.vjp) in
    f32; the wrapper on CPU tensors returns it; rows without a valid key
    get zero gradients."""
    win, causal = case[6], case[7]
    arrays = _bwd_inputs(case, seed=1)
    want = _jax_attention_vjp(*(jnp.asarray(x) for x in arrays),
                              window=win, causal=causal)
    q, k, v, dout, qp, kp = (torch.from_numpy(x) for x in arrays)
    out, lse = flash_attention_with_lse(q, k, v, qp, kp, window=win,
                                        causal=causal)
    got = flash_ref.attention_bwd_from_lse(q, k, v, out, dout, lse, qp, kp,
                                           window=win, causal=causal)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    via = flash_bwd.flash_attention_bwd(q, k, v, out, dout, lse, qp, kp,
                                        window=win, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(via, got))
    empty = (qp < 0).numpy()
    assert np.all(got[0].numpy()[empty] == 0)


# ---------------------------------------------------------------------------
# decode attention (repro/kernels/decode_attention)
# ---------------------------------------------------------------------------

DECODE_CASES = [
    (2, 64, 4, 2, 64, None),
    (1, 100, 8, 1, 32, None),                   # MQA, ragged cache
    (2, 48, 4, 4, 64, 16),                      # MHA + window
    (3, 37, 6, 2, 128, None),                   # odd sizes
]


def _decode_inputs(case, dtype, seed=0):
    b, S, nq, nkv, hd, win = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nq, hd), dtype=np.float32)
    k = rng.standard_normal((b, S, nkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, S, nkv, hd), dtype=np.float32)
    kp = np.broadcast_to(np.arange(S, dtype=np.int32), (b, S))
    kp = np.where(kp < S - 5, kp, -1).astype(np.int32)    # empty ring slots
    qp = np.full((b,), S - 6, np.int32)
    return [_pair(a, dtype) for a in (q, k, v, qp, kp)]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_plain_matches_jax_oracle(case, dtype):
    args = _decode_inputs(case, dtype)
    ref = jax_decode_ref(*(a for a, _ in args), window=case[5])
    out = decode_attention(*(t for _, t in args), window=case[5])
    _close(out, ref, dtype)


def test_decode_plain_matches_pallas_interpret():
    case = DECODE_CASES[2]
    args = _decode_inputs(case, "float32", seed=3)
    ref = jax_decode_kernel(*(a for a, _ in args), window=case[5],
                            block_k=32, interpret=True)
    _close(decode_attention(*(t for _, t in args), window=case[5]), ref,
           "float32")


def test_ops_routes_single_token_to_decode():
    """ops.attention keeps the reference routing: s == 1 and causal goes
    to the decode kernel, whose fully-masked rows are uniform, not 0."""
    args = _decode_inputs(DECODE_CASES[0], "float32")
    q, k, v, qp, kp = (t for _, t in args)
    out = ops.attention(q[:, None], k, v, qp[:, None], kp)
    torch.testing.assert_close(out[:, 0], decode_attention(q, k, v, qp, kp))


# ---------------------------------------------------------------------------
# paged decode attention (repro/kernels/paged_decode_attention)
# ---------------------------------------------------------------------------

PAGED_CASES = [
    # b, page, max_pages, nq, nkv, hd, window
    (2, 16, 4, 4, 2, 64, None),              # GQA g=2
    (3, 8, 6, 8, 1, 32, None),               # MQA g=8, ragged
    (2, 16, 8, 4, 4, 64, 20),                # MHA + sliding window
    (1, 32, 3, 6, 2, 128, None),             # big page, odd group g=3
    (2, 8, 5, 8, 2, 64, 12),                 # GQA + window < page span
]


def _paged_inputs(b, page, max_pages, nq, nkv, hd, dtype, seed=0,
                  lens=None):
    """Random pool + block tables + ragged lengths (>=1 per slot), pages
    scattered over the pool, unmapped entries on the trash page 0."""
    n_pages = b * max_pages + 1
    rng = np.random.RandomState(seed)
    k_pool = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    q = rng.standard_normal((b, nq, hd)).astype(np.float32)
    if lens is None:
        lens = [rng.randint(1, max_pages * page + 1) for _ in range(b)]
    lens = np.asarray(lens, np.int32)
    tbl = np.zeros((b, max_pages), np.int32)
    free = list(range(1, n_pages))
    rng.shuffle(free)
    for i in range(b):
        for j in range(max(1, -(-int(lens[i]) // page))):
            tbl[i, j] = free.pop()
    return [_pair(a, dtype) for a in (q, k_pool, v_pool, tbl, lens)]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_plain_matches_jax_oracle(case, dtype):
    b, page, max_pages, nq, nkv, hd, win = case
    args = _paged_inputs(b, page, max_pages, nq, nkv, hd, dtype,
                         seed=sum(case[:6]))
    ref = jax_paged_ref(*(a for a, _ in args), window=win)
    out = paged_decode_attention(*(t for _, t in args), window=win)
    _close(out, ref, dtype)


@pytest.mark.parametrize("lens", [[8, 16, 32], [1, 9, 7]])
def test_paged_plain_page_boundary_lengths(lens):
    """Exact page-multiple lengths (the off-by-one hot spot)."""
    args = _paged_inputs(3, 8, 4, 4, 2, 32, "float32", seed=3, lens=lens)
    ref = jax_paged_ref(*(a for a, _ in args))
    _close(paged_decode_attention(*(t for _, t in args)), ref, "float32")


def test_paged_plain_matches_pallas_interpret():
    b, page, max_pages, nq, nkv, hd, win = PAGED_CASES[4]
    args = _paged_inputs(b, page, max_pages, nq, nkv, hd, "float32", seed=5)
    ref = jax_paged_kernel(*(a for a, _ in args), window=win, interpret=True)
    _close(paged_decode_attention(*(t for _, t in args), window=win), ref,
           "float32")


# ---------------------------------------------------------------------------
# the decode pair's launch plan (host side of the CUDA wrappers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, nkv, n_tokens, plan", [
    (4, 8, 3072, (384, 8)),         # the serving shape: 8 splits of 384
    (1, 1, 64, (64, 1)),            # one tile
    (64, 8, 3072, (3072, 1)),       # rows enough to fill the card alone
    (2, 2, 600, (64, 10)),
    (1, 8, 3072, (192, 16)),        # few rows: more, shorter splits
    (4, 8, 100_000, (11136, 9)),    # long rows: longer splits
    (1, 1, 100_000, (6272, 16)),    # at most MAX_SPLITS
])
def test_decode_split_plan_covers_the_row(b, nkv, n_tokens, plan):
    """The grid is sized from shapes alone (S, or max_pages * page): at
    most MAX_SPLITS splits a row, whole 64-token tiles each, covering
    every slot once."""
    split_len, nsplit = DK.split_plan(b, nkv, n_tokens, n_sm=132)
    assert (split_len, nsplit) == plan
    assert split_len % 64 == 0 and 1 <= nsplit <= DK.MAX_SPLITS
    assert (nsplit - 1) * split_len < n_tokens <= nsplit * split_len


@pytest.mark.parametrize("bsz, S, H, P, N, dtype, plan", [
    # the serving shape: 8 chunks of 256
    (1, 2048, 32, 64, 128, torch.bfloat16, (256, 8)),
    (1, 2048, 32, 64, 128, torch.float32, (64, 32)),    # f32: one tile
    (1, 64, 2, 32, 16, torch.bfloat16, (64, 1)),        # one tile
    (2, 96, 3, 32, 64, torch.bfloat16, (128, 1)),       # whole tiles
    (2, 520, 3, 64, 128, torch.bfloat16, (256, 3)),     # a ragged last chunk
    (2, 520, 3, 64, 128, torch.float32, (64, 9)),
    (1, 200, 2, 16, 64, torch.bfloat16, (256, 1)),
    (3, 4096, 2, 48, 16, torch.bfloat16, (256, 16)),
])
def test_ssd_plan_covers_the_sequence(bsz, S, H, P, N, dtype, plan):
    """The SSD scan's state chunks and scratch come from shapes alone:
    whole 64-token tiles, at most STATE_CHUNK, covering every token once;
    one f32 state (P, N) and one log-decay per (row, chunk, head), and
    the state before each chunk in the input dtype, in two bf16 parts."""
    pl = SK.plan(bsz, S, H, P, N, dtype)
    assert (pl.chunk, pl.n_chunks) == plan
    assert pl.chunk % SK.TILE == 0 and pl.chunk <= SK.STATE_CHUNK[dtype]
    assert (pl.n_chunks - 1) * pl.chunk < S <= pl.n_chunks * pl.chunk
    assert pl.state_floats == bsz * pl.n_chunks * H * P * N
    assert pl.decay_floats == bsz * pl.n_chunks * H
    assert pl.prev_elems == (2 if dtype == torch.bfloat16 else 1) * (
        pl.state_floats)


@pytest.mark.parametrize("g, width, parts", [
    (1, 1, 1), (2, 2, 1), (3, 4, 1), (4, 4, 1), (5, 8, 1), (8, 8, 1),
    (7, 8, 1), (9, 16, 1), (16, 16, 1), (24, 16, 2), (32, 16, 2),
    (33, 16, 3)])
def test_decode_group_width_and_partials(g, width, parts):
    """A group runs on the smallest width of 1/2/4/8/16 that holds it, a
    larger one in parts of 16, and the partials are sized to that width,
    the parts and the launch's splits: acc (b, nkv * parts, nsplit, G,
    hd) plus m and l; none for a single split."""
    assert DK.group_width(g) == width
    assert DK.group_parts(g) == parts
    b, nkv, hd, nsplit = 4, 8, 128, 8
    rows = b * nkv * parts * nsplit
    assert DK.partial_floats(b, nkv, g, hd, nsplit) == (
        rows * width * hd + rows * 2 * width)
    assert DK.partial_floats(b, nkv, g, hd, 1) == 0


def test_pallas_decode_gives_zero_for_a_row_without_keys():
    """What the CUDA pair is held to on the card: the TPU kernel turns
    l == 0 into 1, so a row with no valid key reads 0 (the plain versions
    give the mean of V instead)."""
    rng = np.random.default_rng(11)
    b, S, nq, nkv, hd = 2, 32, 4, 2, 32
    q = rng.standard_normal((b, nq, hd)).astype(np.float32)
    k = rng.standard_normal((b, S, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, S, nkv, hd)).astype(np.float32)
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (b, 1))
    kv_pos[0] = -1
    q_pos = np.array([S - 1, S - 1], np.int32)
    out = np.asarray(jax_decode_kernel(q, k, v, q_pos, kv_pos,
                                       interpret=True))
    assert np.all(out[0] == 0)
    plain = decode_attention(*(torch.from_numpy(x) for x in
                               (q, k, v, q_pos, kv_pos)))
    np.testing.assert_allclose(plain[1].numpy(), out[1], **TOL["float32"])
    assert np.abs(plain[0].numpy()).max() > 0
