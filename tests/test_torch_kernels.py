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
from repro_torch.kernels.decode_attention.kernel import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.kernels.paged_decode_attention.kernel import (  # noqa: E402
    paged_decode_attention)

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
