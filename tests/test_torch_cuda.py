"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports neither ``jax`` nor ``repro``, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each test skips without a CUDA device (the kernels have no CPU mode).
Small shapes with the cases of ``tests/test_torch_kernels.py``: padded
queries, ragged caches, windows, GQA groups 1-8, head dims 32-128; the
serving shapes are checked by ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_decode_attention.kernel import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.paged_decode_attention.ref import (  # noqa: E402
    paged_decode_attention_ref)

pytestmark = pytest.mark.cuda

# bf16: 8-bit mantissa on the outputs; f32: summation order only
TOL = {torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
       torch.float32: dict(atol=1e-4, rtol=1e-4)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("case", [
    # b, s, S, nq, nkv, hd, window, causal
    (2, 64, 64, 4, 2, 64, None, True),
    (1, 100, 100, 8, 8, 32, None, True),
    (2, 128, 128, 4, 1, 64, 32, True),
    (1, 50, 70, 4, 2, 64, None, False),
    (1, 33, 33, 2, 2, 128, 16, True),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(dev, case, dtype):
    b, s, S, nq, nkv, hd, win, causal = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (b, s, nq, hd), dtype, dev)
    k = _randn(gen, (b, S, nkv, hd), dtype, dev)
    v = _randn(gen, (b, S, nkv, hd), dtype, dev)
    qi = torch.arange(s, dtype=torch.int32, device=dev)
    qp = torch.where(qi < s - 3, qi, torch.full_like(qi, -1)).repeat(b, 1)
    kp = torch.arange(S, dtype=torch.int32, device=dev).repeat(b, 1)
    ops.reset_launch_counts()
    out = flash_attention(q, k, v, qp, kp, window=win, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(
        out, attention_ref(q, k, v, qp, kp, window=win, causal=causal),
        **TOL[dtype])
    assert torch.all(out[:, -3:] == 0)         # fully masked query rows


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
