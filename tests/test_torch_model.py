"""The port's model against the JAX package's, layer by layer and end to
end. Parameters come from the reference's ``init_params(cfg,
PRNGKey(0))`` through ``repro_torch.convert.from_numpy_params``; every
other input is made with numpy from a seed and handed to both. f32
throughout; the tolerance covers the two frameworks' summation orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import count_params, param_structure  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["smollm-135m", "llava-next-mistral-7b"]
# the reference's functions compiled whole, the config static: one
# compile per shape instead of eager op-by-op dispatch
jax_attention_block = jax.jit(JL.attention_block, static_argnums=(3,),
                              static_argnames=("window", "causal"))
jax_mlp_block = jax.jit(JL.mlp_block, static_argnums=(2,))
jax_prefill = jax.jit(JM.prefill_forward, static_argnums=(1,))
jax_decode = jax.jit(JM.decode_forward, static_argnums=(1,))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg_j = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    return cfg_j, cfg, pj, pt


def _layer(pj, pt, kind="attn", r=0):
    return (jax.tree.map(lambda a: a[r], pj["blocks"][0][kind]),
            {k: v[r] for k, v in pt["blocks"][0][kind].items()})


def test_convert_keeps_structure_and_values(model):
    cfg_j, cfg, pj, pt = model
    assert count_params(pt) == cfg.param_count()
    assert pt["blocks"][0]["attn"]["wq"].shape == \
        param_structure(cfg)["blocks"][0]["attn"]["wq"].shape
    _close(pt["embed"], pj["embed"], atol=0, rtol=0)
    with pytest.raises(ValueError):
        from_numpy_params({**jax.tree.map(np.asarray, pj), "embed":
                           np.zeros((3, 3), np.float32)}, cfg, device="cpu")


def test_rms_norm_rope_mlp(model):
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    pos[1, -2:] = -1
    w = rng.standard_normal((cfg.d_model,), dtype=np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    xh = x.reshape(2, 9, -1, cfg.head_dim)
    _close(L.rope(torch.from_numpy(xh), torch.from_numpy(pos), 1e6),
           JL.rope(jnp.asarray(xh), jnp.asarray(pos), 1e6))
    mj, mt = _layer(pj, pt, "mlp")
    _close(L.mlp_block(mt, torch.from_numpy(x), cfg),
           jax_mlp_block(mj, jnp.asarray(x), cfg_j))


# ---------------------------------------------------------------------------
# attention_block, one test per branch (repro/models/layers.py:120-263)
# ---------------------------------------------------------------------------

def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _attn(cfg_j, cfg, pj, pt, x, pos, cache=None, **kw):
    aj, at = _layer(pj, pt)
    (xj, pj_), (xt, pt_) = _both(x, pos)
    cj, ct = (None, None) if cache is None else _both(*cache)
    kwj = {k: jnp.asarray(v) for k, v in kw.items()}
    kwt = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    oj, ncj = jax_attention_block(aj, xj, pj_, cfg_j, cache=cj, **kwj)
    ot, nct = L.attention_block(at, xt, pt_, cfg, cache=ct, **kwt)
    _close(ot, oj)
    return ncj, nct


def test_attention_block_no_cache(model):
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    ncj, nct = _attn(cfg_j, cfg, pj, pt, x, pos)
    assert ncj is None and nct is None


def _dense_cache(cfg, b, S, rng, n_filled):
    k = rng.standard_normal((b, S, cfg.n_kv_heads, cfg.head_dim),
                            dtype=np.float32)
    v = rng.standard_normal(k.shape, dtype=np.float32)
    kp = np.tile(np.arange(S, dtype=np.int32), (b, 1))
    kp = np.where(kp < np.asarray(n_filled)[:, None], kp, -1).astype(np.int32)
    return k, v, kp


def test_attention_block_dense_prefill(model):
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(2)
    S, s = 32, 20
    x = rng.standard_normal((1, s, cfg.d_model), dtype=np.float32)
    pos = np.where(np.arange(s) < 17, np.arange(s), -1).astype(np.int32)[None]
    ncj, nct = _attn(cfg_j, cfg, pj, pt, x, pos,
                     cache=_dense_cache(cfg, 1, S, rng, [5]))
    for a, b in zip(nct, ncj):
        _close(a, b)


def test_attention_block_dense_decode(model):
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(3)
    S, b = 32, 3
    cur = np.array([4, 17, 31], np.int32)
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    ncj, nct = _attn(cfg_j, cfg, pj, pt, x, cur[:, None],
                     cache=_dense_cache(cfg, b, S, rng, cur), cur_len=cur)
    for a, b_ in zip(nct, ncj):
        _close(a, b_)


def _pool(cfg, n_pages, page, rng):
    k = rng.standard_normal((n_pages, page, cfg.n_kv_heads, cfg.head_dim),
                            dtype=np.float32)
    return k, rng.standard_normal(k.shape, dtype=np.float32)


def test_attention_block_paged_prefill(model):
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(4)
    page, width, b = 8, 4, 2
    pages = np.array([[3, 1, 0, 0], [2, 5, 4, 0]], np.int32)
    S = 3 * page
    x = rng.standard_normal((b, S, cfg.d_model), dtype=np.float32)
    n = np.array([13, 22])
    pos = np.where(np.arange(S)[None] < n[:, None], np.arange(S)[None],
                   -1).astype(np.int32)
    ncj, nct = _attn(cfg_j, cfg, pj, pt, x, pos, cache=_pool(cfg, 7, page, rng),
                     pages=pages)
    for a, b_ in zip(nct, ncj):           # page 0 is trash: not compared
        _close(a[1:], b_[1:])


def test_attention_block_paged_decode(model):
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(5)
    page = 8
    pages = np.array([[3, 1, 0, 0], [2, 5, 4, 6], [0, 0, 0, 0]], np.int32)
    cur = np.array([9, 31, 0], np.int32)       # slot 2 inactive (trash)
    x = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    aj, at = _layer(pj, pt)
    (xj, pj_, cj0, cj1), (xt, pt_, ct0, ct1) = _both(
        x, cur[:, None], *_pool(cfg, 7, page, rng))
    oj, ncj = jax_attention_block(aj, xj, pj_, cfg_j, cache=(cj0, cj1),
                                 cur_len=jnp.asarray(cur),
                                 pages=jnp.asarray(pages))
    ot, nct = L.attention_block(at, xt, pt_, cfg, cache=(ct0, ct1),
                                cur_len=torch.from_numpy(cur),
                                pages=torch.from_numpy(pages))
    _close(ot[:2], oj[:2])
    for a, b_ in zip(nct, ncj):
        _close(a[1:], b_[1:])


@pytest.mark.parametrize("prefix_len,pos_base,n", [(20, 16, 35), (16, 16, 30),
                                                   (9, 8, 30)])
def test_attention_block_paged_suffix_prefill(model, prefix_len, pos_base, n):
    cfg_j, cfg, pj, pt = model
    rng = np.random.default_rng(6)
    page = 8
    pages = np.array([[3, 1, 5, 2, 4, 0]], np.int32)
    win = -(-n // page) * page - pos_base
    x = rng.standard_normal((1, win, cfg.d_model), dtype=np.float32)
    ab = pos_base + np.arange(win)
    pos = np.where((ab >= prefix_len) & (ab < n), ab, -1).astype(
        np.int32)[None]
    ncj, nct = _attn(cfg_j, cfg, pj, pt, x, pos,
                     cache=_pool(cfg, 7, page, rng), pages=pages,
                     prefix_len=prefix_len, pos_base=pos_base)
    for a, b_ in zip(nct, ncj):
        _close(a[1:], b_[1:])


# ---------------------------------------------------------------------------
# prefill_forward / decode_forward: last-token logits, dense and paged
# ---------------------------------------------------------------------------

MAX_LEN, PAGE = 64, 8


def _prompt(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab, size=n).astype(np.int32)


def _caches(cfg_j, cfg, layout):
    if layout == "dense":
        cj = JT.make_caches(cfg_j, 1, MAX_LEN, dtype=jnp.float32)
        ct = T.make_caches(cfg, 1, MAX_LEN, dtype=torch.float32)
        return cj, ct
    kw = dict(layout="paged", page_size=PAGE, n_pages=1 + MAX_LEN // PAGE)
    cj = JT.make_caches(cfg_j, 1, MAX_LEN, dtype=jnp.float32, **kw)
    ct = T.make_caches(cfg, 1, MAX_LEN, dtype=torch.float32, **kw)
    row = np.arange(1, 1 + MAX_LEN // PAGE, dtype=np.int32)[::-1].copy()
    cj["pages"] = jnp.asarray(row[None])
    ct["pages"][0] = torch.from_numpy(row)
    return cj, ct


def _mm(cfg, pt, seed):
    """Projected image features for the VLM config (numpy, both sides)."""
    if cfg.frontend is None:
        return None
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((cfg.frontend.tokens_per_item,
                                   cfg.frontend.feature_dim),
                                  dtype=np.float32) * np.float32(0.02)
    return (patches @ pt["projector"].numpy())[None]


def _prefill_both(cfg_j, cfg, pj, pt, cj, ct, toks, n, feats, mm_pos, **kw):
    kwj = dict(lengths=jnp.asarray([n], jnp.int32))
    kwt = dict(lengths=torch.tensor([n], dtype=torch.int32))
    if feats is not None:
        kwj.update(mm_feats=jnp.asarray(feats), mm_start=mm_pos)
        kwt.update(mm_feats=torch.from_numpy(feats), mm_start=mm_pos)
    if kw:
        kwj.update(prefix_len=jnp.asarray(kw["prefix_len"]),
                   pos_base=jnp.asarray(kw["pos_base"]))
        kwt.update(kw)
    lj, cj = jax_prefill(pj, cfg_j, jnp.asarray(toks), cj, **kwj)
    lt, ct = M.prefill_forward(pt, cfg, torch.from_numpy(toks), ct, **kwt)
    _close(lt, lj)
    return cj, ct


def _decode_both(cfg_j, cfg, pj, pt, cj, ct, tokens):
    for tok in tokens:
        lj, cj = jax_decode(pj, cfg_j, jnp.asarray([tok], jnp.int32), cj)
        lt, ct = M.decode_forward(pt, cfg, torch.tensor([tok],
                                                        dtype=torch.int32), ct)
        _close(lt, lj)
        assert int(ct["len"][0]) == int(cj["len"][0])
    return cj, ct


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_and_decode_logits(model, layout):
    cfg_j, cfg, pj, pt = model
    feats = _mm(cfg, pt, 7)
    n_mm = 0 if feats is None else feats.shape[1]
    text = _prompt(cfg, 21, 8)
    mm_pos = 5
    n = len(text) + n_mm
    toks = np.zeros((1, MAX_LEN), np.int32)
    toks[0, :mm_pos] = text[:mm_pos]
    toks[0, mm_pos + n_mm:n] = text[mm_pos:]
    cj, ct = _caches(cfg_j, cfg, layout)
    cj, ct = _prefill_both(cfg_j, cfg, pj, pt, cj, ct, toks, n, feats, mm_pos)
    _decode_both(cfg_j, cfg, pj, pt, cj, ct, [3, 11, 7])


@pytest.mark.parametrize("prefix_len", [16, 20])
def test_suffix_prefill_logits(model, prefix_len):
    """Paged prefill of a prefix, then the suffix against the cached
    prefix (the prefix-cache hit / chunk step), then decode."""
    cfg_j, cfg, pj, pt = model
    text = _prompt(cfg, 37, 9)
    cj, ct = _caches(cfg_j, cfg, "paged")
    toks = np.zeros((1, -(-prefix_len // PAGE) * PAGE), np.int32)
    toks[0, :prefix_len] = text[:prefix_len]
    cj, ct = _prefill_both(cfg_j, cfg, pj, pt, cj, ct, toks, prefix_len,
                           None, 0)
    pos_base = prefix_len // PAGE * PAGE
    win = -(-len(text) // PAGE) * PAGE - pos_base
    sfx = np.zeros((1, win), np.int32)
    sfx[0, prefix_len - pos_base:len(text) - pos_base] = text[prefix_len:]
    cj, ct = _prefill_both(cfg_j, cfg, pj, pt, cj, ct, sfx, len(text), None,
                           0, prefix_len=prefix_len, pos_base=pos_base)
    _decode_both(cfg_j, cfg, pj, pt, cj, ct, [4, 9])


def test_unsupported_models_raise():
    for name in ("mamba2-370m", "mixtral-8x7b", "whisper-base"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.make_caches(get_config(name).reduced(), 1, 16)
