"""The fp8 KV cache (``kv_dtype=float8_e4m3fn``) of the port against the
JAX package's.

* The cast through which every value enters a KV cache or pool equals
  JAX's ``astype(float8_e4m3fn)`` bitwise, edges included (NaN past 464,
  where ``Tensor.to`` would saturate).
* The plain decode versions with fp8 K/V give the reference's oracles and
  its Pallas paged kernel (interpret mode).
* ``attention_block`` with fp8 caches gives the reference's outputs (f32,
  1e-5) and the reference's cache bytes, in every cached mode.
* ``Engine(kv_dtype=float8_e4m3fn)`` gives the reference's greedy tokens
  and P->D payload bytes; inside the port an fp8 cluster gives the fp8
  monolithic engine's tokens, continuous equals serial, and no page
  leaks.
Inputs are made with numpy from a seed; fp8 arrays cross between the
packages as their bytes.
"""
import weakref

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as jax_decode_ref)
from repro.kernels.paged_decode_attention.kernel import (  # noqa: E402
    paged_decode_attention as pallas_paged)
from repro.kernels.paged_decode_attention.ref import (  # noqa: E402
    paged_decode_attention_ref as jax_paged_ref)
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.core.cluster import EPDCluster  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.paged_decode_attention.ref import (  # noqa: E402
    paged_decode_attention_ref)
from repro_torch.launch.serve import with_kv_dtype  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

F8 = torch.float8_e4m3fn
NP_F8 = ml_dtypes.float8_e4m3fn
TOL = dict(atol=1e-5, rtol=1e-5)
PROMPT = [3, 1, 4, 1, 5]                   # tests/test_variants.py:45
PROMPTS = [PROMPT, [9, 2, 6, 5], [3, 5, 8, 9, 7, 9]]
jax_attention_block = jax.jit(JL.attention_block, static_argnums=(3,),
                              static_argnames=("window", "causal"))


def _np(x):
    """numpy view of a port tensor or a JAX array (fp8 as ml_dtypes)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == F8:
            return x.view(torch.uint8).numpy().view(NP_F8)
        return x.detach().numpy()
    return np.asarray(x)


def _t(a):
    """A port tensor holding numpy array ``a`` (fp8 bytes as they are)."""
    a = np.array(a)                   # a writable copy
    if a.dtype == NP_F8:
        return torch.from_numpy(a.view(np.uint8)).view(F8)
    return torch.from_numpy(a)


def _bytes(x):
    return _np(x).view(np.uint8)


def _f8(a):
    """numpy f32 -> fp8 through the reference's cast."""
    return np.asarray(jnp.asarray(a).astype(jnp.float8_e4m3fn))


# ---------------------------------------------------------------------------
# the cast
# ---------------------------------------------------------------------------

EDGES = [448, 464, 465, 480, 1e4, -1e4, np.inf, -np.inf, np.nan, -np.nan,
         2.0 ** -9, 1.5 * 2.0 ** -9, -448, -464, -465, 0.0, -0.0, 449, 463.9]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_cast_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(20_000).astype(np.float32) * 300,
                        rng.standard_normal(2_000).astype(np.float32),
                        np.asarray(EDGES, np.float32)])
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    # the same input bits on both sides (torch's own f32 -> bf16 cast
    # drops the sign of a NaN)
    xt = torch.from_numpy(np.asarray(xj).view(np.uint32 if dtype == "float32"
                                              else np.uint16).astype(np.int64))
    xt = xt.to(torch.int32 if dtype == "float32" else torch.int16).view(
        getattr(torch, dtype))
    want = np.asarray(xj.astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = L.to_kv(xt, F8)
    assert got.dtype == F8
    np.testing.assert_array_equal(_bytes(got), want)
    # Tensor.to saturates, so the helper is what makes these agree
    assert not np.array_equal(_bytes(xt.to(F8)), want)
    # every other dtype: a plain .to
    np.testing.assert_array_equal(_np(L.to_kv(xt, torch.float32)),
                                  _np(xt.float()))


# ---------------------------------------------------------------------------
# plain versions against the reference's oracles and Pallas kernel
# ---------------------------------------------------------------------------

def test_plain_decode_fp8_matches_reference():
    """The dense plain version widens fp8 K/V to q's dtype, as the
    reference's layer does before its decode call."""
    rng = np.random.default_rng(1)
    b, S, nq, nkv, hd = 3, 40, 8, 2, 64
    q = rng.standard_normal((b, nq, hd), dtype=np.float32)
    k = _f8(rng.standard_normal((b, S, nkv, hd), dtype=np.float32))
    v = _f8(rng.standard_normal((b, S, nkv, hd), dtype=np.float32))
    qp = np.array([39, 17, 5], np.int32)
    kp = np.where(np.arange(S)[None] <= qp[:, None], np.arange(S)[None],
                  -1).astype(np.int32)
    for window in (None, 7):
        got = decode_attention_ref(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                   window=window)
        want = jax_decode_ref(jnp.asarray(q), jnp.asarray(k, jnp.float32),
                              jnp.asarray(v, jnp.float32), jnp.asarray(qp),
                              jnp.asarray(kp), window=window)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_plain_paged_fp8_matches_reference_and_pallas():
    rng = np.random.default_rng(2)
    b, page, width, nq, nkv, hd = 3, 8, 5, 8, 2, 64
    n_pages = 1 + b * width
    q = rng.standard_normal((b, nq, hd), dtype=np.float32)
    kp = _f8(rng.standard_normal((n_pages, page, nkv, hd), dtype=np.float32))
    vp = _f8(rng.standard_normal((n_pages, page, nkv, hd), dtype=np.float32))
    tbl = (1 + rng.permutation(n_pages - 1)[:b * width]).reshape(
        b, width).astype(np.int32)
    lens = np.array([40, 9, 1], np.int32)
    for window in (None, 6):
        got = _np(paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(tbl),
                                             _t(lens), window=window))
        args = [jnp.asarray(a) for a in (q, kp, vp, tbl, lens)]
        np.testing.assert_allclose(got, np.asarray(
            jax_paged_ref(*args, window=window)), **TOL)
        np.testing.assert_allclose(got, np.asarray(
            pallas_paged(*args, window=window, interpret=True)), **TOL)


def test_attention_routes_fp8_only_to_the_decode_kernel():
    q = torch.zeros((1, 2, 4, 32))
    k = torch.zeros((1, 8, 2, 32), dtype=F8)
    pos = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="fp8"):
        ops.attention(q, k, k, pos, torch.zeros((1, 8), dtype=torch.int32))
    out = ops.attention(q[:, :1], k, k, pos[:, :1],
                        torch.zeros((1, 8), dtype=torch.int32))
    assert out.shape == (1, 1, 4, 32) and out.dtype == torch.float32


# ---------------------------------------------------------------------------
# attention_block with fp8 caches, every cached mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module",
                params=["smollm-135m", "llava-next-mistral-7b"])
def model(request):
    cfg_j = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    return cfg_j, cfg, pj, pt


def _layer(pj, pt, scale_wk=1.0):
    aj = jax.tree.map(lambda a: a[0], pj["blocks"][0]["attn"])
    at = {k: v[0] for k, v in pt["blocks"][0]["attn"].items()}
    if scale_wk != 1.0:
        aj = dict(aj, wk=aj["wk"] * scale_wk)
        at = dict(at, wk=at["wk"] * scale_wk)
    return aj, at


def _fp8_cache(shape, rng):
    return (_f8(rng.standard_normal(shape, dtype=np.float32)),
            _f8(rng.standard_normal(shape, dtype=np.float32)))


def _block(model, x, pos, cache, scale_wk=1.0, **kw):
    """attention_block of both packages on the same inputs; returns the
    outputs and the new caches as numpy. With the fp8 caches widened to
    f32, the new caches hold each package's K/V before the cast."""
    cfg_j, cfg, pj, pt = model
    aj, at = _layer(pj, pt, scale_wk)
    kwj = {k: jnp.asarray(v) for k, v in kw.items()}
    kwt = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    oj, cj = jax_attention_block(aj, jnp.asarray(x), jnp.asarray(pos), cfg_j,
                                 cache=tuple(jnp.asarray(c) for c in cache),
                                 **kwj)
    ot, ct = L.attention_block(at, _t(x), _t(pos), cfg,
                               cache=tuple(_t(c) for c in cache), **kwt)
    return (_np(ot), np.asarray(oj), [_np(c) for c in ct],
            [np.asarray(c) for c in cj])


def _f32(cache):
    return tuple(c.astype(np.float32) if c.dtype == NP_F8 else c
                 for c in cache)


def _check(model, x, pos, cache, skip=slice(None), scale_wk=1.0, **kw):
    """Outputs within 1e-5 (rows ``skip``); cache bytes: each package
    stores the reference's cast of its own f32 K/V (from a run over the
    same cache widened to f32), the two f32 K/V agree within 1e-5 (times
    the scale of ``wk``), and
    the bytes of the two packages are equal except where those f32
    values differ and lie on the two sides of an e4m3 rounding boundary
    (the frameworks' f32 products differ in their last bits), where they
    are neighbouring codes. Page 0 (trash) of a pool is not compared."""
    out_t, out_j, ct, cj = _block(model, x, pos, cache, scale_wk, **kw)
    np.testing.assert_allclose(out_t[skip], out_j[skip], **TOL)
    _, _, ct32, cj32 = _block(model, x, pos, _f32(cache), scale_wk, **kw)
    trash = 1 if "pages" in kw else 0
    n_diff = 0
    for a, b, a32, b32 in zip(ct, cj, ct32, cj32):
        assert a.dtype == b.dtype
        a, b, a32, b32 = a[trash:], b[trash:], a32[trash:], b32[trash:]
        if a.dtype != NP_F8:            # kv_pos
            np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_array_equal(a.view(np.uint8), _bytes(_f8(a32)))
        np.testing.assert_array_equal(b.view(np.uint8), _bytes(_f8(b32)))
        finite = np.isfinite(b32)
        np.testing.assert_allclose(a32[finite], b32[finite], rtol=1e-5,
                                   atol=1e-5 * scale_wk)
        diff = a.view(np.uint8) != b.view(np.uint8)
        assert (a32[diff] != b32[diff]).all()
        codes = np.abs(a.view(np.uint8)[diff].astype(int)
                       - b.view(np.uint8)[diff].astype(int))
        assert (codes == 1).all(), codes
        n_diff += int(diff.sum())
    return ct, cj, n_diff


def test_attention_block_fp8_dense_prefill_and_decode(model):
    cfg = model[1]
    rng = np.random.default_rng(3)
    S, shape = 32, (1, 32, cfg.n_kv_heads, cfg.head_dim)
    x = rng.standard_normal((1, 20, cfg.d_model), dtype=np.float32)
    pos = np.where(np.arange(20) < 17, np.arange(20), -1).astype(
        np.int32)[None]
    kpos = np.where(np.arange(S) < 5, np.arange(S), -1).astype(np.int32)[None]
    _check(model, x, pos, (*_fp8_cache(shape, rng), kpos))
    b, cur = 3, np.array([4, 17, 31], np.int32)
    shape = (b, S, cfg.n_kv_heads, cfg.head_dim)
    kpos = np.where(np.arange(S)[None] < cur[:, None], np.arange(S)[None],
                    -1).astype(np.int32)
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    _check(model, x, cur[:, None], (*_fp8_cache(shape, rng), kpos),
           cur_len=cur)


def _pool(cfg, rng, n_pages=7, page=8):
    return _fp8_cache((n_pages, page, cfg.n_kv_heads, cfg.head_dim), rng)


def test_attention_block_fp8_paged_decode(model):
    cfg = model[1]
    rng = np.random.default_rng(4)
    pages = np.array([[3, 1, 0, 0], [2, 5, 4, 6], [0, 0, 0, 0]], np.int32)
    cur = np.array([9, 31, 0], np.int32)       # slot 2 inactive (trash)
    x = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    _check(model, x, cur[:, None], _pool(cfg, rng), skip=slice(0, 2),
           cur_len=cur, pages=pages)


def test_attention_block_fp8_paged_prefill(model):
    cfg = model[1]
    rng = np.random.default_rng(5)
    pages = np.array([[3, 1, 0, 0], [2, 5, 4, 0]], np.int32)
    S = 24
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    n = np.array([13, 22])
    pos = np.where(np.arange(S)[None] < n[:, None], np.arange(S)[None],
                   -1).astype(np.int32)
    _check(model, x, pos, _pool(cfg, rng), pages=pages)


@pytest.mark.parametrize("prefix_len,pos_base,n", [(20, 16, 35), (9, 8, 30)])
def test_attention_block_fp8_paged_suffix_prefill(model, prefix_len,
                                                  pos_base, n):
    cfg = model[1]
    rng = np.random.default_rng(6)
    page = 8
    pages = np.array([[3, 1, 5, 2, 4, 0]], np.int32)
    win = -(-n // page) * page - pos_base
    x = rng.standard_normal((1, win, cfg.d_model), dtype=np.float32)
    ab = pos_base + np.arange(win)
    pos = np.where((ab >= prefix_len) & (ab < n), ab, -1).astype(
        np.int32)[None]
    _check(model, x, pos, _pool(cfg, rng), pages=pages,
           prefix_len=prefix_len, pos_base=pos_base)


def test_fp8_overflow_is_nan_at_the_reference_slots(model):
    """K scaled past the e4m3 range: NaN (not +-448) at the same slots of
    the pool in both packages, with the same sign bits."""
    cfg = model[1]
    rng = np.random.default_rng(7)
    pages = np.array([[3, 1, 0, 0]], np.int32)
    x = rng.standard_normal((1, 16, cfg.d_model), dtype=np.float32)
    pos = np.arange(16, dtype=np.int32)[None]
    ct, cj, _ = _check(model, x, pos, _pool(cfg, rng), scale_wk=2e3,
                       pages=pages)
    kt, kj = ct[0][1:], cj[0][1:]
    nan = np.isnan(kj.astype(np.float32))
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(kt.astype(np.float32)), nan)


# ---------------------------------------------------------------------------
# engines: greedy tokens and P->D bytes against the reference
# ---------------------------------------------------------------------------

MODES = {
    "dense": {},
    "paged": dict(paged=True, page_size=8),
    "chunked": dict(paged=True, page_size=8, chunked_prefill=True,
                    prefill_chunk=8, prefix_cache=True),
    "preempt": dict(paged=True, page_size=8, preemption=True),
}


def _serve(eng, prompt, preempt_at=None):
    """One request through prefill, insert and decode; a preemption
    (swap-out of its pages) at decode step ``preempt_at``, then resume.
    Returns (tokens, kv bytes handed from prefill to decode)."""
    req_cls = Request if isinstance(eng, Engine) else JaxRequest
    r = req_cls(prompt_tokens=list(prompt), max_new_tokens=6)
    first, payload = eng.prefill_request(r)
    nbytes = (payload.kv_nbytes if eng.paged
              else eng._attn_kv_nbytes(payload["attn"]))
    eng.insert(r, payload, first)
    step = 0
    while (any(s is r for s in eng.slots)
           or any(pr.req is r for pr in eng.preempted)):
        if step == preempt_at and any(s is r for s in eng.slots):
            eng.preempt_slot(eng.slots.index(r))
            assert eng.try_resume() == 1
        eng.decode_step()
        step += 1
    return list(r.output_tokens), nbytes


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fp8_engine_matches_reference(model, mode):
    cfg_j, cfg, pj, pt = model
    kw = MODES[mode]
    at = 2 if mode == "preempt" else None
    ej = JaxEngine(cfg_j, pj, max_batch=2, max_len=48,
                   kv_dtype=jnp.float8_e4m3fn, **kw)
    et = Engine(cfg, pt, max_batch=2, max_len=48, kv_dtype=F8, device="cpu",
                **kw)
    want, want_bytes = _serve(ej, PROMPT, at)
    got, got_bytes = _serve(et, PROMPT, at)
    assert got == want
    assert got_bytes == want_bytes
    # fp8 K/V: one byte an element, a quarter of the f32 payload
    full = Engine(cfg, pt, max_batch=2, max_len=48, device="cpu", **kw)
    assert 4 * got_bytes == _serve(full, PROMPT, at)[1]
    if kw.get("paged"):
        et.assert_no_page_leaks()
        if mode == "preempt":
            assert et.preempt_count == 1 and et.resume_count == 1


# ---------------------------------------------------------------------------
# inside the port, bitwise
# ---------------------------------------------------------------------------

def _fp8_cluster(cfg, pt, max_batch, **kw):
    cluster = EPDCluster(cfg, pt, max_batch=max_batch, max_len=64,
                         device="cpu", **kw)
    return with_kv_dtype(cluster, F8)


def _no_leaks(cluster):
    for eng in [cluster.prefill_engine, *cluster.decode_engines]:
        eng.assert_no_page_leaks()
        assert eng.caches["attn"][0].k.dtype == F8
    assert cluster.decode_engine.pool.n_used == 0


@pytest.fixture(scope="module")
def smollm():
    cfg_j = jax_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    mono = Engine(cfg, pt, max_batch=4, max_len=64, kv_dtype=F8,
                  device="cpu")
    ref = []
    for p in PROMPTS:
        r = Request(prompt_tokens=list(p), max_new_tokens=6)
        mono.run_request(r)
        ref.append(r.output_tokens)
    return cfg, pt, ref


CLUSTER = dict(paged=True, page_size=8, chunked_prefill=True,
               prefill_chunk=8, prefix_cache=True, n_prefill_pool_pages=33)


def test_fp8_cluster_equals_fp8_monolithic(smollm):
    cfg, pt, ref = smollm
    cluster = _fp8_cluster(cfg, pt, 4, **CLUSTER)
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=6)
            for p in PROMPTS]
    for r in reqs:
        cluster.submit(r)
    cluster.run_until_done()
    assert [r.output_tokens for r in reqs] == ref
    _no_leaks(cluster)


def test_fp8_continuous_equals_serial(smollm):
    cfg, pt, ref = smollm
    cluster = _fp8_cluster(cfg, pt, 2, **CLUSTER)
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=6)
            for p in PROMPTS]
    done = cluster.run_continuous(
        reqs, on_step=lambda step: cluster.prefill_engine
        .assert_no_page_leaks())
    assert len(done) == len(reqs)
    assert [r.output_tokens for r in reqs] == ref
    _no_leaks(cluster)


def test_kv_fp8_launcher_rebuilds_engines_not_decode_engine():
    """The port's --kv-fp8 replaces the engines through ``decode_engines``
    (the reference assigns the read-only ``decode_engine``, which raises
    AttributeError), keeping each engine's options."""
    cfg = get_config("smollm-135m").reduced()
    pt = from_numpy_params(jax.tree.map(
        np.asarray, jax_init_params(jax_get_config("smollm-135m").reduced(),
                                    jax.random.PRNGKey(0))), cfg,
        device="cpu")
    cluster = EPDCluster(cfg, pt, max_batch=2, max_len=32, device="cpu",
                         n_decode=2, preemption=True, **CLUSTER)
    old = [cluster.prefill_engine, *cluster.decode_engines]
    with_kv_dtype(cluster, F8)
    new = [cluster.prefill_engine, *cluster.decode_engines]
    for a, b in zip(old, new):
        assert a is not b and a.name == b.name
        assert b.kv_dtype == F8 and b.caches["attn"][0].k.dtype == F8
        assert b.caches["len"].dtype == torch.int32
        assert (b.paged, b.page_size, b.pool.n_pages, b.preemption,
                b.chunked_prefill, b.prefill_chunk,
                b.prefix_cache is None, b.cache_dtype) == (
            a.paged, a.page_size, a.pool.n_pages, a.preemption,
            a.chunked_prefill, a.prefill_chunk, a.prefix_cache is None,
            a.cache_dtype)
        assert b.metrics is cluster.metrics and b.tracer is cluster.tracer
    assert cluster.decode_engine is cluster.decode_engines[0]


def test_kv_fp8_launcher_drops_each_engine_before_building_its_successor():
    """``with_kv_dtype`` never holds an engine and its replacement at
    once: when ``make_engine`` builds one, the engine it replaces is
    already collected, so the bf16 and fp8 pools never coexist."""
    cfg = get_config("smollm-135m").reduced()
    pt = from_numpy_params(jax.tree.map(
        np.asarray, jax_init_params(jax_get_config("smollm-135m").reduced(),
                                    jax.random.PRNGKey(0))), cfg,
        device="cpu")
    cluster = EPDCluster(cfg, pt, max_batch=2, max_len=32, device="cpu",
                         n_decode=2, **CLUSTER)
    old = {("prefill", 0): weakref.ref(cluster.prefill_engine),
           **{("decode", i): weakref.ref(e)
              for i, e in enumerate(cluster.decode_engines)}}
    make, built = cluster.make_engine, []

    def checked(role, i, **kw):
        assert old[role, i]() is None, (role, i)
        built.append((role, i))
        return make(role, i, **kw)

    cluster.make_engine = checked
    with_kv_dtype(cluster, F8)
    assert built == [("prefill", 0), ("decode", 0), ("decode", 1)]
    assert all(e.kv_dtype == F8 for e in
               [cluster.prefill_engine, *cluster.decode_engines])


# ---------------------------------------------------------------------------
# the reference's own test (tests/test_variants.py:15)
# ---------------------------------------------------------------------------

def test_fp8_kv_cache_greedy_agreement():
    """fp8 KV storage must not change greedy decoding on a small model;
    the port's fp8 tokens are the reference's."""
    cfg_j = jax_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    B, S = 2, 10
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                       cfg.vocab), np.int32)
    seqs = {}
    for name, kvd in [("f32", None), ("fp8", F8)]:
        c = T.make_caches(cfg, B, 32, dtype=torch.float32, kv_dtype=kvd)
        assert c["attn"][0].k.dtype == (kvd or torch.float32)
        assert c["attn"][0].kv_pos.dtype == torch.int32
        lg, c = M.prefill_forward(pt, cfg, torch.from_numpy(toks), c,
                                  lengths=torch.tensor([S] * B,
                                                       dtype=torch.int32))
        t = torch.argmax(lg, -1).to(torch.int32)
        out = []
        for _ in range(5):
            lg, c = M.decode_forward(pt, cfg, t, c)
            t = torch.argmax(lg, -1).to(torch.int32)
            out.append(t.numpy())
        seqs[name] = np.stack(out)
    agree = (seqs["f32"] == seqs["fp8"]).mean()
    assert agree >= 0.6, agree
    c = JT.make_caches(cfg_j, B, 32, dtype=jnp.float32,
                       kv_dtype=jnp.float8_e4m3fn)
    lg, c = JM.prefill_forward(pj, cfg_j, jnp.asarray(toks), c,
                               lengths=jnp.array([S] * B))
    t = jnp.argmax(lg, -1)
    want = []
    for _ in range(5):
        lg, c = JM.decode_forward(pj, cfg_j, t, c)
        t = jnp.argmax(lg, -1)
        want.append(np.asarray(t))
    np.testing.assert_array_equal(seqs["fp8"], np.stack(want))
