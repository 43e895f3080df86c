"""The port's encoder-decoder (whisper-class) path against the JAX
package's, on ``get_config("whisper-base").reduced()`` in f32.

* Model: ``run_encoder``, ``compute_cross_kv``, ``cross_attention_block``
  and the prefill / decode logits (dense and paged) against the
  reference, with its parameters carried across by
  ``convert.from_numpy_params`` and every other input made with numpy
  from a seed.
* Serving: greedy tokens equal the reference's in every mode it serves
  whisper (monolithic engine, E->P->D cluster, continuous batching,
  dense and paged, paged preemption), with both packages fed the port's
  stub frames; inside the port, continuous == serial and faulted ==
  zero-fault bitwise, no page leaks, the accountant closes.
* Boundaries: the options the reference refuses for an encoder model
  raise its ValueError, and the decode cache's cross-KV stays the same
  tensors across inserts (a replayed decode graph reads it there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.frontend as jax_frontend  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.cluster import EPDCluster as JaxCluster  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.core.cluster import EPDCluster  # noqa: E402
from repro_torch.core.faults import (SITE_STORE_FETCH, ArmedFault,  # noqa: E402
                                     FaultPlan)
from repro_torch.models import frontend as FE  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.transformer import cache_tensors  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN, PAGE = 48, 8
jax_encoder = jax.jit(JT.run_encoder, static_argnums=(1,))
jax_cross_kv = jax.jit(JL.compute_cross_kv, static_argnums=(3,))
jax_cross_block = jax.jit(JL.cross_attention_block, static_argnums=(4,))
jax_prefill = jax.jit(JM.prefill_forward, static_argnums=(1,))
jax_decode = jax.jit(JM.decode_forward, static_argnums=(1,))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.fixture(scope="module")
def whisper():
    cfg_j = jax_get_config("whisper-base").reduced()
    cfg = get_config("whisper-base").reduced()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    return cfg_j, cfg, pj, pt


@pytest.fixture(scope="module")
def port_frames():
    """Both packages draw the port's stub frames (the reference draws its
    own from jax.random), for the whole module."""
    def frames(cfg_, payload, n_tokens=0, dtype=None):
        cfg = get_config("whisper-base").reduced()
        return jnp.asarray(FE.stub_embeddings(cfg, payload, n_tokens).numpy())

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_frontend, "stub_embeddings", frames)
        yield


def _frames(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.frontend.tokens_per_item,
                                cfg.frontend.feature_dim),
                               dtype=np.float32) * np.float32(0.02)


def _layer(pj, pt, r=0):
    return (jax.tree.map(lambda a: a[r], pj["blocks"][0]["attn"]),
            {k: v[r] for k, v in pt["blocks"][0]["attn"].items()})


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def test_run_encoder_matches_jax(whisper):
    cfg_j, cfg, pj, pt = whisper
    frames = _frames(cfg, 2, 0)
    hj, pos_j = jax_encoder(pj, cfg_j, jnp.asarray(frames))
    ht, pos_t = T.run_encoder(pt, cfg, torch.from_numpy(frames))
    _close(ht, hj, LAYER_TOL)
    assert np.array_equal(_np(pos_t), _np(pos_j))
    assert pos_t.dtype == torch.int32


@pytest.mark.parametrize("s", [1, 9], ids=["decode", "prefill"])
def test_cross_kv_and_cross_attention_block(whisper, s):
    """Cross-KV from an encoder output, then cross-attention of s decoder
    tokens (some padding, position -1) over it with the encoder's tail
    empty (enc_pos -1); every layer's weights."""
    cfg_j, cfg, pj, pt = whisper
    rng = np.random.default_rng(s)
    t = cfg.encoder.n_ctx
    enc = rng.standard_normal((2, t, cfg.d_model), dtype=np.float32)
    enc_pos = np.tile(np.arange(t, dtype=np.int32), (2, 1))
    enc_pos[1, 20:] = -1
    x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1)) + 3
    pos[1, s // 2 + 1:] = -1
    for r in range(cfg.n_repeats):
        aj, at = _layer(pj, pt, r)
        kvj = jax_cross_kv(aj, jnp.asarray(enc), jnp.asarray(enc_pos), cfg_j)
        kvt = L.compute_cross_kv(at, torch.from_numpy(enc),
                                 torch.from_numpy(enc_pos), cfg)
        for a, b in zip(kvt, kvj):
            _close(a, b, LAYER_TOL)
        _close(L.cross_attention_block(at, torch.from_numpy(x),
                                       torch.from_numpy(pos), kvt, cfg),
               jax_cross_block(aj, jnp.asarray(x), jnp.asarray(pos), kvj,
                               cfg_j), LAYER_TOL)


def _caches(cfg_j, cfg, layout):
    if layout == "dense":
        return (JT.make_caches(cfg_j, 1, MAX_LEN, dtype=jnp.float32),
                T.make_caches(cfg, 1, MAX_LEN, dtype=torch.float32))
    kw = dict(layout="paged", page_size=PAGE, n_pages=1 + MAX_LEN // PAGE)
    cj = JT.make_caches(cfg_j, 1, MAX_LEN, dtype=jnp.float32, **kw)
    ct = T.make_caches(cfg, 1, MAX_LEN, dtype=torch.float32, **kw)
    row = np.arange(1, 1 + MAX_LEN // PAGE, dtype=np.int32)[::-1].copy()
    cj["pages"] = jnp.asarray(row[None])
    ct["pages"][0] = torch.from_numpy(row)
    return cj, ct


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_and_decode_logits(whisper, layout):
    """The padded prefill (encoder inside) and three decode steps over
    the cross cache; the cross cache holds the reference's cross-KV in
    its first T slots and nothing (enc_pos -1) after them."""
    cfg_j, cfg, pj, pt = whisper
    frames = _frames(cfg, 1, 5)
    text = np.random.default_rng(6).integers(1, cfg.vocab, size=13)
    toks = np.zeros((1, MAX_LEN), np.int32)
    toks[0, :len(text)] = text
    cj, ct = _caches(cfg_j, cfg, layout)
    lj, cj = jax_prefill(pj, cfg_j, jnp.asarray(toks), cj,
                         lengths=jnp.asarray([len(text)], jnp.int32),
                         enc_frames=jnp.asarray(frames))
    lt, ct = M.prefill_forward(pt, cfg, torch.from_numpy(toks), ct,
                               lengths=torch.tensor([len(text)],
                                                    dtype=torch.int32),
                               enc_frames=torch.from_numpy(frames))
    _close(lt, lj, LOGIT_TOL)
    n = cfg.frontend.tokens_per_item
    for a, b in zip(ct["cross"], cj["cross"]):
        assert tuple(a.shape[:2]) == tuple(b.shape[:2])
        _close(a[:, :, :n], b, LAYER_TOL)
    assert bool((ct["cross"].enc_pos[:, :, n:] == -1).all())
    for tok in (3, 11, 7):
        lj, cj = jax_decode(pj, cfg_j, jnp.asarray([tok], jnp.int32), cj)
        lt, ct = M.decode_forward(pt, cfg, torch.tensor([tok],
                                                        dtype=torch.int32), ct)
        _close(lt, lj, LOGIT_TOL)
        assert int(ct["len"][0]) == int(cj["len"][0])


# ---------------------------------------------------------------------------
# serving: greedy tokens against the reference
# ---------------------------------------------------------------------------

def _reqs(cls, n_new=5):
    """Three audio requests; the first and third share one payload, so
    the MM Store dedups."""
    return [cls(prompt_tokens=[1, 2, 3], max_new_tokens=n_new,
                mm_payload=b"audio-0", mm_tokens=0),
            cls(prompt_tokens=[7, 4, 9, 9, 2, 5], max_new_tokens=n_new,
                mm_payload=b"audio-1", mm_tokens=0),
            cls(prompt_tokens=[3, 8, 1, 6], max_new_tokens=n_new,
                mm_payload=b"audio-0", mm_tokens=0)]


MODES = {"dense": {}, "paged": dict(paged=True, page_size=PAGE)}


@pytest.fixture(scope="module")
def ref_tokens(whisper, port_frames):
    """The reference's monolithic engine on ``_reqs``, and its cluster's
    tokens in each mode (which equal them: checked here)."""
    cfg_j, _, pj, _ = whisper
    mono = JaxEngine(cfg_j, pj, max_batch=2, max_len=MAX_LEN)
    ref = []
    for r in _reqs(JaxRequest):
        mono.run_request(r)
        ref.append(r.output_tokens)
    for kw in MODES.values():
        cl = JaxCluster(cfg_j, pj, max_batch=2, max_len=MAX_LEN, **kw)
        rs = _reqs(JaxRequest)
        for r in rs:
            cl.submit(r)
        cl.run_until_done()
        assert [r.output_tokens for r in rs] == ref
    return ref


def _audit(cl):
    """Page-leak audit, also at an iteration boundary."""
    for eng in [cl.prefill_engine, *cl.decode_engines]:
        if eng.paged:
            eng.assert_no_page_leaks()


def _assert_no_leaks(cl):
    """After the drain: no leaks, and both pools empty."""
    _audit(cl)
    for eng in [cl.prefill_engine, *cl.decode_engines]:
        if eng.paged:
            assert eng.pool.n_used == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_jax(whisper, ref_tokens, mode):
    _, cfg, _, pt = whisper
    eng = Engine(cfg, pt, max_batch=2, max_len=MAX_LEN, device="cpu",
                 **MODES[mode])
    out = []
    for r in _reqs(Request):
        eng.run_request(r)
        out.append(r.output_tokens)
    assert out == ref_tokens


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cluster_matches_jax(whisper, ref_tokens, mode):
    """tests/test_engine_edge.py::test_whisper_epd_serving and
    tests/test_paged.py::test_paged_cluster_e2e_whisper on the port:
    every request completes with the reference's tokens; raw frames go
    through the MM Store (one dedup hit); on the paged cluster the KV
    plans move whole page slices and both pools drain."""
    _, cfg, _, pt = whisper
    cl = EPDCluster(cfg, pt, max_batch=2, max_len=MAX_LEN, device="cpu",
                    **MODES[mode])
    reqs = _reqs(Request)
    for r in reqs:
        cl.submit(r)
    done = cl.run_until_done()
    assert len(done) == 3 and [r.output_tokens for r in reqs] == ref_tokens
    assert cl.store.stats.hits == 1 and cl.store.stats.misses == 2
    if mode == "paged":
        assert cl.decode_engine.kv_insert_bytes_total > 0
        page_layer = cl.cost.kv_page_bytes_per_layer()
        assert page_layer > 0
        for p in cl.report.kv_plans:
            for g in p.groups:
                assert g.nbytes % page_layer == pytest.approx(0.0, abs=1e-6)
            payload = sum(g.nbytes for g in p.groups)
            raw = cl.decode_engine.kv_insert_bytes
            assert payload < raw + cfg.n_layers * page_layer + 1
        _assert_no_leaks(cl)


def _conserved(cl):
    """Router ledgers back to zero, no page leaks, accountant closed."""
    for name, st in cl.router.status.items():
        assert st.pending_tokens == 0.0, name
        assert st.pending_by_req == {}, name
    _assert_no_leaks(cl)
    cl.acc.assert_all_closed()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_continuous_matches_serial(whisper, ref_tokens, mode):
    """tests/test_batching_faults.py::test_whisper_continuous_matches_serial
    on the port: enc-dec requests run as monolithic prefill jobs, with the
    serial run's tokens bitwise, and the reference's."""
    _, cfg, _, pt = whisper
    kw = dict(max_batch=2, max_len=MAX_LEN, device="cpu", **MODES[mode])
    c0 = EPDCluster(cfg, pt, **kw)
    serial = _reqs(Request)
    for r in serial:
        c0.submit(r)
    c0.run_until_done()
    c1 = EPDCluster(cfg, pt, **kw)
    rs = _reqs(Request)
    done = c1.run_continuous(rs, on_step=lambda step: _audit(c1))
    assert len(done) == len(rs) and not c1.report.lost
    assert [r.output_tokens for r in rs] == [r.output_tokens for r in serial]
    assert [r.output_tokens for r in rs] == ref_tokens
    _conserved(c1)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["run_until_done", "run_continuous"])
def test_store_miss_recomputes_frames(whisper, ref_tokens, continuous):
    """Every MM Store fetch fails: the Prefill side recomputes the raw
    frames (``core/cluster.py``'s recompute arms, the continuous one then
    prefilling from ``job.meta``), and completed tokens equal the
    zero-fault run's."""
    _, cfg, _, pt = whisper
    plan = FaultPlan(seed=2, rates={SITE_STORE_FETCH: 1.0})
    cl = EPDCluster(cfg, pt, max_batch=2, max_len=MAX_LEN, device="cpu",
                    faults=plan, **MODES["paged"])
    rs = _reqs(Request)
    if continuous:
        done = cl.run_continuous(rs)
    else:
        for r in rs:
            cl.submit(r)
        done = cl.run_until_done()
    assert cl.report.recomputes >= 2
    assert not cl.report.lost and len(done) == len(rs)
    assert [r.output_tokens for r in rs] == ref_tokens
    if continuous:
        _conserved(cl)
    else:
        _assert_no_leaks(cl)


def test_store_miss_armed_on_one_payload(whisper, ref_tokens):
    """One armed fetch fault on the shared payload's key, with retries:
    the faulted cluster gives the zero-fault tokens."""
    _, cfg, _, pt = whisper
    key = FE.content_hash(b"audio-0")
    plan = FaultPlan(seed=1, armed=[ArmedFault(SITE_STORE_FETCH, key=key,
                                               count=1)])
    cl = EPDCluster(cfg, pt, max_batch=2, max_len=MAX_LEN, device="cpu",
                    faults=plan)
    rs = _reqs(Request)
    done = cl.run_continuous(rs)
    assert not cl.report.lost and len(done) == len(rs)
    assert [r.output_tokens for r in rs] == ref_tokens
    _conserved(cl)


@pytest.mark.parametrize("opts", [dict(prefix_cache=True),
                                  dict(chunked_prefill=True,
                                       prefill_chunk=16)],
                         ids=["prefix_cache", "chunked_prefill"])
def test_refused_options_raise_as_the_reference(whisper, opts):
    cfg_j, cfg, pj, pt = whisper
    kw = dict(max_batch=2, max_len=MAX_LEN, paged=True, page_size=PAGE,
              **opts)
    for make in (lambda: JaxEngine(cfg_j, pj, **kw),
                 lambda: JaxCluster(cfg_j, pj, **kw)):
        with pytest.raises(ValueError, match="cross-KV"):
            make()
    for make in (lambda: Engine(cfg, pt, device="cpu", **kw),
                 lambda: EPDCluster(cfg, pt, device="cpu", **kw)):
        with pytest.raises(ValueError, match="cross-KV"):
            make()


def test_preemption_as_the_reference(whisper, ref_tokens):
    """The reference serves whisper with page-level preemption (the cross
    side state rides the swap) and refuses it only without pages; the
    port does the same, and a preempted, resumed request keeps its
    tokens while another request holds the slot it left."""
    cfg_j, cfg, pj, pt = whisper
    with pytest.raises(ValueError, match="paged"):
        JaxEngine(cfg_j, pj, max_batch=2, max_len=MAX_LEN, preemption=True)
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, pt, max_batch=2, max_len=MAX_LEN, preemption=True,
               device="cpu")
    eng = Engine(cfg, pt, max_batch=2, max_len=MAX_LEN, device="cpu",
                 preemption=True, **MODES["paged"])
    a, b, c = _reqs(Request)
    for r in (a, b):
        f, p = eng.prefill_request(r, None, FE.stub_embeddings(
            cfg, r.mm_payload)[None])
        eng.insert(r, p, f)
    eng.decode_step()
    eng.preempt_slot(eng.slots.index(a))
    f, p = eng.prefill_request(c, None, FE.stub_embeddings(
        cfg, c.mm_payload)[None])
    eng.insert(c, p, f)                # c takes a's slot and its cross-KV
    while eng.n_active or eng.preempted:
        eng.decode_step()
    assert [r.output_tokens for r in (a, b, c)] == ref_tokens
    assert eng.preempt_count == 1 and eng.resume_count == 1
    eng.assert_no_page_leaks()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cross_cache_keeps_its_tensors_across_inserts(whisper, mode):
    """Inserts write the cross-KV into the decode cache in place: every
    cache tensor keeps its ``data_ptr`` (a replayed decode graph reads
    it there), and the slot holds the inserted request's cross-KV."""
    _, cfg, _, pt = whisper
    eng = Engine(cfg, pt, max_batch=2, max_len=MAX_LEN, device="cpu",
                 **MODES[mode])
    ptrs = [t.data_ptr() for t in cache_tensors(eng.caches)]
    n = cfg.frontend.tokens_per_item
    for r in _reqs(Request, n_new=3):
        f, payload = eng.prefill_request(r, None, FE.stub_embeddings(
            cfg, r.mm_payload)[None])
        cross = payload.side["cross"] if eng.paged else payload["cross"]
        slot = eng.insert(r, payload, f)
        for dst, src in zip(eng.caches["cross"], cross):
            assert torch.equal(dst[:, slot], src[:, 0])
        assert bool((eng.caches["cross"].enc_pos[:, slot, :n] >= 0).all())
        while any(s is r for s in eng.slots):
            eng.decode_step()
        assert [t.data_ptr() for t in cache_tensors(eng.caches)] == ptrs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_graph_steps_hold_the_cross_cache(whisper, mode, monkeypatch):
    """The decode step's graph key and state tensors include the cross
    cache, and every decode step shares one key; the dense prefill (the
    encoder inside) is one key too, with the frames among its inputs;
    the paged prefill stays eager."""
    from repro_torch.serving.graphs import GraphStep, graph_key
    keys, states = {}, {}
    real = GraphStep.__call__

    def spy(self, state, *inputs):
        key, st, it = graph_key(state, inputs)
        keys.setdefault(self.fn.__name__, set()).add(key)
        states[self.fn.__name__] = ({t.data_ptr() for t in st},
                                    [tuple(t.shape) for t in it])
        return real(self, state, *inputs)

    monkeypatch.setattr(GraphStep, "__call__", spy)
    _, cfg, _, pt = whisper
    eng = Engine(cfg, pt, max_batch=2, max_len=MAX_LEN, device="cpu",
                 **MODES[mode])
    for r in _reqs(Request, n_new=3):
        eng.run_request(r)
    assert len(keys["decode"]) == 1
    assert {t.data_ptr() for t in eng.caches["cross"]} <= states["decode"][0]
    if mode == "paged":
        assert "dense_prefill" not in keys
    else:
        assert len(keys["dense_prefill"]) == 1
        frames = (1, cfg.frontend.tokens_per_item, cfg.frontend.feature_dim)
        assert frames in states["dense_prefill"][1]
        assert {t.data_ptr() for t in eng._prefill_caches["cross"]} <= \
            states["dense_prefill"][0]
