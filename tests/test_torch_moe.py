"""The port's MoE family against the JAX package's.

* ``moe_block`` (output, aux loss, top-k experts and kept selections) of
  reduced mixtral-8x7b (top-2), llama4-scout-17b-a16e (top-1) and
  jamba-v0.1-52b (top-2, in its hybrid stack), at the configs' capacity
  factor 1.25, which drops selections, and at 8.0 (dropless), for a
  decode step, a padded prompt and a suffix window with dummy slots.
* The logits of prefill and decode (dense, paged, suffix) and the
  counterparts of the reference's ``decode_matches_prefill`` and
  ``swa_ring_buffer_wraparound`` (``tests/test_models.py``).
* Serving: the port's clusters give the reference's greedy tokens in
  each cache layout. At 1.25 the reference's own chunked + prefix mode
  differs from its monolithic engine (capacity is computed per prefill
  window), and the port matches it there too; at 8.0 every mode agrees.
  llama4-scout with an image E->P->D; jamba on the dense and paged
  clusters. Inside the port, bitwise: continuous == serial, faulted ==
  zero-fault (dropless; at 1.25 the reference's recovery changes tokens,
  and the port's faulted run gives the reference's), and no page leaks.

Parameters come from the reference's ``init_params`` through
``from_numpy_params``; other inputs are made with numpy from a seed and
handed to both. f32 throughout.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.frontend as jax_frontend  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.cluster import EPDCluster as JaxCluster  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.core.cluster import EPDCluster  # noqa: E402
from repro_torch.core.faults import (SITE_TRANSFER_HANDSHAKE,  # noqa: E402
                                     SITE_TRANSFER_WIRE, ArmedFault,
                                     FaultPlan)
from repro_torch.models import frontend as FE  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e", "jamba-v0.1-52b"]
TEXT_MOE = ARCHS[:2]               # attention-only: every serving mode
MAX_LEN, PAGE = 64, 8
PROMPTS = [list(range(3, 30)), [9, 2, 6, 5],
           [(5 * i + 1) % 500 for i in range(41)]]
MODES = {
    "dense": {},
    "paged": dict(paged=True, page_size=PAGE),
    "chunked": dict(paged=True, page_size=PAGE, chunked_prefill=True,
                    prefill_chunk=8, prefix_cache=True,
                    n_prefill_pool_pages=33),
}
jax_prefill = jax.jit(JM.prefill_forward, static_argnums=(1,))
jax_decode = jax.jit(JM.decode_forward, static_argnums=(1,))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


def _with_capacity(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


_MODELS = {}


def _models(arch, cf=1.25):
    """(JAX config, port config, JAX params, port params), reduced, with
    capacity factor ``cf``; made once per (arch, cf)."""
    if (arch, cf) not in _MODELS:
        cfg_j = _with_capacity(jax_get_config(arch).reduced(), cf)
        cfg = _with_capacity(get_config(arch).reduced(), cf)
        pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
        pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg,
                               device="cpu")
        _MODELS[arch, cf] = cfg_j, cfg, pj, pt
    return _MODELS[arch, cf]


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

def _block_input(cfg, case):
    """x (B, S, d): a decode step (3 rows of one token), a prompt of 17
    tokens padded to 24 (the padding rows all one embedding, as token 0
    gives) on 2 rows, or a suffix window of 24 whose first 10 slots are
    dummies (one embedding) before the real tokens."""
    rng = np.random.default_rng(11)
    d = cfg.d_model
    if case == "decode":
        return rng.standard_normal((3, 1, d), dtype=np.float32)
    x = rng.standard_normal((2 if case == "prompt" else 1, 24, d),
                            dtype=np.float32)
    fill = rng.standard_normal((d,), dtype=np.float32)
    if case == "prompt":
        x[:, 17:] = fill
    else:
        x[:, :10] = fill
    return x


def _jax_block(p, x, cfg_j):
    """The reference's ``moe_block`` (output, aux), and the top-k experts
    and kept mask of its dispatch (the same ops as
    ``repro/models/moe.py:47-71``), compiled as one function."""
    out, aux = JMOE.moe_block(p, x, cfg_j)
    h = JMOE.rms_norm(x, p["norm"], cfg_j.norm_eps)
    probs = jax.nn.softmax(h.astype(jnp.float32) @ p["router"], axis=-1)
    _, eidx = jax.lax.top_k(probs, cfg_j.moe.top_k)
    fe = eidx.reshape(x.shape[0], -1)
    counts = jnp.sum(jax.nn.one_hot(fe, cfg_j.moe.n_experts,
                                    dtype=jnp.int32), axis=1)
    starts = jnp.cumsum(counts, axis=1) - counts
    sorted_e = jnp.take_along_axis(fe, jnp.argsort(fe, axis=1), axis=1)
    pos = jnp.arange(fe.shape[1])[None] - jnp.take_along_axis(
        starts, sorted_e, axis=1)
    return out, aux, eidx, pos < JMOE.capacity(cfg_j, x.shape[1])


jax_block = jax.jit(_jax_block, static_argnums=(2,))


@pytest.mark.parametrize("case", ["decode", "prompt", "suffix"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, cf, case):
    cfg_j, cfg, pj, pt = _models(arch, cf)
    i = next(i for i, s in enumerate(cfg.pattern) if s.ffn == "moe")
    mj = jax.tree.map(lambda a: a[0], pj["blocks"][i]["moe"])
    mt = {k: v[0] for k, v in pt["blocks"][i]["moe"].items()}
    x = _block_input(cfg, case)
    S = x.shape[1]
    assert MOE.capacity(cfg, S) == JMOE.capacity(cfg_j, S)
    oj, aj, eidx_j, keep_j = jax_block(mj, jnp.asarray(x), cfg_j)
    ot, at = MOE.moe_block(mt, torch.from_numpy(x), cfg)
    _close(ot, oj)
    _close(at, aj)
    assert at.dtype == torch.float32 and at.shape == ()
    # routing: the same experts, and the same selections dropped
    h = MOE.rms_norm(torch.from_numpy(x), mt["norm"], cfg.norm_eps)
    _, _, eidx = MOE.route(mt, h, cfg)
    _, _, pos, _, _ = MOE.dispatch(eidx, cfg.moe.n_experts)
    keep = (pos < MOE.capacity(cfg, S)).numpy()
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(eidx_j))
    np.testing.assert_array_equal(keep, np.asarray(keep_j))
    if cf == 8.0 or case == "decode":      # C = 1 at S = 1 drops nothing
        assert keep.all()
    elif case == "suffix":                 # the dummies fill an expert first
        assert not keep.all()


# ---------------------------------------------------------------------------
# caches, logits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("for_decode", [False, True])
def test_make_caches_for_decode(layout, for_decode):
    """for_decode clamps a dense sliding-window cache to the window (a ring
    buffer), as the reference's; the paged pool is never clamped."""
    cfg_j, cfg, _, _ = _models("mixtral-8x7b")
    kw = dict(layout=layout, page_size=PAGE, n_pages=9) \
        if layout == "paged" else {}
    cj = JT.make_caches(cfg_j, 2, 128, dtype=jnp.float32,
                        for_decode=for_decode, **kw)
    ct = T.make_caches(cfg, 2, 128, for_decode=for_decode, **kw)
    got = [tuple(t.shape) for t in T.cache_tensors(ct)]
    assert got == [tuple(a.shape) for a in jax.tree.leaves(cj)]
    if layout == "dense":
        assert ct["attn"][0].k.shape[2] == (cfg.sliding_window if for_decode
                                            else 128)


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


def _prefill_both(m, cj, ct, toks, n, **kw):
    cfg_j, cfg, pj, pt = m
    kwj = dict(lengths=jnp.asarray([n], jnp.int32))
    kwt = dict(lengths=torch.tensor([n], dtype=torch.int32))
    if kw:
        kwj.update(prefix_len=jnp.asarray(kw["prefix_len"]),
                   pos_base=jnp.asarray(kw["pos_base"]))
        kwt.update(kw)
    lj, cj = jax_prefill(pj, cfg_j, jnp.asarray(toks), cj, **kwj)
    lt, ct = M.prefill_forward(pt, cfg, torch.from_numpy(toks), ct, **kwt)
    _close(lt, lj)
    assert int(lt.argmax()) == int(jnp.argmax(lj))
    return cj, ct


def _decode_both(m, cj, ct, tokens):
    cfg_j, cfg, pj, pt = m
    for tok in tokens:
        lj, cj = jax_decode(pj, cfg_j, jnp.asarray([tok], jnp.int32), cj)
        lt, ct = M.decode_forward(pt, cfg, torch.tensor([tok],
                                                        dtype=torch.int32), ct)
        _close(lt, lj)
        assert int(lt.argmax()) == int(jnp.argmax(lj))
    return cj, ct


def _text(cfg, n, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab, size=n).astype(
        np.int32)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits(arch, layout):
    """A 29-token prompt padded to max_len (C = 40 of 128 selections at
    top-2), then 3 decode steps; greedy tokens equal."""
    m = _models(arch)
    text = _text(m[1], 29, 8)
    toks = np.zeros((1, MAX_LEN), np.int32)
    toks[0, :len(text)] = text
    cj, ct = _caches(m[0], m[1], layout)
    cj, ct = _prefill_both(m, cj, ct, toks, len(text))
    _decode_both(m, cj, ct, [3, 11, 7])


@pytest.mark.parametrize("prefix_len", [16, 20])
@pytest.mark.parametrize("arch", TEXT_MOE)
def test_suffix_prefill_logits(arch, prefix_len):
    """Paged prefill of a prefix, then the suffix window against it (its
    dummy slots below prefix_len route and take capacity as the
    reference's do), then decode."""
    m = _models(arch)
    text = _text(m[1], 37, 9)
    cj, ct = _caches(m[0], m[1], "paged")
    toks = np.zeros((1, -(-prefix_len // PAGE) * PAGE), np.int32)
    toks[0, :prefix_len] = text[:prefix_len]
    cj, ct = _prefill_both(m, cj, ct, toks, prefix_len)
    pos_base = prefix_len // PAGE * PAGE
    win = -(-len(text) // PAGE) * PAGE - pos_base
    sfx = np.zeros((1, win), np.int32)
    sfx[0, prefix_len - pos_base:len(text) - pos_base] = text[prefix_len:]
    cj, ct = _prefill_both(m, cj, ct, sfx, len(text), prefix_len=prefix_len,
                           pos_base=pos_base)
    _decode_both(m, cj, ct, [4, 9])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """``tests/test_models.py``'s decode_matches_prefill in the port:
    decoding token t against a cache prefilled to t - 1 equals prefilling
    all t tokens (dropless capacity), with the reference's tolerance."""
    _, cfg, _, pt = _models(arch, 8.0)
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32))
    log_a, _ = M.prefill_forward(pt, cfg, toks, T.make_caches(cfg, b, 32),
                                 lengths=torch.full((b,), s,
                                                    dtype=torch.int32))
    _, cb = M.prefill_forward(pt, cfg, toks[:, :s - 1],
                              T.make_caches(cfg, b, 32),
                              lengths=torch.full((b,), s - 1,
                                                 dtype=torch.int32))
    log_b, _ = M.decode_forward(pt, cfg, toks[:, s - 1], cb)
    _close(log_a, log_b, atol=2e-3, rtol=1e-3)


def test_swa_ring_buffer_wraparound():
    """``tests/test_models.py``'s swa_ring_buffer_wraparound in the port:
    window 8, a window-sized ring buffer (for_decode) decodes as an
    oversized cache does; the ring's logits also equal the reference's."""
    cfg_j, cfg, pj, pt = _models("mixtral-8x7b", 8.0)
    cfg_j = dataclasses.replace(cfg_j, sliding_window=8)
    cfg = dataclasses.replace(cfg, sliding_window=8)
    b, n_pre, n_dec = 1, 6, 10
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(b, n_pre + n_dec)).astype(np.int32)

    def run_port(for_decode):
        caches = T.make_caches(cfg, b, 64, for_decode=for_decode)
        logits, caches = M.prefill_forward(
            pt, cfg, torch.from_numpy(toks[:, :n_pre]), caches,
            lengths=torch.full((b,), n_pre, dtype=torch.int32))
        out = []
        for i in range(n_dec):
            logits, caches = M.decode_forward(
                pt, cfg, torch.from_numpy(toks[:, n_pre + i]), caches)
            out.append(logits)
        return torch.stack(out), caches

    big, _ = run_port(False)
    ring, caches = run_port(True)
    assert caches["attn"][0].k.shape[2] == 8
    _close(big, ring, atol=2e-3, rtol=1e-3)
    cj = JT.make_caches(cfg_j, b, 64, dtype=jnp.float32, for_decode=True)
    _, cj = jax_prefill(pj, cfg_j, jnp.asarray(toks[:, :n_pre]), cj,
                        lengths=jnp.full((b,), n_pre, jnp.int32))
    for i in range(n_dec):
        lj, cj = jax_decode(pj, cfg_j, jnp.asarray(toks[:, n_pre + i]), cj)
        _close(ring[i], lj)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

_JAX_TOKENS = {}


def _jax_tokens(arch, cf, mode):
    """The reference's greedy tokens on PROMPTS: its monolithic engine
    ("mono"), or its cluster in ``mode``."""
    if (arch, cf, mode) not in _JAX_TOKENS:
        cfg_j, _, pj, _ = _models(arch, cf)
        reqs = [JaxRequest(prompt_tokens=list(p), max_new_tokens=6)
                for p in PROMPTS]
        if mode == "mono":
            eng = JaxEngine(cfg_j, pj, max_batch=4, max_len=MAX_LEN)
            for r in reqs:
                eng.run_request(r)
        else:
            cluster = JaxCluster(cfg_j, pj, max_batch=4, max_len=MAX_LEN,
                                 **MODES[mode])
            for r in reqs:
                cluster.submit(r)
            cluster.run_until_done()
        _JAX_TOKENS[arch, cf, mode] = [r.output_tokens for r in reqs]
    return _JAX_TOKENS[arch, cf, mode]


def _assert_no_leaks(cluster):
    for eng in [cluster.prefill_engine, *cluster.decode_engines]:
        if eng.paged and not eng.crashed:
            eng.assert_no_page_leaks()
    assert cluster.decode_engine.pool.n_used == 0


def _serve(arch, cf, mode, **kw):
    _, cfg, _, pt = _models(arch, cf)
    cluster = EPDCluster(cfg, pt, max_batch=4, max_len=MAX_LEN, device="cpu",
                         **MODES[mode], **kw)
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=6)
            for p in PROMPTS]
    for r in reqs:
        cluster.submit(r)
    cluster.run_until_done()
    if mode != "dense":
        _assert_no_leaks(cluster)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", TEXT_MOE)
def test_disaggregation_matches_jax(arch, cf, mode):
    """The port's E->P->D cluster gives the reference's tokens in each
    mode: the monolithic engine's for dense and paged (the reference's own
    dense = paged = mono), and at capacity 1.25 its chunked + prefix
    cluster's for chunked, which differ from mono. At 8.0 (dropless)
    every mode gives mono's tokens."""
    mono = _jax_tokens(arch, cf, "mono")
    want = mono
    if mode == "chunked" and cf == 1.25:
        want = _jax_tokens(arch, cf, "chunked")
        assert want != mono
    assert _serve(arch, cf, mode) == want


@pytest.mark.parametrize("arch", TEXT_MOE)
def test_continuous_equals_serial(arch):
    """run_continuous over the chunked + prefix cluster gives the serial
    run's tokens bitwise, and leaks no page."""
    _, cfg, _, pt = _models(arch)
    cluster = EPDCluster(cfg, pt, max_batch=2, max_len=MAX_LEN, device="cpu",
                         **MODES["chunked"])
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=6)
            for p in PROMPTS]
    done = cluster.run_continuous(
        reqs, on_step=lambda step: cluster.prefill_engine
        .assert_no_page_leaks())
    assert len(done) == len(reqs)
    assert [r.output_tokens for r in reqs] == _serve(arch, 1.25, "chunked")
    _assert_no_leaks(cluster)


FAULT_KW = dict(max_batch=2, max_len=MAX_LEN, n_decode=2, **MODES["chunked"])


def _fault_reqs(cls):
    """The faulted runs' requests, with the same ids in both packages:
    the injected transfer faults are keyed by request id."""
    return [cls(prompt_tokens=list(range(3 + i, 14 + 3 * i)),
                max_new_tokens=8, request_id=900 + i) for i in range(4)]


def _fault_plan(cls_plan, cls_armed, wire, handshake):
    return cls_plan(seed=1, rates={wire: 0.3, handshake: 0.2},
                    armed=[cls_armed("decode.crash", key=(0, 5))])


def _faulted_port(arch, cf):
    """(zero-fault tokens, faulted tokens) of the port's continuous
    chunked cluster under transfer faults and a decode crash."""
    _, cfg, _, pt = _models(arch, cf)
    ref = _fault_reqs(Request)
    EPDCluster(cfg, pt, device="cpu", **FAULT_KW).run_continuous(ref)
    rs = _fault_reqs(Request)
    cl = EPDCluster(cfg, pt, device="cpu", faults=_fault_plan(
        FaultPlan, ArmedFault, SITE_TRANSFER_WIRE, SITE_TRANSFER_HANDSHAKE),
        **FAULT_KW)
    done = cl.run_continuous(rs)
    assert cl.report.instance_crashes == 1
    assert not cl.report.lost and len(done) == len(rs)
    _assert_no_leaks(cl)
    return ([r.output_tokens for r in ref], [r.output_tokens for r in rs])


def test_faulted_continuous_equals_zero_fault():
    """Transfer faults plus a decode crash re-route onto the survivor;
    at dropless capacity the completed tokens equal the zero-fault run's,
    bitwise."""
    clean, faulted = _faulted_port("mixtral-8x7b", 8.0)
    assert faulted == clean


def test_faulted_continuous_matches_jax():
    """At capacity 1.25 the crash's recovery recomputes the lost requests
    through prefill windows that drop other selections than their decode
    steps did, so the reference's faulted tokens differ from its
    zero-fault ones (ROADMAP Queue 3); the port gives the reference's
    tokens in both runs."""
    from repro.core.faults import (SITE_TRANSFER_HANDSHAKE as J_HS,
                                   SITE_TRANSFER_WIRE as J_WIRE)
    from repro.core.faults import ArmedFault as JaxArmed
    from repro.core.faults import FaultPlan as JaxPlan
    cfg_j, _, pj, _ = _models("mixtral-8x7b")
    ref = _fault_reqs(JaxRequest)
    JaxCluster(cfg_j, pj, **FAULT_KW).run_continuous(ref)
    rs = _fault_reqs(JaxRequest)
    JaxCluster(cfg_j, pj, faults=_fault_plan(JaxPlan, JaxArmed, J_WIRE, J_HS),
               **FAULT_KW).run_continuous(rs)
    want = ([r.output_tokens for r in ref], [r.output_tokens for r in rs])
    assert want[0] != want[1]
    assert _faulted_port("mixtral-8x7b", 1.25) == want


def _vlm_reqs(cls):
    return [cls(prompt_tokens=list(range(1, 12)), max_new_tokens=5,
                mm_payload=b"imgA", mm_tokens=8, mm_pos=3),
            cls(prompt_tokens=list(range(4, 13)), max_new_tokens=5),
            cls(prompt_tokens=list(range(2, 9)), max_new_tokens=5,
                mm_payload=b"imgA", mm_tokens=8, mm_pos=0)]


def test_vlm_moe_disaggregation_matches_jax(monkeypatch):
    """llama4-scout (top-1, early-fusion vision) E->P->D: both packages
    see the port's image features; the dense and chunked clusters give
    the reference engine's tokens and the image is encoded once."""
    cfg_j, cfg, pj, pt = _models("llama4-scout-17b-a16e")

    def port_features(cfg_, payload, n_tokens=0, dtype=None):
        return jnp.asarray(FE.stub_embeddings(cfg, payload, n_tokens).numpy())

    monkeypatch.setattr(jax_frontend, "stub_embeddings", port_features)
    mono = JaxEngine(cfg_j, pj, max_batch=4, max_len=MAX_LEN)
    ref = []
    for r in _vlm_reqs(JaxRequest):
        mono.run_request(r)
        ref.append(r.output_tokens)
    for mode in ("dense", "paged"):
        cluster = EPDCluster(cfg, pt, max_batch=4, max_len=MAX_LEN,
                             device="cpu", **MODES[mode])
        reqs = _vlm_reqs(Request)
        if mode == "dense":
            for r in reqs:
                cluster.submit(r)
            cluster.run_until_done()
        else:
            cluster.run_continuous(reqs)
            _assert_no_leaks(cluster)
        assert [r.output_tokens for r in reqs] == ref, mode
        assert cluster.store.stats.hits >= 1


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_jamba_disaggregation_matches_jax(mode):
    """jamba (attention + SSM + MoE) on the dense and paged clusters gives
    the reference engine's tokens; chunked prefill raises in both
    packages (SSM state cannot resume mid-sequence)."""
    arch = "jamba-v0.1-52b"
    cfg_j, cfg, pj, pt = _models(arch)
    assert _serve(arch, 1.25, mode) == _jax_tokens(arch, 1.25, "mono")
    with pytest.raises(ValueError, match="attention-only"):
        EPDCluster(cfg, pt, max_batch=2, max_len=MAX_LEN, device="cpu",
                   **MODES["chunked"])
    with pytest.raises(ValueError, match="attention-only"):
        JaxCluster(cfg_j, pj, max_batch=2, max_len=MAX_LEN,
                   **MODES["chunked"])
