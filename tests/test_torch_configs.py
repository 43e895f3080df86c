"""The four configs that no other port test serves, held to the reference
on the CPU: glm4-9b (32/2 heads, a group of 16), deepseek-7b (MHA),
llama3.2-1b (tied embeddings, rope theta 5e5) and openpangu-7b-vl (the
paper's own model: a vision projector, a group of 7). Each in its
``reduced()`` form, f32, with the reference's ``init_params(cfg,
PRNGKey(0))`` through ``repro_torch.convert.from_numpy_params``; one
parametrised test per check: prefill and decode logits (dense and
paged), one train step's loss and every gradient leaf, and the greedy
tokens of a dense and a paged ``EPDCluster`` against the reference's
monolithic engine. ``reduced()`` turns glm4's group of 16 into 4, so one
more test runs its true heads (32/2 of 128) at 1 layer.

Tolerances: 1e-4 for logits and the loss, 1e-3 for a gradient relative
to its leaf's max |g| (``tests/test_torch_training.py``'s); f32 on both
sides, only the summation order differs. Each model is built once a
module and dropped when its tests are done.
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.frontend as jax_frontend  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.core.cluster import EPDCluster  # noqa: E402
from repro_torch.models import frontend as FE  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import flatten, leaves, map_tree  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.training.data import synthetic_batches  # noqa: E402

ARCHS = ["glm4-9b", "deepseek-7b", "llama3.2-1b", "openpangu-7b-vl"]
TOL = dict(atol=1e-4, rtol=1e-4)        # logits, f32
LOSS_TOL = 1e-4
GRAD_REL = 1e-3                          # of each leaf's max |g|
MAX_LEN, PAGE = 64, 8
# the reference tests' prompts (tests/test_system.py, test_torch_serving)
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5], [3, 5, 8, 9, 7, 9]]
MODES = {"dense": {}, "paged": dict(paged=True, page_size=PAGE)}
jax_prefill = jax.jit(JM.prefill_forward, static_argnums=(1,))
jax_decode = jax.jit(JM.decode_forward, static_argnums=(1,))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), **TOL)


def _build(cfg_j, cfg):
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    return pj, pt


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg_j = jax_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    pj, pt = _build(cfg_j, cfg)
    yield cfg_j, cfg, pj, pt
    del pj, pt
    jax.clear_caches()
    gc.collect()


def test_reduced_configs_match_the_reference(model):
    """The two packages reduce each config alike (heads, group, tie,
    theta, frontend), and the converted parameters count what the
    config says."""
    cfg_j, cfg, _, pt = model
    assert dataclasses.astuple(cfg) == dataclasses.astuple(cfg_j)
    assert sum(t.numel() for t in leaves(pt)) == cfg.param_count()
    assert ("lm_head" in pt) == (not cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# logits
# ---------------------------------------------------------------------------

def _caches(cfg_j, cfg, layout, n_slots=1, max_len=MAX_LEN):
    if layout == "dense":
        return (JT.make_caches(cfg_j, n_slots, max_len, dtype=jnp.float32),
                T.make_caches(cfg, n_slots, max_len, dtype=torch.float32))
    n_pages = max_len // PAGE
    kw = dict(layout="paged", page_size=PAGE, n_pages=1 + n_slots * n_pages)
    cj = JT.make_caches(cfg_j, n_slots, max_len, dtype=jnp.float32, **kw)
    ct = T.make_caches(cfg, n_slots, max_len, dtype=torch.float32, **kw)
    # scattered pages, in reverse order within each slot
    rows = (1 + np.arange(n_slots * n_pages, dtype=np.int32)[::-1]).reshape(
        n_slots, n_pages).copy()
    cj["pages"] = jnp.asarray(rows)
    ct["pages"][:] = torch.from_numpy(rows)
    return cj, ct


def _feats(cfg, pt, seed):
    """Projected image features of one item (numpy, both sides), or None
    for a text model."""
    if cfg.frontend is None:
        return None
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((cfg.frontend.tokens_per_item,
                                   cfg.frontend.feature_dim),
                                  dtype=np.float32) * np.float32(0.02)
    return (patches @ pt["projector"].numpy())[None]


def _prefill_decode(cfg_j, cfg, pj, pt, layout, n_text=21, forced=(3, 11, 7),
                    max_len=MAX_LEN):
    """Prefill one prompt (with an image for the VLM) and decode
    ``forced`` tokens on both sides, holding the logits of every step."""
    feats = _feats(cfg, pt, 7)
    n_mm = 0 if feats is None else feats.shape[1]
    rng = np.random.default_rng(8)
    text = rng.integers(1, cfg.vocab, size=n_text).astype(np.int32)
    mm_pos = 5
    n = n_text + n_mm
    toks = np.zeros((1, max_len), np.int32)
    toks[0, :mm_pos] = text[:mm_pos]
    toks[0, mm_pos + n_mm:n] = text[mm_pos:]
    cj, ct = _caches(cfg_j, cfg, layout, max_len=max_len)
    kwj = dict(lengths=jnp.asarray([n], jnp.int32))
    kwt = dict(lengths=torch.tensor([n], dtype=torch.int32))
    if feats is not None:
        kwj.update(mm_feats=jnp.asarray(feats), mm_start=mm_pos)
        kwt.update(mm_feats=torch.from_numpy(feats), mm_start=mm_pos)
    lj, cj = jax_prefill(pj, cfg_j, jnp.asarray(toks), cj, **kwj)
    lt, ct = M.prefill_forward(pt, cfg, torch.from_numpy(toks), ct, **kwt)
    _close(lt, lj)
    for tok in forced:
        lj, cj = jax_decode(pj, cfg_j, jnp.asarray([tok], jnp.int32), cj)
        lt, ct = M.decode_forward(pt, cfg, torch.tensor([tok],
                                                        dtype=torch.int32), ct)
        _close(lt, lj)
        assert int(ct["len"][0]) == int(cj["len"][0])


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_and_decode_logits(model, layout):
    cfg_j, cfg, pj, pt = model
    _prefill_decode(cfg_j, cfg, pj, pt, layout)


# ---------------------------------------------------------------------------
# one train step: the loss and every gradient leaf
# ---------------------------------------------------------------------------

def test_train_step_loss_and_gradients(model):
    cfg_j, cfg, pj, pt = model
    mm = cfg.frontend is not None
    jb = next(jax_data.synthetic_batches(cfg_j, 2, 16, 1, seed=3, mm=mm))
    tb = next(synthetic_batches(cfg, 2, 16, 1, seed=3, mm=mm, device="cpu"))
    (_, jm), jg = jax.value_and_grad(
        lambda p: JM.train_forward(p, cfg_j, jb, remat=False),
        has_aux=True)(pj)
    live = map_tree(lambda t: t.detach().requires_grad_(True), pt)
    total, m = M.train_forward(live, cfg, tb, remat=False)
    grads = torch.autograd.grad(total, leaves(live), allow_unused=True)
    loss = float(m["loss"].detach())
    assert abs(loss - float(jm["loss"])) <= LOSS_TOL * max(1.0, abs(loss))
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves(live), grads)])
    got = flatten(map_tree(lambda _: next(it), pt))
    ref = jax.tree.leaves(jg)
    assert len(ref) == len(got)
    for a, t in zip(ref, got):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-12)
        err = float(np.abs(t.numpy() - a).max())
        assert err <= GRAD_REL * scale, (err, scale, a.shape)


# ---------------------------------------------------------------------------
# greedy serving: the port's cluster against the reference's engine
# ---------------------------------------------------------------------------

def _requests(cls, cfg):
    """PROMPTS, 6 new tokens each; for the VLM two of them carry one
    shared image of the frontend's token count."""
    if cfg.frontend is None:
        return [cls(prompt_tokens=list(p), max_new_tokens=6) for p in PROMPTS]
    n = cfg.frontend.tokens_per_item
    return [cls(prompt_tokens=list(PROMPTS[0]), max_new_tokens=6,
                mm_payload=b"imgA", mm_tokens=n, mm_pos=2),
            cls(prompt_tokens=list(PROMPTS[1]), max_new_tokens=6),
            cls(prompt_tokens=list(PROMPTS[2]), max_new_tokens=6,
                mm_payload=b"imgA", mm_tokens=n, mm_pos=0)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_tokens_match_the_reference(model, mode, monkeypatch):
    """Both packages see the port's stub image features (the reference's
    ``stub_embeddings`` monkeypatched), so the tokens compare the
    models, not two generators."""
    cfg_j, cfg, pj, pt = model

    def port_features(cfg_, payload, n_tokens=0, dtype=None):
        return jnp.asarray(FE.stub_embeddings(cfg, payload, n_tokens).numpy())

    monkeypatch.setattr(jax_frontend, "stub_embeddings", port_features)
    mono = JaxEngine(cfg_j, pj, max_batch=4, max_len=MAX_LEN)
    ref = []
    for r in _requests(JaxRequest, cfg):
        mono.run_request(r)
        ref.append(r.output_tokens)
    cluster = EPDCluster(cfg, pt, max_batch=4, max_len=MAX_LEN, device="cpu",
                         **MODES[mode])
    reqs = _requests(Request, cfg)
    for r in reqs:
        cluster.submit(r)
    cluster.run_until_done()
    assert [r.output_tokens for r in reqs] == ref
    if mode == "paged":
        cluster.prefill_engine.assert_no_page_leaks()
        assert cluster.decode_engine.pool.n_used == 0
    if cfg.frontend is not None:
        assert cluster.store.stats.hits >= 1
    del mono, cluster


# ---------------------------------------------------------------------------
# glm4-9b's true group: 32 q heads over 2 kv heads of 128
# ---------------------------------------------------------------------------

def _glm4_true_group(pkg_get_config):
    return dataclasses.replace(
        pkg_get_config("glm4-9b"), name="glm4-9b-1layer", n_layers=1,
        d_model=512, n_heads=32, n_kv_heads=2, head_dim=128, d_ff=1024,
        vocab=1024)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_glm4_true_group_decode_logits(layout):
    """A group of 16 through the plain dense and paged decode paths (the
    reduced config runs a group of 4): prefill and decode logits against
    the reference."""
    cfg_j, cfg = _glm4_true_group(jax_get_config), _glm4_true_group(
        get_config)
    assert cfg.n_heads // cfg.n_kv_heads == 16 and cfg.head_dim == 128
    pj, pt = _build(cfg_j, cfg)
    _prefill_decode(cfg_j, cfg, pj, pt, layout, n_text=37,
                    forced=(5, 900, 17, 2))
    del pj, pt
    gc.collect()
