"""The port's Mamba2 / SSD path against the JAX package's.

* The plain SSD scan (``kernels/ssd_scan/ref.py``) against the JAX
  oracles on the reference's own cases (``tests/test_kernels.py``), one
  case against the Pallas kernel in interpret mode, and the
  scan-then-decode continuation.
* ``ssm_block``, the model's logits and the dense serving path of
  reduced mamba2-370m against the JAX package, with the reference's
  parameters handed over through ``from_numpy_params``.
* Inside the port: preempt/resume of a paged SSM engine is bit-identical
  to the uninterrupted run; jamba (MoE) serves with the reference's
  tokens, and its chunked prefill still raises.
* Two defects of the reference that the port reproduces (ROADMAP
  Queue 3): the conv tail after a padded prefill holds padding, and a
  paged cluster cannot serve an attention-free model.

Inputs are made with numpy from a seed and handed to both packages; f32
throughout, the tolerance covering the two frameworks' summation orders.
The CUDA kernel itself is tested on a card by ``tests/test_torch_cuda.py``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.cluster import EPDCluster as JaxCluster  # noqa: E402
from repro.core.cluster import cache_nbytes as jax_cache_nbytes  # noqa: E402
from repro.core.faults import PlanError as JaxPlanError  # noqa: E402
from repro.kernels import ssd_scan as JK  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.core.cluster import EPDCluster, cache_nbytes  # noqa: E402
from repro_torch.core.faults import PlanError  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as R  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SRC = Path(__file__).resolve().parents[1] / "src"
# tests/test_kernels.py's SSD_CASES: (B, S, H, P, N, chunk)
SSD_CASES = [
    (2, 64, 4, 32, 16, 16),
    (1, 128, 2, 64, 128, 32),
    (2, 96, 3, 32, 64, 32),
]
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5], [3, 5, 8, 9, 7, 9]]
MAX_LEN = 64

jax_ssd_ref = jax.jit(JK.ssd_ref, static_argnums=(6,))
jax_ssd_sequential = jax.jit(JK.ssd_sequential)
jax_ssm_block = jax.jit(JS.ssm_block, static_argnums=(2,))
jax_prefill = jax.jit(JM.prefill_forward, static_argnums=(1,))
jax_decode = jax.jit(JM.decode_forward, static_argnums=(1,))


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(a, b, **kw):
    np.testing.assert_allclose(_np(a), _np(b), **(kw or TOL))


def _both(*arrays):
    """numpy arrays -> (tuple of jax arrays, tuple of torch tensors)."""
    return (tuple(None if x is None else jnp.asarray(x) for x in arrays),
            tuple(None if x is None else torch.from_numpy(x)
                  for x in arrays))


def _ssd_inputs(B, S, H, P, N, seed=0, init=True):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(f)
    a = (-np.exp(rng.standard_normal((H,)) * 0.3)).astype(f)
    b = (rng.standard_normal((B, S, N)) * 0.3).astype(f)
    c = (rng.standard_normal((B, S, N)) * 0.3).astype(f)
    d = np.ones((H,), f)
    s0 = (rng.standard_normal((B, H, P, N)) * 0.1).astype(f) if init else None
    return x, dt, a, b, c, d, s0


# ---------------------------------------------------------------------------
# the plain SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_jax_oracles(case, init):
    B, S_, H, P, N, chunk = case
    (xj, dtj, aj, bj, cj, dj, sj), (x, dt, a, b, c, d, s0) = _both(
        *_ssd_inputs(B, S_, H, P, N, init=init))
    y, fin = ops.ssd(x, dt, a, b, c, d, chunk, s0)      # CPU: plain version
    yr, fr = jax_ssd_ref(xj, dtj, aj, bj, cj, dj, chunk, sj)
    _close(y, yr)
    _close(fin, fr)
    assert y.dtype == torch.float32 and fin.dtype == torch.float32
    ys, fs = R.ssd_sequential(x, dt, a, b, c, d, s0)
    yjs, fjs = jax_ssd_sequential(xj, dtj, aj, bj, cj, dj, sj)
    _close(ys, yjs)
    _close(fs, fjs)
    _close(y, ys)           # the chunked algorithm is the exact recurrence
    _close(fin, fs)
    assert ops.launch_counts()["ssd_scan"] == 0    # no kernel on the CPU


def test_ssd_plain_matches_pallas_interpret():
    B, S_, H, P, N, chunk = SSD_CASES[2]
    (xj, dtj, aj, bj, cj, dj, sj), (x, dt, a, b, c, d, s0) = _both(
        *_ssd_inputs(B, S_, H, P, N, seed=1))
    y, fin = R.ssd_chunked(x, dt, a, b, c, d, chunk, s0)
    yk, fk = JK.ssd_scan(xj, dtj, aj, bj, cj, dj, chunk, sj, interpret=True)
    _close(y, yk)
    _close(fin, fk)


def test_ssd_decode_step_continues_scan():
    """Chunked scan state + one single-token update == the exact
    recurrence over the longer sequence (tests/test_kernels.py:136)."""
    B, S_, H, P, N = 1, 32, 2, 16, 8
    arrays = _ssd_inputs(B, S_ + 1, H, P, N, seed=2, init=False)
    (xj, dtj, aj, bj, cj, dj, _), (x, dt, a, b, c, d, _) = _both(*arrays)
    y_full, f_full = R.ssd_sequential(x, dt, a, b, c, d)
    _, f_prefix = ops.ssd(x[:, :S_], dt[:, :S_], a, b[:, :S_], c[:, :S_],
                          d, 16)
    y_step, f_step = S.ssd_decode_step(x[:, S_], dt[:, S_], a, b[:, S_],
                                       c[:, S_], d, f_prefix)
    _close(y_step, y_full[:, S_])
    _close(f_step, f_full)
    yj, fj = JS.ssd_decode_step(xj[:, S_], dtj[:, S_], aj, bj[:, S_],
                                cj[:, S_], dj, jnp.asarray(f_prefix.numpy()))
    _close(y_step, yj)
    _close(f_step, fj)


# ---------------------------------------------------------------------------
# the block and the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    """Reduced mamba2-370m in both packages, and the JAX monolithic
    engine's greedy tokens on PROMPTS (the reference's own baseline)."""
    cfg_j = jax_get_config("mamba2-370m").reduced()
    cfg = get_config("mamba2-370m").reduced()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    mono = JaxEngine(cfg_j, pj, max_batch=4, max_len=MAX_LEN)
    ref = []
    for p in PROMPTS:
        r = JaxRequest(prompt_tokens=list(p), max_new_tokens=6)
        mono.run_request(r)
        ref.append(r.output_tokens)
    return cfg_j, cfg, pj, pt, ref


@pytest.mark.parametrize("n_pad", [0, 5])
def test_ssm_block_prefill_then_decode(mamba, n_pad):
    """Prefill (right-padded by ``n_pad`` steps in row 1) then one decode
    step against the carried state and conv tail.

    With padding, the reference's conv tail is the last W-1 rows of the
    PADDED input (``repro/models/ssm.py:145``): the padded steps' dt is
    masked to 0, so the SSD state is right, but the tail holds padding
    and the next decode step reads it. The port reproduces that, and this
    test holds it to the reference's values, quirk included."""
    cfg_j, cfg, pj, pt, _ = mamba
    pl_j = jax.tree.map(lambda t: t[0], pj["blocks"][0]["ssm"])
    pl_t = {k: v[0] for k, v in pt["blocks"][0]["ssm"].items()}
    rng = np.random.default_rng(3)
    s = 24
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    if n_pad:
        pos[1, -n_pad:] = -1
    cache_t = S.make_ssm_cache(cfg, 1, 2)
    cache_j = JS.make_ssm_cache(cfg_j, 1, 2)
    view = (cache_t.state[0], cache_t.conv[0])
    out, _ = S.ssm_block(pl_t, torch.from_numpy(x), cfg, cache=view,
                         positions=torch.from_numpy(pos))
    out_j, (st_j, tail_j) = jax_ssm_block(
        pl_j, jnp.asarray(x), cfg_j, cache=(cache_j.state[0],
                                            cache_j.conv[0]),
        positions=jnp.asarray(pos))
    _close(out, out_j)
    _close(cache_t.state[0], st_j)
    _close(cache_t.conv[0], tail_j)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((2, 1), s, np.int32)
    out, _ = S.ssm_block(pl_t, torch.from_numpy(x1), cfg, cache=view,
                         positions=torch.from_numpy(p1))
    out_j, (st_j, tail_j) = jax_ssm_block(
        pl_j, jnp.asarray(x1), cfg_j, cache=(st_j, tail_j),
        positions=jnp.asarray(p1))
    _close(out, out_j)
    _close(cache_t.state[0], st_j)
    _close(cache_t.conv[0], tail_j)


def _padded_prefill_gap(prefill, decode, caches, params, cfg, toks, pad):
    """Max |logit| gap between decoding token n+1 after a prefill of n
    tokens (right-padded to ``pad`` when given) and prefilling all n+1."""
    n = toks.shape[1] - 1
    width = pad or n
    head = np.zeros((1, width), np.int32)
    head[0, :n] = toks[0, :n]
    lens = np.array([n], np.int32)
    _, c = prefill(params, cfg, head, caches(), lens)
    got, _ = decode(params, cfg, toks[:, n], c)
    want, _ = prefill(params, cfg, toks, caches(), lens + 1)
    return float(np.abs(_np(got) - _np(want)).max())


def test_padded_prefill_leaves_padding_in_the_conv_tail(mamba):
    """A reference-side defect the port reproduces (ROADMAP Queue 3): the
    engine pads every prefill to max_len, and the conv tail then holds
    the last W-1 PADDED inputs, so the next decode step differs from a
    prefill of the longer prompt. Unpadded, the two agree."""
    cfg_j, cfg, pj, pt, _ = mamba
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, 12))
    toks = toks.astype(np.int32)

    def port_prefill(params, cfg, t, c, lens):
        return M.prefill_forward(params, cfg, torch.from_numpy(t), c,
                                 lengths=torch.from_numpy(lens))

    def port_decode(params, cfg, t, c):
        return M.decode_forward(params, cfg, torch.from_numpy(t), c)

    def jax_pf(params, cfg, t, c, lens):
        return jax_prefill(params, cfg, jnp.asarray(t), c,
                           lengths=jnp.asarray(lens))

    def jax_dc(params, cfg, t, c):
        return jax_decode(params, cfg, jnp.asarray(t), c)

    gaps = {}
    for pad in (None, 32):
        gaps[pad] = (
            _padded_prefill_gap(port_prefill, port_decode,
                                lambda: T.make_caches(cfg, 1, 32), pt, cfg,
                                toks, pad),
            _padded_prefill_gap(jax_pf, jax_dc,
                                lambda: JT.make_caches(cfg_j, 1, 32,
                                                       dtype=jnp.float32),
                                pj, cfg_j, toks, pad))
    (port_np, ref_np), (port_p, ref_p) = gaps[None], gaps[32]
    assert port_np < 1e-4 and ref_np < 1e-4
    assert ref_p > 0.1 and port_p == pytest.approx(ref_p, rel=1e-3)


@pytest.mark.parametrize("s,chunk", [(64, 32), (24, 24), (40, 40)])
def test_ssm_block_chunk_rule(mamba, monkeypatch, s, chunk):
    """``repro/models/ssm.py:193-195``: chunk = min(chunk_size, S), and one
    chunk of length S when S is not a multiple (chunk_size 32 here)."""
    _, cfg, _, pt, _ = mamba
    seen = []

    def spy(*args):
        seen.append(args[6])
        return R.ssd_chunked(*args)

    monkeypatch.setattr(ops, "ssd", spy)
    x = torch.zeros((1, s, cfg.d_model))
    S.ssm_block({k: v[0] for k, v in pt["blocks"][0]["ssm"].items()}, x, cfg)
    assert seen == [chunk]


def test_params_carry_every_ssm_tensor(mamba):
    _, cfg, pj, pt, _ = mamba
    names = {"norm", "w_in", "conv_w", "conv_b", "dt_bias", "a_log",
             "d_skip", "out_norm", "w_out"}
    assert set(pt["blocks"][0]["ssm"]) == names
    for k in names:
        _close(pt["blocks"][0]["ssm"][k], pj["blocks"][0]["ssm"][k],
               atol=0, rtol=0)
    own = init_params(cfg, device="cpu")["blocks"][0]["ssm"]
    a = -torch.exp(own["a_log"])                # A in [-e, -1]
    assert bool(((a >= -np.e) & (a <= -1)).all())
    assert {k: tuple(t.shape) for k, t in own.items()} == {
        k: tuple(v.shape) for k, v in pj["blocks"][0]["ssm"].items()}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_and_decode_logits(mamba, layout):
    cfg_j, cfg, pj, pt, _ = mamba
    kw = {}
    if layout == "paged":
        kw = dict(layout="paged", page_size=8, n_pages=1 + MAX_LEN // 8)
    ct = T.make_caches(cfg, 1, MAX_LEN, **kw)
    cj = JT.make_caches(cfg_j, 1, MAX_LEN, dtype=jnp.float32, **kw)
    rng = np.random.default_rng(4)
    n = 37
    toks = np.zeros((1, MAX_LEN), np.int32)
    toks[0, :n] = rng.integers(0, cfg.vocab, n)
    lens = np.array([n], np.int32)
    lt, ct = M.prefill_forward(pt, cfg, torch.from_numpy(toks), ct,
                               lengths=torch.from_numpy(lens))
    lj, cj = jax_prefill(pj, cfg_j, jnp.asarray(toks), cj,
                         lengths=jnp.asarray(lens))
    _close(lt, lj)
    for t in (5, 17, 42):
        lt, ct = M.decode_forward(pt, cfg, torch.tensor([t],
                                                        dtype=torch.int32), ct)
        lj, cj = jax_decode(pj, cfg_j, jnp.asarray([t], jnp.int32), cj)
        _close(lt, lj)
    assert cache_nbytes(ct) == jax_cache_nbytes(cj)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _jax_cluster_tokens(cfg_j, pj, continuous):
    cluster = JaxCluster(cfg_j, pj, max_batch=4, max_len=MAX_LEN)
    reqs = [JaxRequest(prompt_tokens=list(p), max_new_tokens=6)
            for p in PROMPTS]
    if continuous:
        cluster.run_continuous(reqs)
    else:
        for r in reqs:
            cluster.submit(r)
        cluster.run_until_done()
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("path", ["engine", "serial", "continuous"])
def test_dense_serving_matches_jax(mamba, path):
    """Greedy tokens on Engine.run_request and on the dense EPDCluster
    (submit + run_until_done, and run_continuous, which serves SSM
    requests as monolithic single-chunk jobs) equal the JAX package's."""
    cfg_j, cfg, pj, pt, ref = mamba
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=6)
            for p in PROMPTS]
    if path == "engine":
        eng = Engine(cfg, pt, max_batch=4, max_len=MAX_LEN, device="cpu")
        for r in reqs:
            eng.run_request(r)
    else:
        cluster = EPDCluster(cfg, pt, max_batch=4, max_len=MAX_LEN,
                             device="cpu")
        if path == "continuous":
            assert len(cluster.run_continuous(reqs)) == len(reqs)
        else:
            for r in reqs:
                cluster.submit(r)
            cluster.run_until_done()
        assert ref == _jax_cluster_tokens(cfg_j, pj, path == "continuous")
    assert [r.output_tokens for r in reqs] == ref


def _serve_preempted(eng, req_cls, preempt_at):
    """Two requests in a paged engine of two slots; the one in slot 1 is
    preempted before the decode steps in ``preempt_at`` and resumed by the
    next decode step (tests/test_preemption.py drives it the same way)."""
    reqs = [req_cls(prompt_tokens=list(p), max_new_tokens=8)
            for p in PROMPTS[:2]]
    for r in reqs:
        f, p = eng.prefill_request(r)
        eng.insert(r, p, f)
    victim = reqs[1]
    step = 0
    while any(s is not None for s in eng.slots) or eng.preempted:
        if step in preempt_at and any(s is victim for s in eng.slots):
            eng.preempt_slot(next(i for i, s in enumerate(eng.slots)
                                  if s is victim))
        eng.decode_step()
        step += 1
        assert step < 100, "preempted request never finished"
    return [r.output_tokens for r in reqs]


def test_preempt_resume_paged_ssm_engine(mamba):
    """The snapshot takes the slot's own SSM state and conv tail, and the
    resume puts them back: bit-identical to the uninterrupted run, and
    equal to the reference's tokens under the same schedule."""
    cfg_j, cfg, pj, pt, _ = mamba
    kw = dict(max_batch=2, max_len=MAX_LEN, paged=True, page_size=8,
              preemption=True)
    base = _serve_preempted(Engine(cfg, pt, device="cpu", **kw), Request, ())
    eng = Engine(cfg, pt, device="cpu", **kw)
    out = _serve_preempted(eng, Request, (1, 4))
    assert out == base and eng.preempt_count == 2 and eng.resume_count == 2
    eng.assert_no_page_leaks()
    assert out == _serve_preempted(JaxEngine(cfg_j, pj, **kw), JaxRequest,
                                   (1, 4))


def test_paged_ssm_cluster_fails_as_the_reference_does(mamba):
    """A paged payload counts attention pages only, so an attention-free
    model's KV-transfer plan has 0 bytes a layer: the reference raises
    PlanError (ROADMAP Queue 3), and so does its copy in the port."""
    cfg_j, cfg, pj, pt, _ = mamba
    for cls, c, params, req, err, kw in (
            (EPDCluster, cfg, pt, Request, PlanError, dict(device="cpu")),
            (JaxCluster, cfg_j, pj, JaxRequest, JaxPlanError, {})):
        cluster = cls(c, params, max_batch=2, max_len=MAX_LEN, paged=True,
                      page_size=8, **kw)
        with pytest.raises(err, match="bytes_per_layer"):
            cluster.submit(req(prompt_tokens=list(PROMPTS[0]),
                               max_new_tokens=2))


def test_serve_launcher_runs_mamba2():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-370m", "--reduced", "--device", "cpu", "--dtype",
         "float32", "--max-len", "64", "--requests", "2",
         "--max-new-tokens", "3"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("[P-D] -> [") == 2, res.stdout


def test_jamba_still_raises():
    """jamba (attention + SSM + MoE) is served by the port's engine with
    the reference's greedy tokens; chunked prefill still raises in both
    packages, as SSM state cannot resume mid-sequence."""
    cfg_j = jax_get_config("jamba-v0.1-52b").reduced()
    cfg = get_config("jamba-v0.1-52b").reduced()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    out = []
    for cls, c, params, req, kw in (
            (Engine, cfg, pt, Request, dict(device="cpu")),
            (JaxEngine, cfg_j, pj, JaxRequest, {})):
        eng = cls(c, params, max_batch=2, max_len=MAX_LEN, **kw)
        r = req(prompt_tokens=list(PROMPTS[0]), max_new_tokens=4)
        eng.run_request(r)
        out.append(r.output_tokens)
        with pytest.raises(ValueError, match="attention-only"):
            cls(c, params, max_batch=1, max_len=MAX_LEN, paged=True,
                page_size=8, chunked_prefill=True, prefill_chunk=8, **kw)
    assert out[0] == out[1]
