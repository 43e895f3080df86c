"""The port's serving path against the JAX package's, and the reference's
own serving invariants re-proved inside the port.

* Greedy tokens equal the JAX package's on the disaggregation matrix of
  ``tests/test_system.py`` (dense / paged / chunked + prefix cache), for
  a text model and, with both packages fed the port's image features, a
  VLM.
* Inside the port, bitwise: cluster == monolithic engine, continuous ==
  serial, preempt/resume == uninterrupted, faulted == zero-fault, and no
  page leaks.
* Boundaries: the port imports with ``jax`` and ``repro`` blocked, and a
  default (CUDA) construction raises where CUDA is absent.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.models.frontend as jax_frontend  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.core.cluster import EPDCluster  # noqa: E402
from repro_torch.core.faults import (SITE_SWAP_IN, SITE_TRANSFER_HANDSHAKE,  # noqa: E402
                                     SITE_TRANSFER_WIRE, ArmedFault,
                                     FaultPlan)
from repro_torch.models import frontend as FE  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5], [3, 5, 8, 9, 7, 9]]
MODES = {
    "dense": {},
    "paged": dict(paged=True, page_size=8),
    "chunked": dict(paged=True, page_size=8, chunked_prefill=True,
                    prefill_chunk=8, prefix_cache=True,
                    n_prefill_pool_pages=33),
}


def _models(name):
    cfg_j = jax_get_config(name).reduced()
    cfg = get_config(name).reduced()
    pj = jax_init_params(cfg_j, jax.random.PRNGKey(0))
    pt = from_numpy_params(jax.tree.map(np.asarray, pj), cfg, device="cpu")
    return cfg_j, cfg, pj, pt


@pytest.fixture(scope="module")
def smollm():
    """The reduced text model in both packages, and the JAX monolithic
    engine's greedy tokens on PROMPTS (the reference's own baseline)."""
    cfg_j, cfg, pj, pt = _models("smollm-135m")
    mono = JaxEngine(cfg_j, pj, max_batch=4, max_len=64)
    ref = []
    for p in PROMPTS:
        r = JaxRequest(prompt_tokens=list(p), max_new_tokens=6)
        mono.run_request(r)
        ref.append(r.output_tokens)
    return cfg, pt, ref


def _assert_no_leaks(cluster):
    for eng in [cluster.prefill_engine, *cluster.decode_engines]:
        if eng.paged and not eng.crashed:
            eng.assert_no_page_leaks()
    assert cluster.decode_engine.pool.n_used == 0


def test_monolithic_engine_matches_jax(smollm):
    cfg, pt, ref = smollm
    mono = Engine(cfg, pt, max_batch=4, max_len=64, device="cpu")
    out = []
    for p in PROMPTS:
        r = Request(prompt_tokens=list(p), max_new_tokens=6)
        mono.run_request(r)
        out.append(r.output_tokens)
    assert out == ref


@pytest.mark.parametrize("mode", sorted(MODES))
def test_disaggregation_matches_jax(smollm, mode):
    """tests/test_system.py's matrix: the port's E->P->D cluster gives the
    JAX monolithic engine's tokens in every cache layout."""
    cfg, pt, ref = smollm
    cluster = EPDCluster(cfg, pt, max_batch=4, max_len=64, device="cpu",
                         **MODES[mode])
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=6)
            for p in PROMPTS]
    for r in reqs:
        cluster.submit(r)
    cluster.run_until_done()
    assert [r.output_tokens for r in reqs] == ref
    if mode != "dense":
        _assert_no_leaks(cluster)


def test_continuous_equals_serial(smollm):
    cfg, pt, ref = smollm
    cluster = EPDCluster(cfg, pt, max_batch=2, max_len=64, device="cpu",
                         **MODES["chunked"])
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=6)
            for p in PROMPTS]
    done = cluster.run_continuous(
        reqs, on_step=lambda step: cluster.prefill_engine
        .assert_no_page_leaks())
    assert len(done) == len(reqs)
    assert [r.output_tokens for r in reqs] == ref
    _assert_no_leaks(cluster)


@pytest.mark.parametrize("mode", ["paged", "chunked"])
def test_preempt_resume_equals_uninterrupted(smollm, mode):
    """Page-level preemption: the swap-out gathers a host copy, the
    resume scatters it back; greedy output is unchanged."""
    cfg, pt, _ = smollm
    kw = {k: v for k, v in MODES[mode].items()
          if k not in ("n_prefill_pool_pages",)}
    prompt = list(range(2, 18))                  # ends on a page boundary

    def serve(preempt_at):
        eng = Engine(cfg, pt, max_batch=2, max_len=64, preemption=True,
                     device="cpu", **kw)
        r = Request(prompt_tokens=prompt, max_new_tokens=8)
        f, p = eng.prefill_request(r)
        eng.insert(r, p, f)
        step = 0
        while (any(s is r for s in eng.slots)
               or any(pr.req is r for pr in eng.preempted)):
            if step in preempt_at and any(s is r for s in eng.slots):
                eng.preempt_slot(next(i for i, s in enumerate(eng.slots)
                                      if s is r))
            eng.decode_step()
            step += 1
            assert step < 100
        eng.assert_no_page_leaks()
        return r.output_tokens, eng.swap_out_pages_total

    base, _ = serve(())
    out, swapped = serve((1, 4))
    assert out == base and swapped > 0


def test_faulted_continuous_equals_zero_fault(smollm):
    """The chaos layer in the port: transfer faults plus a decode crash
    re-route onto the survivor; completed tokens are bit-identical."""
    cfg, pt, _ = smollm
    kw = dict(max_batch=2, max_len=64, n_decode=2, device="cpu",
              **MODES["chunked"])

    def reqs():
        return [Request(prompt_tokens=list(range(3 + i, 14 + 2 * i)),
                        max_new_tokens=8) for i in range(4)]

    ref = reqs()
    EPDCluster(cfg, pt, **kw).run_continuous(ref)
    plan = FaultPlan(seed=1, rates={SITE_TRANSFER_WIRE: 0.3,
                                    SITE_TRANSFER_HANDSHAKE: 0.2},
                     armed=[ArmedFault("decode.crash", key=(0, 5))])
    rs = reqs()
    cl = EPDCluster(cfg, pt, faults=plan, **kw)
    done = cl.run_continuous(rs)
    assert cl.report.instance_crashes == 1
    assert not cl.report.lost and len(done) == len(rs)
    assert [r.output_tokens for r in rs] == [r.output_tokens for r in ref]
    _assert_no_leaks(cl)


def test_swap_loss_recompute_equals_zero_fault(smollm):
    cfg, pt, _ = smollm
    kw = dict(max_batch=3, max_len=64, paged=True, page_size=4,
              preemption=True, n_decode_pool_pages=14, chunked_prefill=True,
              prefill_chunk=16, device="cpu")

    def reqs():
        return [Request(prompt_tokens=list(range(3 + i, 19 + i)),
                        max_new_tokens=12) for i in range(4)]

    ref = reqs()
    EPDCluster(cfg, pt, **kw).run_continuous(ref)
    rs = reqs()
    cl = EPDCluster(cfg, pt, faults=FaultPlan(
        seed=3, armed=[ArmedFault(SITE_SWAP_IN)]), **kw)
    done = cl.run_continuous(rs)
    assert cl.report.swap_losses == 1
    assert not cl.report.lost and len(done) == len(rs)
    assert [r.output_tokens for r in rs] == [r.output_tokens for r in ref]


# ---------------------------------------------------------------------------
# VLM: both packages see the port's image features
# ---------------------------------------------------------------------------

def _vlm_reqs(cls):
    return [cls(prompt_tokens=list(range(1, 12)), max_new_tokens=5,
                mm_payload=b"imgA", mm_tokens=8, mm_pos=3),
            cls(prompt_tokens=list(range(4, 13)), max_new_tokens=5),
            cls(prompt_tokens=list(range(2, 9)), max_new_tokens=5,
                mm_payload=b"imgA", mm_tokens=8, mm_pos=0)]


def test_vlm_disaggregation_matches_jax(monkeypatch):
    cfg_j, cfg, pj, pt = _models("llava-next-mistral-7b")

    def port_features(cfg_, payload, n_tokens=0, dtype=None):
        return jax.numpy.asarray(
            FE.stub_embeddings(cfg, payload, n_tokens).numpy())

    monkeypatch.setattr(jax_frontend, "stub_embeddings", port_features)
    mono = JaxEngine(cfg_j, pj, max_batch=4, max_len=64)
    ref = []
    for r in _vlm_reqs(JaxRequest):
        mono.run_request(r)
        ref.append(r.output_tokens)

    port_mono = Engine(cfg, pt, max_batch=4, max_len=64, device="cpu")
    out = []
    for r in _vlm_reqs(Request):
        port_mono.run_request(r)
        out.append(r.output_tokens)
    assert out == ref
    for mode in ("dense", "chunked"):
        cluster = EPDCluster(cfg, pt, max_batch=4, max_len=64, device="cpu",
                             **MODES[mode])
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


def test_stub_embeddings_deterministic_in_payload():
    cfg = get_config("llava-next-mistral-7b").reduced()
    a = FE.stub_embeddings(cfg, b"x")
    assert a.shape == (cfg.frontend.tokens_per_item, cfg.frontend.feature_dim)
    assert a.dtype == torch.float32
    assert torch.equal(a, FE.stub_embeddings(cfg, b"x"))
    assert not torch.equal(a, FE.stub_embeddings(cfg, b"y"))
    assert FE.mm_key_run("k", 4) == jax_frontend.mm_key_run("k", 4)


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------

def test_port_imports_without_jax_or_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 30


def test_default_device_raises_without_cuda(smollm):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default construction is valid")
    cfg, pt, _ = smollm
    with pytest.raises(RuntimeError, match="cuda"):
        EPDCluster(cfg, pt, max_batch=2, max_len=64)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, pt, max_batch=2, max_len=64)
