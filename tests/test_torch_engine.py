"""The reference's engine invariants, re-proved inside the port.

The port's ``Engine`` on the CPU (plain PyTorch attention), with its own
random parameters: prefix-cache warm == cold, copy-on-write KV == cold
KV, chunked == monolithic prefill, eviction and unwinding leave no
leaks, a preempted request whose prefix was evicted re-faults it, and
the decode loop's edge cases (idle step, exact ``max_len``, slot reuse).
Mirrors ``tests/test_prefix_cache.py``, ``test_chunked_prefill.py`` and
``test_engine_edge.py``; greedy tokens must match bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

BASE = list(range(2, 22))                        # 20 tokens = 2.5 pages @8


@pytest.fixture(scope="module")
def smollm():
    cfg = get_config("smollm-135m").reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _engine(cfg, params, *, chunk=None, prefix=False, **kw):
    kw.setdefault("max_len", 64)
    return Engine(cfg, params, max_batch=2, paged=True, page_size=8,
                  prefix_cache=prefix, chunked_prefill=chunk is not None,
                  prefill_chunk=chunk or 32, device="cpu", **kw)


def _serve(eng, prompt, n=6, **kw):
    r = Request(prompt_tokens=list(prompt), max_new_tokens=n, **kw)
    f, p = eng.prefill_request(r)
    eng.insert(r, p, f)
    while any(s is r for s in eng.slots):
        eng.decode_step()
    return r.output_tokens


PROBES = (BASE[:16] + [55, 56],                  # match ends on a page edge
          BASE[:10] + [99, 98, 97],              # diverges inside a page: CoW
          [77, 78, 79, 80],                      # no match
          BASE + [30, 31, 32],                   # extends the cached prompt
          list(BASE))                            # identical re-run


@pytest.mark.parametrize("chunk", [None, 16])
def test_prefix_cache_warm_matches_cold(smollm, chunk):
    cfg, params = smollm
    cold = _engine(cfg, params)
    warm = _engine(cfg, params, chunk=chunk, prefix=True, n_pool_pages=64)
    assert _serve(cold, BASE) == _serve(warm, BASE)      # seeds the cache
    for probe in PROBES:
        before = warm.prefill_tokens_computed
        assert _serve(cold, probe) == _serve(warm, probe), probe
        hit = warm.prefill_tokens_computed - before < len(probe)
        assert hit == (probe[0] == BASE[0])
        warm.assert_no_page_leaks()
        cold.assert_no_page_leaks()
    assert warm.prefill_tokens_computed < warm.prefill_tokens_total


def test_cow_kv_matches_cold_prefill(smollm):
    """The copied-on-write page plus the recomputed suffix hold the KV a
    cold prefill produces, read back through both block tables."""
    cfg, params = smollm
    cold = _engine(cfg, params)
    warm = _engine(cfg, params, prefix=True, n_pool_pages=64)
    _serve(warm, BASE, n=1)
    probe = BASE[:10] + [99, 98, 97]
    fc, pc = cold.prefill_request(Request(prompt_tokens=probe,
                                          max_new_tokens=1))
    fw, pw = warm.prefill_request(Request(prompt_tokens=probe,
                                          max_new_tokens=1))
    assert pw.cached_tokens > 0 and pw.cached_tokens % warm.page_size
    assert fc == fw
    n = pc.n_tokens
    for ec, ew in zip(cold.caches["attn"], warm.caches["attn"]):
        for tc, tw in zip(ec, ew):
            kc = tc[:, torch.as_tensor(pc.page_ids).long()].flatten(1, 2)
            kw = tw[:, torch.as_tensor(pw.page_ids).long()].flatten(1, 2)
            torch.testing.assert_close(kc[:, :n], kw[:, :n], atol=1e-5,
                                       rtol=1e-5)
    cold.release_payload(pc)
    warm.release_payload(pw)
    cold.assert_no_page_leaks()
    warm.assert_no_page_leaks()


def test_eviction_under_pool_pressure(smollm):
    cfg, params = smollm
    eng = _engine(cfg, params, prefix=True, n_pool_pages=9)   # 8 usable
    outs = [_serve(eng, [100 * w + j for j in range(20)], n=4)
            for w in range(4)]
    eng.assert_no_page_leaks()
    assert eng.prefix_cache.stats.evicted_pages > 0
    assert _serve(eng, list(range(20)), n=4) == outs[0]
    eng.assert_no_page_leaks()


def test_early_eos_and_payload_release(smollm):
    cfg, params = smollm
    eng = _engine(cfg, params, prefix=True, n_pool_pages=64)
    out = _serve(eng, BASE, n=6)
    assert len(_serve(eng, BASE, n=20, eos_token=out[1])) == 2
    eng.assert_no_page_leaks()
    _, p = eng.prefill_request(Request(prompt_tokens=BASE[:8] + [5, 5],
                                       max_new_tokens=2))
    eng.release_payload(p)
    eng.release_payload(p)                       # a second release: no-op
    eng.assert_no_page_leaks()


def test_failed_suffix_prefill_unwinds_all_refs(smollm, monkeypatch):
    cfg, params = smollm
    eng = _engine(cfg, params, prefix=True, n_pool_pages=64)
    _serve(eng, BASE, n=1)
    used = eng.pool.n_used

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(eng, "_prefill_suffix", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.prefill_request(Request(prompt_tokens=BASE[:10] + [99, 98],
                                    max_new_tokens=1))
    assert eng.pool.n_used == used
    eng.assert_no_page_leaks()


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_matches_monolithic(smollm, chunk):
    cfg, params = smollm
    mono = _engine(cfg, params)
    chunked = _engine(cfg, params, chunk=chunk)
    for prompt in ([5, 6, 7], list(range(2, 22)), list(range(2, 34)),
                   list(range(2, 35))):
        assert _serve(mono, prompt, n=5) == _serve(chunked, prompt, n=5)
        chunked.assert_no_page_leaks()
    assert chunked.pool.n_free == chunked.pool.n_pages - 1


def test_chunked_payload_segments_cover_pages(smollm):
    cfg, params = smollm
    eng = _engine(cfg, params, chunk=16, prefix=True, n_pool_pages=64)
    prompt = list(range(400, 430))
    f, p = eng.prefill_request(Request(prompt_tokens=prompt,
                                       max_new_tokens=1))
    assert [t for t, _ in p.chunks] == [16, 14]
    assert sum(n for _, n in p.chunks) == len(p.page_ids)
    eng.release_payload(p)
    f2, p2 = eng.prefill_request(Request(prompt_tokens=prompt,
                                         max_new_tokens=1))
    assert f2 == f and p2.chunks[0][0] == 0 and p2.cached_tokens > 0
    assert sum(t for t, _ in p2.chunks) == p2.n_tokens - p2.cached_tokens
    eng.release_payload(p2)
    eng.assert_no_page_leaks()


def test_resume_after_prefix_eviction_refaults(smollm):
    cfg, params = smollm
    prompt = list(range(2, 20))
    base = _serve(_engine(cfg, params), prompt)
    eng = _engine(cfg, params, prefix=True, preemption=True,
                  n_pool_pages=64)
    _serve(eng, prompt, n=2)
    r = Request(prompt_tokens=list(prompt), max_new_tokens=6)
    f, p = eng.prefill_request(r)
    eng.insert(r, p, f)
    eng.decode_step()
    pr = eng.preempt_slot(next(i for i, s in enumerate(eng.slots) if s is r))
    assert pr.n_shared_pages > 0
    eng.prefix_cache.evict(eng.pool.n_pages)
    steps = 0
    while any(s is r for s in eng.slots) or eng.preempted:
        eng.decode_step()
        steps += 1
        assert steps < 100
    assert r.output_tokens == base
    assert eng.refault_pages_total >= pr.n_shared_pages
    eng.assert_no_page_leaks()


def test_decode_loop_edges(smollm):
    """Idle step dispatches nothing; a request fills the cache to exactly
    max_len; slots are reused; an overlong prompt is refused."""
    cfg, params = smollm
    eng = _engine(cfg, params, max_len=16)
    calls = {"n": 0}
    real = eng._decode

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    eng._decode = counting
    assert eng.decode_step() == [] and calls["n"] == 0
    for _ in range(2):
        out = _serve(eng, [2, 3, 4, 5, 6], n=100)
        assert len(out) == 16 - 5 + 1
        assert int(eng.caches["len"][0]) == 16
        assert eng.free_slots() == [0, 1]
        eng.assert_no_page_leaks()
    with pytest.raises(ValueError, match="exceeds"):
        eng.prefill_request(Request(prompt_tokens=list(range(40))))
