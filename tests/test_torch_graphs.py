"""What the port's CUDA-graph steps rely on, checked on the CPU.

A decode step or a dense prefill is captured once per key and replayed
over the very tensors it was captured over (``serving/graphs.py``). On
the CPU the same steps run eagerly through the same runner, so these
tests prove, without a card:

* the engine keeps its state in the same tensors through decode steps
  on dense, paged and mamba2 engines, across a page boundary, a slot
  released and re-inserted, and a preemption swap-out and swap-in;
* the graph key is the shapes, strides and dtypes of the tensors and the
  values of the other arguments, and an engine's decode steps share one
  key; only the decode step and the dense prefill go through the runner;
* launch accounting: what a capture counts, added once a replay, equals
  the eager counts;
* a dense prefill hands back copies, so a payload held across the next
  prefill is unchanged;
* the graph's kernel nodes are told apart by their function names, and
  the censuses of an engine's and a cluster's steps add up.

Replays against eager runs, bitwise, are ``tests/test_torch_cuda.py``'s.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.paged_decode_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.transformer import (cache_tensors, clone_caches,  # noqa: E402
                                            make_caches)
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.graphs import (GraphStep, census,  # noqa: E402
                                        graph_key, held_to_eager,
                                        recorded_launches)
from repro_torch.serving.request import Request  # noqa: E402

PROMPTS = ([3, 1, 4, 1, 5, 9], [2, 6, 5, 3, 5], [8, 9, 7, 9, 3, 2, 3])
NEW = (12, 3, 6)          # the second request ends first and frees its slot


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("smollm-135m", "mamba2-370m"):
        cfg = get_config(name).reduced()
        out[name] = cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    return out


ENGINES = {
    "dense": ("smollm-135m", {}),
    "paged": ("smollm-135m", dict(paged=True, page_size=8, preemption=True)),
    "mamba2": ("mamba2-370m", {}),
}


def _engine(models, kind, **kw):
    name, opts = ENGINES[kind]
    cfg, params = models[name]
    return Engine(cfg, params, max_batch=2, max_len=32, device="cpu",
                  **opts, **kw)


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_state_keeps_its_tensors(models, kind):
    """Three requests through two slots: the cache tensors (KV or SSM
    state, lengths, block table) and the dense prefill's batch-1 cache
    are the same tensors after every step. The paged engine grows block
    tables across page boundaries and swaps a request out and back in."""
    eng = _engine(models, kind)
    reqs = [Request(prompt_tokens=list(p), max_new_tokens=n)
            for p, n in zip(PROMPTS, NEW)]
    queue = list(reqs)
    state = _ptrs(cache_tensors(eng.caches))
    prefill_state = None
    step = 0
    while queue or any(s is not None for s in eng.slots) or eng.preempted:
        while queue and eng.free_slots():
            r = queue.pop(0)
            first, payload = eng.prefill_request(r)
            eng.insert(r, payload, first)
            if not eng.paged:
                ptrs = _ptrs(cache_tensors(eng._prefill_caches))
                assert prefill_state in (None, ptrs)
                prefill_state = ptrs
        if eng.paged and step == 2:
            eng.preempt_slot(eng.slots.index(reqs[0]))
        eng.decode_step()
        assert _ptrs(cache_tensors(eng.caches)) == state, step
        step += 1
        assert step < 100
    assert [len(r.output_tokens) for r in reqs] == list(NEW)
    if eng.paged:
        assert eng.preempt_count == 1 and eng.resume_count == 1
        assert eng.swap_in_pages_total > 0
        eng.assert_no_page_leaks()


def test_paged_decode_crosses_page_boundaries(models):
    """The block table the paged decode graph reads is written in place
    when a slot's next token starts a new page."""
    eng = _engine(models, "paged")
    r = Request(prompt_tokens=list(PROMPTS[0]), max_new_tokens=14)
    first, payload = eng.prefill_request(r)
    slot = eng.insert(r, payload, first)
    pages = eng.caches["pages"]
    mapped = []
    while any(s is r for s in eng.slots):
        mapped.append(int((pages[slot] > 0).sum()))
        eng.decode_step()
        assert eng.caches["pages"] is pages
    # 6 + 14 tokens on pages of 8: one page, then a second, then a third
    assert mapped[0] == 1 and max(mapped) == 3


def test_graph_key_is_shapes_dtypes_and_scalar_values(models):
    cfg, params = models["smollm-135m"]
    tok = torch.zeros(2, dtype=torch.int32)
    key, st, it = graph_key((params, make_caches(cfg, 2, 32)), (tok, 3, None))
    assert len(st) == len(cache_tensors(make_caches(cfg, 2, 32))) + len(
        [t for t in _leaves(params)]) and it == [tok]
    same = graph_key((params, make_caches(cfg, 2, 32)),
                     (torch.ones(2, dtype=torch.int32), 3, None))[0]
    assert key == same
    for state, inputs in [
            ((params, make_caches(cfg, 3, 32)), (tok, 3, None)),   # batch
            ((params, make_caches(cfg, 2, 64)), (tok, 3, None)),   # length
            ((params, make_caches(cfg, 2, 32, dtype=torch.bfloat16)),
             (tok, 3, None)),                                      # dtype
            ((params, make_caches(cfg, 2, 32)),
             (tok.long(), 3, None)),                               # dtype
            ((params, make_caches(cfg, 2, 32)), (tok, 4, None)),   # scalar
            ((params, make_caches(cfg, 2, 32)), (tok, 3, tok))]:   # None
        assert graph_key(state, inputs)[0] != key


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_decode_steps_share_one_key(models, kind, monkeypatch):
    """Every decode step of an engine (and every text prefill of a dense
    one) has the key of the first, so one graph serves them all."""
    keys = {}
    real = GraphStep.__call__

    def spy(self, state, *inputs):
        keys.setdefault(self.fn.__name__, set()).add(
            graph_key(state, inputs)[0])
        return real(self, state, *inputs)

    monkeypatch.setattr(GraphStep, "__call__", spy)
    eng = _engine(models, kind)
    for p, n in zip(PROMPTS, NEW):
        eng.run_request(Request(prompt_tokens=list(p), max_new_tokens=n))
    assert len(keys["decode"]) == 1
    assert len(keys.get("dense_prefill", ())) == (0 if eng.paged else 1)


@pytest.mark.parametrize("opts,routed", [
    ({}, {"dense_prefill", "decode"}),
    (dict(paged=True, page_size=8), {"decode"}),
    (dict(paged=True, page_size=8, chunked_prefill=True, prefill_chunk=8,
          prefix_cache=True, n_pool_pages=40), {"decode"}),
])
def test_only_decode_and_dense_prefill_reach_the_runner(models, monkeypatch,
                                                        opts, routed):
    """The paged whole-prompt prefill and the suffix/chunk prefill stay
    eager: their steps never reach a GraphStep."""
    seen = []
    real = GraphStep.__call__

    def spy(self, state, *inputs):
        seen.append(self.fn.__name__)
        return real(self, state, *inputs)

    monkeypatch.setattr(GraphStep, "__call__", spy)
    cfg, params = models["smollm-135m"]
    eng = Engine(cfg, params, max_batch=2, max_len=32, device="cpu", **opts)
    for _ in range(2):                 # the second run hits the prefix cache
        eng.run_request(Request(prompt_tokens=list(range(2, 21)),
                                max_new_tokens=3))
    assert set(seen) == routed
    assert seen.count("decode") == 2 * 2      # two steps after the first token


def test_replayed_launches_add_up_to_eager_ones(monkeypatch):
    """A capture's counts are taken back and added once a replay: N
    replays count what N eager calls count."""
    for mod in (DK, FK, PK, SK):
        monkeypatch.setattr(mod, "LAUNCHES", 0)

    def step():                  # as a llava layer pair: 2 flash, 2 decode
        FK.LAUNCHES += 2
        DK.LAUNCHES += 2
        return "out"

    for _ in range(3):
        step()
    eager = ops.launch_counts()
    ops.reset_launch_counts()
    out, counts = recorded_launches(step)
    assert out == "out"
    assert counts == {"flash_attention": 2, "decode_attention": 2}
    assert set(ops.launch_counts().values()) == {0}
    for _ in range(3):
        ops.add_launches(counts)
    assert ops.launch_counts() == eager


@pytest.mark.parametrize("name", ["smollm-135m", "mamba2-370m"])
def test_dense_prefill_payload_survives_the_next_prefill(models, name):
    """The dense prefill fills one batch-1 cache from scratch and hands
    back copies: a held payload is unchanged by the next prefill, and a
    prefill after another gives what a fresh engine gives."""
    cfg, params = models[name]
    eng = Engine(cfg, params, max_batch=2, max_len=32, device="cpu")
    r1, r2 = (Request(prompt_tokens=list(p), max_new_tokens=4)
              for p in PROMPTS[:2])
    f1, p1 = eng.prefill_request(r1)
    held = clone_caches(p1)
    own = {t.data_ptr() for t in cache_tensors(eng._prefill_caches)}
    assert not own & {t.data_ptr() for t in cache_tensors(p1)}
    f2, p2 = eng.prefill_request(r2)
    for a, b in zip(cache_tensors(p1), cache_tensors(held)):
        assert torch.equal(a, b)
    fresh = Engine(cfg, params, max_batch=2, max_len=32, device="cpu")
    f2_fresh, p2_fresh = fresh.prefill_request(
        Request(prompt_tokens=list(PROMPTS[1]), max_new_tokens=4))
    assert f2 == f2_fresh
    for a, b in zip(cache_tensors(p2), cache_tensors(p2_fresh)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("symbol,wrapper", [
    ("_ZN12_GLOBAL__N_12tc15flash_tc_kernelILi128EEEv14CUtensorMap_stS1_S1_"
     "PKiS3_P13__nv_bfloat16iiiiiif", "flash_attention"),
    ("_ZN12_GLOBAL__N_12cc16flash_fwd_kernelIfLi64EEEvPKT_S4_S4_PKiS6_PS2_"
     "iiiiiiif", "flash_attention"),
    ("_ZN2rt19decode_split_kernelI13__nv_bfloat16Li128ELi4EN12_GLOBAL__N_1"
     "7DenseKVEEEvPKT_S6_S6_T2_PS4_PfPiiiiif", "decode_attention"),
    ("_ZN2rt19decode_split_kernelIfLi64ELi1EN12_GLOBAL__N_17PagedKVEEEvPKT_"
     "S5_S5_T2_PS3_PfPiiiiif", "paged_decode_attention"),
    ("_ZN12_GLOBAL__N_112state_kernelI13__nv_bfloat16Li128ELi64EEEvPKT_PKfS7_"
     "S5_", "ssd_scan"),
    ("_ZN12_GLOBAL__N_112recur_kernelIfEEvPKfS2_S2_Pfiiii", "ssd_scan"),
    ("_ZN12_GLOBAL__N_110out_kernelI13__nv_bfloat16Li128ELi64EEEvPKT_PKfS7_",
     "ssd_scan"),
    ("_ZN12_GLOBAL__N_121flash_bwd_prep_kernelI13__nv_bfloat16Li64EEEvPKT_"
     "S4_S4_S4_PKiS6_PfS7_iiiiiiif", "flash_attention_bwd"),
    ("_ZN12_GLOBAL__N_119flash_bwd_kv_kernelIfLi128EEEvPKT_S3_S3_S3_PKiS5_"
     "PKfS7_PS1_S8_iiiiiif", "flash_attention_bwd"),
    ("_ZN12_GLOBAL__N_118flash_bwd_q_kernelIfLi32EEEvPKT_S3_S3_S3_PKiS5_PKfS7_"
     "PS1_iiiiiif", "flash_attention_bwd"),
    ("_ZN12_GLOBAL__N_12tc21flash_bwd_dkdv_kernelILi128EEEv14CUtensorMap_st"
     "S2_S2_S2_PKiS4_PKfS6_P13__nv_bfloat16S8_iiiiiiff", "flash_attention_bwd"),
    ("_ZN12_GLOBAL__N_12tc19flash_bwd_dq_kernelILi64EEEv14CUtensorMap_stS2_S2_"
     "S2_PKiS4_PKfS6_P13__nv_bfloat16iiiiiiff", "flash_attention_bwd"),
    ("_ZN12_GLOBAL__N_117ssd_dstate_kernelI13__nv_bfloat16Li128EEEvPKT_PKfS6_"
     "S4_PfS7_iiii", "ssd_scan_bwd"),
    ("_ZN12_GLOBAL__N_118ssd_dfinish_kernelIfEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiii",
     "ssd_scan_bwd"),
    ("_ZN12_GLOBAL__N_116ssd_dpair_kernelI13__nv_bfloat16Li128EEEvPKT_S5_PKfS5_"
     "S5_S7_S5_PKdPS3_PfPdSC_SC_SC_SB_iiiii", "ssd_scan_bwd"),
    ("_ZN12_GLOBAL__N_115ssd_dcdb_kernelIfLi64EEEvPKT_S3_PKfS3_S3_S3_S3_PKdS5_"
     "PS1_S8_Pdiiiiii", "ssd_scan_bwd"),
    ("_ZN12_GLOBAL__N_115ssd_dsum_kernelIfEEvPKdS2_PfS3_iiii", "ssd_scan_bwd"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEE"
     "St5arrayIPcLm1EEEEviT0_T1_", None),
    ("_ZN2at6native17reduce_out_kernelIfEEvv", None),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas",
     None),
])
def test_graph_kernel_nodes_are_named_by_wrapper(symbol, wrapper):
    """A capture holds each wrapper's recorded launches against the graph's
    kernel nodes of that wrapper's device kernels, told apart by mangled
    name; every other kernel (PyTorch's, cuBLAS's) belongs to none."""
    assert ops.wrapper_of(symbol) == wrapper


def test_device_kernels_per_launch():
    assert ops.device_kernels() == {
        "flash_attention": 1, "flash_attention_bwd": 3,
        "decode_attention": 1, "paged_decode_attention": 1,
        "ssd_scan": SK.DEVICE_KERNELS, "ssd_scan_bwd": 6}


class _Counted:
    def __init__(self, **c):
        self.c = c

    def census(self):
        return dict(self.c)


def test_census_sums_steps_by_name(models):
    out = census([
        ("decode", _Counted(graphs=1, kernel_nodes=9, captures=1, replays=4,
                            **{"decode_attention nodes": 2})),
        ("prefill", _Counted(graphs=2, kernel_nodes=7, captures=2,
                             replays=0)),
        ("decode", _Counted(graphs=1, kernel_nodes=9, captures=1, replays=3,
                            **{"decode_attention nodes": 2}))])
    assert out == {
        "decode": {"graphs": 2, "kernel_nodes": 18, "captures": 2,
                   "replays": 7, "decode_attention nodes": 4},
        "prefill": {"graphs": 2, "kernel_nodes": 7, "captures": 2,
                    "replays": 0},
        "captures": 4, "replays": 7}
    eng = _engine(models, "dense")
    eng.run_request(Request(prompt_tokens=list(PROMPTS[0]), max_new_tokens=3))
    zero = {"graphs": 0, "kernel_nodes": 0, "programmatic_edges": 0,
            "captures": 0, "replays": 0}
    assert eng.graph_census() == {"decode": zero, "prefill": zero,
                                  "captures": 0, "replays": 0}


def test_held_to_eager_raises_when_a_call_differs():
    """The replay-versus-eager check runs each call eagerly on copies of
    the caches first; a step whose call differs from that run raises,
    and the runner is restored after the block."""
    calls = []

    def step(params, caches, x):
        calls.append(1)
        caches["len"].add_(1)
        return x + len(calls), caches

    caches = {"attn": (), "ssm": (), "len": torch.zeros(1, dtype=torch.int32)}
    real = GraphStep.__call__
    with pytest.raises(AssertionError, match="differs from the eager"):
        with held_to_eager() as replays:
            GraphStep(step)(({}, caches), torch.zeros(1))
    assert GraphStep.__call__ is real and replays == {}
    assert int(caches["len"]) == 1         # the eager run took a copy
