"""The port's sharding layer against the JAX package's, on the CPU.

* The rule tables of ``tp_rules`` in each of the reference's six
  variants (``tests/test_variants.py``), ``size`` of every logical name,
  and ``param_pspecs`` / ``cache_pspecs`` (dense and paged) of every
  arch, leaf by leaf, with the reference's duplicate-axis check
  (``test_rule_sets_produce_valid_pspecs``).
* The ``shard`` annotations: the distinct (shape, spec) pairs that the
  reference hands ``with_sharding_constraint`` (monkeypatched here to
  record them) equal the pairs the port hands ``partitioning._constrain``,
  for prefill, decode and training forwards of five reduced configs.
  Sets, since the reference traces a scanned layer body once and the
  port calls each layer.
* ``moe_block``'s branch (the expert-parallel one refuses a mesh
  description: it runs across live ranks, held in
  ``test_torch_expert_parallel.py``), ``shard`` without rules, the mesh
  descriptions and ``distributed.ensure_initialized`` in one process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import partitioning as JPT  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.models.params import param_pspecs as jax_param_pspecs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.launch import distributed, mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import partitioning as PT  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import flatten, param_pspecs  # noqa: E402

SIZES = {"data": 16, "model": 16, "pod": 2}
# the reference's six rule variants (tests/test_variants.py)
VARIANTS = [{}, {"fsdp": True}, {"expert_parallel": True},
            {"fsdp": True, "expert_parallel": True}, {"decode_kv": "seq"},
            {"multi_pod": True}]
LOGICAL = ("batch", "seq", "embed", "vocab", "q", "kv", "heads", "ff",
           "expert", "inner", "state", "layers", "act_embed", "act_ff",
           "act_inner", "act_vocab", "act_heads", "act_kv_heads",
           "act_expert", "kv_seq", "kv_heads", "unknown")
FORWARD_ARCHS = ["smollm-135m", "llava-next-mistral-7b", "mixtral-8x7b",
                 "mamba2-370m", "whisper-base"]
B, S, MAX_LEN, N_MM = 2, 8, 16, 4


def _ref_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_leaves(tree):
    return [tuple(s) for s in flatten(tree) if s is not None]


def _no_duplicate_axes(spec):
    seen = []
    for entry in spec:
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            assert a not in seen, f"duplicate mesh axis {a} in {spec}"
            seen.append(a)


@pytest.mark.parametrize("kw", VARIANTS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "baseline")
def test_rules_and_specs_equal_reference(kw):
    ref = JPT.tp_rules(axis_sizes=SIZES, **kw)
    got = PT.tp_rules(axis_sizes=SIZES, **kw)
    assert got.rules == ref.rules
    assert got.axis_sizes == ref.axis_sizes and got.mesh is None
    for name in LOGICAL:
        assert got.size(name) == ref.size(name), name
        assert tuple(got.spec((name, None))) == tuple(ref.spec((name, None)))
    for arch in ALL_ARCHS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        want = _ref_leaves(jax_param_pspecs(jcfg, ref))
        have = _port_leaves(param_pspecs(cfg, got))
        assert have == want, arch
        for spec in have:
            _no_duplicate_axes(spec)
        for layout in ("dense", "paged"):
            want = _ref_leaves(JT.cache_pspecs(jcfg, ref, layout))
            have = _port_leaves(T.cache_pspecs(cfg, got, layout))
            assert have == want, (arch, layout)
            for spec in have:
                _no_duplicate_axes(spec)


def test_specs_without_rules_and_spec_normalisation():
    """No rules: every parameter spec is the empty spec, as the
    reference's; entries normalise as jax's PartitionSpec does."""
    for arch in ("smollm-135m", "jamba-v0.1-52b", "whisper-base"):
        assert _port_leaves(param_pspecs(get_config(arch), None)) == \
            _ref_leaves(jax_param_pspecs(jax_get_config(arch), None))
        assert _port_leaves(T.cache_pspecs(get_config(arch), None)) == \
            _ref_leaves(JT.cache_pspecs(jax_get_config(arch), None))
    for entries in [(("data",), None, "model"), ((), ("pod", "data")),
                    (["model"],)]:
        assert tuple(PT.P(*entries)) == tuple(JP(*entries))
    assert isinstance(PT.P(), tuple)


def _inputs(arch):
    """Reference and port params and inputs of a reduced config, made
    from seeds with numpy."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    pp = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(7)
    np_in = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "next": rng.integers(0, cfg.vocab, (B,), dtype=np.int32)}
    if cfg.frontend is not None:
        n = cfg.encoder.n_ctx if cfg.encoder is not None else N_MM
        key = "enc_frames" if cfg.encoder is not None else "mm_embeds"
        np_in[key] = rng.standard_normal(
            (B, n, cfg.frontend.feature_dim)).astype(np.float32)
    return jcfg, cfg, jp, pp, np_in


def _run_ref(jcfg, jp, np_in):
    j = {k: jax.numpy.asarray(v) for k, v in np_in.items()}
    extra = {k: j[k] for k in ("mm_embeds", "enc_frames") if k in j}
    n_mm = np_in["mm_embeds"].shape[1] if "mm_embeds" in np_in else 0
    caches = JT.make_caches(jcfg, B, MAX_LEN, dtype=jax.numpy.float32)
    lengths = jax.numpy.asarray([S + n_mm, S + n_mm - 3], jax.numpy.int32)
    _, caches = JM.prefill_forward(jp, jcfg, j["tokens"], caches,
                                   lengths=lengths, **extra)
    yield "prefill"
    JM.decode_forward(jp, jcfg, j["next"], caches)
    yield "decode"
    batch = {"tokens": j["tokens"], "labels": j["labels"], **extra}
    JM.train_forward(jp, jcfg, batch)
    yield "train"


def _run_port(cfg, pp, np_in):
    t = {k: torch.from_numpy(v) for k, v in np_in.items()}
    extra = {k: t[k] for k in ("mm_embeds", "enc_frames") if k in t}
    n_mm = np_in["mm_embeds"].shape[1] if "mm_embeds" in np_in else 0
    caches = T.make_caches(cfg, B, MAX_LEN, dtype=torch.float32)
    lengths = torch.tensor([S + n_mm, S + n_mm - 3], dtype=torch.int32)
    _, caches = M.prefill_forward(pp, cfg, t["tokens"], caches,
                                  lengths=lengths, **extra)
    yield "prefill"
    M.decode_forward(pp, cfg, t["next"], caches)
    yield "decode"
    batch = {"tokens": t["tokens"], "labels": t["labels"], **extra}
    M.train_forward(pp, cfg, batch)
    yield "train"


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_shard_annotations_equal_reference(arch, monkeypatch):
    jcfg, cfg, jp, pp, np_in = _inputs(arch)
    kw = {"expert_parallel": True} if cfg.moe is not None else {}
    sizes = {"data": 2, "model": 2}

    ref, got, seen = {}, {}, set()

    def record_ref(x, spec):
        seen.add((tuple(x.shape), tuple(spec)))
        return x

    def record_port(x, spec):
        assert isinstance(spec, PT.PartitionSpec)
        seen.add((tuple(x.shape), tuple(spec)))
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", record_ref)
    monkeypatch.setattr(PT, "_constrain", record_port)
    with jax_mesh.make_local_mesh(), \
            JPT.use_rules(JPT.tp_rules(axis_sizes=sizes, **kw)):
        for name in _run_ref(jcfg, jp, np_in):
            ref[name], seen = seen, set()
    with PT.use_rules(PT.tp_rules(axis_sizes=sizes, **kw)):
        for name in _run_port(cfg, pp, np_in):
            got[name], seen = seen, set()
    assert set(got) == set(ref) == {"prefill", "decode", "train"}
    for name in ref:
        assert ref[name], name
        assert got[name] == ref[name], (name, got[name] ^ ref[name])
    # some dims split over 'model', others left whole (the divisibility
    # guard: 1 kv head over 2), as in the reference
    entries = {e for _, spec in ref["prefill"] for e in spec}
    assert "model" in entries and None in entries


def test_shard_without_rules_returns_the_tensor(monkeypatch):
    calls, constrain = [], PT._constrain
    monkeypatch.setattr(PT, "_constrain", lambda x, s: calls.append(s))
    x = torch.zeros(4, 6)
    assert PT.current_rules() is None
    assert PT.shard(x, "batch", "act_embed") is x
    assert calls == []
    with PT.use_rules(PT.tp_rules(axis_sizes={"data": 2, "model": 3})):
        PT.shard(x, "batch", "act_vocab")
        PT.shard(x, "act_vocab", "act_heads")   # 4 over 3 stays whole
        with PT.use_rules(None):
            assert PT.shard(x, "batch", "act_embed") is x
    assert PT.current_rules() is None
    assert [tuple(s) for s in calls] == [("data", "model"), (None, "model")]
    # in one process the constraint itself hands the tensor back
    assert constrain(x, PT.P("data", None)) is x


def test_moe_block_refuses_the_expert_parallel_branch():
    """rules.mesh set and the expert axis split: the explicit
    expert-parallel branch, which runs across live ranks only
    (``tests/test_torch_expert_parallel.py``): with a mesh description in
    its place moe_block refuses it (TypeError) instead of taking another
    branch; with mesh None it runs the expert-sharded SPMD mode, equal to
    the block without rules."""
    cfg = get_config("mixtral-8x7b").reduced()
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    pp = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    p = {k: w[0] for k, w in pp["blocks"][0]["moe"].items()}
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    sizes = mesh.make_local_mesh().axis_sizes | {"model": 2}
    rules = PT.tp_rules(expert_parallel=True, axis_sizes=sizes,
                        mesh=mesh.make_local_mesh())
    with PT.use_rules(rules), pytest.raises(TypeError,
                                            match="ProcessMesh"):
        MOE.moe_block(p, x, cfg)
    out, aux = MOE.moe_block(p, x, cfg)
    with PT.use_rules(PT.tp_rules(expert_parallel=True, axis_sizes=sizes)):
        out2, aux2 = MOE.moe_block(p, x, cfg)
    assert torch.equal(out, out2) and torch.equal(aux, aux2)


def test_mesh_descriptions_equal_reference():
    local = jax_mesh.make_local_mesh()
    got = mesh.make_local_mesh()
    assert got.shape == tuple(local.devices.shape)
    assert got.axis_names == tuple(local.axis_names)
    assert got.axis_sizes == {"data": 1, "model": 1} and got.size == 1
    single = mesh.make_production_mesh()
    multi = mesh.make_production_mesh(multi_pod=True)
    # the reference's jax.make_mesh arguments (src/repro/launch/mesh.py)
    assert (single.shape, single.axis_names) == ((16, 16), ("data", "model"))
    assert (multi.shape, multi.axis_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    assert single.size == 256 and multi.size == 512
    assert multi.axis_sizes == {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "1", "RANK": "0",
                                      "LOCAL_RANK": "0"}])
def test_distributed_is_a_no_op_in_one_process(env, monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed.ensure_initialized() is False
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("REPRO_MULTI_POD", raising=False)
    assert distributed.is_multi_pod() is False
    monkeypatch.setenv("REPRO_MULTI_POD", "2")
    assert distributed.is_multi_pod() is True
