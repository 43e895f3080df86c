"""The port's dry-run builders (``launch/specs.py``) and dry-run
(``launch/dryrun.py``) against the JAX package's, on the CPU.

* ``build_case`` for every assigned arch and shape under the baseline
  rules, and under ``fsdp`` and ``fsdp`` + ``expert_parallel`` for the
  MoE archs: the abstract arguments (``meta`` tensors against the
  reference's ``ShapeDtypeStruct``s) leaf by leaf, ``in_specs``,
  ``donate``, ``train_plan`` and ``decode_supported``.
* The meta run: one full-size case of each family runs on ``meta`` and
  gives the shapes and dtypes of ``jax.eval_shape`` of the reference's
  case (the reference's ``with_sharding_constraint`` is replaced by the
  identity here: its 1x1 local mesh has explicit axes, which refuse a
  constraint; nothing in the reference changes).
* Per-device argument bytes, counted by hand for smollm-135m at 16x16.
* Real execution: the same ``fn`` on concrete f32 CPU tensors equals
  the reference's (reduced smollm and mixtral; logits and loss within
  1e-5, updated parameters within 1e-4), and ``grad_specs`` leaves the
  port's train step bitwise as it was.

No test here allocates a full-size model: full size appears only as
``meta`` tensors and ``ShapeDtypeStruct``s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ASSIGNED_ARCHS, SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.launch.mesh import make_local_mesh as jax_local_mesh  # noqa: E402
from repro.models import partitioning as JPT  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.training import optimizer as JOPT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import partitioning as PT  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import (flatten, leaves,  # noqa: E402
                                       param_pspecs)
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train import make_train_step  # noqa: E402

SIZES = {"data": 16, "model": 16}
MOE_ARCHS = [a for a in ASSIGNED_ARCHS if get_config(a).moe is not None]
BUILDER_CASES = ([(a, {}) for a in ASSIGNED_ARCHS]
                 + [(a, kw) for a in MOE_ARCHS
                    for kw in ({"fsdp": True},
                               {"fsdp": True, "expert_parallel": True})])


def _dt(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _ref_sig(tree):
    return [(tuple(x.shape), _dt(x)) for x in jax.tree.leaves(tree)]


def _port_sig(tree):
    return [(tuple(x.shape), _dt(x)) for x in flatten(tree) if x is not None]


def _ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _port_specs(tree):
    return [tuple(s) for s in flatten(tree) if s is not None]


def _identity_constraint(monkeypatch):
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: x)


@pytest.mark.parametrize("arch,kw", BUILDER_CASES, ids=lambda v: (
    "-".join(v) or "baseline") if isinstance(v, dict) else v)
def test_build_case_equals_reference(arch, kw):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    ref_rules = JPT.tp_rules(axis_sizes=SIZES, **kw)
    rules = PT.tp_rules(axis_sizes=SIZES, **kw)
    for name, jshape in SHAPES.items():
        shape = InputShape(jshape.name, jshape.seq_len, jshape.global_batch,
                           jshape.kind)
        assert S.decode_supported(cfg, shape) == \
            JS.decode_supported(jcfg, jshape), name
        if shape.kind == "train":
            assert S.train_plan(rules, shape) == \
                JS.train_plan(ref_rules, jshape), name
        kv = ([(None, None), (jnp.float8_e4m3fn, torch.float8_e4m3fn)]
              if shape.kind == "decode" else [(None, None)])
        for jkv, tkv in kv:
            ref = JS.build_case(jcfg, jshape, ref_rules, kv_dtype=jkv)
            got = S.build_case(cfg, shape, rules, kv_dtype=tkv)
            assert len(got.args) == len(ref.args)
            assert all(t.device.type == "meta" for t in flatten(got.args)
                       if t is not None)
            for i, (a, b) in enumerate(zip(got.args, ref.args)):
                assert (a is None) == (b is None), (name, i)
                assert _port_sig(a) == _ref_sig(b), (name, i)
            for i, (a, b) in enumerate(zip(got.in_specs, ref.in_specs)):
                assert (a is None) == (b is None), (name, i)
                assert _port_specs(a) == _ref_specs(b), (name, i)
            assert got.donate == ref.donate, name


# one full-size case of each family: dense (a train step with grad_specs,
# which the reference passes under the ZeRO hybrid rules), MoE (decode),
# hybrid SSM (decode at 524k) and encoder-decoder (prefill)
META_CASES = [
    ("llama3.2-1b", "train_4k", {"fsdp": True, "expert_parallel": True}),
    ("mixtral-8x7b", "decode_32k", {"expert_parallel": True}),
    ("jamba-v0.1-52b", "long_500k", {}),
    ("whisper-base", "prefill_32k", {}),
]


@pytest.mark.parametrize("arch,shape_name,kw", META_CASES)
def test_meta_run_shapes_equal_eval_shape(arch, shape_name, kw,
                                          monkeypatch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jshape = SHAPES[shape_name]
    shape = InputShape(jshape.name, jshape.seq_len, jshape.global_batch,
                       jshape.kind)
    rules = PT.tp_rules(axis_sizes=SIZES, **kw)
    got_case = S.build_case(cfg, shape, rules)
    if shape.kind == "train":
        # the reference passes grad_specs here; so does the port
        assert S.train_plan(rules, shape)[0] > 1 and rules.size("embed") > 1
        specs = []
        monkeypatch.setattr(PT, "_constrain",
                            lambda x, s: specs.append(s) or x)
    with torch.device("meta"):
        out = got_case.fn(*got_case.args)
    ref_case = JS.build_case(jcfg, jshape, JPT.tp_rules(axis_sizes=SIZES,
                                                        **kw))
    _identity_constraint(monkeypatch)
    with jax_local_mesh():
        want = jax.eval_shape(ref_case.fn, *ref_case.args)
    assert all(t.device.type == "meta" for t in flatten(out)
               if t is not None)
    assert _port_sig(out) == _ref_sig(want)
    if shape.kind == "train":
        p_specs = [tuple(s) for s in leaves(param_pspecs(cfg, rules))]
        n_micro = S.train_plan(rules, shape)[0]
        # each micro-gradient and the accumulator, then the zeros
        assert [tuple(s) for s in specs[-len(p_specs):]] == p_specs
        assert len([s for s in specs if tuple(s) in set(p_specs)]) >= \
            len(p_specs) * (2 * n_micro + 1)


def test_device_bytes_by_hand_smollm_16x16():
    """smollm-135m at 16x16, baseline rules: vocab 49152, q 576, kv 192 and
    ff 1536 split 16 ways on 'model'; in the decode cache its 3 kv heads
    stay whole and the 32768 slots take 'model' instead, the batch of 128
    takes 'data'."""
    cfg = get_config("smollm-135m")
    rules = PT.tp_rules(axis_sizes=SIZES)
    case = S.build_case(cfg, InputShape("decode_32k", 32768, 128, "decode"),
                        rules)
    L, d = 30, 576
    params = 2 * (49152 // 16 * d + d                       # embed, norm
                  + L * d                                   # attn norm
                  + L * d * (576 // 16) * 2                 # wq, wo
                  + L * d * (192 // 16) * 2                 # wk, wv
                  + L * d                                   # mlp norm
                  + L * d * (1536 // 16) * 3)               # wi, wg, wo
    caches = (2 * L * (128 // 16) * (32768 // 16) * 3 * 64 * 2   # k, v
              + 4 * L * (128 // 16) * (32768 // 16)              # kv_pos
              + 4 * 128 // 16)                                   # len
    tokens = 4 * 128 // 16
    got = [dryrun.device_bytes(s, a, SIZES)
           for s, a in zip(case.in_specs, case.args)]
    assert got == [params, tokens, caches]
    # on one device every argument is whole
    whole = [sum(t.numel() * t.element_size() for t in flatten(a)
                 if t is not None) for a in case.args]
    assert [dryrun.device_bytes(s, a, make_local_mesh().axis_sizes)
            for s, a in zip(case.in_specs, case.args)] == whole
    assert dryrun.sanitize(PT.P("model", ("pod", "data")), (50280, 64, 7),
                           {"pod": 2, "data": 16, "model": 16}) == \
        PT.P(None, ("pod", "data"), None)


def test_run_case_records_and_skips():
    res = dryrun.run_case("smollm-135m", "decode_32k", save=False)
    assert res["memory"]["argument_bytes"] == sum(
        res["memory"]["argument_bytes_by_arg"])
    assert res["memory"]["peak_bytes"] is None
    # a dense decoder's decode under the baseline rules: rank 0's
    # collectives counted on meta, over NVLink's rate
    assert res["collective_reason"] is None
    assert set(res["collective_bytes"]) == {"all-reduce", "all-gather"}
    r = res["roofline"]
    assert r["collective_s"] == sum(res["collective_bytes"].values()) / \
        dryrun.NVLINK_BW
    assert r["compute_s"] > 0
    assert r["bottleneck"] == max(
        ("compute", "memory", "collective"),
        key=lambda k: r[f"{k}_s"])
    assert res["outputs_match_donated"] and res["n_chips"] == 256
    assert dryrun.report("t", res).startswith("OK   t: run=")
    skip = dryrun.run_case("glm4-9b", "long_500k", save=False)
    assert skip["skipped"] == JS.decode_supported(
        jax_get_config("glm4-9b"), SHAPES["long_500k"])
    assert dryrun.report("t", skip).startswith("SKIP t: ")
    moe = dryrun.run_case("mixtral-8x7b", "decode_32k", save=False,
                          rules_kw={"expert_parallel": True})
    assert moe["moe_branch"] == "spmd"


def _concrete(arch):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    pp = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, pp


def _close(a, b, atol, rtol):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b"])
def test_cases_run_real_steps_as_the_reference(arch, monkeypatch):
    jcfg, cfg, jp, pp = _concrete(arch)
    kw = {"expert_parallel": True} if cfg.moe is not None else {}
    sizes = make_local_mesh().axis_sizes
    rules = PT.tp_rules(axis_sizes=sizes, **kw)
    ref_rules = JPT.tp_rules(axis_sizes=sizes, **kw)
    _identity_constraint(monkeypatch)
    rng = np.random.default_rng(3)
    b, s = 2, 16

    def cases(kind, batch):
        jshape = JShape(kind, s, batch, kind)
        shape = InputShape(kind, s, batch, kind)
        return (S.build_case(cfg, shape, rules),
                JS.build_case(jcfg, jshape, ref_rules))

    def check_shapes(case, concrete):
        want = [t.shape for t in flatten(case) if t is not None]
        assert [t.shape for t in flatten(concrete) if t is not None] == want

    # prefill, then decode over the caches it filled
    got, ref = cases("prefill", b)
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    lengths = np.array([s, s - 5], np.int32)
    caches = T.make_caches(cfg, b, s, dtype=torch.float32)
    args = (pp, torch.from_numpy(tokens), torch.from_numpy(lengths), caches,
            None, None)
    check_shapes(got.args, args)
    logits, caches = got.fn(*args)
    with jax_local_mesh():
        ref_logits, ref_caches = jax.jit(ref.fn)(
            jp, jnp.asarray(tokens), jnp.asarray(lengths),
            JT.make_caches(jcfg, b, s, dtype=jnp.float32), None, None)
    _close(logits, ref_logits, 1e-5, 1e-5)
    got, ref = cases("decode", b)
    nxt = rng.integers(0, cfg.vocab, (b,), dtype=np.int32)
    check_shapes(got.args[2], caches)
    logits, _ = got.fn(pp, torch.from_numpy(nxt), caches)
    with jax_local_mesh():
        ref_logits, _ = jax.jit(ref.fn)(jp, jnp.asarray(nxt), ref_caches)
    _close(logits, ref_logits, 1e-5, 1e-5)

    # a train step: n_micro and loss_chunk from train_plan (4 and 512)
    got, ref = cases("train", 4)
    assert S.train_plan(rules, InputShape("t", s, 4, "train")) == (4, 512)
    batch = {k: rng.integers(0, cfg.vocab, (4, s), dtype=np.int32)
             for k in ("tokens", "labels")}
    state = AdamW().init(pp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    check_shapes(got.args, (pp, state, tb))
    new_p, new_s, metrics = got.fn(pp, state, tb)
    with jax_local_mesh():
        ref_p, ref_s, ref_m = jax.jit(ref.fn)(
            jp, JOPT.AdamW().init(jp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    _close(metrics["loss"], ref_m["loss"], 1e-5, 1e-5)
    for a, r in zip(flatten(new_p), jax.tree.leaves(ref_p)):
        _close(a, r, 1e-4, 1e-4)
    for a, r in zip(flatten(new_s.mu), jax.tree.leaves(ref_s.mu)):
        _close(a, r, 1e-5, 1e-3)
    assert int(new_s.step) == int(ref_s.step) == 1


def test_grad_specs_step_is_bitwise_the_plain_step(monkeypatch):
    _, cfg, _, pp = _concrete("smollm-135m")
    rules = PT.tp_rules(axis_sizes=make_local_mesh().axis_sizes)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 12),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    opt = AdamW(lr=1e-3, warmup_steps=1)
    specs = param_pspecs(cfg, rules)
    seen = []
    constrain = PT._constrain
    monkeypatch.setattr(PT, "_constrain",
                        lambda x, s: seen.append(s) or constrain(x, s))
    outs = []
    for grad_specs in (None, specs):
        step = make_train_step(cfg, opt, num_microbatches=2,
                               grad_specs=grad_specs)
        with PT.use_rules(rules):
            outs.append(step(pp, opt.init(pp), batch))
        seen.append("end")
    (p0, s0, m0), (p1, s1, m1) = outs
    for a, b in zip(flatten((p0, s0, m0)), flatten((p1, s1, m1))):
        assert torch.equal(a, b)
    # only the second step constrained the gradients: the zeros, then
    # each of 2 micro-gradients and the sum after it
    n = len(leaves(specs))
    first = seen[:seen.index("end")]
    second = seen[seen.index("end") + 1:-1]
    assert len(second) - len(first) == n * 5
