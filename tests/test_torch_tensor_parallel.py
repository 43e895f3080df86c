"""Tensor parallelism across real ranks, on the CPU: gloo ranks started by
``launch/ranks.run_ranks`` under the baseline ``tp_rules()`` (fsdp and
expert parallelism off, ``decode_kv="heads"``) with a ``ProcessMesh``
whose 'model' axis is 2 or 4; f32, reduced configs.

* Head layouts of the reduced llama3.2-1b (``Plan.heads``, a
  ``dataclasses.replace`` of its heads): 4 q over 2 kv heads (a clean
  cut at 'model' 2; at 4 the kv columns are gathered), 4 q over 1 kv
  head (the kv columns gathered, the dense cache cut over its sequence,
  a decode step combined across ranks by log-sum-exp), 6 q over 2 kv
  heads (at 'model' 4 the q columns gathered; a clean cut at 2); at
  meshes 1 x 2, 1 x 4 and 2 x 2.
* Steps: the case builders' dense prefill and three decode steps, each
  later one fed the greedy tokens of the one before; the same with fp8
  K/V; llava's prefill with image features through its projector; and
  on the paged pool (data 1) a prefill, a suffix prefill over its cached
  prefix and decode steps. Each step's logits and caches gathered from
  the ranks (blocks the ranks share bitwise equal) and the greedy tokens
  against one process of the port at 1e-5.
* Counts: each rank's collective bytes against their closed form, and
  the dry-run's count of the same rank block on ``meta``
  (``dryrun.rank_collectives``) against the gloo run's.
* Placement: a rank's blocks of a full-size case hold exactly the
  dry-run's per-device bytes; ``init_params``' cut draws the whole
  tree's block.
* The reference's GSPMD program on forced host devices (a subprocess):
  its dense prefill and decode steps under the same rules, run on the
  port's parameters and inputs at 1 x 2 and 1 x 4 (4 q over 1 kv head)
  and at 1 x 2 (4 q over 2 kv heads), the ranks' gathered logits, caches
  and greedy tokens held to its numbers at 1e-5; and its steps compiled
  at (1, 2), whose ``hlo.collective_bytes`` are printed beside the
  port's count of the same steps. Equality of the counts is not
  required: GSPMD chooses its own collectives (and XLA's CPU program
  carries bf16 collectives in f32, so both sides are counted in f32
  here).
* Refusals: whisper's encoder and cross-attention, and the train step
  of whisper and of the SSM block, raise ``NotImplementedError`` under a
  rank mesh that would cut their leaves (``moe_block`` and ``ssm_block``
  run under it: ``tests/test_torch_tp_moe_ssm.py``);
  a gradient through the sequence-cut decode combine raises, while the
  other TP collectives carry their transposes (the train step across
  ranks: ``tests/test_torch_train_parallel.py``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import collectives, dryrun  # noqa: E402
from repro_torch.launch import ranks as R  # noqa: E402
from repro_torch.launch.mesh import (CountingMesh, MeshDesc,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.specs import build_case  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import partitioning as PT  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import (abstract_params,  # noqa: E402
                                       flatten, init_params)
from repro_torch.models.transformer import cache_pspecs  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = [(1, 2), (1, 4), (2, 2)]
ARCH = "llama3.2-1b"
# (n_heads, n_kv_heads): a clean cut at 'model' 2, the kv columns
# gathered (one kv head), the q columns gathered at 'model' 4
LAYOUTS = {"4q2kv": (4, 2), "4q1kv": (4, 1), "6q2kv": (6, 2)}
PREFILL = (4, 16, (16, 11, 16, 9))
LLAVA_PREFILL = (4, 32, (32, 20, 32, 17))     # 16 image tokens each
PAGED = (8, 20, 37)                           # page, prefix, prompt
DECODE = 3
FP8 = "float8_e4m3fn"
TIMEOUT = 300
TOL = dict(atol=1e-5, rtol=1e-5)


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


def _plans(mesh):
    out = {}
    tp = dict(expert_parallel=False, decode=DECODE)
    for name, heads in LAYOUTS.items():
        out[("dense", name)] = R.Plan(ARCH, heads=heads, prefill=PREFILL,
                                      **tp)
        if mesh[0] == 1:
            out[("paged", name)] = R.Plan(ARCH, heads=heads, paged=PAGED,
                                          **tp)
    for name in ("4q2kv", "4q1kv"):
        out[("fp8", name)] = R.Plan(ARCH, heads=LAYOUTS[name],
                                    prefill=PREFILL, kv_dtype=FP8, **tp)
    out[("llava", "4q1kv")] = R.Plan("llava-next-mistral-7b",
                                     prefill=LLAVA_PREFILL, **tp)
    return out


CASES = [(mesh, form, layout) for mesh in MESHES
         for form, layout in _plans(mesh)]

# the steps held to the reference's GSPMD program on the same parameters
# and inputs: (mesh, layout) of dense plans above
REF_STEPS = [((1, 2), "4q1kv"), ((1, 4), "4q1kv"), ((1, 2), "4q2kv")]
REF_DEVICES = 4

# the reference in its own process on forced host devices: its prefill and
# decode steps compiled under tp_rules at (1, 2) (hlo.collective_bytes of
# each, printed), and at each of REF_STEPS run on the port's parameters
# and inputs (FEED), the later decode steps fed their greedy tokens
REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch.hlo import collective_bytes
from repro.launch.specs import build_case
from repro.models.params import abstract_params
from repro.models.partitioning import tp_rules
from repro.models.transformer import make_caches

arch, feed_file, out_file = sys.argv[1:4]
s_ref, b_ref, n_decode = map(int, sys.argv[4:7])
steps = json.loads(sys.argv[7])
auto = (jax.sharding.AxisType.Auto,) * 2


def setup(shape):
    sizes = dict(zip(("data", "model"), shape))
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=auto,
                         devices=jax.devices()[:shape[0] * shape[1]])
    return sizes, mesh, tp_rules(axis_sizes=sizes)


def shardings(case, args, sizes, mesh):
    def one(spec, arg):
        if arg is None:
            return None
        entries = list(spec or ()) + [None] * (arg.ndim - len(spec or ()))
        out = []
        for dim, e in zip(arg.shape, entries):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n = 1
            for a in axes:
                n *= sizes[a]
            out.append(e if n > 1 and dim % n == 0 else None)
        return NamedSharding(mesh, P(*out))
    return jax.tree.map(one, case.in_specs, args,
                        is_leaf=lambda x: x is None or isinstance(x, P))


def f32(x):
    if x is None or not jnp.issubdtype(x.dtype, jnp.floating):
        return x
    return jax.ShapeDtypeStruct(x.shape, jnp.float32)


counts = {}
sizes, mesh, rules = setup((1, 2))
cfg = get_config(arch).reduced()
for kind in ("prefill", "decode"):
    case = build_case(cfg, InputShape(kind, s_ref, b_ref, kind), rules)
    args = jax.tree.map(f32, case.args)
    with jax.set_mesh(mesh):
        compiled = jax.jit(case.fn, in_shardings=shardings(
            case, args, sizes, mesh), donate_argnums=case.donate).lower(
                *args).compile()
    counts[kind] = collective_bytes(compiled.as_text())

feed = np.load(feed_file)
out = {}
for data, model, nq, nkv, tag in steps:
    sizes, mesh, rules = setup((data, model))
    cfg = dataclasses.replace(get_config(arch).reduced(), n_heads=nq,
                              n_kv_heads=nkv)
    tree = jax.tree.structure(abstract_params(cfg, jnp.float32))
    shapes = [x.shape for x in jax.tree.leaves(abstract_params(cfg))]
    leaves = [jnp.asarray(feed[f"{tag}_p{i}"])
              for i in range(tree.num_leaves)]
    assert [x.shape for x in leaves] == shapes, tag
    params = jax.tree.unflatten(tree, leaves)
    tokens = jnp.asarray(feed[tag + "_tokens"])
    b, s = tokens.shape
    pre = build_case(cfg, InputShape("prefill", s, b, "prefill"), rules)
    dec = build_case(cfg, InputShape("decode", s, b, "decode"), rules)
    args = (params, tokens, jnp.asarray(feed[tag + "_lengths"]),
            make_caches(cfg, b, s, dtype=jnp.float32), None, None)
    with jax.set_mesh(mesh):
        logits, caches = jax.jit(pre.fn, in_shardings=shardings(
            pre, args, sizes, mesh))(*args)
        recs = [("prefill", logits, caches)]
        toks = jnp.asarray(feed[tag + "_decode"])
        sh = shardings(dec, (params, toks, caches), sizes, mesh)
        step = jax.jit(dec.fn, in_shardings=sh)
        for i in range(n_decode):
            # the step's outputs come back placed as its program chose
            toks, caches = jax.device_put((toks, caches), (sh[1], sh[2]))
            logits, caches = step(params, toks, caches)
            recs.append((f"decode{i}", logits, caches))
            toks = jnp.argmax(logits, -1).astype(jnp.int32)
    for name, logits, caches in recs:
        out[f"{tag}_{name}_logits"] = np.asarray(logits)
        for j, c in enumerate(jax.tree.leaves(caches)):
            out[f"{tag}_{name}_c{j}"] = np.asarray(c)
np.savez(out_file, **out)
print(json.dumps(counts))
"""
REF_SHAPE = (64, 2)      # length, batch of the reference's counted steps


def _ref_tag(mesh, layout):
    return f"{_ids(mesh)}_{layout}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of ranks, started once a mesh, with every plan of that
    mesh, and each plan in one process; the reference's subprocess runs
    meanwhile, fed the parameters and inputs of REF_STEPS' plans."""
    base = tmp_path_factory.mktemp("tp_ranks")
    ones, feed, steps = {}, {}, []
    for mesh, layout in REF_STEPS:
        plan = _plans(mesh)[("dense", layout)]
        one = R.run_plan(plan, MeshDesc(mesh, AXES), "cpu")
        ones[(mesh, "dense", layout)] = one
        tag = _ref_tag(mesh, layout)
        for i, t in enumerate(flatten(R.plan_params(plan, "cpu"))):
            feed[f"{tag}_p{i}"] = t.numpy()
        for k in ("tokens", "lengths", "decode"):
            feed[f"{tag}_{k}"] = one["inputs"][k].numpy()
        steps.append([*mesh, *LAYOUTS[layout], tag])
    np.savez(base / "feed.npz", **feed)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{REF_DEVICES}")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, ARCH,
                            str(base / "feed.npz"), str(base / "ref.npz"),
                            *map(str, REF_SHAPE), str(DECODE),
                            json.dumps(steps)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    out = {}
    try:
        for mesh in MESHES:
            desc = MeshDesc(mesh, AXES)
            plans = _plans(mesh)
            got = R.run_ranks(desc, [("plan", dict(plan=p))
                                     for p in plans.values()],
                              backend="gloo", device="cpu",
                              run_dir=base / _ids(mesh), timeout=TIMEOUT)
            for i, key in enumerate(plans):
                one = ones.get((mesh,) + key)
                out[(mesh,) + key] = dict(
                    plan=plans[key], ranks=[g[i] for g in got],
                    one=one or R.run_plan(plans[key], desc, "cpu"))
        text, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err
    out["reference"] = json.loads(text.strip().splitlines()[-1])
    out["reference_steps"] = dict(np.load(base / "ref.npz"))
    return out


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), **TOL)


def _steps(res):
    """(kind, record) of each step a plan ran, in order."""
    out = [(k, res[k]) for k in ("prefill", "suffix", "decode") if k in res]
    return out + [("decode", rec) for rec in res["more"]]


def _out_specs(cfg, rules, paged):
    return (rules.spec(("batch", "act_vocab")),
            cache_pspecs(cfg, rules, "paged" if paged else "dense"))


# ---------------------------------------------------------------------------
# the steps against one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,form,layout", CASES, ids=_ids)
def test_steps_match_one_process(runs, mesh, form, layout):
    run = runs[(mesh, form, layout)]
    plan, one = run["plan"], run["one"]
    desc = MeshDesc(mesh, AXES)
    cfg = R.plan_config(plan)
    rules = R.block_rules(plan, desc)
    specs = _out_specs(cfg, rules, form == "paged")
    per_rank = [_steps(res) for res in run["ranks"]]
    want = _steps(one)
    assert [k for k, _ in want] == [k for k, _ in per_rank[0]]
    for i, (kind, w) in enumerate(want):
        blocks = [steps[i][1]["out"] for steps in per_rank]
        # a rank's logits hold its block of the vocabulary
        assert blocks[0][0].shape[-1] == cfg.vocab // mesh[1]
        whole = R.gather_blocks(cfg, ("batch", "batch"), specs, blocks,
                                w["out"], rules, desc)
        for a, b in zip(flatten(whole), flatten(w["out"])):
            if b is None:
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, kind
            if a.dtype == torch.float8_e4m3fn:
                a, b = a.float(), b.float()
            _close(a, b)
    rows = one["greedy"].shape[0] // mesh[0]
    for r, res in enumerate(run["ranks"]):
        i = R.coordinates(desc, r)["data"]
        assert torch.equal(res["greedy"], one["greedy"][i * rows:
                                                       (i + 1) * rows]), r
        assert res["greedy"].shape[1] == len(want)


@pytest.mark.parametrize("mesh,layout", REF_STEPS, ids=_ids)
def test_steps_match_the_reference(runs, mesh, layout):
    """The ranks' dense prefill and decode steps, gathered, against the
    reference's GSPMD program compiled under the same rules at the same
    mesh, run on the same parameters and inputs (f32, 1e-5): 4 q over 1
    kv head at 1 x 2 and 1 x 4 (the kv columns gathered, the cache cut
    over its sequence, the decode step combined by log-sum-exp), 4 q over
    2 kv heads at 1 x 2 (a clean cut). Logits, every cache leaf and the
    greedy tokens of each step."""
    run = runs[(mesh, "dense", layout)]
    ref = runs["reference_steps"]
    tag = _ref_tag(mesh, layout)
    plan = run["plan"]
    desc = MeshDesc(mesh, AXES)
    cfg = R.plan_config(plan)
    rules = R.block_rules(plan, desc)
    specs = _out_specs(cfg, rules, False)
    per_rank = [_steps(res) for res in run["ranks"]]
    greedy = []
    for i, (kind, w) in enumerate(_steps(run["one"])):
        name = "prefill" if i == 0 else f"decode{i - 1}"
        whole = R.gather_blocks(cfg, ("batch", "batch"), specs,
                                [steps[i][1]["out"] for steps in per_rank],
                                w["out"], rules, desc)
        want = ref[f"{tag}_{name}_logits"]
        _close(whole[0], want)
        greedy.append(want.argmax(-1))
    # the port writes its caches in place, so every step's record holds
    # the caches as the last step left them: held to the reference's last
    leaves = [t for t in flatten(whole[1]) if t is not None]
    assert f"{tag}_{name}_c{len(leaves)}" not in ref
    for j, a in enumerate(leaves):
        b = ref[f"{tag}_{name}_c{j}"]
        assert tuple(a.shape) == b.shape, j
        _close(a, b)
    for res in run["ranks"]:
        assert np.array_equal(res["greedy"].numpy(),
                              np.stack(greedy, axis=1))


# ---------------------------------------------------------------------------
# the collective counts
# ---------------------------------------------------------------------------

def closed_form(cfg, mesh, rows_b, seq, text, *, combine):
    """Result bytes a rank moves in one step, f32: ``rows_b`` batch rows
    on the rank, ``seq`` tokens a row in the decoder (``text`` of them
    looked up in the embedding); ``combine``: a decode step over a dense
    cache cut over its sequence."""
    m, f = mesh[1], 4
    d, hd, n_layers = cfg.d_model, cfg.head_dim, cfg.n_layers
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    tokens = rows_b * seq
    ar = ag = 0
    if cfg.vocab % m == 0:               # the embedding rows over 'vocab'
        ar += rows_b * text * d * f
    if nq * hd % m == 0:                 # attention wo over its rows
        ar += n_layers * tokens * d * f
    if cfg.d_ff % m == 0:                # MLP wo over its rows
        ar += n_layers * tokens * d * f
    if nq * hd % m == 0 and nq % m:      # q columns cut, heads whole
        ag += n_layers * tokens * nq * hd * f
    if nkv * hd % m == 0 and nkv % m:    # k and v columns cut, heads whole
        ag += 2 * n_layers * tokens * nkv * hd * f
    if combine:
        if nq % m == 0:                  # every q head on every rank
            ag += n_layers * rows_b * nq * hd * f
        # the largest log-sum-exp, then the weighted outputs and weights
        ar += n_layers * (rows_b * nq * f + rows_b * nq * (hd + 1) * f)
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag)) if v}


@pytest.mark.parametrize("mesh,form,layout", CASES, ids=_ids)
def test_collective_bytes_closed_form(runs, mesh, form, layout):
    run = runs[(mesh, form, layout)]
    plan = run["plan"]
    cfg = R.plan_config(plan)
    if form == "paged":
        page, prefix, n = plan.paged
        pos_base = prefix // page * page
        first = -(-prefix // page) * page
        rest = -(-n // page) * page - pos_base
        shapes = [("prefill", 1, first, first), ("suffix", 1, rest, rest)]
        combine = False
    else:
        b, s, _ = plan.prefill
        text = s - (cfg.frontend.tokens_per_item if form == "llava" else 0)
        shapes = [("prefill", b // mesh[0], s, text)]
        combine = cfg.n_kv_heads % mesh[1] != 0
    rows = shapes[0][1] if form == "paged" else plan.prefill[0] // mesh[0]
    for res in run["ranks"]:
        for kind, rows_b, seq, text in shapes:
            assert res[kind]["collectives"] == closed_form(
                cfg, mesh, rows_b, seq, text, combine=False), kind
        for rec in [res["decode"]] + res["more"]:
            assert rec["collectives"] == closed_form(
                cfg, mesh, rows, 1, 1, combine=combine)


def _f32(tree):
    """A meta tree with every floating tensor but fp8 in f32."""
    def conv(t):
        if t.is_floating_point() and t.dtype != torch.float8_e4m3fn:
            return torch.empty(t.shape, dtype=torch.float32, device="meta")
        return t
    return R._walk(lambda s, t: conv(t), None, tree)


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_meta_count_equals_the_gloo_run(runs, mesh):
    """The dry-run's collective term, a rank block's step on ``meta`` under
    a ``CountingMesh``, counts what the gloo ranks moved, rank by rank."""
    desc = MeshDesc(mesh, AXES)
    for form in ("dense", "fp8", "llava"):
        for layout in LAYOUTS:
            key = (mesh, form, layout)
            if key not in runs:
                continue
            plan = runs[key]["plan"]
            cfg = R.plan_config(plan)
            b, s, _ = plan.prefill
            kv = getattr(torch, plan.kv_dtype) if plan.kv_dtype else None
            for r, res in enumerate(runs[key]["ranks"]):
                coords = R.coordinates(desc, r)
                rules = R.plan_rules(plan, desc, CountingMesh(desc, coords))
                for kind in ("prefill", "decode"):
                    case = build_case(cfg, InputShape(kind, s, b, kind),
                                      rules, kv_dtype=kv)
                    case.args = _f32(case.args)
                    got = dryrun.rank_collectives(cfg, case, kind, rules,
                                                  coords)
                    assert got == res[kind]["collectives"], (key, r, kind)


def test_reference_collectives_beside_the_port(runs, capsys):
    """The reference's GSPMD program and the port at (1, 2), reduced
    llama3.2-1b (4 q over 1 kv head), prefill 2 x 64 and a decode step,
    f32: the two counts side by side (both all-gather the k/v columns,
    and in the decode step q; both all-reduce wo, the MLP and the
    embedding, and combine the decode step's partial softmax)."""
    desc = MeshDesc((1, 2), AXES)
    cfg = get_config(ARCH).reduced()
    s, b = REF_SHAPE
    coords = R.coordinates(desc, 0)
    rules = PT.tp_rules(axis_sizes=desc.axis_sizes,
                        mesh=CountingMesh(desc, coords))
    port = {}
    for kind in ("prefill", "decode"):
        case = build_case(cfg, InputShape(kind, s, b, kind), rules)
        case.args = _f32(case.args)
        port[kind] = dryrun.rank_collectives(cfg, case, kind, rules, coords)
    ref = runs["reference"]
    with capsys.disabled():
        print(f"\n[tensor parallel, reduced {ARCH} at 1 x 2, f32] "
              f"reference hlo.collective_bytes {ref}; port {port}")
    assert set(ref) == set(port)
    assert port["prefill"] == closed_form(cfg, (1, 2), b, s, s,
                                          combine=False)
    assert port["decode"] == closed_form(cfg, (1, 2), b, 1, 1, combine=True)


# ---------------------------------------------------------------------------
# the dry-run's term
# ---------------------------------------------------------------------------

def test_dry_run_counts_the_dense_decoders_only():
    """The dry-run writes the collective term of a dense decoder's
    base-rules decode (glm4-9b: 2 kv heads over a 16-way axis, so q, k and
    v gathered and the step combined across ranks) and of a MoE decoder's
    (mixtral-8x7b: MoE-TP's expert buffers all-reduced), and null with
    its reason under the fsdp rules; the train cases of the six dense
    decoders and of the SSM decoders (mamba2, jamba) are counted under the
    baseline rules, single-pod and multi-pod, and every case still null
    has a reason that names what is missing (``collective_reason``:
    whisper, fsdp, the expert-parallel branch on meta,
    ``decode_kv='seq'``)."""
    res = dryrun.run_case("glm4-9b", "decode_32k", save=False)
    assert res["collective_reason"] is None
    coll = res["collective_bytes"]
    assert set(coll) == {"all-reduce", "all-gather"}
    assert res["roofline"]["collective_s"] == \
        sum(coll.values()) / dryrun.NVLINK_BW > 0
    null = dryrun.run_case("glm4-9b", "decode_32k", save=False,
                           rules_kw={"fsdp": True})
    assert null["collective_bytes"] is None
    assert null["roofline"]["collective_s"] is None
    assert "fsdp" in null["collective_reason"]
    moe = dryrun.run_case("mixtral-8x7b", "decode_32k", save=False)
    assert moe["collective_reason"] is None
    assert moe["collective_bytes"]["all-reduce"] > 0
    mesh = make_production_mesh()
    for arch, kind, kw, why in (
            ("whisper-base", "prefill", {}, "encoder-decoder"),
            ("whisper-base", "decode", {}, "encoder-decoder"),
            ("mixtral-8x7b", "prefill", {"expert_parallel": True},
             "expert-parallel"),
            ("glm4-9b", "decode", {"decode_kv": "seq"}, "decode_kv='seq'"),
            ("smollm-135m", "train", {"fsdp": True}, "ZeRO-3 training"),
            ("whisper-base", "train", {}, "encoder-decoder"),
            ("llama4-scout-17b-a16e", "train", {"expert_parallel": True},
             "expert-parallel")):
        rules = PT.tp_rules(axis_sizes=mesh.axis_sizes, **kw)
        reason = dryrun.collective_reason(get_config(arch), kind, rules)
        assert why in reason, reason
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        # the SSM decoders' train cases are counted too (since ssd_scan
        # has its gradient on the card)
        for arch in DENSE + ("mamba2-370m", "jamba-v0.1-52b"):
            rules = PT.tp_rules(multi_pod=multi_pod,
                                axis_sizes=mesh.axis_sizes)
            assert dryrun.collective_reason(get_config(arch), "train",
                                            rules) is None, arch


DENSE = ("smollm-135m", "llama3.2-1b", "deepseek-7b", "glm4-9b",
         "llava-next-mistral-7b", "openpangu-7b-vl")


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", DENSE)
def test_rank_blocks_hold_the_dry_run_bytes(arch, multi_pod):
    """A rank's blocks of the full-size prefill_32k and decode_32k cases
    (rank 0 and the last rank) hold exactly the dry-run's per-device
    argument bytes, argument by argument."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    last = R.coordinates(mesh, mesh.size - 1)
    for shape in ("prefill_32k", "decode_32k"):
        kind = dryrun.SHAPES[shape].kind
        for coords in (R.coordinates(mesh, 0), last):
            rules = PT.tp_rules(multi_pod=multi_pod,
                                axis_sizes=mesh.axis_sizes,
                                mesh=CountingMesh(mesh, coords))
            case = build_case(cfg, dryrun.SHAPES[shape], rules)
            blocks = R.rank_block(cfg, R.ARG_ROLES[kind], case.in_specs,
                                  case.args, rules, coords)
            held = [sum(t.numel() * t.element_size()
                        for t in R._tensors_of(b)) if b is not None else 0
                    for b in blocks]
            assert held == [dryrun.device_bytes(s, a, mesh.axis_sizes)
                            for s, a in zip(case.in_specs, case.args)], (
                arch, shape, coords)


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_param_cut_draws_the_whole_trees_block(mesh):
    """``init_params``' cut under tensor parallelism: each rank draws its
    block of every leaf, equal to the whole tree's; the blocks put back
    together are the whole tree, and the rank's caches
    (``rank_caches``) are its blocks of fresh whole caches."""
    desc = MeshDesc(mesh, AXES)
    plan = R.Plan(ARCH, heads=(4, 1), expert_parallel=False)
    cfg = R.plan_config(plan)
    rules = R.block_rules(plan, desc)
    whole = init_params(cfg, device="cpu")
    caches = T.make_caches(cfg, 4, 16)
    specs = cache_pspecs(cfg, rules)
    blocks = []
    for r in range(desc.size):
        c = R.coordinates(desc, r)
        drawn = init_params(cfg, device="cpu", cut=R.param_cut(rules, c))
        mine = R.rank_block(cfg, ("params", "batch"), (None, specs),
                            (whole, caches), rules, c)
        for a, b in zip(flatten(drawn), flatten(mine[0])):
            assert torch.equal(a, b)
        fresh = R.rank_caches(cfg, 4, 16, rules, c, device="cpu")
        for a, b in zip(R._tensors_of(fresh), R._tensors_of(mine[1])):
            assert torch.equal(a, b)
        blocks.append(mine)
    back = R.gather_blocks(cfg, ("params", "batch"), (None, specs), blocks,
                           (whole, caches), rules, desc)
    for a, b in zip(flatten(back[0]), flatten(whole)):
        assert torch.equal(a, b)
    # the embedding rows and the q columns are cut 'model' ways
    assert blocks[0][0]["embed"].shape[0] == cfg.vocab // mesh[1]
    assert blocks[0][0]["blocks"][0]["attn"]["wq"].shape[2] == \
        cfg.q_dim // mesh[1]


@pytest.mark.parametrize("nq,nkv,ways", [(4, 1, 2), (4, 2, 4), (32, 2, 4),
                                         (32, 8, 16), (12, 3, 2), (9, 3, 1)])
def test_kv_heads_a_ranks_q_heads_read(nq, nkv, ways):
    """``layers._kv_for``: the K/V a rank passes to attention with its q
    heads give each q head h the kv head h // (nq / nkv), whether the
    heads are sliced (a group of their own) or, where a rank's q heads
    straddle kv groups unevenly (12 over 3 at 2 ways), one a q head."""
    group = nq // nkv
    k = torch.arange(nkv, dtype=torch.float32)[None, None, :, None]
    k = k.expand(1, 1, nkv, 4).contiguous()
    for c in range(ways):
        nq_loc = nq // ways
        q = torch.zeros((1, 1, nq_loc, 4))
        got, _ = L._kv_for(q, c * nq_loc, k, k, 0, group)
        g = nq_loc // got.shape[2]
        for i in range(nq_loc):
            assert got[0, 0, i // g, 0] == (c * nq_loc + i) // group


def test_rank_caches_refuse_a_sequence_the_axis_does_not_divide():
    desc = MeshDesc((1, 4), AXES)
    plan = R.Plan(ARCH, expert_parallel=False)
    rules = R.block_rules(plan, desc)
    with pytest.raises(NotImplementedError, match="sequence"):
        R.rank_caches(R.plan_config(plan), 2, 18, rules,
                      R.coordinates(desc, 1), device="cpu")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _tp(mesh=(1, 2)):
    desc = MeshDesc(mesh, AXES)
    return PT.tp_rules(axis_sizes=desc.axis_sizes,
                       mesh=CountingMesh(desc, R.coordinates(desc, 0)))


def _layer(params, part):
    return {k: w[0] for k, w in params["blocks"][0][part].items()}


def test_moe_ssm_and_whisper_refuse_tensor_parallelism():
    """Whisper's encoder and cross-attention still refuse tensor
    parallelism across ranks (ROADMAP Queue 1 item 4.1); ``moe_block``
    (MoE-TP) and ``ssm_block`` (the Mamba2 block on a rank's heads) now
    run under the same rank mesh on a rank's blocks (on ``meta`` here:
    their collectives count and move nothing; against one process:
    ``tests/test_torch_tp_moe_ssm.py``)."""
    x = torch.zeros((1, 4, 256))
    pos = torch.arange(4, dtype=torch.int32)[None]
    w_cfg = get_config("whisper-base").reduced()
    w_params = init_params(w_cfg, device="cpu")
    w_p = _layer(w_params, "attn")
    frames = torch.zeros((1, w_cfg.encoder.n_ctx, w_cfg.frontend.feature_dim))
    enc_kv = L.compute_cross_kv(w_p, torch.zeros((1, 8, w_cfg.d_model)),
                                pos.repeat(1, 2), w_cfg)
    calls = [("run_encoder", lambda: T.run_encoder(w_params, w_cfg, frames)),
             ("cross_attention_block", lambda: L.cross_attention_block(
                 w_p, torch.zeros((1, 4, w_cfg.d_model)), pos, enc_kv,
                 w_cfg))]
    for name, call in calls:
        # in one process, and under the same rules with no rank mesh,
        # each runs
        call()
        with PT.use_rules(PT.tp_rules(axis_sizes={"data": 1, "model": 2})):
            call()
        with PT.use_rules(_tp()), pytest.raises(NotImplementedError,
                                                match=name):
            call()
    rules = _tp()
    coords = R.coordinates(MeshDesc((1, 2), AXES), 0)
    for arch, part, block in (("mixtral-8x7b", "moe", MOE.moe_block),
                              ("mamba2-370m", "ssm", SSM.ssm_block)):
        cfg = get_config(arch).reduced()
        whole = _layer(init_params(cfg, device="cpu"), part)
        block(whole, x, cfg)
        p = _layer(R.rank_block(cfg, ("params",), (None,), (abstract_params(
            cfg, torch.float32),), rules, coords)[0], part)
        assert any(p[k].shape != whole[k].shape for k in p), arch
        xm = torch.empty(x.shape, device="meta")
        collectives.reset()
        with PT.use_rules(rules):
            y = block(p, xm, cfg)[0]
        assert y.shape == x.shape and collectives.collective_bytes(), arch
    collectives.reset()
    # under the expert-parallel rules moe_block takes its own branch
    assert PT.tensor_parallel(PT.tp_rules(
        expert_parallel=True, axis_sizes={"data": 1, "model": 2},
        mesh=_tp().mesh)) is None


def test_train_step_refuses_tensor_parallelism():
    """The train step runs the dense decoders, MoE-TP and the SSM block
    (mamba2, jamba) under tensor parallelism
    (``tests/test_torch_train_parallel.py``,
    ``tests/test_torch_tp_moe_ssm.py``, ``tests/test_torch_ssd_grad.py``);
    the encoder-decoder it refuses before any work, naming what is not
    ported and its ROADMAP item."""
    step = make_train_step(get_config("whisper-base").reduced(), AdamW())
    with PT.use_rules(_tp()), pytest.raises(NotImplementedError,
                                            match="encoder-decoder.*item 4.1"):
        step(None, None, None)
    for arch in (ARCH, "mixtral-8x7b", "mamba2-370m", "jamba-v0.1-52b"):
        step = make_train_step(get_config(arch).reduced(), AdamW())
        with PT.use_rules(_tp()), pytest.raises(AttributeError):
            step(None, None, None)   # past the refusals: no parameters


def test_gradient_through_a_tensor_parallel_collective_raises():
    """The forward across ranks runs under autograd (here on ``meta``, a
    rank's block of attention and MLP under a ``CountingMesh`` at 1 x 4,
    4 q heads over 1 kv head). A gradient through the sequence-cut decode
    combine raises; through the other TP collectives it flows, each
    counting its transpose: the block inputs' all-reduces and the K/V
    gathers' reduce-scatters in the backward, nothing for
    ``tp_all_reduce``'s pass-through."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_heads=4,
                              n_kv_heads=1)
    rules = _tp((1, 4))
    c = R.coordinates(MeshDesc((1, 4), AXES), 0)
    p = R.rank_block(cfg, ("params",), (None,), (abstract_params(
        cfg, torch.float32),), rules, c)[0]
    attn = {k: w[0].requires_grad_(True)
            for k, w in p["blocks"][0]["attn"].items()}
    mlp = {k: w[0].requires_grad_(True)
           for k, w in p["blocks"][0]["mlp"].items()}
    x = torch.empty((2, 8, cfg.d_model), device="meta", requires_grad=True)
    pos = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with PT.use_rules(rules):
        collectives.reset()
        h, _ = L.attention_block(attn, x, pos, cfg)
        y = L.mlp_block(mlp, h, cfg)
        forward = collectives.collective_bytes()
    assert y.shape == x.shape
    tokens, d, kv = 2 * 8, cfg.d_model, cfg.kv_dim
    assert forward == {"all-reduce": 2 * tokens * d * 4,
                       "all-gather": 2 * tokens * kv * 4}
    collectives.reset()
    grads = torch.autograd.grad(y.sum(), [x, attn["wq"], attn["norm"],
                                          mlp["wi"], mlp["norm"]])
    assert [g.shape for g in grads] == [x.shape, attn["wq"].shape,
                                        attn["norm"].shape, mlp["wi"].shape,
                                        mlp["norm"].shape]
    assert collectives.collective_bytes() == {
        "all-reduce": 2 * tokens * d * 4,
        "reduce-scatter": 2 * tokens * kv // 4 * 4}
    z = torch.empty((3,), device="meta", requires_grad=True)
    collectives.reset()
    out = collectives.tp_all_reduce(z, rules.mesh, "model")
    assert collectives.collective_bytes() == {"all-reduce": 12}
    assert torch.autograd.grad(out.sum(), z)[0].shape == z.shape
    assert collectives.collective_bytes() == {"all-reduce": 12}
    for fn, args in ((collectives.all_gather, (rules.mesh, "model", 0)),
                     (collectives.all_reduce, (rules.mesh, "model", "max"))):
        out = collectives.serving_only(fn, z, *args)
        with pytest.raises(NotImplementedError, match="decode combine"):
            out.sum().backward()
