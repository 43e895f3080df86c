"""Tensor parallelism across real ranks for the MoE and SSM blocks, on the
CPU: gloo ranks started by ``launch/ranks.run_ranks`` under the baseline
``tp_rules()`` (fsdp and expert parallelism off, ``decode_kv="heads"``)
with a ``ProcessMesh`` of 1 x 2, 1 x 4 and 2 x 2; f32, reduced configs.

* MoE-TP (``models/moe.py``): each expert's ``ff`` cut over 'model',
  routing and dispatch replicated, the expert buffers' partial products
  summed before the combine. Reduced mixtral-8x7b (sliding window, 4 q
  over 1 kv head) and llama4-scout-17b-a16e (top-1 of 4 experts, image
  features through the projector).
* The Mamba2 block across ranks (``models/ssm.py``): the fused
  activation, the conv's weights and its tail gathered, the scan and the
  decode update on the rank's heads, ``out_norm``'s mean square summed
  over the ranks. Reduced mamba2-370m, and jamba-v0.1-52b's 8-layer
  period (attention, SSM, MLP and MoE in one decoder).
* Steps: the case builders' dense prefill of 64 tokens (two SSD chunks;
  mixtral's 64-slot window wraps in the decode steps) and three decode
  steps, each later one fed the greedy tokens of the one before; on the
  paged pool (data 1) a prefill, a suffix prefill over its cached prefix
  and decode steps; and MoE-TP's train step (mixtral, llama4-scout) with
  padded labels. The experts each token is routed to, the logits, every
  cache block, greedy tokens and, for training, the loss, aux and every
  leaf of the new parameters, mu and nu against one process of the port.
* Counts: each rank's collective bytes against their closed form, and
  the dry-run's count of the same rank block on ``meta`` against the
  gloo run's; a rank's blocks of the full-size cases hold the dry-run's
  per-device bytes.
* The reference's GSPMD program on forced host devices (a subprocess):
  reduced mixtral's and mamba2's prefill and decode steps at (1, 2) and
  mixtral's compiled train step at (2, 2), on the port's parameters and
  inputs, the ranks' results held to its numbers.

Tolerance: 1e-5 relative, and 1e-5 absolute on the scale of each tensor
(its largest magnitude, at least 1). The SSM state of jamba's deeper
layers reaches magnitudes near 20, and the ranks' sums, ordered
otherwise than one process's, differ from it there by a few 1e-5.
"""
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
from repro_torch.launch.specs import build_case, train_plan  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import partitioning as PT  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.params import abstract_params, flatten  # noqa: E402
from repro_torch.models.transformer import cache_pspecs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = [(1, 2), (1, 4), (2, 2)]
ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e", "mamba2-370m",
         "jamba-v0.1-52b")
TRAIN_ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
PREFILL = (4, 64, (64, 40, 64, 33))   # llama4-scout: 16 image tokens each
PAGED = (8, 20, 37)                   # page, prefix, prompt
TRAIN = (4, 16, (16, 9, 16, 12))      # batch, length, valid labels a row
DECODE = 3
TIMEOUT = 300
# the steps held to the reference's GSPMD program: (mesh, arch, form)
REF_STEPS = [((1, 2), "mixtral-8x7b", "dense"),
             ((1, 2), "mamba2-370m", "dense"),
             ((2, 2), "mixtral-8x7b", "train")]
REF_DEVICES = 4


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


def _plans(mesh):
    out = {}
    tp = dict(expert_parallel=False, decode=DECODE, routes=True)
    for arch in ARCHS:
        out[(arch, "dense")] = R.Plan(arch, prefill=PREFILL, **tp)
        if mesh[0] == 1:
            out[(arch, "paged")] = R.Plan(arch, paged=PAGED, **tp)
    for arch in TRAIN_ARCHS:
        out[(arch, "train")] = R.Plan(arch, expert_parallel=False,
                                      train=TRAIN)
    return out


CASES = [(mesh, arch, form) for mesh in MESHES for arch, form in _plans(mesh)]
SERVING = [c for c in CASES if c[2] != "train"]
TRAINING = [c for c in CASES if c[2] == "train"]

# the reference in its own process on forced host devices: at each step
# of STEPS, its case under tp_rules compiled on an Auto mesh of (data,
# model), run on the port's parameters and inputs (FEED); serving: the
# prefill, then the decode steps fed their greedy tokens (logits and
# caches saved), training: one step from a fresh AdamW state (new
# parameters, moments and metrics saved)
REFERENCE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch.specs import build_case
from repro.models.params import abstract_params
from repro.models.partitioning import tp_rules
from repro.models.transformer import make_caches
from repro.training.optimizer import AdamW

feed_file, out_file = sys.argv[1:3]
n_decode = int(sys.argv[3])
steps = json.loads(sys.argv[4])
auto = (jax.sharding.AxisType.Auto,) * 2


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


feed = np.load(feed_file)
out = {}
for data, model, arch, form, tag in steps:
    sizes = dict(zip(("data", "model"), (data, model)))
    mesh = jax.make_mesh((data, model), ("data", "model"), axis_types=auto,
                         devices=jax.devices()[:data * model])
    rules = tp_rules(axis_sizes=sizes)
    cfg = get_config(arch).reduced()
    tree = jax.tree.structure(abstract_params(cfg, jnp.float32))
    leaves = [jnp.asarray(feed[f"{tag}_p{i}"])
              for i in range(tree.num_leaves)]
    params = jax.tree.unflatten(tree, leaves)
    if form == "train":
        batch = {k: jnp.asarray(feed[f"{tag}_{k}"])
                 for k in ("tokens", "labels")}
        b, s = batch["tokens"].shape
        case = build_case(cfg, InputShape("train", s, b, "train"), rules)
        args = (params, AdamW().init(params), batch)
        with jax.set_mesh(mesh):
            new_params, state, metrics = jax.jit(case.fn, in_shardings=(
                shardings(case, args, sizes, mesh)))(*args)
        for name, got in (("p", new_params), ("mu", state.mu),
                          ("nu", state.nu)):
            for i, x in enumerate(jax.tree.leaves(got)):
                out[f"{tag}_{name}{i}"] = np.asarray(x)
        for k in ("loss", "aux"):
            out[f"{tag}_{k}"] = np.asarray(metrics[k])
        continue
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
            toks, caches = jax.device_put((toks, caches), (sh[1], sh[2]))
            logits, caches = step(params, toks, caches)
            recs.append((f"decode{i}", logits, caches))
            toks = jnp.argmax(logits, -1).astype(jnp.int32)
    for name, logits, caches in recs:
        out[f"{tag}_{name}_logits"] = np.asarray(logits)
        for j, c in enumerate(jax.tree.leaves(caches)):
            out[f"{tag}_{name}_c{j}"] = np.asarray(c)
np.savez(out_file, **out)
print("done")
"""


def _ref_tag(mesh, arch, form):
    return f"{_ids(mesh)}_{arch}_{form}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of ranks, started once a mesh with every plan of that
    mesh, and each plan in one process; the reference's subprocess runs
    meanwhile, fed the parameters and inputs of REF_STEPS' plans. One
    process runs a plan once: without a rank mesh the rules' axis sizes
    change only a train step's microbatches (``train_plan``: by the data
    axis)."""
    base = tmp_path_factory.mktemp("tp_moe_ssm")
    ones, feed, steps = {}, {}, []

    def one_of(mesh, plan):
        key = (plan, mesh[0] if plan.train else None)
        if key not in ones:
            ones[key] = R.run_plan(plan, MeshDesc(mesh, AXES), "cpu")
        return ones[key]

    for mesh, arch, form in REF_STEPS:
        plan = _plans(mesh)[(arch, form)]
        one = one_of(mesh, plan)
        tag = _ref_tag(mesh, arch, form)
        for i, t in enumerate(flatten(R.plan_params(plan, "cpu"))):
            feed[f"{tag}_p{i}"] = t.numpy()
        if form == "train":
            for k, t in one["inputs"]["train"][0].items():
                feed[f"{tag}_{k}"] = t.numpy()
        else:
            for k in ("tokens", "lengths", "decode"):
                feed[f"{tag}_{k}"] = one["inputs"][k].numpy()
        steps.append([*mesh, arch, form, tag])
    np.savez(base / "feed.npz", **feed)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{REF_DEVICES}")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(base / "feed.npz"), str(base / "ref.npz"),
                            str(DECODE), json.dumps(steps)], env=env,
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
                out[(mesh,) + key] = dict(plan=plans[key],
                                          ranks=[g[i] for g in got],
                                          one=one_of(mesh, plans[key]))
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err
    out["reference"] = dict(np.load(base / "ref.npz"))
    return out


def _close(a, b, where=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=1e-5,
                               err_msg=where)


def _steps(res):
    """(kind, record) of each step a plan ran, in order."""
    out = [(k, res[k]) for k in ("prefill", "suffix", "decode") if k in res]
    return out + [("decode", rec) for rec in res["more"]]


def _out_specs(cfg, rules, paged):
    return (rules.spec(("batch", "act_vocab")),
            cache_pspecs(cfg, rules, "paged" if paged else "dense"))


def _gathered(run, mesh, kind_index):
    """The ranks' outputs of step ``kind_index`` put back together (the
    blocks that ranks share must be bitwise equal)."""
    plan, one = run["plan"], run["one"]
    desc = MeshDesc(mesh, AXES)
    cfg = R.plan_config(plan)
    rules = R.block_rules(plan, desc)
    specs = _out_specs(cfg, rules, plan.paged is not None)
    blocks = [_steps(res)[kind_index][1]["out"] for res in run["ranks"]]
    return R.gather_blocks(cfg, ("batch", "batch"), specs, blocks,
                           _steps(one)[kind_index][1]["out"], rules, desc)


# ---------------------------------------------------------------------------
# the steps against one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,arch,form", SERVING, ids=_ids)
def test_steps_match_one_process(runs, mesh, arch, form):
    run = runs[(mesh, arch, form)]
    plan, one = run["plan"], run["one"]
    desc = MeshDesc(mesh, AXES)
    cfg = R.plan_config(plan)
    want = _steps(one)
    assert [k for k, _ in want] == [k for k, _ in _steps(run["ranks"][0])]
    for i, (kind, w) in enumerate(want):
        # each rank sends every token of its rows to the experts that one
        # process does (a token routed elsewhere would part the outputs
        # below; this says so apart)
        assert ("routes" in w) == (cfg.moe is not None), kind
        for r, res in enumerate(run["ranks"]):
            if "routes" not in w:
                continue
            got = _steps(res)[i][1]["routes"]
            rows = got.shape[1]
            d = R.coordinates(desc, r)["data"]
            mine = w["routes"][:, d * rows:(d + 1) * rows]
            assert got.shape == mine.shape, (kind, r)
            parted = int((got != mine).any(-1).sum())
            assert parted == 0, (f"step {i} ({kind}), rank {r}: {parted} "
                                 f"tokens routed to other experts")
        # a rank's logits hold its block of the vocabulary
        assert _steps(run["ranks"][0])[i][1]["out"][0].shape[-1] == \
            cfg.vocab // mesh[1]
        whole = _gathered(run, mesh, i)
        for j, (a, b) in enumerate(zip(flatten(whole), flatten(w["out"]))):
            if b is None:
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, kind
            _close(a, b, f"step {i} ({kind}), leaf {j} (0: the logits)")
    rows = one["greedy"].shape[0] // mesh[0]
    for r, res in enumerate(run["ranks"]):
        i = R.coordinates(desc, r)["data"]
        assert torch.equal(res["greedy"], one["greedy"][i * rows:
                                                       (i + 1) * rows]), r
        assert res["greedy"].shape[1] == len(want)
    # a rank holds its heads of every SSM state, its block of each
    # expert's 'ff'
    held = run["ranks"][0]
    if cfg.ssm is not None:
        nh = cfg.ssm.n_heads(cfg.d_model)
        state = [c for c in held["prefill"]["out"][1]["ssm"]
                 if c is not None][0].state
        assert state.shape[2] == nh // mesh[1]


@pytest.mark.parametrize("mesh,arch,form", TRAINING, ids=_ids)
def test_train_step_matches_one_process(runs, mesh, arch, form):
    run = runs[(mesh, arch, form)]
    plan = run["plan"]
    desc = MeshDesc(mesh, AXES)
    cfg = R.plan_config(plan)
    one = run["one"]["train"]
    p, s, _ = R.gather_blocks(cfg, R.OUT_ROLES["train"], (None,) * 3,
                              [res["train"]["out"] for res in run["ranks"]],
                              one["out"], R.block_rules(plan, desc), desc)
    want_p, want_s, want_m = one["out"]
    for a, b in zip(flatten((p, s.mu, s.nu)),
                    flatten((want_p, want_s.mu, want_s.nu))):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b)
    assert int(s.step) == int(want_s.step) == 1
    first = run["ranks"][0]["train"]["out"][2]
    assert set(first) == {"loss", "aux"}
    for res in run["ranks"]:
        for k, v in res["train"]["out"][2].items():
            assert torch.equal(v, first[k]), k
            _close(v, want_m[k])
    # each expert's 'ff' is cut over 'model'
    wi = run["ranks"][0]["train"]["out"][0]["blocks"][0]["moe"]["wi"]
    assert wi.shape[-1] == cfg.d_ff // mesh[1]


def test_steps_match_the_reference(runs):
    """The ranks' steps, gathered, against the reference's GSPMD program
    compiled under the same rules at the same mesh, run on the same
    parameters and inputs (f32): reduced mixtral (MoE-TP, the kv columns
    gathered, the window's cache cut over its sequence) and mamba2 (the
    SSM block on each rank's heads) at 1 x 2, the prefill and three
    decode steps' logits and greedy tokens and the last caches (the port
    writes caches in place); mixtral's train step at 2 x 2, every leaf
    of the new parameters, mu and nu, and the loss and aux."""
    ref = runs["reference"]
    for mesh, arch, form in REF_STEPS:
        run = runs[(mesh, arch, form)]
        tag = _ref_tag(mesh, arch, form)
        if form == "train":
            plan = run["plan"]
            desc = MeshDesc(mesh, AXES)
            cfg = R.plan_config(plan)
            p, s, _ = R.gather_blocks(
                cfg, R.OUT_ROLES["train"], (None,) * 3,
                [res["train"]["out"] for res in run["ranks"]],
                run["one"]["train"]["out"], R.block_rules(plan, desc), desc)
            for prefix, tree in (("p", p), ("mu", s.mu), ("nu", s.nu)):
                got = flatten(tree)
                assert f"{tag}_{prefix}{len(got)}" not in ref
                for i, a in enumerate(got):
                    want = ref[f"{tag}_{prefix}{i}"]
                    assert tuple(a.shape) == want.shape, (prefix, i)
                    _close(a, want)
            for res in run["ranks"]:
                for k in ("loss", "aux"):
                    _close(res["train"]["out"][2][k], ref[f"{tag}_{k}"])
            continue
        greedy = []
        for i, _ in enumerate(_steps(run["one"])):
            name = "prefill" if i == 0 else f"decode{i - 1}"
            whole = _gathered(run, mesh, i)
            want = ref[f"{tag}_{name}_logits"]
            _close(whole[0], want)
            greedy.append(want.argmax(-1))
        leaves = [t for t in flatten(whole[1]) if t is not None]
        assert f"{tag}_{name}_c{len(leaves)}" not in ref
        for j, a in enumerate(leaves):
            b = ref[f"{tag}_{name}_c{j}"]
            assert tuple(a.shape) == b.shape, (tag, j)
            _close(a, b)
        for res in run["ranks"]:
            assert np.array_equal(res["greedy"].numpy(),
                                  np.stack(greedy, axis=1)), tag


# ---------------------------------------------------------------------------
# the collective counts
# ---------------------------------------------------------------------------

def _layers(cfg, mixer=None, ffn=None):
    """Layers of the decoder with this mixer (or ffn)."""
    return cfg.n_repeats * sum(
        (mixer is None or sp.mixer in mixer) and (ffn is None or sp.ffn == ffn)
        for sp in cfg.pattern)


def serving_form(cfg, mesh, rows, seq, text, *, combine):
    """Result bytes a rank moves in one serving step, f32: ``rows`` batch
    rows on the rank, ``seq`` tokens a row in the decoder (``text`` of
    them looked up in the embedding); ``combine``: a decode step over a
    dense cache cut over its sequence. Attention as in
    ``tests/test_torch_tensor_parallel.py``; a MoE layer all-reduces its
    expert buffers (rows, E, C, d) where 'model' divides 'ff'; an SSM
    layer gathers its fused activation (rows, seq, 2 inner + 2 N + nh),
    its conv weights and bias and the conv tail (rows, W - 1, inner +
    2 N), and all-reduces out_norm's sums of squares (rows, seq) and
    w_out's partial products (rows, seq, d)."""
    m, f = mesh[1], 4
    d = cfg.d_model
    tokens = rows * seq
    n_attn = _layers(cfg, mixer=("attn", "swa"))
    ar = ag = 0
    if cfg.vocab % m == 0:
        ar += rows * text * d * f
    if n_attn:
        hd, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        if nq * hd % m == 0:
            ar += n_attn * tokens * d * f
        if nq * hd % m == 0 and nq % m:
            ag += n_attn * tokens * nq * hd * f
        if nkv * hd % m == 0 and nkv % m:
            ag += 2 * n_attn * tokens * nkv * hd * f
        if combine:
            if nq % m == 0:
                ag += n_attn * rows * nq * hd * f
            ar += n_attn * (rows * nq * f + rows * nq * (hd + 1) * f)
    if cfg.d_ff and cfg.d_ff % m == 0:
        ar += _layers(cfg, ffn="mlp") * tokens * d * f
        ar += _layers(cfg, ffn="moe") * rows * cfg.moe.n_experts * \
            MOE.capacity(cfg, seq) * d * f
    n_ssm = _layers(cfg, mixer=("ssm",))
    if n_ssm:
        ssm = cfg.ssm
        inner, N = ssm.inner_dim(d), ssm.state_dim
        fused, conv = 2 * inner + 2 * N + ssm.n_heads(d), inner + 2 * N
        ag += n_ssm * (tokens * fused + ssm.conv_width * conv + conv
                       + rows * (ssm.conv_width - 1) * conv) * f
        ar += n_ssm * (tokens + tokens * d) * f
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag)) if v}


def train_form(plan, mesh):
    """Result bytes a rank moves in one MoE-TP train step, f32, remat on:
    attention's TP collectives and the vocab-parallel head as in
    ``tests/test_torch_train_parallel.py``; a MoE layer's expert buffers
    all-reduced in the forward and again in remat's recompute, and their
    gradient all-reduced in the backward (the "f" of ``tp_enter``), and
    its aux sums (2 E, f32) over the data ranks, forward and recompute.
    Per step: the data-parallel reduction of every gradient the rank
    holds, the clip's norm over the cut leaves."""
    cfg = R.plan_config(plan)
    desc = MeshDesc(mesh, AXES)
    rules = R.plan_rules(plan, desc)
    d_ranks, m = mesh
    b, s = plan.train[:2]
    n, chunk = train_plan(rules, InputShape("train", s, b, "train"))
    rows = b // (d_ranks * n)
    text = s - (min(cfg.frontend.tokens_per_item, s // 2)
                if cfg.frontend is not None else 0)
    tokens, f = rows * s, 4
    d, hd, layers = cfg.d_model, cfg.head_dim, cfg.n_layers
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    ar = ag = rs = 0
    if q % m == 0:
        ar += layers * 3 * tokens * d * f
        if cfg.n_heads % m:
            ag += layers * 2 * tokens * q * f
    if kv % m == 0 and cfg.n_kv_heads % m:
        ag += layers * 2 * 2 * tokens * kv * f
        if cfg.n_heads % m == 0:
            rs += layers * 2 * tokens * kv // m * f
    E = cfg.moe.n_experts
    if cfg.d_ff % m == 0:
        ar += layers * 3 * rows * E * MOE.capacity(cfg, s) * d * f
    if d_ranks > 1:
        ar += layers * 2 * 2 * E * 4
    pred = text - 1
    if chunk and pred > chunk:
        pred = -(-pred // chunk) * chunk
    if cfg.vocab % m == 0:
        ar += rows * text * d * f                   # the embedding
        ar += rows * pred * 3 * 4                   # max; exp sums, target
        ar += rows * pred * d * f                   # the head's input
    if d_ranks > 1:
        ar += 2 * 4                                 # the global count
    ar, ag, rs = n * ar, n * ag, n * rs
    if d_ranks > 1:
        held = R.rank_block(cfg, ("params",), (None,), (abstract_params(
            cfg, torch.float32),), R.block_rules(plan, desc),
            R.coordinates(desc, 0))[0]
        ar += sum(t.numel() for t in flatten(held)) * 4
    ar += 4                                         # the clip's norm
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag),
                              ("reduce-scatter", rs)) if v}


@pytest.mark.parametrize("mesh,arch,form", CASES, ids=_ids)
def test_collective_bytes_closed_form(runs, mesh, arch, form):
    run = runs[(mesh, arch, form)]
    plan = run["plan"]
    cfg = R.plan_config(plan)
    if form == "train":
        want = train_form(plan, mesh)
        for r, res in enumerate(run["ranks"]):
            assert res["train"]["collectives"] == want, r
        return
    n_mm = cfg.frontend.tokens_per_item if cfg.frontend is not None else 0
    if form == "paged":
        page, prefix, n = plan.paged
        pos_base = prefix // page * page
        first = -(-prefix // page) * page
        rest = -(-n // page) * page - pos_base
        shapes = [("prefill", 1, first, first), ("suffix", 1, rest, rest)]
        rows, combine = 1, False
    else:
        b, s, _ = plan.prefill
        rows = b // mesh[0]
        shapes = [("prefill", rows, s, s - n_mm)]
        combine = bool(cfg.n_kv_heads) and cfg.n_kv_heads % mesh[1] != 0
    for res in run["ranks"]:
        for kind, rows_b, seq, text in shapes:
            assert res[kind]["collectives"] == serving_form(
                cfg, mesh, rows_b, seq, text, combine=False), kind
        for rec in [res["decode"]] + res["more"]:
            assert rec["collectives"] == serving_form(
                cfg, mesh, rows, 1, 1, combine=combine)


def _f32(tree):
    """A meta tree with every floating tensor in f32."""
    return R._walk(lambda _, t: torch.empty(
        t.shape, dtype=torch.float32 if t.is_floating_point() else t.dtype,
        device="meta"), None, tree)


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_meta_count_equals_the_gloo_run(runs, mesh):
    """The dry-run's collective term, a rank block's step on ``meta``
    under a ``CountingMesh``, counts what the gloo ranks moved, rank by
    rank: the dense prefill and first decode step of each arch, and the
    MoE-TP train steps."""
    desc = MeshDesc(mesh, AXES)
    for arch, form in _plans(mesh):
        if form == "paged":
            continue
        run = runs[(mesh, arch, form)]
        plan = run["plan"]
        cfg = R.plan_config(plan)
        b, s = (plan.prefill or plan.train)[:2]
        kinds = ("train",) if form == "train" else ("prefill", "decode")
        for r, res in enumerate(run["ranks"]):
            coords = R.coordinates(desc, r)
            rules = R.plan_rules(plan, desc, CountingMesh(desc, coords))
            for kind in kinds:
                case = build_case(cfg, InputShape(kind, s, b, kind), rules)
                case.args = _f32(case.args)
                got = dryrun.rank_collectives(cfg, case, kind, rules, coords)
                assert got == res[kind]["collectives"], (arch, r, kind)


# ---------------------------------------------------------------------------
# the dry-run's term and a rank's bytes at full size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_blocks_hold_the_dry_run_bytes(arch, multi_pod):
    """A rank's blocks of the full-size prefill_32k and decode_32k cases
    (rank 0 and the last rank) hold exactly the dry-run's per-device
    argument bytes, argument by argument: each expert's 'ff', the SSM's
    fused projection, conv channels and heads, and its caches, cut as
    their specs say."""
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


def test_collective_reason_counts_moe_and_ssm_serving():
    """Under the baseline rules the dry-run counts the prefill, decode and
    train cases of every MoE and SSM decoder (the SSM block's train step
    across ranks, with ssd_scan's gradient on the card); every other case
    is null with a reason that names what is missing and its ROADMAP
    item."""
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = PT.tp_rules(multi_pod=multi_pod, axis_sizes=mesh.axis_sizes)
        for arch in ARCHS:
            cfg = get_config(arch)
            for kind in ("prefill", "decode", "train"):
                assert dryrun.collective_reason(cfg, kind, rules) is None, (
                    arch, kind)
    mesh = make_production_mesh()
    for arch, kind, kw, why in (
            ("whisper-base", "prefill", {}, "item 4.1"),
            ("whisper-base", "train", {}, "item 4.1"),
            ("glm4-9b", "decode", {"decode_kv": "seq"}, "item 4.2"),
            ("mixtral-8x7b", "train", {"fsdp": True}, "item 4.3"),
            ("jamba-v0.1-52b", "train", {"fsdp": True}, "item 4.3"),
            ("glm4-9b", "prefill", {"fsdp": True}, "item 4.3"),
            ("mixtral-8x7b", "prefill", {"expert_parallel": True},
             "expert-parallel")):
        rules = PT.tp_rules(axis_sizes=mesh.axis_sizes, **kw)
        reason = dryrun.collective_reason(get_config(arch), kind, rules)
        assert reason is not None and why in reason, (arch, kind, reason)


def test_ssm_block_refuses_a_gradient_under_tensor_parallelism(tmp_path):
    """The SSM block's gradient under tensor parallelism equals one
    process's: reduced mamba2-370m cut to one layer, its train step at
    1 x 2 over gloo (mu after one step is 0.1 times the clipped gradient,
    so every leaf's gradient is held, the block's own among them) against
    one process. Heads that the axis does not divide (16 over 3) still
    raise before any collective, naming their ROADMAP item (4.1)."""
    plan = R.Plan("mamba2-370m", layers=1, expert_parallel=False,
                  train=TRAIN)
    desc = MeshDesc((1, 2), AXES)
    one = R.run_plan(plan, desc, "cpu")["train"]
    got = [g[0]["train"] for g in R.run_ranks(
        desc, [("plan", dict(plan=plan))], backend="gloo", device="cpu",
        run_dir=tmp_path, timeout=TIMEOUT)]
    cfg = R.plan_config(plan)
    p, s, _ = R.gather_blocks(cfg, R.OUT_ROLES["train"], (None,) * 3,
                              [rec["out"] for rec in got], one["out"],
                              R.block_rules(plan, desc), desc)
    want_p, want_s, want_m = one["out"]
    block = flatten(s.mu["blocks"][0]["ssm"])
    assert block and all(bool(g.abs().max() > 0) for g in block)
    for a, b in zip(flatten((p, s.mu, s.nu)),
                    flatten((want_p, want_s.mu, want_s.nu))):
        assert a.shape == b.shape
        _close(a, b)
    for rec in got:
        _close(rec["out"][2]["loss"], want_m["loss"])
    whole = get_config("mamba2-370m").reduced()
    desc = MeshDesc((1, 3), AXES)
    rules = PT.tp_rules(axis_sizes=desc.axis_sizes,
                        mesh=CountingMesh(desc, R.coordinates(desc, 0)))
    layer = {k: w[0] for k, w in abstract_params(
        whole, torch.float32)["blocks"][0]["ssm"].items()}
    x = torch.empty((1, 8, whole.d_model), device="meta", requires_grad=True)
    collectives.reset()
    with PT.use_rules(rules), pytest.raises(NotImplementedError,
                                            match="item 4.1"):
        SSM.ssm_block(layer, x, whole)
    assert collectives.collective_bytes() == {}


def test_a_plans_depth_is_a_whole_number_of_periods():
    """``Plan.layers`` cuts a hybrid's depth in whole periods: jamba's one
    8-layer period at full width holds one attention, seven SSM and four
    MoE layers; 12 layers are refused."""
    cfg = R.plan_config(R.Plan("jamba-v0.1-52b", reduced=False, layers=8))
    assert cfg.n_repeats == 1 and cfg.d_model == 4096
    assert _layers(cfg, mixer=("attn",)) == 1
    assert _layers(cfg, mixer=("ssm",)) == 7
    assert _layers(cfg, ffn="moe") == 4
    with pytest.raises(ValueError, match="period"):
        R.plan_config(R.Plan("jamba-v0.1-52b", reduced=False, layers=12))


def test_all_reduce_hands_the_backend_a_contiguous_tensor():
    """MoE-TP's expert buffers leave their einsum as a permuted view;
    NCCL refuses a tensor that is not contiguous (gloo takes it), so
    ``collectives.all_reduce`` sums a contiguous copy, counted as the
    result's bytes."""
    desc = MeshDesc((1, 2), AXES)
    mesh = CountingMesh(desc, R.coordinates(desc, 0))
    x = torch.empty((2, 4, 3, 5), device="meta").permute(0, 2, 1, 3)
    assert not x.is_contiguous()
    collectives.reset()
    out = collectives.all_reduce(x, mesh, "model")
    assert out.is_contiguous() and out.shape == x.shape
    assert collectives.collective_bytes() == {"all-reduce": x.numel() * 4}
    collectives.reset()
