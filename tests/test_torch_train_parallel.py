"""The train step across real ranks, on the CPU: gloo ranks started by
``launch/ranks.run_ranks``, reduced configs, f32.

* Reduced llama3.2-1b under the baseline ``tp_rules()`` in the head
  layouts of ``tests/test_torch_tensor_parallel.py`` (4 q over 2 kv heads,
  4 over 1, 6 over 2) at meshes 2 x 1 (pure data parallel), 1 x 2, 1 x 4
  and 2 x 2, and reduced mixtral-8x7b under the expert-parallel rules at
  2 x 1 and 2 x 2. Every plan trains one step of batch 4 x 16 with
  padded labels (rows of 16, 9, 16 and 12 valid targets), so that the
  rows of each microbatch matter: ``train_plan`` gives two microbatches
  over two data ranks and four over one.
* Each rank's new parameters and AdamW moments, gathered
  (``ranks.gather_blocks``, which holds the blocks that ranks share
  bitwise equal), against one process of the same plan at 1e-5, leaf by
  leaf: ``mu`` after one step is 0.1 times the clipped gradient, so the
  gradient of every leaf is held, the norms and the embedding among
  them (where a missing transpose of the block input shows); the loss
  and aux, bitwise equal on every rank.
* The same ranks against the reference's compiled train step on 4 forced
  host devices (a subprocess; the port's parameters and batch):
  (2, 2) 4q1kv (the K/V gather's reduce-scatter and the microbatches'
  rows), (1, 4) 6q2kv (q gathered, attention on every head), (1, 2)
  4q2kv (a clean cut), and mixtral at (2, 1) on an ``Auto`` mesh.
* Each rank's collective bytes against their closed form, and the
  dry-run's count of the same rank block on ``meta``
  (``dryrun.rank_collectives``) against the gloo run's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import ranks as R  # noqa: E402
from repro_torch.launch.mesh import CountingMesh, MeshDesc  # noqa: E402
from repro_torch.launch.specs import build_case, train_plan  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.params import abstract_params, flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = [(2, 1), (1, 2), (1, 4), (2, 2)]
ARCH = "llama3.2-1b"
MOE_ARCH = "mixtral-8x7b"
LAYOUTS = {"4q2kv": (4, 2), "4q1kv": (4, 1), "6q2kv": (6, 2)}
MOE_MESHES = [(2, 1), (2, 2)]
TRAIN = (4, 16, (16, 9, 16, 12))     # batch, length, valid labels a row
TIMEOUT = 300
TOL = dict(atol=1e-5, rtol=1e-5)
# the plans held to the reference's compiled train step: (mesh, layout)
REF_STEPS = [((2, 2), "4q1kv"), ((1, 4), "6q2kv"), ((1, 2), "4q2kv"),
             ((2, 1), "moe")]
REF_DEVICES = 4


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


def _plans(mesh):
    out = {name: R.Plan(ARCH, heads=heads, expert_parallel=False,
                        train=TRAIN)
           for name, heads in LAYOUTS.items()}
    if mesh in MOE_MESHES:
        out["moe"] = R.Plan(MOE_ARCH, train=TRAIN)
    return out


CASES = [(mesh, name) for mesh in MESHES for name in _plans(mesh)]

# the reference in its own process on forced host devices: at each step of
# STEPS, its train case under the same rules compiled on an Auto mesh of
# (data, model), run on the port's parameters and batch (FEED) from a
# fresh AdamW state; the new parameters, moments and metrics saved, and
# hlo.collective_bytes of each compiled step printed
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
from repro.training.optimizer import AdamW

feed_file, out_file = sys.argv[1:3]
steps = json.loads(sys.argv[3])
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
out, counts = {}, {}
for data, model, arch, heads, ep, tag in steps:
    sizes = dict(zip(("data", "model"), (data, model)))
    mesh = jax.make_mesh((data, model), ("data", "model"), axis_types=auto,
                         devices=jax.devices()[:data * model])
    rules = tp_rules(expert_parallel=ep, axis_sizes=sizes,
                     mesh=mesh if ep else None)
    cfg = get_config(arch).reduced()
    if heads:
        cfg = dataclasses.replace(cfg, n_heads=heads[0], n_kv_heads=heads[1])
    tree = jax.tree.structure(abstract_params(cfg, jnp.float32))
    shapes = [x.shape for x in jax.tree.leaves(abstract_params(cfg))]
    leaves = [jnp.asarray(feed[f"{tag}_p{i}"])
              for i in range(tree.num_leaves)]
    assert [x.shape for x in leaves] == shapes, tag
    params = jax.tree.unflatten(tree, leaves)
    batch = {k: jnp.asarray(feed[f"{tag}_{k}"]) for k in ("tokens", "labels")}
    b, s = batch["tokens"].shape
    case = build_case(cfg, InputShape("train", s, b, "train"), rules)
    args = (params, AdamW().init(params), batch)
    with jax.set_mesh(mesh):
        compiled = jax.jit(case.fn, in_shardings=shardings(
            case, args, sizes, mesh)).lower(*args).compile()
        new_params, state, metrics = compiled(*args)
    counts[tag] = collective_bytes(compiled.as_text())
    for name, tree_out in (("p", new_params), ("mu", state.mu),
                           ("nu", state.nu)):
        for i, x in enumerate(jax.tree.leaves(tree_out)):
            out[f"{tag}_{name}{i}"] = np.asarray(x)
    for k in ("loss", "aux"):
        out[f"{tag}_{k}"] = np.asarray(metrics[k])
np.savez(out_file, **out)
print(json.dumps(counts))
"""


def _ref_tag(mesh, name):
    return f"{_ids(mesh)}_{name}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of ranks, started once a mesh with every plan of that
    mesh, and each plan in one process; the reference's subprocess runs
    meanwhile, fed the parameters and batch of REF_STEPS' plans."""
    base = tmp_path_factory.mktemp("train_ranks")
    ones, feed, steps = {}, {}, []
    for mesh, name in REF_STEPS:
        plan = _plans(mesh)[name]
        one = R.run_plan(plan, MeshDesc(mesh, AXES), "cpu")
        ones[(mesh, name)] = one
        tag = _ref_tag(mesh, name)
        for i, t in enumerate(flatten(R.plan_params(plan, "cpu"))):
            feed[f"{tag}_p{i}"] = t.numpy()
        for k, t in one["inputs"]["train"][0].items():
            feed[f"{tag}_{k}"] = t.numpy()
        steps.append([*mesh, plan.arch, plan.heads,
                      plan.expert_parallel, tag])
    np.savez(base / "feed.npz", **feed)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{REF_DEVICES}")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(base / "feed.npz"), str(base / "ref.npz"),
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
            for i, name in enumerate(plans):
                one = ones.get((mesh, name))
                out[(mesh, name)] = dict(
                    plan=plans[name], ranks=[g[i]["train"] for g in got],
                    one=(one or R.run_plan(plans[name], desc, "cpu")
                         )["train"])
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


def _gathered(run, mesh):
    """The ranks' new parameters and AdamW state put back together (the
    blocks that ranks share must be bitwise equal)."""
    plan = run["plan"]
    desc = MeshDesc(mesh, AXES)
    cfg = R.plan_config(plan)
    p, s, _ = R.gather_blocks(cfg, R.OUT_ROLES["train"], (None,) * 3,
                              [rec["out"] for rec in run["ranks"]],
                              run["one"]["out"], R.block_rules(plan, desc),
                              desc)
    return p, s


# ---------------------------------------------------------------------------
# the step against one process and against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,name", CASES, ids=_ids)
def test_train_step_matches_one_process(runs, mesh, name):
    run = runs[(mesh, name)]
    p, s = _gathered(run, mesh)
    want_p, want_s, want_m = run["one"]["out"]
    for a, b in zip(flatten((p, s.mu, s.nu)),
                    flatten((want_p, want_s.mu, want_s.nu))):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b)
    assert int(s.step) == int(want_s.step) == 1
    first = run["ranks"][0]["out"][2]
    assert set(first) == {"loss", "aux"}
    for rec in run["ranks"]:
        for k, v in rec["out"][2].items():
            assert torch.equal(v, first[k]), k
            _close(v, want_m[k])
    # a rank holds a block of each cut leaf: the embedding rows over
    # 'model', the experts over the expert axis
    block = run["ranks"][0]["out"][0]["embed"]
    cut = mesh[1] if name != "moe" else 1
    assert block.shape[0] == want_p["embed"].shape[0] // cut


@pytest.mark.parametrize("mesh,name", REF_STEPS, ids=_ids)
def test_train_step_matches_the_reference(runs, mesh, name):
    """The ranks' train step, gathered, against the reference's train case
    compiled under the same rules on an ``Auto`` mesh of the same shape,
    run on the same parameters and batch (f32, 1e-5): every leaf of the
    new parameters and of ``mu`` and ``nu``, and the loss and aux. At
    (2, 1) mixtral's expert axis has one rank, so both sides run its
    experts whole on each data rank (the reference's ``shard_map`` branch
    needs the expert axis split)."""
    run = runs[(mesh, name)]
    ref = runs["reference_steps"]
    tag = _ref_tag(mesh, name)
    p, s = _gathered(run, mesh)
    for prefix, tree in (("p", p), ("mu", s.mu), ("nu", s.nu)):
        got = flatten(tree)
        assert f"{tag}_{prefix}{len(got)}" not in ref
        for i, a in enumerate(got):
            want = ref[f"{tag}_{prefix}{i}"]
            assert tuple(a.shape) == want.shape, (prefix, i)
            _close(a, want)
    for rec in run["ranks"]:
        for k in ("loss", "aux"):
            _close(rec["out"][2][k], ref[f"{tag}_{k}"])


# ---------------------------------------------------------------------------
# the collective counts
# ---------------------------------------------------------------------------

def closed_form(plan, mesh):
    """Result bytes a rank moves in one train step, f32, remat on (each
    layer's forward collectives issued twice, the forward and its
    recompute, but for the MLP's sum, past the last tensor the backward
    saves: torch's checkpoint stops its recompute there). Per
    microbatch: the embedding's all-reduce; a layer's
    q / k / v gathers and the two row-cut all-reduces, and in the
    backward the block inputs' all-reduces ("f"), the sliced attention
    output's all-gather and the K/V gathers' reduce-scatters; the
    vocab-parallel cross entropy's two all-reduces and the LM head
    input's; the global count of valid targets over the data ranks. Under
    the expert-parallel rules: each MoE layer's output gather, its
    input slice's gathered gradient, and its aux statistics over the data
    ranks. Per step: the data-parallel reduction of every gradient this
    rank holds, and the clip's norm over the cut leaves."""
    cfg = R.plan_config(plan)
    desc = MeshDesc(mesh, AXES)
    rules = R.plan_rules(plan, desc)
    d_ranks, m = mesh
    b, s = plan.train[:2]
    n, chunk = train_plan(rules, InputShape("train", s, b, "train"))
    rows = b // (d_ranks * n)
    tokens, f = rows * s, 4
    d, hd, layers = cfg.d_model, cfg.head_dim, cfg.n_layers
    ar = ag = rs = 0
    text = s - 1
    if chunk and text > chunk:
        text = -(-text // chunk) * chunk
    if plan.expert_parallel:
        cut = MOE.expert_parallel(R.block_rules(plan, desc),
                                  cfg.moe.n_experts)
        E = cfg.moe.n_experts
        buf = rows * E * MOE.capacity(cfg, s) * d * f
        if cut:
            ag += layers * (2 * buf + buf)
        if d_ranks > 1:
            ar += layers * 2 * (2 * E * 4)
    elif m > 1:
        q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        q_heads = cfg.n_heads % m == 0
        fwd_ar = fwd_ag = bwd_ar = bwd_ag = bwd_rs = 0
        if q % m == 0:
            fwd_ar += tokens * d * f
            bwd_ar += tokens * d * f
            if not q_heads:
                fwd_ag += tokens * q * f
                bwd_ag += tokens * q * f
        if kv % m == 0 and cfg.n_kv_heads % m:
            fwd_ag += 2 * tokens * kv * f
            if q_heads:
                bwd_rs += 2 * tokens * kv // m * f
        last = 0
        if cfg.d_ff % m == 0:
            # the MLP's sum ends the layer: remat's recompute stops before
            # it (no saved tensor of the backward lies past it)
            last = tokens * d * f
            bwd_ar += tokens * d * f
        ar += layers * (2 * fwd_ar + last + bwd_ar)
        ag += layers * (2 * fwd_ag + bwd_ag)
        rs += layers * bwd_rs
        if cfg.vocab % m == 0:
            ar += tokens * d * f                     # the embedding
            ar += rows * text * (1 + 2) * 4          # max; exp sums, target
            ar += rows * text * d * f                # the head's input
    if d_ranks > 1:
        ar += 2 * 4                                  # the global count
    ar, ag, rs = n * ar, n * ag, n * rs
    if d_ranks > 1:
        held = R.rank_block(cfg, ("params",), (None,), (abstract_params(
            cfg, torch.float32),), R.block_rules(plan, desc),
            R.coordinates(desc, 0))[0]
        ar += sum(t.numel() for t in flatten(held)) * 4   # f32 either way
    if m > 1:
        ar += 4                                      # the clip's norm
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag),
                              ("reduce-scatter", rs)) if v}


@pytest.mark.parametrize("mesh,name", CASES, ids=_ids)
def test_collective_bytes_closed_form(runs, mesh, name):
    run = runs[(mesh, name)]
    want = closed_form(run["plan"], mesh)
    for r, rec in enumerate(run["ranks"]):
        assert rec["collectives"] == want, r


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_meta_count_equals_the_gloo_run(runs, mesh):
    """The dry-run's collective term of a train case, a rank block's step
    on ``meta`` under a ``CountingMesh``, counts what the gloo ranks
    moved, rank by rank."""
    desc = MeshDesc(mesh, AXES)
    for name in LAYOUTS:
        plan = runs[(mesh, name)]["plan"]
        cfg = R.plan_config(plan)
        b, s = plan.train[:2]
        for r, rec in enumerate(runs[(mesh, name)]["ranks"]):
            coords = R.coordinates(desc, r)
            rules = R.plan_rules(plan, desc, CountingMesh(desc, coords))
            case = build_case(cfg, InputShape("train", s, b, "train"), rules)
            case.args = R._walk(lambda _, t: torch.empty(
                t.shape, dtype=torch.float32 if t.is_floating_point()
                else t.dtype, device="meta"), None, case.args)
            got = dryrun.rank_collectives(cfg, case, "train", rules, coords)
            assert got == rec["collectives"], (name, r)


def test_reference_collectives_beside_the_port(runs, capsys):
    """The reference's compiled train steps (``hlo.collective_bytes``) and
    the port's counts of the same steps, side by side. Equal counts are
    not required: GSPMD places the data-parallel reduction per
    microbatch and picks its own cross entropy; the port reduces once a
    step, in one flat buffer a dtype."""
    ref = runs["reference"]
    port = {}
    for mesh, name in REF_STEPS:
        port[_ref_tag(mesh, name)] = runs[(mesh, name)]["ranks"][0][
            "collectives"]
    with capsys.disabled():
        for tag in port:
            print(f"\n[train across ranks, f32, {tag}] reference "
                  f"hlo.collective_bytes {ref[tag]}; port rank 0 {port[tag]}")
    assert set(ref) == set(port)
    for tag in port:
        assert "all-reduce" in ref[tag] and "all-reduce" in port[tag], tag


# ---------------------------------------------------------------------------
# the batch's row order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
def test_a_ranks_rows_are_its_share_of_each_microbatch(mesh):
    """``micro_order``: a rank's block of a train batch, reshaped into the
    step's microbatches, holds its share of the reference's microbatch i
    (rows [i B / n, (i + 1) B / n) of the whole batch, split over the
    data ranks); the blocks put back together are the whole batch."""
    desc = MeshDesc(mesh, AXES)
    plan = _plans(mesh)["4q1kv"]
    cfg = R.plan_config(plan)
    rules = R.block_rules(plan, desc)
    b, s = 8, 4
    case = build_case(cfg, InputShape("train", s, b, "train"), rules)
    n = train_plan(rules, InputShape("train", s, b, "train"))[0]
    batch = {k: torch.arange(b * s, dtype=torch.int32).reshape(b, s) + i
             for i, k in enumerate(case.args[2])}
    per = b // (n * mesh[0])
    blocks = []
    for r in range(desc.size):
        c = R.coordinates(desc, r)
        mine = R.rank_block(cfg, ("micro",), (case.in_specs[2],), (batch,),
                            rules, c)
        blocks.append(mine)
        for k, t in mine[0].items():
            micro = t.reshape(n, per, s)
            for i in range(n):
                start = i * b // n + c["data"] * per
                assert torch.equal(micro[i], batch[k][start:start + per])
    back = R.gather_blocks(cfg, ("micro",), (case.in_specs[2],), blocks,
                           (batch,), rules, desc)[0]
    for k in batch:
        assert torch.equal(back[k], batch[k])
