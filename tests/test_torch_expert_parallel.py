"""The expert-parallel branch of ``moe_block`` across real ranks, on the
CPU: gloo ranks started by ``launch/ranks.run_ranks`` (spawn, a
``file://`` store under ``tmp_path``, every join under a timeout, so a
hung rank fails its test).

* ``moe_block`` at meshes 1 x 2, 1 x 4 and 2 x 2, ``fsdp`` off and on,
  capacity factor 1.25 (which drops) and 8.0: each rank's output, aux
  and kept selections against the port's one-process block on that
  rank's rows, and the gradients with respect to x, each rank's expert
  shard and the whole leaves against the one-process gradient's block,
  each rank's loss being sum(y ** 2) over its rows plus the global aux
  (its means over every data rank's rows, as the reference's are under
  GSPMD), so that the global loss is sum(y ** 2) + aux on the whole
  batch (a leaf that data ranks share is summed over them here, as the
  train step's data-parallel reduction sums it).
* The same block against the reference's own ``shard_map`` branch on 4
  forced host devices (a subprocess: ``XLA_FLAGS``, an ``Auto`` mesh),
  forward and ``jax.grad`` at (1, 4) and (2, 2); and the reference's
  failure on a mesh with ``Explicit`` axes (jax 0.9's default), a
  property of the reference that the port does not copy.
* The case builders' steps of reduced mixtral-8x7b, llama4-scout-17b-a16e
  and jamba-v0.1-52b at 1 x 2 and 2 x 2 (prefill, then decode over the
  caches it filled) and mixtral's train step at 1 x 2 (loss, new
  parameters and AdamW state gathered from the ranks), against the same
  plan in one process (over data ranks: ``tests/test_torch_train_parallel.py``).
* The collective counter against its closed form, nothing counted
  without a mesh; a rank's block and its inverse; ``init_params``' cut.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.launch import collectives, distributed  # noqa: E402
from repro_torch.launch import ranks as R  # noqa: E402
from repro_torch.launch.mesh import MeshDesc  # noqa: E402
from repro_torch.launch.specs import build_case  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import partitioning as PT  # noqa: E402
from repro_torch.models.params import (flatten, init_params,  # noqa: E402
                                       moe_spec, param_structure)
from repro_torch.models.model import train_forward  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = [(1, 2), (1, 4), (2, 2)]
FSDP = [False, True]
CAPACITY = [1.25, 8.0]
MOE_CASES = list(itertools.product(MESHES, FSDP, CAPACITY))
ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e", "jamba-v0.1-52b"]
PLAN_MESHES = [(1, 2), (2, 2)]
# (mesh, fsdp) of the runs held to the reference's shard_map branch
REF_CASES = [((1, 4), False), ((2, 2), True)]
X_SHAPE = (4, 16)                # batch, sequence of the moe_block input
PREFILL = (4, 16, (16, 11, 16, 9))
TRAIN = (2, 16)
TIMEOUT = 300                    # seconds a group of ranks may take
TOL = dict(atol=1e-5, rtol=1e-5)


def _ids(v):
    if isinstance(v, tuple):
        return "x".join(map(str, v))
    if isinstance(v, bool):
        return "fsdp" if v else "nofsdp"
    return str(v)


def _moe_cfg(capacity):
    cfg = get_config("mixtral-8x7b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity))


def _plan(arch, mesh):
    train = TRAIN if (arch, mesh) == ("mixtral-8x7b", (1, 2)) else None
    return R.Plan(arch, prefill=PREFILL, decode=True, train=train)


# the reference's branch on 4 forced host devices, in its own process
REFERENCE = r'''
import os, sys, traceback
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import moe as JMOE, partitioning as JPT
from repro.models.params import init_params

cfg = get_config("mixtral-8x7b").reduced()
p = {k: w[0] for k, w in init_params(cfg, jax.random.PRNGKey(0))
     ["blocks"][0]["moe"].items()}
x = jnp.asarray(np.random.default_rng(0).standard_normal(
    (int(sys.argv[2]), int(sys.argv[3]), cfg.d_model)).astype(np.float32))
out = {}
for shape, fsdp in [((1, 4), False), ((2, 2), True)]:
    tag = f"{shape[0]}x{shape[1]}"
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = JPT.tp_rules(expert_parallel=True, fsdp=fsdp, mesh=mesh,
                         axis_sizes=dict(zip(("data", "model"), shape)))
    blocks = np.split(np.arange(x.shape[0]), shape[0])

    def ep(p, x):
        with JPT.use_rules(rules):
            return JMOE.moe_block(p, x, cfg)[0]

    def auxes(p, x):
        # the aux of the whole batch: its means over every data rank's rows
        with JPT.use_rules(rules):
            return JMOE.moe_block(p, x, cfg)[1]

    def loss(p, x):
        return jnp.sum(ep(p, x) ** 2) + auxes(p, x)

    with jax.set_mesh(mesh):
        out[tag + "_y"] = np.asarray(jax.jit(ep)(p, x))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        out[tag + "_aux"] = np.asarray(jax.jit(auxes)(p, x))
    out[tag + "_gx"] = np.asarray(gx)
    for k, v in gp.items():
        out[tag + "_g_" + k] = np.asarray(v)
# the production mesh's call: axes Explicit by default under jax 0.9
mesh = jax.make_mesh((1, 4), ("data", "model"))
rules = JPT.tp_rules(expert_parallel=True, mesh=mesh,
                     axis_sizes={"data": 1, "model": 4})
out["explicit_axes"] = np.array([str(t) for t in mesh.axis_types])
try:
    with JPT.use_rules(rules):
        JMOE.moe_block(p, x, cfg)
    out["explicit"] = np.array(["no error", "", "-1"])
except Exception as e:
    lines = [f.lineno for f in traceback.extract_tb(e.__traceback__)
             if f.filename.endswith(os.path.join("repro", "models",
                                                 "moe.py"))]
    out["explicit"] = np.array([type(e).__name__, str(e),
                                str(lines[-1] if lines else -1)])
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def reference_params():
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    cfg = get_config("mixtral-8x7b").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    pp = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    p = {k: w[0].contiguous() for k, w in pp["blocks"][0]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        X_SHAPE + (cfg.d_model,)).astype(np.float32))
    return p, x


@pytest.fixture(scope="module")
def runs(reference_params, tmp_path_factory):
    """Every group of ranks, started once: per mesh, the moe_block jobs
    (fsdp x capacity) and, at 1 x 2 and 2 x 2, the plans of the three
    archs. The reference's subprocess runs meanwhile."""
    p, x = reference_params
    base = tmp_path_factory.mktemp("ranks")
    ref_file = base / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(ref_file),
                            *map(str, X_SHAPE)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        for mesh in MESHES:
            jobs = [("moe", dict(cfg=_moe_cfg(c), p=p, x=x, fsdp=f))
                    for f, c in itertools.product(FSDP, CAPACITY)]
            if mesh in PLAN_MESHES:
                jobs += [("plan", dict(plan=_plan(a, mesh))) for a in ARCHS]
            got = R.run_ranks(MeshDesc(mesh, AXES), jobs, backend="gloo",
                              device="cpu", run_dir=base / _ids(mesh),
                              timeout=TIMEOUT)
            n = len(FSDP) * len(CAPACITY)
            for r_jobs in got:
                assert len(r_jobs) == len(jobs)
            out[mesh] = {
                "moe": {fc: [g[i] for g in got] for i, fc in enumerate(
                    itertools.product(FSDP, CAPACITY))},
                "plan": {a: [g[n + i] for g in got]
                         for i, a in enumerate(ARCHS)}
                if mesh in PLAN_MESHES else {}}
        text, _ = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, text
    out["reference"] = dict(np.load(ref_file))
    return out


def _rules(mesh, fsdp):
    desc = MeshDesc(mesh, AXES)
    # a mesh in the rules as the ranks have one: the branch's condition,
    # so the same leaves are cut
    return desc, PT.tp_rules(expert_parallel=True, fsdp=fsdp,
                             axis_sizes=desc.axis_sizes, mesh=desc)


def _single(cfg, p, x, n_data):
    """The one-process block on the whole batch: its outputs on each data
    rank's rows (the aux of the whole batch on each), and the gradient of
    its loss, sum(y ** 2) + aux."""
    leaf = {k: t.clone().requires_grad_(True) for k, t in p.items()}
    xx = x.clone().requires_grad_(True)
    y, aux, keep, loss = R.moe_loss(leaf, xx, cfg)
    per = [(yb, aux.detach(), kb) for yb, kb in zip(
        y.detach().chunk(n_data), keep.chunk(n_data))]
    names = sorted(leaf)
    g = torch.autograd.grad(loss, [xx] + [leaf[k] for k in names])
    return per, g[0], dict(zip(names, g[1:]))


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), **(tol or TOL))


def _rel(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rtol * np.abs(b).max(), (
        np.abs(a - b).max(), np.abs(b).max())


def _global_grads(cfg, desc, rules, results):
    """Each leaf's gradient of the global loss, from the ranks: a leaf cut
    over the data axis has it already (the reduce-scatter summed the data
    ranks'); any other leaf is summed over the data ranks of its expert
    coordinate. The blocks are then put together."""
    structure = moe_spec(cfg)
    summed = []
    for r in range(desc.size):
        model = R.coordinates(desc, r)["model"]
        line = [q for q in range(desc.size)
                if R.coordinates(desc, q)["model"] == model]
        g = {}
        for k, spec in structure.items():
            if "data" in (R.expert_entries(spec, rules) or ()):
                g[k] = results[r]["grads"][k]
            else:
                g[k] = sum(results[q]["grads"][k] for q in line)
        summed.append((g,))
    like = {k: torch.empty(s.shape, device="meta")
            for k, s in structure.items()}
    return R.gather_blocks(cfg, ("params",), (None,), summed, (like,),
                           rules, desc, structure=structure)[0]


# ---------------------------------------------------------------------------
# moe_block across ranks against the port in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,fsdp,capacity", MOE_CASES, ids=_ids)
def test_moe_block_across_ranks(runs, reference_params, mesh, fsdp,
                                capacity):
    p, x = reference_params
    cfg = _moe_cfg(capacity)
    desc, _ = _rules(mesh, fsdp)
    per, _, _ = _single(cfg, p, x, mesh[0])
    results = runs[mesh]["moe"][(fsdp, capacity)]
    dropped = 0
    for r, res in enumerate(results):
        y, aux, keep = per[R.coordinates(desc, r)["data"]]
        _close(res["y"], y)
        _close(res["aux"], aux)
        assert torch.equal(res["keep"], keep), r
        dropped += int((~keep).sum())
    # 1.25 drops selections of these rows, 8.0 none
    assert (dropped > 0) == (capacity == 1.25)


@pytest.mark.parametrize("mesh,fsdp,capacity", MOE_CASES, ids=_ids)
def test_moe_gradients_across_ranks(runs, reference_params, mesh, fsdp,
                                    capacity):
    p, x = reference_params
    cfg = _moe_cfg(capacity)
    desc, rules = _rules(mesh, fsdp)
    _, gx, gp = _single(cfg, p, x, mesh[0])
    results = runs[mesh]["moe"][(fsdp, capacity)]
    rows = gx.chunk(mesh[0])
    for r, res in enumerate(results):
        _close(res["grad_x"], rows[R.coordinates(desc, r)["data"]])
        # what the rank holds is its block of the whole parameters
        want = R.rank_block(cfg, ("params",), (None,), (p,), rules,
                            R.coordinates(desc, r),
                            structure=moe_spec(cfg))[0]
        for k in want:
            assert torch.equal(res["held"][k], want[k]), (r, k)
    got = _global_grads(cfg, desc, rules, results)
    for k in gp:
        _close(got[k], gp[k], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("mesh,fsdp", list(itertools.product(MESHES, FSDP)),
                         ids=_ids)
def test_collective_bytes_closed_form(runs, mesh, fsdp):
    """Per rank, in f32: the forward all-gathers the outputs (B / data, E,
    C, d) over the expert axis and, under fsdp with data > 1, wi, wg, wo
    over data, and with data > 1 all-reduces the aux loss's sums (the
    router's probabilities and the top-1 counts, 2 E) over data; the
    backward all-gathers the buffers' gradient and reduce-scatters the
    three weight gradients."""
    for capacity in CAPACITY:
        cfg = _moe_cfg(capacity)
        n_data = mesh[0]
        B, S = X_SHAPE
        E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
        ep = mesh[1]
        C = MOE.capacity(cfg, S)
        out = (B // n_data) * E * C * d * 4
        weights = 3 * (E // ep) * d * f * 4 if fsdp and n_data > 1 else 0
        want_fwd = {"all-gather": out + weights}
        want = {"all-gather": 2 * out + weights}
        if weights:
            want["reduce-scatter"] = weights // n_data
        if n_data > 1:
            want_fwd["all-reduce"] = want["all-reduce"] = 2 * E * 4
        for res in runs[mesh]["moe"][(fsdp, capacity)]:
            assert res["forward"] == want_fwd
            assert res["total"] == want
            assert res["calls"]["all-gather"] == (2 + 3 * bool(weights))


def test_collectives_count_nothing_without_a_mesh(reference_params):
    p, x = reference_params
    cfg = _moe_cfg(1.25)
    collectives.reset()
    y0, _ = MOE.moe_block(p, x, cfg)
    with PT.use_rules(PT.tp_rules(expert_parallel=True,
                                  axis_sizes={"data": 1, "model": 4})):
        y1, _ = MOE.moe_block(p, x, cfg)
    assert torch.equal(y0, y1)
    assert collectives.collective_bytes() == {}
    assert collectives.collective_calls() == {}


# ---------------------------------------------------------------------------
# against the reference's shard_map branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,fsdp", REF_CASES, ids=_ids)
def test_branch_equals_reference_shard_map(runs, mesh, fsdp):
    ref = runs["reference"]
    tag = _ids(mesh)
    cfg = _moe_cfg(1.25)
    desc, rules = _rules(mesh, fsdp)
    results = runs[mesh]["moe"][(fsdp, 1.25)]
    y_rows = np.split(ref[tag + "_y"], mesh[0])
    gx_rows = np.split(ref[tag + "_gx"], mesh[0])
    for r, res in enumerate(results):
        i = R.coordinates(desc, r)["data"]
        _close(res["y"], y_rows[i])
        _close(res["aux"], ref[tag + "_aux"])
        _rel(res["grad_x"], gx_rows[i], 1e-4)
    got = _global_grads(cfg, desc, rules, results)
    for k in got:
        _rel(got[k], ref[f"{tag}_g_{k}"], 1e-4)


def test_reference_fails_on_explicit_mesh_axes(runs):
    """jax 0.9 makes mesh axes Explicit by default; the reference's
    production mesh is built that way (``repro/launch/mesh.py``), and its
    branch then fails at the concatenate of the expert outputs with the
    trash row (``repro/models/moe.py:95-96``). A property of the
    reference, not copied: the port's branch runs at the same shapes
    (``test_branch_equals_reference_shard_map``)."""
    ref = runs["reference"]
    assert set(ref["explicit_axes"]) == {"AxisType.Explicit"}
    kind, msg, line = ref["explicit"]
    assert kind == "ValueError", (kind, msg)
    assert "does not evenly divide" in msg, msg
    assert int(line) in (95, 96), line


# ---------------------------------------------------------------------------
# the case builders' steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", PLAN_MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_case_steps_across_ranks(runs, arch, mesh):
    plan = _plan(arch, mesh)
    desc, rules = _rules(mesh, False)
    ref = R.run_plan(plan, desc, "cpu")
    cfg = R.plan_config(plan)
    results = runs[mesh]["plan"][arch]
    b, s, _ = PREFILL
    n_moe = sum(sp.ffn == "moe" for sp in cfg.pattern) * cfg.n_repeats
    for kind, seq in (("prefill", s), ("decode", 1)):
        case = build_case(cfg, InputShape(kind, s, b, kind), rules)
        specs = R.out_specs(kind, case, rules)
        C = MOE.capacity(cfg, seq)
        for r, res in enumerate(results):
            want = R.rank_block(cfg, R.OUT_ROLES[kind], specs,
                                ref[kind]["out"], rules,
                                R.coordinates(desc, r))
            got = res[kind]["out"]
            pairs = [(a, w) for a, w in zip(flatten(got), flatten(want))
                     if a is not None]
            assert len(pairs) == len([w for w in flatten(want)
                                      if w is not None])
            for a, w in pairs:
                assert a.shape == w.shape and a.dtype == w.dtype
                _close(a, w)
            # the outputs of n_moe layers, gathered over the expert axis
            assert res[kind]["collectives"] == {
                "all-gather": n_moe * (b // mesh[0]) * cfg.moe.n_experts
                * C * cfg.d_model * 4}, (kind, r)
        # the rows put back together are the one-process outputs
        whole = R.gather_blocks(cfg, R.OUT_ROLES[kind], specs,
                                [res[kind]["out"] for res in results],
                                ref[kind]["out"], rules, desc)
        for a, w in zip(flatten(whole), flatten(ref[kind]["out"])):
            if w is not None:
                _close(a, w)


def test_train_step_across_ranks(runs):
    mesh = (1, 2)
    plan = _plan("mixtral-8x7b", mesh)
    desc, rules = _rules(mesh, False)
    ref = R.run_plan(plan, desc, "cpu")["train"]
    cfg = R.plan_config(plan)
    results = [res["train"] for res in runs[mesh]["plan"]["mixtral-8x7b"]]
    p_ref, s_ref, m_ref = ref["out"]
    for res in results:
        _close(res["out"][2]["loss"], m_ref["loss"])
        _close(res["out"][2]["aux"], m_ref["aux"])
        # the expert blocks' squared norm, summed over the expert axis
        assert res["collectives"]["all-reduce"] == 4
    p_got, s_got, _ = R.gather_blocks(
        cfg, R.OUT_ROLES["train"], (None, None, None),
        [res["out"] for res in results], ref["out"], rules, desc)
    for a, w in zip(flatten(p_got), flatten(p_ref)):
        _close(a, w)
    for a, w in zip(flatten((s_got.mu, s_got.nu)), flatten((s_ref.mu,
                                                            s_ref.nu))):
        _close(a, w)
    assert int(s_got.step) == int(s_ref.step) == 1


def test_train_step_refuses_data_ranks():
    """Over data ranks the step runs under the expert-parallel rules
    (``tests/test_torch_train_parallel.py``); under the fsdp rules, whose
    ZeRO-3 training across data ranks is not ported, it raises before
    any work."""
    class Mesh:                     # a live mesh, as far as the step asks
        axis_sizes = {"data": 2, "model": 2}

        def coordinate(self, axis):
            return 0

        def group(self, axis):
            raise AssertionError("no collective may be called")

    cfg = get_config("mixtral-8x7b").reduced()
    step = make_train_step(cfg, AdamW())
    rules = PT.tp_rules(expert_parallel=True, fsdp=True, mesh=Mesh(),
                        axis_sizes=Mesh.axis_sizes)
    with PT.use_rules(rules), pytest.raises(NotImplementedError,
                                            match="fsdp's ZeRO-3 training"):
        step(None, None, None)


# ---------------------------------------------------------------------------
# blocks, the parameter cut, the bootstrap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,fsdp", list(itertools.product(MESHES, FSDP)),
                         ids=_ids)
def test_rank_blocks_and_their_inverse(mesh, fsdp):
    """``init_params``' cut draws the whole tree's block; the blocks of a
    train case's arguments put back together are the whole; only the
    expert leaves (and their moments) are cut, by E / ep (and d / data
    under fsdp), and the batch by its rows: over data ranks, a rank's
    share of each of the reference's microbatches (``ranks.micro_order``)."""
    cfg = get_config("mixtral-8x7b").reduced()
    desc, rules = _rules(mesh, fsdp)
    case = build_case(cfg, InputShape("train", 8, 4, "train"), rules)
    whole = init_params(cfg, device="cpu")
    state = AdamW().init(whole)
    state = state._replace(mu=init_params(cfg, torch.Generator()
                                          .manual_seed(3), device="cpu"))
    batch = {k: torch.arange(32, dtype=torch.int32).reshape(4, 8) + i
             for i, k in enumerate(case.args[2])}
    args = (whole, state, batch)
    blocks = []
    for r in range(desc.size):
        c = R.coordinates(desc, r)
        drawn = init_params(cfg, device="cpu", cut=R.param_cut(rules, c))
        mine = R.rank_block(cfg, R.ARG_ROLES["train"], case.in_specs, args,
                            rules, c)
        for a, b in zip(flatten(drawn), flatten(mine[0])):
            assert torch.equal(a, b)
        blocks.append(mine)
        for spec, a, w in zip(flatten(param_structure(cfg)),
                              flatten(mine[0]), flatten(whole)):
            cut = {"expert": mesh[1], "embed": mesh[0] if fsdp else 1}
            if "expert" not in spec.axes:
                cut = {}
            assert tuple(a.shape) == tuple(
                n // cut.get(ax, 1) for n, ax in zip(w.shape, spec.axes))
        rows = 4 // mesh[0]
        order = R.micro_order(rules, 4)
        for k, t in mine[2].items():
            whole_rows = batch[k] if order is None else batch[k][order]
            assert torch.equal(t, whole_rows[c["data"] * rows:
                                             (c["data"] + 1) * rows])
    back = R.gather_blocks(cfg, R.ARG_ROLES["train"], case.in_specs, blocks,
                           args, rules, desc)
    for a, b in zip(flatten(back), flatten(args)):
        assert torch.equal(a, b)


def test_distributed_states_its_backend_and_device():
    with pytest.raises(ValueError, match="backend"):
        distributed.device_for("mpi", "cpu", 0)
    with pytest.raises(ValueError, match="NCCL"):
        distributed.device_for("nccl", "cpu", 0)
    assert distributed.device_for("gloo", "cpu", 3) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            distributed.device_for("gloo", "cuda", 0)
    assert not torch.distributed.is_initialized()


def test_branch_refuses_a_mesh_description(reference_params):
    p, x = reference_params
    cfg = _moe_cfg(1.25)
    rules = PT.tp_rules(expert_parallel=True, mesh=MeshDesc((1, 2), AXES),
                        axis_sizes={"data": 1, "model": 2})
    with PT.use_rules(rules), pytest.raises(TypeError, match="ProcessMesh"):
        MOE.moe_block(p, x, cfg)


def test_remat_recompute_keeps_the_rules(monkeypatch):
    """On the card autograd runs the backward, and with remat each
    repeat's recompute, on a thread of its own, where the thread-local
    rules are unset: the recompute takes the rules of the forward (else a
    rank would recompute the experts as if it held all of them)."""
    cfg = get_config("mixtral-8x7b").reduced()
    params = init_params(cfg, device="cpu")
    live = [t.requires_grad_(True) for t in flatten(params)]
    batch = {k: torch.randint(0, cfg.vocab, (2, 8), generator=torch
                              .Generator().manual_seed(1), dtype=torch.int32)
             for k in ("tokens", "labels")}
    seen = []
    constrain = PT._constrain
    monkeypatch.setattr(PT, "_constrain", lambda x, s: seen.append(
        threading.current_thread().name) or constrain(x, s))
    with PT.use_rules(PT.tp_rules(expert_parallel=True,
                                  axis_sizes={"data": 1, "model": 2})):
        total, _ = train_forward(params, cfg, batch, remat=True)
    n_forward = len(seen)
    grads = {}
    worker = threading.Thread(name="backward", target=lambda: grads.update(
        g=torch.autograd.grad(total, live)))
    worker.start()
    worker.join(60)
    assert not worker.is_alive() and len(grads["g"]) == len(live)
    # every repeat recomputed on the backward's thread, under the rules
    assert n_forward > 0 and seen[n_forward:].count("backward") > 0
    assert PT.current_rules() is None
