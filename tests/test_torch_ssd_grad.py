"""The SSD scan's gradient and the SSM family's train step across ranks,
on the CPU, in f32.

* ``ref.ssd_chunked_bwd`` (the plain version of the gradient kernel
  ``csrc/ssd_scan_bwd.cu``: a reverse recurrence over the chunks' state
  gradients, then each chunk's own terms) against autograd of the port's
  ``ssd_chunked`` and against ``jax.grad`` of the reference's: several
  chunks, a ragged batch (rows padded with dt = 0, and one chunk of an
  odd length), with and without an initial state, a zero and a nonzero
  gradient of the final state, state dims 16 and 64.
* The same at head counts no head group of the kernel divides (1, 3, 5),
  one case shorter than a 64-token tile; ``backward.workspace``, the
  kernel's scratch from shapes alone.
* ``kernel._SSD``, the autograd Function that CUDA tensors take, on CPU
  tensors (its plain forward keeping the states, its plain backward)
  gives autograd's gradients.
* The train step under the baseline ``tp_rules()`` across gloo ranks
  (``launch/ranks.run_ranks``): reduced mamba2-370m and jamba-v0.1-52b
  (one 8-layer period: attention, SSM, MLP and MoE-TP) at 1 x 2 and
  2 x 2, against one process: the loss and aux, every leaf of the new
  parameters, mu and nu. Reduced mamba2's at (1, 2) also against the
  reference's compiled GSPMD train step on 4 forced host devices (a
  subprocess), on the port's parameters and batch.
* Each rank's collective bytes against their closed form and against the
  dry-run's count of the same rank block on ``meta``.

Tolerance: 1e-5 relative, and 1e-5 absolute on the scale of each tensor
(its largest magnitude, at least 1).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels.ssd_scan import backward as SB  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked,  # noqa: E402
                                              ssd_chunked_bwd)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import ranks as R  # noqa: E402
from repro_torch.launch.mesh import CountingMesh, MeshDesc  # noqa: E402
from repro_torch.launch.specs import build_case, train_plan  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.params import abstract_params, flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MESHES = [(1, 2), (2, 2)]
ARCHS = ("mamba2-370m", "jamba-v0.1-52b")
TRAIN = (4, 16, (16, 9, 16, 12))     # batch, length, valid labels a row
TIMEOUT = 300
REF_MESH, REF_ARCH = (1, 2), "mamba2-370m"
REF_DEVICES = 4
GRADS = ("dx", "ddt", "da", "db", "dc", "dd_skip", "dinit")


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v, tuple) else str(v)


def _close(a, b, where=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=1e-5,
                               err_msg=where)


# ---------------------------------------------------------------------------
# the plain gradient against autograd and jax.grad
# ---------------------------------------------------------------------------

# (B, S, H, P, chunk, rows padded with dt = 0 over their last tokens)
LAYOUTS = {"chunks": (2, 64, 3, 16, 16, {}),
           "ragged": (2, 40, 2, 16, 8, {1: 13}),
           "one odd chunk": (1, 24, 2, 16, 24, {0: 5})}
# head counts that no group of the kernel's pair pass divides (1, 3, 5),
# one of them over fewer tokens than a 64-token tile
HEAD_LAYOUTS = {"one head, 40 tokens": (1, 40, 1, 16, 8, {}),
                "three heads": (2, 48, 3, 16, 16, {1: 9}),
                "five heads": (1, 64, 5, 32, 32, {})}


def _inputs(layout, N, init, dfinal, seed=0):
    """numpy inputs of one case: x, dt, a, b, c, d_skip, init_state (or
    None), and the output gradients dy, dfinal (or None)."""
    bsz, S, H, P, _, pads = {**LAYOUTS, **HEAD_LAYOUTS}[layout]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dt = np.log1p(np.exp(rng.normal(size=(bsz, S, H)))).astype(f32)
    for row, n in pads.items():
        dt[row, -n:] = 0
    return dict(
        x=rng.normal(size=(bsz, S, H, P)).astype(f32), dt=dt,
        a=-np.exp(0.3 * rng.normal(size=(H,))).astype(f32),
        b=(0.5 * rng.normal(size=(bsz, S, N))).astype(f32),
        c=(0.5 * rng.normal(size=(bsz, S, N))).astype(f32),
        d_skip=rng.normal(size=(H,)).astype(f32),
        init=(0.3 * rng.normal(size=(bsz, H, P, N))).astype(f32)
        if init else None,
        dy=rng.normal(size=(bsz, S, H, P)).astype(f32),
        dfinal=rng.normal(size=(bsz, H, P, N)).astype(f32)
        if dfinal else None)


def _torch_grads(v, chunk, fn):
    """Autograd of ``fn`` (ssd_chunked's signature and outputs) for the
    loss sum(y dy) + sum(final dfinal)."""
    names = ("x", "dt", "a", "b", "c", "d_skip")
    ins = [torch.tensor(v[k], requires_grad=True) for k in names]
    init = (torch.tensor(v["init"], requires_grad=True)
            if v["init"] is not None else None)
    y, fin = fn(*ins, chunk, init)
    loss = (y * torch.from_numpy(v["dy"])).sum()
    if v["dfinal"] is not None:
        loss = loss + (fin * torch.from_numpy(v["dfinal"])).sum()
    leaves = ins + ([init] if init is not None else [])
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_grads(v, chunk):
    def loss(x, dt, a, b, c, d_skip, init):
        y, fin = jax_ssd_chunked(x, dt, a, b, c, d_skip, chunk, init)
        out = jnp.sum(y * v["dy"])
        if v["dfinal"] is not None:
            out = out + jnp.sum(fin * v["dfinal"])
        return out
    args = [jnp.asarray(v[k]) for k in ("x", "dt", "a", "b", "c", "d_skip")]
    init = jnp.asarray(v["init"]) if v["init"] is not None else None
    argnums = tuple(range(7 if init is not None else 6))
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=argnums)(*args, init)]


@pytest.mark.parametrize("dfinal", [False, True], ids=["dfinal0", "dfinal"])
@pytest.mark.parametrize("init", [False, True], ids=["noinit", "init"])
@pytest.mark.parametrize("N", [16, 64])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_gradient_matches_autograd_and_jax(layout, N, init, dfinal):
    v = _inputs(layout, N, init, dfinal)
    chunk = LAYOUTS[layout][4]
    t = {k: (torch.from_numpy(a) if a is not None else None)
         for k, a in v.items()}
    got = ssd_chunked_bwd(t["x"], t["dt"], t["a"], t["b"], t["c"],
                          t["d_skip"], chunk, t["init"], None, t["dy"],
                          t["dfinal"])
    assert [g.dtype for g in got] == [torch.float32] * 7
    want_t = _torch_grads(v, chunk, ssd_chunked)
    want_j = _jax_grads(v, chunk)
    n = 7 if init else 6
    for name, g, wt, wj in zip(GRADS[:n], got, want_t, want_j):
        assert tuple(g.shape) == wj.shape, name
        _close(g.numpy(), wt, f"{name} against autograd")
        _close(g.numpy(), wj, f"{name} against jax.grad")
    if not init:   # the gradient of a zero initial state is still given
        assert tuple(got[6].shape) == v["x"].shape[:1] + (
            v["x"].shape[2], v["x"].shape[3], N)


@pytest.mark.parametrize("layout", list(HEAD_LAYOUTS))
def test_plain_gradient_at_odd_head_counts(layout):
    """The plain gradient, whose dC and dB take the heads' sum of M first,
    against autograd and jax.grad where the head count is 1, 3 or 5 and
    where the sequence is shorter than one 64-token tile: with an initial
    state and a final-state gradient, state dim 16."""
    v = _inputs(layout, 16, True, True)
    chunk = HEAD_LAYOUTS[layout][4]
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    got = ssd_chunked_bwd(t["x"], t["dt"], t["a"], t["b"], t["c"],
                          t["d_skip"], chunk, t["init"], None, t["dy"],
                          t["dfinal"])
    for name, g, wt, wj in zip(GRADS, got, _torch_grads(v, chunk, ssd_chunked),
                               _jax_grads(v, chunk)):
        _close(g.numpy(), wt, f"{name} against autograd")
        _close(g.numpy(), wj, f"{name} against jax.grad")


@pytest.mark.parametrize("shape,dtype", [
    ((4, 2048, 32, 64, 128), torch.bfloat16),   # mamba2-370m's training step
    ((1, 2048, 128, 64, 128), torch.bfloat16),  # jamba-v0.1-52b's heads
    ((4, 2048, 32, 64, 128), torch.float32),
    ((2, 320, 5, 96, 16), torch.bfloat16),      # a ragged chunk, two slices
    ((1, 40, 1, 16, 64), torch.float32),        # shorter than one tile
])
def test_gradient_workspace_from_shapes(shape, dtype):
    """``backward.workspace``: the gradient kernel's scratch from shapes
    alone, at the forward's state chunks: the head groups of its pair
    pass, the tile pairs of each chunk, the column blocks of dC and dB and
    the recurrence's blocks a head, each array's elements by its closed
    form; and ``_carve`` starts every array on a 16-byte boundary."""
    bsz, S, H, P, N = shape
    ws = SB.workspace(bsz, S, H, P, N, dtype)
    pl = SK.plan(bsz, S, H, P, N, dtype)
    L, n = pl.chunk, pl.n_chunks
    assert (ws.chunk, ws.n_chunks) == (L, n)
    T = L // 64
    assert ws.tiles == T and L % 64 == 0
    assert ws.groups == -(-H // 8) and ws.groups * 8 >= H
    assert ws.col_blocks == (2 if N == 128 else 1)
    assert ws.recur_blocks == -(-(P * N) // 1024)
    rows = bsz * n * H
    assert (ws.cum, ws.colp, ws.dapart, ws.dec) == (rows * L, rows * L,
                                                   rows, rows)
    assert ws.rowp == rows * T * L and ws.upart == ws.ddpart == rows * T
    assert ws.offp == rows * ws.col_blocks * L
    assert ws.gspart == rows * ws.recur_blocks
    assert ws.mpart == ws.groups * bsz * n * T * (T + 1) // 2 * 64 * 64
    planes = 2 if dtype == torch.bfloat16 else 1
    assert ws.dstates == bsz * n * H * P * N
    assert ws.gstates == planes * ws.dstates == pl.prev_elems
    if shape == (4, 2048, 32, 64, 128) and dtype == torch.bfloat16:
        # 7t's step: 8 chunks of 256, 4 head groups, 10 tile pairs a chunk
        assert (L, n, ws.groups, T * (T + 1) // 2) == (256, 8, 4, 10)
        assert 4 * ws.mpart == 4 * 4 * 32 * 10 * 4096   # 21 MB of f32
    sizes = (ws.mpart, ws.dstates, ws.dec, 3, 5)
    views = SB._carve(torch.empty(SB._total16(sizes, 4)), sizes)
    assert [v.numel() for v in views] == list(sizes)
    assert all(v.data_ptr() % 16 == 0 for v in views)


def test_plain_gradient_reads_the_kept_states():
    """Given the forward's states before each chunk (what the autograd
    Function keeps), the gradient equals the one that recomputes them,
    bitwise; and dx, db and dc come back in x's dtype, ddt, da and
    dd_skip in those of dt, a and d_skip, computed in f64 for f64 x."""
    v = _inputs("chunks", 16, True, True)
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    args = (t["x"], t["dt"], t["a"], t["b"], t["c"], t["d_skip"], 16,
            t["init"])
    prev = SK.ssd_scan_with_states(*args)[2]
    assert tuple(prev.shape) == (2, 4, 3, 16, 16)
    kept = ssd_chunked_bwd(*args, prev, t["dy"], t["dfinal"])
    again = ssd_chunked_bwd(*args, None, t["dy"], t["dfinal"])
    assert all(torch.equal(a, b) for a, b in zip(kept, again))
    low = [t[k].to(torch.float64) if k in ("x", "b", "c", "dy") else t[k]
           for k in ("x", "dt", "a", "b", "c", "d_skip")]
    out = ssd_chunked_bwd(*low, 16, None, None, t["dy"].double(), None)
    assert [g.dtype for g in out] == [torch.float64, torch.float32,
                                      torch.float32, torch.float64,
                                      torch.float64, torch.float32,
                                      torch.float64]


@pytest.mark.parametrize("init", [False, True], ids=["noinit", "init"])
def test_autograd_function_gives_autograds_gradients(init):
    """``kernel._SSD`` on CPU tensors: its forward (the plain version,
    keeping the states) returns ssd_chunked's outputs bitwise, and its
    backward (the plain gradient) autograd's gradients of them; the
    final state's gradient reaches it, and a state nobody reads gets
    none."""
    v = _inputs("ragged", 16, init, True)
    chunk = LAYOUTS["ragged"][4]

    def through_function(*a):
        return SK._SSD.apply(*a)

    want = _torch_grads(v, chunk, ssd_chunked)
    got = _torch_grads(v, chunk, through_function)
    assert len(got) == len(want) == (7 if init else 6)
    for name, g, w in zip(GRADS, got, want):
        _close(g, w, name)
    t = {k: (torch.from_numpy(a) if a is not None else None)
         for k, a in v.items()}
    args = (t["x"], t["dt"], t["a"], t["b"], t["c"], t["d_skip"], chunk,
            t["init"])
    for a, b in zip(SK._SSD.apply(*args), ssd_chunked(*args)):
        assert torch.equal(a, b)
    x = t["x"].clone().requires_grad_(True)
    y, _ = SK._SSD.apply(x, *args[1:])
    (gx,) = torch.autograd.grad(y.sum(), [x])   # dfinal None: zeros
    y2, _ = ssd_chunked(x, *args[1:])
    (wx,) = torch.autograd.grad(y2.sum(), [x])
    _close(gx.numpy(), wx.numpy(), "dx without a final-state gradient")


# ---------------------------------------------------------------------------
# the train step across ranks
# ---------------------------------------------------------------------------

# the reference's compiled train step on forced host devices: its train
# case under tp_rules on an Auto mesh of (data, model), run on the port's
# parameters and batch from a fresh AdamW state
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
from repro.training.optimizer import AdamW

feed_file, out_file, arch = sys.argv[1:4]
data, model = json.loads(sys.argv[4])
sizes = {"data": data, "model": model}
mesh = jax.make_mesh((data, model), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2,
                     devices=jax.devices()[:data * model])
cfg = get_config(arch).reduced()
feed = np.load(feed_file)
tree = jax.tree.structure(abstract_params(cfg, jnp.float32))
params = jax.tree.unflatten(tree, [jnp.asarray(feed[f"p{i}"])
                                   for i in range(tree.num_leaves)])
batch = {k: jnp.asarray(feed[k]) for k in ("tokens", "labels")}
b, s = batch["tokens"].shape
case = build_case(cfg, InputShape("train", s, b, "train"),
                  tp_rules(axis_sizes=sizes))
args = (params, AdamW().init(params), batch)


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


sh = jax.tree.map(one, case.in_specs, args,
                  is_leaf=lambda x: x is None or isinstance(x, P))
with jax.set_mesh(mesh):
    new_params, state, metrics = jax.jit(case.fn, in_shardings=sh)(*args)
out = {}
for name, tree_out in (("p", new_params), ("mu", state.mu),
                       ("nu", state.nu)):
    for i, x in enumerate(jax.tree.leaves(tree_out)):
        out[f"{name}{i}"] = np.asarray(x)
for k in ("loss", "aux"):
    out[k] = np.asarray(metrics[k])
np.savez(out_file, **out)
print("done")
"""


def _plan(arch):
    return R.Plan(arch, expert_parallel=False, train=TRAIN)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's ranks, started once with every arch's plan, and each
    plan in one process (its microbatches follow the data axis); the
    reference's subprocess runs meanwhile on mamba2's (1, 2) plan."""
    base = tmp_path_factory.mktemp("ssd_grad_ranks")
    plan = _plan(REF_ARCH)
    one = R.run_plan(plan, MeshDesc(REF_MESH, AXES), "cpu")
    feed = {f"p{i}": t.numpy()
            for i, t in enumerate(flatten(R.plan_params(plan, "cpu")))}
    feed.update({k: t.numpy() for k, t in one["inputs"]["train"][0].items()})
    np.savez(base / "feed.npz", **feed)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count="
                         f"{REF_DEVICES}")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(base / "feed.npz"), str(base / "ref.npz"),
                            REF_ARCH, json.dumps(list(REF_MESH))], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    out = {}
    try:
        for mesh in MESHES:
            desc = MeshDesc(mesh, AXES)
            got = R.run_ranks(desc, [("plan", dict(plan=_plan(a)))
                                     for a in ARCHS],
                              backend="gloo", device="cpu",
                              run_dir=base / _ids(mesh), timeout=TIMEOUT)
            for i, arch in enumerate(ARCHS):
                single = (one if (mesh, arch) == (REF_MESH, REF_ARCH)
                          else R.run_plan(_plan(arch), desc, "cpu"))
                out[(mesh, arch)] = dict(
                    ranks=[g[i]["train"] for g in got], one=single["train"])
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err
    out["reference"] = dict(np.load(base / "ref.npz"))
    return out


def _gathered(run, mesh, arch):
    desc = MeshDesc(mesh, AXES)
    plan = _plan(arch)
    return R.gather_blocks(R.plan_config(plan), R.OUT_ROLES["train"],
                           (None,) * 3, [rec["out"] for rec in run["ranks"]],
                           run["one"]["out"], R.block_rules(plan, desc),
                           desc)


CASES = [(mesh, arch) for mesh in MESHES for arch in ARCHS]


@pytest.mark.parametrize("mesh,arch", CASES, ids=_ids)
def test_train_step_matches_one_process(runs, mesh, arch):
    run = runs[(mesh, arch)]
    p, s, _ = _gathered(run, mesh, arch)
    want_p, want_s, want_m = run["one"]["out"]
    for i, (a, b) in enumerate(zip(flatten((p, s.mu, s.nu)),
                                   flatten((want_p, want_s.mu, want_s.nu)))):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, f"leaf {i} of (params, mu, nu)")
    assert int(s.step) == int(want_s.step) == 1
    first = run["ranks"][0]["out"][2]
    assert set(first) == {"loss", "aux"}
    for rec in run["ranks"]:
        for k, v in rec["out"][2].items():
            assert torch.equal(v, first[k]), k
            _close(v, want_m[k], k)
    # a rank holds its heads of each SSM layer's parameters
    cfg = R.plan_config(_plan(arch))
    layer = next(b for b in run["ranks"][0]["out"][0]["blocks"]
                 if "ssm" in b)["ssm"]
    assert layer["a_log"].shape[-1] == cfg.ssm.n_heads(cfg.d_model) // mesh[1]


def test_train_step_matches_the_reference(runs):
    """Reduced mamba2's ranks at (1, 2), gathered, against the reference's
    train case compiled under the same rules on an ``Auto`` mesh of the
    same shape, run on the same parameters and batch: every leaf of the
    new parameters, mu and nu, and the loss and aux."""
    run = runs[(REF_MESH, REF_ARCH)]
    ref = runs["reference"]
    p, s, _ = _gathered(run, REF_MESH, REF_ARCH)
    for prefix, tree in (("p", p), ("mu", s.mu), ("nu", s.nu)):
        got = flatten(tree)
        assert f"{prefix}{len(got)}" not in ref
        for i, a in enumerate(got):
            want = ref[f"{prefix}{i}"]
            assert tuple(a.shape) == want.shape, (prefix, i)
            _close(a, want, f"{prefix}{i}")
    for rec in run["ranks"]:
        for k in ("loss", "aux"):
            _close(rec["out"][2][k], ref[k], k)


def _layers(cfg, mixer=None, ffn=None):
    return cfg.n_repeats * sum(
        (mixer is None or sp.mixer == mixer) and (ffn is None or sp.ffn == ffn)
        for sp in cfg.pattern)


def closed_form(arch, mesh):
    """Result bytes a rank moves in one train step under the baseline
    rules, f32, remat on (a repeat's forward collectives issued again by
    its recompute, but for the one that ends the repeat past its last
    saved tensor: torch's checkpoint stops its recompute there). Per
    microbatch: the embedding's all-reduce, the vocab-parallel cross
    entropy's; an attention layer's row-cut all-reduce and its K/V
    gathers (their reduce-scatters in the backward), an MLP's all-reduce,
    a MoE-TP layer's expert buffers, each with its input's all-reduce
    ("f") in the backward; an SSM layer's gathers of the fused activation
    and the conv's weights (their reduce-scatters in the backward),
    out_norm's summed squares (rows, seq) and w_out's partial products,
    and in the backward its input's all-reduce and the summed squares'.
    Over data ranks: the MoE aux sums, the global count. Per step: the
    data-parallel reduction of every gradient, the clip's norm."""
    plan = _plan(arch)
    cfg = R.plan_config(plan)
    desc = MeshDesc(mesh, AXES)
    rules = R.plan_rules(plan, desc)
    d_ranks, m = mesh
    b, s = plan.train[:2]
    n, chunk = train_plan(rules, InputShape("train", s, b, "train"))
    rows = b // (d_ranks * n)
    tokens, f, d = rows * s, 4, cfg.d_model
    last = cfg.pattern[-1]
    # the repeat's last collective, issued once in the forward
    ends = "mlp" if last.ffn == "mlp" else (last.mixer if last.ffn == "none"
                                            else None)
    ar = ag = rs = 0
    n_attn = _layers(cfg, mixer="attn")
    if n_attn:
        q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        if q % m == 0:
            fwd = 1 if ends == "attn" else 2
            ar += n_attn * (fwd + 1) * tokens * d * f
        if kv % m == 0 and cfg.n_kv_heads % m:
            ag += n_attn * 2 * 2 * tokens * kv * f
            if cfg.n_heads % m == 0:
                rs += n_attn * 2 * tokens * kv // m * f
    if cfg.d_ff and cfg.d_ff % m == 0:
        fwd = 1 if ends == "mlp" else 2
        ar += _layers(cfg, ffn="mlp") * (fwd + 1) * tokens * d * f
        if cfg.moe is not None:
            ar += _layers(cfg, ffn="moe") * 3 * rows * cfg.moe.n_experts * \
                MOE.capacity(cfg, s) * d * f
    if cfg.moe is not None and d_ranks > 1:
        ar += _layers(cfg, ffn="moe") * 2 * 2 * cfg.moe.n_experts * 4
    n_ssm = _layers(cfg, mixer="ssm")
    if n_ssm:
        ssm = cfg.ssm
        inner, N, W = ssm.inner_dim(d), ssm.state_dim, ssm.conv_width
        fused, conv = 2 * inner + 2 * N + ssm.n_heads(d), inner + 2 * N
        gathered = tokens * fused + W * conv + conv
        ag += n_ssm * 2 * gathered * f
        rs += n_ssm * gathered // m * f
        fwd = 1 if ends == "ssm" else 2
        ar += n_ssm * (2 * tokens + fwd * tokens * d) * f      # forward
        ar += n_ssm * (tokens * d + tokens) * f                 # backward
    pred = s - 1
    if chunk and pred > chunk:
        pred = -(-pred // chunk) * chunk
    if cfg.vocab % m == 0:
        ar += tokens * d * f                        # the embedding
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


@pytest.mark.parametrize("mesh,arch", CASES, ids=_ids)
def test_collective_bytes_closed_form_and_meta_count(runs, mesh, arch):
    """Every rank's collective bytes equal the closed form, and the
    dry-run's count of the same rank block's train step on ``meta``
    (``dryrun.rank_collectives``, which now counts the SSM family's train
    cases)."""
    run = runs[(mesh, arch)]
    want = closed_form(arch, mesh)
    plan = _plan(arch)
    cfg = R.plan_config(plan)
    desc = MeshDesc(mesh, AXES)
    b, s = plan.train[:2]
    for r, rec in enumerate(run["ranks"]):
        assert rec["collectives"] == want, r
        coords = R.coordinates(desc, r)
        rules = R.plan_rules(plan, desc, CountingMesh(desc, coords))
        assert dryrun.collective_reason(cfg, "train", rules) is None
        case = build_case(cfg, InputShape("train", s, b, "train"), rules)
        case.args = R._walk(lambda _, t: torch.empty(
            t.shape, dtype=torch.float32 if t.is_floating_point()
            else t.dtype, device="meta"), None, case.args)
        got = dryrun.rank_collectives(cfg, case, "train", rules, coords)
        assert got == rec["collectives"], r
