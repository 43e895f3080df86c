"""Production-mesh dry-run on the ``meta`` device: every (arch x shape)
step at full size, with no allocation and no card.

This entry point is the port's one exception to "run on the card": like
the reference's dry-run, which lowers on fake host devices and allocates
nothing, it builds each case's arguments as ``meta`` tensors (shapes
and dtypes, no storage) and runs the whole step on them, the port's
counterpart of lowering. It never falls back to the CPU for data.

Per case, records:
  * whether the step runs at these shapes, and that its outputs have the
    shapes and dtypes of the arguments the reference donates (the new
    params and optimizer state of a train step, the caches of a prefill
    or decode step);
  * per-device argument bytes under the rules, each spec sanitised
    against the mesh as the reference's ``_shard_tree`` does (a dim the
    mesh axes do not divide stays whole);
  * the analytic roofline terms (``launch/analytic.py``) at H100 SXM
    constants;
  * the collective term: rank 0's block of the case's arguments run on
    ``meta`` under the same rules with a ``CountingMesh`` (the
    tensor-parallel path issues its collectives through
    ``launch/collectives.py``, which count the result bytes by kind and
    move nothing there, as ``hlo.py`` reads them off the compiled
    program), over NVLink's datasheet rate. Counted under the baseline
    rules for the prefill and decode steps of every decoder, MoE-TP and
    the SSM block across ranks among them, and for the train steps of the
    decoders without an SSM block (a train step's: its microbatches' TP
    collectives, forward, remat's recompute and backward, and the
    data-parallel reduction); every other case writes null with its
    reason (``collective_reason``).
    Peak bytes have no counterpart of XLA's memory analysis: null.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
Results land in experiments/dryrun_torch/*.json (one file per case).
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.launch import collectives
from repro_torch.launch.analytic import step_flops, step_hbm_bytes
from repro_torch.launch.mesh import CountingMesh, make_production_mesh
from repro_torch.launch.ranks import ARG_ROLES, rank_block
from repro_torch.launch.specs import build_case, decode_supported, train_plan
from repro_torch.models.partitioning import P, tp_rules

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

# Roofline constants of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
# limit, from its datasheet: dense bf16 tensor-core FLOP/s and HBM3
# bytes/s. Analytic: no card is used.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# NVLink of one H100 SXM from its datasheet: 900 GB/s a GPU (18 links,
# both directions together); the collective term is a rank's result
# bytes over it, as the reference's is over its link rate
NVLINK_BW = 900e9
PEAK_REASON = "no counterpart of XLA's memory analysis in the port"


def collective_reason(cfg, kind: str, rules) -> str | None:
    """Why the collective term of a case is not counted, or None where it
    is: under the baseline rules, the prefill, decode and train steps of
    every decoder (attention, MoE-TP and the SSM block across ranks,
    ``partitioning.TensorParallel``; in training their transposes and the
    data-parallel reduction), the paths whose collectives run across
    ranks on the meta device."""
    todo = "is not ported (ROADMAP.md Queue 1"
    if rules.rules.get("embed") is not None:
        what = "training" if kind == "train" else "gathers of the dense leaves"
        return f"the fsdp rules' ZeRO-3 {what} {todo} item 4.3)"
    if rules.rules.get("expert") is not None:
        return ("the expert-parallel rules' branch runs across live ranks "
                "only (launch/ranks.py): its counting on the meta device "
                f"{todo})")
    if rules.rules.get("kv_seq") is not None:
        return f"decode_kv='seq' under tensor parallelism {todo} item 4.2)"
    if cfg.encoder is not None:
        return (f"the encoder-decoder (whisper) under tensor parallelism "
                f"{todo} item 4.1)")
    return None


def rank_collectives(cfg, case, kind: str, rules, coords) -> dict:
    """Collective result bytes by kind of the rank at ``coords``: its
    block of the case's (meta) arguments, cut as ``launch/ranks.py`` cuts
    a rank's, through the case's step on ``meta``. ``case`` was built
    under ``rules``, whose mesh is a ``CountingMesh`` at ``coords``."""
    block = rank_block(cfg, ARG_ROLES[kind], case.in_specs, case.args,
                       rules, coords)
    collectives.reset()
    with torch.device("meta"):
        case.fn(*block)
    out = collectives.collective_bytes()
    collectives.reset()
    return out


def sanitize(spec, shape, sizes) -> P:
    """``spec`` padded to ``shape``'s rank, with any dim sharding whose
    mesh-axis product does not divide the dim dropped (e.g. vocab 50280
    or kv_heads 3 over 16 shards)."""
    spec = tuple(spec) if spec is not None else ()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = math.prod(sizes[a] for a in axes)
        out.append(entry if dim % total == 0 else None)
    return P(*out)


def spec_leaves(spec, arg) -> list:
    """(spec, tensor) pairs of an argument tree and its spec tree; a
    tensor without a spec is replicated, a None argument has none."""
    if arg is None:
        return []
    if isinstance(arg, torch.Tensor):
        return [(spec if spec is not None else P(), arg)]
    if isinstance(arg, dict):
        return [x for k in arg for x in spec_leaves(
            spec[k] if spec is not None else None, arg[k])]
    specs = spec if spec is not None else (None,) * len(arg)
    return [x for s, a in zip(specs, arg) for x in spec_leaves(s, a)]


def device_bytes(spec, arg, sizes) -> int:
    """Bytes of one device's shard of the argument tree ``arg``."""
    total = 0
    for s, t in spec_leaves(spec, arg):
        s = sanitize(s, t.shape, sizes)
        n = t.element_size()
        for dim, entry in zip(t.shape, s):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n
    return total


def signature(tree) -> list:
    """(shape, dtype) of every tensor of a tree, in order."""
    return [(tuple(t.shape), t.dtype) for _, t in spec_leaves(None, tree)]


def returned_state(kind: str, args, out):
    """[(what, output tree, donated argument tree)] that the step must
    return with the donated arguments' shapes and dtypes."""
    if kind == "train":
        return [("params", out[0], args[0]), ("opt_state", out[1], args[1])]
    if kind == "prefill":
        return [("caches", out[1], args[3])]
    return [("caches", out[1], args[2])]


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules_kw: dict = None, save: bool = True,
             label: str = "") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = decode_supported(cfg, shape)
    if skip:
        res = {"arch": arch, "shape": shape_name, "skipped": skip}
        if save:
            _save(res, arch, shape_name, multi_pod, label)
        return res

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    axis_sizes = mesh.axis_sizes
    rules_kw = dict(rules_kw or {})
    kv_dtype = None
    if rules_kw.pop("kv_fp8", False):
        kv_dtype = torch.float8_e4m3fn
    # the explicit expert-parallel branch runs across live ranks only
    # (launch/ranks.py): the rules carry no mesh, so MoE layers take the
    # expert-sharded SPMD mode
    rules = tp_rules(multi_pod=multi_pod, axis_sizes=axis_sizes, mesh=None,
                     **rules_kw)
    case = build_case(cfg, shape, rules, kv_dtype=kv_dtype)

    t0 = time.perf_counter()
    with torch.device("meta"):
        out = case.fn(*case.args)
    run_s = time.perf_counter() - t0
    for what, got, want in returned_state(shape.kind, case.args, out):
        if signature(got) != signature(want):
            raise AssertionError(
                f"{arch} x {shape_name}: the step's {what} differ from the "
                f"donated argument's shapes / dtypes")

    by_arg = [device_bytes(s, a, axis_sizes)
              for s, a in zip(case.in_specs, case.args)]

    reason = collective_reason(cfg, shape.kind, rules)
    coll = None
    if reason is None:
        coords = {a: 0 for a in mesh.axis_names}
        counting = tp_rules(multi_pod=multi_pod, axis_sizes=axis_sizes,
                            mesh=CountingMesh(mesh, coords), **rules_kw)
        coll = rank_collectives(
            cfg, build_case(cfg, shape, counting, kv_dtype=kv_dtype),
            shape.kind, counting, coords)

    n_micro = train_plan(rules, shape)[0] if shape.kind == "train" else 1
    a_flops = step_flops(cfg, shape)
    a_bytes = step_hbm_bytes(cfg, shape, n_chips, n_micro,
                             kv_elem_bytes=1 if kv_dtype is not None else 2)
    t_compute = a_flops / (n_chips * PEAK_FLOPS)
    t_memory = a_bytes / HBM_BW
    t_coll = None if coll is None else sum(coll.values()) / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}

    model_flops = 6.0 * cfg.active_param_count() * (
        shape.seq_len * shape.global_batch if shape.kind == "train" else 0)
    if shape.kind == "prefill":
        model_flops = 2.0 * cfg.active_param_count() * shape.seq_len * \
            shape.global_batch
    elif shape.kind == "decode":
        model_flops = 2.0 * cfg.active_param_count() * shape.global_batch

    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(mesh.shape),
        "n_chips": n_chips,
        "device": "meta",
        "run_s": run_s,
        "outputs_match_donated": True,
        "memory": {
            "argument_bytes": sum(by_arg),
            "argument_bytes_by_arg": by_arg,
            "peak_bytes": None,
            "peak_bytes_reason": PEAK_REASON,
        },
        "analytic_flops_global": a_flops,
        "analytic_hbm_bytes_per_device": a_bytes,
        "collective_bytes": coll,
        "collective_reason": reason,
        "constants": {"card": CARD, "peak_flops": PEAK_FLOPS,
                      "hbm_bytes_per_s": HBM_BW,
                      "nvlink_bytes_per_s": NVLINK_BW, "kind": "analytic"},
        "roofline": {
            "compute_s": t_compute,
            "memory_s": t_memory,
            "collective_s": t_coll,
            "bottleneck": max((k for k, v in terms.items()
                               if v is not None), key=terms.get),
        },
        "model_flops_global": model_flops,
        "useful_flops_ratio": (model_flops / a_flops if a_flops else 0.0),
        "rules": dict(rules_kw, **({"kv_fp8": True} if kv_dtype else {})),
    }
    if cfg.moe is not None:
        res["moe_branch"] = ("spmd" if rules_kw.get("expert_parallel")
                             else "tp")
    if save:
        _save(res, arch, shape_name, multi_pod, label)
    return res


def _save(res: dict, arch: str, shape: str, multi_pod: bool, label: str):
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    mesh_tag = "multipod" if multi_pod else "singlepod"
    suffix = f"_{label}" if label else ""
    f = RESULTS_DIR / f"{arch}_{shape}_{mesh_tag}{suffix}.json"
    f.write_text(json.dumps(res, indent=1))


def report(tag: str, res: dict) -> str:
    """The printed line of one case."""
    if "skipped" in res:
        return f"SKIP {tag}: {res['skipped']}"
    r = res["roofline"]
    coll = ("null" if r["collective_s"] is None else
            f"{r['collective_s'] * 1e3:.2f}ms "
            f"({sum(res['collective_bytes'].values()) / 2 ** 20:.1f}MiB)")
    return (f"OK   {tag}: run={res['run_s']:.1f}s "
            f"args={res['memory']['argument_bytes'] / 2 ** 30:.2f}GiB/dev "
            f"compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms coll={coll} "
            f"bound={r['bottleneck']}")


def main():
    ap = argparse.ArgumentParser(
        description="Dry-run every (arch x shape) step on the production "
        "meshes on the meta device: shapes and dtypes only, nothing "
        "allocated, no card needed. Per-device argument bytes and the "
        "analytic roofline terms at H100 SXM constants "
        f"({CARD}: {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
        f"{HBM_BW / 1e12:.2f} TB/s), and the collective term of the "
        f"decoders' prefill and decode steps and of their train steps "
        f"but the SSM block's under the baseline rules at NVLink's "
        f"{NVLINK_BW / 1e9:.0f} GB/s.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="expert axis over 'model'; MoE layers take the "
                    "expert-sharded SPMD mode (moe_branch 'spmd')")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--kv-fp8", action="store_true")
    ap.add_argument("--decode-kv", default="heads", choices=["heads", "seq"])
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    rules_kw = {}
    if args.expert_parallel:
        rules_kw["expert_parallel"] = True
    if args.fsdp:
        rules_kw["fsdp"] = True
    if args.kv_fp8:
        rules_kw["kv_fp8"] = True
    if args.decode_kv != "heads":
        rules_kw["decode_kv"] = args.decode_kv

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    res = run_case(arch, shape, multi_pod=mp,
                                   rules_kw=rules_kw, label=args.label)
                    print(report(tag, res), flush=True)
                except Exception as e:
                    failures.append(tag)
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} failures: {failures}")


if __name__ == "__main__":
    main()
