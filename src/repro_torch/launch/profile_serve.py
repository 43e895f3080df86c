"""Where a serving step's time goes on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--layers N]

Builds llava-next-mistral-7b (or ``--arch``, e.g. ``mamba2-370m
--max-len 2048``, or ``whisper-base``, whose ``--max-len`` defaults to
its 448-token decoder context) in bf16 (random weights, seed 0) and
serves the requests of ``launch/serve.py:smoke_requests`` (an
encoder-decoder: ``audio_requests``) once on a dense ``EPDCluster`` (on
the ``H100`` cost profile) to pay the first-call costs and capture the
CUDA graphs of its decode step and dense prefills (with another image or
audio payload, so that the second pass encodes its payload as a new
request does). Then, on the same
cluster, it times each ``submit`` (Encode + Prefill + insert of one
request) and ``--steps`` decode steps with the host clock after a
``torch.cuda.synchronize()``, and traces the first submit (an image
request where the model has a frontend) and the decode steps with
``torch.profiler``; both replay the graphs. It prints, for each traced
phase, the wall time, the device time summed over kernels and its share
of the wall time (the device-busy share), the kernel launches (a
replayed graph's kernel nodes among them), the kernels that take the
most device time, the graphs' census (``EPDCluster.graph_census``:
kernel nodes, those of each wrapper's kernels, captures and replays) and
the host time of the graph key a decode replay builds. Last, it serves
the requests once more with the graph steps run eagerly and traces the
first submit and two decode steps there, where the profiler can
attribute each kernel to the PyTorch op that launched it (a replay has
no ops): device time per op (``bmm`` is the MoE experts' products,
``sort``/``gather``/``scatter`` their dispatch).
The Chrome traces go to ``--out`` (default ``chiprun_out/``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import re
import statistics
import time
from pathlib import Path

import torch


def _device_us(e) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, name, None)
        if v is not None:
            return float(v)
    return 0.0


def wrapper_of_key(key: str):
    """The kernel wrapper whose device kernel a profiler row names (a
    demangled name), or None: ``ops.symbols`` with the length prefixes
    and template markers of the mangled parts taken off."""
    from repro_torch.kernels import ops
    for name, alts in ops.symbols().items():
        for parts in alts:
            fn, *rest = (re.sub(r"^\d+", "", p).rstrip("I") for p in parts)
            if (re.search(rf"(?<!\w){fn}<", key)
                    and all(r in key for r in rest)):
                return name
    return None


def report(label: str, prof, wall_ms: float, n_steps: int = 1) -> None:
    """Print device-busy share, top kernels and the hand-written kernels'
    device time of one traced phase."""
    rows = prof.key_averages()
    kernels = [e for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"{label}: wall {wall_ms:.3f} ms over {n_steps} call(s), device "
          f"{dev_ms:.3f} ms in {launches} kernel launches, device-busy "
          f"share {dev_ms / wall_ms:.3f}")
    if not kernels:
        print("  (the profiler recorded no device time)")
        return
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        print(f"  {_device_us(e) / 1e3 / n_steps:9.3f} ms/call "
              f"{e.count // n_steps:5d}x  {e.key[:90]}")
    ours: dict = {}
    for e in kernels:
        name = wrapper_of_key(e.key)
        if name is not None:
            ms, n = ours.get(name, (0.0, 0))
            ours[name] = (ms + _device_us(e) / 1e3, n + e.count)
    for name, (ms, n) in ours.items():
        print(f"  hand-written {name}: {ms / n_steps:.3f} ms/call in "
              f"{n // n_steps} launches a call")


def report_ops(label: str, prof, n_steps: int = 1, top: int = 16) -> None:
    """Print the device time of the kernels each PyTorch op launched
    itself (its children's excluded), per call, for the ops that launched
    any, and the kernels no op launched (the hand-written ones)."""
    rows = prof.key_averages()
    ops = [e for e in rows if e.device_type != torch.autograd.DeviceType.CUDA
           and _device_us(e) > 0]
    total = sum(_device_us(e) for e in ops) / 1e3 / n_steps
    print(f"{label} (eager), device time by the op that launched it: "
          f"{total:.3f} ms per call")
    for e in sorted(ops, key=_device_us, reverse=True)[:top]:
        print(f"  {_device_us(e) / 1e3 / n_steps:9.3f} ms/call "
              f"{e.count // n_steps:5d}x  {e.key[:90]}")


@contextlib.contextmanager
def eager_steps():
    """Within the block, graph steps run their function eagerly: no
    capture, no replay."""
    from repro_torch.serving.graphs import GraphStep
    real = GraphStep.__call__
    GraphStep.__call__ = lambda self, state, *inputs: self.fn(*state,
                                                               *inputs)
    try:
        yield
    finally:
        GraphStep.__call__ = real


def key_us(eng, n: int = 1000):
    """(median host microseconds over ``n`` calls, state tensors) of what
    a decode replay does before the replay itself: build the graph key
    over the parameters, the caches and the tokens
    (``graphs.graph_key``), check their device and read the state
    tensors' ``data_ptr``."""
    from repro_torch.kernels._build import is_plain
    from repro_torch.serving.graphs import graph_key

    tok = torch.zeros(eng.max_batch, dtype=torch.int32, device=eng.device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        _, st, it = graph_key((eng.params, eng.caches), (tok,))
        is_plain(*st, *it)
        tuple(t.data_ptr() for t in st)
        times.append(time.perf_counter() - t0)
    return 1e6 * statistics.median(times), len(st)


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.cluster import EPDCluster
    from repro_torch.core.costmodel import H100
    from repro_torch.launch.serve import audio_requests, smoke_requests
    from repro_torch.models.params import init_params
    from repro_torch.runtime import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llava-next-mistral-7b")
    ap.add_argument("--layers", type=int, default=0,
                    help="decoder depth (0: the model's)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="3072, or 448 (whisper's decoder context) for an "
                         "encoder-decoder")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.max_len is None:
        args.max_len = 448 if cfg.encoder is not None else 3072
    requests = audio_requests if cfg.encoder is not None else smoke_requests
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    cluster = EPDCluster(cfg, params, max_batch=4, max_len=args.max_len,
                         device=dev, hw=H100)
    for r in requests(cfg):
        if r.mm_payload is not None:
            r.mm_payload = b"profile_serve: the first pass's payload"
        cluster.submit(r)
    cluster.run_until_done()
    captured = cluster.graph_census()

    # the first trace of a process starts the profiler's device tracing,
    # which takes seconds: pay that here, not inside the traced submit
    with profile(activities=acts):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()

    submit_ms = []
    prof_p = None
    for i, r in enumerate(requests(cfg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with profile(activities=acts) as prof_p:
                cluster.submit(r)
                torch.cuda.synchronize()
        else:
            cluster.submit(r)
            torch.cuda.synchronize()
        submit_ms.append(1e3 * (time.perf_counter() - t0))
    eng = cluster.decode_engine
    step_ms = []
    with profile(activities=acts) as prof_d:
        for _ in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.decode_step()
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
    untraced = []
    for _ in range(args.steps):
        if not eng.n_active:
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.decode_step()
        torch.cuda.synchronize()
        untraced.append(1e3 * (time.perf_counter() - t0))

    smi = torch.cuda.get_device_name(0)
    print(f"{cfg.name}, {cfg.n_layers} layers, bf16, max_len "
          f"{args.max_len}, on {smi}")
    print(f"submit ms (E->P->D of one request, warm): "
          f"{[round(x, 3) for x in submit_ms]}")
    print(f"decode step ms (batch 4, traced): "
          f"{[round(x, 3) for x in step_ms]}")
    if untraced:
        print(f"decode step ms (untraced): "
              f"{[round(x, 3) for x in untraced]} (median "
              f"{statistics.median(untraced):.3f})")
    report("prefill (first submit)", prof_p, submit_ms[0])
    report("decode steps", prof_d, sum(step_ms), len(step_ms))
    census = cluster.graph_census()
    print(f"CUDA graphs: {census} (captures in the timed pass: "
          f"{census['captures'] - captured['captures']})")
    us, n_state = key_us(eng)
    print(f"graph key of a decode replay: {us:.2f} us host time (median), "
          f"over {n_state} state tensors")
    while eng.n_active:
        eng.decode_step()
    with eager_steps():
        for i, r in enumerate(requests(cfg)):
            if i == 0:
                with profile(activities=acts) as prof_pe:
                    cluster.submit(r)
                    torch.cuda.synchronize()
            else:
                cluster.submit(r)
        eng.decode_step()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof_de:
            for _ in range(2):
                eng.decode_step()
            torch.cuda.synchronize()
    report_ops("prefill (first submit)", prof_pe)
    report_ops("decode steps", prof_de, 2)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof_p.export_chrome_trace(str(out / "trace_prefill.json"))
    prof_d.export_chrome_trace(str(out / "trace_decode.json"))


if __name__ == "__main__":
    main()
