"""Where a serving step's time goes on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve [--layers N]

Builds llava-next-mistral-7b in bf16 (random weights, seed 0) and serves
the ``chip_smoke.py`` requests once on a dense ``EPDCluster`` to pay the
first-call costs. Then, on a fresh cluster, it times each ``submit``
(Encode + Prefill + insert of one request) and ``--steps`` decode steps
with the host clock after a ``torch.cuda.synchronize()``, and traces the
first (image) submit and the decode steps with ``torch.profiler``. It
prints, for each traced phase, the wall time, the device time summed over
kernels and its share of the wall time (the device-busy share), the
kernel launches, and the kernels that take the most device time. The
Chrome traces go to ``--out`` (default ``chiprun_out/``).
"""
from __future__ import annotations

import argparse
import dataclasses
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


def report(label: str, prof, wall_ms: float, n_steps: int = 1) -> None:
    """Print device-busy share and top kernels of one traced phase."""
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


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.cluster import EPDCluster
    from repro_torch.launch.serve import smoke_requests
    from repro_torch.models.params import init_params
    from repro_torch.runtime import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llava-next-mistral-7b")
    ap.add_argument("--layers", type=int, default=0,
                    help="decoder depth (0: the model's)")
    ap.add_argument("--max-len", type=int, default=3072)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    warm = EPDCluster(cfg, params, max_batch=4, max_len=args.max_len,
                      device=dev)
    for r in smoke_requests(cfg):
        warm.submit(r)
    warm.run_until_done()
    del warm

    cluster = EPDCluster(cfg, params, max_batch=4, max_len=args.max_len,
                         device=dev)
    submit_ms = []
    prof_p = None
    for i, r in enumerate(smoke_requests(cfg)):
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
    report("prefill (first submit, image request)", prof_p, submit_ms[0])
    report("decode steps", prof_d, sum(step_ms), len(step_ms))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof_p.export_chrome_trace(str(out / "trace_prefill.json"))
    prof_d.export_chrome_trace(str(out / "trace_decode.json"))


if __name__ == "__main__":
    main()
