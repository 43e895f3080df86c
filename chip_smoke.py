#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # all phases, as a user would run them

Phases (every failure raises and ends the run with a non-zero code):
  1. device: name and power limit, build the CUDA kernels (timed);
  2. kernels: each hand-written kernel against its plain PyTorch version
     at the serving path's shapes (bf16 and f32, padding, ragged lengths,
     a window), with its time, its plain version's time, a PyTorch call
     that computes the same function (a yardstick only) and its bound;
  3. model parity: llava-next-mistral-7b at full width and 2 layers in
     f32, a 2880-token image prefill plus 4 teacher-forced decode steps on
     the CPU (plain versions) and on the GPU (kernels), dense and paged;
  4. serve, dense: EPDCluster at full width and depth in bf16, 4 requests
     (two sharing one image) through submit + run_until_done;
  5. serve, paged: the same requests through run_continuous on a paged
     cluster with prefix cache and chunked prefill;
  6. numbers: wall-clock TTFT, TPOT and tokens/s of phases 4-5.
The kernel launch counters are set to 0 just before each serving phase
and read just after it. The last lines are a JSON object per kernel, the
card's name and power limit, and {"ok": true, "device": {...}}.

``--phases`` runs a subset (``--phases 1,2``: build and kernel checks).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12       # H100 SXM HBM3 bytes/s
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),   # 8-bit mantissa out
       "float32": dict(atol=1e-4, rtol=1e-4)}    # summation order only
PARITY_TOL = dict(atol=1e-3, rtol=1e-3)          # f32 logits, CPU vs GPU
KERNEL_INFO = {
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:70"),
    "decode_attention": dict(
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:69"),
    "paged_decode_attention": dict(
        source="src/repro_torch/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention/kernel.py:81"),
}
MAX_LEN = 3072
IMAGE_TOKENS = 2880


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, n: int = 25, warmup: int = 3) -> float:
    """Median of ``n`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _sdpa(torch, q, k, v, mask):
    """One PyTorch call computing the same attention: q (b, h, s, d),
    k/v (b, hk, S, d), boolean mask broadcastable to (b, h, s, S)."""
    F = torch.nn.functional
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    except TypeError:                      # torch without enable_gqa
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            attn_mask=mask)


def check_kernels(torch, dev):
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_decode_attention.kernel import (
        paged_decode_attention)
    from repro_torch.kernels.paged_decode_attention.ref import (
        paged_decode_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(1234)
    nq, nkv, hd = 32, 8, 128
    lens = [2960, 3000, 100, 64]          # two VLM prompts, two text ones
    results = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(name, label, dtype, out, ref):
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), **TOL[dtype])
        log(f"  {name} [{label}] {dtype}: max_abs_err={err:.3e} "
            f"tol={TOL[dtype]} {'ok' if ok else 'FAIL'}")
        assert ok and torch.isfinite(out.float()).all(), (name, label, err)
        return err

    # -- flash: engine prefill (pad to max_len), suffix chunk, window, cross
    def flash_case(dtype, s, S, n_valid, q_off=0, pfx=None, window=None,
                   causal=True, heads=(nq, nkv), dim=hd):
        b = 1
        dt = getattr(torch, dtype)
        h, hk = heads
        q = randn((b, s, h, dim), dt)
        k = randn((b, S, hk, dim), dt)
        v = randn((b, S, hk, dim), dt)
        qi = torch.arange(s, dtype=torch.int32, device=dev)
        qpos = torch.where(qi < n_valid, qi + q_off,
                           torch.full_like(qi, -1)).repeat(b, 1)
        if pfx is None:
            kpos = qpos.clone() if S == s else torch.arange(
                S, dtype=torch.int32, device=dev).repeat(b, 1)
        else:      # suffix prefill: gathered prefix row + in-batch suffix
            span = torch.arange(S - s, dtype=torch.int32, device=dev)
            kpos = torch.cat([torch.where(span < pfx, span,
                                          torch.full_like(span, -1)),
                              qpos[0]]).repeat(b, 1)
        return q, k, v, qpos.contiguous(), kpos.contiguous(), window, causal

    flash_cases = [
        ("prefill 3072, 2960 valid", "bfloat16",
         dict(s=MAX_LEN, S=MAX_LEN, n_valid=2960)),
        ("prefill 3072, 2960 valid", "float32",
         dict(s=MAX_LEN, S=MAX_LEN, n_valid=2960)),
        ("chunk 512 over 3072+512, prefix 1024", "bfloat16",
         dict(s=512, S=MAX_LEN + 512, n_valid=512, q_off=1024, pfx=1024)),
        ("prefill 1024, window 256", "bfloat16",
         dict(s=1024, S=1024, n_valid=1000, window=256)),
        ("cross 50x70", "float32",
         dict(s=50, S=70, n_valid=47, causal=False, heads=(4, 2), dim=64)),
    ]
    errs = []
    for label, dtype, kw in flash_cases:
        q, k, v, qp, kp, win, causal = flash_case(dtype, **kw)
        out = flash_attention(q, k, v, qp, kp, window=win, causal=causal)
        ref = attention_ref(q, k, v, qp, kp, window=win, causal=causal)
        err = compare("flash_attention", label, dtype, out, ref)
        if dtype == "bfloat16":
            errs.append(err)
    q, k, v, qp, kp, win, causal = flash_case("bfloat16", **flash_cases[0][2])
    valid = ((kp[:, None, :] >= 0) & (qp[:, :, None] >= 0)
             & (kp[:, None, :] <= qp[:, :, None]))
    n_pairs = int(valid.sum().item())
    flops = 4 * hd * nq * n_pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * (
        qp.numel() + kp.numel())
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = valid[:, None]
    results["flash_attention"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: flash_attention(q, k, v, qp, kp)),
        plain_ms=time_ms(torch, lambda: attention_ref(q, k, v, qp, kp),
                         n=20),
        library_ms=time_ms(torch, lambda: _sdpa(torch, qt, kt, vt, mask)),
        bound_ms=1e3 * max(flops / PEAK_BF16, nbytes / HBM_BPS),
        bound_by="operations" if flops / PEAK_BF16 > nbytes / HBM_BPS
        else "bytes",
        shape=f"b1 s=S={MAX_LEN} nq{nq} nkv{nkv} hd{hd} bf16, "
              f"{n_pairs} valid pairs")

    # -- dense decode: 4 slots of a 3072 ring buffer, ragged lengths
    def decode_case(dtype, lengths, window=None):
        dt = getattr(torch, dtype)
        b = len(lengths)
        q = randn((b, nq, hd), dt)
        k = randn((b, MAX_LEN, nkv, hd), dt)
        v = randn((b, MAX_LEN, nkv, hd), dt)
        t = torch.arange(MAX_LEN, dtype=torch.int32, device=dev)[None]
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kpos = torch.where(t < ln[:, None], t, torch.full_like(t, -1))
        return q, k, v, (ln - 1).contiguous(), kpos.contiguous(), window

    errs = []
    for label, dtype, lengths, win in [
            ("b4 S3072 ragged", "bfloat16", lens, None),
            ("b4 S3072 ragged", "float32", lens, None),
            ("b4 S3072 window 512", "bfloat16", lens, 512),
            ("b4 S3072 full + 1", "bfloat16", [MAX_LEN, 1, 17, 2049], None)]:
        q, k, v, qp, kp, w = decode_case(dtype, lengths, win)
        err = compare("decode_attention", label, dtype,
                      decode_attention(q, k, v, qp, kp, window=w),
                      decode_attention_ref(q, k, v, qp, kp, window=w))
        if dtype == "bfloat16":
            errs.append(err)
    q, k, v, qp, kp, _ = decode_case("bfloat16", lens)
    n_tok = sum(lens)
    flops = 4 * hd * nq * n_tok
    nbytes = (2 * n_tok * nkv * hd * 2 + 2 * 2 * q.numel()
              + 4 * (kp.numel() + qp.numel()))
    qt = q[:, :, None]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = (kp >= 0)[:, None, None]
    results["decode_attention"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: decode_attention(q, k, v, qp, kp)),
        plain_ms=time_ms(torch, lambda: decode_attention_ref(q, k, v, qp,
                                                             kp)),
        library_ms=time_ms(torch, lambda: _sdpa(torch, qt, kt, vt, mask)),
        bound_ms=1e3 * max(flops / PEAK_BF16, nbytes / HBM_BPS),
        bound_by="operations" if flops / PEAK_BF16 > nbytes / HBM_BPS
        else "bytes",
        shape=f"b4 S{MAX_LEN} nq{nq} nkv{nkv} hd{hd} bf16, lengths {lens}")

    # -- paged decode: page 16, 192 pages a slot, scattered pages
    page, max_pages = 16, MAX_LEN // 16

    def paged_case(dtype, lengths, window=None):
        dt = getattr(torch, dtype)
        b = len(lengths)
        n_pages = 1 + b * max_pages
        q = randn((b, nq, hd), dt)
        kp_ = randn((n_pages, page, nkv, hd), dt)
        vp_ = randn((n_pages, page, nkv, hd), dt)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        tbl = torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
        off = 0
        for i, n in enumerate(lengths):
            used = max(1, -(-n // page))
            tbl[i, :used] = perm[off:off + used].to(torch.int32)
            off += used
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return q, kp_, vp_, tbl, ln, window

    errs = []
    for label, dtype, lengths, win in [
            ("b4 page16 ragged", "bfloat16", lens, None),
            ("b4 page16 ragged", "float32", lens, None),
            ("b4 page16 window 300", "bfloat16", lens, 300),
            ("b4 page boundaries", "float32", [16, 32, MAX_LEN, 1], None)]:
        args = paged_case(dtype, lengths, win)
        err = compare("paged_decode_attention", label, dtype,
                      paged_decode_attention(*args[:5], window=args[5]),
                      paged_decode_attention_ref(*args[:5], window=args[5]))
        if dtype == "bfloat16":
            errs.append(err)
    q, kpool, vpool, tbl, ln, _ = paged_case("bfloat16", lens)
    n_pg = sum(-(-n // page) for n in lens)
    nbytes = (2 * n_tok * nkv * hd * 2 + 2 * 2 * q.numel()
              + 4 * (n_pg + ln.numel()))
    flops = 4 * hd * nq * n_tok
    # yardstick: SDPA over the same KV laid out densely beforehand (no
    # single PyTorch call reads a paged pool; the gather is not timed)
    kd = kpool[tbl.long()].reshape(len(lens), -1, nkv, hd).transpose(1, 2)
    vd = vpool[tbl.long()].reshape(len(lens), -1, nkv, hd).transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    t = torch.arange(kd.shape[2], device=dev)[None]
    mask = (t < ln[:, None])[:, None, None]
    qt = q[:, :, None]
    results["paged_decode_attention"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: paged_decode_attention(q, kpool, vpool,
                                                         tbl, ln)),
        plain_ms=time_ms(torch, lambda: paged_decode_attention_ref(
            q, kpool, vpool, tbl, ln)),
        library_ms=time_ms(torch, lambda: _sdpa(torch, qt, kd, vd, mask)),
        bound_ms=1e3 * max(flops / PEAK_BF16, nbytes / HBM_BPS),
        bound_by="operations" if flops / PEAK_BF16 > nbytes / HBM_BPS
        else "bytes",
        shape=f"b4 page{page} max_pages{max_pages} nq{nq} nkv{nkv} hd{hd} "
              f"bf16, lengths {lens}")
    for name, r in results.items():
        log(f"  {name}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) at {r['shape']}")
    return results


# ---------------------------------------------------------------------------
# phase 3: model parity, CPU plain versions vs GPU kernels
# ---------------------------------------------------------------------------

def model_parity(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import frontend as FE
    from repro_torch.models.model import decode_forward, prefill_forward
    from repro_torch.models.params import init_params, map_tree
    from repro_torch.models.transformer import make_caches

    base = get_config("llava-next-mistral-7b")
    cfg = dataclasses.replace(base, n_layers=2, name=base.name + "-2layer")
    params_cpu = init_params(cfg, torch.Generator().manual_seed(7),
                             device="cpu", dtype=torch.float32)
    params_gpu = map_tree(lambda t: t.to(dev), params_cpu)
    mm_pos, n_text = 8, 40
    n = n_text + IMAGE_TOKENS
    text = [(7 * i + 3) % cfg.vocab for i in range(n_text)]
    toks = torch.zeros((1, MAX_LEN), dtype=torch.int32)
    toks[0, :mm_pos] = torch.tensor(text[:mm_pos])
    toks[0, mm_pos + IMAGE_TOKENS:n] = torch.tensor(text[mm_pos:])
    patches = FE.stub_embeddings(cfg, b"chip-smoke-image", IMAGE_TOKENS)
    forced = [5, 17, 42, 99]

    def run(params, device, layout):
        feats = (patches.to(device) @ params["projector"]).float()[None]
        kw = {}
        if layout == "paged":
            kw = dict(layout="paged", page_size=16, n_pages=1 + MAX_LEN // 16)
        caches = make_caches(cfg, 1, MAX_LEN, dtype=torch.float32,
                             device=device, **kw)
        if layout == "paged":
            caches["pages"][0] = torch.arange(1, 1 + MAX_LEN // 16,
                                              dtype=torch.int32)
        logits, caches = prefill_forward(
            params, cfg, toks.to(device), caches,
            lengths=torch.tensor([n], dtype=torch.int32, device=device),
            mm_feats=feats, mm_start=mm_pos)
        out = [logits.cpu()]
        for t in forced:
            logits, caches = decode_forward(
                params, cfg, torch.tensor([t], dtype=torch.int32,
                                          device=device), caches)
            out.append(logits.cpu())
        return out

    for layout in ("dense", "paged"):
        t0 = time.perf_counter()
        ref = run(params_cpu, "cpu", layout)
        t1 = time.perf_counter()
        got = run(params_gpu, dev, layout)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, ref)):
            err = (a - b).abs().max().item()
            ok = torch.allclose(a, b, **PARITY_TOL)
            log(f"  {layout} step {i}: logits max_abs_err={err:.3e} "
                f"tol={PARITY_TOL} {'ok' if ok else 'FAIL'}")
            assert ok and torch.isfinite(a).all(), (layout, i, err)
        log(f"  {layout}: cpu {t1 - t0:.1f} s, gpu "
            f"{time.perf_counter() - t1:.1f} s")
    del params_gpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4-5: serving at full width
# ---------------------------------------------------------------------------

def instrument(torch, engine):
    """Stamp wall-clock first-token and done times on the decode engine's
    requests (both drivers insert and decode through these methods)."""
    insert, decode_step = engine.insert, engine.decode_step

    def timed_insert(req, *a, **kw):
        slot = insert(req, *a, **kw)
        torch.cuda.synchronize()
        req.t_first_token = time.perf_counter()
        return slot

    def timed_decode_step():
        out = decode_step()
        now = time.perf_counter()    # decode_step synced to read tokens
        for r, _t, done in out:
            if done:
                r.t_done = now
        return out

    engine.insert, engine.decode_step = timed_insert, timed_decode_step


def serve(torch, dev, cfg, params, mode):
    from repro_torch.core.cluster import EPDCluster
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import smoke_requests

    kw = {}
    if mode == "paged":
        kw = dict(paged=True, page_size=16, prefix_cache=True,
                  chunked_prefill=True, prefill_chunk=512)
    cluster = EPDCluster(cfg, params, max_batch=4, max_len=MAX_LEN,
                         device=dev, **kw)
    for eng in cluster.decode_engines:
        instrument(torch, eng)
    reqs = smoke_requests(cfg, IMAGE_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        r.t_arrival = t0
    if mode == "dense":
        for r in reqs:
            cluster.submit(r)
        done = cluster.run_until_done()
    else:
        done = cluster.run_continuous(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    assert len(done) == len(reqs) and not cluster.report.lost, \
        f"{mode}: {len(done)}/{len(reqs)} completed"
    for r in reqs:
        assert len(r.output_tokens) == r.max_new_tokens, r.output_tokens
        assert all(0 <= t < cfg.vocab for t in r.output_tokens)
    if mode == "paged":
        for eng in [cluster.prefill_engine, *cluster.decode_engines]:
            eng.assert_no_page_leaks()
        assert cluster.decode_engine.pool.n_used == 0
        assert cluster.store.stats.hits >= 1, cluster.store.stats
    n_out = sum(len(r.output_tokens) for r in reqs)
    stats = dict(
        ttft_ms=[1e3 * r.ttft for r in reqs],
        tpot_ms=[1e3 * r.tpot for r in reqs],
        tokens_per_s=n_out / wall, wall_s=wall, n_out=n_out,
        counts=counts, outputs=[list(r.output_tokens) for r in reqs])
    log(f"  {mode}: {len(done)}/{len(reqs)} completed in {wall:.2f} s; "
        f"launches {counts}; MM store {cluster.store.stats}")
    for r in reqs:
        log(f"    req {r.request_id} ({len(r.prompt_tokens)} text + "
            f"{r.mm_tokens} image tokens) -> {r.output_tokens}")
    del cluster
    torch.cuda.empty_cache()
    return stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",") if p}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.params import count_params, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. device ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")
    build_s = _build.build_all()
    log(f"[1] kernels built in {build_s:.1f} s")
    for kname, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {kname}: {line.strip()}")

    kernels = {}
    if 2 in phases:
        log("[2] kernels vs plain versions at the serving shapes")
        kernels = check_kernels(torch, dev)
    if 3 in phases:
        log("[3] model parity, llava-next-mistral-7b full width, 2 layers, "
            "f32, CPU plain vs GPU kernels")
        model_parity(torch, dev)

    serve_stats = {}
    if phases & {4, 5}:
        cfg = get_config("llava-next-mistral-7b")
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[4] {cfg.name}: {count_params(params) / 1e9:.3f} B params in "
            f"bf16 ({cfg.n_layers} layers), made in "
            f"{time.perf_counter() - t0:.1f} s")
        if 4 in phases:
            log("[4] serve, dense: submit + run_until_done")
            serve_stats["dense"] = serve(torch, dev, cfg, params, "dense")
            c = serve_stats["dense"]["counts"]
            assert c["flash_attention"] > 0 and c["decode_attention"] > 0, c
        if 5 in phases:
            log(f"[5] serve, paged (prefix cache, chunked prefill 512): "
                f"run_continuous, {cfg.n_layers} layers")
            serve_stats["paged"] = serve(torch, dev, cfg, params, "paged")
            c = serve_stats["paged"]["counts"]
            assert c["paged_decode_attention"] > 0 and \
                c["flash_attention"] > 0, c
        if "dense" in serve_stats and "paged" in serve_stats:
            same = (serve_stats["dense"]["outputs"]
                    == serve_stats["paged"]["outputs"])
            log(f"[5] dense and paged greedy outputs identical: {same} "
                f"(bf16; not required)")

    # -- 6. numbers ------------------------------------------------------------
    for mode, st in serve_stats.items():
        log(f"[6] {mode} on {smi}: TTFT ms {[round(x, 2) for x in st['ttft_ms']]} "
            f"(mean {statistics.mean(st['ttft_ms']):.2f}); TPOT ms "
            f"{[round(x, 3) for x in st['tpot_ms']]} (mean "
            f"{statistics.mean(st['tpot_ms']):.3f}); "
            f"{st['tokens_per_s']:.2f} output tokens/s over {st['wall_s']:.2f} s")
    log(f"[6] total {time.perf_counter() - t_start:.1f} s")

    rows = []
    for kname in KERNEL_INFO:
        r = kernels.get(kname, {})
        launches = sum(st["counts"][kname] for st in serve_stats.values())
        rows.append(dict(
            name=kname, route="cuda", **KERNEL_INFO[kname],
            launches=launches, max_abs_err=r.get("max_abs_err"),
            ms=r.get("ms"), plain_ms=r.get("plain_ms"),
            bound_ms=r.get("bound_ms"), bound_by=r.get("bound_by"),
            library_ms=r.get("library_ms")))
    if phases >= {2, 4, 5}:
        for row in rows:
            assert row["launches"] > 0, row
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
