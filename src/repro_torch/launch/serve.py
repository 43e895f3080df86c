"""Serving launcher: real-compute EPD-disaggregated serving on the GPU,
or the paper-scale event simulator for any deployment topology.

  # random weights from a seed through the full E->P->D pipeline:
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llava-next-mistral-7b --requests 8
  # the attention-free SSM: text only, so P->D through ssd_scan
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch mamba2-370m --max-len 2048
  # the encoder-decoder: audio payloads, raw frames through the MM Store
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-base --max-len 448
  # K/V stored in float8_e4m3fn (the reference's --kv-fp8)
  PYTHONPATH=src python -m repro_torch.launch.serve --kv-fp8
  # paper-scale simulation of a deployment at a given request rate
  # (pure Python, no device; the same metrics as the reference's):
  PYTHONPATH=src python -m repro_torch.launch.serve --simulate \\
      --deployment "(E-P)-D" --rate 8 --arch openpangu-7b-vl

Runs the model at its full width and depth in bf16 by default
(``--reduced`` for the small CPU-test variant, ``--device cpu`` for the
plain PyTorch versions on the CPU); on the card the cluster's modelled
transfer charges use the ``H100`` cost profile.
"""
from __future__ import annotations

import argparse
import gc

import torch


def smoke_requests(cfg, image_tokens: int = 0):
    """The four requests ``chip_smoke.py`` serves: two sharing one image
    (prompts of 32 and 96 tokens, the image first), two text-only (64 and
    128 tokens), 16 new tokens each. ``image_tokens`` defaults to the
    config's tokens per image (2880 for llava-next-mistral-7b)."""
    from repro_torch.serving.request import Request
    n_img = image_tokens or (cfg.frontend.tokens_per_item
                             if cfg.frontend is not None else 0)
    img = b"chip-smoke: one anyres image"
    reqs = []
    for i, (n, has_img) in enumerate([(32, True), (96, True), (64, False),
                                      (128, False)]):
        prompt = [(13 * i + 7 * j + 1) % cfg.vocab for j in range(n)]
        reqs.append(Request(prompt_tokens=prompt, max_new_tokens=16,
                            mm_payload=img if has_img and n_img else None,
                            mm_tokens=n_img if has_img else 0, mm_pos=0))
    return reqs


def audio_requests(cfg):
    """The four requests ``chip_smoke.py`` serves an encoder-decoder
    (whisper-base): prompts of 4, 16, 32 and 64 tokens, each with an
    audio payload (the first two the same one, so the MM Store dedups),
    32 new tokens each. The payload's frames feed the encoder, not the
    prompt: mm_tokens 0, as in the reference's whisper requests."""
    from repro_torch.serving.request import Request
    payloads = [b"chip-smoke: audio A", b"chip-smoke: audio A",
                b"chip-smoke: audio B", b"chip-smoke: audio C"]
    return [Request(prompt_tokens=[(13 * i + 7 * j + 1) % cfg.vocab
                                   for j in range(n)], max_new_tokens=32,
                    mm_payload=payload, mm_tokens=0)
            for i, (n, payload) in enumerate(zip((4, 16, 32, 64), payloads))]


def with_kv_dtype(cluster, kv_dtype):
    """Rebuild ``cluster``'s prefill engine and its ``decode_engines`` with
    the K/V of every attention layer stored in ``kv_dtype`` (the
    reference's ``--kv-fp8``), each through ``cluster.make_engine``, so
    with the options, tracer, metrics and device the cluster gave it.
    Each old engine is dropped and collected before its replacement is
    built, so the two pools are never held at once. The reference's
    launcher assigns the read-only ``decode_engine`` property instead,
    which raises AttributeError."""
    def release():
        # dropped engines hold their CUDA graphs in reference cycles
        gc.collect()
        if cluster.device.type == "cuda":
            torch.cuda.empty_cache()

    cluster.prefill_engine = None
    release()
    cluster.prefill_engine = cluster.make_engine("prefill", 0,
                                                 kv_dtype=kv_dtype)
    for i in range(len(cluster.decode_engines)):
        cluster.decode_engines[i] = None
        release()
        cluster.decode_engines[i] = cluster.make_engine("decode", i,
                                                        kv_dtype=kv_dtype)
    return cluster


def run_real(args):
    from repro_torch.configs import get_config
    from repro_torch.core.cluster import EPDCluster
    from repro_torch.core.costmodel import H100, V5E
    from repro_torch.models.params import init_params
    from repro_torch.runtime import resolve_device
    from repro_torch.serving.request import Request

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device, dtype=dtype)
    cluster = EPDCluster(cfg, params, max_batch=4, max_len=args.max_len,
                         kv_scheme=args.kv_scheme, device=device,
                         hw=H100 if device.type == "cuda" else V5E)
    if args.kv_fp8:
        with_kv_dtype(cluster, torch.float8_e4m3fn)
    # an encoder-decoder's payload is its frames, not positions of the
    # prompt (mm_tokens 0, as the reference's launcher sets it), and every
    # request needs one: its decoder cross-attends to the encoder (the
    # reference's launcher sends every other request without one, which
    # its prefill cannot run)
    enc_dec = cfg.encoder is not None
    mm_tokens = (cfg.frontend.tokens_per_item
                 if cfg.frontend and not enc_dec else 0)
    reqs = []
    for i in range(args.requests):
        mm = (f"{'audio' if enc_dec else 'image'}-{i % 3}".encode()
              if cfg.frontend is not None and (i % 2 == 0 or enc_dec)
              else None)
        reqs.append(Request(
            prompt_tokens=list(range(2, 2 + 8 + i % 5)),
            max_new_tokens=args.max_new_tokens,
            mm_payload=mm, mm_tokens=mm_tokens if mm else 0))
    for r in reqs:
        cluster.submit(r)
    done = cluster.run_until_done()
    for r in done:
        path = "E-P-D" if r.is_multimodal else "P-D"
        print(f"req {r.request_id} [{path}] -> {r.output_tokens}")
    s = cluster.store.stats
    print(f"MM store: {s} | recomputes: {cluster.report.recomputes}")


def run_sim(args):
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import SHAREGPT_4O, VISUALWEB, simulate

    ds = SHAREGPT_4O if args.dataset == "sharegpt4o" else VISUALWEB
    model = get_config(args.arch)
    m = simulate(model, args.deployment, ds, rate=args.rate,
                 n_requests=args.requests, kv_scheme=args.kv_scheme,
                 per_chip_rate=args.per_chip_rate)
    print(f"deployment={m.deployment} chips={m.n_chips}")
    print(f"TTFT mean={m.mean_ttft_ms:.1f}ms p99={m.p99_ttft_ms:.1f}ms")
    print(f"TPOT mean={m.mean_tpot_ms:.2f}ms p99={m.p99_tpot_ms:.2f}ms")
    print(f"throughput={m.throughput_tok_s:.1f} tok/s; "
          f"SLO(2000/50)={m.slo_attainment(2000, 50)*100:.1f}%; "
          f"effective={m.effective_throughput(2000, 50):.1f} tok/s/chip")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llava-next-mistral-7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=3072)
    ap.add_argument("--kv-scheme", default="grouped",
                    choices=["one_shot", "layer_wise", "grouped"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-fp8", action="store_true",
                    help="store K/V in float8_e4m3fn (prefill and decode "
                         "engines)")
    ap.add_argument("--reduced", action="store_true",
                    help="the small same-family variant (cfg.reduced())")
    ap.add_argument("--simulate", action="store_true",
                    help="the event simulator instead of real compute")
    ap.add_argument("--deployment", default="E-P-D")
    ap.add_argument("--rate", type=float, default=6.0)
    ap.add_argument("--per-chip-rate", action="store_true")
    ap.add_argument("--dataset", default="sharegpt4o",
                    choices=["sharegpt4o", "visualweb"])
    args = ap.parse_args()
    if args.simulate:
        args.requests = max(args.requests, 256)
        run_sim(args)
    else:
        run_real(args)


if __name__ == "__main__":
    main()
