"""Serving launcher: real-compute EPD-disaggregated serving on the GPU.

  # random weights from a seed through the full E->P->D pipeline:
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llava-next-mistral-7b --requests 8

Runs the model at its full width and depth in bf16 by default
(``--reduced`` for the small CPU-test variant, ``--device cpu`` for the
plain PyTorch versions on the CPU). The reference's ``--simulate`` mode
and the fp8 KV option are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import argparse

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


def run_real(args):
    from repro_torch.configs import get_config
    from repro_torch.core.cluster import EPDCluster
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
                         kv_scheme=args.kv_scheme, device=device)
    mm_tokens = cfg.frontend.tokens_per_item if cfg.frontend else 0
    reqs = []
    for i in range(args.requests):
        mm = (f"image-{i % 3}".encode()
              if cfg.frontend is not None and i % 2 == 0 else None)
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
    ap.add_argument("--reduced", action="store_true",
                    help="the small same-family variant (cfg.reduced())")
    run_real(ap.parse_args())


if __name__ == "__main__":
    main()
