"""Training launcher: the reference's ``repro.launch.train`` on the port.

  # on the card (the flash kernel and its gradient kernel):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --full-size --steps 20 --batch 4 --seq 512
  # on the CPU (the plain PyTorch versions), the reduced config:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 50

Trains in f32 from random weights (seed 0) on ``synthetic_batches``, with
the reference's optimizer settings and lines of output. The reduced
config is the default, as in the reference; ``--full-size`` takes the
published one.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.params import count_params, init_params
from repro_torch.runtime import resolve_device
from repro_torch.training.data import synthetic_batches
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    print(f"arch={cfg.name} params={count_params(params):,}")

    opt = AdamW(lr=args.lr, warmup_steps=max(args.steps // 10, 1))
    step_fn = make_train_step(cfg, opt, remat=False)
    opt_state = opt.init(params)

    t0 = time.time()
    for i, batch in enumerate(synthetic_batches(
            cfg, args.batch, args.seq, args.steps,
            mm=cfg.frontend is not None and cfg.encoder is None,
            device=dev)):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={float(metrics['loss']):.4f} "
                  f"aux={float(metrics['aux']):.4f} "
                  f"({(time.time()-t0)/(i+1)*1e3:.0f} ms/step)")


if __name__ == "__main__":
    main()
