"""Checkpointing: save/restore params + optimizer state + step metadata.

Same on-disk format as ``repro/training/checkpoint.py``: ``params.npz``,
``opt_mu.npz`` and ``opt_nu.npz`` with one ``leaf_{i}`` array per leaf
in ``jax.tree.flatten``'s order (``params.flatten``: dict keys sorted),
and ``manifest.json`` with the same config fingerprint; the last
``keep`` steps are kept. A checkpoint either package writes restores
into the other with every leaf bitwise equal. A bf16 leaf is stored as
numpy stores JAX's bfloat16, as its raw 2-byte values (``|V2``).
"""
from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import flatten, unflatten
from repro_torch.training.optimizer import AdamWState

_MANIFEST = "manifest.json"


def _fingerprint(cfg: ModelConfig) -> str:
    key = (f"{cfg.name}|{cfg.n_layers}|{cfg.d_model}|{cfg.n_heads}|"
           f"{cfg.n_kv_heads}|{cfg.d_ff}|{cfg.vocab}")
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:    # bf16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save_checkpoint(ckpt_dir, cfg: ModelConfig, params, opt_state=None,
                    step: int = 0, keep: int = 3) -> Path:
    """Write checkpoint step; returns its directory."""
    root = Path(ckpt_dir)
    out = root / f"step_{step:08d}"
    out.mkdir(parents=True, exist_ok=True)

    def dump(name, tree):
        np.savez(out / f"{name}.npz",
                 **{f"leaf_{i}": _to_numpy(x)
                    for i, x in enumerate(flatten(tree))})

    dump("params", params)
    manifest = {
        "step": step,
        "fingerprint": _fingerprint(cfg),
        "arch": cfg.name,
        "has_opt": opt_state is not None,
    }
    if opt_state is not None:
        dump("opt_mu", opt_state.mu)
        dump("opt_nu", opt_state.nu)
        manifest["opt_step"] = int(opt_state.step)
    (out / _MANIFEST).write_text(json.dumps(manifest))

    # retention
    steps = sorted(p for p in root.glob("step_*") if p.is_dir())
    for old in steps[:-keep]:
        shutil.rmtree(old)
    return out


def latest_step(ckpt_dir) -> Optional[int]:
    root = Path(ckpt_dir)
    best = None
    for p in root.glob("step_*"):
        m = re.match(r"step_(\d+)", p.name)
        if m:
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def restore_checkpoint(ckpt_dir, cfg: ModelConfig, params_like,
                       opt_state_like=None, step: Optional[int] = None):
    """Restore into the structure of ``params_like`` (shape checked; each
    leaf takes the dtype and device of its counterpart there).

    Returns (params, opt_state_or_None, step).
    """
    root = Path(ckpt_dir)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    src = root / f"step_{step:08d}"
    manifest = json.loads((src / _MANIFEST).read_text())
    if manifest["fingerprint"] != _fingerprint(cfg):
        raise ValueError(
            f"checkpoint is for arch {manifest['arch']!r}, not {cfg.name!r}")

    def load(name, like):
        flat = flatten(like)
        with np.load(src / f"{name}.npz") as z:
            new = []
            for i, ref in enumerate(flat):
                arr = z[f"leaf_{i}"]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"{name} leaf {i}: shape {arr.shape} != "
                        f"{tuple(ref.shape)}")
                new.append(_to_tensor(arr, ref))
        return unflatten(like, new)

    params = load("params", params_like)
    opt_state = None
    if opt_state_like is not None and manifest.get("has_opt"):
        opt_state = AdamWState(
            torch.tensor(manifest["opt_step"], dtype=torch.int32,
                         device=opt_state_like.step.device),
            load("opt_mu", opt_state_like.mu),
            load("opt_nu", opt_state_like.nu))
    return params, opt_state, step
