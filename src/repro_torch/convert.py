"""Parameter conversion from the reference package.

``from_numpy_params`` turns the reference's parameter tree, given as
numpy arrays (for example ``jax.tree.map(np.asarray, params)``), into
the port's dict of tensors. The two trees have the same structure, so
both packages then compute the same function. This module imports
neither ``jax`` nor ``repro``: the caller does the numpy hand-off.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec, param_structure
from repro_torch.runtime import resolve_device


def from_numpy_params(tree, cfg: ModelConfig, device="cuda",
                      dtype=torch.float32) -> Dict[str, Any]:
    """Numpy parameter tree -> the port's parameter dict on ``device``.
    Raises if the structure or any shape differs from ``param_structure``."""
    dev = resolve_device(device)

    def conv(spec, x, path):
        if isinstance(spec, ParamSpec):
            arr = np.asarray(x)
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(f"{path}: shape {arr.shape} != "
                                 f"{spec.shape}")
            return torch.as_tensor(np.array(arr, np.float32)).to(
                device=dev, dtype=dtype)
        if isinstance(spec, dict):
            if set(spec) != set(x):
                raise ValueError(f"{path}: keys {sorted(x)} != "
                                 f"{sorted(spec)}")
            return {k: conv(spec[k], x[k], f"{path}/{k}") for k in spec}
        if len(spec) != len(x):
            raise ValueError(f"{path}: {len(x)} entries != {len(spec)}")
        return [conv(s, v, f"{path}[{i}]")
                for i, (s, v) in enumerate(zip(spec, x))]

    return conv(param_structure(cfg), tree, "params")
