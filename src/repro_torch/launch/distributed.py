"""Multi-process bootstrap.

Each process started by ``torchrun`` calls :func:`ensure_initialized`
before it touches a card; the rendezvous comes from torchrun's
environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``). In a single process it is a no-op, so every launcher
can call it unconditionally.
"""
from __future__ import annotations

import os

_initialized = False


def ensure_initialized() -> bool:
    """Initialise torch.distributed (NCCL) from torchrun's environment
    and select the card ``LOCAL_RANK``. Returns True if a multi-process
    runtime was set up."""
    global _initialized
    if _initialized:
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "nccl",
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        world_size=world, rank=int(os.environ["RANK"]))
    _initialized = True
    return True


def is_multi_pod() -> bool:
    return int(os.environ.get("REPRO_MULTI_POD", "1")) > 1
