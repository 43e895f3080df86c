"""Multi-process bootstrap.

Two ways in:

* :func:`ensure_initialized`, for a process started by ``torchrun``: the
  rendezvous comes from torchrun's environment (``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). In a single process
  it is a no-op, so every launcher can call it unconditionally.
* :func:`init_process_group`, for a worker that the caller spawned itself
  (``launch/ranks.py``): rank, world size and the rendezvous (a
  ``file://`` store, so that concurrent groups never share a port) are
  passed in.

The backend is stated, never guessed: NCCL with one card a rank, or gloo
(on the CPU, or on CUDA tensors, which gloo stages through host memory,
where several ranks share one card). Nothing here picks the CPU on its
own: the device comes with the call.
"""
from __future__ import annotations

import os

BACKENDS = ("nccl", "gloo")
_initialized = False


def device_for(backend: str, device: str, rank: int):
    """The device rank ``rank`` computes on: the CPU when asked; under
    NCCL card ``rank`` (one card a rank); under gloo on CUDA card ``rank``
    modulo the cards present, so that ranks may share one card."""
    import torch
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if device == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL moves CUDA tensors only; use gloo on the "
                             "CPU")
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, and torch.cuda is not "
                           "available")
    n = torch.cuda.device_count()
    if backend == "nccl" and rank >= n:
        raise RuntimeError(f"NCCL rank {rank} needs card {rank}; {n} present")
    return torch.device("cuda", rank % n)


def init_process_group(backend: str, rank: int, world_size: int,
                       init_method: str, device: str = "cuda"):
    """Join rank ``rank`` of ``world_size`` over ``backend`` through
    ``init_method`` (``file://<path>`` or ``tcp://host:port``), first
    selecting this rank's card when the device is CUDA. Returns the
    rank's device."""
    import torch
    import torch.distributed as dist
    global _initialized
    dev = device_for(backend, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        # a context on the rank's card before any group exists, so that
        # DeviceMesh keeps this choice instead of guessing its own
        torch.zeros((), device=dev)
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    _initialized = True
    return dev


def ensure_initialized(backend: str = "nccl", device: str = "cuda") -> bool:
    """Initialise torch.distributed from torchrun's environment: rank
    ``RANK`` on card ``LOCAL_RANK`` over ``backend`` (NCCL unless told
    otherwise). Returns True if a multi-process runtime was set up."""
    global _initialized
    if _initialized:
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if device == "cuda":
        import torch
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    import torch.distributed as dist
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        world_size=world, rank=int(os.environ["RANK"]))
    _initialized = True
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_multi_pod() -> bool:
    return int(os.environ.get("REPRO_MULTI_POD", "1")) > 1
