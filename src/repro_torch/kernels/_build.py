"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/lib<name>.so`` at the
root of the checkout, and loaded with ``ctypes``. Nothing is compiled
when a module is imported: ``load(name)`` builds on first use, and
``build_all()`` starts one ``nvcc`` per source at once and waits for
all of them. A library is rebuilt when a source it includes is newer.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "paged_decode_attention", "ssd_scan", "ssd_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of the last build, per kernel
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def build_all(names: Sequence[str] = KERNELS) -> float:
    """Compile every stale library, one ``nvcc`` per source, all started
    together. Returns the wall seconds spent; raises on any failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = BUILD / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        build_log[n] = out
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, qpos, kpos, out, lse (or null), b, s, S, nq, nkv, hd, dtype,
    # causal, window, scale, stream
    "flash_attention": ("flash_attention_fwd",
                        [_P] * 7 + [_I] * 9 + [_F, _P]),
    # q, k, v, o, dout, lse, qpos, kpos, dq, dk, dv, delta, b, s, S, nq,
    # nkv, hd, dtype, causal, window, scale, stream
    "flash_attention_bwd": ("flash_attention_bwd",
                            [_P] * 12 + [_I] * 9 + [_F, _P]),
    # q, k, v, qpos, kpos, out, partials, counters, b, S, nq, nkv, hd,
    # dtype, kv dtype, window, split_len, nsplit, scale, stream
    "decode_attention": ("decode_attention_fwd",
                         [_P] * 8 + [_I] * 10 + [_F, _P]),
    # q, k_pool, v_pool, tbl, lens, out, partials, counters, b, page,
    # max_pages, nq, nkv, hd, dtype, kv dtype, window, split_len, nsplit,
    # scale, stream
    "paged_decode_attention": ("paged_decode_attention_fwd",
                               [_P] * 8 + [_I] * 11 + [_F, _P]),
    # x, dt, a, b, c, d_skip, init (or null), y, fin, states, dec, prev,
    # B, S, H, P, N, L, dtype, stream
    "ssd_scan": ("ssd_scan_fwd", [_P] * 12 + [_I] * 7 + [_P]),
    # x, dt, a, b, c, d_skip, prev, dy, dfinal (or null), dx, ddt, da, db,
    # dc, dd, dinit, dstates, gnext, dec, dcum, upart, ddpart, gs, B, S,
    # H, P, N, L, dtype, stream
    "ssd_scan_bwd": ("ssd_scan_bwd", [_P] * 23 + [_I] * 7 + [_P]),
}


def load(name: str):
    """The C entry point of kernel ``name``, building it if needed."""
    sym, argtypes = _SIGNATURES[name]
    return symbol(name, sym, argtypes, ctypes.c_int)


def symbol(name: str, sym: str, argtypes, restype):
    """Function ``sym`` of kernel ``name``'s library, building it if
    needed."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    fn = getattr(_libs[name], sym)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


# -- helpers shared by the wrappers ------------------------------------------

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
FP8 = torch.float8_e4m3fn
FP8_CODE = 2           # K/V storage of the decode pair only
HEAD_DIMS = (32, 64, 128)


def is_plain(*tensors) -> bool:
    """True when the call takes the plain PyTorch version: only for
    tensors that lie on the CPU, or all on the ``meta`` device (the
    dry-run, which computes shapes and no values). A CUDA tensor goes to
    the kernel."""
    devs = {t.device.type for t in tensors}
    if devs in ({"cpu"}, {"meta"}):
        return True
    if devs != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors must all lie on one CUDA device, all on "
                         f"the CPU or all on meta, got "
                         f"{sorted(map(str, devs))}")
    return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_operands(name: str, data: Sequence[torch.Tensor],
                   index: Sequence[torch.Tensor], hd: int,
                   fp8_kv: bool = False) -> int:
    """Dtype, contiguity and alignment checks; returns q's dtype code.
    ``data`` is (q, k, v). k and v share q's dtype or, where ``fp8_kv``
    (the decode pair), are both float8_e4m3fn; any other pairing (q f32
    with bf16 K/V, say) raises."""
    dt = data[0].dtype
    require(dt in DTYPE_CODES,
            f"{name}: dtype {dt} not supported (float32, bfloat16)")
    kv = {t.dtype for t in data[1:]}
    require(kv == {dt} or (fp8_kv and kv == {FP8}),
            f"{name}: q/k/v dtypes {[t.dtype for t in data]} not supported "
            f"(k and v in q's dtype"
            + (" or both float8_e4m3fn)" if fp8_kv else ")"))
    require(all(t.dtype == torch.int32 for t in index),
            f"{name}: index/position tensors must be int32")
    require(all(t.is_contiguous() for t in (*data, *index)),
            f"{name}: every operand must be contiguous")
    require(all(t.data_ptr() % 16 == 0 for t in data),
            f"{name}: q/k/v must be 16-byte aligned")
    require(hd in HEAD_DIMS, f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    return DTYPE_CODES[dt]


def kv_code(k: torch.Tensor) -> int:
    """The C interface's code of a K/V storage dtype (checked first by
    ``check_operands``)."""
    return FP8_CODE if k.dtype == FP8 else DTYPE_CODES[k.dtype]


def check_window(window) -> int:
    """The C interface's window: 0 for none, else a positive length."""
    if window is None:
        return 0
    require(int(window) > 0, f"window must be positive, got {window}")
    return int(window)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need the gradient of a kernel that has
    none: its output would carry no gradient at all."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel on the card yet, so its inputs "
            f"cannot take a gradient there; run under torch.no_grad(), or "
            f"train on the CPU")


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name`` with ``args`` followed by ``device``'s current
    stream, raising on a non-zero CUDA error code."""
    err = load(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err < 0:
        raise RuntimeError(f"{name}: a TMA tensor map did not encode "
                           f"(CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
