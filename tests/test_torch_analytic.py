"""The port's analytic FLOP / HBM-byte model (``launch/analytic.py``)
against the reference's: for every config and every assigned input
shape, each function gives the reference's number exactly. Pure Python
on both sides, so the two must agree bit for bit."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import InputShape as JaxInputShape  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import analytic as JA  # noqa: E402
from repro_torch.configs import (ALL_ARCHS, SHAPES, InputShape,  # noqa: E402
                                 get_config)
from repro_torch.launch import analytic as A  # noqa: E402


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_analytic_equals_the_reference(arch, shape):
    cj, ct = jax_get_config(arch), get_config(arch)
    sj, st = JAX_SHAPES[shape], SHAPES[shape]
    assert dataclasses.astuple(st) == dataclasses.astuple(sj)
    assert A.forward_flops(ct, st) == JA.forward_flops(cj, sj)
    assert A.step_flops(ct, st) == JA.step_flops(cj, sj)
    for clamp in (False, True):
        for kv_bytes in (1, 2):
            assert A.cache_bytes(ct, st, clamp, kv_bytes) == \
                JA.cache_bytes(cj, sj, clamp, kv_bytes)
    for n_chips, micro, kv_bytes in ((1, 1, 2), (4, 1, 2), (8, 16, 1)):
        assert A.step_hbm_bytes(ct, st, n_chips, micro, kv_bytes) == \
            JA.step_hbm_bytes(cj, sj, n_chips, micro, kv_bytes)


def test_analytic_at_a_phase_shape():
    """The shapes the card's readings use (a phase's own lengths, and a
    reduced config) agree too, and the estimate is what its fields say."""
    for arch in ("glm4-9b", "llama3.2-1b"):
        cj = jax_get_config(arch).reduced()
        ct = get_config(arch).reduced()
        for kind in ("prefill", "decode"):
            st = InputShape("phase", 2048, 4, kind)
            sj = JaxInputShape("phase", 2048, 4, kind)
            assert A.step_flops(ct, st) == JA.step_flops(cj, sj) > 0
            assert A.step_hbm_bytes(ct, st, 1) == \
                JA.step_hbm_bytes(cj, sj, 1)
    est = A.Estimate(1.0, 2.0)
    assert (est.flops_global, est.hbm_bytes_per_device) == (1.0, 2.0)
