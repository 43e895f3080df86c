"""Checkpoints in the port: ``tests/test_checkpoint.py`` ported, and the
file-level parity with the reference: a checkpoint either package writes
restores into the other with every leaf bitwise equal (the leaves are
numbered in ``jax.tree.flatten``'s order, dict keys sorted, on both
sides)."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_numpy_params  # noqa: E402
from repro_torch.models.params import (flatten, init_params, leaves,  # noqa: E402
                                       map_tree)
from repro_torch.training.checkpoint import (latest_step,  # noqa: E402
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import synthetic_batches  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train import make_train_step  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW(lr=1e-3, warmup_steps=1)
    return cfg, params, opt


def _stepped(cfg, params, opt):
    """Params and a state after one step, so the moments are not zero."""
    batch = next(synthetic_batches(cfg, 2, 16, 1, seed=1, device="cpu"))
    p, s, _ = make_train_step(cfg, opt, remat=False)(params, opt.init(params),
                                                      batch)
    return p, s


def test_roundtrip_exact(tmp_path, setup):
    cfg, params, opt = setup
    params, state = _stepped(cfg, params, opt)
    save_checkpoint(tmp_path, cfg, params, state, step=7)
    p2, s2, step = restore_checkpoint(tmp_path, cfg, params, state)
    assert step == 7 and int(s2.step) == int(state.step)
    for a, b in zip(leaves((params, state.mu, state.nu)),
                    leaves((p2, s2.mu, s2.nu))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_training_resumes_identically(tmp_path, setup):
    """train 2 steps == train 1, checkpoint, restore, train 1."""
    cfg, params, opt = setup
    step_fn = make_train_step(cfg, opt, remat=False)
    batches = list(synthetic_batches(cfg, 4, 16, 2, seed=9, device="cpu"))

    pA, sA = params, opt.init(params)
    for b in batches:
        pA, sA, _ = step_fn(pA, sA, b)

    pB, sB = params, opt.init(params)
    pB, sB, _ = step_fn(pB, sB, batches[0])
    save_checkpoint(tmp_path, cfg, pB, sB, step=1)
    pB, sB, _ = restore_checkpoint(tmp_path, cfg, pB, sB)
    pB, sB, _ = step_fn(pB, sB, batches[1])

    # the round trip is bitwise, so the resumed step is the same step
    for a, b in zip(leaves(pA), leaves(pB)):
        assert torch.equal(a, b)


def test_retention(tmp_path, setup):
    cfg, params, opt = setup
    for s in range(5):
        save_checkpoint(tmp_path, cfg, params, None, step=s, keep=2)
    assert latest_step(tmp_path) == 4
    kept = sorted(p.name for p in pathlib.Path(tmp_path).glob("step_*"))
    assert kept == ["step_00000003", "step_00000004"]


def test_wrong_arch_rejected(tmp_path, setup):
    cfg, params, opt = setup
    save_checkpoint(tmp_path, cfg, params, None, step=0)
    other = get_config("llama3.2-1b").reduced()
    with pytest.raises(ValueError, match="arch"):
        restore_checkpoint(tmp_path, other, params)


def test_bf16_roundtrip_exact(tmp_path, setup):
    """bf16 leaves are stored as numpy stores JAX's bfloat16 (raw 2-byte
    values) and come back bitwise."""
    cfg, _, opt = setup
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu",
                         dtype=torch.bfloat16)
    save_checkpoint(tmp_path, cfg, params, opt.init(params), step=3)
    with np.load(tmp_path / "step_00000003" / "params.npz") as z:
        assert z["leaf_0"].dtype == np.dtype("V2")
    p2, _, _ = restore_checkpoint(tmp_path, cfg, params)
    for a, b in zip(leaves(params), leaves(p2)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)


def _reference_state(arch="whisper-base"):
    """The reference's params and a state with nonzero moments, and the
    port's configs."""
    jcfg = jax_get_config(arch).reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jax_opt.AdamW(lr=1e-3, warmup_steps=1)
    grads = jax.tree.map(lambda x: 0.01 * x + 0.001, jp)
    jp2, js = jopt.update(grads, jopt.init(jp), jp)
    return jcfg, jp2, js, get_config(arch).reduced()


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jcfg, jp, js, cfg = _reference_state()
    jax_ckpt.save_checkpoint(tmp_path, jcfg, jp, js, step=5)
    like = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    like_state = AdamW().init(like)
    p, s, step = restore_checkpoint(tmp_path, cfg, like, like_state)
    assert step == 5 and int(s.step) == int(js.step)
    for tree, ref in ((p, jp), (s.mu, js.mu), (s.nu, js.nu)):
        ref_leaves = jax.tree.leaves(ref)
        assert len(ref_leaves) == len(flatten(tree))
        for a, t in zip(ref_leaves, flatten(tree)):
            assert np.array_equal(t.numpy(), np.asarray(a))


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jcfg, jp, js, cfg = _reference_state()
    port = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    opt = AdamW(lr=1e-3, warmup_steps=1)
    grads = map_tree(lambda x: 0.01 * x + 0.001, port)
    port, state = opt.update(grads, opt.init(port), port)
    save_checkpoint(tmp_path, cfg, port, state, step=6)
    p, s, step = jax_ckpt.restore_checkpoint(tmp_path, jcfg, jp, js)
    assert step == 6 and int(s.step) == int(state.step)
    for tree, ref in ((port, p), (state.mu, s.mu), (state.nu, s.nu)):
        for a, t in zip(jax.tree.leaves(ref), flatten(tree)):
            assert np.array_equal(np.asarray(a), t.numpy())


def test_reference_bf16_checkpoint_restores_into_the_port(tmp_path):
    """numpy stores JAX's bfloat16 as raw 2-byte values, which the
    reference's own restore cannot cast back; the port reads them as bf16
    bits, so even the reference's bf16 checkpoint restores bitwise."""
    import jax.numpy as jnp
    jcfg = jax_get_config("smollm-135m").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    jax_ckpt.save_checkpoint(tmp_path, jcfg, jp, None, step=2)
    with pytest.raises(ValueError):
        jax_ckpt.restore_checkpoint(tmp_path, jcfg, jp)
    cfg = get_config("smollm-135m").reduced()
    like = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.bfloat16)
    p, _, _ = restore_checkpoint(tmp_path, cfg, like)
    for a, t in zip(jax.tree.leaves(jp), flatten(p)):
        bits = np.asarray(a).view(np.int16)
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(), bits)
