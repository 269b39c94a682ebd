"""Every family's loss in the port against the JAX package's: the loss
and the gradient of every parameter, for every ``ARCH_IDS`` smoke config
in float32, and with ``cfg.remat`` on for one config of each family.

Weights come from the reference's own ``init`` and reach the port
through ``models/convert.py``; the reference's gradients take the same
path, so the two trees are compared leaf by leaf.  Inputs are numpy draws
from a fixed seed; JAX runs in this process on one CPU device, its
``value_and_grad`` jitted.  Tolerances: the loss within 1e-5 relative,
each gradient within 1e-4 of its max|reference| (f32, the sums in other
orders).  xlstm-350m runs at 16 tokens, one mLSTM chunk: its random
sLSTM recurrence is chaotic (ROADMAP, the note on the zoo at random
weights), and at 32 tokens its mLSTM weights' gradients, which pass back
through the sLSTM stack, read 2.1e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.models.convert import (encdec_params_from_jax,  # noqa: E402
                                        hybrid_params_from_jax,
                                        lm_params_from_jax,
                                        ssm_lm_params_from_jax)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
B, S = 2, 32
SEQ = {"xlstm_350m": 16}
CONVERTERS = {"dense": lm_params_from_jax, "moe": lm_params_from_jax,
              "vlm": lm_params_from_jax, "ssm": ssm_lm_params_from_jax,
              "hybrid": hybrid_params_from_jax,
              "encdec": encdec_params_from_jax}
REMAT_ARCHS = ["llama3_2_1b", "granite_moe_1b_a400m", "qwen2_vl_72b",
               "xlstm_350m", "zamba2_7b", "whisper_tiny"]


def _leaves(tree, prefix=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, sub in items:
            out.update(_leaves(sub, f"{prefix}/{key}"))
        return out
    return {} if tree is None else {prefix: tree}


def _batch(cfg, seq):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (B, seq))
        batch["positions"] = np.stack([pos] * 3, axis=1)
        batch["vision_embeds"] = rng.standard_normal(
            (B, 4, cfg.d_model)).astype(np.float32)
    return batch


def _check_loss_and_grads(arch, remat):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models.api import model_fns as jfns
    jc = dataclasses.replace(jget(arch, smoke=True), dtype="float32",
                             remat=remat)
    tc = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                             remat=remat)
    fns = jfns(jc)
    params = fns.init(jax.random.PRNGKey(0), jc)
    batch = _batch(jc, SEQ.get(arch, S))
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: fns.loss(p, jc, b)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    convert = CONVERTERS[tc.family]
    tree = convert(jax.tree_util.tree_map(np.asarray, params), tc,
                   device="cpu")
    tp = _leaves(tree)                      # the same tensors, by path
    ref = _leaves(convert(jax.tree_util.tree_map(np.asarray, jgrads), tc,
                          device="cpu"))
    names = sorted(tp)
    for name in names:
        tp[name].requires_grad_(True)
    loss = model_fns(tc).loss(tree, tc, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [tp[n] for n in names])
    assert abs(float(loss.detach()) - float(want)) <= \
        LOSS_RTOL * abs(float(want))
    for name, g in zip(names, grads):
        want_g = ref[name].numpy()
        err = float(np.abs(g.numpy() - want_g).max()) / max(
            float(np.abs(want_g).max()), 1e-30)
        assert err <= GRAD_RTOL, f"{arch} {name}: {err:.3e}"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_family_loss_and_grads_match_reference(arch):
    _check_loss_and_grads(arch, remat=False)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_family_loss_and_grads_under_remat_match_reference(arch):
    """``cfg.remat``: the reference checkpoints its layers (the
    transformer keeping the flash output), the port checkpoints each
    layer whole; the gradients are the same."""
    _check_loss_and_grads(arch, remat=True)


def test_model_fns_resolve_every_family_loss():
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        loss = model_fns(cfg).loss
        module = {"ssm": "ssm_lm", "hybrid": "hybrid",
                  "encdec": "encdec"}.get(cfg.family, "lm")
        assert loss.__module__ == f"repro_torch.models.{module}"
