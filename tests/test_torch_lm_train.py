"""LM training in the port against the JAX package: the chunked
vocabulary loss, the custom backward passes (flash attention, the chunked
linear recurrence, the sLSTM scan), the synthetic data pipeline, the
train step's modes, the host trainer's CLI and the loss on a matmul grid.

Inputs are numpy draws from fixed seeds; JAX runs in this process on one
CPU device (the reference's custom VJPs are plain JAX, no Pallas).
Tolerances, of max|reference| (per tensor for gradients): the loss
1e-5 relative; outputs 1e-5; gradients 1e-4 -- the reference's own
bounds for its custom VJPs against autodiff (``tests/test_models.py``,
``tests/test_custom_vjps.py``) -- f32 in both packages, the sums in other
orders.  The grid against dense: 1e-5 (loss) and 1e-4 (gradients), the
products' shards summed in another order.  The family losses against the
reference are in ``tests/test_torch_lm_loss.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

LOSS_RTOL = 1e-5
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _randn(rng, *shape, scale=1.0):
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(
        grad)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


# ------------------------------------------------ chunked cross-entropy --

@pytest.mark.parametrize("chunk", [16, 64, 512])
def test_chunked_cross_entropy_matches_reference(chunk):
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL
    rng = np.random.default_rng(chunk)
    b, s, d, v = 2, 64, 32, 97
    h, w = _randn(rng, b, s, d), _randn(rng, d, v)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    want, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: JL.chunked_cross_entropy(h, w, jnp.asarray(labels),
                                              chunk=chunk), (0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h, True), _t(w, True)
    got = L.chunked_cross_entropy(th, tw, torch.from_numpy(labels),
                                  chunk=chunk)
    assert got.dtype == torch.float32
    dh, dw = torch.autograd.grad(got, (th, tw))
    got = got.detach()
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    assert _rel(dh, jdh) <= GRAD_RTOL and _rel(dw, jdw) <= GRAD_RTOL
    # and the dense log-softmax, the reference's own check
    logp = torch.log_softmax(th.detach() @ tw.detach(), dim=-1)
    dense = -logp.gather(-1, torch.from_numpy(labels).long()[..., None])
    assert abs(float(got) - float(dense.mean())) <= LOSS_RTOL * float(got)


def test_chunked_cross_entropy_refuses_a_ragged_chunk():
    with pytest.raises(ValueError, match="divide"):
        L.chunked_cross_entropy(torch.zeros(1, 24, 4), torch.zeros(4, 5),
                                torch.zeros(1, 24, dtype=torch.int32),
                                chunk=16)


# ------------------------------------------------------- flash attention --

# (name, B, S, H, G, D, causal, window, q_chunk, k_chunk)
FLASH_CASES = [("gqa-causal", 2, 128, 8, 2, 16, True, 0, 64, 32),
               ("gqa-window", 2, 128, 8, 2, 16, True, 40, 32, 32),
               ("gqa-bidirectional", 2, 128, 8, 2, 16, False, 0, 32, 64),
               ("mha-causal", 2, 128, 3, 3, 16, True, 0, 32, 32)]


def _flash_inputs(case):
    _, b, s, h, g, d, *_ = case
    rng = np.random.default_rng(len(case[0]))
    return (_randn(rng, b, s, h, d), _randn(rng, b, s, g, d),
            _randn(rng, b, s, g, d), _randn(rng, b, s, h, d))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_vjp_matches_reference(case):
    """The ``autograd.Function`` against the reference's custom VJP
    (``jax.vjp`` of its ``flash_attention``): output, dq, dk, dv."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL
    _, b, s, h, g, d, causal, win, qc, kc = case
    q, k, v, gr = _flash_inputs(case)
    scale = d ** -0.5
    out_j, vjp = jax.vjp(lambda q, k, v: JL.flash_attention(
        q, k, v, jnp.asarray(win, jnp.int32), causal, scale, qc, kc),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(gr))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = L.flash_attention(tq, tk, tv, win, causal, scale, qc, kc)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert _rel(out, out_j) <= OUT_RTOL
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(gr))
    for name, got, want in zip("qkv", grads, grads_j):
        assert _rel(got, want) <= GRAD_RTOL, name


@pytest.mark.parametrize("case", FLASH_CASES[:2], ids=lambda c: c[0])
def test_flash_vjp_matches_dense_autograd(case):
    """The port's flash backward against autograd through the port's
    dense ``attention_scores`` (k, v expanded) on the same inputs."""
    _, b, s, h, g, d, causal, win, qc, kc = case
    q, k, v, gr = _flash_inputs(case)
    scale = d ** -0.5
    ins = [_t(a, True) for a in (q, k, v)]
    out = L.flash_attention(*ins, win, causal, scale, qc, kc)
    flash = torch.autograd.grad(out, ins, _t(gr))
    ins2 = [_t(a, True) for a in (q, k, v)]
    dense = L.attention_scores(
        ins2[0], L._repeat_kv(ins2[1], h // g), L._repeat_kv(ins2[2], h // g),
        mask=L.make_mask(s, s, causal=causal, window=win), scale=scale)
    assert _rel(out, dense.detach().numpy()) <= OUT_RTOL
    for got, want in zip(flash, torch.autograd.grad(dense, ins2, _t(gr))):
        assert _rel(got, want.numpy()) <= GRAD_RTOL


def test_flash_without_grad_runs_the_forward_alone():
    q, k, v, _ = _flash_inputs(FLASH_CASES[0])
    with torch.no_grad():
        out = L.flash_attention(_t(q, True), _t(k), _t(v), 0, True, 0.25, 64,
                                32)
    assert out.grad_fn is None and out.shape == q.shape


# ---------------------------------------------------- the recurrences --

def _clr_inputs(with_state):
    rng = np.random.default_rng(5)
    b, s, h, n, p = 2, 64, 3, 8, 16
    ins = [_randn(rng, b, s, h, n), _randn(rng, b, s, h, n),
           _randn(rng, b, s, h, p),
           -np.abs(_randn(rng, b, s, h)) * np.float32(0.3),
           -np.abs(_randn(rng, b, s, h)) * np.float32(0.2)]
    s0 = _randn(rng, b, h, n, p, scale=0.5) if with_state else None
    return ins, s0, _randn(rng, b, s, h, p)


@pytest.mark.parametrize("with_state", [False, True])
def test_clr_vjp_matches_reference(with_state):
    """``chunked_linear_recurrence`` (four chunks) through ``_ClrScan``
    against the reference's ``_clr_scan`` custom VJP: ``sum(y * g) +
    sum(S_fin ** 2)``, gradients of q, k, v, lf, li (and state0)."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    ins, s0, g = _clr_inputs(with_state)
    n_in = 5 + with_state

    def jloss(*a):
        y, st = jssm.chunked_linear_recurrence(
            *a[:5], chunk=16, state0=a[5] if with_state else None)
        return jnp.sum(y * g) + jnp.sum(st ** 2)

    args = [jnp.asarray(a) for a in ins] + ([jnp.asarray(s0)]
                                             if with_state else [])
    want, jgrads = jax.value_and_grad(jloss, tuple(range(n_in)))(*args)
    targs = [_t(a, True) for a in ins] + ([_t(s0, True)]
                                           if with_state else [])
    y, st = tssm.chunked_linear_recurrence(
        *targs[:5], chunk=16, state0=targs[5] if with_state else None)
    assert type(y.grad_fn).__name__ == "_ClrScanBackward"
    got = (y * _t(g)).sum() + (st ** 2).sum()
    grads = torch.autograd.grad(got, targs)
    assert abs(float(got.detach()) - float(want)) <= \
        LOSS_RTOL * abs(float(want))
    for i, (gt, gj) in enumerate(zip(grads, jgrads)):
        assert _rel(gt, gj) <= GRAD_RTOL, i


def test_slstm_vjp_matches_reference():
    """``_slstm_scan`` through ``_SlstmScan`` against the reference's
    custom VJP: gradients of pre, r, bias and the initial carry."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm
    rng = np.random.default_rng(6)
    b, s, h, hd = 2, 16, 3, 8
    pre = _randn(rng, b, s, h, 4 * hd, scale=0.5)
    r = _randn(rng, h, hd, 4 * hd, scale=0.2)
    bias = _randn(rng, h, 4 * hd, scale=0.1)
    carry = [_randn(rng, b, h, hd, scale=0.3) for _ in range(3)]
    g = _randn(rng, b, s, h, hd)

    def jloss(pre, r, bias, c, n, hh):
        hs, (cf, nf, hf) = jssm._slstm_scan(pre, r, bias, (c, n, hh))
        return jnp.sum(hs * g) + jnp.sum(cf ** 2) + jnp.sum(nf * hf)

    args = [pre, r, bias] + carry
    want, jgrads = jax.value_and_grad(jloss, tuple(range(6)))(
        *[jnp.asarray(a) for a in args])
    targs = [_t(a, True) for a in args]
    hs, (cf, nf, hf) = tssm._slstm_scan(*targs[:3], tuple(targs[3:]))
    got = (hs * _t(g)).sum() + (cf ** 2).sum() + (nf * hf).sum()
    grads = torch.autograd.grad(got, targs)
    assert abs(float(got.detach()) - float(want)) <= \
        LOSS_RTOL * abs(float(want))
    for i, (gt, gj) in enumerate(zip(grads, jgrads)):
        assert _rel(gt, gj) <= GRAD_RTOL, i


def test_recurrences_without_grad_match_with_grad():
    """The serving path (no graph) and the training path (the
    ``autograd.Function``s) compute the same forward."""
    ins, s0, _ = _clr_inputs(True)
    targs = [_t(a, True) for a in ins]
    y1, st1 = tssm.chunked_linear_recurrence(*targs, chunk=16,
                                             state0=_t(s0))
    with torch.inference_mode():
        y2, st2 = tssm.chunked_linear_recurrence(
            *[_t(a) for a in ins], chunk=16, state0=_t(s0))
    assert torch.equal(y1.detach(), y2) and torch.equal(st1.detach(), st2)


# ------------------------------------------------------ the data pipeline --

@pytest.mark.parametrize("frames,positions3d", [(False, False),
                                                (True, False),
                                                (False, True)])
def test_data_pipeline_batches_equal_reference(frames, positions3d):
    from repro.data import pipeline as jpipe
    kw = dict(global_batch=8, seq_len=16, vocab=101, seed=3, n_hosts=2,
              host_id=1, frames=frames, d_model=12, positions3d=positions3d)
    want = jpipe.SyntheticTokens(jpipe.DataConfig(**kw))
    got = tpipe.SyntheticTokens(tpipe.DataConfig(**kw))
    for step in (0, 5):
        a, b = got.batch_at(step), want.batch_at(step)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_data_pipeline_host_sharded_and_prefetched():
    """The reference's own pipeline checks, on the port."""
    cfg = tpipe.DataConfig(global_batch=8, seq_len=16, vocab=101, seed=3,
                           n_hosts=2, host_id=0)
    ds = tpipe.SyntheticTokens(cfg)
    a = ds.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], ds.batch_at(5)["tokens"])
    other = tpipe.SyntheticTokens(dataclasses.replace(cfg, host_id=1))
    assert not np.array_equal(a["tokens"], other.batch_at(5)["tokens"])
    assert a["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    with pytest.raises(ValueError, match="hosts"):
        tpipe.SyntheticTokens(dataclasses.replace(cfg, n_hosts=3))
    pf = tpipe.Prefetcher(tpipe.SyntheticTokens(tpipe.DataConfig(
        global_batch=4, seq_len=8, vocab=31)), depth=2, start_step=2)
    try:
        for step in range(2, 5):
            np.testing.assert_array_equal(pf.next()["tokens"],
                                          pf.ds.batch_at(step)["tokens"])
    finally:
        pf.close()
    assert not pf.thread.is_alive()
    batch = tpipe.to_torch(a, "cpu")
    assert batch["tokens"].dtype == torch.int32


# ------------------------------------------------------- the train step --

def test_modes_refused_as_the_reference_refuses():
    from repro.train import optim as joptim
    from repro.train import step as jstep
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep

    assert tstep.MODES == jstep.MODES
    for make, opt in ((jstep.make_train_step, joptim.AdamW()),
                      (tstep.make_train_step, toptim.AdamW())):
        with pytest.raises(ValueError, match="mode must be one of"):
            make(lambda p, b: 0.0, opt, mode="fsdp")
        with pytest.raises(ValueError, match="compress_axis needs"):
            make(lambda p, b: 0.0, opt, mode="dist-grid",
                 compress_axis="pod")
        make(lambda p, b: 0.0, opt, mode="dist-grid")
        make(lambda p, b: 0.0, opt, mode="gspmd")


def test_two_adamw_steps_equal_reference():
    """The smoke llama in f32: two ``make_train_step`` AdamW steps (two
    microbatches each) of both packages from the same weights on the
    same batches: losses, gradient norms and the new parameters."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.data import pipeline as jpipe
    from repro.models import lm as jlm
    from repro.train import optim as joptim
    from repro.train import step as jstep
    from repro_torch.models.convert import lm_params_from_jax
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep

    jc = dataclasses.replace(jget("llama3.2-1b", smoke=True),
                             dtype="float32")
    tc = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                             dtype="float32")
    jp = jlm.init_lm(jax.random.PRNGKey(0), jc)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                            device="cpu")
    ds = jpipe.SyntheticTokens(jpipe.DataConfig(global_batch=4, seq_len=16,
                                                vocab=jc.vocab))
    jopt = joptim.AdamW(lr=joptim.cosine_schedule(1e-2, 1, 4))
    topt = toptim.AdamW(lr=toptim.cosine_schedule(1e-2, 1, 4))
    jfn = jax.jit(jstep.make_train_step(
        lambda p, b: jlm.loss_lm(p, jc, b), jopt, n_microbatches=2))
    tfn = tstep.make_train_step(lambda p, b: tlm.loss_lm(p, tc, b), topt,
                                n_microbatches=2, mode="gspmd")
    js, ts = jstep.init_train_state(jp, jopt), tstep.init_train_state(tp,
                                                                      topt)
    for step in range(2):
        batch = ds.batch_at(step)
        js, jm = jfn(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tfn(ts, tpipe.to_torch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            LOSS_RTOL * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            GRAD_RTOL * float(jm["grad_norm"])
        assert tm["step"] == int(jm["step"]) == step + 1
    want = lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     js.params), tc,
                              device="cpu")
    got = torch.utils._pytree.tree_leaves(ts.params)
    # an AdamW step moves a weight by lr * m / sqrt(v), whose error is the
    # relative error of that weight's own gradient -- large where the
    # gradient is small: within 1% of the two steps' learning rates
    step_sum = sum(toptim.cosine_schedule(1e-2, 1, 4)(s) for s in (1, 2))
    for g, w in zip(got, torch.utils._pytree.tree_leaves(want)):
        assert float((g - w).abs().max()) <= 1e-2 * step_sum


# ----------------------------------------------------------- the CLI --

def _host_cli(tmp, *extra):
    from repro_torch.launch import train
    return train.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                       "--steps", "8", "--batch", "4", "--seq", "16",
                       "--log-every", "1", "--ckpt-every", "2",
                       "--ckpt-dir", str(tmp), *extra])


def test_host_cli_resumes_to_the_uninterrupted_losses(tmp_path, capsys):
    """``--mesh host`` killed by a SIGTERM at step 5 (the emergency save)
    and ``--resume``d: the stitched losses equal an uninterrupted run's
    (the same float32 ops on the CPU)."""
    plan = json.dumps({"faults": [{"kind": "sigterm", "step": 5}]})
    a = _host_cli(tmp_path / "a", "--fault-plan", plan)
    assert a["preempted"] and a["end_step"] == 5 and len(a["losses"]) == 5
    b = _host_cli(tmp_path / "a", "--resume")
    assert b["start_step"] == 5 and not b["preempted"]
    full = _host_cli(tmp_path / "full")
    assert full["end_step"] == 8 and all(np.isfinite(full["losses"]))
    assert a["losses"] + b["losses"] == full["losses"]
    out = capsys.readouterr().out
    assert "[train] preempted at step 5" in out
    assert "[train] resumed from step 5" in out
    assert "[train] final checkpoint at 8" in out


# --------------------------------------------------- the loss on a grid --

GRID = (2, 1, 2)
GRID_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")


def _grid_cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32")


def _grid_batch(cfg):
    return tpipe.to_torch(tpipe.SyntheticTokens(tpipe.DataConfig(
        global_batch=4, seq_len=16, vocab=cfg.vocab, seed=2)).batch_at(0))


def _loss_and_grads(cfg, mesh=None):
    from torch.utils import _pytree as pytree
    params = tlm.init_lm(torch.Generator().manual_seed(7), cfg,
                         device="cpu")
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    loss = tlm.loss_lm(pytree.tree_unflatten(leaves, spec), cfg,
                       _grid_batch(cfg), dist_mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _grid_rank(rank):
    """``loss_lm(dist_mesh=)`` on the grid for both archs, the static
    plan; and ``mode="gspmd"`` on more than one rank: the step builds,
    refuses plain state, and runs on state placed on a ``(4, 1)`` mesh
    by ``place_gspmd``."""
    from repro_torch.dist.collectives import record_collectives
    from repro_torch.dist.matmul import make_matmul_mesh
    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep

    mesh = make_matmul_mesh(GRID, device="cpu")
    out = {}
    with autotune_disabled():
        for arch in GRID_ARCHS:
            with record_collectives() as notes:
                out[arch] = _loss_and_grads(_grid_cfg(arch), mesh)
            out[arch + ":tags"] = sorted({n.tag for n in notes})
    from repro_torch.dist.collectives import make_mesh
    cfg = _grid_cfg("llama3.2-1b")
    opt = toptim.AdamW()
    step = tstep.make_train_step(lambda p, b: tlm.loss_lm(p, cfg, b), opt)
    state = tstep.init_train_state(
        tlm.init_lm(torch.Generator().manual_seed(7), cfg, device="cpu"),
        opt)
    try:
        step(state, _grid_batch(cfg))
    except ValueError as e:
        out["gspmd"] = str(e)
    pl = tstep.place_gspmd(cfg, make_mesh((4, 1), ("data", "model"),
                                          device="cpu"),
                           state, _grid_batch(cfg))
    try:
        _, metrics = step(pl.state, pl.place_batch(_grid_batch(cfg)))
    finally:
        L.set_attention_mesh(None)
    out["gspmd_loss"] = float(metrics["loss"])
    return out


def test_loss_on_the_grid_matches_dense():
    """One gloo launch of 4 ranks on the ``(2,1,2)`` matmul grid: every
    projection (and granite-moe's experts) routed, the loss and every
    gradient on every rank equal to the port's dense."""
    from repro_torch.dist.lm import projection_routed
    from repro_torch.dist.spawn import run_spmd

    for arch in GRID_ARCHS:
        cfg = _grid_cfg(arch)
        m = 4 * 16
        assert projection_routed(m, cfg.d_model, cfg.n_kv_heads
                                 * cfg.head_dim, GRID)
        assert projection_routed(m, cfg.n_heads * cfg.head_dim,
                                 cfg.d_model, GRID)
    outs = run_spmd(_grid_rank, 4, device="cpu")
    for arch in GRID_ARCHS:
        loss, grads = _loss_and_grads(_grid_cfg(arch))
        for out in outs:
            got_loss, got_grads = out[arch]
            assert abs(got_loss - loss) <= LOSS_RTOL * abs(loss)
            for g, w in zip(got_grads, grads):
                assert _rel(g, w) <= GRAD_RTOL
        # tags are scoped by the projection: "wq:serve_glue", ...
        tags = {t.split(":")[-1] for t in outs[0][arch + ":tags"]}
        assert {"serve_glue", "reshard", "scatter_axis"} <= tags
        if arch.startswith("granite"):
            assert {"moe_combine", "moe_dx", "moe_dcomb"} <= tags
    assert all("place_gspmd" in o["gspmd"] for o in outs)
    loss, _ = _loss_and_grads(_grid_cfg("llama3.2-1b"))
    for o in outs:
        assert abs(o["gspmd_loss"] - loss) <= LOSS_RTOL * abs(loss)
