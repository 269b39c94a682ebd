"""bfloat16 through the port, against the JAX package, on the CPU.

The reference's kernels compute bfloat16 (``x.dtype`` out, float32
sums), and its LM configs default to it.  Here the port's plain kernel
versions (what the wrappers run on a CPU tensor) are held against the
reference's Pallas kernels in interpret mode, the skinny GEMM's launch
plan is checked at every serving shape, the smoke llama config runs in
bfloat16 in both packages, and the serving CLI picks the reference's
dtype.  Inputs come from numpy with a seed and are rounded to bfloat16
once, in torch; JAX gets the same values (exact in bfloat16).

Tolerances: a kernel's output within ``BF16_KERNEL_RTOL`` = 8e-3 of
max|ref| -- two bfloat16 ulps (2^-8 each): both sides sum in float32 in
their own orders and round once.  Model logits within ``LOGIT_RTOL`` of
max|logit|: the two packages round to bfloat16 at different places of
the layers (norms, RoPE, attention's probabilities), each such rounding
worth an ulp of an activation; the measured gap is recorded beside it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist.lm import lm_step_products  # noqa: E402
from repro_torch.kernels import _plan  # noqa: E402
from repro_torch.kernels.conv2d import conv2d  # noqa: E402
from repro_torch.kernels.matmul import matmul  # noqa: E402
from repro_torch.kernels.winograd import wino_gemm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

BF16_KERNEL_RTOL = 8e-3
# the smoke llama, port vs reference: 1.24e-2 at worst over the prefill
# and 8 decode steps (seed 0; 1.33e-2 over seeds 0-2); ~2.3x headroom.
# The same model with its f32 sums merely reordered (float64 sums, or the
# reduction in two halves) moves the logits by at most 9.3e-6: rounding
# in other places, not summation order, makes this gap
LOGIT_RTOL = 3e-2
SERVE_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")


def _bf16_pair(rng, *shape):
    """The same bfloat16 values as a torch tensor and a JAX array."""
    import jax.numpy as jnp
    t = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                         ).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------- plain versions vs the Pallas kernels --

@pytest.mark.parametrize("m,k,n", [(8, 256, 512), (64, 512, 256)])
def test_matmul_plain_matches_pallas_in_bf16(m, k, n):
    from repro.kernels.matmul import matmul_pallas

    rng = np.random.default_rng(m + k + n)
    x, xj = _bf16_pair(rng, m, k)
    w, wj = _bf16_pair(rng, k, n)
    want = matmul_pallas(xj, wj, interpret=True)
    got = matmul(x, w)
    assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    assert _rel(got.float(), want) <= BF16_KERNEL_RTOL


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d_plain_matches_pallas_in_bf16(padding):
    from repro.kernels.conv2d import conv2d_pallas

    rng = np.random.default_rng(3)
    x, xj = _bf16_pair(rng, 2, 16, 10, 10)
    w, wj = _bf16_pair(rng, 8, 16, 3, 3)
    want = conv2d_pallas(xj, wj, padding=padding, interpret=True)
    got = conv2d(x, w, padding=padding)
    assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    assert _rel(got.float(), want) <= BF16_KERNEL_RTOL


def test_wino_gemm_plain_matches_pallas_in_bf16():
    from repro.kernels.winograd import wino_gemm_pallas

    rng = np.random.default_rng(4)
    v, vj = _bf16_pair(rng, 16, 32, 64)
    u, uj = _bf16_pair(rng, 16, 64, 24)
    want = wino_gemm_pallas(vj, uj, interpret=True)
    got = wino_gemm(v, u)
    assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    assert _rel(got.float(), want) <= BF16_KERNEL_RTOL


# ------------------------------------------------ the skinny GEMM's plan --

def _products(arch):
    """Every distinct (M, C, N) of one decode step (8 slots) and one
    prefill (bucket 64) of ``arch`` that the static plan gives the kernel
    (``pallas_applicable_matmul``), and the (C, N) of each at M = 8, 16,
    64, 128 and 256."""
    from repro_torch.kernels.ops import pallas_applicable_matmul

    cfg = get_config(arch)
    steps = set(lm_step_products(cfg, 8, True))
    steps |= set(lm_step_products(cfg, 64, False))
    steps = {(m, c, n) for m, c, n in steps
             if pallas_applicable_matmul(m, n, c)}
    widths = {(c, n) for _, c, n in steps}
    return sorted(steps | {(m, c, n) for c, n in widths
                           for m in (8, 16, 64, 128, 256)})


def _check_skinny_plan(m, k, n, dtype, sms):
    p = _plan.skinny_plan(m, n, k, dtype, sms)
    strips, chunks, splits = p.grid
    assert p.strip == _plan.SKINNY_STRIP and p.slab == _plan.SKINNY_SLAB[dtype]
    assert p.rows in _plan.SKINNY_ROWS[dtype] and splits == p.splits
    assert p.rows >= min(m, _plan.SKINNY_ROWS[dtype][-1])
    # every output column in exactly one strip, every row in one chunk
    for extent, step, count in ((n, p.strip, strips), (m, p.rows, chunks)):
        owner = np.arange(extent) // step
        assert owner.max() == count - 1
        assert np.bincount(owner, minlength=count).min() >= 1
    # every reduction index in exactly one non-empty split of whole slabs
    assert p.chunk % p.slab == 0
    split_of = np.arange(k) // p.chunk
    assert np.array_equal(np.bincount(split_of, minlength=splits) > 0,
                          np.ones(splits, dtype=bool))
    assert split_of.max() == splits - 1
    # the splits of a strip sum in one cluster, or through a scratch of
    # one [M, N] float32 slice per split, as the kernel writes it
    if splits > _plan.MAX_CLUSTER:
        assert p.scratch == splits * m * n
    else:
        assert p.scratch == 0
    assert strips < 2 ** 31 and chunks <= _plan.GRID_YZ_MAX
    assert splits <= _plan.GRID_YZ_MAX


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_skinny_plan_covers_every_serving_shape(arch):
    for m, c, n in _products(arch):
        for dtype in (torch.bfloat16, torch.float32):
            for sms in (132, 114):
                _check_skinny_plan(m, c, n, dtype, sms)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_skinny_route_takes_bf16_and_short_f32(arch):
    for m, c, n in _products(arch):
        assert _plan.skinny_route(m, n, c, torch.bfloat16)
        assert (_plan.skinny_route(m, n, c, torch.float32)
                == (m <= _plan.SKINNY_M))
    assert not _plan.skinny_route(8, 7, 16, torch.float32)    # ragged N
    assert not _plan.skinny_route(8, 16, 6, torch.float32)    # ragged K
    assert not _plan.skinny_route(8, 16, 16, torch.float64)


def test_skinny_plan_fills_the_card_with_few_splits():
    # a decode step's [8, 2048] @ [2048, 2048] in bfloat16: 16 strips,
    # split until about one block per SM, summed in a cluster
    p = _plan.skinny_plan(8, 2048, 2048, torch.bfloat16, 132)
    assert p.grid[0] == 16 and 1 < p.splits <= _plan.MAX_CLUSTER
    assert p.scratch == 0
    # the 128256-wide head already fills the card: no split
    assert _plan.skinny_plan(8, 128256, 2048, torch.bfloat16, 132).splits == 1


# ------------------------------------------------- the smoke LM in bf16 --

def _cfgs(arch="llama3.2-1b"):
    from repro.configs import get_config as jget
    jc, tc = jget(arch, smoke=True), get_config(arch, smoke=True)
    assert jc.dtype == tc.dtype == "bfloat16"
    return jc, tc


def _teacher_forced_jax(jp, jc, prompts, steps, bucket=16, max_seq=32):
    """The reference: bucket-padded prefills scattered into a per-slot
    cache, then ``steps`` decode steps fed the reference's own greedy
    tokens; (every step's logits, the tokens fed)."""
    import jax.numpy as jnp

    from repro.models import lm as jlm
    cache = jlm.init_cache(jc, len(prompts), max_seq, per_slot=True)
    logits = []
    for slot, p in enumerate(prompts):
        stage = jlm.init_cache(jc, 1, max_seq)
        lg, stage = jlm.prefill(
            jp, jc, stage, jnp.asarray([p + [0] * (bucket - len(p))],
                                       jnp.int32), last_pos=len(p) - 1)
        cache["k"] = cache["k"].at[:, slot].set(stage["k"][:, 0])
        cache["v"] = cache["v"].at[:, slot].set(stage["v"][:, 0])
        cache["len"] = cache["len"].at[slot].set(len(p))
        logits.append(np.asarray(lg[0, 0], dtype=np.float32))
    out, fed = [np.stack(logits)], []
    for _ in range(steps):
        fed.append([int(t) for t in out[-1].argmax(-1)])
        lg, cache = jlm.decode_step(jp, jc, cache,
                                    jnp.asarray(fed[-1], jnp.int32)[:, None])
        out.append(np.asarray(lg[:, 0], dtype=np.float32))
    return out, fed


def _teacher_forced_port(tp, tc, prompts, fed, mesh=None, bucket=16,
                         max_seq=32):
    """The port's logits on the same prompts, fed the tokens ``fed``."""
    cache = tlm.init_cache(tc, len(prompts), max_seq, per_slot=True,
                           device="cpu")
    logits = []
    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            stage = tlm.init_cache(tc, 1, max_seq, device="cpu")
            lg, stage = tlm.prefill(
                tp, tc, stage, torch.tensor([p + [0] * (bucket - len(p))]),
                last_pos=len(p) - 1, dist_mesh=mesh)
            cache["k"][:, slot] = stage["k"][:, 0]
            cache["v"][:, slot] = stage["v"][:, 0]
            cache["len"][slot] = len(p)
            logits.append(lg[0, 0].float().numpy())
        out = [np.stack(logits)]
        for toks in fed:
            lg, cache = tlm.decode_step(
                tp, tc, cache, torch.tensor(toks, dtype=torch.int32)[:, None],
                dist_mesh=mesh)
            out.append(lg[:, 0].float().numpy())
    return out


def _prompts(vocab):
    rng = np.random.default_rng(8)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in (11, 6)]


def test_smoke_llama_bf16_prefill_and_decode_match_jax():
    """The smoke llama config in its own dtype, bfloat16: two slots at
    different lengths, then 4 batched decode steps teacher-forced on the
    reference's tokens; every step's logits within LOGIT_RTOL."""
    import jax

    from repro.models import lm as jlm
    jc, tc = _cfgs()
    jp = jlm.init_lm(jax.random.PRNGKey(0), jc)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                            device="cpu")
    assert tp["emb"]["tok"].dtype == torch.bfloat16
    prompts = _prompts(tc.vocab)
    want, fed = _teacher_forced_jax(jp, jc, prompts, 4)
    got = _teacher_forced_port(tp, tc, prompts, fed)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= LOGIT_RTOL, errs


def _grid_and_dense(rank, prompts, fed):
    """The smoke llama in bfloat16 on a one-rank (1,1,1) grid (every
    projection through ``local_matmul``, the static plan) and dense."""
    from repro_torch.dist.matmul import make_matmul_mesh
    from repro_torch.kernels.autotune import autotune_disabled

    tc = get_config("llama3.2-1b", smoke=True)
    tp = tlm.init_lm(torch.Generator().manual_seed(1), tc, device="cpu")
    mesh = make_matmul_mesh((1, 1, 1), device="cpu")
    before = matmul.launches
    with autotune_disabled():
        grid = _teacher_forced_port(tp, tc, prompts, fed, mesh=mesh)
    routed = matmul.launches - before
    return grid, _teacher_forced_port(tp, tc, prompts, fed), routed


def test_smoke_llama_bf16_grid_matches_dense():
    """On the CPU the grid's products are ``matmul_plain`` (float32 sums,
    one rounding) and the dense ones ``x @ w`` in bfloat16: the logits of
    the two paths within BF16_KERNEL_RTOL, every step."""
    from repro_torch.dist.spawn import run_spmd

    tc = get_config("llama3.2-1b", smoke=True)
    prompts = _prompts(tc.vocab)
    fed = [[3, 5], [7, 11], [13, 17]]
    grid, dense, routed = run_spmd(_grid_and_dense, 1, prompts, fed,
                                   device="cpu")[0]
    assert routed == 0   # the CPU runs the plain versions: no launch
    errs = [_rel(g, d) for g, d in zip(grid, dense)]
    assert max(errs) <= BF16_KERNEL_RTOL, errs


# ---------------------------------------------------------- the CLI dtype --

@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "xlstm-350m"])
def test_serve_config_follows_the_reference_dtype(arch):
    from repro.configs import get_config as jget
    from repro_torch.launch.serve import _TRANSFORMER_FAMILIES, serve_config

    assert serve_config(arch).dtype == jget(arch).dtype
    want = jget(arch, smoke=True)
    if want.family in _TRANSFORMER_FAMILIES:   # the reference's --smoke
        want = dataclasses.replace(want, dtype="float32")
    assert serve_config(arch, smoke=True).dtype == want.dtype


def test_serve_cli_serves_the_config_dtype(monkeypatch, capsys):
    """``main`` hands ``run`` the arch's bfloat16 config, and float32
    under ``--smoke`` (``run`` stubbed: no full-width model is built)."""
    from repro_torch.launch import serve as tserve

    seen = []

    def fake_run(cfg, grid=None, **kw):
        seen.append(cfg.dtype)
        return {"grid": grid, "schedule": "allgather", "n_tokens": 0,
                "n_requests": 0, "served_tokens_per_s": 0.0,
                "tokens_per_s": 0.0, "p50_ms": 0.0, "p99_ms": 0.0}

    monkeypatch.setattr(tserve, "run", fake_run)
    tserve.main(["--device", "cpu", "--arch", "llama3.2-1b"])
    assert seen == ["bfloat16"]
    assert "(bfloat16)" in capsys.readouterr().out
