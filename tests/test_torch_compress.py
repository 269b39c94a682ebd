"""The port's compressed reductions (``dist.compress``), microbatch
pipeline (``dist.pipeline``) and compressed train step against the JAX
package.

Quantization and the top-k mask are held equal to the reference's in
process, tied magnitudes included.  One 8-rank gloo launch of the port
runs every collective case, on three meshes of the same 8 ranks: ``(8,)``
(``compressed_psum`` over 8 ranks, where the s8 gather falls back to the
f32 mean, and the compressed train step), ``(4, 2)`` (a 2-rank axis, s8
against f32 on the wire) and ``(2, 4)`` (a 4-stage pipeline).  The JAX
side runs in process: the reference's quantizer on each rank's values,
``jax.grad`` of the reference's dense stage stack, and the reference's
AdamW.  Tolerances: the 8-rank mean within 1e-6 of max|mean| (the same
quantized values summed in another order), the reference's own gates of
``tests/test_dist.py`` / ``test_dist_units.py`` / ``test_dist_vjps.py``
(s8 within 1e-6 of f32 and at least 3.5x fewer wire bytes on 2 ranks;
the pipeline's forward and gradients within 1e-5), the train step's
parameters and its residuals within 1e-6 (the residual is a gradient of
order 1 less its quantized value, so its error is the gradient's
rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the JAX package is imported inside the tests: the 8 spawned ranks import
# this module for _port_rank and need only torch
from repro_torch.dist import compress as tcomp  # noqa: E402

N_RANKS = 8
S, N_MICRO, MB, D = 4, 6, 2, 8          # the reference's pipeline case
TRAIN_STEPS, TRAIN_LR = 2, 1e-2


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "g8": rng.standard_normal((N_RANKS, 64), dtype=f32),
        "g2": rng.standard_normal((2, 4096), dtype=f32),
        "pw": rng.standard_normal((S, D, D), dtype=f32) * f32(0.3),
        "pb": rng.standard_normal((S, D), dtype=f32) * f32(0.1),
        "px": rng.standard_normal((N_MICRO, MB, D), dtype=f32),
        "pg": rng.standard_normal((N_MICRO, MB, D), dtype=f32),
        "tw": rng.standard_normal((8, 4), dtype=f32) * f32(0.1),
        "tx": rng.standard_normal((N_RANKS * 8, 8), dtype=f32),
        "ttrue": rng.standard_normal((8, 4), dtype=f32),
    }


def _quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _bytes(notes, tag=None):
    return sum(n.wire_elems * n.itemsize for n in notes
               if tag is None or n.tag == tag)


def _port_rank(rank, inp):
    """Every collective case on this rank (numpy out)."""
    from repro_torch.dist.collectives import (any_rank, axis_index,
                                              make_mesh, record_collectives)
    from repro_torch.dist.pipeline import pipelined_apply
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import init_train_state, make_train_step

    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    # 8 ranks: the s8 gather passes its break-even and falls back
    mesh8 = make_mesh((N_RANKS,), ("d",), device="cpu")
    g = t["g8"][rank]
    with record_collectives() as notes:
        red, err = tcomp.compressed_psum(g, mesh8, "d", torch.zeros_like(g))
    out["c8"], out["c8_err"] = red.numpy(), err.numpy()
    out["c8_notes"] = [tuple(n) for n in notes]
    applied, e = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(3):   # error feedback with the same gradient
        red, e = tcomp.compressed_psum(g, mesh8, "d", e)
        applied = applied + red
    out["c8_applied3"] = applied.numpy()

    # a 2-rank axis: the real int8 gather against the f32 mean
    mesh42 = make_mesh((4, 2), ("rest", "pod"), device="cpu")
    g2 = t["g2"][axis_index(mesh42, "pod")]
    for wire in ("s8", "f32"):
        with record_collectives() as notes:
            red, _ = tcomp.compressed_psum(g2, mesh42, "pod",
                                           torch.zeros_like(g2), wire=wire)
        out[f"c2_{wire}"] = red.numpy()
        out[f"c2_{wire}_notes"] = [tuple(n) for n in notes]

    # a 4-stage GPipe pipeline and its reverse-ring backward
    mesh24 = make_mesh((2, 4), ("rest", "pipe"), device="cpu")
    params = {"w": t["pw"].clone().requires_grad_(True),
              "b": t["pb"].clone().requires_grad_(True)}
    x = t["px"].clone().requires_grad_(True)
    with record_collectives() as notes:
        y = pipelined_apply(_stage, params, x, mesh24, axis="pipe")
        gw, gb, gx = torch.autograd.grad((y * t["pg"]).sum(),
                                         (params["w"], params["b"], x))
    out["pipe_y"], out["pipe_gw"] = y.detach().numpy(), gw.numpy()
    out["pipe_gb"], out["pipe_gx"] = gb.numpy(), gx.numpy()
    out["pipe_tags"] = sorted({n.tag for n in notes})

    # data-parallel train steps, gradients compressed over the 8 ranks
    rows = slice(rank * 8, (rank + 1) * 8)
    batch = {"x": t["tx"][rows], "y": t["tx"][rows] @ t["ttrue"]}
    opt = AdamW(lr=TRAIN_LR)
    state = init_train_state({"w": t["tw"], "b": torch.zeros(4)}, opt,
                             compress=True)
    step = make_train_step(_quad_loss, opt, compress_axis="d",
                           compress_mesh=mesh8)
    for _ in range(TRAIN_STEPS):
        state, _ = step(state, batch)
    out["train_params"] = {k: v.numpy() for k, v in state.params.items()}
    out["train_err"] = {k: v.numpy() for k, v in state.err.items()}

    # the resilient loop's stop vote: one rank's flag reaches every rank
    with record_collectives() as notes:
        out["vote"] = (any_rank(rank == 3), any_rank(False))
    out["vote_notes"] = [(n.kind, n.tag, n.itemsize) for n in notes]
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.dist.spawn import run_spmd

    inp = _inputs()
    return inp, run_spmd(_port_rank, N_RANKS, inp, device="cpu")


def _ref_dequantized(rows):
    """The reference's int8 round trip of each row (each rank's value)."""
    import jax.numpy as jnp
    from repro.dist.compress import _quantize_int8
    return np.stack([np.asarray(_quantize_int8(jnp.asarray(r)))
                     for r in rows])


# ------------------------------------------------------------ in process --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_parts_equal_reference(dtype):
    import jax.numpy as jnp
    from repro.dist.compress import _quantize_int8, _quantize_parts

    v = np.random.default_rng(1).standard_normal((3, 257)).astype(np.float32)
    v[0, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]  # exact halves after scaling
    jv = jnp.asarray(v, dtype=dtype)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    jq, js = _quantize_parts(jv)
    tq, ts = tcomp._quantize_parts(tv)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    # the round trip: the reference's values in the input's dtype, and
    # (f32) its error bound, half a step
    dq = tcomp._quantize_int8(tv)
    assert dq.dtype == tv.dtype
    np.testing.assert_array_equal(
        dq.float().numpy(),
        np.asarray(_quantize_int8(jv).astype(jnp.float32)))
    if dtype == "float32":
        assert float((tv - dq).abs().max()) <= float(ts) / 2 + 1e-7


@pytest.mark.parametrize("v,k_frac", [
    ([0.1, -5.0, 0.3, 2.0, -0.2, 1.0], 0.5),   # test_dist_units.py
    ([1.0, -1.0, 1.0, 0.5, -1.0, 1.0, 2.0, -1.0], 0.375),  # tied
    ([3.0] * 10, 0.3),                           # all tied
    (None, 0.25),                                # random, rounded k
])
def test_topk_mask_equals_reference(v, k_frac):
    import jax.numpy as jnp
    from repro.dist.compress import _topk_mask

    if v is None:
        v = np.random.default_rng(2).standard_normal((7, 9))
        v = np.round(v, 1)  # ties among the magnitudes
    v = np.asarray(v, dtype=np.float32)
    want = np.asarray(_topk_mask(jnp.asarray(v), k_frac))
    got = tcomp._topk_mask(torch.from_numpy(v), k_frac).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == max(1, int(round(k_frac * v.size)))


def _one_rank_cases(rank):
    """The reference's one-device checks (``tests/test_dist_units.py``)
    on a one-rank gloo mesh."""
    from repro_torch.dist.collectives import make_mesh

    mesh = make_mesh((1,), ("x",), device="cpu")
    out = {}
    # top-k 25% with error feedback: the time-averaged applied update
    # converges to the gradient
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 64), dtype=np.float32))
    e, applied, errs = torch.zeros_like(g), torch.zeros_like(g), []
    for t in range(1, 9):
        red, e = tcomp.compressed_psum(g, mesh, "x", e, k_frac=0.25)
        applied = applied + red
        errs.append(float((applied / t - g).abs().max()))
    out["ef_errs"], out["ef_gmax"] = errs, float(g.abs().max())
    # bf16 gradients keep a bf16 residual through the steps
    gb = torch.randn(32, generator=torch.Generator().manual_seed(5)).to(
        torch.bfloat16)
    red, err = tcomp.compressed_psum(gb, mesh, "x", torch.zeros_like(gb))
    red2, err2 = tcomp.compressed_psum(gb, mesh, "x", err)
    out["bf16_dtypes"] = [str(t.dtype) for t in (red, err, red2, err2)]
    # trees: a None residual, and tuples inside the gradient pytree
    grads = {"a": torch.ones(4), "b": {"c": torch.full((2, 3), 2.0)}}
    red, err = tcomp.compressed_psum_tree(grads, mesh, "x", None)
    out["tree"] = (red["a"].tolist(), red["b"]["c"].tolist(),
                   sorted(err), sorted(err["b"]))
    tgrads = (torch.ones(3), {"w": (torch.full((2,), 2.0), torch.ones(4))})
    red, err = tcomp.compressed_psum_tree(tgrads, mesh, "x", None)
    out["tuple_tree"] = (type(red).__name__, type(red[1]["w"]).__name__,
                         red[1]["w"][0].tolist(), type(err).__name__)
    try:
        tcomp.compressed_psum_tree(grads, mesh, "x", {"a": torch.ones(4)})
        out["mismatch"] = ""
    except ValueError as exc:
        out["mismatch"] = str(exc)
    try:
        tcomp.compressed_psum(g, mesh, "x", wire="s4")
        out["bad_wire"] = ""
    except ValueError as exc:
        out["bad_wire"] = str(exc)
    # one pipeline stage: the stage itself; a stage dim not the axis' size
    # is refused
    from repro_torch.dist.pipeline import pipelined_apply
    p = {"w": torch.randn(1, 3, 3, generator=torch.Generator().manual_seed(
        6)), "b": torch.zeros(1, 3)}
    x = torch.randn(2, 2, 3, generator=torch.Generator().manual_seed(7))
    y = pipelined_apply(_stage, p, x, mesh, axis="x")
    out["pipe1_err"] = float((y - _stage({"w": p["w"][0], "b": p["b"][0]},
                                         x)).abs().max())
    try:
        pipelined_apply(_stage, {"w": torch.zeros(2, 3, 3)}, x, mesh,
                        axis="x")
        out["pipe_refusal"] = ""
    except ValueError as exc:
        out["pipe_refusal"] = str(exc)
    return out


def test_one_rank_error_feedback_dtypes_and_trees():
    from repro_torch.dist.spawn import run_spmd

    out = run_spmd(_one_rank_cases, 1, device="cpu")[0]
    errs = out["ef_errs"]
    assert errs[-1] < errs[0] / 2
    assert errs[-1] < 0.15 * out["ef_gmax"]
    assert out["bf16_dtypes"] == ["torch.bfloat16"] * 4
    a, c, keys, bkeys = out["tree"]
    np.testing.assert_allclose(a, [1.0] * 4, atol=1e-6)  # max maps to 127
    np.testing.assert_allclose(c, [[2.0] * 3] * 2, atol=1e-6)
    assert keys == ["a", "b"] and bkeys == ["c"]
    assert out["tuple_tree"] == ("tuple", "tuple", [2.0, 2.0], "tuple")
    assert "does not match" in out["mismatch"]
    assert "wire must be one of" in out["bad_wire"]
    assert out["pipe1_err"] == 0.0
    assert "leading dim (2,)" in out["pipe_refusal"]


# ------------------------------------------------------------- 8 ranks ----

def test_compressed_psum_8_ranks_equals_reference_mean(runs):
    inp, port = runs
    g = inp["g8"]
    dq = _ref_dequantized(g)
    want = dq.mean(axis=0)
    for r, out in enumerate(port):
        np.testing.assert_allclose(out["c8"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        np.testing.assert_allclose(out["c8_err"], g[r] - dq[r], rtol=0,
                                   atol=1e-7)
        # 8 ranks: past the break-even, the f32 mean of the dequantized
        assert [(n[0], n[2], n[4]) for n in out["c8_notes"]] == \
            [("all-reduce", "compress", 4)]
    # the reference's gates (tests/test_dist.py): close to the true mean,
    # and error feedback no worse over 3 steps with the same gradient
    true = g.mean(axis=0)
    rel = np.abs(port[0]["c8"] - true).max() / np.abs(true).max()
    assert rel < 0.02, rel
    rel3 = np.abs(port[0]["c8_applied3"] / 3 - true).max() \
        / np.abs(true).max()
    assert rel3 < rel + 1e-6, (rel3, rel)


def test_compressed_psum_s8_on_the_wire_2_ranks(runs):
    from repro_torch.dist.collectives import CollectiveNote

    inp, port = runs
    want = _ref_dequantized(inp["g2"]).mean(axis=0)
    for out in port:
        s8 = [CollectiveNote(*n) for n in out["c2_s8_notes"]]
        f32 = [CollectiveNote(*n) for n in out["c2_f32_notes"]]
        # a real int8 all-gather of the payload, and the f32 scales
        assert [(n.kind, n.tag, n.itemsize) for n in s8] == \
            [("all-gather", "compress_s8", 1),
             ("all-gather", "compress_s8", 4)]
        assert [(n.kind, n.tag, n.itemsize) for n in f32] == \
            [("all-reduce", "compress", 4)]
        saving = _bytes(f32) / _bytes(s8)
        assert saving > 3.5, saving       # ~4x on a 2-rank axis
        assert np.abs(out["c2_s8"] - out["c2_f32"]).max() < 1e-6
        np.testing.assert_allclose(out["c2_s8"], want, rtol=0, atol=1e-6)


def _ref_pipeline_grads(inp):
    import jax
    import jax.numpy as jnp

    def ref(params, x):
        h = x
        for s in range(S):
            h = jnp.tanh(h @ params["w"][s] + params["b"][s])
        return h

    params = {"w": jnp.asarray(inp["pw"]), "b": jnp.asarray(inp["pb"])}
    x, g = jnp.asarray(inp["px"]), jnp.asarray(inp["pg"])
    gp, gx = jax.grad(lambda p, xx: jnp.sum(ref(p, xx) * g),
                      (0, 1))(params, x)
    return (np.asarray(ref(params, x)), np.asarray(gp["w"]),
            np.asarray(gp["b"]), np.asarray(gx))


def test_pipelined_apply_forward_and_grads_4_stages(runs):
    inp, port = runs
    y, gw, gb, gx = _ref_pipeline_grads(inp)
    for out in port:   # the complete result and gradients on every rank
        for got, want in ((out["pipe_y"], y), (out["pipe_gw"], gw),
                          (out["pipe_gb"], gb), (out["pipe_gx"], gx)):
            assert np.abs(got - want).max() < 1e-5
        assert out["pipe_tags"] == ["pipe_bwd", "pipe_dp", "pipe_dx",
                                    "pipe_fwd", "pipe_out"]


def test_compressed_train_step_equals_reference_emulation(runs):
    """The port's ``make_train_step(compress_axis=)`` on 8 ranks against
    the reference's quantizer on each rank's gradients, their mean (8
    ranks: the f32 fallback) and the reference's AdamW."""
    import jax
    import jax.numpy as jnp
    from repro.dist.compress import _quantize_int8
    from repro.train.optim import AdamW

    inp, port = runs

    def loss(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    opt = AdamW(lr=TRAIN_LR)
    params = {"w": jnp.asarray(inp["tw"]), "b": jnp.zeros(4)}
    ostate = opt.init(params)
    x = jnp.asarray(inp["tx"])
    batches = [{"x": x[r * 8:(r + 1) * 8],
                "y": x[r * 8:(r + 1) * 8] @ jnp.asarray(inp["ttrue"])}
               for r in range(N_RANKS)]
    errs = [jax.tree.map(jnp.zeros_like, params) for _ in range(N_RANKS)]
    for _ in range(TRAIN_STEPS):
        dqs = []
        for r in range(N_RANKS):
            acc = jax.tree.map(jnp.add, jax.grad(loss)(params, batches[r]),
                               errs[r])
            dq = jax.tree.map(_quantize_int8, acc)
            errs[r] = jax.tree.map(jnp.subtract, acc, dq)
            dqs.append(dq)
        mean = jax.tree.map(lambda *a: sum(a) / N_RANKS, *dqs)
        params, ostate = opt.update(mean, ostate, params)
    for r, out in enumerate(port):
        for k in ("w", "b"):
            np.testing.assert_allclose(out["train_params"][k],
                                       np.asarray(params[k]), rtol=0,
                                       atol=1e-6)
            # the residual is the gradient less its quantized value: its
            # error is the gradient's rounding, O(1e-7) at |g| ~ 1
            np.testing.assert_allclose(out["train_err"][k],
                                       np.asarray(errs[r][k]), rtol=0,
                                       atol=1e-6)


def test_compress_axis_needs_its_mesh():
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import make_train_step

    with pytest.raises(ValueError, match="compress_mesh"):
        make_train_step(_quad_loss, AdamW(), compress_axis="d")


def test_any_rank_vote_reaches_every_rank(runs):
    _, port = runs
    for out in port:
        assert out["vote"] == (True, False)
        assert out["vote_notes"] == [("all-reduce", "stop_vote", 4)] * 2
