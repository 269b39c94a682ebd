"""The port's autotuned kernel menu against the JAX package: the best-of
tuner's semantics (as ``tests/test_autotune.py`` holds them), the
batched tile GEMM's plain version against ``wino_gemm_pallas`` in
interpret mode, Winograd and im2col against their JAX functions, and the
gradient of every conv candidate against ``jax.grad``.

Inputs come from numpy with a fixed seed.  Tolerances are the JAX
package's own (``tests/test_autotune.py``): forward ``rtol=1e-4,
atol=2e-4``, gradients ``rtol=1e-3, atol=2e-3``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import gemm_conv as jgemm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import winograd as jwino  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels._build import KernelError  # noqa: E402
from repro_torch.kernels.gemm_conv import conv2d_im2col, im2col  # noqa: E402
from repro_torch.kernels.winograd import (conv2d_winograd,  # noqa: E402
                                          winograd_applicable, wino_gemm,
                                          wino_gemm_plain)

FWD_TOL = dict(rtol=1e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=2e-3)
_DN = ("NCHW", "OIHW", "NCHW")


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _ref_conv(x, w, stride, padding):
    return lax.conv_general_dilated(
        x, w, stride, padding, dimension_numbers=_DN,
        preferred_element_type=jnp.float32).astype(x.dtype)


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """Fresh tuner state against a throwaway cache file."""
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "plans.json"))
    monkeypatch.delenv(autotune.MODE_ENV, raising=False)
    autotune.plan_cache().reset()
    yield autotune.plan_cache()
    autotune.plan_cache().reset()


# ===================================================== the batched GEMM ===

@pytest.mark.parametrize("t,p,c,k,bp,bc,bk", [
    (16, 64, 32, 48, 32, 16, 16), (16, 128, 64, 64, 64, 32, 64),
    (16, 8, 256, 8, 8, 128, 8)])
def test_wino_gemm_plain_matches_pallas(t, p, c, k, bp, bc, bk):
    v, u = _normal(1, t, p, c), _normal(2, t, c, k)
    want = jwino.wino_gemm_pallas(jnp.asarray(v), jnp.asarray(u),
                                  block_p=bp, block_k=bk, block_c=bc,
                                  interpret=True)
    got = wino_gemm(torch.from_numpy(v), torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(
        wino_gemm_plain(torch.from_numpy(v), torch.from_numpy(u)).numpy(),
        np.asarray(jwino.wino_gemm_einsum(jnp.asarray(v), jnp.asarray(u))),
        **FWD_TOL)


# ================================================ Winograd and im2col ===

WINO_CASES = [
    ((2, 8, 8, 8), (8, 8, 3, 3), "SAME"),
    ((2, 8, 9, 7), (8, 8, 3, 3), "SAME"),     # odd extents: pad + crop
    ((2, 8, 9, 7), (8, 8, 3, 3), "VALID"),
    ((1, 3, 14, 13), (5, 3, 3, 3), "SAME"),   # non-tiling channels
    ((1, 2, 3, 3), (4, 2, 3, 3), "VALID"),    # single output pixel
]


@pytest.mark.parametrize("xs,ws,pad", WINO_CASES)
def test_conv2d_winograd_matches_jax(xs, ws, pad):
    x, w = _normal(3, *xs), _normal(4, *ws)
    want = jwino.conv2d_winograd(jnp.asarray(x), jnp.asarray(w), padding=pad)
    got = conv2d_winograd(torch.from_numpy(x), torch.from_numpy(w),
                          padding=pad)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    with autotune.autotune_disabled():  # through the tile-GEMM dispatcher
        got_k = conv2d_winograd(torch.from_numpy(x), torch.from_numpy(w),
                                padding=pad, gemm=ops.wino_gemm)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want), **FWD_TOL)


def test_winograd_applicability_matches_jax():
    cases = [((2, 8, 8, 8), (8, 8, 3, 3), (1, 1), "SAME"),
             ((2, 8, 8, 8), (8, 8, 5, 5), (1, 1), "SAME"),
             ((2, 8, 8, 8), (8, 8, 3, 3), (2, 2), "SAME"),
             ((2, 8, 2, 8), (8, 8, 3, 3), (1, 1), "VALID"),
             ((2, 4, 8, 8), (8, 8, 3, 3), (1, 1), "SAME")]
    for case in cases:
        assert winograd_applicable(*case) == jwino.winograd_applicable(*case)
    with pytest.raises(ValueError, match="winograd"):
        conv2d_winograd(torch.zeros(1, 2, 8, 8), torch.zeros(3, 2, 5, 5))


IM2COL_CASES = [
    ((2, 8, 9, 7), (8, 8, 3, 3), (1, 1), "SAME"),
    ((2, 8, 9, 7), (8, 8, 3, 3), (1, 1), "VALID"),
    ((2, 3, 15, 15), (4, 3, 5, 5), (2, 2), "SAME"),    # strided
    ((2, 3, 15, 14), (4, 3, 5, 3), (3, 2), "VALID"),   # aniso stride/kernel
    ((1, 2, 7, 7), (3, 2, 1, 1), (1, 1), "SAME"),      # pointwise
]


@pytest.mark.parametrize("xs,ws,st,pad", IM2COL_CASES)
def test_conv2d_im2col_matches_jax(xs, ws, st, pad):
    x, w = _normal(5, *xs), _normal(6, *ws)
    want = jgemm.conv2d_im2col(jnp.asarray(x), jnp.asarray(w), stride=st,
                               padding=pad)
    for mm in (None, ops.local_matmul):
        with autotune.autotune_disabled():
            got = conv2d_im2col(torch.from_numpy(x), torch.from_numpy(w),
                                stride=st, padding=pad, matmul=mm)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    lhs, hw = im2col(torch.from_numpy(x), ws[2], ws[3], stride=st,
                     padding=pad)
    jlhs, jhw = jgemm.im2col(jnp.asarray(x), ws[2], ws[3], stride=st,
                             padding=pad)
    assert hw == jhw
    np.testing.assert_array_equal(lhs.numpy(), np.asarray(jlhs))


# ================================================ every candidate's grad ==

GRAD_CASES = [((2, 8, 9, 9), (8, 8, 3, 3), (1, 1), "SAME"),
              ((2, 8, 8, 7), (16, 8, 3, 3), (1, 1), "VALID"),
              ((2, 3, 11, 11), (5, 3, 3, 3), (2, 2), "SAME")]


@pytest.mark.parametrize("xs,ws,st,pad", GRAD_CASES)
def test_every_candidate_gradient_matches_jax_grad(xs, ws, st, pad):
    x, w = _normal(7, *xs), _normal(8, *ws)
    rx, rw = jax.grad(lambda a, b: jnp.sum(_ref_conv(a, b, st, pad) ** 2),
                      (0, 1))(jnp.asarray(x), jnp.asarray(w))
    cands = ops.conv_candidates(xs, ws, st, pad)
    assert cands == jops.conv_candidates(xs, ws, st, pad)
    with autotune.autotune_disabled():
        for impl in cands:
            a = torch.from_numpy(x).requires_grad_(True)
            b = torch.from_numpy(w).requires_grad_(True)
            out = ops._run_conv_impl(impl, a, b, st, pad)
            gx, gw = torch.autograd.grad((out ** 2).sum(), (a, b))
            np.testing.assert_allclose(gx.numpy(), np.asarray(rx),
                                       err_msg=impl, **GRAD_TOL)
            np.testing.assert_allclose(gw.numpy(), np.asarray(rw),
                                       err_msg=impl, **GRAD_TOL)


def test_matmul_and_tile_gemm_gradients_match_jax_grad():
    a, b = _normal(9, 16, 24), _normal(10, 24, 8)
    v, u = _normal(11, 16, 8, 16), _normal(12, 16, 16, 8)
    for port_fn, jax_fn, (p, q) in [
            (ops.local_matmul, lambda s, t: s @ t, (a, b)),
            (ops.wino_gemm, jwino.wino_gemm_einsum, (v, u))]:
        want = jax.grad(lambda s, t: jnp.sum(jax_fn(s, t) ** 2), (0, 1))(
            jnp.asarray(p), jnp.asarray(q))
        s = torch.from_numpy(p).requires_grad_(True)
        t = torch.from_numpy(q).requires_grad_(True)
        with autotune.autotune_disabled():
            got = torch.autograd.grad((port_fn(s, t) ** 2).sum(), (s, t))
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL)


# ========================================================= the tuner ===

def _counting_candidates(counter, fast="a"):
    def mk(name):
        def fn(x):
            counter[name] = counter.get(name, 0) + 1
            y = x + 1.0
            if name != fast:          # dominated: extra work
                for _ in range(50):
                    y = y @ torch.eye(x.shape[0])
            return y
        return fn
    return [("a", mk("a")), ("b", mk("b"))]


def test_best_of_times_once_and_persists(tuner):
    counter = {}
    args = lambda: (torch.ones(64, 64),)
    assert autotune.best_of("unit:key", _counting_candidates(counter),
                            args) == "a"
    assert counter == {"a": 3, "b": 3}   # one warm call + 2 timed reps
    assert autotune.best_of("unit:key", _counting_candidates(counter),
                            args) == "a"
    assert counter == {"a": 3, "b": 3}   # memoized: no re-timing
    ent = tuner.lookup("unit:key")
    assert ent["impl"] == "a" and set(ent["wall_ms"]) == {"a", "b"}
    assert os.path.exists(tuner.path)


def test_cache_round_trip_no_retiming(tuner, monkeypatch):
    counter = {}
    args = lambda: (torch.ones(32, 32),)
    autotune.best_of("unit:rt", _counting_candidates(counter), args)
    n_timed = dict(counter)
    tuner.reset()   # a fresh process: empty memory, same cache file
    assert autotune.best_of("unit:rt", _counting_candidates(counter),
                            args) == "a"
    assert counter == n_timed, "persisted winner must not be re-timed"
    monkeypatch.setenv(autotune.MODE_ENV, "refresh")
    tuner.reset()
    autotune.best_of("unit:rt", _counting_candidates(counter), args)
    assert counter == {k: 2 * v for k, v in n_timed.items()}


def test_single_candidate_skips_timing(tuner):
    counter = {}
    (name, fn), _ = _counting_candidates(counter)
    assert autotune.best_of("unit:single", [(name, fn)], lambda: ()) == "a"
    assert counter == {} and tuner.lookup("unit:single") is None


def test_failing_candidate_gets_inf(tuner):
    def boom(x):
        raise RuntimeError("no")
    impl = autotune.best_of("unit:fail", [("bad", boom),
                                          ("ok", lambda x: x + 1)],
                            lambda: (torch.ones(4, 4),))
    assert impl == "ok"
    assert tuner.lookup("unit:fail")["wall_ms"]["bad"] == float("inf")


def test_kernel_error_propagates_out_of_best_of(tuner):
    """A hand-written kernel that fails to build or launch must not lose
    the timing race quietly to a library call."""
    def broken_kernel(x):
        raise KernelError("conv2d kernel launch failed: CUDA error 1")
    with pytest.raises(KernelError, match="launch failed"):
        autotune.best_of("unit:kernel", [("direct", broken_kernel),
                                         ("xla", lambda x: x + 1)],
                         lambda: (torch.ones(4, 4),))
    assert tuner.lookup("unit:kernel") is None
    assert issubclass(KernelError, RuntimeError)


@pytest.mark.parametrize("error", [TypeError, ValueError, MemoryError])
def test_hand_written_candidate_failure_on_the_card_propagates(
        tuner, monkeypatch, error):
    """On operands on the card, any failure of a candidate that is not a
    library call propagates (a wrapper's dtype or layout refusal, an
    out-of-memory scratch allocation); library candidates still read
    ``inf``.  The card is stood in for by ``_on_card``; the CPU keeps the
    JAX package's ``inf`` semantics (test above)."""
    monkeypatch.setattr(autotune, "_on_card", lambda args: True)

    def refused(x):
        raise error("the CUDA kernel takes float32")

    def library_down(x):
        raise RuntimeError("library failure")
    with pytest.raises(error, match="float32"):
        autotune.best_of("unit:card", [("direct", refused),
                                       ("xla", library_down)],
                         lambda: (torch.ones(4, 4),))
    assert tuner.lookup("unit:card") is None
    # every library candidate failing: the static (first) choice, untuned
    assert autotune.best_of("unit:card-lib", [("xla", library_down),
                                              ("einsum", library_down)],
                            lambda: (torch.ones(4, 4),)) == "xla"
    assert tuner.lookup("unit:card-lib") is None


def test_env_zero_forces_paper_plan_path(tuner, monkeypatch):
    monkeypatch.setenv(autotune.MODE_ENV, "0")
    assert not autotune.enabled()
    for case in [((2, 8, 8, 8), (8, 8, 3, 3), (1, 1), "SAME"),
                 ((2, 3, 8, 8), (5, 3, 3, 3), (1, 1), "SAME"),
                 ((2, 8, 8, 8), (8, 8, 3, 3), (2, 2), "SAME")]:
        with jautotune.autotune_disabled():
            want = jops.select_conv_impl(case[0], case[1], jnp.float32,
                                         case[2], case[3])
        assert ops.select_conv_impl(*case) == want
    assert ops.select_matmul_impl(16, 16, 16) == "pallas"
    assert ops.select_matmul_impl(15, 16, 16) == "xla"
    assert not os.path.exists(tuner.path), "static path must not tune"


def test_autotune_disabled_scope(tuner):
    assert autotune.enabled()
    with autotune.autotune_disabled():
        assert not autotune.enabled()
        assert ops.select_conv_impl((2, 8, 8, 8), (8, 8, 3, 3), (1, 1),
                                    "SAME") == "direct"
    assert autotune.enabled()


@pytest.mark.parametrize("select", ["conv", "matmul"])
def test_selector_without_device_never_times_on_cpu(tuner, select,
                                                     monkeypatch):
    """The public selectors' device defaults to the card: with the tuner
    on and no ``device`` on a host without one, the timing pass raises
    the device rule's error instead of timing on the CPU and persisting
    that winner under a key that does not name the device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert autotune.enabled()
    call = {"conv": lambda: ops.select_conv_impl(
                (2, 8, 8, 8), (8, 8, 3, 3), (1, 1), "SAME"),
            "matmul": lambda: ops.select_matmul_impl(16, 16, 16)}[select]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert not os.path.exists(tuner.path), "no plan table may be written"
    assert tuner.lookup(ops.conv_key((2, 8, 8, 8), (8, 8, 3, 3),
                                     torch.float32, (1, 1), "SAME")) is None
    assert tuner.lookup(ops.matmul_key(16, 16, 16, torch.float32)) is None
    with autotune.autotune_disabled():  # the static plan needs no device
        assert call() == {"conv": "direct", "matmul": "pallas"}[select]


def test_selected_dispatch_matches_reference(tuner):
    """Through ``local_conv2d`` with the tuner live: whatever wins, the
    numerics match XLA, and the key strings are the JAX package's."""
    for xs, ws, st, pad in [((2, 8, 9, 9), (8, 8, 3, 3), (1, 1), "SAME"),
                            ((2, 3, 11, 11), (5, 3, 3, 3), (2, 2), "SAME"),
                            ((2, 8, 8, 8), (8, 8, 3, 3), (1, 1), "VALID")]:
        x, w = _normal(13, *xs), _normal(14, *ws)
        out = ops.local_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                               stride=st, padding=pad)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(_ref_conv(jnp.asarray(x), jnp.asarray(w),
                                              st, pad)), **FWD_TOL)
        key = ops.conv_key(xs, ws, torch.float32, st, pad)
        assert key == jops.conv_key(xs, ws, jnp.float32, st, pad)
        assert tuner.lookup(key)["impl"] in ops.conv_candidates(xs, ws, st,
                                                                pad)
    assert ops.matmul_key(8, 16, 24, torch.float32) == \
        jops.matmul_key(8, 16, 24, jnp.float32)
    assert ops.wino_gemm_key(32, 8, 16, torch.float32) == \
        jops.wino_gemm_key(32, 8, 16, jnp.float32)


def test_warm_tunes_the_layer_table_and_persists(tuner):
    """``autotune.warm`` on the CPU at batch 1 for one ResNet-50 layer:
    the table names the layer and the head-style matmuls, each winner is
    a candidate it timed, and the winners land in the cache file, from
    which a fresh table reloads them without timing again."""
    import json

    table = autotune.warm(batch=1, layers=["res5a_2b"], refresh=True,
                          device="cpu")
    assert set(table) == {"res5a_2b", "matmul_1x512x1000",
                          "matmul_256x256x256"}
    layer = table["res5a_2b"]
    assert set(layer["wall_ms"]) == {"direct", "winograd", "im2col", "xla"}
    assert layer["impl"] == min(layer["wall_ms"],
                                key=layer["wall_ms"].__getitem__)
    # the [1,512]@[512,1000] head is not a multiple of 8: xla, untimed
    assert table["matmul_1x512x1000"] == {"impl": "xla", "wall_ms": {}}
    assert autotune.mode() == "1"   # refresh lasted the call only
    with open(tuner.path, encoding="utf-8") as f:
        plans = json.load(f)["plans"]
    key = ops.conv_key((1, 512, 7, 7), (512, 512, 3, 3), torch.float32,
                       (1, 1), "SAME")
    assert plans[key]["impl"] == layer["impl"]
    assert plans[ops.matmul_key(256, 256, 256, torch.float32)]["impl"] == \
        table["matmul_256x256x256"]["impl"]
    tuner.reset()
    assert autotune.warm(batch=1, layers=["res5a_2b"], device="cpu") == table
