"""The port's model zoo -- the ssm, hybrid and encdec families and the
static ``Engine`` -- against the JAX package.

Inputs are numpy draws from fixed seeds; weights come from the
reference's own ``init_*`` and reach the port through the converters of
``models/convert.py``.  JAX runs in this process on one CPU device, its
model functions jitted once per config (module-scoped memo).  The
reference's zoo runs no Pallas kernel.  Tolerances, of max|reference|:
float32 1e-4 (the same math, sums in another order); the bfloat16 zamba2
smoke 3e-2 (the packages round in other places, as
``tests/test_torch_bf16.py`` holds the smoke llama); the port's chunked
recurrence against its own step recurrence 2e-4 (the reference's
``tests/test_models.py`` bound).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.models.convert import (encdec_params_from_jax,  # noqa: E402
                                        hybrid_params_from_jax,
                                        ssm_lm_params_from_jax)

F32_RTOL = 1e-4
BF16_RTOL = 3e-2
SEQ_RTOL = 2e-4
ZOO = ("xlstm-350m", "zamba2-7b", "whisper-tiny")
CONVERTERS = {"ssm": ssm_lm_params_from_jax,
              "hybrid": hybrid_params_from_jax,
              "encdec": encdec_params_from_jax}
B, S, T_ENC, STEPS = 2, 32, 20, 3


def _randn(rng, *shape, scale=1.0):
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, rtol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= rtol, f"{what}: {err:.3e} > {rtol}"


def _leaves(tree, prefix=""):
    """{path: leaf} of nested dicts and lists, ``None`` leaves left
    out."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, sub in items:
            out.update(_leaves(sub, f"{prefix}/{key}"))
        return out
    return {} if tree is None else {prefix: tree}


def _cfgs(arch, dtype="float32"):
    from repro.configs import get_config as jget
    return (dataclasses.replace(jget(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


# ------------------------------------------------------------ reference --

_REF = {}


def _reference(arch, dtype="float32"):
    """The reference on one smoke config (memoized): its parameters (as
    numpy), the inputs, and its forward, prefill and ``STEPS``
    teacher-forced decode steps (logits and caches, as numpy)."""
    if (arch, dtype) in _REF:
        return _REF[(arch, dtype)]
    import jax
    import jax.numpy as jnp

    from repro.models.api import model_fns as jfns
    jc, tc = _cfgs(arch, dtype)
    fns = jfns(jc)
    params = fns.init(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    forced = rng.integers(0, jc.vocab, (STEPS, B, 1)).astype(np.int32)
    frames = _randn(rng, B, T_ENC, jc.d_model)
    to_np = (lambda tree: jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), tree))
    out = {"params": jax.tree_util.tree_map(np.asarray, params),
           "toks": toks, "forced": forced, "frames": frames}
    cache = fns.init_cache(jc, B, S + STEPS, enc_len=T_ENC)
    if jc.family == "encdec":
        from repro.models import encdec as jed
        enc = jax.jit(lambda p, f: jed.encode(p, jc, f))(params, frames)
        h = jax.jit(lambda p, t, e: jed.decode_train(p, jc, t, e))(
            params, toks, enc)
        logits, cache = jax.jit(
            lambda p, c, f, t: fns.prefill(p, jc, c, f, t))(
                params, cache, frames, toks)
    else:
        h = jax.jit(lambda p, t: fns.forward(p, jc, t))(params, toks)
        logits, cache = jax.jit(lambda p, c, t: fns.prefill(p, jc, c, t))(
            params, cache, toks)
    out["forward"] = np.asarray((h @ params["emb"]["lm_head"])
                                .astype(jnp.float32))
    out["prefill"] = (np.asarray(logits), to_np(cache))
    decode = jax.jit(lambda p, c, t: fns.decode_step(p, jc, c, t))
    steps = []
    for t in forced:
        logits, cache = decode(params, cache, t)
        steps.append(np.asarray(logits))
    out["decode"] = (steps, to_np(cache))
    _REF[(arch, dtype)] = out
    return out


def _port(arch, ref, dtype="float32"):
    """The port's parameters from the reference's, and its fns."""
    _, tc = _cfgs(arch, dtype)
    return tc, model_fns(tc), CONVERTERS[tc.family](ref["params"], tc,
                                                     device="cpu")


def _prefill(fns, tc, params, cache, toks, frames=None):
    toks = torch.from_numpy(np.asarray(toks))
    if tc.family == "encdec":
        return fns.prefill(params, tc, cache, _t(frames), toks)
    return fns.prefill(params, tc, cache, toks)


def _snapshot(cache):
    return {k: v.float().clone() for k, v in _leaves(cache).items()}


# ------------------------------------------------------ the recurrences --

def _clr_inputs(seed, s, b=2, h=2, n=4, p=8):
    rng = np.random.default_rng(seed)
    return (_randn(rng, b, s, h, n), _randn(rng, b, s, h, n),
            _randn(rng, b, s, h, p),
            -np.abs(_randn(rng, b, s, h, scale=0.3)),
            -np.abs(_randn(rng, b, s, h, scale=0.2)),
            _randn(rng, b, h, n, p, scale=0.5))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk,s", [(8, 8), (8, 16), (16, 64), (32, 16)])
def test_chunked_recurrence_matches_reference(chunk, s, with_state):
    from repro.models import ssm as jssm
    q, k, v, lf, li, s0 = _clr_inputs(chunk * s, s)
    state0 = s0 if with_state else None
    want_y, want_s = jssm.chunked_linear_recurrence(
        q, k, v, lf, li, chunk=chunk, state0=state0)
    got_y, got_s = tssm.chunked_linear_recurrence(
        *map(_t, (q, k, v, lf, li)), chunk=chunk,
        state0=None if state0 is None else _t(state0))
    _close(got_y, want_y, F32_RTOL, "y")
    _close(got_s, want_s, F32_RTOL, "state")


def test_recurrence_step_matches_reference():
    from repro.models import ssm as jssm
    q, k, v, lf, li, s0 = _clr_inputs(3, 1)
    args = [a[:, 0] for a in (q, k, v, lf, li)]
    want_y, want_s = jssm.linear_recurrence_step(*args, s0)
    state = _t(s0)
    got_y, got_s = tssm.linear_recurrence_step(*map(_t, args), state)
    _close(got_y, want_y, F32_RTOL, "y")
    _close(got_s, want_s, F32_RTOL, "state")
    assert got_s is state          # a float32 state is updated in place


@pytest.mark.parametrize("chunk,s", [(8, 32), (16, 16), (32, 64)])
def test_chunked_recurrence_matches_sequential(chunk, s):
    q, k, v, lf, li, s0 = map(_t, _clr_inputs(chunk + s, s))
    state = s0.clone()
    ys = []
    for t in range(s):
        y, state = tssm.linear_recurrence_step(q[:, t], k[:, t], v[:, t],
                                               lf[:, t], li[:, t], state)
        ys.append(y)
    y, fin = tssm.chunked_linear_recurrence(q, k, v, lf, li, chunk=chunk,
                                            state0=s0)
    _close(y, torch.stack(ys, 1), SEQ_RTOL, "y")
    _close(fin, state, SEQ_RTOL, "state")


def test_causal_conv1d_and_state_continuity():
    from repro.models import ssm as jssm
    rng = np.random.default_rng(4)
    x, w = _randn(rng, 2, 16, 8), _randn(rng, 4, 8, scale=0.5)
    want, want_st = jssm._causal_conv1d(x, w)
    full, st = tssm._causal_conv1d(_t(x), _t(w))
    _close(full, want, F32_RTOL, "y")
    _close(st, want_st, F32_RTOL, "state")
    a, st = tssm._causal_conv1d(_t(x[:, :9]), _t(w))
    b, _ = tssm._causal_conv1d(_t(x[:, 9:]), _t(w), state=st)
    _close(torch.cat([a, b], 1), full, F32_RTOL, "continued")


# -------------------------------------------------------------- blocks --

D_BLK = 32


def _block_case(kind, decode):
    """(reference fn, port fn, params, x, state) of one block."""
    import jax

    from repro.models import ssm as jssm
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(6)
    s = 1 if decode else 16
    x = _randn(rng, 2, s, D_BLK)
    if kind == "mamba2":
        kw = dict(expand=2, state=8, head_dim=16)
        params = jssm.init_mamba2(key, D_BLK, dtype=np.float32, **kw)
        params = dict(params, A_log=_randn(rng, 4, scale=0.5),
                      dt_bias=_randn(rng, 4, scale=0.5))
        state = {"conv_x": _randn(rng, 2, 3, 64),
                 "conv_B": _randn(rng, 2, 3, 8),
                 "conv_C": _randn(rng, 2, 3, 8),
                 "ssd": _randn(rng, 2, 4, 8, 16, scale=0.5)}
        fns = (jssm.mamba2_block, tssm.mamba2_block)
        kw["chunk"] = 8
    elif kind == "mlstm":
        kw = dict(expand=2, n_heads=2)
        params = jssm.init_mlstm(key, D_BLK, dtype=np.float32, **kw)
        state = {"ssd": _randn(rng, 2, 2, 32, 33, scale=0.5)}
        fns = (jssm.mlstm_block, tssm.mlstm_block)
        kw["chunk"] = 8
    else:
        kw = dict(n_heads=2)
        params = jssm.init_slstm(key, D_BLK, dtype=np.float32, **kw)
        params = dict(params, bias=_randn(rng, 4 * D_BLK, scale=0.5))
        state = {name: _randn(rng, 2, 2, 16, scale=0.5)
                 for name in ("c", "n", "h")}
        fns = (jssm.slstm_block, tssm.slstm_block)
    params = {k: np.asarray(v, dtype=np.float32) for k, v in params.items()}
    return fns, kw, params, x, state


@pytest.mark.parametrize("decode", [False, True],
                         ids=["prefill", "decode"])
@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_block_matches_reference(kind, decode):
    (jfn, tfn), kw, params, x, state = _block_case(kind, decode)
    want, want_st = jfn(params, x, ssm_state=state, decode=decode, **kw)
    tparams = {k: _t(v) for k, v in params.items()}
    got, got_st = tfn(tparams, _t(x), decode=decode, **kw,
                      ssm_state={k: _t(v) for k, v in state.items()})
    _close(got, want, F32_RTOL, f"{kind} out")
    assert set(got_st) == set(want_st)
    for name in want_st:
        _close(got_st[name], want_st[name], F32_RTOL, f"{kind} {name}")
    if not decode:     # without a state: no state comes back
        got, none = tfn(tparams, _t(x), **kw)
        assert none is None
        _close(got, jfn(params, x, **kw)[0], F32_RTOL, f"{kind} stateless")


# -------------------------------------------------------------- models --

@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ZOO]
                         + [("zamba2-7b", "bfloat16")])
def test_model_matches_reference(arch, dtype):
    """The forward, the prefill and ``STEPS`` teacher-forced decode steps:
    logits and every cache leaf."""
    rtol = F32_RTOL if dtype == "float32" else BF16_RTOL
    ref = _reference(arch, dtype)
    tc, fns, params = _port(arch, ref, dtype)
    with torch.inference_mode():
        toks = torch.from_numpy(ref["toks"])
        if tc.family == "encdec":
            from repro_torch.models import encdec as ted
            h = ted.decode_train(params, tc, toks,
                                 ted.encode(params, tc, _t(ref["frames"])))
        else:
            h = fns.forward(params, tc, toks)
        _close((h @ params["emb"]["lm_head"]).float(), ref["forward"], rtol,
               "forward")
        cache = fns.init_cache(tc, B, S + STEPS, enc_len=T_ENC, device="cpu")
        logits, cache = _prefill(fns, tc, params, cache, ref["toks"],
                                 ref["frames"])
        want_logits, want_cache = ref["prefill"]
        _close(logits, want_logits, rtol, "prefill logits")
        got_cache = _snapshot(cache)
        assert set(got_cache) == set(_leaves(want_cache))
        for path, leaf in _leaves(want_cache).items():
            _close(got_cache[path], leaf, rtol, f"prefill cache {path}")
        for t, want in zip(ref["forced"], ref["decode"][0]):
            logits, cache = fns.decode_step(params, tc, cache,
                                            torch.from_numpy(t))
            _close(logits, want, rtol, "decode logits")
        for path, leaf in _leaves(ref["decode"][1]).items():
            _close(_leaves(cache)[path], leaf, rtol, f"decode cache {path}")
    assert int(cache["len"]) == S + STEPS


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_matches_forward(arch):
    """The serving prefill's last logits equal the training forward's
    (the reference's ``tests/test_archs.py`` case, in f32)."""
    ref = _reference(arch)
    tc, fns, params = _port(arch, ref)
    with torch.inference_mode():
        cache = fns.init_cache(tc, B, S, enc_len=T_ENC, device="cpu")
        pre, _ = _prefill(fns, tc, params, cache, ref["toks"], ref["frames"])
    _close(pre[:, 0], ref["forward"][:, -1], F32_RTOL, "last logits")


@pytest.mark.parametrize("arch", ZOO)
def test_decode_matches_prefill_continuation(arch):
    """Prefill S - 1 tokens and decode token S == prefill S tokens: the
    step recurrence against the chunked one, the per-step K/V write
    against the bulk one."""
    ref = _reference(arch)
    tc, fns, params = _port(arch, ref)
    toks = ref["toks"][:, :tc.ssm_chunk]
    with torch.inference_mode():
        cache = fns.init_cache(tc, B, S, enc_len=T_ENC, device="cpu")
        _, cache = _prefill(fns, tc, params, cache, toks[:, :-1],
                            ref["frames"])
        step, _ = fns.decode_step(params, tc, cache,
                                  torch.from_numpy(toks[:, -1:]))
        cache = fns.init_cache(tc, B, S, enc_len=T_ENC, device="cpu")
        full, _ = _prefill(fns, tc, params, cache, toks, ref["frames"])
    _close(step, full, F32_RTOL, "continued logits")


@pytest.mark.parametrize("arch", ZOO)
def test_engine_tokens_match_reference(arch):
    """The port's static ``Engine.run`` emits the reference ``Engine``'s
    greedy tokens on the same weights and prompts (f32 smoke)."""
    import jax
    import jax.numpy as jnp

    from repro.launch.serve import Engine as JEngine
    ref = _reference(arch)
    jc, _ = _cfgs(arch)
    tc, _, params = _port(arch, ref)
    prompts, gen = ref["toks"][:, :16], 5
    jparams = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    want, _, _ = JEngine(jc, jparams, slots=B,
                         max_seq=16 + gen).run(jnp.asarray(prompts), gen)
    engine = tserve.Engine(tc, params, slots=B, max_seq=16 + gen)
    got, t_pre, t_dec = engine.run(prompts, gen)
    assert got.tolist() == np.asarray(want).tolist()
    assert len(engine.decode_ms) == gen - 1 and t_pre > 0 and t_dec > 0
    with pytest.raises(ValueError, match="slots"):
        engine.run(np.zeros((B + 1, 4), np.int32), gen)


# ---------------------------------------------------------- converters --

def _first_leaf_path(tree, path=()):
    for key, sub in tree.items():
        if isinstance(sub, dict):
            return _first_leaf_path(sub, path + (key,))
        return path + (key,)


@pytest.mark.parametrize("arch", ZOO)
def test_converter_refuses_wrong_shape_and_missing_key(arch):
    import copy
    ref = _reference(arch)
    _, tc = _cfgs(arch)
    convert = CONVERTERS[tc.family]
    stacked = {"ssm": "mblocks", "hybrid": "mblocks",
               "encdec": "dec"}[tc.family]
    bad = copy.deepcopy(ref["params"])
    path = (stacked,) + _first_leaf_path(bad[stacked])
    node = bad
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = node[path[-1]][..., :-1]       # one column short
    with pytest.raises(ValueError, match="want shape"):
        convert(bad, tc, device="cpu")
    missing = copy.deepcopy(ref["params"])
    del missing[stacked]
    with pytest.raises(ValueError, match="want keys"):
        convert(missing, tc, device="cpu")
    # the converted weights keep the reference's float32 leaves
    params = convert(ref["params"], dataclasses.replace(tc, dtype="bfloat16"),
                     device="cpu")
    dtypes = {path: leaf.dtype for path, leaf in _leaves(params).items()}
    f32 = sorted(p for p, d in dtypes.items() if d == torch.float32)
    want = {"ssm": ["gates", "bias"], "hybrid": ["A_log", "D", "dt_bias"],
            "encdec": []}[tc.family]
    assert sorted({p.rsplit("/", 1)[1] for p in f32}) == sorted(want)
