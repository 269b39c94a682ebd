"""The port's LM layers and models against the JAX package.

Inputs come from numpy with a fixed seed; weights come from the JAX
package's own ``init_lm`` (or numpy) and reach the port only through
``lm_params_from_jax``.  JAX runs in this process on one CPU device (the
reference paths compared here are dense).  Configs are the smoke configs
in float32.  Tolerances: layers ``atol=rtol=1e-5`` on unit-scale data
(f32, reordered sums); model logits ``<= 1e-4`` of max|logit|; greedy
tokens equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels.ref import ref_flash_attention  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.api import model_fns  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_RTOL = 1e-4    # max|port - ref| / max|ref| of the logits
MODEL_ARCHS = ["llama3.2-1b", "gemma3-4b", "granite-moe-1b-a400m",
               "qwen2-vl-72b"]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32)
            * np.float32(scale))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs(arch):
    from repro.configs import get_config as jget
    return (dataclasses.replace(jget(arch, smoke=True), dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


def _params(jc, tc, seed=0):
    import jax

    from repro.models import lm as jlm
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jc)
    return jp, lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  tc, device="cpu")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    from repro.configs import get_config as jget
    for smoke in (False, True):
        want, got = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.is_moe == want.is_moe
        assert got.torch_dtype == getattr(torch, want.dtype)


def test_config_registry_aliases():
    from repro.configs import ALIASES as JALIASES
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro_torch.configs import ALIASES, all_configs
    assert ARCH_IDS == JARCH_IDS and ALIASES == JALIASES
    assert set(all_configs(smoke=True)) == set(ARCH_IDS)
    assert get_config("llama3_2_1b") == get_config("llama3.2-1b")


# -------------------------------------------------------------- layers --

def test_rmsnorm_and_rope_match_jax():
    import jax.numpy as jnp

    from repro.models import layers as JL
    rng = _rng(1)
    x, w = _randn(rng, 2, 5, 4, 16), _randn(rng, 16, scale=0.1)
    np.testing.assert_allclose(
        L.rmsnorm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.apply_rope(_t(x), _t(pos), 500000.0).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 500000.0)), **TOL)
    pos3 = rng.integers(0, 100, (2, 3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.apply_mrope(_t(x), _t(pos3), 1e6, (2, 3, 3)).numpy(),
        np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                                  (2, 3, 3))), **TOL)
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(_t(x), _t(pos3), 1e6, (2, 3, 2))


# (name, n_heads, n_kv_heads, window, causal, M-RoPE)
ATTENTION_CASES = [("causal-mha", 4, 4, 0, True, False),
                   ("causal-gqa", 4, 2, 0, True, False),
                   ("window-gqa", 4, 1, 5, True, False),
                   ("bidirectional", 2, 2, 0, False, False),
                   ("mrope-gqa", 4, 2, 0, True, True)]


@pytest.mark.parametrize("name,nh,g,window,causal,mrope", ATTENTION_CASES,
                         ids=[c[0] for c in ATTENTION_CASES])
def test_attention_matches_jax(name, nh, g, window, causal, mrope):
    import jax.numpy as jnp

    from repro.models import layers as JL
    rng = _rng(2)
    d, hd, b, s = 32, 8, 2, 12
    p = {"wq": _randn(rng, d, nh * hd, scale=d ** -0.5),
         "wk": _randn(rng, d, g * hd, scale=d ** -0.5),
         "wv": _randn(rng, d, g * hd, scale=d ** -0.5),
         "wo": _randn(rng, nh * hd, d, scale=(nh * hd) ** -0.5)}
    x = _randn(rng, b, s, d)
    if mrope:
        pos = rng.integers(0, 40, (b, 3, s)).astype(np.int32)
        sections = (1, 1, 2)
    else:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
        sections = None
    kw = dict(n_heads=nh, n_kv_heads=g, head_dim=hd, theta=1e4,
              causal=causal, window=window, mrope_sections=sections)
    want = JL.attention({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), positions=jnp.asarray(pos), **kw)
    got = L.attention({k: _t(v) for k, v in p.items()}, _t(x),
                      positions=_t(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20),
                                           (False, 0)])
def test_blockwise_and_flash_attention_match_ref(causal, window):
    import jax.numpy as jnp

    from repro.kernels.ref import ref_flash_attention as jref
    from repro.models import layers as JL
    rng = _rng(3)
    b, s, h, g, d = 2, 64, 4, 2, 8
    q, k, v = (_randn(rng, b, s, h, d), _randn(rng, b, s, h, d),
               _randn(rng, b, s, h, d))
    scale = d ** -0.5
    kw = dict(causal=causal, window=window, scale=scale, q_chunk=16,
              k_chunk=32)
    got = L.blockwise_attention(_t(q), _t(k), _t(v), **kw).numpy()
    want = np.asarray(JL.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, want, **TOL)
    if window == 0:   # the oracle has no window
        perm = (0, 2, 1, 3)
        oracle = ref_flash_attention(_t(q).permute(perm), _t(k).permute(perm),
                                     _t(v).permute(perm), causal=causal,
                                     scale=scale).permute(perm).numpy()
        joracle = np.asarray(jref(
            jnp.asarray(q.transpose(perm)), jnp.asarray(k.transpose(perm)),
            jnp.asarray(v.transpose(perm)), causal=causal,
            scale=scale)).transpose(perm)
        np.testing.assert_allclose(oracle, joracle, **TOL)
        np.testing.assert_allclose(got, oracle, **TOL)
    # the grouped flash forward (k, v unexpanded) against the reference's
    kg, vg = k[:, :, :g], v[:, :, :g]
    got = L.flash_attention(_t(q), _t(kg), _t(vg), window, causal, scale,
                            16, 32).numpy()
    want = np.asarray(JL.flash_attention(
        jnp.asarray(q), jnp.asarray(kg), jnp.asarray(vg),
        jnp.asarray(window, jnp.int32), causal, scale, 16, 32))
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_core_takes_flash_above_the_area(monkeypatch):
    """Above ``_BLOCKWISE_AREA`` the reference and the port both take the
    flash path (lowered here so the sizes stay small)."""
    import jax.numpy as jnp

    from repro.models import layers as JL
    monkeypatch.setattr(L, "_BLOCKWISE_AREA", 32 * 32)
    monkeypatch.setattr(JL, "_BLOCKWISE_AREA", 32 * 32)
    called = []
    real = L.flash_attention
    monkeypatch.setattr(L, "flash_attention",
                        lambda *a: called.append(1) or real(*a))
    rng = _rng(4)
    q, k, v = (_randn(rng, 1, 48, 4, 8), _randn(rng, 1, 48, 2, 8),
               _randn(rng, 1, 48, 2, 8))
    got = L.attention_core(_t(q), _t(k), _t(v), causal=True, window=7,
                           scale=0.3)
    want = JL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=7, scale=0.3)
    assert called
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(act):
    import jax.numpy as jnp

    from repro.models import layers as JL
    rng = _rng(5)
    d, f = 16, 40
    p = {"w_up": _randn(rng, d, f, scale=d ** -0.5),
         "w_down": _randn(rng, f, d, scale=f ** -0.5)}
    if act != "gelu":
        p["w_gate"] = _randn(rng, d, f, scale=d ** -0.5)
    x = _randn(rng, 2, 3, d)
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  act)
    got = L.mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# capacity_factor 0.5 and groups of 8 make the capacity bind: tokens are
# dropped, so the outputs agree only if the dispatch pattern does
@pytest.mark.parametrize("capacity_factor,group_size", [(1.25, 4096),
                                                        (0.5, 8)])
def test_moe_layer_matches_jax(capacity_factor, group_size):
    import jax.numpy as jnp

    from repro.models import moe as jmoe
    rng = _rng(6)
    d, f, e, k = 16, 24, 4, 2
    p = {"router": _randn(rng, d, e),
         "w_gate": _randn(rng, e, d, f, scale=d ** -0.5),
         "w_up": _randn(rng, e, d, f, scale=d ** -0.5),
         "w_down": _randn(rng, e, f, d, scale=f ** -0.5)}
    x = _randn(rng, 2, 12, d)
    kw = dict(top_k=k, capacity_factor=capacity_factor,
              group_size=group_size)
    want, want_aux = jmoe.moe_layer({n: jnp.asarray(v) for n, v in p.items()},
                                    jnp.asarray(x), **kw)
    got, aux = tmoe.moe_layer({n: _t(v) for n, v in p.items()}, _t(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    if capacity_factor < 1:
        gsz = tmoe.moe_group_size(24, group_size)
        cap = tmoe.moe_capacity(gsz, k, e, capacity_factor)
        assert (gsz, cap) == (8, 2) and gsz * k > cap * e  # drops happen


# --------------------------------------------------------------- models --

def test_lm_params_from_jax_round_trip_and_checks():
    import jax

    jc, tc = _cfgs("granite-moe-1b-a400m")
    jp, tp = _params(jc, tc)
    assert len(tp["blocks"]) == tc.n_layers
    np.testing.assert_array_equal(
        tp["blocks"][1]["moe"]["w_down"].numpy(),
        np.asarray(jp["blocks"]["moe"]["w_down"][1]))
    np.testing.assert_array_equal(tp["emb"]["lm_head"].numpy(),
                                  np.asarray(jp["emb"]["lm_head"]))
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(
        {k: v for k, v in tp.items() if k != "blocks"}))
    n += sum(t.numel() for blk in tp["blocks"]
             for t in jax.tree_util.tree_leaves(blk))
    assert n == tc.param_count()
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["blocks"]["attn"]["wq"] = bad["blocks"]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        lm_params_from_jax(bad, tc, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           _cfgs("llama3.2-1b")[1], device="cpu")


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_init_lm_shapes_and_layer_windows(arch):
    from repro.models import lm as jlm
    jc, tc = _cfgs(arch)
    p = tlm.init_lm(torch.Generator().manual_seed(0), tc, device="cpu")
    q = tlm.init_lm(torch.Generator().manual_seed(0), tc, device="cpu")
    n = sum(t.numel() for t in torch.utils._pytree.tree_leaves(p))
    assert n == tc.param_count()
    torch.testing.assert_close(p["emb"]["lm_head"], q["emb"]["lm_head"],
                               rtol=0, atol=0)
    assert tlm.layer_windows(tc) == [int(w) for w in jlm.layer_windows(jc)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlm.init_lm(torch.Generator().manual_seed(0), tc)


def _tokens_positions(cfg, b, s, seed=7):
    rng = _rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family != "vlm":
        return toks, None
    p = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    return toks, np.stack([p, p // 2, p % 5], axis=1).astype(np.int32)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_forward_lm_logits_match_jax(arch):
    import jax.numpy as jnp

    from repro.models import lm as jlm
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    toks, pos = _tokens_positions(tc, 2, 24)
    jpos = None if pos is None else jnp.asarray(pos)
    want = np.asarray(jlm.forward_lm(jp, jc, jnp.asarray(toks),
                                     positions=jpos)
                      @ jp["emb"]["lm_head"])
    with torch.inference_mode():
        h = tlm.forward_lm(tp, tc, _t(toks),
                           positions=None if pos is None else _t(pos))
        got = (h @ tp["emb"]["lm_head"]).numpy()
    assert _rel(got, want) <= LOGIT_RTOL


def _serve_jax(jp, jc, prompts, steps, bucket=16, max_seq=32):
    """Reference: each prompt prefilled (bucket-padded) into a one-slot
    stage and scattered into a per-slot cache, then ``steps`` batched
    decode steps fed their own greedy tokens; every step's logits."""
    import jax.numpy as jnp

    from repro.models import lm as jlm
    cache = jlm.init_cache(jc, len(prompts), max_seq, per_slot=True)
    logits, toks = [], []
    for slot, p in enumerate(prompts):
        stage = jlm.init_cache(jc, 1, max_seq)
        lg, stage = jlm.prefill(
            jp, jc, stage, jnp.asarray([p + [0] * (bucket - len(p))],
                                       jnp.int32), last_pos=len(p) - 1)
        cache["k"] = cache["k"].at[:, slot].set(stage["k"][:, 0])
        cache["v"] = cache["v"].at[:, slot].set(stage["v"][:, 0])
        cache["len"] = cache["len"].at[slot].set(len(p))
        logits.append(np.asarray(lg[0, 0]))
        toks.append(int(np.argmax(logits[-1])))
    out = [np.stack(logits)]
    for _ in range(steps):
        lg, cache = jlm.decode_step(jp, jc, cache,
                                    jnp.asarray(toks, jnp.int32)[:, None])
        out.append(np.asarray(lg[:, 0]))
        toks = [int(t) for t in out[-1].argmax(-1)]
    return out


def _serve_port(tp, tc, prompts, steps, bucket=16, max_seq=32):
    cache = tlm.init_cache(tc, len(prompts), max_seq, per_slot=True,
                           device="cpu")
    logits, toks = [], []
    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            stage = tlm.init_cache(tc, 1, max_seq, device="cpu")
            lg, stage = tlm.prefill(
                tp, tc, stage, torch.tensor([p + [0] * (bucket - len(p))]),
                last_pos=len(p) - 1)
            cache["k"][:, slot] = stage["k"][:, 0]
            cache["v"][:, slot] = stage["v"][:, 0]
            cache["len"][slot] = len(p)
            logits.append(lg[0, 0].numpy())
            toks.append(int(lg[0, 0].argmax()))
        out = [np.stack(logits)]
        for _ in range(steps):
            lg, cache = tlm.decode_step(
                tp, tc, cache, torch.tensor(toks, dtype=torch.int32)[:, None])
            out.append(lg[:, 0].numpy())
            toks = [int(t) for t in lg[:, 0].argmax(-1)]
    assert cache["len"].tolist() == [len(p) + steps for p in prompts]
    return out


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_prefill_and_per_slot_decode_match_jax(arch):
    """Two slots at different lengths (bucket-padded prefills), then 4
    batched decode steps: the reference's per-slot decode test held
    across packages."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    rng = _rng(8)
    prompts = [[int(t) for t in rng.integers(0, tc.vocab, n)]
               for n in (11, 6)]
    want = _serve_jax(jp, jc, prompts, 4)
    got = _serve_port(tp, tc, prompts, 4)
    for step, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= LOGIT_RTOL, step
        assert (g.argmax(-1) == w.argmax(-1)).all(), step


def test_scalar_decode_matches_per_slot():
    """With every slot at the same length the per-slot scatter/mask path
    reproduces the scalar path (the reference's own test, on the
    port)."""
    _, tc = _cfgs("gemma3-4b")
    tp = tlm.init_lm(torch.Generator().manual_seed(0), tc, device="cpu")
    toks = torch.from_numpy(_rng(9).integers(0, tc.vocab, (2, 12)))
    with torch.inference_mode():
        cache_s = tlm.init_cache(tc, 2, 16, device="cpu")
        _, cache_s = tlm.prefill(tp, tc, cache_s, toks)
        cache_v = {"k": cache_s["k"].clone(), "v": cache_s["v"].clone(),
                   "len": cache_s["len"].expand(2).clone()}
        nxt = torch.tensor([[3], [5]], dtype=torch.int32)
        ls, cs = tlm.decode_step(tp, tc, cache_s, nxt)
        lv, cv = tlm.decode_step(tp, tc, cache_v, nxt)
    torch.testing.assert_close(ls, lv, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(cs["k"], cv["k"], rtol=0, atol=0)
    assert cv["len"].tolist() == [13, 13] and int(cs["len"]) == 13


def test_model_fns_families():
    fns = model_fns(get_config("granite-moe-1b-a400m", smoke=True))
    cache = fns.init_cache(get_config("llama3.2-1b", smoke=True), 3, 16,
                           per_slot=True, device="cpu")
    assert cache["len"].shape == (3,)
    assert cache["k"].shape == (2, 3, 16, 2, 16)
    assert fns.loss is tlm.loss_lm
    # the zoo's families resolve to their own modules, the loss too (its
    # values against the reference: tests/test_torch_lm_loss.py)
    for arch, module in (("xlstm-350m", "ssm_lm"), ("zamba2-7b", "hybrid"),
                         ("whisper-tiny", "encdec")):
        zoo = model_fns(get_config(arch, smoke=True))
        assert zoo.prefill.__module__ == f"repro_torch.models.{module}"
        assert zoo.decode_step.__module__ == zoo.prefill.__module__
        assert zoo.loss.__module__ == zoo.prefill.__module__
        assert zoo.loss.__name__.startswith("loss_")
