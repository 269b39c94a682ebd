"""The port's LM serving engine (``launch/serve.py``), its grid plumbing
(``dist/lm.py``) and the serve-grid synthesis against the JAX package.

* Accounting and synthesis are pure Python: held exactly equal to the
  reference at full width over every config, slot count, grid of 1-8
  devices and schedule.
* The dense engine (weights from the reference's ``init_lm`` through
  ``lm_params_from_jax``, the same ``Request`` prompts: 5 requests,
  prompt lengths 7-10, gen 4-6, 2 slots, bucket 8) emits the reference
  engine's greedy tokens and statuses (JAX in this process, one device)
  for llama3.2-1b, granite-moe, gemma3-4b and qwen2-vl smoke.
* One 8-rank gloo launch serves the same request sets on the ``(2,2,2)``
  grid under each schedule: every rank's tokens equal the reference's
  dense tokens, and one recorded decode step's wire equals
  ``lm_serve_comm_elems`` term by term (the glue apart).
* The one-rank ``(1,1,1)`` grid (gloo, world 1, in process) gives the
  dense tokens and reaches ``kernels.ops.local_matmul`` with the kernel
  chosen for every projection whose shape tiles.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the JAX package is imported inside the tests: the 8 spawned ranks import
# this module for _port_rank and need only torch
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.dist import lm as tdl  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import lm_params_from_jax  # noqa: E402

SCHEDULES = ("allgather", "ring", "ring2")
ENGINE_ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m")
# the dense engine also serves a sliding-window and an M-RoPE model
DENSE_ENGINE_ARCHS = ENGINE_ARCHS + ("gemma3-4b", "qwen2-vl-72b")
ENGINE_KW = dict(slots=2, max_seq=16, prefill_bucket=8)
TRANSFORMER_ARCHS = [a for a in ARCH_IDS
                     if get_config(a).family in ("dense", "moe", "vlm")]
SLOTS = (1, 4, 8)


def _factorizations(n):
    return [g for g in itertools.product(range(1, n + 1), repeat=3)
            if g[0] * g[1] * g[2] == n]


GRIDS = [g for n in range(1, 9) for g in _factorizations(n)]


def _smoke(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _prompts(vocab):
    """(prompt, max_new) of the 5 requests: lengths 7-10, gen 4-6."""
    rng = np.random.default_rng(5)
    return [([int(t) for t in rng.integers(0, vocab, 7 + i % 4)], 4 + i % 3)
            for i in range(5)]


def _requests(mod, prompts):
    return [mod.Request(rid=i, prompt=list(p), max_new=m)
            for i, (p, m) in enumerate(prompts)]


# ----------------------------------------------------------- accounting --

@pytest.mark.parametrize("arch,slots", [(a, s) for a in ARCH_IDS
                                        for s in SLOTS])
def test_serve_accounting_equals_jax(arch, slots):
    from repro.configs import get_config as jget
    from repro.dist import lm as jdl
    jc, tc = jget(arch), get_config(arch)
    assert tdl.lm_decode_matmuls(tc, slots) == jdl.lm_decode_matmuls(
        jc, slots)
    assert tdl.kv_cache_elems(tc, slots, 4096) == jdl.kv_cache_elems(
        jc, slots, 4096)
    g, t = tdl._moe_decode_group(tc, slots)
    assert (g, t) == jdl._moe_decode_group(jc, slots)
    for grid in GRIDS:
        assert tdl.moe_ffn_comm_elems(g, t, tc.d_model, grid) \
            == jdl.moe_ffn_comm_elems(g, t, jc.d_model, grid)
        assert tdl.moe_ffn_grid_divides(tc.n_experts, tc.d_ff, grid) \
            == jdl.moe_ffn_grid_divides(jc.n_experts, jc.d_ff, grid)
        for sched in SCHEDULES:
            assert tdl.lm_serve_comm_elems(tc, grid, slots=slots,
                                           schedule=sched) \
                == jdl.lm_serve_comm_elems(jc, grid, slots=slots,
                                           schedule=sched), (grid, sched)
            assert tdl.lm_serve_mem_elems(tc, grid, slots=slots,
                                          max_seq=4096, schedule=sched) \
                == jdl.lm_serve_mem_elems(jc, grid, slots=slots,
                                          max_seq=4096, schedule=sched), \
                (grid, sched)
    with pytest.raises(ValueError, match="schedule"):
        tdl.lm_serve_comm_elems(tc, (2, 2, 2), slots=slots, schedule="x")


def _choice(fn, *args, **kw):
    try:
        c = fn(*args, **kw)
    except ValueError as err:
        return ("error", str(err))
    return (c.grid, c.algo, c.routed, c.comm_elems, c.mem_elems)


@pytest.mark.parametrize("arch,n", [(a, n) for a in TRANSFORMER_ARCHS
                                    for n in (1, 2, 4, 8)])
def test_synthesize_serve_grid_equals_jax(arch, n):
    from repro.configs import get_config as jget
    from repro.core.sharding_synthesis import synthesize_serve_grid as jsyn

    from repro_torch.core import synthesize_serve_grid as tsyn
    jc, tc = jget(arch), get_config(arch)
    for slots, sched in ((4, "allgather"), (8, "ring2")):
        kw = dict(slots=slots, max_seq=2048, schedule=sched)
        free = _choice(tsyn, tc, n, **kw)
        assert free == _choice(jsyn, jc, n, **kw)
        if free[0] == "error":
            continue
        cap = free[4]["peak"] * (1 - 1e-9)    # excludes the free pick
        capped = _choice(tsyn, tc, n, mem_cap_elems=cap, **kw)
        assert capped == _choice(jsyn, jc, n, mem_cap_elems=cap, **kw)
        assert capped[0] != free[0]


def test_synthesize_serve_grid_refusals():
    from repro_torch.core import synthesize_serve_grid
    cfg = _smoke("llama3.2-1b")
    with pytest.raises(ValueError, match="over cap"):
        synthesize_serve_grid(cfg, 8, slots=4, max_seq=32,
                              mem_cap_elems=1.0)
    with pytest.raises(ValueError, match="minimize"):
        synthesize_serve_grid(cfg, 8, slots=4, max_seq=32, minimize="x")
    for kw in (dict(minimize="time"), dict(calib={})):
        with pytest.raises(NotImplementedError, match="perf"):
            synthesize_serve_grid(cfg, 8, slots=4, max_seq=32, **kw)


# --------------------------------------------------- engine vs reference --

@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's ``init_lm`` weights (numpy), the request
    set, and the reference engine's dense tokens and statuses."""
    import jax

    from repro.configs import get_config as jget
    from repro.launch import serve as jserve
    from repro.models import lm as jlm
    out = {}
    for arch in DENSE_ENGINE_ARCHS:
        jc = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
        jp = jlm.init_lm(jax.random.PRNGKey(0), jc)
        prompts = _prompts(jc.vocab)
        res = jserve.ContinuousEngine(jc, jp, **ENGINE_KW).serve(
            _requests(jserve, prompts))
        out[arch] = {"params": jax.tree_util.tree_map(np.asarray, jp),
                     "prompts": prompts, "tokens": res["tokens"],
                     "statuses": res["statuses"]}
    return out


@pytest.mark.parametrize("arch", DENSE_ENGINE_ARCHS)
def test_dense_engine_tokens_equal_jax(reference, arch):
    ref = reference[arch]
    cfg = _smoke(arch)
    params = lm_params_from_jax(ref["params"], cfg, device="cpu")
    res = tserve.ContinuousEngine(cfg, params, **ENGINE_KW).serve(
        _requests(tserve, ref["prompts"]))
    assert res["tokens"] == ref["tokens"]
    assert res["statuses"] == ref["statuses"]
    assert res["n_tokens"] == sum(m for _, m in ref["prompts"])
    assert res["reps"] > 0 and res["tokens_per_s"] > 0
    # the served rate counts the prefills' time as well
    assert 0 < res["served_tokens_per_s"] <= res["tokens_per_s"]


def _port_rank(rank, arch_inputs):
    """Every (arch, schedule) served on the (2,2,2) grid, and one decode
    step recorded; this rank's tokens and wire by scope."""
    from repro_torch.kernels.autotune import autotune_disabled

    with autotune_disabled():  # the static plan: ranks agree
        return _port_rank_body(arch_inputs)


def _port_rank_body(arch_inputs):
    from repro_torch.dist.collectives import record_collectives
    from repro_torch.dist.matmul import make_matmul_mesh

    mesh = make_matmul_mesh((2, 2, 2), device="cpu")
    out = {}
    for arch, (params_np, prompts) in arch_inputs.items():
        cfg = _smoke(arch)
        params = lm_params_from_jax(params_np, cfg, device="cpu")
        for sched in SCHEDULES:
            eng = tserve.ContinuousEngine(cfg, params, dist_mesh=mesh,
                                          dist_schedule=sched, **ENGINE_KW)
            res = eng.serve(_requests(tserve, prompts))
            cache = tlm.init_cache(cfg, ENGINE_KW["slots"],
                                   ENGINE_KW["max_seq"], per_slot=True,
                                   device="cpu")
            toks = torch.tensor([[3], [5]], dtype=torch.int32)
            with torch.inference_mode(), record_collectives() as notes:
                tlm.decode_step(params, cfg, cache, toks, dist_mesh=mesh,
                                dist_schedule=sched)
            wire = {}
            for n in notes:
                scope, _, inner = n.tag.partition(":")
                key = "glue" if inner == tdl.GLUE_TAG else scope
                wire[key] = wire.get(key, 0.0) + n.wire_elems
            out[(arch, sched)] = {"tokens": res["tokens"],
                                  "statuses": res["statuses"], "wire": wire}
    return out


@pytest.fixture(scope="module")
def grid_runs(reference):
    from repro_torch.dist.spawn import run_spmd

    inputs = {a: (reference[a]["params"], reference[a]["prompts"])
              for a in ENGINE_ARCHS}
    return run_spmd(_port_rank, 8, inputs, device="cpu")


@pytest.mark.subprocess
@pytest.mark.parametrize("arch,sched", [(a, s) for a in ENGINE_ARCHS
                                        for s in SCHEDULES])
def test_grid_engine_tokens_and_wire_8rank(reference, grid_runs, arch,
                                           sched):
    from repro.configs import get_config as jget
    from repro.dist import lm as jdl
    jc = dataclasses.replace(jget(arch, smoke=True), dtype="float32")
    acc = jdl.lm_serve_comm_elems(jc, (2, 2, 2), slots=ENGINE_KW["slots"],
                                  schedule=sched)
    want = {name: jc.n_layers * v for name, v in acc["per_layer"].items()}
    want["lm_head"] = acc["lm_head"]
    for rank_out in grid_runs:
        got = rank_out[(arch, sched)]
        assert got["tokens"] == reference[arch]["tokens"]
        assert got["statuses"] == reference[arch]["statuses"]
        wire = dict(got["wire"])
        glue = wire.pop("glue")
        assert wire == want            # term by term, exactly
        assert sum(wire.values()) == acc["total"]
        assert glue > 0                # the replicated glue, reported apart


def _one_rank(rank, arch, prompts, slots):
    """The (1,1,1) grid and the dense path on one gloo rank; which impl
    ``local_matmul`` chose per shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import autotune_disabled

    chosen = {}
    real = ops.select_matmul_impl

    def record(m, n, k, **kw):
        chosen[(m, k, n)] = impl = real(m, n, k, **kw)
        return impl

    cfg = _smoke(arch)
    params = tlm.init_lm(torch.Generator().manual_seed(1), cfg,
                         device="cpu")
    kw = dict(slots=slots, max_seq=16, prefill_bucket=8, params=params,
              device="cpu")
    ops.select_matmul_impl = record
    try:
        with autotune_disabled():
            grid = tserve.run(cfg, grid=(1, 1, 1),
                              request_set=_requests(tserve, prompts), **kw)
    finally:
        ops.select_matmul_impl = real
    dense = tserve.run(cfg, grid=None, request_set=_requests(tserve, prompts),
                       **kw)
    return grid, dense, chosen


def test_one_rank_grid_takes_the_kernel_and_matches_dense():
    from repro_torch.dist.spawn import run_spmd
    from repro_torch.kernels.ops import pallas_applicable_matmul

    arch, slots = "llama3.2-1b", 8
    cfg = _smoke(arch)
    prompts = _prompts(cfg.vocab)
    grid, dense, chosen = run_spmd(_one_rank, 1, arch, prompts, slots,
                                   device="cpu")[0]
    assert grid["tokens"] == dense["tokens"] and grid["grid"] == (1, 1, 1)
    assert grid["wire_bytes_per_tok"] == 0.0
    # every projection of the decode step and of both prefill buckets
    shapes = {(M, C, N) for _, M, C, N in tdl.lm_decode_matmuls(cfg, slots)}
    for bucket in (8, 16):
        shapes |= {(bucket, C, N) for name, _, C, N
                   in tdl.lm_decode_matmuls(cfg, slots) if name != "lm_head"}
    shapes.add((1, cfg.d_model, cfg.vocab))     # the prefill's head row
    assert set(chosen) == shapes
    for (m, k, n), impl in chosen.items():
        want = "pallas" if pallas_applicable_matmul(m, n, k) else "xla"
        assert impl == want, (m, k, n)
    assert sum(impl == "pallas" for impl in chosen.values()) >= 8


def test_serve_main_smoke_on_one_rank(capsys):
    res = tserve.main(["--device", "cpu", "--smoke", "--grid", "1x1x1",
                       "--requests", "3", "--gen", "3", "--slots", "2"])
    assert res["n_requests"] == 3 and res["grid"] == (1, 1, 1)
    assert "identical" in capsys.readouterr().out


# ------------------------------------------------- engine bookkeeping --

def _engine(cfg=None, slots=2, max_seq=24, **kw):
    cfg = cfg or _smoke("llama3.2-1b")
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    return tserve.ContinuousEngine(cfg, params, slots=slots,
                                   max_seq=max_seq, prefill_bucket=8, **kw)


def test_engine_admission_rejects_oversized():
    eng = _engine(max_seq=16)
    big = tserve.Request(rid=0, prompt=[1] * 10, max_new=8)
    assert eng.submit(big) is False
    assert big.status == "rejected_oversize"
    assert "exceeds max_seq" in big.error
    assert [r.rid for r in eng.retired] == [0]
    ok = tserve.Request(rid=1, prompt=[1] * 8, max_new=8)   # fits exactly
    assert eng.submit(ok) is True and ok.status == "ok"
    assert len(eng.queue) == 1


def test_engine_slot_recycling_serves_all():
    cfg = _smoke("llama3.2-1b")
    eng = _engine(cfg, slots=2, max_seq=24)
    reqs = tserve._make_requests(cfg, requests=5, prompt_len=6, gen=4,
                                 seed=0)
    eng.warmup([len(r.prompt) for r in reqs])    # leaves no state behind
    assert eng.cache["len"].tolist() == [0, 0] and not eng.decode_ms
    res = eng.serve(reqs)
    assert res["n_requests"] == 5 and sorted(res["tokens"]) == [0, 1, 2, 3, 4]
    for r in reqs:
        assert len(r.out) == r.max_new, r.rid
    assert not eng.queue and all(s is None for s in eng.active)
    assert res["n_tokens"] == sum(r.max_new for r in reqs)
    assert eng.engine_state()["decode_steps"] == res["reps"]
    assert [len(r.prompt) for r in reqs] == [6, 5, 4, 3, 6]
    assert [r.max_new for r in reqs] == [4, 3, 2, 4, 3]


def test_engine_eos_frees_slot():
    eng = _engine(eos_id=7)
    req = tserve.Request(rid=0, prompt=[1, 2], max_new=100, out=[3])
    eng.active[0] = req
    eng._maybe_retire(0, 5)      # ordinary token: keeps the slot
    assert eng.active[0] is req
    eng._maybe_retire(0, 7)      # EOS: retires and frees
    assert eng.active[0] is None and eng.retired == [req]


def test_engine_refusals():
    with pytest.raises(ValueError, match="static Engine"):
        tserve.ContinuousEngine(get_config("xlstm-350m", smoke=True), {},
                                slots=2, max_seq=16)
    # the fault knobs are taken since the fault runtime was ported (their
    # behaviour: tests/test_torch_fault.py); the zoo's families still raise
    for knob in ("decode_watchdog_timeout_s", "state_dump_path",
                 "fault_log", "injector"):
        assert getattr(_engine(**{knob: 1.0}), knob) == 1.0
    with pytest.raises(NotImplementedError, match="zoo slice"):
        tserve.main(["--arch", "whisper-tiny", "--device", "cpu"])


def test_engine_backpressure_and_deadline_statuses():
    eng = _engine(max_queue=2)
    reqs = [tserve.Request(rid=0, prompt=[1] * 30, max_new=4),   # oversize
            tserve.Request(rid=1, prompt=[1] * 4, max_new=4),
            tserve.Request(rid=2, prompt=[1] * 4, max_new=4),
            tserve.Request(rid=3, prompt=[1] * 4, max_new=4)]   # queue full
    stats = eng.serve(reqs)
    assert stats["statuses"] == {0: "rejected_oversize", 1: "ok", 2: "ok",
                                 3: "rejected_backpressure"}
    assert stats["n_ok"] == 2 and stats["n_rejected"] == 2
    assert stats["tokens"][0] == [] and len(stats["tokens"][1]) == 4

    eng = _engine()
    slow = tserve.Request(rid=0, prompt=[1, 2, 3], max_new=16,
                          deadline_s=1e-9)
    ok = tserve.Request(rid=1, prompt=[1, 2, 3], max_new=4)
    eng.submit(slow)
    eng.submit(ok)
    slow.t_submit -= 100.0   # deterministic: deadline long past
    eng._admit()             # queued-expiry check happens on admission
    stats = eng._stats(0.0)
    assert stats["statuses"][0] == "deadline"
    assert "deadline" in stats["errors"][0]
    assert any(r is not None and r.rid == 1 for r in eng.active)

    eng = _engine()
    req = tserve.Request(rid=0, prompt=[1, 2, 3], max_new=16, deadline_s=1e9)
    eng.submit(req)
    eng._admit()
    eng._decode_once()
    req.deadline_s, req.t_submit = 1e-9, req.t_submit - 100.0
    eng._decode_once()
    assert req.status == "deadline" and len(req.out) >= 2
    assert all(r is None for r in eng.active)
    assert eng.cache["len"].tolist() == [0, 0]   # idle slots pinned
