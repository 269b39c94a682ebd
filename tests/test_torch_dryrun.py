"""The placed serve steps and the dry run's op counter, against one rank
and against the JAX package's ``launch/dryrun.py`` builders.

One 4-rank gloo launch serves the smoke llama, granite-moe, zamba2 (the
hybrid family: K/V rows, conv contexts and SSD states) and whisper (the
encoder-decoder: cross K/V) in f32 on the ``("data", "model")`` mesh
``(2, 2)``: ``train.step.place_serve`` places the parameters (serving
specs at the builder's tokens per step), the cache (``cache_specs``: the
K/V sequence over model) and the inputs, then a prefill and three decode
steps run on the placed state, the first step of each kind under
``launch.op_analysis.analyze``.  The budget is the reference's (16 GB,
``HBM_ELEMS``), passed as the GSPMD tests pass it.  Beside it, one
4-device JAX subprocess runs the reference's ``build_prefill`` /
``build_decode`` assembly (``param_specs(train=False)``,
``set_attention_mesh``, ``cache_specs``, ``batch_specs``, ``jax.jit``
with those shardings) on the same weights and inputs, executed, and reads
each compiled program with ``analyze_hlo``; its programs are compiled at
``--xla_backend_optimization_level=0``.  Then, in process, one
full-width cell: llama3.2-1b ``train_4k`` on the fake 16x16 mesh.

Tolerances: the logits and every cache leaf within 1e-5 of max|x| of one
rank's plain prefill and decode (two mesh dims sum partial products in
another order), within 1e-4 of max|logit| of the reference's (the
packages round in other places).  The op counter: argument bytes equal
to XLA's ``argument_size_in_bytes`` (compiled with ``keep_unused=True``:
the reference's builders let jit drop the arguments a step never reads,
such as a decode step's encoder weights, which the port's placed state
holds all the same), model FLOPs equal, dot FLOPs within ``DOT_RTOL`` of
each named gap to the HLO's dots (:data:`DOT_GAPS`).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

import test_torch_sharding as base  # noqa: E402

pytestmark = pytest.mark.subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN_RTOL = 1e-5
JAX_RTOL = 1e-4
GRID = (2, 2)
# (name, arch, batch, prompt, max_seq, frames, decode steps)
CASES = [
    ("llama", "llama3.2-1b", 4, 8, 16, 0, 3),
    ("granite", "granite-moe-1b-a400m", 4, 8, 16, 0, 3),
    ("zamba2", "zamba2-7b", 4, 8, 16, 0, 3),
    ("whisper", "whisper-tiny", 4, 8, 16, 16, 3),
]
IDS = [c[0] for c in CASES]


def _cfg(arch):
    return dataclasses.replace(base.get_config(arch, smoke=True),
                               dtype="float32")


def _inputs(case, vocab, d_model):
    name, _, b, s, _, frames, steps = case
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
           "dec": rng.integers(0, vocab, (b, steps)).astype(np.int32)}
    if frames:
        out["frames"] = rng.standard_normal(
            (b, frames, d_model)).astype(np.float32)
    return out


def _flat_t(tree, prefix=""):
    """``(path, tensor)`` of every leaf of a tree of dicts, the paths the
    reference's ``_path_str`` gives (``None`` subtrees left out)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_t(v, f"{prefix}{k}/")
        elif v is not None:
            yield prefix + k, v


def _serve(case, params_np, mesh=None, budget=None):
    """Prefill and the decode steps of ``case``: plain on one rank, or on
    state placed by ``place_serve`` on ``mesh`` (re-placed for decode at
    its own tokens per step), each placed step under the op counter."""
    from torch.utils import _pytree as pytree

    from repro_torch.dist import collectives as C
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.models import layers as L
    from repro_torch.models.api import model_fns
    from repro_torch.train.step import place_serve, serve_step

    name, arch, b, s, max_seq, frames, steps = case
    cfg = _cfg(arch)
    params = base._convert(params_np, cfg)
    inp = {k: torch.from_numpy(v) for k, v in
           _inputs(case, cfg.vocab, cfg.d_model).items()}
    kw = {"enc_len": frames} if frames else {}
    cache = model_fns(cfg).init_cache(cfg, b, max_seq, device="cpu", **kw)
    pre_in = {"tokens": inp["tokens"]}
    if frames:
        pre_in["frames"] = inp["frames"]
    out = {"logits": []}
    keep = ("flops", "dot_flops", "hbm_bytes", "wire_bytes", "coll_counts",
            "total_wire_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "temp_size_in_bytes")

    def run(kind, args_cache, step_in, tokens_per_step):
        step = serve_step(cfg, kind)
        if mesh is None:
            return step(params, args_cache, step_in)
        try:
            pl = place_serve(cfg, mesh, params, args_cache, step_in,
                             tokens_per_step=tokens_per_step, **budget)
            args = (pl.params, pl.cache, pl.inputs)
            if kind in out:     # the first step of a kind is counted
                logits, new = step(*args)
            else:
                stats = analyze(step, args)
                out[kind] = {"decisions": pl.decisions, "dp_all": pl.dp_all,
                             **{k: stats[k] for k in keep}}
                logits, new = stats["out"]
            return (C.full_tensor(logits),
                    pytree.tree_map(C.full_tensor, new))
        finally:
            L.set_attention_mesh(None)

    logits, cache = run("prefill", cache, pre_in, b * s)
    out["logits"].append(logits.numpy())
    # copies: the plain steps write the cache in place
    out["prefill_cache"] = {k: v.numpy().copy() for k, v in _flat_t(cache)}
    for i in range(steps):
        logits, cache = run("decode", cache,
                            {"tokens": inp["dec"][:, i:i + 1]}, b)
        out["logits"].append(logits.numpy())
    out["cache"] = {k: v.numpy() for k, v in _flat_t(cache)}
    return out


def gloo_rank(rank, params, cases, budget):
    from repro_torch.dist import collectives as C
    torch.set_num_threads(1)
    mesh = C.make_mesh(GRID, ("data", "model"), device="cpu")
    return {c[0]: _serve(c, params[c[1]], mesh, budget) for c in cases}


#: the dots' FLOPs of a compiled module by ``analyze_hlo``'s traversal:
#: loops times their trips, a conditional's larger branch, fusions and
#: calls (``dots(HloModule(text))``); pasted into the JAX subprocesses
#: here and in ``tests/test_torch_dryrun_train.py``
HLO_DOTS = textwrap.dedent("""
    from repro.launch.hlo_analysis import (
        _BRANCHES_RE, _CALLS_RE, _TO_APPLY_RE, _WHILE_RE, _dot_flops)

    def dots(mod, comp=None, memo=None):
        comp = comp or mod.entry
        memo = {} if memo is None else memo
        if comp in memo:
            return memo[comp]
        memo[comp] = 0.0
        tab, total = mod._symtab(comp), 0.0
        for op in mod.comps.get(comp, []):
            oc = op.opcode
            if oc == "dot":
                total += _dot_flops(mod, op, tab)
            elif oc == "while":
                m = _WHILE_RE.search(op.rest)
                if m:
                    trips = mod._trip_count(m.group(1))
                    total += (dots(mod, m.group(1), memo) * (trips + 1)
                              + dots(mod, m.group(2), memo) * trips)
            elif oc == "conditional":
                m = _BRANCHES_RE.search(op.rest)
                if m:
                    total += max(dots(mod, c.strip().lstrip("%"), memo)
                                 for c in m.group(1).split(","))
            elif oc in ("call", "async-start", "fusion"):
                m = _CALLS_RE.search(op.rest) or _TO_APPLY_RE.search(
                    op.rest)
                if m:
                    total += dots(mod, m.group(1), memo)
        memo[comp] = total
        return total
""")

_JAX_SERVE = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.hlo_analysis import HloModule, analyze_hlo
    from repro.models import layers as L
    from repro.models.api import model_fns
    from repro.parallel import sharding as shd
    inp = dict(np.load(sys.argv[1]))
    cases, grid = json.loads(sys.argv[3])
    out, meta = {}, {}

    def unflat(prefix):
        tree = {}
        for key, v in inp.items():
            if not key.startswith(prefix + "|"):
                continue
            *path, leaf = key.split("|", 1)[1].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return tree

    # HLO_DOTS

    mesh = Mesh(np.array(jax.devices()).reshape(grid), ("data", "model"))
    # imported once the 4 devices are up: the module asks for 512
    from repro.launch.dryrun import parse_collectives
    for name, arch, b, s, max_seq, frames, steps in cases:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        fns = model_fns(cfg)
        params = unflat(arch)
        kw = {"enc_len": frames} if frames else {}
        cache = fns.init_cache(cfg, b, max_seq, **kw)
        toks = jnp.asarray(inp[name + "|tokens"])
        dec = jnp.asarray(inp[name + "|dec"])
        logits_all, info = [], {}

        # launch/dryrun.py::build_prefill / build_decode's assembly
        def build(kind, tokens_per_step, batch_in, cache):
            pspecs = shd.param_specs(cfg, params, mesh,
                                     tokens_per_step=tokens_per_step,
                                     train=False)
            decisions = dict(shd.param_specs.last_decisions)
            dp_all = shd.pure_dp(decisions)
            L.set_attention_mesh(
                mesh, ("pod", "data", "model") if dp_all else ("pod", "data"))
            cspecs = shd.cache_specs(cfg, mesh, cache, batch=b,
                                     include_model=dp_all)
            ispecs = shd.batch_specs(cfg, mesh, batch_in, global_batch=b,
                                     include_model=dp_all)
            if kind == "decode":
                def fn(p, c, bt):
                    return fns.decode_step(p, cfg, c, bt["tokens"])
            elif cfg.family == "encdec":
                def fn(p, c, bt):
                    return fns.prefill(p, cfg, c, bt["frames"],
                                       bt["tokens"])
            else:
                def fn(p, c, bt):
                    return fns.prefill(p, cfg, c, bt["tokens"])
            jitted = jax.jit(
                fn, in_shardings=(shd.named(mesh, pspecs),
                                  shd.named(mesh, cspecs),
                                  shd.named(mesh, ispecs)),
                out_shardings=(NamedSharding(mesh, P()),
                               shd.named(mesh, cspecs)),
                keep_unused=True)
            compiled = jitted.lower(params, cache, batch_in).compile()
            text = compiled.as_text()
            static = analyze_hlo(text)
            mem = compiled.memory_analysis()
            info[kind] = {
                "decisions": decisions, "dp_all": dp_all,
                "argument_size_in_bytes": mem.argument_size_in_bytes,
                "flops": static["flops"], "dot_flops": dots(HloModule(text)),
                "hbm_bytes": static["hbm_bytes"],
                "collectives": parse_collectives(text),
                "model_flops_per_device": 2 * cfg.active_param_count()
                * tokens_per_step / 4}
            L.set_attention_mesh(None)
            return compiled

        pre_in = {"tokens": toks}
        if frames:
            pre_in["frames"] = jnp.asarray(inp[name + "|frames"])
        logits, cache = build("prefill", b * s, pre_in, cache)(
            params, cache, pre_in)
        logits_all.append(np.asarray(logits))
        for key, v in jax.tree_util.tree_flatten_with_path(cache)[0]:
            out[name + "|prefill_cache|" + shd._path_str(key)] = np.asarray(v)
        decode = build("decode", b, {"tokens": dec[:, :1]}, cache)
        for i in range(steps):
            logits, cache = decode(params, cache, {"tokens": dec[:, i:i + 1]})
            logits_all.append(np.asarray(logits))
        for key, v in jax.tree_util.tree_flatten_with_path(cache)[0]:
            out[name + "|cache|" + shd._path_str(key)] = np.asarray(v)
        for i, lg in enumerate(logits_all):
            out[f"{name}|logits|{i}"] = lg
        meta[name] = info
    out["meta"] = np.asarray(json.dumps(meta))
    np.savez(sys.argv[2], **out)
""").replace("# HLO_DOTS\n", HLO_DOTS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank gloo launch, the one-rank plain runs and, concurrently,
    the 4-device JAX subprocess."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.api import model_fns as jmodel_fns
    from repro.parallel import sharding as jshd
    from repro_torch.dist.spawn import run_spmd

    archs = sorted({c[1] for c in CASES})
    jcfgs = {a: dataclasses.replace(jget(a, smoke=True), dtype="float32")
             for a in archs}
    params = {a: jax.tree_util.tree_map(np.asarray, jmodel_fns(c).init(
        jax.random.PRNGKey(0), c)) for a, c in jcfgs.items()}
    tmp = tmp_path_factory.mktemp("torch_dryrun")
    npz = {f"{a}|{k}": v for a in archs
           for k, v in base._flat(params[a]).items()}
    for case in CASES:
        cfg = _cfg(case[1])
        for k, v in _inputs(case, cfg.vocab, cfg.d_model).items():
            npz[f"{case[0]}|{k}"] = v
    in_path, jax_out = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    np.savez(in_path, **npz)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    budget = {"hbm_bytes": 16e9, "mem_elems": jshd.HBM_ELEMS}
    with base.launch_slot():
        ref = subprocess.Popen(
            [sys.executable, "-c", _JAX_SERVE, in_path, jax_out,
             json.dumps([CASES, GRID])],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        try:
            port = run_spmd(gloo_rank, 4, params, CASES, budget,
                            device="cpu")
            plain = {c[0]: _serve(c, params[c[1]]) for c in CASES}
            _, err = ref.communicate(timeout=600)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    assert ref.returncode == 0, err
    jax_npz = dict(np.load(jax_out))
    return {"port": port, "plain": plain, "jax": jax_npz,
            "meta": json.loads(str(jax_npz.pop("meta")))}


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_placed_serve_matches_one_rank(runs, case):
    """Every rank's logits (prefill, then each decode step) and every
    cache leaf after the prefill and after the last step equal one rank's
    plain serve."""
    want = runs["plain"][case[0]]
    for rank_out in runs["port"]:
        got = rank_out[case[0]]
        assert len(got["logits"]) == len(want["logits"]) == 1 + case[6]
        for g, w in zip(got["logits"], want["logits"]):
            assert _rel(g, w) <= PLAIN_RTOL
        for key in ("prefill_cache", "cache"):
            assert got[key].keys() == want[key].keys()
            for leaf, w in want[key].items():
                assert _rel(got[key][leaf], w) <= PLAIN_RTOL, (key, leaf)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_placed_serve_matches_jax_builders(runs, case):
    """The logits and the final cache against the reference's executed
    ``build_prefill`` / ``build_decode``, and the same sharding decisions
    for each builder."""
    name = case[0]
    got = runs["port"][0][name]
    for i, g in enumerate(got["logits"]):
        assert _rel(g, runs["jax"][f"{name}|logits|{i}"]) <= JAX_RTOL, i
    for key in ("prefill_cache", "cache"):
        for leaf, g in got[key].items():
            if leaf == "len":
                assert int(g) == int(runs["jax"][f"{name}|{key}|{leaf}"])
                continue
            assert _rel(g, runs["jax"][f"{name}|{key}|{leaf}"]) \
                <= JAX_RTOL, (key, leaf)
    for kind in ("prefill", "decode"):
        assert got[kind]["decisions"] == runs["meta"][name][kind][
            "decisions"]
        assert got[kind]["dp_all"] == runs["meta"][name][kind]["dp_all"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_argument_bytes_equal_xla(runs, case, kind):
    """Per device, the placed parameters, cache and inputs the op counter
    reads hold as many bytes as XLA's arguments of the reference's
    compiled builder; and the useful (model) FLOPs per device agree."""
    from repro_torch.launch.dryrun import model_flops
    name = case[0]
    ref = runs["meta"][name][kind]
    for rank_out in runs["port"]:
        assert rank_out[name][kind]["argument_size_in_bytes"] == \
            ref["argument_size_in_bytes"]
    tokens = case[2] * (case[3] if kind == "prefill" else 1)
    assert model_flops(_cfg(case[1]), kind, tokens, 4) == \
        ref["model_flops_per_device"]


def _cond_dots(case, kind):
    """The per-device dot FLOPs that XLA's count of the reference's
    hybrid step holds and the run does not: its traversal takes the
    shared block's ``lax.cond`` at its larger branch at every scanned
    layer, where the block runs at ``n_layers // attn_every`` of them.
    From the config: the block's products (wq, wk, wv, wo; the MLP; the
    scores and their values against the prompt, or against the cache's
    ``max_seq`` keys in decode), split over the 4 devices (batch over
    data, heads and the MLP's columns over model), times the layers at
    which it does not run."""
    _, arch, b, s, max_seq, _, _ = case
    cfg = _cfg(arch)
    tokens, q_len, k_len = ((b * s, s, s) if kind == "prefill"
                            else (b, 1, max_seq))
    h, g, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    gated = cfg.mlp_act in ("swiglu", "geglu")
    block = (2 * tokens * d * (2 * h + 2 * g) * hd
             + 2 * tokens * d * cfg.d_ff * (3 if gated else 2)
             + 2 * 2 * b * h * q_len * k_len * hd)
    idle = cfg.n_layers - cfg.n_layers // cfg.attn_every
    return idle * block / 4


#: port - HLO of the per-device dot FLOPs on these cells (torch 2.13 on
#: the CPU, jax 0.9).  Every product runs on each device's share, as
#: XLA splits it: llama, granite (the MoE's router, top-k and one-hots
#: on each rank's tokens, the dispatch and combine products over E split
#: by model and, in decode, the combine's tokens over data), whisper
#: (the encoder's and the decoder's residual sequence-split at each
#: sub-block), zamba2 (the chunked recurrence's heads over model, the
#: Mamba2 in-projections on tokens whole over model with ``w_B`` /
#: ``w_C`` cut to their columns).  What stays is zamba2's ``cond`` term
#: (:func:`_cond_dots`), which XLA counts and the run does not (-).
DOT_GAPS = {(c[0], kind): (-_cond_dots(c, kind) if c[0] == "zamba2"
                           else 0.0)
            for c in CASES for kind in ("prefill", "decode")}
DOT_RTOL = 0.01   # of the HLO's dots, around each gap


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dot_flops_near_hlo(runs, case, kind):
    """Per-device dot FLOPs against the dots of the reference's compiled
    builder (``analyze_hlo``'s traversal): within ``DOT_RTOL`` of the
    HLO's dots from the named gap of :data:`DOT_GAPS`.  The wire per
    collective kind is printed beside its ``parse_collectives``, not
    gated: XLA and DTensor choose their own collectives."""
    name = case[0]
    ref = runs["meta"][name][kind]
    got = runs["port"][0][name][kind]
    gap = got["dot_flops"] - ref["dot_flops"]
    print(json.dumps({"case": name, "kind": kind,
                      "port_dot_flops": got["dot_flops"],
                      "hlo_dot_flops": ref["dot_flops"], "gap": gap,
                      "want_gap": DOT_GAPS[name, kind],
                      "port_wire": got["wire_bytes"],
                      "hlo_wire": ref["collectives"]["wire_bytes"]}))
    assert abs(gap - DOT_GAPS[name, kind]) <= DOT_RTOL * ref["dot_flops"]


def test_full_width_fake_cell(tmp_path):
    """llama3.2-1b ``train_4k`` at full width on the fake 16x16 mesh,
    under the reference's 16 GB budget: the record carries the
    reference's keys, and its per-device argument bytes equal those the
    reference's ``param_specs`` and ``batch_specs`` give (the parameters
    and both AdamW moments, f32, and the batch; the reference's int32
    step counter is a host int in the port)."""
    import jax

    from repro.configs import get_config as jget
    from repro.launch import shapes as jshapes
    from repro.models.api import model_fns as jfns
    from repro.parallel import sharding as jshd
    from repro_torch.dist.spawn import end_world
    from repro_torch.launch import dryrun
    from conftest import make_abstract_mesh

    try:
        rec = dryrun.run_cell("llama3.2-1b", "train_4k", multi_pod=False,
                              out_dir=str(tmp_path), device="cpu",
                              memory={"hbm_bytes": 16e9,
                                      "mem_elems": jshd.HBM_ELEMS})
    finally:
        end_world()
    for key in ("status", "flops_per_device", "bytes_per_device",
                "collectives", "memory_analysis", "roofline_compute_s",
                "roofline_memory_s", "roofline_collective_s", "dominant",
                "model_flops_per_device", "useful_flops_ratio",
                "tp_decisions"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["trace_s"] >= 0
    cfg = jget("llama3.2-1b")
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    shapes = jax.eval_shape(lambda: jfns(cfg).init(jax.random.PRNGKey(0),
                                                   cfg))
    sp = jshapes.SHAPES["train_4k"]
    pspecs = jshd.param_specs(cfg, shapes, mesh,
                              tokens_per_step=sp.global_batch * sp.seq_len)
    batch = jshapes.input_specs(cfg, "train_4k")
    bspecs = jshd.batch_specs(cfg, mesh, batch,
                              global_batch=sp.global_batch,
                              include_model=jshd.pure_dp(
                                  jshd.param_specs.last_decisions))

    def local(leaf, spec, itemsize):
        parts = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                parts *= sizes[a]
        return int(np.prod(leaf.shape)) // parts * itemsize

    P = jax.sharding.PartitionSpec
    flat = jax.tree_util.tree_leaves(shapes)
    specs = jax.tree_util.tree_leaves(pspecs,
                                      is_leaf=lambda x: isinstance(x, P))
    want = sum(local(x, s, x.dtype.itemsize) + 2 * local(x, s, 4)
               for x, s in zip(flat, specs))
    want += sum(local(batch[k], bspecs[k], batch[k].dtype.itemsize)
                for k in batch)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    assert rec["tp_decisions"] == dict(jshd.param_specs.last_decisions)
