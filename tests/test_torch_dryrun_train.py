"""The placed train step against the reference's compiled one.

One 4-device JAX subprocess assembles the reference's
``launch/dryrun.py::build_train`` on the ``("data", "model")`` mesh
``(2, 2)`` for each case (``param_specs(train=True)`` at the step's
tokens, ``pure_dp``, ``set_attention_mesh``, ``batch_specs`` with the
model axis carrying batch under ``pure_dp``, ``make_train_step`` with
AdamW, ``jax.jit`` with those shardings), lowers it from ``eval_shape``
and compiles it at ``--xla_backend_optimization_level=0``; its dots are
counted by ``tests/test_torch_dryrun.py``'s traversal (``HLO_DOTS``).
Beside it, in this process, ``launch.dryrun.train_on`` places the same
config on the views test's fake ``(2, 2)`` mesh (``meta`` blocks) and the
op counter runs its step.  No gloo launch.

Both configs run with ``remat=False``: the packages recompute differently
by design (ROADMAP, "Remat").  The budget is the reference's 16 GB (its
``param_specs`` takes no other); at 4 x 16 tokens its cost model already
splits every projection over model, which is what ``TP_BUDGET`` forces in
the port-only tests, and at 2 x 128 tokens llama3.2-1b runs pure data
parallel with a batch of 2 that the 4 devices do not divide.

Under pure data parallelism with a batch the devices do not divide, the
reference's pins hold the batch whole at every layer, and the port's
products, as XLA's, still run on each device's block of it
(``layers._batch_blocks``): the case settles ROADMAP Queue 3's fault 2.

Gates: the sharding decisions equal; the argument bytes equal XLA's
``argument_size_in_bytes`` but for the reference's int32 step counter,
which is a host int in the port (``STEP_BYTES``); the per-device dot
FLOPs within ``DOT_RTOL`` of the HLO's dots from the named gap of
:data:`DOT_GAPS`.  The wire per collective kind is printed, not gated.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here run on meta blocks,
# and beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

import test_torch_dryrun as dry  # noqa: E402
import test_torch_sharding as base  # noqa: E402

pytestmark = pytest.mark.subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (2, 2)
#: the reference's 16 GB and its ``HBM_ELEMS``
BUDGET = {"hbm_bytes": 16e9, "mem_elems": 8 * 1024 ** 3}
# (name, arch, batch, sequence)
CASES = [
    ("llama", "llama3.2-1b", 4, 16),
    ("gemma3", "gemma3-12b", 4, 16),
    ("granite", "granite-moe-1b-a400m", 4, 16),
    # pure data parallelism, a batch the 4 devices do not divide
    ("llama_dp", "llama3.2-1b", 2, 128),
]
IDS = [c[0] for c in CASES]
#: the reference's AdamW step counter: an int32 argument of XLA's step,
#: a host int in the port's state
STEP_BYTES = 4
DOT_RTOL = dry.DOT_RTOL


def _cfg(arch):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True), remat=False)


def _whole_weight_grad(case):
    """The per-device dot FLOPs that XLA's pure data parallel step spends
    and the port's does not.  The reference's residual pin holds a batch
    that the 4 devices do not divide whole at every layer
    (``shard_residual``); XLA still runs every product between two pins
    on each device's block of the batch (over ``data``, which divides
    it), as the port does, but one: at each layer the gradient of one of
    the MLP's input weights (``[d_model, d_ff]``) is a product over the
    whole batch.  From the config: ``2 * B * S * d_model * d_ff`` a
    layer, of which the port computes the share of one data rank."""
    _, arch, b, s = case
    cfg = _cfg(arch)
    return (cfg.n_layers * 2 * b * s * cfg.d_model * cfg.d_ff
            * (1 - 1 / GRID[0]))


#: port - HLO of the per-device dot FLOPs (torch 2.13 on the CPU, jax
#: 0.9).  Every product, forward and backward, runs on each device's
#: share as XLA splits it; under pure data parallelism with a batch the
#: devices do not divide XLA repeats one product more
#: (:func:`_whole_weight_grad`, -)
DOT_GAPS = {c[0]: (-_whole_weight_grad(c) if c[0] == "llama_dp" else 0.0)
            for c in CASES}


_JAX_TRAIN = textwrap.dedent("""
    import dataclasses, functools, json, os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.hlo_analysis import HloModule
    from repro.models import layers as L
    from repro.models.api import model_fns
    from repro.parallel import sharding as shd
    from repro.train.optim import AdamW
    from repro.train.step import TrainState, init_train_state, \\
        make_train_step
    cases, grid = json.loads(sys.argv[2])

    # HLO_DOTS

    mesh = Mesh(np.array(jax.devices()).reshape(grid), ("data", "model"))
    # imported once the 4 devices are up: the module asks for 512
    from repro.launch.dryrun import _loss_dispatch, parse_collectives
    out = {}
    for name, arch, b, s in cases:
        # launch/dryrun.py::build_train's assembly at this batch
        cfg = dataclasses.replace(get_config(arch, smoke=True), remat=False)
        fns = model_fns(cfg)
        batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((b, s), jnp.int32)}
        params_shape = jax.eval_shape(
            lambda: fns.init(jax.random.PRNGKey(0), cfg))
        pspecs = shd.param_specs(cfg, params_shape, mesh,
                                 tokens_per_step=b * s)
        decisions = dict(shd.param_specs.last_decisions)
        dp_all = shd.pure_dp(decisions)
        L.set_attention_mesh(
            mesh, ("pod", "data", "model") if dp_all else ("pod", "data"))
        opt = AdamW(lr=3e-4)
        state_shape = jax.eval_shape(
            lambda: init_train_state(
                jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                             params_shape), opt))
        sspecs = TrainState(
            params=pspecs,
            opt=type(state_shape.opt)(step=P(), m=pspecs, v=pspecs),
            err=None)
        bspecs = shd.batch_specs(cfg, mesh, batch, global_batch=b,
                                 include_model=dp_all)
        step = make_train_step(
            functools.partial(_loss_dispatch, cfg=cfg, fns=fns), opt)
        out_specs = (sspecs, {"loss": P(), "grad_norm": P(), "step": P()})
        jitted = jax.jit(step,
                         in_shardings=(shd.named(mesh, sspecs),
                                       shd.named(mesh, bspecs)),
                         out_shardings=jax.tree.map(
                             lambda x: NamedSharding(mesh, x), out_specs,
                             is_leaf=lambda x: isinstance(x, P)),
                         donate_argnums=0, keep_unused=True)
        compiled = jitted.lower(state_shape, batch).compile()
        text = compiled.as_text()
        L.set_attention_mesh(None)
        out[name] = {
            "decisions": decisions, "dp_all": dp_all,
            "argument_size_in_bytes":
                compiled.memory_analysis().argument_size_in_bytes,
            "dot_flops": dots(HloModule(text)),
            "collectives": parse_collectives(text)}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""").replace("# HLO_DOTS\n", dry.HLO_DOTS)


def _port(case, mesh):
    """The port's placed train step of ``case`` under the op counter."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.shapes import sds
    from repro_torch.models import layers as L
    _, arch, b, s = case
    batch = {"tokens": sds((b, s), torch.int32),
             "labels": sds((b, s), torch.int32)}
    try:
        built = dryrun.train_on(_cfg(arch), mesh, batch, **BUDGET)
        stats = analyze(built.step, built.args)
    finally:
        L.set_attention_mesh(None)
    return {"decisions": built.decisions,
            **{k: stats[k] for k in ("dot_flops", "wire_bytes",
                                     "argument_size_in_bytes")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and, concurrently, the port's steps in this
    process on a fake ``(2, 2)`` mesh."""
    from repro_torch.dist.collectives import make_mesh
    from repro_torch.dist.spawn import end_world, fake_world
    out = str(tmp_path_factory.mktemp("torch_dryrun_train") / "jax.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with base.launch_slot():
        ref = subprocess.Popen(
            [sys.executable, "-c", _JAX_TRAIN, out,
             json.dumps([CASES, GRID])],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        try:
            fake_world(GRID[0] * GRID[1])
            try:
                mesh = make_mesh(GRID, ("data", "model"), device="cpu")
                port = {c[0]: _port(c, mesh) for c in CASES}
            finally:
                end_world()
            _, err = ref.communicate(timeout=600)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    assert ref.returncode == 0, err
    with open(out) as f:
        return {"port": port, "jax": json.load(f)}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_train_decisions_equal(runs, case):
    """The same sharding decisions, pure data parallelism included."""
    got, want = runs["port"][case[0]], runs["jax"][case[0]]
    assert got["decisions"] == want["decisions"]
    assert (case[0] == "llama_dp") == want["dp_all"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_train_argument_bytes_equal_xla(runs, case):
    """Per device, the placed parameters, both AdamW moments and the batch
    hold XLA's argument bytes, but for the step counter."""
    got, want = runs["port"][case[0]], runs["jax"][case[0]]
    assert got["argument_size_in_bytes"] == \
        want["argument_size_in_bytes"] - STEP_BYTES


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_train_dot_flops_near_hlo(runs, case):
    """Per-device dot FLOPs of the whole train step (the forward, the
    backward, the update) against the dots of the reference's compiled
    ``build_train``: within ``DOT_RTOL`` of the HLO's dots from the named
    gap of :data:`DOT_GAPS`."""
    name = case[0]
    got, want = runs["port"][name], runs["jax"][name]
    gap = got["dot_flops"] - want["dot_flops"]
    print(json.dumps({"case": name, "port_dot_flops": got["dot_flops"],
                      "hlo_dot_flops": want["dot_flops"], "gap": gap,
                      "want_gap": DOT_GAPS[name],
                      "port_wire": got["wire_bytes"],
                      "hlo_wire": want["collectives"]["wire_bytes"]}))
    assert abs(gap - DOT_GAPS[name]) <= DOT_RTOL * want["dot_flops"]
