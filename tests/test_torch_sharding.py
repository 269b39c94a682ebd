"""The GSPMD sharding rules (``parallel/sharding.py``), the pins and the
``mode="gspmd"`` train step on placed state, against the JAX package.

The rules run in process against ``repro.parallel.sharding`` on abstract
meshes (no device): every config at full width, its shapes from
``param_shapes`` (meta tensors, no storage) and the reference's from
``jax.eval_shape``, both under the reference's memory constants
(``HBM_ELEMS`` and its 16 GB), which the port's functions take as
arguments.  A port leaf's spec is the reference's stacked spec without the
leading layer entry.

The step: one 4-rank gloo launch trains the smoke llama and granite-moe
(f32) under ``mode="gspmd"`` for two AdamW steps on the ``("data",
"model")`` mesh ``(2, 2)``.  ``tests/test_torch_gspmd_step.py`` runs
``(1, 4)`` and ``(4, 1)``, and ``tests/test_torch_gspmd_flash.py`` the
pinned flash branch, with these helpers: DTensor plans each new
placement and shape once per process, the first time (most of a
launch's time), so the cases are split across files and so across the
workers.  One 4-device JAX subprocess runs the reference's
GSPMD step as ``launch/dryrun.py::build_train`` assembles it
(``param_specs``, ``set_attention_mesh``, ``batch_specs``, ``jax.jit``
with those shardings), executed, concurrently; its programs are compiled
at LLVM optimization level 0 (``--xla_backend_optimization_level=0``),
which takes 40% less compile time on these small programs.  The weights are the
reference's draws (each family's ``init``), converted by
``models/convert.py``; the encdec's batches carry frames.
Tolerances: each step's loss within 1e-4 relative and the step-1
gradients within 1e-3 of max|g| per tensor, of both the port's one-rank
plain step and the reference's GSPMD step (a ``Partial`` over two mesh
dims is summed in another order than one rank's sums).
"""

import contextlib
import dataclasses
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

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.parallel import sharding as tshd  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
LR = 1e-2

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


def _budget():
    """The reference's memory constants: its 16 GB and ``HBM_ELEMS``."""
    from repro.parallel import sharding as jshd
    return {"hbm_bytes": 16e9, "mem_elems": jshd.HBM_ELEMS}


# ------------------------------------------------------------ the rules --

@pytest.mark.parametrize("args", [
    (1 << 20, 256, 256, 16, 16, 1, True, 1 << 62),
    (1 << 20, 4096, 16384, 16, 16, 1, True, 10 ** 6),
    (128, 8192, 29568, 16, 16, 1, False, 1 << 62),
    (128, 1 << 15, 1 << 15, 16, 16, 1, False, 1 << 62),
    (4096, 2048, 8192, 16, 16, 2, True, 1 << 30),
    (64, 64, 128, 2, 2, 1, True, 1 << 62),
])
def test_decide_matches_reference(args):
    from repro.parallel import sharding as jshd
    assert tshd._decide(*args, _budget()["mem_elems"]) == \
        jshd._decide(*args)


def _ref_specs(arch, mesh, tokens, train, fake_mesh):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as jget
    from repro.models.api import model_fns
    from repro.parallel import sharding as jshd
    cfg = jget(arch)
    fns = model_fns(cfg)
    shapes = jax.eval_shape(lambda: fns.init(jax.random.PRNGKey(0), cfg))
    amesh = fake_mesh(tuple(mesh.values()), tuple(mesh))
    specs = jshd.param_specs(cfg, shapes, amesh, tokens_per_step=tokens,
                             train=train)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return ({jshd._path_str(p): tuple(s) for p, s in flat},
            dict(jshd.param_specs.last_decisions))


@pytest.mark.parametrize("train", [True, False], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, train, fake_mesh):
    """Every leaf's spec and every decision at full width, and every
    sharded dim divides."""
    tokens = (1 << 20) if train else 128
    want, want_dec = _ref_specs(arch, mesh, tokens, train, fake_mesh)
    cfg = get_config(arch)
    shapes = tshd.param_shapes(cfg)
    specs = tshd.param_specs(cfg, shapes, mesh, tokens_per_step=tokens,
                             train=train, **_budget())
    assert tshd.param_specs.last_decisions == want_dec
    seen = set()
    for (name, n_layers, leaf), spec in zip(
            tshd._leaves(shapes), tshd.flat_specs(specs)):
        ref = want[name]
        assert spec == (ref[1:] if n_layers else ref), name
        seen.add(name)
        for dim, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else entry or ()
            assert leaf.shape[dim] % int(np.prod(
                [mesh[a] for a in axes])) == 0, (name, spec)
    assert seen == set(want)


@pytest.mark.parametrize("arch,vocab", [("granite-moe-1b-a400m", 49155),
                                        ("whisper-tiny", 51865)])
def test_vocab_fallback_shards_d_model(arch, vocab, fake_mesh):
    """A vocabulary the model axis does not divide: both embeddings shard
    their d_model dim instead, as the reference's."""
    mesh = {"data": 16, "model": 16}
    want, _ = _ref_specs(arch, mesh, 4096, True, fake_mesh)
    cfg = get_config(arch)
    assert cfg.vocab == vocab and vocab % 16
    specs = tshd.param_specs(cfg, tshd.param_shapes(cfg), mesh,
                             tokens_per_step=4096, **_budget())
    assert specs["emb"]["lm_head"] == want["emb/lm_head"] == ("model", None)
    assert specs["emb"]["tok"] == want["emb/tok"] == (None, "model")


def test_pure_dp_and_dp_axes():
    from repro.parallel import sharding as jshd
    for d in ({"a": "bhw", "b": "bhw"}, {"a": "bhw", "b": "k"}, {}):
        assert tshd.pure_dp(d) == jshd.pure_dp(d)
    mesh = {"pod": 2, "data": 16, "model": 1}
    assert tshd.dp_axes(mesh) == ("pod", "data")
    assert tshd.dp_axes(mesh, include_model=True) == ("pod", "data")
    assert tshd.dp_axes({"data": 4, "model": 2}, include_model=True) == \
        ("data", "model")


@pytest.mark.parametrize("mesh,batch,include_model", [
    ({"pod": 2, "data": 16, "model": 16}, 256, False),
    ({"data": 16, "model": 16}, 1, False),
    ({"data": 16, "model": 16}, 64, True),
    ({"data": 4, "model": 2}, 2, True),
])
def test_batch_and_cache_specs_match_reference(mesh, batch, include_model,
                                               fake_mesh):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    from repro.parallel import sharding as jshd
    from repro_torch.models import lm as tlm
    amesh = fake_mesh(tuple(mesh.values()), tuple(mesh))
    jb = {"tokens": jax.ShapeDtypeStruct((batch, 4096), jnp.int32),
          "labels": jax.ShapeDtypeStruct((batch, 4096), jnp.int32)}
    tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
    want = jshd.batch_specs(jget("llama3.2-1b"), amesh, jb,
                            global_batch=batch, include_model=include_model)
    got = tshd.batch_specs(get_config("llama3.2-1b"), mesh, tb,
                           global_batch=batch, include_model=include_model)
    assert got == {k: tuple(v) for k, v in want.items()}
    jcache = jax.eval_shape(lambda: jlm.init_cache(jget("llama3.2-1b"),
                                                   max(batch, 128), 32768))
    tcache = tlm.init_cache(get_config("llama3.2-1b"), max(batch, 128),
                            32768, device="meta")
    want = jshd.cache_specs(jget("llama3.2-1b"), amesh, jcache,
                            batch=max(batch, 128),
                            include_model=include_model)
    got = tshd.cache_specs(get_config("llama3.2-1b"), mesh, tcache,
                           batch=max(batch, 128),
                           include_model=include_model)
    assert got == {k: tuple(v) for k, v in want.items()}
    if mesh.get("pod") and not include_model:
        assert got["k"][1:3] == (("pod", "data"), "model")


def _ref_pin(fn, x_shape, monkeypatch):
    """The spec the reference's pin ``fn`` constrains a tensor of
    ``x_shape`` to (its ``with_sharding_constraint`` captured)."""
    import jax
    import jax.numpy as jnp
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    fn(jnp.zeros(x_shape, jnp.float32))
    return seen[0] if seen else None


@pytest.mark.parametrize("mesh,dp", [
    ({"data": 16, "model": 16}, ("pod", "data")),
    ({"pod": 2, "data": 4, "model": 8}, ("pod", "data")),
    ({"data": 4, "model": 4}, ("pod", "data", "model")),
    ({"data": 1, "model": 4}, ("pod", "data")),
])
def test_pin_specs_match_reference(mesh, dp, fake_mesh, monkeypatch):
    """Each pin's spec, ``_model_free`` included (the model axis carrying
    batch under pure data parallelism), at shapes that divide and that
    do not."""
    from repro.models import layers as JL
    from repro.models import moe as jmoe
    amesh = fake_mesh(tuple(mesh.values()), tuple(mesh))
    JL.set_attention_mesh(amesh, dp)
    L.set_attention_mesh(mesh, dp)
    try:
        assert L._model_free() == JL._model_free()
        assert L._dp_size() == JL._dp_size(amesh)
        for shape in [(64, 128, 32, 16), (6, 128, 6, 16), (1, 7, 8, 4)]:
            assert L._heads_spec(shape) == _ref_pin(JL._shard_heads, shape,
                                                    monkeypatch)
            assert L._heads_spec(shape, batch_sharded=False) == _ref_pin(
                lambda x: JL._shard_heads(x, batch_sharded=False), shape,
                monkeypatch)
            assert tmoe._dispatch_spec(shape) == _ref_pin(
                jmoe._shard_dispatch, shape, monkeypatch)
        for shape in [(64, 128, 32), (6, 7, 32), (16, 4)]:
            assert L._replicate_spec(shape) == _ref_pin(
                JL.replicate_model, shape, monkeypatch)
        for shape in [(64, 128, 32), (6, 7, 32)]:
            assert L._residual_spec(shape) == _ref_pin(
                JL.shard_residual, shape, monkeypatch)
    finally:
        JL.set_attention_mesh(None)
        L.set_attention_mesh(None)


def test_pins_are_the_identity_without_a_mesh():
    x = torch.ones(2, 4, 4, 8)
    assert L._shard_heads(x) is x and L.replicate_model(x) is x
    h = torch.ones(2, 4, 8)
    assert L.shard_residual(h) is h and tmoe._shard_dispatch(x) is x


def test_rules_refuse_an_axis_order_dtensor_cannot_lay_out():
    """``("data", "pod")`` on one dim is not the mesh's order: DTensor
    would lay it out pod-major, JAX data-major."""
    from repro_torch.dist.collectives import placements

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    with pytest.raises(ValueError, match="mesh's order"):
        placements(Mesh(), (("data", "pod"), None))
    with pytest.raises(ValueError, match="lacks"):
        placements(Mesh(), ("expert", None))


# ----------------------------------------------- the step on gloo ranks --

# (name, arch, grid, batch, seq, fsdp, hbm_bytes for the port or None);
# the (1, 4) and (4, 1) cases are in tests/test_torch_gspmd_step.py, the
# pinned flash branch in tests/test_torch_gspmd_flash.py
CASES = [
    ("llama-2x2", "llama3.2-1b", (2, 2), 4, 16, False, None),
    ("granite-2x2", "granite-moe-1b-a400m", (2, 2), 4, 16, False, None),
]
IDS = [c[0] for c in CASES]
LAYOUT_SPECS = [(("data", "model"), None), (None, ("data", "model")),
                ("model", "data"), ("data", None), (None, "model")]


def _cfg(arch, fsdp):
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", fsdp=fsdp)


def _batches(cfg, batch, seq):
    """Two batches of the ported pipeline (the encdec's with frames)."""
    from repro_torch.data import pipeline as tpipe
    ds = tpipe.SyntheticTokens(tpipe.DataConfig(
        global_batch=batch, seq_len=seq, vocab=cfg.vocab, seed=3,
        frames=cfg.family == "encdec", d_model=cfg.d_model))
    return [ds.batch_at(i) for i in range(2)]


def _convert(params_np, cfg):
    """The reference's parameter (or gradient) tree of ``cfg``'s family
    as the port's, by ``models/convert.py``."""
    from repro_torch.models import convert
    fn = {"ssm": convert.ssm_lm_params_from_jax,
          "hybrid": convert.hybrid_params_from_jax,
          "encdec": convert.encdec_params_from_jax}.get(
        cfg.family, convert.lm_params_from_jax)
    return fn(params_np, cfg, device="cpu")


def _layout_input():
    return np.arange(8 * 12, dtype=np.float32).reshape(8, 12)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _plain_run(cfg, params_np, batches, mesh=None, hbm_bytes=None,
               micro=False, nograd=False):
    """Two AdamW steps and the step-1 gradients of the port: plain on one
    rank, or placed by ``place_gspmd`` on ``mesh``.  Returns the losses,
    the gathered step-1 gradients, and (placed) the local and the full
    element count of every parameter with its spec and its gradient's;
    with ``micro``, also the loss and gradient norm of one step of two
    microbatches; with ``nograd``, also the step-1 loss without
    autograd."""
    from torch.utils import _pytree as pytree

    from repro_torch.data.pipeline import to_torch
    from repro_torch.dist import collectives as C
    from repro_torch.models.api import model_fns
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep

    params = _convert(params_np, cfg)
    opt = toptim.AdamW(lr=LR)
    batches = [to_torch(b, "cpu") for b in batches]
    out = {}
    if mesh is not None:
        kw = {} if hbm_bytes is None else {"hbm_bytes": hbm_bytes}
        pl = tstep.place_gspmd(cfg, mesh,
                               tstep.init_train_state(params, opt),
                               batches[0], **kw)
        state = pl.state
        batches = [pl.place_batch(b) for b in batches]
        out["decisions"] = pl.decisions
        flat = pytree.tree_leaves(state.params)
        specs = tshd.flat_specs(pl.param_specs)
        out["elems"] = [(C.local_part(p).numel(), p.numel(), s, C.spec_of(p))
                        for p, s in zip(flat, specs)]
    else:
        state = tstep.init_train_state(params, opt)
    loss_fn = lambda p, b: model_fns(cfg).loss(p, cfg, b)  # noqa: E731
    if nograd:
        region = (C.replicated_region() if mesh is not None
                  else contextlib.nullcontext())
        with torch.no_grad(), region:
            out["nograd_loss"] = float(C.full_tensor(
                loss_fn(state.params, batches[0])))
    with C.record_collectives() as notes, C.count_collectives() as comm:
        _, grads = tstep._value_and_grad(loss_fn, state.params, batches[0],
                                         mesh is not None)
    out["tags"] = sorted({n.tag for n in notes})
    out["comm"] = comm
    out["grads"] = [C.full_tensor(g).numpy()
                    for g in pytree.tree_leaves(grads)]
    if mesh is not None:
        out["grad_specs"] = [C.spec_of(g) for g in pytree.tree_leaves(grads)]
    if micro:
        _, metrics = tstep.make_train_step(loss_fn, opt, n_microbatches=2)(
            state, batches[0])
        out["micro"] = (float(metrics["loss"]), float(metrics["grad_norm"]))
    step = tstep.make_train_step(loss_fn, opt)
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        assert not C.is_placed(metrics["loss"])
    out["losses"] = losses
    return out


def gloo_rank(rank, inputs, cases, micro=(), nograd=()):
    """Every case placed on its mesh; the plain-state refusal; the layout
    of ``place`` at this rank's mesh coordinate.  One thread a rank: the
    smoke models' ops are too small to share, and idle threads spinning
    beside the other test workers only cost time."""
    from repro_torch.data.pipeline import to_torch
    from repro_torch.dist import collectives as C
    from repro_torch.models import lm as tlm
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep

    torch.set_num_threads(1)
    out = {}
    for name, arch, grid, batch, seq, fsdp, hbm in cases:
        cfg = _cfg(arch, fsdp)
        mesh = C.make_mesh(grid, ("data", "model"), device="cpu")
        try:
            out[name] = _plain_run(cfg, inputs[arch], _batches(cfg, batch,
                                                               seq),
                                   mesh, hbm, name in micro,
                                   name in nograd)
        finally:
            L.set_attention_mesh(None)
    cfg = _cfg("llama3.2-1b", False)
    opt = toptim.AdamW(lr=LR)
    step = tstep.make_train_step(lambda p, b: tlm.loss_lm(p, cfg, b), opt)
    state = tstep.init_train_state(
        tlm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu"),
        opt)
    try:
        step(state, to_torch(_batches(cfg, 4, 16)[0], "cpu"))
    except ValueError as e:
        out["refusal"] = str(e)
    mesh = C.make_mesh((2, 2), ("data", "model"), device="cpu")
    x = torch.from_numpy(_layout_input())
    out["coord"] = (C.axis_index(mesh, "data"), C.axis_index(mesh, "model"))
    out["layout"] = [C.local_part(C.place(x, mesh, s)).numpy()
                     for s in LAYOUT_SPECS]
    return out


_JAX_GSPMD = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.models import layers as L
    from repro.models.api import model_fns
    from repro.parallel import sharding as shd
    from repro.train.optim import AdamW, AdamWState
    from repro.train.step import TrainState, init_train_state, make_train_step
    inp = dict(np.load(sys.argv[1]))
    cases, layout_specs, lr = json.loads(sys.argv[3])
    out = {}

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

    for name, arch, grid, batch, seq, fsdp, _ in cases:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32", fsdp=fsdp)
        fns = model_fns(cfg)
        mesh = Mesh(np.array(jax.devices()).reshape(grid), ("data", "model"))
        params = unflat(arch)
        ds = SyntheticTokens(DataConfig(global_batch=batch, seq_len=seq,
                                        vocab=cfg.vocab, seed=3,
                                        frames=cfg.family == "encdec",
                                        d_model=cfg.d_model))
        batches = [{k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
                   for i in range(2)]
        # launch/dryrun.py::build_train's assembly
        pspecs = shd.param_specs(cfg, params, mesh,
                                 tokens_per_step=batch * seq)
        dp_all = shd.pure_dp(shd.param_specs.last_decisions)
        L.set_attention_mesh(
            mesh, ("pod", "data", "model") if dp_all else ("pod", "data"))
        opt = AdamW(lr=lr)
        state = init_train_state(params, opt)
        sspecs = TrainState(params=pspecs,
                            opt=AdamWState(step=P(), m=pspecs, v=pspecs),
                            err=None)
        bspecs = shd.batch_specs(cfg, mesh, batches[0], global_batch=batch,
                                 include_model=dp_all)
        loss_fn = lambda p, b: fns.loss(p, cfg, b)
        mspec = NamedSharding(mesh, P())
        step = jax.jit(make_train_step(loss_fn, opt),
                       in_shardings=(shd.named(mesh, sspecs),
                                     shd.named(mesh, bspecs)),
                       out_shardings=(shd.named(mesh, sspecs),
                                      {"loss": mspec, "grad_norm": mspec,
                                       "step": mspec}))
        grad = jax.jit(jax.grad(loss_fn),
                       in_shardings=(shd.named(mesh, pspecs),
                                     shd.named(mesh, bspecs)),
                       out_shardings=shd.named(mesh, pspecs))
        g = grad(params, batches[0])
        for key, v in jax.tree_util.tree_flatten_with_path(g)[0]:
            out[name + "|grad|" + shd._path_str(key)] = np.asarray(v)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        out[name + "|losses"] = np.asarray(losses)
        L.set_attention_mesh(None)

    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    x = inp["layout"]
    for i, spec in enumerate(layout_specs):
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        arr = jax.device_put(x, NamedSharding(mesh, spec))
        for s in arr.addressable_shards:
            d, m = np.argwhere(mesh.devices == s.device)[0]
            out[f"layout|{i}|{d}|{m}"] = np.asarray(s.data)
    np.savez(sys.argv[2], **out)
""")


#: how many of the port's GSPMD fixtures (a 4-rank gloo launch beside a
#: 4-device JAX subprocess, each ~5 busy processes) run at once across
#: pytest-xdist's workers: one, so that the reference's 8-device
#: subprocess tests running beside them on the other workers keep their
#: share of the host
LAUNCH_SLOTS = 1


@contextlib.contextmanager
def launch_slot():
    """Hold one of :data:`LAUNCH_SLOTS` slots (``flock`` on files in the
    run's temporary directory, which every worker shares) while a fixture
    runs its gloo launch and JAX subprocess.  Under ``-n 6 --dist
    loadfile`` the five such files (``test_torch_sharding.py``,
    ``_gspmd_step``, ``_gspmd_flash``, ``_gspmd_zoo``, ``_dryrun``) sort
    together and start at once, 25 busy processes on the host; each
    fixture then ran 3-6x its time alone (192 s against 56 s for the
    flash case, -n 5 on an 8-core host), near the launch's 600 s limit."""
    import fcntl
    import tempfile
    import time
    paths = [os.path.join(tempfile.gettempdir(),
                          f"repro_torch_gspmd_launch.{i}.lock")
             for i in range(LAUNCH_SLOTS)]
    while True:
        for path in paths:
            f = open(path, "a")
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                f.close()
                continue
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)
                f.close()
            return
        time.sleep(0.5)


def run_cases(tmp_path_factory, cases, micro=(), nograd=()):
    """The 4-rank gloo launch (:func:`gloo_rank`), the one-rank plain runs
    and, concurrently, the 4-device JAX subprocess, for ``cases``; the
    cases named in ``micro`` also take a step of two microbatches, those
    in ``nograd`` a loss without autograd."""
    import json

    import jax

    from repro.configs import get_config as jget
    from repro.models.api import model_fns as jmodel_fns
    from repro_torch.dist.spawn import run_spmd

    archs = sorted({c[1] for c in cases})
    jcfgs = {a: dataclasses.replace(jget(a, smoke=True), dtype="float32")
             for a in archs}
    inputs = {a: jax.tree_util.tree_map(np.asarray, jmodel_fns(c).init(
        jax.random.PRNGKey(0), c)) for a, c in jcfgs.items()}
    tmp = tmp_path_factory.mktemp("torch_gspmd")
    npz = {f"{a}|{k}": v for a in archs for k, v in _flat(inputs[a]).items()}
    npz["layout"] = _layout_input()
    in_path, jax_out = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    np.savez(in_path, **npz)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with launch_slot():
        ref = subprocess.Popen(
            [sys.executable, "-c", _JAX_GSPMD, in_path, jax_out,
             json.dumps([cases, LAYOUT_SPECS, LR])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            port = run_spmd(gloo_rank, 4, inputs, cases, micro, nograd,
                            device="cpu")
            plain = {name: _plain_run(_cfg(arch, fsdp), inputs[arch],
                                      _batches(_cfg(arch, fsdp), batch,
                                               seq),
                                      micro=name in micro,
                                      nograd=name in nograd)
                     for name, arch, _, batch, seq, fsdp, _ in cases}
            _, err = ref.communicate(timeout=600)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    assert ref.returncode == 0, err
    return {"port": port, "plain": plain, "jax": dict(np.load(jax_out))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory, CASES, micro=("llama-2x2",))


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _jax_grads(runs, name, arch, fsdp):
    """The reference's step-1 gradients in the port's leaf order."""
    from torch.utils import _pytree as pytree

    prefix = name + "|grad|"
    tree = _unflat({k[len(prefix):]: v for k, v in runs["jax"].items()
                    if k.startswith(prefix)})
    return [g.numpy() for g in pytree.tree_leaves(
        _convert(tree, _cfg(arch, fsdp)))]


def check_one_rank(runs, case):
    """Two AdamW steps on placed state equal the one-rank plain step on
    every rank: the losses and the gathered step-1 gradients."""
    name = case[0]
    want = runs["plain"][name]
    for rank_out in runs["port"]:
        got = rank_out[name]
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= LOSS_RTOL * abs(b)
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            assert _rel(g, w) <= GRAD_RTOL


def check_jax_gspmd(runs, case):
    """The same against the reference's executed GSPMD step on a 4-device
    mesh (its own decisions: the flash case keeps the default budget)."""
    name, arch, *_, fsdp, _ = case
    want_losses = runs["jax"][name + "|losses"]
    want_grads = _jax_grads(runs, name, arch, fsdp)
    got = runs["port"][0][name]
    for a, b in zip(got["losses"], want_losses):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    for g, w in zip(got["grads"], want_grads):
        assert _rel(g, w) <= GRAD_RTOL


def check_local_blocks(runs, case):
    """Each rank holds the block its spec gives, not a replica: local
    elements are the whole over the product of the spec's axes, the
    placement reads back as the spec, each gradient is placed as its
    parameter, and some parameter is sharded in every case."""
    name, _, grid, *_ = case
    size = {"data": grid[0], "model": grid[1]}
    for rank_out in runs["port"]:
        got = rank_out[name]
        for (local, full, spec, back), gspec in zip(got["elems"],
                                                    got["grad_specs"]):
            parts = 1
            for entry in spec:
                for a in ((entry,) if isinstance(entry, str)
                          else entry or ()):
                    parts *= size[a]
            assert local * parts == full and back == spec == gspec
        assert sum(e[0] for e in got["elems"]) < sum(e[1]
                                                     for e in got["elems"])
    return got["decisions"]


@pytest.mark.subprocess
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gspmd_step_matches_one_rank(runs, case):
    check_one_rank(runs, case)


@pytest.mark.subprocess
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gspmd_step_matches_jax_gspmd(runs, case):
    check_jax_gspmd(runs, case)


@pytest.mark.subprocess
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_local_parameters_are_the_specs_blocks(runs, case):
    check_local_blocks(runs, case)


@pytest.mark.subprocess
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_collectives_are_noted_and_counted(runs, case):
    """The gradient pass on 4 ranks issues collectives (``CommDebugMode``
    counts them) and each gradient's redistribution to its parameter's
    placements is noted under ``gspmd_grad``; the one-rank plain pass
    issues none."""
    name = case[0]
    assert runs["plain"][name]["comm"]["total"] == 0
    for rank_out in runs["port"]:
        got = rank_out[name]
        assert got["comm"]["total"] > 0
        assert "gspmd_grad" in got["tags"]


@pytest.mark.subprocess
def test_microbatches_split_each_ranks_block(runs):
    """``n_microbatches=2`` on placed state (the batch over data, 2 rows a
    rank) splits each rank's block: the step's loss and gradient norm
    equal the one-rank step of two microbatches (the mean of two equal
    halves' means is the batch's mean, whichever rows each half
    holds)."""
    want = runs["plain"]["llama-2x2"]["micro"]
    for rank_out in runs["port"]:
        for got, w in zip(rank_out["llama-2x2"]["micro"], want):
            assert abs(got - w) <= LOSS_RTOL * abs(w)


@pytest.mark.subprocess
def test_plain_state_on_more_ranks_is_refused(runs):
    """On 4 ranks the step builds, and a step on plain parameters raises
    and names the placement function: it would train each rank alone."""
    for rank_out in runs["port"]:
        assert "place_gspmd" in rank_out["refusal"]


@pytest.mark.subprocess
@pytest.mark.parametrize("i", range(len(LAYOUT_SPECS)))
def test_place_layout_matches_jax_shards(runs, i):
    """Rank r's block under a spec equals the JAX shard at r's mesh
    coordinate, ``("data", "model")`` on one dim data-major."""
    for rank_out in runs["port"]:
        d, m = rank_out["coord"]
        np.testing.assert_array_equal(rank_out["layout"][i],
                                      runs["jax"][f"layout|{i}|{d}|{m}"])
