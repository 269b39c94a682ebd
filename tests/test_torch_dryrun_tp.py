"""The placed steps under tensor parallelism on values, with nothing of the
reference: runs on any torch, the card host's too.

One 4-rank gloo launch places every family's smoke config (float32, the
port's own initialisation from a seed) on the ``(2, 2)`` ``("data",
"model")`` mesh at a budget the smoke weights do not fit in, so that the
sharding rules split every projection over model as they do the
full-width cells' (``tests/test_torch_dryrun_views.py``'s
``TP_BUDGET``).  On that state it takes the gradient of one train step
(``place_gspmd``, ``mode="gspmd"``'s ``_value_and_grad``) and serves a
prefill and two decode steps (``place_serve``, ``serve_step``).  Each
rank's loss, gathered gradients, logits and cache equal one rank's plain
run: the loss within ``LOSS_RTOL`` and the gradients within
``GRAD_RTOL`` of ``tests/test_torch_sharding.py``, the logits and every
cache leaf within 1e-5 of max|x| (``tests/test_torch_dryrun.py``), but
xlstm's states within 1e-4: its random sLSTM is chaotic, and the partial
products summed in another order grow along the sequence to 1.06e-5 of
max|h| (``tests/test_torch_gspmd_zoo.py`` runs it at 8 tokens for the
same reason).  So
the tensor-parallel branches of the models (the residual and gradient
pins of ``dist/collectives.py``, the projections' ``_dense_mm``, the
MoE's dispatch and combine) compute the same values on whichever torch
runs this file.

In this process, on the views test's fake ``(2, 2)`` mesh (``meta``
blocks), the op counter then holds each step's per-device dot FLOPs to a
quarter of the same step's on a one-rank mesh, for the families whose
every product the smoke widths let the mesh split: no model rank
repeats a product, a backward's included, that the others split.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread in this process: the plain runs are smoke-sized
torch.set_num_threads(1)

import test_torch_dryrun_views as views  # noqa: E402
import test_torch_sharding as base  # noqa: E402

pytestmark = pytest.mark.subprocess

PLAIN_RTOL = 1e-5
#: the recurrent states of a chaotic random sLSTM (see the docstring)
STATE_RTOL = {"xlstm-350m": 1e-4}
GRID = (2, 2)
BATCH, SEQ, DECODE_STEPS = 4, 8, 2
TP_BUDGET, ARCHS = views.TP_BUDGET, views.ARCHS


def _cfg(arch):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _data(cfg):
    """The train batch and the serve inputs, made from a seed with numpy."""
    rng = np.random.default_rng(11)
    b, s, d = BATCH, SEQ, cfg.d_model

    def ints(*shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape)
                                .astype(np.int32))

    def floats(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))

    batch = {"tokens": ints(b, s), "labels": ints(b, s)}
    serve = {"tokens": batch["tokens"], "dec": ints(b, DECODE_STEPS)}
    if cfg.family == "encdec":
        batch["frames"] = serve["frames"] = floats(b, s, d)
    if cfg.family == "vlm":
        batch["positions"] = torch.arange(s, dtype=torch.int32)[
            None, None].expand(b, 3, s).contiguous()
        batch["vision_embeds"] = floats(b, 2, d)
    return batch, serve


def _run(arch, mesh=None):
    """The loss and gradients of one train step, and the logits and the
    cache of a prefill and :data:`DECODE_STEPS` decode steps: plain, or
    on state placed on ``mesh`` at :data:`TP_BUDGET`."""
    from torch.utils import _pytree as pytree

    from repro_torch.dist import collectives as C
    from repro_torch.models import layers as L
    from repro_torch.models.api import model_fns
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep

    cfg = _cfg(arch)
    fns = model_fns(cfg)
    params = fns.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch, serve = _data(cfg)
    loss_fn = lambda p, b: fns.loss(p, cfg, b)  # noqa: E731
    out = {"logits": []}
    try:
        state, train_batch = tstep.init_train_state(
            params, toptim.AdamW(lr=base.LR)), batch
        if mesh is not None:
            pl = tstep.place_gspmd(cfg, mesh, state, batch, **TP_BUDGET)
            state, train_batch = pl.state, pl.place_batch(batch)
            out["decisions"] = pl.decisions
        loss, grads = tstep._value_and_grad(loss_fn, state.params,
                                            train_batch, mesh is not None)
        out["loss"] = float(C.full_tensor(loss))
        out["grads"] = [C.full_tensor(g).numpy()
                        for g in pytree.tree_leaves(grads)]
        L.set_attention_mesh(None)

        kw = {"enc_len": SEQ} if cfg.family == "encdec" else {}
        cache = fns.init_cache(cfg, BATCH, 2 * SEQ, device="cpu", **kw)
        steps = [("prefill", {k: serve[k] for k in ("tokens", "frames")
                              if k in serve}, BATCH * SEQ)]
        steps += [("decode", {"tokens": serve["dec"][:, i:i + 1]}, BATCH)
                  for i in range(DECODE_STEPS)]
        for kind, inputs, tokens in steps:
            args = (params, cache, inputs)
            if mesh is not None:
                pl = tstep.place_serve(cfg, mesh, params, cache, inputs,
                                       tokens_per_step=tokens, **TP_BUDGET)
                args = (pl.params, pl.cache, pl.inputs)
            logits, cache = tstep.serve_step(cfg, kind)(*args)
            L.set_attention_mesh(None)
            logits, cache = C.full_tensor(logits), pytree.tree_map(
                C.full_tensor, cache)
            out["logits"].append(logits.numpy())
        out["cache"] = {".".join(map(str, k)): v.numpy().copy()
                        for k, v in pytree.tree_flatten_with_path(cache)[0]
                        if isinstance(v, torch.Tensor)}
    finally:
        L.set_attention_mesh(None)
    return out


def gloo_rank(rank, archs):
    from repro_torch.dist import collectives as C
    torch.set_num_threads(1)
    mesh = C.make_mesh(GRID, ("data", "model"), device="cpu")
    return {a: _run(a, mesh) for a in archs}


@pytest.fixture(scope="module")
def runs():
    from repro_torch.dist.spawn import run_spmd
    with base.launch_slot():
        port = run_spmd(gloo_rank, 4, ARCHS, device="cpu")
    return {"port": port, "plain": {a: _run(a) for a in ARCHS}}


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_grads_match_one_rank(runs, arch):
    """The placed train step splits projections over model, and each
    rank's loss and gathered gradients equal one rank's."""
    want = runs["plain"][arch]
    for rank_out in runs["port"]:
        got = rank_out[arch]
        assert set(got["decisions"].values()) & {"k", "c"}, \
            got["decisions"]
        assert abs(got["loss"] - want["loss"]) <= \
            base.LOSS_RTOL * abs(want["loss"])
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            assert _rel(g, w) <= base.GRAD_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_serve_matches_one_rank(runs, arch):
    """Each rank's logits (prefill, then each decode step) and every
    cache leaf after the last step equal one rank's plain serve."""
    want = runs["plain"][arch]
    for rank_out in runs["port"]:
        got = rank_out[arch]
        assert len(got["logits"]) == len(want["logits"]) == 1 + DECODE_STEPS
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            assert _rel(g, w) <= PLAIN_RTOL, i
        assert got["cache"].keys() == want["cache"].keys()
        rtol = STATE_RTOL.get(arch, PLAIN_RTOL)
        for leaf, w in want["cache"].items():
            assert _rel(got["cache"][leaf], w) <= rtol, leaf


@pytest.fixture(scope="module")
def fake_mesh():
    """The views test's fake ``(2, 2)`` mesh in this process (``meta``
    blocks: the op counter counts, nothing is computed)."""
    from repro_torch.dist.collectives import make_mesh
    from repro_torch.dist.spawn import end_world, fake_world
    fake_world(GRID[0] * GRID[1])
    try:
        yield make_mesh(GRID, ("data", "model"), device="cpu")
    finally:
        end_world()


#: the families whose every product the model axis divides at the smoke
#: widths (xlstm's sLSTM, kept whole over model, and a MoE's single token
#: group, which the data axis does not divide, leave products whole on
#: every model rank)
SPLIT_ARCHS = ["llama3.2-1b", "gemma3-12b", "gemma3-4b", "zamba2-7b",
               "whisper-tiny", "qwen2-vl-72b"]
#: the families whose heads the model axis does not divide (smollm's 3):
#: the attention core runs whole over model, its projections still split
HEADS_WHOLE = ["smollm-360m"]


def _projections(sites: dict) -> float:
    """The dot FLOPs of the projections, the MLPs and the vocabulary head
    (``_dense_mm``) and of their backward products (``MmBackward0``)."""
    return sum(v for k, v in sites.items()
               if re.search(r"_dense_mm|\bMmBackward0", k))


@pytest.mark.parametrize("kind", views.KINDS)
@pytest.mark.parametrize("arch", SPLIT_ARCHS + HEADS_WHOLE)
def test_every_product_splits_four_ways(fake_mesh, arch, kind):
    """Per device, the placed step's dot FLOPs are a quarter of the same
    step's on a one-rank mesh: no model rank repeats a product (a
    backward's too) that the others split.  Where the heads do not
    divide, the projections' alone (a row-parallel ``wo`` reads the whole
    heads there: its weight's gradient is then a product of this rank's
    columns, ``layers._dense_mm``'s row-parallel form)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.op_analysis import analyze
    from repro_torch.models import layers as L
    one = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
    sites = []
    for m in (fake_mesh, one):
        try:
            built = views._built(arch, kind, m)
            sites.append(analyze(built.step, built.args,
                                 sites=True)["dot_sites"])
        finally:
            L.set_attention_mesh(None)
    placed, whole = (_projections(s) for s in sites)
    assert placed * 4 == whole > 0, (placed, whole)
    if arch not in HEADS_WHOLE:
        placed, whole = (sum(s.values()) for s in sites)
        assert placed * 4 == whole, (placed, whole)
