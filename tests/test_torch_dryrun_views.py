"""The views torch 2.11's DTensor refuses, guarded on this CPU's torch.

The card's machine runs torch 2.11, whose DTensor takes a ``view`` (or
``_unsafe_view``) of a placed tensor only where it needs no
redistribution: a flattened group of dims may stay split only through
its leading dim, split evenly, and a split dim only through its leading
piece (``_view_ops.propagate_shape_and_sharding`` with ``strict_view``).
Torch 2.13 here also carries a split non-leading dim (``_StridedShard``)
and runs the same step.  Its linear pointwise ops (``add``, ``sub``,
``mul``) follow the input split into the most blocks and keep its pending
sums, so a split of another input on such a mesh dim would have to become
a pending sum, which it cannot do (two gradients summed in the backward,
split on swapped mesh dims).  ``launch.op_analysis.ViewCheck`` states
both conditions as a dispatch mode over the DTensor ops
(``strict_view_refusal``, ``pending_sum_refusal``).

Every family's smoke config runs placed prefill, decode and one train
step on a fake ``(2, 2)`` data x model mesh in this process (``meta``
blocks: nothing is computed), under the check: no view may meet the
first condition and no linear pointwise op the second.  The same steps
(and the train step pure data parallel) run under
``launch.op_analysis.DotCheck``: no product may reach DTensor's sharding
propagation, whose split of it differs between torch versions at full
width; every one runs on each rank's blocks (``collectives.local_map``).
The two rules are also held on hand-made cases, and the same cases run
as real DTensor views and sums on this torch, which on torch 2.11 must
refuse exactly what the rules refuse.  The budget is one the smoke
weights do not fit in, so that the sharding rules split every projection
over model as they do the full-width cells'.
"""

import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here run on meta blocks,
# and beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

GRID = (2, 2)
BATCH, SEQ = 4, 16
#: bytes the smoke weights do not fit in: every projection goes over model
TP_BUDGET = {"hbm_bytes": 1e4, "mem_elems": 8 * 1024 ** 3}
#: the reference's 16 GB and its ``HBM_ELEMS``: at :data:`DP_SEQ` tokens
#: a sequence the smoke weights fit and every matmul runs pure data
#: parallel (at :data:`SEQ` the cost model still splits them over model)
REF_BUDGET = {"hbm_bytes": 16e9, "mem_elems": 8 * 1024 ** 3}
DP_SEQ = 128
ARCHS = ["llama3.2-1b", "smollm-360m", "gemma3-12b", "gemma3-4b",
         "zamba2-7b", "xlstm-350m", "whisper-tiny", "granite-moe-1b-a400m",
         "qwen3-moe-235b-a22b", "qwen2-vl-72b"]
KINDS = ["train", "prefill", "decode"]


@pytest.fixture(scope="module")
def mesh():
    from repro_torch.dist.collectives import make_mesh
    from repro_torch.dist.spawn import end_world, fake_world
    fake_world(GRID[0] * GRID[1])
    try:
        yield make_mesh(GRID, ("data", "model"), device="cpu")
    finally:
        end_world()


def _built(arch, kind, mesh, budget=None, seq=SEQ):
    """The dry run's builders (``launch.dryrun.train_on`` / ``serve_on``)
    on the smoke config at :data:`BATCH` x ``seq`` tokens, at ``budget``
    (:data:`TP_BUDGET` by default)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import sds
    from repro_torch.models.api import model_fns
    budget = budget or TP_BUDGET
    cfg = get_config(arch, smoke=True)
    i32, f32 = torch.int32, torch.float32
    b, s, d = BATCH, seq, cfg.d_model
    if kind == "train":
        batch = {"tokens": sds((b, s), i32), "labels": sds((b, s), i32)}
        if cfg.family == "encdec":
            batch["frames"] = sds((b, s, d), f32)
        if cfg.family == "vlm":
            batch["positions"] = sds((b, 3, s), i32)
            batch["vision_embeds"] = sds((b, 4, d), f32)
        return dryrun.train_on(cfg, mesh, batch, **budget)
    kw = {"device": "meta"}
    if cfg.family == "encdec":
        kw["enc_len"] = s
    cache = model_fns(cfg).init_cache(cfg, b, 2 * s, **kw)
    if kind == "prefill":
        inputs = {"tokens": sds((b, s), i32)}
        if cfg.family == "encdec":
            inputs["frames"] = sds((b, s, d), f32)
        tokens = b * s
    else:
        inputs, tokens = {"tokens": sds((b, 1), i32)}, b
    return dryrun.serve_on(cfg, mesh, kind, inputs, cache,
                           tokens_per_step=tokens, **budget)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_no_view_torch_2_11_refuses(mesh, arch, kind):
    """The placed step (a train step's backward too) runs no DTensor view
    or pointwise sum that torch 2.11 refuses; each refusal is listed with
    its inputs' shapes and placements and where the port ran it."""
    from repro_torch.launch.op_analysis import ViewCheck
    from repro_torch.models import layers as L
    try:
        built = _built(arch, kind, mesh)
        with ViewCheck() as check:
            built.step(*built.args)
    finally:
        L.set_attention_mesh(None)
    assert not check.refused, check.refused[:4]


@pytest.mark.parametrize("kind", KINDS + ["train_dp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_no_dot_left_to_dtensor(mesh, arch, kind):
    """Every product of the placed step (a train step's backward too)
    runs on each rank's blocks (``collectives.local_map``): none reaches
    ``aten.mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` with a DTensor
    operand, whose split DTensor's sharding propagation would choose,
    differently on torch 2.11 and 2.13 at full width.  ``train_dp`` is
    the train step at the reference's 16 GB and :data:`DP_SEQ` tokens a
    sequence, where every matmul runs pure data parallel."""
    from repro_torch.launch.op_analysis import DotCheck
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import pure_dp
    try:
        if kind == "train_dp":
            built = _built(arch, "train", mesh, REF_BUDGET, DP_SEQ)
            assert pure_dp(built.decisions), built.decisions
        else:
            built = _built(arch, kind, mesh)
        with DotCheck() as check:
            built.step(*built.args)
    finally:
        L.set_attention_mesh(None)
    assert not check.left, (len(check.left), check.left[:4])


#: (placements, shape, new_shape, refused by torch 2.11, by torch 2.13)
VIEW_CASES = [
    # a projection's view of [B, S, d]: the batch split, the sequence too
    ("SS", (8, 32, 64), (256, 64), True, False),
    ("SR", (8, 32, 64), (256, 64), False, False),
    # the batch over both mesh dims, evenly
    ("S0S0", (8, 32, 64), (256, 64), False, False),
    # the MoE combine's (C, E) with E split behind C
    ("RS3", (1, 8, 5, 4, 1), (1, 8, 20), True, False),
    # a split dim cut into pieces the mesh dim does not divide
    ("S0R", (6, 8), (3, 16), True, True),
    ("S0R", (8, 8), (4, 16), False, False),
]
#: (the inputs' placements, refused by torch 2.11, by torch 2.13)
SUM_CASES = [
    # two gradients split on swapped mesh dims, summed
    ("PS,SP", True, False),
    # a residual split over model plus a pending sum over model
    ("SS,S0P", False, False),
    # both pending over the same mesh dims
    ("PS,PS", False, False),
]


def _placements(name):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return {"SS": [Shard(0), Shard(1)], "SR": [Shard(0), Replicate()],
            "S0S0": [Shard(0), Shard(0)], "RS3": [Replicate(), Shard(3)],
            "S0R": [Shard(0), Replicate()], "PS": [Partial(), Shard(2)],
            "SP": [Shard(2), Partial()], "S0P": [Shard(0), Partial()]}[name]


@pytest.mark.parametrize("placements, shape, new_shape, refused, _",
                         VIEW_CASES)
def test_strict_view_refusal_states_torch_2_11s_rule(placements, shape,
                                                     new_shape, refused, _):
    """The condition on hand-made cases, as 2.11's rule decides them."""
    from repro_torch.launch.op_analysis import strict_view_refusal
    why = strict_view_refusal(_placements(placements), shape, new_shape,
                              (2, 2))
    assert bool(why) == refused, why


@pytest.mark.parametrize("placements, refused, _", SUM_CASES)
def test_pending_sum_refusal_states_torch_2_11s_rule(placements, refused,
                                                     _):
    """The pointwise condition on hand-made cases, as 2.11's rule decides
    them."""
    from repro_torch.launch.op_analysis import pending_sum_refusal
    why = pending_sum_refusal([_placements(p) for p in placements.split(",")],
                              (2, 2))
    assert bool(why) == refused, why


def _refuses(op) -> bool:
    """Whether this torch's DTensor refuses ``op()`` (a fake process group:
    a redistribution it would take moves nothing)."""
    try:
        op()
    except Exception:   # 2.11's refusals differ in type between rules
        return True
    return False


def _placed(mesh, name, shape):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = _placements(name)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return DTensor.from_local(torch.zeros(local), mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


#: the torch whose DTensor the rules state: 2.11, or a later one (2.13)
AS_2_11 = tuple(int(v) for v in torch.__version__.split(".")[:2]) < (2, 12)


@pytest.mark.parametrize("placements, shape, new_shape, refused, later",
                         VIEW_CASES)
def test_this_torchs_dtensor_decides_the_views(mesh, placements, shape,
                                               new_shape, refused, later):
    """The hand-made views run as real DTensor views on this torch: on
    2.11 it refuses exactly those the rule refuses, on 2.13 only the
    uneven split."""
    x = _placed(mesh, placements, shape)
    assert _refuses(lambda: x.view(new_shape)) == (
        refused if AS_2_11 else later)


@pytest.mark.parametrize("placements, refused, later", SUM_CASES)
def test_this_torchs_dtensor_decides_the_sums(mesh, placements, refused,
                                              later):
    """The hand-made sums run as real DTensor sums on this torch: on 2.11
    it refuses exactly those the rule refuses, on 2.13 none."""
    a, b = (_placed(mesh, p, (16, 16, 16)) for p in placements.split(","))
    assert _refuses(lambda: a + b) == (refused if AS_2_11 else later)


def test_dot_sites_sum_to_the_dot_flops(mesh):
    """The op counter's dot FLOPs by site (``analyze(sites=True)``, the
    dry run's ``--dot-sites``) add up to its dot FLOPs and name the
    port's frames, or the backward node, of each dot."""
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.models import layers as L
    try:
        built = _built("llama3.2-1b", "train", mesh)
        stats = analyze(built.step, built.args, sites=True)
    finally:
        L.set_attention_mesh(None)
    sites = stats["dot_sites"]
    assert sum(sites.values()) == stats["dot_flops"] > 0
    assert any("_dense_mm" in s for s in sites)
    assert any(s.startswith("backward: ") or "< backward: " in s
               for s in sites)


def test_dryrun_diff_names_differing_sites(tmp_path):
    """``tools/dryrun_diff.py``: statuses, argument bytes and dots side by
    side, the sites whose dots differ, and exit 1 on a cell ok in one
    run and not the other."""
    import importlib.util
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "dryrun_diff.py")
    spec = importlib.util.spec_from_file_location("dryrun_diff", path)
    diff = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(diff)

    def rec(status, dots=0.0, sites=None):
        out = {"arch": "a", "shape": "train_4k", "mesh": "16x16",
               "status": status}
        if status == "ok":
            out.update(dot_flops_per_device=dots, dominant="compute_s",
                       memory_analysis={"argument_size_in_bytes": 8},
                       collectives={"total_wire_bytes": 1.0},
                       dot_flops_by_site=sites)
        return out

    for name, r in (("a", rec("ok", 3.0, {"x": 1.0, "y": 2.0})),
                    ("b", rec("ok", 4.0, {"x": 1.0, "y": 3.0})),
                    ("c", rec("error"))):
        os.makedirs(tmp_path / name)
        (tmp_path / name / "a.json").write_text(json.dumps(r))
    row, = diff.compare(diff.load(str(tmp_path / "a")),
                        diff.load(str(tmp_path / "b")))
    assert row["args_equal"] and row["dot_flops"] == [3.0, 4.0]
    assert row["sites"] == [("y", 2.0, 3.0)]
    assert diff.main([str(tmp_path / "a"), str(tmp_path / "c")]) == 1
    assert diff.main([str(tmp_path / "a"), str(tmp_path / "b")]) == 0
