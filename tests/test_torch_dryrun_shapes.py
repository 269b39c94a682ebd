"""The dry run's shape grid, stand-ins, production mesh and wire model
against the JAX package, in process and with no compile.

``launch/shapes.py``: ``SHAPES`` and ``cell_supported`` for every
``ARCH_IDS`` config at full width and every shape; the shapes and dtypes
of ``input_specs`` and ``cache_struct`` (``meta`` tensors) against the
reference's ``ShapeDtypeStruct``s (``jax.eval_shape``).  ``launch/mesh.py``:
the production mesh's extents and axis names, on a fake process group
that is ended after each case.  ``launch/op_analysis.py``: the ring-model
wire of each collective kind and group size against the reference's
``launch/dryrun.py::parse_collectives`` reading a one-op HLO module.
"""

import pytest

torch = pytest.importorskip("torch")
# torch on one thread in this process: the ops here are smoke-sized, and
# beside the other pytest-xdist workers more threads only spin
torch.set_num_threads(1)

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402

SHAPE_NAMES = list(tshapes.SHAPES)


def _tree(tree, prefix=""):
    """``{path: (shape, dtype name)}`` of a tree of dicts of tensors or
    ``ShapeDtypeStruct``s (``None`` subtrees left out)."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tree(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): (tuple(tree.shape),
                                 str(tree.dtype).replace("torch.", ""))}


def test_shapes_match_reference():
    from repro.launch import shapes as jshapes
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, sp in tshapes.SHAPES.items():
        ref = jshapes.SHAPES[name]
        assert (sp.name, sp.seq_len, sp.global_batch, sp.kind) == \
            (ref.name, ref.seq_len, ref.global_batch, ref.kind)
    assert tshapes.WHISPER_DECODE_ENC_LEN == jshapes.WHISPER_DECODE_ENC_LEN
    assert tshapes.VLM_PATCHES == jshapes.VLM_PATCHES


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_supported_and_inputs_match_reference(arch, shape):
    from repro.configs import get_config as jget
    from repro.launch import shapes as jshapes
    cfg, jcfg = get_config(arch), jget(arch)
    assert tshapes.cell_supported(cfg, shape) == \
        jshapes.cell_supported(jcfg, shape)
    got = _tree(tshapes.input_specs(cfg, shape))
    assert got == _tree(jshapes.input_specs(jcfg, shape))
    assert all(t.device.type == "meta" for t in
               tshapes.input_specs(cfg, shape).values())


@pytest.mark.parametrize("shape", [s for s in SHAPE_NAMES
                                   if tshapes.SHAPES[s].kind != "train"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_struct_matches_reference(arch, shape):
    """The serve cache of every cell, leaf by leaf: nothing allocated."""
    from repro.configs import get_config as jget
    from repro.launch import shapes as jshapes
    got = tshapes.cache_struct(get_config(arch), shape)
    assert _tree(got) == _tree(jshapes.cache_struct(jget(arch), shape))
    from torch.utils import _pytree as pytree
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(got))


@pytest.fixture
def fake_world_ended():
    from repro_torch.dist.spawn import end_world
    yield
    end_world()


@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model")),
])
def test_production_mesh(multi_pod, shape, axes, fake_world_ended):
    """256 or 512 fake ranks in this process, seen from rank 0; importing
    the module touched no process group."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    from repro_torch.launch import mesh as tmesh
    assert not dist.is_initialized()
    m = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert tuple(m.shape) == shape
    assert tuple(m.mesh_dim_names) == axes
    assert C.world_size() == m.size() == (512 if multi_pod else 256)
    assert all(C.axis_index(m, a) == 0 for a in axes)
    host = tmesh.make_host_mesh(device="cpu")
    assert tuple(host.shape) == (m.size(), 1)


_HLO = """HloModule m

ENTRY %main.1 (p0: f32[{n},128]) -> f32[{out},128] {{
  %p0 = f32[{n},128]{{1,0}} parameter(0)
  ROOT %c = f32[{out},128]{{1,0}} {op}(f32[{n},128]{{1,0}} %p0), channel_id=1, {groups}{extra}
}}
"""


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all",
                                  "collective-permute"])
def test_ring_wire_matches_reference(kind, g):
    """One collective of each kind over ``g`` ranks: the port's wire
    (``ring_wire`` through ``parse_collectives``) equals the reference's
    reading of the same collective in HLO."""
    from repro.launch.dryrun import parse_collectives as jparse
    from repro_torch.launch.op_analysis import parse_collectives
    n = 8 * g
    out = {"all-gather": n * g, "reduce-scatter": n // g}.get(kind, n)
    groups = ("source_target_pairs={{0,1},{1,0}}"
              if kind == "collective-permute" else
              "replica_groups={{" + ",".join(map(str, range(g))) + "}}")
    extra = {"all-gather": ", dimensions={0}",
             "reduce-scatter": ", dimensions={0}, to_apply=%add",
             "all-reduce": ", to_apply=%add",
             "all-to-all": ", dimensions={0}"}.get(kind, "")
    want = jparse(_HLO.format(n=n, out=out, op=kind, groups=groups,
                              extra=extra))
    payload = (out if kind in ("all-gather", "reduce-scatter") else n) \
        * 128 * 4
    got = parse_collectives([(kind, payload, g)])
    assert got["wire_bytes"] == want["wire_bytes"]
    assert got["counts"] == {k: int(v) for k, v in want["counts"].items()}
    assert got["total_wire_bytes"] == want["total_wire_bytes"] > 0
