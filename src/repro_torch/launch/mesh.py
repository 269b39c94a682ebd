"""Production mesh construction -- the port of ``repro/launch/mesh.py``.

Defined as FUNCTIONS, so importing this module touches no process group.

The production mesh is 256 (16 x 16) or 512 (2 x 16 x 16) devices.  The
dry run builds it in one process on a fake process group of that many
ranks (backend ``"fake"``: every collective returns at once and moves
nothing), seen from rank 0; the program is SPMD, so rank 0 stands for
every rank.  The dry run's tensors live on the ``meta`` device: the mesh
only names their placements.
"""

from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 devices per pod; 2 pods = 512 devices when multi_pod,
    on a fake process group (see the module docstring); ``device`` names
    the mesh's device type (``cuda`` by default)."""
    from repro_torch.dist.collectives import make_mesh
    from repro_torch.dist.spawn import fake_world
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    fake_world(math.prod(shape))
    return make_mesh(shape, axes, device=device)


def make_host_mesh(shape=None, axes=("data", "model"), *, device=None):
    """Small mesh over the ranks that exist (tests / examples): every rank
    of the process group on the data axis unless ``shape`` is given."""
    from repro_torch.dist.collectives import make_mesh, world_size
    n = world_size()
    if shape is None:
        shape = (n, 1)
    return make_mesh(tuple(shape), tuple(axes), device=device)
