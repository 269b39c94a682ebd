"""The ``mode="gspmd"`` train step on placed state, continued from
``tests/test_torch_sharding.py`` (its helpers, launched here on their own
worker): the smoke llama and granite-moe on the ``(1, 4)`` ``("data",
"model")`` mesh, and with ``fsdp`` on ``(4, 1)``, so every matmul's
weight is sharded over data.  One 4-rank gloo launch and one 4-device
JAX subprocess (the reference's GSPMD step as
``launch/dryrun.py::build_train`` assembles it, executed),
concurrently; the tolerances of ``tests/test_torch_sharding.py``.
"""

import pytest

pytest.importorskip("torch")

import test_torch_sharding as base  # noqa: E402

pytestmark = pytest.mark.subprocess

# (name, arch, grid, batch, seq, fsdp, hbm_bytes for the port or None)
CASES = [
    ("llama-1x4", "llama3.2-1b", (1, 4), 4, 16, False, None),
    ("granite-1x4", "granite-moe-1b-a400m", (1, 4), 4, 16, False, None),
    ("llama-4x1-fsdp", "llama3.2-1b", (4, 1), 4, 16, True, None),
    ("granite-4x1-fsdp", "granite-moe-1b-a400m", (4, 1), 4, 16, True, None),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.run_cases(tmp_path_factory, CASES)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gspmd_step_matches_one_rank(runs, case):
    base.check_one_rank(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gspmd_step_matches_jax_gspmd(runs, case):
    base.check_jax_gspmd(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_local_parameters_are_the_specs_blocks(runs, case):
    base.check_local_blocks(runs, case)
