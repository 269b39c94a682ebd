"""The ``mode="gspmd"`` train step through the pinned flash branch,
continued from ``tests/test_torch_sharding.py`` (its helpers, launched
here on their own worker): the smoke llama on the ``(2, 2)`` ``("data",
"model")`` mesh at batch 2 and S = 2560 (S * S above the 2048 * 2048 of
the dense branch; chunked CE needs S a multiple of 512), a small memory
budget making every matmul tensor parallel so the heads go over model:
q and the expanded k/v pinned, ``_FlashAttention`` run on each rank's
blocks through ``collectives.local_map``.  One 4-rank gloo launch and
one 4-device JAX subprocess (the reference's GSPMD step at its own
decisions), concurrently; the tolerances of
``tests/test_torch_sharding.py``.
"""

import pytest

pytest.importorskip("torch")

import test_torch_sharding as base  # noqa: E402

pytestmark = pytest.mark.subprocess

# (name, arch, grid, batch, seq, fsdp, hbm_bytes for the port or None)
CASE = ("llama-flash-2x2", "llama3.2-1b", (2, 2), 2, 2560, False, 1e5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.run_cases(tmp_path_factory, [CASE])


def test_flash_step_matches_one_rank(runs):
    base.check_one_rank(runs, CASE)


def test_flash_step_matches_jax_gspmd(runs):
    base.check_jax_gspmd(runs, CASE)


def test_flash_local_parameters_are_tensor_parallel(runs):
    decisions = base.check_local_blocks(runs, CASE)
    assert set(decisions.values()) <= {"k", "c"}


def test_flash_branch_pins_the_heads(runs):
    """The case ran through the pinned branch: its heads pin noted a
    redistribution on every rank (S * S above the dense area)."""
    from repro_torch.models.layers import _BLOCKWISE_AREA
    assert CASE[4] ** 2 > _BLOCKWISE_AREA
    for rank_out in runs["port"]:
        assert "gspmd_heads" in rank_out[CASE[0]]["tags"]
