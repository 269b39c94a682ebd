"""The ``mode="gspmd"`` train step of the ssm, hybrid and encdec families
on placed state, continued from ``tests/test_torch_sharding.py`` (its
helpers, launched here on their own worker): the smoke xlstm-350m (8
tokens: its random sLSTM is chaotic) and whisper-tiny (with frames) on
the ``(2, 2)`` ``("data", "model")`` mesh, zamba2-7b on ``(2, 2)`` and
``(1, 4)``, in float32.  The two recurrences run on each rank's blocks
(``ssm._pinned_recurrence``), their inputs pinned batch over data and
replicated over model.  One 4-rank gloo launch and one 4-device JAX
subprocess (the reference's GSPMD step as
``launch/dryrun.py::build_train`` assembles it, the loss through
``model_fns``, executed), concurrently; the tolerances of
``tests/test_torch_sharding.py``.
"""

import pytest

pytest.importorskip("torch")

import test_torch_sharding as base  # noqa: E402

pytestmark = pytest.mark.subprocess

# (name, arch, grid, batch, seq, fsdp, hbm_bytes for the port or None)
CASES = [
    ("xlstm-2x2", "xlstm-350m", (2, 2), 4, 8, False, None),
    ("zamba2-2x2", "zamba2-7b", (2, 2), 4, 16, False, None),
    ("zamba2-1x4", "zamba2-7b", (1, 4), 4, 16, False, None),
    ("whisper-2x2", "whisper-tiny", (2, 2), 4, 16, False, None),
]
IDS = [c[0] for c in CASES]
# the cases whose model runs a recurrence (mLSTM, sLSTM or Mamba2)
RECURRENT = ("xlstm-2x2", "zamba2-2x2", "zamba2-1x4")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.run_cases(tmp_path_factory, CASES, nograd=IDS)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zoo_step_matches_one_rank(runs, case):
    base.check_one_rank(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zoo_step_matches_jax_gspmd(runs, case):
    base.check_jax_gspmd(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zoo_local_parameters_are_the_specs_blocks(runs, case):
    base.check_local_blocks(runs, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zoo_collectives_are_counted_and_noted(runs, case):
    """The placed gradient pass issues collectives (``CommDebugMode``)
    and notes each gradient's redistribution; where a recurrence runs,
    its pins' gathers are noted under ``gspmd_replicate_model``.  The
    one-rank plain pass issues none."""
    name = case[0]
    assert runs["plain"][name]["comm"]["total"] == 0
    for rank_out in runs["port"]:
        got = rank_out[name]
        assert got["comm"]["total"] > 0
        assert "gspmd_grad" in got["tags"]
        assert ("gspmd_replicate_model" in got["tags"]) == \
            (name in RECURRENT)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zoo_loss_without_autograd_matches(runs, case):
    """The no-grad branch of each recurrence (the loops, not the
    ``autograd.Function``s) runs on the blocks too: the placed loss
    without autograd equals one rank's and the step's own first loss."""
    name = case[0]
    want = runs["plain"][name]["nograd_loss"]
    for rank_out in runs["port"]:
        got = rank_out[name]
        assert abs(got["nograd_loss"] - want) <= base.LOSS_RTOL * abs(want)
        assert abs(got["nograd_loss"] - got["losses"][0]) \
            <= base.LOSS_RTOL * abs(want)
