"""``launch.train --mesh host --ranks N``: the LM trainer on N gloo ranks,
its state placed on the reference's host mesh ``(N, 1)`` over ``("data",
"model")`` by the GSPMD rules, against the same CLI on one rank.

The smoke llama trains in its config's dtype, bfloat16.  Each rank sums
its block's bf16 gradient, and the ranks' sums are then added: another
rounding than one rank's sum over the whole batch (the reference's GSPMD
reduces bf16 partial sums alike).  So the losses after the first update
agree with one rank's to bf16 rounding, 3.9e-4 relative at most over 8
steps on the CPU, and are held to ``BF16_RTOL``; in float32 the same
runs agree to 1.6e-7 (``tests/test_torch_sharding.py`` holds the placed
f32 step to 1e-4).  The first step's loss (no update yet) and a resumed
run are held exactly or to 1e-6.
"""

import json
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.subprocess

BF16_RTOL = 2e-3     # half a bf16 ulp (2^-8) of the loss
ARGS = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "8",
        "--batch", "4", "--seq", "16", "--log-every", "1",
        "--ckpt-every", "2"]


def _cli(tmp, *extra):
    from repro_torch.launch import train
    return train.main(ARGS + ["--ckpt-dir", str(tmp), *extra])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.abs(b)


def test_two_ranks_train_resume_and_match_one_rank(tmp_path, capfd):
    """``--ranks 2`` killed by a SIGTERM at step 5 and resumed on 2 ranks
    stitches exactly to an uninterrupted 2-rank run; its losses follow
    one rank's; and the 2-rank checkpoint resumes on one rank (whole
    tensors in the manifest) to the 2-rank step-5 loss."""
    plan = json.dumps({"faults": [{"kind": "sigterm", "step": 5}]})
    a = _cli(tmp_path / "a", "--ranks", "2", "--fault-plan", plan)
    assert a["preempted"] and a["end_step"] == 5 and len(a["losses"]) == 5
    shutil.copytree(tmp_path / "a", tmp_path / "a1")
    b = _cli(tmp_path / "a", "--ranks", "2", "--resume")
    assert b["start_step"] == 5 and not b["preempted"]
    full2 = _cli(tmp_path / "full2", "--ranks", "2")
    assert a["losses"] + b["losses"] == full2["losses"]
    full1 = _cli(tmp_path / "full1")
    assert _rel(full2["losses"][0], full1["losses"][0]) <= 1e-6
    assert _rel(full2["losses"], full1["losses"]).max() <= BF16_RTOL
    b1 = _cli(tmp_path / "a1", "--resume")
    assert b1["start_step"] == 5
    assert _rel(b1["losses"][0], b["losses"][0]) <= 1e-6
    out = capfd.readouterr().out
    assert "ranks=2 device=cpu" in out
    assert "[train] mesh={'data': 2, 'model': 1}" in out
    assert "[train] preempted at step 5" in out
    assert "[train] resumed from step 5" in out
    assert "[train] final checkpoint at 8" in out


def test_two_ranks_train_a_zoo_model_as_one_rank(capfd):
    """The hybrid family (the smoke zamba2-7b, Mamba2 recurrences and the
    shared attention block) on ``--ranks 2`` follows ``--ranks 1``: the
    first loss to 1e-6 and the next to bf16 rounding."""
    from repro_torch.launch import train
    args = ["--arch", "zamba2-7b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "4", "--seq", "16", "--log-every", "1"]
    two = train.main(args + ["--ranks", "2"])
    one = train.main(args)
    assert len(two["losses"]) == len(one["losses"]) == 2
    assert _rel(two["losses"][0], one["losses"][0]) <= 1e-6
    assert _rel(two["losses"], one["losses"]).max() <= BF16_RTOL
    out = capfd.readouterr().out
    assert "zamba2-7b (smoke) ranks=2 device=cpu" in out
    assert "[train] mesh={'data': 2, 'model': 1}" in out
