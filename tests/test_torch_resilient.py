"""The acceptance case of the port's fault-tolerant trainer, through its
CLI (``python -m repro_torch.launch.train --mesh dist-grid``), as the
reference's ``tests/test_fault_injection.py::
test_kill_and_resume_on_smaller_grid_continues_trajectory``.

Run A trains on 8 gloo ranks and is SIGTERMed at step 5 (every rank
stops there, rank 0 commits the emergency checkpoint); run B resumes on 4
ranks, where the grid is re-synthesized and the full checkpoint loaded
onto it; run C trains 8 steps on one rank.  The stitched losses of A and
B must equal C's within ``rtol=5e-4`` (the reference's gate), and C's
must equal the reference's dense ``make_resilient_train_loop(grid=None)``
run in process on the same parameters and batches (converted through
numpy) within 1e-4 relative per step.  The subprocesses run with the
tuner off (``REPRO_TORCH_AUTOTUNE=0``) so that the ranks agree.  A
2-rank launch in process checks the SPMD stop: a SIGTERM on one rank
only stops both at the same step, and rank 0 saves.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.fault

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, CHANNELS, CLASSES, IN_CHANNELS, HW, LR = \
    8, 8, [8, 8], 10, 4, 8, 3e-3   # the CLI's defaults but steps and lr


def _run_train(args, *, ranks, timeout=600):
    env = dict(os.environ,
               PYTHONPATH=os.path.join(_ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               REPRO_TORCH_AUTOTUNE="0")
    env.pop("REPRO_FAULT_PLAN", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mesh",
         "dist-grid", "--device", "cpu", "--ranks", str(ranks),
         "--steps", str(STEPS), "--batch", str(BATCH)] + args,
        env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, \
        f"STDOUT:\n{proc.stdout}\nERR:\n{proc.stderr}"
    return proc.stdout


def _losses(stdout):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"\[resilient\] step (\d+) loss ([0-9.]+)", stdout)}


def _reference_dense_losses():
    """The reference's dense resilient loop on the port's parameters and
    batches (the two packages draw with different generators)."""
    import jax.numpy as jnp
    from repro.dist.train import ResilienceConfig, make_resilient_train_loop
    from repro.train.optim import AdamW

    from repro_torch.dist.train import make_synthetic_cnn_batches
    from repro_torch.models.cnn import init_cnn

    params = init_cnn(torch.Generator().manual_seed(0), channels=CHANNELS,
                      n_classes=CLASSES, in_channels=IN_CHANNELS,
                      device="cpu")
    jparams = {"convs": [{"w": jnp.asarray(b["w"].numpy()),
                          "b": jnp.asarray(b["b"].numpy())}
                         for b in params["convs"]],
               "head": jnp.asarray(params["head"].numpy())}
    batches = make_synthetic_cnn_batches((BATCH, IN_CHANNELS, HW, HW),
                                         CLASSES, device="cpu")

    def batch_fn(step):
        b = batches(step)
        return {"images": jnp.asarray(b["images"].numpy()),
                "labels": jnp.asarray(b["labels"].numpy(), jnp.int32)}

    run = make_resilient_train_loop(AdamW(lr=LR), ResilienceConfig(),
                                    grid=None)
    return run(lambda: jparams, batch_fn, STEPS)["losses"]


def test_kill_on_8_ranks_and_resume_on_4_continues_the_trajectory(
        tmp_path):
    ckpt = str(tmp_path / "ckpt")
    common = ["--channels", ",".join(map(str, CHANNELS)), "--lr", str(LR),
              "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    plan = '{"faults": [{"kind": "sigterm", "step": 5}]}'

    out_a = _run_train(common + ["--fault-plan", plan], ranks=8)
    assert "preempted at step 5" in out_a
    assert "[fault] sigterm@5: emergency checkpoint at step 5" in out_a
    la = _losses(out_a)
    assert sorted(la) == [0, 1, 2, 3, 4]

    # 4 ranks: the grid is re-synthesized and training goes on at step 5
    out_b = _run_train(common, ranks=4)
    assert "done at step 8" in out_b
    lb = _losses(out_b)
    assert sorted(lb) == [5, 6, 7]
    ga = re.search(r"grid=\((.*?)\)", out_a).group(1)
    gb = re.search(r"grid=\((.*?)\)", out_b).group(1)
    assert ga != gb, "restart on fewer ranks must pick a new grid"
    assert "[fault] elastic_plan@5: grid" in out_b

    out_c = _run_train(["--channels", ",".join(map(str, CHANNELS)),
                        "--lr", str(LR)], ranks=1)
    lc = _losses(out_c)
    assert sorted(lc) == list(range(STEPS))
    stitched = {**la, **lb}
    for s in range(STEPS):
        np.testing.assert_allclose(stitched[s], lc[s], rtol=5e-4,
                                   err_msg=f"step {s} diverged")

    # run C against the reference's dense loop on the same inputs; the
    # CLI prints 6 decimals, so hold the printed value to 1e-4 relative
    ref = _reference_dense_losses()
    for s in range(STEPS):
        np.testing.assert_allclose(lc[s], ref[s], rtol=1e-4,
                                   err_msg=f"step {s} vs the reference")


def _one_rank_signalled(rank, ckpt_dir):
    """The resilient loop on 2 gloo ranks with a SIGTERM on rank 1 only."""
    from repro_torch.dist.train import (ResilienceConfig,
                                        make_resilient_train_loop,
                                        make_synthetic_cnn_batches)
    from repro_torch.fault.inject import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.kernels.autotune import autotune_disabled
    from repro_torch.models.cnn import init_cnn
    from repro_torch.train.optim import AdamW

    plan = FaultPlan(faults=(FaultSpec(kind="sigterm", step=2),))
    run = make_resilient_train_loop(
        AdamW(lr=LR), ResilienceConfig(ckpt_dir=ckpt_dir, ckpt_every=100),
        grid="auto", injector=FaultInjector(plan) if rank == 1 else None,
        device="cpu")
    with autotune_disabled():
        rep = run(lambda: init_cnn(torch.Generator().manual_seed(0),
                                   channels=CHANNELS, n_classes=CLASSES,
                                   in_channels=IN_CHANNELS, device="cpu"),
                  make_synthetic_cnn_batches((BATCH, IN_CHANNELS, HW, HW),
                                             CLASSES, device="cpu"), STEPS)
    return {"preempted": rep["preempted"], "end": rep["end_step"],
            "events": [(e.kind, e.step, e.detail) for e in rep["events"]]}


def test_a_signal_on_one_rank_stops_every_rank(tmp_path):
    """Rank 1 alone is SIGTERMed: the vote stops both ranks at the same
    step, and rank 0 (which was not signalled) commits the emergency
    checkpoint."""
    from repro_torch.ckpt.checkpointer import CheckpointManager
    from repro_torch.dist.spawn import run_spmd

    out = run_spmd(_one_rank_signalled, 2, str(tmp_path), device="cpu")
    assert [(o["preempted"], o["end"]) for o in out] == [(True, 2)] * 2
    (kind, step, detail), = [e for e in out[0]["events"]
                             if e[0] == "sigterm"]
    assert step == 2 and "a peer rank was signalled" in detail
    assert [e[:2] for e in out[1]["events"]
            if e[0] != "elastic_plan"] == [("inject", 2), ("sigterm", 2)]
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]


def test_host_mesh_waits_for_lm_training():
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="LM-training slice"):
        train.main(["--mesh", "host"])
    with pytest.raises(SystemExit):
        train.main(["--mesh", "dist-grid", "--bogus", "1"])
