"""The port's fault runtime (``repro_torch.fault``, ``repro_torch.ckpt``,
the resilient loop of ``dist/train.py`` and the serving engine's fault
knobs), case by case as the reference's unit tests
(``tests/test_fault_injection.py`` and ``tests/test_train_ckpt_fault.py``).

Cross-package: a fault plan written by either package parses in the
other (one ``REPRO_FAULT_PLAN`` drives both), and ``ElasticPlan``'s grid
planners equal the port's synthesizers and the reference's.  The
checkpoints are the port's own format (JSON manifest, raw numpy chunks;
not byte-compatible with the reference's ``msgpack``); they are held
bit-equal on every dtype the state holds, ``bfloat16`` included.  The
loops run dense on the CPU, in process, as the reference's tests run
them.  Losses of a resumed run: within ``rtol=2e-4`` of the first run's,
the reference's gate.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import checkpointer as ck  # noqa: E402
from repro_torch.fault.inject import (FaultInjector, FaultPlan,  # noqa: E402
                                      FaultSpec, MidSaveCrash,
                                      clear_mid_save_crash, corrupt_chunk,
                                      install_mid_save_crash)
from repro_torch.fault.monitor import (ElasticPlan, EmergencySaver,  # noqa
                                       Heartbeat, StragglerMonitor)
from repro_torch.fault.watchdog import (FaultEvent, FaultLog,  # noqa: E402
                                        StepWatchdog)

pytestmark = pytest.mark.fault


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(16, 8, generator=gen),
            "b": torch.arange(8, dtype=torch.float32),
            "step": torch.tensor(seed)}


def _assert_trees_equal(a, b):
    from torch.utils import _pytree as pytree
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x == y and type(x) is type(y)


# ------------------------------------------------------------ fault plans --

def test_fault_plan_json_roundtrip_and_crosses_packages():
    from repro.fault.inject import FaultPlan as RefPlan

    plan = FaultPlan(faults=(
        FaultSpec(kind="sigterm", step=5),
        FaultSpec(kind="wedge", step=3, point="decode", delay_s=0.2),
        FaultSpec(kind="corrupt_chunk", step=7, leaf_id=2, chunk=1),
    ))
    back = FaultPlan.from_json(plan.to_json())
    assert back == plan
    assert back.at("step", 5) == [plan.faults[0]]
    assert back.at("decode", 3) == [plan.faults[1]]
    assert back.at("step", 99) == []
    # one plan drives either package
    ref = RefPlan.from_json(plan.to_json())
    assert json.loads(ref.to_json()) == json.loads(plan.to_json())
    assert FaultPlan.from_json(ref.to_json()) == plan


def test_fault_plan_from_env(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    assert FaultPlan.from_env() is None
    plan = FaultPlan(faults=(FaultSpec(kind="wedge", step=1, delay_s=0.5),))
    monkeypatch.setenv("REPRO_FAULT_PLAN", plan.to_json())
    assert FaultPlan.from_env() == plan


def test_fault_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="fault kind"):
        FaultSpec(kind="asteroid", step=0)


def test_injector_records_applied_faults():
    plan = FaultPlan(faults=(FaultSpec(kind="wedge", step=2, delay_s=0.0),))
    log = FaultLog()
    inj = FaultInjector(plan, log=log)
    inj.fire("step", 0)
    assert inj.applied == []
    inj.fire("step", 2)
    assert [s.kind for s in inj.applied] == ["wedge"]
    assert log.kinds() == ["inject"]


def test_file_faults_act_on_rank_0_only(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(_tree(0), 1)
    plan = FaultPlan(faults=(FaultSpec(kind="corrupt_chunk", step=1),
                             FaultSpec(kind="crash_mid_save", step=1)))
    inj = FaultInjector(plan)
    try:
        inj.fire("step", 1, {"ckpt_root": str(tmp_path), "rank": 3})
        assert ck._chunk_hook is None        # not armed on rank 3
        ck.restore(_tree(), mgr._dir(1))     # not corrupted on rank 3
        assert inj.log.kinds() == ["inject", "inject"]  # but logged
        inj.fire("step", 1, {"ckpt_root": str(tmp_path), "rank": 0})
        assert ck._chunk_hook is not None
        with pytest.raises(ck.CorruptCheckpointError):
            ck.restore(_tree(), mgr._dir(1))
    finally:
        clear_mid_save_crash()


# -------------------------------------------------- checkpoint integrity --

def test_corrupt_chunk_detected_and_manager_falls_back(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    t0, t1 = _tree(0), _tree(1)
    mgr.save(t0, 3)
    mgr.save(t1, 6)
    path = corrupt_chunk(str(tmp_path), leaf_id=0, chunk=0)
    assert path.endswith("0.c0.npy")
    with pytest.raises(ck.CorruptCheckpointError, match="crc32"):
        ck.restore(_tree(), mgr._dir(6))
    seen = []
    restored, step = mgr.restore_latest(
        _tree(), on_corrupt=lambda s, e: seen.append(s))
    assert seen == [6] and step == 3
    _assert_trees_equal(restored, t0)


def test_corrupt_all_steps_restores_nothing(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(_tree(), 1)
    corrupt_chunk(str(tmp_path), leaf_id=0, chunk=0)
    assert mgr.restore_latest(_tree()) == (None, None)


def test_missing_chunk_is_corrupt_not_crash(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(_tree(), 1)
    os.remove(os.path.join(mgr._dir(1), "0.c0.npy"))
    with pytest.raises(ck.CorruptCheckpointError, match="missing"):
        ck.restore(_tree(), mgr._dir(1))


def test_unreadable_chunk_header_is_corrupt(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(_tree(), 1)
    path = os.path.join(mgr._dir(1), "0.c0.npy")
    with open(path, "r+b") as f:
        f.write(b"garbage!")       # over the .npy magic
    with pytest.raises(ck.CorruptCheckpointError, match="unreadable"):
        ck.restore(_tree(), mgr._dir(1))
    assert mgr.restore_latest(_tree()) == (None, None)


def test_restore_names_missing_leaf(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save({"w": torch.ones(4)}, 1)
    with pytest.raises(ck.CheckpointError,
                       match="no leaf .*extra.*tree structure changed"):
        ck.restore({"w": torch.ones(4), "extra": torch.ones(2)},
                   mgr._dir(1))


def test_all_steps_skips_junk_dirs(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(_tree(), 2)
    os.makedirs(tmp_path / "step_000000009.tmp")
    os.makedirs(tmp_path / "step_garbage")
    os.makedirs(tmp_path / "notes")
    assert mgr.all_steps() == [2]


def test_mid_save_crash_keeps_previous_checkpoint(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    t0 = _tree(0)
    mgr.save(t0, 1)
    install_mid_save_crash(after_chunks=1)
    try:
        with pytest.raises(MidSaveCrash):
            mgr.save(_tree(1), 2)
    finally:
        clear_mid_save_crash()
    assert mgr.all_steps() == [1]
    restored, step = mgr.restore_latest(_tree())
    assert step == 1
    _assert_trees_equal(restored, t0)
    mgr.save(_tree(1), 2)   # the hook is one-shot: the retry commits
    assert mgr.all_steps() == [1, 2]


def test_checkpoint_roundtrip_every_leaf_kind(tmp_path):
    """f32, bf16 (stored as its bits), int, a Python int, a 0-d tensor
    and a ``None`` leaf (not stored, restored as ``None``), under the
    train state's NamedTuples."""
    from repro_torch.train.optim import AdamW
    from repro_torch.train.step import init_train_state

    gen = torch.Generator().manual_seed(3)
    params = {"convs": [{"w": torch.randn(5, 2, 3, 3, generator=gen),
                         "b": torch.randn(5, generator=gen).to(
                             torch.bfloat16)}],
              "head": torch.randn(5, 7, generator=gen),
              "ids": torch.arange(6, dtype=torch.int64),
              "s": torch.tensor(3.5)}
    state = init_train_state(params, AdamW())
    state = state._replace(opt=state.opt._replace(step=4))
    d = str(tmp_path / "step1")
    ck.save(state, d, step=1)
    with open(os.path.join(d, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    dtypes = {l["name"]: l["dtype"] for l in meta["leaves"]}
    assert dtypes["params/convs/0/b"] == "bfloat16"
    assert dtypes["opt/step"] == "py:int"
    assert not any(n.startswith("err") for n in dtypes)
    like = init_train_state(
        {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else v)
         for k, v in params.items()} | {"convs": [
             {"w": torch.zeros(5, 2, 3, 3),
              "b": torch.zeros(5, dtype=torch.bfloat16)}]}, AdamW())
    restored, step = ck.restore(like, d)
    assert step == 1
    _assert_trees_equal(restored, state)


def test_restore_takes_the_like_trees_dtype(tmp_path):
    d = str(tmp_path / "s")
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(4))
    ck.save({"w": w.to(torch.bfloat16)}, d, step=0)
    restored, _ = ck.restore({"w": torch.zeros(4, 3)}, d)
    assert restored["w"].dtype == torch.float32
    assert torch.equal(restored["w"], w.to(torch.bfloat16).float())


def test_checkpoint_chunked_large_leaf(tmp_path):
    tree = {"big": torch.arange(4096, dtype=torch.float32).reshape(64, 64)}
    d = str(tmp_path / "stepc")
    ck.save(tree, d, step=2, chunk_bytes=1024)  # forces many chunks
    assert len([f for f in os.listdir(d) if f.endswith(".npy")]) == 16
    restored, _ = ck.restore(tree, d)
    assert torch.equal(restored["big"], tree["big"])


def test_checkpoint_manager_retention_and_resume(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 5, 9]:
        mgr.save({"x": torch.zeros(4) + s}, s)
    assert mgr.all_steps() == [5, 9]
    restored, step = mgr.restore_latest({"x": torch.zeros(4)})
    assert step == 9
    assert restored["x"].tolist() == [9.0] * 4


def test_checkpoint_async_snapshot_and_crash_atomicity(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=3)
    tree = {"x": torch.ones(128, 16)}
    mgr.save(tree, 3, async_=True)
    tree["x"].add_(1.0)   # after the call: the snapshot was taken
    mgr.wait()
    assert mgr.latest_step() == 3
    restored, _ = ck.restore({"x": torch.zeros(128, 16)}, mgr._dir(3))
    assert restored["x"].eq(1.0).all()
    os.makedirs(str(tmp_path / "step_000000099"))  # uncommitted: ignored
    assert mgr.latest_step() == 3


# ------------------------------------------------------------- watchdog --

def test_watchdog_fires_once_on_wedged_step():
    fired = []
    wd = StepWatchdog(0.08, on_wedge=lambda s, e: fired.append(s),
                      poll_s=0.01)
    try:
        with wd.watch(7):
            time.sleep(0.3)
    finally:
        wd.close()
    assert fired == [7]
    assert [e.kind for e in wd.fired] == ["wedge"]
    assert wd.fired[0].step == 7


def test_watchdog_quiet_on_fast_steps():
    fired = []
    wd = StepWatchdog(0.25, on_wedge=lambda s, e: fired.append(s),
                      poll_s=0.01)
    try:
        for step in range(5):
            with wd.watch(step):
                time.sleep(0.005)
        time.sleep(0.3)  # disarmed: the deadline must not fire late
    finally:
        wd.close()
    assert fired == []


def test_watchdog_handler_error_is_contained():
    def bad(step, elapsed):
        raise RuntimeError("handler exploded")
    log = FaultLog()
    wd = StepWatchdog(0.05, on_wedge=bad, log=log, poll_s=0.01)
    try:
        with wd.watch(1):
            time.sleep(0.2)
    finally:
        wd.close()
    assert log.kinds() == ["wedge", "wedge_handler_error"]
    assert "handler exploded" in log.events[1].detail


def test_fault_log_jsonl_mirror(tmp_path):
    p = tmp_path / "events.jsonl"
    log = FaultLog(str(p))
    log.emit(FaultEvent(kind="sigterm", step=4, detail="x"))
    log.emit(FaultEvent(kind="wedge", step=5))
    lines = [json.loads(ln) for ln in p.read_text().splitlines()]
    assert [(e["kind"], e["step"]) for e in lines] == [("sigterm", 4),
                                                      ("wedge", 5)]


def test_fault_log_keeps_every_event_from_many_threads(tmp_path):
    """The watchdog and saver threads emit beside the train loop: no event
    (or mirrored line) may be lost under contention."""
    import sys
    import threading

    p = tmp_path / "events.jsonl"
    log = FaultLog(str(p))
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            log.emit(FaultEvent(kind="straggler", step=i * per_thread + j))
            for j in range(per_thread)]) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    want = set(range(n_threads * per_thread))
    assert {e.step for e in log.events} == want
    assert len(log.events) == len(want)
    assert sorted(json.loads(ln)["step"]
                  for ln in p.read_text().splitlines()) == sorted(want)


# ------------------------------------------------------------- monitors --

def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(z=3.0, patience=2, warmup_steps=3)
    trigger = False
    for i in range(20):
        trigger = mon.observe(i, 0.10 + 0.001 * (i % 3))
    assert not trigger
    assert mon.observe(20, 1.0) is False     # first anomaly
    assert mon.observe(21, 1.0) is True      # patience=2 reached
    assert len(mon.events) >= 2


def test_straggler_monitor_recovers():
    mon = StragglerMonitor(z=3.0, patience=3, warmup_steps=3)
    for i in range(10):
        mon.observe(i, 0.1)
    mon.observe(10, 2.0)
    mon.observe(11, 0.1)    # back to normal resets the streak
    assert mon.consecutive == 0


def test_emergency_saver_runs_once():
    calls = []
    saver = EmergencySaver(lambda: calls.append(1))
    saver._handler(15, None)
    saver._handler(15, None)
    assert calls == [1]


def test_heartbeat_beats():
    beats = []
    hb = Heartbeat(lambda t: beats.append(t), interval_s=0.05).start()
    time.sleep(0.2)
    hb.stop()
    assert len(beats) >= 2


# ------------------------------------------------------- elastic planning --

def test_elastic_plan_shrinks_data_axis_and_validates():
    plan = ElasticPlan.plan((2, 16, 16), n_devices=400, model_axis=2)
    assert plan.new_shape[2] == 16 and np.prod(plan.new_shape) <= 400
    assert plan.reshard
    with pytest.raises(ValueError, match="rank>=2"):
        ElasticPlan.plan((8,), n_devices=4, model_axis=0)
    with pytest.raises(ValueError, match="model_axis"):
        ElasticPlan.plan((2, 4), n_devices=8, model_axis=5)
    with pytest.raises(ValueError, match="devices"):
        ElasticPlan.plan((2, 4), n_devices=3, model_axis=1)


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_elastic_grid_plans_equal_the_synthesizers(n_devices):
    from repro.fault.monitor import ElasticPlan as RefPlan

    from repro_torch.configs import get_config
    from repro_torch.core.sharding_synthesis import (synthesize_cnn_grid,
                                                     synthesize_dist_grid,
                                                     synthesize_serve_grid)
    x, w = (8, 4, 8, 8), (8, 4, 3, 3)
    cases = [
        (ElasticPlan.plan_conv((2, 2, 1, 2, 1), x, w, n_devices),
         synthesize_dist_grid(x, w, n_devices),
         RefPlan.plan_conv((2, 2, 1, 2, 1), x, w, n_devices)),
        (ElasticPlan.plan_cnn((2, 2, 1, 1, 2), x, [8, 8], 10, n_devices),
         synthesize_cnn_grid(x, [8, 8], 10, n_devices),
         RefPlan.plan_cnn((2, 2, 1, 1, 2), x, [8, 8], 10, n_devices)),
    ]
    cfg = get_config("llama3.2-1b", smoke=True)
    from repro.configs import get_config as ref_config
    cases.append(
        (ElasticPlan.plan_serve((2, 2, 2), cfg, n_devices, slots=4,
                                max_seq=32),
         synthesize_serve_grid(cfg, n_devices, slots=4, max_seq=32),
         RefPlan.plan_serve((2, 2, 2), ref_config("llama3.2-1b", smoke=True),
                            n_devices, slots=4, max_seq=32)))
    for plan, choice, ref in cases:
        assert tuple(plan.new_shape) == tuple(choice.grid)
        assert (plan.old_shape, plan.new_shape, plan.reshard) == \
            (ref.old_shape, ref.new_shape, ref.reshard)
        assert plan.reshard == (tuple(choice.grid) != plan.old_shape)


# -------------------------------------------- resilient loop (in process) --

def _resilient_pieces():
    from repro_torch.dist.train import (ResilienceConfig,
                                        make_resilient_train_loop,
                                        make_synthetic_cnn_batches)
    from repro_torch.models.cnn import init_cnn
    from repro_torch.train.optim import AdamW

    def init():
        return init_cnn(torch.Generator().manual_seed(0), channels=[8, 8],
                        n_classes=10, in_channels=4, device="cpu")

    bf = make_synthetic_cnn_batches((8, 4, 8, 8), 10, device="cpu")
    return ResilienceConfig, make_resilient_train_loop, AdamW, init, bf


def test_synthetic_batches_are_deterministic_per_step():
    *_, bf = _resilient_pieces()
    a, b, c = bf(3), bf(3), bf(4)
    assert torch.equal(a["images"], b["images"])
    assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["images"], c["images"])
    assert a["images"].shape == (8, 4, 8, 8) and a["labels"].max() < 10


def test_resilient_loop_wedge_triggers_emergency_save(tmp_path):
    rc, make_loop, adamw, init, bf = _resilient_pieces()
    plan = FaultPlan(faults=(FaultSpec(kind="wedge", step=2, delay_s=0.6),))
    rcfg = rc(ckpt_dir=str(tmp_path), ckpt_every=100,
              watchdog_timeout_s=0.2)
    run = make_loop(adamw(lr=1e-2), rcfg, injector=FaultInjector(plan),
                    device="cpu")
    report = run(init, bf, 4)
    kinds = [e.kind for e in report["events"]]
    assert "inject" in kinds
    # the injected sleep at step 2 trips the watchdog (step 0 may wedge
    # too: its first call is slower than 0.2 s on a busy host)
    assert any(e.kind == "wedge" and e.step == 2 for e in report["events"])
    assert not report["preempted"] and len(report["losses"]) == 4
    steps = ck.CheckpointManager(str(tmp_path)).all_steps()
    assert steps, "wedge emergency save never committed"
    assert steps[0] <= 2 and steps[-1] == 4   # and the final save


def test_resilient_loop_restores_past_corrupt_step(tmp_path):
    rc, make_loop, adamw, init, bf = _resilient_pieces()
    run = make_loop(adamw(lr=1e-2), rc(ckpt_dir=str(tmp_path),
                                       ckpt_every=2), device="cpu")
    first = run(init, bf, 4)
    assert len(first["losses"]) == 4 and first["grid"] is None
    corrupt_chunk(str(tmp_path))  # the newest committed step
    resumed = run(init, bf, 6)
    kinds = [e.kind for e in resumed["events"]]
    assert "corrupt_ckpt" in kinds
    assert 0 < resumed["start_step"] < 4
    overlap = first["losses"][resumed["start_step"]:]
    np.testing.assert_allclose(resumed["losses"][:len(overlap)], overlap,
                               rtol=2e-4)


def test_resilient_loop_sigterm_saves_and_stops(tmp_path):
    rc, make_loop, adamw, init, bf = _resilient_pieces()
    plan = FaultPlan(faults=(FaultSpec(kind="sigterm", step=3),))
    run = make_loop(adamw(lr=1e-2), rc(ckpt_dir=str(tmp_path),
                                       ckpt_every=100),
                    injector=FaultInjector(plan), device="cpu")
    report = run(init, bf, 6)
    assert report["preempted"] and report["end_step"] == 3
    assert [e.kind for e in report["events"]] == ["inject", "sigterm"]
    assert ck.CheckpointManager(str(tmp_path)).all_steps() == [3]
    resumed = make_loop(adamw(lr=1e-2), rc(ckpt_dir=str(tmp_path)),
                        device="cpu")(init, bf, 6)
    assert resumed["start_step"] == 3 and resumed["end_step"] == 6
    assert not resumed["preempted"]


def test_resilient_loop_refuses_auto_grid_with_custom_loss():
    rc, make_loop, adamw, init, bf = _resilient_pieces()
    run = make_loop(adamw(), rc(), grid="auto", loss_fn=lambda p, b: 0.0,
                    device="cpu")
    with pytest.raises(ValueError, match="introspects the CNN params"):
        run(init, bf, 1)


# ------------------------------------------------------ serve degradation --

def test_serve_decode_wedge_dumps_engine_state(tmp_path):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ContinuousEngine, Request
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              dtype="float32")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    dump = tmp_path / "engine_state.json"
    log = FaultLog()
    plan = FaultPlan(faults=(FaultSpec(kind="wedge", step=1,
                                       point="decode", delay_s=0.6),))
    eng = ContinuousEngine(cfg, params, slots=2, max_seq=24,
                           prefill_bucket=8, decode_watchdog_timeout_s=0.15,
                           state_dump_path=str(dump), fault_log=log,
                           injector=FaultInjector(plan))
    stats = eng.serve([Request(rid=0, prompt=[1, 2, 3], max_new=6)])
    assert stats["statuses"][0] == "ok"  # the wedge cleared, serving went on
    assert len(stats["tokens"][0]) == 6
    snap = json.loads(dump.read_text())
    assert snap["event"] == "decode_wedge" and snap["iteration"] == 1
    assert snap["active"][0]["rid"] == 0
    assert any(e.kind == "wedge" and e.step == 1 for e in log.events)
    assert not os.path.exists(str(dump) + ".tmp")
