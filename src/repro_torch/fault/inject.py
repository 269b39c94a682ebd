"""Deterministic fault injection: every recovery path must be testable --
the port of ``repro/fault/inject.py``.

A :class:`FaultPlan` is a declarative list of faults keyed by
``(point, step)``: the runtime calls ``injector.fire(point, step, ctx)``
at its injection points (``"step"`` at the top of each armed train step,
``"decode"`` at the top of each serve decode iteration) and the injector
applies exactly the faults the plan schedules there.  Plans round-trip
through JSON (``to_json`` / ``from_json``) and through the same
``REPRO_FAULT_PLAN`` environment variable the reference reads, so one
plan drives either package's ``launch/train.py``.

Fault kinds (the runtime's failure model):

``sigterm``
    Preemption: the injector SIGTERMs its own process.  The installed
    ``EmergencySaver`` checkpoints the last completed state, and the
    resilient loop stops cleanly at the next step.
``wedge``
    A wedged or slow step: sleeps ``delay_s`` inside the watchdog
    window, so the ``StepWatchdog`` fires its emergency save.
``crash_mid_save``
    Arms a hook in ``ckpt.checkpointer.save`` that raises
    :class:`MidSaveCrash` after ``after_chunks`` chunk writes: the
    ``.tmp`` directory is left uncommitted and the previous checkpoint
    must survive (the atomicity proof).
``corrupt_chunk``
    Silent disk corruption: flips bytes in one chunk file of the newest
    committed checkpoint, ``_COMMITTED`` left in place; the crc32 check
    on restore must catch it and fall back.
``drop_devices``
    Bookkeeping only (recorded as an event): the launcher restarts with
    fewer ranks, and the resilient loop re-synthesizes the grid over the
    ranks it finds.

Under SPMD every rank fires the same plan.  The kinds that touch files
(``crash_mid_save``, ``corrupt_chunk``) take effect only on the rank that
saves, rank 0 (``ctx["rank"]``): eight ranks flipping the same bytes
would leave an even number of flips, and the chunk intact.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict, List, Optional

from repro_torch.ckpt import checkpointer as _ck
from repro_torch.fault.watchdog import FaultEvent, FaultLog

KINDS = ("sigterm", "wedge", "crash_mid_save", "corrupt_chunk",
         "drop_devices")
FILE_KINDS = ("crash_mid_save", "corrupt_chunk")   # rank 0 only

ENV_VAR = "REPRO_FAULT_PLAN"


class MidSaveCrash(RuntimeError):
    """Raised by the injected checkpoint hook to simulate a crash in the
    middle of a save (before the atomic commit rename)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` fires when the runtime reaches
    injection point ``point`` at ``step``."""

    kind: str
    step: int
    point: str = "step"          # "step" (train) | "decode" (serve)
    delay_s: float = 0.0         # wedge duration
    leaf_id: int = 0             # corrupt_chunk target leaf
    chunk: int = 0               # corrupt_chunk target chunk
    after_chunks: int = 1        # crash_mid_save: chunks written first
    n_devices: int = 0           # drop_devices bookkeeping

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind must be one of {KINDS}, "
                             f"got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of faults."""

    faults: tuple = ()

    def at(self, point: str, step: int) -> List[FaultSpec]:
        return [f for f in self.faults
                if f.point == point and f.step == step]

    def to_json(self) -> str:
        return json.dumps(
            {"faults": [dataclasses.asdict(f) for f in self.faults]})

    @staticmethod
    def from_json(text: str) -> "FaultPlan":
        data = json.loads(text)
        return FaultPlan(faults=tuple(FaultSpec(**f)
                                      for f in data.get("faults", [])))

    @staticmethod
    def from_env(var: str = ENV_VAR) -> Optional["FaultPlan"]:
        text = os.environ.get(var, "")
        return FaultPlan.from_json(text) if text else None


def latest_committed_dir(root: str) -> str:
    """Directory of the newest committed checkpoint under ``root``."""
    mgr = _ck.CheckpointManager(root)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {root}")
    return mgr._dir(step)


def corrupt_chunk(root: str, *, step: Optional[int] = None,
                  leaf_id: int = 0, chunk: int = 0,
                  nbytes: int = 16) -> str:
    """Flip the trailing ``nbytes`` of one chunk file of a *committed*
    checkpoint (the newest, or ``step``), leaving ``_COMMITTED`` in place:
    the silent disk corruption the crc32s exist to catch.  Returns the
    corrupted file's path."""
    d = (latest_committed_dir(root) if step is None
         else _ck.CheckpointManager(root)._dir(step))
    path = os.path.join(d, f"{leaf_id}.c{chunk}.npy")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = min(nbytes, max(1, len(data) // 2))
    for i in range(len(data) - n, len(data)):
        data[i] ^= 0xFF
    with open(path, "wb") as f:
        f.write(data)
    return path


def install_mid_save_crash(after_chunks: int = 1) -> None:
    """Arm ``ckpt.checkpointer`` to crash after ``after_chunks`` chunk
    writes of the *next* save.  One-shot: the hook disarms itself before
    raising, so a retried or resumed save goes through."""
    seen = {"n": 0}

    def hook(leaf_id: int, chunk_idx: int) -> None:
        seen["n"] += 1
        if seen["n"] >= after_chunks:
            _ck._chunk_hook = None
            raise MidSaveCrash(
                f"injected crash after {seen['n']} chunk writes "
                f"(leaf {leaf_id}, chunk {chunk_idx})")

    _ck._chunk_hook = hook


def clear_mid_save_crash() -> None:
    _ck._chunk_hook = None


class FaultInjector:
    """Applies a :class:`FaultPlan` at the runtime's injection points.

    ``ctx`` keys the fault kinds read: ``ckpt_root`` (the checkpoint
    directory, for ``corrupt_chunk``) and ``rank`` (0 when absent; the
    kinds in :data:`FILE_KINDS` act on rank 0 only).  Every fault the
    plan schedules is recorded as an ``inject`` :class:`FaultEvent` in
    ``log`` before it fires, on every rank, so a post-mortem tells
    injected failures from organic ones."""

    def __init__(self, plan: FaultPlan, *,
                 log: Optional[FaultLog] = None):
        self.plan = plan
        self.log = log if log is not None else FaultLog()
        self.applied: List[FaultSpec] = []

    def fire(self, point: str, step: int,
             ctx: Optional[Dict] = None) -> None:
        ctx = ctx or {}
        for spec in self.plan.at(point, step):
            self.log.emit(FaultEvent(
                kind="inject", step=step,
                detail=f"{spec.kind} at {point}@{step}"))
            self.applied.append(spec)
            if spec.kind in FILE_KINDS and ctx.get("rank", 0) != 0:
                continue
            self._apply(spec, ctx)

    def _apply(self, spec: FaultSpec, ctx: Dict) -> None:
        if spec.kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif spec.kind == "wedge":
            time.sleep(spec.delay_s)
        elif spec.kind == "crash_mid_save":
            install_mid_save_crash(spec.after_chunks)
        elif spec.kind == "corrupt_chunk":
            root = ctx.get("ckpt_root")
            if not root:
                raise ValueError(
                    "corrupt_chunk fault needs ctx['ckpt_root']")
            corrupt_chunk(root, leaf_id=spec.leaf_id, chunk=spec.chunk)
        # drop_devices: the launcher's restart owns the rank count
