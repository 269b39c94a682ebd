"""Wedged-step watchdog and the structured fault-event log -- the port of
``repro/fault/watchdog.py`` (pure Python, the same in both packages).

A training (or decode) step that blocks forever -- a peer died mid
all-reduce, a ring exchange deadlocked -- never returns to Python, so the
mitigation cannot live on the thread running the step.
:class:`StepWatchdog` runs a daemon thread that watches an armed
deadline; when a step overstays ``timeout_s`` it emits a structured
:class:`FaultEvent` and calls ``on_wedge`` (typically a checkpoint of the
last *completed* state -- the wedged step itself has produced nothing
worth saving).

Every recovery path of the runtime reports through :class:`FaultLog`: an
in-memory event list, optionally mirrored as JSON lines to disk so a
post-mortem can reconstruct what the runtime saw.  Events are plain
dataclasses; ``dataclasses.asdict`` round-trips them through JSON.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class FaultEvent:
    """One structured entry in the fault log.

    ``kind`` is the failure-model vocabulary: ``sigterm`` (preemption),
    ``wedge`` (watchdog fired), ``straggler`` (StragglerMonitor
    mitigation), ``corrupt_ckpt`` (checksum-failed restore, fell back),
    ``mid_save_crash`` / ``inject`` (fault-injection bookkeeping),
    ``elastic_plan`` (grid re-synthesis on restart).
    """

    kind: str
    step: int
    detail: str = ""
    t: float = dataclasses.field(default_factory=time.time)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class FaultLog:
    """Append-only event log; thread-safe (watchdog/saver threads emit
    concurrently with the train loop).  ``path`` mirrors events to a
    JSON-lines file, one flushed line per event, so a killed process
    still leaves its trace."""

    def __init__(self, path: Optional[str] = None):
        self.events: List[FaultEvent] = []
        self.path = path
        self._lock = threading.Lock()

    def emit(self, event: FaultEvent) -> FaultEvent:
        with self._lock:
            self.events.append(event)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(event.to_json()) + "\n")
                    f.flush()
        return event

    def kinds(self) -> List[str]:
        with self._lock:
            return [e.kind for e in self.events]


class StepWatchdog:
    """Timeout around the step future.

    Usage::

        wd = StepWatchdog(timeout_s=300, on_wedge=save_last_good)
        for step in range(start, steps):
            with wd.watch(step):
                state, metrics = step_fn(state, batch)
        wd.close()

    The watchdog thread polls the armed deadline; a step that overstays
    fires ``on_wedge(step, elapsed_s)`` exactly once per armed step and
    logs a ``wedge`` :class:`FaultEvent`.  ``on_wedge`` runs on the
    watchdog thread while the main thread is still blocked in the
    wedged step — it must only touch the last *completed* state (host
    snapshots are safe; the in-flight step is lost by definition).
    Exceptions from ``on_wedge`` are captured as ``wedge_handler_error``
    events, never propagated into the poll loop.
    """

    def __init__(self, timeout_s: float,
                 on_wedge: Optional[Callable[[int, float], None]] = None,
                 *, log: Optional[FaultLog] = None,
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.on_wedge = on_wedge
        self.log = log if log is not None else FaultLog()
        self.poll_s = poll_s if poll_s is not None \
            else max(min(0.05, self.timeout_s / 4), 0.005)
        self.fired: List[FaultEvent] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._armed_at: Optional[float] = None
        self._step: int = -1
        self._fired_this_arm = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ control --

    def arm(self, step: int) -> None:
        with self._lock:
            self._armed_at = time.monotonic()
            self._step = step
            self._fired_this_arm = False

    def disarm(self) -> None:
        with self._lock:
            self._armed_at = None

    @contextlib.contextmanager
    def watch(self, step: int):
        self.arm(step)
        try:
            yield self
        finally:
            self.disarm()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)

    # --------------------------------------------------------------- loop --

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                armed_at = self._armed_at
                step = self._step
                already = self._fired_this_arm
            if armed_at is None or already:
                continue
            elapsed = time.monotonic() - armed_at
            if elapsed <= self.timeout_s:
                continue
            with self._lock:
                if self._fired_this_arm or self._armed_at is None:
                    continue
                self._fired_this_arm = True
            event = FaultEvent(
                kind="wedge", step=step,
                detail=f"step exceeded watchdog timeout "
                       f"{self.timeout_s:.3g}s (elapsed {elapsed:.3g}s)")
            self.fired.append(event)
            self.log.emit(event)
            if self.on_wedge is not None:
                try:
                    self.on_wedge(step, elapsed)
                except Exception as e:  # never kill the poll loop
                    self.log.emit(FaultEvent(
                        kind="wedge_handler_error", step=step,
                        detail=f"{type(e).__name__}: {e}"))
