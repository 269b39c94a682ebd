"""Fault tolerance: step-time straggler detection, heartbeats, emergency
checkpoints and elastic-restart planning -- the port of
``repro/fault/monitor.py``.

The failure model: (a) hard node loss -- checkpoint and restart, the
chunked checkpoint (``ckpt/checkpointer.py``) restoring onto any grid;
(b) stragglers -- detected here from step-time EMA z-scores, the runner
responding by checkpointing; (c) wedged steps -- a watchdog around the
step (``fault/watchdog.py``) triggers an emergency save.  The loop that
wires them together is ``dist/train.py::make_resilient_train_loop``;
fault injection is ``fault/inject.py``.  :class:`ElasticPlan`'s grid
planners call the port's ``core.sharding_synthesis``.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, List


@dataclasses.dataclass
class StepStats:
    ema: float = 0.0
    var: float = 0.0
    n: int = 0

    def update(self, dt: float, alpha: float = 0.1):
        if self.n == 0:
            self.ema, self.var = dt, 0.0
        else:
            d = dt - self.ema
            self.ema += alpha * d
            self.var = (1 - alpha) * (self.var + alpha * d * d)
        self.n += 1

    @property
    def std(self) -> float:
        return self.var ** 0.5


class StragglerMonitor:
    """Flags steps slower than ema + z*std; tracks consecutive anomalies."""

    def __init__(self, *, z: float = 3.0, patience: int = 3,
                 warmup_steps: int = 5):
        self.stats = StepStats()
        self.z = z
        self.patience = patience
        self.warmup = warmup_steps
        self.consecutive = 0
        self.events: List[dict] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True when mitigation should trigger."""
        is_slow = (self.stats.n >= self.warmup
                   and dt > self.stats.ema
                   + self.z * max(self.stats.std,
                                  0.05 * self.stats.ema))
        if is_slow:
            self.consecutive += 1
            self.events.append({"step": step, "dt": dt,
                                "ema": self.stats.ema})
        else:
            self.consecutive = 0
            self.stats.update(dt)
        return self.consecutive >= self.patience


class Heartbeat:
    """Background liveness file/callback writer; a dead heartbeat is how the
    cluster controller detects a wedged host."""

    def __init__(self, beat_fn: Callable[[float], None],
                 interval_s: float = 10.0):
        self.beat_fn = beat_fn
        self.interval = interval_s
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            self.beat_fn(time.time())

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=2)


class EmergencySaver:
    """Installs SIGTERM/SIGINT handlers that run a checkpoint callback
    before exit (preemption-safe training)."""

    def __init__(self, save_fn: Callable[[], None]):
        self.save_fn = save_fn
        self.triggered = False
        self._orig = {}

    def install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._orig[sig] = signal.getsignal(sig)
            signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        if not self.triggered:
            self.triggered = True
            self.save_fn()
        orig = self._orig.get(signum)
        if callable(orig):
            orig(signum, frame)

    def uninstall(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Decision record for an elastic restart: given surviving devices,
    choose the largest feasible mesh and the resharding strategy.

    Two regimes:

    * :meth:`plan` — the simple GSPMD data/model mesh: keep the model
      axis, shrink data parallelism to the survivors;
    * :meth:`plan_conv` / :meth:`plan_cnn` / :meth:`plan_serve` — the
      ``repro_torch.dist`` runtime grids, where the optimal
      ``(Pb, Ph, Pw, Pk, Pc)`` / ``(Pm, Pn, Pc)`` factorization is a
      function of the device count (the 2.5D memory/wire tradeoff), so
      losing a host means *re-synthesizing* the grid over the
      survivors, not just shrinking an axis.  These delegate to
      ``core.sharding_synthesis.synthesize_dist_grid`` /
      ``synthesize_cnn_grid`` / ``synthesize_serve_grid``; the chunked
      checkpoint format re-assembles and re-shards onto whatever grid
      comes back.
    """

    old_shape: tuple
    new_shape: tuple
    reshard: bool

    @staticmethod
    def plan(old_shape: tuple, n_devices: int, *, model_axis: int
             ) -> "ElasticPlan":
        """Keep the model axis (TP degree is architecture-determined),
        shrink the data axis to what the surviving devices support.

        Only data/model-style meshes of rank >= 2 are plannable here —
        anything else (a runtime conv/matmul grid, a rank-1 mesh) is
        refused; use the grid-aware planners instead of silently
        writing the data degree into an axis that means something else.
        """
        rank = len(old_shape)
        if rank < 2:
            raise ValueError(
                f"ElasticPlan.plan needs a rank>=2 data/model mesh, got "
                f"{old_shape}; runtime grids re-synthesize via "
                f"plan_conv/plan_cnn/plan_serve")
        if not -rank <= model_axis < rank:
            raise ValueError(
                f"model_axis {model_axis} out of range for mesh shape "
                f"{old_shape}")
        model_axis %= rank
        model = old_shape[model_axis]
        if model < 1 or n_devices < model:
            raise ValueError(
                f"cannot keep model degree {model} of {old_shape} with "
                f"only {n_devices} surviving devices")
        data = max(1, n_devices // model)
        new = [1] * rank
        new[model_axis] = model
        # fold all data parallelism into the leading non-model axis
        new[0 if model_axis != 0 else 1] = data
        return ElasticPlan(old_shape=tuple(old_shape),
                           new_shape=tuple(new),
                           reshard=tuple(new) != tuple(old_shape))

    @staticmethod
    def plan_conv(old_grid: tuple, x_shape, w_shape, n_devices: int, *,
                  stride=(1, 1), padding="SAME",
                  schedule: str = "allgather",
                  mem_cap_elems=None) -> "ElasticPlan":
        """Re-synthesize a single conv layer's ``(Pb,Ph,Pw,Pk,Pc)``
        grid over the surviving devices."""
        from repro_torch.core.sharding_synthesis import synthesize_dist_grid
        choice = synthesize_dist_grid(
            x_shape, w_shape, n_devices, stride=stride, padding=padding,
            schedule=schedule, mem_cap_elems=mem_cap_elems)
        return ElasticPlan(old_shape=tuple(old_grid),
                           new_shape=tuple(choice.grid),
                           reshard=tuple(choice.grid) != tuple(old_grid))

    @staticmethod
    def plan_cnn(old_grid: tuple, x_shape, channels, n_classes: int,
                 n_devices: int, *, k: int = 3, pool_every: int = 2,
                 schedule: str = "allgather",
                 mem_cap_elems=None) -> "ElasticPlan":
        """Re-synthesize ONE ``(Pb,Ph,Pw,Pk,Pc)`` grid that divides
        every layer of the CNN — the whole-model elastic restart."""
        from repro_torch.core.sharding_synthesis import synthesize_cnn_grid
        choice = synthesize_cnn_grid(
            x_shape, channels, n_classes, n_devices, k=k,
            pool_every=pool_every, schedule=schedule,
            mem_cap_elems=mem_cap_elems)
        return ElasticPlan(old_shape=tuple(old_grid),
                           new_shape=tuple(choice.grid),
                           reshard=tuple(choice.grid) != tuple(old_grid))

    @staticmethod
    def plan_serve(old_grid: tuple, cfg, n_devices: int, *, slots: int,
                   max_seq: int, schedule: str = "allgather",
                   mem_cap_elems=None) -> "ElasticPlan":
        """Re-synthesize the LM serving ``(Pm,Pn,Pc)`` grid over the
        surviving devices (KV-cache memory cap still enforced)."""
        from repro_torch.core.sharding_synthesis import synthesize_serve_grid
        choice = synthesize_serve_grid(
            cfg, n_devices, slots=slots, max_seq=max_seq,
            schedule=schedule, mem_cap_elems=mem_cap_elems)
        return ElasticPlan(old_shape=tuple(old_grid),
                           new_shape=tuple(choice.grid),
                           reshard=tuple(choice.grid) != tuple(old_grid))
