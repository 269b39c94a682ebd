"""Fault-tolerant runtime -- the port of ``repro/fault``: monitoring,
watchdog, deterministic fault injection, elastic-restart planning.

- ``monitor``: StragglerMonitor / Heartbeat / EmergencySaver /
  ElasticPlan (with the grid-aware ``plan_conv`` / ``plan_cnn`` /
  ``plan_serve`` re-synthesis);
- ``watchdog``: StepWatchdog around a step, and the structured
  FaultEvent / FaultLog every recovery path reports through;
- ``inject``: FaultPlan / FaultInjector, deterministic, JSON-scriptable
  fault injection (SIGTERM, wedge, mid-save crash, chunk corruption) so
  every recovery path is testable.
"""

from repro_torch.fault.inject import (FaultInjector, FaultPlan, FaultSpec,
                                      MidSaveCrash)
from repro_torch.fault.monitor import (ElasticPlan, EmergencySaver,
                                       Heartbeat, StragglerMonitor)
from repro_torch.fault.watchdog import FaultEvent, FaultLog, StepWatchdog

__all__ = [
    "ElasticPlan", "EmergencySaver", "FaultEvent", "FaultInjector",
    "FaultLog", "FaultPlan", "FaultSpec", "Heartbeat", "MidSaveCrash",
    "StepWatchdog", "StragglerMonitor",
]
