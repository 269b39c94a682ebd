"""Best-of runtime autotuner for the local-kernel menu -- the port of
``repro/kernels/autotune.py``.

``best_of(key, candidates, make_args)`` times every applicable candidate
once per unique problem key on freshly drawn operands, memoizes the
winner and persists the plan table to a JSON file:

* in-memory memo: one timing pass per key per process;
* on disk: ``.repro_torch_autotune.json`` (override with
  ``REPRO_TORCH_AUTOTUNE_CACHE``), reloaded lazily, written atomically
  after each new measurement, machine-specific, never checked in.  The
  port keeps its own file and variables: the JAX package's
  ``.repro_autotune.json`` holds winners timed on another machine under
  the same key strings;
* ``REPRO_TORCH_AUTOTUNE``: ``1`` (default) tunes, ``0`` turns the tuner
  off (callers take their static paper-plan dispatch), ``refresh``
  ignores persisted winners and re-times each key once this process.

:func:`autotune_disabled` is the in-process ``REPRO_TORCH_AUTOTUNE=0``.

Timing: on the card, CUDA events on the current stream around ``reps``
calls after one warm call; on the CPU, ``time.perf_counter``; always
under ``torch.no_grad()``.  A candidate that raises reads ``inf``,
except in two cases, which propagate out of :func:`best_of`: a
:class:`~repro_torch.kernels._build.KernelError` (a hand-written kernel
that fails to build or launch), and any failure of a candidate that is
not a library call (:data:`LIBRARY`) on operands on the card -- there a
hand-written candidate has no reason to fail, and losing the race to
the library would hide the fault.  Every rank of a process group tunes on its own, so
multi-rank runs that must agree bit for bit pin the plan (tuner off or a
seeded table).  The candidate menus live in ``kernels.ops``.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels._build import KernelError

MODE_ENV = "REPRO_TORCH_AUTOTUNE"
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
DEFAULT_CACHE = ".repro_torch_autotune.json"
_SCHEMA_VERSION = 1
# candidate names that stand for one library call (``F.conv2d``,
# ``torch.matmul``, ``torch.bmm``); every other candidate reaches a
# hand-written kernel
LIBRARY = frozenset({"xla", "einsum"})

_disabled_depth = 0


def mode() -> str:
    """``"1"`` | ``"0"`` | ``"refresh"`` (unknown values read as "1")."""
    return os.environ.get(MODE_ENV, "1")


def enabled() -> bool:
    """True when the tuner may run (env not ``0``, no
    :func:`autotune_disabled` scope active)."""
    return mode() != "0" and _disabled_depth == 0


@contextlib.contextmanager
def autotune_disabled():
    """Force the static paper-plan dispatch within the scope."""
    global _disabled_depth
    _disabled_depth += 1
    try:
        yield
    finally:
        _disabled_depth -= 1


# --------------------------------------------------------------------------
# The persistable plan table
# --------------------------------------------------------------------------

class PlanCache:
    """Winner-per-key table with lazy JSON load and atomic save.

    Entries: ``{key: {"impl": name, "wall_ms": {candidate: ms}}}``."""

    def __init__(self, path: Optional[str] = None):
        self._path_override = path
        self._mem: Dict[str, dict] = {}
        self._loaded_from: Optional[str] = None

    @property
    def path(self) -> str:
        return (self._path_override
                or os.environ.get(CACHE_ENV, DEFAULT_CACHE))

    def _load(self) -> None:
        path = self.path
        if self._loaded_from == path:
            return
        self._loaded_from = path
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            plans = data.get("plans", {}) if isinstance(data, dict) else {}
            for key, ent in plans.items():
                self._mem.setdefault(key, ent)
        except (OSError, ValueError):
            pass  # missing/corrupt cache: re-time

    def lookup(self, key: str, *, allow_file: bool = True) -> Optional[dict]:
        if key in self._mem:
            return self._mem[key]
        if allow_file:
            self._load()
        return self._mem.get(key)

    def record(self, key: str, impl: str,
               wall_ms: Dict[str, float]) -> None:
        self._mem[key] = {"impl": impl, "wall_ms": wall_ms}
        self.save()

    def save(self) -> None:
        """Atomic best-effort write (a read-only FS must not break
        dispatch)."""
        path = self.path
        payload = {"version": _SCHEMA_VERSION, "plans": self._mem}
        try:
            d = os.path.dirname(os.path.abspath(path))
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            pass

    def reset(self) -> None:
        self._mem.clear()
        self._loaded_from = None


_cache = PlanCache()


def plan_cache() -> PlanCache:
    """The process-wide plan table."""
    return _cache


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def _time_ms(fn: Callable, args: tuple, *, reps: int,
             strict: bool = False) -> float:
    """Best-of-``reps`` ms of ``fn(*args)`` after one warm call: device
    time from CUDA events on the card, ``perf_counter`` on the CPU.
    ``inf`` when the candidate fails, except a :class:`KernelError` or,
    with ``strict``, any exception: those propagate."""
    try:
        with torch.no_grad():
            fn(*args)
            if _on_card(args):
                stream = torch.cuda.current_stream()
                best = float("inf")
                for _ in range(reps):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                    fn(*args)
                    end.record(stream)
                    end.synchronize()
                    best = min(best, start.elapsed_time(end))
                return best
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(*args)
                best = min(best, (time.perf_counter() - t0) * 1e3)
            return best
    except KernelError:
        raise
    except Exception:
        if strict:
            raise
        return float("inf")


def best_of(key: str, candidates: Sequence[Tuple[str, Callable]],
            make_args: Callable[[], tuple], *, reps: int = 2) -> str:
    """Winning implementation name for ``key``.

    ``candidates`` is an ordered ``(name, fn)`` menu (first entry wins
    ties and is the fallback when every candidate fails); ``make_args``
    draws the operands the timing pass runs on.  The winner is memoized
    in the process-wide :class:`PlanCache` and persisted."""
    names = [n for n, _ in candidates]
    if len(names) == 1:
        return names[0]
    ent = _cache.lookup(key, allow_file=mode() != "refresh")
    if ent and ent.get("impl") in names:
        return ent["impl"]
    args = make_args()
    on_card = _on_card(args)
    wall_ms = {name: _time_ms(fn, args, reps=reps,
                              strict=on_card and name not in LIBRARY)
               for name, fn in candidates}
    if all(t == float("inf") for t in wall_ms.values()):
        # timing impossible here: fall back to the static choice and
        # leave the key untuned for a later pass
        return names[0]
    impl = min(names, key=lambda n: wall_ms[n])  # first-listed wins ties
    _cache.record(key, impl, wall_ms)
    return impl
