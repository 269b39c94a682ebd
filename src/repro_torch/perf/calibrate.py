"""Alpha-beta calibration of the distributed engine from bench records --
the port of ``repro/perf/calibrate.py``.

:func:`fit_collectives` turns bench records (the checked-in
``BENCH_comm.json`` / ``BENCH_serve.json`` records, ``perf/bench.py``'s
records from a card, plus synthetic per-collective micro-records) into a
:class:`CalibTable`: per collective kind (x schedule for the ring hops)
a latency ``alpha_ms`` per invocation and a bandwidth
``beta_ms_per_elem``, plus a compute rate (flops per ms) fitted from the
local-kernel records (``BENCH_kernels.json``, ``kernel/<layer>``).  A
table persists as JSON with provenance (host, torch version, platform,
device count and, on a card, its name and power limit, date) so a
prediction can always be traced to the machine it describes;
:func:`prediction_error_report` gives the relative error of
``predicted_ms`` vs ``wall_ms`` per record.

Fit model (matching :func:`repro_torch.perf.predict.replay_ms` exactly):

    wall = max(compute, sum_k beta_k * overlapped_elems_k)
         + sum_k alpha_k * steps_k + sum_k beta_k * serial_elems_k

The ``max`` makes the model piecewise-linear; the fit alternates a
weighted ridge least-squares solve with an active-set update (is the
overlapped byte time visible above compute, or hidden under it?), rows
weighted ``1 / wall`` so the objective matches the relative-error gate.
Parameters are held at zero or above by a non-negative least-squares
solve: a negative latency is a fitting artifact, not a machine property.

:func:`load_calib` resolves the table as the reference does: an
explicit path, the ``REPRO_CALIB`` environment variable, the checked-in
``CALIB.json`` at the repo root, else the nominal default -- so the two
packages price alike on the same checkout.  The CLI (``python -m
repro_torch.perf.calibrate``) reads the checked-in ``BENCH_*.json`` (or
``--root DIR``'s) and writes the table and its report into the
git-ignored ``perf_out/``, never over a checked-in file.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.perf import predict as _pred

#: The reference's gate: median noise-aware relative error of
#: predicted_ms vs wall_ms across the bench matrix.
CALIB_TOL = 0.5

#: Nominal fallback constants used when no CALIB.json exists yet —
#: rough CPU-host magnitudes so time-based synthesis stays runnable
#: (and clearly provenance-stamped as uncalibrated).
_DEFAULT_ALPHA_MS = 0.05
_DEFAULT_BETA_MS_PER_ELEM = 1e-4
_DEFAULT_FLOPS_PER_MS = 2e7


@dataclasses.dataclass(frozen=True)
class CalibEntry:
    """Alpha-beta constants of one collective kind (x schedule)."""

    alpha_ms: float
    beta_ms_per_elem: float
    n_obs: int = 0


@dataclasses.dataclass
class CalibTable:
    """The calibrated machine model the trace replay prices DAGs with."""

    collectives: Dict[str, CalibEntry]
    compute_flops_per_ms: float
    provenance: Dict = dataclasses.field(default_factory=dict)
    fit: Dict = dataclasses.field(default_factory=dict)

    def lookup(self, key: str) -> CalibEntry:
        """Exact key, else the kind prefix (``ppermute/ring`` ->
        ``ppermute``), else the nominal default entry."""
        ent = self.collectives.get(key)
        if ent is None and "/" in key:
            ent = self.collectives.get(key.split("/", 1)[0])
        if ent is None:
            ent = CalibEntry(_DEFAULT_ALPHA_MS, _DEFAULT_BETA_MS_PER_ELEM)
        return ent

    # ------------------------------------------------------ constructors --
    @classmethod
    def unit(cls) -> "CalibTable":
        """alpha=0, beta=1 ms/elem, infinite compute rate: predictions
        degenerate to the analytic element counts (the test anchor)."""
        ents = {k: CalibEntry(0.0, 1.0) for k in _pred.EVENT_KEYS}
        return cls(collectives=ents, compute_flops_per_ms=float("inf"),
                   provenance={"source": "unit"})

    @classmethod
    def default(cls) -> "CalibTable":
        ents = {k: CalibEntry(_DEFAULT_ALPHA_MS, _DEFAULT_BETA_MS_PER_ELEM)
                for k in _pred.EVENT_KEYS}
        return cls(collectives=ents,
                   compute_flops_per_ms=_DEFAULT_FLOPS_PER_MS,
                   provenance={"source": "default-uncalibrated"})

    # ------------------------------------------------------------- codec --
    def to_json(self) -> Dict:
        return {
            "collectives": {
                k: {"alpha_ms": e.alpha_ms,
                    "beta_ms_per_elem": e.beta_ms_per_elem,
                    "n_obs": e.n_obs}
                for k, e in sorted(self.collectives.items())},
            "compute_flops_per_ms": self.compute_flops_per_ms,
            "provenance": self.provenance,
            "fit": self.fit,
        }

    @classmethod
    def from_json(cls, obj: Dict) -> "CalibTable":
        ents = {k: CalibEntry(float(v["alpha_ms"]),
                              float(v["beta_ms_per_elem"]),
                              int(v.get("n_obs", 0)))
                for k, v in obj["collectives"].items()}
        return cls(collectives=ents,
                   compute_flops_per_ms=float(obj["compute_flops_per_ms"]),
                   provenance=dict(obj.get("provenance", {})),
                   fit=dict(obj.get("fit", {})))

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "CalibTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


#: Where the CLI writes by default, under the repo root (git-ignored).
OUT_DIR = "perf_out"
#: The checked-in files the CLI never writes.
CHECKED_IN = ("CALIB.json", "CALIB_report.json", "BENCH_comm.json",
              "BENCH_kernels.json", "BENCH_serve.json")


def repo_root() -> str:
    """src/repro_torch/perf -> the repo checkout root."""
    here = os.path.abspath(__file__)
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))


def calib_path(path: Optional[str] = None) -> Optional[str]:
    """The file :func:`load_calib` reads: ``path``, the ``REPRO_CALIB``
    env var, the checked-in ``CALIB.json`` at the repo root, whichever
    exists first; None for the nominal default table."""
    for cand in (path, os.environ.get("REPRO_CALIB"),
                 os.path.join(repo_root(), "CALIB.json")):
        if cand and os.path.exists(cand):
            return cand
    return None


def load_calib(path: Optional[str] = None) -> CalibTable:
    """The machine calibration: explicit ``path``, the ``REPRO_CALIB``
    env var, the checked-in ``CALIB.json`` at the repo root, else the
    nominal default table (provenance-stamped as uncalibrated)."""
    found = calib_path(path)
    return CalibTable.load(found) if found else CalibTable.default()


def provenance_line(path: Optional[str] = None) -> str:
    """One line naming the table :func:`load_calib` resolves and whose
    machine it describes, for a CLI that ranks grids by time."""
    found = calib_path(path)
    prov = load_calib(path).provenance
    who = (f"source={prov['source']}" if "source" in prov
           else f"host={prov.get('host')}")
    card = f" card={prov['card']}" if "card" in prov else ""
    return (f"[calib] table={found or 'default'} {who} "
            f"platform={prov.get('platform')} date={prov.get('date')}"
            + card)


# ------------------------------------------------------------ fitting ----

def fit_compute_rate(kernel_records: Sequence[Dict]) -> float:
    """flops/ms of the autotuned local kernels: the median rate of the
    ``BENCH_kernels.json`` records carrying a ``flops`` field."""
    rates = [r["flops"] / r["wall_ms"] for r in kernel_records
             if r.get("flops") and r.get("wall_ms", 0) > 0]
    if not rates:
        return _DEFAULT_FLOPS_PER_MS
    return float(np.median(rates))


def _nonneg_lstsq(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """min ||Ax - y|| s.t. x >= 0.  Clipping an unconstrained lstsq
    solution is NOT this (the active bounds shift every other
    coefficient); use a real NNLS solve, with the clipped solution only
    as a last-resort fallback."""
    try:
        from scipy.optimize import nnls
        sol, _ = nnls(A, y)
        return sol
    except Exception:
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
        return np.clip(sol, 0.0, None)


def _features(dag: _pred.StepDag, keys: List[str]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(alpha-steps, serial-elems, overlapped-elems) per key."""
    steps = np.zeros(len(keys))
    serial = np.zeros(len(keys))
    overl = np.zeros(len(keys))
    for ev in dag.events:
        i = keys.index(ev.key)
        steps[i] += ev.steps
        if ev.overlap:
            overl[i] += ev.elems
        else:
            serial[i] += ev.elems
    return steps, serial, overl


def fit_collectives(records: Iterable[Dict], *,
                    kernel_records: Sequence[Dict] = (),
                    compute_flops_per_ms: Optional[float] = None,
                    ridge: float = 1e-7, iters: int = 5,
                    provenance: Optional[Dict] = None) -> CalibTable:
    """Fit the alpha-beta table from bench records (see module doc).

    ``records`` are ``BENCH_comm.json`` / ``BENCH_serve.json`` style
    step records or per-collective micro-records (``{"kind", "elems",
    "steps", "wall_ms"}``); records the replay model cannot rebuild a
    DAG for are skipped.  The compute rate is taken from
    ``compute_flops_per_ms`` when given, else fitted from
    ``kernel_records``.
    """
    rate = (compute_flops_per_ms if compute_flops_per_ms is not None
            else fit_compute_rate(kernel_records))
    fit_recs: List[Tuple[Dict, _pred.StepDag]] = []
    for rec in records:
        if rec.get("wall_ms", 0) <= 0:
            continue
        dag = _pred.record_dag(rec)
        if dag is not None and dag.events:
            fit_recs.append((rec, dag))

    keys = sorted({ev.key for _, dag in fit_recs for ev in dag.events})
    n_obs = {k: sum(1 for _, dag in fit_recs
                    if any(ev.key == k for ev in dag.events))
             for k in keys}
    if not fit_recs:
        table = CalibTable.default()
        table.compute_flops_per_ms = rate
        table.provenance = _provenance(provenance, 0)
        return table

    walls = np.array([r["wall_ms"] for r, _ in fit_recs])
    computes = np.array([dag.flops / rate if np.isfinite(rate) else 0.0
                         for _, dag in fit_recs])
    feats = [_features(dag, keys) for _, dag in fit_recs]
    nk = len(keys)

    # active set: overlapped byte time visible above compute?
    visible = computes < walls * 0.5
    theta = np.zeros(2 * nk)                 # [alpha_0..; beta_0..]
    for _ in range(iters):
        rows, ys = [], []
        for i, (steps, serial, overl) in enumerate(feats):
            byte_col = serial + (overl if visible[i] else 0.0)
            row = np.concatenate([steps, byte_col])
            y = walls[i] - (0.0 if visible[i] else computes[i])
            w = 1.0 / walls[i]               # relative-error weighting
            rows.append(row * w)
            ys.append(y * w)
        A = np.array(rows)
        y = np.array(ys)
        # column scaling + ridge for the (often underdetermined) solve
        scale = np.linalg.norm(A, axis=0)
        scale[scale == 0] = 1.0
        A_s = np.vstack([A / scale, np.sqrt(ridge) * np.eye(2 * nk)])
        y_s = np.concatenate([y, np.zeros(2 * nk)])
        theta = _nonneg_lstsq(A_s, y_s) / scale
        beta = theta[nk:]
        new_visible = np.array([
            float(beta @ feats[i][2]) + float(beta @ feats[i][1])
            > computes[i]
            for i in range(len(fit_recs))])
        if np.array_equal(new_visible, visible):
            break
        visible = new_visible

    ents = {k: CalibEntry(float(theta[i]), float(theta[nk + i]),
                          n_obs=n_obs[k])
            for i, k in enumerate(keys)}
    table = CalibTable(collectives=ents, compute_flops_per_ms=rate,
                       provenance=_provenance(provenance, len(fit_recs)))
    preds = np.array([_pred.replay_ms(dag, table) for _, dag in fit_recs])
    rel = np.abs(preds - walls) / walls
    table.fit = {"n_fit_records": len(fit_recs),
                 "median_rel_err": float(np.median(rel)),
                 "max_rel_err": float(np.max(rel))}
    return table


def card_name_and_power() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card
    (``name, power.limit``), or None where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _provenance(extra: Optional[Dict], n_records: int) -> Dict:
    prov = {"host": socket.gethostname(),
            "date": datetime.date.today().isoformat(),
            "n_records": n_records}
    try:
        import torch
        prov["torch"] = torch.__version__
        on_card = torch.cuda.is_available()
        prov["platform"] = "cuda" if on_card else "cpu"
        prov["device_count"] = torch.cuda.device_count() if on_card else 1
        if on_card:
            prov["device"] = torch.cuda.get_device_name(0)
            card = card_name_and_power()
            if card:
                prov["card"] = card
    except Exception:
        pass
    if extra:
        prov.update(extra)
    return prov


# ------------------------------------------------------ error report ----

def noise_aware_rel_err(predicted_ms: float, wall_ms: float,
                        std_ms: float = 0.0, reps: int = 1) -> float:
    """Relative error of a prediction against a noisy measurement: the
    residual below two standard errors of the timing mean counts as
    noise, not drift."""
    noise = 2.0 * std_ms / max(np.sqrt(max(reps, 1)), 1.0)
    return max(0.0, abs(predicted_ms - wall_ms) - noise) / max(
        wall_ms, 1e-9)


def prediction_error_report(records: Iterable[Dict],
                            calib: CalibTable) -> Dict:
    """Per-record ``predicted_ms`` vs ``wall_ms`` plus summary medians —
    what ``chip_smoke.py`` prints for the card's table."""
    rows = []
    for rec in records:
        dag = _pred.record_dag(rec)
        if dag is None or rec.get("wall_ms", 0) <= 0:
            continue
        pred = _pred.replay_ms(dag, calib)
        wall = rec["wall_ms"]
        rows.append({
            "name": rec.get("name", dag.name),
            "grid": rec.get("grid"),
            "schedule": rec.get("schedule"),
            "wall_ms": wall,
            "std_ms": rec.get("std_ms", 0.0),
            "reps": rec.get("reps", 1),
            "predicted_ms": pred,
            "rel_err": abs(pred - wall) / wall,
            "noise_aware_rel_err": noise_aware_rel_err(
                pred, wall, rec.get("std_ms", 0.0), rec.get("reps", 1)),
        })
    errs = [r["noise_aware_rel_err"] for r in rows]
    summary = {"n_records": len(rows),
               "median_rel_err": float(np.median(errs)) if errs else 0.0,
               "max_rel_err": float(np.max(errs)) if errs else 0.0,
               "tol": CALIB_TOL}
    return {"summary": summary, "records": rows}


def annotate_predictions(records: List[Dict], calib: CalibTable) -> None:
    """Write a ``predicted_ms`` column next to every ``wall_ms`` the
    replay model can price (in place; unpriceable records are left
    untouched)."""
    for rec in records:
        dag = _pred.record_dag(rec)
        if dag is not None:
            rec["predicted_ms"] = _pred.replay_ms(dag, calib)


def _load_bench(root: str) -> Tuple[List[Dict], List[Dict], List[Dict]]:
    out = []
    for fname in ("BENCH_comm.json", "BENCH_kernels.json",
                  "BENCH_serve.json"):
        path = os.path.join(root, fname)
        if os.path.exists(path):
            with open(path) as f:
                out.append(json.load(f))
        else:
            out.append([])
    return tuple(out)


def _refuse_checked_in(path: str) -> None:
    """The CLI writes no checked-in file of the repo."""
    target = os.path.abspath(path)
    for name in CHECKED_IN:
        if target == os.path.join(repo_root(), name):
            raise SystemExit(f"[calib] refusing to write the checked-in "
                             f"{name}; pick a path under {OUT_DIR}/")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fit a calibration table from BENCH_*.json records "
                    "and report the prediction error")
    ap.add_argument("--root", default=repo_root(),
                    help="directory holding BENCH_*.json, read only "
                         "(default: the repo root's checked-in records)")
    ap.add_argument("--out", default=None,
                    help=f"table path (default: {OUT_DIR}/CALIB.json "
                         f"under the repo root)")
    ap.add_argument("--report", default=None,
                    help=f"error-report path (default: "
                         f"{OUT_DIR}/CALIB_report.json)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 when the median noise-aware relative "
                         "error exceeds --tol")
    ap.add_argument("--tol", type=float, default=CALIB_TOL)
    args = ap.parse_args(argv)

    out_dir = os.path.join(repo_root(), OUT_DIR)
    out = args.out or os.path.join(out_dir, "CALIB.json")
    rpath = args.report or os.path.join(out_dir, "CALIB_report.json")
    for path in (out, rpath):
        _refuse_checked_in(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    comm, kern, serve = _load_bench(args.root)
    table = fit_collectives(comm + serve, kernel_records=kern)
    table.save(out)
    report = prediction_error_report(comm + kern + serve, table)
    with open(rpath, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    s = report["summary"]
    print(f"[calib] {s['n_records']} records, median rel err "
          f"{s['median_rel_err']:.3f}, max {s['max_rel_err']:.3f} "
          f"(tol {args.tol}); wrote {out} + {rpath}")
    for row in report["records"]:
        print(f"  {row['name']}/{row['schedule']}: wall "
              f"{row['wall_ms']:.3f}ms predicted "
              f"{row['predicted_ms']:.3f}ms "
              f"(err {row['rel_err']:.2f})")
    if args.check and s["median_rel_err"] > args.tol:
        print(f"[calib] FAIL: median rel err {s['median_rel_err']:.3f} "
              f"> tol {args.tol}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
