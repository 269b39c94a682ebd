"""Measured performance model of the distributed engine -- the port of
``repro/perf``.

Three layers:

1. **calibrate** (:mod:`repro_torch.perf.calibrate`) -- fit per-collective
   alpha-beta constants and a local-kernel compute rate from bench
   records (the checked-in ``BENCH_*.json``, or ``perf/bench.py``'s from
   a card), persisted as a JSON table with provenance (host, torch,
   platform, card, date).
2. **predict** (:mod:`repro_torch.perf.predict`) -- replay a step's
   per-layer op DAG (tile-model compute + calibrated collectives,
   honoring ring pipelining overlap) to a wall-time prediction.
3. **synthesize** -- ``synthesize_dist_grid`` / ``synthesize_cnn_grid`` /
   ``synthesize_serve_grid`` (:mod:`repro_torch.core.sharding_synthesis`)
   take ``minimize="time"`` to rank candidate grids (and, for
   ``schedule="auto"``, schedules) by predicted wall time instead of
   analytic wire volume.

``perf/bench.py`` writes records from the card with the reference's
keys.  Importing this package imports numpy, not torch.
"""

from repro_torch.perf.calibrate import (CALIB_TOL, CalibEntry, CalibTable,
                                        annotate_predictions,
                                        fit_collectives, fit_compute_rate,
                                        load_calib, noise_aware_rel_err,
                                        prediction_error_report)
from repro_torch.perf.predict import (EVENT_KEYS, CommEvent, StepDag,
                                      cnn_train_dag, conv_step_dag,
                                      lm_decode_dag, matmul_step_dag,
                                      predict_cnn_train_ms,
                                      predict_conv_step_ms,
                                      predict_decode_step_ms,
                                      predict_matmul_step_ms,
                                      predict_step_ms, rank_conv_schedules,
                                      record_dag, replay_ms)

__all__ = [
    "CALIB_TOL", "CalibEntry", "CalibTable", "CommEvent", "EVENT_KEYS",
    "StepDag", "annotate_predictions", "cnn_train_dag", "conv_step_dag",
    "fit_collectives", "fit_compute_rate", "lm_decode_dag", "load_calib",
    "matmul_step_dag", "noise_aware_rel_err", "prediction_error_report",
    "predict_cnn_train_ms", "predict_conv_step_ms",
    "predict_decode_step_ms", "predict_matmul_step_ms", "predict_step_ms",
    "rank_conv_schedules", "record_dag", "replay_ms",
]
