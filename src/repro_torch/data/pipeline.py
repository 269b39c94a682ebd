"""Deterministic synthetic data pipeline -- shard-aware, prefetching --
the port of ``repro/data/pipeline.py``, in numpy as the reference's, so
the same seed gives the same batches in both packages.

Produces reproducible token streams keyed by (seed, step, host), so any
host can regenerate any step's data: this is the property the straggler /
elastic-restart machinery relies on (a rescheduled host re-derives its
shard without coordination).  Real deployments swap the synthetic stream
for a tokenized corpus reader with the same (step -> batch) contract.
:func:`to_torch` moves a batch onto a device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    frames: bool = False          # also emit encoder frames (enc-dec)
    d_model: int = 0
    positions3d: bool = False     # also emit M-RoPE positions (vlm)


class SyntheticTokens:
    """Index-addressable dataset: batch_at(step) is pure."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {cfg.n_hosts} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_id)
        # markovian-ish synthetic stream: next ~ (3*prev + noise) % vocab,
        # giving the LM a learnable structure (tests check loss decreases).
        b, s = self.local_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        noise = rng.integers(0, 17, (b, s))
        for t in range(s):
            toks[:, t + 1] = (3 * toks[:, t] + noise[:, t]) % cfg.vocab
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frames:
            out["frames"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)
        if cfg.positions3d:
            pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
            out["positions"] = np.stack([pos] * 3, axis=1)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of host batches (double buffering)."""

    def __init__(self, ds: SyntheticTokens, depth: int = 2,
                 start_step: int = 0):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.ds.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> Dict[str, np.ndarray]:
        step, batch = self.q.get()
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)


def to_torch(batch: Dict[str, np.ndarray], device=None
             ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (int32 tokens, labels and
    positions; float32 frames)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
