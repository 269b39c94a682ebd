"""LM serving on the distributed matmul grid -- the port of
``repro/launch/serve.py``: continuous batching over static slots, with
every projection routed through ``dist.matmul.matmul_distributed`` when a
serving grid is given.

Engine structure (the production shape):

  - a request **queue** with admission control: a request enters a slot
    only when one is free and ``prompt + max_new`` fits the KV budget; a
    bounded queue (``max_queue``) rejects with a status instead of
    growing, and a request past its ``deadline_s`` retires;
  - **prefill/decode split**: an admitted prompt is right-padded to a
    prefill bucket, prefilled as a batch of one into a one-slot stage
    cache, and its KV rows scattered into the shared per-slot cache;
  - batched single-token **decode** over all slots against the per-slot
    cache (``cache["len"]`` is a [slots] vector -- every slot advances
    independently);
  - **slot recycling**: a slot frees on EOS / ``max_new`` and the next
    queued request is admitted into it -- no drain barrier.

The reference jits prefill and decode with donated buffers and pinned
boundary shardings; here both are eager calls under
``torch.inference_mode()`` that write the KV cache in place, run per
rank: with a ``(Pm, Pn, Pc)`` mesh (``dist_mesh``) every rank runs the
same engine on the same requests and emits the same tokens.
``core.sharding_synthesis.synthesize_serve_grid`` picks the grid.

The CLI serves at the config's own dtype (bfloat16 for the LM configs;
the GEMM takes it on the card) and in float32 under ``--smoke``, as the
reference's does (:func:`serve_config`).  Degradation knobs, as the
reference's: a bounded queue (``max_queue``), per-request deadlines, and
a decode watchdog (``decode_watchdog_timeout_s``) that snapshots the
engine's bookkeeping to ``state_dump_path`` when a decode step wedges,
reporting to ``fault_log``; an ``injector`` fires at the ``"decode"``
point of every iteration (``fault/inject.py``).

The ``ssm``, ``hybrid`` and ``encdec`` families (xlstm-350m, zamba2-7b,
whisper-tiny) serve through the static :class:`Engine`: one prefill of
a ``[B,S]`` prompt batch, then batched greedy decode, as the
reference's.

CLI::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b

On a card the first serves on one rank (``--grid PmxPnxPc`` or ``auto``
with ``Pm*Pn*Pc`` cards); ``--smoke`` serves the smoke config on the
``(2,2,2)`` grid over 8 ranks (gloo on the CPU) and dense, and exits 1
if the greedy tokens diverge.  A zoo ``--arch`` serves ``--requests``
prompts of ``--prompt-len`` tokens through :class:`Engine` at the
config's dtype (``--smoke``: the smoke config), with weights drawn from
a seeded generator on the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config

_TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
SMOKE_GRID = (2, 2, 2)


@dataclass
class Request:
    """One generation request.

    ``status`` is the structured per-request outcome: ``"ok"`` (served
    to EOS/``max_new``), ``"rejected_oversize"`` /
    ``"rejected_backpressure"`` (admission refused it -- ``error`` says
    why), or ``"deadline"`` (``deadline_s`` elapsed since submit; any
    tokens produced so far stay in ``out``).  A bad request never raises
    out of the engine loop -- it retires with its status and serving
    continues.
    """

    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = field(default_factory=list)
    prefill_ms: float = 0.0
    step_ms: List[float] = field(default_factory=list)
    deadline_s: Optional[float] = None
    status: str = "ok"
    error: str = ""
    t_submit: float = 0.0


class ContinuousEngine:
    """Continuous-batching decode engine on ``slots`` static KV rows, on
    the device of ``params``.

    ``dist_mesh`` routes every projection through the ``(Pm, Pn, Pc)``
    grid (``models/lm.py``'s ``dist_mesh=`` path); ``None`` serves dense
    -- the two run the identical queue/prefill/decode schedule, which is
    what makes the token comparison meaningful.
    """

    @torch.inference_mode()
    def __init__(self, cfg, params, *, slots: int, max_seq: int,
                 dist_mesh=None, dist_schedule: str = "allgather",
                 prefill_bucket: int = 16, eos_id: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 decode_watchdog_timeout_s: Optional[float] = None,
                 state_dump_path: Optional[str] = None,
                 fault_log=None, injector=None):
        from repro_torch.models import lm as lm_mod
        if cfg.family not in _TRANSFORMER_FAMILIES:
            raise ValueError(
                f"continuous batching covers {_TRANSFORMER_FAMILIES}; "
                f"family {cfg.family!r} serves via the static Engine")
        self._lm = lm_mod
        self.cfg, self.params = cfg, params
        self.device = params["emb"]["tok"].device
        self.slots, self.max_seq = slots, max_seq
        self.bucket = prefill_bucket
        self.eos_id = eos_id
        self.dist_mesh, self.dist_schedule = dist_mesh, dist_schedule
        # degradation knobs: a bounded queue applies backpressure
        # (reject with a status, never unbounded growth); the decode
        # watchdog snapshots the engine's bookkeeping when a decode wedges
        self.max_queue = max_queue
        self.decode_watchdog_timeout_s = decode_watchdog_timeout_s
        self.state_dump_path = state_dump_path
        self.fault_log = fault_log
        self.injector = injector
        self.queue: deque = deque()
        self.active: List[Optional[Request]] = [None] * slots
        self.retired: List[Request] = []
        self.decode_ms: List[float] = []
        self.cache = lm_mod.init_cache(cfg, slots, max_seq, per_slot=True,
                                       device=self.device)
        # each slot's next input token, on the host and on the device;
        # an idle slot keeps the last token it was given, as the
        # reference's (an idle row still competes for MoE capacity)
        self._next = [0] * slots
        self.next_tok = torch.zeros((slots, 1), dtype=torch.int32,
                                    device=self.device)

    def _decode_fn(self, cache, tokens):
        return self._lm.decode_step(self.params, self.cfg, cache, tokens,
                                    dist_mesh=self.dist_mesh,
                                    dist_schedule=self.dist_schedule)

    def _prefill_fn(self, tokens, last_pos):
        stage = self._lm.init_cache(self.cfg, 1, self.max_seq,
                                    device=self.device)
        return self._lm.prefill(self.params, self.cfg, stage, tokens,
                                last_pos=last_pos, dist_mesh=self.dist_mesh,
                                dist_schedule=self.dist_schedule)

    # ------------------------------------------------------------- queue --

    def submit(self, req: Request) -> bool:
        """Admission control: a request that can never fit the KV
        budget, or arrives while the bounded queue is full, retires
        immediately with a structured reject status.  Returns True when
        the request was queued."""
        req.t_submit = time.monotonic()
        if len(req.prompt) + req.max_new > self.max_seq:
            self._reject(
                req, "rejected_oversize",
                f"prompt {len(req.prompt)} + max_new {req.max_new} "
                f"exceeds max_seq {self.max_seq}")
            return False
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._reject(req, "rejected_backpressure",
                         f"queue full ({self.max_queue} waiting)")
            return False
        self.queue.append(req)
        return True

    def _reject(self, req: Request, status: str, error: str) -> None:
        req.status, req.error = status, error
        self.retired.append(req)

    def _expired(self, req: Request, now: Optional[float] = None) -> bool:
        if req.deadline_s is None:
            return False
        now = time.monotonic() if now is None else now
        return now - req.t_submit > req.deadline_s

    def _next_queued(self) -> Optional[Request]:
        """Pop the next admissible request, retiring queued requests
        whose deadline already passed (they would only waste a
        prefill)."""
        while self.queue:
            req = self.queue.popleft()
            if self._expired(req):
                self._reject(req, "deadline",
                             f"deadline {req.deadline_s}s elapsed "
                             f"before admission")
                continue
            return req
        return None

    def _padded_len(self, plen: int) -> int:
        b = self.bucket
        return min(((plen + b - 1) // b) * b, self.max_seq)

    @torch.inference_mode()
    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            req = self._next_queued()
            if req is None:
                break
            plen = len(req.prompt)
            padded = self._padded_len(plen)
            toks = torch.tensor([req.prompt + [0] * (padded - plen)],
                                dtype=torch.int32, device=self.device)
            t0 = time.perf_counter()
            logits, stage = self._prefill_fn(toks, plen - 1)
            first = int(logits[0, 0].argmax())
            req.prefill_ms = (time.perf_counter() - t0) * 1e3
            self.cache["k"][:, slot] = stage["k"][:, 0]
            self.cache["v"][:, slot] = stage["v"][:, 0]
            self.cache["len"][slot] = plen
            self._next[slot] = first
            self.active[slot] = req
            req.out.append(first)
            self._maybe_retire(slot, first)
        self._sync_next()

    def _sync_next(self) -> None:
        self.next_tok = torch.tensor(self._next, dtype=torch.int32,
                                     device=self.device).view(-1, 1)

    def _maybe_retire(self, slot: int, tok: int) -> None:
        req = self.active[slot]
        if tok == self.eos_id or len(req.out) >= req.max_new:
            self.retired.append(req)
            self.active[slot] = None

    def _retire_slot(self, slot: int, status: str, error: str) -> None:
        """Retire an active slot early (deadline) -- the slot frees for
        the next queued request; tokens produced so far are kept."""
        req = self.active[slot]
        req.status, req.error = status, error
        self.retired.append(req)
        self.active[slot] = None

    # ------------------------------------------------------------ decode --

    @torch.inference_mode()
    def _decode_once(self) -> None:
        t0 = time.perf_counter()
        logits, self.cache = self._decode_fn(self.cache, self.next_tok)
        nxt = logits[:, 0].argmax(-1).tolist()            # host sync
        dt = (time.perf_counter() - t0) * 1e3
        self.decode_ms.append(dt)
        now = time.monotonic()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(nxt[slot])
            req.step_ms.append(dt)
            self._next[slot] = nxt[slot]
            self._maybe_retire(slot, nxt[slot])
            if self.active[slot] is not None and self._expired(req, now):
                # per-request deadline: retire the timed-out slot so it
                # recycles instead of decoding for a caller that's gone
                self._retire_slot(
                    slot, "deadline",
                    f"deadline {req.deadline_s}s exceeded after "
                    f"{len(req.out)} tokens")
        self._sync_next()
        # idle slots decode garbage rows; pin their length so the cache
        # write can never run off the cache end while a slot sits empty
        mask = torch.tensor([r is not None for r in self.active],
                            device=self.device)
        self.cache["len"] = torch.where(mask, self.cache["len"], 0)

    @torch.inference_mode()
    def warmup(self, prompt_lens: List[int]) -> None:
        """Run prefill (per bucket) and one decode ahead of serving, so
        measured latencies are steady-state (first-call allocations,
        library handles)."""
        for pl in sorted({self._padded_len(p) for p in prompt_lens}):
            self._prefill_fn(torch.zeros((1, pl), dtype=torch.int32,
                                         device=self.device), pl - 1)
        throwaway = self._lm.init_cache(self.cfg, self.slots, self.max_seq,
                                        per_slot=True, device=self.device)
        self._decode_fn(throwaway, self.next_tok)

    # ----------------------------------------------------- wedge handling --

    def engine_state(self) -> Dict:
        """Bookkeeping snapshot -- what the decode watchdog saves when a
        decode wedges, so a restarted engine (or an operator) knows which
        requests were queued, in flight and retired."""
        return {
            "queued": [r.rid for r in self.queue],
            "active": [{"rid": r.rid, "n_out": len(r.out)}
                       for r in self.active if r is not None],
            "retired": [{"rid": r.rid, "status": r.status,
                         "n_out": len(r.out)} for r in self.retired],
            "decode_steps": len(self.decode_ms),
        }

    def _on_decode_wedge(self, iteration: int, elapsed: float) -> None:
        """The watchdog's handler (on its thread): write the bookkeeping
        snapshot to ``state_dump_path``, whole or not at all
        (``os.replace``)."""
        if not self.state_dump_path:
            return
        snap = dict(self.engine_state(), event="decode_wedge",
                    iteration=iteration, elapsed_s=elapsed)
        tmp = self.state_dump_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=1)
        os.replace(tmp, self.state_dump_path)

    # ------------------------------------------------------------- serve --

    def serve(self, requests: List[Request]) -> Dict:
        for r in requests:
            self.submit(r)
        wd = None
        if self.decode_watchdog_timeout_s:
            from repro_torch.fault.watchdog import StepWatchdog
            wd = StepWatchdog(self.decode_watchdog_timeout_s,
                              on_wedge=self._on_decode_wedge,
                              log=self.fault_log)
        t0 = time.perf_counter()
        iteration = 0
        try:
            while self.queue or any(r is not None for r in self.active):
                self._admit()
                if any(r is not None for r in self.active):
                    if wd is not None:
                        wd.arm(iteration)
                    try:
                        if self.injector is not None:
                            self.injector.fire("decode", iteration)
                        self._decode_once()
                    finally:
                        if wd is not None:
                            wd.disarm()
                iteration += 1
        finally:
            if wd is not None:
                wd.close()
        return self._stats(time.perf_counter() - t0)

    def _stats(self, wall_s: float) -> Dict:
        reqs = sorted(self.retired, key=lambda r: r.rid)
        n_tok = sum(len(r.out) for r in reqs)
        dms = sorted(self.decode_ms) or [0.0]

        def pct(q):
            return dms[min(int(q * len(dms)), len(dms) - 1)]

        decode_s = sum(self.decode_ms) / 1e3
        mean_ms = sum(self.decode_ms) / max(len(self.decode_ms), 1)
        std_ms = (sum((t - mean_ms) ** 2 for t in self.decode_ms)
                  / max(len(self.decode_ms), 1)) ** 0.5
        statuses = {r.rid: r.status for r in reqs}
        return {
            "tokens": {r.rid: list(r.out) for r in reqs},
            "n_requests": len(reqs),
            "n_tokens": n_tok,
            "wall_s": wall_s,
            # the reference's rate: over the decode steps' time only,
            # though each request's first token comes from its prefill
            "tokens_per_s": n_tok / max(decode_s, 1e-9),
            # what a client sees: every token over the whole serve window
            "served_tokens_per_s": n_tok / max(wall_s, 1e-9),
            "p50_ms": pct(0.50),
            "p99_ms": pct(0.99),
            "mean_ms": mean_ms,
            "std_ms": std_ms,
            "reps": len(self.decode_ms),
            "prefill_ms": {r.rid: r.prefill_ms for r in reqs},
            "statuses": statuses,
            "errors": {r.rid: r.error for r in reqs if r.error},
            "n_ok": sum(1 for s in statuses.values() if s == "ok"),
            "n_rejected": sum(1 for s in statuses.values()
                              if s.startswith("rejected")),
            "n_deadline": sum(1 for s in statuses.values()
                              if s == "deadline"),
        }


class Engine:
    """Static-slot batched engine (one prefill, then batched greedy
    decode) on the device of ``params``: the serving engine of the
    non-transformer families (encdec/ssm/hybrid), whose serve functions
    take no serving grid; the transformer families serve through
    :class:`ContinuousEngine`.

    The reference jits the decode step with the cache donated; here each
    step is an eager call under ``torch.inference_mode()`` that writes
    the cache in place.  No step reads a value on the host, so the host
    queues the steps ahead of the device.  ``decode_ms`` holds each
    step's time: on a card the CUDA events recorded between the steps,
    which include any wait for the host; on the CPU the host clock.
    """

    def __init__(self, cfg, params, *, slots: int, max_seq: int):
        from repro_torch.models.api import model_fns
        self.cfg = cfg
        self.fns = model_fns(cfg)
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.device = params["emb"]["tok"].device
        self.decode_ms: List[float] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _mark(self):
        """A point between two steps: a recorded CUDA event on a card,
        the host clock elsewhere."""
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _elapsed_ms(self, a, b) -> float:
        if self.device.type != "cuda":
            return (b - a) * 1e3
        return a.elapsed_time(b)

    @torch.inference_mode()
    def run(self, prompts, gen: int):
        """``prompts`` [B,S] int (B <= ``slots``) -> (tokens [B, gen]
        int32 on the device, prefill s, decode s).  For encdec the
        encoder gets zero frames of S positions, as the reference's."""
        prompts = torch.as_tensor(prompts, dtype=torch.int32,
                                  device=self.device)
        b, s = prompts.shape
        if b > self.slots or s + gen - 1 > self.max_seq:
            raise ValueError(f"{b} prompts of {s} tokens + {gen} new need "
                             f"{b} slots and {s + gen - 1} positions; the "
                             f"engine has {self.slots} and {self.max_seq}")
        cache = self.fns.init_cache(self.cfg, b, self.max_seq, enc_len=s,
                                    device=self.device)
        t0 = time.perf_counter()
        if self.cfg.family == "encdec":
            frames = torch.zeros((b, s, self.cfg.d_model),
                                 dtype=torch.float32, device=self.device)
            logits, cache = self.fns.prefill(self.params, self.cfg, cache,
                                             frames, prompts)
        else:
            logits, cache = self.fns.prefill(self.params, self.cfg, cache,
                                             prompts)
        out = [logits[:, -1:].argmax(-1).to(torch.int32)]
        self._sync()
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        marks = [self._mark()]
        for _ in range(gen - 1):
            logits, cache = self.fns.decode_step(self.params, self.cfg,
                                                 cache, out[-1])
            out.append(logits[:, -1:].argmax(-1).to(torch.int32))
            marks.append(self._mark())
        self._sync()
        t_decode = time.perf_counter() - t0
        self.decode_ms = [self._elapsed_ms(a, e)
                          for a, e in zip(marks, marks[1:])]
        return torch.cat(out, dim=1), t_prefill, t_decode


# ------------------------------------------------------------------ run ---

def _make_requests(cfg, *, requests: int, prompt_len: int, gen: int,
                   seed: int,
                   deadline_s: Optional[float] = None) -> List[Request]:
    """Deterministic request set with varied prompt/output lengths so
    bucketed prefill and slot recycling are actually exercised.  The
    lengths follow the reference; the prompts are numpy draws from the
    seed (the reference draws with ``jax.random``, so they differ)."""
    out = []
    for i in range(requests):
        plen = max(1, prompt_len - (i % 4))
        toks = np.random.default_rng(seed * 1000 + i).integers(
            0, cfg.vocab, plen)
        out.append(Request(rid=i, prompt=[int(t) for t in toks],
                           max_new=max(1, gen - (i % 3)),
                           deadline_s=deadline_s))
    return out


def run(cfg, *, requests: int = 8, prompt_len: int = 16, gen: int = 16,
        slots: int = 4, max_seq: Optional[int] = None, grid=None,
        schedule: str = "allgather", minimize: str = "comm",
        mem_cap_elems: Optional[float] = None,
        seed: int = 0, params=None, prefill_bucket: int = 16,
        warmup: bool = False, max_queue: Optional[int] = None,
        deadline_s: Optional[float] = None,
        decode_watchdog_timeout_s: Optional[float] = None,
        state_dump_path: Optional[str] = None,
        request_set: Optional[List[Request]] = None,
        device=None) -> Dict:
    """Serve a deterministic request set (or ``request_set``) on this
    rank; the callable engine API.

    ``grid``: a ``(Pm, Pn, Pc)`` tuple over the initialized process group
    (``dist.spawn.run_spmd``; ``(1,1,1)`` on one rank), ``"auto"``
    (synthesized over the group's ranks by ``synthesize_serve_grid``), or
    ``None`` (dense, no process group needed).  ``params`` default to
    ``init_lm`` from a CPU generator seeded with ``seed`` (the same
    weights on every rank and device), on ``device`` (``cuda`` by
    default).  Returns the stats of :meth:`ContinuousEngine.serve` plus
    the grid/schedule and the analytic wire/memory accounting.
    """
    from repro_torch.device import resolve_device
    from repro_torch.models.api import model_fns

    device = resolve_device(device)
    max_seq = max_seq or prompt_len + gen
    fns = model_fns(cfg)
    if params is None:
        params = fns.init(torch.Generator().manual_seed(seed), cfg,
                          device=device)
    if grid == "auto":
        import torch.distributed as dist

        from repro_torch.core.sharding_synthesis import synthesize_serve_grid
        n_ranks = dist.get_world_size() if dist.is_initialized() else 1
        grid = synthesize_serve_grid(cfg, n_ranks, slots=slots,
                                     max_seq=max_seq, schedule=schedule,
                                     minimize=minimize,
                                     mem_cap_elems=mem_cap_elems).grid
    mesh = None
    if grid is not None:
        from repro_torch.dist.matmul import make_matmul_mesh
        mesh = make_matmul_mesh(tuple(grid), device=device)
    engine = ContinuousEngine(
        cfg, params, slots=slots, max_seq=max_seq, dist_mesh=mesh,
        dist_schedule=schedule, prefill_bucket=prefill_bucket,
        max_queue=max_queue,
        decode_watchdog_timeout_s=decode_watchdog_timeout_s,
        state_dump_path=state_dump_path)
    reqs = request_set if request_set is not None else _make_requests(
        cfg, requests=requests, prompt_len=prompt_len, gen=gen, seed=seed,
        deadline_s=deadline_s)
    if warmup:
        engine.warmup([len(r.prompt) for r in reqs])
    res = engine.serve(reqs)
    res["arch"] = cfg.arch_id
    res["grid"] = tuple(grid) if grid is not None else None
    res["schedule"] = schedule
    if grid is not None:
        from repro_torch.dist.lm import lm_serve_comm_elems, lm_serve_mem_elems
        itemsize = cfg.torch_dtype.itemsize
        comm = lm_serve_comm_elems(cfg, tuple(grid), slots=slots,
                                   schedule=schedule)
        mem = lm_serve_mem_elems(cfg, tuple(grid), slots=slots,
                                 max_seq=max_seq, schedule=schedule)
        res["wire_bytes_per_tok"] = comm["per_slot"] * itemsize
        res["peak_mem_bytes"] = mem["peak"] * itemsize
    return res


def serve_config(arch: str, smoke: bool = False):
    """The CLI's config of ``arch``: its own dtype, but float32 for a
    transformer under ``smoke``, as the reference's CLI (the greedy-token
    comparison of the smoke run needs f32 headroom, not bf16 rounding)."""
    cfg = get_config(arch, smoke=smoke)
    if smoke and cfg.family in _TRANSFORMER_FAMILIES:
        cfg = dataclasses.replace(cfg, dtype="float32")
    return cfg


def _serve_rank(rank: int, cfg, kw: Dict) -> Dict:
    """One rank of a grid run (``dist.spawn.run_spmd``)."""
    return run(cfg, **kw)


def _serve_static(cfg, args, device):
    """The CLI's non-transformer branch, as the reference's: weights from
    seed 0, ``--requests`` prompts of ``--prompt-len`` tokens from seed 1,
    one :class:`Engine` run."""
    from repro_torch.models.api import model_fns

    params = model_fns(cfg).init(torch.Generator(device).manual_seed(0),
                                 cfg, device=device)
    engine = Engine(cfg, params, slots=args.requests,
                    max_seq=args.prompt_len + args.gen)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (args.requests, args.prompt_len))
    toks, t_pre, t_dec = engine.run(prompts, args.gen)
    n_tok = args.requests * args.gen
    print(f"[serve] {cfg.arch_id} ({cfg.dtype}) on {device.type}: prefill "
          f"{t_pre * 1e3:.1f}ms, decode {t_dec * 1e3:.1f}ms for {n_tok} "
          f"tokens ({n_tok / max(t_dec, 1e-9):.0f} tok/s), output "
          f"{tuple(toks.shape)}")
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke config, 8 ranks on the (2,2,2) grid, "
                         "dist-vs-dense token comparison")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--schedule", default="allgather",
                    choices=("allgather", "ring", "ring2"))
    ap.add_argument("--grid", default=None,
                    help='"PmxPnxPc", "auto", or omit for dense')
    ap.add_argument("--minimize", default="comm",
                    choices=("comm", "time"),
                    help="--grid auto objective: analytic wire volume "
                         "or calibrated replay time (CALIB.json)")
    ap.add_argument("--mem-cap-elems", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (gloo ranks)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.dist.spawn import run_spmd

    device = resolve_device(args.device)
    cfg = serve_config(args.arch, smoke=args.smoke)
    if cfg.family not in _TRANSFORMER_FAMILIES:
        return _serve_static(cfg, args, device)

    # smoke pins the 2.5D (2,2,2) grid, as the reference's does
    grid = args.grid or (SMOKE_GRID if args.smoke else None)
    n_dev = (torch.cuda.device_count() if device.type == "cuda"
             else math.prod(SMOKE_GRID) if args.smoke else 1)
    kw = dict(requests=args.requests, prompt_len=args.prompt_len,
              gen=args.gen, slots=args.slots, schedule=args.schedule,
              device=device.type)
    if args.minimize == "time":
        from repro_torch.perf.calibrate import provenance_line
        print(provenance_line(), flush=True)
    if grid == "auto":
        from repro_torch.core.sharding_synthesis import synthesize_serve_grid
        grid = synthesize_serve_grid(
            cfg, n_dev, slots=args.slots,
            max_seq=args.prompt_len + args.gen, schedule=args.schedule,
            minimize=args.minimize, mem_cap_elems=args.mem_cap_elems).grid
    elif isinstance(grid, str):
        grid = tuple(int(x) for x in grid.split("x"))
    if grid is None:
        res = run(cfg, grid=None, **kw)
    else:
        ranks = run_spmd(_serve_rank, math.prod(grid), cfg,
                         dict(kw, grid=grid), device=device.type)
        res = ranks[0]
        if any(r["tokens"] != res["tokens"] for r in ranks):
            print("[serve] the ranks emitted different tokens")
            raise SystemExit(1)
    wire = res.get("wire_bytes_per_tok", 0.0)
    print(f"[serve] {cfg.arch_id} ({cfg.dtype}) on {device.type} "
          f"grid={res['grid']} "
          f"schedule={res['schedule']}: {res['n_tokens']} tokens from "
          f"{res['n_requests']} requests, "
          f"{res['served_tokens_per_s']:.0f} tok/s served "
          f"({res['tokens_per_s']:.0f} over decode time), "
          f"p50 {res['p50_ms']:.1f}ms p99 {res['p99_ms']:.1f}ms, "
          f"wire {wire:.0f} B/tok")
    if args.smoke:
        dense = run(cfg, grid=None, **kw)
        match = dense["tokens"] == res["tokens"]
        print(f"[serve] dist grid {res['grid']} vs dense: greedy tokens "
              f"{'identical' if match else 'DIVERGED'}")
        if not match:
            raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
