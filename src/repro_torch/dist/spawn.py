"""Run one SPMD function on N ranks.

:func:`run_spmd` starts ``world_size`` processes (``spawn`` start method),
joins them into one ``torch.distributed`` process group through a
``FileStore`` in a fresh temporary directory -- no fixed port, no network
-- and returns each rank's result.  The backend is gloo on the CPU and
nccl on cards (rank ``r`` on card ``r``).  A world of one runs in the
calling process, so what it does (the kernels' launch counts included)
stays visible to the caller.

``fn(rank, *args)`` must be importable by name (a module-level function)
and return something picklable; tensors should be moved to the CPU.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

TIMEOUT_S = 600.0  # a whole multi-rank run, start-up included


def _run_rank(rank, world_size, store_path, device_type, fn, args):
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        return fn(rank, *args)
    finally:
        dist.destroy_process_group()


def _worker(rank, world_size, store_path, device_type, fn, args, results):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        out = _run_rank(rank, world_size, store_path, device_type, fn, args)
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def fake_world(n: int) -> None:
    """A process group of ``n`` fake ranks in this process, as rank 0
    (backend ``"fake"``: every collective returns at once and moves
    nothing), unless a fake group of that size is already up (a fake
    group of another size is ended first).  The dry run's meshes stand on
    it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"already up; a fake one cannot join it")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def end_world() -> None:
    """End this process's process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def run_spmd(fn, world_size: int, *args, device=None) -> list:
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each run on its
    own rank of a fresh process group on ``device`` (``cuda`` by
    default).  Raises if any rank fails or the run outlasts
    :data:`TIMEOUT_S`; every started process is ended before it
    returns."""
    device_type = resolve_device(device).type
    if device_type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks need {world_size} cards, "
                         f"have {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        if world_size == 1:
            return [_run_rank(0, 1, store_path, device_type, fn, args)]
        ctx = multiprocessing.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_worker,
                             args=(r, world_size, store_path, device_type,
                                   fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, errors = {}, []
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while len(out) + len(errors) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and not errors:
                        errors.append(f"a rank exited with code "
                                      f"{dead[0].exitcode} without a result")
                    if errors or time.monotonic() > deadline:
                        break
                    continue
                if ok:
                    out[rank] = payload
                else:
                    errors.append(f"rank {rank}:\n{payload}")
        finally:
            for p in procs:
                p.join(timeout=5.0 if not errors else 0.5)
                if p.is_alive():
                    p.terminate()
                    p.join()
        if errors:
            raise RuntimeError("SPMD run failed; " + "\n".join(errors))
        if len(out) < world_size:
            raise TimeoutError(f"SPMD run outlasted {TIMEOUT_S} s")
        return [out[r] for r in range(world_size)]
