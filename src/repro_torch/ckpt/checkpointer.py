"""Chunked, crc32-verified checkpoints of tensor pytrees -- the port of
``repro/ckpt/checkpointer.py``.

Format: one directory per step with

  - ``meta.json``: the step, and per leaf its path name, shape, dtype
    name, chunking and one crc32 per chunk;
  - ``<leaf-id>.c<j>.npy``: raw chunks, split along the leaf's axis 0, so
    a restart on another grid or rank count re-assembles the full leaf
    (elastic restart);
  - ``_COMMITTED``, written last; the step is written into
    ``<dir>.tmp`` and renamed into place, so a crash mid-save never
    damages the newest committed checkpoint.

The manifest is JSON and the chunks raw numpy arrays: the port needs only
torch, numpy and the standard library.  ``bfloat16`` (and the float8
types) are stored as their integer bits, with the dtype name in the
manifest.  The files are not byte-compatible with the reference's
(``meta.msgpack``), by design.

Leaves are torch tensors (or Python scalars, such as the optimizer's step
count), walked with ``torch.utils._pytree``; a ``None`` leaf is not
stored and restores as ``None``.  :func:`restore` puts each leaf on the
device and in the dtype of the matching leaf of ``tree_like``.

Integrity: every chunk's crc32 (``zlib``, over the stored bytes) is
checked on restore.  A chunk that fails, or is missing, raises
:class:`CorruptCheckpointError`, and
``CheckpointManager.restore_latest`` falls back to the previous committed
step instead of returning garbage.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

_SENTINEL = "_COMMITTED"
_META = "meta.json"

#: Fault-injection and test hook: when set, called as
#: ``_chunk_hook(leaf_id, chunk_idx)`` after each chunk write inside
#: :func:`save`; raising from it simulates a crash mid-save (the ``.tmp``
#: directory is left uncommitted, the previous checkpoint stays intact).
#: See ``fault/inject.py``.
_chunk_hook: Optional[Callable[[int, int], None]] = None


class CheckpointError(RuntimeError):
    """A checkpoint could not be restored (structural mismatch)."""


class CorruptCheckpointError(CheckpointError):
    """A committed checkpoint failed integrity verification (crc32
    mismatch or missing chunk file)."""


# numpy has no bfloat16 or float8: their bits are stored as integers
_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.int8,
         torch.float8_e5m2: torch.int8}
_BY_NAME = {str(dt).removeprefix("torch."): dt for dt in _BITS}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The stored array of a leaf, and the dtype name it restores to."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, f"py:{type(leaf).__name__}"
    t = leaf.detach().cpu()
    if t.dtype in _BITS:
        return t.view(_BITS[t.dtype]).numpy(), str(t.dtype).removeprefix(
            "torch.")
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_numpy(arr: np.ndarray, dtype_name: str, like, device):
    if dtype_name.startswith("py:"):
        kind = {"int": int, "float": float, "bool": bool}[dtype_name[3:]]
        return kind(arr.item())
    t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
    if dtype_name in _BY_NAME:
        t = t.view(_BY_NAME[dtype_name])
    return t.to(device=like.device if device is None else device,
                dtype=like.dtype)


def _leaf_paths(tree) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` per leaf; the name joins the path's dict keys,
    sequence indices and attribute names with ``/``."""
    out = []
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        out.append(("/".join(str(getattr(p, "key", getattr(
            p, "idx", getattr(p, "name", p)))) for p in path), leaf))
    return out


def save(tree, directory: str, *, step: int, chunk_bytes: int = 1 << 28
         ) -> None:
    """Write ``tree`` (``None`` leaves skipped) as the committed
    checkpoint of ``step`` in ``directory``."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(
            (n, l) for n, l in _leaf_paths(tree) if l is not None):
        arr, dtype_name = _to_numpy(leaf)
        if arr.ndim == 0:
            rows_per_chunk, n_chunks = 0, 1
            chunks = [arr]
        else:
            per_row = max(1, arr.nbytes // max(arr.shape[0], 1))
            rows_per_chunk = max(1, chunk_bytes // per_row)
            n_chunks = max(1, -(-arr.shape[0] // rows_per_chunk))
            chunks = (arr[j * rows_per_chunk:(j + 1) * rows_per_chunk]
                      for j in range(n_chunks))
        crcs = []
        for j, chunk in enumerate(chunks):
            chunk = np.ascontiguousarray(chunk)
            crcs.append(zlib.crc32(chunk.tobytes()))
            np.save(os.path.join(tmp, f"{i}.c{j}.npy"), chunk)
            if _chunk_hook is not None:
                _chunk_hook(i, j)
        meta["leaves"].append({
            "name": name, "shape": list(arr.shape), "dtype": dtype_name,
            "id": i, "n_chunks": n_chunks, "rows_per_chunk": rows_per_chunk,
            "crc32": crcs})
    with open(os.path.join(tmp, _META), "w", encoding="utf-8") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, _SENTINEL), "w", encoding="utf-8") as f:
        f.write("ok")
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def _load_chunk(directory: str, info: dict, j: int,
                leaf_name: str) -> np.ndarray:
    """Chunk ``j`` of a leaf, its crc32 verified."""
    path = os.path.join(directory, f"{info['id']}.c{j}.npy")
    if not os.path.exists(path):
        raise CorruptCheckpointError(
            f"checkpoint {directory}: chunk {info['id']}.c{j}.npy of "
            f"leaf '{leaf_name}' is missing")
    try:
        chunk = np.load(path)
    except ValueError as e:  # a header the corruption reached
        raise CorruptCheckpointError(
            f"checkpoint {directory}: chunk {info['id']}.c{j}.npy of "
            f"leaf '{leaf_name}' is unreadable ({e})") from e
    got = zlib.crc32(np.ascontiguousarray(chunk).tobytes())
    if got != info["crc32"][j]:
        raise CorruptCheckpointError(
            f"checkpoint {directory}: crc32 mismatch in chunk "
            f"{info['id']}.c{j}.npy of leaf '{leaf_name}' "
            f"(stored {info['crc32'][j]:#010x}, got {got:#010x})")
    return chunk


def restore(tree_like, directory: str, *, device=None):
    """Rebuild ``tree_like``'s structure from the checkpoint in
    ``directory``; returns ``(tree, step)``.  Each tensor leaf takes the
    dtype of its ``tree_like`` leaf and its device (or ``device``, when
    given) -- the elastic path: a full leaf, whatever grid saved it.

    Raises :class:`CheckpointError` naming the leaf when the checkpoint
    lacks a leaf of ``tree_like``, and :class:`CorruptCheckpointError`
    when a chunk is missing or fails its crc32 (callers fall back to an
    older committed step, see ``CheckpointManager.restore_latest``)."""
    with open(os.path.join(directory, _META), encoding="utf-8") as f:
        meta = json.load(f)
    by_name = {l["name"]: l for l in meta["leaves"]}
    named, spec = _leaf_paths(tree_like), pytree.tree_structure(tree_like)
    leaves = []
    for name, like in named:
        if like is None:
            leaves.append(None)
            continue
        info = by_name.get(name)
        if info is None:
            have = ", ".join(sorted(by_name)[:8])
            raise CheckpointError(
                f"checkpoint {directory} has no leaf '{name}' "
                f"(has: {have}{', ...' if len(by_name) > 8 else ''}) -- "
                f"tree structure changed since the save?")
        chunks = [_load_chunk(directory, info, j, name)
                  for j in range(info["n_chunks"])]
        arr = np.concatenate(chunks, axis=0) if info["shape"] else chunks[0]
        leaves.append(_from_numpy(arr.reshape(info["shape"]), info["dtype"],
                                  like, device))
    return pytree.tree_unflatten(leaves, spec), meta["step"]


def _host_copy(tree):
    """A host snapshot of every tensor leaf (other leaves as they are)."""
    return pytree.tree_map(
        lambda x: x.detach().to("cpu", copy=True)
        if isinstance(x, torch.Tensor) else x, tree)


class CheckpointManager:
    """Steps ``step_<n>`` under ``root``: keeps the newest ``keep``,
    saves synchronously or on a thread, and restores the newest step
    that passes verification."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def all_steps(self) -> List[int]:
        """Committed steps, ascending.  Junk ``step_*`` directories (a
        suffix that is not an integer, ``.tmp`` leftovers) and steps
        without ``_COMMITTED`` are skipped."""
        out = []
        for d in os.listdir(self.root):
            suffix = d[len("step_"):] if d.startswith("step_") else ""
            if (suffix.isdigit() and os.path.exists(
                    os.path.join(self.root, d, _SENTINEL))):
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, tree, step: int, *, async_: bool = False) -> None:
        """Commit ``tree`` as ``step``.  With ``async_`` the caller takes
        a host copy of every tensor (so the thread never reads the card)
        and a thread writes it; a later save or :meth:`wait` joins it."""
        if async_:
            host_tree = _host_copy(tree)
            self.wait()
            self._async_thread = threading.Thread(
                target=self._save_and_gc, args=(host_tree, step),
                daemon=True)
            self._async_thread.start()
        else:
            self._save_and_gc(tree, step)

    def _save_and_gc(self, tree, step: int) -> None:
        save(tree, self._dir(step), step=step)
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def restore_latest(self, tree_like, *, device=None,
                       on_corrupt: Optional[Callable[[int, Exception],
                                                     None]] = None):
        """``(tree, step)`` of the newest committed step that passes
        verification, or ``(None, None)``.  A step whose chunks fail their
        crc32 (or went missing) is reported through ``on_corrupt(step,
        exc)`` and skipped; the corrupt directory stays on disk for
        forensics until retention ages it out."""
        for step in reversed(self.all_steps()):
            try:
                return restore(tree_like, self._dir(step), device=device)
            except CorruptCheckpointError as e:
                if on_corrupt is not None:
                    on_corrupt(step, e)
        return None, None

    def wait(self) -> None:
        """Join the async save in flight."""
        if self._async_thread is not None and self._async_thread.is_alive():
            self._async_thread.join()
