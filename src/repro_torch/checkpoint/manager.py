"""Fault-tolerant checkpointing in the reference's on-disk format.

A checkpoint is ``step_XXXXXXXX/`` holding ``arrays.npz`` and
``manifest.json`` (the step, every leaf's path key, CRC32 and dtype), as
``repro.checkpoint.manager`` writes it, so either package restores the
other's files:

- **atomic commit**: written to ``step_XXXXXXXX.tmp/`` then ``os.rename``d,
  so a crash mid-write never corrupts the latest checkpoint;
- **self-describing**: leaves are keyed by their path in the tree
  (:func:`~repro_torch.streaming.carry.tree_flatten_with_paths`: dict keys
  sorted, sequence indices, ``.field`` for a NamedTuple field), so restore
  works without the tree it came from;
- **keep-N GC** with an optional keep-every-K cadence;
- **async writer**: the state is copied to host memory on the caller's
  thread and serialized on a worker thread;
- **integrity check**: a CRC32 per array, verified on restore.

Leaves may be torch tensors (on any device; a ``DTensor`` is saved whole),
numpy arrays or Python scalars.  bfloat16 tensors are stored as their ``uint16`` bits with the
dtype ``bfloat16`` in the manifest and come back as ``torch.bfloat16``
(the reference's ``ml_dtypes`` is not needed).  Restore returns numpy
leaves, or with ``like`` each leaf in the dtype and on the device of the
matching leaf of ``like`` (:func:`as_like`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..streaming.carry import tree_flatten, tree_flatten_with_paths, tree_unflatten

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint", "as_like",
           "to_host"]


def _flatten_with_paths(tree) -> list[tuple[str, Any]]:
    return tree_flatten_with_paths(tree)


def to_host(tree):
    """A copy of ``tree`` with every tensor leaf on the host (numpy, or a
    CPU ``torch.bfloat16`` tensor), taken now: the snapshot an async save
    writes while the caller moves on."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [_host_leaf(x) for x in leaves])


def _whole(x):
    """A ``DTensor``'s whole value (a collective over its mesh, so every
    rank of the mesh saves), any other leaf as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _host_leaf(x):
    if isinstance(x, torch.Tensor):
        x = _whole(x).detach().cpu()
        return x.clone() if x.dtype == torch.bfloat16 else x.numpy().copy()
    return x


def _array(leaf) -> tuple[np.ndarray, str]:
    """The array written for a leaf and the dtype the manifest names."""
    if isinstance(leaf, torch.Tensor):
        leaf = _whole(leaf).detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _steps(directory: Path) -> list[int]:
    if not directory.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                  if not p.name.endswith(".tmp"))


def save_checkpoint(directory: str | Path, step: int, state) -> Path:
    """Atomic single-checkpoint write.  Returns the committed path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = {}
    manifest = {"step": step, "keys": [], "crc": {}, "dtypes": {}}
    for key, leaf in _flatten_with_paths(state):
        arr, dtype = _array(leaf)
        manifest["dtypes"][key] = dtype
        arrays[key.replace("/", "__")] = arr
        manifest["keys"].append(key)
        manifest["crc"][key] = zlib.crc32(np.ascontiguousarray(arr).tobytes())
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def as_like(arr, like):
    """A restored leaf in the form of ``like``: a tensor of ``like``'s dtype
    on its device (integers of one width are reinterpreted bit for bit, as
    a uint32 CMS table is the port's int32 one), a numpy array of its
    dtype, or a Python scalar of its type."""
    if isinstance(like, torch.Tensor):
        if isinstance(arr, torch.Tensor):
            return arr.to(like.device, like.dtype)
        a = np.asarray(arr)
        want = torch.empty((), dtype=like.dtype).numpy().dtype
        if a.dtype.kind in "iu" and want.kind in "iu" and a.dtype.itemsize == want.itemsize:
            a = a.view(want)
        else:
            a = a.astype(want)
        return torch.from_numpy(np.asarray(a, order="C")).to(like.device)
    if isinstance(like, (bool, np.bool_)) and not isinstance(like, np.ndarray):
        return type(like)(np.asarray(arr).item())
    if isinstance(like, (int, float)):
        return type(like)(np.asarray(arr).item())
    if isinstance(like, (np.ndarray, np.generic)):
        return np.asarray(arr).astype(like.dtype)
    return arr


def restore_checkpoint(directory: str | Path, step: int | None = None,
                       like=None, verify: bool = True):
    """Restore the given (or latest) step: ``(tree, step)``.

    ``like`` supplies the tree: leaves are filled by path (:func:`as_like`).
    Without it a flat ``{path: array}`` dict is returned.
    """
    directory = Path(directory)
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = step if step is not None else steps[-1]
    path = directory / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as z:
        flat = {k: z[k.replace("/", "__")] for k in manifest["keys"]}
    if verify:
        for k, arr in flat.items():
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != manifest["crc"][k]:
                raise IOError(f"checkpoint corruption at {k} (crc mismatch)")
    for k, dt in manifest.get("dtypes", {}).items():
        if dt == "bfloat16" and flat[k].dtype == np.uint16:
            flat[k] = torch.from_numpy(flat[k].view(np.int16).copy()).view(torch.bfloat16)
    if like is None:
        return flat, step
    paths_leaves = _flatten_with_paths(like)
    _, spec = tree_flatten(like)
    return tree_unflatten(spec, [as_like(flat[k], x) for k, x in paths_leaves]), step


class CheckpointManager:
    """keep-N manager with an async writer thread."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 keep_every: int | None = None, async_write: bool = True):
        self.directory = Path(directory)
        self.keep = keep
        self.keep_every = keep_every
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state) -> None:
        host_state = to_host(state)  # snapshot before returning
        self.wait()

        def work():
            try:
                save_checkpoint(self.directory, step, host_state)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, like=None, step: int | None = None):
        self.wait()
        return restore_checkpoint(self.directory, step=step, like=like)

    def steps(self) -> list[int]:
        return _steps(self.directory)

    def _gc(self) -> None:
        steps = self.steps()
        protect = set(steps[-self.keep:]) if self.keep else set(steps)
        if self.keep_every:
            protect |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in protect:
                shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)
