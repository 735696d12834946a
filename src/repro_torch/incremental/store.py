"""CarryStore — durable, validated persistence for partitioner carries.

A carry checkpoint is the atomic npz + CRC commit of ``checkpoint.manager``
with one addition, a **metadata leaf**: the store saves every carry as
``{"meta": <json as uint8>, "carry": <tree>}``, so the consumer name, a
config fingerprint and the stream position travel inside the same atomic
commit as the arrays, under the CRC too.  The files are the reference's
(``repro.incremental.store``): the same format, representation generation,
path keys and dtypes, so each package's store reads the other's.  Two
leaves of the port's carries are held in another form than the
reference's and are written in the reference's: the CMS table (the port's
int32 bit patterns) and row seeds (the port's int64 holding uint32) as
``uint32``, and a Python int (the grid's column count) as ``int32``.
Restoring with ``like`` gives each leaf back in the form of ``like``'s.

Validation on load is strict: a carry written under another consumer,
config fingerprint, an incompatible stream position, or another carry
representation generation (``CARRY_REPR``) raises
:class:`CarryMismatchError`; a corrupted file raises ``IOError`` from the
CRC verify underneath.  Steps are keyed by stream position, and keep-N GC
bounds the directory.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..checkpoint.manager import _flatten_with_paths, as_like, restore_checkpoint, save_checkpoint
from ..core.cms import CMSketch
from ..streaming.carry import CARRY_REPR, tree_flatten, tree_unflatten

__all__ = ["CarryStore", "CarryMismatchError", "config_fingerprint", "flat_lookup"]

_META_KEY = "meta"
_CARRY_KEY = "carry"
_FORMAT = 1


class CarryMismatchError(ValueError):
    """A persisted carry exists but must not seed this warm start."""


def config_fingerprint(config: Mapping[str, Any]) -> str:
    """Order-insensitive 16-hex fingerprint of a config mapping (values
    JSON-serializable; numpy scalars hash as their Python values)."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"),
                      default=_json_default)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    return str(o)


def _meta_to_leaf(meta: dict) -> np.ndarray:
    return np.frombuffer(
        json.dumps(meta, sort_keys=True, default=_json_default).encode(),
        np.uint8).copy()


def _leaf_to_meta(arr: np.ndarray) -> dict:
    return json.loads(np.asarray(arr, np.uint8).tobytes().decode())


def _u32(x) -> np.ndarray:
    """A uint32 value array from the port's int32 bit patterns or int64
    values holding uint32."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a.astype(np.uint32)


def reference_form(tree):
    """``tree`` with the leaves the reference holds in another dtype in the
    reference's: a :class:`CMSketch`'s table and seeds as ``uint32``, a
    Python int as ``int32``."""
    if isinstance(tree, CMSketch):
        return CMSketch(table=_u32(tree.table), seeds=_u32(tree.seeds))
    if isinstance(tree, dict):
        return {k: reference_form(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[reference_form(v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(reference_form(v) for v in tree)
    if isinstance(tree, int) and not isinstance(tree, bool):
        return np.int32(tree)
    return tree


class CarryStore:
    """keep-N store of validated carry checkpoints under one directory."""

    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.keep = int(keep)

    # ------------------------------------------------------------- write
    def save(self, carry, *, consumer: str, config: Mapping[str, Any],
             stream_pos: int, extra_meta: Mapping[str, Any] | None = None,
             step: int | None = None) -> Path:
        """Persist ``carry`` atomically; returns the committed path.
        ``stream_pos`` (edges ingested when the carry was taken) is the
        default step key."""
        meta = {
            "format": _FORMAT,
            "carry_repr": CARRY_REPR,
            "consumer": str(consumer),
            "config_hash": config_fingerprint(config),
            "config": dict(config),
            "stream_pos": int(stream_pos),
        }
        if extra_meta:
            meta.update(extra_meta)
        state = {_META_KEY: _meta_to_leaf(meta), _CARRY_KEY: reference_form(carry)}
        path = save_checkpoint(self.directory, int(
            step if step is not None else stream_pos), state)
        self._gc()
        return path

    # -------------------------------------------------------------- read
    def load(self, like=None, *, consumer: str | None = None,
             config: Mapping[str, Any] | None = None,
             max_stream_pos: int | None = None,
             step: int | None = None, verify: bool = True):
        """Restore ``(carry, meta)`` from the given (default: latest) step.

        ``consumer``/``config`` must match the stored metadata,
        ``max_stream_pos`` bound its stream position (else
        :class:`CarryMismatchError`).  With ``like`` the carry is rebuilt
        in that tree's structure (leaves matched by path, each in the form
        of ``like``'s leaf); without it a flat ``{path: array}`` dict.
        """
        if step is None and max_stream_pos is not None:
            # steps are keyed by stream position: take the furthest one
            # that fits; else the latest, whose metadata check reports it
            fitting = [s for s in self.steps() if s <= max_stream_pos]
            if fitting:
                step = fitting[-1]
        flat, _ = restore_checkpoint(self.directory, step=step, like=None,
                                     verify=verify)
        if _META_KEY not in flat:
            raise CarryMismatchError(
                f"checkpoint under {self.directory} is not a carry "
                "checkpoint (no metadata leaf)")
        meta = _leaf_to_meta(flat.pop(_META_KEY))
        if meta.get("format") != _FORMAT:
            raise CarryMismatchError(
                f"unsupported carry format {meta.get('format')!r}")
        if meta.get("carry_repr") != CARRY_REPR:
            # a monotone (OR/MAX bitmap) carry would mis-account every
            # later retraction in the counted algebra
            raise CarryMismatchError(
                f"carry was written under representation "
                f"{meta.get('carry_repr')!r} but this build speaks the "
                f"counted (group-structured) representation {CARRY_REPR}; "
                "re-run the cold start to produce a compatible carry")
        if consumer is not None and meta["consumer"] != consumer:
            raise CarryMismatchError(
                f"carry was written by consumer {meta['consumer']!r}, "
                f"refusing to seed {consumer!r}")
        if config is not None:
            want = config_fingerprint(config)
            if meta["config_hash"] != want:
                raise CarryMismatchError(
                    f"carry config fingerprint {meta['config_hash']} != "
                    f"{want} for the requested config "
                    f"(stored: {meta.get('config')})")
        if max_stream_pos is not None and meta["stream_pos"] > max_stream_pos:
            raise CarryMismatchError(
                f"carry was taken at stream position {meta['stream_pos']} "
                f"but the current stream holds only {max_stream_pos} edges "
                "(stale or foreign stream)")
        prefix = _CARRY_KEY + "/"
        carry_flat = {k[len(prefix):] if k.startswith(prefix) else k: v
                      for k, v in flat.items()}
        if like is None:
            return carry_flat, meta
        paths_leaves = _flatten_with_paths({_CARRY_KEY: like})
        try:
            leaves = [as_like(flat_lookup(carry_flat, k, prefix), x)
                      for k, x in paths_leaves]
        except KeyError as e:
            raise CarryMismatchError(
                f"carry structure mismatch: stored checkpoint has no leaf "
                f"{e.args[0]!r} for the requested treedef") from None
        if len(carry_flat) != len(paths_leaves):
            raise CarryMismatchError(
                f"carry structure mismatch: stored checkpoint has "
                f"{len(carry_flat)} leaves, requested treedef expects "
                f"{len(paths_leaves)}")
        _, spec = tree_flatten(like)
        return tree_unflatten(spec, leaves), meta

    # ------------------------------------------------------------- admin
    def steps(self) -> list[int]:
        if not self.directory.exists():
            return []
        return sorted(
            int(p.name.split("_")[1]) for p in self.directory.glob("step_*")
            if not p.name.endswith(".tmp"))

    def _gc(self) -> None:
        steps = self.steps()
        if self.keep and len(steps) > self.keep:
            for s in steps[:-self.keep]:
                shutil.rmtree(self.directory / f"step_{s:08d}",
                              ignore_errors=True)


def flat_lookup(carry_flat: dict, full_key: str, prefix: str):
    """Leaf for a ``carry/...`` manifest path from the stripped flat dict."""
    key = full_key[len(prefix):] if full_key.startswith(prefix) else full_key
    if key not in carry_flat:
        raise KeyError(full_key)
    return carry_flat[key]
