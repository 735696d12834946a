"""Out-of-core edge shards: ``write_shards`` and the mmap-paged ``ShardedEdgeStream``.

The port of ``repro.streaming.oocstream``.  The shard format is the
reference's own, so a shard directory written by either package reads in
the other, and both writers produce the same bytes::

    manifest.json            version 1, "format": "s5p-edge-shards"
    shard_00000.src.npy      int32 (n,), readable by np.load(mmap_mode="r")
    shard_00000.dst.npy      int32 (n,)
    shard_00000.<field>.npy  optional per-edge fields (any dtype and shape)
    shard_00001.src.npy      ...

Every shard holds ``shard_edges`` edges except the last; the manifest
records ``{version, format, n_edges, n_vertices, shard_edges, fields,
shards}``, ``fields`` a list of ``{name, dtype, shape}`` and ``shards`` a
list of ``{id, offset, n_edges, files}``.

:class:`ShardedEdgeStream` never holds the edge list.  The shards are
memory-mapped and paged by the OS; the host allocations the stream makes
(each chunk's staging copy, O(shard_edges) reorder buffers, an O(window)
heap) are charged to a :class:`HostBudget` (``stream.budget.peak_bytes``).
Chunks land on ``stream.device`` (default ``cuda``) by a pageable copy, as
the in-memory stream's do.  Orderings:

- ``natural``    — contiguous mmap reads, shard by shard;
- ``windowed``   — one bounded-heap pass of ``_windowed_emit`` over the
  ``dst`` field, spilled as an order ``.npy``; chunks gather through it;
- ``shuffled``   — Fisher–Yates on a scratch memmap (the draws of
  ``default_rng(seed).permutation(E)``, so the same permutation), then the
  edges respilled in stream order;
- ``dst-sorted`` — an external stable merge sort (per-shard stable runs,
  merged with ties to the arrival index), then respilled likewise.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import weakref
from contextlib import contextmanager
from heapq import merge as _heap_merge
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from .stream import DEFAULT_CHUNK, ORDERINGS, EdgeStream, _windowed_emit

__all__ = ["HostBudget", "BudgetExceededError", "ShardedEdgeStream",
           "write_shards", "append_shards", "read_manifest",
           "DEFAULT_SHARD_EDGES", "MANIFEST_NAME"]

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
DEFAULT_SHARD_EDGES = 1 << 20


# ---------------------------------------------------------------------------
# byte-budget accounting
# ---------------------------------------------------------------------------


class BudgetExceededError(MemoryError):
    """A :class:`HostBudget` charge would push residency past its hard cap."""

    def __init__(self, requested: int, current: int, limit: int):
        self.requested = int(requested)
        self.current = int(current)
        self.limit = int(limit)
        super().__init__(
            f"host budget exceeded: charging {requested} bytes at "
            f"{current} resident would pass the {limit}-byte limit")


class HostBudget:
    """Accounting of the host allocations a stream makes.

    mmap-backed views are charged nothing (the OS pages them); every array
    the stream allocates is charged while it lives.  ``limit_bytes`` makes
    it a hard cap: a :meth:`charge` past it raises
    :class:`BudgetExceededError` before any counter moves.  ``None`` (the
    default) only observes.
    """

    def __init__(self, limit_bytes: int | None = None) -> None:
        if limit_bytes is not None and int(limit_bytes) < 0:
            raise ValueError(f"limit_bytes must be >= 0, got {limit_bytes}")
        self.limit_bytes = None if limit_bytes is None else int(limit_bytes)
        self.current_bytes = 0
        self.peak_bytes = 0

    def charge(self, nbytes: int) -> None:
        nbytes = int(nbytes)
        if (self.limit_bytes is not None
                and self.current_bytes + nbytes > self.limit_bytes):
            raise BudgetExceededError(nbytes, self.current_bytes,
                                      self.limit_bytes)
        self.current_bytes += nbytes
        if self.current_bytes > self.peak_bytes:
            self.peak_bytes = self.current_bytes

    def release(self, nbytes: int) -> None:
        self.current_bytes -= int(nbytes)

    @contextmanager
    def scoped(self, nbytes: int):
        self.charge(nbytes)
        try:
            yield
        finally:
            self.release(nbytes)


# ---------------------------------------------------------------------------
# shard writer + manifest
# ---------------------------------------------------------------------------


def _host(a, dtype=None) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a, dtype)


def write_shards(out_dir, src, dst, *extras, shard_edges: int = DEFAULT_SHARD_EDGES,
                 n_vertices: int | None = None, field_names=None) -> Path:
    """Write ``src``/``dst`` (and per-edge ``extras``) as edge shards; returns
    the path of ``manifest.json``.  ``extras`` keep their dtype and trailing
    shape; ``field_names`` names them (default ``x0, x1, ...``).  Arrays or
    tensors."""
    if shard_edges < 1:
        raise ValueError("shard_edges must be >= 1")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    src = _host(src, np.int32)
    dst = _host(dst, np.int32)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError("src/dst must be equal-length 1-D arrays")
    ex = [_host(e) for e in extras]
    for e in ex:
        if e.shape[:1] != src.shape:
            raise ValueError("extra array length != n_edges")
    names = list(field_names) if field_names is not None else [
        f"x{i}" for i in range(len(ex))]
    if len(names) != len(ex):
        raise ValueError("field_names length != number of extras")
    fields = ["src", "dst", *names]
    if len(set(fields)) != len(fields):
        raise ValueError(f"duplicate field names in {fields}")
    n = int(src.shape[0])
    if n_vertices is None:
        n_vertices = int(max(src.max(), dst.max())) + 1 if n else 0
    arrays = [src, dst, *ex]
    shard_rows = []
    for sid, lo in enumerate(range(0, n, shard_edges)):
        hi = min(lo + shard_edges, n)
        files = {}
        for name, arr in zip(fields, arrays):
            fname = f"shard_{sid:05d}.{name}.npy"
            np.save(out / fname, arr[lo:hi])
            files[name] = fname
        shard_rows.append({"id": sid, "offset": lo, "n_edges": hi - lo,
                           "files": files})
    manifest = {
        "version": MANIFEST_VERSION,
        "format": "s5p-edge-shards",
        "n_edges": n,
        "n_vertices": int(n_vertices),
        "shard_edges": int(shard_edges),
        "fields": [
            {"name": name, "dtype": str(arr.dtype), "shape": list(arr.shape[1:])}
            for name, arr in zip(fields, arrays)
        ],
        "shards": shard_rows,
    }
    mpath = out / MANIFEST_NAME
    mpath.write_text(json.dumps(manifest, indent=1))
    return mpath


def append_shards(manifest, src, dst, *extras) -> Path:
    """Grow a shard directory in place with an insertion batch; returns the
    manifest path.

    ``append(prefix); append(delta)`` leaves the shards of one
    ``write_shards(prefix + delta)``: the tail shard is topped up to
    ``shard_edges`` before new shards are laid down.  Extras must match
    the manifest's fields (order, dtype, trailing shape).  The commit
    order survives a crash: the tail shard's files are replaced first
    (their committed rows unchanged; the old manifest never reads past
    them), the new shards next, the manifest last by tmp +
    ``os.replace``.  Reopen a :class:`ShardedEdgeStream` after growing.
    """
    mpath, meta = read_manifest(manifest)
    root = mpath.parent
    src = _host(src, np.int32)
    dst = _host(dst, np.int32)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError("src/dst must be equal-length 1-D arrays")
    ex = [_host(e) for e in extras]
    fields = meta["fields"]
    if len(ex) != len(fields) - 2:
        raise ValueError(
            f"manifest has {len(fields) - 2} extra fields, got {len(ex)}")
    arrays = [src, dst, *ex]
    for f, arr in zip(fields, arrays):
        if arr.shape[:1] != src.shape:
            raise ValueError("extra array length != n_edges")
        if str(arr.dtype) != f["dtype"] or list(arr.shape[1:]) != f["shape"]:
            raise ValueError(
                f"field {f['name']!r} expects dtype {f['dtype']} shape "
                f"{f['shape']}, got {arr.dtype} {list(arr.shape[1:])}")
    names = [f["name"] for f in fields]
    se = int(meta["shard_edges"])
    n_new = int(src.shape[0])
    shard_rows = list(meta["shards"])

    consumed = 0
    if n_new and shard_rows and shard_rows[-1]["n_edges"] < se:
        tail = dict(shard_rows[-1])
        take = min(se - tail["n_edges"], n_new)
        for name, arr in zip(names, arrays):
            fpath = root / tail["files"][name]
            # the manifest's length: a crash between the tail's replacement
            # and the manifest's commit leaves uncommitted rows in the file
            old = np.load(fpath)[: tail["n_edges"]]
            tmp = fpath.with_name("tmp-" + fpath.name)  # np.save keeps .npy
            np.save(tmp, np.concatenate([old, arr[:take]]))
            os.replace(tmp, fpath)
        tail["n_edges"] += take
        shard_rows[-1] = tail
        consumed = take
    next_off = (shard_rows[-1]["offset"] + shard_rows[-1]["n_edges"]
                if shard_rows else 0)
    sid = len(shard_rows)
    for lo in range(consumed, n_new, se):
        hi = min(lo + se, n_new)
        files = {}
        for name, arr in zip(names, arrays):
            fname = f"shard_{sid:05d}.{name}.npy"
            np.save(root / fname, arr[lo:hi])
            files[name] = fname
        shard_rows.append({"id": sid, "offset": next_off, "n_edges": hi - lo,
                           "files": files})
        next_off += hi - lo
        sid += 1

    n_vertices = int(meta["n_vertices"])
    if n_new:
        n_vertices = max(n_vertices, int(max(src.max(), dst.max())) + 1)
    meta = dict(meta, n_edges=int(meta["n_edges"]) + n_new,
                n_vertices=n_vertices, shards=shard_rows)
    tmp = mpath.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(meta, indent=1))
    os.replace(tmp, mpath)
    return mpath


def read_manifest(path) -> tuple[Path, dict]:
    """Resolve a manifest path (the file or its shard directory) and load it."""
    p = Path(path)
    if p.is_dir():
        p = p / MANIFEST_NAME
    meta = json.loads(p.read_text())
    version = meta.get("version")
    if version != MANIFEST_VERSION:
        raise ValueError(f"unsupported shard manifest version {version!r}")
    return p, meta


class _Shard:
    """One on-disk shard: its fields' mmaps, opened at first use."""

    __slots__ = ("offset", "n", "root", "files", "_mm")

    def __init__(self, root: Path, offset: int, n: int, files: dict):
        self.root = root
        self.offset = int(offset)
        self.n = int(n)
        self.files = files
        self._mm: dict = {}

    def mm(self, field: str) -> np.ndarray:
        m = self._mm.get(field)
        if m is None:
            m = np.load(self.root / self.files[field], mmap_mode="r")
            self._mm[field] = m
        return m

    def close(self) -> None:
        self._mm.clear()


class _FieldView:
    """One stored field as an array-like: ``len``, ``.shape`` and unit-stride
    slices or index arrays, each returning a copy of just those rows (what
    :meth:`EdgeStream.chunk_at` asks of an extra), so stored fields page
    through ``chunks()``."""

    def __init__(self, stream: "ShardedEdgeStream", shards, field: str,
                 dtype, shape: tuple):
        self._stream = stream
        self._shards = shards
        self._field = field
        self.dtype = np.dtype(dtype)
        self.shape = shape
        self._staged = 0  # bytes of the last rows returned, still live

    def __len__(self) -> int:
        return self.shape[0]

    def _stage(self, rows: np.ndarray) -> np.ndarray:
        # the previous read is dead once the next one is built
        rows = _owned(rows)
        budget = self._stream.budget
        budget.release(self._staged)
        self._staged = int(rows.nbytes)
        budget.charge(self._staged)
        return rows

    def __getitem__(self, sl):
        if isinstance(sl, slice):
            start, stop, step = sl.indices(self.shape[0])
            if step != 1:
                raise IndexError("field views support unit-stride slices only")
            return self._stage(self._stream._read_range(
                self._shards, self._field, start, stop))
        return self._stage(self._stream._gather(
            self._shards, self._field, np.asarray(sl, np.int64)))


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------


class ShardedEdgeStream(EdgeStream):
    """An :class:`EdgeStream` over a shard directory, paged from disk.

    The same ``chunks()`` / ``chunk_at()`` / ``scatter_back()`` contract, so
    every consumer runs on it unchanged: only ``_edges_at`` differs.
    ``scratch_dir`` takes the reorder spills (keyed by ordering, seed and
    window: give each stream alive at once its own); a private temporary
    directory, removed on :meth:`close` or collection, otherwise.
    ``budget`` is the :class:`HostBudget` charged.
    """

    def __init__(self, manifest, *, chunk_size: int = DEFAULT_CHUNK,
                 ordering: str = "natural", seed: int = 0, window: int = 4096,
                 scratch_dir=None, budget: HostBudget | None = None,
                 device=None):
        # no super().__init__: the base's host arrays are what this class
        # must not hold
        if ordering not in ORDERINGS:
            raise ValueError(f"unknown ordering {ordering!r}; one of {ORDERINGS}")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if window < 1:
            raise ValueError("window must be >= 1")
        self.device = resolve_device(device)
        self.manifest_path, self._meta = read_manifest(manifest)
        self.root = self.manifest_path.parent
        self._n_edges = int(self._meta["n_edges"])
        self.n_vertices = int(self._meta["n_vertices"])
        self.shard_edges = int(self._meta["shard_edges"])
        self._fields = {f["name"]: f for f in self._meta["fields"]}
        self._shards = [_Shard(self.root, s["offset"], s["n_edges"], s["files"])
                        for s in self._meta["shards"]]
        self.chunk_size = int(chunk_size)
        self.ordering = ordering
        self.seed = int(seed)
        self.window = int(window)
        self.budget = budget if budget is not None else HostBudget()
        self.plans: dict = {}
        # reorder block: buffers stay O(shard_edges + chunk_size)
        self._block = max(min(self.shard_edges, 1 << 16), self.chunk_size, 1024)
        self._staged = 0  # bytes of the live chunk staging copy
        self._respilled: list[_Shard] | None = None
        self._scratch = Path(scratch_dir) if scratch_dir is not None else None
        self._finalizer = None
        if self._scratch is not None:
            self._scratch.mkdir(parents=True, exist_ok=True)
        self._order = self._make_order()

    # -------------------------------------------------------------- misc
    @property
    def n_edges(self) -> int:
        return self._n_edges

    @property
    def field_names(self) -> tuple:
        return tuple(self._fields)

    @property
    def src(self):
        raise AttributeError(
            "ShardedEdgeStream holds no host-resident edge arrays; page via "
            "chunks()/chunk_at(), or materialize explicitly with "
            "arrival_arrays()")

    dst = src

    def open_field(self, name: str) -> _FieldView:
        """A paged view of a stored per-edge field (for ``chunks(*extras)``)."""
        f = self._fields[name]
        return _FieldView(self, self._shards, name, f["dtype"],
                          (self._n_edges, *f["shape"]))

    def arrival_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) in arrival order: O(E) host memory, for metrics and
        converters only; the read path never calls it."""
        return (np.array(self._read_range(self._shards, "src", 0, self._n_edges)),
                np.array(self._read_range(self._shards, "dst", 0, self._n_edges)))

    def close(self) -> None:
        for sh in self._shards:
            sh.close()
        for sh in self._respilled or ():
            sh.close()
        if self._finalizer is not None:
            self._finalizer()
            self._finalizer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- scratch
    def _scratch_path(self, name: str) -> Path:
        if self._scratch is None:
            self._scratch = Path(tempfile.mkdtemp(prefix="oocstream-"))
            self._finalizer = weakref.finalize(
                self, shutil.rmtree, str(self._scratch), ignore_errors=True)
        return self._scratch / name

    @property
    def _tag(self) -> str:
        return f"{self.ordering}-s{self.seed}-w{self.window}"

    # --------------------------------------------------------- raw reads
    def _read_range(self, shards, field: str, start: int, stop: int) -> np.ndarray:
        """Rows [start, stop) across a shard list: a zero-copy mmap view
        when they lie in one shard.  The caller charges what it keeps."""
        if stop <= start:
            f = self._fields.get(field)
            shape = (0, *(f["shape"] if f else ()))
            return np.empty(shape, f["dtype"] if f else np.int32)
        parts = []
        for sh in shards:
            lo = max(start - sh.offset, 0)
            hi = min(stop - sh.offset, sh.n)
            if lo < hi:
                parts.append(sh.mm(field)[lo:hi])
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _gather(self, shards, field: str, idx: np.ndarray) -> np.ndarray:
        """Rows at arbitrary arrival indices, grouped by shard."""
        first = shards[0].mm(field) if shards else None
        dt = first.dtype if first is not None else np.int32
        trail = first.shape[1:] if first is not None else ()
        out = np.empty((idx.shape[0], *trail), dt)
        with self.budget.scoped(idx.nbytes):  # mask and offset scratch
            for sh in shards:
                m = (idx >= sh.offset) & (idx < sh.offset + sh.n)
                if m.any():
                    out[m] = sh.mm(field)[idx[m] - sh.offset]
        return out

    def _iter_field(self, field: str):
        """Python ints of a field, read a block at a time."""
        for sh in self._shards:
            mm = sh.mm(field)
            for lo in range(0, sh.n, self._block):
                blk = np.asarray(mm[lo:lo + self._block])
                with self.budget.scoped(blk.nbytes):
                    yield from blk.tolist()

    # ----------------------------------------------------- order building
    def _make_order(self):
        if self.ordering == "natural":
            return None
        if self._n_edges == 0:
            return np.empty(0, np.int64)
        opath = self._scratch_path(f"order-{self._tag}.npy")
        if self.ordering == "shuffled":
            self._build_shuffled_order(opath)
        elif self.ordering == "dst-sorted":
            self._build_dst_sorted_order(opath)
        else:
            self._build_windowed_order(opath)
        order = np.load(opath, mmap_mode="r")
        if self.ordering in ("shuffled", "dst-sorted"):
            self._respilled = self._spill_reordered(order)
        return order

    def _build_shuffled_order(self, opath: Path) -> None:
        """``Generator.permutation(E)`` is an arange shuffled in place by
        Fisher–Yates, whose draws depend on E alone: shuffling a scratch
        memmap gives the in-memory stream's permutation."""
        E = self._n_edges
        perm = np.lib.format.open_memmap(opath, mode="w+", dtype=np.int64,
                                         shape=(E,))
        with self.budget.scoped(self._block * 8):
            for lo in range(0, E, self._block):
                hi = min(lo + self._block, E)
                perm[lo:hi] = np.arange(lo, hi, dtype=np.int64)
        np.random.default_rng(self.seed).shuffle(perm)
        perm.flush()
        del perm

    def _build_dst_sorted_order(self, opath: Path) -> None:
        """External stable merge sort by dst: per-shard stable runs merged
        with ties to the arrival index give ``argsort(dst, kind="stable")``
        (a stable order is unique), with O(shard_edges) buffers."""
        runs = []
        for sh in self._shards:
            d = np.asarray(sh.mm("dst"))
            with self.budget.scoped(d.nbytes * 4):  # d, argsort, key, index
                loc = np.argsort(d, kind="stable")
                kpath = self._scratch_path(f"run-{sh.offset}.key.npy")
                ipath = self._scratch_path(f"run-{sh.offset}.idx.npy")
                np.save(kpath, d[loc])
                np.save(ipath, loc.astype(np.int64) + sh.offset)
            runs.append((kpath, ipath))
        del d, loc

        block = max(256, min(self._block, -(-self._block // max(len(runs), 1))))

        def run_iter(kpath, ipath):
            key = np.load(kpath, mmap_mode="r")
            idx = np.load(ipath, mmap_mode="r")
            for lo in range(0, key.shape[0], block):
                kb = np.asarray(key[lo:lo + block])
                ib = np.asarray(idx[lo:lo + block])
                with self.budget.scoped(kb.nbytes + ib.nbytes):
                    yield from zip(kb.tolist(), ib.tolist())

        self._spill_order(opath, (arrival for _, arrival in
                                  _heap_merge(*(run_iter(k, i) for k, i in runs))), 0)
        for kpath, ipath in runs:
            kpath.unlink()
            ipath.unlink()

    def _build_windowed_order(self, opath: Path) -> None:
        """One bounded-heap pass of the shared emitter over dst, shard by
        shard; the heap holds <= window + 1 (dst, index) pairs."""
        self._spill_order(opath, _windowed_emit(self._iter_field("dst"), self.window),
                          (self.window + 1) * 64)

    def _spill_order(self, opath: Path, arrivals, held: int) -> None:
        """Write an iterator of arrival indices to ``opath`` a block at a
        time; ``held`` is what the iterator keeps besides the block."""
        out = np.lib.format.open_memmap(opath, mode="w+", dtype=np.int64,
                                        shape=(self._n_edges,))
        buf = np.empty(self._block, np.int64)
        with self.budget.scoped(buf.nbytes + held):
            j = pos = 0
            for arrival in arrivals:
                buf[j] = arrival
                j += 1
                if j == buf.shape[0]:
                    out[pos:pos + j] = buf
                    pos += j
                    j = 0
            if j:
                out[pos:pos + j] = buf[:j]
        out.flush()
        del out

    def _spill_reordered(self, order) -> list[_Shard]:
        """Rewrite src/dst in stream order as scratch shards of
        ``shard_edges`` edges, so the read path is contiguous."""
        spilled = []
        se = self.shard_edges
        for sid, lo in enumerate(range(0, self._n_edges, se)):
            hi = min(lo + se, self._n_edges)
            idx = np.asarray(order[lo:hi])
            with self.budget.scoped(idx.nbytes):
                files = {}
                for field in ("src", "dst"):
                    rows = self._gather(self._shards, field, idx)
                    with self.budget.scoped(rows.nbytes):
                        fname = f"spill-{self._tag}-{sid:05d}.{field}.npy"
                        np.save(self._scratch_path(fname), rows)
                    files[field] = fname
            spilled.append(_Shard(self._scratch, lo, hi - lo, files))
        return spilled

    # ----------------------------------------------------------- read path
    def scatter_back(self, values: torch.Tensor) -> torch.Tensor:
        """Per-edge results (last axis) from stream to arrival order.

        ``values`` and the result are the caller's O(E); the stream builds
        no O(E) inverse permutation, but walks the order mmap in charged
        O(block) slices and scatters on ``values.device``."""
        if self._order is None:
            return values
        out = torch.empty_like(values)
        for lo in range(0, self._n_edges, self._block):
            idx = np.array(self._order[lo:lo + self._block])
            with self.budget.scoped(idx.nbytes):
                pos = torch.from_numpy(idx).to(values.device)
                out.index_copy_(-1, pos, values[..., lo:lo + idx.shape[0]])
        return out

    def _edges_at(self, sl, start: int, stop: int):
        """Owned int32 copies of the edges at stream positions [start, stop)
        (natural, a slice of arrival positions: contiguous reads; shuffled
        and dst-sorted: the respilled shards; windowed, or any index array
        over a natural stream: gathers)."""
        # the previous chunk's staging copy is dead once the next is built
        self.budget.release(self._staged)
        self._staged = 0
        if isinstance(sl, slice):
            s = self._read_range(self._shards, "src", start, stop)
            d = self._read_range(self._shards, "dst", start, stop)
        elif self._respilled is not None:
            s = self._read_range(self._respilled, "src", start, stop)
            d = self._read_range(self._respilled, "dst", start, stop)
        else:
            idx = np.asarray(sl, np.int64)
            s = self._gather(self._shards, "src", idx)
            d = self._gather(self._shards, "dst", idx)
        s, d = _owned(s), _owned(d)
        self._staged = int(s.nbytes + d.nbytes)
        self.budget.charge(self._staged)
        return s, d


def _owned(a: np.ndarray) -> np.ndarray:
    """``a`` itself when it owns writable memory, else a copy (an mmap view
    is read-only, and ``torch.from_numpy`` wants writable memory)."""
    return a if a.flags.owndata and a.flags.writeable else np.array(a)
