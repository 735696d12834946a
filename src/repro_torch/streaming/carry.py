"""PartitionerCarry — the carry protocol every streaming consumer speaks.

A streaming partitioner is an ``init / step_chunk / retract_chunk / merge /
finalize`` quintuple over an O(|V| + k) carry:

- ``init()``          — the identity carry (empty tables, zero loads);
- ``step_chunk``      — fold one EdgeStream chunk into the carry and
  optionally emit per-edge results (``parts``) for that chunk;
- ``retract_chunk``   — undo the accounting ``step_chunk`` did for these
  edges, given their recorded ``parts``;
- ``merge``           — reconcile carries folded by independent lanes of
  one stream (:func:`~repro_torch.streaming.parallel.run_parallel`);
- ``finalize``        — extract the consumer-facing result.

Merge semantics are declared per leaf in :attr:`PartitionerCarry.merge_ops`,
in the order :func:`tree_flatten` visits the carry: tuples and NamedTuples
(``ClusterState``, ``CMSketch``), lists and dicts (keys sorted) are walked
depth first, ``None`` holds no leaf, anything else is a leaf (a tensor, an
array, or a Python scalar such as the grid's ``n_cols``, which is always
``REPLICATED``) — the order of ``jax.tree_util``.
:func:`tree_flatten_with_paths` names each leaf by the reference's
checkpoint path (``carry/scan/0``, ``carry/.v2c_h``), the key a checkpoint
file stores it under.  The ops are those of ``repro.streaming.carry``:

- ``SUM`` — additive statistics (loads, volumes, degrees, CMS tables, id
  counters).  Carries that diverged from a common ``base`` merge as
  ``base + Σ (cᵢ − base)``.  int32 adds wrap, so the CMS table (int32
  holding uint32 bit patterns) is the group ℤ/2³² here as in the reference.
- ``COUNTED`` — occupancy counters (replica tables); merged like SUM.
- ``REPLICATED`` — constants threaded through the carry; the first wins.
- ``OR`` / ``MAX`` — the monotone ops, for external consumers.

``pick_first`` leaves (vertex → cluster tables) keep the lowest lane's
value where several lanes changed a cell.  ``SUM``/``COUNTED`` leaves form
a group: :meth:`~PartitionerCarry.signed_delta`, :meth:`~PartitionerCarry.
negate` and :meth:`~PartitionerCarry.apply_delta` invert bit for bit.

The port's carries may update their tensors in place (K1–K3 write through
the tensors they are handed), so the merges here always build new tensors
and never write into the carries they read.  ``merge_collective`` is the
reference's ``shard_map`` merge over a ``torch.distributed`` group: every
rank holds one lane's carry and gets the merged one back.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Sequence

import torch

__all__ = [
    "SUM",
    "COUNTED",
    "OR",
    "MAX",
    "REPLICATED",
    "MERGE_OPS",
    "GROUP_OPS",
    "CARRY_REPR",
    "PartitionerCarry",
    "FnCarry",
    "RetractCarry",
    "tree_flatten",
    "tree_flatten_with_paths",
    "tree_leaves",
    "tree_unflatten",
]

SUM = "sum"
COUNTED = "counted"
OR = "or"
MAX = "max"
REPLICATED = "replicated"

MERGE_OPS = (SUM, COUNTED, OR, MAX, REPLICATED)

#: ops whose leaves form an abelian group under merge
GROUP_OPS = (SUM, COUNTED)

#: representation generation of the carry algebra (2 = counted / group)
CARRY_REPR = 2

_LEAF = object()


def _walk(x, leaves: list, paths: list | None = None, prefix: str = ""):
    if x is None:
        return None
    if isinstance(x, dict):
        keys = sorted(x)
        return (dict, keys, [_walk(x[k], leaves, paths, _join(prefix, k)) for k in keys])
    if isinstance(x, (tuple, list)):
        named = getattr(x, "_fields", None)
        return (type(x), None, [
            _walk(c, leaves, paths, _join(prefix, f".{named[i]}" if named else i))
            for i, c in enumerate(x)])
    leaves.append(x)
    if paths is not None:
        paths.append(prefix)
    return _LEAF


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def tree_flatten(tree) -> tuple[list, Any]:
    """``(leaves, spec)``: tuples, NamedTuples, lists and dicts (sorted
    keys) walked depth first, every other object a leaf; ``None`` holds no
    leaf (as in ``jax.tree_util``).  Plain recursion, no closures: a
    self-referencing closure would keep the leaves (the lanes' tensors)
    alive until the cyclic collector runs."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def tree_flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in :func:`tree_flatten` order, each path the
    reference checkpoint's key: dict keys, sequence indices and
    ``.field`` for a NamedTuple field, joined by ``/``."""
    leaves: list = []
    paths: list = []
    _walk(tree, leaves, paths)
    return list(zip(paths, leaves))


def _build(spec, it):
    if spec is None:
        return None
    if spec is _LEAF:
        return next(it)
    typ, keys, kids = spec
    vals = [_build(k, it) for k in kids]
    if typ is dict:
        return dict(zip(keys, vals))
    return typ(vals) if typ in (tuple, list) else typ(*vals)


def tree_unflatten(spec, leaves: Iterable):
    return _build(spec, iter(leaves))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def _check_ops(ops: Sequence[str], n_leaves: int) -> None:
    if len(ops) != n_leaves:
        raise ValueError(
            f"merge_ops declares {len(ops)} fields but the carry has "
            f"{n_leaves} leaves")
    for op in ops:
        if op not in MERGE_OPS:
            raise ValueError(f"unknown merge op {op!r}; one of {MERGE_OPS}")


def _or_leaf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b if a.dtype == torch.bool else torch.maximum(a, b)


def _neg(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device) - x


class PartitionerCarry:
    """Base class: declare :attr:`merge_ops`, implement ``init`` and
    ``step_chunk``.

    ``step_chunk(carry, src, dst, n_valid, *extras) -> (carry, parts)``;
    ``n_valid`` is the chunk's unpadded length (padding entries are (0, 0)
    self-loops).  ``parts`` is the per-edge result, or ``None`` for
    state-only consumers (clustering, the Θ pass).  The port's carries
    may update the carry's tensors in place and return them.
    """

    #: one merge op per carry leaf, in :func:`tree_flatten` order
    merge_ops: tuple[str, ...] = ()

    #: leaf indices whose merge keeps the lowest changed lane's value
    pick_first: tuple[int, ...] = ()

    #: False for state-only consumers whose step_chunk returns parts=None
    emits_parts: bool = True

    #: True once the consumer implements :meth:`retract_chunk`
    supports_retract: bool = False

    #: True when retract_chunk(step_chunk(c, chunk), chunk, parts) == c
    #: bitwise (the scoring carries); False where retraction is an
    #: approximation (Alg. 1 clustering: migrations depend on history)
    retract_exact: bool = False

    # ------------------------------------------------------------ protocol
    def init(self):
        raise NotImplementedError

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        raise NotImplementedError

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        """Subtract what ``step_chunk`` added for the first ``n_valid``
        entries of this chunk, given their recorded ``parts``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support edge deletion")

    def finalize(self, carry):
        return carry

    # -------------------------------------------------------- group algebra
    def _zip(self, *trees):
        flats = [tree_flatten(t) for t in trees]
        spec = flats[0][1]
        _check_ops(self.merge_ops, len(flats[0][0]))
        return spec, [f[0] for f in flats]

    def signed_delta(self, after, before):
        """The group difference ``after ⊖ before`` per leaf (REPLICATED
        leaves pass ``after`` through; the monotone ops raise)."""
        spec, (fa, fb) = self._zip(after, before)
        out = []
        for op, a, b in zip(self.merge_ops, fa, fb):
            if op in GROUP_OPS:
                out.append(a - b)
            elif op == REPLICATED:
                out.append(a)
            else:
                raise ValueError(
                    f"merge op {op!r} is monotone — it has no signed delta")
        return tree_unflatten(spec, out)

    def negate(self, delta):
        """The group inverse of a signed delta (identity on REPLICATED)."""
        spec, (fd,) = self._zip(delta)
        out = []
        for op, x in zip(self.merge_ops, fd):
            if op in GROUP_OPS:
                out.append(_neg(x))
            elif op == REPLICATED:
                out.append(x)
            else:
                raise ValueError(
                    f"merge op {op!r} is monotone — it has no inverse")
        return tree_unflatten(spec, out)

    def apply_delta(self, carry, delta):
        """``carry ⊕ delta``; ``apply_delta(apply_delta(c, δ), negate(δ))
        == c`` bit for bit."""
        spec, (fc, fd) = self._zip(carry, delta)
        out = []
        for op, c, d in zip(self.merge_ops, fc, fd):
            if op in GROUP_OPS:
                out.append((c + d).to(c.dtype))
            elif op == REPLICATED:
                out.append(c)
            else:
                raise ValueError(
                    f"merge op {op!r} is monotone — signed deltas do not "
                    "apply")
        return tree_unflatten(spec, out)

    # ------------------------------------------------------------- merging
    def merge(self, carries: Iterable[Any], base: Any | None = None):
        """Reconcile carries of independent lanes.  With ``base``, each is
        a divergence from it (``base + Σ (cᵢ − base)``); without, SUM
        leaves add.  ``merge([c])`` returns ``c`` itself."""
        carries = list(carries)
        if not carries:
            raise ValueError("merge() needs at least one carry")
        if len(carries) == 1:
            return carries[0]
        spec, cols = self._zip(*carries)
        base_flat = tree_leaves(base) if base is not None else None
        out = []
        for i, op in enumerate(self.merge_ops):
            leaves = [c[i] for c in cols]
            if op in GROUP_OPS:
                if i in self.pick_first and base_flat is not None:
                    b = base_flat[i]
                    acc = b.clone()
                    taken = torch.zeros(b.shape, dtype=torch.bool, device=b.device)
                    for x in leaves:
                        ch = x != b
                        acc = torch.where(ch & ~taken, x, acc)
                        taken = taken | ch
                    out.append(acc.to(leaves[0].dtype))
                    continue
                acc = leaves[0]
                for x in leaves[1:]:
                    acc = acc + x
                if base_flat is not None:
                    acc = acc - (len(leaves) - 1) * base_flat[i].to(acc.dtype)
                out.append(acc)
            elif op in (OR, MAX):
                acc = leaves[0]
                for x in leaves[1:]:
                    acc = _or_leaf(acc, x) if op == OR else torch.maximum(acc, x)
                out.append(acc)
            else:  # REPLICATED
                out.append(leaves[0])
        return tree_unflatten(spec, out)

    def merge_stacked(self, stacked, base: Any | None = None):
        """Merge a carry whose tensor leaves carry a leading lane axis (the
        batched backend's layout), one reduction per leaf.  Non-tensor
        leaves are shared by every lane and pass through."""
        spec, (flat,) = self._zip(stacked)
        base_flat = tree_leaves(base) if base is not None else None
        out = []
        for i, op in enumerate(self.merge_ops):
            x = flat[i]
            if not isinstance(x, torch.Tensor):
                out.append(x)
            elif op in GROUP_OPS:
                if i in self.pick_first and base_flat is not None:
                    b = base_flat[i]
                    changed = x != b[None, ...]
                    first = changed.to(torch.uint8).argmax(dim=0)
                    picked = x.gather(0, first[None, ...])[0]
                    out.append(torch.where(changed.any(dim=0), picked, b).to(x.dtype))
                    continue
                acc = x.sum(dim=0, dtype=x.dtype)
                if base_flat is not None:
                    acc = acc - (x.shape[0] - 1) * base_flat[i].to(acc.dtype)
                out.append(acc.to(x.dtype))
            elif op == OR:
                out.append(x.any(dim=0) if x.dtype == torch.bool else x.amax(dim=0))
            elif op == MAX:
                out.append(x.amax(dim=0))
            else:  # REPLICATED
                out.append(x[0])
        return tree_unflatten(spec, out)

    def occupancy_contest(self, before, after) -> float:
        """The fraction of active cells whose zero/nonzero projection
        flipped between two merge bases: over the COUNTED leaves, else the
        SUM leaves, else 0 (what ``super_chunk="auto"`` backs off on)."""
        spec, (fb, fa) = self._zip(before, after)
        for pick in (COUNTED, SUM):
            changed = active = None
            for op, b, a in zip(self.merge_ops, fb, fa):
                if op != pick:
                    continue
                c = ((b != 0) != (a != 0)).sum()
                n = (a != 0).sum()
                changed = c if changed is None else changed + c
                active = n if active is None else active + n
            if changed is not None:
                got = torch.stack([changed, active]).tolist()
                return got[0] / max(got[1], 1)
        return 0.0

    def merge_collective(self, local, base, axis=None):
        """The collective form of :meth:`merge`, called on every rank of
        ``axis`` (a group as :func:`repro_torch._dist.group_of` reads it:
        ``None`` for the default group, a ``ProcessGroup``, a 1-D
        ``DeviceMesh`` or ``(mesh, dim name)``) with the rank's ``local``
        carry and the common ``base``: one collective a leaf, ``b + Σ(x −
        b)`` for SUM and COUNTED (wrapping at the leaf's width),
        ``pick_first`` through a MIN over the rank of each changed cell, MAX
        for OR and MAX, the base for REPLICATED.  Every rank returns the
        same new carry, equal bit for bit to :meth:`merge` of the ranks'
        carries (rank order = lane order)."""
        from .. import _dist

        spec, (flat, base_flat) = self._zip(local, base)
        me, n = _dist.rank(axis), _dist.world_size(axis)
        out = []
        for i, op in enumerate(self.merge_ops):
            x, b = flat[i], base_flat[i]
            if not isinstance(x, torch.Tensor) or op == REPLICATED:
                out.append(b)
            elif op in GROUP_OPS:
                b = b.to(x.dtype)
                exact = not x.dtype.is_floating_point  # integer deltas ride int64
                d = x.to(torch.int64) - b.to(torch.int64) if exact else x - b
                if i in self.pick_first:
                    changed = x != b
                    rank = torch.full(x.shape, me, dtype=torch.int64, device=x.device)
                    winner = _dist.all_reduce(torch.where(changed, rank, rank.new_full((), n)),
                                              _dist.MIN, axis)
                    d = torch.where(changed & (winner == me), d, torch.zeros_like(d))
                total = _dist.all_reduce(d, _dist.SUM, axis)
                out.append(_dist.wrap(b.to(torch.int64) + total, x.dtype) if exact
                           else b + total)
            else:  # OR, MAX (bools travel as int32)
                out.append(_dist.all_reduce(x, _dist.MAX, axis))
        return tree_unflatten(spec, out)


class FnCarry(PartitionerCarry):
    """Adapter: a bare ``(carry0, chunk_fn)`` pair as a PartitionerCarry
    (``chunk_fn(carry, src, dst, *extras)``); no merge semantics — the
    sequential ``run_scan`` only."""

    def __init__(self, carry0, chunk_fn: Callable):
        self._carry0 = carry0
        self._chunk_fn = chunk_fn

    def init(self):
        return self._carry0

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        return self._chunk_fn(carry, src, dst, *extras)


class RetractCarry(PartitionerCarry):
    """Adapter: a consumer's **retraction** as a fold.  ``step_chunk`` is
    the wrapped consumer's ``retract_chunk``, with the deleted edges'
    recorded ``parts`` as the first stream extra (``with_parts=False``
    forwards ``None``).  Retraction only subtracts on group leaves, so a
    deletion batch shards through ``run_parallel`` like an insertion."""

    emits_parts = False

    def __init__(self, pc: PartitionerCarry, *, with_parts: bool = True):
        if not pc.supports_retract:
            raise NotImplementedError(
                f"{type(pc).__name__} does not support edge deletion")
        self._pc = pc
        self._with_parts = bool(with_parts)

    @property
    def merge_ops(self) -> tuple[str, ...]:
        return self._pc.merge_ops

    def init(self):
        return self._pc.init()

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        if self._with_parts:
            parts, extras = extras[0], extras[1:]
        else:
            parts = None
        return (self._pc.retract_chunk(carry, src, dst, n_valid, parts,
                                       *extras), None)
