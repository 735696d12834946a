"""Elastic scaling: grow or shrink the worker set without losing the run
(the port of ``repro.runtime.elastic``).

The flow on a resize: checkpoint (host arrays, placement-independent),
build the new device set, restore the checkpoint and place it, and, when
the job is graph-shaped, re-home its S5P bundle with bounded migration
(:func:`repro_torch.elastic.reshard_bundle`) instead of re-partitioning
cold.  ``make_mesh(n)`` returns a ``torch.device`` (one card) or a
``DeviceMesh`` over the world's first n ranks, and the state is placed
through :func:`~repro_torch.checkpoint.reshard.reshard_state`: onto the
device, or as ``DTensor`` leaves laid out by ``make_shardings(mesh)`` (a
tree of ``(mesh, placements)``; replicated over the mesh without one).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..checkpoint import CheckpointManager
from ..checkpoint.reshard import reshard_state

__all__ = ["ElasticController", "ElasticPartition"]


class ElasticPartition:
    """The graph-shaped job's routing state under elastic resizes: an S5P
    warm bundle and the arrival-indexed stream prefix it is keyed on.
    :meth:`resize` reshards in place and returns the
    :class:`~repro_torch.elastic.ReshardResult`; :attr:`parts` is the
    live arrival-indexed assignment at the current k."""

    def __init__(self, bundle: dict, config, full_src, full_dst, *, device=None):
        self.bundle = bundle
        self.config = config
        self.full_src = np.asarray(full_src, np.int32)
        self.full_dst = np.asarray(full_dst, np.int32)
        self.device = device

    @property
    def k(self) -> int:
        return int(self.config.k)

    @property
    def parts(self) -> np.ndarray:
        from ..incremental.pipeline import _scatter_parts, ensure_slot_index

        b = ensure_slot_index(self.bundle)
        parts = np.where(np.asarray(b["alive"], bool),
                         np.asarray(b["parts"], np.int32), -1)
        return _scatter_parts(parts.astype(np.int32),
                              np.asarray(b["arrival"], np.int64),
                              int(b["stream_pos"]))

    def resize(self, k_new: int):
        from ..elastic import reshard_bundle

        self.bundle, self.config, res = reshard_bundle(
            self.bundle, self.config, k_new, self.full_src, self.full_dst,
            device=self.device)
        return res


class ElasticController:
    """Checkpoint → new devices → restore and place → re-partition.

    ``partition`` (an :class:`ElasticPartition`) takes precedence over the
    ``repartition`` hook: the resize re-homes the existing bundle with
    bounded migration instead of partitioning the graph cold.
    """

    def __init__(self, manager: CheckpointManager,
                 make_mesh: Callable[[int], object],
                 make_shardings: Callable[[object], object] | None = None,
                 repartition: Callable[[int], object] | None = None,
                 partition: ElasticPartition | None = None):
        self.manager = manager
        self.make_mesh = make_mesh
        self.make_shardings = make_shardings
        self.repartition = repartition
        self.partition = partition

    def resize(self, state, step: int, new_size: int):
        """Returns ``(new_state, mesh, parts, step)``: the state restored
        from the checkpoint and placed by ``make_shardings(mesh)`` (a
        device, a ``(DeviceMesh, placements)`` pair, or a tree of them) or
        else onto ``mesh`` itself (a device, or a ``DeviceMesh``: every leaf
        replicated).  With a mesh, every rank of the world calls ``resize``
        (building a mesh, and saving ``DTensor`` leaves, are collective),
        each with a manager of its own directory; a rank inside the new
        mesh gets ``DTensor`` leaves whose ``full_tensor()`` is the
        checkpoint bit for bit, a rank outside it ``DTensor`` leaves with
        empty local tensors;
        ``parts`` is the warm reshard's ``ReshardResult`` with a
        ``partition``, the ``repartition`` hook's value otherwise (``None``
        with neither)."""
        self.manager.save(step, state)
        self.manager.wait()
        mesh = self.make_mesh(new_size)
        host_state, step = self.manager.restore(like=state)
        placement = self.make_shardings(mesh) if self.make_shardings else mesh
        new_state = reshard_state(host_state, placement)
        if self.partition is not None:
            parts = self.partition.resize(new_size)
        else:
            parts = self.repartition(new_size) if self.repartition else None
        return new_state, mesh, parts, step
