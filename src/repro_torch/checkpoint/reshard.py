"""Restart placement: put a host checkpoint's leaves onto a device or a mesh.

Checkpoints hold full (unsharded) host arrays, so placement is all a
restart needs: each leaf becomes a tensor on its target ``torch.device``,
or a ``DTensor`` laid out over a ``DeviceMesh`` (the counterpart of
``jax.device_put(x, NamedSharding)``).  Every rank holds the whole
checkpoint, so a rank takes its own shard without any collective.
"""

from __future__ import annotations

import numpy as np
import torch

from ..streaming.carry import tree_flatten, tree_unflatten

__all__ = ["reshard_state"]


def _is_mesh(x) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(x, DeviceMesh)


def _is_placement(x) -> bool:
    """A ``(DeviceMesh, placements)`` pair (or a bare mesh: replicated)."""
    return _is_mesh(x) or (isinstance(x, tuple) and len(x) == 2 and _is_mesh(x[0]))


def _put(x, dev):
    if dev is None:
        return x
    if isinstance(x, (np.ndarray, np.generic)):
        x = torch.from_numpy(np.array(x, order="C"))
    if _is_placement(dev):
        from torch.distributed.tensor import Replicate, distribute_tensor

        mesh, placements = (dev, None) if _is_mesh(dev) else dev
        if placements is None:
            placements = [Replicate()] * mesh.ndim
        if not isinstance(x, torch.Tensor):
            return x
        return distribute_tensor(x.to(mesh.device_type), mesh, list(placements),
                                 src_data_rank=None)
    if not isinstance(dev, (str, torch.device)):
        raise TypeError(f"a placement is a device, a DeviceMesh, (mesh, placements) "
                        f"or None, not {type(dev).__name__}")
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def reshard_state(host_state, devices):
    """``host_state``: a tree of numpy arrays (or tensors); ``devices``: one
    placement for every leaf, or a matching tree of them.  A placement is a
    ``torch.device`` (or its name), a ``DeviceMesh`` (the leaf replicated
    over it), a ``(DeviceMesh, placements)`` pair (``Shard``/``Replicate``
    per mesh dim: the leaf becomes a ``DTensor``) or ``None`` (the leaf
    stays where it is).  A rank outside a mesh gets a ``DTensor`` with an
    empty local tensor, as ``distribute_tensor`` gives it.  Returns the
    placed tree."""
    leaves, spec = tree_flatten(host_state)
    if not isinstance(devices, (dict, tuple, list)) or _is_placement(devices):
        targets = [devices] * len(leaves)  # one placement for every leaf
    else:
        targets = _placements(devices)
        if len(targets) != len(leaves):
            raise ValueError(f"{len(targets)} placements for {len(leaves)} leaves")
    return tree_unflatten(spec, [_put(x, d) for x, d in zip(leaves, targets)])


def _placements(tree) -> list:
    """The leaves of a placement tree, a ``(mesh, placements)`` pair being
    one leaf."""
    if _is_placement(tree) or tree is None or not isinstance(tree, (dict, tuple, list)):
        return [tree]
    if isinstance(tree, dict):
        return [p for key in sorted(tree) for p in _placements(tree[key])]
    return [p for x in tree for p in _placements(x)]
