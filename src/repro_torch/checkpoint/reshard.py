"""Restart placement: put a host checkpoint's leaves onto a device.

Checkpoints hold full (unsharded) host arrays, so placement is all a
restart needs on one card: each leaf becomes a tensor on its target
``torch.device``.  Sharding a tree over a mesh waits for multi-device S5P
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from ..streaming.carry import tree_flatten, tree_unflatten

__all__ = ["reshard_state"]


def _put(x, dev):
    if dev is None:
        return x
    if not isinstance(dev, (str, torch.device)):
        raise NotImplementedError(
            "placing a checkpoint onto a mesh or a sharding tree waits for "
            "multi-device S5P, ROADMAP Queue 1 item 7")
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.asarray(x, order="C")).to(dev)
    return x


def reshard_state(host_state, devices):
    """``host_state``: a tree of numpy arrays (or tensors); ``devices``: one
    ``torch.device`` (or name) for every leaf, a matching tree of them, or
    ``None`` (leaves stay where they are).  Returns the placed tree.  Any
    other placement (a mesh, a sharding) raises."""
    leaves, spec = tree_flatten(host_state)
    if not isinstance(devices, (dict, tuple, list)):  # one target for all
        targets = [devices] * len(leaves)
    else:
        targets, _ = tree_flatten(devices)
        if len(targets) != len(leaves):
            raise ValueError(f"{len(targets)} placements for {len(leaves)} leaves")
    return tree_unflatten(spec, [_put(x, d) for x, d in zip(leaves, targets)])
