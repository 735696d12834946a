"""Test meshes over a ``torch.distributed`` world (the port of
``repro.launch.mesh``).

``make_test_mesh`` is a function, not a module constant, so importing
this module touches no process group.  The production meshes (256 and 512
chips) wait for the launch tools (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["make_test_mesh"]


def make_test_mesh(n_devices: int | None = None, device_type: str | None = None):
    """A ``(data, model)`` ``DeviceMesh`` over the world's first
    ``n_devices`` ranks (default: all), ``model`` 4 or 2 where that divides
    the count, else 1.  ``device_type`` defaults to the card (none raises);
    pass ``"cpu"`` for CPU ranks.  Every rank of the world calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    n = n_devices or dist.get_world_size()
    model = 1
    for m in (4, 2):
        if n % m == 0 and n >= m:
            model = m
            break
    if device_type is None:
        device_type = resolve_device(None).type
    ranks = torch.arange(n).reshape(n // model, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))
