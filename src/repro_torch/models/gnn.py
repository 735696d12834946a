"""GCN on the segment-aggregation substrate (port of the GCN part of
``repro.models.gnn``).

Message passing is a gather of source rows, a per-edge weight and a sum
into destination rows over the same edge list S5P partitions; every such
sum here is K5 (:func:`repro_torch.kernels.segment_agg.segment_agg`): the
degree counts (a ``(V, 1)`` table of ones, weights = the edge mask), the
forward aggregation into ``edge_dst`` and the reverse one into
``edge_src``.  :func:`gcn_norm` lays the edges out once by destination and
once by source, and both layers reuse the two layouts: six K5 launches per
forward.  The arithmetic is the reference's (``models/gnn.py:84-120``);
the edge weight is ``inv_sqrt[src]·inv_sqrt[dst]·mask``, formed in that
order.  The layers' ``x @ W`` is a plain matrix product (cuBLAS on the
card, in full float32 unless the caller enables TF32).  SchNet, EGNN and
DimeNet are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from .. import random as jrandom
from .._device import resolve_device
from ..kernels.segment_agg import SegmentLayout, segment_agg, segment_layout
from .common import dense_init, softmax_xent

__all__ = ["GCNConfig", "GCNNorm", "gcn_init", "gcn_norm", "gcn_layer",
           "gcn_forward", "gcn_loss"]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 7
    dtype: Any = torch.float32


def gcn_init(cfg: GCNConfig, key, device=None) -> dict:
    """``{"layers": [{"w": (d_in, d_out)}, ...]}`` from a ``repro_torch.random``
    key, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    ks = jrandom.split(key, cfg.n_layers)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"layers": [{"w": dense_init(ks[i], (dims[i], dims[i + 1]), dtype=cfg.dtype,
                                        device=dev)}
                       for i in range(cfg.n_layers)]}


class GCNNorm(NamedTuple):
    """The symmetric normalisation of one edge list, built once per forward."""

    fwd: SegmentLayout  # by edge_dst, weights inv_sqrt[src]·inv_sqrt[dst]·mask
    rev: SegmentLayout  # by edge_src, the same weights
    inv_sqrt: torch.Tensor  # (V,) deg^-1/2, deg = in + out + 1 (self loop)


def gcn_norm(edge_src, edge_dst, n_nodes: int, dtype=torch.float32, edge_mask=None,
             *, device=None) -> GCNNorm:
    dev = resolve_device(device)
    src = torch.as_tensor(edge_src).to(dev, torch.int32)
    dst = torch.as_tensor(edge_dst).to(dev, torch.int32)
    fwd = segment_layout(src, dst, n_nodes, device=dev)
    rev = segment_layout(dst, src, n_nodes, device=dev)
    ones = torch.ones(src.shape, dtype=dtype, device=dev)
    if edge_mask is not None:
        ones = ones * torch.as_tensor(edge_mask).to(dev, dtype)
    table = torch.ones((n_nodes, 1), dtype=dtype, device=dev)
    deg = (segment_agg(table, fwd.with_weights(ones))[:, 0]
           + segment_agg(table, rev.with_weights(ones))[:, 0] + 1.0)
    inv_sqrt = torch.rsqrt(deg)
    w = inv_sqrt[src.long()] * inv_sqrt[dst.long()]
    if edge_mask is not None:
        w = w * torch.as_tensor(edge_mask).to(dev, dtype)
    return GCNNorm(fwd.with_weights(w), rev.with_weights(w), inv_sqrt)


def gcn_layer(x: torch.Tensor, norm: GCNNorm) -> torch.Tensor:
    """``Â x`` for ``x = h @ W``: both directions of every edge plus the
    normalised self loop (two K5 launches)."""
    agg = segment_agg(x, norm.fwd) + segment_agg(x, norm.rev)
    return agg + x * norm.inv_sqrt[:, None] ** 2


def gcn_forward(params, feats, edge_src, edge_dst, n_nodes: int, cfg: GCNConfig,
                edge_mask=None, *, device=None) -> torch.Tensor:
    """Symmetric-normalised GCN, ``H' = D^-½ Ã D^-½ H W`` (self loops
    included), on ``device`` (default ``cuda``): (n_nodes, n_classes)."""
    dev = resolve_device(device)
    norm = gcn_norm(edge_src, edge_dst, n_nodes, cfg.dtype, edge_mask, device=dev)
    x = torch.as_tensor(feats).to(dev, cfg.dtype)
    layers = params["layers"]
    for i, layer in enumerate(layers):
        x = gcn_layer(x @ layer["w"].to(dev), norm)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def gcn_loss(params, batch, cfg: GCNConfig, *, device=None):
    """Mean cross-entropy of :func:`gcn_forward` over ``batch["labels"]``
    (masked by ``batch["label_mask"]`` when present), and ``{}``."""
    dev = resolve_device(device)
    logits = gcn_forward(params, batch["feats"], batch["edge_src"], batch["edge_dst"],
                         int(batch["feats"].shape[0]), cfg, batch.get("edge_mask"),
                         device=dev)
    labels = torch.as_tensor(batch["labels"]).to(dev)
    mask = batch.get("label_mask")
    if mask is not None:
        mask = torch.as_tensor(mask).to(dev)
    return softmax_xent(logits, labels, mask), {}
