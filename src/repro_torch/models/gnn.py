"""The GNN architectures on the segment-aggregation substrate (port of
``repro.models.gnn``): GCN, SchNet, EGNN and DimeNet.

Message passing is a gather of source rows, a per-edge factor and a sum
into destination rows over the same edge list S5P partitions; every such
sum here is K5 (:func:`repro_torch.kernels.segment_agg.segment_agg`).

**GCN** (``models/gnn.py:84-120`` of the reference): the degree counts (a
``(V, 1)`` table of ones, weights = the edge mask), the forward
aggregation into ``edge_dst`` and the reverse one into ``edge_src``.
:func:`gcn_norm` lays the edges out once by destination and once by
source, and both layers reuse the two layouts: six K5 launches per
forward.  The edge weight is ``inv_sqrt[src]·inv_sqrt[dst]·mask``, formed
in that order.

**SchNet, EGNN, DimeNet** (``:125-423``): their messages carry a factor per
channel, which K5's one weight an edge cannot hold, so each message tensor
is formed first and summed through a layout whose source is
``arange(rows)`` and whose weights are 1 (:func:`message_layout`; each
product ``x·1`` is exact, so each sum is the reference's
``jax.ops.segment_sum``, edge order from zero, bit for bit).  The layouts
are built once per forward and reused by every layer: messages into nodes
by ``edge_dst``, DimeNet's triplets into edges by ``tri_ji``, the
per-graph pooling by ``graph_idx``.  Masked messages (zeros) stay in the
sums, as in the reference.  K5 launches per forward, with ``graph_idx``
given (one fewer without it, where the pool is ``_fp32.xla_sum_f32``, the
order of XLA's CPU ``jnp.sum``):

- SchNet: ``n_interactions`` + 1 (3 + 1 at the published config);
- EGNN: 1 + 2·``n_layers`` + 1 (10): the edge counts ``cnt`` once (the
  same bits every layer), then ``dx`` (d = 3) and ``agg`` a layer;
- DimeNet: 2·``n_blocks`` + 1 (13): triplets into edges and edges into
  nodes a block.

The float forms follow the reference's: the RBF centres as
``jnp.linspace`` builds them, ``norm(Δ + 1e-9)`` with the 1e-9 on every
component, ``(n·π)·dn`` and the raw ``d`` in the Bessel basis, the
clipped ``arccos``.  The transcendental functions (``exp``, ``cos``,
``softplus``, ``silu``, ``arccos``) and the matrix products are PyTorch's,
an ulp or so from XLA's: the CPU tests state the tolerance.  DimeNet's
``einsum("tb,bdf,td->tf")`` is ``Σ_b sb[:, b]·(src_t @ bilinear[b])``,
keeping one (T, d) product alive.  The layers' products are plain matrix
products (cuBLAS on the card, in full float32 unless the caller enables
TF32).  Large tensors are updated in place where the reference's value
is the same, so SchNet at 29.4 M edges keeps one (E, 300) basis and two
(E, 64) buffers alive.  The reference's ``constrain`` calls are sharding
hints with no counterpart on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as jrandom
from .._device import resolve_device
from .._fp32 import xla_sum_f32
from ..kernels.segment_agg import SegmentLayout, segment_agg, segment_layout
from .common import dense_init, softmax_xent

__all__ = ["GCNConfig", "GCNNorm", "gcn_init", "gcn_norm", "gcn_layer",
           "gcn_forward", "gcn_loss", "SchNetConfig", "schnet_init", "schnet_forward",
           "schnet_loss", "EGNNConfig", "egnn_init", "egnn_forward", "egnn_loss",
           "DimeNetConfig", "dimenet_init", "dimenet_forward", "dimenet_loss",
           "build_triplets", "message_layout"]


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


# ---------------------------------------------------------------------------
# The message sums of SchNet, EGNN and DimeNet, and the shared MLP
# ---------------------------------------------------------------------------


def message_layout(idx, n_rows: int, *, device=None) -> SegmentLayout:
    """K5's layout that sums message ``e`` (row ``e`` of a message tensor)
    into row ``idx[e]``: source ``arange(len(idx))``, weights 1."""
    dev = resolve_device(device)
    idx = torch.as_tensor(idx).to(dev, torch.int32)
    rows = torch.arange(idx.numel(), dtype=torch.int32, device=dev)
    return segment_layout(rows, idx, n_rows, device=dev)


def _seg_sum(x: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """``jax.ops.segment_sum(x, idx, n)`` for the ``idx`` of ``layout``: one
    K5 launch (a vector is summed as one column)."""
    if x.dim() == 1:
        return segment_agg(x[:, None], layout)[:, 0]
    return segment_agg(x, layout)


def _pool(e_atom: torch.Tensor, graph_idx, n_graphs: int, dev) -> torch.Tensor:
    """Per-graph energies: K5 by ``graph_idx``, or the whole sum (shape (1,))
    in the order of XLA's CPU ``jnp.sum`` without it."""
    if graph_idx is None:
        return xla_sum_f32(e_atom).reshape(1)
    return _seg_sum(e_atom, message_layout(graph_idx, int(n_graphs), device=dev))


def _mlp_init(key, dims, dtype, device) -> list[dict]:
    ks = jrandom.split(key, len(dims) - 1)
    return [{"w": dense_init(ks[i], (dims[i], dims[i + 1]), dtype=dtype, device=device),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=device)}
            for i in range(len(dims) - 1)]


def _mlp_apply(layers, x: torch.Tensor, act=F.silu, final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"]
        x += layer["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def _ints(x, dev) -> torch.Tensor:
    return torch.as_tensor(x).to(dev, torch.int64)


def _floats(x, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x).to(dev, dtype)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of a float32 vector: XLA's CPU sum order, then ÷ n."""
    return xla_sum_f32(x) / x.numel()


def _regression_loss(pred: torch.Tensor, targets) -> tuple[torch.Tensor, dict]:
    err = pred - _floats(targets, pred.device)
    return _mean(torch.square(err)), {"mae": _mean(torch.abs(err))}


def _norm(v: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(v, axis=-1)``: on the CPU ``torch.linalg.vector_norm``
    gives XLA's bits for (n, 3) float32 rows."""
    return torch.linalg.vector_norm(v, dim=-1)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(v, axis=-1)`` of (n, 3) rows: XLA adds them in order."""
    return (v[:, 0] + v[:, 1]) + v[:, 2]


# ---------------------------------------------------------------------------
# SchNet (n_interactions=3, d_hidden=64, rbf=300, cutoff=10)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100
    dtype: Any = torch.float32


def schnet_init(cfg: SchNetConfig, key, device=None) -> dict:
    """The reference's tree from a ``repro_torch.random`` key (``2 + 3n``
    keys), on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    ks = jrandom.split(key, 2 + 3 * cfg.n_interactions)
    d = cfg.d_hidden
    params = {
        "embed": dense_init(ks[0], (cfg.n_species, d), scale=1.0, dtype=cfg.dtype, device=dev),
        "inter": [],
        "out": _mlp_init(ks[1], [d, d // 2, 1], cfg.dtype, dev),
    }
    for i in range(cfg.n_interactions):
        params["inter"].append({
            "filter": _mlp_init(ks[2 + 3 * i], [cfg.n_rbf, d, d], cfg.dtype, dev),
            "in_w": dense_init(ks[3 + 3 * i], (d, d), dtype=cfg.dtype, device=dev),
            "post": _mlp_init(ks[4 + 3 * i], [d, d, d], cfg.dtype, dev),
        })
    return params


def _linspace_f32(stop: float, num: int, dev) -> torch.Tensor:
    """``jnp.linspace(0, stop, num, dtype=float32)`` as XLA compiles it:
    ``iota·(stop·r)`` with ``r = 1/(num − 1)`` rounded to float32 (the
    division folded into a reciprocal, ``0·(1 − s)`` adding nothing), then
    ``stop`` itself.  ``torch.linspace`` fills its upper half backwards
    from the end, another set of bits."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=dev)
    f32 = np.float32
    c = f32(stop) * (f32(1.0) / f32(num - 1))
    iota = torch.arange(num - 1, dtype=torch.float32, device=dev)
    return torch.cat([iota * float(c), torch.full((1,), stop, dtype=torch.float32, device=dev)])


def _rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """``exp(−γ·(d − c)²)``, γ = 10 / cutoff, over ``n_rbf`` centres on
    [0, cutoff]: one (E, n_rbf) buffer, updated in place."""
    centers = _linspace_f32(cutoff, n_rbf, dist.device)
    gamma = 10.0 / cutoff
    out = dist[:, None] - centers
    out.square_()
    out.mul_(-gamma)
    return out.exp_()


_LOG2 = float(np.log(np.float32(2.0)))  # jnp.log(2.0) in float32


def _ssp(x: torch.Tensor) -> torch.Tensor:
    """Shifted softplus, SchNet's activation: ``softplus(x) − log 2``."""
    return F.softplus(x).sub_(_LOG2)


def schnet_forward(params, species, positions, edge_src, edge_dst, n_nodes: int,
                   cfg: SchNetConfig, edge_mask=None, node_mask=None, graph_idx=None,
                   n_graphs: int = 1, *, device=None) -> torch.Tensor:
    """Energy prediction, (n_graphs,) (or (1,) without ``graph_idx``), on
    ``device`` (default ``cuda``): ``n_interactions`` K5 launches into the
    nodes, one more for the pool."""
    dev = resolve_device(device)
    src, dst = _ints(edge_src, dev), _ints(edge_dst, dev)
    pos = _floats(positions, dev)
    into_nodes = message_layout(dst, n_nodes, device=dev)
    x = params["embed"][_ints(species, dev)]
    d = _norm(pos[src] - pos[dst] + 1e-9)
    rbf = _rbf_expand(d, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
    cosc = 0.5 * (torch.cos(math.pi * d / cfg.cutoff) + 1.0)  # smooth cutoff
    cosc = torch.where(d <= cfg.cutoff, cosc, 0.0).to(cfg.dtype)
    del d
    if edge_mask is not None:
        cosc = cosc * _floats(edge_mask, dev, cfg.dtype)
    for blk in params["inter"]:
        w_ij = _mlp_apply(blk["filter"], rbf, act=_ssp)
        w_ij *= cosc[:, None]
        msg = (x @ blk["in_w"])[src]
        msg *= w_ij
        del w_ij
        agg = _seg_sum(msg, into_nodes)
        del msg
        x = x + _mlp_apply(blk["post"], agg, act=_ssp)
    del rbf
    e_atom = _mlp_apply(params["out"], x, act=_ssp)[:, 0]
    if node_mask is not None:
        e_atom = e_atom * _floats(node_mask, dev, e_atom.dtype)
    return _pool(e_atom, graph_idx, n_graphs, dev)


def schnet_loss(params, batch, cfg: SchNetConfig, *, device=None):
    """Mean squared error of :func:`schnet_forward` against
    ``batch["targets"]``, and ``{"mae": ...}``."""
    pred = schnet_forward(
        params, batch["species"], batch["positions"], batch["edge_src"],
        batch["edge_dst"], int(batch["species"].shape[0]), cfg,
        batch.get("edge_mask"), batch.get("node_mask"),
        batch.get("graph_idx"), batch.get("n_graphs", 1), device=device)
    return _regression_loss(pred, batch["targets"])


# ---------------------------------------------------------------------------
# EGNN (n_layers=4, d_hidden=64, E(n)-equivariant)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    n_layers: int = 4
    d_hidden: int = 64
    n_species: int = 100
    dtype: Any = torch.float32


def egnn_init(cfg: EGNNConfig, key, device=None) -> dict:
    """The reference's tree (``1 + 4n`` keys, the output MLP from the last),
    on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    ks = jrandom.split(key, 1 + 4 * cfg.n_layers)
    d = cfg.d_hidden
    params = {
        "embed": dense_init(ks[0], (cfg.n_species, d), scale=1.0, dtype=cfg.dtype, device=dev),
        "layers": [],
        "out": _mlp_init(ks[-1], [d, d, 1], cfg.dtype, dev),
    }
    for i in range(cfg.n_layers):
        params["layers"].append({
            "phi_e": _mlp_init(ks[1 + 4 * i], [2 * d + 1, d, d], cfg.dtype, dev),
            "phi_x": _mlp_init(ks[2 + 4 * i], [d, d, 1], cfg.dtype, dev),
            "phi_h": _mlp_init(ks[3 + 4 * i], [2 * d, d, d], cfg.dtype, dev),
        })
    return params


def egnn_forward(params, species, positions, edge_src, edge_dst, n_nodes: int,
                 cfg: EGNNConfig, edge_mask=None, node_mask=None, graph_idx=None,
                 n_graphs: int = 1, *, device=None) -> torch.Tensor:
    """Energy prediction, (n_graphs,) (or (1,)), on ``device`` (default
    ``cuda``): K5 once for the edge counts, twice a layer (``dx``, d = 3;
    ``agg``, d = ``d_hidden``), once for the pool."""
    dev = resolve_device(device)
    src, dst = _ints(edge_src, dev), _ints(edge_dst, dev)
    into_nodes = message_layout(dst, n_nodes, device=dev)
    h = params["embed"][_ints(species, dev)]
    x = _floats(positions, dev)
    mask = None if edge_mask is None else _floats(edge_mask, dev)
    ones = mask if mask is not None else torch.ones(src.shape, dtype=torch.float32,
                                                    device=dev)
    # C = 1/deg normalisation; the mask is fixed, so the counts are the same
    # bits in every layer
    cnt = _seg_sum(ones, into_nodes) + 1.0
    for blk in params["layers"]:
        diff = x[src] - x[dst]
        d2 = _sum3(torch.square(diff))[:, None]
        m = _mlp_apply(blk["phi_e"], torch.cat([h[src], h[dst], d2.to(cfg.dtype)], dim=-1),
                       final_act=True)
        if mask is not None:
            m *= mask.to(m.dtype)[:, None]
        coef = _mlp_apply(blk["phi_x"], m)  # (E, 1)
        diff *= coef.to(torch.float32)
        dx = _seg_sum(diff, into_nodes)
        del diff
        x = x + dx / cnt[:, None]
        agg = _seg_sum(m, into_nodes)
        del m
        h = h + _mlp_apply(blk["phi_h"], torch.cat([h, agg], dim=-1))
    e_atom = _mlp_apply(params["out"], h)[:, 0]
    if node_mask is not None:
        e_atom = e_atom * _floats(node_mask, dev, e_atom.dtype)
    return _pool(e_atom, graph_idx, n_graphs, dev)


def egnn_loss(params, batch, cfg: EGNNConfig, *, device=None):
    pred = egnn_forward(
        params, batch["species"], batch["positions"], batch["edge_src"],
        batch["edge_dst"], int(batch["species"].shape[0]), cfg,
        batch.get("edge_mask"), batch.get("node_mask"),
        batch.get("graph_idx"), batch.get("n_graphs", 1), device=device)
    return _regression_loss(pred, batch["targets"])


# ---------------------------------------------------------------------------
# DimeNet (n_blocks=6, d_hidden=128, bilinear=8, spherical=7, radial=6)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 100
    dtype: Any = torch.float32


def dimenet_init(cfg: DimeNetConfig, key, device=None) -> dict:
    """The reference's tree (``4 + 5n`` keys, every fifth unused), on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    ks = jrandom.split(key, 4 + 5 * cfg.n_blocks)
    d = cfg.d_hidden
    params = {
        "embed": dense_init(ks[0], (cfg.n_species, d), scale=1.0, dtype=cfg.dtype, device=dev),
        "rbf_w": dense_init(ks[1], (cfg.n_radial, d), dtype=cfg.dtype, device=dev),
        "edge_mlp": _mlp_init(ks[2], [3 * d, d], cfg.dtype, dev),
        "blocks": [],
        "out": _mlp_init(ks[3], [d, d, 1], cfg.dtype, dev),
    }
    nsph = cfg.n_spherical * cfg.n_radial
    for i in range(cfg.n_blocks):
        params["blocks"].append({
            "w_src": dense_init(ks[4 + 5 * i], (d, d), dtype=cfg.dtype, device=dev),
            "sbf_w": dense_init(ks[5 + 5 * i], (nsph, cfg.n_bilinear), dtype=cfg.dtype,
                                device=dev),
            "bilinear": dense_init(ks[6 + 5 * i], (cfg.n_bilinear, d, d), scale=0.1,
                                   dtype=cfg.dtype, device=dev),
            "post": _mlp_init(ks[7 + 5 * i], [d, d, d], cfg.dtype, dev),
        })
    return params


def _bessel_rbf(d: torch.Tensor, n_radial: int, cutoff: float) -> torch.Tensor:
    """DimeNet's spherical Bessel radial basis ``√(2/c)·sin((n·π)·dn) / d``,
    ``dn = max(d, 1e-6) / c``, divided by the raw ``d``."""
    dn = torch.clamp_min(d, 1e-6) / cutoff
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    scale = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=torch.float32, device=d.device))
    return scale * torch.sin((n * math.pi) * dn[:, None]) / d[:, None]


def _angular_sbf(angle: torch.Tensor, d: torch.Tensor, n_spherical: int, n_radial: int,
                 cutoff: float) -> torch.Tensor:
    """``cos((l + 1)·θ) ⊗ Bessel_n(d)``, (T, n_spherical·n_radial), ``l`` outer."""
    ell = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    ang = torch.cos(angle[:, None] * (ell + 1.0))  # (T, n_sph)
    rad = _bessel_rbf(d, n_radial, cutoff)  # (T, n_rad)
    return (ang[:, :, None] * rad[:, None, :]).reshape(angle.shape[0], -1)


def _bilinear(sb: torch.Tensor, bilinear: torch.Tensor, src_t: torch.Tensor) -> torch.Tensor:
    """``einsum("tb,bdf,td->tf")`` as ``Σ_b sb[:, b]·(src_t @ bilinear[b])``:
    one (T, d) product alive at a time, never a (T, b·d) one."""
    out = None
    for b in range(bilinear.shape[0]):
        y = src_t @ bilinear[b]
        y *= sb[:, b:b + 1]
        if out is None:
            out = y
        else:
            out += y
    return out


def dimenet_forward(params, species, positions, edge_src, edge_dst, tri_kj, tri_ji,
                    n_nodes: int, cfg: DimeNetConfig, edge_mask=None, tri_mask=None,
                    node_mask=None, graph_idx=None, n_graphs: int = 1, *,
                    device=None) -> torch.Tensor:
    """Directional message passing on the directed edges ``m_ji``, with the
    triplets ``(tri_kj, tri_ji)`` that share vertex j; energies (n_graphs,)
    (or (1,)), on ``device`` (default ``cuda``): K5 twice a block
    (triplets into edges by ``tri_ji``, edges into nodes), once for the
    pool."""
    dev = resolve_device(device)
    src, dst = _ints(edge_src, dev), _ints(edge_dst, dev)
    kj, ji = _ints(tri_kj, dev), _ints(tri_ji, dev)
    pos = _floats(positions, dev)
    E = int(src.shape[0])
    into_nodes = message_layout(dst, n_nodes, device=dev)
    into_edges = message_layout(ji, E, device=dev)
    vec = pos[src] - pos[dst]
    d = _norm(vec + 1e-9)
    rbf = _bessel_rbf(d, cfg.n_radial, cfg.cutoff).to(cfg.dtype)
    # triplet geometry: angle between edge kj and ji at shared vertex j
    v1 = vec[kj]
    v2 = -vec[ji]
    cosang = _sum3(v1 * v2) / (_norm(v1 + 1e-9) * _norm(v2 + 1e-9))
    del v1, v2
    angle = torch.arccos(torch.clamp(cosang, -1.0 + 1e-6, 1.0 - 1e-6))
    sbf = _angular_sbf(angle, d[kj], cfg.n_spherical, cfg.n_radial, cfg.cutoff).to(cfg.dtype)
    if tri_mask is not None:
        sbf *= _floats(tri_mask, dev, cfg.dtype)[:, None]

    h = params["embed"][_ints(species, dev)]
    rbf_d = rbf @ params["rbf_w"]
    m = _mlp_apply(params["edge_mlp"], torch.cat([h[src], h[dst], rbf_d], dim=-1),
                   final_act=True)
    mask = None if edge_mask is None else _floats(edge_mask, dev, cfg.dtype)[:, None]
    if mask is not None:
        m *= mask

    out_e = torch.zeros((n_nodes, cfg.d_hidden), dtype=cfg.dtype, device=dev)
    for blk in params["blocks"]:
        # directional aggregation: m_ji ← Σ_k sbf·W[m_kj] (bilinear form)
        src_t = (m @ blk["w_src"])[kj]  # (T, d)
        sb = sbf @ blk["sbf_w"]  # (T, n_bilinear)
        inter = _bilinear(sb, blk["bilinear"], src_t)
        del src_t
        agg = _seg_sum(inter, into_edges)
        del inter
        m = m + _mlp_apply(blk["post"], agg, final_act=True)
        if mask is not None:
            m *= mask
        out_e = out_e + _seg_sum(rbf_d * m, into_nodes)

    e_atom = _mlp_apply(params["out"], out_e)[:, 0]
    if node_mask is not None:
        e_atom = e_atom * _floats(node_mask, dev, e_atom.dtype)
    return _pool(e_atom, graph_idx, n_graphs, dev)


def dimenet_loss(params, batch, cfg: DimeNetConfig, *, device=None):
    pred = dimenet_forward(
        params, batch["species"], batch["positions"], batch["edge_src"],
        batch["edge_dst"], batch["tri_kj"], batch["tri_ji"],
        int(batch["species"].shape[0]), cfg,
        batch.get("edge_mask"), batch.get("tri_mask"), batch.get("node_mask"),
        batch.get("graph_idx"), batch.get("n_graphs", 1), device=device)
    return _regression_loss(pred, batch["targets"])


def build_triplets(edge_src, edge_dst, max_triplets: int):
    """Host-side triplet index construction: pairs (kj, ji) sharing j.

    Returns ``(tri_kj, tri_ji, tri_mask)`` padded to ``max_triplets``
    (≥ 1): the reference's arrays bit for bit.  The reference walks edge
    ``ji`` in order and, for each, the edges ``k → j`` into its source in
    order, skipping ``k == i``, until ``max_triplets`` pairs; here that
    walk is counted and expanded in NumPy (each edge's valid pairs are its
    source's in-edges less those from its own destination, and the r-th
    valid one is found by a search over the skipped positions), so no
    loop runs per edge.
    """
    src = np.asarray(edge_src).reshape(-1)
    dst = np.asarray(edge_dst).reshape(-1)
    if max_triplets < 1:
        raise ValueError("max_triplets must be at least 1")
    E = src.size
    tri_kj = np.zeros(max_triplets, np.int32)
    tri_ji = np.zeros(max_triplets, np.int32)
    mask = np.zeros(max_triplets, np.float32)
    if E == 0:
        return tri_kj, tri_ji, mask
    _, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    sr, dr = inv[:E].astype(np.int64), inv[E:].astype(np.int64)
    U = int(inv.max()) + 1
    # in-edges of each vertex, in edge order (the reference's by_dst lists)
    order = np.argsort(dr, kind="stable")
    counts = np.bincount(dr, minlength=U)
    starts = np.cumsum(counts) - counts
    local = np.empty(E, np.int64)
    local[order] = np.arange(E) - starts[dr[order]]  # each edge's place in its list
    # the skipped in-edges (k == i) of edge ji form the group (dst j, src i)
    in_key = dr * U + sr
    by_group = np.argsort(in_key, kind="stable")
    g_keys, g_start, g_size = np.unique(in_key[by_group], return_index=True,
                                        return_counts=True)
    t = np.arange(E) - np.repeat(g_start, g_size)  # index within the group
    g_of = np.repeat(np.arange(g_keys.size), g_size)
    span = E + 1
    skipped = g_of * span + (local[by_group] - t)  # non-decreasing
    q_key = sr * U + dr
    g = np.minimum(np.searchsorted(g_keys, q_key), g_keys.size - 1)
    has = g_keys[g] == q_key
    valid = counts[sr] - np.where(has, g_size[g], 0)
    cum = np.cumsum(valid)
    if cum[-1] > max_triplets:  # the walk stops inside edge `last`
        last = int(np.searchsorted(cum, max_triplets, side="left"))
        take = valid[:last + 1].copy()
        take[last] = max_triplets - (cum[last - 1] if last else 0)
    else:
        take = valid
    n = int(take.sum())
    e_ji = np.repeat(np.arange(take.size), take)
    r = np.arange(n) - np.repeat(np.cumsum(take) - take, take)
    gq, hq = g[e_ji], has[e_ji]
    before = np.searchsorted(skipped, gq * span + r, side="right") - g_start[gq]
    p = r + np.where(hq, before, 0)
    tri_kj[:n] = order[starts[sr[e_ji]] + p]
    tri_ji[:n] = e_ji
    mask[:n] = 1.0
    return tri_kj, tri_ji, mask
