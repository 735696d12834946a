"""xDeepFM: sparse embeddings + CIN feature interaction + deep MLP (port of
``repro.models.recsys``).

[Lian et al., arXiv:1803.05170]  Published config: 39 sparse fields,
embed_dim 10, CIN 200-200-200, MLP 400-400.

- :func:`embedding_lookup` — one row gather per field (``index_select``);
- :func:`embedding_bag` — multi-hot ragged bags (sum/mean) from
  ``searchsorted`` + ``index_add_``, ``torch.nn.EmbeddingBag``'s semantics;
- :func:`s5p_row_placement` — S5P over the (sample × feature-row) access
  graph places embedding rows on shards, replicating the hot ones.

Every CIN layer goes through :func:`repro_torch.kernels.cin.cin_layer_kernel`:
on the card it *is* K7, on the CPU its plain version; there is no switch to
the plain version on the card.  The reference's ``sharding.constrain``
calls have no counterpart: on one device they are no-ops
(``repro/sharding.py:106-112``), and no sharding module is ported.
Parameters are the reference's tree as plain lists and dicts of tensors;
every entry point runs on ``device`` (default ``cuda``, raising without a
card).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import random as jrandom
from .._device import resolve_device
from ..kernels.cin import cin_layer_kernel
from .common import dense_init

__all__ = ["XDeepFMConfig", "xdeepfm_init", "xdeepfm_forward", "xdeepfm_loss",
           "embedding_lookup", "embedding_bag", "s5p_row_placement",
           "retrieval_scores"]


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    n_fields: int = 39
    embed_dim: int = 10
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_dims: tuple[int, ...] = (400, 400)
    # heterogeneous vocab sizes: a few huge fields + many small (Criteo-like)
    field_vocabs: tuple[int, ...] = ()
    dtype: Any = torch.float32

    def vocabs(self) -> tuple[int, ...]:
        # powers of two so row-sharded tables divide any mesh axis exactly
        if self.field_vocabs:
            return self.field_vocabs
        out = []
        for i in range(self.n_fields):
            if i % 13 == 0:
                out.append(1_048_576)
            elif i % 5 == 0:
                out.append(131_072)
            elif i % 3 == 0:
                out.append(16_384)
            else:
                out.append(1_024)
        return tuple(out)


# ---------------------------------------------------------------------------
# embedding substrate
# ---------------------------------------------------------------------------


def embedding_lookup(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Row gather: ``table[indices]``."""
    return torch.index_select(table, 0, indices)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, offsets: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` semantics by gather + ``index_add_``.

    indices: (N,) flat row ids; offsets: (B,) bag starts.  Returns (B, D).
    An empty bag gives zeros; ``mode="mean"`` divides by ``max(size, 1)``.
    Indices before ``offsets[0]`` belong to no bag and are dropped, as the
    reference's ``segment_sum`` drops them."""
    n = indices.shape[0]
    B = offsets.shape[0]
    pos = torch.arange(n, dtype=offsets.dtype, device=offsets.device)
    bag_ids = torch.searchsorted(offsets, pos, right=True) - 1
    keep = bag_ids >= 0
    bag_ids, rows = bag_ids[keep], embedding_lookup(table, indices[keep])
    out = torch.zeros((B, table.shape[1]), dtype=table.dtype, device=table.device)
    out.index_add_(0, bag_ids, rows)
    if mode == "mean":
        sizes = torch.zeros((B,), dtype=table.dtype, device=table.device)
        sizes.index_add_(0, bag_ids, torch.ones_like(bag_ids, dtype=table.dtype))
        out = out / torch.clamp(sizes, min=1.0)[:, None]
    return out


def s5p_row_placement(access_rows: np.ndarray, access_samples: np.ndarray,
                      n_rows: int, k: int, *, device=None, **s5p_kwargs):
    """Place embedding rows on k shards with S5P over the bipartite access
    graph (samples ∪ rows), on ``device`` (default ``cuda``).  Returns
    numpy ``(row_shard (n_rows,) int32, replica_mask (n_rows, k) bool)`` —
    head (hot) rows come back replicated on several shards."""
    from ..core.metrics import replica_matrix
    from ..core.s5p import S5PConfig, s5p_partition

    dev = resolve_device(device)
    n_samples = int(access_samples.max()) + 1 if access_samples.size else 1
    src = np.asarray(access_samples, np.int64)
    dst = np.asarray(access_rows, np.int64) + n_samples  # rows after samples
    cfg = S5PConfig(k=k, **s5p_kwargs)
    out = s5p_partition(src.astype(np.int32), dst.astype(np.int32),
                        n_samples + n_rows, cfg, device=dev)
    mat = replica_matrix(torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev),
                         out.parts, n_vertices=n_samples + n_rows, k=k)
    mat = mat.cpu().numpy()[n_samples:]
    shard = np.where(mat.any(1), mat.argmax(1), np.arange(n_rows) % k)
    return shard.astype(np.int32), mat


# ---------------------------------------------------------------------------
# xDeepFM
# ---------------------------------------------------------------------------


def xdeepfm_init(cfg: XDeepFMConfig, key, device=None) -> dict:
    """The reference's parameter tree from a ``repro_torch.random`` key, on
    ``device`` (default ``cuda``): ``tables``, ``lin_tables`` (zeros),
    ``cin``, ``cin_out``, ``mlp`` (``w``, zero ``b``), ``mlp_out``, ``bias``."""
    dev = resolve_device(device)
    vocabs = cfg.vocabs()
    ks = jrandom.split(key, len(vocabs) + len(cfg.cin_layers) + len(cfg.mlp_dims) + 4)
    D, m = cfg.embed_dim, cfg.n_fields

    def init(k, shape, scale=None):
        return dense_init(k, shape, scale=scale, dtype=cfg.dtype, device=dev)

    tables = [init(ks[i], (v, D), scale=0.01) for i, v in enumerate(vocabs)]
    lin_tables = [torch.zeros((v, 1), dtype=cfg.dtype, device=dev) for v in vocabs]
    j = len(vocabs)
    cin = []
    h_prev = m
    for h in cfg.cin_layers:
        cin.append(init(ks[j], (h_prev * m, h), scale=0.1))
        h_prev = h
        j += 1
    mlp = []
    d_in = m * D
    for d_out in cfg.mlp_dims:
        mlp.append({"w": init(ks[j], (d_in, d_out)),
                    "b": torch.zeros((d_out,), dtype=cfg.dtype, device=dev)})
        d_in = d_out
        j += 1
    return {
        "tables": tables,
        "lin_tables": lin_tables,
        "cin": cin,
        "cin_out": init(ks[j], (sum(cfg.cin_layers), 1)),
        "mlp": mlp,
        "mlp_out": init(ks[j + 1], (d_in, 1)),
        "bias": torch.zeros((1,), dtype=cfg.dtype, device=dev),
    }


def _cin_layer(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One CIN layer: z = outer(x_k, x_0) along fields, 1×1-conv compress.

    x_k: (B, Hk, D); x_0: (B, m, D); w: (Hk·m, H') → (B, H', D): K7 on
    the card, its plain version on the CPU."""
    return cin_layer_kernel(x_k, x_0, w)


def xdeepfm_forward(params: dict, field_ids: torch.Tensor, cfg: XDeepFMConfig,
                    pools: list | None = None) -> torch.Tensor:
    """field_ids: (B, n_fields) int32 per-field row indices on the
    parameters' device → logits (B,).  With a ``pools`` list, each CIN
    layer's (B, H_k) sum over the embedding axis is appended to it."""
    B = field_ids.shape[0]
    embs = []
    lin = torch.zeros((B, 1), dtype=cfg.dtype, device=field_ids.device)
    for f in range(cfg.n_fields):
        embs.append(embedding_lookup(params["tables"][f], field_ids[:, f]))
        lin = lin + embedding_lookup(params["lin_tables"][f], field_ids[:, f])
    x0 = torch.stack(embs, dim=1)  # (B, m, D)

    # CIN branch
    xk = x0
    layer_pools = []
    for w in params["cin"]:
        xk = _cin_layer(xk, x0, w)
        layer_pools.append(torch.sum(xk, dim=-1))  # (B, Hk)
    if pools is not None:
        pools.extend(layer_pools)
    cin_logit = torch.cat(layer_pools, dim=-1) @ params["cin_out"]

    # deep branch
    h = x0.reshape(B, -1)
    for layer in params["mlp"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    deep_logit = h @ params["mlp_out"]

    return (lin + cin_logit + deep_logit + params["bias"])[:, 0]


def xdeepfm_loss(params: dict, batch: dict, cfg: XDeepFMConfig):
    """Mean binary log-loss of the logits against ``batch["labels"]``
    (evaluation only: K7 has no backward)."""
    logits = xdeepfm_forward(params, batch["field_ids"], cfg).float()
    y = batch["labels"].float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y +
                      torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, {"logloss": loss}


def retrieval_scores(params: dict, query_ids: torch.Tensor, cand_table: torch.Tensor,
                     cfg: XDeepFMConfig, top_k: int = 100):
    """retrieval_cand shape: each query (pooled field embeddings) scored
    against the N candidates of ``cand_table`` (N, D) by one batched dot;
    returns the ``top_k`` (values, int32 indices), largest first."""
    embs = [embedding_lookup(params["tables"][f], query_ids[:, f])
            for f in range(cfg.n_fields)]
    q = torch.mean(torch.stack(embs, dim=1), dim=1)  # (B, D)
    scores = torch.einsum("bd,nd->bn", q, cand_table)
    values, idx = torch.topk(scores, top_k, dim=-1, largest=True, sorted=True)
    return values, idx.to(torch.int32)
