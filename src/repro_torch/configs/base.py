"""Architecture specs: ``ArchSpec`` ties a model config to its shape sets
(copied as data from ``repro.configs.base``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

__all__ = ["ArchSpec", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str  # "lm" | "gnn" | "recsys"
    config: Any
    smoke_config: Any
    shapes: Mapping[str, Mapping[str, Any]]
    skips: Mapping[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""

    def runnable_shapes(self):
        return {k: v for k, v in self.shapes.items() if k not in self.skips}


# The assigned shape sets (identical within each family).
LM_SHAPES = {
    "train_4k": dict(kind="lm_train", seq=4096, batch=256),
    "prefill_32k": dict(kind="lm_prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="lm_decode", seq=32768, batch=128),
    "long_500k": dict(kind="lm_decode", seq=524288, batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="gnn_full", n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(kind="gnn_minibatch", n_nodes=232_965,
                         n_edges=114_615_892, batch_nodes=1024, fanout=(15, 10),
                         d_feat=602),
    "ogb_products": dict(kind="gnn_full", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100),
    "molecule": dict(kind="gnn_molecule", n_nodes=30, n_edges=64, batch=128),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="rec_train", batch=65536),
    "serve_p99": dict(kind="rec_serve", batch=512),
    "serve_bulk": dict(kind="rec_serve", batch=262144),
    "retrieval_cand": dict(kind="rec_retrieval", batch=1, n_candidates=1_000_000),
}
