"""Cell construction: (architecture × input shape) → a step on the card
(port of ``repro.launch.cells``).

A *cell* bundles what the trainers and the smoke runs need:

- ``step_fn``: the step (``train_step`` or the serve step);
- ``state_shape`` / ``batch_shape``: the state and the batch as tensors on
  the ``meta`` device (no memory), the counterpart of ``jax.eval_shape``;
- ``state_axes`` / ``batch_axes`` / ``rules``: the reference's logical
  sharding axes per leaf and per-cell overrides, carried as plain data
  (resolving them on a mesh is the sharding module's, not ported);
- ``init_state`` / ``make_batch``: the concrete state and batch from a
  ``repro_torch.random`` key, on the cell's device, with the reference's
  draws (integers and uniforms bit for bit; ``normal`` within a few ulp,
  see :mod:`repro_torch.random`);
- ``model_flops``: analytic FLOPs per step.

Two cuts, for a configuration one card cannot hold whole, default to the
reference's behaviour: ``n_layers`` (an LM's depth) and ``batch``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from .. import random as jrandom
from .._device import resolve_device
from ..configs import ArchSpec, get_arch
from ..models import gnn as G
from ..models import lm as LM
from ..models import recsys as R
from ..optim import AdamWConfig, TrainState, init_state as opt_init, make_train_step
from ..streaming.carry import tree_flatten, tree_flatten_with_paths, tree_unflatten

__all__ = ["Cell", "build_cell", "SMOKE_OVERRIDES"]

f32, i32 = torch.float32, torch.int32
META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    state_shape: Any  # tree of meta tensors
    batch_shape: tuple  # positional args after state, meta tensors
    state_axes: Any
    batch_axes: tuple
    rules: dict
    init_state: Callable[[Any], Any]
    make_batch: Callable[[Any], tuple]
    model_flops: float
    donate: tuple = ()
    out_axes: Any = None
    attn_block: Any = None  # (q_chunk, kv_chunk, d_head) of the CPU's blocked attention
    cuts: dict = dataclasses.field(default_factory=dict)  # the cuts this cell was built with


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _axes_like(tree, fn):
    """Map (path, leaf) → logical axes tuple over a tree."""
    spec = tree_flatten(tree)[1]
    return tree_unflatten(spec, [fn(p, leaf) for p, leaf in tree_flatten_with_paths(tree)])


def _meta_like(tree):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [_sds(x.shape, x.dtype) for x in leaves])


# ---------------------------------------------------------------------------
# logical axes per family
# ---------------------------------------------------------------------------


def _lm_param_axes(p: str, leaf):
    nd = len(leaf.shape)
    if "embed" in p:
        return ("mlp", "fsdp")
    if "lm_head" in p:
        return ("fsdp", "mlp")
    if any(k in p for k in ("wq", "wk", "wv")):
        return (None, "fsdp", "mlp")
    if "wo" in p:
        return (None, "mlp", "fsdp")
    if any(k in p for k in ("bq", "bk", "bv")):
        return (None, "mlp")
    if "router" in p:
        return (None, "fsdp", None)
    if any(k in p for k in ("w_gate", "w_up")):
        return (None, "expert", "fsdp", "mlp") if nd == 4 else (None, "fsdp", "mlp")
    if "w_down" in p:
        return (None, "expert", "mlp", "fsdp") if nd == 4 else (None, "mlp", "fsdp")
    return (None,) * nd


def _rec_param_axes(p: str, leaf):
    nd = len(leaf.shape)
    if "tables" in p and nd == 2:
        return ("rows", None)
    return (None,) * nd


def _replicated_axes(p: str, leaf):
    return (None,) * len(leaf.shape)


def _state_axes(params_axes) -> TrainState:
    return TrainState(params=params_axes, mu=params_axes, nu=params_axes, step=())


def opt_init_from(params_shapes) -> TrainState:
    """The ``TrainState`` of a tree of (meta) parameters, on the meta device."""
    leaves, spec = tree_flatten(params_shapes)
    zeros = tree_unflatten(spec, [_sds(p.shape, f32) for p in leaves])
    return TrainState(params=_meta_like(params_shapes), mu=zeros, nu=_meta_like(zeros),
                      step=_sds((), i32))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_cell(arch: ArchSpec, shape_name: str, shp: dict, cfg: LM.LMConfig, dev) -> Cell:
    S, B = shp["seq"], shp["batch"]
    opt = AdamWConfig()
    kind = shp["kind"]
    n_tok = B * S
    attn_block = (min(cfg.attn_chunk // 2, max(S, 8)), min(cfg.attn_chunk, max(S, 8)),
                  cfg.d_head)
    params_s = LM.init_params(cfg, jrandom.PRNGKey(0), device=META)
    p_axes = _axes_like(params_s, _lm_param_axes)

    def init_params(key):
        return LM.init_params(cfg, key, device=dev)

    if kind == "lm_train":
        step = make_train_step(functools.partial(LM.loss_fn, device=dev), cfg, opt)
        batch_s = ({"tokens": _sds((B, S), i32), "targets": _sds((B, S), i32)},)
        batch_axes = ({"tokens": ("batch", "seq"), "targets": ("batch", "seq")},)
        train_rules = {"batch": ("data", "model"), "seq": ("pod",)}

        def make_batch(key):
            t = jrandom.randint(key, (B, S), 0, cfg.vocab, dev)
            return ({"tokens": t, "targets": torch.roll(t, -1, dims=1)},)

        return Cell(
            arch=arch.name, shape=shape_name, kind=kind, step_fn=step,
            state_shape=opt_init_from(params_s), batch_shape=batch_s,
            state_axes=_state_axes(p_axes), batch_axes=batch_axes, rules=train_rules,
            init_state=lambda key: opt_init(init_params(key)), make_batch=make_batch,
            model_flops=LM.model_flops(cfg, n_tok, train=True), donate=(0,),
            attn_block=attn_block)

    serve_rules = {"fsdp": ()}  # serving: TP only, no per-layer weight gather
    if kind == "lm_prefill":
        def step(params, tokens):
            return LM.prefill(params, tokens, cfg, max_seq=S, device=dev)

        def make_batch(key):
            return (jrandom.randint(key, (B, S), 0, cfg.vocab, dev),)

        cache_out_axes = {"k": (None, "batch", "kv_seq", None, None),
                          "v": (None, "batch", "kv_seq", None, None),
                          "pos": (None, "batch", "kv_seq")}
        return Cell(
            arch=arch.name, shape=shape_name, kind=kind, step_fn=step,
            state_shape=params_s, batch_shape=(_sds((B, S), i32),), state_axes=p_axes,
            batch_axes=(("batch", None),), rules={**serve_rules, "kv_seq": ("model",)},
            init_state=init_params, make_batch=make_batch,
            model_flops=LM.model_flops(cfg, n_tok, train=False),
            out_axes=(("batch", None), cache_out_axes), attn_block=attn_block)

    # decode: one token against a seq_len cache (rolling window under SWA)
    W = min(S, cfg.sliding_window) if cfg.sliding_window else S
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.d_head

    def step(params, cache, tokens, pos):
        return LM.decode_step(params, cache, tokens, pos, cfg, device=dev)

    cache_s = {"k": _sds((L, B, W, KV, hd), cfg.dtype), "v": _sds((L, B, W, KV, hd), cfg.dtype),
               "pos": _sds((L, B, W), i32)}
    cache_axes = {"k": (None, "batch", "kv_seq", None, None),
                  "v": (None, "batch", "kv_seq", None, None), "pos": (None, "batch", "kv_seq")}
    rules = {**serve_rules, "kv_seq": ("model",)}
    if B == 1:  # long_500k: latency cell — spread the window over everything
        rules["batch"] = ()
        rules["kv_seq"] = ("pod", "data", "model")

    def make_batch(key):
        cache = LM.init_cache(cfg, B, S, device=dev)
        # pretend the cache is fully prefilled
        pos0 = torch.arange(W, dtype=i32, device=dev).expand(L, B, W)
        cache["pos"] = (pos0 + (S - W)).contiguous()
        toks = jrandom.randint(key, (B,), 0, cfg.vocab, dev)
        return (cache, toks, torch.full((B,), S, dtype=i32, device=dev))

    return Cell(
        arch=arch.name, shape=shape_name, kind=kind, step_fn=step, state_shape=params_s,
        batch_shape=(cache_s, _sds((B,), i32), _sds((B,), i32)), state_axes=p_axes,
        batch_axes=(cache_axes, ("batch",), ("batch",)), rules=rules,
        init_state=init_params, make_batch=make_batch,
        model_flops=LM.model_flops(cfg, B, train=False), donate=(1,))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

_GNN_FNS = {
    "gcn-cora": (G.gcn_init, G.gcn_loss),
    "schnet": (G.schnet_init, G.schnet_loss),
    "egnn": (G.egnn_init, G.egnn_loss),
    "dimenet": (G.dimenet_init, G.dimenet_loss),
}


def _pad512(n: int) -> int:
    """Counts padded to the reference's 512-chip multiple (the padding is
    masked, and kept here so the batches are the reference's)."""
    return -(-n // 512) * 512


def _gnn_batch_spec(arch: ArchSpec, shp: dict, cfg) -> tuple[dict, dict]:
    """(meta batch, logical axes) for one GNN shape."""
    kind, name = shp["kind"], arch.name
    if kind in ("gnn_full", "gnn_minibatch"):
        if kind == "gnn_full":
            V, E = _pad512(shp["n_nodes"]), _pad512(shp["n_edges"] // 2)
            n_tri = 2 * E
        else:
            n = max_nodes = shp["batch_nodes"]
            max_edges = 0
            for f in shp["fanout"]:
                n *= f
                max_edges += n
                max_nodes += n
            V, E = _pad512(max_nodes), _pad512(max_edges)
            n_tri = 2 * E
        b: dict[str, Any] = {"edge_src": _sds((E,), i32), "edge_dst": _sds((E,), i32),
                             "edge_mask": _sds((E,), f32), "node_mask": _sds((V,), f32)}
        a: dict[str, Any] = {"edge_src": ("edges",), "edge_dst": ("edges",),
                             "edge_mask": ("edges",), "node_mask": ("nodes",)}
        if name == "gcn-cora":
            b |= {"feats": _sds((V, shp["d_feat"]), f32), "labels": _sds((V,), i32),
                  "label_mask": _sds((V,), f32)}
            a |= {"feats": ("nodes", None), "labels": ("nodes",), "label_mask": ("nodes",)}
        else:
            b |= {"species": _sds((V,), i32), "positions": _sds((V, 3), f32),
                  "targets": _sds((1,), f32)}
            a |= {"species": ("nodes",), "positions": ("nodes", None), "targets": (None,)}
        if name == "dimenet":
            b |= {"tri_kj": _sds((n_tri,), i32), "tri_ji": _sds((n_tri,), i32),
                  "tri_mask": _sds((n_tri,), f32)}
            a |= {"tri_kj": ("edges",), "tri_ji": ("edges",), "tri_mask": ("edges",)}
        return b, a
    # molecule: batched small graphs, flattened with graph_idx
    Bm, N, Em = shp["batch"], shp["n_nodes"], shp["n_edges"]
    V, E = _pad512(Bm * N), _pad512(Bm * Em)
    b = {"edge_src": _sds((E,), i32), "edge_dst": _sds((E,), i32),
         "edge_mask": _sds((E,), f32), "node_mask": _sds((V,), f32),
         "graph_idx": _sds((V,), i32), "n_graphs": Bm}
    a = {"edge_src": ("edges",), "edge_dst": ("edges",), "edge_mask": ("edges",),
         "node_mask": ("nodes",), "graph_idx": ("nodes",), "n_graphs": None}
    if name == "gcn-cora":
        b |= {"feats": _sds((V, cfg.d_feat), f32), "labels": _sds((Bm,), f32)}
        a |= {"feats": ("nodes", None), "labels": (None,)}
    else:
        b |= {"species": _sds((V,), i32), "positions": _sds((V, 3), f32),
              "targets": _sds((Bm,), f32)}
        a |= {"species": ("nodes",), "positions": ("nodes", None), "targets": (None,)}
        if name == "dimenet":
            T = 4 * E
            b |= {"tri_kj": _sds((T,), i32), "tri_ji": _sds((T,), i32),
                  "tri_mask": _sds((T,), f32)}
            a |= {"tri_kj": ("edges",), "tri_ji": ("edges",), "tri_mask": ("edges",)}
    return b, a


def _gnn_flops(arch: ArchSpec, shp: dict, cfg) -> float:
    """Analytic per-step training FLOPs (fwd+bwd ≈ 3× fwd matmuls)."""
    kind = shp["kind"]
    if kind == "gnn_full":
        V, E = shp["n_nodes"], shp["n_edges"] // 2
    elif kind == "gnn_minibatch":
        n, E, V = shp["batch_nodes"], 0, shp["batch_nodes"]
        for f in shp["fanout"]:
            n *= f
            E += n
            V += n
    else:
        V, E = shp["batch"] * shp["n_nodes"], shp["batch"] * shp["n_edges"]
    name = arch.name
    if name == "gcn-cora":
        d_in = shp.get("d_feat", 16)
        fwd = (2 * V * d_in * cfg.d_hidden + 2 * V * cfg.d_hidden * cfg.n_classes
               + 4 * E * cfg.d_hidden)
    elif name == "schnet":
        d = cfg.d_hidden
        fwd = (cfg.n_interactions * (2 * E * cfg.n_rbf * d + 2 * E * d * d + 4 * V * d * d)
               + 2 * E * cfg.n_rbf)
    elif name == "egnn":
        d = cfg.d_hidden
        fwd = cfg.n_layers * (2 * E * (2 * d + 1) * d + 2 * E * d * d + 4 * V * d * d)
    else:  # dimenet
        d = cfg.d_hidden
        T = (4 if kind == "gnn_molecule" else 2) * E
        fwd = cfg.n_blocks * (2 * E * d * d + T * cfg.n_bilinear * d * d * 2
                              + 4 * E * d * d) + 2 * E * cfg.n_radial * d
    return 3.0 * fwd


def _gnn_cell(arch: ArchSpec, shape_name: str, shp: dict, cfg, dev) -> Cell:
    init_fn, loss = _GNN_FNS[arch.name]
    opt = AdamWConfig()
    kind = shp["kind"]
    if arch.name == "gcn-cora":
        # first-layer width is a dataset property: follow the shape's d_feat
        d_feat = cfg.d_feat if kind == "gnn_molecule" else shp.get("d_feat", cfg.d_feat)
        cfg = dataclasses.replace(cfg, d_feat=d_feat)
        if kind == "gnn_molecule":  # graph-level regression head over pooled outputs
            loss = G.gcn_molecule_loss
    step = make_train_step(functools.partial(loss, device=dev), cfg, opt)
    params_s = init_fn(cfg, jrandom.PRNGKey(0), device=META)
    batch, axes = _gnn_batch_spec(arch, shp, cfg)
    static = {k: v for k, v in batch.items() if not isinstance(v, torch.Tensor)}
    batch_arrs = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}

    def step_wrapped(state, b):
        return step(state, {**b, **static})

    def make_batch(key):
        ks = jrandom.split(key, 8)
        out = {}
        n_nodes = batch_arrs.get("node_mask", batch_arrs["edge_src"]).shape[0]
        for i, (k, sds) in enumerate(sorted(batch_arrs.items())):
            if sds.dtype == i32:
                hi = {"edge_src": n_nodes, "edge_dst": n_nodes, "species": 10, "labels": 4,
                      "graph_idx": static.get("n_graphs", 1)}.get(k, 4)
                if k.startswith("tri_"):
                    hi = batch_arrs["edge_src"].shape[0]
                out[k] = jrandom.randint(ks[i % 8], tuple(sds.shape), 0, max(hi, 1), dev)
            else:
                out[k] = jrandom.normal(ks[i % 8], tuple(sds.shape), dev)
        for k in ("edge_mask", "node_mask", "label_mask", "tri_mask"):
            if k in out:
                out[k] = torch.ones_like(out[k])
        return (out,)

    return Cell(
        arch=arch.name, shape=shape_name, kind=kind, step_fn=step_wrapped,
        state_shape=opt_init_from(params_s), batch_shape=(batch_arrs,),
        state_axes=_state_axes(_axes_like(params_s, _replicated_axes)),
        batch_axes=({k: axes[k] for k in batch_arrs},), rules={},
        init_state=lambda key: opt_init(init_fn(cfg, key, device=dev)),
        make_batch=make_batch, model_flops=_gnn_flops(arch, shp, cfg), donate=(0,))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _rec_cell(arch: ArchSpec, shape_name: str, shp: dict, cfg, dev) -> Cell:
    opt = AdamWConfig()
    kind = shp["kind"]
    B = shp["batch"]
    params_s = R.xdeepfm_init(cfg, jrandom.PRNGKey(0), device=META)
    p_axes = _axes_like(params_s, _rec_param_axes)
    vocabs = cfg.vocabs()

    def rand_ids(key, batch):
        cols = [jrandom.randint(jrandom.fold_in(key, f), (batch, 1), 0, v, dev)
                for f, v in enumerate(vocabs)]
        return torch.cat(cols, dim=1)

    def init_params(key):
        return R.xdeepfm_init(cfg, key, device=dev)

    # analytic flops: CIN dominates
    m, D = cfg.n_fields, cfg.embed_dim
    cin_f, h_prev = 0, m
    for h in cfg.cin_layers:
        cin_f += 2 * B * h_prev * m * D + 2 * B * h_prev * m * h * D
        h_prev = h
    mlp_f, d_in = 0, m * D
    for d_out in cfg.mlp_dims:
        mlp_f += 2 * B * d_in * d_out
        d_in = d_out
    fwd = cin_f + mlp_f

    if kind == "rec_train":
        def make_batch(key):
            k1, k2 = jrandom.split(key)
            return ({"field_ids": rand_ids(k1, B),
                     "labels": (jrandom.uniform(k2, (B,), dev) < 0.3).to(f32)},)

        return Cell(
            arch=arch.name, shape=shape_name, kind=kind,
            step_fn=make_train_step(R.xdeepfm_loss, cfg, opt),
            state_shape=opt_init_from(params_s),
            batch_shape=({"field_ids": _sds((B, cfg.n_fields), i32), "labels": _sds((B,), f32)},),
            state_axes=_state_axes(p_axes),
            batch_axes=({"field_ids": ("batch", None), "labels": ("batch",)},), rules={},
            init_state=lambda key: opt_init(init_params(key)), make_batch=make_batch,
            model_flops=3.0 * fwd, donate=(0,))

    if kind == "rec_serve":
        def step(params, ids):
            return R.xdeepfm_forward(params, ids, cfg)

        return Cell(
            arch=arch.name, shape=shape_name, kind=kind, step_fn=step, state_shape=params_s,
            batch_shape=(_sds((B, cfg.n_fields), i32),), state_axes=p_axes,
            batch_axes=(("batch", None),), rules={}, init_state=init_params,
            make_batch=lambda key: (rand_ids(key, B),), model_flops=fwd)

    # retrieval: 1 query × n_candidates batched dot + top-k
    N = shp["n_candidates"]

    def step(params, ids, cand):
        return R.retrieval_scores(params, ids, cand, cfg, top_k=100)

    def make_batch(key):
        k1, k2 = jrandom.split(key)
        return (rand_ids(k1, B), jrandom.normal(k2, (N, cfg.embed_dim), dev))

    return Cell(
        arch=arch.name, shape=shape_name, kind=kind, step_fn=step, state_shape=params_s,
        batch_shape=(_sds((B, cfg.n_fields), i32), _sds((N, cfg.embed_dim), f32)),
        state_axes=p_axes, batch_axes=(("batch", None), ("rows", None)),
        rules={"batch": ()} if B == 1 else {}, init_state=init_params, make_batch=make_batch,
        model_flops=2.0 * B * N * cfg.embed_dim)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

SMOKE_OVERRIDES = {
    "lm_train": dict(seq=64, batch=2),
    "lm_prefill": dict(seq=64, batch=2),
    "lm_decode": dict(seq=128, batch=2),
    "gnn_full": dict(n_nodes=128, n_edges=512, d_feat=32),
    "gnn_minibatch": dict(n_nodes=512, n_edges=2048, batch_nodes=8,
                          fanout=(3, 2), d_feat=32),
    "gnn_molecule": dict(batch=4, n_nodes=8, n_edges=12),
    "rec_train": dict(batch=16),
    "rec_serve": dict(batch=16),
    "rec_retrieval": dict(batch=1, n_candidates=512),
}


def build_cell(arch_name: str, shape_name: str, smoke: bool = False, *, device=None,
               n_layers: int | None = None, batch: int | None = None) -> Cell:
    """The cell of ``arch_name`` × ``shape_name`` (the smoke config and the
    smoke shape when ``smoke``) on ``device`` (default ``cuda``).  ``n_layers``
    cuts an LM's depth and ``batch`` the shape's batch; the cell's ``cuts``
    names those given."""
    dev = resolve_device(device)
    arch = get_arch(arch_name)
    if shape_name in arch.skips:
        raise ValueError(
            f"{arch_name} × {shape_name} is a documented skip: {arch.skips[shape_name]}")
    shp = dict(arch.shapes[shape_name])
    cfg = arch.smoke_config if smoke else arch.config
    if smoke:
        shp.update({k: v for k, v in SMOKE_OVERRIDES[shp["kind"]].items() if k in shp
                    or k in ("seq", "batch", "n_nodes", "n_edges", "d_feat",
                             "batch_nodes", "fanout", "n_candidates")})
        if arch.family == "gnn" and arch.name == "gcn-cora":
            shp["d_feat"] = cfg.d_feat
    cuts = {}
    if n_layers is not None:
        if arch.family != "lm":
            raise ValueError("n_layers cuts the depth of an LM")
        cuts["n_layers"] = f"{n_layers} of {cfg.n_layers}"
        cfg = dataclasses.replace(cfg, n_layers=int(n_layers))
    if batch is not None:
        if "batch" not in shp:
            raise ValueError(f"{shape_name} has no batch to cut")
        cuts["batch"] = f"{batch} of {shp['batch']}"
        shp["batch"] = int(batch)
    if arch.family == "lm":
        cell = _lm_cell(arch, shape_name, shp, cfg, dev)
    elif arch.family == "gnn":
        cell = _gnn_cell(arch, shape_name, shp, cfg, dev)
    else:
        cell = _rec_cell(arch, shape_name, shp, cfg, dev)
    cell.cuts = cuts
    return cell
