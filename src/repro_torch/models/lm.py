"""Decoder-only LM: Llama-3 / Qwen2.5 / Qwen3 (dense) and Mixtral (MoE)
(port of ``repro.models.lm``).

One implementation parameterized by :class:`LMConfig`: GQA attention with
RoPE, optional QKV bias (Qwen2.5), optional qk-norm (Qwen3), optional
sliding window; a SwiGLU MLP, or Mixtral's top-k MoE block with the
reference's sort-based capacity dispatch (each batch row its own dispatch
group; plain torch, as the reference's is plain ``jnp``).  Parameters are a
dict with the reference's keys and stacked (L, …) leaves; a Python loop
over layers takes the place of ``lax.scan`` (``remat`` and the sharding
constraints have no effect on one device).  The full-sequence attention of
``forward`` and ``prefill`` is :func:`.attention.flash_attention`, which on
the card *is* K6; there is no switch to a plain version on the card.
``use_flash_kernel`` stays for parity with the reference's config and is
read nowhere, as there.  Every entry point runs on ``device`` (default
``cuda``, raising without a card).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from .. import random as jrandom
from .._device import resolve_device
from .attention import decode_attention, flash_attention
from .common import dense_init, rms_norm, softmax_xent

__all__ = ["LMConfig", "init_params", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "count_params", "active_params", "model_flops"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    sliding_window: int | None = None  # SWA width (Mixtral)
    onehot_embed: bool = True  # the reference's one-hot lookup; the port gathers
    n_experts: int = 0  # 0 ⇒ dense MLP
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16
    attn_chunk: int = 1024  # KV block of the CPU's online-softmax loop
    remat: bool = True  # no effect in the port (inference only)
    use_flash_kernel: bool = False  # read nowhere, as in the reference

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: LMConfig, key, device=None) -> dict:
    """The reference's parameter tree from the same key: each weight is a
    truncated-normal draw, made slice by slice into ``cfg.dtype`` on the
    device (``fan_in`` = the first axis, L for the stacked weights)."""
    dev = resolve_device(device)
    L, D, H, KV, hd, F_, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                              cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab)
    ks = jrandom.split(key, 16)
    dt = cfg.dtype

    def w(k, *shape, scale=None):
        return dense_init(k, shape, scale=scale, dtype=dt, device=dev)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    attn = {
        "wq": w(ks[0], L, D, H * hd),
        "wk": w(ks[1], L, D, KV * hd),
        "wv": w(ks[2], L, D, KV * hd),
        "wo": w(ks[3], L, H * hd, D),
    }
    if cfg.qkv_bias:
        attn["bq"] = full((L, H * hd), 0.0)
        attn["bk"] = full((L, KV * hd), 0.0)
        attn["bv"] = full((L, KV * hd), 0.0)
    if cfg.qk_norm:
        attn["q_norm"] = full((L, hd), 1.0)
        attn["k_norm"] = full((L, hd), 1.0)
    if cfg.is_moe:
        E = cfg.n_experts
        mlp = {
            "router": w(ks[4], L, D, E, scale=0.02),
            "w_gate": w(ks[5], L, E, D, F_),
            "w_up": w(ks[6], L, E, D, F_),
            "w_down": w(ks[7], L, E, F_, D),
        }
    else:
        mlp = {
            "w_gate": w(ks[5], L, D, F_),
            "w_up": w(ks[6], L, D, F_),
            "w_down": w(ks[7], L, F_, D),
        }
    return {
        "embed": w(ks[8], V, D, scale=0.02),
        "layers": {"attn": attn, "mlp": mlp, "ln1": full((L, D), 1.0),
                   "ln2": full((L, D), 1.0)},
        "final_norm": full((D,), 1.0),
        "lm_head": w(ks[9], D, V, scale=0.02),
    }


def count_params(cfg: LMConfig) -> int:
    L, D, H, KV, hd, F_, V = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                              cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab)
    attn = L * (D * H * hd + 2 * D * KV * hd + H * hd * D)
    if cfg.is_moe:
        mlp = L * (D * cfg.n_experts + cfg.n_experts * 3 * D * F_)
    else:
        mlp = L * 3 * D * F_
    return attn + mlp + 2 * V * D + L * 2 * D + D


def active_params(cfg: LMConfig) -> int:
    """Per-token active parameters (MoE counts top_k experts only)."""
    if not cfg.is_moe:
        return count_params(cfg)
    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
    return (count_params(cfg) - L * cfg.n_experts * 3 * D * F_
            + L * cfg.top_k * 3 * D * F_)


def model_flops(cfg: LMConfig, n_tokens: int, train: bool = True) -> float:
    """6·N_active·D (train) or 2·N_active·D (inference)."""
    return (6.0 if train else 2.0) * active_params(cfg) * n_tokens


# ---------------------------------------------------------------------------
# rotary embedding and the layer
# ---------------------------------------------------------------------------


def _rope(x, positions, theta):
    """x: (B, S, H, hd); positions: (B, S).  The angles are float32 and the
    products promote to float32, as in the reference; the result is in x's
    type.  ``theta ** e``, cos and sin differ from XLA's by ulps."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions[..., :, None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[..., None, :]  # (B, S, 1, half): broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (sort-based capacity dispatch: Mixtral top-2)
# ---------------------------------------------------------------------------


def _moe_block(x_bsd, mp, cfg: LMConfig, route: dict | None = None):
    """x_bsd: (B, S, D) → (B, S, D), the aux load-balance loss averaged over
    the rows.  Each batch row is its own dispatch group, as in the
    reference (which ``vmap``s :func:`_moe_dispatch_group` over the rows):
    capacity and drops are per row, never over the flattened batch."""
    out, aux = _moe_dispatch_group(x_bsd, mp, cfg, route=route)
    return out, aux.mean()


def _moe_dispatch_group(x, mp, cfg: LMConfig, route: dict | None = None):
    """One dispatch group ``x`` (T, D) → (T, D), aux; or a stack of groups
    (G, T, D) → (G, T, D), (G,) aux, each routed on its own.

    Within a group the tokens go to their top-K experts (ties to the lower
    expert index, as ``lax.top_k``); the T·K assignments, in ``t·K + k``
    order, are ranked within each expert by a stable sort, and each expert
    serves the first ``cap = max(8, min(int(capacity_factor·K·T/E), T))``
    of them: slot ``e·cap + pos``, or the sink ``E·cap`` (dropped, adds 0).
    The experts run as (E, G·cap, D) × (E, D, F) products over the groups'
    slots, and the outputs are scatter-added back with their gate weights
    in x's type.  ``route``, a dict, receives the routing (in sorted order
    where the reference's is): ``gate_w``, ``gate_e`` (…, T, K), ``order``,
    ``slot``, ``keep`` (…, T·K) and ``load`` (…, E), the assignments each
    expert was given."""
    lead = x.shape[:-2]
    xb = x.reshape(-1, *x.shape[-2:])
    G, T, D = xb.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = max(8, min(int(cfg.capacity_factor * K * T / E), T))
    dev = x.device

    logits = xb @ mp["router"].to(xb.dtype)  # (G, T, E)
    probs = torch.softmax(logits.float(), dim=-1)
    ranked, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = ranked[..., :K], experts[..., :K]
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    # aux load-balance loss (Switch): E · Σ_e f_e · p_e
    me = probs.mean(dim=1)
    ce = F.one_hot(gate_e, E).float().sum(dim=2).mean(dim=1) / K
    aux = E * (me * ce).sum(dim=-1)

    # rank the assignments within each expert by a stable (expert, arrival) sort
    flat_e = gate_e.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = flat_e.gather(1, order)
    experts_e = torch.arange(E, device=dev).expand(G, E).contiguous()
    starts = torch.searchsorted(e_sorted, experts_e)  # left side
    pos_in_e = torch.arange(T * K, device=dev) - starts.gather(1, e_sorted)
    keep = pos_in_e < cap
    slot = torch.where(keep, e_sorted * cap + pos_in_e, E * cap)  # E·cap: the sink
    tok = order // K  # the token of each sorted assignment

    # dispatch: (G, E·cap + 1, D), the sink row last
    gidx = torch.arange(G, device=dev)[:, None]
    buf = xb.new_zeros((G, E * cap + 1, D))
    buf[gidx, slot] = xb[gidx, tok]
    xe = buf[:, :E * cap].reshape(G, E, cap, D).transpose(0, 1).reshape(E, G * cap, D)
    del buf
    # the experts' products over every group's slots at once
    h = torch.bmm(xe, mp["w_gate"])
    h = F.silu(h).mul_(torch.bmm(xe, mp["w_up"]))
    del xe
    ye = torch.bmm(h, mp["w_down"])
    del h
    yflat = ye.reshape(E, G, cap, D).transpose(0, 1).reshape(G, E * cap, D)
    # combine: a weighted scatter-add back to the tokens, in x's type
    contrib = torch.where(keep[..., None], yflat[gidx, slot.clamp(max=E * cap - 1)], 0)
    w = gate_w.reshape(G, T * K).gather(1, order).to(xb.dtype)
    out = xb.new_zeros((G * T, D))
    out.index_add_(0, (gidx * T + tok).reshape(-1), (contrib * w[..., None]).reshape(-1, D))
    if route is not None:
        counts = torch.diff(starts, dim=1, append=torch.full((G, 1), T * K, device=dev))
        for name, v in (("gate_w", gate_w), ("gate_e", gate_e), ("order", order),
                        ("slot", slot), ("keep", keep), ("load", counts)):
            route[name] = v.reshape(*lead, *v.shape[1:])
    return out.reshape(x.shape), aux.reshape(lead)


def _attention_block(x, ap, cfg: LMConfig, positions, layer_cache=None):
    """Full sequence when ``layer_cache`` is None (returns this layer's k, v);
    else one-token decode, writing the token into the layer's cache in place
    (returns the cache)."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ ap["wq"]
    k = x @ ap["wk"]
    v = x @ ap["wv"]
    if cfg.qkv_bias:
        q = q + ap["bq"]
        k = k + ap["bk"]
        v = v + ap["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, ap["q_norm"])
        k = rms_norm(k, ap["k_norm"])
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)

    if layer_cache is None:
        out = flash_attention(
            q, k, v, positions, positions, True, cfg.sliding_window,
            min(cfg.attn_chunk // 2, max(S, 8)), min(cfg.attn_chunk, max(S, 8)))
        new_cache = (k, v)
    else:
        ck, cv, cpos = layer_cache  # (B, Smax, KV, hd) ×2, (B, Smax)
        # rolling write for SWA caches; plain append otherwise
        wpos = (positions[:, 0] % ck.shape[1]).long()
        bidx = torch.arange(B, device=x.device)
        ck[bidx, wpos] = k[:, 0]
        cv[bidx, wpos] = v[:, 0]
        cpos[bidx, wpos] = positions[:, 0].to(cpos.dtype)
        out = decode_attention(q, ck, cv, positions, cpos,
                               causal=True, window=cfg.sliding_window)
        new_cache = (ck, cv, cpos)
    out = out.reshape(B, S, H * hd) @ ap["wo"]
    return out, new_cache


def _layer(x, lp, cfg: LMConfig, positions, layer_cache=None, route=None):
    """One layer: (x, aux, cache); aux is the MoE block's (0 for the dense
    MLP), ``route`` receives its routing (see :func:`_moe_dispatch_group`)."""
    h, new_cache = _attention_block(rms_norm(x, lp["ln1"]), lp["attn"], cfg, positions,
                                    layer_cache=layer_cache)
    x = x + h
    y = rms_norm(x, lp["ln2"])
    if cfg.is_moe:
        out, aux = _moe_block(y, lp["mlp"], cfg, route=route)
    else:
        hmid = F.silu(y @ lp["mlp"]["w_gate"]) * (y @ lp["mlp"]["w_up"])
        out = hmid @ lp["mlp"]["w_down"]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux, new_cache


def _layer_params(params, i: int) -> dict:
    """Layer ``i``'s leaves of the stacked (L, …) tree (views)."""
    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    return take(params["layers"])


def _embed(params, tokens, cfg: LMConfig):
    """Token embedding as a gather.  The reference's one-hot contraction
    (``onehot_embed``) sums one nonzero product ``1·e`` per output, so it
    equals the gather value for value."""
    return params["embed"].to(cfg.dtype)[tokens.long()]


def _tokens(tokens, dev) -> torch.Tensor:
    return torch.as_tensor(tokens).to(dev)


def _check_params(params, dev) -> None:
    if params["embed"].device.type != dev.type:
        raise ValueError(f"the parameters are on {params['embed'].device}, not {dev}")


def forward(params, tokens, cfg: LMConfig, positions=None, device=None):
    """Prefill forward: (B, S) → logits (B, S, V), and aux: the layers' MoE
    load-balance losses summed over the layers / ``n_layers`` (0 for the
    dense MLP)."""
    dev = resolve_device(device)
    _check_params(params, dev)
    tokens = _tokens(tokens, dev)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    positions = _tokens(positions, dev).to(torch.int32)
    x = _embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(cfg.n_layers):
        x, a, _ = _layer(x, _layer_params(params, i), cfg, positions)
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    return x @ params["lm_head"], aux / cfg.n_layers


def loss_fn(params, batch, cfg: LMConfig, device=None):
    """Mean cross-entropy of ``forward`` (evaluation only: the port has no
    backward for K6 yet)."""
    logits, aux = forward(params, batch["tokens"], cfg, device=device)
    targets = _tokens(batch["targets"], logits.device)
    loss = softmax_xent(logits, targets)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with (rolling) KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None) -> dict:
    """SWA models roll within a window-sized cache; empty slots hold
    position −1."""
    dev = resolve_device(device)
    S = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    return {
        "k": torch.zeros((L, batch, S, KV, hd), dtype=cfg.dtype, device=dev),
        "v": torch.zeros((L, batch, S, KV, hd), dtype=cfg.dtype, device=dev),
        "pos": torch.full((L, batch, S), -1, dtype=torch.int32, device=dev),
    }


def prefill(params, tokens, cfg: LMConfig, max_seq: int, device=None,
            routes: list | None = None):
    """Forward the prompt, returning last-position logits and a filled cache.

    Each layer's trailing window of k and v is written into the rolling
    cache (slot ``position % W``) as the layer runs, so the (L, B, S, …)
    stack of the reference is never held whole; the values are the same.
    ``routes``, a list, receives each MoE layer's routing as a dict (see
    :func:`_moe_dispatch_group`)."""
    dev = resolve_device(device)
    _check_params(params, dev)
    tokens = _tokens(tokens, dev)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    cache = init_cache(cfg, B, max_seq, device=dev)
    W = cache["k"].shape[2]
    take = min(W, S)
    sl = slice(S - take, S)
    slots = (positions[0, sl] % W).long()  # the same for every row
    x = _embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        route = {} if routes is not None and cfg.is_moe else None
        x, _, (k, v) = _layer(x, _layer_params(params, i), cfg, positions, route=route)
        if route is not None:
            routes.append(route)
        cache["k"][i][:, slots] = k[:, sl]
        cache["v"][i][:, slots] = v[:, sl]
        cache["pos"][i][:, slots] = positions[:, sl]
    x = rms_norm(x, params["final_norm"])
    logits = x[:, -1] @ params["lm_head"]
    return logits, cache


def decode_step(params, cache, tokens, pos, cfg: LMConfig, device=None):
    """One decode step: tokens (B,), pos (B,) → logits (B, V), the cache.

    The token's k, v and position are written into ``cache`` in place (the
    rolling slot ``pos % W``); the returned cache is the same dict."""
    dev = resolve_device(device)
    _check_params(params, dev)
    tokens = _tokens(tokens, dev)
    positions = _tokens(pos, dev).to(torch.int32)[:, None]  # (B, 1)
    x = _embed(params, tokens[:, None], cfg)
    for i in range(cfg.n_layers):
        layer_cache = (cache["k"][i], cache["v"][i], cache["pos"][i])
        x, _, _ = _layer(x, _layer_params(params, i), cfg, positions, layer_cache=layer_cache)
    x = rms_norm(x, params["final_norm"])
    return x[:, 0] @ params["lm_head"], cache
