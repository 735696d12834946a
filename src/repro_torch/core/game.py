"""Two-stage Stackelberg game for cluster→partition assignment (Alg. 2).

Players are the clusters of Algorithm 1.  Each round has two stages:
leaders (head clusters, ids ``[0, n_head)``) best-respond first, then
followers (tail clusters), in batches of ``batch_size`` consecutive ids;
within a batch moves are simultaneous, across batches sequential.  Cost of
cluster i on partition p (paper Eq. 6):

    S_i(p) = (δ/k)·|c_i|·|p| + (deg_i − W[i, p] + |c_i|)/k
    W[i, p] = Σ_{j : P(c_j)=p} Θ(c_i, c_j)

Each improving move is accepted with probability ``accept_prob``; the
acceptance draws are ``jax.random.uniform`` bit for bit
(:mod:`repro_torch.random`), so assignments match the reference.

Only the rows of the batch can move, so each batch computes ``W`` for its
own rows from a cluster-sorted adjacency (CSR) instead of for all C rows;
the cost matrix is the reference's expression in its operation order,
rounded as the reference's compiled program rounds it (:func:`_costs`).
Θ is integer-valued, so the float32 scatter-adds are exact in any order
while the sums stay below 2**24.  This is plain PyTorch: the reference
computes the game outside any Pallas kernel.  The masked game
(``leader_mask``/``move_mask``/``move_cost``) waits for the touch-up and
incremental slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import random as _random
from .._fp32 import fma_f32 as _fma_f32

__all__ = [
    "GameInputs",
    "GameResult",
    "init_assignment",
    "compute_delta",
    "default_batch_size",
    "run_game",
    "social_welfare",
    "best_response_gap",
]


def default_batch_size(requested: int, n_clusters: int) -> int:
    """Clamp a requested game batch to ≲ C/8 (floor 16)."""
    return max(16, min(int(requested), n_clusters // 8))


class GameInputs(NamedTuple):
    sizes: torch.Tensor  # (C,) float32 edge-volume of each cluster
    pair_a: torch.Tensor  # (P,) int32 cluster adjacency endpoint a
    pair_b: torch.Tensor  # (P,) int32 endpoint b (a < b)
    pair_w: torch.Tensor  # (P,) float32 Θ(a, b), exact or CMS estimate
    n_head: int  # leaders are cluster ids [0, n_head)
    k: int


class GameResult(NamedTuple):
    assignment: torch.Tensor  # (C,) int32 cluster → partition
    rounds: int  # rounds played
    converged: bool  # no player wanted to move in the last round


def init_assignment(sizes, k: int) -> np.ndarray:
    """Snake round-robin over clusters sorted by size, descending."""
    if isinstance(sizes, torch.Tensor):
        sizes = sizes.cpu().numpy()
    order = np.argsort(-np.asarray(sizes), kind="stable")
    assign = np.empty(order.size, np.int32)
    lane = np.arange(order.size) % (2 * k)
    snake = np.where(lane < k, lane, 2 * k - 1 - lane)
    assign[order] = snake.astype(np.int32)
    return assign


def compute_delta(sizes: torch.Tensor, degs: torch.Tensor, k: int) -> torch.Tensor:
    """δ_max of paper Eq. (12): k·Σ(F(c_i)+|c_i|) / (Σ|c_i|)²."""
    num = k * torch.sum(degs + sizes)
    den = torch.square(torch.sum(sizes))
    return num / torch.clamp(den, min=1.0)


def _cluster_degrees(inputs: GameInputs, n_clusters: int) -> torch.Tensor:
    """deg_i = Σ_j Θ(i, j)."""
    z = torch.zeros(n_clusters + 1, dtype=torch.float32, device=inputs.pair_w.device)
    deg = z.index_add(0, inputs.pair_a.long(), inputs.pair_w)
    deg = deg + z.index_add(0, inputs.pair_b.long(), inputs.pair_w)
    return deg[:n_clusters]


def _neighbor_partition_weight(inputs: GameInputs, assign: torch.Tensor,
                               n_clusters: int) -> torch.Tensor:
    """W[i, p] for every cluster, via two scatter-adds over the pair list."""
    a = inputs.pair_a.long().clamp(max=n_clusters)
    b = inputs.pair_b.long().clamp(max=n_clusters)
    assign_ext = torch.cat([assign.long(), assign.new_zeros(1, dtype=torch.long)])
    w = torch.zeros((n_clusters + 1, inputs.k), dtype=torch.float32,
                    device=inputs.pair_w.device)
    w.index_put_((a, assign_ext[b]), inputs.pair_w, accumulate=True)
    w.index_put_((b, assign_ext[a]), inputs.pair_w, accumulate=True)
    return w[:n_clusters]


class _Adjacency(NamedTuple):
    """Both directions of every pair, sorted by row; ``indptr`` on host."""

    rows: torch.Tensor  # (2P,) int64
    nbrs: torch.Tensor  # (2P,) int64
    w: torch.Tensor  # (2P,) float32
    indptr: np.ndarray  # (C + 2,) int64


def _adjacency(inputs: GameInputs, n_clusters: int) -> _Adjacency:
    rows = torch.cat([inputs.pair_a, inputs.pair_b]).long().clamp(max=n_clusters)
    nbrs = torch.cat([inputs.pair_b, inputs.pair_a]).long().clamp(max=n_clusters)
    w = torch.cat([inputs.pair_w, inputs.pair_w])
    order = torch.argsort(rows, stable=True)
    rows, nbrs, w = rows[order], nbrs[order], w[order]
    counts = torch.bincount(rows, minlength=n_clusters + 1).cpu().numpy()
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return _Adjacency(rows, nbrs, w, indptr)


def _costs(a, hyp, t, inv_k, cur_p):
    """Cost matrix ``a·hyp + t·inv_k`` and each row's cost at ``cur_p``,
    rounded as the reference's compiled program (XLA CPU) rounds them: its
    min/argmin reduction contracts ``fma(a, hyp, t·inv_k)``, its gather of
    the current partition's cost contracts the other product,
    ``fma(t, inv_k, a·hyp)``."""
    cost = _fma_f32(a, hyp, t * inv_k)
    col = cur_p[:, None]
    t_cur = t.gather(1, col)
    cur = _fma_f32(t_cur, torch.full_like(t_cur, inv_k), a * hyp.gather(1, col))
    return cost, cur[:, 0]


def _batch_update(inputs, degs, assign, lo, hi, lucky, dk, inv_k, adj):
    """Best response of clusters ``[lo, hi)`` (one simultaneous batch),
    updating ``assign`` in place.  Returns whether any of them had an
    improving move (a device bool)."""
    k = inputs.k
    s, e = int(adj.indptr[lo]), int(adj.indptr[hi])
    cell = (adj.rows[s:e] - lo) * k + assign[adj.nbrs[s:e]].long()
    w_ip = torch.zeros((hi - lo) * k, dtype=torch.float32, device=assign.device)
    w_ip = w_ip.index_add_(0, cell, adj.w[s:e]).view(hi - lo, k)
    part_sizes = torch.zeros(k, dtype=torch.float32, device=assign.device)
    part_sizes.index_add_(0, assign.long(), inputs.sizes)
    sz = inputs.sizes[lo:hi, None]
    cur_p = assign[lo:hi].long()
    onehot = (torch.arange(k, device=assign.device) == cur_p[:, None]).to(torch.float32)
    # hypothetical |p| if i moved to p: current size + s_i when p ≠ P_i
    hyp = part_sizes[None, :] + sz * (1.0 - onehot)
    cost, cur = _costs(dk * sz, hyp, degs[lo:hi, None] - w_ip + sz, inv_k, cur_p)
    # the current partition wins cost ties; other ties go to the lowest id
    strictly_better = cost.amin(dim=1) < cur
    best = torch.where(strictly_better, cost.argmin(dim=1), cur_p)
    improves = strictly_better & (best != cur_p)
    assign[lo:hi] = torch.where(improves & lucky[lo:hi], best, cur_p).to(torch.int32)
    return improves.any()


def _acceptance(key0, rounds, leader, batch, cid, accept_prob):
    """``uniform(fold_in(k_stage, b), (C,))[i] < accept_prob`` for every
    cluster i, with ``k_stage`` the stage's half of ``split(fold_in(key0,
    rounds))`` and ``b`` the batch that holds i."""
    k1, k2 = _random.split(_random.fold_in(key0, rounds))
    dev = cid.device
    kk0 = torch.where(leader, torch.tensor(k1[0], device=dev), torch.tensor(k2[0], device=dev))
    kk1 = torch.where(leader, torch.tensor(k1[1], device=dev), torch.tensor(k2[1], device=dev))
    b0, b1 = _random.fold_in((kk0, kk1), batch)
    y0, y1 = _random.threefry2x32(b0, b1, 0, cid)
    return _random.bits_to_uniform(y0 ^ y1) < accept_prob


def run_game(inputs: GameInputs, n_clusters: int, *, batch_size: int = 256,
             max_rounds: int = 64, accept_prob: float = 0.7,
             assign0: np.ndarray | None = None, delta=None, seed: int = 0,
             leader_mask=None, move_mask=None, move_cost=None,
             home=None) -> GameResult:
    """Damped best-response dynamics to a pure Nash equilibrium (the
    unmasked game of ``repro.core.game.run_game``), on the device of
    ``inputs.sizes``."""
    if any(x is not None for x in (leader_mask, move_mask, move_cost, home)):
        raise NotImplementedError(
            "the masked game (leader_mask, move_mask, move_cost, home) waits "
            "for the touch-up and incremental slice (slice 5) of the port")
    dev = inputs.sizes.device
    C, k, n_head = int(n_clusters), inputs.k, inputs.n_head
    if assign0 is None:
        assign0 = init_assignment(inputs.sizes, k)
    degs = _cluster_degrees(inputs, C)
    if delta is None:
        delta = compute_delta(inputs.sizes, degs, k)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev)
    inv_k = 1.0 / k
    dk = delta * inv_k
    accept = torch.tensor(accept_prob, dtype=torch.float32, device=dev)
    assign = torch.as_tensor(np.asarray(assign0), dtype=torch.int32).to(dev).clone()
    adj = _adjacency(inputs, C)
    bs = int(batch_size)
    n_batches_h = max(1, -(-n_head // bs))
    n_batches_t = max(1, -(-(C - n_head) // bs))
    cid = torch.arange(C, dtype=torch.int64, device=dev)
    leader = cid < n_head
    batch = torch.where(leader, cid // bs, (cid - n_head) // bs)
    key0 = _random.PRNGKey(seed)

    rounds = 0
    while True:  # at least one round; the last round's `wanted` decides
        lucky = _acceptance(key0, rounds, leader, batch, cid, accept)
        wanted = torch.zeros((), dtype=torch.bool, device=dev)
        spans = ([(b * bs, min(b * bs + bs, n_head)) for b in range(n_batches_h)]
                 + [(n_head + b * bs, min(n_head + b * bs + bs, C))
                    for b in range(n_batches_t)])
        for lo, hi in spans:  # Stage 1: leaders; Stage 2: followers
            if hi > lo:
                wanted |= _batch_update(inputs, degs, assign, lo, hi, lucky,
                                        dk, inv_k, adj)
        rounds += 1
        wanted = bool(wanted)
        if not (wanted and rounds < max_rounds):
            break
    return GameResult(assignment=assign, rounds=rounds, converged=not wanted)


def social_welfare(inputs: GameInputs, assign: torch.Tensor, delta) -> torch.Tensor:
    """S(Λ) of Eq. (5) = δ·Σ|p|²/k + Σ Θ(p, V)/k (Theorem 4 identity)."""
    k = inputs.k
    part_sizes = torch.zeros(k, dtype=torch.float32, device=assign.device)
    part_sizes.index_add_(0, assign.long(), inputs.sizes)
    assign_ext = torch.cat([assign.long(), assign.new_zeros(1, dtype=torch.long)])
    cut = torch.sum(inputs.pair_w * (assign_ext[inputs.pair_a.long()]
                                     != assign_ext[inputs.pair_b.long()]).to(torch.float32))
    load = delta * torch.sum(torch.square(part_sizes)) / k
    comm = (2.0 * cut + torch.sum(part_sizes)) / k
    return load + comm


def best_response_gap(inputs: GameInputs, assign: torch.Tensor, n_clusters: int,
                      delta=None) -> torch.Tensor:
    """Max cost improvement any single player could get by deviating
    (0 ⇔ pure Nash equilibrium)."""
    degs = _cluster_degrees(inputs, n_clusters)
    if delta is None:
        delta = compute_delta(inputs.sizes, degs, inputs.k)
    k = inputs.k
    sizes = inputs.sizes
    w_ip = _neighbor_partition_weight(inputs, assign, n_clusters)
    part_sizes = torch.zeros(k, dtype=torch.float32, device=assign.device)
    part_sizes.index_add_(0, assign.long(), sizes)
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    hyp = part_sizes[None, :] + sizes[:, None] * (1.0 - onehot)
    # the reference runs this op by op (no jit), so nothing is fused here
    cost = (delta / k) * sizes[:, None] * hyp + (degs[:, None] - w_ip + sizes[:, None]) / k
    cur = cost.gather(1, assign.long()[:, None])[:, 0]
    return torch.max(cur - cost.amin(dim=1))
