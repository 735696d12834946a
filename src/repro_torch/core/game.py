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
(:mod:`repro_torch.random`, in either threefry mode), so assignments
match the reference.

Only the rows of the batch can move, so each batch computes ``W`` for its
own rows from a cluster-sorted adjacency (CSR) instead of for all C rows;
the cost matrix is the reference's expression in its operation order,
rounded as the reference's compiled program rounds it (:func:`_costs`).

The reference adds every float32 sum cell by cell in index order; the
card's ``index_add_`` adds with atomics in an order that varies.  Every
term is non-negative (Θ is integer-valued, a cluster size a multiple of
½), so no partial sum in any order exceeds the exact total, and rounding
is monotone: a total below the limit (2**24 for integers, 2**23 for
halves) is exact in every order, and an atomic total below it proves the
exact one is.  So, per game (:func:`_static_bounds`, from the exact
degrees and Σ sizes in float64):

- W[i, p] ≤ deg_i.  A batch that holds a row with deg_i ≥ 2**24 (a *hub
  batch*) sums W in the reference's order on K5 (:func:`_segment_sum`: the
  adjacency holds each row's pairs with ``pair_a == i`` by index, then
  those with ``pair_b == i``, and a stable grouping by cell keeps that
  order, which is ``w.at[a, ·].add`` followed by ``w.at[b, ·].add``);
  every other batch keeps ``index_add_``.
- Where the exact Σ sizes ≥ 2**23, the partition sizes stay atomic but
  are guarded: a running (k,) max of each batch's totals stays on the
  device and is read with ``wanted`` at the round's one sync.  If it
  reached 2**23, the round is replayed from its starting assignment with
  the same acceptance draws and the sizes summed on K5 in index order; a
  round is a function of its start and its draws, so the replay gives the
  reference's bits.  While the sizes summed in order still reach 2**23,
  the next round starts in order (no atomic pass to throw away); below
  2**23 it returns to the guard.  In order, K5 runs each partition's
  chain only from where its exact running total reaches 2**23: below, the
  chain's state is the exact prefix (:func:`_part_sizes`).  Below 2**23 in
  all, no guard runs.
- The cluster degrees (a CMS Θ overestimates them past 2**24 at R-MAT
  scale 20) are always summed in the reference's order on K5, and the
  whole-array sums of δ and of the objective in the reference's order too
  (:func:`~.._fp32.xla_sum_f32`); :func:`social_welfare` and
  :func:`best_response_gap` run once a call and take the ordered sums.

:class:`GameResult` reports the hub batches, the ordered sums (one K5
launch each on the card), the replayed and the ordered rounds and the
largest guarded partition size and hub-batch W seen.
This is plain PyTorch: the reference computes the game outside any Pallas
kernel.

The masked game (``leader_mask``/``move_mask``, the reference's
``_run_game_masked_jit``) names the leaders by a mask and lets only
``move_mask`` clusters move.  It visits the batch windows
``[b·bs, (b+1)·bs)`` that hold a movable cluster (not offset at
``n_head``), leaders' stage first, each with the role mask of its stage,
and draws window b's acceptance bits from ``fold_in(split(fold_in(key0,
round))[stage], b)``.  A window with no movable cluster of the stage's role
is a no-op there and is skipped.  The hub batches and the size guard work
as above.

The masked game also takes the migration cost of elastic resharding: with
``move_cost`` (C,), cluster i pays ``move_cost[i]`` on every partition but
``home[i]`` (default its ``assign0`` seat; ``home = -1`` charges every
partition, a uniform and so neutral penalty).  A ``move_cost`` without
masks plays the masked game with the leader prefix ``arange(C) < n_head``.
The reference materialises the (C, k) penalty ``move_cost·(1 − one_hot(home))``
once and adds it after the cost's two products (:func:`_costs`); each
batch here builds the penalty of its own rows only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import random as _random
from .._fp32 import fma_f32 as _fma_f32
from .._fp32 import xla_sum_f32 as _xla_sum
from ..kernels.segment_agg import LONG_ROW_EDGES, SegmentLayout, segment_agg

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


W_LIMIT = 2**24  # integer-valued float32 sums are exact in any order below it
SIZE_LIMIT = 2**23  # the same for sums of multiples of ½ (the cluster sizes)


class GameResult(NamedTuple):
    assignment: torch.Tensor  # (C,) int32 cluster → partition
    rounds: int  # rounds played
    converged: bool  # no player wanted to move in the last round
    hub_batches: int = 0  # batches that sum W in order (a row with deg ≥ 2**24)
    ordered_sums: int = 0  # ordered sums taken by batch updates (a K5 launch each)
    size_guard: bool = False  # the exact Σ sizes ≥ 2**23: partition sizes guarded
    replayed_rounds: int = 0  # rounds replayed with the sizes in order
    ordered_rounds: int = 0  # rounds whose sizes were summed in order (replays too)
    max_part_size: float = 0.0  # largest exact partition size in a guarded batch
    max_w_hub: float = 0.0  # largest W[i, p] in a hub batch


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
    """δ_max of paper Eq. (12): k·Σ(F(c_i)+|c_i|) / (Σ|c_i|)², both sums
    in the reference's order (they pass 2**24 on large graphs, where the
    order decides the last bits)."""
    num = k * _xla_sum(degs + sizes)
    den = torch.square(_xla_sum(sizes))
    return num / torch.clamp(den, min=1.0)


def _segment_sum(w: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(w, ids, n)`` as XLA's CPU scatter adds it: each
    segment in index order, one float32 add at a time.  That is K5's
    function (products ``w·1``), so on the card it runs on K5, where atomics
    would add in another order once a total passes the float32 limits.  The
    stable grouping by segment and its row pointers stay on the device (no
    host sync); every segment goes to K5's short rows (a warp's chain past
    64 entries), so no long-row list has to be counted on the host."""
    dev = w.device
    ids = ids.long()  # ids < 0 are dropped
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    row_ptr = torch.searchsorted(sorted_ids, torch.arange(n + 1, device=dev))
    m = int(ids.numel())
    lay = SegmentLayout(
        src=torch.zeros(m, dtype=torch.int32, device=dev), dst=sorted_ids.to(torch.int32),
        w=w[order].contiguous(), row_ptr=row_ptr, order=order, n_rows=n,
        n_src=int(m > 0), n_edges=m, long_rows=torch.zeros(0, dtype=torch.int32, device=dev),
        long_row_edges=min(max(m, LONG_ROW_EDGES), 2**31 - 1))
    ones = torch.ones((1, 1), dtype=torch.float32, device=dev)
    return segment_agg(ones, lay)[:, 0]


def _cluster_degrees(inputs: GameInputs, n_clusters: int) -> torch.Tensor:
    """deg_i = Σ_j Θ(i, j)."""
    deg = _segment_sum(inputs.pair_w, inputs.pair_a, n_clusters + 1)
    deg = deg + _segment_sum(inputs.pair_w, inputs.pair_b, n_clusters + 1)
    return deg[:n_clusters]


def _neighbor_partition_weight(inputs: GameInputs, assign: torch.Tensor,
                               n_clusters: int) -> torch.Tensor:
    """W[i, p] for every cluster in the reference's order: its two
    scatter-adds (``w.at[a, P(b)].add`` then ``w.at[b, P(a)].add``) are one
    cell-keyed sum over the pair list followed by its mirror."""
    k = inputs.k
    a = inputs.pair_a.long().clamp(max=n_clusters)
    b = inputs.pair_b.long().clamp(max=n_clusters)
    assign_ext = torch.cat([assign.long(), assign.new_zeros(1, dtype=torch.long)])
    cells = torch.cat([a * k + assign_ext[b], b * k + assign_ext[a]])
    w = _segment_sum(torch.cat([inputs.pair_w, inputs.pair_w]), cells,
                     (n_clusters + 1) * k)
    return w.view(n_clusters + 1, k)[:n_clusters]


def _part_sizes(sizes: torch.Tensor, assign: torch.Tensor, k: int,
                exact_below: float | None = None) -> torch.Tensor:
    """|p| = Σ_{P(i)=p} |c_i|: by ``index_add_`` (atomics on the card) when
    ``exact_below`` is None, else as the reference sums it (index order, one
    float32 add at a time) on K5.  While a partition's running total stays
    below ``exact_below`` (2**23 for multiples of ½) every add is exact, so
    the chain's state there is the exact prefix (float64 here, exact): K5
    runs each partition's chain from that prefix over its other members
    only."""
    dev = sizes.device
    if exact_below is None:
        return torch.zeros(k, dtype=torch.float32, device=dev).index_add_(
            0, assign.long(), sizes)
    a = assign.long()
    order = torch.argsort(a, stable=True)
    part, t = a[order], sizes[order]
    incl = torch.cumsum(t.double(), 0)
    base = torch.cat([incl.new_zeros(1), incl])[
        torch.searchsorted(part, torch.arange(k, device=dev))]
    tail = incl - base[part] >= exact_below
    head = torch.zeros(k, dtype=torch.float64, device=dev).index_add_(
        0, part, torch.where(tail, 0.0, t.double()))
    # each partition's row: its exact head, then its other members in order
    ids = torch.cat([torch.arange(k, device=dev), torch.where(tail, part, -1)])
    return _segment_sum(torch.cat([head.float(), t]), ids, k)


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


def _costs(a, hyp, t, inv_k, cur_p, pen=None):
    """Cost matrix ``a·hyp + t·inv_k (+ pen)`` and each row's cost at
    ``cur_p``, rounded as the reference's compiled program (XLA CPU) rounds
    them: its min/argmin reduction contracts ``fma(a, hyp, t·inv_k)``, its
    gather of the current partition's cost contracts the other product,
    ``fma(t, inv_k, a·hyp)``.  The migration penalty ``pen`` is a separate
    buffer there, added to either form after it (one float32 add)."""
    cost = _fma_f32(a, hyp, t * inv_k)
    col = cur_p[:, None]
    t_cur = t.gather(1, col)
    cur = _fma_f32(t_cur, torch.full_like(t_cur, inv_k), a * hyp.gather(1, col))
    if pen is not None:
        cost = cost + pen
        cur = cur + pen.gather(1, col)
    return cost, cur[:, 0]


class _Static(NamedTuple):
    """What the exact totals prove, once per game (:func:`_static_bounds`)."""

    hub_rows: np.ndarray  # rows whose W may pass 2**24: sum their batches in order
    size_limit: float | None  # replay a round whose atomic sizes reach it; None: no guard


def _static_bounds(inputs: GameInputs, n_clusters: int) -> _Static:
    """The exact degrees and Σ sizes in float64 (exact in any order).
    Where Θ is not integer-valued and non-negative, every row is a hub row;
    where a size is not a non-negative multiple of ½, every round is
    replayed (the limit is 0): the argument above holds for neither."""
    sizes, pw = inputs.sizes, inputs.pair_w
    C = n_clusters
    w64 = pw.double()
    deg = torch.zeros(C + 1, dtype=torch.float64, device=pw.device)
    deg.index_add_(0, inputs.pair_a.long().clamp(max=C), w64)
    deg.index_add_(0, inputs.pair_b.long().clamp(max=C), w64)
    twice = sizes.double() * 2
    facts = torch.stack([
        ((pw == pw.trunc()) & (pw >= 0)).all().double(),
        ((twice == twice.trunc()) & (twice >= 0)).all().double(),
        sizes.double().sum()]).tolist()
    if facts[0]:
        hub_rows = torch.nonzero(deg[:C] >= W_LIMIT)[:, 0].cpu().numpy()
    else:
        hub_rows = np.arange(C)
    if not facts[1]:
        return _Static(hub_rows, 0.0)
    return _Static(hub_rows, SIZE_LIMIT if facts[2] >= SIZE_LIMIT else None)


def _batch_w(adj, assign, lo, hi, k, ordered: bool) -> torch.Tensor:
    """W[i, p] for the rows ``[lo, hi)``: (hi − lo, k) float32, in the
    reference's order on K5 when ``ordered``, else by ``index_add_``."""
    s, e = int(adj.indptr[lo]), int(adj.indptr[hi])
    cell = (adj.rows[s:e] - lo) * k + assign[adj.nbrs[s:e]].long()
    if ordered:
        return _segment_sum(adj.w[s:e], cell, (hi - lo) * k).view(hi - lo, k)
    w_ip = torch.zeros((hi - lo) * k, dtype=torch.float32, device=assign.device)
    return w_ip.index_add_(0, cell, adj.w[s:e]).view(hi - lo, k)


def _move_pen(move_cost, home, lo, hi, k):
    """Rows ``[lo, hi)`` of the reference's penalty ``move_cost[:, None]·
    (1 − one_hot(home, k))`` (``home = -1``: a row of zeros in the one-hot)."""
    at_home = (torch.arange(k, device=home.device) == home[lo:hi, None].long())
    return move_cost[lo:hi, None] * (1.0 - at_home.to(torch.float32))


def _batch_update(inputs, degs, assign, lo, hi, lucky, dk, inv_k, adj, *,
                  hub=False, sizes_exact_below=None, size_max=None, w_max=None,
                  active=None, migrate=None):
    """Best response of clusters ``[lo, hi)`` (one simultaneous batch),
    updating ``assign`` in place.  Returns whether any of them had an
    improving move (a device bool).  ``hub`` sums W in order; the sizes
    are summed in order when ``sizes_exact_below`` is given
    (:func:`_part_sizes`); ``size_max`` ((k,)) and ``w_max`` (()) are
    running maxima that the batch raises in place.  ``active`` ((C,)
    bool, the masked game) limits the moves to its clusters; ``migrate``,
    a ``(move_cost, home)`` pair, adds the migration penalty."""
    k = inputs.k
    w_ip = _batch_w(adj, assign, lo, hi, k, hub)
    part_sizes = _part_sizes(inputs.sizes, assign, k, sizes_exact_below)
    if size_max is not None:
        torch.maximum(size_max, part_sizes, out=size_max)
    if hub:
        torch.maximum(w_max, w_ip.max(), out=w_max)
    sz = inputs.sizes[lo:hi, None]
    cur_p = assign[lo:hi].long()
    onehot = (torch.arange(k, device=assign.device) == cur_p[:, None]).to(torch.float32)
    # hypothetical |p| if i moved to p: current size + s_i when p ≠ P_i
    hyp = part_sizes[None, :] + sz * (1.0 - onehot)
    pen = None if migrate is None else _move_pen(*migrate, lo, hi, k)
    cost, cur = _costs(dk * sz, hyp, degs[lo:hi, None] - w_ip + sz, inv_k, cur_p, pen)
    # the current partition wins cost ties; other ties go to the lowest id
    strictly_better = cost.amin(dim=1) < cur
    best = torch.where(strictly_better, cost.argmin(dim=1), cur_p)
    improves = strictly_better & (best != cur_p)
    if active is not None:
        improves = improves & active[lo:hi]
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
    bits = _random.bits_at(b0, b1, cid.shape[0], cid)
    return _random.bits_to_uniform(bits) < accept_prob


def run_game(inputs: GameInputs, n_clusters: int, *, batch_size: int = 256,
             max_rounds: int = 64, accept_prob: float = 0.7,
             assign0: np.ndarray | None = None, delta=None, seed: int = 0,
             leader_mask=None, move_mask=None, move_cost=None,
             home=None) -> GameResult:
    """Damped best-response dynamics to a pure Nash equilibrium (the
    reference's ``run_game``), on the device of ``inputs.sizes``.  With
    ``leader_mask``, ``move_mask`` or ``move_cost`` given, the masked game
    (module docstring); the other masks default to ``arange(C) < n_head``
    and all movable.  ``move_cost`` charges each cluster for leaving
    ``home`` (default ``assign0``); ``home`` alone is ignored, as in the
    reference."""
    dev = inputs.sizes.device
    C, k, n_head = int(n_clusters), inputs.k, inputs.n_head
    if assign0 is None:
        assign0 = init_assignment(inputs.sizes, k)
    masked = leader_mask is not None or move_mask is not None or move_cost is not None
    migrate = None
    if move_cost is not None:
        home = np.asarray(assign0) if home is None else home
        migrate = (torch.as_tensor(move_cost, dtype=torch.float32, device=dev),
                   torch.as_tensor(home, dtype=torch.int32, device=dev))
    bs = int(batch_size)
    cid = torch.arange(C, dtype=torch.int64, device=dev)
    if masked:
        lead = (np.arange(C) < n_head if leader_mask is None
                else np.asarray(leader_mask, bool))
        move = np.ones(C, bool) if move_mask is None else np.asarray(move_mask, bool)
        # only the windows that hold a movable cluster are worth visiting
        windows = np.unique(np.nonzero(move)[0] // bs)
        if windows.size == 0:  # every player frozen: a no-op equilibrium
            return GameResult(assignment=torch.as_tensor(
                np.asarray(assign0), dtype=torch.int32).to(dev).clone(),
                rounds=0, converged=True)
        stages = []  # (lo, hi, active) per stage, leaders' first
        for role in (lead & move, ~lead & move):
            active = torch.from_numpy(role).to(dev)
            stages += [(int(b) * bs, min(int(b) * bs + bs, C), active)
                       for b in windows if role[int(b) * bs:int(b) * bs + bs].any()]
        leader = torch.from_numpy(lead).to(dev)
        batch = cid // bs
    else:
        n_batches_h = max(1, -(-n_head // bs))
        n_batches_t = max(1, -(-(C - n_head) // bs))
        stages = [(b * bs, min(b * bs + bs, n_head), None) for b in range(n_batches_h)]
        stages += [(n_head + b * bs, min(n_head + b * bs + bs, C), None)
                   for b in range(n_batches_t)]
        stages = [(lo, hi, a) for lo, hi, a in stages if hi > lo]
        leader = cid < n_head
        batch = torch.where(leader, cid // bs, (cid - n_head) // bs)
    degs = _cluster_degrees(inputs, C)
    if delta is None:
        delta = compute_delta(inputs.sizes, degs, k)
    delta = torch.as_tensor(delta, dtype=torch.float32, device=dev)
    inv_k = 1.0 / k
    dk = delta * inv_k
    accept = torch.tensor(accept_prob, dtype=torch.float32, device=dev)
    assign = torch.as_tensor(np.asarray(assign0), dtype=torch.int32).to(dev).clone()
    adj = _adjacency(inputs, C)
    key0 = _random.PRNGKey(seed)

    static = _static_bounds(inputs, C)
    hubs = static.hub_rows
    hub = [bool(np.searchsorted(hubs, lo) < np.searchsorted(hubs, hi))
           for lo, hi, _ in stages]
    w_max = torch.zeros((), dtype=torch.float32, device=dev)
    guard = static.size_limit is not None
    size_max = torch.zeros(k, dtype=torch.float32, device=dev) if guard else None
    ordered_sums = replayed = ordered_rounds = 0
    max_size = 0.0

    def play(lucky, in_order):
        wanted = torch.zeros((), dtype=torch.bool, device=dev)
        for (lo, hi, active), h in zip(stages, hub):  # leaders, then followers
            wanted |= _batch_update(
                inputs, degs, assign, lo, hi, lucky, dk, inv_k, adj, hub=h,
                sizes_exact_below=static.size_limit if in_order else None,
                size_max=size_max, w_max=w_max, active=active, migrate=migrate)
        return wanted

    def read(wanted):
        """``wanted`` and the running size maximum in one transfer."""
        vals = [wanted.to(torch.float32)]
        if size_max is not None:
            vals.append(size_max.max())
        got = torch.stack(vals).tolist()
        return bool(got[0]), (got[1] if size_max is not None else 0.0)

    rounds = 0
    in_order = False  # the round sums the sizes in order from its start
    while True:  # at least one round; the last round's `wanted` decides
        lucky = _acceptance(key0, rounds, leader, batch, cid, accept)
        start = assign.clone() if guard and not in_order else None
        wanted, seen = read(play(lucky, in_order))
        ordered_sums += sum(hub) + (len(stages) if in_order else 0)
        if guard and not in_order and seen >= static.size_limit:  # may have rounded
            assign.copy_(start)
            size_max.zero_()
            in_order = True
            wanted, seen = read(play(lucky, True))
            ordered_sums += sum(hub) + len(stages)
            replayed += 1
        if guard:
            ordered_rounds += in_order
            max_size = max(max_size, seen)  # below the limit, or summed in order: exact
            size_max.zero_()
            # sizes that reached the limit in order: the next round starts in order
            in_order = in_order and seen >= static.size_limit
        rounds += 1
        if not (wanted and rounds < max_rounds):
            break
    return GameResult(assignment=assign, rounds=rounds, converged=not wanted,
                      hub_batches=sum(hub), ordered_sums=ordered_sums,
                      size_guard=guard, replayed_rounds=replayed,
                      ordered_rounds=ordered_rounds,
                      max_part_size=max_size, max_w_hub=float(w_max) if any(hub) else 0.0)


def social_welfare(inputs: GameInputs, assign: torch.Tensor, delta) -> torch.Tensor:
    """S(Λ) of Eq. (5) = δ·Σ|p|²/k + Σ Θ(p, V)/k (Theorem 4 identity)."""
    k = inputs.k
    part_sizes = _segment_sum(inputs.sizes, assign.long(), k)
    assign_ext = torch.cat([assign.long(), assign.new_zeros(1, dtype=torch.long)])
    cut = _xla_sum(inputs.pair_w * (assign_ext[inputs.pair_a.long()]
                                     != assign_ext[inputs.pair_b.long()]).to(torch.float32))
    load = delta * _xla_sum(torch.square(part_sizes)) / k
    comm = (2.0 * cut + _xla_sum(part_sizes)) / k
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
    part_sizes = _segment_sum(sizes, assign.long(), k)
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    hyp = part_sizes[None, :] + sizes[:, None] * (1.0 - onehot)
    # the reference runs this op by op (no jit), so nothing is fused here
    cost = (delta / k) * sizes[:, None] * hyp + (degs[:, None] - w_ip + sizes[:, None]) / k
    cur = cost.gather(1, assign.long()[:, None])[:, 0]
    return torch.max(cur - cost.amin(dim=1))
