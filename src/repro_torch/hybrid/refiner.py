"""In-memory core refinement and the core-aware streamed tail carry (the
port of ``repro.hybrid.refiner``).

- :func:`place_core` / :func:`refine_core_game`: the retained high-degree
  core is held resident (host numpy records, :class:`CoreBuffer`) and
  refined with passes of the masked Stackelberg game (``core.game``: only
  the clusters the core level touches may move, its sums on K5 on the
  card); each candidate is placed by Alg. 3 over the resident records
  (K2, one launch a chunk of at most ``chunk_size`` records);
- :class:`TailAssignCarry`: the streamed remainder.  It is the standard
  :class:`~repro_torch.core.postprocess.AssignCarry` (the ``(k,)`` load
  carry, SUM merge, so ``run_parallel`` lanes work unchanged) except that
  the per-edge extras (head flag, endpoint clusters) are derived inside
  the chunk step from device-resident O(|V|) tables, and the resident
  core's edges are rewritten to ``(0, 0)`` self-loops: K2 gives them part
  −1 and charges no load.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import game as _game
from ..core.postprocess import AssignCarry
from ..streaming import EdgeStream, run_carry

__all__ = [
    "CoreBuffer",
    "TailAssignCarry",
    "core_move_mask",
    "place_core",
    "refine_core_game",
]


class CoreBuffer(NamedTuple):
    """Resident records of the spilled high-degree core (host numpy, the
    reference's dtypes, so :meth:`nbytes` is 29 bytes a record).

    ``arrival`` is each edge's index in the arrival-ordered edge list, so
    core placements scatter straight into the final parts vector;
    ``deg_min`` lets one spill at ξ* serve every refinement level ℓ ≥ ξ*
    by masking (``deg_min > ℓ``).
    """

    src: np.ndarray       # (M,) int32
    dst: np.ndarray       # (M,) int32
    arrival: np.ndarray   # (M,) int64, position in arrival order
    cu: np.ndarray        # (M,) int32, endpoint cluster (combined id)
    cv: np.ndarray        # (M,) int32
    deg_min: np.ndarray   # (M,) int32, min(deg(u), deg(v))
    head: np.ndarray      # (M,) bool, Alg. 3 head-edge flag

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self)

    def select(self, mask: np.ndarray) -> "CoreBuffer":
        return CoreBuffer(*(a[mask] for a in self))


class TailAssignCarry(AssignCarry):
    """Alg. 3 over the streamed tail of a hybrid run.

    Extras are computed per chunk from resident tables on ``c2p``'s
    device (exact degrees and the compacted head/tail cluster maps), and
    core edges (both endpoint degrees above ``core_threshold``) are
    rewritten to ``(0, 0)`` self-loops after tagging, so the scan treats
    them as padding.  The merge contract is inherited (load vector, SUM).
    """

    def __init__(self, k: int, max_load: int, c2p, *, degrees, v2c_h,
                 v2c_t, xi: int, core_threshold: int):
        super().__init__(k, max_load, c2p)
        dev = self.c2p.device
        self.degrees = torch.as_tensor(degrees).to(dev, torch.int32)
        self.v2c_h = torch.as_tensor(v2c_h).to(dev, torch.int32)
        self.v2c_t = torch.as_tensor(v2c_t).to(dev, torch.int32)
        self.xi = int(xi)
        self.core_threshold = int(core_threshold)

    def _tag_chunk(self, src, dst):
        s, d = src.long(), dst.long()
        deg_u = self.degrees[s]
        deg_v = self.degrees[d]
        is_core = (deg_u > self.core_threshold) & (deg_v > self.core_threshold)
        h = (deg_u > self.xi) & (deg_v > self.xi)
        cu = torch.where(h, self.v2c_h[s], self.v2c_t[s])
        cv = torch.where(h, self.v2c_h[d], self.v2c_t[d])
        return is_core, h, cu.clamp(min=0), cv.clamp(min=0)

    def _mask_core(self, src, dst, is_core):
        zero = torch.zeros_like(src)
        return torch.where(is_core, zero, src), torch.where(is_core, zero, dst)

    def step_chunk(self, carry, src, dst, n_valid, *extras):
        is_core, h, cu, cv = self._tag_chunk(src, dst)
        src, dst = self._mask_core(src, dst, is_core)
        return super().step_chunk(carry, src, dst, n_valid, h, cu, cv)

    def retract_chunk(self, carry, src, dst, n_valid, parts, *extras):
        is_core = self._tag_chunk(src, dst)[0]
        src, dst = self._mask_core(src, dst, is_core)
        return super().retract_chunk(carry, src, dst, n_valid, parts)


def place_core(core: CoreBuffer, c2p, k: int, max_load: int,
               n_vertices: int, *, chunk_size: int = 1 << 16, device=None):
    """Place the resident core records under Alg. 3 (K2 on the card), on
    ``device`` (default the card).

    Returns ``(parts, load)``: host int32 parts for the core edges in
    buffer order and the ``(k,)`` int32 load tensor, which then seeds the
    tail pass so both halves share one capacity L.
    """
    dev = resolve_device(device)
    if core.n_edges == 0:
        return np.zeros(0, np.int32), torch.zeros((int(k),), dtype=torch.int32, device=dev)
    stream = EdgeStream(core.src, core.dst, n_vertices,
                        chunk_size=min(chunk_size, max(core.n_edges, 1)), device=dev)
    pc = AssignCarry(k, max_load, torch.as_tensor(np.asarray(c2p, np.int32)).to(dev))
    parts, load = run_carry(
        stream, pc,
        torch.from_numpy(np.asarray(core.head, bool)).to(dev),
        torch.from_numpy(np.maximum(np.asarray(core.cu, np.int32), 0)).to(dev),
        torch.from_numpy(np.maximum(np.asarray(core.cv, np.int32), 0)).to(dev))
    return parts.cpu().numpy().astype(np.int32), load


def core_move_mask(core: CoreBuffer, n_clusters: int) -> np.ndarray:
    """Movable-player mask: clusters with at least one resident core edge.

    The refinement game at a ladder level frees exactly the clusters that
    level's core touches; the rest of the equilibrium is frozen context.
    """
    mask = np.zeros(int(n_clusters), bool)
    for c in (core.cu, core.cv):
        c = np.asarray(c)
        c = c[(c >= 0) & (c < n_clusters)]
        mask[c] = True
    return mask


def refine_core_game(inputs: "_game.GameInputs", n_clusters: int, c2p,
                     *, leader_mask, move_mask, rounds: int,
                     accept_prob: float, seed: int,
                     batch_size: int) -> "_game.GameResult":
    """One masked-game refinement pass over the resident core's clusters,
    on the device of ``inputs``: ``assign0`` is the incumbent map, only
    ``move_mask`` players deviate, and the leader/follower split comes
    from the combined-id head mask."""
    bs = _game.default_batch_size(batch_size, n_clusters)
    return _game.run_game(
        inputs, n_clusters,
        batch_size=bs, max_rounds=max(int(rounds), 1),
        accept_prob=accept_prob, assign0=np.asarray(c2p, np.int32),
        seed=seed, leader_mask=np.asarray(leader_mask, bool),
        move_mask=np.asarray(move_mask, bool))
