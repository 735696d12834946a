"""Incremental re-partitioning of the port: carry checkpoints, delta
streams, deletions, drift-triggered game refinement and sliding windows
(the port of ``repro.incremental``).

A warm start replays only the new edges against retained partitioner
state: ``run_carry`` (or ``run_parallel``) seeded with a restored carry
instead of ``init()``.  The carries' merge ops are the laws of the replay:
SUM fields add the delta's state (and subtract a deletion's, since the
group has inverses: ``retract_chunk`` / :func:`~repro_torch.streaming.
run_retract`), COUNTED occupancy counters subtract exactly to 0 when an
edge's last replica goes, REPLICATED fields are constants the
:class:`CarryStore`'s config fingerprint guards.  Degrees, the Θ sketch,
Alg. 1 under frozen ξ/κ/degrees, Greedy, grid and Alg. 3 compose exactly
(fold(fold(init, prefix), delta) == fold(init, prefix + delta) bit for
bit); HDRF and the pipeline-level S5P warm start approximately, and the
:class:`DriftMonitor` decides when a bounded masked Stackelberg game
re-settles the touched clusters.

On the card every fold runs in the kernels of the cold path: K1 (Alg. 1),
K2 (Alg. 3), K3 and G1 (the scan partitioners; K3 also retracts), K4a/K4b
(the Θ sketch; K4a with negative counts retracts) and K5 (the games' sums).

Pieces: :class:`CarryStore` (validated atomic npz + CRC persistence, the
reference's file format), :class:`DeltaStream` / :func:`run_incremental_carry`
/ :func:`grow_carry`, :class:`DriftMonitor`, the S5P bundle of
:mod:`~repro_torch.incremental.pipeline`, and the drivers of
:mod:`~repro_torch.incremental.driver` (the CLI's ``--save-carry`` /
``--resume-carry`` / ``--delta`` / ``--delete`` / ``--window-edges``).
"""

from .delta import DeltaStream, grow_carry, run_incremental_carry  # noqa: F401
from .drift import DriftDecision, DriftMonitor, RefreshDecision  # noqa: F401
from .driver import (  # noqa: F401
    INCREMENTAL_PARTITIONERS,
    SCAN_PARTITIONERS,
    S5PWindowChain,
    WindowStep,
    cold_start,
    run_incremental,
    s5p_sliding_window,
)
from .pipeline import (  # noqa: F401
    JOURNAL_PREFIX,
    IncrementalResult,
    compact_bundle,
    compact_edge_slots,
    ensure_slot_index,
    pack_warm_bundle,
    s5p_apply_delta,
    s5p_apply_deletion,
    s5p_cold_bundle,
    s5p_cold_restart,
    s5p_identity_config,
)
from .store import CarryMismatchError, CarryStore, config_fingerprint  # noqa: F401

__all__ = [
    "CarryStore",
    "CarryMismatchError",
    "config_fingerprint",
    "DeltaStream",
    "run_incremental_carry",
    "grow_carry",
    "DriftMonitor",
    "DriftDecision",
    "RefreshDecision",
    "IncrementalResult",
    "s5p_cold_bundle",
    "pack_warm_bundle",
    "s5p_apply_delta",
    "s5p_apply_deletion",
    "s5p_cold_restart",
    "compact_bundle",
    "compact_edge_slots",
    "ensure_slot_index",
    "s5p_identity_config",
    "cold_start",
    "run_incremental",
    "s5p_sliding_window",
    "S5PWindowChain",
    "WindowStep",
    "SCAN_PARTITIONERS",
    "INCREMENTAL_PARTITIONERS",
]
