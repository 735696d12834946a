"""Elastic k→k′ re-partitioning with bounded migration (the port of
``repro.elastic``).

- :func:`reshard_bundle` maps an S5P carry bundle onto a new partition
  count: every edge whose partition survives keeps its placement; only
  the displaced remainder (partitions ≥ k′ on shrink, plus the edges of
  clusters the migration-cost game relocates) is placed again.
- :func:`reshard_scan_carry` does the same for the Greedy/HDRF scan
  carries: grow pads the k columns, shrink retracts the displaced edges
  and scans only them again at k′.
- :func:`reshard_carry` dispatches on what it is handed.

``S5PWindowChain.resize`` and ``ServingController.resize`` (an atomic
bundle swap) put it in front of users; ``runtime.ElasticController``
calls it in place of a cold re-partition.
"""

from .reshard import (  # noqa: F401
    ReshardResult,
    reshard_bundle,
    reshard_carry,
    reshard_scan_carry,
)

__all__ = ["ReshardResult", "reshard_bundle", "reshard_scan_carry",
           "reshard_carry"]
