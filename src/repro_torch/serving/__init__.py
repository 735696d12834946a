"""Serving, the read side: versioned bundles, the RCU registry and the GAS
server (GCN inference included).  ``ServingController`` (the writer side)
waits for the incremental window chain."""

from .bundle import BundleRegistry, PartitionBundle, build_bundle  # noqa: F401
from .server import GASServer, ServingMetrics, SuperstepRecord  # noqa: F401

__all__ = [
    "BundleRegistry",
    "GASServer",
    "PartitionBundle",
    "ServingMetrics",
    "SuperstepRecord",
    "build_bundle",
]
