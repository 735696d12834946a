"""Live partition serving: versioned bundles and the RCU registry, the
GAS server (GCN inference included) and the ingest controller that
publishes each churn step, cold restart and resize as an atomic swap."""

from .bundle import BundleRegistry, PartitionBundle, build_bundle  # noqa: F401
from .controller import ServingController  # noqa: F401
from .server import GASServer, ServingMetrics, SuperstepRecord  # noqa: F401

__all__ = [
    "BundleRegistry",
    "GASServer",
    "PartitionBundle",
    "ServingController",
    "ServingMetrics",
    "SuperstepRecord",
    "build_bundle",
]
