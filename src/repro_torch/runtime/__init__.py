"""The runtime of the port: the fault-tolerant loop and the lane fault
injector, straggler detection (with the parallel-ingest handoff) and the
elastic controller (the port of ``repro.runtime``)."""

from .elastic import ElasticController, ElasticPartition  # noqa: F401
from .fault import FaultInjector, FaultTolerantLoop, LaneFaultInjector  # noqa: F401
from .straggler import StragglerMonitor  # noqa: F401

__all__ = ["ElasticController", "ElasticPartition", "FaultInjector",
           "FaultTolerantLoop", "LaneFaultInjector", "StragglerMonitor"]
