"""Edge-stream engine of the port: chunked replayable streams (in memory
and out of core, from disk shards), sliding windows, the carry protocol
and its merge algebra, the sequential drivers and parallel ingest."""

from .carry import (  # noqa: F401
    CARRY_REPR,
    COUNTED,
    MAX,
    OR,
    REPLICATED,
    SUM,
    FnCarry,
    PartitionerCarry,
    RetractCarry,
)
from .engine import (  # noqa: F401
    as_stream,
    run_carry,
    run_retract,
    run_scan,
    run_scan_batched,
    stack_carries,
)
from .parallel import (  # noqa: F401
    IngestStats,
    LaneStats,
    ParallelEdgeStream,
    last_ingest_stats,
    reset_cadence_log,
    run_parallel,
)
from .oocstream import (  # noqa: F401
    BudgetExceededError,
    HostBudget,
    ShardedEdgeStream,
    append_shards,
    read_manifest,
    write_shards,
)
from .stream import DEFAULT_CHUNK, ORDERINGS, Chunk, EdgeStream  # noqa: F401
from .window import SlidingWindowStream, WindowEvent  # noqa: F401

__all__ = ["Chunk", "EdgeStream", "DEFAULT_CHUNK", "ORDERINGS", "as_stream",
           "run_carry", "run_retract", "run_scan", "run_scan_batched",
           "stack_carries", "PartitionerCarry", "FnCarry", "RetractCarry",
           "SUM", "COUNTED", "OR", "MAX", "REPLICATED", "CARRY_REPR",
           "ParallelEdgeStream", "run_parallel", "IngestStats", "LaneStats",
           "last_ingest_stats", "reset_cadence_log", "ShardedEdgeStream",
           "HostBudget", "BudgetExceededError", "write_shards",
           "append_shards", "read_manifest", "SlidingWindowStream",
           "WindowEvent"]
