"""Edge-stream engine of the port: chunked replayable streams, the carry
protocol, and the sequential drivers."""

from .carry import PartitionerCarry  # noqa: F401
from .engine import as_stream, run_carry, run_retract  # noqa: F401
from .stream import DEFAULT_CHUNK, ORDERINGS, Chunk, EdgeStream  # noqa: F401
