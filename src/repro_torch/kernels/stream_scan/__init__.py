"""K1 (Alg. 1 fold), K2 (Alg. 3 placement), K3 (Greedy/HDRF scoring scan)
and G1 (grid scan): CUDA kernels in ``csrc/``, wrappers in ``kernel``,
plain versions, the staged tile plans and the scoring oracles in ``ref``,
tile sizes in ``plan``, latency bounds in ``latency``, the scoring carries
in ``ops``."""

from .kernel import (  # noqa: F401
    assign_scan,
    cluster_scan,
    grid_scan,
    launch_counts,
    reset_launch_counts,
    scoring_scan,
)
from .ops import (  # noqa: F401
    SHARED_MEM_BYTES,
    GreedyCarry,
    GridCarry,
    HdrfCarry,
    cluster_state_bytes,
    make_chunk_fn,
    reset_path_log,
    scoring_state_bytes,
    select_path,
)
from .ref import (  # noqa: F401
    assign_chunk_oracle,
    cluster_chunk_oracle,
    cluster_chunk_staged,
    grid_chunk,
    grid_chunk_oracle,
    grid_init,
    grid_retract_chunk,
    greedy_chunk,
    greedy_init,
    greedy_retract_chunk,
    hdrf_chunk,
    hdrf_init,
    hdrf_retract_chunk,
    scoring_chunk_oracle,
    scoring_chunk_staged,
)
