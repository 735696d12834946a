"""K1 (Alg. 1 fold) and K2 (Alg. 3 placement): CUDA kernels in
``csrc/stream_scan.cu``, wrappers in ``kernel``, plain versions in ``ref``."""

from .kernel import (  # noqa: F401
    assign_scan,
    cluster_scan,
    launch_counts,
    reset_launch_counts,
)
from .ref import assign_chunk_oracle, cluster_chunk_oracle  # noqa: F401
