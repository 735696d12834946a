"""K5 (segment aggregation, GNN message passing): CUDA kernel in
``csrc/segment_agg.cu``, wrapper in ``kernel``, layout and entry point in
``ops``, plain version in ``ref``."""

from .kernel import launch_counts, reset_launch_counts, segment_agg  # noqa: F401
from .ops import SegmentLayout, segment_aggregate, segment_layout  # noqa: F401
from .ref import segment_agg_ref  # noqa: F401
