"""K5 (segment aggregation, GNN message passing): CUDA kernel in
``csrc/segment_agg.cu``, wrapper in ``kernel``, layout and entry point in
``ops``, plain version in ``ref``."""

from .kernel import (kernel_attributes, launch_counts, reset_launch_counts,  # noqa: F401
                     segment_agg, tree_exact)
from .ops import LONG_ROW_EDGES, SegmentLayout, segment_aggregate, segment_layout  # noqa: F401
from .ref import segment_agg_ref  # noqa: F401
