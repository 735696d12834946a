"""K7 (the xDeepFM CIN layer): CUDA kernel in ``csrc/cin.cu``, wrapper in
``kernel``, entry point in ``ops``, plain version in ``ref``."""

from .kernel import cin_layer, launch_counts, plan, reset_launch_counts  # noqa: F401
from .ops import cin_layer_kernel  # noqa: F401
from .ref import cin_layer_ref, cin_split_partials  # noqa: F401
