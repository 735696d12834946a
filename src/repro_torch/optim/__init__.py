"""The optimizer of the training path (port of ``repro.optim``): AdamW
with float32 moments and global-norm clipping, LR schedules, and gradient
compression."""

from .adamw import AdamWConfig, TrainState, adamw_update, init_state, make_train_step  # noqa: F401
from .grad_compress import (CompressState, init_compress_state, int8_compress,  # noqa: F401
                            int8_decompress, topk_compress_update)
from .schedules import cosine_schedule, linear_warmup  # noqa: F401
