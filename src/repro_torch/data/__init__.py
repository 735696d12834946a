"""Step-addressable data pipelines and the host prefetcher."""

from .pipeline import EdgeChunkPipeline, Prefetcher, RecsysPipeline, TokenPipeline  # noqa: F401

__all__ = ["TokenPipeline", "RecsysPipeline", "EdgeChunkPipeline", "Prefetcher"]
