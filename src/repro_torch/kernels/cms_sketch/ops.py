"""Drop-in ``CMSketch`` ops backed by K4a/K4b, the counterpart of
``repro.kernels.cms_sketch.ops``: a sketch in, a new sketch (or the
estimates) out.  The update copies the table and adds into the copy in
one launch."""

from __future__ import annotations

from .kernel import cms_add, cms_query

__all__ = ["cms_update_kernel", "cms_query_kernel"]


def cms_update_kernel(sketch, keys, counts=None):
    """A new sketch with ``counts`` (default 1, may be negative) added at
    ``keys``, wrapping in ℤ/2³²."""
    table = cms_add(sketch.table.clone(), keys, sketch.seeds, counts)
    return sketch._replace(table=table)


def cms_query_kernel(sketch, keys):
    """Point query: min over rows (unsigned), as int64 holding uint32."""
    return cms_query(sketch.table, keys, sketch.seeds)
