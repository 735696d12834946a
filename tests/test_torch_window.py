"""Port parity: ``repro_torch.streaming.window.SlidingWindowStream`` against
the live reference's, in memory and paged from disk shards.  Its consumers
(decremental partitioning) come with ``incremental/``."""

import numpy as np
import pytest
from proptest import random_graph

import repro.streaming as js
from repro_torch.streaming import (EdgeStream, ShardedEdgeStream, SlidingWindowStream,
                                   WindowEvent, write_shards)


def _events_equal(a: WindowEvent, b) -> None:
    for field in WindowEvent._fields:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, field
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=field)
        else:
            assert x == y, field
    assert a.window_edges == b.window_edges


@pytest.mark.parametrize("on_disk", [False, True])
@pytest.mark.parametrize("window, step", [(48, 16), (40, None), (1, 1), (500, 7)])
def test_window_events_equal_the_reference(tmp_path, on_disk, window, step):
    src, dst, n, _ = random_graph(1)
    man = write_shards(tmp_path, src, dst, shard_edges=32, n_vertices=n)
    if on_disk:
        port = ShardedEdgeStream(man, chunk_size=24, device="cpu")
        ref = js.ShardedEdgeStream(man, chunk_size=24)
    else:
        port = EdgeStream(src, dst, n, chunk_size=24, device="cpu")
        ref = js.EdgeStream(src, dst, n, chunk_size=24)
    a = SlidingWindowStream(port, window, step_edges=step)
    b = js.SlidingWindowStream(ref, window, step_edges=step)
    assert (a.n_steps, a.step_edges, a.n_edges) == (b.n_steps, b.step_edges, b.n_edges)
    evs_a, evs_b = list(a.events()), list(b.events())
    assert len(evs_a) == len(evs_b) == a.n_steps
    for x, y in zip(evs_a, evs_b):
        _events_equal(x, y)
    if on_disk:
        port.close()
        ref.close()


def test_window_events_cover_the_stream_fifo():
    """Inserts cover the stream once in arrival order, expiry is FIFO, and
    the live window is the last W arrivals (fewer while filling)."""
    src, dst, n, _ = random_graph(1)
    sw = SlidingWindowStream(EdgeStream(src, dst, n, device="cpu"), 40, step_edges=16)
    seen, expired = [], []
    for ev in sw.events():
        assert ev.start == len(seen)
        seen.extend(range(ev.start, ev.hi))
        np.testing.assert_array_equal(ev.src, src[ev.start:ev.hi])
        np.testing.assert_array_equal(ev.expire_src, src[ev.expire_idx])
        np.testing.assert_array_equal(ev.expire_dst, dst[ev.expire_idx])
        expired.extend(ev.expire_idx.tolist())
        assert ev.hi - ev.lo == min(ev.hi, 40)
        assert expired == list(range(ev.lo))
    assert seen == list(range(len(src)))


def test_window_stream_validation(tmp_path):
    src, dst, n, _ = random_graph(0)
    st = EdgeStream(src, dst, n, device="cpu")
    with pytest.raises(ValueError, match="window_edges"):
        SlidingWindowStream(st, 0)
    with pytest.raises(ValueError, match="step_edges"):
        SlidingWindowStream(st, 8, step_edges=0)
    assert SlidingWindowStream(st, 8).step_edges == 8
    with pytest.raises(ValueError, match="arrival order"):
        SlidingWindowStream(EdgeStream(src, dst, n, ordering="shuffled", device="cpu"), 8)
    man = write_shards(tmp_path, src, dst, shard_edges=13, n_vertices=n)
    with ShardedEdgeStream(man, ordering="windowed", device="cpu") as ooc:
        with pytest.raises(ValueError, match="arrival order"):
            SlidingWindowStream(ooc, 8)
