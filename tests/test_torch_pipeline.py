"""Port parity: ``repro_torch.data.pipeline`` against the live reference's
``repro.data.pipeline``: the same batches for the same (seed, step), edge
chunks over arrays, a stream or a shard manifest, and the Prefetcher's
stop, restart and worker-death contract."""

import time

import numpy as np
import pytest
import torch
from proptest import random_graph

import repro.data.pipeline as jpipe
from repro_torch.data import EdgeChunkPipeline, Prefetcher, RecsysPipeline, TokenPipeline
from repro_torch.streaming import ShardedEdgeStream, write_shards


@pytest.mark.parametrize("step", [0, 3])
def test_token_batches_equal_the_reference(step):
    got = TokenPipeline(101, 3, 9, seed=4, device="cpu")(step)
    want = jpipe.TokenPipeline(101, 3, 9, seed=4)(step)
    for key in ("tokens", "targets"):
        assert got[key].dtype == torch.int32 and got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))

def _recsys_reference(vocabs, batch, seed, step):
    """``repro.data.pipeline.RecsysPipeline.__call__``'s statements with the
    hash in int64, as numpy 1 promotes it: under numpy 2 the reference's
    int32 product raises OverflowError (ROADMAP Queue 3 k)."""
    rng = np.random.default_rng((seed, step))
    ids = np.stack([(rng.zipf(1.3, batch) % v).astype(np.int32) for v in vocabs], axis=1)
    h = (ids[:, 0].astype(np.int64) * 2654435761 % 97) / 97.0
    return ids, (rng.random(batch) < 0.15 + 0.5 * h).astype(np.float32)


@pytest.mark.parametrize("step", [0, 3])
def test_recsys_batches_equal_the_reference_statements(step):
    got = RecsysPipeline((10, 1000, 7), 33, seed=2, device="cpu")(step)
    ids, labels = _recsys_reference((10, 1000, 7), 33, 2, step)
    np.testing.assert_array_equal(got["field_ids"].numpy(), ids)
    np.testing.assert_array_equal(got["labels"].numpy(), labels)
    assert 0 < labels.sum() < labels.size


def test_edge_chunk_pipeline_over_arrays_stream_and_path(tmp_path):
    src, dst, n, _ = random_graph(0)
    man = write_shards(tmp_path, src, dst, shard_edges=23, n_vertices=n)
    kw = dict(chunk_size=31, ordering="shuffled", seed=4)
    mem = EdgeChunkPipeline(src, dst, n, device="cpu", **kw)
    via_path = EdgeChunkPipeline(f"file:{man}", device="cpu", **kw)
    via_dir = EdgeChunkPipeline(tmp_path, device="cpu", **kw)
    via_stream = EdgeChunkPipeline(ShardedEdgeStream(man, device="cpu", **kw))
    ref = jpipe.EdgeChunkPipeline(src, dst, n, **kw)
    nc = mem.stream.n_chunks
    for step in (0, 2, nc + 1):
        a, b, c, d, r = (p(step) for p in (mem, via_path, via_dir, via_stream, ref))
        for x in (b, c, d):
            assert torch.equal(a["src"], x["src"]) and torch.equal(a["dst"], x["dst"])
            assert (a["start"], a["n_valid"], a["epoch"]) == (x["start"], x["n_valid"], x["epoch"])
        np.testing.assert_array_equal(a["src"].numpy(), np.asarray(r["src"]))
        assert (a["start"], a["n_valid"], a["epoch"]) == (r["start"], r["n_valid"], r["epoch"])
    assert mem(nc + 1)["epoch"] == 1
    with pytest.raises(ValueError):
        EdgeChunkPipeline(f"file:{man}", dst, n, device="cpu")
    with pytest.raises(ValueError):
        EdgeChunkPipeline(mem.stream, dst)


def test_prefetcher_pages_from_disk(tmp_path):
    """Prefetched out-of-core chunks equal the direct ones; stop ends the
    worker."""
    src, dst, n, _ = random_graph(1)
    man = write_shards(tmp_path, src, dst, shard_edges=23, n_vertices=n)
    pipe = EdgeChunkPipeline(str(man), chunk_size=17, device="cpu")
    pf = Prefetcher(pipe, depth=2)
    pf.start(0)
    try:
        for step in range(min(pipe.stream.n_chunks, 4)):
            assert torch.equal(pf(step)["src"], pipe(step)["src"])
    finally:
        pf.stop()
    assert pf._thread is None


def test_prefetcher_stop_unblocks_a_full_queue_and_restarts():
    def fn(step):
        return {"step": step}

    p = Prefetcher(fn, depth=1)
    p.start(0)
    deadline = time.time() + 5.0
    while not p._q.full() and time.time() < deadline:  # a consumer that never reads
        time.sleep(0.01)
    assert p._q.full()
    worker = p._thread
    p.stop()
    worker.join(timeout=2.0)
    assert not worker.is_alive()
    p.start(10)  # a restart from another step serves fresh batches
    assert p(10)["step"] == 10 and p(11)["step"] == 11
    assert p(5)["step"] == 5  # a seek backwards is built directly
    worker2 = p._thread
    p.stop()
    assert not worker2.is_alive() and p._thread is None
    assert p(3)["step"] == 3  # stopped: built directly
    p.stop()  # idempotent


def test_prefetcher_worker_death_raises_instead_of_hanging():
    def fn(step):
        if step >= 2:
            raise ValueError(f"shard vanished at step {step}")
        return {"step": step}

    p = Prefetcher(fn, depth=1)
    p.start(0)
    try:
        assert p(0)["step"] == 0 and p(1)["step"] == 1
        with pytest.raises(RuntimeError, match="prefetch worker died") as ei:
            p(2)
        assert isinstance(ei.value.__cause__, ValueError)
    finally:
        p.stop()
