"""Port parity: Alg. 1 clustering (repro_torch.core.clustering and the K1
plain version) against repro's lax.scan and its Pallas kernel in
interpret mode, leaf by leaf, with exact equality."""

import numpy as np
import pytest
import torch
from proptest import random_graph

from repro.core import clustering as jcl
from repro.kernels.stream_scan import cluster_scan as pallas_cluster_scan
from repro.streaming import EdgeStream as JaxStream
from repro_torch import interop
from repro_torch.core import clustering as tcl
from repro_torch.kernels.stream_scan import cluster_chunk_oracle, cluster_scan

XI, KAPPA, CHUNK = 3, 50, 64


def _assert_state_equal(ref, port, where):
    for name, a, b in zip(tcl.ClusterState._fields, ref, port):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{where}: leaf {name}")


@pytest.mark.parametrize("global_tail", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_cluster_chunk_matches_reference_and_pallas(seed, global_tail):
    src, dst, n, _ = random_graph(seed)
    deg = jcl.compute_degrees(src, dst, n)
    deg_t = torch.from_numpy(np.array(deg))
    kw = dict(xi=XI, kappa=KAPPA, global_tail=global_tail)
    ref = jcl.init_state(n)
    pallas = tuple(jcl.init_state(n))
    port = interop.cluster_state(jcl.init_state(n), device="cpu")
    for i, ch in enumerate(JaxStream(src, dst, n, chunk_size=CHUNK).chunks()):
        ref = jcl.cluster_chunk(ref, ch.src, ch.dst, deg, **kw)
        pallas = pallas_cluster_scan(pallas, ch.src, ch.dst, deg, interpret=True, **kw)
        s = torch.from_numpy(np.asarray(ch.src))
        d = torch.from_numpy(np.asarray(ch.dst))
        port = tcl.cluster_chunk(port, s, d, deg_t, **kw)
        _assert_state_equal(ref, port, f"seed {seed} chunk {i} vs lax.scan")
        _assert_state_equal(pallas, port, f"seed {seed} chunk {i} vs Pallas")
    # the wrapper's CPU route is the same plain version
    again = interop.cluster_state(jcl.init_state(n), device="cpu")
    s = torch.from_numpy(src)
    d = torch.from_numpy(dst)
    full = cluster_scan(tuple(again), s, d, deg_t, **kw)
    oracle = cluster_chunk_oracle(tuple(interop.cluster_state(jcl.init_state(n), device="cpu")),
                                  s, d, deg_t, **kw)
    for a, b in zip(full, oracle):
        assert torch.equal(a, b)


@pytest.mark.parametrize("global_tail", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_cluster_stream_and_compaction_match(seed, global_tail):
    src, dst, n, _ = random_graph(seed)
    kw = dict(xi=XI, kappa=KAPPA, chunk_size=CHUNK, global_tail=global_tail)
    ref = jcl.cluster_stream(src, dst, n, **kw)
    port = tcl.cluster_stream(src, dst, n, device="cpu", **kw)
    _assert_state_equal(ref, port, f"seed {seed} cluster_stream")
    deg = jcl.compute_degrees(src, dst, n)
    deg_t = tcl.compute_degrees(torch.from_numpy(src), torch.from_numpy(dst), n)
    np.testing.assert_array_equal(np.asarray(deg), deg_t.numpy())
    rres = jcl.compact_clusters(ref, deg, XI)
    pres = tcl.compact_clusters(port, deg_t, XI)
    assert (rres.n_head, rres.n_clusters) == (pres.n_head, pres.n_clusters)
    for name in ("v2c", "v2c_h", "v2c_t", "is_head_vertex"):
        np.testing.assert_array_equal(np.asarray(getattr(rres, name)),
                                      getattr(pres, name).numpy(), err_msg=name)


def test_bounded_kappa_wraps_like_int32():
    """S5P-B: κ = 2³¹−1 makes ``vol + d < κ`` int32 arithmetic that wraps."""
    src, dst, n, _ = random_graph(1)
    kw = dict(xi=1, kappa=2**31 - 1, chunk_size=CHUNK, global_tail=True)
    ref = jcl.cluster_stream(src, dst, n, **kw)
    port = tcl.cluster_stream(src, dst, n, device="cpu", **kw)
    _assert_state_equal(ref, port, "bounded")


def test_degree_carry_masks_padding():
    src, dst, n, _ = random_graph(0)
    from repro_torch.streaming import EdgeStream, run_carry, run_retract

    stream = EdgeStream(src, dst, n, chunk_size=7, device="cpu")
    dc = tcl.DegreeCarry(n, device="cpu")
    _, deg = run_carry(stream, dc)
    want = tcl.compute_degrees(torch.from_numpy(src), torch.from_numpy(dst), n)
    assert torch.equal(deg, want)
    assert int(run_retract(stream, dc, None, carry=deg).abs().sum()) == 0


def test_parallel_options_raise():
    src, dst, n, _ = random_graph(0)
    with pytest.raises(NotImplementedError, match="slice 4"):
        tcl.cluster_stream(src, dst, n, xi=XI, kappa=KAPPA, num_streams=2,
                           device="cpu")
