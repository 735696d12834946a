"""Port parity: Alg. 3 placement (repro_torch.core.postprocess and the K2
plain version) against repro's lax.scan and its Pallas kernel in
interpret mode, with exact equality; retraction is the exact inverse."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from proptest import random_graph

from repro.core import postprocess as jpost
from repro.kernels.stream_scan import assign_scan as pallas_assign_scan
from repro.streaming import EdgeStream as JaxStream
from repro_torch import interop
from repro_torch.core import postprocess as tpost
from repro_torch.kernels.stream_scan import assign_chunk_oracle, assign_scan
from repro_torch.streaming import EdgeStream, run_carry, run_retract


def _inputs(seed, k):
    src, dst, n, _ = random_graph(seed)
    rng = np.random.default_rng(seed + 10 * k)
    n_clusters = max(n // 3, 1)
    cu = rng.integers(0, n_clusters, src.size).astype(np.int32)
    cv = rng.integers(0, n_clusters, src.size).astype(np.int32)
    head = rng.random(src.size) < 0.4
    c2p = rng.integers(0, k, n_clusters).astype(np.int32)
    # a tight cap drives the overflow branches (first/last room, argmin)
    max_load = max(int(np.ceil(0.9 * src.size / k)), 1)
    return src, dst, n, head, cu, cv, c2p, max_load


@pytest.mark.parametrize("k", [3, 8, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_edges_stream_matches(seed, k):
    src, dst, n, head, cu, cv, c2p, max_load = _inputs(seed, k)
    ref_parts, ref_load = jpost.assign_edges_stream(
        src, dst, jnp.asarray(head), jnp.asarray(cu), jnp.asarray(cv),
        jnp.asarray(c2p), k, max_load, chunk_size=64)
    c2p_t, _ = interop.placement(c2p, np.zeros(k, np.int32), device="cpu")
    parts, load = tpost.assign_edges_stream(
        src, dst, torch.from_numpy(head), torch.from_numpy(cu),
        torch.from_numpy(cv), c2p_t, k, max_load, chunk_size=64, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref_parts), parts.numpy())
    np.testing.assert_array_equal(np.asarray(ref_load), load.numpy())
    assert int(load.max()) <= max(max_load, int(np.ceil(src.size / k)))


@pytest.mark.parametrize("k", [3, 8, 32])
def test_chunks_match_pallas_insert_and_retract(k):
    src, dst, n, head, cu, cv, c2p, max_load = _inputs(3, k)
    stream = JaxStream(src, dst, n, chunk_size=64)
    load_ref = jnp.zeros((k,), jnp.int32)
    load = torch.zeros(k, dtype=torch.int32)
    for ch in stream.chunks(head, c2p[cu], c2p[cv]):
        h, a, b = ch.extras
        p_ref, load_ref = pallas_assign_scan(load_ref, ch.src, ch.dst, h, a, b,
                                             max_load=max_load, interpret=True)
        t = [torch.from_numpy(np.asarray(x)) for x in (ch.src, ch.dst, h, a, b)]
        p, load = assign_scan(load, *t, max_load=max_load)
        np.testing.assert_array_equal(np.asarray(p_ref), p.numpy())
        np.testing.assert_array_equal(np.asarray(load_ref), load.numpy())
        # retract the chunk on both sides: the contract's sign = -1 path
        z = jnp.zeros_like(ch.src)
        _, back_ref = pallas_assign_scan(load_ref, ch.src, ch.dst, z, z, z,
                                         max_load=max_load, sign=-1,
                                         parts=p_ref, n_valid=ch.n_valid,
                                         interpret=True)
        zt = torch.zeros_like(t[0])
        p_back, back = assign_chunk_oracle(load, t[0], t[1], zt, zt, zt,
                                           max_load=max_load, sign=-1,
                                           parts=p, n_valid=ch.n_valid)
        np.testing.assert_array_equal(np.asarray(back_ref), back.numpy())
        assert torch.equal(p_back, p)


@pytest.mark.parametrize("k", [3, 8, 32])
def test_retracting_every_chunk_restores_zero_load(k):
    src, dst, n, head, cu, cv, c2p, max_load = _inputs(1, k)
    stream = EdgeStream(src, dst, n, chunk_size=7, device="cpu")
    pc = tpost.AssignCarry(k, max_load, torch.from_numpy(c2p))
    extras = (torch.from_numpy(head), torch.from_numpy(cu), torch.from_numpy(cv))
    parts, load = run_carry(stream, pc, *extras)
    assert int(load.sum()) == int((src != dst).sum())
    back = run_retract(stream, pc, parts, *extras, carry=load)
    assert int(back.abs().sum()) == 0
    # the plain vectorized inverse agrees with the kernel contract's retract
    ch = stream.chunk_at(0, parts)
    again = tpost._retract_load(load, ch.src, ch.dst, ch.n_valid, ch.extras[0])
    _, via_oracle = assign_chunk_oracle(load, ch.src, ch.dst, ch.src * 0, ch.src * 0,
                                        ch.src * 0, max_load=max_load, sign=-1,
                                        parts=ch.extras[0], n_valid=ch.n_valid)
    assert torch.equal(again, via_oracle)


def test_assign_chunk_and_assign_edges_match_reference():
    src, dst, n, head, cu, cv, c2p, max_load = _inputs(2, 8)
    load_ref, parts_ref = jpost._assign_chunk(
        jnp.zeros(8, jnp.int32), max_load, jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(head), jnp.asarray(cu), jnp.asarray(cv), jnp.asarray(c2p), k=8)
    t = [torch.from_numpy(x) for x in (src, dst, head, cu, cv, c2p)]
    load, parts = tpost._assign_chunk(torch.zeros(8, dtype=torch.int32), max_load,
                                      *t, k=8)
    np.testing.assert_array_equal(np.asarray(parts_ref), parts.numpy())
    np.testing.assert_array_equal(np.asarray(load_ref), load.numpy())
    p2, l2 = tpost.assign_edges(*t, 8, max_load, device="cpu")
    assert torch.equal(p2, parts) and torch.equal(l2, load)
