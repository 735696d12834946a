"""Port parity for the GAS engine and the partition CLI.

``repro_torch.gas`` against the live ``repro.gas`` on the same partitions:
the vertex-cut layout and the mirror counts exactly, label propagation
exactly (integer minima), PageRank within ``rtol = 1e-5``: both sum the
same float32 terms, but XLA and PyTorch reduce the (V, k) accumulator in
another order and XLA may contract ``0.15 + 0.85·total`` into an FMA, so
the last bits may differ (ten supersteps keep the drift far below 1e-5).
Then ``python -m repro_torch.launch.partition --compare`` on the CPU
prints the reference's RF, balance and gas_comm columns.
"""

import re

import numpy as np
import pytest
import torch

from repro.core.baselines import PARTITIONERS as JPART
from repro.gas import engine as jg
from repro.launch import partition as jcli
from repro_torch.gas import engine as tg
from repro_torch.launch import partition as tcli

RTOL = 1e-5


@pytest.fixture(scope="module")
def cut(community_bench_graph):
    src, dst, n = community_bench_graph
    k = 8
    parts = np.array(JPART["hdrf"](src, dst, n, k, 0))
    parts[::41] = -1  # unplaced edges drop out of the layout
    return src, dst, parts, n, k


@pytest.fixture(scope="module")
def graphs(cut):
    src, dst, parts, n, k = cut
    return (jg.build_gas_graph(src, dst, parts, n, k),
            tg.build_gas_graph(src, dst, torch.from_numpy(parts), n, k, device="cpu"))


def test_build_gas_graph_exact(graphs):
    j, t = graphs
    for name in ("src", "dst", "edge_part", "replica_mask", "masters"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      getattr(t, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(j.part_offsets, t.part_offsets)
    assert (j.n_vertices, j.k) == (t.n_vertices, t.k)


def test_build_gas_graph_takes_arrays_or_tensors(cut):
    src, dst, parts, n, k = cut
    a = tg.build_gas_graph(src, dst, parts, n, k, device="cpu")
    b = tg.build_gas_graph(torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(parts), n, k, device="cpu")
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def test_comm_stats_exact(graphs):
    j, t = graphs
    assert tg.comm_stats(t) == tuple(jg.comm_stats(j))
    assert tg.comm_stats(t).total_bytes() == jg.comm_stats(j).total_bytes()


@pytest.mark.parametrize("iterations", [1, 10])
def test_pagerank(graphs, iterations):
    j, t = graphs
    jv, js = jg.pagerank(j, iterations)
    tv, ts = tg.pagerank(t, iterations)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=0)
    assert tuple(ts) == tuple(js)


def test_pagerank_step_and_out_degree(graphs):
    j, t = graphs
    np.testing.assert_array_equal(np.asarray(jg.out_degree_inv(j)),
                                  tg.out_degree_inv(t).numpy())
    vals = np.random.default_rng(0).random(t.n_vertices).astype(np.float32)
    np.testing.assert_allclose(tg.pagerank_step(t, torch.from_numpy(vals)).numpy(),
                               np.asarray(jg.pagerank_step(j, vals)), rtol=RTOL, atol=0)


def test_pagerank_is_partition_invariant(cut):
    """The super-step is replica-exact: another cut moves only the bytes."""
    src, dst, parts, n, k = cut
    a = tg.build_gas_graph(src, dst, torch.from_numpy(parts), n, k, device="cpu")
    other = np.where(parts >= 0, np.arange(parts.size) % k, -1)
    b = tg.build_gas_graph(src, dst, torch.from_numpy(other), n, k, device="cpu")
    np.testing.assert_allclose(tg.pagerank(a)[0].numpy(), tg.pagerank(b)[0].numpy(),
                               rtol=RTOL, atol=0)
    assert tg.comm_stats(b).total_bytes() > tg.comm_stats(a).total_bytes()


@pytest.mark.parametrize("iterations", [1, 5])
def test_label_propagation_exact(graphs, iterations):
    j, t = graphs
    jl, js = jg.label_propagation(j, iterations)
    tl, ts = tg.label_propagation(t, iterations)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    assert tuple(ts) == tuple(js)


@pytest.mark.parametrize("n_new", [1500, 2000, 2600])
def test_carry_values(n_new):
    vals = np.random.default_rng(1).random(2000).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jg.carry_values(vals, n_new, fill=0.5)),
                                  tg.carry_values(torch.from_numpy(vals), n_new, fill=0.5).numpy())


def _columns(out: str):
    """``name RF balance gas_comm`` of each printed row (not the seconds)."""
    return re.findall(r"^(\S+)\s+RF=\s*(\S+) balance=\s*(\S+) "
                      r"gas_comm=\s*(\S+) MB/iter", out, re.M)


def test_cli_compare_prints_the_reference_columns(capsys):
    want = jcli.run("community:2000", 8, "s5p", 0, True)
    want_out = capsys.readouterr().out
    tcli.main(["--graph", "community:2000", "--k", "8", "--compare", "--device", "cpu"])
    got_out = capsys.readouterr().out
    assert got_out.splitlines()[0].startswith("graph=community:2000 device=cpu")
    assert _columns(got_out) == _columns(want_out)
    assert len(_columns(got_out)) == len(JPART)
    got = tcli.run("community:2000", 8, "hdrf", device="cpu")
    assert [r[:4] for r in got] == [r[:4] for r in want if r[0] == "hdrf"]


def test_cli_prints_the_s5p_phase_split(capsys):
    tcli.main(["--graph", "toy", "--k", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].startswith("s5p ") and len(_columns(lines[1])) == 1
    assert re.match(r"^ +clusters=\d+ \(head \d+\) game_rounds=\d+ "
                    r"converged=(True|False) seconds: clustering=\S+ "
                    r"statistics=\S+ game=\S+ postprocess=\S+$", lines[2])


def test_cli_single_partitioner_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--graph", "toy", "--k", "2", "--partitioner", "greedy"])
