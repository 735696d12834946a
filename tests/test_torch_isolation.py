"""The port stands alone: no module of ``repro_torch`` imports ``jax`` or
``repro``, and its entry points refuse to run without a device."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch

SRC = os.path.dirname(os.path.dirname(repro_torch.__file__))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.core.s5p" in mods and "repro_torch.launch.partition" in mods
    assert {"repro_torch.serving.server", "repro_torch.models.gnn",
            "repro_torch.kernels.segment_agg.ops", "repro_torch.graphs.datasets",
            "repro_torch.configs.gcn_cora", "repro_torch.models.lm",
            "repro_torch.models.attention", "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.kernel", "repro_torch.launch.serve",
            "repro_torch.configs.llama3_8b", "repro_torch.configs.mixtral_8x7b",
            "repro_torch.configs.mixtral_8x22b", "repro_torch.models.recsys",
            "repro_torch.kernels.cin.kernel", "repro_torch.kernels.cin.ops",
            "repro_torch.kernels.cin.ref", "repro_torch.configs.xdeepfm",
            "repro_torch.streaming.oocstream", "repro_torch.streaming.window",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
            "repro_torch.checkpoint.reshard", "repro_torch.incremental.store",
            "repro_torch.incremental.delta", "repro_torch.incremental.drift",
            "repro_torch.incremental.pipeline", "repro_torch.incremental.driver",
            "repro_torch.elastic.reshard", "repro_torch.runtime.fault",
            "repro_torch.runtime.straggler", "repro_torch.runtime.elastic",
            "repro_torch.serving.controller", "repro_torch.hybrid",
            "repro_torch.hybrid.planner", "repro_torch.hybrid.refiner",
            "repro_torch.hybrid.driver", "repro_torch._dist", "repro_torch.launch.mesh",
            "repro_torch.core.distributed", "repro_torch.graphs.sampler",
            "repro_torch.configs.schnet", "repro_torch.configs.egnn",
            "repro_torch.configs.dimenet"} <= set(mods)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None"
        " and (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": SRC}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_rank_worker_module_imports_without_jax_or_repro():
    """Spawned ranks import the test's rank functions in a fresh process:
    that module must stand on ``repro_torch`` alone."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch_dist_ranks\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None"
        " and (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join([SRC, tests])},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _entry_points():
    from repro_torch.core.clustering import cluster_stream
    from repro_torch.core.postprocess import assign_edges_stream
    from repro_torch.core.s5p import S5PConfig, s5p_partition
    from repro_torch.launch.partition import run

    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    z = np.zeros(3, np.int32)
    from repro_torch.kernels.segment_agg import segment_aggregate
    from repro_torch.models.gnn import GCNConfig, gcn_forward, gcn_init
    from repro_torch.serving import build_bundle

    from repro_torch.configs import get_arch
    from repro_torch.kernels.cin import cin_layer_kernel
    from repro_torch.launch.serve import serve_lm, serve_recsys
    from repro_torch.models import lm, recsys

    from repro_torch.data import EdgeChunkPipeline, TokenPipeline
    from repro_torch.streaming import ShardedEdgeStream

    from repro_torch import incremental as inc
    from repro_torch.elastic import reshard_bundle
    from repro_torch.launch.serve import serve_graph

    from repro_torch import hybrid

    from repro_torch.core.distributed import distributed_partition
    from repro_torch.launch.mesh import make_test_mesh

    cfg = GCNConfig(n_layers=2, d_hidden=2, d_feat=2, n_classes=2)
    lm_cfg = get_arch("llama3-8b").smoke_config
    lm_params = {"embed": torch.ones(lm_cfg.vocab, lm_cfg.d_model)}
    params = {"layers": [{"w": torch.ones(2, 2)}, {"w": torch.ones(2, 2)}]}
    return {
        "build_bundle": lambda: build_bundle(1, src, dst, z, 3, 2),
        "gcn_init": lambda: gcn_init(cfg, (0, 0)),
        "gcn_forward": lambda: gcn_forward(params, np.ones((3, 2), np.float32), src, dst,
                                           3, cfg),
        "segment_aggregate": lambda: segment_aggregate(np.ones((3, 2), np.float32), src, dst),
        "s5p_partition": lambda: s5p_partition(src, dst, 3, S5PConfig(k=2)),
        "cluster_stream": lambda: cluster_stream(src, dst, 3, xi=1, kappa=4),
        "assign_edges_stream": lambda: assign_edges_stream(
            src, dst, z.astype(bool), z, z, torch.zeros(1, dtype=torch.int32), 2, 2),
        "cli": lambda: run("toy", 2),
        "init_params": lambda: lm.init_params(lm_cfg, (0, 0)),
        "prefill": lambda: lm.prefill(lm_params, np.zeros((1, 4), np.int32), lm_cfg, 8),
        "serve_lm": lambda: serve_lm("llama3-8b"),
        "serve_recsys": lambda: serve_recsys("xdeepfm"),
        "xdeepfm_init": lambda: recsys.xdeepfm_init(get_arch("xdeepfm").smoke_config, (0, 0)),
        "cin_layer_kernel": lambda: cin_layer_kernel(np.ones((2, 3, 4), np.float32),
                                                     np.ones((2, 3, 4), np.float32),
                                                     np.ones((9, 5), np.float32)),
        "sharded_stream": lambda: ShardedEdgeStream("no-such-manifest.json"),
        "edge_chunk_pipeline": lambda: EdgeChunkPipeline(src, dst, 3),
        "token_pipeline": lambda: TokenPipeline(8, 1, 4),
        "cold_start": lambda: inc.cold_start("no-such-store", "greedy", src, dst, 3, 2),
        "run_incremental": lambda: inc.run_incremental("no-such-store", "s5p", src, dst, 3, 2),
        "s5p_cold_bundle": lambda: inc.s5p_cold_bundle(src, dst, 3, S5PConfig(k=2)),
        "s5p_apply_delta": lambda: inc.s5p_apply_delta({}, S5PConfig(k=2), src, dst, 0),
        "s5p_apply_deletion": lambda: inc.s5p_apply_deletion({}, S5PConfig(k=2), src, dst, []),
        "compact_bundle": lambda: inc.compact_bundle({}, S5PConfig(k=2)),
        "window_chain": lambda: inc.S5PWindowChain(src, dst, 3, S5PConfig(k=2), 2),
        "reshard_bundle": lambda: reshard_bundle({}, S5PConfig(k=2), 3, src, dst),
        "serve_graph": lambda: serve_graph("block-rmat"),
        "run_hybrid": lambda: hybrid.run_hybrid((src, dst, 3), S5PConfig(k=2, host_budget=1 << 20)),
        "plan_budget": lambda: hybrid.plan_budget(src, dst, 3, 1 << 20),
        "place_core": lambda: hybrid.place_core(None, z, 2, 2, 3),
        "hybrid_chain": lambda: hybrid.HybridServingChain(None, S5PConfig(k=2), src, dst, 3),
        "cli_host_budget": lambda: run("toy", 2, host_budget=1 << 20),
        "distributed_partition": lambda: distributed_partition(src, dst, 3, S5PConfig(k=2),
                                                               None),
        "make_test_mesh": lambda: make_test_mesh(1),
    }


@pytest.mark.parametrize("name", ["s5p_partition", "cluster_stream",
                                  "assign_edges_stream", "cli", "build_bundle",
                                  "gcn_init", "gcn_forward", "segment_aggregate",
                                  "init_params", "prefill", "serve_lm", "serve_recsys",
                                  "xdeepfm_init", "cin_layer_kernel", "sharded_stream",
                                  "edge_chunk_pipeline", "token_pipeline", "cold_start",
                                  "run_incremental", "s5p_cold_bundle", "s5p_apply_delta",
                                  "s5p_apply_deletion", "compact_bundle", "window_chain",
                                  "reshard_bundle", "serve_graph", "run_hybrid",
                                  "plan_budget", "place_core", "hybrid_chain",
                                  "cli_host_budget", "distributed_partition",
                                  "make_test_mesh"])
def test_entry_points_need_a_device(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels.stream_scan import assign_scan

    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        assign_scan(torch.zeros(2, dtype=torch.int32, device="meta"), t, t, t, t, t,
                    max_load=1)
