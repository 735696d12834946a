"""Port parity: ``repro_torch.checkpoint`` against the live
``repro.checkpoint``.

Checkpoints are the reference's files: every leaf under the reference's
path key (``_flatten_with_paths``: sorted dict keys, sequence indices,
``.field`` for a NamedTuple field, ``None`` no leaf, a scalar a 0-d leaf)
with its dtype and CRC32.  The tests hold the keys to the reference's on
the carries and bundles the port saves, and check the atomic commit, the
CRC refusal, keep-N with keep-every-K, the async writer, the bfloat16
round trip (a ``uint16`` view, back as ``torch.bfloat16`` without
``ml_dtypes``), and that a checkpoint written by either package restores
in the other.  Reference calls that draw threefry bits run with
``jax_threefry_partitionable`` set."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.checkpoint.manager import _flatten_with_paths as j_paths
from repro_torch.checkpoint import (CheckpointManager, reshard_state, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.streaming.carry import tree_leaves


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _trees(name):
    """(reference tree, port tree) of the same shape for one case."""
    from repro.core.clustering import init_state as j_init
    from repro.core.cms import make_sketch as j_sketch
    from repro.kernels.stream_scan import ref as jref
    from repro_torch.core.clustering import init_state
    from repro_torch.core.cms import make_sketch
    from repro_torch.kernels.stream_scan import ref as tref

    row = np.arange(9, dtype=np.int32) % 2
    if name == "cluster_state":
        return j_init(9), init_state(9, "cpu")
    if name == "hdrf":
        return jref.hdrf_init(9, 4, 1.1), tref.hdrf_init(9, 4, 1.1)
    if name == "grid":
        return (jref.grid_init(4, jnp.asarray(row), jnp.asarray(row), 2),
                tref.grid_init(4, torch.from_numpy(row), torch.from_numpy(row), 2))
    if name == "sketch":
        return j_sketch(28, 5, seed=3), make_sketch(28, 5, seed=3, device="cpu")
    if name == "scan_bundle":
        parts = np.zeros(5, np.int32)
        alive = np.ones(5, bool)
        return ({"scan": jref.greedy_init(9, 4), "parts": parts, "alive": alive},
                {"scan": tref.greedy_init(9, 4), "parts": parts, "alive": alive})
    if name == "nested":
        tree = {"b": [1, 2.5, (np.int32(3), None)], "a": {"z": None, "y": np.zeros(2)},
                "c": (True, np.float64(1.5)), "d": None}
        return tree, tree
    raise KeyError(name)


CASES = ["cluster_state", "hdrf", "grid", "sketch", "scan_bundle", "nested"]


@pytest.mark.parametrize("name", CASES)
def test_paths_equal_the_reference(name):
    ref, port = _trees(name)
    want = [k for k, _ in j_paths({"carry": ref})]
    got = [k for k, _ in _flatten_with_paths({"carry": port})]
    assert got == want
    assert len(got) == len(tree_leaves({"carry": port}))


def test_paths_of_the_s5p_bundle_equal_the_reference():
    from repro.core import S5PConfig as JConfig
    from repro.incremental import s5p_cold_bundle as j_cold
    from repro_torch.core.s5p import S5PConfig
    from repro_torch.incremental import s5p_cold_bundle

    from proptest import random_graph

    src, dst, n, _ = random_graph(0)
    _, jb = j_cold(src, dst, n, JConfig(k=4, chunk_size=64))
    _, tb = s5p_cold_bundle(src, dst, n, S5PConfig(k=4, chunk_size=64), device="cpu")
    assert [k for k, _ in _flatten_with_paths(tb)] == [k for k, _ in j_paths(jb)]


def test_atomic_commit_and_crc_refusal(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.int32), "b": np.float32(2.0)}
    # a write that died before its rename leaves a .tmp dir: never restored
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)
    path = save_checkpoint(tmp_path, 3, state)
    assert path.name == "step_00000003" and not (tmp_path / "step_00000003.tmp").exists()
    flat, step = restore_checkpoint(tmp_path)
    assert step == 3 and flat["w"].tolist() == list(range(6))
    with np.load(path / "arrays.npz") as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["w"][0] += 1
    np.savez(path / "arrays.npz", **arrays)
    with pytest.raises(IOError, match="corruption"):
        restore_checkpoint(tmp_path)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "empty")


@pytest.mark.parametrize("keep,keep_every", [(2, None), (2, 3), (0, None)])
def test_keep_n_and_keep_every(tmp_path, keep, keep_every):
    mgr = CheckpointManager(tmp_path / "p", keep=keep, keep_every=keep_every,
                            async_write=False)
    ref = JManager(tmp_path / "j", keep=keep, keep_every=keep_every, async_write=False)
    for s in range(1, 8):
        mgr.save(s, {"x": torch.full((3,), s)})
        ref.save(s, {"x": np.full((3,), s)})
    assert mgr.steps() == ref.steps()
    got, step = mgr.restore(like={"x": torch.zeros(3, dtype=torch.int64)})
    assert step == 7 and got["x"].tolist() == [7, 7, 7]


def test_async_writer_snapshots_and_surfaces_errors(tmp_path):
    mgr = CheckpointManager(tmp_path / "a", keep=3)
    x = torch.arange(4, dtype=torch.float32)
    mgr.save(1, {"x": x})
    x.add_(100)  # after save returns: the snapshot was taken already
    mgr.wait()
    got, _ = mgr.restore(like={"x": torch.zeros(4)})
    assert got["x"].tolist() == [0.0, 1.0, 2.0, 3.0]
    (tmp_path / "file").write_text("not a directory")
    bad = CheckpointManager(tmp_path / "file" / "sub")
    bad.save(1, {"x": x})
    with pytest.raises(OSError):
        bad.wait()


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    x = torch.randn(5, 3).to(torch.bfloat16)
    save_checkpoint(tmp_path, 0, {"w": x, "n": torch.tensor(3)})
    manifest = json.loads((tmp_path / "step_00000000" / "manifest.json").read_text())
    assert manifest["dtypes"] == {"n": "int64", "w": "bfloat16"}
    flat, _ = restore_checkpoint(tmp_path)
    assert flat["w"].dtype == torch.bfloat16 and torch.equal(flat["w"], x)
    got, _ = restore_checkpoint(tmp_path, like={"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                                                "n": torch.tensor(0)})
    assert torch.equal(got["w"], x) and int(got["n"]) == 3
    # the reference reads the port's bf16 leaf (through ml_dtypes)
    jflat, _ = j_restore(tmp_path)
    np.testing.assert_array_equal(np.asarray(jflat["w"]).view(np.uint16),
                                  x.view(torch.int16).numpy().view(np.uint16))


def _mixed():
    rng = np.random.default_rng(0)
    return {"i32": rng.integers(-9, 9, (4, 3)).astype(np.int32),
            "u32": rng.integers(0, 2**32, 7, dtype=np.uint64).astype(np.uint32),
            "f32": rng.standard_normal(5).astype(np.float32),
            "f64": np.float64(0.25), "b": rng.random(6) < 0.5,
            "seq": (np.int32(4), np.arange(3, dtype=np.int64)), "none": None}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _mixed()
    j_save(tmp_path, 5, tree)
    flat, step = restore_checkpoint(tmp_path)
    jflat, _ = j_restore(tmp_path)
    assert step == 5 and sorted(flat) == sorted(jflat)
    for k in jflat:
        assert flat[k].dtype == jflat[k].dtype
        np.testing.assert_array_equal(flat[k], jflat[k])
    like = {"i32": torch.zeros(4, 3, dtype=torch.int32),
            "u32": torch.zeros(7, dtype=torch.int32),  # bit patterns, as the CMS table
            "f32": torch.zeros(5), "f64": 0.0, "b": torch.zeros(6, dtype=torch.bool),
            "seq": (0, torch.zeros(3, dtype=torch.int64)), "none": None}
    got, _ = restore_checkpoint(tmp_path, like=like)
    assert torch.equal(got["i32"], torch.from_numpy(tree["i32"]))
    assert np.array_equal(got["u32"].numpy().view(np.uint32), tree["u32"])
    assert got["f64"] == 0.25 and got["seq"][0] == 4 and got["none"] is None
    assert torch.equal(got["b"], torch.from_numpy(tree["b"]))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _mixed()
    port_tree = {**tree, "i32": torch.from_numpy(tree["i32"]),
                 "f32": torch.from_numpy(tree["f32"])}
    save_checkpoint(tmp_path / "p", 5, port_tree)
    j_save(tmp_path / "j", 5, tree)
    mp = json.loads((tmp_path / "p" / "step_00000005" / "manifest.json").read_text())
    mj = json.loads((tmp_path / "j" / "step_00000005" / "manifest.json").read_text())
    assert mp == mj  # keys, dtypes and CRCs
    jflat, _ = j_restore(tmp_path / "p")
    for k, v in j_restore(tmp_path / "j")[0].items():
        np.testing.assert_array_equal(np.asarray(jflat[k]), v)
    got, _ = j_restore(tmp_path / "p", like=tree)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax.tree_util.tree_leaves(got),
                               jax.tree_util.tree_leaves(tree)))


def test_reshard_state_places_leaves():
    tree = {"a": np.arange(3, dtype=np.int32), "b": (np.float32(1.0), 7)}
    out = reshard_state(tree, "cpu")
    assert isinstance(out["a"], torch.Tensor) and out["a"].device.type == "cpu"
    assert out["b"][1] == 7
    same = reshard_state(tree, None)
    assert same["a"] is tree["a"]
    per_leaf = reshard_state(tree, {"a": "cpu", "b": ("cpu", "cpu")})
    assert per_leaf["b"][0].dtype == torch.float32
    with pytest.raises(TypeError, match="a placement is a device, a DeviceMesh"):
        reshard_state(tree, object())
