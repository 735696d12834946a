"""The training path of the port (``repro_torch.launch.{cells,train}``,
AdamW in the fault-tolerant loop) against the live reference
(``repro.launch``), on the CPU.  The losses' gradients are
``tests/test_torch_grads.py``'s.  Tolerances:

- the cells' batches: integers and uniforms bit for bit, ``normal`` draws
  within rtol 1e-5, atol 1e-6 (``repro_torch.random``'s erfinv);
- the cells' meta shapes, logical axes, rules and FLOPs exactly;
- ``train(..., fail_at=(2,))`` resumes to the bits of the run without the
  fault; against the reference's ``train`` the losses within rtol 1e-4
  (1e-3 for the bf16 smoke LM; the inits differ by erfinv's ulps) and the
  parameters within 2·lr·steps of each other (AdamW's steps are near
  ±lr whatever the gradient's size, so a gradient near zero may step
  either way); a bf16 leaf moves by whole ulps where lr is below its ulp,
  so each of its steps may differ by an ulp as well (rtol 2·steps·2^-7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import cells as jcells
from repro.launch import train as jtrain
from repro_torch import random as trandom
from repro_torch.launch import cells, train
from repro_torch.streaming.carry import tree_flatten


@pytest.fixture(autouse=True)
def _threefry_partitionable():
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _np(x) -> np.ndarray:
    x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    return x


def _t(x):
    return torch.from_numpy(np.array(x)) if hasattr(x, "shape") else x


_TRAIN_CELLS = [("llama3-8b", "train_4k"), ("mixtral-8x7b", "train_4k"),
                ("xdeepfm", "train_batch"), ("gcn-cora", "full_graph_sm"),
                ("gcn-cora", "minibatch_lg"), ("gcn-cora", "molecule"),
                ("schnet", "molecule"), ("schnet", "full_graph_sm"), ("egnn", "molecule"),
                ("dimenet", "molecule"), ("dimenet", "minibatch_lg")]
_SERVE_CELLS = [("llama3-8b", "prefill_32k"), ("xdeepfm", "serve_p99"),
                ("xdeepfm", "retrieval_cand")]


@pytest.mark.parametrize("arch,shape", _TRAIN_CELLS + _SERVE_CELLS)
def test_make_batch_against_reference(arch, shape):
    jb = jcells.build_cell(arch, shape, smoke=True).make_batch(jax.random.PRNGKey(3))
    tb = cells.build_cell(arch, shape, smoke=True, device="cpu").make_batch(
        trandom.PRNGKey(3))
    jl, tl = jax.tree.leaves(jb), tree_flatten(tb)[0]
    assert len(jl) == len(tl)
    for w, g in zip(jl, tl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if np.issubdtype(w.dtype, np.integer) or shape == "train_batch":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def _shape_tree(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", "")) for x in tree_flatten(tree)[0]]


def _jshape_tree(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


_ALL = [(a, s) for a in ("llama3-8b", "mixtral-8x7b", "qwen3-14b", "xdeepfm", "gcn-cora",
                         "schnet", "egnn", "dimenet")
        for s in jget_arch(a).runnable_shapes()]


@pytest.mark.parametrize("arch,shape", _ALL)
def test_cell_shapes_axes_and_flops_against_reference(arch, shape):
    """The published configs: the meta state and batch against the
    reference's ``eval_shape``, the logical axes, rules, donation and FLOPs."""
    jc = jcells.build_cell(arch, shape)
    tc = cells.build_cell(arch, shape, device="cpu")
    assert (tc.kind, tc.rules, tc.donate, tc.attn_block) == \
        (jc.kind, jc.rules, jc.donate, jc.attn_block)
    assert tc.model_flops == jc.model_flops
    assert all(x.device.type == "meta" for x in tree_flatten(tc.state_shape)[0])
    assert _shape_tree(tc.state_shape) == _jshape_tree(jc.state_shape)
    assert _shape_tree(tc.batch_shape) == _jshape_tree(jc.batch_shape)
    assert tc.state_axes == jc.state_axes
    assert tc.batch_axes == jc.batch_axes


def test_cuts_and_refusals():
    c = cells.build_cell("llama3-8b", "train_4k", device="cpu", n_layers=4, batch=2)
    assert c.cuts == {"n_layers": "4 of 32", "batch": "2 of 256"}
    assert c.state_shape.params["layers"]["attn"]["wq"].shape[0] == 4
    assert c.batch_shape[0]["tokens"].shape == (2, 4096)
    with pytest.raises(ValueError, match="depth of an LM"):
        cells.build_cell("xdeepfm", "train_batch", device="cpu", n_layers=2)
    with pytest.raises(ValueError, match="documented skip"):
        cells.build_cell("llama3-8b", "long_500k", device="cpu")


@pytest.mark.parametrize("arch,shape", [("llama3-8b", "train_4k"), ("gcn-cora", "molecule"),
                                        ("xdeepfm", "train_batch")])
def test_train_resumes_bitwise_after_fault(tmp_path, arch, shape):
    clean, _ = train.train(arch, shape, steps=4, smoke=True, ckpt_dir=str(tmp_path / "a"),
                           ckpt_every=100, device="cpu")
    info = {}
    faulty, _ = train.train(arch, shape, steps=4, smoke=True, ckpt_dir=str(tmp_path / "b"),
                            ckpt_every=2, fail_at=(2,), device="cpu", info=info)
    assert info["restarts"] == 1 and int(faulty.step) == 4
    others = [faulty]
    if arch != "llama3-8b":  # a fault before the first checkpoint: the entry copy
        others.append(train.train(arch, shape, steps=4, smoke=True,
                                  ckpt_dir=str(tmp_path / "c"), ckpt_every=100, fail_at=(1,),
                                  device="cpu")[0])
    for other in others:
        for a, b in zip(tree_flatten(clean)[0], tree_flatten(other)[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch,shape", [("llama3-8b", "train_4k"), ("gcn-cora", "molecule"),
                                        ("xdeepfm", "train_batch")])
def test_train_against_reference(tmp_path, capsys, arch, shape):
    jstate, jout = jtrain.train(arch, shape, steps=3, smoke=True,
                                ckpt_dir=str(tmp_path / "j"), ckpt_every=2, fail_at=(2,))
    tstate, tout = train.train(arch, shape, steps=3, smoke=True,
                               ckpt_dir=str(tmp_path / "t"), ckpt_every=2, fail_at=(2,),
                               device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[train]")]
    assert len(lines) == 2 and all("3 steps" in ln and "restarts=1" in ln for ln in lines)
    assert set(tout) == set(jout)
    for k in jout:
        assert tout[k] == pytest.approx(jout[k], rel=1e-3 if arch == "llama3-8b" else 1e-4,
                                        abs=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    lr = 3e-4
    for w, g in zip(jax.tree.leaves(jstate.params), tree_flatten(tstate.params)[0]):
        rtol = 2 * 3 * 2**-7 if g.dtype == torch.bfloat16 else 0
        np.testing.assert_allclose(g.float().numpy(), _np(w), rtol=rtol, atol=2 * lr * 3 + 1e-6)


def test_train_cli(capsys):
    train.main(["--arch", "llama3-8b", "--shape", "train_4k", "--smoke", "--steps", "2",
                "--device", "cpu", "--ckpt-every", "100"])
    out = capsys.readouterr().out
    assert "[train] llama3-8b × train_4k: 2 steps in" in out and "restarts=0" in out
    train.main(["--arch", "gcn-cora", "--shape", "molecule", "--steps", "2", "--device", "cpu",
                "--fail-at", "1", "--ckpt-every", "100"])
    assert "restarts=1" in capsys.readouterr().out
