"""Losses and gradients of the port (``repro_torch.models`` through K5ᵀ,
K6b and K7b's plain versions on the CPU) against ``jax.value_and_grad`` of
the live reference, on the CPU.

Inputs are the reference's own smoke cells (``init_state``,
``make_batch``), given to the port through ``interop``.  Tolerances: losses
within rtol 1e-5; each gradient leaf's largest error within a stated
fraction of its largest magnitude: 1e-4 for the float32 models (GCN,
SchNet, EGNN, DimeNet, xDeepFM; measured ≤ 1.2e-5, DimeNet's 1e9-sized
loss the largest), 2e-3 for the float32 LMs (measured ≤ 4.8e-4: the smoke
LM's weights have ``fan_in = L = 2``, so its attention is nearly one-hot
and amplifies the ulps of ``exp``, ``rsqrt`` and the sums' order).

The bf16 smoke LM runs with ``wq`` scaled by 1/8 (exact in bf16).  On the
smoke weights as drawn, the reference's own bf16 gradient differs from
its float32 one by 0.5–1.2 of the largest magnitude in every leaf above
the head, so no bound there would test the port.  With the scaled
queries the reference's bf16 gradient is within 0.016–0.091 of its
float32 one, and the port's bf16 gradient is held to 2^-5 (four bf16 ulps
at the leaf's top) of the reference's bf16 gradient, measured ≤ 0.020;
the loss within rtol 1e-4 (measured 3e-5).  One GCN layer's gradient is
bitwise.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import cells as jcells
from repro.models import gnn as jgnn
from repro.models import lm as jlm
from repro.models import recsys as jrec
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.launch import cells
from repro_torch.models import gnn as tgnn
from repro_torch.models import lm as tlm
from repro_torch.models import recsys as trec
from repro_torch.streaming.carry import tree_flatten, tree_flatten_with_paths


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


def _jgcn_molecule_loss(params, batch, cfg):
    """The loss the reference's gcn-cora × molecule cell defines inline."""
    out = jgnn.gcn_forward(params, batch["feats"], batch["edge_src"], batch["edge_dst"],
                           batch["feats"].shape[0], cfg, batch.get("edge_mask"))
    out = out * batch["node_mask"][:, None]
    pooled = jax.ops.segment_sum(out, batch["graph_idx"], num_segments=batch["n_graphs"])
    return jnp.mean(jnp.square(jnp.mean(pooled, axis=-1) - batch["labels"])), {}


def _losses(arch: str, shape: str, dtype):
    """(reference loss, port loss, reference params, batch) of a smoke cell."""
    jc = jcells.build_cell(arch, shape, smoke=True)
    key = jax.random.PRNGKey(0)
    params = jc.init_state(key).params
    batch = jc.make_batch(jax.random.fold_in(key, 0))[0]
    jcfg, tcfg = jget_arch(arch).smoke_config, get_arch(arch).smoke_config
    fam = jget_arch(arch).family
    if fam == "lm":
        if dtype == "f32":
            jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
            tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
            params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
        else:
            attn = {**params["layers"]["attn"], "wq": params["layers"]["attn"]["wq"] * 0.125}
            params = {**params, "layers": {**params["layers"], "attn": attn}}
        return (lambda p, b: jlm.loss_fn(p, b, jcfg),
                lambda p, b: tlm.loss_fn(p, b, tcfg, device="cpu"), params, batch)
    if fam == "recsys":
        return (lambda p, b: jrec.xdeepfm_loss(p, b, jcfg),
                lambda p, b: trec.xdeepfm_loss(p, b, tcfg), params, batch)
    static = {"n_graphs": cells.SMOKE_OVERRIDES["gnn_molecule"]["batch"]} \
        if shape == "molecule" else {}
    if arch == "gcn-cora":
        jcfg = dataclasses.replace(jcfg, d_feat=batch["feats"].shape[1])
        tcfg = dataclasses.replace(tcfg, d_feat=batch["feats"].shape[1])
    jfn, tfn = jcells._GNN_FNS[arch][1], cells._GNN_FNS[arch][1]
    if arch == "gcn-cora" and shape == "molecule":
        jfn, tfn = _jgcn_molecule_loss, tgnn.gcn_molecule_loss
    return (lambda p, b: jfn(p, {**b, **static}, jcfg),
            lambda p, b: tfn(p, {**b, **static}, tcfg, device="cpu"), params, batch)


@pytest.mark.parametrize("arch,shape,dtype,tol", [
    ("llama3-8b", "train_4k", "f32", 2e-3), ("llama3-8b", "train_4k", "bf16", 2**-5),
    ("mixtral-8x7b", "train_4k", "f32", 2e-3), ("xdeepfm", "train_batch", None, 1e-4),
    ("gcn-cora", "full_graph_sm", None, 1e-4), ("gcn-cora", "molecule", None, 1e-4),
    ("schnet", "molecule", None, 1e-4), ("egnn", "molecule", None, 1e-4),
    ("dimenet", "molecule", None, 1e-4),
])
def test_value_and_grad_against_reference(arch, shape, dtype, tol):
    jloss, tloss, params, batch = _losses(arch, shape, dtype)
    (want, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(params, batch)
    tparams = interop.train_params(params, device="cpu")
    leaves = tree_flatten(tparams)[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    got, _ = tloss(tparams, {k: _t(v) for k, v in batch.items()})
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want),
                                                rel=1e-4 if dtype == "bf16" else 1e-5)
    paths = [p for p, _ in tree_flatten_with_paths(tparams)]
    for path, w, leaf in zip(paths, jax.tree.leaves(jgrads), leaves):
        w = _np(w).astype(np.float32)
        g = np.zeros(w.shape, np.float32) if leaf.grad is None else leaf.grad.float().numpy()
        assert g.shape == w.shape, path
        if dtype == "bf16":
            assert leaf.grad.dtype == torch.bfloat16
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (path, err)


def test_gcn_layer_gradient_bit_for_bit():
    """One GCN layer's aggregation (both directions and the self loop) on a
    fixed ``x``: the gradient of ``x`` through K5ᵀ's plain version equals
    ``jax.grad`` of the reference's sums bit for bit (the scatter-adds of
    both add in edge order from zero)."""
    rng = np.random.default_rng(2)
    V, E, d = 60, 400, 8
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    mask = (rng.random(E) < 0.8).astype(np.float32)
    x = rng.standard_normal((V, d)).astype(np.float32)
    g = rng.standard_normal((V, d)).astype(np.float32)
    norm = tgnn.gcn_norm(src, dst, V, edge_mask=mask, device="cpu")
    w = (norm.inv_sqrt[src] * norm.inv_sqrt[dst] * torch.from_numpy(mask)).numpy()

    def jlayer(x):
        fwd = jax.ops.segment_sum(x[src] * w[:, None], dst, V)
        rev = jax.ops.segment_sum(x[dst] * w[:, None], src, V)
        return fwd, rev

    _, vjp = jax.vjp(jlayer, jnp.asarray(x))
    for which in (0, 1):
        cot = [jnp.zeros_like(g), jnp.zeros_like(g)]
        cot[which] = jnp.asarray(g)
        want = np.asarray(vjp(tuple(cot))[0])
        xt = torch.from_numpy(x).requires_grad_()
        lay = norm.fwd if which == 0 else norm.rev
        tgnn.segment_agg(xt, lay).backward(torch.from_numpy(g))
        np.testing.assert_array_equal(xt.grad.numpy(), want)
