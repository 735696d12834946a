"""AdamW with float32 moments, global-norm clipping and LR schedules (port
of ``repro.optim.adamw``).

Parameters are trees of tensors (dicts, lists, tuples; see
:func:`repro_torch.streaming.carry.tree_flatten`) in their own dtype (bf16
for the LM); ``mu`` and ``nu`` are float32 trees of the same shape.  The
update keeps the reference's order of operations: the clip scale from
the global norm over all leaves in float32 (the leaves' squared sums
added in tree order), the bias corrections ``1 − b^step`` in float32, the
decoupled weight decay inside ``delta``, and one rounding of the new
parameter to its dtype.  :func:`make_train_step` takes the gradient with
``torch.autograd.grad``.

:func:`adamw_update` writes the new parameters and moments into the old
state's tensors (each computed whole first, then copied in), the
counterpart of the reference cells' ``donate_argnums=(0,)``: the state is
not held twice.  A caller that keeps the old state passes a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..streaming.carry import tree_flatten, tree_unflatten

__all__ = ["AdamWConfig", "TrainState", "init_state", "adamw_update", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Callable[[torch.Tensor], torch.Tensor] | None = None


class TrainState(NamedTuple):
    params: Any
    mu: Any
    nu: Any
    step: torch.Tensor  # int32 scalar on the parameters' device


def _zeros_like(tree):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                 for p in leaves])


def init_state(params) -> TrainState:
    leaves = tree_flatten(params)[0]
    dev = leaves[0].device if leaves else torch.device("cpu")
    return TrainState(params=params, mu=_zeros_like(params), nu=_zeros_like(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _global_norm(tree) -> torch.Tensor:
    leaves = tree_flatten(tree)[0]
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def adamw_update(state: TrainState, grads, cfg: AdamWConfig) -> TrainState:
    step = state.step + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cfg.lr * (cfg.schedule(step) if cfg.schedule is not None else 1.0)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * g
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
        del g
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        del mhat, vhat
        p_new = (p.float() - lr * delta).to(p.dtype)
        with torch.no_grad():
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
        return p, m, v

    p_leaves, spec = tree_flatten(state.params)
    g_leaves = tree_flatten(grads)[0]
    m_leaves = tree_flatten(state.mu)[0]
    v_leaves = tree_flatten(state.nu)[0]
    if not len(p_leaves) == len(g_leaves) == len(m_leaves) == len(v_leaves):
        raise ValueError("params, grads, mu and nu must be trees of one structure")
    new = [upd(p, g, m, v) for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves)]
    return TrainState(params=tree_unflatten(spec, [t[0] for t in new]),
                      mu=tree_unflatten(spec, [t[1] for t in new]),
                      nu=tree_unflatten(spec, [t[2] for t in new]), step=step)


def make_train_step(loss_fn: Callable, model_cfg, opt_cfg: AdamWConfig):
    """``loss_fn(params, batch, model_cfg) → (loss, metrics)``; returns
    ``train_step(state, batch) → (state, metrics)``, the metrics the loss
    function's (detached) plus ``"loss"``; the new state is written into
    the old one's tensors."""

    def train_step(state: TrainState, batch):
        leaves, spec = tree_flatten(state.params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(spec, live), batch, model_cfg)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
        del live
        new_state = adamw_update(state, tree_unflatten(spec, grads), opt_cfg)
        out = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
        out["loss"] = loss.detach()
        return new_state, out

    return train_step
