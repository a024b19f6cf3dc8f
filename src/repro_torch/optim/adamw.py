"""AdamW with decoupled weight decay and global-norm gradient clipping,
counterpart of ``repro.optim.adamw``, as functions over nested dicts of
tensors.

Optimizer state mirrors the parameter tree (``mu``, ``nu`` in fp32) plus a
0-d int ``step`` on the parameters' device.  The clip factor, the bias
corrections and the returned metrics stay tensors on that device: an
update makes no host sync.

``adamw_update_`` writes the step into the parameters, ``mu`` and ``nu`` in
place, leaf by leaf: the counterpart of the reference's ``donate_argnums``,
so a full-width LM step never holds a second copy of its parameters and
optimizer state.  ``adamw_update`` returns new trees, as the reference
does: it runs ``adamw_update_`` on copies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict in sorted key order (the reference's pytree
    order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def init_opt_state(params: Any) -> dict:
    first = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0):
    """Returns (new_params, new_state, metrics); the inputs are left as they
    were."""
    with torch.no_grad():
        new_params = tree_map(torch.clone, params)
        new_state = {"mu": tree_map(torch.clone, state["mu"]),
                     "nu": tree_map(torch.clone, state["nu"]), "step": state["step"]}
    metrics = adamw_update_(new_params, grads, new_state, cfg, lr_scale)
    return new_params, new_state, metrics


@torch.no_grad()
def adamw_update_(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                  lr_scale: torch.Tensor | float = 1.0,
                  gnorm: torch.Tensor | None = None) -> dict:
    """One AdamW step in place: the parameters, ``mu`` and ``nu`` are
    overwritten and ``state["step"]`` replaced.  Returns the metrics.
    ``gnorm``: the norm the clip factor is taken from, where ``grads`` is a
    part of the gradient (a ZeRO-1 rank's blocks); by default theirs."""
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    stepf = step.float()
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    lr = cfg.lr * lr_scale
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        g = g.float() * clip
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        step_dir = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        decay = cfg.weight_decay * p.float() if p.ndim >= 2 else 0.0
        p.copy_(p.float() - lr * (step_dir + decay))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
