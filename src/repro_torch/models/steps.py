"""Training, serving and scoring entry points: counterpart of
``repro.models.steps``.  ``loss_fn`` is the forward of a training step: it
scores a batch, and for xlstm it is the one path that runs the mLSTM scan
kernel (a full-sequence forward that asks for no state).  ``train_step``
differentiates it with ``torch.autograd.grad`` over every parameter leaf
and applies AdamW in place (``optim.adamw.adamw_update_``)."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..optim import adamw
from . import lm


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in fp32; labels == -1 are masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict):
    """batch {"tokens", "labels": (B,S)} -> (loss, {"ce", "aux"}): the
    full-sequence forward with no cache, then the shifted cross entropy."""
    logits, aux, _ = lm.forward(params, cfg, batch)
    ce = softmax_xent(logits[:, :-1], batch["labels"][:, 1:])
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


def train_step(params: dict, opt_state: dict, batch: dict, *, cfg: ArchConfig,
               opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
               lr_scale: torch.Tensor | float = 1.0):
    """One step: ``loss_fn``, the gradient of every leaf by
    ``torch.autograd.grad`` (``allow_unused=False``: a leaf the loss does
    not reach raises), then AdamW.  The parameters, ``mu`` and ``nu`` are
    updated in place (the reference's ``donate_argnums``); the same trees
    are returned, with the metrics (tensors on the parameters' device)."""
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(leaves, cfg, batch)
    flat = adamw.tree_leaves(leaves)
    by_leaf = dict(zip(map(id, flat), torch.autograd.grad(loss, flat, allow_unused=False)))
    om = adamw.adamw_update_(leaves, adamw.tree_map(lambda p: by_leaf[id(p)], leaves),
                             opt_state, opt_cfg, lr_scale)
    return params, opt_state, {"loss": loss.detach(),
                               **{k: v.detach() for k, v in metrics.items()}, **om}


def prefill(params: dict, batch: dict, *, cfg: ArchConfig, cache_len: int = 0):
    """Full-sequence forward emitting a decode cache (padded to cache_len).
    Returns (last-position logits (B,V), cache)."""
    cache_len = cache_len or batch["tokens"].shape[1]
    logits, _, cache = lm.forward(params, cfg, batch, collect_cache=True,
                                  cache_len=cache_len)
    return logits[:, -1], cache


def serve_step(params: dict, cache: dict, tokens: torch.Tensor, positions: torch.Tensor,
               *, cfg: ArchConfig):
    """ONE new token per sequence against the cache. tokens: (B,1)."""
    return lm.decode_step(params, cfg, tokens, positions, cache)


def greedy_decode_loop(params: dict, cache: dict, first_token: torch.Tensor,
                       start_pos: torch.Tensor, n_steps: int, *, cfg: ArchConfig):
    """Greedy generation, one decode step per token: first_token (B,1),
    start_pos (B,).  Returns (tokens (B, n_steps), cache)."""
    tok, pos, out = first_token, start_pos, []
    for _ in range(n_steps):
        logits, cache = lm.decode_step(params, cfg, tok, pos, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        pos = pos + 1
        out.append(tok[:, 0])
    toks = torch.stack(out, dim=1) if out else first_token[:, :0]
    return toks, cache
