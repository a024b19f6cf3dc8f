"""Training, serving and scoring entry points: counterpart of
``repro.models.steps``.  ``loss_fn`` is the forward of a training step: it
scores a batch, and for xlstm it is the one path that runs the mLSTM scan
kernel (a full-sequence forward that asks for no state).  ``train_step``
differentiates it with ``torch.autograd.grad`` over every parameter leaf
and applies AdamW in place (``optim.adamw.adamw_update_``).

``dp_train_step`` is the data-parallel step: each rank of the
``torch.distributed`` group holds every parameter and its own rows of the
global batch, and the step computes what ``train_step`` computes on all
the rows at once (the reference's jitted step on a batch sharded over the
mesh): ``dp_grads`` then ``dp_update_``."""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..configs.base import ArchConfig
from ..optim import adamw
from . import lm, sharding


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross entropy in fp32; labels == -1 are masked out.
    ``count``: the divisor in place of this batch's unmasked labels (a
    data-parallel rank divides its sum by the global batch's count)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / (mask.sum().clamp_min(1.0) if count is None else count)


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, *,
            count: torch.Tensor | None = None, row_share: torch.Tensor | float = 1.0):
    """batch {"tokens", "labels": (B,S), and the family's stubs (``frames``,
    ``vision_embeds``, ``mrope_positions``), which go to ``lm.forward``} ->
    (loss, {"ce", "aux"}): the full-sequence forward with no cache, then the
    shifted cross entropy.  A data-parallel rank's share of the global
    loss: ``count`` the global batch's unmasked labels (``softmax_xent``),
    ``row_share`` its share of the global rows, which weights the MoE
    auxiliary loss (a mean over rows: each row routes alone)."""
    logits, aux, _ = lm.forward(params, cfg, batch)
    ce = softmax_xent(logits[:, :-1], batch["labels"][:, 1:], count)
    aux = aux * row_share
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


def dp_grads(params: dict, batch: dict, *, cfg: ArchConfig):
    """This rank's rows ``batch`` of the global batch -> (loss, {"ce",
    "aux"}, grads) of the global batch, on every rank.  The unmasked labels
    and the rows are counted over the ranks first (the labels are known
    before the forward); the rank's loss is its masked NLL sum over the
    global count plus its row share of the MoE auxiliary loss, so the
    ranks' losses sum to the global loss and their gradients, summed leaf
    by leaf (``all_reduce``), are its gradient.  (A mean of per-rank means
    is wrong as soon as the ranks' masks differ.)"""
    labels, rows = batch["labels"][:, 1:], batch["tokens"].shape[0]
    counts = torch.tensor([0.0, float(rows)], device=labels.device)
    counts[0] = (labels >= 0).sum()
    dist.all_reduce(counts)
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(leaves, cfg, batch, count=counts[0].clamp_min(1.0),
                            row_share=rows / counts[1])
    flat = adamw.tree_leaves(leaves)
    grads = [g.contiguous() for g in torch.autograd.grad(loss, flat, allow_unused=False)]
    for g in grads:
        dist.all_reduce(g)
    reported = torch.stack([loss.detach(), metrics["ce"].detach(), metrics["aux"].detach()])
    dist.all_reduce(reported)
    by_leaf = dict(zip(map(id, flat), grads))
    return reported[0], {"ce": reported[1], "aux": reported[2]}, adamw.tree_map(
        lambda p: by_leaf[id(p)], leaves)


def dp_opt_state(params: dict, specs: dict, mesh) -> dict:
    """AdamW's state for ``dp_update_``: zero moments of each leaf's block
    under ``specs`` on this rank (the whole leaf where a spec splits
    nothing), in fp32 on the parameters' device."""
    def zeros(p, s):
        return torch.zeros(sharding.local_slice(p, s, mesh).shape, dtype=torch.float32,
                           device=p.device)
    first = adamw.tree_leaves(params)[0]
    return {"mu": adamw.tree_map(zeros, params, specs), "nu": adamw.tree_map(zeros, params, specs),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def dp_update_(params: dict, grads: dict, opt_state: dict, *, specs: dict, mesh,
               opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
               lr_scale: torch.Tensor | float = 1.0) -> dict:
    """AdamW in place on this rank's block of every leaf: the block under
    the moments' spec in ``specs`` (``launch.shardings.opt_shardings``'
    ``mu``), ``opt_state``'s moments being blocks of that shape already,
    clipped by the norm of the whole gradient (every rank holds it).  A
    leaf its spec splits (ZeRO-1) is then rebuilt whole on every rank from
    the ranks' blocks (``all_gather``); the rest update whole, on every
    rank.  Elementwise on the same gradient and clip factor: the same bits
    as the whole update, split or not."""
    gnorm = adamw.global_norm(grads)

    def blocks(tree):
        return adamw.tree_map(lambda t, s: sharding.local_slice(t, s, mesh), tree, specs)

    om = adamw.adamw_update_(blocks(params), blocks(grads), opt_state, opt_cfg, lr_scale,
                             gnorm=gnorm)
    for p, s in zip(adamw.tree_leaves(params), adamw.tree_leaves(specs)):
        if sharding.splits(s, mesh):
            sharding.gather_leaf(sharding.local_slice(p, s, mesh), s, mesh, out=p)
    return om


def dp_train_step(params: dict, opt_state: dict, batch: dict, *, cfg: ArchConfig, specs: dict,
                  mesh, opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                  lr_scale: torch.Tensor | float = 1.0):
    """One data-parallel step (``dp_grads``, then ``dp_update_``): the
    parameters on every rank and this rank's moment blocks updated in
    place, as ``train_step`` does.  Returns (params, opt_state, metrics),
    the metrics the global batch's."""
    loss, metrics, grads = dp_grads(params, batch, cfg=cfg)
    om = dp_update_(params, grads, opt_state, specs=specs, mesh=mesh, opt_cfg=opt_cfg,
                    lr_scale=lr_scale)
    return params, opt_state, {"loss": loss, **metrics, **om}


def batch_inputs(cfg: ArchConfig, tokens: torch.Tensor) -> dict:
    """The batch the reference's predictor builds around token ids (B,S)
    (``repro/launch/serve.py:31-43``): under M-RoPE ``mrope_positions``
    0..S-1 on all three streams; a VLM's ``vision_embeds``, zeros, of
    min(n_vision_tokens, S) rows; audio's ``frames``, zeros, of
    ``encoder_len`` rows (the frontends are stubs)."""
    b, s = tokens.shape
    kw = dict(dtype=cfg.compute_dtype, device=tokens.device)
    batch = {"tokens": tokens}
    if cfg.use_mrope:
        batch["mrope_positions"] = torch.arange(s, dtype=torch.int32, device=tokens.device)[
            None, None].expand(b, 3, s)
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros((b, min(cfg.n_vision_tokens, s), cfg.d_model), **kw)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((b, cfg.encoder_len, cfg.d_model), **kw)
    return batch


def start_positions(cfg: ArchConfig, b: int, pos: int, device) -> torch.Tensor:
    """The first decode step's positions after a prompt of ``pos`` tokens:
    (B,), or (B,3) under M-RoPE, every stream at ``pos``."""
    start = torch.full((b,), pos, dtype=torch.int32, device=device)
    return start[:, None].expand(b, 3).contiguous() if cfg.use_mrope else start


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
    start_pos (B,) or (B,3) under M-RoPE (each step adds one to every
    stream).  Returns (tokens (B, n_steps), cache)."""
    tok, pos, out = first_token, start_pos, []
    for _ in range(n_steps):
        logits, cache = lm.decode_step(params, cfg, tok, pos, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        pos = pos + 1
        out.append(tok[:, 0])
    toks = torch.stack(out, dim=1) if out else first_token[:, :0]
    return toks, cache
