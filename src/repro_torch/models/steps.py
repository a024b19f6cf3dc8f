"""Training, serving and scoring entry points: counterpart of
``repro.models.steps``.  ``loss_fn`` is the forward of a training step: it
scores a batch, and for xlstm it is the one path that runs the mLSTM scan
kernel (a full-sequence forward that asks for no state).  ``train_step``
differentiates it with ``torch.autograd.grad`` over every parameter leaf
and applies AdamW in place (``optim.adamw.adamw_update_``).

``dp_train_step`` is the step over a mesh: each rank of the
``torch.distributed`` group holds its rows of the global batch and every
parameter (data parallelism) or its shard of each (tensor parallelism,
the ``tp`` profile on a model axis larger than 1, the model's layers
running on the shards: ``models/sharding``), and the step computes what
``train_step`` computes on all the rows at once (the reference's jitted
step on a batch sharded over the mesh): ``dp_grads`` then ``dp_update_``.
They read the mesh the model's layers read, ``sharding.current_mesh()``
(none active: every rank of the group holds its rows and every parameter).
A head split on the vocabulary gives each rank its block of the logits,
and ``vocab_parallel_xent`` takes the loss from them.

The serving steps (``prefill``, ``serve_step``, ``greedy_decode_loop``)
run under the same mesh: each rank holds its shards, its rows and its
block of the cache, and gets logits whole over the vocabulary, so every
rank of a model group takes the same argmax.  A family outside
``sharding.TP_FAMILIES`` raises there under a model axis larger than 1,
as ``LMTrainJob`` does."""
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


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        count: torch.Tensor | None = None) -> torch.Tensor:
    """``softmax_xent`` of logits split on the vocabulary over the model
    group, ``logits`` this rank's block (.., V/m) of it: the max and the
    sum of exponentials over the group (the max, a constant shift, carries
    no gradient), the gold logit from the rank that owns its id.  Every
    rank returns the whole loss."""
    logits = logits.float()
    n = logits.shape[-1]
    top = logits.detach().amax(dim=-1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=sharding.model_group())
    logz = top + torch.log(sharding.reduce(torch.exp(logits - top[..., None]).sum(-1)))
    local = labels.long() - sharding.model_index() * n
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = sharding.reduce(torch.where((local >= 0) & (local < n), gold, 0.0))
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
    xent = vocab_parallel_xent if logits.shape[-1] < cfg.vocab_size else softmax_xent
    ce = xent(logits[:, :-1], batch["labels"][:, 1:], count)
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
    and the rows are counted over the batch group first (the labels are
    known before the forward); the rank's loss is its masked NLL sum over
    the global count plus its row share of the MoE auxiliary loss, so the
    batch group's losses sum to the global loss and their gradients, summed
    leaf by leaf (``all_reduce``), are its gradient.  (A mean of per-rank
    means is wrong as soon as the ranks' masks differ.)  The batch group
    (``sharding.batch_group``) is every rank with no active mesh; under tensor
    parallelism it leaves out the model axis, whose ranks hold the same
    rows, one shard of each split leaf (its gradient that shard's), and
    every whole leaf's whole gradient; a group of one rank sums nothing.
    So the MoE auxiliary loss, whole on every model rank (each routes the
    same rows whole), enters each rank's loss once at its row share over
    the batch group, never once a model rank."""
    group, ways = sharding.batch_group(sharding.current_mesh())
    labels, rows = batch["labels"][:, 1:], batch["tokens"].shape[0]
    counts = torch.tensor([0.0, float(rows)], device=labels.device)
    counts[0] = (labels >= 0).sum()
    if ways > 1:
        dist.all_reduce(counts, group=group)
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(leaves, cfg, batch, count=counts[0].clamp_min(1.0),
                            row_share=rows / counts[1])
    flat = adamw.tree_leaves(leaves)
    grads = [g.contiguous() for g in torch.autograd.grad(loss, flat, allow_unused=False)]
    reported = torch.stack([loss.detach(), metrics["ce"].detach(), metrics["aux"].detach()])
    if ways > 1:
        for g in grads:
            dist.all_reduce(g, group=group)
        dist.all_reduce(reported, group=group)
    by_leaf = dict(zip(map(id, flat), grads))
    return reported[0], {"ce": reported[1], "aux": reported[2]}, adamw.tree_map(
        lambda p: by_leaf[id(p)], leaves)


def dp_opt_state(params: dict, specs: dict) -> dict:
    """AdamW's state for ``dp_update_``: zero moments of each leaf's block
    under ``specs`` (the moments' specs) on this rank, read against the
    rank's parameter shard (the whole leaf where no spec splits it), in
    fp32 on the parameters' device."""
    mesh = _active_mesh("dp_opt_state")

    def zeros(p, s):
        return torch.zeros(_block(p, s, mesh).shape, dtype=torch.float32, device=p.device)
    first = adamw.tree_leaves(params)[0]
    return {"mu": adamw.tree_map(zeros, params, specs), "nu": adamw.tree_map(zeros, params, specs),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _active_mesh(name: str):
    mesh = sharding.current_mesh()
    if mesh is None:
        raise ValueError(f"{name}: no active mesh (sharding.use_mesh)")
    return mesh


def _block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The moments' block of ``t``, a rank's parameter shard (or its
    gradient): ``spec``'s splits but the model axis's, which the shard
    has already taken."""
    return sharding.local_slice(t, sharding.without_axis(spec, "model"), mesh)


def global_norm(grads: dict, specs: dict) -> torch.Tensor:
    """The whole gradient's norm from this rank's shards: each leaf that
    ``specs`` split over the model axis sums its squares over the model
    group, a whole leaf counts once.  With no such leaf,
    ``adamw.global_norm``."""
    mesh = sharding.current_mesh()
    split, whole = [], []
    for g, s in zip(adamw.tree_leaves(grads), adamw.tree_leaves(specs)):
        on_model = any("model" in axes for _, axes, _, _ in sharding.splits(s, mesh))
        (split if on_model else whole).append(g)
    if not split:
        return adamw.global_norm(grads)
    sq = sum(torch.sum(torch.square(g.float())) for g in split)
    dist.all_reduce(sq, group=sharding.model_group())
    return torch.sqrt(sq + sum(torch.sum(torch.square(g.float())) for g in whole))


def dp_update_(params: dict, grads: dict, opt_state: dict, *, specs: dict,
               opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
               lr_scale: torch.Tensor | float = 1.0) -> dict:
    """AdamW in place on this rank's block of every leaf: the block under
    the moments' spec in ``specs`` (``launch.shardings.opt_shardings``'
    ``mu``), read against the rank's parameter shard, ``opt_state``'s
    moments being blocks of that shape already, clipped by the norm of the
    whole gradient (``global_norm``).  A leaf whose moments are split on
    the data axis (ZeRO-1) is then rebuilt on every rank of the data group
    from their blocks (``all_gather``), each rank keeping its model shard;
    the rest update in place.  Elementwise on the same gradient and clip
    factor: the same bits as the unsplit update."""
    mesh = _active_mesh("dp_update_")
    gnorm = global_norm(grads, specs)

    def blocks(tree):
        return adamw.tree_map(lambda t, s: _block(t, s, mesh), tree, specs)

    om = adamw.adamw_update_(blocks(params), blocks(grads), opt_state, opt_cfg, lr_scale,
                             gnorm=gnorm)
    for p, s in zip(adamw.tree_leaves(params), adamw.tree_leaves(specs)):
        s = sharding.without_axis(s, "model")
        if sharding.splits(s, mesh):
            sharding.gather_leaf(sharding.local_slice(p, s, mesh), s, mesh, out=p)
    return om


def dp_train_step(params: dict, opt_state: dict, batch: dict, *, cfg: ArchConfig, specs: dict,
                  opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                  lr_scale: torch.Tensor | float = 1.0):
    """One step over the mesh (``dp_grads``, then ``dp_update_``): this
    rank's parameter shards and moment blocks updated in place, as
    ``train_step`` does.  Under tensor parallelism the forward and backward
    run on the shards (the active mesh, ``models/sharding``).  Returns
    (params, opt_state, metrics), the metrics the global batch's."""
    loss, metrics, grads = dp_grads(params, batch, cfg=cfg)
    om = dp_update_(params, grads, opt_state, specs=specs, opt_cfg=opt_cfg, lr_scale=lr_scale)
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
    Returns (last-position logits (B,V), cache).  Under tensor parallelism
    the cache is this rank's block and the logits are whole over the
    vocabulary (``lm.whole_vocab``), as ``serve_step``'s are."""
    cache_len = cache_len or batch["tokens"].shape[1]
    logits, _, cache = lm.forward(params, cfg, batch, collect_cache=True,
                                  cache_len=cache_len)
    return lm.whole_vocab(logits[:, -1], cfg), cache


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
