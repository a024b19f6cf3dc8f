"""TFJob analog: a training job, counterpart of ``repro.core.trainjob``.

Two flavours, as in the reference:
  * ``SupervisedTrainJob`` trains the paper's classifier (LeNet on MNIST)
    on ``device``: an eager step of ``lenet.loss_fn``,
    ``torch.autograd.grad`` and ``adamw_update``;
  * ``LMTrainJob`` trains any ported LM arch on the synthetic token
    pipeline (``data.tokens.lm_batches``): fp32 master parameters,
    ``steps.train_step`` (autograd through the kernels' backward where
    ``cfg.use_kernels`` is set, AdamW in place) under the reference's
    warmup-cosine schedule, and resume from a checkpoint with its
    optimizer state.  One card: a ``mesh`` raises (ROADMAP.md queue 1
    item 1.10).
Both log through the EventLog, checkpoint into the ArtifactStore (PVC
analog), and time their stages for the Tables 4/5 repro.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Iterable, Optional

import torch

from ..checkpoint.store import ArtifactStore
from ..configs.base import ArchConfig
from ..data import tokens as token_data
from ..models import lenet, lm, steps
from ..models.modules import require_device
from ..optim import adamw
from ..optim.schedules import warmup_cosine
from ..telemetry.events import EventLog


def train_step(params: dict, opt: dict, batch: dict, cfg: adamw.AdamWConfig):
    """One eager LeNet step on tensors: ``lenet.loss_fn``, the gradients by
    ``torch.autograd.grad``, then ``adamw_update``.  Returns (params, opt,
    metrics), the metrics tensors on the parameters' device."""
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = lenet.loss_fn(leaves, batch)
    flat = adamw.tree_leaves(leaves)
    by_leaf = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    grads = adamw.tree_map(lambda p: by_leaf[id(p)], leaves)
    params, opt, om = adamw.adamw_update(leaves, grads, opt, cfg)
    return params, opt, {**{k: v.detach() for k, v in metrics.items()}, **om}


class SupervisedTrainJob:
    """Train the LeNet classifier; the reference's knobs and defaults, plus
    the device it runs on."""

    def __init__(self, *, lr: float = 1e-3, batch_size: int = 64,
                 n_steps: int = 200, width: int = 16, seed: int = 0,
                 store: Optional[ArtifactStore] = None,
                 log: Optional[EventLog] = None, device="cuda"):
        self.lr = lr
        self.batch_size = batch_size
        self.n_steps = n_steps
        self.width = width
        self.seed = seed
        self.store = store
        self.log = log or EventLog()
        self.device = device

    def run(self, data: Iterable[dict], *, report: Optional[Callable] = None,
            checkpoint_name: str = "lenet") -> dict:
        dev = require_device(self.device)
        opt_cfg = adamw.AdamWConfig(lr=self.lr, weight_decay=1e-4)
        params = lenet.init_params(torch.Generator().manual_seed(self.seed),
                                   width=self.width, device=dev)
        opt = adamw.init_opt_state(params)

        it = iter(data)
        metrics = {}
        t0 = time.perf_counter()
        with self.log.stage("tfjob:train"):
            for i in range(self.n_steps):
                try:
                    batch = next(it)
                except StopIteration:
                    it = iter(data)
                    batch = next(it)
                batch = {k: torch.as_tensor(batch[k], device=dev) for k in ("image", "label")}
                params, opt, metrics = train_step(params, opt, batch, opt_cfg)
                if report and (i + 1) % max(self.n_steps // 5, 1) == 0:
                    report(i + 1, float(metrics["loss"]))
        out = {k: float(v) for k, v in metrics.items()}   # waits for the card
        out["wall_s"] = time.perf_counter() - t0
        if self.store:
            with self.log.stage("tfjob:checkpoint"):
                out["checkpoint"] = self.store.save_tree(checkpoint_name, params,
                                                         meta=out)
        out["params"] = params
        return out


class LMTrainJob:
    """LM training on one card: the reference's signature (``mesh`` must be
    None here), plus the device it runs on."""

    def __init__(self, cfg: ArchConfig, *, batch_size: int, seq_len: int,
                 n_steps: int, lr: float = 3e-4, seed: int = 0,
                 mesh=None, store: Optional[ArtifactStore] = None,
                 log: Optional[EventLog] = None, device="cuda"):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.n_steps = n_steps
        self.lr = lr
        self.seed = seed
        self.mesh = mesh
        self.store = store
        self.log = log or EventLog()
        self.device = device

    def run(self, *, report: Optional[Callable] = None,
            checkpoint_name: Optional[str] = None,
            resume_from: Optional[str] = None) -> dict:
        """resume_from: checkpoint name in the store -- restores params AND
        optimizer state, continuing the step counter (preemption recovery,
        the Kubernetes-rescheduling analog)."""
        if self.mesh is not None:
            raise NotImplementedError("LMTrainJob on a device mesh is not ported yet: "
                                      "ROADMAP.md queue 1 item 1.10 (sharding)")
        cfg = self.cfg
        dev = require_device(self.device)
        opt_cfg = adamw.AdamWConfig(lr=self.lr)
        schedule = functools.partial(warmup_cosine, warmup=max(self.n_steps // 10, 1),
                                     total=self.n_steps)
        with self.log.stage("tfjob:init"):
            params = lm.init_params(cfg, seed=self.seed, device=dev,
                                    dtype=getattr(torch, cfg.param_dtype))
            opt = adamw.init_opt_state(params)
            if resume_from and self.store:
                params = self.store.load_tree(resume_from, params)
                if self.store.exists(f"{resume_from}_opt"):
                    opt = self.store.load_tree(f"{resume_from}_opt", opt)
        data = token_data.lm_batches(cfg, self.batch_size, self.seq_len, seed=self.seed)
        history = []
        with self.log.stage("tfjob:train"):
            for i, batch in enumerate(data):
                if i >= self.n_steps:
                    break
                batch = {k: torch.as_tensor(batch[k], device=dev) for k in ("tokens", "labels")}
                params, opt, metrics = steps.train_step(params, opt, batch, cfg=cfg,
                                                        opt_cfg=opt_cfg, lr_scale=schedule(i))
                loss = float(metrics["loss"])
                history.append(loss)
                if report:
                    report(i + 1, loss)
        out = {"loss": history[-1] if history else float("nan"), "history": history}
        if self.store and checkpoint_name:
            with self.log.stage("tfjob:checkpoint"):
                out["checkpoint"] = self.store.save_tree(checkpoint_name, params,
                                                         meta={"loss": out["loss"]})
                self.store.save_tree(f"{checkpoint_name}_opt", opt)
        out["params"] = params
        return out
