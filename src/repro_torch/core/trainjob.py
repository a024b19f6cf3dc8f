"""TFJob analog: a training job, counterpart of ``repro.core.trainjob``.

``SupervisedTrainJob`` trains the paper's classifier (LeNet on MNIST) on
``device``: an eager step of ``lenet.loss_fn``, ``torch.autograd.grad`` and
``adamw_update``.  It logs through the EventLog, checkpoints into the
ArtifactStore (PVC analog), and times its stages for the Tables 4/5 repro.
The reference's ``LMTrainJob`` raises here until ROADMAP.md queue 1 item
1.5 ports it.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch

from ..checkpoint.store import ArtifactStore
from ..models import lenet
from ..models.modules import require_device
from ..optim import adamw
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
    """The reference's distributed LM training job, not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("core.trainjob.LMTrainJob is not ported yet: ROADMAP.md "
                                  "queue 1 item 1.5 (LM training)")
