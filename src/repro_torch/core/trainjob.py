"""TFJob analog: a training job, counterpart of ``repro.core.trainjob``.

Two flavours, as in the reference:
  * ``SupervisedTrainJob`` trains the paper's classifier (LeNet on MNIST)
    on ``device``: an eager step of ``lenet.loss_fn``,
    ``torch.autograd.grad`` and ``adamw_update``;
  * ``LMTrainJob`` trains any ported LM arch on the synthetic token
    pipeline (``data.tokens.lm_batches``, every field of its batches):
    fp32 master parameters, ``steps.train_step`` (autograd through the
    kernels' backward where ``cfg.use_kernels`` is set, AdamW in place)
    under the reference's warmup-cosine schedule, and resume from a
    checkpoint with its optimizer state.  With a ``mesh``
    (``launch.mesh``) it trains over the ranks of the process group under
    ``cfg.sharding_profile``: rank 0's parameters broadcast to every rank,
    each rank keeping its block of each leaf under the fitted spec
    (``models.sharding.param_shardings``: the whole leaf under data
    parallelism, its shard on a model axis larger than 1 under ``tp``:
    tensor parallelism, the dense, VLM, MoE, SSM, hybrid and enc-dec
    archs), each rank on its rows of every global batch
    (``launch.shardings``) and, with ``cfg.zero1``, AdamW's moments split
    over the data axis too (``steps.dp_train_step``).  A family that
    ``sharding.TP_FAMILIES`` does not list refuses a mesh that would shard
    one of its parameters, naming ROADMAP.md queue 1 item 1.13.
    Every attention trains through the flash kernels both ways, at every
    head dim (gemma3's 320 and deepseek's MLA 192 too), zamba2's Mamba2
    scan through ``ssm_scan`` and its backward kernel, and xlstm's mLSTM
    scan through ``mlstm_scan`` and its backward kernel.
Both log through the EventLog, checkpoint into the ArtifactStore (PVC
analog), and time their stages for the Tables 4/5 repro.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from ..checkpoint.store import ArtifactStore
from ..configs.base import ArchConfig
from ..data import tokens as token_data
from ..launch import shardings
from ..models import lenet, lm, sharding as msh, steps
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
    """LM training: the reference's signature, plus the device it runs on.
    ``mesh``: a ``launch.mesh.Mesh`` over the process group's ranks, this
    process one of them; ``device`` is then this rank's card."""

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
        the Kubernetes-rescheduling analog).  Under a mesh every rank loads
        the whole tree and keeps its blocks, and rank 0 saves the whole
        tree (parameter shards and moment blocks gathered) while the others
        wait: a checkpoint loads at any mesh.  Returns the loss history,
        the parameters (under tensor parallelism, this rank's shards) and
        ``opt_state`` (this rank's moment blocks)."""
        cfg, mesh = self.cfg, self.mesh
        if mesh is not None:
            _refuse_sharded_params(cfg, mesh)
        dev = require_device(self.device)
        opt_cfg = adamw.AdamWConfig(lr=self.lr)
        schedule = functools.partial(warmup_cosine, warmup=max(self.n_steps // 10, 1),
                                     total=self.n_steps)
        with msh.use_profile(cfg.sharding_profile), msh.use_mesh(mesh):
            with self.log.stage("tfjob:init"):
                params, opt, specs, pspecs = self._init(dev, resume_from)
            data = token_data.lm_batches(cfg, self.batch_size, self.seq_len, seed=self.seed)
            history = []
            with self.log.stage("tfjob:train"):
                for i, batch in enumerate(data):
                    if i >= self.n_steps:
                        break
                    batch = self._rows(batch, dev)
                    if mesh is None:
                        params, opt, metrics = steps.train_step(
                            params, opt, batch, cfg=cfg, opt_cfg=opt_cfg, lr_scale=schedule(i))
                    else:
                        params, opt, metrics = steps.dp_train_step(
                            params, opt, batch, cfg=cfg, specs=specs, opt_cfg=opt_cfg,
                            lr_scale=schedule(i))
                    loss = float(metrics["loss"])
                    history.append(loss)
                    if report:
                        report(i + 1, loss)
            out = {"loss": history[-1] if history else float("nan"), "history": history}
            if self.store and checkpoint_name:
                with self.log.stage("tfjob:checkpoint"):
                    out["checkpoint"] = self._save(checkpoint_name, params, opt, specs,
                                                   pspecs, {"loss": out["loss"]})
        out["params"] = params
        out["opt_state"] = opt
        return out

    def _init(self, dev: torch.device, resume_from: Optional[str]):
        """(params, opt, the moments' and the parameters' specs under the
        mesh, else None and None).  Under a mesh each leaf is broadcast
        whole from rank 0 (or read whole from the checkpoint) in turn, and
        every rank keeps its block of it (``local_slice``, cloned so the
        whole leaf is freed); the moments' blocks are read against that
        shard (``steps.dp_opt_state``)."""
        cfg, mesh, store = self.cfg, self.mesh, self.store
        dtype = getattr(torch, cfg.param_dtype)
        if mesh is None:
            params = lm.init_params(cfg, seed=self.seed, device=dev, dtype=dtype)
            opt = adamw.init_opt_state(params)
            if resume_from and store:
                params = store.load_tree(resume_from, params)
                if store.exists(f"{resume_from}_opt"):
                    opt = store.load_tree(f"{resume_from}_opt", opt)
            return params, opt, None, None
        meta = lm.init_params(cfg, device="meta", dtype=dtype)
        pspecs = msh.param_shardings(meta, mesh)
        specs = shardings.opt_shardings(None, meta, mesh, zero1=cfg.zero1)["mu"]
        host = adamw.tree_map(lambda p: torch.empty(0, dtype=p.dtype), meta)   # dtypes, host

        def own(whole, spec):
            block = msh.local_slice(whole, spec, mesh)
            return block.clone() if block is not whole else whole

        if resume_from and store:
            params = adamw.tree_map(lambda w, s: own(w, s).to(dev),
                                    store.load_tree(resume_from, host), pspecs)
        else:
            # rank 0 draws the parameters, every other rank receives them
            first = dist.get_rank() == 0
            drawn = lm.init_params(cfg, seed=self.seed, device=dev if first else "meta",
                                   dtype=dtype)

            def receive(t, spec):
                whole = t if first else torch.empty_like(t, device=dev)
                dist.broadcast(whole, src=0)
                return own(whole, spec)
            params = adamw.tree_map(receive, drawn, pspecs)
            del drawn
        opt = steps.dp_opt_state(params, specs)
        if resume_from and store and store.exists(f"{resume_from}_opt"):
            whole = store.load_tree(f"{resume_from}_opt", {
                "mu": host, "nu": host, "step": torch.empty(0, dtype=torch.int32)})
            for key in ("mu", "nu"):
                adamw.tree_map(lambda b, w, s: b.copy_(msh.local_slice(w, s, mesh)),
                               opt[key], whole[key], specs)
            opt["step"] = whole["step"].to(dev)
        return params, opt, specs, pspecs

    def _rows(self, batch: dict, dev: torch.device) -> dict:
        """A global batch of ``lm_batches`` -> this rank's rows of every
        field on ``dev`` (``launch.shardings.batch_shardings``)."""
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self.mesh is not None:
            specs = shardings.batch_shardings(batch, self.mesh)
            batch = {k: msh.local_slice(v, specs[k], self.mesh) for k, v in batch.items()}
        return {k: v.to(dev) for k, v in batch.items()}

    def _save(self, name: str, params: dict, opt: dict, specs, pspecs, meta: dict) -> str:
        """The whole tree under the reference's names (``name``,
        ``f"{name}_opt"``); under a mesh the parameter shards (over the
        model axis) and the moment blocks (over data and model) are
        gathered, each leaf to the host in turn, rank 0 writes and the
        other ranks wait."""
        if self.mesh is None:
            uri = self.store.save_tree(name, params, meta=meta)
            self.store.save_tree(f"{name}_opt", opt)
            return uri

        def whole(tree, spec_tree):
            return adamw.tree_map(lambda b, s: msh.gather_leaf(b, s, self.mesh).cpu(),
                                  tree, spec_tree)
        params = whole(params, pspecs)
        moments = {key: whole(opt[key], specs) for key in ("mu", "nu")}
        moments["step"] = opt["step"]
        if dist.get_rank() == 0:
            self.store.save_tree(name, params, meta=meta)
            self.store.save_tree(f"{name}_opt", moments)
        dist.barrier()
        return self.store.tree_uri(name)


def _refuse_sharded_params(cfg: ArchConfig, mesh) -> None:
    """``sharding.refuse_outside_tp`` under the job's mesh and profile:
    before any work, as the serving steps refuse at entry."""
    with msh.use_profile(cfg.sharding_profile), msh.use_mesh(mesh):
        msh.refuse_outside_tp(cfg, "LMTrainJob")
