"""Training launcher: `python -m repro_torch.launch.train --arch granite_3_8b
--layers 8 --batch 4 --seq 1024`.

Twin of ``repro.launch.train``, with the same flags and ``--device``
(default the card).  The model trains with ``use_kernels=True``: on the card
attention and every norm run the hand-written kernels both ways (the
forward kernels and their backward kernels); an arch whose kernels have no
backward yet raises, naming its ROADMAP item.  ``--smoke`` selects the
reduced config (``--smoke --device cpu`` runs the plain path on the host);
``--layers`` cuts the depth.

``--mesh local`` trains data-parallel (``LMTrainJob(mesh=...)``) on the
reference's local mesh, every rank on the data axis, under the config's
``sharding_profile`` and ``zero1``.  Under
``python -m torch.distributed.run --nproc-per-node N`` each rank joins the
group and takes the card ``cuda:{LOCAL_RANK}``; run plainly, it is a group
of one rank.  The group's backend is ``--dist-backend``: nccl by default on
the card, gloo on the CPU; nccl with more ranks on a host than it has
cards raises (it refuses two ranks on one card), and nothing switches the
backend or the device behind the caller's back.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from ..checkpoint.store import ArtifactStore
from ..configs import registry
from ..core.trainjob import LMTrainJob
from ..telemetry.events import EventLog
from .mesh import make_local_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--store", default="experiments/torch_artifacts")
    ap.add_argument("--mesh", choices=("local", "none"), default="none")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="--mesh local: the group's backend (nccl on the card, gloo on the CPU)")
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    cfg = cfg.replace(use_kernels=True)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.mesh == "none":
        return _train(cfg, args, args.device, None)

    device = torch.device(args.device)
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if backend == "nccl" and (device.type != "cuda" or ranks_here > torch.cuda.device_count()):
        raise ValueError(f"nccl: {ranks_here} rank(s) on this host on {args.device!r}, "
                         f"{torch.cuda.device_count()} card(s): nccl needs a card a rank "
                         "(--dist-backend gloo shares one)")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)      # nccl's communicator and barrier use the current card
    joined = not dist.is_initialized()
    if joined:
        if "RANK" in os.environ:           # torch.distributed.run's environment
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        return _train(cfg, args, device, make_local_mesh(device.type))
    finally:
        if joined:
            dist.destroy_process_group()


def _train(cfg, args, device, mesh):
    log = EventLog()
    job = LMTrainJob(cfg, batch_size=args.batch, seq_len=args.seq,
                     n_steps=args.steps, lr=args.lr, mesh=mesh,
                     store=ArtifactStore(args.store), log=log, device=device)
    res = job.run(checkpoint_name=f"{cfg.name}-smoke")
    if mesh is None or dist.get_rank() == 0:
        print(json.dumps({"arch": cfg.name, "device": str(device),
                          "mesh": None if mesh is None else mesh.shape,
                          "loss_first": res["history"][0], "loss_last": res["loss"],
                          "stages": log.totals()}, indent=1))
    return res


if __name__ == "__main__":
    main()
