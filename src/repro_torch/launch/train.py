"""Training launcher: `python -m repro_torch.launch.train --arch granite_3_8b
--layers 8 --batch 4 --seq 1024`.

Twin of ``repro.launch.train``, with the same flags and ``--device``
(default the card).  The model trains with ``use_kernels=True``: on the card
attention and every norm run the hand-written kernels both ways (the
forward kernels and their backward kernels); an arch whose kernels have no
backward yet raises, naming its ROADMAP item.  ``--smoke`` selects the
reduced config (``--smoke --device cpu`` runs the plain path on the host);
``--layers`` cuts the depth.  One card: ``--mesh local`` raises (ROADMAP.md
queue 1 item 1.10).
"""
from __future__ import annotations

import argparse
import json

from ..checkpoint.store import ArtifactStore
from ..configs import registry
from ..core.trainjob import LMTrainJob
from ..telemetry.events import EventLog


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
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    cfg = cfg.replace(use_kernels=True)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    log = EventLog()
    job = LMTrainJob(cfg, batch_size=args.batch, seq_len=args.seq,
                     n_steps=args.steps, lr=args.lr,
                     mesh=args.mesh if args.mesh == "local" else None,
                     store=ArtifactStore(args.store), log=log, device=args.device)
    res = job.run(checkpoint_name=f"{cfg.name}-smoke")
    print(json.dumps({"arch": cfg.name, "device": args.device,
                      "loss_first": res["history"][0], "loss_last": res["loss"],
                      "stages": log.totals()}, indent=1))


if __name__ == "__main__":
    main()
