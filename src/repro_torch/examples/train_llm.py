"""Training example: train a reduced config of a ported architecture on the
synthetic token pipeline through the TFJob analog.  Twin of
``examples/train_llm.py``.

    python -m repro_torch.examples.train_llm --arch granite-3-8b --steps 30 --device cpu
    python -m repro_torch.examples.train_llm --arch granite-3-8b --steps 30   # the card

The smoke configs, as in the reference.  On the card the model runs with
``use_kernels=True``: attention and the norms train through the
hand-written forward and backward kernels.  It checkpoints, reports its
stage times and, at 20 steps or more, asserts that the loss fell.
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
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get_smoke_config(args.arch).replace(use_kernels=True)
    log = EventLog()
    job = LMTrainJob(cfg, batch_size=args.batch, seq_len=args.seq,
                     n_steps=args.steps, lr=1e-3,
                     store=ArtifactStore("experiments/torch_artifacts"), log=log,
                     device=args.device)
    res = job.run(checkpoint_name=f"{cfg.name}-example")
    print(json.dumps({
        "arch": cfg.name,
        "device": args.device,
        "loss_first": round(res["history"][0], 4),
        "loss_last": round(res["loss"], 4),
        "checkpoint": res.get("checkpoint"),
        "stages_s": {k: round(v, 2) for k, v in log.totals().items()},
    }, indent=1))
    check(res["history"], args.steps)
    return res


def check(history: list, steps: int) -> None:
    """The reference example's own assert: at 20 steps or more (shorter
    runs are too noisy for a strict check) the loss fell."""
    if steps >= 20:
        assert min(history) < history[0], "loss should decrease"


if __name__ == "__main__":
    main()
