"""Quickstart on the port: build and run a 3-step pipeline.  Twin of
``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart --device cpu
    python -m repro_torch.examples.quickstart               # on the card

Mirrors the paper's 'lightweight components' flow (its Fig. 14): plain
python functions become pipeline steps; the framework adds ordering,
caching, artifact storage, stage timing, and a YAML spec export.  LeNet
trains and evaluates on ``--device``; artifacts go under
``experiments/torch_quickstart/``.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..checkpoint.store import ArtifactStore
from ..core.pipeline import Pipeline, component
from ..core.trainjob import SupervisedTrainJob
from ..data.mnist import Batches, make_dataset
from ..models import lenet
from ..models.modules import require_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    @component
    def load_data():
        imgs, labels = make_dataset(512, seed=0)
        return {"n": len(labels)}

    @component
    def train(data_info):
        imgs, labels = make_dataset(data_info["n"], seed=0)
        job = SupervisedTrainJob(lr=2e-3, n_steps=40, width=8, device=dev)
        res = job.run(Batches(imgs, labels, 64))
        return {"loss": res["loss"], "accuracy": res["accuracy"],
                "params": res["params"]}

    @component
    def evaluate(trained):
        imgs, labels = make_dataset(128, seed=7)
        with torch.inference_mode():
            pred = torch.argmax(lenet.apply(trained["params"], imgs), -1).cpu().numpy()
        return {"holdout_accuracy": float((pred == labels).mean())}

    store = ArtifactStore("experiments/torch_quickstart")
    pipe = Pipeline("quickstart", store)
    d = pipe.step(load_data, cache=False)
    t = pipe.step(train, d, cache=False)
    pipe.step(evaluate, t, cache=False)
    out = pipe.run(verbose=True)
    print("\npipeline spec:\n" + pipe.export_yaml())
    summary = {"device": str(dev), "train_loss": out["train"]["loss"],
               **out["evaluate"]}
    print(json.dumps(summary))
    assert out["evaluate"]["holdout_accuracy"] > 0.5
    return summary


if __name__ == "__main__":
    main()
