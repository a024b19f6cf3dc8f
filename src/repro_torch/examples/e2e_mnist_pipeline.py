"""The paper's headline experiment, end to end (its §5.3), on the port:

  Katib hyperparameter tuning -> TFJob training with the best params ->
  KServe serving -> stress test, on BOTH cloud profiles (gcp, ibm),
  exporting the generated pipeline YAML (the minikf_generated_gcp.yaml
  analog) and the per-stage timing table (paper Tables 4/5).  Twin of
  ``examples/e2e_mnist_pipeline.py``.

    python -m repro_torch.examples.e2e_mnist_pipeline --device cpu
    python -m repro_torch.examples.e2e_mnist_pipeline               # on the card

Training and the served predicts run on ``--device``; the Predictor's
service times are measured there (synchronised before the clock is read).
Artifacts go under ``experiments/torch_e2e_mnist/``.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..checkpoint.store import ArtifactStore
from ..clouds.profiles import get_profile
from ..core.pipeline import Pipeline
from ..core.trainjob import SupervisedTrainJob
from ..data.mnist import Batches, make_dataset
from ..models import lenet
from ..models.modules import require_device
from ..serving.kserve import InferenceService, Predictor
from ..tuning import katib

ROOT = "experiments/torch_e2e_mnist"


def run_cloud(profile_name: str, store: ArtifactStore, dev: torch.device) -> dict:
    prof = get_profile(profile_name)
    imgs, labels = make_dataset(384, seed=0)
    pipe = Pipeline(f"e2e-mnist-{profile_name}", store, enable_cache=False)

    def katib_tuning():
        """Paper: random search over lr [0.01,0.05], batch [80,100]."""
        def objective(params, report):
            job = SupervisedTrainJob(lr=params["lr"], n_steps=10, width=8, device=dev)
            res = job.run(Batches(imgs, labels, int(params["batch_size"])),
                          report=report)
            return {"loss": res["loss"]}
        exp = katib.tune(
            objective,
            {"lr": katib.Double(0.01, 0.05),
             "batch_size": katib.Categorical((80, 96))},
            algorithm="random", max_trials=3, seed=0,
            early_stopping=katib.MedianStop(), store=store,
            name=f"mnist-{profile_name}")
        best = exp.best_trial()
        print(f"  katib best: {best.params} loss={exp.objective(best):.4f}")
        return best.params

    def tfjob_training(best):
        job = SupervisedTrainJob(lr=best["lr"], n_steps=60, width=8, store=store,
                                 device=dev)
        res = job.run(Batches(imgs, labels, int(best["batch_size"])),
                      checkpoint_name=f"mnist-{profile_name}")
        print(f"  tfjob: loss={res['loss']:.4f} acc={res['accuracy']:.3f}")
        return res["params"]

    def kserve_serving(params):
        @torch.inference_mode()
        def predict(x):
            return torch.argmax(lenet.apply(params, x), -1)

        pred = Predictor(f"mnist-{profile_name}", predict, imgs[:1], device=dev)
        svc = InferenceService(pred, prof, "kserve", max_batch=32,
                               max_replicas=4)
        res = svc.stress_test(128)
        print(f"  kserve: 128 reqs in {res.total_time_s:.3f}s "
              f"(p99 {res.p99 * 1e3:.1f}ms)")
        return res.summary()

    k = pipe.step(katib_tuning, cache=False)
    t = pipe.step(tfjob_training, k, cache=False)
    pipe.step(kserve_serving, t, cache=False)
    out = pipe.run()
    yaml_path = f"{ROOT}/pipeline_{profile_name}.yaml"
    pipe.export_yaml(yaml_path)
    stages = {e["name"]: round(e["duration_s"] + prof.startup_s, 2)
              for e in pipe.log.events if not e["name"].startswith("pipeline")}
    return {"stages_s": stages, "serving": out["kserve_serving"],
            "pipeline_yaml": yaml_path}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    store = ArtifactStore(ROOT)
    results = {}
    for profile in ("gcp", "ibm"):
        print(f"== cloud profile: {profile} ==")
        results[profile] = run_cloud(profile, store, dev)
        assert results[profile]["serving"]["n"] == 128
        assert store.exists(f"mnist-{profile}")
    results["device"] = str(dev)
    print(json.dumps(results, indent=1, default=str))
    return results


if __name__ == "__main__":
    main()
