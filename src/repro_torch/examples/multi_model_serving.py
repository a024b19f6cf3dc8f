"""Serve a heterogeneous model fleet through the port's model-mesh gateway:
a LeNet classifier, a synthetic embedding model, and a continuous-batched
LLM behind one router -- with a canary split, a scale-to-zero cold-start
cycle, a SPLIT-aware multi-cloud placement plan (a model may serve
active-active from several clouds at once), and the simulated dollar bill
for the run (CloudProfile price sheet; a simulation output).  Twin of
``examples/multi_model_serving.py``.

    python -m repro_torch.examples.multi_model_serving --device cpu
    python -m repro_torch.examples.multi_model_serving    # on the card

Every backend's service time is measured on ``--device``: LeNet and the
embedder through the port's Predictor, the LLM (the arch's smoke config,
as in the reference) by draining real requests through its
ContinuousBatcher.  Weights come from seeded torch generators.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..clouds.profiles import get_profile
from ..configs import registry
from ..data.mnist import make_dataset
from ..models import lenet, lm
from ..models.modules import require_device
from ..serving.continuous import ContinuousBatcher
from ..serving.gateway import (AutoscalerConfig, BatcherBackend, CloudCapacity,
                               Gateway, ModelDemand, Predictor, TrafficSpec,
                               plan_placement)
from ..telemetry.events import EventLog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o_danube_3_4b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    # -- three very different backends -------------------------------------
    imgs, _ = make_dataset(8, seed=0)
    lp = lenet.init_params(torch.Generator().manual_seed(0), device=dev)

    def predictor(name, fn, example):
        return Predictor(name, torch.inference_mode()(fn), example, device=dev)

    classifier = predictor("lenet", lambda x: torch.argmax(lenet.apply(lp, x), -1), imgs[:1])
    classifier.warmup((1, 8))

    w = torch.randn((128, 128), generator=torch.Generator().manual_seed(1)).to(dev)
    embedder = predictor("embed", lambda v: torch.tanh(torch.as_tensor(v, device=dev) @ w),
                         np.zeros((1, 128), np.float32))
    embedder.warmup((1, 8))
    embedder_v2 = predictor("embed-v2",
                            lambda v: torch.tanh(torch.as_tensor(v, device=dev) @ w.T),
                            np.zeros((1, 128), np.float32))

    cfg = registry.get_smoke_config(args.arch)
    llm = BatcherBackend(
        "llm", ContinuousBatcher(cfg, lm.init_params(cfg, seed=0, device=dev),
                                 max_slots=2, max_len=64),
        prompt_len=4, gen_tokens=4)

    # -- place the fleet over gcp/ibm, then simulate it ---------------------
    # demands in fixed Erlangs (rate = load / measured service time) so the
    # plan is the same shape on any device, however fast the measurement
    t_lenet = classifier.service_time(8) / 8
    t_embed = embedder.service_time(8) / 8
    t_llm = llm.service_time(2)
    demands = [ModelDemand("lenet", 3.0 / t_lenet, t_lenet),
               ModelDemand("embed", 1.0 / t_embed, t_embed),
               ModelDemand("llm", 0.5 / t_llm, t_llm)]
    # gcp is cheap but small: the heaviest model cannot fit there whole, so
    # the split planner serves it ACTIVE-ACTIVE from both clouds at once
    clouds = [CloudCapacity(get_profile("gcp"), 4, 1.0),
              CloudCapacity(get_profile("ibm"), 10, 1.4)]
    plan = plan_placement(demands, clouds, objective="cost", split=True)
    print("placement (cost, split-aware):", json.dumps(plan.summary(), indent=1))
    assert plan.feasible, "fleet does not fit the configured clouds"
    split_of = {a.model: {get_profile(c): wt for c, wt in a.weights.items()}
                for a in plan.assignments}
    # the plan's expected-queue hints seed queue-aware routing (the
    # default policy) before any real queue signal exists
    hint_of = {a.model: dict(a.est_wait_s) for a in plan.assignments}

    log = EventLog()
    gw = Gateway(capacity=plan.capacity_map(), log=log)
    gw.deploy("lenet", classifier, split=split_of["lenet"],
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=4,
                                          target_queue=8, idle_window_s=2.0),
              max_batch=8, queue_hint=hint_of["lenet"])
    gw.deploy("embed", embedder, split=split_of["embed"],
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=4,
                                          target_queue=8, idle_window_s=2.0),
              max_batch=16, canary=embedder_v2, canary_fraction=0.25,
              queue_hint=hint_of["embed"])
    gw.deploy("llm", llm, split=split_of["llm"],
              autoscaler=AutoscalerConfig(min_replicas=0, max_replicas=2,
                                          scale_up_delay_s=0.5,
                                          idle_window_s=1.0), max_batch=4,
              queue_hint=hint_of["llm"])
    out = gw.run([
        TrafficSpec("lenet", 200, arrival="poisson", rate=1000.0),
        TrafficSpec("embed", 128),                 # burst, 25% canary
        TrafficSpec("llm", 4),                     # cold start
        TrafficSpec("llm", 4, start_s=8.0),        # scale-to-zero -> cold again
    ], seed=0)
    print("fleet:", json.dumps(out.summary(), indent=1))
    print("final split weights:", json.dumps(gw.final_weights, indent=1))
    print(f"simulated run cost: ${out.total_cost_usd:.6f} "
          "(price-sheet output, not a measurement)")
    trace = [(round(t, 3), p) for t, p in out.per_model["llm"].replica_trace]
    print("llm replica trace (scale-to-zero cycle):", trace)

    # the LLM backend is real: generate through the same batcher
    outputs = llm.generate([[5, 17, 99], [7, 8, 9]], max_new=4)
    print("llm generations:", outputs)

    assert out.cold_starts["llm"] >= 2
    assert sum(out.per_model["embed"].per_version.values()) == 128
    assert out.per_model["lenet"].n_requests == 200
    assert all(len(o) == 4 for o in outputs)
    return {"device": str(dev), "cold_starts_llm": out.cold_starts["llm"],
            "served": {m: r.n_requests for m, r in out.per_model.items()},
            "embed_per_version": dict(out.per_model["embed"].per_version),
            "service_time_s": {"lenet": t_lenet, "embed": t_embed, "llm": t_llm},
            "generations": outputs}


if __name__ == "__main__":
    main()
