"""The paper's Table 4/5 story end to end on the port's orchestrator, the
MNIST leg: a RECURRING pipeline (Kubeflow Runs / Recurring Runs) that tunes
and trains MNIST on the cheapest simulated cloud, profiles the trained
model per cloud into Model-CI artifacts, hands it to the serving gateway
through a terminal ``deploy`` step with a SPLIT placement planned from those
artifacts (gcp capacity-pinned, spill to ibm), then stress-tests the
deployed model -- pipeline -> profile -> placement -> live serving in one
run.  Then the registry-model leg (``registry_leg``): gemma3-4b profiled
analytically (``roofline_fields`` over the card's ``HardwareSpec``) on gcp
and ibm into the same store and deployed on ibm behind a
``ProfiledBackend``, with no hand-tuned number anywhere.  Twin of
``examples/e2e_train_to_serve.py``.

The second recurring firing reuses every training and profiling artifact
from the cross-run cache (only the deploy step re-executes: the handoff is
a side effect).  One Tracer is shared by the orchestrator and the gateway,
so the pipeline's span tree and the serving spans form a single connected
trace; one CapacityMarket is shared too, so the burst's gcp floor preempts
the recorded training leases (spot semantics).

Stage compute and the Predictor's service times are MEASURED on
``--device`` (the card by default, synchronised before each clock read);
startup / RTT / transfer / dollar figures derive from the CloudProfile
constants and are simulation outputs, and the registry model's service
time is a closed form of its config and the H100's data-sheet peaks.

    python -m repro_torch.examples.e2e_train_to_serve --device cpu
    python -m repro_torch.examples.e2e_train_to_serve               # on the card
"""
from __future__ import annotations

import argparse
import json

import torch

from ..clouds.capacity import CapacityMarket
from ..clouds.profiles import get_profile
from ..configs.registry import get_config
from ..core.pipeline import Pipeline
from ..core.trainjob import SupervisedTrainJob
from ..data.mnist import Batches, make_dataset
from ..modelci import ProfiledBackend, ProfileSpec, ProfileStore, measure, roofline_fields
from ..models import lenet
from ..models.modules import require_device
from ..pipelines import ArtifactCache, DeploySpec, Orchestrator, PipelineRuns
from ..serving.gateway import (AutoscalerConfig, CloudCapacity, Gateway,
                               Predictor, TrafficSpec)
from ..telemetry.analyze import request_table, run_table, validate_trace
from ..telemetry.events import EventLog
from ..telemetry.metrics import MetricsRegistry
from ..telemetry.trace import Tracer
from ..tuning import katib


def lenet_predictor(params: dict, example, device, warm=(1, 8, 16)) -> Predictor:
    """The trained LeNet behind the port's Predictor: argmax of ``apply``
    on a numpy batch, its service times measured on ``device``."""
    @torch.inference_mode()
    def predict(x):
        return torch.argmax(lenet.apply(params, x), -1)

    pred = Predictor("mnist", predict, example, device=device)
    pred.warmup(warm)
    return pred


def train_to_serve(imgs, labels, *, device, width=8, lr_space=(0.01, 0.05), tune_steps=8,
                   train_steps=30) -> dict:
    """Author, compile and run the recurring tune -> train -> profile x2 ->
    deploy pipeline twice (batches of 64, three Katib trials), then serve
    512 Poisson requests at half the deployed fleet's ceiling.  The result
    holds the trainer's (``trained``: its params, its reported losses, the
    lr Katib chose) beside the runs, for callers that hold the trained model
    to more gates."""
    gcp, ibm = get_profile("gcp"), get_profile("ibm")
    trained: dict = {"reported": []}

    def tune():
        def objective(params, report):
            job = SupervisedTrainJob(lr=params["lr"], n_steps=tune_steps, width=width,
                                     device=device)
            return {"loss": job.run(Batches(imgs, labels, 64), report=report)["loss"]}
        exp = katib.tune(objective, {"lr": katib.Double(*lr_space)},
                         algorithm="random", max_trials=3, seed=0)
        return exp.best_trial().params

    def train(best):
        job = SupervisedTrainJob(lr=best["lr"], n_steps=train_steps, width=width, device=device)
        res = job.run(Batches(imgs, labels, 64),
                      report=lambda i, v: trained["reported"].append(v))
        print(f"  train: lr={best['lr']:.4f} loss={res['loss']:.4f} "
              f"acc={res['accuracy']:.3f} ({train_steps} steps in {res['wall_s']:.3f} s)")
        trained.update(res, lr=best["lr"])
        return res["params"]

    def profile(params):
        # cloud-agnostic measurement of the trained backend; the
        # orchestrator stamps the per-cloud load_s constant at commit
        return measure(lenet_predictor(params, imgs[:1], device), max_batch=16,
                       weights=params)

    def deploy_backend(params, *_profiles):
        return lenet_predictor(params, imgs[:1], device)

    # the profile artifacts live in the SAME ArtifactCache the step
    # artifacts do: one residency/egress rule set for both
    cache = ArtifactCache()
    store = ProfileStore(cache)
    # gcp holds only 2 replicas, so the 2.0-Erlang demand (3 replicas at
    # 0.7 target utilization) forces a split placement, planned entirely
    # from the committed profile artifacts (DeploySpec.profile)
    pipe = Pipeline("train-to-serve")
    best = pipe.step(tune)
    model = pipe.step(train, best)
    profs = [pipe.step(profile, model, name=f"profile_{c}", kind="profile", pin=c,
                       payload=ProfileSpec("mnist", store, max_batch=16))
             for c in ("gcp", "ibm")]
    pipe.step(deploy_backend, model, *profs, name="deploy", kind="deploy",
              payload=DeploySpec(
                  "mnist",
                  clouds=[CloudCapacity(gcp, 2, 1.0), CloudCapacity(ibm, 4, 1.4)],
                  load_erlangs=2.0, objective="cost", split=True,
                  autoscaler=AutoscalerConfig(min_replicas=3, max_replicas=4,
                                              target_queue=8, idle_window_s=2.0),
                  max_batch=16, profile=store))
    spec = pipe.compile()

    log = EventLog()
    tracer = Tracer()                    # ONE tracer spans train AND serve
    registry = MetricsRegistry()
    # ONE capacity market under both planes: gcp is tight (2 slots), so the
    # serving floor must preempt the recorded training leases to come up
    market = CapacityMarket({"gcp": 2, "ibm": 4})
    gw = Gateway(log=log, tracer=tracer, metrics=registry, shared_capacity=market)
    # cost policy: tuning + training land on the CHEAPEST simulated cloud
    orch = Orchestrator({"gcp": 2, "ibm": 2}, policy="cost", log=log,
                        tracer=tracer, cache=cache, shared_capacity=market)
    recs = PipelineRuns(orch).recurring(spec, every_s=300.0, runs=2, gateway=gw)

    backend = gw.deployments["mnist"].backend
    rate = 0.5 * 3 * 16 / backend.service_time(16)   # ~50% of fleet ceiling
    served = gw.run([TrafficSpec("mnist", 512, arrival="poisson", rate=rate)], seed=0)
    return {"recs": recs, "store": store, "log": log, "tracer": tracer,
            "registry": registry, "market": market, "served": served,
            "backend": backend, "rate": rate, "requests": 512, "trained": trained,
            "orchestrator": orch, "gateway": gw}


def check(out: dict) -> dict:
    """The example's acceptance: cheapest-cloud training, a profile-planned
    split deploy, a cached rerun, a contended capacity market, one
    connected trace, and the deployed model served every request.  Returns
    the readings the asserts were made on."""
    recs, store, log, tracer = out["recs"], out["store"], out["log"], out["tracer"]
    registry, n = out["registry"], out["requests"]
    res = out["served"].per_model["mnist"]
    deploy_out = recs[-1].outputs["deploy"]
    planned = store.worst("mnist")
    n_served = registry.total("gateway_requests_total", outcome="served")
    assert all(r.status == "succeeded" for r in recs)
    assert all(recs[0].steps[s].cloud in (None, "gcp")
               for s in ("tune", "train") if not recs[0].steps[s].cached), \
        "cost policy must train on the cheap cloud"
    assert len(deploy_out["replicas"]) == 2          # genuinely split
    assert abs(sum(deploy_out["weights"].values()) - 1.0) < 1e-6
    assert deploy_out["profiled"], "demand must come from the ProfileStore"
    assert store.clouds("mnist") == ["gcp", "ibm"]   # one artifact per cloud
    assert planned.source == "measured"
    # tune + train + both profile measurements cached; a cache-hit profile
    # firing still refreshes the store's latest pointer
    assert recs[1].cache_hits == 4
    assert log.count("modelci:profile") == 4         # committed every firing
    assert not recs[1].steps["deploy"].cached        # handoff re-executes
    assert [s for s, r in recs[1].steps.items() if not r.cached] == ["deploy"]
    assert res.n_requests == n and len(res.latencies_s) == n
    assert log.count("pipeline:deploy") == 2
    assert out["served"].makespan_s > 0
    # the shared market contended: the serving floor preempted at least one
    # recorded training lease, and no cloud was over-committed
    assert log.count("capacity:preempt") >= 1
    assert log.count("capacity:lease") >= 1
    out["market"].check_conservation()
    # the pipeline trace and the serving trace are ONE connected component:
    # every served request span is reachable from the second run's root
    assert not validate_trace(tracer)
    linked = tracer.reachable(recs[1].span_id)
    request_roots = [s for s in tracer.named("gateway.request")
                     if s.attrs.get("outcome") == "served"]
    assert request_roots and all(s.span_id in linked for s in request_roots)
    assert n_served == len(request_roots) == n
    return {"runs": [r.summary() for r in recs],
            "deploy": {"weights": deploy_out["weights"], "replicas": deploy_out["replicas"]},
            "planned_from": {"key": planned.key, "cloud": planned.cloud,
                             "service_time_s": planned.service_time_s,
                             "max_batch": planned.max_batch,
                             "memory_bytes": planned.memory_bytes},
            "stress": {"requests": n, "rate_rps": out["rate"], "p50_s": res.p50,
                       "p99_s": res.p99, "sim_cost_usd": out["served"].total_cost_usd},
            "leases": log.count("capacity:lease"), "preempts": log.count("capacity:preempt"),
            "spans": len(tracer.spans)}


def registry_leg(out: dict) -> dict:
    """The registry-model leg, after ``check`` on the same orchestrator,
    store and gateway: gemma3-4b profiled analytically on gcp and ibm
    (``roofline_fields``: every term a closed form of the config and the
    ``HardwareSpec``), per-cloud artifacts committed into the SAME store,
    and deployed on ibm behind a ``ProfiledBackend`` whose cost model IS the
    artifact (gcp's 2 market slots are held by the MNIST serving floor);
    then 24 Poisson requests at half its service rate.  The reference
    example's asserts; returns what they were made on."""
    store, orch, gw = out["store"], out["orchestrator"], out["gateway"]
    cfg = get_config("gemma3_4b")

    def roofline_profile():
        return roofline_fields(cfg)

    gpipe = Pipeline("profile-gemma")
    gprofs = [gpipe.step(roofline_profile, name=f"profile_{c}", kind="profile", pin=c,
                         payload=ProfileSpec(cfg.name, store, max_batch=1))
              for c in ("gcp", "ibm")]
    gpipe.step(lambda *_: ProfiledBackend(store.worst(cfg.name)), *gprofs,
               name="deploy", kind="deploy",
               payload=DeploySpec(
                   cfg.name,
                   clouds=[CloudCapacity(get_profile("ibm"), 4, 1.4)],
                   load_erlangs=1.0, objective="cost", split=True,
                   autoscaler=AutoscalerConfig(min_replicas=2, max_replicas=3,
                                               target_queue=4, idle_window_s=2.0),
                   max_batch=1, profile=store))
    grec = orch.execute(gpipe.compile(), gateway=gw)
    gout = grec.outputs["deploy"]
    gprof = store.worst(cfg.name)
    gserved = gw.run([TrafficSpec(cfg.name, 24, arrival="poisson",
                                  rate=0.5 / gprof.service_time_s)], seed=0)
    gres = gserved.per_model[cfg.name]
    assert grec.status == "succeeded"
    assert gout["profiled"] and gprof.source == "roofline"
    assert gres.n_requests == 24
    # the analytic profile is derived, not typed in: its terms reproduce
    # from the config alone
    assert gprof.roofline is not None and gprof.memory_bytes == \
        2 * cfg.approx_active_params()
    return {"model": cfg.name, "key": gprof.key, "service_time_s": gprof.service_time_s,
            "memory_bytes": gprof.memory_bytes, "placement": gout["weights"],
            "requests": gres.n_requests, "p50_s": gres.p50, "p99_s": gres.p99,
            "sim_cost_usd": gserved.total_cost_usd}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    imgs, labels = make_dataset(256, seed=0)
    out = train_to_serve(imgs, labels, device=dev)
    for rec in out["recs"]:
        print(f" {rec.run_id} [{rec.status}] makespan {rec.makespan_s:.2f}s "
              f"sim ${rec.cost_usd:.6f} cache_hits={rec.cache_hits}")
        for name, r in rec.steps.items():
            print(f"   {name:12s} {r.cloud or '-':4s} {r.duration_s:8.3f}s "
                  f"{'cached' if r.cached else f'x{len(r.attempts)}'}")
    summary = check(out)
    summary["registry_model"] = reg = registry_leg(out)
    print(f"\nregistry model {reg['model']}: roofline profile {reg['key']} "
          f"({reg['service_time_s'] * 1e3:.1f} ms/req, {reg['memory_bytes'] / 1e9:.1f} GB "
          f"weights) -> placement {json.dumps(reg['placement'])}; 24 requests p50 "
          f"{reg['p50_s']:.3f} s p99 {reg['p99_s']:.3f} s sim ${reg['sim_cost_usd']:.6f}")
    print()
    print(run_table(out["tracer"], out["recs"][0].span_id))
    print()
    print(request_table(out["tracer"], 3, model="mnist"))
    summary["device"] = str(dev)
    print(json.dumps(summary, indent=1, default=str))
    return summary


if __name__ == "__main__":
    main()
