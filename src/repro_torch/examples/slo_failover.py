"""SLO-aware serving through a cloud outage, on the port: three traffic
classes (latency / standard / batch) on one fleet, a mid-run gcp failure
with ibm standby, an observed-load re-plan afterwards -- and the revised
plan applied LIVE to a second window via a MigrationPlan (drain-and-shift,
no requests dropped), then the same outage window replayed WITH per-class
admission control (deadline-hopeless latency/standard work is shed exactly
once, batch work only deferred).  Twin of ``examples/slo_failover.py``.

The predictor is ``tanh(v @ w)`` in torch, ``w`` drawn from an explicit
``torch.Generator``; its service times are measured on ``--device`` (the
card by default, synchronised before the clock is read).

    python -m repro_torch.examples.slo_failover --device cpu
    python -m repro_torch.examples.slo_failover               # on the card
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..clouds.profiles import get_profile
from ..models.modules import require_device
from ..serving.gateway import (AdmissionConfig, AutoscalerConfig,
                               CloudCapacity, FailureSpec, Gateway,
                               MigrationSpec, ModelDemand, Predictor,
                               TrafficSpec, plan_placement, replan)
from ..telemetry.events import EventLog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    w = torch.randn((256, 256), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float32).to(dev)

    @torch.inference_mode()
    def predict(v):
        return torch.tanh(torch.as_tensor(v, device=dev) @ w)

    pred = Predictor("ranker", predict, np.zeros((1, 256), np.float32), device=dev)
    pred.warmup((1, 8))

    # plan from a deliberately rough demand guess; the replan at the end
    # corrects it from measurement
    guess = ModelDemand("ranker", rate=50.0,
                        service_time_s=pred.service_time(8) / 8)
    clouds = [CloudCapacity(get_profile("gcp"), 8, 1.0),
              CloudCapacity(get_profile("ibm"), 8, 1.4)]
    plan = plan_placement([guess], clouds, objective="p99")
    print("initial plan:", json.dumps(plan.summary(), indent=1))

    log = EventLog()
    gw = Gateway(capacity=plan.capacity_map(), log=log)
    gw.deploy("ranker", pred, get_profile("gcp"), standby=get_profile("ibm"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2,
                                          scale_up_delay_s=0.02,
                                          idle_window_s=np.inf),
              max_batch=8)

    # size the workload from the MEASURED batch time so the backlog shape is
    # host-independent: the batch burst keeps both replicas saturated for
    # ~drain seconds, the latency stream lands inside that backlog (forcing
    # preemptions), and the outage hits while the queue is still deep
    t8 = pred.service_time(8)
    per_batch = get_profile("gcp").network_rtt_s + t8
    drain = (640 / 8) * per_batch / 2
    traffic = [
        TrafficSpec("ranker", 640, slo="batch"),              # bulk backlog
        TrafficSpec("ranker", 96, slo="standard",
                    arrival="poisson", rate=96 / drain),
        TrafficSpec("ranker", 64, slo="latency",
                    arrival="poisson", rate=64 / (0.4 * drain)),
    ]
    outage = FailureSpec("gcp", at_s=0.6 * drain, duration_s=0.5 * drain)
    out = gw.run(traffic, seed=0, failures=[outage])

    print("per-class latencies through the outage:")
    print(json.dumps(out.per_class(), indent=1))
    for name in ("gateway:preempt", "gateway:failover", "gateway:recover",
                 "gateway:cold_start"):
        print(f"  {name}: {log.count(name)}")

    revised = replan(plan, out)
    print("replanned from observed load:",
          json.dumps(revised.summary(), indent=1))
    print(f"simulated run cost: ${out.total_cost_usd:.6f} "
          "(price-sheet output, not a measurement)")

    assert log.count("gateway:failover") >= 1
    assert log.count("gateway:recover") >= 1
    assert log.count("gateway:preempt") >= 1
    pc = out.per_class()
    assert pc["latency"]["p99_s"] <= pc["batch"]["p99_s"]

    # apply the revised plan LIVE to a fresh window: the router shifts the
    # split mid-run (in-flight batches finish where they started, the
    # backlog re-routes, relaunches arrive cold on the destination).
    # diff_plans(plan, revised) is the general plan-to-plan form; here the
    # RUNNING placement (gcp primary) is what differs, so we migrate to the
    # revised assignment's weights directly
    target = dict(next(a for a in revised.assignments
                       if a.model == "ranker").weights)
    out2 = gw.run([TrafficSpec("ranker", 160, slo="standard",
                               arrival="poisson", rate=96 / drain)],
                  seed=1,
                  migrations=[MigrationSpec(0.3 * drain, {"ranker": target})])
    print("live migration applied mid-run ->", target)
    print("post-migration split:", gw.final_weights["ranker"],
          f"- sim cost ${out2.total_cost_usd:.6f}")
    assert log.count("gateway:migrate") >= 1
    assert out2.per_model["ranker"].n_requests == 160

    # replay the outage window WITH per-class admission control: requests
    # whose expected completion already breaks their deadline are shed at
    # the door (gateway:shed, exactly once) instead of queueing to certain
    # failure -- batch work is only deferred, and the survivors' per-class
    # tail collapses because the hopeless work no longer clogs the queues
    adm_log = EventLog()
    adm = Gateway(capacity=plan.capacity_map(), log=adm_log,
                  admission=AdmissionConfig())
    adm.deploy("ranker", pred, get_profile("gcp"), standby=get_profile("ibm"),
               autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2,
                                           scale_up_delay_s=0.02,
                                           idle_window_s=np.inf),
               max_batch=8)
    out3 = adm.run(traffic, seed=0, failures=[outage])
    res3 = out3.per_model["ranker"]
    pc3 = out3.per_class()
    print("same outage window with admission control:")
    print(json.dumps(pc3, indent=1))
    print(f"  shed {res3.shed_total}/{res3.n_requests} "
          f"(rate {res3.shed_rate:.4f}), by class {res3.class_shed}")
    assert res3.class_shed.get("batch", 0) == 0   # deferred, never shed
    assert len(res3.class_latencies["batch"]) == 640
    n_shed = adm_log.count("gateway:shed")
    assert n_shed == res3.shed_total              # exactly once, all logged
    assert len(res3.latencies_s) + n_shed == res3.n_requests
    return {"device": str(dev), "service_time_8_s": t8,
            "failovers": log.count("gateway:failover"),
            "recovers": log.count("gateway:recover"),
            "preempts": log.count("gateway:preempt"),
            "migrates": log.count("gateway:migrate"),
            "split_after_migration": gw.final_weights["ranker"],
            "shed_with_admission": res3.shed_total}


if __name__ == "__main__":
    main()
