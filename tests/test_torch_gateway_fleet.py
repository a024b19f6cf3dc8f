"""Twin of tests/test_gateway.py on the port: multi-model routing, SLO
classes with preemption, scale-to-zero autoscaling with cold starts, shared
per-cloud capacity, simulated cloud failover, and multi-cloud placement +
re-planning, each held to the reference test's own asserts.  Predictors
run on the CPU (``device="cpu"``); the ``BatcherBackend`` case measures
the port's h2o_danube smoke batcher on the host."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.clouds.profiles import get_profile
from repro_torch.serving.gateway import (AutoscalerConfig, BatcherBackend,
                                   CloudCapacity, FailureSpec, Gateway,
                                   ModelDemand, Predictor, SLOClass,
                                   TrafficSpec, est_p99_s, plan_placement,
                                   replan, replicas_needed)
from repro_torch.telemetry.events import EventLog

from conftest import AnalyticBackend


def make_predictor(name="m", cost_s=0.0):
    import time

    def predict(x):
        if cost_s:
            time.sleep(cost_s)
        return x.sum(axis=tuple(range(1, x.ndim)))

    return Predictor(name, predict, np.zeros((1, 4), np.float32), device="cpu")



def warm_config(**kw):
    """Legacy-style pool: starts warm, never idles out."""
    return AutoscalerConfig(min_replicas=kw.pop("min_replicas", 1),
                            idle_window_s=kw.pop("idle_window_s", math.inf),
                            **kw)


def test_multi_model_all_served_exactly_once():
    gw = Gateway()
    for name in ("a", "b", "c"):
        gw.deploy(name, make_predictor(name), get_profile("gcp"),
                  autoscaler=warm_config(), max_batch=8)
    out = gw.run([TrafficSpec("a", 100),
                  TrafficSpec("b", 50, arrival="poisson", rate=200.0),
                  TrafficSpec("c", 25)], seed=0)
    assert set(out.per_model) == {"a", "b", "c"}
    for name, n in (("a", 100), ("b", 50), ("c", 25)):
        res = out.per_model[name]
        assert res.n_requests == n
        assert len(res.latencies_s) == n
        assert all(l > 0 for l in res.latencies_s)
        assert sum(res.per_version.values()) == n
    assert out.makespan_s >= max(r.total_time_s for r in out.per_model.values()) - 1e-12


def test_multiple_specs_for_one_model_concatenate():
    gw = Gateway()
    gw.deploy("a", make_predictor("a"), get_profile("gcp"),
              autoscaler=warm_config())
    out = gw.run([TrafficSpec("a", 10), TrafficSpec("a", 10, start_s=1.0)])
    assert out.per_model["a"].n_requests == 20


def test_scale_to_zero_cold_start_cycle():
    """min_replicas=0: burst -> cold start, idle out to zero, second burst
    pays a second cold start (Cox et al. serverless-inferencing behavior)."""
    log = EventLog()
    prof = get_profile("gcp")
    gw = Gateway(log=log)
    gw.deploy("m", make_predictor("m"), prof,
              autoscaler=AutoscalerConfig(min_replicas=0, max_replicas=2,
                                          scale_up_delay_s=0.5,
                                          idle_window_s=0.5))
    out = gw.run([TrafficSpec("m", 8), TrafficSpec("m", 8, start_s=10.0)])
    assert out.cold_starts["m"] == 2
    trace = out.per_model["m"].replica_trace
    assert trace[0] == (0.0, 0)
    pools = [p for _, p in trace]
    assert 0 in pools[1:]                # scaled back to zero mid-run
    names = [e["name"] for e in log.events]
    assert names.count("gateway:cold_start") == 2
    assert "gateway:scale_to_zero" in names
    # first request of each burst pays control-plane delay + model load
    lat = out.per_model["m"].latencies_s
    assert max(lat[:8]) >= 0.5 + prof.model_load_s
    assert max(lat[8:]) >= 0.5 + prof.model_load_s


def test_cold_start_penalty_matches_profile_constants():
    prof = get_profile("gcp")
    warm = Gateway()
    warm.deploy("m", make_predictor("m"), prof, autoscaler=warm_config())
    lat_warm = warm.run([TrafficSpec("m", 1)]).per_model["m"].latencies_s[0]
    cold = Gateway()
    cold.deploy("m", make_predictor("m"), prof,
                autoscaler=AutoscalerConfig(min_replicas=0,
                                            scale_up_delay_s=0.5,
                                            idle_window_s=1.0))
    lat_cold = cold.run([TrafficSpec("m", 1)]).per_model["m"].latencies_s[0]
    penalty = lat_cold - lat_warm
    assert abs(penalty - (0.5 + prof.model_load_s)) < 0.02


def test_idle_replicas_retire_back_to_min():
    gw = Gateway()
    gw.deploy("m", make_predictor("m", cost_s=0.002), get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=4,
                                          target_queue=4, idle_window_s=0.5),
              max_batch=4)
    out = gw.run([TrafficSpec("m", 128)])
    trace = out.per_model["m"].replica_trace
    assert max(p for _, p in trace) > 1          # scaled up under the burst
    assert trace[-1][1] == 1                     # decayed back to min


def test_shared_cloud_capacity_is_enforced():
    log = EventLog()
    gw = Gateway(capacity={"gcp": 3}, log=log)
    for name in ("a", "b"):
        gw.deploy(name, make_predictor(name, cost_s=0.002), get_profile("gcp"),
                  autoscaler=warm_config(max_replicas=4, target_queue=2),
                  max_batch=2)
    out = gw.run([TrafficSpec("a", 64), TrafficSpec("b", 64)])
    # replay the two traces together: total pool never exceeds the cap
    merged = sorted((t, name, p) for name in ("a", "b")
                    for t, p in out.per_model[name].replica_trace)
    cur, peak = {"a": 0, "b": 0}, 0
    for _, name, p in merged:
        cur[name] = p
        peak = max(peak, cur["a"] + cur["b"])
    assert peak <= 3
    assert any(e["name"] == "gateway:scale_denied" for e in log.events)
    assert all(out.per_model[m].n_requests == 64 for m in ("a", "b"))


def test_scale_from_zero_not_starved_by_warm_pools():
    """A cloud pinned full by never-idling pools must not deadlock a
    scale-to-zero deployment: its first replica launches over budget and
    the breach is logged (gateway:capacity_exceeded)."""
    log = EventLog()
    gw = Gateway(capacity={"gcp": 1}, log=log)
    gw.deploy("warm", make_predictor("warm"), get_profile("gcp"),
              autoscaler=warm_config(min_replicas=1))
    gw.deploy("cold", make_predictor("cold"), get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=0, idle_window_s=1.0))
    out = gw.run([TrafficSpec("warm", 4), TrafficSpec("cold", 4)])
    assert out.per_model["cold"].n_requests == 4
    assert all(l > 0 for l in out.per_model["cold"].latencies_s)
    assert any(e["name"] == "gateway:capacity_exceeded" for e in log.events)


def test_min_replicas_over_capacity_rejected_up_front():
    gw = Gateway(capacity={"gcp": 1})
    for name in ("a", "b"):
        gw.deploy(name, make_predictor(name), get_profile("gcp"),
                  autoscaler=warm_config(min_replicas=1))
    with pytest.raises(ValueError, match="capacity"):
        gw.run([TrafficSpec("a", 2), TrafficSpec("b", 2)])


def test_untrafficked_deployment_still_holds_capacity():
    """A deployed model that gets no traffic this run keeps its warm pool,
    which counts against the shared cloud cap (and the baseline check)."""
    log = EventLog()
    gw = Gateway(capacity={"gcp": 2}, log=log)
    gw.deploy("quiet", make_predictor("quiet"), get_profile("gcp"),
              autoscaler=warm_config(min_replicas=1))
    gw.deploy("busy", make_predictor("busy", cost_s=0.002), get_profile("gcp"),
              autoscaler=warm_config(max_replicas=4, target_queue=2),
              max_batch=2)
    out = gw.run([TrafficSpec("busy", 64)])
    assert "quiet" not in out.per_model          # no traffic -> no results
    assert max(p for _, p in out.per_model["busy"].replica_trace) == 1
    assert any(e["name"] == "gateway:scale_denied" for e in log.events)

    strict = Gateway(capacity={"gcp": 1})
    strict.deploy("quiet", make_predictor("quiet"), get_profile("gcp"),
                  autoscaler=warm_config(min_replicas=1))
    strict.deploy("busy", make_predictor("busy"), get_profile("gcp"),
                  autoscaler=warm_config(min_replicas=1))
    with pytest.raises(ValueError, match="capacity"):
        strict.run([TrafficSpec("busy", 2)])


def test_canary_split_through_gateway():
    gw = Gateway()
    gw.deploy("m", make_predictor("stable"), get_profile("gcp"),
              autoscaler=warm_config(), canary=make_predictor("canary"),
              canary_fraction=0.3)
    res = gw.run([TrafficSpec("m", 500)], seed=11).per_model["m"]
    assert sum(res.per_version.values()) == 500
    assert 0.2 < res.per_version.get("canary", 0) / 500 < 0.4


def test_unknown_model_raises():
    gw = Gateway()
    with pytest.raises(KeyError):
        gw.run([TrafficSpec("ghost", 4)])


# -- SLO classes / preemption ------------------------------------------------

def _one_replica_fleet(slo_batch, slo_lat):
    """32 batch-class requests burst at t=0 against one replica, one
    latency-class request arriving just behind them."""
    gw = Gateway(log=EventLog(), record_batches=True)
    gw.deploy("m", AnalyticBackend("m"), get_profile("gcp"),
              autoscaler=warm_config(max_replicas=1), max_batch=4)
    return gw, [TrafficSpec("m", 32, slo=slo_batch),
                TrafficSpec("m", 1, start_s=0.01, slo=slo_lat)]


def test_latency_class_beats_no_priority_baseline():
    gw, tr = _one_replica_fleet("batch", "latency")
    pri = gw.run(tr, seed=0).per_model["m"]
    # no-priority baseline: same class NAMES but uniform weight and no
    # preemption, so dispatch degenerates to FIFO-by-age while per-class
    # reporting stays comparable
    gw2, tr2 = _one_replica_fleet(SLOClass("batch", 1.0, math.inf),
                                  SLOClass("latency", 1.0, 4.0))
    base = gw2.run(tr2, seed=0).per_model["m"]
    assert pri.n_requests == base.n_requests == 33
    p_pri = pri.per_class()["latency"]["p99_s"]
    p_base = base.per_class()["latency"]["p99_s"]
    assert p_pri < p_base       # the whole point of priority dispatch
    # and priority must not lose any batch work
    assert len(pri.class_latencies["batch"]) == 32


def test_preemption_requeues_and_completes_exactly_once():
    log = EventLog()
    gw = Gateway(log=log, record_batches=True)
    gw.deploy("m", AnalyticBackend("m", base_s=0.1), get_profile("gcp"),
              autoscaler=warm_config(max_replicas=1), max_batch=8)
    out = gw.run([TrafficSpec("m", 8, slo="batch"),
                  TrafficSpec("m", 2, slo="latency", start_s=0.02)])
    assert log.count("gateway:preempt") >= 1
    res = out.per_model["m"]
    assert res.n_requests == 10
    assert sum(res.per_version.values()) == 10
    served = sorted(i for rec in gw.batch_log if not rec["preempted"]
                    for i in rec["idx"])
    assert served == list(range(10))         # exactly once, preempt included
    pc = res.per_class()
    # the preempted batch work finishes AFTER the latency work that evicted it
    assert pc["latency"]["p99_s"] < pc["batch"]["p50_s"]


def test_standard_class_never_preempts():
    log = EventLog()
    gw = Gateway(log=log)
    gw.deploy("m", AnalyticBackend("m", base_s=0.1), get_profile("gcp"),
              autoscaler=warm_config(max_replicas=1), max_batch=8)
    gw.run([TrafficSpec("m", 8, slo="batch"),
            TrafficSpec("m", 2, slo="standard", start_s=0.02)])
    assert log.count("gateway:preempt") == 0


def test_deadline_miss_rate_zero_when_deadlines_infinite():
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m"), get_profile("gcp"),
              autoscaler=warm_config(), max_batch=4)
    res = gw.run([TrafficSpec("m", 64,
                              slo=SLOClass("standard", 1.0, math.inf))])
    assert res.per_model["m"].per_class()["standard"]["miss_rate"] == 0.0
    assert res.per_class()["standard"]["miss_rate"] == 0.0


def test_deadline_miss_rate_one_when_deadline_impossible():
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m"), get_profile("gcp"),
              autoscaler=warm_config(), max_batch=4)
    res = gw.run([TrafficSpec("m", 64, slo=SLOClass("standard", 1.0, 0.0))])
    assert res.per_model["m"].per_class()["standard"]["miss_rate"] == 1.0


def test_unknown_slo_class_raises():
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m"), get_profile("gcp"),
              autoscaler=warm_config())
    with pytest.raises(ValueError, match="SLO"):
        gw.run([TrafficSpec("m", 4, slo="gold")])


def test_conflicting_slo_definitions_rejected():
    """Queues are keyed by class NAME: two different definitions under one
    name on the same model would silently share dispatch weight."""
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m"), get_profile("gcp"),
              autoscaler=warm_config())
    with pytest.raises(ValueError, match="conflicting"):
        gw.run([TrafficSpec("m", 4, slo=SLOClass("batch", 4.0, 5.0)),
                TrafficSpec("m", 4, slo="batch")])
    # the same definition twice is fine
    gw2 = Gateway()
    gw2.deploy("m", AnalyticBackend("m"), get_profile("gcp"),
               autoscaler=warm_config())
    out = gw2.run([TrafficSpec("m", 4, slo="batch"),
                   TrafficSpec("m", 4, slo="batch", start_s=0.1)])
    assert out.per_model["m"].n_requests == 8


# -- cloud failover ----------------------------------------------------------

def test_failover_to_standby_and_recover():
    log = EventLog()
    gw = Gateway(log=log, record_batches=True)
    gw.deploy("m", AnalyticBackend("m", base_s=0.01), get_profile("gcp"),
              standby=get_profile("ibm"),
              autoscaler=warm_config(max_replicas=2, scale_up_delay_s=0.02),
              max_batch=4)
    out = gw.run([TrafficSpec("m", 200, arrival="poisson", rate=400.0)],
                 seed=0,
                 failures=[FailureSpec("gcp", at_s=0.1, duration_s=0.2)])
    assert out.per_model["m"].n_requests == 200
    fo = log.named("gateway:failover")
    rec = log.named("gateway:recover")
    assert fo and fo[0]["src"] == "gcp" and fo[0]["dst"] == "ibm"
    assert rec and rec[-1]["src"] == "ibm" and rec[-1]["dst"] == "gcp"
    # migrated replicas arrive cold on BOTH transitions: control-plane delay
    # plus model_load_s, visible as cold starts on each side
    assert out.cold_starts["m"] >= 2
    clouds_used = {r["cloud"] for r in gw.batch_log}
    assert clouds_used == {"gcp", "ibm"}
    # nothing is served on gcp inside the outage window
    for r in gw.batch_log:
        if r["cloud"] == "gcp":
            assert not (0.1 <= r["start_s"] < 0.3)


def test_failover_without_standby_queues_until_recovery():
    log = EventLog()
    gw = Gateway(log=log, record_batches=True)
    gw.deploy("m", AnalyticBackend("m", base_s=0.01), get_profile("gcp"),
              autoscaler=warm_config(max_replicas=2), max_batch=4)
    out = gw.run([TrafficSpec("m", 100, arrival="poisson", rate=300.0)],
                 seed=1,
                 failures=[FailureSpec("gcp", at_s=0.05, duration_s=0.25)])
    assert out.per_model["m"].n_requests == 100     # nothing lost
    fo = log.named("gateway:failover")
    assert fo and fo[0]["dst"] is None              # nowhere to go: drain
    for r in gw.batch_log:                          # dead cloud serves nothing
        assert not (0.05 <= r["start_s"] < 0.3)
    # requests that arrived mid-outage waited for the recovery
    assert max(out.per_model["m"].latencies_s) > 0.1


def test_failover_drain_preserves_arrival_order():
    """Regression: when a whole pool drains, several in-flight batches
    reclaim into ONE queue; the merge must restore arrival order, so the
    oldest requests are re-served first on the (capacity-1) standby."""
    gw = Gateway(capacity={"ibm": 1})
    gw.deploy("m", AnalyticBackend("m", base_s=0.1), get_profile("gcp"),
              standby=get_profile("ibm"),
              autoscaler=warm_config(min_replicas=2, max_replicas=2,
                                     scale_up_delay_s=0.02), max_batch=2)
    out = gw.run([TrafficSpec("m", 4, slo="batch")],
                 failures=[FailureSpec("gcp", at_s=0.05, duration_s=10.0)])
    lat = out.per_model["m"].latencies_s
    done = [lat[i] for i in range(4)]            # burst: arr == 0 for all
    assert done == sorted(done)                  # 0,1 complete before 2,3


def test_recovery_relaunch_is_cold_even_with_warm_scale_up():
    """Regression: a pool destroyed by an outage (no standby) must relaunch
    COLD on recovery -- the pods are gone -- even for cold_scale_up=False
    deployments whose ordinary elastic scale-ups arrive warm."""
    log = EventLog()
    gw = Gateway(log=log)
    gw.deploy("m", AnalyticBackend("m", base_s=0.01), get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=1,
                                          scale_up_delay_s=0.02,
                                          idle_window_s=math.inf,
                                          cold_scale_up=False),
              max_batch=4)
    out = gw.run([TrafficSpec("m", 8), TrafficSpec("m", 8, start_s=0.5)],
                 failures=[FailureSpec("gcp", at_s=0.2, duration_s=0.2)])
    assert out.per_model["m"].n_requests == 16
    assert out.cold_starts["m"] >= 1
    rec = log.named("gateway:recover")
    assert rec and rec[0]["dst"] == "gcp"


def test_failure_spec_validation():
    with pytest.raises(ValueError):
        FailureSpec("gcp", at_s=-1.0, duration_s=1.0)
    with pytest.raises(ValueError):
        FailureSpec("gcp", at_s=0.0, duration_s=0.0)
    gw = Gateway()
    with pytest.raises(ValueError, match="standby"):
        gw.deploy("m", AnalyticBackend("m"), get_profile("gcp"),
                  standby=get_profile("gcp"))


# -- placement ---------------------------------------------------------------

def _clouds(gcp_cost=1.0, ibm_cost=2.0, cap=8):
    return [CloudCapacity(get_profile("gcp"), cap, gcp_cost),
            CloudCapacity(get_profile("ibm"), cap, ibm_cost)]


def test_replicas_needed_sizing():
    assert replicas_needed(ModelDemand("m", rate=10.0, service_time_s=0.1)) == 2
    assert replicas_needed(ModelDemand("m", rate=0.01, service_time_s=0.01)) == 1


def test_placement_objective_cost_vs_p99():
    models = [ModelDemand("m", rate=20.0, service_time_s=0.05)]
    cheap = plan_placement(models, _clouds(), objective="cost")
    fast = plan_placement(models, _clouds(), objective="p99")
    assert cheap.assignments[0].cloud == "gcp"       # cheaper replicas
    assert fast.assignments[0].cloud == "ibm"        # same-VPC lower RTT
    assert cheap.total_cost_hr < fast.total_cost_hr
    assert fast.worst_p99_s < cheap.worst_p99_s


def test_placement_respects_capacity_and_flags_infeasible():
    # both models need 3 replicas; capacities 3 + 1 can only hold one
    models = [ModelDemand("big", rate=40.0, service_time_s=0.05),
              ModelDemand("big2", rate=38.0, service_time_s=0.05)]
    clouds = [CloudCapacity(get_profile("gcp"), 3, 1.0),
              CloudCapacity(get_profile("ibm"), 1, 2.0)]
    plan = plan_placement(models, clouds, objective="cost")
    assert not plan.feasible
    placed = [a for a in plan.assignments if a.cloud]
    unplaced = [a for a in plan.assignments if a.cloud is None]
    assert len(placed) == 1 and len(unplaced) == 1
    assert placed[0].model == "big"                  # heaviest placed first


def test_placement_capacity_map_feeds_gateway():
    models = [ModelDemand("a", rate=20.0, service_time_s=0.05),
              ModelDemand("b", rate=10.0, service_time_s=0.05)]
    plan = plan_placement(models, _clouds(), objective="cost")
    assert plan.feasible
    cap = plan.capacity_map()
    assert sum(cap.values()) == sum(a.replicas for a in plan.assignments)
    gw = Gateway(capacity=cap)      # planner budget enforced by the router
    assert gw.capacity == cap


def test_placement_overload_estimate_is_inf():
    d = ModelDemand("m", rate=100.0, service_time_s=0.1)   # 10 Erlangs
    assert est_p99_s(get_profile("gcp"), d, 5) == math.inf


def test_saturated_estimates_never_finite():
    """Regression: utilization >= 1 or an empty replica
    set has no finite tail, and an infeasible plan must not report the
    finite worst_p99_s of whatever happened to fit."""
    d = ModelDemand("m", rate=100.0, service_time_s=0.1)
    assert est_p99_s(get_profile("gcp"), d, 0) == math.inf    # no replicas
    assert est_p99_s(get_profile("gcp"), d, 10) == math.inf   # rho == 1.0
    assert est_p99_s(get_profile("gcp"), d, 11) < math.inf    # rho < 1
    models = [ModelDemand("big", rate=40.0, service_time_s=0.05),
              ModelDemand("big2", rate=38.0, service_time_s=0.05)]
    clouds = [CloudCapacity(get_profile("gcp"), 3, 1.0),
              CloudCapacity(get_profile("ibm"), 1, 2.0)]
    plan = plan_placement(models, clouds, objective="cost")
    assert not plan.feasible
    assert plan.worst_p99_s == math.inf          # was: finite max over placed
    s = plan.summary()
    assert s["worst_p99_s"] == "inf"
    unplaced = [a for a in plan.assignments if a.cloud is None]
    assert unplaced and all(a.saturated for a in unplaced)
    placed = [a for a in plan.assignments if a.cloud]
    assert all(not a.saturated for a in placed)


# -- observed-load re-planning ----------------------------------------------

def test_replan_moves_toward_observed_load():
    """Round trip: plan from a (deliberately wrong) demand estimate, run
    the real traffic, re-plan from the measured result.  Revised replica
    counts must move toward the observed load and the new capacity map
    must stay within the clouds' budgets."""
    est = ModelDemand("m", rate=5.0, service_time_s=0.01)   # 10x underrated
    clouds = _clouds(cap=8)
    plan = plan_placement([est], clouds, objective="cost")
    n0 = plan.assignments[0].replicas
    assert n0 == 1

    gw = Gateway(capacity=plan.capacity_map())
    gw.deploy("m", AnalyticBackend("m", base_s=0.01),
              get_profile(plan.assignments[0].cloud),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=n0,
                                          idle_window_s=math.inf),
              max_batch=1)
    out = gw.run([TrafficSpec("m", 400, arrival="poisson", rate=150.0)],
                 seed=0)
    obs = out.per_model["m"].observed
    assert obs["n"] == 400 and obs["service_time_s"] > 0

    plan2 = replan(plan, out)           # clouds + objective carried over
    assert plan2.objective == plan.objective
    n1 = plan2.assignments[0].replicas
    assert n1 > n0                      # moved toward the observed load
    assert n1 == replicas_needed(
        ModelDemand("m", obs["rate_rps"], obs["service_time_s"]))
    assert plan2.feasible
    cap_map = plan2.capacity_map()
    avail = {c.profile.name: c.max_replicas for c in clouds}
    assert all(cap_map[c] <= avail[c] for c in cap_map)


def test_replan_keeps_untrafficked_models_reserved():
    """A model that saw no traffic this window keeps its prior assignment
    and its replicas stay reserved in the revised capacity map."""
    demands = [ModelDemand("busy", rate=5.0, service_time_s=0.01),
               ModelDemand("quiet", rate=10.0, service_time_s=0.05)]
    plan = plan_placement(demands, _clouds(cap=8), objective="cost")
    assert plan.feasible
    quiet0 = next(a for a in plan.assignments if a.model == "quiet")

    gw = Gateway(capacity=plan.capacity_map())
    for name in ("busy", "quiet"):
        gw.deploy(name, AnalyticBackend(name, base_s=0.01), get_profile("gcp"),
                  autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=1,
                                              idle_window_s=math.inf))
    out = gw.run([TrafficSpec("busy", 50, arrival="poisson", rate=40.0)],
                 seed=0)
    assert "quiet" not in out.per_model          # untrafficked this window

    plan2 = replan(plan, out)
    by_model = {a.model: a for a in plan2.assignments}
    assert by_model["quiet"].cloud == quiet0.cloud
    assert by_model["quiet"].replicas == quiet0.replicas
    assert plan2.feasible
    assert plan2.capacity_map()[quiet0.cloud] >= quiet0.replicas


def test_replan_requires_clouds_and_observed_stats():
    plan = plan_placement([ModelDemand("m", 5.0, 0.01)], _clouds())
    bare = plan_placement([ModelDemand("m", 5.0, 0.01)], _clouds())
    bare.clouds = []
    from repro_torch.serving.gateway import GatewayResult, ServeResult
    fake = GatewayResult(
        {"m": ServeResult("gateway:m", 1, 1.0, [1.0])}, {"m": 0}, 1.0)
    with pytest.raises(ValueError, match="clouds"):
        replan(bare, fake)
    with pytest.raises(ValueError, match="observed"):
        replan(plan, fake)              # result lacks observed stats


# -- LLM backend behind the router ------------------------------------------

def test_batcher_backend_service_time_and_generation():
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serving.continuous import ContinuousBatcher

    cfg = registry.get_smoke_config("h2o_danube_3_4b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    cb = ContinuousBatcher(cfg, params, max_slots=2, max_len=64)
    be = BatcherBackend("llm", cb, prompt_len=4, gen_tokens=3)
    t1 = be.service_time(2)          # one slot wave
    t2 = be.service_time(3)          # two waves
    assert t1 > 0
    assert abs(t2 / t1 - 2.0) < 1e-6
    outs = be.generate([[5, 17, 99], [7, 7]], max_new=3)
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)

    gw = Gateway()
    gw.deploy("llm", be, get_profile("ibm"), autoscaler=warm_config(),
              max_batch=4)
    res = gw.run([TrafficSpec("llm", 12)]).per_model["llm"]
    assert res.n_requests == 12 and res.p99 > 0
