"""Twin of tests/test_split_migration.py on the port: weighted traffic
splits, the split-aware placement planner, MigrationPlan diffs applied live
mid-run, cost-aware autoscaling against the CloudProfile price sheet, and
simulated dollar accounting in results."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.clouds.profiles import get_profile
from repro_torch.serving.gateway import (Autoscaler, AutoscalerConfig,
                                   CloudCapacity, FailureSpec, Gateway,
                                   MigrationSpec, MigrationStep, ModelDemand,
                                   PoolView, ReplanConfig, RoutingConfig,
                                   TrafficSpec, diff_plans, plan_placement,
                                   replan, replicas_needed)
from repro_torch.telemetry.events import EventLog

from conftest import AnalyticBackend


def warm_config(**kw):
    return AutoscalerConfig(min_replicas=kw.pop("min_replicas", 1),
                            idle_window_s=kw.pop("idle_window_s", math.inf),
                            **kw)


def split_gcp_ibm(f_ibm):
    return {get_profile("gcp"): 1.0 - f_ibm, get_profile("ibm"): f_ibm}


# -- split routing ------------------------------------------------------------

def test_split_routes_by_weight_and_charges_per_cloud():
    # policy="weights" pins the pure weighted-draw contract this test is
    # about; the queue-aware blend's share behavior is covered by
    # tests/test_admission.py
    gw = Gateway(record_batches=True, routing=RoutingConfig("weights"))
    gw.deploy("m", AnalyticBackend("m"), split=split_gcp_ibm(0.3),
              autoscaler=warm_config(min_replicas=2), max_batch=4)
    out = gw.run([TrafficSpec("m", 400, arrival="poisson", rate=300.0)],
                 seed=3)
    res = out.per_model["m"]
    assert res.n_requests == 400
    assert all(l > 0 for l in res.latencies_s)
    by_cloud: dict = {}
    for rec in gw.batch_log:
        assert not rec["preempted"]
        by_cloud[rec["cloud"]] = by_cloud.get(rec["cloud"], 0) \
            + len(rec["idx"])
    assert sum(by_cloud.values()) == 400
    assert 0.2 < by_cloud["ibm"] / 400 < 0.4     # ~the declared 30% share
    assert abs(sum(gw.final_weights["m"].values()) - 1.0) < 1e-9


def test_split_weights_must_sum_to_one():
    gw = Gateway()
    with pytest.raises(ValueError, match="sum to 1"):
        gw.deploy("m", AnalyticBackend("m"),
                  split={get_profile("gcp"): 0.5, get_profile("ibm"): 0.2})
    with pytest.raises(ValueError, match="profile or a split"):
        gw.deploy("m", AnalyticBackend("m"))
    with pytest.raises(ValueError, match="standby"):
        gw.deploy("m", AnalyticBackend("m"), split=split_gcp_ibm(0.5),
                  standby=get_profile("ibm"))


def test_split_min_replicas_apportioned_across_pools():
    """min_replicas=2 over a 50/50 split: one warm floor replica per cloud,
    and the shared capacity baseline counts both."""
    gw = Gateway(capacity={"gcp": 1, "ibm": 1}, record_batches=True)
    gw.deploy("m", AnalyticBackend("m"), split=split_gcp_ibm(0.5),
              autoscaler=warm_config(min_replicas=2, max_replicas=2),
              max_batch=4)
    out = gw.run([TrafficSpec("m", 16)], seed=0)
    assert out.per_model["m"].n_requests == 16
    assert {rec["cloud"] for rec in gw.batch_log} == {"gcp", "ibm"}

    over = Gateway(capacity={"gcp": 1, "ibm": 0})
    over.deploy("m", AnalyticBackend("m"), split=split_gcp_ibm(0.5),
                autoscaler=warm_config(min_replicas=2))
    with pytest.raises(ValueError, match="capacity"):
        over.run([TrafficSpec("m", 2)])


def test_failover_is_degenerate_split():
    """An outage on one side of an active-active split zeroes that cloud's
    weight (no standby machinery): survivors absorb everything, recovery
    restores the declared split, nothing is lost or doubled."""
    log = EventLog()
    gw = Gateway(log=log, record_batches=True)
    gw.deploy("m", AnalyticBackend("m", base_s=0.01),
              split=split_gcp_ibm(0.5),
              autoscaler=warm_config(min_replicas=2, max_replicas=2,
                                     scale_up_delay_s=0.02), max_batch=4)
    out = gw.run([TrafficSpec("m", 300, arrival="poisson", rate=600.0)],
                 seed=0, failures=[FailureSpec("gcp", at_s=0.1,
                                               duration_s=0.2)])
    assert out.per_model["m"].n_requests == 300
    splits = log.named("gateway:split")
    assert splits, "outage edges must emit gateway:split"
    during = [e for e in splits if e["reason"] == "fail"]
    assert during and during[0]["weights"]["gcp"] == 0.0
    assert during[0]["weights"]["ibm"] == 1.0
    # src is the cloud that LOST share (the dead one), dst the absorber --
    # a renormalizing survivor is a real destination, not drain-in-place
    fo = log.named("gateway:failover")
    assert fo and fo[0]["src"] == "gcp" and fo[0]["dst"] == "ibm"
    # recovery restores the nominal 50/50
    assert gw.final_weights["m"] == {"gcp": 0.5, "ibm": 0.5}
    for rec in gw.batch_log:             # dead cloud serves nothing inside
        if rec["cloud"] == "gcp":        # the window
            assert not (0.1 <= rec["start_s"] < 0.3)


# -- live migration -----------------------------------------------------------

def test_explicit_migration_shifts_mid_run():
    log = EventLog()
    gw = Gateway(log=log, record_batches=True)
    gw.deploy("m", AnalyticBackend("m", base_s=0.01), get_profile("gcp"),
              autoscaler=warm_config(max_replicas=2, scale_up_delay_s=0.02),
              max_batch=4)
    out = gw.run([TrafficSpec("m", 200, arrival="poisson", rate=400.0)],
                 seed=0,
                 migrations=[MigrationSpec(0.2, {"m": {"ibm": 1.0}})])
    assert out.per_model["m"].n_requests == 200
    assert log.count("gateway:migrate") == 1
    assert log.named("gateway:migrate")[0]["reason"] == "plan"
    clouds = {rec["cloud"] for rec in gw.batch_log}
    assert clouds == {"gcp", "ibm"}
    # drain-and-shift: no gcp batch STARTS after the migration fired, but
    # nothing is reclaimed either (in-flight work completes where it ran)
    assert all(rec["start_s"] < 0.2 for rec in gw.batch_log
               if rec["cloud"] == "gcp")
    assert not any(rec["preempted"] for rec in gw.batch_log)
    assert gw.final_weights["m"] == {"gcp": 0.0, "ibm": 1.0}


def test_replan_config_validated():
    with pytest.raises(ValueError, match="check_every_s"):
        ReplanConfig(check_every_s=0.0)
    with pytest.raises(ValueError, match="shift"):
        ReplanConfig(shift=0.0)
    with pytest.raises(ValueError, match="sustain"):
        ReplanConfig(sustain=0)
    with pytest.raises(ValueError, match="min_window_n"):
        ReplanConfig(min_window_n=0)   # would divide by zero in the probe


def test_migration_weights_validated():
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m"), get_profile("gcp"),
              autoscaler=warm_config())
    with pytest.raises(ValueError, match="sum to 1"):
        gw.run([TrafficSpec("m", 4)],
               migrations=[MigrationSpec(0.1, {"m": {"gcp": 0.4}})])
    with pytest.raises(KeyError):
        gw.run([TrafficSpec("m", 4)],
               migrations=[MigrationSpec(0.1, {"ghost": {"gcp": 1.0}})])
    with pytest.raises(ValueError):
        MigrationSpec(-1.0, {})
    with pytest.raises(ValueError, match="sum to 1"):
        MigrationStep("m", {"gcp": 0.5}, {}, {"gcp": get_profile("gcp")})


def test_plan_diff_round_trips_through_the_router():
    """plan -> diff -> run(migrations=[...]): the router lands on the new
    plan's split, opening pools for clouds it had never served from."""
    clouds = [CloudCapacity(get_profile("gcp"), 2, 1.0),
              CloudCapacity(get_profile("ibm"), 8, 1.4)]
    d_lo = [ModelDemand("m", rate=10.0, service_time_s=0.1)]    # 2 replicas
    d_hi = [ModelDemand("m", rate=25.0, service_time_s=0.1)]    # 4 replicas
    plan_lo = plan_placement(d_lo, clouds, objective="cost", split=True)
    plan_hi = plan_placement(d_hi, clouds, objective="cost", split=True)
    assert plan_lo.assignments[0].shares == {"gcp": 2}
    assert plan_hi.assignments[0].shares == {"gcp": 2, "ibm": 2}
    mig = diff_plans(plan_lo, plan_hi)
    assert mig.models == ["m"]

    gw = Gateway(record_batches=True)
    gw.deploy("m", AnalyticBackend("m", base_s=0.01), get_profile("gcp"),
              autoscaler=warm_config(min_replicas=2, max_replicas=4,
                                     scale_up_delay_s=0.02), max_batch=4)
    out = gw.run([TrafficSpec("m", 300, arrival="poisson", rate=500.0)],
                 seed=1, migrations=[MigrationSpec(0.15, mig)])
    assert out.per_model["m"].n_requests == 300
    assert gw.final_weights["m"] == plan_hi.assignments[0].weights
    assert {rec["cloud"] for rec in gw.batch_log} == {"gcp", "ibm"}


def test_unchanged_plan_diffs_to_no_steps():
    clouds = [CloudCapacity(get_profile("gcp"), 8, 1.0)]
    models = [ModelDemand("m", rate=10.0, service_time_s=0.1)]
    a = plan_placement(models, clouds, split=True)
    b = plan_placement(models, clouds, split=True)
    assert diff_plans(a, b).steps == []


def test_split_total_never_exceeds_deployment_budget():
    """Regression: per-pool ceil-share caps sum over max_replicas (ceil(3/2)
    twice = 4); the deployment-wide budget must still bound elastic
    scale-up across the split."""
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m", base_s=0.02),
              split=split_gcp_ibm(0.5),
              autoscaler=AutoscalerConfig(min_replicas=2, max_replicas=3,
                                          target_queue=1,
                                          scale_up_delay_s=0.01,
                                          idle_window_s=math.inf),
              max_batch=1)
    out = gw.run([TrafficSpec("m", 400, arrival="poisson", rate=800.0)],
                 seed=2)
    assert out.per_model["m"].n_requests == 400
    assert max(r for _, r in out.per_model["m"].replica_trace) <= 3


def test_scale_from_zero_budget_breach_is_loud():
    """A pool whose queued work cannot be served anywhere else may breach
    the deployment budget (the run must complete) -- but loudly."""
    log = EventLog()
    gw = Gateway(log=log)
    gw.deploy("m", AnalyticBackend("m", base_s=0.3),
              split=split_gcp_ibm(0.5),
              autoscaler=AutoscalerConfig(min_replicas=0, max_replicas=1,
                                          scale_up_delay_s=0.01,
                                          idle_window_s=math.inf),
              max_batch=8)
    out = gw.run([TrafficSpec("m", 32)], seed=0)
    assert out.per_model["m"].n_requests == 32
    assert log.count("gateway:budget_exceeded") >= 1


def test_migration_relaunches_working_set_despite_busy_source():
    """Regression: when every source replica is mid-batch at the shift, the
    destination must still relaunch the working set (transient surge) --
    the deployment budget must not count the soft-draining source pool."""
    log = EventLog()
    gw = Gateway(log=log)
    gw.deploy("m", AnalyticBackend("m", base_s=0.3), get_profile("gcp"),
              autoscaler=warm_config(min_replicas=2, max_replicas=2,
                                     scale_up_delay_s=0.02), max_batch=4)
    out = gw.run([TrafficSpec("m", 8), TrafficSpec("m", 8, start_s=1.0)],
                 seed=0,
                 migrations=[MigrationSpec(0.1, {"m": {"ibm": 1.0}})])
    ups = [e for e in log.named("gateway:scale_up") if e["cloud"] == "ibm"]
    assert len(ups) >= 2, "destination floor never launched"
    assert out.per_model["m"].n_requests == 16
    assert gw.final_weights["m"] == {"gcp": 0.0, "ibm": 1.0}


def test_probe_shift_during_outage_preserves_dead_clouds_nominal():
    """Regression: an auto-replan shift fired DURING an outage must not
    erase the dead cloud's nominal share -- recovery still restores it."""
    log = EventLog()
    gw = Gateway(log=log,
                 replan=ReplanConfig(check_every_s=0.05, sustain=2,
                                     overload_factor=1.0, consolidate=False))
    gw.deploy("m", AnalyticBackend("m", base_s=0.1),
              split=split_gcp_ibm(0.5), standby=get_profile("k8s"),
              autoscaler=warm_config(min_replicas=2, max_replicas=2,
                                     target_queue=1, scale_up_delay_s=0.01),
              max_batch=1)
    out = gw.run([TrafficSpec("m", 40, start_s=0.02)], seed=0,
                 failures=[FailureSpec("gcp", at_s=0.01, duration_s=1.0)])
    assert out.per_model["m"].n_requests == 40
    migs = [e for e in log.named("gateway:migrate")
            if e["reason"] in ("overload", "miss_rate")]
    assert migs and migs[0]["src"] == "ibm" and migs[0]["dst"] == "k8s"
    assert log.count("gateway:recover") >= 1
    final = gw.final_weights["m"]
    assert final["gcp"] == pytest.approx(0.5)    # the outage gave it back
    assert abs(sum(final.values()) - 1.0) < 1e-9


# -- continuous re-planning ---------------------------------------------------

def test_auto_replan_shifts_overload_to_cheapest_headroom():
    """A pool that is overloaded and out of room sheds weight toward the
    cheapest declared cloud with headroom (here: the zero-weight standby
    pool on gcp, which is also the cheaper price-sheet entry)."""
    log = EventLog()
    gw = Gateway(log=log, record_batches=True,
                 replan=ReplanConfig(check_every_s=0.05, sustain=2,
                                     overload_factor=1.0))
    gw.deploy("m", AnalyticBackend("m", base_s=0.2), get_profile("ibm"),
              standby=get_profile("gcp"),
              autoscaler=warm_config(max_replicas=1, target_queue=1),
              max_batch=1)
    out = gw.run([TrafficSpec("m", 40)], seed=0)
    assert out.per_model["m"].n_requests == 40
    migs = log.named("gateway:migrate")
    assert migs and migs[0]["reason"] == "overload"
    assert migs[0]["src"] == "ibm" and migs[0]["dst"] == "gcp"
    assert {rec["cloud"] for rec in gw.batch_log} == {"gcp", "ibm"}


def test_auto_replan_consolidates_idle_fleet_off_expensive_cloud():
    """Cost-aware scale-down: an idle 50/50 split folds the expensive ibm
    pool into gcp (retire-most-expensive-first), and the stranded ibm
    replica idles out to zero."""
    log = EventLog()
    gw = Gateway(log=log,
                 replan=ReplanConfig(check_every_s=0.1, sustain=2))
    gw.deploy("m", AnalyticBackend("m", base_s=0.005),
              split=split_gcp_ibm(0.5),
              autoscaler=AutoscalerConfig(min_replicas=2, max_replicas=2,
                                          idle_window_s=1.5), max_batch=8)
    out = gw.run([TrafficSpec("m", 16)], seed=0)
    assert out.per_model["m"].n_requests == 16
    migs = [e for e in log.named("gateway:migrate") if e["reason"] == "cost"]
    assert migs and migs[0]["src"] == "ibm" and migs[0]["dst"] == "gcp"
    assert gw.final_weights["m"] == {"gcp": 1.0, "ibm": 0.0}
    downs = [e for e in log.named("gateway:scale_down")
             if e["cloud"] == "ibm"]
    assert downs, "the expensive replica must retire after consolidation"


# -- cost-aware policy units --------------------------------------------------

def test_relaunch_pool_respects_destination_headroom():
    """Migration relaunches size against the DESTINATION
    pool's capacity, not just the global max_replicas."""
    asc = Autoscaler(AutoscalerConfig(min_replicas=0, max_replicas=4))
    assert asc.relaunch_pool(3, 10) == 3                 # legacy: global cap
    assert asc.relaunch_pool(3, 10, headroom=2) == 2     # destination-bound
    assert asc.relaunch_pool(3, 10, headroom=0) == 1     # from-zero, loudly
    assert asc.relaunch_pool(3, 0, headroom=0) == 0      # nothing queued
    assert asc.relaunch_pool(9, 10, headroom=9) == 4     # still <= max


def test_pick_scale_up_and_retire_rank_by_price_sheet():
    pools = [PoolView("ibm", 1.4 / 3600, replicas=2, headroom=2),
             PoolView("gcp", 1.0 / 3600, replicas=1, headroom=1),
             PoolView("k8s", 1.1 / 3600, replicas=0, headroom=0)]
    assert Autoscaler.pick_scale_up(pools).cloud == "gcp"   # cheapest open
    assert Autoscaler.pick_retire(pools).cloud == "ibm"     # costliest held
    assert Autoscaler.pick_scale_up([]) is None
    assert Autoscaler.pick_retire(
        [PoolView("gcp", 1.0, replicas=0, headroom=3)]) is None


# -- split-aware planner ------------------------------------------------------

def _clouds(gcp=(8, 1.0), ibm=(8, 1.4)):
    return [CloudCapacity(get_profile("gcp"), gcp[0], gcp[1]),
            CloudCapacity(get_profile("ibm"), ibm[0], ibm[1])]


def test_split_plan_spills_when_best_cloud_is_full():
    d = ModelDemand("m", rate=50.0, service_time_s=0.1)   # needs 8 replicas
    clouds = _clouds(gcp=(5, 1.0), ibm=(8, 1.4))
    single = plan_placement([d], clouds, objective="cost")
    split = plan_placement([d], clouds, objective="cost", split=True)
    assert single.assignments[0].shares == {"ibm": 8}     # gcp cannot fit it
    a = split.assignments[0]
    assert a.shares == {"gcp": 5, "ibm": 3}               # cheap first, spill
    assert abs(sum(a.weights.values()) - 1.0) < 1e-9
    assert a.weights["gcp"] == 5 / 8
    assert split.total_cost_hr < single.total_cost_hr     # the point
    assert split.capacity_map() == {"gcp": 5, "ibm": 3}
    assert a.cloud == "gcp"                               # primary = max w


def test_split_plan_feasible_where_single_cloud_is_not():
    d = ModelDemand("m", rate=30.0, service_time_s=0.1)   # needs 5
    clouds = _clouds(gcp=(3, 1.0), ibm=(2, 1.4))
    assert not plan_placement([d], clouds).feasible
    split = plan_placement([d], clouds, split=True)
    assert split.feasible
    assert split.assignments[0].shares == {"gcp": 3, "ibm": 2}


def test_split_weights_always_sum_to_one_or_unplaced():
    models = [ModelDemand(f"m{i}", rate=10.0 + 7 * i, service_time_s=0.08)
              for i in range(4)]
    plan = plan_placement(models, _clouds(gcp=(4, 1.0), ibm=(5, 1.4)),
                          split=True)
    for a in plan.assignments:
        if a.shares:
            assert abs(sum(a.weights.values()) - 1.0) < 1e-9
            assert all(w > 0 for w in a.weights.values())
        else:
            assert a.weights == {} and a.saturated


def test_cloud_capacity_price_defaults_to_profile_sheet():
    c = CloudCapacity(get_profile("ibm"), 4)
    assert c.replica_cost_hr == pytest.approx(1.4)
    c2 = CloudCapacity(get_profile("ibm"), 4, 9.0)
    assert c2.replica_cost_hr == 9.0


# -- split replan round-trip -------------------------------------------------

def test_replan_round_trip_under_split_assignments():
    """plan -> run -> replan with splits: untrafficked models keep their
    reserved shares, every placed assignment's weights sum to 1, and the
    revised capacity map stays within the cloud budgets."""
    demands = [ModelDemand("busy", rate=5.0, service_time_s=0.01),
               ModelDemand("quiet", rate=60.0, service_time_s=0.1)]
    clouds = _clouds(gcp=(5, 1.0), ibm=(8, 1.4))
    plan = plan_placement(demands, clouds, objective="cost", split=True)
    assert plan.feasible
    quiet0 = next(a for a in plan.assignments if a.model == "quiet")
    assert len(quiet0.shares) == 2       # the big model genuinely splits

    gw = Gateway(capacity=plan.capacity_map())
    gw.deploy("busy", AnalyticBackend("busy", base_s=0.01),
              get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2,
                                          idle_window_s=math.inf))
    gw.deploy("quiet", AnalyticBackend("quiet", base_s=0.01),
              split={get_profile(c): w for c, w in quiet0.weights.items()},
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2,
                                          idle_window_s=math.inf))
    out = gw.run([TrafficSpec("busy", 300, arrival="poisson", rate=150.0)],
                 seed=0)
    assert "quiet" not in out.per_model  # untrafficked this window

    plan2 = replan(plan, out)
    assert plan2.split                   # split mode carries over
    by_model = {a.model: a for a in plan2.assignments}
    assert by_model["quiet"].shares == quiet0.shares
    assert by_model["quiet"].weights == quiet0.weights
    # observed busy load >> the estimate: replicas moved toward measurement
    obs = out.per_model["busy"].observed
    # n arrivals span n-1 gaps: the measured rate must be
    # interval-based, not the n/window overestimate
    assert obs["rate_rps"] == pytest.approx(
        (obs["n"] - 1) / obs["window_s"])
    assert by_model["busy"].replicas == replicas_needed(
        ModelDemand("busy", obs["rate_rps"], obs["service_time_s"]))
    assert by_model["busy"].replicas > 1
    for a in plan2.assignments:
        if a.shares:
            assert abs(sum(a.weights.values()) - 1.0) < 1e-9
    cap_map = plan2.capacity_map()
    avail = {c.profile.name: c.max_replicas for c in clouds}
    assert all(cap_map[c] <= avail[c] for c in cap_map)


# -- simulated dollars --------------------------------------------------------

def test_cost_accounting_bills_provisioned_replica_seconds():
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m", base_s=0.05), get_profile("gcp"),
              autoscaler=warm_config(min_replicas=2, max_replicas=2),
              max_batch=8)
    out = gw.run([TrafficSpec("m", 64)], seed=0)
    res = out.per_model["m"]
    assert set(res.cost_by_cloud) == {"gcp"}
    # two always-on replicas billed to at least the last completion
    floor = 2 * out.makespan_s * get_profile("gcp").cost_per_s
    assert res.cost_usd >= floor - 1e-12
    assert out.costs["m"] == pytest.approx(res.cost_usd)
    assert out.total_cost_usd == pytest.approx(res.cost_usd)
    assert "sim_cost_usd" in out.summary()
    assert "sim_cost_usd" in res.summary()


def test_trailing_events_do_not_inflate_cost():
    """Regression: surviving replicas bill to the fleet's last completion,
    not to the last event -- an outage window on a cloud this deployment
    never touches must not change the bill."""
    def run_once(failures):
        gw = Gateway()
        gw.deploy("m", AnalyticBackend("m", base_s=0.01), get_profile("gcp"),
                  autoscaler=warm_config(), max_batch=8)
        return gw.run([TrafficSpec("m", 8)], seed=0, failures=failures)
    plain = run_once(None)
    late = run_once([FailureSpec("ibm", at_s=50.0, duration_s=50.0)])
    assert late.total_cost_usd == pytest.approx(plain.total_cost_usd)
    assert late.makespan_s == pytest.approx(plain.makespan_s)


def test_split_to_cheaper_cloud_costs_less():
    """Same fleet, same traffic: serving mostly from the cheaper price-sheet
    entry costs fewer simulated dollars than serving all-expensive."""
    def run_once(split):
        gw = Gateway()
        gw.deploy("m", AnalyticBackend("m", base_s=0.01), split=split,
                  autoscaler=warm_config(min_replicas=2, max_replicas=2),
                  max_batch=8)
        return gw.run([TrafficSpec("m", 200, arrival="poisson", rate=400.0)],
                      seed=5)
    cheap = run_once({get_profile("gcp"): 1.0})
    dear = run_once({get_profile("ibm"): 1.0})
    assert cheap.total_cost_usd < dear.total_cost_usd
