"""The gateway's second slice on the port, against the reference.

- Cross-package parity, exact: the same scenario -- failover with a
  standby, an explicit ``MigrationSpec``, a ``diff_plans`` round trip, an
  auto-replan shift, staged and unified disaggregation, a cache shed, the
  full telemetry plane, and a ``CapacityMarket`` shared by two deployments
  over a recorded training lease -- is built in both packages from one
  ``AnalyticBackend`` (tests/conftest.py) and run under both engines.  The
  results, the batch log, the stripped event dump, the tracer's JSON, the
  Prometheus text, ``final_weights``, ``final_kv`` and the market ledger's
  audit are equal float for float.  So are ``InferenceService`` runs with
  a tracer and a registry, the placement planner's plans, and the seeded
  random fleets of the invariant suites (tests/test_gateway_invariants.py
  and its twin build them from the same plain-data draw).
- The entry points take the reference's parameters, under the same names,
  kinds and defaults.
- Twins of the ``ReplanConfig`` cases of tests/test_admission.py and of
  tests/test_sim_engine.py's stale burn-alert case.
- Twins of tests/test_modelci.py's ``DriftMonitor`` cases on the port's
  ``telemetry/drift.py``; their ``feed`` keeps its cumulative counters on
  the monitor object itself, so a new monitor always starts from zero.
"""
import dataclasses
import importlib
import inspect
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import test_gateway_invariants as ref_inv  # noqa: E402
import test_torch_gateway_invariants as port_inv  # noqa: E402
from repro_torch.clouds.profiles import CloudProfile, get_profile  # noqa: E402
from repro_torch.serving.gateway import (AdmissionConfig, AutoscalerConfig,  # noqa: E402
                                         Gateway, ReplanConfig, RoutingConfig,
                                         SLOClass, TrafficSpec)
from repro_torch.telemetry.drift import DriftConfig, DriftMonitor  # noqa: E402
from repro_torch.telemetry.events import EVENT_KINDS, EventLog, unregistered  # noqa: E402
from repro_torch.telemetry.metrics import MetricsRegistry  # noqa: E402
from repro_torch.telemetry.slo import BurnRateConfig  # noqa: E402

from conftest import AnalyticBackend  # noqa: E402


def _package(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    gw = mod("serving.gateway")
    return SimpleNamespace(
        P=mod("clouds.profiles").get_profile, G=gw, Log=mod("telemetry.events").EventLog,
        Tracer=mod("telemetry.trace").Tracer, Registry=mod("telemetry.metrics").MetricsRegistry,
        Burn=mod("telemetry.slo").BurnRateConfig, Drift=mod("telemetry.drift").DriftConfig,
        Market=mod("clouds.capacity").CapacityMarket, Service=mod("serving.kserve").InferenceService)


PACKAGES = {"reference": _package("repro"), "port": _package("repro_torch")}


@dataclasses.dataclass(frozen=True)
class Profiled:
    """What a placement was planned from: the gateway's drift monitor reads
    only ``service_time_s``.  One object goes into both packages."""
    service_time_s: float


def _warm(K, **kw):
    return K.G.AutoscalerConfig(min_replicas=kw.pop("min_replicas", 1),
                                idle_window_s=kw.pop("idle_window_s", math.inf), **kw)


# -- scenarios: each builds (gateway, traffic, run kwargs) in one package ------

def _failover(K):
    """gcp dies mid-run; the zero-weight ibm standby absorbs its traffic."""
    gw = K.G.Gateway(log=K.Log(), record_batches=True)
    gw.deploy("m", AnalyticBackend("m", 0.02, 1e-3), K.P("gcp"), standby=K.P("ibm"),
              autoscaler=K.G.AutoscalerConfig(min_replicas=1, max_replicas=3, target_queue=4,
                                              idle_window_s=0.5), max_batch=4)
    traffic = [K.G.TrafficSpec("m", 120, arrival="poisson", rate=200.0),
               K.G.TrafficSpec("m", 40, slo="latency", arrival="poisson", rate=80.0),
               K.G.TrafficSpec("m", 60, slo="batch", start_s=0.1)]
    return gw, traffic, dict(failures=[K.G.FailureSpec("gcp", at_s=0.2, duration_s=0.3)])


def _migration(K):
    """An explicit raw-dict MigrationSpec moves a split mid-run."""
    gw = K.G.Gateway(log=K.Log(), record_batches=True)
    gw.deploy("m", AnalyticBackend("m", 0.01, 1e-3), split={K.P("gcp"): 0.7, K.P("ibm"): 0.3},
              autoscaler=_warm(K, min_replicas=2, max_replicas=4), max_batch=8)
    return gw, [K.G.TrafficSpec("m", 200, arrival="poisson", rate=300.0)], dict(
        migrations=[K.G.MigrationSpec(0.3, {"m": {"gcp": 0.2, "ibm": 0.8}})])


def _clouds(K):
    return [K.G.CloudCapacity(K.P("gcp"), 6, 1.0), K.G.CloudCapacity(K.P("ibm"), 6, 1.4)]


def _diff_plans(K):
    """plan_placement -> diff_plans -> MigrationPlan applied live."""
    old = K.G.plan_placement([K.G.ModelDemand("a", 30.0, 0.02),
                              K.G.ModelDemand("b", 10.0, 0.05)], _clouds(K), split=True)
    new = K.G.plan_placement([K.G.ModelDemand("a", 120.0, 0.02),
                              K.G.ModelDemand("b", 10.0, 0.05)], _clouds(K), split=True,
                             objective="p99")
    mig = K.G.diff_plans(old, new)
    gw = K.G.Gateway(log=K.Log(), record_batches=True, capacity=old.capacity_map())
    for a in old.assignments:
        gw.deploy(a.model, AnalyticBackend(a.model, 0.02, 1e-3),
                  split={K.P(c): w for c, w in a.weights.items()},
                  autoscaler=K.G.AutoscalerConfig(min_replicas=a.replicas, max_replicas=6,
                                                  idle_window_s=0.5), max_batch=4)
    traffic = [K.G.TrafficSpec("a", 150, arrival="poisson", rate=150.0),
               K.G.TrafficSpec("b", 40, arrival="poisson", rate=40.0, slo="latency")]
    return gw, traffic, dict(migrations=[K.G.MigrationSpec(0.25, mig)])


def _auto_replan(K):
    """Overload on ibm shifts weight to the gcp standby (reason=overload),
    and the probe's cost consolidation runs through the idle tail."""
    gw = K.G.Gateway(log=K.Log(), record_batches=True,
                     replan=K.G.ReplanConfig(check_every_s=0.05, sustain=2, overload_factor=1.0))
    gw.deploy("m", AnalyticBackend("m", 0.2), K.P("ibm"), standby=K.P("gcp"),
              autoscaler=_warm(K, max_replicas=1, target_queue=1), max_batch=1)
    return gw, [K.G.TrafficSpec("m", 40)], {}


def _disagg(K, **spec):
    gw = K.G.Gateway(log=K.Log(), record_batches=True, admission=spec.pop("admission", None))
    kind = spec.pop("pool_kind", {"gcp": "prefill", "ibm": "decode"})
    gw.deploy("llm", AnalyticBackend("llm", 0.02, 0.005), split={K.P("gcp"): 0.5, K.P("ibm"): 0.5},
              autoscaler=K.G.AutoscalerConfig(min_replicas=1, max_replicas=2), max_batch=4,
              disagg=K.G.DisaggSpec(block_size=16, prompt_tokens=64, gen_tokens=16,
                                    pool_kind=kind, **spec))
    return gw, [K.G.TrafficSpec("llm", 40, arrival="poisson", rate=100.0),
                K.G.TrafficSpec("llm", 16, arrival="poisson", rate=60.0, slo="latency"),
                K.G.TrafficSpec("llm", 12, slo="batch", start_s=0.05)], {}


def _staged(K):
    return _disagg(K, kv_blocks=256)


def _cache_shed(K):
    """A block budget far below the staged queue's demand: sheddable work
    is dropped before enqueue (gateway:cache_shed), batch work waits."""
    return _disagg(K, kv_blocks=12, shed_margin=1.0)


def _unified(K):
    return _disagg(K, kv_blocks={"gcp": 64, "ibm": 64}, pool_kind={"gcp": "both", "ibm": "both"},
                   admission=K.G.AdmissionConfig())


def _telemetry(K):
    """Tracer, registry, burn-rate alerts and drift against a planned
    profile, on the scrape clock; request spans link to a deploy span."""
    tracer = K.Tracer()
    deploy_span = tracer.start("pipeline.step", 0.0, step="deploy")
    K.Tracer.end(deploy_span, 0.0)
    gw = K.G.Gateway(log=K.Log(), record_batches=True, tracer=tracer, metrics=K.Registry(),
                     slo_burn=K.Burn(threshold=2.0, min_n=4),
                     drift=K.Drift(threshold=1.5, sustain=2, min_n=4), scrape_every_s=0.1,
                     admission=K.G.AdmissionConfig(),
                     replan=K.G.ReplanConfig(check_every_s=0.1, sustain=2))
    gw.deploy("m", AnalyticBackend("m", 0.05, 2e-3), split={K.P("gcp"): 0.6, K.P("ibm"): 0.4},
              autoscaler=K.G.AutoscalerConfig(min_replicas=1, max_replicas=2, target_queue=4,
                                              idle_window_s=0.4), max_batch=4,
              trace_link=deploy_span.span_id, planned_from=Profiled(0.004))
    gw.deploy("n", AnalyticBackend("n", 0.01), K.P("gcp"), standby=K.P("ibm"),
              autoscaler=_warm(K, max_replicas=2), max_batch=8)
    traffic = [K.G.TrafficSpec("m", 120, arrival="poisson", rate=120.0),
               K.G.TrafficSpec("m", 40, slo="latency", arrival="poisson", rate=60.0),
               K.G.TrafficSpec("n", 80, arrival="poisson", rate=150.0, slo="batch")]
    return gw, traffic, dict(failures=[K.G.FailureSpec("gcp", at_s=0.3, duration_s=0.2)])


def _market(K):
    """Two deployments draw serving leases from one CapacityMarket whose
    gcp ledger holds a recorded training lease: scale-ups preempt it, and
    a migration hands warm state over the interconnect."""
    mkt = K.Market({"gcp": 3, "ibm": 3}, state_bytes=2e7)
    mkt.ledger("gcp").lease("training", "train:step", 0.0)
    gw = K.G.Gateway(log=K.Log(), record_batches=True, shared_capacity=mkt,
                     capacity={"gcp": 3, "ibm": 3})
    gw.deploy("a", AnalyticBackend("a", 0.01, 1e-3), K.P("gcp"),
              autoscaler=K.G.AutoscalerConfig(min_replicas=1, max_replicas=3, target_queue=2,
                                              scale_up_delay_s=0.01, idle_window_s=0.3),
              max_batch=4)
    gw.deploy("b", AnalyticBackend("b", 0.02), K.P("gcp"), standby=K.P("ibm"),
              autoscaler=K.G.AutoscalerConfig(min_replicas=2, max_replicas=3,
                                              idle_window_s=0.3), max_batch=4)
    traffic = [K.G.TrafficSpec("a", 100, arrival="poisson", rate=600.0),
               K.G.TrafficSpec("b", 60, arrival="poisson", rate=200.0)]
    return gw, traffic, dict(migrations=[K.G.MigrationSpec(0.1, {"b": {"gcp": 0.0, "ibm": 1.0}})])


SCENARIOS = {"failover": _failover, "migration": _migration, "diff_plans": _diff_plans,
             "auto_replan": _auto_replan, "staged_disagg": _staged, "cache_shed": _cache_shed,
             "unified_disagg": _unified, "telemetry": _telemetry, "market": _market}
# each scenario's reason to exist: the events it must record
EXERCISES = {"failover": ("gateway:failover", "gateway:recover", "gateway:split"),
             "migration": ("gateway:migrate",),
             "diff_plans": ("gateway:migrate",),
             "auto_replan": ("gateway:migrate",),
             "staged_disagg": ("gateway:prefill",),
             "cache_shed": ("gateway:cache_shed",),
             "unified_disagg": ("gateway:prefill",),
             "telemetry": ("gateway:alert", "profile:drift", "metrics:scrape",
                           "trace:materialize", "gateway:failover"),
             "market": ("capacity:lease", "capacity:preempt", "capacity:handoff")}


def _assert_plane_same(ref_gw, ref_out, port_gw, port_out):
    """Float-for-float equality of two runs, the telemetry plane included."""
    assert ref_gw.log.dump() == port_gw.log.dump()
    assert ref_out.summary() == port_out.summary()
    assert (ref_out.makespan_s, ref_out.costs, ref_out.cold_starts) == \
        (port_out.makespan_s, port_out.costs, port_out.cold_starts)
    assert set(ref_out.per_model) == set(port_out.per_model)
    for m, r in ref_out.per_model.items():
        p = port_out.per_model[m]
        for field in ("latencies_s", "replica_trace", "per_version", "class_latencies",
                      "class_misses", "class_shed", "observed", "cost_usd", "cost_by_cloud",
                      "total_time_s", "n_requests", "strategy"):
            assert getattr(r, field) == getattr(p, field), (m, field)
        assert r.per_class() == p.per_class()
    assert ref_gw.batch_log == port_gw.batch_log
    assert ref_gw.usage_trace == port_gw.usage_trace
    assert ref_gw.final_weights == port_gw.final_weights
    assert ref_gw.final_kv == port_gw.final_kv
    for plane in ("tracer", "metrics"):
        assert (getattr(ref_gw, plane) is None) == (getattr(port_gw, plane) is None)
    if ref_gw.tracer is not None:
        assert ref_gw.tracer.to_json() == port_gw.tracer.to_json()
    if ref_gw.metrics is not None:
        assert ref_gw.metrics.to_prometheus() == port_gw.metrics.to_prometheus()
        assert ref_gw.metrics.to_json() == port_gw.metrics.to_json()
    assert (ref_gw.market is None) == (port_gw.market is None)
    if ref_gw.market is not None:
        for c, led in ref_gw.market.ledgers.items():
            other = port_gw.market.ledgers[c]
            assert led.audit == other.audit
            assert [dataclasses.asdict(x) for x in led.leases] == \
                [dataclasses.asdict(x) for x in other.leases]


@pytest.mark.parametrize("engine", ["scalar", "vector"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_second_slice_equals_reference(scenario, engine):
    runs = {}
    for name, K in PACKAGES.items():
        gw, traffic, kw = SCENARIOS[scenario](K)
        runs[name] = gw, gw.run(traffic, seed=5, engine=engine, **kw)
    _assert_plane_same(*runs["reference"], *runs["port"])
    gw = runs["port"][0]
    for kind in EXERCISES[scenario]:
        assert gw.log.count(kind) > 0, f"{scenario} never recorded {kind}"
    assert unregistered(gw.log) == set()
    for e in gw.log.named("gateway:split"):
        if any(e["weights"].values()):
            assert sum(e["weights"].values()) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("seed", range(8))
def test_random_fleet_equals_reference(seed):
    """The invariant suites' seeded scenario space (failures, migrations,
    auto-replan, admission, burn-rate alerts, scrapes, capacity), built by
    the reference suite and by its twin from one plain-data draw."""
    p = ref_inv.params_from_seed(seed + 2000)
    runs = {}
    for name, mod in (("reference", ref_inv), ("port", port_inv)):
        gw, traffic, failures, migrations = mod.build(p)
        runs[name] = gw, gw.run(traffic, seed=p["seed"], failures=failures,
                                migrations=migrations)
    _assert_plane_same(*runs["reference"], *runs["port"])


@pytest.mark.parametrize("case", ["burst", "poisson_latency"])
def test_inference_service_telemetry_equals_reference(case):
    """The kserve strategy's gateway records into the service's tracer and
    registry: both packages' spans and series are equal."""
    out = {}
    for name, K in PACKAGES.items():
        svc = K.Service(AnalyticBackend("m", 0.68, 0.002), K.P("gcp"), "kserve", log=K.Log(),
                        max_batch=8, tracer=K.Tracer(), metrics=K.Registry())
        kw = {} if case == "burst" else dict(arrival="poisson", rate=20.0, slo="latency", seed=3)
        out[name] = svc, svc.stress_test(32, **kw)
    (rs, r), (ps, p) = out["reference"], out["port"]
    assert rs.log.dump() == ps.log.dump()
    assert r.summary() == p.summary() and r.latencies_s == p.latencies_s
    assert rs.tracer.to_json() == ps.tracer.to_json()
    assert len(ps.tracer.named("gateway.request")) == 32
    assert rs.metrics.to_prometheus() == ps.metrics.to_prometheus()
    assert ps.metrics.total("gateway_requests_total", model="m") == 32


def test_placement_plans_equal_reference():
    """plan_placement (single and split), replan from an observed run, and
    diff_plans give the same plans in both packages."""
    summaries = {}
    for name, K in PACKAGES.items():
        demands = [K.G.ModelDemand("a", 80.0, 0.03),
                   K.G.ModelDemand("b", 5.0, 0.2, prefill_s=0.15, decode_s=0.05),
                   K.G.ModelDemand("c", 200.0, 0.01)]
        single = K.G.plan_placement(demands, _clouds(K))
        split = K.G.plan_placement(demands, _clouds(K), split=True, objective="p99")
        gw = K.G.Gateway(capacity=split.capacity_map())
        for a in split.assignments:
            gw.deploy(a.model, AnalyticBackend(a.model, 0.02, 1e-3),
                      split={K.P(c): w for c, w in a.weights.items()},
                      autoscaler=_warm(K, min_replicas=a.replicas), max_batch=8)
        res = gw.run([K.G.TrafficSpec(d.name, 60, arrival="poisson", rate=d.rate)
                      for d in demands], seed=1)
        revised = K.G.replan(split, res)
        mig = K.G.diff_plans(single, revised)
        summaries[name] = (single.summary(), split.summary(), revised.summary(),
                           [(s.model, s.weights, s.replicas) for s in mig.steps],
                           K.G.est_p99_s(K.P("gcp"), demands[0], 4),
                           K.G.est_wait_s(demands[1], 3), K.G.replicas_needed(demands[2]))
    assert summaries["reference"] == summaries["port"]


@pytest.mark.parametrize("call", ["Gateway", "deploy", "run", "InferenceService"])
def test_entry_point_signatures_equal_reference(call):
    def params(f):
        return [(n, p.kind, p.default) for n, p in inspect.signature(f).parameters.items()]
    pair = {"Gateway": ("serving.gateway", "Gateway.__init__"),
            "deploy": ("serving.gateway", "Gateway.deploy"),
            "run": ("serving.gateway", "Gateway.run"),
            "InferenceService": ("serving.kserve", "InferenceService.__init__")}[call]
    fns = []
    for root in ("repro", "repro_torch"):
        obj = importlib.import_module(f"{root}.{pair[0]}")
        for attr in pair[1].split("."):
            obj = getattr(obj, attr)
        fns.append(obj)
    assert params(fns[0]) == params(fns[1])


def test_event_vocabulary_equals_reference():
    from repro.telemetry.events import EVENT_KINDS as REF_KINDS
    assert EVENT_KINDS == REF_KINDS


# -- twins of tests/test_admission.py's ReplanConfig cases -----------------------

def split_gcp_ibm(f_ibm):
    return {get_profile("gcp"): 1.0 - f_ibm, get_profile("ibm"): f_ibm}


def warm_config(**kw):
    return AutoscalerConfig(min_replicas=kw.pop("min_replicas", 1),
                            idle_window_s=kw.pop("idle_window_s", math.inf), **kw)


def test_config_validation():
    with pytest.raises(ValueError, match="policy"):
        RoutingConfig(policy="jsq")
    with pytest.raises(ValueError, match="slack"):
        RoutingConfig(slack=-0.1)
    with pytest.raises(ValueError, match="margin"):
        AdmissionConfig(margin=0.0)
    with pytest.raises(ValueError, match="max_shed_rate"):
        ReplanConfig(max_shed_rate=0.0)


def test_probe_treats_shed_rate_as_overload_signal():
    """A pool serving inside its queue bound but shedding a class whose
    deadline it cannot meet must still shift weight away
    (gateway:migrate reason=shed_rate)."""
    log = EventLog()
    gw = Gateway(log=log, admission=AdmissionConfig(),
                 replan=ReplanConfig(check_every_s=0.1, sustain=2, min_window_n=4,
                                     max_shed_rate=0.1, consolidate=False))
    strict = SLOClass("strict", weight=4.0, deadline_mult=0.5)
    gw.deploy("m", AnalyticBackend("m", base_s=0.2), get_profile("ibm"),
              standby=get_profile("gcp"),
              autoscaler=warm_config(max_replicas=2, target_queue=64), max_batch=8)
    out = gw.run([TrafficSpec("m", 30, arrival="poisson", rate=40.0),
                  TrafficSpec("m", 30, slo=strict, arrival="poisson", rate=40.0)], seed=0)
    migs = log.named("gateway:migrate")
    assert migs and migs[0]["reason"] == "shed_rate", migs
    assert migs[0]["src"] == "ibm" and migs[0]["dst"] == "gcp"
    assert out.per_model["m"].class_shed.get("strict", 0) > 0


SLOW = CloudProfile("slowcloud", network_rtt_s=0.5, lb_overhead_s=0.0,
                    model_load_s=0.2, cost_per_s=0.9 / 3600)


def test_slow_split_cloud_does_not_oscillate_replan():
    """Misses are charged per serving pool: a cheap-but-slow split cloud
    must not look like a miss storm to the ReplanConfig probes."""
    log = EventLog()
    gw = Gateway(log=log, routing=RoutingConfig(policy="weights"),
                 replan=ReplanConfig(check_every_s=0.25, sustain=2, max_miss_rate=0.3,
                                     consolidate=False))
    gw.deploy("m", AnalyticBackend("m", base_s=0.01),
              split={get_profile("gcp"): 0.5, SLOW: 0.5},
              autoscaler=warm_config(min_replicas=2, max_replicas=4), max_batch=8)
    out = gw.run([TrafficSpec("m", 120, arrival="poisson", rate=50.0)], seed=0)
    assert out.per_model["m"].n_requests == 120
    assert log.named("gateway:migrate") == [], \
        "slow-but-honest split cloud must not trigger miss_rate replans"
    assert gw.final_weights["m"] == {"gcp": 0.5, "slowcloud": 0.5}
    assert out.per_model["m"].per_class()["standard"]["miss_rate"] > 0.2


# -- twin of tests/test_sim_engine.py's stale burn-alert case ---------------------

def test_stale_burn_alert_does_not_livelock_the_run():
    """A burst that ends inside a firing burn alert must still let the run
    terminate: ``BurnRateMonitor.age`` resolves the alert on the simulated
    clock, so the scale-up / idle-retire cycle cannot re-arm forever."""
    def mk(engine):
        gw = Gateway(log=EventLog(), replan=ReplanConfig(),
                     slo_burn=BurnRateConfig(threshold=2.0, min_n=4))
        gw.deploy("m", AnalyticBackend("m", 0.2, 1e-3), get_profile("gcp"),
                  autoscaler=AutoscalerConfig(min_replicas=0, max_replicas=2,
                                              idle_window_s=0.5), max_batch=4)
        out = gw.run([TrafficSpec("m", 16, arrival="burst", slo="latency")],
                     seed=2, engine=engine)
        return gw, out

    gw_s, out_s = mk("scalar")
    states = [e["state"] for e in gw_s.log.events if e["name"] == "gateway:alert"]
    assert "firing" in states
    assert states[-1] == "resolved"
    assert out_s.makespan_s < 60.0
    gw_v, out_v = mk("vector")
    assert gw_s.log.dump() == gw_v.log.dump()
    assert out_s.summary() == out_v.summary()


# -- twins of tests/test_modelci.py's DriftMonitor cases --------------------------

def feed(mon, t, ratio, n=10):
    """One scrape's cumulative counters at observed ratio x profile.  The
    counters live on the monitor object itself: a monitor built later never
    inherits them, even where it reuses a freed object's id."""
    busy, served = getattr(mon, "_test_counters", (0.0, 0))
    busy += ratio * 0.01 * n
    served += n
    mon._test_counters = (busy, served)
    mon.observe(t, "m", busy, served)


def _fed_monitor(threshold=1.5, sustain=2, min_n=8, metrics=None):
    log = EventLog()
    mon = DriftMonitor(DriftConfig(threshold=threshold, sustain=sustain, min_n=min_n),
                       log=log, metrics=metrics)
    mon.watch("m", Profiled(0.01), t=0.0)
    return mon, log


def test_drift_config_validation():
    for bad in (dict(threshold=1.0), dict(threshold=0.5), dict(sustain=0), dict(min_n=0)):
        with pytest.raises(ValueError):
            DriftConfig(**bad)


def test_drift_fires_on_sustained_out_of_band_only():
    mon, log = _fed_monitor()
    feed(mon, 1.0, ratio=1.0)
    feed(mon, 2.0, ratio=2.0)
    assert not mon.is_drifting("m")
    feed(mon, 3.0, ratio=2.0)
    assert mon.is_drifting("m") and mon.drifting_models() == {"m"}
    evs = log.named("profile:drift")
    assert len(evs) == 1 and evs[0]["state"] == "firing"
    assert evs[0]["ratio"] == pytest.approx(2.0, abs=1e-3)
    assert mon.pop_reprofile() == {"m"}
    assert mon.pop_reprofile() == set()
    feed(mon, 4.0, ratio=2.0)
    assert len(log.named("profile:drift")) == 1
    assert log.count("modelci:reprofile") == 1
    feed(mon, 5.0, ratio=1.0)
    assert not mon.is_drifting("m")
    assert [e["state"] for e in log.named("profile:drift")] == ["firing", "resolved"]


def test_drift_detects_too_fast_too():
    mon, log = _fed_monitor(threshold=1.5)
    feed(mon, 1.0, ratio=0.5)
    feed(mon, 2.0, ratio=0.5)
    assert mon.is_drifting("m")


def test_drift_small_intervals_are_not_evidence():
    mon, log = _fed_monitor(min_n=8)
    feed(mon, 1.0, ratio=2.0, n=10)
    feed(mon, 2.0, ratio=2.0, n=3)
    assert not mon.is_drifting("m")
    feed(mon, 3.0, ratio=2.0, n=10)
    assert mon.is_drifting("m")


def test_drift_metrics_and_staleness():
    reg = MetricsRegistry()
    mon, log = _fed_monitor(metrics=reg)
    feed(mon, 7.0, ratio=2.0)
    assert reg.value("modelci_profile_staleness", model="m") == 7.0
    assert reg.value("modelci_drift_ratio", model="m") == pytest.approx(2.0, abs=1e-3)
    feed(mon, 8.0, ratio=2.0)
    assert reg.total("modelci_drift_total", model="m") == 1


def test_drift_rewatch_and_reset_semantics():
    mon, log = _fed_monitor()
    feed(mon, 1.0, ratio=2.0)
    feed(mon, 2.0, ratio=2.0)
    assert mon.is_drifting("m")
    mon.watch("m", Profiled(0.02), t=2.0)
    assert not mon.is_drifting("m") and mon.reprofile == set()
    mon.reset()
    assert not mon.active
    mon.observe(3.0, "ghost", 1.0, 100)
    assert not mon.drifting_models()


def test_drift_feed_starts_each_monitor_from_zero():
    """Two monitors built one after the other, the first dropped before the
    second exists (so the second may reuse its id): the second one's first
    interval is its own 10 requests at ratio 1.0, not a delta against the
    first monitor's counters."""
    mon, _ = _fed_monitor()
    for t in range(1, 6):
        feed(mon, float(t), ratio=3.0)
    assert mon._test_counters == (pytest.approx(1.5), 50)
    del mon
    mon2, log2 = _fed_monitor()
    assert not hasattr(mon2, "_test_counters")
    feed(mon2, 1.0, ratio=1.0)
    assert mon2._test_counters == (pytest.approx(0.1), 10)
    feed(mon2, 2.0, ratio=1.0)
    feed(mon2, 3.0, ratio=1.0)
    assert not mon2.is_drifting("m") and log2.named("profile:drift") == []


def test_gateway_drift_requires_scrape_clock():
    with pytest.raises(ValueError, match="scrape_every_s"):
        Gateway(drift=DriftConfig())
    with pytest.raises(ValueError, match="scrape_every_s"):
        Gateway(drift=DriftConfig(), metrics=MetricsRegistry())
    gw = Gateway(drift=DriftConfig(), metrics=MetricsRegistry(), scrape_every_s=0.5)
    assert gw.drift is not None
    gw.deploy("m", AnalyticBackend("m"), get_profile("gcp"), planned_from=Profiled(0.01))
    assert "m" in gw.drift._watch
