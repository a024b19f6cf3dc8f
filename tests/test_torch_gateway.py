"""The port's serving gateway (``repro_torch.serving.gateway``) against the
reference's, and its own twins of the reference's gateway tests.

- Cross-package parity, exact: one closed-form backend (``AnalyticBackend``
  of tests/conftest.py: ``.name`` and ``.service_time(b)``, all the router
  calls) goes into both packages' ``Gateway`` with the same traffic and
  seed; every result -- latencies, replica trace, per-version and per-class
  counts, simulated dollars, the batch log and the stripped event log -- is
  equal float for float.
- Twins of tests/test_admission.py and tests/test_sim_engine.py (their
  ``ReplanConfig`` / ``BurnRateConfig`` cases are in
  tests/test_torch_gateway_plane.py) and of tests/test_engine_equivalence.py
  (scalar == vector on the port).
- An argument neither package knows is a TypeError.
- A ``BatcherBackend`` over the h2o_danube smoke batcher, on the CPU, behind
  the port's Gateway.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.clouds.profiles as ref_profiles  # noqa: E402
import repro.serving.gateway as ref_gateway  # noqa: E402
import repro.telemetry.events as ref_events  # noqa: E402
import repro_torch.clouds.profiles as port_profiles  # noqa: E402
import repro_torch.serving.gateway as port_gateway  # noqa: E402
import repro_torch.telemetry.events as port_events  # noqa: E402
from repro.serving.kserve import InferenceService as RefService  # noqa: E402
from repro_torch.clouds.profiles import CloudProfile, get_profile  # noqa: E402
from repro_torch.serving.gateway import (SLO_CLASSES, AdmissionConfig,  # noqa: E402
                                         AutoscalerConfig, BatcherBackend,
                                         Gateway, RoutingConfig, ServeResult,
                                         SLOClass, TrafficSpec)
from repro_torch.serving.gateway.router import _apportion  # noqa: E402
from repro_torch.serving.kserve import InferenceService as PortService  # noqa: E402
from repro_torch.sim import EventHeap, IndexQueue, Ledger  # noqa: E402
from repro_torch.telemetry.events import EventLog  # noqa: E402

from conftest import AnalyticBackend  # noqa: E402

PACKAGES = {"reference": (ref_profiles.get_profile, ref_gateway, ref_events.EventLog),
            "port": (port_profiles.get_profile, port_gateway, port_events.EventLog)}


# -- cross-package parity ------------------------------------------------------

def _burst(P, G, Log):
    gw = G.Gateway(log=Log(), record_batches=True)
    gw.deploy("m", AnalyticBackend("m", 0.05, 1e-3), P("gcp"),
              autoscaler=G.AutoscalerConfig(min_replicas=1, max_replicas=4, target_queue=8,
                                            idle_window_s=math.inf),
              max_batch=8)
    return gw, [G.TrafficSpec("m", 200)]


def _poisson(P, G, Log):
    gw = G.Gateway(log=Log(), record_batches=True)
    gw.deploy("m", AnalyticBackend("m", 0.02, 2e-3), P("ibm"),
              autoscaler=G.AutoscalerConfig(min_replicas=1, max_replicas=3, target_queue=4,
                                            idle_window_s=0.4),
              max_batch=4)
    return gw, [G.TrafficSpec("m", 300, arrival="poisson", rate=250.0)]


def _canary(P, G, Log):
    gw = G.Gateway(log=Log(), record_batches=True)
    gw.deploy("m", AnalyticBackend("m-v1", 0.03, 1e-3), P("gcp"),
              canary=AnalyticBackend("m-v2", 0.04, 1e-3), canary_fraction=0.25,
              autoscaler=G.AutoscalerConfig(min_replicas=1, max_replicas=4, target_queue=6),
              max_batch=8)
    return gw, [G.TrafficSpec("m", 150, arrival="poisson", rate=400.0),
                G.TrafficSpec("m", 50, slo="latency", start_s=0.1)]


def _admission(P, G, Log):
    gw = G.Gateway(log=Log(), record_batches=True, admission=G.AdmissionConfig())
    gw.deploy("m", AnalyticBackend("m", 0.1), P("gcp"),
              autoscaler=G.AutoscalerConfig(min_replicas=1, max_replicas=4, target_queue=2,
                                            scale_up_delay_s=0.5, idle_window_s=math.inf),
              max_batch=1)
    return gw, [G.TrafficSpec("m", 6, slo="latency"),
                G.TrafficSpec("m", 8, slo="latency", start_s=0.05),
                G.TrafficSpec("m", 30, arrival="poisson", rate=40.0)]


def _admission_off(P, G, Log):
    gw = G.Gateway(log=Log(), record_batches=True)
    gw.deploy("m", AnalyticBackend("m", 0.1), P("gcp"),
              autoscaler=G.AutoscalerConfig(min_replicas=1, max_replicas=4, target_queue=2,
                                            scale_up_delay_s=0.5, idle_window_s=math.inf),
              max_batch=1)
    return gw, [G.TrafficSpec("m", 6, slo="latency"),
                G.TrafficSpec("m", 8, slo="latency", start_s=0.05)]


def _slo_mix(P, G, Log):
    """Batch-class bursts on one replica with latency work just behind:
    latency batches preempt in-flight batch batches."""
    gw = G.Gateway(log=Log(), record_batches=True)
    gw.deploy("m", AnalyticBackend("m", 0.1, 1e-3), P("gcp"),
              autoscaler=G.AutoscalerConfig(min_replicas=1, max_replicas=1,
                                            idle_window_s=math.inf),
              max_batch=8)
    return gw, [G.TrafficSpec("m", 24, slo="batch"),
                G.TrafficSpec("m", 6, slo="latency", arrival="poisson", rate=30.0,
                              start_s=0.02),
                G.TrafficSpec("m", 10, slo="batch", start_s=0.15)]


def _split_capacity(P, G, Log):
    """Two models on a two-cloud split under shared per-cloud capacity:
    scale-ups are denied, one pool scales from zero over its budget."""
    gw = G.Gateway(log=Log(), record_batches=True, capacity={"gcp": 3, "ibm": 2})
    gw.deploy("a", AnalyticBackend("a", 0.05, 1e-3),
              split={P("gcp"): 0.6, P("ibm"): 0.4},
              autoscaler=G.AutoscalerConfig(min_replicas=2, max_replicas=5, target_queue=4,
                                            idle_window_s=0.5),
              max_batch=4)
    gw.deploy("b", AnalyticBackend("b", 0.2), P("gcp"),
              autoscaler=G.AutoscalerConfig(min_replicas=1, max_replicas=2, target_queue=2),
              max_batch=2)
    gw.deploy("idle", AnalyticBackend("idle", 0.1), P("ibm"),
              autoscaler=G.AutoscalerConfig(min_replicas=0), max_batch=4)
    return gw, [G.TrafficSpec("a", 120, arrival="poisson", rate=300.0),
                G.TrafficSpec("a", 20, slo="latency", start_s=0.1),
                G.TrafficSpec("b", 30, slo="batch"),
                G.TrafficSpec("b", 10, slo="latency", start_s=0.05)]


def _scale_to_zero(P, G, Log):
    """Two bursts apart by more than the idle window over a weighted split:
    scale-to-zero, then cold starts that pay the profile's model load."""
    gw = G.Gateway(log=Log(), record_batches=True, routing=G.RoutingConfig("weights"))
    gw.deploy("m", AnalyticBackend("m", 0.05, 1e-3), split={P("gcp"): 0.5, P("ibm"): 0.5},
              autoscaler=G.AutoscalerConfig(min_replicas=0, max_replicas=3, target_queue=4,
                                            idle_window_s=0.3),
              max_batch=4)
    return gw, [G.TrafficSpec("m", 20), G.TrafficSpec("m", 20, start_s=2.0)]


SCENARIOS = {"burst": _burst, "poisson": _poisson, "canary": _canary,
             "admission": _admission, "admission_off": _admission_off, "slo_mix": _slo_mix,
             "split_capacity": _split_capacity, "scale_to_zero": _scale_to_zero}
# each scenario's reason to exist: an event it must record
EXERCISES = {"admission": "gateway:shed", "slo_mix": "gateway:preempt",
             "split_capacity": "gateway:scale_denied", "scale_to_zero": "gateway:cold_start",
             "burst": "gateway:scale_up", "canary": "gateway:scale_up"}


def _build(package: str, scenario: str):
    return SCENARIOS[scenario](*PACKAGES[package])


def _assert_same(ref_gw, ref_out, port_gw, port_out):
    """Float-for-float equality of two Gateway runs (either package)."""
    assert ref_gw.log.dump() == port_gw.log.dump()
    assert [e["name"] for e in ref_gw.log.events] == [e["name"] for e in port_gw.log.events]
    assert ref_out.summary() == port_out.summary()
    assert ref_out.makespan_s == port_out.makespan_s
    assert ref_out.costs == port_out.costs
    assert ref_out.cold_starts == port_out.cold_starts
    assert set(ref_out.per_model) == set(port_out.per_model)
    for m, r in ref_out.per_model.items():
        p = port_out.per_model[m]
        assert r.latencies_s == p.latencies_s
        assert r.replica_trace == p.replica_trace
        assert r.per_version == p.per_version
        assert r.class_latencies == p.class_latencies
        assert r.class_misses == p.class_misses
        assert r.class_shed == p.class_shed
        assert r.observed == p.observed
        assert r.cost_usd == p.cost_usd and r.cost_by_cloud == p.cost_by_cloud
        assert r.summary() == p.summary() and r.per_class() == p.per_class()
    assert ref_gw.batch_log == port_gw.batch_log
    assert ref_gw.usage_trace == port_gw.usage_trace
    assert ref_gw.final_weights == port_gw.final_weights


@pytest.mark.parametrize("engine", ["scalar", "vector"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_gateway_equals_reference(scenario, engine):
    runs = {}
    for package in PACKAGES:
        gw, traffic = _build(package, scenario)
        runs[package] = gw, gw.run(traffic, seed=5, engine=engine)
    _assert_same(*runs["reference"], *runs["port"])
    kind = EXERCISES.get(scenario)
    if kind:
        assert runs["port"][0].log.count(kind) > 0, f"{scenario} never recorded {kind}"


SERVICE_CASES = {
    "burst": dict(n=32, kw={}, svc=dict(max_batch=8)),
    "poisson": dict(n=64, kw=dict(arrival="poisson", rate=20.0, seed=3), svc=dict(max_batch=8)),
    "canary_latency": dict(n=80, kw=dict(slo="latency", seed=7),
                           svc=dict(canary_fraction=0.25, target_queue=4)),
    "admission": dict(n=48, kw=dict(slo="latency"),
                      svc=dict(max_batch=2, max_replicas=2, target_queue=4,
                               admission="on")),
}


@pytest.mark.parametrize("case", list(SERVICE_CASES))
def test_inference_service_kserve_equals_reference(case):
    """The paper's stress test through both packages' kserve strategy, on
    the closed-form cost the issue sized it with (0.68 s + 2 ms x b)."""
    c = SERVICE_CASES[case]
    out = {}
    for package, service in (("reference", RefService), ("port", PortService)):
        P, G, Log = PACKAGES[package]
        kw = dict(c["svc"])
        if "canary_fraction" in kw:
            kw["canary"] = AnalyticBackend("m-v2", 0.7, 0.002)
        if kw.get("admission") == "on":
            kw["admission"] = G.AdmissionConfig(margin=0.5)
        svc = service(AnalyticBackend("m", 0.68, 0.002), P("gcp"), "kserve", log=Log(), **kw)
        out[package] = svc, svc.stress_test(c["n"], **c["kw"])
    (rs, r), (ps, p) = out["reference"], out["port"]
    assert rs.log.dump() == ps.log.dump()
    assert r.summary() == p.summary()
    for field in ("latencies_s", "replica_trace", "per_version", "class_latencies",
                  "class_misses", "class_shed", "observed", "cost_usd", "cost_by_cloud",
                  "total_time_s", "n_requests", "strategy"):
        assert getattr(r, field) == getattr(p, field), field


# -- twins of tests/test_admission.py -------------------------------------------

def warm_config(**kw):
    return AutoscalerConfig(min_replicas=kw.pop("min_replicas", 1),
                            idle_window_s=kw.pop("idle_window_s", math.inf), **kw)


def split_gcp_ibm(f_ibm):
    return {get_profile("gcp"): 1.0 - f_ibm, get_profile("ibm"): f_ibm}


def test_config_validation():
    with pytest.raises(ValueError, match="policy"):
        RoutingConfig(policy="jsq")
    with pytest.raises(ValueError, match="slack"):
        RoutingConfig(slack=-0.1)
    with pytest.raises(ValueError, match="margin"):
        AdmissionConfig(margin=0.0)


def _stale_weights_fleet(routing):
    gw = Gateway(record_batches=True, routing=routing)
    gw.deploy("m", AnalyticBackend("m", base_s=0.1), split=split_gcp_ibm(0.1),
              autoscaler=warm_config(min_replicas=2, max_replicas=2), max_batch=1)
    return gw


def test_queue_aware_drains_to_idle_sibling_pool():
    traffic = [TrafficSpec("m", 40)]
    by_policy = {}
    for policy in ("weights", "queue_aware"):
        gw = _stale_weights_fleet(RoutingConfig(policy=policy))
        out = gw.run(traffic, seed=0)
        per_cloud = {}
        for rec in gw.batch_log:
            per_cloud[rec["cloud"]] = per_cloud.get(rec["cloud"], 0) + len(rec["idx"])
        by_policy[policy] = (out.per_model["m"].p99, per_cloud)
    p99_w, cloud_w = by_policy["weights"]
    p99_q, cloud_q = by_policy["queue_aware"]
    assert cloud_w.get("ibm", 0) < 10
    assert cloud_q["ibm"] >= 15
    assert abs(cloud_q["gcp"] - cloud_q["ibm"]) <= 6
    assert p99_q < p99_w


def test_queue_aware_respects_weights_when_balanced():
    gw = Gateway(record_batches=True)
    gw.deploy("m", AnalyticBackend("m", base_s=0.05), split=split_gcp_ibm(0.3),
              autoscaler=warm_config(min_replicas=2, max_replicas=2), max_batch=8)
    gw.run([TrafficSpec("m", 300, arrival="poisson", rate=10.0)], seed=3)
    share = sum(len(r["idx"]) for r in gw.batch_log if r["cloud"] == "ibm") / 300
    assert 0.2 < share < 0.45


def test_queue_aware_routing_is_deterministic():
    traffic = [TrafficSpec("m", 60, arrival="poisson", rate=120.0),
               TrafficSpec("m", 20, slo="latency", start_s=0.1)]
    runs = []
    for _ in range(2):
        gw = _stale_weights_fleet(RoutingConfig())
        out = gw.run(traffic, seed=7)
        runs.append((out.summary(), [(r["cloud"], r["idx"]) for r in gw.batch_log]))
    assert runs[0] == runs[1]


def test_queue_hint_biases_first_arrivals_off_congested_plan():
    gw = Gateway(record_batches=True)
    gw.deploy("m", AnalyticBackend("m", base_s=0.01), split=split_gcp_ibm(0.5),
              autoscaler=warm_config(min_replicas=2, max_replicas=2), max_batch=4,
              queue_hint={"gcp": 5.0})
    gw.run([TrafficSpec("m", 4)], seed=0)
    first = min(gw.batch_log, key=lambda r: (r["start_s"], min(r["idx"])))
    assert first["cloud"] == "ibm"


def _hopeless(margin=1.0):
    log = EventLog()
    gw = Gateway(log=log, record_batches=True, admission=AdmissionConfig(margin=margin))
    gw.deploy("m", AnalyticBackend("m", base_s=0.2), get_profile("gcp"),
              autoscaler=warm_config(max_replicas=1), max_batch=1)
    return gw, log


def test_hopeless_requests_shed_exactly_once_and_reported():
    gw, log = _hopeless()
    out = gw.run([TrafficSpec("m", 30, slo="latency")], seed=0)
    res = out.per_model["m"]
    sheds = log.named("gateway:shed")
    assert sheds
    idx = [e["idx"] for e in sheds]
    assert len(idx) == len(set(idx))
    assert res.n_requests == 30
    assert len(res.latencies_s) == 30 - len(idx)
    assert res.shed_total == len(idx)
    assert res.class_shed == {"latency": len(idx)}
    served = sorted(i for rec in gw.batch_log if not rec["preempted"] for i in rec["idx"])
    assert sorted(served + idx) == list(range(30))
    pc = res.per_class()["latency"]
    assert pc["shed"] == len(idx)
    assert pc["shed_rate"] == pytest.approx(len(idx) / 30, abs=1e-4)
    assert 0 < res.shed_rate < 1
    assert out.shed_total == res.shed_total
    assert "shed" in res.summary() and "shed" in out.summary()
    assert all(l > 0 for l in res.latencies_s)


def test_batch_class_is_deferred_never_shed():
    gw, log = _hopeless()
    out = gw.run([TrafficSpec("m", 30, slo="batch"),
                  TrafficSpec("m", 10, slo="latency", start_s=0.01)], seed=0)
    res = out.per_model["m"]
    assert res.class_shed.get("batch", 0) == 0
    assert len(res.class_latencies["batch"]) == 30
    assert all(e["cls"] != "batch" for e in log.named("gateway:shed"))


def test_infinite_deadline_class_never_shed():
    gw, log = _hopeless()
    out = gw.run([TrafficSpec("m", 30, slo=SLOClass("lazy", 1.0, math.inf))], seed=0)
    assert log.count("gateway:shed") == 0
    assert out.per_model["m"].shed_total == 0


def test_admission_off_is_legacy_behavior():
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m", base_s=0.2), get_profile("gcp"),
              autoscaler=warm_config(max_replicas=1), max_batch=1)
    res = gw.run([TrafficSpec("m", 30, slo="latency")], seed=0).per_model["m"]
    assert res.shed_total == 0 and res.class_shed == {}
    assert len(res.latencies_s) == 30
    assert "shed" not in res.summary()


def test_dispatch_recheck_sheds_aged_backlog():
    log = EventLog()
    gw = Gateway(log=log, admission=AdmissionConfig())
    gw.deploy("m", AnalyticBackend("m", base_s=0.1), get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=4, target_queue=2,
                                          scale_up_delay_s=0.5, idle_window_s=math.inf),
              max_batch=1)
    out = gw.run([TrafficSpec("m", 6, slo="latency"),
                  TrafficSpec("m", 8, slo="latency", start_s=0.05)], seed=0)
    sheds = log.named("gateway:shed")
    assert {e["at"] for e in sheds} == {"enqueue", "dispatch"}
    idx = [e["idx"] for e in sheds]
    assert len(idx) == len(set(idx))
    assert len(out.per_model["m"].latencies_s) == 14 - len(idx)


def test_shedding_triggers_scale_up_not_masking():
    log = EventLog()
    gw = Gateway(log=log, admission=AdmissionConfig())
    gw.deploy("m", AnalyticBackend("m", base_s=0.2), get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=4, target_queue=2,
                                          scale_up_delay_s=0.05, idle_window_s=math.inf),
              max_batch=1)
    gw.run([TrafficSpec("m", 40, slo="latency")], seed=0)
    assert log.count("gateway:shed") > 0
    assert log.count("gateway:scale_up") >= 1


SLOW = CloudProfile("slowcloud", network_rtt_s=0.5, lb_overhead_s=0.0,
                    model_load_s=0.2, cost_per_s=0.9 / 3600)


def test_shedder_uses_serving_pools_own_base():
    gw = Gateway(routing=RoutingConfig(policy="weights"), admission=AdmissionConfig())
    gw.deploy("m", AnalyticBackend("m", base_s=0.01), split={get_profile("gcp"): 0.5, SLOW: 0.5},
              autoscaler=warm_config(min_replicas=2, max_replicas=4), max_batch=8)
    out = gw.run([TrafficSpec("m", 60, arrival="poisson", rate=20.0)], seed=0)
    assert out.per_model["m"].shed_total == 0


def test_apportion_min1_floor_for_live_pools():
    assert _apportion(2, {"a": 0.95, "b": 0.05}) == {"a": 1, "b": 1}
    assert _apportion(3, {"a": 0.95, "b": 0.05}) == {"a": 2, "b": 1}
    assert _apportion(1, {"a": 0.95, "b": 0.05}) == {"a": 1, "b": 0}
    assert _apportion(2, {"a": 0.9, "b": 0.1, "standby": 0.0}) == \
        {"a": 1, "b": 1, "standby": 0}
    assert _apportion(20, {"a": 0.95, "b": 0.05}) == {"a": 19, "b": 1}
    assert _apportion(0, {"a": 1.0}) == {"a": 0}


def test_low_weight_pool_serves_immediately_at_small_replica_counts():
    gw = Gateway(record_batches=True, routing=RoutingConfig("weights"))
    gw.deploy("m", AnalyticBackend("m", base_s=0.05), split=split_gcp_ibm(0.05),
              autoscaler=warm_config(min_replicas=2, max_replicas=2), max_batch=8)
    out = gw.run([TrafficSpec("m", 100)], seed=4)
    assert out.per_model["m"].n_requests == 100
    assert min(r["start_s"] for r in gw.batch_log if r["cloud"] == "ibm") == 0.0


def test_observed_rate_counts_intervals_not_arrivals():
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m", base_s=0.001), get_profile("gcp"),
              autoscaler=warm_config(), max_batch=4)
    obs = gw.run([TrafficSpec("m", 4, arrivals=[0.0, 1.0, 2.0, 3.0])]).per_model["m"].observed
    assert obs["window_s"] == pytest.approx(3.0)
    assert obs["rate_rps"] == pytest.approx(1.0)


def test_observed_rate_burst_fallback_unchanged():
    gw = Gateway()
    gw.deploy("m", AnalyticBackend("m", base_s=0.01), get_profile("gcp"),
              autoscaler=warm_config(), max_batch=8)
    obs = gw.run([TrafficSpec("m", 16)]).per_model["m"].observed
    assert obs["rate_rps"] == pytest.approx(16 / obs["window_s"])
    assert obs["rate_rps"] > 0


# -- twins of tests/test_sim_engine.py ------------------------------------------

def test_heap_orders_by_time_then_push_order():
    h = EventHeap()
    h.push(2.0, "b", "late")
    h.push(1.0, "a", "first-at-1")
    h.push(1.0, "a", "second-at-1")
    h.push(1.0, "z", "third-at-1")
    assert h.peek_t() == 1.0
    got = [h.pop() for _ in range(len(h))]
    assert got == [("a", "first-at-1"), ("a", "second-at-1"), ("z", "third-at-1"),
                   ("b", "late")]
    assert not h and h.peek_t() == math.inf
    assert h.n_pushed == 4 and h.n_popped == 4


def test_heap_payloads_never_compared():
    h = EventHeap()
    h.push(0.0, "k", {"dict": 1})
    h.push(0.0, "k", {"dict": 2})
    assert h.pop() == ("k", {"dict": 1})
    assert h.pop() == ("k", {"dict": 2})


def test_heap_pop_batch_excludes_sameday_pushes():
    h = EventHeap()
    h.push(1.0, "x")
    h.push(1.0, "y")
    h.push(2.0, "z")
    t, batch = h.pop_batch()
    assert t == 1.0 and batch == [("x",), ("y",)]
    h.push(2.0, "w")
    t, batch = h.pop_batch()
    assert t == 2.0 and batch == [("z",), ("w",)]


def test_heap_only_timers_dead_tail_rule():
    h = EventHeap(timer_kinds=("probe", "scrape"))
    assert h.only_timers()
    h.push(5.0, "probe")
    h.push(6.0, "scrape")
    assert h.only_timers()
    h.push(5.5, "free", "m", ())
    assert not h.only_timers()
    assert h.pop() == ("probe",)
    assert h.pop() == ("free", "m", ())
    assert h.only_timers()


def test_index_queue_fifo_and_take():
    q = IndexQueue()
    q.extend(range(5))
    q.append(5)
    assert len(q) == 6 and bool(q)
    assert q.peek() == 0
    assert q.popleft() == 0
    assert q.take(3) == [1, 2, 3]
    assert list(q) == [4, 5]
    assert sorted(q) == [4, 5]
    assert q.take(99) == [4, 5]
    assert len(q) == 0 and not q


def test_index_queue_compaction_preserves_order():
    q = IndexQueue(range(1000))
    out = [q.popleft() for _ in range(997)]
    assert out == list(range(997))
    q.extend([1000, 1001])
    assert list(q) == [997, 998, 999, 1000, 1001]
    assert [q.popleft() for _ in range(5)] == [997, 998, 999, 1000, 1001]


def test_index_queue_interleaved_matches_plain_list():
    rng = np.random.default_rng(3)
    q, ref = IndexQueue(), []
    for op in rng.integers(0, 3, 500):
        if op == 0 or not ref:
            x = int(rng.integers(0, 1000))
            q.append(x)
            ref.append(x)
        elif op == 1:
            assert q.popleft() == ref.pop(0)
        else:
            k = int(rng.integers(1, 4))
            assert q.take(k) == ref[:k]
            del ref[:k]
        assert list(q) == ref and len(q) == len(ref)


def test_ledger_columns_and_deadlines():
    led = Ledger(np.array([0.0, 0.5, 1.0]), np.array([0, 1, 0], dtype=np.intp),
                 np.zeros(3, int), np.zeros(3))
    assert len(led) == 3
    assert (led.lat == -1.0).all() and not led.shed.any()
    np.testing.assert_allclose(led.deadlines(np.array([2.0, 10.0]), 0.1), [0.2, 1.0, 0.2])


def _single_pool_gateway(admission=None):
    gw = Gateway(log=EventLog(), record_batches=True, admission=admission)
    gw.deploy("m", AnalyticBackend("m", 0.02, 1e-3), get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=1), max_batch=4)
    return gw


def test_dispatch_is_fifo_within_class():
    gw = _single_pool_gateway()
    out = gw.run([TrafficSpec("m", 64, arrival="poisson", rate=800.0)], seed=4)
    served = [i for rec in gw.batch_log for i in rec["idx"]]
    assert served == sorted(served) and len(served) == 64
    assert out.per_model["m"].shed_total == 0


def test_shed_exactly_once_under_overload():
    gw = _single_pool_gateway(AdmissionConfig(margin=1.0))
    res = gw.run([TrafficSpec("m", 120, slo="latency")], seed=0).per_model["m"]
    assert res.shed_total > 0
    assert gw.log.count("gateway:shed") == res.shed_total
    served = [i for rec in gw.batch_log for i in rec["idx"]]
    assert served == sorted(served)
    assert len(served) + res.shed_total == 120
    assert len(res.latencies_s) == len(served)


def test_burst_rate_not_diluted_by_drain_time():
    gw = _single_pool_gateway()
    res = gw.run([TrafficSpec("m", 120, slo="batch")], seed=0).per_model["m"]
    obs = res.observed
    assert obs["window_s"] > 0
    assert obs["window_s"] == pytest.approx(obs["service_time_s"])
    assert obs["rate_rps"] == pytest.approx(120 / obs["window_s"])
    assert obs["rate_rps"] > 10 * (120 / res.total_time_s)


def test_trickle_rate_window_unchanged():
    gw = _single_pool_gateway()
    obs = gw.run([TrafficSpec("m", 50, arrival="poisson", rate=40.0)],
                 seed=1).per_model["m"].observed
    assert obs["rate_rps"] == pytest.approx((50 - 1) / obs["window_s"])


def test_empty_serve_result_percentiles_are_none():
    res = ServeResult("gateway:x", 4, 1.0, [], class_shed={"standard": 4})
    assert res.p50 is None and res.p99 is None
    s = res.summary()
    assert s["p50_s"] is None and s["p99_s"] is None
    assert s["shed"] == 4 and s["shed_rate"] == 1.0
    pc = res.per_class()["standard"]
    assert pc["n"] == 0 and pc["p50_s"] is None and pc["p99_s"] is None
    assert pc["shed"] == 4 and pc["shed_rate"] == 1.0


def test_shed_everything_run_reports_none_percentiles():
    """A near-zero shed margin against a 5 s backend drops every request:
    the summary says None, never a fake perfect 0.0."""
    gw = Gateway(log=EventLog(), admission=AdmissionConfig(margin=0.01))
    gw.deploy("m", AnalyticBackend("m", 5.0, 0.0), get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=1), max_batch=1)
    res = gw.run([TrafficSpec("m", 10, slo="latency")], seed=0).per_model["m"]
    assert res.shed_total == 10
    assert res.latencies_s == []
    assert res.p50 is None and res.summary()["p99_s"] is None


# -- engine equivalence on the port (tests/test_engine_equivalence.py) ----------

def _random_fleet(seed: int):
    """A seeded scenario drawn with numpy: one or two models, a static split
    or one cloud, canaries, SLO class mixes, admission on or off, capacity."""
    rng = np.random.default_rng(seed)
    gw = Gateway(log=EventLog(), record_batches=True,
                 admission=AdmissionConfig() if rng.random() < 0.5 else None,
                 routing=RoutingConfig(rng.choice(["queue_aware", "weights"])),
                 capacity={"gcp": int(rng.integers(2, 6))} if rng.random() < 0.5 else None)
    traffic = []
    for m in range(int(rng.integers(1, 3))):
        name = f"m{m}"
        split = ({get_profile("gcp"): 0.7, get_profile("ibm"): 0.3} if rng.random() < 0.5
                 else None)
        canary = rng.random() < 0.5
        gw.deploy(name, AnalyticBackend(f"{name}-v1", float(rng.uniform(0.01, 0.2)), 1e-3),
                  None if split else get_profile("gcp"), split=split,
                  canary=AnalyticBackend(f"{name}-v2", 0.05, 1e-3) if canary else None,
                  canary_fraction=0.3 if canary else 0.0,
                  autoscaler=AutoscalerConfig(min_replicas=int(rng.integers(0, 3)),
                                              max_replicas=int(rng.integers(2, 5)),
                                              target_queue=int(rng.integers(2, 9)),
                                              idle_window_s=float(rng.choice([0.3, math.inf]))),
                  max_batch=int(rng.integers(1, 9)))
        for _ in range(int(rng.integers(1, 4))):
            traffic.append(TrafficSpec(
                name, int(rng.integers(5, 80)), arrival=rng.choice(["burst", "poisson"]),
                rate=float(rng.uniform(20, 400)), start_s=float(rng.uniform(0, 0.5)),
                slo=rng.choice(list(SLO_CLASSES))))
    return gw, traffic


@pytest.mark.parametrize("seed", range(8))
def test_engines_bit_compatible_seeded(seed):
    runs = {}
    for engine in ("scalar", "vector"):
        gw, traffic = _random_fleet(seed)
        runs[engine] = gw, gw.run(traffic, seed=seed, engine=engine)
    _assert_same(*runs["scalar"], *runs["vector"])
    assert runs["scalar"][0].run_stats["requests"] == runs["vector"][0].run_stats["requests"]


def test_equivalence_on_pure_burst():
    runs = {}
    for engine in ("scalar", "vector"):
        gw = Gateway(log=EventLog(), record_batches=True)
        gw.deploy("m", AnalyticBackend("m", 0.02, 1e-4), get_profile("gcp"),
                  autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2), max_batch=8)
        runs[engine] = gw, gw.run([TrafficSpec("m", 500)], seed=7, engine=engine)
    _assert_same(*runs["scalar"], *runs["vector"])


def test_equivalence_with_canary_split_classes():
    runs = {}
    for engine in ("scalar", "vector"):
        gw = Gateway(log=EventLog(), record_batches=True)
        gw.deploy("m", AnalyticBackend("m-v0", 0.01, 1e-4), get_profile("gcp"),
                  canary=AnalyticBackend("m-v1", 0.012, 1e-4), canary_fraction=0.3,
                  autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=3), max_batch=8)
        traffic = [TrafficSpec("m", 300, arrival="poisson", rate=900.0, slo="latency"),
                   TrafficSpec("m", 300, arrival="poisson", rate=900.0, slo="standard")]
        runs[engine] = gw, gw.run(traffic, seed=11, engine=engine)
    _assert_same(*runs["scalar"], *runs["vector"])


def test_unknown_engine_rejected():
    gw = _single_pool_gateway()
    with pytest.raises(ValueError, match="unknown engine"):
        gw.run([TrafficSpec("m", 4)], engine="turbo")


# -- arguments ------------------------------------------------------------------

def test_unknown_argument_is_a_type_error():
    with pytest.raises(TypeError, match="colour"):
        Gateway(colour="red")


# -- the gateway over a measured batcher, on the smoke config -------------------

def test_gateway_serves_a_batcher_backend_on_the_smoke_config():
    """``BatcherBackend`` measures the h2o_danube smoke batcher on the CPU
    (real drains), then the Gateway serves a Poisson mix of two classes on
    it: every request once, and no latency below RTT + LB + service_time(1)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serving.continuous import ContinuousBatcher
    cfg = registry.get_smoke_config("h2o_danube_3_4b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    be = BatcherBackend("h2o", ContinuousBatcher(cfg, params, max_slots=2, max_len=48,
                                                 prefill_chunk=8),
                        prompt_len=16, gen_tokens=4)
    svc1 = be.service_time(1)
    gw = Gateway(log=EventLog(), record_batches=True)
    gw.deploy("h2o", be, get_profile("gcp"), max_batch=be.batcher.max_slots,
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2))
    out = gw.run([TrafficSpec("h2o", 16, arrival="poisson", rate=0.5 / svc1),
                  TrafficSpec("h2o", 16, arrival="poisson", rate=0.5 / svc1, slo="latency")],
                 seed=0)
    res = out.per_model["h2o"]
    served = sorted(i for rec in gw.batch_log if not rec["preempted"] for i in rec["idx"])
    assert served == list(range(32)) and sum(res.per_version.values()) == 32
    prof = get_profile("gcp")
    # a latency is (t + rtt + lb + service) - arrival: exact up to rounding
    assert min(res.latencies_s) >= prof.network_rtt_s + prof.lb_overhead_s + svc1 - 1e-9
    assert set(res.per_class()) == {"standard", "latency"}
