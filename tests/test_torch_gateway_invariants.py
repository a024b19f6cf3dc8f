"""Twin of tests/test_gateway_invariants.py on the port: property-based
invariants over random gateway fleets, traffic mixes, failure injections,
active-active splits, live migrations and queue-aware routing + per-class
admission control -- with the observability plane (tracer + metrics
registry + burn-rate monitor) attached to every scenario and reconciled
against the simulation.

Nine invariants, checked over randomly drawn scenarios:

  1. every request completes EXACTLY once OR is shed exactly once (with a
     matching gateway:shed event), even when preemption, cloud failover
     and mid-run live migration re-queue in-flight batches;
     served + shed == offered, and ``batch``-class work is never shed;
  2. simulated time is monotonic per replica -- batches on one replica never
     overlap (a preempted batch ends at its preemption time);
  3. shared per-cloud capacity caps are never exceeded, except the
     documented scale-from-zero breach (gateway:capacity_exceeded);
  4. a fixed seed makes Gateway.run bit-for-bit deterministic (identical
     summary dict and event-name sequence on a rebuilt gateway) under
     BOTH routing policies and with admission control on or off;
  5. split weights always normalize to 1: every gateway:split event and the
     post-run final_weights map sum to 1 per model (0 only while every
     cloud of a deployment is down);
  6. shed bookkeeping is consistent: per-class shed counts match the
     event log, shed requests are excluded from latency percentiles, and
     with admission off nothing is ever shed;
  7. the span tree is well-formed (validate_trace) and complete: one
     gateway.run root, one gateway.request span per offered request
     ending served xor shed, and a served request's latency decomposes
     exactly into queue + preempted + rtt/lb + cold + service child time;
  8. the metric plane reconciles exactly: served + shed counters equal
     offered per model, per-class histogram counts equal the served
     samples, and sketch p50/p99 sit within the 1/sub relative-error
     bound of the exact rank statistic;
  9. burn-rate alert edges strictly alternate firing/resolved per
     (model, class), each firing bumps gateway_slo_alerts_total, and
     scrape timestamps are monotone with a final post-run scrape.

Determinism (invariant 4) now also covers the plane: byte-stable
EventLog.dump(), bit-identical trace JSON, identical Prometheus text.

The scenario space is described once (``scenario``) and driven two ways:
via hypothesis when it is installed (requirements-dev.txt; CI pins
--hypothesis-seed and the deadline-free "ci" profile from conftest.py) and
via a seeded numpy fallback that always runs, so the invariants are
exercised even on a machine without the dev deps.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.clouds.profiles import get_profile
from repro_torch.serving.gateway import (AdmissionConfig, AutoscalerConfig,
                                   FailureSpec, Gateway, MigrationSpec,
                                   ReplanConfig, RoutingConfig, TrafficSpec)
from repro_torch.telemetry.analyze import request_breakdown, validate_trace
from repro_torch.telemetry.events import EventLog
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.slo import BurnRateConfig
from repro_torch.telemetry.trace import Tracer

from conftest import AnalyticBackend

try:
    from hypothesis import given, strategies as hyp_st
    HAS_HYPOTHESIS = True
except ImportError:              # degrade to the seeded fallback only
    HAS_HYPOTHESIS = False

CLOUDS = ("gcp", "ibm")
SLOS = ("latency", "standard", "batch")



# -- scenario space ----------------------------------------------------------

def scenario(pick_int, pick_choice, pick_float):
    """One random-but-valid fleet + traffic + failure description as plain
    data, parameterized over the drawing primitives so hypothesis and the
    numpy fallback explore the same space."""
    models, traffic = [], []
    for i in range(pick_int(1, 3)):
        m = {"name": f"m{i}", "cloud": pick_choice(CLOUDS),
             "standby": pick_choice((True, False)),
             "split": pick_choice((None, 0.25, 0.5)),  # active-active share
             "min": pick_int(0, 1), "max": pick_int(1, 3),
             "tq": pick_choice((2, 8)),
             "idle": pick_choice((0.5, None)),    # None => never idles out
             "max_batch": pick_choice((2, 8)),
             "base_ms": pick_float(1.0, 20.0),
             "per_ms": pick_float(0.5, 2.0)}
        models.append(m)
        for _ in range(pick_int(1, 2)):
            traffic.append({"model": m["name"], "n": pick_int(3, 30),
                            "slo": pick_choice(SLOS),
                            "arrival": pick_choice(("burst", "poisson")),
                            "rate": pick_float(20.0, 500.0),
                            "start": pick_float(0.0, 1.5)})
    failure = None
    if pick_choice((True, False)):
        failure = {"cloud": pick_choice(CLOUDS),
                   "at": pick_float(0.05, 1.5),
                   "dur": pick_float(0.2, 1.0)}
    migration = None
    if pick_choice((True, False)):       # mid-run live re-split of one model
        migration = {"model": pick_int(0, len(models) - 1),
                     "at": pick_float(0.05, 1.5),
                     "frac": pick_float(0.0, 1.0)}
    capacity = {"gcp": 4, "ibm": 4} if pick_choice((True, False)) else None
    return {"models": models, "traffic": traffic, "failure": failure,
            "migration": migration,
            "replan": pick_choice((True, False)),
            "routing": pick_choice(("queue_aware", "weights")),
            "admission": pick_choice((None, 1.0, 1.5)),   # shed margin
            "slo_burn": pick_choice((None, 2.0, 6.0)),    # burn threshold
            "scrape": pick_choice((None, 0.25)),          # scrape period
            "capacity": capacity, "seed": pick_int(0, 2 ** 16)}


def build(p):
    gw = Gateway(capacity=p["capacity"], log=EventLog(), record_batches=True,
                 replan=(ReplanConfig(check_every_s=0.2, sustain=2)
                         if p["replan"] else None),
                 routing=RoutingConfig(policy=p["routing"]),
                 admission=(AdmissionConfig(margin=p["admission"])
                            if p["admission"] else None),
                 # the full observability plane rides every scenario: the
                 # invariants below reconcile it against the simulation
                 tracer=Tracer(), metrics=MetricsRegistry(),
                 slo_burn=(BurnRateConfig(threshold=p["slo_burn"])
                           if p["slo_burn"] else None),
                 scrape_every_s=p["scrape"])
    for m in p["models"]:
        other = CLOUDS[1 - CLOUDS.index(m["cloud"])]
        backend = AnalyticBackend(m["name"], m["base_ms"] / 1e3,
                                  m["per_ms"] / 1e3)
        kw = dict(
            autoscaler=AutoscalerConfig(
                min_replicas=m["min"],
                max_replicas=max(m["max"], m["min"]),
                target_queue=m["tq"],
                idle_window_s=math.inf if m["idle"] is None else m["idle"]),
            max_batch=m["max_batch"])
        if m["split"] is not None:       # active-active over both clouds
            gw.deploy(m["name"], backend,
                      split={get_profile(m["cloud"]): 1.0 - m["split"],
                             get_profile(other): m["split"]}, **kw)
        else:
            gw.deploy(m["name"], backend, get_profile(m["cloud"]),
                      standby=get_profile(other) if m["standby"] else None,
                      **kw)
    traffic = [TrafficSpec(t["model"], t["n"], arrival=t["arrival"],
                           rate=t["rate"], start_s=t["start"], slo=t["slo"])
               for t in p["traffic"]]
    failures = ([FailureSpec(p["failure"]["cloud"], p["failure"]["at"],
                             p["failure"]["dur"])]
                if p["failure"] else [])
    migrations = []
    if p["migration"]:
        mi = p["migration"]
        f = mi["frac"]
        migrations.append(MigrationSpec(mi["at"], {
            p["models"][mi["model"]]["name"]:
                {"gcp": f, "ibm": 1.0 - f}}))
    return gw, traffic, failures, migrations


# -- the invariants ----------------------------------------------------------

def run_and_check(p):
    gw, traffic, failures, migrations = build(p)
    out = gw.run(traffic, seed=p["seed"], failures=failures,
                 migrations=migrations)

    want = {}
    for t in p["traffic"]:
        want[t["model"]] = want.get(t["model"], 0) + t["n"]

    # 1. + 6. every request completes exactly once OR is shed exactly once
    #    (matching gateway:shed event); served + shed == offered; batch
    #    never shed; shed excluded from percentiles but reported
    for m, n in want.items():
        res = out.per_model[m]
        assert res.n_requests == n
        shed_idx = sorted(e["idx"] for e in gw.log.named("gateway:shed")
                          if e["model"] == m)
        assert len(shed_idx) == len(set(shed_idx)), "shed more than once"
        if p["admission"] is None:
            assert shed_idx == [] and res.shed_total == 0
        assert res.shed_total == len(shed_idx)
        assert sum(res.class_shed.values()) == len(shed_idx)
        assert res.class_shed.get("batch", 0) == 0, "batch must defer"
        by_cls = {}
        for e in gw.log.named("gateway:shed"):
            if e["model"] == m:
                by_cls[e["cls"]] = by_cls.get(e["cls"], 0) + 1
        assert by_cls == res.class_shed
        assert len(res.latencies_s) == n - len(shed_idx)
        assert all(l > 0 for l in res.latencies_s)
        assert sum(res.per_version.values()) == n - len(shed_idx)
        served = sorted(i for rec in gw.batch_log
                        if rec["model"] == m and not rec["preempted"]
                        for i in rec["idx"])
        assert sorted(served + shed_idx) == list(range(n)), \
            f"{m}: served {served} shed {shed_idx}"
        pc = res.per_class()
        assert sum(st["shed"] for st in pc.values()) == len(shed_idx)
        assert sum(st["n"] for st in pc.values()) == n - len(shed_idx)

    # 2. monotonic per-replica time: completed and preempted batches on one
    #    replica never overlap
    by_replica = {}
    for rec in gw.batch_log:
        by_replica.setdefault((rec["model"], rec["rid"]), []).append(rec)
    for key, recs in by_replica.items():
        recs.sort(key=lambda r: r["start_s"])
        for a, b in zip(recs, recs[1:]):
            assert a["end_s"] >= a["start_s"] - 1e-9, (key, a)
            assert b["start_s"] >= a["end_s"] - 1e-9, (key, a, b)

    # 3. capacity caps hold except the documented scale-from-zero breach
    if p["capacity"]:
        breached = {e["cloud"]
                    for e in gw.log.named("gateway:capacity_exceeded")}
        for t, cloud, usage in gw.usage_trace:
            cap = p["capacity"].get(cloud)
            if cap is not None and cloud not in breached:
                assert usage <= cap, (t, cloud, usage, cap)

    # 4. makespan covers every completion
    assert out.makespan_s >= max(
        r.total_time_s for r in out.per_model.values()) - 1e-9

    # 5. split weights normalize to 1 (0 only while every cloud is down)
    for e in gw.log.named("gateway:split"):
        tot = sum(e["weights"].values())
        assert abs(tot - 1.0) < 1e-4 or tot == 0.0, e
    for m, w in gw.final_weights.items():
        tot = sum(w.values())
        assert abs(tot - 1.0) < 1e-4, (m, w)   # outages all end in-scenario

    # simulated dollars exist and add up for every deployed model
    assert set(gw.final_weights) == set(out.costs)
    assert all(c >= 0.0 for c in out.costs.values())
    assert abs(out.total_cost_usd - sum(out.costs.values())) < 1e-12

    # 7. the trace is well-formed and complete: unique ids,
    #    acyclic parent edges, every child interval nested in its parent,
    #    no open spans; ONE gateway.run root; exactly one gateway.request
    #    span per offered request, each ending served xor shed; a served
    #    request's latency decomposes exactly into its child spans
    tr, reg = gw.tracer, gw.metrics
    violations = validate_trace(tr)
    assert violations == [], violations
    assert len(tr.named("gateway.run")) == 1
    req_spans: dict = {}
    for sp in tr.named("gateway.request"):
        req_spans.setdefault(sp.attrs["model"], []).append(sp)
    rows = {(r["model"], r["idx"]): r for r in request_breakdown(tr)}
    for m, n in want.items():
        res = out.per_model[m]
        spans = req_spans.get(m, [])
        assert len(spans) == n
        outcomes = [sp.attrs["outcome"] for sp in spans]
        assert all(o in ("served", "shed") for o in outcomes)
        assert sum(o == "shed" for o in outcomes) == res.shed_total
        for sp in spans:
            if sp.attrs["outcome"] != "served":
                continue
            row = rows[(m, sp.attrs["idx"])]
            parts = (row["queue_s"] + row["preempted_s"] + row["rtt_lb_s"]
                     + row["cold_s"] + row["service_s"])
            assert abs(parts - row["total_s"]) < 1e-6 + 1e-6 * row["total_s"], row

        # 8. the metric plane reconciles EXACTLY with the event log and the
        #    result: served + shed counters == offered, per-class histogram
        #    counts == served samples, and every sketch quantile is within
        #    its 1/sub relative-error bound of the exact rank statistic
        n_shed = res.shed_total
        assert reg.total("gateway_requests_total", model=m,
                         outcome="served") == n - n_shed
        assert reg.total("gateway_requests_total", model=m,
                         outcome="shed") == n_shed
        for cname, ls in res.class_latencies.items():
            snap = reg.value("gateway_request_latency_seconds",
                             model=m, cls=cname)
            if not ls:
                assert snap is None or snap["n"] == 0
                continue
            assert snap["n"] == len(ls)
            assert abs(snap["sum"] - sum(ls)) <= 1e-9 * max(sum(ls), 1.0)
            xs = sorted(ls)
            for q, got in ((0.5, snap["p50"]), (0.99, snap["p99"])):
                exact = xs[max(math.ceil(q * len(xs)), 1) - 1]
                assert abs(got - exact) <= exact / reg.sub + 1e-12, \
                    (m, cname, q, got, exact)

    # 9. burn-rate alerts are edge-consistent: firing/resolved strictly
    #    alternate per (model, cls), every firing edge bumped the alert
    #    counter, and without a monitor there are no alert events
    edges: dict = {}
    for e in gw.log.named("gateway:alert"):
        edges.setdefault((e["model"], e["cls"]), []).append(e["state"])
    if p["slo_burn"] is None:
        assert edges == {}
    for (m, cname), states in edges.items():
        assert all(s == ("firing" if i % 2 == 0 else "resolved")
                   for i, s in enumerate(states)), states
        assert reg.total("gateway_slo_alerts_total", model=m, cls=cname) \
            == sum(s == "firing" for s in states)
    if p["scrape"]:
        ts = [s["t_sim"] for s in reg.scrapes]
        assert ts == sorted(ts) and len(ts) >= 1
        assert reg.scrapes[-1]["t_sim"] >= out.makespan_s - 1e-9
    return out


def run_twice_and_compare(p):
    """Invariant 4: seed => bit-for-bit determinism on a rebuilt gateway."""
    gw1, tr1, f1, m1 = build(p)
    out1 = gw1.run(tr1, seed=p["seed"], failures=f1, migrations=m1)
    gw2, tr2, f2, m2 = build(p)
    out2 = gw2.run(tr2, seed=p["seed"], failures=f2, migrations=m2)
    assert out1.summary() == out2.summary()
    assert gw1.final_weights == gw2.final_weights
    assert ([e["name"] for e in gw1.log.events]
            == [e["name"] for e in gw2.log.events])
    # the whole observability plane is seed-deterministic too --
    # byte-stable event dump (wall fields stripped), bit-identical span
    # tree, identical Prometheus exposition
    assert gw1.log.dump() == gw2.log.dump()
    assert gw1.tracer.to_json() == gw2.tracer.to_json()
    assert gw1.metrics.to_prometheus() == gw2.metrics.to_prometheus()


# -- hypothesis search (requirements-dev.txt) --------------------------------

if HAS_HYPOTHESIS:
    @hyp_st.composite
    def scenarios(draw):
        return scenario(
            lambda lo, hi: draw(hyp_st.integers(lo, hi)),
            lambda seq: draw(hyp_st.sampled_from(list(seq))),
            lambda lo, hi: draw(hyp_st.floats(lo, hi, allow_nan=False,
                                              allow_infinity=False)))

    @given(scenarios())
    def test_fleet_invariants(params):
        run_and_check(params)

    @given(scenarios())
    def test_seed_makes_run_deterministic(params):
        run_twice_and_compare(params)
else:                            # visible skips instead of silent absence
    @pytest.mark.skip(reason="hypothesis not installed "
                             "(pip install -r requirements-dev.txt)")
    def test_fleet_invariants():
        pass

    @pytest.mark.skip(reason="hypothesis not installed "
                             "(pip install -r requirements-dev.txt)")
    def test_seed_makes_run_deterministic():
        pass


# -- seeded numpy fallback (always runs) -------------------------------------

def params_from_seed(seed):
    rng = np.random.default_rng(seed)
    return scenario(lambda lo, hi: int(rng.integers(lo, hi + 1)),
                    lambda seq: seq[int(rng.integers(len(seq)))],
                    lambda lo, hi: float(rng.uniform(lo, hi)))


@pytest.mark.parametrize("seed", range(30))
def test_fleet_invariants_seeded(seed):
    run_and_check(params_from_seed(seed))


@pytest.mark.parametrize("seed", range(8))
def test_seed_makes_run_deterministic_seeded(seed):
    run_twice_and_compare(params_from_seed(seed + 1000))
