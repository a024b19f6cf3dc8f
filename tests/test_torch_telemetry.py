"""Twin of tests/test_telemetry.py on the port's copies of the
observability plane: telemetry/trace.py (span tree), telemetry/metrics.py
(registry + quantile sketch), telemetry/slo.py (burn-rate monitor),
telemetry/analyze.py (well-formedness oracle + critical paths),
telemetry/events.py (deterministic event log), and placement.replan's
alert headroom.  The end-to-end reconciliation against a live port gateway
run is in tests/test_torch_gateway_invariants.py."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.clouds.profiles import get_profile
from repro_torch.serving.gateway import CloudCapacity
from repro_torch.serving.gateway.placement import (ModelDemand, plan_placement,
                                             replan)
from repro_torch.telemetry.analyze import (export, request_breakdown, request_table,
                                     run_breakdown, run_critical_path,
                                     run_table, slowest_requests,
                                     validate_trace)
from repro_torch.telemetry.events import EventLog
from repro_torch.telemetry.metrics import (Counter, Gauge, MetricsRegistry,
                                     QuantileSketch)
from repro_torch.telemetry.slo import BurnRateConfig, BurnRateMonitor
from repro_torch.telemetry.trace import Tracer

try:
    from hypothesis import given, strategies as hyp_st
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False


# -- QuantileSketch ----------------------------------------------------------

def exact_rank(xs_sorted, q):
    """The rank statistic the sketch approximates: the smallest sample
    whose cumulative count reaches q * n."""
    k = max(int(math.ceil(q * len(xs_sorted))), 1)
    return xs_sorted[k - 1]


def check_sketch_bound(values, sub):
    sk = QuantileSketch(sub=sub)
    for v in values:
        sk.observe(v)
    xs = sorted(values)
    assert sk.n == len(values)
    assert sk.quantile(0.0) == min(values)
    assert sk.quantile(1.0) == max(values)
    for q in (0.25, 0.5, 0.9, 0.99):
        got, want = sk.quantile(q), exact_rank(xs, q)
        assert abs(got - want) <= want / sub + 1e-12, (q, got, want)


@pytest.mark.parametrize("sub", [8, 32, 128])
@pytest.mark.parametrize("seed", range(4))
def test_sketch_relative_error_bound(sub, seed):
    rng = np.random.default_rng(seed)
    values = rng.lognormal(mean=-3.0, sigma=1.5, size=500).tolist()
    check_sketch_bound(values, sub)


def test_sketch_empty_and_edge_cases():
    sk = QuantileSketch()
    assert sk.quantile(0.5) is None and sk.mean is None
    assert sk.snapshot() == {"n": 0, "sum": 0.0, "p50": None, "p99": None}
    with pytest.raises(ValueError):
        QuantileSketch(sub=0)
    sk.observe(0.0)                      # underflow bucket: exact
    sk.observe(-2.0)
    assert sk.quantile(0.5) == -2.0 and sk.vmin == -2.0 and sk.vmax == 0.0


def test_sketch_single_value_is_exact():
    sk = QuantileSketch()
    sk.observe(0.125)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert sk.quantile(q) == 0.125


def test_sketch_merge_equals_union():
    rng = np.random.default_rng(7)
    a, b = rng.exponential(0.05, 200), rng.exponential(0.5, 300)
    ska, skb, sku = QuantileSketch(), QuantileSketch(), QuantileSketch()
    for v in a:
        ska.observe(v)
        sku.observe(v)
    for v in b:
        skb.observe(v)
        sku.observe(v)
    ska.merge(skb)
    assert ska.counts == sku.counts
    assert ska.n == sku.n and ska.vmin == sku.vmin and ska.vmax == sku.vmax
    assert ska.quantile(0.99) == sku.quantile(0.99)
    with pytest.raises(ValueError):
        ska.merge(QuantileSketch(sub=8))


if HAS_HYPOTHESIS:
    @given(hyp_st.lists(hyp_st.floats(1e-9, 1e9, allow_nan=False,
                                      allow_infinity=False),
                        min_size=1, max_size=200))
    def test_sketch_bound_property(values):
        check_sketch_bound(values, 32)
else:
    @pytest.mark.skip(reason="hypothesis not installed "
                             "(pip install -r requirements-dev.txt)")
    def test_sketch_bound_property():
        pass


# -- MetricsRegistry ---------------------------------------------------------

def test_counter_and_gauge_contracts():
    c = Counter()
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1.0)
    g = Gauge()
    g.set(4)
    assert g.snapshot() == 4.0


def test_registry_get_or_create_and_kind_guard():
    reg = MetricsRegistry()
    c1 = reg.counter("gateway_requests_total", model="m", outcome="served")
    c2 = reg.counter("gateway_requests_total", outcome="served", model="m")
    assert c1 is c2                      # label order does not matter
    with pytest.raises(ValueError):
        reg.gauge("gateway_requests_total", model="m")
    assert reg.value("nope") is None


def test_registry_total_matches_label_superset():
    reg = MetricsRegistry()
    reg.counter("req_total", model="a", outcome="served").inc(3)
    reg.counter("req_total", model="a", outcome="shed").inc(1)
    reg.counter("req_total", model="b", outcome="served").inc(5)
    assert reg.total("req_total") == 9
    assert reg.total("req_total", model="a") == 4
    assert reg.total("req_total", outcome="served") == 8
    assert reg.total("req_total", model="a", outcome="shed") == 1
    assert reg.total("req_total", model="c") == 0


def test_registry_scrape_series_and_export(tmp_path):
    reg, log = MetricsRegistry(), EventLog()
    reg.counter("hits_total", model="m").inc()
    reg.gauge("queue_depth", model="m").set(7)
    h = reg.histogram("lat_seconds", model="m")
    for v in (0.01, 0.02, 0.04):
        h.observe(v)
    reg.scrape(0.5, log)
    reg.counter("hits_total", model="m").inc()
    reg.scrape(1.5, log)
    assert [s["t_sim"] for s in reg.scrapes] == [0.5, 1.5]
    assert reg.series("hits_total", model="m") == [(0.5, 1.0), (1.5, 2.0)]
    assert log.count("metrics:scrape") == 2
    text = reg.to_prometheus()
    assert "# TYPE hits_total counter" in text
    assert "# TYPE lat_seconds summary" in text
    assert 'lat_seconds_count{model="m"} 3' in text
    assert 'quantile="0.99"' in text
    blob = json.loads(reg.to_json(str(tmp_path / "metrics.json")))
    assert blob["current"]['queue_depth{model="m"}'] == 7.0
    assert len(blob["scrapes"]) == 2


def test_prometheus_exposition_escapes_hostile_labels():
    """Exposition-format hardening: a model named
    with quotes, backslashes or newlines must produce a parseable text
    page -- label values escape backslash FIRST, then quote and newline,
    and HELP text escapes backslash and newline only."""
    reg = MetricsRegistry()
    hostile = 'mo"del\\with\nnewline'
    reg.counter("gateway_requests_total", model=hostile).inc(2)
    reg.describe("gateway_requests_total", 'requests "per" \\ model\nline2')
    text = reg.to_prometheus()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("gateway_requests_total{"))
    # the raw newline never leaks into the page: one series, one line
    assert line.endswith(" 2")
    assert r'model="mo\"del\\with\nnewline"' in line
    help_line = next(ln for ln in text.splitlines()
                     if ln.startswith("# HELP gateway_requests_total"))
    assert help_line == r'# HELP gateway_requests_total requests "per" \\ ' \
                        "model\\nline2"
    assert "# TYPE gateway_requests_total counter" in text


def test_prometheus_exposition_help_type_per_family():
    """Every family gets exactly one HELP/TYPE pair, before its samples;
    histograms expose as summaries; undescribed families fall back to a
    kind-derived HELP."""
    reg = MetricsRegistry()
    reg.counter("a_total", model="x").inc()
    reg.counter("a_total", model="y").inc()
    reg.gauge("b_depth").set(3)
    reg.histogram("c_seconds").observe(0.5)
    text = reg.to_prometheus()
    lines = text.splitlines()
    assert sum(ln.startswith("# HELP a_total") for ln in lines) == 1
    assert sum(ln.startswith("# TYPE a_total") for ln in lines) == 1
    assert "# TYPE b_depth gauge" in lines
    assert "# TYPE c_seconds summary" in lines
    assert "# HELP b_depth gauge family b_depth" in lines
    # HELP/TYPE precede the family's first sample line
    assert lines.index("# TYPE a_total counter") \
        < lines.index('a_total{model="x"} 1')


# -- EventLog determinism ----------------------------------------------------

def test_eventlog_seq_and_index():
    log = EventLog()
    for i in range(5):
        log.record("a" if i % 2 else "b", 0.1, i=i)
    assert [e["seq"] for e in log.events] == list(range(5))
    assert [e["i"] for e in log.named("a")] == [1, 3]
    assert log.count("b") == 3 and log.count("zzz") == 0
    assert log.named("a")[0] is log.events[1]   # index shares the dicts


def test_eventlog_dump_is_byte_stable_without_wall(tmp_path):
    def run():
        log = EventLog()
        log.record("gateway:run", 2.5, models=["m"], wall_s=np.random.rand())
        with log.stage("serve:kserve", n=3):
            sum(range(1000))             # arbitrary wall-clock work
        log.record("pipeline:step", 0.25, step="train")
        return log

    a, b = run(), run()
    assert a.dump() == b.dump()          # wall fields stripped by default
    assert a.dump(include_wall=True) != b.dump(include_wall=True)
    d = json.loads(a.dump())
    assert "wall_s" not in d[0]
    assert d[0]["duration_s"] == 2.5     # simulated durations survive
    assert "duration_s" not in d[1]      # stage events are wall=True
    assert d[1]["wall"] is True
    p = tmp_path / "events.json"
    a.dump(str(p))
    assert p.read_text() == b.dump()


# -- Tracer + validate_trace -------------------------------------------------

def make_request_trace():
    """A tiny gateway-shaped forest: run > request > queue + serve, plus a
    foreign deploy span the request links to."""
    tr = Tracer()
    deploy = tr.start("pipeline.step", 0.0, step="deploy")
    tr.end(deploy, 1.0)
    run = tr.start("gateway.run", 0.0, seed=0)
    req = tr.start("gateway.request", 0.1, parent=run,
                   links=(deploy.span_id, None), model="m", idx=0,
                   cls="standard")
    q = tr.start("gateway.queue", 0.1, parent=req, cloud="gcp")
    tr.end(q, 0.3)
    srv = tr.start("gateway.serve", 0.3, parent=req, cloud="gcp",
                   rtt_lb_s=0.05, cold_s=0.0, service_s=0.15)
    tr.end(srv, 0.5)
    tr.end(req, 0.5, outcome="served", latency_s=0.4)
    tr.end(run, 1.0, models=["m"])
    return tr, deploy, run, req


def test_tracer_ids_links_and_reachability():
    tr, deploy, run, req = make_request_trace()
    assert [s.span_id for s in tr.spans] == list(range(5))
    assert tr.get(req.span_id) is req
    assert req.trace_id == run.span_id and req.links == (deploy.span_id,)
    assert {s.span_id for s in tr.roots()} == {deploy.span_id, run.span_id}
    kids = tr.children_index()[req.span_id]
    assert [k.name for k in kids] == ["gateway.queue", "gateway.serve"]
    # the cross-trace walk: pipeline deploy -> linking request -> children
    reach = tr.reachable(deploy.span_id)
    assert req.span_id in reach and kids[0].span_id in reach
    assert run.span_id not in reach      # links are directed


def test_tracer_json_export_records_event(tmp_path):
    tr, *_ = make_request_trace()
    log = EventLog()
    p = tmp_path / "trace.json"
    blob = json.loads(tr.to_json(str(p), log=log))
    assert len(blob) == 5 and blob[2]["name"] == "gateway.request"
    assert json.loads(p.read_text()) == blob
    assert log.named("trace:export")[0]["spans"] == 5


def test_tracer_from_json_round_trip_offline_analysis(tmp_path):
    """Offline re-analysis: a Tracer rebuilt from a
    ``to_json`` export must drive the analyzers to the exact same tables
    as the live tracer, survive a second export byte-identically, and
    reject blobs whose span ids are not the list indices."""
    tr, *_ = make_request_trace()
    blob = tr.to_json()
    back = Tracer.from_json(blob)
    assert len(back.spans) == len(tr.spans)
    assert back.to_json() == blob                        # lossless
    assert request_table(back, 3) == request_table(tr, 3)
    assert validate_trace(back) == []
    # new spans keep allocating past the imported ids (the get() contract)
    s = back.start("gateway.request", 9.0)
    assert s.span_id == len(tr.spans)
    # load() is from_json over a file written by to_json(path)
    p = tmp_path / "trace.json"
    tr.to_json(str(p))
    assert Tracer.load(str(p)).to_json() == blob
    # a reordered/id-gapped export is rejected, not silently re-keyed
    rows = json.loads(blob)
    rows[0], rows[1] = rows[1], rows[0]
    with pytest.raises(ValueError):
        Tracer.from_json(json.dumps(rows))


def test_tracer_from_json_run_tables_match(tmp_path):
    tr, run, _ = make_run_trace()
    back = Tracer.from_json(tr.to_json())
    assert run_table(back, run.span_id) == run_table(tr, run.span_id)
    assert [s.attrs["step"]
            for s in run_critical_path(back, run.span_id)] \
        == [s.attrs["step"] for s in run_critical_path(tr, run.span_id)]


def test_validate_trace_catches_malformed_spans():
    tr, deploy, run, req = make_request_trace()
    assert validate_trace(tr) == []
    open_span = tr.start("gateway.queue", 0.2, parent=req)
    assert any("open span" in v for v in validate_trace(tr))
    tr.end(open_span, 0.1)               # negative interval
    assert any("negative interval" in v for v in validate_trace(tr))
    tr.end(open_span, 9.0)               # escapes parent [0.1, 0.5]
    assert any("escapes" in v for v in validate_trace(tr))
    tr.end(open_span, 0.4)
    assert validate_trace(tr) == []
    open_span.parent_id = 99             # dangling
    assert any("dangling" in v for v in validate_trace(tr))
    open_span.parent_id = req.span_id
    open_span.trace_id = deploy.span_id  # wrong tree
    assert any("mismatch" in v for v in validate_trace(tr))
    open_span.trace_id = run.span_id
    run.trace_id = 42                    # root must own its trace id
    assert any("root" in v for v in validate_trace(tr))


# -- analyzer ----------------------------------------------------------------

def test_request_breakdown_attribution():
    tr, deploy, run, req = make_request_trace()
    # a second, slower request with a preempted first serve attempt
    r2 = tr.start("gateway.request", 0.2, parent=run, model="m", idx=1,
                  cls="latency")
    q1 = tr.start("gateway.queue", 0.2, parent=r2)
    tr.end(q1, 0.4)
    bad = tr.start("gateway.serve", 0.4, parent=r2, cloud="gcp")
    tr.end(bad, 0.6, preempted=True)
    q2 = tr.start("gateway.queue", 0.6, parent=r2, requeued=True)
    tr.end(q2, 0.7)
    srv = tr.start("gateway.serve", 0.7, parent=r2, cloud="ibm",
                   rtt_lb_s=0.1, cold_s=0.05, service_s=0.05)
    tr.end(srv, 0.9)
    tr.end(r2, 0.9, outcome="served", latency_s=0.7)
    shed = tr.start("gateway.request", 0.3, parent=run, model="m", idx=2,
                    cls="standard")
    tr.end(shed, 0.35, outcome="shed", at="enqueue")

    rows = request_breakdown(tr)
    assert len(rows) == 2                # shed requests are excluded
    r = {row["idx"]: row for row in rows}[1]
    assert r["queue_s"] == pytest.approx(0.3)
    assert r["preempted_s"] == pytest.approx(0.2)
    assert r["cold_s"] == pytest.approx(0.05)
    assert r["cloud"] == "ibm"
    assert r["total_s"] == pytest.approx(
        r["queue_s"] + r["preempted_s"] + r["rtt_lb_s"] + r["cold_s"]
        + r["service_s"])
    assert slowest_requests(tr, 1)[0]["idx"] == 1
    table = request_table(tr, k=2)
    assert "slowest requests" in table and "ibm" in table


def make_run_trace():
    """A pipeline-shaped tree: prep -> {a, b} -> join, where b finishes
    last (the critical path is prep -> b -> join)."""
    tr = Tracer()
    run = tr.start("pipeline.run", 0.0, run_id="r-000", pipeline="p")
    spans = {}
    plan = [("prep", (), 0.0, 1.0, 0.2), ("a", ("prep",), 1.0, 2.0, 0.3),
            ("b", ("prep",), 1.0, 4.0, 0.5),
            ("join", ("a", "b"), 4.0, 5.0, 0.1)]
    for name, deps, t0, t1, compute in plan:
        s = tr.start("pipeline.step", t0, parent=run, step=name,
                     deps=list(deps), cloud="gcp")
        att = tr.start("pipeline.attempt", t0, parent=s, cloud="gcp",
                       control_s=0.1, transfer_s=0.05, compute_s=compute)
        tr.end(att, t1)
        tr.end(s, t1, status="done")
        spans[name] = s
    tr.end(run, 5.0, status="succeeded")
    return tr, run, spans


def test_run_critical_path_and_breakdown():
    tr, run, spans = make_run_trace()
    assert validate_trace(tr) == []
    path = [s.attrs["step"] for s in run_critical_path(tr, run.span_id)]
    assert path == ["prep", "b", "join"]
    rows = run_breakdown(tr, run.span_id)
    b = {r["step"]: r for r in rows}["b"]
    assert b["attempts"] == 1 and b["total_s"] == pytest.approx(3.0)
    assert b["wait_s"] == pytest.approx(3.0 - 0.1 - 0.05 - 0.5)
    table = run_table(tr, run.span_id)
    assert "critical path" in table and "join" in table
    assert run_critical_path(tr, spans["prep"].span_id) == []


def test_export_writes_both_wire_formats(tmp_path):
    tr, run, _ = make_run_trace()
    reg = MetricsRegistry()
    reg.counter("pipeline_runs_total", pipeline="p").inc()
    log = EventLog()
    tpath, ppath = tmp_path / "trace.json", tmp_path / "metrics.prom"
    export(tr, reg, trace_path=str(tpath), prom_path=str(ppath), log=log)
    assert len(json.loads(tpath.read_text())) == len(tr.spans)
    assert "pipeline_runs_total" in ppath.read_text()
    assert log.count("trace:export") == 1


# -- burn-rate monitor -------------------------------------------------------

def test_burn_config_validation():
    for bad in (dict(objective=0.0), dict(objective=1.0),
                dict(short_s=2.0, long_s=1.0), dict(threshold=0.0),
                dict(min_n=0)):
        with pytest.raises(ValueError):
            BurnRateConfig(**bad)


def test_burn_monitor_fires_and_resolves():
    log, reg = EventLog(), MetricsRegistry()
    cfg = BurnRateConfig(objective=0.9, short_s=0.5, long_s=2.5,
                         threshold=2.0, min_n=8)
    mon = BurnRateMonitor(cfg, log=log, metrics=reg)
    # 7 breaches: below min_n per window, must NOT fire
    for k in range(7):
        mon.observe(0.01 * k, "m", "standard", good=False)
    assert not mon.is_burning("m") and mon.alerts == []
    # the 8th breach tips both windows past threshold (burn = 10 >= 2)
    mon.observe(0.08, "m", "standard", good=False)
    assert mon.is_burning("m") and mon.alerting_models() == {"m"}
    assert len(mon.alerts) == 1
    fire = log.named("gateway:alert")[0]
    assert fire["state"] == "firing" and fire["burn_short"] >= 2.0
    assert reg.total("gateway_slo_alerts_total", model="m") == 1
    assert mon.pressure("m", 16) == 16 and mon.pressure("other", 16) == 0
    # a good-only stream past the short window resolves the alert even
    # though the long window still remembers the breaches
    for k in range(20):
        mon.observe(1.0 + 0.01 * k, "m", "standard", good=True)
    assert not mon.is_burning("m")
    states = [e["state"] for e in log.named("gateway:alert")]
    assert states == ["firing", "resolved"]
    assert len(mon.alerts) == 1          # alert history survives resolution
    mon.reset()
    assert mon.alerts and not mon.active


def test_burn_monitor_ages_out_on_the_clock():
    """An alert must resolve by TIME alone: after the last observation of
    a run there is no further observe() call, so a firing alert would
    otherwise pin pressure() forever and the gateway's scale-up /
    idle-retire cycle never terminates (the seed-517 livelock)."""
    log = EventLog()
    cfg = BurnRateConfig(objective=0.9, short_s=0.5, long_s=2.5,
                         threshold=2.0, min_n=8)
    mon = BurnRateMonitor(cfg, log=log)
    for k in range(8):
        mon.observe(0.01 * k, "m", "latency", good=False)
    assert mon.is_burning("m") and mon.pressure("m", 16) == 16
    mon.age(0.2)                        # within the short window: still firing
    assert mon.is_burning("m")
    mon.age(5.0)                        # both windows empty: must resolve
    assert not mon.is_burning("m") and mon.pressure("m", 16) == 0
    assert [e["state"] for e in log.named("gateway:alert")] \
        == ["firing", "resolved"]
    mon.age(6.0)                        # idempotent on empty windows
    assert not mon.active


def test_burn_monitor_needs_sustained_breach():
    """A single bad observation among good ones never pages (the long
    window gates on significance)."""
    mon = BurnRateMonitor(BurnRateConfig(objective=0.9, min_n=4))
    for k in range(40):
        mon.observe(0.05 * k, "m", "latency", good=(k != 20))
    assert not mon.is_burning("m") and mon.alerts == []


# -- placement.replan with alert headroom ------------------------------------

class _Obs:
    def __init__(self, rate):
        self.observed = {"rate_rps": rate, "service_time_s": 0.02, "shed": 0}


class _Result:
    def __init__(self, rate):
        self.per_model = {"m": _Obs(rate)}


def test_replan_alert_headroom_overprovisions():
    clouds = [CloudCapacity(get_profile("gcp"), 8, 1.0),
              CloudCapacity(get_profile("ibm"), 8, 1.4)]
    plan = plan_placement([ModelDemand("m", 40.0, 0.02)], clouds)
    res = _Result(40.0)                  # load 0.8 Erlang as observed
    base = replan(plan, res, clouds=clouds)
    hot = replan(plan, res, clouds=clouds, alerts={"m"}, alert_headroom=2.0)
    n_base = sum(base.assignments[0].shares.values())
    n_hot = sum(hot.assignments[0].shares.values())
    assert n_hot > n_base                # alerts inflate observed demand
    cold = replan(plan, res, clouds=clouds, alerts={"other"},
                  alert_headroom=2.0)
    assert sum(cold.assignments[0].shares.values()) == n_base
    with pytest.raises(ValueError):
        replan(plan, res, clouds=clouds, alerts={"m"}, alert_headroom=0.5)
