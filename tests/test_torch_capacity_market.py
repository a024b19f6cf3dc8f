"""Twin of tests/test_capacity_market.py on the port's copy of
``clouds/capacity.py``: the ledger's unit contract (refusal at the slot
ceiling, youngest-first preemption, audit-seq monotonicity, the budget
planner's reserve) and the gateway's side of spot semantics (a serving
burst on a cloud whose recorded timeline is full of training leases
preempts them, and is never denied); then the cases that drive training
through the port's pipeline ``Orchestrator`` and ``core.pipeline.Pipeline``:
the seeded (and, with hypothesis installed, property-based) colocated
training + serving scenarios, preemption at a recorded serving edge, the
speculative retry, the worker gauges and the dormant path."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.clouds.capacity import CapacityLedger, CapacityMarket  # noqa: E402
from repro_torch.clouds.profiles import get_profile  # noqa: E402
from repro_torch.core.pipeline import Pipeline  # noqa: E402
from repro_torch.pipelines import Orchestrator, RetryPolicy  # noqa: E402
from repro_torch.serving.gateway import (AutoscalerConfig, FailureSpec, Gateway,  # noqa: E402
                                         TrafficSpec)
from repro_torch.telemetry.events import EventLog  # noqa: E402
from repro_torch.telemetry.metrics import MetricsRegistry  # noqa: E402

from conftest import AnalyticBackend  # noqa: E402

try:
    from hypothesis import given, strategies as hyp_st
    HAS_HYPOTHESIS = True
except ImportError:              # degrade to the seeded fallback only
    HAS_HYPOTHESIS = False

CLOUDS = ("gcp", "ibm")


# -- ledger unit contract ----------------------------------------------------

def test_ledger_refuses_overcommit():
    led = CapacityLedger("gcp", 2)
    a = led.lease("training", "t0", 0.0)
    b = led.lease("serving", "s0", 0.0)
    assert a is not None and b is not None
    assert led.lease("training", "t1", 0.0) is None     # full at t=0
    assert led.free(0.0) == 0 and led.used(0.0) == 2
    led.release(a, 1.0)
    assert led.lease("training", "t1", 1.0) is not None  # freed slot reused
    assert led.max_overlap() == 2                        # never above slots


def test_ledger_preempts_youngest():
    led = CapacityLedger("gcp", 3)
    old = led.lease("training", "old", 0.0)
    mid = led.lease("training", "mid", 1.0)
    yng = led.lease("training", "yng", 2.0)
    victim = led.preempt_youngest(3.0)
    assert victim is yng and yng.status == "preempted" and yng.t1 == 3.0
    assert not yng.covers(3.0)                  # truncation is half-open
    victim = led.preempt_youngest(3.0)
    assert victim is mid                        # next-youngest by t0
    assert old.status == "active"
    assert led.preempt_youngest(3.0, kind="serving") is None


def test_ledger_audit_is_monotonic_and_complete():
    led = CapacityLedger("gcp", 2)
    a = led.lease("training", "a", 0.0)
    b = led.lease("serving", "b", 0.5)
    led.release(b, 1.0)
    led.release(a, 1.5, status="cancelled")
    c = led.lease("training", "c", 2.0)
    led.preempt_youngest(3.0)
    ops = [(op["op"], op["lease"]) for op in led.audit]
    assert ops == [("lease", a.lease_id), ("lease", b.lease_id),
                   ("release", b.lease_id), ("cancel", a.lease_id),
                   ("lease", c.lease_id), ("preempt", c.lease_id)]
    seqs = [op["seq"] for op in led.audit]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


def test_market_shares_one_audit_order():
    mkt = CapacityMarket({"gcp": 1, "ibm": 2})
    mkt.ledger("ibm").lease("serving", "s", 0.0)
    mkt.ledger("gcp").lease("training", "t", 0.0)
    mkt.ledger("ibm").lease("serving", "s2", 1.0)
    seqs = [op["seq"] for led in mkt.ledgers.values() for op in led.audit]
    assert sorted(seqs) == [0, 1, 2]     # one global counter, no collisions
    mkt.check_conservation()


def test_plan_budget_reserves_serving_headroom():
    mkt = CapacityMarket({"gcp": 4, "ibm": 2})
    plan = mkt.plan_budget({"gcp": 2.0}, work_s=12.0, target_util=0.7)
    assert plan["reserve"] == {"gcp": 3, "ibm": 0}      # ceil(2/0.7), capped
    assert plan["training_slots"] == {"gcp": 1, "ibm": 2}
    assert plan["est_makespan_s"] == pytest.approx(4.0)
    # training_free honors the installed reserve; unledgered clouds are open
    assert mkt.training_free("gcp", 0.0) == 1
    assert mkt.training_free("baremetal", 0.0) > 1000


def test_training_free_blocks_at_reserve():
    mkt = CapacityMarket({"gcp": 2})
    mkt.reserve = {"gcp": 2}
    assert mkt.training_free("gcp", 0.0) == 0
    assert mkt.ledger("gcp").lease("serving", "s", 0.0) is not None


# -- end-to-end scenario space -----------------------------------------------

def _pipeline(n_branches: int, tune_s: float, train_s: float):
    fns = {"prep": lambda: 1.0,
           "tune": lambda i, p: {"i": i, "loss": 1.0 / (1 + i)},
           "select": lambda *rs: min(rs, key=lambda r: r["loss"]),
           "train": lambda p, best: {"loss": best["loss"] / 2}}
    pipe = Pipeline("market-tune")
    prep = pipe.step(fns["prep"], name="prep", cache=False)
    branches = [pipe.step(fns["tune"], i, prep, name=f"tune{i}", cache=False)
                for i in range(n_branches)]
    best = pipe.step(fns["select"], *branches, name="select", cache=False)
    pipe.step(fns["train"], prep, best, name="train", cache=False)
    spec = pipe.compile()
    sims = {"prep": 0.2, "select": 0.05, "train": train_s,
            **{f"tune{i}": tune_s for i in range(n_branches)}}
    for s in spec.steps:
        s.sim_s = sims[s.name]
    return spec


def scenario(pick_int, pick_choice, pick_float):
    """One random-but-valid colocated training+serving description."""
    return {
        "slots": {c: pick_int(2, 4) for c in CLOUDS},
        "priority": pick_choice((True, True, False)),   # mostly spot mode
        "order": pick_choice(("train_first", "serve_first")),
        "workers": {c: pick_int(1, 3) for c in CLOUDS},
        "branches": pick_int(2, 6),
        "tune_s": pick_float(0.5, 2.0),
        "train_s": pick_float(0.5, 2.0),
        "retries": pick_int(2, 4),
        "outage": (pick_choice(CLOUDS), pick_float(0.5, 4.0),
                   pick_float(0.3, 1.5)) if pick_choice((True, False))
                  else None,
        "serve_cloud": pick_choice(CLOUDS),
        "min": pick_int(0, 1), "max": pick_int(2, 4),
        "n": pick_int(40, 300),
        "rate_x": pick_float(1.5, 4.0),   # x one replica's ceiling
        "base_ms": pick_float(1.0, 10.0),
        "seed": pick_int(0, 2 ** 16),
    }


def run_and_check(p):
    mkt = CapacityMarket(dict(p["slots"]), serving_priority=p["priority"])

    def run_training():
        log = EventLog()
        orch = Orchestrator(dict(p["workers"]), policy="makespan", log=log,
                            retry=RetryPolicy(max_retries=p["retries"],
                                              backoff_s=0.3),
                            shared_capacity=mkt)
        failures = ([FailureSpec(*p["outage"])] if p["outage"] else [])
        rec = orch.execute(_pipeline(p["branches"], p["tune_s"],
                                     p["train_s"]), failures=failures)
        return rec, log

    def run_serving():
        log = EventLog()
        gw = Gateway(log=log, shared_capacity=mkt)
        backend = AnalyticBackend("m", p["base_ms"] / 1e3, 1e-4)
        prof = get_profile(p["serve_cloud"])
        gw.deploy("m", backend,
                  autoscaler=AutoscalerConfig(min_replicas=p["min"],
                                              max_replicas=p["max"],
                                              target_queue=4,
                                              scale_up_delay_s=0.01,
                                              idle_window_s=math.inf),
                  profile=prof, max_batch=8)
        per_req = backend.service_time(1)
        out = gw.run([TrafficSpec("m", p["n"], arrival="poisson",
                                  rate=p["rate_x"] / per_req)],
                     seed=p["seed"])
        return out, log

    if p["order"] == "train_first":
        rec, tr_log = run_training()
        out, gw_log = run_serving()
    else:
        out, gw_log = run_serving()
        rec, tr_log = run_training()

    # 1. conservation: committed timeline never over-commits any cloud,
    #    audit seq strictly increasing per ledger
    mkt.check_conservation()
    for cloud, led in mkt.ledgers.items():
        assert led.max_overlap() <= led.slots, (cloud, led.audit)

    # 2. preempted training attempts complete-or-fail exactly once
    for name, r in rec.steps.items():
        oks = sum(1 for a in r.attempts if a["status"] == "ok")
        if r.status == "done" and not r.cached:
            assert oks == 1, (name, r.attempts)
        elif r.status in ("failed", "skipped"):
            assert oks == 0, (name, r.attempts)
        assert all(a["status"] in ("ok", "outage", "preempted", "cancelled")
                   for a in r.attempts), (name, r.attempts)

    # every serving request still completes exactly once (preemption is a
    # ledger-level fact; live replicas are never killed by the market)
    assert out.per_model["m"].n_requests == p["n"]
    assert len(out.per_model["m"].latencies_s) == p["n"]

    # 3. priority-on serving is never starved by training holders: any
    #    capacity denial happened with zero training leases covering it
    if p["priority"]:
        for e in gw_log.named("gateway:scale_denied"):
            if e.get("reason") != "capacity":
                continue
            led = mkt.ledger(e["cloud"])
            if led is not None:
                t = e["t_sim"]
                assert led.used(t, kind="training") == 0, (e, led.audit)
    else:
        # priority off: the market never preempts on the gateway's behalf
        assert gw_log.count("capacity:preempt") == 0

    # the audit trail accounts for every event the subsystems logged
    n_leases = sum(1 for led in mkt.ledgers.values()
                   for op in led.audit if op["op"] == "lease")
    assert n_leases == (tr_log.count("capacity:lease")
                        + gw_log.count("capacity:lease"))
    n_preempts = sum(1 for led in mkt.ledgers.values()
                     for op in led.audit if op["op"] == "preempt")
    assert n_preempts >= (tr_log.count("capacity:preempt")
                          + gw_log.count("capacity:preempt"))


# -- hypothesis runner (requirements-dev.txt) --------------------------------

if HAS_HYPOTHESIS:
    @hyp_st.composite
    def scenarios(draw):
        return scenario(
            lambda lo, hi: draw(hyp_st.integers(lo, hi)),
            lambda seq: draw(hyp_st.sampled_from(list(seq))),
            lambda lo, hi: draw(hyp_st.floats(lo, hi, allow_nan=False,
                                              allow_infinity=False)))

    @given(scenarios())
    def test_market_invariants(params):
        run_and_check(params)
else:                            # visible skip instead of silent absence
    @pytest.mark.skip(reason="hypothesis not installed "
                             "(pip install -r requirements-dev.txt)")
    def test_market_invariants():
        pass


# -- seeded numpy fallback (always runs) -------------------------------------

def params_from_seed(seed):
    rng = np.random.default_rng(seed)
    return scenario(lambda lo, hi: int(rng.integers(lo, hi + 1)),
                    lambda seq: seq[int(rng.integers(len(seq)))],
                    lambda lo, hi: float(rng.uniform(lo, hi)))


@pytest.mark.parametrize("seed", range(20))
def test_market_invariants_seeded(seed):
    run_and_check(params_from_seed(seed))


# -- directed end-to-end cases -----------------------------------------------

def test_gateway_preempts_recorded_training():
    """Spot semantics, serving side: a burst on a cloud whose recorded
    timeline is full of training leases must preempt (never be denied)."""
    mkt = CapacityMarket({"gcp": 2})
    led = mkt.ledger("gcp")
    for i in range(2):
        led.lease("training", f"t{i}", 0.0)
    log = EventLog()
    gw = Gateway(log=log, shared_capacity=mkt)
    gw.deploy("m", AnalyticBackend("m", 0.005), get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2,
                                          target_queue=2,
                                          scale_up_delay_s=0.01,
                                          idle_window_s=math.inf),
              max_batch=4)
    out = gw.run([TrafficSpec("m", 60, arrival="poisson", rate=800.0)],
                 seed=0)
    assert out.per_model["m"].n_requests == 60
    assert log.count("capacity:preempt") >= 1        # the floor alone evicts
    assert not [e for e in log.named("gateway:scale_denied")
                if e["reason"] == "capacity"]
    mkt.check_conservation()


def test_training_preempted_at_serving_edge_retries():
    """Spot semantics, training side: recorded serving rise-edges that
    over-commit the cloud kill the youngest running attempt, which
    re-enters RetryPolicy backoff and still completes exactly once."""
    mkt = CapacityMarket({"gcp": 2})
    led = mkt.ledger("gcp")
    s = led.lease("serving", "pool:m", 0.0)          # floor, covers the run
    led.lease("serving", "pool:m", 5.0)              # rise-edge at t=5
    led.release(s, 60.0)
    log = EventLog()
    orch = Orchestrator({"gcp": 2}, policy="makespan", log=log,
                        retry=RetryPolicy(max_retries=3, backoff_s=0.3),
                        shared_capacity=mkt)
    rec = orch.execute(_pipeline(2, 4.0, 1.0))
    assert rec.status == "succeeded"
    assert log.count("capacity:preempt") >= 1
    retries = [e for e in log.named("pipeline:retry")
               if e.get("reason") == "preempt"]
    assert retries, log.named("pipeline:retry")
    for name, r in rec.steps.items():
        assert sum(1 for a in r.attempts if a["status"] == "ok") == 1
    mkt.check_conservation()


def test_speculative_retry_cancels_loser():
    """An outage window dooming a running attempt launches a backup on a
    second cloud; the winner completes, the loser's lease is cancelled."""
    mkt = CapacityMarket({"gcp": 2, "ibm": 2})
    log = EventLog()
    orch = Orchestrator({"gcp": 2, "ibm": 2}, policy="makespan", log=log,
                        retry=RetryPolicy(max_retries=2, backoff_s=0.3),
                        shared_capacity=mkt)
    gcp = get_profile("gcp")
    t0 = gcp.startup_s + gcp.network_rtt_s           # prep starts its compute
    rec = orch.execute(_pipeline(2, 2.0, 1.0),
                       failures=[FailureSpec("gcp", t0 + 0.1, 1.0)])
    assert rec.status == "succeeded"
    assert log.count("capacity:speculate") >= 1
    cancelled = [op for led in mkt.ledgers.values()
                 for op in led.audit if op["op"] == "cancel"]
    assert cancelled, "the losing side must be cancelled through the ledger"
    for name, r in rec.steps.items():
        assert sum(1 for a in r.attempts if a["status"] == "ok") == 1
    mkt.check_conservation()


def test_worker_gauges_exposed():
    """Satellite: cluster occupancy reaches the metrics plane as
    pipeline_workers_busy/free{cloud=...} gauges."""
    reg = MetricsRegistry()
    orch = Orchestrator({"gcp": 2, "ibm": 1}, policy="makespan", metrics=reg)
    orch.execute(_pipeline(2, 0.5, 0.5))
    for c in ("gcp", "ibm"):
        assert reg.value("pipeline_workers_busy", cloud=c) == 0  # drained
        free = reg.value("pipeline_workers_free", cloud=c)
        assert free == {"gcp": 2, "ibm": 1}[c]
    reg.scrape(0.0)
    assert any("pipeline_workers_busy" in k
               for k in reg.scrapes[-1]["series"])


def test_dormant_path_emits_no_capacity_events():
    """shared_capacity=None must leave both planes exactly as they were:
    not a single capacity:* event, no ledger anywhere."""
    log = EventLog()
    orch = Orchestrator({"gcp": 2}, policy="makespan", log=log)
    orch.execute(_pipeline(2, 0.3, 0.3))
    gw = Gateway(log=log)
    gw.deploy("m", AnalyticBackend("m", 0.005), get_profile("gcp"),
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2,
                                          target_queue=4,
                                          idle_window_s=math.inf),
              max_batch=4)
    gw.run([TrafficSpec("m", 40, arrival="poisson", rate=400.0)], seed=0)
    assert not [e for e in log.events if e["name"].startswith("capacity:")]
