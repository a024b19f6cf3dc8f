"""Twin of tests/test_capacity_market.py on the port's copy of
``clouds/capacity.py``: the ledger's unit contract (refusal at the slot
ceiling, youngest-first preemption, audit-seq monotonicity, the budget
planner's reserve) and the gateway's side of spot semantics (a serving
burst on a cloud whose recorded timeline is full of training leases
preempts them, and is never denied).  The cases that drive training
through the pipeline orchestrator wait for its port."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.clouds.capacity import CapacityLedger, CapacityMarket  # noqa: E402
from repro_torch.clouds.profiles import get_profile  # noqa: E402
from repro_torch.serving.gateway import AutoscalerConfig, Gateway, TrafficSpec  # noqa: E402
from repro_torch.telemetry.events import EventLog  # noqa: E402

from conftest import AnalyticBackend  # noqa: E402


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


# -- directed end-to-end case -------------------------------------------------

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
