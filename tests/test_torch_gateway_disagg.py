"""Twin of tests/test_gateway_disagg.py on the port: prefill/decode
disaggregation in the gateway.

  * DisaggSpec / deploy() validation: pool kinds must name declared
    clouds, staged mode forbids "both" pools and requires a weighted
    prefill AND decode pool;
  * staged two-stage pipeline: every request is dispatched exactly once
    per stage, ``gateway:prefill`` fires per prefill batch, latency is
    charged once at decode completion and covers both phases, the KV
    ledger drains to zero, and scalar/vector engines stay bit-identical;
  * unified (both-kind) disagg is a pure annotation;
  * cache-exhaustion shedding pairs ``gateway:cache_shed`` with
    ``gateway:shed`` (at="cache") and never drops batch-class work;
  * BatcherBackend's measured two-phase cost model over the port's
    h2o_danube smoke ContinuousBatcher on the CPU, and the ModelDemand
    prefill/decode split in the placement planner.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.clouds.profiles import get_profile
from repro_torch.serving.gateway import (AutoscalerConfig, BatcherBackend,
                                   DisaggSpec, Gateway, ModelDemand,
                                   RoutingConfig, TrafficSpec, est_p99_s,
                                   est_wait_s, plan_placement, replicas_needed,
                                   CloudCapacity)
from repro_torch.telemetry.events import EventLog

from conftest import AnalyticBackend

GCP, IBM = get_profile("gcp"), get_profile("ibm")


def _staged_gateway(*, kv_blocks=256, shed_margin=1.0, routing="queue_aware",
                    admission=None, n=14, seed=3, engine="vector",
                    slo="standard"):
    gw = Gateway(log=EventLog(), record_batches=True,
                 routing=RoutingConfig(policy=routing), admission=admission)
    gw.deploy("llm", AnalyticBackend("llm", 0.02, 0.005),
              split={GCP: 0.5, IBM: 0.5},
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2),
              max_batch=4,
              disagg=DisaggSpec(kv_blocks=kv_blocks, block_size=16,
                                prompt_tokens=64, gen_tokens=16,
                                shed_margin=shed_margin,
                                pool_kind={"gcp": "prefill",
                                           "ibm": "decode"}))
    traffic = [TrafficSpec("llm", n, arrival="poisson", rate=100.0, slo=slo)]
    out = gw.run(traffic, seed=seed, engine=engine)
    return gw, out


# -- spec / deploy validation ------------------------------------------------

def test_disagg_spec_validation():
    assert DisaggSpec(prompt_tokens=64, gen_tokens=16,
                      block_size=16).blocks_per_request == 5
    assert DisaggSpec(prompt_tokens=0, gen_tokens=1,
                      block_size=16).blocks_per_request == 1
    spec = DisaggSpec(kv_blocks={"gcp": 32}, pool_kind={"gcp": "prefill"})
    assert spec.blocks_for("gcp") == 32 and spec.blocks_for("ibm") == 0
    assert spec.kind("gcp") == "prefill" and spec.kind("ibm") == "both"
    with pytest.raises(ValueError):
        DisaggSpec(block_size=0)
    with pytest.raises(ValueError):
        DisaggSpec(gen_tokens=0)
    with pytest.raises(ValueError):
        DisaggSpec(shed_margin=0.0)


def test_deploy_validation():
    def fresh():
        return Gateway(log=EventLog())

    be = AnalyticBackend("m", 0.01)
    kw = dict(autoscaler=AutoscalerConfig(max_replicas=1))
    with pytest.raises(ValueError, match="not in the placement"):
        fresh().deploy("m", be, GCP, disagg=DisaggSpec(
            pool_kind={"aws": "prefill"}), **kw)
    with pytest.raises(ValueError, match="pool_kind"):
        fresh().deploy("m", be, GCP, disagg=DisaggSpec(
            pool_kind={"gcp": "turbo"}), **kw)
    # staged mode forbids mixing in a unified pool (the zero-weight standby
    # defaults to "both" and must be assigned a side too)...
    with pytest.raises(ValueError, match="both"):
        fresh().deploy("m", be, split={GCP: 0.4, IBM: 0.6},
                       standby=get_profile("baremetal"),
                       disagg=DisaggSpec(pool_kind={"gcp": "prefill",
                                                    "ibm": "decode"}), **kw)
    # ...and each stage needs a pool that actually takes traffic
    with pytest.raises(ValueError, match="decode"):
        fresh().deploy("m", be, GCP,
                       disagg=DisaggSpec(pool_kind={"gcp": "prefill"}), **kw)
    with pytest.raises(ValueError, match="prefill"):
        fresh().deploy("m", be, split={GCP: 1.0, IBM: 0.0},
                       disagg=DisaggSpec(pool_kind={"gcp": "decode",
                                                    "ibm": "prefill"}), **kw)


# -- staged pipeline ---------------------------------------------------------

def test_staged_pipeline_two_dispatches_per_request():
    gw, out = _staged_gateway()
    res = out.per_model["llm"]
    n = res.n_requests
    assert res.shed_total == 0
    recs = [r for r in gw.batch_log if not r["preempted"]]
    by_stage = {"prefill": [], "decode": []}
    for r in recs:
        by_stage[r["stage"]].extend(r["idx"])
    # exactly once per stage, and only on the pool of that kind
    assert sorted(by_stage["prefill"]) == list(range(n))
    assert sorted(by_stage["decode"]) == list(range(n))
    assert {r["cloud"] for r in recs if r["stage"] == "prefill"} == {"gcp"}
    assert {r["cloud"] for r in recs if r["stage"] == "decode"} == {"ibm"}
    # latency charged once, at decode completion, covering both phases
    assert len(res.latencies_s) == n and all(l > 0 for l in res.latencies_s)
    for i in range(n):
        dec = [r for r in recs if r["stage"] == "decode" and i in r["idx"]]
        pre = [r for r in recs if r["stage"] == "prefill" and i in r["idx"]]
        assert dec[0]["start_s"] >= pre[0]["end_s"] - 1e-9, \
            "decode dispatched before its prefill landed"
    # one staged gateway:prefill event per prefill batch, n requests total
    pf = gw.log.named("gateway:prefill")
    assert len(pf) == sum(1 for r in recs if r["stage"] == "prefill")
    assert all(e["staged"] for e in pf)
    assert sum(e["n"] for e in pf) == n
    # the KV ledger drains: blocks are held dispatch -> free per phase
    assert gw.final_kv == {"llm": {"gcp": 0, "ibm": 0}}


def test_staged_engines_bit_identical():
    a = _staged_gateway(engine="scalar")[0].log.dump()
    b = _staged_gateway(engine="vector")[0].log.dump()
    assert a == b


def test_staged_deterministic():
    a = _staged_gateway(seed=11)[0].log.dump()
    b = _staged_gateway(seed=11)[0].log.dump()
    assert a == b


# -- unified (both-kind) disagg ----------------------------------------------

def test_unified_disagg_is_pure_annotation():
    def run(disagg):
        gw = Gateway(log=EventLog(), record_batches=True)
        gw.deploy("m", AnalyticBackend("m", 0.02, 0.005), GCP,
                  autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2),
                  max_batch=4, disagg=disagg)
        out = gw.run([TrafficSpec("m", 12, arrival="poisson", rate=150.0)],
                     seed=5)
        return gw, out.per_model["m"]

    gw_d, res_d = run(DisaggSpec(kv_blocks=10_000))
    gw_p, res_p = run(None)
    assert res_d.latencies_s == res_p.latencies_s
    assert res_d.shed_total == res_p.shed_total == 0
    # cost attribution rides along: one unstaged prefill event per dispatch
    pf = gw_d.log.named("gateway:prefill")
    n_batches = sum(1 for r in gw_d.batch_log if not r["preempted"])
    assert len(pf) == n_batches and not any(e["staged"] for e in pf)
    assert all(e["duration_s"] > 0 for e in pf)
    assert not gw_p.log.named("gateway:prefill")


# -- cache-exhaustion shedding -----------------------------------------------

def test_cache_exhaustion_sheds():
    # blocks_per_request = ceil(80/16) = 5; 6 blocks hold ONE request per
    # pool, so a poisson burst must shed on projected exhaustion
    gw, out = _staged_gateway(kv_blocks=6, n=16, slo="standard")
    res = out.per_model["llm"]
    assert res.shed_total > 0
    assert res.shed_total + len(res.latencies_s) == res.n_requests
    cache = gw.log.named("gateway:cache_shed")
    sheds = [e for e in gw.log.named("gateway:shed") if e["at"] == "cache"]
    assert len(cache) == len(sheds) == res.shed_total
    assert sorted(e["idx"] for e in cache) == sorted(e["idx"] for e in sheds)
    for e in cache:
        assert e["kv_projected"] > e["kv_total"] >= e["kv_used"]


def test_cache_shed_never_touches_batch_class():
    gw, out = _staged_gateway(kv_blocks=6, n=16, slo="batch")
    res = out.per_model["llm"]
    assert res.shed_total == 0 and len(res.latencies_s) == res.n_requests


def test_big_budget_never_cache_sheds():
    gw, out = _staged_gateway(kv_blocks=100_000, n=16)
    assert out.per_model["llm"].shed_total == 0
    assert not gw.log.named("gateway:cache_shed")


# -- measured two-phase cost model -------------------------------------------

def test_batcher_backend_cost_split():
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serving.continuous import ContinuousBatcher

    cfg = registry.get_smoke_config("h2o_danube_3_4b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    b = ContinuousBatcher(cfg, params, max_slots=2, max_len=64,
                          prefill_chunk=8)
    be = BatcherBackend("llm", b, prompt_len=16, gen_tokens=4)
    assert be.disaggregated
    pf, dec = be.prefill_time(16), be.decode_time(4)
    assert pf > 0 and dec > 0
    # chunked ingest of a 16-token prompt is 2 prefill calls; the
    # teacher-forced equivalent would be 16 decode steps
    assert be.prefill_time(16) == 2 * be.prefill_time(8)
    assert be.decode_time(8) == 2 * be.decode_time(4)
    assert be.service_time(1) == pytest.approx(pf + dec)
    assert be.service_time(2) == pytest.approx(2 * pf + dec)
    assert be.service_time(3) == pytest.approx(3 * pf + 2 * dec)


def test_batcher_backend_blended_fallback():
    class FakeBatcher:
        prefill_chunk = 0
        max_slots = 2
        step_count = 0

        def submit(self, prompt, max_new):
            self._work = len(prompt) + max_new

        def run(self):
            self.step_count += self._work
            return []

    be = BatcherBackend("m", FakeBatcher(), prompt_len=8, gen_tokens=4)
    assert not be.disaggregated
    # blended: prefill is priced as P teacher-forced steps
    assert be.prefill_time(8) == pytest.approx(8 * be.decode_time(1))


# -- placement demand split --------------------------------------------------

def test_model_demand_split():
    blended = ModelDemand("m", rate=10.0, service_time_s=0.3)
    split = ModelDemand("m", rate=10.0, service_time_s=0.3,
                        prefill_s=0.2, decode_s=0.1)
    assert blended.load == pytest.approx(split.load) == pytest.approx(3.0)
    assert split.prefill_load == pytest.approx(2.0)
    assert split.decode_load == pytest.approx(1.0)
    assert blended.prefill_load == 0.0
    assert blended.decode_load == pytest.approx(blended.load)
    # a heavier split raises the effective load the planner sizes against
    heavy = ModelDemand("m", rate=10.0, service_time_s=0.3,
                        prefill_s=0.4, decode_s=0.2)
    assert heavy.load > blended.load
    assert replicas_needed(heavy) >= replicas_needed(blended)
    assert est_wait_s(heavy, 12) > est_wait_s(blended, 12)
    assert est_p99_s(GCP, heavy, 12) > est_p99_s(GCP, blended, 12)


def test_plan_placement_with_split_demand():
    clouds = [CloudCapacity(GCP, 4), CloudCapacity(IBM, 4)]
    # need 6 replicas: no single cloud fits, the split path must engage
    # (and carry the prefill/decode split into each share's estimates)
    plan = plan_placement(
        [ModelDemand("llm", rate=8.0, service_time_s=0.5,
                     prefill_s=0.35, decode_s=0.15)], clouds, split=True)
    a = plan.assignments[0]
    assert sum(a.shares.values()) >= replicas_needed(
        ModelDemand("llm", 8.0, 0.5))
    assert abs(sum(a.weights.values()) - 1.0) < 1e-9
    assert math.isfinite(a.est_p99_s)
