"""Twins of tests/test_orchestrator.py and of the non-drift cases of
tests/test_modelci.py on the port's copies of the multi-cloud pipeline
orchestrator (``pipelines/``) and the Model-CI profiling plane
(``modelci/``); ``test_roofline_fields_closed_form`` waits for the H100
HardwareSpec (ROADMAP.md queue 1 item 1.10), and the port's
``roofline_fields`` says so.  Then exact parity with the reference: equal
specs with ``sim_s`` on every step, profile and deploy steps included, run
through both packages' ``Orchestrator`` with the same failures give equal
run summaries, per-step clouds, attempts and costs, and equal event-name
sequences."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import modelci as jmodelci  # noqa: E402
from repro import pipelines as jpipelines  # noqa: E402
from repro.clouds import profiles as jprofiles  # noqa: E402
from repro.core import pipeline as jpipeline  # noqa: E402
from repro.serving import gateway as jgateway  # noqa: E402
from repro.telemetry.events import EventLog as JEventLog  # noqa: E402
from repro_torch import modelci  # noqa: E402
from repro_torch.clouds import profiles  # noqa: E402
from repro_torch.clouds.profiles import get_profile  # noqa: E402
from repro_torch.core import pipeline as tpipeline  # noqa: E402
from repro_torch.core.pipeline import Pipeline  # noqa: E402
from repro_torch.modelci import (ModelProfile, ProfiledBackend, ProfileSpec,  # noqa: E402
                                 ProfileStore, finalize, measure)
from repro_torch.pipelines import (ArtifactCache, DeploySpec, Orchestrator,  # noqa: E402
                                   PipelineRuns, RetryPolicy)
from repro_torch.serving import gateway  # noqa: E402
from repro_torch.serving.gateway import (AutoscalerConfig, CloudCapacity,  # noqa: E402
                                         FailureSpec, Gateway, TrafficSpec)
from repro_torch.telemetry.events import EventLog  # noqa: E402

from conftest import AnalyticBackend  # noqa: E402

GCP = get_profile("gcp")
IBM = get_profile("ibm")


def _counted(calls):
    def fn(tag, *deps):
        calls[tag] = calls.get(tag, 0) + 1
        return [tag] + [d[0] for d in deps if isinstance(d, list)]
    return fn


def fanout_spec(n_branches=4, sim=1.0, cache=True, calls=None):
    calls = calls if calls is not None else {}
    fn = _counted(calls)
    pipe = Pipeline("fan")
    p = pipe.step(fn, 0, sim_s=0.2, name="prep", cache=cache)
    bs = [pipe.step(fn, 10 + i, p, sim_s=sim, name=f"branch{i}", cache=cache)
          for i in range(n_branches)]
    pipe.step(fn, 99, *bs, sim_s=0.1, name="merge", cache=cache)
    return pipe.compile(), calls


def test_fanout_runs_branches_in_parallel():
    spec, calls = fanout_spec()
    orch = Orchestrator({"gcp": 2, "ibm": 2})
    rec = orch.execute(spec)
    assert rec.status == "succeeded"
    assert all(r.status == "done" for r in rec.steps.values())
    # each fn ran exactly once
    assert all(v == 1 for v in calls.values())
    # branches overlap in simulated time (true parallelism)
    b = [rec.steps[f"branch{i}"] for i in range(4)]
    assert all(x.start_s == b[0].start_s for x in b)
    # work conservation: makespan never exceeds the serial sum
    serial = sum(r.duration_s for r in rec.steps.values())
    assert rec.makespan_s <= serial + 1e-9
    # and genuinely beats it on a 4-way fan-out over 4 workers
    assert serial / rec.makespan_s > 1.5


def test_cost_policy_prefers_cheap_cloud_makespan_prefers_fast():
    fast_dear = dataclasses.replace(GCP, cost_per_s=2.0 / 3600.0)
    slow_cheap = dataclasses.replace(IBM, cost_per_s=1.0 / 3600.0)
    pipe = Pipeline("one")
    pipe.step(lambda: 1, name="s", sim_s=0.5)
    spec = pipe.compile()
    rec_cost = Orchestrator({fast_dear: 1, slow_cheap: 1},
                            policy="cost").execute(spec)
    rec_mk = Orchestrator({fast_dear: 1, slow_cheap: 1},
                          policy="makespan").execute(spec)
    assert rec_cost.steps["s"].cloud == "ibm"     # cheapest first
    assert rec_mk.steps["s"].cloud == "gcp"       # startup 3s < 5s


def test_pin_forces_cloud():
    pipe = Pipeline("pinned")
    pipe.step(lambda: 1, name="s", sim_s=0.1, pin="ibm")
    rec = Orchestrator({"gcp": 1, "ibm": 1}).execute(pipe.compile())
    assert rec.steps["s"].cloud == "ibm"
    with pytest.raises(ValueError, match="unknown cloud"):
        Orchestrator({"gcp": 1}).execute(pipe.compile())


def test_outage_mid_attempt_retries_and_completes_once():
    calls = {}
    fn = _counted(calls)
    pipe = Pipeline("retry")
    pipe.step(fn, 0, sim_s=1.0, name="s")
    spec = pipe.compile()
    orch = Orchestrator({"gcp": 1}, retry=RetryPolicy(max_retries=2,
                                                      backoff_s=0.25))
    # attempt spans [0, ~4.0); the outage at 3.0 kills it
    rec = orch.execute(spec, failures=[FailureSpec("gcp", 3.0, 0.5)])
    r = rec.steps["s"]
    assert rec.status == "succeeded" and r.status == "done"
    assert calls[0] == 1                          # fn ran exactly once
    assert len(r.attempts) == 2
    assert r.attempts[0]["status"] == "outage"
    assert r.attempts[0]["end_s"] == pytest.approx(3.0)
    # retry backs off past the recovery edge, then restarts
    assert r.attempts[1]["start_s"] >= 3.5
    assert orch.log.count("pipeline:retry") == 1
    assert orch.log.count("pipeline:step") == 1
    # the failed attempt is still billed for its worker-seconds
    assert r.cost_usd > r.attempts[1]["cost_usd"]


def test_retries_exhausted_fails_step_and_skips_descendants():
    pipe = Pipeline("perm")
    a = pipe.step(lambda: 1, name="a", sim_s=1.0)
    pipe.step(lambda x: x, a, name="b", sim_s=0.1)
    spec = pipe.compile()
    orch = Orchestrator({"gcp": 1}, retry=RetryPolicy(max_retries=1,
                                                      backoff_s=0.1))
    rec = orch.execute(spec, failures=[FailureSpec("gcp", 3.0, 0.2),
                                       FailureSpec("gcp", 3.5, 0.2)])
    assert rec.status == "failed"
    assert rec.steps["a"].status == "failed"
    assert len(rec.steps["a"].attempts) == 2
    assert rec.steps["b"].status == "skipped"
    assert orch.log.count("pipeline:fail") == 1
    assert orch.log.count("pipeline:skip") == 1
    assert "b" not in rec.outputs


def test_exception_fails_fast_without_retries():
    pipe = Pipeline("boom")
    a = pipe.step(lambda: 1 / 0, name="a")
    pipe.step(lambda x: x, a, name="b")
    orch = Orchestrator({"gcp": 1})
    rec = orch.execute(pipe.compile())
    assert rec.status == "failed"
    assert rec.steps["a"].status == "failed"
    assert len(rec.steps["a"].attempts) == 1
    assert rec.steps["b"].status == "skipped"
    ev = orch.log.named("pipeline:fail")[0]
    assert ev["reason"].startswith("exception:ZeroDivisionError")


def test_cache_hits_never_reexecute_and_bypass_workers():
    spec, calls = fanout_spec(cache=True)
    orch = Orchestrator({"gcp": 2, "ibm": 2})
    rec1 = orch.execute(spec)
    n_after_first = dict(calls)
    rec2 = orch.execute(spec)
    assert calls == n_after_first                 # nothing re-ran
    assert rec2.cache_hits == len(spec.steps)
    assert all(r.cached and r.status == "done" for r in rec2.steps.values())
    assert orch.log.count("pipeline:cache_hit") == len(spec.steps)
    # a cached run is control-plane-only: no startup, tiny makespan, $0
    assert rec2.makespan_s < 0.1 and rec2.cost_usd == 0.0
    assert rec2.outputs == rec1.outputs


def test_cross_cloud_transfer_charged_once_then_resident():
    big = np.zeros(125_000_000 // 8, np.float64)   # 125 MB
    pipe = Pipeline("xfer")
    a = pipe.step(lambda: big, name="produce", sim_s=0.1, pin="gcp")
    b = pipe.step(lambda x: float(x[0]), a, name="consume", sim_s=0.1,
                  pin="ibm")
    pipe.step(lambda x, y: y, a, b, name="consume2", sim_s=0.1, pin="ibm")
    orch = Orchestrator({"gcp": 1, "ibm": 1})
    rec = orch.execute(pipe.compile())
    assert rec.status == "succeeded"
    tr = orch.log.named("pipeline:transfer")
    assert len(tr) == 1                           # second consume: resident
    assert tr[0]["src"] == "gcp" and tr[0]["dst"] == "ibm"
    assert tr[0]["bytes"] == big.nbytes
    # 125 MB over the 1.25 GB/s interconnect: ~0.1 s on the consume path
    assert rec.steps["consume"].transfer_s == pytest.approx(
        GCP.network_rtt_s + IBM.network_rtt_s + 0.1)
    assert rec.steps["consume"].transfer_cost_usd == pytest.approx(
        0.125 * GCP.egress_per_gb)
    assert rec.steps["consume2"].transfer_s == 0.0


def test_deploy_step_hands_model_to_gateway():
    pipe = Pipeline("t2s")
    model = pipe.step(lambda: {"w": 1.0}, name="train", sim_s=0.5)
    pipe.step(lambda m: AnalyticBackend("ranker", 0.01, 0.001), model,
              name="deploy", kind="deploy",
              payload=DeploySpec(
                  "ranker",
                  clouds=[CloudCapacity(GCP, 2, 1.0),
                          CloudCapacity(IBM, 4, 1.4)],
                  load_erlangs=2.0, split=True,
                  autoscaler=AutoscalerConfig(min_replicas=3, max_replicas=3,
                                              idle_window_s=np.inf),
                  max_batch=8))
    spec = pipe.compile()
    assert spec.steps[1].cache is False           # handoff is a side effect
    gw = Gateway()
    orch = Orchestrator({"gcp": 2, "ibm": 2}, policy="cost")
    rec = orch.execute(spec, gateway=gw)
    assert rec.status == "succeeded"
    out = rec.outputs["deploy"]
    # load 2.0 Erlangs / 0.7 target -> 3 replicas: gcp holds 2, ibm 1
    assert out["replicas"] == {"gcp": 2, "ibm": 1}
    assert sum(out["weights"].values()) == pytest.approx(1.0)
    assert "ranker" in gw.deployments
    assert orch.log.count("pipeline:deploy") == 1
    # the deployed model serves real traffic through the gateway
    served = gw.run([TrafficSpec("ranker", 16)], seed=0)
    assert served.per_model["ranker"].n_requests == 16


def test_failed_deploy_leaves_no_live_deployment():
    """The Gateway.deploy side effect is applied on step COMPLETION: a
    deploy step whose every attempt dies in an outage must not leave the
    model serving in the fleet."""
    pipe = Pipeline("dead-deploy")
    m = pipe.step(lambda: 1, name="train", sim_s=0.2)
    pipe.step(lambda _: AnalyticBackend("ghost", 0.01), m, name="deploy",
              kind="deploy", pin="gcp",
              payload=DeploySpec("ghost", clouds=[CloudCapacity(GCP, 4, 1.0)],
                                 load_erlangs=1.0))
    gw = Gateway()
    orch = Orchestrator({"gcp": 1}, retry=RetryPolicy(max_retries=1,
                                                      backoff_s=0.1))
    # train ends ~3.2s; both deploy attempts die inside the windows
    rec = orch.execute(pipe.compile(), gateway=gw,
                       failures=[FailureSpec("gcp", 4.0, 0.2),
                                 FailureSpec("gcp", 5.0, 3.0)])
    assert rec.steps["deploy"].status == "failed"
    assert "ghost" not in gw.deployments
    assert orch.log.count("pipeline:deploy") == 0


def test_deploy_infeasible_fails_run():
    pipe = Pipeline("nofit")
    m = pipe.step(lambda: 1, name="train", sim_s=0.1)
    pipe.step(lambda _: AnalyticBackend("m", 0.01), m, name="deploy",
              kind="deploy",
              payload=DeploySpec("m", clouds=[CloudCapacity(GCP, 0, 1.0)],
                                 load_erlangs=2.1))
    orch = Orchestrator({"gcp": 1})
    rec = orch.execute(pipe.compile(), gateway=Gateway())
    assert rec.status == "failed"
    assert orch.log.named("pipeline:fail")[0]["reason"] == "deploy_infeasible"


def test_deploy_requires_gateway_and_payload():
    pipe = Pipeline("bad")
    pipe.step(lambda: AnalyticBackend("m", 0.01), name="d", kind="deploy",
              payload=DeploySpec("m", clouds=[], load_erlangs=1.0))
    with pytest.raises(ValueError, match="gateway"):
        Orchestrator({"gcp": 1}).execute(pipe.compile())
    with pytest.raises(ValueError, match="rate / load_erlangs"):
        DeploySpec("m", clouds=[], rate=1.0, load_erlangs=1.0)
    with pytest.raises(ValueError, match="kind"):
        pipe.step(lambda: 1, kind="serve")


def test_recurring_runs_share_cache_and_catch_up():
    spec, calls = fanout_spec(cache=True)
    orch = Orchestrator({"gcp": 2, "ibm": 2})
    runs = PipelineRuns(orch)
    recs = runs.recurring(spec, every_s=100.0, runs=3)
    assert [r.run_id for r in recs] == ["fan-000", "fan-001", "fan-002"]
    assert [r.t0 for r in recs] == [0.0, 100.0, 200.0]
    assert recs[0].cache_hits == 0
    assert all(r.cache_hits == len(spec.steps) for r in recs[1:])
    assert all(v == 1 for v in calls.values())    # one real execution total
    assert orch.log.count("pipeline:recurring") == 3
    assert len(runs.history) == 3 and set(runs.summary()) == {
        "fan-000", "fan-001", "fan-002"}
    # a period shorter than the makespan catches up instead of overlapping
    orch2 = Orchestrator({"gcp": 1})
    recs2 = PipelineRuns(orch2).recurring(fanout_spec(cache=False)[0],
                                          every_s=1.0, runs=2)
    assert recs2[1].t0 >= recs2[0].finished_s


def test_cache_hits_wait_out_an_outage_on_the_resident_cloud():
    """A cached recurring run must still feel an injected outage: an
    artifact resident only on a dead cloud cannot be fetched until the
    cloud recovers."""
    spec, _ = fanout_spec(cache=True)
    orch = Orchestrator({"gcp": 1})
    first = orch.execute(spec)                    # residency: all on gcp
    rec = orch.execute(spec, t0=100.0,
                       failures=[FailureSpec("gcp", 100.0, 2.0)])
    assert rec.cache_hits == len(spec.steps)
    # nothing could be served before the recovery edge at t=102
    assert min(r.start_s for r in rec.steps.values()) >= 102.0
    assert first.makespan_s > 1.0                 # and run 1 was real work


def test_serial_cache_entry_reused_by_orchestrator(tmp_path):
    """Pipeline.run and the orchestrator share one store record shape: a
    step cached by the serial executor is a free hit for the orchestrator
    (no residency -> no cloud to bill a transfer against, by design)."""
    from repro_torch.checkpoint.store import ArtifactStore

    def make():
        return [4, 2]

    store = ArtifactStore(str(tmp_path))
    serial = Pipeline("shared", store)
    serial.step(make)
    serial.run()
    authored = Pipeline("shared")
    authored.step(make)
    orch = Orchestrator({"gcp": 1}, cache=ArtifactCache(store))
    rec = orch.execute(authored.compile())
    r = rec.steps["make"]
    assert r.cached and r.cloud is None and r.transfer_cost_usd == 0.0
    assert rec.outputs["make"] == [4, 2]


def test_transfers_cannot_source_from_a_dead_cloud():
    """An input artifact resident only on a mid-outage cloud blocks its
    consumer (same rule as cache hits) instead of transferring bytes out
    of a dead cluster at full speed."""
    pipe = Pipeline("deadsrc")
    a = pipe.step(lambda: [1], name="produce", sim_s=0.1, pin="ibm",
                  cache=False)
    slow = pipe.step(lambda: 2, name="slow", sim_s=3.5, pin="gcp",
                     cache=False)
    pipe.step(lambda x, y: x, a, slow, name="consume", sim_s=0.1,
              pin="gcp", cache=False)
    orch = Orchestrator({"gcp": 1, "ibm": 1})
    # producer ends ~5.1 on ibm; consume becomes ready at ~6.5 (slow),
    # inside the ibm outage [6, 9): its only input source is dead
    rec = orch.execute(pipe.compile(), failures=[FailureSpec("ibm", 6.0, 3.0)])
    assert rec.status == "succeeded"
    assert rec.steps["consume"].start_s >= 9.0
    tr = orch.log.named("pipeline:transfer")
    assert len(tr) == 1 and tr[0]["src"] == "ibm" and tr[0]["t_sim"] >= 9.0


def test_cache_hit_from_retired_cluster_charges_its_rtt(tmp_path):
    """A store entry resident on a cloud outside this orchestrator's
    cluster map still charges that cloud's control-plane RTT on a hit
    (the same PROFILES fallback best_transfer uses)."""
    from repro_torch.checkpoint.store import ArtifactStore

    def make():
        return [7]

    store = ArtifactStore(str(tmp_path))
    pipe = Pipeline("retired")
    pipe.step(make, sim_s=0.1)
    spec = pipe.compile()
    Orchestrator({"gcp": 1}, cache=ArtifactCache(store)).execute(spec)
    rec = Orchestrator({"ibm": 1}, cache=ArtifactCache(store)).execute(spec)
    r = rec.steps["make"]
    assert r.cached and r.cloud == "gcp"
    assert r.duration_s == pytest.approx(GCP.network_rtt_s)


def test_seeded_determinism_of_simulated_timeline():
    spec, _ = fanout_spec()
    fails = [FailureSpec("gcp", 3.5, 1.0)]

    def run():
        orch = Orchestrator({"gcp": 2, "ibm": 2},
                            retry=RetryPolicy(backoff_s=0.25))
        rec = orch.execute(spec, failures=fails)
        return rec.summary(), [e["name"] for e in orch.log.events]

    s1, e1 = run()
    s2, e2 = run()
    assert s1 == s2 and e1 == e2


def test_orchestrator_rejects_bad_configs():
    with pytest.raises(ValueError, match="policy"):
        Orchestrator({"gcp": 1}, policy="greedy")
    with pytest.raises(ValueError, match="worker"):
        Orchestrator({"gcp": 0})
    with pytest.raises(ValueError, match="at least one"):
        Orchestrator({})
    with pytest.raises(ValueError, match="max_retries"):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="backoff_s"):
        RetryPolicy(backoff_s=0.0)


def test_artifact_cache_persists_through_store(tmp_path):
    from repro_torch.checkpoint.store import ArtifactStore

    pipe = Pipeline("persist")
    a = pipe.step(lambda: [1, 2, 3], name="make", sim_s=0.1, pin="gcp")
    # cache=False: the consumer re-executes every run, so run 2 genuinely
    # re-consumes the artifact on ibm
    pipe.step(lambda x: list(x), a, name="use", sim_s=0.1, pin="ibm",
              cache=False)
    spec = pipe.compile()
    store = ArtifactStore(str(tmp_path))
    orch1 = Orchestrator({"gcp": 1, "ibm": 1}, cache=ArtifactCache(store))
    orch1.execute(spec)
    assert orch1.log.count("pipeline:transfer") == 1
    # a fresh process (fresh cache) reloads the JSON-able artifact AND its
    # committed residency: the gcp->ibm move paid above is not re-billed
    orch2 = Orchestrator({"gcp": 1, "ibm": 1}, cache=ArtifactCache(store))
    rec = orch2.execute(spec)
    assert rec.steps["make"].cached and not rec.steps["use"].cached
    assert rec.outputs["make"] == [1, 2, 3]
    assert orch2.log.count("pipeline:transfer") == 0
    assert rec.steps["use"].transfer_cost_usd == 0.0


# -- Model-CI (twin of the non-drift cases of tests/test_modelci.py) ---------

class FakeBackend:
    """Linear cost model: service_time(b) = b * per_request."""

    def __init__(self, name="m", per_request=0.01):
        self.name = name
        self.per_request = per_request

    def service_time(self, b: int) -> float:
        return b * self.per_request


class FakeDisaggBackend(FakeBackend):
    def prefill_time(self) -> float:
        return 0.006

    def decode_time(self) -> float:
        return 0.004


# -- ModelProfile -------------------------------------------------------------

def test_profile_validation_and_effective_service():
    with pytest.raises(ValueError):
        ModelProfile("m", "gcp", 0.0)
    with pytest.raises(ValueError):
        ModelProfile("m", "gcp", float("inf"))
    with pytest.raises(ValueError):                  # one-sided split
        ModelProfile("m", "gcp", 0.01, prefill_s=0.006)
    p = ModelProfile("m", "gcp", 0.01)
    assert p.effective_service_s == 0.01
    d = ModelProfile("m", "gcp", 0.01, prefill_s=0.006, decode_s=0.005)
    assert d.effective_service_s == pytest.approx(0.011)


def test_profile_key_is_content_hash():
    a = ModelProfile("m", "gcp", 0.01, max_batch=8)
    b = ModelProfile("m", "gcp", 0.01, max_batch=8)
    assert a.key == b.key                            # identical -> dedupe
    assert a.key.startswith("profile_")
    c = ModelProfile("m", "gcp", 0.0100001, max_batch=8)
    assert c.key != a.key                            # any change re-keys
    assert ModelProfile("m", "ibm", 0.01, max_batch=8).key != a.key


def test_profile_dict_round_trip():
    p = ModelProfile("m", "aws", 0.02, max_batch=4, prefill_s=0.015,
                     decode_s=0.005, memory_bytes=123, load_s=9.0,
                     roofline={"compute_s": 1.0}, source="measured")
    assert ModelProfile.from_dict(p.to_dict()) == p
    assert ModelProfile.from_dict(p.to_dict()).key == p.key


def test_profile_demand_bridge():
    p = ModelProfile("m", "gcp", 0.01, prefill_s=0.015, decode_s=0.005)
    with pytest.raises(ValueError):
        p.demand()                                   # exactly one of
    with pytest.raises(ValueError):
        p.demand(rate=1.0, load_erlangs=1.0)
    dem = p.demand(load_erlangs=2.0)
    assert dem.name == "m" and dem.service_time_s == 0.01
    assert dem.rate == pytest.approx(2.0 / 0.02)     # effective (pf+dc)
    assert dem.prefill_s == 0.015 and dem.decode_s == 0.005
    assert p.demand(rate=7.0).rate == 7.0


# -- measurement --------------------------------------------------------------

def test_measure_blended_and_disagg_fields():
    fields = measure(FakeBackend(per_request=0.01), max_batch=8)
    assert fields["service_time_s"] == pytest.approx(0.01)
    assert fields["max_batch"] == 8 and fields["source"] == "measured"
    assert "prefill_s" not in fields                 # no two-point model
    d = measure(FakeDisaggBackend(), max_batch=8,
                weights={"w": [1.0, 2.0]})
    assert d["prefill_s"] == 0.006 and d["decode_s"] == 0.004
    assert d["memory_bytes"] > 0


def test_finalize_stamps_cloud_constants():
    gcp = get_profile("gcp")
    mp = finalize(measure(FakeBackend(), max_batch=4), "m", gcp)
    assert mp.cloud == "gcp" and mp.load_s == gcp.model_load_s
    assert mp.source == "measured"


# -- ProfileStore -------------------------------------------------------------

def test_store_put_get_latest_and_dedupe():
    store = ProfileStore()
    a = ModelProfile("m", "gcp", 0.01)
    e1 = store.put(a)
    e2 = store.put(ModelProfile("m", "gcp", 0.01))   # identical: dedupe
    assert e1 is e2
    assert store.get("m", "gcp") == a
    newer = ModelProfile("m", "gcp", 0.02)
    store.put(newer)
    assert store.get("m", "gcp") == newer            # latest supersedes
    assert store.cache.get(a.key) is not None        # history survives
    assert store.get("m", "aws") is None
    store.put(ModelProfile("m", "ibm", 0.03))
    store.put(ModelProfile("other", "gcp", 0.5))
    assert store.clouds("m") == ["gcp", "ibm"]
    assert store.models() == ["m", "other"]


def test_store_worst_and_demand():
    store = ProfileStore()
    store.put(ModelProfile("m", "gcp", 0.01))
    store.put(ModelProfile("m", "ibm", 0.03))
    assert store.worst("m").cloud == "ibm"           # conservative pick
    assert store.worst("m", ["gcp"]).cloud == "gcp"  # restricted to plan
    dem = store.demand("m", load_erlangs=3.0)
    assert dem.service_time_s == 0.03
    with pytest.raises(KeyError):
        store.worst("m", ["aws"])                    # no artifact there
    with pytest.raises(KeyError):
        store.worst("ghost")


def test_store_pull_prices_residency_move():
    store = ProfileStore()
    p = ModelProfile("m", "gcp", 0.01, memory_bytes=10**9)
    store.put(p)
    entry, t_s, usd = store.pull("m", "gcp", get_profile("gcp"))
    assert t_s == 0.0 and usd == 0.0                 # already resident
    entry, t_s, usd = store.pull("m", "gcp", get_profile("ibm"))
    assert t_s > 0 and usd >= 0                      # priced by best_transfer
    assert "ibm" in entry.clouds                     # residency committed
    _, t2, u2 = store.pull("m", "gcp", get_profile("ibm"))
    assert t2 == 0.0 and u2 == 0.0                   # second pull is local
    with pytest.raises(KeyError):
        store.pull("m", "aws", get_profile("gcp"))


# -- ProfiledBackend ----------------------------------------------------------

def test_profiled_backend_cost_model_is_the_artifact():
    p = ModelProfile("m", "gcp", 0.01, max_batch=8)
    be = ProfiledBackend(p)
    assert be.name == "m"
    assert be.service_time(4) == pytest.approx(0.04)
    assert be.service_time(0) == pytest.approx(0.01)  # floor at one request
    assert not hasattr(be, "prefill_time")            # no split, no attrs
    split = ProfiledBackend(ModelProfile("m", "gcp", 0.01,
                                         prefill_s=0.006, decode_s=0.004))
    assert split.prefill_time() == 0.006 and split.decode_time() == 0.004


# -- orchestrator profile steps ----------------------------------------------

def _profile_pipeline(store, backend, clouds=("gcp", "ibm")):
    pipe = Pipeline("ci")
    for c in clouds:
        pipe.step(lambda: measure(backend, max_batch=8),
                  name=f"profile_{c}", kind="profile", pin=c,
                  payload=ProfileSpec("m", store, max_batch=8))
    return pipe


def test_profile_step_commits_per_cloud_artifacts():
    store, log = ProfileStore(), EventLog()
    orch = Orchestrator({"gcp": 1, "ibm": 1}, log=log)
    rec = orch.execute(_profile_pipeline(store, FakeBackend()).compile())
    assert rec.status == "succeeded"
    assert store.clouds("m") == ["gcp", "ibm"]
    # the cloud constant differentiates the artifacts per cloud
    assert store.get("m", "gcp").load_s == get_profile("gcp").model_load_s
    evs = log.named("modelci:profile")
    assert [e["cloud"] for e in evs] == ["gcp", "ibm"]
    assert all(e["key"].startswith("profile_") for e in evs)


def test_profile_step_requires_spec_payload():
    pipe = Pipeline("ci")
    pipe.step(lambda: {}, name="p", kind="profile")
    with pytest.raises(ValueError, match="ProfileSpec"):
        Orchestrator({"gcp": 1}).execute(pipe.compile())
    bad = Pipeline("ci2")
    with pytest.raises(ValueError):
        ProfileSpec("", ProfileStore())              # model must be named
    with pytest.raises(ValueError):
        ProfileSpec("m", store=object())             # store must store
    bad.step(lambda: {}, name="p", kind="profile", payload=object())
    with pytest.raises(ValueError, match="ProfileSpec"):
        Orchestrator({"gcp": 1}).execute(bad.compile())


def test_cached_recurring_profile_still_refreshes_store():
    """The second recurring firing hits the step cache, but the commit
    hook must still run: a fresh store (new process, same ArtifactStore)
    learns the latest pointers from cached completions."""
    cache = ArtifactCache()
    store = ProfileStore(cache)
    log = EventLog()
    orch = Orchestrator({"gcp": 1, "ibm": 1}, cache=cache, log=log)
    spec = _profile_pipeline(store, FakeBackend()).compile()
    recs = PipelineRuns(orch).recurring(spec, every_s=60.0, runs=2)
    assert recs[1].cache_hits == 2                   # measurements cached
    assert log.count("modelci:profile") == 4         # committed every firing
    assert store.clouds("m") == ["gcp", "ibm"]


# -- DeploySpec.profile placement ---------------------------------------------

def _deploy_spec(store):
    return DeploySpec(
        "m",
        clouds=[CloudCapacity(get_profile("gcp"), 2, 1.0),
                CloudCapacity(get_profile("ibm"), 2, 1.4)],
        load_erlangs=2.0, objective="p99", split=True,
        autoscaler=AutoscalerConfig(min_replicas=3, max_replicas=4,
                                    target_queue=8),
        max_batch=8, profile=store)


def test_profile_planned_deploy_uses_store_demand():
    store, log = ProfileStore(), EventLog()
    backend = FakeBackend(per_request=0.01)
    pipe = _profile_pipeline(store, backend)
    pipe.step(lambda: backend, name="deploy", kind="deploy",
              payload=_deploy_spec(store))
    gw = Gateway(log=log)
    rec = Orchestrator({"gcp": 1, "ibm": 1}, log=log).execute(
        pipe.compile(), gateway=gw)
    assert rec.status == "succeeded"
    out = rec.outputs["deploy"]
    assert out["profiled"] is True
    assert len(out["replicas"]) == 2                 # genuinely split
    assert "m" in gw.deployments
    # the gateway's drift monitor knows the planned-from artifact only
    # when drift detection is configured; bare gateways just deploy
    assert gw.drift is None


def test_profile_planned_deploy_infeasible_without_artifacts():
    """No committed profiles for the model on the candidate clouds is an
    infeasible deploy, not a silent fall back to hand-measured numbers."""
    store, log = ProfileStore(), EventLog()
    store.put(ModelProfile("other", "gcp", 0.01))    # wrong model
    pipe = Pipeline("ci")
    pipe.step(lambda: FakeBackend(), name="deploy", kind="deploy",
              payload=_deploy_spec(store))
    rec = Orchestrator({"gcp": 1, "ibm": 1}, log=log).execute(
        pipe.compile(), gateway=Gateway(log=log))
    assert rec.status == "failed"
    assert rec.steps["deploy"].status == "failed"
    assert rec.steps["deploy"].attempts[-1]["status"] == "infeasible"


def test_modelci_does_not_export_roofline_fields():
    """Until 1.10's single-card half the port's package lacked it; now both
    packages export ``roofline_fields``, the port's over the card's
    HardwareSpec (held to the reference's in tests/test_torch_roofline.py)."""
    assert "roofline_fields" in jmodelci.__all__
    assert "roofline_fields" in modelci.__all__ and callable(modelci.roofline_fields)


def test_orchestrator_profile_constants_equal_the_reference():
    for name, p in profiles.PROFILES.items():
        j = jprofiles.get_profile(name)
        assert (p.startup_s, p.egress_per_gb, p.network_rtt_s, p.cost_per_s,
                p.interconnect_bw, p.model_load_s) == \
            (j.startup_s, j.egress_per_gb, j.network_rtt_s, j.cost_per_s,
             j.interconnect_bw, j.model_load_s)


def test_payload_bytes_sizes_tensor_leaves():
    from repro_torch.pipelines import payload_bytes
    tree = {"w": torch.zeros(3, 4), "b": torch.zeros(4, dtype=torch.bfloat16), "n": [1, 2.5]}
    assert payload_bytes(tree) == 48 + 8 + 16
    assert payload_bytes({"w": np.zeros((3, 4), np.float32), "n": [1, 2.5]}) == \
        jpipelines.payload_bytes({"w": np.zeros((3, 4), np.float32), "n": [1, 2.5]})
    assert measure(FakeBackend(), max_batch=4, weights=tree)["memory_bytes"] == 72


# -- exact parity with the reference orchestrator --------------------------

def _produce(tag, *deps):
    return {"tag": tag, "deps": [d["tag"] for d in deps if isinstance(d, dict)],
            "blob": np.full(2048 * (tag + 1), float(tag), np.float32)}


def _measure_fake(pkg, model_out):
    return pkg.measure(FakeBackend("m", 0.004), max_batch=8)


def _parity_spec(pkg):
    """One DAG authored in ``pkg`` (either package's namespace): a fan-out
    of compute steps over pinned and free clouds, two pinned profile steps
    and a profile-planned deploy step, every step with an analytic
    ``sim_s``."""
    P = pkg["pipeline"].Pipeline("parity")
    store = pkg["modelci"].ProfileStore(pkg["cache"])
    prep = P.step(_produce, 0, name="prep", sim_s=0.3)
    branches = [P.step(_produce, i + 1, prep, name=f"b{i}", sim_s=0.5 + 0.25 * i,
                       pin=("ibm" if i == 1 else None), cache=(i != 2))
                for i in range(4)]
    model = P.step(_produce, 9, *branches, name="train", sim_s=1.5)
    profs = [P.step(_measure_fake, pkg["modelci"], model, name=f"profile_{c}",
                    kind="profile", pin=c, sim_s=0.2,
                    payload=pkg["modelci"].ProfileSpec("m", store, max_batch=8))
             for c in ("gcp", "ibm")]
    gw = pkg["gateway"]
    P.step(lambda m, *_: AnalyticBackend("m", 0.01, 0.001), model, *profs,
           name="deploy", kind="deploy", sim_s=0.1,
           payload=pkg["pipelines"].DeploySpec(
               "m", clouds=[gw.CloudCapacity(pkg["profiles"].get_profile("gcp"), 2, 1.0),
                            gw.CloudCapacity(pkg["profiles"].get_profile("ibm"), 4, 1.4)],
               load_erlangs=2.0, split=True,
               autoscaler=gw.AutoscalerConfig(min_replicas=3, max_replicas=4,
                                              target_queue=8, idle_window_s=2.0),
               max_batch=8, profile=store))
    return P.compile(), store


def _run_parity(pkg, failures, recurring):
    pkg = dict(pkg, cache=pkg["pipelines"].ArtifactCache())
    spec, store = _parity_spec(pkg)
    log = pkg["EventLog"]()
    gw = pkg["gateway"].Gateway(log=log)
    orch = pkg["pipelines"].Orchestrator(
        {"gcp": 2, "ibm": 1}, policy="makespan", log=log, cache=pkg["cache"],
        retry=pkg["pipelines"].RetryPolicy(max_retries=2, backoff_s=0.25))
    fails = [pkg["gateway"].FailureSpec(*f) for f in failures]
    if recurring:
        recs = pkg["pipelines"].PipelineRuns(orch).recurring(
            spec, every_s=50.0, runs=2, failures=fails, gateway=gw)
    else:
        recs = [orch.execute(spec, failures=fails, gateway=gw)]
    steps = [{n: (r.status, r.cloud, r.cached, r.attempts, round(r.cost_usd, 12),
                  round(r.transfer_s, 12), round(r.compute_s, 12))
              for n, r in rec.steps.items()} for rec in recs]
    outs = [rec.outputs["deploy"] if "deploy" in rec.outputs else None for rec in recs]
    return ([rec.summary() for rec in recs], steps, outs,
            [e["name"] for e in log.events], store.clouds("m"),
            {c: store.get("m", c).to_dict() for c in store.clouds("m")})


PORT = {"pipeline": tpipeline, "modelci": modelci, "pipelines": __import__(
    "repro_torch.pipelines", fromlist=["Orchestrator"]), "gateway": gateway,
    "profiles": profiles, "EventLog": EventLog}
REF = {"pipeline": jpipeline, "modelci": jmodelci, "pipelines": jpipelines,
       "gateway": jgateway, "profiles": jprofiles, "EventLog": JEventLog}


@pytest.mark.parametrize("failures,recurring", [
    ((), False),
    ((("gcp", 3.5, 1.0),), False),
    ((("ibm", 4.0, 2.0), ("gcp", 9.0, 0.5)), False),
    ((("gcp", 3.5, 1.0),), True),
], ids=["clean", "gcp_outage", "two_outages", "recurring"])
def test_orchestrator_equals_the_reference(failures, recurring):
    mine = _run_parity(PORT, failures, recurring)
    theirs = _run_parity(REF, failures, recurring)
    assert mine[0] == theirs[0]                  # RunRecord.summary()
    assert mine[1] == theirs[1]                  # clouds, attempts, costs
    assert mine[2] == theirs[2]                  # the deploy plan
    assert mine[3] == theirs[3]                  # event-name sequence
    assert mine[4:] == theirs[4:] and mine[4] == ["gcp", "ibm"]
    assert all(s["status"] == "succeeded" for s in mine[0])
