"""The port's KServe analog (``repro_torch.serving.kserve``): twins of the 15
tests of tests/test_serving.py -- the paper's Table 3 ordering, batching,
autoscaling, canary split, Poisson queueing, SLO pass-through -- on the
port's InferenceService with a Predictor on the CPU, and the serving
launcher's kserve strategy on the smoke config."""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.clouds.profiles import get_profile  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.kserve import InferenceService, Predictor  # noqa: E402


def make_predictor(name="v1", cost_s=0.0):
    def predict(x):
        if cost_s:
            time.sleep(cost_s)
        return torch.as_tensor(x).sum(dim=tuple(range(1, x.ndim)))

    return Predictor(name, predict, np.zeros((1, 4), np.float32), device="cpu")


def test_strategy_ordering_matches_paper_table3():
    """baremetal >> k8s > kserve for every request count (paper's finding)."""
    pred = make_predictor()
    pred.warmup((1, 32))
    totals = {}
    for strat, prof in (("baremetal", "baremetal"), ("k8s", "k8s"), ("kserve", "gcp")):
        svc = InferenceService(pred, get_profile(prof), strat)
        totals[strat] = [svc.stress_test(n).total_time_s for n in (8, 64, 256)]
    for i in range(3):
        assert totals["baremetal"][i] > totals["k8s"][i] > totals["kserve"][i]
    assert totals["baremetal"][2] / totals["kserve"][2] > \
        totals["baremetal"][0] / totals["kserve"][0] * 0.5


def test_ibm_profile_faster_inference_than_gcp():
    pred = make_predictor()
    gcp = InferenceService(pred, get_profile("gcp"), "kserve").stress_test(128)
    ibm = InferenceService(pred, get_profile("ibm"), "kserve").stress_test(128)
    assert ibm.total_time_s < gcp.total_time_s


def test_all_requests_served_exactly_once():
    pred = make_predictor()
    res = InferenceService(pred, get_profile("gcp"), "kserve", max_batch=8).stress_test(100)
    assert res.n_requests == 100
    assert len(res.latencies_s) == 100
    assert all(l > 0 for l in res.latencies_s)
    assert sum(res.per_version.values()) == 100


def test_autoscaler_adds_replicas_under_load():
    pred = make_predictor(cost_s=0.002)
    svc = InferenceService(pred, get_profile("gcp"), "kserve", max_batch=4,
                           min_replicas=1, max_replicas=4, target_queue=4)
    res = svc.stress_test(128)
    assert max(r for _, r in res.replica_trace) > 1
    assert max(r for _, r in res.replica_trace) <= 4


def test_canary_traffic_split():
    v1, v2 = make_predictor("v1"), make_predictor("v2")
    svc = InferenceService(v1, get_profile("gcp"), "kserve", canary=v2, canary_fraction=0.25)
    frac = svc.stress_test(400, seed=7).per_version.get("v2", 0) / 400
    assert 0.15 < frac < 0.35


def test_batching_reduces_per_request_cost():
    pred = make_predictor(cost_s=0.001)
    small = InferenceService(pred, get_profile("gcp"), "kserve", max_batch=1)
    big = InferenceService(pred, get_profile("gcp"), "kserve", max_batch=32)
    assert big.stress_test(64).total_time_s < small.stress_test(64).total_time_s


def test_poisson_arrivals_latency_includes_queueing():
    pred = make_predictor(cost_s=0.002)
    svc = InferenceService(pred, get_profile("gcp"), "kserve", max_batch=4, max_replicas=1)
    hot = svc.stress_test(64, arrival="poisson", rate=10000.0)
    cold = svc.stress_test(64, arrival="poisson", rate=5.0)
    assert hot.p99 > cold.p99
    assert all(l > 0 for l in hot.latencies_s)
    assert hot.n_requests == 64 and sum(hot.per_version.values()) == 64


def test_poisson_underload_latency_near_service_time():
    pred = make_predictor()
    res = InferenceService(pred, get_profile("gcp"), "kserve", max_batch=8).stress_test(
        32, arrival="poisson", rate=2.0)
    base = (get_profile("gcp").network_rtt_s + get_profile("gcp").lb_overhead_s
            + pred.service_time(1))
    assert res.p50 < base * 3 + 0.01


def test_burst_mode_unchanged_semantics():
    a = InferenceService(make_predictor(), get_profile("gcp"), "kserve").stress_test(50)
    assert a.n_requests == 50 and len(a.latencies_s) == 50


def test_poisson_canary_split_and_accounting():
    v1, v2 = make_predictor("v1"), make_predictor("v2")
    svc = InferenceService(v1, get_profile("gcp"), "kserve", canary=v2, canary_fraction=0.3)
    res = svc.stress_test(300, seed=3, arrival="poisson", rate=500.0)
    assert sum(res.per_version.values()) == 300
    assert 0.2 < res.per_version.get("v2", 0) / 300 < 0.4
    assert all(l > 0 for l in res.latencies_s)


def test_canary_zero_fraction_never_routes():
    v1, v2 = make_predictor("v1"), make_predictor("v2")
    svc = InferenceService(v1, get_profile("gcp"), "kserve", canary=v2, canary_fraction=0.0)
    assert svc.stress_test(64).per_version == {"v1": 64}


def test_canary_split_deterministic_per_seed():
    v1, v2 = make_predictor("v1"), make_predictor("v2")
    svc = InferenceService(v1, get_profile("gcp"), "kserve", canary=v2, canary_fraction=0.25)
    assert svc.stress_test(200, seed=5).per_version == svc.stress_test(200, seed=5).per_version


def test_poisson_latency_floor_is_network_path():
    pred = make_predictor()
    prof = get_profile("gcp")
    res = InferenceService(pred, prof, "kserve", max_batch=8).stress_test(
        64, arrival="poisson", rate=20.0)
    assert min(res.latencies_s) >= prof.network_rtt_s + prof.lb_overhead_s
    assert res.total_time_s >= max(res.latencies_s)


def test_slo_passthrough_reports_per_class():
    pred = make_predictor()
    pred.warmup((1, 32))
    res = InferenceService(pred, get_profile("gcp"), "kserve").stress_test(64, slo="latency")
    pc = res.per_class()
    assert set(pc) == {"latency"}
    assert pc["latency"]["n"] == 64
    assert 0.0 <= pc["latency"]["miss_rate"] <= 1.0
    assert res.observed["n"] == 64


def test_stress_test_zero_requests_is_empty_result():
    res = InferenceService(make_predictor(), get_profile("gcp"), "kserve").stress_test(0)
    assert res.n_requests == 0
    assert res.latencies_s == []
    assert res.total_time_s == 0.0


def test_predictor_warmup_measures_each_bucket_once():
    calls = []
    pred = Predictor("m", lambda x: calls.append(len(x)) or torch.zeros(len(x)),
                     np.zeros((1, 3), np.int32), device="cpu")
    pred.warmup((1, 3, 8))
    assert sorted(set(calls)) == [1, 4, 8] and len(calls) == 12    # 1 + 3 per bucket
    assert pred.service_time(5) == pred.service_time(8)             # pow2 bucket, cached
    assert len(calls) == 12


def test_serve_main_kserve_strategy_on_the_smoke_config(capsys):
    """The launcher's default strategy on the host: the gateway batches the
    burst up to --max-batch requests a predict."""
    serve.main(["--arch", "granite_3_8b", "--strategy", "kserve", "--max-batch", "4",
                "--smoke", "--device", "cpu", "--requests", "8", "--gen-tokens", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["strategy"] == "kserve" and out["n"] == 8 and out["device"] == "cpu"
    assert out["per_version"] == {out["arch"]: 8}
    assert out["p50_s"] > 0 and out["total_s"] >= out["p99_s"]
