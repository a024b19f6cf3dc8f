"""Twin of tests/test_pipelines_invariants.py on the port's copy of the
pipeline orchestrator: property-based invariants over random pipeline
DAGs, cluster shapes, placement policies and outage windows.

Invariants, checked over randomly drawn scenarios:

  1. exactly-once completion: every step ends in exactly one of done /
     failed / skipped; a done step has exactly ONE successful attempt and
     its fn ran exactly once; a failed step exhausted its RetryPolicy
     (attempts == max_retries + 1, all killed by outages); a skipped step
     has a failed ancestor; events reconcile (pipeline:step == done,
     pipeline:fail == failed, pipeline:skip == skipped, and every failed
     attempt logged either pipeline:retry or pipeline:fail);
  2. work conservation: with no outage windows every step completes and
     the parallel makespan never exceeds the serial sum of per-step
     simulated durations (the greedy scheduler never idles a worker while
     a step is ready);
  3. cache hits never re-execute: a second run on the same orchestrator
     reuses every cacheable artifact from a clean first run -- fn call
     counters do not move, records say cached;
  4. cost totals match per-step charges: run cost == sum of step costs ==
     sum over attempts of worker-seconds x the cloud's price sheet plus
     the egress dollars of every transfer (failed attempts billed too);
  5. the simulated timeline is deterministic: a rebuilt orchestrator
     replays the identical records and event-name sequence (steps carry
     analytic sim_s durations, so nothing depends on host wall clock).

The scenario space is described once (``scenario``) and driven via
hypothesis when installed (requirements-dev.txt; CI pins
--hypothesis-seed and the "ci" profile from conftest.py) and via a seeded
numpy fallback that always runs.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.pipeline import Pipeline  # noqa: E402
from repro_torch.pipelines import Orchestrator, RetryPolicy  # noqa: E402
from repro_torch.serving.gateway import FailureSpec  # noqa: E402

try:
    from hypothesis import given, strategies as hyp_st
    HAS_HYPOTHESIS = True
except ImportError:              # degrade to the seeded fallback only
    HAS_HYPOTHESIS = False

CLOUDS = ("gcp", "ibm")


# -- scenario space ----------------------------------------------------------

def scenario(pick_int, pick_choice, pick_float):
    """One random-but-valid DAG + cluster + failure description as plain
    data, parameterized over the drawing primitives so hypothesis and the
    numpy fallback explore the same space."""
    n = pick_int(2, 7)
    steps = []
    for i in range(n):
        n_deps = pick_int(0, min(i, 2))
        deps = sorted({pick_int(0, i - 1) for _ in range(n_deps)}) \
            if n_deps else []
        steps.append({"deps": deps,
                      "sim_ms": pick_float(1.0, 50.0),
                      "cache": pick_choice((True, False)),
                      "kb": pick_int(1, 64),      # artifact payload size
                      "pin": pick_choice((None, None, "gcp", "ibm"))})
    clusters = {"gcp": pick_int(1, 3)}
    if pick_choice((True, False)):
        clusters["ibm"] = pick_int(1, 3)
    for s in steps:                  # pins must name a cluster
        if s["pin"] is not None and s["pin"] not in clusters:
            s["pin"] = None
    failures = []
    for _ in range(pick_int(0, 2)):
        failures.append({"cloud": pick_choice(tuple(clusters)),
                         "at": pick_float(0.0, 12.0),
                         "dur": pick_float(0.3, 4.0)})
    return {"steps": steps, "clusters": clusters,
            "policy": pick_choice(("cost", "makespan")),
            "retries": pick_int(0, 2),
            "backoff": pick_float(0.1, 1.0),
            "failures": failures,
            "seed": pick_int(0, 2 ** 16)}


def build(p):
    calls: dict = {}

    def make(tag, *deps, _calls=calls, _steps=p["steps"]):
        _calls[tag] = _calls.get(tag, 0) + 1
        return np.full(_steps[tag]["kb"] * 128, float(tag))

    pipe = Pipeline("rand")
    refs = []
    for i, s in enumerate(p["steps"]):
        refs.append(pipe.step(make, i, *[refs[d] for d in s["deps"]],
                              name=f"s{i}", cache=s["cache"],
                              sim_s=s["sim_ms"] / 1e3, pin=s["pin"]))
    orch = Orchestrator(dict(p["clusters"]), policy=p["policy"],
                        retry=RetryPolicy(max_retries=p["retries"],
                                          backoff_s=p["backoff"]))
    failures = [FailureSpec(f["cloud"], f["at"], f["dur"])
                for f in p["failures"]]
    return pipe.compile(), orch, failures, calls


# -- the invariants ----------------------------------------------------------

def run_and_check(p):
    spec, orch, failures, calls = build(p)
    rec = orch.execute(spec, failures=failures)
    n = len(spec.steps)
    by_status: dict = {}
    for name, r in rec.steps.items():
        by_status.setdefault(r.status, []).append(name)

    # 1. exactly-once completion, statuses partition the DAG
    assert sum(len(v) for v in by_status.values()) == n
    assert set(by_status) <= {"done", "failed", "skipped"}
    for i, s in enumerate(spec.steps):
        r = rec.steps[s.name]
        if r.status == "done":
            ok = [a for a in r.attempts if a["status"] == "ok"]
            if r.cached:
                assert not r.attempts
            else:
                assert len(ok) == 1 and r.attempts[-1] is ok[0]
                assert calls.get(i, 0) == 1      # real work ran exactly once
            assert s.name in rec.outputs
        elif r.status == "failed":
            assert len(r.attempts) == p["retries"] + 1
            assert all(a["status"] == "outage" for a in r.attempts)
            assert s.name not in rec.outputs
        else:                                    # skipped: a bad ancestor
            assert not r.attempts
            frontier, bad = set(s.deps), False
            while frontier:
                d = frontier.pop()
                dr = rec.steps[spec.steps[d].name]
                if dr.status in ("failed", "skipped"):
                    bad = True
                    break
                frontier |= set(spec.steps[d].deps)
            assert bad, f"{s.name} skipped without a failed ancestor"
    assert rec.status == ("succeeded" if by_status.get("done", []) and
                          len(by_status["done"]) == n else "failed")

    # events reconcile with the records
    assert orch.log.count("pipeline:step") == len(by_status.get("done", []))
    assert orch.log.count("pipeline:fail") == len(by_status.get("failed", []))
    assert orch.log.count("pipeline:skip") == len(by_status.get("skipped", []))
    failed_attempts = sum(
        1 for r in rec.steps.values() for a in r.attempts
        if a["status"] == "outage")
    assert (orch.log.count("pipeline:retry")
            + orch.log.count("pipeline:fail") == failed_attempts)
    assert orch.log.count("pipeline:cache_hit") == rec.cache_hits

    # 2. work conservation (no failures => all done, makespan <= serial sum)
    if not p["failures"]:
        assert by_status.get("done", []) and len(by_status["done"]) == n
        serial = sum(r.duration_s for r in rec.steps.values())
        assert rec.makespan_s <= serial + 1e-9

    # 4. cost totals match per-step charges
    price = {c: orch.pools[c].profile.cost_per_s for c in orch.pools}
    total = 0.0
    for r in rec.steps.values():
        charge = sum((a["end_s"] - a["start_s"]) * price[a["cloud"]]
                     for a in r.attempts) + r.transfer_cost_usd
        assert r.cost_usd == pytest.approx(charge, abs=1e-12)
        assert r.cost_usd == pytest.approx(
            sum(a["cost_usd"] for a in r.attempts), abs=1e-12)
        total += r.cost_usd
    assert rec.cost_usd == pytest.approx(total, abs=1e-12)
    return rec


def run_twice_and_compare(p):
    """Invariant 5: rebuilt orchestrator => identical simulated timeline."""
    spec1, orch1, f1, _ = build(p)
    rec1 = orch1.execute(spec1, failures=f1)
    spec2, orch2, f2, _ = build(p)
    rec2 = orch2.execute(spec2, failures=f2)
    assert rec1.summary() == rec2.summary()
    assert ([dataclasses.asdict(r) for r in rec1.steps.values()]
            == [dataclasses.asdict(r) for r in rec2.steps.values()])
    assert ([e["name"] for e in orch1.log.events]
            == [e["name"] for e in orch2.log.events])


def run_cached_second_pass(p):
    """Invariant 3: on a clean (failure-free) first run, a second run on
    the same orchestrator never re-executes a cacheable step."""
    p = dict(p, failures=[])
    spec, orch, _, calls = build(p)
    orch.execute(spec)
    before = dict(calls)
    rec2 = orch.execute(spec)
    for i, s in enumerate(spec.steps):
        r = rec2.steps[s.name]
        assert r.status == "done"
        if s.cache:
            assert r.cached and calls[i] == before[i]
        else:
            assert not r.cached and calls[i] == before[i] + 1
    assert rec2.cache_hits == sum(1 for s in spec.steps if s.cache)


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
    def test_orchestrator_invariants(params):
        run_and_check(params)

    @given(scenarios())
    def test_orchestrator_deterministic(params):
        run_twice_and_compare(params)

    @given(scenarios())
    def test_orchestrator_cache_never_reexecutes(params):
        run_cached_second_pass(params)
else:                            # visible skips instead of silent absence
    @pytest.mark.skip(reason="hypothesis not installed "
                             "(pip install -r requirements-dev.txt)")
    def test_orchestrator_invariants():
        pass

    @pytest.mark.skip(reason="hypothesis not installed "
                             "(pip install -r requirements-dev.txt)")
    def test_orchestrator_deterministic():
        pass

    @pytest.mark.skip(reason="hypothesis not installed "
                             "(pip install -r requirements-dev.txt)")
    def test_orchestrator_cache_never_reexecutes():
        pass


# -- seeded numpy fallback (always runs) -------------------------------------

def params_from_seed(seed):
    rng = np.random.default_rng(seed)
    return scenario(lambda lo, hi: int(rng.integers(lo, hi + 1)),
                    lambda seq: seq[int(rng.integers(len(seq)))],
                    lambda lo, hi: float(rng.uniform(lo, hi)))


@pytest.mark.parametrize("seed", range(30))
def test_orchestrator_invariants_seeded(seed):
    run_and_check(params_from_seed(seed))


@pytest.mark.parametrize("seed", range(8))
def test_orchestrator_deterministic_seeded(seed):
    run_twice_and_compare(params_from_seed(seed + 500))


@pytest.mark.parametrize("seed", range(8))
def test_orchestrator_cache_seeded(seed):
    run_cached_second_pass(params_from_seed(seed + 900))
