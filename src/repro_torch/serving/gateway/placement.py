"""Multi-cloud placement planner (the port's copy of
``repro.serving.gateway.placement``; automated placement, MLModelCI analog --
arXiv:2006.05096): assign models to cloud profiles to minimize cost or p99
under per-cloud replica capacity.  With ``split=True`` an assignment may
SPREAD one model across several clouds -- fractional traffic shares backed
by per-cloud replica counts -- which is what the router's active-active
mode (serving/gateway/router.py) consumes.

Sizing is queueing-theoretic, not simulated: a model offering
``rate * service_time`` Erlangs needs ``ceil(load / target_util)`` replicas,
and its latency estimate inflates service time by an M/M/1-style waiting
term per replica.  The plan's capacity map feeds Gateway(capacity=...) so
the discrete-event simulation enforces what the planner assumed.

``diff_plans(old, new)`` emits a MigrationPlan -- the per-model weight /
replica deltas between two plans -- which ``Gateway.run(migrations=[
MigrationSpec(at_s, plan)])`` applies live, mid-run, without dropping
requests (drain-and-shift, router.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ...clouds.profiles import CloudProfile

TARGET_UTILIZATION = 0.7


@dataclasses.dataclass(frozen=True)
class ModelDemand:
    name: str
    rate: float                  # expected offered load, req/s
    service_time_s: float        # per-request service time at typical batch
    # disaggregated demand: split the per-request cost into the
    # compute-bound prompt-ingest phase and the bandwidth-bound decode
    # phase so a planner can size prefill and decode tiers separately.
    # When both are set they OVERRIDE service_time_s for load purposes
    # (effective per-request time = prefill_s + decode_s); left at None
    # the blended single-phase model is unchanged.
    prefill_s: Optional[float] = None    # compute: serial prompt ingest
    decode_s: Optional[float] = None     # bandwidth: generation steps

    @property
    def effective_service_s(self) -> float:
        if self.prefill_s is not None and self.decode_s is not None:
            return self.prefill_s + self.decode_s
        return self.service_time_s

    @property
    def load(self) -> float:
        return self.rate * self.effective_service_s   # Erlangs

    @property
    def prefill_load(self) -> float:
        """Erlangs of prompt-ingest compute (0 when not disaggregated)."""
        return self.rate * (self.prefill_s or 0.0)

    @property
    def decode_load(self) -> float:
        """Erlangs of generation bandwidth (full load when blended)."""
        if self.prefill_s is not None and self.decode_s is not None:
            return self.rate * self.decode_s
        return self.load


@dataclasses.dataclass(frozen=True)
class CloudCapacity:
    profile: CloudProfile
    max_replicas: int
    cost_per_replica_hr: Optional[float] = None  # None: profile price sheet

    @property
    def replica_cost_hr(self) -> float:
        if self.cost_per_replica_hr is not None:
            return self.cost_per_replica_hr
        return self.profile.cost_per_s * 3600.0


def replicas_needed(demand: ModelDemand, *,
                    target_util: float = TARGET_UTILIZATION) -> int:
    # the 1e-9 slack absorbs float noise in the Erlang arithmetic: a rate
    # derived as k*util/t then multiplied back by t can land a hair above
    # k*util and must not round up to an extra replica
    return max(1, math.ceil(demand.load / target_util - 1e-9))


def est_wait_s(demand: ModelDemand, replicas: int) -> float:
    """Expected steady-state queueing wait (M/M/1-style, per replica) --
    the planner's expected-queue hint.  An Assignment carries one per
    cloud; the router's queue-aware `_route` uses it as a prior for pools
    that have no live queue signal yet (Gateway.deploy(queue_hint=...)).
    inf when saturated, same rule as est_p99_s."""
    if replicas <= 0:
        return math.inf
    rho = demand.load / replicas
    if rho >= 1.0:
        return math.inf
    return demand.effective_service_s * rho / (1.0 - rho)


def est_p99_s(profile: CloudProfile, demand: ModelDemand,
              replicas: int) -> float:
    """rtt + lb + service + 3x an M/M/1-style waiting term at per-replica
    utilization rho -- a tail estimate, deliberately coarse (the gateway
    simulation is the ground truth; this only has to rank clouds).

    Saturated assignments (rho >= 1, or no replicas at all) have no finite
    tail: the queue grows without bound, so the estimate is inf, never a
    misleading finite number."""
    wait = est_wait_s(demand, replicas)
    if not math.isfinite(wait):
        return math.inf
    return (profile.network_rtt_s + profile.lb_overhead_s
            + demand.effective_service_s + 3.0 * wait)


@dataclasses.dataclass
class Assignment:
    """One model's placement: per-cloud replica shares plus the traffic
    weights the router should split arrivals by.  A single-cloud placement
    is the degenerate one-entry case; ``shares == {}`` means unplaceable
    under capacity.  Weights always sum to 1 for a placed model.
    ``est_wait_s`` is the per-cloud expected-queue hint (steady-state
    queueing wait at the planned utilization) that feeds
    Gateway.deploy(queue_hint=...) for queue-aware routing."""
    model: str
    shares: dict                 # cloud -> replicas (int)
    weights: dict                # cloud -> traffic fraction
    est_p99_s: float             # worst share's tail estimate
    cost_hr: float
    est_wait_s: dict = dataclasses.field(default_factory=dict)

    @property
    def cloud(self) -> Optional[str]:
        """Primary cloud (largest traffic weight); None when unplaceable."""
        if not self.shares:
            return None
        return max(self.weights, key=lambda c: (self.weights[c], c))

    @property
    def replicas(self) -> int:
        return sum(self.shares.values())

    @property
    def saturated(self) -> bool:
        """True when the assignment offers no finite latency bound
        (unplaced, zero replicas, or utilization >= 1)."""
        return not math.isfinite(self.est_p99_s)


def _single(model: str, cloud: Optional[str], replicas: int,
            p99: float, cost: float, wait: float = math.inf) -> Assignment:
    if cloud is None:
        return Assignment(model, {}, {}, math.inf, 0.0)
    return Assignment(model, {cloud: replicas}, {cloud: 1.0}, p99, cost,
                      {cloud: wait})


@dataclasses.dataclass
class PlacementPlan:
    objective: str
    assignments: list
    feasible: bool
    clouds: list = dataclasses.field(default_factory=list)  # CloudCapacity
    split: bool = False          # planner allowed multi-cloud assignments

    @property
    def total_cost_hr(self) -> float:
        return sum(a.cost_hr for a in self.assignments if a.shares)

    @property
    def worst_p99_s(self) -> float:
        """Worst estimated tail over the whole plan.  A saturated or
        unplaced assignment makes this inf: an infeasible plan must not
        report the finite tail of whatever happened to fit."""
        if any(a.saturated for a in self.assignments):
            return math.inf
        return max((a.est_p99_s for a in self.assignments if a.shares),
                   default=0.0)

    def capacity_map(self) -> dict:
        """Planned replica budget per cloud, ready for Gateway(capacity=...)."""
        out: dict = {}
        for a in self.assignments:
            for cloud, n in a.shares.items():
                out[cloud] = out.get(cloud, 0) + n
        return out

    def summary(self) -> dict:
        fin = lambda x: round(x, 6) if math.isfinite(x) else "inf"
        return {"objective": self.objective, "feasible": self.feasible,
                "split": self.split,
                "total_cost_hr": round(self.total_cost_hr, 4),
                "worst_p99_s": fin(self.worst_p99_s),
                "assignments": {a.model: {
                    "cloud": a.cloud, "replicas": a.replicas,
                    "est_p99_s": fin(a.est_p99_s),
                    "saturated": a.saturated,
                    "cost_hr": round(a.cost_hr, 4),
                    **({"est_wait_s": {c: fin(w)
                                       for c, w in a.est_wait_s.items()}}
                       if a.est_wait_s else {}),
                    **({"shares": dict(a.shares),
                        "weights": {c: round(w, 6)
                                    for c, w in a.weights.items()}}
                       if len(a.shares) > 1 else {})}
                    for a in self.assignments}}


def _split_assign(d: ModelDemand, need: int, clouds: list,
                  remaining: dict, objective: str) -> Optional[Assignment]:
    """Fill the ranked clouds first-to-last until the replica need is met,
    splitting the model when the best cloud alone cannot hold it.  Traffic
    weights are proportional to replica shares, so per-pool utilization is
    uniform and the share-weighted tail estimate stays honest."""
    def rank(c):
        p99 = est_p99_s(c.profile, d, need)
        cost = c.replica_cost_hr
        return ((cost, p99, c.profile.name) if objective == "cost"
                else (p99, cost, c.profile.name))

    shares: dict = {}
    left = need
    for c in sorted(clouds, key=rank):
        take = min(remaining[c.profile.name], left)
        if take <= 0:
            continue
        shares[c.profile.name] = take
        left -= take
        if left == 0:
            break
    if left > 0:                 # does not fit anywhere: leave capacity alone
        return None
    by_name = {c.profile.name: c for c in clouds}
    weights = {cl: n / need for cl, n in shares.items()}
    # a mixture's tail is pinned by its SLOWEST share as soon as that share
    # holds more than ~1% of traffic, so the estimate is the max over
    # pools, never a weight-average that would under-report it
    # replace() keeps the prefill/decode split (when set) attached to each
    # share, so disaggregated demand prices identically across pools
    est = max(est_p99_s(
        by_name[cl].profile,
        dataclasses.replace(d, rate=d.rate * weights[cl]), n)
        for cl, n in shares.items())
    waits = {cl: est_wait_s(
        dataclasses.replace(d, rate=d.rate * weights[cl]), n)
        for cl, n in shares.items()}
    cost = sum(n * by_name[cl].replica_cost_hr for cl, n in shares.items())
    for cl, n in shares.items():
        remaining[cl] -= n
    return Assignment(d.name, shares, weights, est, cost, waits)


def plan_placement(models: list, clouds: list, objective: str = "cost", *,
                   split: bool = False) -> PlacementPlan:
    """Greedy by offered load, heaviest model first: each model takes the
    feasible cloud minimizing (cost, p99) or (p99, cost).  Greedy is exact
    enough at fleet sizes where this repo runs (tens of models, few clouds)
    and keeps the plan explainable.

    split=True allows fractional assignments: a model fills the ranked
    clouds in order, spilling onto the next when capacity runs out, and the
    plan records per-cloud traffic weights for the router's active-active
    splitter.  A fleet that is infeasible single-cloud can be feasible
    split (the capacity fragments add up)."""
    assert objective in ("cost", "p99")
    remaining = {c.profile.name: c.max_replicas for c in clouds}
    assignments, feasible = [], True
    for d in sorted(models, key=lambda d: d.load, reverse=True):
        need = replicas_needed(d)
        if split:
            a = _split_assign(d, need, clouds, remaining, objective)
            if a is None:
                feasible = False
                a = _single(d.name, None, 0, math.inf, 0.0)
            assignments.append(a)
            continue
        best = None
        for c in clouds:
            if remaining[c.profile.name] < need:
                continue
            p99 = est_p99_s(c.profile, d, need)
            cost = need * c.replica_cost_hr
            key = (cost, p99) if objective == "cost" else (p99, cost)
            if best is None or key < best[0]:
                best = (key, c, p99, cost)
        if best is None:
            feasible = False
            assignments.append(_single(d.name, None, 0, math.inf, 0.0))
            continue
        _, c, p99, cost = best
        remaining[c.profile.name] -= need
        assignments.append(_single(d.name, c.profile.name, need, p99, cost,
                                   est_wait_s(d, need)))
    return PlacementPlan(objective, assignments, feasible,
                         clouds=list(clouds), split=split)


# -- plan diffs: the live-migration contract ---------------------------------

@dataclasses.dataclass(frozen=True)
class MigrationStep:
    """Target state for ONE model: the traffic weights the router should
    shift to (sum to 1), the planned per-cloud replica counts (a sizing
    hint for relaunches), and the CloudProfiles backing any cloud the
    deployment has not seen before."""
    model: str
    weights: dict                # cloud -> target traffic fraction
    replicas: dict               # cloud -> planned replicas
    profiles: dict               # cloud -> CloudProfile

    def __post_init__(self):
        if not self.weights or any(w < 0 for w in self.weights.values()):
            raise ValueError(f"{self.model}: weights must be non-negative "
                             f"and non-empty, got {self.weights}")
        total = sum(self.weights.values())
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"{self.model}: migration weights must sum "
                             f"to 1, got {total}")
        missing = set(self.weights) - set(self.profiles)
        if missing:
            raise ValueError(f"{self.model}: no CloudProfile for "
                             f"{sorted(missing)}")


@dataclasses.dataclass
class MigrationPlan:
    """The diff between two PlacementPlans: one MigrationStep per model
    whose split changed.  Applied live by the router (drain-and-shift)."""
    steps: list

    @property
    def models(self) -> list:
        return [s.model for s in self.steps]

    def summary(self) -> dict:
        return {s.model: {"weights": {c: round(w, 6)
                                      for c, w in s.weights.items()},
                          "replicas": dict(s.replicas)}
                for s in self.steps}


def diff_plans(old: PlacementPlan, new: PlacementPlan) -> MigrationPlan:
    """Per-model weight/replica deltas between two plans.  Models placed
    identically in both plans are omitted; a model unplaceable in ``new``
    is omitted too (there is no routable target to shift it to -- the
    plan's ``feasible`` flag already says so)."""
    profiles = {c.profile.name: c.profile
                for c in list(old.clouds) + list(new.clouds)}
    old_by = {a.model: a for a in old.assignments}
    steps = []
    for a in new.assignments:
        if not a.shares:
            continue
        o = old_by.get(a.model)
        if o is not None and o.shares == a.shares and o.weights == a.weights:
            continue
        steps.append(MigrationStep(
            a.model, dict(a.weights), dict(a.shares),
            {c: profiles[c] for c in a.shares}))
    return MigrationPlan(steps)


def replan(plan: PlacementPlan, result, *, clouds: Optional[list] = None,
           objective: Optional[str] = None,
           split: Optional[bool] = None,
           alerts: Optional[set] = None,
           alert_headroom: float = 1.25) -> PlacementPlan:
    """Re-plan from OBSERVED load (closing the estimate -> measure ->
    re-plan loop, MLModelCI analog): each model's demand is rebuilt from
    the arrival rate and realized per-request service time the gateway
    measured (ServeResult.observed / gateway:observed events), then placed
    again under the same clouds and objective.

    ``result`` is a GatewayResult from Gateway.run; ``clouds`` defaults to
    the CloudCapacity list the original plan was built against; ``split``
    defaults to whatever the original plan allowed.  Models in the original
    plan that saw no traffic this window (Gateway.run omits them from
    per_model) keep their prior assignment: their replicas stay reserved,
    so the revised capacity_map still covers the whole fleet.

    ``alerts`` is a set of model names under an SLO burn-rate alert
    (telemetry/slo.py: BurnRateMonitor.alerting_models(), or the models in
    the run's ``gateway:alert`` events): the observed rate alone UNDERSTATES
    their demand (it is what the overloaded fleet managed to absorb, sheds
    included only as a count), so their demand is inflated by
    ``alert_headroom`` before placement."""
    clouds = list(clouds) if clouds is not None else list(plan.clouds)
    if not clouds:
        raise ValueError("replan needs the CloudCapacity list: the original "
                         "plan carries none (pass clouds=...)")
    if alert_headroom < 1.0:
        raise ValueError("alert_headroom must be >= 1")
    demands = []
    for name in sorted(result.per_model):
        obs = result.per_model[name].observed
        if not obs:
            raise ValueError(f"no observed load for {name!r}: run the "
                             "traffic through Gateway.run first")
        rate = obs["rate_rps"]
        if alerts and name in alerts:
            rate *= alert_headroom
        demands.append(ModelDemand(name, rate,
                                   obs["service_time_s"]))
    kept = [a for a in plan.assignments if a.model not in result.per_model]
    reserve: dict = {}
    for a in kept:
        for cloud, n in a.shares.items():
            reserve[cloud] = reserve.get(cloud, 0) + n
    shrunk = [dataclasses.replace(
        c, max_replicas=c.max_replicas - reserve.get(c.profile.name, 0))
        for c in clouds]
    new = plan_placement(demands, shrunk, objective=objective
                         or plan.objective,
                         split=plan.split if split is None else split)
    new.assignments.extend(kept)
    new.feasible = new.feasible and all(a.shares for a in kept)
    new.clouds = clouds                  # report the REAL budgets, not the
    return new                           # reservation-shrunk ones
