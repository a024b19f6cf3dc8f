"""Kubeflow-Pipelines analog: typed component DAG with artifact passing,
content-hash step caching, per-stage telemetry, and YAML spec export.

The paper's workflow (its Fig. 14: func_to_container_op -> pipeline) maps to:

    pipe = Pipeline("e2e-mnist", store)
    data  = pipe.step(download_data)
    prep  = pipe.step(preprocess, data)
    tuned = pipe.step(tune, prep)
    model = pipe.step(train, prep, tuned)
    pipe.step(serve_eval, model)
    result = pipe.run()

Components are plain python functions ("lightweight components"); the
framework contributes orchestration: dependency resolution, caching (re-use
of components, a headline Kubeflow feature), artifact lineage, stage timing
(Tables 4/5), and a serialized pipeline spec -- the analog of the paper's
`minikf_generated_gcp.yaml`.

This module is the AUTHORING front-end.  ``Pipeline.run()`` is the serial
in-process executor (every step on the calling thread, wall-clock timing);
``Pipeline.compile()`` lowers the same DAG into a ``PipelineSpec`` that the
multi-cloud orchestrator (pipelines.scheduler.Orchestrator) schedules
onto simulated per-cloud clusters -- parallel branches, retries, artifact
transfer accounting, and a terminal ``kind="deploy"`` step that hands the
trained model to the serving gateway.  Both executors share the
content-hash cache keys (``step_cache_key``), so a step cached by one is a
cache hit for the other.

The port's copy of ``repro.core.pipeline``, over the port's store: a tree
of tensors hashes through the port's ``tree_hash`` (host copies of its
leaves), so ``value_hash`` keys it by content.  PyYAML is imported where
the spec is exported, so the rest runs without it.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import inspect
import time
from typing import Any, Callable, Optional

from ..checkpoint.store import ArtifactStore, tree_hash
from ..telemetry.events import EventLog


@dataclasses.dataclass
class StepRef:
    """Handle to a pipeline step; resolves to its output at execution."""
    name: str
    index: int


class Step:
    def __init__(self, name: str, fn: Callable, args: tuple, kwargs: dict,
                 cache: bool = True, kind: str = "compute",
                 payload: Any = None, sim_s: Optional[float] = None,
                 pin: Optional[str] = None):
        self.name = name
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.cache = cache
        self.kind = kind                 # "compute" | "deploy" | "profile"
        self.payload = payload           # kind-specific config (DeploySpec
        # for deploy, modelci.ProfileSpec for profile)
        self.sim_s = sim_s               # analytic simulated compute seconds
        self.pin = pin                   # force this cloud (orchestrator)
        self.output: Any = None
        self.cached = False
        self.duration_s: float = 0.0

    def deps(self) -> list:
        out = []
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, StepRef):
                out.append(a.index)
        return out


def value_hash(v: Any) -> str:
    try:
        if hasattr(v, "dtype") or isinstance(v, (dict, list, tuple)):
            return tree_hash(v)
        return hashlib.sha256(repr(v).encode()).hexdigest()[:16]
    except Exception:
        return "unhashable"


_value_hash = value_hash                 # backward-compatible alias


def step_cache_key(pipeline: str, step_name: str, fn: Callable,
                   args, kwargs) -> str:
    """Content-hash cache key over (pipeline, step, fn source, resolved
    inputs).  Shared by the serial executor and the orchestrator
    (pipelines/), so the two reuse each other's cached artifacts."""
    h = hashlib.sha256()
    h.update(pipeline.encode())
    h.update(step_name.encode())
    try:
        h.update(inspect.getsource(fn).encode())
    except (OSError, TypeError):
        # source unavailable (REPL/lambda): fall back to a stable name,
        # never repr() (contains memory addresses -> cache always misses)
        h.update(f"{getattr(fn, '__module__', '')}."
                 f"{getattr(fn, '__qualname__', str(fn))}".encode())
    for a in list(args) + sorted(kwargs.items(), key=str):
        h.update(value_hash(a).encode())
    return "cache_" + h.hexdigest()[:16]


def value_cacheable(v: Any) -> bool:
    """Whether a step output can be persisted in the JSON store record.
    The ONE predicate shared by the serial executor and the orchestrator's
    ArtifactCache -- a drift here would silently desynchronize their
    shared cache."""
    return isinstance(v, (str, int, float, list, dict, type(None)))


def cache_record(value: Any, step_name: str, clouds=(), nbytes=None) -> dict:
    """The ONE on-disk cache record shape (ArtifactStore JSON), shared by
    Pipeline.run and ArtifactCache.put/commit_transfer.  ``clouds`` is the
    simulated residency ([] for the serial executor, which runs on no
    simulated cloud: the orchestrator then has no honest source to bill a
    transfer against and moves the artifact for free); ``nbytes`` is the
    measured payload size when the producer knows it."""
    cacheable = value_cacheable(value)
    rec = {"cacheable": cacheable,
           "value": value if cacheable else None,
           "step": step_name,
           "clouds": sorted(clouds)}
    if nbytes is not None:
        rec["nbytes"] = int(nbytes)
    return rec


def toposort(deps: list) -> list:
    """Deterministic Kahn's algorithm: ``deps[i]`` lists the indices step
    ``i`` depends on.  Ready nodes are seeded in insertion-index order and
    popped FIFO from a deque (O(V+E); the old list.pop(0) was O(n^2)), and
    a node's children unlock in insertion order too, so the returned order
    is a pure function of the DAG -- orchestrator schedules built on it are
    reproducible run to run and across processes."""
    n = len(deps)
    indeg = [0] * n
    adj: list = [[] for _ in range(n)]
    for i in range(n):
        for d in deps[i]:
            adj[d].append(i)
            indeg[i] += 1
    queue = collections.deque(i for i in range(n) if indeg[i] == 0)
    order = []
    while queue:
        i = queue.popleft()
        order.append(i)
        for j in adj[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                queue.append(j)
    if len(order) != n:
        raise ValueError("pipeline DAG has a cycle")
    return order


# -- compiled form (the orchestrator's input) --------------------------------

@dataclasses.dataclass
class StepSpec:
    """One compiled step: pure data, no execution state (the orchestrator
    keeps its own).  ``sim_s`` replaces the measured wall duration with an
    analytic simulated compute time (the AnalyticBackend idiom -- tests and
    benchmark replays stay host-independent); ``pin`` forces a cloud."""
    name: str
    fn: Callable
    args: tuple
    kwargs: dict
    index: int
    deps: tuple
    cache: bool = True
    kind: str = "compute"                # "compute" | "deploy" | "profile"
    payload: Any = None                  # kind-specific (pipelines.DeploySpec
    # for deploy, modelci.ProfileSpec for profile)
    sim_s: Optional[float] = None
    pin: Optional[str] = None


def _step_rows(steps: list) -> list:
    """The ONE serializer for step rows (StepSpec list -> dict rows),
    shared by Pipeline.spec() and PipelineSpec.to_dict() so the two
    exported artifacts can never drift."""
    return [{"name": s.name,
             "component": getattr(s.fn, "__name__", str(s.fn)),
             "dependencies": [steps[d].name for d in s.deps],
             "cache": s.cache,
             **({"kind": s.kind} if s.kind != "compute" else {}),
             **({"pin": s.pin} if s.pin else {})}
            for s in steps]


@dataclasses.dataclass
class PipelineSpec:
    """A compiled pipeline DAG, ready for Orchestrator.execute()."""
    name: str
    steps: list

    def to_dict(self) -> dict:
        return {
            "apiVersion": "repro/v1",
            "kind": "PipelineSpec",
            "metadata": {"name": self.name},
            "spec": {"steps": _step_rows(self.steps)},
        }


class Pipeline:
    """A DAG of components executed topologically with caching + telemetry."""

    def __init__(self, name: str, store: Optional[ArtifactStore] = None,
                 log: Optional[EventLog] = None, enable_cache: bool = True):
        self.name = name
        self.store = store
        self.log = log or EventLog()
        self.steps: list[Step] = []
        self.enable_cache = enable_cache and store is not None

    # -- authoring ----------------------------------------------------------
    def step(self, fn: Callable, *args, name: Optional[str] = None,
             cache: bool = True, kind: str = "compute", payload: Any = None,
             sim_s: Optional[float] = None, pin: Optional[str] = None,
             **kwargs) -> StepRef:
        """Add a step.  Steps sharing a function (or an explicit name) are
        deduplicated ``train``, ``train_2``, ``train_3`` ... -- the suffix
        is re-checked against every existing name, so a generated name can
        never silently collide with an explicit one (two steps sharing a
        name made ``run()``'s {name: output} dict drop the earlier output
        and let cache keys alias)."""
        if kind not in ("compute", "deploy", "profile"):
            raise ValueError(f"unknown step kind {kind!r}")
        sname = name or fn.__name__
        taken = {s.name for s in self.steps}
        if sname in taken:
            k = 2
            while f"{sname}_{k}" in taken:
                k += 1
            sname = f"{sname}_{k}"
        self.steps.append(Step(sname, fn, args, kwargs, cache,
                               kind=kind, payload=payload, sim_s=sim_s,
                               pin=pin))
        return StepRef(sname, len(self.steps) - 1)

    # -- spec export (minikf_generated_gcp.yaml analog) ---------------------
    def spec(self) -> dict:
        return {
            "apiVersion": "repro/v1",
            "kind": "Pipeline",
            "metadata": {"name": self.name},
            "spec": {"steps": _step_rows(self.compile().steps)},
        }

    def export_yaml(self, path: Optional[str] = None) -> str:
        import yaml
        text = yaml.safe_dump(self.spec(), sort_keys=False)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def compile(self) -> PipelineSpec:
        """Lower the authored DAG into the orchestrator's PipelineSpec.
        Deploy steps are never cached (the gateway handoff is a side
        effect); profile steps DO cache -- the fn's output is the raw
        measurement dict and the ProfileStore commit re-runs on cached
        completions.  The serial run() treats both as plain steps (the fn
        runs; handoff/commit are orchestrator-only semantics)."""
        return PipelineSpec(self.name, [
            StepSpec(name=s.name, fn=s.fn, args=tuple(s.args),
                     kwargs=dict(s.kwargs), index=i,
                     deps=tuple(dict.fromkeys(s.deps())),
                     cache=s.cache and s.kind != "deploy",
                     kind=s.kind, payload=s.payload, sim_s=s.sim_s,
                     pin=s.pin)
            for i, s in enumerate(self.steps)])

    # -- execution ----------------------------------------------------------
    def _resolve(self, v: Any):
        if isinstance(v, StepRef):
            return self.steps[v.index].output
        return v

    def _cache_key(self, step: Step, args, kwargs) -> str:
        return step_cache_key(self.name, step.name, step.fn, args, kwargs)

    def run(self, verbose: bool = False) -> dict:
        """Execute all steps; returns {step_name: output}."""
        order = self._toposort()
        t_start = time.perf_counter()
        for idx in order:
            step = self.steps[idx]
            args = tuple(self._resolve(a) for a in step.args)
            kwargs = {k: self._resolve(v) for k, v in step.kwargs.items()}
            key = None
            if self.enable_cache and step.cache:
                key = self._cache_key(step, args, kwargs)
                if self.store.exists(key):
                    cached = self.store.load_json(key)
                    if cached.get("cacheable", False):
                        step.output = cached["value"]
                        step.cached = True
                        self.log.record(step.name, 0.0, cached=True)
                        if verbose:
                            print(f"[{self.name}] {step.name}: cached")
                        continue
            t0 = time.perf_counter()
            step.output = step.fn(*args, **kwargs)
            step.duration_s = time.perf_counter() - t0
            self.log.record(step.name, step.duration_s, cached=False)
            if verbose:
                print(f"[{self.name}] {step.name}: {step.duration_s:.3f}s")
            if key is not None:
                self.store.save_json(key, cache_record(step.output, step.name))
        total = time.perf_counter() - t_start
        self.log.record(f"pipeline:{self.name}", total)
        return {s.name: s.output for s in self.steps}

    def _toposort(self) -> list:
        return toposort([s.deps() for s in self.steps])


def component(fn: Callable) -> Callable:
    """Marker decorator (func_to_container_op analog) -- components are
    plain functions; the decorator just tags them for spec export."""
    fn.__component__ = True
    return fn
