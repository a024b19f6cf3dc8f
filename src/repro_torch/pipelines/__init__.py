"""Multi-cloud pipeline orchestrator (Kubeflow-Pipelines control-plane
analog): discrete-event scheduling of compiled step DAGs onto simulated
per-cloud worker pools (scheduler.py), recurring / fault-tolerant runs
with retries and exactly-once completion (runs.py), a cross-run
cloud-local artifact cache with transfer-cost accounting (artifacts.py),
and a terminal deploy step that hands the trained model to the serving
gateway.  See DESIGN.md §4.  The port's copy of ``repro.pipelines``,
over the port's event engine, gateway, placement, capacity market and
telemetry."""
from .artifacts import (ArtifactCache, CacheEntry, best_transfer,
                        payload_bytes, transfer_cost_usd, transfer_time_s)
from .runs import PipelineRuns, RetryPolicy, RunRecord, StepRecord
from .scheduler import DeploySpec, Orchestrator

__all__ = [
    "ArtifactCache", "CacheEntry", "best_transfer", "payload_bytes",
    "transfer_cost_usd", "transfer_time_s",
    "PipelineRuns", "RetryPolicy", "RunRecord", "StepRecord",
    "DeploySpec", "Orchestrator",
]
