"""Model-mesh serving gateway, the port's counterpart of
``repro.serving.gateway``: multi-model routing with SLO classes,
preemption, active-active multi-cloud splits, queue-aware weighted-JSQ
routing + per-class admission control (load shedding) and live migration
(router.py), cost-aware scale-to-zero autoscaling (autoscaler.py),
split-aware multi-cloud placement + expected-queue hints + observed-load
re-planning + plan diffs (placement.py).  See DESIGN.md §Gateway."""
from .autoscaler import Autoscaler, AutoscalerConfig, PoolView
from .placement import (Assignment, CloudCapacity, MigrationPlan,
                        MigrationStep, ModelDemand, PlacementPlan, diff_plans,
                        est_p99_s, est_wait_s, plan_placement, replan,
                        replicas_needed)
from .router import (SLO_CLASSES, AdmissionConfig, BatcherBackend, Deployment,
                     DisaggSpec, FailureSpec, Gateway, GatewayResult,
                     MigrationSpec, Predictor, ReplanConfig, RoutingConfig,
                     ServeResult, SLOClass, TrafficSpec, resolve_slo)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "PoolView",
    "Assignment", "CloudCapacity", "MigrationPlan", "MigrationStep",
    "ModelDemand", "PlacementPlan", "diff_plans", "est_p99_s", "est_wait_s",
    "plan_placement", "replan", "replicas_needed",
    "AdmissionConfig", "BatcherBackend", "Deployment", "DisaggSpec",
    "FailureSpec", "Gateway", "GatewayResult", "MigrationSpec", "Predictor",
    "ReplanConfig", "RoutingConfig", "ServeResult", "SLOClass",
    "SLO_CLASSES", "TrafficSpec", "resolve_slo",
]
