"""Model-mesh serving gateway: counterpart of ``repro.serving.gateway``.

Ported: the router's single-deployment part (queue-aware split routing,
per-class admission control, SLO classes and preemption, canaries, both
engines; router.py) and the cost-aware scale-to-zero autoscaler
(autoscaler.py).  Placement, failover, migration, re-planning,
disaggregation and the telemetry plane follow with ROADMAP.md queue 1 item
1.3's second slice."""
from .autoscaler import Autoscaler, AutoscalerConfig, PoolView
from .router import (SLO_CLASSES, AdmissionConfig, BatcherBackend, Deployment,
                     Gateway, GatewayResult, Predictor, RoutingConfig,
                     ServeResult, SLOClass, TrafficSpec, resolve_slo)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "PoolView",
    "AdmissionConfig", "BatcherBackend", "Deployment", "Gateway",
    "GatewayResult", "Predictor", "RoutingConfig", "ServeResult", "SLOClass",
    "SLO_CLASSES", "TrafficSpec", "resolve_slo",
]
