"""The serving gateway: counterpart of ``repro.serving.gateway``.  Only
``BatcherBackend``, the adapter that measures a ``ContinuousBatcher``, is
ported so far; the router, autoscaler and placement follow (ROADMAP.md
queue 1 item 1.3)."""
from .router import BatcherBackend

__all__ = ["BatcherBackend"]
