"""Model-CI profiling plane (DESIGN.md S9, MLModelCI analog): measured,
versioned per-(model, cloud) profile artifacts produced by ``kind=
"profile"`` pipeline steps, stored content-hashed in the pipelines
ArtifactCache, consumed by placement (``ProfileStore.demand`` ->
``ModelDemand``) and watched at serving time by the drift monitor
(telemetry/drift.py).  Every demand number in the system becomes a
measured, monitored quantity.  The port's copy of ``repro.modelci``, without
``roofline_fields`` (``modelci.profile.roofline_fields`` raises: ROADMAP.md
queue 1 item 1.10)."""
import dataclasses
from typing import Any, Optional

from .backends import ProfiledBackend
from .profile import ModelProfile, ProfileStore, finalize, measure


@dataclasses.dataclass
class ProfileSpec:
    """Payload for a ``kind="profile"`` pipeline step.  The step's fn is
    the MEASUREMENT: it returns the raw profile field dict (``measure``/
    ``roofline_fields`` -- JSON-able, so recurring runs cache it), and
    the orchestrator commits the (model, cloud)-stamped ``ModelProfile``
    into ``store`` when the step completes -- cached completions
    included, so a cache-hit recurring firing still refreshes the
    store's ``latest`` pointer."""
    model: str
    store: ProfileStore
    max_batch: int = 32

    def __post_init__(self):
        if not self.model:
            raise ValueError("profile step needs a model name")
        if not hasattr(self.store, "put"):
            raise ValueError("profile step needs a ProfileStore")


__all__ = ["ModelProfile", "ProfileSpec", "ProfileStore", "ProfiledBackend",
           "finalize", "measure"]
