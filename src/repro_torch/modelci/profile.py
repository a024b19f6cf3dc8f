"""Measured, versioned model profiles: the Model-CI artifact schema
(DESIGN.md S9, MLModelCI analog -- continuous benchmarking as a service).

A ``ModelProfile`` is ONE measurement record per (model, cloud): the
per-request service time a placement planner needs, the prefill/decode
split when the backend exposes the two-point measurement
(``BatcherBackend.prefill_time``/``decode_time``), the memory footprint,
the cold model-load cost, and the roofline terms that explain WHERE the
service time comes from.  Profiles are content-hashed (``key``) so two
identical measurements dedupe and any change re-versions the artifact.

``ProfileStore`` keeps profiles inside a pipelines ``ArtifactCache`` --
the same content-addressed, residency-aware store the orchestrator's step
artifacts live in -- so profile artifacts obey the exact cloud-residency
and egress-pricing rules every other artifact does (``pull`` prices a
cross-cloud move with ``artifacts.best_transfer`` and commits the new
residency).  ``demand()`` is the profile -> ``ModelDemand`` bridge: every
demand number the placement planner sees becomes a measured quantity.

Measurement split (DESIGN.md S1): ``measure()`` wall-clocks a real
backend on this host; ``roofline_fields()`` derives an analytic profile
from an ArchConfig + HardwareSpec with no compilation (the registry-model
path: ``model_flops`` and the weight-streaming bytes bound are closed
forms of the config).  Cloud-specific terms (``load_s``) are CloudProfile
constants stamped at commit time -- the host measurement is
cloud-independent, the constants are not.

The port's copy of ``repro.modelci.profile``: ``measure`` sizes the weights
through the port's ``payload_bytes`` (tensor leaves included);
``roofline_fields`` is the reference's closed form over the port's
``launch/roofline.py`` and a ``HardwareSpec`` (default: the H100 SXM).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Optional

from ..clouds.profiles import H100_SXM, PROFILES, CloudProfile, HardwareSpec
from ..launch.roofline import model_flops, roofline
from ..pipelines.artifacts import (ArtifactCache, best_transfer,
                                   payload_bytes)
from ..serving.gateway.placement import ModelDemand


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """One measured profile artifact: (model, cloud) -> the numbers
    placement and drift detection consume.  ``service_time_s`` is the
    PER-REQUEST service time at ``max_batch`` (the planner's unit);
    ``prefill_s``/``decode_s`` split it when the backend is
    disaggregated.  JSON-able end to end (``value_cacheable``), so the
    artifact persists through the shared cache machinery."""
    model: str
    cloud: str
    service_time_s: float
    max_batch: int = 1
    prefill_s: Optional[float] = None
    decode_s: Optional[float] = None
    memory_bytes: int = 0
    load_s: float = 0.0                  # cold model load on this cloud
    roofline: Optional[dict] = None      # RooflineTerms.as_dict(), if known
    source: str = "measured"             # measured | roofline

    def __post_init__(self):
        if self.service_time_s <= 0 or not math.isfinite(self.service_time_s):
            raise ValueError(f"{self.model}: service_time_s must be a "
                             f"positive finite measurement, "
                             f"got {self.service_time_s}")
        if (self.prefill_s is None) != (self.decode_s is None):
            raise ValueError(f"{self.model}: prefill_s and decode_s come "
                             "from one two-point measurement; set both "
                             "or neither")

    @property
    def effective_service_s(self) -> float:
        if self.prefill_s is not None and self.decode_s is not None:
            return self.prefill_s + self.decode_s
        return self.service_time_s

    @property
    def key(self) -> str:
        """Content-hash version: any field change re-keys the artifact
        (the ``step_cache_key`` discipline, applied to measurements)."""
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return "profile_" + hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # canonical float rounding so a re-measurement that agrees to
        # float noise hashes identically only when truly identical, but
        # the JSON never carries repr jitter
        for k in ("service_time_s", "prefill_s", "decode_s", "load_s"):
            if d[k] is not None:
                d[k] = float(d[k])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ModelProfile":
        return cls(**{f.name: d.get(f.name, f.default)
                      for f in dataclasses.fields(cls)})

    def demand(self, *, rate: Optional[float] = None,
               load_erlangs: Optional[float] = None) -> ModelDemand:
        """The profile -> planner bridge for ONE cloud's numbers."""
        if (rate is None) == (load_erlangs is None):
            raise ValueError("set exactly one of rate / load_erlangs")
        if rate is None:
            rate = load_erlangs / self.effective_service_s
        return ModelDemand(self.model, rate, self.service_time_s,
                           prefill_s=self.prefill_s,
                           decode_s=self.decode_s)


# -- measurement --------------------------------------------------------------

def measure(backend, *, max_batch: int = 32,
            weights: Any = None) -> dict:
    """Measure a live backend into the raw profile FIELD dict (JSON-able,
    cloud-agnostic -- a profile step's fn returns exactly this, so the
    measurement caches across recurring runs).  Uses the backend's own
    measured cost models: ``service_time(max_batch)`` for the blended
    per-request time, plus ``prefill_time``/``decode_time`` when the
    backend carries the two-point disaggregated measurement
    (``BatcherBackend``)."""
    svc = backend.service_time(max_batch) / max_batch
    fields: dict = {"service_time_s": float(svc),
                    "max_batch": int(max_batch),
                    "source": "measured"}
    if hasattr(backend, "prefill_time") and hasattr(backend, "decode_time"):
        fields["prefill_s"] = float(backend.prefill_time())
        fields["decode_s"] = float(backend.decode_time())
    if weights is not None:
        fields["memory_bytes"] = payload_bytes(weights)
    return fields


def roofline_fields(cfg, *, shape_kind: str = "decode", batch: int = 1,
                    seq: int = 1, gen_tokens: int = 32, chips: int = 1,
                    hw: HardwareSpec = H100_SXM) -> dict:
    """Analytic profile fields for a registry ArchConfig, no compilation:
    compute from ``model_flops`` (closed form of the config), memory from
    streaming the active weights once per token (the decode bandwidth
    bound), zero collective bytes per chip at chips=1.  A decode-shaped
    request costs ``gen_tokens`` roofline-bound steps.  This is the
    zero-hand-tuned-numbers path: every term derives from the config and
    the HardwareSpec constants."""
    per_tok_flops = model_flops(cfg, shape_kind, batch, seq) / chips
    weight_bytes = 2.0 * cfg.approx_active_params() / chips   # bf16 stream
    terms = roofline(per_tok_flops, weight_bytes, 0.0, chips, hw=hw)
    svc = terms.total_s * gen_tokens / max(batch, 1)
    return {"service_time_s": float(svc),
            "max_batch": int(batch),
            "memory_bytes": int(2 * cfg.approx_active_params()),
            "roofline": terms.as_dict(),
            "source": "roofline"}


def finalize(fields: dict, model: str, cloud: CloudProfile) -> ModelProfile:
    """Stamp cloud-agnostic measured fields into the (model, cloud)
    artifact: the cold-load cost is the ONE cloud-specific constant
    (CloudProfile.model_load_s), applied at commit time."""
    return ModelProfile(model=model, cloud=cloud.name,
                        load_s=float(cloud.model_load_s), **fields)


# -- the store ----------------------------------------------------------------

class ProfileStore:
    """Content-addressed profile artifacts over a pipelines ArtifactCache.

    ``put`` writes the profile's dict under its content-hash key with the
    producing cloud as residency (the exact ``ArtifactCache.put`` rules,
    so an ArtifactStore-backed cache persists profiles across processes);
    ``latest`` tracks the newest key per (model, cloud) so re-profiles
    supersede without destroying history.  ``pull`` prices moving a
    profile to a consuming cloud through ``best_transfer`` -- the one
    shared egress rule -- and commits the new residency.
    """

    def __init__(self, cache: Optional[ArtifactCache] = None):
        self.cache = cache if cache is not None else ArtifactCache()
        self.latest: dict[tuple, str] = {}   # (model, cloud) -> cache key

    def put(self, profile: ModelProfile):
        key = profile.key
        entry = self.cache.entries.get(key)
        if entry is None:
            entry = self.cache.put(key, profile.to_dict(),
                                   f"profile:{profile.model}", profile.cloud)
        else:                            # identical re-measurement: dedupe,
            entry.clouds.add(profile.cloud)   # extend residency
        self.latest[(profile.model, profile.cloud)] = key
        return entry

    def get(self, model: str, cloud: str) -> Optional[ModelProfile]:
        key = self.latest.get((model, cloud))
        if key is None:
            return None
        entry = self.cache.get(key)
        if entry is None:
            return None
        return ModelProfile.from_dict(entry.value)

    def clouds(self, model: str) -> list:
        return sorted(c for m, c in self.latest if m == model)

    def models(self) -> list:
        return sorted({m for m, _ in self.latest})

    def pull(self, model: str, cloud: str, dst: CloudProfile,
             profiles: Optional[dict] = None):
        """Make (model, cloud)'s artifact resident on ``dst``; returns
        (entry, transfer_s, egress_usd) -- (entry, 0, 0) when dst already
        holds a copy.  Pricing and source choice are ``best_transfer``'s,
        residency commit is ``commit_transfer``'s: profiles are ordinary
        artifacts under the ordinary rules."""
        key = self.latest.get((model, cloud))
        entry = self.cache.get(key) if key else None
        if entry is None:
            raise KeyError(f"no profile for ({model!r}, {cloud!r})")
        move = best_transfer(entry.clouds, entry.nbytes, dst,
                             profiles or PROFILES)
        if move is None:
            return entry, 0.0, 0.0
        _src, t_s, usd = move
        self.cache.commit_transfer(entry, dst.name)
        return entry, t_s, usd

    def worst(self, model: str, clouds: Optional[list] = None) -> ModelProfile:
        """The committed profile with the LARGEST effective service time
        among ``clouds`` (names; default: every profiled cloud) -- the
        conservative pick a split placement sizes against."""
        names = clouds if clouds is not None else self.clouds(model)
        profs = [p for p in (self.get(model, c) for c in names)
                 if p is not None]
        if not profs:
            raise KeyError(f"no profile artifacts for {model!r} on "
                           f"{list(names)!r}: run the profiling DAG first")
        return max(profs, key=lambda p: p.effective_service_s)

    def demand(self, model: str, *, rate: Optional[float] = None,
               load_erlangs: Optional[float] = None,
               clouds: Optional[list] = None) -> ModelDemand:
        """Build the planner's ModelDemand from committed profiles.  With
        several per-cloud profiles the WORST (largest) service time wins:
        a split placement must not under-provision its slowest share.
        ``clouds`` restricts to the placement's candidate clouds (cloud
        names); profiles must exist for at least one."""
        return self.worst(model, clouds).demand(rate=rate,
                                                load_erlangs=load_erlangs)
