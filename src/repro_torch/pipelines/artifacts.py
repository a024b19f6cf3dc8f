"""Cross-run, cloud-local artifact cache with transfer-cost accounting.

Every successful orchestrator step publishes its output here under the
content-hash key from ``core.pipeline.step_cache_key`` -- the SAME key the
serial ``Pipeline.run`` cache uses, so the two executors reuse each other's
artifacts.  An entry remembers which simulated clouds hold a local copy
("cloud-local", the PVC-per-cluster analog): a step scheduled on a cloud
that does not hold one of its inputs pays a TRANSFER -- seconds over the
cross-cloud interconnect plus simulated egress dollars, both priced from
the CloudProfile fields (``interconnect_bw``, ``egress_per_gb``) -- and the
destination cloud becomes a holder once the consuming attempt completes,
so a recurring run only pays each cross-cloud move once.

Like every CloudProfile-derived number (DESIGN.md §1), transfer seconds and
egress dollars are simulation outputs, never measurements; only the
artifact SIZES are real (bytes of the actual in-memory value).

An optional ArtifactStore backs the cache on disk using the one shared
record shape (``core.pipeline.cache_record``), so cache hits survive the
process when the value is JSON-able and committed residency is never
re-billed cross-process.  An artifact written by the SERIAL executor
carries no residency (it ran on no simulated cloud): the orchestrator
reuses it with no resident cloud to serve from and no honest source to
bill a transfer against -- it moves for free, by design.

The port's copy of ``repro.pipelines.artifacts``; ``payload_bytes`` walks
trees with the store's ``tree_paths`` and sizes tensor leaves directly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..checkpoint.store import ArtifactStore, tree_paths
from ..clouds.profiles import PROFILES, CloudProfile
from ..core.pipeline import cache_record, value_cacheable


def payload_bytes(v: Any) -> int:
    """Real in-memory size of an artifact value: array leaves count their
    buffers (a tensor ``numel() * element_size()``, wherever it lives),
    everything else falls back to its repr.  This is the one MEASURED term
    in the transfer formula."""
    total = 0
    for _, leaf in tree_paths(v):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
            continue
        try:
            total += int(np.asarray(leaf).nbytes)
        except Exception:
            total += len(repr(leaf).encode())
    return total


def transfer_time_s(src: CloudProfile, dst: CloudProfile,
                    nbytes: int) -> float:
    """Seconds to move ``nbytes`` from src to dst: one control-plane RTT on
    each side plus the bytes over the narrower interconnect."""
    return (src.network_rtt_s + dst.network_rtt_s
            + nbytes / min(src.interconnect_bw, dst.interconnect_bw))


def transfer_cost_usd(src: CloudProfile, nbytes: int) -> float:
    """Simulated egress dollars: billed by the SOURCE cloud per GB sent
    (the bytes leave even if the consuming attempt later fails)."""
    return (nbytes / 1e9) * src.egress_per_gb


def best_transfer(src_clouds, nbytes: int, dst: CloudProfile,
                  profiles: dict):
    """(src_cloud, seconds, usd) for the cheapest move of ``nbytes`` onto
    ``dst`` from any of the resident ``src_clouds`` (fastest, then lowest
    egress, then name -- deterministic), or None when dst already holds a
    copy or nothing is priceable.  Egress is always billed at the SOURCE
    cloud's rate: a residency cloud missing from the caller's clusters is
    resolved from the global PROFILES sheet (a store entry written against
    a retired cluster), and only a cloud known to neither transfers for
    free -- there is nothing honest to price it against.  The ONE
    transfer-pricing rule, shared by the scheduler's input planning and
    its placement ranking."""
    if not src_clouds or dst.name in src_clouds:
        return None
    best = None
    for c in sorted(src_clouds):
        src = profiles.get(c) or PROFILES.get(c)
        if src is None:
            continue
        k = (transfer_time_s(src, dst, nbytes),
             transfer_cost_usd(src, nbytes), c)
        if best is None or k < best:
            best = k
    if best is None:
        return None
    t_s, usd, src_c = best
    return (src_c, t_s, usd)


@dataclasses.dataclass
class CacheEntry:
    key: str
    value: Any
    step: str
    nbytes: int
    clouds: set                          # cloud names holding a local copy
    hits: int = 0
    persisted: bool = False              # JSON-able -> mirrored to the store


class ArtifactCache:
    """Content-addressed, residency-aware artifact cache (in-memory, with
    an optional ArtifactStore mirror shared with the serial Pipeline)."""

    def __init__(self, store: Optional[ArtifactStore] = None):
        self.store = store
        self.entries: dict[str, CacheEntry] = {}
        self.transfers = 0               # lifetime cross-cloud moves

    def get(self, key: str) -> Optional[CacheEntry]:
        e = self.entries.get(key)
        if e is not None:
            return e
        if self.store is not None and self.store.exists(key):
            rec = self.store.load_json(key)
            if not rec.get("cacheable", False):
                return None              # value was not persistable
            nbytes = (int(rec["nbytes"]) if "nbytes" in rec
                      else payload_bytes(rec["value"]))
            e = CacheEntry(key, rec["value"], rec.get("step", "?"), nbytes,
                           set(rec.get("clouds", [])), persisted=True)
            self.entries[key] = e
        return e

    def put(self, key: str, value: Any, step: str, cloud: str) -> CacheEntry:
        e = CacheEntry(key, value, step, payload_bytes(value), {cloud})
        self.entries[key] = e
        if self.store is not None:
            e.persisted = value_cacheable(value)
            self.store.save_json(key, cache_record(value, step, e.clouds,
                                                   e.nbytes))
        return e

    def commit_transfer(self, entry: CacheEntry, dst_cloud: str) -> None:
        """The consuming attempt completed: dst now holds a local copy.
        Persisted entries rewrite their residency meta too, so a future
        PROCESS reloading this entry does not re-bill a move already
        paid (the in-memory set covers recurring runs in-process)."""
        entry.clouds.add(dst_cloud)
        self.transfers += 1
        if self.store is not None and entry.persisted:
            self.store.save_json(entry.key, cache_record(
                entry.value, entry.step, entry.clouds, entry.nbytes))
