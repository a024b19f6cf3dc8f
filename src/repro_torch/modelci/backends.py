"""Analytic serving backend built FROM a profile artifact.

The registry-model serving path: a ``ModelProfile`` (measured or
roofline-derived) already IS a service-time model, so a gateway backend
can be synthesized from it with no weights and no compilation --
``service_time(b)`` prices a batch linearly at the profiled per-request
time, and a disaggregated profile exposes ``prefill_time``/
``decode_time`` so the router's staged prefill/decode pricing engages
exactly as it would for a measured ``BatcherBackend``.  The port's copy of
``repro.modelci.backends``.
"""
from __future__ import annotations

from .profile import ModelProfile


class ProfiledBackend:
    """Gateway backend whose cost model is a committed ModelProfile."""

    def __init__(self, profile: ModelProfile):
        self.name = profile.model
        self.profile = profile
        if profile.prefill_s is not None and profile.decode_s is not None:
            # instance attributes, not class methods: the gateway engages
            # its disaggregated pricing on hasattr, so a blended profile
            # must NOT expose these
            self.prefill_time = lambda prompt_tokens=None: profile.prefill_s
            self.decode_time = lambda steps=None: profile.decode_s

    def service_time(self, b: int) -> float:
        return max(int(b), 1) * self.profile.service_time_s
