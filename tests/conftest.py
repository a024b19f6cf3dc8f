import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

try:
    # Hypothesis profiles for the property suites (test_properties.py,
    # test_gateway_invariants.py): "dev" runs the full 200 examples,
    # "ci" is a smaller deadline-free subset so the tier-1 workflow stays
    # fast and deterministic (ci.yml pins HYPOTHESIS_PROFILE=ci and a fixed
    # --hypothesis-seed).  Both disable the per-example deadline: simulated
    # fleets are cheap but wall-clock-noisy on shared runners.
    from hypothesis import settings as _hyp_settings

    _hyp_settings.register_profile("dev", max_examples=200, deadline=None)
    _hyp_settings.register_profile("ci", max_examples=25, deadline=None)
    _hyp_settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))
except ImportError:                      # dev dep; suites importorskip/skip
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (the port's CUDA / Triton kernels); "
        "skips without one")


@pytest.fixture(autouse=True)
def _no_global_log_leaks():
    """GLOBAL_LOG is a retired legacy sink (telemetry/events.py): every
    gateway / orchestrator owns a run-scoped EventLog.  Fail any test that
    records into the shared singleton -- a leak here means some code path
    silently fell back to it."""
    from repro.telemetry.events import GLOBAL_LOG
    before = len(GLOBAL_LOG.events)
    yield
    leaked = GLOBAL_LOG.events[before:]
    assert not leaked, (
        f"{len(leaked)} event(s) leaked into the legacy GLOBAL_LOG "
        f"(first: {leaked[0]['name']!r}); pass log=EventLog() instead")


def make_batch(cfg, B, S, key=None, labels=True):
    """Batch dict matching models.lm.forward's contract for any family."""
    key = key if key is not None else jax.random.PRNGKey(1)
    ks = jax.random.split(key, 4)
    b = {"tokens": jax.random.randint(ks[0], (B, S), 0, cfg.vocab_size)}
    if labels:
        b["labels"] = jax.random.randint(ks[1], (B, S), 0, cfg.vocab_size)
    if cfg.use_mrope:
        b["mrope_positions"] = jnp.broadcast_to(
            jnp.arange(S, dtype=jnp.int32)[None, None], (B, 3, S))
    if cfg.family == "vlm":
        b["vision_embeds"] = jax.random.normal(
            ks[2], (B, min(cfg.n_vision_tokens, S), cfg.d_model))
    if cfg.family == "audio":
        b["frames"] = jax.random.normal(ks[3], (B, cfg.encoder_len, cfg.d_model))
    return b


class AnalyticBackend:
    """Closed-form gateway backend (the router only needs .name and
    .service_time): deterministic service times with no hardware
    measurement, shared by the gateway unit and invariant suites."""

    def __init__(self, name, base_s=0.05, per_req_s=0.0):
        self.name = name
        self.base_s = base_s
        self.per_req_s = per_req_s

    def service_time(self, b):
        return self.base_s + self.per_req_s * b


@pytest.fixture(scope="session")
def mnist_data():
    from repro.data.mnist import make_dataset
    return make_dataset(256, seed=0)
