"""Cloud serving profiles: the port's trimmed copy of ``repro.clouds.profiles``.

A profile holds the serving-network constants the sequential strategies of
``serving.kserve`` add around a measured predict: network round trip,
load-balancer hop, model (re)load, the simulated price sheet, and the
cross-cloud pipe a capacity market's warm replica handoff is priced over.  Like the
reference's, these are simulation inputs calibrated to the paper's Table 3
ratios, not measurements.  The reference's hardware constants describe its
accelerator and are not copied; the port's compute term is always measured
on its own device.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CloudProfile:
    name: str
    network_rtt_s: float        # per-request network round trip
    lb_overhead_s: float        # load-balancer / ingress hop
    model_load_s: float         # cost of (re)loading the model ("baremetal")
    cost_per_s: float = 1.0 / 3600.0    # SIMULATED $/replica-second
    interconnect_bw: float = 1.25e9     # SIMULATED cross-cloud pipe, B/s


PROFILES = {
    "gcp": CloudProfile("gcp", network_rtt_s=0.0025, lb_overhead_s=0.0004,
                        model_load_s=0.20, cost_per_s=1.0 / 3600.0,
                        interconnect_bw=1.25e9),
    "ibm": CloudProfile("ibm", network_rtt_s=0.0010, lb_overhead_s=0.0004,
                        model_load_s=0.20, cost_per_s=1.4 / 3600.0,
                        interconnect_bw=1.25e9),
    "baremetal": CloudProfile("baremetal", network_rtt_s=0.0030, lb_overhead_s=0.0,
                              model_load_s=0.25, cost_per_s=0.9 / 3600.0,
                              interconnect_bw=0.625e9),
    "k8s": CloudProfile("k8s", network_rtt_s=0.0030, lb_overhead_s=0.0006,
                        model_load_s=0.20, cost_per_s=1.1 / 3600.0,
                        interconnect_bw=0.625e9),
}


def get_profile(name: str) -> CloudProfile:
    return PROFILES[name]
