"""Cloud serving profiles: the port's trimmed copy of ``repro.clouds.profiles``.

A profile holds the serving-network constants the sequential strategies of
``serving.kserve`` add around a measured predict: network round trip,
load-balancer hop, model (re)load, the simulated price sheet, and the
cross-cloud pipe a capacity market's warm replica handoff is priced over;
and the two the pipeline orchestrator reads: a cluster's per-attempt
spin-up (``startup_s``) and the egress price of an artifact leaving it
(``egress_per_gb``).  Like the
reference's, these are simulation inputs calibrated to the paper's Table 3
ratios, not measurements.

Every profile also names the card it runs on (``hardware``, a
``HardwareSpec``): the peaks the roofline terms of ``launch/roofline.py``
and ``modelci.roofline_fields`` divide by.  The port runs on one card kind,
the H100 SXM; ``hardware_for`` resolves a card's reported name to its spec
and refuses any other card, since another part (a PCIe H100, say) has other
peaks.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float      # dense tensor-core FLOP/s
    peak_flops_fp32: float      # FLOP/s outside the tensor cores
    hbm_bw: float               # device memory, B/s
    link_bw: float              # NVLink, per GPU per direction, B/s
    net_bw: float               # across nodes, per GPU, B/s
    hbm_bytes: float            # device memory capacity
    smem_bytes: float           # shared memory per SM


# NVIDIA's H100 SXM data sheet, dense rates (no sparsity) at the full 700 W
# power limit: data-sheet peaks, not measurements.  80 GB is five HBM3
# stacks of 16 GiB; 228 KiB of shared memory an SM (the Hopper tuning
# guide); net_bw is one 400 Gb/s network adapter per GPU, as the DGX H100
# pairs them.
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    peak_flops_fp32=67e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    net_bw=50e9,
    hbm_bytes=80 * 2**30,
    smem_bytes=228 * 2**10,
)

# the name the card reports (``torch.cuda.get_device_name``, ``nvidia-smi``)
CARDS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def hardware_for(device_name: str) -> HardwareSpec:
    """The spec of the card named ``device_name``; any other card raises."""
    try:
        return CARDS[device_name.strip()]
    except KeyError:
        raise KeyError(f"no HardwareSpec for the card {device_name!r}; known: "
                       f"{sorted(CARDS)}") from None


@dataclasses.dataclass(frozen=True)
class CloudProfile:
    name: str
    network_rtt_s: float        # per-request network round trip
    lb_overhead_s: float        # load-balancer / ingress hop
    model_load_s: float         # cost of (re)loading the model ("baremetal")
    cost_per_s: float = 1.0 / 3600.0    # SIMULATED $/replica-second
    interconnect_bw: float = 1.25e9     # SIMULATED cross-cloud pipe, B/s
    startup_s: float = 0.0              # cluster/job spin-up per pipeline attempt
    egress_per_gb: float = 0.08         # SIMULATED $ per GB leaving this cloud
    hardware: HardwareSpec = H100_SXM   # the card a replica runs on


PROFILES = {
    "gcp": CloudProfile("gcp", network_rtt_s=0.0025, lb_overhead_s=0.0004,
                        model_load_s=0.20, cost_per_s=1.0 / 3600.0,
                        interconnect_bw=1.25e9, startup_s=3.0, egress_per_gb=0.08),
    "ibm": CloudProfile("ibm", network_rtt_s=0.0010, lb_overhead_s=0.0004,
                        model_load_s=0.20, cost_per_s=1.4 / 3600.0,
                        interconnect_bw=1.25e9, startup_s=5.0, egress_per_gb=0.09),
    "baremetal": CloudProfile("baremetal", network_rtt_s=0.0030, lb_overhead_s=0.0,
                              model_load_s=0.25, cost_per_s=0.9 / 3600.0,
                              interconnect_bw=0.625e9, startup_s=0.0, egress_per_gb=0.0),
    "k8s": CloudProfile("k8s", network_rtt_s=0.0030, lb_overhead_s=0.0006,
                        model_load_s=0.20, cost_per_s=1.1 / 3600.0,
                        interconnect_bw=0.625e9, startup_s=1.0, egress_per_gb=0.08),
}


def get_profile(name: str) -> CloudProfile:
    return PROFILES[name]
