"""Cross-cloud transfer pricing: the port's trimmed copy of
``repro.pipelines.artifacts`` (the part the gateway's warm replica handoff
reads).  Transfers are SIMULATED from the CloudProfile, like every other
network constant."""
from __future__ import annotations

from ..clouds.profiles import CloudProfile


def transfer_time_s(src: CloudProfile, dst: CloudProfile,
                    nbytes: int) -> float:
    """Seconds to move ``nbytes`` from src to dst: one control-plane RTT on
    each side plus the bytes over the narrower interconnect."""
    return (src.network_rtt_s + dst.network_rtt_s
            + nbytes / min(src.interconnect_bw, dst.interconnect_bw))
