"""Roofline terms over a ``HardwareSpec``: the closed forms of
``repro.launch.roofline`` for the port's card.

Three terms per (arch x shape), in seconds, from per-card quantities:
  compute    = FLOPs_per_card  / peak bf16 FLOP/s
  memory     = bytes_per_card  / HBM bandwidth
  collective = collective_bytes_per_card / NVLink bandwidth
The bound is the largest of the three (they overlap on real hardware).

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and parses
collectives out of the compiled HLO text; the port has no compiler to ask,
so ``launch/count.py`` counts them on the eager program instead, and those
XLA parsers have no counterpart here.  ``model_flops`` is the analytic
MODEL_FLOPS (6 N D to train, 2 N D for a forward), the numerator of
``useful_flops_ratio`` and of a measured phase's ``mfu``.
"""
from __future__ import annotations

import dataclasses

from ..clouds.profiles import H100_SXM, HardwareSpec


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    coll_bytes: float
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        # terms overlap on real hardware; max() is the roofline bound
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant,
                "bound_s": self.total_s}


def roofline(flops: float, bytes_accessed: float, coll_bytes: float,
             chips: int, hw: HardwareSpec = H100_SXM) -> RooflineTerms:
    """Inputs are per card."""
    return RooflineTerms(
        compute_s=flops / hw.peak_flops_bf16,
        memory_s=bytes_accessed / hw.hbm_bw,
        collective_s=coll_bytes / hw.link_bw,
        flops=flops, bytes_accessed=bytes_accessed, coll_bytes=coll_bytes,
        chips=chips,
    )


def slstm_correction_flops(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """The sLSTM time loop's in-loop recurrent products (4 gates x per-head
    hd x hd), for ``batch`` x ``seq`` tokens; the input projections lie
    outside the loop.  Train counts fwd+bwd (x3)."""
    if cfg.family != "ssm" or not cfg.slstm_every or shape_kind == "decode":
        return 0.0
    n_slstm = cfg.n_layers // cfg.slstm_every
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    per_token = 4 * h * hd * hd * 2
    mult = 3.0 if shape_kind == "train" else 1.0
    return mult * n_slstm * batch * seq * per_token


def model_flops(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D for train, 2*N_active*D for a
    forward-only token pass (prefill/decode)."""
    n_active = cfg.approx_active_params()
    mult = 6.0 if shape_kind == "train" else 2.0
    tokens = batch * (1 if shape_kind == "decode" else seq)
    return mult * n_active * tokens
