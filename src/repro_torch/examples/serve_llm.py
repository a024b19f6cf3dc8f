"""Serve an LLM through the KServe analog on the port, with batched greedy
generation and a canary rollout between two model versions, then through
the DISAGGREGATED gateway path: a real ContinuousBatcher is measured by
BatcherBackend to split the per-request cost into prefill and decode, and
the gateway stages every request across a prefill pool (gcp) and a decode
pool (ibm) with KV-block accounting.  Twin of ``examples/serve_llm.py``.

    python -m repro_torch.examples.serve_llm --smoke --device cpu
    python -m repro_torch.examples.serve_llm               # full config, card

``--smoke`` takes the reduced config; without it the full config runs on
the card with random weights from a seed, kernels on (the batcher's decode
steps launch the hand-written decode attention and RMSNorm kernels).
"""
from __future__ import annotations

import argparse
import json

import torch

from ..clouds.profiles import get_profile
from ..configs import registry
from ..launch.serve import make_lm_predictor
from ..models import lm
from ..models.modules import require_device
from ..serving.continuous import ContinuousBatcher
from ..serving.gateway import (AutoscalerConfig, BatcherBackend, DisaggSpec,
                               Gateway, RoutingConfig, TrafficSpec)
from ..serving.kserve import InferenceService
from ..telemetry.events import EventLog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    cfg = (registry.get_smoke_config if args.smoke else registry.get_config)(args.arch)
    cfg = cfg.replace(use_kernels=True)
    v1 = make_lm_predictor(cfg, gen_tokens=8, seed=0, device=dev)
    v2 = make_lm_predictor(cfg, gen_tokens=8, seed=1, device=dev)   # canary candidate
    v2.name = f"{cfg.name}-canary"

    svc = InferenceService(v1, get_profile("gcp"), "kserve", max_batch=8,
                           canary=v2, canary_fraction=0.2)
    res = svc.stress_test(args.requests)
    out = {"arch": cfg.name, "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "kserve_canary": res.summary()}
    assert sum(res.per_version.values()) == args.requests

    # disaggregated leg: measure a real batcher, stage prefill on gcp and
    # decode on ibm, KV budget sized so nothing sheds at this load
    params = lm.init_params(cfg, seed=0, device=dev)
    batcher = ContinuousBatcher(cfg, params, max_slots=2, max_len=64,
                                prefill_chunk=8)
    backend = BatcherBackend(cfg.name, batcher, prompt_len=16, gen_tokens=4)
    gw = Gateway(log=EventLog(), routing=RoutingConfig(policy="queue_aware"))
    gw.deploy(cfg.name, backend,
              split={get_profile("gcp"): 0.5, get_profile("ibm"): 0.5},
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2),
              max_batch=4,
              disagg=DisaggSpec(kv_blocks=256, block_size=16,
                                prompt_tokens=16, gen_tokens=4,
                                pool_kind={"gcp": "prefill",
                                           "ibm": "decode"}))
    run = gw.run([TrafficSpec(cfg.name, args.requests, arrival="poisson",
                              rate=50.0)], seed=0)
    r = run.per_model[cfg.name]
    out["disagg_gateway"] = {
        "served": r.n_requests - r.shed_total,
        "shed": r.shed_total,
        "p50_s": round(r.p50, 5),
        "p99_s": round(r.p99, 5),
        "prefill_batches": len(gw.log.named("gateway:prefill")),
        "cache_sheds": len(gw.log.named("gateway:cache_shed")),
        "measured_prefill_s_per_chunk": round(backend.prefill_time(8), 6),
        "measured_decode_s_per_step": round(backend.decode_time(1), 6),
        "kv_blocks_leaked": sum(run_kv for run_kv
                                in gw.final_kv[cfg.name].values()),
    }
    assert out["disagg_gateway"]["served"] + r.shed_total == args.requests
    assert out["disagg_gateway"]["kv_blocks_leaked"] == 0
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
