"""Continuous-batching LLM serving on the port: more requests than decode
slots, admitted into freed slots mid-flight.  Twin of
``examples/continuous_batching.py``.

Prompts ingest through the batched-prefill path (``--prefill-chunk C``:
ceil(P/C) ``lm.prefill_chunk`` calls write the KV rows, then the request
enters the decode slot pool); a teacher-forced leg (``--prefill-chunk 0``)
drains the same mix and the outputs are asserted identical, the oracle
contract of ``tests/test_prefill_oracle.py`` end to end.

    python -m repro_torch.examples.continuous_batching --smoke --device cpu
    python -m repro_torch.examples.continuous_batching          # full config, card

``--smoke`` takes the reduced config; without it the full config runs on
the card with random weights from a seed, kernels on.  The model runs in
fp32: the contract is exact token equality, and in bf16 the two legs' products
of different shapes round differently.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import registry
from ..models import lm
from ..models.modules import require_device
from ..serving.continuous import ContinuousBatcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="0 = teacher-forced path only")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    cfg = (registry.get_smoke_config if args.smoke else registry.get_config)(args.arch)
    cfg = cfg.replace(dtype="float32", use_kernels=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, args.prompt_len).tolist()
               for _ in range(args.requests)]

    def drain(pc):
        cb = ContinuousBatcher(cfg, params, max_slots=args.slots, max_len=96,
                               prefill_chunk=pc)
        reqs = [cb.submit(list(p), max_new=args.max_new) for p in prompts]
        t0 = time.perf_counter()
        done = cb.run()
        if len(done) != args.requests:
            raise AssertionError(f"{len(done)} of {args.requests} requests finished")
        return cb, reqs, time.perf_counter() - t0

    cb, reqs, wall = drain(args.prefill_chunk)
    summary = {
        "arch": cfg.name,
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "requests": args.requests,
        "slots": args.slots,
        "prefill_chunk": args.prefill_chunk,
        "prefill_stats": dict(cb.prefill_stats) if args.prefill_chunk else None,
        "engine_steps": cb.step_count,
        "wall_s": round(wall, 2),
        "tokens_generated": sum(len(r.output) for r in reqs),
        "admission_steps": [r.admitted_step for r in reqs],
        "sample_output": reqs[0].output,
    }
    if args.prefill_chunk:
        # oracle leg: the teacher-forced path must emit the same tokens
        _, ref, ref_wall = drain(0)
        if [r.output for r in ref] != [r.output for r in reqs]:
            raise AssertionError("batched prefill diverged from the teacher-forced path")
        summary["oracle_ok"] = True
        summary["teacher_forced_wall_s"] = round(ref_wall, 2)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
