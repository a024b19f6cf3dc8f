"""Serving launcher: batched greedy generation through the KServe analog.

`python -m repro_torch.launch.serve --arch zamba2_1_2b --strategy k8s
--requests 4` builds the full config of a ported arch (granite_3_8b,
h2o_danube_3_4b, minitron_4b, zamba2_1_2b, xlstm_1_3b) with random weights
from a seed on the card, wraps prefill + a greedy decode loop in a
Predictor, and runs the paper's stress test against it.  `--smoke` selects
the reduced config; `--device cpu` runs the plain path on the host.  The
model runs with ``use_kernels=True``: on the card every kernel its path
reaches (attention, norms, the SSD scan in zamba2's prefill) is the
hand-written one.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..clouds.profiles import get_profile
from ..configs import registry
from ..configs.base import ArchConfig
from ..models import lm, steps
from ..models.modules import require_device
from ..serving.kserve import STRATEGIES, InferenceService, Predictor
from ..telemetry.events import EventLog


def make_lm_predictor(cfg: ArchConfig, *, gen_tokens: int = 8, prompt_len: int = 16,
                      seed: int = 0, device="cuda", params: dict | None = None) -> Predictor:
    """Predictor whose predict takes int token ids (B, prompt_len) and
    returns the greedy continuation (B, gen_tokens) on ``device``.
    ``params`` defaults to ``lm.init_params(cfg, seed=seed)``."""
    dev = require_device(device)
    if params is None:
        params = lm.init_params(cfg, seed=seed, device=dev)
    cache_len = prompt_len + gen_tokens + 1

    @torch.inference_mode()
    def predict(tokens):
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32, device=dev)
        last, cache = steps.prefill(params, {"tokens": tokens}, cfg=cfg, cache_len=cache_len)
        first = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        start = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32, device=dev)
        toks, _ = steps.greedy_decode_loop(params, cache, first, start, gen_tokens, cfg=cfg)
        return toks

    example = np.zeros((1, prompt_len), np.int32)
    return Predictor(cfg.name, predict, example, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--profile", default="gcp")
    ap.add_argument("--strategy", default="k8s", choices=STRATEGIES)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="batch cap of the kserve strategy (not ported yet)")
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.max_batch is not None:
        raise NotImplementedError(
            "--max-batch caps the kserve strategy's batches; that strategy needs "
            "the multi-model gateway, which is not ported yet: ROADMAP.md queue 1 "
            "item 1.3")

    cfg = (registry.get_smoke_config if args.smoke else registry.get_config)(args.arch)
    cfg = cfg.replace(use_kernels=True)
    pred = make_lm_predictor(cfg, gen_tokens=args.gen_tokens, device=args.device)
    svc = InferenceService(pred, get_profile(args.profile), args.strategy, log=EventLog())
    res = svc.stress_test(args.requests)
    dev = pred.device
    print(json.dumps({**res.summary(), "arch": cfg.name, "device": str(dev),
                      "device_name": (torch.cuda.get_device_name(dev)
                                      if dev.type == "cuda" else "cpu")}, indent=1))


if __name__ == "__main__":
    main()
