"""Where the time goes: trace one prefill and one decode step, one scoring
forward, or a continuous batcher's prefill chunk and step.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch granite_3_8b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch zamba2_1_2b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch h2o_danube_3_4b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch xlstm_1_3b --score
    PYTHONPATH=src python -m repro_torch.launch.profile --arch h2o_danube_3_4b --batcher
    PYTHONPATH=src python -m repro_torch.launch.profile --arch deepseek_v2_lite_16b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch whisper_base
    PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen2_vl_7b --prompt 384
    PYTHONPATH=src python -m repro_torch.launch.profile --arch zamba2_1_2b --train --prompt 1024

Builds the model with random weights on the card (``use_kernels=True``),
warms it up, then, at batch 4 x prompt 128 (``--prompt``), traces one
prefill and one decode step (the family's inputs around the tokens as the
predictor builds them, ``steps.batch_inputs``: whisper's 1500 zero frames
through its encoder, qwen2-vl's zero vision rows and M-RoPE positions)
with ``torch.profiler`` (CPU and CUDA activity).  With
``--score`` it traces one full-sequence forward of ``steps.loss_fn`` (no
cache) instead; with ``--batcher``, for a ``ContinuousBatcher`` of 4
slots over 4608 cache rows, one 256-row ``lm.prefill_chunk`` on a one-row
cache at positions 4352-4607 (the last chunk the cache takes; a 4096-row
ring has wrapped) and one engine step with all four slots decoding; with
``--train``, one ``steps.train_step`` (bf16 compute on fp32 masters,
AdamW) on a batch of 4 x ``--prompt`` tokens.  For
each it prints the host wall time, the device busy time (union of kernel
intervals), the device's idle share of the span between its first and
last kernel, and device time by kernel group (the port's kernels, matrix
products, sorts and indexed gathers and scatters, the rest), and the
median and least host time of ``UNTRACED`` runs of each without the
profiler (host clock around the run and a ``torch.cuda.synchronize``),
which the profiler's own cost leaves out.  The traces go to ``--out`` (default
``chiprun_out/profile``).
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import registry
from ..data.tokens import lm_batches
from ..models import lm, steps
from ..models.modules import require_device
from ..optim import adamw
from ..serving.continuous import ContinuousBatcher

BATCH, PROMPT = 4, 128          # chip_smoke.py's serving shape
MAX_LEN, CHUNK = 4608, 256      # chip_smoke.py's batcher
UNTRACED = 20

GROUPS = (("flash_attention", ("flash_fwd",)), ("decode_attention", ("decode_fwd",)),
          ("flash_attention_bwd", ("flash_bwd",)),
          ("rmsnorm_bwd", ("_rmsnorm_bwd_kernel", "_rmsnorm_dscale_kernel")),
          ("rmsnorm", ("_rmsnorm_kernel",)),
          ("ssm_scan_bwd", ("bwd_states", "bwd_carry", "bwd_chunk", "bwd_walk", "bwd_groups",
                            "bwd_finish")),
          ("ssm_scan", ("ssd_scan", "ssd_states", "ssd_carry", "ssd_output", "ssd_fused")),
          ("mlstm_scan", ("mlstm_scan_kernel", "mlstm_gates", "mlstm_scores", "mlstm_walk")),
          ("matmul", ("gemm", "gemv", "cutlass", "sm90_xmma", "cublas", "nvjet")),
          # sorts, gathers and scatters: MoE's routing, dispatch and combine,
          # besides the cache-row writes and the embedding lookup
          ("index_sort", ("sort", "scatter", "gather", "index")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def trace(fn, out: Path, label: str) -> dict:
    """Run ``fn`` once under the profiler; summarise its device activity.
    A trace that records no device activity at all (seen on the H100) is
    taken again, up to three traces in all."""
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"{label}.json"))
    if not kernels:
        raise RuntimeError(f"{label}: the profiler recorded no device activity in three traces")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_group: dict = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        g = by_group[_group(e.name)]
        g[0] += e.time_range.elapsed_us() / 1e3
        g[1] += 1
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
            "idle_share_of_span": 1.0 - busy / span if span else 0.0,
            "kernels": len(kernels),
            "by_group_ms": {k: {"ms": v[0], "n": v[1]}
                            for k, v in sorted(by_group.items(), key=lambda kv: -kv[1][0])}}


def host_times(fn, n: int) -> dict:
    """Median and least host ms of ``n`` runs of ``fn``, each ending in a
    ``torch.cuda.synchronize``, with no profiler."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    return {"n": n, "median_ms": ms[n // 2], "min_ms": ms[0]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--score", action="store_true",
                    help="trace the scoring forward instead of prefill and decode")
    ap.add_argument("--batcher", action="store_true",
                    help="trace a continuous batcher's prefill chunk and step instead")
    ap.add_argument("--train", action="store_true",
                    help="trace one training step instead")
    ap.add_argument("--prompt", type=int, default=PROMPT)
    ap.add_argument("--out", default="chiprun_out/profile")
    args = ap.parse_args(argv)

    dev = require_device("cuda")
    cfg = (registry.get_smoke_config if args.smoke else registry.get_config)(args.arch)
    cfg = cfg.replace(use_kernels=True)
    if args.train:
        params = lm.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
        opt = adamw.init_opt_state(params)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(lm_batches(cfg, BATCH, args.prompt, seed=3)).items()}
        return _report(cfg, args, {"train_step": lambda: steps.train_step(params, opt, batch,
                                                                          cfg=cfg)})
    params = lm.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, args.prompt), device=dev,
                           generator=gen, dtype=torch.int32)
    batch = steps.batch_inputs(cfg, tokens)
    cache_len = args.prompt + 2
    pos = steps.start_positions(cfg, BATCH, args.prompt, dev)
    state = {}

    def run_prefill():
        last, state["cache"] = steps.prefill(params, batch, cfg=cfg, cache_len=cache_len)
        state["tok"] = torch.argmax(last, -1).to(torch.int32)[:, None]

    def run_decode():
        lm.decode_step(params, cfg, state["tok"], pos, state["cache"])

    def run_score():
        lm.forward(params, cfg, batch)

    def batcher_runs():
        cb = ContinuousBatcher(cfg, params, max_slots=BATCH, max_len=MAX_LEN,
                               prefill_chunk=CHUNK)
        for row in tokens.tolist():
            cb.submit(row, 1 << 20)
        cb.step()                                  # admits (prefills) all four
        row = lm.init_cache(cfg, 1, MAX_LEN, device=dev)
        chunk = tokens.reshape(1, -1)[:, :CHUNK]
        chunk_pos = torch.arange(MAX_LEN - CHUNK, MAX_LEN, dtype=torch.int32, device=dev)[None]
        if cfg.use_mrope:
            chunk_pos = chunk_pos[:, None].expand(1, 3, CHUNK)
        return {"prefill_chunk": lambda: lm.prefill_chunk(params, cfg, chunk, chunk_pos, row),
                "batcher_step": cb.step}

    with torch.inference_mode():
        _report(cfg, args, {"forward": run_score} if args.score else batcher_runs()
                if args.batcher else {"prefill": run_prefill, "decode_step": run_decode})


def _report(cfg, args, runs: dict) -> None:
    """Warm each run up, trace it, time it untraced; print the summary."""
    for _ in range(2):                          # warm-up: kernel builds, allocator
        for fn in runs.values():
            fn()
    out = Path(args.out)
    res = {"arch": cfg.name, "batch": BATCH, "prompt": args.prompt,
           "device": torch.cuda.get_device_name(),
           **{label: trace(fn, out, label) for label, fn in runs.items()}}
    for label, fn in runs.items():
        res[label]["untraced"] = host_times(fn, UNTRACED)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
