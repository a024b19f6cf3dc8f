#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports only the port
(``src/repro_torch``), never JAX or the reference package, and:

1. prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and compiles the Triton RMSNorm;
2. holds every kernel against its plain PyTorch twin on the card, in bf16,
   at the shapes of the paths below (long cases, and the shapes each
   path's run gives the kernel), with the reference's tolerance scaled to
   each row, |kernel - twin| <= 2e-2 (|twin| + rms of the twin's row), and
   times kernel, twin and, where one exists, the one PyTorch call that
   computes the same function: ``ms`` with CUDA events around a loop of
   calls (at small shapes that is the host's issue rate), and, for kernel
   and library call, ``device_ms``, the device time per call summed from
   the kernels a ``torch.profiler`` trace of such a loop records (for the
   library call also the backend its kernels' names show: SDPA has no
   flash kernel past head dim 256, so at gemma3's 320 it falls back);
3. drives eight paths at full width, with random bf16 weights from a seeded
   generator and ``use_kernels=True``, each through the entry points a user
   calls, freeing each path's weights before the next:
   granite-3-8b serving (40 layers), h2o-danube-3-4b serving (24 sliding-
   window layers, head dim 120), minitron-4b serving (32 layers, squared-
   ReLU MLP), gemma3-4b serving (34 layers, 5:1 local:global with window
   1024, head dim 320, tied and scaled embeddings), zamba2-1.2b serving
   (38 Mamba2 layers and the shared attention block) and xlstm-1.3b
   serving, each through ``make_lm_predictor`` and the k8s strategy of
   ``InferenceService``; gemma3 also serves a long leg on the same weights
   (batch 1, a 2048-token prompt, ``_long_leg``: the window binds in
   prefill, decode wraps the 1024-row local rings and splits the global
   layers' 2064-row caches five ways), gated like its main run;
   h2o-danube-3-4b continuous batching through ``ContinuousBatcher`` and
   ``BatcherBackend`` (eight requests on four slots, one prompt of 4400
   tokens past the 4096-row ring: ``_batch_path``); and xlstm-1.3b scoring
   through ``steps.loss_fn`` (its full-sequence forward is xlstm's one route
   to the mLSTM scan).  Two legs serve through the gateway: granite's
   Predictor under the paper's stress test (32 requests in a burst, the
   baremetal, k8s and kserve strategies, ``_kserve_leg``: the order of their
   total times and each request served once are gated), and h2o's measured
   ``BatcherBackend`` deployed in the port's ``Gateway`` under a Poisson mix
   of two SLO classes (``_gateway_leg``).  Every gateway latency is held at
   or above the network path plus the least measured service time.
   Launch counts are zeroed just before each path's run (and the kserve
   leg) and read just after: every kernel of the path's own set must have
   launched and no other.  Every kernel call of one kernel-path prefill and decode step
   (or one scoring run, or the batcher's first step) is recorded, inputs
   and output, and held against its twin on those inputs under the phase-2
   rule.  The path's logits (prefill and one decode step, or the scoring
   forward) are compared three ways, each gated where the path's readings
   allow (``PATHS``): the bf16 kernel path against the bf16 plain path
   (granite, h2o, minitron, gemma3: <= 2e-2); with the same weights cast to fp32,
   the kernel path against the plain path (granite, h2o, minitron, gemma3
   <= 1e-4, zamba2 <= 1e-3); and the bf16 kernel path's drift from the fp32 plain
   path, at most 1.5 times the bf16 plain path's (every path).
   Random-weight zamba2 and xlstm amplify bf16 rounding until the two bf16
   paths differ by more than any kernel does (the reference drifts as far:
   ``tests/test_torch_drift.py``), and xlstm even in fp32, so those
   comparisons are reported, not gated.  The batcher's run gates its fp32
   tokens (equal to the non-batched path's for every request, and to the
   teacher-forced batcher's for the short prompts) and the memory one
   256-row prefill chunk adds on a wrapped ring (< 2 GB);
4. runs the paper's own workload, MNIST train-to-serve (``_mnist_leg``):
   LeNet at the reference trainer's width 16, batches of 64, fp32, through
   the ``e2e_train_to_serve`` example's recurring pipeline on the port's
   orchestrator (Katib, ``SupervisedTrainJob`` for 200 steps on 2048
   images, per-cloud Model-CI profiles of the trained model's Predictor, a
   profile-planned split deploy, 512 Poisson requests through the gateway,
   one tracer and one capacity market under both planes), gated by the
   example's own asserts; then the trained model's losses and holdout
   accuracy, the card against the port's CPU path on one init (logits,
   gradients, the losses of 10 training steps), a checkpoint round trip on
   the card, the paper's Table 3 on its own model (128 requests in a burst
   under baremetal, k8s and kserve) and a trace of one training step and
   one predict.  No port kernel is on this path: the leg's launch set is
   empty, and the kernels' line adds nothing for it;
5. trains granite-3-8b at full width (``_lm_train_leg``; depth cut from 40
   to TRAIN_LAYERS layers: training holds 16 bytes a parameter in fp32
   plus a bf16 copy, 134 GB at 40 layers) through ``LMTrainJob.run``: bf16
   compute on fp32 masters, ``use_kernels=True``, TRAIN_BATCH x TRAIN_SEQ
   tokens from the port's ``lm_batches``, TRAIN_STEPS steps, a checkpoint
   and a resume for 2 more.  Gated: the four kernels of the path (RMSNorm
   and flash attention, forward and backward) launched and no other; every
   kernel call of one recorded step, forward and backward, against its
   twin; finite losses that fall (``examples/train_llm.py``'s assert); the
   resumed run's first loss below a fresh job's; one step's loss and
   global gradient norm, kernel path against plain path in bf16 (<=
   TRAIN_LIMITS), and every gradient leaf in fp32 at 2 layers.  Phase 2
   holds and times the two backward kernels (flash at granite's training
   shape, at h2o's D 120 under a window that binds and in fp32; RMSNorm
   at 4096 x 4096) against autograd of their twins, beside autograd
   through SDPA and ``F.rms_norm``.  Steps/s, tokens/s, peak memory and a
   trace of one step are reported;
6. prints the kernels' JSON line and, last, the device line.

Any failure raises, and the script exits non-zero without the last line.
The build prints each kernel instantiation's registers and spills (ptxas).
Details (every case, ptxas register reports) go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16
# tensor-core FLOP/s, fp32 CUDA-core FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
TOL = 2e-2                  # reference bf16 tolerance, tests/test_kernels.py:17-19
BWD_FLOOR = 1e-6            # the backward kernels' absolute floor, of the twin's largest
# the bf16 kernel path may drift from the fp32 plain run at most this many
# times as far as the bf16 plain path does on the same weights and tokens
DRIFT_RATIO = 1.5

BATCH, PROMPT, GEN = 4, 128, 16
# the continuous batcher's run: slots, cache rows, prefill chunk, the mix's
# long prompt (it wraps h2o_danube's 4096-row ring in chunked prefill, and
# its decode runs on the wrapped ring) and the longest prompt that also goes
# through the teacher-forced batcher
BATCH_SLOTS, BATCH_MAX_LEN, BATCH_CHUNK = 4, 4608, 256
LONG_PROMPT, SHORT_PROMPT = 4400, 64
RING_CHUNK_BYTES = 2e9      # the most one ring chunk may add to peak memory
# the paper's stress test (Table 3) on granite's card-measured Predictor: a
# burst of requests under each strategy, the kserve one batching up to
# KSERVE_BATCH a predict; and the gateway leg's Poisson mix on h2o's
# measured BatcherBackend
KSERVE_PATH, KSERVE_REQUESTS, KSERVE_BATCH = "granite-3-8b serving", 32, 8
GATEWAY_REQUESTS = 64
# the gateway's second slice on the same measured backends: h2o's
# BatcherBackend staged across a prefill pool (gcp) and a decode pool (ibm),
# GATEWAY_REQUESTS Poisson requests in two classes (``_disagg_leg``); and
# granite's Predictor on gcp with an ibm standby through a mid-run gcp
# outage, three SLO classes of FAILOVER_MIX requests (batch, standard,
# latency), with the telemetry plane attached, then a live migration
# (``_failover_leg``)
FAILOVER_MIX = (64, 24, 16)
# the paper's own MNIST workload (``_mnist_leg``): LeNet at the reference
# trainer's full width, trained and served through the port's orchestrator
# in the ``e2e_train_to_serve`` example's shape, then the paper's Table 3 on
# its own model; the card held to the port's CPU path at these rel limits
MNIST_WIDTH, MNIST_BATCH, MNIST_LR, MNIST_STEPS = 16, 64, 2e-3, 200
MNIST_TRAIN, MNIST_HOLDOUT = 2048, 512
MNIST_TABLE3_REQUESTS, MNIST_TABLE3_BATCH = 128, 32
# (logits at the init, the first step's gradients per leaf, each loss of
# ten steps).  After ten steps the parameters are reported, not gated: a
# pre-activation within rounding of zero is zero past the ReLU on one
# device and tiny on the other, and AdamW's normalised step turns that tiny
# gradient into a full ``lr`` step (PERF.md §6)
MNIST_LIMITS = {"logits": 1e-5, "grads": 1e-4, "losses_10_steps": 1e-3}
# gemma3's long leg on its serving weights: batch 1, a prompt of 2048, GEN
# new tokens over a cache of 2048 + GEN rows (the local layers' rings hold
# min(1024, that)); gated with the path's limits
LONG_LEG_PATH, LONG_LEG_PROMPT = "gemma3-4b serving", 2048
# granite-3-8b training (``_lm_train_leg``): full width, depth cut to
# TRAIN_LAYERS; the gates on one step, kernel path against plain path: loss
# and global gradient norm in bf16, every gradient leaf in fp32 (2 layers).
# An H100 read 6.4e-6 and 4.5e-5 (bf16) and 4.8e-6 (fp32): the limits sit
# 200x and more above, far below a kernel fault phase 2 catches
TRAIN_PATH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = \
    "granite-3-8b training", 8, 4, 1024, 20
TRAIN_LIMITS = {"bf16_loss": 2e-2, "bf16_grad_norm": 2e-2, "fp32_grad_leaf": 1e-3}
TRAIN_KERNELS = ("rmsnorm", "flash_attention", "rmsnorm_bwd", "flash_attention_bwd")
# (label, arch, run, the kernels that run must launch (no other may launch),
# limits on the logits' rel error of kernel path vs plain path in bf16 and
# with the weights in fp32; None reports without gating).  The fp32 limits
# sit 10-40x above the H100 readings (granite 2.6e-6, zamba2 9.4e-5); gemma3
# takes granite's gates.  The
# batcher's run gates its tokens instead (``_batch_path``): its prefill
# runs no attention kernel, as in the reference.
PATHS = (
    ("granite-3-8b serving", "granite_3_8b", "serve",
     ("rmsnorm", "flash_attention", "decode_attention"), TOL, 1e-4),
    ("h2o-danube-3-4b serving", "h2o_danube_3_4b", "serve",
     ("rmsnorm", "flash_attention", "decode_attention"), TOL, 1e-4),
    ("minitron-4b serving", "minitron_4b", "serve",
     ("rmsnorm", "flash_attention", "decode_attention"), TOL, 1e-4),
    ("gemma3-4b serving", "gemma3_4b", "serve",
     ("rmsnorm", "flash_attention", "decode_attention"), TOL, 1e-4),
    ("h2o-danube-3-4b continuous batching", "h2o_danube_3_4b", "batch",
     ("rmsnorm", "decode_attention"), None, None),
    ("zamba2-1.2b serving", "zamba2_1_2b", "serve",
     ("rmsnorm", "flash_attention", "decode_attention", "ssm_scan"), None, 1e-3),
    ("xlstm-1.3b serving", "xlstm_1_3b", "serve", ("rmsnorm",), None, None),
    ("xlstm-1.3b scoring", "xlstm_1_3b", "score", ("rmsnorm", "mlstm_scan"), None, None),
)
# kernel -> (route, source, TPU kernel it replaces, path whose shapes its
# entry in the kernels line reports, its wrapper: a name in ``ops``, or
# ``module.name`` in ``repro_torch.kernels`` for the backward kernels, which
# their ``autograd.Function`` calls).  The ``ops`` entry of the kernel's own
# name, with ``use_kernel=False``, is its twin on the wrapper's arguments.
# The backward kernels replace no TPU kernel: the reference differentiates
# its plain code (``jax.value_and_grad`` at repro/models/steps.py:44).
META = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/_rmsnorm_triton.py",
                "src/repro/kernels/rmsnorm.py:36", "granite-3-8b serving", "_rmsnorm_kernel"),
    "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:85", "granite-3-8b serving",
                        "_flash_kernel"),
    "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:86", "granite-3-8b serving",
                         "_decode_kernel"),
    "ssm_scan": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:79", "zamba2-1.2b serving", "_ssm_kernel"),
    "mlstm_scan": ("cuda", "src/repro_torch/kernels/csrc/mlstm_scan.cu",
                   "src/repro/kernels/mlstm_scan.py:77", "xlstm-1.3b scoring", "_mlstm_kernel"),
    "flash_attention_bwd": ("cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/models/steps.py:44", TRAIN_PATH,
                            "flash_attention.flash_attention_bwd"),
    "rmsnorm_bwd": ("triton", "src/repro_torch/kernels/_rmsnorm_triton.py",
                    "src/repro/models/steps.py:44", TRAIN_PATH, "rmsnorm.rmsnorm_bwd"),
}


def _cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int, capturable: bool = True) -> tuple[float, str, float | None, list]:
    """Mean device time per call of ``fn``: the durations of the device
    activity (kernels, copies) a ``torch.profiler`` trace of ``iters`` calls
    records, summed, so host issue gaps between launches do not count.
    The median of three such traces: a trace that drops events reads low
    (seen on the H100); a trace with no device activity at all (seen on an
    autograd backward) is taken again, up to six traces.  Where none
    records device activity, the CUDA-event time of a CUDA graph that
    replays the calls, or, for a function that cannot be captured
    (``capturable`` False: autograd's backward runs on its own thread),
    of the calls themselves.  Returns (ms, which of the three, device
    activities per call in the median trace, None otherwise, the names of
    the device activities in that trace, longest first; empty otherwise)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not device:
            continue
        by_name: dict = {}
        for e in device:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        readings.append((sum(by_name.values()) / 1e3 / iters, len(device) / iters,
                         sorted(by_name, key=by_name.get, reverse=True)))
        if len(readings) == 3:
            break
    if readings:
        ms, per_call, names = sorted(readings, key=lambda r: r[0])[len(readings) // 2]
        return ms, "profiler", per_call, names
    if not capturable:
        return _cuda_ms(fn, iters), "cuda events", None, []
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _cuda_ms(graph.replay, 3, warmup=1) / iters, "cuda graph", None, []


def _sdpa_backend(names: list) -> str:
    """Which of SDPA's backends ran, from its device kernels' names."""
    low = " ".join(names).lower()
    for backend, keys in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                          ("memory-efficient", ("fmha", "efficient"))):
        if any(k in low for k in keys):
            return backend
    return "math (plain products and softmax)"


def _check(name: str, got, want, floor: float = 0.0) -> tuple[float, float]:
    """|kernel - twin| <= TOL |twin| + TOL rms(twin's row), the row being the
    last axis: the reference's bf16 tolerance with its absolute term scaled
    to the row, since attention over L keys gives outputs of size ~L**-0.5.
    ``floor`` (the backward kernels' cases: BWD_FLOOR) puts the absolute
    term at least at that share of the twin's largest value: a gradient row
    can be zero in the twin (the first query of a causal row sees one key,
    so its dq is exactly zero) while the kernel's sums in another order
    leave fp32 noise there.  Returns the max abs error and the largest share
    of its allowance any element used (1 fails)."""
    import torch
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite")
    err = (g - w).abs()
    row = w.square().mean(dim=-1, keepdim=True).sqrt()
    if floor:
        row = torch.clamp(row, min=float(floor / TOL * w.abs().max()))
    allowed = (TOL * (w.abs() + row)).clamp_min(1e-12)
    share = float((err / allowed).max())
    if share > 1.0:
        bad = int((err > allowed).sum())
        at = tuple(int(i) for i in torch.unravel_index(torch.argmax(err / allowed), err.shape))
        raise AssertionError(f"{name}: {bad} elements off by more than {TOL}(|twin| + "
                             f"rms row) (max abs err {float(err.max())}, share {share:.3g}; "
                             f"worst at {at}: kernel {float(g[at])}, twin {float(w[at])}, "
                             f"rms of the twin's row {float(row[at[:-1]])})")
    return float(err.max()), share


def _bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- one case per kernel call: inputs, kernel, twin, library call, cost -----
def _rmsnorm_case(rows: int, d: int, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    x = torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
    s = (torch.randn(d, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    weight = (1.0 + s.float()).to(torch.bfloat16)       # F.rms_norm's weight form
    return dict(
        shape=f"x ({rows},{d}) bf16",
        kernel=lambda: ops.rmsnorm(x, s, use_kernel=True),
        twin=lambda: ref.rmsnorm_ref(x, s),
        library=lambda: F.rms_norm(x, (d,), weight=weight, eps=1e-6),
        nbytes=2 * (2 * rows * d + d), flops=4 * rows * d, peak=FP32_FLOPS)


def _flash_case(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, gen, window: int = 0):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    off = skv - sq
    qpos = torch.arange(sq, device="cuda")[:, None] + off
    kpos = torch.arange(skv, device="cuda")[None, :]
    mask = kpos <= qpos                                                # causal, offset
    if window:
        mask &= kpos > qpos - window
    visible = int(mask.sum())                                        # keys seen, all rows
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(causal=True, q_offset=off, window=window)
    return dict(
        shape=f"q ({b},{sq},{hq},{d}) kv ({b},{skv},{hkv},{d}) causal q_offset {off}"
              + (f" window {window}" if window else "") + " bf16",
        kernel=lambda: ops.flash_attention(q, k, v, use_kernel=True, **kw),
        twin=lambda: ref.flash_attention_ref(q, k, v, **kw),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                       enable_gqa=True),
        nbytes=2 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d),
        flops=4 * d * b * hq * visible, peak=BF16_FLOPS)


def _flash_bwd_case(b: int, s: int, hq: int, hkv: int, d: int, gen, window: int = 0,
                    dtype=None):
    """The backward kernel alone on the training forward's log-sum-exp and
    fp32 output, against the twin's gradient (autograd in fp32); the
    library call is the backward of SDPA (autograd of one forward, kept).
    The bound counts the five S x S x D products over the visible pairs,
    and each of q, k, v, dO, lse and the fp32 output read once and dq, dk,
    dv written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    dtype = dtype or torch.bfloat16
    q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
    do = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(dtype)
    _, lse, o32 = fa.forward_for_training(q, k, v, True, window, d ** -0.5)
    pos = torch.arange(s, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    visible = int(mask.sum())
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    o_lib = (F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
             if window else F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True))
    do_t = do.transpose(1, 2)
    kw = dict(causal=True, window=window)
    size = 2 if dtype == torch.bfloat16 else 4
    return dict(
        shape=f"q ({b},{s},{hq},{d}) kv {hkv} causal" + (f" window {window}" if window else "")
              + (" bf16" if size == 2 else " fp32"),
        kernel=lambda: ops.flash_attention_bwd(q, k, v, do, lse, o32, use_kernel=True, **kw),
        twin=lambda: ref.flash_attention_bwd_ref(q, k, v, do, **kw),
        library=lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t, retain_graph=True),
        capturable=False,
        nbytes=size * (3 * b * s * hq * d + 4 * b * s * hkv * d) + 4 * b * hq * s * (d + 1),
        flops=10 * d * b * hq * visible, peak=BF16_FLOPS if size == 2 else FP32_FLOPS,
        floor=BWD_FLOOR)


def _rmsnorm_bwd_case(rows: int, d: int, gen):
    """The backward kernel on the forward kernel's rstd, against autograd of
    the twin; the library call is the backward of ``F.rms_norm``.  Bytes:
    x, g, scale and rstd read once, dx and dscale written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rn
    x = torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
    s = (torch.randn(d, device="cuda", generator=gen) * 0.1).to(torch.bfloat16)
    g = torch.randn(rows, d, device="cuda", generator=gen).to(torch.bfloat16)
    _, rstd = rn._forward(x, s, 1e-6, True)
    xl = x.detach().requires_grad_()
    wl = (1.0 + s.float()).to(torch.bfloat16).requires_grad_()
    y_lib = F.rms_norm(xl, (d,), weight=wl, eps=1e-6)
    return dict(
        shape=f"x ({rows},{d}) bf16",
        kernel=lambda: ops.rmsnorm_bwd(x, s, g, rstd, use_kernel=True),
        twin=lambda: ref.rmsnorm_bwd_ref(x, s, g),
        library=lambda: torch.autograd.grad(y_lib, (xl, wl), g, retain_graph=True),
        capturable=False,
        nbytes=2 * 3 * rows * d + 4 * rows + 2 * 2 * d,
        flops=8 * rows * d, peak=FP32_FLOPS, floor=BWD_FLOOR)


def _decode_case(lens: list, s: int, hq: int, hkv: int, d: int, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    b = len(lens)
    q = torch.randn(b, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    kc = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    vc = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :] < cl[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    return dict(
        shape=f"q ({b},{hq},{d}) cache ({b},{s},{hkv},{d}) lens {lens} bf16",
        kernel=lambda: ops.decode_attention(q, kc, vc, cl, use_kernel=True),
        twin=lambda: ref.decode_attention_ref(q, kc, vc, cl),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                       enable_gqa=True),
        nbytes=2 * (2 * b * hq * d + 2 * sum(lens) * hkv * d) + 4 * b,
        flops=4 * d * hq * sum(lens), peak=BF16_FLOPS)


def _ssm_case(b: int, s: int, h: int, p: int, n: int, chunk: int, gen):
    """zamba2's scan inputs: A = -exp(A_log) with A_log = log(linspace(1, 16))
    as initialised, dt a softplus, bf16 activations.  The bound counts the
    sequential recurrence's state work, ~5 P N flops per token and head
    (decay, inject, read-out), at the bf16 tensor-core rate (the least time
    any design could take: a chunked form moves it onto the tensor cores),
    and each input and output once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    x = (torch.randn(b, s, h, p, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
    dt = F.softplus(torch.randn(b, s, h, device="cuda", generator=gen)).to(torch.bfloat16)
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    bm = (torch.randn(b, s, n, device="cuda", generator=gen) * 0.3).to(torch.bfloat16)
    cm = (torch.randn(b, s, n, device="cuda", generator=gen) * 0.3).to(torch.bfloat16)
    return dict(
        shape=f"x ({b},{s},{h},{p}) N {n} chunk {chunk} bf16",
        kernel=lambda: ops.ssm_scan(x, dt, A, bm, cm, chunk=chunk, use_kernel=True),
        twin=lambda: ops.ssd_chunked(x, dt, A, bm, cm, chunk=chunk),
        library=None,           # no single PyTorch call computes the scan
        nbytes=2 * (2 * b * s * h * p + b * s * h + 2 * b * s * n) + 4 * h + 4 * b * h * p * n,
        flops=5 * b * s * h * p * n, peak=BF16_FLOPS)


def _mlstm_case(b: int, s: int, h: int, d: int, chunk: int, gen):
    """xlstm's scan inputs (bf16 q/k/v, fp32 log gates, forget bias 3).  The
    bound counts the carried state's work, ~4 D^2 flops per token and head
    (q C^T and the rank-1 update), at the bf16 tensor-core rate (the least
    time any design could take), and each input and output once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    li = torch.randn(b, s, h, device="cuda", generator=gen) * 0.5
    lf = F.logsigmoid(torch.randn(b, s, h, device="cuda", generator=gen) + 3.0)
    return dict(
        shape=f"q ({b},{s},{h},{d}) chunk {chunk} bf16",
        kernel=lambda: ops.mlstm_scan(q, k, v, li, lf, chunk=chunk, use_kernel=True),
        twin=lambda: ops.mlstm_scan(q, k, v, li, lf, chunk=chunk, use_kernel=False),
        library=None,           # no single PyTorch call computes the scan
        nbytes=2 * 4 * b * s * h * d + 4 * 2 * b * s * h,
        flops=4 * b * s * h * d * d, peak=BF16_FLOPS)


def _run_case(name: str, case: dict, iters: int) -> dict:
    got, want = case["kernel"](), case["twin"]()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    checks = [_check(f"{name} output {i}", g, w, case.get("floor", 0.0))
              for i, (g, w) in enumerate(zip(got, want))]
    bound, by = _bound_ms(case["nbytes"], case["flops"], case["peak"])
    lib = case["library"]
    device_ms, source, per_call, _ = _device_ms(case["kernel"], iters)
    lib_dev = _device_ms(lib, iters, case.get("capturable", True)) if lib is not None else None
    backend = None
    if lib is not None and name in ("flash_attention", "decode_attention", "flash_attention_bwd"):
        backend = _sdpa_backend(lib_dev[3])
    return {"kernel": name, "shape": case["shape"], "device_kernels_per_call": per_call,
            "max_abs_err": max(e for e, _ in checks), "tol_share": max(t for _, t in checks),
            "ms": _cuda_ms(case["kernel"], iters), "device_ms": device_ms,
            "plain_ms": _cuda_ms(case["twin"], max(iters // 4, 2)),
            "library_ms": _cuda_ms(lib, iters) if lib is not None else None,
            "library_device_ms": lib_dev[0] if lib is not None else None,
            "library_backend": backend,
            "library_kernels": lib_dev[3][:3] if lib is not None else None,
            "device_ms_from": source, "bound_ms": bound, "bound_by": by}


def _kernel_name(mangled: str) -> str:
    """The innermost identifier of an Itanium-mangled (nested) name."""
    i, names = (3 if mangled.startswith("_ZN") else 2), []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    return names[-1] if names else mangled


def _mma_counts(lib: Path) -> dict | None:
    """Tensor-core instructions (HMMA, HGMMA) and ldmatrix (LDSM) per kernel
    in a built library's SASS, from ``cuobjdump -sass``; None without it."""
    import re
    from repro_torch.kernels import native
    tool = Path(native._nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict = {}
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = _kernel_name(m.group(1))
            continue
        for ins in re.findall(r"\b((?:HMMA|HGMMA|LDSM)\.[0-9A-Z.]+)", line):
            counts.setdefault(kernel, {}).setdefault(ins, 0)
            counts[kernel][ins] += 1
    return counts


def _ptxas_usage(log: str) -> list:
    """Each kernel instantiation's registers and spills from ``-Xptxas -v``:
    (name, dtype, template integer and bool arguments, registers, spill
    store and load bytes)."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            cur = {"kernel": _kernel_name(mangled),
                   "dtype": "bf16" if "nv_bfloat16" in mangled else "f32",
                   "args": [int(a) for a in re.findall(r"L[ib](\d+)E", mangled)],
                   "registers": None, "spill_stores": None, "spill_loads": None}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _fmt_ms(t) -> str:
    return "none" if t is None else f"{t:.4f} ms"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.kernels import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {}

    # -- phase 1: card, build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    report["card"] = card
    t0 = time.perf_counter()
    built = native.build(ptxas_verbose=True)
    build_s = time.perf_counter() - t0
    report["build"] = {src: {"s": s, "ptxas": log, "usage": _ptxas_usage(log)}
                       for src, (s, log) in built.items()}
    for src, b in report["build"].items():
        print(f"built {src} in {b['s']:.1f} s: " + "; ".join(
            f"{u['kernel']}<{u['dtype']},{','.join(map(str, u['args']))}> "
            f"{u['registers']} registers, "
            f"spills {u['spill_stores']}/{u['spill_loads']} B" for u in b["usage"]))
    report["sass"] = {src: _mma_counts(native.library_path(src)) for src in native.SOURCES}
    for src, counts in report["sass"].items():
        print(f"tensor-core and ldmatrix instructions in {src}: " + (
            "not counted (no cuobjdump)" if counts is None else "; ".join(
                f"{k} " + ", ".join(f"{i} x{n}" for i, n in sorted(c.items()))
                for k, c in sorted(counts.items())) or "none"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm = _rmsnorm_case(8, 4096, gen)
    t0 = time.perf_counter()
    _check("rmsnorm first call", warm["kernel"](), warm["twin"]())
    triton_s = time.perf_counter() - t0
    print(f"build: nvcc {build_s:.1f} s wall ({len(built)} sources built), "
          f"triton rmsnorm first call {triton_s:.1f} s")

    # -- phase 2: kernels vs twins -------------------------------------------
    g = registry.get_config("granite_3_8b")
    z = registry.get_config("zamba2_1_2b")
    xl = registry.get_config("xlstm_1_3b")
    h = registry.get_config("h2o_danube_3_4b")
    mt = registry.get_config("minitron_4b")
    gm = registry.get_config("gemma3_4b")
    cache_len = PROMPT + GEN + 1
    long_cache = LONG_LEG_PROMPT + GEN      # gemma3's long leg: its global caches' rows
    rows = BATCH * PROMPT
    zp, xhd = z.d_inner // z.n_heads, xl.d_model // xl.n_heads
    long_lens = [4096, 2048, 1, 3000, 17, 4095, 64, 1024]
    long_cases = [
        ("rmsnorm", _rmsnorm_case(4096, g.d_model, gen), 50),
        ("flash_attention", _flash_case(1, 2048, 2048, g.n_heads, g.n_kv_heads, g.head_dim,
                                        gen), 10),
        ("flash_attention", _flash_case(1, 1000, 1500, g.n_heads, g.n_kv_heads, g.head_dim,
                                        gen), 10),
        ("decode_attention", _decode_case(long_lens, 4096, g.n_heads, g.n_kv_heads, g.head_dim,
                                          gen), 20),
        ("flash_attention", _flash_case(1, 2048, 2048, z.n_heads, z.n_kv_heads, z.head_dim,
                                        gen), 10),
        ("decode_attention", _decode_case(long_lens, 4096, z.n_heads, z.n_kv_heads, z.head_dim,
                                          gen), 20),
        ("ssm_scan", _ssm_case(1, 4096, z.n_heads, zp, z.ssm_state, z.ssm_chunk, gen), 10),
        ("ssm_scan", _ssm_case(1, 1000, z.n_heads, zp, z.ssm_state, z.ssm_chunk, gen), 10),
        ("mlstm_scan", _mlstm_case(1, 4096, xl.n_heads, xhd, xl.ssm_chunk, gen), 5),
        ("mlstm_scan", _mlstm_case(1, 1000, xl.n_heads, xhd, xl.ssm_chunk, gen), 5),
        # h2o_danube: D 120 (zero-padded to the 128 tile) under a window that
        # binds, and decode over its 4096-row ring once wrapped (every row valid)
        ("flash_attention", _flash_case(1, BATCH_MAX_LEN, BATCH_MAX_LEN, h.n_heads, h.n_kv_heads,
                                        h.head_dim, gen, window=h.sliding_window), 5),
        ("decode_attention", _decode_case([h.sliding_window] * BATCH_SLOTS, h.sliding_window,
                                          h.n_heads, h.n_kv_heads, h.head_dim, gen), 20),
        # gemma3's long leg at D 320: prefill over 2048 tokens, global and
        # under the window of 1024; its first decode step over a global cache
        # of 2064 rows (five splits and the merge) and the wrapped 1024-row
        # local ring (every row valid; two splits)
        ("flash_attention", _flash_case(1, LONG_LEG_PROMPT, LONG_LEG_PROMPT, gm.n_heads,
                                        gm.n_kv_heads, gm.head_dim, gen), 10),
        ("flash_attention", _flash_case(1, LONG_LEG_PROMPT, LONG_LEG_PROMPT, gm.n_heads,
                                        gm.n_kv_heads, gm.head_dim, gen,
                                        window=gm.sliding_window), 10),
        ("decode_attention", _decode_case([LONG_LEG_PROMPT + 1], long_cache, gm.n_heads,
                                          gm.n_kv_heads, gm.head_dim, gen), 20),
        ("decode_attention", _decode_case([gm.sliding_window], gm.sliding_window, gm.n_heads,
                                          gm.n_kv_heads, gm.head_dim, gen), 20),
        # the backward kernels: h2o's D 120 under a window that binds, and
        # flash in fp32 at a small shape (the training leg's own shapes are
        # its path cases below)
        ("flash_attention_bwd", _flash_bwd_case(1, 2048, h.n_heads, h.n_kv_heads, h.head_dim,
                                                gen, window=512), 5),
        ("flash_attention_bwd", _flash_bwd_case(1, 256, 8, 2, 64, gen,
                                                dtype=torch.float32), 5),
    ]
    # the shapes each path's run gives each kernel
    path_cases = {
        "granite-3-8b serving": {
            "rmsnorm": (_rmsnorm_case(rows, g.d_model, gen), 50),
            "flash_attention": (_flash_case(BATCH, PROMPT, PROMPT, g.n_heads, g.n_kv_heads,
                                            g.head_dim, gen), 20),
            "decode_attention": (_decode_case([PROMPT + 1] * BATCH, cache_len, g.n_heads,
                                              g.n_kv_heads, g.head_dim, gen), 50)},
        "zamba2-1.2b serving": {
            "rmsnorm": (_rmsnorm_case(rows, z.d_inner, gen), 50),
            "flash_attention": (_flash_case(BATCH, PROMPT, PROMPT, z.n_heads, z.n_kv_heads,
                                            z.head_dim, gen), 20),
            "decode_attention": (_decode_case([PROMPT + 1] * BATCH, cache_len, z.n_heads,
                                              z.n_kv_heads, z.head_dim, gen), 50),
            "ssm_scan": (_ssm_case(BATCH, PROMPT, z.n_heads, zp, z.ssm_state, z.ssm_chunk,
                                   gen), 20)},
        "h2o-danube-3-4b serving": {
            "rmsnorm": (_rmsnorm_case(rows, h.d_model, gen), 50),
            "flash_attention": (_flash_case(BATCH, PROMPT, PROMPT, h.n_heads, h.n_kv_heads,
                                            h.head_dim, gen, window=h.sliding_window), 20),
            "decode_attention": (_decode_case([PROMPT + 1] * BATCH, cache_len, h.n_heads,
                                              h.n_kv_heads, h.head_dim, gen), 50)},
        "minitron-4b serving": {
            "rmsnorm": (_rmsnorm_case(rows, mt.d_model, gen), 50),
            "flash_attention": (_flash_case(BATCH, PROMPT, PROMPT, mt.n_heads, mt.n_kv_heads,
                                            mt.head_dim, gen), 20),
            "decode_attention": (_decode_case([PROMPT + 1] * BATCH, cache_len, mt.n_heads,
                                              mt.n_kv_heads, mt.head_dim, gen), 50)},
        "gemma3-4b serving": {
            "rmsnorm": (_rmsnorm_case(rows, gm.d_model, gen), 50),
            "flash_attention": (_flash_case(BATCH, PROMPT, PROMPT, gm.n_heads, gm.n_kv_heads,
                                            gm.head_dim, gen, window=gm.sliding_window), 20),
            "decode_attention": (_decode_case([PROMPT + 1] * BATCH, cache_len, gm.n_heads,
                                              gm.n_kv_heads, gm.head_dim, gen), 50)},
        "xlstm-1.3b scoring": {
            "rmsnorm": (_rmsnorm_case(rows, xl.d_model, gen), 50),
            "mlstm_scan": (_mlstm_case(BATCH, PROMPT, xl.n_heads, xhd, xl.ssm_chunk, gen), 20)},
        TRAIN_PATH: {
            "flash_attention_bwd": (_flash_bwd_case(TRAIN_BATCH, TRAIN_SEQ, g.n_heads,
                                                    g.n_kv_heads, g.head_dim, gen), 5),
            "rmsnorm_bwd": (_rmsnorm_bwd_case(TRAIN_BATCH * TRAIN_SEQ, g.d_model, gen), 20)},
    }
    cases = [_run_case(n, c, it) for n, c, it in long_cases]
    path = {label: {n: _run_case(n, c, it) for n, (c, it) in per.items()}
            for label, per in path_cases.items()}
    for r in cases + [r for per in path.values() for r in per.values()]:
        print(f"{r['kernel']:<17} {r['shape']}: err {r['max_abs_err']:.3g} "
              f"({r['tol_share']:.3g} of its tolerance) kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms, "
              f"{r['device_kernels_per_call']} device kernels a call), twin {r['plain_ms']:.4f} ms, "
              f"library {_fmt_ms(r['library_ms'])} (device {_fmt_ms(r['library_device_ms'])}"
              + (f", SDPA backend {r['library_backend']}" if r["library_backend"] else "")
              + f"), bound {r['bound_ms']:.4f} ms ({r['bound_by']})  [{card}]")
    report["cases"], report["path_cases"] = cases, path
    del long_cases, path_cases
    torch.cuda.empty_cache()

    # -- phase 3: the paths, full width --------------------------------------
    report["paths"] = {}
    for label, arch, run, expected, bf16_limit, fp32_limit in PATHS:
        cfg = registry.get_config(arch).replace(use_kernels=True)
        limits = {"bf16_kernel_vs_plain": bf16_limit, "kernel_vs_plain": fp32_limit}
        run_path = {"serve": _serve_path, "score": _score_path, "batch": _batch_path}[run]
        res = run_path(cfg, label, expected, limits, card)
        report["paths"][label] = res
        gc.collect()
        torch.cuda.empty_cache()

    # -- the MNIST train-to-serve leg: no port kernel on its path ----------
    report["mnist_leg"] = _mnist_leg(card)
    gc.collect()
    torch.cuda.empty_cache()

    # -- LM training: both ways through the kernels --------------------------
    report["lm_train_leg"] = _lm_train_leg(card)

    # -- phase 4: report -----------------------------------------------------
    totals = {n: sum(r["launches_run"][n] for r in report["paths"].values())
              + report["mnist_leg"]["launches"][n] + report["lm_train_leg"]["launches"][n]
              for n in META}
    kernels = []
    for n, (route, src, rep, label, _) in META.items():
        r = path[label][n]
        kernels.append({"name": n, "route": route, "source": src, "replaces": rep,
                        "launches": totals[n], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library_device_ms": r["library_device_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print("kernels launched on the paths' runs: " + ", ".join(f"{n} x{totals[n]}" for n in META))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _expect(label: str, launches: dict, expected: tuple) -> None:
    """Every kernel of the path's set launched in its run, and no other."""
    missing = [k for k in expected if launches[k] == 0]
    stray = [k for k, n in launches.items() if n and k not in expected]
    if missing or stray:
        raise AssertionError(f"{label}: kernels never launched {missing}, kernels launched "
                             f"off the path {stray} (counts {launches})")


def _gate(label: str, rel: dict, limits: dict) -> None:
    """Each phase's logits: the limits of ``PATHS`` (None reports only) and
    the drift ratio, gated on every path."""
    for phase, r in rel.items():
        r["ratio"] = r["kernel_vs_fp32"] / max(r["plain_vs_fp32"], 1e-12)
        over = [f"{k} {r[k]} (limit {lim})" for k, lim in limits.items()
                if lim is not None and r[k] > lim]
        if r["ratio"] > DRIFT_RATIO:
            over.append(f"drift ratio {r['ratio']} (limit {DRIFT_RATIO})")
        if over:
            raise AssertionError(f"{label} {phase} logits: " + "; ".join(over) + f" ({r})")

        def lim(k):
            return "report only" if limits[k] is None else f"limit {limits[k]}"
        print(f"{label} {phase} logits, kernel vs plain: bf16 rel {r['bf16_kernel_vs_plain']:.4g} "
              f"({lim('bf16_kernel_vs_plain')}), fp32 rel {r['kernel_vs_plain']:.4g} "
              f"({lim('kernel_vs_plain')}); from fp32: bf16 kernel path "
              f"{r['kernel_vs_fp32']:.4g}, bf16 plain path {r['plain_vs_fp32']:.4g}, ratio "
              f"{r['ratio']:.4g} (limit {DRIFT_RATIO})")


def _wrapper_home(name: str):
    """(module, attribute) of a kernel's wrapper as the path calls it:
    ``ops`` for the forward kernels, the kernel's own module for the
    backward ones (their ``autograd.Function`` calls them there)."""
    import importlib
    where = META[name][4]
    if "." in where:
        mod, attr = where.split(".")
        return importlib.import_module(f"repro_torch.kernels.{mod}"), attr
    return importlib.import_module("repro_torch.kernels.ops"), where


@contextlib.contextmanager
def _recording(names):
    """Record every call of the named kernels' wrappers made inside the
    block: copies of the arguments and of the result (detached, so a
    training step's graph is not kept)."""
    calls: dict = {n: [] for n in names}
    homes = {n: _wrapper_home(n) for n in names}
    saved = {n: getattr(mod, attr) for n, (mod, attr) in homes.items()}

    def copy(v):
        if isinstance(v, tuple):
            return tuple(copy(t) for t in v)
        return v.detach().clone() if hasattr(v, "clone") else v

    def recorder(n, wrapper):
        def call(*args, **kw):
            out = wrapper(*args, **kw)
            calls[n].append((copy(args), {k: copy(v) for k, v in kw.items()}, copy(out)))
            return out
        return call

    for n, wrapper in saved.items():
        setattr(*homes[n], recorder(n, wrapper))
    try:
        yield calls
    finally:
        for n, wrapper in saved.items():
            setattr(*homes[n], wrapper)


def _hold_recorded(label: str, cfg, calls: dict) -> dict:
    """Hold each recorded kernel call against its twin on the same inputs."""
    from repro_torch.kernels import ops
    out = {}
    for n, recs in calls.items():
        twin = getattr(ops, n)
        extra = {"chunk": cfg.ssm_chunk} if n in ("ssm_scan", "mlstm_scan") else {}
        errs, shares = [], []
        for i, (args, kw, got) in enumerate(recs):
            want = twin(*args, **kw, **extra, use_kernel=False)
            pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
            for j, (g, w) in enumerate(pairs):
                e, sh = _check(f"{label}: {n} call {i} output {j} (recorded)", g, w,
                               BWD_FLOOR if n.endswith("_bwd") else 0.0)
                errs.append(e)
                shares.append(sh)
        if not recs:
            raise AssertionError(f"{label}: no call of {n} was recorded")
        out[n] = {"calls": len(recs), "max_abs_err": max(errs), "tol_share": max(shares)}
        print(f"{label}: {n} on its {len(recs)} recorded calls vs its twin: max err "
              f"{out[n]['max_abs_err']:.3g}, {out[n]['tol_share']:.3g} of its tolerance")
    return out


def _rels(pairs: dict) -> dict:
    """phase -> (bf16 kernel, bf16 plain, fp32 kernel, fp32 plain) logits."""
    return {phase: {"kernel_vs_plain": _rel(k32, p32), "kernel_vs_fp32": _rel(k, p32),
                    "plain_vs_fp32": _rel(p, p32), "bf16_kernel_vs_plain": _rel(k, p)}
            for phase, (k, p, k32, p32) in pairs.items()}


def _prompts(cfg):
    import torch
    return torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))


def _serve_path(cfg, label: str, expected: tuple, limits: dict, card: str) -> dict:
    """Serve ``cfg`` through make_lm_predictor and the k8s strategy (on
    KSERVE_PATH also the three strategies of ``_kserve_leg``), time one
    prefill and the greedy decode loop, hold the kernels' recorded calls
    against their twins and gate the logits."""
    import torch
    from repro_torch.clouds.profiles import get_profile
    from repro_torch.kernels import native
    from repro_torch.launch.serve import make_lm_predictor
    from repro_torch.models import lm, steps
    from repro_torch.serving.kserve import InferenceService

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    cache_len = PROMPT + GEN + 1
    pred = make_lm_predictor(cfg, gen_tokens=GEN, prompt_len=PROMPT, params=params)
    prompts = _prompts(cfg).numpy()

    native.reset_launches()
    toks = pred.predict(prompts)
    svc = InferenceService(pred, get_profile("k8s"), "k8s").stress_test(4)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    _expect(label, launches, expected)
    if toks.shape != (BATCH, GEN) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label}: generated tokens out of range / shape {tuple(toks.shape)}")
    summary = svc.summary()
    print(f"{label}: served {summary['n']} requests (k8s strategy): p50 {summary['p50_s']} s; "
          f"launches {launches}  [{card}]")
    kserve = None
    if label == KSERVE_PATH:
        kserve = _kserve_leg(pred, label, expected, card)
        failover = _failover_leg(pred, label, expected, card)
        launches = {k: n + kserve["launches"][k] + failover["launches"][k]
                    for k, n in launches.items()}
        kserve["failover_leg"] = failover

    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
        start = torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")
        per = {}
        native.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last_k, cache = steps.prefill(params, batch, cfg=cfg, cache_len=cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        per["prefill"] = dict(native.LAUNCHES)
        first = torch.argmax(last_k, -1).to(torch.int32)[:, None]
        native.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.greedy_decode_loop(params, cache, first, start, GEN, cfg=cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / GEN
        per["decode_step"] = {k: n // GEN for k, n in native.LAUNCHES.items()}
        del cache
        peak_gib = torch.cuda.max_memory_allocated() / 2**30      # the served runs'
        if not bool(torch.isfinite(last_k.float()).all()):
            raise AssertionError(f"{label}: prefill logits not finite")
        # kernel path vs plain path on the same weights; every kernel call of
        # the kernel path's prefill and decode step recorded
        plain = cfg.replace(use_kernels=False)
        last_p, cache_p = steps.prefill(params, batch, cfg=plain, cache_len=cache_len)
        with _recording(expected) as calls:
            _, cache_k = steps.prefill(params, batch, cfg=cfg, cache_len=cache_len)
            step_k, _ = lm.decode_step(params, cfg, first, start, cache_k)
        step_p, _ = lm.decode_step(params, plain, first, start, cache_p)
        del cache_k, cache_p
        if not bool(torch.isfinite(step_k.float()).all()):
            raise AssertionError(f"{label}: decode-step logits not finite")
        recorded = _hold_recorded(label, cfg, calls)
        del calls
    long_leg = None
    if label == LONG_LEG_PATH:
        long_leg = _long_leg(params, cfg, label, expected, limits, card)
        launches = {k: n + long_leg["launches"][k] for k, n in launches.items()}
    # the same weights in fp32, through the kernels and the plain path: the
    # first gate's pair, and the yardstick both bf16 paths are held against
    with torch.inference_mode():
        params32 = _cast(params, torch.float32)
        del params, pred
        out32 = {}
        for use in (True, False):
            c32 = cfg.replace(dtype="float32", use_kernels=use)
            last, cache32 = steps.prefill(params32, batch, cfg=c32, cache_len=cache_len)
            step, _ = lm.decode_step(params32, c32, first, start, cache32)
            out32[use] = (last, step)
            del cache32
        del params32
    rel = _rels({"prefill": (last_k, last_p, out32[True][0], out32[False][0]),
                 "decode": (step_k, step_p, out32[True][1], out32[False][1])})
    _gate(label, rel, limits)
    print(f"{label}, full width ({cfg.n_layers} layers, {n_params / 1e9:.2f} B params, bf16): "
          f"batch {BATCH} prompt {PROMPT}: prefill {prefill_ms:.2f} ms, decode "
          f"{decode_ms:.2f} ms/token, peak {peak_gib:.2f} GiB; launches per prefill "
          f"{per['prefill']}, per decode step {per['decode_step']}  [{card}]")
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params, "batch": BATCH,
            "prompt": PROMPT, "gen": GEN, "init_s": init_s, "prefill_ms": prefill_ms,
            "decode_ms_per_token": decode_ms, "peak_gib": peak_gib, "rel": rel,
            "recorded": recorded, "launches_run": launches, "launches_per": per,
            "k8s": summary, "kserve_leg": kserve, "long_leg": long_leg}


def _long_leg(params, cfg, label: str, expected: tuple, limits: dict, card: str) -> dict:
    """Batch 1, a prompt of LONG_LEG_PROMPT, GEN new tokens on the serving
    path's weights: timed prefill (``steps.prefill``) and greedy loop, their
    launches held to the path's set; every kernel call of one prefill and
    decode step recorded and held against its twin; the logits gated with
    the path's limits, in bf16 and with the weights in fp32.  The prefill's
    local layers run flash under a window that binds; the decode steps wrap
    the local rings and split the global caches (``n_splits``), so the
    merge kernel runs."""
    import torch
    from repro_torch.kernels import native
    from repro_torch.kernels.decode_attention import n_splits
    from repro_torch.models import lm, steps

    cache_len = LONG_LEG_PROMPT + GEN
    tokens = torch.randint(0, cfg.vocab_size, (1, LONG_LEG_PROMPT), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2)).to("cuda")
    batch = {"tokens": tokens}
    start = torch.full((1,), LONG_LEG_PROMPT, dtype=torch.int32, device="cuda")
    plain = cfg.replace(use_kernels=False)
    with torch.inference_mode():
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last_k, cache = steps.prefill(params, batch, cfg=cfg, cache_len=cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        first = torch.argmax(last_k, -1).to(torch.int32)[:, None]
        rows = sorted({c["k"].shape[2] for pc in cache.values() for c in pc.values()})
        t0 = time.perf_counter()
        toks, _ = steps.greedy_decode_loop(params, cache, first, start, GEN, cfg=cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / GEN
        launches = dict(native.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del cache
        _expect(f"{label} long leg", launches, expected)
        if rows != [cfg.sliding_window, cache_len]:
            raise AssertionError(f"{label} long leg: cache rows {rows}, want the ring of "
                                 f"{cfg.sliding_window} and {cache_len} global rows")
        if not bool(torch.isfinite(last_k.float()).all()) or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"{label} long leg: prefill logits or tokens out of range")
        last_p, cache_p = steps.prefill(params, batch, cfg=plain, cache_len=cache_len)
        with _recording(expected) as calls:
            _, cache_k = steps.prefill(params, batch, cfg=cfg, cache_len=cache_len)
            step_k, _ = lm.decode_step(params, cfg, first, start, cache_k)
        step_p, _ = lm.decode_step(params, plain, first, start, cache_p)
        del cache_k, cache_p
        recorded = _hold_recorded(f"{label} long leg", cfg, calls)
        del calls
        params32 = _cast(params, torch.float32)
        out32 = {}
        for use in (True, False):
            c32 = cfg.replace(dtype="float32", use_kernels=use)
            last, cache32 = steps.prefill(params32, batch, cfg=c32, cache_len=cache_len)
            step, _ = lm.decode_step(params32, c32, first, start, cache32)
            out32[use] = (last, step)
            del cache32
        del params32
    rel = _rels({"long prefill": (last_k, last_p, out32[True][0], out32[False][0]),
                 "long decode": (step_k, step_p, out32[True][1], out32[False][1])})
    _gate(label, rel, limits)
    print(f"{label} long leg: batch 1 prompt {LONG_LEG_PROMPT}: prefill {prefill_ms:.2f} ms, "
          f"decode {decode_ms:.2f} ms/token, peak {peak_gib:.2f} GiB; cache rows {rows} (decode "
          f"splits {[n_splits(r) for r in rows]}); launches {launches}  [{card}]")
    return {"batch": 1, "prompt": LONG_LEG_PROMPT, "gen": GEN, "prefill_ms": prefill_ms,
            "decode_ms_per_token": decode_ms, "peak_gib": peak_gib, "cache_rows": rows,
            "rel": rel, "recorded": recorded, "launches": launches}


def _latency_floor(label: str, res, prof, least_service_s: float) -> None:
    """No request is served faster than the network path (RTT + load
    balancer) plus the least measured service time; a latency is
    (t + rtt + lb + service) - arrival, exact up to rounding."""
    floor = prof.network_rtt_s + prof.lb_overhead_s + least_service_s
    if min(res.latencies_s) < floor - 1e-9:
        raise AssertionError(f"{label}: latency {min(res.latencies_s)} s below the floor "
                             f"{floor} s (RTT + LB + least service time)")


def _kserve_leg(pred, label: str, expected: tuple, card: str) -> dict:
    """The paper's stress test on the card-measured Predictor: a burst of
    KSERVE_REQUESTS under baremetal (profile baremetal), k8s (k8s) and kserve
    (gcp, batches of up to KSERVE_BATCH), the launches of the whole leg held
    to the path's set.  Gated: every request served once, the paper's order
    of total times (baremetal > k8s > kserve), the latency floor."""
    import torch
    from repro_torch.clouds.profiles import get_profile
    from repro_torch.kernels import native
    from repro_torch.serving.kserve import InferenceService

    native.reset_launches()
    res = {strat: InferenceService(pred, get_profile(prof), strat, max_batch=KSERVE_BATCH)
           .stress_test(KSERVE_REQUESTS)
           for strat, prof in (("baremetal", "baremetal"), ("k8s", "k8s"), ("kserve", "gcp"))}
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    _expect(f"{label} kserve leg", launches, expected)
    svc = {b: pred.service_time(b) for b in (1, KSERVE_BATCH)}    # measured in the leg
    for strat, r in res.items():
        if len(r.latencies_s) != KSERVE_REQUESTS:
            raise AssertionError(f"{label} {strat}: {len(r.latencies_s)} of {KSERVE_REQUESTS} "
                                 f"requests served")
        prof = get_profile("gcp" if strat == "kserve" else strat)
        _latency_floor(f"{label} {strat}", r, prof, min(svc.values()))
    if sum(res["kserve"].per_version.values()) != KSERVE_REQUESTS:
        raise AssertionError(f"{label} kserve: per-version counts {res['kserve'].per_version}")
    totals = {strat: r.total_time_s for strat, r in res.items()}
    if not totals["baremetal"] > totals["k8s"] > totals["kserve"]:
        raise AssertionError(f"{label}: total times {totals}, not baremetal > k8s > kserve")
    ks = res["kserve"].summary()
    print(f"{label} kserve leg, {KSERVE_REQUESTS} requests in a burst: total baremetal "
          f"{totals['baremetal']:.4f} s, k8s {totals['k8s']:.4f} s, kserve {totals['kserve']:.4f} s "
          f"(k8s / kserve {totals['k8s'] / totals['kserve']:.2f}); kserve p50 {ks['p50_s']} s, "
          f"p99 {ks['p99_s']} s, replicas_max {ks['replicas_max']}; service_time(1) "
          f"{svc[1]:.4f} s, service_time({KSERVE_BATCH}) {svc[KSERVE_BATCH]:.4f} s; launches "
          f"{launches}  [{card}]")
    return {"requests": KSERVE_REQUESTS, "max_batch": KSERVE_BATCH, "totals_s": totals,
            "summaries": {strat: r.summary() for strat, r in res.items()},
            "service_time_s": svc, "launches": launches}


def _gateway_leg(be, label: str, card: str) -> dict:
    """``BatcherBackend``, measured already (its estimates are cached, so
    this costs no card time), deployed in the port's Gateway on gcp with a
    batch of its slots and one warm replica: GATEWAY_REQUESTS Poisson
    arrivals from a seed at one per service_time(1) in all, half standard
    and half latency class.  Gated: every request served once, the latency
    floor."""
    from repro_torch.clouds.profiles import get_profile
    from repro_torch.serving.gateway import AutoscalerConfig, Gateway, TrafficSpec

    prof = get_profile("gcp")
    svc1 = be.service_time(1)
    gw = Gateway(record_batches=True)
    gw.deploy(be.name, be, prof, max_batch=be.batcher.max_slots,
              autoscaler=AutoscalerConfig(min_replicas=1))
    traffic = [TrafficSpec(be.name, GATEWAY_REQUESTS // 2, arrival="poisson",
                           rate=0.5 / svc1, slo=c) for c in ("standard", "latency")]
    res = gw.run(traffic, seed=0).per_model[be.name]
    served = sorted(i for rec in gw.batch_log if not rec["preempted"] for i in rec["idx"])
    if (served != list(range(GATEWAY_REQUESTS)) or len(res.latencies_s) != GATEWAY_REQUESTS
            or sum(res.per_version.values()) != GATEWAY_REQUESTS):
        raise AssertionError(f"{label} gateway leg: {len(served)} batched, "
                             f"{len(res.latencies_s)} latencies, versions {res.per_version}")
    _latency_floor(f"{label} gateway leg", res, prof, svc1)
    pc = res.per_class()
    s = res.summary()
    print(f"{label} gateway leg, {GATEWAY_REQUESTS} Poisson requests at {1 / svc1:.3f} req/s "
          f"(BatcherBackend service_time(1) {svc1:.4f} s, batches of up to "
          f"{be.batcher.max_slots}): " + "; ".join(
              f"{c} p50 {v['p50_s']} s p99 {v['p99_s']} s miss rate {v['miss_rate']}"
              for c, v in pc.items())
          + f"; total {s['total_s']} s, replicas_max {s['replicas_max']}  [{card}]")
    return {"requests": GATEWAY_REQUESTS, "rate_rps": 1 / svc1, "summary": s}


def _leg_launches(label: str, launches: dict, expected: tuple) -> None:
    """A gateway leg over an already measured backend launches nothing, or,
    where it measures a batch size the path has not run yet, exactly the
    path's set."""
    if any(launches.values()):
        _expect(label, launches, expected)


def _disagg_leg(be, label: str, expected: tuple, card: str) -> dict:
    """The measured ``BatcherBackend`` staged across two pools: prefill on
    gcp, decode on ibm (``DisaggSpec`` with the backend's own prompt and
    generation lengths, a KV budget that holds every request at once), one
    warm replica each, GATEWAY_REQUESTS Poisson arrivals at one per
    service_time(1), half standard and half latency class.  Gated: every
    request served exactly once by a decode batch after its prefill batch,
    the ``gateway:prefill`` events' sizes sum to the served count, no KV
    block leaked, every event name registered, and no latency below the
    least network path plus the smaller measured phase time."""
    import torch
    from repro_torch.clouds.profiles import get_profile
    from repro_torch.kernels import native
    from repro_torch.serving.gateway import (AutoscalerConfig, DisaggSpec, Gateway,
                                             TrafficSpec)
    from repro_torch.telemetry.events import EventLog, unregistered

    profs = {c: get_profile(c) for c in ("gcp", "ibm")}
    spec = DisaggSpec(block_size=16, prompt_tokens=be.prompt_len, gen_tokens=be.gen_tokens,
                      pool_kind={"gcp": "prefill", "ibm": "decode"})
    spec = dataclasses.replace(spec, kv_blocks=GATEWAY_REQUESTS * spec.blocks_per_request)
    native.reset_launches()
    svc1 = be.service_time(1)
    phases = {"prefill": be.prefill_time(be.prompt_len), "decode": be.decode_time(be.gen_tokens)}
    gw = Gateway(log=EventLog(), record_batches=True)
    gw.deploy(be.name, be, split={profs["gcp"]: 0.5, profs["ibm"]: 0.5},
              max_batch=be.batcher.max_slots,
              autoscaler=AutoscalerConfig(min_replicas=2, max_replicas=4), disagg=spec)
    traffic = [TrafficSpec(be.name, GATEWAY_REQUESTS // 2, arrival="poisson",
                           rate=0.5 / svc1, slo=c) for c in ("standard", "latency")]
    out = gw.run(traffic, seed=0)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    _leg_launches(f"{label} disagg leg", launches, expected)
    res = out.per_model[be.name]
    recs = [r for r in gw.batch_log if not r["preempted"]]
    by_stage = {st: sorted(i for r in recs if r["stage"] == st for i in r["idx"])
                for st in ("prefill", "decode")}
    every = list(range(GATEWAY_REQUESTS))
    if (by_stage["prefill"] != every or by_stage["decode"] != every or res.shed_total
            or len(res.latencies_s) != GATEWAY_REQUESTS):
        raise AssertionError(f"{label} disagg leg: prefilled {len(by_stage['prefill'])}, "
                             f"decoded {len(by_stage['decode'])}, shed {res.shed_total}, "
                             f"{len(res.latencies_s)} latencies of {GATEWAY_REQUESTS}")
    if {r["cloud"] for r in recs if r["stage"] == "prefill"} != {"gcp"} or \
            {r["cloud"] for r in recs if r["stage"] == "decode"} != {"ibm"}:
        raise AssertionError(f"{label} disagg leg: a stage ran off its pool")
    prefilled = sum(e["n"] for e in gw.log.named("gateway:prefill"))
    if prefilled != GATEWAY_REQUESTS:
        raise AssertionError(f"{label} disagg leg: gateway:prefill sizes sum to {prefilled}")
    leaked = sum(gw.final_kv[be.name].values())
    if leaked != 0:
        raise AssertionError(f"{label} disagg leg: {leaked} KV blocks leaked {gw.final_kv}")
    stray = unregistered(gw.log)
    if stray:
        raise AssertionError(f"{label} disagg leg: unregistered event names {stray}")
    floor = min(p.network_rtt_s + p.lb_overhead_s for p in profs.values()) + min(phases.values())
    if min(res.latencies_s) < floor - 1e-9:
        raise AssertionError(f"{label} disagg leg: latency {min(res.latencies_s)} s below the "
                             f"floor {floor} s (least RTT + LB + smaller phase time)")
    pc = res.per_class()
    s = res.summary()
    print(f"{label} disagg leg, {GATEWAY_REQUESTS} Poisson requests at {1 / svc1:.3f} req/s, "
          f"prefill on gcp and decode on ibm (prompt {be.prompt_len}, {be.gen_tokens} new "
          f"tokens, {spec.kv_blocks} KV blocks of {spec.block_size}): estimates prefill chunk "
          f"{be.prefill_time(be.batcher.prefill_chunk) * 1e3:.3f} ms, decode step "
          f"{be.decode_time(1) * 1e3:.3f} ms; " + "; ".join(
              f"{c} p50 {v['p50_s']} s p99 {v['p99_s']} s" for c, v in pc.items())
          + f"; {len(gw.log.named('gateway:prefill'))} prefill batches, replicas_max "
          f"{s['replicas_max']}; launches {launches}  [{card}]")
    return {"requests": GATEWAY_REQUESTS, "rate_rps": 1 / svc1, "phase_s": phases,
            "kv_blocks": spec.kv_blocks, "summary": s, "final_kv": gw.final_kv[be.name],
            "prefill_batches": len(gw.log.named("gateway:prefill")), "launches": launches}


def _failover_leg(pred, label: str, expected: tuple, card: str) -> dict:
    """The card-measured Predictor on gcp with an ibm standby, in
    ``slo_failover``'s shape: FAILOVER_MIX requests of the batch, standard
    and latency classes (sized from the measured service_time(KSERVE_BATCH)),
    an outage of gcp from 0.6 to 1.1 of the batch backlog's drain time,
    admission control on, a tracer, a metrics registry, burn-rate alerts and
    a scrape clock attached; then ``plan_placement`` / ``replan`` from the
    observed run and a second run with the revised weights applied live by
    a ``MigrationSpec``.  The pow2 batch sizes the gateway prices are
    measured first, their launches counted.  Gated: every request served xor
    shed exactly once and the batch class never shed; gcp's split weight 0
    through the outage and back afterwards, no batch started on gcp while it
    was down; every split summing to 1; a well-formed trace; the served and
    shed counters equal to the offered count; burn-alert edges alternating;
    the migration applied with every request of the second run served."""
    import torch
    from repro_torch.clouds.profiles import get_profile
    from repro_torch.kernels import native
    from repro_torch.serving.gateway import (AdmissionConfig, AutoscalerConfig, CloudCapacity,
                                             FailureSpec, Gateway, MigrationSpec, ModelDemand,
                                             TrafficSpec, plan_placement, replan)
    from repro_torch.telemetry.analyze import validate_trace
    from repro_torch.telemetry.events import EventLog, unregistered
    from repro_torch.telemetry.metrics import MetricsRegistry
    from repro_torch.telemetry.slo import BurnRateConfig
    from repro_torch.telemetry.trace import Tracer

    native.reset_launches()
    sizes = [b for b in (1, 2, 4, 8, 16, 32) if b <= KSERVE_BATCH]
    pred.warmup(sizes)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    _leg_launches(f"{label} failover leg", launches, expected)
    native.reset_launches()
    gcp, ibm = get_profile("gcp"), get_profile("ibm")
    t_b = pred.service_time(KSERVE_BATCH)
    n_batch, n_std, n_lat = FAILOVER_MIX
    drain = (n_batch / KSERVE_BATCH) * (gcp.network_rtt_s + t_b) / 2
    guess = ModelDemand(pred.name, rate=n_std / drain, service_time_s=t_b / KSERVE_BATCH)
    plan = plan_placement([guess], [CloudCapacity(gcp, 8, 1.0), CloudCapacity(ibm, 8, 1.4)],
                          objective="p99")
    tracer, reg = Tracer(), MetricsRegistry()
    gw = Gateway(capacity=plan.capacity_map(), log=EventLog(), record_batches=True,
                 admission=AdmissionConfig(), tracer=tracer, metrics=reg,
                 slo_burn=BurnRateConfig(threshold=2.0, min_n=4), scrape_every_s=drain / 20)
    gw.deploy(pred.name, pred, gcp, standby=ibm, max_batch=KSERVE_BATCH,
              autoscaler=AutoscalerConfig(min_replicas=1, max_replicas=2, scale_up_delay_s=0.02,
                                          idle_window_s=math.inf))
    traffic = [TrafficSpec(pred.name, n_batch, slo="batch"),
               TrafficSpec(pred.name, n_std, slo="standard", arrival="poisson",
                           rate=n_std / drain),
               TrafficSpec(pred.name, n_lat, slo="latency", arrival="poisson",
                           rate=n_lat / (0.4 * drain))]
    outage = FailureSpec("gcp", at_s=0.6 * drain, duration_s=0.5 * drain)
    out = gw.run(traffic, seed=0, failures=[outage])
    n = sum(FAILOVER_MIX)
    res = out.per_model[pred.name]
    served = [i for r in gw.batch_log if not r["preempted"] for i in r["idx"]]
    shed = [e["idx"] for e in gw.log.named("gateway:shed")]
    if sorted(served + shed) != list(range(n)) or len(res.latencies_s) != len(served):
        raise AssertionError(f"{label} failover leg: {len(served)} served, {len(shed)} shed "
                             f"of {n}, not each exactly once")
    if res.class_shed.get("batch", 0) or len(res.class_latencies["batch"]) != n_batch:
        raise AssertionError(f"{label} failover leg: batch class shed {res.class_shed}")
    splits = gw.log.named("gateway:split")
    edges = [(e["reason"], e["weights"]["gcp"]) for e in splits]
    if ("fail", 0.0) not in edges or edges[-1] != ("recover", 1.0) or \
            gw.final_weights[pred.name]["gcp"] != 1.0:
        raise AssertionError(f"{label} failover leg: split edges {edges}, final "
                             f"{gw.final_weights}")
    down = (outage.at_s, outage.at_s + outage.duration_s)
    on_dead = [r for r in gw.batch_log
               if r["cloud"] == "gcp" and down[0] <= r["start_s"] < down[1]]
    if on_dead:
        raise AssertionError(f"{label} failover leg: {len(on_dead)} batches started on gcp "
                             f"while it was down")
    if any(abs(sum(e["weights"].values()) - 1.0) > 1e-9 for e in splits):
        raise AssertionError(f"{label} failover leg: a split does not sum to 1: {splits}")
    bad = validate_trace(tracer)
    if bad or len(tracer.named("gateway.request")) != n:
        raise AssertionError(f"{label} failover leg: trace violations {bad[:5]}")
    counted = (reg.total("gateway_requests_total", model=pred.name, outcome="served"),
               reg.total("gateway_requests_total", model=pred.name, outcome="shed"))
    if counted != (len(served), len(shed)):
        raise AssertionError(f"{label} failover leg: counters {counted}, want "
                             f"{(len(served), len(shed))}")
    alerts: dict = {}
    for e in gw.log.named("gateway:alert"):
        alerts.setdefault(e["cls"], []).append(e["state"])
    for cls, states in alerts.items():
        if any(s != ("firing" if i % 2 == 0 else "resolved") for i, s in enumerate(states)):
            raise AssertionError(f"{label} failover leg: {cls} alert edges {states}")
    revised = replan(plan, out)
    target = dict(next(a for a in revised.assignments if a.model == pred.name).weights)
    out2 = gw.run([TrafficSpec(pred.name, n_std, slo="standard", arrival="poisson",
                               rate=n_std / drain)],
                  seed=1, migrations=[MigrationSpec(0.3 * drain, {pred.name: target})])
    res2 = out2.per_model[pred.name]
    migrated = [e for e in gw.log.named("gateway:migrate") if e.get("reason") == "plan"]
    if not migrated or len(res2.latencies_s) + res2.shed_total != n_std or \
            any(abs(w - target.get(c, 0.0)) > 1e-9
                for c, w in gw.final_weights[pred.name].items()):
        raise AssertionError(f"{label} failover leg: migration to {target} gave "
                             f"{gw.final_weights}, {len(res2.latencies_s)} served")
    stray = unregistered(gw.log)
    if stray:
        raise AssertionError(f"{label} failover leg: unregistered event names {stray}")
    torch.cuda.synchronize()
    run_launches = dict(native.LAUNCHES)
    _leg_launches(f"{label} failover leg runs", run_launches, expected)
    launches = {k: v + run_launches[k] for k, v in launches.items()}
    pc = res.per_class()
    print(f"{label} failover leg, {n} requests ({n_batch} batch, {n_std} standard, {n_lat} "
          f"latency; service_time({KSERVE_BATCH}) {t_b:.4f} s), gcp down "
          f"{down[0]:.3f}-{down[1]:.3f} s: " + "; ".join(
              f"{c} p50 {v['p50_s']} s p99 {v['p99_s']} s shed {v['shed']}"
              for c, v in pc.items())
          + f"; {gw.log.count('gateway:failover')} failover, "
          f"{gw.log.count('gateway:recover')} recover, {gw.log.count('gateway:preempt')} "
          f"preempt, {len(alerts)} alerting classes, {len(tracer.spans)} spans, "
          f"{len(reg.scrapes)} scrapes; migration to {target}: {len(res2.latencies_s)} of "
          f"{n_std} served, p99 {res2.summary()['p99_s']} s; launches {launches}  [{card}]")
    return {"requests": n, "mix": FAILOVER_MIX, "drain_s": drain, "outage_s": down,
            "service_time_s": {b: pred.service_time(b) for b in sizes},
            "per_class": pc, "split_edges": edges, "shed": len(shed),
            "migration_target": target, "migration_summary": res2.summary(),
            "launches": launches}


def _score_path(cfg, label: str, expected: tuple, limits: dict, card: str) -> dict:
    """Score a batch through ``steps.loss_fn`` (the full-sequence forward
    with no cache, then the cross entropy), time the forward, hold the
    kernels' recorded calls against their twins and gate the logits."""
    import torch
    from repro_torch.kernels import native
    from repro_torch.models import lm, steps

    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = _prompts(cfg).to("cuda")
    batch = {"tokens": tokens, "labels": tokens}
    with torch.inference_mode():
        native.reset_launches()
        loss, metrics = steps.loss_fn(params, cfg, batch)
        torch.cuda.synchronize()
        launches = dict(native.LAUNCHES)
        _expect(label, launches, expected)
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"{label}: loss not finite")
        t0 = time.perf_counter()
        logits_k, _, _ = lm.forward(params, cfg, batch)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
        peak_gib = torch.cuda.max_memory_allocated() / 2**30      # the scoring runs'
        with _recording(expected) as calls:
            lm.forward(params, cfg, batch)
        recorded = _hold_recorded(label, cfg, calls)
        del calls
        plain = cfg.replace(use_kernels=False)
        logits_p, _, _ = lm.forward(params, plain, batch)
        loss_p, _ = steps.loss_fn(params, plain, batch)
    with torch.inference_mode():
        params32 = _cast(params, torch.float32)
        del params
        cfg32 = cfg.replace(dtype="float32", use_kernels=False)
        logits_kx, _, _ = lm.forward(params32, cfg32.replace(use_kernels=True), batch)
        logits_x, _, _ = lm.forward(params32, cfg32, batch)
        loss_x, _ = steps.loss_fn(params32, cfg32, batch)
        del params32
    rel = _rels({"forward": (logits_k, logits_p, logits_kx, logits_x)})
    _gate(label, rel, limits)
    losses = {"kernel": float(loss), "plain": float(loss_p), "fp32": float(loss_x)}
    print(f"{label}, full width ({cfg.n_layers} layers, {n_params / 1e9:.2f} B params, bf16): "
          f"batch {BATCH} x {PROMPT} tokens: forward {forward_ms:.2f} ms, peak {peak_gib:.2f} "
          f"GiB, loss {losses}; launches per forward {launches}  [{card}]")
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params, "batch": BATCH,
            "tokens": PROMPT, "forward_ms": forward_ms, "peak_gib": peak_gib, "rel": rel,
            "recorded": recorded, "loss": losses, "launches_run": launches,
            "launches_per": {"forward": launches}}


def _batch_mix(cfg) -> list:
    """Eight prompts from a seed: three of 16-64 tokens, four of 65-256 and,
    second in the queue, one of 4400 (past the 4096-row ring)."""
    import numpy as np
    rng = np.random.default_rng(3)
    lens = [int(n) for n in rng.integers(SHORT_PROMPT // 4, SHORT_PROMPT + 1, 3)] + \
        [int(n) for n in rng.integers(SHORT_PROMPT + 1, 4 * SHORT_PROMPT + 1, 4)]
    lens.insert(1, LONG_PROMPT)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


@contextlib.contextmanager
def _first_step_logits(store: list):
    """Keep a copy of the logits of the first ``lm.decode_step`` call made
    inside the block (the batcher calls it through the module)."""
    from repro_torch.models import lm
    real = lm.decode_step

    def spy(*args, **kw):
        logits, cache = real(*args, **kw)
        if not store:
            store.append(logits.float().clone())
        return logits, cache

    lm.decode_step = spy
    try:
        yield
    finally:
        lm.decode_step = real


def _batcher(cfg, params, prompts: list, chunk: int):
    """A ContinuousBatcher with ``prompts`` queued (16 new tokens each)."""
    from repro_torch.serving.continuous import ContinuousBatcher
    cb = ContinuousBatcher(cfg, params, max_slots=BATCH_SLOTS, max_len=BATCH_MAX_LEN,
                           prefill_chunk=chunk)
    return cb, [cb.submit(p, GEN) for p in prompts]


def _batch_path(cfg, label: str, expected: tuple, limits: dict, card: str) -> dict:
    """Serve a mix of eight requests through ``ContinuousBatcher`` (4 slots,
    4608-row cache, prefill chunks of 256), more requests than slots, one
    prompt past the ring.  In bf16: the timed kernel run (launches, tokens/s,
    peak memory), token agreement and first-step logits against the plain
    path (reported), every kernel call of the first step (admission
    prefills, the long one included, then a decode on the wrapped ring) held
    against its twin, the peak-memory rise of one 256-row chunk on a wrapped
    ring (gated), and ``BatcherBackend``'s measured costs.  With the weights
    in fp32, kernels on: every request's tokens equal the non-batched path's
    (``steps.prefill`` at B 1, then ``greedy_decode_loop``), and the short
    prompts' equal the teacher-forced batcher's (gated)."""
    import torch
    from repro_torch.kernels import native
    from repro_torch.models import lm, steps
    from repro_torch.serving.gateway import BatcherBackend

    params = lm.init_params(cfg, seed=0, device="cuda")
    prompts = _batch_mix(cfg)
    plain = cfg.replace(use_kernels=False)
    with torch.inference_mode():
        cb, reqs = _batcher(cfg, params, prompts, BATCH_CHUNK)
        first_k, first_p = [], []
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        t0 = time.perf_counter()
        with _first_step_logits(first_k):
            done = cb.run()
        wall = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        _expect(label, launches, expected)
        toks_k = [r.output for r in reqs]
        n_tokens = sum(len(t) for t in toks_k)
        if len(done) != len(prompts) or n_tokens != GEN * len(prompts):
            raise AssertionError(f"{label}: {len(done)} requests finished, {n_tokens} tokens")
        stats = dict(cb.prefill_stats)
        del cb, reqs
        cbp, reqs = _batcher(plain, params, prompts, BATCH_CHUNK)
        with _first_step_logits(first_p):
            cbp.run()
        toks_p = [r.output for r in reqs]
        del cbp, reqs
        # every kernel call of the first step, held against its twin
        cbr, _ = _batcher(cfg, params, prompts, BATCH_CHUNK)
        with _recording(expected) as calls:
            cbr.step()
        del cbr
        recorded = _hold_recorded(label, cfg, calls)
        del calls
        # one 256-row chunk on a wrapped ring (positions 4096..4351)
        row = lm.init_cache(cfg, 1, BATCH_MAX_LEN, device="cuda")
        tok = torch.tensor([prompts[1][:BATCH_CHUNK]], dtype=torch.int32, device="cuda")
        pos = torch.arange(cfg.sliding_window, cfg.sliding_window + BATCH_CHUNK,
                           dtype=torch.int32, device="cuda")[None]
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lm.prefill_chunk(params, cfg, tok, pos, row)
        torch.cuda.synchronize()
        chunk_rise = torch.cuda.max_memory_allocated() - before
        del row
        if chunk_rise >= RING_CHUNK_BYTES:
            raise AssertionError(f"{label}: one {BATCH_CHUNK}-row ring chunk raised peak memory "
                                 f"by {chunk_rise / 1e9:.3f} GB (limit {RING_CHUNK_BYTES / 1e9} GB)")
        be = BatcherBackend(cfg.name, _batcher(cfg, params, [], BATCH_CHUNK)[0],
                            prompt_len=2 * BATCH_CHUNK, gen_tokens=GEN)
        backend = {"chunk_ms": be.prefill_time(BATCH_CHUNK) * 1e3,
                   "step_ms": be.decode_time(1) * 1e3,
                   "service_time_1_s": be.service_time(1), "service_time_8_s": be.service_time(8)}
        gateway = _gateway_leg(be, label, card)
        disagg = _disagg_leg(be, label, expected, card)
        launches = {k: n + disagg["launches"][k] for k, n in launches.items()}
        gateway["disagg_leg"] = disagg
        del be
    agree = sum(a == b for tk, tp in zip(toks_k, toks_p) for a, b in zip(tk, tp)) / n_tokens
    first_rel = _rel(first_k[0], first_p[0])
    # the same weights in fp32, kernels on: the token gates
    with torch.inference_mode():
        params32 = _cast(params, torch.float32)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        c32 = cfg.replace(dtype="float32")
        cb32, reqs = _batcher(c32, params32, prompts, BATCH_CHUNK)
        cb32.run()
        toks32 = [r.output for r in reqs]
        del cb32, reqs
        alone = []
        for p in prompts:
            last, cache = steps.prefill(params32, {"tokens": torch.tensor([p], device="cuda")},
                                        cfg=c32, cache_len=BATCH_MAX_LEN)
            first = torch.argmax(last, -1).to(torch.int32)[:, None]
            rest, _ = steps.greedy_decode_loop(
                params32, cache, first, torch.full((1,), len(p), dtype=torch.int32,
                                                   device="cuda"), GEN - 1, cfg=c32)
            alone.append([int(first[0, 0])] + rest[0].tolist())
            del cache
        short = [i for i, p in enumerate(prompts) if len(p) <= SHORT_PROMPT]
        cbt, reqs = _batcher(c32, params32, [prompts[i] for i in short], 0)
        cbt.run()
        toks_tf = [r.output for r in reqs]
        del cbt, reqs, params32
    agree32 = sum(a == b for tk, t32 in zip(toks_k, toks32) for a, b in zip(tk, t32)) / n_tokens
    off = [i for i in range(len(prompts)) if toks32[i] != alone[i]]
    if off:
        raise AssertionError(f"{label}: fp32 batcher tokens differ from the non-batched path for "
                             f"requests {off} (prompt lengths {[len(prompts[i]) for i in off]})")
    if toks_tf != [toks32[i] for i in short]:
        raise AssertionError(f"{label}: fp32 prefill batcher differs from the teacher-forced "
                             f"batcher on the short prompts {short}")
    print(f"{label}, full width ({cfg.n_layers} layers, bf16): {len(prompts)} requests "
          f"(prompts {[len(p) for p in prompts]}), {BATCH_SLOTS} slots, chunks of "
          f"{BATCH_CHUNK}: drained in {wall:.3f} s, {n_tokens / wall:.2f} tokens/s, "
          f"{stats['chunks']} prefill chunks, peak {peak_gib:.2f} GiB; launches {launches}  "
          f"[{card}]")
    print(f"{label}: fp32 tokens equal the non-batched path for all {len(prompts)} requests "
          f"and the teacher-forced batcher for prompts {short}; bf16 kernel vs plain: token "
          f"agreement {agree:.4f}, first step logits rel {first_rel:.4g} (report only); bf16 "
          f"kernel vs fp32 tokens agreement {agree32:.4f}")
    print(f"{label}: one {BATCH_CHUNK}-row chunk on a wrapped ring raises peak memory by "
          f"{chunk_rise / 1e9:.4f} GB (limit {RING_CHUNK_BYTES / 1e9} GB); BatcherBackend: chunk "
          f"{backend['chunk_ms']:.3f} ms, step {backend['step_ms']:.3f} ms, service_time(1) "
          f"{backend['service_time_1_s']:.4f} s, service_time(8) "
          f"{backend['service_time_8_s']:.4f} s  [{card}]")
    return {"arch": cfg.name, "layers": cfg.n_layers, "prompts": [len(p) for p in prompts],
            "slots": BATCH_SLOTS, "max_len": BATCH_MAX_LEN, "chunk": BATCH_CHUNK, "gen": GEN,
            "drain_s": wall, "tokens_per_s": n_tokens / wall, "peak_gib": peak_gib,
            "prefill_stats": stats, "bf16_token_agreement": agree,
            "bf16_vs_fp32_token_agreement": agree32, "first_step_rel": first_rel,
            "ring_chunk_peak_rise_bytes": chunk_rise, "backend": backend, "gateway_leg": gateway,
            "recorded": recorded, "launches_run": launches, "launches_per": {"run": launches}}


def _mnist_leg(card: str) -> dict:
    """The paper's MNIST train-to-serve workload through the port's own
    entry points, LeNet at full width (MNIST_WIDTH, batches of MNIST_BATCH,
    fp32), launch counts zeroed before it and read after (no port kernel is
    on this path, so none may launch):

    - ``e2e_train_to_serve.train_to_serve`` on MNIST_TRAIN images: Katib
      (random, 3 trials x 10 steps, lr around quickstart's MNIST_LR) ->
      ``SupervisedTrainJob`` (MNIST_STEPS steps) -> per-cloud profiles of the
      trained model's Predictor -> a profile-planned split deploy, run twice
      as a recurring pipeline over one tracer, metrics registry and capacity
      market, then 512 Poisson requests at half the fleet ceiling; gated
      by the example's own ``check``;
    - the trained model: every reported loss finite, the last below the
      first, holdout accuracy > 0.5;
    - the card against the port's CPU path on one init (a CPU generator)
      and the same batches: logits, the first step's gradients and the
      losses of 10 training steps at MNIST_LIMITS (the parameters and the
      holdout logits after them reported);
    - a checkpoint round trip on the card: bit-equal logits, equal
      ``tree_hash``, every stored leaf fp32 numpy;
    - the paper's Table 3 on its own model: the trained LeNet's Predictor
      under baremetal, k8s and kserve (MNIST_TABLE3_REQUESTS in a burst,
      batches of up to MNIST_TABLE3_BATCH, 4 replicas), gated as
      ``_kserve_leg`` gates granite's;
    - one training step and one predict at MNIST_TABLE3_BATCH traced."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.store import ArtifactStore, tree_hash
    from repro_torch.clouds.profiles import get_profile
    from repro_torch.core.trainjob import train_step
    from repro_torch.data.mnist import Batches, make_dataset
    from repro_torch.examples.e2e_train_to_serve import check, lenet_predictor, train_to_serve
    from repro_torch.kernels import native
    from repro_torch.launch.profile import trace
    from repro_torch.models import lenet
    from repro_torch.optim import adamw
    from repro_torch.serving.kserve import InferenceService

    label = "mnist train-to-serve"
    imgs, labels = make_dataset(MNIST_TRAIN, seed=0)
    h_imgs, h_labels = make_dataset(MNIST_HOLDOUT, seed=7)
    native.reset_launches()
    t0 = time.perf_counter()
    out = train_to_serve(imgs, labels, device="cuda", width=MNIST_WIDTH,
                         lr_space=(MNIST_LR / 2, MNIST_LR * 2), tune_steps=10,
                         train_steps=MNIST_STEPS)
    orchestrated = check(out)
    leg_s = time.perf_counter() - t0
    trained = out["trained"]
    params = trained["params"]
    losses = trained["reported"]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: reported losses {losses} not finite and falling")
    with torch.inference_mode():
        pred = torch.argmax(lenet.apply(params, h_imgs), -1).cpu().numpy()
    holdout = float((pred == h_labels).mean())
    if not holdout > 0.5:
        raise AssertionError(f"{label}: holdout accuracy {holdout} (gate > 0.5)")
    wall = trained["wall_s"]
    print(f"{label}: recurring pipeline x2 and {out['requests']} Poisson requests in "
          f"{leg_s:.2f} s; trained lr {trained['lr']:.5f}, {MNIST_STEPS} steps in {wall:.3f} s "
          f"({MNIST_STEPS / wall:.1f} steps/s, {MNIST_STEPS * MNIST_BATCH / wall:.0f} images/s), "
          f"losses {[round(v, 4) for v in losses]}, holdout accuracy {holdout:.4f} on "
          f"{MNIST_HOLDOUT}; deploy {orchestrated['deploy']}, planned from "
          f"{orchestrated['planned_from']['cloud']} at "
          f"{orchestrated['planned_from']['service_time_s'] * 1e6:.2f} us/request; stress p50 "
          f"{orchestrated['stress']['p50_s']:.6f} s p99 {orchestrated['stress']['p99_s']:.6f} s; "
          f"{orchestrated['leases']} leases, {orchestrated['preempts']} preempts  [{card}]")

    # the card against the port's CPU path, one init, the same batches
    init = {d: lenet.init_params(torch.Generator().manual_seed(0), width=MNIST_WIDTH, device=d)
            for d in ("cpu", "cuda")}
    rel = {"logits": _rel(lenet.apply(init["cuda"], imgs[:MNIST_BATCH]),
                          lenet.apply(init["cpu"], imgs[:MNIST_BATCH]).cuda())}
    grads = {}
    for d, p in init.items():
        leaves = adamw.tree_map(lambda t: t.requires_grad_(), p)
        loss, _ = lenet.loss_fn(leaves, {"image": imgs[:MNIST_BATCH],
                                         "label": labels[:MNIST_BATCH]})
        grads[d] = torch.autograd.grad(loss, adamw.tree_leaves(leaves))
    rel["grads"] = max(_rel(g, c.cuda()) for g, c in zip(grads["cuda"], grads["cpu"]))
    cfg = adamw.AdamWConfig(lr=MNIST_LR, weight_decay=1e-4)
    opt = {d: adamw.init_opt_state(p) for d, p in init.items()}
    steps_rel = []
    for i, b in enumerate(Batches(imgs, labels, MNIST_BATCH)):
        if i == 10:
            break
        step_loss = {}
        for d in init:
            bt = {k: torch.as_tensor(v, device=d) for k, v in b.items()}
            init[d], opt[d], m = train_step(init[d], opt[d], bt, cfg)
            step_loss[d] = float(m["loss"])
        steps_rel.append(abs(step_loss["cuda"] - step_loss["cpu"]) / abs(step_loss["cpu"]))
    rel["losses_10_steps"] = max(steps_rel)
    with torch.inference_mode():
        after = {d: lenet.apply(init[d], h_imgs).cpu() for d in init}
    rel["holdout_logits_after_10"] = _rel(after["cuda"], after["cpu"])
    argmax_agree = float((after["cuda"].argmax(-1) == after["cpu"].argmax(-1)).float().mean())
    params_rel = {f"{k}/{n}": _rel(init["cuda"][k][n], init["cpu"][k][n].cuda())
                  for k in sorted(init["cpu"]) for n in sorted(init["cpu"][k])}
    over = {k: rel[k] for k, lim in MNIST_LIMITS.items() if rel[k] > lim}
    if over:
        raise AssertionError(f"{label}: card vs CPU rel {over} over {MNIST_LIMITS}")
    print(f"{label}, card vs the port's CPU path (fp32, TF32 off): rel logits {rel['logits']:.3g} "
          f"(limit {MNIST_LIMITS['logits']}), first-step gradients {rel['grads']:.3g} (limit "
          f"{MNIST_LIMITS['grads']}), losses of 10 steps "
          f"{[float(f'{r:.3g}') for r in steps_rel]} (limit {MNIST_LIMITS['losses_10_steps']}); "
          f"after them, reported: holdout logits {rel['holdout_logits_after_10']:.3g} (argmax "
          f"agrees on {argmax_agree:.4f}), parameters per leaf "
          + ", ".join(f"{k} {v:.3g}" for k, v in params_rel.items()) + f"  [{card}]")
    rel.update(steps=steps_rel, argmax_agree_after_10=argmax_agree, params_after_10=params_rel)

    # checkpoint round trip on the card
    store = ArtifactStore(str(ROOT / "experiments" / "chip_smoke_mnist"))
    store.save_tree("lenet", params)
    restored = store.load_tree("lenet", adamw.tree_map(torch.zeros_like, params))
    with np.load(ROOT / "experiments" / "chip_smoke_mnist" / "lenet.npz") as z:
        dtypes = {z[k].dtype for k in z.files}
    with torch.inference_mode():
        same = torch.equal(lenet.apply(restored, h_imgs), lenet.apply(params, h_imgs))
    if not same or tree_hash(restored) != tree_hash(params) or dtypes != {np.dtype(np.float32)} \
            or any(t.device.type != "cuda" for t in adamw.tree_leaves(restored)):
        raise AssertionError(f"{label}: checkpoint round trip: logits equal {same}, stored "
                             f"dtypes {dtypes}")

    # the paper's Table 3 on its own model
    lp = lenet_predictor(params, h_imgs[:1], "cuda", warm=(1, 8, 16, MNIST_TABLE3_BATCH))
    res = {strat: InferenceService(lp, get_profile(prof), strat, max_batch=MNIST_TABLE3_BATCH,
                                   max_replicas=4).stress_test(MNIST_TABLE3_REQUESTS)
           for strat, prof in (("baremetal", "baremetal"), ("k8s", "k8s"), ("kserve", "gcp"))}
    svc = {b: lp.service_time(b) for b in (1, MNIST_TABLE3_BATCH)}
    for strat, r in res.items():
        if len(r.latencies_s) != MNIST_TABLE3_REQUESTS:
            raise AssertionError(f"{label} {strat}: {len(r.latencies_s)} of "
                                 f"{MNIST_TABLE3_REQUESTS} requests served")
        prof = get_profile("gcp" if strat == "kserve" else strat)
        _latency_floor(f"{label} {strat}", r, prof, min(svc.values()))
    if sum(res["kserve"].per_version.values()) != MNIST_TABLE3_REQUESTS:
        raise AssertionError(f"{label} kserve: per-version counts {res['kserve'].per_version}")
    totals = {strat: r.total_time_s for strat, r in res.items()}
    if not totals["baremetal"] > totals["k8s"] > totals["kserve"]:
        raise AssertionError(f"{label}: total times {totals}, not baremetal > k8s > kserve")
    ks = res["kserve"].summary()
    print(f"{label} Table 3, {MNIST_TABLE3_REQUESTS} requests in a burst: total baremetal "
          f"{totals['baremetal']:.4f} s, k8s {totals['k8s']:.4f} s, kserve "
          f"{totals['kserve']:.4f} s (k8s / kserve {totals['k8s'] / totals['kserve']:.2f}); "
          f"kserve p50 {ks['p50_s']} s, p99 {ks['p99_s']} s, replicas_max {ks['replicas_max']}; "
          f"service_time(1) {svc[1] * 1e3:.4f} ms, service_time({MNIST_TABLE3_BATCH}) "
          f"{svc[MNIST_TABLE3_BATCH] * 1e3:.4f} ms  [{card}]")

    # one training step and one predict, traced
    batch = {"image": torch.as_tensor(imgs[:MNIST_BATCH], device="cuda"),
             "label": torch.as_tensor(labels[:MNIST_BATCH], device="cuda")}
    opt = adamw.init_opt_state(params)

    def one_step():
        train_step(params, opt, batch, cfg)

    x32 = h_imgs[:MNIST_TABLE3_BATCH]
    for _ in range(2):
        one_step()
        lp.predict(x32)
    traced = {"train_step": trace(one_step, ROOT / "chiprun_out" / "profile", "mnist_train_step"),
              "predict_32": trace(lambda: lp.predict(x32), ROOT / "chiprun_out" / "profile",
                                  "mnist_predict_32")}
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    _expect(label, launches, ())
    for k, t in traced.items():
        print(f"{label} trace, {k}: host {t['wall_ms']:.3f} ms, device busy "
              f"{t['device_busy_ms']:.4f} ms in a span of {t['device_span_ms']:.4f} ms (idle "
              f"{t['idle_share_of_span']:.3f}), {t['kernels']} kernels; by group "
              + ", ".join(f"{g} {v['ms']:.4f} ms x{v['n']}" for g, v in t["by_group_ms"].items())
              + f"  [{card}]")
    total_s = time.perf_counter() - t0
    print(f"{label}: the whole leg {total_s:.2f} s; launches {launches}  [{card}]")
    return {"leg_s": leg_s, "total_s": total_s, "train": {"lr": trained["lr"], "steps": MNIST_STEPS,
                                      "wall_s": wall, "steps_per_s": MNIST_STEPS / wall,
                                      "images_per_s": MNIST_STEPS * MNIST_BATCH / wall,
                                      "reported_losses": losses, "holdout_accuracy": holdout},
            "orchestrated": orchestrated, "card_vs_cpu_rel": rel,
            "table3": {"totals_s": totals, "service_time_s": svc,
                       "summaries": {s: r.summary() for s, r in res.items()}},
            "trace": traced, "launches": launches}


def _lm_train_leg(card: str) -> dict:
    """granite-3-8b at full width, TRAIN_LAYERS layers, trained through the
    port's entry point with every kernel on the path running both ways:

    - ``LMTrainJob.run`` (fp32 masters, bf16 compute, ``use_kernels=True``,
      TRAIN_BATCH x TRAIN_SEQ tokens a step from ``lm_batches``,
      TRAIN_STEPS steps, warmup-cosine) with a checkpoint, then a job
      resumed from it for 2 steps; launch counts zeroed before and read
      after: RMSNorm and flash attention forward and backward, no other;
      finite losses that fall (``examples/train_llm.py``'s ``check``); the
      resumed run's first loss below the fresh job's first;
    - every kernel call of one recorded ``steps.train_step``, forward and
      backward, held against its twin on the recorded inputs;
    - one step on fresh masters and one batch, kernel path against plain
      path: loss and global gradient norm in bf16 (per-leaf rel reported),
      every gradient leaf in fp32 at 2 layers, at TRAIN_LIMITS;
    - steps/s, tokens/s, peak memory, and a trace of one training step."""
    import shutil

    import torch
    from repro_torch.checkpoint.store import ArtifactStore
    from repro_torch.configs import registry
    from repro_torch.core.trainjob import LMTrainJob
    from repro_torch.data.tokens import lm_batches
    from repro_torch.examples.train_llm import check
    from repro_torch.kernels import native
    from repro_torch.launch.profile import trace
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    from repro_torch.telemetry.events import EventLog

    label = TRAIN_PATH
    full = registry.get_config("granite_3_8b")
    cfg = full.replace(n_layers=TRAIN_LAYERS, use_kernels=True)
    print(f"{label}: granite-3-8b at full width (d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), depth cut from "
          f"{full.n_layers} to {cfg.n_layers} layers (16 bytes a parameter in fp32 plus a bf16 "
          f"copy); batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps, bf16 compute on fp32 "
          f"masters, use_kernels=True  [{card}]")
    root = ROOT / "experiments" / "chip_smoke_lm"
    shutil.rmtree(root, ignore_errors=True)
    store = ArtifactStore(str(root))
    job_kw = dict(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, store=store, device="cuda")
    t_leg = time.perf_counter()

    # -- the job, a checkpoint, a resume --------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    log = EventLog()
    try:        # the checkpoint is 24 GB: it leaves the checkout whatever happens
        res = LMTrainJob(cfg, n_steps=TRAIN_STEPS, log=log, **job_kw).run(
            checkpoint_name="granite")
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(t.numel() for t in _leaves(res["params"]))
        del res["params"]
        stages = log.totals()
        history = res["history"]
        if not all(math.isfinite(v) for v in history):
            raise AssertionError(f"{label}: losses not finite: {history}")
        check(history, TRAIN_STEPS)
        train_s = stages["tfjob:train"]
        resumed = LMTrainJob(cfg, n_steps=2, **job_kw).run(resume_from="granite")
        del resumed["params"]
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(native.LAUNCHES)
    _expect(label, launches, TRAIN_KERNELS)
    if not resumed["history"][0] < history[0]:
        raise AssertionError(f"{label}: resumed first loss {resumed['history'][0]} not below "
                             f"the fresh job's {history[0]}")
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    print(f"{label}: {TRAIN_STEPS} steps in {train_s:.3f} s ({TRAIN_STEPS / train_s:.3f} steps/s, "
          f"{tokens / train_s:.0f} tokens/s), {n_params / 1e9:.3f} B parameters, peak "
          f"{peak_gib:.2f} GiB; losses {[round(v, 4) for v in history]}; checkpoint "
          f"{stages.get('tfjob:checkpoint', 0.0):.2f} s; resumed for 2 steps: "
          f"{[round(v, 4) for v in resumed['history']]} (first below the fresh job's "
          f"{history[0]:.4f}); launches {launches}  [{card}]")
    gc.collect()
    torch.cuda.empty_cache()

    # -- one recorded step: every kernel call against its twin ----------------
    batch = next(lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=3))
    batch = {k: torch.as_tensor(batch[k], device="cuda") for k in ("tokens", "labels")}
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    opt = adamw.init_opt_state(params)
    with _recording(TRAIN_KERNELS) as calls:
        steps.train_step(params, opt, batch, cfg=cfg)
    recorded = _hold_recorded(label, cfg, calls)
    del calls, opt
    gc.collect()
    torch.cuda.empty_cache()

    # -- one step, kernel path against plain path -----------------------------
    def grads(p, c):
        leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = steps.loss_fn(leaves, c, batch)
        return loss.detach(), torch.autograd.grad(loss, adamw.tree_leaves(leaves))

    names = [k for k, _ in _named(params)]
    loss_k, g_k = grads(params, cfg)
    norm_k = adamw.global_norm(dict(zip(names, g_k)))
    loss_p, g_p = grads(params, cfg.replace(use_kernels=False))
    norm_p = adamw.global_norm(dict(zip(names, g_p)))
    bf16 = {"loss": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
            "grad_norm": abs(float(norm_k) - float(norm_p)) / float(norm_p),
            "leaves": {n: _rel(a, b) for n, a, b in zip(names, g_k, g_p)}}
    del g_k, g_p, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(n_layers=2, dtype="float32")
    params32 = lm.init_params(cfg32, seed=0, device="cuda", dtype=torch.float32)
    _, g_k = grads(params32, cfg32)
    _, g_p = grads(params32, cfg32.replace(use_kernels=False))
    fp32 = {n: _rel(a, b) for n, a, b in zip([k for k, _ in _named(params32)], g_k, g_p)}
    del g_k, g_p, params32
    gc.collect()
    torch.cuda.empty_cache()
    over = [f"bf16 {k} {bf16[k]} (limit {TRAIN_LIMITS['bf16_' + k]})" for k in ("loss", "grad_norm")
            if bf16[k] > TRAIN_LIMITS["bf16_" + k]]
    over += [f"fp32 {n} {r} (limit {TRAIN_LIMITS['fp32_grad_leaf']})" for n, r in fp32.items()
             if r > TRAIN_LIMITS["fp32_grad_leaf"]]
    worst_bf16 = max(bf16["leaves"], key=bf16["leaves"].get)
    worst_fp32 = max(fp32, key=fp32.get)
    print(f"{label}, one step, kernel path vs plain path: bf16 loss rel {bf16['loss']:.4g} (limit "
          f"{TRAIN_LIMITS['bf16_loss']}), global gradient norm rel {bf16['grad_norm']:.4g} (limit "
          f"{TRAIN_LIMITS['bf16_grad_norm']}), per-leaf gradient rel up to "
          f"{bf16['leaves'][worst_bf16]:.4g} ({worst_bf16}, reported); fp32 at 2 layers: per-leaf "
          f"gradient rel up to {fp32[worst_fp32]:.4g} ({worst_fp32}; limit "
          f"{TRAIN_LIMITS['fp32_grad_leaf']})  [{card}]")
    if over:
        raise AssertionError(f"{label}: kernel vs plain over the limits: " + "; ".join(over))

    # -- one training step traced ----------------------------------------------
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    opt = adamw.init_opt_state(params)

    def one_step():
        steps.train_step(params, opt, batch, cfg=cfg)

    one_step()
    traced = trace(one_step, ROOT / "chiprun_out" / "profile", "granite_train_step")
    torch.cuda.synchronize()
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label} trace, one step: host {traced['wall_ms']:.3f} ms, device busy "
          f"{traced['device_busy_ms']:.3f} ms in a span of {traced['device_span_ms']:.3f} ms (idle "
          f"{traced['idle_share_of_span']:.3f}), {traced['kernels']} kernels; by group "
          + ", ".join(f"{g} {v['ms']:.3f} ms x{v['n']}" for g, v in traced["by_group_ms"].items())
          + f"  [{card}]")
    total_s = time.perf_counter() - t_leg
    print(f"{label}: the whole leg {total_s:.2f} s  [{card}]")
    return {"layers": cfg.n_layers, "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "train_s": train_s, "steps_per_s": TRAIN_STEPS / train_s,
            "tokens_per_s": tokens / train_s, "peak_gib": peak_gib, "stages_s": stages,
            "history": history, "resumed": resumed["history"], "recorded": recorded,
            "bf16_kernel_vs_plain": bf16, "fp32_kernel_vs_plain": fp32, "trace": traced,
            "leg_s": total_s, "launches": launches}


def _named(tree: dict, prefix: str = ""):
    """(path, leaf) in ``adamw.tree_leaves``'s order (sorted keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _cast(tree: dict, dtype) -> dict:
    return {k: (_cast(v, dtype) if isinstance(v, dict) else v.to(dtype)) for k, v in tree.items()}


def _rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / (w.abs().max() + 1e-9))


if __name__ == "__main__":
    sys.exit(main())
