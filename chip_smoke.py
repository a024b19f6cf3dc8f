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
3. drives twelve paths at full width, with random bf16 weights from a
   seeded generator and ``use_kernels=True``, each through the entry points
   a user calls, freeing each path's weights before the next:
   granite-3-8b serving (40 layers), h2o-danube-3-4b serving (24 sliding-
   window layers, head dim 120), minitron-4b serving (32 layers, squared-
   ReLU MLP), gemma3-4b serving (34 layers, 5:1 local:global with window
   1024, head dim 320, tied and scaled embeddings), zamba2-1.2b serving
   (38 Mamba2 layers and the shared attention block), xlstm-1.3b serving,
   granite-moe-3b-a800m serving (32 layers, 40 experts top 8, attention at
   a GQA group of 3) and deepseek-v2-lite-16b serving (27 layers, MLA with
   its prefill through flash attention at head dim 192, v zero-padded, and
   an absorbed decode that runs no kernel; 64 experts top 6 and 2 shared,
   a dense layer 0), whisper-base serving (6 + 6 layers: the encoder's
   non-causal flash attention over 1500 frames, the decoder's cross-
   attention, non-causal flash over those rows in prefill and decode
   attention over all 1500 in each step, which must leave the cached rows
   bit for bit as prefill wrote them) and qwen2-vl-7b serving (28 layers,
   M-RoPE, a GQA group of 7 in both attention kernels, a prompt of
   VLM_PROMPT so that tokens follow the 256 vision rows), each through
   ``make_lm_predictor`` and the k8s strategy of ``InferenceService`` (the
   predictor builds the reference's stub inputs: zero frames, zero vision
   rows, equal M-RoPE streams); the logit gates of those two run the
   frames, or the vision rows and a 16 x 16 M-RoPE image grid, drawn from a
   seeded generator; gemma3 also serves a long leg on the same weights
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
   (granite, h2o, minitron, gemma3, granite-moe, deepseek: <= 2e-2); with
   the same weights cast to fp32 (in place, leaf by leaf, so deepseek's
   fp32 tree fits beside no bf16 copy), the kernel path against the plain
   path (granite, h2o, minitron, gemma3, granite-moe, deepseek <= 1e-4,
   zamba2 <= 1e-3); and the bf16 kernel path's drift from the fp32 plain
   path, at most 1.5 times the bf16 plain path's (every path).  On the MoE
   paths each plain run routes every token to the experts its kernel run
   chose (a near-tied top-k choice that bf16 rounding flips would move a
   token by a whole gate's share, which no kernel fault does), and the
   (token, layer) decisions it would have made otherwise are counted and
   printed.
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
   shape, at h2o's D 120 under a window that binds, in fp32, and without a
   causal mask at whisper's two training calls; RMSNorm at 4096 x 4096)
   against autograd of their twins, beside autograd through SDPA and
   ``F.rms_norm``.  Steps/s, tokens/s, peak memory and a
   trace of one step are reported;
5b. trains the archs whose attention is wider than 128 columns through the
   same kernels (``_wide_train_leg``, WIDE_ARCHS): gemma3-4b (8/4 heads of
   320) at 6 layers, one whole 5:1 pattern, batch 2 x 2048 so the 1024-key
   window binds, and deepseek-v2-lite-16b (MLA: qk 192, v zero-padded from
   128, scale 192^-0.5) at 2 layers, batch 4 x 1024.  Gated for each:
   WIDE_STEPS bf16 steps of ``LMTrainJob.run`` with the launch set exactly
   TRAIN_KERNELS, finite losses and the first batch's loss again below its
   loss at the init; every kernel call of one recorded step against its
   twin; one step, kernel path against plain path, at TRAIN_LIMITS (every
   fp32 leaf at the same depth; deepseek's plain runs replaying the kernel
   run's expert ids).  Phase 2 holds and times the training forward and
   the backward at gemma3's shapes (windowed and global), deepseek's and a
   tensor-parallel rank's (8 of its 16 heads), and the fp32 backward at D
   320.  Steps/s, tokens/s and peak memory are reported, and the leg's and
   the whole run's seconds;
5c. trains zamba2-1.2b through the SSD scan's forward and backward kernels
   (``_ssm_train_leg``, SSM_TRAIN): full width, 7 layers (a group of six
   Mamba2 layers with the shared attention block, and one more), batch 4 x
   1024, gated as 5b with the launch set RMSNorm, flash attention and
   ``ssm_scan``, each both ways, at TRAIN_LIMITS.  Phase 2
   holds and times the backward at zamba2's training shape, a tensor-
   parallel rank's (16 of its 32 heads) and a ragged S;
5d. trains xlstm-1.3b through the mLSTM scan's forward and backward kernels
   (``_xlstm_train_leg``, XLSTM_TRAIN): full width, 8 layers (7 mLSTM and
   the sLSTM layer), batch 4 x 512, gated as 5b with the launch set RMSNorm
   and ``mlstm_scan``, each both ways; the bf16 gradient norm and every fp32
   leaf at the larger of TRAIN_LIMITS' and SENS_RATIO times their one-ulp
   sensitivity; XLSTM_TIMED steps timed on each path.  Phase 2 holds and
   times the backward at xlstm's training shape, a tensor-parallel rank's
   (2 of its 4 heads at 4 x TP_SSM_SEQ) and over one row of 4096;
6. trains granite-3-8b data-parallel (``_dp_train_leg``): DP_RANKS ranks
   share the card through a gloo group (``torch.multiprocessing``, a file
   store), full width cut to DP_LAYERS layers, each on its rows of the
   training leg's global batch.  Gated: one fp32 step on the kernel path
   against the one-process step on the same masters and batch (the loss
   and every all-reduced gradient leaf, DP_LIMITS); ZeRO-1's update bit
   for bit plain DP's; DP_STEPS bf16 steps of ``LMTrainJob(mesh=...)``
   with ZeRO-1 (finite falling losses, the first batch's loss taken again
   below its loss at the init, the training leg's launch set, every
   replica bit for bit rank 0's, each rank's moments half the whole).
   Each rank's peak memory, steps/s, tokens/s and one gradient
   all-reduce's time are reported: host-staged gloo on one card measures
   correctness, not scaling;
6b. trains granite-3-8b tensor-parallel (``_tp_train_leg``): TP_RANKS
   ranks share the card through a gloo group on a (1, TP_RANKS) mesh over
   ("data", "model"), full width cut to TP_LAYERS layers, each rank on the
   whole global batch and its shard of every parameter under the ``tp``
   rules (heads, d_ff over the model axis; granite's odd vocabulary puts
   the embedding and the head on D).  Gated: (a) one fp32 step on the
   kernel path, the gradients gathered whole, against one process on rank
   0 (the loss and every leaf at DP_LIMITS); (b) TP_STEPS bf16 steps of
   ``LMTrainJob(mesh=...)``: the training leg's launch set, every flash
   call at the local heads (16 query over 4 kv heads), every whole leaf
   bit for bit on both ranks, finite losses, and the first batch's loss
   taken again with the trained parameters below its loss at the init.
   The fitted specs of ``embed`` and ``lm_head``, each rank's parameter
   and moment bytes against the whole, its peak memory and one activation
   all-reduce's time are reported; phase 2 holds the flash kernel forward
   and backward at the local shape;
6c. trains the MoE archs tensor-parallel (``_tp_moe_leg``) on the same
   ranks, mesh, depth and batch, full width: granite-moe-3b-a800m on the
   kernel path (20 of its 40 experts a rank, 12/4 heads a rank: a local
   GQA group of 3), gated as 6b ((a) against one process, the plain run
   replaying the split run's expert ids; (b) TP_STEPS bf16 steps, the
   training launch set, every flash call at 12/4 heads, every MoE
   routing's expert ids equal on both ranks, whole leaves bit for bit, the
   first batch again below its init loss), every kernel call of one
   recorded step held to its twin; and deepseek-v2-lite-16b (a dense MLA
   layer and an MoE layer of 64 experts, 2 shared) on the kernel path,
   gate (a) only, its MLA flash calls at D 192 forward and backward, every
   one of the split run at a rank's 8/8 heads.  The
   expert leaves' fitted specs, the bytes and time of one MoE layer's
   collectives, a rank's parameter and moment bytes, peak memory and
   steps/s are reported; phase 2 holds flash forward and backward at
   (4, 1024, 12, 64) over 4 kv heads;
6d. serves tensor-parallel (``_tp_serve_leg``) on the same ranks and mesh:
   granite-3-8b and granite-moe-3b-a800m at full width through
   ``steps.prefill``, ``steps.serve_step`` and ``greedy_decode_loop``,
   batch 4 x PROMPT, GEN new tokens, each rank on its shards and its block
   of the cache (the kv heads split on 2).  Gated: (a) fp32 at
   TP_SERVE_LAYERS layers on the kernel path, every rank's prefill logits
   and all GEN decode steps' logits against one process within
   TP_SERVE_REL, the tokens equal; (b) bf16 at full depth (40 and 32
   layers): the launch set exactly flash attention, decode attention and
   RMSNorm on each rank, every decode-attention call at the local heads
   (16/4, 12/4), every recorded kernel call of one prefill and one decode
   step under the phase-2 rule, a rank's cache half of the one process's;
   (c) the collective bytes of one bf16 decode step, counted on the card
   by wrapping ``torch.distributed``, equal by kind to what
   ``launch/dryrun.py``'s counting mesh (a fake group in this process)
   counts for the same step.  Token agreement with one process in bf16,
   each rank's prefill and decode times, peak memory and cache bytes are
   reported; phase 2 holds decode attention at a rank's shape, q
   (4, 16, 128) over 4 kv heads of a 145-row cache, and at a pod rank's,
   q (4, 2, 128) over a one-head view of an 8-head cache read in place;
6e. runs the recurrent mixers tensor-parallel (``_tp_ssm_leg``) on the same
   ranks and mesh: zamba2-1.2b (Mamba2 and its shared attention block) and
   xlstm-1.3b (mLSTM and sLSTM) at full width, each rank on its heads (16
   of 32, 2 of 4), its conv channel block and its block of every state.
   Gated: (a) fp32 on the kernel path, zamba2 at 7 layers (a group of 6
   with the shared block, and the remainder phase) and xlstm at 8 (one
   sLSTM): every rank's prefill and GEN decode steps' logits against one
   process within TP_SERVE_REL, the tokens equal, and xlstm's scoring loss;
   one fp32 training step of each on the kernel path (each scan's kernels
   both ways on every rank), the loss and every gathered gradient leaf at
   TP_SSM_LIMITS (or SENS_RATIO times its one-ulp sensitivity); (b) bf16
   at full depth (38 and 48 layers): zamba2's serving launch set exactly
   RMSNorm, flash attention, decode attention and ``ssm_scan``, every scan
   at 16 heads, a rank's cache half the one process's; xlstm's scoring launch set exactly RMSNorm
   and ``mlstm_scan``, every scan at 2 heads; every recorded kernel call of
   one prefill, one decode step and one scoring forward under the phase-2
   rule; (c) one zamba2 bf16 decode step's collectives equal by kind to the
   counting mesh's.  Token agreement, times and peak memory are reported;
   phase 2 holds ``ssm_scan`` at x (4, 128, 16, 128) and ``mlstm_scan`` at
   q (4, 128, 2, 512), a rank's shapes;
6f. runs whisper tensor-parallel (``_tp_encdec_leg``) on the same ranks and
   mesh: whisper-base at full width and depth (6 + 6 layers), each rank on
   its 4 of the 8 heads in the encoder, the decoder's self-attention and
   its cross-attention, its block of the cross rows (``cross_k``/
   ``cross_v``) and the embedding and head on D (51865 ids divide no
   axis), batch 4 x PROMPT over 1500 seeded frame rows, GEN new tokens.
   Gated: (a) fp32 on the kernel path, every rank's prefill and GEN decode
   steps' logits against one process within TP_SERVE_REL, the tokens
   equal, and one training step at TRAIN_BATCH x PROMPT through the
   forward and backward kernels, the loss at TP_ENCDEC_LIMITS and every
   gathered gradient leaf at the larger of TP_ENCDEC_LIMITS and SENS_RATIO
   times its one-ulp sensitivity; (b) bf16: serving launches exactly
   RMSNorm, flash attention and decode attention, one training step those
   of TRAIN_KERNELS, every flash and decode-attention call at 4 heads, a
   rank's cache half of one process's (``enc_len`` whole on both), every
   recorded kernel call of one prefill, one decode step and one training
   step under the phase-2 rule; (c) one bf16 decode step's collectives
   equal by kind to the counting mesh's.  Token agreement, times and peak
   memory are reported; phase 2 holds flash forward and backward at the
   encoder's rank shape, q (4, 1500, 4, 64), and the cross-attention's,
   q (4, 128, 4, 64) over 1500 rows, and decode attention at q (4, 4, 64)
   over 1500 rows;
7. holds every phase it timed against the card's roofline
   (``_roofline_phase``): each arch's prefill and decode step at batch 4
   (qwen2-vl prompt 384), gemma3's 1 x 2048 long leg, xlstm's scoring
   forward and the granite training step, each at or above max(model FLOPs
   / bf16 peak, least bytes / HBM bandwidth) over the card's
   ``HardwareSpec`` (chosen by the card's name in phase 1, where its
   memory is held within 8 % of the card's; phase 2's bounds read the same
   spec), printing ``mfu``, the HBM share and the FLOPs ``launch/count.py``
   counts for the same step on ``meta``;
8. prints the kernels' JSON line and, last, the device line.

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

TOL = 2e-2                  # reference bf16 tolerance, tests/test_kernels.py:17-19
# the card's HardwareSpec must state its memory within this share of what
# the card reports (the spec's 80 GiB against the part's usable memory)
HBM_SPEC_SHARE = 0.08
BWD_FLOOR = 1e-6            # the backward kernels' absolute floor, of the twin's largest
# the bf16 kernel path may drift from the fp32 plain run at most this many
# times as far as the bf16 plain path does on the same weights and tokens
DRIFT_RATIO = 1.5

BATCH, PROMPT, GEN = 4, 128, 16
# qwen2-vl's prompt: its predictor overwrites the first min(256, S) rows
# with vision rows, so at PROMPT every prompt would be the same zeros; its
# logit gate lays those rows out as a VLM_GRID x VLM_GRID image grid
VLM_PATH, VLM_PROMPT, VLM_GRID = "qwen2-vl-7b serving", 384, 16
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
# gemma3 and deepseek trained through the flash kernels past head dim 128
# (``_wide_train_leg``; gemma3 320, deepseek's MLA 192 with v zero-padded
# from 128): arch -> (layers, batch, sequence), full width.  gemma3's six
# layers are one whole 5:1 pattern (five layers under the 1024-key window,
# one global), and its 2048 tokens make the window bind; deepseek's two are
# its dense MLA layer and one MoE layer (the tensor-parallel leg's depth).
# WIDE_STEPS bf16 steps of ``LMTrainJob``: over so few steps a fresh
# batch's loss stays within batch noise, so the first batch's loss is taken
# again with the trained parameters and must fall below its loss at the
# init.  One step, kernel path against plain path, at TRAIN_LIMITS, the
# fp32 leaves at the same depth (gemma3's windowed and global layers both)
WIDE_PATH = "wide-head training"
WIDE_ARCHS = {"gemma3_4b": (6, 2, 2048), "deepseek_v2_lite_16b": (2, 4, 1024)}
WIDE_STEPS = 5
# zamba2 trained through the SSD scan's forward and backward kernels
# (``_ssm_train_leg``): full width, 7 layers (a group of 6 Mamba2 layers with
# the shared attention block, and one more), batch 4 x 1024, WIDE_STEPS bf16
# steps, gated as the wide-head leg, its launch set SSM_TRAIN_KERNELS
SSM_TRAIN_PATH = "zamba2-1.2b training"
SSM_TRAIN = ("zamba2_1_2b", 7, 4, 1024)
SSM_TRAIN_KERNELS = TRAIN_KERNELS + ("ssm_scan", "ssm_scan_bwd")
# xlstm trained through the mLSTM scan's forward and backward kernels
# (``_xlstm_train_leg``): full width (4 heads of 512), 8 layers (one period:
# 7 mLSTM layers and the sLSTM layer, as TP_SSM_LAYERS cuts it), batch 4 x
# 512 (the sLSTM layer steps one token at a time both ways; 512 tokens give
# the scan 8 chunks of 64), WIDE_STEPS bf16 steps, gated as the wide-head
# leg, its launch set XLSTM_TRAIN_KERNELS; every fp32 leaf of the kernel vs
# plain step at the larger of TRAIN_LIMITS' and SENS_RATIO times its one-ulp
# sensitivity, as the recurrent-mixer leg holds xlstm's leaves, and the bf16
# gradient norm likewise (an H100 read the two paths' bf16 norms 5.1 %
# apart, and moving every master by one ulp moved a path's own norm by up to
# 4.6 %: bf16 rounding, amplified through the eight layers)
XLSTM_TRAIN_PATH = "xlstm-1.3b training"
XLSTM_TRAIN = ("xlstm_1_3b", 8, 4, 512)
XLSTM_TRAIN_KERNELS = ("rmsnorm", "rmsnorm_bwd", "mlstm_scan", "mlstm_scan_bwd")
XLSTM_TIMED = 2             # steps timed on each path, kernel and plain
# granite-3-8b data-parallel training (``_dp_train_leg``): DP_RANKS gloo
# ranks sharing the one card, full width, DP_LAYERS layers, the training
# leg's global batch (TRAIN_BATCH / DP_RANKS rows a rank).  Gate (a), one
# fp32 step on the kernel path against one process on the same masters and
# global batch: the loss and every all-reduced gradient leaf at DP_LIMITS;
# gate (b), ZeRO-1's update bit for bit plain DP's; gate (c), DP_STEPS bf16
# steps of ``LMTrainJob(mesh=...)`` with ZeRO-1.  Over so few steps at full
# width the loss on each fresh batch stays within batch noise (an H100 read
# 11.1894 to 11.2123 over five), so (c) also takes the first batch's loss
# again with the trained parameters: it must fall below its loss at the
# init.  An H100 read 0 and 6.4e-6 in gate (a)
DP_PATH, DP_RANKS, DP_LAYERS, DP_STEPS = "granite-3-8b data-parallel training", 2, 2, 5
DP_LIMITS = {"fp32_loss": 1e-5, "fp32_grad_leaf": 1e-4}
# granite-3-8b tensor-parallel training (``_tp_train_leg``): TP_RANKS gloo
# ranks sharing the one card on a (1, TP_RANKS) mesh, full width, TP_LAYERS
# layers, the training leg's global batch on every rank.  Gate (a) holds one
# fp32 step at DP_LIMITS; gate (b) runs TP_STEPS bf16 steps of
# ``LMTrainJob(mesh=...)``
TP_PATH, TP_RANKS, TP_LAYERS, TP_STEPS = "granite-3-8b tensor-parallel training", 2, 2, 5
# the MoE archs trained tensor-parallel (``_tp_moe_leg``) on the same ranks,
# mesh, depth, batch and steps: granite-moe (gates (a) and (b)) and deepseek
# (gate (a), its MLA flash calls at D 192 and a rank's 8/8 heads), both on
# the kernel path
TP_MOE_PATH = "granite-moe-3b-a800m tensor-parallel training"
TP_MLA_PATH = "deepseek-v2-lite-16b tensor-parallel training"
# tensor-parallel serving (``_tp_serve_leg``): TP_RANKS gloo ranks on the
# same (1, TP_RANKS) mesh serve batch BATCH x PROMPT and GEN new tokens for
# each arch of TP_SERVE_ARCHS.  Gate (a): fp32 at TP_SERVE_LAYERS layers,
# every rank's prefill and decode logits against one process within
# TP_SERVE_REL (the card bound of the tensor-parallel leaves), the tokens
# equal; gate (b): bf16 at full depth, the launch set TP_SERVE_KERNELS,
# decode attention at the local heads, every recorded call under the
# phase-2 rule, a rank's cache 1 / TP_RANKS of the whole; gate (c): the
# collective bytes of one bf16 decode step equal to what
# ``launch/dryrun.py``'s counting mesh counts for it
TP_SERVE_PATH = "tensor-parallel serving"
TP_SERVE_ARCHS = ("granite_3_8b", "granite_moe_3b_a800m")
TP_SERVE_LAYERS, TP_SERVE_REL = 4, 1e-4
TP_SERVE_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
# tensor parallelism of the recurrent mixers (``_tp_ssm_leg``): the same
# ranks and mesh, zamba2 and xlstm at full width.  Gate (a): fp32 on the
# kernel path at TP_SSM_LAYERS layers (zamba2: a group of 6 with its shared
# block, and the one-layer remainder phase; xlstm: 7 mLSTM and its sLSTM),
# serving held as TP_SERVE_ARCHS' is, plus xlstm's scoring loss; one fp32
# training step of each at TRAIN_BATCH x TP_SSM_SEQ on the kernel path (the
# scans' backward kernels on every rank), the loss at TP_SSM_LIMITS and every
# gathered gradient
# leaf at the larger of TP_SSM_LIMITS and SENS_RATIO times the leaf's own
# sensitivity: how far one process's gradient moves when every weight moves
# by one ulp (the larger of two random nudges, ``_nudged``), measured in the
# same run.  An H100 read zamba2's leaves within 8.5e-5 (its sensitivity up
# to 8.8e-5) and xlstm's within 6.3e-3 (its sensitivity up to 0.11: one-ulp
# weight changes move xlstm's fp32 gradient by 1e-3 through eight layers);
# a leaf whose whole gradient is below ZERO_LEAF of the tree's largest is
# held below that floor.  Gate (b): bf16 at full depth,
# zamba2 serving with the launch set TP_SSM_SERVE_KERNELS, xlstm scoring
# with TP_SSM_SCORE_KERNELS, every scan at the rank's heads.  Gate (c):
# one zamba2 bf16 decode step's collectives against the counting mesh
TP_SSM_PATH = "recurrent-mixer tensor parallelism"
TP_SSM_LAYERS = {"zamba2_1_2b": 7, "xlstm_1_3b": 8}
TP_SSM_SEQ, ZERO_LEAF, SENS_RATIO = 256, 1e-6, 4.0
TP_SSM_LIMITS = {"fp32_loss": 1e-4, "fp32_grad_leaf": 1e-4}
TP_SSM_SERVE_KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "ssm_scan")
TP_SSM_SCORE_KERNELS = ("rmsnorm", "mlstm_scan")
# whisper's encoder and cross-attention tensor-parallel (``_tp_encdec_leg``):
# the same ranks and mesh, whisper-base at full width and depth, batch BATCH x
# PROMPT over its 1500 seeded frame rows, GEN new tokens.  Gate (a): fp32 on
# the kernel path, serving held as TP_SERVE_ARCHS' is, and one training step
# at TRAIN_BATCH x PROMPT: the loss at TP_ENCDEC_LIMITS and every gathered
# gradient leaf at the larger of TP_ENCDEC_LIMITS and SENS_RATIO times its
# one-ulp sensitivity (``_tp_sens_parity``); gate (b): bf16, serving's launch
# set TP_SERVE_KERNELS and a training step's TRAIN_KERNELS, every flash and
# decode-attention call at the rank's heads, a rank's cache half of one
# process's but ``enc_len``; gate (c): one bf16 decode step's collectives
# against the counting mesh
TP_ENCDEC_PATH = "whisper-base tensor parallelism"
TP_ENCDEC_LIMITS = {"fp32_loss": 1e-5, "fp32_grad_leaf": 1e-4}
# the 16 x 16 pod's model axis (``launch/dryrun.py``'s "pod"): phase 2's
# decode case at a pod rank's heads
POD_MODEL = 16
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
    ("granite-moe-3b-a800m serving", "granite_moe_3b_a800m", "serve",
     ("rmsnorm", "flash_attention", "decode_attention"), TOL, 1e-4),
    ("deepseek-v2-lite-16b serving", "deepseek_v2_lite_16b", "serve",
     ("rmsnorm", "flash_attention"), TOL, 1e-4),
    ("whisper-base serving", "whisper_base", "serve",
     ("rmsnorm", "flash_attention", "decode_attention"), TOL, 1e-4),
    (VLM_PATH, "qwen2_vl_7b", "serve",
     ("rmsnorm", "flash_attention", "decode_attention"), TOL, 1e-4),
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
    "ssm_scan_bwd": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
                     "src/repro/models/steps.py:44", SSM_TRAIN_PATH, "ssm_scan.ssm_scan_bwd"),
    "mlstm_scan_bwd": ("cuda", "src/repro_torch/kernels/csrc/mlstm_scan_bwd.cu",
                       "src/repro/models/steps.py:44", XLSTM_TRAIN_PATH,
                       "mlstm_scan.mlstm_scan_bwd"),
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


def _device_ms(fn, iters: int, capturable: bool = True) -> tuple[float, str, float | None, dict]:
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
    activities per call in the median trace, None otherwise, the device
    activities of that trace by name, ms per call, longest first; empty
    otherwise)."""
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
                         {n: by_name[n] / 1e3 / iters
                          for n in sorted(by_name, key=by_name.get, reverse=True)}))
        if len(readings) == 3:
            break
    if readings:
        ms, per_call, names = sorted(readings, key=lambda r: r[0])[len(readings) // 2]
        return ms, "profiler", per_call, names
    if not capturable:
        return _cuda_ms(fn, iters), "cuda events", None, {}
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _cuda_ms(graph.replay, 3, warmup=1) / iters, "cuda graph", None, {}


def _sdpa_backend(names) -> str:
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


def _bound_ms(nbytes: float, flops: float, peak: str, hw) -> tuple[float, str]:
    """The least time for ``nbytes`` and ``flops`` on the card ``hw`` (its
    ``HardwareSpec``), at its ``peak`` rate: "bf16" (tensor cores) or
    "fp32" (CUDA cores)."""
    rate = hw.peak_flops_bf16 if peak == "bf16" else hw.peak_flops_fp32
    t_bytes, t_ops = nbytes / hw.hbm_bw, flops / rate
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
        nbytes=2 * (2 * rows * d + d), flops=4 * rows * d, peak="fp32")


def _flash_case(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, gen, window: int = 0,
                dv: int = 0, causal: bool = True):
    """With ``dv``: MLA's call (``models/attention.mla_forward``), v of dv
    columns zero-padded to D and the scale of D passed; its library call is
    SDPA on the same inputs, causal by ``is_causal`` (the form SDPA's
    fused backends take), with that scale.  The bound counts what the
    function needs: q and k of D columns, v and the output of dv, so the
    padding is the kernel's cost.  ``causal`` False (whisper's encoder and
    cross-attention): every query sees every key, so the bound's operations
    count the full Sq x Skv rectangle, and the library call is SDPA with
    no mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, skv, hkv, dv or d, device="cuda", generator=gen).to(torch.bfloat16)
    dv = dv or d
    if dv < d:
        v = F.pad(v, (0, d - dv))
    off = skv - sq
    qpos = torch.arange(sq, device="cuda")[:, None] + off
    kpos = torch.arange(skv, device="cuda")[None, :]
    mask = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)  # causal, offset
    if window:
        mask &= kpos > qpos - window
    visible = int(mask.sum())                                        # keys seen, all rows
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(causal=True, q_offset=off, window=window) if causal else dict(causal=False)
    if dv < d:
        kw["scale"] = d ** -0.5
        lib_kw = dict(is_causal=True, scale=kw["scale"])
    elif not causal:
        lib_kw = dict(enable_gqa=True)
    else:
        lib_kw = dict(attn_mask=mask, enable_gqa=True)
    return dict(
        shape=f"q ({b},{sq},{hq},{d}) kv ({b},{skv},{hkv},{d}) "
              + (f"causal q_offset {off}" if causal else "non-causal")
              + (f" window {window}" if window else "")
              + (f" v {dv} zero-padded, scale {d}^-0.5" if dv < d else "") + " bf16",
        kernel=lambda: ops.flash_attention(q, k, v, use_kernel=True, **kw),
        twin=lambda: ref.flash_attention_ref(q, k, v, **kw),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib_kw),
        nbytes=2 * (b * sq * hq * (d + dv) + b * skv * hkv * (d + dv)),
        flops=2 * (d + dv) * b * hq * visible, peak="bf16")


def _flash_bwd_case(b: int, s: int, hq: int, hkv: int, d: int, gen, window: int = 0,
                    dtype=None, causal: bool = True, skv: int = 0, dv: int = 0):
    """The backward kernel alone on the training forward's log-sum-exp and
    fp32 output, against the twin's gradient (autograd in fp32); the
    library call is the backward of SDPA (autograd of one forward, kept).
    ``causal`` False (whisper's encoder, and with ``skv`` keys its
    cross-attention): every query sees every key, and SDPA runs with no
    mask.  With ``dv``: MLA's call (``models/attention.mla_forward``), v of
    dv columns zero-padded to D and dO zero past dv (the output is cut
    there), the scale of D.  The bound counts the five Sq x Skv products
    over the visible pairs (three of D columns, two of dv), and each of q,
    k, v, dO, lse and the fp32 output read once and dq, dk, dv written
    once, v, dO, dv and the output at dv columns (bf16 past head dim 128
    reads no fp32 output)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    dtype = dtype or torch.bfloat16
    skv = skv or s
    q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, skv, hkv, dv or d, device="cuda", generator=gen).to(dtype)
    do = torch.randn(b, s, hq, dv or d, device="cuda", generator=gen).to(dtype)
    dv = dv or d
    if dv < d:
        v, do = F.pad(v, (0, d - dv)), F.pad(do, (0, d - dv))
    _, lse, o32 = fa.forward_for_training(q, k, v, causal, window, d ** -0.5)
    qpos, kpos = torch.arange(s, device="cuda")[:, None], torch.arange(skv, device="cuda")[None, :]
    mask = kpos <= qpos if causal else torch.ones((s, skv), dtype=torch.bool, device="cuda")
    if window:
        mask &= kpos > qpos - window
    visible = int(mask.sum())
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_kw = (dict(attn_mask=mask) if window else dict(is_causal=True)) if causal else {}
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **lib_kw)
    do_t = do.transpose(1, 2)
    kw = dict(causal=causal, window=window)
    size = 2 if dtype == torch.bfloat16 else 4
    o32_cols = dv if o32 is not None else 0
    return dict(
        shape=f"q ({b},{s},{hq},{d}) kv {hkv}" + (f" x {skv} rows" if skv != s else "")
              + (" causal" if causal else " non-causal")
              + (f" window {window}" if window else "")
              + (f" v {dv} zero-padded, scale {d}^-0.5" if dv < d else "")
              + (" bf16" if size == 2 else " fp32"),
        kernel=lambda: ops.flash_attention_bwd(q, k, v, do, lse, o32, use_kernel=True, **kw),
        twin=lambda: ref.flash_attention_bwd_ref(q, k, v, do, **kw),
        library=lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t, retain_graph=True),
        capturable=False,
        nbytes=size * (b * s * hq * (2 * d + dv) + 2 * b * skv * hkv * (d + dv))
        + 4 * b * hq * s * (o32_cols + 1),
        flops=2 * (3 * d + 2 * dv) * b * hq * visible, peak="bf16" if size == 2 else "fp32",
        floor=BWD_FLOOR)


def _flash_train_case(b: int, s: int, hq: int, hkv: int, d: int, gen, window: int = 0,
                      dv: int = 0):
    """The training forward (``flash_attention.forward_for_training``, the
    LSE variant, causal, ``q_offset`` 0): its output, the rows' log-sum-exp
    and (up to head dim 128) O32 against the twin's output, the log-sum-exp
    of its scaled scores and its output from the inputs in fp32; with
    ``dv`` MLA's call as in ``_flash_case``.  The library call is SDPA's
    forward on the same inputs.  The bound counts ``_flash_case``'s bytes
    plus lse and O32 written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q = torch.randn(b, s, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, dv or d, device="cuda", generator=gen).to(torch.bfloat16)
    dv = dv or d
    if dv < d:
        v = F.pad(v, (0, d - dv))
    scale = d ** -0.5
    n_out = 3 if d <= fa.O32_MAX_HEAD_DIM else 2      # (out, lse, O32), or no O32
    o32_cols = dv if n_out == 3 else 0
    pos = torch.arange(s, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    visible = int(mask.sum())
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib_kw = dict(attn_mask=mask) if window else dict(is_causal=True)

    def twin():
        out = ref.flash_attention_ref(q, k, v, window=window, scale=scale)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float().repeat_interleave(hq // hkv, 2)) * scale
        lse = torch.logsumexp(torch.where(mask, logits, -torch.inf), dim=-1)
        del logits
        if n_out == 2:
            return out, lse
        return out, lse, ref.flash_attention_ref(q.float(), k.float(), v.float(), window=window,
                                                 scale=scale)
    return dict(
        shape=f"q ({b},{s},{hq},{d}) kv {hkv} causal" + (f" window {window}" if window else "")
              + (f" v {dv} zero-padded, scale {d}^-0.5" if dv < d else "")
              + f" bf16, training forward ({'lse, O32' if n_out == 3 else 'lse'})",
        kernel=lambda: fa.forward_for_training(q, k, v, True, window, scale)[:n_out],
        twin=twin,
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, scale=scale,
                                                       **lib_kw),
        nbytes=2 * (b * s * hq * (d + dv) + b * s * hkv * (d + dv))
        + 4 * b * hq * s * (o32_cols + 1),
        flops=2 * (d + dv) * b * hq * visible, peak="bf16")


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
        flops=8 * rows * d, peak="fp32", floor=BWD_FLOOR)


def _decode_case(lens: list, s: int, hq: int, hkv: int, d: int, gen, row_heads: int = 0):
    """Decode attention over a (B,s,hkv,d) cache; with ``row_heads``, the
    cache is a range of hkv heads (from the middle one on) of a cache whose
    rows hold ``row_heads`` heads, which the kernel reads in place."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import _row_heads
    b = len(lens)
    hs = row_heads or hkv
    q = torch.randn(b, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    kc = torch.randn(b, s, hs, d, device="cuda", generator=gen).to(torch.bfloat16)
    vc = torch.randn(b, s, hs, d, device="cuda", generator=gen).to(torch.bfloat16)
    view = ""
    if row_heads:
        kc, vc = kc.narrow(2, hs // 2, hkv), vc.narrow(2, hs // 2, hkv)
        if _row_heads(kc) != hs or _row_heads(vc) != hs:
            raise AssertionError(f"decode case: a {hkv}-head view of {hs}-head rows is not "
                                 f"read in place (_row_heads {_row_heads(kc)})")
        view = f" of rows of {hs} heads, read in place"
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :] < cl[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    return dict(
        shape=f"q ({b},{hq},{d}) cache ({b},{s},{hkv},{d}){view} lens {lens} bf16",
        kernel=lambda: ops.decode_attention(q, kc, vc, cl, use_kernel=True),
        twin=lambda: ref.decode_attention_ref(q, kc, vc, cl),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                       enable_gqa=True),
        nbytes=2 * (2 * b * hq * d + 2 * sum(lens) * hkv * d) + 4 * b,
        flops=4 * d * hq * sum(lens), peak="bf16")


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
        flops=5 * b * s * h * p * n, peak="bf16")


def _ssm_bwd_case(b: int, s: int, h: int, p: int, n: int, chunk: int, gen):
    """The scan's backward kernel on ``_ssm_case``'s inputs and a bf16 dy
    (h_final's gradient None, as in training: the loss reads y alone),
    against the twin's gradient (autograd of ``ops.ssd_chunked`` in fp32 at
    the inputs' values).  No PyTorch call computes it.  The bound counts
    the sequential recurrence's backward state work, ~10 P N flops per
    token and head (the forward's 5 P N, twice: the state and its
    gradient), at the bf16 tensor-core rate, and each input (x, dt, A, B,
    C, dy) read once and each gradient written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    x = (torch.randn(b, s, h, p, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
    dt = F.softplus(torch.randn(b, s, h, device="cuda", generator=gen)).to(torch.bfloat16)
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    bm = (torch.randn(b, s, n, device="cuda", generator=gen) * 0.3).to(torch.bfloat16)
    cm = (torch.randn(b, s, n, device="cuda", generator=gen) * 0.3).to(torch.bfloat16)
    dy = torch.randn(b, s, h, p, device="cuda", generator=gen).to(torch.bfloat16)
    return dict(
        shape=f"x ({b},{s},{h},{p}) N {n} chunk {chunk} bf16, backward (dh_final None)",
        kernel=lambda: ops.ssm_scan_bwd(x, dt, A, bm, cm, dy, use_kernel=True),
        twin=lambda: ops.ssm_scan_bwd(x, dt, A, bm, cm, dy, chunk=chunk, use_kernel=False),
        library=None,           # no single PyTorch call computes the scan's gradient
        nbytes=2 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * n) + 2 * 4 * h,
        flops=10 * b * s * h * p * n, peak="bf16", floor=BWD_FLOOR)


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
        flops=4 * b * s * h * d * d, peak="bf16")


def _mlstm_bwd_case(b: int, s: int, h: int, d: int, chunk: int, gen):
    """The scan's backward kernel on ``_mlstm_case``'s inputs and a bf16 dy,
    against the twin's gradient (autograd of ``ops.mlstm_chunked`` in fp32 at
    the inputs' values).  No PyTorch call computes it.  The bound counts the
    sequential recurrence's backward state work, ~10 D^2 flops per token and
    head (the state's rerun, its gradient's update, and dq from the state,
    dk and dv from its gradient), at the bf16 tensor-core rate, and each
    input (q, k, v, dy, the two gates) read once and each gradient written
    once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    q, k, v, dy = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    li = torch.randn(b, s, h, device="cuda", generator=gen) * 0.5
    lf = F.logsigmoid(torch.randn(b, s, h, device="cuda", generator=gen) + 3.0)
    return dict(
        shape=f"q ({b},{s},{h},{d}) chunk {chunk} bf16, backward",
        kernel=lambda: ops.mlstm_scan_bwd(q, k, v, li, lf, dy, use_kernel=True),
        twin=lambda: ops.mlstm_scan_bwd(q, k, v, li, lf, dy, chunk=chunk, use_kernel=False),
        library=None,           # no single PyTorch call computes the scan's gradient
        nbytes=2 * 7 * b * s * h * d + 4 * 4 * b * s * h,
        flops=10 * b * s * h * d * d, peak="bf16", floor=BWD_FLOOR)


def _run_case(name: str, case: dict, iters: int, hw) -> dict:
    got, want = case["kernel"](), case["twin"]()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    checks = [_check(f"{name} output {i}", g, w, case.get("floor", 0.0))
              for i, (g, w) in enumerate(zip(got, want))]
    bound, by = _bound_ms(case["nbytes"], case["flops"], case["peak"], hw)
    lib = case["library"]
    device_ms, source, per_call, passes = _device_ms(case["kernel"], iters)
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
            "library_kernels": list(lib_dev[3])[:3] if lib is not None else None,
            "device_kernels": passes,
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


def _pass_name(name: str) -> str:
    """A profiler's demangled kernel name without its namespace, return type
    and arguments: ``mlstm_bwd_walk<__nv_bfloat16, true>``."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")


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

    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {}

    # -- phase 1: card, build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    report["card"] = card
    # the card's peaks, for every bound below: its HardwareSpec, by its name
    from repro_torch.clouds.profiles import hardware_for
    hw = hardware_for(torch.cuda.get_device_name(0))
    memory = torch.cuda.get_device_properties(0).total_memory
    print(f"{card}: {hw} (data-sheet peaks); the card reports {memory} bytes of memory")
    if abs(hw.hbm_bytes - memory) > HBM_SPEC_SHARE * memory:
        raise AssertionError(f"{hw.name}: hbm_bytes {hw.hbm_bytes} more than "
                             f"{HBM_SPEC_SHARE:.0%} off the card's {memory}")
    report["hardware"] = {**dataclasses.asdict(hw), "device_memory_bytes": memory}
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
    # the mLSTM backward's bf16 passes at head dim 512 multiply on wgmma
    mlstm_sass = report["sass"].get("mlstm_scan_bwd.cu")
    for k in ("mlstm_bwd_tc_walk", "mlstm_bwd_tc_chunk"):
        if mlstm_sass is not None and not any(i.startswith("HGMMA")
                                              for i in mlstm_sass.get(k, {})):
            raise AssertionError(f"mlstm_scan_bwd.cu: no HGMMA in {k}'s SASS")
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm = _rmsnorm_case(8, 4096, gen)
    t0 = time.perf_counter()
    _check("rmsnorm first call", warm["kernel"](), warm["twin"]())
    triton_s = time.perf_counter() - t0
    print(f"build: nvcc {build_s:.1f} s wall ({len(built)} sources built), "
          f"triton rmsnorm first call {triton_s:.1f} s")
    report["phase_s"] = {}
    last = [t_run]

    def mark(phase: str) -> None:
        """Print the seconds since the last mark: where the run's time goes."""
        now = time.perf_counter()
        report["phase_s"][phase] = now - last[0]
        print(f"chip_smoke: {phase} {now - last[0]:.1f} s (the run at {now - t_run:.1f} s)  "
              f"[{card}]")
        last[0] = now

    mark("phase 1, the card and the build")

    # -- phase 2: kernels vs twins -------------------------------------------
    g = registry.get_config("granite_3_8b")
    z = registry.get_config("zamba2_1_2b")
    xl = registry.get_config("xlstm_1_3b")
    h = registry.get_config("h2o_danube_3_4b")
    mt = registry.get_config("minitron_4b")
    gm = registry.get_config("gemma3_4b")
    gmo = registry.get_config("granite_moe_3b_a800m")
    ds = registry.get_config("deepseek_v2_lite_16b")
    ds_qk = ds.qk_nope_dim + ds.qk_rope_dim             # MLA's qk head dim, 192
    wb = registry.get_config("whisper_base")
    qv = registry.get_config("qwen2_vl_7b")
    vlm_cache = VLM_PROMPT + GEN + 1
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
        # whisper's training calls at batch 4 x PROMPT, no causal mask: the
        # encoder's over its 1500 frame rows, the decoder's cross-attention
        # (PROMPT queries over those rows)
        ("flash_attention_bwd", _flash_bwd_case(BATCH, wb.encoder_len, wb.n_heads, wb.n_kv_heads,
                                                wb.head_dim, gen, causal=False), 5),
        ("flash_attention_bwd", _flash_bwd_case(BATCH, PROMPT, wb.n_heads, wb.n_kv_heads,
                                                wb.head_dim, gen, causal=False,
                                                skv=wb.encoder_len), 10),
        # deepseek's MLA prefill at a long prompt: D 192 through the
        # 320-column tile, v zero-padded, against SDPA's fused backends
        ("flash_attention", _flash_case(1, 2048, 2048, ds.n_heads, ds.n_kv_heads, ds_qk, gen,
                                        dv=ds.v_head_dim), 10),
        # training past head dim 128 (the wide-head training leg's shapes):
        # the training forward and the backward at gemma3's (2 x 2048, 8/4
        # heads of 320) windowed and global, deepseek's MLA (4 x 1024, 16
        # heads of 192, v zero-padded from 128) and its tensor-parallel
        # rank's (8 of the 16 heads)
        ("flash_attention", _flash_train_case(2, 2048, gm.n_heads, gm.n_kv_heads, gm.head_dim,
                                              gen, window=gm.sliding_window), 5),
        ("flash_attention", _flash_train_case(2, 2048, gm.n_heads, gm.n_kv_heads, gm.head_dim,
                                              gen), 5),
        ("flash_attention", _flash_train_case(TRAIN_BATCH, TRAIN_SEQ, ds.n_heads, ds.n_kv_heads,
                                              ds_qk, gen, dv=ds.v_head_dim), 5),
        ("flash_attention", _flash_train_case(TRAIN_BATCH, TRAIN_SEQ, ds.n_heads // TP_RANKS,
                                              ds.n_kv_heads // TP_RANKS, ds_qk, gen,
                                              dv=ds.v_head_dim), 5),
        ("flash_attention_bwd", _flash_bwd_case(2, 2048, gm.n_heads, gm.n_kv_heads, gm.head_dim,
                                                gen, window=gm.sliding_window), 5),
        ("flash_attention_bwd", _flash_bwd_case(2, 2048, gm.n_heads, gm.n_kv_heads, gm.head_dim,
                                                gen), 5),
        ("flash_attention_bwd", _flash_bwd_case(TRAIN_BATCH, TRAIN_SEQ, ds.n_heads,
                                                ds.n_kv_heads, ds_qk, gen,
                                                dv=ds.v_head_dim), 5),
        ("flash_attention_bwd", _flash_bwd_case(TRAIN_BATCH, TRAIN_SEQ, ds.n_heads // TP_RANKS,
                                                ds.n_kv_heads // TP_RANKS, ds_qk, gen,
                                                dv=ds.v_head_dim), 5),
        ("flash_attention_bwd", _flash_bwd_case(1, 256, 8, 4, 320, gen, window=100,
                                                dtype=torch.float32), 5),
        # the scan's backward at a ragged S (1000: the last chunk 40 rows)
        ("ssm_scan_bwd", _ssm_bwd_case(1, 1000, z.n_heads, zp, z.ssm_state, z.ssm_chunk, gen),
         5),
        # and one row past S 1024: 64 chunks, the state walks' length
        ("ssm_scan_bwd", _ssm_bwd_case(1, 4096, z.n_heads, zp, z.ssm_state, z.ssm_chunk, gen),
         5),
        # the mLSTM scan's backward over one row of 4096: 64 chunks, the
        # walks' length and dlogf's longest reverse sum
        ("mlstm_scan_bwd", _mlstm_bwd_case(1, 4096, xl.n_heads, xhd, xl.ssm_chunk, gen), 5),
        # whisper's decoder: its prompt's queries over the 1500 encoder rows
        # (non-causal cross-attention), and decode over its self-attention
        # cache (its path case below is decode over the encoder rows)
        ("flash_attention", _flash_case(BATCH, PROMPT, wb.encoder_len, wb.n_heads,
                                        wb.n_kv_heads, wb.head_dim, gen, causal=False), 20),
        ("decode_attention", _decode_case([PROMPT + 1] * BATCH, cache_len, wb.n_heads,
                                          wb.n_kv_heads, wb.head_dim, gen), 50),
        # whisper on a rank of (1, TP_RANKS): its prompt's queries over the
        # 1500 encoder rows at 4 of the 8 heads, forward and backward
        ("flash_attention", _flash_case(BATCH, PROMPT, wb.encoder_len, wb.n_heads // TP_RANKS,
                                        wb.n_kv_heads // TP_RANKS, wb.head_dim, gen,
                                        causal=False), 20),
        ("flash_attention_bwd", _flash_bwd_case(BATCH, PROMPT, wb.n_heads // TP_RANKS,
                                                wb.n_kv_heads // TP_RANKS, wb.head_dim, gen,
                                                causal=False, skv=wb.encoder_len), 10),
        # a rank of the 16 x 16 pod serving granite: its 2 query heads over
        # the one kv head they read, a view of the whole cache (8 kv heads
        # do not divide 16), which the kernel reads in place
        ("decode_attention", _decode_case([PROMPT + 1] * BATCH, cache_len,
                                          g.n_heads // POD_MODEL, 1, g.head_dim, gen,
                                          row_heads=g.n_kv_heads), 50),
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
        "granite-moe-3b-a800m serving": {         # a GQA group of 3
            "rmsnorm": (_rmsnorm_case(rows, gmo.d_model, gen), 50),
            "flash_attention": (_flash_case(BATCH, PROMPT, PROMPT, gmo.n_heads, gmo.n_kv_heads,
                                            gmo.head_dim, gen), 20),
            "decode_attention": (_decode_case([PROMPT + 1] * BATCH, cache_len, gmo.n_heads,
                                              gmo.n_kv_heads, gmo.head_dim, gen), 50)},
        "deepseek-v2-lite-16b serving": {         # MLA: D 192, v padded; decode runs no kernel
            "rmsnorm": (_rmsnorm_case(rows, ds.d_model, gen), 50),
            "flash_attention": (_flash_case(BATCH, PROMPT, PROMPT, ds.n_heads, ds.n_kv_heads,
                                            ds_qk, gen, dv=ds.v_head_dim), 20)},
        "whisper-base serving": {                 # the encoder's rows: non-causal flash, decode
            "rmsnorm": (_rmsnorm_case(BATCH * wb.encoder_len, wb.d_model, gen), 50),
            "flash_attention": (_flash_case(BATCH, wb.encoder_len, wb.encoder_len, wb.n_heads,
                                            wb.n_kv_heads, wb.head_dim, gen, causal=False), 10),
            "decode_attention": (_decode_case([wb.encoder_len] * BATCH, wb.encoder_len,
                                              wb.n_heads, wb.n_kv_heads, wb.head_dim, gen), 50)},
        VLM_PATH: {                               # a GQA group of 7 in both kernels
            "rmsnorm": (_rmsnorm_case(BATCH * VLM_PROMPT, qv.d_model, gen), 50),
            "flash_attention": (_flash_case(BATCH, VLM_PROMPT, VLM_PROMPT, qv.n_heads,
                                            qv.n_kv_heads, qv.head_dim, gen), 20),
            "decode_attention": (_decode_case([VLM_PROMPT + 1] * BATCH, vlm_cache, qv.n_heads,
                                              qv.n_kv_heads, qv.head_dim, gen), 50)},
        "xlstm-1.3b scoring": {
            "rmsnorm": (_rmsnorm_case(rows, xl.d_model, gen), 50),
            "mlstm_scan": (_mlstm_case(BATCH, PROMPT, xl.n_heads, xhd, xl.ssm_chunk, gen), 20)},
        TRAIN_PATH: {
            "flash_attention_bwd": (_flash_bwd_case(TRAIN_BATCH, TRAIN_SEQ, g.n_heads,
                                                    g.n_kv_heads, g.head_dim, gen), 5),
            "rmsnorm_bwd": (_rmsnorm_bwd_case(TRAIN_BATCH * TRAIN_SEQ, g.d_model, gen), 20)},
        SSM_TRAIN_PATH: {                         # zamba2's training shape, both ways
            "ssm_scan": (_ssm_case(TRAIN_BATCH, TRAIN_SEQ, z.n_heads, zp, z.ssm_state,
                                   z.ssm_chunk, gen), 10),
            "ssm_scan_bwd": (_ssm_bwd_case(TRAIN_BATCH, TRAIN_SEQ, z.n_heads, zp, z.ssm_state,
                                           z.ssm_chunk, gen), 5)},
        XLSTM_TRAIN_PATH: {                       # xlstm's training shape, both ways
            "mlstm_scan": (_mlstm_case(XLSTM_TRAIN[2], XLSTM_TRAIN[3], xl.n_heads, xhd,
                                       xl.ssm_chunk, gen), 10),
            "mlstm_scan_bwd": (_mlstm_bwd_case(XLSTM_TRAIN[2], XLSTM_TRAIN[3], xl.n_heads, xhd,
                                               xl.ssm_chunk, gen), 5)},
        TP_PATH: {                                # a rank's heads: Hq / TP_RANKS, Hkv / TP_RANKS
            "flash_attention": (_flash_case(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ,
                                            g.n_heads // TP_RANKS, g.n_kv_heads // TP_RANKS,
                                            g.head_dim, gen), 10),
            "flash_attention_bwd": (_flash_bwd_case(TRAIN_BATCH, TRAIN_SEQ, g.n_heads // TP_RANKS,
                                                    g.n_kv_heads // TP_RANKS, g.head_dim,
                                                    gen), 5)},
        TP_SERVE_PATH: {                          # a rank's heads and cache block: 16 over 4
            "decode_attention": (_decode_case([PROMPT + 1] * BATCH, cache_len,
                                              g.n_heads // TP_RANKS, g.n_kv_heads // TP_RANKS,
                                              g.head_dim, gen), 50)},
        TP_SSM_PATH: {                            # a rank's heads: 16 of 32, 2 of 4
            "ssm_scan": (_ssm_case(BATCH, PROMPT, z.n_heads // TP_RANKS, zp, z.ssm_state,
                                   z.ssm_chunk, gen), 20),
            "mlstm_scan": (_mlstm_case(BATCH, PROMPT, xl.n_heads // TP_RANKS, xhd, xl.ssm_chunk,
                                       gen), 20),
            "ssm_scan_bwd": (_ssm_bwd_case(TRAIN_BATCH, TRAIN_SEQ, z.n_heads // TP_RANKS, zp,
                                           z.ssm_state, z.ssm_chunk, gen), 5),
            "mlstm_scan_bwd": (_mlstm_bwd_case(TRAIN_BATCH, TP_SSM_SEQ, xl.n_heads // TP_RANKS,
                                               xhd, xl.ssm_chunk, gen), 5)},
        TP_ENCDEC_PATH: {                         # a rank's heads: 4 of 8, the encoder's rows
            "flash_attention": (_flash_case(BATCH, wb.encoder_len, wb.encoder_len,
                                            wb.n_heads // TP_RANKS, wb.n_kv_heads // TP_RANKS,
                                            wb.head_dim, gen, causal=False), 10),
            "flash_attention_bwd": (_flash_bwd_case(BATCH, wb.encoder_len, wb.n_heads // TP_RANKS,
                                                    wb.n_kv_heads // TP_RANKS, wb.head_dim, gen,
                                                    causal=False), 5),
            "decode_attention": (_decode_case([wb.encoder_len] * BATCH, wb.encoder_len,
                                              wb.n_heads // TP_RANKS, wb.n_kv_heads // TP_RANKS,
                                              wb.head_dim, gen), 50)},
        TP_MOE_PATH: {                            # a rank's heads: 12 over 4, a local group of 3
            "flash_attention": (_flash_case(TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ,
                                            gmo.n_heads // TP_RANKS, gmo.n_kv_heads // TP_RANKS,
                                            gmo.head_dim, gen), 10),
            "flash_attention_bwd": (_flash_bwd_case(TRAIN_BATCH, TRAIN_SEQ,
                                                    gmo.n_heads // TP_RANKS,
                                                    gmo.n_kv_heads // TP_RANKS, gmo.head_dim,
                                                    gen), 5)},
    }
    cases = [_run_case(n, c, it, hw) for n, c, it in long_cases]
    path = {label: {n: _run_case(n, c, it, hw) for n, (c, it) in per.items()}
            for label, per in path_cases.items()}
    for r in cases + [r for per in path.values() for r in per.values()]:
        print(f"{r['kernel']:<17} {r['shape']}: err {r['max_abs_err']:.3g} "
              f"({r['tol_share']:.3g} of its tolerance) kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms, "
              f"{r['device_kernels_per_call']} device kernels a call), twin {r['plain_ms']:.4f} ms, "
              f"library {_fmt_ms(r['library_ms'])} (device {_fmt_ms(r['library_device_ms'])}"
              + (f", SDPA backend {r['library_backend']}" if r["library_backend"] else "")
              + f"), bound {r['bound_ms']:.4f} ms ({r['bound_by']})  [{card}]")
        if r["kernel"].endswith("_bwd") and len(r["device_kernels"]) > 1:
            print("  its device kernels, ms a call: " + "; ".join(
                f"{_pass_name(n)} {ms:.4f}" for n, ms in r["device_kernels"].items()))
    report["cases"], report["path_cases"] = cases, path
    del long_cases, path_cases
    torch.cuda.empty_cache()
    mark("phase 2, kernels vs twins")

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
    mark("phase 3, the paths")

    # -- the MNIST train-to-serve leg: no port kernel on its path ----------
    report["mnist_leg"] = _mnist_leg(card)
    mark("mnist leg")
    gc.collect()
    torch.cuda.empty_cache()

    # -- LM training: both ways through the kernels --------------------------
    report["lm_train_leg"] = _lm_train_leg(card)
    mark("lm train leg")

    # -- training past head dim 128: gemma3 (320) and deepseek's MLA (192) ----
    report["wide_train_leg"] = _wide_train_leg(card)
    mark("wide train leg")
    gc.collect()
    torch.cuda.empty_cache()

    # -- zamba2 training through the SSD scan's forward and backward kernels ----
    report["ssm_train_leg"] = _ssm_train_leg(card)
    mark("ssm train leg")
    gc.collect()
    torch.cuda.empty_cache()

    # -- xlstm training through the mLSTM scan's forward and backward kernels --
    report["xlstm_train_leg"] = _xlstm_train_leg(card)
    mark("xlstm train leg")
    gc.collect()
    torch.cuda.empty_cache()

    # -- data-parallel LM training: two ranks on the card ---------------------
    report["dp_train_leg"] = _dp_train_leg(card)
    mark("dp train leg")

    # -- tensor-parallel LM training: two ranks on the card -------------------
    report["tp_train_leg"] = _tp_train_leg(card)
    mark("tp train leg")

    # -- tensor-parallel training of the MoE archs: two ranks on the card ------
    report["tp_moe_train_leg"] = _tp_moe_leg(card)
    mark("tp moe train leg")

    # -- tensor-parallel serving: two ranks on the card ------------------------
    report["tp_serve_leg"] = _tp_serve_leg(card)
    mark("tp serve leg")

    # -- tensor parallelism of the recurrent mixers: two ranks on the card ------
    report["tp_ssm_leg"] = _tp_ssm_leg(card)
    mark("tp ssm leg")

    # -- tensor parallelism of enc-dec (whisper): two ranks on the card ---------
    report["tp_encdec_leg"] = _tp_encdec_leg(card)
    mark("tp encdec leg")

    # -- the roofline: every timed phase at or above its bound ---------------
    report["roofline_phase"] = _roofline_phase(report, hw, card)
    mark("roofline phase")

    # -- phase 4: report -----------------------------------------------------
    totals = {n: sum(r["launches_run"][n] for r in report["paths"].values())
              + report["mnist_leg"]["launches"][n] + report["lm_train_leg"]["launches"][n]
              + report["wide_train_leg"]["launches"][n] + report["ssm_train_leg"]["launches"][n]
              + report["xlstm_train_leg"]["launches"][n]
              + report["dp_train_leg"]["launches"][n] + report["tp_train_leg"]["launches"][n]
              + report["tp_moe_train_leg"]["launches"][n] + report["tp_serve_leg"]["launches"][n]
              + report["tp_ssm_leg"]["launches"][n] + report["tp_encdec_leg"]["launches"][n]
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
    report["total_s"] = time.perf_counter() - t_run
    print(f"chip_smoke: the whole run {report['total_s']:.1f} s  [{card}]")
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
        scans = ("ssm_scan", "mlstm_scan", "ssm_scan_bwd", "mlstm_scan_bwd")
        extra = {"chunk": cfg.ssm_chunk} if n in scans else {}
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


def _prompts(cfg, prompt: int = PROMPT):
    import torch
    return torch.randint(0, cfg.vocab_size, (BATCH, prompt), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))


def _mrope_grid(b: int, s: int, n_vis: int, side: int):
    """(B,3,S) M-RoPE positions of Qwen2-VL's layout: n_vis image rows on a
    ``side``-wide grid (t 0, h = i // side, w = i % side), then text from
    the grid's larger side onward, equal on all three streams."""
    import torch
    i = torch.arange(s)
    text = max(-(-n_vis // side), side) + i - n_vis
    img = i < n_vis
    pos = torch.stack([torch.where(img, 0, text), torch.where(img, i // side, text),
                       torch.where(img, i % side, text)])
    return pos[None].expand(b, 3, s).to(torch.int32).contiguous()


def _gate_inputs(cfg, tokens):
    """The logit gates' batch around ``tokens`` (B,S) on the card, and the
    first decode step's positions.  Where the predictor feeds zeros (the
    reference's stub frontends), the gates draw from a seeded generator:
    whisper's frames; qwen2-vl's vision rows, on an image grid of M-RoPE
    positions.  Decode is held where the temporal stream is the sequence
    index (t = S on every stream), the one place where the reference's
    cache index by t (ROADMAP queue 3) writes a new row."""
    import torch
    from repro_torch.models import steps
    b, s = tokens.shape
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": tokens}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(b, cfg.encoder_len, cfg.d_model, generator=gen).cuda()
    if cfg.family == "vlm":
        n_vis = min(cfg.n_vision_tokens, s)
        batch["vision_embeds"] = (torch.randn(b, n_vis, cfg.d_model, generator=gen)
                                  * 0.02).cuda()
        batch["mrope_positions"] = _mrope_grid(b, s, n_vis, VLM_GRID).cuda()
    return batch, steps.start_positions(cfg, b, s, "cuda")


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
    prompt = VLM_PROMPT if label == VLM_PATH else PROMPT
    cache_len = prompt + GEN + 1
    pred = make_lm_predictor(cfg, gen_tokens=GEN, prompt_len=prompt, params=params)
    prompts = _prompts(cfg, prompt).numpy()

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
        batch, start = _gate_inputs(cfg, torch.as_tensor(prompts, device="cuda"))
        per = {}
        native.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last_k, cache = steps.prefill(params, batch, cfg=cfg, cache_len=cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        per["prefill"] = dict(native.LAUNCHES)
        first = torch.argmax(last_k, -1).to(torch.int32)[:, None]
        # whisper: the cached encoder rows, which decode reads and must not write
        cross = {(pi, slot, k): (t, t.clone()) for pi, pc in cache.items()
                 if pi.startswith("phase") for slot, c in pc.items() for k, t in c.items()
                 if k.startswith("cross_")}
        native.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.greedy_decode_loop(params, cache, first, start, GEN, cfg=cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / GEN
        per["decode_step"] = {k: n // GEN for k, n in native.LAUNCHES.items()}
        moved = [key for key, (t, before) in cross.items() if not torch.equal(t, before)]
        if moved:
            raise AssertionError(f"{label}: decode wrote the cached encoder rows {moved}")
        del cache, cross
        peak_gib = torch.cuda.max_memory_allocated() / 2**30      # the served runs'
        if not bool(torch.isfinite(last_k.float()).all()):
            raise AssertionError(f"{label}: prefill logits not finite")
        # kernel path vs plain path on the same weights; every kernel call of
        # the kernel path's prefill and decode step recorded.  MoE: the plain
        # path routes as the kernel path did (``_routing``), so the logits
        # differ by the kernels' rounding alone, and the decisions it would
        # have made otherwise are counted
        plain = cfg.replace(use_kernels=False)
        with _recording(expected) as calls, _routing() as ids_k:
            last_k, cache_k = steps.prefill(params, batch, cfg=cfg, cache_len=cache_len)
            n_prefill = len(ids_k)
            step_k, _ = lm.decode_step(params, cfg, first, start, cache_k)
        del cache_k
        with _routing(replay=ids_k) as ids_p:
            last_p, cache_p = steps.prefill(params, batch, cfg=plain, cache_len=cache_len)
            step_p, _ = lm.decode_step(params, plain, first, start, cache_p)
        del cache_p
        flips = {"prefill": _flips(ids_k[:n_prefill], ids_p[:n_prefill]),
                 "decode": _flips(ids_k[n_prefill:], ids_p[n_prefill:])} if cfg.n_experts \
            else None
        del ids_k, ids_p
        if not bool(torch.isfinite(step_k.float()).all()):
            raise AssertionError(f"{label}: decode-step logits not finite")
        recorded = _hold_recorded(label, cfg, calls)
        del calls
    long_leg = None
    if label == LONG_LEG_PATH:
        long_leg = _long_leg(params, cfg, label, expected, limits, card)
        launches = {k: n + long_leg["launches"][k] for k, n in launches.items()}
    # the same weights in fp32, through the kernels and the plain path: the
    # first gate's pair, and the yardstick both bf16 paths are held against.
    # The tree is cast in place, largest leaf first, each bf16 leaf freed as
    # its fp32 twin is made: the peak is the fp32 tree and about one leaf
    # (deepseek: 62.8 GB; a full copy beside the bf16 tree would not fit)
    del pred, svc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        _cast_in_place(params, torch.float32)
        params32 = params
        del params
        out32, ids32 = {}, {}
        for use in (True, False):               # the plain run replays the kernel run's routing
            c32 = cfg.replace(dtype="float32", use_kernels=use)
            with _routing(replay=ids32.get(True)) as ids32[use]:
                last, cache32 = steps.prefill(params32, batch, cfg=c32, cache_len=cache_len)
                step, _ = lm.decode_step(params32, c32, first, start, cache32)
            out32[use] = (last, step)
            del cache32
        del params32
    peak32_gib = torch.cuda.max_memory_allocated() / 2**30
    if flips is not None:
        flips["fp32, prefill and decode step"] = _flips(ids32[True], ids32[False])
    del ids32
    rel = _rels({"prefill": (last_k, last_p, out32[True][0], out32[False][0]),
                 "decode": (step_k, step_p, out32[True][1], out32[False][1])})
    if flips is not None:
        _print_flips(label, flips)
    _gate(label, rel, limits)
    print(f"{label}, full width ({cfg.n_layers} layers, {n_params / 1e9:.2f} B params, bf16): "
          f"batch {BATCH} prompt {prompt}: prefill {prefill_ms:.2f} ms, decode "
          f"{decode_ms:.2f} ms/token, peak {peak_gib:.2f} GiB (served runs; the fp32 "
          f"comparison after the in-place cast {peak32_gib:.2f} GiB); launches per prefill "
          f"{per['prefill']}, per decode step {per['decode_step']}  [{card}]")
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params, "batch": BATCH,
            "prompt": prompt, "gen": GEN, "init_s": init_s, "prefill_ms": prefill_ms,
            "decode_ms_per_token": decode_ms, "peak_gib": peak_gib, "peak_fp32_gib": peak32_gib,
            "rel": rel, "routing_flips": flips, "limits": limits,
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
      by the example's own ``check``; then its registry-model leg
      (``registry_leg``: gemma3-4b profiled analytically by
      ``roofline_fields``, deployed behind a ``ProfiledBackend``, 24
      requests), gated by the reference example's asserts;
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
    from repro_torch.examples.e2e_train_to_serve import (check, lenet_predictor, registry_leg,
                                                         train_to_serve)
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
    orchestrated["registry_model"] = registry_leg(out)
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
    reg = orchestrated["registry_model"]
    print(f"{label}: registry-model leg, {reg['model']} profiled by roofline_fields (analytic, "
          f"the H100's data-sheet peaks: {reg['service_time_s'] * 1e3:.3f} ms a request), "
          f"placed {reg['placement']}, {reg['requests']} Poisson requests p50 {reg['p50_s']:.4f} s "
          f"p99 {reg['p99_s']:.4f} s (simulated)")

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
              + f"; traces taken {t['traces']} (a trace with no device activity is taken "
              f"again)  [{card}]")
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


def _wide_train_leg(card: str) -> dict:
    """gemma3-4b (head dim 320, a 1024-key window on five layers of six) and
    deepseek-v2-lite-16b (MLA: qk 192, v zero-padded from 128) at full
    width, depth and batch cut as WIDE_ARCHS says, trained through the
    flash kernels past head dim 128 (``use_kernels=True``), each gated by
    ``_train_arch`` with the launch set TRAIN_KERNELS; steps/s, tokens/s
    and peak memory."""
    t_leg = time.perf_counter()
    out: dict = {"archs": {}, "launches": {n: 0 for n in META}}
    for arch, (layers, bsz, seq) in WIDE_ARCHS.items():
        res = _train_arch(arch, layers, bsz, seq, WIDE_PATH, TRAIN_KERNELS, card)
        out["archs"][arch] = res
        for n in META:
            out["launches"][n] += res["launches"][n]
    out["leg_s"] = time.perf_counter() - t_leg
    print(f"{WIDE_PATH}: the whole leg {out['leg_s']:.2f} s  [{card}]")
    return out


def _ssm_train_leg(card: str) -> dict:
    """zamba2-1.2b at full width, cut as SSM_TRAIN says, trained through
    the SSD scan's forward and backward kernels beside RMSNorm's and flash
    attention's (its shared block), gated by ``_train_arch`` with the launch
    set SSM_TRAIN_KERNELS."""
    arch, layers, bsz, seq = SSM_TRAIN
    t_leg = time.perf_counter()
    res = _train_arch(arch, layers, bsz, seq, SSM_TRAIN_PATH, SSM_TRAIN_KERNELS, card)
    out = {"archs": {arch: res}, "launches": res["launches"],
           "leg_s": time.perf_counter() - t_leg}
    print(f"{SSM_TRAIN_PATH}: the whole leg {out['leg_s']:.2f} s  [{card}]")
    return out


def _xlstm_train_leg(card: str) -> dict:
    """xlstm-1.3b at full width, cut as XLSTM_TRAIN says, trained through
    the mLSTM scan's forward and backward kernels beside RMSNorm's, gated by
    ``_train_arch`` with the launch set XLSTM_TRAIN_KERNELS, its bf16
    gradient norm and fp32 leaves under the sensitivity rule; then
    XLSTM_TIMED steps of ``steps.train_step`` timed on each path."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import lm_batches
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw

    arch, layers, bsz, seq = XLSTM_TRAIN
    t_leg = time.perf_counter()
    res = _train_arch(arch, layers, bsz, seq, XLSTM_TRAIN_PATH, XLSTM_TRAIN_KERNELS, card,
                      sens=True)
    # the training rate on each path: XLSTM_TIMED bf16 steps of
    # ``steps.train_step`` on the same masters and batch, after one warm-up
    cfg = registry.get_config(arch).replace(n_layers=layers, use_kernels=True)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg, bsz, seq, seed=3)).items()}
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    opt = adamw.init_opt_state(params)
    rate = {}
    for path, use in (("kernel", True), ("plain", False)):
        c = cfg.replace(use_kernels=use)
        steps.train_step(params, opt, batch, cfg=c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(XLSTM_TIMED):
            steps.train_step(params, opt, batch, cfg=c)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / XLSTM_TIMED
        rate[path] = {"step_ms": step_s * 1e3, "steps_per_s": 1.0 / step_s,
                      "tokens_per_s": bsz * seq / step_s}
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{XLSTM_TRAIN_PATH}, {XLSTM_TIMED} timed steps of steps.train_step a path: "
          + "; ".join(f"{k} path {v['step_ms']:.1f} ms a step ({v['steps_per_s']:.3f} steps/s, "
                      f"{v['tokens_per_s']:.0f} tokens/s)" for k, v in rate.items())
          + f"  [{card}]")
    out = {"archs": {arch: res}, "launches": res["launches"], "rate": rate,
           "leg_s": time.perf_counter() - t_leg}
    print(f"{XLSTM_TRAIN_PATH}: the whole leg {out['leg_s']:.2f} s  [{card}]")
    return out


def _train_arch(arch: str, layers: int, bsz: int, seq: int, path: str, kernels: tuple,
                card: str, sens: bool = False) -> dict:
    """``arch`` at full width, ``layers`` layers, batch ``bsz`` x ``seq``,
    trained through the kernels (``use_kernels=True``):

    - ``LMTrainJob.run`` (fp32 masters, bf16 compute) for WIDE_STEPS steps,
      launch counts zeroed before and read after: exactly ``kernels``;
      finite losses; the first batch's loss taken again with the trained
      parameters below its loss at the init;
    - every kernel call of one recorded ``steps.train_step``, forward and
      backward, held against its twin on the recorded inputs;
    - one step on fresh masters and one batch, kernel path against plain
      path: loss and global gradient norm in bf16, every gradient leaf in
      fp32, at TRAIN_LIMITS (with ``sens``, each fp32 leaf at the larger of
      that and SENS_RATIO times its one-ulp sensitivity: how far the plain
      path's gradient moves when every master moves by one ulp, the larger
      of two random nudges, ``_nudged``; and the bf16 gradient norm at the
      larger of its limit and SENS_RATIO times the norm's own one-ulp
      sensitivity, the largest move of either path's bf16 norm under the
      same two nudges); the MoE archs' plain runs replay the kernel run's
      expert ids (``_routing``), the decisions they would have made
      otherwise counted;
    - steps/s, tokens/s and peak memory."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.trainjob import LMTrainJob
    from repro_torch.data.tokens import lm_batches
    from repro_torch.kernels import native
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    from repro_torch.telemetry.events import EventLog

    full = registry.get_config(arch)
    cfg = full.replace(n_layers=layers, use_kernels=True)
    label = f"{full.name} {path}" if path == WIDE_PATH else path
    d = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim
    print(f"{label}: full width (d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{d}" + (f", v {cfg.v_head_dim} zero-padded" if cfg.use_mla else "")
          + (f", window {cfg.sliding_window} on its local layers"
             if "local" in cfg.block_pattern else "")
          + (f", Mamba2 {cfg.n_heads} heads of {cfg.d_inner // cfg.n_heads}, state "
             f"{cfg.ssm_state}, the shared block every {cfg.shared_attn_every}"
             if cfg.family == "hybrid" else "")
          + (f", mLSTM {cfg.n_heads} heads of {cfg.d_model // cfg.n_heads}, the sLSTM layer "
             f"every {cfg.slstm_every}" if cfg.family == "ssm" else "")
          + f"), depth cut from {full.n_layers} to {layers} layers; batch {bsz} x {seq}, "
          f"{WIDE_STEPS} steps, bf16 compute on fp32 masters, use_kernels=True  [{card}]")
    t_arch = time.perf_counter()

    # -- the job ----------------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    log = EventLog()
    res = LMTrainJob(cfg, batch_size=bsz, seq_len=seq, n_steps=WIDE_STEPS, log=log,
                     device="cuda").run()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(native.LAUNCHES)
    _expect(label, launches, kernels)
    history = res["history"]
    if not all(math.isfinite(v) for v in history):
        raise AssertionError(f"{label}: losses not finite: {history}")
    first = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg, bsz, seq)).items()}
    with torch.no_grad():
        again = float(steps.loss_fn(res["params"], cfg, first)[0])
    if not again < history[0]:
        raise AssertionError(f"{label}: the first batch's loss with the trained parameters, "
                             f"{again}, is not below its loss at the init, {history[0]}")
    n_params = sum(t.numel() for t in _leaves(res["params"]))
    train_s = log.totals()["tfjob:train"]
    tokens = WIDE_STEPS * bsz * seq
    del res, first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: {WIDE_STEPS} steps in {train_s:.3f} s ({WIDE_STEPS / train_s:.3f} "
          f"steps/s, {tokens / train_s:.0f} tokens/s), {n_params / 1e9:.4f} B parameters, "
          f"peak {peak_gib:.2f} GiB; losses {[round(v, 4) for v in history]}, the first "
          f"batch again {again:.4f}; launches {launches}  [{card}]")

    # -- one recorded step: every kernel call against its twin ------------------
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg, bsz, seq, seed=3)).items()}
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    opt = adamw.init_opt_state(params)
    with _recording(kernels) as calls:
        steps.train_step(params, opt, batch, cfg=cfg)
    recorded = _hold_recorded(label, cfg, calls)
    del calls, opt, params
    gc.collect()
    torch.cuda.empty_cache()

    # -- one step, kernel path against plain path, bf16 then fp32 ---------------
    def grads(p, c, replay=None):
        leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(), p)
        with _routing(replay) as ids:
            loss, _ = steps.loss_fn(leaves, c, batch)
            g = torch.autograd.grad(loss, adamw.tree_leaves(leaves))
        return loss.detach(), g, ids

    rel, flips = {}, {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(dtype=dtype)
        params = lm.init_params(c, seed=0, device="cuda", dtype=torch.float32)
        names = [k for k, _ in _named(params)]
        loss_k, g_k, ids = grads(params, c)
        loss_p, g_p, own = grads(params, c.replace(use_kernels=False), replay=ids)
        flips[dtype] = _flips(own, ids)
        if dtype == "bfloat16":
            norm_k = float(adamw.global_norm(dict(zip(names, g_k))))
            norm_p = float(adamw.global_norm(dict(zip(names, g_p))))
            rel["bf16"] = {
                "loss": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
                "grad_norm": abs(norm_k - norm_p) / norm_p,
                "leaves": {n: _rel(a, b) for n, a, b in zip(names, g_k, g_p)}}
            # the norm's own one-ulp sensitivity on each path
            norm_sens = 0.0
            for seed in (1, 2) if sens else ():
                for use, norm in ((True, norm_k), (False, norm_p)):
                    _, g_n, _ = grads(_nudged(params, seed), c.replace(use_kernels=use))
                    moved = float(adamw.global_norm(dict(zip(names, g_n))))
                    norm_sens = max(norm_sens, abs(moved - norm) / norm)
                    del g_n
            norm_limit = max(TRAIN_LIMITS["bf16_grad_norm"], SENS_RATIO * norm_sens)
        else:
            rel["fp32"] = {n: _rel(a, b) for n, a, b in zip(names, g_k, g_p)}
            sensitivity = {n: 0.0 for n in names}
            for seed in (1, 2) if sens else ():
                _, g_n, _ = grads(_nudged(params, seed), c.replace(use_kernels=False))
                for n, a, b in zip(names, g_n, g_p):
                    sensitivity[n] = max(sensitivity[n], _rel(a, b))
                del g_n
            limits = {n: max(TRAIN_LIMITS["fp32_grad_leaf"], SENS_RATIO * v)
                      for n, v in sensitivity.items()}
        del params, g_k, g_p, ids, own
        gc.collect()
        torch.cuda.empty_cache()
    bf16, fp32 = rel["bf16"], rel["fp32"]
    over = [f"bf16 {k} {bf16[k]} (limit {lim})"
            for k, lim in (("loss", TRAIN_LIMITS["bf16_loss"]), ("grad_norm", norm_limit))
            if bf16[k] > lim]
    over += [f"fp32 {n} {r} (limit {limits[n]})" for n, r in fp32.items() if r > limits[n]]
    worst_bf16 = max(bf16["leaves"], key=bf16["leaves"].get)
    worst_fp32 = max(fp32, key=fp32.get)
    nearest = max(fp32, key=lambda n: fp32[n] / limits[n])
    print(f"{label}, one step, kernel path vs plain path: bf16 loss rel {bf16['loss']:.4g} "
          f"(limit {TRAIN_LIMITS['bf16_loss']}), global gradient norm rel "
          f"{bf16['grad_norm']:.4g} (limit {norm_limit:.4g}"
          + (f"; its one-ulp sensitivity {norm_sens:.4g}" if sens else "") + "), per-leaf "
          f"gradient rel up to {bf16['leaves'][worst_bf16]:.4g} ({worst_bf16}, reported); "
          f"fp32 at {layers} layers: per-leaf gradient rel up to {fp32[worst_fp32]:.4g} "
          f"({worst_fp32}; limit {limits[worst_fp32]:.4g}"
          + (f"; the one-ulp sensitivity up to {max(sensitivity.values()):.4g}, nearest its "
             f"limit {nearest} at {fp32[nearest]:.4g} of {limits[nearest]:.4g}" if sens else "")
          + f"); routing decisions the plain runs would have made otherwise (replayed): "
          f"{flips}  [{card}]")
    if over:
        raise AssertionError(f"{label}: kernel vs plain over the limits: " + "; ".join(over))
    arch_s = time.perf_counter() - t_arch
    print(f"{label}: {arch_s:.2f} s  [{card}]")
    return {"layers": layers, "batch": bsz, "seq": seq, "head_dim": d, "params": n_params,
            "steps": WIDE_STEPS, "train_s": train_s, "steps_per_s": WIDE_STEPS / train_s,
            "tokens_per_s": tokens / train_s, "peak_gib": peak_gib, "history": history,
            "first_again": again, "recorded": recorded, "bf16_kernel_vs_plain": bf16,
            "fp32_kernel_vs_plain": fp32, "fp32_limits": limits,
            "sensitivity": sensitivity if sens else None,
            "bf16_grad_norm_sensitivity": norm_sens if sens else None,
            "bf16_grad_norm_limit": norm_limit, "flips": flips,
            "launches": launches, "s": arch_s}


def _dp_train_leg(card: str) -> dict:
    """granite-3-8b at full width, DP_LAYERS layers, trained data-parallel
    by DP_RANKS ranks that share the card through a gloo group (processes
    from ``torch.multiprocessing``, a file store under the ignored
    ``experiments/``), each on its rows of the training leg's global batch
    (``_dp_rank``).  Gated: (a) one fp32 step on the kernel path, ZeRO-1
    off, against the one-process step on the same masters and global batch
    (loss and every all-reduced gradient leaf at DP_LIMITS); (b) the same
    step's update with ZeRO-1, its parameters and gathered moments bit for
    bit plain DP's; (c) DP_STEPS bf16 steps of ``LMTrainJob(mesh=...)``
    with ZeRO-1: finite losses that fall (``examples/train_llm.py``'s
    condition), the first batch's loss taken again with the trained
    parameters below its loss at the init, the launch set of the training
    leg (RMSNorm and flash attention, forward and backward) and no other,
    every replica's parameters bit for bit rank 0's, and each rank's moment
    bytes half the whole moments' (within one leaf).  Reported: each
    rank's peak memory, steps/s and tokens/s of the two-rank run, and the
    time of one gradient all-reduce.  Two ranks on one card through
    host-staged gloo measure correctness, not scaling."""
    import shutil

    import torch

    sys.path.insert(0, str(ROOT / "tests"))          # the ranks' launcher, shared with the tests
    from _ranks import spawn_ranks

    label = DP_PATH
    print(f"{label}: granite-3-8b at full width, {DP_LAYERS} layers, {DP_RANKS} gloo ranks on "
          f"one card, batch {TRAIN_BATCH} x {TRAIN_SEQ} ({TRAIN_BATCH // DP_RANKS} rows a rank), "
          f"fp32 masters  [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "experiments" / "chip_smoke_dp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(_dp_rank, DP_RANKS, out_dir=out_dir, timeout_s=900)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    leg_s = time.perf_counter() - t0

    a = ranks[0]["a"]
    worst = max(a["leaves"], key=a["leaves"].get)
    print(f"{label} (a), one fp32 step on {DP_RANKS} ranks vs one process: loss rel "
          f"{a['loss']:.4g} (limit {DP_LIMITS['fp32_loss']}), all-reduced gradient leaf rel up "
          f"to {a['leaves'][worst]:.4g} ({worst}; limit {DP_LIMITS['fp32_grad_leaf']})  [{card}]")
    over = ([f"loss {a['loss']}"] if a["loss"] > DP_LIMITS["fp32_loss"] else []) + [
        f"{n} {r}" for n, r in a["leaves"].items() if r > DP_LIMITS["fp32_grad_leaf"]]
    if over:
        raise AssertionError(f"{label} (a): {DP_RANKS} ranks vs one process over the limits: "
                             + "; ".join(over))
    for r in ranks:
        if r["b_differ"] or not r["b_split"]:
            raise AssertionError(f"{label} (b), rank {r['rank']}: ZeRO-1 split {r['b_split']} "
                                 f"moment leaves; leaves not bit for bit plain DP's: "
                                 f"{r['b_differ']}")
    print(f"{label} (b): ZeRO-1's parameters and gathered moments bit for bit plain DP's on every "
          f"rank ({ranks[0]['b_split']} moment leaves split)  [{card}]")

    history, again = ranks[0]["history"], ranks[0]["first_again"]
    if not all(math.isfinite(v) for v in history) or not min(history[1:]) < history[0]:
        raise AssertionError(f"{label} (c): losses not finite and falling: {history}")
    if not again < history[0]:
        raise AssertionError(f"{label} (c): the first batch's loss with the trained parameters, "
                             f"{again}, is not below its loss at the init, {history[0]}")
    for r in ranks:
        _expect(f"{label}, rank {r['rank']}", r["launches"], TRAIN_KERNELS)
        if r["history"] != history:
            raise AssertionError(f"{label} (c): rank {r['rank']} reports {r['history']}, rank 0 "
                                 f"{history}")
        if r["replica_differ"]:
            raise AssertionError(f"{label} (c): rank {r['rank']}'s parameters differ from rank "
                                 f"0's: {r['replica_differ']}")
        half = r["whole_moment_bytes"] / DP_RANKS
        if not half <= r["moment_bytes"] <= half + r["largest_leaf_bytes"]:
            raise AssertionError(f"{label} (c): rank {r['rank']} holds {r['moment_bytes']} moment "
                                 f"bytes, not half of {r['whole_moment_bytes']}")
    train_s = ranks[0]["train_s"]
    tokens = DP_STEPS * TRAIN_BATCH * TRAIN_SEQ
    launches = {n: sum(r["launches"][n] for r in ranks) for n in META}
    print(f"{label} (c): {DP_STEPS} bf16 steps with ZeRO-1 in {train_s:.3f} s "
          f"({DP_STEPS / train_s:.4f} steps/s, {tokens / train_s:.1f} tokens/s), losses "
          f"{[round(v, 4) for v in history]}, the first batch again {again:.4f}, replicas bit for "
          f"bit rank 0's, moment bytes a rank "
          f"{ranks[0]['moment_bytes']} of {ranks[0]['whole_moment_bytes']}; one gradient "
          f"all-reduce ({ranks[0]['grad_bytes']} bytes) {ranks[0]['allreduce_s']:.3f} s; peak "
          f"memory by rank " + ", ".join(f"{r['peak_gib']:.2f} GiB" for r in ranks)
          + f"; launches (both ranks) {launches}; the whole leg {leg_s:.1f} s  [{card}]")
    return {"ranks": DP_RANKS, "layers": DP_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": DP_STEPS, "a": a, "b_split": ranks[0]["b_split"], "history": history,
            "first_again": again,
            "train_s": train_s, "steps_per_s": DP_STEPS / train_s,
            "tokens_per_s": tokens / train_s, "allreduce_s": ranks[0]["allreduce_s"],
            "grad_bytes": ranks[0]["grad_bytes"], "peak_gib": [r["peak_gib"] for r in ranks],
            "moment_bytes": [r["moment_bytes"] for r in ranks],
            "whole_moment_bytes": ranks[0]["whole_moment_bytes"], "leg_s": leg_s,
            "launches": launches}


def _dp_rank(rank: int) -> dict:
    """One rank of ``_dp_train_leg``, in its own process on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.trainjob import LMTrainJob
    from repro_torch.data.tokens import lm_batches
    from repro_torch.kernels import native
    from repro_torch.launch import shardings
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm, steps
    from repro_torch.models import sharding as msh
    from repro_torch.optim import adamw
    from repro_torch.telemetry.events import EventLog

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    mesh = make_local_mesh("cuda")
    full = registry.get_config("granite_3_8b")
    out: dict = {"rank": rank}

    # (a) one fp32 step on the kernel path, against one process on rank 0
    cfg32 = full.replace(n_layers=DP_LAYERS, dtype="float32", use_kernels=True)
    params = lm.init_params(cfg32, seed=0, device="cuda", dtype=torch.float32)
    whole = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg32, TRAIN_BATCH, TRAIN_SEQ, seed=3)).items()}
    bspecs = shardings.batch_shardings(whole, mesh)
    rows = {k: msh.local_slice(v, bspecs[k], mesh) for k, v in whole.items()}
    loss, _, grads = steps.dp_grads(params, rows, cfg=cfg32)
    copy = [g.clone() for g in adamw.tree_leaves(grads)]
    out["grad_bytes"] = sum(g.numel() * g.element_size() for g in copy)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for g in copy:
        dist.all_reduce(g)
    torch.cuda.synchronize()
    out["allreduce_s"] = time.perf_counter() - t0
    del copy
    if rank == 0:
        leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        one, _ = steps.loss_fn(leaves, cfg32, whole)
        names = [n for n, _ in _named(params)]
        want = torch.autograd.grad(one, adamw.tree_leaves(leaves))
        one = float(one.detach())
        out["a"] = {"loss": abs(float(loss) - one) / abs(one),
                    "leaves": {n: _rel(g, w) for n, g, w in
                               zip(names, adamw.tree_leaves(grads), want)}}
        del leaves, one, want
        torch.cuda.empty_cache()
    dist.barrier()

    # (b) the update from the same gradients, plain and ZeRO-1
    runs = {}
    for zero1 in (False, True):
        p = adamw.tree_map(torch.clone, params)
        mu_specs = shardings.opt_shardings(None, p, mesh, zero1=zero1)["mu"]
        with msh.use_mesh(mesh):
            opt = steps.dp_opt_state(p, mu_specs)
            steps.dp_update_(p, grads, opt, specs=mu_specs)
        runs[zero1] = (p, opt, mu_specs)
    del params, grads
    (p0, o0, _), (p1, o1, s1) = runs[False], runs[True]
    differ = [n for (n, a), b in zip(_named(p0), adamw.tree_leaves(p1)) if not torch.equal(a, b)]
    for key in ("mu", "nu"):
        differ += [f"{key}/{n}" for (n, a), b, s in zip(
            _named(o0[key]), adamw.tree_leaves(o1[key]), adamw.tree_leaves(s1))
            if not torch.equal(a, msh.gather_leaf(b, s, mesh))]
    out["b_differ"] = differ
    out["b_split"] = sum(bool(msh.splits(s, mesh)) for s in adamw.tree_leaves(s1))
    del runs, p0, o0, p1, o1
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    # (c) bf16 steps with ZeRO-1 through the entry point, launches counted
    cfg = full.replace(n_layers=DP_LAYERS, use_kernels=True, zero1=True)
    log = EventLog()
    native.reset_launches()
    res = LMTrainJob(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, n_steps=DP_STEPS, mesh=mesh,
                     log=log, device="cuda").run()
    torch.cuda.synchronize()
    out["launches"] = dict(native.LAUNCHES)
    out["history"], out["train_s"] = res["history"], log.totals()["tfjob:train"]
    first = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ)).items()}
    rows = {k: msh.local_slice(v, bspecs[k], mesh) for k, v in first.items()}
    out["first_again"] = float(steps.dp_grads(res["params"], rows, cfg=cfg)[0])
    differ = []
    for n, t in _named(res["params"]):
        first = t.clone()
        dist.broadcast(first, src=0)
        if not torch.equal(first, t):
            differ.append(n)
    out["replica_differ"] = differ
    sizes = [t.numel() * 4 for t in _leaves(res["params"])]
    out["whole_moment_bytes"], out["largest_leaf_bytes"] = 2 * sum(sizes), 2 * max(sizes)
    out["moment_bytes"] = sum(t.numel() * t.element_size() for key in ("mu", "nu")
                              for t in _leaves(res["opt_state"][key]))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _tp_train_leg(card: str) -> dict:
    """granite-3-8b at full width, TP_LAYERS layers, trained tensor-parallel
    by TP_RANKS ranks that share the card through a gloo group on a (1,
    TP_RANKS) mesh (processes from ``torch.multiprocessing``, a file store
    under the ignored ``experiments/``), each on the whole global batch and
    its shard of every parameter (``_tp_rank``).  Gated: (a) one fp32 step
    on the kernel path, the gradients gathered whole, against the
    one-process step on rank 0 (the loss and every leaf at DP_LIMITS); (b)
    TP_STEPS bf16 steps of ``LMTrainJob(mesh=...)``: the training leg's
    launch set and no other, every flash call at Hq / TP_RANKS query and
    Hkv / TP_RANKS kv heads, every whole leaf bit for bit equal on every
    rank, finite losses, and the first batch's loss taken again with the
    trained parameters below its loss at the init.  Reported: the fitted
    specs of ``embed`` and ``lm_head``, each rank's parameter and moment
    bytes against the whole, peak memory, steps/s, and one activation
    all-reduce's time.  Ranks sharing one card through host-staged gloo
    measure correctness, not scaling."""
    import shutil

    import torch

    sys.path.insert(0, str(ROOT / "tests"))          # the ranks' launcher, shared with the tests
    from _ranks import spawn_ranks
    from repro_torch.configs import registry

    label = TP_PATH
    g = registry.get_config("granite_3_8b")
    heads = (g.n_heads // TP_RANKS, g.n_kv_heads // TP_RANKS)
    print(f"{label}: granite-3-8b at full width, {TP_LAYERS} layers, {TP_RANKS} gloo ranks on "
          f"one card on a (1, {TP_RANKS}) mesh, batch {TRAIN_BATCH} x {TRAIN_SEQ} on every rank, "
          f"{heads[0]}/{heads[1]} heads a rank, fp32 masters  [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "experiments" / "chip_smoke_tp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(_tp_rank, TP_RANKS, out_dir=out_dir, timeout_s=900)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    leg_s = time.perf_counter() - t0

    first = ranks[0]
    print(f"{label}: fitted specs embed {first['specs']['embed']}, lm_head "
          f"{first['specs']['lm_head']} (vocab {g.vocab_size}); parameter bytes a rank "
          + ", ".join(str(r["param_bytes"]) for r in ranks) + f" of {first['whole_param_bytes']}, "
          "moment bytes a rank " + ", ".join(str(r["moment_bytes"]) for r in ranks)
          + f" of {2 * first['whole_param_bytes']}  [{card}]")
    a = first["a"]
    worst = max(a["leaves"], key=a["leaves"].get)
    print(f"{label} (a), one fp32 step on {TP_RANKS} ranks vs one process: loss rel "
          f"{a['loss']:.4g} (limit {DP_LIMITS['fp32_loss']}), gathered gradient leaf rel up "
          f"to {a['leaves'][worst]:.4g} ({worst}; limit {DP_LIMITS['fp32_grad_leaf']})  [{card}]")
    over = ([f"loss {a['loss']}"] if a["loss"] > DP_LIMITS["fp32_loss"] else []) + [
        f"{n} {r}" for n, r in a["leaves"].items() if r > DP_LIMITS["fp32_grad_leaf"]]
    if over:
        raise AssertionError(f"{label} (a): {TP_RANKS} ranks vs one process over the limits: "
                             + "; ".join(over))
    history, again = first["history"], first["first_again"]
    if not all(math.isfinite(v) for v in history):
        raise AssertionError(f"{label} (b): losses not finite: {history}")
    if not again < history[0]:
        raise AssertionError(f"{label} (b): the first batch's loss with the trained parameters, "
                             f"{again}, is not below its loss at the init, {history[0]}")
    for r in ranks:
        _expect(f"{label}, rank {r['rank']}", r["launches"], TRAIN_KERNELS)
        if r["history"] != history:
            raise AssertionError(f"{label} (b): rank {r['rank']} reports {r['history']}, rank 0 "
                                 f"{history}")
        if r["whole_differ"]:
            raise AssertionError(f"{label} (b): rank {r['rank']}'s whole leaves differ from rank "
                                 f"0's: {r['whole_differ']}")
        if set(r["flash_heads"]) != {heads}:
            raise AssertionError(f"{label} (b): rank {r['rank']}'s flash calls at (query, kv) "
                                 f"heads {sorted(set(r['flash_heads']))}, not {heads}")
        if not r["whole_param_bytes"] / TP_RANKS <= r["param_bytes"] < \
                r["whole_param_bytes"] / TP_RANKS * 1.01:
            raise AssertionError(f"{label}: rank {r['rank']} holds {r['param_bytes']} parameter "
                                 f"bytes, not 1/{TP_RANKS} of {r['whole_param_bytes']}")
    train_s = first["train_s"]
    tokens = TP_STEPS * TRAIN_BATCH * TRAIN_SEQ
    launches = {n: sum(r["launches"][n] for r in ranks) for n in META}
    print(f"{label} (b): {TP_STEPS} bf16 steps in {train_s:.3f} s ({TP_STEPS / train_s:.4f} "
          f"steps/s, {tokens / train_s:.1f} tokens/s), losses {[round(v, 4) for v in history]}, "
          f"the first batch again {again:.4f}, {first['whole_leaves']} whole leaves bit for bit on "
          f"every rank, {len(first['flash_heads'])} flash calls a rank at {heads[0]}/{heads[1]} "
          f"heads; one activation all-reduce ({first['act_bytes']} bytes) "
          f"{first['allreduce_s']:.4f} s; peak memory by rank "
          + ", ".join(f"{r['peak_gib']:.2f} GiB" for r in ranks)
          + f"; launches (both ranks) {launches}; the whole leg {leg_s:.1f} s  [{card}]")
    return {"ranks": TP_RANKS, "layers": TP_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TP_STEPS, "specs": first["specs"], "a": a, "history": history,
            "first_again": again, "train_s": train_s, "steps_per_s": TP_STEPS / train_s,
            "tokens_per_s": tokens / train_s, "allreduce_s": first["allreduce_s"],
            "act_bytes": first["act_bytes"], "peak_gib": [r["peak_gib"] for r in ranks],
            "param_bytes": [r["param_bytes"] for r in ranks],
            "moment_bytes": [r["moment_bytes"] for r in ranks],
            "whole_param_bytes": first["whole_param_bytes"], "leg_s": leg_s,
            "launches": launches}


def _tp_rank(rank: int) -> dict:
    """One rank of ``_tp_train_leg``, in its own process on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.trainjob import LMTrainJob
    from repro_torch.data.tokens import lm_batches
    from repro_torch.kernels import native, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, steps
    from repro_torch.models import sharding as msh
    from repro_torch.optim import adamw
    from repro_torch.telemetry.events import EventLog

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((1, TP_RANKS), ("data", "model"), "cuda")
    full = registry.get_config("granite_3_8b")
    out: dict = {"rank": rank}

    # (a) one fp32 step on the kernel path, the gradients gathered whole,
    # against one process on rank 0
    cfg32 = full.replace(n_layers=TP_LAYERS, dtype="float32", use_kernels=True)
    params = lm.init_params(cfg32, seed=0, device="cuda", dtype=torch.float32)
    whole = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg32, TRAIN_BATCH, TRAIN_SEQ, seed=3)).items()}
    with msh.use_mesh(mesh):
        pspecs = msh.param_shardings(params, mesh)
        out["specs"] = {k: str(s) for k, s in pspecs.items() if k in ("embed", "lm_head")}
        local = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params, pspecs)
        loss, _, grads = steps.dp_grads(local, whole, cfg=cfg32)
        del local
        grads = adamw.tree_map(lambda t, s: msh.gather_leaf(t, s, mesh), grads, pspecs)
        act = torch.randn((TRAIN_BATCH, TRAIN_SEQ, full.d_model), device="cuda",
                          dtype=torch.bfloat16)
        out["act_bytes"] = act.numel() * act.element_size()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(act, group=msh.model_group())
        torch.cuda.synchronize()
        out["allreduce_s"] = time.perf_counter() - t0
        del act
    if rank == 0:
        leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        one, _ = steps.loss_fn(leaves, cfg32, whole)
        names = [n for n, _ in _named(params)]
        want = torch.autograd.grad(one, adamw.tree_leaves(leaves))
        one = float(one.detach())
        out["a"] = {"loss": abs(float(loss) - one) / abs(one),
                    "leaves": {n: _rel(g, w) for n, g, w in
                               zip(names, adamw.tree_leaves(grads), want)}}
        del leaves, want
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    # (b) bf16 steps through the entry point, launches and flash heads counted
    cfg = full.replace(n_layers=TP_LAYERS, use_kernels=True)
    heads = []
    kernel = ops._flash_kernel

    def spy(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return kernel(q, k, v, **kw)

    log = EventLog()
    native.reset_launches()
    ops._flash_kernel = spy
    try:
        res = LMTrainJob(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, n_steps=TP_STEPS,
                         mesh=mesh, log=log, device="cuda").run()
    finally:
        ops._flash_kernel = kernel
    torch.cuda.synchronize()
    out["launches"] = dict(native.LAUNCHES)
    out["flash_heads"] = heads
    out["history"], out["train_s"] = res["history"], log.totals()["tfjob:train"]
    first = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ)).items()}
    with msh.use_mesh(mesh):
        out["first_again"] = float(steps.dp_grads(res["params"], first, cfg=cfg)[0])
        pspecs = msh.param_shardings(lm.init_params(cfg, device="meta", dtype=torch.float32),
                                     mesh)
    differ, n_whole = [], 0
    for (n, t), s in zip(_named(res["params"]), adamw.tree_leaves(pspecs)):
        if msh.splits(s, mesh):
            continue
        n_whole += 1
        ref = t.clone()
        dist.broadcast(ref, src=0)
        if not torch.equal(ref, t):
            differ.append(n)
    out["whole_differ"], out["whole_leaves"] = differ, n_whole
    out["param_bytes"] = sum(t.numel() * t.element_size() for t in _leaves(res["params"]))
    out["whole_param_bytes"] = sum(
        t.numel() * 4 for t in _leaves(lm.init_params(cfg, device="meta", dtype=torch.float32)))
    out["moment_bytes"] = sum(t.numel() * t.element_size() for key in ("mu", "nu")
                              for t in _leaves(res["opt_state"][key]))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _tp_moe_leg(card: str) -> dict:
    """The MoE archs at full width, TP_LAYERS layers, trained
    tensor-parallel by TP_RANKS ranks sharing the card through a gloo group
    on a (1, TP_RANKS) mesh, each on the whole global batch and its shard
    of every parameter (``_tp_moe_rank``): granite-moe on the kernel path,
    gates (a) and (b) of ``_tp_train_leg``, with every MoE routing's expert
    ids equal on both ranks, 20 of 40 experts a rank and every flash call
    at 12/4 heads; deepseek on the kernel path, gate (a), with its MLA
    flash calls at D 192 forward and backward, every one at 8/8 heads and
    the launch set TRAIN_KERNELS on each rank.  Gate (a)
    runs the one process on the split run's expert ids (``_routing``): a
    near tie that the split run's summation order decides otherwise would
    move a token's whole gate; the decisions it would have made otherwise
    are counted and printed.  Ranks sharing one card through host-staged
    gloo measure correctness, not scaling."""
    import shutil

    import torch

    sys.path.insert(0, str(ROOT / "tests"))          # the ranks' launcher, shared with the tests
    from _ranks import spawn_ranks
    from repro_torch.configs import registry

    gm = registry.get_config("granite_moe_3b_a800m")
    ds = registry.get_config("deepseek_v2_lite_16b")
    heads = (gm.n_heads // TP_RANKS, gm.n_kv_heads // TP_RANKS)
    experts = gm.n_experts // TP_RANKS
    print(f"{TP_MOE_PATH}: granite-moe at full width (d {gm.d_model}, {gm.n_experts} experts top "
          f"{gm.top_k}, expert width {gm.moe_d_ff}), {TP_LAYERS} layers, and {TP_MLA_PATH}: "
          f"deepseek at full width (MLA, {ds.n_experts} experts top {ds.top_k} + "
          f"{ds.n_shared_experts} shared), {TP_LAYERS} layers (the dense MLA layer and one MoE "
          f"layer); {TP_RANKS} gloo ranks on one card on a (1, {TP_RANKS}) mesh, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} on every rank, fp32 masters  [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "experiments" / "chip_smoke_tp_moe"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(_tp_moe_rank, TP_RANKS, out_dir=out_dir, timeout_s=900)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    leg_s = time.perf_counter() - t0

    first = ranks[0]
    for label, key in ((TP_MOE_PATH, "granite_moe_a"), (TP_MLA_PATH, "deepseek_a")):
        a = first[key]
        worst = max(a["leaves"], key=a["leaves"].get)
        print(f"{label} (a), one fp32 step on {TP_RANKS} ranks vs one process: loss rel "
              f"{a['loss']:.4g} (limit {DP_LIMITS['fp32_loss']}), gathered gradient leaf rel up "
              f"to {a['leaves'][worst]:.4g} ({worst}; limit {DP_LIMITS['fp32_grad_leaf']}); "
              f"routing decisions the one process would have made otherwise (replayed): "
              f"{a['flips']}  [{card}]")
        over = ([f"loss {a['loss']}"] if a["loss"] > DP_LIMITS["fp32_loss"] else []) + [
            f"{n} {r}" for n, r in a["leaves"].items() if r > DP_LIMITS["fp32_grad_leaf"]]
        if over:
            raise AssertionError(f"{label} (a): {TP_RANKS} ranks vs one process over the "
                                 "limits: " + "; ".join(over))
    mla_heads = (ds.n_heads // TP_RANKS, ds.n_kv_heads // TP_RANKS)
    for r in ranks:
        _expect(f"{TP_MLA_PATH} (a), rank {r['rank']}", r["deepseek_launches"], TRAIN_KERNELS)
        if set(r["deepseek_flash_heads"]) != {mla_heads}:
            raise AssertionError(f"{TP_MLA_PATH} (a): rank {r['rank']}'s flash calls at (query, "
                                 f"kv) heads {sorted(set(r['deepseek_flash_heads']))}, not "
                                 f"{mla_heads}")
    print(f"{TP_MLA_PATH} (a): the kernel path, MLA's flash forward and backward at D "
          f"{ds.qk_nope_dim + ds.qk_rope_dim}, {len(first['deepseek_flash_heads'])} flash calls "
          f"a rank at {mla_heads[0]}/{mla_heads[1]} heads; launches by rank "
          + ", ".join(str(r["deepseek_launches"]) for r in ranks) + f"  [{card}]")

    label = TP_MOE_PATH
    history, again = first["history"], first["first_again"]
    if not all(math.isfinite(v) for v in history):
        raise AssertionError(f"{label} (b): losses not finite: {history}")
    if not again < history[0]:
        raise AssertionError(f"{label} (b): the first batch's loss with the trained parameters, "
                             f"{again}, is not below its loss at the init, {history[0]}")
    for r in ranks:
        _expect(f"{label}, rank {r['rank']}", r["launches"], TRAIN_KERNELS)
        if r["history"] != history:
            raise AssertionError(f"{label} (b): rank {r['rank']} reports {r['history']}, rank 0 "
                                 f"{history}")
        if r["whole_differ"]:
            raise AssertionError(f"{label} (b): rank {r['rank']}'s whole leaves differ from rank "
                                 f"0's: {r['whole_differ']}")
        if set(r["flash_heads"]) != {heads}:
            raise AssertionError(f"{label} (b): rank {r['rank']}'s flash calls at (query, kv) "
                                 f"heads {sorted(set(r['flash_heads']))}, not {heads}")
        if set(r["local_experts"].values()) != {experts}:
            raise AssertionError(f"{label} (b): rank {r['rank']} holds {r['local_experts']} "
                                 f"experts a leaf, not {experts}")
        if len(r["route_ids"]) != len(first["route_ids"]) or not all(
                torch.equal(a, b) for a, b in zip(r["route_ids"], first["route_ids"])):
            raise AssertionError(f"{label} (b): rank {r['rank']} routes otherwise than rank 0")
        if not r["whole_param_bytes"] / TP_RANKS <= r["param_bytes"] < \
                r["whole_param_bytes"] / TP_RANKS * 1.01:
            raise AssertionError(f"{label}: rank {r['rank']} holds {r['param_bytes']} parameter "
                                 f"bytes, not 1/{TP_RANKS} of {r['whole_param_bytes']}")
    train_s = first["train_s"]
    tokens = TP_STEPS * TRAIN_BATCH * TRAIN_SEQ
    launches = {n: sum(r["launches"][n] for r in ranks) for n in META}
    moe = first["moe_layer"]
    print(f"{label}: fitted specs " + ", ".join(f"{k} {v}" for k, v in first["specs"].items())
          + "; parameter bytes a rank " + ", ".join(str(r["param_bytes"]) for r in ranks)
          + f" of {first['whole_param_bytes']}, moment bytes a rank "
          + ", ".join(str(r["moment_bytes"]) for r in ranks)
          + f" of {2 * first['whole_param_bytes']}  [{card}]")
    print(f"{label}: one MoE layer's forward and backward at {TRAIN_BATCH} x {TRAIN_SEQ} (bf16) "
          f"moves {moe['bytes']} bytes through {moe['collectives']} ({moe['calls']}); one "
          f"all-reduce of {moe['reduce_bytes']} bytes {moe['reduce_s']:.4f} s  [{card}]")
    print(f"{label} (b): {TP_STEPS} bf16 steps in {train_s:.3f} s ({TP_STEPS / train_s:.4f} "
          f"steps/s, {tokens / train_s:.1f} tokens/s), losses {[round(v, 4) for v in history]}, "
          f"the first batch again {again:.4f}, {first['whole_leaves']} whole leaves bit for bit on "
          f"every rank, {len(first['route_ids'])} routings equal on every rank, "
          f"{len(first['flash_heads'])} flash calls a rank at {heads[0]}/{heads[1]} heads, "
          f"{experts} experts a rank; peak memory by rank "
          + ", ".join(f"{r['peak_gib']:.2f} GiB" for r in ranks)
          + f"; launches (both ranks) {launches}; the whole leg {leg_s:.1f} s  [{card}]")
    return {"ranks": TP_RANKS, "layers": TP_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TP_STEPS, "specs": first["specs"], "granite_moe_a": first["granite_moe_a"],
            "deepseek_a": first["deepseek_a"],
            "deepseek_launches": [r["deepseek_launches"] for r in ranks], "history": history,
            "first_again": again, "train_s": train_s, "steps_per_s": TP_STEPS / train_s,
            "tokens_per_s": tokens / train_s, "moe_layer": moe,
            "recorded": [r["recorded"] for r in ranks], "peak_gib": [r["peak_gib"] for r in ranks],
            "param_bytes": [r["param_bytes"] for r in ranks],
            "moment_bytes": [r["moment_bytes"] for r in ranks],
            "whole_param_bytes": first["whole_param_bytes"], "leg_s": leg_s,
            "launches": launches}


def _tp_parity(rank: int, mesh, cfg32, params: dict, flash_spy=None) -> dict | None:
    """Gate (a) of the tensor-parallel legs on a MoE arch: one fp32 step of
    ``steps.dp_grads`` on this rank's shards of ``params`` and the whole
    batch, the gradients gathered whole, against one process on rank 0 run
    on the split run's expert ids.  ``flash_spy``, where given, stands for
    ``ops._flash_kernel`` in the split run.  Returns rank 0's rel errors
    (None on the others)."""
    import torch
    from repro_torch.data.tokens import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.models import sharding as msh
    from repro_torch.models import steps
    from repro_torch.optim import adamw

    whole = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg32, TRAIN_BATCH, TRAIN_SEQ, seed=3)).items()}
    with msh.use_mesh(mesh):
        pspecs = msh.param_shardings(params, mesh)
        local = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params, pspecs)
        kernel = ops._flash_kernel
        ops._flash_kernel = flash_spy or kernel
        try:
            with _routing() as ids:
                loss, _, grads = steps.dp_grads(local, whole, cfg=cfg32)
        finally:
            ops._flash_kernel = kernel
        del local
        grads = adamw.tree_map(lambda t, s: msh.gather_leaf(t, s, mesh), grads, pspecs)
    out = None
    if rank == 0:
        leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        with _routing(replay=ids) as own:
            one, _ = steps.loss_fn(leaves, cfg32, whole)
        want = torch.autograd.grad(one, adamw.tree_leaves(leaves))
        one = float(one.detach())
        out = {"loss": abs(float(loss) - one) / abs(one), "flips": _flips(own, ids),
               "leaves": {n: _rel(g, w) for (n, _), g, w in
                          zip(_named(params), adamw.tree_leaves(grads), want)}}
        del leaves, want
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _collective_bytes(fn, out: dict | None = None) -> tuple[int, dict]:
    """(bytes, {collective: calls}) of every all-reduce and all-gather
    ``fn`` runs, forward and backward (``torch.distributed`` wrapped): the
    bytes each call sends (an all-gather its own block).  ``out``, when
    given, gathers the same calls in ``launch/count.py``'s convention, each
    call's output buffer bytes by kind ({"all-reduce": [calls, bytes],
    ...}: an all-gather counts its whole output)."""
    import torch.distributed as dist
    seen, calls = [0], {}
    saved = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

    def counting(name):
        def call(t, *args, **kw):
            x = args[0] if name == "all_gather" else t
            seen[0] += x.numel() * x.element_size()
            calls[name] = calls.get(name, 0) + 1
            if out is not None:
                rec = out.setdefault(name.replace("_", "-"), [0, 0])
                rec[0] += 1
                rec[1] += sum(y.numel() * y.element_size()
                              for y in (t if name == "all_gather" else (t,)))
            return saved[name](t, *args, **kw)
        return call

    for n in saved:
        setattr(dist, n, counting(n))
    try:
        fn()
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
    return seen[0], calls


def _tp_moe_rank(rank: int) -> dict:
    """One rank of ``_tp_moe_leg``, in its own process on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.core.trainjob import LMTrainJob
    from repro_torch.data.tokens import lm_batches
    from repro_torch.kernels import native, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, moe, steps
    from repro_torch.models import sharding as msh
    from repro_torch.optim import adamw
    from repro_torch.telemetry.events import EventLog

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((1, TP_RANKS), ("data", "model"), "cuda")
    gm = registry.get_config("granite_moe_3b_a800m")
    out: dict = {"rank": rank}

    # granite-moe (a): one fp32 step on the kernel path against one process
    cfg32 = gm.replace(n_layers=TP_LAYERS, dtype="float32", use_kernels=True)
    params = lm.init_params(cfg32, seed=0, device="cuda", dtype=torch.float32)
    out["granite_moe_a"] = _tp_parity(rank, mesh, cfg32, params)
    del params
    dist.barrier()

    # one MoE layer at the leg's shape in bf16: the bytes its collectives
    # move, forward and backward, and one all-reduce of its (B, S, D) output
    cfg = gm.replace(n_layers=TP_LAYERS, use_kernels=True)
    with msh.use_mesh(mesh):
        whole = lm.init_params(cfg.replace(n_layers=1), seed=0, device="cuda",
                               dtype=torch.bfloat16)["phase0"]["slot0"]["ffn"]
        layer = {k: msh.local_slice(t[0], msh.param_shardings({k: t[0]}, mesh)[k], mesh)
                 for k, t in whole.items()}
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, gm.d_model), device="cuda",
                        dtype=torch.bfloat16, generator=gen).requires_grad_()

        def layer_step():
            y, aux = moe.moe_forward(layer, x, cfg)
            (y.float().square().mean() + aux).backward()
        nbytes, calls = _collective_bytes(layer_step)
        act = torch.randn((TRAIN_BATCH, TRAIN_SEQ, gm.d_model), device="cuda",
                          dtype=torch.bfloat16, generator=gen)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(act, group=msh.model_group())
        torch.cuda.synchronize()
        out["moe_layer"] = {"bytes": nbytes, "calls": calls, "collectives": sum(calls.values()),
                            "reduce_bytes": act.numel() * act.element_size(),
                            "reduce_s": time.perf_counter() - t0}
        del whole, layer, x, act
    dist.barrier()

    # granite-moe (b): bf16 steps through the entry point, launches, flash
    # heads and expert ids recorded
    heads = []
    kernel = ops._flash_kernel

    def spy(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return kernel(q, k, v, **kw)

    log = EventLog()
    native.reset_launches()
    ops._flash_kernel = spy
    try:
        with _routing() as ids:
            res = LMTrainJob(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, n_steps=TP_STEPS,
                             mesh=mesh, log=log, device="cuda").run()
    finally:
        ops._flash_kernel = kernel
    torch.cuda.synchronize()
    out["launches"] = dict(native.LAUNCHES)
    out["flash_heads"] = heads
    out["route_ids"] = [t.cpu() for t in ids]
    out["history"], out["train_s"] = res["history"], log.totals()["tfjob:train"]
    first = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ)).items()}
    meta = lm.init_params(cfg, device="meta", dtype=torch.float32)
    with msh.use_mesh(mesh):
        out["first_again"] = float(steps.dp_grads(res["params"], first, cfg=cfg)[0])
        pspecs = msh.param_shardings(meta, mesh)
        # every kernel call of one recorded step against its twin
        with _recording(TRAIN_KERNELS) as calls:
            steps.dp_grads(res["params"], first, cfg=cfg)
        out["recorded"] = _hold_recorded(f"{TP_MOE_PATH}, rank {rank}", cfg, calls)
        del calls
    out["specs"] = {n: str(s) for n, s in _named(pspecs)
                    if n.startswith("phase0/slot0/ffn/")}
    out["local_experts"] = {n: t.shape[1] for n, t in _named(res["params"])
                            if n.rsplit("/", 1)[-1].startswith("experts_")}
    differ, n_whole = [], 0
    for (n, t), s in zip(_named(res["params"]), adamw.tree_leaves(pspecs)):
        if msh.splits(s, mesh):
            continue
        n_whole += 1
        ref = t.clone()
        dist.broadcast(ref, src=0)
        if not torch.equal(ref, t):
            differ.append(n)
    out["whole_differ"], out["whole_leaves"] = differ, n_whole
    out["param_bytes"] = sum(t.numel() * t.element_size() for t in _leaves(res["params"]))
    out["whole_param_bytes"] = sum(t.numel() * 4 for t in _leaves(meta))
    out["moment_bytes"] = sum(t.numel() * t.element_size() for key in ("mu", "nu")
                              for t in _leaves(res["opt_state"][key]))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del res, first
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()

    # deepseek (a) on the kernel path: MLA's flash forward and backward at
    # D 192 on the rank's heads (the flash calls' heads recorded)
    ds = registry.get_config("deepseek_v2_lite_16b").replace(n_layers=TP_LAYERS,
                                                             dtype="float32", use_kernels=True)
    params = lm.init_params(ds, seed=0, device="cuda", dtype=torch.float32)
    heads = []
    native.reset_launches()
    out["deepseek_a"] = _tp_parity(rank, mesh, ds, params, flash_spy=spy)
    torch.cuda.synchronize()
    out["deepseek_flash_heads"] = heads[:]
    out["deepseek_launches"] = dict(native.LAUNCHES)
    out["peak_gib"] = max(out["peak_gib"], torch.cuda.max_memory_allocated() / 2**30)
    return out


def _tp_serve_leg(card: str) -> dict:
    """Tensor-parallel serving: TP_RANKS ranks share the card through a gloo
    group on a (1, TP_RANKS) mesh (``_tp_serve_rank``), each on its shards
    of every parameter and its block of the cache, and serve batch BATCH x
    PROMPT, GEN new tokens, through ``steps.prefill``, ``steps.serve_step``
    and ``greedy_decode_loop``, for granite and granite-moe at full width.
    Gated: (a) fp32 at TP_SERVE_LAYERS layers on the kernel path, every
    rank's prefill logits and all GEN decode steps' logits (greedy) against
    one process on rank 0 within TP_SERVE_REL, the tokens equal (granite-moe:
    the one process replays rank 0's expert ids); (b) bf16 at full depth:
    the launch set TP_SERVE_KERNELS on each rank and no other, every
    decode-attention call at Hq / TP_RANKS query over Hkv / TP_RANKS kv
    heads, every recorded kernel call of one prefill and one decode step
    under the phase-2 rule, a rank's cache bytes 1 / TP_RANKS of the one
    process's; (c) the collective bytes of one bf16 decode step, counted on
    the card by wrapping ``torch.distributed`` (``_collective_bytes``) in
    ``launch/count.py``'s convention, equal by kind to what
    ``launch/dryrun.py``'s counting mesh counts for the same step, config
    and mesh.  Reported: token agreement with one process in bf16, each
    rank's prefill ms and decode ms a token, peak memory and cache bytes.
    Ranks sharing one card through host-staged gloo measure correctness,
    not scaling."""
    import shutil

    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding as msh

    sys.path.insert(0, str(ROOT / "tests"))          # the ranks' launcher, shared with the tests
    from _ranks import spawn_ranks

    label = TP_SERVE_PATH
    cache_len = PROMPT + GEN + 1
    print(f"{label}: {', '.join(TP_SERVE_ARCHS)} at full width, {TP_RANKS} gloo ranks on one card "
          f"on a (1, {TP_RANKS}) mesh, batch {BATCH} x {PROMPT}, {GEN} new tokens; fp32 at "
          f"{TP_SERVE_LAYERS} layers, bf16 at full depth  [{card}]")
    # (c)'s yardstick: the counting mesh's count of the same bf16 decode step
    counted = {}
    for arch in TP_SERVE_ARCHS:
        cfg = registry.get_config(arch)
        shape = InputShape("tp_serve_decode", cache_len, BATCH, "decode")
        with dryrun.counting_mesh((1, TP_RANKS), ("data", "model")) as mesh, \
                msh.use_mesh(mesh):
            coll = dryrun.count_step(dryrun._shape_cfg(cfg, shape), shape)["collectives"]
        counted[arch] = {k: [c["calls"], c["bytes"]] for k, c in coll.items()}
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "experiments" / "chip_smoke_tp_serve"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(_tp_serve_rank, TP_RANKS, out_dir=out_dir, timeout_s=900)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    leg_s = time.perf_counter() - t0

    res = {}
    for arch in TP_SERVE_ARCHS:
        cfg = registry.get_config(arch)
        heads = (cfg.n_heads // TP_RANKS, cfg.n_kv_heads // TP_RANKS)
        one = ranks[0][arch]["one"]
        # (a) fp32: every rank against one process
        a = {}
        for r in ranks:
            got = r[arch]["a"]
            rel = {"prefill": _rel(got["logits"][0], one["logits"][0]),
                   "decode": max(_rel(g, w) for g, w in zip(got["logits"][1:],
                                                            one["logits"][1:]))}
            a[r["rank"]] = {**rel, "tokens_equal": torch.equal(got["tokens"], one["tokens"])}
            print(f"{label} {arch} (a), fp32 at {TP_SERVE_LAYERS} layers, rank {r['rank']} vs one "
                  f"process: prefill logits rel {rel['prefill']:.4g}, {GEN} decode steps' logits "
                  f"rel up to {rel['decode']:.4g} (limit {TP_SERVE_REL}), tokens equal "
                  f"{a[r['rank']]['tokens_equal']}; routing decisions the one process would have "
                  f"made otherwise (replayed): {one['flips']}  [{card}]")
            if max(rel.values()) > TP_SERVE_REL or not a[r["rank"]]["tokens_equal"]:
                raise AssertionError(f"{label} {arch} (a): rank {r['rank']} vs one process: "
                                     f"{a[r['rank']]} (limit {TP_SERVE_REL})")
        # (b) bf16 at full depth
        b = {}
        whole_cache = ranks[0][arch]["b"]["whole_cache_bytes"]
        for r in ranks:
            got = r[arch]["b"]
            _expect(f"{label} {arch}, rank {r['rank']}", got["launches"], TP_SERVE_KERNELS)
            if set(got["decode_heads"]) != {heads}:
                raise AssertionError(f"{label} {arch} (b): rank {r['rank']}'s decode attention at "
                                     f"(query, kv) heads {sorted(set(got['decode_heads']))}, "
                                     f"not {heads}")
            if got["cache_bytes"] * TP_RANKS != whole_cache:
                raise AssertionError(f"{label} {arch} (b): rank {r['rank']} holds "
                                     f"{got['cache_bytes']} cache bytes, not 1/{TP_RANKS} of "
                                     f"{whole_cache}")
            b[r["rank"]] = {k: got[k] for k in ("prefill_ms", "decode_ms_per_token", "peak_gib",
                                                "cache_bytes", "recorded")}
        agree = float((ranks[0][arch]["b"]["tokens"] == one["bf16_tokens"]).float().mean())
        print(f"{label} {arch} (b), bf16 at {cfg.n_layers} layers: launch set "
              f"{sorted(TP_SERVE_KERNELS)} on every rank, "
              f"{len(ranks[0][arch]['b']['decode_heads'])} decode-attention calls a rank at "
              f"{heads[0]}/{heads[1]} heads; cache bytes a rank "
              + ", ".join(str(v["cache_bytes"]) for v in b.values()) + f" of {whole_cache}; "
              + "; ".join(f"rank {k}: prefill {v['prefill_ms']:.2f} ms, decode "
                          f"{v['decode_ms_per_token']:.2f} ms/token, peak {v['peak_gib']:.2f} GiB"
                          for k, v in b.items())
              + f"; token agreement with one process {agree:.4f} (reported)  [{card}]")
        # (c) the card's collective bytes of one decode step against the count
        for r in ranks:
            got = r[arch]["c"]
            if got != counted[arch]:
                raise AssertionError(f"{label} {arch} (c): rank {r['rank']}'s collectives of one "
                                     f"decode step {got}, the counting mesh's {counted[arch]}")
        print(f"{label} {arch} (c): one bf16 decode step's collectives on the card "
              f"{ranks[0][arch]['c']} (calls, output bytes) equal the counting mesh's  [{card}]")
        res[arch] = {"a": a, "b": b, "c": counted[arch], "bf16_token_agreement": agree,
                     "whole_cache_bytes": whole_cache,
                     "one_process": {k: one[k] for k in ("prefill_ms", "decode_ms_per_token",
                                                         "flips")}}
    launches = {n: sum(r["launches"][n] for r in ranks) for n in META}
    print(f"{label}: launches (both ranks, bf16 runs) {launches}; the whole leg {leg_s:.1f} s  "
          f"[{card}]")
    return {"ranks": TP_RANKS, "archs": res, "leg_s": leg_s, "launches": launches}


def _shards(params: dict, mesh) -> dict:
    """This rank's block of every leaf under its fitted spec, a copy."""
    from repro_torch.models import sharding as msh
    from repro_torch.optim import adamw
    specs = msh.param_shardings(params, mesh)
    return adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params, specs)


def _nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _tp_serve_run(params, cfg, prompts, cache_len: int, **stubs) -> dict:
    """Prefill (the family's ``stubs``, such as whisper's frames, beside the
    tokens), then GEN greedy steps through ``steps.serve_step``, every
    step's logits kept (fp32 on the host)."""
    import torch
    from repro_torch.models import steps
    last, cache = steps.prefill(params, {"tokens": prompts, **stubs}, cfg=cfg,
                                cache_len=cache_len)
    logits, toks = [last.float().cpu()], []
    tok = torch.argmax(last, -1).to(torch.int32)[:, None]
    pos = steps.start_positions(cfg, prompts.shape[0], prompts.shape[1], "cuda")
    for t in range(GEN):
        toks.append(tok)
        step, cache = steps.serve_step(params, cache, tok, pos + t, cfg=cfg)
        logits.append(step.float().cpu())
        tok = torch.argmax(step, -1).to(torch.int32)[:, None]
    return {"logits": logits, "tokens": torch.cat(toks, 1).cpu()}


def _tp_serve_rank(rank: int) -> dict:
    """One rank of ``_tp_serve_leg``, in its own process on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.kernels import native, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, steps
    from repro_torch.models import sharding as msh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((1, TP_RANKS), ("data", "model"), "cuda")
    cache_len = PROMPT + GEN + 1
    out: dict = {"rank": rank, "launches": {n: 0 for n in META}}

    for arch in TP_SERVE_ARCHS:
        full = registry.get_config(arch)
        prompts = _prompts(full, PROMPT).cuda()
        res: dict = {}
        # (a) fp32 at TP_SERVE_LAYERS layers: the split run, then (rank 0)
        # one process replaying its expert ids
        cfg32 = full.replace(n_layers=TP_SERVE_LAYERS, dtype="float32", use_kernels=True)
        params = lm.init_params(cfg32, seed=0, device="cuda")
        local = _shards(params, mesh)
        with torch.inference_mode(), msh.use_mesh(mesh), _routing() as ids:
            res["a"] = _tp_serve_run(local, cfg32, prompts, cache_len)
        del local
        if rank == 0:
            with torch.inference_mode(), _routing(replay=ids) as own:
                one = _tp_serve_run(params, cfg32, prompts, cache_len)
            one["flips"] = _flips(own, ids) if full.n_experts else None
        del params, ids
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()

        # (b) bf16 at full depth: timed, launches and decode-attention heads
        # counted, one prefill and one decode step recorded
        cfg = full.replace(use_kernels=True, dtype="bfloat16")
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(cfg, seed=0, device="cuda")
        local = _shards(params, mesh)
        if rank != 0:
            del params
        gc.collect()
        torch.cuda.empty_cache()
        heads, kernel = [], ops._decode_kernel

        def spy(q, k, v, *args, **kw):
            heads.append((q.shape[1], k.shape[2]))
            return kernel(q, k, v, *args, **kw)

        b: dict = {}
        start = steps.start_positions(cfg, BATCH, PROMPT, "cuda")
        with torch.inference_mode(), msh.use_mesh(mesh):
            native.reset_launches()
            ops._decode_kernel = spy
            try:
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                last, cache = steps.prefill(local, {"tokens": prompts}, cfg=cfg,
                                            cache_len=cache_len)
                torch.cuda.synchronize()
                b["prefill_ms"] = (time.perf_counter() - t0) * 1e3
                first = torch.argmax(last, -1).to(torch.int32)[:, None]
                b["cache_bytes"] = _nbytes(cache)
                t0 = time.perf_counter()
                b["tokens"], cache = steps.greedy_decode_loop(local, cache, first, start, GEN,
                                                              cfg=cfg)
                torch.cuda.synchronize()
                b["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / GEN
            finally:
                ops._decode_kernel = kernel
            b["launches"] = dict(native.LAUNCHES)
            b["decode_heads"] = heads
            b["tokens"] = b["tokens"].cpu()
            b["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            for n, c in b["launches"].items():
                out["launches"][n] += c
            del cache
            # every kernel call of one prefill and one decode step against its twin
            with _recording(TP_SERVE_KERNELS) as calls:
                _, cache = steps.prefill(local, {"tokens": prompts}, cfg=cfg, cache_len=cache_len)
                steps.serve_step(local, cache, first, start, cfg=cfg)
            b["recorded"] = _hold_recorded(f"{TP_SERVE_PATH} {arch}, rank {rank}", cfg, calls)
            del calls, cache
            # (c) the collectives of one decode step, in the count's convention
            _, cache = steps.prefill(local, {"tokens": prompts}, cfg=cfg, cache_len=cache_len)
            coll: dict = {}
            _collective_bytes(lambda: steps.serve_step(local, cache, first, start, cfg=cfg), coll)
            res["c"] = coll
            del cache
        b["whole_cache_bytes"] = _nbytes(lm.init_cache(cfg, BATCH, cache_len, device="meta"))
        res["b"] = b
        del local
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:                       # one process in bf16: its tokens, its times
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                last, cache = steps.prefill(params, {"tokens": prompts}, cfg=cfg,
                                            cache_len=cache_len)
                torch.cuda.synchronize()
                one["prefill_ms"] = (time.perf_counter() - t0) * 1e3
                first = torch.argmax(last, -1).to(torch.int32)[:, None]
                t0 = time.perf_counter()
                toks, _ = steps.greedy_decode_loop(params, cache, first, start, GEN, cfg=cfg)
                torch.cuda.synchronize()
                one["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / GEN
                one["bf16_tokens"] = toks.cpu()
            res["one"] = one
            del params, cache
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        out[arch] = res
    return out



def _tp_ssm_leg(card: str) -> dict:
    """Tensor parallelism of the recurrent mixers: TP_RANKS ranks share the
    card through a gloo group on a (1, TP_RANKS) mesh (``_tp_ssm_rank``),
    each on its shards of every parameter and its block of every state,
    for zamba2 and xlstm at full width.  Gated: (a) fp32 on the kernel path
    at TP_SSM_LAYERS layers, every rank's prefill logits and GEN greedy
    decode steps' logits against one process on rank 0 within
    TP_SERVE_REL, the tokens equal, and xlstm's scoring loss
    (``steps.loss_fn``); one fp32 training step of each on the kernel path
    (each scan's kernels launched both ways on every rank) holds the loss
    at TP_SSM_LIMITS and every gathered gradient leaf at the
    larger of TP_SSM_LIMITS and SENS_RATIO times its one-ulp sensitivity
    (``_tp_sens_parity``); (b) bf16 at full depth:
    zamba2's serving launches exactly TP_SSM_SERVE_KERNELS on each rank,
    every ``ssm_scan`` call at H / TP_RANKS heads, a rank's cache bytes
    1 / TP_RANKS of the one process's; xlstm's scoring launches exactly
    TP_SSM_SCORE_KERNELS, every ``mlstm_scan`` call at H / TP_RANKS heads;
    every recorded kernel call of one prefill, one decode step and one
    scoring forward under the phase-2 rule; (c) one zamba2 bf16 decode
    step's collectives (``_collective_bytes``) equal by kind to what
    ``launch/dryrun.py``'s counting mesh counts for the same step.
    Reported: token agreement with one process in bf16, times and peak
    memory.  Ranks sharing one card through host-staged gloo measure
    correctness, not scaling."""
    import shutil

    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding as msh

    sys.path.insert(0, str(ROOT / "tests"))          # the ranks' launcher, shared with the tests
    from _ranks import spawn_ranks

    label = TP_SSM_PATH
    cache_len = PROMPT + GEN + 1
    z, xl = registry.get_config("zamba2_1_2b"), registry.get_config("xlstm_1_3b")
    print(f"{label}: zamba2 and xlstm at full width, {TP_RANKS} gloo ranks on one card on a "
          f"(1, {TP_RANKS}) mesh, batch {BATCH} x {PROMPT}, {GEN} new tokens; fp32 at "
          f"{TP_SSM_LAYERS} layers, bf16 at full depth  [{card}]")
    shape = InputShape("tp_ssm_decode", cache_len, BATCH, "decode")
    with dryrun.counting_mesh((1, TP_RANKS), ("data", "model")) as mesh, msh.use_mesh(mesh):
        coll = dryrun.count_step(dryrun._shape_cfg(z, shape), shape)["collectives"]
    counted = {k: [c["calls"], c["bytes"]] for k, c in coll.items()}
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "experiments" / "chip_smoke_tp_ssm"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(_tp_ssm_rank, TP_RANKS, out_dir=out_dir, timeout_s=900)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    leg_s = time.perf_counter() - t0

    res = {}
    for arch, cfg, scan in (("zamba2_1_2b", z, "ssm_scan"), ("xlstm_1_3b", xl, "mlstm_scan")):
        one = ranks[0][arch]["one"]
        # (a) fp32 serving (and xlstm's scoring) on the kernel path
        a = {}
        for r in ranks:
            got = r[arch]["a"]
            rel = {"prefill": _rel(got["logits"][0], one["logits"][0]),
                   "decode": max(_rel(g, w) for g, w in zip(got["logits"][1:],
                                                            one["logits"][1:]))}
            if "score" in one:
                rel["score"] = abs(got["score"] - one["score"]) / abs(one["score"])
            a[r["rank"]] = {**rel, "tokens_equal": torch.equal(got["tokens"], one["tokens"])}
            print(f"{label} {arch} (a), fp32 at {TP_SSM_LAYERS[arch]} layers, rank {r['rank']} vs "
                  f"one process: " + ", ".join(f"{k} rel {v:.4g}" for k, v in rel.items())
                  + f" (limit {TP_SERVE_REL}), tokens equal {a[r['rank']]['tokens_equal']}  "
                  f"[{card}]")
            if max(rel.values()) > TP_SERVE_REL or not a[r["rank"]]["tokens_equal"]:
                raise AssertionError(f"{label} {arch} (a): rank {r['rank']} vs one process: "
                                     f"{a[r['rank']]} (limit {TP_SERVE_REL})")
            got = r[arch]["train_launches"]
            if not (got[scan] and got[scan + "_bwd"]):
                raise AssertionError(f"{label} {arch}: rank {r['rank']}'s training step did not "
                                     f"run the scan's kernels both ways: launches {got}")
        train = ranks[0][arch]["train"]
        worst = max(train["leaves"], key=train["leaves"].get)
        ratio = max(train["leaves"], key=lambda n: train["leaves"][n] / train["limits"][n])
        print(f"{label} {arch} (a), one fp32 training step at {TRAIN_BATCH} x {TP_SSM_SEQ} on "
              f"the kernel path, {TP_RANKS} ranks vs one process: loss rel {train['loss']:.4g} "
              f"(limit "
              f"{TP_SSM_LIMITS['fp32_loss']}), gathered gradient leaf rel up to "
              f"{train['leaves'][worst]:.4g} ({worst}: its limit {train['limits'][worst]:.4g}; "
              f"the one process's one-ulp sensitivity up to {max(train['sens'].values()):.4g}); "
              f"nearest its limit {ratio}, {train['leaves'][ratio]:.4g} of "
              f"{train['limits'][ratio]:.4g}; {len(train['floored'])} leaves held at the floor; "
              f"launches of rank 0's step: {ranks[0][arch]['train_launches']}  [{card}]")
        over = ([f"loss {train['loss']}"] if train["loss"] > TP_SSM_LIMITS["fp32_loss"] else []) \
            + [f"{n} {v} (limit {train['limits'][n]})" for n, v in train["leaves"].items()
               if v > train["limits"][n]]
        if over:
            raise AssertionError(f"{label} {arch} (a): one training step over the limits: "
                                 + "; ".join(over))
        # (b) bf16 at full depth
        heads = cfg.n_heads // TP_RANKS
        kernels = TP_SSM_SERVE_KERNELS if arch == "zamba2_1_2b" else TP_SSM_SCORE_KERNELS
        b = {}
        for r in ranks:
            got = r[arch]["b"]
            _expect(f"{label} {arch}, rank {r['rank']}", got["launches"], kernels)
            if set(got["scan_heads"]) != {heads}:
                raise AssertionError(f"{label} {arch} (b): rank {r['rank']}'s scans at heads "
                                     f"{sorted(set(got['scan_heads']))}, not {heads}")
            if "cache_bytes" in got and got["cache_bytes"] * TP_RANKS != got["whole_cache_bytes"]:
                raise AssertionError(f"{label} {arch} (b): rank {r['rank']} holds "
                                     f"{got['cache_bytes']} cache bytes, not 1/{TP_RANKS} of "
                                     f"{got['whole_cache_bytes']}")
            b[r["rank"]] = {k: v for k, v in got.items()
                            if k not in ("launches", "tokens", "prefill_logits")}
        if arch == "zamba2_1_2b":
            agree = float((ranks[0][arch]["b"]["tokens"] == one["bf16_tokens"]).float().mean())
            logits_rel = _rel(ranks[0][arch]["b"]["prefill_logits"], one["bf16_prefill_logits"])
            print(f"{label} {arch} (b), bf16 at {cfg.n_layers} layers: launch set "
                  f"{sorted(kernels)} on every rank, {len(ranks[0][arch]['b']['scan_heads'])} "
                  f"ssm_scan calls a rank at {heads} heads; cache bytes a rank "
                  + ", ".join(str(v["cache_bytes"]) for v in b.values())
                  + f" of {b[0]['whole_cache_bytes']}; "
                  + "; ".join(f"rank {k}: prefill {v['prefill_ms']:.2f} ms, decode "
                              f"{v['decode_ms_per_token']:.2f} ms/token, peak "
                              f"{v['peak_gib']:.2f} GiB" for k, v in b.items())
                  + f"; one process: prefill {one['prefill_ms']:.2f} ms, decode "
                  f"{one['decode_ms_per_token']:.2f} ms/token; token agreement with one process "
                  f"{agree:.4f}, prefill logits rel {logits_rel:.4g} (reported)  [{card}]")
            # (c) the card's collectives of one decode step against the count
            for r in ranks:
                if r[arch]["c"] != counted:
                    raise AssertionError(f"{label} {arch} (c): rank {r['rank']}'s collectives of "
                                         f"one decode step {r[arch]['c']}, the counting mesh's "
                                         f"{counted}")
            print(f"{label} {arch} (c): one bf16 decode step's collectives on the card "
                  f"{ranks[0][arch]['c']} (calls, output bytes) equal the counting mesh's  "
                  f"[{card}]")
        else:
            agree = abs(ranks[0][arch]["b"]["loss"] - one["bf16_loss"]) / abs(one["bf16_loss"])
            print(f"{label} {arch} (b), bf16 scoring at {cfg.n_layers} layers, batch {BATCH} x "
                  f"{PROMPT}: launch set {sorted(kernels)} on every rank, "
                  f"{len(ranks[0][arch]['b']['scan_heads'])} mlstm_scan calls a rank at {heads} "
                  "heads; " + "; ".join(f"rank {k}: loss {v['loss']:.5f}, forward "
                                        f"{v['forward_ms']:.2f} ms, peak {v['peak_gib']:.2f} GiB"
                                        for k, v in b.items())
                  + f"; one process: loss {one['bf16_loss']:.5f}, forward "
                  f"{one['forward_ms']:.2f} ms; loss rel to one process {agree:.4g} (reported)  "
                  f"[{card}]")
        res[arch] = {"a": a, "train": train, "b": b, "bf16_agreement": agree,
                     "bf16_prefill_logits_rel": logits_rel if arch == "zamba2_1_2b" else None,
                     "one_process": {k: v for k, v in one.items()
                                     if k in ("prefill_ms", "decode_ms_per_token", "forward_ms",
                                              "bf16_loss")}}
    res["zamba2_1_2b"]["c"] = counted
    launches = {n: sum(r["launches"][n] for r in ranks) for n in META}
    print(f"{label}: launches (both ranks, bf16 runs) {launches}; the whole leg {leg_s:.1f} s  "
          f"[{card}]")
    return {"ranks": TP_RANKS, "archs": res, "leg_s": leg_s, "launches": launches}


def _tp_sens_parity(rank: int, mesh, cfg32, params: dict, seq: int,
                    limits: dict) -> dict | None:
    """Gate (a)'s training step: one fp32 step of ``steps.dp_grads`` on
    this rank's shards of ``params`` and the whole batch (TRAIN_BATCH x
    ``seq``), the gradients gathered whole, against one process on rank
    0.  Returns rank 0's rel errors (None on the others), each leaf's
    sensitivity (``_nudged``) and its limit, the larger of ``limits``'
    leaf limit and SENS_RATIO times its sensitivity.  A leaf whose whole
    gradient is below ZERO_LEAF of the tree's largest is listed in
    ``floored`` and reads 0 if the split run's is below that floor too,
    else infinity."""
    import torch
    from repro_torch.data.tokens import lm_batches
    from repro_torch.models import sharding as msh
    from repro_torch.models import steps
    from repro_torch.optim import adamw

    whole = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg32, TRAIN_BATCH, seq, seed=3)).items()}
    with msh.use_mesh(mesh):
        pspecs = msh.param_shardings(params, mesh)
        local = adamw.tree_map(lambda t, s: msh.local_slice(t, s, mesh).clone(), params, pspecs)
        loss, _, grads = steps.dp_grads(local, whole, cfg=cfg32)
        del local
        grads = adamw.tree_map(lambda t, s: msh.gather_leaf(t, s, mesh), grads, pspecs)
    out = None
    if rank == 0:
        one, want = _one_step(params, cfg32, whole)
        sens = {n: 0.0 for n, _ in _named(params)}
        for seed in (1, 2):
            _, nudged = _one_step(_nudged(params, seed), cfg32, whole)
            for (n, _), g, w in zip(_named(params), nudged, want):
                sens[n] = max(sens[n], _rel(g, w))
            del nudged
        floor = ZERO_LEAF * max(float(w.abs().max()) for w in want)
        rels, floored = {}, []
        for (n, _), g, w in zip(_named(params), adamw.tree_leaves(grads), want):
            if float(w.abs().max()) < floor:
                floored.append(n)
                rels[n] = 0.0 if float(g.abs().max()) < floor else math.inf
            else:
                rels[n] = _rel(g, w)
        out = {"loss": abs(float(loss) - one) / abs(one), "leaves": rels, "floored": floored,
               "sens": sens, "limits": {n: max(limits["fp32_grad_leaf"], SENS_RATIO * v)
                                        for n, v in sens.items()}}
        del want
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _one_step(params: dict, cfg, batch: dict) -> tuple:
    """(loss, every leaf's gradient) of one process's step on ``batch``."""
    import torch
    from repro_torch.models import steps
    from repro_torch.optim import adamw
    leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = steps.loss_fn(leaves, cfg, batch)
    return float(loss.detach()), torch.autograd.grad(loss, adamw.tree_leaves(leaves))


def _nudged(params: dict, seed: int) -> dict:
    """``params`` with every element moved by one ulp, up or down at random."""
    import torch
    from repro_torch.optim import adamw
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def nudge(t):
        up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
        return torch.nextafter(t, torch.where(up, torch.inf, -torch.inf).to(t.dtype))
    return adamw.tree_map(nudge, params)


def _tp_ssm_rank(rank: int) -> dict:
    """One rank of ``_tp_ssm_leg``, in its own process on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.kernels import native, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, steps
    from repro_torch.models import sharding as msh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((1, TP_RANKS), ("data", "model"), "cuda")
    cache_len = PROMPT + GEN + 1
    out: dict = {"rank": rank, "launches": {n: 0 for n in META}}

    def settle():
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()

    for arch in ("zamba2_1_2b", "xlstm_1_3b"):
        full = registry.get_config(arch)
        prompts = _prompts(full, PROMPT).cuda()
        scoring = {"tokens": prompts, "labels": prompts}
        res: dict = {}
        # (a) fp32 on the kernel path: serving (and xlstm's scoring), the
        # split run, then (rank 0) one process
        cfg32 = full.replace(n_layers=TP_SSM_LAYERS[arch], dtype="float32", use_kernels=True)
        params = lm.init_params(cfg32, seed=0, device="cuda")
        local = _shards(params, mesh)
        with torch.inference_mode(), msh.use_mesh(mesh):
            res["a"] = _tp_serve_run(local, cfg32, prompts, cache_len)
            if arch == "xlstm_1_3b":
                res["a"]["score"] = float(steps.loss_fn(local, cfg32, scoring)[0])
        one: dict = {}
        if rank == 0:
            with torch.inference_mode():
                one = _tp_serve_run(params, cfg32, prompts, cache_len)
                if arch == "xlstm_1_3b":
                    one["score"] = float(steps.loss_fn(params, cfg32, scoring)[0])
        # one training step on the kernel path (the scans' backward kernels)
        del local
        settle()
        native.reset_launches()
        res["train"] = _tp_sens_parity(rank, mesh, cfg32, params, TP_SSM_SEQ, TP_SSM_LIMITS)
        res["train_launches"] = dict(native.LAUNCHES)
        del params
        settle()

        # (b) bf16 at full depth: timed, launches and the scans' heads
        # counted; one prefill and one decode step, or one scoring forward,
        # recorded
        cfg = full.replace(use_kernels=True, dtype="bfloat16")
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(cfg, seed=0, device="cuda")
        local = _shards(params, mesh)
        if rank != 0:
            del params
        settle()
        heads, name = [], "_ssm_kernel" if arch == "zamba2_1_2b" else "_mlstm_kernel"
        kernel = getattr(ops, name)

        def spy(x, *args, **kw):
            heads.append(x.shape[2])
            return kernel(x, *args, **kw)

        b: dict = {}
        start = steps.start_positions(cfg, BATCH, PROMPT, "cuda")
        with torch.inference_mode(), msh.use_mesh(mesh):
            native.reset_launches()
            setattr(ops, name, spy)
            try:
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                if arch == "zamba2_1_2b":
                    last, cache = steps.prefill(local, {"tokens": prompts}, cfg=cfg,
                                                cache_len=cache_len)
                    torch.cuda.synchronize()
                    b["prefill_ms"] = (time.perf_counter() - t0) * 1e3
                    b["prefill_logits"] = last.float().cpu()
                    first = torch.argmax(last, -1).to(torch.int32)[:, None]
                    b["cache_bytes"] = _nbytes(cache)
                    t0 = time.perf_counter()
                    b["tokens"], cache = steps.greedy_decode_loop(local, cache, first, start,
                                                                  GEN, cfg=cfg)
                    torch.cuda.synchronize()
                    b["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / GEN
                    b["tokens"] = b["tokens"].cpu()
                    del cache
                else:
                    b["loss"] = float(steps.loss_fn(local, cfg, scoring)[0])
                    torch.cuda.synchronize()
                    b["forward_ms"] = (time.perf_counter() - t0) * 1e3
            finally:
                setattr(ops, name, kernel)
            b["launches"] = dict(native.LAUNCHES)
            b["scan_heads"] = heads
            b["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            for n, c in b["launches"].items():
                out["launches"][n] += c
            # every kernel call of one prefill and one decode step, or of one
            # scoring forward, against its twin
            kernels = TP_SSM_SERVE_KERNELS if arch == "zamba2_1_2b" else TP_SSM_SCORE_KERNELS
            with _recording(kernels) as calls:
                if arch == "zamba2_1_2b":
                    _, cache = steps.prefill(local, {"tokens": prompts}, cfg=cfg,
                                             cache_len=cache_len)
                    steps.serve_step(local, cache, first, start, cfg=cfg)
                    del cache
                else:
                    steps.loss_fn(local, cfg, scoring)
            b["recorded"] = _hold_recorded(f"{TP_SSM_PATH} {arch}, rank {rank}", cfg, calls)
            del calls
            if arch == "zamba2_1_2b":
                # (c) the collectives of one decode step, in the count's convention
                _, cache = steps.prefill(local, {"tokens": prompts}, cfg=cfg,
                                         cache_len=cache_len)
                coll: dict = {}
                _collective_bytes(lambda: steps.serve_step(local, cache, first, start, cfg=cfg),
                                  coll)
                res["c"] = coll
                del cache
        if arch == "zamba2_1_2b":
            b["whole_cache_bytes"] = _nbytes(lm.init_cache(cfg, BATCH, cache_len, device="meta"))
        res["b"] = b
        del local
        settle()
        if rank == 0:                       # one process in bf16: its tokens or loss, its times
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if arch == "zamba2_1_2b":
                    last, cache = steps.prefill(params, {"tokens": prompts}, cfg=cfg,
                                                cache_len=cache_len)
                    torch.cuda.synchronize()
                    one["prefill_ms"] = (time.perf_counter() - t0) * 1e3
                    one["bf16_prefill_logits"] = last.float().cpu()
                    first = torch.argmax(last, -1).to(torch.int32)[:, None]
                    t0 = time.perf_counter()
                    toks, _ = steps.greedy_decode_loop(params, cache, first, start, GEN, cfg=cfg)
                    torch.cuda.synchronize()
                    one["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / GEN
                    one["bf16_tokens"] = toks.cpu()
                    del cache
                else:
                    one["bf16_loss"] = float(steps.loss_fn(params, cfg, scoring)[0])
                    torch.cuda.synchronize()
                    one["forward_ms"] = (time.perf_counter() - t0) * 1e3
            del params
        res["one"] = one
        settle()
        out[arch] = res
    return out

def _tp_encdec_leg(card: str) -> dict:
    """Tensor parallelism of enc-dec: TP_RANKS ranks share the card through
    a gloo group on a (1, TP_RANKS) mesh (``_tp_encdec_rank``), each on its
    shards of every parameter and its block of the cache, for whisper-base
    at full width and depth over BATCH x 1500 seeded frame rows.  Gated:
    (a) fp32 on the kernel path, every rank's prefill logits and GEN greedy
    decode steps' logits against one process on rank 0 within
    TP_SERVE_REL, the tokens equal, and one training step through the
    forward and backward kernels, the loss at TP_ENCDEC_LIMITS and every
    gathered gradient leaf at the larger of TP_ENCDEC_LIMITS and SENS_RATIO
    times its one-ulp sensitivity (``_tp_sens_parity``); (b) bf16: serving
    launches exactly TP_SERVE_KERNELS on each rank and one training step
    exactly TRAIN_KERNELS, every flash and decode-attention call at Hq /
    TP_RANKS query over Hkv / TP_RANKS kv heads, a rank's cache half of one
    process's apart from ``enc_len`` (whole on both), every recorded kernel
    call of one prefill, one decode step and one training step under the
    phase-2 rule; (c) one bf16 decode step's collectives
    (``_collective_bytes``) equal by kind to what ``launch/dryrun.py``'s
    counting mesh counts for the same step.  Reported: token agreement with
    one process in bf16, times and peak memory.  Ranks sharing one card
    through host-staged gloo measure correctness, not scaling."""
    import shutil

    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding as msh

    sys.path.insert(0, str(ROOT / "tests"))          # the ranks' launcher, shared with the tests
    from _ranks import spawn_ranks

    label = TP_ENCDEC_PATH
    cache_len = PROMPT + GEN + 1
    wb = registry.get_config("whisper_base")
    heads = (wb.n_heads // TP_RANKS, wb.n_kv_heads // TP_RANKS)
    print(f"{label}: whisper-base at full width and depth ({wb.encoder_layers} + {wb.n_layers} "
          f"layers, {wb.encoder_len} frame rows), {TP_RANKS} gloo ranks on one card on a "
          f"(1, {TP_RANKS}) mesh, batch {BATCH} x {PROMPT}, {GEN} new tokens  [{card}]")
    t0 = time.perf_counter()
    shape = InputShape("tp_encdec_decode", cache_len, BATCH, "decode")
    with dryrun.counting_mesh((1, TP_RANKS), ("data", "model")) as mesh, msh.use_mesh(mesh):
        coll = dryrun.count_step(dryrun._shape_cfg(wb, shape), shape)["collectives"]
    counted = {k: [c["calls"], c["bytes"]] for k, c in coll.items()}
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "experiments" / "chip_smoke_tp_encdec"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    try:
        ranks = spawn_ranks(_tp_encdec_rank, TP_RANKS, out_dir=out_dir, timeout_s=900)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    leg_s = time.perf_counter() - t0

    one = ranks[0]["one"]
    # (a) fp32 on the kernel path: serving, then one training step
    a = {}
    for r in ranks:
        got = r["a"]
        rel = {"prefill": _rel(got["logits"][0], one["logits"][0]),
               "decode": max(_rel(g, w) for g, w in zip(got["logits"][1:], one["logits"][1:]))}
        a[r["rank"]] = {**rel, "tokens_equal": torch.equal(got["tokens"], one["tokens"])}
        print(f"{label} (a), fp32 at full depth, rank {r['rank']} vs one process: prefill logits "
              f"rel {rel['prefill']:.4g}, {GEN} decode steps' logits rel up to {rel['decode']:.4g} "
              f"(limit {TP_SERVE_REL}), tokens equal {a[r['rank']]['tokens_equal']}  [{card}]")
        if max(rel.values()) > TP_SERVE_REL or not a[r["rank"]]["tokens_equal"]:
            raise AssertionError(f"{label} (a): rank {r['rank']} vs one process: "
                                 f"{a[r['rank']]} (limit {TP_SERVE_REL})")
    train = ranks[0]["train"]
    worst = max(train["leaves"], key=train["leaves"].get)
    ratio = max(train["leaves"], key=lambda n: train["leaves"][n] / train["limits"][n])
    print(f"{label} (a), one fp32 training step at {TRAIN_BATCH} x {PROMPT} on the kernel path, "
          f"{TP_RANKS} ranks vs one process: loss rel {train['loss']:.4g} (limit "
          f"{TP_ENCDEC_LIMITS['fp32_loss']}), gathered gradient leaf rel up to "
          f"{train['leaves'][worst]:.4g} ({worst}: its limit {train['limits'][worst]:.4g}); "
          f"the one process's one-ulp sensitivity up to {max(train['sens'].values()):.4g}; "
          f"nearest its limit {ratio}, {train['leaves'][ratio]:.4g} of "
          f"{train['limits'][ratio]:.4g}; leaves over {TP_ENCDEC_LIMITS['fp32_grad_leaf']}: "
          + (", ".join(f"{n} {v:.4g} (sensitivity {train['sens'][n]:.4g})"
                       for n, v in train["leaves"].items()
                       if v > TP_ENCDEC_LIMITS["fp32_grad_leaf"]) or "none")
          + f"; {len(train['floored'])} leaves held at the floor  [{card}]")
    over = ([f"loss {train['loss']}"] if train["loss"] > TP_ENCDEC_LIMITS["fp32_loss"] else []) \
        + [f"{n} {v} (limit {train['limits'][n]})" for n, v in train["leaves"].items()
           if v > train["limits"][n]]
    if over:
        raise AssertionError(f"{label} (a): one training step over the limits: "
                             + "; ".join(over))
    # (b) bf16: launch sets, heads, the cache block
    b = {}
    whole_cache, enc_bytes = ranks[0]["b"]["whole_cache_bytes"], ranks[0]["b"]["enc_len_bytes"]
    for r in ranks:
        got = r["b"]
        _expect(f"{label} serving, rank {r['rank']}", got["serve_launches"], TP_SERVE_KERNELS)
        _expect(f"{label} training, rank {r['rank']}", got["train_launches"], TRAIN_KERNELS)
        for kind in ("flash_heads", "decode_heads"):
            if set(got[kind]) != {heads}:
                raise AssertionError(f"{label} (b): rank {r['rank']}'s {kind} at (query, kv) "
                                     f"heads {sorted(set(got[kind]))}, not {heads}")
        if (got["cache_bytes"] - enc_bytes) * TP_RANKS != whole_cache - enc_bytes:
            raise AssertionError(f"{label} (b): rank {r['rank']} holds {got['cache_bytes']} cache "
                                 f"bytes, not 1/{TP_RANKS} of {whole_cache} apart from enc_len's "
                                 f"{enc_bytes}")
        b[r["rank"]] = {k: v for k, v in got.items()
                        if k not in ("tokens", "prefill_logits", "flash_heads", "decode_heads")}
    agree = float((ranks[0]["b"]["tokens"] == one["bf16_tokens"]).float().mean())
    logits_rel = _rel(ranks[0]["b"]["prefill_logits"], one["bf16_prefill_logits"])
    print(f"{label} (b), bf16: serving launch set {sorted(TP_SERVE_KERNELS)} and a training "
          f"step's {sorted(TRAIN_KERNELS)} on every rank, "
          f"{len(ranks[0]['b']['flash_heads'])} flash and {len(ranks[0]['b']['decode_heads'])} "
          f"decode-attention calls a rank, all at {heads[0]}/{heads[1]} heads; cache bytes a rank "
          + ", ".join(str(v["cache_bytes"]) for v in b.values())
          + f" of {whole_cache} ({ranks[0]['b']['cross_bytes']} of a rank's in cross_k/cross_v, "
          f"enc_len {enc_bytes} whole); "
          + "; ".join(f"rank {k}: prefill {v['prefill_ms']:.2f} ms, decode "
                      f"{v['decode_ms_per_token']:.2f} ms/token, training step "
                      f"{v['train_ms']:.2f} ms, peak {v['peak_gib']:.2f} GiB" for k, v in b.items())
          + f"; one process: prefill {one['prefill_ms']:.2f} ms, decode "
          f"{one['decode_ms_per_token']:.2f} ms/token; token agreement with one process "
          f"{agree:.4f}, prefill logits rel {logits_rel:.4g} (reported)  [{card}]")
    # (c) the card's collectives of one decode step against the count
    for r in ranks:
        if r["c"] != counted:
            raise AssertionError(f"{label} (c): rank {r['rank']}'s collectives of one decode step "
                                 f"{r['c']}, the counting mesh's {counted}")
    print(f"{label} (c): one bf16 decode step's collectives on the card {ranks[0]['c']} (calls, "
          f"output bytes) equal the counting mesh's  [{card}]")
    launches = {n: sum(r["launches"][n] for r in ranks) for n in META}
    print(f"{label}: launches (both ranks, bf16 runs) {launches}; the whole leg {leg_s:.1f} s  "
          f"[{card}]")
    return {"ranks": TP_RANKS, "a": a, "train": train, "b": b, "c": counted,
            "whole_cache_bytes": whole_cache, "bf16_token_agreement": agree,
            "bf16_prefill_logits_rel": logits_rel,
            "one_process": {k: one[k] for k in ("prefill_ms", "decode_ms_per_token")},
            "leg_s": leg_s, "launches": launches}


def _tp_encdec_rank(rank: int) -> dict:
    """One rank of ``_tp_encdec_leg``, in its own process on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.data.tokens import lm_batches
    from repro_torch.kernels import native, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, steps
    from repro_torch.models import sharding as msh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((1, TP_RANKS), ("data", "model"), "cuda")
    cache_len = PROMPT + GEN + 1
    full = registry.get_config("whisper_base")
    out: dict = {"rank": rank, "launches": {n: 0 for n in META}}

    def settle():
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()

    prompts = _prompts(full, PROMPT).cuda()
    inputs, start = _gate_inputs(full, prompts)
    frames = inputs["frames"]
    # (a) fp32 on the kernel path: serving, the split run, then (rank 0) one
    # process; one training step through the forward and backward kernels
    cfg32 = full.replace(dtype="float32", use_kernels=True)
    params = lm.init_params(cfg32, seed=0, device="cuda")
    local = _shards(params, mesh)
    with torch.inference_mode(), msh.use_mesh(mesh):
        out["a"] = _tp_serve_run(local, cfg32, prompts, cache_len, frames=frames)
    del local
    one: dict = {}
    if rank == 0:
        with torch.inference_mode():
            one = _tp_serve_run(params, cfg32, prompts, cache_len, frames=frames)
    settle()
    out["train"] = _tp_sens_parity(rank, mesh, cfg32, params, PROMPT, TP_ENCDEC_LIMITS)
    del params
    settle()

    # (b) bf16: serving timed, launches and the attention kernels' heads
    # counted; one training step on fp32 masters; one prefill, one decode
    # step and one training step recorded
    cfg = full.replace(use_kernels=True, dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    masters = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    params = lm._cast_tree(masters, torch.bfloat16)
    local, local32 = _shards(params, mesh), _shards(masters, mesh)
    del masters
    if rank != 0:
        del params
    settle()
    flash_heads, decode_heads = [], []
    flash, decode = ops._flash_kernel, ops._decode_kernel

    def flash_spy(q, k, v, **kw):
        flash_heads.append((q.shape[2], k.shape[2]))
        return flash(q, k, v, **kw)

    def decode_spy(q, k, v, *args, **kw):
        decode_heads.append((q.shape[1], k.shape[2]))
        return decode(q, k, v, *args, **kw)

    b: dict = {}
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(lm_batches(cfg, TRAIN_BATCH, PROMPT, seed=3)).items()}
    ops._flash_kernel, ops._decode_kernel = flash_spy, decode_spy
    try:
        with torch.inference_mode(), msh.use_mesh(mesh):
            native.reset_launches()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            last, cache = steps.prefill(local, inputs, cfg=cfg, cache_len=cache_len)
            torch.cuda.synchronize()
            b["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            b["prefill_logits"] = last.float().cpu()
            first = torch.argmax(last, -1).to(torch.int32)[:, None]
            b["cache_bytes"] = _nbytes(cache)
            b["cross_bytes"] = sum(t.numel() * t.element_size() for n, t in _named(cache)
                                   if n.rsplit("/", 1)[-1] in ("cross_k", "cross_v"))
            t0 = time.perf_counter()
            b["tokens"], cache = steps.greedy_decode_loop(local, cache, first, start, GEN,
                                                          cfg=cfg)
            torch.cuda.synchronize()
            b["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / GEN
            b["serve_launches"] = dict(native.LAUNCHES)
            b["tokens"] = b["tokens"].cpu()
            del cache
        with msh.use_mesh(mesh):
            native.reset_launches()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            steps.dp_grads(local32, batch, cfg=cfg)
            torch.cuda.synchronize()
            b["train_ms"] = (time.perf_counter() - t0) * 1e3
            b["train_launches"] = dict(native.LAUNCHES)
    finally:
        ops._flash_kernel, ops._decode_kernel = flash, decode
    b["flash_heads"], b["decode_heads"] = flash_heads, decode_heads
    b["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for launches in (b["serve_launches"], b["train_launches"]):
        for n, c in launches.items():
            out["launches"][n] += c
    with msh.use_mesh(mesh):
        # every kernel call of one prefill and one decode step, and of one
        # training step, against its twin
        with torch.inference_mode(), _recording(TP_SERVE_KERNELS) as calls:
            _, cache = steps.prefill(local, inputs, cfg=cfg, cache_len=cache_len)
            steps.serve_step(local, cache, first, start, cfg=cfg)
        b["recorded"] = _hold_recorded(f"{TP_ENCDEC_PATH} serving, rank {rank}", cfg, calls)
        del calls, cache
        with _recording(TRAIN_KERNELS) as calls:
            steps.dp_grads(local32, batch, cfg=cfg)
        b["recorded_train"] = _hold_recorded(f"{TP_ENCDEC_PATH} training, rank {rank}", cfg,
                                             calls)
        del calls
        # (c) the collectives of one decode step, in the count's convention
        with torch.inference_mode():
            _, cache = steps.prefill(local, inputs, cfg=cfg, cache_len=cache_len)
            coll: dict = {}
            _collective_bytes(lambda: steps.serve_step(local, cache, first, start, cfg=cfg), coll)
        out["c"] = coll
        del cache
    whole = lm.init_cache(cfg, BATCH, cache_len, device="meta")
    b["whole_cache_bytes"] = _nbytes(whole)
    b["enc_len_bytes"] = whole["enc_len"].numel() * whole["enc_len"].element_size()
    out["b"] = b
    del local, local32, batch
    settle()
    if rank == 0:                       # one process in bf16: its tokens, its times
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = steps.prefill(params, inputs, cfg=cfg, cache_len=cache_len)
            torch.cuda.synchronize()
            one["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            one["bf16_prefill_logits"] = last.float().cpu()
            first = torch.argmax(last, -1).to(torch.int32)[:, None]
            t0 = time.perf_counter()
            toks, _ = steps.greedy_decode_loop(params, cache, first, start, GEN, cfg=cfg)
            torch.cuda.synchronize()
            one["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / GEN
            one["bf16_tokens"] = toks.cpu()
        del params, cache
    out["one"] = one
    settle()
    return out


def _cache_read_bytes(cfg, batch: int, cache_len: int, pos: int) -> int:
    """The cache bytes one decode step at position ``pos`` must read: rows
    0..pos of every row cache (of a ring, its last min(pos + 1, size)),
    whisper's cached encoder rows whole, every recurrent state whole."""
    from repro_torch.models import lm
    total = 0
    for path, t in _named(lm.init_cache(cfg, batch, cache_len, device="meta")):
        key = path.rsplit("/", 1)[-1]
        if key in ("k", "v", "c_kv", "k_rope"):          # (groups, B, rows, ...)
            total += t[:, :, :min(pos + 1, t.shape[2])].numel() * t.element_size()
        elif key != "enc_len":
            total += t.numel() * t.element_size()
    return total


def _roofline_phase(report: dict, hw, card: str) -> list:
    """Every phase the paths timed against the least time the card ``hw``
    could take for it: max(model FLOPs / bf16 peak, least bytes / HBM
    bandwidth).  Model FLOPs are ``launch.roofline.model_flops`` (2 N D a
    forward, 6 N D a training step, N the active non-embedding
    parameters); the least bytes are the active weights in the served
    dtype read once plus the cache a decode step reads (averaged over the
    GEN steps), and for the training step the fp32 masters and AdamW's two
    moments, each read and written once.  A measured time below its bound
    is a wrong count or a wrong spec: the run fails.  Printed per phase:
    ``mfu`` (model FLOPs over time x peak), the HBM share (least bytes
    over time x bandwidth), and the FLOPs ``launch/count.py`` counts on
    ``meta`` for the same step at the same shape on the plain path (a
    decode step against the full cache), with their ratio to the model's."""
    from repro_torch.configs import registry
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.roofline import model_flops

    t0 = time.perf_counter()
    phases = []                 # (label, phase, cfg, kind, batch, seq or cache rows, ms, bytes)
    for label, arch, run, *_ in PATHS:
        res = report["paths"][label]
        cfg = registry.get_config(arch)
        weights = cfg.approx_active_params() * cfg.compute_dtype.itemsize
        legs = [(res, "")] + ([(res["long_leg"], "long ")] if res.get("long_leg") else [])
        for leg, tag in legs if run == "serve" else []:
            b, prompt = leg["batch"], leg["prompt"]
            rows = prompt + GEN + (0 if tag else 1)
            reads = sum(_cache_read_bytes(cfg, b, rows, prompt + i) for i in range(GEN)) / GEN
            phases += [(label, f"{tag}prefill", cfg, "prefill", b, prompt, leg["prefill_ms"],
                        weights),
                       (label, f"{tag}decode step", cfg, "decode", b, rows,
                        leg["decode_ms_per_token"], weights + reads)]
        if run == "score":
            phases.append((label, "forward", cfg, "prefill", res["batch"], res["tokens"],
                           res["forward_ms"], weights))
    leg = report["lm_train_leg"]
    cfg = registry.get_config("granite_3_8b").replace(n_layers=TRAIN_LAYERS)
    phases.append((TRAIN_PATH, "step", cfg, "train", TRAIN_BATCH, TRAIN_SEQ,
                   leg["train_s"] / TRAIN_STEPS * 1e3, 24 * cfg.approx_active_params()))
    rows_out, low, counts = [], [], {}
    for label, phase, cfg, kind, b, seq, ms, nbytes in phases:
        mf = model_flops(cfg, kind, b, seq)
        t_ops, t_bytes = mf / hw.peak_flops_bf16 * 1e3, nbytes / hw.hbm_bw * 1e3
        bound = max(t_ops, t_bytes)
        key = (cfg, kind, b, seq)           # xlstm's scoring forward is its serving prefill
        if key not in counts:
            counts[key] = count_step(cfg, InputShape(phase, seq, b, kind),
                                     serve_bf16=True)["flops"]
        counted = counts[key]
        row = {"path": label, "phase": phase, "batch": b, "tokens_or_rows": seq, "ms": ms,
               "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "model_flops": mf, "least_bytes": nbytes, "mfu": t_ops / ms,
               "hbm_share": t_bytes / ms, "counted_flops": counted,
               "counted_over_model": counted / mf}
        rows_out.append(row)
        print(f"{label} {phase}: {ms:.3f} ms, bound {bound:.4f} ms ({row['bound_by']}); mfu "
              f"{row['mfu']:.4f}, HBM share {row['hbm_share']:.4f}; model FLOPs {mf:.4g}, "
              f"counted {counted:.4g} (x{row['counted_over_model']:.3f})  [{card}]")
        if ms < bound:
            low.append(f"{label} {phase} {ms} ms < {bound} ms")
    if low:
        raise AssertionError("measured below the roofline bound (a wrong count or spec): "
                             + "; ".join(low))
    print(f"roofline phase: {len(rows_out)} phases at or above their bounds, counted on meta "
          f"in {time.perf_counter() - t0:.1f} s  [{card}]")
    return rows_out


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


def _cast_in_place(tree: dict, dtype) -> None:
    """Replace every leaf of ``tree`` by its cast to ``dtype``, largest
    first, freeing each old leaf (and releasing its cached memory)
    before the next cast: the peak is the new tree and about one old leaf,
    never both trees.  The caller must hold no other reference to a leaf."""
    import torch

    def slots(t):
        for k, v in t.items():
            yield from (slots(v) if isinstance(v, dict) else ((t, k),))

    for t, k in sorted(slots(tree), key=lambda tk: -tk[0][tk[1]].numel()):
        t[k] = t[k].to(dtype)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _routing(replay: list | None = None):
    """Yields the expert ids (B,S,k) of every MoE top-k choice made inside
    the block, in call order (``moe._top_k`` wrapped).  With ``replay``,
    another run's list, call i routes to that run's ids instead, with this
    run's own probabilities there as gates (renormalised as ever), while the
    list still holds the ids this run would have chosen: two paths compared
    so differ by rounding alone, never by a flipped token's whole gate."""
    import torch
    from repro_torch.models import moe
    ids, real = [], moe._top_k

    def spy(probs, k):
        gates, own = real(probs, k)
        ids.append(own.clone())
        if replay is None:
            return gates, own
        if len(ids) > len(replay) or replay[len(ids) - 1].shape != own.shape:
            raise AssertionError(f"routing {len(ids)} {tuple(own.shape)} has no twin in the "
                                 f"replayed run ({len(replay)} routings)")
        forced = replay[len(ids) - 1]
        return torch.gather(probs, -1, forced), forced

    moe._top_k = spy
    try:
        yield ids
    finally:
        moe._top_k = real


def _flips(got: list, want: list) -> int:
    """(token, layer) routing decisions whose top-k expert set differs."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} routings against {len(want)}")
    return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
               for a, b in zip(got, want))


def _print_flips(label: str, flips: dict) -> None:
    """MoE paths: the routing decisions the plain path would have made
    otherwise.  It replays the kernel path's, so none of them enters the
    gated logits, and both logit gates hold as on the dense paths."""
    print(f"{label}: routing decisions (token x MoE layer) whose top-k set differs between "
          f"the bf16 kernel and bf16 plain paths: prefill {flips['prefill']}, decode step "
          f"{flips['decode']} (fp32 kernel vs fp32 plain: "
          f"{flips['fp32, prefill and decode step']}); the plain paths replayed the kernel "
          f"paths' routing")


def _rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / (w.abs().max() + 1e-9))


if __name__ == "__main__":
    sys.exit(main())
