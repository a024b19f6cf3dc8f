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
   computes the same function (CUDA events);
3. drives four paths at full width, with random bf16 weights from a seeded
   generator and ``use_kernels=True``, each through the entry points a user
   calls, freeing each path's weights before the next:
   granite-3-8b serving (40 layers), zamba2-1.2b serving (38 Mamba2
   layers and the shared attention block) and xlstm-1.3b serving, each
   through ``make_lm_predictor`` and the k8s strategy of
   ``InferenceService``; and xlstm-1.3b scoring through ``steps.loss_fn``
   (its full-sequence forward is xlstm's one route to the mLSTM scan).
   Launch counts are zeroed just before each path's run and read just
   after: every kernel of the path's own set must have launched and no
   other.  Every kernel call of one kernel-path prefill and decode step
   (or one scoring run) is recorded, inputs and output, and held against
   its twin on those inputs under the phase-2 rule.  The path's logits
   (prefill and one decode step, or the scoring forward) are compared
   three ways, each gated where the path's readings allow (``PATHS``):
   the bf16 kernel path against the bf16 plain path (granite: <= 2e-2);
   with the same weights cast to fp32, the kernel path against the plain
   path (granite <= 1e-4, zamba2 <= 1e-3); and the bf16 kernel path's
   drift from the fp32 plain path, at most 1.5 times the bf16 plain
   path's (every path).  Random-weight zamba2 and xlstm amplify bf16
   rounding until the two bf16 paths differ by more than any kernel does
   (the reference drifts as far: ``tests/test_torch_drift.py``), and xlstm
   even in fp32, so those comparisons are reported, not gated;
4. prints the kernels' JSON line and, last, the device line.

Any failure raises, and the script exits non-zero without the last line.
Details (every case, ptxas register reports) go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import gc
import json
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
# the bf16 kernel path may drift from the fp32 plain run at most this many
# times as far as the bf16 plain path does on the same weights and tokens
DRIFT_RATIO = 1.5

BATCH, PROMPT, GEN = 4, 128, 16
# (label, arch, run, the kernels that run must launch (no other may launch),
# limits on the logits' rel error of kernel path vs plain path in bf16 and
# with the weights in fp32; None reports without gating).  The fp32 limits
# sit 10-40x above the H100 readings (granite 2.6e-6, zamba2 9.4e-5).
PATHS = (
    ("granite-3-8b serving", "granite_3_8b", "serve",
     ("rmsnorm", "flash_attention", "decode_attention"), TOL, 1e-4),
    ("zamba2-1.2b serving", "zamba2_1_2b", "serve",
     ("rmsnorm", "flash_attention", "decode_attention", "ssm_scan"), None, 1e-3),
    ("xlstm-1.3b serving", "xlstm_1_3b", "serve", ("rmsnorm",), None, None),
    ("xlstm-1.3b scoring", "xlstm_1_3b", "score", ("rmsnorm", "mlstm_scan"), None, None),
)
# kernel -> (route, source, TPU kernel it replaces, path whose shapes its
# entry in the kernels line reports, its wrapper's name in ``ops``).  The
# ``ops`` entry of the kernel's own name, with ``use_kernel=False``, is its
# twin on the wrapper's arguments.
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


def _check(name: str, got, want) -> tuple[float, float]:
    """|kernel - twin| <= TOL |twin| + TOL rms(twin's row), the row being the
    last axis: the reference's bf16 tolerance with its absolute term scaled
    to the row, since attention over L keys gives outputs of size ~L**-0.5.
    Returns the max abs error and the largest share of its allowance any
    element used (1 fails)."""
    import torch
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite")
    err = (g - w).abs()
    row = w.square().mean(dim=-1, keepdim=True).sqrt()
    allowed = (TOL * (w.abs() + row)).clamp_min(1e-12)
    share = float((err / allowed).max())
    if share > 1.0:
        bad = int((err > allowed).sum())
        raise AssertionError(f"{name}: {bad} elements off by more than {TOL}(|twin| + "
                             f"rms row) (max abs err {float(err.max())}, share {share:.3g})")
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


def _flash_case(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q = torch.randn(b, sq, hq, d, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn(b, skv, hkv, d, device="cuda", generator=gen).to(torch.bfloat16)
    off = skv - sq
    qpos = torch.arange(sq, device="cuda")[:, None] + off
    mask = torch.arange(skv, device="cuda")[None, :] <= qpos          # causal, offset
    visible = int(mask.sum())                                        # keys seen, all rows
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return dict(
        shape=f"q ({b},{sq},{hq},{d}) kv ({b},{skv},{hkv},{d}) causal q_offset {off} bf16",
        kernel=lambda: ops.flash_attention(q, k, v, causal=True, q_offset=off, use_kernel=True),
        twin=lambda: ref.flash_attention_ref(q, k, v, causal=True, q_offset=off),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                       enable_gqa=True),
        nbytes=2 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d),
        flops=4 * d * b * hq * visible, peak=BF16_FLOPS)


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
    sequential recurrence's fp32 state work, ~5 P N flops per token and head
    (decay, inject, read-out), and each input and output once."""
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
        flops=5 * b * s * h * p * n, peak=FP32_FLOPS)


def _mlstm_case(b: int, s: int, h: int, d: int, chunk: int, gen):
    """xlstm's scan inputs (bf16 q/k/v, fp32 log gates, forget bias 3).  The
    bound counts the carried state's fp32 work, ~4 D^2 flops per token and
    head (q C^T and the rank-1 update), and each input and output once."""
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
        flops=4 * b * s * h * d * d, peak=FP32_FLOPS)


def _run_case(name: str, case: dict, iters: int) -> dict:
    got, want = case["kernel"](), case["twin"]()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    checks = [_check(f"{name} output {i}", g, w) for i, (g, w) in enumerate(zip(got, want))]
    bound, by = _bound_ms(case["nbytes"], case["flops"], case["peak"])
    lib = case["library"]
    return {"kernel": name, "shape": case["shape"],
            "max_abs_err": max(e for e, _ in checks), "tol_share": max(t for _, t in checks),
            "ms": _cuda_ms(case["kernel"], iters),
            "plain_ms": _cuda_ms(case["twin"], max(iters // 4, 2)),
            "library_ms": _cuda_ms(lib, iters) if lib is not None else None,
            "bound_ms": bound, "bound_by": by}


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
    report["build"] = {src: {"s": s, "ptxas": log} for src, (s, log) in built.items()}
    for src, (s, log) in built.items():
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"built {src} in {s:.1f} s: " + " | ".join(usage))
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
    cache_len = PROMPT + GEN + 1
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
        "xlstm-1.3b scoring": {
            "rmsnorm": (_rmsnorm_case(rows, xl.d_model, gen), 50),
            "mlstm_scan": (_mlstm_case(BATCH, PROMPT, xl.n_heads, xhd, xl.ssm_chunk, gen), 20)},
    }
    cases = [_run_case(n, c, it) for n, c, it in long_cases]
    path = {label: {n: _run_case(n, c, it) for n, (c, it) in per.items()}
            for label, per in path_cases.items()}
    for r in cases + [r for per in path.values() for r in per.values()]:
        print(f"{r['kernel']:<17} {r['shape']}: err {r['max_abs_err']:.3g} "
              f"({r['tol_share']:.3g} of its tolerance) kernel "
              f"{r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms, library {_fmt_ms(r['library_ms'])}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  [{card}]")
    report["cases"], report["path_cases"] = cases, path
    del long_cases, path_cases
    torch.cuda.empty_cache()

    # -- phase 3: the paths, full width --------------------------------------
    report["paths"] = {}
    for label, arch, run, expected, bf16_limit, fp32_limit in PATHS:
        cfg = registry.get_config(arch).replace(use_kernels=True)
        limits = {"bf16_kernel_vs_plain": bf16_limit, "kernel_vs_plain": fp32_limit}
        res = (_serve_path if run == "serve" else _score_path)(cfg, label, expected, limits,
                                                               card)
        report["paths"][label] = res
        gc.collect()
        torch.cuda.empty_cache()

    # -- phase 4: report -----------------------------------------------------
    totals = {n: sum(r["launches_run"][n] for r in report["paths"].values()) for n in META}
    kernels = []
    for n, (route, src, rep, label, _) in META.items():
        r = path[label][n]
        kernels.append({"name": n, "route": route, "source": src, "replaces": rep,
                        "launches": totals[n], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print("kernels launched on the paths' runs: " + ", ".join(f"{n} x{totals[n]}" for n in META))
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


@contextlib.contextmanager
def _recording(names):
    """Record every call of the named kernels' wrappers made through ``ops``
    inside the block: copies of the arguments and of the result."""
    from repro_torch.kernels import ops
    calls: dict = {n: [] for n in names}
    saved = {n: getattr(ops, META[n][4]) for n in names}

    def copy(v):
        if isinstance(v, tuple):
            return tuple(copy(t) for t in v)
        return v.clone() if hasattr(v, "clone") else v

    def recorder(n, wrapper):
        def call(*args, **kw):
            out = wrapper(*args, **kw)
            calls[n].append((copy(args), {k: copy(v) for k, v in kw.items()}, copy(out)))
            return out
        return call

    for n, wrapper in saved.items():
        setattr(ops, META[n][4], recorder(n, wrapper))
    try:
        yield calls
    finally:
        for n, wrapper in saved.items():
            setattr(ops, META[n][4], wrapper)


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
                e, sh = _check(f"{label}: {n} call {i} output {j} (recorded)", g, w)
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
    """Serve ``cfg`` through make_lm_predictor and the k8s strategy, time one
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
            "k8s": summary}


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
