#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports only the port
(``src/repro_torch``), never JAX or the reference package, and:

1. prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and compiles the Triton RMSNorm;
2. holds every kernel against its plain PyTorch twin on the card, in bf16,
   at granite-3-8b's shapes (long-context cases, and the shapes the
   serving run below gives each kernel), with the reference's tolerance
   scaled to each row, |kernel - twin| <= 2e-2 (|twin| + rms of the twin's
   row), and times kernel, twin and the one PyTorch call that computes the
   same function (CUDA events);
3. serves the FULL-width granite-3-8b (40 layers, random bf16 weights from a
   seeded generator) through ``make_lm_predictor`` and the k8s strategy of
   ``InferenceService``, with ``use_kernels=True``; launch counts are zeroed
   just before the served run and read just after, and every kernel must
   have launched; the prefill's and one decode step's logits are held
   against the plain path on the same weights (relative error <= 2e-2),
   and both paths against the same weights run in fp32: the kernel path may
   drift from it at most 1.5 times as far as the plain path;
4. prints the kernels' JSON line and, last, the device line.

Any failure raises, and the script exits non-zero without the last line.
Details (every case, ptxas register reports) go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

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
# the kernel path may drift from the fp32 run at most this many times as far
# as the plain path does on the same weights and tokens
DRIFT_RATIO = 1.5

ARCH = "granite_3_8b"
BATCH, PROMPT, GEN = 4, 128, 16


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


def _run_case(name: str, case: dict, iters: int) -> dict:
    err, share = _check(name, case["kernel"](), case["twin"]())
    bound, by = _bound_ms(case["nbytes"], case["flops"], case["peak"])
    return {"kernel": name, "shape": case["shape"], "max_abs_err": err, "tol_share": share,
            "ms": _cuda_ms(case["kernel"], iters),
            "plain_ms": _cuda_ms(case["twin"], max(iters // 4, 2)),
            "library_ms": _cuda_ms(case["library"], iters),
            "bound_ms": bound, "bound_by": by}


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
    from repro_torch.launch.serve import make_lm_predictor
    from repro_torch.models import lm, steps
    from repro_torch.clouds.profiles import get_profile
    from repro_torch.serving.kserve import InferenceService

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
    cfg = registry.get_config(ARCH).replace(use_kernels=True)
    hq, hkv, d, dm = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    cache_len = PROMPT + GEN + 1
    long_cases = [
        ("rmsnorm", _rmsnorm_case(4096, dm, gen), 50),
        ("flash_attention", _flash_case(1, 2048, 2048, hq, hkv, d, gen), 10),
        ("flash_attention", _flash_case(1, 1000, 1500, hq, hkv, d, gen), 10),
        ("decode_attention", _decode_case([4096, 2048, 1, 3000, 17, 4095, 64, 1024],
                                          4096, hq, hkv, d, gen), 20),
    ]
    # the shapes the serving run below gives each kernel
    path_cases = {
        "rmsnorm": (_rmsnorm_case(BATCH * PROMPT, dm, gen), 50),
        "flash_attention": (_flash_case(BATCH, PROMPT, PROMPT, hq, hkv, d, gen), 20),
        "decode_attention": (_decode_case([PROMPT + 1] * BATCH, cache_len, hq, hkv, d, gen), 50),
    }
    cases = [_run_case(n, c, it) for n, c, it in long_cases]
    path = {n: _run_case(n, c, it) for n, (c, it) in path_cases.items()}
    for r in cases + list(path.values()):
        print(f"{r['kernel']:<17} {r['shape']}: err {r['max_abs_err']:.3g} "
              f"({r['tol_share']:.3g} of its tolerance) kernel "
              f"{r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  [{card}]")
    report["cases"], report["path_cases"] = cases, path
    del long_cases, path_cases
    torch.cuda.empty_cache()

    # -- phase 3: full-width serving -----------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    pred = make_lm_predictor(cfg, gen_tokens=GEN, prompt_len=PROMPT, params=params)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=torch.Generator()
                            .manual_seed(1), dtype=torch.int32).numpy()

    native.reset_launches()
    toks = pred.predict(prompts)
    svc = InferenceService(pred, get_profile("k8s"), "k8s").stress_test(4)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    if toks.shape != (BATCH, GEN) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"generated tokens out of range / shape {tuple(toks.shape)}")
    summary = svc.summary()
    print(f"served {summary['n']} requests (k8s strategy): p50 {summary['p50_s']} s; "
          f"launches {launches}")

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
        _, _ = steps.greedy_decode_loop(params, cache, first, start, GEN, cfg=cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / GEN
        per["decode_step"] = {k: n // GEN for k, n in native.LAUNCHES.items()}
        if not bool(torch.isfinite(last_k.float()).all()):
            raise AssertionError("prefill logits not finite")
        # kernel path vs plain path on the same weights
        plain = cfg.replace(use_kernels=False)
        last_p, cache_p = steps.prefill(params, batch, cfg=plain, cache_len=cache_len)
        _, cache_k = steps.prefill(params, batch, cfg=cfg, cache_len=cache_len)
        step_k, _ = lm.decode_step(params, cfg, first, start, cache_k)
        step_p, _ = lm.decode_step(params, plain, first, start, cache_p)
        del cache_k, cache_p
        if not bool(torch.isfinite(step_k.float()).all()):
            raise AssertionError("decode-step logits not finite")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # the same weights in fp32 on the plain path: the yardstick both bf16 paths
    # are held against, so the gate below sits on the bf16 rounding drift of
    # this run rather than on a fixed number
    with torch.inference_mode():
        params32 = _cast(params, torch.float32)
        cfg32 = cfg.replace(dtype="float32", use_kernels=False)
        last_x, cache_x = steps.prefill(params32, batch, cfg=cfg32, cache_len=cache_len)
        step_x, _ = lm.decode_step(params32, cfg32, first, start, cache_x)
        del params32, cache_x
    rel = {phase: {"kernel_vs_plain": _rel(k, p), "kernel_vs_fp32": _rel(k, x),
                   "plain_vs_fp32": _rel(p, x)}
           for phase, (k, p, x) in {"prefill": (last_k, last_p, last_x),
                                    "decode": (step_k, step_p, step_x)}.items()}
    for phase, r in rel.items():
        r["ratio"] = r["kernel_vs_fp32"] / max(r["plain_vs_fp32"], 1e-12)
        if r["kernel_vs_plain"] > TOL or r["ratio"] > DRIFT_RATIO:
            raise AssertionError(
                f"{phase} logits: kernel path vs plain path rel {r['kernel_vs_plain']} "
                f"(limit {TOL}); kernel path {r['kernel_vs_fp32']} and plain path "
                f"{r['plain_vs_fp32']} from fp32, ratio {r['ratio']} (limit {DRIFT_RATIO})")
    serving = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
               "batch": BATCH, "prompt": PROMPT, "gen": GEN, "init_s": init_s,
               "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
               "peak_gib": peak_gib, "rel": rel,
               "launches_served_run": launches, "launches_per": per, "k8s": summary}
    report["serving"] = serving
    print(f"granite-3-8b full width ({n_params / 1e9:.2f} B params, bf16): batch {BATCH} "
          f"prompt {PROMPT}: prefill {prefill_ms:.2f} ms, decode {decode_ms:.2f} ms/token, "
          f"peak {peak_gib:.2f} GiB; launches per prefill {per['prefill']}, "
          f"per decode step {per['decode_step']}  [{card}]")
    for phase, r in rel.items():
        print(f"{phase} logits: kernel vs plain rel {r['kernel_vs_plain']:.4g} (limit {TOL}); "
              f"from fp32: kernel path {r['kernel_vs_fp32']:.4g}, plain path "
              f"{r['plain_vs_fp32']:.4g}, ratio {r['ratio']:.4g} (limit {DRIFT_RATIO})")

    # -- phase 4: report -----------------------------------------------------
    meta = {
        "rmsnorm": ("triton", "src/repro_torch/kernels/_rmsnorm_triton.py",
                    "src/repro/kernels/rmsnorm.py:36"),
        "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:85"),
        "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:86"),
    }
    kernels = [{"name": n, "route": r, "source": s, "replaces": rep,
                "launches": launches[n], "max_abs_err": path[n]["max_abs_err"],
                "ms": path[n]["ms"], "plain_ms": path[n]["plain_ms"],
                "bound_ms": path[n]["bound_ms"], "bound_by": path[n]["bound_by"],
                "library_ms": path[n]["library_ms"]} for n, (r, s, rep) in meta.items()]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print("kernels launched on the serving path: " +
          ", ".join(f"{n} x{launches[n]}" for n in meta))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


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
