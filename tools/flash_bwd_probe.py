#!/usr/bin/env python3
"""The flash attention backward kernel on the card, beyond ``chip_smoke.py``.

    python3 tools/flash_bwd_probe.py [--arch granite_3_8b]

Prints, for the card it runs on:

- the device time of each of the backward's two kernels (dQ, dK/dV) at
  granite's training shape and at h2o's window (with ``--arch`` gemma3_4b
  or deepseek_v2_lite_16b: at that arch's training shape), from a
  ``torch.profiler`` trace of five calls;
- the share of the card's rule (``chip_smoke._check``: |kernel - twin| <=
  2e-2 (|twin| + rms of the twin's row), the row's rms floored at
  ``BWD_FLOOR`` of the twin's largest) that dq, dk and dv use on each of the
  recorded calls of one training step (granite: 8 layers, 4 x 1024 tokens,
  the seeded weights and batch of ``chip_smoke.py``'s training leg; gemma3
  and deepseek: their ``WIDE_ARCHS`` depth and batch, as the wide-head
  training leg), with the worst element, beside the share of each rounding
  order of ``ORDERS`` (past head dim 128 also ``WIDE_ORDERS``) emulated on
  the same inputs by ``ref.flash_attention_bwd_order_ref`` (the kernel's
  first).

Run it on the machine with the card.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# name -> flags of ref.flash_attention_bwd_order_ref: the kernel's order and
# the ones it was chosen against
ORDERS = {
    "kernel's order": {},
    "PR 20's (sum P dP everywhere, not centred)": {"delta": "sum_p_dp", "centre": "none"},
    "O32 in every block": {"exact_delta_tiles": 0},
    "O32 over l in every block": {"delta": "o32_by_l", "exact_delta_tiles": 0},
    "exact Delta where the band spans 1 tile": {"exact_delta_tiles": 1},
    "centred on the first key tile": {"centre": "first"},
    "centred on the diagonal key tile": {"centre": "diagonal"},
    "centred on the row's P-weighted mean": {"centre": "weighted"},
    "one bf16 dS in dQ": {"split_dq": False},
    "one bf16 dS in dK": {"split_dk": False},
    "the first build (O32 everywhere, first tile, one bf16 dS in dK)":
        {"exact_delta_tiles": 0, "centre": "first", "split_dk": False},
}
# past head dim 128 (32-key tiles), where the kernel takes Delta from its
# first sweep in every block: the D <= 128 tiles' rule instead
WIDE_ORDERS = {"Delta from O32 past 256 keys": {"exact_delta_tiles": 8}}


def _share(got, want) -> tuple:
    """(share, worst index, kernel value, twin value, the row's rms)."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    row = w.square().mean(dim=-1, keepdim=True).sqrt()
    row = torch.clamp(row, min=float(cs.BWD_FLOOR / cs.TOL * w.abs().max()))
    ratio = err / (cs.TOL * (w.abs() + row)).clamp_min(1e-12)
    at = tuple(int(i) for i in torch.unravel_index(torch.argmax(ratio), ratio.shape))
    return float(ratio.max()), at, float(g[at]), float(w[at]), float(row[at[:-1]])


def kernel_split(case: dict, iters: int = 5) -> dict:
    """Device ms per call of each device kernel ``case["kernel"]`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    case["kernel"]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            case["kernel"]()
        torch.cuda.synchronize()
    by: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("<")[0].split("::")[-1]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / iters / 1e3
    return by


def recorded_calls(arch: str):
    """The flash backward's calls in one training step's backward."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.tokens import lm_batches
    from repro_torch.models import lm, steps
    from repro_torch.optim import adamw
    layers, b, s = cs.WIDE_ARCHS.get(arch, (cs.TRAIN_LAYERS, cs.TRAIN_BATCH, cs.TRAIN_SEQ))
    cfg = registry.get_config(arch).replace(n_layers=layers, use_kernels=True)
    batch = next(lm_batches(cfg, b, s, seed=3))
    batch = {k: torch.as_tensor(batch[k], device="cuda") for k in ("tokens", "labels")}
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    with cs._recording(("flash_attention_bwd",)) as calls:
        leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = steps.loss_fn(leaves, cfg, batch)
        torch.autograd.grad(loss, adamw.tree_leaves(leaves))
    return calls["flash_attention_bwd"]


def main(argv: list[str]) -> int:
    import argparse

    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.kernels import ref
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="granite_3_8b")
    arch = parser.parse_args(argv).arch
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = registry.get_config(arch)
    if arch in cs.WIDE_ARCHS:
        _, b, s = cs.WIDE_ARCHS[arch]
        d = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim
        wide = dict(window=cfg.sliding_window) if "local" in cfg.block_pattern else \
            dict(dv=cfg.v_head_dim)
        cases = ((f"{arch} training ({b},{s}), D {d}, {cfg.n_heads}/{cfg.n_kv_heads} heads, {wide}",
                  cs._flash_bwd_case(b, s, cfg.n_heads, cfg.n_kv_heads, d, gen, **wide)),)
    else:
        cases = (("granite training (4,1024), D 128, 32/8 heads",
                  cs._flash_bwd_case(4, 1024, 32, 8, 128, gen)),
                 ("h2o (1,2048), D 120, window 512",
                  cs._flash_bwd_case(1, 2048, 32, 8, 120, gen, window=512)))
    for label, case in cases:
        split = kernel_split(case)
        print(f"{label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
              + f", total {sum(split.values()):.4f} ms  [{card}]", flush=True)
        del case
    del cases
    torch.cuda.empty_cache()
    orders = {**ORDERS, **(WIDE_ORDERS if arch in cs.WIDE_ARCHS else {})}
    worst = {n: 0.0 for n in orders}
    for i, (args, kw, got) in enumerate(recorded_calls(arch)):
        q, k, v, do = args[:4]
        want = ref.flash_attention_bwd_ref(q, k, v, do, **kw)
        print(f"call {i}: kernel " + "; ".join(
            f"{n} {s[0]:.3f} at {s[1]} (kernel {s[2]:.3g}, twin {s[3]:.3g}, row rms {s[4]:.3g})"
            for n, s in zip(("dq", "dk", "dv"), (_share(g, w) for g, w in zip(got, want)))),
            flush=True)
        for name, flags in orders.items():
            emu = ref.flash_attention_bwd_order_ref(q, k, v, do, **kw, **flags)
            shares = [_share(g, w)[0] for g, w in zip(emu, want)]
            worst[name] = max(worst[name], *shares)
            print(f"  emulated, {name}: dq {shares[0]:.3f} dk {shares[1]:.3f} dv {shares[2]:.3f}",
                  flush=True)
            del emu
        del want
        torch.cuda.empty_cache()
    print("emulated orders, largest share over the calls: "
          + "; ".join(f"{n} {w:.3f}" for n, w in worst.items()) + f"  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
