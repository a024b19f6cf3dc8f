#!/usr/bin/env python3
"""The mLSTM scan's backward kernel on the card, beyond ``chip_smoke.py``.

    python3 tools/mlstm_bwd_probe.py

Builds ``csrc/mlstm_scan_bwd.cu`` alone with ``-Xptxas -v`` and prints each
instantiation's registers and spills and the tensor-core instructions of its
SASS; holds the bf16 kernel at head dim 512 against its twin
(``ref.mlstm_scan_bwd_ref``) at four small shapes, one head's rows under the
denominator's floor, under ``chip_smoke``'s backward rule (``_check`` with
``BWD_FLOOR``); checks two calls at xlstm's training shape for bit-equality;
and times the kernel at q (4,512,4,512), (4,256,2,512) and (1,4096,4,512)
with ``chip_smoke._run_case`` (device ms, event ms, the rule's share, the
bound, each device kernel's ms a call).  Run it on the machine with the
card.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.clouds.profiles import hardware_for  # noqa: E402
from repro_torch.kernels import native, ops, ref  # noqa: E402

src = "mlstm_scan_bwd.cu"
out = native.library_path(src)
out.parent.mkdir(parents=True, exist_ok=True)
t0 = time.time()
p = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-Xptxas=-v", "-o", str(out),
                    str(native.CSRC / src)], capture_output=True, text=True)
print(f"nvcc {time.time() - t0:.1f} s rc {p.returncode}", flush=True)
log = p.stdout + p.stderr
if p.returncode:
    print(log[-12000:])
    sys.exit(1)
for u in cs._ptxas_usage(log):
    print("ptxas", u)
for ln in log.splitlines():
    if "wgmma" in ln.lower() or "warning" in ln.lower():
        print(ln)
counts = cs._mma_counts(out) or {}
for k, c in sorted(counts.items()):
    print("sass", k, c)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, flush=True)
gen = torch.Generator(device="cuda").manual_seed(0)


def inputs(b, s, h, d):
    q, k, v, dy = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    li = torch.randn(b, s, h, device="cuda", generator=gen) * 0.5
    li[:, :, 0] -= 30.0
    lf = torch.nn.functional.logsigmoid(torch.randn(b, s, h, device="cuda", generator=gen) + 2.0)
    return q, k, v, li, lf, dy


for shape in [(1, 70, 1, 512), (2, 200, 3, 512), (1, 64, 2, 512), (2, 300, 4, 512)]:
    args = inputs(*shape)
    got = ops.mlstm_scan_bwd(*args, use_kernel=True)
    torch.cuda.synchronize()
    want = ref.mlstm_scan_bwd_ref(*args, chunk=64)
    rel = [float((g.float() - w.float()).abs().max() / w.float().abs().max()) for g, w in zip(got, want)]
    shares = []
    for i, (g, w) in enumerate(zip(got, want)):
        try:
            shares.append(round(cs._check(f"{shape} out {i}", g, w, cs.BWD_FLOOR)[1], 3))
        except AssertionError as e:
            shares.append(f"FAIL {e}"[:300])
    print("check", shape, "rel", [f"{r:.2e}" for r in rel], "shares", shares, flush=True)
args = inputs(4, 512, 4, 512)
a1 = ops.mlstm_scan_bwd(*args, use_kernel=True)
a2 = ops.mlstm_scan_bwd(*args, use_kernel=True)
torch.cuda.synchronize()
print("bit-equal at the training shape:", all(torch.equal(x, y) for x, y in zip(a1, a2)))
hw = hardware_for(torch.cuda.get_device_name(0))
for b, s, h in [(4, 512, 4), (4, 256, 2), (1, 4096, 4)]:
    case = cs._mlstm_bwd_case(b, s, h, 512, 256, gen)
    r = cs._run_case("mlstm_scan_bwd", case, 5, hw)
    print(f"time q ({b},{s},{h},512): device {r['device_ms']:.4f} ms, event {r['ms']:.4f}, "
          f"share {r['tol_share']:.3f}, bound {r['bound_ms']:.4f}, kernels {r['device_kernels_per_call']}, "
          + "; ".join(f"{cs._pass_name(n)} {ms:.4f}" for n, ms in r["device_kernels"].items())
          + f"  [{card}]", flush=True)
