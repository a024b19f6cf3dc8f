#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against each other on one card.

    python3 tools/kernel_variants.py tools/kernel_variants_attention.json
    python3 tools/kernel_variants.py tools/kernel_variants_scans.json
    python3 tools/kernel_variants.py tools/kernel_variants_bwd_wide.json
    python3 tools/kernel_variants.py tools/kernel_variants_ssm_bwd.json
    python3 tools/kernel_variants.py tools/kernel_variants_mlstm_bwd.json

A spec names, per source in ``src/repro_torch/kernels/csrc``, a list of
variants: each is a name and a list of ``[old, new]`` text substitutions
applied to a copy of the source (an empty list is the source as it
stands), and for decode attention the wrapper's ``SPLIT_KEYS``, or an
object ``{"git": revision}``: the source as that commit has it (``git
show``, kept under ``.torch_ext_build/variants/git/``; run ``--prepare``
where git is, before a run on a machine without the repository's
history), so an older design is timed in the same run.  Every
variant is built with the port's own nvcc flags into
``.torch_ext_build/variants/``, loaded in place of the source's
library, held against its plain twin (a variant whose result is wrong is
marked so and still timed) and timed by device time per call
(``chip_smoke._device_ms``) at the long and serving cases of
``chip_smoke.py`` (attention, and the two scans: their serving shapes and
S 4096 and 1000; the attention backward at granite's training shape and
h2o's window, and past head dim 128 at gemma3's and deepseek's training
shapes; the scan's backward at zamba2's training shape, a tensor-parallel
rank's 16 heads, S 1000 and S 4096; the mLSTM scan's backward at xlstm's
training shape, a rank's 2 heads and S 4096).  The library call's device time is printed beside each
case (the backward's, autograd of SDPA, by CUDA events: a trace of it
may see no device activity and a CUDA graph cannot capture it).  Run it
on the machine with the card; compare variants only within one run.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import decode_attention as decode_mod  # noqa: E402
from repro_torch.kernels import native  # noqa: E402

OUT = native.BUILD_DIR / "variants"


def variant_dir(name: str) -> Path:
    return OUT / re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")


def git_source(src: str, rev: str) -> Path:
    """``src`` as commit ``rev`` has it, fetched once with ``git show``."""
    path = OUT / "git" / rev / src
    if not path.is_file():
        rel = (native.CSRC / src).relative_to(ROOT).as_posix()
        text = subprocess.run(["git", "show", f"{rev}:{rel}"], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return path


def make_variant(src: str, name: str, subs: list, rev: str | None = None) -> Path:
    text = (git_source(src, rev) if rev else native.CSRC / src).read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: text not found in {src}: {old!r}")
        text = text.replace(old, new)
    d = variant_dir(name)
    d.mkdir(parents=True, exist_ok=True)
    for header in native.CSRC.glob("*.cuh"):
        (d / header.name).write_text(header.read_text())
    (d / src).write_text(text)
    return d / src


def build(paths: list[Path]) -> None:
    """One nvcc per variant, all started together; print each build's
    register and spill report."""
    procs = {p: subprocess.Popen([native._nvcc(), *native.NVCC_FLAGS, "-Xptxas=-v", "-o",
                                  str(p.with_suffix(".so")), str(p)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p in paths}
    for p, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{p.parent.name}: nvcc exited {proc.returncode}\n{log}")
        usage = [ln.strip().removeprefix("ptxas info    : ") for ln in log.splitlines()
                 if "registers" in ln or ("spill" in ln and " 0 bytes spill" not in ln)
                 or "wgmma" in ln]
        print(f"{p.parent.name}: " + " | ".join(usage))


def load(path: Path, src: str):
    """Route ``native.function`` for ``src`` to the variant's library;
    returns the original to restore."""
    lib = ctypes.CDLL(str(path.with_suffix(".so")))
    real = native.function

    def function(s, name, argtypes, restype=ctypes.c_int):
        if s != src:
            return real(s, name, argtypes, restype)
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
        return fn

    native.function = function
    return real


def cases(gen) -> dict:
    """Per source, a function that makes its cases (only the sources a spec
    names are made)."""
    long_lens = [4096, 2048, 1, 3000, 17, 4095, 64, 1024]
    serve = [cs.PROMPT + 1] * cs.BATCH
    ssm = dict(h=32, p=128, n=64, chunk=256)        # zamba2-1.2b
    mlstm = dict(h=4, d=512, chunk=256)             # xlstm-1.3b
    half = dict(ssm, h=16)                          # a tensor-parallel rank's heads
    return {
        "mlstm_scan_bwd.cu": lambda: [
            ("q (4,512,4,512), xlstm training", cs._mlstm_bwd_case(4, 512, gen=gen, **mlstm), 5),
            ("q (4,256,2,512), 2 heads", cs._mlstm_bwd_case(4, 256, gen=gen, **dict(mlstm, h=2)),
             5),
            ("q (1,4096,4,512)", cs._mlstm_bwd_case(1, 4096, gen=gen, **mlstm), 3)],
        "ssm_scan_bwd.cu": lambda: [
            ("x (4,1024), zamba2 training",
             cs._ssm_bwd_case(cs.TRAIN_BATCH, cs.TRAIN_SEQ, gen=gen, **ssm), 5),
            ("x (4,1024), 16 heads", cs._ssm_bwd_case(cs.TRAIN_BATCH, cs.TRAIN_SEQ, gen=gen,
                                                      **half), 5),
            ("x (1,1000)", cs._ssm_bwd_case(1, 1000, gen=gen, **ssm), 5),
            ("x (1,4096)", cs._ssm_bwd_case(1, 4096, gen=gen, **ssm), 5)],
        "ssm_scan.cu": lambda: [
            ("x (4,128), zamba2", cs._ssm_case(cs.BATCH, cs.PROMPT, gen=gen, **ssm), 20),
            ("x (1,4096)", cs._ssm_case(1, 4096, gen=gen, **ssm), 10),
            ("x (1,1000)", cs._ssm_case(1, 1000, gen=gen, **ssm), 10)],
        "mlstm_scan.cu": lambda: [
            ("q (4,128), xlstm", cs._mlstm_case(cs.BATCH, cs.PROMPT, gen=gen, **mlstm), 20),
            ("q (1,4096)", cs._mlstm_case(1, 4096, gen=gen, **mlstm), 5),
            ("q (1,1000)", cs._mlstm_case(1, 1000, gen=gen, **mlstm), 5)],
        "flash_attention.cu": lambda: [
            ("q 2048, D 128, 32/8 heads", cs._flash_case(1, 2048, 2048, 32, 8, 128, gen), 10),
            ("q 1000 / kv 1500, D 128", cs._flash_case(1, 1000, 1500, 32, 8, 128, gen), 10),
            ("q 2048, D 64, 32/32 heads", cs._flash_case(1, 2048, 2048, 32, 32, 64, gen), 10),
            ("q (4,128), D 128", cs._flash_case(4, 128, 128, 32, 8, 128, gen), 20)],
        "flash_attention_bwd.cu": lambda: [
            ("q (4,1024), D 128, 32/8 heads, granite training",
             cs._flash_bwd_case(4, 1024, 32, 8, 128, gen), 5),
            ("q (1,2048), D 120, window 512, h2o",
             cs._flash_bwd_case(1, 2048, 32, 8, 120, gen, window=512), 5),
            ("q (2,2048), D 320, 8/4 heads, window 1024, gemma3 training",
             cs._flash_bwd_case(2, 2048, 8, 4, 320, gen, window=1024), 5),
            ("q (4,1024), D 192, v 128 padded, 16/16 heads, deepseek training",
             cs._flash_bwd_case(4, 1024, 16, 16, 192, gen, dv=128), 5)],
        "decode_attention.cu": lambda: [
            ("B 8 x 4096, D 128, 32/8 heads", cs._decode_case(long_lens, 4096, 32, 8, 128, gen), 20),
            ("B 8 x 4096, D 64, 32/32 heads", cs._decode_case(long_lens, 4096, 32, 32, 64, gen), 20),
            ("B 4 x 145, D 128", cs._decode_case(serve, 145, 32, 8, 128, gen), 50),
            ("B 4 x 145, D 64", cs._decode_case(serve, 145, 32, 32, 64, gen), 50)]}


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available() and argv[1:] != ["--prepare"]:
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    spec = json.loads(Path(argv[0]).read_text())
    revs = [(src, v[2]["git"]) for src, vs in spec.items() for v in vs
            if len(v) > 2 and isinstance(v[2], dict)]
    if argv[1:] == ["--prepare"]:
        for src, rev in revs:
            print(git_source(src, rev))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    runs = [(src, v[0], v[1], v[2] if len(v) > 2 else None) for src, vs in spec.items() for v in vs]
    build([make_variant(src, name, subs, opt["git"] if isinstance(opt, dict) else None)
           for src, name, subs, opt in runs])
    table = {src: make() for src, make in cases(torch.Generator(device="cuda").manual_seed(0)).items()
             if src in spec}
    for src, per in table.items():
        for label, case, iters in per:
            case["library_device_ms"] = (
                cs._device_ms(case["library"], iters, case.get("capturable", True))[0]
                if case["library"] is not None else None)
    split_default = decode_mod.SPLIT_KEYS
    for src, name, _, opt in runs:
        split_keys = None if isinstance(opt, dict) else opt
        real = load(variant_dir(name) / src, src)
        if split_keys is not None:
            decode_mod.SPLIT_KEYS = split_keys
        row = []
        for label, case, iters in table[src]:
            got, want = case["kernel"](), case["twin"]()
            pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
            try:
                share = max(cs._check(label, g, w, case.get("floor", 0.0))[1] for g, w in pairs)
                share = f"{share:.2f}"
            except AssertionError:
                share = "WRONG"
            ms = cs._device_ms(case["kernel"], iters)[0]
            row.append(f"{label}: {ms:.4f} ms (library {cs._fmt_ms(case['library_device_ms'])}, "
                       f"tolerance share {share})")
        native.function = real
        decode_mod.SPLIT_KEYS = split_default
        kc = f", SPLIT_KEYS {split_keys}" if split_keys is not None else ""
        print(f"{name}{kc}: " + "; ".join(row) + f"  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
