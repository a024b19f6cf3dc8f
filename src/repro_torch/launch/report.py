"""Render the dry-run's records (experiments/torch_dryrun/*.json) of one
mesh as markdown tables.  The port's copy of ``repro.launch.report``; a
record carries the port's fields (``count_s``, ``counted``, ``memory``)
where the reference's carries XLA's (``lower_s``, ``compile_s``), and its
``collectives`` as ``launch/count.py`` counts them (on one card none run).
Every number is a card's.

  python -m repro_torch.launch.report [--dir experiments/torch_dryrun] [--mesh single|pod|multi]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dryrun_dir: str, mesh: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, f"*_{mesh}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _fmt(x, digits=4):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    return f"{x:.{digits}g}"


def roofline_table(recs: list[dict]) -> str:
    hdr = ("| arch | shape | status | compute_s | memory_s | collective_s | "
           "bound_s | dominant | useful_ratio | memory (GB, fits one card) |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | skipped "
                         f"({r['reason'][:40]}...) |" + " - |" * 7)
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR |" + " - |" * 7)
            continue
        t, m = r["roofline"], r["memory"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {_fmt(t['compute_s'])} | "
            f"{_fmt(t['memory_s'])} | {_fmt(t['collective_s'])} | "
            f"{_fmt(t['bound_s'])} | **{t['dominant']}** | "
            f"{_fmt(r.get('useful_flops_ratio'), 3)} | "
            f"{_fmt(m['total_bytes'] / 1e9, 4)} ({'yes' if m['fits'] else 'no'}) |")
    return "\n".join(lines)


def dryrun_table(recs: list[dict]) -> str:
    hdr = ("| arch | shape | status | chips | count_s | flops/chip | bytes/chip | "
           "collective bytes/chip | dominant | aten ops |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in recs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['status']} |" + " - |" * 7)
            continue
        t = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['chips']} | {r['count_s']} | "
            f"{_fmt(t['flops'], 4)} | {_fmt(t['bytes_accessed'], 4)} | "
            f"{_fmt(t['coll_bytes'], 4)} | {t['dominant']} | {r['counted']['ops']} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/torch_dryrun")
    ap.add_argument("--mesh", choices=("single", "pod", "multi"), default="single")
    ap.add_argument("--kind", choices=("roofline", "dryrun"), default="roofline")
    args = ap.parse_args(argv)
    recs = load(args.dir, args.mesh)
    print((roofline_table if args.kind == "roofline" else dryrun_table)(recs))


if __name__ == "__main__":
    main()
