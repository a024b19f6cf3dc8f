"""Dry-run on one card: count every (arch x input shape) step with no real
allocation, and write its roofline record.  Twin of
``repro.launch.dryrun`` for a single H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The parameters (and, to train, the optimizer state), the batch or the
decode cache are built on ``meta``: shapes and dtypes, no bytes, no card.
One ``steps.train_step``, one ``steps.prefill`` or one ``steps.serve_step``
against a full cache runs on them under ``launch/count.py`` on the plain
path, and the counts become the roofline terms over ``H100_SXM``.
``fused_attn`` puts attention on ``ops.flash_chunked``, which holds no
whole (Sq, Skv) score matrix at a time; it does the same products, and its
eager chunks write every score once, so the counts barely move.  The
reference lowers and compiles the same steps with XLA and reads its cost
analysis instead; its production meshes have no counterpart here yet, so
``mesh_kind="multi"`` raises (ROADMAP.md queue 1 item 1.14).  Records go to
``experiments/torch_dryrun/<arch>_<shape>_<mesh>.json``;
``launch/report.py`` renders them.

xlstm's sLSTM steps token by token: counted eagerly at 32k tokens that
loop would run for many minutes, even on ``meta``.  Its steps are
identical, so the dry-run runs the first step, lets its output stand for
every step's, and adds the other S - 1 steps' recurrent products in closed
form (``roofline.slstm_correction_flops``); the record's ``slstm`` says so.
Those steps' bytes are not counted.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from unittest import mock

import torch

from ..clouds.profiles import H100_SXM
from ..configs import registry
from ..models import lm, ssm, steps
from ..optim import adamw
from . import roofline
from .count import count


def _shape_cfg(cfg, shape):
    """Shape-specific config: bf16 compute; the decode budget."""
    cfg = cfg.replace(dtype="bfloat16")
    if shape.kind == "decode":
        cfg = cfg.replace(max_decode_len=shape.seq_len)
    return cfg


def _serve_step(params, cache, tokens, positions, *, cfg):
    """``steps.serve_step`` on weights cast to the compute dtype first, as
    the reference's decode casts them every call (``lm.forward`` casts for
    prefill and training); weights already in it pass through."""
    return steps.serve_step(lm._cast_tree(params, cfg.compute_dtype), cache, tokens,
                            positions, cfg=cfg)


def build(cfg, shape, *, device="meta", serve_bf16: bool = False):
    """One shape's counted call on ``device``: (fn, args, kwargs, held),
    ``held`` naming the trees the step holds in device memory (params,
    optimizer state, batch or cache).  Parameters are ``cfg.param_dtype``
    (fp32 masters, cast every call, as the reference's dry-run holds them),
    or for serving with ``serve_bf16`` the compute dtype (the port's
    serving entry points hold them so from load on)."""
    b, s = shape.global_batch, shape.seq_len
    serve = shape.kind != "train"
    pdtype = cfg.compute_dtype if serve and serve_bf16 else getattr(torch, cfg.param_dtype)
    params = lm.init_params(cfg, device=device, dtype=pdtype)
    if shape.kind == "decode":            # ONE token against a seq_len cache
        cache = lm.init_cache(cfg, b, s, device=device)
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=device)
        pos = steps.start_positions(cfg, b, s - 1, device)
        return (_serve_step, (params, cache, tokens, pos), {"cfg": cfg},
                {"params": params, "cache": cache})
    batch = steps.batch_inputs(cfg, torch.zeros((b, s), dtype=torch.int32, device=device))
    if serve:
        return (steps.prefill, (params, batch), {"cfg": cfg, "cache_len": s},
                {"params": params, "batch": batch})
    batch["labels"] = batch["tokens"]
    opt = adamw.init_opt_state(params)
    return (steps.train_step, (params, opt, batch), {"cfg": cfg},
            {"params": params, "opt_state": opt, "batch": batch})


def _slstm_first_step(p, x, cfg, *, return_state: bool = False):
    """``ssm.slstm_forward`` with its time loop cut to the first step, whose
    hidden state stands for every step's (the dry-run counts shapes, not
    values)."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, d // cfg.n_heads
    pre = ssm._slstm_preacts(p, x)
    zeros = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
    carry = ssm._slstm_step(p, (zeros, zeros, torch.full_like(zeros, -1e30), zeros),
                            tuple(g[:, 0] for g in pre))
    y = carry[3][:, None].expand(b, s, h, hd).reshape(b, s, h * hd).to(x.dtype)
    out = ssm._norm(y, p["scale"], cfg) @ p["out_proj"]
    return (out, dict(zip(("c", "n", "m", "h"), carry))) if return_state else out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in adamw.tree_leaves(tree))


def count_step(cfg, shape, *, device="meta", serve_bf16: bool = False) -> dict:
    """``count`` of one step of ``cfg``'s plain path at ``shape`` (``build``'s
    call), plus ``memory``, the bytes of each tree the step holds, and
    ``slstm_flops_added``: xlstm's sLSTM loop runs its first step and the
    other S - 1 steps' recurrent products are added in closed form."""
    b, s = shape.global_batch, shape.seq_len
    loop_fix = roofline.slstm_correction_flops(cfg, shape.kind, b, s) * (s - 1) / s
    fn, args, kwargs, held = build(cfg.replace(use_kernels=False), shape, device=device,
                                   serve_bf16=serve_bf16)
    cut = mock.patch.object(ssm, "slstm_forward", _slstm_first_step) if loop_fix \
        else contextlib.nullcontext()
    with cut:
        counted = count(fn, *args, **kwargs)
    counted["flops"] += loop_fix
    counted["slstm_flops_added"] = loop_fix
    counted["memory"] = {f"{name}_bytes": _tree_bytes(tree) for name, tree in held.items()}
    return counted


def run_one(arch: str, shape_name: str, mesh_kind: str = "single", *, fused_attn: bool = True,
            serve_bf16: bool = False, device="meta", smoke: bool = False) -> dict:
    """Count one (arch, shape) step on one card and return its record.
    ``smoke``: the arch's reduced config (the CPU tests' size)."""
    if mesh_kind != "single":
        raise NotImplementedError(f"dry-run mesh {mesh_kind!r}: the port counts one card; "
                                  "per-card counts on a production mesh are ROADMAP.md queue 1 "
                                  "item 1.14")
    cfg = registry.get_smoke_config(arch) if smoke else registry.get_config(arch)
    shape = registry.INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    ok, reason = registry.runnable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    cfg = _shape_cfg(cfg, shape).replace(fused_attention=fused_attn)
    try:
        t0 = time.time()
        counted = count_step(cfg, shape, device=device, serve_bf16=serve_bf16)
        count_s = time.time() - t0
    except Exception as e:                      # the matrix keeps going; the record says why
        rec.update(status="error", error=f"{type(e).__name__}: {e}")
        return rec
    flops = counted["flops"]
    terms = roofline.roofline(flops, counted["bytes"], 0.0, 1, hw=H100_SXM)
    mf = roofline.model_flops(cfg, shape.kind, shape.global_batch, shape.seq_len)
    memory = counted["memory"]
    total = sum(memory.values())
    memory.update(total_bytes=total, hbm_bytes=H100_SXM.hbm_bytes,
                  fits=total <= H100_SXM.hbm_bytes)
    rec.update(status="ok", chips=1, device=str(device), count_s=round(count_s, 2),
               roofline=terms.as_dict(), model_flops=mf,
               useful_flops_ratio=mf / flops if flops else None,
               counted={"ops": counted["ops"], "bytes_by_device": counted["bytes_by_device"]},
               memory=memory)
    if counted["slstm_flops_added"]:
        rec["slstm"] = {"method": "first step counted, the other S - 1 steps' recurrent "
                                  "products added by slstm_correction_flops; their bytes "
                                  "not counted", "flops_added": counted["slstm_flops_added"]}
    return rec


def matrix():
    for arch in registry.list_archs():
        for shape_name in registry.INPUT_SHAPES:
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser(description="one-card dry-run")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(registry.INPUT_SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true", help="every arch x shape, in process")
    ap.add_argument("--smoke", action="store_true", help="reduced configs")
    ap.add_argument("--serve-bf16", action="store_true",
                    help="bf16 weights for prefill/decode")
    ap.add_argument("--out", default="experiments/torch_dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    os.makedirs(args.out, exist_ok=True)
    cells = matrix() if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch, shape_name in cells:
        rec = run_one(arch, shape_name, args.mesh, serve_bf16=args.serve_bf16,
                      smoke=args.smoke)
        path = os.path.join(args.out, f"{arch}_{shape_name}_{args.mesh}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        failures += rec["status"] not in ("ok", "skipped")
        print(path if args.all else json.dumps(rec, indent=1))
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
