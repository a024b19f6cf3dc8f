"""Dry-run: count every (arch x input shape) step with no real allocation,
and write its roofline record, on one card or per card on the reference's
production meshes.  Twin of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_8b --shape decode_32k \
        --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|pod|multi]

``--mesh``: ``single`` is one card (H100); ``pod`` the 16 x 16 mesh over
("data", "model"), 256 cards, which the reference calls ``single``
(``repro/launch/dryrun.py``'s ``--mesh single``); ``multi`` 2 x 16 x 16
over ("pod", "data", "model"), 512 cards, as in the reference.

The parameters (and, to train, the optimizer state), the batch or the
decode cache are built on ``meta``: shapes and dtypes, no bytes, no card.
One training step, one ``steps.prefill`` or one ``steps.serve_step``
against a full cache runs on them under ``launch/count.py`` on the plain
path, and the counts become the roofline terms over ``H100_SXM``.
``fused_attn`` puts attention on ``ops.flash_chunked``, which holds no
whole (Sq, Skv) score matrix at a time; it does the same products, and its
eager chunks write every score once, so the counts barely move.

On a production mesh the count is one card's: this process runs as rank
0 of a group of 256 or 512 ranks that lives inside it and moves
no data (``torch``'s ``fake`` backend over a ``FakeStore``: its
collectives on ``meta`` tensors return at once), laid out by
``launch.mesh.make_mesh`` (``counting_mesh``).  The rank's operands come
from the sharding rules: its parameter blocks (``param_shardings``,
``local_slice``), its optimizer state (``opt_shardings``, ZeRO-1 with
``zero1``), its rows of the batch (``batch_shardings``) and its block of
the cache (``cache_shardings``, through ``lm.init_cache`` under the
mesh).  Train counts ``steps.dp_train_step`` (what ``LMTrainJob(mesh=...)``
runs), prefill ``steps.prefill`` and decode ``steps.serve_step``, under
the ``tp`` or ``dp`` profile; the collectives they run are counted by kind
and by mesh axis, and their bytes are the roofline's collective term.  The
group is torn down when the count ends, whatever happens.  The reference
lowers and compiles the same steps with XLA and reads its cost analysis
instead.  Records go to ``experiments/torch_dryrun/<arch>_<shape>_<mesh>.json``;
``launch/report.py`` renders them.

xlstm's sLSTM steps token by token: counted eagerly at 32k tokens that
loop would run for many minutes, even on ``meta``.  Its steps are
identical, so the dry-run runs the first step, lets its output stand for
every step's, and adds the other S - 1 steps' recurrent products in closed
form (``roofline.slstm_correction_flops``, for the card's rows and heads); the
record's ``slstm`` says so.  Those steps' bytes are not counted.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from unittest import mock

import torch
import torch.distributed as dist

from ..clouds.profiles import H100_SXM
from ..configs import registry
from ..models import lm, ssm, steps
from ..models import sharding as msh
from ..optim import adamw
from . import roofline, shardings
from .count import collective_bytes, count
from .mesh import make_mesh

# --mesh -> (shape, axes) of the production mesh, None for one card
MESHES = {"single": None, "pod": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


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


@contextlib.contextmanager
def counting_mesh(shape, axes, rank: int = 0):
    """A mesh of prod(shape) ranks over ``axes`` inside this process, which
    is rank ``rank`` of it: a ``fake`` process group over a ``FakeStore``
    (``torch.testing._internal.distributed.fake_pg``), whose collectives
    move nothing.  Torn down on exit, whatever happens.  Raises where a
    process group is already active (count in a fresh process) or where
    this torch has no fake group."""
    if dist.is_initialized():
        raise RuntimeError("counting_mesh: a process group is already active in this process; "
                           "count a production mesh in a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"counting_mesh: torch {torch.__version__} has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg); the dry-run cannot "
                           "count a production mesh here") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=math.prod(shape))
    try:
        yield make_mesh(shape, axes, "cpu")
    finally:
        dist.destroy_process_group()


def _rows(tree: dict, mesh) -> dict:
    """This rank's rows of a batch-like tree (``batch_shardings``); the
    tree itself with no mesh."""
    if mesh is None:
        return tree
    specs = shardings.batch_shardings(tree, mesh)
    return {k: msh.local_slice(v, specs[k], mesh) for k, v in tree.items()}


def build(cfg, shape, *, device="meta", serve_bf16: bool = False, zero1: bool = False,
          min_relocate_bytes: int = 0):
    """One shape's counted call on ``device``: (fn, args, kwargs, held),
    ``held`` naming the trees the step holds in device memory (params,
    optimizer state, batch or cache).  Parameters are ``cfg.param_dtype``
    (fp32 masters, cast every call, as the reference's dry-run holds them),
    or for serving with ``serve_bf16`` the compute dtype (the port's
    serving entry points hold them so from load on).  Under an active mesh
    every tree is this rank's block of it (module docstring) and training
    runs ``steps.dp_train_step``; must then run under the mesh and
    ``cfg.sharding_profile``."""
    b, s = shape.global_batch, shape.seq_len
    serve = shape.kind != "train"
    mesh = msh.current_mesh()
    pdtype = cfg.compute_dtype if serve and serve_bf16 else getattr(torch, cfg.param_dtype)
    params = lm.init_params(cfg, device=device, dtype=pdtype)
    whole = params
    if mesh is not None:
        pspecs = msh.param_shardings(params, mesh, min_relocate_bytes=min_relocate_bytes)
        params = adamw.tree_map(lambda t, sp: msh.local_slice(t, sp, mesh), params, pspecs)
    if shape.kind == "decode":            # ONE token against a seq_len cache
        cache = lm.init_cache(cfg, b, s, device=device)
        step = _rows({"tokens": torch.zeros((b, 1), dtype=torch.int32, device=device),
                      "pos": steps.start_positions(cfg, b, s - 1, device)}, mesh)
        return (_serve_step, (params, cache, step["tokens"], step["pos"]), {"cfg": cfg},
                {"params": params, "cache": cache})
    batch = steps.batch_inputs(cfg, torch.zeros((b, s), dtype=torch.int32, device=device))
    if serve:
        batch = _rows(batch, mesh)
        return (steps.prefill, (params, batch), {"cfg": cfg, "cache_len": s},
                {"params": params, "batch": batch})
    batch["labels"] = batch["tokens"]
    batch = _rows(batch, mesh)
    if mesh is None:
        opt = adamw.init_opt_state(params)
        return (steps.train_step, (params, opt, batch), {"cfg": cfg},
                {"params": params, "opt_state": opt, "batch": batch})
    specs = shardings.opt_shardings(None, whole, mesh, zero1=zero1)["mu"]
    opt = steps.dp_opt_state(params, specs)
    return (steps.dp_train_step, (params, opt, batch), {"cfg": cfg, "specs": specs},
            {"params": params, "opt_state": opt, "batch": batch})


def _slstm_first_step(r, pre, carry):
    """``ssm._slstm_loop`` cut to its first step, whose hidden state stands
    for every step's (the dry-run counts shapes, not values)."""
    carry = ssm._slstm_step(r, carry, tuple(g[:, 0] for g in pre))
    h = carry[3]
    return h[:, None].expand(h.shape[0], pre[0].shape[1], *h.shape[1:]), carry


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in adamw.tree_leaves(tree))


def count_step(cfg, shape, *, device="meta", serve_bf16: bool = False, zero1: bool = False,
               min_relocate_bytes: int = 0) -> dict:
    """``count`` of one step of ``cfg``'s plain path at ``shape`` (``build``'s
    call) on one card, or as this rank of the active mesh (run under it and
    ``cfg.sharding_profile``), plus ``memory``, the bytes of each tree the
    step holds on the card, and ``slstm_flops_added``: xlstm's sLSTM loop
    runs its first step and the other S - 1 steps' recurrent products, for
    the card's rows, are added in closed form."""
    fn, args, kwargs, held = build(cfg.replace(use_kernels=False), shape, device=device,
                                   serve_bf16=serve_bf16, zero1=zero1,
                                   min_relocate_bytes=min_relocate_bytes)
    s = shape.seq_len
    rows = held["batch"]["tokens"].shape[0] if "batch" in held else shape.global_batch
    # the card's heads: a block of them where they divide the model axis
    heads = 1 / msh.model_ways() if ssm._split_heads(cfg.n_heads) else 1
    loop_fix = roofline.slstm_correction_flops(cfg, shape.kind, rows, s) * heads * (s - 1) / s
    cut = mock.patch.object(ssm, "_slstm_loop", _slstm_first_step) if loop_fix \
        else contextlib.nullcontext()
    with cut:
        counted = count(fn, *args, **kwargs)
    counted["flops"] += loop_fix
    counted["slstm_flops_added"] = loop_fix
    counted["memory"] = {f"{name}_bytes": _tree_bytes(tree) for name, tree in held.items()}
    return counted


def run_one(arch: str, shape_name: str, mesh_kind: str = "single", *, fused_attn: bool = True,
            serve_bf16: bool = False, device="meta", smoke: bool = False, profile: str = "tp",
            zero1: bool = False, remat: bool = False, min_relocate_bytes: int = 0) -> dict:
    """Count one (arch, shape) step on one card (``mesh_kind`` "single")
    or on card 0 of the production mesh "pod" or "multi"
    (``MESHES``), and return its record.  ``smoke``: the arch's reduced
    config (the CPU tests' size).  ``profile``, ``zero1``, ``remat`` and
    ``min_relocate_bytes`` as the reference's ``run_one`` takes them.  A
    family that ``sharding.TP_FAMILIES`` does not list gets an ``error``
    record naming its item under ``tp`` on a mesh."""
    if mesh_kind not in MESHES:
        raise ValueError(f"dry-run mesh {mesh_kind!r}: one of {sorted(MESHES)}")
    cfg = registry.get_smoke_config(arch) if smoke else registry.get_config(arch)
    shape = registry.INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "profile": profile,
           "zero1": zero1, "remat": remat, "min_relocate_bytes": min_relocate_bytes}
    ok, reason = registry.runnable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    cfg = _shape_cfg(cfg, shape).replace(fused_attention=fused_attn, sharding_profile=profile,
                                         zero1=zero1, remat=remat)
    kw = dict(device=device, serve_bf16=serve_bf16, zero1=zero1,
              min_relocate_bytes=min_relocate_bytes)
    try:
        t0 = time.time()
        if MESHES[mesh_kind] is None:
            chips = 1
            counted = count_step(cfg, shape, **kw)
        else:
            with counting_mesh(*MESHES[mesh_kind]) as mesh, \
                    msh.use_profile(profile), msh.use_mesh(mesh):
                chips = math.prod(mesh.shape.values())
                msh.refuse_outside_tp(cfg, "dry-run")
                counted = count_step(cfg, shape, **kw)
                rec["coordinate"] = dict(mesh.coordinate)
        count_s = time.time() - t0
    except Exception as e:                      # the matrix keeps going; the record says why
        rec.update(status="error", error=f"{type(e).__name__}: {e}")
        return rec
    flops, coll = counted["flops"], counted["collectives"]
    terms = roofline.roofline(flops, counted["bytes"], collective_bytes(coll), chips,
                              hw=H100_SXM)
    mf = roofline.model_flops(cfg, shape.kind, shape.global_batch, shape.seq_len)
    memory = counted["memory"]
    total = sum(memory.values())
    memory.update(total_bytes=total, hbm_bytes=H100_SXM.hbm_bytes,
                  fits=total <= H100_SXM.hbm_bytes)
    rec.update(status="ok", chips=chips, device=str(device), count_s=round(count_s, 2),
               roofline=terms.as_dict(), model_flops=mf,
               useful_flops_ratio=mf / (flops * chips) if flops else None,
               collectives=coll,
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
    ap = argparse.ArgumentParser(description="dry-run: per-card counts of one step, on one "
                                 "card or on a production mesh")
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(registry.INPUT_SHAPES))
    ap.add_argument("--mesh", choices=tuple(MESHES), default="single",
                    help="single: one card; pod: 16 x 16 over (data, model), 256 cards (the "
                         "reference's --mesh single); multi: 2 x 16 x 16 over (pod, data, "
                         "model), 512 cards (the reference's --mesh multi)")
    ap.add_argument("--profile", choices=("tp", "dp"), default="tp")
    ap.add_argument("--zero1", action="store_true", help="ZeRO-1 moments over data")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--min-relocate-bytes", type=int, default=0)
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
                      smoke=args.smoke, profile=args.profile, zero1=args.zero1,
                      remat=args.remat, min_relocate_bytes=args.min_relocate_bytes)
        path = os.path.join(args.out, f"{arch}_{shape_name}_{args.mesh}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        failures += rec["status"] not in ("ok", "skipped")
        print(path if args.all else json.dumps(rec, indent=1))
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
