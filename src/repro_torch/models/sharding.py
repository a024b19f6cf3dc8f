"""Sharding rules: logical axes of parameters and activations onto a mesh,
counterpart of ``repro.models.sharding``.

A mesh is read through two attributes, ``shape`` (axis name -> size) and
``axis_names``: an :class:`AbstractMesh` here (the production meshes, which
start no process), or ``launch.mesh.Mesh`` over the ranks of a
``torch.distributed`` group.  The production mesh has axes ("data",
"model"), or ("pod", "data", "model") across pods (``launch/mesh.py``).

A spec is a :class:`P`, the port's ``PartitionSpec``: one entry per leading
dim of a leaf, each ``None`` (replicated), a mesh-axis name, or a tuple of
axis names (the dim split over their product, the first the major one).
Parameter sharding is rule-based: a leaf's key (``wq``, ``w_down``,
``experts_up`` ...) maps through ``SHARDING_RULES`` to a spec *tail* over
its trailing dims, the leading layer-stack dims replicated.  ``fit_pspec``
makes a spec legal for a shape: an entry that does not divide its dim is
moved to the largest divisible dim or dropped.

``local_slice`` maps a leaf and its fitted spec to this rank's block (a
view, by ``narrow``, of the leaf's own rank; the mesh's ``coordinate``
places the rank), and ``gather_leaf`` rebuilds the whole leaf from every
rank's block: the data-parallel step shards its batch and its ZeRO-1
moments through them, and a tensor-parallel rank holds each parameter as
its ``local_slice`` under the fitted spec.

Tensor parallelism (the ``tp`` profile on a model axis larger than 1) runs
each layer on the rank's shards with explicit collectives over the model
axis's group, where the reference lets GSPMD insert them.  A tensor's place
on that axis is a :class:`Layout`: whole on every rank, split on one dim,
or a partial sum.  Four ``autograd.Function`` s move between them, the
Megatron pairs: ``copy`` (identity, all-reduce backward), ``reduce``
(all-reduce, identity backward), ``gather`` (all-gather, keep this rank's
slice backward) and ``scatter`` (this rank's slice, all-gather backward).
A whole tensor's gradient is whole on every rank; one that enters
rank-local work (a product with a split weight, a slice of its heads) goes
through ``copy`` first, so the ranks' partial gradients are summed.
``constrain`` (the reference's ``with_sharding_constraint``) fits a logical
spec with ``fit_pspec(..., relocate=False)`` and moves a tensor from its
layout to that one; ``project`` multiplies by a weight split on any one of
its dims and gives the product's layout.  With no mesh, a model axis of 1,
or the ``dp`` profile, all of them return their input and run no
collective.  A rank's rows of the batch need no collective here: they are
the rank's own already, and the step sums over the batch axes' group.

The MoE layer (``moe._split_moe``) routes whole on every rank and runs
its experts on the rank's block: with the experts on E, one all-reduce of
its (B,S,D) output a layer forward (the routed and shared experts' partial
sums together), and backward one of x's gradient and one of the gates';
no expert buffer crosses ranks.  With the experts on D (E does not divide
the axis) the (B,E,C,F) gate and up products' partial sums are reduced
forward (in one all-reduce) and the SwiGLU's gradient backward, and the
output's columns are gathered.  MLA (``attention._split_mla``) moves what
a GQA layer moves, plus the gradients of its whole compressed rows.

The recurrent mixers (``models/ssm``) run their scans on the rank's heads
where the heads divide the model axis, else on every head (q, k, v and
the gates gathered whole, as the state caches then are).  Mamba2's conv
runs on the rank's block of its conv_dim channels (the ``conv`` cache's
block), which need not line up with its heads, and the conv's output is
gathered whole before the rank takes its heads.  Each mixer's norm spans
its whole inner row: the row is gathered and normed whole (the RMSNorm
kernel on the path), and ``out_proj`` takes the rank's block of it.

Whisper's encoder runs its attention and MLP as the decoder does, its
output whole on every rank.  Each decoder layer's cross-attention projects
that output on the rank's heads (``attention.cross_kv``: the block of
``cross_k``/``cross_v`` that ``cache_shardings`` places, or every head,
reduced from a split on D, where the heads do not divide the model axis)
and attends it with its queries' heads; the output's partial sum over the
heads is reduced, as self-attention's is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


class P(tuple):
    """PartitionSpec: ``P(None, "model")`` is the tuple ``(None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axes and sizes, with no devices behind them."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(shape: Sequence[int], names: Sequence[str]) -> AbstractMesh:
    """The reference's constructor shim, for rule resolution without devices."""
    return AbstractMesh(tuple(shape), tuple(names))


_state = threading.local()

# Logical axis -> mesh axis (or tuple of mesh axes).  "batch" spans the pod
# axis too when present so the global batch shards over every data-parallel
# rank.
LOGICAL_AXES = {
    "batch": ("pod", "data"),
    "model": ("model",),
    "expert": ("model",),   # expert-parallel rides the model axis
    None: None,
}

# "dp" profile: the model axis carries batch instead -- params replicated,
# no per-layer activation collectives.
DP_AXES = {
    "batch": ("pod", "data", "model"),
    "model": None,
    "expert": None,
    None: None,
}


def current_profile() -> str:
    return getattr(_state, "profile", "tp")


@contextlib.contextmanager
def use_profile(profile: str):
    prev = current_profile()
    _state.profile = profile
    try:
        yield
    finally:
        _state.profile = prev


def axis_table() -> dict:
    return DP_AXES if current_profile() == "dp" else LOGICAL_AXES


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the rules.  None deactivates."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def bind_active(fn):
    """``fn`` run under the mesh and profile active now, on whatever
    thread calls it: the active pair is per thread, and a checkpointed
    forward is rerun by the autograd engine, on its own thread for CUDA
    tensors, where none is active."""
    mesh, profile = current_mesh(), current_profile()

    def bound(*args, **kwargs):
        with use_profile(profile), use_mesh(mesh):
            return fn(*args, **kwargs)
    return bound


def _resolve(spec: Sequence[Any], mesh) -> P:
    """Map logical axis names to mesh axes present on ``mesh``."""
    table = axis_table()
    out = []
    for ax in spec:
        mesh_axes = table.get(ax, (ax,) if ax else None)
        if mesh_axes is None:
            out.append(None)
            continue
        present = tuple(a for a in mesh_axes if a in mesh.axis_names)
        out.append(present if len(present) > 1 else (present[0] if present else None))
    return P(*out)


def axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def fit_pspec(shape: tuple, spec: Sequence[Any], mesh, *, relocate: bool = True,
              min_relocate_bytes: int = 0) -> P:
    """Make a spec legal for ``shape``: every sharded dim must divide
    exactly, so non-dividing assignments are moved to the largest divisible
    unassigned dim (relocate=True) or dropped.

    min_relocate_bytes: skip relocation for small tensors (counted at 4
    bytes an element) -- replicating a small projection is free, while
    relocating it to its *input* dim turns every consumer matmul into a
    partial sum and an all-reduce."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    entries = entries[:len(shape)]
    # dedup: a mesh axis may appear once; keep the first (leftmost) use so
    # specs can express fallbacks like ("expert", ..., "model") where both
    # resolve to the model axis and only one survives
    used: set = set()
    for i, e in enumerate(entries):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        if any(a in used for a in axes):
            entries[i] = None
            continue
        if shape[i] % axis_size(mesh, e) == 0:
            used.update(axes)
    homeless = []
    for i, e in enumerate(entries):
        if e is not None and shape[i] % axis_size(mesh, e) != 0:
            homeless.append(e)
            entries[i] = None
    if relocate and min_relocate_bytes:
        elems = 1
        for d in shape:
            elems *= d
        if elems * 4 < min_relocate_bytes:
            relocate = False
    if relocate:
        placed: set = set()
        for cur in entries:
            if cur is not None:
                placed.update(cur if isinstance(cur, tuple) else (cur,))
        for e in homeless:
            axes = e if isinstance(e, tuple) else (e,)
            if any(a in placed for a in axes):
                continue            # fallback entry already claimed this axis
            cand = [i for i, (d, cur) in enumerate(zip(shape, entries))
                    if cur is None and d % axis_size(mesh, e) == 0
                    and d >= axis_size(mesh, e)]
            if cand:
                best = max(cand, key=lambda i: shape[i])
                entries[best] = e
                placed.update(axes)
    return P(*entries)


def map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a nested dict, ``path`` the tuple of keys."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


# ---------------------------------------------------------------------------
# Parameter sharding rules.  Key -> spec tail over the *trailing* dims of the
# leaf (leading layer-stack dims padded with None).
# ---------------------------------------------------------------------------
SHARDING_RULES: dict[str, Optional[tuple]] = {
    # embeddings / output head: vocab over model
    "embed": ("model", None),
    "lm_head": (None, "model"),
    # attention: heads over model
    "wq": (None, "model", None),          # (D, Hq, hd)
    "wk": (None, "model", None),          # (D, Hkv, hd)
    "wv": (None, "model", None),
    "wo": ("model", None, None),          # (Hq, hd, D)
    # MLA (deepseek): low-rank kv path; shard the decompression over heads
    "w_dq": (None, None),                 # (D, q_lora) -- small, replicated
    "w_uq": (None, "model", None),        # (q_lora|D, Hq, qk_head)
    "w_dkv": (None, None),                # (D, kv_lora + rope) replicated (small)
    "w_uk": (None, "model", None),        # (kv_lora, Hq, qk_nope)
    "w_uv": (None, "model", None),        # (kv_lora, Hq, v_head)
    "w_qr": (None, "model", None),        # rope-part q proj
    # MLP
    "w_gate": (None, "model"),            # (D, F)
    "w_up": (None, "model"),
    "w_down": ("model", None),            # (F, D)
    # MoE: experts over model axis (expert-parallel)
    "router": (None, None),               # (D, E) small, replicated
    "experts_gate": ("expert", None, None),   # (E, D, F)
    "experts_up": ("expert", None, None),
    "experts_down": ("expert", None, None),   # (E, F, D)
    "shared_gate": (None, "model"),
    "shared_up": (None, "model"),
    "shared_down": ("model", None),
    # SSM / xLSTM: inner dim over model
    "in_proj": (None, "model"),           # (D, inner)
    "out_proj": ("model", None),          # (inner, D)
    "conv_w": (None, "model"),            # (k, inner)
    "conv_b": ("model",),
    "xbc_proj": (None, "model"),
    "dt_proj": (None, "model"),
    "A_log": ("model",),
    "D_skip": ("model",),
    "gate_proj": (None, "model"),
    "ssm_norm": ("model",),
    # sLSTM / mLSTM gates
    "w_i": (None, "model"), "w_f": (None, "model"), "w_o": (None, "model"),
    "w_z": (None, "model"), "w_qx": (None, "model"), "w_kx": (None, "model"),
    "w_vx": (None, "model"),
    "r_i": (None, None), "r_f": (None, None), "r_o": (None, None), "r_z": (None, None),
    # norms / scalars: replicated
    "scale": (None,), "bias": (None,), "b_i": (None,), "b_f": (None,),
    "b_o": (None,), "b_z": (None,), "alpha": (None,),
    # conv stubs / lenet
    "w": None, "b": None,
}


def leaf_spec(path: tuple, leaf: Any) -> tuple:
    """Spec entries for one param leaf, from the last string key of its
    path (the port's key paths are the reference's: ``models/transplant``)."""
    key = next((p for p in reversed(path) if isinstance(p, str)), None)
    rule = SHARDING_RULES.get(key)
    ndim = len(leaf.shape)
    if rule is None:
        return (None,) * ndim
    if len(rule) > ndim:            # e.g. scalar stored where rule expects vector
        return (None,) * ndim
    return (None,) * (ndim - len(rule)) + tuple(rule)


def param_pspecs(params: Any) -> Any:
    """Tree of specs (logical names) mirroring ``params``."""
    return map_with_path(lambda path, leaf: P(*leaf_spec(path, leaf)), params)


def param_shardings(params: Any, mesh, *, min_relocate_bytes: int = 0) -> Any:
    """Tree of fitted specs for ``params`` on ``mesh`` (logical axes
    resolved, fitted to divisibility with relocation to the largest
    divisible dim; tensors under min_relocate_bytes replicate instead of
    relocating)."""
    return map_with_path(
        lambda path, leaf: fit_pspec(tuple(leaf.shape), _resolve(leaf_spec(path, leaf), mesh),
                                     mesh, min_relocate_bytes=min_relocate_bytes),
        params)


# cache leaf key -> logical spec tail (after the leading group-stack dim and
# the batch dim, which are fixed (None, batch)).
_CACHE_RULES = {
    "k": (None, "model", None),        # (G,B,S,Hkv,hd)
    "v": (None, "model", None),
    "cross_k": (None, "model", None),
    "cross_v": (None, "model", None),
    "c_kv": (None, None),              # (G,B,S,r) MLA compressed: replicated tail
    "k_rope": (None, None),
    "ssm": ("model", None, None),      # (G,B,H,P,N)
    "conv": (None, "model"),           # (G,B,k,conv_dim)
    "C": ("model", None, None),        # (G,B,H,hd,hd) mlstm
    "n": ("model", None),
    "m": ("model",),
    "c": ("model", None),              # slstm
    "h": ("model", None),
}


def cache_shardings(cache_spec: Any, mesh) -> Any:
    """Tree of fitted specs for a decode cache on ``mesh`` (the reference's
    ``launch.shardings.cache_shardings``): the batch dim over the batch
    axes where their ways divide it, the tail by ``_CACHE_RULES``, fitted
    without relocation (kv heads that do not divide the model axis stay
    whole)."""
    batch = _resolve(("batch",), mesh)[0]
    ways = axis_size(mesh, batch)

    def f(path, leaf):
        key = next((p for p in reversed(path) if isinstance(p, str)), None)
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if key == "enc_len":
            return P(batch if shape[0] % ways == 0 else None)
        tail = _CACHE_RULES.get(key, ())[:max(ndim - 2, 0)]
        tail = tail + (None,) * (ndim - 2 - len(tail))
        batch_ax = batch if ndim >= 2 and shape[1] % ways == 0 else None
        spec = (None, batch_ax) + tuple(_resolve(tail, mesh))
        return fit_pspec(shape, spec[:ndim], mesh, relocate=False)
    return map_with_path(f, cache_spec)


# ---------------------------------------------------------------------------
# A rank's block of a leaf under a fitted spec, and the whole leaf back.
# ---------------------------------------------------------------------------
def splits(spec: P, mesh) -> list:
    """(dim, axes, ways, this rank's index) of every dim ``spec`` splits
    more than one way; the index runs over the entry's axes, the first the
    major one (JAX's layout of a tuple of axes)."""
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        ways, idx = 1, 0
        for a in axes:
            ways, idx = ways * mesh.shape[a], idx * mesh.shape[a] + mesh.coordinate[a]
        if ways > 1:
            out.append((dim, axes, ways, idx))
    return out


def local_slice(leaf: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec``: a view of the same rank
    (``narrow`` on every split dim, so a 2-D weight stays 2-D).  A spec
    that splits nothing returns ``leaf`` itself."""
    for dim, _, ways, idx in splits(spec, mesh):
        n = leaf.shape[dim] // ways
        leaf = leaf.narrow(dim, idx * n, n)
    return leaf


def gather_leaf(local: torch.Tensor, spec: P, mesh, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """The whole leaf from every rank's ``local_slice`` (``all_gather``
    over the group of each split axis), written into ``out`` when given.
    Each split dim must be split over one mesh axis ("data" or "model":
    no ``tp`` spec splits a dim over two)."""
    for dim, axes, ways, _ in reversed(splits(spec, mesh)):
        if len(axes) != 1:
            raise NotImplementedError(f"gathering a dim split over {axes}: one axis a dim")
        parts = [torch.empty_like(local, memory_format=torch.contiguous_format)
                 for _ in range(ways)]
        dist.all_gather(parts, local.contiguous(), group=mesh.group(axes[0]))
        local = torch.cat(parts, dim)
    if out is None:
        return local
    return out.copy_(local)


def without_axis(spec: P, axis: str) -> P:
    """``spec`` with ``axis`` taken out of every entry: the spec of a
    rank's block relative to its block on ``axis`` (a tensor-parallel
    rank's moments read against its parameter shard)."""
    out = []
    for entry in spec:
        axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                     if a is not None and a != axis)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return P(*out)


def batch_group(mesh) -> tuple:
    """(process group, ways) of the ranks that hold other rows of the
    batch than this one (the batch axes under the active profile): the
    group None, the whole world, where they are every rank (no mesh, a
    model axis of 1, the ``dp`` profile)."""
    world = dist.get_world_size()
    if mesh is None:
        return None, world
    entry = _resolve(("batch",), mesh)[0]
    ways = axis_size(mesh, entry)
    if ways == world:
        return None, world
    return (mesh.group(entry) if ways > 1 else None), ways


# ---------------------------------------------------------------------------
# Tensor parallelism: layouts on the model axis, the four Functions,
# ``constrain`` and ``project``.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Layout:
    """A tensor's place on the model axis: ``dim`` split over it (None:
    whole on every rank), or ``partial``: each rank holds a partial sum."""
    dim: Optional[int] = None
    partial: bool = False


WHOLE = Layout()
PARTIAL = Layout(partial=True)


def model_ways() -> int:
    """The model axis's size under the active mesh and the ``tp`` profile;
    1 with no mesh, no model axis, or the ``dp`` profile."""
    mesh = current_mesh()
    if mesh is None or current_profile() == "dp" or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


# the families tensor parallelism covers: every family of the registry.  A
# family named in neither (a new one) -> its ROADMAP.md queue 1 item, 1.13
# unless ``TP_ITEMS`` names another
TP_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
TP_ITEMS: dict = {}


def refuse_outside_tp(cfg, entry: str) -> None:
    """Tensor parallelism covers the families of ``TP_FAMILIES`` (dense,
    VLM, MoE, SSM, hybrid and enc-dec).  A family named nowhere raises,
    naming ROADMAP.md item 1.13, where the active mesh and profile split
    parameters over a model axis (``model_ways() > 1``): ``LMTrainJob``
    before any work, ``lm.forward``, ``decode_step`` and ``prefill_chunk``
    at entry, so that no new family trains or serves unsharded in
    silence.  A model axis of 1, or the ``dp`` profile, refuses none."""
    ways = model_ways()
    if ways == 1 or cfg.family in TP_FAMILIES:
        return
    item, what = TP_ITEMS.get(cfg.family, ("1.13", f"the {cfg.family!r} family"))
    raise NotImplementedError(
        f"{entry}: the {current_profile()!r} profile on mesh {dict(current_mesh().shape)} "
        f"splits {cfg.family!r} parameters over a model axis of {ways}; tensor parallelism of "
        f"{what} (training and serving) is ROADMAP.md queue 1 item {item}. Run it "
        "data-parallel: a model axis of 1, or sharding_profile='dp'")


def model_group():
    """The process group of the ranks that differ from this one on the
    model axis alone."""
    return current_mesh().group("model")


def model_index() -> int:
    """This rank's coordinate on the model axis."""
    return current_mesh().coordinate["model"]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather(x: torch.Tensor, dim: int, group, ways: int) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(ways)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _own(x: torch.Tensor, dim: int, index: int, ways: int) -> torch.Tensor:
    n = x.shape[dim] // ways
    return x.narrow(dim, index * n, n).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index, ways):
        ctx.dim, ctx.index, ctx.ways = dim, index, ways
        return _all_gather(x, dim, group, ways)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.dim, ctx.index, ctx.ways), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, index, ways):
        ctx.dim, ctx.group, ctx.ways = dim, group, ways
        return _own(x, dim, index, ways)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.ways), None, None, None, None


def copy(x: torch.Tensor) -> torch.Tensor:
    """Identity; backward all-reduces the gradient over the model group."""
    return x if model_ways() == 1 else _Copy.apply(x, model_group())


def reduce(x: torch.Tensor) -> torch.Tensor:
    """All-reduce of a partial sum over the model group; identity backward
    (the downstream gradient is already whole on every rank: an all-reduce
    there would count it once a rank)."""
    return x if model_ways() == 1 else _Reduce.apply(x, model_group())


def block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of a whole ``x`` that has come through
    ``copy``: a slice, whose gradient is this rank's block of the whole
    one (zeros elsewhere, summed over the ranks by the ``copy``)."""
    ways = model_ways()
    return x if ways == 1 else _own(x, dim % x.ndim, model_index(), ways)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor from the ranks' blocks on ``dim``; backward keeps
    this rank's block of the gradient."""
    ways = model_ways()
    if ways == 1:
        return x
    return _Gather.apply(x, dim % x.ndim, model_group(), model_index(), ways)


def scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of ``dim``; backward all-gathers the gradient."""
    ways = model_ways()
    if ways == 1:
        return x
    return _Scatter.apply(x, dim % x.ndim, model_group(), model_index(), ways)


def fitted_layout(shape: Sequence[int], *spec: Any) -> Layout:
    """The layout the logical ``spec`` asks of a whole tensor of ``shape``
    (``fit_pspec(..., relocate=False)``: a model entry that does not divide
    its dim is dropped, and the tensor stays whole).  WHOLE where
    ``model_ways()`` is 1."""
    if model_ways() == 1:
        return WHOLE
    mesh = current_mesh()
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    fitted = fit_pspec(tuple(shape), _resolve(spec, mesh), mesh, relocate=False)
    for dim, entry in enumerate(fitted):
        if entry is not None and "model" in (entry if isinstance(entry, tuple) else (entry,)):
            return Layout(dim)
    return WHOLE


def constrain(x: torch.Tensor, *spec: Any, layout: Layout = WHOLE) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` against the active mesh:
    ``x``, whose layout is ``layout``, moved to the layout that ``spec``
    (logical axes, one entry a leading dim) fits to on the model axis.  The
    batch entry needs nothing (the rows are this rank's).  A partial sum is
    reduced, then a split gathered or scattered.  Returns ``x``
    itself with no mesh, a model axis of 1, or the ``dp`` profile."""
    ways = model_ways()
    if ways == 1:
        return x
    shape = list(x.shape)
    if layout.dim is not None:
        shape[layout.dim] *= ways
    return relayout(x, layout, fitted_layout(shape, *spec))


def relayout(x: torch.Tensor, layout: Layout, dst: Layout) -> torch.Tensor:
    """``x``, whose layout is ``layout``, moved to the layout ``dst``: a
    partial sum is reduced, then a split gathered or scattered.  Returns
    ``x`` itself where ``model_ways()`` is 1 or the two already agree."""
    if model_ways() == 1:
        return x
    if layout.partial:                   # a partial sum is summed first
        x, layout = reduce(x), WHOLE
    if layout.dim is not None and dst.dim is not None and \
            layout.dim % x.ndim == dst.dim % x.ndim:
        return x
    if layout.dim is not None:
        x = gather(x, layout.dim)
    return x if dst.dim is None else scatter(x, dst.dim)


def weight_split(w: torch.Tensor, whole: Sequence[int]) -> Optional[int]:
    """The dim of ``whole`` that this rank's block ``w`` of a weight is
    split on over the model axis (None: whole)."""
    diff = [d for d, (a, b) in enumerate(zip(w.shape, whole)) if a != b]
    if w.ndim != len(whole) or len(diff) > 1 or \
            any(w.shape[d] * model_ways() != whole[d] for d in diff):
        raise ValueError(f"a block {tuple(w.shape)} of a {tuple(whole)} weight is not one dim "
                         f"split {model_ways()} ways")
    return diff[0] if diff else None


def project(eq: str, x: torch.Tensor, layout: Layout, w: torch.Tensor, whole: Sequence[int],
            op=None) -> tuple:
    """(``op(x, w)``, its layout): the product ``eq`` (an einsum equation,
    ``...`` allowed at the front of the input's and output's letters) of
    ``x`` under ``layout`` and this rank's block ``w`` of a weight whose
    whole shape is ``whole``; ``op`` computes it (default
    ``torch.einsum(eq, ...)``).  A weight split on an output dim (column
    parallel) takes a whole ``x`` and gives the product split there; one
    split on a contracted dim (row parallel) takes ``x`` split on that dim,
    or whole, and then its block of it, and gives a partial sum; one split
    on a dim that ``x`` and the output share (the experts of
    ``becd,edf->becf``) takes ``x`` split there, or its block of a whole
    ``x``, and gives the product split there.  A whole ``x`` must have come
    through ``copy``: its gradient here is this rank's part."""
    op = op or (lambda a, b: torch.einsum(eq, a, b))
    if model_ways() == 1:
        return op(x, w), WHOLE
    dim = weight_split(w, whole)
    if dim is None or layout.partial:
        raise NotImplementedError(f"{eq} of a {layout} input and a {tuple(whole)} weight whole "
                                  "on the model axis: no tp rule gives either")
    ins, out = eq.split("->")
    xs, ws = ins.split(",")
    letter = ws[dim]

    def at(spec: str, t_ndim: int, c: str) -> int:       # index of ``c`` in a tensor of ``spec``
        body = spec[3:] if spec.startswith("...") else spec
        return t_ndim - len(body) + body.index(c)

    xdim = None if layout.dim is None else layout.dim % x.ndim
    if letter in out and letter not in xs:               # column parallel
        if xdim is not None:
            raise NotImplementedError(f"{eq}: input split on dim {xdim}, weight on {letter!r}")
        y = op(x, w)
        return y, Layout(at(out, y.ndim, letter))
    if letter in xs:                                     # row parallel, or batched on it
        k = at(xs, x.ndim, letter)
        if xdim is None:
            x = _own(x, k, model_index(), model_ways())
        elif xdim != k:
            raise NotImplementedError(f"{eq}: input split on dim {xdim}, weight on {letter!r}")
        y = op(x, w)
        return (y, Layout(at(out, y.ndim, letter))) if letter in out else (y, PARTIAL)
    raise NotImplementedError(f"{eq}: a weight split on {letter!r}")
