"""The port's sharding rules against the reference's, on the CPU.

Every fitted spec of ``repro_torch.models.sharding`` and
``repro_torch.launch.shardings`` equals the reference's
(``repro.models.sharding``, ``repro.launch.shardings``, ``JAX_PLATFORMS=cpu``)
on three abstract meshes: (4, 2) over (data, model), (2, 2, 2) over (pod,
data, model) and the production (16, 16).  Specs are compared as tuples,
an entry of one axis name written as the name (JAX's ``PartitionSpec``
writes ``("data",)`` so).  Parameters are the smoke configs' of every
arch under both profiles, matched leaf by leaf by key path: the port's
tree on ``meta`` against ``steps.params_spec``; batches, decode caches and
AdamW's moments (ZeRO-1 on and off) likewise.  ``fit_pspec`` is held
equal on random shapes, specs and meshes, relocating or not.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="dev dep: pip install -r requirements-dev.txt")

import jax  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import shardings as jshardings  # noqa: E402
from repro.models import sharding as jmsh  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.models.sharding import P  # noqa: E402

ARCHS = ["granite_3_8b", "h2o_danube_3_4b", "minitron_4b", "gemma3_4b", "zamba2_1_2b",
         "xlstm_1_3b", "granite_moe_3b_a800m", "deepseek_v2_lite_16b", "whisper_base",
         "qwen2_vl_7b"]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model"))}
PROFILES = ("tp", "dp")


def _meshes(name):
    shape, names = MESHES[name]
    return msh.abstract_mesh(shape, names), jmsh.abstract_mesh(shape, names)


def _norm(spec) -> tuple:
    """A spec as a tuple, an entry of one axis name as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _ref_spec(s) -> tuple:
    return _norm(s.spec if hasattr(s, "spec") else s)


def _port_flat(tree) -> dict:
    out = {}
    msh.map_with_path(lambda path, leaf: out.__setitem__("/".join(path), leaf), tree)
    return out


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, jax.sharding.NamedSharding)))[0]
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in leaves}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jsteps.params_spec(jreg.get_smoke_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return lm.init_params(registry.get_smoke_config(arch), device="meta", dtype=torch.float32)


def _same_shapes(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


# -- fit_pspec ---------------------------------------------------------------
def _entries(names):
    singles = list(names)
    pairs = [(a, b) for a in names for b in names if a != b]
    return [None] + singles + pairs + ([tuple(names)] if len(names) == 3 else [])


@settings(max_examples=300, deadline=None)
@given(st.data())
def test_fit_pspec_equals_the_reference(data):
    """Random shapes, specs (any axis of the mesh, tuples of axes, repeats
    that the dedup must drop, specs longer or shorter than the shape),
    relocation on and off, and ``min_relocate_bytes``."""
    name = data.draw(st.sampled_from(sorted(MESHES)))
    mesh, jmesh = _meshes(name)
    shape = tuple(data.draw(st.lists(st.sampled_from([1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32,
                                                      48, 64, 96, 97, 256]),
                                     min_size=1, max_size=4)))
    spec = data.draw(st.lists(st.sampled_from(_entries(MESHES[name][1])),
                              max_size=len(shape) + 1))
    relocate = data.draw(st.booleans())
    min_bytes = data.draw(st.sampled_from([0, 1, 64, 4096, 1 << 20]))
    got = msh.fit_pspec(shape, P(*spec), mesh, relocate=relocate, min_relocate_bytes=min_bytes)
    want = jmsh.fit_pspec(shape, JP(*spec), jmesh, relocate=relocate,
                          min_relocate_bytes=min_bytes)
    assert isinstance(got, P)
    assert _norm(got) == _norm(want), (shape, spec, relocate, min_bytes)


def test_fit_pspec_relocates_to_divisible_dim():
    """The reference's example: 24 heads do not divide a 16-way model axis,
    so the entry moves to the d_model dim."""
    mesh, jmesh = _meshes("16x16")
    got = msh.fit_pspec((1536, 24, 64), P(None, "model", None), mesh)
    want = jmsh.fit_pspec((1536, 24, 64), JP(None, "model", None), jmesh)
    assert _norm(got) == _norm(want) == ("model", None, None)


def test_fit_pspec_drops_when_nothing_fits():
    mesh, jmesh = _meshes("16x16")
    got = msh.fit_pspec((7, 5), P("model", None), mesh)
    want = jmsh.fit_pspec((7, 5), JP("model", None), jmesh)
    assert _norm(got) == _norm(want) == (None, None)


def test_logical_batch_axis_spans_pod_and_data():
    mesh, jmesh = _meshes("2x2x2")
    assert _norm(msh._resolve(("batch", None), mesh)) == \
        _norm(jmsh._resolve(("batch", None), jmesh)) == (("pod", "data"), None)


def test_production_meshes_are_the_references_shapes():
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        want = ((2, 16, 16), ("pod", "data", "model")) if multi else \
            ((16, 16), ("data", "model"))
        assert (mesh.axis_sizes, mesh.axis_names) == want
        assert mesh.shape == dict(zip(want[1], want[0]))


# -- every parameter of every arch ---------------------------------------------
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_the_reference(arch, profile, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    port, ref = _port_params(arch), _ref_params(arch)
    _same_shapes(_port_flat(port), _ref_flat(ref))
    with msh.use_profile(profile), jmsh.use_profile(profile):
        got = _port_flat(msh.param_shardings(port, mesh))
        logical = _port_flat(msh.param_pspecs(port))
        want = _ref_flat(jax.tree_util.tree_map_with_path(
            lambda path, leaf: jmsh.fit_pspec(tuple(leaf.shape),
                                              jmsh._resolve(jmsh.leaf_spec(path, leaf), jmesh),
                                              jmesh), ref))
        want_logical = _ref_flat(jmsh.param_pspecs(ref))
    assert {k: _norm(v) for k, v in got.items()} == {k: _ref_spec(v) for k, v in want.items()}
    assert {k: _norm(v) for k, v in logical.items()} == \
        {k: _ref_spec(v) for k, v in want_logical.items()}
    shapes = _port_flat(port)
    for k, spec in got.items():         # the rules' promise: every split divides
        for dim, e in zip(shapes[k].shape, spec):
            assert dim % msh.axis_size(mesh, e) == 0, (k, spec)


# -- batches, caches, moments ----------------------------------------------------
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_equal_the_reference(arch, mesh_name):
    """Every field ``lm_batches`` emits, at batches that the batch ways
    divide and that they do not (those stay unsharded)."""
    mesh, jmesh = _meshes(mesh_name)
    cfg_t, cfg_j = registry.get_smoke_config(arch), jreg.get_smoke_config(arch)
    for b in (2, 8, 32, 256):
        batch = next(tokens.lm_batches(cfg_t, b, 8))
        spec = jsteps.batch_spec(cfg_j, b, 8, train=True)
        _same_shapes(batch, spec)
        for profile in PROFILES:
            with msh.use_profile(profile), jmsh.use_profile(profile):
                got = shardings.batch_shardings(batch, mesh)
                want = jshardings.batch_shardings(spec, jmesh)
            assert {k: _norm(v) for k, v in got.items()} == \
                {k: _ref_spec(v) for k, v in want.items()}, (b, profile)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_equal_the_reference(arch, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    cfg_t, cfg_j = registry.get_smoke_config(arch), jreg.get_smoke_config(arch)
    for b in (2, 8, 32):
        cache = lm.init_cache(cfg_t, b, 16, device="meta")
        spec = jsteps.decode_specs(cfg_j, b, 16)[2]
        _same_shapes(_port_flat(cache), _ref_flat(spec))
        for profile in PROFILES:
            with msh.use_profile(profile), jmsh.use_profile(profile):
                got = _port_flat(shardings.cache_shardings(cache, mesh))
                want = _ref_flat(jshardings.cache_shardings(spec, jmesh))
            assert {k: _norm(v) for k, v in got.items()} == \
                {k: _ref_spec(v) for k, v in want.items()}, (b, profile)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_shardings_equal_the_reference(arch, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    port, ref = _port_params(arch), _ref_params(arch)
    opt_spec = jsteps.opt_state_spec(ref)
    for profile in PROFILES:
        for zero1 in (False, True):
            with msh.use_profile(profile), jmsh.use_profile(profile):
                got = shardings.opt_shardings(None, port, mesh, zero1=zero1)
                want = jshardings.opt_shardings(opt_spec, ref, jmesh, zero1=zero1)
            for key in ("mu", "nu"):
                assert {k: _norm(v) for k, v in _port_flat(got[key]).items()} == \
                    {k: _ref_spec(v) for k, v in _ref_flat(want[key]).items()}, \
                    (key, profile, zero1)
            assert _norm(got["step"]) == _ref_spec(want["step"]) == ()


def test_dp_profile_replicates_params_and_zero1_shards_moments():
    """The assertions of tests/test_sharding.py::test_dp_profile_lowering_subprocess,
    without XLA: on a (2, 4) mesh under the dp profile every parameter of
    xlstm's smoke config is replicated, ZeRO-1 puts at least one moment
    leaf over data, and the tokens span ("data", "model")."""
    cfg = registry.get_smoke_config("xlstm_1_3b").replace(sharding_profile="dp", zero1=True)
    mesh = msh.abstract_mesh((2, 4), ("data", "model"))
    params = lm.init_params(cfg, device="meta", dtype=torch.float32)
    with msh.use_profile("dp"):
        specs = _port_flat(msh.param_shardings(params, mesh))
        assert all(all(e is None for e in s) for s in specs.values()), "params not replicated"
        mu = _port_flat(shardings.opt_shardings(None, params, mesh, zero1=True)["mu"])
        assert any("data" in s for s in mu.values()), "zero1 did not shard moments"
        batch = shardings.batch_shardings(next(tokens.lm_batches(cfg, 8, 32)), mesh)
    assert batch["tokens"][0] == ("data", "model"), batch["tokens"]
