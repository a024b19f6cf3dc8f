"""The single-card half of launch and hardware profile, against the JAX
reference: the chunked ("fused") attention twin, the roofline closed forms,
``modelci.roofline_fields``, the FLOP and traffic counter, the one-card
dry-run on ``meta``, the input shapes and the report.

The reference runs on the CPU as its own tests run it: ``flash_chunked_jnp``
and the smoke forwards through jnp (``use_kernels=False``: the reference's
chunked path is its plain path).  Inputs are drawn with numpy from a seed;
tolerances are the reference's (tests/test_kernels.py: 3e-4 in fp32;
tests/test_archs.py:66-67: rel 2e-3 on logits).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.clouds.profiles import TPU_V5E  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.modelci.profile import roofline_fields as jroofline_fields  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.clouds.profiles import (H100_SXM, HardwareSpec, get_profile,  # noqa: E402
                                         hardware_for)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.registry import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402
from repro_torch.launch.count import count  # noqa: E402
from repro_torch.modelci.profile import roofline_fields  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import sharding as msh  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the chunked attention twin -------------------------------------------------

@pytest.mark.parametrize("sq,skv,hq,hkv,window,off,dv", [
    (64, 64, 4, 2, 0, 0, 32), (100, 100, 8, 2, 24, 0, 32), (33, 128, 4, 4, 0, 95, 32),
    (40, 40, 4, 4, 0, 0, 24),                   # MLA: v narrower than q and k
])
def test_flash_chunked_matches_the_reference_twin(sq, skv, hq, hkv, window, off, dv):
    """tests/test_kernels.py:105-119's grid (causal, window, q_offset, GQA)
    and MLA's dv != d, chunks of 32 keys, fp32."""
    rng = np.random.default_rng(sq + skv + dv)
    q = rng.standard_normal((2, sq, hq, 32), dtype=np.float32)
    k = rng.standard_normal((2, skv, hkv, 32), dtype=np.float32)
    v = rng.standard_normal((2, skv, hkv, dv), dtype=np.float32)
    want = np.asarray(jops.flash_chunked_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=True, window=window, q_offset=off,
                                             chunk_k=32))
    got = ops.flash_chunked(_t(q), _t(k), _t(v), causal=True, window=window, q_offset=off,
                            chunk_k=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    # the plain path takes it when asked, and it is the twin's function
    routed = ops.flash_attention(_t(q), _t(k), _t(v), window=window, q_offset=off,
                                 chunked=True, chunk_k=32)
    assert torch.equal(routed, got)
    if dv == 32:
        np.testing.assert_allclose(got.numpy(), ref.flash_attention_ref(
            _t(q), _t(k), _t(v), window=window, q_offset=off).numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("arch", ["granite_3_8b", "h2o_danube_3_4b", "deepseek_v2_lite_16b"])
def test_fused_attention_forward_matches_reference(arch):
    """The smoke forward with ``fused_attention`` (chunks of 4 keys over 12
    tokens: three chunks, the window and MLA's dv inside them), the port's
    plain path against the reference's."""
    cfg_j = jreg.get_smoke_config(arch).replace(fused_attention=True, attn_chunk=4)
    cfg_t = registry.get_smoke_config(arch).replace(fused_attention=True, attn_chunk=4)
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = transplant(jax.tree_util.tree_map(np.asarray, params_j), device="cpu",
                          dtype=cfg_t.compute_dtype)
    tokens = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (2, 12), dtype=np.int32)
    want, _, _ = jlm.forward(params_j, cfg_j, {"tokens": jnp.asarray(tokens)})
    got, _, _ = lm.forward(params_t, cfg_t, {"tokens": _t(tokens)})
    want = np.asarray(want, np.float32)
    rel = np.max(np.abs(got.float().numpy() - want)) / (np.max(np.abs(want)) + 1e-9)
    assert rel < 2e-3, rel
    plain, _, _ = lm.forward(params_t, cfg_t.replace(fused_attention=False),
                             {"tokens": _t(tokens)})
    torch.testing.assert_close(got, plain, rtol=3e-4, atol=3e-4)


# -- the closed forms -----------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_model_flops_equal_the_references(arch):
    cfg_t, cfg_j = registry.get_config(arch), jreg.get_config(arch)
    for shape in INPUT_SHAPES.values():
        assert roofline.model_flops(cfg_t, shape.kind, shape.global_batch, shape.seq_len) == \
            jroofline.model_flops(cfg_j, shape.kind, shape.global_batch, shape.seq_len)
        for kind in ("train", "prefill"):
            assert roofline.slstm_correction_flops(cfg_t, kind, 2, 64) == \
                jroofline.slstm_correction_flops(cfg_j, kind, 2, 64)


def _reference_chip() -> HardwareSpec:
    """A HardwareSpec holding the reference's accelerator constants, copied
    from its ``TPU_V5E`` (the port's own spec holds none of them)."""
    return HardwareSpec(name=TPU_V5E.name, peak_flops_bf16=TPU_V5E.peak_flops_bf16,
                        peak_flops_fp32=TPU_V5E.peak_flops_bf16, hbm_bw=TPU_V5E.hbm_bw,
                        link_bw=TPU_V5E.ici_bw, net_bw=TPU_V5E.dcn_bw,
                        hbm_bytes=TPU_V5E.hbm_bytes, smem_bytes=TPU_V5E.vmem_bytes)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_roofline_fields_equal_the_references_on_its_constants(arch):
    """The formula, held to the reference's: on the reference's constants
    the fields are the reference's, float for float."""
    cfg_t, cfg_j = registry.get_config(arch), jreg.get_config(arch)
    for kw in ({}, {"shape_kind": "prefill", "batch": 4, "seq": 128, "gen_tokens": 1},
               {"batch": 8, "chips": 4}):
        assert roofline_fields(cfg_t, hw=_reference_chip(), **kw) == jroofline_fields(cfg_j, **kw)
    t = roofline.roofline(1e12, 3e9, 2e8, 4, hw=_reference_chip()).as_dict()
    assert t == jroofline.roofline(1e12, 3e9, 2e8, 4).as_dict()


def test_roofline_fields_closed_form():
    """Twin of tests/test_modelci.py::test_roofline_fields_closed_form over
    the card's spec: a decode step of gemma3 streams its weights."""
    cfg = registry.get_config("gemma3_4b")
    fields = roofline_fields(cfg)
    assert fields["source"] == "roofline"
    assert fields["service_time_s"] > 0
    assert fields["memory_bytes"] == 2 * cfg.approx_active_params()
    assert fields["roofline"]["memory_s"] > 0        # decode: bandwidth-bound
    assert fields["roofline"]["dominant"] == "memory"
    assert fields["roofline"]["memory_s"] == pytest.approx(
        2 * cfg.approx_active_params() / H100_SXM.hbm_bw)
    assert fields["service_time_s"] == pytest.approx(32 * fields["roofline"]["bound_s"])


def test_the_card_spec_and_the_cloud_profiles():
    assert hardware_for("NVIDIA H100 80GB HBM3") is H100_SXM
    assert hardware_for(" NVIDIA H100 80GB HBM3\n") is H100_SXM
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(KeyError, match="no HardwareSpec"):
            hardware_for(name)
    assert H100_SXM.peak_flops_bf16 == 989e12 and H100_SXM.hbm_bw == 3.35e12
    assert H100_SXM.hbm_bytes == 80 * 2**30 and H100_SXM.smem_bytes == 228 * 2**10
    for cloud in ("gcp", "ibm", "baremetal", "k8s"):
        assert get_profile(cloud).hardware is H100_SXM
    assert dataclasses.fields(get_profile("gcp"))[-1].name == "hardware"


# -- the counter ----------------------------------------------------------------

def test_count_equals_the_closed_form_of_a_dense_forward():
    """granite's smoke forward on the plain path: the projections, MLP and
    head at 2 x params x tokens, attention's two products at 2 B Hq Sq Skv D
    each (the twin computes every pair and masks); on ``meta``, so nothing
    is allocated, and on the CPU the same counts."""
    cfg = registry.get_smoke_config("granite_3_8b")
    b, s = 2, 12
    d, hq, hkv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = d * hd * (hq + 2 * hkv) + hq * hd * d + 3 * d * f
    want = 2 * (cfg.n_layers * per_layer + d * cfg.vocab_size) * b * s \
        + cfg.n_layers * 4 * b * hq * s * s * hd
    counts = {}
    for dev in ("meta", "cpu"):
        params = lm.init_params(cfg, device=dev)
        tokens = torch.zeros((b, s), dtype=torch.int32, device=dev)
        counts[dev] = count(lm.forward, params, cfg, {"tokens": tokens})
    assert counts["meta"]["flops"] == counts["cpu"]["flops"] == want
    assert counts["meta"]["ops"] == counts["cpu"]["ops"] > 0
    assert counts["meta"]["bytes"] == counts["cpu"]["bytes"]
    assert set(counts["meta"]["bytes_by_device"]) <= {"meta", "cpu"}


def test_count_takes_an_indexed_write_at_the_rows_it_writes():
    cache = torch.zeros((4, 1000, 8), device="meta")
    rows = torch.ones((4, 8), device="meta")

    def write():
        cache[torch.arange(4, device="meta"), torch.zeros(4, dtype=torch.long,
                                                          device="meta")] = rows

    c = count(write)
    assert c["flops"] == 0 and c["bytes"] < 4 * 1000 * 8 * 4


def test_dryrun_cuts_the_slstm_loop_to_its_exact_count():
    """xlstm's sLSTM loop counted as its first step plus the closed form of
    the rest equals the eager loop's count, forward and training."""
    cfg = registry.get_smoke_config("xlstm_1_3b")
    for kind in ("prefill", "train"):
        shape = InputShape("t", 24, 2, kind)
        cut = dryrun.count_step(cfg, shape)
        assert cut["slstm_flops_added"] > 0
        fn, args, kwargs, _ = dryrun.build(cfg, shape)
        assert cut["flops"] == count(fn, *args, **kwargs)["flops"]


# -- the dry-run ----------------------------------------------------------------

def _meta_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _meta_leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch,smoke", [(a, True) for a in registry.ARCH_IDS]
                         + [("granite_3_8b", False)])
def test_dryrun_counts_a_full_cache_decode_on_meta(arch, smoke):
    """Every arch's smoke config at decode_32k, and granite's full config
    (its 40 layers' cache at 128 x 32768 would be ~690 GB): status ok,
    every leaf on ``meta``, and no tensor the count saw on the CPU but the
    few host constants (RoPE's theta, the embedding scale)."""
    rec = dryrun.run_one(arch, "decode_32k", smoke=smoke)
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 1 and rec["roofline"]["collective_s"] == 0
    assert rec["roofline"]["bound_s"] > 0 and rec["model_flops"] > 0
    assert rec["counted"]["bytes_by_device"].get("cpu", 0) < 1024
    assert rec["memory"]["total_bytes"] == sum(v for k, v in rec["memory"].items()
                                               if k in ("params_bytes", "cache_bytes"))
    json.dumps(rec)
    cfg = registry.get_smoke_config(arch) if smoke else registry.get_config(arch)
    _, args, _, held = dryrun.build(cfg, INPUT_SHAPES["decode_32k"])
    assert all(t.device.type == "meta" for t in _meta_leaves(held) + list(args[2:]))
    if not smoke:
        assert not rec["memory"]["fits"]


def test_dryrun_matrix_rules(monkeypatch):
    rec = dryrun.run_one("granite_3_8b", "long_500k")
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]
    rec = dryrun.run_one("whisper_base", "train_4k", smoke=True)
    assert rec["status"] == "ok" and rec["memory"]["opt_state_bytes"] > 0
    assert 0 < rec["useful_flops_ratio"] < 1
    # the production meshes count one card of 512: granite's smoke config
    # with a collective term; under tp a family that tensor parallelism
    # does not list (whisper's, taken out of TP_FAMILIES here) gets an
    # error record naming item 1.13, under dp it counts (each card decodes
    # its rows alone: no collective)
    rec = dryrun.run_one("granite_3_8b", "decode_32k", "multi", smoke=True)
    assert rec["status"] == "ok" and rec["chips"] == 512 and rec["roofline"]["collective_s"] > 0
    monkeypatch.setattr(msh, "TP_FAMILIES", tuple(f for f in msh.TP_FAMILIES if f != "audio"))
    for arch, item in (("whisper_base", "1.13"),):
        rec = dryrun.run_one(arch, "decode_32k", "multi", smoke=True)
        assert rec["status"] == "error" and f"ROADMAP.md queue 1 item {item}." in rec["error"]
        rec = dryrun.run_one(arch, "decode_32k", "multi", smoke=True, profile="dp")
        assert rec["status"] == "ok" and rec["chips"] == 512 and rec["collectives"] == {}, rec
    # the chunked attention twin does the same products, and its eager
    # chunks still write every score once: it bounds what is held at a
    # time, not the counted traffic
    fused, full = (dryrun.run_one("granite_3_8b", "prefill_32k", smoke=True, fused_attn=f)
                   for f in (True, False))
    assert fused["roofline"]["flops"] == full["roofline"]["flops"]
    assert 0.8 < fused["roofline"]["bytes_accessed"] / full["roofline"]["bytes_accessed"] < 1
    assert fused["counted"]["ops"] > full["counted"]["ops"]


def test_dryrun_main_writes_its_record(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "h2o_danube_3_4b", "--shape", "prefill_32k", "--smoke",
                     "--out", str(tmp_path)])
    assert done.value.code == 0
    rec = json.loads((tmp_path / "h2o_danube_3_4b_prefill_32k_single.json").read_text())
    assert rec == json.loads(capsys.readouterr().out) and rec["status"] == "ok"


def test_input_shapes_match_assignment():
    """Twin of tests/test_launchers.py::test_input_shapes_match_assignment."""
    s = INPUT_SHAPES
    assert (s["train_4k"].seq_len, s["train_4k"].global_batch) == (4096, 256)
    assert (s["prefill_32k"].seq_len, s["prefill_32k"].global_batch) == (32768, 32)
    assert (s["decode_32k"].seq_len, s["decode_32k"].global_batch) == (32768, 128)
    assert (s["long_500k"].seq_len, s["long_500k"].global_batch) == (524288, 1)
    assert s["decode_32k"].kind == "decode" and s["long_500k"].kind == "decode"
    for arch in registry.ARCH_IDS:
        for shape in s.values():
            assert registry.runnable(registry.get_config(arch), shape) == jreg.runnable(
                jreg.get_config(arch), jreg.INPUT_SHAPES[shape.name])


def test_report_tables_from_records(tmp_path):
    """Twin of tests/test_launchers.py::test_report_tables_from_records, on
    the port's record fields."""
    rec = {"arch": "a", "shape": "train_4k", "mesh": "single", "status": "ok",
           "chips": 1, "count_s": 1.5,
           "roofline": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.0,
                        "bound_s": 2.0, "dominant": "memory", "flops": 1e12,
                        "bytes_accessed": 1e12, "coll_bytes": 0.0, "chips": 1},
           "useful_flops_ratio": 0.5, "counted": {"ops": 1234},
           "memory": {"total_bytes": 9e10, "fits": False}}
    skip = {"arch": "b", "shape": "long_500k", "mesh": "single",
            "status": "skipped", "reason": "pure full-attention arch"}
    (tmp_path / "a_train_4k_single.json").write_text(json.dumps(rec))
    (tmp_path / "b_long_500k_single.json").write_text(json.dumps(skip))
    recs = report.load(str(tmp_path), "single")
    assert len(recs) == 2
    table = report.roofline_table(recs)
    assert "**memory**" in table and "skipped" in table and "90 (no)" in table
    dtable = report.dryrun_table(recs)
    assert "1234" in dtable and "1.5" in dtable and "| 0 | memory |" in dtable
