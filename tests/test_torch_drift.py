"""bf16 rounding drift of the port against the JAX reference's own.

``chip_smoke.py`` finds random-weight zamba2 and xlstm logits in bf16 far
from the same weights run in fp32, on the kernel path and the plain path
alike, so it holds the two paths against each other in fp32.  This file is
the reference's side of that explanation: at the smoke widths, at the
smoke depth and at the full config's depth (and grouping), the reference's
plain path (``lm.forward``, ``use_kernels=False``) and the port's plain CPU
path each run the same bf16-rounded weights and token ids in bf16 and in
fp32.  The drift (max |bf16 - fp32| over max |fp32|) is the reference's own
and grows with depth; the port's may be at most 1.5 times the reference's
(the chip gate's ratio), and the two fp32 runs agree at rel < 2e-3
(tests/test_archs.py:66-67).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_drift.py

prints the table PERF.md quotes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402

ARCHS = ["granite_3_8b", "zamba2_1_2b", "xlstm_1_3b"]
DEPTHS = ["smoke", "full"]
B, S = 4, 128                   # chip_smoke.py's batch and prompt
DRIFT_RATIO = 1.5
REL = 2e-3


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _cut(cfg, arch: str, depth: str):
    """Smoke widths; at "full", the full config's depth and grouping."""
    if depth == "smoke":
        return cfg
    full = jreg.get_config(arch)
    return cfg.replace(n_layers=full.n_layers, shared_attn_every=full.shared_attn_every,
                       slstm_every=full.slstm_every)


def drift(arch: str, depth: str) -> dict:
    cfg_j = _cut(jreg.get_smoke_config(arch).replace(use_kernels=False), arch, depth)
    cfg_t = _cut(registry.get_smoke_config(arch), arch, depth)
    params = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    # both dtypes run the weights bf16 holds, as chip_smoke.py's fp32 run does
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32))
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), params)
    tokens = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (B, S), dtype=np.int32)
    ref, port = {}, {}
    for dtype, tdtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        logits, _, _ = jlm.forward(params, cfg_j.replace(dtype=dtype),
                                   {"tokens": jnp.asarray(tokens)})
        ref[dtype] = np.asarray(logits.astype(jnp.float32))
        with torch.inference_mode():
            logits, _, _ = lm.forward(transplant(params, device="cpu", dtype=tdtype),
                                      cfg_t.replace(dtype=dtype),
                                      {"tokens": torch.from_numpy(tokens)})
        port[dtype] = logits.float().numpy()
    return {"layers": cfg_t.n_layers,
            "ref_bf16_vs_fp32": rel_err(ref["bfloat16"], ref["float32"]),
            "port_bf16_vs_fp32": rel_err(port["bfloat16"], port["float32"]),
            "port_vs_ref_bf16": rel_err(port["bfloat16"], ref["bfloat16"]),
            "port_vs_ref_fp32": rel_err(port["float32"], ref["float32"])}


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_port_bf16_drift_tracks_reference(arch, depth):
    d = drift(arch, depth)
    assert d["port_vs_ref_fp32"] < REL, d
    assert d["port_bf16_vs_fp32"] <= DRIFT_RATIO * d["ref_bf16_vs_fp32"], d


if __name__ == "__main__":
    print("arch, depth (layers): reference bf16 vs fp32 | port bf16 vs fp32 | "
          "port vs reference, bf16 | port vs reference, fp32")
    for arch in ARCHS:
        for depth in DEPTHS:
            d = drift(arch, depth)
            print(f"{arch}, {depth} ({d['layers']}): {d['ref_bf16_vs_fp32']:.4g} | "
                  f"{d['port_bf16_vs_fp32']:.4g} | {d['port_vs_ref_bf16']:.4g} | "
                  f"{d['port_vs_ref_fp32']:.4g}", flush=True)
