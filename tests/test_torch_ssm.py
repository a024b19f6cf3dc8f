"""Block-level parity of the port's SSM family with the JAX reference.

Mamba2 (zamba2), mLSTM and sLSTM (xlstm): the reference initialises each
block on its smoke config (``ssm.*_init(PRNGKey(0), cfg, float32)``),
``transplant`` loads the parameters, and the same inputs, drawn with numpy
from a seed, go through ``forward`` (with and without state), ``decode``
and ``prefill`` of both packages.  The reference runs with
``use_kernels=True`` (its Pallas SSD scan and mLSTM scan in interpret mode,
where its block code dispatches them), the port on its plain CPU path.
Tolerances: 2e-4 for the scans (tests/test_kernels.py:83-88), rel < 2e-3
for block outputs and states (tests/test_ssm.py:43, tests/test_archs.py:66-67).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.kernels.ref import mlstm_scan_ref as jax_mlstm_oracle  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from test_torch_gpu import mlstm_inputs  # noqa: E402

REL = 2e-3
BLOCKS = ["mamba2", "mlstm", "slstm"]


def _arch(block: str) -> str:
    return "zamba2_1_2b" if block == "mamba2" else "xlstm_1_3b"


def rel_err(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _fns(mod, block: str):
    return tuple(getattr(mod, f"{block}_{f}") for f in ("forward", "decode", "prefill"))


@pytest.fixture(scope="module", params=BLOCKS)
def block(request):
    """(name, jax cfg, jax params, port cfg, port params, x (2,17,d) numpy)."""
    name = request.param
    cfg_j = jreg.get_smoke_config(_arch(name)).replace(use_kernels=True)
    cfg_t = registry.get_smoke_config(_arch(name))
    p_j = getattr(jssm, f"{name}_init")(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    p_t = transplant(jax.tree_util.tree_map(np.asarray, p_j), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 17, cfg_t.d_model), dtype=np.float32) * 0.5
    return name, cfg_j, p_j, cfg_t, p_t, x


def _states_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == torch.float32, k
        assert rel_err(got[k], want[k]) < REL, k


@pytest.mark.parametrize("chunk", [4, 8, 37])
def test_mlstm_chunked_matches_sequential_oracle(chunk):
    """Twin of tests/test_ssm.py::test_mlstm_chunked_matches_sequential_oracle."""
    q, k, v, logi, fpre = mlstm_inputs(np.random.default_rng(0), 2, 37, 3, 8)
    want = jax_mlstm_oracle(*(jnp.asarray(a) for a in (q, k, v, logi, fpre)))
    tq, tk, tv, tli, tfp = (torch.from_numpy(a) for a in (q, k, v, logi, fpre))
    got, (C, n, m) = ops.mlstm_chunked(tq, tk, tv, tli,
                                       torch.nn.functional.logsigmoid(tfp), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    assert C.shape == (2, 3, 8, 8) and n.shape == (2, 3, 8) and m.shape == (2, 3)
    np.testing.assert_allclose(ref.mlstm_scan_ref(tq, tk, tv, tli, tfp).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


def test_block_forward_matches_reference(block):
    name, cfg_j, p_j, cfg_t, p_t, x = block
    fwd_j, fwd_t = _fns(jssm, name)[0], _fns(ssm, name)[0]
    want = fwd_j(p_j, jnp.asarray(x), cfg_j)
    got = fwd_t(p_t, torch.from_numpy(x), cfg_t)
    assert got.shape == x.shape and rel_err(got, want) < REL
    want, st_j = fwd_j(p_j, jnp.asarray(x), cfg_j, return_state=True)
    got, st_t = fwd_t(p_t, torch.from_numpy(x), cfg_t, return_state=True)
    assert rel_err(got, want) < REL
    _states_close(st_t, st_j)


def test_block_decode_and_prefill_match_reference(block):
    """State after 9 tokens from forward, then one decode step and a prefill
    of the last 7 tokens (the exact decode recurrence) on both sides."""
    name, cfg_j, p_j, cfg_t, p_t, x = block
    fwd_j, dec_j, pre_j = _fns(jssm, name)
    fwd_t, dec_t, pre_t = _fns(ssm, name)
    _, st_j = fwd_j(p_j, jnp.asarray(x[:, :9]), cfg_j, return_state=True)
    _, st_t = fwd_t(p_t, torch.from_numpy(x[:, :9]), cfg_t, return_state=True)
    want, st_j = dec_j(p_j, jnp.asarray(x[:, 9:10]), st_j, cfg_j)
    got, st_t = dec_t(p_t, torch.from_numpy(x[:, 9:10]), st_t, cfg_t)
    assert got.shape == (2, 1, cfg_t.d_model) and rel_err(got, want) < REL
    _states_close(st_t, st_j)
    want, st_j = pre_j(p_j, jnp.asarray(x[:, 10:]), st_j, cfg_j)
    got, st_t = pre_t(p_t, torch.from_numpy(x[:, 10:]), st_t, cfg_t)
    assert got.shape == (2, 7, cfg_t.d_model) and rel_err(got, want) < REL
    _states_close(st_t, st_j)


@pytest.mark.parametrize("name", BLOCKS)
def test_forward_then_decode_equals_longer_forward(name):
    """Twin of tests/test_ssm.py::test_forward_then_decode_equals_longer_forward,
    on the port's own random weights."""
    cfg = registry.get_smoke_config(_arch(name))
    p = getattr(ssm, f"{name}_init")(cfg, torch.float32, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    fwd, dec, _ = _fns(ssm, name)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 17, cfg.d_model), dtype=np.float32) * 0.5)
    full = fwd(p, x, cfg)
    _, state = fwd(p, x[:, :16], cfg, return_state=True)
    got, _ = dec(p, x[:, 16:17], state, cfg)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, 16].numpy(), rtol=2e-3, atol=2e-3)


def test_mamba2_decode_state_advances():
    cfg = registry.get_smoke_config("zamba2_1_2b")
    p = ssm.mamba2_init(cfg, torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    cache = {k: torch.zeros(v) for k, v in ssm.mamba2_cache_shape(cfg, batch=2).items()}
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(2))
    _, c1 = ssm.mamba2_decode(p, x, cache, cfg)
    _, c2 = ssm.mamba2_decode(p, x, c1, cfg)
    assert float((c2["ssm"] - c1["ssm"]).abs().max()) > 0.0


def test_mlstm_kernel_runs_only_without_state(monkeypatch):
    """As in the reference (ssm.py:228-237): the scan entry with its kernel
    serves the stateless forward; asking for state takes the chunked twin."""
    cfg = registry.get_smoke_config("xlstm_1_3b").replace(use_kernels=True)
    p = ssm.mlstm_init(cfg, torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    calls = []
    real = ops.mlstm_scan
    monkeypatch.setattr(ops, "mlstm_scan", lambda *a, **k: calls.append(k) or real(*a, **k))
    x = torch.randn(1, 5, cfg.d_model, generator=torch.Generator().manual_seed(3))
    ssm.mlstm_forward(p, x, cfg, return_state=True)
    assert calls == []
    ssm.mlstm_forward(p, x, cfg)
    assert calls == [{"chunk": cfg.ssm_chunk, "use_kernel": True}]


def test_slstm_stabiliser_finite():
    """m is a running max of log-gates: finite after the first step."""
    cfg = registry.get_smoke_config("xlstm_1_3b")
    p = ssm.slstm_init(cfg, torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator().manual_seed(3))
    _, state = ssm.slstm_forward(p, x, cfg, return_state=True)
    assert bool(torch.isfinite(state["m"]).all()) and bool(torch.isfinite(state["h"]).all())
