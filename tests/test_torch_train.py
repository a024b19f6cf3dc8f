"""LM training on the port against the JAX reference, on the CPU.

The reference runs with ``JAX_PLATFORMS=cpu`` through its jnp path
(``use_kernels=False``: its Pallas kernels have no gradient, so it trains
without them).  Its smoke parameters (``jlm.init_params(PRNGKey(0), cfg)``,
fp32) are loaded into the port by ``transplant`` as fp32 masters, and both
sides take the same token batches.  Tolerances: rel <= 3e-4
(tests/test_kernels.py:17-19) on the loss, every gradient leaf, every
updated parameter and the AdamW moments after one step; rel <= 1e-3 on
each loss of a 12-step trajectory (its parameters are reported).  ``rel``
is max |port - reference| over max |reference|, per leaf.  Two readings
of "every" are fp32 arithmetic, not slack: a leaf whose whole reference
gradient is below 1e-6 of the tree's largest is a zero leaf (its gradient
is cancellation noise on both sides) and must stay below that floor; and
AdamW's first step, g / (|g| + eps), is compared at the elements whose
gradient the gradient gate resolves, the rest held to the step's bound.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.store import ArtifactStore as JStore  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core.trainjob import LMTrainJob as JLMTrainJob  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint.store import ArtifactStore  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import trainjob  # noqa: E402
from repro_torch.core.trainjob import LMTrainJob  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm, steps  # noqa: E402
from repro_torch.models.transplant import transplant  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ["granite_3_8b", "h2o_danube_3_4b", "minitron_4b", "gemma3_4b", "zamba2_1_2b",
         "xlstm_1_3b", "granite_moe_3b_a800m", "deepseek_v2_lite_16b", "whisper_base",
         "qwen2_vl_7b"]
B, S = 2, 32
REL = 3e-4
ZERO_LEAF = 1e-6
TRAJ_STEPS, TRAJ_REL = 12, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size models: one intra-op thread runs them about as fast as
    many, and under a multi-process test run it keeps them from waiting on
    threads the other workers hold."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed=0):
    """``lm_batches``' batch (whisper's frames, qwen2-vl's vision rows too),
    its M-RoPE positions replaced by three distinct streams (t the sequence
    index): equal streams would make M-RoPE plain RoPE."""
    b = next(tokens.lm_batches(cfg, B, S, seed=seed))
    if cfg.use_mrope:
        i = np.arange(S)
        b["mrope_positions"] = np.broadcast_to(
            np.stack([i, i // 3 + 1, (i * 7) % 5 + 2])[None], (B, 3, S)).astype(np.int32).copy()
    return b


@pytest.fixture(scope="module", params=ARCHS)
def one_step(request):
    """One training step of the arch's smoke config on both sides, from the
    reference's parameters: (loss, metrics, grads, params, mu, nu) each."""
    cfg_j = jreg.get_smoke_config(request.param)
    cfg_t = registry.get_smoke_config(request.param)
    assert cfg_t.dtype == "float32" and not cfg_t.use_kernels
    params_j = jlm.init_params(jax.random.PRNGKey(0), cfg_j)
    batch = _batch(cfg_t)

    @jax.jit
    def ref_step(params, opt):
        return (jax.value_and_grad(lambda p: jsteps.loss_fn(p, cfg_j, batch), has_aux=True)(params),
                jsteps.train_step(params, opt, batch, cfg=cfg_j))

    ((loss_j, m_j), grads_j), (new_j, opt_j, om_j) = ref_step(
        params_j, jadamw.init_opt_state(params_j))

    params_t = transplant(_np(params_j), device="cpu")
    bt = {k: torch.as_tensor(v) for k, v in batch.items()}
    leaves = adamw.tree_map(lambda p: p.clone().requires_grad_(), params_t)
    loss_t, m_t = steps.loss_fn(leaves, cfg_t, bt)
    flat = adamw.tree_leaves(leaves)
    grads_t = dict(zip(map(id, flat), torch.autograd.grad(loss_t, flat)))
    grads_t = adamw.tree_map(lambda p: grads_t[id(p)], leaves)
    opt_t = adamw.init_opt_state(params_t)
    new_t, opt_t, om_t = steps.train_step(params_t, opt_t, bt, cfg=cfg_t)
    return {"arch": request.param, "init": _np(params_j),
            "ref": (loss_j, {**m_j, **om_j}, _np(grads_j), _np(new_j), _np(opt_j)),
            "port": (loss_t, {**m_t, **om_t}, grads_t, new_t, opt_t)}


def test_train_step_loss_and_metrics_match_reference(one_step):
    loss_j, m_j = one_step["ref"][:2]
    loss_t, m_t = one_step["port"][:2]
    assert rel_err(loss_t, loss_j) < REL
    for k in ("ce", "aux", "grad_norm", "lr"):
        assert rel_err(m_t[k], m_j[k]) < REL, k


def _zero_floor(grads: dict) -> float:
    """The gradient below which a whole leaf is fp32 noise: 1e-6 of the
    tree's largest gradient.  xlstm's sLSTM input-gate bias is such a leaf:
    h = c / n is invariant to a constant shift of the input-gate
    pre-activation, so its gradient is zero, and both sides return
    cancellation noise of ~1e-10 (55 % apart)."""
    return ZERO_LEAF * max(float(np.abs(g).max()) for g in grads.values())


def _held(got: dict, want: dict, floor: float, label: str) -> None:
    """rel <= REL per leaf; a leaf whose reference is below ``floor``
    throughout must be below it on the port's side too."""
    assert got.keys() == want.keys()
    bad = {}
    for p, w in want.items():
        g = got[p].detach().numpy() if isinstance(got[p], torch.Tensor) else got[p]
        if np.abs(w).max() < floor:
            if np.abs(g).max() >= floor:
                bad[p] = f"zero leaf, port {np.abs(g).max():.3g} >= {floor:.3g}"
        elif (r := rel_err(g, w)) >= REL:
            bad[p] = r
    assert bad == {}, f"{label}: leaves off by rel >= {REL}: {bad}"


def test_train_step_gradients_match_reference(one_step):
    want = dict(_leaves(one_step["ref"][2]))
    _held(dict(_leaves(one_step["port"][2])), want, _zero_floor(want),
          f"{one_step['arch']} gradients")


def test_train_step_parameters_and_moments_match_reference(one_step, capsys):
    """mu and nu leaf by leaf; the parameters leaf by leaf at every element
    whose reference gradient the gradient gate resolves (|g| >= REL max|g|
    of its leaf) or is exactly zero outside a zero leaf (the element moves
    by its decay alone).  In between the two gradients are equal within the gate
    but their signs are not fixed, and AdamW's first step, g / (|g| + eps)
    elementwise, turns them into steps anywhere in [-lr, lr] (zamba2's
    ``shared/mixer/wv`` holds an element at 2.4e-8 against -1.6e-9, in a
    leaf whose largest gradient is 0.03).  There the step is held to its
    bound, lr (1 + wd |p|); the whole-leaf rel and the count of such
    elements are reported."""
    grads_j = dict(_leaves(one_step["ref"][2]))
    init = dict(_leaves(one_step["init"]))
    new_j, opt_j = one_step["ref"][3:]
    new_t, opt_t = one_step["port"][3:]
    assert int(opt_t["step"]) == int(opt_j["step"]) == 1
    cfg = adamw.AdamWConfig()
    floor = _zero_floor(grads_j)
    _held(dict(_leaves(opt_t["mu"])), dict(_leaves(opt_j["mu"])), (1 - cfg.b1) * floor,
          f"{one_step['arch']} mu")
    _held(dict(_leaves(opt_t["nu"])), dict(_leaves(opt_j["nu"])), (1 - cfg.b2) * floor ** 2,
          f"{one_step['arch']} nu")
    want = dict(_leaves(new_j))
    whole, bad, unresolved = {}, {}, {}
    for p, t in _leaves(new_t):
        got, w, g = t.numpy(), want[p], np.abs(grads_j[p])
        whole[p] = rel_err(t, w)
        resolved = g >= max(REL * g.max(), floor)
        if g.max() >= floor:        # an element with no gradient moves by its decay alone
            resolved |= g == 0
        unresolved[p] = (int(resolved.size - resolved.sum()), resolved.size)
        err = np.abs(got - w)
        r = float(err[resolved].max(initial=0.0) / (np.abs(w).max() + 1e-9))
        if r >= REL:
            bad[p] = r
        decay = cfg.weight_decay * np.abs(init[p]) if init[p].ndim >= 2 else 0.0
        bound = cfg.lr * (1 + decay) * (1 + REL)
        assert (np.abs(got - init[p]) <= bound).all(), f"{p}: a step past lr (1 + wd |p|)"
    assert bad == {}, f"{one_step['arch']} params: leaves off by rel >= {REL}: {bad}"
    worst = max(whole, key=whole.get)
    most = max(unresolved, key=lambda p: unresolved[p][0] / unresolved[p][1])
    n_out, n_all = (sum(v[i] for v in unresolved.values()) for i in (0, 1))
    with capsys.disabled():
        print(f"\n{one_step['arch']}: parameters after one step, whole-leaf rel at most "
              f"{whole[worst]:.3g} ({worst}); held to the step bound only: {n_out} of "
              f"{n_all} elements, the most in {most} ({unresolved[most][0]} of "
              f"{unresolved[most][1]})")


@pytest.mark.parametrize("causal,window,hq,hkv,d,s", [
    (True, 0, 8, 2, 64, 40),        # causal, GQA 4:1, S no multiple of 16
    (True, 16, 8, 2, 120, 37),      # window 16, h2o's D 120
    (True, 16, 4, 1, 64, 50),
    (False, 0, 4, 4, 32, 24),
])
def test_attention_gradients_match_reference(causal, window, hq, hkv, d, s):
    """jax.grad of the reference's ``ops.flash_attention`` (jnp path)
    against autograd of the port's twin, at 3e-4."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, s, hq, d), dtype=np.float32)
    k, v = (rng.standard_normal((2, s, hkv, d), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal((2, s, hq, d), dtype=np.float32)

    def jloss(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, causal=causal, window=window,
                                            use_kernel=False) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window, use_kernel=True)
    got = torch.autograd.grad((out * torch.tensor(w)).sum(), (qt, kt, vt))
    for g, wt in zip(got, want):
        assert rel_err(g, wt) < REL


@pytest.mark.parametrize("shape", [(3, 17, 64), (2, 37, 120), (5, 3840)])
def test_rmsnorm_gradients_match_reference(shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape, dtype=np.float32)
    scale = rng.standard_normal(shape[-1], dtype=np.float32) * 0.1
    w = rng.standard_normal(shape, dtype=np.float32)
    want = jax.jit(jax.grad(lambda x, s: jnp.sum(jops.rmsnorm(x, s, use_kernel=False) * w),
                            argnums=(0, 1)))(x, scale)
    xt, st = torch.tensor(x, requires_grad=True), torch.tensor(scale, requires_grad=True)
    got = torch.autograd.grad((ops.rmsnorm(xt, st, use_kernel=True) * torch.tensor(w)).sum(),
                              (xt, st))
    for g, wt in zip(got, want):
        assert rel_err(g, wt) < REL


def test_backward_twins_are_autograd_of_the_forward_twins():
    """``ops.flash_attention_bwd`` / ``ops.rmsnorm_bwd`` on the CPU: the
    gradients the kernels are held to (attention's at the fp32 values of
    its inputs)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 20, 4, 16, generator=g)
    k, v = torch.randn(1, 20, 2, 16, generator=g), torch.randn(1, 20, 2, 16, generator=g)
    do = torch.randn(1, 20, 4, 16, generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention(*leaves, window=8), leaves, do)
    got = ops.flash_attention_bwd(q, k, v, do, None, window=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # bf16 inputs: the gradient at their fp32 values, rounded to bf16
    bf = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    leaves = [t.float().requires_grad_() for t in bf[:3]]
    want = torch.autograd.grad(ops.flash_attention(*leaves, window=8), leaves, bf[3].float())
    got = ops.flash_attention_bwd(*bf, None, window=8)
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
               for a, b in zip(got, want))
    x, s, gy = torch.randn(6, 32, generator=g), torch.randn(32, generator=g), torch.randn(6, 32)
    leaves = [x.clone().requires_grad_(), s.clone().requires_grad_()]
    want = torch.autograd.grad(ops.rmsnorm(*leaves), leaves, gy)
    assert all(torch.equal(a, b) for a, b in zip(ops.rmsnorm_bwd(x, s, gy, None), want))


def _reference_params(cfg_j, seed):
    return _np(jlm.init_params(jax.random.PRNGKey(seed), cfg_j))


def test_lm_trainjob_trajectory_matches_reference(tmp_path, monkeypatch, capsys):
    """``LMTrainJob.run`` on both sides for TRAJ_STEPS steps (granite smoke,
    warmup-cosine, each side's own ``lm_batches``), the port starting from
    the reference's parameters: every loss within 1e-3."""
    cfg_j = jreg.get_smoke_config("granite_3_8b")
    cfg_t = registry.get_smoke_config("granite_3_8b")
    kw = dict(batch_size=B, seq_len=S, n_steps=TRAJ_STEPS, lr=2e-3)
    ref = JLMTrainJob(cfg_j, **kw, store=JStore(str(tmp_path / "ref"))).run()
    init = _reference_params(cfg_j, 0)
    monkeypatch.setattr(trainjob.lm, "init_params",
                        lambda cfg, seed, device, dtype: transplant(init, device=device,
                                                                   dtype=dtype))
    port = LMTrainJob(cfg_t, **kw, device="cpu").run()
    rels = [abs(a - b) / abs(b) for a, b in zip(port["history"], ref["history"])]
    params = {p: rel_err(t, w) for (p, t), (_, w) in
              zip(_leaves(port["params"]), _leaves(_np(ref["params"])))}
    with capsys.disabled():
        print(f"\n{TRAJ_STEPS}-step trajectory, rel loss per step {[f'{r:.2e}' for r in rels]}; "
              f"parameters after it, largest rel {max(params.values()):.3g} "
              f"({max(params, key=params.get)})")
    assert len(rels) == TRAJ_STEPS and max(rels) <= TRAJ_REL, rels


def test_lm_batches_equal_reference_for_every_family_field():
    """Three batches, array for array, for a dense, an M-RoPE/vision and an
    audio config (every field ``lm_batches`` emits)."""
    for arch in ("granite_3_8b", "qwen2_vl_7b", "whisper_base"):
        cfg = jreg.get_smoke_config(arch)
        got = list(tokens.lm_batches(cfg, 3, 24, seed=5, n_batches=3))
        want = list(jtokens.lm_batches(cfg, 3, 24, seed=5, n_batches=3))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (arch, k)
    keys = set(next(tokens.lm_batches(jreg.get_smoke_config("qwen2_vl_7b"), 1, 8)))
    assert keys == {"tokens", "labels", "mrope_positions", "vision_embeds"}


def test_adamw_update_in_place_is_bitwise_the_functional_update():
    """The in-place step and the functional one (which runs it on copies)
    agree bit for bit, and the functional one leaves its inputs as they were."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(7, 5, generator=g), "b": torch.randn(5, generator=g),
              "n": {"s": torch.randn(3, 4, 2, generator=g)}}
    cfg = adamw.AdamWConfig(lr=1e-2)
    fp, fs = params, adamw.init_opt_state(params)
    ip = adamw.tree_map(torch.clone, params)
    ins = adamw.init_opt_state(ip)
    for i in range(4):
        grads = adamw.tree_map(lambda p: torch.randn(p.shape, generator=g) * 3, params)
        scale = torch.tensor(0.5 + 0.1 * i)
        inputs = adamw.tree_leaves({"p": fp, "mu": fs["mu"], "nu": fs["nu"], "step": fs["step"]})
        before = [t.clone() for t in inputs]
        fp, fs, fm = adamw.adamw_update(fp, grads, fs, cfg, lr_scale=scale)
        assert all(torch.equal(a, b) for a, b in zip(before, inputs))
        im = adamw.adamw_update_(ip, grads, ins, cfg, lr_scale=scale)
        for f, n in ((fp, ip), (fs["mu"], ins["mu"]), (fs["nu"], ins["nu"])):
            assert all(torch.equal(a, b) for a, b in zip(adamw.tree_leaves(f),
                                                         adamw.tree_leaves(n)))
        assert torch.equal(fs["step"], ins["step"]) and torch.equal(fm["grad_norm"],
                                                                   im["grad_norm"])


def _grads(cfg, params, batch):
    leaves = adamw.tree_map(lambda p: p.clone().requires_grad_(), params)
    loss, _ = steps.loss_fn(leaves, cfg, batch)
    return loss, torch.autograd.grad(loss, adamw.tree_leaves(leaves))


@pytest.mark.parametrize("arch", ["granite_3_8b", "zamba2_1_2b"])
def test_remat_gives_the_same_gradients(arch):
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    loss0, g0 = _grads(cfg, params, batch)
    loss1, g1 = _grads(cfg.replace(remat=True), params, batch)
    assert torch.equal(loss0, loss1)
    assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-7) for a, b in zip(g0, g1))


def test_train_step_refuses_a_leaf_without_gradient():
    """``allow_unused=False``: a parameter the loss never reaches raises
    instead of silently keeping its value."""
    cfg = registry.get_smoke_config("granite_3_8b")
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    params["orphan"] = torch.zeros(3)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    with pytest.raises(RuntimeError, match="not have been used"):
        steps.train_step(params, adamw.init_opt_state(params), batch, cfg=cfg)


def test_forward_casts_fp32_masters_to_the_compute_dtype():
    """Training's fp32 masters through a bf16 forward: the same logits as the
    tree cast once by hand (the reference's ``cast_tree``), and serving's
    bf16 tree passes through uncopied."""
    cfg = registry.get_smoke_config("granite_3_8b").replace(dtype="bfloat16")
    masters = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for _, t in _leaves(masters))
    bf16 = adamw.tree_map(lambda t: t.to(torch.bfloat16), masters)
    toks = torch.as_tensor(_batch(cfg)["tokens"])
    with torch.no_grad():
        a = lm.forward(masters, cfg, {"tokens": toks})[0]
        b = lm.forward(bf16, cfg, {"tokens": toks})[0]
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert lm._cast_tree(bf16, torch.bfloat16)["embed"] is bf16["embed"]
    assert lm.init_params(cfg, seed=0, device="cpu")["embed"].dtype == torch.bfloat16


def test_transplant_keeps_fp32_and_the_store_round_trips_masters_and_step(tmp_path):
    cfg_j = jreg.get_smoke_config("granite_3_8b")
    params = transplant(_reference_params(cfg_j, 0), device="cpu")
    assert {t.dtype for _, t in _leaves(params)} == {torch.float32}
    opt = adamw.init_opt_state(params)
    opt["step"] = opt["step"] + 7
    store = ArtifactStore(str(tmp_path))
    store.save_tree("m", params)
    store.save_tree("m_opt", opt)
    zeros = adamw.tree_map(torch.zeros_like, params)
    back = store.load_tree("m", zeros)
    back_opt = store.load_tree("m_opt", adamw.init_opt_state(zeros))
    assert all(torch.equal(a, b) for a, b in zip(adamw.tree_leaves(back),
                                                 adamw.tree_leaves(params)))
    assert back_opt["step"].dtype == torch.int32 and back_opt["step"].shape == ()
    assert int(back_opt["step"]) == 7


# -- twins of the reference's own training tests, on the port ---------------
def _smoke_t(arch):
    return registry.get_smoke_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_nothing_nan(arch):
    """Twin of tests/test_archs.py::test_train_step_decreases_nothing_nan."""
    cfg = _smoke_t(arch)
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    opt = adamw.init_opt_state(params)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, seed=1).items()}
    params, opt, m = steps.train_step(params, opt, batch, cfg=cfg)
    assert np.isfinite(float(m["loss"]))
    assert np.isfinite(float(m["grad_norm"]))
    assert int(opt["step"]) == 1


def test_lm_trainjob_loss_decreases(tmp_path):
    """Twin of tests/test_system.py::test_lm_trainjob_loss_decreases."""
    cfg = _smoke_t("granite_3_8b")
    job = LMTrainJob(cfg, batch_size=4, seq_len=32, n_steps=12, lr=2e-3,
                     store=ArtifactStore(str(tmp_path)), device="cpu")
    res = job.run(checkpoint_name="lm-smoke")
    assert len(res["history"]) == 12
    assert res["history"][-1] < res["history"][0]
    assert "checkpoint" in res


def test_lm_trainjob_resume_continues_from_checkpoint(tmp_path):
    """Twin of tests/test_system.py::test_lm_trainjob_resume_continues_from_checkpoint."""
    cfg = _smoke_t("h2o_danube_3_4b")
    store = ArtifactStore(str(tmp_path))
    job = functools.partial(LMTrainJob, cfg, batch_size=2, seq_len=32, lr=2e-3, store=store,
                            device="cpu")
    job(n_steps=6).run(checkpoint_name="resume-test")
    r2 = job(n_steps=3).run(resume_from="resume-test")
    r3 = job(n_steps=3).run()
    assert abs(r2["history"][0] - r3["history"][0]) > 1e-6
    assert r2["history"][0] < r3["history"][0]


def test_lm_trainjob_refuses_a_mesh(monkeypatch):
    """An arch of a family that tensor parallelism does not list (whisper's,
    taken out of ``TP_FAMILIES`` here): a mesh whose rules would shard a
    parameter (the tp profile on a model axis of 2) raises before any work,
    naming item 1.13; the dp profile on that mesh shards none."""
    from repro_torch.models import sharding
    from repro_torch.models.sharding import abstract_mesh
    monkeypatch.setattr(sharding, "TP_FAMILIES",
                        tuple(f for f in sharding.TP_FAMILIES if f != "audio"))
    cfg = _smoke_t("whisper_base")
    mesh = abstract_mesh((1, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md queue 1 item 1\.13\b"):
        LMTrainJob(cfg, batch_size=1, seq_len=8, n_steps=1, mesh=mesh, device="cpu").run()
    assert trainjob._refuse_sharded_params(cfg.replace(sharding_profile="dp"), mesh) is None


@pytest.mark.parametrize("arch", ["qwen2_vl_7b", "whisper_base"])
def test_lm_trainjob_feeds_every_field_of_the_batch(arch, monkeypatch):
    """``LMTrainJob`` passes every field ``lm_batches`` emits (M-RoPE
    positions, vision rows, frames) to the step, as the reference's does:
    it once passed tokens and labels alone, and both archs raised
    ``KeyError`` (ROADMAP.md queue 3).  Three steps from the reference's
    init, every loss within the trajectory tolerance."""
    cfg_j = jreg.get_smoke_config(arch)
    kw = dict(batch_size=B, seq_len=S, n_steps=3, lr=2e-3)
    ref = JLMTrainJob(cfg_j, **kw).run()["history"]
    init = _reference_params(cfg_j, 0)
    monkeypatch.setattr(trainjob.lm, "init_params",
                        lambda cfg, seed, device, dtype: transplant(init, device=device,
                                                                   dtype=dtype))
    got = LMTrainJob(registry.get_smoke_config(arch), **kw, device="cpu").run()["history"]
    assert len(got) == 3
    assert max(abs(a - b) / abs(b) for a, b in zip(got, ref)) <= TRAJ_REL
