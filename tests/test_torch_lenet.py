"""The port's MNIST training substrate against the JAX reference: LeNet,
AdamW, the schedules, the trainer, the synthetic data and the checkpoint
store.

Parity is by transplant: the reference builds LeNet's parameters
(``lenet.init_params(PRNGKey(0))``) and ``transplant_lenet`` loads them
into the port (conv weights HWIO -> OIHW, everything else as is); both
packages then run the same numpy images, made from a seed.  Tolerances
(rel = max|port - ref| / max|ref|): logits 1e-5, gradients 1e-4 per leaf,
one AdamW step 1e-6, a 20-step trainer trajectory 1e-4 per step's loss.
The reference runs on the CPU (``JAX_PLATFORMS=cpu``); TF32 is off for
matmuls and cuDNN throughout.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import trainjob as jtrainjob  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro.models import lenet as jlenet  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro_torch.checkpoint.store import ArtifactStore, tree_hash  # noqa: E402
from repro_torch.core.trainjob import SupervisedTrainJob  # noqa: E402
from repro_torch.data.mnist import Batches, make_dataset  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.models.transplant import transplant_lenet  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedules import constant, warmup_cosine  # noqa: E402


@pytest.fixture(autouse=True)
def no_tf32_one_thread():
    """TF32 off; one intra-op thread (LeNet's convs are tiny, and one thread
    keeps them from waiting on threads other test workers hold)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_num_threads())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
    torch.set_num_threads(saved[2])


def rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(g - w)) / (np.max(np.abs(w)) + 1e-12))


def leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_layout(tree_j):
    """The reference's tree in the port's layout (conv w OIHW), as numpy."""
    return {k: {n: np.asarray(a).transpose(3, 2, 0, 1) if k.startswith("conv") and n == "w"
                else np.asarray(a) for n, a in v.items()} for k, v in tree_j.items()}


@pytest.fixture(scope="module")
def data():
    return make_dataset(128, seed=3)


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("batch", [1, 64])
def test_lenet_forward_and_grads_match_reference(data, width, batch):
    imgs, labels = data[0][:batch], data[1][:batch]
    pj = jlenet.init_params(jax.random.PRNGKey(0), width=width)
    pt = transplant_lenet(as_numpy(pj), device="cpu")
    assert rel(lenet.apply(pt, imgs), jlenet.apply(pj, imgs)) <= 1e-5
    (loss_j, aux_j), grads_j = jax.value_and_grad(jlenet.loss_fn, has_aux=True)(
        pj, {"image": imgs, "label": labels})
    leaves_t = adamw.tree_map(lambda p: p.requires_grad_(), pt)
    loss_t, aux_t = lenet.loss_fn(leaves_t, {"image": imgs, "label": labels})
    flat = adamw.tree_leaves(leaves_t)
    grads_t = torch.autograd.grad(loss_t, flat)
    assert rel(loss_t, loss_j) <= 1e-5
    assert float(aux_t["accuracy"]) == pytest.approx(float(aux_j["accuracy"]))
    want = dict(leaves(port_layout(grads_j)))
    got = dict(zip([k for k, _ in leaves(pt)], grads_t))
    assert set(got) == set(want)
    for k in want:
        assert rel(got[k], want[k]) <= 1e-4, k


def test_transplant_lenet_layout():
    pj = as_numpy(jlenet.init_params(jax.random.PRNGKey(1), width=8))
    pt = transplant_lenet(pj, device="cpu")
    assert [k for k, _ in leaves(pt)] == [k for k, _ in leaves(pj)]
    assert tuple(pt["conv2"]["w"].shape) == (16, 8, 5, 5)
    np.testing.assert_array_equal(pt["conv1"]["w"].numpy(), pj["conv1"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(pt["fc1"]["w"].numpy(), pj["fc1"]["w"])


def test_port_init_shapes_and_generator_is_device_independent():
    p1 = lenet.init_params(torch.Generator().manual_seed(0), width=8, device="cpu")
    p2 = lenet.init_params(torch.Generator().manual_seed(0), width=8, device="cpu")
    ref = as_numpy(jlenet.init_params(jax.random.PRNGKey(0), width=8))
    shapes = {k: tuple(np.shape(v)) for k, v in leaves(port_layout(ref))}
    assert {k: tuple(v.shape) for k, v in leaves(p1)} == shapes
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(p1), leaves(p2)))


def test_adamw_step_matches_reference():
    """Decay on (the 2-D and 4-D leaves) and the clip binding: the grads'
    global norm is far above ``grad_clip``."""
    rng = np.random.default_rng(0)
    pj = as_numpy(jlenet.init_params(jax.random.PRNGKey(2), width=8))
    grads = jax.tree_util.tree_map(lambda a: rng.normal(0, 3.0, a.shape).astype(np.float32), pj)
    cfg_j = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    cfg_t = adamw.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    state_j = jadamw.init_opt_state(pj)
    new_j, state_j, m_j = jadamw.adamw_update(pj, grads, state_j, cfg_j)
    new_j, state_j, m_j = jadamw.adamw_update(new_j, grads, state_j, cfg_j)   # bias corr. at 2
    pt = transplant_lenet(pj, device="cpu")
    gt = transplant_lenet(as_numpy(grads), device="cpu")
    state_t = adamw.init_opt_state(pt)
    new_t, state_t, m_t = adamw.adamw_update(pt, gt, state_t, cfg_t)
    new_t, state_t, m_t = adamw.adamw_update(new_t, gt, state_t, cfg_t)
    assert float(m_j["grad_norm"]) > 10 * cfg_j.grad_clip
    assert rel(m_t["grad_norm"], m_j["grad_norm"]) <= 1e-6
    assert int(state_t["step"]) == int(state_j["step"]) == 2
    assert state_t["step"].dtype == torch.int32 and state_t["step"].ndim == 0
    for tree_t, tree_j in ((new_t, new_j), (state_t["mu"], state_j["mu"]),
                           (state_t["nu"], state_j["nu"])):
        want = dict(leaves(port_layout(as_numpy(tree_j))))
        for k, v in leaves(tree_t):
            assert rel(v, want[k]) <= 1e-6, k


def test_adamw_update_keeps_metrics_on_the_device():
    p = {"w": torch.ones(3)}
    new, state, m = adamw.adamw_update(p, {"w": torch.ones(3)}, adamw.init_opt_state(p),
                                       adamw.AdamWConfig())
    assert isinstance(m["grad_norm"], torch.Tensor) and not new["w"].requires_grad


def test_adamw_optimises_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.init_opt_state(params)
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, opt, _ = adamw.adamw_update({"w": w}, {"w": g}, opt, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2
    assert int(opt["step"]) == 150


def test_adamw_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    opt = adamw.init_opt_state(params)
    cfg = adamw.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    new, _, m = adamw.adamw_update(params, {"w": torch.full((3,), 1e6)}, opt, cfg)
    assert float(m["grad_norm"]) > 1e5
    assert float(new["w"].abs().max()) < 10.0


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 140])
def test_warmup_cosine_matches_reference(step):
    kw = dict(base_lr=2e-3, warmup=10, total=100, min_frac=0.1)
    assert float(warmup_cosine(step, **kw)) == pytest.approx(
        float(jschedules.warmup_cosine(step, **kw)), rel=1e-6, abs=1e-12)
    assert float(constant(step, base_lr=0.5)) == float(jschedules.constant(step, base_lr=0.5))


def test_warmup_cosine_shape():
    assert float(warmup_cosine(0, warmup=10, total=100)) == 0.0
    assert float(warmup_cosine(10, warmup=10, total=100)) > 0.9
    assert float(warmup_cosine(100, warmup=10, total=100)) < 0.2


def _reference_losses(init_j, batches, lr, n_steps):
    """Each step's loss through the reference trainer's step (its body,
    jitted, as ``SupervisedTrainJob.run`` builds it), its data re-iterated
    on ``StopIteration`` as the trainer does."""
    cfg = jadamw.AdamWConfig(lr=lr, weight_decay=1e-4)

    @jax.jit
    def step(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(jlenet.loss_fn, has_aux=True)(params, batch)
        params, opt, _ = jadamw.adamw_update(params, grads, opt, cfg)
        return params, opt, loss

    params, opt, out = init_j, jadamw.init_opt_state(init_j), []
    it = iter(batches)
    for _ in range(n_steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(batches)
            batch = next(it)
        params, opt, loss = step(params, opt, batch)
        out.append(float(loss))
    return out


def test_trainjob_trajectory_matches_reference(monkeypatch, data):
    """20 steps from the same init on the same batches (128 images in
    batches of 32: the data is re-iterated, reshuffled, every 4 steps): the
    port's trainer, its ``lenet.init_params`` swapped for the transplanted
    reference init, against the reference trainer's reports and its step,
    loss by loss."""
    imgs, labels = data
    init_j = jlenet.init_params(jax.random.PRNGKey(0), width=8)
    reports_j = []
    jtrainjob.SupervisedTrainJob(lr=2e-3, n_steps=20, width=8).run(
        jmnist.Batches(imgs, labels, 32, seed=1), report=lambda i, v: reports_j.append((i, v)))
    losses_j = _reference_losses(init_j, jmnist.Batches(imgs, labels, 32, seed=1), 2e-3, 20)
    assert [v for _, v in reports_j] == pytest.approx([losses_j[i - 1] for i, _ in reports_j],
                                                      rel=1e-6)
    monkeypatch.setattr(lenet, "init_params",
                        lambda gen, *, width, device: transplant_lenet(as_numpy(init_j),
                                                                       device=device))
    losses_t, loss_fn = [], lenet.loss_fn

    def recording(params, batch):
        loss, aux = loss_fn(params, batch)
        losses_t.append(float(loss.detach()))
        return loss, aux

    monkeypatch.setattr(lenet, "loss_fn", recording)
    reports_t = []
    res = SupervisedTrainJob(lr=2e-3, n_steps=20, width=8, device="cpu").run(
        Batches(imgs, labels, 32, seed=1), report=lambda i, v: reports_t.append((i, v)))
    assert [i for i, _ in reports_t] == [i for i, _ in reports_j] == [4, 8, 12, 16, 20]
    for (_, a), (_, b) in zip(reports_t, reports_j):
        assert abs(a - b) / abs(b) <= 1e-4
    assert len(losses_t) == len(losses_j) == 20
    for i, (a, b) in enumerate(zip(losses_t, losses_j)):
        assert abs(a - b) / abs(b) <= 1e-4, (i, a, b)
    assert losses_t[-1] < losses_t[0]
    assert res["loss"] == pytest.approx(losses_t[-1])
    assert set(res) == {"loss", "accuracy", "grad_norm", "lr", "wall_s", "params"}


def test_trainjob_checkpoint_roundtrip(tmp_path, data):
    imgs, labels = data
    store = ArtifactStore(str(tmp_path))
    res = SupervisedTrainJob(n_steps=5, store=store, device="cpu").run(
        Batches(imgs, labels, 64), checkpoint_name="rt")
    assert res["checkpoint"].startswith("file://")
    like = adamw.tree_map(torch.zeros_like, res["params"])
    restored = store.load_tree("rt", like)
    np.testing.assert_allclose(lenet.apply(restored, imgs[:4]).numpy(),
                               lenet.apply(res["params"], imgs[:4]).numpy(), rtol=1e-5)
    assert store.load_json("rt")["meta"]["loss"] == res["loss"]


# -- synthetic MNIST ----------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(32, 5), (70, 1)])
def test_make_dataset_and_batches_equal_the_reference(n, seed):
    imgs, labels = make_dataset(n, seed=seed)
    ji, jl = jmnist.make_dataset(n, seed=seed)
    assert imgs.tobytes() == ji.tobytes() and labels.tobytes() == jl.tobytes()
    assert imgs.dtype == ji.dtype and labels.dtype == jl.dtype
    # two epochs each: the second reshuffles from the iterator's own rng
    mine_it, theirs_it = Batches(imgs, labels, 16, seed=seed), jmnist.Batches(ji, jl, 16, seed=seed)
    mine = [b for _ in range(2) for b in mine_it]
    theirs = [b for _ in range(2) for b in theirs_it]
    assert len(mine) == len(theirs) == 2 * (n // 16)
    for a, b in zip(mine, theirs):
        assert a["image"].tobytes() == b["image"].tobytes()
        assert a["label"].tobytes() == b["label"].tobytes()


def test_mnist_deterministic_and_shaped():
    i1, l1 = make_dataset(32, seed=5)
    i2, l2 = make_dataset(32, seed=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(l1, l2)
    assert i1.shape == (32, 28, 28, 1) and i1.min() >= 0 and i1.max() <= 1
    assert set(np.unique(l1)).issubset(set(range(10)))


def test_mnist_classes_distinguishable():
    imgs, labels = make_dataset(256, seed=0)
    means = {d: imgs[labels == d].mean(0) for d in (0, 1)}
    assert np.abs(means[0] - means[1]).mean() > 0.02


def test_batches_iterator_drops_remainder():
    imgs, labels = make_dataset(70, seed=1)
    batches = list(Batches(imgs, labels, 32))
    assert len(batches) == 2
    assert batches[0]["image"].shape == (32, 28, 28, 1)


# -- checkpoint store ---------------------------------------------------------

def _numpy_tree():
    rng = np.random.default_rng(4)
    return {"layer": {"w": rng.normal(size=(2, 3)).astype(np.float32),
                      "b": np.ones(3, np.float32)},
            "seq": [np.arange(4, dtype=np.int32), (np.float32(2.5), None)],
            "step": np.array(7, np.int32)}


def test_tree_hash_equals_the_reference():
    tree = _numpy_tree()
    assert tree_hash(tree) == jstore.tree_hash(tree)
    params = as_numpy(jlenet.init_params(jax.random.PRNGKey(0), width=8))
    assert tree_hash(params) == jstore.tree_hash(params)
    # a tensor tree hashes as its host numpy content
    as_t = {"layer": {k: torch.from_numpy(v) for k, v in tree["layer"].items()}}
    assert tree_hash(as_t) == jstore.tree_hash({"layer": tree["layer"]})
    assert tree_hash({"w": torch.ones(2, dtype=torch.bfloat16)}) == \
        jstore.tree_hash({"w": np.ones(2, np.float32)})


def test_checkpoint_roundtrip(tmp_path):
    """A tree of tensors, one bf16, and numpy leaves: every stored leaf is
    numpy fp32 where the tensor was bf16; the reload takes each leaf's dtype
    and device from ``like``."""
    store = ArtifactStore(str(tmp_path))
    tree = {"layer": {"w": torch.arange(6.0).reshape(2, 3),
                      "b": torch.ones(3, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "host": [np.arange(3, dtype=np.int64)]}
    uri = store.save_tree("ckpt", tree, meta={"loss": 1.0})
    assert uri.startswith("file://")
    with np.load(tmp_path / "ckpt.npz") as z:
        assert sorted(z.files) == ["host/0", "layer/b", "layer/w", "step"]
        assert z["layer/b"].dtype == np.float32 and z["layer/w"].dtype == np.float32
    like = {"layer": {"w": torch.zeros(2, 3), "b": torch.zeros(3, dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32), "host": [np.zeros(3, np.int64)]}
    restored = store.load_tree("ckpt", like)
    assert tree_hash(restored) == tree_hash(tree)
    assert restored["layer"]["b"].dtype == torch.bfloat16
    assert isinstance(restored["host"], list) and restored["host"][0].dtype == np.int64
    assert store.load_json("ckpt")["hash"] == tree_hash(tree)
    # the reference reads the port's checkpoint (same keys, numpy shards)
    jlike = {"layer": {"w": jnp.zeros((2, 3)), "b": jnp.zeros(3)},
             "step": jnp.zeros((), jnp.int32), "host": [np.zeros(3, np.int64)]}
    back = jstore.ArtifactStore(str(tmp_path)).load_tree("ckpt", jlike)
    np.testing.assert_array_equal(np.asarray(back["layer"]["w"]), tree["layer"]["w"].numpy())
