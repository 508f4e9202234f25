"""The routers and the optimizer of the port against the JAX package.

* ``adamw`` (with global-norm clipping and weight decay): two steps on the
  same parameters and gradients match JAX's within 1e-7.
* The MLP router's init draws JAX's threefry normals: within 1e-6 (XLA's
  and torch's ``log1p`` may round an ulp apart inside ``erfinv``).
* Predictions of JAX-trained parameters carried into the port: within 1e-6.
* A router trained in both from the same seed, on the same labels:
  predictions within 1e-5 (1.2e-7 measured on a CPU, seeds 0-2).
* The KNN router is numpy on both sides: bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro.core.robatch import collect_router_labels
from repro.data import make_simulated_pool, make_workload
from repro.training import optimizer as joptimizer
from repro_torch.core import router
from repro_torch.training import optimizer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: its models here are tiny, so
    a pool of threads a process only adds contention when the suite runs in
    several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def task():
    wl = make_workload("agnews", n_train=192, n_val=48, n_test=96)
    tr, te = wl.subset_indices("train"), wl.subset_indices("test")
    labels = collect_router_labels(make_simulated_pool("qwen3"), wl, tr)
    return wl.embeddings[tr], labels, wl.embeddings[te]


def test_adamw_steps_match():
    rng = np.random.default_rng(0)
    shapes = [(8, 16), (16,), (16, 3), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(10 * rng.normal(size=s)).astype(np.float32) for s in shapes] for _ in range(2)]
    jopt = joptimizer.adamw(1e-3, weight_decay=1e-4, grad_clip=1.0)
    opt = optimizer.adamw(1e-3, weight_decay=1e-4, grad_clip=1.0)
    jp = [{"x": jnp.asarray(p)} for p in params]
    tp = [torch.tensor(p) for p in params]
    jstate, state = jopt.init(jp), opt.init(tp)
    for g in grads:
        jp, jstate = jopt.update([{"x": jnp.asarray(x)} for x in g], jstate, jp)
        tp, state = opt.update([torch.tensor(x) for x in g], state, tp)
    assert state.step == int(jstate.step) == 2
    for a, b, m, v, jm, jv in zip(jp, tp, state.mu, state.nu, jstate.mu, jstate.nu):
        np.testing.assert_allclose(b.numpy(), np.asarray(a["x"]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm["x"]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv["x"]), rtol=0, atol=1e-7)
    g = [torch.tensor(x) for x in grads[0]]
    clipped, norm = optimizer.clip_by_global_norm(g, 1.0)
    jclipped, jnorm = joptimizer.clip_by_global_norm([jnp.asarray(x) for x in grads[0]], 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-7)
    for a, b in zip(jclipped, clipped):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-7)


@pytest.mark.parametrize("seed,dims", [(0, (64, 256, 128, 3)), (7, (8, 256, 128, 2)),
                                       (123, (32, 16, 5))])
def test_mlp_init_matches_jax(seed, dims):
    jp = jrouter._init_mlp(jax.random.PRNGKey(seed), dims)
    tp = router.init_mlp_params(seed, dims, "cpu")
    for a, (w, b) in zip(jp, tp):
        assert tuple(w.shape) == a["w"].shape and w.dtype == torch.float32
        np.testing.assert_allclose(w.numpy(), np.asarray(a["w"]), rtol=0, atol=1e-6)
        assert not b.any() and tuple(b.shape) == a["b"].shape


def test_carried_and_trained_routers_match_jax(task):
    emb_tr, labels, emb_te = task
    for seed in (0, 1):
        jr = jrouter.train_mlp_router(emb_tr, labels, seed=seed)
        want = jr.predict(emb_te)
        carried = router.router_from_params(jr.params, device="cpu")
        got = carried.predict(emb_te)
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        trained = router.train_mlp_router(emb_tr, labels, seed=seed, device="cpu")
        assert (trained.embed_dim, trained.n_models) == (jr.embed_dim, jr.n_models)
        np.testing.assert_allclose(trained.predict(emb_te), want, rtol=0, atol=1e-5)


def test_knn_router_matches_bit_for_bit(task):
    emb_tr, labels, emb_te = task
    for k in (1, 16, 500):
        want = jrouter.KNNRouter(emb_tr.astype(np.float32), labels, k=k).predict(emb_te)
        got = router.KNNRouter(emb_tr.astype(np.float32), labels, k=k).predict(emb_te)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_mlp_router_defaults_to_the_card(task):
    emb_tr, labels, _ = task
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        router.train_mlp_router(emb_tr, labels, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        router.router_from_params([{"w": np.zeros((2, 2)), "b": np.zeros(2)}])
