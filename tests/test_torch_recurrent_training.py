"""Training the recurrent families in the port, against the JAX package on the CPU.

The plain backwards of the three kernels this training runs through on the
card: ``wkv6_backward_plain`` against ``jax.vjp`` of ``_wkv6_jnp`` and of the
token-by-token oracle ``wkv6_ref`` (and, at decays near 1e-12 and 1, where
``_wkv6_jnp``'s fp32 differences of cumulative log-decays lose ~1e-4 of a
pair decay, against autograd through the float64 ``wkv6_plain`` and a
float64 token-by-token recurrence); ``rglru_backward_plain`` against
``jax.vjp`` of ``_rglru_jnp`` and ``rglru_ref``, with gates at the clamp;
the plain flash backward at RecurrentGemma's D=256, G=16 with a window
shorter than the sequence against ``jax.grad`` of ``_flash_jnp``.  Then the
models: loss and every gradient of ``reduced()`` RWKV6-3B (S=40 > CHUNK)
and RecurrentGemma-9B (S=48 > window 32) from JAX's weights through the
bridge against ``jax.value_and_grad(Model.loss)`` (1e-5 relative, 1e-4 of
each leaf's largest gradient, as ``test_torch_training.py``), remat
``"block"`` against ``"none"`` bit for bit, a 5-step ``Trainer.fit``
against JAX's ``Trainer`` (losses within 1e-4), the launcher, no autograd
node under ``no_grad``, and the CUDA wrappers' refusals.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them
against these plain versions.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.transformer import Model as JaxModel
from repro.training.optimizer import adamw as jax_adamw
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.config import ShardingConfig, get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_cuda,
    flash_attention_backward_plain,
)
from repro_torch.kernels.rglru_scan import (
    RGLRU,
    rglru_backward_cuda,
    rglru_backward_plain,
    rglru_plain,
)
from repro_torch.kernels.rwkv6_scan import (
    CHUNK,
    WKV6,
    wkv6_backward_cuda,
    wkv6_backward_plain,
    wkv6_plain,
)
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import adamw
from repro_torch.training.train_loop import Trainer, trainable

ROOT = Path(__file__).resolve().parents[1]
KERNEL_TOL = 1e-5        # of each gradient's largest |value| (or 1 below it)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |gradient|
FIT_RTOL = 1e-4
MODELS = {"rwkv6-3b": 40, "recurrentgemma-9b": 48}   # arch: sequence length


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=KERNEL_TOL, label=""):
    got, want = (torch.as_tensor(np.array(x)).double() for x in (got, want))
    assert got.shape == want.shape, label
    scale = max(want.abs().max().item(), 1.0)
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"{label}: {err:.3g} of {scale:.3g}"


# ---- the WKV6 backward ------------------------------------------------------

def _wkv6_inputs(seed, T, state, decays="mild", B=2, H=3, D=16):
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
    if decays == "mild":        # exp(−exp(U(−3, 1))): where _wkv6_jnp is exact to fp32
        lo, hi = -3.0, 1.0
    else:                       # near 1 beside near 1e-12 (and below it, clipped)
        lo, hi = -8.0, 3.4
    w = np.exp(-np.exp(rng.uniform(lo, hi, (B, T, H, D)))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, D))).astype(np.float32)
    s0 = rng.standard_normal((B, H, D, D)).astype(np.float32) if state else None
    ds = rng.standard_normal((B, H, D, D)).astype(np.float32) if state else None
    return r, k, v, w, u, s0, do, ds


def _torch(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("T", [1, 31, 40, 64])
def test_wkv6_backward_plain_matches_jax(T, state):
    r, k, v, w, u, s0, do, ds = _wkv6_inputs(T * 7 + state, T, state)
    got = wkv6_backward_plain(*_torch(r, k, v, w, u, do, s0, ds))
    s0j = jnp.zeros((2, 3, 16, 16), jnp.float32) if s0 is None else jnp.asarray(s0)
    dsj = jnp.zeros_like(s0j) if ds is None else jnp.asarray(ds)
    for name, fn in (("_wkv6_jnp", lambda *a: jops._wkv6_jnp(*a, CHUNK)),
                     ("wkv6_ref", jref.wkv6_ref)):
        _, vjp = jax.vjp(fn, *map(jnp.asarray, (r, k, v, w, u)), s0j)
        want = vjp((jnp.asarray(do), dsj))
        for g, wnt, leaf in zip(got, want, ("dr", "dk", "dv", "dw", "du", "dstate")):
            _close(g, wnt, label=f"{name} {leaf}")


def _wkv6_token_oracle(r, k, v, w, u, s0):
    """The recurrence token by token in float64, autograd-friendly."""
    B, T, H, D = r.shape
    S = torch.zeros((B, H, D, D), dtype=torch.float64) if s0 is None else s0.double()
    wd = torch.exp(torch.log(w.clamp(1e-12, 1.0)).double())
    outs = []
    for t in range(T):
        kv = k[:, t, ..., None].double() * v[:, t, :, None, :].double()
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t].double(),
                                 S + u.double()[None, :, :, None] * kv))
        S = wd[:, t, ..., None] * S + kv
    return torch.stack(outs, 1), S


@pytest.mark.parametrize("state", [False, True])
def test_wkv6_backward_plain_at_extreme_decays(state):
    """Decays from 3e-13 to 1 − 3e-4 in one chunk.  Every gradient but ∂w is
    held against autograd through the float64 ``wkv6_plain``, and ∂w through
    the log, w·∂w, the kernel's own ∂lw; ∂w itself against a float64
    token-by-token recurrence, whose ∂lw holds w_t in every term as the
    plain backward's does (the chunked form's autograd takes it as a
    difference and is a few 1e-3 off where w is 1e-12)."""
    r, k, v, w, u, s0, do, ds = _torch(*_wkv6_inputs(5 + state, 40, state, decays="extreme"))
    assert (w < 1e-12).any() and (w > 0.999).any()
    got = wkv6_backward_plain(r, k, v, w, u, do, s0, ds)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u)]
    leaves.append(s0.clone().requires_grad_() if state else None)
    for name, fwd in (("wkv6_plain", wkv6_plain), ("token oracle", _wkv6_token_oracle)):
        out, s_out = fwd(*leaves)
        loss = (out.double() * do.double()).sum()
        if state:
            loss = loss + (s_out.double() * ds.double()).sum()
        want = torch.autograd.grad(loss, [x for x in leaves if x is not None])
        for i, (g, wnt, leaf) in enumerate(zip(got, want, ("dr", "dk", "dv", "dw", "du",
                                                           "dstate"))):
            if leaf == "dw" and name == "wkv6_plain":
                g, wnt = g * w, wnt * w
            _close(g, wnt, label=f"{name} {leaf}")


# ---- the RG-LRU backward ----------------------------------------------------

def _rglru_inputs(seed, T, B=2, W=48):
    rng = np.random.default_rng(seed)
    x, dh = (rng.standard_normal((B, T, W)).astype(np.float32) for _ in range(2))
    al = -np.abs(0.5 * rng.standard_normal((B, T, W))).astype(np.float32)
    al[:, :, :8] = -rng.uniform(0, 1e-6, (B, T, 8))         # 1 − exp(2a) keeps a few bits
    al[:, :, 8:12] = -rng.uniform(1e-10, 1e-8, (B, T, 4))    # exp(2a) rounds to 1: clamped
    al[:, :, 12:16] = -rng.uniform(0, 20, (B, T, 4))         # strong
    s0, ds = (rng.standard_normal((B, W)).astype(np.float32) for _ in range(2))
    return x, al, s0, dh, ds


@pytest.mark.parametrize("T", [1, 17, 40])
def test_rglru_backward_plain_matches_jax(T):
    x, al, s0, dh, ds = _rglru_inputs(T, T)
    assert (1.0 - np.exp(2.0 * al[:, :, 8:12].astype(np.float64)).astype(np.float32)
            == 0).all()
    got = rglru_backward_plain(*_torch(x, al, dh, s0, ds))
    for name, fn in (("_rglru_jnp", jops._rglru_jnp), ("rglru_ref", jref.rglru_ref)):
        # compiled whole, as the JAX model runs it (op by op it takes ~6 s a call)
        _, vjp = jax.vjp(jax.jit(fn), *map(jnp.asarray, (x, al, s0)))
        want = vjp((jnp.asarray(dh), jnp.asarray(ds)))
        for g, wnt, leaf in zip(got, want, ("dx", "da_log", "dstate")):
            _close(g, wnt, label=f"{name} {leaf}")
    # where the clamp holds, the gate's gradient is zero: ∂a is δ·a·h alone
    lv = [t.clone().requires_grad_() for t in _torch(x, al, s0)]
    h, hT = rglru_plain(*lv)
    auto = torch.autograd.grad((h * torch.from_numpy(dh)).sum()
                               + (hT * torch.from_numpy(ds)).sum(), lv)
    for g, wnt, leaf in zip(got, auto, ("dx", "da_log", "dstate")):
        _close(g, wnt, label=f"autograd {leaf}")


# ---- the flash backward at D = 256 --------------------------------------------

@pytest.mark.parametrize("window", [32, None])
def test_flash_backward_plain_d256_window(window):
    """RecurrentGemma's local attention, reduced in length: 16 query heads on
    one KV head of 256, causal, a window of 32 over 48 positions."""
    rng = np.random.default_rng(256)
    B, S, H, D = 1, 48, 16, 256
    q, do = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, 1, D)).astype(np.float32) for _ in range(2))
    got = flash_attention_backward_plain(*_torch(q, k, v, do), window=window)

    def f(q, k, v):
        return jops._flash_jnp(q, k, v, causal=True, window=window, q_block=512,
                               kv_block=1024, causal_skip=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    for g, wnt, leaf in zip(got, vjp(jnp.asarray(do)), ("dq", "dk", "dv")):
        _close(g, wnt, label=leaf)


# ---- the ops routing ----------------------------------------------------------

def test_recurrences_build_nodes_only_under_grad():
    r, k, v, w, u, s0, _, _ = _torch(*_wkv6_inputs(1, 5, True))
    x, al, h0, _, _ = _torch(*_rglru_inputs(1, 5))
    calls = []
    for fn in (WKV6, RGLRU):
        fn.apply_saved = fn.apply
        fn.apply = (lambda f: lambda *a: calls.append(f.__name__) or f.apply_saved(*a))(fn)
    try:
        wr = w.clone().requires_grad_()
        xr = x.clone().requires_grad_()
        with torch.no_grad():
            out, _ = ops.wkv6(r, k, v, wr, u, s0)
            h, _ = ops.rglru_scan(xr, al, h0)
        assert out.grad_fn is None and h.grad_fn is None and not calls
        out, _ = ops.wkv6(r, k, v, w, u, s0)          # nothing requires grad
        h, _ = ops.rglru_scan(x, al, h0)
        assert out.grad_fn is None and h.grad_fn is None and not calls
        out, s_out = ops.wkv6(r, k, v, wr, u, s0)
        h, h_out = ops.rglru_scan(xr, al, h0)
        assert calls == ["WKV6", "RGLRU"]
        assert out.grad_fn is not None and h.grad_fn is not None
        # the node's gradients are the plain backward's
        gw, = torch.autograd.grad(out.sum() + s_out.sum(), wr)
        gx, = torch.autograd.grad(h.sum() + h_out.sum(), xr)
        _, _, _, dw, _, _ = wkv6_backward_plain(r, k, v, w, u, torch.ones_like(r), s0,
                                                torch.ones_like(s0))
        dx, _, _ = rglru_backward_plain(x, al, torch.ones_like(x), h0, torch.ones_like(h0))
        assert torch.equal(gw, dw) and torch.equal(gx, dx)
    finally:
        for fn in (WKV6, RGLRU):
            fn.apply = fn.apply_saved
            del fn.apply_saved


def test_backward_wrappers_refuse():
    """CPU tensors never reach a kernel, and a shape or width a kernel does
    not take raises as such before any device is looked at."""
    r, k, v, w, u, s0, do, ds = _torch(*_wkv6_inputs(2, 4, True))
    with pytest.raises(ValueError, match="not a CUDA device"):
        wkv6_backward_cuda(r, k, v, w, u, do, s0, ds)
    wide = [torch.zeros(2, 4, 3, 128) for _ in range(4)]
    with pytest.raises(ValueError, match="head_dim 128 not in"):
        wkv6_backward_cuda(*wide[:3], wide[3], torch.zeros(3, 128), wide[0])
    with pytest.raises(ValueError, match="do not agree"):
        wkv6_backward_cuda(r, k, v, w, u, do[:, :2], s0, ds)
    x, al, h0, dh, dhT = _torch(*_rglru_inputs(2, 4))
    with pytest.raises(ValueError, match="not a CUDA device"):
        rglru_backward_cuda(x, al, dh, h0, dhT)
    with pytest.raises(ValueError, match="are not"):
        rglru_backward_cuda(x, al, dh[:, :2], h0, dhT)
    with pytest.raises(ValueError, match="must be float32"):
        rglru_backward_cuda(x, al.double(), dh, h0, dhT)
    q = torch.zeros(1, 8, 4, 128)
    with pytest.raises(ValueError, match="head_dim 128 not in"):
        flash_attention_backward_cuda(q, q[:, :, :1], q[:, :, :1], q)
    q = torch.zeros(1, 8, 4, 256)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_backward_cuda(q, q[:, :, :1], q[:, :, :1], q)
    assert (wkv6_backward_cuda.launches == rglru_backward_cuda.launches
            == flash_attention_backward_cuda.launches == 0)


# ---- the models ---------------------------------------------------------------

def _pair(arch, seed=0, remat="none"):
    """(JAX model, its params, the port's reduced model with the same weights)."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jmodel = JaxModel(jcfg, JaxShardingConfig(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = Model(cfg, ShardingConfig(remat=remat), device="cpu")
    model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, model


def _batch(vocab, S, B=2, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = t[:, 1:].copy()
    labels[:, -3:] = -100
    return {"tokens": t[:, :-1], "labels": labels}


@pytest.mark.parametrize("arch", list(MODELS))
def test_recurrent_loss_and_gradients_match_jax(arch):
    jmodel, jparams, model = _pair(arch, seed=3)
    assert model.cfg.family in ("ssm", "hybrid")
    batch = _batch(model.cfg.vocab_size, MODELS[arch])
    if model.cfg.family == "ssm":
        assert MODELS[arch] > CHUNK
    else:
        assert MODELS[arch] > model.cfg.window
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = state_from_jax(jax.tree.map(np.asarray, jgrads), model.cfg)
    params = trainable(model)
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(params.values()))
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert set(jgrads) == set(params)
    for (n, _), g in zip(params.items(), grads):
        want = jgrads[n]
        scale = want.abs().max().item()
        err = (g - want).abs().max().item()
        assert err <= GRAD_TOL * max(scale, 1e-12), f"{n}: {err:.3g} of {scale:.3g}"


@pytest.mark.parametrize("arch", list(MODELS))
def test_recurrent_remat_block_gives_the_same_gradients(arch):
    cfg = get_arch(arch).reduced()
    model = Model(cfg, ShardingConfig(remat="none"), device="cpu").init(
        torch.Generator().manual_seed(1))
    remat = Model(cfg, ShardingConfig(remat="block"), device="cpu")
    remat.load_state_dict(model.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, MODELS[arch],
                                                        seed=2).items()}
    out = []
    for m in (model, remat):
        params = trainable(m)
        out.append((m.loss(batch), params))
        out[-1] = (out[-1][0].detach(), torch.autograd.grad(out[-1][0],
                                                            list(params.values())))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", list(MODELS))
def test_recurrent_trainer_fit_follows_jax_losses(arch):
    jmodel, jparams, model = _pair(arch, seed=0)
    jtr = JaxTrainer(jmodel, jax_adamw(3e-3, grad_clip=1.0), JaxShardingConfig(remat="none"))
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(5):
        t = rng.integers(0, model.cfg.vocab_size, (2, MODELS[arch] + 1)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    _, _, jhist = jtr.fit(jparams, jtr.opt.init(jparams),
                          ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
                          log_every=1)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, adamw(3e-3, grad_clip=1.0))
    params, state = tr.init_state(torch.Generator().manual_seed(0))
    model.load_state_dict(init)
    _, _, hist = tr.fit(params, state, batches, log_every=1)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [1, 2, 3, 4, 5]
    for h, jh in zip(hist, jhist):
        assert h["loss"] == pytest.approx(jh["loss"], rel=FIT_RTOL)


def test_recurrent_train_launcher_prints_what_jax_prints():
    """``launch.train --arch rwkv6-3b --device cpu`` prints the JAX
    launcher's lines: the parameter count of JAX's reduced model and the
    start step, then a loss line at step 1 and every 10 steps."""
    # one torch thread, as this file's own tests: the suite's workers share the cores
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "rwkv6-3b", "--steps", "12", "--batch", "2", "--seq", "40",
                          "--device", "cpu"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-1500:]
    jcfg = jax_get_arch("rwkv6-3b").reduced()
    n_jax = JaxModel(jcfg, JaxShardingConfig(remat="none")).param_count()
    lines = out.stdout.splitlines()
    assert lines[0] == f"{jcfg.name}: {n_jax / 1e6:.2f}M params, start step 0"
    steps = [int(line.split()[1]) for line in lines[1:]]
    losses = [float(line.split("loss")[1].split()[0]) for line in lines[1:]]
    assert steps == [1, 10] and all(np.isfinite(losses))
    assert all(line.startswith("  step ") and line.endswith("s)") for line in lines[1:])

