"""Training in the port against the JAX package on the CPU.

``Model.loss`` and its gradients (autograd through ``FlashAttention`` and the
plain flash backward) against ``jax.value_and_grad(Model.loss)`` on
``tiny-s`` and on ``reduced()`` Qwen1.5-0.5B in fp32, with JAX's weights
carried by ``models/bridge.py``: the loss within 1e-5 relative, every
gradient within 1e-4 of its leaf's largest |gradient| (the two frameworks
sum in other orders; the gradients of a two-layer model differ by ~1e-6 of
their scale).  Then remat, the schedule, gradient accumulation, a 5-step
``Trainer.fit`` against JAX's ``Trainer`` on JAX's batches (losses within
1e-4 relative: AdamW turns the sign of a gradient near 0 into ±lr, so
parameters are not compared), checkpoint resume, atomicity and keep-N, the
data pipeline and the training launcher.
"""
import dataclasses
import json
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
from repro.data.pipeline import synthetic_lm_stream as jax_stream
from repro.models.transformer import Model as JaxModel
from repro.training.optimizer import adamw as jax_adamw
from repro.training.optimizer import cosine_schedule as jax_cosine
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.checkpoint import CheckpointManager, latest_step, load_state, save_state
from repro_torch.config import ShardingConfig, get_arch
from repro_torch.data.pipeline import ShardedPipeline, synthetic_lm_stream
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import adamw, clip_by_global_norm, cosine_schedule
from repro_torch.training.train_loop import Trainer, make_train_step, train_state, trainable
from repro_torch.utils.tree import tree_bytes, tree_size, tree_summary

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |gradient|
FIT_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    return {"tiny-s": "tiny-s", "qwen-reduced": "qwen1.5-0.5b"}[name]


def _configs(name):
    jcfg, cfg = jax_get_arch(_cfg(name)), get_arch(_cfg(name))
    if name == "qwen-reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    return jcfg, cfg


def _pair(name, seed=0, remat="none"):
    """(JAX model, its params, the port's model with the same weights)."""
    jcfg, cfg = _configs(name)
    jmodel = JaxModel(jcfg, JaxShardingConfig(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = Model(cfg, ShardingConfig(remat=remat), device="cpu")
    model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, model


def _batch(vocab, B=4, S=24, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = t[:, 1:].copy()
    if masked:
        labels[:, -3:] = -100            # a padded tail, as the tiny pool's batches have
    return {"tokens": t[:, :-1], "labels": labels}


@pytest.mark.parametrize("name", ["tiny-s", "qwen-reduced"])
def test_loss_and_gradients_match_jax(name):
    jmodel, jparams, model = _pair(name, seed=3)
    batch = _batch(model.cfg.vocab_size)
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


def test_remat_block_gives_the_same_gradients():
    _, _, model = _pair("qwen-reduced", seed=1, remat="none")
    remat = Model(model.cfg, ShardingConfig(remat="block"), device="cpu")
    remat.load_state_dict(model.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg.vocab_size, seed=2).items()}
    out = []
    for m in (model, remat):
        params = trainable(m)
        out.append(torch.autograd.grad(m.loss(batch), list(params.values())))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_takes_remat_from_the_model():
    """The step reads ``model.shard`` when it runs: under ``remat="block"``
    every block's forward, its flash call included, runs again in the
    backward, so a step builds twice the ``FlashAttention`` nodes; the
    updated parameters are those of ``"none"``."""
    from repro_torch.kernels import flash_attention as flash_mod

    _, _, model = _pair("tiny-s", seed=4)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(model.cfg.vocab_size, seed=5)
    apply, nodes, out = flash_mod.FlashAttention.apply, [], {}

    def counted(*args):
        nodes[-1] += 1
        return apply(*args)

    flash_mod.FlashAttention.apply = counted
    try:
        for remat in ("none", "block"):
            model.load_state_dict(init)
            model.shard = dataclasses.replace(model.shard, remat=remat)
            opt = adamw(1e-3)
            params = trainable(model)
            nodes.append(0)
            make_train_step(model, opt)(params, opt.init(list(params.values())), batch)
            out[remat] = {k: v.detach().clone() for k, v in params.items()}
    finally:
        del flash_mod.FlashAttention.apply
    assert nodes == [model.cfg.n_layers, 2 * model.cfg.n_layers]
    for k in out["none"]:
        torch.testing.assert_close(out["block"][k], out["none"][k], rtol=0, atol=0)


def test_padded_vocab_masks_under_autograd():
    """``_logits`` writes -1e30 into the padded vocab columns in place; under
    autograd their logits stay -1e30 and their gradient is zero."""
    cfg = dataclasses.replace(get_arch("tiny-s"), vocab_size=500)
    model = Model(cfg, ShardingConfig(remat="none"), device="cpu").init(
        torch.Generator().manual_seed(0))
    params = trainable(model)
    batch = {k: torch.from_numpy(v) for k, v in _batch(500).items()}
    logits, _ = model(batch["tokens"])
    assert logits.shape[-1] == 512 and bool((logits[..., 500:] == -1e30).all())
    grads = dict(zip(params, torch.autograd.grad(model.loss(batch), list(params.values()))))
    assert bool((grads["lm_head"][:, 500:] == 0).all())
    assert bool(grads["lm_head"][:, :500].abs().sum() > 0)


def test_cosine_schedule_equals_jax():
    for args in ((1e-3, 10, 100), (3e-3, 10, 12)):
        j, t = jax_cosine(*args), cosine_schedule(*args)
        for step in (0, 5, 10, 100):
            assert np.float32(t(step)) == np.float32(j(step)), (args, step)


def test_grad_accumulation_matches_full_batch():
    _, _, model = _pair("tiny-s", seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(model.cfg.vocab_size, B=8, masked=False)
    out = []
    for micro in (1, 4):
        model.load_state_dict(init)
        opt = adamw(1e-3)
        params = trainable(model)
        model.shard = dataclasses.replace(model.shard, microbatches=micro)
        step = make_train_step(model, opt)
        _, _, metrics = step(params, opt.init(list(params.values())), batch)
        out.append((float(metrics["loss"]), {k: v.clone() for k, v in params.items()}))
    (l1, p1), (l4, p4) = out
    assert l1 == pytest.approx(l4, rel=1e-4)
    assert max((p1[k] - p4[k]).abs().max().item() for k in p1) < 5e-5


def _jax_batches(cfg, n, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}


def test_trainer_fit_follows_jax_losses():
    jmodel, jparams, model = _pair("tiny-s", seed=0)
    jtr = JaxTrainer(jmodel, jax_adamw(3e-3, grad_clip=1.0), JaxShardingConfig(remat="none"))
    batches = list(_jax_batches(model.cfg, 5, seed=1))
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
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_trainer_resumes_bit_equal(tmp_path):
    cfg = get_arch("tiny-s")
    opt = adamw(3e-3)
    tr = Trainer(Model(cfg, ShardingConfig(remat="none"), device="cpu"), opt,
                 ckpt_dir=str(tmp_path / "ck"), ckpt_every=5)
    params, state, start = tr.restore_or_init(torch.Generator().manual_seed(0))
    assert start == 0
    params, state, hist = tr.fit(params, state, _jax_batches(cfg, 12, seed=1), log_every=5)
    assert hist[-1]["loss"] < hist[0]["loss"]
    saved = {k: v.clone() for k, v in train_state(params, state).items()}
    tr2 = Trainer(Model(cfg, ShardingConfig(remat="none"), device="cpu"), opt,
                  ckpt_dir=str(tmp_path / "ck"))
    p2, s2, start2 = tr2.restore_or_init(torch.Generator().manual_seed(1))
    assert start2 == 12 and s2.step == 12
    restored = train_state(p2, s2)
    assert set(restored) == set(saved)
    for k in saved:
        assert torch.equal(restored[k], saved[k]), k
    # both continue identically
    b = next(_jax_batches(cfg, 1, seed=9))
    _, _, h1 = tr.fit(params, state, [b], start_step=12, log_every=1)
    _, _, h2 = tr2.fit(p2, s2, [b], start_step=12, log_every=1)
    assert h1[0]["loss"] == h2[0]["loss"]


@pytest.mark.parametrize("n_steps, saved", [(4, [2, 4]), (3, [2, 3]), (0, [])])
def test_trainer_saves_each_step_once(tmp_path, n_steps, saved):
    """A checkpoint every ``ckpt_every`` steps and after the last, which is
    not written again when it was just saved; no step, no checkpoint."""
    cfg = get_arch("tiny-s")
    tr = Trainer(Model(cfg, ShardingConfig(remat="none"), device="cpu"), adamw(3e-3),
                 ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    params, state, _ = tr.restore_or_init(torch.Generator().manual_seed(0))
    save, steps = tr._mgr.save, []

    def recorded(tree, step):
        steps.append(step)
        return save(tree, step)

    tr._mgr.save = recorded
    tr.fit(params, state, _jax_batches(cfg, n_steps, seed=1), log_every=1)
    assert steps == saved
    assert latest_step(str(tmp_path / "ck")) == (saved[-1] if saved else None)


def test_checkpoint_atomic_and_keep_n(tmp_path):
    state = {"a": torch.arange(5), "b/c": torch.ones((2, 2)),
             "w": torch.linspace(-1, 1, 7).to(torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(state, s)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000000003", "step_000000000004"]
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]
    restored, step = mgr.restore({k: torch.zeros_like(v) for k, v in state.items()})
    assert step == 4
    for k in state:
        assert restored[k].dtype == state[k].dtype and torch.equal(restored[k], state[k])
    meta = json.loads((tmp_path / "step_000000000004" / "meta.json").read_text())
    assert meta["step"] == 4 and meta["n_leaves"] == 3 and meta["dtypes"]["w"] == "torch.bfloat16"


def test_checkpoint_ignores_partial_writes(tmp_path):
    state = {"a": torch.arange(3)}
    save_state(state, str(tmp_path), 7)
    os.makedirs(tmp_path / "tmp.9.123", exist_ok=True)   # a torn write
    assert latest_step(str(tmp_path)) == 7
    restored, step = load_state({"a": torch.zeros_like(state["a"])}, str(tmp_path))
    assert step == 7 and torch.equal(restored["a"], state["a"])
    with pytest.raises(FileNotFoundError):
        load_state(state, str(tmp_path / "empty"))


def test_checkpoint_restores_into_the_template(tmp_path):
    """A restore reads each leaf into the template's own tensor, bf16 bit
    for bit, and returns those tensors."""
    saved = {"w": torch.randn(4, 3).to(torch.bfloat16), "m": torch.randn(5),
             "step": torch.tensor(9, dtype=torch.int64)}
    save_state(saved, str(tmp_path), 9)
    template = {k: torch.zeros_like(v) for k, v in saved.items()}
    restored, step = load_state(template, str(tmp_path))
    assert step == 9
    for k in saved:
        assert restored[k] is template[k] and torch.equal(template[k], saved[k]), k


def _functional_adamw(grads, state, params, lr, b1, b2, eps, weight_decay, grad_clip):
    """AdamW as a function of its inputs, which it leaves alone: JAX's
    order of operations, new tensors out."""
    if grad_clip is not None:
        grads, _ = clip_by_global_norm(grads, grad_clip)
    t = torch.tensor(float(state.step + 1), dtype=torch.float32)
    b1t = (1 - torch.tensor(b1, dtype=torch.float32) ** t).item()
    b2t = (1 - torch.tensor(b2, dtype=torch.float32) ** t).item()
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(grads, state.mu, state.nu, params):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
        d = (m32 / b1t) / (torch.sqrt(v32 / b2t) + eps)
        if weight_decay:
            d = d + weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * d).to(p.dtype))
        new_m.append(m32.to(m.dtype))
        new_v.append(v32.to(v.dtype))
    return new_p, new_m, new_v


def test_adamw_update_donates_params_and_moments():
    """The update overwrites the parameters and moments in place and returns
    those tensors; the parameters (fp32 and bf16) and both moments equal
    the functional form's, bit for bit."""
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(6, 5, generator=g), torch.randn(7, generator=g).to(torch.bfloat16)]
    grads = [torch.randn(p.shape, generator=g).to(p.dtype) for p in params]
    opt = adamw(1e-2, weight_decay=1e-3, grad_clip=0.5)
    state = opt.init(params)
    state = opt.update(grads, state, [p.clone() for p in params])[1]   # non-zero moments
    want_p, want_m, want_v = _functional_adamw(
        grads, state._replace(mu=[m.clone() for m in state.mu], nu=[v.clone() for v in state.nu]),
        [p.clone() for p in params], 1e-2, 0.9, 0.95, 1e-8, 1e-3, 0.5)
    before = [t.clone() for t in params]
    new, new_state = opt.update(grads, state, params)
    assert all(a is b for a, b in zip(new, params))
    assert all(a is b for a, b in zip(new_state.mu, state.mu))
    assert all(a is b for a, b in zip(new_state.nu, state.nu))
    assert not any(torch.equal(a, b) for a, b in zip(params, before))
    for got, want in ((new, want_p), (new_state.mu, want_m), (new_state.nu, want_v)):
        for a, w in zip(got, want):
            assert a.dtype == w.dtype
            torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_synthetic_stream_equals_jax():
    a, b = synthetic_lm_stream(128, 4, 16, seed=3), jax_stream(128, 4, 16, seed=3)
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_pipeline_prefetches_and_closes():
    it = (dict(x=np.full((2, 2), i)) for i in range(5))
    pipe = ShardedPipeline(it, device="cpu", prefetch=2)
    got = [int(b["x"][0, 0]) for b in pipe]
    assert got == list(range(5))
    pipe.close()
    assert not pipe._thread.is_alive()
    # closing an endless stream mid-way stops its thread
    pipe = ShardedPipeline(synthetic_lm_stream(64, 2, 8), device="cpu", prefetch=2)
    first = next(pipe)
    assert isinstance(first["tokens"], torch.Tensor) and first["tokens"].shape == (2, 8)
    pipe.close()
    assert not pipe._thread.is_alive()


def test_tree_helpers():
    _, _, model = _pair("tiny-s")
    sd = model.state_dict()
    assert tree_size(sd) == model.param_count() == tree_size(list(sd.values()))
    assert tree_bytes(sd) == 4 * model.param_count()
    assert tree_summary(sd, "tiny-s").startswith("tiny-s: 0.20M params")


def test_train_launcher_prints_params_and_loss():
    # one torch thread, as this file's own tests: the suite's workers share the cores
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "tiny-s",
                          "--steps", "12", "--batch", "4", "--seq", "32", "--device", "cpu"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-1500:]
    assert "params" in out.stdout and "loss" in out.stdout
    losses = [float(line.split("loss")[1].split()[0]) for line in out.stdout.splitlines()
              if "loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
