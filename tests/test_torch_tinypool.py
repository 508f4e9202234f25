"""The trained tiny pool of the port on the CPU.

``train_engines`` trains through the port's train step (the flash backward's
plain version on the CPU) and hands over engines that serve;
``build_tiny_pool`` and ``PoolSpec(kind="tiny")`` give members that
``Gateway.fit``/``submit`` take, with ``draft_member`` turning the dearer
members into ``SpeculativeEngine``s.  The port's init draws other numbers
than ``jax.random``, so a pool trained in each framework is compared in
behaviour; given the JAX package's trained tiny-s weights, carried by the
weight bridge, a port member answers the test queries exactly as the JAX
member does (greedy decoding on identical weights).
"""
import jax
import numpy as np
import pytest
import torch

from repro.serving import pool as jpool
from repro.serving import tinypool as jtinypool
from repro.serving.batcher import BatchPromptFormatter as JaxFormatter
from repro_torch import api
from repro_torch.config import get_arch
from repro_torch.models.bridge import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving import pool, tinypool
from repro_torch.serving.batcher import BatchPromptFormatter
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.speculative import SpeculativeEngine

STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_pool():
    return tinypool.build_tiny_pool(np.random.default_rng(0), steps=STEPS, n_train=12,
                                    n_test=12, draft_member="tiny-s", verbose=False,
                                    device="cpu")


def test_train_engines_loss_falls_and_engines_serve():
    fmt = BatchPromptFormatter(tinypool.SYSTEM_PROMPT)
    engines = tinypool.train_engines(np.random.default_rng(1), fmt, 6, names=("tiny-s",),
                                     replicas=2, verbose=False, device="cpu")
    engs = engines["tiny-s"]
    assert len(engs) == 2 and engs[0].model is engs[1].model
    model = engs[0].model
    losses = model.train_log["losses"]
    assert len(losses) == 6 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not any(p.requires_grad for p in model.parameters())
    out = engs[1].generate_text(["1+2", "40+3"], max_new=4)
    assert len(out) == 2 and all(isinstance(t, str) for t in out)


def test_build_tiny_pool_members_fit_and_submit(tiny_pool):
    wl, members, fmt = tiny_pool
    assert [m.name for m in members] == ["tiny-s", "tiny-m", "tiny-l"]
    assert isinstance(members[0].engine, ServingEngine)
    assert all(isinstance(m.engine, SpeculativeEngine) for m in members[1:])
    assert all(m.engine.draft_model is members[0].engine.model for m in members[1:])
    assert [(m.c_in, m.c_out) for m in members] == [tinypool.TINY_PRICES[m.name]
                                                    for m in members]
    gw = api.Gateway(members, wl, spec=api.RunSpec(router="knn", coreset_size=4,
                                                   grid_multiple=2), device="cpu").fit()
    test = wl.subset_indices("test")
    budget = 4.0 * float(gw.robatch.cost_model.single_model_cost(0, test, 1))
    out = gw.submit(budget=budget)
    assert out.n_invocations > 0 and out.exact_cost <= budget + 1e-12
    assert len(out.per_query_utility) == len(test)


def test_poolspec_tiny_builds_on_the_cpu():
    spec = api.PoolSpec(kind="tiny", n_train=8, n_test=8, steps=2, replicas=2)
    wl, members = spec.build(device="cpu")
    assert [m.name for m in members] == ["tiny-s", "tiny-m", "tiny-l"]
    assert all(isinstance(m, pool.ReplicaSet) and len(m.replicas) == 2 for m in members)
    assert len(wl.subset_indices("test")) == 8


def test_member_over_jax_trained_weights_answers_as_jax():
    jfmt = JaxFormatter(jtinypool.SYSTEM_PROMPT)
    jengs = jtinypool.train_engines(np.random.default_rng(2), jfmt, 3, names=("tiny-s",),
                                    verbose=False)
    jeng = jengs["tiny-s"][0]
    model = Model(get_arch("tiny-s"), device="cpu")
    model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jeng.params), model.cfg))
    eng = ServingEngine(model, max_slots=4, max_len=512, decode_block=8, paged=True,
                        page_size=16, device="cpu")
    fmt = BatchPromptFormatter(tinypool.SYSTEM_PROMPT)
    jwl, jtask = jtinypool.build_task_workload(np.random.default_rng(0), jfmt, 6, 6)
    wl, task = tinypool.build_task_workload(np.random.default_rng(0), fmt, 6, 6)
    c_in, c_out = tinypool.TINY_PRICES["tiny-s"]
    jm = jpool.ServedPoolMember("tiny-s", jeng, jfmt, jtask, c_in=c_in, c_out=c_out,
                                context_len=512)
    m = pool.ServedPoolMember("tiny-s", eng, fmt, task, c_in=c_in, c_out=c_out,
                              context_len=512)
    test = wl.subset_indices("test")
    for idx in (test[:1], test[1:4], test):
        jr, r = jm.invoke_batch(jwl, np.array(idx)), m.invoke_batch(wl, np.array(idx))
        assert list(r.answers) == list(jr.answers)
        assert list(r.utilities) == list(jr.utilities)
        assert (r.in_tokens, r.out_tokens) == (jr.in_tokens, jr.out_tokens)
