"""The tiny pool's task and members, without its training.

The JAX package trains the tiny-s/m/l byte-level LMs on an addition task and
wraps them as ``ServedPoolMember``s (``serving/tinypool.py`` there).  The
port has its jax-free parts: the task (:func:`gen_query`,
:func:`format_training_example`, :func:`build_task_workload`), the prices,
and :func:`replica_factory` over the port's engines, so a pool of live
members can be put together from engines built elsewhere (the tests carry
the JAX package's weights into them; ``chip_smoke.py`` serves full-width
models with random weights).  Training the pool waits for the port's
training loop: :func:`train_engines` and :func:`build_tiny_pool`, and so
``PoolSpec(kind="tiny")``, raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.workload import BenchmarkSpec, Workload
from repro_torch.serving.batcher import BatchPromptFormatter
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.pool import ServedPoolMember, TextTask
from repro_torch.serving.speculative import SpeculativeEngine

__all__ = ["SYSTEM_PROMPT", "TINY_PRICES", "gen_query",
           "format_training_example", "train_engines", "build_task_workload",
           "replica_factory", "build_tiny_pool"]

SYSTEM_PROMPT = ("You are a calculator. For each question output the last digit "
                 "of the sum, answers separated by ';'.")

# (c_in, c_out) $/1M tokens, ascending with capacity; context fits max_len.
TINY_PRICES = {"tiny-s": (0.1, 0.4), "tiny-m": (0.3, 1.2), "tiny-l": (0.8, 3.2)}

_UNTRAINED = ("the port has no training loop yet (ROADMAP.md queue 1, item 2: "
              "training); build the members' engines from weights made elsewhere and "
              "wrap them with ServedPoolMember")


def gen_query(rng) -> tuple[str, str, float]:
    """Two-term addition with difficulty tiers by operand size.
    Answer = last digit of the sum (single token)."""
    tier = int(rng.integers(0, 3))               # 0 easy … 2 hard
    hi = (10, 50, 100)[tier]
    a_, b_ = int(rng.integers(0, hi)), int(rng.integers(0, hi))
    q = f"{a_}+{b_}"
    ans = str((a_ + b_) % 10)
    return q, ans, tier / 2.0


def format_training_example(rng, fmt: BatchPromptFormatter, max_b: int = 6):
    b = int(rng.integers(1, max_b + 1))
    qas = [gen_query(rng) for _ in range(b)]
    prompt = fmt.format([q for q, _, _ in qas])
    answer = ";".join(a for _, a, _ in qas)
    tok = fmt.tokenizer
    return prompt + tok.encode(answer, add_bos=False, add_eos=True)


def train_engines(*args, **kwargs):
    """Train the tiny architectures on the addition task: not in the port
    yet (raises ``NotImplementedError``)."""
    raise NotImplementedError(f"train_engines: {_UNTRAINED}")


def build_task_workload(rng, fmt: BatchPromptFormatter, n_train: int,
                        n_test: int) -> tuple[Workload, TextTask]:
    """Addition-task workload + parallel text view (see examples/serve_pool.py)."""
    n = n_train + n_test
    queries, answers, difficulty = [], [], []
    for _ in range(n):
        q, a, d = gen_query(rng)
        queries.append(q)
        answers.append(a)
        difficulty.append(d)
    difficulty = np.array(difficulty, np.float32)
    # embeddings: simple text features (the real system would use a sentence
    # embedding model; tiny pool queries are fully described by these)
    feats = np.stack([
        [len(q), sum(int(c) for c in q if c.isdigit()) / 20.0,
         max(len(t) for t in q.split("+")), min(len(t) for t in q.split("+"))]
        for q in queries
    ]).astype(np.float32)
    feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-6)
    emb = np.concatenate([feats, rng.normal(0, 0.1, (n, 4)).astype(np.float32)], axis=1)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8

    in_tokens = np.array([fmt.query_tokens(q) for q in queries], np.int32)
    spec = BenchmarkSpec("tiny-add", "reasoning", 10, fmt.sys_tokens,
                         (float(in_tokens.mean()), 0.2), (2, 0.1), (2.0, 2.0), 3, 5.0)
    wl = Workload(
        name="tiny-add", spec=spec, embeddings=emb, difficulty=difficulty,
        topic=np.zeros(n, np.int32), in_tokens=in_tokens,
        out_tokens=np.full(n, 2, np.int32), sys_tokens=fmt.sys_tokens,
        split={"train": np.arange(n_train),
               "val": np.arange(0),
               "test": np.arange(n_train, n)},
    )
    return wl, TextTask(queries=queries, answers=answers)


def replica_factory(prototype: ServedPoolMember):
    """Zero-arg builder of one more interchangeable replica of a served
    member: a fresh :class:`ServingEngine` (its own KV-cache slots) over the
    SAME model weights — what :meth:`repro_torch.serving.pool.ReplicaSet.scale_to`
    calls to grow a tiny-pool member without retraining.  A speculative
    prototype replicates as a fresh :class:`SpeculativeEngine` over the same
    target/draft model pair."""
    proto_engine = prototype.engine

    def build() -> ServedPoolMember:
        if isinstance(proto_engine, SpeculativeEngine):
            engine = SpeculativeEngine(
                proto_engine.model, proto_engine.draft_model,
                max_slots=proto_engine.max_slots,
                max_len=proto_engine.max_len, spec_k=proto_engine.spec_k,
                page_size=proto_engine.page_size,
                share_prefix=proto_engine.share_prefix,
                device=proto_engine.device)
        else:
            engine = ServingEngine(proto_engine.model,
                                   max_slots=proto_engine.max_slots,
                                   max_len=proto_engine.max_len,
                                   decode_block=proto_engine.decode_block,
                                   paged=proto_engine.paged,
                                   page_size=proto_engine.page_size,
                                   share_prefix=proto_engine.share_prefix,
                                   device=proto_engine.device)
        return ServedPoolMember(prototype.name, engine, prototype.formatter,
                                prototype.task, c_in=prototype.c_in,
                                c_out=prototype.c_out,
                                context_len=prototype.context_len,
                                max_answer_tokens=prototype.max_answer_tokens,
                                generation=prototype.generation)

    return build


def build_tiny_pool(*args, **kwargs):
    """The trained tiny pool (``PoolSpec(kind="tiny")``): not in the port yet
    (raises ``NotImplementedError``)."""
    raise NotImplementedError(f"build_tiny_pool: {_UNTRAINED}")
