"""Tiny *real* model pool builder: train the tiny-s/m/l byte-level LMs on an
addition task (batched-prompt examples in-distribution) and wrap them as
``ServedPoolMember``s.

Counterpart of the JAX package's ``serving/tinypool.py``: the same task
(:func:`gen_query`, :func:`format_training_example`,
:func:`build_task_workload`), prices, batches, optimizer (AdamW at 3e-3,
global-norm clip 1.0) and step count, on ``device`` (the card unless
``"cpu"`` is asked).  Training goes through the port's train step
(``training.train_loop``), so on the card every step runs the flash
forward and backward kernels.  Architectures come from
``repro_torch.configs.tiny_pool`` (tiny-s/m/l); prices follow the ascending
cost/capability convention the scheduler assumes (§3).
"""
from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from repro_torch.config import ShardingConfig, get_arch
from repro_torch.data.workload import BenchmarkSpec, Workload
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serving.batcher import BatchPromptFormatter
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.pool import ReplicaSet, ServedPoolMember, TextTask
from repro_torch.serving.speculative import SpeculativeEngine
from repro_torch.training.optimizer import adamw
from repro_torch.training.train_loop import make_train_step, trainable

__all__ = ["SYSTEM_PROMPT", "TINY_PRICES", "gen_query",
           "format_training_example", "train_engines", "build_task_workload",
           "replica_factory", "build_tiny_pool"]

SYSTEM_PROMPT = ("You are a calculator. For each question output the last digit "
                 "of the sum, answers separated by ';'.")

# (c_in, c_out) $/1M tokens, ascending with capacity; context fits max_len.
TINY_PRICES = {"tiny-s": (0.1, 0.4), "tiny-m": (0.3, 1.2), "tiny-l": (0.8, 3.2)}

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


def _make_batches(rng, fmt, batch_size, seq_len, n_steps, device):
    tok = fmt.tokenizer
    for _ in range(n_steps):
        seqs = [format_training_example(rng, fmt) for _ in range(batch_size)]
        tokens, lengths = tok.pad_batch(seqs, seq_len + 1)
        labels = tokens[:, 1:].copy()
        labels[labels == tok.pad] = -100
        yield {"tokens": torch.from_numpy(np.ascontiguousarray(tokens[:, :-1])).to(device),
               "labels": torch.from_numpy(np.where(labels == -100, -100, labels)).to(device)}


def train_engines(rng, fmt: BatchPromptFormatter, steps: int,
                  names=("tiny-s", "tiny-m", "tiny-l"), *, batch_size: int = 8,
                  seq_len: int = 192, max_slots: int = 4, max_len: int = 512,
                  replicas: int = 1, decode_block: int = 8, paged: bool = True,
                  page_size: int = 16, verbose: bool = True,
                  device="cuda") -> dict[str, list[ServingEngine]]:
    """Train the tiny architectures on the addition task; returns
    ``{name: [engine, ...]}`` with ``replicas`` engines per architecture.

    Each architecture trains ONCE — replica engines share the trained model
    but hold their own KV-cache slots, so they serve genuinely concurrent
    batches.  The JAX package seeds each member's init with
    ``jax.random.PRNGKey(crc32(name))``; the port draws its own from
    ``torch.Generator(device).manual_seed(crc32(name) % 2**31)`` (other
    numbers, so a trained pool matches JAX's in behaviour, not bit for
    bit).  Batches come from ``rng`` as JAX's do.  After training the
    parameters' grad is turned off again, and the model keeps its losses
    and training seconds as ``model.train_log``.

    ``seq_len`` must cover the longest batched example: at the previous
    default of 160 the b=5/6 examples were silently truncated by
    ``pad_batch`` — cutting off exactly the answers they were meant to teach.

    Caveat for benchmark consumers: at smoke-scale step counts (a few
    hundred) these tiny byte-level LMs learn the *format* reliably but sit
    near the task's chance floor on the arithmetic itself, so measured
    utilities are low; the serving/routing machinery above them is exercised
    either way, and the calibrated simulator pool is the right target for
    utility-sensitive numbers."""
    dev = resolve_device(device)
    engines = {}
    for name in names:
        cfg = get_arch(name)
        model = Model(cfg, ShardingConfig(remat="none"), device=dev).init(
            torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()) % 2**31))
        opt = adamw(3e-3, grad_clip=1.0)
        params = trainable(model)
        state = opt.init(list(params.values()))
        step = make_train_step(model, opt)
        t0 = time.time()
        losses = []
        if verbose:
            print(f"training {name} ({model.param_count() / 1e6:.2f}M params)...",
                  flush=True)
        for batch in _make_batches(rng, fmt, batch_size, seq_len, steps, dev):
            params, state, metrics = step(params, state, batch)
            losses.append(metrics["loss"])
        losses = [float(x) for x in losses]      # one wait for the device, at the end
        model.requires_grad_(False)
        model.train_log = dict(losses=losses, seconds=time.time() - t0)
        if verbose:
            print(f"trained {name}: loss {losses[0]:.2f} -> "
                  f"{np.mean(losses[-20:]):.2f} "
                  f"({time.time() - t0:.0f}s, {len(losses)} steps)", flush=True)
        engines[name] = [ServingEngine(model, max_slots=max_slots, max_len=max_len,
                                       decode_block=decode_block, paged=paged,
                                       page_size=page_size, device=dev)
                         for _ in range(replicas)]
    return engines


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


def _speculative_of(engine: ServingEngine, draft: ServingEngine,
                    spec_k: int) -> SpeculativeEngine:
    """Wrap a trained member engine so the draft member's model proposes its
    tokens (fresh KV slots on both sides; the models are shared)."""
    return SpeculativeEngine(engine.model, draft.model, max_slots=engine.max_slots,
                             max_len=engine.max_len, spec_k=spec_k,
                             page_size=engine.page_size, share_prefix=engine.share_prefix,
                             device=engine.device)


def build_tiny_pool(rng, *, steps: int = 300, n_train: int = 48, n_test: int = 48,
                    replicas: int = 1, scalable: bool = False,
                    draft_member: str = "", spec_k: int = 4,
                    verbose: bool = True, device="cuda"):
    """Everything the routing stack needs: (workload, pool, formatter).

    The returned members satisfy the pool-member protocol, so ``Robatch`` and
    ``OnlineRobatchServer`` use them exactly like the simulator.  With
    ``replicas > 1`` each member is a :class:`~repro_torch.serving.pool.ReplicaSet`
    of that many engines over one trained model — N-way concurrent
    serving without N training runs.  ``scalable=True`` wraps members in
    ReplicaSets even at ``replicas=1`` and attaches a shared-weight
    :func:`replica_factory`, so the autoscaler can grow them on demand.

    ``draft_member`` names the cheap member whose model drafts for every
    *more expensive* member (routed speculative decoding): those members'
    engines become :class:`SpeculativeEngine`\\ s verifying the draft's
    ``spec_k``-token proposals.  Outputs are identical to the plain
    engines' — the draft only moves latency.  Training and serving run on
    ``device``."""
    fmt = BatchPromptFormatter(SYSTEM_PROMPT)
    engines = train_engines(rng, fmt, steps, replicas=replicas, verbose=verbose,
                            device=device)
    if draft_member:
        if draft_member not in engines:
            raise ValueError(f"draft_member {draft_member!r} is not in the "
                             f"pool: {sorted(engines)}")
        d_cost = TINY_PRICES[draft_member][1]
        draft0 = engines[draft_member][0]
        for name, engs in engines.items():
            if TINY_PRICES[name][1] > d_cost:
                engines[name] = [_speculative_of(e, draft0, spec_k)
                                 for e in engs]
    wl, task = build_task_workload(rng, fmt, n_train, n_test)

    def member(name: str, engine: ServingEngine) -> ServedPoolMember:
        return ServedPoolMember(name, engine, fmt, task,
                                c_in=TINY_PRICES[name][0],
                                c_out=TINY_PRICES[name][1], context_len=512)

    if replicas > 1 or scalable:
        # async_build: a scale-up's engine construction runs off the serving
        # thread and joins at the next window boundary, so an autoscaler grow
        # never stretches the window that detected the backlog
        def rset(name: str) -> ReplicaSet:
            members = [member(name, e) for e in engines[name]]
            return ReplicaSet(members, name=name,
                              factory=replica_factory(members[0]),
                              async_build=True)

        pool = [rset(name) for name in ("tiny-s", "tiny-m", "tiny-l")]
    else:
        pool = [member(name, engines[name][0])
                for name in ("tiny-s", "tiny-m", "tiny-l")]
    return wl, pool, fmt
