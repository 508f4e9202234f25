"""Serving engine of the port: slot-based continuous batching over a paged
or a contiguous KV cache, greedy or sampled decoding.

Counterpart of the JAX package's ``serving/engine.py`` (``ServingEngine``
with ``paged=True`` or ``paged=False``), and bit-for-bit the same host logic:

* **Batched admission** (``_admit_batch``): every request admitted in one
  serving tick is padded to a power-of-two length bucket (at least 16) and
  prefilled in one ``Model.prefill`` call.  Paged: the bucket is rounded up
  to a page multiple and the rows' pages are written into the pools by
  ``_insert_pages``; siblings that share the batch prompt's prefix map their
  tables onto the owner's pages (refcount bumps, no second copy).
  Contiguous: each row is written into its slot's ``max_len`` row by
  ``_insert_many``.  Both write the cache in place: no cache tensor is ever
  reallocated, which the captured decode graphs rely on.
* **Page maintenance** (``_prepare_paged``): before each paged decode
  dispatch every active slot's table grows to cover its next
  ``decode_block`` writes, and any still-shared page in that range is
  copied-on-write (``_fork_pages``).
* **Fused K-step decode** (``_decode_k``): ``decode_block`` steps run back
  to back with the per-slot state (last token, active mask, emitted count,
  and the sampling knobs) on the device, and the host reads the results once
  per K.  The paged dispatch attends through the table sliced to the
  horizon; the contiguous one through a horizon view of the cache's
  sequence axis.  On the card each dispatch is one CUDA-graph replay
  (``serving/graphs.py``), keyed like the JAX package's jit variants on
  (horizon bucket, ``sample``) or (table column count, ``sample``): the
  first dispatch of a key runs the body eagerly, the next captures it, and
  every later one replays it.  The body reads static input buffers that the
  host refills before each dispatch.  On the CPU the same body runs eagerly
  on the same buffers.
* **Sampling** (``sample_tokens``, ``_fold_keys``): temperature, top-k and
  top-p, drawn with the port's bit-exact copy of ``jax.random``
  (``utils/prng.py``) from a per-request key folded with the stream
  position, so token t of a request is a pure function of (seed, t) and
  equals the JAX engine's.  A dispatch with any sampled request runs the
  sampled body (inside the graph on the card); an all-greedy one the exact
  greedy body.  The first token is sampled at admission.
* **Stepwise reference driver** (``serve_stepwise``, contiguous only): one
  admission per request and one host round-trip per token, the parity
  reference of the fused driver.

Only attention stacks are served, as in JAX, whose prefill of a
right-padded batch asserts as much.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serving.generation import GenerationConfig
from repro_torch.serving.graphs import GraphSet, StaticInput
from repro_torch.serving.kvpool import PagedCacheManager
from repro_torch.utils import prng


def sample_tokens(logits, keys, temp, top_k, top_p):
    """Temperature/top-k/top-p sampling, one token per row, as the JAX
    package's ``sample_tokens``.

    ``logits``: (B, V) float32; ``keys``: (B, 2) per-row PRNG keys as int64
    words (already folded with the stream position); ``temp``/``top_k``/
    ``top_p``: (B,).  Rows with ``temp <= 0`` take the greedy argmax, bit for
    bit.  The filter order is JAX's: scale by temperature, sort descending
    (stable), keep the top-k ranks and the nucleus (the probability mass
    before a token < ``top_p``; rank 0 always kept), then draw
    ``categorical`` over the sorted survivors and map back through the
    order.  The sort negates the scaled logits and adds 0.0, so −0.0 ties
    with 0.0 as in JAX's sort.  Returns (B,) int32.
    """
    greedy = logits.argmax(dim=-1).to(torch.int32)
    scaled = logits.float() / temp.clamp_min(1e-6)[:, None]
    order = torch.argsort(0.0 - scaled, dim=-1, stable=True)
    sl = torch.gather(scaled, -1, order)
    ranks = torch.arange(sl.shape[-1], device=sl.device)[None, :]
    keep = (top_k[:, None] <= 0) | (ranks < top_k[:, None])
    e = torch.exp(sl - sl[:, :1])                       # the sorted row's max is its first
    probs = e / e.sum(dim=-1, keepdim=True)
    keep &= (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    idx = prng.categorical(keys, torch.where(keep, sl, float("-inf")))
    sampled = torch.gather(order, -1, idx[:, None])[:, 0].to(torch.int32)
    return torch.where(temp > 0.0, sampled, greedy)


def _fold_keys(keys, n):
    """Per-row ``fold_in``: key i folded with stream position ``n[i]``, the
    determinism pivot — position, never the dispatch step, so outputs do not
    depend on K, the slot, or fused against stepwise serving.  Kept under
    the JAX engine's name (where it vmaps ``jax.random.fold_in``), since
    ``prng.fold_in`` already works row by row."""
    return prng.fold_in(keys, n)


@dataclass
class Request:
    rid: int
    tokens: list[int]
    max_new: int = 32
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False
    enqueued_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    on_tokens: Optional[Callable[[list[int], bool], None]] = None
    # ^ streaming hook: called once per host dispatch that appended to
    #   out_tokens — the prefill's first token at admission, then each fused
    #   decode block.  Args: the freshly appended token ids and whether the
    #   request is done.  Called from the serving thread; sinks must not block.
    gen: Optional[GenerationConfig] = None
    # ^ generation knobs; None means greedy with the legacy ``max_new``.


class ServingEngine:
    """Continuous-batching engine for one model on one device.

    ``decode_block`` is K, the number of tokens generated per host dispatch;
    greedy outputs are the same for every K.  ``paged=True`` (the default)
    keeps the KV cache in per-layer pools of ``page_size``-token pages plus
    host-side per-slot block tables (:class:`PagedCacheManager`);
    ``share_prefix=False`` keeps paging but gives every slot private pages.
    ``paged=False`` keeps one contiguous ``(max_slots, max_len)`` row of
    K/V per slot; greedy outputs are the same in both layouts.

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    ``model`` must live on the same device.
    """

    def __init__(self, model: Model, *, max_slots: int = 8, max_len: int = 1024,
                 decode_block: int = 8, paged: bool = True, page_size: int = 16,
                 share_prefix: bool = True, eos_id: int = ByteTokenizer.eos,
                 pad_id: int = ByteTokenizer.pad, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        if model.recurrent or model.hybrid:
            raise ValueError(f"{model.cfg.name}: the engine prefills right-padded batches, and "
                             f"variable-length prefill requires attention-only models")
        if model.encoder is not None:
            raise ValueError(f"{model.cfg.name}: the engine serves decoder-only stacks; an "
                             f"encoder-decoder's prefill needs the encoder's inputs "
                             f"(Model.prefill(enc_inputs=), then RecurrentDecoder)")
        self.model = model
        self.max_slots = max_slots
        self.max_len = max_len
        self.decode_block = max(1, int(decode_block))
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.share_prefix = bool(share_prefix)
        self.eos_id = eos_id
        self.pad_id = pad_id
        if self.paged:
            self.kv = PagedCacheManager(max_slots, max_len, self.page_size)
            self.cache = model.init_paged_cache(self.kv.alloc.n_pages, self.page_size,
                                                max_slots)
        else:
            self.kv = None
            self.cache = model.init_cache(max_slots, max_len)
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.tok = ByteTokenizer()
        self.n_decode_calls = 0             # host→device decode dispatches
        self.n_decode_steps = 0             # device decode steps they executed
        self.n_prefill_calls = 0            # admission prefill dispatches
        # the fused dispatch's static inputs, one int32 row a slot: last
        # token, active, emitted count, limit, the two key words, temperature
        # (float32 bits), top-k, top-p (float32 bits); and the paged table a
        # column count
        self._state = StaticInput((max_slots, 9), torch.int32, self.device)
        self._tables: dict[int, StaticInput] = {}
        self._graphs = GraphSet(self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def _bucket_len(self, n: int) -> int:
        """Pad prompt lengths to power-of-two buckets (at least 16)."""
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _bucket_count(self, n: int) -> int:
        """Pad admission batch sizes to power-of-two buckets (≤ max_slots)."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_slots)

    def _sibling_share_pages(self, owner: list[int], sib: list[int]) -> int:
        """How many of the owner's prompt pages a sibling admitted in the
        same batch may point at: page j is shareable iff the prompts agree on
        every position of it the sibling will ever read unmasked.  A sibling
        that is a prefix of the owner shares even the final partial page (its
        first decode append CoW-forks it); past a divergence the floor
        applies."""
        common = 0
        for a, b in zip(owner, sib):
            if a != b:
                break
            common += 1
        if common == len(sib):
            return -(-common // self.page_size)
        return common // self.page_size

    def _insert_pages(self, rows: dict, slots: np.ndarray, dst_pages: np.ndarray) -> None:
        """Write freshly prefilled rows into the page pools.

        ``rows`` K/V are ``(n_layers, B, Lp, Hk, hd)`` with ``Lp`` a page
        multiple; logical page j of row b lands at physical page
        ``dst_pages[b, j]``.  Sentinel entries (>= n_pages: padding rows of the
        admission bucket, and shared prefix pages the owner row writes) are
        masked out here on the host — JAX drops them in the scatter.  ``len``
        is set for the live rows (slot < max_slots) only.
        """
        ps = self.page_size
        n_layers, B, Lp = rows["k"].shape[:3]
        flat = dst_pages.reshape(-1)
        keep = np.nonzero(flat < self.kv.alloc.n_pages)[0]
        src_idx = self._to_device(keep)
        dst_idx = self._to_device(flat[keep].astype(np.int64))
        for name in ("k", "v"):
            pool = self.cache[name]
            src = rows[name].reshape(n_layers, B * (Lp // ps), ps, *rows[name].shape[3:])
            pool[:, dst_idx] = src[:, src_idx].to(pool.dtype)
        live = np.nonzero(slots < self.max_slots)[0]
        self.cache["len"][self._to_device(slots[live].astype(np.int64))] = \
            rows["len"][self._to_device(live)]

    def _insert_many(self, rows: dict, slots: np.ndarray) -> None:
        """Write freshly prefilled rows into their slots of the contiguous
        cache.  ``rows`` K/V are ``(n_layers, B, L, Hk, hd)``; row b fills
        positions ``[0, L)`` of slot ``slots[b]`` and the rest of the slot's
        row is zeroed, as JAX's ``_fill_kv_cache`` + ``_insert_many`` leave
        it.  A slot index of ``max_slots`` marks a padding row of the
        admission bucket: JAX drops its scatter, here it is left out on the
        host."""
        live = np.nonzero(slots < self.max_slots)[0]
        dst = self._to_device(slots[live].astype(np.int64))
        src = self._to_device(live.astype(np.int64))
        L = rows["k"].shape[2]
        for name in ("k", "v"):
            buf = self.cache[name]
            buf[:, dst, :L] = rows[name][:, src].to(buf.dtype)
            buf[:, dst, L:] = 0
        self.cache["len"][dst] = rows["len"][src]

    def _fork_pages(self, src_pages: list[int], dst_pages: list[int]) -> None:
        """Copy-on-write device copy: physical page ``src[i]`` → ``dst[i]`` in
        every layer's pools.  (JAX pads the list to a size bucket to bound
        jit variants and drops the pads; eager PyTorch needs no padding.)"""
        src = self._to_device(np.asarray(src_pages, np.int64))
        dst = self._to_device(np.asarray(dst_pages, np.int64))
        for name in ("k", "v"):
            pool = self.cache[name]
            pool[:, dst] = pool[:, src]

    def _admit_batch(self, reqs: list[Request], slots: list[int]):
        """Admit ``reqs`` into ``slots`` with ONE prefill + ONE insert.

        Prompts pad to a shared length bucket (paged: rounded up to a page
        multiple); the batch count pads to a power-of-two bucket, whose
        padding rows carry the slot index ``max_slots`` and are never
        written.
        """
        B = self._bucket_count(len(reqs))
        L = self._bucket_len(max(len(r.tokens) for r in reqs))
        seqs = [r.tokens for r in reqs] + [[self.pad_id]] * (B - len(reqs))
        slot_arr = np.full(B, self.max_slots, dtype=np.int32)
        slot_arr[: len(reqs)] = slots
        if self.paged:
            logits = self._admit_paged(reqs, slots, seqs, slot_arr, L)
        else:
            tokens, lengths = self.tok.pad_batch(seqs, L)
            logits, rows = self.model.prefill(self._to_device(tokens),
                                              lengths=self._to_device(lengths))
            self.n_prefill_calls += 1
            self._insert_many(rows, slot_arr)
        sample, *knobs = self._sampling_arrays(reqs + [None] * (B - len(reqs)))
        if sample:
            # sampled first token: stream position 0, the fold-in of every
            # later position; the bucket's padding rows stay greedy
            first = self._pick_tokens(logits[:, 0], np.zeros(B, np.int32), *knobs)
        else:
            # argmax takes the first maximum, as jnp.argmax does
            first = logits[:, 0].argmax(dim=-1).cpu().numpy()
        now = time.time()
        for req, slot, f in zip(reqs, slots, first):
            self.slot_req[slot] = req
            req.started_at = now
            req.finished_at = None      # clear stale timing on re-admission
            req.done = False
            req.out_tokens.append(int(f))
            if int(f) == self.eos_id:
                self._retire(slot)
            if req.on_tokens is not None:
                req.on_tokens([int(f)], req.done)

    def _admit_paged(self, reqs, slots, seqs, slot_arr, L):
        """The paged half of :meth:`_admit_batch`: build the sharing plan,
        prefill the page-multiple bucket once and write its pages.  The
        owner (first request) allocates all its prompt pages; every sibling
        points its table at the owner's common-prefix pages and allocates
        only the pages past it.  Causal attention makes each row's prefix K/V
        identical, so which row's bytes land in a shared page is immaterial.
        Returns the prefill's logits."""
        ps = self.page_size
        Lp = -(-L // ps) * ps
        tokens, lengths = self.tok.pad_batch(seqs, Lp)
        dst = np.full((len(seqs), Lp // ps), self.kv.alloc.n_pages, np.int32)
        owner_pages: list[int] = []
        for idx, (req, slot) in enumerate(zip(reqs, slots)):
            n_need = -(-len(req.tokens) // ps)
            if idx == 0:
                pages = self.kv.alloc.alloc_n(n_need)
                owner_pages = pages
                dst[idx, :n_need] = pages
            else:
                n_sh = 0
                if self.share_prefix:
                    n_sh = min(self._sibling_share_pages(reqs[0].tokens, req.tokens),
                               n_need, len(owner_pages))
                pages = [self.kv.alloc.share(p) for p in owner_pages[:n_sh]]
                priv = self.kv.alloc.alloc_n(n_need - n_sh)
                dst[idx, n_sh:n_need] = priv
                pages = pages + priv
            self.kv.map_slot(slot, pages)
        logits, rows = self.model.prefill(self._to_device(tokens),
                                          lengths=self._to_device(lengths))
        self.n_prefill_calls += 1
        self._insert_pages(rows, slot_arr, dst)
        return logits

    def _admit_free(self, queue: list[Request]):
        """Fill every free slot from the queue (FCFS, slot-index order); an
        EOS-at-prefill retirement frees its slot for the next round."""
        while queue:
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            if not free:
                return
            n = min(len(free), len(queue))
            self._admit_batch([queue.pop(0) for _ in range(n)], free[:n])

    def _retire(self, slot: int):
        req = self.slot_req[slot]
        if req is not None:
            req.done = True
            req.finished_at = time.time()
        self.slot_req[slot] = None
        if self.paged:
            # drop the slot's table references; only pages no sibling still
            # shares actually return to the free list
            self.kv.release_slot(slot)

    def _active_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    @staticmethod
    def _gen_of(req: Request) -> GenerationConfig:
        """Effective generation config: the request's, or a greedy one from
        the legacy ``max_new`` field."""
        if req.gen is not None:
            return req.gen
        return GenerationConfig(max_new=req.max_new)

    @staticmethod
    def _base_key(req: Request) -> np.ndarray:
        """Per-request PRNG base key, ``jax.random.PRNGKey(seed)``'s bits
        (cached on the request: from admission to retirement the fused and
        the stepwise loops fold the same base with the position)."""
        key = getattr(req, "_prng_base", None)
        if key is None:
            key = req._prng_base = prng.prng_key(ServingEngine._gen_of(req).seed)
        return key

    def _pick_tokens(self, logits, n, keys, temp, top_k, top_p) -> np.ndarray:
        """One sampled token per row at stream position ``n``, the rows'
        knobs as numpy arrays: the admission and stepwise counterpart of the
        fused body's sampling (the same fold-in, so both loops agree), read
        back to the host."""
        keys = prng.as_words(keys).to(self.device)
        toks = sample_tokens(logits, _fold_keys(keys, self._to_device(n)),
                             self._to_device(temp), self._to_device(top_k),
                             self._to_device(top_p))
        return toks.cpu().numpy()

    def _slot_state(self):
        """Host view of the device decode state, rebuilt from the requests
        each fused call — the host bookkeeping stays authoritative."""
        last = np.zeros(self.max_slots, dtype=np.int32)
        act = np.zeros(self.max_slots, dtype=bool)
        n_out = np.zeros(self.max_slots, dtype=np.int32)
        limit = np.ones(self.max_slots, dtype=np.int32)
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            last[i] = req.out_tokens[-1]
            act[i] = True
            n_out[i] = len(req.out_tokens)
            limit[i] = min(self._gen_of(req).max_new,
                           self.max_len - 1 - len(req.tokens))
        return last, act, n_out, limit

    def _sampling_arrays(self, rows: list[Optional[Request]]):
        """Sampling arrays of a row a request (None: an empty row): ``sample,
        keys, temp, top_k, top_p``.  Rows of greedy requests and empty rows
        stay at (temp=0, key=0) and take the argmax branch of
        :func:`sample_tokens`; ``sample`` is False iff no row is sampled, and
        the caller then runs the exact greedy path."""
        n = len(rows)
        keys = np.zeros((n, 2), dtype=np.uint32)
        temp = np.zeros(n, dtype=np.float32)
        top_k = np.zeros(n, dtype=np.int32)
        top_p = np.ones(n, dtype=np.float32)
        sample = False
        for i, req in enumerate(rows):
            g = None if req is None else self._gen_of(req)
            if g is None or g.greedy:
                continue
            sample = True
            keys[i] = self._base_key(req)
            temp[i], top_k[i], top_p[i] = g.temperature, g.top_k, g.top_p
        return sample, keys, temp, top_k, top_p

    def _sampling_state(self):
        """The sampling arrays of the live slots (``_sampling_arrays`` over
        ``slot_req``), under the JAX engine's name: what the speculative
        engine's dispatches read."""
        return self._sampling_arrays(self.slot_req)

    def _load_state(self) -> bool:
        """Fill the fused dispatch's static state from the host bookkeeping.
        Returns ``sample``."""
        last, act, n_out, limit = self._slot_state()
        sample, keys, temp, top_k, top_p = self._sampling_state()
        self._state.load(np.stack([last, act.astype(np.int32), n_out, limit,
                                   keys[:, 0].view(np.int32), keys[:, 1].view(np.int32),
                                   temp.view(np.int32), top_k, top_p.view(np.int32)], axis=1))
        return sample

    def _prepare_paged(self, active: list[int], horizon: int, offset: int = 0):
        """Page maintenance before one decode dispatch: grow every active
        slot's table to cover its next ``decode_block`` writes, CoW-fork any
        still-shared page in that write range (one copy for the whole tick),
        and upload the table sliced to the horizon's column count — the
        slice bounds per-step attention cost.  The table goes into the
        static buffer of its column count, which the dispatch reads.

        ``offset`` shifts the first write position from ``prompt +
        emitted``: the speculative engine passes −1, since its dispatches
        re-feed the last emitted token, whose K/V was rolled back or never
        written."""
        ps = self.page_size
        cap = self.kv.pages_per_slot * ps
        src: list[int] = []
        dst: list[int] = []
        for i in active:
            req = self.slot_req[i]
            ln = len(req.tokens) + len(req.out_tokens) + offset
            end = min(ln + self.decode_block, cap)
            self.kv.extend_slot(i, -(-end // ps))
            s, d = self.kv.fork_for_write(i, ln, end)
            src += s
            dst += d
        if src:
            self._fork_pages(src, dst)
        n_cols = min(self.kv.pages_per_slot, -(-horizon // ps))
        table = self._tables.get(n_cols)
        if table is None:
            table = self._tables[n_cols] = StaticInput((self.max_slots, n_cols), torch.int32,
                                                       self.device)
        table.load(self.kv.table[:, :n_cols])
        return table.tensor

    def _horizon_view(self, horizon: int) -> dict:
        """The contiguous cache with its sequence axis cut to ``horizon``:
        views of the K/V buffers (decode writes land in the cache itself,
        and the kernel reads them through their strides, so nothing is
        copied) and the shared ``len``.  The host guarantees ``horizon`` ≥
        the longest live sequence + K, so the cut is exact; a retired slot's
        garbage stream may run past it, where its writes are dropped."""
        return {"k": self.cache["k"][:, :, :horizon], "v": self.cache["v"][:, :, :horizon],
                "len": self.cache["len"]}

    def _decode_k(self, horizon: int, table, sample: bool):
        """The fused dispatch's body: ``decode_block`` decode steps back to
        back, reading the static state (``_load_state``).

        ``table``: the paged table sliced to the horizon's columns (a static
        buffer), or None for the contiguous cache's horizon view.  Device
        state per slot: ``last`` (next input token), ``active`` (still
        generating), ``n`` (tokens emitted, the prefill's first included,
        which is also the stream position a sampled key is folded with) and
        ``limit`` (min(max_new, max_len−1−prompt)); with ``sample``, the
        keys and knobs of :func:`sample_tokens`.  The cache is updated in
        place (JAX donates it to the scan).  Returns one (2K + 1, max_slots)
        int32 tensor: the K tokens a slot, their validity (``valid[k, i]`` ⇔
        slot i was active entering step k) and the final active mask.
        Inactive slots decode garbage: into pages no live table maps, or
        into their own contiguous rows, which admission rewrites.
        """
        st = self._state.tensor
        last, act, n, limit = st[:, 0], st[:, 1] != 0, st[:, 2], st[:, 3]
        if sample:
            keys = prng.as_words(st[:, 4:6])
            temp, top_k, top_p = st[:, 6].view(torch.float32), st[:, 7], st[:, 8].view(
                torch.float32)
        cache = self.cache if self.paged else self._horizon_view(horizon)
        toks, valid = [], []
        for _ in range(self.decode_block):
            logits = self.model.decode_step(last[:, None], cache, table)
            if sample:
                nxt = sample_tokens(logits[:, 0], _fold_keys(keys, n), temp, top_k, top_p)
            else:
                nxt = logits[:, 0].argmax(dim=-1).to(torch.int32)
            n = n + act.to(torch.int32)
            done = act & ((nxt == self.eos_id) | (n >= limit))
            last = torch.where(act, nxt, last)
            toks.append(nxt)
            valid.append(act)
            act = act & ~done
        return torch.cat([torch.stack(toks), torch.stack(valid).to(torch.int32),
                          act[None].to(torch.int32)])

    def kv_occupancy(self) -> dict:
        """KV memory telemetry.  Contiguous engines report the committed
        buffer size (every slot owns a full ``max_len`` row whether it uses
        it or not); paged engines report live and peak *mapped* bytes —
        distinct physical pages times per-page bytes summed across layers
        (the drop page is not counted)."""
        if not self.paged:
            kv_bytes = sum(self.cache[n].numel() * self.cache[n].element_size()
                           for n in ("k", "v"))
            return {"paged": False, "kv_bytes": kv_bytes, "peak_kv_bytes": kv_bytes}
        occ = self.kv.occupancy()
        page_bytes = 2 * self.cache["k"][:, 0].numel() * self.cache["k"].element_size()
        occ.update(paged=True, page_bytes=page_bytes,
                   kv_bytes=occ["pages_used"] * page_bytes,
                   peak_kv_bytes=occ["peak_pages"] * page_bytes)
        return occ

    # ------------------------------------------------------------------
    def serve(self, requests: list[Request]) -> list[Request]:
        """Run all requests to completion with continuous batching: one
        batched admission per tick, then one fused dispatch of up to
        ``decode_block`` tokens for every active slot (on the card one graph
        replay), with one device→host copy of its results."""
        queue = list(requests)
        while queue or self._active_slots():
            self._admit_free(queue)
            active = self._active_slots()
            if not active:
                continue
            sample = self._load_state()
            live = max(len(self.slot_req[i].tokens) + len(self.slot_req[i].out_tokens)
                       for i in active)
            horizon = min(self.max_len, self._bucket_len(live + self.decode_block))
            if self.paged:
                table = self._prepare_paged(active, horizon)
                key = (table.shape[1], sample)
            else:
                table, key = None, (horizon, sample)
            # the body binds this dispatch's values (a lambda would read the
            # loop's variables as they stand whenever it is called)
            out = self._graphs.run(key, partial(self._decode_k, horizon, table, sample))
            self.n_decode_calls += 1
            self.n_decode_steps += self.decode_block
            K = self.decode_block
            host = out.cpu().numpy()
            toks, valid, act_f = host[:K], host[K:2 * K].astype(bool), host[2 * K].astype(bool)
            for i in active:
                req = self.slot_req[i]
                block = [int(t) for t in toks[valid[:, i], i]]
                req.out_tokens.extend(block)
                if not act_f[i]:
                    self._retire(i)
                if req.on_tokens is not None:
                    req.on_tokens(block, req.done)
        return requests

    def serve_stepwise(self, requests: list[Request]) -> list[Request]:
        """Reference driver: one admission per request (into the lowest free
        slot) and one host round-trip (dispatch + argmax) per generated token,
        over the whole ``max_len`` cache.  Outputs, greedy or sampled, are
        identical to :meth:`serve`'s.  Contiguous layout only, as in JAX: it is the
        reference, and paging it would leave no fixed point to test
        against."""
        if self.paged:
            raise RuntimeError("serve_stepwise is the contiguous parity "
                               "reference; use serve() on a paged engine")
        queue = list(requests)
        while queue or self._active_slots():
            for slot in range(self.max_slots):
                if self.slot_req[slot] is None and queue:
                    self._admit_batch([queue.pop(0)], [slot])
            active = self._active_slots()
            if not active:
                continue
            # lockstep decode across all slots (inactive slots decode garbage
            # into their own rows; admission rewrites them)
            last = np.full((self.max_slots, 1), self.pad_id, dtype=np.int32)
            for i in active:
                last[i, 0] = self.slot_req[i].out_tokens[-1]
            logits = self.model.decode_step(self._to_device(last), self.cache)
            self.n_decode_calls += 1
            self.n_decode_steps += 1
            sample, *knobs = self._sampling_arrays(self.slot_req)
            if sample:
                n_arr = np.zeros(self.max_slots, dtype=np.int32)
                for i in active:
                    n_arr[i] = len(self.slot_req[i].out_tokens)
                nxt = self._pick_tokens(logits[:, 0], n_arr, *knobs)
            else:
                nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
            for i in active:
                req = self.slot_req[i]
                req.out_tokens.append(int(nxt[i]))
                total_len = len(req.tokens) + len(req.out_tokens)
                if (int(nxt[i]) == self.eos_id
                        or len(req.out_tokens) >= self._gen_of(req).max_new
                        or total_len >= self.max_len - 1):
                    self._retire(i)
                if req.on_tokens is not None:
                    req.on_tokens([int(nxt[i])], req.done)
        return requests

    # convenience --------------------------------------------------------
    def generate_text(self, prompts: list[str], max_new: int = 32,
                      gen: Optional[GenerationConfig] = None) -> list[str]:
        """``gen`` supersedes ``max_new`` when given."""
        if gen is not None:
            max_new = gen.max_new
        reqs = [Request(rid=i, tokens=self.tok.encode(p), max_new=max_new, gen=gen)
                for i, p in enumerate(prompts)]
        self.serve(reqs)
        outs = []
        for r in reqs:
            ids = r.out_tokens
            if self.eos_id in ids:
                ids = ids[: ids.index(self.eos_id)]
            outs.append(self.tok.decode(ids))
        return outs
