"""Routed speculative decoding: a cheap pool member drafts, the routed (dearer)
model verifies.

Counterpart of the JAX package's ``serving/speculative.py``
(``SpeculativeEngine``), with the same host logic.  One engine wraps two
paged :class:`ServingEngine`s over the same token stream, each with
``decode_block = spec_k + 1``: the *draft* runs K+1 fused decode steps to
propose ``spec_k`` tokens, then the *target* scores all of them in one
:meth:`Model.decode_span` call (K+1 of its decode steps in one dispatch).
Each keeps its own paged KV, so batch-prompt
prefixes share pages on both sides, and a rejected draft suffix rolls back by
block-table truncation (``PagedCacheManager.truncate_slot``) plus a write of
the host's lengths into ``cache["len"]`` at the entry of the next dispatch:
no K/V byte is copied back.

Acceptance is deterministic match: the verify pass computes the target's own
next token at every draft position (argmax, or for a sampled request
:func:`sample_tokens` with the key folded with that stream position, as the
target alone would draw it).  A draft token is accepted iff it equals that
choice; the first mismatch emits the target's choice instead, and a fully
accepted window emits the target's K+1-th token as a bonus.  So the emitted
stream is the target's own by construction, since ``decode_span`` gives
the logits of sequential decode steps: the draft moves the accept rate,
never the text.

Between rounds, with n tokens emitted, both caches hold K/V for positions
``[0, prompt + n − 1)``: the last emitted token is fed, and its K/V written,
by the next round's dispatches.

On the card each draft dispatch and each verify dispatch is one CUDA-graph
replay, through the inner engines' :class:`GraphSet`s, keyed like the
engine's paged dispatches on (table column count, ``sample``).  Both bodies
read one packed static buffer of per-slot state (the lengths to reset to,
the last token, the emitted count, the two key words and the three sampling
knobs), the verify also a static (slots, K+1) buffer of its inputs, which
the host fills once the draft's tokens are read back.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import Request, ServingEngine, _fold_keys, sample_tokens
from repro_torch.serving.graphs import StaticInput
from repro_torch.utils import prng

__all__ = ["SpeculativeEngine"]


class SpeculativeEngine:
    """Draft/verify serving engine with :class:`ServingEngine`'s surface
    (``serve``, ``generate_text``, ``kv_occupancy``, the dispatch counters).

    ``spec_k`` is the speculation depth: each round drafts ``spec_k`` tokens
    with ``draft_model`` and verifies them, with the bonus position, in one
    ``model.decode_span`` pass.  Both models must share the target's vocab
    and live on ``device`` (default ``"cuda"``).
    """

    def __init__(self, model: Model, draft_model: Model, *, max_slots: int = 8,
                 max_len: int = 1024, spec_k: int = 4, page_size: int = 16,
                 share_prefix: bool = True, eos_id: int = ByteTokenizer.eos,
                 pad_id: int = ByteTokenizer.pad, device="cuda"):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if draft_model.cfg.vocab_size != model.cfg.vocab_size:
            raise ValueError(f"draft vocab {draft_model.cfg.vocab_size} differs from the "
                             f"target's {model.cfg.vocab_size}")
        self.spec_k = int(spec_k)
        self.model = model
        self.draft_model = draft_model
        self.max_slots = max_slots
        self.max_len = max_len
        self.paged = True
        self.page_size = int(page_size)
        self.share_prefix = bool(share_prefix)
        self.decode_block = self.spec_k + 1
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.target = ServingEngine(model, max_slots=max_slots, max_len=max_len,
                                    decode_block=self.decode_block, paged=True,
                                    page_size=page_size, share_prefix=share_prefix,
                                    eos_id=eos_id, pad_id=pad_id, device=device)
        # the draft never retires on its own: eos_id=-1 suppresses EOS (and
        # admission-time retirement); the target's stream decides lifecycle
        self.draft = ServingEngine(draft_model, max_slots=max_slots, max_len=max_len,
                                   decode_block=self.decode_block, paged=True,
                                   page_size=page_size, share_prefix=share_prefix, eos_id=-1,
                                   pad_id=pad_id, device=device)
        self.device = self.target.device
        self.tok = self.target.tok
        self.n_rounds = 0               # draft + verify dispatch pairs
        self.n_drafted = 0              # draft tokens proposed (k a slot-round)
        self.n_accepted = 0             # draft tokens the target accepted
        self.n_bonus = 0                # bonus tokens of fully accepted windows
        # one int32 row a slot: the length to reset to, last token, emitted
        # count, the two key words, temperature (float32 bits), top-k, top-p
        # (float32 bits); and the verify's K+1 inputs a slot
        self._state = StaticInput((max_slots, 8), torch.int32, self.device)
        self._xs = StaticInput((max_slots, self.decode_block), torch.int32, self.device)

    # ---- telemetry ----------------------------------------------------
    @property
    def n_decode_calls(self) -> int:
        return self.target.n_decode_calls + self.draft.n_decode_calls

    @property
    def n_decode_steps(self) -> int:
        return self.target.n_decode_steps + self.draft.n_decode_steps

    @property
    def n_prefill_calls(self) -> int:
        return self.target.n_prefill_calls + self.draft.n_prefill_calls

    def accept_rate(self) -> float:
        return self.n_accepted / max(self.n_drafted, 1)

    def kv_occupancy(self) -> dict:
        """The target's paged occupancy with the draft pool's bytes added."""
        occ = self.target.kv_occupancy()
        docc = self.draft.kv_occupancy()
        occ["draft_kv_bytes"] = docc["kv_bytes"]
        occ["kv_bytes"] += docc["kv_bytes"]
        occ["peak_kv_bytes"] += docc["peak_kv_bytes"]
        return occ

    # ---- the two dispatches ---------------------------------------------
    def _knobs(self, st):
        """The sampling inputs of the packed state: keys, temp, top-k, top-p."""
        return (prng.as_words(st[:, 3:5]), st[:, 5].view(torch.float32), st[:, 6],
                st[:, 7].view(torch.float32))

    def _draft_k(self, table, sample: bool):
        """K+1 draft steps: the last emitted token, then each proposal fed
        back.  No EOS or limit masking (the target's stream decides); the
        last step only writes the K-th proposal's K/V.  The draft cache's
        lengths are first reset to the host's (the rollback of the previous
        round).  Returns the (K+1, slots) int32 proposals."""
        st = self._state.tensor
        last, n = st[:, 1], st[:, 2]
        if sample:
            keys, temp, top_k, top_p = self._knobs(st)
        cache = self.draft.cache
        cache["len"].copy_(st[:, 0])
        toks = []
        for _ in range(self.decode_block):
            logits = self.draft_model.decode_step(last[:, None], cache, table)
            if sample:
                last = sample_tokens(logits[:, 0], _fold_keys(keys, n), temp, top_k, top_p)
            else:
                last = logits[:, 0].argmax(dim=-1).to(torch.int32)
            n = n + 1
            toks.append(last)
        return torch.stack(toks)

    def _verify_k(self, table, sample: bool):
        """One target pass over the window: ``decode_span`` of the static
        (slots, K+1) inputs (the last emitted token, then the K drafts) after
        the lengths are reset, and the target's own token at each position
        (argmax, or the sample keyed by stream position ``n_out + i``).
        Returns (K+1, slots) int32."""
        st = self._state.tensor
        n = st[:, 2]
        if sample:
            keys, temp, top_k, top_p = self._knobs(st)
        cache = self.target.cache
        cache["len"].copy_(st[:, 0])
        logits = self.model.decode_span(self._xs.tensor, cache, table)
        toks = []
        for i in range(self.decode_block):
            if sample:
                toks.append(sample_tokens(logits[:, i], _fold_keys(keys, n + i), temp, top_k,
                                          top_p))
            else:
                toks.append(logits[:, i].argmax(dim=-1).to(torch.int32))
        return torch.stack(toks)

    # ---- lifecycle ----------------------------------------------------
    def _sync_shadows(self):
        """Mirror freshly admitted target requests into the draft engine:
        the shadow shares the tokens, the generation config (same seed, so a
        sampled draft draws with the target's keys) and the target's first
        token.  The draft's admission writes prompt K/V only, the round
        invariant at one emitted token."""
        reqs, slots = [], []
        for i, req in enumerate(self.target.slot_req):
            if req is None or self.draft.slot_req[i] is not None:
                continue
            reqs.append((Request(rid=req.rid, tokens=list(req.tokens), max_new=self.max_len,
                                 gen=req.gen), req))
            slots.append(i)
        if not reqs:
            return
        self.draft._admit_batch([s for s, _ in reqs], slots)
        for shadow, req in reqs:
            # the draft's own first token is dropped: the stream is the target's
            shadow.out_tokens[:] = list(req.out_tokens)
            shadow.done = False

    def _release_slot(self, slot: int):
        self.target._retire(slot)
        if self.draft.slot_req[slot] is not None:
            self.draft._retire(slot)

    # ---- serving ------------------------------------------------------
    def serve(self, requests: list[Request]) -> list[Request]:
        """Continuous-batching speculative serving: one draft and one verify
        dispatch a round (on the card two graph replays), one read-back of
        each.  The emitted streams are ``ServingEngine.serve``'s on the
        target alone."""
        k = self.spec_k
        queue = list(requests)
        while queue or self.target._active_slots():
            self.target._admit_free(queue)
            self._sync_shadows()
            active = self.target._active_slots()
            if not active:
                continue
            last, _, n_out, limit = self.target._slot_state()
            sample, keys, temp, top_k, top_p = self.target._sampling_state()
            live = max(len(self.target.slot_req[i].tokens)
                       + len(self.target.slot_req[i].out_tokens) for i in active)
            horizon = min(self.max_len, self.target._bucket_len(live + k + 1))
            # with n tokens emitted the caches cover [0, prompt + n − 1); both
            # dispatches reset their lengths to this at entry
            lens = np.zeros(self.max_slots, np.int32)
            for i in active:
                req = self.target.slot_req[i]
                lens[i] = len(req.tokens) + len(req.out_tokens) - 1
            self._state.load(np.stack([lens, last, n_out, keys[:, 0].view(np.int32),
                                       keys[:, 1].view(np.int32), temp.view(np.int32), top_k,
                                       top_p.view(np.int32)], axis=1))
            # the draft: offset −1, since the dispatch re-feeds the last
            # emitted token, whose K/V is not written yet
            dtable = self.draft._prepare_paged(active, horizon, offset=-1)
            d_toks = self.draft._graphs.run((dtable.shape[1], sample),
                                            partial(self._draft_k, dtable, sample))
            d_toks = d_toks.cpu().numpy()                      # (K+1, slots)
            self.draft.n_decode_calls += 1
            self.draft.n_decode_steps += k + 1
            # the verify: one target pass over the whole window
            xs = np.zeros((self.max_slots, k + 1), np.int32)
            xs[:, 0] = last
            xs[:, 1:] = d_toks[:k].T
            self._xs.load(xs)
            ttable = self.target._prepare_paged(active, horizon, offset=-1)
            t_toks = self.target._graphs.run((ttable.shape[1], sample),
                                             partial(self._verify_k, ttable, sample))
            t_toks = t_toks.cpu().numpy()                      # (K+1, slots)
            self.target.n_decode_calls += 1
            self.target.n_decode_steps += k + 1
            self.n_rounds += 1
            # the host's accept/reject and lifecycle
            for i in active:
                req = self.target.slot_req[i]
                n = int(n_out[i])
                lim = int(limit[i])
                block: list[int] = []
                done = False
                self.n_drafted += k
                for j in range(k + 1):
                    tt = int(t_toks[j, i])
                    match = j < k and tt == int(d_toks[j, i])
                    block.append(tt)
                    n += 1
                    if match:
                        self.n_accepted += 1
                    elif j == k:
                        self.n_bonus += 1       # a fully accepted window
                    if tt == self.eos_id or n >= lim:
                        done = True
                        break
                    if not match:
                        # a mismatch (the target's token replaced the
                        # draft's), or the bonus token ends the window
                        break
                req.out_tokens.extend(block)
                self.draft.slot_req[i].out_tokens[:] = list(req.out_tokens)
                if done:
                    self._release_slot(i)
                else:
                    # roll both caches back to the accepted length: pages by
                    # table truncation now, lengths at the next dispatch's entry
                    keep = len(req.tokens) + len(req.out_tokens) - 1
                    self.target.kv.truncate_slot(i, keep)
                    self.draft.kv.truncate_slot(i, keep)
                if req.on_tokens is not None:
                    req.on_tokens(block, req.done)
        return requests

    # convenience --------------------------------------------------------
    def generate_text(self, prompts: list[str], max_new: int = 32, gen=None) -> list[str]:
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
