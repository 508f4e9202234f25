"""Mixture-of-experts layer of the port: top-k router, an optional shared
expert, and the capacity-based dispatch in two forms.

Counterpart of the JAX package's ``models/moe.py`` (``init_moe``,
``apply_moe``, ``_pair_ranks``, ``_dispatch_gather``, ``_dispatch_dense``).
The parameter names mirror its tree — ``router`` (d, E), ``gate``/``up``
(E, d, f) (``up`` alone for the ungated GELU and squared-ReLU experts),
``down`` (E, f, d), and with a shared expert ``shared.gate``,
``shared.up``, ``shared.down`` (``Dense``) and ``shared.gate_proj`` (d, 1)
— so the weight bridge maps ``blocks/b<s>/mlp/...`` with no special case.

Dispatch (``ShardingConfig.moe_dispatch``):

* ``gather`` (default): each (token, slot) pair takes a rank within its
  expert in (token, slot) order; pairs ranked below the capacity C fill an
  (E, C, d) buffer, the experts run as batched products over it, and each
  token sums its kept pairs' weighted outputs;
* ``dense``: GShard's one-hot dispatch and combine einsums, the oracle.

Expert-parallel dispatch (``"ep"``) needs the mesh and is not ported.  The
expert products are ``torch.bmm`` over all E experts, as JAX's
``_expert_ffn`` runs them as ``einsum`` outside any Pallas kernel.

Everything here runs inside a captured decode graph: no operator's output
size depends on the data, nothing reads a value back to the host, and the
combine uses no atomics, so a replay gives the eager body's bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Dense, empty_param, init_normal_
from repro_torch.models.mlp import GATED, UNGATED

__all__ = ["MoE", "pair_ranks", "top_k_stable", "dispatch_gather", "dispatch_dense",
           "capacity"]


class SharedExpert(nn.Module):
    """The always-on expert of Qwen2-MoE: ``down(silu(gate(x)) · up(x))``,
    scaled by a per-token ``sigmoid(x @ gate_proj)``."""

    def __init__(self, d: int, d_shared: int, *, dtype, device):
        super().__init__()
        self.gate = Dense(d, d_shared, bias=False, dtype=dtype, device=device)
        self.up = Dense(d, d_shared, bias=False, dtype=dtype, device=device)
        self.down = Dense(d_shared, d, bias=False, dtype=dtype, device=device)
        self.gate_proj = empty_param((d, 1), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for lin in (self.gate, self.up, self.down):
            lin.init(generator)
        init_normal_(self.gate_proj, generator)

    def forward(self, xt):
        sh = self.down(F.silu(self.gate(xt)) * self.up(xt))
        return torch.sigmoid(xt @ self.gate_proj.to(xt.dtype)) * sh


class MoE(nn.Module):
    """The MoE MLP of a block.  ``forward(x, exact=False)`` returns ``(out,
    aux)``, as JAX's ``apply_moe``: ``exact`` sets the capacity to the
    token count (no drops), which the decode steps use."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, dispatch: str = "gather",
                 chunk_tokens: int = 65_536):
        super().__init__()
        m = cfg.moe
        if dispatch == "ep":
            raise NotImplementedError(
                "moe_dispatch='ep' (expert parallelism) needs the device mesh, which is not "
                "ported yet (ROADMAP queue 4); on one card the JAX package runs it with "
                "dp_size = 1, which is the 'gather' dispatch")
        if dispatch not in ("gather", "dense"):
            raise ValueError(f"unknown moe_dispatch {dispatch!r}")
        if cfg.activation not in GATED and cfg.activation not in UNGATED:
            raise NotImplementedError(f"expert activation {cfg.activation!r} is not ported yet")
        self.cfg, self.dispatch, self.chunk_tokens = cfg, dispatch, chunk_tokens
        d, E, f = cfg.d_model, m.n_experts, m.d_expert
        self.router = empty_param((d, E), dtype, device)
        self.act = GATED.get(cfg.activation) or UNGATED[cfg.activation]
        # ungated experts (GELU, squared ReLU) hold up and down only, as JAX's tree
        self.gate = (empty_param((E, d, f), dtype, device) if cfg.activation in GATED
                     else None)
        self.up = empty_param((E, d, f), dtype, device)
        self.down = empty_param((E, f, d), dtype, device)
        self.shared = (SharedExpert(d, m.d_shared, dtype=dtype, device=device)
                       if m.d_shared else None)

    def init(self, generator: torch.Generator) -> None:
        """The ``Builder``'s normal init, std 1/sqrt(fan_in) with fan_in the
        second-to-last dim (d for the router, gate and up; f for down)."""
        for p in (self.router, self.gate, self.up, self.down):
            if p is not None:
                init_normal_(p, generator)
        if self.shared is not None:
            self.shared.init(generator)

    def expert_ffn(self, x):
        """x: (E, C, d) -> (E, C, d), every expert's MLP on its C rows: gated
        ``act(x·gate) · (x·up)``, or ungated ``act(x·up)``, then ``·down``."""
        if self.gate is None:
            return torch.bmm(self.act(torch.bmm(x, self.up)), self.down)
        return torch.bmm(self.act(torch.bmm(x, self.gate)) * torch.bmm(x, self.up), self.down)

    def forward(self, x, exact: bool = False):
        """x: (B, S, d).  Router logits in x's dtype, softmax in fp32, the
        top-k renormalised; the Switch load-balance loss ``aux``; dispatch
        with capacity ``C = min(max(1, ceil(T·k/E·cf)), T)`` (``C = T``
        when ``exact``) over all T = B·S tokens at once, or over chunks of
        ``chunk_tokens`` when T is a larger multiple of it; then the shared
        expert.  Returns ``(out (B, S, d) in x's dtype, aux fp32 scalar)``."""
        m = self.cfg.moe
        B, S, d = x.shape
        T = B * S
        xt = x.reshape(T, d)
        logits = (xt @ self.router.to(xt.dtype)).float()
        probs = torch.softmax(logits, dim=-1)                        # (T, E)
        top_p, top_i = top_k_stable(probs, m.top_k)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

        # Switch load-balance loss E · Σ_e f_e · P_e, f_e the share of the
        # T·k pairs routed to e: Σ_e f_e · P_e is the mean of P over the pairs
        aux = m.n_experts * m.router_aux_weight * probs.mean(0)[top_i].mean()

        fn = dispatch_dense if self.dispatch == "dense" else dispatch_gather
        chunk = self.chunk_tokens
        if exact or T <= chunk or T % chunk != 0:
            out = fn(self, xt, top_p, top_i, T if exact else capacity(m, T))
        else:
            C = capacity(m, chunk)
            out = torch.cat([fn(self, xt[c:c + chunk], top_p[c:c + chunk],
                                top_i[c:c + chunk], C) for c in range(0, T, chunk)])
        if self.shared is not None:
            out = out + self.shared(xt)
        return out.reshape(B, S, d).to(x.dtype), aux


def capacity(m, T: int) -> int:
    """Slots an expert keeps of T tokens: ``min(max(1, ceil(T·k/E·cf)), T)``."""
    return min(max(1, math.ceil(T * m.top_k / m.n_experts * m.capacity_factor)), T)


def top_k_stable(probs, k: int):
    """The k largest of each row, largest first, with ties in ascending
    index order as ``jax.lax.top_k`` gives them (``torch.topk`` promises no
    order for ties, and bf16 router logits tie often): the first k of a
    stable descending sort.  Returns (values, indices)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pair_ranks(top_i):
    """Rank of each (token, slot) pair within its expert, in (token, slot)
    order (JAX's ``_pair_ranks``): the pairs grouped by expert with a stable
    sort, each one's rank its place in the sorted order less its group's
    start.  Returns (flat expert ids (P,), ranks (P,)), P = T·k, both
    int64."""
    flat_e = top_i.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    ranks_sorted = (torch.arange(flat_e.shape[0], device=flat_e.device)
                    - torch.searchsorted(sorted_e, sorted_e))
    return flat_e, torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)


def _slots(top_i, n_experts: int, C: int):
    """Each pair's slot ``e·C + rank`` in the (E·C + 1)-row buffer, or the
    last row ``E·C`` when the pair is dropped (rank >= C)."""
    flat_e, ranks = pair_ranks(top_i)
    return torch.where(ranks < C, flat_e * C + ranks, n_experts * C)


def dispatch_gather(moe: MoE, xt, top_p, top_i, C: int):
    """The capacity-based gather dispatch of T tokens (JAX's
    ``_dispatch_gather``).  Slot buffers have E·C + 1 rows; the last takes
    the dropped pairs and is cut off, as JAX's ``mode="drop"`` scatter
    does.  Empty slots point at token 0 with weight 0, and rows of weight 0
    are zeroed before the experts run.

    The combine uses no atomics: token t reads its k weighted expert
    outputs back through its pairs' slots (a dropped pair reads a zero
    row) and sums them in one reduction over its k slots, in top-k order:
    one fixed order, the same bits on every run and in every graph replay.
    In bf16 the reduction accumulates in fp32 and rounds once, where JAX's
    ``out.at[slot_tok].add(h)`` rounds after each addition; in fp32 the two
    agree to rounding."""
    E = moe.cfg.moe.n_experts
    T, d = xt.shape
    k = top_i.shape[1]
    slot = _slots(top_i, E, C)                                    # (P,)
    tok = torch.arange(T * k, device=xt.device) // k              # each pair's token
    slot_tok = torch.zeros(E * C + 1, dtype=torch.int64, device=xt.device).scatter_(
        0, slot, tok)[:-1]
    slot_w = torch.zeros(E * C + 1, dtype=torch.float32, device=xt.device).scatter_(
        0, slot, top_p.reshape(-1))[:-1].reshape(E, C, 1)
    h = moe.expert_ffn(xt[slot_tok].reshape(E, C, d) * (slot_w > 0)) * slot_w.to(xt.dtype)
    rows = torch.cat([h.reshape(E * C, d), h.new_zeros((1, d))])[slot]
    return rows.reshape(T, k, d).sum(1)


def dispatch_dense(moe: MoE, xt, top_p, top_i, C: int):
    """GShard's one-hot dispatch (JAX's ``_dispatch_dense``): combine[t, e,
    c] is token t's weight in expert e's slot c, the dispatch mask its
    support; the one-hots are comparisons with an ``arange``."""
    E = moe.cfg.moe.n_experts
    T, d = xt.shape
    flat_e, ranks = pair_ranks(top_i)
    keep = (ranks < C).float()
    onehot_e = (flat_e[:, None] == torch.arange(E, device=xt.device)).float()
    onehot_c = (ranks[:, None] == torch.arange(C, device=xt.device)).float()
    pair = onehot_e[:, :, None] * onehot_c[:, None, :] * keep[:, None, None]
    combine = (pair * top_p.reshape(-1)[:, None, None]).reshape(T, top_i.shape[1], E, C).sum(1)
    dispatch = (combine > 0).to(xt.dtype)                         # (T, E, C)
    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
    h = moe.expert_ffn(expert_in)
    return torch.einsum("tec,ecd->td", combine.to(h.dtype), h)
