"""Unified control-plane API: policy registry, declarative specs, gateway.

The three pieces (see docs/architecture.md, docs/policies.md):

* :mod:`repro_torch.api.policy` — the :class:`SchedulingPolicy` protocol, the
  :class:`Plan` it produces, and the ``@register_policy`` registry.
* :mod:`repro_torch.api.policies` — RoBatch (heap + vectorized), the five adapted
  baselines and both ablations, ported onto the protocol.  Importing
  :mod:`repro_torch.api` registers all of them.
* :mod:`repro_torch.api.specs` / :mod:`repro_torch.api.gateway` — ``RunSpec`` declarative
  experiments and the ``Gateway`` facade running them offline or online.
"""

from repro_torch.api import policies as _policies  # noqa: F401 — registers built-ins
from repro_torch.api.gateway import Gateway
from repro_torch.api.policy import (
    Plan,
    SchedulingPolicy,
    UnknownPolicyError,
    amortized_group_costs,
    fit_artifacts,
    get_policy,
    list_policies,
    register_policy,
)
from repro_torch.api.specs import PolicySpec, PoolSpec, RunSpec

__all__ = [
    "Plan", "SchedulingPolicy", "UnknownPolicyError", "amortized_group_costs",
    "fit_artifacts", "get_policy", "list_policies", "register_policy",
    "PolicySpec", "PoolSpec", "RunSpec", "Gateway",
]
