"""The paper's primary contribution: the Route-with-Batching problem and the
Robatch two-stage solution (modeling + greedy Pareto routing)."""

from repro_torch.core.coreset import select_coreset
from repro_torch.core.pareto import (
    CandidateSpace,
    build_candidate_space,
    build_frontiers,
    pareto_frontier,
)
from repro_torch.core.problem import Assignment, CostModel, State, group_into_batches
from repro_torch.core.robatch import (
    ExecutionOutcome,
    Robatch,
    collect_router_labels,
    execute,
    execute_plan,
)
from repro_torch.core.router import KNNRouter, MLPRouter, train_mlp_router
from repro_torch.core.scaling import (
    ModelCalibration,
    ProfileCache,
    b_max_from_epsilon,
    batch_grid,
    calibrate_model,
    fit_scaling,
    ternary_search_rcu,
)
from repro_torch.core.scheduler import (
    ScheduleResult,
    brute_force_schedule,
    greedy_schedule,
    greedy_schedule_window,
    restrict_space,
)
