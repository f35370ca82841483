"""ThriftLLM core in torch: CRN sampling, xi estimation, SurGreedy planning,
GreedyLLM and the paper's baselines."""
from .belief import (
    aggregate_log_beliefs,
    aggregate_log_beliefs_batch,
    aggregate_predict,
    empty_log_belief,
    log_weight,
    predict_batch,
    predict_from_beliefs,
    tie_break_argmax,
    top2_beliefs,
)
from .cascade import FrugalCascade, blender_all, random_subset, single_best, topk_weighted
from .clustering import auto_eps, dbscan, kmeans
from .correctness import gamma, gamma_marginal, xi_exact, xi_exact_feasible, xi_pair
from .estimation import (
    ClusterStats,
    SuccessProbEstimator,
    hoeffding_interval,
    median_boost_rounds,
    median_boosted_interval,
    wilson_interval,
)
from .mc import (
    GroupedXiEstimator,
    McXiEstimator,
    sample_pool_responses,
    sample_pool_responses_grouped,
    theta_for,
    xi_from_responses,
    xi_from_responses_grouped,
    xi_marginal_grouped,
)
from .selection import (
    ThriftLLM,
    adaptive_invoke,
    gamma_value_batch,
    greedy,
    sur_greedy,
    sur_greedy_many,
)
from .types import Arm, InvocationResult, QueryClass, SelectionResult, clip_probs

__all__ = [
    "Arm", "QueryClass", "SelectionResult", "InvocationResult", "clip_probs",
    "log_weight", "empty_log_belief", "aggregate_log_beliefs", "aggregate_predict",
    "aggregate_log_beliefs_batch", "predict_batch", "predict_from_beliefs",
    "tie_break_argmax", "top2_beliefs",
    "gamma", "gamma_marginal", "xi_exact", "xi_exact_feasible", "xi_pair",
    "McXiEstimator", "GroupedXiEstimator", "sample_pool_responses",
    "sample_pool_responses_grouped", "theta_for",
    "xi_from_responses", "xi_from_responses_grouped", "xi_marginal_grouped",
    "greedy", "gamma_value_batch", "sur_greedy", "sur_greedy_many",
    "adaptive_invoke", "ThriftLLM",
    "SuccessProbEstimator", "ClusterStats", "hoeffding_interval", "wilson_interval",
    "median_boosted_interval", "median_boost_rounds",
    "kmeans", "dbscan", "auto_eps",
    "FrugalCascade", "blender_all", "topk_weighted", "single_best", "random_subset",
]
