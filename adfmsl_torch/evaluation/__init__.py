from adfmsl_torch.evaluation.metrics import (
    TDCFCosts,
    accuracy_at_threshold,
    asv_operating_point,
    auc_score,
    average_precision,
    compute_all_metrics,
    compute_eer,
    costs_from_asv_scores,
    min_tdcf,
    parse_asv_scores,
    roc_points,
    simplified_min_dcf,
)
from adfmsl_torch.evaluation.runner import EvalResult, evaluate_to_file, produce_scores
from adfmsl_torch.evaluation.scores import read_score_file, write_score_file

__all__ = [
    "TDCFCosts", "accuracy_at_threshold", "asv_operating_point", "auc_score",
    "average_precision", "compute_all_metrics", "compute_eer",
    "costs_from_asv_scores", "min_tdcf", "parse_asv_scores", "roc_points",
    "simplified_min_dcf",
    "EvalResult", "evaluate_to_file", "produce_scores",
    "read_score_file", "write_score_file",
]
