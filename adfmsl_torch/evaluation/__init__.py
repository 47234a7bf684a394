from adfmsl_torch.evaluation.bootstrap import (
    BootstrapResult,
    bootstrap_metric,
    paired_bootstrap_test,
)
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
from adfmsl_torch.evaluation.runner import (EmbeddingResult, EvalResult,
                                            evaluate_to_file, produce_embeddings,
                                            produce_scores)
from adfmsl_torch.evaluation.scores import (
    join_scores_with_labels,
    read_score_file,
    write_score_file,
)

__all__ = [
    "BootstrapResult", "bootstrap_metric", "paired_bootstrap_test",
    "TDCFCosts", "accuracy_at_threshold", "asv_operating_point", "auc_score",
    "average_precision", "compute_all_metrics", "compute_eer",
    "costs_from_asv_scores", "min_tdcf", "parse_asv_scores", "roc_points",
    "simplified_min_dcf",
    "EmbeddingResult", "EvalResult", "evaluate_to_file",
    "produce_embeddings", "produce_scores",
    "join_scores_with_labels", "read_score_file", "write_score_file",
]
