from adfmsl_torch.analysis.compare import ComparisonResult, compare_models, detect_architecture
from adfmsl_torch.analysis.figures import (
    plot_det,
    plot_embedding_geometry,
    plot_fmsl_trend,
    plot_model_comparison,
    plot_performance_landscape,
    plot_roc,
    plot_score_distributions,
    plot_training_curves,
)
from adfmsl_torch.analysis.processor import (
    ProcessedScores,
    ScoreFileProcessor,
    model_name_from_filename,
)
from adfmsl_torch.analysis.summary import check_compatibility, count_params, model_summary
from adfmsl_torch.analysis.report import (
    REFERENCE_RESULTS,
    check_against_reference,
    comparison_markdown,
    results_csv,
    results_latex,
)

__all__ = [
    "check_compatibility", "count_params", "model_summary",
    "ComparisonResult", "compare_models", "detect_architecture",
    "plot_det", "plot_embedding_geometry", "plot_fmsl_trend",
    "plot_model_comparison",
    "plot_performance_landscape", "plot_roc", "plot_score_distributions",
    "plot_training_curves",
    "ProcessedScores", "ScoreFileProcessor", "model_name_from_filename",
    "REFERENCE_RESULTS", "check_against_reference", "comparison_markdown",
    "results_csv", "results_latex",
]
