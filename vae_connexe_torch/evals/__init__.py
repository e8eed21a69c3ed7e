from vae_connexe_torch.evals.gc_metrics import (
    auroc,
    auto_threshold,
    auto_vote_threshold,
    gc_accuracy,
    gc_metrics,
    precision_recall_f1,
    stability_selection,
    threshold_sweep,
    variable_usage,
    vote_confidence,
)
from vae_connexe_torch.evals.generation import moment_match, prediction_mse

__all__ = ["auroc", "auto_threshold", "auto_vote_threshold", "gc_accuracy",
           "gc_metrics", "moment_match", "precision_recall_f1",
           "prediction_mse", "stability_selection", "threshold_sweep",
           "variable_usage", "vote_confidence"]
