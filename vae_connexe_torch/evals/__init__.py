from vae_connexe_torch.evals.gc_metrics import (
    auroc,
    auto_threshold,
    gc_accuracy,
    gc_metrics,
    precision_recall_f1,
    threshold_sweep,
    variable_usage,
)

__all__ = ["auroc", "auto_threshold", "gc_accuracy", "gc_metrics",
           "precision_recall_f1", "threshold_sweep", "variable_usage"]
