"""Causal-graph recovery metrics (port of ``vae_connexe_tpu/evals/gc_metrics.py``).

Exact-match accuracy, precision/recall/F1, AUROC of the continuous scores
(Mann-Whitney with midranks for ties), a threshold sweep, the unsupervised
log-gap threshold, multi-seed stability selection with its two vote
helpers, and the one-call summary.
"""

from __future__ import annotations

import numpy as np
import torch


def gc_accuracy(gc_true: torch.Tensor, gc_est: torch.Tensor) -> torch.Tensor:
    """Exact-match accuracy over all entries, diagonal included."""
    return ((gc_true > 0) == (gc_est > 0)).float().mean()


def variable_usage(gc_est: torch.Tensor) -> torch.Tensor:
    """Fraction of active edges of the binary GC matrix."""
    return (gc_est > 0).float().mean()


def precision_recall_f1(gc_true: torch.Tensor, gc_est: torch.Tensor):
    """Edge-level precision, recall and F1 of the binarised estimate."""
    est, true = gc_est > 0, gc_true > 0
    tp = (est & true).sum().float()
    fp = (est & ~true).sum().float()
    fn = (~est & true).sum().float()
    zero = torch.zeros((), device=tp.device)
    precision = torch.where(tp + fp > 0, tp / (tp + fp).clamp(min=1), zero)
    recall = torch.where(tp + fn > 0, tp / (tp + fn).clamp(min=1), zero)
    denom = precision + recall
    f1 = torch.where(denom > 0,
                     2 * precision * recall / denom.clamp(min=1e-30), zero)
    return precision, recall, f1


def auroc(gc_true: torch.Tensor, scores: torch.Tensor,
          exclude_diagonal: bool = False) -> torch.Tensor:
    """Area under the ROC curve of continuous scores against binary truth:
    the Mann-Whitney statistic with midranks, rank = (#smaller) +
    (#equal + 1) / 2.  ``exclude_diagonal`` drops the self-edges.  NaN when
    one class is empty."""
    t = (gc_true > 0).reshape(-1)
    s = scores.reshape(-1).float()
    if exclude_diagonal:
        p = gc_true.shape[0]
        keep = ~torch.eye(p, dtype=torch.bool, device=s.device).reshape(-1)
        t, s = t[keep], s[keep]
    smaller = (s[None, :] < s[:, None]).sum(dim=1).float()
    equal = (s[None, :] == s[:, None]).sum(dim=1).float()
    ranks = smaller + (equal + 1) / 2.0
    pos = t.float()
    n_pos = pos.sum()
    n_neg = t.numel() - n_pos
    u = (ranks * pos).sum() - n_pos * (n_pos + 1) / 2.0
    nan = torch.full((), float("nan"), device=s.device)
    return torch.where((n_pos > 0) & (n_neg > 0),
                       u / (n_pos * n_neg).clamp(min=1), nan)


def threshold_sweep(gc_true: torch.Tensor, scores: torch.Tensor,
                    thresholds: torch.Tensor):
    """Accuracy and sparsity of (scores > thr) for each threshold; returns
    (accuracies, sparsities), each shaped like ``thresholds``."""
    thr = thresholds.reshape(-1, *([1] * scores.ndim))
    est = scores[None] > thr
    dims = tuple(range(1, est.ndim))
    acc = (est == (gc_true > 0)[None]).float().mean(dim=dims)
    sparsity = (~est).float().mean(dim=dims)
    return acc.reshape(thresholds.shape), sparsity.reshape(thresholds.shape)


def auto_threshold(scores: torch.Tensor, exclude_diagonal: bool = False,
                   floor: float | None = None,
                   rel_floor: float = 1e-6) -> torch.Tensor:
    """Binarisation threshold from the scores alone: the geometric midpoint
    of the largest gap between consecutive sorted log scores.  Scores below
    the floor (``max(scores) * rel_floor`` unless ``floor`` is given) clamp
    to it before the log; with ``exclude_diagonal`` the diagonal entries
    move onto the minimum so they never widen a gap."""
    s = scores.reshape(-1).float()
    if exclude_diagonal:
        p = scores.shape[0]
        mask = ~torch.eye(p, dtype=torch.bool, device=s.device).reshape(-1)
        s = torch.where(mask, s, s.min())
    if floor is None:
        floor_val = torch.clamp(s.max() * rel_floor, min=1e-30)
    else:
        floor_val = torch.tensor(float(floor), device=s.device)
    log_s = torch.sort(torch.log(torch.maximum(s, floor_val))).values
    i = torch.argmax(log_s[1:] - log_s[:-1])
    return torch.exp((log_s[i] + log_s[i + 1]) / 2.0)


def stability_selection(score_stack: torch.Tensor,
                        min_frac: float | str = 0.5,
                        exclude_diagonal: bool = False):
    """Unsupervised multi-seed edge selection (stability selection).

    Each seed's (p, p) scores of the (S, p, p) stack, e.g. from
    ``parallel.sweep_phase1``, are binarised at their own
    ``auto_threshold``, and the seeds vote: an edge is kept when the
    fraction of seeds selecting it reaches ``min_frac``.  ``"auto"`` puts
    ``min_frac`` at the midpoint of the largest gap in the sorted distinct
    vote values, clamped to [0.5, 0.95] (``auto_vote_threshold``).

    Returns ``(votes (p, p) in [0, 1], selected = votes >= min_frac as
    int32, min_frac)``, the last the resolved vote threshold.
    """
    votes = torch.stack([
        (s > auto_threshold(s, exclude_diagonal=exclude_diagonal)).float()
        for s in score_stack]).mean(dim=0)
    if min_frac == "auto":
        min_frac = auto_vote_threshold(votes, exclude_diagonal)
    return votes, (votes >= min_frac).to(torch.int32), float(min_frac)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def vote_confidence(votes, exclude_diagonal: bool = True,
                    low: float = 0.25) -> float:
    """Discovery confidence from a stability-selection vote matrix: the
    fraction of candidate edges the seeds confidently rule out (vote <=
    ``low``), self-loops excluded by default.  Low (< 0.5) means the
    ensemble agrees on a dense graph it cannot discriminate: treat the
    graph as exploratory (``cli discover`` warns)."""
    vals = _host(votes)
    if exclude_diagonal and vals.ndim == 2 and vals.shape[0] == vals.shape[1]:
        vals = vals[~np.eye(vals.shape[0], dtype=bool)]
    return float((vals <= low).mean())


def auto_vote_threshold(votes, exclude_diagonal: bool = False) -> float:
    """The ``min_frac="auto"`` rule: midpoint of the largest gap in the
    sorted distinct vote values, clamped to [0.5, 0.95]."""
    vals = _host(votes)
    if exclude_diagonal and vals.ndim == 2:
        vals = vals[~np.eye(vals.shape[0], dtype=bool)]
    vals = np.unique(vals)
    if len(vals) > 1:
        i = int(np.argmax(np.diff(vals)))
        thr = float((vals[i] + vals[i + 1]) / 2)
    else:
        thr = 0.5
    return min(max(thr, 0.5), 0.95)


def gc_metrics(gc_true: torch.Tensor, scores: torch.Tensor,
               threshold: float = 0.0) -> dict:
    """Summary dict: accuracy, precision, recall and F1 at ``threshold``,
    AUROC (and, for a square input, off-diagonal AUROC), variable usage of
    the estimate and of the truth.  Values are 0-d tensors."""
    est = (scores > threshold).to(torch.int32)
    precision, recall, f1 = precision_recall_f1(gc_true, est)
    out = {
        "accuracy": gc_accuracy(gc_true, est),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "auroc": auroc(gc_true, scores),
        "variable_usage": variable_usage(est),
        "true_usage": variable_usage(gc_true),
    }
    if scores.ndim == 2 and scores.shape[0] == scores.shape[1]:
        out["auroc_offdiag"] = auroc(gc_true, scores, exclude_diagonal=True)
    return out
