"""Figures, drawn offline from saved arrays (the port's own copy of
``vae_connexe_tpu/evals/viz.py``; numpy and matplotlib, Agg backend;
scikit-learn imported inside the PCA and t-SNE functions).

- GC heatmap pairs with the disagreements outlined in red, and the
  truth-less discovery heatmap that ``cli discover --out-dir`` writes;
- PCA / t-SNE scatter of per-window feature means, real against synthetic;
- trajectory overlays;
- W_in weight heatmaps and row-norm bar charts.

Every function takes arrays and saves to a path; nothing here touches a
device.  ``FigureWriter`` draws a run's figures where matplotlib (and, for
PCA and t-SNE, scikit-learn) can be imported, and otherwise names the
figures it did not write on one stderr line: the card's machine has
neither, and a run there still writes every array and metric.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys
from typing import Optional

import numpy as np


# The modules each figure needs beyond numpy.
_NEEDS = {"pca_comparison": ("matplotlib", "sklearn"),
          "tsne_comparison": ("matplotlib", "sklearn")}


class FigureWriter:
    """``draw(fn, *arrays, path=..., **kw)`` calls a figure function of this
    module when the modules it needs can be imported, and otherwise
    records the figure as not written; ``report()`` prints the one stderr
    line that names them and the missing modules.  Nothing is caught: the
    check is ``importlib.util.find_spec`` before the call."""

    def __init__(self):
        self.skipped: list[str] = []
        self.missing: set[str] = set()

    def draw(self, fn, *args, path: str, **kw) -> bool:
        absent = [m for m in _NEEDS.get(fn.__name__, ("matplotlib",))
                  if importlib.util.find_spec(m) is None]
        if absent:
            self.skipped.append(pathlib.Path(path).name)
            self.missing.update(absent)
            return False
        fn(*args, path=path, **kw)
        return True

    def report(self) -> None:
        if self.skipped:
            print(f"figures not written ({', '.join(sorted(self.missing))} "
                  f"cannot be imported): {', '.join(self.skipped)}",
                  file=sys.stderr)


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def gc_heatmaps(gc_true: np.ndarray, gc_est: np.ndarray, path: str,
                titles=("Causal-effect matrix", "Estimated")) -> None:
    """Side-by-side truth/estimate heatmaps; disagreements outlined in red."""
    plt = _mpl()
    gc_true = np.asarray(gc_true)
    gc_est = np.asarray(gc_est)
    fig, axarr = plt.subplots(1, 2, figsize=(10, 5))
    for ax, mat, title in zip(axarr, (gc_true, gc_est), titles):
        ax.imshow(mat, cmap="Blues", vmin=0, vmax=1)
        ax.set_title(title)
        ax.set_ylabel("Effect series")
        ax.set_xlabel("Causal series")
        ax.set_xticks([])
        ax.set_yticks([])
    n = len(gc_est)
    for i in range(n):
        for j in range(n):
            if gc_true[i, j] != gc_est[i, j]:
                axarr[1].add_patch(plt.Rectangle(
                    (j - 0.5, i - 0.5), 1, 1, facecolor="none",
                    edgecolor="red", linewidth=1))
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def discovery_heatmap(scores: np.ndarray, selected: np.ndarray, path: str,
                      names: Optional[list] = None,
                      threshold: Optional[float] = None) -> None:
    """Score + selected-graph heatmap pair for truth-less discovery runs.

    The reference's heatmap ritual needs a ground-truth matrix to compare
    against (``author_CRVAE.py:763-784``); on user data there is none, so
    this renders the continuous edge strengths next to the binarized
    selection, selected edges outlined, with variable names on the axes
    when the input file carried a header.
    """
    plt = _mpl()
    scores = np.asarray(scores)
    selected = np.asarray(selected)
    n = len(scores)
    fig, axarr = plt.subplots(1, 2, figsize=(11, 5))
    im = axarr[0].imshow(scores, cmap="viridis")
    fig.colorbar(im, ax=axarr[0], fraction=0.046)
    title = "Edge strengths"
    if threshold is not None:
        title += f" (threshold {threshold:.3g})"
    axarr[0].set_title(title)
    axarr[1].imshow(selected, cmap="Blues", vmin=0, vmax=1)
    axarr[1].set_title(f"Selected graph ({int(selected.sum())} edges)")
    for ax in axarr:
        ax.set_ylabel("Effect series")
        ax.set_xlabel("Causal series")
        if names is not None and n <= 32:
            ax.set_xticks(range(n), names, rotation=90, fontsize=7)
            ax.set_yticks(range(n), names, fontsize=7)
        else:
            ax.set_xticks([])
            ax.set_yticks([])
    for i in range(n):
        for j in range(n):
            if selected[i, j]:
                axarr[1].add_patch(plt.Rectangle(
                    (j - 0.5, i - 0.5), 1, 1, facecolor="none",
                    edgecolor="black", linewidth=0.6))
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def _window_means(data: np.ndarray) -> np.ndarray:
    """(N, T, D) -> (N, T) per-window feature means, the reference's prep."""
    return np.mean(np.asarray(data), axis=2)


def pca_comparison(ori: np.ndarray, syn: np.ndarray, path: str,
                   max_samples: int = 1000, seed: int = 0) -> None:
    """PCA scatter: original (red) vs synthetic (blue) window-mean curves."""
    from sklearn.decomposition import PCA

    plt = _mpl()
    rng = np.random.default_rng(seed)
    n = min(max_samples, len(ori), len(syn))
    idx = rng.permutation(min(len(ori), len(syn)))[:n]
    prep_o = _window_means(ori)[idx]
    prep_s = _window_means(syn)[idx]
    pca = PCA(n_components=2).fit(prep_o)
    po, ps = pca.transform(prep_o), pca.transform(prep_s)
    fig, ax = plt.subplots(1)
    ax.scatter(po[:, 0], po[:, 1], c="red", alpha=0.2, label="original")
    ax.scatter(ps[:, 0], ps[:, 1], c="blue", alpha=0.2, label="synthetic")
    ax.legend()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def tsne_comparison(ori: np.ndarray, syn: np.ndarray, path: str,
                    max_samples: int = 500, seed: int = 0,
                    perplexity: float = 40.0) -> None:
    """Joint t-SNE of original/synthetic window means."""
    from sklearn.manifold import TSNE

    plt = _mpl()
    rng = np.random.default_rng(seed)
    n = min(max_samples, len(ori), len(syn))
    idx = rng.permutation(min(len(ori), len(syn)))[:n]
    both = np.concatenate([_window_means(ori)[idx], _window_means(syn)[idx]], 0)
    emb = TSNE(n_components=2, perplexity=min(perplexity, n - 1),
               init="pca", random_state=seed).fit_transform(both)
    fig, ax = plt.subplots(1)
    ax.scatter(emb[:n, 0], emb[:n, 1], c="red", alpha=0.2, label="original")
    ax.scatter(emb[n:, 0], emb[n:, 1], c="blue", alpha=0.2, label="synthetic")
    ax.legend()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def trajectory_overlay(ori: np.ndarray, syn: np.ndarray, path: str,
                       sample: int = 0, dim: int = 1) -> None:
    """Overlay one original and one generated trajectory for one variable."""
    plt = _mpl()
    fig, ax = plt.subplots(1)
    ax.plot(np.asarray(ori)[sample, :, dim], label="original")
    ax.plot(np.asarray(syn)[sample, :, dim], label="synthetic")
    ax.legend()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def w_in_heatmaps(w_in: np.ndarray, path: str) -> None:
    """Per-head W_in weight patterns, (P, D, H)."""
    plt = _mpl()
    w_in = np.asarray(w_in)
    p = w_in.shape[0]
    cols = min(3, p)
    rows = -(-p // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 4 * rows),
                             squeeze=False)
    for i in range(p):
        ax = axes[i // cols][i % cols]
        im = ax.imshow(w_in[i].T, cmap="RdBu_r", aspect="auto")
        ax.set_title(f"W_in[{i}]")
        ax.set_xlabel("Input dim")
        ax.set_ylabel("Hidden")
        fig.colorbar(im, ax=ax)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def w_in_row_norms(w_in: np.ndarray, path: str, threshold: float = 1e-6) -> None:
    """Per-head row-norm bars — the sparsity picture (``CRVAE.py:421-435``)."""
    plt = _mpl()
    w_in = np.asarray(w_in)
    p = w_in.shape[0]
    cols = min(3, p)
    rows = -(-p // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3 * rows),
                             squeeze=False)
    for i in range(p):
        ax = axes[i // cols][i % cols]
        norms = np.linalg.norm(w_in[i], axis=1)
        ax.bar(range(len(norms)), norms)
        ax.axhline(y=threshold, color="r", linestyle="--", alpha=0.5)
        ax.set_title(f"W_in[{i}] row norms")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
