"""TimeGAN-style utilities the reference carries (a numpy copy of
``vae_connexe_tpu/data/timegan_utils.py``; with the same ``seed`` each
gives the JAX package's result).

The reference defines them in three scripts and calls them from none, but
a user of the reference may import them: train/test division of original
and generated sequence sets, sequence-length extraction, and a random
minibatch generator.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def train_test_divide(ori_data: Sequence, generated_data: Sequence,
                      ori_time: Sequence, generated_time: Sequence,
                      train_rate: float = 0.8, seed: int | None = None):
    """Split original and generated data (and their time vectors) into
    train/test by independent random permutations."""
    rng = np.random.default_rng(seed)

    def split(data, times):
        n = len(data)
        idx = rng.permutation(n)
        cut = int(n * train_rate)
        tr, te = idx[:cut], idx[cut:]
        return ([data[i] for i in tr], [data[i] for i in te],
                [times[i] for i in tr], [times[i] for i in te])

    train_x, test_x, train_t, test_t = split(ori_data, ori_time)
    train_x_hat, test_x_hat, train_t_hat, test_t_hat = split(
        generated_data, generated_time)
    return (train_x, train_x_hat, test_x, test_x_hat,
            train_t, train_t_hat, test_t, test_t_hat)


def extract_time(data: Sequence) -> Tuple[List[int], int]:
    """Per-sequence lengths and the maximum length."""
    times = [len(np.asarray(seq)[:, 0]) for seq in data]
    return times, max(times) if times else 0


def batch_generator(data: Sequence, time: Sequence, batch_size: int,
                    seed: int | None = None):
    """One random minibatch of (sequences, lengths)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(data))[:batch_size]
    return [data[i] for i in idx], [time[i] for i in idx]
