"""PVAD output binarization: asteroid-style stability smoothing or a 200 ms
moving-average threshold.

A copy of the JAX recipe's egs/tse/local/binarize.py (numpy), which
re-expresses PureSound's asteroid-derived egs/tse/local/binarize.py.
"""
from __future__ import annotations

from itertools import groupby
from typing import List

import numpy as np


class Binarize:
    """Map a [N, L] (or [N, 1, L]) sequence of probabilities to binary
    activity with jump suppression."""

    def __init__(self, threshold: float = 0.5, stability: float = 0.1,
                 sample_rate: int = 8000, mode: str = "asteroid"):
        self.threshold = threshold
        self.stability = stability
        self.sample_rate = sample_rate
        self.mode = mode.lower()
        if self.mode == "moving_average":
            self.kernel = int(0.2 * sample_rate)

    def __call__(self, x) -> np.ndarray:
        x = np.asarray(x)
        if x.ndim == 3:
            x = x[:, 0, :]
        if self.mode == "asteroid":
            active = (x > self.threshold).astype(np.int64)
            pairs = count_same_pair(active.tolist())
            return transform_to_binary_sequence(pairs, self.stability,
                                                self.sample_rate)
        elif self.mode == "moving_average":
            pad = np.concatenate(
                [np.zeros((x.shape[0], self.kernel - 1), x.dtype), x], axis=-1)
            kernel = np.ones(self.kernel) / self.kernel
            sm = np.stack([np.convolve(row, kernel, mode="valid") for row in pad])
            return sm > self.threshold
        raise NotImplementedError(self.mode)


def count_same_pair(nums: List) -> List:
    """[[0,0,1,0]] -> [[[0,2],[1,1],[0,1]]] (value, run length)."""
    return [[[i, sum(1 for _ in g)] for i, g in groupby(num)] for num in nums]


def transform_to_binary_sequence(pairs: List, stability: float,
                                 sample_rate: int) -> np.ndarray:
    min_run = int(stability * sample_rate)
    batch = []
    for pair in pairs:
        if len(pair) == 1:
            value, n = pair[0]
            batch.append(np.full(n, float(bool(value))))
            continue
        active: List[np.ndarray] = []
        i = 0
        while i < len(pair):
            value, n = pair[i]
            if n < min_run:
                actived = not_actived = 0
                while i < len(pair) and pair[i][1] < min_run:
                    v, m = pair[i]
                    if v:
                        actived += m
                    else:
                        not_actived += m
                    i += 1
                total = actived + not_actived
                if total < min_run and active:
                    active.append(np.full(total, float(active[-1][0] == 1)))
                elif total < min_run:
                    active.append(np.zeros(total))
                else:
                    active.append(np.full(total, float(actived > not_actived)))
            else:
                active.append(np.full(n, float(bool(value))))
                i += 1
        batch.append(np.concatenate(active))
    return np.stack(batch)[:, None, :]
