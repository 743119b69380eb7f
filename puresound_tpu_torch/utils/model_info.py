"""Model introspection: parameter counts and the empirical lookahead /
receptive-field probe by inf injection (counterpart of
puresound_tpu/utils/model_info.py, `count_params` `:12` and
`probe_lookahead_receptive` `:17`).

The probe feeds a signal whose tail (or head) is inf and reads where NaNs
appear in the output. It runs on the device it is given: on the card the
inference goes through the kernels, on the CPU through their plain
versions. NaN comes from upstream of the kernels' gates (LayerNorm of an inf
row is inf - inf); a sigmoid or tanh of +-inf is finite on both routes.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn


def count_params(module: nn.Module) -> int:
    """Total number of scalar parameters of a module."""
    return sum(p.numel() for p in module.parameters())


def probe_lookahead_receptive(
    inference_fn: Callable[[torch.Tensor], torch.Tensor],
    length: int = 160000,
    inject_at: Optional[int] = None,
    seed: int = 0,
    *,
    device,
) -> Tuple[Optional[int], Optional[int]]:
    """Measure (lookahead, receptive_field) in samples by inf injection,
    `inference_fn` called on a [1, length] float32 tensor on `device`
    (required: "cuda" runs the model's kernels, "cpu" their plain versions).

    lookahead: inject inf at t >= inject_at; the first NaN in the output
    appears `lookahead` samples BEFORE inject_at. None means infinite
    (non-causal) lookahead.
    receptive field: inject inf at t < inject_at; the last NaN appears
    `receptive` samples after the inf region ends. None means infinite.
    """
    if inject_at is None:
        inject_at = length // 2
    rng = np.random.default_rng(seed)
    x = rng.random((1, length)).astype(np.float32)

    def run(a: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            y = inference_fn(torch.from_numpy(a).to(device))
        return y.detach().float().cpu().numpy()

    x_look = x.copy()
    x_look[:, inject_at:] = np.inf
    y = run(x_look)
    nan_idx = np.where(np.isnan(y))[-1]
    if len(nan_idx) == 0 or nan_idx[0] == 0:
        lookahead = None  # infinite
    else:
        lookahead = int(inject_at - nan_idx[0])

    x_rf = x.copy()
    x_rf[:, :inject_at] = np.inf
    y = run(x_rf)
    nan_idx = np.where(np.isnan(y))[-1]
    if len(nan_idx) == 0:
        receptive = 0
    else:
        receptive = int(nan_idx[-1] - (inject_at - 1))
        if receptive >= y.shape[-1] - inject_at:
            receptive = None  # infinite
    return lookahead, receptive
