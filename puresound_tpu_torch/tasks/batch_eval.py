"""Shape-bucketed, padded batch inference for the recipes' evaluation loops
(counterpart of puresound_tpu/tasks/batch_eval.py:38-154).

`--batch_eval N` runs `dev` / `eval` N utterances at a time on the card:

- lengths are quantized up onto a bucket grid (default 1 s of audio) and
  the utterances of one bucket are batched together;
- mixture inputs are zero-padded to the bucket and the outputs sliced back
  to the true length (for a causal model only the last analysis window can
  differ from the batch-1 result);
- enrollment inputs are tile-padded (cyclic repeat), which keeps the
  speaker net's global statistics where zero-padding would shift them;
- every batch is padded to `batch_size` rows (repeating its first row).

JAX jits `fn` once per bucket shape; here `fn` runs eagerly and there is
no compile to bucket for, so `use_jit` is gone. The bucketing, padding
modes and ordering stay as they are. A batch is built on the host, copied
to `device` once, `fn` takes and returns tensors there, and its output
comes back to the host once. Results come back in submission order
whatever the grouping.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["BucketedBatchRunner", "quantize_length"]


def quantize_length(n: int, quantum: int) -> int:
    """Round a length UP to the bucket grid (at least one quantum)."""
    if quantum <= 0:
        raise ValueError(f"quantum must be positive, got {quantum}")
    return max(quantum, int(math.ceil(n / quantum)) * quantum)


def _pad_last(x: np.ndarray, target: int, mode: str) -> np.ndarray:
    """Pad [..., L] to [..., target] with zeros or by cyclic tiling."""
    L = x.shape[-1]
    if L == target:
        return x
    if L > target:
        raise ValueError(f"length {L} exceeds bucket {target}")
    if mode == "zero":
        pad = [(0, 0)] * (x.ndim - 1) + [(0, target - L)]
        return np.pad(x, pad)
    if mode == "tile":
        reps = int(math.ceil(target / L))
        return np.concatenate([x] * reps, axis=-1)[..., :target]
    raise ValueError(f"unknown pad mode {mode!r} (use 'zero' or 'tile')")


class BucketedBatchRunner:
    """Run a tensor function over variable-length items in shape buckets.

    Args:
        fn: callable taking ``arity`` tensors, each ``[B, L_k]`` on
            `device`, returning a tensor ``[B, ...]`` (extra axes allowed,
            e.g. ``[B, M, T]`` from the SIMO separator).
        batch_size: fixed batch; short groups are padded up to it.
        quantum: bucket grid in samples, one int for all inputs or one per
            input (a coarser grid for enrollments keeps their continuously
            varying lengths from giving every utterance its own bucket).
        pad_modes: per-input padding, ``"zero"`` (mixtures) or ``"tile"``
            (enrollments). The arity is this tuple's length.
        out_slice_axis: axis of the output to slice back to input 0's true
            length (``None``: no slicing, e.g. embeddings).
        device: where the batches go (the model's device); the CPU if None.
    """

    def __init__(self, fn: Callable, batch_size: int = 8, quantum=16000,
                 pad_modes: Sequence[str] = ("zero",),
                 out_slice_axis: Optional[int] = -1, device=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.fn = fn
        self.batch_size = int(batch_size)
        self.pad_modes = tuple(pad_modes)
        if isinstance(quantum, (int, float)):
            self.quanta = (int(quantum),) * len(self.pad_modes)
        else:
            self.quanta = tuple(int(q) for q in quantum)
            if len(self.quanta) != len(self.pad_modes):
                raise ValueError(f"quantum has {len(self.quanta)} entries, pad_modes "
                                 f"has {len(self.pad_modes)}")
        self.out_slice_axis = out_slice_axis
        self.device = torch.device("cpu" if device is None else device)
        self.bucket_keys: List[Tuple[int, ...]] = []  # in first-seen order

    def run(self, items: Sequence[Sequence[np.ndarray]]) -> List[np.ndarray]:
        """items: each a tuple of ``arity`` arrays shaped ``[1, L]`` (or
        ``[L]``). Returns one numpy output per item, in submission order."""
        arity = len(self.pad_modes)
        norm: List[Tuple[np.ndarray, ...]] = []
        for it in items:
            arrs = tuple(np.atleast_2d(np.asarray(a)) for a in it)
            if len(arrs) != arity:
                raise ValueError(f"item has {len(arrs)} inputs, pad_modes has {arity}")
            norm.append(arrs)

        groups = {}
        for i, arrs in enumerate(norm):
            key = tuple(quantize_length(a.shape[-1], q) for a, q in zip(arrs, self.quanta))
            groups.setdefault(key, []).append(i)

        results: List[Optional[np.ndarray]] = [None] * len(norm)
        for key, idxs in groups.items():
            if key not in self.bucket_keys:
                self.bucket_keys.append(key)
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                rows = chunk + [chunk[0]] * (self.batch_size - len(chunk))
                inputs = [torch.from_numpy(np.concatenate(
                    [_pad_last(norm[r][k], key[k], self.pad_modes[k]) for r in rows],
                    axis=0)).to(self.device) for k in range(arity)]
                out = self.fn(*inputs).detach().cpu().numpy()
                for j, idx in enumerate(chunk):
                    o = out[j]
                    if self.out_slice_axis is not None:
                        sl = [slice(None)] * o.ndim
                        sl[self.out_slice_axis] = slice(0, norm[idx][0].shape[-1])
                        o = o[tuple(sl)]
                    # a copy: a view would keep the whole padded batch alive
                    results[idx] = np.array(o)
        return results  # type: ignore[return-value]
