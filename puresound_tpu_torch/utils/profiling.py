"""Timing and tracing (counterpart of puresound_tpu/utils/profiling.py).

- `timed`: a function's first call (kernel builds included: JAX's
  `compile_s`) apart from its steady state, each call ended by a
  synchronisation of the card (CUDA events on the current stream), or the
  host clock alone where nothing ran on a card;
- `profiler_trace`: a `torch.profiler` window writing a Chrome trace, the
  counterpart of JAX's `xla_trace` (an XLA profiler trace).
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch


@dataclass
class Timing:
    compile_s: float        # the first call, kernel builds included
    mean_ms: float
    p50_ms: float
    p95_ms: float
    iters: int

    def rtf(self, audio_seconds: float) -> float:
        """Real-time factor: how many x faster than real time."""
        return audio_seconds / (self.mean_ms / 1000.0)

    def __str__(self):
        return (f"compile {self.compile_s:.1f}s | mean {self.mean_ms:.3f} ms "
                f"p50 {self.p50_ms:.3f} p95 {self.p95_ms:.3f} ({self.iters} iters)")


def _on_card(out) -> bool:
    leaves = torch.utils._pytree.tree_leaves(out)
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)


def timed(fn: Callable, *args, iters: int = 20, warmup: int = 1) -> Timing:
    """Time fn(*args): the first call on the host clock (synchronised) as
    `compile_s`, warmup - 1 more calls, then `iters` calls each timed by a
    pair of CUDA events where fn's output lies on a card, else on the host
    clock."""
    t0 = time.perf_counter()
    out = fn(*args)
    card = _on_card(out)
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        fn(*args)
    sync()
    samples = []
    for _ in range(iters):
        if card:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            samples.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn(*args)
            samples.append((time.perf_counter() - t) * 1000.0)
    samples = np.asarray(samples)
    return Timing(compile_s=compile_s, mean_ms=float(samples.mean()),
                  p50_ms=float(np.percentile(samples, 50)),
                  p95_ms=float(np.percentile(samples, 95)), iters=iters)


@contextlib.contextmanager
def profiler_trace(log_dir: str, name: str = "trace.json") -> Iterator:
    """A `torch.profiler` window (CPU, and CUDA where a card is present)
    whose Chrome trace is written to log_dir/name on exit; yields the
    profiler (its `key_averages()` hold the kernels' device times). The
    counterpart of JAX's `xla_trace`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))
