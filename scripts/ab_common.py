"""What the A/B scripts (`dual_path_ab.py`, `dparn_center_ab.py`,
`skim_stream_ab.py`, `lstm_scan_ab.py`) share: this checkout's
`chip_smoke.py` loaded as a module (their measuring code, whichever tree's
port they measure), the bf16 NS engine step and back-to-back timing with
CUDA events."""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """This checkout's chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def ns_engine_step(cs, zoo_name, mode, options, n_slots, dev) -> dict:
    """An NS model's bf16 engine step alone at n_slots on the route `mode`
    with `options` (phases 4b / 4c / 4d / 4h / 4j's reading): p50 and min ms
    over 10 steps, host clock around a synced step."""
    from puresound_tpu_torch.streaming.file_eval import build_engine
    from puresound_tpu_torch.streaming.halfprec import to_half
    from puresound_tpu_torch.zoo.ns import init_model

    gen = torch.Generator().manual_seed(cs.SEED)
    model = init_model(zoo_name, device=dev, generator=gen)
    to_half(model)
    engine = build_engine(model).eval()
    rng = np.random.default_rng(cs.SEED)
    x = torch.from_numpy((0.1 * rng.standard_normal((n_slots, 256))).astype(np.float32))
    ms = cs.engine_step_ms(engine, mode, options, x.to(dev, torch.bfloat16), n_slots)
    return {"p50": float(np.median(ms)), "min": min(ms)}


def back_to_back_ms(fn, reps: int) -> float:
    """Mean ms of `reps` calls enqueued back to back between two CUDA events,
    after 3 untimed ones: the card stays busy, so this is the device time."""
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
