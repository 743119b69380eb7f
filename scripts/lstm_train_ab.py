"""Times the training LSTM kernels and the flagship's training step of one
checkout of the port on the card, as one JSON line.

The checkout given by `--root` supplies `puresound_tpu_torch` (its kernels
are built from its own `csrc/`); the measuring code is this checkout's
`chip_smoke.py`. Run it once per tree, in turns (parent, change, change,
parent), to compare two trees on one card:

    python scripts/lstm_train_ab.py --root <checkout> [--train] [--cases SegLSTM,...]
        [--unfused SegLSTM,...]

It prints, at each of `chip_smoke.LSTM_CASES` named in `--cases`, the
`lstm_scan_train_fp` forward and backward CUDA-event medians (f32 and bf16,
against the plain version at phase 2b's bars), the device time of each
kernel of one launch from a profiler window (also for the hoisted
`lstm_scan_train_tm`), at the phase 2j cases named in `--unfused` the
hoisted and time-major scans as phase 2j times them, and with `--train`
phase 6's
B=64 x 2 s step (f32 and bf16: step p50, peak memory, the LSTM kernels'
share of device time).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--cases", default="SegLSTM")
    ap.add_argument("--unfused", default="",
                    help="phase 2j cases (chip_smoke.UNFUSED_CASES names) to time too")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("lstm_train_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(a.root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import tcn_train_kernel as tk

    if not lk.__file__.startswith(os.path.abspath(a.root)):
        raise RuntimeError(f"imported {lk.__file__}, not from {a.root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    out = {"root": a.root, "card": card, "cases": {}}
    gen = torch.Generator().manual_seed(cs.SEED)
    for name, B, T, C, H, reverse, reps in cs.LSTM_CASES:
        if name not in a.cases.split(","):
            continue
        r = cs.lstm_kernel_case(lk, name, B, T, C, H, reverse, gen, dev, reps)
        for key, hoisted in (("split", False), ("split_hoisted", True)):
            r[key] = {lb: cs.lstm_split(lk, B, T, C, H, dt, dev, hoisted=hoisted)
                      for lb, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        out["cases"][name] = r
    ugen = torch.Generator().manual_seed(cs.SEED + 2)
    for name, B, T, C, H, reverse, reps in cs.UNFUSED_CASES:
        if name in a.unfused.split(","):
            out["cases"]["2j " + name] = cs.lstm_unfused_case(lk, name, B, T, C, H, reverse,
                                                              ugen, dev, reps)
    if a.train:
        out["train"] = {lb: cs.full_width_training(lk, tk, dev, card, dt)
                        for lb, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
