"""Times the training TCN block (`tcn_block_train`) and the flagship's
training step of one checkout of the port on the card, as one JSON line.

The checkout given by `--root` supplies `puresound_tpu_torch` (its kernels
are built from its own `csrc/`); the measuring code is this checkout's
`chip_smoke.py`. Run it once per tree, in turns (parent, change, change,
parent), to compare two trees on one card:

    python scripts/tcn_train_ab.py --root <checkout> [--train] [--cases "speaker d=1,..."]

At each of phase 2c's speaker / recipe cases (`chip_smoke.TCN_CASES`, by
name in `--cases`) it prints the forward and backward CUDA-event medians in
float32 and bfloat16, the stock module's forward + backward
(`chip_smoke.stock_tcn_ms`: cuDNN convolutions, the norms under autograd)
and, at the speaker shape, the device time of each kernel of one forward
and one backward launch (`chip_smoke.tcn_split`); with `--train` phase 6's
B=64 x 2 s step (f32 and bf16: step p50, peak memory, the LSTM and TCN
kernels' shares of device time). Results are not checked here: phase 2c
holds the kernels against their plain versions.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = "speaker d=1,speaker d=16,recipe d=1,recipe d=16"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--cases", default=CASES)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("tcn_train_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(a.root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import tcn_train_kernel as tk

    if not tk.__file__.startswith(os.path.abspath(a.root)):
        raise RuntimeError(f"imported {tk.__file__}, not from {a.root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"root": a.root, "card": cs.card_line(), "cases": {}}
    wanted = a.cases.split(",")
    for name, B, C, Ch, T, dilation, _ in cs.TCN_CASES:
        if name not in wanted:
            continue
        gen = torch.Generator().manual_seed(cs.SEED)
        params = cs.tcn_params(C, Ch, 3, gen)
        x = torch.randn(B, C, T, generator=gen)
        dy = torch.randn(B, C, T, generator=gen)
        r = {"shape": f"B={B} C={C} Ch={Ch} T={T} k=3 d={dilation}"}
        for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            ps = [p.to(dev, dt) for p in params]
            xd, dyd = x.to(dev, dt), dy.to(dev, dt)
            r[f"{label}_fwd_ms"] = cs.cuda_ms(lambda: tk._launch_fwd(xd, ps, dilation), a.reps)
            r[f"{label}_bwd_ms"] = cs.cuda_ms(lambda: tk._launch_bwd(xd, dyd, ps, dilation),
                                              a.reps)
            r[f"{label}_stock_ms"] = cs.stock_tcn_ms(ps, xd, dyd, dilation, a.reps)
            if name == "speaker d=1":
                r[f"{label}_split"] = cs.tcn_split(tk, B, C, Ch, T, dilation, dt, dev)
            del ps, xd, dyd
        out["cases"][name] = r
    if a.train:
        out["train"] = {lb: cs.full_width_training(lk, tk, dev, out["card"], dt)
                        for lb, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
