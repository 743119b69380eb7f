"""Times the serving LSTM scan of one checkout of the port on the card, as one
JSON line: `lstm_scan` at phase 2d's shapes and the NS engine steps whose
fused routes run it.

The checkout given by `--root` supplies `puresound_tpu_torch` (its kernel is
built from its own `csrc/`); the measuring code is this checkout's
`chip_smoke.py`. Run the script once per tree, in turns (parent, change,
change, parent), to compare two trees on one card:

    git archive HEAD^ | (mkdir -p build/parent && tar -x -C build/parent)
    for r in build/parent . . build/parent; do python3 scripts/lstm_scan_ab.py --root $r; done

For each of phase 2d's cases (`chip_smoke.LSCAN_CASES`), f32 then bf16 xp /
weights (the bf16 run's dots and state as the case says) it prints the
CUDA-event median of one call (`ms`, as phase 2d times it: the wrapper's
host work falls inside the events), the mean of back-to-back calls between
two events (`b2b_ms`: the card stays busy, the kernel's device time), the
plain version's distance (max|d| /
max|ref| of each output, the bf16 outputs' SNR), whether two calls are
bit-equal, the launches by route where the tree counts them, and a digest of
the outputs (equal digests: equal outputs, bit for bit). Unless
`--skip-serving`, the bf16 engine steps of DPCRN at 2,048 slots on `fused`
(6 scans a tick) and of DPARN at 256 and 1,024 slots on `fused` +
`attn_kernel` (2 scans a tick), phase 4j's and 4c's, host clock around a
synced step.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys

import torch

from ab_common import HERE, back_to_back_ms, load_chip_smoke, ns_engine_step


def scan_case(cs, lsk, name, B, T, H, reverse, carries, bf16_dot, bf16_state, reps, dev):
    """One phase-2d case on this tree's kernel, f32 and bf16."""
    gen = torch.Generator().manual_seed(cs.SEED + 31)
    xp = torch.randn(B, T, 4 * H, generator=gen)
    h0 = 0.3 * torch.randn(B, H, generator=gen) if carries else torch.zeros(B, H)
    c0 = 0.3 * torch.randn(B, H, generator=gen) if carries else torch.zeros(B, H)
    w = (torch.rand(H, 4 * H, generator=gen) * 2 - 1) / math.sqrt(H)
    by_route = getattr(lsk, "LAUNCHES_BY_ROUTE", None)
    out = {}
    for label, dt, dot, sdt in (("f32", torch.float32, torch.float32, torch.float32),
                                ("bf16", torch.bfloat16, bf16_dot, bf16_state)):
        args = [xp.to(dev, dt), h0.to(dev, sdt), c0.to(dev, sdt), w.to(dev, dt)]
        if by_route is not None:
            by_route.clear()
        with torch.no_grad():
            got = lsk._launch(*args, reverse, dot)
            again = lsk._launch(*args, reverse, dot)
            want = lsk.lstm_scan_ref(*args, reverse, dot)
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in got:
            digest.update(t.float().cpu().numpy().tobytes())
        out[label] = {
            "ms": cs.cuda_ms(lambda: lsk._launch(*args, reverse, dot), reps),
            "b2b_ms": back_to_back_ms(lambda: lsk._launch(*args, reverse, dot), reps),
            "rel": [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                    for g, r in zip(got, want)],
            "snr_db": [cs.snr_db(g, r) for g, r in zip(got, want)],
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, again)),
            "routes": None if by_route is None else dict(by_route),
            "digest": digest.hexdigest()[:16]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--skip-serving", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("lstm_scan_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(a.root))
    cs = load_chip_smoke()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import lstm_scan_kernel as lsk

    if not lsk.__file__.startswith(os.path.abspath(a.root)):
        raise RuntimeError(f"imported {lsk.__file__}, not from {a.root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(["lstm_scan", "dparn_attention"])   # in parallel
    out = {"root": a.root, "card": cs.card_line(),
           "sass": cs.hmma_counts(_build.BUILD_DIR, "lstm_scan")}
    out["cases"] = {c[0]: scan_case(cs, lsk, *c, dev) for c in cs.LSCAN_CASES}
    if not a.skip_serving:
        out["serving"] = {f"4j DPCRN fused {cs.NS_SLOTS[-1]}": ns_engine_step(
            cs, "ns_dpcrn_v0_causal", {"fused": True}, {}, cs.NS_SLOTS[-1], dev)}
        for n in cs.DPARN_SLOTS:
            out["serving"][f"4c DPARN fused+attn_kernel {n}"] = ns_engine_step(
                cs, "ns_dparn_v0_causal", {"fused": True, "attn_kernel": True}, {}, n, dev)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
