"""Times `fused_skim_frames` and the TSE engine step of one checkout of the
port on the card, as one JSON line.

The checkout given by `--root` supplies `puresound_tpu_torch` (its kernels
are built from its own `csrc/`); the measuring code is this checkout's
`chip_smoke.py`. A tree from before the kernel's launch plan has only the
CUDA-core route and counts no launches by route: its two calls are
reported as CUDA-core launches. Run the script once per tree, in turns
(parent, change, change, parent), to compare two trees on one card:

    python scripts/skim_stream_ab.py --root <checkout> [--skip-serving]

It prints the SASS tensor-core instructions of `skim_stream` (HMMA / IMMA by
kernel), then for B = 256 and 1,024 streams (n=4, C=128, H=256, F=15, every
block FiLM, or every block a Gate at Hg=128) and each of no option,
int8_hh and int8_full, in float32 and bfloat16: the CUDA-event median of
one call, its device ms by kernel from a profiler window, the launches by
route, two calls bit-equal, and the call against its plain version (f32:
max|d| / max|ref|; bf16: SNR). Unless
`--skip-serving`, the bf16 engine step (`StreamingTSE.step(fused=True)`,
host clock around a synced step, the median of 25 after 3 warm-up) of the
flagship at 256 and 1,024 slots, with int8_hh / int8_full at 1,024, and of
the Gate model at 256 and 1,024.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ab_common import load_chip_smoke
SLOTS = (256, 1024)
VARIANTS = ("", "int8_hh", "int8_full")


@torch.no_grad()
def kernel_case(cs, ops, B, fusion, variant, dev):
    """One call of the flagship's shape at B streams, f32 then bf16: the
    CUDA-event median and the device ms by kernel, the launches by route,
    two calls bit-equal, the plain version's distance."""
    from puresound_tpu_torch.nnet.skim import SkiM

    n, C, H, _, F = cs.QSKIM_SHAPE
    gen = torch.Generator().manual_seed(cs.SEED)
    masker = SkiM(input_size=C, hidden_size=H, output_size=C, n_blocks=n, seg_size=F * 10,
                  causal=True, embed_dim=192, embed_norm=True,
                  embed_fusion="Gate" if fusion == "gate" else "FiLM",
                  block_with_embed=(1,) * n, device=dev, generator=gen).eval()
    kw = cs.opts_of(variant) if variant else {}
    w32 = masker._fused_weights(**kw)
    embed = torch.randn(B, 192, generator=gen).to(dev)
    se, be, ge = masker._embed_terms(masker._norm_embed(embed), B, torch.float32, w32)
    x = torch.randn(B, F, C, generator=gen).to(dev)
    h0 = (0.3 * torch.randn(n, B, H, generator=gen)).to(dev)
    c0 = (0.3 * torch.randn(n, B, H, generator=gen)).to(dev)
    modes = (fusion,) * n
    out = {}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ws = ops.SkimWeights(w if w.dtype == torch.int8 else w.to(dt) for w in w32)
        args = (x.to(dt), se.to(dt), be.to(dt), ge.to(dt), h0.to(dt), c0.to(dt), ws, modes)
        routes = getattr(ops, "LAUNCHES_BY_ROUTE", None)
        if routes is not None:
            routes.clear()
        got = ops.fused_skim_frames(*args, dot_dtype=dt, **kw)
        again = ops.fused_skim_frames(*args, dot_dtype=dt, **kw)
        want = ops.fused_skim_frames_ref(*args, dot_dtype=dt, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"B={B} {fusion} {variant} {label}: two calls differ")
        r = {"route": dict(routes) if routes is not None else {"cuda": 2}}
        if dt == torch.float32:
            r["rel_err"] = max((g - w).abs().max().item() / w.abs().max().item()
                               for g, w in zip(got, want))
        else:
            r["snr_db"] = min(cs.snr_db(g, w) for g, w in zip(got, want))
        call = lambda: ops.fused_skim_frames(*args, dot_dtype=dt, **kw)
        r["ms"] = cs.cuda_ms(call, 10)
        r["device_ms"] = cs.center_split(call, passes=cs.SKIM_KERNELS)
        out[label] = r
    return out


@torch.no_grad()
def engine_step_ms(cs, model, n_slots, option, dev):
    """Median ms of the bf16 engine step (make_session_server(half=True,
    fused=True)'s engine) at n_slots, 3 warm-up and 25 timed synced steps."""
    from puresound_tpu_torch.streaming.deploy import make_session_server

    bf = torch.bfloat16
    bundle = make_session_server(model, None, n_slots=n_slots, chunk_ms=15.0, half=True,
                                 fused=True, lockstep=True, enroll_len=16000)
    engine, chunk = bundle.engine, bundle.chunk_samples
    rng = np.random.default_rng(cs.SEED)
    x = torch.from_numpy((0.1 * rng.standard_normal((n_slots, chunk))).astype(np.float32))
    dvec = torch.from_numpy(rng.standard_normal((n_slots, 192)).astype(np.float32))
    x, dvec = x.to(dev, bf), dvec.to(dev, bf)
    opts = {option: True} if option else {}
    state = engine.init_state(n_slots, bf)
    ms = []
    for k in range(28):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, state = engine.step(x, dvec, state, fused=True, dot_dtype=bf, **opts)
        torch.cuda.synchronize()
        if k >= 3:
            ms.append(1e3 * (time.perf_counter() - t1))
    return float(np.median(ms))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="checkout whose port is measured")
    ap.add_argument("--skip-serving", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import skim_stream_kernel as ops

    if not torch.cuda.is_available():
        print("skim_stream_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops._lib()
    res = {"root": args.root, "card": cs.card_line(),
           "tc_plan": hasattr(ops, "_plan"),
           "sass": {k: list(v) for k, v in cs.hmma_counts(_build.BUILD_DIR, "skim_stream").items()}}
    if hasattr(ops, "tc_clusters"):
        res["clusters"] = ops.tc_clusters(dev)
    res["kernel"] = {f"B={B} {fusion} {variant or 'bf16/f32'}":
                     kernel_case(cs, ops, B, fusion, variant, dev)
                     for B in SLOTS for fusion in ("film", "gate") for variant in VARIANTS}
    if not args.skip_serving:
        from puresound_tpu_torch.zoo.tse import init_model

        flag = init_model("tse_skim_v0_causal", device=dev,
                          generator=torch.Generator().manual_seed(cs.SEED))
        steps = {f"flagship {n}": engine_step_ms(cs, flag, n, None, dev) for n in SLOTS}
        steps.update({f"flagship {SLOTS[-1]} {o}": engine_step_ms(cs, flag, SLOTS[-1], o, dev)
                      for o in VARIANTS[1:]})
        gate = cs.gate_model(dev, torch.Generator().manual_seed(cs.SEED))
        steps.update({f"gate {n}": engine_step_ms(cs, gate, n, None, dev) for n in SLOTS})
        res["engine_step_ms"] = steps
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
