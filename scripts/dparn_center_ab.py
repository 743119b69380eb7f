"""Times DPARN's attention pass, the wide-center kernels and DPARN's serving
step of one checkout of the port on the card, as one JSON line.

The checkout given by `--root` supplies `puresound_tpu_torch` (its kernels
are built from its own `csrc/`); the measuring code is this checkout's
`chip_smoke.py`. Run it once per tree, in turns (parent, change, change,
parent), to compare two trees on one card:

    python scripts/dparn_center_ab.py --root <checkout> [--skip-serving]

It prints phase 2f's `dparn_intra_pass` case at R = 4,096 (f32 and bf16
against the plain version at its bars, with the stock encoder modules as
the yardstick), phase 2g's `center_chunk` (2,048 DPCRN streams) and
`dparn_center_chunk` (1,024 DPARN streams) with their device ms by pass,
the CUDA-event medians of the wide center's option variants (`center_chunk`
int8_hh and xscr_half, `dparn_center_chunk` xscr_half; f32 and bf16) and,
unless `--skip-serving`, DPARN's bf16 engine step at 1,024 slots on
`fused + attn_kernel` (phase 4c) and on `mk_kernel` + xscr_half (phase 4h).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ab_common import HERE, load_chip_smoke, ns_engine_step


def variant_ms(cs, mkk, name, zoo_name, B, variant, dt, dev, reps=5):
    """CUDA-event median of one wide-center call with an option, the
    full-width masker's weights (as phase 2h's `qcenter_case` times it)."""
    from puresound_tpu_torch.streaming.halfprec import to_half

    masker = cs.full_width_masker(zoo_name, dev, cs.SEED)
    if dt == torch.bfloat16:
        to_half(masker)
    cgen = torch.Generator(device=dev).manual_seed(cs.SEED)
    st0 = masker.init_stream_state(B, mk_kernel=True)
    F, C0 = st0["dc"][0].shape[0], st0["dc"][0].shape[-1]
    x = (0.5 * torch.randn(F, 2, B, C0, device=dev, generator=cgen)).to(dt)
    c = [(0.3 * torch.randn(t.shape, device=dev, generator=cgen)).to(dt)
         for t in st0["dc"] + [st0[k] for k in ("u0h", "u0s", "u1h", "u2h", "h1", "h2",
                                                  "c1", "c2")]]
    kind = 0 if name == "center_chunk" else 1
    opts = cs.opts_of(variant)
    with torch.no_grad():
        cw = masker._mk_conv_weights()
        bw = (masker._dp_kernel_weights(opts.get("int8_hh", False)) if kind == 0
              else masker._dparn_block_weights())
        pe = masker.dprnn_block1.intra_atten1.pos.table(F, dev) if kind else None
        heads = getattr(masker, "nhead", 0)
        return cs.cuda_ms(lambda: mkk._launch(kind, x, pe, c[0:3], *c[3:7], c[7:9], c[9:11],
                                              cw, bw, heads, dt, **opts), reps)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--skip-serving", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("dparn_center_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(a.root))
    cs = load_chip_smoke()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import dparn_attention_kernel as dak
    from puresound_tpu_torch.ops import masker_kernel as mkk

    if not mkk.__file__.startswith(os.path.abspath(a.root)):
        raise RuntimeError(f"imported {mkk.__file__}, not from {a.root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(["dparn_attention", "masker", "lstm_scan", "dual_path"])   # in parallel
    out = {"root": a.root, "card": cs.card_line()}
    gen = torch.Generator().manual_seed(cs.SEED)
    name, R, F, C, heads, FFD, reps = cs.ATTN_CASES[0]
    out["attn"] = cs.attn_case(dak, name, R, F, C, heads, FFD, reps, gen, dev)
    out["center"] = {n: cs.center_case(mkk, n, zoo, B, reps, dev)
                     for n, zoo, B, reps in cs.CENTER_CASES}
    out["variants"] = {}
    for n, zoo, B, variants in cs.QCENTER_CASES:
        for v in variants:
            out["variants"][f"{n} {v}"] = {
                lb: variant_ms(cs, mkk, n, zoo, B, v, dt, dev)
                for lb, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    if not a.skip_serving:
        n = cs.DPARN_SLOTS[-1]
        out["serving"] = {
            "4c fused+attn_kernel": ns_engine_step(
                cs, "ns_dparn_v0_causal", {"fused": True, "attn_kernel": True}, {}, n, dev),
            "4h mk_kernel+xscr_half": ns_engine_step(
                cs, "ns_dparn_v0_causal", {"mk_kernel": True}, {"xscr_half": True}, n, dev)}
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
