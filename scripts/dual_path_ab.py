"""Times the dual-path passes of one checkout of the port on the card, as one
JSON line: `dual_path_chunk`, the wide-center kernels and the NS serving
steps that run them.

The checkout given by `--root` supplies `puresound_tpu_torch` (its kernels
are built from its own `csrc/`); the measuring code is this checkout's
`chip_smoke.py`. A tree from before the dual-path launch plan runs every
pass on the CUDA cores and counts no launches by pass: it is measured with
that route and no pass counts to hold (`legacy_tree`). Run the script once
per tree, in turns (parent, change, change, parent), to compare two trees
on one card:

    python scripts/dual_path_ab.py --root <checkout> [--skip-serving]

It prints the SASS tensor-core instructions of the dual-path kernels
(HMMA / HGMMA / IMMA by kernel, `dual_path` and `masker`), phase 2e's
`dual_path_chunk` at 2,048 DPCRN streams (f32 and bf16 against the plain
version at its bars, two calls bit-equal, the device ms by pass), the
CUDA-event medians of its int8_hh / xscr_half / both variants, phase 2g's
`center_chunk` (2,048 streams) and `dparn_center_chunk` (1,024) with their
device ms by pass and their variants and, unless
`--skip-serving`, the bf16 engine steps of DPCRN at 2,048 slots on
`dp_kernel` and `mk_kernel`, of DPARN at 1,024 on `mk_kernel` + xscr_half
and at 256 on `fused` + `attn_kernel`, which runs none of the dual-path
passes (phases 4b, 4d, 4h, 4c).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import types

import torch

from ab_common import HERE, load_chip_smoke, ns_engine_step


def legacy_tree(cs, dpk):
    """Let chip_smoke's cases measure a tree whose `dual_path_kernel` has no
    launch plan (before the tensor-core route): its plan is the CUDA cores'
    route for every pass, and no launches by pass are expected."""
    cuda = types.SimpleNamespace(route="cuda", passes=dict.fromkeys("ABC", "cuda"))
    dpk._plan = lambda *a, **k: cuda
    dpk.LAUNCHES_BY_PASS = {}
    cs.dp_pass_launches = lambda *a, **k: {}


def dp_variant_ms(cs, dpk, variant, dt, dev, reps=5):
    """CUDA-event median of one `dual_path_chunk` call with an option at
    phase 2h's shape (2,048 streams)."""
    from puresound_tpu_torch.ops.dual_path_kernel import NAMES
    from puresound_tpu_torch.ops.quant import quantize_cols

    B, F, K, CH, H = cs.QDP_SHAPE
    kw = cs.opts_of(variant)
    ws = []
    for i, w in enumerate(cs.dp_weights(CH, H, torch.Generator().manual_seed(cs.SEED))):
        q = kw.get("int8_hh") and NAMES[i % len(NAMES)].startswith("w_hh")
        ws += list(quantize_cols(w)) if q else [w]
    wd = [w.to(dev) if w.dtype == torch.int8 else w.to(dev, dt) for w in ws]
    cgen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = torch.randn(F, K, B, CH, device=dev, generator=cgen).to(dt)
    c = [(0.3 * torch.randn(F, B, H, device=dev, generator=cgen)).to(dt) for _ in range(4)]
    with torch.no_grad():
        return cs.cuda_ms(lambda: dpk._launch(x, c[:2], c[2:], wd, dt, **kw), reps)


def center_variant_ms(cs, mkk, name, zoo_name, B, variant, dt, dev, reps=5):
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
        print("dual_path_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(a.root))
    cs = load_chip_smoke()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import dual_path_kernel as dpk
    from puresound_tpu_torch.ops import masker_kernel as mkk

    if not mkk.__file__.startswith(os.path.abspath(a.root)):
        raise RuntimeError(f"imported {mkk.__file__}, not from {a.root}")
    if not hasattr(dpk, "_plan"):
        legacy_tree(cs, dpk)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(["dparn_attention", "masker", "lstm_scan", "dual_path"])   # in parallel
    out = {"root": a.root, "card": cs.card_line(),
           "sass": {lib: cs.hmma_counts(_build.BUILD_DIR, lib) for lib in ("dual_path",
                                                                          "masker")}}
    gen = torch.Generator().manual_seed(cs.SEED)
    name, B, F, K, CH, H, reps = cs.DP_CASES[0]
    out["dual_path"] = cs.dual_path_case(dpk, name, B, F, K, CH, H, reps, gen, dev)
    out["dp_variants"] = {v: {lb: dp_variant_ms(cs, dpk, v, dt, dev)
                              for lb, dt in (("f32", torch.float32),
                                             ("bf16", torch.bfloat16))}
                          for v in cs.QDP_VARIANTS}
    out["center"] = {n: cs.center_case(mkk, n, zoo, B, reps, dev)
                     for n, zoo, B, reps in cs.CENTER_CASES}
    out["center_variants"] = {}
    for n, zoo, B, variants in cs.QCENTER_CASES:
        for v in variants:
            out["center_variants"][f"{n} {v}"] = {
                lb: center_variant_ms(cs, mkk, n, zoo, B, v, dt, dev)
                for lb, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    if not a.skip_serving:
        dp_slots, ar_slots = cs.NS_SLOTS[-1], cs.DPARN_SLOTS[-1]
        out["serving"] = {
            f"4b DPCRN dp_kernel {dp_slots}": ns_engine_step(
                cs, "ns_dpcrn_v0_causal", {"dp_kernel": True}, {}, dp_slots, dev),
            f"4d DPCRN mk_kernel {dp_slots}": ns_engine_step(
                cs, "ns_dpcrn_v0_causal", {"mk_kernel": True}, {}, dp_slots, dev),
            f"4h DPARN mk_kernel+xscr_half {ar_slots}": ns_engine_step(
                cs, "ns_dparn_v0_causal", {"mk_kernel": True}, {"xscr_half": True},
                ar_slots, dev),
            f"4c DPARN fused+attn_kernel {cs.DPARN_SLOTS[0]}": ns_engine_step(
                cs, "ns_dparn_v0_causal", {"fused": True, "attn_kernel": True}, {},
                cs.DPARN_SLOTS[0], dev)}
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
