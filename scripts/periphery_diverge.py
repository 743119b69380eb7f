"""Where phase 8 of `chip_smoke.py` reads a difference, on one CUDA card:

- mesh serving (8b): `lstm_scan_train_fp` at 16 rows against its first 8
  (the stock steps' scan shapes and a 4,096-row one), then the flagship's
  and ns_dpcrn_v0_causal's stock engine step at 16 slots against 8 (NS
  under `cudnn.deterministic`): the modules whose outputs differ, in call
  order;
- the improved attention layer (8d): the `lstm_scan_train_fp` kernel alone
  (4,096 x 64, C = H = 128) against its plain version in float64 on the
  CPU, f32 max|d| / max|ref| and bf16 SNR by tensor; then
  `MhaSelfAttenLayer(improved=True)` at the same widths against float64 on
  the CPU (the reference's seconds), with its own ReLU decisions and with
  the card's.

    python3 scripts/periphery_diverge.py            # from the repo root
"""
from __future__ import annotations

import copy
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

R, T, C, H = 4096, 64, 128, 128


def rel(g, w):
    return ((g.double().cpu() - w).abs().max() / w.abs().max()).item()


def snr(g, w):
    g = g.double().cpu()
    return 10 * np.log10((w * w).sum().item() / max(((g - w) ** 2).sum().item(), 1e-300))


def read(dt, g, w):
    return f"{rel(g, w):.2e}" if dt == torch.float32 else f"{snr(g, w):.1f} dB"


def rows_invariance(lk, dev, g):
    for B, t, c, h in ((16, 1, 128, 256), (16, 15, 128, 256), (16, 1, 256, 256),
                       (4096, 1, 128, 256)):
        k = 1 / np.sqrt(h)
        r = lambda *s: torch.randn(*s, generator=g).to(dev)
        u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * k).to(dev)
        x, h0, c0, w_ih, b, w_hh = r(B, t, c), r(B, h), r(B, h), u(c, 4 * h), u(4 * h), u(h, 4 * h)
        with torch.no_grad():
            full = lk.lstm_scan_train_fp(x, h0, c0, w_ih, b, w_hh)
            half = lk.lstm_scan_train_fp(x[:B // 2], h0[:B // 2], c0[:B // 2], w_ih, b, w_hh)
        print(f"lstm_scan_train_fp B={B} T={t} C={c} H={h}: first {B // 2} rows of {B} == "
              f"{B // 2} rows alone (y, hT, cT): {[torch.equal(a[:B // 2], z) for a, z in zip(full, half)]}")


def first_differing_modules(dev, g):
    from puresound_tpu_torch.streaming.file_eval import build_engine
    from puresound_tpu_torch.zoo.ns import init_model as ns_model
    from puresound_tpu_torch.zoo.tse import init_model

    def trace(engine, n, x, extra):
        outs = {}

        def hook(name):
            def f(m, i, o):
                t = o[0] if isinstance(o, (tuple, list)) else o
                if isinstance(t, torch.Tensor):
                    outs.setdefault(name, t)
            return f

        hooks = [m.register_forward_hook(hook(name))
                 for name, m in engine.named_modules() if name]
        with torch.no_grad():
            st = engine.init_state(n)
            y, _ = engine.step(x[:n], *extra(n), st) if extra else engine.step(x[:n], st)
        for h in hooks:
            h.remove()
        return y, outs

    for name in ("tse_skim_v0_causal", "ns_dpcrn_v0_causal"):
        tse = name.startswith("tse")
        torch.backends.cudnn.deterministic = not tse
        gen = torch.Generator().manual_seed(1)
        m = (init_model if tse else ns_model)(name, device=dev, generator=gen)
        engine = build_engine(m).eval()
        dv = torch.randn(16, 192, generator=g).to(dev)
        extra = (lambda n: (dv[:n],)) if tse else None
        x = (0.1 * torch.randn(16, 240 if tse else 256, generator=g)).to(dev)
        y16, o16 = trace(engine, 16, x, extra)
        y8, o8 = trace(engine, 8, x, extra)
        diff = [k for k, a in o16.items() if a.dim() and a.shape[0] == 16
                and k in o8 and not torch.equal(a[:8], o8[k])]
        print(f"{name} step, slots 0-7 of 16 == 8 slots alone: {torch.equal(y16[:8], y8)}; "
              f"modules that differ, in call order: {diff[:6]}")
    torch.backends.cudnn.deterministic = False


def improved_layer(lk, dev, g):
    from puresound_tpu_torch.nnet.lobe.attention import MhaSelfAttenLayer

    k = 1 / np.sqrt(H)
    x = torch.randn(R, T, C, generator=g, dtype=torch.float64)
    h0 = torch.zeros(R, H, dtype=torch.float64)
    w = [(torch.rand(*s, generator=g, dtype=torch.float64) * 2 - 1) * k
         for s in ((C, 4 * H), (4 * H,), (H, 4 * H))]
    dy = torch.randn(R, T, H, generator=g, dtype=torch.float64)
    wf = lk.lstm_scan_train_fp_ref(x, h0, h0, *w, False)
    wb = lk.lstm_scan_train_fp_bwd_ref(x, h0, h0, *w, wf[0], *wf[3:], dy, None, None, False)
    for dt in (torch.float32, torch.bfloat16):
        a = [t.to(dev, dt) for t in (x, h0, h0, *w)]
        gf = lk._launch_fwd(*a, False, residuals=True)
        gb = lk._launch_bwd(*a, *gf[:1], *gf[3:], dy.to(dev, dt), None, None, False)
        torch.cuda.synchronize()
        print(f"lstm_scan_train_fp kernel {dt} vs float64 plain: y {read(dt, gf[0], wf[0])}; "
              + ", ".join(f"{n} {read(dt, p, q)}" for n, p, q in
                          zip(("dx", "dh0", "dc0", "dw_ih", "db", "dw_hh"), gb, wb)))
    rng = np.random.default_rng(1474)
    x64 = torch.from_numpy(rng.standard_normal((R, C, T)))
    w64 = torch.from_numpy(rng.standard_normal((R, C, T)))

    def reference(ref, mask=None):
        if mask is not None:
            def ff(a):
                y, _ = ref.recurrent(a)
                return ref.ff_drop2(ref.ff2(ref.ff_drop1(y * mask)))
            ref._feedforward = ff
        for p in ref.parameters():
            p.grad = None
        xr = x64.clone().requires_grad_()
        y = ref(xr)
        (y * w64).sum().backward()
        ref.__dict__.pop("_feedforward", None)
        return {"y": y.detach(), "dx": xr.grad, **{n: p.grad.clone()
                                                   for n, p in ref.named_parameters()}}

    for bi in (False, True):
        ref = MhaSelfAttenLayer(C, H, 8, improved=True, bidirectional=bi, dtype=torch.float64,
                                generator=torch.Generator().manual_seed(1234)).eval()
        t = time.perf_counter()
        own = reference(ref)
        print(f"improved layer bi={bi}: the float64 reference on the CPU took "
              f"{time.perf_counter() - t:.1f} s")
        for dt in (torch.float32, torch.bfloat16):
            layer = copy.deepcopy(ref).to(dev, dt)
            signs = []
            hook = layer.recurrent.register_forward_hook(
                lambda m, i, o: signs.append((o[0] > 0).double().cpu()))
            xx = x64.to(dev, dt).requires_grad_()
            y = layer(xx)
            (y * w64.to(dev, dt)).sum().backward()
            hook.remove()
            got = {"y": y.detach(), "dx": xx.grad,
                   **{n: p.grad for n, p in layer.named_parameters()}}
            card = reference(ref, signs[0])
            for key in ("y", "dx", "recurrent.weight_ih_l0", "recurrent.weight_hh_l0"):
                print(f"  {dt} {key}: own ReLU decisions {read(dt, got[key], own[key])}, "
                      f"the card's {read(dt, got[key], card[key])}")


def main() -> int:
    if not torch.cuda.is_available():
        print("periphery_diverge: no CUDA device", file=sys.stderr)
        return 2
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import tcn_train_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(("lstm_train", "tcn_train"))
    lk._lib(), tk._lib()
    dev, g = torch.device("cuda", 0), torch.Generator().manual_seed(3)
    rows_invariance(lk, dev, g)
    first_differing_modules(dev, g)
    improved_layer(lk, dev, g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
