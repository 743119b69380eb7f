"""Where the Conv-TasNet v0 training step on the card parts from its f64 step.

`chip_smoke.py` phase 6g holds one f32 step of `td_tse_conv_tasnet_v0` (B=2 x
0.5 s, SI-SNR + 10 x AAM-softmax, the `..._1a.yaml` config's losses) against
the CPU's f64 step. This script shows what moves the gradients apart:

    python3 scripts/tcn_step_diverge.py            # on the card
    python3 scripts/tcn_step_diverge.py --cudnn    # on the card, cuDNN on / off
    python3 scripts/tcn_step_diverge.py --cpu      # the f64 step's sensitivity, CPU

On the card it runs the step twice from one state, once with
`tcn_block_train`'s CUDA kernel and once with its plain version on the card,
records every launch's inputs (x; x and dy) and outputs, and prints, launch by
launch, how far the two steps' inputs and outputs lie apart (max|d|/max|ref|),
then the gradients. With `--cudnn` it holds the card's f32 step against the
CPU's f64 step with cuDNN's default algorithms, cuDNN's deterministic ones
and cuDNN off (PyTorch's own convolutions): the whole gradient's relative L2
and the five furthest tensors (max|d|/max|ref|). With `--cpu` it runs the f64 step on the CPU three times,
the mixture scaled by 1 + eps * noise (eps 0, 1e-7, 1e-6), and prints how far
the gradients move: the step's own conditioning.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONF = "egs/tse/conf/libri2mix_max_2spk_clean_16k_1a.yaml"
NAME = "td_tse_conv_tasnet_v0"


def rel(a, b) -> float:
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max().clamp_min(1e-300)).item()


def on_card() -> None:
    import chip_smoke as cs
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import tcn_train_kernel as tk
    from puresound_tpu_torch.src.utils import load_hparam

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(("tcn_train",))
    dev = torch.device("cuda", 0)
    hp = load_hparam(CONF)
    fwd, bwd = tk._launch_fwd, tk._launch_bwd
    plain = (lambda x, ps, d: tk.tcn_block_train_ref(x, *ps, dilation=d),
             lambda x, dy, ps, d: tk.tcn_block_train_bwd_ref(x, dy, *ps, dilation=d))
    runs = {}
    for label, (f, b) in (("kernel", (fwd, bwd)), ("plain", plain)):
        rec = []

        def rec_fwd(x, ps, d, f=f, rec=rec):
            y = f(x, ps, d)
            rec.append(("fwd", [x.clone()], [y.clone()]))
            return y

        def rec_bwd(x, dy, ps, d, b=b, rec=rec):
            out = b(x, dy, ps, d)
            rec.append(("bwd", [x.clone(), dy.clone()], [o.clone() for o in out]))
            return out

        tk._launch_fwd, tk._launch_bwd = rec_fwd, rec_bwd
        try:
            model, state, step = cs.tse_train_parts(NAME, hp, dev)
            state, m = step(state, cs.tse_batch(dev, False))
            torch.cuda.synchronize()
        finally:
            tk._launch_fwd, tk._launch_bwd = fwd, bwd
        runs[label] = (rec, {n: p.grad.clone() for n, p in model.named_parameters()},
                       float(m["loss"]))
    (rk, gk, loss_k), (rp, gp, loss_p) = runs["kernel"], runs["plain"]
    print(f"{NAME} B={cs.TSE_CHECK_B} x {cs.TSE_CHECK_SECONDS:g} s on "
          f"{cs.card_line()}: loss kernel {loss_k} / plain {loss_p}")
    names = ("dx",) + tk.PARAM_NAMES
    for i, (a, b) in enumerate(zip(rk, rp)):
        ins = ", ".join(f"{rel(x, y):.1e}" for x, y in zip(a[1], b[1]))
        outs = sorted(((rel(x, y), n) for x, y, n in zip(
            a[2], b[2], ("y",) if a[0] == "fwd" else names)), reverse=True)[:3]
        print(f"launch {i} {a[0]}: inputs (x{', dy' if a[0] == 'bwd' else ''}) apart {ins}; "
              "outputs, the three furthest: " + ", ".join(f"{n} {v:.1e}" for v, n in outs))
    rows = sorted(((rel(gk[n], gp[n]), n) for n in gk if gp[n].abs().max() > 0),
                  reverse=True)[:12]
    print("gradients, kernel step vs plain step: "
          + ", ".join(f"{n} {v:.2e}" for v, n in rows))


def cudnn_modes() -> None:
    import chip_smoke as cs
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.src.utils import load_hparam

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(("tcn_train",))
    dev = torch.device("cuda", 0)
    hp = load_hparam(CONF)

    def grads(d, dt):
        model, state, step = cs.tse_train_parts(NAME, hp, d)
        model.to(dt)
        step(state, {k: v.to(dt) if v.is_floating_point() else v
                     for k, v in cs.tse_batch(d, False).items()})
        return {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}

    ref = grads(torch.device("cpu"), torch.float64)
    g_all = max(g.abs().max().item() for g in ref.values())
    flat = lambda g: torch.cat([g[n].reshape(-1) for n in ref])
    print(f"{NAME} B={cs.TSE_CHECK_B} x {cs.TSE_CHECK_SECONDS:g} s, f32 on {cs.card_line()} "
          "against f64 on the CPU")
    for label, enabled, deterministic in (("cuDNN default", True, False),
                                          ("cuDNN deterministic", True, True),
                                          ("cuDNN off", False, False)):
        torch.backends.cudnn.enabled = enabled
        torch.backends.cudnn.deterministic = deterministic
        g = grads(dev, torch.float32)
        rows = sorted(((rel(g[n], r), n) for n, r in ref.items()
                       if r.abs().max() > 1e-6 * g_all), reverse=True)[:5]
        l2 = ((flat(g) - flat(ref)).norm() / flat(ref).norm()).item()
        print(f"{label}: whole gradient {l2:.2e} by relative L2; "
              + ", ".join(f"{n} {v:.2e}" for v, n in rows))


def on_cpu() -> None:
    import chip_smoke as cs
    from puresound_tpu_torch.src.utils import load_hparam

    hp = load_hparam(CONF)
    cpu = torch.device("cpu")
    grads = {}
    for eps in (0.0, 1e-7, 1e-6):
        model, state, step = cs.tse_train_parts(NAME, hp, cpu)
        model.to(torch.float64)
        batch = {k: v.to(torch.float64) if v.is_floating_point() else v
                 for k, v in cs.tse_batch(cpu, False).items()}
        noise = torch.randn(batch["noisy"].shape, dtype=torch.float64,
                            generator=torch.Generator().manual_seed(5))
        batch["noisy"] = batch["noisy"] * (1 + eps * noise)
        step(state, batch)
        grads[eps] = {n: p.grad.clone() for n, p in model.named_parameters()}
    g_all = max(g.abs().max().item() for g in grads[0.0].values())
    for eps in (1e-7, 1e-6):
        rows = sorted(((rel(grads[eps][n], g), n) for n, g in grads[0.0].items()
                       if g.abs().max() > 1e-6 * g_all), reverse=True)[:6]
        print(f"f64 step, mixture x (1 + {eps:g} noise): gradients moved "
              + ", ".join(f"{n} {v:.2e}" for v, n in rows))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--cudnn", action="store_true")
    args = parser.parse_args(argv)
    on_cpu() if args.cpu else cudnn_modes() if args.cudnn else on_card()


if __name__ == "__main__":
    main()
