"""Chip smoke test of puresound_tpu_torch on one NVIDIA card.

Drives the port's serving and training paths for the flagship
`tse_skim_v0_causal` at full width (random weights from a seed):

  0. device: torch / CUDA versions, the card's name and power limit;
  1. build: nvcc builds both CUDA sources from the checkout, in parallel,
     and prints each build's seconds and ptxas registers and spills;
  2. `fused_skim_frames` vs `fused_skim_frames_ref` on the card at the
     flagship shapes (f32 and bf16, 20 carried chunks), at a ragged batch and
     at a small shape, with CUDA-event timings of both;
  2b. `lstm_scan_train_fp` forward and backward vs their plain versions at
     the training shapes (SegLSTM 896 x 150, C=128, H=256; MemLSTM 64 x 14,
     C=H=256; a ragged 13 x 7 reverse case), f32 and bf16, with CUDA-event
     timings, the bounds from the shapes, and cuDNN's LSTM as the yardstick;
  3. flagship: 6,375,440 parameters; 20 streamed ticks through
     `StreamingTSE.step(fused=True)` equal the offline `inference`, which
     launches the LSTM kernel 10 times (4 SegLSTM + 6 MemLSTM scans);
  4. serving: `make_session_server(half=True, fused=True)` with 256 sessions,
     25 ticks, every output finite, every step through the kernel;
  5. one f32 training step (B=2 x 1 s) on the card against the same step on
     the CPU in f64 (and the CPU's f32 step beside it): loss, grad_norm,
     every gradient and updated parameter;
  6. full-width training, B=64 x 2 s, Adam 1e-3, grad clip 10, in f32 and
     with bf16 compute: 2 warm-up and 5 timed steps, 10 forward and 10
     backward LSTM launches per step, step time, peak memory and the LSTM
     kernels' share of device time over 2 profiled steps;
  7. the kernels JSON line.

Each phase prints one line with its result and time; any failure raises and
the run exits non-zero. The last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Run from the repo root: `python3 chip_smoke.py` (needs one CUDA card).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
REPLACES = "puresound_tpu/ops/skim_stream_kernel.py:270"
SOURCE = "puresound_tpu_torch/csrc/skim_stream.cu"
LSTM_REPLACES = ("puresound_tpu/ops/lstm_train_kernel.py:533",
                 "puresound_tpu/ops/lstm_train_kernel.py:590")
LSTM_SOURCE = "puresound_tpu_torch/csrc/lstm_train.cu"
# phase 2: (name, blocks, C, H, streams, frames, fusion modes)
SKIM_CASES = [("flagship B=1024", 4, 128, 256, 1024, 15, ("film",) * 4),
              ("ragged B=1001", 4, 128, 256, 1001, 15, ("film",) * 4),
              ("small C=16 H=16 B=13", 3, 16, 16, 13, 4, ("film", "", "film"))]
# phase 2b: (name, rows, T, C, H, reverse, timed repetitions)
LSTM_CASES = [("SegLSTM", 896, 150, 128, 256, False, 20),
              ("MemLSTM", 64, 14, 256, 256, False, 20),
              ("ragged", 13, 7, 24, 16, True, 20)]
TRAIN_B, TRAIN_SECONDS = 64, 2.0    # phase 6: the JAX bench's B=64 x 2 s


def log(phase: str, msg: str, t0: float):
    print(f"[{phase}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def expect_launches(got, want, what: str):
    """Fail unless the kernels were launched exactly as often as the path
    should have launched them."""
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, not {want}")


def snr_db(got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.double() - want.double()).pow(2).sum().item()
    ref = want.double().pow(2).sum().item()
    return 10 * math.log10(ref / max(err, 1e-300))


# ------------------------------------------------------------------ phase 2
@torch.no_grad()
def kernel_case(ops, SkiM, name, n, C, H, B, F, modes, chunks, gen, dev):
    """Kernel vs plain over `chunks` carried chunks, f32 then bf16."""
    masker = SkiM(input_size=C, hidden_size=H, output_size=C, n_blocks=n,
                  seg_size=F * 10, causal=True, embed_dim=192, embed_norm=True,
                  embed_fusion="FiLM",
                  block_with_embed=tuple(int(m == "film") for m in modes),
                  device=dev, generator=gen).eval()
    w32 = masker._fused_weights()
    embed = torch.randn(B, 192, generator=gen).to(dev)
    se, be, ge = masker._embed_terms(masker._norm_embed(embed), B,
                                     torch.float32, w32)
    xs = [torch.randn(B, F, C, generator=gen).to(dev) for _ in range(chunks)]
    h0 = (0.3 * torch.randn(n, B, H, generator=gen)).to(dev)
    c0 = (0.3 * torch.randn(n, B, H, generator=gen)).to(dev)
    res = {"name": name}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ws = w32 if dt == torch.float32 else ops.SkimWeights(
            w.to(dt) for w in w32)
        args = (se.to(dt), be.to(dt), ge.to(dt))
        runs = {}
        for fn in (ops.fused_skim_frames, ops.fused_skim_frames_ref):
            h, c = h0.to(dt), c0.to(dt)
            ys = []
            for x in xs:
                y, h, c = fn(x.to(dt), *args, h, c, ws, modes, dot_dtype=dt)
                ys.append(y)
            runs[fn] = (torch.cat(ys, 1), h, c)
        torch.cuda.synchronize()
        got, want = runs[ops.fused_skim_frames], runs[ops.fused_skim_frames_ref]
        for t in got:
            if not torch.isfinite(t).all():
                raise AssertionError(f"{name} {label}: non-finite kernel output")
        if dt == torch.float32:
            errs = [(g - w).abs().max().item() / w.abs().max().item()
                    for g, w in zip(got, want)]
            res["f32_rel_err"] = max(errs)
            res["f32_max_abs_err"] = max((g - w).abs().max().item()
                                         for g, w in zip(got, want))
            if max(errs) > 1e-3:
                raise AssertionError(f"{name} f32: max|d| / max|ref| per "
                                     f"(y, h, c) = {errs} > 1e-3")
        else:
            snrs = [snr_db(g, w) for g, w in zip(got, want)]
            res["bf16_snr_db"] = min(snrs)
            if min(snrs) < 40.0:
                raise AssertionError(f"{name} bf16: SNR (y, h, c) = {snrs} dB "
                                     "< 40 dB")
        x1, h1, c1 = xs[0].to(dt), h0.to(dt), c0.to(dt)
        for fn, key in ((ops.fused_skim_frames, "ms"),
                        (ops.fused_skim_frames_ref, "plain_ms")):
            res[f"{label}_{key}"] = cuda_ms(
                lambda: fn(x1, *args, h1, c1, ws, modes, dot_dtype=dt))
    return res


# ------------------------------------------------------------------ phase 2b
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float, dt) -> tuple:
    """(least time in ms, "operations" or "bytes") on the published peaks."""
    t_ops, t_bytes = flops / PEAK_OPS[dt], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def skim_work(n, C, H, F, B, dt):
    """(operations, bytes) of one fused_skim_frames call: per frame, stream
    and FiLM block the two C x C FiLM dots, the LSTM's (C + H) x 4H dot and
    the H x C projection; the weights, x, se/be and h/c read once, y and
    h/c written once."""
    e = torch.finfo(dt).bits // 8
    flops = 2.0 * B * F * n * (2 * C * C + (C + H) * 4 * H + H * C)
    weights = n * (2 * C * C + (C + H) * 4 * H + H * C) * e
    nbytes = weights + (2 * B * F * C + 2 * n * B * C + 4 * n * B * H) * e
    return flops, nbytes


def lstm_work(B, T, C, H, dt):
    """(forward flops, forward bytes, backward flops, backward bytes) of one
    lstm_scan_train_fp call: each input read once, each output written once."""
    e = torch.finfo(dt).bits // 8
    R, G = B * T, 4 * H
    w = (C + H + 1) * G * e
    fwd_flops = 2.0 * R * (C + H) * G
    fwd_bytes = R * C * e + w + 2 * B * H * e + R * (H + G + H) * e + 2 * B * H * e
    bwd_flops = 4.0 * R * (C + H) * G
    bwd_bytes = (R * (G + H + H + C + H) * e + w + 4 * B * H * e   # in
                 + R * C * e + 2 * B * H * e + w)                   # out
    return fwd_flops, fwd_bytes, bwd_flops, bwd_bytes


def lstm_kernel_case(lk, name, B, T, C, H, reverse, gen, dev, reps):
    """`lstm_scan_train_fp` kernel (forward + backward) against its plain
    version on the card, f32 then bf16, with CUDA-event times and cuDNN's
    LSTM (`torch.nn.LSTM`, the same weights) as the library yardstick."""
    k = 1.0 / math.sqrt(H)
    uni = lambda *s: (torch.rand(s, generator=gen) * 2 - 1) * k
    x = 0.5 * torch.randn(B, T, C, generator=gen)
    h0, c0 = 0.3 * torch.randn(B, H, generator=gen), 0.3 * torch.randn(B, H, generator=gen)
    w_ih, bias, w_hh = uni(C, 4 * H), uni(4 * H), uni(H, 4 * H)
    dy = torch.randn(B, T, H, generator=gen)
    dhT, dcT = torch.randn(B, H, generator=gen), torch.randn(B, H, generator=gen)
    res = {"name": name, "shape": f"B={B} T={T} C={C} H={H} reverse={reverse}"}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = [a.to(dev, dt) for a in (x, h0, c0, w_ih, bias, w_hh)]
        cot = [a.to(dev, dt) for a in (dy,)] + [dhT.to(dev), dcT.to(dev)]
        got_f = lk._launch_fwd(*args, reverse, residuals=True)
        got_b = lk._launch_bwd(*args, *got_f[:1], *got_f[3:], *cot, reverse)
        want_f = lk.lstm_scan_train_fp_ref(*args, reverse)
        want_b = lk.lstm_scan_train_fp_bwd_ref(*args, want_f[0], *want_f[3:], *cot,
                                               reverse)
        torch.cuda.synchronize()
        vals = list(zip(got_f[:3], want_f[:3]))
        grads = list(zip(got_b, want_b))
        for g, _ in vals + grads:
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {label}: non-finite kernel output")
        if dt == torch.float32:
            rel = lambda pairs: [((g - w).abs().max() / w.abs().max()).item()
                                 for g, w in pairs]
            rv, rg = rel(vals), rel(grads)
            res["f32_val_rel"], res["f32_grad_rel"] = max(rv), max(rg)
            res["f32_max_abs_err"] = max((g - w).abs().max().item()
                                         for g, w in vals + grads)
            if max(rv) > 1e-4 or max(rg) > 1e-3:
                raise AssertionError(
                    f"{name} f32: max|d|/max|ref| (y, hT, cT) {rv} > 1e-4 or "
                    f"(dx, dh0, dc0, dw_ih, dbias, dw_hh) {rg} > 1e-3")
        else:
            sv = [snr_db(g, w) for g, w in vals]
            sg = [snr_db(g, w) for g, w in grads]
            res["bf16_val_snr"], res["bf16_grad_snr"] = min(sv), min(sg)
            if min(sv) < 40.0 or min(sg) < 30.0:
                raise AssertionError(f"{name} bf16: SNR (y, hT, cT) {sv} dB < 40 "
                                     f"or gradients {sg} dB < 30")
        kf = lambda: lk._launch_fwd(*args, reverse, residuals=True)
        kb = lambda: lk._launch_bwd(*args, *got_f[:1], *got_f[3:], *cot, reverse)
        pf = lambda: lk.lstm_scan_train_fp_ref(*args, reverse)
        pb = lambda: lk.lstm_scan_train_fp_bwd_ref(*args, want_f[0], *want_f[3:],
                                                   *cot, reverse)
        res[f"{label}_fwd_ms"] = cuda_ms(kf, reps)
        res[f"{label}_bwd_ms"] = cuda_ms(kb, reps)
        res[f"{label}_plain_fwd_ms"] = cuda_ms(pf, max(2, reps // 4), 1)
        res[f"{label}_plain_bwd_ms"] = cuda_ms(pb, max(2, reps // 4), 1)
        ff, fb, bf, bb = lstm_work(B, T, C, H, dt)
        res[f"{label}_fwd_bound"] = bound_ms(ff, fb, dt)
        res[f"{label}_bwd_bound"] = bound_ms(bf, bb, dt)
        (res[f"{label}_lib_fwd_ms"], res[f"{label}_lib_bwd_ms"],
         res[f"{label}_lib_fwdbwd_ms"]) = cudnn_lstm_ms(*args, *cot, reverse, reps)
    return res


def cudnn_lstm_ms(x, h0, c0, w_ih, bias, w_hh, dy, dhT, dcT, reverse, reps):
    """cuDNN's LSTM (`torch.nn.LSTM`) on the same weights and inputs: (ms of
    its forward, ms of its backward alone, one `torch.autograd.grad` call
    over a kept graph, ms of forward + backward), or Nones where it does not
    apply (it has no reverse-only direction) or refuses the dtype. A
    yardstick only: the port never calls it."""
    if reverse:
        return None, None, None
    B, T, C = x.shape
    H = w_hh.shape[0]
    lstm = torch.nn.LSTM(C, H, batch_first=True).to(device=x.device, dtype=x.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.T)
        lstm.weight_hh_l0.copy_(w_hh.T)
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
    try:
        with torch.no_grad():
            fwd = cuda_ms(lambda: lstm(x, (h0[None], c0[None])), reps)
        inputs = [t.detach().requires_grad_() for t in (x, h0[None], c0[None])]
        y, (h, c) = lstm(inputs[0], tuple(inputs[1:]))
        wrt = inputs + list(lstm.parameters())
        cot = (dy, dhT[None].to(h.dtype), dcT[None].to(c.dtype))
        bwd = cuda_ms(lambda: torch.autograd.grad((y, h, c), wrt, cot,
                                                  retain_graph=True), reps)

        def fwd_bwd():
            y, (h, c) = lstm(inputs[0], tuple(inputs[1:]))
            torch.autograd.grad((y, h, c), wrt, cot)

        both = cuda_ms(fwd_bwd, reps)
    except RuntimeError as err:   # the yardstick only; the port is not involved
        print(f"  cuDNN LSTM ({x.dtype}) not timed: {err}".splitlines()[0], flush=True)
        return None, None, None
    return fwd, bwd, both


# ------------------------------------------------------------ phases 5-6
def train_parts(dev, gen, dtype=torch.float32):
    """(flagship with the SI-SNR loss, TrainState, step) on `dev`."""
    from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
    from puresound_tpu_torch.parallel import TrainState, adam, make_train_step
    from puresound_tpu_torch.zoo import init_tse_model

    model = init_tse_model("tse_skim_v0_causal",
                           sig_loss=SDRLoss.init_mode("sisnr"), device=dev,
                           generator=gen)
    step = make_train_step(model, grad_clip=10.0,
                           compute_dtype=None if dtype == torch.float32 else dtype)
    return model, TrainState.create(model, adam(1e-3)), step


def train_batch(B: int, seconds: float, dev) -> dict:
    rng = np.random.default_rng(SEED)
    L = int(16000 * seconds)
    return {k: torch.from_numpy((0.1 * rng.standard_normal((B, L))
                                 ).astype(np.float32)).to(dev)
            for k in ("noisy", "enroll", "ref_clean")}


def card_vs_cpu_step(lk, dev, card):
    """One f32 training step of the flagship (B=2 x 1 s) on the card
    (kernels) held against the same step on the CPU (plain versions) in
    float64, with the CPU's own f32 step beside it, from the same weights."""
    t = time.perf_counter()
    sides = []
    for d, dt in ((dev, torch.float32), (torch.device("cpu"), torch.float32),
                  (torch.device("cpu"), torch.float64)):
        model, state, step = train_parts(d, torch.Generator().manual_seed(SEED))
        model.to(dt)
        lk.FWD_LAUNCHES = lk.BWD_LAUNCHES = 0
        state, m = step(state, {k: v.to(dt)
                                for k, v in train_batch(2, 1.0, d).items()})
        sides.append(({n: (p.detach().cpu().double(), p.grad.cpu().double())
                       for n, p in model.named_parameters()},
                      {k: float(v) for k, v in m.items()},
                      (lk.FWD_LAUNCHES, lk.BWD_LAUNCHES)))
    (gpu, gm, gl), (cpu, cm, cl), (ref, rm, _) = sides
    expect_launches(gl, (10, 10), "card step, LSTM (fwd, bwd)")
    expect_launches(cl, (0, 0), "CPU step, LSTM (fwd, bwd)")
    loss_rel = abs(gm["loss"] - rm["loss"]) / abs(rm["loss"])
    norm_rel = abs(gm["grad_norm"] - rm["grad_norm"]) / rm["grad_norm"]
    if not loss_rel <= 1e-4 or not norm_rel <= 1e-3:
        raise AssertionError(f"loss rel {loss_rel:.3e} > 1e-4 or grad_norm rel "
                             f"{norm_rel:.3e} > 1e-3")
    g_all = max(g.abs().max().item() for _, g in ref.values())
    worst = {"card": (0.0, ""), "cpu f32": (0.0, "")}
    worst_p, flips, over = 0.0, 0, []
    for n, (p64, g64) in ref.items():
        gmax = g64.abs().max().item()
        if gmax <= 1e-6 * g_all:
            continue    # an exact zero gradient (ASP's conv bias ahead of its softmax)
        for key, side in (("card", gpu), ("cpu f32", cpu)):
            rel = (side[n][1] - g64).abs().max().item() / gmax
            worst[key] = max(worst[key], (rel, n))
        rel = (gpu[n][1] - g64).abs().max().item() / gmax
        if rel > 1e-3:
            over.append(f"{n} {rel:.2e}")
        if rel > 3e-3:
            raise AssertionError(f"grad {n}: max|d|/max|ref| {rel:.3e} > 3e-3")
        # Adam's first step moves each weight by about lr * sign(g): where
        # |g| is within the gradient bar its sign, and so the update, may
        # differ by up to 2 lr; elsewhere the bar is 1e-3 max|ref|
        d = (gpu[n][0] - p64).abs()
        pmax = p64.abs().max().item()
        small = g64.abs() <= 3e-3 * gmax
        if (~small).any():
            worst_p = max(worst_p, d[~small].max().item() / pmax)
        flips += int((d[small] > 1e-3 * pmax).sum())
        if (d[~small] > 1e-3 * pmax).any() or (d[small] > 2e-3 + 1e-6).any():
            raise AssertionError(f"param {n}: updated weights differ")
    log("5 train step", f"flagship B=2 x 1 s, f32 on the card vs f64 on the "
        f"CPU: loss {gm['loss']:.6f} / {rm['loss']:.6f} (rel {loss_rel:.2e}), "
        f"grad_norm rel {norm_rel:.2e}; worst grad max|d|/max|ref| card "
        f"{worst['card'][0]:.2e} ({worst['card'][1]}), CPU f32 "
        f"{worst['cpu f32'][0]:.2e} ({worst['cpu f32'][1]}); card tensors over "
        f"1e-3 (bar 3e-3): {over or 'none'}; updated params {worst_p:.2e} (bar "
        f"1e-3; {flips} weights with |g| <= 3e-3 max|g| apart by <= 2 lr); LSTM "
        f"launches fwd/bwd {gl} on the card, TF32 off [{card}]", t)


def device_share(prof, pattern: str, top: int = 6):
    """(device ms of kernels whose name holds `pattern`, all kernels' device
    ms, the `top` kernels as (ms, name)) from a torch.profiler run, or
    (None, None, []) when it recorded no device time."""
    from torch.autograd import DeviceType

    mine = total = 0.0
    kernels = []
    for e in prof.key_averages():
        # kernels only: a user annotation (e.g. the optimizer's step range)
        # also shows on the device timeline and would count its kernels twice
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        total += us
        kernels.append((us / 1e3, e.key))
        if pattern in e.key:
            mine += us
    if total == 0:
        return None, None, []
    return mine / 1e3, total / 1e3, sorted(kernels, reverse=True)[:top]


def full_width_training(lk, dev, card, dtype):
    """The flagship at B=64 x 2 s: 2 warm-up steps, 5 timed steps, 2
    profiled steps; every step runs 10 LSTM scans forward and backward."""
    t = time.perf_counter()
    B, seconds, warm, timed, profiled = TRAIN_B, TRAIN_SECONDS, 2, 5, 2
    model, state, step = train_parts(dev, torch.Generator().manual_seed(SEED), dtype)
    batch = train_batch(B, seconds, dev)
    first = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms = [], [], []
    lk.FWD_LAUNCHES = lk.BWD_LAUNCHES = 0
    for i in range(warm + timed):
        seen = (lk.FWD_LAUNCHES, lk.BWD_LAUNCHES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        torch.cuda.synchronize()
        expect_launches((lk.FWD_LAUNCHES - seen[0], lk.BWD_LAUNCHES - seen[1]),
                        (10, 10), f"training step {i}, LSTM (fwd, bwd)")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i >= warm:
            times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"non-finite loss {losses} or grad_norm {norms}")
    moved = sum(not torch.equal(first[n], p.detach())
                for n, p in model.named_parameters())
    if moved != len(first):
        raise AssertionError(f"{len(first) - moved} parameter tensors did not move")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            state, m = step(state, batch)
        torch.cuda.synchronize()
    launches = (lk.FWD_LAUNCHES, lk.BWD_LAUNCHES)
    lstm_ms, device_ms, top = device_share(prof, "lstm_")
    p50 = float(np.median(times))
    label = "f32" if dtype == torch.float32 else "bf16"
    share = ("not measured (the profiler saw no device time)" if device_ms is None
             else f"{lstm_ms:.3f} of {device_ms:.3f} ms over {profiled} steps "
             f"({100 * lstm_ms / device_ms:.1f} %); top kernels: " + "; ".join(
                 f"{ms:.3f} ms {name[:60]}" for ms, name in top))
    log("6 training", f"flagship {label} B={B} x {seconds:g} s, Adam 1e-3, clip "
        f"10: loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad_norm "
        f"{norms[-1]:.4f}, all {moved} parameter tensors moved; 10 + 10 LSTM "
        f"launches per step; step p50 {p50:.3f} ms (min {min(times):.3f}, max "
        f"{max(times):.3f}), {B * seconds * 1e3 / p50:.1f} audio-s/s; peak "
        f"{peak / 2**30:.2f} GiB; LSTM kernels' device time {share} [{card}]", t)
    return {"step_ms_p50": p50, "peak_bytes": peak, "lstm_ms": lstm_ms,
            "device_ms": device_ms, "launches": launches}


def run(dev: torch.device) -> int:
    t0 = time.perf_counter()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import skim_stream_kernel as ops
    from puresound_tpu_torch.nnet.skim import SkiM
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.streaming.engine import (StreamingTSE,
                                                      offline_equivalent_input)
    from puresound_tpu_torch.zoo.tse import init_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("0 device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; TF32 off for "
        "matmuls and cuDNN convolutions", t0)

    # ------------------------------------------------------------ 1. build
    t = time.perf_counter()
    sources = ("skim_stream", "lstm_train")
    _build.build(sources)       # one nvcc per source, in parallel
    ops._lib()
    lk._lib()
    for name in sources:
        regs = "; ".join(f"{k}: {r} registers, spills {st}/{ld} B"
                         for k, r, st, ld in _build.ptxas_report(name))
        log("1 build", f"{name}.cu built in {_build.build_seconds[name]:.1f} s "
            f"(nvcc, sm_90a); ptxas: {regs}", t)

    # --------------------------------------------------- 2. kernel vs plain
    gen = torch.Generator().manual_seed(SEED)
    results = []
    for name, n, C, H, B, F, modes in SKIM_CASES:
        t = time.perf_counter()
        r = kernel_case(ops, SkiM, name, n, C, H, B, F, modes, 20, gen, dev)
        results.append(r)
        log("2 kernel", f"{name}: f32 max|d|/max|ref| {r['f32_rel_err']:.3e} "
            f"(max|d| {r['f32_max_abs_err']:.3e}), bf16 SNR "
            f"{r['bf16_snr_db']:.1f} dB; median ms kernel/plain: f32 "
            f"{r['f32_ms']:.3f}/{r['f32_plain_ms']:.3f}, bf16 "
            f"{r['bf16_ms']:.3f}/{r['bf16_plain_ms']:.3f} [{card}]", t)

    # ------------------------------------- 2b. LSTM training kernel vs plain
    lstm_results = {}
    for name, B, T, C, H, reverse, reps in LSTM_CASES:
        t = time.perf_counter()
        r = lstm_kernel_case(lk, name, B, T, C, H, reverse, gen, dev, reps)
        lstm_results[name] = r
        fmt = lambda v: "n/a" if v is None else f"{v:.3f}"
        log("2b lstm", f"{r['shape']}: f32 max|d|/max|ref| values "
            f"{r['f32_val_rel']:.2e}, grads {r['f32_grad_rel']:.2e}; bf16 SNR "
            f"values {r['bf16_val_snr']:.1f} dB, grads {r['bf16_grad_snr']:.1f} dB; "
            + "; ".join(
                f"{lb} ms fwd/bwd kernel {r[f'{lb}_fwd_ms']:.3f}/{r[f'{lb}_bwd_ms']:.3f}, "
                f"plain {r[f'{lb}_plain_fwd_ms']:.3f}/{r[f'{lb}_plain_bwd_ms']:.3f}, "
                f"cuDNN {fmt(r[f'{lb}_lib_fwd_ms'])}/{fmt(r[f'{lb}_lib_bwd_ms'])} "
                f"(fwd+bwd {fmt(r[f'{lb}_lib_fwdbwd_ms'])}), "
                f"bound {r[f'{lb}_fwd_bound'][0]:.3f}/{r[f'{lb}_bwd_bound'][0]:.3f}"
                for lb in ("f32", "bf16")) + f" [{card}]", t)

    # ------------------------------------------------------- 3. flagship
    t = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    model = init_model("tse_skim_v0_causal", device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 6_375_440:
        raise AssertionError(f"flagship has {n_params} parameters")
    engine = StreamingTSE.from_offline(model).eval()
    S, ticks, n_str = 240, 20, 4
    audio = (0.1 * torch.randn(n_str, S * ticks, generator=gen)).to(dev)
    enroll = (0.1 * torch.randn(n_str, 16000, generator=gen)).to(dev)
    with torch.no_grad():
        dvec = engine.embed(enroll)
        state = engine.init_state(n_str)
        ops.LAUNCHES = 0
        outs = []
        for k in range(ticks):
            y, state = engine.step(audio[:, k * S:(k + 1) * S], dvec, state,
                                   fused=True)
            outs.append(y)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES
        streamed = torch.cat(outs, -1)
        lk.FWD_LAUNCHES = lk.BWD_LAUNCHES = 0
        offline = model.inference(offline_equivalent_input(audio, 32, 16),
                                  enroll)[:, :streamed.shape[-1]]
        torch.cuda.synchronize()
        offline_launches = (lk.FWD_LAUNCHES, lk.BWD_LAUNCHES)
    expect_launches(offline_launches, (10, 0), "offline inference, LSTM (fwd, bwd)")
    expect_launches(launches, ticks, "streamed ticks, fused_skim_frames")
    err = (streamed - offline).abs().max().item()
    peak = offline.abs().max().item()
    if not torch.isfinite(streamed).all() or err > 1e-4 * peak:
        raise AssertionError(f"streamed vs offline max|d| {err:.3e} > "
                             f"1e-4 * max|y| ({peak:.3e})")
    log("3 flagship", f"{n_params:,} params; {ticks} ticks x {S} samples x "
        f"{n_str} streams fused == offline inference: max|d| {err:.3e}, "
        f"max|y| {peak:.3e}; fused_skim_frames launches {launches}; offline "
        f"inference's LSTM kernel launches (fwd, bwd) {offline_launches}", t)

    # -------------------------------------------------------- 4. serving
    t = time.perf_counter()
    n_slots, n_ticks = 256, 25
    bundle = make_session_server(model, None, n_slots=n_slots, chunk_ms=15.0,
                                 half=True, fused=True, lockstep=True,
                                 enroll_len=16000)
    server = bundle.server
    chunk = bundle.chunk_samples
    rng = np.random.default_rng(SEED)
    enrolls = (0.1 * rng.standard_normal((n_slots, 16000))).astype(np.float32)
    feed = (0.1 * rng.standard_normal((n_slots, chunk * n_ticks))
            ).astype(np.float32)
    sids = [server.attach(enroll=enrolls[i]) for i in range(n_slots)]
    t_attach = time.perf_counter() - t
    served = np.zeros((n_slots, chunk * n_ticks), np.float32)
    ops.LAUNCHES = 0
    for k in range(n_ticks):
        for i, sid in enumerate(sids):
            server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
        n_out = server.tick()
        if n_out != n_slots:
            raise AssertionError(f"tick {k}: {n_out} outputs, not {n_slots}")
        for i, sid in enumerate(sids):
            got = server.hub.pop_output(sid, chunk)
            if len(got) != chunk or not np.isfinite(got).all():
                raise AssertionError(f"tick {k} slot {sid}: bad output")
            served[i, k * chunk:(k + 1) * chunk] = got
    torch.cuda.synchronize()
    serve_launches = ops.LAUNCHES
    stats = server.stats.snapshot()
    expect_launches(serve_launches, n_ticks, "serving ticks, fused_skim_frames")
    if stats["underrun_slot_ticks"] != 0:
        raise AssertionError(f"{stats['underrun_slot_ticks']} underruns")
    # slot 0 served in bf16 against the f32 engine on the same audio
    with torch.no_grad():
        d0 = engine.embed(torch.from_numpy(enrolls[:1]).to(dev))
        st0 = engine.init_state(1)
        ref0 = []
        for k in range(n_ticks):
            y, st0 = engine.step(torch.from_numpy(
                feed[:1, k * chunk:(k + 1) * chunk]).to(dev), d0, st0,
                fused=True)
            ref0.append(y)
        ref0 = torch.cat(ref0, -1)[0].float().cpu()
    half_snr = snr_db(torch.from_numpy(served[0]), ref0)
    log("4 serving", f"{n_slots} sessions (attach {t_attach:.2f} s), "
        f"{n_ticks} ticks of {chunk} samples: {n_slots} finite outputs per "
        f"tick, 0 underruns, launches {serve_launches}; tick p50 "
        f"{stats['tick_ms_p50']:.3f} ms, p99 {stats['tick_ms_p99']:.3f} ms; "
        f"bf16 slot 0 vs f32 engine SNR {half_snr:.1f} dB [{card}]", t)

    # ----------------------------------------------- 5. card vs CPU step
    card_vs_cpu_step(lk, dev, card)

    # ------------------------------------------ 6. full-width training
    train = {label: full_width_training(lk, dev, card, dt)
             for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}

    # ------------------------------------------------- 7. the kernels line
    flag = results[0]
    skim_bound = bound_ms(*skim_work(4, 128, 256, 15, 1024, torch.float32),
                          torch.float32)
    kernels = [{
        "name": "fused_skim_frames", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": serve_launches,
        "max_abs_err": flag["f32_max_abs_err"], "ms": flag["f32_ms"],
        "plain_ms": flag["f32_plain_ms"], "bound_ms": skim_bound[0],
        "bound_by": skim_bound[1], "library_ms": None,
        "bf16_ms": flag["bf16_ms"], "bf16_plain_ms": flag["bf16_plain_ms"],
        "bf16_bound_ms": bound_ms(*skim_work(4, 128, 256, 15, 1024, torch.bfloat16),
                                  torch.bfloat16)[0],
        "bf16_snr_db": flag["bf16_snr_db"],
        "shape": "n=4 C=128 H=256 F=15 B=1024"}]
    seg = lstm_results["SegLSTM"]
    for half, replaces in (("fwd", LSTM_REPLACES[0]), ("bwd", LSTM_REPLACES[1])):
        i = 0 if half == "fwd" else 1
        kernels.append({
            "name": f"lstm_scan_train_fp ({'forward' if i == 0 else 'backward'})",
            "route": "cuda", "source": LSTM_SOURCE, "replaces": replaces,
            "launches": train["f32"]["launches"][i] + train["bf16"]["launches"][i],
            "max_abs_err": seg["f32_max_abs_err"], "ms": seg[f"f32_{half}_ms"],
            "plain_ms": seg[f"f32_plain_{half}_ms"],
            "bound_ms": seg[f"f32_{half}_bound"][0],
            "bound_by": seg[f"f32_{half}_bound"][1],
            "library_ms": seg[f"f32_lib_{half}_ms"],
            "bf16_ms": seg[f"bf16_{half}_ms"],
            "bf16_plain_ms": seg[f"bf16_plain_{half}_ms"],
            "bf16_bound_ms": seg[f"bf16_{half}_bound"][0],
            "bf16_library_ms": seg[f"bf16_lib_{half}_ms"],
            "shape": seg["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this test runs on an NVIDIA card only", file=sys.stderr)
        return 2
    return run(torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
