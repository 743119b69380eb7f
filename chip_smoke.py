"""Chip smoke test of puresound_tpu_torch on one NVIDIA card.

Drives the port's serving path for the flagship `tse_skim_v0_causal` at full
width (random weights from a seed):

  0. device: torch / CUDA versions, the card's name and power limit;
  1. build: nvcc builds the fused SkiM kernel from the checkout's sources;
  2. kernel vs plain: `fused_skim_frames` against `fused_skim_frames_ref` on
     the card at the flagship shapes (f32 and bf16, 20 carried chunks), at a
     ragged batch and at a small shape, with CUDA-event timings of both;
  3. flagship: 6,375,440 parameters; 20 streamed ticks through
     `StreamingTSE.step(fused=True)` equal the offline `inference`;
  4. serving: `make_session_server(half=True, fused=True)` with 256 sessions,
     25 ticks, every output finite, every step through the kernel.

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


def run(dev: torch.device) -> int:
    t0 = time.perf_counter()
    from puresound_tpu_torch.ops import _build
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
    ops._lib()
    log("1 build", f"skim_stream.cu built in "
        f"{_build.build_seconds['skim_stream']:.1f} s (nvcc, sm_90a)", t)

    # --------------------------------------------------- 2. kernel vs plain
    gen = torch.Generator().manual_seed(SEED)
    flag_modes = ("film",) * 4
    cases = [("flagship B=1024", 4, 128, 256, 1024, 15, flag_modes),
             ("ragged B=1001", 4, 128, 256, 1001, 15, flag_modes),
             ("small C=16 H=16 B=13", 3, 16, 16, 13, 4, ("film", "", "film"))]
    results = []
    for name, n, C, H, B, F, modes in cases:
        t = time.perf_counter()
        r = kernel_case(ops, SkiM, name, n, C, H, B, F, modes, 20, gen, dev)
        results.append(r)
        log("2 kernel", f"{name}: f32 max|d|/max|ref| {r['f32_rel_err']:.3e} "
            f"(max|d| {r['f32_max_abs_err']:.3e}), bf16 SNR "
            f"{r['bf16_snr_db']:.1f} dB; median ms kernel/plain: f32 "
            f"{r['f32_ms']:.3f}/{r['f32_plain_ms']:.3f}, bf16 "
            f"{r['bf16_ms']:.3f}/{r['bf16_plain_ms']:.3f} [{card}]", t)

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
        offline = model.inference(offline_equivalent_input(audio, 32, 16),
                                  enroll)[:, :streamed.shape[-1]]
    if launches != ticks:
        raise AssertionError(f"{launches} kernel launches for {ticks} ticks")
    err = (streamed - offline).abs().max().item()
    peak = offline.abs().max().item()
    if not torch.isfinite(streamed).all() or err > 1e-4 * peak:
        raise AssertionError(f"streamed vs offline max|d| {err:.3e} > "
                             f"1e-4 * max|y| ({peak:.3e})")
    log("3 flagship", f"{n_params:,} params; {ticks} ticks x {S} samples x "
        f"{n_str} streams fused == offline inference: max|d| {err:.3e}, "
        f"max|y| {peak:.3e}; launches {launches}", t)

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
    if serve_launches != n_ticks:
        raise AssertionError(f"{serve_launches} launches for {n_ticks} ticks")
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

    flag = results[0]
    print(json.dumps({"kernels": [{
        "name": "fused_skim_frames", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": serve_launches,
        "max_abs_err": flag["f32_max_abs_err"], "ms": flag["f32_ms"],
        "plain_ms": flag["f32_plain_ms"], "bf16_ms": flag["bf16_ms"],
        "bf16_plain_ms": flag["bf16_plain_ms"],
        "bf16_snr_db": flag["bf16_snr_db"],
        "shape": "n=4 C=128 H=256 F=15 B=1024"}]}))
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
