"""Streaming TSE demo on a file (counterpart of egs/tse/demo/demo_app.py).

The enroll -> stream -> reconstruct pipeline of the reference's microphone
app, on a wav file: the enrollment is embedded once, then the input is
streamed chunk by chunk through the flagship's `StreamingTSE` step at
real-time cadence (`--no-realtime`: as fast as it goes), and the per-chunk
latency and real-time factor are printed. Runs on the CUDA card unless
`--device cpu`.

    python -m puresound_tpu_torch.egs.tse.demo.demo_app --ckpt epoch_N.ckpt \\
        --enroll enroll.wav --input noisy.wav --output enhanced.wav [--chunk-ms 20]

`--ckpt` takes the port's checkpoint or the JAX package's (read without
flax); without one the weights are random (from `--seed`), with a warning.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .utils import DemoSpeakerNet, DemoTseNet

SR = 16000


def build_flagship_engine(device=None, generator=None):
    """The flagship `tse_skim_v0_causal` as a StreamingTSE (FreeEncDec 32 /
    16 / 128, causal SkiM of 4 FiLM blocks at H=256, the TCN speaker net of
    192-d d-vectors), in eval mode, on the card unless `device` says
    otherwise."""
    from ....streaming.engine import StreamingTSE
    from ....zoo.tse import init_model

    return StreamingTSE.from_offline(
        init_model("tse_skim_v0_causal", device=device, generator=generator)).eval()


def load_or_init(build_engine, ckpt, device="cuda", seed: int = 0):
    """build_engine(device=, generator=) with weights from `ckpt` (the port's
    checkpoint or the JAX package's) or random ones from `seed`, with a
    warning. Shared with mic_demo and live_demo."""
    from ....tasks.base import BaseTrainer

    engine = build_engine(device=torch.device(device),
                          generator=torch.Generator().manual_seed(seed))
    if ckpt:
        BaseTrainer.load_params_from_ckpt(ckpt, engine)
        print(f"loaded checkpoint {ckpt}")
    else:
        print("WARNING: running with random weights (no --ckpt given)")
    return engine


def read_mono(path: str, sr: int = SR, target_lvl=None) -> np.ndarray:
    """A wav's first channel at `sr` [1, L]."""
    from ....src.audio import AudioIO

    wav, file_sr = AudioIO.open(path, target_lvl=target_lvl)
    if file_sr != sr:
        wav = AudioIO.resample(wav, file_sr, sr)
    return wav[:1]


def stream_file(engine, dvec, noisy: np.ndarray, chunk: int, realtime: bool):
    """(enhanced [n * chunk], per-chunk latencies in ms): the whole chunks
    of `noisy` [L] through DemoTseNet, paced at real time when asked."""
    tse = DemoTseNet(engine)
    period = chunk / SR
    outs, lat = [], []
    next_t = time.perf_counter()
    for i in range(len(noisy) // chunk):
        t0 = time.perf_counter()
        out = tse.streaming_inference_chunk(noisy[i * chunk:(i + 1) * chunk], dvec)
        lat.append((time.perf_counter() - t0) * 1000)
        outs.append(out.reshape(-1))
        if realtime:
            next_t += period
            time.sleep(max(0.0, next_t - time.perf_counter()))
    return np.concatenate(outs) if outs else np.zeros(0, np.float32), np.asarray(lat)


def main(args) -> dict:
    from ....src.audio import AudioIO

    engine = load_or_init(build_flagship_engine, args.ckpt, args.device, args.seed)
    enroll = read_mono(args.enroll, target_lvl=-28)
    noisy = read_mono(args.input)[0]
    dvec = DemoSpeakerNet(engine).get_speaker_embedding(enroll)
    print(f"speaker embedding: {dvec.shape}")
    chunk = int(SR * args.chunk_ms / 1000)
    chunk -= chunk % 16  # hop-aligned
    enh, lat = stream_file(engine, dvec, noisy, chunk, realtime=not args.no_realtime)
    AudioIO.save(enh.reshape(1, -1), args.output, SR)
    steady = lat[1:] if len(lat) > 1 else lat  # the first call builds the kernels
    rtf = float(np.mean(steady)) / args.chunk_ms
    print(f"streamed {len(lat)} chunks of {args.chunk_ms} ms on {args.device}")
    print(f"latency p50/p95/p99/max: {np.percentile(steady, 50):.2f}/"
          f"{np.percentile(steady, 95):.2f}/{np.percentile(steady, 99):.2f}/"
          f"{steady.max():.2f} ms")
    print(f"real-time factor: {rtf:.3f} ({1 / rtf:.1f}x real time)")
    print(f"saved {args.output}")
    return {"enhanced": enh, "latency_ms": lat, "rtf": rtf, "dvec": dvec, "chunk": chunk}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--enroll", type=str, required=True)
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, default="enhanced.wav")
    p.add_argument("--chunk-ms", type=float, default=20.0)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0, help="random weights' seed (no --ckpt)")
    p.add_argument("--no-realtime", action="store_true",
                   help="stream as fast as it goes instead of at real-time cadence")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
    sys.exit(0)
