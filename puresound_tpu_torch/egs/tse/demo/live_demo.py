"""Live streaming TSE demo: simulated microphones -> serving loop -> sinks
(counterpart of egs/tse/demo/live_demo.py).

    N mic threads (real-time cadence, one wav each)
        --push--> the C++ ring hub (csrc/stream_runtime.cpp)
    serving thread: StreamingServer.tick, one batched StreamingTSE step on
    the card
        --pop---> N sink threads (enhanced audio, per-piece latency)

    python -m puresound_tpu_torch.egs.tse.demo.live_demo --enroll e.wav \\
        --input noisy.wav --n-mics 4 --seconds 6 --out-dir live_demo

Prints per-stream latency percentiles and whether every sink got all of
its audio, and writes each stream's enhanced wav. The server steps in
lockstep (only when every stream has a whole chunk), so a stream's state
never advances on the zeros of a chunk that had not arrived: each sink
equals the engine fed the same chunks. Runs on the card unless `--device
cpu`.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np
import torch

from .demo_app import SR, build_flagship_engine, load_or_init, read_mono


class SimulatedMicrophone(threading.Thread):
    """Pushes a waveform into the hub in chunk-sized pieces at real-time
    cadence (the record thread of the reference demo, without hardware)."""

    def __init__(self, hub, stream_id: int, wav: np.ndarray, sr: int, chunk: int,
                 realtime: bool = True):
        super().__init__(daemon=True)
        self.hub, self.sid = hub, stream_id
        self.wav = np.asarray(wav, np.float32).reshape(-1)
        self.sr, self.chunk, self.realtime = sr, chunk, realtime
        self.pushed = 0

    def run(self):
        period = self.chunk / self.sr
        next_t = time.perf_counter()
        for i in range(0, len(self.wav), self.chunk):
            piece = self.wav[i:i + self.chunk]
            if len(piece) < self.chunk:
                piece = np.pad(piece, (0, self.chunk - len(piece)))
            self.hub.push_input(self.sid, piece)
            self.pushed += self.chunk
            if self.realtime:
                next_t += period
                dt = next_t - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)


class Sink(threading.Thread):
    """Drains a stream's enhanced audio and records each piece's arrival
    latency against the mic's real-time clock. It polls every `poll_s`: a
    tighter poll of several sinks keeps taking the interpreter from the
    serving thread, whose step is host-bound."""

    def __init__(self, hub, stream_id: int, total: int, chunk: int, t_start: float,
                 sr: int, timeout: float = 60.0, poll_s: float = 0.005):
        super().__init__(daemon=True)
        self.hub, self.sid, self.total, self.chunk = hub, stream_id, total, chunk
        self.t_start, self.sr, self.timeout, self.poll_s = t_start, sr, timeout, poll_s
        self.audio = np.zeros(0, np.float32)
        self.latencies_ms = []

    def run(self):
        deadline = time.perf_counter() + self.timeout
        while len(self.audio) < self.total and time.perf_counter() < deadline:
            got = self.hub.pop_output(self.sid, self.chunk)
            if len(got) == 0:
                time.sleep(self.poll_s)
                continue
            now = time.perf_counter()
            # the mic produced the last sample of this piece at:
            produced_at = self.t_start + (len(self.audio) + len(got)) / self.sr
            self.latencies_ms.append((now - produced_at) * 1000.0)
            self.audio = np.concatenate([self.audio, got])


def make_step(engine, dvec: torch.Tensor, n: int):
    """(step_fn for StreamingServer, the state box): the engine's step on
    the gathered [n, chunk] batch, its state carried in the box."""
    dev = dvec.device
    box = {"state": engine.init_state(n)}

    def step_fn(batch_np):
        x = torch.from_numpy(np.ascontiguousarray(batch_np, np.float32)).to(dev)
        with torch.no_grad():
            out, box["state"] = engine.step(x, dvec, box["state"])
        return out

    return step_fn, box


def run(args) -> dict:
    """The demo; returns the sinks' audio and latencies, the per-stream
    inputs and d-vectors, the server's stats and the tick count."""
    from ....src.audio import AudioIO
    from ....streaming.server import StreamingServer

    chunk = max(1, int(SR * args.chunk_ms / 1000) // 16) * 16
    engine = load_or_init(build_flagship_engine, args.ckpt, args.device, args.seed)
    dev = next(engine.parameters()).device
    enroll = read_mono(args.enroll)
    wav = read_mono(args.input)[0, :int(args.seconds * SR)]
    N = args.n_mics
    with torch.no_grad():
        dvec = engine.embed(torch.as_tensor(np.repeat(enroll, N, 0), device=dev))
    step_fn, box = make_step(engine, dvec, N)
    step_fn(np.zeros((N, chunk), np.float32))   # build the kernels before going live
    box["state"] = engine.init_state(N)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    server = StreamingServer(step_fn, n_streams=N, chunk_samples=chunk, lockstep=True)
    server.start()
    t0 = time.perf_counter()
    total = len(wav) // chunk * chunk
    mics = [SimulatedMicrophone(server.hub, i, wav, SR, chunk, realtime=not args.no_realtime)
            for i in range(N)]
    sinks = [Sink(server.hub, i, total, chunk, t0, SR) for i in range(N)]
    for s in sinks + mics:
        s.start()
    for m in mics:
        m.join()
    for s in sinks:
        s.join()
    server.stop()

    os.makedirs(args.out_dir, exist_ok=True)
    print(f"\nlive demo: {N} simulated mics, {args.seconds:.1f}s each, "
          f"{chunk / SR * 1000:.0f} ms chunks, {server.ticks} server ticks on {dev}")
    period_ms = chunk / SR * 1000
    per_stream = []
    for i, s in enumerate(sinks):
        lat = np.asarray(s.latencies_ms) if s.latencies_ms else np.zeros(1)
        out_path = os.path.join(args.out_dir, f"enhanced_{i}.wav")
        AudioIO.save(s.audio.reshape(1, -1), out_path, SR)
        late = int((lat > period_ms).sum())
        per_stream.append({"p50_ms": float(np.percentile(lat, 50)),
                           "p99_ms": float(np.percentile(lat, 99)),
                           "late_pieces": late, "complete": len(s.audio) >= total})
        print(f"  mic {i}: {len(s.audio) / SR:.2f}s out, latency "
              f"p50={per_stream[-1]['p50_ms']:.1f} ms p99={per_stream[-1]['p99_ms']:.1f} ms, "
              f"{late} pieces later than a chunk -> {out_path}")
    ok = all(p["complete"] for p in per_stream)
    print("real-time:", "OK" if ok else "UNDERRUN")
    return {"ok": ok, "sinks": [s.audio for s in sinks], "per_stream": per_stream,
            "wav": wav, "enroll": enroll, "chunk": chunk, "ticks": server.ticks,
            "engine": engine, "dvec": dvec}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--enroll", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--n-mics", type=int, default=4)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--chunk-ms", type=float, default=20.0)
    p.add_argument("--out-dir", default="live_demo")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0, help="random weights' seed (no --ckpt)")
    p.add_argument("--no-realtime", action="store_true",
                   help="push audio as fast as possible (throughput mode)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
