"""Live-microphone streaming TSE demo with a tkinter UI (counterpart of
egs/tse/demo/mic_demo.py).

- audio capture through `sounddevice` (PortAudio) when it is there;
- enroll: record N seconds, embed once with the speaker net;
- stream: a capture thread queues chunks, the inference thread steps the
  flagship's `StreamingTSE` on the card, a playback thread plays the
  enhanced chunks;
- the input and output spectrograms live on a tkinter canvas (matplotlib).

Without `sounddevice`, an input device, tkinter or a display it prints what
is missing and points to the file demo (`demo_app`) and the simulated-mic
pipeline (`live_demo`). The capture and UI follow JAX's thread structure.

    python -m puresound_tpu_torch.egs.tse.demo.mic_demo [--ckpt epoch_N.ckpt] \\
        [--chunk-ms 20] [--enroll-seconds 5] [--device cuda] [--headless]
"""
from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time

import numpy as np
import torch


def check_environment(need_ui: bool = True):
    """(ok, missing): which of the live demo's prerequisites are there."""
    missing = []
    try:
        import sounddevice  # noqa: F401
        try:
            if not any(d["max_input_channels"] > 0 for d in sounddevice.query_devices()):
                missing.append("an audio input device")
        except Exception:
            missing.append("a queryable audio backend (PortAudio)")
    except Exception:
        missing.append("the `sounddevice` package")
    if need_ui:
        try:
            import tkinter  # noqa: F401
        except Exception:
            missing.append("tkinter")
        if not os.environ.get("DISPLAY") and os.name == "posix":
            missing.append("a display (DISPLAY is unset)")
    return (not missing), missing


class MicDemo:
    """Enroll -> live stream -> enhanced playback + spectrogram."""

    def __init__(self, ckpt, sr=16000, chunk_ms=20.0, enroll_seconds=5.0, device="cuda"):
        from .demo_app import build_flagship_engine, load_or_init

        self.sr = sr
        self.chunk = max(1, int(sr * chunk_ms / 1000.0) // 16) * 16
        self.enroll_seconds = enroll_seconds
        self.engine = load_or_init(build_flagship_engine, ckpt, device)
        self.device = next(self.engine.parameters()).device
        self.dvec = None
        self._stop = threading.Event()
        self._in_q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=64)
        self._out_q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=64)
        self.last_spec = (None, None)  # (input, output) chunks

    # ------------------------------------------------------------ audio io
    def record(self, seconds):
        import sounddevice as sd

        audio = sd.rec(int(seconds * self.sr), samplerate=self.sr, channels=1,
                       dtype="float32")
        sd.wait()
        return audio.reshape(1, -1)

    def enroll(self):
        print(f"Recording {self.enroll_seconds:.0f} s enrollment...")
        wav = self.record(self.enroll_seconds)
        with torch.no_grad():
            self.dvec = self.engine.embed(torch.as_tensor(wav, device=self.device))
        print("Enrolled.")

    # ------------------------------------------------------- worker threads
    def _capture_loop(self):
        import sounddevice as sd

        def cb(indata, frames, t, status):
            if status:
                print(f"capture: {status}", file=sys.stderr)
            try:
                self._in_q.put_nowait(indata[:, 0].copy())
            except queue.Full:
                pass  # dropped under overload, as the reference demo does

        with sd.InputStream(samplerate=self.sr, channels=1, blocksize=self.chunk,
                            callback=cb):
            while not self._stop.is_set():
                time.sleep(0.05)

    def _infer_loop(self):
        state = self.engine.init_state(1)
        while not self._stop.is_set():
            try:
                chunk = self._in_q.get(timeout=0.2)
            except queue.Empty:
                continue
            x = torch.as_tensor(chunk[None, :], device=self.device)
            with torch.no_grad():
                y, state = self.engine.step(x, self.dvec, state)
            out = y[0].cpu().numpy()
            self.last_spec = (chunk, out)
            try:
                self._out_q.put_nowait(out)
            except queue.Full:
                pass

    def _playback_loop(self):
        import sounddevice as sd

        def cb(outdata, frames, t, status):
            try:
                out = self._out_q.get_nowait()
                outdata[:, 0] = out[:frames]
            except queue.Empty:
                outdata[:] = 0.0

        with sd.OutputStream(samplerate=self.sr, channels=1, blocksize=self.chunk,
                             callback=cb):
            while not self._stop.is_set():
                time.sleep(0.05)

    def start_streaming(self):
        if self.dvec is None:
            raise RuntimeError("enroll first")
        self.threads = [threading.Thread(target=f, daemon=True)
                        for f in (self._capture_loop, self._infer_loop,
                                  self._playback_loop)]
        for t in self.threads:
            t.start()

    def stop(self):
        self._stop.set()
        for t in getattr(self, "threads", []):
            t.join(timeout=1.0)
        self._stop.clear()

    # --------------------------------------------------------------- UI
    def run_ui(self):
        import tkinter as tk

        import matplotlib
        matplotlib.use("Agg")
        from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
        from matplotlib.figure import Figure

        root = tk.Tk()
        root.title("puresound_tpu_torch live TSE")
        fig = Figure(figsize=(7, 3))
        ax_in, ax_out = fig.subplots(1, 2)
        canvas = FigureCanvasTkAgg(fig, master=root)
        canvas.get_tk_widget().pack()
        status = tk.StringVar(value="not enrolled")
        tk.Label(root, textvariable=status).pack()
        tk.Button(root, text="Enroll",
                  command=lambda: (self.enroll(), status.set("enrolled"))).pack(side=tk.LEFT)
        tk.Button(root, text="Start",
                  command=lambda: (self.start_streaming(),
                                   status.set("streaming"))).pack(side=tk.LEFT)
        tk.Button(root, text="Stop",
                  command=lambda: (self.stop(), status.set("stopped"))).pack(side=tk.LEFT)
        spec_in, spec_out = [], []

        def tick():
            cin, cout = self.last_spec
            if cin is not None:
                for buf, c in ((spec_in, cin), (spec_out, cout)):
                    mag = np.abs(np.fft.rfft(c * np.hanning(len(c))))
                    buf.append(20 * np.log10(mag + 1e-8))
                    del buf[:-100]
                for ax, buf, name in ((ax_in, spec_in, "input"),
                                      (ax_out, spec_out, "enhanced")):
                    ax.clear()
                    ax.imshow(np.stack(buf, 1), origin="lower", aspect="auto")
                    ax.set_title(name)
                canvas.draw()
            root.after(100, tick)

        root.after(100, tick)
        root.protocol("WM_DELETE_WINDOW", lambda: (self.stop(), root.destroy()))
        root.mainloop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--chunk-ms", type=float, default=20.0)
    ap.add_argument("--enroll-seconds", type=float, default=5.0)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--headless", action="store_true",
                    help="no UI: enroll then stream until Ctrl-C")
    args = ap.parse_args(argv)

    ok, missing = check_environment(need_ui=not args.headless)
    if not ok:
        print("Live-mic demo cannot run here; missing: " + ", ".join(missing) + ".")
        print("Use the file-streaming demo instead:")
        print("  python -m puresound_tpu_torch.egs.tse.demo.demo_app --ckpt ... "
              "--enroll e.wav --input n.wav --output out.wav")
        print("or the simulated-mic end-to-end pipeline:")
        print("  python -m puresound_tpu_torch.egs.tse.demo.live_demo --enroll e.wav "
              "--input n.wav")
        return 2

    demo = MicDemo(args.ckpt, sr=args.sr, chunk_ms=args.chunk_ms,
                   enroll_seconds=args.enroll_seconds, device=args.device)
    if args.headless:
        demo.enroll()
        demo.start_streaming()
        print("Streaming (Ctrl-C to stop)...")
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            demo.stop()
        return 0
    demo.run_ui()
    return 0


if __name__ == "__main__":
    sys.exit(main())
