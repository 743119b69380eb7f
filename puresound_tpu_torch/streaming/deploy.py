"""One-call deployment: model -> ready-to-tick SessionServer.

Counterpart of puresound_tpu/streaming/deploy.py:40 (`make_session_server`):
the time-domain TSE branch, the STFT-engine branch (NS, and STFT-domain TSE
with a speaker net, `:182-188`) and the SIMO (DSS) branch (`:119-122,
170-197`), with the pipelined and int16 (pcm16)
transports (`:199-246`), mesh serving (`mesh=`, `:88-93, 238`) and
`run_serve` (`:247-285`), the recipes' `--action serve`: the server behind
the TCP front of `socket_server`. The server owns a copy of the model (cast
to bfloat16 when `half`), so the caller's module is never changed.
"""
from __future__ import annotations

import copy
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..nnet.encoder import FreeEncDec
from .engine import StreamingTSE
from .file_eval import build_engine, check_chunk_frames, engine_step_options
from .halfprec import to_half
from .ns_engine import StreamingNS
from .server import SessionServer, infer_slot_axes
from .simo_engine import StreamingDSS

__all__ = ["ServingBundle", "make_session_server", "run_serve"]


@dataclass
class ServingBundle:
    """Everything a serving front-end needs."""

    server: SessionServer
    engine: torch.nn.Module
    chunk_samples: int
    embed_fn: Optional[Callable]    # None for an unconditioned NS / DSS engine
    embed_dim: Optional[int]
    n_sources: int = 1              # > 1: SIMO separation, sources sample-interleaved


def make_session_server(model, weights: Optional[dict], n_slots: int,
                        chunk_ms: float = 16.0, sr: int = 16000,
                        half: bool = False, fused: Optional[bool] = None,
                        dp_kernel: bool = False, attn_kernel: bool = False,
                        mk_kernel: bool = False,
                        enroll_len: Optional[int] = None, mesh=None,
                        pipelined: bool = False, lockstep: bool = False,
                        ring_capacity: int = 1 << 16,
                        pcm16: bool = False,
                        pcm16_scale: float = 8192.0) -> ServingBundle:
    """Build a SessionServer for a SoTaskWrapModule, TSE (FreeEncDec +
    SkiM or causal ConvTasNet + speaker net, or ConvEncDec + causal UnetTcn
    + speaker net) or NS (ConvEncDec + DPCRN / DPARN), or for the DSS
    SiMoTaskWrapModule (ConvEncDec + DPARN_Mout),
    whose step returns its M sources sample-interleaved, [B, S * M] (sample
    s of source m at s * M + m), so that they ride each slot's one output
    ring; `n_sources` of the bundle is the engine's M.

    Args:
        model: the offline wrapper (its device is the serving device).
        weights: a state_dict loaded into the server's copy of the model
            (e.g. `utils.from_jax.from_jax(variables)`), or None to serve
            the model's own weights.
        n_slots: fixed concurrent-session capacity (the step's batch).
        chunk_ms: tick size, rounded down to a hop multiple.
        half: serve in bfloat16 (weights, state and the kernels' dots); the
            hub surface stays float32.
        fused: TSE runs the SkiM stack through `fused_skim_frames`; NS runs
            the masker's recurrences through `lstm_scan`. None (the default)
            means on for a TSE masker with a fused step (SkiM), off for one
            without (ConvTasNet) and off for NS, so that an NS call with
            dp_kernel=True or mk_kernel=True stands. True raises a ValueError
            for a TSE masker without a fused step.
        dp_kernel: NS only, the whole DPCRN bottleneck through
            `dual_path_chunk` (exclusive with fused).
        attn_kernel: a DPARN (NS) or DPARN_Mout (DSS) masker, each block's
            intra pass through `dparn_intra_pass` (combines with fused).
        mk_kernel: NS and DSS, the six stride-1 inner layers of a causal
            DPCRN or DPARN through the wide-center kernel (`center_chunk` /
            `dparn_center_chunk`; exclusive with fused and dp_kernel).
        enroll_len: TSE enrollment length (samples) of the probe that reads
            the embedding width (default 5 s).
        pipelined: a tick returns the previous tick's output while its own
            copies back (`SessionServer`; call `server.flush()` at the end).
        pcm16: the audio crosses the host link as int16 at pcm16_scale; the
            step converts on the device (x / scale in, clip(y * scale,
            +-32767) truncated to int16 out).
        mesh: a single-process `parallel.Mesh` of devices (one may repeat):
            the slots are served over its dp devices, each holding a replica
            of the engine (`SessionServer(mesh=)`). The replicas run the stock
            step: `fused` (whose default None then means off), `dp_kernel`,
            `attn_kernel` and `mk_kernel` raise JAX's ValueError.

    The server's `step_fn` passes keyword options on to `engine.step`: serve
    the int8 / bf16-scratch kernels (`int8_hh`, `int8_full`, `xscr_half`,
    which this function does not take, nor does JAX's) with
    `server.step_fn = functools.partial(server.step_fn, int8_hh=True)`.
    """
    if mesh is not None:
        if fused or dp_kernel or attn_kernel or mk_kernel:
            # as JAX's: only the stock step is served over a mesh
            raise ValueError("mesh serving supports the stock step only — "
                             "drop the fused/dp_kernel/attn_kernel/mk_kernel "
                             "flags (or serve single-device with them)")
        if mesh.over_ranks:
            raise ValueError("mesh serving is single-process: build the mesh from "
                             "local devices (make_mesh(devices=[...]))")
        fused = False
    if (isinstance(model.encoder, FreeEncDec)
            and getattr(model, "speaker_net", None) is None):
        raise ValueError(
            "embedding-free TSE conditioning lives in the initial recurrent "
            "state; SessionServer cannot attach per-slot sessions for it")
    model = copy.deepcopy(model)
    if weights is not None:
        model.load_state_dict(weights)
    dt = torch.bfloat16 if half else torch.float32
    if half:
        to_half(model)
    engine = build_engine(model).eval()
    device = next(engine.parameters()).device
    hop = engine.encoder.hop_length
    chunk = max(1, int(round(sr * chunk_ms / 1000.0)) // hop) * hop

    if isinstance(engine, StreamingTSE):
        if dp_kernel or attn_kernel or mk_kernel:
            raise ValueError("dp_kernel/attn_kernel/mk_kernel apply to STFT-domain "
                             "engines; time-domain TSE serving fuses via fused=True")
        check_chunk_frames(engine, chunk, sr)
        has_fused = hasattr(engine.masker, "step_frames_fused")
        if fused and not has_fused:
            raise ValueError(f"fused=True needs a masker with a fused step (SkiM); "
                             f"{type(engine.masker).__name__} has none")
        seg = getattr(engine.masker, "seg_size", None)
        frames = chunk // hop
        if fused in (None, True) and has_fused and seg % frames:
            # the fused step needs whole chunks in a segment; JAX asserts it
            # only at the first tick, which kills the serving thread
            works = ", ".join(f"{f * hop * 1000 / sr:g}" for f in range(1, seg + 1)
                              if seg % f == 0)
            raise ValueError(
                f"the fused SkiM step needs the chunk's {frames} frames to divide "
                f"seg_size {seg}; chunk_ms={chunk_ms:g} does not. Chunk lengths "
                f"that work at hop {hop} and {sr} Hz (ms): {works}")
        if seg is not None and frames % seg:
            warnings.warn(
                f"chunk of {chunk // hop} frames does not cover whole SkiM "
                f"segments (seg_size={seg}): sessions attached mid-serving will "
                "see shifted segment boundaries vs a fresh engine (SkiM's "
                "segment clock is shared across slots). Attach-before-first-tick "
                "serving is unaffected.", stacklevel=2)
        step_kw = (dict(fused=True, dot_dtype=dt) if fused in (None, True) and has_fused
                   else {})
        init_kw = {}
    else:
        step_kw, init_kw = engine_step_options(engine, fused=bool(fused),
                                               dp_kernel=dp_kernel,
                                               attn_kernel=attn_kernel,
                                               mk_kernel=mk_kernel)

    def init_state(n):
        return engine.init_state(n, dt, **init_kw)

    scale = float(pcm16_scale)
    embed_fn = embed_dim = None
    stft_tse = isinstance(engine, StreamingNS) and engine.speaker_net is not None
    if isinstance(engine, StreamingTSE) or stft_tse:
        # a session attaches by its enrollment (or a d-vector): the
        # time-domain and the STFT-domain TSE engines alike
        def embed_fn(enroll):
            with torch.no_grad():
                x = torch.as_tensor(np.asarray(enroll, np.float32), device=device)
                return engine.embed(x.to(dt)).float()

        probe = embed_fn(np.zeros((1, enroll_len or 5 * sr), np.float32))
        embed_dim = int(probe.shape[-1])

    def make_step(engine, device):
        """The server's step on `engine`, whose device is `device`."""
        if pcm16:
            # only int16 crosses the host link: dequantize and quantize on
            # the device, as JAX's wrapper does inside its jit (deploy.py:199-217)
            to_dev = lambda b: (torch.from_numpy(np.ascontiguousarray(b, np.int16))
                                .to(device).float() / scale).to(dt)
            from_dev = lambda y: (y.float() * scale).clamp(-32767.0, 32767.0).to(torch.int16)
        else:
            to_dev = lambda b: torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(
                device=device, dtype=dt)
            from_dev = lambda y: y.float()
        if isinstance(engine, StreamingTSE):
            def step_fn(chunk_b, dvec, st, **options):
                with torch.no_grad():
                    out, st = engine.step(to_dev(chunk_b), dvec.to(dt), st, **step_kw,
                                          **options)
                    return from_dev(out), st
        elif stft_tse:
            def step_fn(chunk_b, dvec, st, **options):
                with torch.no_grad():
                    out, st = engine.step(to_dev(chunk_b), st, dvec.to(dt), **step_kw,
                                          **options)
                    return from_dev(out), st
        elif isinstance(engine, StreamingDSS):
            def step_fn(chunk_b, st, **options):
                with torch.no_grad():
                    out, st = engine.step(to_dev(chunk_b), st, **step_kw, **options)
                    B, M, S = out.shape
                    # interleaved, then quantised under pcm16, as JAX's order
                    return from_dev(out.transpose(1, 2).reshape(B, S * M)), st
        else:
            def step_fn(chunk_b, st, **options):
                with torch.no_grad():
                    out, st = engine.step(to_dev(chunk_b), st, **step_kw, **options)
                    return from_dev(out), st
        return step_fn

    if mesh is None:
        step_fn = make_step(engine, device)
    else:
        # one engine a device (a repeated device shares its replica's
        # module: the step is stateless, the server owns the state)
        engines = {device: engine}
        for d in mesh.along("dp"):
            if d not in engines:
                engines[d] = copy.deepcopy(engine).to(d)
        step_fn = [make_step(engines[d], d) for d in mesh.along("dp")]

    server = SessionServer(step_fn, init_state(n_slots), n_slots, chunk,
                           embed_dim, infer_slot_axes(init_state),
                           embed_fn=embed_fn, lockstep=lockstep,
                           ring_capacity=ring_capacity, pipelined=pipelined,
                           pcm16=pcm16, pcm16_scale=scale, mesh=mesh)
    return ServingBundle(server=server, engine=engine, chunk_samples=chunk,
                         embed_fn=embed_fn, embed_dim=embed_dim,
                         n_sources=getattr(engine, "n_sources", 1))


def run_serve(model, weights: Optional[dict], n_slots: int, host: str = "0.0.0.0",
              port: int = 7654, stats_every_s: float = 10.0, stop_event=None,
              on_started=None, **kw) -> None:
    """The recipes' `--action serve`: build the SessionServer
    (make_session_server's keywords pass through), open the TCP front, and
    print the `[serve]` telemetry lines every `stats_every_s` until Ctrl-C,
    or until `stop_event` is set; `on_started(front, bundle)` and
    `stop_event` let a test or an embedding program drive the live server."""
    import time

    from .socket_server import SocketServingFront

    bundle = make_session_server(model, weights, n_slots, **kw)
    front = SocketServingFront(bundle.server, host=host, port=port,
                               n_sources=bundle.n_sources).start()
    addr = front.address
    if on_started is not None:
        on_started(front, bundle)
    mode = ("TSE (per-session enrollment)" if bundle.embed_fn else
            f"SIMO x{bundle.n_sources}" if bundle.n_sources > 1 else "NS")
    print(f"[serve] {mode} on {addr[0]}:{addr[1]} — {n_slots} slots, "
          f"{bundle.chunk_samples} samples/tick "
          f"({bundle.chunk_samples / (kw.get('sr', 16000) / 1000.0):.1f} ms)", flush=True)
    try:
        while stop_event is None or not stop_event.is_set():
            time.sleep(stats_every_s if stop_event is None else 0.05)
            if stop_event is None:
                s = bundle.server.stats.snapshot()
                print(f"[serve] active={bundle.server.n_active}/{n_slots} "
                      f"ticks={s['ticks']} p50={s['tick_ms_p50']:.2f}ms "
                      f"p99={s['tick_ms_p99']:.2f}ms "
                      f"underruns={s['underrun_slot_ticks']}", flush=True)
    except KeyboardInterrupt:
        print("[serve] shutting down", flush=True)
    finally:
        front.stop()
