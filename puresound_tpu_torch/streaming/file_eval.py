"""File-based streaming evaluation (counterpart of
puresound_tpu/streaming/file_eval.py): run a waveform through a streaming
engine in real-time-sized chunks and report the real-time factor
(`stream_signal`, the recipes' `stream_eval`), the output delay, the kernel
flags' validation, and the engine matching an offline wrapper: StreamingTSE,
StreamingNS (with the speaker net of an STFT-domain TSE model, whose
d-vector `stream_signal` passes to every step), or StreamingDSS for a SIMO
wrapper."""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..nnet.base_nn import SiMoTaskWrapModule
from ..nnet.dparn import _DPARNBase
from ..nnet.dual_path_streaming import DualPathStreaming
from ..nnet.encoder import ConvEncDec, FreeEncDec
from .engine import StreamingTSE
from .halfprec import to_half
from .ns_engine import StreamingNS
from .simo_engine import StreamingDSS

#: the STFT-domain engines, which take the kernel-route flags
_STFT_ENGINES = (StreamingNS, StreamingDSS)


def engine_delay_samples(engine) -> int:
    """Samples by which the streamed output lags the input (to trim)."""
    if isinstance(engine, _STFT_ENGINES):
        hop = engine.encoder.hop_length
        mask_delay = getattr(engine.masker, "stream_delay_frames", 0)
        return (engine.encoder.fft_length - hop) + mask_delay * hop
    # time-domain engines align with the zero-primed offline signal
    return 0


def engine_step_options(engine, fused: bool = False, dp_kernel: bool = False,
                        attn_kernel: bool = False, mk_kernel: bool = False):
    """Check the kernel flags against the engine and turn them into
    (step kwargs, init_state kwargs). attn_kernel (a DPARN masker) combines
    with fused; fused, dp_kernel (DPCRN) and mk_kernel (DPCRN or DPARN)
    exclude each other. As in JAX, dp_kernel / mk_kernel drop attn_kernel:
    their kernels run the whole bottleneck."""
    if sum(map(bool, (fused, dp_kernel, mk_kernel))) > 1:
        raise ValueError("fused / dp_kernel / mk_kernel are mutually exclusive "
                         "(each already fuses the bottleneck)")
    if (fused or dp_kernel or mk_kernel) and not isinstance(engine, _STFT_ENGINES):
        raise ValueError("fused/dp_kernel/mk_kernel apply to STFT-domain engines "
                         f"(StreamingNS/StreamingDSS), not {type(engine).__name__}")
    if dp_kernel and not hasattr(engine.masker, "bottleneck_kernel_chunk"):
        raise ValueError("dp_kernel requires a DPCRN masker "
                         f"(got {type(engine.masker).__name__})")
    if mk_kernel and not hasattr(engine.masker, "center_kernel_chunk"):
        raise ValueError("mk_kernel requires a DPCRN or DPARN masker "
                         f"(got {type(engine.masker).__name__})")
    if ((fused or attn_kernel) and isinstance(engine, StreamingNS)
            and not isinstance(engine.masker, DualPathStreaming)):
        raise ValueError("fused / attn_kernel apply to DPCRN / DPARN maskers, not "
                         f"{type(engine.masker).__name__}")
    if attn_kernel and not isinstance(engine.masker, _DPARNBase):
        raise ValueError("attn_kernel requires a DPARN masker "
                         f"(got {type(engine.masker).__name__})")
    if dp_kernel:
        return {"dp_kernel": True}, {"dp_kernel": True}
    if mk_kernel:
        return {"mk_kernel": True}, {"mk_kernel": True}
    kw = {"fused": True} if fused else {}
    if attn_kernel:
        kw["attn_kernel"] = True
    return kw, {}


def check_chunk_frames(engine, chunk: int, sr: int) -> None:
    """Raise a ValueError, naming the chunk lengths that work, where the
    engine's masker cannot step `chunk` samples: a DPRNN chunk must be a
    whole number of segments (JAX asserts it at the first step,
    puresound_tpu/nnet/dprnn.py:172)."""
    ok = getattr(engine.masker, "chunk_frames_ok", None)
    hop = engine.encoder.hop_length
    if ok is None or ok(chunk // hop):
        return
    seg = engine.masker.seg_size
    works = ", ".join(f"{k * seg * hop * 1000 / sr:g}" for k in range(1, 5))
    raise ValueError(f"a {type(engine.masker).__name__} chunk must be a whole number of "
                     f"segments of {seg} frames; {chunk // hop} frames ({chunk} samples) is "
                     f"not. Chunk lengths that work at hop {hop} and {sr} Hz (ms): {works}, ...")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_signal(engine, wav: np.ndarray, sr: int, chunk_ms: float = 16.0,
                  dvec: Optional[torch.Tensor] = None, half: bool = False,
                  fused: bool = False, dp_kernel: bool = False,
                  attn_kernel: bool = False, mk_kernel: bool = False
                  ) -> Tuple[np.ndarray, float]:
    """Stream `wav` [L] through `engine` chunk by chunk, on the engine's
    device (JAX's `:69-157`).

    Returns (enhanced [L] aligned with the input, [M, L] for a SIMO
    engine, and the real-time factor: audio
    seconds over wall seconds, > 1 faster than real time). One warm-up step
    on zeros runs first; the file then streams from a fresh state. The
    timed loop starts and ends with the card synchronised, so the RTF holds
    the device's time, not only the host's queueing.

    half=True streams in bfloat16: `to_half` casts the engine's float32
    weights in place (hand it a copy to keep the float32 ones) and `dvec`
    is cast. fused / dp_kernel / attn_kernel / mk_kernel pick the STFT
    engines' kernel routes (`engine_step_options`); a TSE engine takes the
    unfused step, as JAX's does.
    """
    device = next(engine.parameters()).device
    hop = engine.encoder.hop_length
    chunk = max(1, int(round(sr * chunk_ms / 1000.0)) // hop) * hop
    if isinstance(engine, StreamingTSE):
        check_chunk_frames(engine, chunk, sr)
    delay = engine_delay_samples(engine)
    wav = np.asarray(wav, np.float32).reshape(-1)
    L = wav.shape[0]
    n_chunks = -(-(L + delay) // chunk)
    dt = torch.bfloat16 if half else torch.float32
    if half:
        to_half(engine)
        if dvec is not None:
            dvec = dvec.to(dt)
    x = np.zeros((1, n_chunks * chunk), np.float32)
    x[0, :L] = wav
    x = torch.from_numpy(x).to(device)

    kw, init_kw = engine_step_options(engine, fused=fused, dp_kernel=dp_kernel,
                                      attn_kernel=attn_kernel, mk_kernel=mk_kernel)
    if isinstance(engine, StreamingNS):
        run = lambda c, s: engine.step(c, s, dvec, **kw)
    elif isinstance(engine, StreamingDSS):
        run = lambda c, s: engine.step(c, s, **kw)
    elif isinstance(engine, StreamingTSE):
        run = lambda c, s: engine.step(c, dvec, s)
    else:
        raise TypeError(f"unknown streaming engine {type(engine)}")
    init_state = lambda: engine.init_state(1, dt, device, **init_kw)

    with torch.inference_mode():
        run(torch.zeros((1, chunk), dtype=dt, device=device), init_state())
        state = init_state()
        outs = []
        _sync(device)
        t0 = time.perf_counter()
        for i in range(n_chunks):
            y, state = run(x[:, i * chunk:(i + 1) * chunk].to(dt), state)
            outs.append(y)
        _sync(device)
        elapsed = time.perf_counter() - t0
        out = torch.cat(outs, dim=-1)[0].float().cpu().numpy()
    rtf = (n_chunks * chunk / sr) / max(elapsed, 1e-9)
    return out[..., delay:delay + L], rtf


def build_engine(model):
    """The streaming engine over an offline wrapper's submodules:
    StreamingDSS for a SiMoTaskWrapModule, else by the encoder."""
    if isinstance(model, SiMoTaskWrapModule):
        return StreamingDSS.from_offline(model)
    if isinstance(model.encoder, ConvEncDec):
        return StreamingNS.from_offline(model)
    if isinstance(model.encoder, FreeEncDec):
        return StreamingTSE.from_offline(model)
    raise TypeError("no streaming engine for this encoder type")
