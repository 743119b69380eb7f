"""Streaming-engine helpers (counterpart of puresound_tpu/streaming/file_eval.py:20-66,
160-186): the output delay, the kernel flags' validation, and the engine
matching an offline wrapper. `stream_signal` (the file-streaming CLI) is
not ported yet (ROADMAP queue 1 item 8)."""
from __future__ import annotations

from ..nnet.dparn import _DPARNBase
from ..nnet.encoder import ConvEncDec, FreeEncDec
from .engine import StreamingTSE
from .ns_engine import StreamingNS


def engine_delay_samples(engine) -> int:
    """Samples by which the streamed output lags the input (to trim)."""
    if isinstance(engine, StreamingNS):
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
    if (fused or dp_kernel or mk_kernel) and not isinstance(engine, StreamingNS):
        raise ValueError("fused/dp_kernel/mk_kernel apply to STFT-domain engines "
                         f"(StreamingNS), not {type(engine).__name__}")
    if dp_kernel and not hasattr(engine.masker, "bottleneck_kernel_chunk"):
        raise ValueError("dp_kernel requires a DPCRN masker "
                         f"(got {type(engine.masker).__name__})")
    if mk_kernel and not hasattr(engine.masker, "center_kernel_chunk"):
        raise ValueError("mk_kernel requires a DPCRN or DPARN masker "
                         f"(got {type(engine.masker).__name__})")
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


def build_engine(model):
    """The streaming engine over an offline SoTaskWrapModule's submodules."""
    if isinstance(model.encoder, ConvEncDec):
        return StreamingNS.from_offline(model)
    if isinstance(model.encoder, FreeEncDec):
        return StreamingTSE.from_offline(model)
    raise TypeError("no streaming engine for this encoder type")
