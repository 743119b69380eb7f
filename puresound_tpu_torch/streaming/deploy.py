"""One-call deployment: TSE model -> ready-to-tick SessionServer.

Counterpart of puresound_tpu/streaming/deploy.py:40 (`make_session_server`),
the time-domain TSE branch. The server owns a copy of the model (cast to
bfloat16 when `half`), so the caller's module is never changed.
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
from .halfprec import to_half
from .server import SessionServer, infer_slot_axes

__all__ = ["ServingBundle", "make_session_server"]


@dataclass
class ServingBundle:
    """Everything a serving front-end needs."""

    server: SessionServer
    engine: StreamingTSE
    chunk_samples: int
    embed_fn: Callable
    embed_dim: int


def make_session_server(model, weights: Optional[dict], n_slots: int,
                        chunk_ms: float = 16.0, sr: int = 16000,
                        half: bool = False, fused: bool = True,
                        enroll_len: Optional[int] = None, mesh=None,
                        pipelined: bool = False, lockstep: bool = False,
                        ring_capacity: int = 1 << 16,
                        pcm16: bool = False) -> ServingBundle:
    """Build a SessionServer for a TSE SoTaskWrapModule.

    Args:
        model: the offline wrapper (its device is the serving device).
        weights: a state_dict loaded into the server's copy of the model
            (e.g. `utils.from_jax.from_jax(variables)`), or None to serve
            the model's own weights.
        n_slots: fixed concurrent-session capacity (the step's batch).
        chunk_ms: tick size, rounded down to a hop multiple.
        half: serve in bfloat16 (weights, state and the kernel's dots); the
            hub surface stays float32.
        fused: run the SkiM stack through `fused_skim_frames` (the CUDA
            kernel on a CUDA model, its plain version on the CPU).
        enroll_len: enrollment length (samples) of the probe that reads the
            embedding width (default 5 s).
        mesh / pipelined / pcm16: not ported yet (raise).
    """
    if mesh is not None or pipelined or pcm16:
        raise NotImplementedError(
            "mesh / pipelined / pcm16 serving is not ported yet (ROADMAP "
            "queue 1: serving options)")
    if not isinstance(model.encoder, FreeEncDec):
        raise NotImplementedError(
            "only time-domain TSE engines are ported (ROADMAP queue 1: NS / "
            "DSS engines)")
    if model.speaker_net is None:
        raise ValueError(
            "embedding-free TSE conditioning lives in the initial recurrent "
            "state; SessionServer cannot attach per-slot sessions for it")
    model = copy.deepcopy(model)
    if weights is not None:
        model.load_state_dict(weights)
    dt = torch.bfloat16 if half else torch.float32
    if half:
        to_half(model)
    engine = StreamingTSE.from_offline(model).eval()
    device = engine.encoder.decoder.weight.device

    hop = engine.encoder.hop_length
    chunk = max(1, int(round(sr * chunk_ms / 1000.0)) // hop) * hop
    seg = engine.masker.seg_size
    if (chunk // hop) % seg:
        warnings.warn(
            f"chunk of {chunk // hop} frames does not cover whole SkiM "
            f"segments (seg_size={seg}): sessions attached mid-serving will "
            "see shifted segment boundaries vs a fresh engine (SkiM's "
            "segment clock is shared across slots). Attach-before-first-tick "
            "serving is unaffected.", stacklevel=2)
    step_kw = dict(fused=True, dot_dtype=dt) if fused else {}

    def embed_fn(enroll):
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(enroll, np.float32), device=device)
            return engine.embed(x.to(dt)).float()

    probe = embed_fn(np.zeros((1, enroll_len or 5 * sr), np.float32))
    embed_dim = int(probe.shape[-1])

    def step_fn(chunk_b, dvec, st):
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(chunk_b, np.float32))
            out, st = engine.step(x.to(device=device, dtype=dt), dvec.to(dt),
                                  st, **step_kw)
            return out.float(), st

    def init_state(n):
        return engine.init_state(n, dt)

    server = SessionServer(step_fn, init_state(n_slots), n_slots, chunk,
                           embed_dim, infer_slot_axes(init_state),
                           embed_fn=embed_fn, lockstep=lockstep,
                           ring_capacity=ring_capacity)
    return ServingBundle(server=server, engine=engine, chunk_samples=chunk,
                         embed_fn=embed_fn, embed_dim=embed_dim)
