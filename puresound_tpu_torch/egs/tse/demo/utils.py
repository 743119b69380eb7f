"""Streaming demo nets: a speaker embedding and chunked TSE inference on the
port's `StreamingTSE` (counterpart of egs/tse/demo/utils.py).

Both are thin wrappers over the batched engine: a chunk goes through one
`StreamingTSE.step` (the unfused step: its LSTMs on `lstm_scan_train_fp`),
with JAX's latency semantics (the encoder's zero-primed 2-hop window, sum
overlap-add). The engine runs on its parameters' device.
"""
from __future__ import annotations

import numpy as np
import torch


def _device(engine) -> torch.device:
    return next(engine.parameters()).device


def _dtype(engine) -> torch.dtype:
    return next(engine.parameters()).dtype


class DemoSpeakerNet:
    """A speaker embedding from enrollment audio."""

    def __init__(self, engine):
        self.engine = engine

    def get_speaker_embedding(self, wav: np.ndarray) -> np.ndarray:
        """wav (any shape, one channel) -> [1, E]."""
        x = torch.as_tensor(np.asarray(wav).reshape(1, -1), dtype=_dtype(self.engine),
                            device=_device(self.engine))
        with torch.no_grad():
            return self.engine.embed(x).cpu().numpy()


class DemoTseNet:
    """Chunked streaming TSE: feed fixed-size chunks (a multiple of the hop),
    receive the enhanced chunks."""

    def __init__(self, engine, batch: int = 1):
        self.engine = engine
        self.reset(batch)

    def reset(self, batch: int = 1):
        self.state = self.engine.init_state(batch, _dtype(self.engine))

    def streaming_inference_chunk(self, chunk: np.ndarray, embed: np.ndarray) -> np.ndarray:
        """chunk [S] or [1, S], embed [1, E] -> [1, S]."""
        dev, dt = _device(self.engine), _dtype(self.engine)
        x = torch.as_tensor(np.asarray(chunk).reshape(1, -1), dtype=dt, device=dev)
        e = torch.as_tensor(np.asarray(embed), dtype=dt, device=dev)
        with torch.no_grad():
            out, self.state = self.engine.step(x, e, self.state)
        return out.cpu().numpy()


def overlap_add(chunks, hop: int) -> np.ndarray:
    """Sample-domain overlap-add of [*, W] frames at stride hop."""
    chunks = [np.asarray(c).reshape(-1) for c in chunks]
    W = chunks[0].shape[-1]
    out = np.zeros(hop * (len(chunks) - 1) + W, np.float32)
    for i, c in enumerate(chunks):
        out[i * hop:i * hop + W] += c
    return out
