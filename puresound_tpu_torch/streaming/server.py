"""Streaming serving loop: native ring-buffer hub + batched device step.

Counterpart of puresound_tpu/streaming/server.py. Client threads push and
pop audio through the C++ per-stream rings (csrc/stream_runtime.cpp, loaded
by puresound_tpu_torch.src.native); the serving thread gathers a fixed
[n_slots, chunk] batch, runs one step on the device, and scatters the
output. A slot without a full chunk contributes zeros for that tick and
its output is withheld.
"""
from __future__ import annotations

import collections
import ctypes
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..src import native as _native
from ..utils.tree import tree_leaves, tree_map


def _to_numpy(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.detach().float().cpu().numpy()
    return np.asarray(out)


class StreamHub:
    """ctypes wrapper over the native per-stream ring-buffer hub."""

    def __init__(self, n_streams: int, ring_capacity: int = 1 << 16):
        lib = _native.load()
        self._lib = lib
        self._bind(lib)
        self.n_streams = n_streams
        self._hub = lib.hub_create(n_streams, ring_capacity)

    @staticmethod
    def _bind(lib):
        if getattr(lib, "_hub_bound", False):
            return
        c = ctypes
        f32p = c.POINTER(c.c_float)
        lib.hub_create.argtypes = [c.c_int, c.c_size_t]
        lib.hub_create.restype = c.c_void_p
        lib.hub_destroy.argtypes = [c.c_void_p]
        lib.hub_push_input.argtypes = [c.c_void_p, c.c_int, f32p, c.c_int64]
        lib.hub_push_input.restype = c.c_int64
        lib.hub_pop_output.argtypes = [c.c_void_p, c.c_int, f32p, c.c_int64]
        lib.hub_pop_output.restype = c.c_int64
        lib.hub_input_available.argtypes = [c.c_void_p, c.c_int]
        lib.hub_input_available.restype = c.c_int64
        lib.hub_output_available.argtypes = [c.c_void_p, c.c_int]
        lib.hub_output_available.restype = c.c_int64
        lib.hub_gather.argtypes = [c.c_void_p, c.c_int64, f32p,
                                   c.POINTER(c.c_int8)]
        lib.hub_gather.restype = c.c_int
        lib.hub_scatter.argtypes = [c.c_void_p, c.c_int64, f32p,
                                    c.POINTER(c.c_int8)]
        lib.hub_reset_stream.argtypes = [c.c_void_p, c.c_int]
        lib._hub_bound = True

    def __del__(self):
        if getattr(self, "_hub", None):
            self._lib.hub_destroy(self._hub)
            self._hub = None

    @staticmethod
    def _fptr(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def push_input(self, stream_id: int, samples: np.ndarray) -> int:
        samples = np.ascontiguousarray(samples, np.float32).reshape(-1)
        return int(self._lib.hub_push_input(self._hub, stream_id,
                                            self._fptr(samples), len(samples)))

    def pop_output(self, stream_id: int, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        got = int(self._lib.hub_pop_output(self._hub, stream_id,
                                           self._fptr(out), n))
        return out[:got]

    def input_available(self, stream_id: int) -> int:
        return int(self._lib.hub_input_available(self._hub, stream_id))

    def output_available(self, stream_id: int) -> int:
        return int(self._lib.hub_output_available(self._hub, stream_id))

    def reset_stream(self, stream_id: int):
        """Drop everything buffered in one stream's rings (slot reuse)."""
        self._lib.hub_reset_stream(self._hub, stream_id)

    def gather(self, chunk: int):
        batch = np.empty((self.n_streams, chunk), np.float32)
        mask = np.empty(self.n_streams, np.int8)
        ready = int(self._lib.hub_gather(
            self._hub, chunk, self._fptr(batch),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))))
        return batch, mask.astype(bool), ready

    def scatter(self, batch: np.ndarray, mask: np.ndarray):
        batch = np.ascontiguousarray(batch, np.float32)
        m = np.ascontiguousarray(mask.astype(np.int8))
        self._lib.hub_scatter(self._hub, batch.shape[1], self._fptr(batch),
                              m.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))


class ServeStats:
    """Rolling tick latency percentiles + underrun slot-ticks (an ACTIVE
    session that had no full chunk buffered when the batch stepped)."""

    def __init__(self, window: int = 4096):
        self._lat = collections.deque(maxlen=window)
        self._lock = threading.Lock()
        self.ticks = 0
        self.underrun_slot_ticks = 0

    def record(self, seconds: float, n_late: int = 0):
        with self._lock:
            self._lat.append(seconds)
            self.ticks += 1
            self.underrun_slot_ticks += int(n_late)

    def snapshot(self) -> dict:
        with self._lock:
            lat = list(self._lat)
        lat = np.sort(np.asarray(lat, np.float64))
        q = (lambda p: float(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3)
             ) if len(lat) else (lambda p: 0.0)
        return {"ticks": self.ticks,
                "underrun_slot_ticks": self.underrun_slot_ticks,
                "tick_ms_p50": q(0.50), "tick_ms_p95": q(0.95),
                "tick_ms_p99": q(0.99),
                "tick_ms_max": float(lat[-1] * 1e3) if len(lat) else 0.0}


class StreamingServer:
    """Fixed-slot serving loop around a state-carrying step closure
    step_fn(chunk_batch [B, S]) -> out [B, S]."""

    def __init__(self, step_fn, n_streams: int, chunk_samples: int,
                 ring_capacity: int = 1 << 16, lockstep: bool = False):
        self.hub = StreamHub(n_streams, ring_capacity)
        self.step_fn = step_fn
        self.chunk = chunk_samples
        self.n_streams = n_streams
        self.lockstep = lockstep
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        self.stats = ServeStats()
        self.failure: Optional[BaseException] = None

    def tick(self) -> int:
        """gather -> device step -> scatter; returns the streams served."""
        if self.lockstep and any(self.hub.input_available(i) < self.chunk
                                 for i in range(self.n_streams)):
            return 0
        t0 = time.perf_counter()
        batch, mask, ready = self.hub.gather(self.chunk)
        if ready == 0:
            return 0
        self.hub.scatter(_to_numpy(self.step_fn(batch)), mask)
        self.ticks += 1
        self.stats.record(time.perf_counter() - t0)
        return ready

    def run(self, poll_s: float = 0.001):
        """Blocking serve loop (call stop() from another thread)."""
        try:
            while not self._stop.is_set():
                if self.tick() == 0:
                    time.sleep(poll_s)
        except BaseException as e:
            # a dead loop must not keep ACKing sessions it will never serve
            self.failure = e
            self._stop.set()
            raise

    def start(self):
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def infer_slot_axes(init_state, b1: int = 2, b2: int = 3):
    """Per-leaf slot axes of a state layout, found by building the state at
    two slot counts and diffing shapes (-1: a leaf shared by all slots)."""
    s1, s2 = init_state(b1), init_state(b2)

    def ax(a, b):
        if not isinstance(a, torch.Tensor) or a.shape == b.shape:
            return -1
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        ok = (a.dim() == b.dim() and len(diffs) == 1
              and a.shape[diffs[0]] % b1 == 0
              and a.shape[diffs[0]] // b1 == b.shape[diffs[0]] // b2)
        if not ok:
            raise ValueError(f"cannot infer slot axis: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)} at counts ({b1}, {b2})")
        return diffs[0]

    return tree_map(ax, s1, s2)


def _axes_state_reset(slot_axes):
    """Masked per-slot reset with explicit slot axes. A leaf without a slot
    axis (the shared SkiM clock) resets only when every slot resets."""

    def reset(state, fresh, mask: np.ndarray):
        masks = {}

        def w(ax, s, f):
            if ax < 0:
                return f if mask.all() else s
            rep = s.shape[ax] // mask.shape[0]  # slot-major folded axis
            key = (rep, s.device)
            if key not in masks:
                masks[key] = torch.from_numpy(np.repeat(mask, rep)).to(s.device)
            m = masks[key].reshape((1,) * ax + (-1,) + (1,) * (s.dim() - ax - 1))
            return torch.where(m, f, s)

        return tree_map(w, slot_axes, state, fresh)

    return reset


class SessionServer(StreamingServer):
    """Dynamic sessions on the fixed-slot loop.

    step_fn(chunk [B, S] numpy, dvec [B, E] tensor, state) -> (out [B, S],
    state) is stateless; the server owns the state. `fresh_state` is the
    engine's init_state(n_slots) and `slot_axes` its `infer_slot_axes`. A
    slot's state is reset at its session's first ready tick, so a session
    that joins mid-serving gets the output of a fresh engine fed the same
    audio. Each TSE session carries its own d-vector row
    (attach(dvec=...) or attach(enroll=...) via embed_fn).

    SkiM's segment clock is shared by all slots: a chunk that covers whole
    segments keeps mid-serving attaches exact.
    """

    def __init__(self, step_fn, fresh_state, n_slots: int, chunk_samples: int,
                 embed_dim: int, slot_axes, embed_fn=None,
                 ring_capacity: int = 1 << 16, lockstep: bool = False):
        super().__init__(step_fn, n_slots, chunk_samples,
                         ring_capacity=ring_capacity, lockstep=lockstep)
        tensors = [t for t in tree_leaves(fresh_state)
                   if isinstance(t, torch.Tensor)]
        self.device = tensors[0].device if tensors else torch.device("cpu")
        self._fresh = fresh_state
        self._state = fresh_state
        self._embed_fn = embed_fn
        self._reset = _axes_state_reset(slot_axes)
        self._dvec = np.zeros((n_slots, embed_dim), np.float32)
        self._dvec_dev = self._put_rows(self._dvec)
        self._dvec_dirty = False
        self._active = np.zeros(n_slots, bool)
        self._pending_reset = np.zeros(n_slots, bool)
        # per-slot session generation: an output computed for a slot's
        # previous occupant never reaches a session attached meanwhile
        self._gen = np.zeros(n_slots, np.int64)
        self._lock = threading.Lock()

    def _put_rows(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr)).to(self.device)

    # ------------------------------------------------------------- lifecycle
    def attach(self, enroll=None, dvec=None) -> int:
        """Claim a free slot; returns the slot id for push/pop."""
        if self.failure is not None:
            raise RuntimeError(
                f"serving loop died: {self.failure!r}") from self.failure
        # embed outside the lock: tick() needs it every tick
        if dvec is None:
            if enroll is None or self._embed_fn is None:
                raise ValueError("TSE session needs dvec= or enroll= "
                                 "(with embed_fn)")
            dvec = _to_numpy(self._embed_fn(
                np.asarray(enroll, np.float32)[None]))[0]
        with self._lock:
            free = np.flatnonzero(~self._active)
            if len(free) == 0:
                raise RuntimeError("no free stream slots")
            sid = int(free[0])
            self._dvec[sid] = np.asarray(dvec, np.float32)
            self._dvec_dirty = True  # uploaded at the next tick
            self.hub.reset_stream(sid)
            self._pending_reset[sid] = True
            self._active[sid] = True
            self._gen[sid] += 1
            return sid

    def detach(self, sid: int):
        """Release a slot. The client must have stopped feeding it."""
        with self._lock:
            self._active[sid] = False
            self._pending_reset[sid] = False
            self.hub.reset_stream(sid)

    # ------------------------------------------------------------------ tick
    def tick(self) -> int:
        with self._lock:
            active = self._active.copy()
            if self.lockstep and any(
                    self.hub.input_available(i) < self.chunk
                    for i in np.flatnonzero(active)):
                return 0
            t0 = time.perf_counter()
            batch, mask, _ = self.hub.gather(self.chunk)
            mask &= active
            if not mask.any():
                return 0
            reset_now = self._pending_reset & mask
            self._pending_reset &= ~mask
            if self._dvec_dirty:
                self._dvec_dev = self._put_rows(self._dvec)
                self._dvec_dirty = False
            dvec = self._dvec_dev
            gen = self._gen.copy()
            n_late = int((active & ~mask).sum())
        if reset_now.any():
            self._state = self._reset(self._state, self._fresh, reset_now)
        out, self._state = self.step_fn(batch, dvec, self._state)
        out = _to_numpy(out)
        with self._lock:
            # a slot detached (or re-attached) while the step ran gets no
            # output
            mask = mask & self._active & (self._gen == gen)
            self.hub.scatter(out, mask)
        self.ticks += 1
        self.stats.record(time.perf_counter() - t0, n_late=n_late)
        return int(mask.sum())

