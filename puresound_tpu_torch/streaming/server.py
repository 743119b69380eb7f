"""Streaming serving loop: native ring-buffer hub + batched device step.

Counterpart of puresound_tpu/streaming/server.py. Client threads push and
pop audio through the C++ per-stream rings (csrc/stream_runtime.cpp, loaded
by puresound_tpu_torch.src.native); the serving thread gathers a fixed
[n_slots, chunk] batch, runs one step on the device, and scatters the
output. A slot without a full chunk contributes zeros for that tick and
its output is withheld.

SessionServer(mesh=) serves the slot batch over the dp devices of a
single-process mesh (`parallel.make_mesh(devices=...)`; a device may repeat):
each replica holds its contiguous slots' part of the state and of the
d-vectors, and a tick launches every replica's step on its rows before it
reads any output back.

SessionServer(pipelined=True) does not wait for a tick's own output: the
device-to-host copy of tick t goes into a pinned host buffer behind a CUDA
event, and the tick scatters tick t-1's output, so the copy and the ring I/O
of one tick overlap the device work of the next (`flush()` drains the last
one). pcm16=True moves the audio as int16 PCM at `pcm16_scale` both ways;
the caller's step converts on the device (deploy.make_session_server).
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
    """A step output as numpy in its own dtype (bfloat16, which numpy
    lacks, as float32)."""
    if not isinstance(out, torch.Tensor):
        return np.asarray(out)
    t = out.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _HostCopy:
    """A step output on its way to the host in its own dtype: a CUDA tensor
    is copied into one of two pinned buffers behind an event (the buffer of
    the copy before stays readable until this one is taken); anything else
    is converted at once."""

    def __init__(self):
        self._bufs = [None, None]
        self._next = 0

    def start(self, out):
        if not (isinstance(out, torch.Tensor) and out.is_cuda):
            return _to_numpy(out), None
        buf = self._bufs[self._next]
        if buf is None or buf.shape != out.shape or buf.dtype != out.dtype:
            buf = self._bufs[self._next] = torch.empty(out.shape, dtype=out.dtype,
                                                       pin_memory=True)
        self._next ^= 1
        buf.copy_(out.detach(), non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        return buf, event

    @staticmethod
    def finish(pending) -> np.ndarray:
        out, event = pending
        if event is None:
            return out
        event.synchronize()
        return _to_numpy(out)


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
        lib.hub_output_dropped.argtypes = [c.c_void_p, c.c_int]
        lib.hub_output_dropped.restype = c.c_int64
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

    def output_dropped(self, stream_id: int) -> int:
        """Samples `scatter` dropped on this stream's full output ring since
        its last reset (a client that stopped reading)."""
        return int(self._lib.hub_output_dropped(self._hub, stream_id))

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
        """Push row i of batch [n_streams, width] to stream i's output ring
        where mask[i]; the width is the step's output per tick (chunk, or
        chunk * M for M sample-interleaved sources)."""
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
    axis (the shared SkiM clock) resets only when every slot resets
    (`every`: of the whole server, where `mask` is one replica's part)."""

    def reset(state, fresh, mask: np.ndarray, every: Optional[bool] = None):
        masks = {}
        every = mask.all() if every is None else every

        def w(ax, s, f):
            if ax < 0:
                return f if every else s
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
    state) for TSE, step_fn(chunk, state) for an engine without
    conditioning (embed_dim None, e.g. NS; DSS returns [B, S * M], its M
    sources sample-interleaved, and each slot's output ring takes S * M
    samples a tick); it is stateless and the server owns the state. `fresh_state` is the engine's init_state(n_slots) and
    `slot_axes` its `infer_slot_axes`. A slot's state is reset at its
    session's first ready tick, so a session that joins mid-serving gets
    the output of a fresh engine fed the same audio. Each TSE session
    carries its own d-vector row (attach(dvec=...) or attach(enroll=...)
    via embed_fn); an NS session attaches with no argument.

    SkiM's segment clock is shared by all slots: a chunk that covers whole
    segments keeps mid-serving attaches exact. STFT engines carry per-frame
    state only; any hop-multiple chunk works.

    pipelined=True: a tick dispatches its step and scatters the previous
    tick's output (one tick later to the clients, the same values); an idle
    tick drains it, and `flush()` after the last tick. pcm16=True: the
    gathered batch goes to step_fn as int16 (clip(x * pcm16_scale,
    +-32767), truncated), step_fn returns int16, and the output is scaled
    back by 1 / pcm16_scale on the host.

    mesh: a single-process `parallel.Mesh` whose dp devices serve the slots
    (n_slots divisible by the dp size, else a ValueError as JAX's): replica
    i holds slots [i * n / dp, (i + 1) * n / dp), its part of the state (cut
    on `slot_axes` by `parallel.shard_by_slots`) and of the d-vectors on its
    device. `step_fn` is then one callable per replica (each on its
    replica's device), or one callable that follows its inputs' device. A
    tick cuts the gathered batch by rows, launches every replica's step
    before it waits on any, and joins the outputs in slot order; resets and
    attaches reach the replica that holds the slot.
    """

    def __init__(self, step_fn, fresh_state, n_slots: int, chunk_samples: int,
                 embed_dim: Optional[int], slot_axes, embed_fn=None,
                 ring_capacity: int = 1 << 16, lockstep: bool = False,
                 pipelined: bool = False, pcm16: bool = False,
                 pcm16_scale: float = 8192.0, mesh=None):
        super().__init__(step_fn, n_slots, chunk_samples,
                         ring_capacity=ring_capacity, lockstep=lockstep)
        if mesh is None:
            tensors = [t for t in tree_leaves(fresh_state)
                       if isinstance(t, torch.Tensor)]
            self._devices = [tensors[0].device if tensors else torch.device("cpu")]
            self._fresh = [fresh_state]
        else:
            from ..parallel.mesh import shard_by_slots

            n_dp = mesh.shape["dp"]
            if n_slots % n_dp:
                raise ValueError(f"n_slots={n_slots} not divisible by the dp mesh axis "
                                 f"({n_dp})")
            self._fresh = shard_by_slots(mesh, fresh_state, n_slots, slot_axes=slot_axes)
            self._devices = mesh.along("dp")
            if isinstance(step_fn, (list, tuple)) and len(step_fn) != n_dp:
                raise ValueError(f"{len(step_fn)} step functions for {n_dp} replicas")
        self.mesh = mesh
        self.device = self._devices[0]
        self._per = n_slots // len(self._devices)
        self._state = list(self._fresh)
        self._embed_fn = embed_fn
        self._reset = _axes_state_reset(slot_axes)
        self._dvec = (np.zeros((n_slots, embed_dim), np.float32)
                      if embed_dim is not None else None)
        self._dvec_dev = self._put_rows(self._dvec) if self._dvec is not None else None
        self._dvec_dirty = False
        self._active = np.zeros(n_slots, bool)
        self._pending_reset = np.zeros(n_slots, bool)
        # per-slot session generation: an output computed for a slot's
        # previous occupant never reaches a session attached meanwhile
        # (a pipelined output outlives its tick's ownership snapshot)
        self._gen = np.zeros(n_slots, np.int64)
        self._lock = threading.Lock()
        self.pipelined = pipelined
        self._pcm16_scale = float(pcm16_scale) if pcm16 else None
        self._copies = [_HostCopy() for _ in self._devices]
        self._inflight = None  # (pending host copies, mask, gen) of tick t-1

    def _rows(self, i: int) -> slice:
        return slice(i * self._per, (i + 1) * self._per)

    def _put_rows(self, arr: np.ndarray) -> list:
        """Each replica's rows of a host array, on its device."""
        return [torch.from_numpy(np.array(arr[self._rows(i)])).to(d)
                for i, d in enumerate(self._devices)]

    def _step_fns(self) -> list:
        fn = self.step_fn
        return list(fn) if isinstance(fn, (list, tuple)) else [fn] * len(self._devices)

    # ------------------------------------------------------------- lifecycle
    def attach(self, enroll=None, dvec=None) -> int:
        """Claim a free slot; returns the slot id for push/pop."""
        if self.failure is not None:
            raise RuntimeError(
                f"serving loop died: {self.failure!r}") from self.failure
        # embed outside the lock: tick() needs it every tick
        if self._dvec is not None and dvec is None:
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
            if self._dvec is not None:
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

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    # ------------------------------------------------------------------ tick
    def tick(self) -> int:
        idle = False
        with self._lock:
            active = self._active.copy()
            if self.lockstep and any(
                    self.hub.input_available(i) < self.chunk
                    for i in np.flatnonzero(active)):
                idle = True
            else:
                t0 = time.perf_counter()
                batch, mask, _ = self.hub.gather(self.chunk)
                mask &= active
                idle = not mask.any()
            if not idle:
                reset_now = self._pending_reset & mask
                self._pending_reset &= ~mask
                if self._dvec_dirty:
                    self._dvec_dev = self._put_rows(self._dvec)
                    self._dvec_dirty = False
                dvec = self._dvec_dev
                gen = self._gen.copy()
                n_late = int((active & ~mask).sum())
        if idle:
            # nothing to step: still drain a pipelined output, so a paused
            # stream gets its last chunk
            return self.flush() if self.pipelined else 0
        every = bool(reset_now.all())
        for i in range(len(self._devices)):
            part = reset_now[self._rows(i)]
            if part.any():
                self._state[i] = self._reset(self._state[i], self._fresh[i], part, every)
        if self._pcm16_scale is not None:
            batch = np.clip(batch * self._pcm16_scale, -32767.0, 32767.0).astype(np.int16)
        # every replica's step is launched before any output is read back
        outs = []
        for i, fn in enumerate(self._step_fns()):
            rows = batch[self._rows(i)]
            if dvec is None:
                out, self._state[i] = fn(rows, self._state[i])
            else:
                out, self._state[i] = fn(rows, dvec[i], self._state[i])
            outs.append(out)
        pending = ([c.start(o) for c, o in zip(self._copies, outs)], mask, gen)
        if self.pipelined:
            # scatter the last tick's output while the device runs this one
            prev, self._inflight = self._inflight, pending
            n = self._scatter_owned(*prev) if prev is not None else 0
        else:
            n = self._scatter_owned(*pending)
        self.ticks += 1
        self.stats.record(time.perf_counter() - t0, n_late=n_late)
        return n

    def _scatter_owned(self, pending, mask, gen) -> int:
        parts = [_HostCopy.finish(p) for p in pending]
        out = parts[0] if len(parts) == 1 else np.concatenate(parts)
        if self._pcm16_scale is not None:
            out = out.astype(np.float32) * (1.0 / self._pcm16_scale)
        with self._lock:
            # a slot detached (or re-attached: a generation bump) while the
            # step ran gets no output
            mask = mask & self._active & (self._gen == gen)
            self.hub.scatter(out, mask)
        return int(mask.sum())

    def flush(self) -> int:
        """Scatter the pipelined in-flight output (after the last tick)."""
        prev, self._inflight = self._inflight, None
        return self._scatter_owned(*prev) if prev is not None else 0
