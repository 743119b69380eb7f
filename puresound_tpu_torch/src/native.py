"""Loader of the repository's C++ host library (csrc/): the ring hub, the
audio decoders, the polyphase resampler and the biquad filter.

The same `csrc/libpuresound_audio.so` that puresound_tpu/src/native.py
loads, found and built (`make -C csrc`) here so that this package never
imports the JAX package. Nothing runs at import time. This is host I/O for
the data pipeline, not the device.

Several processes may load at once (test workers, loader workers, the JAX
package's own loader running the same `make`). The check-and-build runs
under an exclusive `fcntl` lock on `build/native/native.lock`, so one
process builds and the others wait for it; each process then loads a
private copy of the library, taken whole (copied, its size and mtime the
same before and after, then renamed into place), so a `make` that another
loader runs meanwhile cannot hand it a half-written file. A build that
fails raises with make's output, and every later call raises it again; a
copy caught mid-write is taken again.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(ROOT, "csrc")
LIB_PATH = os.path.join(CSRC, "libpuresound_audio.so")
#: the lock file and the private copies (git-ignored)
PRIVATE_DIR = os.path.join(ROOT, "build", "native")
COPY_ATTEMPTS = 20

_lib: Optional[ctypes.CDLL] = None
_error: Optional[Exception] = None   # a failed build, raised again on every call
_lock = threading.Lock()


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(name.endswith(".cpp")
               and os.path.getmtime(os.path.join(CSRC, name)) > built
               for name in os.listdir(CSRC))


def _bind_audio(lib: ctypes.CDLL) -> None:
    for name in ("decode_flac", "decode_wav"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                       ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                       ctypes.POINTER(ctypes.c_int64),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.free_buffer.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.free_buffer.restype = None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.ps_resample_len.argtypes = [ctypes.c_int64] * 3
    lib.ps_resample_len.restype = ctypes.c_int64
    lib.ps_resample_poly_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, f32p]
    lib.ps_resample_poly_f32.restype = ctypes.c_int
    lib.ps_biquad_f32.argtypes = [f32p, f32p, f32p, ctypes.c_int64, f32p]
    lib.ps_biquad_f32.restype = None


def _stat(path: str) -> Tuple[int, int]:
    st = os.stat(path)
    return st.st_size, st.st_mtime_ns


def _private_copy() -> str:
    """A whole copy of the built library for this process: the source's
    size and mtime unchanged across the copy (no writer meanwhile), then
    renamed into place. Raises OSError when no stable copy was taken."""
    private = os.path.join(PRIVATE_DIR, f"libpuresound_audio.{os.getpid()}.so")
    for _ in range(COPY_ATTEMPTS):
        before = _stat(LIB_PATH)
        shutil.copyfile(LIB_PATH, private + ".part")
        if _stat(LIB_PATH) == before == (os.path.getsize(private + ".part"), before[1]):
            os.replace(private + ".part", private)
            return private
        time.sleep(0.1)     # another loader's make is writing it: take it again
    raise OSError(f"{LIB_PATH} kept changing while it was copied")


def _build_and_load() -> ctypes.CDLL:
    """Check and build under the cross-process lock, then load this
    process's private copy (removed once loaded: the mapping stays)."""
    global _error
    os.makedirs(PRIVATE_DIR, exist_ok=True)
    with open(os.path.join(PRIVATE_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _stale():
                proc = subprocess.run(["make", "-C", CSRC], capture_output=True, text=True)
                if proc.returncode != 0:
                    _error = RuntimeError(f"make -C {CSRC} failed:\n"
                                          f"{proc.stdout}\n{proc.stderr}")
                    raise _error
            private = _private_copy()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    try:
        return ctypes.CDLL(private)
    finally:
        os.remove(private)


def load() -> ctypes.CDLL:
    """The library handle, built first when missing or older than a
    source. Raises with make's output when the build fails (and again on
    every later call); a load that fails otherwise is tried afresh on the
    next call."""
    global _lib
    with _lock:
        if _lib is None:
            if _error is not None:
                raise _error
            lib = _build_and_load()
            _bind_audio(lib)
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _decode(fn_name: str, raw: bytes) -> Tuple[np.ndarray, int]:
    lib = load()
    buf = (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw)
    out = ctypes.POINTER(ctypes.c_float)()
    total, channels, sr = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, fn_name)(buf, len(raw), ctypes.byref(out),
                               ctypes.byref(total), ctypes.byref(channels),
                               ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"{fn_name} failed with code {rc}")
    n = total.value * channels.value
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.free_buffer(out)
    return arr.reshape(channels.value, total.value), sr.value


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return _decode("decode_flac", f.read())


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return _decode("decode_wav", f.read())


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly's polyphase resampler (kaiser-5.0 lowpass,
    float32) along the last axis."""
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    ny = lib.ps_resample_len(flat.shape[1], up, down)
    out = np.empty((flat.shape[0], ny), np.float32)
    for r in range(flat.shape[0]):
        rc = lib.ps_resample_poly_f32(flat[r], flat.shape[1], up, down, out[r])
        if rc != 0:
            raise ValueError(f"ps_resample_poly_f32 failed ({rc})")
    return out.reshape(lead + (ny,))


def biquad(b: np.ndarray, a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """lfilter(b, a, x) for an order-2 IIR along the last axis, float32
    (direct form II transposed, zero initial state)."""
    lib = load()
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if a.shape != (3,) or b.shape != (3,):
        raise ValueError("biquad expects 3-tap a/b")
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    x = np.ascontiguousarray(x, np.float32)
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    out = np.empty_like(flat)
    for r in range(flat.shape[0]):
        lib.ps_biquad_f32(b, a, flat[r], flat.shape[1], out[r])
    return out.reshape(lead + (flat.shape[1],))
