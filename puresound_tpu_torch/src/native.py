"""Loader of the repository's C++ host library (csrc/, the ring hub).

The same `csrc/libpuresound_audio.so` that puresound_tpu/src/native.py
loads, found and built (`make -C csrc`) here so that this package never
imports the JAX package. Nothing runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
LIB_PATH = os.path.join(CSRC, "libpuresound_audio.so")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(name.endswith(".cpp")
               and os.path.getmtime(os.path.join(CSRC, name)) > built
               for name in os.listdir(CSRC))


def load() -> ctypes.CDLL:
    """The library handle, built first when missing or older than a
    source. Raises with make's output when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                proc = subprocess.run(["make", "-C", CSRC],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"make -C {CSRC} failed:\n"
                                       f"{proc.stdout}\n{proc.stderr}")
            _lib = ctypes.CDLL(LIB_PATH)
        return _lib
