"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source in `puresound_tpu_torch/csrc/` becomes one shared library with
a plain C interface under `build/puresound_tpu_torch/` at the checkout
root. It is built at first use and rebuilt when the source, or a shared
`.cuh` header beside it, is newer than the library; a failed build raises with nvcc's stderr. `build` starts one
nvcc per stale source, all at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "puresound_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: seconds each library took to build in this process (0.0 when it was
#: already up to date on disk)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit's "
                       "bin/ on PATH)")


def _paths(name: str) -> Tuple[str, str]:
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def build(names: Sequence[str]) -> None:
    """Build the stale libraries among `names`, one nvcc each, in parallel."""
    procs = {}
    for name in names:
        src, out = _paths(name)
        newest = max([os.path.getmtime(src)] + [
            os.path.getmtime(os.path.join(CSRC, h)) for h in os.listdir(CSRC)
            if h.endswith(".cuh")])
        if os.path.exists(out) and os.path.getmtime(out) >= newest:
            build_seconds.setdefault(name, 0.0)
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       time.perf_counter(), tmp, out, src)
    failed = []
    for name, (proc, t0, tmp, out, src) in procs.items():
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src} (exit {proc.returncode}):\n"
                          f"{stderr}")
            continue
        os.replace(tmp, out)
        build_seconds[name] = time.perf_counter() - t0
        # ptxas -v: registers / shared memory / spills per kernel
        with open(os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt"), "w") as f:
            f.write(stderr)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> List[Tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes) per kernel
    from the last build's `ptxas -v` output."""
    path = os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt")
    rows, kernel, spills = [], None, (0, 0)
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                mangled = m.group(1)
                short = re.search(r"[a-z]+(?:_[a-z0-9]+)*_(?:kernel|reduce|cluster|prod)", mangled)
                kernel = short.group(0) if short else mangled
                if "bfloat16" in mangled:
                    kernel += "<bf16>"
                elif "IfE" in mangled:
                    kernel += "<f32>"
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel is not None:
                rows.append((kernel, int(m.group(1)), *spills))
                kernel, spills = None, (0, 0)
    return rows
