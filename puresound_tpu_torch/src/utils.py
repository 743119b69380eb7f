"""Host-side utilities the recipe needs: `str2bool` / `str2list`, the config
loader and writer, the manifest loader, `create_folder`, the corpus folder walk and the
convolutions of the augmentation chain (counterpart of
puresound_tpu/src/utils.py, kept as this package's own copy so that it
never imports the JAX package).
"""
from __future__ import annotations

import io
import json
import math
import os
from typing import Dict, List, Optional

import numpy as np


def str2bool(v: str) -> bool:
    return v.lower() in ("true", "yes")


def str2list(s: str) -> List[str]:
    return s.strip().split()


def load_text_as_dict(file_path: str, separator: str = " ",
                      coding: str = "utf8") -> Dict:
    """Kaldi-style .scp loader: first column keys, rest as list values."""
    dct = {}
    with io.open(file_path, "r", encoding=coding) as f:
        for line in f.readlines():
            parts = line.strip().split(separator)
            dct[parts[0]] = parts[1:]
    return dct


def load_hparam(filename: str) -> Dict:
    """Multi-document YAML -> flat dict. Where PyYAML is not installed, a
    config written in YAML's JSON form (one JSON object) still loads."""
    with open(filename, "r") as stream:
        text = stream.read()
    try:
        import yaml
    except ImportError:
        try:
            return dict(json.loads(text))
        except json.JSONDecodeError as err:
            raise RuntimeError(
                f"{filename}: PyYAML is not installed, and the file is not in "
                f"YAML's JSON form ({err})") from err
    hparam = {}
    for doc in yaml.load_all(text, Loader=yaml.FullLoader):
        for k, v in doc.items():
            hparam[k] = v
    return hparam


def _json_form(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_json_form(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, float) and math.isfinite(v):
        return f"{v:.17e}"        # with its dot: PyYAML reads `1e-05` as a string
    return json.dumps(v)


def dump_hparam(hparam: Dict, filename: str) -> None:
    """Write a config in YAML's JSON form, which `load_hparam` reads back
    equal with PyYAML or without it."""
    with open(filename, "w") as f:
        f.write(_json_form(hparam) + "\n")


def create_folder(folder_name: str) -> None:
    os.makedirs(folder_name, exist_ok=True)


def recursive_read_folder(folder: str, file_type: str,
                          output: Optional[List]) -> None:
    """List '<name> <path>' entries for every matching file under folder."""
    for file in os.listdir(folder):
        cur = os.path.join(folder, file)
        if os.path.isdir(cur):
            recursive_read_folder(cur, file_type, output)
        elif file_type in file:
            output.append(f"{file} {cur}")


_NEXT_FAST_LEN: Dict[int, int] = {}


def next_fast_len(size: int) -> int:
    """Next 5-smooth number >= size (efficient FFT length)."""
    if size in _NEXT_FAST_LEN:
        return _NEXT_FAST_LEN[size]
    n = size
    while True:
        rem = n
        for p in (2, 3, 5):
            while rem % p == 0:
                rem //= p
        if rem == 1:
            _NEXT_FAST_LEN[size] = n
            return n
        n += 1


def convolve(x: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Causal direct convolution, output length == input length."""
    full = np.convolve(x.reshape(-1), filt.reshape(-1), mode="full")
    return full[: x.reshape(-1).shape[0]].reshape(1, -1)


def fftconvolve(x: np.ndarray, kernel: np.ndarray, mode: str = "full") -> np.ndarray:
    """rFFT-based convolution over the last axis."""
    m = x.shape[-1]
    n = kernel.shape[-1]
    if mode == "full":
        truncate = m + n - 1
    elif mode == "valid":
        truncate = max(m, n) - min(m, n) + 1
    elif mode == "same":
        truncate = max(m, n)
    else:
        raise ValueError(f"Unknown mode: {mode}")
    size = next_fast_len(m + n - 1)
    out = np.fft.irfft(np.fft.rfft(x, n=size) * np.fft.rfft(kernel, n=size), n=size)
    start = (m + n - 1 - truncate) // 2
    return out[..., start : start + truncate]
