"""Host-side utilities the recipe needs: the config loader and writer, the
manifest loader and `create_folder` (counterpart of puresound_tpu/src/utils.py,
kept as this package's own copy so that it never imports the JAX package).
"""
from __future__ import annotations

import io
import json
import math
import os
from typing import Dict


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
