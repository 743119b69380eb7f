"""Host-side utilities the recipe needs: the config loader, the manifest
loader and `create_folder` (counterpart of puresound_tpu/src/utils.py,
kept as this package's own copy so that it never imports the JAX package).
"""
from __future__ import annotations

import io
import json
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


def create_folder(folder_name: str) -> None:
    os.makedirs(folder_name, exist_ok=True)
