"""LibriMix -> TSE manifest generator (a copy of the JAX recipe's
egs/tse/local/parser.py, on this package's `src`).

Reads a Libri2Mix metadata csv and the LibriSpeech metadata table, and
writes the manifests the recipe trains on (wav2scp / wav2ref / ref2spk /
wav2spk / ref2list), with up to 5 enrollment utterances per target speaker:

    python parser.py <mixture csv> <output folder> <librispeech table> <corpus root>
"""
import argparse
import io
import os
import random
import sys
from copy import deepcopy
from typing import Any, Dict, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

from puresound_tpu_torch.src.utils import create_folder  # noqa: E402


class Parser:
    def __init__(self, config: Any) -> None:
        self.config = config

    @staticmethod
    def read_librispeech_metadata(f_path: str,
                                  insert_root: Optional[str] = None) -> Dict:
        """metadata csv line: uttid, spkid, gender, path, length, sr, ch."""
        meta: Dict[str, Dict] = {}
        with io.open(f_path, "r", encoding="utf-8") as f:
            for idx, line in enumerate(f.readlines()):
                if idx == 0 or line.strip() == "":
                    continue
                uttid, spkid, gender, audio_path, length, sr, ch = \
                    line.strip().split(", ")
                if insert_root is not None:
                    audio_path = os.path.join(insert_root, audio_path)
                meta.setdefault(spkid, {"gender": gender, "sr": sr,
                                        "channels": ch, "utts": {}})
                meta[spkid]["utts"][uttid] = {"path": audio_path,
                                              "length": length}
        return meta


def pick_enroll(meta_pool: Dict, spk: str, uttid: str, n_enroll: int = 5):
    pool = deepcopy(meta_pool[spk])
    pool["utts"].pop(uttid, None)
    picked = random.sample(list(pool["utts"].keys()),
                           k=min(n_enroll, len(pool["utts"])))
    return [pool["utts"][u]["path"] for u in picked]


def main(config):
    create_folder(config.output_folder)
    meta_pool = Parser.read_librispeech_metadata(
        f_path=config.corpus_metadata, insert_root=config.corpus_root)
    dct: Dict[str, Dict] = {}
    with io.open(config.meta_path, "r") as f:
        for line in f.readlines()[1:]:
            cols = line.strip().split(",")
            uttid, mixed, s1, s2 = cols[0], cols[1], cols[2], cols[3]
            uttid1, uttid2 = uttid.strip().split("_")
            spk1 = uttid1.split("-")[0]
            spk2 = uttid2.split("-")[0]
            dct[f"{uttid}_1"] = {
                "noisy": mixed, "ref": s1, "spk": spk1,
                "all_spks": f"{spk1}-{spk2}",
                "enroll": " ".join(pick_enroll(meta_pool, spk1, uttid1)),
            }
            dct[f"{uttid}_2"] = {
                "noisy": mixed, "ref": s2, "spk": spk2,
                "all_spks": f"{spk1}-{spk2}",
                "enroll": " ".join(pick_enroll(meta_pool, spk2, uttid2)),
            }

    out = config.output_folder
    files = {"wav2scp.txt": "noisy", "wav2ref.txt": "ref",
             "ref2spk.txt": "spk", "wav2spk.txt": "all_spks",
             "ref2list.txt": "enroll"}
    for fname, field in files.items():
        with io.open(f"{out}/{fname}", "w", encoding="utf-8") as f:
            for key in sorted(dct.keys()):
                f.write(f"{key} {dct[key][field]}\n")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("meta_path", type=str)
    parser.add_argument("output_folder", type=str)
    parser.add_argument("corpus_metadata", type=str)
    parser.add_argument("corpus_root", type=str)
    main(parser.parse_args())
