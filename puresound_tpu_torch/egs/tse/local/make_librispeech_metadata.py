"""Generate LibriSpeech metadata tables for the TSE manifest parser (a copy
of the JAX recipe's egs/tse/local/make_librispeech_metadata.py, on this
package's `src`).

The repo bundles the tables under egs/tse/local/librispeech_metadata/; this
script writes the same format from a LibriSpeech corpus tree:

    uttid, spkid, gender, audio_path, length, sr, channels

Usage:
    python make_librispeech_metadata.py <librispeech_root>/<split> out.csv \\
        [--speakers-file <librispeech_root>/SPEAKERS.TXT] [--relative-to <dir>]
"""
import argparse
import io
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

from puresound_tpu_torch.src.audio import AudioIO  # noqa: E402
from puresound_tpu_torch.src.utils import recursive_read_folder  # noqa: E402


def load_genders(speakers_file):
    genders = {}
    if not speakers_file or not os.path.isfile(speakers_file):
        return genders
    with io.open(speakers_file, "r", encoding="utf-8") as f:
        for line in f:
            if line.startswith(";"):
                continue
            parts = [p.strip() for p in line.split("|")]
            if len(parts) >= 2:
                genders[parts[0]] = parts[1]
    return genders


def main(config):
    genders = load_genders(config.speakers_file)
    flacs = []
    recursive_read_folder(config.corpus_split, ".flac", flacs)
    rows = []
    for entry in sorted(flacs):
        path = entry.strip().split(" ")[1]
        uttid = os.path.basename(path).rsplit(".", 1)[0]
        spkid = uttid.split("-")[0]
        sr, seconds, channels = AudioIO.audio_info(path)
        rel = os.path.relpath(path, config.relative_to) if config.relative_to else path
        rows.append(f"{uttid}, {spkid}, {genders.get(spkid, 'U')}, {rel}, "
                    f"{seconds}, {sr}, {channels}")
    with io.open(config.output_csv, "w", encoding="utf-8") as f:
        f.write("uttid, spkid, gender, audio_path, length, sr, channels\n")
        f.write("\n".join(rows) + "\n")
    print(f"wrote {len(rows)} rows to {config.output_csv}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("corpus_split", type=str,
                        help="e.g. LibriSpeech/train-clean-100")
    parser.add_argument("output_csv", type=str)
    parser.add_argument("--speakers-file", type=str, default=None)
    parser.add_argument("--relative-to", type=str, default=None)
    main(parser.parse_args())
