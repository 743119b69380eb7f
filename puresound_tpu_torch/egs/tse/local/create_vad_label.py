"""Sample-level VAD labels for PVAD training (a copy of the JAX recipe's
egs/tse/local/create_vad_label.py, on this package's `src`).

The default is an energy VAD on the host: frame RMS against the peak with
dual thresholds and a hangover, so labels are made without a network.
`--vad silero` asks `torch.hub` for Silero-VAD as the reference recipe does;
that download needs a network, and where it fails the script prints why and
falls back to the energy VAD, as JAX's does. This is label preparation on
the host, not a device path.

    python create_vad_label.py <manifest folder with wav2ref.txt> <output folder>
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

from puresound_tpu_torch.src.audio import AudioIO  # noqa: E402
from puresound_tpu_torch.src.utils import create_folder, load_text_as_dict  # noqa: E402


def energy_vad(wav: np.ndarray, sr: int, frame_ms: float = 30.0,
               hop_ms: float = 10.0, on_db: float = -35.0,
               off_db: float = -45.0, hangover_frames: int = 8) -> np.ndarray:
    """Sample-level 0/1 labels via dual-threshold frame energy + hangover."""
    x = wav.reshape(-1).astype(np.float64)
    frame = int(sr * frame_ms / 1000)
    hop = int(sr * hop_ms / 1000)
    n = max(1 + (len(x) - frame) // hop, 1)
    peak = np.abs(x).max() + 1e-12
    labels = np.zeros(len(x), np.float32)
    active = False
    hang = 0
    for t in range(n):
        seg = x[t * hop : t * hop + frame]
        rms_db = 20 * np.log10(np.sqrt(np.mean(seg**2)) / peak + 1e-12)
        if rms_db > on_db:
            active = True
            hang = hangover_frames
        elif rms_db < off_db:
            if hang > 0:
                hang -= 1
            else:
                active = False
        if active:
            labels[t * hop : t * hop + frame] = 1.0
    return labels


def silero_vad(wav: np.ndarray, sr: int):  # pragma: no cover
    import torch

    model, utils = torch.hub.load("snakers4/silero-vad", "silero_vad")
    (get_speech_timestamps, *_rest) = utils
    ts = get_speech_timestamps(torch.from_numpy(wav.reshape(-1)), model,
                               sampling_rate=sr)
    labels = np.zeros(wav.shape[-1], np.float32)
    for seg in ts:
        labels[seg["start"] : seg["end"]] = 1.0
    return labels


def main(config):
    create_folder(config.output_folder)
    wav2ref = load_text_as_dict(os.path.join(config.manifest, "wav2ref.txt"))
    lines = []
    for key, paths in wav2ref.items():
        wav, sr = AudioIO.open(paths[0])
        try:
            if config.vad == "silero":
                labels = silero_vad(wav, sr)
            else:
                labels = energy_vad(wav, sr)
        except Exception as e:
            print(f"silero unavailable ({e}); falling back to energy VAD")
            labels = energy_vad(wav, sr)
        out_path = os.path.join(config.output_folder, f"{key}.vad.wav")
        AudioIO.save(labels.reshape(1, -1), out_path, sr)
        lines.append(f"{key} {out_path}")
    with open(os.path.join(config.manifest, "ref2vad.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} VAD label files")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("manifest", type=str, help="manifest folder with wav2ref.txt")
    parser.add_argument("output_folder", type=str)
    parser.add_argument("--vad", type=str, default="energy",
                        choices=["energy", "silero"])
    main(parser.parse_args())
