"""Phases 4n, 6l and 7e of `chip_smoke.py` alone, on one CUDA card: the
STFT-domain TSE zoo (`tse_unet_tcn_v0`, `tse_unet_tcn_v0_causal`,
`tse_unet_tcn_v1`). Their path launches none of the port's kernels, so
nothing is built; the phases run as `chip_smoke.run` runs them and print
their lines and the card's name and power limit.

    python3 scripts/unet_phases.py           # from the repo root
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ab_common import load_chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("unet_phases: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import tcn_train_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = torch.device("cuda", 0), cs.card_line()
    cs.unet_phases(lk, tk, dev, card)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
