"""Phases 2l, 4m, 6k and 7d of `chip_smoke.py` alone, on one CUDA card: the
time-domain rest of the TSE zoo (`tse_skim_v0`, `tse_skim_v1_causal`,
`tse_skim_v2_causal`, `veve_dprnn_v0_causal`). It builds the three CUDA
sources those phases launch (`skim_stream`, `lstm_train`, `tcn_train`),
then runs the phases as `chip_smoke.run` does and prints their lines, the
launches by phase as JSON and the card's name and power limit.

    python3 scripts/zoo_phases.py            # from the repo root
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ab_common import load_chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("zoo_phases: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import skim_stream_kernel as ops
    from puresound_tpu_torch.ops import tcn_train_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = torch.device("cuda", 0), cs.card_line()
    t = time.perf_counter()
    _build.build(("skim_stream", "lstm_train", "tcn_train"))
    for mod in (ops, lk, tk):
        mod._lib()
    cs.log("1 build", "skim_stream, lstm_train, tcn_train built", t)
    zoo = cs.zoo_phases(ops, lk, tk, dev, card)
    print(json.dumps(zoo["launches"]))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
