"""Phase 8 of `chip_smoke.py` alone, on one CUDA card: the multi-device and
demo periphery. It builds the three CUDA sources the phase launches
(`lstm_train`, `tcn_train`, `skim_stream`), runs `chip_smoke.periphery_phase`
as `chip_smoke.run` does (8a `seq_parallel_infer`, 8b mesh serving, 8c the
tensor-parallel step in a NCCL group of one, 8d `MhaSelfAttenLayer(improved=
True)`, 8e the demos, 8f `utils.profiling` / `utils.roofline`) and prints
its lines, its launches by kernel as JSON and the card's name and power
limit.

    python3 scripts/periphery_phases.py            # from the repo root
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
        print("periphery_phases: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import skim_stream_kernel as ops
    from puresound_tpu_torch.ops import tcn_train_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = torch.device("cuda", 0), cs.card_line()
    cs.log("0 device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}", time.perf_counter())
    t = time.perf_counter()
    _build.build(("lstm_train", "tcn_train", "skim_stream"))
    for mod in (lk, tk, ops):
        mod._lib()
    cs.log("1 build", "lstm_train, tcn_train, skim_stream built", t)
    out = cs.periphery_phase(ops, lk, tk, dev, card)
    print(json.dumps({"launches_8": out["launches"]}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
