"""Phase 7f of `chip_smoke.py` alone, on one CUDA card: the recipes' last
actions. It builds the two CUDA sources the phase launches (`lstm_train`,
`tcn_train`), runs `chip_smoke.export_phase` as `chip_smoke.run` does (the
flagship through the TSE CLI's `export_model`, each loaded artifact against
the eager module, `ns_dpcrn_v0_causal`'s export, the op's dispatch cost,
`--action tSNE` card against CPU, the inf-injection probe) and prints its
lines, its launches as JSON and the card's name and power limit.

    python3 scripts/export_phases.py            # from the repo root
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
        print("export_phases: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import tcn_train_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = torch.device("cuda", 0), cs.card_line()
    cs.log("0 device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}", time.perf_counter())
    t = time.perf_counter()
    _build.build(("lstm_train", "tcn_train"))
    for mod in (lk, tk):
        mod._lib()
    cs.log("1 build", "lstm_train, tcn_train built", t)
    out = cs.export_phase(lk, tk, dev, card)
    print(json.dumps({"launches_7f": out["launches"], "dispatch": out["dispatch"],
                      "timing": out["timing"], "export_s": out["export_s"]}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
