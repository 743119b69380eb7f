"""Where the socket front's float32 output parts from the engine's
(`chip_smoke.py` phase 4l), on one CUDA card.

For `ns_dpcrn_v0_causal` on the `mk_kernel` route (phase 4l's f32 DPCRN
round) at 8 slots it reads, with cuDNN's default algorithms and with
`torch.backends.cudnn.deterministic`:
1. the bundle's step function run twice over the same ticks from the same
   state: bit-equal or not, and the SNR between the two runs;
2. the first module (forward hooks over the engine, one tick) whose output
   differs between two calls, and every module that differs;
3. phase 4l's socket round itself (`chip_smoke.socket_round`): the worst
   client's dB from the engine stepped outside the server.

    python3 scripts/socket_diverge.py            # from the repo root
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ab_common import load_chip_smoke  # noqa: E402

SLOTS, TICKS = 8, 20


def main() -> int:
    if not torch.cuda.is_available():
        print("socket_diverge: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import masker_kernel as mkk
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.zoo.ns import init_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = torch.device("cuda", 0), cs.card_line()
    t = time.perf_counter()
    _build.build(("masker",))
    mkk._lib()
    cs.log("1 build", "masker built", t)
    model = init_model("ns_dpcrn_v0_causal", device=dev,
                       generator=torch.Generator().manual_seed(cs.SEED))
    bundle = make_session_server(model, None, SLOTS, chunk_ms=16.0, lockstep=True,
                                 mk_kernel=True)
    engine, step, chunk = bundle.engine, bundle.server.step_fn, bundle.chunk_samples
    rng = np.random.default_rng(cs.SEED + 130)
    batch = (0.1 * rng.standard_normal((SLOTS, TICKS * chunk))).astype(np.float32)

    def run():
        state, outs = engine.init_state(SLOTS, torch.float32, mk_kernel=True), []
        for k in range(TICKS):
            y, state = step(batch[:, k * chunk:(k + 1) * chunk], state)
            outs.append(y.cpu())
        return torch.cat(outs, -1)

    def modules_of_one_tick():
        seen = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out, name=name: seen.append(
                (name, out.detach().clone() if isinstance(out, torch.Tensor) else None)))
            for name, m in engine.named_modules() if name]
        try:
            step(batch[:, :chunk], engine.init_state(SLOTS, torch.float32, mk_kernel=True))
        finally:
            for h in hooks:
                h.remove()
        return seen

    results = {}
    for det in (False, True):
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = det
        try:
            t = time.perf_counter()
            a, b = run(), run()
            snr = cs.snr_db(b, a) if not torch.equal(a, b) else float("inf")
            one, two = modules_of_one_tick(), modules_of_one_tick()
            differ = [n for (n, x), (_, y) in zip(one, two)
                      if x is not None and y is not None and not torch.equal(x, y)]
            cs.log("socket diverge", f"cudnn.deterministic={det}: the step function over "
                   f"{TICKS} ticks x {SLOTS} slots twice from one state: "
                   f"{'bit-equal' if snr == float('inf') else f'{snr:.1f} dB apart'}; "
                   f"modules whose output differs between two calls of one tick, in call "
                   f"order: {differ[:12]}{' ...' if len(differ) > 12 else ''} "
                   f"({len(differ)} of {len(one)}) [{card}]", t)
            rnd = cs.socket_round("ns_dpcrn_v0_causal", model, dict(mk_kernel=True),
                                  [("center_chunk", mkk, "LAUNCHES")], lambda ticks: (ticks,),
                                  dev, card)
            results[det] = (snr, differ[:1], rnd["snr"])
        finally:
            torch.backends.cudnn.deterministic = prev
    print({f"deterministic={k}": v for k, v in results.items()})
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
