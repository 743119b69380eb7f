"""Count what the flagship's unfused streaming step dispatches a chunk.

TSE `stream_eval` runs `StreamingTSE.step` without the fused kernel, as
JAX's does; at B = 1 its time is the host's dispatch of small ops. This
prints the torch ops (`aten::` calls in a profiler window) and the
`lstm_scan_train_fp` entries one 16 ms chunk (256 samples, 16 frames)
issues, after one warm-up chunk:

    python3 scripts/tse_stream_ops.py [--device cuda]

The counts depend on the code, not on the device; on the card the
`lstm_scan_train_fp` entries are kernel launches.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu")
    dev = torch.device(parser.parse_args(argv).device)

    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.streaming.engine import StreamingTSE
    from puresound_tpu_torch.zoo.tse import init_model

    engine = StreamingTSE.from_offline(init_model(
        "tse_skim_v0_causal", device=dev, generator=torch.Generator().manual_seed(0)))
    chunk = torch.randn(1, 256, generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        dvec = engine.embed(torch.randn(1, 16000).to(dev))
        _, state = engine.step(chunk, dvec, engine.init_state(1))
        entries = dict(lk.FWD_BY_ENTRY)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            engine.step(chunk, dvec, state)
    ops = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    fp = {k: v - entries.get(k, 0) for k, v in lk.FWD_BY_ENTRY.items()}
    print(f"one 16 ms chunk of the flagship's unfused StreamingTSE.step on {dev}: "
          f"{ops} aten ops; lstm_scan_train_fp entries {fp or 'none counted (CPU tensors)'}")


if __name__ == "__main__":
    main()
