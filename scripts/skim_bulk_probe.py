"""What sizes `fused_skim_frames`'s tensor-core route on the card, as one
JSON line: the clusters of 2, 4 and 8 CTAs of its kernel in flight
(`cudaOccupancyMaxActiveClusters`, `ops.skim_stream_kernel.tc_clusters`)
and the rate at which the bulk copy engine fills an SM's shared memory
from L2 (`skim_bulk_probe.cu`: 1, 32 and one CTA an SM each stream 2,048
stages of 16 KB from a 4 MB image; the median of 5 CUDA-event timings).

    python scripts/skim_bulk_probe.py

Builds `skim_bulk_probe.cu` with nvcc into `build/scripts/` at the
checkout root. Needs a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from puresound_tpu_torch.ops import _build  # noqa: E402
from puresound_tpu_torch.ops import skim_stream_kernel as ops  # noqa: E402

STAGES = 2048


def build() -> ctypes.CDLL:
    src = os.path.join(ROOT, "scripts", "skim_bulk_probe.cu")
    out_dir = os.path.join(ROOT, "build", "scripts")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libskim_bulk_probe.so")
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-I", _build.CSRC, "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.skim_bulk_rate.argtypes = [p, i, i, i, p, p]
    lib.skim_bulk_rate.restype = i
    return lib


def main():
    if not torch.cuda.is_available():
        sys.exit("skim_bulk_probe.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    lib = build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    src = torch.randint(0, 255, (256 * ops.STAGE_BYTES,), dtype=torch.uint8, device=dev)
    sink = torch.zeros(sms, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(ctas):
        err = lib.skim_bulk_rate(src.data_ptr(), src.numel() // ops.STAGE_BYTES, ctas,
                                 STAGES, sink.data_ptr(), stream)
        if err:
            raise RuntimeError(f"bulk-copy probe launch failed: CUDA error {err}")

    rates = {}
    for ctas in (1, 32, sms):
        launch(ctas)
        times = []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            launch(ctas)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = sorted(times)[len(times) // 2]
        gbs = ctas * STAGES * ops.STAGE_BYTES / ms / 1e6
        rates[str(ctas)] = {"ms": ms, "GB_per_s": gbs, "GB_per_s_a_cta": gbs / ctas}
    print(json.dumps({"card": card.strip(), "clusters_in_flight": ops.tc_clusters(dev),
                      "bulk_copy_fill_rate": rates}))


if __name__ == "__main__":
    main()
