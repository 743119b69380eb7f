"""`utils.profiling` and `utils.roofline` of the port against JAX's
(`puresound_tpu/utils/profiling.py`, `roofline.py`):

- `timed`'s fields (the first call apart, percentiles in order, rtf) on the
  host clock here;
- `profiler_trace` writes a Chrome trace on the CPU whose events hold the
  window's ops;
- `fused_skim_kernel_cost` / `lstm_scan_cost` equal JAX's over FiLM, Gate
  and unconditioned blocks, f32 and bf16 byte widths;
- `summarize` equals JAX's at the H100's peaks and defaults to them; its
  `bound_ms` is the roofline's;
- `cost_of` counts a Linear's 2 x B x in x out FLOPs and zero for the
  port's kernel op (`lstm_scan_train_fp`, a custom op as XLA's custom
  call), with its bytes at 0 as JAX's where nothing reports them.
"""
import json
import os

import numpy as np
import pytest
import torch

from puresound_tpu.utils import roofline as jroof
from puresound_tpu_torch.utils import profiling, roofline

torch.set_num_threads(1)

SKIM_CASES = [(1024, 15, 128, 256, 4, ("film",) * 4, 128, 2),
              (256, 15, 128, 256, 4, ("film",) * 4, 128, 4),
              (1024, 15, 128, 256, 4, ("gate",) * 4, 128, 2),
              (13, 4, 16, 16, 3, ("film", "", "gate"), 16, 4),
              (1, 1, 128, 64, 2, ("", ""), 128, 2)]


def test_timed_fields():
    calls = []
    t = profiling.timed(lambda a: calls.append(1) or a * 2, torch.ones(8), iters=5, warmup=3)
    assert len(calls) == 1 + 2 + 5 and t.iters == 5
    assert t.compile_s >= 0 and 0 < t.p50_ms <= t.p95_ms and t.mean_ms > 0
    assert t.rtf(1.0) == pytest.approx(1000.0 / t.mean_ms)
    assert "p50" in str(t)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with profiling.profiler_trace(str(tmp_path), name="t.json") as prof:
        for _ in range(3):
            x = x @ x * 1e-3
    path = tmp_path / "t.json"
    assert path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in k.key for k in prof.key_averages())


@pytest.mark.parametrize("case", SKIM_CASES)
def test_fused_skim_kernel_cost_equals_jax(case):
    B, F, C, H, n, modes, hd, nbytes = case
    want = jroof.fused_skim_kernel_cost(B, F, C, H, n, modes, gate_hidden=hd,
                                        dtype_bytes=nbytes)
    assert roofline.fused_skim_kernel_cost(B, F, C, H, n, modes, gate_hidden=hd,
                                           dtype_bytes=nbytes) == want


@pytest.mark.parametrize("rows,T,H,nbytes", [(4096, 64, 128, 2), (131072, 2, 128, 4),
                                             (7, 3, 24, 2)])
def test_lstm_scan_cost_equals_jax(rows, T, H, nbytes):
    assert roofline.lstm_scan_cost(rows, T, H, nbytes) == jroof.lstm_scan_cost(rows, T, H,
                                                                              nbytes)


def test_summarize_at_the_h100_peaks():
    cost = roofline.fused_skim_kernel_cost(1024, 15, 128, 256, 4, ("film",) * 4)
    got = roofline.summarize(0.5, cost["flops"], cost["bytes"])
    want = jroof.summarize(0.5, cost["flops"], cost["bytes"],
                           peak_flops=roofline.H100_BF16_FLOPS,
                           peak_bw=roofline.H100_HBM_BYTES_S)
    assert {k: got[k] for k in want} == want
    assert got["gflops_per_step"] == pytest.approx(56.4, abs=0.05)
    assert got["bound_ms"] == pytest.approx(1e3 * cost["flops"] / 989e12)
    assert got["bound_ms"] == pytest.approx(0.057, abs=5e-4)
    f32 = roofline.summarize(1.0, 67e9, 0.0, peak_flops=roofline.H100_F32_FLOPS)
    assert f32["mfu_pct_bf16peak"] == 100.0 and f32["bound_ms"] == pytest.approx(1.0)
    assert (roofline.H100_F32_FLOPS, roofline.H100_BF16_FLOPS, roofline.H100_INT8_OPS,
            roofline.H100_HBM_BYTES_S) == (67e12, 989e12, 1979e12, 3.35e12)


def test_cost_of_counts_aten_flops_and_zero_for_a_port_kernel(rng):
    lin = torch.nn.Linear(16, 8)
    assert roofline.cost_of(lin, torch.zeros(5, 16)) == {"flops": 2.0 * 5 * 16 * 8,
                                                         "bytes": 0.0}
    import puresound_tpu_torch.ops.lstm_train_kernel  # noqa: F401  (registers the op)

    r = lambda *s: torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32))
    args = (r(4, 6, 8), r(4, 16), r(4, 16), r(8, 64), r(64), r(16, 64), False, False)
    op = torch.ops.puresound_tpu_torch.lstm_scan_train_fp
    assert roofline.cost_of(op, *args) == {"flops": 0.0, "bytes": 0.0}
    # the plain version of the same scan is counted (its projections)
    from puresound_tpu_torch.ops import lstm_train_kernel as lk

    assert roofline.cost_of(lk._fp_forward, *args)["flops"] > 0
