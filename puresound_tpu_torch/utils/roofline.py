"""Roofline accounting: FLOPs and memory bytes of a step against the card's
peaks (counterpart of puresound_tpu/utils/roofline.py).

The peaks are the NVIDIA H100 SXM's published dense rates. `cost_of` counts
the aten FLOPs of a call with `torch.utils.flop_counter.FlopCounterMode`;
the port's hand-written kernels (the `puresound_tpu_torch::` ops and the
`ops` wrappers) count zero there, as XLA's cost analysis counts a custom
call, so their work is added analytically (`fused_skim_kernel_cost`,
`lstm_scan_cost`, JAX's formulas). FlopCounterMode counts no bytes: they
read zero, as JAX's do where the backend gives no analysis.
"""
from __future__ import annotations

from typing import Dict

#: NVIDIA H100 SXM (80 GB HBM3), dense peaks: float32 on the CUDA cores,
#: bfloat16 and int8 on the tensor cores, and the memory rate
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_HBM_BYTES_S = 3.35e12


def cost_of(fn, *args, **kwargs) -> Dict[str, float]:
    """{"flops", "bytes"} of one call fn(*args, **kwargs): the aten FLOPs
    FlopCounterMode sees (the port's kernels count zero), bytes 0."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes": 0.0}


def fused_skim_kernel_cost(B: int, F: int, C: int, H: int, n_blocks: int,
                           fusion_modes, gate_hidden: int = 128,
                           dtype_bytes: int = 2) -> Dict[str, float]:
    """Analytic FLOPs and memory bytes of one `fused_skim_frames` call (B
    streams, F frames, n_blocks SkiM blocks of width C and hidden H).

    Per frame and block: the LSTM's x @ W_ih [B, C] x [C, 4H] and h @ W_hh
    [B, H] x [H, 4H] and the projection [B, H] x [H, C]; FiLM adds two
    [B, C] x [C, C], the Gate its in / left / right / out 1x1 convs. Bytes:
    x in, y out, the conditioning rows, the h / c states in and out, and
    one read of the weights."""
    flops = 0.0
    for i in range(n_blocks):
        flops += 2.0 * B * F * (C * 4 * H + H * 4 * H + H * C)
        if fusion_modes[i] == "film":
            flops += 2.0 * B * F * 2 * C * C
        elif fusion_modes[i] == "gate":
            Hd = gate_hidden
            flops += 2.0 * B * F * (C * Hd + 2 * Hd * Hd + Hd * C)
    w_elems = n_blocks * (C * 4 * H + H * 4 * H + 4 * H + H * C + C + 2 * C)
    for i in range(n_blocks):
        if fusion_modes[i] == "film":
            w_elems += 2 * C * C + 2 * C
        elif fusion_modes[i] == "gate":
            Hd = gate_hidden
            w_elems += C * Hd + 2 * Hd * Hd + Hd * C + 4 * Hd + 2
    io_elems = (2 * B * F * C            # x in, y out
                + 2 * n_blocks * B * C   # the conditioning rows
                + 4 * n_blocks * B * H)  # h / c in and out
    return {"flops": flops, "bytes": dtype_bytes * (io_elems + w_elems)}


def lstm_scan_cost(rows: int, T: int, H: int, dtype_bytes: int = 2) -> Dict[str, float]:
    """Analytic cost of `lstm_scan`, the recurrent half of an LSTM ([rows,
    H] x [H, 4H] a step; the input projection is counted apart)."""
    flops = 2.0 * rows * T * H * 4 * H
    io_elems = rows * T * 4 * H + rows * T * H + 4 * rows * H + H * 4 * H
    return {"flops": flops, "bytes": dtype_bytes * io_elems}


def summarize(step_ms: float, flops: float, bytes_hbm: float,
              peak_flops: float = H100_BF16_FLOPS,
              peak_bw: float = H100_HBM_BYTES_S) -> Dict[str, float]:
    """The rates one measured step reached: TFLOP/s and its share of
    `peak_flops` (the H100's bf16 tensor-core peak unless given:
    `mfu_pct_bf16peak`, as JAX names it; a float32 step is measured against
    that peak too), memory GB/s and its share of `peak_bw`, and the step's
    GFLOP and MB. `bound_ms` is the least time the peaks allow."""
    t = step_ms / 1000.0
    achieved_flops = flops / t if t > 0 else 0.0
    achieved_bw = bytes_hbm / t if t > 0 else 0.0
    return {
        "tflops": round(achieved_flops / 1e12, 2),
        "mfu_pct_bf16peak": round(100.0 * achieved_flops / peak_flops, 2),
        "hbm_gbps": round(achieved_bw / 1e9, 1),
        "hbm_util_pct": round(100.0 * achieved_bw / peak_bw, 2),
        "gflops_per_step": round(flops / 1e9, 2),
        "mbytes_per_step": round(bytes_hbm / 1e6, 1),
        "bound_ms": 1e3 * max(flops / peak_flops, bytes_hbm / peak_bw),
    }
