"""int8 serving products shared by the kernel modules' plain versions and
weight packing (counterpart of JAX's `dot_hh` / `dot_dyn`,
puresound_tpu/ops/skim_stream_kernel.py:63-85 and dual_path_kernel.py:63-77,
and of the per-column quantizers, puresound_tpu/nnet/skim.py:422-425 and
nnet/dpcrn.py:146-150).

Rounding is round half to even (`torch.round`, as `jnp.round`) and clips to
+-127, never -128. Scales keep JAX's order of operations: the weight scale
is divided first (scale / 127^2 for `dot_hh`, scale / 127 for `dot_dyn`) in
its own dtype, then the product is scaled. The integer sums are exact in
float32 while K * 127^2 < 2^24 (K < 1040)."""
from __future__ import annotations

import torch

HH_DIV = 127.0 * 127.0   # dot_hh: h / 127 times w * scale / 127
DYN_DIV = 127.0          # dot_dyn: the activation's own amax / 127


def quantize_cols(w: torch.Tensor):
    """Per-output-column int8 weights of w [K, N] in w's dtype: (int8
    round(w / col_max * 127) clipped to +-127, col_max clipped at 1e-8)."""
    col_max = w.abs().amax(dim=0).clamp_min(1e-8)
    return (torch.round(w / col_max * 127.0).clamp(-127, 127).to(torch.int8),
            col_max)


def dot_hh_ref(h, wq, s):
    """`dot_hh` on h in (-1, 1) at the fixed scale 1/127; s = scale / 127^2."""
    hq = torch.round(h * 127.0).clamp(-127.0, 127.0)
    return (hq @ wq.to(h.dtype)) * s


def dot_dyn_ref(a, wq, s):
    """`dot_dyn`: a per-row amax (clipped at 1e-8) as the activation scale;
    s = scale / 127."""
    amax = a.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    aq = torch.round(a / amax * 127.0).clamp(-127.0, 127.0)
    return (aq @ wq.to(a.dtype)) * (amax / 127.0) * s


def option_key(**options: bool) -> str:
    """The key of a kernel module's LAUNCHES_BY_OPTION: the names of the
    options that are on, joined by '+' ("" for none)."""
    return "+".join(k for k, on in options.items() if on)


def pack_int8(w: torch.Tensor) -> torch.Tensor:
    """An int8 [K, N] matrix (K % 4 == 0) as [K/4, N] int32 words, word (g,
    n) holding rows 4g..4g+3 of column n (byte e = row 4g + e): the operand
    layout of the kernels' __dp4a products."""
    K, N = w.shape
    words = w.reshape(K // 4, 4, N).permute(0, 2, 1).contiguous().view(torch.int32)
    return words.reshape(K // 4, N)
