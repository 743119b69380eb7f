"""The fused SkiM streaming step: the port's plain version against the JAX
Pallas kernel (interpret mode). The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py (it has no CPU mode).

Kernel-level parity runs in float32 (the JAX kernel computes in f32) with
the JAX suite's own bar, atol 2e-5 / rtol 1e-4. With bf16 dots the two
sides round the same operands but sum in another order, so the bar is an
SNR: measured 141 dB with float32 I/O and bit-equal with bfloat16 I/O,
held at >= 100 dB.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.ops.skim_stream_kernel import fused_skim_frames as j_fused
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.ops import skim_stream_kernel as ops

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

MODES = ("film", "", "film")
B, F, C, H = 8, 4, 16, 32


def _weights(rng, modes, C=C, H=H):
    """Random weights in the kernel's flat JAX order."""
    def w(*shape, scale=None):
        s = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * s).astype(np.float32)
    ws = []
    for m in modes:
        if m == "film":
            ws += [w(C, C), w(C, C), 1 + w(C, scale=0.1), w(C, scale=0.1)]
        ws += [w(C, 4 * H), w(H, 4 * H), w(4 * H, scale=0.1), w(H, C),
               w(C, scale=0.1), 1 + w(C, scale=0.1), w(C, scale=0.1)]
    return ws


def _inputs(rng, n_chunks, modes=MODES, B=B, C=C, H=H):
    n = len(modes)
    xs = [rng.standard_normal((B, F, C)).astype(np.float32)
          for _ in range(n_chunks)]
    se = (rng.standard_normal((n, B, C)) * 0.3).astype(np.float32)
    be = (rng.standard_normal((n, B, C)) * 0.3).astype(np.float32)
    for i, m in enumerate(modes):
        if m != "film":
            se[i] = be[i] = 0.0
    h0 = (rng.standard_normal((n, B, H)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((n, B, H)) * 0.3).astype(np.float32)
    return xs, se, be, h0, c0


def _run_jax(xs, se, be, h, c, ws, dot_dtype, dtype=jnp.float32):
    cast = lambda a: jnp.asarray(a, dtype)
    ge = jnp.zeros((len(MODES), B, 1), dtype)
    h, c = cast(h), cast(c)
    ys = []
    for x in xs:
        y, h, c = j_fused(cast(x), cast(se), cast(be), ge, h, c,
                          tuple(cast(w) for w in ws), fusion_modes=MODES,
                          b_tile=B, interpret=True, dot_dtype=dot_dtype)
        ys.append(y)
    out = [np.asarray(jnp.asarray(a, jnp.float32)) for a in ys + [h, c]]
    return np.concatenate([o.ravel() for o in out])


def _run_port(xs, se, be, h, c, ws, dot_dtype, dtype=torch.float32,
              device="cpu", fn=ops.fused_skim_frames):
    cast = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
    ge = torch.zeros((len(MODES), xs[0].shape[0], 1), device=device, dtype=dtype)
    weights = ops.SkimWeights(cast(w) for w in ws)
    h, c = cast(h), cast(c)
    ys = []
    for x in xs:
        y, h, c = fn(cast(x), cast(se), cast(be), ge, h, c, weights, MODES,
                     dot_dtype=dot_dtype)
        ys.append(y)
    out = [a.float().cpu().numpy() for a in ys + [h, c]]
    return np.concatenate([o.ravel() for o in out])


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def test_plain_matches_pallas_f32(rng):
    """4 carried chunks, FiLM / unconditioned / FiLM blocks."""
    xs, se, be, h, c = _inputs(rng, 4)
    ws = _weights(rng, MODES)
    want = _run_jax(xs, se, be, h, c, ws, jnp.float32)
    got = _run_port(xs, se, be, h, c, ws, torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("io", ["f32_io", "bf16_io"])
def test_plain_matches_pallas_bf16_dots(rng, io):
    """dot_dtype=bf16, with float32 or bfloat16 inputs/state/weights."""
    xs, se, be, h, c = _inputs(rng, 4)
    ws = _weights(rng, MODES)
    jdt, tdt = ((jnp.float32, torch.float32) if io == "f32_io"
                else (jnp.bfloat16, torch.bfloat16))
    want = _run_jax(xs, se, be, h, c, ws, jnp.bfloat16, jdt)
    got = _run_port(xs, se, be, h, c, ws, torch.bfloat16, tdt)
    assert np.isfinite(got).all()
    assert _snr_db(got, want) >= 100.0


@pytest.mark.parametrize("opt", ["gate"])
def test_unported_options_raise(rng, opt):
    """Every fusion mode of JAX's kernel is ported (Gate since its own tests,
    tests/test_torch_gate_fusion.py); a mode JAX does not have raises on
    both paths."""
    xs, se, be, h, c = _inputs(rng, 1)
    ws = [torch.from_numpy(w) for w in _weights(rng, MODES)]
    args = [torch.from_numpy(a) for a in (xs[0], se, be)]
    ge = torch.zeros(3, B, 1)
    modes = (opt + "_film", "", "film")
    for fn in (ops.fused_skim_frames, ops.fused_skim_frames_ref):
        with pytest.raises(ValueError, match="unknown fusion modes"):
            fn(*args, ge, torch.from_numpy(h), torch.from_numpy(c), ws, modes)


def test_misaligned_chunk_raises():
    """F must divide seg_size (counterpart of test_pallas_kernels.py:110)."""
    m = SkiM(input_size=16, hidden_size=16, output_size=16, n_blocks=3,
             seg_size=8, causal=True, embed_dim=8, embed_norm=True,
             embed_fusion="FiLM", block_with_embed=(1, 0, 1))
    state = m.init_state(8)
    with pytest.raises(ValueError, match="divide seg_size"):
        m.step_frames_fused(torch.zeros(8, 3, 16), torch.ones(8, 8), state)


def test_cpu_tensors_take_the_plain_version(rng):
    """A CPU tensor never launches (nor counts) a kernel."""
    xs, se, be, h, c = _inputs(rng, 1)
    ws = _weights(rng, MODES)
    before = ops.LAUNCHES
    a = _run_port(xs, se, be, h, c, ws, torch.float32)
    b = _run_port(xs, se, be, h, c, ws, torch.float32,
                  fn=ops.fused_skim_frames_ref)
    assert ops.LAUNCHES == before
    np.testing.assert_array_equal(a, b)
