"""The DPARN intra-attention kernel's plain version against the JAX package:
`dparn_intra_pass` (Pallas, interpret mode) at a small geometry (F=8
tokens, C=16, 4 heads, feed-forward 16) for JAX's three variants in float32
(atol 2e-5, the bar of JAX's own variant test), with bf16 dots, and in
float64 against the stock DPARN intra pass it fuses. The CUDA kernel itself
runs only on the card (chip_smoke.py phase 2f)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.ops.dparn_attention_kernel import dparn_intra_pass as j_intra_pass
from puresound_tpu_torch.nnet.dparn import DPARNblock2D
from puresound_tpu_torch.ops import dparn_attention_kernel as dak

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

F, C, HEADS, FFD, R = 8, 16, 4, 16, 6


def _weights(rng):
    a = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    v = lambda n, c=0.0: (c + 0.1 * rng.standard_normal(n)).astype(np.float32)
    ws = []
    for _ in range(2):
        ws += [a(C, C), a(C, C), a(C, C), a(C, C), v(C, 1.0), v(C),
               a(C, FFD), v(FFD), a(FFD, C), v(C), v(C, 1.0), v(C)]
    return ws + [a(C, C), v(C), v(C, 1.0), v(C)]


@pytest.fixture
def case(rng):
    x = (rng.standard_normal((R, F, C)) * 0.5).astype(np.float32)
    pe = (rng.standard_normal((F, C)) * 0.1).astype(np.float32)
    return x, pe, _weights(rng)


@pytest.mark.parametrize("variant", dak.VARIANTS)
def test_plain_matches_jax_interpret(case, variant):
    x, pe, ws = case
    want = j_intra_pass(jnp.asarray(x), jnp.asarray(pe), tuple(map(jnp.asarray, ws)),
                        heads=HEADS, r_tile=2, interpret=True, variant=variant)
    got = dak.dparn_intra_pass(torch.from_numpy(x), torch.from_numpy(pe),
                               [torch.from_numpy(w) for w in ws], HEADS, variant=variant)
    assert got.dtype == torch.float32 and got.shape == (R, F, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_bf16_dots_match_jax_interpret(case):
    """bf16 operands at the kernel's cast points: the same roundings as
    JAX's kernel, so the two agree far inside bf16's own error."""
    x, pe, ws = case
    want = np.asarray(j_intra_pass(jnp.asarray(x), jnp.asarray(pe),
                                   tuple(map(jnp.asarray, ws)), heads=HEADS, r_tile=3,
                                   interpret=True, dot_dtype=jnp.bfloat16))
    got = dak.dparn_intra_pass(torch.from_numpy(x), torch.from_numpy(pe),
                               [torch.from_numpy(w) for w in ws], HEADS,
                               dot_dtype=torch.bfloat16).numpy()
    f32 = dak.dparn_intra_pass(torch.from_numpy(x), torch.from_numpy(pe),
                               [torch.from_numpy(w) for w in ws], HEADS).numpy()
    err, bf16_err = np.abs(got - want).max(), np.abs(f32 - want).max()
    assert err < 0.05 * bf16_err, (err, bf16_err)


def test_plain_equals_the_stock_intra_pass_in_f64(rng):
    """The fused math (two-pass norms, positions on layer 1) equals
    DPARNblock2D's stock intra pass (flax-style norms) in float64."""
    blk = DPARNblock2D(C, FFD, HEADS, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(3)).eval()
    rows = torch.from_numpy(rng.standard_normal((5, F, C)))
    with torch.no_grad():
        want = blk._intra(rows)
        pe = blk.intra_atten1.pos.table(F, "cpu").double()
        got = dak.dparn_intra_pass(rows, pe, blk.attn_kernel_weights(), HEADS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-10, rtol=1e-9)


def test_wrapper_checks(case):
    x, pe, ws = case
    tw = [torch.from_numpy(w) for w in ws]
    with pytest.raises(ValueError, match="variant"):
        dak.dparn_intra_pass(torch.from_numpy(x), torch.from_numpy(pe), tw, HEADS,
                             variant="fused")
    with pytest.raises(ValueError, match="28 weights"):
        dak.check_weights(tw[:-1], C, torch.device("cpu"))
    with pytest.raises(ValueError, match="heads"):
        dak.check_geometry(F, C, FFD, 3)
    with pytest.raises(ValueError, match="F <= 64"):
        dak.check_geometry(66, C, FFD, HEADS)
    assert dak.weight_shapes(C, FFD)[6] == (C, FFD)
