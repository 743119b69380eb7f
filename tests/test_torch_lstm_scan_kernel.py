"""The serving LSTM scan's plain version against the Pallas kernel
(puresound_tpu/ops/lstm_scan_kernel.py::lstm_scan, interpret mode) in
float32 at atol 1e-6, as tests/test_pallas_kernels.py holds the Pallas
kernel against the cell scan: forward and reverse, a ragged row count,
bfloat16 xp with float32 and with bfloat16 dots (y is bfloat16 there, held
within one bf16 step, 2^-8, of the Pallas output), and the tensor-core
route's serving inputs (bf16 xp and W_hh, f32 dots, bf16 or f32 carries, H =
16 to 128) likewise. Then DPRNNblock2D.step_chunk(fused=True)
against JAX's (float32, atol 1e-5 / rtol 1e-4: a whole block of products
on top of the scan). The CUDA kernel is held against the plain version on
the card by chip_smoke.py (phase 2d)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.dpcrn import DPRNNblock2D as JBlock
from puresound_tpu.ops.lstm_scan_kernel import lstm_scan as j_lstm_scan
from puresound_tpu_torch.nnet.dpcrn import DPRNNblock2D
from puresound_tpu_torch.ops import lstm_scan_kernel as lsk
from puresound_tpu_torch.utils.from_jax import dprnn_block2d, to_torch

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


def _inputs(rng, B, T, H, dt=np.float32):
    xp = rng.standard_normal((B, T, 4 * H)).astype(dt)
    h0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    c0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    w = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return xp, h0, c0, w


@pytest.mark.parametrize("B,T,H,reverse", [(8, 10, 16, False), (8, 10, 16, True),
                                           (13, 7, 24, True)])
def test_plain_lstm_scan_matches_pallas(rng, B, T, H, reverse):
    xp, h0, c0, w = _inputs(rng, B, T, H)
    want = j_lstm_scan(*map(jnp.asarray, (xp, h0, c0, w)), reverse=reverse,
                       interpret=True)
    got = lsk.lstm_scan(*map(torch.from_numpy, (xp, h0, c0, w)), reverse=reverse)
    for g, wt in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=1e-6)
    assert lsk.LAUNCHES == 0          # CPU tensors take the plain version


@pytest.mark.parametrize("dot", ["float32", "bfloat16"])
def test_plain_lstm_scan_bf16_xp(rng, dot):
    """bf16 xp and weights, f32 state, with f32 dots (the fused serving
    route) and with bf16 dots."""
    xp, h0, c0, w = _inputs(rng, 6, 9, 16)
    xp16 = jnp.asarray(xp).astype(jnp.bfloat16)
    w16 = jnp.asarray(w).astype(jnp.bfloat16)
    want = j_lstm_scan(xp16, jnp.asarray(h0), jnp.asarray(c0), w16, reverse=True,
                       interpret=True, dot_dtype=getattr(jnp, dot))
    got = lsk.lstm_scan(torch.from_numpy(np.array(xp16.astype(jnp.float32))).bfloat16(),
                        torch.from_numpy(h0), torch.from_numpy(c0),
                        torch.from_numpy(np.array(w16.astype(jnp.float32))).bfloat16(),
                        reverse=True, dot_dtype=getattr(torch, dot))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)), atol=2 ** -8)
    for g, wt in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=1e-6)


def test_fused_step_chunk_matches_jax(rng):
    """The block's fused step (6 scans in all for two blocks; here one
    block: intra forward, intra reverse, inter) against JAX's."""
    CH, H, B, F, K = 16, 8, 3, 6, 2
    jb = JBlock(CH, H)
    x = rng.standard_normal((B, CH, F, K)).astype(np.float32)
    h = (0.3 * rng.standard_normal((1, B, F, H))).astype(np.float32)
    c = (0.3 * rng.standard_normal((1, B, F, H))).astype(np.float32)
    v = jb.init(KEY, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c),
                method=JBlock.step_chunk)
    want = jb.apply(v, *map(jnp.asarray, (x, h, c)), True, method=JBlock.step_chunk)
    blk = DPRNNblock2D(CH, H)
    blk.load_state_dict(to_torch(dprnn_block2d(jax.device_get(v["params"]))),
                        strict=True)
    with torch.no_grad():
        got = blk.step_chunk(*map(torch.from_numpy, (x, h, c)), fused=True)
        stock = blk.step_chunk(*map(torch.from_numpy, (x, h, c)))
    for g, s, wt in zip(got, stock, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(g.numpy(), s.numpy(), atol=1e-5, rtol=1e-4)


def test_cuda_only_checks_raise_before_a_launch():
    """The launch path's own checks (run before any build) refuse what the
    kernel does not take."""
    xp = torch.zeros(2, 3, 4 * 600)
    with pytest.raises(ValueError, match="H <= 512"):
        lsk._check(xp, torch.zeros(2, 600), torch.zeros(2, 600),
                   torch.zeros(600, 2400), torch.float32)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        lsk._check(xp.double(), torch.zeros(2, 600), torch.zeros(2, 600),
                   torch.zeros(600, 2400), torch.float32)


@pytest.mark.parametrize("B,T,H,reverse,state", [
    (8, 10, 16, False, "bf16"), (8, 10, 16, True, "bf16"), (33, 6, 32, True, "f32"),
    (13, 7, 24, False, "bf16"), (40, 3, 64, False, "f32"), (5, 4, 128, True, "bf16")])
def test_plain_bf16_route_matches_pallas(rng, B, T, H, reverse, state):
    """bf16 xp and W_hh, float32 dots, carries in bf16 or f32 (the tensor-core
    route's serving inputs): the plain version against the Pallas kernel in
    interpret mode; y (bf16) within one bf16 step, the f32 carries at 1e-6."""
    xp = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    c0 = (0.3 * rng.standard_normal((B, H))).astype(np.float32)
    w = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    sdt = torch.bfloat16 if state == "bf16" else torch.float32
    t = [torch.from_numpy(a) for a in (xp, h0, c0, w)]
    t = [t[0].bfloat16(), t[1].to(sdt), t[2].to(sdt), t[3].bfloat16()]
    j = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16 if a.dtype == torch.bfloat16
                                               else jnp.float32) for a in t]
    want = j_lstm_scan(*j, reverse=reverse, interpret=True)
    got = lsk.lstm_scan(*t, reverse=reverse)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == sdt
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)), atol=2 ** -8)
    tol = 2 ** -8 if state == "bf16" else 1e-6
    for g, wt in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(wt.astype(jnp.float32)),
                                   atol=tol)
    assert lsk.LAUNCHES == 0 and not lsk.LAUNCHES_BY_ROUTE
