"""Port parity, the training LSTM kernel's plain versions
(`ops/lstm_train_kernel.py`): forward and backward against the JAX
package's Pallas `lstm_scan_train_fp` in interpret mode on the same f32
inputs (JAX's own bars: values atol 1e-6, gradients atol 2e-6,
tests/test_pallas_kernels.py:344-352), the bf16 dot path by SNR, and the
autograd Function checked in float64 (gradcheck; the plain backward against
autograd through the plain forward at a ragged row count)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.ops.lstm_train_kernel import lstm_scan_train_fp as j_scan
from puresound_tpu_torch.ops import lstm_train_kernel as lk

B, T, H, C = 8, 12, 16, 8  # C != H catches axis mixups (test_pallas_kernels.py:313)
GRADS = ("dx", "dh0", "dc0", "dw_ih", "dbias", "dw_hh")


def _inputs(rng, b=B, t=T, c=C, h=H, dtype=np.float32):
    return [(rng.standard_normal(s) * k).astype(dtype) for s, k in (
        ((b, t, c), 0.4), ((b, h), 0.3), ((b, h), 0.3), ((c, 4 * h), 0.3),
        ((4 * h,), 0.2), ((h, 4 * h), 0.2))]


def _cotangent(b, t, h):
    """The loss sum(y * w) + sum(hT^2) + sum(0.3 * cT) of the JAX test."""
    return np.cos(np.arange(b * t * h).reshape(b, t, h) * 0.1)


def _jax_value_and_grads(args, reverse, dtype=jnp.float32):
    dd = jnp.bfloat16 if dtype == jnp.bfloat16 else jnp.float32
    jargs = tuple(jnp.asarray(a, dtype) for a in args)
    w = jnp.asarray(_cotangent(*args[0].shape[:2], args[1].shape[1]), dtype)
    fused = lambda *a: j_scan(*a, reverse, 4, True, dd)

    def loss(a):
        y, hT, cT = fused(*a)
        return (jnp.sum((y * w).astype(jnp.float32))
                + jnp.sum(hT.astype(jnp.float32) ** 2)
                + jnp.sum(cT.astype(jnp.float32) * 0.3))

    outs = fused(*jargs)
    grads = jax.grad(loss)(jargs)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return [f32(o) for o in outs], [f32(g) for g in grads]


def _port_value_and_grads(args, reverse, dtype=torch.float32):
    targs = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in args]
    y, hT, cT = lk.lstm_scan_train_fp(*targs, reverse=reverse)
    w = torch.tensor(_cotangent(*y.shape), dtype=dtype)
    loss = ((y * w).float().sum() + (hT.float() ** 2).sum()
            + (cT.float() * 0.3).sum())
    grads = torch.autograd.grad(loss, targs)
    f32 = lambda t: t.detach().float().numpy()
    return [f32(o) for o in (y, hT, cT)], [f32(g) for g in grads]


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas_interpret_f32(rng, reverse):
    args = _inputs(rng)
    want_v, want_g = _jax_value_and_grads(args, reverse)
    got_v, got_g = _port_value_and_grads(args, reverse)
    for got, want, name in zip(got_v, want_v, ("y", "hT", "cT")):
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    for got, want, name in zip(got_g, want_g, GRADS):
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=name)


def _snr_db(got, want):
    err = np.sum((got.astype(np.float64) - want) ** 2)
    return 10 * math.log10(np.sum(want.astype(np.float64) ** 2) / max(err, 1e-300))


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas_interpret_bf16_dots(rng, reverse):
    """bf16 x, weights and states: dots on bf16 operands summed in f32,
    y / gates / c stored in bf16. The two round the same values in the same
    places but sum in another order, so a stored bf16 value can land one
    ulp apart and carry through the recurrence; the bar is SNR >= 40 dB
    (measured: bit-identical values and gradients on this CPU)."""
    args = _inputs(rng)
    want_v, want_g = _jax_value_and_grads(args, reverse, jnp.bfloat16)
    got_v, got_g = _port_value_and_grads(args, reverse, torch.bfloat16)
    for got, want, name in zip(got_v + got_g, want_v + want_g,
                               ("y", "hT", "cT") + GRADS):
        assert _snr_db(got, want) >= 40.0, (name, _snr_db(got, want))


def test_function_gradcheck_f64(rng):
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in _inputs(rng, b=3, t=4, c=3, h=2, dtype=np.float64)]
    for reverse in (False, True):
        assert torch.autograd.gradcheck(
            lambda *a: lk.lstm_scan_train_fp(*a, reverse=reverse), args)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_backward_equals_autograd_ragged_f64(rng, reverse):
    """13 rows (no JAX tile takes it): the hand-written backward equals
    autograd through the plain forward, dhT / dcT and h0 / c0 included."""
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in _inputs(rng, b=13, t=7, c=24, h=16, dtype=np.float64)]
    y, hT, cT, gates, cseq = lk.lstm_scan_train_fp_ref(*args, reverse)
    dy, dhT, dcT = (torch.from_numpy(rng.standard_normal(t.shape))
                    for t in (y, hT, cT))
    want = torch.autograd.grad((y, hT, cT), args, (dy, dhT, dcT))
    with torch.no_grad():
        got = lk.lstm_scan_train_fp_bwd_ref(*args, y, gates, cseq, dy, dhT,
                                            dcT, reverse)
    for g, w, name in zip(got, want, GRADS):
        assert g.dtype == w.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12,
                                   rtol=1e-10, err_msg=name)


def test_dispatch_counts_and_no_grad(rng):
    """CPU tensors take the plain versions (the launch counts stay 0); with
    no gradient to compute the forward returns the same values."""
    lk.FWD_LAUNCHES = lk.BWD_LAUNCHES = 0
    args = [torch.from_numpy(a) for a in _inputs(rng)]
    with torch.no_grad():
        y, hT, cT = lk.lstm_scan_train_fp(*args)
    ref = lk.lstm_scan_train_fp_ref(*args)
    for a, b in zip((y, hT, cT), ref):
        assert torch.equal(a, b)
    assert lk.FWD_LAUNCHES == lk.BWD_LAUNCHES == 0
