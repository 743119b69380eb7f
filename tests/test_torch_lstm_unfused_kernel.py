"""Port parity, the training LSTM kernels' entries beside
`lstm_scan_train_fp`: the hoisted-projection scan `lstm_scan_train`
(batch-major) and `lstm_scan_train_tm` (time-major), and the time-major
entry to the fused kernel, `lstm_scan_train_fp_tm`
(`ops/lstm_train_kernel.py`).

- Their plain forward and VJP against the JAX package's Pallas kernels in
  interpret mode on the same f32 inputs (b_tile 4, a divisor of B, as
  tests/test_pallas_kernels.py:262-305 and :761 run them), both directions,
  at JAX's own bars: values atol 1e-6, gradients atol 2e-6.
- bf16 inputs against JAX's bf16 kernels at SNR >= 40 dB (the two sum in
  another order; measured bit-equal on this CPU), and the bf16 rounding
  rule: the hoisted xp is rounded before the kernel and the fused route
  never rounds it, so the two routes agree in float64 and differ in bf16.
- gradcheck in float64, the hand-written backward against autograd through
  the plain forward at a ragged row count, and the time-major entries
  against the batch-major ones bit for bit (the same arithmetic)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.ops import lstm_train_kernel as jk
from puresound_tpu_torch.ops import lstm_train_kernel as lk

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

B, T, H, C = 8, 12, 16, 8
ENTRIES = ("lstm_scan_train", "lstm_scan_train_tm", "lstm_scan_train_fp_tm")
TIME_MAJOR = {"lstm_scan_train": False, "lstm_scan_train_tm": True,
              "lstm_scan_train_fp_tm": True}


def _inputs(rng, entry, b=B, t=T, c=C, h=H, dtype=np.float32):
    """The entry's differentiable inputs, seed-made with numpy."""
    mk = lambda shape, k: (rng.standard_normal(shape) * k).astype(dtype)
    states = [mk((b, h), 0.3), mk((b, h), 0.3)]
    if entry == "lstm_scan_train_fp_tm":
        return [mk((t, b, c), 0.4)] + states + [mk((c, 4 * h), 0.3),
                                               mk((4 * h,), 0.2), mk((h, 4 * h), 0.2)]
    xp = mk((t, b, 4 * h), 0.4) if TIME_MAJOR[entry] else mk((b, t, 4 * h), 0.4)
    return [xp] + states + [mk((h, 4 * h), 0.2)]


def _cotangent(entry, b, t, h):
    """The loss sum(y * w) + sum(hT^2) + sum(0.3 * cT) of the JAX tests,
    with w laid out as the entry's y."""
    w = np.cos(np.arange(b * t * h).reshape(b, t, h) * 0.1)
    return w.transpose(1, 0, 2) if TIME_MAJOR[entry] else w


def _jax_value_and_grads(entry, args, reverse, dtype=jnp.float32):
    dd = jnp.bfloat16 if dtype == jnp.bfloat16 else jnp.float32
    fn = lambda *a: getattr(jk, entry)(*a, reverse, 4, True, dd)
    jargs = tuple(jnp.asarray(a, dtype) for a in args)
    b, h = args[1].shape
    t = args[0].shape[0 if TIME_MAJOR[entry] else 1]
    w = jnp.asarray(_cotangent(entry, b, t, h), dtype)

    def loss(a):
        y, hT, cT = fn(*a)
        return (jnp.sum((y * w).astype(jnp.float32))
                + jnp.sum(hT.astype(jnp.float32) ** 2)
                + jnp.sum(cT.astype(jnp.float32) * 0.3))

    outs = fn(*jargs)
    grads = jax.grad(loss)(jargs)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return [f32(o) for o in outs], [f32(g) for g in grads]


def _port_value_and_grads(entry, args, reverse, dtype=torch.float32):
    targs = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in args]
    y, hT, cT = getattr(lk, entry)(*targs, reverse=reverse)
    b, h = hT.shape
    t = y.shape[0 if TIME_MAJOR[entry] else 1]
    w = torch.tensor(_cotangent(entry, b, t, h), dtype=dtype)
    loss = ((y * w).float().sum() + (hT.float() ** 2).sum()
            + (cT.float() * 0.3).sum())
    grads = torch.autograd.grad(loss, targs)
    f32 = lambda x: x.detach().float().numpy()
    return [f32(o) for o in (y, hT, cT)], [f32(g) for g in grads]


def _snr_db(got, want):
    err = np.sum((got.astype(np.float64) - want) ** 2)
    return 10 * math.log10(np.sum(want.astype(np.float64) ** 2) / max(err, 1e-300))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("entry", ENTRIES)
def test_plain_matches_pallas_interpret_f32(rng, entry, reverse):
    args = _inputs(rng, entry)
    want_v, want_g = _jax_value_and_grads(entry, args, reverse)
    got_v, got_g = _port_value_and_grads(entry, args, reverse)
    for got, want, name in zip(got_v, want_v, ("y", "hT", "cT")):
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    assert len(got_g) == len(want_g) == len(args)
    for i, (got, want) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=f"grad {i}")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("entry", ENTRIES)
def test_plain_matches_pallas_interpret_bf16(rng, entry, reverse):
    """bf16 inputs, weights and states: dots on bf16 operands summed in f32;
    y / gates / c and (hoisted) dxp stored in bf16, c0 rounded to bf16 at
    the hoisted backward's boundary step, as JAX's concatenation does."""
    args = _inputs(rng, entry)
    want_v, want_g = _jax_value_and_grads(entry, args, reverse, jnp.bfloat16)
    got_v, got_g = _port_value_and_grads(entry, args, reverse, torch.bfloat16)
    for i, (got, want) in enumerate(zip(got_v + got_g, want_v + want_g)):
        assert _snr_db(got, want) >= 40.0, (i, _snr_db(got, want))


@pytest.mark.parametrize("entry", ENTRIES)
def test_function_gradcheck_f64(rng, entry):
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in _inputs(rng, entry, b=3, t=4, c=3, h=2, dtype=np.float64)]
    for reverse in (False, True):
        assert torch.autograd.gradcheck(
            lambda *a: getattr(lk, entry)(*a, reverse=reverse), args)


@pytest.mark.parametrize("reverse", [False, True])
def test_hoisted_backward_equals_autograd_ragged_f64(rng, reverse):
    """13 rows: the hand-written hoisted backward equals autograd through
    the plain forward, dhT / dcT and h0 / c0 included."""
    args = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in _inputs(rng, "lstm_scan_train_tm", b=13, t=7, h=16,
                             dtype=np.float64)]
    y, hT, cT, gates, cseq = lk.lstm_scan_train_ref(*args, reverse)
    dy, dhT, dcT = (torch.from_numpy(rng.standard_normal(t.shape)) for t in (y, hT, cT))
    want = torch.autograd.grad((y, hT, cT), args, (dy, dhT, dcT))
    with torch.no_grad():
        got = lk.lstm_scan_train_bwd_ref(*args, y, gates, cseq, dy, dhT, dcT, reverse)
    for g, w, name in zip(got, want, ("dxp", "dh0", "dc0", "dw_hh")):
        assert g.dtype == w.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12, rtol=1e-10,
                                   err_msg=name)


def _values_and_grads(fn, args, cot):
    args = [a.detach().clone().requires_grad_() for a in args]
    outs = fn(*args)
    grads = torch.autograd.grad(outs, args, cot)
    return [o.detach() for o in outs], list(grads)


@pytest.mark.parametrize("reverse", [False, True])
def test_time_major_entries_equal_batch_major_bit_for_bit(rng, reverse):
    """lstm_scan_train_fp_tm against lstm_scan_train_fp and
    lstm_scan_train_tm against lstm_scan_train, on the same data: the same
    arithmetic, so equal bit for bit, values and every gradient."""
    x, h0, c0, w_ih, bias, w_hh = (torch.from_numpy(a) for a in
                                   _inputs(rng, "lstm_scan_train_fp_tm"))
    dy_t = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32))
    dhT, dcT = (torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
                for _ in range(2))
    sw = lambda a: a.transpose(0, 1).contiguous()
    pairs = (
        (lambda x_t, *a: lk.lstm_scan_train_fp_tm(x_t, *a, reverse=reverse),
         lambda x_t, *a: (lambda y, hT, cT: (sw(y), hT, cT))(
             *lk.lstm_scan_train_fp(sw(x_t), *a, reverse=reverse)),
         (x, h0, c0, w_ih, bias, w_hh)),
        (lambda xp_t, *a: lk.lstm_scan_train_tm(xp_t, *a, reverse=reverse),
         lambda xp_t, *a: (lambda y, hT, cT: (sw(y), hT, cT))(
             *lk.lstm_scan_train(sw(xp_t), *a, reverse=reverse)),
         (torch.from_numpy(_inputs(rng, "lstm_scan_train_tm")[0]), h0, c0, w_hh)),
    )
    for tm_fn, bm_fn, args in pairs:
        got_v, got_g = _values_and_grads(tm_fn, args, (dy_t, dhT, dcT))
        want_v, want_g = _values_and_grads(bm_fn, args, (dy_t, dhT, dcT))
        for a, b in zip(got_v + got_g, want_v + want_g):
            assert torch.equal(a, b)


@pytest.mark.parametrize("reverse", [False, True])
def test_hoisted_route_equals_fused_route_f64(rng, reverse):
    """x @ w_ih + bias hoisted into lstm_scan_train against the projection
    inside lstm_scan_train_fp: the same function, values and all six
    gradients (autograd through the projection gives dx, dw_ih, dbias)."""
    args = [torch.tensor(a, dtype=torch.float64) for a in
            _inputs(rng, "lstm_scan_train_fp_tm", dtype=np.float64)]
    args[0] = args[0].transpose(0, 1).contiguous()        # batch-major x
    cot = [torch.from_numpy(rng.standard_normal(s)) for s in ((B, T, H), (B, H), (B, H))]
    fused = lambda x, h0, c0, wi, b, wh: lk.lstm_scan_train_fp(x, h0, c0, wi, b, wh,
                                                               reverse=reverse)
    hoisted = lambda x, h0, c0, wi, b, wh: lk.lstm_scan_train(x @ wi + b, h0, c0, wh,
                                                              reverse=reverse)
    got_v, got_g = _values_and_grads(hoisted, args, cot)
    want_v, want_g = _values_and_grads(fused, args, cot)
    for a, b in zip(got_v + got_g, want_v + want_g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12, rtol=1e-10)


def test_hoisted_route_rounds_xp_under_bf16(rng):
    """Under bf16 the hoisted projection reaches the kernel rounded to bf16
    and the fused kernel never rounds it: the routes differ, each held to
    JAX above. The hoisted forward equals the plain version fed the rounded
    xp, which the fused route's plain version does not."""
    x, h0, c0, w_ih, bias, w_hh = (torch.from_numpy(a).to(torch.bfloat16) for a in
                                   _inputs(rng, "lstm_scan_train_fp_tm"))
    xp_t = x @ w_ih + bias                                 # bf16, rounded
    y_h = lk.lstm_scan_train_tm(xp_t, h0, c0, w_hh)[0]
    y_f = lk.lstm_scan_train_fp_tm(x, h0, c0, w_ih, bias, w_hh)[0]
    assert torch.equal(y_h, lk.lstm_scan_train_ref(xp_t, h0, c0, w_hh)[0])
    assert not torch.equal(y_h, y_f)
    assert _snr_db(y_h.float().numpy(), y_f.float().numpy()) >= 30.0


def test_dispatch_counts_and_no_grad(rng):
    """CPU tensors take the plain versions (no launch counted); with no
    gradient to compute the forward returns the same values."""
    lk.FWD_BY_ENTRY.clear()
    lk.BWD_BY_ENTRY.clear()
    for entry in ENTRIES:
        args = [torch.from_numpy(a) for a in _inputs(rng, entry)]
        with torch.no_grad():
            got = getattr(lk, entry)(*args)
        grad_args = [a.clone().requires_grad_() for a in args]
        want = getattr(lk, entry)(*grad_args)
        for a, b in zip(got, want):
            assert torch.equal(a, b.detach())
    assert lk.FWD_BY_ENTRY == lk.BWD_BY_ENTRY == {}


@pytest.mark.parametrize("bad", ["xp_width", "batch_major_hoisted"])
def test_launch_checks_refuse_bad_inputs(rng, bad):
    """The CUDA wrappers' checks run before any launch: an xp that is not
    4H wide, and a hoisted scan asked for batch-major xp."""
    xp_t, h0, c0, w_hh = (torch.from_numpy(a) for a in _inputs(rng, "lstm_scan_train_tm"))
    if bad == "xp_width":
        with pytest.raises(ValueError, match="shape mismatch"):
            lk._check(xp_t[..., :-1], h0, c0, None, None, w_hh, True)
    else:
        with pytest.raises(ValueError, match="time-major"):
            lk._launch_fwd(xp_t, h0, c0, None, None, w_hh, False, True,
                           time_major=False)
