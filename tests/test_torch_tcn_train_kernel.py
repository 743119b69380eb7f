"""Port parity, the training TCN kernel's plain versions
(`ops/tcn_train_kernel.py`) and the `TCN` module that routes through them:

- the plain forward and VJP against the JAX package's Pallas
  `tcn_block_train` in interpret mode on the same inputs: float32 y at atol
  2e-5 / rtol 1e-5 (JAX's own bar, tests/test_pallas_kernels.py:544) and
  every gradient at >= 60 dB SNR; bfloat16 at >= 40 dB on y and >= 30 dB on
  the gradients; at dilations 1 and 4 with T = 100 (no tile multiple) and
  at dilation 16 with T = 13 (every outer tap falls outside the sample);
- the plain versions in float64 against the port's stock module under
  autograd (atol 1e-8 / rtol 1e-6);
- the port's `TCN` (through the autograd Function) against the JAX stock
  `TCN.apply` in float64, output and all 16 parameter gradients.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.ops.tcn_train_kernel import tcn_block_train as j_block
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.ops import tcn_train_kernel as tk
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
B, C, CH, K = 3, 16, 24, 3
CASES = [(1, 100), (4, 100), (16, 13)]   # (dilation, T)


def _jax_variables(rng, dilation, T):
    """(JAX stock TCN, its params perturbed away from the init, in f64)."""
    m = JTCN(C, CH, kernel=K, dilation=dilation, causal=False,
             tcn_norm="gLN", dconv_norm="gGN")
    p = m.init(KEY, jnp.zeros((B, C, T)))
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + 0.1 * rng.standard_normal(np.shape(a)), jax.device_get(p))
    return m, p


def _args(pp):
    """The kernel's 16 parameters from a JAX TCN params tree (numpy)."""
    d = pp["dconv"]
    return [pp["in_conv"]["w"][:, :, 0], pp["in_norm"]["gamma"],
            pp["in_norm"]["beta"], pp["in_act"]["alpha"],
            d["dw_conv"]["w"][:, 0, :], d["dw_conv"]["b"], d["dw_norm"]["gamma"],
            d["dw_norm"]["beta"], d["dw_act"]["alpha"], d["pw_conv"]["w"][:, :, 0],
            d["pw_conv"]["b"], d["pw_norm"]["gamma"], d["pw_norm"]["beta"],
            d["pw_act"]["alpha"], pp["out_conv"]["w"][:, :, 0], pp["out_conv"]["b"]]


def _snr_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.sum((got - want) ** 2)
    return 10 * math.log10(np.sum(want ** 2) / max(err, 1e-300))


def _jax_kernel(x, params, w, dilation, dtype):
    dd = jnp.bfloat16 if dtype == jnp.bfloat16 else jnp.float32
    args = [jnp.asarray(a, dtype) for a in [x, *params]]
    f = lambda *a: j_block(*a, dilation, 0, True, dd)
    loss = lambda *a: jnp.sum(f(*a).astype(jnp.float32) * w)
    y = f(*args)
    grads = jax.grad(loss, argnums=tuple(range(17)))(*args)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return f32(y), [f32(g) for g in grads]


def _port_kernel(x, params, w, dilation, dtype):
    targs = [torch.tensor(np.asarray(a), dtype=dtype, requires_grad=True)
             for a in [x, *params]]
    y = tk.tcn_block_train(*targs, dilation=dilation)
    loss = (y.float() * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, targs)
    f32 = lambda t: t.detach().float().numpy()
    return f32(y), [f32(g) for g in grads]


@pytest.mark.parametrize("dilation,T", CASES)
def test_plain_matches_pallas_interpret_f32(rng, dilation, T):
    _, p = _jax_variables(rng, dilation, T)
    params = [a.astype(np.float32) for a in _args(p["params"])]
    x = rng.standard_normal((B, C, T)).astype(np.float32)
    w = rng.standard_normal((B, C, T)).astype(np.float32)
    want_y, want_g = _jax_kernel(x, params, w, dilation, jnp.float32)
    got_y, got_g = _port_kernel(x, params, w, dilation, torch.float32)
    np.testing.assert_allclose(got_y, want_y, atol=2e-5, rtol=1e-5)
    for name, got, want in zip(("dx",) + tk.PARAM_NAMES, got_g, want_g):
        assert got.shape == want.shape, name
        assert _snr_db(got, want) >= 60.0, (name, _snr_db(got, want))


@pytest.mark.parametrize("dilation,T", CASES)
def test_plain_matches_pallas_interpret_bf16(rng, dilation, T):
    """bf16 x and parameters: the dot operands rounded to bf16, the rest in
    f32 on both sides; the sums run in another order, so the bars are SNR."""
    _, p = _jax_variables(rng, dilation, T)
    params = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
              for a in _args(p["params"])]
    x = np.asarray(jnp.asarray(rng.standard_normal((B, C, T)), jnp.bfloat16)
                   .astype(jnp.float32))
    w = rng.standard_normal((B, C, T)).astype(np.float32)
    want_y, want_g = _jax_kernel(x, params, w, dilation, jnp.bfloat16)
    got_y, got_g = _port_kernel(x, params, w, dilation, torch.bfloat16)
    assert _snr_db(got_y, want_y) >= 40.0
    for name, got, want in zip(("dx",) + tk.PARAM_NAMES, got_g, want_g):
        assert _snr_db(got, want) >= 30.0, (name, _snr_db(got, want))


@pytest.mark.parametrize("dilation,T", CASES)
def test_plain_exact_reference_keeps_the_cast_points(rng, dilation, T):
    """`compute_dtype=float64` runs the math in float64 and returns in it:
    for float32 x it is the float64 plain version; for bfloat16 x it keeps
    the bfloat16 dot operands, so it stays near the float32-math bf16 run
    and away from the unrounded float64 one."""
    _, p = _jax_variables(rng, dilation, T)
    params = [torch.from_numpy(a.astype(np.float32)) for a in _args(p["params"])]
    x = torch.from_numpy(rng.standard_normal((B, C, T)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((B, C, T)).astype(np.float32))
    f64 = torch.float64
    run = lambda x, dy, ps, **kw: ([tk.tcn_block_train_ref(x, *ps, dilation=dilation, **kw)]
                                   + list(tk.tcn_block_train_bwd_ref(x, dy, *ps,
                                                                     dilation=dilation, **kw)))
    exact = run(x, dy, params, compute_dtype=f64)
    plain64 = run(x.double(), dy.double(), [q.double() for q in params])
    for got, want in zip(exact, plain64):
        assert got.dtype == f64
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    bf = torch.bfloat16
    xb, dyb, pb = x.to(bf), dy.to(bf), [q.to(bf) for q in params]
    exact = run(xb, dyb, pb, compute_dtype=f64)
    plain = run(xb, dyb, pb)
    unrounded = run(xb.double(), dyb.double(), [q.double() for q in pb])
    assert all(t.dtype == f64 for t in exact)
    assert _snr_db(plain[0].float(), exact[0]) >= 40.0
    for name, got, want in zip(("dx",) + tk.PARAM_NAMES, plain[1:], exact[1:]):
        assert _snr_db(got.float(), want) >= 30.0, name
    assert _snr_db(exact[0], unrounded[0]) < 80.0    # the bf16 rounding is there


def _port_tcn(p, dilation):
    m = TCN(C, CH, K, dilation, dtype=torch.float64)
    m.load_state_dict(fj.to_torch(fj.tcn(p["params"])), strict=True)
    return m


@pytest.mark.parametrize("dilation,T", CASES)
def test_plain_f64_matches_stock_module_autograd(rng, dilation, T):
    """The hand-written VJP against autograd through the port's stock path
    (conv1d / GlobLN / GroupNorm1 / PReLU) on the same f64 weights."""
    _, p = _jax_variables(rng, dilation, T)
    m = _port_tcn(p, dilation)
    x = torch.from_numpy(rng.standard_normal((B, C, T))).requires_grad_()
    dy = torch.from_numpy(rng.standard_normal((B, C, T)))
    stock = m.out_conv(m.dconv(m.in_conv(x))) + x
    ds = m.dconv[0]
    bases = [m.in_conv[0].weight, m.in_conv[1].gamma, m.in_conv[1].beta,
             m.in_conv[2].weight, ds.depthwise[0].weight, ds.depthwise[0].bias,
             ds.depthwise[1].weight, ds.depthwise[1].bias, ds.depthwise[2].weight,
             ds.pointwise[0].weight, ds.pointwise[0].bias, ds.pointwise[1].weight,
             ds.pointwise[1].bias, ds.pointwise[2].weight, m.out_conv.weight,
             m.out_conv.bias]
    want = torch.autograd.grad(stock, (x, *bases), dy)
    params = m.fused_params()
    with torch.no_grad():
        y = tk.tcn_block_train_ref(x, *params, dilation=dilation)
        got = tk.tcn_block_train_bwd_ref(x, dy, *params, dilation=dilation)
    np.testing.assert_allclose(y.numpy(), stock.detach().numpy(), atol=1e-8,
                               rtol=1e-6)
    for name, g, w_ in zip(("dx",) + tk.PARAM_NAMES, got, want):
        assert g.dtype == torch.float64 and g.numel() == w_.numel(), name
        np.testing.assert_allclose(g.reshape(w_.shape).numpy(), w_.numpy(),
                                   atol=1e-8, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("dilation,T", CASES)
def test_port_tcn_matches_jax_stock_f64(rng, dilation, T):
    """The port's TCN (through the Function) against JAX's stock TCN.apply
    with jax.enable_x64: output, dx and all 16 parameter gradients."""
    jm, p = _jax_variables(rng, dilation, T)
    m = _port_tcn(p, dilation)
    x = rng.standard_normal((B, C, T))
    w = rng.standard_normal((B, C, T))
    with jax.enable_x64(True):
        loss = lambda v, x: jnp.sum(jm.apply(v, x) * w)
        want_y = np.asarray(jm.apply(p, jnp.asarray(x)))
        gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = m(xt)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-8, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-8,
                               rtol=1e-6)
    want_g = fj.tcn(jax.device_get(gp["params"]))
    got_g = {n: q.grad for n, q in m.named_parameters()}
    assert set(got_g) == set(want_g) and len(got_g) == 16
    for name, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[name], atol=1e-8,
                                   rtol=1e-6, err_msg=name)


def test_dispatch_counts_and_stock_fallback(rng):
    """CPU tensors take the plain versions (the launch counts stay 0, no
    gradient gives the same values); a BatchNorm block takes the stock
    path, as JAX's `_fusable` sends it there."""
    tk.FWD_LAUNCHES = tk.BWD_LAUNCHES = 0
    m = TCN(C, CH, K, 2, dtype=torch.float64,
            generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((B, C, 40)))
    with torch.no_grad():
        y = m(x)
        stock = m.out_conv(m.dconv(m.in_conv(x))) + x
    np.testing.assert_allclose(y.numpy(), stock.numpy(), atol=1e-10)
    m(x.requires_grad_()).sum().backward()
    assert tk.FWD_LAUNCHES == tk.BWD_LAUNCHES == 0
    bn = TCN(C, CH, K, 2, tcn_norm="bN1d", dconv_norm="bN1d").eval()
    assert bn.fused_params() is None
    assert bn(torch.zeros(2, C, 10)).shape == (2, C, 10)
    with pytest.raises(ValueError, match="taps"):
        tk._check(torch.zeros(2, C, 10), [torch.zeros(s) for s in (
            (CH, C), (CH,), (CH,), (1,), (CH, 2), (CH,), (CH,), (CH,), (1,),
            (CH, CH), (CH,), (CH,), (CH,), (1,), (C, CH), (C,))])
