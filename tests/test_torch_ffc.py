"""Port parity, the FFC family: `LayerNorm2D`, `SpectralTransform` and `FFC`
against JAX's (puresound_tpu/nnet/lobe/norm.py:97, cnn.py:294, :327) in
float64, in training mode (BatchNorm's batch statistics and the updated
running statistics) and in eval mode, with the weights loaded through
`utils.from_jax`; the norm module's aliases and `is_batchnorm`. Bar: atol
1e-8, rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.lobe import cnn as j_cnn
from puresound_tpu.nnet.lobe import norm as j_norm
from puresound_tpu_torch.nnet.lobe import cnn as t_cnn
from puresound_tpu_torch.nnet.lobe import norm as t_norm
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=what)


def _perturbed_f64(variables, rng):
    """JAX's initial variables in float64, the parameters moved off their
    init and the running statistics set (variances positive)."""
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(variables))
    out = {"params": jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape), v["params"])}
    if "batch_stats" in v:
        out["batch_stats"] = jax.tree_util.tree_map(
            lambda a: 0.5 + np.abs(rng.standard_normal(a.shape)) if a.min() == 1.0
            else 0.3 * rng.standard_normal(a.shape), v["batch_stats"])
    return out


def _jax_apply(module, v, x, train):
    """JAX's output (and, in training, its updated batch_stats), jitted on
    float64."""
    with jax.enable_x64(True):
        if train:
            fn = lambda v, x: module.apply(v, x, True, mutable=["batch_stats"])
        else:
            fn = lambda v, x: (module.apply(v, x, False), None)
        out, upd = jax.jit(fn)(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x))
        return np.asarray(out), (jax.device_get(upd["batch_stats"]) if upd else None)


def _port(tm, flat, train):
    tm.load_state_dict(fj.to_torch(flat), strict=True)
    return tm.train(train)


def _running(tm, flat_want):
    names = [n for n in tm.state_dict() if "running" in n]
    assert names
    for n in names:
        _close(tm.state_dict()[n], flat_want[n], n)


# ------------------------------------------------------------ LayerNorm2D
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 4, 9, 2)])
def test_layer_norm_2d_matches_jax(rng, shape):
    N, CH, F, T = shape
    jm = j_norm.LayerNorm2D(CH, F)
    x = 2.0 + rng.standard_normal(shape)
    v = _perturbed_f64(jm.init(KEY, jnp.zeros(shape)), rng)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jm.apply)(jax.tree_util.tree_map(jnp.asarray, v),
                                            jnp.asarray(x)))
    tm = _port(t_norm.LayerNorm2D(CH, F, dtype=torch.float64), fj.layer_norm_2d(v["params"]),
               False)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want)


def test_layer_norm_2d_init_and_bf16(rng):
    """JAX's init (w 1, b 1e-4) loads as the port's own; a bfloat16 input
    comes out bfloat16, its statistics taken in float32 (>= 40 dB from
    float64: the roundings of x, the normalisation and the affine)."""
    jm = j_norm.LayerNorm2D(3, 8)
    v = jax.device_get(jm.init(KEY, jnp.zeros((1, 3, 8, 4))))
    flat = fj.layer_norm_2d(v["params"])
    tm = t_norm.LayerNorm2D(3, 8)
    for k, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), flat[k])
    x = torch.from_numpy(0.5 + rng.standard_normal((2, 3, 8, 6)))
    with torch.no_grad():
        want = t_norm.LayerNorm2D(3, 8, dtype=torch.float64)(x)
        got = tm(x.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.double()
    snr = 10 * np.log10((want ** 2).sum().item() / ((got - want) ** 2).sum().item())
    assert snr >= 40.0, snr


# ------------------------------------------------------- SpectralTransform
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("causal,F", [(True, 16), (False, 15)], ids=["causal", "noncausal"])
def test_spectral_transform_matches_jax(rng, causal, F, train):
    N, CIN, COUT, T = 2, 4, 6, 9
    jm = j_cnn.SpectralTransform(CIN, COUT, (3, 3), (1, 1), causal)
    x = rng.standard_normal((N, CIN, F, T))
    v = _perturbed_f64(jm.init(KEY, jnp.zeros((N, CIN, F, T))), rng)
    want, stats = _jax_apply(jm, v, x, train)
    tm = _port(t_cnn.SpectralTransform(CIN, COUT, (3, 3), (1, 1), causal,
                                       dtype=torch.float64),
               fj.spectral_transform(v["params"], v["batch_stats"]), train)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want)
    if train:
        _running(tm, fj.spectral_transform(v["params"], stats))


# --------------------------------------------------------------------- FFC
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("alpha", [0.3, 0.5])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_ffc_matches_jax(rng, causal, alpha, train):
    N, CIN, COUT, F, T = 2, 10, 12, 16, 7
    jm = j_cnn.FFC(CIN, COUT, alpha=alpha, kernel_size=(3, 3), causal=causal)
    x = rng.standard_normal((N, CIN, F, T))
    v = _perturbed_f64(jm.init(KEY, jnp.zeros((N, CIN, F, T))), rng)
    want, stats = _jax_apply(jm, v, x, train)
    tm = _port(t_cnn.FFC(CIN, COUT, alpha=alpha, kernel_size=(3, 3), causal=causal,
                         dtype=torch.float64),
               fj.ffc(v["params"], v["batch_stats"]), train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape == (N, COUT, F, T)
    _close(got, want)
    if train:
        _running(tm, fj.ffc(v["params"], stats))


@pytest.mark.parametrize("cin,cout", [(3, 3), (3, 10), (10, 3)])
def test_ffc_zero_channel_branch_raises_as_jax(cin, cout):
    """int(C * alpha) == 0 for the input or the output: a zero-channel
    conv's init divides by zero, in JAX (at init) and in the port."""
    with pytest.raises(ZeroDivisionError):
        j_cnn.FFC(cin, cout, alpha=0.3).init(KEY, jnp.zeros((1, cin, 8, 4)))
    with pytest.raises(ZeroDivisionError):
        t_cnn.FFC(cin, cout, alpha=0.3)


def test_ffc_converter_round_trip():
    """JAX-initialised variables (params and batch_stats) load strictly into
    the port's FFC: the same names, shapes and values."""
    jm = j_cnn.FFC(10, 12, alpha=0.3)
    v = jax.device_get(jm.init(KEY, jnp.zeros((1, 10, 8, 4))))
    flat = fj.ffc(v["params"], v["batch_stats"])
    tm = t_cnn.FFC(10, 12, alpha=0.3)
    sd = tm.state_dict()
    assert set(flat) == set(sd)
    assert all(flat[k].shape == tuple(sd[k].shape) for k in sd)
    tm.load_state_dict(fj.to_torch(flat), strict=True)
    for k, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), flat[k])
    # JAX's fresh statistics are torch's: mean 0, variance 1
    assert all(np.all(flat[k] == (1.0 if k.endswith("var") else 0.0))
               for k in flat if "running" in k)


def test_ffc_causal_time_padding(rng):
    """Causal FFC: the output at frame t does not change when frames > t do
    (tests/test_filter_ffc.py:165); a non-causal one's does."""
    N, CIN, F, T = 1, 10, 16, 12
    x = rng.standard_normal((N, CIN, F, T))
    x2 = x.copy()
    x2[..., 6:] = rng.standard_normal((N, CIN, F, T - 6))
    for causal in (True, False):
        tm = t_cnn.FFC(CIN, CIN, alpha=0.3, causal=causal, dtype=torch.float64).eval()
        with torch.no_grad():
            base, pert = (tm(torch.from_numpy(a)).numpy() for a in (x, x2))
        if causal:
            np.testing.assert_array_equal(pert[..., :6], base[..., :6])
            assert np.abs(pert[..., 6:] - base[..., 6:]).max() > 1e-4
        else:
            assert np.abs(pert[..., 5] - base[..., 5]).max() > 1e-4


def test_ffc_bf16_fft_in_float32(rng):
    """JAX's FFT refuses bfloat16; the port's bf16 FFC takes the FFT-domain
    part in float32 and casts back: >= 30 dB from its float64 run."""
    with pytest.raises(ValueError):
        jnp.fft.rfft(jnp.ones((2, 8), jnp.bfloat16), axis=1)
    tm = t_cnn.FFC(10, 10, alpha=0.3).eval()
    x = torch.from_numpy(rng.standard_normal((2, 10, 16, 8)))
    with torch.no_grad():
        want = tm.double()(x)
        got = tm.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = ((got.double() - want) ** 2).sum().item()
    assert 10 * np.log10((want ** 2).sum().item() / err) >= 30.0


# -------------------------------------------------------- aliases, registry
ALIASES = ("gLN", "cLN", "iLN", "bN1d", "bN2d", "gGN", "LN2D")


@pytest.mark.parametrize("name", ALIASES)
def test_norm_aliases_and_is_batchnorm_as_jax(name):
    jcls, tcls = getattr(j_norm, name), getattr(t_norm, name)
    assert tcls.__name__ == jcls.__name__
    assert t_norm.is_batchnorm(name) == j_norm.is_batchnorm(name)
    in_registry = name in j_norm._REGISTRY
    assert (name in t_norm._REGISTRY) == in_registry
    if in_registry:
        assert t_norm.get_norm(name) is tcls
    else:
        with pytest.raises(NameError):
            t_norm.get_norm(name)
