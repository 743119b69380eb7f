"""Port parity, the SDR loss family (`nnet/loss/sdr.py`): every `SDRLoss`
mode x reduction x threshold x inactive labels (and `compat` for the
source-aggregated modes), `si_snr`, `inactive_sdr_loss` and
`attenuation_ratio`, values and input gradients against the JAX package on
the same float64 inputs. Bar: atol 1e-8, rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.loss import sdr as j_sdr
from puresound_tpu_torch.nnet.loss import sdr as t_sdr

ATOL, RTOL = 1e-8, 1e-6
MODES = ("sisnr", "sdsdr", "sdr", "tsdr", "sasdr", "sasisnr", "satsdr")
SA = ("sasdr", "sasisnr", "satsdr")
N, M, L = 4, 3, 64


def _signals(rng, sa: bool):
    """References and estimates whose SNRs spread over about 40 dB, so a
    threshold keeps some items and drops others."""
    shape = (N, M, L) if sa else (N, L)
    ref = rng.standard_normal(shape)
    noise_db = np.linspace(-10, 30, int(np.prod(shape[:-1]))).reshape(shape[:-1])
    est = ref + rng.standard_normal(shape) * 10 ** (-noise_db[..., None] / 20)
    return est, ref


def _labels(sa: bool):
    lab = np.zeros((N, M) if sa else (N,), bool)
    if sa:
        lab[0, 1] = lab[2] = True          # one inactive source, one silent mixture
    else:
        lab[1] = True
    return lab


def _value_and_grad(j_fn, t_fn, *args):
    """Both sides' value and gradient w.r.t. the first argument (a weighted
    sum of the output, so unreduced outputs are covered too)."""
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a) for a in args]
        out = j_fn(*jargs)
        w = jnp.asarray(np.linspace(0.5, 1.5, np.size(out)).reshape(np.shape(out)))
        g = jax.grad(lambda a: jnp.sum(j_fn(a, *jargs[1:]) * w))(jargs[0])
        want = (np.asarray(out), np.asarray(g))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    targs[0].requires_grad_(True)
    out = t_fn(*targs)
    (g,) = torch.autograd.grad(
        (out * torch.from_numpy(np.array(w))).sum(), targs[0])
    return (out.detach().numpy(), g.numpy()), want


def _close(got, want):
    for a, b in zip(got, want):
        assert np.shape(a) == np.shape(b)
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


LOSS_CASES = [(mode, compat) for mode in MODES
              for compat in ((False, True) if mode in SA else (False,))]


@pytest.mark.parametrize("inactive", [False, True])
@pytest.mark.parametrize("threshold", [None, -15.0])
@pytest.mark.parametrize("reduction", [True, False])
@pytest.mark.parametrize("mode,compat", LOSS_CASES)
def test_sdr_loss_matches_jax(rng, mode, compat, reduction, threshold, inactive):
    sa = mode in SA
    est, ref = _signals(rng, sa)
    kw = dict(reduction=reduction, threshold=threshold, compat=compat)
    jl, tl = j_sdr.SDRLoss.init_mode(mode, **kw), t_sdr.SDRLoss.init_mode(mode, **kw)
    assert (tl.scaled, tl.source_aggregated, tl.sdr_max) == (
        jl.scaled, jl.source_aggregated, jl.sdr_max)
    args = [est, ref] + ([_labels(sa)] if inactive else [])
    _close(*_value_and_grad(jl, tl, *args))


def test_init_mode_alias_quirk_and_unknown_name():
    """"sdr" is scaled and "sasisnr" is not (the reference's substring
    check, sdr.py:78-89)."""
    assert t_sdr.SDRLoss.init_mode("sdr").scaled
    assert not t_sdr.SDRLoss.init_mode("sasisnr").scaled
    with pytest.raises(NameError):
        t_sdr.SDRLoss.init_mode("pesq")


@pytest.mark.parametrize("reduction", [True, False])
@pytest.mark.parametrize("name", ["si_snr", "inactive_sdr_loss"])
def test_metric_functions_match_jax(rng, name, reduction):
    est, ref = _signals(rng, sa=False)
    jf, tf = getattr(j_sdr, name), getattr(t_sdr, name)
    _close(*_value_and_grad(lambda a, b: jf(a, b, reduction=reduction),
                            lambda a, b: tf(a, b, reduction=reduction),
                            est, ref))


@pytest.mark.parametrize("reduction", [True, False])
def test_attenuation_ratio_matches_jax(rng, reduction):
    est, noisy = _signals(rng, sa=False)
    mask = (rng.random((N, L)) > 0.6).astype(np.float64)
    _close(*_value_and_grad(
        lambda a, b, m: j_sdr.attenuation_ratio(a, b, m, reduction),
        lambda a, b, m: t_sdr.attenuation_ratio(a, b, m, reduction),
        est, noisy, mask))
