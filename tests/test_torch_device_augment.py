"""Port parity, the on-device augmentation chain: `src.augment_torch`
against puresound_tpu/src/augment_jax.py on the CPU, in float64.

- JAX's draws (its key splits replayed here) fed into the port's `apply`
  give JAX's `__call__` outputs at atol 1e-8 / rtol 1e-6, for every
  `rir_mode`, with `vol_extra`, `inactive`, [B, 1, L] inputs and the NaN
  rollback. JAX's banks are float32 rows; the test lifts them to float64,
  as the port does at use, so both FFTs run in float64;
- the port's own draws: shapes, ranges, the generator's determinism;
- a `make_train_step` step with `augment_fn` equals the plain step on the
  batch augmented beforehand from the same generator state;
- the tasks' wiring: NS / TSE arguments, PVAD and DSS refused (JAX's chain
  fails on DSS's [N, 2, L] targets).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.src.augment_jax import DeviceAugmentor as JAug
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec
from puresound_tpu_torch.parallel import TrainState, make_train_step
from puresound_tpu_torch.src.augment_torch import DeviceAugmentor
from puresound_tpu_torch.tasks import dss, ns, tse
from puresound_tpu_torch.zoo import ns as zoo

torch.set_num_threads(1)

ATOL, RTOL = 1e-8, 1e-6
SR = 8000
B, L = 5, 700


def _banks(seed=0):
    rng = np.random.default_rng(seed)
    noise = 0.3 * rng.standard_normal((4, 1500))
    noise[1, 300:] = 0.0          # a short row once read back (trailing zeros kept)
    rir = np.zeros((3, 900))
    for i, peak in enumerate((20, 35, 60)):
        rir[i, peak] = 0.8
        t = np.arange(900 - peak - 1)
        rir[i, peak + 1:] = 0.2 * rng.standard_normal(t.size) * np.exp(-t / (80 + 40 * i))
    return noise, rir


def _pair(rir_mode="image", noise=True, rir=True, vol=(0.4, 1.3), **kw):
    nb, rb = _banks()
    args = dict(noise=nb if noise else None, rir=rb if rir else None)
    with jax.enable_x64(True):
        jaug = JAug.from_arrays(SR, rir_mode=rir_mode, vol_range=vol, **args, **kw)
        for name in ("noise_bank", "rir_bank", "rir_bank_target"):
            bank = getattr(jaug, name, None)
            if bank is not None:
                setattr(jaug, name, jnp.asarray(np.asarray(bank, np.float64)))
    aug = DeviceAugmentor.from_arrays(SR, rir_mode=rir_mode, vol_range=vol, **args, **kw)
    return jaug, aug


def jax_draws(jaug, key, n):
    """The draws of JAX's `__call__(key, ...)`, its key splits replayed
    (augment_jax.py:212-266)."""
    k_rir, k_rp, k_noise, k_np, k_vol = jax.random.split(key, 5)
    out = {}
    if jaug.rir_bank is not None:
        out["rir_idx"] = jax.random.randint(k_rir, (n,), 0, jaug.rir_bank.shape[0])
        out["rir_use"] = jax.random.uniform(k_rp, (n,)) < jaug.p_rir
    if jaug.noise_bank is not None:
        out["noise_use"] = jax.random.uniform(k_np, (n,)) < jaug.p_noise
        k_idx, k_start, k_snr = jax.random.split(k_noise, 3)
        idx = jax.random.randint(k_idx, (n,), 0, jaug.noise_bank.shape[0])
        nlen = jaug.noise_len[idx]
        out["noise_idx"] = idx
        out["noise_start"] = (jax.random.uniform(k_start, (n,))
                              * nlen.astype(jnp.float32)).astype(jnp.int32)
        out["snr_db"] = jax.random.uniform(k_snr, (n,), minval=jaug.noise_snr_range[0],
                                           maxval=jaug.noise_snr_range[1])
    if jaug.vol_range is not None:
        out["vol"] = jax.random.uniform(k_vol, (n,), minval=jaug.vol_range[0],
                                        maxval=jaug.vol_range[1])
    return {k: torch.from_numpy(np.asarray(v)).long() if k.endswith(("idx", "start"))
            else torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _signals(seed, shape=(B, L)):
    rng = np.random.default_rng(seed)
    return 0.3 * rng.standard_normal(shape), 0.2 * rng.standard_normal(shape)


def _compare(jaug, aug, noisy, clean, seed, vol_extra=None, inactive=None):
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64(True):
        kw = {}
        if vol_extra is not None:
            kw["vol_extra"] = [jnp.asarray(vol_extra)]
        if inactive is not None:
            kw["inactive"] = jnp.asarray(inactive)
        want = jaug(key, jnp.asarray(noisy), jnp.asarray(clean), **kw)
        draws = jax_draws(jaug, key, noisy.shape[0])
    got = aug.apply(torch.from_numpy(noisy), torch.from_numpy(clean), draws,
                    vol_extra=None if vol_extra is None else [torch.from_numpy(vol_extra)],
                    inactive=None if inactive is None else torch.from_numpy(inactive))
    assert len(got) == len(want)
    _close(got[0], want[0])
    _close(got[1], want[1])
    if vol_extra is not None:
        _close(got[2][0], want[2][0])
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rir_mode", ["image", "direct", "early", "anechoic"])
def test_apply_on_jax_draws_matches_jax(rir_mode, seed):
    jaug, aug = _pair(rir_mode)
    noisy, clean = _signals(seed)
    _compare(jaug, aug, noisy, clean, seed)


@pytest.mark.parametrize("parts", [dict(rir=False), dict(noise=False), dict(vol=None),
                                   dict(noise=False, rir=False)])
def test_each_part_alone_matches_jax(parts):
    jaug, aug = _pair("early", **parts)
    noisy, clean = _signals(7)
    _compare(jaug, aug, noisy, clean, 7)


def test_vol_extra_inactive_and_channel_axis_match_jax():
    jaug, aug = _pair("direct", noise_snr_range=(5.0, 15.0))
    noisy, clean = _signals(3, (B, 1, L))
    enroll = 0.25 * np.random.default_rng(9).standard_normal((B, 400))
    inactive = np.array([True, False, True, False, False])
    x, t, (e,) = _compare(jaug, aug, noisy, clean, 11, vol_extra=enroll, inactive=inactive)
    assert x.shape == t.shape == (B, 1, L) and e.shape == (B, 400)
    assert torch.equal(t[inactive], x[inactive])


def test_nan_rollback_matches_jax():
    jaug, aug = _pair("image", p_noise=1.0, p_rir=1.0)
    noisy, clean = _signals(5)
    noisy[1, 10] = np.nan         # the RIR smears it over the row: rolled back
    clean[3, 20] = np.nan
    x, t = _compare(jaug, aug, noisy, clean, 5)
    assert torch.isnan(x[1]).any() and torch.isnan(t[3]).any()   # the originals back
    for i in (0, 2, 4):
        assert not torch.equal(x[i], torch.from_numpy(noisy[i]))


def test_port_draws_are_seeded_and_in_range():
    _, aug = _pair("early", vol=(0.5, 1.5))
    d1 = aug.draw(torch.Generator().manual_seed(4), 64)
    d2 = aug.draw(torch.Generator().manual_seed(4), 64)
    assert d1.keys() == d2.keys() == {"rir_idx", "rir_use", "noise_idx", "noise_start",
                                      "snr_db", "noise_use", "vol"}
    for k in d1:
        assert torch.equal(d1[k], d2[k]) and d1[k].shape == (64,)
    assert (d1["noise_start"] < aug.noise_len[d1["noise_idx"]]).all()
    assert ((d1["snr_db"] >= -5) & (d1["snr_db"] < 15)).all()
    assert ((d1["vol"] >= 0.5) & (d1["vol"] < 1.5)).all()
    assert int(d1["rir_idx"].max()) < 3 and int(d1["noise_idx"].max()) < 4
    noisy, clean = (torch.from_numpy(a) for a in _signals(1))
    a = aug(torch.Generator().manual_seed(4), noisy, clean)
    b = aug.apply(noisy, clean, aug.draw(torch.Generator().manual_seed(4), B))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(NameError):
        DeviceAugmentor(SR, rir_mode="late")


# ------------------------------------------------------------------ the step
N_FFT, HOP = 64, 16
UNET = dict(input_type="RI", input_dim=N_FFT, norm_type="bN2d", dropout=0.1,
            channels=(1, 4, 4, 8, 8, 8), transpose_t_size=2,
            kernel_t=(2, 2, 2, 2, 2), stride_t=(1, 1, 1, 1, 1),
            dilation_t=(1, 1, 1, 1, 1), kernel_f=(5, 3, 3, 3, 3),
            stride_f=(2, 2, 1, 1, 1), dilation_f=(1, 1, 1, 1, 1),
            delay=(0, 0, 0, 0, 0), rnn_hidden=8)


def small_ns(seed=0):
    g = torch.Generator().manual_seed(seed)
    fk = dict(dtype=torch.float64)
    return SoTaskWrapModule(
        ConvEncDec(fft_length=N_FFT, win_length=N_FFT, hop_length=HOP, trainable=True,
                   output_format="Complex", **fk),
        DPCRN(**UNET, generator=g, **fk),
        loss_func_wav=zoo.init_loss({"LOSS": {"sig_loss": "sisnr"}}),
        drop_first_bin=True, mask_constraint="linear", f_type="Complex", mask_type="Complex")


def test_step_with_augment_fn_equals_step_on_the_augmented_batch():
    _, aug = _pair("early")
    fn = aug.make_augment_fn()
    noisy, clean = (torch.from_numpy(a) for a in _signals(2, (2, 640)))
    batch = {"noisy": noisy, "ref_clean": clean, "enroll": None}
    models = [small_ns(), small_ns()]
    a = TrainState(models[0], torch.optim.Adam(models[0].parameters(), lr=1e-3))
    b = TrainState(models[1], torch.optim.Adam(models[1].parameters(), lr=1e-3))
    step_a = make_train_step(models[0], grad_clip=5.0, augment_fn=fn)
    step_b = make_train_step(models[1], grad_clip=5.0)
    with pytest.raises(ValueError, match="generator"):
        step_a(a, batch)
    ga, gb = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    for _ in range(2):
        a, ma = step_a(a, batch, generator=ga)
        b, mb = step_b(b, fn(gb, batch))
        assert torch.equal(ma["loss"], mb["loss"])
    for (n, p), q in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        assert torch.equal(p, q), n
    assert not torch.equal(fn(torch.Generator().manual_seed(8), batch)["noisy"], noisy)


# --------------------------------------------------------------- the tasks
def _task(cls, tmp, **ds):
    nb, rb = _banks()
    from scipy.io import wavfile

    folders = {}
    for name, rows in (("noise", nb), ("rir", rb)):
        folders[name] = os.path.join(tmp, name)
        os.makedirs(folders[name], exist_ok=True)
        for i, row in enumerate(rows):
            wavfile.write(os.path.join(folders[name], f"{i}.wav"), SR,
                          (np.clip(row, -1, 1) * 32767).astype(np.int16))
    task = object.__new__(cls)
    task.device = torch.device("cpu")
    task.hparam = {"DATASET": dict(sample_rate=SR, noise_folder=folders["noise"],
                                   rir_folder=folders["rir"], rir_mode="direct",
                                   vol_perturbed="0.5,1.5", augment_on_device=True, **ds)}
    return task


def test_ns_and_tse_tasks_build_jax_arguments(tmp_path):
    for cls, snr in ((ns.NsTask, (-5.0, 15.0)), (tse.TseTask, (5.0, 15.0))):
        task = _task(cls, str(tmp_path), type="tse")
        fn = task._device_augment_fn()
        aug = task.device_augmentor
        assert aug.noise_snr_range == snr and aug.vol_range == (0.5, 1.5)
        assert aug.rir_mode == "direct" and aug.rir_bank.shape[0] == 3
        batch = {"noisy": torch.zeros(2, 300, dtype=torch.float64) + 0.1,
                 "ref_clean": torch.zeros(2, 300, dtype=torch.float64) + 0.05,
                 "enroll": torch.full((2, 200), 0.2, dtype=torch.float64),
                 "inactive_labels": torch.tensor([True, False])}
        out = fn(torch.Generator().manual_seed(0), batch)
        if cls is tse.TseTask:
            assert not torch.equal(out["enroll"], batch["enroll"])      # the volume
            assert torch.equal(out["ref_clean"][0], out["noisy"][0])    # inactive
        else:
            assert torch.equal(out["enroll"], batch["enroll"])


def test_pvad_and_dss_refuse_the_device_chain(tmp_path):
    with pytest.raises(ValueError, match="PVAD"):
        _task(tse.TseTask, str(tmp_path), type="pvad")._device_augment_fn()
    with pytest.raises(ValueError, match=r"\[N, 2, L\]"):
        _task(dss.DssTask, str(tmp_path))._device_augment_fn()


@pytest.mark.parametrize("parts", [dict(rir=False, vol=None), dict(noise=False, vol=None),
                                   dict(noise=False, rir=False)])
def test_jax_chain_fails_on_dss_targets(parts):
    """What DssTask refuses: JAX's DssTask batch ([N, L] mixture, [N, 2, L]
    near / far targets) through JAX's augment_fn."""
    jaug, _ = _pair("image", **parts)
    rng = np.random.default_rng(0)
    batch = {"noisy": jnp.asarray(rng.standard_normal((4, L)), jnp.float32),
             "ref_clean": jnp.asarray(rng.standard_normal((4, 2, L)), jnp.float32),
             "inactive_labels": jnp.zeros((4, 2), bool)}
    with pytest.raises((TypeError, ValueError)):
        jax.jit(jaug.make_augment_fn())(jax.random.PRNGKey(0), batch)
