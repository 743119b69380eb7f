"""Port parity, the host augmentation chain: `AudioAugmentor` and the NS /
TSE / DSS datasets with every host option on, against the JAX package on
the CPU, bit for bit.

- every `AudioAugmentor` method gives JAX's bytes at the same `random` /
  `np.random` seeds, on the native library's route (resampler, biquad) and
  on scipy's;
- `NsDataset` (every `rir_mode`), `TseDataset` (with `enroll_augment` and
  inactive targets, TSE and PVAD) and `DssDataset` (noise, speed, volume)
  give JAX's batches through the port's `DataLoader` at 0 and 2 workers;
- the corpora (noise, RIR) are written from numpy seeds: noises shorter
  and longer than the crop, at the dataset's rate and at twice it, a
  stereo RIR (its channel drawn).
"""
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from puresound_tpu.src import audio as jaudio
from puresound_tpu.src import native as jnative
from puresound_tpu.src import utils as jutils
from puresound_tpu.tasks import base as jbase
from puresound_tpu.tasks import dss as jdss
from puresound_tpu.tasks import ns as jns
from puresound_tpu.tasks import tse as jtse
from puresound_tpu_torch.src import audio
from puresound_tpu_torch.src import native
from puresound_tpu_torch.src import utils
from puresound_tpu_torch.tasks import base, dss, ns, tse

torch.set_num_threads(1)

SR = 8000


def _write(path, sig, sr=SR):
    sig = np.asarray(sig)
    wavfile.write(path, sr, np.clip(sig.T * 32768, -32768, 32767).astype(np.int16))


def write_corpora(folder, seed=3):
    """(noise folder, rir folder): four noises (0.1 s and 0.7 s at SR,
    0.5 s at 2 SR in a sub-folder, 0.3 s), three RIRs (a mono one at SR, a
    stereo one, a mono one at 2 SR) of a direct peak and a decaying tail."""
    rng = np.random.default_rng(seed)
    noise, rir = os.path.join(folder, "noise"), os.path.join(folder, "rir")
    os.makedirs(os.path.join(noise, "sub"), exist_ok=True)
    os.makedirs(rir, exist_ok=True)
    for i, (sec, sr, sub) in enumerate(((0.1, SR, ""), (0.7, SR, ""), (0.5, 2 * SR, "sub"),
                                        (0.3, SR, ""))):
        n = int(sec * sr)
        col = np.cumsum(rng.standard_normal(n)) * 0.01 + 0.2 * rng.standard_normal(n)
        _write(os.path.join(noise, sub, f"noise{i}.wav"), 0.3 * col / np.abs(col).max(), sr)

    def impulse(n, peak, sr_scale=1):
        h = np.zeros(n)
        h[peak] = 0.9
        t = np.arange(n - peak - 1)
        h[peak + 1:] = 0.3 * rng.standard_normal(n - peak - 1) * np.exp(-t / (200 * sr_scale))
        return h

    _write(os.path.join(rir, "rir0.wav"), impulse(1600, 40))
    _write(os.path.join(rir, "rir1.wav"), np.stack([impulse(1200, 25), impulse(1200, 60)]))
    _write(os.path.join(rir, "rir2.wav"), impulse(3000, 90, 2), 2 * SR)
    return noise, rir


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    return write_corpora(str(tmp_path_factory.mktemp("corpora")))


@pytest.fixture(params=["native", "scipy"])
def route(request, monkeypatch):
    if request.param == "scipy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert native.available() and jnative.available()
    return request.param


def _pair(corpora):
    out = []
    for mod in (jaudio, audio):
        aug = mod.AudioAugmentor(sample_rate=SR)
        aug.load_bg_noise_from_folder(corpora[0])
        aug.load_rir_from_folder(corpora[1])
        out.append(aug)
    return out


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (a.dtype, getattr(b, "dtype", b))
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _seeded(fn, seed):
    import random

    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _wav(seed, n=2400):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((1, n))).astype(np.float32)


METHODS = {
    "speed": lambda a, x: a.sox_speed_perturbed(x, 0.93),
    "speed_fast": lambda a, x: a.sox_speed_perturbed(x, 1.07),
    "sox_effect": lambda a, x: a.sox_effect(x),
    "volume": lambda a, x: a.sox_volumn_perturbed(x, 0.7),
    "bg_noise": lambda a, x: a.add_bg_noise(x, [-3.0, 5.0, 12.5]),
    "white_noise": lambda a, x: a._get_white_noise_with_snr(x, 7.0),
    "rir": lambda a, x: a.apply_rir(x),
    "rir_image": lambda a, x: a.apply_rir_by_key(x, "rir1", rir_mode="image"),
    "rir_direct": lambda a, x: a.apply_rir_by_key(x, "rir0", rir_mode="direct"),
    "rir_early": lambda a, x: a.apply_rir_by_key(x, "rir2", choose_ch=0, rir_mode="early"),
    "biquad": lambda a, x: a.add_variaion_response(x),
    "biquad_given": lambda a, x: a.add_variaion_response(
        x, np.array([1.0, -0.2, 0.1], np.float32), np.array([1.0, 0.3, -0.25], np.float32)),
}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_audio_augmentor_gives_jax_bytes(corpora, route, method):
    jaug, aug = _pair(corpora)
    for seed in (0, 1, 2, 3):
        x = _wav(seed)
        want = _seeded(lambda: METHODS[method](jaug, x.copy()), seed)
        got = _seeded(lambda: METHODS[method](aug, x.copy()), seed)
        _same(want, got)


def test_audio_augmentor_direct_convolution_and_corpus_keys(corpora):
    jaug, aug = (m.AudioAugmentor(sample_rate=SR, convolve_mode="convolution")
                 for m in (jaudio, audio))
    for a in (jaug, aug):
        a.load_rir_from_folder(corpora[1])
        a.load_bg_noise_from_folder(corpora[0])
    assert jaug.rir == aug.rir and jaug.bg_noise == aug.bg_noise
    assert sorted(aug.bg_noise) == ["noise0", "noise1", "noise2", "noise3"]
    x = _wav(5)
    _same(_seeded(lambda: jaug.apply_rir(x), 4), _seeded(lambda: aug.apply_rir(x), 4))
    with pytest.raises(ValueError):
        audio.AudioAugmentor(SR, convolve_mode="overlap")


@pytest.mark.parametrize("n", [1, 17, 100, 4099])
def test_utils_convolutions_and_fast_lengths_match_jax(n):
    rng = np.random.default_rng(n)
    assert utils.next_fast_len(n) == jutils.next_fast_len(n)
    x, k = rng.standard_normal((1, n + 5)), rng.standard_normal((1, 7))
    for mode in ("full", "valid", "same"):
        np.testing.assert_array_equal(utils.fftconvolve(x, k, mode),
                                      jutils.fftconvolve(x, k, mode))
    np.testing.assert_array_equal(utils.convolve(x, k), jutils.convolve(x, k))


def test_native_biquad_equals_lfilter_and_jax():
    from scipy.signal import lfilter

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 999)).astype(np.float32)
    b, a = np.array([1.0, 0.3, -0.2], np.float32), np.array([1.0, -0.25, 0.1], np.float32)
    got = native.biquad(b, a, x)
    np.testing.assert_array_equal(got, jnative.biquad(b, a, x))
    np.testing.assert_array_equal(got, lfilter(b, a, x, axis=-1).astype(np.float32))
    with pytest.raises(ValueError, match="3-tap"):
        native.biquad(b[:2], a, x)


# ------------------------------------------------------------------ datasets
def write_ns_manifest(folder, n=6, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    scp, ref = [], []
    for i in range(n):
        L = int((0.2 + 0.08 * i) * SR)
        clean = 0.2 * np.sin(2 * np.pi * (100 + 20 * i) * np.arange(L) / SR)
        for name, sig, lines in (("noisy", clean + 0.1 * rng.standard_normal(L), scp),
                                 ("clean", clean, ref)):
            path = os.path.join(folder, f"{name}_{i}.wav")
            _write(path, sig)
            lines.append(f"utt_{i} {path}")
    for name, lines in (("wav2scp", scp), ("wav2ref", ref)):
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return folder


def write_tse_manifest(folder, n=6, seed=1, vad=False):
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    names = ("wav2scp", "wav2ref", "ref2list", "ref2spk", "wav2spk") + (("ref2vad",) if vad else ())
    lines = {f: [] for f in names}
    L = int(0.6 * SR)
    for i in range(n):
        spk_a, spk_b = f"sp{i % 3}", f"sp{(i + 1) % 3}"
        clean = 0.2 * np.sin(2 * np.pi * (100 + 40 * (i % 3)) * np.arange(L) / SR)
        sigs = {"mix": clean + 0.1 * rng.standard_normal(L), "clean": clean,
                "vad": (np.abs(clean) > 0.1).astype(float) * 0.5,
                "enrollA": clean[:L // 2] + 0.01 * rng.standard_normal(L // 2),
                "enrollB": 0.3 * rng.standard_normal(L + 100 * i)}
        paths = {}
        for name, sig in sigs.items():
            paths[name] = os.path.join(folder, f"{name}_{i}.wav")
            _write(paths[name], sig)
        key = f"mix_{i}_s1"
        lines["wav2scp"].append(f"{key} {paths['mix']}")
        lines["wav2ref"].append(f"{key} {paths['clean']}")
        lines["ref2list"].append(f"{key} {paths['enrollA']} {paths['enrollB']}")
        lines["ref2spk"].append(f"{key} {spk_a}")
        lines["wav2spk"].append(f"{key} {spk_a}-{spk_b}")
        if vad:
            lines["ref2vad"].append(f"{key} {paths['vad']}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


def write_dss_manifest(folder, n=6, seed=2):
    """near / far pairs, one near and one far all-zero (inactive)."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    lines = {"wav2scp": [], "ref2near": [], "ref2far": []}
    for i in range(n):
        L = int((0.8 + 0.1 * i) * SR)
        near = 0.3 * np.sin(2 * np.pi * (150 + 30 * i) * np.arange(L) / SR) * (i != 1)
        far = 0.1 * rng.standard_normal(L) * (i != 4)
        for name, sig, key in (("mix", near + far, "wav2scp"), ("near", near, "ref2near"),
                               ("far", far, "ref2far")):
            path = os.path.join(folder, f"{name}_{i}.wav")
            _write(path, sig)
            lines[key].append(f"utt_{i} {path}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("aug_manifests"))
    return {"ns": write_ns_manifest(os.path.join(root, "ns")),
            "tse": write_tse_manifest(os.path.join(root, "tse")),
            "pvad": write_tse_manifest(os.path.join(root, "pvad"), vad=True),
            "dss": write_dss_manifest(os.path.join(root, "dss"))}


def _run(mod_pair, kwargs, folder, workers, bs=4, epochs=2):
    """JAX's loader and the port's over the same dataset options: equal
    batches, epoch after epoch."""
    loaders = [loader_mod.DataLoader(ds(folder, resample_to=SR, **kwargs), batch_size=bs,
                                     shuffle=True, collate_fn=collate(),
                                     num_workers=workers, seed=11)
               for loader_mod, (ds, collate) in zip((jbase, base), mod_pair)]
    for _ in range(epochs):
        want, got = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                if isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    assert g[k] == w[k], k


NS_MODS = ((jns.NsDataset, jns.NsCollateFunc), (ns.NsDataset, ns.NsCollateFunc))
TSE_MODS = ((jtse.TseDataset, jtse.TseCollateFunc), (tse.TseDataset, tse.TseCollateFunc))
DSS_MODS = ((jdss.DssDataset, jdss.DssCollateFunc), (dss.DssDataset, dss.DssCollateFunc))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("rir_mode", ["image", "direct", "early", "anechoic"])
def test_ns_batches_with_every_host_option_match_jax(corpora, manifests, rir_mode, workers):
    kw = dict(max_length=0.25, noise_folder=corpora[0], rir_folder=corpora[1],
              rir_mode=rir_mode, vol_perturbed="0.5,1.5", speed_perturbed=True,
              perturb_frequency_response=True)
    _run(NS_MODS, kw, manifests["ns"], workers)


@pytest.mark.parametrize("option", ["noise_folder", "rir_folder", "speed_perturbed",
                                    "perturb_frequency_response", "vol_perturbed"])
def test_ns_batches_with_one_host_option_match_jax(corpora, manifests, option):
    value = {"noise_folder": corpora[0], "rir_folder": corpora[1],
             "vol_perturbed": (0.3, 0.9)}.get(option, True)
    _run(NS_MODS, {"max_length": 0.25, option: value}, manifests["ns"], 0)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("enroll_augment", [False, True])
def test_tse_batches_with_every_host_option_match_jax(corpora, manifests, enroll_augment,
                                                      workers):
    kw = dict(max_length=0.4, noise_folder=corpora[0], rir_folder=corpora[1],
              rir_mode="early", vol_perturbed="0.5,1.5", speed_perturbed=True,
              perturb_frequency_response=True, enroll_augment=enroll_augment,
              single_spk_pb=0.2, inactive_training=0.5)
    _run(TSE_MODS, kw, manifests["tse"], workers)


def test_tse_inactive_targets_are_the_augmented_mixture(corpora, manifests):
    ds = tse.TseDataset(manifests["tse"], resample_to=SR, max_length=0.4,
                        noise_folder=corpora[0], rir_folder=corpora[1],
                        vol_perturbed="0.5,1.5", inactive_training=1.0)
    loader = base.DataLoader(ds, batch_size=3, shuffle=True, collate_fn=tse.TseCollateFunc(),
                             seed=4)
    batch = next(iter(loader))
    assert batch["inactive_utts"].all()
    np.testing.assert_array_equal(batch["clean_wav"], batch["process_wav"])


@pytest.mark.parametrize("enroll_augment", [False, True])
def test_pvad_batches_with_host_options_match_jax(corpora, manifests, enroll_augment):
    kw = dict(max_length=0.4, noise_folder=corpora[0], rir_folder=corpora[1],
              vol_perturbed="0.5,1.5", speed_perturbed=True, enroll_augment=enroll_augment,
              perturb_frequency_response=True, inactive_training=0.5, is_vad_dataset=True)
    _run(TSE_MODS, kw, manifests["pvad"], 0)


@pytest.mark.parametrize("workers", [0, 2])
def test_dss_batches_with_every_host_option_match_jax(corpora, manifests, workers):
    # whole seconds: JAX's DSS crop takes max_length * rate as an int
    kw = dict(max_length=1, noise_folder=corpora[0], vol_perturbed="0.5,1.5",
              speed_perturbed=True)
    _run(DSS_MODS, kw, manifests["dss"], workers)
