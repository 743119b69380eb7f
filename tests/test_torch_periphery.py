"""Port parity, the recipes' periphery on the CPU: the TSE CLI's `--action
tSNE` (d-vectors through `inference_tse_embedding` against JAX's in float64
at atol 1e-8, the silhouette to 1e-9, the PNG and HTML written),
`utils/scatter_html.py` byte for byte against JAX's, `src/filter.py`
against `puresound_tpu.src.filter` on seeded input, and `utils/model_info.py`
(`count_params` against JAX's count for small models of every family, the
inf-injection probe against JAX's on small causal models with carried
weights).
"""
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.src import filter as jfilter
from puresound_tpu.tasks.base import DataLoader as JDataLoader
from puresound_tpu.tasks.tse import TseCollateFunc as JCollate
from puresound_tpu.tasks.tse import TseDataset as JTseDataset
from puresound_tpu.utils import model_info as jinfo
from puresound_tpu.utils.scatter_html import write_scatter_html as j_write_scatter_html
from puresound_tpu_torch.egs.tse import main as tse_cli
from puresound_tpu_torch.src import Filter, wav_drop_chunk, wav_drop_frequency
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.utils import count_params, probe_lookahead_receptive
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.utils.scatter_html import write_scatter_html
from tests.test_torch_eval_cli import _JaxTrainer
from tests.test_torch_export import ROOT, SR, _models, _variables

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

N_SPK, N_PER = 3, 3


# -------------------------------------------------------------------- tSNE
def _dev_set(folder, rng):
    """N_SPK speakers x N_PER utterances at SR: a mixture, its clean
    reference and a 1 s enrollment each (ref2spk names the speaker)."""
    os.makedirs(folder, exist_ok=True)
    names = ("wav2scp", "wav2ref", "ref2list", "ref2spk", "wav2spk")
    lines = {k: [] for k in names}
    for i in range(N_SPK * N_PER):
        spk = i % N_SPK
        t = np.arange(SR) / SR
        voice = lambda f0: sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k
                               for k in range(1, 4))
        sigs = {"clean": 0.1 * voice(110 + 60 * spk), "enroll": 0.1 * voice(110 + 60 * spk)}
        sigs["mix"] = sigs["clean"] + 0.05 * rng.standard_normal(SR)
        for name, sig in sigs.items():
            wavfile.write(os.path.join(folder, f"{name}_{i}.wav"), SR,
                          np.clip(sig * 32768, -32768, 32767).astype(np.int16))
        key, p = f"mix_{i}_s1", lambda name: os.path.join(folder, f"{name}_{i}.wav")
        row = {"wav2scp": p("mix"), "wav2ref": p("clean"), "ref2list": p("enroll"),
               "ref2spk": f"sp{spk}", "wav2spk": f"sp{spk}-sp9"}
        for k in names:
            lines[k].append(f"{key} {row[k]}")
    for k, ls in lines.items():
        with open(os.path.join(folder, f"{k}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


def test_tsne_action_matches_jax(tmp_path, monkeypatch, capsys):
    """`--action tSNE` on a JAX-written checkpoint, the model in float64:
    the d-vectors equal JAX's `inference_tse_embedding` (float64, the same
    dev loader) at atol 1e-8, the silhouette JAX's recipe would print to
    1e-9; the PNG and the HTML page are written."""
    rng = np.random.default_rng(5)
    jmodel, _ = _models("tse")
    v = _variables(jmodel, "tse", seed=21)
    monkeypatch.setattr(tse_cli, "init_model",
                        lambda *a, device=None, **kw: _models("tse")[1].double())
    _JaxTrainer(v).save_ckpt(str(tmp_path / "epoch_0.ckpt"), 0, {"total_loss": 0.1})
    hp = load_hparam(os.path.join(ROOT, "egs/tse/conf/libri2mix_max_2spk_clean_16k_1c.yaml"))
    data = _dev_set(str(tmp_path / "dev"), rng)
    hp["DATASET"].update(dev=data, train=data, eval=data, sample_rate=SR)
    hp["TRAIN"].update(model_save_dir=str(tmp_path), log_dir=str(tmp_path), model_average=1)
    cfg = tmp_path / "c.yaml"
    dump_hparam(hp, str(cfg))
    random.seed(7)    # the dev loaders draw their seeds from Python's RNG
    got = tse_cli.main(tse_cli.parse_args([str(cfg), "--action", "tSNE", "--ckpt",
                                           "epoch_0.ckpt", "--backend", "cpu"]))
    out = capsys.readouterr().out
    assert got["dvecs"].dtype == np.float64 and got["dvecs"].shape == (N_SPK * N_PER, 8)
    assert f"silhouette: {got['silhouette']}" in out
    for ext in ("png", "html"):
        assert os.path.getsize(tmp_path / f"Speaker_dev_tSNE.{ext}") > 1000

    # JAX's action, its loader and model call, in float64
    from sklearn.metrics import silhouette_score

    random.seed(7)
    ds = hp["DATASET"]
    loader = JDataLoader(JTseDataset(folder=ds["dev"], resample_to=ds["sample_rate"],
                                     max_length=None, rir_mode=ds.get("rir_mode") or "image",
                                     enroll_rule=ds["enroll_rule"]),
                         batch_size=1, shuffle=False, collate_fn=JCollate())
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        embed = jax.jit(lambda x: jmodel.apply(v64, x, method=JWrap.inference_tse_embedding))
        want, uttids = [], []
        for batch in loader:
            want.append(np.asarray(embed(jnp.asarray(batch["enroll_wav"], jnp.float64)))
                        .reshape(-1))
            uttids.append(batch["uttid"][0])
    assert uttids == got["uttids"]
    np.testing.assert_allclose(got["dvecs"], np.stack(want), atol=1e-8, rtol=0)
    speakers = [f"sp{int(u.split('_')[1]) % N_SPK}" for u in uttids]
    assert got["speakers"] == speakers
    assert abs(got["silhouette"] - silhouette_score(np.stack(want), speakers)) < 1e-9
    assert got["tsne"].shape == (N_SPK * N_PER, 2) and np.isfinite(got["tsne"]).all()


def test_scatter_html_is_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(2)
    xy = rng.standard_normal((7, 2)) * 20
    labels = [f"spk{i % 3}" for i in range(7)]
    names = [f"utt_{i}" for i in range(7)]
    ours = write_scatter_html(str(tmp_path / "a.html"), xy, labels, names, title="t")
    theirs = j_write_scatter_html(str(tmp_path / "b.html"), xy, labels, names, title="t")
    assert (tmp_path / "a.html").read_bytes() == (tmp_path / "b.html").read_bytes()
    assert ours.endswith("a.html") and theirs.endswith("b.html")


# ------------------------------------------------------------------ filter
FILTERS = {
    "lowpass": lambda m, x: m.Filter.lowpass_filter(0.1),
    "lowpass win 20": lambda m, x: m.Filter.lowpass_filter(0.23, 20),
    "bandpass": lambda m, x: m.Filter.get_bandpass_filter(0.05, 0.2),
    "notch": lambda m, x: m.Filter.get_notch_filter(0.15, 0.03, 101),
    "drop_frequency": lambda m, x: m.wav_drop_frequency(x, 16000, 3000.0, 400.0, 256),
    "drop_frequency at nyquist": lambda m, x: m.wav_drop_frequency(x[None], 8000, 3900.0,
                                                                   300.0),
    "drop_chunk": lambda m, x: m.wav_drop_chunk(x, 0.3, 0.25),
    "drop_chunk past the end": lambda m, x: m.wav_drop_chunk(x, 0.9, 0.5),
}


class _Port:
    Filter, wav_drop_frequency, wav_drop_chunk = Filter, wav_drop_frequency, wav_drop_chunk


@pytest.mark.parametrize("name", list(FILTERS))
def test_filter_equals_jax_package(name):
    x = np.random.default_rng(len(name)).standard_normal(4000)
    got, want = FILTERS[name](_Port, x), FILTERS[name](jfilter, x)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- model info
@pytest.mark.parametrize("kind", ["ns", "tse", "dss", "veve", "unet"])
def test_count_params_equals_jax(kind):
    jmodel, model = _models(kind)
    shapes = _variables(jmodel, kind, seed=1)
    assert count_params(model) == jinfo.count_params(shapes["params"]) > 0


@pytest.mark.parametrize("kind", ["tse", "ns"])
def test_probe_equals_jax_with_carried_weights(kind):
    """(lookahead, receptive) by inf injection, the port on the CPU against
    JAX's on the same float32 weights (from_jax)."""
    jmodel, model = _models(kind)
    v = _variables(jmodel, kind, seed=3)
    model.load_state_dict(fj.from_jax(v), strict=True)
    L = 1600 if kind == "tse" else 3200
    enroll = np.random.default_rng(0).random((1, 800), np.float32)
    if kind == "tse":
        jinfer = jax.jit(lambda x: jmodel.apply(v, x, jnp.asarray(enroll),
                                                method=JWrap.inference))
        infer = lambda x: model.inference(x, torch.from_numpy(enroll))
    else:
        jinfer = jax.jit(lambda x: jmodel.apply(v, x, method=JWrap.inference))
        infer = model.inference
    want = jinfo.probe_lookahead_receptive(jinfer, length=L, inject_at=L // 2)
    got = probe_lookahead_receptive(infer, length=L, inject_at=L // 2, device="cpu")
    assert got == want and got[0] is not None


def test_the_new_modules_import_no_jax():
    """The periphery stays on torch: no module of JAX or the JAX package is
    imported by it (a fresh interpreter)."""
    import subprocess
    import sys

    code = ("import puresound_tpu_torch.utils.export, puresound_tpu_torch.utils.model_info, "
            "puresound_tpu_torch.utils.scatter_html, puresound_tpu_torch.src.filter, "
            "puresound_tpu_torch.egs.dss.main, puresound_tpu_torch.egs.tse.main, sys; "
            "assert not {'jax', 'flax', 'msgpack', 'puresound_tpu'} & set(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
