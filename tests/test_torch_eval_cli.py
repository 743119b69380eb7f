"""Port parity, the recipes' evaluation actions end to end on the CPU
(`python -m puresound_tpu_torch.egs.{tse,ns}.main --action
dev|eval|stream_eval --backend cpu`), small models in place of the zoo's,
inputs from numpy seeds:

- `action_dev` (`--metrics detail`: PESQ, STOI, SDR, SI-SNR, SI-SNRi, NSR)
  and `action_eval` of the port's CLIs against the JAX recipes' on the same
  JAX checkpoint (TRAIN.model_average 2 over epochs 0 and 1), a
  2-utterance manifest of equal lengths, the shipped configs
  `vctk_dpcrn_1a.yaml` and `libri2mix_max_2spk_clean_16k_1c.yaml` read from
  their files, the TSE one also as a PVAD set (the binarized output's
  accuracy / precision / recall / F1): every printed number within 1e-4
  (relative) of JAX's, and the written wavs within one int16 step;
- `--batch_eval 2` against one utterance at a time, before the last
  analysis window (zero-padded tail), within 1e-5 of max|ref|;
- `stream_eval` (stock and `--half`, NS also on `--dp_kernel`): the wavs
  `stream_signal` gives on the model `load_eval_model` loads, RTFs printed;
- `--ckpt` required (serve's, export_model's and tSNE's too), and wrong
  kernel flags raise.
"""
import functools
import importlib.util
import os
import random
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.nnet.encoder import ConvEncDec as JConvEncDec
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.tasks import base as jbase
from puresound_tpu_torch.egs.ns import main as ns_cli
from puresound_tpu_torch.egs.tse import main as tse_cli
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.streaming.file_eval import build_engine, stream_signal
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
L, L_ENROLL = 12000, 10000
C, E = 24, 8
TSE_ENC = dict(win_length=32, hop_length=16, laten_length=C, output_active=True)
SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2, seg_size=10,
            seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
            embed_fusion="FiLM", block_with_embed=(1, 1))
NS_ENC = dict(fft_length=512, win_length=512, hop_length=128, trainable=True,
              output_format="Complex")
UNET = dict(input_type="RI", input_dim=512, norm_type="bN2d", dropout=0.0,
            channels=(1, 4, 4, 8, 8, 16), transpose_t_size=2, kernel_t=(2,) * 5,
            stride_t=(1,) * 5, dilation_t=(1,) * 5, kernel_f=(5, 3, 3, 3, 3),
            stride_f=(2, 2, 1, 1, 1), dilation_f=(1,) * 5, delay=(0,) * 5, rnn_hidden=8)
NS_WRAP = dict(drop_first_bin=True, mask_constraint="linear", f_type="Complex",
               mask_type="Complex")
CONFS = {"ns": os.path.join(ROOT, "egs", "ns", "conf", "vctk_dpcrn_1a.yaml"),
         "tse": os.path.join(ROOT, "egs", "tse", "conf",
                             "libri2mix_max_2spk_clean_16k_1c.yaml")}


# ------------------------------------------------------------------ models
def _jax_model(kind):
    if kind == "ns":
        return JWrap(encoder=JConvEncDec(**NS_ENC), masker=JDPCRN(**UNET), **NS_WRAP)
    spk = tuple([JTCN(C, 16, 3, dilation=1, causal=False, tcn_norm="gLN", dconv_norm="gGN")]
                + [JASP(C, 16), JConv(2 * C, E, 1, use_bias=False)])
    return JWrap(encoder=JEnc(**TSE_ENC), masker=JSkiM(**SKIM), speaker_net=spk,
                 mask_constraint="ReLU")


def _port_model(kind, device=None, **_):
    if kind == "ns":
        return SoTaskWrapModule(ConvEncDec(**NS_ENC, device=device),
                                DPCRN(**UNET, device=device), **NS_WRAP).eval()
    spk = ([TCN(C, 16, 3, dilation=1, tcn_norm="gLN", dconv_norm="gGN", device=device)]
           + [AttentiveStatisticsPooling(C, 16, device=device),
              Conv1d(2 * C, E, 1, bias=False, device=device)])
    return SoTaskWrapModule(FreeEncDec(**TSE_ENC, device=device), SkiM(**SKIM, device=device),
                            spk, mask_constraint="ReLU").eval()


class _Jitted:
    """JAX's recipe calls `model.apply(variables, ..., method=inference)`
    one utterance at a time, eagerly; this stand-in jits it (the same
    computation, compiled once for the manifest's one shape)."""

    def __init__(self, model):
        self.model = model
        self._apply = jax.jit(functools.partial(model.apply, method=JWrap.inference))

    def apply(self, variables, *args, method=None):
        assert method is JWrap.inference
        return self._apply(variables, *args)


def _variables(kind, rng, dtype=np.float32):
    """Random variables in the layout of JAX's init (shapes from
    `jax.eval_shape`); BatchNorm variances positive."""
    model = _jax_model(kind)
    args = (jnp.zeros((1, 320)),) + ((jnp.zeros((1, 640)),) if kind == "tse" else ())
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args,
                                               method=JWrap.inference))
    v = jax.tree_util.tree_map(lambda s: (0.2 * rng.standard_normal(s.shape)).astype(dtype),
                               shapes)
    if v.get("batch_stats"):
        v["batch_stats"] = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, v["batch_stats"])
    return v


def _jax_cli(kind, monkeypatch, rng):
    """JAX's recipe CLI module, its `model` zoo and `get_model_variables`
    replaced by the small model (compiled) and a variable tree of its
    layout (the checkpoint overwrites the values)."""
    path = os.path.join(ROOT, "egs", kind, "main.py")
    spec = importlib.util.spec_from_file_location(f"jax_recipe_{kind}_main", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    target = _variables(kind, rng)
    monkeypatch.setitem(sys.modules, "model", types.SimpleNamespace(
        init_model=lambda name: _Jitted(_jax_model(kind))))
    monkeypatch.setattr(mod, "get_model_variables", lambda model, hparam: target)
    return mod


# ----------------------------------------------------------------- the data
def _signal(rng, n):
    t = np.arange(n) / SR
    f0 = rng.uniform(120, 300)
    tone = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k for k in range(1, 6))
    return 0.1 * tone * np.clip(np.sin(2 * np.pi * 4 * t + rng.uniform(0, 6)), 0.2, None)


def _manifest(folder, kind, rng, n=2, vad=False):
    """n mixtures of L samples (TSE: an L_ENROLL enrollment each; PVAD: a
    0 / 1 activity label wav as ref2vad)."""
    os.makedirs(folder, exist_ok=True)
    names = ["wav2scp", "wav2ref"] + (["ref2list", "ref2spk", "wav2spk"] if kind == "tse"
                                      else []) + (["ref2vad"] if vad else [])
    lines = {k: [] for k in names}
    for i in range(n):
        clean = _signal(rng, L)
        sigs = {"mix": clean + 0.6 * _signal(rng, L) + 0.01 * rng.standard_normal(L),
                "clean": clean, "enroll": _signal(rng, L_ENROLL),
                "vad": (np.abs(clean) > 0.05).astype(np.float64) * 0.9}
        for name, sig in sigs.items():
            wavfile.write(os.path.join(folder, f"{name}_{i}.wav"), SR,
                          np.clip(sig * 32768, -32768, 32767).astype(np.int16))
        key, p = f"mix_{i}_s1", lambda name: os.path.join(folder, f"{name}_{i}.wav")
        row = {"wav2scp": p("mix"), "wav2ref": p("clean"), "ref2list": p("enroll"),
               "ref2spk": f"sp{i}", "wav2spk": f"sp{i}-sp{i + 5}", "ref2vad": p("vad")}
        for k in names:
            lines[k].append(f"{key} {row[k]}")
    for k, ls in lines.items():
        with open(os.path.join(folder, f"{k}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


def _hp(kind, data, save_dir, vad=False):
    hp = load_hparam(CONFS[kind])
    hp["DATASET"].update(train=data, dev=data, eval=data, sample_rate=SR)
    if vad:
        hp["DATASET"]["type"] = "pvad"
    hp["TRAIN"].update(model_save_dir=str(save_dir), log_dir=str(save_dir), model_average=2)
    return hp


class _JaxTrainer:
    """Enough of JAX's BaseTrainer for its own `save_ckpt`."""
    _ckpt_tree = jbase.BaseTrainer._ckpt_tree
    save_ckpt = jbase.BaseTrainer.save_ckpt
    current_lr, best_loss, best_epoch, overall_step = 1e-3, 0.1, 0, 1

    def __init__(self, v):
        self.state = types.SimpleNamespace(params=v["params"], opt_state={},
                                           batch_stats=v.get("batch_stats", {}))
        self.scheduler = jbase.LearningRateScheduler("Plateau", base_lr=1e-3)


def _checkpoints(kind, rng, save_dirs):
    """JAX-written epoch_0 / epoch_1 checkpoints (JAX's own save_ckpt) of
    the small model in every folder of `save_dirs`."""
    for e in range(2):
        trainer = _JaxTrainer(_variables(kind, rng))
        for d in save_dirs:
            os.makedirs(d, exist_ok=True)
            trainer.save_ckpt(os.path.join(d, f"epoch_{e}.ckpt"), e, {"total_loss": 0.1})


def _numbers(text):
    """Every number `dev` printed, by line."""
    out = []
    for line in text.splitlines():
        vals = [p.strip() for p in line.replace(":", ",").split(",")[1:]]
        try:
            out.append([float(v) for v in vals if v])
        except ValueError:
            continue
    return out


def _wavs(folder):
    return {f: wavfile.read(os.path.join(folder, f))[1] for f in sorted(os.listdir(folder))}


def _port_main(cli, cfg, *args):
    return cli.main(cli.parse_args([str(cfg), *args, "--ckpt", "epoch_1.ckpt",
                                    "--backend", "cpu"]))


@pytest.mark.parametrize("kind,vad", [("ns", False), ("tse", False), ("tse", True)],
                         ids=["ns dpcrn", "tse 1c", "tse pvad"])
def test_dev_and_eval_match_the_jax_recipe(tmp_path, rng, monkeypatch, capsys, kind, vad):
    cli = ns_cli if kind == "ns" else tse_cli
    monkeypatch.setattr(cli, "init_model", lambda name, **kw: _port_model(kind, **kw))
    jcli = _jax_cli(kind, monkeypatch, rng)
    data = _manifest(str(tmp_path / "data"), kind, rng, vad=vad)
    _checkpoints(kind, rng, [tmp_path / "jax", tmp_path / "port"])
    jhp, hp = _hp(kind, data, tmp_path / "jax", vad), _hp(kind, data, tmp_path / "port", vad)
    cfg = tmp_path / "port.yaml"
    dump_hparam(hp, str(cfg))

    random.seed(7)   # the dev loaders draw their seeds from Python's RNG
    jcli.action_dev(jhp, "cpu", "epoch_1.ckpt", "detail")
    want = capsys.readouterr().out
    random.seed(7)
    means = _port_main(cli, cfg, "--action", "dev", "--metrics", "detail")
    got = capsys.readouterr().out
    assert "model_average: averaging 2 checkpoints ending at epoch_1.ckpt" in got
    label = lambda text: [line.replace(":", ",").split(",")[0] for line in text.splitlines()]
    assert label(got) == label(want)
    g, w = _numbers(got), _numbers(want)
    assert len(g) == len(w) and np.isfinite(sum(g, [])).all()
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert len(means) == (4 if vad else {"ns": 5, "tse": 7}[kind])

    jcli.action_eval(jhp, "cpu", "epoch_1.ckpt")
    _port_main(cli, cfg, "--action", "eval")
    want_w, got_w = _wavs(tmp_path / "jax" / "eval_audio"), _wavs(tmp_path / "port" / "eval_audio")
    assert list(got_w) == list(want_w) == ["mix_0_s1.wav", "mix_1_s1.wav"]
    for k in want_w:
        assert got_w[k].dtype == want_w[k].dtype == np.int16
        assert np.abs(got_w[k].astype(int) - want_w[k]).max() <= 1, k


def _port_ckpts(kind, tmp_path, rng):
    """Port-written epoch_0 / epoch_1 checkpoints of the small model."""
    from puresound_tpu_torch.tasks import base

    class Saver(base.BaseTrainer):
        def __init__(self, model):
            self.model = model
            super().__init__({"OPTIMIZER": {"lr_scheduler": "Plateau", "lr": 1e-3},
                              "TRAIN": {}}, "cpu")

    for e in range(2):
        model = _port_model(kind)
        model.load_state_dict(fj.from_jax(_variables(kind, rng)))
        Saver(model).save_ckpt(str(tmp_path / "models" / f"epoch_{e}.ckpt"), e,
                               {"total_loss": 0.1})


@pytest.fixture(params=["ns", "tse"])
def port_run(request, tmp_path, rng, monkeypatch):
    """(kind, CLI, config path, save dir) on port-written checkpoints."""
    kind = request.param
    cli = ns_cli if kind == "ns" else tse_cli
    monkeypatch.setattr(cli, "init_model", lambda name, **kw: _port_model(kind, **kw))
    os.makedirs(tmp_path / "models")
    _port_ckpts(kind, tmp_path, rng)
    data = _manifest(str(tmp_path / "data"), kind, rng, n=3)
    cfg = tmp_path / "c.yaml"
    dump_hparam(_hp(kind, data, tmp_path / "models"), str(cfg))
    return kind, cli, cfg, tmp_path / "models"


def test_batch_eval_matches_one_utterance_at_a_time(port_run, capsys):
    """Zero-padded to the 2,500-sample grid: equal before the last window
    (the enrollments are 4x the grid, so not tiled)."""
    kind, cli, cfg, save = port_run
    _port_main(cli, cfg, "--action", "eval")
    one = _wavs(save / "eval_audio")
    _port_main(cli, cfg, "--action", "eval", "--batch_eval", "2", "--eval_quantum", "0.15625")
    assert "Running inference: mix_2_s1" in capsys.readouterr().out
    batched = _wavs(save / "eval_audio")
    tail = 512 if kind == "ns" else 32
    for k in one:
        a, b = batched[k][:L - tail].astype(int), one[k][:L - tail].astype(int)
        assert np.abs(a - b).max() <= 1 + 1e-5 * np.abs(b).max(), k
    means = _port_main(cli, cfg, "--action", "dev", "--batch_eval", "2")
    assert "batch_eval: 1 bucket shapes for 3 utterances" in capsys.readouterr().out
    assert np.isfinite(list(means.values())).all()


def test_stream_eval_writes_what_stream_signal_streams(port_run, capsys, rng):
    """On a one-mixture eval set."""
    kind, cli, cfg, save = port_run
    hp = load_hparam(str(cfg))
    hp["DATASET"]["eval"] = _manifest(str(save.parent / "one"), kind, rng, n=1)
    dump_hparam(hp, str(cfg))
    routes = [(), ("--half",)] + ([("--dp_kernel",)] if kind == "ns" else [])
    for flags in routes:
        _port_main(cli, cfg, "--action", "stream_eval", *flags)
        out = capsys.readouterr().out
        assert "Average RTF over 1 utts" in out and out.count("Streamed mix_") == 1
        got = _wavs(save / "stream_eval_audio")
        engine = build_engine(cli.load_eval_model(hp, "epoch_1.ckpt", "cpu"))
        d = hp["DATASET"]["eval"]
        noisy, enroll = tse_cli._load_pair({"k": [os.path.join(d, "mix_0.wav")]},
                                           {"k": [os.path.join(d, "enroll_0.wav")]}, "k", SR)
        dvec = None
        if kind == "tse":
            with torch.inference_mode():
                dvec = engine.embed(torch.from_numpy(enroll))
        if "--half" in flags:
            engine = build_engine(cli.load_eval_model(hp, "epoch_1.ckpt", "cpu"))
        enh, _ = stream_signal(engine, noisy, SR, dvec=dvec, half="--half" in flags,
                               dp_kernel="--dp_kernel" in flags)
        want = np.clip(enh * 32768.0, -32768, 32767).astype(np.int16)
        np.testing.assert_array_equal(got["mix_0_s1.wav"], want)


@pytest.mark.parametrize("kind", ["ns", "tse"])
def test_cli_needs_a_ckpt_and_unported_actions_raise(tmp_path, kind):
    cli = ns_cli if kind == "ns" else tse_cli
    cfg = tmp_path / "c.yaml"
    dump_hparam(_hp(kind, str(tmp_path), tmp_path / "models"), str(cfg))
    # export_model (both CLIs) and tSNE (TSE) are ported: they need --ckpt too
    ported = {"ns": ("export_model",), "tse": ("export_model", "tSNE")}[kind]
    for action in ("dev", "eval", "stream_eval", "serve") + ported:
        with pytest.raises(ValueError, match="--ckpt is required"):
            cli.main(cli.parse_args([str(cfg), "--action", action, "--backend", "cpu"]))
    # a checkpoint that is not there fails when the action loads it
    for action in ported:
        with pytest.raises(FileNotFoundError):
            cli.main(cli.parse_args([str(cfg), "--action", action, "--ckpt", "x",
                                     "--backend", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--backend cpu"):
            cli.main(cli.parse_args([str(cfg), "--action", "eval", "--ckpt", "x"]))


def test_stream_eval_rejects_a_route_the_model_lacks(port_run):
    kind, cli, cfg, _ = port_run
    if kind == "tse":
        assert not hasattr(cli.parse_args([str(cfg)]), "dp_kernel")
        return
    for flags in (["--attn_kernel"], ["--fused", "--mk_kernel"]):
        with pytest.raises(ValueError):
            _port_main(cli, cfg, "--action", "stream_eval", *flags)
