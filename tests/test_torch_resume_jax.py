"""Resuming the port's trainer from the JAX package's training checkpoint
(`BaseTrainer.load_ckpt` on a flax msgpack `epoch_{n}.ckpt`), on the CPU in
float64.

JAX's `NsTask` / `TseTask` train one epoch and write `epoch_0.ckpt`. Both
trainers resume from it (`TRAIN.resume_epoch: 1`) and train the next epoch
on the same batches; then the parameters, the batch statistics, both Adam
moments, the step count, the learning rate, the scheduler state and the
bookkeeping agree at atol 1e-8 / rtol 1e-6. The NS case is a small DPCRN
(BatchNorm2d, Adam with weight decay), the TSE one a small Conv-TasNet
under `multi_rate` (its per-module factors). A moment leaf the converter
drops, and a tree with no or two Adam states, raise.
"""
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.conv_tasnet import ConvTasNet as JConvTasNet
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.nnet.encoder import ConvEncDec as JEncDec
from puresound_tpu.nnet.encoder import FreeEncDec as JFree
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDR
from puresound_tpu.tasks import base as jbase
from puresound_tpu.tasks import ns as jns
from puresound_tpu.tasks import tse as jtse
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN, ConvTasNet
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.tasks import base, ns, tse
from puresound_tpu_torch.utils import from_jax as fj

torch.set_num_threads(1)

ATOL, RTOL = 1e-8, 1e-6
SR = 8000
F64 = dict(dtype=torch.float64)
UNET = dict(input_type="RI", input_dim=64, norm_type="bN2d", dropout=0.0,
            channels=(1, 4, 4, 8, 8, 8), transpose_t_size=2, kernel_t=(2, 2, 2, 2, 2),
            stride_t=(1, 1, 1, 1, 1), dilation_t=(1, 1, 1, 1, 1), kernel_f=(5, 3, 3, 3, 3),
            stride_f=(2, 2, 1, 1, 1), dilation_f=(1, 1, 1, 1, 1), delay=(0, 0, 0, 0, 0),
            rnn_hidden=8)
ENC = dict(fft_length=64, win_length=64, hop_length=16, trainable=True,
           output_format="Complex")
WRAP = dict(drop_first_bin=True, mask_constraint="linear", f_type="Complex",
            mask_type="Complex")
C, CH, E = 16, 24, 8
MASKER = dict(input_dim=C, embed_dim=E, embed_norm=True, tcn_kernel=3, tcn_dim=CH,
              repeat_tcn=1, tcn_dilated_basic=2, per_tcn_stack=2, tcn_with_embed=(1, 0),
              tcn_layer="normal")


def _write_manifest(folder, n=4, seed=1):
    """Mixtures of 0.3-0.45 s (shorter than the 0.5 s crop: zero-padded,
    so a batch does not depend on its epoch's seed); TSE files too."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    lines = {f: [] for f in ("wav2scp", "wav2ref", "ref2list", "ref2spk", "wav2spk")}
    for i in range(n):
        L = int((0.3 + 0.05 * i) * SR)
        clean = 0.2 * np.sin(2 * np.pi * (100 + 40 * i) * np.arange(L) / SR)
        sigs = {"mix": clean + 0.1 * rng.standard_normal(L), "clean": clean,
                "enroll": 0.2 * rng.standard_normal(int(0.4 * SR))}
        paths = {}
        for name, sig in sigs.items():
            paths[name] = os.path.join(folder, f"{name}_{i}.wav")
            wavfile.write(paths[name], SR, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
        key = f"mix_{i}_s1"
        lines["wav2scp"].append(f"{key} {paths['mix']}")
        lines["wav2ref"].append(f"{key} {paths['clean']}")
        lines["ref2list"].append(f"{key} {paths['enroll']}")
        lines["ref2spk"].append(f"{key} sp{i % 2}")
        lines["wav2spk"].append(f"{key} sp{i % 2}-sp{(i + 1) % 2}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return _write_manifest(str(tmp_path_factory.mktemp("resume_manifest")))


def _hparam(tmp, manifest, kind, **train):
    h = {"DATASET": {"type": "TSE", "sample_rate": SR, "max_length": 0.5,
                     "train": manifest, "dev": manifest, "eval": None,
                     "single_spk_prob": 0.0, "inactive_training": 0.0,
                     "enroll_rule": None},
         "LOSS": {"sig_loss": "sisnr", "alpha": 10.0},
         "OPTIMIZER": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999,
                       "weight_decay": 1e-5 if kind == "ns" else 0.01,
                       "lr_scheduler": "stepLR", "gamma": 0.5, "patience": 1,
                       "mode": "min", "num_epochs_decay": 0, "gradiend_clip": 10.0,
                       "multi_rate": kind == "tse"},
         "TRAIN": {"num_epochs": 1, "resume_epoch": None, "multi_gpu": False,
                   "use_tensorboard": False, "batch_size": 2, "num_workers": 0,
                   "model_save_dir": os.path.join(tmp, "ckpt"),
                   "log_dir": os.path.join(tmp, "log"), "contrastive_learning": False,
                   "seed": 3}}
    h["TRAIN"].update(train)
    return h


def _jax_model(kind):
    if kind == "ns":
        return JWrap(encoder=JEncDec(**ENC), masker=JDPCRN(**UNET),
                     loss_func_wav=JSDR.init_mode("sisnr"), **WRAP)
    spk = (JTCN(C, CH, 3, dilation=1, causal=False, tcn_norm="gLN", dconv_norm="gGN"),
           JASP(C, 8), JConv(2 * C, E, 1, use_bias=False))
    return JWrap(encoder=JFree(win_length=32, hop_length=16, laten_length=C),
                 masker=JConvTasNet(**MASKER, tcn_norm="gLN", dconv_norm="gGN"),
                 speaker_net=spk, mask_constraint="ReLU", loss_func_wav=JSDR.init_mode("sisnr"))


def _port_model(kind):
    if kind == "ns":
        return SoTaskWrapModule(ConvEncDec(**ENC, **F64), DPCRN(**UNET, **F64),
                                loss_func_wav=SDRLoss.init_mode("sisnr"), **WRAP)
    spk = [TCN(C, CH, 3, 1, **F64), AttentiveStatisticsPooling(C, 8, **F64),
           Conv1d(2 * C, E, 1, bias=False, **F64)]
    return SoTaskWrapModule(FreeEncDec(win_length=32, hop_length=16, laten_length=C, **F64),
                            ConvTasNet(**MASKER, tcn_norm="gLN", dconv_norm="gGN", **F64),
                            spk, mask_constraint="ReLU", loss_func_wav=SDRLoss.init_mode("sisnr"))


def _variables(kind, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.zeros((2, SR // 2))
    kw = dict(noisy=x, ref_clean=x, train=False)
    kw["enroll"] = x if kind == "tse" else None
    v = jax.jit(lambda key: _jax_model(kind).init(key, **kw))(jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64)
                               + 0.05 * rng.standard_normal(np.shape(a)), jax.device_get(v))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return v


class _F64:
    """A collate whose waveforms are float64, so both trainers run in it."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, batch):
        out = self.inner(batch)
        for k in ("clean_wav", "process_wav", "enroll_wav"):
            if k in out:
                out[k] = out[k].astype(np.float64)
        return out


def _loaders(pkg, kind, manifest):
    tasks = (jns, jtse) if pkg == "jax" else (ns, tse)
    loader = jbase.DataLoader if pkg == "jax" else base.DataLoader
    if kind == "ns":
        ds = tasks[0].NsDataset(manifest, resample_to=SR, max_length=0.5)
        collate = tasks[0].NsCollateFunc()
    else:
        ds = tasks[1].TseDataset(manifest, resample_to=SR, max_length=0.5)
        collate = tasks[1].TseCollateFunc()
    mk = lambda: loader(ds, batch_size=2, shuffle=False, seed=3, collate_fn=_F64(collate))
    return mk(), mk()


def _jax_task(kind, hp, manifest, v):
    cls = jns.NsTask if kind == "ns" else jtse.TseTask
    return cls(hp, _jax_model(kind), lambda: v, "cpu", *_loaders("jax", kind, manifest))


def _port_task(kind, hp, manifest, v):
    model = _port_model(kind)
    model.load_state_dict(fj.from_jax(v), strict=True)
    cls = ns.NsTask if kind == "ns" else tse.TseTask
    return cls(hp, model, "cpu", *_loaders("port", kind, manifest))


def _adam(jtask):
    found = []

    def walk(t):
        if hasattr(t, "mu") and hasattr(t, "nu") and hasattr(t, "count"):
            found.append(t)
        elif isinstance(t, (tuple, list)):
            for x in t:
                walk(x)
        elif hasattr(t, "inner_state"):
            walk(t.inner_state)

    walk(jtask.state.opt_state)
    assert len(found) == 1
    return found[0]


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=msg)


@pytest.fixture(scope="module", params=["ns", "tse"])
def trained(request, tmp_path_factory, manifest):
    """(kind, the folder of JAX's epoch_0.ckpt, the variables)."""
    kind = request.param
    tmp = str(tmp_path_factory.mktemp(f"jax_{kind}"))
    v = _variables(kind)
    with jax.enable_x64(True):
        _jax_task(kind, _hparam(tmp, manifest, kind), manifest, v).train()
    return kind, tmp, v


def test_port_resumes_a_jax_checkpoint_and_trains_on_like_jax(trained, manifest, tmp_path):
    kind, tmp, v = trained
    ckpt = os.path.join(tmp, "ckpt", "epoch_0.ckpt")
    with jax.enable_x64(True):
        hp = lambda d: _hparam(tmp, manifest, kind, num_epochs=2, resume_epoch=1,
                               model_save_dir=d)
        jres = _jax_task(kind, hp(os.path.join(tmp, "ckpt")), manifest, v)
        jres.hparam["TRAIN"]["model_save_dir"] = str(tmp_path / "jax_out")
        # JAX's resumed loaders count epochs from 0 again, the port's go on
        # from the resumed epoch (`set_epoch`): line JAX's up with the port's,
        # so both draw the straight run's per-batch seeds (the enrollment level)
        for loader in (jres.train_dataloader, jres.dev_dataloader):
            loader._epoch = 1
        jres.train()
    task = _port_task(kind, hp(os.path.join(tmp, "ckpt")), manifest, v)
    loaded = dict(task.model.state_dict())
    task.hparam["TRAIN"]["model_save_dir"] = str(tmp_path / "port_out")
    # the resume read JAX's parameters and moments, not the initial ones
    raw = fser.msgpack_restore(open(ckpt, "rb").read())
    want0 = fj.flat_from_jax({"params": raw["params"],
                              "batch_stats": raw.get("batch_stats") or {}})
    for n, t in loaded.items():
        _close(t, want0[n], n)
    task.train()

    want = fj.flat_from_jax({"params": jax.device_get(jres.state.params),
                             "batch_stats": jax.device_get(jres.state.batch_stats)})
    for n, t in task.model.state_dict().items():
        _close(t, want[n], n)
    adam = _adam(jres)
    mu, nu = fj.params_by_name(jax.device_get(adam.mu)), fj.params_by_name(jax.device_get(adam.nu))
    opt = task.state.optimizer
    for n, p in task.model.named_parameters():
        st = opt.state[p]
        _close(st["exp_avg"], mu[n], f"mu {n}")
        _close(st["exp_avg_sq"], nu[n], f"nu {n}")
        assert float(st["step"]) == int(adam.count) == 4
    assert task.state.step == 4
    assert task.current_lr == jres.current_lr
    assert task.scheduler.state_dict() == jres.scheduler.state_dict()
    assert task.overall_step == jres.overall_step == 4
    assert task.best_epoch == jres.best_epoch
    np.testing.assert_allclose(task.best_loss, jres.best_loss, atol=ATOL, rtol=RTOL)
    if kind == "tse":
        assert sorted(g["factor"] for g in opt.param_groups) == [0.1, 1.0]


def _rewrite(src, dst, edit):
    tree = fser.msgpack_restore(open(src, "rb").read())
    edit(tree)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "wb") as f:
        f.write(fser.msgpack_serialize(tree))


def _adam_dict(tree):
    found = []

    def walk(t):
        if isinstance(t, dict):
            if set(t) == {"count", "mu", "nu"}:
                found.append(t)
            else:
                for x in t.values():
                    walk(x)

    walk(tree["opt_state"])
    return found


@pytest.mark.parametrize("fault", ["extra_leaf", "no_adam", "two_adams"])
def test_unmappable_optimizer_state_raises(trained, manifest, tmp_path, fault):
    kind, tmp, v = trained
    src = os.path.join(tmp, "ckpt", "epoch_0.ckpt")
    dst = str(tmp_path / "bad" / "epoch_0.ckpt")

    def edit(tree):
        adam = _adam_dict(tree)
        assert len(adam) == 1
        if fault == "extra_leaf":
            adam[0]["mu"]["masker"]["bogus"] = np.zeros(3)
        elif fault == "no_adam":
            adam[0].pop("nu")
        else:
            tree["opt_state"]["copy"] = dict(adam[0])

    _rewrite(src, dst, edit)
    hp = _hparam(tmp, manifest, kind, num_epochs=2, resume_epoch=1,
                 model_save_dir=str(tmp_path / "bad"))
    with pytest.raises(ValueError, match="optax|ScaleByAdamState"):
        _port_task(kind, hp, manifest, v)


def test_port_checkpoint_still_resumes_with_its_generators(trained, manifest, tmp_path):
    kind, tmp, v = trained
    hp = _hparam(str(tmp_path), manifest, kind)
    task = _port_task(kind, hp, manifest, v)
    task.train()
    tree = torch.load(tmp_path / "ckpt" / "epoch_0.ckpt", weights_only=True)
    assert set(tree["rng"]) >= {"augment"}
    again = _port_task(kind, _hparam(str(tmp_path), manifest, kind, num_epochs=1,
                                     resume_epoch=1), manifest, v)
    for (n, a), b in zip(task.model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert torch.equal(again.augment_generator.get_state(),
                       task.augment_generator.get_state())
