"""Port parity, the recipe's training path (`tasks/`, `egs/tse/main.py`)
against the JAX package on a synthetic TSE manifest folder of short WAVs:

- `DataLoader` + `TseDataset` + `TseCollateFunc` give the JAX package's
  batches bit for bit for the same seed (every enrollment rule, single-
  speaker and inactive cases, the volume draw, 0 and 2 workers);
- `LearningRateScheduler` gives the same LR sequences;
- the optimizer chain (weight decay, `multi_rate` factors) equals
  `_make_tx` over 3 steps (float64, atol 1e-12);
- `TseTask.train()` for 2 epochs x 2 batches equals JAX's `TseTask` in
  per-step loss, dev loss, best epoch and final parameters (float64, atol
  1e-8 / rtol 1e-6);
- 1 epoch, a resume from `epoch_0.ckpt` and 1 more equal 2 straight epochs;
- `main.py --action train --backend cpu` writes `epoch_0.ckpt` / `.info`,
  the default backend raises without a card, unported options raise.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDRLoss
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.tasks import base as jbase
from puresound_tpu.tasks import tse as jtse
from puresound_tpu_torch.egs.tse import main as cli
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.tasks import base, tse
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

SR = 8000
C, E = 16, 8
ENC = dict(win_length=16, hop_length=8, laten_length=C, output_active=True)
SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2, seg_size=20,
            seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
            embed_fusion="FiLM", block_with_embed=(1, 1))


def _write_manifest(folder, n=6, seed=1):
    """n mixtures of 1.2 s at 8 kHz, keys mix_<i>_s1; each target speaker
    has two enrollment candidates of different lengths."""
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(folder, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    lines = {f: [] for f in ("wav2scp", "wav2ref", "ref2list", "ref2spk", "wav2spk")}
    L = int(1.2 * SR)
    for i in range(n):
        spk_a, spk_b = f"sp{i % 3}", f"sp{(i + 1) % 3}"
        t = np.arange(L) / SR
        clean = 0.2 * np.sin(2 * np.pi * (100 + 40 * (i % 3)) * t)
        mix = clean + 0.1 * rng.standard_normal(L)
        sigs = {"mix": mix, "clean": clean,
                "enrollA": clean[: L // 2] + 0.01 * rng.standard_normal(L // 2),
                "enrollB": 0.3 * rng.standard_normal(L + 100 * i)}
        paths = {}
        for name, sig in sigs.items():
            paths[name] = os.path.join(wav_dir, f"{name}_{i}.wav")
            wavfile.write(paths[name], SR,
                          np.clip(sig * 32768, -32768, 32767).astype(np.int16))
        key = f"mix_{i}_s1"
        lines["wav2scp"].append(f"{key} {paths['mix']}")
        lines["wav2ref"].append(f"{key} {paths['clean']}")
        lines["ref2list"].append(f"{key} {paths['enrollA']} {paths['enrollB']}")
        lines["ref2spk"].append(f"{key} {spk_a}")
        lines["wav2spk"].append(f"{key} {spk_a}-{spk_b}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return _write_manifest(str(tmp_path_factory.mktemp("tse_manifest")))


# ----------------------------------------------------------------- batches
BATCH_CASES = [
    dict(enroll_rule=None), dict(enroll_rule="longest"),
    dict(enroll_rule="shortest"), dict(enroll_rule="fixed_length"),
    dict(enroll_rule="full"),
    dict(enroll_rule="fixed_length", single_spk_pb=1.0),
    dict(enroll_rule="fixed_length", inactive_training=1.0),
    dict(enroll_rule=None, vol_perturbed="0.5,1.5", inactive_training=0.5),
    dict(enroll_rule="fixed_length", inactive_training=0.5, num_workers=2),
    dict(enroll_rule=None, single_spk_pb=0.5, num_workers=2),
]


def _loaders(manifest, case):
    case = dict(case)
    workers = case.pop("num_workers", 0)
    out = []
    for mod_ds, mod_base in ((jtse, jbase), (tse, base)):
        ds = mod_ds.TseDataset(manifest, resample_to=SR, max_length=0.5, **case)
        out.append(mod_base.DataLoader(ds, batch_size=4, shuffle=True,
                                       collate_fn=mod_ds.TseCollateFunc(),
                                       num_workers=workers, seed=7))
    return out


@pytest.mark.parametrize("case", BATCH_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_batches_match_jax_bit_for_bit(manifest, case):
    jloader, loader = _loaders(manifest, case)
    for _ in range(2):                       # two epochs: the reshuffle too
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g["uttid"] == w["uttid"]
            for k in set(w) - {"uttid"}:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_batches_do_not_depend_on_num_workers(manifest):
    case = dict(enroll_rule=None, inactive_training=0.5, vol_perturbed="0.5,1.5")
    a = list(_loaders(manifest, case)[1])
    b = list(_loaders(manifest, dict(case, num_workers=2))[1])
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_native_build_is_tried_once(monkeypatch):
    """A failed `make -C csrc` is remembered: later calls (one per file in
    every loader worker) raise it again without running make."""
    from puresound_tpu_torch.src import native

    runs = []

    def failing_make(*args, **kwargs):
        runs.append(args)
        return type("Proc", (), {"returncode": 2, "stdout": "", "stderr": "no"})()

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_stale", lambda: True)
    monkeypatch.setattr(native.subprocess, "run", failing_make)
    assert not native.available() and not native.available()
    with pytest.raises(RuntimeError, match="make -C"):
        native.load()
    assert len(runs) == 1


def test_unported_dataset_and_loader_options_raise(manifest):
    """The host chain and the sharded loader are ported
    (tests/test_torch_augment.py, tests/test_torch_multiprocess.py): what
    still raises is what JAX's refuses."""
    with pytest.raises(NameError, match="late"):
        ds = tse.TseDataset(manifest, resample_to=SR, rir_folder=manifest, rir_mode="late")
        np.random.seed(0)
        for i in range(len(ds)):
            ds[i]
    with pytest.raises(ValueError, match="batch_sampler"):
        base.DataLoader([1, 2], shard=(0, 2), batch_sampler=[[0]])
    with pytest.raises(ValueError, match="seed"):
        base.DataLoader([1, 2], batch_size=2, shard=(0, 2), shuffle=True)


# -------------------------------------------------------- scheduler / optim
@pytest.mark.parametrize("kind,kw,losses", [
    ("stepLR", dict(gamma=0.5, patience=2), [None] * 6),
    ("Plateau", dict(gamma=0.1, patience=1, mode="min"),
     [1.0, 1.1, 1.2, 0.9, 0.95, 0.97, 0.99, 0.5]),
    ("Plateau", dict(gamma=0.5, patience=0, mode="max"), [1.0, 0.5, 2.0, 1.0]),
])
def test_lr_scheduler_matches_jax(kind, kw, losses):
    a = base.LearningRateScheduler(kind, base_lr=1e-3, **kw)
    b = jbase.LearningRateScheduler(kind, base_lr=1e-3, **kw)
    assert [a.step(x) for x in losses] == [b.step(x) for x in losses]
    assert a.state_dict() == b.state_dict()


def _jax_model():
    spk = tuple([JTCN(C, 24, 3, dilation=d, causal=False, tcn_norm="gLN",
                      dconv_norm="gGN") for d in (1, 2)]
                + [JASP(C, 16), JConv(2 * C, E, 1, use_bias=False)])
    return JWrap(encoder=JEnc(**ENC), masker=JSkiM(**SKIM), speaker_net=spk,
                 loss_func_wav=JSDRLoss.init_mode("sisnr"), mask_constraint="ReLU")


def _port_model():
    fk = dict(dtype=torch.float64, device="cpu")
    spk = ([TCN(C, 24, 3, dilation=d, **fk) for d in (1, 2)]
           + [AttentiveStatisticsPooling(C, 16, **fk), Conv1d(2 * C, E, 1, bias=False, **fk)])
    return SoTaskWrapModule(FreeEncDec(**ENC, **fk), SkiM(**SKIM, **fk), spk,
                            loss_func_wav=SDRLoss.init_mode("sisnr"),
                            mask_constraint="ReLU").eval()


@pytest.fixture(scope="module")
def variables():
    return _variables(np.random.default_rng(5))


def _variables(rng):
    """f64 JAX variables of the small model, perturbed away from the init."""
    x = jnp.zeros((2, SR // 2))
    init = jax.jit(lambda key: _jax_model().init(key, noisy=x, enroll=x, ref_clean=x,
                                                 train=False))
    v = init(jax.random.PRNGKey(0))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64)
                               + 0.05 * rng.standard_normal(np.shape(a)),
                               jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return v


def _hparam(tmp, manifest, **train):
    h = {"DATASET": {"type": "TSE", "sample_rate": SR, "max_length": 0.5,
                     "train": manifest, "dev": manifest, "eval": None,
                     "single_spk_prob": 0.0, "inactive_training": 0.0,
                     "enroll_rule": "fixed_length"},
         "MODEL": {"type": "tse_skim_v0_causal"},
         "LOSS": {"sig_loss": "sisnr", "alpha": 10.0, "cls_loss": None},
         "OPTIMIZER": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999,
                       "weight_decay": 0.01, "lr_scheduler": "stepLR", "gamma": 0.5,
                       "patience": 1, "mode": "min", "num_epochs_decay": 0,
                       "gradiend_clip": 10.0, "multi_rate": True},
         "TRAIN": {"num_epochs": 2, "resume_epoch": None, "multi_gpu": False,
                   "use_tensorboard": False, "batch_size": 3, "num_workers": 0,
                   "model_save_dir": os.path.join(tmp, "ckpt"),
                   "log_dir": os.path.join(tmp, "log"),
                   "contrastive_learning": False, "seed": 3}}
    h["TRAIN"].update(train)
    return h


def test_optimizer_chain_matches_make_tx(rng, variables):
    """Adam + weight decay + per-module factors (speaker net and encoder at
    0.1x) for 3 steps on the same gradients."""
    v = variables
    hp = _hparam("/unused", "/unused")
    owner = object.__new__(jtse.TseTask)
    owner.hparam = hp
    with jax.enable_x64(True):
        tx = optax.chain(owner._make_tx(), optax.scale(np.float32(1e-3)))
        params = v["params"]
        opt_state = tx.init(params)

        @jax.jit
        def step(grads, opt_state, params):
            upd, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, upd), opt_state

        model = _port_model()
        model.load_state_dict(fj.from_jax(v), strict=True)
        port = object.__new__(tse.TseTask)
        port.hparam, port.model = hp, model
        opt = port._make_optimizer()
        assert sorted(g["factor"] for g in opt.param_groups) == [0.1, 1.0]
        for _ in range(3):
            grads = jax.tree_util.tree_map(
                lambda a: rng.standard_normal(np.shape(a)), params)
            params, opt_state = step(grads, opt_state, params)
            named = fj.params_by_name(grads)
            for n, p in model.named_parameters():
                p.grad = torch.from_numpy(np.array(named[n]))
            opt.step()
    want = fj.params_by_name(jax.device_get(params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-12,
                                   rtol=1e-10, err_msg=n)


# ------------------------------------------------------------------ trainer
class _F64Collate(tse.TseCollateFunc):
    """The batches in float64, so both trainers run in float64."""

    def __call__(self, batch):
        out = super().__call__(batch)
        for k in ("clean_wav", "process_wav", "enroll_wav"):
            out[k] = out[k].astype(np.float64)
        return out


def _recording(cls):
    class Rec(cls):
        def _consume_metrics(self, current_epoch, ctx, metrics):
            loss = super()._consume_metrics(current_epoch, ctx, metrics)
            self.losses = getattr(self, "losses", []) + [loss]
            return loss

        def compute_dev_loss(self, current_epoch):
            out = super().compute_dev_loss(current_epoch)
            self.dev = getattr(self, "dev", []) + [out["total_loss"]]
            return out

    return Rec


def _port_loaders(hp, manifest, collate=None):
    ds = tse.TseDataset(manifest, resample_to=SR, max_length=0.5,
                        enroll_rule="fixed_length")
    mk = lambda: base.DataLoader(ds, batch_size=3, shuffle=True, seed=3,
                                 collate_fn=collate or _F64Collate())
    return mk(), mk()


def _port_task(hp, manifest, v):
    model = _port_model()
    model.load_state_dict(fj.from_jax(v), strict=True)
    return _recording(tse.TseTask)(hp, model, "cpu", *_port_loaders(hp, manifest))


def test_tse_task_train_matches_jax(tmp_path, manifest, variables):
    v = variables
    hp = _hparam(str(tmp_path / "port"), manifest)
    task = _port_task(hp, manifest, v)
    task.train()
    with jax.enable_x64(True):
        jds = jtse.TseDataset(manifest, resample_to=SR, max_length=0.5,
                              enroll_rule="fixed_length")
        mk = lambda: jbase.DataLoader(jds, batch_size=3, shuffle=True, seed=3,
                                      collate_fn=_F64Collate())
        jtask = _recording(jtse.TseTask)(_hparam(str(tmp_path / "jax"), manifest),
                                         _jax_model(), lambda: v, "cpu", mk(), mk())
        jtask.train()
    assert len(task.losses) == len(jtask.losses) == 4
    np.testing.assert_allclose(task.losses, jtask.losses, atol=1e-8, rtol=1e-6)
    np.testing.assert_allclose(task.dev, jtask.dev, atol=1e-8, rtol=1e-6)
    assert task.best_epoch == jtask.best_epoch
    assert task.current_lr == jtask.current_lr
    want = fj.so_wrapper_tse_skim({"params": jax.device_get(jtask.state.params),
                                   "batch_stats": jax.device_get(jtask.state.batch_stats)})
    got = task.model.state_dict()
    assert set(got) == set(want)
    for n, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[n], atol=1e-8, rtol=1e-6, err_msg=n)
    info = (tmp_path / "port" / "ckpt" / "epoch_1.info").read_text()
    jinfo = (tmp_path / "jax" / "ckpt" / "epoch_1.info").read_text()
    assert info.splitlines()[:2] == jinfo.splitlines()[:2]   # epoch, lr


def test_resume_equals_straight_run(tmp_path, manifest, variables):
    """Plateau, so the LR stays put: a checkpoint holds the scheduler and
    LR from before its epoch's scheduler step, as JAX's does (ROADMAP §3)."""
    v = variables

    def hp(name, **train):
        h = _hparam(str(tmp_path / name), manifest, **train)
        h["OPTIMIZER"]["lr_scheduler"] = "Plateau"
        return h

    straight = _port_task(hp("a"), manifest, v)
    straight.train()
    first = _port_task(hp("b", num_epochs=1), manifest, v)
    first.train()
    second = _port_task(hp("b", resume_epoch=1), manifest, v)
    second.train()
    assert first.losses + second.losses == straight.losses
    assert first.dev + second.dev == straight.dev
    for (n, a), b in zip(straight.model.state_dict().items(),
                         second.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert second.state.step == straight.state.step == 4
    assert second.best_epoch == straight.best_epoch


# ---------------------------------------------------------------------- CLI
def _config(tmp_path, manifest):
    cfg = _hparam(str(tmp_path), manifest, num_epochs=1)
    cfg["TRAIN"].update(use_tensorboard=True, multi_gpu=True)
    cfg["DATASET"]["max_length"] = 0.5
    path = tmp_path / "TSE.json.yaml"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_train_on_the_cpu(tmp_path, manifest, monkeypatch):
    """The recipe's entry point with a tiny model in place of the flagship
    (the zoo name is looked up through `init_model`)."""
    def tiny(name, sig_loss=None, cls_loss=None, *, device=None, dtype=None,
             generator=None):
        fk = dict(device=device)
        spk = ([TCN(C, 24, 3, dilation=d, **fk) for d in (1, 2)]
               + [AttentiveStatisticsPooling(C, 16, **fk),
                  Conv1d(2 * C, E, 1, bias=False, **fk)])
        return SoTaskWrapModule(FreeEncDec(**ENC, **fk), SkiM(**SKIM, **fk), spk,
                                loss_func_wav=sig_loss, mask_constraint="ReLU").eval()

    monkeypatch.setattr(cli, "init_model", tiny)
    cfg = _config(tmp_path, manifest)
    task = cli.main(cli.parse_args([cfg, "--action", "train", "--backend", "cpu"]))
    assert (tmp_path / "ckpt" / "epoch_0.ckpt").is_file()
    info = (tmp_path / "ckpt" / "epoch_0.info").read_text()
    assert info.startswith("epoch: 0\nlr: ")
    assert (tmp_path / "log" / "metrics.jsonl").is_file()
    fresh = tiny("x", SDRLoss.init_mode("sisnr"), device="cpu")
    tree = torch.load(tmp_path / "ckpt" / "epoch_0.ckpt", weights_only=True)
    fresh.load_state_dict({**tree["params"], **tree["batch_stats"]}, strict=True)
    for (n, a), b in zip(task.model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n


def test_cli_defaults_to_the_card_and_unported_options_raise(tmp_path, manifest,
                                                              variables):
    cfg = _config(tmp_path, manifest)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--backend cpu"):
            cli.main(cli.parse_args([cfg]))
    # tSNE and export_model are ported: like every action but train they
    # need a checkpoint
    for argv in ([cfg, "--action", "tSNE"], [cfg, "--action", "export_model"]):
        with pytest.raises(ValueError, match="--ckpt is required"):
            cli.main(cli.parse_args(argv))
    with pytest.raises(ValueError, match="--action train"):
        cli.main(cli.parse_args([cfg, "--action", "eval", "--num_processes", "2"]))
    # serve is ported: like every action but train it needs a checkpoint
    with pytest.raises(ValueError, match="--ckpt is required"):
        cli.main(cli.parse_args([cfg, "--action", "serve", "--backend", "cpu"]))
    from puresound_tpu_torch.zoo.tse import init_loss

    assert init_loss({"LOSS": {"sig_loss": "tsdr", "sig_threshold": -30}})[1] is None
    # tensor parallelism is ported: it runs one process per card, so one
    # process with mp_devices > 1 points to --num_processes
    with pytest.raises(ValueError, match="--num_processes"):
        _port_task(_hparam(str(tmp_path), manifest, mp_devices=2), manifest, variables)
    with pytest.raises(ValueError, match="remat"):       # True / "dots" are ported
        _port_task(_hparam(str(tmp_path), manifest, remat="all"), manifest, variables)
