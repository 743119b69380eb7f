"""Port parity, the flagship's contrastive recipe (GE2E, `SpeakerSampler`),
against the JAX package on the CPU, inputs from numpy seeds:

- the wrapper's tasks at a small width in float64 (atol 1e-8, rtol 1e-6):
  task 1 with GE2E / AAM-softmax / cross-entropy as the speaker loss,
  task 2 (GE2E over the enrollment's and the enhanced waveform's
  d-vectors, JAX's interleave and mixture-encoder re-embedding) and task 3
  (the triplet loop), the loss and every gradient, the loss's parameters
  among them, carried by `from_jax`;
- `SpeakerSampler` and `DataLoader(batch_sampler=)` batches bit for bit with
  JAX's under one seed, at 0 and 2 workers (JAX's process pool);
- `TseTask.train()` on contrastive batches (task 1 + GE2E, `multi_rate`,
  so GE2E's `w` / `b` train at 0.1x) against JAX's `TseTask`;
- the recipe `--action train --backend cpu` on the shipped
  `libri2mix_max_2spk_clean_16k_1c.yaml` with a small model: GE2E's
  parameters move and `epoch_0.ckpt` reloads equal, them included.
"""
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.loss.aamsoftmax import AAMsoftmax as JAAM
from puresound_tpu.nnet.loss.metrics import GE2ELoss as JGE2E
from puresound_tpu.nnet.loss.metrics import TripletLoss as JTriplet
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDRLoss
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.src.sampler import SpeakerSampler as JSampler
from puresound_tpu.tasks import base as jbase
from puresound_tpu.tasks import tse as jtse
from puresound_tpu.zoo.tse import cross_entropy as j_cross_entropy
from puresound_tpu_torch.egs.tse import main as cli
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.aamsoftmax import AAMsoftmax
from puresound_tpu_torch.nnet.loss.metrics import GE2ELoss, TripletLoss
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.src.sampler import SpeakerSampler
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.tasks import base, tse
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.zoo.tse import cross_entropy

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

ATOL, RTOL = 1e-8, 1e-6
SR = 8000
C, E, N_CLASS = 16, 8, 5
ENC = dict(win_length=16, hop_length=8, laten_length=C, output_active=True)
SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2, seg_size=10,
            seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
            embed_fusion="FiLM", block_with_embed=(1, 1))
CONF_1C = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "egs", "tse", "conf", "libri2mix_max_2spk_clean_16k_1c.yaml")


def _jax_spk():
    return tuple([JTCN(C, 24, 3, dilation=d, causal=False, tcn_norm="gLN",
                       dconv_norm="gGN") for d in (1, 2)]
                 + [JASP(C, 16), JConv(2 * C, E, 1, use_bias=False)])


def _port_spk(**fk):
    return ([TCN(C, 24, 3, dilation=d, **fk) for d in (1, 2)]
            + [AttentiveStatisticsPooling(C, 16, **fk), Conv1d(2 * C, E, 1, bias=False, **fk)])


# (JAX losses, port losses) by task: (wav, spk, others)
def _losses(kind, nspks, putts):
    f64 = dict(dtype=torch.float64)
    sisnr = (JSDRLoss.init_mode("sisnr"), SDRLoss.init_mode("sisnr"))
    ge2e = (JGE2E(nspks=nspks, putts=putts), GE2ELoss(nspks, putts, **f64))
    aam = (JAAM(input_dim=E, n_class=N_CLASS), AAMsoftmax(E, N_CLASS, **f64))
    ce = (j_cross_entropy, cross_entropy)
    trip = (JTriplet(margin=0.3, distance="consine"), TripletLoss(margin=0.3,
                                                                  distance="consine"))
    none = (None, None)
    return {"1 ge2e": (sisnr, ge2e, none), "1 aamsoftmax": (sisnr, aam, none),
            "1 cross_entropy": (sisnr, ce, none), "2 ge2e": (none, ge2e, none),
            "3 aamsoftmax triplet": (sisnr, aam, trip),
            "3 cross_entropy triplet": (sisnr, ce, trip)}[kind]


def _pair(kind, rng, n, L, nspks, putts):
    (jw, pw), (js, ps), (jo, po) = _losses(kind, nspks, putts)
    jwrap = JWrap(encoder=JEnc(**ENC), masker=JSkiM(**SKIM), speaker_net=_jax_spk(),
                  loss_func_wav=jw, loss_func_spk=js, loss_func_others=jo,
                  mask_constraint="ReLU")
    batch = _batch(rng, n, L)
    v = jwrap.init(jax.random.PRNGKey(0),
                   **{k: jnp.asarray(a) for k, a in batch.items()}, train=False)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + (0.05 * rng.standard_normal(np.shape(a)) if np.issubdtype(
            np.asarray(a).dtype, np.floating) else 0), jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = SoTaskWrapModule(FreeEncDec(**ENC, dtype=torch.float64),
                             SkiM(**SKIM, dtype=torch.float64),
                             _port_spk(dtype=torch.float64), loss_func_wav=pw,
                             loss_func_spk=ps, loss_func_others=po,
                             mask_constraint="ReLU")
    model.load_state_dict(fj.from_jax(v), strict=True)
    return jwrap, v, model, batch


def _batch(rng, n, L):
    return {"noisy": 0.3 * rng.standard_normal((n, L)),
            "enroll": 0.3 * rng.standard_normal((n, 2 * L)),
            "ref_clean": 0.3 * rng.standard_normal((n, L)),
            "spk_class": rng.integers(0, N_CLASS, n).astype(np.int32)}


TASK_CASES = ["1 ge2e", "1 aamsoftmax", "1 cross_entropy", "2 ge2e",
              "3 aamsoftmax triplet", "3 cross_entropy triplet"]


@pytest.mark.parametrize("kind", TASK_CASES)
def test_task_loss_and_gradients_match_jax(rng, kind):
    task = int(kind[0])
    # task 2 groups (enrollment, enhanced) pairs: nspks = batch, putts = 2
    n, (nspks, putts) = (3, (3, 2)) if task == 2 else (4, (2, 2))
    jwrap, v, model, batch = _pair(kind, rng, n, 8 * 30, nspks, putts)
    assert model.task == jwrap.task == task
    if "ge2e" in kind or "aamsoftmax" in kind:
        names = {n for n, _ in model.named_parameters() if n.startswith("loss_func_spk.")}
        assert names == {f"loss_func_spk.{k}" for k in v["params"]["loss_func_spk"]}
    with jax.enable_x64(True):
        def loss_fn(params):
            out, _ = jwrap.apply({"params": params, "batch_stats": v["batch_stats"]},
                                 **{k: jnp.asarray(a) for k, a in batch.items()},
                                 alpha=10.0, train=True, mutable=["batch_stats"])
            return out

        want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    model.train()
    got = model(**{k: torch.from_numpy(a) for k, a in batch.items()}, alpha=10.0)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(got, params, allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL, rtol=RTOL)
    jg = fj.params_by_name(jax.device_get(jgrads))
    assert set(jg) == set(names)
    for name, g in zip(names, grads):
        g = torch.zeros_like(model.get_parameter(name)) if g is None else g
        np.testing.assert_allclose(g.numpy(), jg[name], atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_task2_reembeds_through_the_mixture_encoder_and_interleaves(rng):
    """The GE2E input is [dvec_0, enh_dvec_0, dvec_1, ...] of width E, the
    enhanced waveform embedded through the model's (mixture) encoder."""
    _, _, model, batch = _pair("2 ge2e", rng, 3, 8 * 30, 3, 2)
    seen = []
    model.loss_func_spk.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    enc_calls = []
    model.encoder.register_forward_hook(lambda m, a, o: enc_calls.append(a[0].shape))
    model.eval()
    with torch.no_grad():
        model(**{k: torch.from_numpy(a) for k, a in batch.items()})
        t = {k: torch.from_numpy(a) for k, a in batch.items()}
        dvec = model._dvec(model._encode(t["enroll"]))
        enh = model.inference(t["noisy"], t["enroll"])
        enh_dvec = model._dvec(model._encode(enh))
    total = seen[0]
    assert total.shape == (6, E)
    torch.testing.assert_close(total[0::2], dvec, rtol=0, atol=0)
    torch.testing.assert_close(total[1::2], enh_dvec, rtol=0, atol=0)
    assert enc_calls[:3] == [t["enroll"].shape, t["noisy"].shape, t["noisy"].shape]


# ------------------------------------------------------------------ batches
def _write_manifest(folder, n_spk=4, per_spk=3, seconds=0.5, seed=1):
    """n_spk speakers x per_spk mixtures at 8 kHz, keys mix_<i>_s1; each
    mixture's enrollment is another utterance of its target speaker."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    lines = {f: [] for f in ("wav2scp", "wav2ref", "ref2list", "ref2spk", "wav2spk")}
    L = int(seconds * SR)
    for i in range(n_spk * per_spk):
        spk = i % n_spk
        paths = {}
        t = np.arange(L) / SR
        clean = 0.2 * np.sin(2 * np.pi * (90 + 30 * spk) * t + i)
        for name, sig in (("mix", clean + 0.1 * rng.standard_normal(L)), ("clean", clean),
                          ("enroll", clean[::-1] + 0.02 * rng.standard_normal(L))):
            paths[name] = os.path.join(folder, f"{name}_{i}.wav")
            wavfile.write(paths[name], SR, np.clip(sig * 32768, -32768, 32767
                                                   ).astype(np.int16))
        key = f"mix_{i}_s1"
        lines["wav2scp"].append(f"{key} {paths['mix']}")
        lines["wav2ref"].append(f"{key} {paths['clean']}")
        lines["ref2list"].append(f"{key} {paths['enroll']}")
        lines["ref2spk"].append(f"{key} sp{spk}")
        lines["wav2spk"].append(f"{key} sp{spk}-sp{(spk + 1) % n_spk}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return _write_manifest(str(tmp_path_factory.mktemp("contrastive_manifest")))


@pytest.mark.parametrize("n_per", [2, 5])
def test_speaker_sampler_matches_jax(n_per):
    meta = {f"sp{s}": list(range(3 * s, 3 * s + 3)) for s in range(5)}
    random.seed(11)
    want = list(JSampler(meta, 4, n_spks=3, n_per=n_per))
    random.seed(11)
    got = list(SpeakerSampler(meta, 4, n_spks=3, n_per=n_per))
    assert got == want and len(got) == len(SpeakerSampler(meta, 4, 3, n_per)) == 4
    for b in got:
        spk = [i // 3 for i in b]
        assert len(set(spk)) == 3 and all(spk[j] == spk[j - j % n_per]
                                          for j in range(len(b)))


def _sampler_loaders(manifest, workers):
    out = []
    for mod_ds, mod_base, sampler, nw in ((jtse, jbase, JSampler, 2),
                                          (tse, base, SpeakerSampler, workers)):
        random.seed(23)
        ds = mod_ds.TseDataset(manifest, resample_to=SR, max_length=0.25,
                               enroll_rule=None, vol_perturbed="0.5,1.5")
        out.append(mod_base.DataLoader(
            ds, batch_sampler=sampler(ds.sampler_meta(), 3 * len(ds) // (2 * 2),
                                      n_spks=2, n_per=2),
            collate_fn=mod_ds.TseCollateFunc(), num_workers=nw, seed=5))
    assert out[0].dataset.sampler_meta() == out[1].dataset.sampler_meta()
    assert sorted(len(v) for v in out[1].dataset.sampler_meta().values()) == [3] * 4
    return out


@pytest.mark.parametrize("workers", [0, 2])
def test_batch_sampler_loader_matches_jax_bit_for_bit(manifest, workers):
    """JAX's process pool (2 workers) draws the sampler in the parent, where
    nothing else touches Python's RNG; the port gives those batches at 0
    and at 2 workers, over two epochs."""
    jloader, loader = _sampler_loaders(manifest, workers)
    assert len(loader) == len(jloader) == 9
    for _ in range(2):
        random.seed(31)
        want = list(jloader)
        random.seed(31)
        got = list(loader)
        assert len(got) == len(want) == 9
        for g, w in zip(got, want):
            assert g["uttid"] == w["uttid"]
            for k in set(w) - {"uttid"}:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_batch_sampler_with_shard_raises():
    with pytest.raises(ValueError, match="batch_sampler"):
        base.DataLoader([1, 2], batch_sampler=[[0, 1]], shard=(0, 2))


# ------------------------------------------------------------------ trainer
class _F64Collate(tse.TseCollateFunc):
    def __call__(self, batch):
        out = super().__call__(batch)
        for k in ("clean_wav", "process_wav", "enroll_wav"):
            out[k] = out[k].astype(np.float64)
        return out


def _hparam(tmp, manifest):
    return {"DATASET": {"type": "TSE", "sample_rate": SR, "max_length": 0.25,
                        "train": manifest, "dev": manifest, "eval": None,
                        "single_spk_prob": 0.0, "inactive_training": 0.0,
                        "enroll_rule": None},
            "MODEL": {"type": "tse_skim_v0_causal"},
            "LOSS": {"sig_loss": "sisnr", "alpha": 0.05, "cls_loss": "ge2e"},
            "OPTIMIZER": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "weight_decay": 0.0,
                          "lr_scheduler": "Plateau", "gamma": 0.5, "patience": 5,
                          "mode": "min", "num_epochs_decay": 0, "gradiend_clip": 10.0,
                          "multi_rate": True},
            "TRAIN": {"num_epochs": 1, "resume_epoch": None, "multi_gpu": False,
                      "use_tensorboard": False, "batch_size": 4, "num_workers": 0,
                      "model_save_dir": os.path.join(tmp, "ckpt"),
                      "log_dir": os.path.join(tmp, "log"), "contrastive_learning": True,
                      "p_spks": 2, "p_utts": 2, "repeat": 1, "seed": 3}}


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


def test_tse_task_contrastive_train_matches_jax(tmp_path, manifest, rng):
    jwrap, v, model, _ = _pair("1 ge2e", rng, 4, 8 * 30, 2, 2)
    model.eval()
    out = {}
    for side, mod_ds, mod_base, sampler, nw in (
            ("jax", jtse, jbase, JSampler, 2), ("port", tse, base, SpeakerSampler, 0)):
        hp = _hparam(str(tmp_path / side), manifest)
        random.seed(41)
        loaders = []
        for _ in range(2):
            ds = mod_ds.TseDataset(manifest, resample_to=SR, max_length=0.25)
            loaders.append(mod_base.DataLoader(
                ds, batch_sampler=sampler(ds.sampler_meta(), len(ds) // 4, 2, 2),
                collate_fn=_F64Collate(), num_workers=nw, seed=3))
        if side == "jax":
            with jax.enable_x64(True):
                task = _recording(jtse.TseTask)(hp, jwrap, lambda: v, "cpu", *loaders)
                task.train()
                params = jax.device_get(task.state.params)
                out[side] = (task, fj.so_wrapper_tse_skim(
                    {"params": params, "batch_stats": jax.device_get(
                        task.state.batch_stats)}))
        else:
            task = _recording(tse.TseTask)(hp, model, "cpu", *loaders)
            groups = {n: g["factor"] for g in task.state.optimizer.param_groups
                      for n, p in model.named_parameters() if any(p is q for q in g["params"])}
            assert groups["loss_func_spk.w"] == groups["loss_func_spk.b"] == 0.1
            task.train()
            out[side] = (task, {n: t.numpy() for n, t in model.state_dict().items()})
    (jtask, want), (task, got) = out["jax"], out["port"]
    assert len(task.losses) == len(jtask.losses) == 3
    np.testing.assert_allclose(task.losses, jtask.losses, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(task.dev, jtask.dev, atol=ATOL, rtol=RTOL)
    assert set(got) == set(want)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], atol=ATOL, rtol=RTOL, err_msg=n)
    assert abs(got["loss_func_spk.w"] - v["params"]["loss_func_spk"]["w"]) > 0


# ---------------------------------------------------------------------- CLI
def test_cli_trains_the_shipped_1c_config_on_the_cpu(tmp_path, monkeypatch):
    """The shipped flagship config (GE2E, contrastive batches, p_spks 12 x
    p_utts 4), read from its file, with a small model in place of the
    flagship, 8 kHz audio, 12 speakers x 4 utterances and paths, epochs,
    workers and seed overridden."""
    folder = _write_manifest(str(tmp_path / "data"), n_spk=12, per_spk=4, seconds=0.3)

    def tiny(name, sig_loss=None, cls_loss=None, other_loss=None, *, device=None,
             dtype=None, generator=None):
        fk = dict(device=device)
        return SoTaskWrapModule(FreeEncDec(**ENC, **fk), SkiM(**SKIM, **fk),
                                _port_spk(**fk), loss_func_wav=sig_loss,
                                loss_func_spk=cls_loss, loss_func_others=other_loss,
                                mask_constraint="ReLU").eval()

    monkeypatch.setattr(cli, "init_model", tiny)
    hp = load_hparam(CONF_1C)
    assert hp["LOSS"]["cls_loss"] == "ge2e" and hp["TRAIN"]["contrastive_learning"]
    hp["DATASET"].update(train=folder, dev=folder, eval=None, sample_rate=SR,
                         max_length=0.25)
    hp["TRAIN"].update(num_epochs=1, num_workers=0, seed=3,
                       model_save_dir=str(tmp_path / "models"),
                       log_dir=str(tmp_path / "logs"))
    hp["LOSS"]["embed_dim"] = E
    cfg = tmp_path / "1c.yaml"
    dump_hparam(hp, str(cfg))
    task = cli.main(cli.parse_args([str(cfg), "--action", "train", "--backend", "cpu"]))
    assert isinstance(task.model.loss_func_spk, GE2ELoss)
    assert len(task.train_dataloader) == 3 * 48 // 48
    w, b = task.model.loss_func_spk.w.item(), task.model.loss_func_spk.b.item()
    assert w != 10.0 and b != -5.0
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert all(np.isfinite(r["value"]) for r in logged)
    tree = torch.load(tmp_path / "models" / "epoch_0.ckpt", weights_only=True)
    assert {"loss_func_spk.w", "loss_func_spk.b"} <= set(tree["params"])
    fresh = tiny("x", SDRLoss.init_mode("sisnr"), GE2ELoss(12, 4), device="cpu")
    fresh.load_state_dict({**tree["params"], **tree["batch_stats"]}, strict=True)
    for (n, a), b in zip(task.model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
