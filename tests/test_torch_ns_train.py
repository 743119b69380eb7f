"""Port parity, NS training (the STFT losses, `zoo.ns.init_loss`,
`NsDataset` / `NsCollateFunc`, the NS recipe, seeded dropout) against the
JAX package on the CPU, inputs from numpy seeds:

- `stft_mag`, `STFTLoss`, `MultiResolutionSTFTLoss` and
  `over_suppression_loss`: values and input gradients in float64 (atol
  1e-8, rtol 1e-6), and float32 out of bfloat16 inputs, as JAX's;
- every branch of `zoo.ns.init_loss`;
- `NsDataset` batches bit for bit with JAX's (crop, zero-pad, volume draw;
  0 and 2 workers);
- one `make_train_step` step of small DPCRN and DPARN models on the
  shipped `stft_ov` loss at dropout 0 against JAX's (loss and gradients),
  and three steps with the trainer's Adam at the shipped configs'
  weight decay 1e-5 against JAX's `_make_tx` chain (float64);
- `Dropout`: masks from the model's generator (the same seed, the same
  masks), torch's global RNG untouched, rate and 1/(1-p) scaling;
- `python -m puresound_tpu_torch.egs.ns.main --action train --backend
  cpu` on the shipped `vctk_dpcrn_1a.yaml` / `vctk_dparn_1a.yaml` with
  small models; the other actions raise.
"""
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.dparn import DPARN as JDPARN
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.nnet.encoder import ConvEncDec as JEncDec
from puresound_tpu.nnet.loss import stft_loss as jstft
from puresound_tpu.parallel.mesh import TrainState as JTrainState
from puresound_tpu.parallel.mesh import make_train_step as j_make_train_step
from puresound_tpu.tasks import base as jbase
from puresound_tpu.tasks import ns as jns
from puresound_tpu.zoo import ns as jzoo
from puresound_tpu_torch.egs.ns import main as cli
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.dparn import DPARN
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec
from puresound_tpu_torch.nnet.lobe.dropout import Dropout
from puresound_tpu_torch.nnet.loss import stft_loss
from puresound_tpu_torch.parallel import TrainState, make_train_step
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.tasks import base, ns
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.zoo import ns as zoo

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

ATOL, RTOL = 1e-8, 1e-6
SR = 8000
N_FFT, HOP = 128, 32
UNET = dict(input_type="RI", input_dim=N_FFT, norm_type="bN2d", dropout=0.0,
            channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2,
            kernel_t=(2, 2, 2, 2, 2), stride_t=(1, 1, 1, 1, 1),
            dilation_t=(1, 1, 1, 1, 1), kernel_f=(5, 3, 3, 3, 3),
            stride_f=(2, 2, 1, 1, 1), dilation_f=(1, 1, 1, 1, 1),
            delay=(0, 0, 0, 0, 0), rnn_hidden=16)
ENC = dict(fft_length=N_FFT, win_length=N_FFT, hop_length=HOP, trainable=True,
           output_format="Complex")
WRAP = dict(drop_first_bin=True, mask_constraint="linear", f_type="Complex",
            mask_type="Complex")
CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "egs", "ns", "conf")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=rtol)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _value_grads(jfn, pfn, *arrays):
    """(port value, JAX value, port grads, JAX grads) in float64."""
    with jax.enable_x64(True):
        want, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
            *[jnp.asarray(a) for a in arrays])
    ts = [_t(a, True) for a in arrays]
    got = pfn(*ts)
    return got, want, torch.autograd.grad(got, ts), jax.device_get(jg)


# ------------------------------------------------------------- STFT losses
@pytest.mark.parametrize("fft,hop,win", [(512, 128, 512), (1024, 120, 600), (256, 50, 240)])
def test_stft_mag_matches_jax(rng, fft, hop, win):
    x = 0.3 * rng.standard_normal((2, 1600))
    window = np.asarray(jstft.hann_window(win))
    w = rng.standard_normal((2, 1600 // hop + 1, fft // 2 + 1))
    got, want, (g,), (jg,) = _value_grads(
        lambda a: jnp.sum(jstft.stft_mag(a, fft, hop, win, jnp.asarray(window)) * w),
        lambda a: (stft_loss.stft_mag(a, fft, hop, win, torch.from_numpy(window)) * _t(w)
                   ).sum(), x)
    _close(got, want)
    _close(g, jg)


def test_stft_loss_and_multi_resolution_match_jax(rng):
    x, y = 0.3 * rng.standard_normal((2, 4000)), 0.3 * rng.standard_normal((2, 4000))
    with jax.enable_x64(True):
        for got, want in zip(stft_loss.STFTLoss(512, 100, 400)(_t(x), _t(y)),
                             jstft.STFTLoss(512, 100, 400)(jnp.asarray(x), jnp.asarray(y))):
            _close(got, want)
    got, want, grads, jgrads = _value_grads(
        lambda a, b: jstft.MultiResolutionSTFTLoss()(a, b),
        lambda a, b: stft_loss.MultiResolutionSTFTLoss()(a, b), x, y)
    _close(got, want)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)


@pytest.mark.parametrize("p", [0.5, 0.3])
def test_over_suppression_loss_matches_jax(rng, p):
    x, y = 0.3 * rng.standard_normal((2, 3000)), 0.3 * rng.standard_normal((2, 3000))
    got, want, grads, jgrads = _value_grads(
        lambda a, b: jstft.over_suppression_loss(a, b, p=p),
        lambda a, b: stft_loss.over_suppression_loss(a, b, p=p), x, y)
    _close(got, want)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)


NS_LOSSES = ["sisnr", "sdsdr", "sdr", "tsdr", "stft", "stft_ov", "STFT_OV", None]


@pytest.mark.parametrize("sig_loss", NS_LOSSES)
def test_ns_init_loss_branch_matches_jax(rng, sig_loss):
    hp = {"LOSS": {"sig_loss": sig_loss,
                   "sig_threshold": -30 if sig_loss == "tsdr" else None}}
    jl, pl = jzoo.init_loss(hp), zoo.init_loss(hp)
    if sig_loss is None:
        assert jl is None and pl is None
        return
    x, y = 0.3 * rng.standard_normal((3, 2400)), 0.3 * rng.standard_normal((3, 2400))
    with jax.enable_x64(True):
        _close(pl(_t(x), _t(y), None), jl(jnp.asarray(x), jnp.asarray(y), None))


def test_stft_losses_are_float32_under_bf16_as_jax(rng):
    x = (0.3 * rng.standard_normal((2, 3000))).astype(np.float32)
    y = (0.3 * rng.standard_normal((2, 3000))).astype(np.float32)
    jl, pl = jzoo.init_loss({"LOSS": {"sig_loss": "stft_ov"}}), \
        zoo.init_loss({"LOSS": {"sig_loss": "stft_ov"}})
    want = jl(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16), None)
    got = pl(torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16(), None)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# ------------------------------------------------------------------ dataset
def _write_manifest(folder, n=6, seed=1):
    """n noisy / clean pairs at 8 kHz of 0.2-0.6 s (some shorter than the
    crop, so they are zero-padded)."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    scp, ref = [], []
    for i in range(n):
        L = int((0.2 + 0.08 * i) * SR)
        clean = 0.2 * np.sin(2 * np.pi * (100 + 20 * i) * np.arange(L) / SR)
        for name, sig, lines in (("noisy", clean + 0.1 * rng.standard_normal(L), scp),
                                 ("clean", clean, ref)):
            path = os.path.join(folder, f"{name}_{i}.wav")
            wavfile.write(path, SR, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
            lines.append(f"utt_{i} {path}")
    for name, lines in (("wav2scp", scp), ("wav2ref", ref)):
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return folder


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return _write_manifest(str(tmp_path_factory.mktemp("ns_manifest")))


NS_BATCH_CASES = [dict(max_length=0.3), dict(max_length=0.3, vol_perturbed="0.5,1.5"),
                  dict(max_length=0.3, vol_perturbed=(0.2, 0.9), num_workers=2),
                  dict(max_length=None, batch_size=1)]


@pytest.mark.parametrize("case", NS_BATCH_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_ns_batches_match_jax_bit_for_bit(manifest, case):
    case = dict(case)
    workers, bs = case.pop("num_workers", 0), case.pop("batch_size", 4)
    loaders = [mb.DataLoader(m.NsDataset(manifest, resample_to=SR, **case), batch_size=bs,
                             shuffle=True, collate_fn=m.NsCollateFunc(),
                             num_workers=workers, seed=9)
               for m, mb in ((jns, jbase), (ns, base))]
    for _ in range(2):
        want, got = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == -(-6 // bs)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"uttid", "clean_wav", "process_wav"}
            assert g["uttid"] == w["uttid"]
            for k in ("clean_wav", "process_wav"):
                assert g[k].dtype == w[k].dtype == np.float32
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_ns_dataset_augmentation_options_raise(manifest):
    """The host chain is ported (tests/test_torch_augment.py holds its
    batches against JAX's): an unknown rir_mode raises at the first warped
    target, as JAX's does."""
    for m in (jns, ns):
        ds = m.NsDataset(manifest, resample_to=SR, rir_folder=manifest, rir_mode="late")
        assert ds.augmentor is not None and len(ds.augmentor.rir) == 12
        np.random.seed(0)
        with pytest.raises(NameError, match="late"):
            for i in range(len(ds)):
                ds[i]


# --------------------------------------------------------------- the step
def _models(kind, dropout=0.0):
    """(the JAX wrapper, a function making the port's: (device, dtype, generator)
    -> wrapper), both on the stft_ov loss."""
    unet = dict(UNET, dropout=dropout)
    jmasker, masker = ((JDPARN(nhead=4, **unet), lambda **fk: DPARN(nhead=4, **unet, **fk))
                       if kind == "dparn" else (JDPCRN(**unet), lambda **fk: DPCRN(**unet, **fk)))
    jwrap = JWrap(encoder=JEncDec(**ENC), masker=jmasker,
                  loss_func_wav=jzoo.init_loss({"LOSS": {"sig_loss": "stft_ov"}}), **WRAP)

    def port(device=None, dtype=torch.float64, generator=None):
        fk = dict(device=device, dtype=dtype)
        return SoTaskWrapModule(ConvEncDec(**ENC, **fk), masker(generator=generator, **fk),
                                loss_func_wav=zoo.init_loss({"LOSS": {"sig_loss": "stft_ov"}}),
                                **WRAP)

    return jwrap, port


def _variables(jwrap, rng, L):
    v = jwrap.init(jax.random.PRNGKey(0), jnp.zeros((1, L)), method=JWrap.inference)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) + 0.05 * rng.standard_normal(np.shape(a)),
        jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return v


def _flat(kind, tree):
    fn = fj.so_wrapper_ns_dparn if kind == "dparn" else fj.so_wrapper_ns_dpcrn
    return fn(tree)


@pytest.mark.parametrize("kind", ["dpcrn", "dparn"])
def test_ns_train_step_matches_jax(rng, kind):
    """One step (loss, grad_norm, every gradient, the BatchNorm statistics)
    on the shipped stft_ov loss; the MR-STFT's 2048-point frames need more
    than 1024 samples."""
    L = HOP * 40
    jwrap, port = _models(kind)
    v = _variables(jwrap, rng, L)
    model = port(dtype=torch.float64)
    model.load_state_dict(fj.from_jax(v), strict=True)
    batch = {"noisy": 0.3 * rng.standard_normal((2, L)),
             "ref_clean": 0.3 * rng.standard_normal((2, L))}
    with jax.enable_x64(True):
        jstate = JTrainState.create(v["params"], v["batch_stats"], optax.identity())
        jstep = j_make_train_step(jwrap, grad_clip=10.0, donate=False)
        _, jm = jstep(jstate, {k: jnp.asarray(a) for k, a in batch.items()},
                      jax.random.PRNGKey(1))

        def loss_fn(params):
            out, upd = jwrap.apply({"params": params, "batch_stats": v["batch_stats"]},
                                   **{k: jnp.asarray(a) for k, a in batch.items()},
                                   train=True, mutable=["batch_stats"])
            return out, upd["batch_stats"]

        # one call gives both: the gradients and, in the aux, the statistics
        (_, jstats), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    step = make_train_step(model, grad_clip=10.0)
    state, m = step(state, {k: torch.from_numpy(a) for k, a in batch.items()})
    _close(m["loss"], jm["loss"])
    _close(m["grad_norm"], jm["grad_norm"])
    clip = min(1.0, 10.0 / float(jm["grad_norm"]))
    want = _flat(kind, {"params": jax.device_get(jgrads)})
    for n, p in model.named_parameters():
        _close(p.grad, want[n] * clip, atol=ATOL, rtol=RTOL)
    stats = _flat(kind, {"params": v["params"], "batch_stats": jax.device_get(jstats)})
    sd = model.state_dict()      # the parameters (lr 0) and the new statistics
    assert set(sd) == set(stats)
    for n, t in sd.items():
        _close(t, stats[n])


def _hp(kind, tmp="/unused", **train):
    hp = load_hparam(os.path.join(CONF, f"vctk_{kind}_1a.yaml"))
    hp["TRAIN"].update(model_save_dir=os.path.join(tmp, "models"),
                       log_dir=os.path.join(tmp, "logs"), **train)
    return hp


@pytest.mark.parametrize("kind", ["dpcrn", "dparn"])
def test_three_adam_steps_at_the_shipped_weight_decay_match_jax(rng, kind):
    """The shipped configs' optimizer (Adam 1e-4, weight decay 1e-5 added to
    the gradient before Adam, clip 10): the trainer's torch.optim.Adam
    against JAX's add_decayed_weights + scale_by_adam over 3 train steps."""
    hp = _hp(kind)
    assert hp["OPTIMIZER"]["weight_decay"] == 1e-5
    L = HOP * 40
    jwrap, port = _models(kind)
    v = _variables(jwrap, rng, L)
    model = port(dtype=torch.float64)
    model.load_state_dict(fj.from_jax(v), strict=True)
    owner, trainer = object.__new__(jns.NsTask), object.__new__(ns.NsTask)
    owner.hparam = trainer.hparam = hp
    trainer.model = model
    opt = trainer._make_optimizer()
    assert [g["weight_decay"] for g in opt.param_groups] == [1e-5]
    lr = np.float32(hp["OPTIMIZER"]["lr"])
    clip = hp["OPTIMIZER"]["gradiend_clip"]
    with jax.enable_x64(True):
        jstate = JTrainState.create(v["params"], v["batch_stats"],
                                    optax.chain(owner._make_tx(), optax.scale(lr)))
        jstep = j_make_train_step(jwrap, grad_clip=clip, donate=False)
        state, step = TrainState(model, opt), make_train_step(model, grad_clip=clip)
        for i in range(3):
            batch = {"noisy": 0.3 * rng.standard_normal((2, L)),
                     "ref_clean": 0.3 * rng.standard_normal((2, L))}
            jstate, jm = jstep(jstate, {k: jnp.asarray(a) for k, a in batch.items()},
                               jax.random.PRNGKey(i))
            state, m = step(state, {k: torch.from_numpy(a) for k, a in batch.items()})
            _close(m["loss"], jm["loss"])
        want = _flat(kind, {"params": jax.device_get(jstate.params),
                            "batch_stats": jax.device_get(jstate.batch_stats)})
    for n, t in model.state_dict().items():
        _close(t, want[n], atol=1e-8, rtol=1e-6)


# ------------------------------------------------------------------ dropout
def test_dropout_masks_come_from_the_generator_not_the_global_rng():
    x = torch.ones(4000, dtype=torch.float64)
    state = torch.random.get_rng_state()
    outs = []
    for seed in (7, 7, 8):
        d = Dropout(0.25, generator=torch.Generator().manual_seed(seed)).train()
        outs.append((d(x), d(x)))
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], outs[0][1])       # the stream moves on
    assert not torch.equal(outs[0][0], outs[2][0])


def test_dropout_rate_scale_and_eval():
    d = Dropout(0.1, generator=torch.Generator().manual_seed(0)).train()
    x = torch.full((200_000,), 3.0, dtype=torch.float64)
    y = d(x)
    assert set(torch.unique(y).tolist()) == {0.0, 3.0 / 0.9}
    assert abs((y == 0).double().mean().item() - 0.1) < 0.004
    assert torch.equal(d.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)
    assert y.dtype == x.dtype and d(x.bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["dpcrn", "dparn"])
def test_model_dropouts_share_the_models_generator(rng, kind):
    """Every dropout of a model built from one generator draws from one
    stream on its device: the same seed gives the same training loss, another
    seed another, and dropout 0 equals eval-mode masks."""
    L = HOP * 40
    _, port = _models(kind, dropout=0.1)
    batch = {"noisy": torch.from_numpy(0.3 * rng.standard_normal((2, L))),
             "ref_clean": torch.from_numpy(0.3 * rng.standard_normal((2, L)))}
    losses = []
    for seed in (3, 3, 4):
        model = port(dtype=torch.float64, generator=torch.Generator().manual_seed(seed))
        drops = [m for m in model.modules() if isinstance(m, Dropout)]
        assert len(drops) >= 5 and len({id(m.generator) for m in drops}) == 1
        for m in drops:
            m.p = 0.1
        model.train()
        with torch.no_grad():
            losses.append(model(**batch).item())
    assert losses[0] == losses[1] != losses[2]


# ---------------------------------------------------------------------- CLI
SHIPPED = sorted(glob.glob(os.path.join(os.path.dirname(CONF), "..", "*", "conf", "*.yaml"))
                 + glob.glob(os.path.join(os.path.dirname(CONF), "..", "*", "*.yaml")))


@pytest.mark.parametrize("path", SHIPPED, ids=os.path.basename)
def test_dump_hparam_round_trips_the_shipped_configs(monkeypatch, tmp_path, path):
    """`dump_hparam` (the chip phases' overridden configs) writes YAML's JSON
    form: PyYAML and the JSON fallback read it back equal, floats as floats
    (`weight_decay: 1.0e-05`, which PyYAML reads as a string when written
    `1e-05`)."""
    want = load_hparam(path)
    want["DATASET"]["train"] = str(tmp_path / "a b")
    out = str(tmp_path / "c.yaml")
    dump_hparam(want, out)
    assert load_hparam(out) == want
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert load_hparam(out) == want
    assert all(type(v) is type(want[s][k]) for s in want for k, v in load_hparam(out)[s].items())


def _tiny(name, sig_loss=None, *, device=None, dtype=torch.float32, generator=None):
    kind = "dparn" if "dparn" in name else "dpcrn"
    return _models(kind)[1](device=device, dtype=dtype, generator=generator)


@pytest.mark.parametrize("kind", ["dpcrn", "dparn"])
def test_cli_trains_the_shipped_config_on_the_cpu(tmp_path, manifest, monkeypatch, kind):
    """The shipped vctk config read from its file (stft_ov, weight decay
    1e-5), a small model in place of the zoo's, 8 kHz audio; paths, epochs,
    workers, seed and the crop overridden."""
    seen = []

    def tiny(name, sig_loss=None, **kw):
        seen.append((name, sig_loss))
        model = _tiny(name, **kw)
        model.loss_func_wav = sig_loss
        return model

    monkeypatch.setattr(cli, "init_model", tiny)
    hp = _hp(kind, str(tmp_path), num_epochs=1, num_workers=0, seed=4, batch_size=2)
    hp["DATASET"].update(train=manifest, dev=manifest, sample_rate=SR, max_length=0.3)
    cfg = tmp_path / f"{kind}.yaml"
    dump_hparam(hp, str(cfg))
    task = cli.main(cli.parse_args([str(cfg), "--action", "train", "--backend", "cpu"]))
    assert seen[0][0] == f"ns_{kind}_v0_causal" and seen[0][1] is not None
    assert task.state.step == 3
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert len([r for r in logged if r["name"] == "train/batch_loss"]) == 3
    assert all(np.isfinite(r["value"]) for r in logged)
    tree = torch.load(tmp_path / "models" / "epoch_0.ckpt", weights_only=True)
    # the checkpoint holds the persistent state only (not the STFT bases)
    assert not any("basis" in n or "_window" in n for n in tree["batch_stats"])
    fresh = _tiny(kind, device="cpu")
    fresh.load_state_dict({**tree["params"], **tree["batch_stats"]}, strict=True)
    for (n, a), b in zip(task.model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
    # and a resumed run starts from it
    hp["TRAIN"].update(resume_epoch=1, num_epochs=2)
    dump_hparam(hp, str(cfg))
    resumed = cli.main(cli.parse_args([str(cfg), "--action", "train", "--backend", "cpu"]))
    assert resumed.state.step == 6


def test_cli_defaults_to_the_card_and_other_actions_raise(tmp_path):
    cfg = tmp_path / "c.yaml"
    dump_hparam(_hp("dpcrn", str(tmp_path)), str(cfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--backend cpu"):
            cli.main(cli.parse_args([str(cfg)]))
    # export_model is ported: like every action but train it needs --ckpt
    with pytest.raises(ValueError, match="--ckpt is required"):
        cli.main(cli.parse_args([str(cfg), "--action", "export_model"]))
    # multi-process runs train only (JAX's check)
    with pytest.raises(ValueError, match="--action train"):
        cli.main(cli.parse_args([str(cfg), "--action", "dev", "--num_processes", "2"]))
    # serve is ported: like every action but train it needs a checkpoint
    with pytest.raises(ValueError, match="--ckpt is required"):
        cli.main(cli.parse_args([str(cfg), "--action", "serve", "--backend", "cpu"]))
