"""Port parity, the PVAD slice (`tse_skim_v0_causal_vad`, the shipped
`libri2mix-pvad_max_2spk_clean_16k_1a.yaml`): a small model of its layout
(FreeEncDec + TCN speaker net + causal FiLM SkiM, Sigmoid output) through
offline inference, the F1 training loss's gradients, `StreamingTSE` (fused
and unfused) and `make_session_server`; the PVAD set's batches
(`is_vad_dataset`, single-speaker and inactive-speaker draws); the zoo's
parameter count, `from_jax` and a JAX checkpoint at full width (shapes from
`jax.eval_shape`); and the recipe CLI's `train` / `dev` on a tiny PVAD set,
`dev` against JAX's CLI on one JAX checkpoint. Against the JAX package in
float64 (atol 1e-8, rtol 1e-6) on inputs from numpy seeds.
"""
import functools
import importlib.util
import os
import random
import sys
import types

import flax.serialization as fser
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
from puresound_tpu.nnet.loss.metrics import F1Loss as JF1
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.streaming.engine import StreamingTSE as JEngine
from puresound_tpu.tasks import base as jbase
from puresound_tpu.tasks import tse as jtse
from puresound_tpu.zoo import tse as jzoo
from puresound_tpu_torch.egs.tse import main as cli
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.metrics import F1Loss
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.streaming.deploy import make_session_server
from puresound_tpu_torch.streaming.engine import StreamingTSE, offline_equivalent_input
from puresound_tpu_torch.tasks import base, tse
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.zoo import tse as zoo

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "egs", "tse", "conf", "libri2mix-pvad_max_2spk_clean_16k_1a.yaml")
KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
SR = 8000
C, E = 16, 8
WIN, HOP = 32, 16
ENC = dict(win_length=WIN, hop_length=HOP, laten_length=C, output_active=True)
SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2, seg_size=10,
            seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
            embed_fusion="FiLM", block_with_embed=(1, 1))
WRAP = dict(mask_constraint="ReLU", output_constraint="Sigmoid")


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=msg)


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.array(a)).to(dtype)


def _jax_model(losses=True):
    spk = (JTCN(C, 16, 3, dilation=1, causal=False, tcn_norm="gLN", dconv_norm="gGN"),
           JASP(C, 8), JConv(2 * C, E, 1, use_bias=False))
    f1 = JF1()
    kw = dict(loss_func_wav=lambda enh, ref, others: f1(enh, ref)) if losses else {}
    return JWrap(encoder=JEnc(**ENC), masker=JSkiM(**SKIM), speaker_net=spk, **WRAP, **kw)


def _port_model(losses=True, device=None, dtype=torch.float64, **_):
    fk = dict(device=device, dtype=dtype)
    spk = [TCN(C, 16, 3, 1, **fk), AttentiveStatisticsPooling(C, 8, **fk),
           Conv1d(2 * C, E, 1, bias=False, **fk)]
    f1 = F1Loss()
    kw = dict(loss_func_wav=lambda enh, ref, others: f1(enh, ref)) if losses else {}
    return SoTaskWrapModule(FreeEncDec(**ENC, **fk), SkiM(**SKIM, **fk), spk, **WRAP,
                            **kw).eval()


@functools.lru_cache(maxsize=None)
def _variables(seed=0, dtype=np.float64):
    """JAX's inference variables of the small model (shapes from
    `jax.eval_shape`), leaves from a numpy seed, BatchNorm variances positive."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: _jax_model(False).init(
        KEY, jnp.zeros((1, 320)), jnp.zeros((1, 640)), method=JWrap.inference))

    def leaf(path, s):
        v = 0.3 * rng.standard_normal(s.shape)
        return (np.abs(v) + 0.5 if getattr(path[-1], "key", None) == "var" else v).astype(dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _jit(module, method=None, **kw):
    return jax.jit(functools.partial(module.apply, method=method, **kw))


def _pair():
    model = _port_model()
    model.load_state_dict(fj.from_jax(_variables()), strict=True)
    return model


def test_offline_inference_matches_jax_and_is_a_probability():
    rng = np.random.default_rng(1)
    x, enroll = 0.3 * rng.standard_normal((2, 16 * 25)), 0.3 * rng.standard_normal((2, 640))
    with jax.enable_x64(True):
        want = _jit(_jax_model(False), JWrap.inference)(_variables(), jnp.asarray(x),
                                                        jnp.asarray(enroll))
    with torch.no_grad():
        got = _pair().inference(_t(x), _t(enroll))
    _close(got, want)
    assert (got > 0).all() and (got < 1).all()


def test_f1_training_loss_and_gradients_match_jax():
    """The PVAD recipe's loss: F1 of the Sigmoid output against the frame
    labels, in training mode (SkiM and the speaker net's BatchNorm)."""
    rng = np.random.default_rng(2)
    b = {"noisy": 0.3 * rng.standard_normal((3, 480)),
         "enroll": 0.3 * rng.standard_normal((3, 400)),
         "ref_clean": (rng.random((3, 480)) > 0.5).astype(np.float64)}
    v, jwrap = _variables(), _jax_model()
    with jax.enable_x64(True):
        def loss_fn(params):
            loss, upd = jwrap.apply({"params": params, "batch_stats": v["batch_stats"]},
                                    **{k: jnp.asarray(a) for k, a in b.items()}, train=True,
                                    mutable=["batch_stats"])
            return loss, upd["batch_stats"]
        (want, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    model = _pair().train()
    loss = model(**{k: _t(a) for k, a in b.items()})
    loss.backward()
    _close(loss, want)
    want_g = fj.params_by_name(jax.device_get(grads))
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        _close(g, want_g[name], name)
    want_s = fj.from_jax({"params": v["params"], "batch_stats": jax.device_get(stats)})
    for name, t in model.state_dict().items():
        _close(t, want_s[name], name)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_streaming_step_matches_jax_and_offline(fused):
    """5 chunks of 5 frames (seg_size 10) through the Sigmoid output,
    against JAX's engine chunk by chunk and the port's offline inference of
    the zero-primed input."""
    v, j = _variables(), _jax_model(False)
    jeng = JEngine(encoder=j.encoder, masker=j.masker, speaker_net=j.speaker_net, **WRAP)
    model = _pair()
    engine = StreamingTSE.from_offline(model)
    rng = np.random.default_rng(3)
    B, S = 2, 5 * HOP
    x, enroll = 0.3 * rng.standard_normal((B, 5 * S)), 0.3 * rng.standard_normal((B, 640))
    with torch.no_grad():
        dvec = engine.embed(_t(enroll))
        state = engine.init_state(B, torch.float64)
    with jax.enable_x64(True):
        jdvec = _jit(jeng, JEngine.embed)(v, jnp.asarray(enroll))
        jstate = jeng.apply(v, B, jnp.float64, method=JEngine.init_state)
    jstep = _jit(jeng, JEngine.step)      # JAX's unfused step: the same math
    outs = []
    for k in range(5):
        chunk = x[:, k * S:(k + 1) * S]
        with torch.no_grad():
            y, state = engine.step(_t(chunk), dvec, state, fused=fused)
        with jax.enable_x64(True):
            jy, jstate = jstep(v, jnp.asarray(chunk), jdvec, jstate)
        _close(y, jy)
        outs.append(y)
    with torch.no_grad():
        offline = model.inference(offline_equivalent_input(_t(x), WIN, HOP), _t(enroll))
    _close(torch.cat(outs, -1), offline[:, :5 * S])


@pytest.fixture
def ring_hub():
    """The C++ ring hub SessionServer runs on (csrc/, built on demand)."""
    from puresound_tpu_torch.src import native

    return native.load()


def test_session_server_serves_the_sigmoid_output_fused(ring_hub):
    """fused=None takes the fused step for a SkiM masker; the served
    probabilities equal the bare engine's fused step."""
    model = _port_model(losses=False, dtype=torch.float32)
    model.load_state_dict(fj.from_jax(_variables(4, np.float32)), strict=True)
    bundle = make_session_server(model, None, n_slots=2, chunk_ms=10.0, enroll_len=640,
                                 lockstep=True)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    rng = np.random.default_rng(5)
    audio = (0.3 * rng.standard_normal((2, 3 * chunk))).astype(np.float32)
    enroll = (0.3 * rng.standard_normal((2, 640))).astype(np.float32)
    sids = [server.attach(enroll=enroll[i]) for i in range(2)]
    got = np.zeros_like(audio)
    for k in range(3):
        for i, sid in enumerate(sids):
            server.hub.push_input(sid, audio[i, k * chunk:(k + 1) * chunk])
        assert server.tick() == 2
        for i, sid in enumerate(sids):
            got[i, k * chunk:(k + 1) * chunk] = server.hub.pop_output(sid, chunk)
    with torch.no_grad():
        d = engine.embed(torch.from_numpy(enroll))
        st, want = engine.init_state(2), []
        for k in range(3):
            y, st = engine.step(torch.from_numpy(audio[:, k * chunk:(k + 1) * chunk]), d, st,
                                fused=True)
            want.append(y.numpy())
    np.testing.assert_allclose(got, np.concatenate(want, -1), atol=1e-6, rtol=1e-5)
    assert (got > 0).all() and (got < 1).all()


# ------------------------------------------------------------- the PVAD set
def _signal(rng, n):
    t = np.arange(n) / SR
    f0 = rng.uniform(120, 300)
    return 0.1 * sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k
                     for k in range(1, 6))


def _write(path, sig):
    wavfile.write(path, SR, np.clip(sig * 32768, -32768, 32767).astype(np.int16))


def _vad_manifest(folder, n=6, seed=1, seconds=0.6):
    """n mixtures of `seconds` with a 0 / 1 activity label wav (ref2vad),
    two enrollment candidates each, speakers sp0-sp2."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    names = ("wav2scp", "wav2ref", "ref2list", "ref2spk", "wav2spk", "ref2vad")
    lines = {k: [] for k in names}
    L = int(seconds * SR)
    for i in range(n):
        clean = _signal(rng, L) * (np.arange(L) > L // 3)
        sigs = {"mix": clean + 0.6 * _signal(rng, L), "clean": clean,
                "vad": (np.abs(clean) > 0).astype(np.float64) * 0.9,
                "enrollA": _signal(rng, L // 2), "enrollB": _signal(rng, L + 40 * i)}
        p = {k: os.path.join(folder, f"{k}_{i}.wav") for k in sigs}
        for k, sig in sigs.items():
            _write(p[k], sig)
        key = f"mix_{i}_s1"
        row = {"wav2scp": p["mix"], "wav2ref": p["clean"],
               "ref2list": f"{p['enrollA']} {p['enrollB']}", "ref2spk": f"sp{i % 3}",
               "wav2spk": f"sp{i % 3}-sp{(i + 1) % 3}", "ref2vad": p["vad"]}
        for k in names:
            lines[k].append(f"{key} {row[k]}")
    for k, ls in lines.items():
        with open(os.path.join(folder, f"{k}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


@pytest.fixture(scope="module")
def vad_set(tmp_path_factory):
    return _vad_manifest(str(tmp_path_factory.mktemp("pvad_set")))


VAD_CASES = [dict(single_spk_pb=0.1, inactive_training=0.1),
             dict(single_spk_pb=1.0), dict(inactive_training=1.0),
             dict(single_spk_pb=0.5, inactive_training=0.5, vol_perturbed="0.5,1.5")]


@pytest.mark.parametrize("case", VAD_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_pvad_batches_match_jax_bit_for_bit(vad_set, case):
    """Frame labels as the target, zeros for an inactive speaker, the
    mixture's clean speech for a single-speaker draw: JAX's loader's
    batches, two epochs."""
    loaders = [mod_base.DataLoader(
        mod_ds.TseDataset(vad_set, resample_to=SR, max_length=0.4,
                          enroll_rule="fixed_length", is_vad_dataset=True, **case),
        batch_size=3, shuffle=True, collate_fn=mod_ds.TseCollateFunc(), seed=7)
        for mod_ds, mod_base in ((jtse, jbase), (tse, base))]
    for _ in range(2):
        want, got = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["uttid"] == w["uttid"] and set(g) == set(w)
            for k in set(w) - {"uttid"}:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            labels = np.unique(g["clean_wav"])
            assert (np.isclose(labels, 0) | np.isclose(labels, 0.9, atol=1e-4)).all()


# ------------------------------------------------------- the zoo, full width
@functools.lru_cache(maxsize=None)
def _zoo_shapes():
    m = jzoo.init_model("tse_skim_v0_causal_vad")
    return jax.eval_shape(lambda: m.init(KEY, jnp.zeros((1, 2400)), jnp.zeros((1, 800)),
                                         method=JWrap.inference))


def test_zoo_model_matches_jax_count_and_loads_its_variables():
    """1,133,200 parameters, as JAX counts (with a 251-class AAM-softmax
    weight, 1,181,392: the reference's count); H = 64, two FiLM blocks; a
    random JAX tree loads strictly."""
    shapes = _zoo_shapes()
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    model = zoo.init_model("tse_skim_v0_causal_vad", device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 1_133_200
    assert n_jax + 251 * 192 == 1_181_392
    assert model.output_constraint == "Sigmoid" and model.masker.hidden_size == 64
    rng = np.random.default_rng(6)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               shapes)
    model.load_state_dict(fj.from_jax(v), strict=True)


def test_from_jax_maps_every_leaf_once():
    rng = np.random.default_rng(9)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape), _zoo_shapes())
    sd = fj.flat_from_jax(v)
    flat = lambda t: np.sort(np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(t)]))
    np.testing.assert_array_equal(flat(sd), flat(v))
    assert len(sd) == len(jax.tree_util.tree_leaves(v))


def test_jax_checkpoint_reads_into_the_zoo_model(tmp_path):
    rng = np.random.default_rng(7)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               _zoo_shapes())
    path = tmp_path / "epoch_0.ckpt"
    path.write_bytes(fser.to_bytes({"params": v["params"], "batch_stats": v["batch_stats"],
                                    "epoch": 0}))
    model = zoo.init_model("tse_skim_v0_causal_vad", device="cpu")
    model.load_state_dict(fj.for_model(base.checkpoint_state(str(path)), model), strict=True)
    want = fj.flat_from_jax(v)
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


# ---------------------------------------------------------------- the CLI
def _hp(data, save_dir, **train):
    hp = load_hparam(CONF)
    assert hp["LOSS"]["sig_loss"] == "f1" and hp["DATASET"]["type"] == "PVAD"
    assert hp["DATASET"]["single_spk_prob"] == hp["DATASET"]["inactive_training"] == 0.1
    hp["DATASET"].update(train=data, dev=data, eval=data, sample_rate=SR, max_length=0.4)
    hp["TRAIN"].update(model_save_dir=str(save_dir), log_dir=str(save_dir), **train)
    return hp


def test_cli_trains_the_shipped_pvad_config_on_the_cpu(tmp_path, vad_set, monkeypatch):
    """The shipped PVAD config read from its file (F1, alpha 0, no speaker
    loss, multi_gpu as on one card), a small model in place of the zoo's:
    finite losses, and epoch_0.ckpt reloads equal."""
    monkeypatch.setattr(cli, "init_model", lambda name, *losses, **kw: _port_model(
        True, device=kw.get("device"), dtype=torch.float32))
    hp = _hp(vad_set, tmp_path / "models", num_epochs=1, num_workers=0, seed=3,
             batch_size=3)
    assert hp["TRAIN"]["multi_gpu"]
    cfg = tmp_path / "pvad.yaml"
    dump_hparam(hp, str(cfg))
    task = cli.main(cli.parse_args([str(cfg), "--action", "train", "--backend", "cpu"]))
    assert len(task.train_dataloader) == 2 and task.model.loss_func_spk is None
    tree = torch.load(tmp_path / "models" / "epoch_0.ckpt", weights_only=True)
    fresh = _port_model(False, dtype=torch.float32)
    fresh.load_state_dict({**tree["params"], **tree["batch_stats"]}, strict=True)
    for (n, a), b in zip(task.model.state_dict().items(), fresh.state_dict().values()):
        assert torch.isfinite(a).all() and torch.equal(a, b), n


class _Jitted:
    """JAX's recipe calls `model.apply(variables, ..., method=inference)`;
    this stand-in jits it (the same computation, compiled once)."""

    def __init__(self, model):
        self._apply = jax.jit(functools.partial(model.apply, method=JWrap.inference))

    def apply(self, variables, *args, method=None):
        assert method is JWrap.inference
        return self._apply(variables, *args)


class _JaxTrainer:
    """Enough of JAX's BaseTrainer for its own `save_ckpt`."""
    _ckpt_tree = jbase.BaseTrainer._ckpt_tree
    save_ckpt = jbase.BaseTrainer.save_ckpt
    current_lr, best_loss, best_epoch, overall_step = 1e-3, 0.1, 0, 1

    def __init__(self, v):
        self.state = types.SimpleNamespace(params=v["params"], opt_state={},
                                           batch_stats=v["batch_stats"])
        self.scheduler = jbase.LearningRateScheduler("Plateau", base_lr=1e-3)


def _numbers(text):
    out = []
    for line in text.splitlines():
        vals = [p.strip() for p in line.replace(":", ",").split(",")[1:]]
        try:
            out.append([float(v) for v in vals if v])
        except ValueError:
            continue
    return out


def test_cli_dev_matches_the_jax_recipe(tmp_path, vad_set, monkeypatch, capsys):
    """`--action dev` on one JAX checkpoint through both CLIs: the printed
    accuracy / precision / recall / F1 of the binarised outputs, row by row
    and the means, within 1e-4 of JAX's."""
    v = _variables(8, np.float32)
    for d in ("jax", "port"):
        os.makedirs(tmp_path / d)
        _JaxTrainer(v).save_ckpt(str(tmp_path / d / "epoch_0.ckpt"), 0, {"total_loss": 0.1})
    spec = importlib.util.spec_from_file_location(
        "jax_recipe_pvad_main", os.path.join(ROOT, "egs", "tse", "main.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    monkeypatch.setitem(sys.modules, "model", types.SimpleNamespace(
        init_model=lambda name: _Jitted(_jax_model(False))))
    monkeypatch.setattr(jcli, "get_model_variables", lambda model, hparam: v)
    monkeypatch.setattr(cli, "init_model", lambda name, **kw: _port_model(
        False, device=kw.get("device"), dtype=torch.float32))
    cfg = tmp_path / "pvad.yaml"
    dump_hparam(_hp(vad_set, tmp_path / "port"), str(cfg))
    random.seed(7)
    jcli.action_dev(_hp(vad_set, tmp_path / "jax"), "cpu", "epoch_0.ckpt", "detail")
    want = capsys.readouterr().out
    random.seed(7)
    means = cli.main(cli.parse_args([str(cfg), "--action", "dev", "--metrics", "detail",
                                     "--ckpt", "epoch_0.ckpt", "--backend", "cpu"]))
    got = capsys.readouterr().out
    assert set(means) == {"accuracy", "precision", "recall", "f1_score"}
    g, w = _numbers(got), _numbers(want)
    assert len(g) == len(w) >= 7 and np.isfinite(sum(g, [])).all()
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
