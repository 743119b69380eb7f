"""Port parity, the evaluation actions' checkpoints and models against the
JAX package on the CPU, inputs from numpy seeds:

- `utils/flax_ckpt.py` reads trees written by `flax.serialization.to_bytes`
  (float32 / float64 / int32 / bool arrays, numpy and Python scalars,
  strings, nil, complex, nested dicts and lists, an array chunked under a
  small `MAX_CHUNK_SIZE`, JAX's trainer checkpoint with its optimizer state)
  equal to `flax.serialization.msgpack_restore` leaf by leaf, bit for bit;
- `tasks/base.py`: `checkpoint_state` tells the port's `torch.save` files
  from JAX's msgpack ones by their bytes; `resolve_eval_params` /
  `average_checkpoints` at `model_average` 0, 1, 2 and 3 over a missing
  epoch equal JAX's `BaseTrainer.resolve_eval_params` on checkpoints
  written by JAX's `save_ckpt`, bit for bit (float32), from JAX's files, the
  port's files and a mix; a tensor that is not floating point comes from the
  last checkpoint; `for_model` drops keys the model lacks and raises on
  keys it lacks;
- the port's `inference` from a JAX-written checkpoint against JAX's from
  the same file in float64 (atol 1e-8, rtol 1e-6): a small flagship-style
  FiLM SkiM (also from a training checkpoint that carries GE2E's
  `loss_func_spk.*`), a small DPCRN and a small DPARN (BatchNorm in eval
  mode);
- `stream_signal` against JAX's at a small width in float32 (JAX's runs in
  float32 whatever x64 says): within 2e-5 of max|ref|, with the same
  length, and so the same chunk count and delay trim.
"""
import functools
import os
import types

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.dparn import DPARN as JDPARN
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.nnet.encoder import ConvEncDec as JConvEncDec
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.loss.metrics import GE2ELoss as JGE2E
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.streaming import file_eval as jfile_eval
from puresound_tpu.tasks import base as jbase
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.dparn import DPARN
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.streaming import file_eval
from puresound_tpu_torch.tasks import base
from puresound_tpu_torch.utils import flax_ckpt
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

ATOL, RTOL = 1e-8, 1e-6
KEY = jax.random.PRNGKey(0)
C, E = 24, 8
TSE_ENC = dict(win_length=32, hop_length=16, laten_length=C, output_active=True)
SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2, seg_size=10,
            seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
            embed_fusion="FiLM", block_with_embed=(1, 1))
N_FFT, HOP = 128, 32
NS_ENC = dict(fft_length=N_FFT, win_length=N_FFT, hop_length=HOP, trainable=True,
              output_format="Complex")
UNET = dict(input_type="RI", input_dim=N_FFT, norm_type="bN2d", dropout=0.0,
            channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2, kernel_t=(2, 2, 2, 2, 2),
            stride_t=(1, 1, 1, 1, 1), dilation_t=(1, 1, 1, 1, 1), kernel_f=(5, 3, 3, 3, 3),
            stride_f=(2, 2, 1, 1, 1), dilation_f=(1, 1, 1, 1, 1), delay=(0, 0, 0, 0, 0),
            rnn_hidden=16)
NS_WRAP = dict(drop_first_bin=True, mask_constraint="linear", f_type="Complex",
               mask_type="Complex")


# -------------------------------------------------------------- the models
def _models(kind, loss_spk=False):
    """(JAX wrapper, its eval-time twin without losses, a function making the
    port's wrapper for a dtype), small widths."""
    if kind == "tse":
        spk_j = lambda: tuple([JTCN(C, 16, 3, dilation=d, causal=False, tcn_norm="gLN",
                                    dconv_norm="gGN") for d in (1, 2)]
                              + [JASP(C, 16), JConv(2 * C, E, 1, use_bias=False)])
        jw = lambda **kw: JWrap(encoder=JEnc(**TSE_ENC), masker=JSkiM(**SKIM),
                                speaker_net=spk_j(), mask_constraint="ReLU", **kw)

        def port(dtype):
            fk = dict(dtype=dtype)
            spk = ([TCN(C, 16, 3, dilation=d, tcn_norm="gLN", dconv_norm="gGN", **fk)
                    for d in (1, 2)]
                   + [AttentiveStatisticsPooling(C, 16, **fk), Conv1d(2 * C, E, 1, bias=False,
                                                                     **fk)])
            return SoTaskWrapModule(FreeEncDec(**TSE_ENC, **fk), SkiM(**SKIM, **fk), spk,
                                    mask_constraint="ReLU").eval()

        train = jw(loss_func_spk=JGE2E(nspks=2, putts=2)) if loss_spk else jw()
        return train, jw(), port
    jmasker, masker = ((JDPARN(nhead=4, **UNET), lambda **fk: DPARN(nhead=4, **UNET, **fk))
                       if kind == "dparn" else (JDPCRN(**UNET), lambda **fk: DPCRN(**UNET, **fk)))
    jw = JWrap(encoder=JConvEncDec(**NS_ENC), masker=jmasker, **NS_WRAP)
    port = lambda dtype: SoTaskWrapModule(ConvEncDec(**NS_ENC, dtype=dtype),
                                          masker(dtype=dtype), **NS_WRAP).eval()
    return jw, jw, port


def _init(jwrap, kind, loss_spk=False):
    L = 320
    if kind != "tse":
        return jwrap.init(KEY, jnp.zeros((1, L)), method=JWrap.inference)
    if loss_spk:   # a training tree: the GE2E loss's w / b under loss_func_spk
        return jwrap.init(KEY, noisy=jnp.zeros((4, L)), enroll=jnp.zeros((4, 2 * L)),
                          ref_clean=jnp.zeros((4, L)), spk_class=jnp.zeros((4,), jnp.int32),
                          train=False)
    return jwrap.init(KEY, jnp.zeros((1, L)), jnp.zeros((1, 2 * L)), method=JWrap.inference)


def _variables(jwrap, kind, rng, dtype=np.float64, loss_spk=False, scale=0.2):
    """Random variables in the layout of JAX's init (its shapes from
    `jax.eval_shape`, nothing compiled); BatchNorm variances positive."""
    shapes = jax.eval_shape(lambda: _init(jwrap, kind, loss_spk))
    v = jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(dtype), shapes)
    if v.get("batch_stats"):
        v["batch_stats"] = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5,
                                                  v["batch_stats"])
    return v


def _inference(jwrap, variables, *args):
    return jax.jit(functools.partial(jwrap.apply, method=JWrap.inference))(
        variables, *map(jnp.asarray, args))


class _JaxTrainer:
    """Enough of JAX's BaseTrainer to call its own `save_ckpt`: the state
    and bookkeeping `_ckpt_tree` reads, with an Adam optimizer state."""
    _ckpt_tree = jbase.BaseTrainer._ckpt_tree
    save_ckpt = jbase.BaseTrainer.save_ckpt
    current_lr = 1e-3

    def __init__(self, variables):
        params = variables["params"]
        self.state = types.SimpleNamespace(params=params,
                                           batch_stats=variables.get("batch_stats", {}),
                                           opt_state=optax.adam(1e-3).init(params))
        self.best_loss, self.best_epoch, self.overall_step = 0.25, 1, 40
        self.scheduler = jbase.LearningRateScheduler("Plateau", base_lr=1e-3)


def _jax_save(path, variables, epoch=0):
    _JaxTrainer(variables).save_ckpt(str(path), epoch, {"total_loss": np.float32(0.5)})


class _PortTrainer(base.BaseTrainer):
    """The port's BaseTrainer around a model, to call its `save_ckpt`."""

    def __init__(self, model):
        self.model = model
        super().__init__({"OPTIMIZER": {"lr_scheduler": "Plateau", "lr": 1e-3},
                          "TRAIN": {}}, "cpu")


def _port_save(path, model, epoch=0):
    _PortTrainer(model).save_ckpt(str(path), epoch, {"total_loss": 0.5})


# ------------------------------------------------------------- the reader
def _leaves_equal(got, want, path=""):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _leaves_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _leaves_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want or (got != got and want != want), path


def _trees(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "nested": {"params": {"a": f(3, 4), "b": {"c": f(5), "d": {"e": f(2, 3, 4)}}},
                   "batch_stats": {"m": {"mean": f(7), "var": np.abs(f(7))}}},
        "dtypes": {"i": np.arange(-5, 7, dtype=np.int32).reshape(3, 4),
                   "b": rng.random(9) > 0.5, "d": rng.standard_normal(4),
                   "u": np.arange(6, dtype=np.uint8), "h": f(4).astype(np.float16),
                   "empty": np.zeros((0, 3), np.float32), "nan": np.array([np.nan, np.inf])},
        "scalars": {"np32": np.float32(1.25), "np64": np.float64(-3.5), "npi": np.int32(-7),
                    "npb": np.bool_(True), "arr0": np.asarray(3), "py_i": 7, "neg": -40000,
                    "big": 2 ** 40, "py_f": 0.1, "none": None, "t": True, "f": False,
                    "s": "epoch", "long": "x" * 300, "cx": 1.5 - 2j, "lst": [1, 2.5, "a"]},
        "big map": {f"k{i:03d}": {"w": f(2)} for i in range(40)},
    }


@pytest.mark.parametrize("name", ["nested", "dtypes", "scalars", "big map"])
def test_reader_matches_flax_msgpack_restore(rng, name):
    tree = _trees(rng)[name]
    data = fser.to_bytes(tree)
    assert flax_ckpt.is_msgpack_map(data)
    _leaves_equal(flax_ckpt.msgpack_restore(data), fser.msgpack_restore(data))


def test_reader_unchunks_arrays_as_flax(rng, monkeypatch):
    """Arrays over MAX_CHUNK_SIZE (patched to 64 bytes) are written in flat
    chunks; both readers put them back together."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"big": rng.standard_normal((9, 7)).astype(np.float32),
                       "small": np.ones(3, np.float32)},
            "ints": {"x": np.arange(100, dtype=np.int32)}}
    data = fser.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = flax_ckpt.msgpack_restore(data)
    _leaves_equal(got, fser.msgpack_restore(data))
    np.testing.assert_array_equal(got["params"]["big"], tree["params"]["big"])


def test_reader_widens_bfloat16_exactly(rng):
    """numpy has no bfloat16 here: its arrays come back as float32 with the
    same values (a bfloat16 widens to float32 exactly)."""
    x = jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16)
    got = flax_ckpt.msgpack_restore(fser.to_bytes({"w": x}))["w"]
    assert got.dtype == np.float32 and got.shape == (5, 3)
    np.testing.assert_array_equal(got, np.asarray(x.astype(jnp.float32)))


def test_reader_matches_flax_on_a_trainer_checkpoint(rng, tmp_path):
    jw, _, _ = _models("dpcrn")
    _jax_save(tmp_path / "epoch_3.ckpt", _variables(jw, "dpcrn", rng, np.float32), 3)
    data = (tmp_path / "epoch_3.ckpt").read_bytes()
    got = flax_ckpt.msgpack_restore(data)
    _leaves_equal(got, fser.msgpack_restore(data))
    assert set(got) == {"params", "batch_stats", "opt_state", "meta", "scheduler"}
    with pytest.raises(ValueError):
        flax_ckpt.msgpack_restore(data[:-3])
    with pytest.raises(ValueError):
        flax_ckpt.msgpack_restore(data + b"\x00")


# ----------------------------------------------------- loading, averaging
def _ns_epochs(rng, tmp_path, n=3):
    """JAX's DPCRN variables (float32) of n epochs, each saved by JAX's
    save_ckpt as epoch_<i>.ckpt."""
    jw, _, port = _models("dpcrn")
    vs = [_variables(jw, "dpcrn", rng, np.float32) for i in range(n + 1)]
    v0 = vs.pop()
    for i, v in enumerate(vs):
        _jax_save(tmp_path / f"epoch_{i}.ckpt", v, i)
    return jw, v0, vs, port


def _hp(tmp_path, n_avg):
    return {"TRAIN": {"model_save_dir": str(tmp_path), "model_average": n_avg}}


def _equal_state(model, variables):
    want = fj.from_jax(jax.device_get(variables))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.dtype == torch.float32, k
        np.testing.assert_array_equal(t.numpy(), want[k].numpy(), err_msg=k)


@pytest.mark.parametrize("n_avg,missing", [(0, None), (1, None), (2, None), (3, 1)],
                         ids=["single", "average 1", "average 2", "average 3, epoch 1 missing"])
def test_resolve_eval_params_matches_jax(rng, tmp_path, capsys, n_avg, missing):
    jw, v0, _, port = _ns_epochs(rng, tmp_path)
    if missing is not None:
        os.remove(tmp_path / f"epoch_{missing}.ckpt")
    want = jbase.BaseTrainer.resolve_eval_params(_hp(tmp_path, n_avg), "epoch_2.ckpt", v0)
    jax_out = capsys.readouterr().out
    model = base.BaseTrainer.resolve_eval_params(_hp(tmp_path, n_avg), "epoch_2.ckpt",
                                                 port(torch.float32))
    assert capsys.readouterr().out == jax_out
    _equal_state(model, want)
    # a name that is not epoch_<n>.ckpt loads the one file
    os.rename(tmp_path / "epoch_2.ckpt", tmp_path / "best.pt")
    _equal_state(base.BaseTrainer.resolve_eval_params(_hp(tmp_path, n_avg), "best.pt",
                                                      port(torch.float32)),
                 jbase.BaseTrainer.load_params_from_ckpt(str(tmp_path / "best.pt"), v0))


def test_average_of_port_and_mixed_checkpoints_matches_jax(rng, tmp_path):
    """The port's own checkpoints of the same values, and a mix of JAX's and
    the port's, average to JAX's result bit for bit."""
    jw, v0, vs, port = _ns_epochs(rng, tmp_path)
    paths = [str(tmp_path / f"epoch_{i}.ckpt") for i in range(3)]
    want = jbase.BaseTrainer.average_checkpoints(paths, v0)
    for i in (0, 2):
        m = port(torch.float32)
        m.load_state_dict(fj.from_jax(vs[i]))
        _port_save(tmp_path / f"port_{i}.ckpt", m, i)
        assert (tmp_path / f"port_{i}.ckpt").read_bytes()[:2] == b"PK"
    mixed = [str(tmp_path / "port_0.ckpt"), paths[1], str(tmp_path / "port_2.ckpt")]
    _equal_state(base.BaseTrainer.average_checkpoints(mixed, port(torch.float32)), want)
    # the port's checkpoint_state reads either format to the same tensors
    a, b = base.checkpoint_state(paths[0]), base.checkpoint_state(mixed[0])
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="neither"):
        base.checkpoint_state(str(bad))


def test_average_takes_non_float_tensors_from_the_last_checkpoint(tmp_path):
    class Toy(torch.nn.Module):
        def __init__(self, w, n):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(w, dtype=torch.float32))
            self.register_buffer("count", torch.tensor(n))

    _port_save(tmp_path / "epoch_0.ckpt", Toy([1.0, 2.0], 3))
    _port_save(tmp_path / "epoch_1.ckpt", Toy([2.0, 5.0], 7))
    out = base.BaseTrainer.resolve_eval_params(_hp(tmp_path, 2), "epoch_1.ckpt",
                                               Toy([0.0, 0.0], 0))
    assert out.w.tolist() == [1.5, 3.5] and out.count.item() == 7


def test_for_model_drops_extra_keys_and_raises_on_missing():
    _, _, port = _models("dpcrn")
    model = port(torch.float32)
    sd = dict(model.state_dict())
    sd["loss_func_spk.w"] = torch.ones(())
    assert list(fj.for_model(sd, model)) == list(model.state_dict())
    del sd["masker.dprnn_block1.inter_norm.weight"]
    with pytest.raises(KeyError, match="lacks 1"):
        fj.for_model(sd, model)


# --------------------------------------------- inference from a JAX checkpoint
@pytest.mark.parametrize("kind,loss_spk", [("tse", False), ("tse", True), ("dpcrn", False),
                                           ("dparn", False)],
                         ids=["tse", "tse training ckpt with GE2E", "dpcrn", "dparn"])
def test_inference_from_a_jax_checkpoint_matches_jax(rng, tmp_path, kind, loss_spk):
    jtrain, jeval, port = _models(kind, loss_spk)
    with jax.enable_x64(True):
        v = _variables(jtrain, kind, rng, loss_spk=loss_spk)
        if loss_spk:
            assert set(v["params"]["loss_func_spk"]) == {"w", "b"}
        _jax_save(tmp_path / "epoch_0.ckpt", v)
        ev = jbase.BaseTrainer.resolve_eval_params(
            _hp(tmp_path, None), "epoch_0.ckpt", _variables(jeval, kind, rng))
        assert "loss_func_spk" not in ev["params"]
        x = 0.3 * rng.standard_normal((1, 480))
        args = (x,) if kind != "tse" else (x, 0.3 * rng.standard_normal((1, 800)))
        want = _inference(jeval, ev, *args)
    model = base.BaseTrainer.resolve_eval_params(_hp(tmp_path, None), "epoch_0.ckpt",
                                                 port(torch.float64))
    with torch.inference_mode():
        got = model.inference(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------- stream_signal
@pytest.mark.parametrize("kind", ["tse", "dpcrn", "dparn"])
def test_stream_signal_matches_jax(rng, kind):
    _, jw, port = _models(kind)
    v = _variables(jw, kind, rng, np.float32)
    model = port(torch.float32)
    model.load_state_dict(fj.from_jax(v))
    wav = 0.3 * rng.standard_normal(1000).astype(np.float32)
    jeng, eng = jfile_eval.build_engine(jw), file_eval.build_engine(model)
    dvec = jdvec = None
    if kind == "tse":
        enroll = 0.3 * rng.standard_normal((1, 900)).astype(np.float32)
        jdvec = jax.jit(functools.partial(jeng.apply, method=type(jeng).embed))(
            v, jnp.asarray(enroll))
        with torch.inference_mode():
            dvec = eng.embed(torch.from_numpy(enroll))
    want, _ = jfile_eval.stream_signal(jeng, v, wav, 8000, chunk_ms=16, dvec=jdvec)
    got, rtf = file_eval.stream_signal(eng, wav, 8000, chunk_ms=16, dvec=dvec)
    assert got.shape == want.shape == (1000,) and got.dtype == np.float32 and rtf > 0
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    with pytest.raises(ValueError):
        file_eval.stream_signal(eng, wav, 8000, fused=True, mk_kernel=True)


@pytest.mark.parametrize("kind,routes", [("dpcrn", ({"fused": True}, {"dp_kernel": True},
                                                    {"mk_kernel": True})),
                                         ("dparn", ({"fused": True, "attn_kernel": True},
                                                    {"mk_kernel": True}))])
def test_stream_signal_kernel_routes_and_half(rng, kind, routes):
    """The kernel routes (their plain versions on the CPU) stream what the
    stock route streams, within 2e-5 of max|ref| in float32; `half` streams
    a bfloat16 copy within 25 dB (the DPARN serving bar) of it."""
    _, jw, port = _models(kind)
    v = _variables(jw, kind, rng, np.float32)
    model = port(torch.float32)
    model.load_state_dict(fj.from_jax(v))
    wav = 0.3 * rng.standard_normal(1200).astype(np.float32)
    ref, _ = file_eval.stream_signal(file_eval.build_engine(model), wav, 8000)
    for opts in routes:
        got, _ = file_eval.stream_signal(file_eval.build_engine(model), wav, 8000, **opts)
        assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max(), opts
    half = port(torch.float32)
    half.load_state_dict(fj.from_jax(v))
    got, _ = file_eval.stream_signal(file_eval.build_engine(half), wav, 8000, half=True)
    assert next(half.parameters()).dtype == torch.bfloat16
    snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((got - ref) ** 2))
    assert snr >= 25, snr
