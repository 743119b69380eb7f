"""Port parity, model export on `torch.export` (`utils/export.py`, the
recipes' `--action export_model`) against the JAX package's StableHLO
export, on the CPU at SR 2,000 with small models:

- the `puresound_tpu_torch::` ops (`lstm_scan_train_fp` in both layouts,
  `lstm_scan_train_tm`, `tcn_block_train`) pass `torch.library.opcheck`;
- per family (NS SISO DPCRN, TSE with a speaker net, DSS SIMO DPARN through
  their CLIs on a JAX-written checkpoint; embedding-free DPRNN and a causal
  UnetTcn through `export_program`): the artifact names equal JAX's set for
  the same wrapper; every loaded artifact equals the eager module (atol
  1e-6), `StreamStep` carried over six chunks (two SkiM segment boundaries)
  against the eager engine; the graphs hold the ops and no unrolled scan;
- every family's `FullModel` artifact equals JAX's deserialized
  `FullModel` at JAX's own tolerance (atol 1e-5, rtol 1e-4,
  tests/test_export.py:51), the weights carried by from_jax;
- the engines' refusals (non-causal SkiM / UnetTcn, DPRNN segments the
  chunk does not fill) give no StreamStep.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport

from puresound_tpu.nnet import unet as junet
from puresound_tpu.nnet.base_nn import SiMoTaskWrapModule as JSiMo
from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.conv_tasnet import GatedTCN as JGated
from puresound_tpu.nnet.dparn import DPARN_Mout as JDPARN_Mout
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.nnet.dprnn import DPRNN as JDPRNN
from puresound_tpu.nnet.encoder import ConvEncDec as JConvEncDec
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.lobe.trivial import Magnitude as JMag
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.utils import export as jex
from puresound_tpu_torch.egs.dss import main as dss_cli
from puresound_tpu_torch.egs.ns import main as ns_cli
from puresound_tpu_torch.egs.tse import main as tse_cli
from puresound_tpu_torch.nnet import unet
from puresound_tpu_torch.nnet.base_nn import SiMoTaskWrapModule, SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN, GatedTCN
from puresound_tpu_torch.nnet.dparn import DPARN_Mout
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.dprnn import DPRNN
from puresound_tpu_torch.nnet.encoder import ConvEncDec, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.lobe.trivial import Magnitude
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.ops import lstm_train_kernel as lk
from puresound_tpu_torch.ops import tcn_train_kernel as tk
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.streaming.file_eval import build_engine
from puresound_tpu_torch.utils import export as ex
from puresound_tpu_torch.utils import from_jax as fj
from tests.test_torch_dprnn import C as VC, HOP as VHOP, VEVE, WIN as VWIN
from tests.test_torch_eval_cli import _JaxTrainer

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
SR = 2000
C, E = 24, 8
TSE_ENC = dict(win_length=32, hop_length=16, laten_length=C, output_active=True)
SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2, seg_size=10,
            seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
            embed_fusion="FiLM", block_with_embed=(1, 1))
ENC = dict(fft_length=128, win_length=128, hop_length=32, trainable=True,
           output_format="Complex")
#: one-layer Unets: torch.export traces every op of an artifact, so the
#: widths and depths here set the file's time
LAYER = dict(input_type="RI", input_dim=128, dropout=0.0, channels=(1, 4), transpose_t_size=2,
             kernel_t=(2,), stride_t=(1,), dilation_t=(1,), kernel_f=(5,), stride_f=(2,),
             dilation_f=(1,), delay=(0,))
UNET = dict(LAYER, norm_type="bN2d", rnn_hidden=8)
DSS = dict(UNET, multi_output=2, nhead=2)
UNET_TCN = dict(LAYER, transpose_delay=True, norm_type="bN2d", tcn_norm="bN1d",
                dconv_norm="bN1d", causal=True, embed_dim=E, embed_norm=True,
                tcn_layer="gated", tcn_kernel=3, tcn_dim=8, tcn_dilated_basic=2,
                per_tcn_stack=1, repeat_tcn=1, tcn_with_embed=(1,))
NS_WRAP = dict(drop_first_bin=True, mask_constraint="linear", f_type="Complex",
               mask_type="Complex")
VEVE4 = dict(VEVE, seg_size=4)      # whole segments in export's 4-hop chunk
CONFS = {"ns": "egs/ns/conf/vctk_dpcrn_1a.yaml",
         "tse": "egs/tse/conf/libri2mix_max_2spk_clean_16k_1c.yaml",
         "dss": "egs/dss/conf/dss_dparn_1a.yaml"}
CLIS = {"ns": ns_cli, "tse": tse_cli, "dss": dss_cli}
N_CHUNKS = 6


# ------------------------------------------------------------------ models
def _models(kind):
    """(JAX wrapper, port wrapper in float32, eval) of the family."""
    if kind == "ns":
        return (JWrap(encoder=JConvEncDec(**ENC), masker=JDPCRN(**UNET), **NS_WRAP),
                SoTaskWrapModule(ConvEncDec(**ENC), DPCRN(**UNET), **NS_WRAP).eval())
    if kind == "tse":
        jspk = (JTCN(C, 16, 3, dilation=1, causal=False, tcn_norm="gLN", dconv_norm="gGN"),
                JASP(C, 16), JConv(2 * C, E, 1, use_bias=False))
        spk = [TCN(C, 16, 3, dilation=1, tcn_norm="gLN", dconv_norm="gGN"),
               AttentiveStatisticsPooling(C, 16), Conv1d(2 * C, E, 1, bias=False)]
        return (JWrap(encoder=JEnc(**TSE_ENC), masker=JSkiM(**SKIM), speaker_net=jspk,
                      mask_constraint="ReLU"),
                SoTaskWrapModule(FreeEncDec(**TSE_ENC), SkiM(**SKIM), spk,
                                 mask_constraint="ReLU").eval())
    if kind == "dss":
        return (JSiMo(encoder=JConvEncDec(**ENC), masker=JDPARN_Mout(**DSS), **NS_WRAP),
                SiMoTaskWrapModule(ConvEncDec(**ENC), DPARN_Mout(**DSS), **NS_WRAP).eval())
    if kind == "veve":
        enc = dict(win_length=VWIN, hop_length=VHOP, laten_length=VC, output_active=True)
        return (JWrap(encoder=JEnc(**enc), masker=JDPRNN(**VEVE4), speaker_net=None,
                      mask_constraint="ReLU", embedding_free_tse=True),
                SoTaskWrapModule(FreeEncDec(**enc), DPRNN(**VEVE4), None,
                                 embedding_free_tse=True, mask_constraint="ReLU").eval())
    jspk = (JMag(drop_first=False), JGated(64, 8, 3, dilation=1, causal=False, tcn_norm="gLN"),
            JASP(64, 8), JConv(128, E, 1, use_bias=False))
    spk = [Magnitude(drop_first=False), GatedTCN(64, 8, 3, 1, tcn_norm="gLN"),
           AttentiveStatisticsPooling(64, 8), Conv1d(128, E, 1, bias=False)]
    return (JWrap(encoder=JConvEncDec(**ENC), masker=junet.UnetTcn(**UNET_TCN), speaker_net=jspk,
                  mask_constraint="linear", drop_first_bin=True),
            SoTaskWrapModule(ConvEncDec(**ENC), unet.UnetTcn(**UNET_TCN), spk,
                             mask_constraint="linear", drop_first_bin=True).eval())


def _conditioned(kind):
    return kind in ("tse", "veve", "unet")


def _variables(jmodel, kind, seed):
    """float32 variables in the layout of JAX's init; BatchNorm variances
    positive."""
    rng = np.random.default_rng(seed)
    x = jnp.zeros((1, 320))
    args = (x, x) if _conditioned(kind) else (x,)
    method = JSiMo.inference if kind == "dss" else JWrap.inference
    shapes = jax.eval_shape(lambda: jmodel.init(KEY, *args, method=method))

    def leaf(path, s):
        v = (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        return np.abs(v) + 0.5 if getattr(path[-1], "key", None) == "var" else v

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_cli(kind, tmp_path, monkeypatch):
    """The family's CLI with the small model in place of the zoo's, and
    its config (model_save_dir under tmp_path)."""
    cli = CLIS[kind]
    fresh = lambda *a, device=None, **kw: _models(kind)[1].to(device or "cpu")
    monkeypatch.setattr(cli, "build_model" if kind == "dss" else "init_model", fresh)
    hp = load_hparam(os.path.join(ROOT, CONFS[kind]))
    hp["DATASET"]["sample_rate"] = SR
    hp["TRAIN"].update(model_save_dir=str(tmp_path), log_dir=str(tmp_path), model_average=1)
    cfg = tmp_path / "c.yaml"
    dump_hparam(hp, str(cfg))
    return cli, hp, cfg


def _jax_names(jmodel, v):
    """JAX's artifact set for this wrapper: the keys of `_subnet_fns`, and
    StreamStep where `_stream_step_fn` builds. Traced abstractly
    (`jax.eval_shape`): the names do not depend on the values."""
    names = set()

    def probe(dummy):
        names.update(jex._subnet_fns(jmodel, v, dummy))
        try:
            jex._stream_step_fn(jmodel, v, SR)
            names.add("StreamStep")
        except TypeError:
            pass
        return dummy

    jax.eval_shape(probe, jax.ShapeDtypeStruct((1, SR // 4), jnp.float32))
    return names


# ------------------------------------------------------------------ inputs
def _wavs(kind, seed):
    rng = np.random.default_rng(seed)
    wav = torch.from_numpy((0.1 * rng.standard_normal((1, 5 * SR))).astype(np.float32))
    return (wav, wav.flip(-1).clone()) if _conditioned(kind) else (wav,)


def _leaves(tree):
    return [torch.as_tensor(t).double() for t in torch.utils._pytree.tree_leaves(tree)]


def _stream_equal(kind, model, program, seed):
    """StreamStep over N_CHUNKS chunks against the eager engine (the host
    int clock): every output and the final state within atol 1e-6."""
    engine = build_engine(model)
    step = program.module()
    rng = np.random.default_rng(seed)
    hop = model.encoder.hop_length
    enroll = torch.from_numpy((0.1 * rng.standard_normal((1, SR))).astype(np.float32))
    init_kw, dvec = {}, None
    if kind == "veve":
        init_kw = dict(enroll_feats=engine.embed(enroll))
    elif _conditioned(kind):
        dvec = engine.embed(enroll)
    st = engine.init_state(1, **init_kw)
    st_x = ex.stream_state(engine, **init_kw)
    for _ in range(N_CHUNKS):
        c = torch.from_numpy((0.1 * rng.standard_normal((1, 4 * hop))).astype(np.float32))
        if kind in ("tse", "veve"):
            y, st = engine.step(c, dvec, st)
            y_x, st_x = step(c, dvec, st_x) if dvec is not None else step(c, st_x)
        else:
            y, st = engine.step(c, st) if dvec is None else engine.step(c, st, dvec)
            y_x, st_x = step(c, st_x) if dvec is None else step(c, st_x, dvec)
        torch.testing.assert_close(y_x, y, atol=1e-6, rtol=0)
    for a, b in zip(_leaves(st_x), _leaves(st), strict=True):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    if kind == "tse":
        assert int(st_x["skim"]["frame_count"]) == N_CHUNKS * 4 > 2 * SKIM["seg_size"]


def _artifact_args(kind, model, name, wavs):
    """The eager module's inputs of each artifact."""
    if kind == "dss":
        feats = model._encode(wavs[0])
        return {"EncoderNet": wavs[:1], "MaskNet": (feats,),
                "decoderNet": (model.masker(feats),), "FullModel": wavs[:1]}[name]
    feats = model._encode(wavs[0])
    args = {"EncoderNet": wavs[:1], "decoderNet": (feats,), "FullModel": wavs,
            "SpeakerNet": wavs[1:]}
    if model.speaker_net is not None:
        args["MaskNet"] = (feats, model.inference_tse_embedding(wavs[1]).squeeze(-1))
    else:
        args["MaskNet"] = (feats,)
    return args[name]


def _eager(kind, model, name, args):
    if name == "EncoderNet":
        return model._encode(*args)
    if name == "decoderNet":
        return model._decode_multi(*args) if kind == "dss" else model._decode(*args)
    if name == "MaskNet":
        return model.masker(*args)
    if name == "SpeakerNet":
        return model.inference_tse_embedding(*args)
    return model.inference(*args)


# ---------------------------------------------------------------- the ops
def _lstm_args(time_major, hoisted=False, dtype=torch.float32):
    g = torch.Generator().manual_seed(3)
    B, T, C_, H = 3, 5, 4, 8
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)
    h0, c0, w_hh = r(B, H), r(B, H), r(H, 4 * H)
    if hoisted:
        return (r(T, B, 4 * H), h0, c0, w_hh, True)
    x = r(T, B, C_) if time_major else r(B, T, C_)
    return (x, h0, c0, r(C_, 4 * H), r(4 * H), w_hh, False, time_major)


def _tcn_args():
    g = torch.Generator().manual_seed(4)
    B, C_, Ch, T, k = 2, 4, 6, 9, 3
    shapes = [(Ch, C_), (Ch,), (Ch,), (1,), (Ch, k), (Ch,), (Ch,), (Ch,), (1,), (Ch, Ch),
              (Ch,), (Ch,), (Ch,), (1,), (C_, Ch), (C_,)]
    return (torch.randn(B, C_, T, generator=g),
            [torch.randn(s, generator=g) for s in shapes], 2)


OPS = {"lstm_scan_train_fp": (lk._fp_op, lambda: _lstm_args(False)),
       "lstm_scan_train_fp time_major": (lk._fp_op, lambda: _lstm_args(True)),
       "lstm_scan_train_tm": (lk._hoisted_op, lambda: _lstm_args(True, hoisted=True)),
       "tcn_block_train": (tk._tcn_op, _tcn_args)}


@pytest.mark.parametrize("name", list(OPS))
def test_ops_pass_opcheck_and_run_the_plain_version(name):
    """`torch.library.opcheck` (schema, fake tensors, the dispatcher) on the
    CPU, where the op's body is the plain version: the same output as
    calling it directly."""
    op, make = OPS[name]
    args = make()
    torch.library.opcheck(op, args)
    if op is tk._tcn_op:
        want = (tk.tcn_block_train_ref(args[0], *args[1], dilation=args[2]),)
        got = (op(*args),)
    else:
        want = (lk.lstm_scan_train_ref(*args)[:3] if op is lk._hoisted_op
                else lk.lstm_scan_train_fp_ref(*args[:7], args[7])[:3])
        got = op(*args)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert str(op).startswith("puresound_tpu_torch.")


# -------------------------------------------------------------- families
FAMILIES = ["ns", "tse", "dss", "veve", "unet"]


@pytest.fixture(scope="module", params=FAMILIES)
def exported(request, tmp_path_factory):
    """(kind, paths, eager model, JAX wrapper, its variables), each family
    exported once: NS / TSE / DSS through their CLI's export_model on a
    JAX-written checkpoint, the other two through export_program."""
    kind = request.param
    jmodel, _ = _models(kind)
    v = _variables(jmodel, kind, seed=len(kind))
    tmp = tmp_path_factory.mktemp(kind)
    if kind in CLIS:
        with pytest.MonkeyPatch.context() as mp:
            cli, hp, cfg = _port_cli(kind, tmp, mp)
            _JaxTrainer(v).save_ckpt(str(tmp / "epoch_0.ckpt"), 0, {"total_loss": 0.1})
            paths = cli.main(cli.parse_args([str(cfg), "--action", "export_model", "--ckpt",
                                             "epoch_0.ckpt", "--backend", "cpu"]))
            model = cli.load_eval_model(hp, "epoch_0.ckpt", "cpu")
    else:
        model = _models(kind)[1]
        model.load_state_dict(fj.from_jax(v), strict=True)
        paths = ex.export_program(model, SR, str(tmp), "m")
    return kind, paths, model, jmodel, v


def test_export_writes_jax_artifact_set_and_loads_equal_to_eager(exported):
    """The `.pt2` set is JAX's for the same wrapper; each artifact, loaded
    with torch.export.load, equals the eager module (StreamStep over
    carried chunks); the LSTM / TCN forwards are op nodes and no scan is
    unrolled (the plain scan's sigmoid gates never reach the graph)."""
    kind, paths, model, jmodel, v = exported
    names = {os.path.basename(p).split(".")[-2]: p for p in paths}
    assert set(names) == _jax_names(jmodel, v)
    assert all(p.endswith(".pt2") and os.path.basename(p).startswith(("epoch_0.ckpt.", "m."))
               for p in paths)
    wavs = _wavs(kind, seed=7)
    with torch.no_grad():
        for name in ("FullModel", "StreamStep"):
            if name not in names:
                continue
            program = torch.export.load(names[name])
            ops = ex.op_nodes(program)
            sigmoid = sum(str(n.target) == "aten.sigmoid.default"
                          for gm in program.graph_module.modules()
                          if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes)
            if name in ("FullModel", "MaskNet") and kind != "unet":
                assert ops.get("lstm_scan_train_fp", 0) > 0 and sigmoid == 0, (name, ops)
            if name in ("FullModel", "SpeakerNet") and kind == "tse":
                assert ops.get("tcn_block_train") == 1, (name, ops)
            if name == "StreamStep":
                _stream_equal(kind, model, program, seed=11)
                continue
            args = _artifact_args(kind, model, name, wavs)
            torch.testing.assert_close(program.module()(*args), _eager(kind, model, name, args),
                                       atol=1e-6, rtol=0)


def test_full_model_artifact_matches_jax_deserialized(exported):
    """The port's FullModel artifact (weights carried from the JAX
    checkpoint by from_jax) against JAX's FullModel exported, serialized and
    deserialized, on one seeded input, at JAX's own tolerance."""
    kind, paths, _, jmodel, v = exported
    method = JSiMo.inference if kind == "dss" else JWrap.inference
    full = lambda *a: jmodel.apply(v, *a, method=method)
    wavs = _wavs(kind, seed=9)
    dummy = tuple(jnp.zeros((1, 5 * SR)) for _ in wavs)
    restored = jexport.deserialize(jexport.export(jax.jit(full))(*dummy).serialize())
    want = np.asarray(restored.call(*[jnp.asarray(w.numpy()) for w in wavs]))
    path = next(p for p in paths if p.endswith(".FullModel.pt2"))
    with torch.no_grad():
        got = torch.export.load(path).module()(*wavs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


REFUSED = {"non-causal SkiM": lambda: SoTaskWrapModule(
               FreeEncDec(**TSE_ENC), SkiM(**dict(SKIM, causal=False)),
               [TCN(C, 16, 3, dilation=1, tcn_norm="gLN", dconv_norm="gGN"),
                AttentiveStatisticsPooling(C, 16), Conv1d(2 * C, E, 1, bias=False)],
               mask_constraint="ReLU").eval(),
           "non-causal UnetTcn": lambda: SoTaskWrapModule(
               ConvEncDec(**ENC), unet.UnetTcn(**dict(UNET_TCN, causal=False)),
               _models("unet")[1].speaker_net, mask_constraint="linear",
               drop_first_bin=True).eval(),
           "DPRNN, 5-frame segments": lambda: SoTaskWrapModule(
               FreeEncDec(win_length=VWIN, hop_length=VHOP, laten_length=VC,
                          output_active=True), DPRNN(**VEVE), None,
               embedding_free_tse=True, mask_constraint="ReLU").eval()}


@pytest.mark.parametrize("name", list(REFUSED))
def test_models_the_engines_refuse_get_no_stream_step(name):
    """The engines' build-time refusals (ValueError) leave StreamStep out;
    export_program prints the reason and exports the rest."""
    with torch.no_grad(), pytest.raises(ValueError):
        ex._stream_step(REFUSED[name](), SR)
