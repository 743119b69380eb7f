"""Port parity, Gate-conditioned SkiM (`embed_fusion="Gate"`):

- `ChanLN` (cLN) and `Gate` against the JAX layers in float64 (atol 1e-8 /
  rtol 1e-6), also with dropout in eval mode and at rate 0 in training
  mode, and the Gate's dropout drawn from its own generator, its masks
  on the input's device (`nnet/lobe/dropout.py`'s `Dropout`);
- `SkiM(embed_fusion="Gate")` offline, `step_frames` and the fused step's
  plain route against JAX's SkiM in float64, with every block a Gate and
  with the mixed pattern (1, 0, 1); `from_jax` on it;
- `fused_skim_frames_ref` with Gate blocks (float32; int8_hh / int8_full;
  bf16 dots) against the JAX Pallas kernel in interpret mode on the same
  seed-made inputs, at JAX's own bar for the float route (atol 2e-5 / rtol
  1e-4; tests/test_pallas_kernels.py:49-78) and the quantized tests' bar
  for the int8 routes (atol 2e-5 / rtol 1e-2, one call);
- the Gate model through `StreamingTSE` (against JAX's engine, and streamed
  == offline) and `make_session_server` on the CPU;
- the flagship's configuration with Gate fusion: the parameter count of
  the JAX model of the same configuration.

The CUDA kernel's Gate branch runs only on the card (chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet import skim as j_skim
from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.norm import ChanLN as JChanLN
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.lobe.trivial import Gate as JGate
from puresound_tpu.ops.skim_stream_kernel import fused_skim_frames as j_fused
from puresound_tpu.streaming.engine import StreamingTSE as JEngine
from puresound_tpu.zoo.tse import _tcn_speaker_net as j_tcn_speaker_net
from puresound_tpu_torch.nnet import skim as t_skim
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.norm import ChanLN, get_norm
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.lobe.trivial import Gate
from puresound_tpu_torch.ops import skim_stream_kernel as ops
from puresound_tpu_torch.ops.quant import quantize_cols
from puresound_tpu_torch.streaming.deploy import make_session_server
from puresound_tpu_torch.streaming.engine import (StreamingTSE,
                                                  offline_equivalent_input)
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.utils.tree import tree_leaves
from puresound_tpu_torch.zoo.tse import _tcn_speaker_net

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
PATTERNS = {"all_gate": (1, 1, 1), "mixed": (1, 0, 1)}
SKIM_KW = dict(input_size=16, hidden_size=24, output_size=16, n_blocks=3,
               seg_size=8, seg_overlap=False, causal=True, embed_dim=8,
               embed_norm=True, embed_fusion="Gate")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _perturbed_f64(tree, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) + scale * rng.standard_normal(np.shape(a)),
        jax.device_get(tree))


# ---------------------------------------------------------------- the layers
@pytest.mark.parametrize("shape", [(3, 12, 7), (2, 6, 5, 4)])
def test_chan_ln_matches_jax(rng, shape):
    x = rng.standard_normal(shape) * 2.0 + 0.5
    jm = JChanLN(shape[1])
    v = _perturbed_f64(jm.init(KEY, jnp.zeros(shape)), rng)
    with jax.enable_x64(True):
        want = jm.apply(v, jnp.asarray(x))
    tm = get_norm("cLN")(shape[1], dtype=torch.float64)
    assert isinstance(tm, ChanLN)
    tm.load_state_dict(fj.to_torch(fj.norm(v["params"], kind="gLN")))
    _close(tm(torch.from_numpy(x)).detach().numpy(), want)


@pytest.mark.parametrize("sizes", [(16, 12, 8), (24, 32, 6)])
def test_gate_matches_jax(rng, sizes):
    C, Hd, E = sizes
    x, cond = rng.standard_normal((2, C, 9)), rng.standard_normal((2, E))
    jm = JGate(C, Hd, E)
    v = _perturbed_f64(jm.init(KEY, jnp.zeros((2, C, 9)), jnp.zeros((2, E))), rng)
    with jax.enable_x64(True):
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(cond))
    tm = Gate(C, Hd, E, dtype=torch.float64).eval()
    tm.load_state_dict(fj.to_torch(fj.gate(v["params"])), strict=True)
    _close(tm(torch.from_numpy(x), torch.from_numpy(cond)).detach().numpy(), want)


@pytest.mark.parametrize("dropout,train", [(0.3, False), (0.0, True)],
                         ids=["eval mode", "rate 0 in training"])
def test_gate_with_dropout_matches_jax(rng, dropout, train):
    C, Hd, E = 16, 12, 8
    x, cond = rng.standard_normal((2, C, 9)), rng.standard_normal((2, E))
    jm = JGate(C, Hd, E, dropout=dropout)
    v = _perturbed_f64(jm.init(KEY, jnp.zeros((2, C, 9)), jnp.zeros((2, E))), rng)
    with jax.enable_x64(True):
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(cond), train=train,
                        rngs={"dropout": KEY})
    tm = Gate(C, Hd, E, dropout=dropout, dtype=torch.float64).train(train)
    tm.load_state_dict(fj.to_torch(fj.gate(v["params"])), strict=True)
    _close(tm(torch.from_numpy(x), torch.from_numpy(cond)).detach().numpy(), want)


def test_gate_dropout_draws_its_masks_on_the_inputs_device(rng, monkeypatch):
    """Each of the Gate's two masks comes from a generator of the input's
    device, and is made there (never on the CPU and copied)."""
    from puresound_tpu_torch.nnet.lobe.dropout import Dropout

    seen, rand = [], torch.rand

    def recording_rand(*shape, generator=None, device=None, **kw):
        seen.append((generator.device, torch.device(device)))
        return rand(*shape, generator=generator, device=device, **kw)

    m = Gate(8, 16, 4, dropout=0.5, dtype=torch.float64,
             generator=torch.Generator().manual_seed(0)).train()
    assert isinstance(m.drop, Dropout) and m.drop.generator is m.generator
    x, cond = (torch.from_numpy(rng.standard_normal(s)) for s in ((2, 8, 20), (2, 4)))
    monkeypatch.setattr(torch, "rand", recording_rand)
    m(x, cond)
    assert seen == [(x.device, x.device)] * 2
    assert set(m.drop._masks) == {x.device}


def test_gate_dropout_draws_from_its_generator(rng):
    """Training-mode dropout: the same seed gives the same mask, another
    seed another one, the global RNG is left alone; eval mode has none."""
    x, cond = (torch.from_numpy(rng.standard_normal(s)) for s in ((2, 8, 20), (2, 4)))

    def run(seed, train=True):
        g = torch.Generator().manual_seed(seed)
        m = Gate(8, 16, 4, dropout=0.5, dtype=torch.float64, generator=g)
        m.generator.manual_seed(99 + seed)
        return m.train(train)(x, cond)

    state = torch.get_rng_state()
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(0)
    m = Gate(8, 16, 4, dropout=0.5, dtype=torch.float64, generator=g).eval()
    m0 = Gate(8, 16, 4, dtype=torch.float64,
              generator=torch.Generator().manual_seed(0)).eval()
    assert torch.equal(m(x, cond), m0(x, cond))


# ---------------------------------------------------------------- the module
@pytest.fixture(params=list(PATTERNS))
def skims(request, rng):
    """(JAX SkiM, its f64 variables, the port's f64 SkiM with them)."""
    blocks = PATTERNS[request.param]
    jm = j_skim.SkiM(**SKIM_KW, block_with_embed=blocks)
    v = _perturbed_f64(jm.init(KEY, jnp.zeros((2, 16, 8)), jnp.ones((2, 8))), rng)
    tm = t_skim.SkiM(**SKIM_KW, block_with_embed=blocks, dtype=torch.float64)
    tm.load_state_dict(fj.to_torch(fj.skim(v["params"])), strict=True)
    return jm, v, tm.eval()


@pytest.mark.parametrize("T", [29, 32])
def test_skim_gate_offline_matches_jax(skims, rng, T):
    jm, v, tm = skims
    x, e = rng.standard_normal((2, 16, T)), rng.standard_normal((2, 8))
    with jax.enable_x64(True):
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(e))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(e))
    _close(got.numpy(), want)


@pytest.mark.parametrize("route", ["step_frames", "step_frames_fused"])
def test_skim_gate_streaming_matches_jax_step_frames(skims, rng, route):
    """4-frame chunks over three segments, state by state. The fused step's
    plain route uses the kernel's two-pass LayerNorms where JAX's
    step_frames uses cLN's single-pass one: in float64 they agree far below
    the bar."""
    jm, v, tm = skims
    B = 3
    frames = rng.standard_normal((B, 24, 16))
    e = rng.standard_normal((B, 8))
    state = tm.init_state(B, torch.float64)
    with jax.enable_x64(True):
        jstate = jm.apply(v, B, jnp.float64, method=j_skim.SkiM.init_state)
        for k in range(6):
            chunk = frames[:, 4 * k:4 * k + 4]
            want, jstate = jm.apply(v, jnp.asarray(chunk), jnp.asarray(e), jstate,
                                    method=j_skim.SkiM.step_frames)
            with torch.no_grad():
                got, state = getattr(tm, route)(torch.from_numpy(chunk),
                                                torch.from_numpy(e), state)
            _close(got.numpy(), want)
    assert state["frame_count"] == int(jstate["frame_count"])
    for key in ("seg_h", "seg_c", "mem_h", "mem_c"):
        for g, w in zip(tree_leaves(state[key]),
                        jax.tree_util.tree_leaves(jstate[key])):
            _close(g.numpy(), w)


def test_skim_gate_fused_weights_and_embed_terms_match_jax(skims, rng):
    """The kernel's flat weights (ten Gate arrays a Gate block, in JAX's
    order) and the frame-invariant terms se / be / ge."""
    jm, v, tm = skims
    e = rng.standard_normal((3, 8))
    with jax.enable_x64(True):
        want_w = jm.apply(v, method=lambda m: m._fused_weights())
        want_t = jm.apply(v, jnp.asarray(e), 3, jnp.float64,
                          method=lambda m, *a: m._embed_terms(*a))
    got_w = tm._fused_weights()
    assert len(got_w) == len(want_w)
    for g, w in zip(got_w, want_w):
        _close(g.detach().numpy().reshape(np.shape(w)), w)
    got_t = tm._embed_terms(torch.from_numpy(e), 3, torch.float64, got_w)
    for g, w in zip(got_t, want_t):
        assert tuple(g.shape) == np.shape(w)
        _close(g.numpy(), w)


def test_from_jax_gate_skim_names(skims):
    """Every JAX Gate leaf lands on a port parameter, none left over."""
    _, v, tm = skims
    sd = fj.skim(v["params"])
    assert set(sd) == set(tm.state_dict())
    assert any(k.endswith("left_conv.1.gamma") for k in sd)
    n_leaves = len(jax.tree_util.tree_leaves(v["params"]))
    assert len(sd) == n_leaves


def test_skim_gate_weight_cache_follows_the_gate(skims):
    """A change to a Gate parameter alone rebuilds the kernel's weights."""
    _, _, tm = skims
    a = tm._fused_weights()
    assert tm._fused_weights() is a
    with torch.no_grad():
        tm.seg_input_fusion[0].right_conv[0].weight.add_(0.25)
    b = tm._fused_weights()
    assert b is not a and not torch.equal(b.gate_embed_w, a.gate_embed_w)


# ---------------------------------------------------------- the kernel's plain
GB, GF, GC, GH, GHG = 8, 4, 16, 24, 12
KERNEL_MODES = {"gate_blank_gate": ("gate", "", "gate"),
                "gate_film_blank": ("gate", "film", "")}


def _gate_kernel_case(rng, modes, option, n_chunks):
    """Seed-made float weights in JAX's flat order (quantized by the same
    `quantize_cols` for both sides), inputs and embed terms."""
    def w(*shape, scale=None):
        s = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * s).astype(np.float32)
    quantized = {"int8_hh": ("w_hh",),
                 "int8_full": ("w_hh", "wsx", "wbx", "w_ih", "proj_w")}.get(option, ())
    jws, tws = [], []
    for m in modes:
        raw = []
        if m == "film":
            raw += [("wsx", w(GC, GC)), ("wbx", w(GC, GC)),
                    ("fg", 1 + w(GC, scale=0.1)), ("fb", w(GC, scale=0.1))]
        elif m == "gate":
            raw += [("g_win", w(GC, GHG)), ("g_wl", w(GHG, GHG)),
                    ("g_lg", 1 + w(GHG, scale=0.1)), ("g_lb", w(GHG, scale=0.1)),
                    ("g_la", 0.25 + w(1, scale=0.05)), ("g_wrx", w(GHG, GHG)),
                    ("g_rg", 1 + w(GHG, scale=0.1)), ("g_rb", w(GHG, scale=0.1)),
                    ("g_ra", 0.25 + w(1, scale=0.05)), ("g_wout", w(GHG, GC))]
        raw += [("w_ih", w(GC, 4 * GH)), ("w_hh", w(GH, 4 * GH)),
                ("b", w(4 * GH, scale=0.1)), ("proj_w", w(GH, GC)),
                ("proj_b", w(GC, scale=0.1)), ("ln_g", 1 + w(GC, scale=0.1)),
                ("ln_b", w(GC, scale=0.1))]
        for name, a in raw:
            if name in quantized:
                q, s = quantize_cols(torch.from_numpy(a))
                jws += [jnp.asarray(q.numpy()), jnp.asarray(s.numpy())]
                tws += [q, s]
            else:
                jws.append(jnp.asarray(a))
                tws.append(torch.from_numpy(a))
    n = len(modes)
    xs = [rng.standard_normal((GB, GF, GC)).astype(np.float32) for _ in range(n_chunks)]
    terms = {}
    for name, width, kind in (("se", GC, "film"), ("be", GC, "film"), ("ge", GHG, "gate")):
        t = (rng.standard_normal((n, GB, width)) * 0.3).astype(np.float32)
        t[[i for i, m in enumerate(modes) if m != kind]] = 0.0
        terms[name] = t
    h0 = (rng.standard_normal((n, GB, GH)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((n, GB, GH)) * 0.3).astype(np.float32)
    return tuple(jws), ops.SkimWeights(tws), xs, terms, h0, c0


def _gate_kernel_runs(rng, modes, option, n_chunks, dot="f32"):
    jws, tws, xs, terms, h, c = _gate_kernel_case(rng, modes, option, n_chunks)
    kw = {option: True} if option else {}
    jdot, tdot = ((jnp.bfloat16, torch.bfloat16) if dot == "bf16"
                  else (jnp.float32, torch.float32))
    jt = [jnp.asarray(terms[k]) for k in ("se", "be", "ge")]
    tt = [torch.from_numpy(terms[k]) for k in ("se", "be", "ge")]
    jh, jc, th, tc = jnp.asarray(h), jnp.asarray(c), torch.from_numpy(h), torch.from_numpy(c)
    want, got = [], []
    for x in xs:
        jy, jh, jc = j_fused(jnp.asarray(x), *jt, jh, jc, jws, fusion_modes=modes,
                             b_tile=GB, interpret=True, dot_dtype=jdot, **kw)
        with torch.no_grad():
            ty, th, tc = ops.fused_skim_frames(torch.from_numpy(x), *tt, th, tc, tws,
                                               modes, dot_dtype=tdot, **kw)
        want.append(jy)
        got.append(ty)
    flat = lambda arrs: np.concatenate([np.asarray(a, np.float32).ravel() for a in arrs])
    return flat(got + [th, tc]), flat(want + [jh, jc])


@pytest.mark.parametrize("modes", list(KERNEL_MODES))
def test_gate_pack_layout(rng, modes):
    """The Gate buffers csrc/skim_stream.cu indexes: per block win wl wrx
    wout in the dot dtype, then lg lb rg rb la ra in float32, zeros for a
    block that is not a Gate; the other buffers as without a Gate."""
    modes = KERNEL_MODES[modes]
    _, tws, *_ = _gate_kernel_case(rng, modes, "", 1)
    g_mat, g_vec, Hg = ops._pack_gate(tws, modes, GC, torch.bfloat16, "cpu", False, False)
    assert Hg == GHG and g_mat.dtype == torch.bfloat16 and g_vec.dtype == torch.float32
    mat_shapes = {"g_win": (GC, GHG), "g_wl": (GHG, GHG), "g_wrx": (GHG, GHG),
                  "g_wout": (GHG, GC)}
    vec_shapes = {"g_lg": (GHG,), "g_lb": (GHG,), "g_rg": (GHG,), "g_rb": (GHG,),
                  "g_la": (1,), "g_ra": (1,)}
    mats, vecs = [], []
    for mode, blk in zip(modes, ops._unpack(tws, modes)):
        for shapes, out in ((mat_shapes, mats), (vec_shapes, vecs)):
            for name, shape in shapes.items():
                out.append(blk[name] if mode == "gate" else torch.zeros(shape))
    flat = lambda ts: torch.cat([t.reshape(-1) for t in ts])
    assert torch.equal(g_mat, flat(mats).to(torch.bfloat16))
    assert torch.equal(g_vec, flat(vecs))
    assert ops._pack_gate(tws[:0], (), GC, torch.float32, "cpu", False, False) == (
        None, None, 0)


@pytest.mark.parametrize("modes", list(KERNEL_MODES))
def test_fused_gate_plain_matches_pallas_f32(rng, modes):
    """4 carried chunks, float32 dots: JAX's Gate-kernel bar."""
    got, want = _gate_kernel_runs(rng, KERNEL_MODES[modes], "", 4)
    _close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("option", ["int8_hh", "int8_full"])
@pytest.mark.parametrize("modes", list(KERNEL_MODES))
def test_fused_gate_plain_matches_pallas_int8(rng, modes, option):
    """The Gate's products stay float; the LSTM / projection ones int8."""
    got, want = _gate_kernel_runs(rng, KERNEL_MODES[modes], option, 1)
    _close(got, want, atol=2e-5, rtol=1e-2)


def test_fused_gate_plain_matches_pallas_bf16_dots(rng):
    """bf16 dot operands summed in float32 on both sides: the sums run in
    another order, so the bar is an SNR, as for the FiLM kernel (>= 100 dB)."""
    got, want = _gate_kernel_runs(rng, ("gate", "", "gate"), "", 4, dot="bf16")
    snr = 10 * np.log10(np.sum(want.astype(np.float64) ** 2)
                        / max(np.sum((got.astype(np.float64) - want) ** 2), 1e-30))
    assert np.isfinite(got).all() and snr >= 100.0, snr


# ---------------------------------------------------------------- the model
WIN, HOP, C, E = 32, 16, 24, 8
ENC = dict(win_length=WIN, hop_length=HOP, laten_length=C, output_active=True)
MODEL_SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2,
                  seg_size=10, seg_overlap=False, causal=True, embed_dim=E,
                  embed_norm=True, embed_fusion="Gate", block_with_embed=(1, 1))


def _port_model(dtype=torch.float64):
    fk = dict(dtype=dtype)
    spk = ([TCN(C, 16, 3, dilation=d, tcn_norm="gLN", dconv_norm="gGN", **fk)
            for d in (1, 2)]
           + [AttentiveStatisticsPooling(C, 16, **fk),
              Conv1d(2 * C, E, 1, bias=False, **fk)])
    return SoTaskWrapModule(FreeEncDec(**ENC, **fk), t_skim.SkiM(**MODEL_SKIM, **fk),
                            spk, mask_constraint="ReLU").eval()


@pytest.fixture
def model_pair(rng):
    """(JAX wrapper, JAX engine, f64 variables, port wrapper with them)."""
    spk = tuple([JTCN(C, 16, 3, dilation=d, causal=False, tcn_norm="gLN",
                      dconv_norm="gGN") for d in (1, 2)]
                + [JASP(C, 16), JConv(2 * C, E, 1, use_bias=False)])
    enc, masker = JEnc(**ENC), j_skim.SkiM(**MODEL_SKIM)
    jwrap = JWrap(encoder=enc, masker=masker, speaker_net=spk, mask_constraint="ReLU")
    jeng = JEngine(encoder=enc, masker=masker, speaker_net=spk, mask_constraint="ReLU")
    v = jwrap.init(KEY, jnp.zeros((1, 320)), jnp.zeros((1, 800)),
                   method=JWrap.inference)
    v = _perturbed_f64(v, rng, 0.05)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = _port_model()
    model.load_state_dict(fj.from_jax(v), strict=True)
    return jwrap, jeng, v, model


def test_gate_model_offline_inference_matches_jax(model_pair, rng):
    jwrap, _, v, model = model_pair
    x, enroll = rng.standard_normal((2, 400)) * 0.3, rng.standard_normal((2, 800)) * 0.3
    with jax.enable_x64(True):
        want = jwrap.apply(v, jnp.asarray(x), jnp.asarray(enroll), method=JWrap.inference)
    with torch.no_grad():
        got = model.inference(torch.from_numpy(x), torch.from_numpy(enroll))
    _close(got.numpy(), want)


@pytest.mark.parametrize("fused", [False, True])
def test_gate_model_streaming_step_matches_jax(model_pair, rng, fused):
    """StreamingTSE.step, unfused (SkiM.step_frames) and fused (the kernel's
    plain route), chunk by chunk against JAX's engine: 5 chunks of 5 frames
    over two segment boundaries."""
    _, jeng, v, model = model_pair
    engine = StreamingTSE.from_offline(model)
    B, S = 2, 5 * HOP
    x, enroll = rng.standard_normal((B, 5 * S)) * 0.3, rng.standard_normal((B, 800)) * 0.3
    with torch.no_grad():
        dvec = engine.embed(torch.from_numpy(enroll))
        state = engine.init_state(B, torch.float64)
    with jax.enable_x64(True):
        jdvec = jeng.apply(v, jnp.asarray(enroll), method=JEngine.embed)
        jstate = jeng.apply(v, B, jnp.float64, method=JEngine.init_state)
        for k in range(5):
            chunk = x[:, k * S:(k + 1) * S]
            want, jstate = jeng.apply(v, jnp.asarray(chunk), jdvec, jstate,
                                      method=JEngine.step)
            with torch.no_grad():
                got, state = engine.step(torch.from_numpy(chunk), dvec, state,
                                         fused=fused)
            _close(got.numpy(), want)


@pytest.mark.parametrize("fused", [False, True])
def test_gate_model_streamed_equals_offline(model_pair, rng, fused):
    _, _, _, model = model_pair
    engine = StreamingTSE.from_offline(model)
    L = HOP * 40
    x = torch.from_numpy(rng.standard_normal((2, L)) * 0.3)
    enroll = torch.from_numpy(rng.standard_normal((2, 800)) * 0.3)
    with torch.no_grad():
        offline = model.inference(offline_equivalent_input(x, WIN, HOP), enroll)
        dvec = engine.embed(enroll)
        state = engine.init_state(2, torch.float64)
        outs = []
        for i in range(0, L, 5 * HOP):
            y, state = engine.step(x[:, i:i + 5 * HOP], dvec, state, fused=fused)
            outs.append(y)
    streamed = torch.cat(outs, -1)
    _close(streamed.numpy(), offline[:, :streamed.shape[-1]].numpy())


@pytest.mark.parametrize("half", [False, True])
def test_gate_model_session_server_on_cpu(rng, half):
    """make_session_server(fused=True) on the CPU: each session's output
    equals a bare engine fed the same audio (float32), or is finite (bf16
    weights, state and dots); CPU tensors launch no kernel."""
    from puresound_tpu_torch.src import native

    native.load()
    model = _port_model(torch.float32)          # 10 ms chunks: one segment
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    before = ops.LAUNCHES
    bundle = make_session_server(model, None, n_slots=2, chunk_ms=10.0,
                                 enroll_len=400, half=half, fused=True)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    audio = [rng.standard_normal(4 * chunk).astype(np.float32) * 0.3 for _ in range(2)]
    enroll = [rng.standard_normal(400).astype(np.float32) * 0.3 for _ in range(2)]
    sids = [server.attach(enroll=e) for e in enroll]
    outs = [[], []]
    for k in range(4):
        for sid, a in zip(sids, audio):
            server.hub.push_input(sid, a[k * chunk:(k + 1) * chunk])
        assert server.tick() == 2
        for o, sid in zip(outs, sids):
            got = server.hub.pop_output(sid, chunk)
            assert len(got) == chunk and np.isfinite(got).all()
            o.append(got)
    assert ops.LAUNCHES == before
    if half:
        return
    for a, e, o in zip(audio, enroll, outs):
        with torch.no_grad():
            d = engine.embed(torch.from_numpy(e)[None])
            st = engine.init_state(1)
            solo = []
            for k in range(4):
                y, st = engine.step(torch.from_numpy(a[None, k * chunk:(k + 1) * chunk]),
                                    d, st, fused=True)
                solo.append(y[0].numpy())
        np.testing.assert_allclose(np.concatenate(o), np.concatenate(solo), atol=1e-5)


def test_gate_flagship_parameter_count():
    """The flagship's configuration with embed_fusion="Gate" (no zoo name
    builds it, in either package): the port's count equals the JAX model's."""
    skim = dict(input_size=128, hidden_size=256, output_size=128, n_blocks=4,
                seg_size=150, seg_overlap=False, causal=True, embed_dim=192,
                embed_norm=True, block_with_embed=(1, 1, 1, 1), embed_fusion="Gate")
    enc = dict(win_length=32, hop_length=16, laten_length=128, output_active=True)
    jwrap = JWrap(encoder=JEnc(**enc), masker=j_skim.SkiM(**skim),
                  speaker_net=j_tcn_speaker_net(128), mask_constraint="ReLU")
    shapes = jax.eval_shape(lambda: jwrap.init(KEY, jnp.zeros((1, 320)),
                                               jnp.zeros((1, 800)),
                                               method=JWrap.inference))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    fk = dict(device="meta", dtype=torch.float32)
    model = SoTaskWrapModule(FreeEncDec(**enc, **fk), t_skim.SkiM(**skim, **fk),
                             _tcn_speaker_net(128, **fk), mask_constraint="ReLU")
    assert sum(p.numel() for p in model.parameters()) == want
