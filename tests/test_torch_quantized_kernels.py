"""The int8 and bf16-scratch serving options of the port's kernels, plain
versions on the CPU, against the JAX package.

- The quantizers (`SkiM._fused_weights(int8_hh / int8_full)`,
  `DPCRN._dp_kernel_weights(int8_hh)`) against JAX's: the int8 weights and
  the float32 scales bit for bit.
- One int8 product on the same int8 inputs (`dot_hh_ref` against JAX's
  `dot_hh`): bit for bit, since the integer sum is exact.
- `fused_skim_frames_ref` (int8_hh, int8_full), `dual_path_chunk_ref`
  (int8_hh, xscr_half, both), `center_chunk`'s plain version (int8_hh,
  xscr_half) and `dparn_center_chunk`'s (xscr_half) against the Pallas
  kernels in interpret mode. One call is held at atol 2e-5 / rtol 1e-2
  (the float32 sums differ in order by ~1e-6; an activation at an int8 or
  bf16 rounding boundary can round the other way, which moves a value by up
  to one bf16 step, 2^-8 relative). Carried chunks are held by an SNR of
  >= 50 dB, well above JAX's own quantization bars (int8_hh 20 dB,
  int8_full 15, DPCRN xscr_half 35, center int8_hh 30).

The CUDA kernels run only on the card (chip_smoke.py phase 2h)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet import skim as j_skim
from puresound_tpu.nnet.dparn import DPARN as JDPARN
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.ops.dual_path_kernel import dual_path_chunk as j_dual_path
from puresound_tpu.ops.dual_path_kernel import make_dots
from puresound_tpu.ops.skim_stream_kernel import fused_skim_frames as j_fused
from puresound_tpu_torch.nnet import skim as t_skim
from puresound_tpu_torch.nnet.dparn import DPARN
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.ops import dual_path_kernel as dpk
from puresound_tpu_torch.ops import skim_stream_kernel as ops
from puresound_tpu_torch.ops.quant import dot_hh_ref, quantize_cols
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ONE_ATOL, ONE_RTOL = 2e-5, 1e-2
SNR_BAR = 50.0


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _snr_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _flat(arrays):
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------- quantizers
SKIM_KW = dict(input_size=16, hidden_size=24, output_size=16, n_blocks=3,
               seg_size=8, seg_overlap=False, causal=True, embed_dim=8,
               embed_norm=True, embed_fusion="FiLM", block_with_embed=(1, 0, 1))


def _skim_pair(rng):
    jm = j_skim.SkiM(**SKIM_KW)
    v = jm.init(KEY, jnp.zeros((2, 16, 8)), jnp.ones((2, 8)))
    v = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float64) + 0.1 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), jax.device_get(v))
    tm = t_skim.SkiM(**SKIM_KW).eval()
    tm.load_state_dict(fj.to_torch(fj.skim(v["params"])), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("option", ["int8_hh", "int8_full"])
def test_skim_quantized_weights_bit_equal_to_jax(rng, option):
    jm, v, tm = _skim_pair(rng)
    kw = {option: True}
    want = jm.apply(v, method=lambda m: m._fused_weights(**kw))
    got = tm._fused_weights(**kw)
    assert len(got) == len(want)
    n_int8 = 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and str(g.dtype).endswith(str(w.dtype))
        if w.dtype == np.int8:
            n_int8 += 1
        np.testing.assert_array_equal(g.numpy(), w)
    # int8_hh: one w_hh a block; int8_full: w_ih, w_hh, proj_w and 2 FiLM dots
    assert n_int8 == (3 if option == "int8_hh" else 3 * 3 + 2 * 2)


def test_skim_quantized_weights_cached_per_option(rng):
    """Each option keeps its own tuple (and so its packed copies) until a
    parameter changes in place."""
    _, _, tm = _skim_pair(rng)
    a, b = tm._fused_weights(int8_hh=True), tm._fused_weights(int8_full=True)
    assert tm._fused_weights(int8_hh=True) is a and tm._fused_weights(int8_full=True) is b
    assert tm._fused_weights() is not a and len(b) > len(a) > len(tm._fused_weights())
    tm.seg_lstm[0].lstm.weight_hh_l0.add_(0.5)
    c = tm._fused_weights(int8_hh=True)
    assert c is not a and not torch.equal(c[5], a[5])


def _dpcrn_pair(rng, name="dpcrn"):
    jcls, pcls, conv, extra = CENTER_MODELS[name]
    jm = jcls(**UNET, **extra)
    v = jax.device_get(jm.init(KEY, jnp.zeros((B, C_IN, 4))))
    v = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float64)
                   + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    pm = pcls(**UNET, **extra).eval()
    pm.load_state_dict(fj.to_torch(conv(v["params"], v["batch_stats"])), strict=True)
    return jm, v, pm


def test_dpcrn_quantized_weights_bit_equal_to_jax(rng):
    jm, v, pm = _dpcrn_pair(rng)
    want = jm.apply(v, method=lambda m: m._dp_kernel_weights(int8_hh=True))
    got = pm._dp_kernel_weights(int8_hh=True)
    assert len(got) == len(want) == 2 * len(dpk.block_names(True)) == 42
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert pm._dp_kernel_weights(int8_hh=True) is got      # cached
    pm.dprnn_block1.inter_rnn.rnn.weight_hh_l0.mul_(0.5)
    assert pm._dp_kernel_weights(int8_hh=True) is not got  # rebuilt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_cols_bit_equal_to_jax(rng, dtype):
    """The quantizer in the weights' own dtype (bf16 serving quantizes bf16
    weights, as JAX does under half=True)."""
    w = (rng.standard_normal((40, 24)) * 0.3).astype(np.float32)
    w[:, 3] = 0.0                                            # col_max clipped at 1e-8
    jw = jnp.asarray(w, jnp.dtype(dtype))
    col_max = jnp.max(jnp.abs(jw), axis=0).clip(1e-8)
    want_q = jnp.clip(jnp.round(jw / col_max * 127.0), -127, 127).astype(jnp.int8)
    q, s = quantize_cols(torch.from_numpy(w).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(col_max, np.float32))


def test_dot_hh_bit_equal_to_jax(rng):
    """One int8 product on the same int8 weights and scales: the integer sum
    is exact on both sides, so the result is bit for bit JAX's; h values on
    the half-way points of the 1/127 grid round half to even."""
    h = np.tanh(rng.standard_normal((7, 64)) * 2).astype(np.float32)
    h[0, :8] = (np.arange(8) + 0.5) / 127.0                  # ties
    q, s = quantize_cols(torch.from_numpy((rng.standard_normal((64, 32)) * 0.2)
                                          .astype(np.float32)))
    _, j_dot_hh = make_dots(jnp.float32, int8_hh=True)
    want = j_dot_hh(jnp.asarray(h), jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    got = dot_hh_ref(torch.from_numpy(h), q.float(), s / (127.0 * 127.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ fused SkiM step
MODES = ("film", "", "film")
SB, SF, SC, SH = 8, 4, 16, 32


def _skim_weights(rng, option):
    """Random float weights in JAX's order, then JAX's and the port's
    quantization of them (bit-equal, tested above)."""
    def w(*shape, scale=None):
        s = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * s).astype(np.float32)
    full = option == "int8_full"
    jws, tws = [], []
    for m in MODES:
        raw = []
        if m == "film":
            raw += [("wsx", w(SC, SC)), ("wbx", w(SC, SC)), ("fg", 1 + w(SC, scale=0.1)),
                    ("fb", w(SC, scale=0.1))]
        raw += [("w_ih", w(SC, 4 * SH)), ("w_hh", w(SH, 4 * SH)), ("b", w(4 * SH, scale=0.1)),
                ("proj_w", w(SH, SC)), ("proj_b", w(SC, scale=0.1)),
                ("ln_g", 1 + w(SC, scale=0.1)), ("ln_b", w(SC, scale=0.1))]
        for name, a in raw:
            if name == "w_hh" or (full and name in ("wsx", "wbx", "w_ih", "proj_w")):
                q, s = quantize_cols(torch.from_numpy(a))
                jws += [jnp.asarray(q.numpy()), jnp.asarray(s.numpy())]
                tws += [q, s]
            else:
                jws.append(jnp.asarray(a))
                tws.append(torch.from_numpy(a))
    return tuple(jws), ops.SkimWeights(tws)


def _skim_inputs(rng, n_chunks):
    xs = [rng.standard_normal((SB, SF, SC)).astype(np.float32) for _ in range(n_chunks)]
    se = (rng.standard_normal((3, SB, SC)) * 0.3).astype(np.float32)
    be = (rng.standard_normal((3, SB, SC)) * 0.3).astype(np.float32)
    se[1] = be[1] = 0.0
    h0 = (rng.standard_normal((3, SB, SH)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((3, SB, SH)) * 0.3).astype(np.float32)
    return xs, se, be, h0, c0


def _skim_runs(rng, option, n_chunks, dot):
    jws, tws = _skim_weights(rng, option)
    xs, se, be, h, c = _skim_inputs(rng, n_chunks)
    kw = {option: True}
    jdot, tdot = (jnp.bfloat16, torch.bfloat16) if dot == "bf16" else (jnp.float32,
                                                                         torch.float32)
    jh, jc, th, tc = jnp.asarray(h), jnp.asarray(c), torch.from_numpy(h), torch.from_numpy(c)
    want, got = [], []
    for x in xs:
        jy, jh, jc = j_fused(jnp.asarray(x), jnp.asarray(se), jnp.asarray(be),
                             jnp.zeros((3, SB, 1)), jh, jc, jws, fusion_modes=MODES,
                             b_tile=SB, interpret=True, dot_dtype=jdot, **kw)
        ty, th, tc = ops.fused_skim_frames(
            torch.from_numpy(x), torch.from_numpy(se), torch.from_numpy(be),
            torch.zeros(3, SB, 1), th, tc, tws, MODES, dot_dtype=tdot, **kw)
        want.append(jy)
        got.append(ty)
    return _flat(got + [th, tc]), _flat(want + [jh, jc])


@pytest.mark.parametrize("dot", ["f32", "bf16"])
@pytest.mark.parametrize("option", ["int8_hh", "int8_full"])
def test_fused_skim_frames_int8_one_chunk(rng, option, dot):
    got, want = _skim_runs(rng, option, 1, dot)
    np.testing.assert_allclose(got, want, atol=ONE_ATOL, rtol=ONE_RTOL)


@pytest.mark.parametrize("option", ["int8_hh", "int8_full"])
def test_fused_skim_frames_int8_carried_chunks(rng, option):
    got, want = _skim_runs(rng, option, 6, "f32")
    assert np.isfinite(got).all()
    assert _snr_db(got, want) >= SNR_BAR


def test_fused_skim_frames_gate_still_raises(rng):
    """Gate fusion runs with the int8 options (tests/test_torch_gate_fusion.py);
    a weight tuple that does not hold a Gate block's ten arrays where the
    fusion modes put one still raises on both paths, with or without them."""
    xs, se, be, h, c = _skim_inputs(rng, 1)
    for option in ("int8_hh", "int8_full"):
        _, tws = _skim_weights(rng, option)
        for fn in (ops.fused_skim_frames, ops.fused_skim_frames_ref):
            with pytest.raises(ValueError, match="weight tuple has"):
                fn(*(torch.from_numpy(a) for a in (xs[0], se, be)),
                   torch.zeros(3, SB, 1), torch.from_numpy(h), torch.from_numpy(c),
                   tws, ("gate", "", "film"), **{option: True})


# --------------------------------------------------------- dual-path chunk
DF, DK, DB, DCH, DH = 6, 2, 3, 16, 8


def _dp_weights(rng, int8_hh):
    jws, tws = [], []
    for _ in range(2):
        for name in dpk.NAMES:
            shape = dpk._weight_shape(name, DCH, DH)
            scale = 1.0 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1
            w = rng.uniform(-1, 1, shape) * scale
            w = (1.0 + w if name in ("ig", "tg") else w).astype(np.float32)
            if int8_hh and name.startswith("w_hh"):
                q, s = quantize_cols(torch.from_numpy(w))
                jws += [jnp.asarray(q.numpy()), jnp.asarray(s.numpy())]
                tws += [q, s]
            else:
                jws.append(jnp.asarray(w))
                tws.append(torch.from_numpy(w))
    return tuple(jws), tws


def _dp_runs(rng, variant, n_chunks):
    kw = {k: True for k in variant.split("+")}
    jws, tws = _dp_weights(rng, kw.get("int8_hh", False))
    hs = [(0.3 * rng.standard_normal((DF, DB, DH))).astype(np.float32) for _ in range(2)]
    cs = [(0.3 * rng.standard_normal((DF, DB, DH))).astype(np.float32) for _ in range(2)]
    jh, jc = [jnp.asarray(a) for a in hs], [jnp.asarray(a) for a in cs]
    th, tc = [torch.from_numpy(a) for a in hs], [torch.from_numpy(a) for a in cs]
    got, want = [], []
    for _ in range(n_chunks):
        x = rng.standard_normal((DF, DK, DB, DCH)).astype(np.float32)
        jy, jh, jc = j_dual_path(jnp.asarray(x), jh, jc, jws, b_tile=DB, interpret=True,
                                 **kw)
        ty, th, tc = dpk.dual_path_chunk(torch.from_numpy(x), th, tc, tws, **kw)
        want.append(jy)
        got.append(ty)
    return _flat(got + th + tc), _flat(want + list(jh) + list(jc))


DP_VARIANTS = ["int8_hh", "xscr_half", "int8_hh+xscr_half"]


@pytest.mark.parametrize("variant", DP_VARIANTS)
def test_dual_path_chunk_variant_one_chunk(rng, variant):
    got, want = _dp_runs(rng, variant, 1)
    np.testing.assert_allclose(got, want, atol=ONE_ATOL, rtol=ONE_RTOL)


@pytest.mark.parametrize("variant", DP_VARIANTS)
def test_dual_path_chunk_variant_carried_chunks(rng, variant):
    got, want = _dp_runs(rng, variant, 5)
    assert np.isfinite(got).all()
    assert _snr_db(got, want) >= SNR_BAR


def test_dual_path_xscr_half_rounds_every_write(rng):
    """Under xscr_half y holds bf16 values even with float32 I/O, and the
    int8 weights keep their shapes in the kernel's checks."""
    _, tws = _dp_weights(rng, True)
    x = torch.from_numpy(rng.standard_normal((DF, DK, DB, DCH)).astype(np.float32))
    z = [torch.zeros(DF, DB, DH)] * 2
    y, _, _ = dpk.dual_path_chunk(x, z, z, tws, int8_hh=True, xscr_half=True)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, y.to(torch.bfloat16).float(), atol=0, rtol=0)
    dpk._check(x, z, z, tws, torch.float32, int8_hh=True)
    with pytest.raises(ValueError, match="36 weights"):
        dpk._check(x, z, z, tws, torch.float32, int8_hh=False)


# ----------------------------------------------------------- wide center
UNET = dict(input_type="RI", input_dim=128, norm_type="bN2d", dropout=0.0,
            channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2, transpose_delay=False,
            kernel_t=(2,) * 5, stride_t=(1,) * 5, dilation_t=(1,) * 5,
            kernel_f=(5, 3, 3, 3, 3), stride_f=(2, 2, 1, 1, 1), dilation_f=(1,) * 5,
            delay=(0,) * 5, rnn_hidden=16)
CENTER_MODELS = {"dpcrn": (JDPCRN, DPCRN, fj.dpcrn, {}),
                 "dparn": (JDPARN, DPARN, fj.dparn, {"nhead": 4})}
B, C_IN = 3, 128
CENTER_CASES = [("dpcrn", "int8_hh"), ("dpcrn", "xscr_half"), ("dparn", "xscr_half")]


def _random_state(pm, rng):
    st = pm.init_stream_state(B, mk_kernel=True)
    r = lambda t: torch.from_numpy((0.3 * rng.standard_normal(t.shape)).astype(np.float32))
    return {k: [r(t) for t in v] if isinstance(v, list) else r(v) for k, v in st.items()}


def _leaves(tree):
    return [_np(t) for t in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))]


@pytest.mark.parametrize("name,option", CENTER_CASES)
def test_center_kernel_chunk_option_one_call(rng, name, option):
    """One wide-center call from a random carried state (a u0h carry off
    the bf16 grid included): y and every carry against the Pallas kernel."""
    jm, v, pm = _dpcrn_pair(rng, name)
    st = _random_state(pm, rng)
    x = rng.standard_normal((B, 8, 16, 2)).astype(np.float32)
    jst = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), st,
                                 is_leaf=lambda t: isinstance(t, torch.Tensor))
    kw = {option: True}
    want = jm.apply(v, jnp.asarray(x), jst,
                    method=lambda m, a, s: m.center_kernel_chunk(a, s, **kw))
    got = pm.center_kernel_chunk(torch.from_numpy(x), st, **kw)
    for g, w in zip(_leaves(list(got)), _leaves(list(want))):
        np.testing.assert_allclose(g, w, atol=ONE_ATOL, rtol=ONE_RTOL)


@pytest.mark.parametrize("name,option", CENTER_CASES)
def test_stream_frames_mk_kernel_option_carried(rng, name, option):
    """stream_frames(mk_kernel=True, option) over 5 carried chunks against
    JAX's route (SNR over the masks and the final carries)."""
    jm, v, pm = _dpcrn_pair(rng, name)
    kw = {option: True}
    s = pm.init_stream_state(B, mk_kernel=True)
    js = jm.apply(v, B, jnp.float32, False, True,
                  method=lambda m, *a: m.init_stream_state(*a))
    step = jax.jit(lambda a, st: jm.apply(
        v, a, st, method=lambda m, a, st: m.stream_frames(a, st, mk_kernel=True, **kw)))
    got, want = [], []
    for _ in range(5):
        x = rng.standard_normal((B, C_IN, 2)).astype(np.float32)
        w, js = step(jnp.asarray(x), js)
        g, s = pm.stream_frames(torch.from_numpy(x), s, mk_kernel=True, **kw)
        got.append(g)
        want.append(w)
    keys = ("dc", "u0h", "u0s", "u1h", "u2h", "h1", "c1", "h2", "c2")
    got = _flat(got + [a for k in keys for a in _leaves(s[k])])
    want = _flat(want + [a for k in keys for a in _leaves(js[k])])
    assert np.isfinite(got).all()
    assert _snr_db(got, want) >= SNR_BAR


def test_dparn_int8_hh_still_raises(rng):
    """JAX asserts that the DPARN wide center has no int8_hh
    (puresound_tpu/nnet/dparn.py:181); the port keeps the ValueError."""
    _, _, pm = _dpcrn_pair(rng, "dparn")
    st = pm.init_stream_state(B, mk_kernel=True)
    with pytest.raises(ValueError, match="int8_hh"):
        pm.stream_frames(torch.zeros(B, C_IN, 2), st, mk_kernel=True, int8_hh=True)


# ------------------------------------------------- the kernels' packed layouts
def _unpack_words(words, K, N):
    """pack_int8's inverse: [K/4, N] int32 words -> the int8 [K, N] matrix."""
    return words.reshape(K // 4, N).contiguous().view(torch.int8).reshape(
        K // 4, N, 4).permute(0, 2, 1).reshape(K, N)


@pytest.mark.parametrize("option", ["int8_hh", "int8_full"])
def test_skim_int8_pack_layout(rng, option):
    """The buffers csrc/skim_stream.cu indexes: per block wsx wbx w_ih w_hh
    proj_w as __dp4a words in w_q, their scales (divided as the products
    take them) in w_s, zeros in the float buffer where a matrix is int8."""
    _, tws = _skim_weights(rng, option)
    kw = dict(int8_hh=True, int8_full=option == "int8_full")
    w_mat, w_vec, w_q, w_s = ops._pack(tws, MODES, SC, SH, torch.float32, "cpu", **kw)
    shapes = [("wsx", SC, SC), ("wbx", SC, SC), ("w_ih", SC, 4 * SH), ("w_hh", SH, 4 * SH),
              ("proj_w", SH, SC)]
    q_off = s_off = m_off = 0
    for mode, blk in zip(MODES, ops._unpack(tws, MODES, **kw)):
        for name, K, N in shapes:
            words = w_q[q_off:q_off + K * N // 4]
            if name + "_s" in blk:
                torch.testing.assert_close(_unpack_words(words, K, N), blk[name],
                                           atol=0, rtol=0)
                torch.testing.assert_close(w_s[s_off:s_off + N],
                                           ops.dequant_scale(name, blk[name + "_s"]))
                assert not w_mat[m_off:m_off + K * N].any()
            else:
                assert not words.any() and not w_s[s_off:s_off + N].any()
                want = blk.get(name, torch.zeros(K, N))
                torch.testing.assert_close(w_mat[m_off:m_off + K * N], want.reshape(-1))
            q_off, s_off, m_off = q_off + K * N // 4, s_off + N, m_off + K * N
    assert (q_off, s_off, m_off) == (w_q.numel(), w_s.numel(), w_mat.numel())
    assert w_vec.numel() == 3 * (2 * SC + 4 * SH + 3 * SC)


def test_dual_path_int8_kernel_operands(rng):
    """dual_path.cu's operands under int8_hh: 18 tensors a block with each
    w_hh as __dp4a words, and the three scales / 127^2 a block."""
    _, tws = _dp_weights(rng, True)
    mats, scales = dpk.kernel_weights(tws, True)
    names = dpk.block_names(True)
    assert len(mats) == 2 * dpk.PER_BLOCK and len(scales) == 6
    w = [dict(zip(names, tws[b * len(names):(b + 1) * len(names)])) for b in range(2)]
    for b in range(2):
        for i, d in enumerate("fbi"):
            k = dpk.NAMES.index("w_hh_" + d)
            m = mats[b * dpk.PER_BLOCK + k]
            assert m.dtype == torch.int32 and m.shape == (DH // 4, 4 * DH)
            torch.testing.assert_close(_unpack_words(m, DH, 4 * DH), w[b]["w_hh_" + d],
                                       atol=0, rtol=0)
            torch.testing.assert_close(scales[3 * b + i], w[b]["s_hh_" + d] / (127.0 * 127.0))
    assert all(m.dtype == torch.float32 for j, m in enumerate(mats)
               if not dpk.NAMES[j % dpk.PER_BLOCK].startswith("w_hh"))


def test_launch_counts_by_option():
    """LAUNCHES_BY_OPTION's keys: the options that are on, joined by '+'
    in the order given ("" for none)."""
    from puresound_tpu_torch.ops.quant import option_key

    assert option_key(int8_hh=True, xscr_half=True) == "int8_hh+xscr_half"
    assert option_key(int8_hh=False, xscr_half=True) == "xscr_half"
    assert option_key(int8_hh=False, int8_full=False) == ""


def test_dp4a_rate_probe_needs_a_card():
    """The dp4a issue-rate probe runs only on a card: a CPU buffer (or a
    bad size) raises before anything is built or launched."""
    with pytest.raises(ValueError, match="on a card"):
        ops.dp4a_rate(torch.zeros(256, dtype=torch.int32), 8)
