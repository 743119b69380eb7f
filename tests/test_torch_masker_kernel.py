"""The wide-center masker kernels' plain versions against the JAX package, at
the small geometry of JAX's own center-kernel tests (DPCRN / DPARN channels
(1, 8, 8, 16, 16, 32), F = 16 at the bottleneck, hidden 16, 4 heads):
`center_chunk` / `dparn_center_chunk` against the Pallas kernels in
interpret mode (y and every carry, float32 at atol 3e-5 / rtol 1e-4),
`_mk_conv_weights` in float64, `init_stream_state(mk_kernel=True)`'s layout
and `stream_frames(mk_kernel=True)` over 3 carried chunks. The CUDA kernel
itself runs only on the card (chip_smoke.py phase 2g)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.dparn import DPARN as JDPARN
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu_torch.nnet.dparn import DPARN
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.ops import masker_kernel as mk
from puresound_tpu_torch.utils.from_jax import dparn, dpcrn, to_torch

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
UNET = dict(input_type="RI", input_dim=128, norm_type="bN2d", dropout=0.0,
            channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2, transpose_delay=False,
            kernel_t=(2,) * 5, stride_t=(1,) * 5, dilation_t=(1,) * 5,
            kernel_f=(5, 3, 3, 3, 3), stride_f=(2, 2, 1, 1, 1), dilation_f=(1,) * 5,
            delay=(0,) * 5, rnn_hidden=16)
MODELS = {"dpcrn": (JDPCRN, DPCRN, dpcrn, {}), "dparn": (JDPARN, DPARN, dparn,
                                                          {"nhead": 4})}
B, C_IN = 3, 128


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _pair(name, dtype=np.float32, seed=5):
    """(JAX masker, its variables, the port masker loaded with them)."""
    jcls, pcls, conv, extra = MODELS[name]
    rng = np.random.default_rng(seed)
    jm = jcls(**UNET, **extra)
    v = jax.device_get(jm.init(KEY, jnp.zeros((B, C_IN, 4))))
    v = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float64)
                   + 0.05 * rng.standard_normal(np.shape(a))).astype(dtype), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pm = pcls(**UNET, **extra, dtype=tdt).eval()
    pm.load_state_dict(to_torch(conv(v["params"], v["batch_stats"])), strict=True)
    return jm, v, pm


def _tree_close(got, want, atol, rtol):
    gl = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", list(MODELS))
def test_mk_conv_weights_match_jax_f64(name):
    """BatchNorm folded, the transpose convs' time taps flipped, in JAX's
    flat order."""
    jm, v, pm = _pair(name, np.float64)
    with jax.enable_x64(True):
        want = jm.apply(v, method=lambda m: m._mk_conv_weights())
    got = pm._mk_conv_weights()
    assert len(got) == len(want) == mk.N_CONV_WEIGHTS
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("name", list(MODELS))
def test_init_stream_state_mk_kernel_layout(name):
    jm, v, pm = _pair(name)
    want = jm.apply(v, B, jnp.float32, False, True,
                    method=lambda m, *a: m.init_stream_state(*a))
    got = pm.init_stream_state(B, mk_kernel=True)
    assert set(got) == set(want)
    assert [tuple(a.shape) for a in got["dc"]] == [(16, B, 8), (16, B, 16), (16, B, 16)]
    assert tuple(got["u0h"].shape) == (16, B, 32) and len(got["down"]) == 2
    for key in got:
        ws = jax.tree_util.tree_leaves(want[key])
        gs = got[key] if isinstance(got[key], list) else [got[key]]
        assert [tuple(g.shape) for g in gs] == [tuple(w.shape) for w in ws], key


def _random_state(pm, rng):
    st = pm.init_stream_state(B, mk_kernel=True)
    return {k: ([torch.from_numpy((0.3 * rng.standard_normal(t.shape)).astype(np.float32))
                 for t in v] if isinstance(v, list)
                else torch.from_numpy((0.3 * rng.standard_normal(v.shape)).astype(
                    np.float32)))
            for k, v in st.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_center_kernel_chunk_plain_matches_jax_interpret(name, rng):
    """One call of the wide center from a random carried state: y and every
    carry against the Pallas kernel in interpret mode."""
    jm, v, pm = _pair(name)
    st = _random_state(pm, rng)
    x = (rng.standard_normal((B, 8, 16, 2))).astype(np.float32)
    jst = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), st,
                                 is_leaf=lambda t: isinstance(t, torch.Tensor))
    want = jm.apply(v, jnp.asarray(x), jst,
                    method=lambda m, a, s: m.center_kernel_chunk(a, s))
    got = pm.center_kernel_chunk(torch.from_numpy(x), st)
    _tree_close(list(got), list(want), 3e-5, 1e-4)


@pytest.mark.parametrize("name", list(MODELS))
def test_stream_frames_mk_kernel_matches_jax(name, rng):
    """stream_frames(mk_kernel=True) over 3 carried chunks against JAX's
    mk_kernel route (the Pallas kernel in interpret mode), and against the
    port's own stock route."""
    jm, v, pm = _pair(name)
    s_mk = pm.init_stream_state(B, mk_kernel=True)
    s_ref = pm.init_stream_state(B)
    js = jm.apply(v, B, jnp.float32, False, True,
                  method=lambda m, *a: m.init_stream_state(*a))
    step = jax.jit(lambda a, s: jm.apply(
        v, a, s, method=lambda m, a, s: m.stream_frames(a, s, mk_kernel=True)))
    for _ in range(3):
        x = rng.standard_normal((B, C_IN, 2)).astype(np.float32)
        want, js = step(jnp.asarray(x), js)
        got, s_mk = pm.stream_frames(torch.from_numpy(x), s_mk, mk_kernel=True)
        stock, s_ref = pm.stream_frames(torch.from_numpy(x), s_ref)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), stock.numpy(), atol=3e-5, rtol=1e-4)
    for key in ("dc", "u0h", "u0s", "u1h", "u2h", "h1", "c2", "down", "up"):
        _tree_close(s_mk[key], js[key], 3e-5, 1e-4)


def test_unported_options_raise(rng):
    with pytest.raises(ValueError, match="66 conv weights"):
        mk.parse_conv_weights([torch.zeros(1)] * 65)
