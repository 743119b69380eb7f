"""The dual-path bottleneck's plain version against the Pallas kernel
(puresound_tpu/ops/dual_path_kernel.py::dual_path_chunk, interpret mode)
in float32 at atol 3e-5 / rtol 1e-4, as tests/test_pallas_kernels.py holds
the Pallas kernel against the stock step (the Pallas kernel casts its dots
to float32 even on float64 inputs, so the comparison is float32): 3
carried chunks, y and the four carries. Then StreamingNS.step(dp_kernel=
True) against JAX's, a 120-chunk run of the kernel route against the stock
route (no drift). The int8_hh / xscr_half options are held to JAX in
test_torch_quantized_kernels.py. The CUDA kernel is held against the plain
version on the card by chip_smoke.py (phases 2e, 2h)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.nnet.encoder import ConvEncDec as JEncDec
from puresound_tpu.ops.dual_path_kernel import dual_path_chunk as j_dual_path
from puresound_tpu.streaming.ns_engine import StreamingNS as JStreamingNS
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec
from puresound_tpu_torch.ops import dual_path_kernel as dpk
from puresound_tpu_torch.streaming.ns_engine import StreamingNS
from puresound_tpu_torch.utils.from_jax import from_jax

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
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


def _weights(rng, CH, H, n_blocks=2):
    ws = []
    for _ in range(n_blocks):
        for name in dpk.NAMES:
            shape = dpk._weight_shape(name, CH, H)
            scale = 1.0 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1
            w = rng.uniform(-1, 1, shape) * scale
            if name in ("ig", "tg"):
                w = 1.0 + w
            ws.append(w.astype(np.float32))
    return ws


def test_plain_dual_path_matches_pallas(rng):
    F, K, B, CH, H = 6, 2, 3, 16, 8
    ws = _weights(rng, CH, H)
    hs = [(0.3 * rng.standard_normal((F, B, H))).astype(np.float32) for _ in range(2)]
    cs = [(0.3 * rng.standard_normal((F, B, H))).astype(np.float32) for _ in range(2)]
    jh, jc = [jnp.asarray(a) for a in hs], [jnp.asarray(a) for a in cs]
    th, tc = [torch.from_numpy(a) for a in hs], [torch.from_numpy(a) for a in cs]
    jw = tuple(jnp.asarray(w) for w in ws)
    tw = [torch.from_numpy(w) for w in ws]
    for chunk in range(3):
        x = rng.standard_normal((F, K, B, CH)).astype(np.float32)
        jy, jh, jc = j_dual_path(jnp.asarray(x), jh, jc, jw, b_tile=B, interpret=True)
        ty, th, tc = dpk.dual_path_chunk(torch.from_numpy(x), th, tc, tw)
        for g, w in zip([ty] + th + tc, [jy] + jh + jc):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5, rtol=1e-4,
                                       err_msg=f"chunk {chunk}")
    assert dpk.LAUNCHES == 0          # CPU tensors take the plain version


def _pair(rng):
    jwrap = JWrap(encoder=JEncDec(**ENC), masker=JDPCRN(**UNET), **WRAP)
    v = jwrap.init(KEY, jnp.zeros((1, 8 * HOP)), method=JWrap.inference)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + (0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = SoTaskWrapModule(ConvEncDec(**ENC), DPCRN(**UNET), **WRAP).eval()
    model.load_state_dict(from_jax(v), strict=True)
    return jwrap, v, model


def test_streaming_ns_dp_kernel_matches_jax(rng):
    jwrap, v, model = _pair(rng)
    jeng = JStreamingNS(encoder=jwrap.encoder, masker=jwrap.masker,
                        mask_constraint="linear", drop_first_bin=True)
    engine = StreamingNS.from_offline(model)
    S, n = 2 * HOP, 4
    x = (0.3 * rng.standard_normal((2, S * n))).astype(np.float32)
    state = engine.init_state(2, dp_kernel=True)
    assert state["masker"]["h1"].shape == (16, 2, 16)
    jstate = jeng.apply(v, 2, dp_kernel=True, method=JStreamingNS.init_state)
    step = jax.jit(lambda a, s: jeng.apply(v, a, s, dp_kernel=True,
                                           method=JStreamingNS.step))
    for k in range(n):
        chunk = x[:, k * S:(k + 1) * S]
        want, jstate = step(jnp.asarray(chunk), jstate)
        with torch.no_grad():
            got, state = engine.step(torch.from_numpy(chunk), state, dp_kernel=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-3)
    for key in ("h1", "c1", "h2", "c2"):
        np.testing.assert_allclose(state["masker"][key].numpy(),
                                   np.asarray(jstate["masker"][key]), atol=3e-5, rtol=1e-4)


def test_dp_kernel_long_stream_no_drift(rng):
    """After 120 two-frame chunks the kernel route still matches the stock
    route (counterpart of tests/test_streaming_ns.py:392)."""
    _, _, model = _pair(rng)
    m = model.masker
    s_ref = m.init_stream_state(2)
    s_k = m.init_stream_state(2, dp_kernel=True)
    with torch.no_grad():
        for _ in range(120):
            x = torch.from_numpy(rng.standard_normal((2, 128, 2)).astype(np.float32))
            y_ref, s_ref = m.stream_frames(x, s_ref)
            y_k, s_k = m.stream_frames(x, s_k, dp_kernel=True)
    assert torch.isfinite(y_k).all()
    np.testing.assert_allclose(y_k.numpy(), y_ref.numpy(), atol=5e-5, rtol=1e-3)
