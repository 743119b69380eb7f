"""Sequence parallelism in the port (`parallel.seqpar`) against JAX's
(`puresound_tpu/parallel/seqpar.py`), JAX's four `tests/test_seqpar.py`
cases on the port's mesh of 8 CPU cells against JAX's 8-device CPU mesh:

- `overlapped_chunks` equals JAX's, and the identity round trip holds;
- an identity `fn` comes back whole, 2-D and 1-D;
- a finite-receptive-field model (a causal cLN Conv-TasNet) with the halo
  of its probed receptive field / lookahead: the port's result within 1e-8
  of JAX's in float64, and equal to the unsharded run away from the
  recording's edges;
- the recurrent (SkiM) burn-in curve: the SNR against the unsharded run at
  each left halo within 0.1 dB of JAX's, and rising with the halo.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from puresound_tpu.parallel.seqpar import overlapped_chunks as j_chunks
from puresound_tpu.parallel.seqpar import seq_parallel_infer as j_infer
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN, ConvTasNet
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.parallel import make_mesh, overlapped_chunks, seq_parallel_infer
from puresound_tpu_torch.utils.from_jax import for_model, from_jax
from puresound_tpu_torch.utils.model_info import probe_lookahead_receptive

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
CPU8 = [torch.device("cpu")] * 8


def _jmesh():
    return JMesh(np.array(jax.devices()), ("sp",))


def _snr_db(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))


@pytest.mark.parametrize("halo_l,halo_r,align", [(0, 0, 1), (13, 5, 1), (16, 8, 8)])
def test_overlapped_chunks_equal_jax_and_round_trip(rng, halo_l, halo_r, align):
    x = rng.standard_normal((2, 777)).astype(np.float32)
    want, jLc, jT = j_chunks(jnp.asarray(x), 8, halo_l, halo_r, align)
    chunks, Lc, T = overlapped_chunks(torch.from_numpy(x), 8, halo_l, halo_r, align)
    assert (Lc, T) == (jLc, jT) and T == 777 and chunks.shape[0] == 8
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(want))
    h = chunks.shape[-1] - Lc - halo_r
    y = chunks[:, :, h:h + Lc].transpose(0, 1).reshape(2, -1)[:, :T]
    np.testing.assert_array_equal(y.numpy(), x)


def test_identity_fn_comes_back_whole(rng):
    x = torch.from_numpy(rng.standard_normal((1, 1000)).astype(np.float32))
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == {"dp": 8, "mp": 1}
    y = seq_parallel_infer(lambda c: c, x, mesh, halo_left=32, halo_right=32, align=8)
    assert torch.equal(y, x)
    assert torch.equal(seq_parallel_infer(lambda c: c, x[0], mesh, halo_left=0), x[0])
    # a named axis of one cell calls fn on the whole input
    calls = []
    seq_parallel_infer(lambda c: calls.append(c.shape) or c, x, make_mesh(1, 8, CPU8),
                       halo_left=0, axis="dp")
    assert calls == [(1, 1000)]
    # over "mp" the same 8 chunks as over the whole mesh
    mp = seq_parallel_infer(lambda c: c * 2, x, make_mesh(1, 8, CPU8), 16, 8, 8, axis="mp")
    assert torch.equal(mp, 2 * x)


def _conv_models():
    """JAX's causal cLN Conv-TasNet NS model (tests/test_seqpar.py) and the
    port's on the same float64 weights."""
    from tests.test_seqpar import _causal_conv_ns

    jm = _causal_conv_ns()
    with jax.enable_x64(True):
        v = jm.init(KEY, jnp.zeros((1, 512), jnp.float64),
                    method=type(jm).inference)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(v))
    pm = SoTaskWrapModule(
        encoder=FreeEncDec(win_length=16, hop_length=8, laten_length=16, output_active=True,
                           dtype=torch.float64),
        masker=ConvTasNet(input_dim=16, embed_dim=0, tcn_layer="normal", tcn_kernel=3,
                          tcn_dim=8, tcn_dilated_basic=2, per_tcn_stack=2, repeat_tcn=2,
                          tcn_with_embed=(0, 0), tcn_norm="cLN", dconv_norm="cLN",
                          causal=True, dtype=torch.float64),
        mask_constraint="ReLU")
    # the dconv's cLN gamma / beta, which from_jax writes as a GroupNorm's
    # weight / bias, go to the names the model has (for_model)
    pm.load_state_dict(for_model(from_jax(v), pm), strict=True)
    return jm, v, pm.eval()


def test_finite_receptive_field_exact_and_equal_to_jax(rng):
    jm, v, pm = _conv_models()
    x = rng.standard_normal((1, 4096)) * 0.1

    def fn(c):
        with torch.no_grad():
            return pm.inference(c.double())

    look, recep = probe_lookahead_receptive(fn, length=2048, device="cpu")
    assert recep is not None and look is not None
    mesh = make_mesh(devices=CPU8)
    xt = torch.from_numpy(x)
    got = seq_parallel_infer(fn, xt, mesh, halo_left=recep, halo_right=look, align=8).numpy()
    ref = fn(xt).numpy()
    assert got.shape == ref.shape
    edge = recep + look + 16
    np.testing.assert_allclose(got[:, edge:-edge], ref[:, edge:-edge], atol=1e-10, rtol=0)
    with jax.enable_x64(True):
        jfn = jax.jit(lambda c: jm.apply(v, c, method=type(jm).inference))
        want = np.asarray(j_infer(jfn, jnp.asarray(x), _jmesh(), halo_left=recep,
                                  halo_right=look, align=8))
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)


def _skim_models():
    """JAX's tiny SkiM TSE (tests/test_parallel.py) and the port's on the
    same float32 weights."""
    from tests.test_parallel import _tiny_tse

    jm = _tiny_tse()
    v = jm.init(KEY, jnp.zeros((1, 800)), jnp.zeros((1, 800)), method=type(jm).inference)
    v = jax.device_get(v)
    pm = SoTaskWrapModule(
        FreeEncDec(win_length=16, hop_length=8, laten_length=24, output_active=True),
        SkiM(input_size=24, hidden_size=16, output_size=24, n_blocks=2, seg_size=10,
             causal=True, embed_dim=8, embed_norm=True, embed_fusion="FiLM",
             block_with_embed=(1, 1)),
        [TCN(24, 16, 3, dilation=1, tcn_norm="gLN", dconv_norm="gGN"),
         AttentiveStatisticsPooling(24, 16), Conv1d(48, 8, 1, bias=False)],
        mask_constraint="ReLU")
    pm.load_state_dict(from_jax(v), strict=True)
    return jm, v, pm.eval()


def test_recurrent_halo_burn_in_curve_as_jax_s(rng):
    jm, v, pm = _skim_models()
    x = (rng.standard_normal((1, 4000)) * 0.1).astype(np.float32)
    e = (rng.standard_normal((1, 800)) * 0.1).astype(np.float32)
    et = torch.from_numpy(e)

    def fn(c):
        with torch.no_grad():
            return pm.inference(c, et)

    jfn = jax.jit(lambda c: jm.apply(v, c, jnp.asarray(e), method=type(jm).inference))
    ref, jref = fn(torch.from_numpy(x)).numpy(), np.asarray(jfn(jnp.asarray(x)))
    mesh = make_mesh(devices=CPU8)
    snrs, jsnrs = [], []
    for h in (0, 400, 2400):
        snrs.append(_snr_db(ref, seq_parallel_infer(fn, torch.from_numpy(x), mesh, h, 96,
                                                    align=80).numpy()))
        jsnrs.append(_snr_db(jref, j_infer(jfn, jnp.asarray(x), _jmesh(), halo_left=h,
                                           halo_right=96, align=80)))
    assert snrs[1] > snrs[0] and snrs[2] > snrs[1] and snrs[2] > 25.0, snrs
    np.testing.assert_allclose(snrs, jsnrs, atol=0.1)


def test_a_mesh_over_ranks_or_a_bad_axis_raises():
    from puresound_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="single-process"):
        seq_parallel_infer(lambda c: c, torch.zeros(1, 8), Mesh(range(2), 2, 1, True), 0)
    with pytest.raises(ValueError, match="no mesh axis"):
        seq_parallel_infer(lambda c: c, torch.zeros(1, 8), make_mesh(devices=CPU8), 0,
                           axis="sp")
