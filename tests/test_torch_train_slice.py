"""Port parity, the training slice as a whole: a small tse_skim-style model
(FreeEncDec + 2 TCN + ASP + Conv1d speaker net + 2-block FiLM SkiM, seg 10)
with the SI-SNR loss, against the JAX package on the same weights and batch.

- the wrapper's training loss, every parameter gradient and the updated
  batch stats against `jax.value_and_grad` of `__call__(train=True)`;
- `make_train_step` (Adam 1e-3, grad clip 10) for 3 steps, then with
  `accum_steps=2`, then `skip_nonfinite` over a NaN batch;
all in float64 at atol 1e-8 / rtol 1e-6; and `compute_dtype=bf16` against
JAX's bf16 step at the bars measured and stated there. Then the streaming
weight cache after a step, and the options that are not ported."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDRLoss
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.parallel.mesh import TrainState as JTrainState
from puresound_tpu.parallel.mesh import make_train_step as j_make_train_step
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.parallel import TrainState, adam, make_train_step
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
WIN, HOP, C, E = 32, 16, 24, 8
ENC = dict(win_length=WIN, hop_length=HOP, laten_length=C, output_active=True)
SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2,
            seg_size=10, seg_overlap=False, causal=True, embed_dim=E,
            embed_norm=True, embed_fusion="FiLM", block_with_embed=(1, 1))
N, L, L_ENROLL = 2, HOP * 25, 800


def _jax_model():
    spk = tuple([JTCN(C, 16, 3, dilation=d, causal=False, tcn_norm="gLN",
                      dconv_norm="gGN") for d in (1, 2)]
                + [JASP(C, 16), JConv(2 * C, E, 1, use_bias=False)])
    return JWrap(encoder=JEnc(**ENC), masker=JSkiM(**SKIM), speaker_net=spk,
                 loss_func_wav=JSDRLoss.init_mode("sisnr"),
                 mask_constraint="ReLU")


def _port_model(dtype=torch.float64):
    fk = dict(dtype=dtype)
    spk = ([TCN(C, 16, 3, dilation=d, tcn_norm="gLN", dconv_norm="gGN", **fk)
            for d in (1, 2)]
           + [AttentiveStatisticsPooling(C, 16, **fk),
              Conv1d(2 * C, E, 1, bias=False, **fk)])
    return SoTaskWrapModule(FreeEncDec(**ENC, **fk), SkiM(**SKIM, **fk), spk,
                            loss_func_wav=SDRLoss.init_mode("sisnr"),
                            mask_constraint="ReLU")


def _batch(rng, dtype=np.float64, n=N):
    return {"noisy": rng.standard_normal((n, L)).astype(dtype) * 0.3,
            "enroll": rng.standard_normal((n, L_ENROLL)).astype(dtype) * 0.3,
            "ref_clean": rng.standard_normal((n, L)).astype(dtype) * 0.3}


@pytest.fixture
def pair(rng):
    """(JAX wrapper, its f64 variables, a port wrapper holding them)."""
    jwrap = _jax_model()
    v = jwrap.init(KEY, **{k: jnp.asarray(a, jnp.float32)
                           for k, a in _batch(rng).items()}, train=False)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + 0.05 * rng.standard_normal(np.shape(a)), jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = _port_model()
    model.load_state_dict(fj.from_jax(v), strict=True)
    return jwrap, v, model


def _tb(batch, dtype=None):
    return {k: torch.from_numpy(np.array(a)).to(dtype or torch.float64)
            for k, a in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(a) for k, a in batch.items()}


def _close_state(model, params, stats, atol=ATOL, rtol=RTOL):
    """Every parameter and buffer of the port against JAX's params/stats."""
    want = fj.so_wrapper_tse_skim({"params": params, "batch_stats": stats})
    got = model.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name], atol=atol,
                                   rtol=rtol, err_msg=name)


def test_training_loss_and_gradients_match_jax(pair, rng):
    jwrap, v, model = pair
    batch = _batch(rng)
    with jax.enable_x64(True):
        def loss_fn(params):
            loss, upd = jwrap.apply({"params": params,
                                     "batch_stats": v["batch_stats"]},
                                    **_jb(batch), train=True,
                                    mutable=["batch_stats"])
            return loss, upd["batch_stats"]

        (want, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"])
    model.train()
    loss = model(**_tb(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=ATOL, rtol=RTOL)
    want_g = fj.params_by_name(jax.device_get(grads))
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    _close_state(model, v["params"], stats)


def _run_steps(jwrap, v, model, batches, **kw):
    """The same steps on both sides; per-step (loss, grad_norm) pairs."""
    trace = []
    with jax.enable_x64(True):
        jstate = JTrainState.create(v["params"], v["batch_stats"],
                                    optax.adam(1e-3))
        jstep = j_make_train_step(jwrap, grad_clip=10.0, donate=False, **kw)
        state = TrainState.create(model, adam(1e-3))
        step = make_train_step(model, grad_clip=10.0, **kw)
        for i, batch in enumerate(batches):
            jstate, jm = jstep(jstate, _jb(batch), jax.random.PRNGKey(i))
            state, m = step(state, _tb(batch))
            trace.append(({k: float(t) for k, t in m.items()},
                          {k: float(a) for k, a in jm.items()}))
    assert state.step == len(batches)
    return trace, jstate


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_three_adam_steps_match_jax(pair, rng):
    jwrap, v, model = pair
    trace, jstate = _run_steps(jwrap, v, model, [_batch(rng) for _ in range(3)])
    for got, want in trace:
        _close_metrics(got, want)
    _close_state(model, jstate.params, jstate.batch_stats)


def test_accum_steps_match_jax(pair, rng):
    jwrap, v, model = pair
    trace, jstate = _run_steps(jwrap, v, model, [_batch(rng)], accum_steps=2)
    _close_metrics(*trace[0])
    _close_state(model, jstate.params, jstate.batch_stats)


def test_skip_nonfinite_matches_jax(pair, rng):
    """A clean step, then a batch with a NaN in the enrollment: the loss and
    norm are NaN, the gradient applied is zero (Adam still steps on its
    moments), the BatchNorm stats keep their values, `skipped` is 1."""
    jwrap, v, model = pair
    clean, bad = _batch(rng), _batch(rng)
    bad["enroll"][0, 7] = np.nan
    trace, jstate = _run_steps(jwrap, v, model, [clean, bad],
                               skip_nonfinite=True)
    _close_metrics(*trace[0])
    got, want = trace[1]
    assert got["skipped"] == want["skipped"] == 1.0
    assert np.isnan(got["loss"]) and np.isnan(want["loss"])
    assert all(torch.count_nonzero(p.grad) == 0 for p in model.parameters())
    _close_state(model, jstate.params, jstate.batch_stats)


def test_bf16_step_matches_jax_bf16_step(pair, rng):
    """compute_dtype=bf16 on float32 masters. JAX's step runs with
    `optax.identity()` so its parameter change is the gradient it applied;
    the port's step leaves that gradient in `.grad`. The two round to bf16
    at different places (JAX's plain scan keeps h/c in bf16, the port's
    kernel path carries them in f32, and the SI-SNR sums cancel), so the
    bars are the spread measured here with margin. Measured: loss 34.25 vs
    34.0 (one bf16 ulp), grad_norm 1.1 % apart, gradient cosine 0.9987 over
    all parameters and >= 0.985 per tensor, BatchNorm stats within 2e-3 of
    their max. Bars: 2e-2, 3e-2, 0.99, 0.95, 1e-2. The ASP conv bias is
    left out per tensor: a softmax over time is shift-invariant, so its
    exact gradient is zero and both sides hold rounding noise there."""
    jwrap, v, model = pair
    v32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    model = model.float()
    batch = _batch(rng, np.float32)
    batch["ref_clean"] = batch["noisy"] + 0.1 * batch["ref_clean"]
    jstate = JTrainState.create(v32["params"], v32["batch_stats"],
                                optax.identity())
    jstep = j_make_train_step(jwrap, donate=False, compute_dtype=jnp.bfloat16)
    jstate2, jm = jstep(jstate, _jb(batch), KEY)
    state = TrainState.create(model, adam(1e-3))
    step = make_train_step(model, compute_dtype=torch.bfloat16)
    state, m = step(state, _tb(batch, torch.float32))
    assert m["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for k, rtol in (("loss", 2e-2), ("grad_norm", 3e-2)):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol)
    want_g = fj.params_by_name(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        jax.device_get(jstate2.params), v32["params"]))
    got_g = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    cos = lambda a, b: float(np.sum(a * b) / np.sqrt(np.sum(a * a) * np.sum(b * b)))
    flat = lambda d: np.concatenate([d[n].ravel() for n in sorted(got_g)])
    assert cos(flat(got_g), flat(want_g)) >= 0.99
    for name in set(got_g) - {"speaker_net.2.conv.bias"}:
        assert cos(got_g[name], want_g[name]) >= 0.95, name
    stats = fj.so_wrapper_tse_skim({"params": v32["params"],
                                    "batch_stats": jstate2.batch_stats})
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name], rtol=0,
                                   atol=1e-2 * np.abs(stats[name]).max())


def test_streaming_serves_the_updated_weights(pair, rng):
    """A train step updates the parameters in place; the fused streaming
    step's weight cache (keyed on each parameter's version) rebuilds, so
    the model serves the new weights: it equals a fresh model loaded with
    the trained state_dict."""
    _, _, model = pair
    x = torch.from_numpy(rng.standard_normal((2, 5, C)))
    embed = torch.from_numpy(rng.standard_normal((2, E)))

    def serve(m):
        with torch.no_grad():
            skim = m.masker
            y, _ = skim.step_frames_fused(x, embed,
                                          skim.init_state(2, torch.float64))
        return y

    before = serve(model)
    state = TrainState.create(model, adam(1e-3))
    make_train_step(model, grad_clip=10.0)(state, _tb(_batch(rng)))
    after = serve(model)
    fresh = _port_model()
    fresh.load_state_dict(model.state_dict())
    assert not torch.equal(before, after)
    assert torch.equal(after, serve(fresh))


def test_unported_step_options_raise():
    """mesh= / tp= are ported (tests/test_torch_tp.py): tp=True without a
    mesh, and a mesh of local devices for training, raise and point to the
    process mesh (--num_processes)."""
    from puresound_tpu_torch.parallel import make_mesh

    model = _port_model(torch.float32)
    with pytest.raises(ValueError, match="needs a mesh over the process group"):
        make_train_step(model, tp=True)
    local = make_mesh(devices=[torch.device("cpu")] * 2)
    for option in (dict(mesh=local), dict(mesh=local, tp=True)):
        with pytest.raises(ValueError, match="--num_processes"):
            make_train_step(model, **option)
    # remat and augment_fn are ported (tests/test_torch_remat.py,
    # tests/test_torch_device_augment.py), and SkiM's dropout
    # (tests/test_torch_skim_zoo.py)
    with pytest.raises(ValueError, match="remat"):
        make_train_step(model, remat="all")
    skim = SkiM(**SKIM, dropout=0.1)
    assert skim.seg_lstm[0].drop.p == skim.mem_lstm[0].h_drop.p == 0.1
