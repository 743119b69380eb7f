"""Port parity, DSS (near / far separation): `DPARN_Mout`, the Unet's
multi_output, `SiMoTaskWrapModule`, `StreamingDSS`, `DssDataset` /
`DssCollateFunc` / `DssTask`, the SIMO eval helpers and the DSS recipe CLI
against the JAX package on the CPU, inputs from numpy seeds:

- in float64 (atol 1e-8, rtol 1e-6): `DPARN_Mout`'s forward at M = 2 (every
  weight drawn apart, so a transposed (M, channel) layout shows), the
  wrapper's inference, its loss (`sasisnr` on [N, M, L] and plain SI-SNR on
  [N * M, L], with and without inactive labels; ref truncated to the
  outputs) and every gradient, one `DssTask` train step and three Adam
  steps at the shipped config's optimizer;
- `StreamingDSS.step` on the stock, fused, attn_kernel, fused + attn_kernel
  and mk_kernel routes (the kernels' plain versions) chunk by chunk against
  JAX's stock engine (f64), and streamed == offline on the zero-primed
  input per source (f32 at JAX's test's atol 3e-5 / rtol 1e-3);
- `DssDataset` batches bit for bit with JAX's (silent near and far
  references, crop, pad, volume draw; 0 and 2 workers);
- `stream_signal` gives [M, L], `BucketedBatchRunner` [B, M, T];
- `python -m puresound_tpu_torch.egs.dss.main` dev / eval against JAX's
  `egs/dss/main.py` on one JAX checkpoint (model_average 2), small models
  patched in: every printed number within 1e-4 relative, the wavs within
  one int16 step; the recipe's train on the CPU; the raising actions.
"""
import copy
import functools
import importlib.util
import os
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from puresound_tpu.nnet.base_nn import SiMoTaskWrapModule as JSiMo
from puresound_tpu.nnet.dparn import DPARN_Mout as JDPARN_Mout
from puresound_tpu.nnet.encoder import ConvEncDec as JEncDec
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDRLoss
from puresound_tpu.parallel.mesh import TrainState as JTrainState
from puresound_tpu.parallel.mesh import make_train_step as j_make_train_step
from puresound_tpu.streaming.simo_engine import StreamingDSS as JStreamingDSS
from puresound_tpu.tasks import base as jbase
from puresound_tpu.tasks import dss as jdss
from puresound_tpu_torch.egs.dss import main as cli
from puresound_tpu_torch.nnet.base_nn import SiMoTaskWrapModule
from puresound_tpu_torch.nnet.dparn import DPARN_Mout
from puresound_tpu_torch.nnet.encoder import ConvEncDec
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.nnet.unet import Unet
from puresound_tpu_torch.parallel import TrainState, make_train_step
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.streaming.file_eval import build_engine, stream_signal
from puresound_tpu_torch.streaming.simo_engine import StreamingDSS
from puresound_tpu_torch.tasks import base, dss
from puresound_tpu_torch.tasks.batch_eval import BucketedBatchRunner
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
N_FFT, HOP = 128, 32
COMMON = dict(input_type="RI", input_dim=N_FFT, norm_type="bN2d", dropout=0.0,
              transpose_t_size=2, multi_output=2)
#: tests/test_streaming_dss.py's `_build` widths, and a five-layer Unet whose
#: three stride-1 inner layers the wide-center (mk_kernel) route takes
GEOMS = {"small": dict(channels=(1, 8, 8), kernel_t=(2, 2), stride_t=(1, 1),
                       dilation_t=(1, 1), kernel_f=(5, 3), stride_f=(2, 2),
                       dilation_f=(1, 1), delay=(0, 0), rnn_hidden=8, nhead=2),
         "wide": dict(channels=(1, 8, 8, 16, 16, 32), kernel_t=(2,) * 5, stride_t=(1,) * 5,
                      dilation_t=(1,) * 5, kernel_f=(5, 3, 3, 3, 3),
                      stride_f=(2, 2, 1, 1, 1), dilation_f=(1,) * 5, delay=(0,) * 5,
                      rnn_hidden=16, nhead=4)}
ENC = dict(fft_length=N_FFT, win_length=N_FFT, hop_length=HOP, trainable=True,
           output_format="Complex")
WRAP = dict(f_type="Complex", mask_type="Complex", drop_first_bin=True)
CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "egs", "dss", "conf", "dss_dparn_1a.yaml")


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jwrap(geom, loss=None):
    return JSiMo(encoder=JEncDec(**ENC), masker=JDPARN_Mout(**COMMON, **GEOMS[geom]),
                 loss_func_wav=loss, **WRAP)


def _port(geom, loss=None, dtype=torch.float64, device=None):
    fk = dict(device=device, dtype=dtype)
    return SiMoTaskWrapModule(ConvEncDec(**ENC, **fk),
                              DPARN_Mout(**COMMON, **GEOMS[geom], **fk),
                              loss_func_wav=loss, **WRAP).eval()


def _variables(jwrap, rng, scale=0.05):
    v = jwrap.init(KEY, jnp.zeros((1, 8 * HOP)), method=JSiMo.inference)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) + scale * rng.standard_normal(np.shape(a)),
        jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return v


def _pair(geom, rng, jloss=None, loss=None):
    jwrap = _jwrap(geom, jloss)
    v = _variables(jwrap, rng)
    model = _port(geom, loss)
    model.load_state_dict(fj.from_jax(v), strict=True)
    return jwrap, v, model


@pytest.fixture(scope="module", params=list(GEOMS))
def pair(request):
    return _pair(request.param, np.random.default_rng(17))


@pytest.fixture(scope="module")
def wide():
    return _pair("wide", np.random.default_rng(18))


def _japply(jwrap, v, fn, *args):
    with jax.enable_x64(True):
        return np.asarray(jwrap.apply(v, *[jnp.asarray(a) for a in args], method=fn))


# ------------------------------------------------------------------ modules
def test_dparn_mout_forward_matches_jax(pair, rng):
    """[N, M, C, T] masks, the M sources' channels read as (M, channel)."""
    jwrap, v, model = pair
    x = rng.standard_normal((2, N_FFT, 9))
    with torch.no_grad():
        got = model.masker(_t(x))
    want = _japply(jwrap, v, lambda m, a: m.masker(a), x)
    assert got.shape == (2, 2, N_FFT, 9) == want.shape
    _close(got, want)
    assert not np.allclose(want[:, 0], want[:, 1])


def test_from_jax_simo_wrapper_is_strict(pair):
    _, v, model = pair
    sd = fj.simo_wrapper_dss_dparn(v)
    assert set(sd) == set(model.state_dict()) == set(fj.from_jax(v))
    last = model.masker.cnn_up[-1][0].weight
    assert last.shape[1] == 2 * 2 and len(model.masker.cnn_up[-1]) == 1


def test_multi_output_streaming_checks_and_skip_conv():
    """JAX's split: the plain Unet streams one output only, the dual-path
    models any; skip_conv (ported) builds and does not stream, as JAX's
    `causal_streamable`."""
    geo = {k: v for k, v in GEOMS["small"].items() if k not in ("rnn_hidden", "nhead")}
    assert not Unet(**COMMON, **geo).causal_streamable()
    assert Unet(**dict(COMMON, multi_output=1), **geo).causal_streamable()
    assert DPARN_Mout(**COMMON, **GEOMS["small"]).causal_streamable()
    skip = Unet(**dict(COMMON, multi_output=1), **geo, skip_conv=True)
    assert len(skip.skip_cnn) == len(skip.cnn_up) and not skip.causal_streamable()


def test_simo_inference_matches_jax(pair, rng):
    jwrap, v, model = pair
    x = rng.standard_normal((2, HOP * 20 + 5)) * 0.3
    with torch.no_grad():
        got = model.inference(_t(x))
    want = _japply(jwrap, v, JSiMo.inference, x)
    assert got.shape == want.shape and got.shape[:2] == (2, 2)
    _close(got, want)


LOSSES = ["sasisnr", "sisnr"]
INACTIVE = {"none": None, "labels": np.array([[False, True], [True, False], [False, False]])}


@pytest.mark.parametrize("inactive", list(INACTIVE))
@pytest.mark.parametrize("mode", LOSSES)
def test_simo_loss_and_gradients_match_jax(rng, mode, inactive):
    """Training-mode loss (BatchNorm on batch statistics) and every
    gradient: source-aggregated SI-SNR over [N, M, L] with [N, M] labels,
    plain SI-SNR over [N * M, L] with [N * M]; a reference 7 samples longer
    than the outputs is truncated to them."""
    jwrap, v, model = _pair("small", rng, JSDRLoss.init_mode(mode), SDRLoss.init_mode(mode))
    L = HOP * 16
    noisy = 0.3 * rng.standard_normal((3, L))
    ref = 0.3 * rng.standard_normal((3, 2, L + 7))
    inact = INACTIVE[inactive]
    with jax.enable_x64(True):
        def loss_fn(params):
            kw = {} if inact is None else {"inactive_labels": jnp.asarray(inact)}
            out, _ = jwrap.apply({"params": params, "batch_stats": v["batch_stats"]},
                                 jnp.asarray(noisy), jnp.asarray(ref), train=True,
                                 mutable=["batch_stats"], **kw)
            return out

        want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    model.train()
    loss = model(_t(noisy), _t(ref), None if inact is None else _t(inact))
    loss.backward()
    _close(loss, want)
    flat = fj.params_by_name(jax.device_get(jgrads))
    for n, p in model.named_parameters():
        _close(p.grad, flat[n])


# ---------------------------------------------------------------- streaming
ROUTES = {"stock": {}, "fused": dict(fused=True), "attn_kernel": dict(attn_kernel=True),
          "fused+attn_kernel": dict(fused=True, attn_kernel=True),
          "mk_kernel": dict(mk_kernel=True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_streaming_dss_step_matches_jax_chunk_by_chunk(wide, rng, route):
    """StreamingDSS.step on each route (the kernels' plain versions) against
    JAX's stock step, [B, M, S] chunk by chunk, in f64."""
    jwrap, v, model = wide
    kw = ROUTES[route]
    jeng = JStreamingDSS(encoder=jwrap.encoder, masker=jwrap.masker,
                         mask_constraint="linear", drop_first_bin=True)
    engine = build_engine(model)
    assert isinstance(engine, StreamingDSS) and engine.n_sources == 2
    S, n = 4 * HOP, 4
    x = rng.standard_normal((2, S * n)) * 0.3
    state = engine.init_state(2, torch.float64, mk_kernel=route == "mk_kernel")
    with jax.enable_x64(True), torch.no_grad():
        jstate = jeng.apply(v, 2, jnp.float64, method=JStreamingDSS.init_state)
        step = jax.jit(lambda a, s: jeng.apply(v, a, s, method=JStreamingDSS.step))
        for k in range(n):
            chunk = x[:, k * S:(k + 1) * S]
            want, jstate = step(jnp.asarray(chunk), jstate)
            got, state = engine.step(_t(chunk), state, **kw)
            assert got.shape == (2, 2, S)
            _close(got, want)
    _close(state["ola_tail"], jstate["ola_tail"])


@pytest.mark.parametrize("geom", list(GEOMS))
def test_streaming_dss_equals_offline_per_source_f32(rng, geom):
    """f32: the streamed chunks of x equal the offline inference of
    [zeros(n_fft - hop), x] per source past n_fft (JAX's test's bars)."""
    jwrap = _jwrap(geom)
    v = _variables(jwrap, rng)
    model = _port(geom, dtype=torch.float32)
    model.load_state_dict({k: t.float() for k, t in fj.from_jax(v).items()}, strict=True)
    engine = build_engine(model)
    L = HOP * 40
    x = torch.from_numpy(rng.standard_normal((2, L)).astype(np.float32) * 0.1)
    with torch.no_grad():
        off = model.inference(torch.nn.functional.pad(x, (N_FFT - HOP, 0)))
        state, outs = engine.init_state(2), []
        for i in range(0, L, HOP * 4):
            y, state = engine.step(x[:, i:i + HOP * 4], state)
            outs.append(y)
    streamed = torch.cat(outs, -1)
    assert streamed.shape == (2, 2, L)
    np.testing.assert_allclose(streamed[..., N_FFT:].numpy(), off[..., N_FFT:L].numpy(),
                               atol=3e-5, rtol=1e-3)


def test_mk_kernel_route_equals_stock_and_refuses_int8(wide, rng):
    """The wide-center route's plain version against the stock route on one
    stream; int8_hh raises as it does on DPARN; fused excludes mk_kernel."""
    _, _, model = wide
    engine = build_engine(model)
    x = _t(rng.standard_normal((1, 8 * HOP)) * 0.3)
    with torch.no_grad():
        a, _ = engine.step(x, engine.init_state(1, torch.float64))
        b, st = engine.step(x, engine.init_state(1, torch.float64, mk_kernel=True),
                            mk_kernel=True)
        _close(b, a)
        with pytest.raises(ValueError, match="int8_hh"):
            model.masker.center_kernel_chunk(torch.zeros(1, 16, 32, 2, dtype=torch.float64),
                                             st["masker"], int8_hh=True)
        with pytest.raises(ValueError, match="mutually exclusive"):
            engine.step(x, st, fused=True, mk_kernel=True)


def test_stream_signal_gives_every_source(pair, rng):
    """[M, L] aligned with the input (n_fft - hop later), equal to the
    engine's own steps on the zero-padded file."""
    _, _, model = pair
    engine = build_engine(copy.deepcopy(model).float())
    L, chunk = 2000, 128                 # 8 ms at 16 kHz
    wav = (rng.standard_normal(L) * 0.1).astype(np.float32)
    out, rtf = stream_signal(engine, wav, 16000, chunk_ms=8.0)
    assert out.shape == (2, L) and rtf > 0 and np.isfinite(out).all()
    n = -(-(L + N_FFT - HOP) // chunk)
    x = torch.zeros(1, n * chunk)
    x[0, :L] = torch.from_numpy(wav)
    with torch.no_grad():
        state, ys = engine.init_state(1), []
        for k in range(n):
            y, state = engine.step(x[:, k * chunk:(k + 1) * chunk], state)
            ys.append(y)
    want = torch.cat(ys, -1)[0, :, N_FFT - HOP:N_FFT - HOP + L].numpy()
    np.testing.assert_array_equal(out, want)


def test_bucketed_runner_carries_the_source_axis(pair, rng):
    """[B, M, T] outputs sliced back per item, equal to batch-1 inference
    before the zero-padded tail's last window."""
    _, _, model = pair
    items = [(rng.standard_normal((1, n)) * 0.3,) for n in (900, 1100, 1000)]
    runner = BucketedBatchRunner(model.inference, batch_size=2, quantum=1200)
    with torch.no_grad():
        outs = runner.run(items)
        for (x,), o in zip(items, outs):
            one = model.inference(_t(x))[0].numpy()
            assert o.shape == (2, x.shape[-1])
            _close(o[:, :x.shape[-1] - N_FFT], one[:, :x.shape[-1] - N_FFT])
    assert runner.bucket_keys == [(1200,)]


# ------------------------------------------------------------------ batches
SR = 2000


def _write_manifest(folder, n=6, seed=3):
    """n mixtures at 2 kHz of 0.6-1.6 s (cropped to JAX's whole-second
    max_length, or zero-padded to it); item 1's near and item 2's far
    reference are all zeros (silent sides)."""
    r = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    lines = {"wav2scp": [], "ref2near": [], "ref2far": []}
    for i in range(n):
        L = int((0.6 + 0.2 * i) * SR)
        near = 0.2 * np.sin(2 * np.pi * (100 + 20 * i) * np.arange(L) / SR) * (i != 1)
        far = 0.1 * r.standard_normal(L) * (i != 2)
        for name, sig in (("mix", near + far + 0.01 * r.standard_normal(L)), ("near", near),
                          ("far", far)):
            path = os.path.join(folder, f"{name}_{i}.wav")
            wavfile.write(path, SR, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
            key = {"mix": "wav2scp", "near": "ref2near", "far": "ref2far"}[name]
            lines[key].append(f"utt_{i} {path}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return _write_manifest(str(tmp_path_factory.mktemp("dss_manifest")))


BATCH_CASES = [dict(max_length=1), dict(max_length=1, vol_perturbed="0.5,1.5"),
               dict(max_length=1, vol_perturbed=(0.2, 0.9), num_workers=2),
               dict(max_length=None, batch_size=1)]


@pytest.mark.parametrize("case", BATCH_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_dss_batches_match_jax_bit_for_bit(manifest, case):
    case = dict(case)
    workers, bs = case.pop("num_workers", 0), case.pop("batch_size", 4)
    loaders = [mb.DataLoader(m.DssDataset(manifest, resample_to=SR, **case), batch_size=bs,
                             shuffle=True, collate_fn=m.DssCollateFunc(),
                             num_workers=workers, seed=9)
               for m, mb in ((jdss, jbase), (dss, base))]
    flags = 0
    for _ in range(2):
        want, got = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == -(-6 // bs)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert g["uttid"] == w["uttid"]
            for k in ("near_wav", "far_wav", "process_wav", "inactive_nearend",
                      "inactive_farfield"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            flags += int(g["inactive_nearend"].sum() + g["inactive_farfield"].sum())
    assert flags == 4      # each pass meets the silent near and the silent far


def test_dss_dataset_augmentation_options_raise(manifest):
    """The host options are ported (their batches against JAX's in
    tests/test_torch_augment.py); the on-device chain raises for DSS, whose
    [N, 2, L] targets JAX's chain cannot take."""
    for opt in (dict(noise_folder=manifest), dict(speed_perturbed=True)):
        assert dss.DssDataset(manifest, resample_to=SR, **opt).augmentor is not None
    task = object.__new__(dss.DssTask)
    with pytest.raises(ValueError, match=r"\[N, 2, L\]"):
        task._device_augment_fn()


def _loader_batch(manifest):
    """One collated batch of 4 (a silent side among them) from each
    package's loader, bit-equal."""
    loaders = [mb.DataLoader(m.DssDataset(manifest, resample_to=SR, max_length=1),
                             batch_size=4, shuffle=False, collate_fn=m.DssCollateFunc(),
                             seed=9)
               for m, mb in ((jdss, jbase), (dss, base))]
    # each loader run out before the next starts: JAX's prefetches in a
    # thread that seeds the global RNGs
    jb, b = list(loaders[0])[0], list(loaders[1])[0]
    for k in ("process_wav", "near_wav", "far_wav"):
        np.testing.assert_array_equal(jb[k], b[k])
    return jb, b


def _task(trainer_cls, hp, model=None):
    """A trainer instance with what `_batch_kwargs` / `_make_optimizer`
    read, without its loaders."""
    t = object.__new__(trainer_cls)
    t.hparam, t.device, t.model = hp, torch.device("cpu"), model
    return t


def _jbatch(jtask, jb):
    with jax.enable_x64(True):
        return {k: jnp.asarray(np.asarray(a, np.float64) if a.dtype != bool else a)
                for k, a in jtask._batch_kwargs(jb).items()}


def _pbatch(task, b):
    return {k: (t.double() if t.is_floating_point() else t)
            for k, t in task._batch_kwargs(b).items()}


def test_dss_task_train_step_matches_jax(manifest, rng):
    """One step of DssTask's batches ([N, 2, L] targets, [N, 2] labels) on
    the shipped `sasisnr` loss: loss, grad_norm, every gradient and the new
    BatchNorm statistics."""
    jwrap, v, model = _pair("small", rng, JSDRLoss.init_mode("sasisnr"),
                            SDRLoss.init_mode("sasisnr"))
    hp = load_hparam(CONF)
    jb, b = _loader_batch(manifest)
    assert b["inactive_nearend"].any() or b["inactive_farfield"].any()
    jbatch = _jbatch(_task(jdss.DssTask, hp), jb)
    pbatch = _pbatch(_task(dss.DssTask, hp), b)
    assert pbatch["ref_clean"].shape == (4, 2, SR)
    assert pbatch["inactive_labels"].dtype == torch.bool
    with jax.enable_x64(True):
        # optax.identity: the step adds the clipped gradient to the params
        jstate = JTrainState.create(v["params"], v["batch_stats"], optax.identity())
        jstep = j_make_train_step(jwrap, grad_clip=10.0, donate=False)
        jnew, jm = jstep(jstate, jbatch, jax.random.PRNGKey(1))
        jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                        jax.device_get(jnew.params), v["params"])
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    state, m = make_train_step(model, grad_clip=10.0)(state, pbatch)
    _close(m["loss"], jm["loss"])
    _close(m["grad_norm"], jm["grad_norm"])
    want = fj.params_by_name(jgrads)
    for n, p in model.named_parameters():
        _close(p.grad, want[n], atol=1e-7)
    stats = fj.flat_from_jax({"params": v["params"],
                              "batch_stats": jax.device_get(jnew.batch_stats)})
    for n, t in model.state_dict().items():
        _close(t, stats[n])


def test_three_adam_steps_at_the_shipped_optimizer_match_jax(manifest, rng):
    """The shipped config's optimizer (Adam 1e-4, clip 10, no weight decay)
    through DssTask's `_make_optimizer` against JAX's `_make_tx`, 3 steps."""
    hp = load_hparam(CONF)
    jwrap, v, model = _pair("small", rng, JSDRLoss.init_mode("sasisnr"),
                            SDRLoss.init_mode("sasisnr"))
    owner, trainer = _task(jdss.DssTask, hp), _task(dss.DssTask, hp, model)
    lr = np.float32(hp["OPTIMIZER"]["lr"])
    clip = hp["OPTIMIZER"]["gradiend_clip"]
    jb, b = _loader_batch(manifest)
    with jax.enable_x64(True):
        jstate = JTrainState.create(v["params"], v["batch_stats"],
                                    optax.chain(owner._make_tx(), optax.scale(lr)))
        jstep = j_make_train_step(jwrap, grad_clip=clip, donate=False)
        state = TrainState(model, trainer._make_optimizer())
        step = make_train_step(model, grad_clip=clip)
        for i in range(3):
            jstate, jm = jstep(jstate, _jbatch(owner, jb), jax.random.PRNGKey(i))
            state, m = step(state, _pbatch(trainer, b))
            _close(m["loss"], jm["loss"])
        want = fj.flat_from_jax({"params": jax.device_get(jstate.params),
                                 "batch_stats": jax.device_get(jstate.batch_stats)})
    for n, t in model.state_dict().items():
        _close(t, want[n])


# ---------------------------------------------------------------------- CLI
def test_build_model_is_the_shipped_configuration():
    """ConvEncDec 512 / 512 / 128 and DPARN_Mout(M=2, H=128, 8 heads): the
    JAX recipe's model, parameter for parameter; the zoo name is checked."""
    hp = load_hparam(CONF)
    model = cli.build_model(hp, device="cpu")
    shapes = jax.eval_shape(lambda: _load_jax_cli().build_model(hp).init(
        KEY, jnp.zeros((1, 16000)), method=JSiMo.inference))
    want = {k: tuple(a.shape) for k, a in fj.flat_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want
    assert model.masker.multi_output == 2 and not model.training
    with pytest.raises(NameError):
        cli.build_model({"MODEL": {"type": "dss_x"}}, device="cpu")


def _load_jax_cli():
    """JAX's `egs/dss/main.py` as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(CONF)), "main.py")
    spec = importlib.util.spec_from_file_location("jax_recipe_dss_main", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Jitted:
    """JAX's recipe builds its model and applies it eagerly; this stand-in
    jits `inference` (the same computation, compiled once a shape)."""

    def __init__(self, model):
        self.model = model
        self._apply = jax.jit(functools.partial(model.apply, method=JSiMo.inference))

    def init(self, *args, **kw):
        return self.model.init(*args, **kw)

    def apply(self, variables, *args, method=None):
        assert method is JSiMo.inference
        return self._apply(variables, *args)


def _jax_cli(monkeypatch):
    mod = _load_jax_cli()
    monkeypatch.setattr(mod, "build_model", lambda hparam, sig_loss=None: _Jitted(
        JSiMo(encoder=JEncDec(**ENC), masker=JDPARN_Mout(**COMMON, **GEOMS["small"]),
              **WRAP)))
    return mod


class _JaxTrainer:
    """Enough of JAX's BaseTrainer for its own `save_ckpt`."""
    _ckpt_tree = jbase.BaseTrainer._ckpt_tree
    save_ckpt = jbase.BaseTrainer.save_ckpt
    current_lr, best_loss, best_epoch, overall_step = 1e-4, 0.1, 0, 1

    def __init__(self, v):
        self.state = types.SimpleNamespace(params=v["params"], opt_state={},
                                           batch_stats=v["batch_stats"])
        self.scheduler = jbase.LearningRateScheduler("Plateau", base_lr=1e-4)


def _checkpoints(rng, save_dirs):
    """JAX-written epoch_0 / epoch_1 checkpoints of the small model."""
    for e in range(2):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   _variables(_jwrap("small"), rng, 0.2))
        for d in save_dirs:
            os.makedirs(d, exist_ok=True)
            _JaxTrainer(v).save_ckpt(os.path.join(d, f"epoch_{e}.ckpt"), e,
                                     {"total_loss": 0.1})


def _eval_manifest(folder, rng, n=2, L=12000):
    """n mixtures at 16 kHz; the second one's far reference silent."""
    os.makedirs(folder, exist_ok=True)
    lines = {"wav2scp": [], "ref2near": [], "ref2far": []}
    t = np.arange(L) / 16000
    for i in range(n):
        near = 0.2 * np.sin(2 * np.pi * rng.uniform(120, 300) * t)
        far = 0.05 * rng.standard_normal(L) * (i != 1)
        for name, sig, key in (("mix", near + far, "wav2scp"), ("near", near, "ref2near"),
                               ("far", far, "ref2far")):
            path = os.path.join(folder, f"{name}_{i}.wav")
            wavfile.write(path, 16000, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
            lines[key].append(f"mix_{i} {path}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


def _hp(data, save_dir):
    hp = load_hparam(CONF)
    hp["DATASET"].update(train=data, dev=data, eval=data)
    hp["TRAIN"].update(model_save_dir=str(save_dir), log_dir=str(save_dir), model_average=2)
    return hp


def _small_build(hparam, sig_loss=None, *, device=None, generator=None):
    return _port("small", sig_loss, torch.float32, device)


def _numbers(text):
    out = []
    for line in text.splitlines():
        vals = [p.strip() for p in line.replace(":", ",").split(",")[1:]]
        try:
            out.append([float(v) for v in vals if v])
        except ValueError:
            continue
    return out


def _wavs(folder):
    return {f: wavfile.read(os.path.join(folder, f))[1] for f in sorted(os.listdir(folder))}


def _main(cfg, *args):
    return cli.main(cli.parse_args([str(cfg), *args, "--ckpt", "epoch_1.ckpt",
                                    "--backend", "cpu"]))


def test_dev_and_eval_match_the_jax_recipe(tmp_path, rng, monkeypatch, capsys):
    """`dev` (uttid, SISNR(near), SISNR(far), the two means) and `eval`
    (<key>_near.wav / <key>_far.wav) on one JAX checkpoint pair, model
    averaging on; then --batch_eval 2 against one at a time."""
    monkeypatch.setattr(cli, "build_model", _small_build)
    jcli = _jax_cli(monkeypatch)
    data = _eval_manifest(str(tmp_path / "data"), rng)
    _checkpoints(rng, [tmp_path / "jax", tmp_path / "port"])
    jhp, hp = _hp(data, tmp_path / "jax"), _hp(data, tmp_path / "port")
    cfg = tmp_path / "port.yaml"
    dump_hparam(hp, str(cfg))

    random.seed(7)
    jcli.action_dev(jhp, "cpu", "epoch_1.ckpt")
    want = capsys.readouterr().out
    random.seed(7)
    means = _main(cfg, "--action", "dev")
    got = capsys.readouterr().out
    assert "model_average: averaging 2 checkpoints ending at epoch_1.ckpt" in got
    label = lambda text: [line.replace(":", ",").split(",")[0] for line in text.splitlines()
                          if not line.startswith("model_average")]
    assert label(got) == label(want)
    assert "uttid, SISNR(near), SISNR(far)" in got and "SiSNR far:" in got
    g, w = _numbers(got), _numbers(want)
    assert len(g) == len(w) == 4 and np.isfinite(sum(g, [])).all()
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert set(means) == {"near", "far"}

    jcli.action_eval(jhp, "cpu", "epoch_1.ckpt")
    _main(cfg, "--action", "eval")
    want_w, got_w = _wavs(tmp_path / "jax" / "eval_audio"), _wavs(tmp_path / "port" /
                                                                  "eval_audio")
    assert list(got_w) == list(want_w) == ["mix_0_far.wav", "mix_0_near.wav",
                                           "mix_1_far.wav", "mix_1_near.wav"]
    for k in want_w:
        assert got_w[k].dtype == want_w[k].dtype == np.int16
        assert np.abs(got_w[k].astype(int) - want_w[k]).max() <= 1, k

    _main(cfg, "--action", "eval", "--batch_eval", "2", "--eval_quantum", "0.8")
    batched = _wavs(tmp_path / "port" / "eval_audio")
    for k in got_w:
        a, b = batched[k][:12000 - 512].astype(int), got_w[k][:12000 - 512].astype(int)
        assert np.abs(a - b).max() <= 1, k
    _main(cfg, "--action", "dev", "--batch_eval", "2")
    assert "batch_eval: 1 bucket shapes for 2 utterances" in capsys.readouterr().out


def test_stream_eval_writes_each_source(tmp_path, rng, monkeypatch, capsys):
    """stream_eval over the dev set (as JAX's DSS recipe) on the stock,
    --fused and --mk_kernel routes and --half: <key>_near / _far wavs equal
    to what stream_signal gives on the loaded model."""
    monkeypatch.setattr(cli, "build_model",
                        lambda hparam, sig_loss=None, *, device=None, generator=None:
                        _port("wide", sig_loss, torch.float32, device))
    data = _eval_manifest(str(tmp_path / "data"), rng, n=1, L=6000)
    save = tmp_path / "models"
    os.makedirs(save)

    class Saver(base.BaseTrainer):
        def __init__(self, model):
            self.model = model
            super().__init__({"OPTIMIZER": {"lr_scheduler": "Plateau", "lr": 1e-4},
                              "TRAIN": {}}, "cpu")

    for e in range(2):
        m = _port("wide", dtype=torch.float32)
        m.load_state_dict({k: t.float() for k, t in
                           fj.from_jax(_variables(_jwrap("wide"), rng, 0.2)).items()})
        Saver(m).save_ckpt(str(save / f"epoch_{e}.ckpt"), e, {"total_loss": 0.1})
    hp = _hp(data, save)
    cfg = tmp_path / "c.yaml"
    dump_hparam(hp, str(cfg))
    for flags in [(), ("--fused",), ("--mk_kernel",), ("--half",)]:
        _main(cfg, "--action", "stream_eval", *flags)
        assert "Average RTF over 1 utts" in capsys.readouterr().out
        got = _wavs(save / "stream_eval_audio")
        engine = build_engine(cli.load_eval_model(hp, "epoch_1.ckpt", "cpu"))
        mix = cli._open(os.path.join(data, "mix_0.wav"), 16000)
        out, _ = stream_signal(engine, mix, 16000, half="--half" in flags,
                               fused="--fused" in flags, mk_kernel="--mk_kernel" in flags)
        assert out.shape == (2, 6000)
        for m, tag in enumerate(("near", "far")):
            want = np.clip(out[m] * 32768.0, -32768, 32767).astype(np.int16)
            np.testing.assert_array_equal(got[f"mix_0_{tag}.wav"], want)


def test_cli_trains_the_shipped_config_on_the_cpu(tmp_path, manifest, monkeypatch):
    """`--action train --backend cpu` on dss_dparn_1a.yaml read from its
    file (paths, epochs, workers overridden), a small model: finite losses,
    epoch_0.ckpt reloading strictly."""
    built = []

    def small(hparam, sig_loss=None, *, device=None, generator=None):
        assert isinstance(sig_loss, SDRLoss) and sig_loss.source_aggregated
        built.append(_port("small", sig_loss, torch.float32, device))
        return built[-1]

    monkeypatch.setattr(cli, "build_model", small)
    hp = load_hparam(CONF)
    hp["DATASET"].update(train=manifest, dev=manifest, eval=None, sample_rate=SR,
                         max_length=1)
    hp["TRAIN"].update(num_epochs=1, num_workers=0, batch_size=3, seed=5,
                       use_tensorboard=False, model_save_dir=str(tmp_path / "models"),
                       log_dir=str(tmp_path / "logs"))
    cfg = tmp_path / "c.yaml"
    dump_hparam(hp, str(cfg))
    trainer = cli.main(cli.parse_args([str(cfg), "--action", "train", "--backend", "cpu"]))
    assert isinstance(trainer, dss.DssTask) and trainer.device.type == "cpu"
    tree = torch.load(tmp_path / "models" / "epoch_0.ckpt", weights_only=True)
    fresh = _port("small", dtype=torch.float32)
    fresh.load_state_dict({**tree["params"], **tree["batch_stats"]}, strict=True)
    assert all(torch.isfinite(p).all() for p in fresh.parameters())


def test_cli_needs_a_ckpt_and_unported_actions_raise(tmp_path):
    cfg = tmp_path / "c.yaml"
    dump_hparam(_hp(str(tmp_path), tmp_path / "models"), str(cfg))
    # export_model is ported: like every action but train it needs --ckpt
    for action in ("dev", "eval", "stream_eval", "serve", "export_model"):
        with pytest.raises(ValueError, match="--ckpt is required"):
            cli.main(cli.parse_args([str(cfg), "--action", action, "--backend", "cpu"]))
    with pytest.raises(ValueError, match="--action train"):
        cli.main(cli.parse_args([str(cfg), "--action", "dev", "--num_processes", "2"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--backend cpu"):
            cli.main(cli.parse_args([str(cfg), "--action", "eval", "--ckpt", "x"]))
