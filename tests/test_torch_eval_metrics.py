"""Port parity, the evaluation actions' host code against the JAX package on
the CPU, inputs from numpy seeds:

- `src/metrics.py`: every `Metrics` method and the module's STOI /
  BSS-eval SDR functions equal JAX's bit for bit (the same float64 /
  float32 values) on the same arrays, silent and short inputs included;
- `egs/tse/local/binarize.py`: `Binarize` in both modes and its helpers
  equal JAX's recipe's bit for bit;
- `src/flac.py`: FLAC files written here (16-bit, verbatim and fixed
  predictor subframes of orders 0-4, mono and stereo in the independent,
  left-side, right-side and mid-side modes, a short last block) decode to
  the samples written, bit for bit against JAX's `read_flac` and the native
  decoder of `csrc/` where it loads; `AudioIO` reads FLAC without the
  native library;
- `tasks/batch_eval.py`: the cases of tests/test_batch_eval.py on tensors,
  and a small causal TSE model batched against one utterance at a time.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from puresound_tpu.src import flac as jflac
from puresound_tpu.src import metrics as jmetrics
from puresound_tpu_torch.egs.tse.local import binarize as tbin
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.src import audio, flac, metrics, native
from puresound_tpu_torch.tasks.batch_eval import BucketedBatchRunner, quantize_length

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_binarize():
    spec = importlib.util.spec_from_file_location(
        "jax_recipe_binarize", os.path.join(ROOT, "egs", "tse", "local", "binarize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(got, want):
    """Equal values of the same type, NaN where NaN (bit for bit)."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _signals(rng, n=16000, f32=True):
    t = np.arange(n) / 16000
    clean = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    noisy = clean + 0.1 * rng.standard_normal(n)
    enh = clean + 0.03 * rng.standard_normal(n)
    dt = np.float32 if f32 else np.float64
    return clean.astype(dt)[None], noisy.astype(dt)[None], enh.astype(dt)[None]


@pytest.mark.parametrize("method", ["sisnr", "stoi", "bss_sdr", "noise_reduction",
                                    "pesq_nb", "check_shape"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "f64"])
def test_metrics_match_jax_bit_for_bit(rng, method, f32):
    clean, noisy, enh = _signals(rng, f32=f32)
    fn = lambda m: getattr(m.Metrics, method)
    args = (noisy, enh) if method == "noise_reduction" else (clean, enh[..., :15000])
    _same(fn(metrics)(*args), fn(jmetrics)(*args))


def test_pesq_wb_sisnr_imp_and_the_functions_match_jax(rng):
    clean, noisy, enh = _signals(rng)
    for name in ("pesq_wb",):
        _same(getattr(metrics.Metrics, name)(clean, enh),
              getattr(jmetrics.Metrics, name)(clean, enh))
    _same(metrics.Metrics.sisnr_imp(clean, enh, noisy),
          jmetrics.Metrics.sisnr_imp(clean, enh, noisy))
    _same(metrics.stoi(clean[0], enh[0], 8000), jmetrics.stoi(clean[0], enh[0], 8000))
    _same(metrics.bss_eval_sdr(clean, enh, 64), jmetrics.bss_eval_sdr(clean, enh, 64))
    # too short for STOI / PESQ: the same errors
    for mod in (metrics, jmetrics):
        with pytest.raises(ValueError):
            mod.Metrics.stoi(clean[..., :2000], enh[..., :2000])
        with pytest.raises(ValueError):
            mod.Metrics.pesq_wb(clean[..., :2000], enh[..., :2000])


def test_f1_score_and_silent_signals_match_jax(rng):
    truth = (rng.random((1, 4000)) > 0.4).astype(np.float32)
    pred = (rng.random((1, 4000)) > 0.5).astype(np.float32)
    _same(metrics.Metrics.f1_score(truth, pred), jmetrics.Metrics.f1_score(truth, pred))
    zeros = np.zeros((1, 4000), np.float32)
    _same(metrics.Metrics.f1_score(zeros, pred), jmetrics.Metrics.f1_score(zeros, pred))
    with np.errstate(all="ignore"):
        _same(metrics.Metrics.sisnr(zeros, pred), jmetrics.Metrics.sisnr(zeros, pred))
        _same(metrics.Metrics.check_shape(zeros, pred), jmetrics.Metrics.check_shape(zeros, pred))


@pytest.mark.parametrize("mode,stability", [("asteroid", 0.1), ("asteroid", 0.01),
                                            ("moving_average", 0.05)])
def test_binarize_matches_jax_recipe(rng, mode, stability):
    jbin = _jax_binarize()
    # probabilities with runs of several lengths, some shorter than the
    # stability window
    runs = rng.integers(5, 400, 40)
    levels = rng.random(40)
    x = np.concatenate([np.full(n, v) for n, v in zip(runs, levels)])[None]
    x = np.concatenate([x, x[:, ::-1]]).astype(np.float32)
    for shape in (x, x[:, None]):
        got = tbin.Binarize(0.5, stability, 8000, mode)(shape)
        want = jbin.Binarize(0.5, stability, 8000, mode)(shape)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    active = (x > 0.5).astype(np.int64).tolist()
    assert tbin.count_same_pair(active) == jbin.count_same_pair(active)
    with pytest.raises(NotImplementedError):
        tbin.Binarize(mode="other")(x)


# --------------------------------------------------------------------- FLAC
def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


class _Bits:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        value &= (1 << n) - 1
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def rice(self, r: int, k: int):
        u = 2 * r if r >= 0 else -2 * r - 1
        self.bits += [0] * (u >> k) + [1]
        self.put(u & ((1 << k) - 1), k)

    def bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


_FIXED = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _subframe(bits: _Bits, x: np.ndarray, bps: int, kind):
    """A verbatim subframe, or a fixed-predictor one of order `kind`
    (residuals in one rice partition)."""
    if kind == "verbatim":
        bits.put(0b00000010, 8)
        for v in x:
            bits.put(int(v), bps)
        return
    order = kind
    bits.put((8 + order) << 1, 8)
    for v in x[:order]:
        bits.put(int(v), bps)
    res = [int(x[i]) - sum(c * int(x[i - 1 - j]) for j, c in enumerate(_FIXED[order]))
           for i in range(order, len(x))]
    k = max(0, min(14, int(np.log2(np.mean(np.abs(res)) + 1))))
    bits.put(0, 2)   # rice, 4-bit parameters
    bits.put(0, 4)   # partition order 0
    bits.put(k, 4)
    for r in res:
        bits.rice(r, k)


def _write_flac(path: str, chans: np.ndarray, sr: int, block: int, modes, kinds):
    """16-bit FLAC of int samples [channels, n]: one frame per block, frame
    i in channel mode modes[i % len] with subframes kinds[i % len]."""
    n_ch, total = chans.shape
    info = _Bits()
    for v, n in ((block, 16), (block, 16), (0, 24), (0, 24), (sr, 20), (n_ch - 1, 3),
                 (15, 5), (total, 36)):
        info.put(v, n)
    body = info.bytes() + bytes(16)
    out = b"fLaC" + bytes([0x80]) + len(body).to_bytes(3, "big") + body
    sr_code = {8000: 4, 16000: 5}[sr]
    for i, start in enumerate(range(0, total, block)):
        blk = chans[:, start:start + block].astype(np.int64)
        n = blk.shape[1]
        mode = modes[i % len(modes)]
        if mode == "left_side":
            subs, extra, code = [blk[0], blk[0] - blk[1]], (0, 1), 8
        elif mode == "right_side":
            subs, extra, code = [blk[0] - blk[1], blk[1]], (1, 0), 9
        elif mode == "mid_side":
            subs, extra, code = [(blk[0] + blk[1]) >> 1, blk[0] - blk[1]], (0, 1), 10
        else:
            subs, extra, code = list(blk), (0,) * n_ch, n_ch - 1
        head = _Bits()
        head.put(0x3FFE, 14)
        head.put(0, 2)
        head.put(7, 4)          # block size: 16 bits at the end of the header
        head.put(sr_code, 4)
        head.put(code, 4)
        head.put(4, 3)          # 16 bits a sample
        head.put(0, 1)
        assert i < 128
        head.put(i, 8)          # frame number, one UTF-8 byte
        head.put(n - 1, 16)
        hb = head.bytes()
        hb += bytes([_crc8(hb)])
        sub = _Bits()
        for c, x in enumerate(subs):
            _subframe(sub, x, 16 + extra[c], kinds[(i + c) % len(kinds)])
        frame = hb + sub.bytes()
        out += frame + _crc16(frame).to_bytes(2, "big")
    with open(path, "wb") as f:
        f.write(out)


@pytest.mark.parametrize("n_ch,modes", [(1, ["independent"]),
                                        (2, ["independent", "left_side", "right_side",
                                             "mid_side"])], ids=["mono", "stereo"])
def test_flac_decoder_matches_jax_and_native(tmp_path, rng, n_ch, modes):
    total = 1500
    t = np.arange(total)
    chans = np.stack([np.round(9000 * np.sin(2 * np.pi * (0.01 + 0.003 * c) * t)
                               + rng.normal(0, 300, total)) for c in range(n_ch)])
    chans = np.clip(chans, -32768, 32767).astype(np.int64)
    path = str(tmp_path / "x.flac")
    _write_flac(path, chans, 16000, 192, modes, ["verbatim", 0, 1, 2, 3, 4])
    got, sr = flac.read_flac(path)
    want, jsr = jflac.read_flac(path)
    assert sr == jsr == 16000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (chans / 32768.0).astype(np.float32))
    if native.available():
        nat, nsr = native.read_flac(path)
        assert nsr == 16000
        np.testing.assert_array_equal(got, nat)


def test_audio_reads_flac_without_the_native_library(tmp_path, rng, monkeypatch):
    chans = rng.integers(-20000, 20000, (1, 700))
    path = str(tmp_path / "y.flac")
    _write_flac(path, chans, 8000, 256, ["independent"], [2, "verbatim"])
    monkeypatch.setattr(native, "available", lambda: False)
    wav, sr = audio.AudioIO.open(path)
    assert sr == 8000
    np.testing.assert_array_equal(wav, (chans / 32768.0).astype(np.float32))


# --------------------------------------------------------------- batch eval
def test_quantize_length():
    assert quantize_length(1, 100) == 100
    assert quantize_length(100, 100) == 100
    assert quantize_length(101, 100) == 200
    assert quantize_length(250, 100) == 300
    with pytest.raises(ValueError):
        quantize_length(10, 0)


def test_runner_order_buckets_and_slicing(rng):
    """Items come back in submission order with their true lengths, in the
    expected buckets; zero padding + a causal fn is exact."""
    shapes_seen = []

    def fn(x):
        assert isinstance(x, torch.Tensor)
        shapes_seen.append(tuple(x.shape))
        return torch.cumsum(x, dim=-1)

    runner = BucketedBatchRunner(fn, batch_size=2, quantum=100, pad_modes=("zero",))
    lengths = [37, 150, 98, 205, 140, 60, 101]
    items = [(rng.standard_normal((1, L)).astype(np.float32),) for L in lengths]
    outs = runner.run(items)
    assert len(outs) == len(items)
    for (x,), o, L in zip(items, outs, lengths):
        assert isinstance(o, np.ndarray) and o.shape == (L,)
        np.testing.assert_allclose(o, np.cumsum(x, axis=-1)[0], rtol=1e-5, atol=1e-6)
    assert sorted(runner.bucket_keys) == [(100,), (200,), (300,)]
    assert set(shapes_seen) == {(2, 100), (2, 200), (2, 300)}


def test_runner_tile_pad_and_multi_input():
    def fn(x, e):
        return x + e.mean(dim=-1, keepdim=True)

    runner = BucketedBatchRunner(fn, batch_size=4, quantum=100, pad_modes=("zero", "tile"))
    x = np.ones((1, 80), np.float32)
    e = np.arange(50, dtype=np.float32)[None]  # tiles 2x into bucket 100
    (out,) = runner.run([(x, e)])
    np.testing.assert_allclose(out, (x + e.mean())[0], rtol=1e-6)
    with pytest.raises(ValueError):  # arity mismatch
        runner.run([(x,)])
    with pytest.raises(ValueError):  # unknown pad mode
        BucketedBatchRunner(fn, pad_modes=("zero", "wrap")).run([(x, e)])
    with pytest.raises(ValueError):  # quanta / pad_modes length mismatch
        BucketedBatchRunner(fn, quantum=(100,), pad_modes=("zero", "tile"))
    with pytest.raises(ValueError):
        BucketedBatchRunner(fn, batch_size=0)


def test_runner_per_input_quanta():
    runner = BucketedBatchRunner(lambda x, e: x, batch_size=2, quantum=(100, 400),
                                 pad_modes=("zero", "tile"))
    items = [(np.ones((1, 90), np.float32), np.ones((1, 150 + 7 * i), np.float32))
             for i in range(5)]
    runner.run(items)
    assert runner.bucket_keys == [(100, 400)]


def test_runner_no_out_slice():
    runner = BucketedBatchRunner(
        lambda x: torch.stack([x.sum(-1), x.max(-1).values], -1), batch_size=3,
        quantum=10, pad_modes=("zero",), out_slice_axis=None)
    items = [(np.full((1, L), i + 1, np.float32),) for i, L in enumerate([5, 17, 9])]
    outs = runner.run(items)
    for i, (o, L) in enumerate(zip(outs, [5, 17, 9])):
        assert o.shape == (2,)
        np.testing.assert_allclose(o[0], (i + 1) * L, rtol=1e-6)


def _small_tse():
    C, E = 24, 8
    spk = ([TCN(C, 16, 3, dilation=1, tcn_norm="gLN", dconv_norm="gGN")]
           + [AttentiveStatisticsPooling(C, 16), Conv1d(2 * C, E, 1, bias=False)])
    return SoTaskWrapModule(
        FreeEncDec(win_length=32, hop_length=16, laten_length=C, output_active=True,
                   generator=torch.Generator().manual_seed(1)),
        SkiM(input_size=C, hidden_size=16, output_size=C, n_blocks=2, seg_size=10,
             seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
             embed_fusion="FiLM", block_with_embed=(1, 1),
             generator=torch.Generator().manual_seed(2)),
        spk, mask_constraint="ReLU").eval()


def test_batch_eval_matches_per_utterance_tse(rng):
    """A causal TSE model batched in buckets == one utterance at a time,
    away from the padded tail's overlap-add window; enrollments on the grid,
    so tiling is a no-op."""
    model = _small_tse()
    quantum, win = 640, 32
    lengths = [500, 640, 1000, 1100]
    items = [(0.1 * rng.standard_normal((1, L)).astype(np.float32),
              0.1 * rng.standard_normal((1, quantum)).astype(np.float32)) for L in lengths]
    with torch.inference_mode():
        runner = BucketedBatchRunner(model.inference, batch_size=2, quantum=quantum,
                                     pad_modes=("zero", "tile"), device="cpu")
        outs = runner.run(items)
        refs = [model.inference(torch.from_numpy(x), torch.from_numpy(e))[0].numpy()
                for x, e in items]
    assert sorted(runner.bucket_keys) == [(640, 640), (1280, 640)]
    for o, ref, L in zip(outs, refs, lengths):
        assert o.shape[-1] == L
        np.testing.assert_allclose(o[..., :L - win], ref[..., :L - win], atol=1e-4, rtol=1e-3)
