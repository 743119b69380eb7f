"""Port parity, the small public helpers: `length_to_mask`
(nnet/lobe/pooling.py:17), `LambdaLayer` (nnet/lobe/trivial.py:19),
`str2bool` / `str2list` (src/utils.py:15, :19), `AudioIO.audio_cut`
(src/audio.py:88) and `TensorboardWriter.add_ep_picture` /
`update_ep_metric` (tasks/base.py:68, :96), each against JAX's."""
import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.lobe import pooling as j_pool
from puresound_tpu.nnet.lobe import trivial as j_triv
from puresound_tpu.src import audio as j_audio
from puresound_tpu.src import utils as j_utils
from puresound_tpu.tasks import base as j_base
from puresound_tpu_torch.nnet.lobe import pooling as t_pool
from puresound_tpu_torch.nnet.lobe import trivial as t_triv
from puresound_tpu_torch.src import audio as t_audio
from puresound_tpu_torch.src import utils as t_utils
from puresound_tpu_torch.tasks import base as t_base

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("lengths,max_len", [([3, 0, 5], 5), ([0.5, 2.25, 7.0], 6),
                                             ([1], 1)])
def test_length_to_mask(lengths, max_len):
    want = np.asarray(j_pool.length_to_mask(jnp.asarray(lengths), max_len))
    got = t_pool.length_to_mask(torch.tensor(lengths), max_len)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kwargs", [{}, {"scale": 3.0}])
def test_lambda_layer(rng, kwargs):
    fn = lambda x, scale=1.0: scale * x ** 2 - 1
    x = rng.standard_normal((2, 3))
    want = np.asarray(j_triv.LambdaLayer(fn=fn).apply({}, jnp.asarray(x), **kwargs))
    layer = t_triv.LambdaLayer(fn)
    assert isinstance(layer, torch.nn.Module) and not list(layer.parameters())
    np.testing.assert_allclose(layer(torch.from_numpy(x), **kwargs).numpy(), want,
                               rtol=1e-6)


@pytest.mark.parametrize("v", ["true", "True", "YES", "yes", "no", "1", "false", ""])
def test_str2bool(v):
    assert t_utils.str2bool(v) is j_utils.str2bool(v)


@pytest.mark.parametrize("s", [" a b  c ", "", "one", "x\ty\nz"])
def test_str2list(s):
    assert t_utils.str2list(s) == j_utils.str2list(s)


@pytest.mark.parametrize("shape,seconds", [((800,), 0.25), ((3000,), 0.25), ((2, 3000), 0.1),
                                           ((1, 2000), 0.125)],
                         ids=["pad-1d", "cut-1d", "cut-2ch", "exact"])
def test_audio_cut(rng, shape, seconds):
    wav = rng.standard_normal(shape).astype(np.float32)
    random.seed(7)
    want, want_span = j_audio.AudioIO.audio_cut(wav, 16000, seconds)
    random.seed(7)
    got, got_span = t_audio.AudioIO.audio_cut(wav, 16000, seconds)
    assert got_span == want_span
    assert got.dtype == want.dtype and got.shape == want.shape == (
        1 if len(shape) == 1 else shape[0], int(16000 * seconds))
    np.testing.assert_array_equal(got, want)


class _Recorder:
    """A SummaryWriter stand-in: records add_scalar / add_figure calls (a
    figure as its image array)."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, scalar_value, global_step=None):
        self.calls.append(("scalar", tag, float(scalar_value), global_step))

    def add_figure(self, tag, figure, global_step=None):
        self.calls.append(("figure", tag, np.asarray(figure.axes[0].images[0].get_array()),
                           global_step))


def _write(mod, folder, method, tf: bool, *args, **kwargs):
    writer = mod.TensorboardWriter(str(folder))
    if writer.tf_writer is not None:
        writer.tf_writer.close()
    writer.tf_writer = _Recorder() if tf else None
    getattr(writer, method)(*args, **kwargs)
    writer._jsonl.close()
    lines = [json.loads(l) for l in (folder / "metrics.jsonl").read_text().splitlines()]
    return lines, (writer.tf_writer.calls if tf else None)


def _same_calls(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[-1] == w[-1]
        np.testing.assert_array_equal(g[2], w[2])


@pytest.mark.parametrize("tf", [True, False], ids=["tensorboard", "none"])
@pytest.mark.parametrize("method", ["update_ep_metric", "add_ep_picture", "add_ep_picture_lin"])
def test_writer_methods(tmp_path, rng, method, tf):
    """The same tensorboard calls and metrics.jsonl lines as JAX's writer;
    without tensorboard the picture is a no-op, the metric a jsonl line."""
    if method == "update_ep_metric":
        args, kwargs = (), dict(tag="dev/si_snr", scalar_value=12.5, global_step=3)
    else:
        pic = np.abs(rng.standard_normal((2, 4, 5)))
        args, kwargs = ("spec", pic, 2), dict(log=method == "add_ep_picture")
        method = "add_ep_picture"
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _write(j_base, tmp_path / "j", method, tf, *args, **kwargs)
    got = _write(t_base, tmp_path / "t", method, tf, *args, **kwargs)
    assert got[0] == want[0]
    if tf:
        _same_calls(got[1], want[1])
