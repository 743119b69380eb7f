"""Port parity, `SkiM.step_chunk` (one segment a call: a K-frame SegLSTM
scan a block, then the MemLSTM update) against JAX's
(puresound_tpu/nnet/skim.py:345) in float64, segment by segment and state by
state, at the widths of tests/test_streaming.py:_skim_kw (FiLM, Gate and
unconditioned; T = 50 and 57, the last segment padded); against the port's
`step_frames` and offline forward; a stream that takes turns between the two
steps at segment boundaries; the refusals. Bar: atol 1e-8, rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet import skim as j_skim
from puresound_tpu_torch.nnet import skim as t_skim
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.utils.tree import tree_leaves

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
B, C, E, K = 2, 12, 8, 10


def _kw(fusion):
    """tests/test_streaming.py:_skim_kw, its conditioning by `fusion`."""
    kw = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=3, seg_size=K,
              seg_overlap=False, causal=True)
    if fusion is None:
        return kw
    return dict(kw, embed_dim=E, embed_norm=True, embed_fusion=fusion,
                block_with_embed=(1, 0, 1))


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=what)


def _models(fusion, rng):
    """(JAX SkiM, its float64 variables moved off init, the port's float64
    SkiM with them)."""
    jm = j_skim.SkiM(**_kw(fusion))
    e = jnp.ones((B, E)) if fusion else None
    v = jm.init(KEY, jnp.zeros((B, C, K)), e)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64)
                               + 0.1 * rng.standard_normal(np.shape(a)), jax.device_get(v))
    tm = t_skim.SkiM(**_kw(fusion), dtype=torch.float64)
    tm.load_state_dict(fj.to_torch(fj.skim(v["params"])), strict=True)
    return jm, v, tm.eval()


def _inputs(fusion, T, rng):
    x = rng.standard_normal((B, C, T))
    e = rng.standard_normal((B, E)) if fusion else None
    T_pad = -(-T // K) * K
    frames = np.pad(x, ((0, 0), (0, 0), (0, T_pad - T))).transpose(0, 2, 1)
    return x, e, frames


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _chunks(tm, frames, e, steps):
    """The port's stream over `frames` [B, T, C], one call a step from
    `steps` ("chunk": one segment; an int: that many frames of
    `step_frames`) in turn; returns (y [B, C, T], state)."""
    state = tm.init_state(B, torch.float64)
    outs, i, k = [], 0, 0
    with torch.no_grad():
        while i < frames.shape[1]:
            step = steps[k % len(steps)]
            n = K if step == "chunk" else step
            fn = tm.step_chunk if step == "chunk" else tm.step_frames
            y, state = fn(_t(frames[:, i:i + n]), _t(e), state)
            outs.append(y)
            i, k = i + n, k + 1
    return torch.cat(outs, -1), state


FUSIONS = {"film": "FiLM", "gate": "Gate", "none": None}


@pytest.mark.parametrize("T", [50, 57])
@pytest.mark.parametrize("fusion", list(FUSIONS))
def test_step_chunk_matches_jax_state_by_state(rng, fusion, T):
    fusion = FUSIONS[fusion]
    jm, v, tm = _models(fusion, rng)
    _, e, frames = _inputs(fusion, T, rng)
    with jax.enable_x64(True):
        embed = None if e is None else jnp.asarray(e)
        step = jax.jit(lambda v, x, st: jm.apply(v, x, embed, st,
                                                 method=j_skim.SkiM.step_chunk))
        jv = jax.tree_util.tree_map(jnp.asarray, v)
        jstate = jm.apply(v, B, jnp.float64, method=j_skim.SkiM.init_state)
        pstate = tm.init_state(B, torch.float64)
        for s in range(frames.shape[1] // K):
            seg = frames[:, s * K:(s + 1) * K]
            want, jstate = step(jv, jnp.asarray(seg), jstate)
            with torch.no_grad():
                got, pstate = tm.step_chunk(_t(seg), _t(e), pstate)
            assert got.shape == (B, C, K)
            _close(got, want, f"segment {s}")
            # the port's clock advances a segment; JAX's step_chunk leaves it
            assert pstate["frame_count"] == (s + 1) * K
            for key in ("seg_h", "seg_c", "mem_h", "mem_c"):
                for g, w in zip(tree_leaves(pstate[key]), jax.tree_util.tree_leaves(jstate[key]),
                                strict=True):
                    _close(g, w, f"segment {s} {key}")


@pytest.mark.parametrize("T", [50, 57])
@pytest.mark.parametrize("fusion", ["film", "none"])
def test_step_chunk_matches_port_step_frames_and_offline(rng, fusion, T):
    """tests/test_streaming.py:71-113 for the port: step_chunk == step_frames
    (13 frames a call) == the offline forward, and the two streams end in the
    same state."""
    fusion = FUSIONS[fusion]
    _, _, tm = _models(fusion, rng)
    x, e, frames = _inputs(fusion, T, rng)
    y_chunk, st_chunk = _chunks(tm, frames, e, ["chunk"])
    y_frames, st_frames = _chunks(tm, frames, e, [13])
    with torch.no_grad():
        offline = tm(_t(x), _t(e))
    _close(y_chunk[..., :T], offline)
    _close(y_chunk, y_frames)
    assert st_chunk["frame_count"] == st_frames["frame_count"] == frames.shape[1]
    for g, w in zip(tree_leaves(st_chunk), tree_leaves(st_frames), strict=True):
        _close(g, w)


@pytest.mark.parametrize("steps", [["chunk", 10], ["chunk", 4, 6, "chunk"], [3, 7, "chunk"]],
                         ids=["chunk-frames", "chunk-4-6", "3-7-chunk"])
def test_mixed_stream_matches_step_frames(rng, steps):
    """step_chunk and step_frames taking turns at segment boundaries on one
    stream == the step_frames stream."""
    _, _, tm = _models("FiLM", rng)
    _, e, frames = _inputs("film", 60, rng)
    mixed, st_mixed = _chunks(tm, frames, e, steps)
    want, st_want = _chunks(tm, frames, e, [1])
    _close(mixed, want)
    for g, w in zip(tree_leaves(st_mixed), tree_leaves(st_want), strict=True):
        _close(g, w)


def test_seg_lstm_state_serves_both_layouts(rng):
    """A stream's carried SegLSTM h / c (state["seg_h"][i], [1, B, H]) start
    a K-frame scan alike through the batch-major and the time-major entry
    (`lstm_scan_train_fp` and its `_tm`)."""
    _, _, tm = _models("FiLM", rng)
    _, e, frames = _inputs("film", 30, rng)
    _, state = _chunks(tm, frames[:, :20], e, ["chunk"])
    seg = frames[:, 20:30]
    with torch.no_grad():
        for i, block in enumerate(tm.seg_lstm):
            h, c = state["seg_h"][i], state["seg_c"][i]
            y, hT, cT = block(_t(seg), h, c)
            y_t, hT_t, cT_t = block.call_tm(_t(seg).transpose(0, 1), h, c)
            _close(y_t.transpose(0, 1), y)
            _close(hT_t, hT)
            _close(cT_t, cT)


def test_step_chunk_refusals(rng):
    _, _, tm = _models("FiLM", rng)
    _, e, frames = _inputs("film", 30, rng)
    state = tm.init_state(B, torch.float64)
    with torch.no_grad(), pytest.raises(ValueError, match="one segment"):
        tm.step_chunk(_t(frames[:, :K - 1]), _t(e), state)
    with torch.no_grad():
        _, state = tm.step_frames(_t(frames[:, :3]), _t(e), state)
        with pytest.raises(ValueError, match="segment boundary"):
            tm.step_chunk(_t(frames[:, 3:3 + K]), _t(e), state)
    noncausal = t_skim.SkiM(**dict(_kw("FiLM"), causal=False), dtype=torch.float64)
    with torch.no_grad(), pytest.raises(ValueError, match="causal"):
        noncausal.step_chunk(_t(frames[:, :K]), _t(e), state)
