"""Port parity, SkiM: offline forward, per-frame streaming and the fused
streaming step (plain route on the CPU) against the JAX SkiM in float64,
state by state across segment boundaries. Bar: atol 1e-8, rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet import skim as j_skim
from puresound_tpu_torch.nnet import skim as t_skim
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.utils.tree import tree_leaves

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
KW = dict(input_size=16, hidden_size=24, output_size=16, n_blocks=3,
          seg_size=8, seg_overlap=False, causal=True, embed_dim=8,
          embed_norm=True, embed_fusion="FiLM")
BLOCKS = (1, 0, 1)


def _perturbed_f64(tree, rng):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + 0.1 * rng.standard_normal(np.shape(a)), jax.device_get(tree))


@pytest.fixture
def models(rng):
    """(JAX SkiM, its f64 variables, the port's f64 SkiM with them)."""
    jm = j_skim.SkiM(**KW, block_with_embed=BLOCKS)
    x = jnp.zeros((2, 16, 8))
    v = _perturbed_f64(jm.init(KEY, x, jnp.ones((2, 8))), rng)
    tm = t_skim.SkiM(**KW, block_with_embed=BLOCKS, dtype=torch.float64)
    tm.load_state_dict(fj.to_torch(fj.skim(v["params"])), strict=True)
    return jm, v, tm.eval()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _assert_states_equal(pstate, jstate):
    assert pstate["frame_count"] == int(jstate["frame_count"])
    for key in ("seg_h", "seg_c", "mem_h", "mem_c"):
        got, want = tree_leaves(pstate[key]), jax.tree_util.tree_leaves(jstate[key])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.detach().numpy(), w)


@pytest.mark.parametrize("T", [37, 40])
def test_offline_matches_jax(models, rng, T):
    jm, v, tm = models
    x = rng.standard_normal((2, 16, T))
    e = rng.standard_normal((2, 8))
    with jax.enable_x64(True):
        want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(e)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(e)).numpy()
    _close(got, want)


@pytest.mark.parametrize("route", ["step_frames", "step_frames_fused"])
def test_streaming_matches_jax_state_by_state(models, rng, route):
    """4 chunks of 4 frames with seg_size 8: two MemLSTM boundary updates.
    Both port routes are held to JAX's per-frame `step_frames`."""
    jm, v, tm = models
    B, F = 3, 4
    frames = rng.standard_normal((B, 4 * F, 16))
    e = rng.standard_normal((B, 8))
    pstate = tm.init_state(B, torch.float64)
    step = getattr(tm, route)
    with jax.enable_x64(True):
        jstate = jm.apply(v, B, jnp.float64, method=j_skim.SkiM.init_state)
        for k in range(4):
            chunk = frames[:, k * F:(k + 1) * F]
            want, jstate = jm.apply(v, jnp.asarray(chunk), jnp.asarray(e),
                                    jstate, method=j_skim.SkiM.step_frames)
            with torch.no_grad():
                got, pstate = step(torch.from_numpy(chunk),
                                   torch.from_numpy(e), pstate)
            _close(got.numpy(), want)
            _assert_states_equal(pstate, jstate)


def test_port_streamed_equals_port_offline(models, rng):
    """Counterpart of tests/test_streaming.py:71 for the fused route."""
    _, _, tm = models
    B, T, F = 2, 32, 4
    x = rng.standard_normal((B, 16, T))
    e = torch.from_numpy(rng.standard_normal((B, 8)))
    with torch.no_grad():
        offline = tm(torch.from_numpy(x), e)
        state = tm.init_state(B, torch.float64)
        outs = []
        frames = torch.from_numpy(x).transpose(1, 2)
        for k in range(T // F):
            y, state = tm.step_frames_fused(frames[:, k * F:(k + 1) * F], e,
                                            state)
            outs.append(y)
    _close(torch.cat(outs, -1).numpy(), offline.numpy())


@pytest.mark.parametrize("part", ["seg_lstm", "mem_lstm_offline", "mem_lstm_step"])
def test_seg_and_mem_lstm_match_jax(rng, part):
    C, H, B, S = 6, 5, 3, 4
    if part == "seg_lstm":
        jm = j_skim.SegLSTM(C, H)
        x = rng.standard_normal((B, 7, C))
        h0 = rng.standard_normal((1, B, H))
        c0 = rng.standard_normal((1, B, H))
        args = (x, h0, c0)
        tm = t_skim.SegLSTM(C, H, dtype=torch.float64)
        conv = fj.seg_lstm
    else:
        jm = j_skim.MemLSTM(H)
        tm = t_skim.MemLSTM(H, dtype=torch.float64)
        conv = fj.mem_lstm
        if part == "mem_lstm_offline":
            args = (rng.standard_normal((2, S, 1, H)),
                    rng.standard_normal((2, S, 1, H)))
        else:
            st = lambda: (rng.standard_normal((1, B, H)),
                          rng.standard_normal((1, B, H)))
            args = (rng.standard_normal((B, 1, H)),
                    rng.standard_normal((B, 1, H)), st(), st())
    method = j_skim.MemLSTM.step if part == "mem_lstm_step" else None
    jargs = jax.tree_util.tree_map(jnp.asarray, args)
    init_args = (jargs if part == "seg_lstm"
                 else (jnp.zeros((1, S, 1, H)), jnp.zeros((1, S, 1, H))))
    v = _perturbed_f64(jm.init(KEY, *init_args), rng)
    with jax.enable_x64(True):
        want = jm.apply(v, *jax.tree_util.tree_map(jnp.asarray, args),
                        method=method)
    tm.load_state_dict(fj.to_torch(conv(v["params"])), strict=True)
    targs = jax.tree_util.tree_map(torch.from_numpy, args)
    with torch.no_grad():
        got = tm.step(*targs) if part == "mem_lstm_step" else tm(*targs)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(g.numpy(), w)
