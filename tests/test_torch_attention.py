"""`MhaSelfAttenLayer(improved=True)` (DPTNet's block: the LSTM
feed-forward, no positions) against JAX's
(`puresound_tpu/nnet/lobe/attention.py:103-158`) in float64:

- forward and every parameter's gradient of sum(out * w), uni- and
  bidirectional, unmasked / causal / context-range / causal context-range,
  within atol 1e-8 / rtol 1e-6;
- the attention weights it returns;
- `from_jax` of its variables (the LSTM's four tensors a direction and
  `ff2`) loading into the port's layer, strict;
- dropout in training mode draws from the layer's generator (two layers
  of one seed agree, eval is the identity).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.lobe.attention import MhaSelfAttenLayer as JLayer
from puresound_tpu_torch.nnet.lobe.attention import MhaSelfAttenLayer
from puresound_tpu_torch.utils import from_jax as fj

torch.set_num_threads(1)

C, HID, HEADS, N, T = 16, 12, 4, 3, 9
ATOL, RTOL = 1e-8, 1e-6
MASKS = {"none": (False, None), "causal": (True, None), "context": (False, 4),
         "causal context": (True, 3)}


def _pair(bidirectional: bool):
    jl = JLayer(C, HID, HEADS, improved=True, bidirectional=bidirectional)
    with jax.enable_x64(True):
        v = jl.init(jax.random.PRNGKey(0), jnp.zeros((1, C, T), jnp.float64))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jax.device_get(v))
    pl = MhaSelfAttenLayer(C, HID, HEADS, improved=True, bidirectional=bidirectional,
                           dtype=torch.float64)
    pl.load_state_dict(fj.to_torch(fj.mha_self_atten_layer(v["params"])), strict=True)
    return jl, v, pl.eval()


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("bidirectional", [False, True])
def test_improved_layer_forward_and_gradients_match_jax(rng, bidirectional, mask):
    causal, context = MASKS[mask]
    jl, v, pl = _pair(bidirectional)
    x = rng.standard_normal((N, C, T))
    w = rng.standard_normal((N, C, T))

    def jloss(params, a):
        y, att = jl.apply({"params": params}, a, causal=causal, context_range=context,
                          return_atten_weight=True)
        return jnp.sum(y * w), (y, att)

    with jax.enable_x64(True):
        (_, (jy, jatt)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            v["params"], jnp.asarray(x))
        jy, jatt = np.asarray(jy), np.asarray(jatt)
        jg = fj.mha_self_atten_layer(jax.tree_util.tree_map(np.asarray, jg))
    y, att = pl(torch.from_numpy(x), causal=causal, context_range=context,
                return_atten_weight=True)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), jy, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(att.detach().numpy(), jatt, atol=ATOL, rtol=RTOL)
    grads = {n: p.grad.numpy() for n, p in pl.named_parameters()}
    assert set(grads) == set(jg)
    for n, g in grads.items():
        np.testing.assert_allclose(g, jg[n], atol=ATOL, rtol=RTOL, err_msg=n)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_from_jax_of_the_improved_layer(bidirectional):
    _, v, pl = _pair(bidirectional)
    flat = fj.mha_self_atten_layer(v["params"])
    d = 2 if bidirectional else 1
    assert sum(k.startswith("recurrent.") for k in flat) == 4 * d
    assert flat["ff2.weight"].shape == (C, d * HID)
    assert flat["recurrent.weight_ih_l0"].shape == (4 * HID, C)
    assert "pos" not in dict(pl.named_children())
    assert sorted(flat) == sorted(pl.state_dict())


def test_improved_layer_dropout_draws_from_its_generator(rng):
    mk = lambda: MhaSelfAttenLayer(C, HID, HEADS, dropout=0.3, improved=True,
                                   generator=torch.Generator().manual_seed(5)).train()
    a, b = mk(), mk()
    x = torch.from_numpy(rng.standard_normal((N, C, T)).astype(np.float32))
    assert torch.equal(a(x), b(x))
    a.eval()
    plain = MhaSelfAttenLayer(C, HID, HEADS, dropout=0.0, improved=True,
                              generator=torch.Generator().manual_seed(5)).eval()
    assert torch.equal(a(x), plain(x))
