"""Port parity, the speaker losses and the TSE zoo's `init_loss`, against the
JAX package in float64 (atol 1e-8, rtol 1e-6), inputs from a numpy seed:

- GE2E (softmax and contrast, with and without `add_norm`): the loss and
  its gradients with respect to the d-vectors and to `w` / `b`;
- Triplet (Euclidean, cosine and the "consine" spelling, reduced or not),
  the soft F1 loss, AAM-softmax with JAX's weight carried over, and
  `cross_entropy`: values and input gradients;
- AAM-softmax's init: flax's truncated glorot normal from the explicit
  generator, and torch's global RNG left alone;
- every branch of `zoo.tse.init_loss` on the same inputs as JAX's, the
  GE2E branch's need for contrastive batches, and the losses' output
  dtypes under bfloat16 inputs (JAX's cast points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.loss.aamsoftmax import AAMsoftmax as JAAM
from puresound_tpu.nnet.loss.metrics import F1Loss as JF1
from puresound_tpu.nnet.loss.metrics import GE2ELoss as JGE2E
from puresound_tpu.nnet.loss.metrics import TripletLoss as JTriplet
from puresound_tpu.zoo import tse as jzoo
from puresound_tpu_torch.nnet.loss.aamsoftmax import AAMsoftmax, glorot_truncated_normal
from puresound_tpu_torch.nnet.loss.metrics import F1_loss, F1Loss, GE2ELoss, TripletLoss
from puresound_tpu_torch.zoo import tse as zoo

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

ATOL, RTOL = 1e-8, 1e-6
NSPK, NUTT, D = 3, 4, 16


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=ATOL, rtol=RTOL)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _jax_value_grad(fn, *args):
    """(value, gradients w.r.t. every argument) of a JAX function in f64."""
    with jax.enable_x64(True):
        args = [jax.tree_util.tree_map(jnp.asarray, a) for a in args]
        val, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(*args)
        return np.asarray(val), jax.device_get(grads)


def _port_value_grad(fn, *args):
    ts = [_t(a, True) for a in args]
    val = fn(*ts)
    return val, torch.autograd.grad(val, ts)


@pytest.mark.parametrize("method", ["softmax", "contrast"])
@pytest.mark.parametrize("add_norm", [True, False])
def test_ge2e_matches_jax(rng, method, add_norm):
    dvecs = rng.standard_normal((NSPK * NUTT, D))
    w, b = 10.0 + rng.standard_normal(), -5.0 + rng.standard_normal()
    jloss = JGE2E(nspks=NSPK, putts=NUTT, loss_method=method, add_norm=add_norm)
    want, (jg_x, jg_p) = _jax_value_grad(
        lambda x, p: jloss.apply({"params": p}, x), dvecs,
        {"w": np.float64(w), "b": np.float64(b)})
    loss = GE2ELoss(NSPK, NUTT, loss_method=method, add_norm=add_norm,
                    dtype=torch.float64)
    with torch.no_grad():
        loss.w.fill_(w)
        loss.b.fill_(b)
    x = _t(dvecs, True)
    got = loss(x, None)
    g_x, g_w, g_b = torch.autograd.grad(got, [x, loss.w, loss.b])
    _close(got, want)
    _close(g_x, jg_x)
    _close(g_w, jg_p["w"])
    _close(g_b, jg_p["b"])


def test_ge2e_parameters_and_init():
    loss = GE2ELoss(2, 3, device="cpu")
    assert dict(loss.named_parameters()).keys() == {"w", "b"}
    assert loss.w.shape == () and loss.w.item() == 10.0 and loss.b.item() == -5.0
    with pytest.raises(NameError):
        GE2ELoss(2, 3, loss_method="angular")


@pytest.mark.parametrize("distance", ["Euclidean", "cosine", "consine"])
@pytest.mark.parametrize("reduction", [True, False])
def test_triplet_matches_jax(rng, distance, reduction):
    x = rng.standard_normal((5, 3, D))
    jl = JTriplet(margin=0.3, add_norm=True, distance=distance)
    pl = TripletLoss(margin=0.3, add_norm=True, distance=distance)
    want, (jg,) = _jax_value_grad(lambda a: jnp.sum(jl(a, reduction)), x)
    got, (g,) = _port_value_grad(lambda a: pl(a, reduction).sum(), x)
    _close(got, want)
    _close(g, jg)
    with jax.enable_x64(True):
        _close(pl(_t(x), reduction), jl(jnp.asarray(x), reduction))


def test_f1_matches_jax(rng):
    est = 1 / (1 + np.exp(-rng.standard_normal((3, 200))))
    tgt = (rng.random((3, 200)) > 0.5).astype(np.float64)
    want, (jg, _) = _jax_value_grad(lambda e, t: JF1()(e, t), est, tgt)
    got, (g, _) = _port_value_grad(lambda e, t: F1Loss()(e, t), est, tgt)
    _close(got, want)
    _close(g, jg)
    assert F1_loss is F1Loss


@pytest.mark.parametrize("margin,scale", [(0.2, 30.0), (0.5, 16.0)])
def test_aamsoftmax_matches_jax_with_its_weight(rng, margin, scale):
    n_class = 7
    x = rng.standard_normal((6, D))
    label = rng.integers(0, n_class, 6)
    jl = JAAM(input_dim=D, n_class=n_class, margin=margin, scale=scale)
    with jax.enable_x64(True):
        v = jax.device_get(jl.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(label)))
    weight = np.asarray(v["params"]["weight"], np.float64)
    want, (jg_x, jg_p) = _jax_value_grad(
        lambda a, p: jl.apply({"params": p}, a, jnp.asarray(label)), x, {"weight": weight})
    loss = AAMsoftmax(D, n_class, margin, scale, dtype=torch.float64)
    loss.load_state_dict({"weight": _t(weight)}, strict=True)
    xt = _t(x, True)
    got = loss(xt, torch.from_numpy(label))
    g_x, g_w = torch.autograd.grad(got, [xt, loss.weight])
    _close(got, want)
    _close(g_x, jg_x)
    _close(g_w, jg_p["weight"])


def test_aamsoftmax_init_is_flax_glorot_normal_from_the_generator():
    state = torch.random.get_rng_state()
    a = glorot_truncated_normal((251, 192), torch.Generator().manual_seed(3))
    b = glorot_truncated_normal((251, 192), torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b)
    std = np.sqrt(2.0 / (251 + 192))
    w = a.detach().numpy()
    # truncated at two standard deviations of the untruncated normal
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7
    assert abs(w.std() / std - 1) < 0.02
    with jax.enable_x64(True):
        ref = np.asarray(jax.nn.initializers.xavier_normal()(
            jax.random.PRNGKey(0), (251, 192), jnp.float64))
    assert abs(w.std() / ref.std() - 1) < 0.03
    assert abs(np.abs(w).max() / np.abs(ref).max() - 1) < 0.01
    m = AAMsoftmax(192, 251, generator=torch.Generator().manual_seed(3))
    assert torch.equal(m.weight.detach(), a.detach())


def test_cross_entropy_matches_jax(rng):
    logits = rng.standard_normal((5, 9))
    labels = rng.integers(0, 9, 5)
    want, (jg,) = _jax_value_grad(lambda z: jzoo.cross_entropy(z, jnp.asarray(labels)),
                                  logits)
    got, (g,) = _port_value_grad(lambda z: zoo.cross_entropy(z, torch.from_numpy(labels)),
                                 logits)
    _close(got, want)
    _close(g, jg)


# ---------------------------------------------------------------- init_loss
LOSS = dict(sig_threshold=None, embed_dim=D, n_class=5, margin=0.2, scale=30.0)
TRAIN = dict(contrastive_learning=True, p_spks=NSPK, p_utts=NUTT)
INIT_LOSS_CASES = [
    dict(sig_loss="sisnr"), dict(sig_loss="sdsdr"), dict(sig_loss="sdr"),
    dict(sig_loss="tsdr", sig_threshold=-30), dict(sig_loss="SISNR"),
    dict(sig_loss="sisnr_stft"), dict(sig_loss="sisnr_ov"), dict(sig_loss="f1"),
    dict(sig_loss=None, cls_loss="cross_entropy"),
    dict(sig_loss="sisnr", cls_loss="aamsoftmax"),
    dict(sig_loss=None, cls_loss="ge2e"),
    dict(sig_loss="sisnr", cls_loss="ge2e", cls_loss_other="triplet"),
]


def _hp(case):
    return {"LOSS": {**LOSS, "cls_loss": None, **case}, "TRAIN": dict(TRAIN)}


@pytest.mark.parametrize("case", INIT_LOSS_CASES, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_init_loss_branch_matches_jax(rng, case):
    L = 4096
    jl = jzoo.init_loss(_hp(case))
    pl = zoo.init_loss(_hp(case), device="cpu", dtype=torch.float64)
    assert len(pl) == len(jl) == (3 if "cls_loss_other" in case else 2)
    enh = np.clip(0.3 * rng.standard_normal((NSPK * NUTT, L)), -1, 1)
    ref = 0.3 * rng.standard_normal((NSPK * NUTT, L))
    if case["sig_loss"] == "f1":
        enh, ref = 1 / (1 + np.exp(-enh)), (ref > 0).astype(np.float64)
    with jax.enable_x64(True):
        if jl[0] is not None:
            want = jl[0](jnp.asarray(enh), jnp.asarray(ref), None)
            _close(pl[0](_t(enh), _t(ref), None), want)
        else:
            assert pl[0] is None
        dvec = rng.standard_normal((NSPK * NUTT, D))
        label = rng.integers(0, LOSS["n_class"], NSPK * NUTT)
        cls = case.get("cls_loss")
        if cls is None:
            assert pl[1] is None and jl[1] is None
        elif cls == "cross_entropy":
            _close(pl[1](_t(dvec[:, :5]), torch.from_numpy(label)),
                   jl[1](jnp.asarray(dvec[:, :5]), jnp.asarray(label)))
        else:
            v = jl[1].init(jax.random.PRNGKey(0), jnp.asarray(dvec), jnp.asarray(label))
            v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
            pl[1].load_state_dict({k: torch.from_numpy(np.array(a))
                                   for k, a in v["params"].items()}, strict=True)
            _close(pl[1](_t(dvec), torch.from_numpy(label)),
                   jl[1].apply(v, jnp.asarray(dvec), jnp.asarray(label)))
        if len(jl) == 3:
            trip = rng.standard_normal((4, 3, D))
            _close(pl[2](_t(trip)), jl[2](jnp.asarray(trip)))


def test_init_loss_ge2e_needs_contrastive_batches_and_unknown_other_raises():
    hp = _hp(dict(sig_loss="sisnr", cls_loss="ge2e"))
    hp["TRAIN"]["contrastive_learning"] = False
    with pytest.raises(ValueError, match="contrastive_learning"):
        zoo.init_loss(hp, device="cpu")
    with pytest.raises(NotImplementedError):
        zoo.init_loss(_hp(dict(sig_loss="sisnr", cls_loss_other="angular")),
                      device="cpu")
    losses = zoo.init_loss(_hp(dict(sig_loss="sisnr", cls_loss="aamsoftmax")),
                           device="cpu", generator=torch.Generator().manual_seed(1))
    again = zoo.init_loss(_hp(dict(sig_loss="sisnr", cls_loss="aamsoftmax")),
                          device="cpu", generator=torch.Generator().manual_seed(1))
    assert torch.equal(losses[1].weight, again[1].weight)


@pytest.mark.parametrize("cls", ["ge2e", "aamsoftmax", "cross_entropy"])
def test_speaker_losses_keep_jax_dtypes_under_bf16(rng, cls):
    """JAX's bf16 step casts the loss's parameters and feeds it bf16
    d-vectors: GE2E stays bf16, AAM-softmax and cross-entropy promote to
    float32 through their float32 one-hot."""
    hp = _hp(dict(sig_loss="sisnr", cls_loss=cls))
    jl = jzoo.init_loss(hp)[1]
    pl = zoo.init_loss(hp, device="cpu", dtype=torch.bfloat16)[1]
    dvec = rng.standard_normal((NSPK * NUTT, D)).astype(np.float32)
    label = rng.integers(0, LOSS["n_class"], NSPK * NUTT)
    jd = jnp.asarray(dvec, jnp.bfloat16)
    if cls == "cross_entropy":
        want = jl(jd[:, :5], jnp.asarray(label))
        got = pl(torch.from_numpy(dvec[:, :5]).bfloat16(), torch.from_numpy(label))
    else:
        v = jl.init(jax.random.PRNGKey(0), jd, jnp.asarray(label))
        v = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), v)
        want = jl.apply(v, jd, jnp.asarray(label))
        pl.load_state_dict({k: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                            for k, a in v["params"].items()})
        got = pl(torch.from_numpy(dvec).bfloat16(), torch.from_numpy(label))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.item(), float(want), rtol=3e-2)
