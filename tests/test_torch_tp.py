"""Tensor parallelism in the port (`make_train_step(mesh=, tp=True)`,
`shard_state_to_mesh`, `TRAIN.mp_devices`) over spawned gloo processes on
the CPU, against one process on the whole batch in float64:

- (dp, mp) = (1, 2) and (2, 2) on a tiny SkiM TSE wrapper (JAX's
  `tests/test_parallel.py` setup, `tp_min_size=8`): two Adam steps with a
  clip, losses and grad norms within 1e-10 and the gathered parameters
  within 1e-10; at least 4 leaves sharded; between steps each rank holds
  only its `tp_spec` slice of every sharded parameter and of both Adam
  moments, the mp ranks' slices tiling the whole;
- `accum_steps=2` and `skip_nonfinite` (a NaN batch skipped alike on every
  rank) under tp;
- `NsTask.train()` with `TRAIN.mp_devices: 2` over 2 processes equals one
  process (losses, dev loss, parameters), the loader's shard is the dp
  index's (every rank of a dp row loads the same rows), and the primary's
  checkpoint holds whole tensors that load into a plain model;
- in a world of 4 with mp_devices 2 the loader shards (rank // 2, 2);
- in a world of one the data-parallel and the tp (mp = 1) steps of the
  tiny TSE are bit-equal to the plain step (the gradients' mean comes back
  laid out as the gradients were: a transposed gradient's norm then sums in
  the plain step's order).

The module imports no JAX at its top: the spawned processes import it.
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.parallel import (TrainState, gathered, make_mesh, make_train_step,
                                          multihost, shard_batch, shard_state_to_mesh,
                                          tp_spec)
from puresound_tpu_torch.tasks import base, ns
from test_torch_multiprocess import _F64, _hparam, small_dpcrn, write_manifest

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)
B, L = 8, 800
TOL = 1e-10
MIN = 8
CASES = {"plain": {}, "accum": dict(accum_steps=2), "skip": dict(skip_nonfinite=True)}


def tiny_tse():
    g = torch.Generator().manual_seed(0)
    return SoTaskWrapModule(
        FreeEncDec(win_length=16, hop_length=8, laten_length=24, output_active=True,
                   generator=g, **F64),
        SkiM(input_size=24, hidden_size=16, output_size=24, n_blocks=2, seg_size=10,
             causal=True, embed_dim=8, embed_norm=True, embed_fusion="FiLM",
             block_with_embed=(1, 1), generator=g, **F64),
        [TCN(24, 16, 3, dilation=1, tcn_norm="gLN", dconv_norm="gGN", generator=g, **F64),
         AttentiveStatisticsPooling(24, 16, generator=g, **F64),
         Conv1d(48, 8, 1, bias=False, generator=g, **F64)],
        loss_func_wav=SDRLoss.init_mode("sisnr"), mask_constraint="ReLU")


def batches(case):
    rng = np.random.default_rng(11)
    t = lambda: torch.from_numpy(0.1 * rng.standard_normal((B, L)))
    out = [{"noisy": t(), "enroll": t(), "ref_clean": t()} for _ in range(2)]
    if case == "skip":   # a NaN batch in between: skipped, the moments step on
        bad = {k: v.clone() for k, v in out[0].items()}
        bad["noisy"][1, 5] = float("nan")
        out.insert(1, bad)
    return out


def train(case, n_mp=None, data_parallel=False):
    """(losses, grad norms, skipped, whole parameters, what each rank held):
    one process on the whole batch (n_mp None) or this rank's dp rows on
    the (world / n_mp, n_mp) mesh with tp."""
    model = tiny_tse()
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    mesh = None
    if n_mp is not None:
        mesh = make_mesh(n_mp=n_mp)
        shard_state_to_mesh(mesh, state, tp=True, tp_min_size=MIN)
    step = make_train_step(model, grad_clip=1.0, mesh=mesh, tp=mesh is not None,
                           tp_min_size=MIN, data_parallel=data_parallel, **CASES[case])
    losses, norms, skipped = [], [], []
    for batch in batches(case):
        state, m = step(state, shard_batch(mesh, batch) if mesh else batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        skipped.append(float(m.get("skipped", 0.0)))
    held = {}
    if mesh is not None:
        opt = state.optimizer.state
        held = {n: (tuple(p.shape), tuple(opt[p]["exp_avg"].shape),
                    tuple(opt[p]["exp_avg_sq"].shape), p.detach().clone(),
                    opt[p]["exp_avg"].clone())
                for n, p in model.named_parameters() if n in state.tp_layout}
        held = {"layout": dict(state.tp_layout), "held": held}
    with gathered(state):
        params = {k: v.clone() for k, v in model.state_dict().items()}
        moments = {n: state.optimizer.state[p]["exp_avg_sq"].clone()
                   for n, p in model.named_parameters()}
    return losses, norms, skipped, params, moments, held


def run_task(manifest, out, n_mp=None):
    hp = _hparam(manifest, out, multi_gpu=n_mp is not None, mp_devices=n_mp or 1,
                 tp_min_size=MIN)
    from puresound_tpu_torch.egs.tse.main import loader_kwargs

    kw = loader_kwargs(hp["TRAIN"]) if n_mp else {}
    kw.pop("seed", None)
    ds = ns.NsDataset(manifest, resample_to=8000, max_length=0.25)
    mk = lambda: base.DataLoader(ds, batch_size=4, shuffle=True, seed=3, collate_fn=_F64(),
                                 **kw)

    class Recording(ns.NsTask):
        losses = []

        def _consume_metrics(self, current_epoch, ctx, metrics):
            loss = super()._consume_metrics(current_epoch, ctx, metrics)
            self.losses = self.losses + [loss]
            return loss

        def compute_dev_loss(self, current_epoch):
            out = super().compute_dev_loss(current_epoch)
            self.dev = out["total_loss"]
            return out

    task = Recording(hp, small_dpcrn(), "cpu", mk(), mk())
    task.train()
    with gathered(task.state):
        params = {k: v.clone() for k, v in task.model.state_dict().items()}
    return {"losses": task.losses, "dev": task.dev, "params": params,
            "shard": kw.get("shard"), "n_sharded": len(task.state.tp_layout)}


def _worker(rank, world, port, out_dir, manifest):
    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", world, rank, "cpu")
    try:
        res = {case: train(case, n_mp=2) for case in (CASES if world == 2 else ("plain",))}
        if world == 2:
            res["task"] = run_task(manifest, os.path.join(out_dir, f"rank{rank}"), n_mp=2)
        else:
            from puresound_tpu_torch.egs.tse.main import loader_kwargs

            res["shard"] = loader_kwargs({"mp_devices": 2, "seed": 1})["shard"]
            res["index"] = (multihost.dp_index(), multihost.mp_index(), multihost.dp_count())
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds spawned at once, each on its own port."""
    runs = {}
    for world in (2, 4):
        out = str(tmp_path_factory.mktemp(f"tp{world}"))
        manifest = write_manifest(os.path.join(out, "manifest"))
        ctx = tmp_mp.start_processes(_worker, args=(world, _free_port(), out, manifest),
                                     nprocs=world, join=False, start_method="spawn")
        runs[world] = (out, manifest, ctx)
    for _, _, ctx in runs.values():
        while not ctx.join():
            pass
    return {w: (out, manifest, [torch.load(os.path.join(out, f"rank{r}.pt"),
                                           weights_only=False) for r in range(w)])
            for w, (out, manifest, _) in runs.items()}


@pytest.fixture(scope="module")
def single():
    return {case: train(case) for case in CASES}


def _close(got, want, what):
    assert got.dtype == want.dtype == torch.float64, what
    assert torch.allclose(got, want, atol=TOL, rtol=TOL), (what,
                                                          float((got - want).abs().max()))


@pytest.mark.parametrize("world,case", [(2, "plain"), (4, "plain"), (2, "accum"),
                                        (2, "skip")])
def test_tp_steps_equal_one_process(worlds, single, world, case):
    _, _, ranks = worlds[world]
    w_losses, w_norms, w_skipped, want, w_moments, _ = single[case]
    for r in ranks:
        losses, norms, skipped, got, moments, _ = r[case]
        np.testing.assert_allclose(losses, w_losses, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(norms, w_norms, atol=TOL, rtol=TOL)
        assert skipped == w_skipped
        assert set(got) == set(want)
        for n in want:
            _close(got[n], want[n], n)
        for n in w_moments:
            _close(moments[n], w_moments[n], n)
    if case == "skip":
        assert w_skipped == [0.0, 1.0, 0.0]


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_only_its_slices(worlds, single, world):
    _, _, ranks = worlds[world]
    model = tiny_tse()
    whole = dict(model.named_parameters())
    layout = ranks[0]["plain"][5]["layout"]
    assert len(layout) >= 4
    assert layout == {n: (tp_spec(tuple(p.shape), 2, MIN).index("mp"), tuple(p.shape))
                      for n, p in whole.items() if tp_spec(tuple(p.shape), 2, MIN)}
    final = ranks[0]["plain"][3]
    for n, (ax, shape) in layout.items():
        part = list(shape)
        part[ax] //= 2
        slices = []
        for r in ranks[:2]:          # the mp ranks of dp row 0
            p_shape, mu_shape, nu_shape, p, mu = r["plain"][5]["held"][n]
            assert p_shape == mu_shape == nu_shape == tuple(part), n
            slices.append(p)
        assert torch.equal(torch.cat(slices, ax), final[n]), n


def test_tp_trainer_equals_one_process_and_writes_whole_checkpoints(worlds, tmp_path):
    from test_torch_multiprocess import run_task as plain_task

    out, manifest, ranks = worlds[2]
    losses, dev, want = plain_task(manifest, str(tmp_path))
    for r in ranks:
        got = r["task"]
        assert got["shard"] == (0, 1) and got["n_sharded"] >= 2
        assert len(got["losses"]) == len(losses) == 2
        np.testing.assert_allclose(got["losses"], losses, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got["dev"], dev, atol=TOL, rtol=TOL)
        for n in want:
            _close(got["params"][n], want[n], n)
    ckpt = os.path.join(out, "rank0", "ckpt", "epoch_0.ckpt")
    assert not os.path.exists(os.path.join(out, "rank1", "ckpt"))
    plain = base.BaseTrainer.load_params_from_ckpt(ckpt, small_dpcrn())
    for n, t in plain.state_dict().items():
        _close(t, ranks[0]["task"]["params"][n], n)
    tree = torch.load(ckpt, weights_only=True)
    for n, p in plain.named_parameters():
        assert tree["opt_state"]["state"][list(dict(plain.named_parameters())).index(n)][
            "exp_avg"].shape == p.shape, n


def test_loader_shards_by_dp_index(worlds):
    _, _, ranks = worlds[4]
    assert [r["shard"] for r in ranks] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert [r["index"] for r in ranks] == [(0, 0, 2), (0, 1, 2), (1, 0, 2), (1, 1, 2)]


@pytest.mark.parametrize("mode", ["data_parallel", "tp"])
def test_a_world_of_one_is_bit_equal_to_the_plain_step(single, mode):
    w_losses, w_norms, _, want, w_moments, _ = single["plain"]
    multihost.initialize(f"localhost:{_free_port()}", 1, 0, "cpu")
    try:
        got = (train("plain", data_parallel=True) if mode == "data_parallel"
               else train("plain", n_mp=1))
    finally:
        multihost.shutdown()
    assert got[0] == w_losses and got[1] == w_norms
    for n in want:
        assert torch.equal(got[3][n], want[n]), n


def test_the_gradient_mean_keeps_the_gradients_layout():
    """An LSTM weight's gradient comes transposed ([4H, C] with strides (1,
    4H)); its mean over a world of one keeps that layout, so its norm sums
    in the same order and equals the plain step's bit for bit (the
    flagship's f32 step moved by 2e-7 when the mean came back contiguous)."""
    g = torch.Generator().manual_seed(4)
    grads = [torch.randn(256, 1024, generator=g).T, torch.randn(1024, generator=g)]
    multihost.initialize(f"localhost:{_free_port()}", 1, 0, "cpu")
    try:
        out = multihost.all_reduce_mean(grads)
    finally:
        multihost.shutdown()
    for a, b in zip(grads, out):
        assert b.stride() == a.stride() and torch.equal(a, b)
        assert torch.equal(torch.linalg.vector_norm(a), torch.linalg.vector_norm(b))
