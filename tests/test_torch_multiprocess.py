"""Multi-process data parallelism in the port (`parallel.multihost`,
`DataLoader(shard=)`, `make_train_step(data_parallel=True)`, the trainers
and the CLIs' flags) on the CPU.

- `DataLoader(shard=(r, 2))` gives JAX's rows process by process (the
  lockstep order, the wraparound padding of the last global batch, the host
  augmentation chain on), and refuses what JAX's refuses;
- two gloo processes (spawned, a free port), each with half of every global
  batch, run two Adam steps of a small causal Conv-TasNet TSE wrapper
  (BatchNorm, AAM-softmax, inactive labels unevenly split) and of a small
  DPCRN, and end within 1e-10 of one process on the whole batch in
  float64; so does `NsTask.train()` (losses, dev loss, parameters), and
  only the primary writes checkpoints and logs;
- the CLIs refuse `--num_processes > 1` with another action than train, and
  with contrastive batches, as JAX's do.

The module imports no JAX at its top: the spawned processes import it.
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp
from scipy.io import wavfile

from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN, ConvTasNet
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.aamsoftmax import AAMsoftmax
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.parallel import TrainState, make_train_step, multihost
from puresound_tpu_torch.tasks import base, ns

torch.set_num_threads(1)

SR = 8000
F64 = dict(dtype=torch.float64)
C, CH, E, N_CLASS = 16, 24, 8, 5
WORLD, B = 2, 4
TOL = 1e-10


def causal_tasnet():
    g = torch.Generator().manual_seed(0)
    spk = [TCN(C, CH, 3, 1, generator=g, **F64), AttentiveStatisticsPooling(C, 8, **F64),
           Conv1d(2 * C, E, 1, bias=False, generator=g, **F64)]
    masker = ConvTasNet(input_dim=C, embed_dim=E, embed_norm=True, tcn_kernel=3, tcn_dim=CH,
                        repeat_tcn=1, tcn_dilated_basic=2, per_tcn_stack=3,
                        tcn_with_embed=(1, 0, 0), tcn_norm="bN1d", dconv_norm="bN1d",
                        causal=True, generator=g, **F64)
    return SoTaskWrapModule(FreeEncDec(win_length=32, hop_length=16, laten_length=C, **F64),
                            masker, spk, mask_constraint="ReLU",
                            loss_func_wav=SDRLoss.init_mode("sisnr"),
                            loss_func_spk=AAMsoftmax(E, N_CLASS, generator=g, **F64))


def small_dpcrn():
    g = torch.Generator().manual_seed(1)
    return SoTaskWrapModule(
        ConvEncDec(fft_length=64, win_length=64, hop_length=16, trainable=True,
                   output_format="Complex", **F64),
        DPCRN(input_type="RI", input_dim=64, norm_type="bN2d", dropout=0.0,
              channels=(1, 4, 4, 8, 8, 8), transpose_t_size=2, kernel_t=(2, 2, 2, 2, 2),
              stride_t=(1, 1, 1, 1, 1), dilation_t=(1, 1, 1, 1, 1),
              kernel_f=(5, 3, 3, 3, 3), stride_f=(2, 2, 1, 1, 1),
              dilation_f=(1, 1, 1, 1, 1), delay=(0, 0, 0, 0, 0), rnn_hidden=8,
              generator=g, **F64),
        loss_func_wav=SDRLoss.init_mode("sisnr"), drop_first_bin=True,
        mask_constraint="linear", f_type="Complex", mask_type="Complex")


MODELS = {"tasnet": (causal_tasnet, dict(alpha=10.0, return_loss_detail=True)),
          "dpcrn": (small_dpcrn, None)}


def global_batches(kind, seed=5, L=480):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(0.3 * rng.standard_normal(s))
    out = []
    for _ in range(2):
        b = {"noisy": t(B, L), "ref_clean": t(B, L)}
        if kind == "tasnet":
            b.update(enroll=t(B, 320),
                     spk_class=torch.from_numpy(rng.integers(0, N_CLASS, B)),
                     # both inactive rows on process 0: a mean of the
                     # processes' masked means is not the global one
                     inactive_labels=torch.tensor([True, True, False, False]))
        else:
            b["enroll"] = None
        out.append(b)
    return out


def local(batch, rank, world=WORLD):
    n = B // world
    return {k: v[rank * n:(rank + 1) * n] if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def train_steps(kind, data_parallel, rank=0, world=1):
    build, loss_kwargs = MODELS[kind]
    model = build()
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=1e-5))
    step = make_train_step(model, loss_kwargs=loss_kwargs, grad_clip=1.0,
                           data_parallel=data_parallel)
    losses = []
    for batch in global_batches(kind):
        state, m = step(state, local(batch, rank, world) if data_parallel else batch)
        losses.append(float(m["loss"]))
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


# ----------------------------------------------------------------- trainer
def write_manifest(folder, n=8, seed=1):
    """NS pairs of 0.1-0.24 s, under the 0.25 s crop (zero-padded: a batch
    does not depend on its seed); whole global batches (a padded last one
    repeats rows, which moves BatchNorm's unbiased running variance)."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    scp, ref = [], []
    for i in range(n):
        L = int((0.1 + 0.02 * i) * SR)
        clean = 0.2 * np.sin(2 * np.pi * (100 + 20 * i) * np.arange(L) / SR)
        for name, sig, lines in (("noisy", clean + 0.1 * rng.standard_normal(L), scp),
                                 ("clean", clean, ref)):
            path = os.path.join(folder, f"{name}_{i}.wav")
            wavfile.write(path, SR, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
            lines.append(f"utt_{i} {path}")
    for name, lines in (("wav2scp", scp), ("wav2ref", ref)):
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return folder


def _hparam(manifest, out, **train):
    h = {"DATASET": {"sample_rate": SR, "max_length": 0.25, "train": manifest,
                     "dev": manifest, "eval": None},
         "OPTIMIZER": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "weight_decay": 1e-5,
                       "lr_scheduler": "Plateau", "gamma": 0.5, "patience": 1, "mode": "min",
                       "num_epochs_decay": 0, "gradiend_clip": 10.0},
         "TRAIN": {"num_epochs": 1, "resume_epoch": None, "multi_gpu": True,
                   "use_tensorboard": False, "batch_size": B, "num_workers": 0,
                   "model_save_dir": os.path.join(out, "ckpt"),
                   "log_dir": os.path.join(out, "log"), "seed": 3}}
    h["TRAIN"].update(train)
    return h


class _F64(ns.NsCollateFunc):
    def __call__(self, batch):
        out = super().__call__(batch)
        for k in ("clean_wav", "process_wav"):
            out[k] = out[k].astype(np.float64)
        return out


class _Recording(ns.NsTask):
    def _consume_metrics(self, current_epoch, ctx, metrics):
        loss = super()._consume_metrics(current_epoch, ctx, metrics)
        self.losses = getattr(self, "losses", []) + [loss]
        return loss

    def compute_dev_loss(self, current_epoch):
        out = super().compute_dev_loss(current_epoch)
        self.dev = out["total_loss"]
        return out


def run_task(manifest, out, shard=None):
    hp = _hparam(manifest, out, multi_gpu=shard is not None)
    ds = ns.NsDataset(manifest, resample_to=SR, max_length=0.25)
    kw = dict(shard=shard) if shard else {}
    mk = lambda: base.DataLoader(ds, batch_size=B, shuffle=True, seed=3, collate_fn=_F64(),
                                 **kw)
    task = _Recording(hp, small_dpcrn(), "cpu", mk(), mk())
    task.train()
    return task.losses, task.dev, {k: v.clone() for k, v in task.model.state_dict().items()}


def _worker(rank, world, port, out_dir, manifest):
    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", world, rank, "cpu")
    try:
        assert multihost.process_count() == world and multihost.process_index() == rank
        assert multihost.is_primary() == (rank == 0)
        results = {kind: train_steps(kind, True, rank, world) for kind in MODELS}
        results["task"] = run_task(manifest, os.path.join(out_dir, f"rank{rank}"),
                                   shard=(rank, world))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp"))
    manifest = write_manifest(os.path.join(out, "manifest"))
    tmp_mp.start_processes(_worker, args=(WORLD, _free_port(), out, manifest), nprocs=WORLD,
                           join=True, start_method="spawn")
    return out, manifest, [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                           for r in range(WORLD)]


def _close(got, want, tol=TOL):
    assert got.dtype == want.dtype == torch.float64
    assert torch.allclose(got, want, atol=tol, rtol=tol), float((got - want).abs().max())


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_two_processes_equal_one_on_the_global_batch(two_processes, kind):
    _, _, ranks = two_processes
    want_losses, want = train_steps(kind, False)
    for r in ranks:
        losses, got = r[kind]
        np.testing.assert_allclose(losses, want_losses, atol=TOL, rtol=TOL)
        assert set(got) == set(want)
        for n in want:
            _close(got[n], want[n])
    # the processes end bit-equal: the same averaged gradients, the same steps
    for n, t in ranks[0][kind][1].items():
        assert torch.equal(t, ranks[1][kind][1][n]), n


def test_two_process_trainer_equals_one_and_only_the_primary_writes(two_processes, tmp_path):
    out, manifest, ranks = two_processes
    losses, dev, want = run_task(manifest, str(tmp_path))
    for r in ranks:
        got_losses, got_dev, got = r["task"]
        assert len(got_losses) == len(losses) == 2
        np.testing.assert_allclose(got_losses, losses, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got_dev, dev, atol=TOL, rtol=TOL)
        for n in want:
            _close(got[n], want[n])
    primary, other = (os.path.join(out, f"rank{r}") for r in range(WORLD))
    assert os.path.isfile(os.path.join(primary, "ckpt", "epoch_0.ckpt"))
    assert os.path.isfile(os.path.join(primary, "ckpt", "epoch_0.info"))
    assert not os.path.exists(os.path.join(other, "ckpt"))


def test_only_the_primary_opens_the_log(monkeypatch, tmp_path):
    """TensorBoard / metrics.jsonl on the primary only (the stub stands in
    for TensorboardWriter, whose import pulls in TensorBoard)."""
    opened = []
    monkeypatch.setattr(base, "TensorboardWriter", lambda path: opened.append(path) or path)
    manifest = write_manifest(str(tmp_path / "m"), n=4)
    for primary in (False, True):
        monkeypatch.setattr(multihost, "is_primary", lambda: primary)
        hp = _hparam(manifest, str(tmp_path), use_tensorboard=True, multi_gpu=False)
        task = ns.NsTask(hp, small_dpcrn(), "cpu", [], [])
        assert (task.tf_writer is not None) == primary
    assert opened == [hp["TRAIN"]["log_dir"]]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_a_world_of_one_is_bit_equal_to_the_plain_step(kind):
    """The data-parallel path in a group of one process (as the card's smoke
    run takes it under NCCL): every collective is the identity, so the
    parameters after two steps equal the plain step's bit for bit."""
    want_losses, want = train_steps(kind, False)
    multihost.initialize(f"localhost:{_free_port()}", 1, 0, "cpu")
    try:
        losses, got = train_steps(kind, True, 0, 1)
    finally:
        multihost.shutdown()
    assert losses == want_losses
    for n in want:
        assert torch.equal(got[n], want[n]), n


def test_global_batch_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize"):
        with multihost.global_batch(small_dpcrn()):
            pass
    with pytest.raises(ValueError, match="initialize"):
        make_train_step(small_dpcrn(), data_parallel=True)
    assert multihost.process_count() == 1 and multihost.is_primary()
    local = multihost.host_local({"a": torch.ones(2), "b": [torch.zeros(1)], "c": 3})
    assert isinstance(local["a"], np.ndarray) and isinstance(local["b"][0], np.ndarray)
    assert local["c"] == 3
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("localhost:1", 1, 0, "meta")


# ------------------------------------------------------------------ loader
@pytest.mark.parametrize("bs,drop_last", [(4, False), (2, False), (4, True), (6, False)])
def test_sharded_loader_gives_jax_rows_with_the_host_chain(tmp_path, bs, drop_last):
    from puresound_tpu.tasks import base as jbase
    from puresound_tpu.tasks import ns as jns
    from test_torch_augment import write_corpora, write_ns_manifest

    noise, rir = write_corpora(str(tmp_path / "corpora"))
    folder = write_ns_manifest(str(tmp_path / "ns"), n=7)
    opts = dict(max_length=0.25, noise_folder=noise, rir_folder=rir, vol_perturbed="0.5,1.5",
                speed_perturbed=True, perturb_frequency_response=True)
    for rank in range(2):
        loaders = [mb.DataLoader(m.NsDataset(folder, resample_to=SR, **opts), batch_size=bs,
                                 shuffle=True, collate_fn=m.NsCollateFunc(), seed=5,
                                 drop_last=drop_last, shard=(rank, 2))
                   for m, mb in ((jns, jbase), (ns, base))]
        for _ in range(2):
            want, got = list(loaders[0]), list(loaders[1])
            assert len(got) == len(want) == (7 // bs if drop_last else -(-7 // bs))
            for g, w in zip(got, want):
                assert g["uttid"] == w["uttid"] and len(g["uttid"]) == bs // 2
                for k in ("clean_wav", "process_wav"):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_sharded_loader_refuses_what_jax_refuses():
    for kw, match in ((dict(shard=(0, 2), batch_sampler=[[0]]), "batch_sampler"),
                      (dict(shard=(0, 2), shuffle=True), "seed"),
                      (dict(shard=(0, 3), batch_size=4, seed=1), "divide"),
                      (dict(shard=(2, 2), batch_size=4, seed=1), "process_id")):
        with pytest.raises(ValueError, match=match):
            base.DataLoader(list(range(8)), **kw)


# -------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("recipe", ["tse", "ns", "dss"])
def test_cli_refuses_multi_process_outside_train(tmp_path, recipe):
    import importlib

    from puresound_tpu_torch.src.utils import dump_hparam

    cli = importlib.import_module(f"puresound_tpu_torch.egs.{recipe}.main")
    cfg = tmp_path / "c.yaml"
    dump_hparam(_hparam(str(tmp_path), str(tmp_path), contrastive_learning=True), str(cfg))
    args = cli.parse_args([str(cfg), "--action", "dev", "--num_processes", "2",
                           "--process_id", "1", "--coordinator", "localhost:1"])
    assert (args.num_processes, args.process_id, args.coordinator) == (2, 1, "localhost:1")
    with pytest.raises(ValueError, match="applies to --action train"):
        cli.main(args)
    defaults = cli.parse_args([str(cfg)])
    assert (defaults.num_processes, defaults.process_id,
            defaults.coordinator) == (1, 0, "localhost:12345")
    # contrastive batches are not process-sharded (refused before joining)
    with pytest.raises(NotImplementedError, match="contrastive"):
        cli.main(cli.parse_args([str(cfg), "--backend", "cpu", "--num_processes", "2"]))
