"""Training runtime: logging, LR scheduling, Kaldi-manifest datasets, the
host-side data loader and the epoch trainer (counterpart of
puresound_tpu/tasks/base.py: TensorboardWriter `:35`, LearningRateScheduler
`:107`, TaskDataset `:158`, DataLoader `:281`, pad_stack `:499`,
DeferredMetricSink `:512`, BaseTrainer `:554-855`).

The optimizer chain of `_make_tx` (`:602`) is one `torch.optim.Adam` with
a parameter group per LR factor: optax's `add_decayed_weights` before
`scale_by_adam` is Adam's `weight_decay` (an L2 term added to the gradient,
not AdamW), and `multi_rate` scales a group's update by its factor, which
is the group's lr = base lr x factor. The scheduler sets the base LR and
keeps the factors. Checkpoints (`epoch_{n}.ckpt`, `torch.save`) hold the
parameters, the buffers (JAX's `batch_stats`), the optimizer state, the
bookkeeping (`meta`) and the scheduler, with JAX's resume semantics.
The eval-time loaders (`load_params_from_ckpt`, `resolve_eval_params`,
`average_checkpoints`, JAX's `:733-806`) read these and the JAX package's
flax-msgpack checkpoints alike, told apart by their first bytes, and so does
`load_ckpt`: training resumes from a JAX checkpoint with its parameters,
batch statistics, optax's Adam moments and count, learning rate, scheduler
and bookkeeping. The port's own checkpoints also hold the states of the
model's dropout generator and of the task's augmentation generator, so a
resumed run draws what the straight run would. In a multi-process run
(`parallel.multihost`) the loader takes its process's rows of each global
batch (`shard=`) and only the primary writes checkpoints and logs.
"""
from __future__ import annotations

import io
import json
import os
import random
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import multihost
from ..parallel.mesh import gathered
from ..src.utils import create_folder, load_text_as_dict
from ..utils import flax_ckpt
from ..utils.from_jax import flat_from_jax, for_model, params_by_name, to_torch


# ---------------------------------------------------------------------------
# Logging
# ---------------------------------------------------------------------------

class TensorboardWriter:
    """TensorBoard logger; always also a `metrics.jsonl` beside it (the
    only log where tensorboard is not installed)."""

    def __init__(self, logging_path: str):
        create_folder(logging_path)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.tf_writer = None
        else:
            self.tf_writer = SummaryWriter(log_dir=logging_path)
        self._jsonl = open(os.path.join(logging_path, "metrics.jsonl"), "a")

    def _log(self, kind, name, value, step):
        self._jsonl.write(json.dumps(
            {"kind": kind, "name": name, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()

    def update_ep_lr(self, lr: float, epoch: int) -> None:
        if self.tf_writer:
            self.tf_writer.add_scalar("learning_rate", lr, epoch)
        self._log("scalar", "learning_rate", lr, epoch)

    def update_ep_loss(self, name: str, loss: Any, epoch: int) -> None:
        if self.tf_writer:
            self.tf_writer.add_scalar(name, float(loss), epoch)
        self._log("scalar", name, loss, epoch)

    def update_step_loss(self, name: str, loss: Any, step: int) -> None:
        if self.tf_writer:
            self.tf_writer.add_scalar(name, float(loss), step)
        self._log("scalar", name, loss, step)

    def add_ep_picture(self, name: str, pic: Any, epoch: int, log: bool = True) -> None:
        """A [H, W] (or the first of [N, H, W]) image as a figure, log10 of
        it by default; nothing without tensorboard."""
        if self.tf_writer is None:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        pic = np.asarray(pic)
        if log:
            pic = np.log10(np.maximum(pic, 1e-12))
        if pic.ndim == 3:
            pic = pic[0]
        fig = plt.figure()
        plt.imshow(pic, origin="lower")
        self.tf_writer.add_figure(name, fig, epoch)
        plt.close(fig)

    def add_ep_audio(self, name: str, audio: Any, epoch: int, sr: int = 16000) -> None:
        if self.tf_writer is None:
            return
        audio = np.asarray(audio)
        if audio.ndim == 3:
            audio = audio[0]
        self.tf_writer.add_audio(name, torch.from_numpy(audio), epoch, sr)

    def update_ep_metric(self, **kwargs) -> None:
        """`add_scalar(**kwargs)` (tag, scalar_value, global_step) on
        tensorboard where there is one; always a line in metrics.jsonl."""
        if self.tf_writer:
            self.tf_writer.add_scalar(**kwargs)
        self._log("scalar", kwargs.get("tag", "metric"),
                  kwargs.get("scalar_value", 0.0), kwargs.get("global_step", 0))

    def close(self) -> None:
        if self.tf_writer:
            self.tf_writer.close()
        self._jsonl.close()


# ---------------------------------------------------------------------------
# LR scheduling (host-side; the trainer writes the value into the optimizer)
# ---------------------------------------------------------------------------

class LearningRateScheduler:
    """stepLR (decay every `patience` steps) or Plateau (decay after
    `patience` epochs without improvement). Call step() per epoch and read
    .lr."""

    def __init__(self, type: str, base_lr: float, gamma: float = 0.5,
                 patience: int = 3, mode: str = "min"):
        if type not in ("stepLR", "Plateau"):
            raise NotImplementedError(type)
        self.type = type
        self.lr = base_lr
        self.gamma = gamma
        self.patience = patience
        self.mode = mode
        self._step_count = 0
        self._best = np.inf if mode == "min" else -np.inf
        self._bad_epochs = 0

    def step(self, loss: Optional[float] = None) -> float:
        if self.type == "stepLR":
            self._step_count += 1
            if self._step_count % self.patience == 0:
                self.lr *= self.gamma
        else:
            if loss is None:
                raise ValueError("the Plateau scheduler needs the dev loss")
            improved = (loss < self._best) if self.mode == "min" else (loss > self._best)
            if improved:
                self._best = loss
                self._bad_epochs = 0
            else:
                self._bad_epochs += 1
                if self._bad_epochs > self.patience:
                    self.lr *= self.gamma
                    self._bad_epochs = 0
        return self.lr

    def state_dict(self) -> Dict:
        return {"lr": self.lr, "step_count": self._step_count,
                "best": float(self._best), "bad_epochs": self._bad_epochs}

    def load_state_dict(self, d: Dict) -> None:
        self.lr = float(d["lr"])
        self._step_count = int(d["step_count"])
        self._best = float(d["best"])
        self._bad_epochs = int(d["bad_epochs"])


# ---------------------------------------------------------------------------
# Datasets / loader
# ---------------------------------------------------------------------------

class TaskDataset:
    """Kaldi-style manifest dataset (wav2scp.txt is mandatory; subclasses
    declare extra files via folder_content)."""

    def __init__(self, folder: str, resample_to: Optional[int] = None):
        self.folder = folder
        self.resample_to = resample_to
        self.df = self._load_df(folder)
        self.idx_df = {i: k for i, k in enumerate(self.df.keys())}

    def __len__(self):
        return len(self.idx_df)

    def __getitem__(self, index):
        raise NotImplementedError

    @property
    def folder_content(self) -> Dict[str, str]:
        return {"wav2scp": "wav2scp.txt"}

    def _load_df(self, folder: str) -> Dict:
        content = dict(self.folder_content)
        scp_path = os.path.join(folder, content.pop("wav2scp"))
        if not os.path.isfile(scp_path):
            raise FileNotFoundError(f"{scp_path} is not found")
        df: Dict[str, Dict] = {}
        wav2scp = load_text_as_dict(scp_path)
        for key in sorted(wav2scp.keys()):
            df[key] = {"wav2scp": wav2scp[key][0]}
        for name, fname in content.items():
            fpath = os.path.join(folder, fname)
            if not os.path.isfile(fpath):
                raise FileNotFoundError(f"{fpath} is not found")
            temp = load_text_as_dict(fpath)
            for key in sorted(temp.keys()):
                if key not in df:
                    print(f"Non match key {key}")
                    continue
                df[key][name] = temp[key] if len(temp[key]) != 1 else temp[key][0]
        return df


def _as_is(batch):
    return batch


def _to_tensors(batch):
    """In a worker: a batch's numpy arrays become tensors, which torch's
    loader hands over through shared memory, where arrays would be pickled
    through a pipe (a recipe batch is 8.4 MB)."""
    if not isinstance(batch, dict):
        return batch
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def _to_arrays(batch):
    """The numpy arrays of a batch `_to_tensors` handed over (no copy)."""
    if not isinstance(batch, dict):
        return batch
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


class _EpochBatches(torch.utils.data.Dataset):
    """One epoch's batches as a map-style dataset: item `seq` is batch `seq`
    of the epoch's order, built under the RNG seeded for it."""

    def __init__(self, loader: "DataLoader", batches: List[List[int]]):
        self.loader = loader
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, seq: int):
        return self.loader._make(self.batches[seq], seq)


class DataLoader:
    """Host-side loader: shuffling and batching, or a `batch_sampler`'s
    batches (`SpeakerSampler`'s, for contrastive training), and collate.
    num_workers == 0 builds each batch in this process; num_workers > 0
    hands an epoch's batches to torch's DataLoader with fork'd workers,
    which run numpy code only and never touch the CUDA state the parent may
    have initialised before it forked; a batch's arrays come back through
    shared memory.

    The epoch's batches are drawn in this process before any is built, the
    sampler from Python's global `random` as JAX's does. Every batch is
    built under an RNG seeded from (seed, epoch, batch), and the global
    `random` / `np.random` states are put back after each one, so neither
    the batches nor the sampler's next draws depend on num_workers (JAX's
    process pool gives the same batches); without `seed` a random base is
    drawn per loader (fork'd workers never share one RNG stream).

    `shard=(process_id, n_processes)` makes the loader one process's part of
    a multi-process run, as JAX's: `batch_size` is the global batch, every
    process draws the same global order (so shuffling needs `seed`) and
    takes its contiguous batch_size / n_processes rows, and a short last
    batch is padded by wrapping around, so every process steps in lockstep."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 collate_fn: Optional[Callable] = None, num_workers: int = 0,
                 batch_sampler=None, drop_last: bool = False,
                 prefetch: int = 2, seed: Optional[int] = None,
                 shard: Optional[tuple] = None):
        if shard is not None:
            rank, world = shard
            if batch_sampler is not None:
                raise ValueError("shard= is incompatible with batch_sampler")
            if shuffle and seed is None:
                raise ValueError("sharded loading requires seed= so every "
                                 "process shuffles identically")
            if batch_size % world:
                raise ValueError(f"batch_size {batch_size} must divide by "
                                 f"n_processes {world}")
            if not 0 <= rank < world:
                raise ValueError(f"process_id {rank} outside 0..{world - 1}")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or _as_is
        self.num_workers = num_workers
        self.batch_sampler = batch_sampler
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self._auto_base = random.getrandbits(63)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Start the epoch count at `epoch` (the next pass is epoch + 1), as a
        resumed run's loader would have reached it."""
        self._epoch = epoch

    def _batches(self):
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            if self.seed is not None:
                random.Random(self.seed + 7919 * self._epoch).shuffle(idx)
            else:
                random.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            b = idx[i:i + self.batch_size]
            if len(b) < self.batch_size:
                if self.drop_last:
                    continue
                if self.shard is not None:      # lockstep: pad, never ragged
                    b = (b * ((self.batch_size - 1) // len(b) + 1))[:self.batch_size]
            if self.shard is not None:
                rank, world = self.shard
                per = self.batch_size // world
                b = b[rank * per:(rank + 1) * per]
            yield b

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_seed(self, seq: int) -> int:
        base = self._auto_base if self.seed is None else self.seed
        return (base * 1_000_003 + self._epoch * 7919 + seq) % (2**63)

    def _make(self, indices, seq: int):
        states = random.getstate(), np.random.get_state()
        s = self._batch_seed(seq)
        random.seed(s)
        np.random.seed(s % (2**32))
        try:
            return self.collate_fn([self.dataset[i] for i in indices])
        finally:
            random.setstate(states[0])
            np.random.set_state(states[1])

    def __iter__(self):
        self._epoch += 1
        batches = _EpochBatches(self, list(self._batches()))
        if self.num_workers == 0:
            for seq in range(len(batches)):
                yield batches[seq]
            return
        for batch in torch.utils.data.DataLoader(
                batches, batch_size=None, collate_fn=_to_tensors,
                num_workers=self.num_workers, prefetch_factor=max(self.prefetch, 1),
                multiprocessing_context="fork"):
            yield _to_arrays(batch)


def pad_stack(seqs: List[np.ndarray]) -> np.ndarray:
    """Zero-pad 1-D arrays to the max length and stack -> [N, L]."""
    L = max(s.shape[-1] for s in seqs)
    out = np.zeros((len(seqs), L), np.float32)
    for i, s in enumerate(seqs):
        out[i, :s.shape[-1]] = s.reshape(-1)
    return out


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class DeferredMetricSink:
    """Read per-step device metrics back one step behind dispatch, so the
    host queues step k+1 before it waits on step k's loss. The logged
    values, their order and the epoch averages are unchanged.

        sink = DeferredMetricSink(consume)   # consume(ctx, metrics)
        for ...:
            state, metrics = train_step(...)
            sink.push(ctx, metrics)          # reads the PREVIOUS step
        sink.flush()                         # reads the last one
    """

    def __init__(self, consume):
        self._consume = consume
        self._pending = None

    def push(self, ctx, metrics):
        prev = self._pending
        self._pending = (ctx, metrics)
        if prev is not None:
            self._consume(*prev)

    def flush(self):
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._consume(*prev)


def checkpoint_state(filename: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's parameters and persistent buffers by the port's
    state_dict names, on the CPU: the port's own `torch.save` file (a zip
    archive, `PK\\x03\\x04`) or the JAX package's `flax.serialization.to_bytes`
    one (a msgpack map), told apart by the bytes, not the file name."""
    with open(filename, "rb") as f:
        data = f.read()
    if data[:4] == b"PK\x03\x04":
        tree = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
        return {**tree["params"], **tree["batch_stats"]}
    if flax_ckpt.is_msgpack_map(data):
        tree = flax_ckpt.msgpack_restore(data)
        return to_torch(flat_from_jax({"params": tree["params"],
                                       "batch_stats": tree.get("batch_stats") or {}}))
    raise ValueError(f"{filename}: neither a torch.save checkpoint nor a flax msgpack one")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _find_adam(tree) -> Dict:
    """The one ScaleByAdamState of a restored optax state (a dict with the
    fields count, mu and nu), wherever the chain nests it."""
    found = []

    def walk(t):
        if isinstance(t, dict):
            if set(t) == {"count", "mu", "nu"}:
                found.append(t)
                return
            for v in t.values():
                walk(v)

    walk(tree)
    if len(found) != 1:
        raise ValueError(f"{len(found)} ScaleByAdamState in the checkpoint's "
                         "optimizer state; resuming needs exactly one")
    return found[0]


def _f32(lr: float) -> float:
    """The learning rate as JAX holds it (a float32 hyperparameter)."""
    return float(np.float32(lr))


class BaseTrainer:
    """Epoch-driven trainer around one train step on `device`.

    Subclasses set `self.model` before calling this constructor and build
    their step in `_build_steps`. Checkpoints include the optimizer state
    and the scheduler bookkeeping (full resume)."""

    def __init__(self, hparam: Dict, device):
        self.hparam = hparam
        self.device = torch.device(device)
        self.best_loss = np.inf
        self.best_epoch = np.inf
        self.overall_step = 0
        self.build_optim()
        if hparam["TRAIN"].get("use_tensorboard") and multihost.is_primary():
            self.tf_writer = TensorboardWriter(hparam["TRAIN"]["log_dir"])
        else:
            self.tf_writer = None

    # ------------------------------------------------------------- builders
    def lr_factors(self) -> Optional[Dict[str, float]]:
        """Optional per-submodule LR factors (e.g. encoder 0.1)."""
        return None

    def _factor(self, name: str, factors: Optional[Dict[str, float]]) -> float:
        """The factor of the first prefix the top-level module name starts
        with (the tree path's first key in JAX), else 1."""
        top = name.split(".", 1)[0]
        for prefix, f in (factors or {}).items():
            if top.startswith(prefix):
                return f
        return 1.0

    def _make_optimizer(self) -> torch.optim.Optimizer:
        opt = self.hparam["OPTIMIZER"]
        factors = self.lr_factors() if opt.get("multi_rate") else None
        groups: Dict[float, list] = {}
        for name, p in self.model.named_parameters():
            groups.setdefault(self._factor(name, factors), []).append(p)
        lr = _f32(opt["lr"])
        return torch.optim.Adam(
            [{"params": ps, "factor": f, "lr": lr * f} for f, ps in groups.items()],
            lr=lr, betas=(opt.get("beta1", 0.9), opt.get("beta2", 0.999)),
            eps=1e-8, weight_decay=opt.get("weight_decay", 0.0) or 0.0)

    def build_optim(self):
        from ..parallel.mesh import TrainState

        opt = self.hparam["OPTIMIZER"]
        self.scheduler = LearningRateScheduler(
            opt["lr_scheduler"], base_lr=opt["lr"], gamma=opt.get("gamma", 0.5),
            patience=opt.get("patience", 3), mode=opt.get("mode", "min"))
        self.state = TrainState(self.model, self._make_optimizer())
        self._lr = _f32(opt["lr"])
        resume = self.hparam["TRAIN"].get("resume_epoch")
        if resume:
            print(f"***** Start from {resume} epoch")
            self.load_ckpt(os.path.join(self.hparam["TRAIN"]["model_save_dir"],
                                        f"epoch_{resume - 1}.ckpt"))

    def set_learning_rate(self, lr: float):
        self._lr = _f32(lr)
        for group in self.state.optimizer.param_groups:
            group["lr"] = self._lr * group["factor"]

    @property
    def current_lr(self) -> float:
        return self._lr

    # ---------------------------------------------------------- checkpoints
    def _generators(self) -> Dict[str, torch.Generator]:
        """The generators a resumed run must continue: the model's dropout
        generator (one per distinct generator, in module order) and the
        task's augmentation generator."""
        out: Dict[str, torch.Generator] = {}
        seen = set()
        for m in self.model.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator) and id(g) not in seen:
                seen.add(id(g))
                out[f"model_{len(seen) - 1}"] = g
        if getattr(self, "augment_generator", None) is not None:
            out["augment"] = self.augment_generator
        return out

    def _ckpt_tree(self, epoch, loss) -> Dict:
        params = dict(self.model.named_parameters())
        state = self.model.state_dict()
        # the persistent buffers only (the BatchNorm statistics): the STFT
        # bases of ConvEncDec are constants rebuilt with the module
        return {
            "params": {n: t.detach() for n, t in state.items() if n in params},
            "batch_stats": {n: t.detach() for n, t in state.items() if n not in params},
            "opt_state": self.state.optimizer.state_dict(),
            "meta": {"epoch": int(epoch), "learning_rate": self.current_lr,
                     "loss": float(loss["total_loss"]),
                     "best_loss": float(self.best_loss),
                     "best_epoch": (float(self.best_epoch)
                                    if np.isfinite(self.best_epoch) else -1.0),
                     "overall_step": int(self.overall_step),
                     "step": int(self.state.step)},
            "scheduler": self.scheduler.state_dict(),
            "rng": {k: g.get_state() for k, g in self._generators().items()},
        }

    def save_ckpt(self, filename: str, epoch: int, loss: Dict) -> None:
        torch.save(self._ckpt_tree(epoch, loss), filename)

    def save_ckpt_info(self, filename: str, epoch: int, learning_rate, loss) -> None:
        with open(filename, "w") as f:
            f.write(f"epoch: {epoch}\n")
            f.write(f"lr: {learning_rate}\n")
            f.write(f"loss: {loss['total_loss']}\n")
            f.write(f"best_epoch: {self.best_epoch}\n")
            f.write(f"best_dev_loss: {self.best_loss}\n")

    def load_ckpt(self, filename: str) -> Tuple[int, float, float]:
        """Resume from the port's checkpoint or the JAX package's (a flax
        msgpack map, told apart by its first bytes)."""
        with open(filename, "rb") as f:
            data = f.read()
        if flax_ckpt.is_msgpack_map(data):
            return self._load_jax_ckpt(flax_ckpt.msgpack_restore(data))
        tree = torch.load(io.BytesIO(data), map_location=self.device, weights_only=True)
        gens = self._generators()
        for k, st in tree.get("rng", {}).items():
            if k in gens:
                gens[k].set_state(st.cpu())
        state = dict(tree["params"])
        state.update(tree["batch_stats"])
        self.model.load_state_dict(state, strict=True)
        self.state.optimizer.load_state_dict(tree["opt_state"])
        meta = tree["meta"]
        self.best_loss = float(meta["best_loss"])
        self.best_epoch = np.inf if meta["best_epoch"] < 0 else float(meta["best_epoch"])
        self.overall_step = int(meta["overall_step"])
        self.state.step = int(meta["step"])
        self.scheduler.load_state_dict(tree["scheduler"])
        self.set_learning_rate(float(meta["learning_rate"]))
        return int(meta["epoch"]), float(meta["learning_rate"]), float(meta["loss"])

    def _load_jax_ckpt(self, tree: Dict) -> Tuple[int, float, float]:
        """JAX's `load_ckpt` (puresound_tpu/tasks/base.py:710-730) on the
        port: the parameters and batch statistics by the converter of
        `utils.from_jax`; optax's ScaleByAdamState (found by its fields
        count / mu / nu in the restored tree) into each parameter's Adam
        `exp_avg` / `exp_avg_sq` / `step`, the moments laid out by
        `params_by_name` as the weights are; the learning rate, best loss
        and epoch, step count and scheduler from the tree. A moment leaf
        the converter does not carry over one to one raises."""
        state = to_torch(flat_from_jax({"params": tree["params"],
                                        "batch_stats": tree.get("batch_stats") or {}}))
        self.model.load_state_dict(for_model(state, self.model), strict=True)
        adam = _find_adam(tree["opt_state"])
        params = dict(self.model.named_parameters())
        moments = {}
        for key in ("mu", "nu"):
            flat = params_by_name(adam[key])
            n_jax = sum(np.asarray(a).size for a in _leaves(adam[key]))
            if set(flat) != set(params) or n_jax != sum(a.size for a in flat.values()):
                extra = sorted(set(flat) ^ set(params))
                raise ValueError(
                    f"optax {key!r}: {n_jax} values in the checkpoint, "
                    f"{sum(a.size for a in flat.values())} mapped onto the "
                    f"model's {len(params)} parameters (unmatched: {extra[:4]})")
            for n, a in flat.items():
                if a.shape != tuple(params[n].shape):
                    raise ValueError(f"optax {key!r} {n}: {a.shape} != "
                                     f"{tuple(params[n].shape)}")
            moments[key] = flat
        count = int(np.asarray(adam["count"]))
        scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
        opt = self.state.optimizer
        for n, p in params.items():
            opt.state[p] = {"step": torch.tensor(float(count), dtype=scalar),
                            "exp_avg": torch.as_tensor(moments["mu"][n]).to(p),
                            "exp_avg_sq": torch.as_tensor(moments["nu"][n]).to(p)}
        self.state.step = count
        meta = tree["meta"]
        self.best_loss = float(meta["best_loss"])
        be = float(meta["best_epoch"])
        self.best_epoch = np.inf if be < 0 else be
        self.overall_step = int(meta["overall_step"])
        if "scheduler" in tree:
            self.scheduler.load_state_dict(
                {k: (int(v) if k in ("step_count", "bad_epochs") else float(v))
                 for k, v in tree["scheduler"].items()})
        self.set_learning_rate(float(meta["learning_rate"]))
        return int(meta["epoch"]), float(meta["learning_rate"]), float(meta["loss"])

    @staticmethod
    def load_params_from_ckpt(filename: str, model: torch.nn.Module) -> torch.nn.Module:
        """Eval-time loading: the checkpoint's parameters and buffers into
        `model` (the optimizer state is ignored; keys the model lacks are
        dropped, keys it has must be there, `for_model`). Returns `model`."""
        model.load_state_dict(for_model(checkpoint_state(filename), model), strict=True)
        return model

    @staticmethod
    def resolve_eval_params(hparam: Dict, ckpt_name: str,
                            model: torch.nn.Module) -> torch.nn.Module:
        """Load eval-time parameters into `model` honouring
        ``TRAIN.model_average``: N > 1 averages the N epoch checkpoints ending
        at ``--ckpt epoch_k.ckpt`` (epochs k-N+1 .. k, skipping the epochs
        whose file is missing); any other value, a checkpoint not named
        ``epoch_<n>.ckpt``, or fewer than two files found load the one
        checkpoint."""
        save_dir = hparam["TRAIN"]["model_save_dir"]
        n_avg = int(hparam.get("TRAIN", {}).get("model_average") or 0)
        m = re.fullmatch(r"epoch_(\d+)\.ckpt", ckpt_name)
        if n_avg > 1 and m:
            k = int(m.group(1))
            paths = [os.path.join(save_dir, f"epoch_{e}.ckpt")
                     for e in range(max(0, k - n_avg + 1), k + 1)]
            paths = [p for p in paths if os.path.isfile(p)]
            if len(paths) > 1:
                print(f"model_average: averaging {len(paths)} checkpoints "
                      f"ending at {ckpt_name}")
                return BaseTrainer.average_checkpoints(paths, model)
        return BaseTrainer.load_params_from_ckpt(os.path.join(save_dir, ckpt_name), model)

    @staticmethod
    def average_checkpoints(filenames, model: torch.nn.Module) -> torch.nn.Module:
        """The mean of several checkpoints' parameters and buffers into
        `model`, as JAX's: summed in float64 in the order given, divided by
        their count, cast to float32. A tensor that is not floating point
        (none of the ported models has one) is not averaged: the last
        checkpoint's is taken."""
        acc: Dict[str, torch.Tensor] = {}
        for fn in filenames:
            for name, t in for_model(checkpoint_state(fn), model).items():
                if not t.is_floating_point():
                    acc[name] = t
                elif name in acc:
                    acc[name] = acc[name] + t.to(torch.float64)
                else:
                    acc[name] = t.to(torch.float64)
        n = float(len(filenames))
        avg = {k: (a / n).to(torch.float32) if a.is_floating_point() else a
               for k, a in acc.items()}
        model.load_state_dict(avg, strict=True)
        return model

    # -------------------------------------------------------------- running
    def train_one_epoch(self, current_epoch: int) -> Dict:
        raise NotImplementedError

    def compute_dev_loss(self, current_epoch: int) -> Dict:
        raise NotImplementedError

    def gen_logging(self, epoch: Optional[int] = None, prefix: str = ""):
        raise NotImplementedError

    def early_stopping(self, current_epoch: int, stop_criterion: int = 20):
        if current_epoch >= self.best_epoch + stop_criterion:
            raise RuntimeError("Early stopping")

    def train(self):
        num_epochs = self.hparam["TRAIN"]["num_epochs"]
        start = self.hparam["TRAIN"].get("resume_epoch") or 0
        if start:   # a resumed run draws the batches the straight run would
            for loader in (self.train_dataloader, self.dev_dataloader):
                if hasattr(loader, "set_epoch"):
                    loader.set_epoch(start)
        for epoch in range(start, num_epochs):
            lr = self.current_lr
            loss = self.train_one_epoch(current_epoch=epoch)
            # a tensor-parallel state is whole for the dev loss, the
            # checkpoint and the logging inference (every rank gathers)
            with gathered(self.state):
                self._end_epoch(epoch, lr, loss)
            self.early_stopping(current_epoch=epoch, stop_criterion=25)

    def _end_epoch(self, epoch: int, lr: float, loss: Dict) -> None:
        """The dev loss, the bookkeeping, the primary's checkpoint, the
        scheduler and the primary's logging of one finished epoch."""
        dev_loss = self.compute_dev_loss(current_epoch=epoch)

        if dev_loss["total_loss"] <= self.best_loss:
            self.best_loss = dev_loss["total_loss"]
            self.best_epoch = epoch

        if self.tf_writer:
            self.tf_writer.update_ep_lr(lr, epoch)
            self.tf_writer.update_ep_loss("train/avg_loss", loss["total_loss"], epoch)
            self.tf_writer.update_ep_loss("train/avg_dev_loss",
                                          dev_loss["total_loss"], epoch)

        if multihost.is_primary():
            save_dir = self.hparam["TRAIN"]["model_save_dir"]
            create_folder(save_dir)
            self.save_ckpt(os.path.join(save_dir, f"epoch_{epoch}.ckpt"), epoch, loss)
            self.save_ckpt_info(os.path.join(save_dir, f"epoch_{epoch}.info"),
                                epoch, lr, loss)

        if epoch >= self.hparam["OPTIMIZER"]["num_epochs_decay"]:
            new_lr = self.scheduler.step(
                dev_loss["total_loss"]
                if self.hparam["OPTIMIZER"]["lr_scheduler"] == "Plateau" else None)
            self.set_learning_rate(new_lr)

        if multihost.is_primary():
            self.gen_logging(epoch=epoch, prefix="")
