"""The device mesh and the training step (counterpart of
puresound_tpu/parallel/mesh.py).

A `Mesh` is a ("dp", "mp") grid of cells, `mesh.shape` a dict as JAX's
(`mesh.shape["dp"]`). Its cells are either `torch.device`s of this process
(serving, `seq_parallel_infer`; a device may stand in more than one cell,
as JAX's tests fake several devices on one CPU) or the ranks of the process
group (training, one process per card). `make_mesh`, `tp_spec`,
`shard_batch`, `replicate_to_mesh`, `shard_by_slots` and
`shard_state_to_mesh` place data on it.

`TrainState` holds the float32 master `nn.Module` (its buffers are the
BatchNorm running statistics, JAX's `batch_stats`), an optimizer built over
its parameters and the step count. `make_train_step` returns
`step(state, batch) -> (state, metrics)` with JAX's semantics:

- mixed precision: with `compute_dtype`, every float32 parameter, buffer and
  batch tensor is cast to it and the forward and backward run on the casts
  (the module reparametrised on them for the forward and the backward; not
  `torch.autocast`, which keeps chosen ops in float32). The gradients reach
  the masters through the cast; the loss and the new running statistics
  come back in float32;
- the global-norm clip `min(1, clip / max(norm, 1e-12))`, `grad_norm` being
  the norm before clipping;
- `accum_steps` micro-batches split on the leading axis, their gradients and
  losses averaged, the running statistics chained through them;
- `skip_nonfinite`: a non-finite loss or gradient norm applies a zero
  gradient (the optimizer still steps, as optax does) and keeps the old
  running statistics.

The step updates the state in place, PyTorch's idiom where JAX returns a
new state: the optimizer writes the parameters in place, the running
statistics are copied into the module's buffers, and each parameter's
`.grad` holds the gradient that was applied (clipped, zeroed on a skip).
Nothing reads back to the host: the metrics are 0-d tensors on the
model's device.

- `augment_fn(generator, batch) -> batch` runs on the batch's device before
  the forward (the on-device chain, `src.augment_torch`), its draws from
  the generator the step is given;
- `remat` (True / "dots") recomputes the model's blocks in the backward,
  one at a time (`parallel.remat`), with the same dropout masks and one
  running-statistics update;
- `data_parallel`, or a `mesh` over the process group: the step runs inside
  `multihost.global_batch` over the mesh's dp group (BatchNorm and the
  losses on the global batch) and averages the gradients across processes
  before the clip, the non-finite check and the optimizer;
- `tp=True` (tensor parallelism over the mesh's "mp" axis): between steps
  each mp rank holds only its `tp_spec` slice of every eligible parameter
  and of both Adam moments (`shard_state_to_mesh(tp=True)`), the memory
  JAX's `tp` saves. A step gathers the whole parameters over the mp group
  (the kernels take whole weights, as GSPMD gathers around a custom call),
  runs the forward and backward on the rank's dp rows (the mp ranks of one
  dp row hold the same rows), averages the gradients over the world (the
  mean over dp, then over the mp ranks, whose gradients agree), takes the
  norm of the whole gradient (so the clip and the skip decide alike on
  every rank) and hands the optimizer each rank's slice.

Unlike JAX, whose tensor parallelism runs within one process, the port's
runs over process subgroups: the port trains one process per card.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module

from ..utils.tree import tree_map
from . import multihost
from .remat import check_mode, regions


class Mesh:
    """A ("dp", "mp") grid: `devices` [n_dp, n_mp] holds `torch.device`s of
    this process, or process ranks (`over_ranks`, with the rank's dp and mp
    groups)."""

    axis_names = ("dp", "mp")

    def __init__(self, cells, n_dp: int, n_mp: int, over_ranks: bool = False,
                 groups=(None, None)):
        grid = np.empty(n_dp * n_mp, dtype=object)
        grid[:] = list(cells)
        self.devices = grid.reshape(n_dp, n_mp)
        self.over_ranks = over_ranks
        self.dp_group, self.mp_group = groups

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.devices.shape[0], "mp": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    def along(self, axis: Optional[str] = None) -> list:
        """The cells one per index of `axis` ("dp": the first mp column,
        "mp": the first dp row), or every cell in row-major order (None)."""
        if axis is None:
            return list(self.devices.flat)
        if axis not in self.axis_names:
            raise ValueError(f"no mesh axis {axis!r}; the axes are {self.axis_names}")
        return list(self.devices[:, 0] if axis == "dp" else self.devices[0, :])

    def __repr__(self):
        kind = "ranks" if self.over_ranks else "devices"
        return f"Mesh({kind}, dp={self.shape['dp']}, mp={self.shape['mp']})"


def make_mesh(n_dp: Optional[int] = None, n_mp: int = 1, devices=None) -> Mesh:
    """A ("dp", "mp") mesh. `devices=None` in an initialised process group
    is the world, one rank a cell (n_dp x n_mp must be the world; the dp and
    mp subgroups are made here, `multihost.mesh_groups`); without a group it
    is the current CUDA card once (raises where torch sees none). An
    explicit list of devices may repeat a device; the first n_dp x n_mp of
    them fill the grid row by row."""
    if devices is None and multihost.dist.is_initialized():
        world = multihost.process_count()
        n_dp = world // n_mp if n_dp is None else n_dp
        if n_dp * n_mp != world:
            raise ValueError(f"a mesh over the process group covers its {world} "
                             f"processes, not {n_dp} x {n_mp}")
        groups = multihost.mesh_groups(n_mp)
        return Mesh(range(world), n_dp, n_mp, over_ranks=True, groups=groups)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() builds on the current CUDA card and torch "
                               "sees none; pass devices=[torch.device('cpu')] * n for "
                               "the CPU")
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    n_dp = len(devices) // n_mp if n_dp is None else n_dp
    if n_dp < 1 or n_mp < 1 or n_dp * n_mp > len(devices):
        raise ValueError(f"a {n_dp} x {n_mp} mesh needs {n_dp * n_mp} devices, "
                         f"{len(devices)} given")
    return Mesh(devices[:n_dp * n_mp], n_dp, n_mp)


def tp_spec(shape, n_mp: int, min_size: int = 64) -> tuple:
    """Tensor-parallel spec of one parameter, by shape alone (JAX's rule):
    the largest axis that divides by n_mp and is at least `min_size` (ties
    to the later axis) is sharded over "mp" -> a tuple with "mp" there and
    None elsewhere; () keeps the leaf whole (n_mp <= 1, fewer than two
    axes, no eligible axis). The optimizer's moments have their
    parameter's shape, so the rule places them alike."""
    if n_mp <= 1 or len(shape) < 2:
        return ()
    best = -1
    for ax, n in enumerate(shape):
        if n % n_mp == 0 and n >= min_size and (best < 0 or n >= shape[best]):
            best = ax
    if best < 0:
        return ()
    spec = [None] * len(shape)
    spec[best] = "mp"
    return tuple(spec)


def _tp_axis(shape, n_mp: int, min_size: int) -> int:
    spec = tp_spec(tuple(shape), n_mp, min_size)
    return spec.index("mp") if spec else -1


def _rows(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} not divisible by the dp mesh axis ({parts})")
    return n // parts


def _local_mesh(mesh: Mesh, what: str) -> None:
    if mesh.over_ranks:
        raise ValueError(f"{what} is single-process: build its mesh from local devices "
                         "(make_mesh(devices=[...]))")


def shard_batch(mesh: Mesh, batch: Dict) -> object:
    """Split the global batch's leading axis over "dp". A mesh of local
    devices gives one dict per dp row, its rows on that row's device; a
    mesh over the process group gives this rank's rows (its dp index's)."""
    n_dp = mesh.shape["dp"]

    def take(v, i):
        if not isinstance(v, torch.Tensor) or v.dim() == 0:
            return v
        r = _rows(v.shape[0], n_dp, "batch")
        return v[i * r:(i + 1) * r]

    if mesh.over_ranks:
        i = multihost.dp_index()
        return {k: take(v, i) for k, v in batch.items()}
    return [{k: (t.to(d) if isinstance(t, torch.Tensor) else t)
             for k, t in ((k, take(v, i)) for k, v in batch.items())}
            for i, d in enumerate(mesh.along("dp"))]


def replicate_to_mesh(mesh: Mesh, tree) -> list:
    """A copy of `tree` for every cell of a mesh of local devices, in
    row-major order. (Over the process group every process builds the same
    state from one seed, as JAX's multi-process runs require.)"""
    _local_mesh(mesh, "replicate_to_mesh")
    return [tree_map(lambda x: x.to(d) if isinstance(x, torch.Tensor) else x, tree)
            for d in mesh.along()]


def shard_by_slots(mesh: Mesh, tree, n_slots: int, axis: str = "dp", slot_axes=None) -> list:
    """A serving state tree cut over `axis`: one tree per replica, on its
    device, each leaf's slot axis cut into equal contiguous parts (a
    slot-major folded axis [.., n_slots * f, ..] included). The slot axis is
    `slot_axes`' (`streaming.server.infer_slot_axes`, exact; -1 keeps a leaf
    whole on every replica, as SkiM's shared clock) or JAX's heuristic, the
    first axis whose size is n_slots, which a width equal to the slot count
    fools. Non-tensor leaves are shared."""
    _local_mesh(mesh, "shard_by_slots")
    devices = mesh.along(axis)
    n = len(devices)
    _rows(n_slots, n, "n_slots")

    def cut(i, d):
        def leaf(x, ax=None):
            if not isinstance(x, torch.Tensor):
                return x
            if ax is None:
                ax = next((a for a, s in enumerate(x.shape) if s == n_slots), -1)
            if ax < 0:
                return x.to(d)
            per = x.shape[ax] // n
            return x.narrow(ax, i * per, per).to(d)

        if slot_axes is not None:
            return tree_map(lambda a, x: leaf(x, a), slot_axes, tree)
        return tree_map(leaf, tree)

    return [cut(i, d) for i, d in enumerate(devices)]


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Callable:
    """`optax.adam`'s counterpart: params -> torch.optim.Adam (the two
    compute the same update)."""
    return functools.partial(torch.optim.Adam, lr=learning_rate,
                             betas=(b1, b2), eps=eps)


class TrainState:
    """Master model + optimizer + step count; under tensor parallelism the
    mesh and `tp_layout` (parameter name -> (sharded axis, whole shape)) of
    `shard_state_to_mesh`."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 step: int = 0):
        self.model, self.optimizer, self.step = model, optimizer, step
        self.mesh, self.tp_layout = None, {}

    @classmethod
    def create(cls, model: nn.Module, tx: Callable) -> "TrainState":
        """tx: params -> optimizer, e.g. `adam(1e-3)`."""
        return cls(model, tx(model.parameters()))

    def apply_gradients(self, grads: List[torch.Tensor]) -> "TrainState":
        """One optimizer step with `grads` (in `model.parameters()` order)."""
        for p, g in zip(self.model.parameters(), grads):
            p.grad = g
        self.optimizer.step()
        self.step += 1
        return self


# ------------------------------------------------------ tensor parallelism
_MOMENTS = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")


def _training_mesh(mesh: Mesh) -> None:
    if not mesh.over_ranks:
        raise ValueError("training takes a mesh over the process group, one process per "
                         "card: launch --num_processes N (with TRAIN.mp_devices k for "
                         "tensor parallelism) and build make_mesh(n_dp, n_mp) after "
                         "multihost.initialize; a mesh of local devices serves only")


def _slice(t: torch.Tensor, axis: int, n_mp: int) -> torch.Tensor:
    return t.chunk(n_mp, dim=axis)[multihost.mp_index()].clone()


def _gather(shards: List[torch.Tensor], axes: List[int], mesh: Mesh) -> List[torch.Tensor]:
    """The whole tensors of mp slices, one all-gather over the mp group per
    dtype."""
    out: List[torch.Tensor] = [None] * len(shards)
    n_mp = mesh.shape["mp"]
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(shards):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([shards[i].detach().reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(n_mp)]
        multihost.dist.all_gather(parts, flat, group=mesh.mp_group)
        off = 0
        for i in idx:
            n, shape = shards[i].numel(), shards[i].shape
            out[i] = torch.cat([p[off:off + n].view(shape) for p in parts], dim=axes[i])
            off += n
    return out


def shard_state_to_mesh(mesh: Mesh, state: TrainState, tp: bool = False,
                        tp_min_size: int = 64) -> TrainState:
    """Place a TrainState on a mesh over the process group (in place). With
    tp=True each rank keeps only its mp slice (`tp_spec`) of every eligible
    parameter and of its Adam moments; the rest stay whole on every rank.
    A resumed optimizer state is cut alike, so load a checkpoint (whole
    tensors) before this."""
    _training_mesh(mesh)
    n_mp = mesh.shape["mp"]
    state.mesh = mesh
    if not tp:
        return state
    opt = state.optimizer.state
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            ax = _tp_axis(p.shape, n_mp, tp_min_size)
            if ax < 0:
                continue
            state.tp_layout[name] = (ax, tuple(p.shape))
            for k in _MOMENTS:
                m = opt.get(p, {}).get(k)
                if isinstance(m, torch.Tensor) and m.shape == p.shape:
                    opt[p][k] = _slice(m, ax, n_mp)
            p.data = _slice(p.data, ax, n_mp)
    return state


def _sharded(state: TrainState):
    params = dict(state.model.named_parameters())
    names = list(state.tp_layout)
    return names, [params[n] for n in names], [state.tp_layout[n][0] for n in names]


def whole_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every parameter whole (detached), the sharded ones gathered over the
    mp group (a collective: every rank calls it)."""
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    if state.tp_layout:
        names, ps, axes = _sharded(state)
        params.update(zip(names, _gather(ps, axes, state.mesh)))
    return params


@contextlib.contextmanager
def gathered(state: TrainState) -> Iterator[TrainState]:
    """Inside, a tensor-parallel state's parameters and Adam moments are
    whole on every rank (the dev loss, inference, a checkpoint of whole
    tensors); after, each rank's slices again. A collective on entry: every
    rank enters. A state without sharded leaves passes through."""
    if not state.tp_layout:
        yield state
        return
    names, ps, axes = _sharded(state)
    opt = state.optimizer.state
    keys = [(p, k) for p in ps for k in _MOMENTS
            if isinstance(opt.get(p, {}).get(k), torch.Tensor)]
    moment_axes = {id(p): a for p, a in zip(ps, axes)}
    whole = _gather(ps + [opt[p][k] for p, k in keys],
                    axes + [moment_axes[id(p)] for p, _ in keys], state.mesh)
    n_mp = state.mesh.shape["mp"]
    with torch.no_grad():
        for p, w in zip(ps, whole):
            p.data = w
        for (p, k), w in zip(keys, whole[len(ps):]):
            opt[p][k] = w
    try:
        yield state
    finally:
        with torch.no_grad():
            for p, ax in zip(ps, axes):
                p.data = _slice(p.data, ax, n_mp)
            for p, k in keys:
                opt[p][k] = _slice(opt[p][k], moment_axes[id(p)], n_mp)


def make_train_step(model: nn.Module, loss_kwargs: Optional[Dict] = None,
                    grad_clip: Optional[float] = None, compute_dtype=None,
                    accum_steps: int = 1, skip_nonfinite: bool = False, *,
                    mesh: Optional[Mesh] = None, tp: bool = False, tp_min_size: int = 64,
                    remat=False, augment_fn: Optional[Callable] = None,
                    data_parallel: bool = False) -> Callable:
    """step(state, batch, generator=None) -> (state, metrics) for a wrapper
    whose forward returns its training loss (or (loss, details)); `batch`
    is a dict of forward kwargs (noisy / enroll / ref_clean / ...), and
    `generator` feeds `augment_fn`. The metrics are `loss`, `grad_norm`,
    `skipped` (with `skip_nonfinite`) and `loss_i` for each loss detail.
    With `mesh` (over the process group) the batch holds this rank's rows
    (its dp index's, `DataLoader(shard=(dp_index, dp_count))`); with `tp`
    the state comes from `shard_state_to_mesh(mesh, state, tp=True,
    tp_min_size=)` with the same `tp_min_size`."""
    if tp and mesh is None:
        raise ValueError("tp=True needs a mesh over the process group: make_mesh(n_dp, "
                         "n_mp) after multihost.initialize (--num_processes N with "
                         "TRAIN.mp_devices k)")
    if mesh is not None:
        _training_mesh(mesh)
        data_parallel = True
    if data_parallel and not multihost.dist.is_initialized():
        raise ValueError("data_parallel needs multihost.initialize first")
    group = mesh.dp_group if mesh is not None else None
    loss_kwargs = loss_kwargs or {}

    check_mode(remat)

    def cast(t):
        if (compute_dtype is not None and isinstance(t, torch.Tensor)
                and t.dtype == torch.float32):
            return t.to(compute_dtype)
        return t

    def split(v):
        if not isinstance(v, torch.Tensor) or v.dim() == 0:
            return [v] * accum_steps
        if v.shape[0] % accum_steps:
            raise ValueError(f"batch {v.shape[0]} must divide accum_steps "
                             f"{accum_steps}")
        return list(v.chunk(accum_steps))

    def micro(net, params, stats, batch):
        """(loss, details, grads, new stats) of one micro-batch."""
        tensors = {n: cast(p) for n, p in params.items()}
        bufs = {n: cast(b) for n, b in stats.items()}
        tensors.update(bufs)
        # the module runs on `tensors` through the backward too, where
        # remat's blocks are recomputed
        with _reparametrize_module(net, tensors, strict=True), regions(net, remat):
            out = net(**{k: cast(v) for k, v in batch.items()}, **loss_kwargs)
            loss, detail = out if isinstance(out, tuple) else (out, None)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), grads)]
        # BatchNorm updated the buffers it was given (in place, or rebound
        # to float32 statistics when they were cast); read them back
        new_stats = {n: tensors[n].detach().to(stats[n].dtype) for n in stats}
        as_f32 = lambda t: t.detach().float() if compute_dtype else t.detach()
        detail = None if detail is None else [as_f32(d) for d in detail]
        return as_f32(loss), detail, grads, new_stats

    def grads_of(net, params, stats, batch):
        if not data_parallel:
            return micro(net, params, stats, batch)
        with multihost.global_batch(net, group):
            return micro(net, params, stats, batch)

    def step(state: TrainState, batch: Dict, generator: Optional[torch.Generator] = None):
        net = state.model
        if net is not model:
            raise ValueError("the state holds another module than the step's")
        if augment_fn is not None:
            if generator is None:
                raise ValueError("a step with augment_fn needs its generator")
            batch = augment_fn(generator, batch)
        if tp and state.mesh is not mesh:
            raise ValueError("tp=True: place the state with shard_state_to_mesh(mesh, "
                             "state, tp=True) first")
        if state.tp_layout and not tp:
            raise ValueError("a tensor-parallel state needs the step's tp=True")
        sharded = state.tp_layout
        if sharded and any(_tp_axis(shape, mesh.shape["mp"], tp_min_size) != ax
                                  for ax, shape in sharded.values()):
            raise ValueError("the state was sharded with another tp_min_size")
        was_training = net.training
        net.train()
        if sharded:
            # the whole parameters, gathered over mp, are the leaves the
            # gradients are taken against
            params = {n: t.requires_grad_() for n, t in whole_params(state).items()}
        else:
            params = dict(net.named_parameters())
        old_stats = {n: b.detach() for n, b in net.named_buffers()}
        stats = {n: b.clone() for n, b in old_stats.items()}
        if accum_steps > 1:
            pieces = {k: split(v) for k, v in batch.items()}
            grads, loss, details = None, 0.0, []
            for i in range(accum_steps):
                mloss, mdetail, mgrads, stats = grads_of(
                    net, params, stats, {k: v[i] for k, v in pieces.items()})
                grads = mgrads if grads is None else [
                    a + b for a, b in zip(grads, mgrads)]
                loss = loss + mloss
                details.append(mdetail)
            grads = [g / accum_steps for g in grads]
            loss = loss / accum_steps
            detail = (None if details[0] is None else
                      [torch.stack(d).mean(0) for d in zip(*details)])
        else:
            loss, detail, grads, stats = grads_of(net, params, stats, batch)
        net.train(was_training)
        if data_parallel:
            # over the world: the mean over dp, and over the mp ranks of a dp
            # row, whose gradients agree (the same rows), so every rank then
            # holds the same whole gradient
            grads = multihost.all_reduce_mean(grads)

        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if grad_clip is not None:
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            grads = [g * scale.to(g.dtype) for g in grads]
        metrics = {"loss": loss, "grad_norm": gnorm}
        if skip_nonfinite:
            ok = torch.isfinite(gnorm) & torch.isfinite(loss)
            grads = [torch.where(ok, g, torch.zeros_like(g)) for g in grads]
            stats = {n: torch.where(ok, s, old_stats[n]) for n, s in stats.items()}
            metrics["skipped"] = (~ok).float()
        if sharded:
            n_mp = mesh.shape["mp"]
            grads = [_slice(g, sharded[n][0], n_mp) if n in sharded else g
                     for n, g in zip(params, grads)]
        state.apply_gradients(grads)
        with torch.no_grad():
            for n, b in net.named_buffers():
                b.copy_(stats[n])
        if detail is not None:
            for i, d in enumerate(detail):
                metrics[f"loss_{i}"] = d
        return state, metrics

    return step
