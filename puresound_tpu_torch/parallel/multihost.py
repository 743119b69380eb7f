"""Multi-process data parallelism on `torch.distributed` (counterpart of
puresound_tpu/parallel/multihost.py).

One process per card (or per CPU host under gloo). Every process runs the
same step in lockstep on its own rows of the global batch
(`DataLoader(shard=(process_id, n_processes))`), and the step computes
what one process computes on the whole global batch, as JAX's global mesh
does:

- BatchNorm in training normalises with the global batch's statistics:
  inside `global_batch` its moments are all-reduced (differentiably);
- the wrapper's losses see the global batch: their inputs are all-gathered
  in process order (differentiably), so a masked or thresholded mean is the
  global one and every process holds the same loss;
- the gradients are averaged across processes (`all_reduce_mean`) before
  the clip, the non-finite check and the optimizer.

Checkpoints, logs and dev prints are the primary's (`is_primary`).

Tensor parallelism (`parallel.mesh.make_train_step(tp=True)`) lays the
world out as a ("dp", "mp") grid, rank r at (r // n_mp, r % n_mp), as JAX's
`make_mesh` reshapes its devices. `mesh_groups(n_mp)` makes the subgroups:
the ranks of one dp row share an "mp" group and hold the same rows of the
global batch; the ranks of one mp column share a "dp" group. The global
batch, BatchNorm's moments and the gradient mean then run over the dp group
(`group()`): over the world they would count the mp ranks' rows n_mp times.
`dp_index()` / `dp_count()` say which rows a rank loads.

Launch (the same argv on every process apart from --process_id):

    python -m puresound_tpu_torch.egs.ns.main conf.yaml --action train \\
        --coordinator host0:1234 --num_processes 2 --process_id {0,1}
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List

import torch
import torch.distributed as dist
from torch import nn

#: set inside `global_batch`: BatchNorm all-reduces its batch sums over
#: `group` (None: the world)
_SYNC = {"on": False, "group": None}
#: the ("dp", "mp") layout of the world: n_mp, this rank's dp group (None:
#: the world) and the (dp, mp) groups made by `mesh_groups`, by n_mp
_MESH = {"n_mp": 1, "dp": None, "groups": {}}


def initialize(coordinator: str, num_processes: int, process_id: int,
               device) -> None:
    """Join the process group at `coordinator` (host:port of process 0):
    NCCL when `device` is a CUDA device, gloo when it is the CPU, chosen by
    that device and by nothing else. A world of one is a group too."""
    device = torch.device(device)
    if device.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(device)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside 0..{num_processes - 1}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group (a no-op outside one) and forget its mesh
    groups."""
    _MESH.update(n_mp=1, dp=None, groups={})
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_groups(n_mp: int):
    """(dp group, mp group) of this rank in the (world / n_mp, n_mp) grid,
    made once per n_mp (every process calls this alike: `new_group` is
    collective) and kept as the layout `dp_index`, `dp_count`, `mp_index`
    and `group` read. n_mp = 1 is the plain data-parallel layout: the world
    is the dp group and there is no mp group."""
    world, rank = process_count(), process_index()
    if n_mp < 1 or world % n_mp:
        raise ValueError(f"mp size {n_mp} does not divide the {world} processes")
    if n_mp not in _MESH["groups"]:
        if n_mp == 1:
            _MESH["groups"][1] = (None, None)
        else:
            n_dp = world // n_mp
            mp = [dist.new_group([i * n_mp + j for j in range(n_mp)]) for i in range(n_dp)]
            dp = [dist.new_group([i * n_mp + j for i in range(n_dp)]) for j in range(n_mp)]
            _MESH["groups"][n_mp] = (dp[rank % n_mp], mp[rank // n_mp])
    _MESH["n_mp"], _MESH["dp"] = n_mp, _MESH["groups"][n_mp][0]
    return _MESH["groups"][n_mp]


def dp_index() -> int:
    """This rank's row of the grid: which part of the global batch it
    loads (the loader's shard)."""
    return process_index() // _MESH["n_mp"]


def dp_count() -> int:
    return process_count() // _MESH["n_mp"]


def mp_index() -> int:
    """This rank's column: which slice of a tensor-parallel leaf it holds."""
    return process_index() % _MESH["n_mp"]


def group():
    """The dp group (None, the world, without tensor parallelism)."""
    return _MESH["dp"]


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host-side I/O (checkpoints, logs, dev
    prints, eval audio)."""
    return process_index() == 0


def host_local(tree):
    """Tensors of a (nested) dict / list -> host numpy arrays."""
    if isinstance(tree, dict):
        return {k: host_local(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_local(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# ------------------------------------------------------------ collectives
class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes of `group`; the gradient of every input is the
    sum of the gradients of the output over them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """Concatenate the rows of `group`'s processes in rank order; each
    process's rows get the sum over them of the gradient of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rows, ctx.group = x.shape[0], group
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group) * ctx.rows
        return g[r:r + ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x, group=None):
    """x [b, ...] on every process of `group` (None: the world) -> [n * b,
    ...] in rank order (differentiable for floating tensors; others pass
    through as they are when they are not tensors of at least one
    dimension)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    if x.is_floating_point():
        return _AllGather.apply(x, group)
    as_bytes = x.dtype == torch.bool
    y = x.to(torch.uint8) if as_bytes else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts)
    return out.bool() if as_bytes else out


def all_reduce_mean(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The mean over the processes of `group` (None: the world) of each
    tensor, through one flat buffer per dtype (one all-reduce each)."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    out: List[torch.Tensor] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat = flat / world
        off = 0
        for i in idx:
            n = tensors[i].numel()
            # laid out as the input (a gradient may come transposed): the
            # gradient norm then reduces in the plain step's order, and a
            # world of one stays bit-equal to it
            out[i] = torch.empty_like(tensors[i]).copy_(flat[off:off + n].view(
                tensors[i].shape))
            off += n
    return out


def syncing() -> bool:
    """Whether BatchNorm takes the global batch's statistics here."""
    return _SYNC["on"]


def sync_group():
    """The group BatchNorm reduces its moments over inside `global_batch`."""
    return _SYNC["group"]


class _GatheredLoss:
    """A loss callable whose tensor inputs are first gathered over the
    processes of `group`."""

    def __init__(self, fn, group):
        self.fn, self.group = fn, group

    def __call__(self, *args, **kwargs):
        g = self.group
        return self.fn(*[all_gather_rows(a, g) for a in args],
                       **{k: all_gather_rows(v, g) for k, v in kwargs.items()})


_LOSSES = ("loss_func_wav", "loss_func_spk")


@contextlib.contextmanager
def global_batch(model: nn.Module, group=None) -> Iterator[None]:
    """Inside: BatchNorm's training statistics and the wrapper's losses
    (`loss_func_wav`, `loss_func_spk`) are those of the global batch, the
    rows of `group`'s processes (None: the world; under tensor parallelism
    the dp group). A loss that is a module (AAM-softmax, GE2E) gathers its
    inputs in a forward pre-hook; a plain callable is wrapped for the
    duration."""
    if not dist.is_initialized():
        raise RuntimeError("global_batch needs an initialized process group "
                           "(multihost.initialize)")
    undo = []
    try:
        for name in _LOSSES:
            fn = getattr(model, name, None)
            if fn is None:
                continue
            if isinstance(fn, nn.Module):
                hook = fn.register_forward_pre_hook(
                    lambda m, args, kwargs: (tuple(all_gather_rows(a, group) for a in args),
                                             {k: all_gather_rows(v, group)
                                              for k, v in kwargs.items()}),
                    with_kwargs=True)
                undo.append(hook.remove)
            else:
                setattr(model, name, _GatheredLoss(fn, group))
                undo.append(lambda name=name, fn=fn: setattr(model, name, fn))
        prev = dict(_SYNC)
        _SYNC.update(on=True, group=group)
        undo.append(lambda: _SYNC.update(prev))
        yield
    finally:
        for fn in reversed(undo):
            fn()
