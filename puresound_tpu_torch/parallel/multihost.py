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

#: set inside `global_batch`: BatchNorm all-reduces its batch sums
_SYNC = {"on": False}


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
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


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
    """Sum over processes; the gradient of every input is the sum of the
    gradients of the output over processes."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _AllGather(torch.autograd.Function):
    """Concatenate every process's rows in process order; each process's
    rows get the sum over processes of the gradient of theirs."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        r = dist.get_rank() * ctx.rows
        return g[r:r + ctx.rows]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return _AllReduceSum.apply(x)


def all_gather_rows(x):
    """x [b, ...] on every process -> [world * b, ...] in process order
    (differentiable for floating tensors; others pass through as they are
    when they are not tensors of at least one dimension)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    if x.is_floating_point():
        return _AllGather.apply(x)
    as_bytes = x.dtype == torch.bool
    y = x.to(torch.uint8) if as_bytes else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, y)
    out = torch.cat(parts)
    return out.bool() if as_bytes else out


def all_reduce_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over processes of each tensor, through one flat buffer per
    dtype (one all-reduce each)."""
    world = process_count()
    out: List[torch.Tensor] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        flat = flat / world
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def syncing() -> bool:
    """Whether BatchNorm takes the global batch's statistics here."""
    return _SYNC["on"]


class _GatheredLoss:
    """A loss callable whose tensor inputs are first gathered over
    processes."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return self.fn(*[all_gather_rows(a) for a in args],
                       **{k: all_gather_rows(v) for k, v in kwargs.items()})


_LOSSES = ("loss_func_wav", "loss_func_spk")


@contextlib.contextmanager
def global_batch(model: nn.Module) -> Iterator[None]:
    """Inside: BatchNorm's training statistics and the wrapper's losses
    (`loss_func_wav`, `loss_func_spk`) are those of the global batch. A
    loss that is a module (AAM-softmax, GE2E) gathers its inputs in a
    forward pre-hook; a plain callable is wrapped for the duration."""
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
                    lambda m, args, kwargs: (tuple(all_gather_rows(a) for a in args),
                                             {k: all_gather_rows(v)
                                              for k, v in kwargs.items()}),
                    with_kwargs=True)
                undo.append(hook.remove)
            else:
                setattr(model, name, _GatheredLoss(fn))
                undo.append(lambda name=name, fn=fn: setattr(model, name, fn))
        prev, _SYNC["on"] = _SYNC["on"], True
        undo.append(lambda: _SYNC.__setitem__("on", prev))
        yield
    finally:
        for fn in reversed(undo):
            fn()
