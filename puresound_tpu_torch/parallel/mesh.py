"""The training step (counterpart of puresound_tpu/parallel/mesh.py:111-329).

`TrainState` holds the float32 master `nn.Module` (its buffers are the
BatchNorm running statistics, JAX's `batch_stats`), an optimizer built over
its parameters and the step count. `make_train_step` returns
`step(state, batch) -> (state, metrics)` with JAX's semantics:

- mixed precision: with `compute_dtype`, every float32 parameter, buffer and
  batch tensor is cast to it and the forward and backward run on the casts
  (through `torch.func.functional_call`; not `torch.autocast`, which keeps
  chosen ops in float32). The gradients reach the masters through the cast;
  the loss and the new running statistics come back in float32;
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
model's device. Sharding (`mesh`, `tp`), rematerialisation (`remat`) and
in-step augmentation (`augment_fn`) are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.func import functional_call


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Callable:
    """`optax.adam`'s counterpart: params -> torch.optim.Adam (the two
    compute the same update)."""
    return functools.partial(torch.optim.Adam, lr=learning_rate,
                             betas=(b1, b2), eps=eps)


class TrainState:
    """Master model + optimizer + step count."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 step: int = 0):
        self.model, self.optimizer, self.step = model, optimizer, step

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


def _not_ported(name: str):
    raise NotImplementedError(
        f"make_train_step({name}=...) is not ported yet (ROADMAP queue 1: "
        "the trainer; queue 8: multi-device)")


def make_train_step(model: nn.Module, loss_kwargs: Optional[Dict] = None,
                    grad_clip: Optional[float] = None, compute_dtype=None,
                    accum_steps: int = 1, skip_nonfinite: bool = False, *,
                    mesh=None, tp: bool = False, remat=False,
                    augment_fn: Optional[Callable] = None) -> Callable:
    """step(state, batch) -> (state, metrics) for a wrapper whose forward
    returns its training loss (or (loss, details)); `batch` is a dict of
    forward kwargs (noisy / enroll / ref_clean / ...). The metrics are
    `loss`, `grad_norm`, `skipped` (with `skip_nonfinite`) and `loss_i`
    for each loss detail."""
    for name, value in (("mesh", mesh), ("tp", tp), ("remat", remat),
                        ("augment_fn", augment_fn)):
        if value:
            _not_ported(name)
    loss_kwargs = loss_kwargs or {}

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
        out = functional_call(net, tensors, (),
                              {**{k: cast(v) for k, v in batch.items()},
                               **loss_kwargs}, strict=True)
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

    def step(state: TrainState, batch: Dict):
        net = state.model
        if net is not model:
            raise ValueError("the state holds another module than the step's")
        was_training = net.training
        net.train()
        params = dict(net.named_parameters())
        old_stats = {n: b.detach() for n, b in net.named_buffers()}
        stats = {n: b.clone() for n, b in old_stats.items()}
        if accum_steps > 1:
            pieces = {k: split(v) for k, v in batch.items()}
            grads, loss, details = None, 0.0, []
            for i in range(accum_steps):
                mloss, mdetail, mgrads, stats = micro(
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
            loss, detail, grads, stats = micro(net, params, stats, batch)
        net.train(was_training)

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
        state.apply_gradients(grads)
        with torch.no_grad():
            for n, b in net.named_buffers():
                b.copy_(stats[n])
        if detail is not None:
            for i, d in enumerate(detail):
                metrics[f"loss_{i}"] = d
        return state, metrics

    return step
