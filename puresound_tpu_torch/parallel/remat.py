"""Recomputing the forward in the backward (`TRAIN.remat`, counterpart of
`jax.checkpoint` in puresound_tpu/parallel/mesh.py:219-227).

`regions(model, mode)` runs every block of the model under
`torch.utils.checkpoint` (the non-reentrant one, `checkpointed`): the
encoder, the enrollment's encoder (`encoder_spk`), the speaker net's layers
and the masker's blocks (the elements of its module lists, or its other
children: a Unet masker's down / up / skip layers and each TCN, GatedTCN or
FSMN block of UnetTcn / UnetFsmn), so the backward recomputes them
one block at a time and holds one block's activations at once. `True`
keeps only each block's inputs; `"dots"` also keeps the outputs of the
matrix products and convolutions (`DOT_OPS`, what `checkpoint_dots` keeps)
and recomputes the rest. What lies between the blocks (the masks, the
decoder, the loss) is not recomputed. The port's kernels are
`autograd.Function`s whose launches the dispatcher does not see, so no
policy can keep their outputs: under both modes each runs again in the
backward, as a Pallas call does under `checkpoint_dots` (their plain
versions on the CPU are aten ops, whose products the policy keeps).

Two pieces of module state would make the recomputation differ from the
forward, where JAX's functional checkpoint has none:

- `Dropout` and `SpecAugment` draw a fresh seed from the model's generator
  on every call, and `torch.utils.checkpoint` restores only torch's default
  generators. The forward records the seeds it drew (`dropout_seed`, which
  `seeded_generator` draws through), and
  the recomputation replays them;
- BatchNorm in training updates its running statistics on every call. The
  recomputation does not (`recomputing`).
"""
from __future__ import annotations

import collections
import contextlib
from typing import Callable, Iterator, List

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

aten = torch.ops.aten

#: the products whose outputs `"dots"` keeps
DOT_OPS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.addbmm, aten.mv,
           aten.dot, aten.matmul, aten.linear, aten.convolution, aten._convolution,
           aten.cudnn_convolution, aten.mkldnn_convolution,
           aten.convolution_overrideable, aten.cudnn_convolution_transpose}

_STATE = {"record": None, "replay": None}


def dropout_seed(generator: torch.Generator) -> int:
    """A dropout seed from `generator`; recorded inside a checkpointed
    forward, replayed in order inside its recomputation."""
    replay = _STATE["replay"]
    if replay is not None:
        return replay.popleft()
    seed = int(torch.randint(2 ** 62, (), generator=generator))
    if _STATE["record"] is not None:
        _STATE["record"].append(seed)
    return seed


def seeded_generator(generator: torch.Generator, cache: dict,
                     device: torch.device) -> torch.Generator:
    """The generator of `device` kept in a module's `cache` (made at its
    first use), seeded with `dropout_seed(generator)`: what `Dropout` and
    `SpecAugment` draw from, so a recomputation draws the same."""
    seed = dropout_seed(generator)
    if device not in cache:
        cache[device] = torch.Generator(device=device)
    return cache[device].manual_seed(seed)


def recomputing() -> bool:
    """Whether a checkpointed forward is being recomputed (BatchNorm then
    leaves its running statistics as they are)."""
    return _STATE["replay"] is not None


@contextlib.contextmanager
def _swap(**values):
    prev = {k: _STATE[k] for k in values}
    _STATE.update(values)
    try:
        yield
    finally:
        _STATE.update(prev)


def _dots_policy(ctx, op, *args, **kwargs):
    if op.overloadpacket in DOT_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _contexts(dots: bool):
    seeds: List[int] = []

    @contextlib.contextmanager
    def forward():
        with contextlib.ExitStack() as stack:
            if dots:
                stack.enter_context(sac[0])
            stack.enter_context(_swap(record=seeds))
            yield

    @contextlib.contextmanager
    def recompute():
        with contextlib.ExitStack() as stack:
            if dots:
                stack.enter_context(sac[1])
            stack.enter_context(_swap(record=None, replay=collections.deque(seeds)))
            yield

    sac = _ckpt.create_selective_checkpoint_contexts(_dots_policy) if dots else None
    return forward(), recompute()


def check_mode(mode) -> None:
    """Refuse a remat mode other than a false one, True or "dots"."""
    if mode and mode not in (True, "dots"):
        raise ValueError(f"remat must be False, True or 'dots', not {mode!r}")


def checkpointed(fn: Callable, mode) -> Callable:
    """`fn` itself for a false `mode`; else `fn` recomputed in the backward
    (`True`: all of it; `"dots"`: all but the products' outputs)."""
    check_mode(mode)
    if not mode:
        return fn
    dots = mode == "dots"

    def run(*args, **kwargs):
        return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                                context_fn=lambda: _contexts(dots), **kwargs)
    return run



def blocks(model: nn.Module) -> List[nn.Module]:
    """The modules `regions` recomputes: the wrapper's encoder and
    enrollment encoder, its speaker net's layers and its masker's blocks
    (the leaves of nested module lists; any other child whole)."""
    out: List[nn.Module] = []

    def leaves(m: nn.Module):
        if isinstance(m, nn.ModuleList):
            for c in m:
                leaves(c)
        else:
            out.append(m)

    for name in ("encoder", "encoder_spk", "speaker_net"):
        if getattr(model, name, None) is not None:
            leaves(getattr(model, name))
    masker = getattr(model, "masker", None)
    for child in (masker.children() if masker is not None else ()):
        leaves(child)
    return out


@contextlib.contextmanager
def regions(model: nn.Module, mode) -> Iterator[None]:
    """Inside (the forward and the backward both): each of `blocks(model)`
    recomputed in the backward under `mode` (False: nothing changes)."""
    if not mode:
        yield
        return
    wrapped = blocks(model)
    for m in wrapped:
        m.forward = checkpointed(type(m).forward.__get__(m), mode)
    try:
        yield
    finally:
        for m in wrapped:
            del m.forward
