"""Speaker / embedding losses: GE2E, Triplet, soft F1 (counterpart of
puresound_tpu/nnet/loss/metrics.py: GE2ELoss `:18`, TripletLoss `:75`,
F1Loss `:104`).

GE2E's leave-one-out centroids and cosine matrix are one vectorised
computation, as in the JAX package; its scale `w` and bias `b` are
parameters, so they train with the model and sit in its state under the
wrapper's `loss_func_spk`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...utils.init import const


def _unit(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=1e-12)


def _cos(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(-1) / (torch.linalg.vector_norm(u, dim=-1)
                              * torch.linalg.vector_norm(v, dim=-1))


class GE2ELoss(nn.Module):
    """Generalized end-to-end loss on d-vectors [nspks * putts, D], grouped
    by speaker; `loss_method` "softmax" or "contrast". Returns the sum over
    utterances; the label is ignored."""

    def __init__(self, nspks: int, putts: int, init_w: float = 10.0,
                 init_b: float = -5.0, loss_method: str = "softmax",
                 add_norm: bool = True, *, device=None, dtype=torch.float32):
        super().__init__()
        if loss_method not in ("softmax", "contrast"):
            raise NameError(loss_method)
        self.nspks, self.putts = nspks, putts
        self.loss_method, self.add_norm = loss_method, add_norm
        self.w = const((), init_w, device, dtype)
        self.b = const((), init_b, device, dtype)

    def forward(self, dvecs: torch.Tensor,
                label: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.add_norm:
            dvecs = _unit(dvecs, 1)
        N, M = self.nspks, self.putts
        dvecs = dvecs.reshape(N, M, -1)
        # leave-one-out centroids: the own speaker's excludes the utterance
        sums = dvecs.sum(1)
        centroids = sums / M
        excl = (sums[:, None, :] - dvecs) / (M - 1)
        sim_all = _cos(dvecs[:, :, None, :], centroids[None, None])      # [N, M, N]
        sim_own = _cos(dvecs, excl)                                       # [N, M]
        eye = torch.eye(N, dtype=torch.bool, device=dvecs.device)[:, None, :]
        cos_sim = torch.where(eye, sim_own[:, :, None], sim_all).clamp(min=1e-6)
        cos_sim = cos_sim * self.w + self.b
        own = torch.arange(N, device=dvecs.device)[:, None, None].expand(N, M, 1)
        if self.loss_method == "softmax":
            L = -torch.gather(torch.log_softmax(cos_sim, dim=-1), -1, own)[..., 0]
        else:
            sig = torch.sigmoid(cos_sim)
            others = torch.where(eye, torch.full_like(sig, -torch.inf), sig)
            L = 1.0 - torch.gather(sig, -1, own)[..., 0] + others.amax(-1)
        return L.sum()


class TripletLoss:
    """Margin triplet loss on [N, 3, C] = (anchor, positive, negative);
    `distance` "Euclidean" or "cosine" (also spelled "consine")."""

    def __init__(self, margin: float = 0.0, add_norm: bool = True,
                 distance: str = "Euclidean"):
        if distance.lower() not in ("euclidean", "cosine", "consine"):
            raise NameError(distance)
        self.margin, self.add_norm, self.distance = margin, add_norm, distance

    def __call__(self, x: torch.Tensor, reduction: bool = True) -> torch.Tensor:
        if x.shape[1] != 3:
            raise ValueError(f"TripletLoss takes [N, 3, C], got {tuple(x.shape)}")
        if self.add_norm:
            x = _unit(x, -1)
        anchor, pos, neg = x[:, 0], x[:, 1], x[:, 2]
        if self.distance.lower() == "euclidean":
            d_pos = torch.sqrt(((anchor - pos) ** 2).sum(-1) + 1e-8)
            d_neg = torch.sqrt(((anchor - neg) ** 2).sum(-1) + 1e-8)
        else:
            def cos(a, b):
                return (a * b).sum(-1) / torch.sqrt((a * a).sum(-1) * (b * b).sum(-1))
            d_pos, d_neg = cos(anchor, pos), cos(anchor, neg)
        loss = torch.clamp(d_pos - d_neg + self.margin, min=0.0)
        return loss.mean() if reduction else loss


class F1Loss:
    """Soft F1 loss (1 - F1) of sigmoid outputs against 0/1 targets."""

    def __init__(self, eps: float = 1e-10):
        self.eps = eps

    def __call__(self, estimates: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        tp = (targets * estimates).sum()
        fp = ((1 - targets) * estimates).sum()
        fn = (targets * (1 - estimates)).sum()
        precision = tp / (tp + fp + self.eps)
        recall = tp / (tp + fn + self.eps)
        return 1 - 2 * precision * recall / (precision + recall + self.eps)


# the reference's class name
F1_loss = F1Loss
