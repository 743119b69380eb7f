"""SDR loss family (counterpart of puresound_tpu/nnet/loss/sdr.py).

SI-SNR / SD-SDR / SDR / t-SDR and their source-aggregated forms, with
inactive-source handling and hard-threshold keeps. As in the JAX package
both branches are computed for every item and combined with masked means,
so shapes never depend on the data and nothing reads back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def l2_norm(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """<s1, s2> over the last axis, keepdims."""
    return torch.sum(s1 * s2, dim=-1, keepdim=True)


def _zero_mean(s):
    return s - torch.mean(s, dim=-1, keepdim=True)


def _where0(mask, v):
    return torch.where(mask, v, torch.zeros_like(v))


def inactive_sdr_loss(s1: torch.Tensor, s2: torch.Tensor,
                      reduction: bool = True) -> torch.Tensor:
    """Energy-suppression loss for inactive targets:
    10*log10(||enh||^2 + 0.01*||mix||^2)."""
    s1, s2 = _zero_mean(s1), _zero_mean(s2)
    val = 10 * torch.log10(l2_norm(s1, s1) + 0.01 * l2_norm(s2, s2) + 1e-8)
    return torch.mean(val) if reduction else val


def si_snr(s1: torch.Tensor, s2: torch.Tensor, eps: float = 1e-8,
           reduction: bool = True) -> torch.Tensor:
    """SI-SNR metric (s1 = estimate, s2 = reference), in dB."""
    s1, s2 = _zero_mean(s1), _zero_mean(s2)
    s_target = l2_norm(s1, s2) / (l2_norm(s2, s2) + eps) * s2
    e_noise = s1 - s_target
    snr = 10 * torch.log10(l2_norm(s_target, s_target)
                           / (l2_norm(e_noise, e_noise) + eps) + eps)
    return torch.mean(snr) if reduction else snr


@dataclass(frozen=True)
class SDRLoss:
    """Configurable negative-SDR training loss (callable).

    compat=True reproduces the reference's source-aggregated quirk (the
    "aggregation" sums the size-1 keepdim axis, so nothing aggregates);
    compat=False is the real SA-SDR: power summed over the source axis
    before the log, one ratio per mixture.
    """

    scaled: bool = True
    scale_dependent: bool = False
    zero_mean: bool = True
    source_aggregated: bool = False
    sdr_max: Optional[int] = None
    eps: float = 1e-8
    reduction: bool = True
    threshold: Optional[float] = None
    compat: bool = False

    @classmethod
    def init_mode(cls, loss_func: str = "sisnr", reduction: bool = True,
                  threshold: Optional[float] = None,
                  compat: bool = False) -> "SDRLoss":
        loss_func = loss_func.lower()
        if loss_func not in ("sisnr", "sdsdr", "sdr", "tsdr", "sasdr",
                             "sasisnr", "satsdr"):
            raise NameError(loss_func)
        # the reference's alias logic, substring quirk included: "sdr" is
        # scaled and "sasisnr" is not (it compares against "sasisdr")
        return cls(scaled=loss_func in ("sisnr", "sdsdr", "sdr"),
                   scale_dependent=loss_func == "sdsdr", zero_mean=True,
                   source_aggregated=loss_func in ("sasdr", "sasisnr", "satsdr"),
                   sdr_max=30 if loss_func in ("tsdr", "satsdr") else None,
                   eps=1e-8, reduction=reduction, threshold=threshold,
                   compat=compat)

    def _norms(self, s1, s2):
        """Per-signal target/noise power terms, [..., 1] (keepdims)."""
        if self.zero_mean:
            s1, s2 = _zero_mean(s1), _zero_mean(s2)
        if self.scaled:
            s_target = l2_norm(s1, s2) / (l2_norm(s2, s2) + self.eps) * s2
        else:
            s_target = s2
        e_noise = (s1 - s2) if self.scale_dependent else (s1 - s_target)
        target_norm = l2_norm(s_target, s_target)
        noise_norm = l2_norm(e_noise, e_noise)
        if self.sdr_max is not None:
            tau = 10 ** (-self.sdr_max / 10)
            noise_norm = noise_norm + tau * target_norm
        return target_norm, noise_norm

    def _batch_snr(self, s1, s2):
        """Per-item negative SNR, [..., 1]."""
        target_norm, noise_norm = self._norms(s1, s2)
        if not self.source_aggregated:
            snr = 10 * torch.log10(target_norm / (noise_norm + self.eps) + self.eps)
        else:   # compat: the no-op sum over the size-1 keepdim axis
            snr = 10 * torch.log10(torch.sum(target_norm, dim=-1)
                                   / (torch.sum(noise_norm, dim=-1) + self.eps)
                                   + self.eps)
        return -snr

    def _keep(self, active, snr):
        """Active items whose loss is above the threshold; all active items
        when none is."""
        if self.threshold is None:
            return active
        keep = active & (snr > self.threshold)
        return torch.where(keep.any(), keep, active)

    def _sa_call(self, s1, s2, inactive_labels):
        """True SA-SDR: one ratio per mixture over its ACTIVE sources;
        inactive sources score the energy-suppression loss in the same
        masked mean."""
        N, M, L = s1.shape
        target_norm, noise_norm = self._norms(s1, s2)
        target_norm, noise_norm = target_norm[..., 0], noise_norm[..., 0]
        if inactive_labels is None:
            act = torch.ones((N, M), dtype=torch.bool, device=s1.device)
        else:
            act = ~inactive_labels.reshape(N, M).bool()
        tn = torch.sum(_where0(act, target_norm), dim=1)
        nn_ = torch.sum(_where0(act, noise_norm), dim=1)
        snr = -10 * torch.log10(tn / (nn_ + self.eps) + self.eps)
        has_active = act.any(dim=1)
        inact = inactive_sdr_loss(s1.reshape(N * M, L), s2.reshape(N * M, L),
                                  reduction=False).reshape(N, M)
        keep = self._keep(has_active, snr)
        total = torch.sum(_where0(keep, snr)) + torch.sum(_where0(~act, inact))
        count = keep.sum() + (~act).sum()
        if self.reduction:
            return total / count.clamp_min(1)
        return torch.where(has_active, snr, inact.mean(dim=1))

    def __call__(self, s1: torch.Tensor, s2: torch.Tensor,
                 inactive_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """s1: estimate, s2: reference; [N, L] (or [N, M, L] when
        source_aggregated, with inactive_labels [N, M])."""
        if self.source_aggregated:
            if s1.dim() != 3:
                raise ValueError("source_aggregated expects [N, M, L]")
            if not self.compat:
                return self._sa_call(s1, s2, inactive_labels)
        elif s1.dim() != 2:
            raise ValueError("expects [N, L]")

        snr = self._batch_snr(s1, s2).reshape(-1)
        if inactive_labels is None:
            inactive = torch.zeros_like(snr, dtype=torch.bool)
            inact = torch.zeros_like(snr)
        else:
            inactive = inactive_labels.reshape(-1).bool()
            inact = inactive_sdr_loss(s1.reshape(-1, s1.shape[-1]),
                                      s2.reshape(-1, s2.shape[-1]),
                                      reduction=False).reshape(-1)
        keep = self._keep(~inactive, snr)
        total = torch.sum(_where0(keep, snr)) + torch.sum(_where0(inactive, inact))
        count = keep.sum() + inactive.sum()
        if self.reduction:
            return total / count.clamp_min(1)
        return torch.where(inactive, inact, snr)


def attenuation_ratio(s1: torch.Tensor, s2: torch.Tensor, mask: torch.Tensor,
                      reduction: bool = True) -> torch.Tensor:
    """Suppression level on non-target regions (mask == 0), in dB.

    s1: enhanced [N, L], s2: noisy [N, L], mask: [N, L] target activity."""
    sel = (mask == 0).to(s1.dtype)
    num = torch.sum((s2 * sel) ** 2, dim=-1)
    den = torch.sum((s1 * sel) ** 2, dim=-1)
    score = 10 * torch.log10(num / den.clamp_min(1e-12))
    return torch.mean(score) if reduction else score
