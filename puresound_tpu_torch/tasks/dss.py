"""The distance-based (near / far) speech separation task (counterpart of
puresound_tpu/tasks/dss.py: `DssCollateFunc` `:16`, `DssDataset` `:31-115`,
`DssTask` `:118-155`).

Inactive flags come from all-zero references, and an inactive side's
target becomes the mixture; the trainer stacks [near, far] into the SIMO
wrapper's [N, 2, L] targets with [N, 2] labels. The host augmentation
chain (noise, speed, volume) is the shared one of `tasks/ns.py`, the mixture's
speed draw applied to both references. `DATASET.augment_on_device` raises:
JAX's `DssTask` inherits the NS wiring, whose on-device chain cannot take
the [N, 2, L] targets.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Optional

import numpy as np
import torch

from .base import pad_stack
from .ns import NsTask, _AugmentedDataset


class DssCollateFunc:
    def __call__(self, batch: Any) -> Dict:
        return {
            "uttid": [b["uttid"] for b in batch],
            "near_wav": pad_stack([b["near_wav"] for b in batch]),
            "far_wav": pad_stack([b["far_wav"] for b in batch]),
            "process_wav": pad_stack([b["process_wav"] for b in batch]),
            "inactive_nearend": np.asarray([b["inactive_nearend"] for b in batch], bool),
            "inactive_farfield": np.asarray([b["inactive_farfield"] for b in batch], bool),
        }


class DssDataset(_AugmentedDataset):
    """Mixture / near / far manifest (`wav2scp.txt`, `ref2near.txt`,
    `ref2far.txt`): the random crop, the host augmentation chain and the
    inactive flags."""

    def __init__(self, folder: str, resample_to: int, max_length: Optional[int] = None,
                 noise_folder: Optional[str] = None, vol_perturbed: Optional[tuple] = None,
                 speed_perturbed: bool = False):
        self.max_length = max_length
        self.noise_folder = noise_folder
        self.rir_folder = None
        self.speed_perturbed = speed_perturbed
        self.vol_perturbed = vol_perturbed
        self.perturb_frequency_response = False
        super().__init__(folder, resample_to=resample_to)
        self._maybe_augmentor()

    @property
    def folder_content(self):
        return {"wav2scp": "wav2scp.txt", "ref2near": "ref2near.txt",
                "ref2far": "ref2far.txt"}

    def __getitem__(self, index: int) -> Dict:
        key = self.idx_df[index]
        feats = self.get_feature(key)
        return {"uttid": key,
                "process_wav": feats["process_wav"].reshape(1, -1),
                "near_wav": feats["near_wav"].reshape(1, -1),
                "far_wav": feats["far_wav"].reshape(1, -1),
                "inactive_nearend": feats["inactive_nearend"],
                "inactive_farfield": feats["inactive_farfield"]}

    def get_feature(self, key: str) -> Dict:
        wav = self._open_resampled(self.df[key]["wav2scp"])
        near = self._open_resampled(self.df[key]["ref2near"])
        far = self._open_resampled(self.df[key]["ref2far"])
        if self.max_length is not None:
            target_len = self.resample_to * self.max_length
            if wav.shape[-1] > target_len:
                offset = random.randint(0, wav.shape[-1] - target_len)
                wav = wav[:, offset:offset + target_len]
                near = near[:, offset:offset + target_len]
                far = far[:, offset:offset + target_len]
            else:
                wav = np.pad(wav, ((0, 0), (0, target_len - wav.shape[-1])))
                near = np.pad(near, ((0, 0), (0, target_len - near.shape[-1])))
                far = np.pad(far, ((0, 0), (0, target_len - far.shape[-1])))
        # an all-zero reference: that side is silent, and its target becomes
        # the mixture (JAX `dss.py:80-86`)
        inactive_near = bool(np.sum(np.abs(near)) == 0)
        inactive_far = bool(np.sum(np.abs(far)) == 0)
        if self.augmentor:
            process_wav, (speed, _, _, _, _, _) = self.wave_process(wav)
            if speed is not None:
                near, _ = self.augmentor.sox_speed_perturbed(near, speed)
                far, _ = self.augmentor.sox_speed_perturbed(far, speed)
            if self.vol_perturbed is not None:
                near, far, process_wav = self._vol_perturb(near, far, process_wav)
        else:
            process_wav = wav
        if inactive_near:
            near = process_wav.copy()
        if inactive_far:
            far = process_wav.copy()
        return {"process_wav": process_wav.astype(np.float32),
                "near_wav": near.astype(np.float32), "far_wav": far.astype(np.float32),
                "inactive_nearend": inactive_near, "inactive_farfield": inactive_far}


class DssTask(NsTask):
    """The separation trainer: [near, far] stacked targets into the SIMO
    wrapper with per-source inactive labels."""

    def _batch_kwargs(self, batch) -> Dict:
        ref = np.stack([batch["near_wav"], batch["far_wav"]], axis=1)            # [N, 2, L]
        inact = np.stack([batch["inactive_nearend"], batch["inactive_farfield"]], axis=1)
        return {"noisy": self._tensor(batch["process_wav"]), "ref_clean": self._tensor(ref),
                "inactive_labels": torch.as_tensor(inact, device=self.device)}

    def _device_augment_fn(self):
        raise ValueError(
            "DATASET.augment_on_device does not support DSS: JAX's DssTask takes "
            "NsTask's on-device chain, which fails on the [N, 2, L] near / far "
            "targets (its volume, NaN rollback and RIR broadcast [N] against "
            "[N, 2]); run the host chain (noise_folder, speed_perturbed, "
            "vol_perturbed) instead")

    def inference(self, noisy, enroll=None):
        was_training = self.model.training
        self.model.eval()
        with torch.no_grad():
            out = self.model.inference(noisy)
        self.model.train(was_training)
        return out

    def gen_logging(self, epoch: int, prefix: str):
        """The near and far outputs of the eval manifest, logged apart
        (JAX `dss.py:136-155`)."""
        sr = self.hparam["DATASET"]["sample_rate"]
        for key, wav in self._eval_audio():
            out = self.inference(self._tensor(wav)).float().cpu().numpy()
            if self.tf_writer:
                self.tf_writer.add_ep_audio(f"{prefix}{key}_near.wav", out[:, 0], epoch, sr)
                self.tf_writer.add_ep_audio(f"{prefix}{key}_far.wav", out[:, 1], epoch, sr)
