"""The NS dataset, its collate, the shared dataset pieces and the trainer
loop of the SE tasks (counterpart of puresound_tpu/tasks/ns.py:
`NsCollateFunc` `:17`, `_AugmentedDataset` `:26-106`, `NsDataset`
`:109-158`, `NsTask` `:161-412`).

The host augmentation chain (noise, RIR, speed, frequency response) is not
ported yet and raises (ROADMAP queue 1 item 2); cropping, resampling and
`_vol_perturb`'s volume draw are. `NsTask` trains on one device: with
`TRAIN.multi_gpu` and one visible card it trains on that card, and with
more it raises (DDP is queue 1 item 2), as do `mp_devices > 1`, `remat` and
`augment_on_device`. The dev loss runs under `torch.no_grad` with the model
in eval mode (BatchNorm on its running statistics, JAX's `train=False`),
summed on the device and read back once per epoch.
"""
from __future__ import annotations

import os
import random
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..src import native
from ..src.audio import AudioIO
from ..src.utils import load_text_as_dict
from .base import BaseTrainer, DeferredMetricSink, TaskDataset, pad_stack

_AUGMENT_OPTIONS = ("noise_folder", "rir_folder", "speed_perturbed",
                    "perturb_frequency_response")


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item 2: host augmentation "
        "(AudioAugmentor), on-device augmentation, DDP)")


class _AugmentedDataset(TaskDataset):
    """Cropping, resampling and the volume draw of the shared chain."""

    def __init__(self, folder: str, resample_to=None):
        super().__init__(folder, resample_to=resample_to)
        # build and load the decoders here, once, before loader workers fork
        native.available()

    def _check_augmentation(self) -> None:
        for name in _AUGMENT_OPTIONS:
            if getattr(self, name, None):
                _not_ported(f"dataset augmentation option {name!r}")

    def _open_resampled(self, path: str) -> np.ndarray:
        wav, sr = AudioIO.open(f_path=path)
        if self.resample_to and sr != self.resample_to:
            wav = AudioIO.resample(wav, sr, self.resample_to)
        if wav.shape[0] != 1:
            wav = wav[0:1]
        return wav

    def _random_crop_pair(self, wav, clean_wav, avoid_zero_target=True):
        """Random fixed-length crop avoiding all-zero targets; zero-pad when
        too short."""
        target_len = int(self.resample_to * self.max_length)
        if wav.shape[-1] > target_len:
            offset = random.randint(0, wav.shape[-1] - target_len)
            if avoid_zero_target:
                tries = 0
                while clean_wav[:, offset:offset + target_len].sum() == 0 and tries < 100:
                    offset = random.randint(0, wav.shape[-1] - target_len)
                    tries += 1
            wav = wav[:, offset:offset + target_len]
            clean_wav = clean_wav[:, offset:offset + target_len]
        else:
            wav = np.pad(wav, ((0, 0), (0, target_len - wav.shape[-1])))
            clean_wav = np.pad(clean_wav, ((0, 0), (0, target_len - clean_wav.shape[-1])))
        return wav, clean_wav

    def _vol_perturb(self, *wavs):
        if not isinstance(self.vol_perturbed, tuple):
            lo, hi = (float(v) for v in str(self.vol_perturbed).strip().split(","))
        else:
            lo, hi = self.vol_perturbed
        ratio = float(np.random.uniform(lo, hi))
        return [np.clip(w * ratio, -1, 1) for w in wavs]


class NsCollateFunc:
    def __call__(self, batch: Any) -> Dict:
        return {
            "uttid": [b["uttid"] for b in batch],
            "clean_wav": pad_stack([b["clean_wav"] for b in batch]),
            "process_wav": pad_stack([b["process_wav"] for b in batch]),
        }


class NsDataset(_AugmentedDataset):
    """Parallel noisy / clean NS dataset (`wav2scp.txt`, `wav2ref.txt`): the
    random crop and the volume draw."""

    def __init__(self, folder: str, resample_to: int,
                 max_length: Optional[int] = None,
                 noise_folder: Optional[str] = None,
                 rir_folder: Optional[str] = None, rir_mode: str = "image",
                 vol_perturbed: Optional[tuple] = None,
                 speed_perturbed: bool = False,
                 perturb_frequency_response: bool = False):
        self.max_length = max_length
        self.noise_folder = noise_folder
        self.rir_folder = rir_folder
        self.rir_mode = rir_mode
        self.speed_perturbed = speed_perturbed
        self.vol_perturbed = vol_perturbed
        self.perturb_frequency_response = perturb_frequency_response
        self._check_augmentation()
        super().__init__(folder, resample_to=resample_to)

    @property
    def folder_content(self):
        return {"wav2scp": "wav2scp.txt", "wav2ref": "wav2ref.txt"}

    def __getitem__(self, index: int) -> Dict:
        key = self.idx_df[index]
        feats = self.get_feature(key)
        return {"uttid": key,
                "process_wav": feats["process_wav"].reshape(1, -1),
                "clean_wav": feats["clean_wav"].reshape(1, -1)}

    def get_feature(self, key: str) -> Dict:
        wav = self._open_resampled(self.df[key]["wav2scp"])
        clean_wav = self._open_resampled(self.df[key]["wav2ref"])
        if self.max_length is not None:
            wav, clean_wav = self._random_crop_pair(wav, clean_wav)
        process_wav = wav
        if self.vol_perturbed is not None:
            clean_wav, process_wav = self._vol_perturb(clean_wav, process_wav)
        return {"clean_wav": clean_wav.astype(np.float32),
                "process_wav": process_wav.astype(np.float32)}


class NsTask(BaseTrainer):
    """The SE trainer loop: the wrapper's loss, Adam, clip; the batches'
    tensors go to the trainer's device."""

    def __init__(self, hparam, model, device, train_dataloader, dev_dataloader):
        train = hparam["TRAIN"]
        device = torch.device(device)
        if train.get("multi_gpu") and device.type == "cuda" \
                and torch.cuda.device_count() > 1:
            _not_ported(f"TRAIN.multi_gpu over {torch.cuda.device_count()} cards")
        if int(train.get("mp_devices") or 1) > 1:
            _not_ported("TRAIN.mp_devices > 1 (tensor parallelism)")
        if train.get("remat"):
            _not_ported("TRAIN.remat")
        if hparam["DATASET"].get("augment_on_device"):
            _not_ported("DATASET.augment_on_device")
        self.model = model
        super().__init__(hparam, device)
        self.train_dataloader = train_dataloader
        self.dev_dataloader = dev_dataloader
        self._build_steps()

    def _loss_kwargs(self) -> Dict:
        return {}

    def _build_steps(self):
        from ..parallel.mesh import make_train_step

        train = self.hparam["TRAIN"]
        self._train_step = make_train_step(
            self.model, loss_kwargs=self._loss_kwargs() or None,
            grad_clip=self.hparam["OPTIMIZER"].get("gradiend_clip"),
            compute_dtype=torch.bfloat16 if train.get("mixed_precision") else None,
            accum_steps=int(train.get("grad_accum") or 1),
            skip_nonfinite=bool(train.get("skip_nan_steps")))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _batch_kwargs(self, batch) -> Dict:
        return {"noisy": self._tensor(batch["process_wav"]), "enroll": None,
                "ref_clean": self._tensor(batch["clean_wav"])}

    def _eval_kwargs(self, batch) -> Dict:
        return self._batch_kwargs(batch)

    def _consume_metrics(self, current_epoch, ctx, metrics) -> float:
        """Log one finished step's metrics; returns the loss."""
        batch_idx, overall = ctx
        loss = float(metrics["loss"])
        print(f"epoch: {current_epoch}, iter: {batch_idx + 1}, batch_loss: {loss:.4f}")
        if self.tf_writer:
            self.tf_writer.update_step_loss("train/batch_loss", loss, overall)
        return loss

    def train_one_epoch(self, current_epoch):
        step = 0
        total_loss = [0.0]

        def consume(ctx, metrics):
            total_loss[0] += self._consume_metrics(current_epoch, ctx, metrics)

        sink = DeferredMetricSink(consume)
        for batch_idx, batch in enumerate(self.train_dataloader):
            self.overall_step += 1
            step += 1
            self.state, metrics = self._train_step(self.state, self._batch_kwargs(batch))
            sink.push((batch_idx, self.overall_step), metrics)
        sink.flush()
        return {"total_loss": total_loss[0] / max(step, 1)}

    def compute_dev_loss(self, current_epoch):
        was_training = self.model.training
        self.model.eval()
        step, total = 0, None
        with torch.no_grad():
            for batch in self.dev_dataloader:
                step += 1
                out = self.model(**self._eval_kwargs(batch))
                loss = out[0] if isinstance(out, tuple) else out
                total = loss if total is None else total + loss
        self.model.train(was_training)
        avg = float(total) / step if step else 0.0
        print(f"dev average loss: {avg}")
        return {"total_loss": avg}

    def inference(self, noisy, enroll=None):
        was_training = self.model.training
        self.model.eval()
        with torch.no_grad():
            out = self.model.inference(noisy, enroll)
        self.model.train(was_training)
        return out

    def _eval_audio(self):
        """(key, noisy wav) of the eval manifest folder, if it has one."""
        eval_dir = self.hparam["DATASET"].get("eval")
        if not eval_dir or not os.path.isfile(f"{eval_dir}/wav2scp.txt"):
            return
        sr = self.hparam["DATASET"]["sample_rate"]
        for key, paths in load_text_as_dict(f"{eval_dir}/wav2scp.txt").items():
            wav, file_sr = AudioIO.open(f_path=paths[0])
            yield key, (AudioIO.resample(wav, file_sr, sr) if file_sr != sr else wav)

    def gen_logging(self, epoch: int, prefix: str):
        sr = self.hparam["DATASET"]["sample_rate"]
        for key, wav in self._eval_audio():
            print(f"Running inference: {key}")
            enh = self.inference(self._tensor(wav))
            if self.tf_writer:
                self.tf_writer.add_ep_audio(f"{prefix}{key}.wav",
                                            enh.float().cpu().numpy(), epoch, sr)

