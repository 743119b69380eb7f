"""Target-speech-extraction task: dataset (inactive-speaker training,
enrollment rules), collate and the trainer with per-module LR factors
(counterpart of puresound_tpu/tasks/tse.py: TseCollateFunc `:20`,
TseDataset `:32`, TseTask `:227`).

`TRAIN.fused_scan` is accepted and changes nothing: the port always runs
the speaker net's TCN blocks through `tcn_block_train` and every SkiM LSTM
scan through `lstm_scan_train_fp` (the CUDA kernels on the card).
`TseDataset.sampler_meta` feeds `SpeakerSampler`, the GE2E batches of
contrastive training.
"""
from __future__ import annotations

import os
import random
from typing import Any, Dict, Optional

import numpy as np

from ..parallel import multihost
from ..src.audio import AudioIO
from ..src.utils import load_text_as_dict
from .base import pad_stack
from .ns import NsTask, _AugmentedDataset


class TseCollateFunc:
    def __call__(self, batch: Any) -> Dict:
        return {
            "uttid": [b["uttid"] for b in batch],
            "clean_wav": pad_stack([b["clean_wav"] for b in batch]),
            "process_wav": pad_stack([b["process_wav"] for b in batch]),
            "enroll_wav": pad_stack([b["enroll_wav"] for b in batch]),
            "spk_label": np.asarray([b["spk_label"] for b in batch], np.int32),
            "inactive_utts": np.asarray([b["inactive"] for b in batch], bool),
        }


class TseDataset(_AugmentedDataset):
    """TSE / PVAD dataset with single-speaker and inactive-speaker cases,
    the enrollment rules (None/longest/shortest/fixed_length/full), the
    enrollment level draw (-28 dBFS with sqrt(10) std) and the host
    augmentation chain; `enroll_augment` runs RIR, noise and the frequency
    response on the enrollment too. An inactive utterance's target is the
    augmented mixture (TSE) or zeros (PVAD)."""

    def __init__(self, folder: str, resample_to: int,
                 max_length: Optional[int] = None,
                 enroll_rule: Optional[str] = None,
                 enroll_augment: bool = False,
                 noise_folder: Optional[str] = None,
                 rir_folder: Optional[str] = None, rir_mode: str = "image",
                 vol_perturbed: Optional[tuple] = None,
                 speed_perturbed: bool = False,
                 perturb_frequency_response: bool = False,
                 single_spk_pb: float = 0.0, inactive_training: float = 0.0,
                 is_vad_dataset: bool = False):
        self.max_length = max_length
        self.noise_folder = noise_folder
        self.rir_folder = rir_folder
        self.rir_mode = rir_mode
        self.speed_perturbed = speed_perturbed
        self.perturb_frequency_response = perturb_frequency_response
        self.vol_perturbed = vol_perturbed
        self.single_spk_pb = single_spk_pb
        self.inactive_training = inactive_training
        self.enroll_rule = enroll_rule
        self.enroll_augment = enroll_augment
        self.is_vad_dataset = is_vad_dataset
        super().__init__(folder, resample_to=resample_to)
        self._maybe_augmentor()
        # the speaker label map (JAX's `create_df2spk`)
        spk_ids = sorted(set(self.df[k]["ref2spk"] for k in self.df))
        self.ref2spk = {s: i for i, s in enumerate(spk_ids)}

    @property
    def folder_content(self):
        content = {
            "wav2scp": "wav2scp.txt",    # noisy wav path
            "wav2ref": "wav2ref.txt",    # clean (target) wav path
            "ref2list": "ref2list.txt",  # enrollment candidates
            "ref2spk": "ref2spk.txt",    # target speaker id
            "wav2spk": "wav2spk.txt",    # speakers in the mixture
        }
        if self.is_vad_dataset:
            content["ref2vad"] = "ref2vad.txt"
        return content

    def __getitem__(self, index: int) -> Dict:
        key = self.idx_df[index]
        feats = self.get_feature(key)
        return {"uttid": key,
                "process_wav": feats["process_wav"].reshape(1, -1),
                "clean_wav": feats["clean_wav"].reshape(1, -1),
                "enroll_wav": feats["enroll_wav"].reshape(1, -1),
                "spk_label": feats["spk_label"],
                "inactive": feats["inactive"]}

    def get_feature(self, key: str) -> Dict:
        spk_label = self.ref2spk[self.df[key]["ref2spk"]]
        wav = self._open_resampled(self.df[key]["wav2scp"])
        clean_path = (self.df[key]["wav2ref"] if not self.is_vad_dataset
                      else self.df[key]["ref2vad"])
        clean_wav = self._open_resampled(clean_path)

        # single-target-speaker cases
        if np.random.rand() < self.single_spk_pb:
            if not self.is_vad_dataset:
                wav = clean_wav.copy()
            else:
                wav = self._open_resampled(self.df[key]["wav2ref"])

        # inactive-speaker training: replace the mixture with audio from
        # speakers disjoint from the current mixture; target := mixture
        # (TSE) or zeros (PVAD)
        inactive = False
        if np.random.rand() < self.inactive_training:
            current_spks = self.df[key]["wav2spk"].split("-")
            keys = list(self.df.keys())
            for _ in range(1000):
                pick_key = random.choice(keys)
                pick_sid = int(pick_key.strip().split("_")[-1][-1]) - 1
                pick_spk = self.df[pick_key]["wav2spk"].split("-")[pick_sid]
                if pick_spk not in current_spks:
                    break
            enroll_wav = self.load_enroll(key, mode=self.enroll_rule)
            if np.random.rand() > 0.5:
                wav = self._open_resampled(self.df[pick_key]["wav2scp"])
            else:
                wav = self._open_resampled(self.df[pick_key]["wav2ref"])
            clean_wav = wav.copy() if not self.is_vad_dataset else np.zeros_like(wav)
            inactive = True
        else:
            enroll_wav = self.load_enroll(key, mode=self.enroll_rule)

        if self.max_length is not None:
            wav, clean_wav = self._random_crop_pair(
                wav, clean_wav, avoid_zero_target=not self.is_vad_dataset)

        if self.augmentor:
            process_wav, (speed, _, rir_id, rir_ch, a, b) = self.wave_process(
                wav, noise_snr_range=(5, 15))
            clean_wav = self._match_target(
                clean_wav, speed, rir_id, rir_ch, a, b, self.rir_mode,
                skip_signal_warp=self.is_vad_dataset)
            if self.vol_perturbed is not None:
                if not self.is_vad_dataset:
                    clean_wav, process_wav, enroll_wav = self._vol_perturb(
                        clean_wav, process_wav, enroll_wav)
                else:
                    process_wav, enroll_wav = self._vol_perturb(process_wav, enroll_wav)
        else:
            process_wav = wav

        if inactive:
            clean_wav = (process_wav.copy() if not self.is_vad_dataset
                         else np.zeros_like(process_wav))

        return {"clean_wav": clean_wav.astype(np.float32),
                "process_wav": process_wav.astype(np.float32),
                "enroll_wav": enroll_wav.astype(np.float32),
                "spk_label": spk_label, "inactive": inactive}

    # ---------------------------------------------------------- enrollment
    def load_enroll(self, key, mode: Optional[str] = None) -> np.ndarray:
        min_length = self.resample_to * 1
        max_length = self.resample_to * 15
        enroll_list = self.df[key]["ref2list"]
        if not isinstance(enroll_list, list):
            enroll_list = [enroll_list]
        enroll_list = list(enroll_list)
        target_lvl = round(float(np.random.normal(-28, np.sqrt(10))), 1)

        def _open(path):
            wav, sr = AudioIO.open(f_path=path, target_lvl=target_lvl)
            if self.resample_to and sr != self.resample_to:
                wav = AudioIO.resample(wav, sr, self.resample_to)
            return wav

        if mode is None:
            pick = random.randrange(len(enroll_list))
            enroll_wav = _open(enroll_list[pick])
            while enroll_wav.shape[-1] < min_length:
                del enroll_list[pick]
                if not enroll_list:
                    break
                pick = random.randrange(len(enroll_list))
                enroll_wav = np.concatenate([enroll_wav, _open(enroll_list[pick])],
                                            axis=-1)
        elif mode in ("longest", "shortest"):
            lengths = [AudioIO.audio_info(p)[1] for p in enroll_list]
            pick = int(np.argmax(lengths) if mode == "longest" else np.argmin(lengths))
            enroll_wav = _open(enroll_list[pick])
        elif mode == "fixed_length":
            enroll_len = self.resample_to * 5
            pick = random.randrange(len(enroll_list))
            enroll_wav = _open(enroll_list[pick])
            if enroll_wav.shape[-1] > enroll_len:
                offset = random.randint(0, enroll_wav.shape[-1] - enroll_len)
                enroll_wav = enroll_wav[:, offset:offset + enroll_len]
        elif mode == "full":
            enroll_wav = np.concatenate([_open(p) for p in enroll_list], axis=-1)
        else:
            raise NameError(mode)

        if self.augmentor and self.enroll_augment:
            backup = enroll_wav.copy()
            if self.rir_folder is not None and np.random.rand() < 0.5:
                enroll_wav, _, _ = self.augmentor.apply_rir(enroll_wav)
            if self.noise_folder is not None and np.random.rand() < 0.5:
                snr = float(np.random.uniform(5, 15))
                enroll_wav = self.augmentor.add_bg_noise(enroll_wav, [snr])[0]
            if self.perturb_frequency_response and np.random.rand() < 0.8:
                enroll_wav, _, _ = self.augmentor.add_variaion_response(enroll_wav)
            if np.isnan(enroll_wav).any():
                print("Enroll augmentation warning: nan, rolled back")
                enroll_wav = backup
        return enroll_wav[:, :max_length]

    def sampler_meta(self) -> Dict[str, list]:
        """{speaker id: [dataset indices of its utterances]}, for
        `SpeakerSampler`."""
        spk2utt: Dict[str, list] = {}
        for idx in range(len(self.df)):
            spk2utt.setdefault(self.df[self.idx_df[idx]]["ref2spk"], []).append(idx)
        return spk2utt


class TseTask(NsTask):
    """TSE trainer: the joint loss of task 1 (signal loss; the speaker loss
    when the model has one), the per-module LR factors of `multi_rate`
    (encoder / speaker net / speaker loss at 0.1x, masker at 1x)."""

    def lr_factors(self) -> Optional[Dict[str, float]]:
        return {"encoder_spk": 0.1, "encoder": 0.1, "masker": 1.0,
                "speaker_net": 0.1, "loss_func_spk": 0.1}

    def _loss_kwargs(self) -> Dict:
        return {"alpha": self.hparam["LOSS"].get("alpha", 10.0),
                "return_loss_detail": True}

    def _device_augment_fn(self):
        """NsTask's on-device chain with the TSE specifics of JAX's
        (`tasks/tse.py:261-297`): noise SNR from (5, 15), the volume ratio
        scales the enrollment too, inactive utterances take the augmented
        mixture as their target; enroll_augment stays in the loader."""
        from ..src.augment_torch import DeviceAugmentor

        if str(self.hparam["DATASET"].get("type", "")).lower() == "pvad":
            raise ValueError("augment_on_device does not support PVAD "
                             "(VAD-label targets must not be warped)")
        self.device_augmentor = DeviceAugmentor(**self._augmentor_kwargs(),
                                                noise_snr_range=(5.0, 15.0))
        return self.device_augmentor.make_augment_fn(inactive_key="inactive_labels",
                                                     vol_keys=("enroll",))

    def _batch_kwargs(self, batch) -> Dict:
        return {"noisy": self._tensor(batch["process_wav"]),
                "enroll": self._tensor(batch["enroll_wav"]),
                "ref_clean": self._tensor(batch["clean_wav"]),
                "spk_class": self._tensor(batch["spk_label"]),
                "inactive_labels": self._tensor(batch["inactive_utts"])}

    def _eval_kwargs(self, batch) -> Dict:
        kwargs = self._batch_kwargs(batch)
        if not self.hparam["TRAIN"].get("contrastive_learning") and self.model.task != 2:
            kwargs["spk_class"] = None
        kwargs["alpha"] = self.hparam["LOSS"].get("alpha", 10.0)
        return kwargs

    def _consume_metrics(self, current_epoch, ctx, metrics) -> float:
        """NsTask's logging plus the per-loss detail (signal / class)."""
        batch_idx, overall = ctx
        loss = float(metrics["loss"])
        detail = {k: float(v) for k, v in metrics.items() if k.startswith("loss_")}
        msg = ", ".join(f"{k}: {v:.4f}" for k, v in detail.items())
        if multihost.is_primary():
            print(f"epoch: {current_epoch}, iter: {batch_idx + 1}, "
              f"batch_loss: {loss:.4f}{', ' + msg if msg else ''}")
        if self.tf_writer:
            self.tf_writer.update_step_loss("train/batch_loss", loss, overall)
            if "loss_0" in detail:
                self.tf_writer.update_step_loss("train/batch_signal_loss",
                                                detail["loss_0"], overall)
            if "loss_1" in detail:
                self.tf_writer.update_step_loss("train/batch_class_loss",
                                                detail["loss_1"], overall)
        return loss

    def gen_logging(self, epoch: int, prefix: str):
        eval_dir = self.hparam["DATASET"].get("eval")
        if not eval_dir or not os.path.isfile(f"{eval_dir}/wav2scp.txt"):
            return
        test_enroll = load_text_as_dict(f"{eval_dir}/ref2list.txt")
        sr = self.hparam["DATASET"]["sample_rate"]
        for key, wav in self._eval_audio():
            print(f"Running inference: {key}")
            enroll, file_sr = AudioIO.open(f_path=test_enroll[key][0], target_lvl=-28)
            if file_sr != sr:
                enroll = AudioIO.resample(enroll, file_sr, sr)
            enh = self.inference(self._tensor(wav), self._tensor(enroll))
            if self.tf_writer:
                self.tf_writer.add_ep_audio(f"{prefix}{key}.wav",
                                            enh.float().cpu().numpy(), epoch, sr)
