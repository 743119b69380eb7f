"""The NS dataset, its collate, the shared dataset pieces and the trainer
loop of the SE tasks (counterpart of puresound_tpu/tasks/ns.py:
`NsCollateFunc` `:17`, `_AugmentedDataset` `:26-106`, `NsDataset`
`:109-158`, `NsTask` `:161-412`).

The datasets run the host augmentation chain (`AudioAugmentor`: speed, RIR,
noise, frequency response, volume) in the loader. `NsTask` trains on one
device, or on one card per process of a multi-process run
(`parallel.multihost`, `TRAIN.multi_gpu: true` as JAX asks), with
`DATASET.augment_on_device` (RIR, noise and volume in the step,
`src.augment_torch`, its draws from the task's `augment_generator`) and
`TRAIN.remat`. `TRAIN.mp_devices: k` over `--num_processes N` (N % k == 0)
trains tensor-parallel on the (N / k, k) mesh (`parallel.mesh`): each rank
keeps its slices of the eligible parameters and Adam moments
(`TRAIN.tp_min_size`, default 64), the loader shards by dp index, and the
dev loss, the logging inference and the checkpoints (whole tensors, which
load into a plain model and into JAX's reader) see the gathered
parameters. `TRAIN.multi_gpu` over several cards in one process, and
`mp_devices > 1` in one process, raise and point to `--num_processes`. The dev loss runs
under `torch.no_grad` with the model in eval mode (BatchNorm on its running
statistics, JAX's `train=False`), summed on the device and read back once
per epoch; in a multi-process run it is the global batch's.
"""
from __future__ import annotations

import contextlib
import os
import random
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel import multihost
from ..src import native
from ..src.audio import AudioAugmentor, AudioIO
from ..src.utils import load_text_as_dict
from .base import BaseTrainer, DeferredMetricSink, TaskDataset, pad_stack

class _AugmentedDataset(TaskDataset):
    """The shared chain: speed -> RIR -> noise -> frequency response, the
    target warped with the same draws, NaN rollback; cropping, resampling
    and the volume draw."""

    def __init__(self, folder: str, resample_to=None):
        super().__init__(folder, resample_to=resample_to)
        # build and load the decoders here, once, before loader workers fork
        native.available()

    def create_augmentor(self) -> None:
        self.augmentor = AudioAugmentor(sample_rate=self.resample_to,
                                        convolve_mode="fft")
        print("Created audio augmentor")
        if getattr(self, "noise_folder", None):
            self.augmentor.load_bg_noise_from_folder(self.noise_folder)
            print(f"Finished load {len(self.augmentor.bg_noise)} noises")
        if getattr(self, "rir_folder", None):
            self.augmentor.load_rir_from_folder(self.rir_folder)
            print(f"Finished load {len(self.augmentor.rir)} rirs")

    def _maybe_augmentor(self) -> None:
        """The augmentor when any host option is on, else None."""
        if (getattr(self, "noise_folder", None) or getattr(self, "rir_folder", None)
                or getattr(self, "speed_perturbed", False)
                or getattr(self, "vol_perturbed", None) is not None
                or getattr(self, "perturb_frequency_response", False)):
            self.create_augmentor()
        else:
            self.augmentor = None

    def _open_resampled(self, path: str) -> np.ndarray:
        wav, sr = AudioIO.open(f_path=path)
        if self.resample_to and sr != self.resample_to:
            wav = AudioIO.resample(wav, sr, self.resample_to)
        if wav.shape[0] != 1:
            wav = wav[0:1]
        return wav

    def wave_process(self, x: np.ndarray,
                     noise_snr_range=(-5, 15)) -> Tuple[np.ndarray, Tuple]:
        speed = snr = rir_id = rir_ch = a_coeffs = b_coeffs = None
        backup = x.copy()
        if getattr(self, "speed_perturbed", False) and np.random.rand() < 0.5:
            speed = float(np.random.uniform(0.9, 1.1))
            x, _ = self.augmentor.sox_speed_perturbed(x, speed)
        if getattr(self, "rir_folder", None) is not None and np.random.rand() < 0.8:
            x, rir_id, rir_ch = self.augmentor.apply_rir(x)
        if getattr(self, "noise_folder", None) is not None and np.random.rand() < 0.8:
            snr = float(np.random.uniform(*noise_snr_range))
            x = self.augmentor.add_bg_noise(x, [snr])[0]
        if getattr(self, "perturb_frequency_response", False) and np.random.rand() < 0.8:
            x, a_coeffs, b_coeffs = self.augmentor.add_variaion_response(x)
        if np.isnan(x).any():
            print(f"warning this augment has nan, snr={snr}, speed={speed}, rir_id={rir_id}")
            x, speed, rir_id, a_coeffs, b_coeffs = backup, None, None, None, None
        return x, (speed, snr, rir_id, rir_ch, a_coeffs, b_coeffs)

    def _match_target(self, clean_wav, speed, rir_id, rir_ch, a_coeffs, b_coeffs,
                      rir_mode: str, skip_signal_warp: bool = False):
        """Warp the target with the same augmentation draws."""
        if speed is not None and not skip_signal_warp:
            clean_wav, _ = self.augmentor.sox_speed_perturbed(clean_wav, speed)
        if rir_id is not None and rir_mode != "anechoic" and not skip_signal_warp:
            clean_wav = self.augmentor.apply_rir_by_key(
                clean_wav, rir_id, choose_ch=rir_ch, rir_mode=rir_mode)
        if a_coeffs is not None and b_coeffs is not None:
            clean_wav, _, _ = self.augmentor.add_variaion_response(
                clean_wav, a_coeffs, b_coeffs)
        return clean_wav

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
    """Parallel noisy / clean NS dataset (`wav2scp.txt`, `wav2ref.txt`) with
    on-the-fly augmentation."""

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
        super().__init__(folder, resample_to=resample_to)
        self._maybe_augmentor()

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
        if self.augmentor:
            process_wav, (speed, _, rir_id, rir_ch, a, b) = self.wave_process(wav)
            clean_wav = self._match_target(clean_wav, speed, rir_id, rir_ch,
                                           a, b, self.rir_mode)
            if self.vol_perturbed is not None:
                clean_wav, process_wav = self._vol_perturb(clean_wav, process_wav)
        else:
            process_wav = wav
        return {"clean_wav": clean_wav.astype(np.float32),
                "process_wav": process_wav.astype(np.float32)}


class NsTask(BaseTrainer):
    """The SE trainer loop: the wrapper's loss, Adam, clip; the batches'
    tensors go to the trainer's device."""

    def __init__(self, hparam, model, device, train_dataloader, dev_dataloader):
        train = hparam["TRAIN"]
        device = torch.device(device)
        self._dp = multihost.process_count() > 1
        if self._dp and not train.get("multi_gpu"):
            raise ValueError("multi-process training requires TRAIN.multi_gpu: true "
                             "(the global batch)")
        n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if train.get("multi_gpu") and not self._dp and n_cards > 1:
            raise NotImplementedError(
                f"TRAIN.multi_gpu over {n_cards} cards in one process: the port "
                f"trains one process per card (--num_processes {n_cards} --process_id "
                "<rank> --coordinator host:port)")
        n_mp = int(train.get("mp_devices") or 1)
        if n_mp > 1 and not self._dp:
            raise ValueError(
                f"TRAIN.mp_devices: {n_mp} (tensor parallelism) runs one process per "
                f"card: launch --num_processes N with N % {n_mp} == 0 (--process_id "
                "<rank> --coordinator host:port)")
        self.model = model
        # the on-device chain's draws (JAX's PRNGKey(TRAIN.seed)); the same
        # seed on every process, whose draws are the global batch's
        self.augment_generator = torch.Generator(device=device).manual_seed(
            int(train.get("seed") or 0))
        super().__init__(hparam, device)
        self._mesh, self._tp = None, n_mp > 1
        if self._dp:
            from ..parallel.mesh import make_mesh, shard_state_to_mesh

            # after the resume above: a checkpoint holds whole tensors
            self._mesh = make_mesh(n_mp=n_mp)
            shard_state_to_mesh(self._mesh, self.state, tp=self._tp,
                                tp_min_size=self._tp_min_size())
            if self._tp and multihost.is_primary():
                print(f"Tensor+data-parallel training over {self._mesh.shape['dp']}x"
                      f"{self._mesh.shape['mp']} process mesh, "
                      f"{len(self.state.tp_layout)} parameters sharded")
        self.train_dataloader = train_dataloader
        self.dev_dataloader = dev_dataloader
        self._build_steps()

    def _tp_min_size(self) -> int:
        return int(self.hparam["TRAIN"].get("tp_min_size") or 64)

    def _loss_kwargs(self) -> Dict:
        return {}

    def _augmentor_kwargs(self) -> Dict:
        ds = self.hparam["DATASET"]
        vol = ds.get("vol_perturbed")
        if vol and not isinstance(vol, (tuple, list)):
            vol = tuple(float(v) for v in str(vol).strip().split(","))
        return dict(sample_rate=ds["sample_rate"], noise_folder=ds.get("noise_folder"),
                    rir_folder=ds.get("rir_folder"), rir_mode=ds.get("rir_mode") or "image",
                    vol_range=vol, device=self.device)

    def _device_augment_fn(self):
        """`DATASET.augment_on_device`: RIR, noise and volume in the step
        (the loader keeps decode, crop, speed and the biquad)."""
        from ..src.augment_torch import DeviceAugmentor

        self.device_augmentor = DeviceAugmentor(**self._augmentor_kwargs())
        return self.device_augmentor.make_augment_fn()

    def _build_steps(self):
        from ..parallel.mesh import make_train_step

        train = self.hparam["TRAIN"]
        augment_fn = (self._device_augment_fn()
                      if self.hparam["DATASET"].get("augment_on_device") else None)
        self._train_step = make_train_step(
            self.model, loss_kwargs=self._loss_kwargs() or None,
            grad_clip=self.hparam["OPTIMIZER"].get("gradiend_clip"),
            compute_dtype=torch.bfloat16 if train.get("mixed_precision") else None,
            accum_steps=int(train.get("grad_accum") or 1),
            skip_nonfinite=bool(train.get("skip_nan_steps")),
            remat=train.get("remat", False), augment_fn=augment_fn,
            mesh=self._mesh, tp=self._tp, tp_min_size=self._tp_min_size())

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
        if multihost.is_primary():
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
            self.state, metrics = self._train_step(self.state, self._batch_kwargs(batch),
                                                   generator=self.augment_generator)
            sink.push((batch_idx, self.overall_step), metrics)
        sink.flush()
        return {"total_loss": total_loss[0] / max(step, 1)}

    def compute_dev_loss(self, current_epoch):
        was_training = self.model.training
        self.model.eval()
        step, total = 0, None
        with torch.no_grad(), (multihost.global_batch(self.model, multihost.group())
                               if self._dp else contextlib.nullcontext()):
            for batch in self.dev_dataloader:
                step += 1
                out = self.model(**self._eval_kwargs(batch))
                loss = out[0] if isinstance(out, tuple) else out
                total = loss if total is None else total + loss
        self.model.train(was_training)
        avg = float(total) / step if step else 0.0
        if multihost.is_primary():
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

