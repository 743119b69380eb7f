"""TSE recipe command line: train (counterpart of egs/tse/main.py:
`init_dataloader` `:46-113`, `action_train` `:116-144`, `main` `:443-491`).

    python -m puresound_tpu_torch.egs.tse.main <TSE.yaml-style config> \\
        --action train [--backend cuda|cpu]

Trains on the CUDA card unless `--backend cpu` asks for the CPU; `cuda`
raises where torch sees no card. The other actions (dev / eval / tSNE /
export_model / stream_eval / serve), contrastive (GE2E) batches and
`--num_processes > 1` are not ported yet and raise.
"""
from __future__ import annotations

import argparse

import torch

from ...src.utils import create_folder, load_hparam
from ...tasks.base import DataLoader
from ...tasks.tse import TseCollateFunc, TseDataset, TseTask
from ...zoo.tse import init_loss, init_model

ACTIONS = ("train", "dev", "eval", "tSNE", "export_model", "stream_eval", "serve")


def _device(backend: str) -> torch.device:
    if backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--backend cuda (the default) needs a CUDA card and "
                           "torch sees none; pass --backend cpu to train on the CPU")
    return torch.device("cuda")


def init_dataloader(hparam):
    ds = hparam["DATASET"]
    if hparam["TRAIN"].get("contrastive_learning"):
        raise NotImplementedError(
            "contrastive (GE2E) batches through SpeakerSampler are not ported yet "
            "(ROADMAP queue 1 item 5)")
    common = dict(
        resample_to=ds["sample_rate"], max_length=ds["max_length"],
        noise_folder=ds.get("noise_folder"), rir_folder=ds.get("rir_folder"),
        rir_mode=ds.get("rir_mode") or "image",
        speed_perturbed=ds.get("speed_perturbed", False),
        perturb_frequency_response=ds.get("perturb_frequency_response", False),
        vol_perturbed=ds.get("vol_perturbed"),
        enroll_augment=ds.get("enroll_augment", False),
        enroll_rule=ds.get("enroll_rule"),
        is_vad_dataset=ds["type"].lower() == "pvad")
    train_ds = TseDataset(folder=ds["train"], single_spk_pb=ds["single_spk_prob"],
                          inactive_training=ds["inactive_training"], **common)
    dev_ds = TseDataset(folder=ds["dev"], single_spk_pb=0.0, inactive_training=0.0,
                        **common)
    kw = dict(batch_size=hparam["TRAIN"]["batch_size"], shuffle=True,
              collate_fn=TseCollateFunc(),
              num_workers=int(hparam["TRAIN"].get("num_workers", 0)),
              seed=hparam["TRAIN"].get("seed"))
    return DataLoader(train_ds, **kw), DataLoader(dev_ds, **kw)


def action_train(hparam, device) -> TseTask:
    sig_loss, cls_loss = init_loss(hparam)
    model = init_model(hparam["MODEL"]["type"], sig_loss, cls_loss, device=device,
                       generator=torch.Generator().manual_seed(0))
    train_loader, dev_loader = init_dataloader(hparam)
    trainer = TseTask(hparam, model, device, train_loader, dev_loader)
    trainer.train()
    return trainer


def main(config) -> TseTask:
    if config.action != "train":
        raise NotImplementedError(
            f"--action {config.action} is not ported yet (ROADMAP queue 1 item 2: "
            "the recipe's other actions); only train is")
    if config.num_processes > 1:
        raise NotImplementedError(
            "--num_processes > 1 (multi-process training) is not ported yet "
            "(ROADMAP queue 1 item 2: DDP)")
    device = _device(config.backend)
    hparam = load_hparam(config.config_path)
    create_folder(hparam["TRAIN"]["model_save_dir"])
    return action_train(hparam, device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config_path", type=str)
    parser.add_argument("--action", type=str, default="train", choices=ACTIONS)
    parser.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--num_processes", type=int, default=1)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
