"""TSE recipe command line: train (counterpart of egs/tse/main.py:
`init_dataloader` `:46-113`, `action_train` `:116-144`, `main` `:443-491`).

    python -m puresound_tpu_torch.egs.tse.main <TSE.yaml-style config> \\
        --action train [--backend cuda|cpu]

Trains on the CUDA card unless `--backend cpu` asks for the CPU; `cuda`
raises where torch sees no card. With `TRAIN.contrastive_learning` the
batches are `SpeakerSampler`'s, p_spks speakers x p_utts utterances, as the
GE2E loss needs them. The other actions (dev / eval / tSNE / export_model /
stream_eval / serve) and `--num_processes > 1` are not ported yet and raise.
"""
from __future__ import annotations

import argparse

import torch

from ...src.sampler import SpeakerSampler
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
    ds, train = hparam["DATASET"], hparam["TRAIN"]
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
    n_work = int(train.get("num_workers", 0))
    if train.get("contrastive_learning"):
        p_spks, p_utts, repeat = train["p_spks"], train["p_utts"], train["repeat"]
        # the sampler's batch count for each set (`egs/tse/main.py:81-96`)
        loader = lambda d: DataLoader(
            d, batch_sampler=SpeakerSampler(d.sampler_meta(),
                                            repeat * len(d) // (p_spks * p_utts),
                                            n_spks=p_spks, n_per=p_utts),
            collate_fn=TseCollateFunc(), num_workers=n_work, seed=train.get("seed"))
        return loader(train_ds), loader(dev_ds)
    kw = dict(batch_size=train["batch_size"], shuffle=True, collate_fn=TseCollateFunc(),
              num_workers=n_work, seed=train.get("seed"))
    return DataLoader(train_ds, **kw), DataLoader(dev_ds, **kw)


def action_train(hparam, device) -> TseTask:
    gen = torch.Generator().manual_seed(0)
    losses = init_loss(hparam, device=device, generator=gen)
    model = init_model(hparam["MODEL"]["type"], *losses, device=device, generator=gen)
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
