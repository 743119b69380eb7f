"""NS recipe command line: train (counterpart of egs/ns/main.py:
`init_dataloader` `:42-84`, `action_train` `:87-106`, `main` `:152-195`).

    python -m puresound_tpu_torch.egs.ns.main <NS.yaml-style config> \\
        --action train [--backend cuda|cpu]

Trains on the CUDA card unless `--backend cpu` asks for the CPU; `cuda`
raises where torch sees no card. The other actions (dev / eval /
stream_eval / serve / export_model) and `--num_processes > 1` are not
ported yet and raise.
"""
from __future__ import annotations

import argparse

import torch

from ...src.utils import create_folder, load_hparam
from ...tasks.base import DataLoader
from ...tasks.ns import NsCollateFunc, NsDataset, NsTask
from ...zoo.ns import init_loss, init_model
from ..tse.main import _device

ACTIONS = ("train", "dev", "eval", "stream_eval", "serve", "export_model")


def init_dataloader(hparam):
    ds, train = hparam["DATASET"], hparam["TRAIN"]
    common = dict(
        resample_to=ds["sample_rate"], max_length=ds["max_length"],
        noise_folder=ds.get("noise_folder"), rir_folder=ds.get("rir_folder"),
        rir_mode=ds.get("rir_mode") or "image",
        speed_perturbed=ds.get("speed_perturbed", False),
        perturb_frequency_response=ds.get("perturb_frequency_response", False),
        vol_perturbed=ds.get("vol_perturbed"))
    kw = dict(batch_size=train["batch_size"], shuffle=True, collate_fn=NsCollateFunc(),
              num_workers=int(train.get("num_workers", 0)), seed=train.get("seed"))
    return (DataLoader(NsDataset(folder=ds["train"], **common), **kw),
            DataLoader(NsDataset(folder=ds["dev"], **common), **kw))


def action_train(hparam, device) -> NsTask:
    model = init_model(hparam["MODEL"]["type"], init_loss(hparam), device=device,
                       generator=torch.Generator().manual_seed(0))
    train_loader, dev_loader = init_dataloader(hparam)
    trainer = NsTask(hparam, model, device, train_loader, dev_loader)
    trainer.train()
    return trainer


def main(config) -> NsTask:
    if config.action != "train":
        raise NotImplementedError(
            f"--action {config.action} is not ported yet (ROADMAP queue 1 item 2: "
            "the recipes' other actions); only train is")
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
