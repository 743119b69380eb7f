"""NS recipe command line: train, dev, eval, stream_eval, serve and
export_model (counterpart of egs/ns/main.py: `load_eval_model` `:29-40`,
`init_dataloader` `:42-84`, `action_train` `:86-106`, `action_dev`
`:109-173`, `action_eval` `:176-220`, `action_stream_eval` `:223-252`,
`action_serve` `:255-266`, `action_export` `:269-278`, `main` `:281-324`).

    python -m puresound_tpu_torch.egs.ns.main <NS.yaml-style config> \\
        --action train|dev|eval|stream_eval|serve|export_model [--ckpt epoch_N.ckpt] \\
        [--backend cuda|cpu]

Runs on the CUDA card unless `--backend cpu` asks for the CPU; `cuda`
raises where torch sees no card. dev / eval / stream_eval load `--ckpt`
(the port's checkpoint or the JAX package's) honouring
`TRAIN.model_average`; stream_eval and serve take the engine's kernel
routes (`--fused`, `--dp_kernel`, `--attn_kernel`, `--mk_kernel`). serve
opens the TCP front on `--port` with `--serve_slots` sessions, each
attached by an empty HELLO. Augmentation (host chain or
augment_on_device), TRAIN.remat and multi-process training (`--num_processes
--process_id --coordinator`, one process per card) work as in the TSE
recipe. export_model writes the model's `torch.export` artifacts to
TRAIN.model_save_dir/<ckpt>.<Name>.pt2, as the TSE recipe's does.
`TRAIN.mp_devices: k` with `--num_processes N` (N % k == 0) trains
tensor-parallel over the (N / k, k) process mesh, the loader sharding by
dp index.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ...src.audio import AudioIO
from ...src.metrics import Metrics
from ...src.utils import create_folder, load_hparam, load_text_as_dict
from ...streaming.deploy import run_serve
from ...streaming.file_eval import build_engine, stream_signal
from ...streaming.halfprec import to_half
from ...tasks.base import BaseTrainer, DataLoader
from ...tasks.batch_eval import BucketedBatchRunner
from ...tasks.ns import NsCollateFunc, NsDataset, NsTask
from ...zoo.ns import init_loss, init_model
from ..tse.main import (_detail_scores, _open, _tensor, add_eval_args,
                       add_process_args, add_serve_args, check_action, export_model,
                       loader_kwargs, on_device_split, run_main)

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
              num_workers=int(train.get("num_workers", 0)), **loader_kwargs(train))
    return (DataLoader(NsDataset(folder=ds["train"], **on_device_split(ds, common)), **kw),
            DataLoader(NsDataset(folder=ds["dev"], **common), **kw))


def action_train(hparam, device) -> NsTask:
    model = init_model(hparam["MODEL"]["type"], init_loss(hparam), device=device,
                       generator=torch.Generator().manual_seed(0))
    train_loader, dev_loader = init_dataloader(hparam)
    trainer = NsTask(hparam, model, device, train_loader, dev_loader)
    trainer.train()
    return trainer


# ------------------------------------------------------------- evaluation
def load_eval_model(hparam, ckpt_name: str, device):
    """The zoo model on `device` in eval mode (BatchNorm on its running
    statistics), its parameters from the checkpoint (TRAIN.model_average)."""
    model = init_model(hparam["MODEL"]["type"], device=device)
    return BaseTrainer.resolve_eval_params(hparam, ckpt_name, model).eval()


def _runner(model, hparam, device, batch_eval: int, eval_quantum: float):
    return BucketedBatchRunner(model.inference, batch_size=batch_eval,
                               quantum=int(hparam["DATASET"]["sample_rate"] * eval_quantum),
                               pad_modes=("zero",), device=device)


def _dev_pairs(model, hparam, device, loader, batch_eval, eval_quantum):
    if batch_eval > 0:
        batches = list(loader)
        runner = _runner(model, hparam, device, batch_eval, eval_quantum)
        outs = runner.run([(b["process_wav"],) for b in batches])
        print(f"batch_eval: {len(runner.bucket_keys)} bucket shapes "
              f"for {len(batches)} utterances")
        for b, o in zip(batches, outs):
            yield b, o[None]
        return
    for b in loader:
        yield b, model.inference(_tensor(b["process_wav"], device)).cpu().numpy()


def action_dev(hparam, device, ckpt, metrics="simple", batch_eval=0,
               eval_quantum=1.0) -> dict:
    """Score the dev set (PESQ / STOI / SDR with `--metrics detail`, SI-SNR,
    SI-SNRi), printing a row per utterance and the means; returns the
    means."""
    dev_ds = NsDataset(folder=hparam["DATASET"]["dev"],
                       resample_to=hparam["DATASET"]["sample_rate"], max_length=None)
    loader = DataLoader(dev_ds, batch_size=1, shuffle=False, collate_fn=NsCollateFunc())
    model = load_eval_model(hparam, ckpt, device)
    names = ("PESQ", "STOI", "SDR", "SiSNR", "SiSNRi")
    scores = {k: [] for k in names}
    print("uttid, PESQ, STOI, SDR, SISNR, SISNRi")
    with torch.inference_mode():
        for batch, enh in _dev_pairs(model, hparam, device, loader, batch_eval,
                                     eval_quantum):
            clean, noisy = batch["clean_wav"], batch["process_wav"]
            row = (*_detail_scores(clean, enh, metrics), Metrics.sisnr(clean, enh),
                   Metrics.sisnr_imp(clean, enh, noisy))
            for k, v in zip(names, row):
                scores[k].append(v)
            print(f"{batch['uttid'][0]}, " + ", ".join(str(v) for v in row))
    means = {k: np.mean(v) for k, v in scores.items()}
    for k, v in means.items():
        print(f"{k}: {v}")
    return means


def action_eval(hparam, device, ckpt, batch_eval=0, eval_quantum=1.0) -> str:
    """Enhance the eval set (wav2scp.txt) into
    TRAIN.model_save_dir/eval_audio/<key>.wav; returns that folder."""
    sr = hparam["DATASET"]["sample_rate"]
    out_dir = f"{hparam['TRAIN']['model_save_dir']}/eval_audio"
    create_folder(out_dir)
    model = load_eval_model(hparam, ckpt, device)
    test_audio = load_text_as_dict(f"{hparam['DATASET']['eval']}/wav2scp.txt")
    keys = list(test_audio.keys())
    load = lambda k: np.asarray(_open(test_audio[k][0], sr))
    with torch.inference_mode():
        if batch_eval > 0:
            runner = _runner(model, hparam, device, batch_eval, eval_quantum)
            # macro-chunks keep the host's memory bounded on large sets
            group = max(batch_eval * 8, 64)
            for start in range(0, len(keys), group):
                chunk = keys[start:start + group]
                for k, o in zip(chunk, runner.run([(load(k),) for k in chunk])):
                    print(f"Running inference: {k}")
                    AudioIO.save(o.reshape(1, -1), f"{out_dir}/{k}.wav", sr)
            return out_dir
        for key in keys:
            print(f"Running inference: {key}")
            enh = model.inference(_tensor(load(key), device)).cpu().numpy()
            AudioIO.save(enh.reshape(1, -1), f"{out_dir}/{key}.wav", sr)
    return out_dir


def action_stream_eval(hparam, device, ckpt, chunk_ms=16.0, half=False, fused=False,
                       dp_kernel=False, attn_kernel=False, mk_kernel=False) -> list:
    """Stream the eval set through `StreamingNS` on the route the flags
    pick, in `chunk_ms` chunks; writes
    TRAIN.model_save_dir/stream_eval_audio/<key>.wav aligned with the input
    and prints each utterance's RTF and their mean; returns the RTFs."""
    sr = hparam["DATASET"]["sample_rate"]
    out_dir = f"{hparam['TRAIN']['model_save_dir']}/stream_eval_audio"
    create_folder(out_dir)
    model = load_eval_model(hparam, ckpt, device)
    engine = build_engine(to_half(model) if half else model)
    test_audio = load_text_as_dict(f"{hparam['DATASET']['eval']}/wav2scp.txt")
    rtfs = []
    for key in test_audio.keys():
        enh, rtf = stream_signal(engine, _open(test_audio[key][0], sr), sr,
                                 chunk_ms=chunk_ms, half=half, fused=fused,
                                 dp_kernel=dp_kernel, attn_kernel=attn_kernel,
                                 mk_kernel=mk_kernel)
        rtfs.append(rtf)
        print(f"Streamed {key}: RTF {rtf:.1f}x real time")
        AudioIO.save(enh.reshape(1, -1), f"{out_dir}/{key}.wav", sr)
    if rtfs:
        print(f"Average RTF over {len(rtfs)} utts: {np.mean(rtfs):.1f}x "
              f"({chunk_ms} ms chunks)")
    return rtfs


def action_serve(hparam, device, ckpt, chunk_ms, n_slots, port, half=False, fused=False,
                 dp_kernel=False, attn_kernel=False, mk_kernel=False,
                 pcm16=False) -> None:
    """Serve the checkpoint through the TCP front until Ctrl-C (JAX's
    `egs/ns/main.py:255-266`)."""
    model = load_eval_model(hparam, ckpt, device)
    run_serve(model, None, n_slots, port=port, chunk_ms=chunk_ms,
              sr=hparam["DATASET"]["sample_rate"], half=half, fused=fused,
              dp_kernel=dp_kernel, attn_kernel=attn_kernel, mk_kernel=mk_kernel,
              pcm16=pcm16)


def main(config):
    check_action(config)
    hparam = load_hparam(config.config_path)
    create_folder(hparam["TRAIN"]["model_save_dir"])
    return run_main(config, hparam, lambda device: _run(config, hparam, device))


def _run(config, hparam, device):
    if config.action == "train":
        return action_train(hparam, device)
    if config.action == "dev":
        return action_dev(hparam, device, config.ckpt, config.metrics,
                          config.batch_eval, config.eval_quantum)
    if config.action == "eval":
        return action_eval(hparam, device, config.ckpt, config.batch_eval,
                           config.eval_quantum)
    if config.action == "export_model":
        return export_model(load_eval_model(hparam, config.ckpt, device), hparam, config.ckpt)
    if config.action == "serve":
        return action_serve(hparam, device, config.ckpt, config.chunk_ms,
                            config.serve_slots, config.port, config.half, config.fused,
                            config.dp_kernel, config.attn_kernel, config.mk_kernel,
                            config.pcm16)
    return action_stream_eval(hparam, device, config.ckpt, config.chunk_ms, config.half,
                              config.fused, config.dp_kernel, config.attn_kernel,
                              config.mk_kernel)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config_path", type=str)
    parser.add_argument("--action", type=str, default="train", choices=ACTIONS)
    parser.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"])
    add_process_args(parser)
    add_eval_args(parser)
    add_serve_args(parser)
    parser.add_argument("--fused", action="store_true",
                        help="stream_eval with the recurrences through lstm_scan")
    parser.add_argument("--dp_kernel", action="store_true",
                        help="stream_eval with the dual-path bottleneck kernel (DPCRN)")
    parser.add_argument("--attn_kernel", action="store_true",
                        help="stream_eval with the intra-attention kernel (DPARN)")
    parser.add_argument("--mk_kernel", action="store_true",
                        help="stream_eval with the wide-center masker kernel "
                             "(DPCRN / DPARN)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
