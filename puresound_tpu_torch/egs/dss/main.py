"""DSS (near / far separation) recipe command line: train, dev, eval,
stream_eval, serve and export_model (counterpart of egs/dss/main.py:
`build_model` `:16-34`, `load_eval_model` `:37-52`, `action_train`
`:55-96`, `action_dev` `:99-148`, `action_eval` `:151-207`, `action_serve`
`:210-221`, `action_stream_eval` `:224-253`, `action_export` `:256-265`,
`main` `:268-309`).

    python -m puresound_tpu_torch.egs.dss.main <egs/dss/conf/dss_dparn_1a.yaml-style config> \\
        --action train|dev|eval|stream_eval|serve|export_model [--ckpt epoch_N.ckpt] \\
        [--backend cuda|cpu]

The model is the SIMO wrapper of a ConvEncDec (512 / 512 / 128) and a
`DPARN_Mout` with two outputs, near and far. Runs on the CUDA card unless
`--backend cpu` asks for the CPU; `cuda` raises where torch sees no card.
dev / eval / stream_eval / serve load `--ckpt` (the port's checkpoint or
the JAX package's) honouring `TRAIN.model_average`. dev prints each
utterance's SI-SNR of the near and the far output and their means; eval
and stream_eval write `<key>_near.wav` / `<key>_far.wav`; stream_eval
takes `--half`, `--fused` and `--mk_kernel`; serve opens the TCP front,
each session's two sources sample-interleaved. The host augmentation chain
(noise_folder, speed_perturbed, vol_perturbed), TRAIN.remat and
multi-process training (`--num_processes --process_id --coordinator`, one
process per card) work as in the TSE recipe; augment_on_device raises, as
JAX's DSS recipe fails on it. export_model writes the model's
`torch.export` artifacts to TRAIN.model_save_dir/<ckpt>.<Name>.pt2, as the
TSE recipe's does.
`TRAIN.mp_devices: k` with `--num_processes N` (N % k == 0) trains
tensor-parallel over the (N / k, k) process mesh, the loader sharding by
dp index.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ...nnet.base_nn import SiMoTaskWrapModule
from ...nnet.dparn import DPARN_Mout
from ...nnet.encoder import ConvEncDec
from ...nnet.loss.sdr import SDRLoss
from ...src.audio import AudioIO
from ...src.metrics import Metrics
from ...src.utils import create_folder, load_hparam, load_text_as_dict
from ...streaming.deploy import run_serve
from ...streaming.file_eval import build_engine, stream_signal
from ...streaming.halfprec import to_half
from ...tasks.base import BaseTrainer, DataLoader
from ...tasks.batch_eval import BucketedBatchRunner
from ...tasks.dss import DssCollateFunc, DssDataset, DssTask
from ...utils.init import generator_or_default
from ...zoo.tse import _device as _model_device
from ..tse.main import (_open, _tensor, add_process_args, check_action, export_model,
                       loader_kwargs, run_main)

ACTIONS = ("train", "dev", "eval", "stream_eval", "serve", "export_model")
SOURCES = ("near", "far")


def build_model(hparam, sig_loss=None, *, device=None,
                generator: Optional[torch.Generator] = None) -> SiMoTaskWrapModule:
    """`dss_dparn_mout_v0` in eval mode on `device` (the card unless it
    says otherwise); `sig_loss` makes `forward` the training loss."""
    if hparam["MODEL"]["type"] != "dss_dparn_mout_v0":
        raise NameError(hparam["MODEL"]["type"])
    fk = dict(device=_model_device(device))
    g = generator_or_default(generator)
    return SiMoTaskWrapModule(
        encoder=ConvEncDec(fft_length=512, win_length=512, hop_length=128,
                           trainable=True, output_format="Complex", **fk),
        masker=DPARN_Mout(input_type="RI", input_dim=512, norm_type="bN2d", dropout=0.1,
                          channels=(1, 32, 32, 32, 64, 128), transpose_t_size=2,
                          kernel_t=(2, 2, 2, 2, 2), stride_t=(1, 1, 1, 1, 1),
                          dilation_t=(1, 1, 1, 1, 1), kernel_f=(5, 3, 3, 3, 3),
                          stride_f=(2, 2, 1, 1, 1), dilation_f=(1, 1, 1, 1, 1),
                          delay=(0, 0, 0, 0, 0), multi_output=2, rnn_hidden=128, nhead=8,
                          generator=g, **fk),
        loss_func_wav=sig_loss, f_type="Complex", mask_type="Complex",
        drop_first_bin=True).eval()


def init_dataloader(hparam):
    ds, train = hparam["DATASET"], hparam["TRAIN"]
    make = lambda folder: DataLoader(
        DssDataset(folder=folder, resample_to=ds["sample_rate"], max_length=ds["max_length"],
                   noise_folder=ds.get("noise_folder"), vol_perturbed=ds.get("vol_perturbed"),
                   speed_perturbed=ds.get("speed_perturbed", False)),
        batch_size=train["batch_size"], shuffle=True, collate_fn=DssCollateFunc(),
        num_workers=int(train.get("num_workers", 0)), **loader_kwargs(train))
    return make(ds["train"]), make(ds["dev"])


def action_train(hparam, device) -> DssTask:
    loss = hparam["LOSS"]
    sig_loss = SDRLoss.init_mode(loss["sig_loss"], threshold=loss.get("sig_threshold"))
    model = build_model(hparam, sig_loss, device=device,
                        generator=torch.Generator().manual_seed(0))
    train_loader, dev_loader = init_dataloader(hparam)
    trainer = DssTask(hparam, model, device, train_loader, dev_loader)
    trainer.train()
    return trainer


# ------------------------------------------------------------- evaluation
def load_eval_model(hparam, ckpt_name: str, device):
    """The model on `device` in eval mode, its parameters from the
    checkpoint (TRAIN.model_average: N averages the last N epochs')."""
    return BaseTrainer.resolve_eval_params(hparam, ckpt_name,
                                           build_model(hparam, device=device)).eval()


def _runner(model, hparam, device, batch_eval: int, eval_quantum: float):
    return BucketedBatchRunner(model.inference, batch_size=batch_eval,
                               quantum=int(hparam["DATASET"]["sample_rate"] * eval_quantum),
                               pad_modes=("zero",), device=device)


def _dev_pairs(model, hparam, device, loader, batch_eval, eval_quantum):
    """(batch, outputs [1, M, L]) in manifest order."""
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


def action_dev(hparam, device, ckpt, batch_eval=0, eval_quantum=1.0) -> dict:
    """SI-SNR of the near and the far output on the dev set, a row per
    utterance and the means; returns the means."""
    sr = hparam["DATASET"]["sample_rate"]
    loader = DataLoader(DssDataset(folder=hparam["DATASET"]["dev"], resample_to=sr,
                                   max_length=None),
                        batch_size=1, shuffle=False, collate_fn=DssCollateFunc())
    model = load_eval_model(hparam, ckpt, device)
    scores = {"near": [], "far": []}
    print("uttid, SISNR(near), SISNR(far)")
    with torch.inference_mode():
        for batch, out in _dev_pairs(model, hparam, device, loader, batch_eval,
                                     eval_quantum):
            s_near = Metrics.sisnr(batch["near_wav"], out[:, 0])
            s_far = Metrics.sisnr(batch["far_wav"], out[:, 1])
            scores["near"].append(s_near)
            scores["far"].append(s_far)
            print(f"{batch['uttid'][0]}, {s_near}, {s_far}")
    means = {k: np.mean(v) for k, v in scores.items()}
    print(f"SiSNR near: {means['near']}")
    print(f"SiSNR far: {means['far']}")
    return means


def _load_mix(path: str, sr: int) -> np.ndarray:
    """The mixture [1, L], a multi-channel file down-mixed to mono (the
    batched runner takes one row an item)."""
    mix = np.asarray(_open(path, sr))
    if mix.ndim == 2 and mix.shape[0] > 1:
        mix = mix.mean(axis=0, keepdims=True)
    return mix


def _save_sources(out_dir: str, key: str, out: np.ndarray, sr: int) -> None:
    """out [M, L] -> <key>_near.wav, <key>_far.wav."""
    for m, tag in enumerate(SOURCES[:out.shape[0]]):
        AudioIO.save(out[m].reshape(1, -1), f"{out_dir}/{key}_{tag}.wav", sr)


def action_eval(hparam, device, ckpt, batch_eval=0, eval_quantum=1.0) -> str:
    """Separate the eval set (wav2scp.txt) into
    TRAIN.model_save_dir/eval_audio/<key>_{near,far}.wav; returns that
    folder."""
    sr = hparam["DATASET"]["sample_rate"]
    out_dir = f"{hparam['TRAIN']['model_save_dir']}/eval_audio"
    create_folder(out_dir)
    model = load_eval_model(hparam, ckpt, device)
    test_audio = load_text_as_dict(f"{hparam['DATASET']['eval']}/wav2scp.txt")
    keys = list(test_audio.keys())
    with torch.inference_mode():
        if batch_eval > 0:
            runner = _runner(model, hparam, device, batch_eval, eval_quantum)
            # macro-chunks keep the host's memory bounded on large sets
            group = max(batch_eval * 8, 64)
            for start in range(0, len(keys), group):
                chunk = keys[start:start + group]
                outs = runner.run([(_load_mix(test_audio[k][0], sr),) for k in chunk])
                for k, o in zip(chunk, outs):
                    print(f"Running inference: {k}")
                    _save_sources(out_dir, k, o, sr)
            return out_dir
        for key in keys:
            print(f"Running inference: {key}")
            out = model.inference(_tensor(_load_mix(test_audio[key][0], sr), device))
            _save_sources(out_dir, key, out[0].cpu().numpy(), sr)
    return out_dir


def action_stream_eval(hparam, device, ckpt, chunk_ms=16.0, half=False, fused=False,
                       mk_kernel=False) -> list:
    """Stream the dev set (as JAX's DSS recipe does) through `StreamingDSS`
    in `chunk_ms` chunks on the route the flags pick; writes
    TRAIN.model_save_dir/stream_eval_audio/<key>_{near,far}.wav aligned with
    the input, prints each utterance's RTF and their mean; returns the
    RTFs."""
    sr = hparam["DATASET"]["sample_rate"]
    out_dir = f"{hparam['TRAIN']['model_save_dir']}/stream_eval_audio"
    create_folder(out_dir)
    model = load_eval_model(hparam, ckpt, device)
    engine = build_engine(to_half(model) if half else model)
    test_audio = load_text_as_dict(f"{hparam['DATASET']['dev']}/wav2scp.txt")
    rtfs = []
    for key in test_audio.keys():
        out, rtf = stream_signal(engine, _open(test_audio[key][0], sr), sr,
                                 chunk_ms=chunk_ms, half=half, fused=fused,
                                 mk_kernel=mk_kernel)
        rtfs.append(rtf)
        print(f"Streamed {key}: RTF {rtf:.1f}x real time")
        _save_sources(out_dir, key, out, sr)
    if rtfs:
        print(f"Average RTF over {len(rtfs)} utts: {np.mean(rtfs):.1f}x "
              f"({chunk_ms} ms chunks)")
    return rtfs


def action_serve(hparam, device, ckpt, chunk_ms, n_slots, port, half=False, fused=False,
                 mk_kernel=False, pcm16=False) -> None:
    """SIMO serving through the TCP front until Ctrl-C: each connection
    streams a mixture and gets the M separated sources back
    sample-interleaved (its ACK carries n_sources; `StreamingClient`
    de-interleaves to [M, T])."""
    model = load_eval_model(hparam, ckpt, device)
    run_serve(model, None, n_slots, port=port, chunk_ms=chunk_ms,
              sr=hparam["DATASET"]["sample_rate"], half=half, fused=fused,
              mk_kernel=mk_kernel, pcm16=pcm16)


def main(config):
    check_action(config)
    hparam = load_hparam(config.config_path)
    create_folder(hparam["TRAIN"]["model_save_dir"])
    return run_main(config, hparam, lambda device: _run(config, hparam, device))


def _run(config, hparam, device):
    if config.action == "train":
        return action_train(hparam, device)
    if config.action == "dev":
        return action_dev(hparam, device, config.ckpt, config.batch_eval,
                          config.eval_quantum)
    if config.action == "eval":
        return action_eval(hparam, device, config.ckpt, config.batch_eval,
                           config.eval_quantum)
    if config.action == "export_model":
        return export_model(load_eval_model(hparam, config.ckpt, device), hparam, config.ckpt)
    if config.action == "serve":
        return action_serve(hparam, device, config.ckpt, config.chunk_ms,
                            config.serve_slots, config.port, config.half, config.fused,
                            config.mk_kernel, config.pcm16)
    return action_stream_eval(hparam, device, config.ckpt, config.chunk_ms, config.half,
                              config.fused, config.mk_kernel)


def parse_args(argv=None):
    """JAX's DSS flags (`egs/dss/main.py:312-353`), with `--backend cuda|cpu`."""
    parser = argparse.ArgumentParser()
    parser.add_argument("config_path", type=str)
    parser.add_argument("--action", type=str, default="train", choices=ACTIONS)
    parser.add_argument("--serve_slots", type=int, default=64,
                        help="serve: fixed concurrent-session capacity")
    parser.add_argument("--port", type=int, default=7654,
                        help="serve: TCP port for the socket front-end")
    parser.add_argument("--chunk_ms", type=float, default=16.0,
                        help="stream_eval chunk size in milliseconds")
    parser.add_argument("--half", action="store_true",
                        help="stream_eval / serve in bfloat16 (serving mode)")
    parser.add_argument("--pcm16", action="store_true",
                        help="serve: move each tick's audio host<->device as int16 PCM")
    parser.add_argument("--mk_kernel", action="store_true",
                        help="stream_eval / serve with the wide-center masker kernel")
    parser.add_argument("--fused", action="store_true",
                        help="stream_eval / serve with the inter LSTMs through lstm_scan")
    parser.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--batch_eval", type=int, default=0,
                        help="dev / eval: bucketed batched inference at this batch size "
                             "(0: one utterance at a time)")
    parser.add_argument("--eval_quantum", type=float, default=1.0,
                        help="batch_eval: the length buckets' grid in seconds")
    parser.add_argument("--ckpt", type=str, default=None)
    add_process_args(parser)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
