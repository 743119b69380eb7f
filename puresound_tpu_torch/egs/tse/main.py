"""TSE recipe command line: train, dev, tSNE, eval, export_model,
stream_eval and serve (counterpart of egs/tse/main.py: `load_eval_model`
`:33-43`, `init_dataloader` `:46-113`, `action_train` `:116-144`,
`action_dev` `:147-253`, `action_tsne` `:256-310`, `action_eval`
`:311-375`, `action_export` `:378-386`, `action_serve` `:389-399`,
`action_stream_eval` `:402-440`, `main` `:443-491`).

    python -m puresound_tpu_torch.egs.tse.main <TSE.yaml-style config> \\
        --action train|dev|tSNE|eval|export_model|stream_eval|serve \\
        [--ckpt epoch_N.ckpt] [--backend cuda|cpu]

Runs on the CUDA card unless `--backend cpu` asks for the CPU; `cuda`
raises where torch sees no card. With `TRAIN.contrastive_learning` the
batches are `SpeakerSampler`'s, p_spks speakers x p_utts utterances, as the
GE2E loss needs them. dev / eval / stream_eval load `--ckpt` (a file under
TRAIN.model_save_dir, the port's or the JAX package's) honouring
`TRAIN.model_average`, and score or write the dev / eval sets; `--batch_eval
N` batches dev / eval N utterances at a time in length buckets. serve opens
the TCP front (`streaming.socket_server`) on `--port` with `--serve_slots`
sessions, each enrolled by its HELLO (a d-vector or an enrollment
waveform); `--fused` serves the SkiM stack through `fused_skim_frames`
(its chunk's frames must divide SkiM's seg_size: `--chunk_ms 15` for the
shipped configs). The DATASET keys turn on the host augmentation chain
(noise_folder, rir_folder / rir_mode, vol_perturbed, speed_perturbed,
perturb_frequency_response, enroll_augment) or, with augment_on_device,
RIR, noise and volume in the step; TRAIN.remat recomputes the forward in
the backward. `--num_processes N --process_id i --coordinator host:port`
trains data-parallel, one process per card (NCCL; gloo with `--backend
cpu`), with TRAIN.multi_gpu: true as JAX's recipes ask. stream_eval
refuses an embedding-free model (`veve_dprnn_v0_causal`: its enrollment
conditions the masker's initial state, which JAX's stream_eval never sets)
and a non-causal one (stream_eval and serve refuse `tse_unet_tcn_v0` /
`_v1` with the streaming engine's ValueError; the causal STFT-domain
`tse_unet_tcn_v0_causal` streams through `StreamingNS` with its speaker
net). tSNE embeds the dev set's enrollments (`inference_tse_embedding`),
prints their silhouette by speaker and writes a t-SNE plot,
TRAIN.model_save_dir/Speaker_dev_tSNE.png and .html (scikit-learn and
matplotlib, imported by the action). export_model writes the model's
`torch.export` artifacts (`utils.export.export_program`) to
TRAIN.model_save_dir/<ckpt>.<Name>.pt2; load them after importing
puresound_tpu_torch, which registers the kernels' ops.
`TRAIN.mp_devices: k` with `--num_processes N` (N % k == 0) trains
tensor-parallel over the (N / k, k) process mesh, the loader sharding by
dp index.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ...parallel import multihost
from ...src.audio import AudioIO
from ...src.metrics import Metrics
from ...src.sampler import SpeakerSampler
from ...src.utils import create_folder, load_hparam, load_text_as_dict
from ...streaming.deploy import run_serve
from ...streaming.file_eval import build_engine, stream_signal
from ...streaming.halfprec import to_half
from ...tasks.base import BaseTrainer, DataLoader
from ...tasks.batch_eval import BucketedBatchRunner
from ...tasks.tse import TseCollateFunc, TseDataset, TseTask
from ...zoo.tse import init_loss, init_model
from .local.binarize import Binarize

ACTIONS = ("train", "dev", "eval", "tSNE", "export_model", "stream_eval", "serve")


def _device(backend: str, process_id: Optional[int] = None) -> torch.device:
    """The CPU, or the card (card process_id modulo the cards seen in a
    multi-process run: one process per card)."""
    if backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--backend cuda (the default) needs a CUDA card and "
                           "torch sees none; pass --backend cpu to run on the CPU")
    if process_id is None:
        return torch.device("cuda")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def loader_kwargs(train) -> Dict:
    """The seed, and in a multi-process run this process's shard of every
    global batch (JAX's `egs/tse/main.py:100-105`): its dp index's rows, so
    the mp ranks of one dp row (`TRAIN.mp_devices`) load the same rows."""
    if multihost.process_count() > 1:
        multihost.mesh_groups(int(train.get("mp_devices") or 1))
        return dict(shard=(multihost.dp_index(), multihost.dp_count()),
                    seed=int(train.get("seed") or 0))
    return dict(seed=train.get("seed"))


def on_device_split(ds, common: Dict) -> Dict:
    """The train set's dataset options: with augment_on_device, RIR, noise
    and volume move into the step (the dev set keeps the host chain, so dev
    losses compare across modes)."""
    if not ds.get("augment_on_device"):
        return common
    return dict(common, noise_folder=None, rir_folder=None, vol_perturbed=None)


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
                          inactive_training=ds["inactive_training"],
                          **on_device_split(ds, common))
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
              num_workers=n_work, **loader_kwargs(train))
    return DataLoader(train_ds, **kw), DataLoader(dev_ds, **kw)


def action_train(hparam, device) -> TseTask:
    gen = torch.Generator().manual_seed(0)
    losses = init_loss(hparam, device=device, generator=gen)
    model = init_model(hparam["MODEL"]["type"], *losses, device=device, generator=gen)
    train_loader, dev_loader = init_dataloader(hparam)
    trainer = TseTask(hparam, model, device, train_loader, dev_loader)
    trainer.train()
    return trainer


# ------------------------------------------------------------- evaluation
def load_eval_model(hparam, ckpt_name: str, device):
    """The zoo model (no losses) on `device` in eval mode, its parameters
    from the checkpoint (TRAIN.model_average: N averages the last N epoch
    checkpoints)."""
    model = init_model(hparam["MODEL"]["type"], device=device)
    return BaseTrainer.resolve_eval_params(hparam, ckpt_name, model).eval()


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _binarizer(sr: int) -> Binarize:
    return Binarize(threshold=0.5, stability=0.05, sample_rate=sr, mode="moving_average")


def _runner(model, hparam, device, batch_eval: int, eval_quantum: float):
    """`--batch_eval N`: enrollments on a 4x coarser grid (the bucket keys
    are the (mixture, enrollment) product, and enrollment lengths vary
    continuously)."""
    sr = hparam["DATASET"]["sample_rate"]
    return BucketedBatchRunner(model.inference, batch_size=batch_eval,
                               quantum=(int(sr * eval_quantum), int(sr * eval_quantum * 4)),
                               pad_modes=("zero", "tile"), device=device)


def _dev_pairs(model, hparam, device, loader, batch_eval, eval_quantum):
    """(batch, enhanced [1, ...]) in manifest order, one utterance at a
    time or bucketed at batch_eval."""
    if batch_eval > 0:
        batches = list(loader)
        runner = _runner(model, hparam, device, batch_eval, eval_quantum)
        outs = runner.run([(b["process_wav"], b["enroll_wav"]) for b in batches])
        print(f"batch_eval: {len(runner.bucket_keys)} bucket shapes "
              f"for {len(batches)} utterances")
        for b, o in zip(batches, outs):
            yield b, o[None]
        return
    for b in loader:
        yield b, model.inference(_tensor(b["process_wav"], device),
                                 _tensor(b["enroll_wav"], device)).cpu().numpy()


def action_dev(hparam, device, ckpt, metrics="simple", batch_eval=0,
               eval_quantum=1.0) -> dict:
    """Score the dev set (PESQ / STOI / SDR with `--metrics detail`, SI-SNR,
    SI-SNRi, NSR; accuracy / precision / recall / F1 of the binarized output
    for a PVAD set), printing a row per utterance and the means; returns
    the means."""
    ds = hparam["DATASET"]
    is_vad = ds["type"].lower() == "pvad"
    dev_ds = TseDataset(folder=ds["dev"], resample_to=ds["sample_rate"], max_length=None,
                        rir_mode=ds.get("rir_mode") or "image",
                        enroll_rule=ds.get("enroll_rule"), is_vad_dataset=is_vad)
    loader = DataLoader(dev_ds, batch_size=1, shuffle=False, collate_fn=TseCollateFunc())
    model = load_eval_model(hparam, ckpt, device)
    with torch.inference_mode():
        pairs = _dev_pairs(model, hparam, device, loader, batch_eval, eval_quantum)
        if is_vad:
            return _score_vad(pairs, _binarizer(ds["sample_rate"]))
        return _score_tse(pairs, metrics)


def _score_vad(pairs, binarizer) -> dict:
    scores = {k: [] for k in ("accuracy", "precision", "recall", "f1_score")}
    print("accuracy, precision, recall, f1_score")
    for batch, enh in pairs:
        score = Metrics.f1_score(batch["clean_wav"], binarizer(enh).astype(np.float32))
        for k, v in scores.items():
            v.append(score[k])
        print(f"{batch['uttid'][0]}, " + ", ".join(str(v[-1]) for v in scores.values()))
    means = {k: np.mean(v) for k, v in scores.items()}
    for k, v in means.items():
        print(f"{k}: {v}")
    return means


def _detail_scores(clean, enh, metrics: str):
    """(PESQ, STOI, SDR); zeros under `--metrics simple`."""
    if metrics != "detail":
        return 0, 0, 0
    try:
        pesq = Metrics.pesq_wb(clean, enh)
    except ValueError:  # utterance too short for PESQ (< 0.25 s)
        pesq = 0
    return pesq, Metrics.stoi(clean, enh), Metrics.bss_sdr(clean, enh)


def _score_tse(pairs, metrics: str) -> dict:
    names = ("PESQ", "STOI", "SDR", "SiSNR", "SiSNRi", "NSR", "NSR-negative")
    scores = {k: [] for k in names}
    print("uttid, PESQ, STOI, SDR, SISNR, SISNRi, NSR")
    for batch, enh in pairs:
        clean, noisy = batch["clean_wav"], batch["process_wav"]
        sisnr = Metrics.sisnr(clean, enh)
        sisnri = Metrics.sisnr_imp(clean, enh, noisy)
        nsr = 1 if (sisnri < 0 and sisnr < 30) else 0
        row = (*_detail_scores(clean, enh, metrics), sisnr, sisnri, nsr,
               1 if (nsr and sisnr < 0) else 0)
        for k, v in zip(names, row):
            scores[k].append(v)
        print(f"{batch['uttid'][0]}, " + ", ".join(str(v) for v in row[:6]))
    means = {k: np.mean(v) for k, v in scores.items()}
    for k, v in means.items():
        print(f"{k}: {v}")
    return means


def _eval_sets(hparam):
    ds = hparam["DATASET"]
    return (load_text_as_dict(f"{ds['eval']}/wav2scp.txt"),
            load_text_as_dict(f"{ds['eval']}/ref2list.txt"))


def _open(path: str, sr: int, target_lvl=None) -> np.ndarray:
    wav, wav_sr = AudioIO.open(f_path=path, target_lvl=target_lvl)
    return AudioIO.resample(wav, wav_sr, sr) if wav_sr != sr else wav


def _load_pair(test_audio, enroll_dct, key, sr):
    """(mixture [1, L], the key's enrollments at -28 dB joined [1, L'])."""
    enrolls = [_open(p, sr, target_lvl=-28) for p in enroll_dct[key]]
    return (np.asarray(_open(test_audio[key][0], sr)),
            np.concatenate(enrolls, axis=-1))


def action_eval(hparam, device, ckpt, batch_eval=0, eval_quantum=1.0) -> str:
    """Enhance the eval set (wav2scp.txt, ref2list.txt) into
    TRAIN.model_save_dir/eval_audio/<key>.wav; returns that folder."""
    sr = hparam["DATASET"]["sample_rate"]
    out_dir = f"{hparam['TRAIN']['model_save_dir']}/eval_audio"
    create_folder(out_dir)
    model = load_eval_model(hparam, ckpt, device)
    test_audio, enroll_dct = _eval_sets(hparam)
    post = _binarizer(sr) if hparam["DATASET"]["type"].lower() == "pvad" else None

    def finish(key, enh):
        enh = np.asarray(enh).reshape(1, -1)
        if post is not None:
            enh = post(enh).astype(np.float32)
        AudioIO.save(enh.reshape(1, -1), f"{out_dir}/{key}.wav", sr)

    keys = list(test_audio.keys())
    with torch.inference_mode():
        if batch_eval > 0:
            runner = _runner(model, hparam, device, batch_eval, eval_quantum)
            # macro-chunks keep the host's memory bounded on large sets
            group = max(batch_eval * 8, 64)
            for start in range(0, len(keys), group):
                chunk = keys[start:start + group]
                outs = runner.run([_load_pair(test_audio, enroll_dct, k, sr) for k in chunk])
                for k, o in zip(chunk, outs):
                    print(f"Running inference: {k}")
                    finish(k, o)
            return out_dir
        for key in keys:
            print(f"Running inference: {key}")
            noisy, enroll = _load_pair(test_audio, enroll_dct, key, sr)
            finish(key, model.inference(_tensor(noisy, device),
                                        _tensor(enroll, device)).cpu().numpy())
    return out_dir


def action_stream_eval(hparam, device, ckpt, chunk_ms=16.0, half=False) -> list:
    """Stream the eval set through the model's engine (`StreamingTSE` on the
    unfused step, as JAX's, or `StreamingNS` for an STFT-domain model): each
    enrollment embedded once (in float32), the mixture
    streamed in `chunk_ms` chunks; writes
    TRAIN.model_save_dir/stream_eval_audio/<key>.wav aligned with the input
    and prints each utterance's RTF and their mean; returns the RTFs."""
    sr = hparam["DATASET"]["sample_rate"]
    model = load_eval_model(hparam, ckpt, device)
    if model.embedding_free_tse:
        raise ValueError(
            f"stream_eval does not stream the embedding-free {hparam['MODEL']['type']}: its "
            "enrollment conditions the masker's initial recurrent state "
            "(StreamingTSE.init_state(enroll_feats=)), which JAX's stream_eval never sets, "
            "so JAX's streams it unconditioned; stream it through the engine with "
            "init_state(enroll_feats=engine.embed(enroll)) and dvec None instead")
    out_dir = f"{hparam['TRAIN']['model_save_dir']}/stream_eval_audio"
    create_folder(out_dir)
    engine = build_engine(model)
    # under --half the stream runs on a bfloat16 copy; the embedding stays float32
    streamer = (build_engine(to_half(load_eval_model(hparam, ckpt, device)))
                if half else engine)
    test_audio, enroll_dct = _eval_sets(hparam)
    rtfs = []
    for key in test_audio.keys():
        noisy, enroll = _load_pair(test_audio, enroll_dct, key, sr)
        with torch.inference_mode():
            dvec = engine.embed(_tensor(enroll.reshape(1, -1), device))
        enh, rtf = stream_signal(streamer, noisy, sr, chunk_ms=chunk_ms, dvec=dvec,
                                 half=half)
        rtfs.append(rtf)
        print(f"Streamed {key}: RTF {rtf:.1f}x real time")
        AudioIO.save(enh.reshape(1, -1), f"{out_dir}/{key}.wav", sr)
    if rtfs:
        print(f"Average RTF over {len(rtfs)} utts: {np.mean(rtfs):.1f}x "
              f"({chunk_ms} ms chunks)")
    return rtfs


def tsne_dvecs(hparam, device, ckpt):
    """The dev set's enrollment d-vectors through `inference_tse_embedding`
    on `device` (float64 on the host, [N, E]), their speakers (ref2spk.txt)
    and utterance ids, in manifest order: the part of `--action tSNE` that
    runs the model."""
    ds = hparam["DATASET"]
    dev_ds = TseDataset(folder=ds["dev"], resample_to=ds["sample_rate"], max_length=None,
                        rir_mode=ds.get("rir_mode") or "image",
                        enroll_rule=ds.get("enroll_rule"))
    loader = DataLoader(dev_ds, batch_size=1, shuffle=False, collate_fn=TseCollateFunc())
    model = load_eval_model(hparam, ckpt, device)
    spk_dct = load_text_as_dict(f"{ds['dev']}/ref2spk.txt")
    spk_list, dvec_list, uttids = [], [], []
    dtype = next(model.parameters()).dtype
    with torch.inference_mode():
        for batch in loader:
            enroll = _tensor(batch["enroll_wav"], device).to(dtype)
            dvec = model.inference_tse_embedding(enroll)
            spk_list.append(spk_dct[batch["uttid"][0]][0])
            uttids.append(batch["uttid"][0])
            dvec_list.append(dvec.double().cpu().numpy().reshape(-1))
    return np.stack(dvec_list), spk_list, uttids


def action_tsne(hparam, device, ckpt) -> dict:
    """The dev set's enrollment d-vectors (`tsne_dvecs`), their silhouette
    score by speaker and a 2-d t-SNE of them, written as
    TRAIN.model_save_dir/Speaker_dev_tSNE.png and .html (JAX's
    `egs/tse/main.py:256-310`). scikit-learn and matplotlib are imported
    here, after the d-vectors, so a machine without them raises only here.
    Returns the d-vectors [N, E] (float64), speakers, utterance ids,
    silhouette and the t-SNE points."""
    dvecs, spk_list, uttids = tsne_dvecs(hparam, device, ckpt)
    from sklearn import manifold
    from sklearn.metrics import silhouette_score

    from ...utils.scatter_html import write_scatter_html

    silhouette = silhouette_score(dvecs, spk_list)
    print(f"silhouette: {silhouette}")
    perplexity = min(30.0, max(1.0, len(dvecs) - 1))
    tsne = manifold.TSNE(n_components=2, init="random", random_state=5,
                         perplexity=perplexity, verbose=1).fit_transform(dvecs)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    spk_idx = {s: i for i, s in enumerate(sorted(set(spk_list)))}
    plt.figure(figsize=(8, 8))
    plt.scatter(tsne[:, 0], tsne[:, 1], c=[spk_idx[s] for s in spk_list], cmap="tab20",
                alpha=0.5)
    plt.xticks([])
    plt.yticks([])
    out = f"{hparam['TRAIN']['model_save_dir']}/Speaker_dev_tSNE.png"
    plt.savefig(out)
    plt.close()
    print(f"saved {out}")
    html = f"{hparam['TRAIN']['model_save_dir']}/Speaker_dev_tSNE.html"
    write_scatter_html(html, tsne, spk_list, uttids, title="Speaker dev t-SNE")
    print(f"saved {html}")
    return {"dvecs": dvecs, "speakers": spk_list, "uttids": uttids,
            "silhouette": silhouette, "tsne": tsne}


def export_model(model, hparam, ckpt) -> list:
    """Write `model`'s torch.export artifacts to
    TRAIN.model_save_dir/<ckpt>.<Name>.pt2 (every recipe's export_model,
    JAX's `egs/tse/main.py:378-386`); returns the paths."""
    from ...utils.export import export_program

    return export_program(model, hparam["DATASET"]["sample_rate"],
                          hparam["TRAIN"]["model_save_dir"], ckpt)


def action_serve(hparam, device, ckpt, chunk_ms, n_slots, port, half=False, fused=False,
                 pcm16=False) -> None:
    """Serve the checkpoint through the TCP front until Ctrl-C: each
    connection enrolls its own target speaker (its HELLO a d-vector or an
    enrollment waveform) and streams mixture audio in for enhanced audio
    out (JAX's `egs/tse/main.py:389-399`)."""
    model = load_eval_model(hparam, ckpt, device)
    run_serve(model, None, n_slots, port=port, chunk_ms=chunk_ms,
              sr=hparam["DATASET"]["sample_rate"], half=half, fused=fused, pcm16=pcm16)


def check_action(config) -> None:
    """Raise for --num_processes > 1 with another action than train, and
    for a missing --ckpt (every action but train needs one,
    `egs/tse/main.py:448-469`)."""
    if config.num_processes > 1 and config.action != "train":
        raise ValueError("--num_processes > 1 applies to --action train")
    if config.action != "train" and not config.ckpt:
        raise ValueError(f"--ckpt is required for --action {config.action} "
                         "(a filename under TRAIN.model_save_dir)")


def join_processes(config, hparam) -> torch.device:
    """This process's device; with --num_processes > 1 the process group
    joined first (contrastive batches refused, as JAX's recipe does)."""
    if config.num_processes <= 1:
        return _device(config.backend)
    if hparam["TRAIN"].get("contrastive_learning"):
        raise NotImplementedError("SpeakerSampler batches are not process-sharded; "
                                  "use one process for contrastive training")
    device = _device(config.backend, config.process_id)
    multihost.initialize(config.coordinator, config.num_processes, config.process_id,
                         device)
    return device


def run_main(config, hparam, run) -> object:
    """`run(device)` in this process, inside the process group when there
    is one (left at the end)."""
    device = join_processes(config, hparam)
    try:
        return run(device)
    finally:
        if config.num_processes > 1:
            multihost.shutdown()


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
    if config.action == "tSNE":
        return action_tsne(hparam, device, config.ckpt)
    if config.action == "export_model":
        return export_model(load_eval_model(hparam, config.ckpt, device), hparam, config.ckpt)
    if config.action == "serve":
        return action_serve(hparam, device, config.ckpt, config.chunk_ms,
                            config.serve_slots, config.port, config.half, config.fused,
                            config.pcm16)
    return action_stream_eval(hparam, device, config.ckpt, config.chunk_ms, config.half)


def add_eval_args(parser) -> None:
    """The flags of dev / eval / stream_eval, as JAX's recipes name them."""
    parser.add_argument("--ckpt", type=str, default=None,
                        help="a checkpoint under TRAIN.model_save_dir (every action but train)")
    parser.add_argument("--metrics", type=str, default="simple",
                        choices=["simple", "detail"])
    parser.add_argument("--batch_eval", type=int, default=0,
                        help="dev / eval: bucketed batched inference at this batch size "
                             "(0: one utterance at a time)")
    parser.add_argument("--eval_quantum", type=float, default=1.0,
                        help="batch_eval: the length buckets' grid in seconds")
    parser.add_argument("--chunk_ms", type=float, default=16.0,
                        help="stream_eval chunk size in milliseconds")
    parser.add_argument("--half", action="store_true",
                        help="stream_eval / serve in bfloat16 (serving mode)")


def add_serve_args(parser) -> None:
    """The flags of serve, as JAX's recipes name them."""
    parser.add_argument("--serve_slots", type=int, default=64,
                        help="serve: fixed concurrent-session capacity")
    parser.add_argument("--port", type=int, default=7654,
                        help="serve: TCP port for the socket front-end")
    parser.add_argument("--pcm16", action="store_true",
                        help="serve: move each tick's audio host<->device as int16 PCM "
                             "(half the transfer bytes; the conversions on the card)")


def add_process_args(parser) -> None:
    """The multi-process flags, with JAX's defaults."""
    parser.add_argument("--coordinator", type=str, default="localhost:12345",
                        help="multi-process training: process 0's address host:port")
    parser.add_argument("--num_processes", type=int, default=1,
                        help="multi-process training: total process count (one "
                             "process per card; launch this CLI once per process)")
    parser.add_argument("--process_id", type=int, default=0,
                        help="multi-process training: this process's rank")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config_path", type=str)
    parser.add_argument("--action", type=str, default="train", choices=ACTIONS)
    parser.add_argument("--backend", type=str, default="cuda", choices=["cuda", "cpu"])
    add_process_args(parser)
    add_eval_args(parser)
    add_serve_args(parser)
    parser.add_argument("--fused", action="store_true",
                        help="serve: the SkiM stack through fused_skim_frames "
                             "(bf16 with --half)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
