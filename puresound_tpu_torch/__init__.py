"""puresound_tpu_torch — the PyTorch / CUDA port of puresound_tpu.

The JAX package `puresound_tpu` is the reference: every module here keeps
its counterpart's file name and math, and its tests hold the two against
each other on the CPU. This package imports `torch` and never `jax`.

What is ported (the serving and training slices of the flagship
`tse_skim_v0_causal`, the recipes' trainers with the shipped GE2E config,
NS serving and training of `ns_dpcrn_v0_causal` / `ns_dparn_v0_causal`,
the recipes' evaluation actions, every shipped config with DSS's, and the
TCP serving front):
    zoo.tse.init_model, init_loss      — the flagship, random init from a Generator; every loss
    zoo.ns.init_model, init_loss       — the DPCRN / DPARN NS models; their losses
    nnet                               — encoders (FreeEncDec, ConvSTFT), TCN speaker net,
                                         SkiM, the Unet, DPCRN, DPARN and DPARN_Mout, the SIMO wrapper, the wrapper (tasks
                                         0-4) and TF masks, Dropout from the model's generator
    nnet.loss                          — SDR family, GE2E / Triplet / F1, AAM-softmax, STFT losses
    ops.skim_stream_kernel             — the fused SkiM streaming step (CUDA, sm_90a)
    ops.lstm_train_kernel              — the LSTM scan, forward and backward (CUDA, sm_90a)
    ops.tcn_train_kernel               — the TCN block, forward and backward (CUDA, sm_90a)
    ops.lstm_scan_kernel               — the serving LSTM scan (CUDA, sm_90a)
    ops.dual_path_kernel               — DPCRN's dual-path bottleneck (CUDA, sm_90a)
    ops.quant                          — the int8 serving quantizer and plain int8 products
    parallel                           — TrainState, adam, make_train_step
    src                                — AudioIO (FLAC through src.flac without the C++ host
                                         library), load_hparam, SpeakerSampler, src.metrics
                                         (PESQ via src.pesq_native, STOI, SDR, SI-SNR, F1)
    tasks                              — DataLoader, TseDataset, TseTask, NsDataset, NsTask,
                                         DssDataset, DssTask,
                                         eval-time checkpoint loading and model averaging,
                                         tasks.batch_eval.BucketedBatchRunner
    egs.tse.main, egs.ns.main,
    egs.dss.main                       — the recipes' command lines (--action train, dev, eval,
                                         stream_eval, serve); egs.tse.local.binarize (PVAD)
    streaming                          — StreamingTSE, StreamingNS, StreamingDSS, SessionServer,
                                         make_session_server, run_serve, socket_server (the TCP
                                         front and StreamingClient), file_eval.stream_signal
    utils.from_jax, utils.flax_ckpt    — JAX variables -> this package's state_dict; the JAX
                                         package's msgpack checkpoints read without flax

Kernels build from `csrc/` with nvcc at first use on a CUDA tensor; a CPU
tensor takes each kernel's plain PyTorch version.
"""

# registers the puresound_tpu_torch:: ops, which torch.export.load needs
from .ops import lstm_train_kernel as _lstm_ops, tcn_train_kernel as _tcn_ops  # noqa: E402,F401

__version__ = "0.1.0"

__all__ = ["dsp", "egs", "nnet", "ops", "parallel", "src", "streaming", "tasks",
           "utils", "zoo"]
