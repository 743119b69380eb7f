"""puresound_tpu_torch — the PyTorch / CUDA port of puresound_tpu.

The JAX package `puresound_tpu` is the reference: every module here keeps
its counterpart's file name and math, and its tests hold the two against
each other on the CPU. This package imports `torch` and never `jax`.

What is ported (the serving and training slices of the flagship
`tse_skim_v0_causal`):
    zoo.tse.init_model                 — the flagship, random init from a Generator
    nnet                               — encoder, TCN speaker net, SkiM, the TSE wrapper
    nnet.loss.sdr                      — the SDR loss family (SI-SNR for the flagship)
    ops.skim_stream_kernel             — the fused SkiM streaming step (CUDA, sm_90a)
    ops.lstm_train_kernel              — the LSTM scan, forward and backward (CUDA, sm_90a)
    parallel                           — TrainState, adam, make_train_step
    streaming                          — StreamingTSE, SessionServer, make_session_server
    utils.from_jax                     — JAX variables -> this package's state_dict

Kernels build from `csrc/` with nvcc at first use on a CUDA tensor; a CPU
tensor takes each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

__all__ = ["dsp", "nnet", "ops", "parallel", "streaming", "utils", "zoo"]
