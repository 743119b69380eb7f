"""Chip smoke test of puresound_tpu_torch on one NVIDIA card.

Drives the port's serving and training paths for the flagship
`tse_skim_v0_causal` (also under the training LSTM path's two switches, and
its shipped GE2E recipe), the serving path of the flagship's configuration
with Gate fusion, the NS serving and training paths of
`ns_dpcrn_v0_causal` and `ns_dparn_v0_causal` (their shipped recipes too,
and the recipes' evaluation actions), and the remaining shipped recipes:
the Conv-TasNet TSE models `td_tse_conv_tasnet_v0{,_causal}`, the PVAD model
`tse_skim_v0_causal_vad`, the lookahead NS models `ns_{dpcrn,dparn}_v0`,
the rest of the time-domain TSE zoo (`tse_skim_v0`, `tse_skim_v{1,2}_causal`,
`veve_dprnn_v0_causal`), and DSS (`egs/dss/conf/dss_dparn_1a.yaml`: serving, the recipe, its
evaluation) with the recipes' TCP serving front, at full width (random
weights from a seed):

  0. device: torch / CUDA versions, the card's name and power limit;
  1. build: nvcc builds the seven CUDA sources from the checkout, in
     parallel, and prints each build's seconds and ptxas registers and spills,
     and the tensor-core instructions (HMMA: mma.sync, HGMMA: wgmma, IMMA:
     int8 mma.sync) from cuobjdump of the training LSTM kernels (every bf16
     kernel has some, every f32 one none), the TCN block's (its wgmma route's
     kernels have HGMMA, the CUDA-core ones none), `dparn_attention`,
     `masker` and `dual_path` (the attention's and the resident convs' wgmma
     routes have HGMMA, no kernel with float32 dots either; the dual-path
     passes' tensor-core kernels: both chains HMMA, their int8_hh builds IMMA
     too, the projection HGMMA; the CUDA-core passes none), and
     `skim_stream` (the three builds of the tensor-core kernel HMMA, its
     int8_hh / int8_full builds IMMA too, the CUDA-core kernel none), and
     `lstm_scan` (both builds of the tensor-core kernel HMMA, the CUDA-core
     kernel none);
  2. `fused_skim_frames` vs `fused_skim_frames_ref` on the card at the
     flagship shapes (f32 and bf16, 20 carried chunks), at a ragged batch and
     at a small shape, with CUDA-event timings of both; every launch on the
     route its plan names (bf16 at the flagship's widths: tensor cores; f32
     and the small shape: CUDA cores), two calls bit-equal, one call's device
     ms by kernel from a profiler window, and the bf16 plan's cluster size K
     and rows a tile M beside the clusters in flight; the flagship at 256
     streams too (the tile phases 4 and 4i serve: K=8, M=32), from a
     generator of its own;
  2i. the Gate mode of `fused_skim_frames` vs its plain version with every
     block a Gate at the flagship's width (Hg=128, B=1024 and 256), a ragged 1,001
     and the mixed pattern ("gate", "", "gate") at C=H=16, over 10 carried
     chunks (f32 max|d|/max|ref| <= 1e-4, bf16 SNR >= 30 dB), with
     CUDA-event times beside the FiLM kernel's from phase 2, routes, two
     calls bit-equal and the device ms as in phase 2;
  2b. `lstm_scan_train_fp` forward and backward vs their plain versions at
     the training shapes of phase 6 (SegLSTM 896 x 150, C=128, H=256;
     MemLSTM 64 x 14, C=H=256) and of the recipe (SegLSTM 240 x 150; MemLSTM
     12 x 20), a ragged 13 x 7 reverse case, NS training's scans at the vctk
     configs' B=16 x 3 s (intra BiLSTM 5,952 x 64 both directions, inter
     1,024 x 372, C=H=128) and the flagship's at the 1c recipe's B=48 (SegLSTM
     960 x 150, MemLSTM 48 x 20), f32 and bf16, with CUDA-event
     timings, the bounds from the shapes, and cuDNN's LSTM as the yardstick;
     two calls of each kernel bit-equal; at the SegLSTM shape the device ms
     of each kernel of one call from a profiler window (the backward's
     chain, weight gradient, dx and reduce);
  2j. `lstm_scan_train_tm` (the hoisted projection) forward and backward vs
     their plain versions at the SegLSTM shape (896 x 150, C=128, H=256)
     in both directions, the MemLSTM shape (64 x 14, C=H=256) and a ragged
     case, f32 and bf16 at 2b's bars, with the batch-major `lstm_scan_train`
     (its xp swap included) timed beside;
     `lstm_scan_train_fp_tm` against the batch-major launches bit for bit
     and against its plain version; the bounds and cuDNN's LSTM; two calls of
     each kernel bit-equal and, at SegLSTM, the device ms by kernel;
  2c. `tcn_block_train` forward and backward vs their plain versions at the
     speaker net's shapes in phase 6 (B=64, C=128, Ch=256, T=1,999) and in
     the recipe (B=12, T=4,999) and the 1c recipe's contrastive batch (B=48,
     T=4,999), dilations 1 and 16 each, and a ragged case,
     f32 and bf16, with CUDA-event timings, the bounds, and the stock module
     under autograd as the yardstick; the plan equal to the CUDA source's,
     the launches on the route it names (bf16 at the speaker / recipe
     shapes: wgmma; f32 and the ragged case: CUDA cores), two calls of each
     kernel bit-equal, and at the speaker shape the device ms by kernel of
     one forward and one backward; then the PReLU slope gradients of the
     speaker shape over 8 seeds of their own, each call within the cap of
     the exact reference and each dtype's median at most twice the plain
     version's distance;
  2d. `lstm_scan` vs its plain version at DPCRN's fused serving scans with
     2048 streams (intra 4,096 rows x 64 steps, forward and reverse; inter
     131,072 rows x 2 steps with carries), DPARN's inter scan at 1024
     streams (65,536 x 2), a bf16 xp / weights case with f32 h0 / c0 (its f32
     hT / cT held within 1e-4 of max|ref|: the dots stayed f32), two ragged
     1,001-row cases at H = 128 (a 9-row last tile; reverse with bf16 dots,
     the one-piece build, and forward with f32 dots) and a ragged reverse
     case at H = 24, f32 and bf16 xp / weights / state with f32 dots (bf16
     dots where the case says): launches by route (`LAUNCHES_BY_ROUTE`:
     every bf16 case at H = 128 on the tensor cores, `tc`; f32 and H = 24 on
     `cuda`), two calls bit-equal, f32 within 1e-4 of max|ref|, bf16 SNR >=
     40 dB, one call's device ms (CUDA events), the bound on the route's rule
     (`tc`: three bf16 products a multiply-add, one under bf16 dots, at 989
     TFLOP/s; `cuda`: one f32 FMA at 67) and cuDNN's LSTM forward (C=128) as
     the yardstick;
  2e. `dual_path_chunk` vs its plain version at 2048 streams, a ragged 1,001
     and a small shape, f32 and bf16, over 10 carried chunks (y and the
     four carries), with CUDA-event times of one chunk and the bound; two
     calls bit-equal; the passes launched by route (`LAUNCHES_BY_PASS`: the
     model geometry's bf16 chunk on the tensor cores, A / C `mma`, B
     `wgmma`; f32 on the CUDA cores) and one chunk's device ms by pass
     (intra scans, intra projection, inter) from a profiler window;
  2f. `dparn_intra_pass` vs its plain version at R = 4,096 rows (2048
     streams x K = 2) of 64 tokens x 128, a ragged R = 2,002 and a small F =
     8, C = 16 case, f32 (max|d|/max|ref| <= 1e-4) and bf16 (SNR >= 30 dB),
     with CUDA-event times, the bound and stock modules (nn.TransformerEncoder
     + Linear + LayerNorm) as the yardstick; two calls bit-equal, the
     launches by the plan's path (wgmma for the bf16 model geometry);
  2g. `center_chunk` at 2048 streams and `dparn_center_chunk` at 1024 (and
     at a ragged 3 streams), the zoo maskers' weights, vs their plain
     versions over 10 carried chunks (y
     and the 11 carries; the bars of 2f), with the time of one chunk, the
     bound and the port's route for the same layers (cuDNN convs + the
     bottleneck kernels) as the yardstick; two calls bit-equal, the launches
     by path and the dual-path passes by route, and one call's device ms by
     pass (convs, attention, intra scans, intra projection, inter, copies)
     from a profiler window;
  2h. the card's __dp4a rate (a loop in skim_stream.cu, CUDA events), the
     int8 products' peak; then the int8 and bf16-scratch variants at full
     width, each against its own plain version over 5 carried chunks:
     `fused_skim_frames` int8_hh / int8_full (n=4, C=128, H=256, F=15,
     B=1024), `dual_path_chunk` int8_hh / xscr_half / both (2048 streams),
     `center_chunk` int8_hh / xscr_half (2048), `dparn_center_chunk`
     xscr_half (1024), and the Gate mode's int8_hh / int8_full (B=1024). f32 I/O: each variant's own SNR bar (Q_F32_BARS), and
     the kernel without the option (the control) must read below it; under
     xscr_half dual_path_chunk's y and the centers' u0h carry-out must lie
     on the bfloat16 grid and the control's must not. bf16 I/O: SNR >= 30
     dB. CUDA-event times beside the same kernel's f32 / bf16 times from 2,
     2e, 2g, the bound (int8 at the measured dp4a rate on the CUDA cores; the
     dual-path passes' bf16 int8 products at the dense int8 tensor-core rate,
     1,979 T op/s) and the share of it;
  3. flagship: 6,375,440 parameters; `StreamingTSE.embed` launches the TCN
     kernel 5 times; 20 streamed ticks through `StreamingTSE.step(fused=True)`
     (f32: every launch on the CUDA cores; phases 4, 4e, 4f and 4i serve in
     bf16, every launch on the tensor cores, and 3g in f32 on the CUDA cores)
     equal the offline `inference`, which launches the LSTM kernel 10 times
     (4 SegLSTM + 6 MemLSTM scans) and the TCN kernel 5 times;
  4. serving: `make_session_server(half=True, fused=True)` with 256 sessions
     (each attach embeds: 5 TCN launches, all on its bf16 wgmma route), 25
     ticks, every output finite,
     every step through the kernel;
  4e. the flagship in bf16 through `StreamingTSE.step(fused=True, int8_hh /
     int8_full)` at 1024 streams: the engine step alone, then
     `make_session_server(half=True, fused=True)` with its step_fn bound to
     the option (25 ticks after 3 warm-up; every launch with the option, no
     plain version, slot 0 against the f32 engine: bars 20 / 15 dB);
  4f. `make_session_server(half=True, fused=True)` at 256 sessions with the
     float32 transport, `pcm16=True` and `pipelined=True, pcm16=True`: the
     pipelined outputs bit-equal to the unpipelined ones, the pcm16 SNR, the
     three tick p50 / p99 beside phase 4's, and each one's whole timed window
     (pushes, ticks, pops, a final device sync) per tick;
  3g. the Gate model (the flagship's configuration with Gate fusion,
     6,409,240 parameters) in f32: 4 streams x 20 ticks through
     `StreamingTSE.step(fused=True)` (one Gate-mode launch a tick) and
     `step(fused=False)`, each equal to the offline `inference`;
  4i. its serving, `make_session_server(half=True, fused=True)` at 256 and
     1024 sessions (25 ticks after 3 warm-up, one launch a tick, the engine
     step alone, bf16 slot 0 against the f32 engine, bar 25 dB), and at
     1024 with `int8_hh` / `int8_full` (JAX's bars 20 / 15 dB);
  3b. NS: `ns_dpcrn_v0_causal` in f32 (1,380,043 parameters), 4 streams x
     2 s at 16 ms ticks through the stock, fused, dp_kernel and mk_kernel
     routes of `StreamingNS.step`, each equal to the offline `inference` past
     n_fft samples; exact launches: 6 `lstm_scan_train_fp` per inference and
     per stock tick, 6 `lstm_scan` per fused tick, 1 `dual_path_chunk` per
     dp_kernel tick, 1 `center_chunk` per mk_kernel tick;
  4b. NS serving: `make_session_server(half=True, dp_kernel=True)` at 256
     and 2048 sessions attached without enrollment, 25 ticks after 3
     warm-up, one `dual_path_chunk` per tick, every output finite, 0
     underruns; the dual-path passes by route (`mma` / `wgmma`, 2 a tick
     each; 4d, 4g and 4h likewise); tick p50/p99, the engine step alone, and
     bf16 slot 0 against the f32 engine (bar 35 dB);
  4d. the same through `mk_kernel=True` (one `center_chunk` per tick, bar 25
     dB), printed beside 4b's numbers;
  4j. the same through `fused=True` at 2048 sessions (6 `lstm_scan` per tick,
     every one on the tensor cores, bar 35 dB);
  4g. DPCRN at 2048 sessions through `make_session_server(half=True)` with
     its step_fn bound to the option: `dp_kernel` + int8_hh, `mk_kernel` +
     int8_hh, `dp_kernel` + xscr_half, `mk_kernel` + xscr_half and
     `dp_kernel` + both (bars 20, 30, 35, 35, 20 dB against the f32 engine;
     launches by option, no plain version);
  3c. DPARN: `ns_dparn_v0_causal` in f32 (1,215,179 parameters), 4 streams x
     2 s through the stock, fused, attn_kernel, fused + attn_kernel and
     mk_kernel routes, each equal to the offline `inference`; exact
     launches: 2 `lstm_scan_train_fp` per inference and stock tick, 2
     `lstm_scan` per fused tick, 2 `dparn_intra_pass` per attn_kernel tick,
     1 `dparn_center_chunk` per mk_kernel tick;
  4c. DPARN serving: `make_session_server(half=True, fused=True,
     attn_kernel=True)` at 256 and 1024 sessions: 25 ticks after 3 warm-up,
     2 `dparn_intra_pass` and 2 `lstm_scan` per tick, every attention launch
     on the wgmma path and every scan on the tensor cores, 0 underruns, bf16
     slot 0 against the f32 engine (bar 25 dB);
  4h. DPARN at 1024 sessions on `mk_kernel` + xscr_half, as 4g (bar 25 dB),
     every launch on the wgmma attention and resident convs;
  5. one f32 training step (B=2 x 1 s) on the card against the same step on
     the CPU in f64 (and the CPU's f32 step beside it): loss, grad_norm,
     every gradient and updated parameter;
  6. full-width training, B=64 x 2 s, Adam 1e-3, grad clip 10, in f32 and
     with bf16 compute: 2 warm-up and 5 timed steps, 10 + 10 LSTM and 5 + 5
     TCN launches per step, step time, peak memory and the LSTM and TCN
     kernels' shares of device time over 2 profiled steps;
  6c. the same step under `FUSED_PROJ_SCAN=False`, `TM_BLOCKS=True` and
     both (module attributes, restored after), f32 and bf16: loss and
     gradients against the default route from the same weights and batch
     (f32: every leaf within 1e-4 under TM_BLOCKS alone, the same
     arithmetic; 1e-2, and 3e-2 on the scalar PReLU slopes, on the hoisted
     routes), the LSTM launches by entry in every step, step p50 and peak
     memory; then the step's forward and backward twice from one state, f32
     and bf16, with cuDNN free and held to its deterministic algorithms:
     the first module output and the gradients that differ between calls;
  6b. the recipe: `python -m puresound_tpu_torch.egs.tse.main <config>
     --action train` (in this process) on a synthetic manifest folder, the
     flagship at B=12 x 3 s with 5 s enrollments and 4 loader workers, 1
     epoch of 12 steps + 1 dev batch: finite losses, exact launch counts,
     the step p50 over steps 2-11 and the host's gap between steps, and
     `epoch_0.ckpt` reloads into a fresh model;
  6d. NS training at full width: `ns_dpcrn_v0_causal` and `ns_dparn_v0_causal`
     at the vctk configs' B=16 x 3 s (stft_ov, Adam 1e-4 with weight decay
     1e-5, clip 10, dropout 0.1 drawn on the card from the model's
     generator), f32 and bf16 compute: step p50, audio-s/s, peak memory, the
     LSTM kernels' share of device time; 6 + 6 (DPCRN) or 2 + 2 (DPARN)
     `lstm_scan_train_fp` launches a step, no TCN and no serving kernel
     (`fused_skim_frames`, `lstm_scan`, `dual_path_chunk`, `dparn_intra_pass`,
     the centers); then one f32 step (B=2 x 0.5 s, dropout 0) on the card
     against the CPU's f64 step, the CPU's f32 step beside;
  6e. the flagship's shipped recipe: `python -m puresound_tpu_torch.egs.tse.main
     egs/tse/conf/libri2mix_max_2spk_clean_16k_1c.yaml --action train`, read
     from the file with only the data paths, output directories, epochs,
     workers and seed overridden, on a synthetic manifest of 12 speakers x 8
     utterances: GE2E on SpeakerSampler's batches of 12 x 4 (B=48 x 3 s, 5 s
     enrollments), 6 steps + 3 dev batches: finite losses, GE2E's w / b moved,
     exact launches, no serving kernel, step p50 and host gap as 6b, and
     `epoch_0.ckpt` (loss_func_spk.* included) reloads equal;
  6f. the NS recipes: `python -m puresound_tpu_torch.egs.ns.main
     egs/ns/conf/vctk_{dpcrn,dparn}_1a.yaml --action train`, the same
     overrides, on a synthetic wav2scp / wav2ref manifest: 4 steps of B=16 x 3
     s + 1 dev batch, the same checks;
  7. the recipes' evaluation actions through their CLIs (run in-process with
     `runpy`), on the checkpoints 6e / 6f kept (epoch_0.ckpt and an
     epoch_1.ckpt their trainers' `save_ckpt` wrote after a seeded 1 %
     move), TRAIN.model_average 2, for `..._1c.yaml` and
     `vctk_{dpcrn,dparn}_1a.yaml` read from their files, on a synthetic
     Kaldi-style set of 8 mixtures of 4 s (3 s enrollments for TSE): `--action
     dev --metrics detail` (every printed row finite and equal to `Metrics`
     of the outputs; model, Metrics and loading seconds), `eval` (RTF at B=1),
     `eval --batch_eval 4 --eval_quantum 0.75` (RTF; >= 60 dB from B=1
     before the zero-padded tail's last window), `eval --backend cpu` on
     the first mixture (the card's f32 wavs >= 60 dB from the CPU's),
     `stream_eval` on every route (NS: the first mixture, stock and
     DPCRN `--dp_kernel` / `--mk_kernel`, DPARN `--fused --attn_kernel` /
     `--mk_kernel`; TSE: one 1 s mixture, its unfused step as JAX's) >= 60
     dB from the offline inference of the zero-primed input (the engines'
     contract), and `--half` at the serving bars (35 dB flagship and
     DPCRN, 25 dB DPARN); every model tensor on the card; exact launches
     (dev / eval: the forward training kernels, no backward, no serving
     kernel; each stream route its own: the flagship's unfused step runs
     its SegLSTMs a frame at a time through `lstm_scan_train_fp`);
  2k. the kernels at the remaining recipes' shapes against their plain
     versions, each case from a generator of its own: `tcn_block_train`
     forward / backward at C=512, Ch=256, B=12 x T=2,999, d = 1, 16, 128
     (the Conv-TasNet masker's blocks; CUDA cores at both dtypes) with
     phase 2c's bars and the stock module beside; `fused_skim_frames` at the
     PVAD widths (n=2, C=128, H=64, FiLM) at B=256 and 1,024 over 20 carried
     chunks (f32 max|d|/max|ref| <= 1e-4, bf16 SNR >= 30 dB; bf16 on the
     tensor cores, `mma` K=2 M=16; f32 on the CUDA cores); `lstm_scan_train_fp`
     at the PVAD recipe's SegLSTM (240 x 150, C=128, H=64) and MemLSTM (12 x
     20, C=H=64) with phase 2b's bars and cuDNN beside;
  4k. `tse_skim_v0_causal_vad` (1,133,200 parameters, a Sigmoid output)
     through `make_session_server(half=True, fused=True)` at 256 sessions:
     100 ticks after 3 warm-up, every launch on `mma`, no plain version,
     tick p50 / p99, bf16 slot 0 against the f32 engine (30 dB); then
     `td_tse_conv_tasnet_v0_causal` in f32 through `make_session_server` on
     its unfused step (fused=True must raise) at 8 sessions: 5 TCN launches
     an attach, every slot's stream >= 60 dB from the offline inference of
     its zero-primed input;
  6g. the shipped `libri2mix_max_2spk_clean_16k_{1a,1b}.yaml` (Conv-TasNet,
     SI-SNR + 10 x AAM-softmax on spk_label, 251 classes) and
     `libri2mix-pvad_max_2spk_clean_16k_1a.yaml` (PVAD, F1 on frame labels,
     single-speaker / inactive draws at 0.1) through the TSE CLI, read from
     their files with paths, epochs, workers and seed overridden, on
     synthetic manifests (frame labels as ref2vad for PVAD): 3 steps of B=12
     x 3 s + 1 dev batch, finite losses, exact launches by kernel (v0: 21
     masker blocks + 5 speaker blocks on `tcn_block_train` a forward; the
     causal model's BatchNorm masker on the stock path, its 5 speaker blocks
     on the kernel; PVAD 4 LSTM + 5 TCN), AAM-softmax's weight moved,
     `epoch_0.ckpt` reloading equal, step p50, host gap, peak memory; then
     one f32 step of each model (B=2 x 0.5 s) on the card against the CPU's
     f64 step, the CPU's f32 beside;
  6h. `vctk_{dpcrn,dparn}_1b.yaml` (the lookahead `ns_{dpcrn,dparn}_v0`)
     through the NS CLI, with 6f's checks;
  7b. the evaluation actions of the five configs on 6g / 6h's checkpoints
     (model_average 2), 4 mixtures of 4 s: `dev --metrics detail` (PVAD:
     accuracy / precision / recall / F1 equal to `Metrics.f1_score` of the
     binarised outputs against the frame labels; the others Metrics of the
     outputs), `eval`, `eval --backend cpu` (the card's f32 outputs >= 60 dB
     from the CPU's), `stream_eval` (the causal Conv-TasNet and PVAD on the
     unfused step; the `_1b` models on stock, `--fused`, `--dp_kernel`
     (DPCRN), `--fused --attn_kernel` (DPARN)) >= 60 dB from the offline
     inference of the zero-primed input; the non-causal v0's `stream_eval`
     and `--mk_kernel` on a `_1b` model raise;
  4l. DSS, `dss_dparn_mout_v0` (ConvEncDec 512 / 512 / 128 + DPARN_Mout,
     M = 2 sources, 1,216,461 parameters): `make_session_server(half=True,
     mk_kernel=True)` at 1,024 slots and `(half=True, fused=True,
     attn_kernel=True)` at 256, 100 ticks after 3 warm-up (1
     `dparn_center_chunk` a tick on `attn=wgmma,conv=resident`, its passes 2
     `C:mma`; or 2 `dparn_intra_pass` on `wgmma` and 2 `lstm_scan` on `tc`),
     every slot's row de-interleaved into its two sources, bf16 slot 0 >=
     25 dB from the f32 engine per source, tick p50 / p99 and the engine
     step; an f32 stock server at 8 slots (2 `lstm_scan_train_fp` a tick)
     whose every slot's two sources are >= 60 dB from the offline inference
     of its zero-primed input; then `run_serve` on 127.0.0.1, port 0,
     through its on_started / stop_event hooks, for the flagship (bf16,
     fused, 15 ms ticks, each client's HELLO a 3 s enrollment embedded on
     the card), `ns_dpcrn_v0_causal` and DSS (f32, `mk_kernel`): 8
     concurrent StreamingClients of 2 s and 100 samples each, in lockstep;
     each client holds exactly (sent // chunk) * chunk samples a source and
     is >= 60 dB from the engine stepped outside the server (its step
     function at the server's batch); the f32 models serve a second round
     under `cudnn.deterministic`, where every client must equal the engine
     bit for bit (with cuDNN's default algorithms the Unet's up-convolution
     makes two calls of the f32 step differ, about 147 dB); exact launches;
     tick p50 / p99 and underruns from ServeStats (each round's; the default
     algorithms' are the served path's);
  6i. the shipped `egs/dss/conf/dss_dparn_1a.yaml` through
     `python -m puresound_tpu_torch.egs.dss.main --action train` (paths,
     epochs, workers and seed overridden) on a synthetic manifest with
     silent near and far references: 3 steps of B=8 x 3 s + 1 dev batch on
     `sasisnr`, exact launches (2 inter LSTMs a forward), `epoch_0.ckpt`
     reloading equal, step p50, host gap, peak memory; then one f32 step
     (B=2 x 0.5 s, one inactive far side, dropout 0) on the card against the
     CPU's f64 step, the CPU's f32 beside (loss, grad_norm and the whole
     gradient gated as 6g);
  7c. the DSS CLI's evaluation on 6i's checkpoints (model_average 2), 4
     mixtures of 4 s: `dev` (every printed SI-SNR, near and far, equal to
     `Metrics.sisnr` of the outputs), `eval`, `eval --batch_eval 2` (>= 60
     dB from B=1), `eval --backend cpu` (the card's f32 wavs >= 60 dB from
     the CPU's), `stream_eval` on the stock, `--fused` and `--mk_kernel`
     routes (each source >= 60 dB from the offline inference of the
     zero-primed input) and `--half` (>= 25 dB); exact launches;
     `export_model` writes the five artifacts of a SIMO model, and its
     loaded FullModel equals the eager inference (within 1e-5 of max|ref|,
     the same launches);
  6j. the rest of the trainer. Synthetic corpora from the seed (8 coloured
     noises of 2-6 s, 8 RIRs of 0.3 s). The host chain: vctk_dpcrn_1a.yaml
     (noise, RIR early, volume, speed, frequency response), the Conv-TasNet
     TSE `_1a` (the same, enroll_augment, inactive_training 0.2) and
     dss_dparn_1a.yaml (noise, speed, volume) through their CLIs, each
     beside the same config with augmentation off: 3 steps + 1 dev batch,
     finite losses, exact launches, step p50, host gap and the loader's share
     of it. The device chain: NS and TSE `_1a` with augment_on_device (step
     p50, host gap), and one batch's draws from the task's generator applied
     on the card and on the CPU in float64 (<= 1e-5 of max|ref|). Remat:
     the flagship's B=64 x 2 s step and the causal Conv-TasNet's B=12 x 3 s
     step (BatchNorm, dropout 0.1 in its masker) under remat False / True /
     "dots" (the blocks recomputed one at a time), cuDNN deterministic:
     gradients and new BatchNorm statistics bit-equal to remat=False, the
     forward kernels twice a step under recomputation, step p50 and peak
     memory a mode (True's below False's).
     Resume: vctk_dpcrn_1a for 2 epochs straight == 1 epoch then resumed from
     epoch_0.ckpt (parameters, Adam moments and steps, scheduler, logged
     losses bit-equal). Data parallelism: `multihost.initialize` joins a NCCL
     group of one process, and the data-parallel NS step equals the plain
     one bit for bit over 2 steps (a two-process run needs two cards: a line
     says it was not run);
  2l. the time-domain rest of the TSE zoo (`tse_skim_v0`, `tse_skim_v1_causal`,
     `tse_skim_v2_causal`, `veve_dprnn_v0_causal`): `lstm_scan_train_fp`
     forward and backward vs plain at v0's SegLSTM 240 x 150 reverse (C=128,
     H=256), its MemLSTM 12 x 20 at C=512 both ways, v1's speaker BiLSTM
     12 x 4,999 (H=192: 24 units a CTA; its plain version timed by the
     check's one call), DPRNN's intra 1,800 x 20 and inter
     240 x 150 (H=64) and its streaming inter step 5,120 x 1, and
     `tcn_block_train` at v2's speaker net (B=12, C=80, T=622, d=1 and 16,
     the CUDA cores), f32 and bf16 at phase 2b / 2c's bars, two calls
     bit-equal, CUDA-event times, the bounds, cuDNN's LSTM (its forward
     direction for a reverse scan) or the stock TCN module beside;
  4m. v1 and v2 through `make_session_server(half=True, fused=True)` at 256
     sessions attached by 1 s enrollments (embedded on the card), 100 ticks
     of 15 ms after warm-up: every `fused_skim_frames` launch on the tensor
     cores, the MemLSTM scans at segment ends, tick p50 / p99, the engine
     step alone, slot 0 >= 35 dB from the f32 engine; each also as an f32
     unfused server at 8 sessions (every slot >= 60 dB from the offline
     inference of its zero-primed input); veve as a fixed cohort of 256
     streams through `StreamingServer` (20 ms chunks, states from
     `init_state(enroll_feats=)`; every stream >= 60 dB from offline); exact
     launches throughout;
  6k. the four through `python -m puresound_tpu_torch.egs.tse.main --action
     train` on a copy of `..._1a.yaml` with MODEL.type swapped (B=12 x 3 s, 5
     s enrollments, 3 steps + 1 dev batch: finite losses, exact launches,
     step p50, host gap, peak memory, epoch_0.ckpt reloading equal), and one
     f32 step each (B=2 x 0.5 s, dropout 0, SpecAugment's draws fixed) on the
     card against the CPU's f64 step, gated as 6g;
  7d. their `dev`, `eval` and `eval --batch_eval 2` (>= 60 dB from B=1) on
     6k's checkpoints, `stream_eval --chunk_ms 15` for v1 / v2 (>= 60 dB
     from offline, exact launches); v0 and veve refuse to stream;
  4n. the STFT-domain TSE zoo (`tse_unet_tcn_v0`, `_v0_causal`, `_v1`;
     UnetTcn with GatedTCN blocks, which launch none of the port's
     kernels): `tse_unet_tcn_v0_causal` through `make_session_server(half=
     True)` at 256 sessions attached by 1 s enrollments, 16 ms ticks (2 hop
     frames), 100 ticks after warm-up: tick p50 / p99, the engine step
     alone, 8 slots >= 35 dB from the f32 engine; the f32 server at 8
     sessions (every slot >= 60 dB from the offline inference of its
     zero-primed input, 1,152 samples behind); no kernel and no plain
     version launched;
  6l. the three through the TSE CLI's train on `..._1a.yaml` with
     MODEL.type swapped (as 6k), and one f32 step each on the card against
     the CPU's f64 step (dropout 0), gated as 6g;
  7e. their `dev` / `eval` on 6l's checkpoints (RTF), `stream_eval` at 16
     ms for the causal one (>= 60 dB from offline); v0 / v1 refuse to
     stream with a ValueError;
  7f. the recipes' last actions (`export_phase`): the flagship (f32,
     seed SEED) through the TSE CLI's `export_model` (`torch.export`, the
     LSTM and TCN forwards as `puresound_tpu_torch::` ops): export / save
     seconds an artifact; each artifact loaded with `torch.export.load`,
     its graph naming the ops; FullModel, SpeakerNet, MaskNet, EncoderNet,
     decoderNet on seeded card inputs and StreamStep over 40 chunks of 64
     samples (across a 150-frame segment boundary: its `cond` branch)
     within 1e-5 of max|ref| of the eager module (bit-equality printed)
     with the same LSTM / TCN launches; eager and artifact ms (CUDA
     events); `ns_dpcrn_v0_causal` through the NS CLI's `export_model`, its
     FullModel the same way; the op's dispatch cost (the unfused B=1
     streaming step, op against its body called directly, in turns);
     tSNE's d-vectors on 6 mixtures of 2 speakers, card against CPU (each
     within cosine 0.9999), and `--action tSNE` through the CLI on the card
     (where scikit-learn or matplotlib is missing, it raises
     ModuleNotFoundError after embedding the set, as JAX's would);
     `probe_lookahead_receptive` of the flagship, card == CPU;
  (phase 8, `periphery_phase`: 8a-8f, the multi-device and demo periphery;)
  9a. `SkiM.step_chunk` (`step_chunk_phase`): the flagship on 64 streams x
     23 segments of 150 frames, f32 and bf16, against the f32 `step_frames`
     stream and the offline inference of the zero-primed input (f32 within
     1e-4 of max|ref|, bf16 >= 30 dB), two streams bit-equal, a stream
     taking turns between the two steps; exact `lstm_scan_train_fp`
     launches (a segment: 4 SegLSTM scans of B x 150 steps + 6 MemLSTM
     one-step scans through `step_chunk`, 606 through `step_frames`); a
     segment's wall ms through each at B = 64 (the f32 streams' segments)
     and B = 1; the kernel alone at 64 x 150 without a gradient against its
     plain version, its bound and cuDNN's forward;
  9b. `FFC` / `SpectralTransform` / `LayerNorm2D` (`ffc_phase`) at N, CH,
     F, T = 8, 64, 257, 300 with JAX-layout variables through `from_jax`, in
     eval and training mode: card f32 vs the card's f64 (1e-4), that f64 vs
     the CPU's on one sample (1e-9), bf16 >= 30 dB, the causal FFC's
     causality;
  8. the kernels JSON line (phase 7's launches in `launches_7`, the new
     phases' in `launches_4k` / `_6g` / `_6h` / `_7b` / `_4l` / `_6i` /
     `_7c` / `_6j` / `_2l` / `_4m` / `_6k` / `_7d` / `_4n` / `_6l` / `_7e` /
     `_7f` / `_8` / `_9`, the new shapes' times and bounds in `new_shapes`
     (9a's segment shape under "9a step_chunk segment"); the LSTM forward's
     op dispatch cost in `op_dispatch_us`).

Each phase prints one line with its result and time; any failure raises and
the run exits non-zero. The last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Run from the repo root: `python3 chip_smoke.py` (needs one CUDA card).
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from puresound_tpu_torch.utils import roofline

SEED = 1234
REPLACES = "puresound_tpu/ops/skim_stream_kernel.py:270"
SOURCE = "puresound_tpu_torch/csrc/skim_stream.cu"
LSTM_REPLACES = ("puresound_tpu/ops/lstm_train_kernel.py:533",
                 "puresound_tpu/ops/lstm_train_kernel.py:590")
LSTM_SOURCE = "puresound_tpu_torch/csrc/lstm_train.cu"
TCN_REPLACES = ("puresound_tpu/ops/tcn_train_kernel.py:353",
                "puresound_tpu/ops/tcn_train_kernel.py:383")
TCN_SOURCE = "puresound_tpu_torch/csrc/tcn_train.cu"
# phase 2: (name, blocks, C, H, streams, frames, fusion modes)
SKIM_CASES = [("flagship B=1024", 4, 128, 256, 1024, 15, ("film",) * 4),
              ("ragged B=1001", 4, 128, 256, 1001, 15, ("film",) * 4),
              ("small C=16 H=16 B=13", 3, 16, 16, 13, 4, ("film", "", "film")),
              ("flagship B=256", 4, 128, 256, 256, 15, ("film",) * 4)]
# phase 2i: the Gate mode, the same columns; 10 carried chunks at the bars of
# phases 2e-2g (f32 max|d|/max|ref| 1e-4, bf16 SNR 30 dB)
GATE_HG = 128                       # the Gate width of a Gate SkiM (JAX skim.py:192-194)
GATE_CASES = [("gate flagship B=1024", 4, 128, 256, 1024, 15, ("gate",) * 4),
              ("gate ragged B=1001", 4, 128, 256, 1001, 15, ("gate",) * 4),
              ("gate mixed C=16 H=16 B=13", 3, 16, 16, 13, 4, ("gate", "", "gate")),
              ("gate flagship B=256", 4, 128, 256, 256, 15, ("gate",) * 4)]
# the 256-stream cases (the tile of phases 4 and 4i: clusters of 8, 32 rows
# a tile) draw from generators of their own, so the other cases' data stay
# as they were
SERVE_SEEDS = {"flagship B=256": SEED + 2, "gate flagship B=256": SEED + 3}
GATE_CHUNKS, GATE_BARS = 10, (1e-4, 30.0)
# phase 2j: lstm_scan_train(_tm) and lstm_scan_train_fp_tm at the SegLSTM
# shapes of phase 6, both directions, and its MemLSTM shape (the hoisted
# scans of phase 6c): (name, rows, T, C, H, reverse, reps)
UNFUSED_CASES = [("SegLSTM", 896, 150, 128, 256, False, 10),
                 ("SegLSTM reverse", 896, 150, 128, 256, True, 10),
                 ("MemLSTM", 64, 14, 256, 256, False, 20),
                 ("ragged", 13, 7, 24, 16, True, 5)]
UNFUSED_REPLACES = ("puresound_tpu/ops/lstm_train_kernel.py:177",
                    "puresound_tpu/ops/lstm_train_kernel.py:224")
FP_TM_ENTRY = "puresound_tpu/ops/lstm_train_kernel.py:708"
# phase 2b: (name, rows, T, C, H, reverse, timed repetitions)
LSTM_CASES = [("SegLSTM", 896, 150, 128, 256, False, 20),
              ("MemLSTM", 64, 14, 256, 256, False, 20),
              ("recipe SegLSTM", 240, 150, 128, 256, False, 20),
              ("recipe MemLSTM", 12, 20, 256, 256, False, 20),
              ("ragged", 13, 7, 24, 16, True, 20),
              ("NS intra", 5952, 64, 128, 128, False, 10),
              ("NS intra reverse", 5952, 64, 128, 128, True, 10),
              ("NS inter", 1024, 372, 128, 128, False, 10),
              ("1c SegLSTM", 960, 150, 128, 256, False, 10),
              ("1c MemLSTM", 48, 20, 256, 256, False, 10)]
# the NS training scans at the vctk configs' B=16 x 3 s (intra: 16 x 372
# frames of F=64 bins, both directions; inter: 16 x 64 bins of 372 frames;
# C = H = 128) and the flagship's at the 1c recipe's B=48 x 3 s, from
# generators of their own, so the other cases' data stay as they were
LSTM_SEEDS = {"NS intra": SEED + 31, "NS intra reverse": SEED + 32, "NS inter": SEED + 33,
              "1c SegLSTM": SEED + 34, "1c MemLSTM": SEED + 35}
# phase 2c: (name, B, C, Ch, T, dilation, timed repetitions)
TCN_CASES = [("speaker d=1", 64, 128, 256, 1999, 1, 10),
             ("speaker d=16", 64, 128, 256, 1999, 16, 10),
             ("recipe d=1", 12, 128, 256, 4999, 1, 10),
             ("recipe d=16", 12, 128, 256, 4999, 16, 10),
             ("ragged", 5, 20, 36, 13, 16, 10),
             ("1c recipe d=1", 48, 128, 256, 4999, 1, 5),
             ("1c recipe d=16", 48, 128, 256, 4999, 16, 5)]
# the speaker net at the 1c recipe's contrastive batch (12 speakers x 4
# utterances, 5 s enrollments), from generators of their own
TCN_SEEDS = {"1c recipe d=1": SEED + 36, "1c recipe d=16": SEED + 37}
LSCAN_REPLACES = "puresound_tpu/ops/lstm_scan_kernel.py:109"
LSCAN_SOURCE = "puresound_tpu_torch/csrc/lstm_scan.cu"
DP_REPLACES = "puresound_tpu/ops/dual_path_kernel.py:433"
DP_SOURCE = "puresound_tpu_torch/csrc/dual_path.cu"
# phase 2d: (name, rows, T, H, reverse, carries, the bf16 run's dot dtype,
# its state dtype, timed repetitions), the DPCRN serving scans at 2048
# streams (bf16 xp, weights and state with f32 dots, as the fused route runs
# them), DPARN's inter scan at 1024, bf16 xp / weights with f32 state (hT /
# cT in f32, held to the f32 bar: the proof that the dots stayed f32), two
# ragged row counts at H = 128 (1,001 rows: the last 16-row tile holds 9;
# bf16 and f32 dots) and a ragged case at H = 24 with bf16 dots; the bf16
# runs at H = 128 take the tensor cores, the rest the CUDA cores
LSCAN_CASES = [("intra", 4096, 64, 128, False, False, torch.float32, torch.bfloat16, 20),
               ("intra reverse", 4096, 64, 128, True, False, torch.float32, torch.bfloat16, 20),
               ("inter", 131072, 2, 128, False, True, torch.float32, torch.bfloat16, 20),
               ("DPARN inter", 65536, 2, 128, False, True, torch.float32, torch.bfloat16, 20),
               ("f32 state", 4096, 16, 128, True, True, torch.float32, torch.float32, 10),
               ("ragged reverse", 13, 7, 24, True, True, torch.bfloat16, torch.bfloat16, 20),
               ("ragged tc", 1001, 7, 128, True, True, torch.bfloat16, torch.bfloat16, 10),
               ("ragged tc f32 dots", 1001, 7, 128, False, True, torch.float32,
                torch.bfloat16, 10)]
# the cases added with the tensor-core route draw from generators of their own,
# so the other cases' data stay as they were
LSCAN_SEEDS = {"DPARN inter": SEED + 21, "f32 state": SEED + 22, "ragged tc": SEED + 23,
               "ragged tc f32 dots": SEED + 24}
# phase 2e: (name, streams, F, K, CH, H, timed repetitions)
DP_CASES = [("2048 streams", 2048, 64, 2, 128, 128, 10),
            ("ragged B=1001", 1001, 64, 2, 128, 128, 5),
            ("small B=3", 3, 6, 2, 16, 8, 5)]
DP_CHUNKS = 10                      # carried chunks held against the plain version
DPARN_REPLACES = "puresound_tpu/ops/dparn_attention_kernel.py:252"
DPARN_SOURCE = "puresound_tpu_torch/csrc/dparn_attention.cu"
CENTER_REPLACES = {"center_chunk": "puresound_tpu/ops/masker_kernel.py:468",
                   "dparn_center_chunk": "puresound_tpu/ops/masker_kernel.py:468"}
CENTER_ENTRY = {"center_chunk": "puresound_tpu/ops/masker_kernel.py:489",
                "dparn_center_chunk": "puresound_tpu/ops/masker_kernel.py:536"}
CENTER_SOURCE = "puresound_tpu_torch/csrc/masker.cu"
# phase 2f: (name, rows, F, C, heads, feed-forward width, timed repetitions)
ATTN_CASES = [("2048 streams", 4096, 64, 128, 8, 128, 10),
              ("ragged R=2002", 2002, 64, 128, 8, 128, 5),
              ("small F=8 C=16", 13, 8, 16, 4, 16, 5)]
# phase 2g: (kernel, zoo model, streams, timed repetitions)
CENTER_CASES = [("center_chunk", "ns_dpcrn_v0_causal", 2048, 5),
                ("dparn_center_chunk", "ns_dparn_v0_causal", 1024, 5)]
# and 3 streams: no conv tile lies in one (frame, k) block, so the resident
# convs gather row by row (held to the same bars, not in the kernels line)
CENTER_RAGGED = ("dparn_center_chunk", "ns_dparn_v0_causal", 3, 2)
NS_STREAMS, NS_SECONDS = 4, 2.0     # phases 3b, 3c
NS_SLOTS, NS_TICKS, NS_WARM = (256, 2048), 25, 3    # phases 4b, 4d
DPARN_SLOTS = (256, 1024)           # phase 4c
TRAIN_B, TRAIN_SECONDS = 64, 2.0    # phase 6: the JAX bench's B=64 x 2 s
RECIPE_STEPS, RECIPE_WARM = 12, 2   # phase 6b: steps in its epoch, untimed ones


_START = time.perf_counter()


def log(phase: str, msg: str, t0: float):
    """A phase's line: its message, the seconds since `t0`, and the run's
    clock (seconds since this module was loaded), which places the phase."""
    now = time.perf_counter()
    print(f"[{phase}] {msg} ({now - t0:.2f} s; at {now - _START:.0f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _sass_name(mangled: str) -> str:
    """A short kernel name for a SASS function: the LSTM training kernels
    as `lstm_fwd_cluster<bf16><proj>`, the others as namespace::kernel with
    their template arguments (<bf16> / <f32> weights, <db> bf16 dots, the
    integer arguments: conv_tc_kernel's n-tiles and ring buffers)."""
    short = re.search(r"lstm_[a-z_]+?_(?:cluster|prod|reduce)", mangled)
    if short:
        name = short.group(0) + ("<bf16>" if "bfloat16" in mangled
                                 else "<f32>" if re.search(r"(?:cluster|prod)If", mangled)
                                 else "")
        return name + ("<proj>" if "Lb1" in mangled else "")
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    pos, ids = m.end(), []
    while True:           # the length-prefixed identifiers of the nested name
        d = re.match(r"(\d+)", mangled[pos:])
        if not d:
            break
        n, pos = int(d.group(1)), pos + d.end()
        ids.append(mangled[pos:pos + n])
        pos += n
    ids = [i for i in ids if not i.startswith("_GLOBAL__N")]
    rest = mangled[pos:]
    if ids and ids[-1] == "dp_chain_kernel":   # <INTER, Q8>: the pass and int8_hh
        inter, q8 = re.findall(r"Lb([01])E", rest)[:2]
        return f"dp_tc::dp_chain_kernel<{'C' if inter == '1' else 'A'}>" + (
            "<q8>" if q8 == "1" else "")
    args = ""
    if rest.startswith("I"):
        t = rest[1:rest.find("EE") + 1] if "EE" in rest else rest[1:]
        args = "".join((["<bf16>"] if t.startswith("13__nv_bfloat16") else
                        ["<f32>"] if t.startswith("f") else [])
                       + (["<db>"] if re.search(r"Lb1E", t) else [])
                       + [f"<{a}>" for a in re.findall(r"Li(\d+)E", t)])
    return "::".join(ids[-2:]) + args


def sass_dumps(build_dir: str, names) -> dict:
    """{name: `cuobjdump -sass` of lib<name>.so}, the dumps run side by side
    (threads waiting on the subprocesses); {} where the toolkit has no
    cuobjdump."""
    from concurrent.futures import ThreadPoolExecutor

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    dump = lambda name: subprocess.run([exe, "-sass", os.path.join(build_dir, f"lib{name}.so")],
                                       capture_output=True, text=True, check=True).stdout
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(dump, names)))


def hmma_counts(build_dir: str, name: str, sass: str = None) -> dict:
    """{kernel: (mma.sync HMMA, wgmma HGMMA, int8 mma.sync IMMA) tensor-core
    instructions} in the SASS of a built library (`cuobjdump -sass`, or the
    dump `sass` already taken), {} where the toolkit has no cuobjdump."""
    if sass is None:
        sass = sass_dumps(build_dir, [name]).get(name)
        if sass is None:
            return {}
    counts, fn = {}, None
    for line in sass.splitlines():
        if "MMA" not in line and "Function : " not in line:
            continue
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _sass_name(m.group(1))
            counts[fn] = [0, 0, 0]
        elif fn is not None and "HGMMA" in line:
            counts[fn][1] += 1
        elif fn is not None and "HMMA" in line:
            counts[fn][0] += 1
        elif fn is not None and "IMMA" in line:
            counts[fn][2] += 1
    return {k: tuple(v) for k, v in counts.items()}


def expect_launches(got, want, what: str):
    """Fail unless the kernels were launched exactly as often as the path
    should have launched them."""
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, not {want}")


def count_of(mod, attr) -> int:
    """A kernel module's launch count: an int, or the sum of a count by
    entry (the LSTM training kernel's FWD_BY_ENTRY / BWD_BY_ENTRY)."""
    v = getattr(mod, attr)
    return sum(v.values()) if isinstance(v, dict) else v


def zero_count(mod, attr):
    v = getattr(mod, attr)
    if isinstance(v, dict):
        v.clear()
    else:
        setattr(mod, attr, 0)


def _fwd_bwd(k) -> tuple:
    return (("FWD_BY_ENTRY", "BWD_BY_ENTRY") if hasattr(k, "FWD_BY_ENTRY")
            else ("FWD_LAUNCHES", "BWD_LAUNCHES"))


def zero_counts(*kernels):
    """Set the launch counts of the kernel modules to 0."""
    for k in kernels:
        for attr in _fwd_bwd(k):
            zero_count(k, attr)


def counts(lk, tk) -> tuple:
    """(LSTM forward, LSTM backward, TCN forward, TCN backward) launches."""
    return tuple(count_of(k, a) for k in (lk, tk) for a in _fwd_bwd(k))


def snr_db(got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.double() - want.double()).pow(2).sum().item()
    ref = want.double().pow(2).sum().item()
    return 10 * math.log10(ref / max(err, 1e-300))


# ------------------------------------------------------------------ phase 2
#: fused_skim_frames's kernels by route (`center_split` patterns)
SKIM_KERNELS = (("mma", r"skim_tc_kernel"), ("cuda", r"skim_frames_kernel"))


def skim_route(dt, C, H, modes) -> str:
    """The route fused_skim_frames's plan takes at the models' geometry (bf16
    dots at C=128, H=256 (the flagship) or H=64 (the PVAD model), n >= 2:
    tensor cores) and elsewhere (CUDA cores)."""
    geometry = C == 128 and H in (64, 256) and len(modes) >= 2
    return "mma" if dt == torch.bfloat16 and geometry else "cuda"


@torch.no_grad()
def kernel_case(ops, SkiM, name, n, C, H, B, F, modes, chunks, gen, dev,
                bars=(1e-3, 40.0)):
    """Kernel vs plain over `chunks` carried chunks, f32 then bf16: f32
    max|d|/max|ref| within bars[0], bf16 SNR at least bars[1] dB; every
    launch on the route `skim_route` names (LAUNCHES_BY_ROUTE), two calls
    bit-equal, one call's device ms by kernel from a profiler window; the
    bf16 plan's (route, K, M) and the clusters of K in flight. The masker's
    fusion is Gate when a mode is "gate", else FiLM."""
    masker = SkiM(input_size=C, hidden_size=H, output_size=C, n_blocks=n,
                  seg_size=F * 10, causal=True, embed_dim=192, embed_norm=True,
                  embed_fusion="Gate" if "gate" in modes else "FiLM",
                  block_with_embed=tuple(int(m != "") for m in modes),
                  device=dev, generator=gen).eval()
    w32 = masker._fused_weights()
    embed = torch.randn(B, 192, generator=gen).to(dev)
    se, be, ge = masker._embed_terms(masker._norm_embed(embed), B,
                                     torch.float32, w32)
    xs = [torch.randn(B, F, C, generator=gen).to(dev) for _ in range(chunks)]
    h0 = (0.3 * torch.randn(n, B, H, generator=gen)).to(dev)
    c0 = (0.3 * torch.randn(n, B, H, generator=gen)).to(dev)
    res = {"name": name}
    plan = ops.plan_on(dev, B, C, H, ge.shape[2], modes,
                       torch.bfloat16)
    res["bf16_plan"] = (f"{plan.route} K={plan.K} M={plan.M} (clusters in flight by K "
                        f"{ops.tc_clusters(dev)})" if plan.route == "mma" else plan.route)
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ws = w32 if dt == torch.float32 else ops.SkimWeights(
            w.to(dt) for w in w32)
        args = (se.to(dt), be.to(dt), ge.to(dt))
        runs = {}
        ops.LAUNCHES_BY_ROUTE.clear()
        for fn in (ops.fused_skim_frames, ops.fused_skim_frames_ref):
            h, c = h0.to(dt), c0.to(dt)
            ys = []
            for x in xs:
                y, h, c = fn(x.to(dt), *args, h, c, ws, modes, dot_dtype=dt)
                ys.append(y)
            runs[fn] = (torch.cat(ys, 1), h, c)
        torch.cuda.synchronize()
        res[f"{label}_routes"] = dict(ops.LAUNCHES_BY_ROUTE)
        expect_launches(res[f"{label}_routes"], {skim_route(dt, C, H, modes): chunks},
                        f"{name} {label}, fused_skim_frames launches by route")
        got, want = runs[ops.fused_skim_frames], runs[ops.fused_skim_frames_ref]
        for t in got:
            if not torch.isfinite(t).all():
                raise AssertionError(f"{name} {label}: non-finite kernel output")
        if dt == torch.float32:
            errs = [(g - w).abs().max().item() / w.abs().max().item()
                    for g, w in zip(got, want)]
            res["f32_rel_err"] = max(errs)
            res["f32_max_abs_err"] = max((g - w).abs().max().item()
                                         for g, w in zip(got, want))
            if max(errs) > bars[0]:
                raise AssertionError(f"{name} f32: max|d| / max|ref| per "
                                     f"(y, h, c) = {errs} > {bars[0]:g}")
        else:
            snrs = [snr_db(g, w) for g, w in zip(got, want)]
            res["bf16_snr_db"] = min(snrs)
            if min(snrs) < bars[1]:
                raise AssertionError(f"{name} bf16: SNR (y, h, c) = {snrs} dB "
                                     f"< {bars[1]:g} dB")
        x1, h1, c1 = xs[0].to(dt), h0.to(dt), c0.to(dt)
        call = lambda: ops.fused_skim_frames(x1, *args, h1, c1, ws, modes, dot_dtype=dt)
        first, again = call(), call()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{name} {label}: two calls of the kernel differ")
        for fn, key in ((ops.fused_skim_frames, "ms"),
                        (ops.fused_skim_frames_ref, "plain_ms")):
            res[f"{label}_{key}"] = cuda_ms(
                lambda: fn(x1, *args, h1, c1, ws, modes, dot_dtype=dt))
        res[f"{label}_split"] = center_split(call, passes=SKIM_KERNELS)
    return res


# ------------------------------------------------------------------ phase 2b
# the H100 SXM's dense peaks (utils/roofline.py)
PEAK_OPS = {torch.float32: roofline.H100_F32_FLOPS, torch.bfloat16: roofline.H100_BF16_FLOPS}
PEAK_BYTES = roofline.H100_HBM_BYTES_S


def bound_ms(flops: float, nbytes: float, dt) -> tuple:
    """(least time in ms, "operations" or "bytes") on the published peaks."""
    t_ops, t_bytes = flops / PEAK_OPS[dt], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def fusion_macs(C, fusion, Hg=GATE_HG):
    """Multiply-adds a stream row of one conditioned block adds per frame:
    FiLM's two C x C dots, or the Gate's x @ Win, u @ Wl, u @ Wrx and
    (left * right) @ Wout."""
    return 2 * C * Hg + 2 * Hg * Hg if fusion == "gate" else 2 * C * C


def skim_work(n, C, H, F, B, dt, fusion="film", Hg=GATE_HG):
    """(operations, bytes) of one fused_skim_frames call with every block
    conditioned by `fusion`: per frame, stream and block the fusion's dots,
    the LSTM's (C + H) x 4H dot and the H x C projection; the weights, x,
    the embed terms (se/be, or ge) and h/c read once, y and h/c written
    once."""
    e = torch.finfo(dt).bits // 8
    macs = fusion_macs(C, fusion, Hg) + (C + H) * 4 * H + H * C
    flops = 2.0 * B * F * n * macs
    terms = n * B * Hg if fusion == "gate" else 2 * n * B * C
    nbytes = n * macs * e + (2 * B * F * C + terms + 4 * n * B * H) * e
    return flops, nbytes


def lstm_work(B, T, C, H, dt):
    """(forward flops, forward bytes, backward flops, backward bytes) of one
    lstm_scan_train_fp call: each input read once, each output written once."""
    e = torch.finfo(dt).bits // 8
    R, G = B * T, 4 * H
    w = (C + H + 1) * G * e
    fwd_flops = 2.0 * R * (C + H) * G
    fwd_bytes = R * C * e + w + 2 * B * H * e + R * (H + G + H) * e + 2 * B * H * e
    bwd_flops = 4.0 * R * (C + H) * G
    bwd_bytes = (R * (G + H + H + C + H) * e + w + 4 * B * H * e   # in
                 + R * C * e + 2 * B * H * e + w)                   # out
    return fwd_flops, fwd_bytes, bwd_flops, bwd_bytes


def hold_values_grads(res, label, name, vals, grads):
    """(kernel, plain) pairs of values and gradients at phase 2b's bars: f32
    max|d|/max|ref| 1e-4 on the values and 1e-3 on the gradients; bf16 SNR
    40 dB on the values and 30 on the gradients."""
    for g, _ in vals + grads:
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {label}: non-finite kernel output")
    if label == "f32":
        rel = lambda pairs: [((g - w).abs().max() / w.abs().max()).item() for g, w in pairs]
        rv, rg = rel(vals), rel(grads)
        res["f32_val_rel"], res["f32_grad_rel"] = max(rv), max(rg)
        res["f32_max_abs_err"] = max((g - w).abs().max().item() for g, w in vals + grads)
        if max(rv) > 1e-4 or max(rg) > 1e-3:
            raise AssertionError(f"{name} f32: max|d|/max|ref| values {rv} > 1e-4 or "
                                 f"gradients {rg} > 1e-3")
    else:
        sv = [snr_db(g, w) for g, w in vals]
        sg = [snr_db(g, w) for g, w in grads]
        res["bf16_val_snr"], res["bf16_grad_snr"] = min(sv), min(sg)
        if min(sv) < 40.0 or min(sg) < 30.0:
            raise AssertionError(f"{name} bf16: SNR values {sv} dB < 40 or gradients "
                                 f"{sg} dB < 30")


def lstm_kernel_case(lk, name, B, T, C, H, reverse, gen, dev, reps, plain_once=False):
    """`lstm_scan_train_fp` kernel (forward + backward) against its plain
    version on the card, f32 then bf16, with CUDA-event times and cuDNN's
    LSTM (`torch.nn.LSTM`, the same weights) as the library yardstick.
    `plain_once`: the plain version's time is that of the one call the check
    makes (a long scan's Python loop, thousands of steps, is not repeated)."""
    k = 1.0 / math.sqrt(H)
    uni = lambda *s: (torch.rand(s, generator=gen) * 2 - 1) * k
    x = 0.5 * torch.randn(B, T, C, generator=gen)
    h0, c0 = 0.3 * torch.randn(B, H, generator=gen), 0.3 * torch.randn(B, H, generator=gen)
    w_ih, bias, w_hh = uni(C, 4 * H), uni(4 * H), uni(H, 4 * H)
    dy = torch.randn(B, T, H, generator=gen)
    dhT, dcT = torch.randn(B, H, generator=gen), torch.randn(B, H, generator=gen)
    res = {"name": name, "shape": f"B={B} T={T} C={C} H={H} reverse={reverse}"}
    want = []
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = [a.to(dev, dt) for a in (x, h0, c0, w_ih, bias, w_hh)]
        cot = [a.to(dev, dt) for a in (dy,)] + [dhT.to(dev), dcT.to(dev)]
        got_f = lk._launch_fwd(*args, reverse, residuals=True)
        got_b = lk._launch_bwd(*args, *got_f[:1], *got_f[3:], *cot, reverse)
        repeat_equal(f"{name} {label} lstm_scan_train_fp", got_f, got_b,
                     lk._launch_fwd(*args, reverse, residuals=True),
                     lk._launch_bwd(*args, *got_f[:1], *got_f[3:], *cot, reverse))
        pf = lambda: lk.lstm_scan_train_fp_ref(*args, reverse)
        if plain_once:
            res[f"{label}_plain_fwd_ms"] = cuda_ms(lambda: want.append(pf()), 1, 0)
            want_f = want.pop()
        else:
            want_f = pf()
        pb = lambda: lk.lstm_scan_train_fp_bwd_ref(*args, want_f[0], *want_f[3:],
                                                   *cot, reverse)
        if plain_once:
            res[f"{label}_plain_bwd_ms"] = cuda_ms(lambda: want.append(pb()), 1, 0)
            want_b = want.pop()
        else:
            want_b = pb()
        torch.cuda.synchronize()
        hold_values_grads(res, label, name, list(zip(got_f[:3], want_f[:3])),
                          list(zip(got_b, want_b)))
        kf = lambda: lk._launch_fwd(*args, reverse, residuals=True)
        kb = lambda: lk._launch_bwd(*args, *got_f[:1], *got_f[3:], *cot, reverse)
        res[f"{label}_fwd_ms"] = cuda_ms(kf, reps)
        res[f"{label}_bwd_ms"] = cuda_ms(kb, reps)
        if not plain_once:
            res[f"{label}_plain_fwd_ms"] = cuda_ms(pf, max(2, reps // 4), 1)
            res[f"{label}_plain_bwd_ms"] = cuda_ms(pb, max(2, reps // 4), 1)
        ff, fb, bf, bb = lstm_work(B, T, C, H, dt)
        res[f"{label}_fwd_bound"] = bound_ms(ff, fb, dt)
        res[f"{label}_bwd_bound"] = bound_ms(bf, bb, dt)
        (res[f"{label}_lib_fwd_ms"], res[f"{label}_lib_bwd_ms"],
         res[f"{label}_lib_fwdbwd_ms"]) = cudnn_lstm_ms(*args, *cot, reps)
    return res


def repeat_equal(what, got_f, got_b, again_f, again_b):
    """Two calls of the forward and backward kernels on the same inputs give
    the same outputs bit for bit (no atomics, fixed summation orders)."""
    torch.cuda.synchronize()
    for a, b in zip(list(got_f) + list(got_b), list(again_f) + list(again_b)):
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"{what}: two calls of the kernels differ")


#: phase 2b / 2j's split of one backward: the profiler's kernel names
SPLIT_NAMES = (("chain", "lstm_bwd_cluster"), ("weight gradient", "lstm_wgrad_prod"),
               ("dx", "lstm_dx_prod"), ("reduce", "lstm_wgrad_reduce"))


def split_text(split: dict) -> str:
    """The backward's (and the forward's) device ms by kernel, for the log."""
    if not split:
        return "not measured (the profiler saw no device time)"
    bwd = split.get("bwd", {})
    fwd = "; ".join(f"{k} {v:.3f}" for k, v in split.get("fwd", {}).items()
                    if k.startswith("lstm_"))
    return ("backward " + ", ".join(f"{label} {bwd.get(key, 0.0):.3f}"
                                    for label, key in SPLIT_NAMES) + f"; forward {fwd}")


def lstm_split(lk, B, T, C, H, dt, dev, reps=5, hoisted=False):
    """{"fwd": {kernel: ms a call}, "bwd": {...}}: the device time of each
    kernel of one `lstm_scan_train_fp` forward and backward launch (with
    `hoisted`, `lstm_scan_train_tm`'s) at one shape, from a torch.profiler
    window over `reps` launches of each, after one of each untimed; {} when
    the profiler saw no device time."""
    from torch.autograd import DeviceType

    gen = torch.Generator().manual_seed(SEED + 3)
    x = (0.5 * torch.randn(T, B, 4 * H if hoisted else C, generator=gen)).to(dev, dt)
    h0, c0 = (0.3 * torch.randn(2, B, H, generator=gen)).to(dev, dt)
    w_ih = None if hoisted else (0.05 * torch.randn(C, 4 * H, generator=gen)).to(dev, dt)
    bias = None if hoisted else (0.05 * torch.randn(4 * H, generator=gen)).to(dev, dt)
    w_hh = (0.05 * torch.randn(H, 4 * H, generator=gen)).to(dev, dt)
    dy = torch.randn(T, B, H, generator=gen).to(dev, dt)
    args = (x, h0, c0, w_ih, bias, w_hh)
    fwd = lambda: lk._launch_fwd(*args, False, residuals=True, time_major=True)
    y, _, _, gates, cseq = fwd()
    bwd = lambda: lk._launch_bwd(*args, y, gates, cseq, dy, None, None, False,
                                 time_major=True)
    bwd()
    torch.cuda.synchronize()
    out = {}
    for half, fn in (("fwd", fwd), ("bwd", bwd)):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            m = re.search(r"(lstm_\w+)", e.key)
            key = m.group(1) if m else e.key[:40]
            split[key] = split.get(key, 0.0) + us / 1e3 / reps
        if split:
            out[half] = split
    return out


def cudnn_lstm_ms(x, h0, c0, w_ih, bias, w_hh, dy, dhT, dcT, reps):
    """cuDNN's LSTM (`torch.nn.LSTM`) on the same weights and inputs: (ms of
    its forward, ms of its backward alone, one `torch.autograd.grad` call
    over a kept graph, ms of forward + backward), or Nones where it refuses
    the dtype. It has no reverse-only direction: for a reverse scan it runs
    its forward direction, the same work. A yardstick only: the port never
    calls it."""
    B, T, C = x.shape
    H = w_hh.shape[0]
    with torch.random.fork_rng(devices=[]):   # its init draws leave the global RNG as it was
        lstm = torch.nn.LSTM(C, H, batch_first=True).to(device=x.device, dtype=x.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.T)
        lstm.weight_hh_l0.copy_(w_hh.T)
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
    try:
        with torch.no_grad():
            fwd = cuda_ms(lambda: lstm(x, (h0[None], c0[None])), reps)
        inputs = [t.detach().requires_grad_() for t in (x, h0[None], c0[None])]
        y, (h, c) = lstm(inputs[0], tuple(inputs[1:]))
        wrt = inputs + list(lstm.parameters())
        cot = (dy, dhT[None].to(h.dtype), dcT[None].to(c.dtype))
        bwd = cuda_ms(lambda: torch.autograd.grad((y, h, c), wrt, cot,
                                                  retain_graph=True), reps)

        def fwd_bwd():
            y, (h, c) = lstm(inputs[0], tuple(inputs[1:]))
            torch.autograd.grad((y, h, c), wrt, cot)

        both = cuda_ms(fwd_bwd, reps)
    except RuntimeError as err:   # the yardstick only; the port is not involved
        print(f"  cuDNN LSTM ({x.dtype}) not timed: {err}".splitlines()[0], flush=True)
        return None, None, None
    return fwd, bwd, both


# ------------------------------------------------------------------ phase 2j
def hoisted_work(B, T, H, dt):
    """(forward flops, forward bytes, backward flops, backward bytes) of one
    lstm_scan_train_tm call: the forward's h @ W_hh (xp is given), the
    backward's dgates @ W_hh^T and h_prev^T @ dgates; each input read once
    (xp, W_hh, h0/c0; then gates, cseq, y, dy, dhT/dcT), each output written
    once (y, hT/cT, gates, cseq; then dxp, dh0/dc0 and dW_hh in float32)."""
    e = torch.finfo(dt).bits // 8
    R, G = B * T, 4 * H
    fwd_flops = 2.0 * R * H * G
    fwd_bytes = (R * G + H * G + 2 * B * H) * e + (R * (H + G + H) + 2 * B * H) * e
    bwd_flops = 4.0 * R * H * G
    bwd_bytes = ((R * (G + H + H + H) + H * G + 2 * B * H) * e + 2 * B * H * 4
                 + R * G * e + 2 * B * H * 4 + H * G * 4)
    return fwd_flops, fwd_bytes, bwd_flops, bwd_bytes


def lstm_unfused_case(lk, name, B, T, C, H, reverse, gen, dev, reps):
    """Phase 2j at one shape, f32 then bf16:
    - `lstm_scan_train_tm` (the hoisted projection: xp_t = x_t @ w_ih + bias
      made in the input dtype) forward and backward kernels against their
      plain versions, with CUDA-event times, the bound, and the batch-major
      `lstm_scan_train` timed whole (its [B, T, 4H] swap of xp included);
    - `lstm_scan_train_fp_tm` forward and backward against the batch-major
      `lstm_scan_train_fp` launches on the same data, bit for bit (the same
      arithmetic), and against its plain version;
    cuDNN's LSTM (it projects the input too) as the yardstick."""
    k = 1.0 / math.sqrt(H)
    uni = lambda *s: (torch.rand(s, generator=gen) * 2 - 1) * k
    x = 0.5 * torch.randn(B, T, C, generator=gen)
    h0, c0 = 0.3 * torch.randn(B, H, generator=gen), 0.3 * torch.randn(B, H, generator=gen)
    w_ih, bias, w_hh = uni(C, 4 * H), uni(4 * H), uni(H, 4 * H)
    dy = torch.randn(B, T, H, generator=gen)
    dhT, dcT = torch.randn(B, H, generator=gen), torch.randn(B, H, generator=gen)
    res = {"name": name, "shape": f"B={B} T={T} C={C} H={H} reverse={reverse}"}
    sw = lambda a: a.transpose(0, 1).contiguous()
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xd, h0d, c0d, wid, bd, whd = (a.to(dev, dt) for a in (x, h0, c0, w_ih, bias, w_hh))
        x_t, dy_t = sw(xd), sw(dy.to(dev, dt))
        cot = (dhT.to(dev), dcT.to(dev))
        # the hoisted scan
        xp_t = x_t @ wid + bd
        hargs = (xp_t, h0d, c0d, None, None, whd)
        got_f = lk._launch_fwd(*hargs, reverse, residuals=True, time_major=True)
        got_b = lk._launch_bwd(*hargs, *got_f[:1], *got_f[3:], dy_t, *cot, reverse,
                               time_major=True)
        repeat_equal(f"{name} {label} lstm_scan_train_tm", got_f, got_b,
                     lk._launch_fwd(*hargs, reverse, residuals=True, time_major=True),
                     lk._launch_bwd(*hargs, *got_f[:1], *got_f[3:], dy_t, *cot, reverse,
                                    time_major=True))
        want_f = lk.lstm_scan_train_ref(xp_t, h0d, c0d, whd, reverse)
        want_b = lk.lstm_scan_train_bwd_ref(xp_t, h0d, c0d, whd, want_f[0], *want_f[3:],
                                            dy_t, *cot, reverse)
        torch.cuda.synchronize()
        hold_values_grads(res, label, f"{name} lstm_scan_train_tm",
                          list(zip(got_f[:3], want_f[:3])), list(zip(got_b, want_b)))
        res[f"{label}_fwd_ms"] = cuda_ms(
            lambda: lk._launch_fwd(*hargs, reverse, residuals=True, time_major=True), reps)
        res[f"{label}_bwd_ms"] = cuda_ms(
            lambda: lk._launch_bwd(*hargs, *got_f[:1], *got_f[3:], dy_t, *cot, reverse,
                                   time_major=True), reps)
        res[f"{label}_plain_fwd_ms"] = cuda_ms(
            lambda: lk.lstm_scan_train_ref(xp_t, h0d, c0d, whd, reverse), max(2, reps // 4), 1)
        res[f"{label}_plain_bwd_ms"] = cuda_ms(
            lambda: lk.lstm_scan_train_bwd_ref(xp_t, h0d, c0d, whd, want_f[0], *want_f[3:],
                                               dy_t, *cot, reverse), max(2, reps // 4), 1)
        xp = sw(xp_t)
        with torch.no_grad():
            res[f"{label}_batch_major_fwd_ms"] = cuda_ms(
                lambda: lk.lstm_scan_train(xp, h0d, c0d, whd, reverse), reps)
        ff, fb, bf, bb = hoisted_work(B, T, H, dt)
        res[f"{label}_fwd_bound"] = bound_ms(ff, fb, dt)
        res[f"{label}_bwd_bound"] = bound_ms(bf, bb, dt)
        # the time-major entry of the fused kernel
        fargs = (x_t, h0d, c0d, wid, bd, whd)
        tm_f = lk._launch_fwd(*fargs, reverse, residuals=True, time_major=True)
        tm_b = lk._launch_bwd(*fargs, *tm_f[:1], *tm_f[3:], dy_t, *cot, reverse,
                              time_major=True)
        repeat_equal(f"{name} {label} lstm_scan_train_fp_tm", tm_f, tm_b,
                     lk._launch_fwd(*fargs, reverse, residuals=True, time_major=True),
                     lk._launch_bwd(*fargs, *tm_f[:1], *tm_f[3:], dy_t, *cot, reverse,
                                    time_major=True))
        bm_f = lk._launch_fwd(xd, *fargs[1:], reverse, residuals=True)
        bm_b = lk._launch_bwd(xd, *fargs[1:], *bm_f[:1], *bm_f[3:], dy.to(dev, dt), *cot,
                              reverse)
        ref_f = lk.lstm_scan_train_fp_ref(*fargs, reverse, True)
        ref_b = lk.lstm_scan_train_fp_bwd_ref(*fargs, ref_f[0], *ref_f[3:], dy_t, *cot,
                                              reverse, True)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            [tm_f[0], *tm_f[1:], tm_b[0], *tm_b[1:]],
            [sw(bm_f[0]), *bm_f[1:], sw(bm_b[0]), *bm_b[1:]]))
        if not same:
            raise AssertionError(f"{name} {label}: lstm_scan_train_fp_tm differs from the "
                                 "batch-major launches")
        sub = {}
        hold_values_grads(sub, label, f"{name} lstm_scan_train_fp_tm",
                          list(zip(tm_f[:3], ref_f[:3])), list(zip(tm_b, ref_b)))
        res.update({f"fp_tm_{k}": v for k, v in sub.items()})
        res[f"fp_tm_{label}_fwd_ms"] = cuda_ms(
            lambda: lk._launch_fwd(*fargs, reverse, residuals=True, time_major=True), reps)
        res[f"fp_tm_{label}_bwd_ms"] = cuda_ms(
            lambda: lk._launch_bwd(*fargs, *tm_f[:1], *tm_f[3:], dy_t, *cot, reverse,
                                   time_major=True), reps)
        res[f"fp_tm_{label}_plain_fwd_ms"] = cuda_ms(
            lambda: lk.lstm_scan_train_fp_ref(*fargs, reverse, True), max(2, reps // 4), 1)
        res[f"fp_tm_{label}_plain_bwd_ms"] = cuda_ms(
            lambda: lk.lstm_scan_train_fp_bwd_ref(*fargs, ref_f[0], *ref_f[3:], dy_t, *cot,
                                                  reverse, True), max(2, reps // 4), 1)
        ff, fb, bf, bb = lstm_work(B, T, C, H, dt)
        res[f"fp_tm_{label}_fwd_bound"] = bound_ms(ff, fb, dt)
        res[f"fp_tm_{label}_bwd_bound"] = bound_ms(bf, bb, dt)
        (res[f"{label}_lib_fwd_ms"], res[f"{label}_lib_bwd_ms"],
         res[f"{label}_lib_fwdbwd_ms"]) = cudnn_lstm_ms(xd, h0d, c0d, wid, bd, whd,
                                                        dy.to(dev, dt), *cot, reps)
    res["fp_tm_bit_equal"] = True
    return res


# ------------------------------------------------------------------ phase 2c
def tcn_work(B, C, Ch, T, k, dt):
    """(forward flops, forward bytes, backward flops, backward bytes) of one
    tcn_block_train call: the three 1x1 products and the depthwise taps
    (the backward recomputes the forward and runs each product twice more);
    x, the parameters and y (forward), x, dy, the parameters, dx and the
    gradients (backward), each read or written once."""
    e = torch.finfo(dt).bits // 8
    R = B * T
    prod = 2.0 * R * (Ch * C + Ch * Ch + C * Ch)
    taps = 2.0 * R * Ch * k
    params = (2 * Ch * C + Ch * Ch + Ch * k + 7 * Ch + C + 3) * e
    fwd_bytes = 2 * R * C * e + params
    bwd_bytes = 3 * R * C * e + 2 * params
    return prod + taps, fwd_bytes, 3 * (prod + taps), bwd_bytes


def tcn_params(C, Ch, k, gen):
    """Random block parameters at the scale of a trained speaker net."""
    uni = lambda bound, *s: (torch.rand(s, generator=gen) * 2 - 1) * bound
    near1 = lambda n: 1 + 0.1 * torch.randn(n, generator=gen)
    small = lambda n: 0.1 * torch.randn(n, generator=gen)
    alpha = lambda: 0.25 + 0.05 * torch.randn(1, generator=gen)
    return [uni(C ** -0.5, Ch, C), near1(Ch), small(Ch), alpha(),
            uni(k ** -0.5, Ch, k), small(Ch), near1(Ch), small(Ch), alpha(),
            uni(Ch ** -0.5, Ch, Ch), small(Ch), near1(Ch), small(Ch), alpha(),
            uni(Ch ** -0.5, C, Ch), small(C)]


def stock_tcn_ms(params, x, dy, dilation, reps):
    """The port's stock TCN path (cuDNN convolutions, the norms and PReLUs
    under autograd) on the same weights, forward + backward: a yardstick,
    since no single PyTorch call computes the block."""
    from puresound_tpu_torch.nnet.conv_tasnet import TCN

    B, C, T = x.shape
    Ch, k = params[0].shape[0], params[4].shape[1]
    m = TCN(C, Ch, k, dilation, device=x.device, dtype=x.dtype)
    ds = m.dconv[0]
    targets = [m.in_conv[0].weight, m.in_conv[1].gamma, m.in_conv[1].beta,
               m.in_conv[2].weight, ds.depthwise[0].weight, ds.depthwise[0].bias,
               ds.depthwise[1].weight, ds.depthwise[1].bias, ds.depthwise[2].weight,
               ds.pointwise[0].weight, ds.pointwise[0].bias, ds.pointwise[1].weight,
               ds.pointwise[1].bias, ds.pointwise[2].weight, m.out_conv.weight,
               m.out_conv.bias]
    with torch.no_grad():
        for t, p in zip(targets, params):
            t.copy_(p.reshape(t.shape))
    xg = x.detach().requires_grad_()

    def fwd_bwd():
        y = m.out_conv(m.dconv(m.in_conv(xg))) + xg
        torch.autograd.grad(y, [xg, *m.parameters()], dy)

    return cuda_ms(fwd_bwd, reps)


def tcn_kernel_case(tk, name, B, C, Ch, T, dilation, gen, dev, reps):
    """`tcn_block_train` kernel (forward + backward) against its plain
    version on the card, f32 then bf16, with CUDA-event times, the bounds
    and the stock module's forward + backward as the yardstick."""
    k = 3
    params = tcn_params(C, Ch, k, gen)
    x = torch.randn(B, C, T, generator=gen)
    dy = torch.randn(B, C, T, generator=gen)
    res = {"name": name, "shape": f"B={B} C={C} Ch={Ch} T={T} k={k} d={dilation}"}
    alphas = {3, 8, 13}          # al1, al2, al3 among the 16 gradients
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ps = [p.to(dev, dt) for p in params]
        xd, dyd = x.to(dev, dt), dy.to(dev, dt)
        # the plan the wrapper launches is the CUDA source's, and the route
        # it names is the one the launches took
        pl = tk._plan(B, C, Ch, T, k, dt, dilation)
        if tk.source_plan(B, C, Ch, T, k, dilation, dt) != (pl.ints(), (pl.fwd_scratch,
                                                                         pl.bwd_scratch)):
            raise AssertionError(f"{name} {label}: _plan differs from csrc/tcn_train.cu's")
        tk.LAUNCHES_BY_ROUTE.clear()
        got_y = tk._launch_fwd(xd, ps, dilation)
        got_b = tk._launch_bwd(xd, dyd, ps, dilation)
        routes = dict(tk.LAUNCHES_BY_ROUTE)
        if routes != {("fwd", pl.route): 1, ("bwd", pl.route): 1}:
            raise AssertionError(f"{name} {label}: launches by route {routes}, plan {pl.route}")
        res[f"{label}_route"] = pl.route
        # deterministic: a second call is bit-equal
        again = [tk._launch_fwd(xd, ps, dilation)] + list(tk._launch_bwd(xd, dyd, ps, dilation))
        if not all(torch.equal(a, b) for a, b in zip([got_y] + list(got_b), again)):
            raise AssertionError(f"{name} {label}: two calls differ")
        del again
        want_y = tk.tcn_block_train_ref(xd, *ps, dilation=dilation)
        want_b = tk.tcn_block_train_bwd_ref(xd, dyd, *ps, dilation=dilation)
        torch.cuda.synchronize()
        pairs = [(got_y, want_y)] + list(zip(got_b, want_b))
        for g, _ in pairs:
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {label}: non-finite kernel output")
        # The direct bars hold the kernel against the plain version: f32
        # max|d|/max|ref| <= 1e-4 on y and dx, 1e-3 on the parameter
        # gradients (3e-3 on the alphas); bf16 >= 40 dB SNR on y and >= 30 dB
        # on the gradients. Two computations at these sizes can miss them
        # both: an f32 PReLU input within rounding of 0 takes the other slope
        # (a few dozen of 33M elements do; the plain f32 version misses the
        # f64 one by about 1e-2 of max|dx|), and a bf16 dot operand near a
        # rounding boundary rounds the other way, which moves an alpha
        # gradient, a sum over B*Ch*T terms that cancel, by a few per cent.
        # So each result is also held against the exact reference, the same
        # cast points with the math in float64, by relative L2 error: where
        # a direct bar fails (not on y), the kernel must be no further from
        # it than twice the plain version is, and within 3e-3 (f32) or 30 dB
        # (bf16) whatever the plain version's own distance. The three PReLU
        # slope gradients are single sums over B*Ch*T terms that cancel, so
        # one draw decides where a rounding boundary falls: where their
        # direct bar fails, each call must be within that cap of the exact
        # reference whatever the plain version's distance, and the seed
        # sweep below holds their distribution.
        exact = ([tk.tcn_block_train_ref(xd, *ps, dilation=dilation,
                                         compute_dtype=torch.float64)]
                 + list(tk.tcn_block_train_bwd_ref(xd, dyd, *ps, dilation=dilation,
                                                   compute_dtype=torch.float64)))
        rel2 = lambda a, b: ((a.double() - b).norm() / b.norm()).item()
        kx = [rel2(g, r) for (g, _), r in zip(pairs, exact)]
        px = [rel2(w, r) for (_, w), r in zip(pairs, exact)]
        del exact
        names = ("y", "dx") + tk.PARAM_NAMES
        if dt == torch.float32:
            direct = [((g.double() - w.double()).abs().max()
                       / w.double().abs().max()).item() for g, w in pairs]
            bars = [1e-4, 1e-4] + [3e-3 if i in alphas else 1e-3 for i in range(16)]
            held = [d <= bar for d, bar in zip(direct, bars)]
            cap = 3e-3
            res["f32_val_rel"], res["f32_grad_rel"] = direct[0], max(direct[1:])
            res["f32_max_abs_err"] = max((g - w).abs().max().item() for g, w in pairs)
        else:
            direct = [snr_db(g, w) for g, w in pairs]
            bars = [40.0] + [30.0] * 17
            held = [d >= bar for d, bar in zip(direct, bars)]
            cap = 10 ** (-30.0 / 20)
            res["bf16_val_snr"], res["bf16_grad_snr"] = direct[0], min(direct[1:])
        res[f"{label}_l2_vs_exact"], res[f"{label}_plain_l2_vs_exact"] = max(kx), max(px)
        rows = list(zip(names, held, direct, kx, px))
        slope = {names[2 + i] for i in alphas}
        res[f"{label}_l2_fallback"] = [(n, d, k, p) for n, h, d, k, p in rows
                                       if not h and n not in slope]
        res[f"{label}_slopes"] = [(n, d, k, p) for n, h, d, k, p in rows if n in slope]
        bad = [(n, d, k, p) for n, h, d, k, p in rows
               if not (h or (k <= cap if n in slope else n != "y" and k <= min(2 * p, cap)))]
        if bad:
            raise AssertionError(
                f"{name} {label}: (tensor, reading vs plain, L2 vs exact kernel, plain) "
                f"over the bars: {bad}")
        res[f"{label}_fwd_ms"] = cuda_ms(lambda: tk._launch_fwd(xd, ps, dilation), reps)
        res[f"{label}_bwd_ms"] = cuda_ms(lambda: tk._launch_bwd(xd, dyd, ps, dilation),
                                         reps)
        res[f"{label}_plain_fwd_ms"] = cuda_ms(
            lambda: tk.tcn_block_train_ref(xd, *ps, dilation=dilation), max(2, reps // 4), 1)
        res[f"{label}_plain_bwd_ms"] = cuda_ms(
            lambda: tk.tcn_block_train_bwd_ref(xd, dyd, *ps, dilation=dilation),
            max(2, reps // 4), 1)
        res[f"{label}_stock_ms"] = stock_tcn_ms(ps, xd, dyd, dilation,
                                                max(2, reps // 4))
        ff, fb, bf, bb = tcn_work(B, C, Ch, T, k, dt)
        res[f"{label}_fwd_bound"] = bound_ms(ff, fb, dt)
        res[f"{label}_bwd_bound"] = bound_ms(bf, bb, dt)
    # scratch the kernel keeps in device memory (float32)
    pl = tk._plan(B, C, Ch, T, k, torch.bfloat16, dilation)
    res["fwd_scratch_mb"] = 4 * pl.fwd_scratch / 1e6
    res["bwd_scratch_mb"] = 4 * pl.bwd_scratch / 1e6
    return res


def tcn_split(tk, B, C, Ch, T, dilation, dt, dev, reps=5):
    """{"fwd": {kernel: ms a call}, "bwd": {...}}: the device time of each
    kernel of one `tcn_block_train` forward and backward launch at one shape
    (a torch.profiler window over `reps` launches of each, after one of each
    untimed); {} when the profiler saw no device time."""
    from torch.autograd import DeviceType

    gen = torch.Generator().manual_seed(SEED + 4)
    ps = [p.to(dev, dt) for p in tcn_params(C, Ch, 3, gen)]
    x = torch.randn(B, C, T, generator=gen).to(dev, dt)
    dy = torch.randn(B, C, T, generator=gen).to(dev, dt)
    fwd = lambda: tk._launch_fwd(x, ps, dilation)
    bwd = lambda: tk._launch_bwd(x, dy, ps, dilation)
    fwd(), bwd()
    torch.cuda.synchronize()
    out = {}
    for half, fn in (("fwd", fwd), ("bwd", bwd)):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            m = re.search(r"(tcn_\w+)", e.key)
            key = (m.group(1) + ("<" + re.search(r"<([^>]*)>", e.key).group(1) + ">"
                                 if "<" in e.key else "")) if m else e.key[:40]
            split[key] = split.get(key, 0.0) + us / 1e3 / reps
        if split:
            out[half] = split
    return out


#: phase 2c's cases whose bf16 calls must take the wgmma route (the model's
#: widths); the others' take the CUDA cores, as the plan says
TCN_WGMMA_CASES = ("speaker d=1", "speaker d=16", "recipe d=1", "recipe d=16",
                   "1c recipe d=1", "1c recipe d=16")


def tcn_phase(tk, gen, dev, card) -> dict:
    out = {}
    for name, B, C, Ch, T, dilation, reps in TCN_CASES:
        t = time.perf_counter()
        g = torch.Generator().manual_seed(TCN_SEEDS[name]) if name in TCN_SEEDS else gen
        r = tcn_kernel_case(tk, name, B, C, Ch, T, dilation, g, dev, reps)
        out[name] = r
        want = "wgmma" if name in TCN_WGMMA_CASES else "cuda_cores"
        if (r["f32_route"], r["bf16_route"]) != ("cuda_cores", want):
            raise AssertionError(f"{name}: routes f32 {r['f32_route']}, bf16 "
                                 f"{r['bf16_route']}; bf16 should take {want}")
        fallback = lambda lb, fmt: ", ".join(
            f"({n}, {fmt(d)}, {k:.2e} / {p:.2e})" for n, d, k, p in r[f"{lb}_l2_fallback"]
        ) or "none"
        log("2c tcn", f"{r['shape']}: f32 max|d|/max|ref| y {r['f32_val_rel']:.2e}, dx "
            f"and grads {r['f32_grad_rel']:.2e}; bf16 SNR y {r['bf16_val_snr']:.1f} dB, "
            f"dx and grads {r['bf16_grad_snr']:.1f} dB; worst relative L2 against the "
            f"exact reference, kernel / plain: f32 {r['f32_l2_vs_exact']:.2e} / "
            f"{r['f32_plain_l2_vs_exact']:.2e}, bf16 {r['bf16_l2_vs_exact']:.2e} / "
            f"{r['bf16_plain_l2_vs_exact']:.2e}; held by the L2 bar as (tensor, reading "
            f"vs plain, L2 vs exact kernel / plain): f32 "
            f"{fallback('f32', lambda d: f'{d:.2e}')}, bf16 "
            f"{fallback('bf16', lambda d: f'{d:.1f} dB')}; PReLU slope gradients (tensor, "
            f"reading vs plain, L2 vs exact kernel / plain; the direct bar, else the cap): f32 "
            + ", ".join(f"({n}, {d:.2e}, {k:.2e} / {p:.2e})" for n, d, k, p in r["f32_slopes"])
            + ", bf16 "
            + ", ".join(f"({n}, {d:.1f} dB, {k:.2e} / {p:.2e})"
                        for n, d, k, p in r["bf16_slopes"])
            + f"; routes f32 {r['f32_route']}, bf16 {r['bf16_route']} (launches by route "
            "as the plan says, the plan equal to the source's), two calls bit-equal; "
            + "; ".join(
                f"{lb} ms fwd/bwd kernel {r[f'{lb}_fwd_ms']:.3f}/{r[f'{lb}_bwd_ms']:.3f}, "
                f"plain {r[f'{lb}_plain_fwd_ms']:.3f}/{r[f'{lb}_plain_bwd_ms']:.3f}, "
                f"stock module fwd+bwd {r[f'{lb}_stock_ms']:.3f}, "
                f"bound {r[f'{lb}_fwd_bound'][0]:.3f}/{r[f'{lb}_bwd_bound'][0]:.3f} "
                f"({r[f'{lb}_fwd_bound'][1]})" for lb in ("f32", "bf16"))
            + f"; scratch fwd/bwd {r['fwd_scratch_mb']:.1f}/{r['bwd_scratch_mb']:.1f} MB"
            f" [{card}]", t)
    # the device time of each kernel of one launch at the speaker shape
    t = time.perf_counter()
    B, C, Ch, T = 64, 128, 256, 1999
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        split = tcn_split(tk, B, C, Ch, T, 1, dt, dev)
        out["speaker d=1"][f"{label}_split"] = split
        log("2c tcn split", f"B={B} C={C} Ch={Ch} T={T} d=1 {label}: " + ("; ".join(
            f"{half} {sum(v.values()):.3f} ms: " + ", ".join(
                f"{k} {ms:.3f}" for k, ms in sorted(v.items(), key=lambda kv: -kv[1]))
            for half, v in split.items()) or "not measured (the profiler saw no device "
            "time)") + f" [{card}]", t)
    return out


#: phase 2c's seed sweep: the PReLU slope gradients (al1, al2, al3) of the
#: speaker net's block (B=64 x T=1,999, d = 1 and 16) over seeds of their own
TCN_SWEEP_SEEDS = 8
TCN_SWEEP_SHAPE = (64, 128, 256, 1999)   # B, C, Ch, T


def tcn_seed_sweep(tk, dev, card):
    """Phase 2c, seeds: whether the bf16 backward's slope gradients miss the
    exact reference (the plain version's cast points, float64 math) more
    than the plain version does, over TCN_SWEEP_SEEDS fresh draws at the
    speaker net's shape. Each slope gradient is one sum over B*Ch*T terms
    that cancel, after dot operands rounded to bf16: an f32 difference that
    moves one operand across a bf16 rounding boundary moves the sum. The
    reductions that form it (tcn_norm_rows_kernel, tcn_dw_bwd_kernel,
    tcn_norm_reduce) run in float32 for both dtypes, so the f32 backward
    holds them apart from bf16 rounding. In both dtypes each call must meet
    phase 2c's per-call rule for them: within the direct bar of the plain
    version or within the cap of the exact reference (3e-3 relative in f32,
    30 dB in bf16, either), and the kernel's median distance to exact over
    the seeds must be at most twice the plain version's (f32 also passes at
    or below 1e-4); the cases where the kernel is over twice the plain
    version's distance are listed."""
    alphas = (3, 8, 13)
    t = time.perf_counter()
    for dilation in (1, 16):
        rows = {"f32": [], "bf16": []}
        for s in range(TCN_SWEEP_SEEDS):
            gen = torch.Generator().manual_seed(SEED + 100 + s)
            (B, C, Ch, T), k = TCN_SWEEP_SHAPE, 3
            params = tcn_params(C, Ch, k, gen)
            x = torch.randn(B, C, T, generator=gen)
            dy = torch.randn(B, C, T, generator=gen)
            for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                ps = [p.to(dev, dt) for p in params]
                xd, dyd = x.to(dev, dt), dy.to(dev, dt)
                got = tk._launch_bwd(xd, dyd, ps, dilation)
                plain = tk.tcn_block_train_bwd_ref(xd, dyd, *ps, dilation=dilation)
                exact = tk.tcn_block_train_bwd_ref(xd, dyd, *ps, dilation=dilation,
                                                   compute_dtype=torch.float64)
                for i in alphas:
                    e, q = exact[1 + i].item(), plain[1 + i].double().item()
                    k = got[1 + i].double().item()
                    rows[label].append((s, tk.PARAM_NAMES[i], abs(k - e) / abs(e),
                                        abs(q - e) / abs(e), abs(k - q) / abs(q)))
                del got, plain, exact
        torch.cuda.synchronize()
        o = {"cases": len(rows["bf16"])}
        for label, cap in (("f32", 3e-3), ("bf16", 10 ** (-30.0 / 20))):
            over = [r for r in rows[label] if not min(r[2], r[4]) <= cap]
            if over:
                raise AssertionError(f"d={dilation} {label} slope gradients over the cap "
                                     f"{cap:.3e} (seed, slope, kernel and plain vs exact, "
                                     f"kernel vs plain): {over}")
        for label, floor in (("f32", 1e-4), ("bf16", 0.0)):
            k_med = float(np.median([r[2] for r in rows[label]]))
            p_med = float(np.median([r[3] for r in rows[label]]))
            if k_med > max(2 * p_med, floor):
                raise AssertionError(
                    f"d={dilation} {label} slope gradients: kernel median {k_med:.3e} vs "
                    f"exact > max(2 x plain's {p_med:.3e}, {floor:g}): {rows[label]}")
            o.update({f"{label}_kernel_median": k_med, f"{label}_plain_median": p_med,
                      f"{label}_kernel_max": max(r[2] for r in rows[label]),
                      f"{label}_plain_max": max(r[3] for r in rows[label]),
                      f"{label}_kernel_closer": sum(r[2] < r[3] for r in rows[label]),
                      f"{label}_median_ratio": float(np.median(
                          [r[2] / max(r[3], 1e-30) for r in rows[label]]))})
        misses = [r for r in rows["bf16"] if not r[2] <= 2 * r[3]]
        log("2c tcn seeds", "B={} C={} Ch={} T={}".format(*TCN_SWEEP_SHAPE)
            + f" d={dilation}, {TCN_SWEEP_SEEDS} "
            f"seeds x (al1, al2, al3), |d| / |exact|, kernel / plain: " + "; ".join(
                f"{lb} median {o[f'{lb}_kernel_median']:.2e} / {o[f'{lb}_plain_median']:.2e}"
                f", max {o[f'{lb}_kernel_max']:.2e} / {o[f'{lb}_plain_max']:.2e}, kernel "
                f"closer in {o[f'{lb}_kernel_closer']} of {o['cases']}, median of kernel / "
                f"plain a case {o[f'{lb}_median_ratio']:.2f}"
                for lb in ("f32", "bf16"))
            + f" (bars: each call within 3e-3 f32 / 30 dB bf16 of the plain version or of "
            f"exact; kernel median <= 2 x plain's, f32 or <= 1e-4); bf16 cases over 2 x "
            f"plain's distance (seed, slope, kernel, plain): "
            f"{[(a, b, f'{c:.2e}', f'{d:.2e}') for a, b, c, d, _ in misses] or 'none'} "
            f"[{card}]", t)
        t = time.perf_counter()


# ------------------------------------------------------------------ phase 2d
def lscan_work(B, T, H, dt, state_dt=None):
    """(multiply-add operations x 2, bytes) of one lstm_scan call: the H x 4H
    recurrent dot per row and step; xp, w_hh and h0 / c0 read once, y and hT
    / cT written once (xp, y and w_hh in `dt`, the state in `state_dt`)."""
    e, es = torch.finfo(dt).bits // 8, torch.finfo(state_dt or dt).bits // 8
    G = 4 * H
    return 2.0 * B * T * H * G, (B * T * G + H * G + B * T * H) * e + 4 * B * H * es


def lscan_bound(plan, B, T, H, dt, state_dt=None):
    """The least time of a call on its route: on the tensor cores each
    multiply-add is `plan.pieces` bf16 products (three exact pieces of h
    under float32 dots, one under bfloat16 dots) at 989 TFLOP/s; on the CUDA
    cores one float32 FMA at 67 TFLOP/s; against bytes at 3.35 TB/s."""
    flops, nbytes = lscan_work(B, T, H, dt, state_dt)
    if plan.route == "tc":
        return bound_ms(plan.pieces * flops, nbytes, torch.bfloat16)
    return bound_ms(flops, nbytes, torch.float32)


def cudnn_lstm_fwd_ms(B, T, C, H, dt, dev, reps):
    """cuDNN's LSTM forward (`torch.nn.LSTM`, C=128 inputs) at the same rows,
    steps and H: a yardstick that also computes the input projection; the
    port never calls it. None where it refuses the dtype."""
    lstm = torch.nn.LSTM(C, H, batch_first=True).to(device=dev, dtype=dt)
    x = torch.randn(B, T, C, device=dev, dtype=dt)
    h0 = torch.zeros(1, B, H, device=dev, dtype=dt)
    try:
        with torch.no_grad():
            return cuda_ms(lambda: lstm(x, (h0, h0)), reps)
    except RuntimeError as err:    # the yardstick only; the port is not involved
        print(f"  cuDNN LSTM ({dt}) not timed: {err}".splitlines()[0], flush=True)
        return None


def lstm_scan_case(lsk, name, B, T, H, reverse, carries, bf16_dot, bf16_state, gen, dev,
                   reps):
    """`lstm_scan` kernel against its plain version on the card, f32 then
    bf16 xp / weights with `bf16_dot` dots (f32 on the fused serving route)
    and `bf16_state` h0 / c0: the route each call took (LAUNCHES_BY_ROUTE;
    bf16 at H = 128 on the tensor cores, the rest on the CUDA cores), two
    calls bit-equal, the bars (f32 and every float32 output: max|d| <= 1e-4
    max|ref|; bf16 outputs: SNR >= 40 dB), one call's device ms (CUDA
    events), the plain version's, the bound on the route's rule and cuDNN's
    forward."""
    k = 1.0 / math.sqrt(H)
    xp = torch.randn(B, T, 4 * H, generator=gen)
    h0 = 0.3 * torch.randn(B, H, generator=gen) if carries else torch.zeros(B, H)
    c0 = 0.3 * torch.randn(B, H, generator=gen) if carries else torch.zeros(B, H)
    w = (torch.rand(H, 4 * H, generator=gen) * 2 - 1) * k
    bf = torch.bfloat16
    res = {"name": name, "shape": f"rows={B} T={T} H={H} reverse={reverse}, bf16 run "
           f"with {str(bf16_dot)[6:]} dots and {str(bf16_state)[6:]} state"}
    for label, dt, dot, sdt in (("f32", torch.float32, torch.float32, torch.float32),
                                ("bf16", bf, bf16_dot, bf16_state)):
        args = [xp.to(dev, dt), h0.to(dev, sdt), c0.to(dev, sdt), w.to(dev, dt)]
        plan = lsk._plan(B, H, dt == bf, dt == bf, dot == bf)
        want_route = "tc" if dt == bf and H in lsk.TC_WIDTHS else "cuda"
        if plan.route != want_route:
            raise AssertionError(f"{name} {label}: plan {plan}, not the {want_route} route")
        lsk.LAUNCHES_BY_ROUTE.clear()
        got = lsk._launch(*args, reverse, dot)
        again = lsk._launch(*args, reverse, dot)
        want = lsk.lstm_scan_ref(*args, reverse, dot)
        torch.cuda.synchronize()
        expect_launches(dict(lsk.LAUNCHES_BY_ROUTE), {want_route: 2},
                        f"lstm_scan {name} {label}, launches by route")
        res[f"{label}_route"] = plan.route
        res[f"{label}_pieces"] = plan.pieces
        res[f"{label}_bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, again))
        if not res[f"{label}_bit_equal"]:
            raise AssertionError(f"{name} {label}: two calls differ")
        for g in got:
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {label}: non-finite kernel output")
        rel = [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
               for g, r in zip(got, want)]
        snr = [snr_db(g, r) for g, r in zip(got, want)]
        f32_out = [g.dtype == torch.float32 for g in got]
        bad = [i for i in range(3) if (rel[i] > 1e-4 if f32_out[i] else snr[i] < 40.0)]
        if bad:
            raise AssertionError(f"{name} {label}: (y, hT, cT) max|d|/max|ref| {rel}, SNR "
                                 f"{snr} dB; over the bar (f32 1e-4, bf16 40 dB): {bad}")
        if dt == torch.float32:
            res["f32_rel"] = max(rel)
            res["f32_max_abs_err"] = max((g - r).abs().max().item() for g, r in zip(got, want))
        else:
            res["bf16_snr_db"] = min(s for s, f in zip(snr, f32_out) if not f)
            res["bf16_f32_state_rel"] = max([r for r, f in zip(rel, f32_out) if f], default=None)
        del got, again, want
        res[f"{label}_ms"] = cuda_ms(lambda: lsk._launch(*args, reverse, dot), reps)
        res[f"{label}_plain_ms"] = cuda_ms(
            lambda: lsk.lstm_scan_ref(*args, reverse, dot), max(2, reps // 4), 1)
        res[f"{label}_bound"] = lscan_bound(plan, B, T, H, dt, sdt)
        res[f"{label}_bound_rule"] = (
            f"{plan.pieces} bf16 product(s) a multiply-add at 989 TFLOP/s"
            if plan.route == "tc" else "one f32 FMA a multiply-add at 67 TFLOP/s")
        res[f"{label}_lib_ms"] = (None if reverse or sdt != dt else
                                  cudnn_lstm_fwd_ms(B, T, 128, H, dt, dev, reps))
    return res


# ------------------------------------------------------------------ phase 2e
def dual_path_work(F, K, B, CH, H, dt, n_blocks=2):
    """(operations, bytes) of one dual_path_chunk call, as the JAX bench's
    ns_roofline counts them (bench.py:264-281): per block the intra scans
    (2 directions, (CH + H) x 4H per row and step), the intra projection
    (2H x CH), the inter scan and its projection (H x CH); x read and y
    written once, the carries read and written once, the weights read once."""
    e = torch.finfo(dt).bits // 8
    G, R = 4 * H, K * B
    per_block = (2 * 2.0 * R * F * (CH + H) * G + 2.0 * F * R * 2 * H * CH
                 + 2.0 * F * B * K * (CH + H) * G + 2.0 * F * B * K * H * CH)
    weights = n_blocks * (3 * (CH + H) * G + 3 * G + 3 * H * CH + 6 * CH)
    nbytes = (2 * F * K * B * CH + 2 * 2 * n_blocks * F * B * H + weights) * e
    return n_blocks * per_block, nbytes


def dp_weights(CH, H, gen, n_blocks=2):
    """Random weights in dual_path_chunk's flat order, at trained scales."""
    from puresound_tpu_torch.ops.dual_path_kernel import NAMES, _weight_shape

    ws = []
    for _ in range(n_blocks):
        for name in NAMES:
            shape = _weight_shape(name, CH, H)
            scale = 1.0 / math.sqrt(shape[0]) if len(shape) == 2 else 0.1
            w = (torch.rand(shape, generator=gen) * 2 - 1) * scale
            ws.append(1.0 + w if name in ("ig", "tg") else w)
    return ws


def dp_plan(dpk, F, K, B, CH, H, dt, int8_hh: bool = False):
    """The dual-path passes' launch plan of a call in dtype dt (weights and
    dots) on this card."""
    bf16 = dt == torch.bfloat16
    return dpk._plan(F, K, B, CH, H, bf16, bf16, int8_hh,
                     sms=torch.cuda.get_device_properties(0).multi_processor_count)


def dp_pass_launches(plan, blocks: int, passes: str = "ABC") -> dict:
    """The LAUNCHES_BY_PASS of calls on `plan` that ran `blocks` blocks."""
    return {f"{p}:{plan.passes[p]}": blocks for p in passes}


def dual_path_case(dpk, name, B, F, K, CH, H, reps, gen, dev):
    """`dual_path_chunk` kernel against its plain version on the card over
    DP_CHUNKS carried chunks, f32 then bf16 (x, weights, carries and dots),
    with CUDA-event times of one chunk and the bound; two calls bit-equal,
    the launches by pass on the plan's route, one call's device ms by pass."""
    ws = dp_weights(CH, H, gen)
    cgen = torch.Generator(device=dev).manual_seed(SEED)
    xs = [torch.randn(F, K, B, CH, device=dev, generator=cgen) for _ in range(DP_CHUNKS)]
    carries = [0.3 * torch.randn(F, B, H, device=dev, generator=cgen) for _ in range(4)]
    res = {"name": name, "shape": f"B={B} F={F} K={K} CH={CH} H={H}", "passes": {}}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        wd = [w.to(dev, dt) for w in ws]
        plan = dp_plan(dpk, F, K, B, CH, H, dt)
        res[f"{label}_route"] = plan.route
        x1 = xs[0].to(dt)
        h1, c1 = [t.to(dt) for t in carries[:2]], [t.to(dt) for t in carries[2:]]
        dpk.LAUNCHES_BY_PASS.clear()
        first, second = dpk._launch(x1, h1, c1, wd, dt), dpk._launch(x1, h1, c1, wd, dt)
        torch.cuda.synchronize()
        flat = lambda o: [o[0]] + list(o[1]) + list(o[2])
        if not all(torch.equal(a, b) for a, b in zip(flat(first), flat(second))):
            raise AssertionError(f"{name} {label}: two calls of the kernel differ")
        expect_launches(dict(dpk.LAUNCHES_BY_PASS), dp_pass_launches(plan, 4),
                        f"{name} {label}: dual_path_chunk passes by route")
        res["passes"][label] = dict(dpk.LAUNCHES_BY_PASS)
        del first, second
        runs = []
        for fn in (dpk._launch, dpk.dual_path_chunk_ref):
            h, c = [t.to(dt) for t in carries[:2]], [t.to(dt) for t in carries[2:]]
            ys = []
            for x in xs:
                y, h, c = fn(x.to(dt), h, c, wd, dt)
                ys.append(y)
            runs.append([torch.cat(ys, 1)] + h + c)
        torch.cuda.synchronize()
        got, want = runs
        for g in got:
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {label}: non-finite kernel output")
        if dt == torch.float32:
            rel = [((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, want)]
            res["f32_rel"] = max(rel)
            res["f32_max_abs_err"] = max((g - r).abs().max().item() for g, r in zip(got, want))
            if max(rel) > 1e-4:
                raise AssertionError(f"{name} f32: max|d|/max|ref| (y, h1, h2, c1, c2) "
                                     f"{rel} > 1e-4")
        else:
            snr = [snr_db(g, r) for g, r in zip(got, want)]
            res["bf16_snr_db"] = min(snr)
            # both round to bf16 at the same points; a value within rounding
            # of a bf16 boundary goes either way, and the carries take such
            # a flip through 10 chunks: the bar is 30 dB
            if min(snr) < 30.0:
                raise AssertionError(f"{name} bf16: SNR (y, h1, h2, c1, c2) {snr} dB < 30")
        del runs, got, want
        res[f"{label}_ms"] = cuda_ms(lambda: dpk._launch(x1, h1, c1, wd, dt), reps)
        res[f"{label}_split"] = center_split(lambda: dpk._launch(x1, h1, c1, wd, dt),
                                             passes=DP_PASSES)
        res[f"{label}_plain_ms"] = cuda_ms(
            lambda: dpk.dual_path_chunk_ref(x1, h1, c1, wd, dt), 2, 1)
        res[f"{label}_bound"] = bound_ms(*dual_path_work(F, K, B, CH, H, dt), dt)
    return res


# ------------------------------------------------------------------ phase 2f
def attn_work(R, F, C, FFD, dt):
    """(operations, bytes) of one dparn_intra_pass call: per row and encoder
    layer the q / k / v and out projections (4 F C^2 multiply-adds), the
    logits and the probabilities times v (2 F^2 C) and the feed-forward
    (2 F C FFD), then the FC (F C^2); x read and y written once, pe and the
    weights read once."""
    e = torch.finfo(dt).bits // 8
    per_row = 2.0 * (2 * (4 * F * C * C + 2 * F * F * C + 2 * F * C * FFD) + F * C * C)
    weights = 2 * (4 * C * C + 2 * C * FFD + FFD + 5 * C) + C * C + 3 * C
    return R * per_row, (2 * R * F * C + F * C + weights) * e


def attn_weights(C, FFD, gen):
    """Random weights in dparn_intra_pass's flat order, at trained scales."""
    from puresound_tpu_torch.ops.dparn_attention_kernel import weight_shapes

    ws = []
    for i, shape in enumerate(weight_shapes(C, FFD)):
        if len(shape) == 2:
            ws.append((torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(shape[0]))
        else:
            gain = i % 12 in (4, 10) or i == 26          # the LayerNorm scales
            ws.append(float(gain) + 0.1 * torch.randn(shape, generator=gen))
    return ws


def stock_encoder_ms(x, pe, C, FFD, heads, reps):
    """Stock PyTorch modules computing the same function's shape of work: a
    2-layer post-norm ReLU nn.TransformerEncoder (bias=False throughout),
    then nn.Linear + nn.LayerNorm, on x + pe. A yardstick: no single PyTorch
    call computes the pass, and the port never calls these."""
    layer = torch.nn.TransformerEncoderLayer(C, heads, FFD, dropout=0.0, batch_first=True,
                                             bias=False)
    mods = torch.nn.Sequential(torch.nn.TransformerEncoder(layer, 2, enable_nested_tensor=False),
                               torch.nn.Linear(C, C), torch.nn.LayerNorm(C))
    mods = mods.to(device=x.device, dtype=x.dtype).eval()
    with torch.no_grad():
        return cuda_ms(lambda: mods(x + pe), reps)


def attn_case(dak, name, R, F, C, heads, FFD, reps, gen, dev):
    """`dparn_intra_pass` kernel against its plain version on the card, f32
    then bf16 (x, pe, weights and dots), with CUDA-event times, the bound
    and the stock encoder modules as the yardstick."""
    ws = attn_weights(C, FFD, gen)
    x = 0.5 * torch.randn(R, F, C, generator=gen)
    pe = 0.1 * torch.randn(F, C, generator=gen)
    res = {"name": name, "shape": f"R={R} F={F} C={C} heads={heads} FFD={FFD}", "paths": {}}
    by_path = getattr(dak, "LAUNCHES_BY_PATH", None)
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xd, ped, wd = x.to(dev, dt), pe.to(dev, dt), [w.to(dev, dt) for w in ws]
        if by_path is not None:
            by_path.clear()
        got = dak._launch(xd, ped, wd, heads, dt)
        again = dak._launch(xd, ped, wd, heads, dt)
        want = dak.dparn_intra_pass_ref(xd, ped, wd, heads, dt)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: non-finite kernel output")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {label}: two calls of the kernel differ")
        if by_path is not None:
            res["paths"][label] = dict(by_path)
            bf = dt == torch.bfloat16
            expect_launches(res["paths"][label],
                            {dak.plan(R, F, C, FFD, heads, bf, bf, dak.sm_count(dev)).path: 2},
                            f"{name} {label} launches by path")
        if dt == torch.float32:
            res["f32_rel"] = ((got - want).abs().max() / want.abs().max()).item()
            res["f32_max_abs_err"] = (got - want).abs().max().item()
            if res["f32_rel"] > 1e-4:
                raise AssertionError(f"{name} f32: max|d|/max|ref| {res['f32_rel']:.2e} > 1e-4")
        else:
            res["bf16_snr_db"] = snr_db(got, want)
            if res["bf16_snr_db"] < 30.0:
                raise AssertionError(f"{name} bf16: SNR {res['bf16_snr_db']:.1f} dB < 30")
        del got, again, want
        res[f"{label}_ms"] = cuda_ms(lambda: dak._launch(xd, ped, wd, heads, dt), reps)
        res[f"{label}_plain_ms"] = cuda_ms(
            lambda: dak.dparn_intra_pass_ref(xd, ped, wd, heads, dt), 2, 1)
        res[f"{label}_stock_ms"] = stock_encoder_ms(xd, ped, C, FFD, heads, reps)
        res[f"{label}_bound"] = bound_ms(*attn_work(R, F, C, FFD, dt), dt)
    return res


# ------------------------------------------------------------------ phase 2g
def center_work(name, F, K, B, chans, H, dt):
    """(operations, bytes) of one wide-center call: the six convs (six taps
    of C_in x C_out per output row, twelve with the skip part), then the
    bottleneck (dual_path_work for DPCRN; for DPARN attn_work's rows and the
    inter scan with its projection); x and y, the 11 carries in and out and
    the weights, each once."""
    C0, C2, C3, C4, CH, Cu2, yC = chans
    e = torch.finfo(dt).bits // 8
    rows = F * K * B
    convs = [(C0, C2), (C2, C3), (C3, CH), (2 * CH, C4), (C4 + C3, Cu2), (Cu2 + C2, yC)]
    conv_flops = sum(2.0 * rows * 6 * ci * co for ci, co in convs)
    conv_w = sum(6 * ci * co + 2 * co for ci, co in convs)
    if name == "center_chunk":
        bflops, bbytes = dual_path_work(F, K, B, CH, H, dt)
    else:
        G = 4 * H
        aflops, abytes = attn_work(K * B, F, CH, H, dt)
        bflops = 2 * (aflops + 2.0 * F * B * K * ((CH + H) * G + H * CH))
        bbytes = 2 * (abytes - 2 * K * B * F * CH * e + (3 * (CH + H) * G + H * CH) * e)
    carries = F * B * (C0 + C2 + C3 + 2 * CH + C4 + Cu2 + 4 * H)
    return conv_flops + bflops, bbytes + (rows * (C0 + yC) + 2 * carries + conv_w) * e


def full_width_masker(zoo_name, dev, seed):
    """The zoo model's masker on the card with its BatchNorms' statistics
    and affines drawn away from the identity."""
    from puresound_tpu_torch.zoo.ns import init_model

    gen = torch.Generator().manual_seed(seed)
    m = init_model(zoo_name, device=dev, generator=gen).masker
    with torch.no_grad():
        for mod in m.modules():
            if hasattr(mod, "running_var"):
                n = mod.running_var.shape[0]
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                mod.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
    return m


def stock_center_ms(masker, x, reps):
    """The port's dp_kernel-style route for the same six layers: cuDNN
    convs d2-d4, the bottleneck through `dual_path_chunk` (DPCRN) or
    `dparn_intra_pass` + `lstm_scan` (DPARN), cuDNN transpose convs u0-u2
    with their skip concats. A yardstick; x is the d1 output [B, C, F, K]."""
    from puresound_tpu_torch.nnet.dparn import DPARN
    from puresound_tpu_torch.nnet.lobe.norm import apply_norm

    B = x.shape[0]
    dparn = isinstance(masker, DPARN)
    st = masker.init_stream_state(B, x.dtype, dp_kernel=not dparn)
    n = masker._n_cnn

    def run():
        h, skips = x, []
        for i in range(n - 3, n):
            seq = masker.cnn_down[i]
            h = seq[3](apply_norm(seq[2], seq[1].stream_apply(h, st["down"][i], (1, 1))))
            skips.append(h)
        if dparn:
            h = masker.dprnn_block1.step_chunk(h, st["h1"], st["c1"], fused=True,
                                               attn_kernel=True)[0]
            h = masker.dprnn_block2.step_chunk(h, st["h2"], st["c2"], fused=True,
                                               attn_kernel=True)[0]
        else:
            h = masker.bottleneck_kernel_chunk(h, st)[0]
        for j in range(3):
            seq = masker.cnn_up[j]
            h = torch.cat([h, skips[-j - 1]], dim=1)
            h = seq[2](apply_norm(seq[1], seq[0].stream_apply(h, st["up"][j])))
        return h

    with torch.no_grad():
        return cuda_ms(run, reps)


def flat_outs(outs) -> list:
    """A wide-center call's outputs as one list of tensors."""
    flat = []
    for o in outs:
        flat += list(o) if isinstance(o, (list, tuple)) else [o]
    return flat


#: the dual-path passes by kernel name, both routes (the CUDA-core kernels'
#: names and the tensor-core ones: dp_chain_kernel<false, ..> is pass A,
#: <true, ..> pass C)
DP_PASSES = (("intra scans", r"dp_intra_kernel|dp_chain_kernel<false"),
             ("intra proj", r"dp_proj(?:_tc)?_kernel"),
             ("inter", r"dp_inter_kernel|dp_chain_kernel<true"),
             ("copies", r"last_frame_kernel|to_half_kernel"))
#: the wide center's passes by kernel name (`center_split`)
CENTER_PASSES = (("convs", r"conv_(?:tc_)?kernel"),
                 ("attention", r"dparn_(?:attn|wgmma)")) + DP_PASSES


def center_split(fn, reps: int = 3, passes=CENTER_PASSES) -> dict:
    """{pass: device ms a call} of a wide-center call (`CENTER_PASSES`; a
    dual_path_chunk call with DP_PASSES) from a torch.profiler window over
    `reps` calls; {} when the profiler saw no device time."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        key = next((k for k, pat in passes if re.search(pat, e.key)), "other")
        split[key] = split.get(key, 0.0) + us / 1e3 / reps
    return split


def split_line(split: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in split.items()) if split else "not measured"


def center_case(mkk, name, zoo_name, B, reps, dev):
    """`center_chunk` / `dparn_center_chunk` against the plain version on
    the card over DP_CHUNKS carried chunks (y and the 11 carries), f32 then
    bf16 (x, carries, weights and dots), the full-width zoo masker's
    weights; CUDA-event time of one chunk, the bound, and the port's
    dp_kernel-style route for the same layers as the yardstick."""
    from puresound_tpu_torch.ops import dual_path_kernel as dpk
    from puresound_tpu_torch.streaming.halfprec import to_half

    masker = full_width_masker(zoo_name, dev, SEED)
    K = 2
    res = {"name": name, "shape": f"{zoo_name} B={B} K={K} F=64"}
    cgen = torch.Generator(device=dev).manual_seed(SEED)
    st0 = masker.init_stream_state(B, mk_kernel=True)
    F, C0 = st0["dc"][0].shape[0], st0["dc"][0].shape[-1]
    xs = [0.5 * torch.randn(F, K, B, C0, device=dev, generator=cgen) for _ in range(DP_CHUNKS)]
    carries0 = [0.3 * torch.randn(t.shape, device=dev, generator=cgen)
                for t in st0["dc"] + [st0[k] for k in ("u0h", "u0s", "u1h", "u2h",
                                                         "h1", "h2", "c1", "c2")]]
    chans = (C0, st0["dc"][1].shape[-1], st0["dc"][2].shape[-1], st0["u1h"].shape[-1],
             st0["u0h"].shape[-1], st0["u2h"].shape[-1], None)
    H = st0["h1"].shape[-1]
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dt == torch.bfloat16:
            to_half(masker)
        with torch.no_grad():
            cw = masker._mk_conv_weights()
            if name == "center_chunk":
                bw = masker._dp_kernel_weights()
                pe = None
                call = lambda fn, x, c: fn(x, c[0:3], *c[3:7], c[7:9], c[9:11], cw, bw, dt)
            else:
                bw = masker._dparn_block_weights()
                pe = masker.dprnn_block1.intra_atten1.pos.table(F, dev)
                call = lambda fn, x, c: fn(x, pe, c[0:3], *c[3:7], c[7:9], c[9:11], cw, bw,
                                           masker.nhead, dt)
            heads = getattr(masker, "nhead", 0)
            kern = lambda *a: mkk._launch(0 if name == "center_chunk" else 1, a[0],
                                          pe, a[1][0:3], *a[1][3:7], a[1][7:9], a[1][9:11],
                                          cw, bw, heads, dt)
            plain = getattr(mkk, name + "_ref")
            by_path = getattr(mkk, "LAUNCHES_BY_PATH", None)
            if by_path is not None:
                by_path.clear()
            dpk.LAUNCHES_BY_PASS.clear()
            x1, c1 = xs[0].to(dt), [t.to(dt) for t in carries0]
            first, second = kern(x1, c1), kern(x1, c1)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(flat_outs(first), flat_outs(second))):
                raise AssertionError(f"{name} {label}: two calls of the kernel differ")
            expect_launches(dict(dpk.LAUNCHES_BY_PASS), dp_pass_launches(
                dp_plan(dpk, F, K, B, chans[4], H, dt), 4,
                "ABC" if name == "center_chunk" else "C"),
                f"{name} {label}: the dual-path passes by route")
            res.setdefault("passes", {})[label] = dict(dpk.LAUNCHES_BY_PASS)
            del first, second
            runs = []
            for fn in (lambda x, c: kern(x, c), lambda x, c: call(plain, x, c)):
                c = [t.to(dt) for t in carries0]
                ys = []
                for x in xs:
                    y, dc, u0h, u0s, u1h, u2h, h, cc = fn(x.to(dt), c)
                    c = list(dc) + [u0h, u0s, u1h, u2h] + list(h) + list(cc)
                    ys.append(y)
                runs.append([torch.cat(ys, 1)] + c)
            torch.cuda.synchronize()
        got, want = runs
        chans = chans[:6] + (got[0].shape[-1],)
        for g in got:
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {label}: non-finite kernel output")
        if dt == torch.float32:
            rel = [((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, want)]
            res["f32_rel"] = max(rel)
            res["f32_max_abs_err"] = max((g - r).abs().max().item() for g, r in zip(got, want))
            if max(rel) > 1e-4:
                raise AssertionError(f"{name} f32: max|d|/max|ref| (y, 11 carries) {rel} > 1e-4")
        else:
            snr = [snr_db(g, r) for g, r in zip(got, want)]
            res["bf16_snr_db"] = min(snr)
            if min(snr) < 30.0:
                raise AssertionError(f"{name} bf16: SNR (y, 11 carries) {snr} dB < 30")
        if by_path is not None:
            res.setdefault("paths", {})[label] = dict(by_path)
        del runs, got, want
        with torch.no_grad():
            res[f"{label}_ms"] = cuda_ms(lambda: kern(x1, c1), reps)
            res[f"{label}_split"] = center_split(lambda: kern(x1, c1))
            res[f"{label}_plain_ms"] = cuda_ms(lambda: call(plain, x1, c1), 2, 1)
        res[f"{label}_stock_ms"] = stock_center_ms(masker, x1.permute(2, 3, 0, 1), reps)
        res[f"{label}_bound"] = bound_ms(*center_work(name, F, K, B, chans, H, dt), dt)
    return res


# ------------------------------------------------------------------ phase 2h
#: the int8 products' peak on the CUDA cores in op/s (a multiply-add is 2):
#: the card's __dp4a rate, read by `dp4a_rate` at the start of phase 2h
INT8_CORE_OPS = None
Q_CHUNKS = 5        # carried chunks each variant is held over
#: kernel-vs-plain SNR bars. bf16 I/O: the bf16 bar of phases 2e-2g. f32 I/O:
#: each variant's own, set between its reading and its control's (the kernel
#: without the option against the plain version with it), both read on an
#: H100 80GB HBM3 at 700 W (PERF.md §6), so that a kernel that ignored
#: the option fails; the run asserts that the control stays below. The
#: readings repeat bit for bit from run to run (fixed seeds, no atomics).
Q_BF16_BAR_DB = 30.0
Q_F32_BARS = {                                     # reading / control, dB
    "fused_skim_frames int8_hh": 55.0,             # 61.97 / 44.28
    "fused_skim_frames int8_full": 38.0,           # 43.05 / 29.00
    "dual_path_chunk int8_hh": 65.0,               # 74.82 / 51.67
    "dual_path_chunk xscr_half": 58.0,             # 66.41 / 48.59
    "dual_path_chunk int8_hh+xscr_half": 53.0,     # 58.96 / 46.68
    "center_chunk int8_hh": 65.0,                  # 72.96 / 43.87
    "center_chunk xscr_half": 54.0,                # 59.74 / 47.14
    "dparn_center_chunk xscr_half": 57.0,          # 63.92 / 49.95
    "fused_skim_frames gate int8_hh": 60.0,        # 70.73 / 49.60
    "fused_skim_frames gate int8_full": 44.0}      # 53.70 / 34.80
QSKIM_VARIANTS = ("int8_hh", "int8_full")
QSKIM_SHAPE = (4, 128, 256, 1024, 15)      # n, C, H, B, F: the flagship
QDP_VARIANTS = ("int8_hh", "xscr_half", "int8_hh+xscr_half")
QDP_SHAPE = (2048, 64, 2, 128, 128)        # B, F, K, CH, H: DPCRN at 2048 streams
QCENTER_CASES = [("center_chunk", "ns_dpcrn_v0_causal", 2048, ("int8_hh", "xscr_half")),
                 ("dparn_center_chunk", "ns_dparn_v0_causal", 1024, ("xscr_half",))]


def dp4a_rate(ops, dev) -> float:
    """The card's int8 rate on the CUDA cores, op/s: `skim_stream.cu`'s
    __dp4a loop (8 CTAs of 256 threads per SM, 8 chains a thread) timed
    with CUDA events, 4 multiply-adds a dp4a."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(sms * 8 * 256, dtype=torch.int32, device=dev)
    n = ops.dp4a_rate(out, 16384)
    ms = cuda_ms(lambda: ops.dp4a_rate(out, 16384), 10)
    return 8.0 * n / (ms * 1e-3)


def opts_of(variant: str) -> dict:
    """"int8_hh+xscr_half" -> {"int8_hh": True, "xscr_half": True}."""
    return {k: True for k in variant.split("+")}


#: the card's dense int8 tensor-core rate (H100 SXM data sheet), op/s: the
#: peak of int8 products that run on mma.sync m16n8k32
INT8_TC_OPS = roofline.H100_INT8_OPS


def mixed_bound(ops: dict, nbytes: float) -> tuple:
    """bound_ms for work of several types: each type's operations over its
    own peak ("int8": on the CUDA cores at INT8_CORE_OPS; "int8_tc": on the
    tensor cores at INT8_TC_OPS), the times summed, against the bytes."""
    peak = {"int8": INT8_CORE_OPS, "int8_tc": INT8_TC_OPS}
    t_ops = sum(v / peak.get(t) if t in peak else v / PEAK_OPS[t] for t, v in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def qskim_work(n, C, H, F, B, dt, variant, fusion="film", tc=False):
    """skim_work split by type: int8_hh moves h @ W_hh to int8, int8_full
    every dot but the Gate's (JAX leaves those float), "int8_tc" where they
    run on the tensor cores (`tc`: the bf16 route at the model geometry); a
    quantized matrix is read as 1 byte a weight plus its float32 scales."""
    e = torch.finfo(dt).bits // 8
    rows = 2.0 * B * F * n
    dots = {fusion: (fusion_macs(C, fusion), 2 * C), "ih": (C * 4 * H, 4 * H),
            "hh": (H * 4 * H, 4 * H), "proj": (H * C, C)}
    q = {"hh"} if variant == "int8_hh" else set(dots) - {"gate"}
    ops = {dt: sum(rows * m for k, (m, _) in dots.items() if k not in q),
           "int8_tc" if tc else "int8": sum(rows * m for k, (m, _) in dots.items() if k in q)}
    weights = sum((m + 4 * s) if k in q else m * e for k, (m, s) in dots.items()) * n
    terms = n * B * GATE_HG if fusion == "gate" else 2 * n * B * C
    return ops, weights + (2 * B * F * C + terms + 4 * n * B * H) * e


def q_dual_path_work(work, F, K, B, H, dt, variant, n_blocks=2, tc=False):
    """A dual-path kernel's (flops, bytes) split by type: int8_hh moves the
    recurrent products (the two intra directions and the inter scan, h [H]
    x W_hh [H, 4H] per row and step) to int8 ("int8_tc" where they run on
    the tensor cores, `tc`: the bf16 route) and reads each of the 3 W_hh a
    block as 1 byte a weight plus its 4H float32 scales."""
    flops, nbytes = work
    if "int8_hh" not in variant:
        return {dt: flops}, nbytes
    hh = n_blocks * 3 * 2.0 * K * B * F * H * 4 * H
    e = torch.finfo(dt).bits // 8
    return ({dt: flops - hh, "int8_tc" if tc else "int8": hh},
            nbytes - n_blocks * 3 * (H * 4 * H * (e - 1) - 16 * H))


def on_bf16_grid(t: torch.Tensor) -> bool:
    return torch.equal(t, t.to(torch.bfloat16).to(t.dtype))


def hold(res, label, got, want, control, floor=None):
    """Record a variant's kernel outputs over the carried chunks (`got`)
    against its plain version's (`want`): finite, the SNR over every output
    (values at an int8 or bf16 rounding boundary go either way on the two
    sides, and the carries take such a flip on), and the same SNR of
    `control`, the kernel without the option on the same inputs. `floor`,
    the plain version in float64: the SNR of the float32 plain version
    against it, the rounding floor that no float32 kernel can beat."""
    for g in got:
        if not torch.isfinite(g).all():
            raise AssertionError(f"{res['name']} {label}: non-finite kernel output")
    res[f"{label}_snr_db"] = min(snr_db(g, w) for g, w in zip(got, want))
    res[f"{label}_control_snr_db"] = min(snr_db(g, w) for g, w in zip(control, want))
    if floor is not None:
        res[f"{label}_floor_snr_db"] = min(snr_db(w, f) for w, f in zip(want, floor))
    res[f"{label}_max_abs_err"] = max((g.float() - w.float()).abs().max().item()
                                      for g, w in zip(got, want))


def check_bar(res, label):
    """The kernel reaches the variant's bar; in f32 the control stays below
    it (the bar tells a kernel without the option apart), and under
    xscr_half the kernel's checked outputs lie on the bfloat16 grid while
    the control's do not."""
    what = f"{res['name']} {label}"
    bar = Q_F32_BARS[res["name"]] if label == "f32" else Q_BF16_BAR_DB
    res[f"{label}_bar_db"] = bar
    if res[f"{label}_snr_db"] < bar:
        raise AssertionError(f"{what}: kernel vs plain SNR {res[f'{label}_snr_db']:.1f} dB "
                             f"< {bar:g}")
    if label == "f32" and res["f32_control_snr_db"] >= bar:
        raise AssertionError(f"{what}: the control reads {res['f32_control_snr_db']:.1f} dB "
                             f">= the bar {bar:g}, so the bar cannot fail it")
    if label == "f32" and "xscr_half" in res["name"]:
        if not res["f32_on_bf16_grid"] or res["f32_control_on_bf16_grid"]:
            raise AssertionError(f"{what}: {res['grid_what']} on the bf16 grid: kernel "
                                 f"{res['f32_on_bf16_grid']}, control "
                                 f"{res['f32_control_on_bf16_grid']} (want True, False)")


@torch.no_grad()
def qskim_case(ops, SkiM, variant, reps, gen, dev, fusion="film"):
    """`fused_skim_frames` with int8_hh / int8_full at the flagship shapes
    (n=4, C=128, H=256, F=15, B=1024; every block FiLM, or every block a
    Gate) against its plain version over Q_CHUNKS carried chunks, f32 then
    bf16 (I/O, state, float weights, dots), with CUDA-event times and the
    bound."""
    n, C, H, B, F = QSKIM_SHAPE
    modes = (fusion,) * n
    masker = SkiM(input_size=C, hidden_size=H, output_size=C, n_blocks=n, seg_size=F * 10,
                  causal=True, embed_dim=192, embed_norm=True,
                  embed_fusion="Gate" if fusion == "gate" else "FiLM",
                  block_with_embed=(1,) * n, device=dev, generator=gen).eval()
    kw = opts_of(variant)
    wq, wf = masker._fused_weights(**kw), masker._fused_weights()
    embed = torch.randn(B, 192, generator=gen).to(dev)
    se, be, ge = masker._embed_terms(masker._norm_embed(embed), B, torch.float32, wq)
    xs = [torch.randn(B, F, C, generator=gen).to(dev) for _ in range(Q_CHUNKS)]
    h0 = (0.3 * torch.randn(n, B, H, generator=gen)).to(dev)
    c0 = (0.3 * torch.randn(n, B, H, generator=gen)).to(dev)
    res = {"name": f"fused_skim_frames {'gate ' if fusion == 'gate' else ''}{variant}",
           "shape": f"n={n} C={C} H={H} F={F} B={B}, {fusion}"}
    plan = ops.plan_on(dev, B, C, H, ge.shape[2], modes, torch.bfloat16, int8_hh=True,
                       int8_full="int8_full" in kw)
    res["bf16_plan"] = f"{plan.route} K={plan.K} M={plan.M}"
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cast = lambda ws, d=dt: ops.SkimWeights(w if w.dtype == torch.int8 else w.to(d)
                                                for w in ws)
        ws = cast(wq)
        args = (se.to(dt), be.to(dt), ge.to(dt))
        specs = [(ops.fused_skim_frames, ws, kw, dt), (ops.fused_skim_frames_ref, ws, kw, dt),
                 (ops.fused_skim_frames, cast(wf), {}, dt)]
        if dt == torch.float32:
            f64 = torch.float64
            specs.append((ops.fused_skim_frames_ref, cast(wq, f64), kw, f64))
        runs = []
        ops.LAUNCHES_BY_ROUTE.clear()
        for fn, w, o, rdt in specs:
            h, c = h0.to(rdt), c0.to(rdt)
            ys = []
            for x in xs:
                y, h, c = fn(x.to(rdt), se.to(rdt), be.to(rdt), ge.to(rdt), h, c, w, modes,
                             dot_dtype=rdt, **o)
                ys.append(y)
            runs.append([torch.cat(ys, 1), h, c])
        torch.cuda.synchronize()
        # the option's launches and the control's, on the plan's route
        res[f"{label}_routes"] = dict(ops.LAUNCHES_BY_ROUTE)
        expect_launches(res[f"{label}_routes"], {skim_route(dt, C, H, modes): 2 * Q_CHUNKS},
                        f"{res['name']} {label}, launches by route")
        hold(res, label, *runs)
        check_bar(res, label)
        x1, h1, c1 = xs[0].to(dt), h0.to(dt), c0.to(dt)
        first, again = (ops.fused_skim_frames(x1, *args, h1, c1, ws, modes, dot_dtype=dt, **kw)
                        for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{res['name']} {label}: two calls of the kernel differ")
        res[f"{label}_ms"] = cuda_ms(lambda: ops.fused_skim_frames(
            x1, *args, h1, c1, ws, modes, dot_dtype=dt, **kw), reps)
        res[f"{label}_plain_ms"] = cuda_ms(lambda: ops.fused_skim_frames_ref(
            x1, *args, h1, c1, ws, modes, dot_dtype=dt, **kw), 2, 1)
        res[f"{label}_bound"] = mixed_bound(*qskim_work(
            n, C, H, F, B, dt, variant, fusion, skim_route(dt, C, H, modes) == "mma"))
    return res


@torch.no_grad()
def qdp_case(dpk, variant, reps, gen, dev):
    """`dual_path_chunk` with int8_hh / xscr_half / both at 2048 streams
    against its plain version over Q_CHUNKS carried chunks, f32 then bf16;
    under xscr_half every chunk's f32 y must lie on the bfloat16 grid."""
    from puresound_tpu_torch.ops.dual_path_kernel import NAMES
    from puresound_tpu_torch.ops.quant import quantize_cols

    B, F, K, CH, H = QDP_SHAPE
    kw = opts_of(variant)
    wf, ws = dp_weights(CH, H, gen), []
    for i, w in enumerate(wf):
        q = kw.get("int8_hh") and NAMES[i % len(NAMES)].startswith("w_hh")
        ws += list(quantize_cols(w)) if q else [w]
    cgen = torch.Generator(device=dev).manual_seed(SEED)
    xs = [torch.randn(F, K, B, CH, device=dev, generator=cgen) for _ in range(Q_CHUNKS)]
    carries = [0.3 * torch.randn(F, B, H, device=dev, generator=cgen) for _ in range(4)]
    res = {"name": f"dual_path_chunk {variant}", "shape": f"B={B} F={F} K={K} CH={CH} H={H}",
           "grid_what": "every chunk's y"}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cast = lambda wl, d=dt: [w.to(dev) if w.dtype == torch.int8 else w.to(dev, d)
                                 for w in wl]
        wd = cast(ws)
        specs = [(dpk._launch, wd, kw, dt), (dpk.dual_path_chunk_ref, wd, kw, dt),
                 (dpk._launch, cast(wf), {}, dt)]
        if dt == torch.float32:
            specs.append((dpk.dual_path_chunk_ref, cast(ws, torch.float64), kw, torch.float64))
        runs = []
        for fn, w, o, rdt in specs:
            h, c = [t.to(rdt) for t in carries[:2]], [t.to(rdt) for t in carries[2:]]
            ys = []
            for x in xs:
                y, h, c = fn(x.to(rdt), h, c, w, rdt, **o)
                ys.append(y)
            runs.append([torch.cat(ys, 1)] + h + c)
        torch.cuda.synchronize()
        hold(res, label, *runs)
        res[f"{label}_on_bf16_grid"] = on_bf16_grid(runs[0][0])
        res[f"{label}_control_on_bf16_grid"] = on_bf16_grid(runs[2][0])
        check_bar(res, label)
        del runs
        x1 = xs[0].to(dt)
        h1, c1 = [t.to(dt) for t in carries[:2]], [t.to(dt) for t in carries[2:]]
        res[f"{label}_ms"] = cuda_ms(lambda: dpk._launch(x1, h1, c1, wd, dt, **kw), reps)
        res[f"{label}_plain_ms"] = cuda_ms(
            lambda: dpk.dual_path_chunk_ref(x1, h1, c1, wd, dt, **kw), 2, 1)
        res[f"{label}_bound"] = mixed_bound(*q_dual_path_work(
            dual_path_work(F, K, B, CH, H, dt), F, K, B, H, dt, variant,
            tc=dp_plan(dpk, F, K, B, CH, H, dt, "int8_hh" in variant).route == "mma"))
    return res


@torch.no_grad()
def qcenter_case(mkk, name, zoo_name, B, variants, reps, dev):
    """`center_chunk` (int8_hh, xscr_half) / `dparn_center_chunk`
    (xscr_half) with the full-width zoo masker's weights against the plain
    version over Q_CHUNKS carried chunks, f32 then bf16; one result a
    variant. Under xscr_half every chunk's f32 u0h carry-out (the last
    frame of the bottleneck's scratch) must lie on the bfloat16 grid."""
    from puresound_tpu_torch.ops import dual_path_kernel as dpk
    from puresound_tpu_torch.streaming.halfprec import to_half

    masker = full_width_masker(zoo_name, dev, SEED)
    K = 2
    cgen = torch.Generator(device=dev).manual_seed(SEED)
    st0 = masker.init_stream_state(B, mk_kernel=True)
    F, C0 = st0["dc"][0].shape[0], st0["dc"][0].shape[-1]
    xs = [0.5 * torch.randn(F, K, B, C0, device=dev, generator=cgen) for _ in range(Q_CHUNKS)]
    carries0 = [0.3 * torch.randn(t.shape, device=dev, generator=cgen)
                for t in st0["dc"] + [st0[k] for k in ("u0h", "u0s", "u1h", "u2h",
                                                         "h1", "h2", "c1", "c2")]]
    H = st0["h1"].shape[-1]
    kind = 0 if name == "center_chunk" else 1
    heads = getattr(masker, "nhead", 0)
    out = {v: {"name": f"{name} {v}", "shape": f"{zoo_name} B={B} K={K} F={F}",
               "grid_what": "every chunk's u0h carry-out"} for v in variants}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if dt == torch.bfloat16:
            to_half(masker)
        cw = masker._mk_conv_weights()
        pe = masker.dprnn_block1.intra_atten1.pos.table(F, dev) if kind else None
        plain = getattr(mkk, name + "_ref")
        bws = {q: (masker._dp_kernel_weights(q) if kind == 0
                   else masker._dparn_block_weights()) for q in (False, True)}

        def kern(x, c, int8_hh=False, xscr_half=False):
            return mkk._launch(kind, x, pe, c[0:3], *c[3:7], c[7:9], c[9:11], cw,
                               bws[int8_hh], heads, dt, int8_hh, xscr_half)

        def ref(x, c, rdt=dt, **o):
            """The plain version; rdt=float64: every float operand in float64."""
            f = ((lambda ws: [w.to(rdt) if w.is_floating_point() else w for w in ws])
                 if rdt == torch.float64 else (lambda ws: ws))
            bw, cw_r = f(bws[o.get("int8_hh", False)]), f(cw)
            if kind == 0:
                return plain(x, c[0:3], *c[3:7], c[7:9], c[9:11], cw_r, bw, rdt, **o)
            return plain(x, *f([pe]), c[0:3], *c[3:7], c[7:9], c[9:11], cw_r, bw, heads,
                         rdt, **o)

        for variant in variants:
            kw = opts_of(variant)
            res = out[variant]
            specs = [(kern, kw, dt), (ref, kw, dt), (kern, {}, dt)]
            if dt == torch.float32:
                specs.append((functools.partial(ref, rdt=torch.float64), kw, torch.float64))
            runs, grid = [], []
            for fn, o, rdt in specs:
                c = [t.to(rdt) for t in carries0]
                ys, on_grid = [], True
                for x in xs:
                    y, dc, u0h, u0s, u1h, u2h, h, cc = fn(x.to(rdt), c, **o)
                    c = list(dc) + [u0h, u0s, u1h, u2h] + list(h) + list(cc)
                    ys.append(y)
                    on_grid = on_grid and on_bf16_grid(u0h)
                runs.append([torch.cat(ys, 1)] + c)
                grid.append(on_grid)
            torch.cuda.synchronize()
            chans = (C0, st0["dc"][1].shape[-1], st0["dc"][2].shape[-1],
                     st0["u1h"].shape[-1], st0["u0h"].shape[-1], st0["u2h"].shape[-1],
                     runs[0][0].shape[-1])
            hold(res, label, *runs)
            res[f"{label}_on_bf16_grid"], res[f"{label}_control_on_bf16_grid"] = grid[0], grid[2]
            check_bar(res, label)
            del runs
            x1, c1 = xs[0].to(dt), [t.to(dt) for t in carries0]
            res[f"{label}_ms"] = cuda_ms(lambda: kern(x1, c1, **kw), reps)
            res[f"{label}_plain_ms"] = cuda_ms(lambda: ref(x1, c1, **kw), 2, 1)
            res[f"{label}_bound"] = mixed_bound(*q_dual_path_work(
                center_work(name, F, K, B, chans, H, dt), F, K, B, H, dt, variant,
                tc=dp_plan(dpk, F, K, B, chans[4], H, dt, "int8_hh" in variant).route == "mma"))
    return list(out.values())


def quant_phase(ops, SkiM, dpk, mkk, gen, dev, card, base) -> dict:
    """Phase 2h: the card's dp4a rate (INT8_CORE_OPS), then every int8 /
    bf16-scratch variant against its plain version at full width, its time
    beside the same kernel's f32 / bf16 time from phases 2, 2e, 2g (`base`:
    name -> (f32 ms, bf16 ms)), the bound (int8 on the CUDA cores at
    INT8_CORE_OPS) and the share of it."""
    global INT8_CORE_OPS
    t = time.perf_counter()
    INT8_CORE_OPS = dp4a_rate(ops, dev)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log("2h quantized", f"__dp4a loop: INT8_CORE_OPS {INT8_CORE_OPS:.4e} int8 op/s (a "
        f"multiply-add 2) = {INT8_CORE_OPS / 8 / sms:.4e} dp4a/s per SM; SM clock after "
        f"the loop {clock} [{card}]", t)
    results = {}
    gate_gen = torch.Generator().manual_seed(SEED + 3)   # the earlier cases' data as before
    cases = ([lambda v=v: qskim_case(ops, SkiM, v, 10, gen, dev) for v in QSKIM_VARIANTS]
             + [lambda v=v: qskim_case(ops, SkiM, v, 10, gate_gen, dev, "gate")
                for v in QSKIM_VARIANTS]
             + [lambda v=v: qdp_case(dpk, v, 5, gen, dev) for v in QDP_VARIANTS]
             + [lambda c=c: qcenter_case(mkk, *c, 5, dev) for c in QCENTER_CASES])
    for case in cases:
        t = time.perf_counter()
        got = case()
        for r in (got if isinstance(got, list) else [got]):
            results[r["name"]] = r
            kernel = r["name"].split()[0]
            f32_ms, bf16_ms = base["fused_skim_frames gate" if " gate " in r["name"]
                                   else kernel]
            # int8 products: CUDA cores (__dp4a) in float32, the tensor cores in
            # the bf16 routes (qskim_work, q_dual_path_work)
            int8_note = {lb: ("" if "int8" not in r["name"] else
                              ", int8 on the tensor cores at INT8_TC_OPS"
                              if lb == "bf16" else
                              ", int8 at INT8_CORE_OPS") for lb in ("f32", "bf16")}
            grid = (f"; {r['grid_what']} on the bf16 grid: kernel {r['f32_on_bf16_grid']}, "
                    f"control {r['f32_control_on_bf16_grid']}" if "xscr_half" in r["name"]
                    else "")
            log("2h quantized", f"{r['name']}, {r['shape']}, {Q_CHUNKS} carried chunks: "
                f"kernel vs plain SNR f32 {r['f32_snr_db']:.2f} dB (bar {r['f32_bar_db']:g}; "
                f"control {r['f32_control_snr_db']:.2f}; the f32 plain version against "
                f"itself in f64 {r['f32_floor_snr_db']:.2f}) / bf16 {r['bf16_snr_db']:.2f} dB (bar "
                f"{r['bf16_bar_db']:g}; control {r['bf16_control_snr_db']:.2f}){grid}; "
                + (f"bf16 plan {r['bf16_plan']}; " if "bf16_plan" in r else "")
                + (f"launches by route (option and control) f32 {r['f32_routes']}, bf16 "
                   f"{r['bf16_routes']}; two calls bit-equal; " if "f32_routes" in r else "") +
                "; ".join(
                    f"{lb} ms kernel {r[f'{lb}_ms']:.3f} (the same kernel without the option "
                    f"{ms:.3f}), plain {r[f'{lb}_plain_ms']:.3f}, bound "
                    f"{r[f'{lb}_bound'][0]:.3f} ({r[f'{lb}_bound'][1]}{int8_note[lb]}), share "
                    f"{100 * r[f'{lb}_bound'][0] / r[f'{lb}_ms']:.1f} %"
                    for lb, ms in (("f32", f32_ms), ("bf16", bf16_ms))) + f" [{card}]", t)
    return results


# ------------------------------------------------ phases 3b, 3c, 4b, 4c, 4d
def counter_values(counters):
    return tuple(count_of(mod, attr) for _, mod, attr in counters)


def zero_counters(counters):
    for _, mod, attr in counters:
        zero_count(mod, attr)


def ns_full_width(zoo_name, n_params_want, routes, counters, offline_want, dev, card,
                  phase):
    """The full-width zoo model in f32: NS_STREAMS streams of NS_SECONDS s
    through each route of StreamingNS.step at 16 ms ticks, each equal to
    the offline inference past n_fft samples, with exact launch counts per
    tick (`routes`: (name, step kwargs, launches per tick)) and per
    inference (`offline_want`)."""
    from puresound_tpu_torch.streaming.file_eval import engine_step_options
    from puresound_tpu_torch.streaming.ns_engine import StreamingNS
    from puresound_tpu_torch.zoo.ns import init_model

    t = time.perf_counter()
    model = init_model(zoo_name, device=dev, generator=torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != n_params_want:
        raise AssertionError(f"{zoo_name} has {n_params} parameters")
    engine = StreamingNS.from_offline(model)
    S, n_str, L = 256, NS_STREAMS, int(16000 * NS_SECONDS)
    ticks = L // S
    audio = (0.1 * torch.randn(n_str, L, generator=torch.Generator().manual_seed(SEED))
             ).to(dev)
    n_fft, hop = 512, 128
    names = ", ".join(n for n, _, _ in counters)
    with torch.no_grad():
        zero_counters(counters)
        offline = model.inference(torch.nn.functional.pad(audio, (n_fft - hop, 0)))
        torch.cuda.synchronize()
        expect_launches(counter_values(counters), offline_want,
                        f"{zoo_name} offline inference, ({names})")
        out = {"params": n_params, "model": model, "engine": engine, "ticks": ticks}
        results = {}
        for route, kw, per_tick in routes:
            step_kw, init_kw = engine_step_options(engine, **kw)
            state = engine.init_state(n_str, **init_kw)
            zero_counters(counters)
            ys = []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for k in range(ticks):
                y, state = engine.step(audio[:, k * S:(k + 1) * S], state, **step_kw)
                ys.append(y)
            torch.cuda.synchronize()
            tick_ms = 1e3 * (time.perf_counter() - t1) / ticks
            got = counter_values(counters)
            expect_launches(got, tuple(ticks * w for w in per_tick),
                            f"{zoo_name} {route} route, ({names})")
            streamed = torch.cat(ys, -1)
            a, b = streamed[:, n_fft:], offline[:, n_fft:streamed.shape[-1]]
            err = (a - b).abs()
            bad = (err > 3e-5 + 1e-3 * b.abs()).sum().item()
            if bad or not torch.isfinite(streamed).all():
                raise AssertionError(f"{zoo_name} {route}: {bad} samples past n_fft off the "
                                     f"offline inference (max|d| {err.max().item():.3e})")
            results[route] = (err.max().item(), got, tick_ms)
    out["routes"] = results
    log(phase, f"{zoo_name} f32, {n_params:,} params; {n_str} streams x {NS_SECONDS:g} s "
        f"at 16 ms ticks ({ticks} ticks) == offline inference past n_fft (atol 3e-5, "
        f"rtol 1e-3; offline launches ({names}) {offline_want}): " + "; ".join(
            f"{r} max|d| {e:.3e}, launches {g}, host ms per synced tick {ms:.3f}"
            for r, (e, g, ms) in results.items()) + f" [{card}]", t)
    return out


class PlainCalls:
    """Counts the calls of the kernels' plain versions while it is entered
    (a serving run must make none: every step goes through the kernels)."""

    NAMES = {"skim_stream_kernel": ("fused_skim_frames_ref",),
             "dual_path_kernel": ("dual_path_chunk_ref",),
             "masker_kernel": ("center_chunk_ref", "dparn_center_chunk_ref"),
             "lstm_scan_kernel": ("lstm_scan_ref",),
             "dparn_attention_kernel": ("dparn_intra_pass_ref",)}

    def __enter__(self):
        import importlib

        self.calls, self._saved = 0, []
        for mod_name, fns in self.NAMES.items():
            mod = importlib.import_module(f"puresound_tpu_torch.ops.{mod_name}")
            for fn in fns:
                orig = getattr(mod, fn)
                self._saved.append((mod, fn, orig))

                def counted(*a, _orig=orig, **kw):
                    self.calls += 1
                    return _orig(*a, **kw)

                setattr(mod, fn, counted)
        return self

    def __exit__(self, *exc):
        for mod, fn, orig in self._saved:
            setattr(mod, fn, orig)


def engine_step_ms(engine, mode, options, x, n_slots, reps=10) -> list:
    """The engine step alone at n_slots in bf16, host clock around a synced
    step, NS_WARM untimed steps first: ms of each of `reps` steps."""
    from puresound_tpu_torch.streaming.file_eval import engine_step_options

    step_kw, init_kw = engine_step_options(engine, **mode)
    state = engine.init_state(n_slots, torch.bfloat16, **init_kw)
    step_ms = []
    with torch.no_grad():
        for k in range(NS_WARM + reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, state = engine.step(x, state, **step_kw, **options)
            torch.cuda.synchronize()
            if k >= NS_WARM:
                step_ms.append(1e3 * (time.perf_counter() - t1))
    return step_ms


#: the dual-path passes a tick of bf16 NS serving launches, by route
#: (dual_path_kernel.LAUNCHES_BY_PASS): DPCRN's two blocks run A, B and C,
#: DPARN's wide center the inter pass C of each block
DPCRN_TC_PASSES = {"A:mma": 2, "B:wgmma": 2, "C:mma": 2}
DPARN_TC_PASSES = {"C:mma": 2}


def ns_serving(ns, zoo_name, mode, counters, per_tick, bar_db, n_slots, dev, card, phase,
               options=None, by_option=None, by_path=None, by_pass=None, by_route=None,
               ticks=None):
    """make_session_server(half=True, **mode) for the full-width NS model at
    n_slots sessions: NS_WARM warm-up ticks, then NS_TICKS ticks with
    exact launches, every output finite, 0 underruns; slot 0 in bf16
    against the f32 engine on the same route and audio (bar `bar_db`);
    tick p50/p99 and the engine step alone. `options` (int8_hh /
    xscr_half) are bound to the server's step function, with `by_option` =
    (module, key): that many launches must carry the option and no plain
    version may run. `by_path` = (module, key, launches a tick): every launch
    of the module must take that path (its LAUNCHES_BY_PATH). `by_pass`:
    the dual-path passes a tick launches by route (LAUNCHES_BY_PASS).
    `by_route` = (module, route, launches a tick): every launch of the
    module on that route (its LAUNCHES_BY_ROUTE). `ticks`: the timed ticks
    (NS_TICKS by default). A SIMO (DSS) server's slot returns its M sources
    sample-interleaved, chunk * M samples a tick: each slot's output is
    de-interleaved, and slot 0 held to the bar source by source."""
    from puresound_tpu_torch.ops import dual_path_kernel as dpk
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.streaming.file_eval import engine_step_options
    from puresound_tpu_torch.streaming.server import ServeStats

    t = time.perf_counter()
    options = options or {}
    bundle = make_session_server(ns["model"], None, n_slots=n_slots, chunk_ms=16.0,
                                 half=True, lockstep=True, **mode)
    server, chunk, M = bundle.server, bundle.chunk_samples, bundle.n_sources
    server.step_fn = functools.partial(server.step_fn, **options)
    timed = ticks or NS_TICKS
    n_ticks = NS_WARM + timed
    rng = np.random.default_rng(SEED)
    feed = (0.1 * rng.standard_normal((n_slots, chunk * n_ticks))).astype(np.float32)
    sids = [server.attach() for _ in range(n_slots)]
    width = chunk * M
    served = np.zeros((n_slots, width * n_ticks), np.float32)
    with PlainCalls() as plain:
        for k in range(n_ticks):
            if k == NS_WARM:
                torch.cuda.synchronize()
                server.stats = ServeStats()
                zero_counters(counters)
                if by_option:
                    by_option[0].LAUNCHES_BY_OPTION.clear()
                if by_path:
                    by_path[0].LAUNCHES_BY_PATH.clear()
                if by_route:
                    by_route[0].LAUNCHES_BY_ROUTE.clear()
                dpk.LAUNCHES_BY_PASS.clear()
                plain.calls = 0
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
            if server.tick() != n_slots:
                raise AssertionError(f"tick {k}: not every slot served")
            for i, sid in enumerate(sids):
                got = server.hub.pop_output(sid, width)
                if len(got) != width or not np.isfinite(got).all():
                    raise AssertionError(f"tick {k} slot {sid}: bad output")
                served[i, k * width:(k + 1) * width] = got
        torch.cuda.synchronize()
    launches = counter_values(counters)
    names = ", ".join(n for n, _, _ in counters)
    expect_launches(launches, tuple(timed * w for w in per_tick),
                    f"{zoo_name} serving {n_slots} slots, ({names})")
    expect_launches(plain.calls, 0, f"{zoo_name} serving, plain versions")
    if by_option:
        expect_launches(dict(by_option[0].LAUNCHES_BY_OPTION), {by_option[1]: timed},
                        f"{zoo_name} serving {n_slots} slots, launches by option")
    paths = dict(by_path[0].LAUNCHES_BY_PATH) if by_path else None
    if by_path:
        expect_launches(paths, {by_path[1]: by_path[2] * timed},
                        f"{zoo_name} serving {n_slots} slots, launches by path")
    routes = dict(by_route[0].LAUNCHES_BY_ROUTE) if by_route else None
    if by_route:
        expect_launches(routes, {by_route[1]: by_route[2] * timed},
                        f"{zoo_name} serving {n_slots} slots, launches by route")
    passes = dict(dpk.LAUNCHES_BY_PASS)
    if by_pass is not None:
        expect_launches(passes, {k: v * timed for k, v in by_pass.items()},
                        f"{zoo_name} serving {n_slots} slots, dual-path passes by route")
    # every slot's row de-interleaved into its M sources: [n_slots, M, T]
    sources = served.reshape(n_slots, -1, M).transpose(0, 2, 1)
    stats = server.stats.snapshot()
    if stats["underrun_slot_ticks"] != 0:
        raise AssertionError(f"{stats['underrun_slot_ticks']} underruns")
    # the engine step alone, host clock around a synced step
    step_ms = engine_step_ms(bundle.engine, mode, options,
                             torch.from_numpy(feed[:, :chunk]).to(dev, torch.bfloat16), n_slots)
    step_kw, init_kw = engine_step_options(bundle.engine, **mode)
    with torch.no_grad():
        st = ns["engine"].init_state(1, **init_kw)
        ref = []
        for k in range(n_ticks):
            y, st = ns["engine"].step(torch.from_numpy(
                feed[:1, k * chunk:(k + 1) * chunk]).to(dev), st, **step_kw)
            ref.append(y.reshape(M, chunk))
    ref = torch.cat(ref, -1).cpu()                              # [M, T]
    half_snr = min(snr_db(torch.from_numpy(sources[0, m]), ref[m]) for m in range(M))
    if half_snr < bar_db:
        raise AssertionError(f"{zoo_name} bf16 serving vs f32: SNR {half_snr:.1f} dB < "
                             f"{bar_db:g}")
    opts = ", ".join(f"{k}=True" for k in mode)
    if options:
        opts += "; its step_fn bound to " + ", ".join(f"{k}=True" for k in options)
    log(phase, f"{zoo_name}, make_session_server(half=True, {opts}), {n_slots} sessions, "
        f"{timed} ticks of {chunk} samples after {NS_WARM} warm-up: every output "
        f"finite" + (f", {M} sources a slot ({width} samples a tick, sample-interleaved; "
                     f"every row de-interleaved, {sources.shape})" if M > 1 else "")
        + f", launches ({names}) {launches}"
        + (f", every {by_path[0].__name__.rsplit('.', 1)[-1]} launch on path "
           f"{by_path[1]!r} ({paths})" if by_path else "")
        + (f", dual-path passes by route {passes}" if by_pass is not None else "")
        + (f", every {by_route[0].__name__.rsplit('.', 1)[-1]} launch on route "
           f"{by_route[1]!r} ({routes})" if by_route else "")
        + ", 0 underruns; tick p50 "
        f"{stats['tick_ms_p50']:.3f} ms, p99 {stats['tick_ms_p99']:.3f} ms; engine step "
        f"alone p50 {float(np.median(step_ms)):.3f} ms (min {min(step_ms):.3f}); bf16 slot 0 "
        f"vs the f32 engine SNR {half_snr:.1f} dB{' (the worse source)' if M > 1 else ''} "
        f"(bar {bar_db:g}); plain-version calls {plain.calls} [{card}]", t)
    return {"launches": launches, "tick_p50": stats["tick_ms_p50"],
            "tick_p99": stats["tick_ms_p99"], "step_p50": float(np.median(step_ms)),
            "snr": half_snr, "passes": passes, "routes": routes}


# ------------------------------------------------------------ phases 4e, 4f
TSE_Q_SLOTS = 1024                  # phase 4e: the JAX bench's int8 probes' serving point
TRANSPORT_SLOTS = 256               # phase 4f
Q_BARS = {"int8_hh": 20.0, "int8_full": 15.0}   # JAX's bars (tests/test_pallas_kernels.py)


@torch.no_grad()
def tse_quant_serving(ops, model, option, n_slots, dev, card, label="tse_skim_v0_causal",
                      phase="4e tse quantized", bar=None, ticks=NS_TICKS):
    """Phase 4e (and 4i, 4k): a TSE model through make_session_server(half=True,
    fused=True) at n_slots with its step_fn bound to `option`=True (None:
    no option): the engine step alone (as bench.py's int8 probes time it),
    then NS_WARM + `ticks` server ticks: exact launches (every one with
    the option, no plain version), every output finite, 0 underruns, tick
    p50/p99, and slot 0 against the f32 engine on the same audio (JAX's bar
    for the option, or `bar`)."""
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.streaming.engine import StreamingTSE
    from puresound_tpu_torch.streaming.server import ServeStats

    t = time.perf_counter()
    bf = torch.bfloat16
    engine32 = StreamingTSE.from_offline(model).eval()
    bundle = make_session_server(model, None, n_slots=n_slots, chunk_ms=15.0, half=True,
                                 fused=True, lockstep=True, enroll_len=16000)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    opts = {option: True} if option else {}
    server.step_fn = functools.partial(server.step_fn, **opts)
    n_ticks = NS_WARM + ticks
    rng = np.random.default_rng(SEED)
    enrolls = (0.1 * rng.standard_normal((n_slots, 16000))).astype(np.float32)
    feed = (0.1 * rng.standard_normal((n_slots, chunk * n_ticks))).astype(np.float32)
    dvecs = torch.cat([engine32.embed(torch.from_numpy(enrolls[i:i + 256]).to(dev))
                       for i in range(0, n_slots, 256)])
    # the engine step alone
    x = torch.from_numpy(feed[:, :chunk]).to(dev, bf)
    state = engine.init_state(n_slots, bf)
    step_ms = []
    for k in range(NS_WARM + NS_TICKS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, state = engine.step(x, dvecs.to(bf), state, fused=True, dot_dtype=bf, **opts)
        torch.cuda.synchronize()
        if k >= NS_WARM:
            step_ms.append(1e3 * (time.perf_counter() - t1))
    # the server
    dv = dvecs.float().cpu().numpy()
    sids = [server.attach(dvec=dv[i]) for i in range(n_slots)]
    served = np.zeros_like(feed)
    with PlainCalls() as plain:
        for k in range(n_ticks):
            if k == NS_WARM:
                torch.cuda.synchronize()
                server.stats = ServeStats()
                ops.LAUNCHES = 0
                ops.LAUNCHES_BY_OPTION.clear()
                ops.LAUNCHES_BY_ROUTE.clear()
                plain.calls = 0
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
            if server.tick() != n_slots:
                raise AssertionError(f"tick {k}: not every slot served")
            for i, sid in enumerate(sids):
                got = server.hub.pop_output(sid, chunk)
                if len(got) != chunk or not np.isfinite(got).all():
                    raise AssertionError(f"tick {k} slot {sid}: bad output")
                served[i, k * chunk:(k + 1) * chunk] = got
        torch.cuda.synchronize()
    launches = ops.LAUNCHES
    what = f"{label} {option or 'bf16'} serving"
    expect_launches(launches, ticks, f"{what}, fused_skim_frames")
    expect_launches(dict(ops.LAUNCHES_BY_OPTION), {option or "": ticks},
                    f"{what}, launches by option")
    expect_launches(plain.calls, 0, f"{what}, plain versions")
    routes = dict(ops.LAUNCHES_BY_ROUTE)
    expect_launches(routes, {"mma": ticks}, f"{what}, launches by route")
    stats = server.stats.snapshot()
    if stats["underrun_slot_ticks"] != 0:
        raise AssertionError(f"{stats['underrun_slot_ticks']} underruns")
    st = engine32.init_state(1)
    ref = []
    for k in range(n_ticks):
        y, st = engine32.step(torch.from_numpy(feed[:1, k * chunk:(k + 1) * chunk]).to(dev),
                              dvecs[:1], st, fused=True)
        ref.append(y)
    snr = snr_db(torch.from_numpy(served[0]), torch.cat(ref, -1)[0].cpu())
    bar = Q_BARS[option] if bar is None else bar
    if snr < bar:
        raise AssertionError(f"{what} vs f32: SNR {snr:.1f} dB < {bar:g}")
    bound = f"with its step_fn bound to {option}=True" if option else "(no option)"
    log(phase, f"{label}, make_session_server(half=True, fused=True) "
        f"{bound}, {n_slots} streams: engine step alone p50 "
        f"{float(np.median(step_ms)):.3f} ms (min {min(step_ms):.3f}, {NS_TICKS} synced "
        f"steps); {ticks} server ticks of {chunk} samples after {NS_WARM} warm-up: every "
        f"output finite, fused_skim_frames launches {launches} (all {option or 'no option'}; "
        f"by route {routes}), "
        f"plain-version "
        f"calls {plain.calls}, 0 underruns; tick p50 {stats['tick_ms_p50']:.3f} ms, p99 "
        f"{stats['tick_ms_p99']:.3f} ms; slot 0 vs the f32 engine SNR {snr:.1f} dB (bar "
        f"{bar:g}) [{card}]", t)
    return {"launches": launches, "routes": routes, "tick_p50": stats["tick_ms_p50"],
            "tick_p99": stats["tick_ms_p99"], "step_p50": float(np.median(step_ms)),
            "snr": snr}


GATE_PARAMS = 6_409_240             # the flagship's configuration with Gate fusion
GATE_SLOTS = (256, 1024)            # phase 4i; 1024 again with int8_hh and int8_full
GATE_BF16_BAR = 35.0                # bf16 serving vs the f32 engine, dB (read 43.1 on an H100)


def gate_model(dev, gen):
    """The flagship's configuration (puresound_tpu/zoo/tse.py:157-170) with
    embed_fusion="Gate": no zoo name builds it in either package."""
    from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
    from puresound_tpu_torch.nnet.encoder import FreeEncDec
    from puresound_tpu_torch.nnet.skim import SkiM
    from puresound_tpu_torch.zoo.tse import _tcn_speaker_net

    fk = dict(device=dev, generator=gen)
    return SoTaskWrapModule(
        encoder=FreeEncDec(win_length=32, hop_length=16, laten_length=128,
                           output_active=True, **fk),
        masker=SkiM(input_size=128, hidden_size=256, output_size=128, n_blocks=4,
                    seg_size=150, seg_overlap=False, causal=True, embed_dim=192,
                    embed_norm=True, block_with_embed=(1, 1, 1, 1),
                    embed_fusion="Gate", **fk),
        speaker_net=_tcn_speaker_net(128, **fk), mask_constraint="ReLU").eval()


@torch.no_grad()
def gate_full_width(ops, lk, tk, dev, card):
    """Phase 3g: the Gate model in f32, 4 streams x 20 ticks of 240 samples
    through StreamingTSE.step(fused=True) (one Gate-mode fused_skim_frames
    a tick) and step(fused=False) (SkiM.step_frames), each equal to the
    offline inference (which launches the LSTM kernel 10 times and the TCN
    kernel 5) to 1e-4 of max|y|, as phase 3 holds the flagship."""
    from puresound_tpu_torch.streaming.engine import StreamingTSE, offline_equivalent_input

    t = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    model = gate_model(dev, gen)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != GATE_PARAMS:
        raise AssertionError(f"the Gate model has {n_params} parameters")
    engine = StreamingTSE.from_offline(model).eval()
    S, ticks, n_str = 240, 20, 4
    audio = (0.1 * torch.randn(n_str, S * ticks, generator=gen)).to(dev)
    enroll = (0.1 * torch.randn(n_str, 16000, generator=gen)).to(dev)
    zero_counts(tk)
    dvec = engine.embed(enroll)
    torch.cuda.synchronize()
    expect_launches((tk.FWD_LAUNCHES, tk.BWD_LAUNCHES), (5, 0), "Gate embed, TCN")
    streamed, launches = {}, {}
    for fused in (True, False):
        state = engine.init_state(n_str)
        ops.LAUNCHES = 0
        ops.LAUNCHES_BY_ROUTE.clear()
        outs = []
        for k in range(ticks):
            y, state = engine.step(audio[:, k * S:(k + 1) * S], dvec, state, fused=fused)
            outs.append(y)
        torch.cuda.synchronize()
        launches[fused] = ops.LAUNCHES
        streamed[fused] = torch.cat(outs, -1)
        # float32 dots: the CUDA-core kernel
        expect_launches(dict(ops.LAUNCHES_BY_ROUTE), {"cuda": ticks} if fused else {},
                        f"Gate streamed ticks (fused={fused}), launches by route")
    zero_counts(lk, tk)
    offline = model.inference(offline_equivalent_input(audio, 32, 16),
                              enroll)[:, :streamed[True].shape[-1]]
    torch.cuda.synchronize()
    offline_launches = counts(lk, tk)
    expect_launches(offline_launches, (10, 0, 5, 0), "Gate offline inference, LSTM and TCN")
    expect_launches(launches, {True: ticks, False: 0}, "Gate streamed ticks, fused_skim_frames")
    peak = offline.abs().max().item()
    errs = {}
    for fused, y in streamed.items():
        errs[fused] = (y - offline).abs().max().item()
        if not torch.isfinite(y).all() or errs[fused] > 1e-4 * peak:
            raise AssertionError(f"Gate streamed (fused={fused}) vs offline max|d| "
                                 f"{errs[fused]:.3e} > 1e-4 * max|y| ({peak:.3e})")
    log("3g gate", f"flagship configuration with Gate fusion, {n_params:,} params; {ticks} "
        f"ticks x {S} samples x {n_str} streams == offline inference: fused max|d| "
        f"{errs[True]:.3e}, unfused (step_frames) {errs[False]:.3e}, max|y| {peak:.3e}; "
        f"fused_skim_frames launches {launches[True]} fused, {launches[False]} unfused; "
        f"offline LSTM and TCN launches (fwd, bwd) {offline_launches} [{card}]", t)
    return model


@torch.no_grad()
def transport_phase(ops, model, n_slots, dev, card):
    """Phase 4f: the flagship through make_session_server(half=True,
    fused=True) at n_slots with the float32 transport, with pcm16=True, and
    with pipelined=True + pcm16=True, NS_WARM + NS_TICKS ticks each on the
    same audio: the pipelined outputs bit-equal to the unpipelined pcm16
    ones (one tick later; flush() at the end), pcm16 against the float32
    transport by SNR, the three tick p50 / p99, and the sustained rate: the
    host clock over the whole timed window (every push, tick and pop, then
    a device sync) per tick, so that a tick which returns before its own
    step has run gains nothing it has not earned."""
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.streaming.server import ServeStats

    t = time.perf_counter()
    n_ticks = NS_WARM + NS_TICKS
    rng = np.random.default_rng(SEED + 1)
    enrolls = (0.1 * rng.standard_normal((n_slots, 16000))).astype(np.float32)
    configs = (("float32", {}), ("pcm16", {"pcm16": True}),
               ("pipelined+pcm16", {"pipelined": True, "pcm16": True}))
    out, feed, dvecs = {}, None, None
    for label, kw in configs:
        bundle = make_session_server(model, None, n_slots=n_slots, chunk_ms=15.0, half=True,
                                     fused=True, lockstep=True, enroll_len=16000, **kw)
        server, chunk = bundle.server, bundle.chunk_samples
        if feed is None:
            feed = (0.1 * rng.standard_normal((n_slots, chunk * n_ticks))).astype(np.float32)
            dvecs = bundle.embed_fn(enrolls).float().cpu().numpy()
        sids = [server.attach(dvec=dvecs[i]) for i in range(n_slots)]
        served = [[] for _ in range(n_slots)]
        for k in range(n_ticks):
            if k == NS_WARM:
                torch.cuda.synchronize()
                server.stats = ServeStats()
                ops.LAUNCHES = 0
                ops.LAUNCHES_BY_ROUTE.clear()
                t_win = time.perf_counter()
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
            n_out = server.tick()
            if n_out != (n_slots if k or not kw.get("pipelined") else 0):
                raise AssertionError(f"{label} tick {k}: {n_out} outputs")
            for i, sid in enumerate(sids):
                served[i].append(server.hub.pop_output(sid, chunk))
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t_win) / NS_TICKS
        launches = ops.LAUNCHES
        expect_launches(launches, NS_TICKS, f"{label} serving, fused_skim_frames")
        expect_launches(dict(ops.LAUNCHES_BY_ROUTE), {"mma": NS_TICKS},
                        f"{label} serving, fused_skim_frames launches by route")
        if kw.get("pipelined") and server.flush() != n_slots:
            raise AssertionError("flush() did not scatter the last tick")
        for i, sid in enumerate(sids):
            served[i].append(server.hub.pop_output(sid, chunk))
        served = np.stack([np.concatenate(s) for s in served])
        if served.shape[1] != chunk * n_ticks or not np.isfinite(served).all():
            raise AssertionError(f"{label}: {served.shape} outputs, or non-finite")
        out[label] = (served, server.stats.snapshot(), launches, window_ms)
    pcm, piped = out["pcm16"][0], out["pipelined+pcm16"][0]
    if not np.array_equal(pcm, piped):
        raise AssertionError(f"pipelined outputs differ from unpipelined: max|d| "
                             f"{np.abs(pcm - piped).max():.3e}")
    snr = snr_db(torch.from_numpy(pcm), torch.from_numpy(out["float32"][0]))
    log("4f transport", f"tse_skim_v0_causal, make_session_server(half=True, fused=True) at "
        f"{n_slots} sessions, {NS_TICKS} ticks after {NS_WARM} warm-up each: " + "; ".join(
            f"{label} tick p50 {st['tick_ms_p50']:.3f} ms, p99 {st['tick_ms_p99']:.3f} ms, "
            f"window {w:.3f} ms per tick ({n_slots * chunk / 16.0 / w:.1f} x real time, "
            f"{chunk / 16.0:g} ms of audio a slot and tick), launches {n} (all on the "
            "tensor-core route)"
            for label, (_, st, n, w) in out.items())
        + f"; pipelined + pcm16 outputs bit-equal to unpipelined pcm16 ({pcm.size:,} "
        f"samples); pcm16 vs float32 transport SNR {snr:.1f} dB [{card}]", t)
    return {label: {"tick_p50": st["tick_ms_p50"], "tick_p99": st["tick_ms_p99"],
                    "window_ms_per_tick": w, "launches": n}
            for label, (_, st, n, w) in out.items()} | {"pcm16_snr": snr}


# ------------------------------------------------------------ phases 5-6
def train_parts(dev, gen, dtype=torch.float32):
    """(flagship with the SI-SNR loss, TrainState, step) on `dev`."""
    from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
    from puresound_tpu_torch.parallel import TrainState, adam, make_train_step
    from puresound_tpu_torch.zoo import init_tse_model

    model = init_tse_model("tse_skim_v0_causal",
                           sig_loss=SDRLoss.init_mode("sisnr"), device=dev,
                           generator=gen)
    step = make_train_step(model, grad_clip=10.0,
                           compute_dtype=None if dtype == torch.float32 else dtype)
    return model, TrainState.create(model, adam(1e-3)), step


def train_batch(B: int, seconds: float, dev) -> dict:
    rng = np.random.default_rng(SEED)
    L = int(16000 * seconds)
    return {k: torch.from_numpy((0.1 * rng.standard_normal((B, L))
                                 ).astype(np.float32)).to(dev)
            for k in ("noisy", "enroll", "ref_clean")}


def card_vs_cpu_step(lk, tk, dev, card):
    """One f32 training step of the flagship (B=2 x 1 s) on the card
    (kernels) held against the same step on the CPU (plain versions) in
    float64, with the CPU's own f32 step beside it, from the same weights."""
    t = time.perf_counter()
    sides = []
    for d, dt in ((dev, torch.float32), (torch.device("cpu"), torch.float32),
                  (torch.device("cpu"), torch.float64)):
        model, state, step = train_parts(d, torch.Generator().manual_seed(SEED))
        model.to(dt)
        zero_counts(lk, tk)
        state, m = step(state, {k: v.to(dt)
                                for k, v in train_batch(2, 1.0, d).items()})
        sides.append(({n: (p.detach().cpu().double(), p.grad.cpu().double())
                       for n, p in model.named_parameters()},
                      {k: float(v) for k, v in m.items()}, counts(lk, tk)))
    (gpu, gm, gl), (cpu, cm, cl), (ref, rm, _) = sides
    expect_launches(gl, (10, 10, 5, 5), "card step, LSTM and TCN (fwd, bwd)")
    expect_launches(cl, (0, 0, 0, 0), "CPU step, LSTM and TCN (fwd, bwd)")
    loss_rel = abs(gm["loss"] - rm["loss"]) / abs(rm["loss"])
    norm_rel = abs(gm["grad_norm"] - rm["grad_norm"]) / rm["grad_norm"]
    if not loss_rel <= 1e-4 or not norm_rel <= 1e-3:
        raise AssertionError(f"loss rel {loss_rel:.3e} > 1e-4 or grad_norm rel "
                             f"{norm_rel:.3e} > 1e-3")
    g_all = max(g.abs().max().item() for _, g in ref.values())
    worst = {"card": (0.0, ""), "cpu f32": (0.0, "")}
    worst_p, flips, over = 0.0, 0, []
    for n, (p64, g64) in ref.items():
        gmax = g64.abs().max().item()
        if gmax <= 1e-6 * g_all:
            continue    # an exact zero gradient (ASP's conv bias ahead of its softmax)
        for key, side in (("card", gpu), ("cpu f32", cpu)):
            rel = (side[n][1] - g64).abs().max().item() / gmax
            worst[key] = max(worst[key], (rel, n))
        rel = (gpu[n][1] - g64).abs().max().item() / gmax
        if rel > 1e-3:
            over.append(f"{n} {rel:.2e}")
        if rel > 3e-3:
            raise AssertionError(f"grad {n}: max|d|/max|ref| {rel:.3e} > 3e-3")
        # Adam's first step moves each weight by about lr * sign(g): where
        # |g| is within the gradient bar its sign, and so the update, may
        # differ by up to 2 lr; elsewhere the bar is 1e-3 max|ref|
        d = (gpu[n][0] - p64).abs()
        pmax = p64.abs().max().item()
        small = g64.abs() <= 3e-3 * gmax
        if (~small).any():
            worst_p = max(worst_p, d[~small].max().item() / pmax)
        flips += int((d[small] > 1e-3 * pmax).sum())
        if (d[~small] > 1e-3 * pmax).any() or (d[small] > 2e-3 + 1e-6).any():
            raise AssertionError(f"param {n}: updated weights differ")
    log("5 train step", f"flagship B=2 x 1 s, f32 on the card vs f64 on the "
        f"CPU: loss {gm['loss']:.6f} / {rm['loss']:.6f} (rel {loss_rel:.2e}), "
        f"grad_norm rel {norm_rel:.2e}; worst grad max|d|/max|ref| card "
        f"{worst['card'][0]:.2e} ({worst['card'][1]}), CPU f32 "
        f"{worst['cpu f32'][0]:.2e} ({worst['cpu f32'][1]}); card tensors over "
        f"1e-3 (bar 3e-3): {over or 'none'}; updated params {worst_p:.2e} (bar "
        f"1e-3; {flips} weights with |g| <= 3e-3 max|g| apart by <= 2 lr); LSTM "
        f"and TCN launches fwd/bwd {gl} on the card, TF32 off [{card}]", t)


def device_share(prof, pattern: str, top: int = 6):
    """(device ms of kernels whose name holds `pattern`, all kernels' device
    ms, the `top` kernels as (ms, name)) from a torch.profiler run, or
    (None, None, []) when it recorded no device time."""
    from torch.autograd import DeviceType

    mine = total = 0.0
    kernels = []
    for e in prof.key_averages():
        # kernels only: a user annotation (e.g. the optimizer's step range)
        # also shows on the device timeline and would count its kernels twice
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        total += us
        kernels.append((us / 1e3, e.key))
        if pattern in e.key:
            mine += us
    if total == 0:
        return None, None, []
    return mine / 1e3, total / 1e3, sorted(kernels, reverse=True)[:top]


def full_width_training(lk, tk, dev, card, dtype):
    """The flagship at B=64 x 2 s: 2 warm-up steps, 5 timed steps, 2
    profiled steps; every step runs 10 LSTM scans and 5 TCN blocks forward
    and backward."""
    t = time.perf_counter()
    B, seconds, warm, timed, profiled = TRAIN_B, TRAIN_SECONDS, 2, 5, 2
    model, state, step = train_parts(dev, torch.Generator().manual_seed(SEED), dtype)
    batch = train_batch(B, seconds, dev)
    first = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms = [], [], []
    zero_counts(lk, tk)
    for i in range(warm + timed):
        seen = counts(lk, tk)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        torch.cuda.synchronize()
        expect_launches(tuple(a - b for a, b in zip(counts(lk, tk), seen)),
                        (10, 10, 5, 5), f"training step {i}, LSTM and TCN (fwd, bwd)")
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i >= warm:
            times.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"non-finite loss {losses} or grad_norm {norms}")
    moved = sum(not torch.equal(first[n], p.detach())
                for n, p in model.named_parameters())
    if moved != len(first):
        raise AssertionError(f"{len(first) - moved} parameter tensors did not move")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            state, m = step(state, batch)
        torch.cuda.synchronize()
    launches = counts(lk, tk)
    lstm_ms, device_ms, top = device_share(prof, "lstm_")
    tcn_ms = device_share(prof, "tcn_")[0]
    p50 = float(np.median(times))
    label = "f32" if dtype == torch.float32 else "bf16"
    share = ("not measured (the profiler saw no device time)" if device_ms is None
             else f"LSTM {lstm_ms:.3f} ({100 * lstm_ms / device_ms:.1f} %), TCN "
             f"{tcn_ms:.3f} ({100 * tcn_ms / device_ms:.1f} %) of {device_ms:.3f} ms "
             f"over {profiled} steps; top kernels: " + "; ".join(
                 f"{ms:.3f} ms {name[:60]}" for ms, name in top))
    log("6 training", f"flagship {label} B={B} x {seconds:g} s, Adam 1e-3, clip "
        f"10: loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad_norm "
        f"{norms[-1]:.4f}, all {moved} parameter tensors moved; 10 + 10 LSTM "
        f"and 5 + 5 TCN launches per step; step p50 {p50:.3f} ms (min "
        f"{min(times):.3f}, max {max(times):.3f}), {B * seconds * 1e3 / p50:.1f} "
        f"audio-s/s; peak {peak / 2**30:.2f} GiB; kernels' device time {share} "
        f"[{card}]", t)
    return {"step_ms_p50": p50, "peak_bytes": peak, "lstm_ms": lstm_ms,
            "tcn_ms": tcn_ms, "device_ms": device_ms, "launches": launches}


# ------------------------------------------------------------ phase 6b
#: phase 6c: the switches of the training LSTM path, set through the module
#: attributes inside the phase and restored after it
TRAIN_SETTINGS = {"FUSED_PROJ_SCAN=False": dict(fused_proj=False, tm=False),
                  "TM_BLOCKS=True": dict(fused_proj=True, tm=True),
                  "both": dict(fused_proj=False, tm=True)}
#: LSTM launches a step by entry, forward and backward alike: the flagship's
#: 4 SegLSTM scans (time-major under TM_BLOCKS) and 6 MemLSTM scans
SETTING_ENTRIES = {"FUSED_PROJ_SCAN=False": {"hoisted": 10},
                   "TM_BLOCKS=True": {"fp_tm": 4, "fp": 6},
                   "both": {"hoisted": 10}}
#: against the default route's step from the same weights and batch, by
#: dtype and route: "same" (TM_BLOCKS=True alone, the default arithmetic in
#: another layout) and "hoisted" (xp by one matmul; rounded to bf16 under
#: bf16, where the fused kernel never rounds it): (the loss's relative
#: difference, the gradient's cosine over all parameters, each leaf's
#: max|d| / max|ref| except the scalar PReLU slopes, each slope's |d| /
#: |ref|). A slope's gradient is one sum over B x Ch x T terms that cancel,
#: and a ReLU / PReLU input within rounding of 0 that takes the other side
#: moves every gradient below it, so another rounding upstream moves leaves
#: far more than the loss. Readings on an H100, worst setting, two
#: calls: f32 same 0 / 1.0000000 / 1.0e-6 / 0; f32 hoisted 1.5e-7 /
#: 0.9999997 / 4.2e-3 (masker.output_fc.1.weight, the conv under the ReLU
#: mask) / 8.6e-3 (speaker_net.2.dconv.0.pointwise.2.weight), both calls
#: alike; bf16, which differs between calls: same 0 / 0.99998 / 1.7e-2 -
#: 2.4e-2 / 0.37 - 1.29, hoisted 5.1e-3 (one bf16 ulp) / 0.981 / 0.61 / 8.5
#: - 32.5 (speaker_net.0.in_conv.2.weight), so no slope bar in bf16 (and a
#: leaf of the opposite sign reads 2). Those readings were taken with
#: cuDNN's default algorithms, whose Conv1d weight gradient differs between
#: two calls of one step; one bf16 "same" reading fell to cosine 0.99989
#: that way. Both steps of a comparison now run with cuDNN deterministic.
SETTING_BARS = {("f32", "same"): (1e-5, 0.99999, 1e-4, 1e-4),
                ("f32", "hoisted"): (1e-5, 0.99999, 1e-2, 3e-2),
                ("bf16", "same"): (2e-2, 0.9999, 0.1, None),
                ("bf16", "hoisted"): (2e-2, 0.95, 1.5, None)}


def prelu_slopes(model) -> set:
    """The names of the model's scalar PReLU slopes."""
    from puresound_tpu_torch.nnet.lobe.activation import PReLU

    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, PReLU) and m.weight.numel() == 1}


def leaf_readings(grads, ref_g, slopes):
    """[(max|d| / max|ref|, name)] of every leaf, worst first, split into
    (the other leaves, the PReLU slopes); leaves whose reference is an exact
    zero (ASP's conv bias) are left out."""
    g_all = max(g.abs().max().item() for g in ref_g.values())
    rows = []
    for n, g in grads.items():
        gmax = ref_g[n].abs().max().item()
        if gmax > 1e-6 * g_all:
            rows.append(((g - ref_g[n]).abs().max().item() / gmax, n))
    rows.sort(reverse=True)
    return [r for r in rows if r[1] not in slopes], [r for r in rows if r[1] in slopes]


class lstm_switches:
    """`nnet.lobe.rnn.FUSED_PROJ_SCAN` and `nnet.skim.TM_BLOCKS` set for a
    `with` block, restored after it."""

    def __init__(self, fused_proj=True, tm=False):
        self.want = (fused_proj, tm)

    def __enter__(self):
        from puresound_tpu_torch.nnet import skim
        from puresound_tpu_torch.nnet.lobe import rnn

        self.mods = rnn, skim
        self.prev = rnn.FUSED_PROJ_SCAN, skim.TM_BLOCKS
        rnn.FUSED_PROJ_SCAN, skim.TM_BLOCKS = self.want

    def __exit__(self, *exc):
        rnn, skim = self.mods
        rnn.FUSED_PROJ_SCAN, skim.TM_BLOCKS = self.prev


@contextlib.contextmanager
def deterministic_cudnn():
    """`torch.backends.cudnn.deterministic` set for a `with` block, restored
    after it: cuDNN's default Conv1d weight-gradient algorithm accumulates in
    an order that changes between calls (phase 6c's determinism probe)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def one_step(dev, dtype, batch):
    """(loss, {name: gradient in float32}, (model, state, step)) after one
    step of a fresh flagship from SEED."""
    model, state, step = train_parts(dev, torch.Generator().manual_seed(SEED), dtype)
    state, m = step(state, batch)
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
    return float(m["loss"]), grads, (model, state, step)


def entry_counts(lk) -> tuple:
    """(forward, backward) LSTM launches by entry."""
    return dict(lk.FWD_BY_ENTRY), dict(lk.BWD_BY_ENTRY)


def entry_diff(now: dict, seen: dict) -> dict:
    return {e: n - seen.get(e, 0) for e, n in now.items() if n != seen.get(e, 0)}


def train_settings_phase(lk, tk, dev, card):
    """Phase 6c: the full-width flagship step (B=64 x 2 s) under each of
    TRAIN_SETTINGS, f32 and bf16: loss and every gradient against the
    default route's step from the same weights and batch (SETTING_BARS),
    both steps with cuDNN deterministic, so that the comparison sees the
    route and not cuDNN's order of accumulation; the timed steps run with
    cuDNN as the caller set it. The LSTM launches by entry against SETTING_ENTRIES in every step, step
    p50 over 5 timed steps after 1, and the memory peak. The launches by
    entry of the 7 steps are returned for the kernels line."""
    results = {}
    batch = train_batch(TRAIN_B, TRAIN_SECONDS, dev)
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with deterministic_cudnn():
            ref_loss, ref_g, (model, _, _) = one_step(dev, dt, batch)
        slopes = prelu_slopes(model)
        del model
        for setting, kw in TRAIN_SETTINGS.items():
            t = time.perf_counter()
            want = SETTING_ENTRIES[setting]
            bars = SETTING_BARS[(label, "same" if kw["fused_proj"] else "hoisted")]
            with lstm_switches(**kw):
                torch.cuda.reset_peak_memory_stats()
                zero_counts(lk, tk)
                with deterministic_cudnn():
                    loss, grads, (model, state, step) = one_step(dev, dt, batch)
                    torch.cuda.synchronize()
                expect_launches(entry_counts(lk), (want, want),
                                f"{setting} {label} step, LSTM launches (fwd, bwd) by entry")
                expect_launches(counts(lk, tk), (10, 10, 5, 5),
                                f"{setting} {label} step, LSTM and TCN (fwd, bwd)")
                loss_rel = abs(loss - ref_loss) / abs(ref_loss)
                others, slope_rows = leaf_readings(grads, ref_g, slopes)
                dot = sum((g.double() * ref_g[n].double()).sum().item()
                          for n, g in grads.items())
                norm2 = lambda gs: sum(g.double().pow(2).sum().item() for g in gs)
                cosine = dot / math.sqrt(norm2(grads.values()) * norm2(ref_g.values()))
                loss_bar, cos_bar, leaf_bar, slope_bar = bars
                if not (loss_rel <= loss_bar and cosine >= cos_bar
                        and others[0][0] <= leaf_bar
                        and (slope_bar is None or slope_rows[0][0] <= slope_bar)):
                    raise AssertionError(
                        f"{setting} {label}: loss rel {loss_rel:.3e}, cosine "
                        f"{cosine:.7f}, worst leaves {others[:3]}, worst slopes "
                        f"{slope_rows[:3]} (bars {bars})")
                times = []
                for i in range(6):
                    seen, seen_e = counts(lk, tk), entry_counts(lk)
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    state, m = step(state, batch)
                    b.record()
                    torch.cuda.synchronize()
                    expect_launches(tuple(x - y for x, y in zip(counts(lk, tk), seen)),
                                    (10, 10, 5, 5), f"{setting} {label} step {i}")
                    expect_launches(tuple(entry_diff(x, y) for x, y in
                                          zip(entry_counts(lk), seen_e)),
                                    (want, want), f"{setting} {label} step {i} by entry")
                    if not math.isfinite(float(m["loss"])):
                        raise AssertionError(f"{setting} {label}: non-finite loss")
                    if i:
                        times.append(a.elapsed_time(b))
                peak = torch.cuda.max_memory_allocated()
                fwd_by, bwd_by = entry_counts(lk)
            p50 = float(np.median(times))
            results[(label, setting)] = {"step_ms_p50": p50, "peak_bytes": peak,
                                         "loss_rel": loss_rel, "leaf_rel": others[0],
                                         "slope_rel": slope_rows[0], "cosine": cosine,
                                         "fwd_launches": fwd_by, "bwd_launches": bwd_by}
            fmt = lambda rows: ", ".join(f"{n} {r:.2e}" for r, n in rows)
            log("6c settings", f"flagship {label} B={TRAIN_B} x {TRAIN_SECONDS:g} s under "
                f"{setting}: loss {loss:.6f} vs default {ref_loss:.6f} (rel {loss_rel:.2e}), "
                f"gradient cosine {cosine:.7f}, max|d|/max|ref| of the worst leaves "
                f"{fmt(others[:3])}, of the worst PReLU slopes {fmt(slope_rows[:3])} (bars "
                f"{bars}); LSTM launches in 7 steps by entry, forward "
                f"{fwd_by}, backward {bwd_by}, TCN 5 + 5 a step; step p50 "
                f"{p50:.3f} ms (min {min(times):.3f}, max {max(times):.3f}), "
                f"{TRAIN_B * TRAIN_SECONDS * 1e3 / p50:.1f} audio-s/s; peak "
                f"{peak / 2**30:.2f} GiB [{card}]", t)
            del model, state, step, grads
        del ref_g
        torch.cuda.empty_cache()
    return results


def step_determinism(dev, card):
    """Phase 6c's probe of the training step's determinism: the flagship's
    forward and backward at B=64 x 2 s as `make_train_step`'s micro-batch runs
    them (parameters cast to the compute dtype, `functional_call`,
    `torch.autograd.grad`), twice from the same weights on one batch, in f32
    and bf16, then again with cuDNN held to its deterministic algorithms
    (`torch.backends.cudnn.deterministic`, restored after). Forward hooks
    record every leaf module's output and the order the modules ran in. The
    first module whose output differs is a forward op that is not
    deterministic; with every output equal, the module that ran last among
    those whose parameter gradients differ is next to the backward op that
    is not (its gradient flows to every module that ran before it). Returns
    {(dtype label, cuDNN deterministic): (first differing output, that last
    module, number of differing gradients)}."""
    from torch.func import functional_call

    batch = train_batch(TRAIN_B, TRAIN_SECONDS, dev)
    found = {}
    prev = torch.backends.cudnn.deterministic
    for label, dt, det in (("f32", torch.float32, False), ("bf16", torch.bfloat16, False),
                           ("f32", torch.float32, True), ("bf16", torch.bfloat16, True)):
        t = time.perf_counter()
        torch.backends.cudnn.deterministic = det
        model, _, _ = train_parts(dev, torch.Generator().manual_seed(SEED), dt)
        model.train()
        leaves = [(n, m) for n, m in model.named_modules() if not list(m.children())]
        cast = (lambda v: v.to(dt) if v.dtype == torch.float32 else v)
        runs = []
        for _ in range(2):
            outs, seen = {}, []

            def hook(mod, inp, out, name=None):
                first = out[0] if isinstance(out, tuple) else out
                if isinstance(first, torch.Tensor) and name not in outs:
                    outs[name] = first.detach().clone()
                    seen.append(name)

            handles = [m.register_forward_hook(functools.partial(hook, name=n))
                       for n, m in leaves]
            params = dict(model.named_parameters())
            tensors = {n: cast(p) for n, p in params.items()}
            tensors.update({n: cast(b.clone()) for n, b in model.named_buffers()})
            out = functional_call(model, tensors, (), {k: cast(v) for k, v in batch.items()},
                                  strict=True)
            loss = out[0] if isinstance(out, tuple) else out
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            torch.cuda.synchronize()
            for h in handles:
                h.remove()
            runs.append((outs, seen, dict(zip(params, grads))))
        (o1, seen, g1), (o2, _, g2) = runs
        first_out = next((n for n in seen if not torch.equal(o1[n], o2[n])), None)
        diff = [n for n in g1 if g1[n] is not None and not torch.equal(g1[n], g2[n])]
        ran = {n: i for i, n in enumerate(seen)}
        owner = lambda pname: pname.rsplit(".", 1)[0]
        last = max(diff, key=lambda n: ran.get(owner(n), -1)) if diff else None
        found[(label, det)] = (first_out, last, len(diff))
        log("6c determinism", f"flagship {label} B={TRAIN_B} x {TRAIN_SECONDS:g} s, cuDNN "
            f"deterministic {det}: forward and backward twice from one state, "
            f"{len(seen)} leaf-module outputs, first differing {first_out}; {len(diff)} of "
            f"{len(g1)} parameter gradients differ"
            + (f", the module that ran last among them {owner(last)} (max|d| "
               f"{(g1[last] - g2[last]).abs().max().item():.3e}); run order of the hooked "
               f"modules: {' > '.join(seen[-4:])}" if last else "")
            + f" [{card}]", t)
        del model, runs
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = prev
    return found


def write_tse_manifest(folder: str, n: int, seed: int, n_spk: int = 7,
                       vad: bool = False) -> str:
    """A synthetic TSE manifest folder (the recipe's five files) of n
    mixtures of 4 s and 6 s enrollments at 16 kHz, keys mix_<i>_s1, target
    speaker sp<i mod n_spk>; `vad`: a PVAD set, the target active in
    alternate quarter seconds and its 0 / 1 frame labels as ref2vad."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    lines = {f: [] for f in ("wav2scp", "wav2ref", "ref2list", "ref2spk", "wav2spk")
             + (("ref2vad",) if vad else ())}
    sr = 16000
    for i in range(n):
        active = (np.arange(4 * sr) // (sr // 4) + i) % 2 if vad else 1.0
        clean = 0.1 * rng.standard_normal(4 * sr) * active
        sigs = {"mix": clean + 0.05 * rng.standard_normal(4 * sr), "clean": clean,
                "enroll": 0.1 * rng.standard_normal(6 * sr)}
        if vad:
            sigs["vad"] = active.astype(np.float64)
        for name, sig in sigs.items():
            wavfile.write(os.path.join(folder, f"{name}_{i}.wav"), sr,
                          np.clip(sig * 32768, -32768, 32767).astype(np.int16))
        key = f"mix_{i}_s1"
        path = lambda name: os.path.join(folder, f"{name}_{i}.wav")
        lines["wav2scp"].append(f"{key} {path('mix')}")
        lines["wav2ref"].append(f"{key} {path('clean')}")
        lines["ref2list"].append(f"{key} {path('enroll')}")
        lines["ref2spk"].append(f"{key} sp{i % n_spk}")
        lines["wav2spk"].append(f"{key} sp{i % n_spk}-sp{(i + 3) % n_spk}")
        if vad:
            lines["ref2vad"].append(f"{key} {path('vad')}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


def write_ns_manifest(folder: str, n: int, seed: int) -> str:
    """A synthetic NS manifest folder (wav2scp / wav2ref) of n noisy / clean
    pairs of 4 s at 16 kHz, keys utt_<i>."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    scp, ref = [], []
    sr = 16000
    for i in range(n):
        clean = 0.1 * rng.standard_normal(4 * sr)
        for name, sig, lines in (("noisy", clean + 0.05 * rng.standard_normal(4 * sr), scp),
                                 ("clean", clean, ref)):
            path = os.path.join(folder, f"{name}_{i}.wav")
            wavfile.write(path, sr, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
            lines.append(f"utt_{i} {path}")
    for name, lines in (("wav2scp", scp), ("wav2ref", ref)):
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return folder


def serving_counters():
    """The serving kernels' launch counts: a training step launches none
    (JAX's training forward reaches no Pallas kernel but the LSTM and TCN
    training kernels)."""
    from puresound_tpu_torch.ops import dparn_attention_kernel as dak
    from puresound_tpu_torch.ops import dual_path_kernel as dpk
    from puresound_tpu_torch.ops import lstm_scan_kernel as lsk
    from puresound_tpu_torch.ops import masker_kernel as mkk
    from puresound_tpu_torch.ops import skim_stream_kernel as ops

    return [("fused_skim_frames", ops, "LAUNCHES"), ("lstm_scan", lsk, "LAUNCHES"),
            ("dual_path_chunk", dpk, "LAUNCHES"), ("dparn_intra_pass", dak, "LAUNCHES"),
            ("center_chunk / dparn_center_chunk", mkk, "LAUNCHES")]


def run_recipe(lk, tk, module: str, cfg: str, backend: str) -> dict:
    """`python -m <module> <cfg> --action train --backend <backend>`, run in
    this process with `runpy` so the launch counts are read here. Each train
    step is timed on the host clock with the card synchronised before and
    after it; the gap between two steps is the host's time in which the card
    has nothing queued, split into the wait for the loader's next batch, the
    batch's copy to the card, and the rest (logging the step's metrics)."""
    import runpy

    from puresound_tpu_torch.tasks import base, ns

    trainers, spans, waits, copies = [], [], [], []
    build, loader_iter = ns.NsTask._build_steps, base.DataLoader.__iter__

    def timed_iter(self):
        batches = loader_iter(self)
        while True:
            t1 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            waits.append(time.perf_counter() - t1)
            yield batch

    def timed_build(self):
        build(self)
        trainers.append(self)
        step, to_card = self._train_step, self._batch_kwargs

        def timed_copy(batch):
            t1 = time.perf_counter()
            out = to_card(batch)
            copies.append(time.perf_counter() - t1)
            return out

        def timed(state, batch, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = step(state, batch, **kw)
            torch.cuda.synchronize()
            spans.append((t1, time.perf_counter()))
            return out

        self._train_step, self._batch_kwargs = timed, timed_copy

    serving = serving_counters()
    argv = sys.argv
    sys.argv = [module, cfg, "--action", "train", "--backend", backend]
    ns.NsTask._build_steps, base.DataLoader.__iter__ = timed_build, timed_iter
    zero_counts(lk, tk)
    zero_counters(serving)
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        torch.cuda.synchronize()
    finally:
        ns.NsTask._build_steps, base.DataLoader.__iter__ = build, loader_iter
        sys.argv = argv
    trainer = trainers[0]
    with open(os.path.join(trainer.hparam["TRAIN"]["log_dir"], "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    return {"trainer": trainer, "spans": spans, "waits": waits, "copies": copies,
            "launches": counts(lk, tk), "serving": counter_values(serving),
            "losses": [r["value"] for r in logged if r["name"] == "train/batch_loss"],
            "dev_loss": [r["value"] for r in logged if r["name"] == "train/avg_dev_loss"]}


def recipe_checks(res: dict, steps: int, dev, fresh, label: str):
    """Finite losses, one per step and one dev average, training on the
    card, no serving kernel launched, and `epoch_0.ckpt` reloading equal
    into `fresh` (a model of the recipe's configuration)."""
    losses, dev_loss = res["losses"], res["dev_loss"]
    if (len(losses) != steps or len(dev_loss) != 1
            or not np.isfinite(losses + dev_loss).all()):
        raise AssertionError(f"{label}: losses {losses}, dev {dev_loss}")
    trainer = res["trainer"]
    if trainer.device.type != dev.type:
        raise AssertionError(f"{label}: trained on {trainer.device}")
    if any(res["serving"]):
        raise AssertionError(f"{label}: serving kernels launched {res['serving']}")
    save_dir = trainer.hparam["TRAIN"]["model_save_dir"]
    tree = torch.load(os.path.join(save_dir, "epoch_0.ckpt"), map_location=dev,
                      weights_only=True)
    fresh.load_state_dict({**tree["params"], **tree["batch_stats"]}, strict=True)
    for (n, a), b in zip(trainer.model.state_dict().items(), fresh.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: checkpoint tensor {n} differs after reload")
    with open(os.path.join(save_dir, "epoch_0.info")) as f:
        return f.read().split("\n")


def step_gaps(res: dict, steps: int, warm: int) -> dict:
    """Step ms, the host gaps between steps and their split (the first
    `steps` waits and copies are the train loader's), p50 over the steps
    after `warm`."""
    spans = res["spans"]
    step_ms = [1e3 * (b - a) for a, b in spans]
    gap_ms = [1e3 * (spans[i + 1][0] - spans[i][1]) for i in range(steps - 1)]
    window = 1e3 * (spans[-1][1] - spans[warm][0])
    # the gap before step i holds the wait for batch i and its copy
    wait_ms = [1e3 * res["waits"][i + 1] for i in range(steps - 1)]
    copy_ms = [1e3 * res["copies"][i + 1] for i in range(steps - 1)]
    rest_ms = [g - a - b for g, a, b in zip(gap_ms, wait_ms, copy_ms)]
    p50 = lambda v: float(np.median(v[warm:]))
    return {"step_ms": step_ms, "gap_ms": gap_ms, "wait_ms": wait_ms, "copy_ms": copy_ms,
            "busy": sum(step_ms[warm:]) / window, "window_ms": window,
            "step_p50": float(np.median(step_ms[warm:])), "gap_p50": p50(gap_ms),
            "wait_p50": p50(wait_ms), "copy_p50": p50(copy_ms), "rest_p50": p50(rest_ms)}


def gap_text(g: dict, steps: int, warm: int, audio_s: float) -> str:
    sm = g["step_ms"][warm:]
    return (f"synced step ms over steps {warm}-{steps - 1}: p50 {g['step_p50']:.3f} (min "
            f"{min(sm):.3f}, max {max(sm):.3f}), {audio_s * 1e3 / g['step_p50']:.1f} "
            f"audio-s/s; the untimed first steps {[round(x, 3) for x in g['step_ms'][:warm]]}; "
            f"host gap between steps p50 {g['gap_p50']:.3f} ms (max "
            f"{max(g['gap_ms'][warm:]):.3f}): loader wait p50 {g['wait_p50']:.3f}, copy to "
            f"the card {g['copy_p50']:.3f}, the rest {g['rest_p50']:.3f}; steps fill "
            f"{100 * g['busy']:.1f} % of the {g['window_ms']:.1f} ms from step {warm}'s "
            "start to the last step's end")


def recipe_phase(lk, tk, dev, card, backend: str = "cuda"):
    """Phase 6b: the TSE recipe on a config of its own (TSE.yaml's defaults:
    SI-SNR, alpha 10, 3 s, fixed_length 5 s enrollment, batch 12, no speaker
    loss), the flagship at full width, 4 fork'd loader workers, one epoch of
    RECIPE_STEPS train batches and 1 dev batch."""
    import tempfile

    from puresound_tpu_torch.zoo.tse import init_model

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = {
            "DATASET": {"type": "TSE", "sample_rate": 16000, "max_length": 3,
                        "train": write_tse_manifest(os.path.join(tmp, "train"),
                                                    12 * RECIPE_STEPS, 1),
                        "dev": write_tse_manifest(os.path.join(tmp, "dev"), 12, 2),
                        "eval": None, "noise_folder": None, "rir_folder": None,
                        "rir_mode": None, "vol_perturbed": None,
                        "speed_perturbed": False, "perturb_frequency_response": False,
                        "single_spk_prob": 0.0, "inactive_training": 0.0,
                        "enroll_rule": "fixed_length", "enroll_augment": False,
                        "augment_on_device": False},
            "MODEL": {"type": "tse_skim_v0_causal"},
            "LOSS": {"sig_loss": "sisnr", "sig_threshold": None, "alpha": 10,
                     "cls_loss": None, "cls_loss_other": None},
            "OPTIMIZER": {"gradiend_clip": 10, "lr": 0.0001, "num_epochs_decay": 0,
                          "lr_scheduler": "Plateau", "mode": "min", "patience": 5,
                          "gamma": 0.5, "beta1": 0.9, "beta2": 0.999,
                          "weight_decay": 0.0, "multi_rate": False},
            "TRAIN": {"num_epochs": 1, "resume_epoch": None,
                      "contrastive_learning": False, "batch_size": 12,
                      "multi_gpu": True, "mixed_precision": False, "grad_accum": 1,
                      "skip_nan_steps": False, "mp_devices": 1, "remat": False,
                      "fused_scan": False, "num_workers": 4, "seed": SEED,
                      "use_tensorboard": True,
                      "model_save_dir": os.path.join(tmp, "models"),
                      "log_dir": os.path.join(tmp, "logs")}}
        path = os.path.join(tmp, "TSE.yaml")
        with open(path, "w") as f:    # YAML's JSON form
            json.dump(cfg, f, indent=1)
        res = run_recipe(lk, tk, "puresound_tpu_torch.egs.tse.main", path, backend)
        # each train step 10 + 10 LSTM and 5 + 5 TCN launches, the dev batch 10 + 5
        steps = RECIPE_STEPS
        got = res["launches"]
        expect_launches(got, (10 * steps + 10, 10 * steps, 5 * steps + 5, 5 * steps),
                        "recipe, LSTM and TCN (fwd, bwd)")
        info = recipe_checks(res, steps, dev, init_model("tse_skim_v0_causal", device=dev),
                             "6b recipe")
    g = step_gaps(res, steps, RECIPE_WARM)
    losses, dev_loss = res["losses"], res["dev_loss"]
    log("6b recipe", f"python -m puresound_tpu_torch.egs.tse.main --action train: "
        f"flagship, B=12 x 3 s, 5 s enrollment, 4 loader workers, 1 epoch of {steps} "
        f"steps + 1 dev batch on {res['trainer'].device}: losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, dev {dev_loss[0]:.4f}; "
        + gap_text(g, steps, RECIPE_WARM, 12 * 3)
        + f"; launches LSTM fwd/bwd {got[:2]}, TCN fwd/bwd {got[2:]}, serving kernels "
        f"{res['serving']}; epoch_0.ckpt reloads equal ({info[0]}, {info[1]}) [{card}]", t)
    return dict(g, launches=got)


#: phase 6e: the flagship's shipped recipe config, and what a run may override
SHIPPED_1C = "egs/tse/conf/libri2mix_max_2spk_clean_16k_1c.yaml"
#: phase 6f: the NS recipes' shipped configs
SHIPPED_NS = ("egs/ns/conf/vctk_dpcrn_1a.yaml", "egs/ns/conf/vctk_dparn_1a.yaml")
RECIPE_1C_SPK, RECIPE_1C_UTTS = 12, 8       # the train manifest: speakers x utterances
NS_RECIPE_STEPS = 4                          # phase 6f: train batches in its epoch


def shipped_config(path: str, tmp: str, train: str, dev: str, dataset=None,
                   **train_kw) -> str:
    """The shipped config read from its file, with only the data paths, the
    output directories, num_epochs 1, the loader workers and the seed
    overridden (and `train_kw`'s TRAIN keys, `dataset`'s DATASET keys),
    written back into `tmp`."""
    from puresound_tpu_torch.src.utils import dump_hparam, load_hparam

    hp = load_hparam(path)
    hp["DATASET"].update(train=train, dev=dev, eval=None, **(dataset or {}))
    hp["TRAIN"].update(dict(dict(num_epochs=1, num_workers=4, seed=SEED,
                                 model_save_dir=os.path.join(tmp, "models"),
                                 log_dir=os.path.join(tmp, "logs")), **train_kw))
    out = os.path.join(tmp, os.path.basename(path))
    dump_hparam(hp, out)
    return out


def shipped_1c_phase(lk, tk, dev, card, backend: str = "cuda", keep: str = None):
    """Phase 6e: `python -m puresound_tpu_torch.egs.tse.main
    egs/tse/conf/libri2mix_max_2spk_clean_16k_1c.yaml --action train`: the
    flagship under GE2E (task 1: SI-SNR + alpha x GE2E over the enrollments'
    d-vectors) on SpeakerSampler's batches of 12 speakers x 4 utterances (B=48
    x 3 s, 5 s enrollments), repeat x len(ds) // 48 batches a set. `keep`:
    a folder that receives the run's checkpoints for phase 7
    (`keep_checkpoints`)."""
    import tempfile

    from puresound_tpu_torch.src.utils import load_hparam
    from puresound_tpu_torch.zoo.tse import init_loss, init_model

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        n_train = RECIPE_1C_SPK * RECIPE_1C_UTTS
        path = shipped_config(
            SHIPPED_1C, tmp,
            write_tse_manifest(os.path.join(tmp, "train"), n_train, 3, RECIPE_1C_SPK),
            write_tse_manifest(os.path.join(tmp, "dev"), 48, 4, RECIPE_1C_SPK))
        hp = load_hparam(path)
        batch = hp["TRAIN"]["p_spks"] * hp["TRAIN"]["p_utts"]
        steps = hp["TRAIN"]["repeat"] * n_train // batch
        dev_batches = hp["TRAIN"]["repeat"] * 48 // batch
        res = run_recipe(lk, tk, "puresound_tpu_torch.egs.tse.main", path, backend)
        got = res["launches"]
        # task 1: the speaker net once a step, on the enrollments
        expect_launches(got, (10 * (steps + dev_batches), 10 * steps,
                              5 * (steps + dev_batches), 5 * steps),
                        "6e 1c recipe, LSTM and TCN (fwd, bwd)")
        ge2e = res["trainer"].model.loss_func_spk
        w, b = ge2e.w.item(), ge2e.b.item()
        if type(ge2e).__name__ != "GE2ELoss" or w == 10.0 or b == -5.0:
            raise AssertionError(f"6e: speaker loss {type(ge2e).__name__}, w {w}, b {b}")
        fresh = init_model(hp["MODEL"]["type"], *init_loss(hp, device=dev), device=dev)
        info = recipe_checks(res, steps, dev, fresh, "6e 1c recipe")
        if not {"loss_func_spk.w", "loss_func_spk.b"} <= set(fresh.state_dict()):
            raise AssertionError("6e: the checkpoint lacks GE2E's parameters")
        if keep:
            keep_checkpoints(res["trainer"], os.path.join(keep, hp["MODEL"]["type"]))
    g = step_gaps(res, steps, RECIPE_WARM)
    losses = res["losses"]
    log("6e 1c recipe", f"python -m puresound_tpu_torch.egs.tse.main {SHIPPED_1C} --action "
        f"train (paths, epochs, workers 4, seed overridden): flagship + GE2E (task 1, "
        f"alpha {hp['LOSS']['alpha']}), SpeakerSampler batches of {hp['TRAIN']['p_spks']} "
        f"speakers x {hp['TRAIN']['p_utts']} = B={batch} x 3 s, 5 s enrollments, {steps} "
        f"steps + {dev_batches} dev batches on {res['trainer'].device}: losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, dev {res['dev_loss'][0]:.4f}; GE2E w "
        f"10 -> {w:.6f}, b -5 -> {b:.6f}; " + gap_text(g, steps, RECIPE_WARM, batch * 3)
        + f"; launches LSTM fwd/bwd {got[:2]}, TCN fwd/bwd {got[2:]}, serving kernels "
        f"{res['serving']}; epoch_0.ckpt reloads equal, loss_func_spk.w / .b included "
        f"({info[0]}, {info[1]}) [{card}]", t)
    return dict(g, launches=got, steps=steps)


def ns_recipe_phase(lk, tk, dev, card, backend: str = "cuda", keep: str = None,
                    confs=SHIPPED_NS, phase: str = "6f ns recipe"):
    """Phase 6f (and 6h, `confs` the lookahead `_1b` configs):
    `python -m puresound_tpu_torch.egs.ns.main
    egs/ns/conf/vctk_{dpcrn,dparn}_1a.yaml --action train` on a synthetic
    manifest: B=16 x 3 s, stft_ov, Adam with weight decay 1e-5, dropout 0.1,
    one epoch of NS_RECIPE_STEPS steps and 1 dev batch. `keep`: a folder
    that receives each run's checkpoints (in <keep>/<model name>) for
    phase 7."""
    import tempfile

    from puresound_tpu_torch.src.utils import load_hparam
    from puresound_tpu_torch.zoo.ns import init_model

    out = {}
    for conf in confs:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = shipped_config(conf, tmp,
                                  write_ns_manifest(os.path.join(tmp, "train"),
                                                    16 * NS_RECIPE_STEPS, 5),
                                  write_ns_manifest(os.path.join(tmp, "dev"), 16, 6))
            hp = load_hparam(path)
            name = hp["MODEL"]["type"]
            res = run_recipe(lk, tk, "puresound_tpu_torch.egs.ns.main", path, backend)
            got, steps = res["launches"], NS_RECIPE_STEPS
            n = NS_TRAIN_LAUNCHES[name]
            expect_launches(got, (n * (steps + 1), n * steps, 0, 0),
                            f"{phase} {name}, LSTM and TCN (fwd, bwd)")
            info = recipe_checks(res, steps, dev, init_model(name, device=dev),
                                 f"{phase} {name}")
            if keep:
                keep_checkpoints(res["trainer"], os.path.join(keep, name))
        g = step_gaps(res, steps, 1)
        losses = res["losses"]
        log(phase, f"python -m puresound_tpu_torch.egs.ns.main {conf} --action train "
            f"(paths, epochs, workers 4, seed overridden): {name}, {hp['LOSS']['sig_loss']}, "
            f"Adam weight decay {hp['OPTIMIZER']['weight_decay']}, B="
            f"{hp['TRAIN']['batch_size']} x {hp['DATASET']['max_length']} s, {steps} steps + "
            f"1 dev batch on {res['trainer'].device}: losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, dev {res['dev_loss'][0]:.4f}; "
            + gap_text(g, steps, 1, hp["TRAIN"]["batch_size"] * hp["DATASET"]["max_length"])
            + f"; launches LSTM fwd/bwd {got[:2]}, TCN {got[2:]}, serving kernels "
            f"{res['serving']}; epoch_0.ckpt reloads equal ({info[0]}, {info[1]}) [{card}]", t)
        out[name] = dict(g, launches=got)
    return out


# ------------------------------------------------------------ phase 7
#: the evaluation set: mixtures of 4 s at 16 kHz (TSE: 3 s enrollments)
EVAL_UTTS, EVAL_SECONDS, EVAL_ENROLL_SECONDS = 8, 4.0, 3.0
#: the eval set's first mixtures, which the CPU's eval and NS / DSS
#: stream_eval take (one: at two, the host-bound B = 1 streams took about
#: 120 s of phases 7-7c on an H100)
EVAL_SUBSET = 1
#: TSE stream_eval's set (mixtures, seconds): its unfused engine step, JAX's
#: choice for TSE streaming, dispatches some 12,000 ops a 16 ms chunk
#: (scripts/tse_stream_ops.py)
TSE_STREAM = (1, 1.0)
TSE_MEM_LAUNCHES = 6    # the flagship's MemLSTM scans at a segment's end
EVAL_BATCH = 4
#: --batch_eval's grid: the 4 s mixtures are zero-padded to 4.5 s and the 3 s
#: enrollments (4x the grid) are on it, so nothing is tiled
EVAL_QUANTUM = 0.75
EVAL_BAR_DB = 60.0      # f32: card vs CPU, batched vs not, streamed vs offline
#: bf16 streaming against f32 (PERF.md section 2; GATE_BF16_BAR for the flagship)
HALF_BARS_DB = {"tse_skim_v0_causal": GATE_BF16_BAR, "ns_dpcrn_v0_causal": 35.0,
                "ns_dparn_v0_causal": 25.0}
#: (config, CLI module, zoo name, launches an inference (LSTM fwd, TCN fwd),
#:  stream_eval routes: (flags, launches a tick (LSTM fwd, serving kernels))).
#: The flagship's unfused step runs each of its 4 SegLSTMs one frame at a
#: time through lstm_scan_train_fp (16 frames a tick), and its 6 MemLSTM
#: scans at every 150th frame (TSE_MEM_LAUNCHES)
EVAL_RECIPES = (
    (SHIPPED_1C, "puresound_tpu_torch.egs.tse.main", "tse_skim_v0_causal", (10, 5),
     (((), (4 * 16, (0, 0, 0, 0, 0))),)),
    (SHIPPED_NS[0], "puresound_tpu_torch.egs.ns.main", "ns_dpcrn_v0_causal", (6, 0),
     (((), (6, (0, 0, 0, 0, 0))), (("--dp_kernel",), (0, (0, 0, 1, 0, 0))),
      (("--mk_kernel",), (0, (0, 0, 0, 0, 1))))),
    (SHIPPED_NS[1], "puresound_tpu_torch.egs.ns.main", "ns_dparn_v0_causal", (2, 0),
     (((), (2, (0, 0, 0, 0, 0))), (("--fused", "--attn_kernel"), (0, (0, 2, 0, 2, 0))),
      (("--mk_kernel",), (0, (0, 0, 0, 0, 1))))))


def eval_signal(rng, n: int) -> np.ndarray:
    """Speech-like: a 120-300 Hz harmonic tone with a syllable-rate envelope
    and pauses (PESQ and STOI find active frames)."""
    t = np.arange(n) / 16000
    f0 = rng.uniform(120, 300)
    tone = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.3)) / k for k in range(1, 8))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6.3)), 0, None)
    return 0.1 * tone * env


def write_eval_manifest(folder: str, n: int, seed: int, tse: bool,
                        seconds: float = None, vad: bool = False) -> str:
    """A Kaldi-style dev / eval folder of n mixtures of `seconds` (default
    EVAL_SECONDS) s at 16 kHz (keys mix_<i>_s1): wav2scp / wav2ref, and for
    TSE ref2list (one 3 s enrollment of the target), ref2spk and wav2spk;
    `vad`: ref2vad too, the target's 0 / 1 activity by 10 ms frames."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    files = (("wav2scp", "wav2ref") + (("ref2list", "ref2spk", "wav2spk") if tse else ())
             + (("ref2vad",) if vad else ()))
    lines = {f: [] for f in files}
    L = int(16000 * (seconds or EVAL_SECONDS))
    for i in range(n):
        clean, other = eval_signal(rng, L), eval_signal(rng, L)
        sigs = {"mix": clean + 0.7 * other + 0.01 * rng.standard_normal(L), "clean": clean}
        if tse:
            sigs["enroll"] = eval_signal(rng, int(16000 * EVAL_ENROLL_SECONDS))
        if vad:
            frames = np.abs(clean[:L // 160 * 160]).reshape(-1, 160).max(-1) > 0.01
            sigs["vad"] = np.repeat(frames, 160).astype(np.float64)
        path = lambda name: os.path.join(folder, f"{name}_{i}.wav")
        for name, sig in sigs.items():
            wavfile.write(path(name), 16000, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
        key = f"mix_{i}_s1"
        lines["wav2scp"].append(f"{key} {path('mix')}")
        lines["wav2ref"].append(f"{key} {path('clean')}")
        if tse:
            lines["ref2list"].append(f"{key} {path('enroll')}")
            lines["ref2spk"].append(f"{key} sp{i}")
            lines["wav2spk"].append(f"{key} sp{i}-sp{i + n}")
        if vad:
            lines["ref2vad"].append(f"{key} {path('vad')}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


def keep_checkpoints(trainer, folder: str):
    """A recipe run's epoch_0.ckpt, and an epoch_1.ckpt that the trainer's
    `save_ckpt` writes after every parameter moved by 1 % noise from a
    generator of its own, into `folder` (phase 7 averages the two)."""
    os.makedirs(folder, exist_ok=True)
    save_dir = trainer.hparam["TRAIN"]["model_save_dir"]
    shutil.copy(os.path.join(save_dir, "epoch_0.ckpt"), folder)
    gen = torch.Generator().manual_seed(SEED + 70)
    with torch.no_grad():
        for p in trainer.model.parameters():
            noise = torch.randn(p.shape, generator=gen).to(p.device, p.dtype)
            p.add_(0.01 * p.abs().mean() * noise)
    trainer.save_ckpt(os.path.join(folder, "epoch_1.ckpt"), 1, {"total_loss": 0.0})


class EvalProbe:
    """While entered, records what the recipes' evaluation actions do:
    every `SoTaskWrapModule.inference` / `SiMoTaskWrapModule.inference`
    output (its time with the card
    synchronised before and after), every array `AudioIO.save` writes
    (before int16), the model each `resolve_eval_params` loads (and the
    time it takes: two checkpoints read and averaged), every
    `stream_signal`'s RTF and the time spent in `Metrics`."""

    def __init__(self):
        from puresound_tpu_torch.nnet.base_nn import SiMoTaskWrapModule, SoTaskWrapModule
        from puresound_tpu_torch.src.audio import AudioIO
        from puresound_tpu_torch.src.metrics import Metrics
        from puresound_tpu_torch.streaming import file_eval
        from puresound_tpu_torch.tasks.base import BaseTrainer

        self.targets = [(SoTaskWrapModule, "inference"), (AudioIO, "save"),
                        (BaseTrainer, "resolve_eval_params"), (file_eval, "stream_signal"),
                        (SiMoTaskWrapModule, "inference")]
        self.targets += [(Metrics, m) for m in ("pesq_wb", "stoi", "bss_sdr", "sisnr",
                                                "sisnr_imp")]
        self.reset()

    def reset(self):
        self.outputs, self.saved, self.models, self.rtfs = [], {}, [], []
        self.model_s = self.metric_s = self.load_s = 0.0

    def __enter__(self):
        self.orig = [(obj, name, obj.__dict__[name]) for obj, name in self.targets]
        probe = self

        def timed_inference(inference):
            def timed(model, *args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = inference(model, *args)
                torch.cuda.synchronize()
                probe.model_s += time.perf_counter() - t
                probe.outputs.append(out.detach().float().cpu().numpy())
                return out
            return timed

        save = self.orig[1][2].__func__

        def recording_save(wav, f_path, sr):
            probe.saved[os.path.basename(f_path)[:-4]] = np.array(wav, np.float32).reshape(-1)
            return save(wav, f_path, sr)

        resolve = self.orig[2][2].__func__

        def recording_resolve(*args):
            t = time.perf_counter()
            model = resolve(*args)
            probe.load_s += time.perf_counter() - t
            probe.models.append(model)
            return model

        stream = self.orig[3][2]

        def recording_stream(*args, **kw):
            enh, rtf = stream(*args, **kw)
            probe.rtfs.append(rtf)
            return enh, rtf

        def timed(fn):
            def metric(*args):
                t = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    probe.metric_s += time.perf_counter() - t
            return staticmethod(metric)

        SoTaskWrapModule, AudioIO, BaseTrainer, file_eval, SiMo = (o for o, _ in self.targets[:5])
        SoTaskWrapModule.inference = timed_inference(self.orig[0][2])
        SiMo.inference = timed_inference(self.orig[4][2])
        AudioIO.save = staticmethod(recording_save)
        BaseTrainer.resolve_eval_params = staticmethod(recording_resolve)
        file_eval.stream_signal = recording_stream
        for obj, name, fn in self.orig[5:]:
            setattr(obj, name, timed(fn.__func__))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.orig:
            setattr(obj, name, fn)


def run_cli(module: str, cfg: str, args, probe: EvalProbe, lk, tk) -> dict:
    """`python -m <module> <cfg> <args>`, run in this process with `runpy`
    (its standard output captured): wall seconds, the launches (LSTM fwd,
    LSTM bwd, TCN fwd, TCN bwd; the serving kernels), and what `probe`
    recorded."""
    import contextlib
    import io
    import runpy

    serving = serving_counters()
    probe.reset()
    zero_counts(lk, tk)
    zero_counters(serving)
    argv, out = sys.argv, io.StringIO()
    sys.argv = [module, cfg, *args]
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        sys.argv = argv
    log("7 eval actions", f"{module.split('.')[-2]} {' '.join(args)}: {wall:.3f} s", t)
    return {"wall_s": wall, "stdout": out.getvalue(), "launches": counts(lk, tk),
            "serving": counter_values(serving), "outputs": probe.outputs,
            "saved": dict(probe.saved), "models": list(probe.models), "rtfs": list(probe.rtfs),
            "model_s": probe.model_s, "metric_s": probe.metric_s, "load_s": probe.load_s}


def check_models(res: dict, dev, label: str, want: int = 1):
    """`want` models loaded, every parameter and buffer on `dev`, in eval mode."""
    models = res["models"]
    if len(models) != want:
        raise AssertionError(f"{label}: {len(models)} models loaded, not {want}")
    for m in models:
        off = [n for n, t in list(m.named_parameters()) + list(m.named_buffers())
               if t.device.type != dev.type]
        if off or m.training:
            raise AssertionError(f"{label}: tensors off the card {off[:3]}, "
                                 f"training {m.training}")


def dev_rows(stdout: str, n_cols: int) -> dict:
    """The per-utterance rows `dev` printed: {key: [float, ...]}."""
    rows = {}
    for line in stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == n_cols + 1 and parts[0].startswith("mix_"):
            rows[parts[0]] = [float(p) for p in parts[1:]]
    return rows


def rescore(folder: str, outputs, tse: bool) -> dict:
    """`Metrics` on the dev outputs the probe recorded, in the manifest's
    order, against the manifest's own wavs: the rows dev must print."""
    from puresound_tpu_torch.src.audio import AudioIO
    from puresound_tpu_torch.src.metrics import Metrics
    from puresound_tpu_torch.src.utils import load_text_as_dict

    scp = load_text_as_dict(os.path.join(folder, "wav2scp.txt"))
    ref = load_text_as_dict(os.path.join(folder, "wav2ref.txt"))
    rows = {}
    for key, enh in zip(sorted(scp), outputs):
        clean, noisy = AudioIO.open(ref[key][0])[0], AudioIO.open(scp[key][0])[0]
        sisnr, sisnri = Metrics.sisnr(clean, enh), Metrics.sisnr_imp(clean, enh, noisy)
        row = [Metrics.pesq_wb(clean, enh), Metrics.stoi(clean, enh),
               Metrics.bss_sdr(clean, enh), sisnr, sisnri]
        if tse:
            row.append(1 if (sisnri < 0 and sisnr < 30) else 0)
        rows[key] = [float(v) for v in row]
    return rows


def snr_np(got: np.ndarray, want: np.ndarray) -> float:
    return snr_db(torch.from_numpy(np.asarray(got)), torch.from_numpy(np.asarray(want)))


def eval_actions_phase(lk, tk, dev, card, keep: str, backend: str = "cuda"):
    """Phase 7: the recipes' evaluation actions through their CLIs (runpy,
    as 6b), on the checkpoints phases 6e / 6f kept, TRAIN.model_average 2
    (epochs 0 and 1 averaged), on a synthetic dev / eval set of EVAL_UTTS
    mixtures: `--action dev --metrics detail`, `eval`, `eval --batch_eval
    4`, `eval --backend cpu` and `stream_eval` on every route, with and
    without `--half`, on `libri2mix_max_2spk_clean_16k_1c.yaml` and
    `vctk_{dpcrn,dparn}_1a.yaml` read from their files."""
    import tempfile

    from puresound_tpu_torch.src.utils import dump_hparam, load_hparam

    out = {"launches": [0, 0, 0, 0], "serving": [0] * 5, "by_model": {}}
    probe = EvalProbe()
    with tempfile.TemporaryDirectory() as tmp, probe:
        for conf, module, name, per_inference, routes in EVAL_RECIPES:
            t = time.perf_counter()
            tse = name.startswith("tse")
            full = write_eval_manifest(os.path.join(tmp, name, "full"), EVAL_UTTS, SEED + 80,
                                       tse)
            subset = write_eval_manifest(os.path.join(tmp, name, "subset"), EVAL_SUBSET,
                                         SEED + 80, tse)
            stream = subset if not tse else write_eval_manifest(
                os.path.join(tmp, name, "stream"), TSE_STREAM[0], SEED + 81, tse, TSE_STREAM[1])
            hp = load_hparam(conf)
            hp["TRAIN"].update(model_save_dir=os.path.join(keep, name), model_average=2,
                               log_dir=os.path.join(tmp, name, "logs"))
            cfgs = {}
            for label, folder in (("full", full), ("subset", subset), ("stream", stream)):
                hp["DATASET"].update(dev=folder, eval=folder, train=folder)
                cfgs[label] = os.path.join(tmp, name, f"{label}.yaml")
                dump_hparam(hp, cfgs[label])
            ck = ["--ckpt", "epoch_1.ckpt"]
            cli = lambda cfg, *args, on=backend: run_cli(module, cfgs[cfg],
                                                         [*args, *ck, "--backend", on],
                                                         probe, lk, tk)
            res = {"dev": cli("full", "--action", "dev", "--metrics", "detail"),
                   "eval": cli("full", "--action", "eval"),
                   "batch": cli("full", "--action", "eval", "--batch_eval", str(EVAL_BATCH),
                                "--eval_quantum", str(EVAL_QUANTUM)),
                   "cpu": cli("subset", "--action", "eval", on="cpu")}
            for flags, _ in routes:
                for half in ((), ("--half",)) if not flags else ((),):
                    res[("stream",) + flags + half] = cli("stream", "--action", "stream_eval",
                                                          *flags, *half)
            summary = check_eval_runs(res, name, tse, per_inference, routes, full, stream, dev)
            runs = [r for k, r in res.items() if k != "cpu"]
            summary["launches"] = [sum(r["launches"][i] for r in runs) for i in range(4)]
            summary["serving"] = [sum(r["serving"][i] for r in runs) for i in range(5)]
            out["launches"] = [a + b for a, b in zip(out["launches"], summary["launches"])]
            out["serving"] = [a + b for a, b in zip(out["serving"], summary["serving"])]
            out["by_model"][name] = summary
            log("7 eval actions", f"python -m {module} {conf} (--ckpt epoch_1.ckpt, "
                "TRAIN.model_average 2: epochs 0 and 1 averaged) on "
                f"{EVAL_UTTS} mixtures of {EVAL_SECONDS:g} s" + (
                    f", {EVAL_ENROLL_SECONDS:g} s enrollments" if tse else "")
                + ": " + summary["text"] + f" [{card}]", t)
    return out


def stream_set(tse: bool) -> tuple:
    """(mixtures, samples a mixture) of stream_eval's set."""
    n, seconds = TSE_STREAM if tse else (EVAL_SUBSET, EVAL_SECONDS)
    return n, int(16000 * seconds)


def stream_ticks(tse: bool) -> int:
    """stream_signal's steps an utterance: the chunks that cover the input
    and the engine's delay, and the warm-up step."""
    L, chunk = stream_set(tse)[1], 256
    delay = 0 if tse else 512 - 128
    return -(-(L + delay) // chunk) + 1


def check_eval_runs(res, name, tse, per_inference, routes, folder, stream, dev):
    """Phase 7's checks of one recipe's runs; returns the numbers and the
    log text."""
    from puresound_tpu_torch.src.audio import AudioIO
    from puresound_tpu_torch.src.utils import load_text_as_dict

    n, L = EVAL_UTTS, int(16000 * EVAL_SECONDS)
    n_b = -(-n // EVAL_BATCH)
    lf, tf = per_inference
    for key, calls in (("dev", n), ("eval", n), ("batch", n_b)):
        expect_launches((res[key]["launches"], res[key]["serving"]),
                        ((lf * calls, 0, tf * calls, 0), (0,) * 5),
                        f"7 {name} {key}: training (LSTM fwd/bwd, TCN fwd/bwd), serving")
    expect_launches((res["cpu"]["launches"], res["cpu"]["serving"]), ((0,) * 4, (0,) * 5),
                    f"7 {name} eval --backend cpu")
    n_s, L_s = stream_set(tse)
    ticks = stream_ticks(tse) * n_s
    # the flagship's MemLSTMs at each segment's end: the warm-up step's 16
    # frames reach none
    mem = TSE_MEM_LAUNCHES * ((stream_ticks(tse) - 1) * 16 // 150) * n_s if tse else 0
    for flags, (l_tick, serving_tick) in routes:
        for half in ((), ("--half",)) if not flags else ((),):
            r = res[("stream",) + flags + half]
            expect_launches((r["launches"], r["serving"]),
                            ((l_tick * ticks + mem, 0, 5 * n_s if tse else 0, 0),
                             tuple(s * ticks for s in serving_tick)),
                            f"7 {name} stream_eval {' '.join(flags + half) or 'stock'}")
            check_models(r, dev, f"7 {name} stream_eval", 2 if (tse and half) else 1)
    for key in ("dev", "eval", "batch"):
        check_models(res[key], dev, f"7 {name} {key}")
    check_models(res["cpu"], torch.device("cpu"), f"7 {name} eval --backend cpu")

    # dev: the printed rows are finite and Metrics of the outputs
    printed = dev_rows(res["dev"]["stdout"], 6 if tse else 5)
    want = rescore(folder, res["dev"]["outputs"], tse)
    if printed != want or len(printed) != n or not np.isfinite(list(want.values())).all():
        raise AssertionError(f"7 {name} dev: printed {printed}, Metrics of the outputs {want}")
    means = np.mean(list(want.values()), axis=0)

    # f32: the card against the CPU; batched against one at a time (before
    # the padded tail's last window)
    keys = sorted(res["eval"]["saved"])
    sub = keys[:EVAL_SUBSET]
    card_cpu = min(snr_np(res["eval"]["saved"][k], res["cpu"]["saved"][k]) for k in sub)
    tail = 32 if tse else 512
    batch = min(snr_np(res["batch"]["saved"][k][:L - tail], res["eval"]["saved"][k][:L - tail])
                for k in keys)
    # streamed == offline inference on the zero-primed input (the engines'
    # contract), the averaged model eval loaded; NS past the first window
    model = res["eval"]["models"][0]
    scp = load_text_as_dict(os.path.join(stream, "wav2scp.txt"))
    enr = load_text_as_dict(os.path.join(stream, "ref2list.txt")) if tse else {}
    pad = 16 if tse else 384
    offline = {}
    with torch.inference_mode():
        for k in sorted(scp):
            x = torch.from_numpy(AudioIO.open(scp[k][0])[0]).to(dev)
            args = [torch.nn.functional.pad(x, (pad, 0))]
            if tse:
                e = AudioIO.open(enr[k][0], target_lvl=-28)[0]
                args.append(torch.from_numpy(e).to(dev))
            offline[k] = model.inference(*args)[0].float().cpu().numpy()
    # the time-domain engine's output lines up with the primed offline
    # output (delay 0: it lags the input by the prime), the STFT engine's
    # with the input (JAX's tests); eval's output with the input
    lo, hi, shift = (0, L_s, 0) if tse else (512, L_s - 1024, pad)
    lag = pad if tse else 0
    streams = {}
    for flags, _ in routes:
        r = res[("stream",) + flags]
        got = min(snr_np(r["saved"][k][lo:hi], offline[k][lo + shift:hi + shift])
                  for k in offline)
        to_eval = (None if tse else min(
            snr_np(r["saved"][k][512 + lag:hi], res["eval"]["saved"][k][512:hi - lag])
            for k in offline))
        streams[" ".join(flags) or "stock"] = (got, to_eval, float(np.mean(r["rtfs"])))
    r_half = res[("stream", "--half")]
    half = min(snr_np(r_half["saved"][k], res[("stream",)]["saved"][k]) for k in offline)
    bars = {"card vs CPU": card_cpu, "batched vs unbatched": batch,
            **{f"stream {s} vs offline": v[0] for s, v in streams.items()}}
    low = {k: v for k, v in bars.items() if not v >= EVAL_BAR_DB}
    if low or not half >= HALF_BARS_DB[name]:
        raise AssertionError(f"7 {name}: below {EVAL_BAR_DB} dB {low}; --half {half:.1f} dB "
                             f"(bar {HALF_BARS_DB[name]})")

    audio_s = n * EVAL_SECONDS
    d, e, b = res["dev"], res["eval"], res["batch"]
    cols = ("PESQ", "STOI", "SDR", "SiSNR", "SiSNRi") + (("NSR",) if tse else ())
    summary = {
        "dev_wall_s": d["wall_s"], "dev_model_s": d["model_s"], "dev_metrics_s": d["metric_s"],
        "dev_load_s": d["load_s"], "eval_load_s": res["eval"]["load_s"],
        "dev_means": dict(zip(cols, map(float, means))),
        "eval_wall_s": e["wall_s"], "eval_model_s": e["model_s"],
        "eval_rtf": audio_s / e["wall_s"], "eval_model_rtf": audio_s / e["model_s"],
        "batch_wall_s": b["wall_s"], "batch_model_s": b["model_s"],
        "batch_rtf": audio_s / b["wall_s"], "batch_model_rtf": audio_s / b["model_s"],
        "cpu_eval_wall_s": res["cpu"]["wall_s"], "card_vs_cpu_db": card_cpu,
        "batch_vs_unbatched_db": batch, "half_vs_f32_db": half, "streams": streams,
        "stream_wall_s": {" ".join(k[1:]) or "stock": r["wall_s"] for k, r in res.items()
                          if k[0] == "stream"},
        "half_rtf": float(np.mean(r_half["rtfs"]))}
    summary["text"] = (
        f"dev --metrics detail {d['wall_s']:.2f} s (model {d['model_s']:.3f} s synced, Metrics "
        f"{d['metric_s']:.2f} s, reading and averaging the checkpoints "
        f"{d['load_s']:.2f} s, the rest (the model's build, data, printing) "
        f"{d['wall_s'] - d['model_s'] - d['metric_s'] - d['load_s']:.2f} s), "
        "means " + ", ".join(f"{c} {v:.4f}" for c, v in summary["dev_means"].items())
        + f", every row finite and equal to Metrics of the outputs; eval B=1 {e['wall_s']:.2f} s "
        f"(RTF {summary['eval_rtf']:.1f}, model alone {summary['eval_model_rtf']:.1f}; loading "
        f"{e['load_s']:.2f} s); "
        f"--batch_eval {EVAL_BATCH} --eval_quantum {EVAL_QUANTUM} {b['wall_s']:.2f} s (RTF "
        f"{summary['batch_rtf']:.1f}, model alone {summary['batch_model_rtf']:.1f}), "
        f"{batch:.1f} dB from B=1 before the last window; card vs --backend cpu "
        f"{card_cpu:.1f} dB (CPU eval of {EVAL_SUBSET} {res['cpu']['wall_s']:.2f} s); "
        f"stream_eval on {n_s} mixture(s) of {L_s / 16000:g} s, 16 ms chunks: " + "; ".join(
            f"{s} {summary['stream_wall_s'][s]:.2f} s, RTF {v[2]:.2f}, {v[0]:.1f} dB from the "
            "offline inference of the zero-primed input" + (
                "" if v[1] is None else f", {v[1]:.1f} dB from eval's past the first window")
            for s, v in streams.items())
        + f"; --half {summary['stream_wall_s']['--half']:.2f} s, RTF {summary['half_rtf']:.2f}, "
        f"{half:.1f} dB from f32 (bar {HALF_BARS_DB[name]:g}); launches dev / eval / batch "
        f"(LSTM fwd, TCN fwd) {d['launches'][::2]} / {e['launches'][::2]} / "
        f"{b['launches'][::2]}, no backward, no serving kernel; stream_eval (LSTM fwd, TCN fwd;"
        " serving) " + "; ".join(f"{' '.join(k[1:]) or 'stock'} {r['launches'][::2]}; "
                                 f"{r['serving']}" for k, r in res.items() if k[0] == "stream")
        + "; every model tensor on the card")
    return summary


# ------------------------------------------------------------ phase 6d
NS_TRAIN_B, NS_TRAIN_SECONDS = 16, 3.0       # the vctk configs' batch and crop
#: lstm_scan_train_fp launches a step, forward and backward alike: DPCRN's
#: two blocks each run a BiLSTM (two scans) and an inter LSTM, DPARN's only
#: the inter LSTM (its intra attention trains under autograd)
NS_TRAIN_LAUNCHES = {"ns_dpcrn_v0_causal": 6, "ns_dparn_v0_causal": 2,
                     "ns_dpcrn_v0": 6, "ns_dparn_v0": 2}
NS_CHECK_B, NS_CHECK_SECONDS = 2, 0.5        # the card vs CPU step


def ns_train_parts(name, dev, gen, dtype=torch.float32):
    """(model on the stft_ov loss, TrainState with the vctk configs' Adam,
    step with their clip) on `dev`."""
    from puresound_tpu_torch.parallel import TrainState, make_train_step
    from puresound_tpu_torch.zoo.ns import init_loss, init_model

    model = init_model(name, init_loss({"LOSS": {"sig_loss": "stft_ov"}}), device=dev,
                       generator=gen)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, weight_decay=1e-5)
    step = make_train_step(model, grad_clip=10.0,
                           compute_dtype=None if dtype == torch.float32 else dtype)
    return model, TrainState(model, opt), step


def ns_batch(B: int, seconds: float, dev) -> dict:
    rng = np.random.default_rng(SEED + 5)
    L = int(16000 * seconds)
    clean = 0.1 * rng.standard_normal((B, L))
    noisy = clean + 0.05 * rng.standard_normal((B, L))
    return {k: torch.from_numpy(v.astype(np.float32)).to(dev)
            for k, v in (("noisy", noisy), ("ref_clean", clean))}


def ns_card_vs_cpu(name, lk, dev, card):
    """One f32 step of the full-width model on the card against the same
    step on the CPU in float64, with the CPU's own f32 step beside it
    (dropout 0 on all three: the devices' mask streams differ), from the
    same weights: loss, grad_norm, every gradient. The Unet's conv weight
    gradients come through training-mode BatchNorm (JAX's single-pass
    variance), sums that cancel: the CPU's own f32 step misses the f64 one
    by up to ~2e-2 of a tensor's max and ~1e-2 of the gradient norm. So
    each reading is held within its bar (loss 1e-4, grad_norm 1e-3, a
    tensor 3e-3 of max|ref|) or within three times the CPU f32 step's
    distance, two f32 computations of the same arithmetic in other orders."""
    from puresound_tpu_torch.nnet.lobe.dropout import Dropout

    t = time.perf_counter()
    sides = []
    cpu = torch.device("cpu")
    for d, dt in ((dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64)):
        model, state, step = ns_train_parts(name, d, torch.Generator().manual_seed(SEED))
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        model.to(dt)
        zero_counts(lk)
        state, m = step(state, {k: v.to(dt)
                                for k, v in ns_batch(NS_CHECK_B, NS_CHECK_SECONDS, d).items()})
        sides.append(({n: p.grad.cpu().double() for n, p in model.named_parameters()},
                      {k: float(v) for k, v in m.items()},
                      tuple(count_of(lk, a) for a in _fwd_bwd(lk))))
    (gpu, gm, gl), (cpu32, cm, cl), (ref, rm, _) = sides
    n = NS_TRAIN_LAUNCHES[name]
    expect_launches(gl, (n, n), f"6d {name} card step, LSTM (fwd, bwd)")
    expect_launches(cl, (0, 0), f"6d {name} CPU step, LSTM (fwd, bwd)")
    rel = lambda side, key: abs(side[key] - rm[key]) / abs(rm[key])
    loss_rel, norm_rel = rel(gm, "loss"), rel(gm, "grad_norm")
    cpu_loss_rel, cpu_norm_rel = rel(cm, "loss"), rel(cm, "grad_norm")
    if loss_rel > max(1e-4, 3 * cpu_loss_rel) or norm_rel > max(1e-3, 3 * cpu_norm_rel):
        raise AssertionError(f"6d {name}: loss rel {loss_rel:.3e} (CPU f32 {cpu_loss_rel:.3e}), "
                             f"grad_norm rel {norm_rel:.3e} (CPU f32 {cpu_norm_rel:.3e}) over "
                             "the bars")
    g_all = max(g.abs().max().item() for g in ref.values())
    worst, worst_cpu, over = (0.0, ""), (0.0, ""), []
    for p, g64 in ref.items():
        gmax = g64.abs().max().item()
        if gmax <= 1e-6 * g_all:
            continue
        rel = (gpu[p] - g64).abs().max().item() / gmax
        rel_cpu = (cpu32[p] - g64).abs().max().item() / gmax
        worst, worst_cpu = max(worst, (rel, p)), max(worst_cpu, (rel_cpu, p))
        if rel > 3e-3:
            over.append(f"{p} {rel:.2e} (CPU f32 {rel_cpu:.2e})")
            if rel > 3 * rel_cpu:
                raise AssertionError(f"6d {name} grad {p}: max|d|/max|ref| {rel:.3e} > 3e-3 "
                                     f"and > three times the CPU f32 step's {rel_cpu:.3e}")
    log("6d ns train step", f"{name} B={NS_CHECK_B} x {NS_CHECK_SECONDS:g} s, stft_ov, dropout "
        f"0, f32 on the card vs f64 on the CPU: loss {gm['loss']:.6f} / {rm['loss']:.6f} "
        f"(rel {loss_rel:.2e}; CPU f32 {cpu_loss_rel:.2e}), grad_norm rel {norm_rel:.2e} (CPU "
        f"f32 {cpu_norm_rel:.2e}); worst grad max|d|/max|ref| card {worst[0]:.2e} "
        f"({worst[1]}), CPU f32 {worst_cpu[0]:.2e} ({worst_cpu[1]}); card tensors over 3e-3, "
        f"each within three times the CPU f32 distance: {over or 'none'}; LSTM "
        f"launches fwd/bwd {gl} on the card, TF32 off [{card}]", t)
    return {"loss_rel": loss_rel, "norm_rel": norm_rel, "cpu_norm_rel": cpu_norm_rel,
            "worst_grad_rel": worst[0], "worst_cpu_f32_rel": worst_cpu[0]}


def ns_training_phase(lk, tk, dev, card) -> dict:
    """Phase 6d: `ns_dpcrn_v0_causal` and `ns_dparn_v0_causal` at full width
    on the vctk configs' B=16 x 3 s (stft_ov, Adam 1e-4 with weight decay
    1e-5, clip 10, dropout 0.1 from the model's generator on the card), f32
    and bf16 compute: 2 warm-up, 5 timed and 2 profiled steps; exact LSTM
    launches every step, no TCN and no serving kernel; then the f32 step
    against the CPU's f64 step."""
    serving = serving_counters()
    out = {}
    for name in NS_TRAIN_LAUNCHES:
        n = NS_TRAIN_LAUNCHES[name]
        for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            t = time.perf_counter()
            model, state, step = ns_train_parts(name, dev, torch.Generator().manual_seed(SEED),
                                                dtype)
            batch = ns_batch(NS_TRAIN_B, NS_TRAIN_SECONDS, dev)
            first = {p: w.detach().clone() for p, w in model.named_parameters()}
            torch.cuda.reset_peak_memory_stats()
            times, losses = [], []
            zero_counts(lk, tk)
            zero_counters(serving)
            for i in range(7):
                seen = counts(lk, tk)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                state, m = step(state, batch)
                b.record()
                torch.cuda.synchronize()
                expect_launches(tuple(x - y for x, y in zip(counts(lk, tk), seen)),
                                (n, n, 0, 0), f"6d {name} {label} step {i}, LSTM and TCN")
                losses.append(float(m["loss"]))
                if i >= 2:
                    times.append(a.elapsed_time(b))
            peak = torch.cuda.max_memory_allocated()
            if not np.isfinite(losses).all():
                raise AssertionError(f"6d {name} {label}: losses {losses}")
            moved = sum(not torch.equal(first[p], w.detach())
                        for p, w in model.named_parameters())
            if moved != len(first):
                raise AssertionError(f"6d {name} {label}: {len(first) - moved} parameter "
                                     "tensors did not move")
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    state, m = step(state, batch)
                torch.cuda.synchronize()
            if any(counter_values(serving)):
                raise AssertionError(f"6d {name}: serving kernels launched "
                                     f"{counter_values(serving)}")
            lstm_ms, device_ms, top = device_share(prof, "lstm_")
            p50 = float(np.median(times))
            share = ("not measured (the profiler saw no device time)" if device_ms is None
                     else f"LSTM kernels {lstm_ms:.3f} ({100 * lstm_ms / device_ms:.1f} %) of "
                     f"{device_ms:.3f} ms over 2 steps; top kernels: " + "; ".join(
                         f"{ms:.3f} ms {k[:60]}" for ms, k in top))
            log("6d ns training", f"{name} {label} B={NS_TRAIN_B} x {NS_TRAIN_SECONDS:g} s, "
                f"stft_ov, Adam 1e-4 + weight decay 1e-5, clip 10, dropout 0.1: loss "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}, all {moved} parameter tensors moved; "
                f"{n} + {n} LSTM launches a step, 0 TCN, serving kernels "
                f"{counter_values(serving)}; step p50 {p50:.3f} ms (min {min(times):.3f}, max "
                f"{max(times):.3f}), {NS_TRAIN_B * NS_TRAIN_SECONDS * 1e3 / p50:.1f} audio-s/s; "
                f"peak {peak / 2**30:.2f} GiB; device time {share} [{card}]", t)
            out[(name, label)] = {"step_ms_p50": p50, "peak_bytes": peak,
                                  "lstm_ms": lstm_ms, "device_ms": device_ms,
                                  "launches": counts(lk, tk)}
            del model, state, step, batch, first
        out[(name, "check")] = ns_card_vs_cpu(name, lk, dev, card)
    return out


# ------------------------------------------------------------ phase 2k
#: the kernels at the shapes the remaining shipped recipes give them, each
#: case from a generator of its own (NEW_SEEDS), so the earlier phases'
#: data stay as they were. tcn_block_train at C = 512 (the Conv-TasNet
#: masker's un-embedded blocks, 1a recipe, B=12 x 3 s: 2,999 frames; its
#: speaker net is C = 512 too): (name, B, C, Ch, T, dilation, reps)
TCN512_CASES = [("C=512 d=1", 12, 512, 256, 2999, 1, 5),
                ("C=512 d=16", 12, 512, 256, 2999, 16, 5),
                ("C=512 d=128", 12, 512, 256, 2999, 128, 5)]
#: fused_skim_frames at the PVAD model's widths (n=2, C=128, H=64, FiLM),
#: 4k's serving tile and 1,024 streams: (name, n, C, H, B, F, modes)
PVAD_SKIM_CASES = [("PVAD B=256", 2, 128, 64, 256, 15, ("film",) * 2),
                   ("PVAD B=1024", 2, 128, 64, 1024, 15, ("film",) * 2)]
#: lstm_scan_train_fp at the PVAD recipe's scans (B=12 x 3 s: 20 segments
#: of 150 frames; SegLSTM C=128, H=64; MemLSTM C=H=64)
PVAD_LSTM_CASES = [("PVAD SegLSTM", 240, 150, 128, 64, False, 20),
                   ("PVAD MemLSTM", 12, 20, 64, 64, False, 20)]
NEW_SEEDS = {name: SEED + 90 + i for i, (name, *_) in enumerate(
    TCN512_CASES + PVAD_SKIM_CASES + PVAD_LSTM_CASES)}
NEW_CHUNKS, NEW_BARS = 20, (1e-4, 30.0)     # carried chunks; f32 max|d|/max|ref|, bf16 dB


def new_shapes_phase(ops, SkiM, lk, tk, dev, card) -> dict:
    """Phase 2k: the three kernels of the new recipes' paths at their new
    shapes against their plain versions (the bars and checks of phases 2,
    2b and 2c: routes as the plans name them, two calls bit-equal, CUDA-event
    times, the bounds, the yardsticks)."""
    gen = lambda name: torch.Generator().manual_seed(NEW_SEEDS[name])
    out = {"tcn": {}, "skim": {}, "lstm": {}}
    for name, B, C, Ch, T, dilation, reps in TCN512_CASES:
        t = time.perf_counter()
        r = tcn_kernel_case(tk, name, B, C, Ch, T, dilation, gen(name), dev, reps)
        if (r["f32_route"], r["bf16_route"]) != ("cuda_cores", "cuda_cores"):
            raise AssertionError(f"2k {name}: routes f32 {r['f32_route']}, bf16 "
                                 f"{r['bf16_route']}, not the CUDA cores (_plan: wgmma at "
                                 "C, Ch in {64, 128, 256} only)")
        out["tcn"][name] = r
        log("2k tcn", f"{r['shape']}: f32 max|d|/max|ref| y {r['f32_val_rel']:.2e}, dx and "
            f"grads {r['f32_grad_rel']:.2e}; bf16 SNR y {r['bf16_val_snr']:.1f} dB, dx and "
            f"grads {r['bf16_grad_snr']:.1f} dB; L2 vs the exact reference kernel / plain: f32 "
            f"{r['f32_l2_vs_exact']:.2e} / {r['f32_plain_l2_vs_exact']:.2e}, bf16 "
            f"{r['bf16_l2_vs_exact']:.2e} / {r['bf16_plain_l2_vs_exact']:.2e}; held by the L2 "
            f"bar: f32 {[x[0] for x in r['f32_l2_fallback']] or 'none'}, bf16 "
            f"{[x[0] for x in r['bf16_l2_fallback']] or 'none'}; routes f32 / bf16 "
            f"{r['f32_route']} / {r['bf16_route']}, two calls bit-equal; " + "; ".join(
                f"{lb} ms fwd/bwd kernel {r[f'{lb}_fwd_ms']:.3f}/{r[f'{lb}_bwd_ms']:.3f}, "
                f"plain {r[f'{lb}_plain_fwd_ms']:.3f}/{r[f'{lb}_plain_bwd_ms']:.3f}, stock "
                f"module fwd+bwd {r[f'{lb}_stock_ms']:.3f}, bound "
                f"{r[f'{lb}_fwd_bound'][0]:.3f}/{r[f'{lb}_bwd_bound'][0]:.3f} "
                f"({r[f'{lb}_fwd_bound'][1]})" for lb in ("f32", "bf16")) + f" [{card}]", t)
    for name, n, C, H, B, F, modes in PVAD_SKIM_CASES:
        t = time.perf_counter()
        r = kernel_case(ops, SkiM, name, n, C, H, B, F, modes, NEW_CHUNKS, gen(name), dev,
                        NEW_BARS)
        for lb, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            r[f"{lb}_bound"] = bound_ms(*skim_work(n, C, H, F, B, dt), dt)
        out["skim"][name] = r
        log("2k skim", f"{name} (n={n} C={C} H={H} F={F}), {NEW_CHUNKS} carried chunks: f32 "
            f"max|d|/max|ref| {r['f32_rel_err']:.3e} (bar {NEW_BARS[0]:g}), bf16 SNR "
            f"{r['bf16_snr_db']:.1f} dB (bar {NEW_BARS[1]:g}); bf16 plan {r['bf16_plan']}; "
            f"launches by route f32 {r['f32_routes']}, bf16 {r['bf16_routes']}; two calls "
            "bit-equal; " + "; ".join(
                f"{lb} ms kernel {r[f'{lb}_ms']:.3f}, plain {r[f'{lb}_plain_ms']:.3f}, bound "
                f"{r[f'{lb}_bound'][0]:.4f} ({r[f'{lb}_bound'][1]}), device ms by kernel "
                f"{split_line(r[f'{lb}_split'])}" for lb in ("f32", "bf16")) + f" [{card}]", t)
    for name, B, T, C, H, reverse, reps in PVAD_LSTM_CASES:
        t = time.perf_counter()
        r = lstm_kernel_case(lk, name, B, T, C, H, reverse, gen(name), dev, reps)
        out["lstm"][name] = r
        fmt = lambda v: "n/a" if v is None else f"{v:.3f}"
        log("2k lstm", f"{r['shape']}: two calls of each kernel bit-equal; clusters in "
            f"flight (fwd, bwd) f32 {lk.clusters_in_flight(B, T, C, H, torch.float32, dev)}, "
            f"bf16 {lk.clusters_in_flight(B, T, C, H, torch.bfloat16, dev)}; f32 "
            f"max|d|/max|ref| values {r['f32_val_rel']:.2e}, grads {r['f32_grad_rel']:.2e}; "
            f"bf16 SNR values {r['bf16_val_snr']:.1f} dB, grads {r['bf16_grad_snr']:.1f} dB; "
            + "; ".join(
                f"{lb} ms fwd/bwd kernel {r[f'{lb}_fwd_ms']:.3f}/{r[f'{lb}_bwd_ms']:.3f}, "
                f"plain {r[f'{lb}_plain_fwd_ms']:.3f}/{r[f'{lb}_plain_bwd_ms']:.3f}, cuDNN "
                f"{fmt(r[f'{lb}_lib_fwd_ms'])}/{fmt(r[f'{lb}_lib_bwd_ms'])}, bound "
                f"{r[f'{lb}_fwd_bound'][0]:.4g}/{r[f'{lb}_bwd_bound'][0]:.4g} "
                f"({r[f'{lb}_fwd_bound'][1]}/{r[f'{lb}_bwd_bound'][1]})"
                for lb in ("f32", "bf16")) + f" [{card}]", t)
    return out


# ------------------------------------------------------------ phase 4k
PVAD_PARAMS = 1_133_200             # tse_skim_v0_causal_vad, as the JAX zoo counts
PVAD_SLOTS, PVAD_TICKS = 256, 100   # phase 4k's sessions and timed ticks
TASNET_SLOTS, TASNET_TICKS = 8, 20  # phase 4k's Conv-TasNet sessions and ticks


def pvad_serving(ops, dev, card) -> dict:
    """Phase 4k (PVAD): `tse_skim_v0_causal_vad` through
    make_session_server(half=True, fused=True) at PVAD_SLOTS sessions, as
    phase 4i serves the Gate model: PVAD_TICKS ticks after warm-up, every
    launch on the tensor cores (K=2, M=16 at H=64), no plain version, tick
    p50 / p99, bf16 slot 0's Sigmoid output against the f32 engine (30 dB)."""
    from puresound_tpu_torch.zoo.tse import init_model

    model = init_model("tse_skim_v0_causal_vad", device=dev,
                       generator=torch.Generator().manual_seed(SEED + 100))
    n = sum(p.numel() for p in model.parameters())
    if n != PVAD_PARAMS or model.output_constraint != "Sigmoid":
        raise AssertionError(f"PVAD model: {n} parameters, output {model.output_constraint}")
    return tse_quant_serving(ops, model, None, PVAD_SLOTS, dev, card,
                             "tse_skim_v0_causal_vad", "4k pvad serving", 30.0, PVAD_TICKS)


def conv_tasnet_serving(tk, dev, card) -> dict:
    """Phase 4k (Conv-TasNet): `td_tse_conv_tasnet_v0_causal` through
    make_session_server in f32 on its unfused step (fused=None: the masker
    has no fused step; fused=True raises): TASNET_SLOTS sessions attached by
    enrollment (5 TCN launches each, C = 512 on the CUDA cores), TASNET_TICKS
    ticks of 16 ms; each slot's stream equal to the offline inference of its
    zero-primed input (>= 60 dB); tick p50 / p99."""
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.streaming.engine import offline_equivalent_input
    from puresound_tpu_torch.zoo.tse import init_model

    t = time.perf_counter()
    model = init_model("td_tse_conv_tasnet_v0_causal", device=dev,
                       generator=torch.Generator().manual_seed(SEED + 101))
    try:
        make_session_server(model, None, n_slots=2, fused=True)
        raise AssertionError("4k: fused=True served a ConvTasNet masker")
    except ValueError as e:
        if "ConvTasNet" not in str(e):
            raise
    bundle = make_session_server(model, None, n_slots=TASNET_SLOTS, chunk_ms=16.0,
                                 lockstep=True, enroll_len=16000)
    server, chunk = bundle.server, bundle.chunk_samples
    rng = np.random.default_rng(SEED + 102)
    enrolls = (0.1 * rng.standard_normal((TASNET_SLOTS, 48000))).astype(np.float32)
    feed = (0.1 * rng.standard_normal((TASNET_SLOTS, chunk * TASNET_TICKS))).astype(np.float32)
    zero_counts(tk)
    tk.LAUNCHES_BY_ROUTE.clear()
    sids = [server.attach(enroll=enrolls[i]) for i in range(TASNET_SLOTS)]
    torch.cuda.synchronize()
    expect_launches((dict(tk.LAUNCHES_BY_ROUTE), tk.BWD_LAUNCHES),
                    ({("fwd", "cuda_cores"): 5 * TASNET_SLOTS}, 0),
                    "4k conv-tasnet attaches, TCN launches by route")
    served = np.zeros_like(feed)
    with PlainCalls() as plain:
        for k in range(TASNET_TICKS):
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
            if server.tick() != TASNET_SLOTS:
                raise AssertionError(f"4k conv-tasnet tick {k}: not every slot served")
            for i, sid in enumerate(sids):
                got = server.hub.pop_output(sid, chunk)
                if len(got) != chunk or not np.isfinite(got).all():
                    raise AssertionError(f"4k conv-tasnet tick {k} slot {sid}: bad output")
                served[i, k * chunk:(k + 1) * chunk] = got
        torch.cuda.synchronize()
    stats = server.stats.snapshot()
    with torch.no_grad():
        x = torch.from_numpy(feed).to(dev)
        offline = model.inference(offline_equivalent_input(x, 32, 16),
                                  torch.from_numpy(enrolls).to(dev))[:, :feed.shape[1]]
    snr = min(snr_np(served[i], offline[i].cpu().numpy()) for i in range(TASNET_SLOTS))
    if snr < EVAL_BAR_DB or stats["underrun_slot_ticks"] or plain.calls:
        raise AssertionError(f"4k conv-tasnet: streamed vs offline {snr:.1f} dB (bar "
                             f"{EVAL_BAR_DB:g}), underruns {stats['underrun_slot_ticks']}, "
                             f"plain-version calls {plain.calls}")
    log("4k conv-tasnet serving", f"td_tse_conv_tasnet_v0_causal "
        f"({sum(p.numel() for p in model.parameters()):,} params), make_session_server f32, "
        f"fused=None -> the unfused step (fused=True raises a ValueError naming ConvTasNet), "
        f"{TASNET_SLOTS} sessions attached by 3 s enrollments (TCN launches {5 * TASNET_SLOTS}"
        f", all on the CUDA cores at C=512), {TASNET_TICKS} ticks of {chunk} samples: 0 "
        f"underruns, every output finite, tick p50 {stats['tick_ms_p50']:.3f} ms, p99 "
        f"{stats['tick_ms_p99']:.3f} ms; each slot vs the offline inference of its zero-primed "
        f"input: worst {snr:.1f} dB (bar {EVAL_BAR_DB:g}) [{card}]", t)
    return {"launches": 5 * TASNET_SLOTS, "tick_p50": stats["tick_ms_p50"],
            "tick_p99": stats["tick_ms_p99"], "snr": snr}


# ------------------------------------------------------------ phase 6g
SHIPPED_TSE = ("egs/tse/conf/libri2mix_max_2spk_clean_16k_1a.yaml",
               "egs/tse/conf/libri2mix_max_2spk_clean_16k_1b.yaml",
               "egs/tse/conf/libri2mix-pvad_max_2spk_clean_16k_1a.yaml")
SHIPPED_NS_1B = ("egs/ns/conf/vctk_dpcrn_1b.yaml", "egs/ns/conf/vctk_dparn_1b.yaml")
TSE_RECIPE_STEPS = 3                # phase 6g: train batches of 12 in its epoch
#: (lstm_scan_train_fp, tcn_block_train) launches of one forward: the
#: speaker net's 5 blocks; td_tse_conv_tasnet_v0's masker's 21 un-embedded
#: gLN blocks (its causal model's are BatchNorm blocks, on the stock path);
#: the PVAD SkiM's 2 SegLSTMs and the h / c MemLSTMs between its 2 blocks
TSE_LAUNCHES = {"td_tse_conv_tasnet_v0": (0, 26), "td_tse_conv_tasnet_v0_causal": (0, 5),
                "tse_skim_v0_causal_vad": (4, 5)}
TSE_CHECK_B, TSE_CHECK_SECONDS = 2, 0.5      # the card vs CPU step


def tse_train_parts(name, hp, dev, prepare=None):
    """(the zoo model with the config's losses, TrainState with Adam at the
    config's rate, step with its clip) on `dev`, from a seed; `prepare(model)`
    adjusts the model first (phase 6k: dropout 0)."""
    from puresound_tpu_torch.parallel import TrainState, make_train_step
    from puresound_tpu_torch.zoo.tse import init_loss, init_model

    gen = torch.Generator().manual_seed(SEED + 103)
    model = init_model(name, *init_loss(hp, device=dev, generator=gen), device=dev,
                       generator=gen)
    if prepare is not None:
        prepare(model)
    opt = torch.optim.Adam(model.parameters(), lr=hp["OPTIMIZER"]["lr"])
    step = make_train_step(model, {"alpha": hp["LOSS"]["alpha"]},
                           grad_clip=hp["OPTIMIZER"]["gradiend_clip"])
    return model, TrainState(model, opt), step


def tse_batch(dev, vad: bool) -> dict:
    rng = np.random.default_rng(SEED + 104)
    L = int(16000 * TSE_CHECK_SECONDS)
    b = {k: torch.from_numpy((0.1 * rng.standard_normal((TSE_CHECK_B, L))).astype(np.float32))
         for k in ("noisy", "enroll", "ref_clean")}
    if vad:
        b["ref_clean"] = (b["ref_clean"] > 0).float()
    b["spk_class"] = torch.arange(TSE_CHECK_B)
    return {k: v.to(dev) for k, v in b.items()}


@contextlib.contextmanager
def record_tcn_launches(tk):
    """While entered, every tcn_block_train launch's inputs and outputs
    (copies, stream-ordered) go into the yielded list as (dilation, x,
    params, dy or None, outputs)."""
    calls, (fwd, bwd) = [], (tk._launch_fwd, tk._launch_bwd)

    def rec_fwd(x, params, dilation):
        y = fwd(x, params, dilation)
        calls.append((dilation, x.clone(), [p.clone() for p in params], None, [y.clone()]))
        return y

    def rec_bwd(x, dy, params, dilation):
        out = bwd(x, dy, params, dilation)
        calls.append((dilation, x.clone(), [p.clone() for p in params], dy.clone(),
                      [o.clone() for o in out]))
        return out

    tk._launch_fwd, tk._launch_bwd = rec_fwd, rec_bwd
    try:
        yield calls
    finally:
        tk._launch_fwd, tk._launch_bwd = fwd, bwd


def replay_tcn_launches(tk, calls, label: str) -> float:
    """Each recorded launch again from its inputs: bit-equal to what the step
    computed, and within phase 2c's f32 bars (max|d|/max|ref|: y and dx 1e-4,
    the parameter gradients 1e-3, the PReLU slopes 3e-3) of the exact
    reference at those inputs. Returns the worst reading."""
    alphas = {3, 8, 13}
    worst = 0.0
    for i, (d, x, ps, dy, outs) in enumerate(calls):
        if dy is None:
            again = [tk._launch_fwd(x, ps, d)]
            exact = [tk.tcn_block_train_ref(x, *ps, dilation=d, compute_dtype=torch.float64)]
            bars = [1e-4]
        else:
            again = list(tk._launch_bwd(x, dy, ps, d))
            exact = list(tk.tcn_block_train_bwd_ref(x, dy, *ps, dilation=d,
                                                    compute_dtype=torch.float64))
            bars = [1e-4] + [3e-3 if k in alphas else 1e-3 for k in range(16)]
        if not all(torch.equal(a, b) for a, b in zip(outs, again)):
            raise AssertionError(f"{label}: launch {i} replayed differs from the step's")
        for o, e, bar in zip(outs, exact, bars):
            r = ((o.double() - e).abs().max() / e.abs().max().clamp_min(1e-300)).item()
            worst = max(worst, r)
            if r > bar:
                raise AssertionError(f"{label}: launch {i} (d={d}) {r:.3e} from the exact "
                                     f"reference at its inputs, bar {bar:g}")
    return worst


def tse_card_vs_cpu(name, hp, lk, tk, dev, card, prepare=None,
                    phase: str = "6g tse train step") -> dict:
    """One f32 training step of the full-width zoo model with the config's
    losses (SI-SNR + alpha AAM-softmax, or F1 on frame labels) on the card
    against the same step on the CPU in float64, with the CPU's own f32 step
    beside it, from the same weights (B=2 x 0.5 s). Loss and grad_norm
    within 1e-4 / 1e-3, the whole gradient within 3e-3 of the f64 one by
    relative L2 (each, or three times the CPU f32 distance); each tensor's
    max|d|/max|ref| printed against 3e-3 and three times the CPU f32
    distance (phase 6d's bars). Those per-tensor bars are not gated here: a
    PReLU or ReLU input within rounding of 0 takes the other slope in one
    f32 computation and not in another, and behind a global norm such a flip
    moves a whole sample's gradient (phase 2c's note); the CPU's f32 step,
    the f64 step's arithmetic in another precision, flips less than any
    other order does. What the kernels contribute is gated instead: every
    tcn_block_train launch of the card step, replayed from its inputs, is
    bit-equal and within phase 2c's f32 bars of the exact reference."""
    t = time.perf_counter()
    sides = []
    cpu = torch.device("cpu")
    for d, dt in ((dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64)):
        model, state, step = tse_train_parts(name, hp, d, prepare)
        model.to(dt)
        zero_counts(lk, tk)
        batch = {k: v.to(dt) if v.is_floating_point() else v
                 for k, v in tse_batch(d, name.endswith("vad")).items()}
        with record_tcn_launches(tk) as calls:
            state, m = step(state, batch)
        sides.append(({n: p.grad.cpu().double() for n, p in model.named_parameters()},
                      {k: float(v) for k, v in m.items()}, counts(lk, tk), calls))
        del model, state
    (gpu, gm, gl, calls), (cpu32, cm, cl, _), (ref, rm, _, _) = sides
    lf, tf = TSE_LAUNCHES[name]
    expect_launches(gl, (lf, lf, tf, tf), f"{phase} {name} card step, LSTM and TCN (fwd, bwd)")
    expect_launches(cl, (0, 0, 0, 0), f"{phase} {name} CPU step, LSTM and TCN (fwd, bwd)")
    replay = replay_tcn_launches(tk, calls, f"{phase} {name} card step")
    rel = lambda side, key: abs(side[key] - rm[key]) / abs(rm[key])
    loss_rel, norm_rel = rel(gm, "loss"), rel(gm, "grad_norm")
    cpu_loss_rel, cpu_norm_rel = rel(cm, "loss"), rel(cm, "grad_norm")
    flat = lambda g: torch.cat([g[p].reshape(-1) for p in ref])
    total = ((flat(gpu) - flat(ref)).norm() / flat(ref).norm()).item()
    total_cpu = ((flat(cpu32) - flat(ref)).norm() / flat(ref).norm()).item()
    if (loss_rel > max(1e-4, 3 * cpu_loss_rel) or norm_rel > max(1e-3, 3 * cpu_norm_rel)
            or not total <= max(3e-3, 3 * total_cpu)):
        raise AssertionError(f"{phase} {name}: loss rel {loss_rel:.3e} (CPU f32 {cpu_loss_rel:.3e}), "
                             f"grad_norm rel {norm_rel:.3e} (CPU f32 {cpu_norm_rel:.3e}), the "
                             f"whole gradient {total:.3e} by relative L2 (CPU f32 {total_cpu:.3e})")
    g_all = max(g.abs().max().item() for g in ref.values())
    worst, worst_cpu, over = (0.0, ""), (0.0, ""), []
    for p, g64 in ref.items():
        gmax = g64.abs().max().item()
        if gmax <= 1e-6 * g_all:
            continue    # an exact zero gradient (ASP's conv bias ahead of its softmax)
        r_card = (gpu[p] - g64).abs().max().item() / gmax
        r_cpu = (cpu32[p] - g64).abs().max().item() / gmax
        worst, worst_cpu = max(worst, (r_card, p)), max(worst_cpu, (r_cpu, p))
        if r_card > max(3e-3, 3 * r_cpu):
            over.append(f"{p} {r_card:.2e} (CPU f32 {r_cpu:.2e})")
    log(phase, f"{name} B={TSE_CHECK_B} x {TSE_CHECK_SECONDS:g} s, "
        f"{hp['LOSS']['sig_loss']} + {hp['LOSS']['alpha']} x {hp['LOSS']['cls_loss']}, f32 on "
        f"the card vs f64 on the CPU: loss {gm['loss']:.6f} / {rm['loss']:.6f} (rel "
        f"{loss_rel:.2e}; CPU f32 {cpu_loss_rel:.2e}), grad_norm rel {norm_rel:.2e} (CPU f32 "
        f"{cpu_norm_rel:.2e}), the whole gradient by relative L2 {total:.2e} (bar 3e-3 or three "
        f"times the CPU f32 step's {total_cpu:.2e}); {len(calls)} tcn_block_train launches replayed bit-equal, worst "
        f"{replay:.2e} from the exact reference at their inputs (phase 2c's bars); worst grad "
        f"max|d|/max|ref| card {worst[0]:.2e} ({worst[1]}), CPU f32 {worst_cpu[0]:.2e} "
        f"({worst_cpu[1]}); tensors over 3e-3 and three times the CPU f32 distance (kink "
        f"flips, not gated): {over or 'none'}; LSTM and TCN launches fwd/bwd {gl} on the card "
        f"[{card}]", t)
    return {"loss_rel": loss_rel, "norm_rel": norm_rel, "grad_l2": total,
            "grad_l2_cpu_f32": total_cpu, "worst_grad_rel": worst[0],
            "worst_cpu_f32_rel": worst_cpu[0], "replay_worst": replay, "over": over,
            "launches": gl}


def shipped_tse_phase(lk, tk, dev, card, keep: str, backend: str = "cuda") -> dict:
    """Phase 6g: `python -m puresound_tpu_torch.egs.tse.main <config> --action
    train` for the 1a / 1b (Conv-TasNet, AAM-softmax on spk_label, 251
    classes) and PVAD (SkiM H=64, F1 on frame labels, single-speaker and
    inactive-speaker draws at 0.1) configs, read from their files with the
    paths, epochs, workers and seed overridden; B=12 x 3 s, 5 s enrollments,
    TSE_RECIPE_STEPS steps + 1 dev batch: finite losses, exact launches, the
    AAM-softmax weight moved, epoch_0.ckpt reloading equal, step p50, host
    gap and peak memory; then one f32 step of each model against the CPU's
    f64 step. Each run's checkpoints go to <keep>/<model name> for 7b."""
    import tempfile

    from puresound_tpu_torch.src.utils import load_hparam
    from puresound_tpu_torch.zoo.tse import init_loss, init_model

    out = {}
    for conf in SHIPPED_TSE:
        t = time.perf_counter()
        vad = "pvad" in conf
        with tempfile.TemporaryDirectory() as tmp:
            path = shipped_config(
                conf, tmp,
                write_tse_manifest(os.path.join(tmp, "train"), 12 * TSE_RECIPE_STEPS, 7,
                                   vad=vad),
                write_tse_manifest(os.path.join(tmp, "dev"), 12, 8, vad=vad))
            hp = load_hparam(path)
            name, steps = hp["MODEL"]["type"], TSE_RECIPE_STEPS
            torch.cuda.reset_peak_memory_stats()
            res = run_recipe(lk, tk, "puresound_tpu_torch.egs.tse.main", path, backend)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            lf, tf = TSE_LAUNCHES[name]
            got = res["launches"]
            expect_launches(got, (lf * (steps + 1), lf * steps, tf * (steps + 1), tf * steps),
                            f"6g {name} recipe, LSTM and TCN (fwd, bwd)")
            model = res["trainer"].model
            moved = None
            if hp["LOSS"]["cls_loss"] == "aamsoftmax":
                # the recipe's AAM-softmax weight: the first draw of its generator
                w0 = init_loss(hp, device=dev, generator=torch.Generator().manual_seed(0))[1]
                moved = (model.loss_func_spk.weight - w0.weight).abs().max().item()
                if type(model.loss_func_spk).__name__ != "AAMsoftmax" or not moved > 0:
                    raise AssertionError(f"6g {name}: speaker loss "
                                         f"{type(model.loss_func_spk).__name__}, moved {moved}")
            elif model.loss_func_spk is not None:
                raise AssertionError(f"6g {name}: a speaker loss where the config has none")
            fresh = init_model(name, *init_loss(hp, device=dev), device=dev)
            info = recipe_checks(res, steps, dev, fresh, f"6g {name} recipe")
            keep_checkpoints(res["trainer"], os.path.join(keep, name))
        g = step_gaps(res, steps, 1)
        losses = res["losses"]
        log("6g tse recipe", f"python -m puresound_tpu_torch.egs.tse.main {conf} --action "
            f"train (paths, epochs, workers 4, seed overridden): {name} "
            f"({sum(p.numel() for p in fresh.parameters()):,} params with the losses'), "
            f"{hp['LOSS']['sig_loss']} + alpha {hp['LOSS']['alpha']} x "
            f"{hp['LOSS']['cls_loss']}, single-speaker / inactive draws "
            f"{hp['DATASET']['single_spk_prob']} / {hp['DATASET']['inactive_training']}, "
            f"multi_gpu {hp['TRAIN']['multi_gpu']} on one card, B={hp['TRAIN']['batch_size']} "
            f"x 3 s, {steps} steps + 1 dev batch on {res['trainer'].device}: losses "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, dev {res['dev_loss'][0]:.4f}"
            + ("" if moved is None else f"; AAM-softmax weight moved by max {moved:.3e}")
            + "; " + gap_text(g, steps, 1, hp["TRAIN"]["batch_size"] * 3)
            + f"; peak memory {peak:.2f} GiB; launches LSTM fwd/bwd {got[:2]}, TCN fwd/bwd "
            f"{got[2:]}, serving kernels {res['serving']}; epoch_0.ckpt reloads equal "
            f"({info[0]}, {info[1]}) [{card}]", t)
        check = tse_card_vs_cpu(name, hp, lk, tk, dev, card)
        out[name] = dict(g, launches=tuple(a + b for a, b in zip(got, check["launches"])),
                         peak_gib=peak, steps=steps, check=check, aam_moved=moved)
    return out


# ------------------------------------------------------------ phase 7b
EVAL_7B_UTTS = 4
#: (config, CLI module, zoo name, launches an inference (LSTM fwd, TCN fwd),
#:  stream_eval routes: (flags, launches a tick (LSTM fwd, serving kernels)),
#:  or None where the model refuses to stream). The PVAD model's unfused
#:  step runs its 2 SegLSTMs a frame at a time (16 frames a tick) and its 2
#:  MemLSTM scans at every 150th frame
EVAL_7B = (
    (SHIPPED_TSE[0], "puresound_tpu_torch.egs.tse.main", "td_tse_conv_tasnet_v0", (0, 26),
     None),
    (SHIPPED_TSE[1], "puresound_tpu_torch.egs.tse.main", "td_tse_conv_tasnet_v0_causal",
     (0, 5), (((), (0, (0, 0, 0, 0, 0))),)),
    (SHIPPED_TSE[2], "puresound_tpu_torch.egs.tse.main", "tse_skim_v0_causal_vad", (4, 5),
     (((), (2 * 16, (0, 0, 0, 0, 0))),)),
    (SHIPPED_NS_1B[0], "puresound_tpu_torch.egs.ns.main", "ns_dpcrn_v0", (6, 0),
     (((), (6, (0, 0, 0, 0, 0))), (("--fused",), (0, (0, 6, 0, 0, 0))),
      (("--dp_kernel",), (0, (0, 0, 1, 0, 0))))),
    (SHIPPED_NS_1B[1], "puresound_tpu_torch.egs.ns.main", "ns_dparn_v0", (2, 0),
     (((), (2, (0, 0, 0, 0, 0))), (("--fused", "--attn_kernel"), (0, (0, 2, 0, 2, 0))))))
PVAD_MEM_LAUNCHES = 2


def cli_raises(module, cfg, args, probe, lk, tk, what: str) -> str:
    """`run_cli` that must raise a ValueError; returns its message."""
    try:
        run_cli(module, cfg, args, probe, lk, tk)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"7b: {what} ran")


def eval_7b_phase(lk, tk, dev, card, keep: str, backend: str = "cuda") -> dict:
    """Phase 7b: the evaluation actions of the five new configs through
    their CLIs (runpy), on the checkpoints phases 6g / 6h kept
    (TRAIN.model_average 2), on EVAL_7B_UTTS mixtures of 4 s: `dev --metrics
    detail` (every row equal to Metrics of the outputs: the PVAD model's
    accuracy / precision / recall / F1 of the binarised output against the
    frame labels), `eval`, `eval --backend cpu` on the first EVAL_SUBSET
    (the card's f32 outputs >= 60 dB from the CPU's), `stream_eval` on each
    route >= 60 dB from the offline inference of the zero-primed input (the
    non-causal v0 refuses to stream; `--mk_kernel` refuses a lookahead
    model), exact launches."""
    import tempfile

    from puresound_tpu_torch.egs.tse.local.binarize import Binarize
    from puresound_tpu_torch.src.audio import AudioIO
    from puresound_tpu_torch.src.metrics import Metrics
    from puresound_tpu_torch.src.utils import dump_hparam, load_hparam, load_text_as_dict
    from puresound_tpu_torch.streaming.file_eval import build_engine, engine_delay_samples

    out = {"launches": [0, 0, 0, 0], "serving": [0] * 5, "by_model": {}}
    probe = EvalProbe()
    with tempfile.TemporaryDirectory() as tmp, probe:
        for conf, module, name, (lf, tf), routes in EVAL_7B:
            t = time.perf_counter()
            tse, vad = module.endswith("tse.main"), name.endswith("vad")
            full = write_eval_manifest(os.path.join(tmp, name, "full"), EVAL_7B_UTTS,
                                       SEED + 110, tse, vad=vad)
            subset = write_eval_manifest(os.path.join(tmp, name, "subset"), EVAL_SUBSET,
                                         SEED + 110, tse, vad=vad)
            stream = subset if not tse else write_eval_manifest(
                os.path.join(tmp, name, "stream"), TSE_STREAM[0], SEED + 111, tse,
                TSE_STREAM[1], vad=vad)
            hp = load_hparam(conf)
            hp["TRAIN"].update(model_save_dir=os.path.join(keep, name), model_average=2,
                               log_dir=os.path.join(tmp, name, "logs"))
            cfgs = {}
            for label, folder in (("full", full), ("subset", subset), ("stream", stream)):
                hp["DATASET"].update(dev=folder, eval=folder, train=folder)
                cfgs[label] = os.path.join(tmp, name, f"{label}.yaml")
                dump_hparam(hp, cfgs[label])
            ck = ["--ckpt", "epoch_1.ckpt"]
            cli = lambda cfg, *args, on=backend: run_cli(module, cfgs[cfg],
                                                         [*args, *ck, "--backend", on],
                                                         probe, lk, tk)
            res = {"dev": cli("full", "--action", "dev", "--metrics", "detail"),
                   "eval": cli("full", "--action", "eval"),
                   "cpu": cli("subset", "--action", "eval", on="cpu")}
            n = EVAL_7B_UTTS
            for key in ("dev", "eval"):
                expect_launches((res[key]["launches"], res[key]["serving"]),
                                ((lf * n, 0, tf * n, 0), (0,) * 5),
                                f"7b {name} {key}: training (LSTM fwd/bwd, TCN fwd/bwd), "
                                "serving")
                check_models(res[key], dev, f"7b {name} {key}")
            expect_launches((res["cpu"]["launches"], res["cpu"]["serving"]),
                            ((0,) * 4, (0,) * 5), f"7b {name} eval --backend cpu")
            check_models(res["cpu"], torch.device("cpu"), f"7b {name} eval --backend cpu")
            # dev: the printed rows are Metrics of the outputs
            if vad:
                binarize = Binarize(threshold=0.5, stability=0.05, sample_rate=16000,
                                    mode="moving_average")
                labels = load_text_as_dict(os.path.join(full, "ref2vad.txt"))
                want = {}
                for key, enh in zip(sorted(labels), res["dev"]["outputs"]):
                    score = Metrics.f1_score(AudioIO.open(labels[key][0])[0][None],
                                             binarize(enh).astype(np.float32))
                    want[key] = [float(score[c]) for c in ("accuracy", "precision",
                                                           "recall", "f1_score")]
                printed = dev_rows(res["dev"]["stdout"], 4)
            else:
                want = rescore(full, res["dev"]["outputs"], tse)
                printed = dev_rows(res["dev"]["stdout"], 6 if tse else 5)
            if (printed != want or len(printed) != n
                    or not np.isfinite(list(want.values())).all()):
                raise AssertionError(f"7b {name} dev: printed {printed}, Metrics of the "
                                     f"outputs {want}")
            means = np.mean(list(want.values()), axis=0)
            # the card's f32 outputs against the CPU's (PVAD: before binarising)
            card_cpu = min(snr_np(a, b) for a, b in zip(res["eval"]["outputs"][:EVAL_SUBSET],
                                                          res["cpu"]["outputs"]))
            if not card_cpu >= EVAL_BAR_DB:
                raise AssertionError(f"7b {name}: card vs CPU {card_cpu:.1f} dB")
            # stream_eval on each route against the offline inference of the
            # zero-primed input
            streams, refused = {}, []
            n_s, L_s = stream_set(tse)
            if routes is None:
                refused.append(cli_raises(module, cfgs["stream"], ["--action", "stream_eval",
                                                                   *ck, "--backend", backend],
                                          probe, lk, tk, f"{name} stream_eval"))
            else:
                model = res["eval"]["models"][0]
                scp = load_text_as_dict(os.path.join(stream, "wav2scp.txt"))
                enr = load_text_as_dict(os.path.join(stream, "ref2list.txt")) if tse else {}
                pad = 16 if tse else 384
                offline = {}
                with torch.inference_mode():
                    for k in sorted(scp):
                        x = torch.from_numpy(AudioIO.open(scp[k][0])[0]).to(dev)
                        args = [torch.nn.functional.pad(x, (pad, 0))]
                        if tse:
                            e = AudioIO.open(enr[k][0], target_lvl=-28)[0]
                            args.append(torch.from_numpy(e).to(dev))
                        offline[k] = model.inference(*args)[0].float().cpu().numpy()
                lo, hi, shift = (0, L_s, 0) if tse else (512, L_s - 1024, pad)
                # stream_signal's steps an utterance: the chunks that cover the
                # input and the engine's delay (a lookahead model's too), and
                # the warm-up step
                per_utt = -(-(L_s + engine_delay_samples(build_engine(model))) // 256) + 1
                ticks = per_utt * n_s
                mem = (PVAD_MEM_LAUNCHES * ((per_utt - 1) * 16 // 150) * n_s if vad else 0)
                for flags, (l_tick, serving_tick) in routes:
                    r = cli("stream", "--action", "stream_eval", *flags)
                    expect_launches((r["launches"], r["serving"]),
                                    ((l_tick * ticks + mem, 0, tf * n_s, 0),
                                     tuple(s * ticks for s in serving_tick)),
                                    f"7b {name} stream_eval {' '.join(flags) or 'stock'}")
                    check_models(r, dev, f"7b {name} stream_eval")
                    got = min(snr_np(r["saved"][k][lo:hi], offline[k][lo + shift:hi + shift])
                              for k in offline)
                    if not got >= EVAL_BAR_DB:
                        raise AssertionError(f"7b {name} stream_eval {flags}: {got:.1f} dB "
                                             "from offline")
                    streams[" ".join(flags) or "stock"] = (got, float(np.mean(r["rtfs"])),
                                                          r["wall_s"], r["launches"],
                                                          r["serving"])
                    for i in range(4):
                        out["launches"][i] += r["launches"][i]
                    out["serving"] = [a + b for a, b in zip(out["serving"], r["serving"])]
                if not tse:
                    refused.append(cli_raises(module, cfgs["stream"], [
                        "--action", "stream_eval", "--mk_kernel", *ck, "--backend", backend],
                        probe, lk, tk, f"{name} stream_eval --mk_kernel"))
            for key in ("dev", "eval"):
                out["launches"] = [a + b for a, b in zip(out["launches"], res[key]["launches"])]
            audio_s = n * EVAL_SECONDS
            cols = (("accuracy", "precision", "recall", "f1_score") if vad else
                    ("PESQ", "STOI", "SDR", "SiSNR", "SiSNRi") + (("NSR",) if tse else ()))
            d, e = res["dev"], res["eval"]
            summary = {"dev_wall_s": d["wall_s"], "dev_model_s": d["model_s"],
                       "dev_metrics_s": d["metric_s"],
                       "dev_means": dict(zip(cols, map(float, means))),
                       "eval_wall_s": e["wall_s"], "eval_rtf": audio_s / e["wall_s"],
                       "eval_model_rtf": audio_s / e["model_s"], "card_vs_cpu_db": card_cpu,
                       "streams": streams, "refused": refused}
            out["by_model"][name] = summary
            log("7b eval actions", f"python -m {module} {conf} (--ckpt epoch_1.ckpt, "
                f"model_average 2) on {n} mixtures of {EVAL_SECONDS:g} s: dev --metrics detail "
                f"{d['wall_s']:.2f} s (model {d['model_s']:.3f} s synced, Metrics "
                f"{d['metric_s']:.2f} s), means " + ", ".join(
                    f"{c} {v:.4f}" for c, v in summary["dev_means"].items())
                + f", every row equal to Metrics of the outputs; eval B=1 {e['wall_s']:.2f} s "
                f"(RTF {summary['eval_rtf']:.1f}, model alone {summary['eval_model_rtf']:.1f});"
                f" card vs --backend cpu {card_cpu:.1f} dB; stream_eval on {n_s} mixture(s) of "
                f"{L_s / 16000:g} s: " + ("; ".join(
                    f"{s} {v[2]:.2f} s, RTF {v[1]:.2f}, {v[0]:.1f} dB from the offline "
                    f"inference of the zero-primed input, launches (LSTM fwd, TCN fwd) "
                    f"{v[3][::2]}, serving {v[4]}" for s, v in streams.items()) or "refused")
                + "; refused as they must: " + ("; ".join(refused) or "none")
                + f"; launches dev / eval (LSTM fwd, TCN fwd) {d['launches'][::2]} / "
                f"{e['launches'][::2]}, no backward, no serving kernel [{card}]", t)
    return out


# ------------------------------------------------------------ phases 4l, 6i, 7c
SHIPPED_DSS = "egs/dss/conf/dss_dparn_1a.yaml"
DSS_NAME = "dss_dparn_mout_v0"
DSS_PARAMS = 1_216_461              # the JAX recipe's build_model, parameter for parameter
DSS_SLOTS = (1024, 256)             # phase 4l: mk_kernel, fused + attn_kernel
DSS_TICKS = 100                     # phase 4l's timed ticks a serving point
DSS_HALF_BAR = 25.0                 # bf16 against f32, each source (DPARN's serving bar)
DSS_F32_SLOTS, DSS_F32_TICKS = 8, 20
SOCKET_CLIENTS, SOCKET_SECONDS = 8, 2.0
DSS_RECIPE_STEPS = 3                # phase 6i: train batches of 8 in its epoch
DSS_EVAL_UTTS = 4                   # phase 7c: mixtures of EVAL_SECONDS


def dss_model(dev, seed, sig_loss=None):
    """The DSS recipe's model (`egs.dss.main.build_model` on the shipped
    config), weights from a seed."""
    from puresound_tpu_torch.egs.dss.main import build_model
    from puresound_tpu_torch.src.utils import load_hparam

    return build_model(load_hparam(SHIPPED_DSS), sig_loss, device=dev,
                       generator=torch.Generator().manual_seed(seed))


def dss_f32_serving(dss, counters, dev, card) -> dict:
    """Phase 4l (f32): make_session_server on the stock step at
    DSS_F32_SLOTS sessions, DSS_F32_TICKS ticks of 16 ms (2
    lstm_scan_train_fp launches a tick, the inter LSTMs): every slot's two
    sources, de-interleaved, >= 60 dB from the offline inference of its
    zero-primed input past n_fft."""
    from puresound_tpu_torch.streaming.deploy import make_session_server

    t = time.perf_counter()
    n, ticks = DSS_F32_SLOTS, DSS_F32_TICKS
    bundle = make_session_server(dss["model"], None, n_slots=n, chunk_ms=16.0, lockstep=True)
    server, chunk, M = bundle.server, bundle.chunk_samples, bundle.n_sources
    rng = np.random.default_rng(SEED + 121)
    feed = (0.1 * rng.standard_normal((n, chunk * ticks))).astype(np.float32)
    sids = [server.attach() for _ in range(n)]
    served = np.zeros((n, chunk * M * ticks), np.float32)
    zero_counters(counters)
    with PlainCalls() as plain:
        for k in range(ticks):
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
            if server.tick() != n:
                raise AssertionError(f"4l dss f32 tick {k}: not every slot served")
            for i, sid in enumerate(sids):
                served[i, k * chunk * M:(k + 1) * chunk * M] = server.hub.pop_output(
                    sid, chunk * M)
        torch.cuda.synchronize()
    launches = counter_values(counters)
    expect_launches(launches, (2 * ticks, 0, 0, 0), "4l dss f32 stock serving, (lstm_scan_"
                    "train_fp, lstm_scan, dparn_intra_pass, dparn_center_chunk)")
    stats = server.stats.snapshot()
    sources = served.reshape(n, -1, M).transpose(0, 2, 1)
    with torch.no_grad():
        x = torch.from_numpy(feed).to(dev)
        offline = dss["model"].inference(torch.nn.functional.pad(x, (384, 0)))
        offline = offline[..., :feed.shape[1]].cpu().numpy()
    snr = min(snr_np(sources[i, m, 512:], offline[i, m, 512:])
              for i in range(n) for m in range(M))
    if snr < EVAL_BAR_DB or plain.calls or stats["underrun_slot_ticks"]:
        raise AssertionError(f"4l dss f32: streamed vs offline {snr:.1f} dB, plain-version "
                             f"calls {plain.calls}, underruns {stats['underrun_slot_ticks']}")
    log("4l dss serving", f"{DSS_NAME} f32 on the stock step, make_session_server at {n} "
        f"sessions, {ticks} ticks of {chunk} samples, {M} sources a slot interleaved: launches "
        f"{launches}, tick p50 {stats['tick_ms_p50']:.3f} ms, p99 {stats['tick_ms_p99']:.3f}; "
        f"every slot's two sources vs the offline inference of its zero-primed input past "
        f"n_fft: worst {snr:.1f} dB (bar {EVAL_BAR_DB:g}) [{card}]", t)
    return {"launches": launches, "snr": snr, "tick_p50": stats["tick_ms_p50"],
            "tick_p99": stats["tick_ms_p99"]}


def socket_round(*args, exact=False, **kw) -> dict:
    """`_socket_round`, under `cudnn.deterministic` where `exact`."""
    with deterministic_cudnn() if exact else contextlib.nullcontext():
        return _socket_round(*args, exact=exact, **kw)


def _socket_round(label, model, serve_kw, counters, want, dev, card, by_route=None,
                  chunk_ms=16.0, exact=False) -> dict:
    """Phase 4l (the socket front): `run_serve` on 127.0.0.1, port 0, run on
    a thread through its on_started / stop_event hooks, SOCKET_CLIENTS slots
    in lockstep; SOCKET_CLIENTS concurrent StreamingClients (a TSE client's
    HELLO a 3 s enrollment, embedded on the card; NS / DSS an empty one)
    each send SOCKET_SECONDS s and 100 samples more, then BYE. Each client
    holds exactly (sent // chunk) * chunk samples per source, and its float32
    output is >= 60 dB from the bundle's engine stepped outside the server
    (the server's step function at its batch, each client's audio in its
    slot's row); `exact`: the round runs under `cudnn.deterministic` and
    every client's output must equal the engine's bit for bit (an f32 NS /
    DSS step with cuDNN's default algorithms differs between two calls at
    about 147 dB: the Unet's up-convolution, `scripts/socket_diverge.py`).
    `want(ticks)`: the counters' launches in the round;
    `by_route` = (module, route): every launch of the module on that route
    (as many as want's first)."""
    import threading

    from puresound_tpu_torch.streaming.deploy import run_serve
    from puresound_tpu_torch.streaming.engine import StreamingTSE
    from puresound_tpu_torch.streaming.file_eval import engine_step_options
    from puresound_tpu_torch.streaming.socket_server import StreamingClient

    t = time.perf_counter()
    ready, stop, started = threading.Event(), threading.Event(), {}

    def on_started(front, bundle):
        started.update(front=front, bundle=bundle)
        ready.set()

    zero_counters(counters)
    if by_route:
        by_route[0].LAUNCHES_BY_ROUTE.clear()
    serve = threading.Thread(target=run_serve, args=(model, None, SOCKET_CLIENTS), kwargs=dict(
        host="127.0.0.1", port=0, stop_event=stop, on_started=on_started, chunk_ms=chunk_ms,
        lockstep=True, **serve_kw), daemon=True)
    serve.start()
    if not ready.wait(timeout=300):
        raise AssertionError(f"4l {label}: run_serve did not start")
    front, bundle = started["front"], started["bundle"]
    chunk, M, K = bundle.chunk_samples, bundle.n_sources, SOCKET_CLIENTS
    rng = np.random.default_rng(SEED + 130)
    n = int(16000 * SOCKET_SECONDS) + 100
    audio = (0.1 * rng.standard_normal((K, n))).astype(np.float32)
    enrolls = ((0.1 * rng.standard_normal((K, 48000))).astype(np.float32)
               if bundle.embed_fn is not None else None)
    clients, got, errors = [None] * K, [None] * K, []
    attached = threading.Barrier(K)

    def session(i):
        try:
            c = StreamingClient(*front.address, timeout=300.0).hello(
                None if enrolls is None else enrolls[i])
            clients[i] = c
            attached.wait(timeout=300)      # every slot attached before the first tick
            c.send(audio[i])
            got[i] = c.finish()
        except BaseException as e:          # noqa: BLE001 - reported below
            errors.append(f"client {i}: {e!r}")
            attached.abort()

    threads = [threading.Thread(target=session, args=(i,)) for i in range(K)]
    t1 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t1
    torch.cuda.synchronize()
    launches = counter_values(counters)
    stats = bundle.server.stats.snapshot()
    stop.set()
    serve.join(timeout=60)
    if errors or serve.is_alive():
        raise AssertionError(f"4l {label}: {errors or 'run_serve did not stop'}")
    ticks = n // chunk
    want = want(ticks)
    expect_launches(launches, want, f"4l {label} socket round, "
                    f"({', '.join(c for c, _, _ in counters)})")
    routes = dict(by_route[0].LAUNCHES_BY_ROUTE) if by_route else {}
    if by_route:
        expect_launches(routes, {by_route[1]: want[0]},
                        f"4l {label} socket round, launches by route")
    shape = (M, ticks * chunk) if M > 1 else (ticks * chunk,)
    if any(g.shape != shape for g in got):
        raise AssertionError(f"4l {label}: received {[g.shape for g in got]}, not {shape}")
    # the bundle's engine outside the server: its step function at its batch
    engine = bundle.engine
    tse = isinstance(engine, StreamingTSE)
    dt = next(engine.parameters()).dtype
    init_kw = {} if tse else engine_step_options(engine, **{
        k: v for k, v in serve_kw.items() if k in ("fused", "attn_kernel", "mk_kernel",
                                                   "dp_kernel")})[1]
    slots = [c.slot for c in clients]
    batch = np.zeros((K, ticks * chunk), np.float32)
    batch[slots] = audio[:, :ticks * chunk]
    step_args = ()
    if tse:
        dvec = np.zeros((K, bundle.embed_dim), np.float32)
        for i, s in enumerate(slots):
            dvec[s] = bundle.embed_fn(enrolls[i][None]).cpu().numpy()[0]
        step_args = (torch.from_numpy(dvec).to(dev),)
    state, ref = engine.init_state(K, dt, **init_kw), []
    for k in range(ticks):
        y, state = bundle.server.step_fn(batch[:, k * chunk:(k + 1) * chunk], *step_args,
                                         state)
        ref.append(y.cpu().numpy())
    ref = np.concatenate(ref, axis=-1)
    worst = min(snr_np(g.reshape(M, -1)[m], ref[s].reshape(-1, M)[:, m])
                for g, s in zip(got, slots) for m in range(M))
    equal = all(np.array_equal(g.reshape(M, -1)[m], ref[s].reshape(-1, M)[:, m])
                for g, s in zip(got, slots) for m in range(M))
    if not worst >= EVAL_BAR_DB or (exact and not equal):
        raise AssertionError(f"4l {label}: a client's output {worst:.1f} dB from the engine"
                             + (" (not bit-equal under cudnn.deterministic)" if exact else ""))
    log("4l socket front", f"{label}: run_serve(127.0.0.1:0, {SOCKET_CLIENTS} slots, "
        f"chunk_ms {chunk_ms:g}, lockstep, " + ", ".join(f"{k}={v}" for k, v in serve_kw.items()) + f") through on_started / "
        f"stop_event; {K} concurrent StreamingClients"
        + (", each HELLO a 3 s enrollment embedded on the card" if tse else ", empty HELLOs")
        + f", {n} samples each ({ticks} ticks of {chunk}): each received {shape} "
        f"((sent // chunk) * chunk a source), worst {worst:.1f} dB from the engine stepped "
        f"outside the server (bar {EVAL_BAR_DB:g}; "
        + ("bit-equal, gated: the round and the engine under cudnn.deterministic"
           if exact else f"{'bit-equal' if equal else 'not bit-equal'}") + f"); launches {launches}"
        + (f" (by route {routes})" if by_route else "") + f"; round {wall:.3f} s "
        f"wall ({ticks * chunk * K / 16000 / wall:.1f} audio-s/s over the {K} sessions); tick "
        f"p50 {stats['tick_ms_p50']:.3f} ms, p99 {stats['tick_ms_p99']:.3f} ms, underruns "
        f"{stats['underrun_slot_ticks']} [{card}]", t)
    return {"launches": launches, "wall_s": wall, "snr": worst, "bit_equal": equal,
            "ticks": stats["ticks"],
            "tick_p50": stats["tick_ms_p50"], "tick_p99": stats["tick_ms_p99"],
            "underruns": stats["underrun_slot_ticks"]}


def dss_serving_phase(ops, lk, tk, flagship, dev, card) -> dict:
    """Phase 4l: DSS serving (`make_session_server(half=True, mk_kernel=True)`
    at 1,024 slots and `(half=True, fused=True, attn_kernel=True)` at 256,
    as ns_serving with DSS_TICKS ticks; the f32 stock server at 8 slots
    against offline inference), then the socket front for the flagship,
    `ns_dpcrn_v0_causal` and DSS (`socket_round`)."""
    from puresound_tpu_torch.ops import dparn_attention_kernel as dak
    from puresound_tpu_torch.ops import lstm_scan_kernel as lsk
    from puresound_tpu_torch.ops import masker_kernel as mkk
    from puresound_tpu_torch.streaming.file_eval import build_engine
    from puresound_tpu_torch.zoo.ns import init_model

    t = time.perf_counter()
    model = dss_model(dev, SEED + 120)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != DSS_PARAMS or model.masker.multi_output != 2:
        raise AssertionError(f"{DSS_NAME}: {n_params} parameters")
    dss = {"model": model, "engine": build_engine(model)}
    counters = [("lstm_scan_train_fp", lk, "FWD_BY_ENTRY"), ("lstm_scan", lsk, "LAUNCHES"),
                ("dparn_intra_pass", dak, "LAUNCHES"), ("dparn_center_chunk", mkk, "LAUNCHES")]
    log("4l dss serving", f"{DSS_NAME} ({SHIPPED_DSS}: ConvEncDec 512 / 512 / 128, "
        f"DPARN_Mout M=2, H=128, 8 heads), {n_params:,} params", t)
    # each route's launches a tick (lstm_scan_train_fp, lstm_scan,
    # dparn_intra_pass, dparn_center_chunk) and the paths and routes they take
    routes = (({"mk_kernel": True}, (0, 0, 0, 1),
               dict(by_path=(mkk, "attn=wgmma,conv=resident", 1), by_pass=DPARN_TC_PASSES)),
              ({"fused": True, "attn_kernel": True}, (0, 2, 2, 0),
               dict(by_path=(dak, "wgmma", 2), by_route=(lsk, "tc", 2))))
    out = {"params": n_params, "serving": {}}
    for (mode, per_tick, checks), slots in zip(routes, DSS_SLOTS):
        out["serving"]["+".join(mode)] = ns_serving(
            dss, DSS_NAME, mode, counters, per_tick, DSS_HALF_BAR, slots, dev, card,
            "4l dss serving", ticks=DSS_TICKS, **checks)
    out["f32"] = dss_f32_serving(dss, counters, dev, card)
    # the socket front: the flagship (bf16, fused, enrollment HELLOs; 15 ms
    # ticks, whose 15 frames divide its segments of 150 as the fused step
    # needs), DPCRN and DSS (f32, mk_kernel). The f32 models serve twice:
    # with cuDNN's default algorithms, as users serve (the 60 dB bar and the
    # tick numbers), then under cudnn.deterministic (the bit-equality gate)
    tse_counters = [("fused_skim_frames", ops, "LAUNCHES"), ("tcn_block_train fwd", tk,
                                                            _fwd_bwd(tk)[0])]
    dpcrn = init_model("ns_dpcrn_v0_causal", device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    out["socket"] = {
        "tse_skim_v0_causal": socket_round(
            "tse_skim_v0_causal", flagship, dict(half=True, fused=True), tse_counters,
            # 5 TCN launches an attach, and 5 for the probe that reads the
            # embedding's width when the server is built
            lambda ticks: (ticks, 5 * (SOCKET_CLIENTS + 1)), dev, card, by_route=(ops, "mma"),
            chunk_ms=15.0)}
    for exact in (False, True):
        tag = " deterministic" if exact else ""
        out["socket"]["ns_dpcrn_v0_causal" + tag] = socket_round(
            "ns_dpcrn_v0_causal" + tag, dpcrn, dict(mk_kernel=True),
            [("center_chunk", mkk, "LAUNCHES")], lambda ticks: (ticks,), dev, card, exact=exact)
        out["socket"][DSS_NAME + tag] = socket_round(
            DSS_NAME + tag, model, dict(mk_kernel=True), counters,
            lambda ticks: (0, 0, 0, ticks), dev, card, exact=exact)
    return out


def write_dss_manifest(folder: str, n: int, seed: int, seconds=(3.5, 2.5),
                       silent: bool = True) -> str:
    """A synthetic DSS manifest folder (wav2scp / ref2near / ref2far) of n
    mixtures at 16 kHz, keys mix_<i>, lengths cycling through `seconds`
    (cropped to, or padded up to, the recipe's 3 s): a speech-like near
    talker and a noisier far one; with `silent`, every fourth item's near
    reference and every fourth (offset two) far reference all zeros."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    lines = {"wav2scp": [], "ref2near": [], "ref2far": []}
    for i in range(n):
        L = int(16000 * seconds[i % len(seconds)])
        near = eval_signal(rng, L) * (0 if silent and i % 4 == 1 else 1)
        far = 0.4 * eval_signal(rng, L) * (0 if silent and i % 4 == 3 else 1)
        for name, sig, key in (("mix", near + far + 0.005 * rng.standard_normal(L), "wav2scp"),
                               ("near", near, "ref2near"), ("far", far, "ref2far")):
            path = os.path.join(folder, f"{name}_{i}.wav")
            wavfile.write(path, 16000, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
            lines[key].append(f"mix_{i} {path}")
    for name, ls in lines.items():
        with open(os.path.join(folder, f"{name}.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    return folder


def dss_card_vs_cpu(lk, dev, card) -> dict:
    """One f32 training step of the full-width DSS model on the shipped
    sasisnr loss (B=NS_CHECK_B x NS_CHECK_SECONDS s, one inactive far side,
    dropout 0) on the card against the same step on the CPU in float64, the
    CPU's own f32 step beside it: loss and grad_norm within 1e-4 / 1e-3 and
    the whole gradient within 3e-3 by relative L2 of the f64 step's (each,
    or three times the CPU f32 step's distance), as phases 6f / 6g gate;
    the worst tensor readings printed."""
    from puresound_tpu_torch.nnet.lobe.dropout import Dropout
    from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
    from puresound_tpu_torch.parallel import TrainState, make_train_step

    t = time.perf_counter()
    rng = np.random.default_rng(SEED + 142)
    L = int(16000 * NS_CHECK_SECONDS)
    noisy = (0.1 * rng.standard_normal((NS_CHECK_B, L))).astype(np.float32)
    ref = (0.1 * rng.standard_normal((NS_CHECK_B, 2, L))).astype(np.float32)
    inact = np.array([[False, True], [False, False]])
    sides = []
    cpu = torch.device("cpu")
    for d, dt in ((dev, torch.float32), (cpu, torch.float32), (cpu, torch.float64)):
        model = dss_model(d, SEED + 143, SDRLoss.init_mode("sasisnr"))
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        model.to(dt)
        state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-4))
        step = make_train_step(model, grad_clip=10.0)
        zero_counts(lk)
        batch = {"noisy": torch.from_numpy(noisy).to(d, dt),
                 "ref_clean": torch.from_numpy(ref).to(d, dt),
                 "inactive_labels": torch.from_numpy(inact).to(d)}
        state, m = step(state, batch)
        sides.append(({n: p.grad.cpu().double() for n, p in model.named_parameters()},
                      {k: float(v) for k, v in m.items()},
                      tuple(count_of(lk, a) for a in _fwd_bwd(lk))))
        del model, state
    (gpu, gm, gl), (cpu32, cm, cl), (ref64, rm, _) = sides
    expect_launches(gl, (2, 2), "6i dss card step, LSTM (fwd, bwd)")
    expect_launches(cl, (0, 0), "6i dss CPU step, LSTM (fwd, bwd)")
    rel = lambda side, key: abs(side[key] - rm[key]) / abs(rm[key])
    loss_rel, norm_rel = rel(gm, "loss"), rel(gm, "grad_norm")
    cpu_loss_rel, cpu_norm_rel = rel(cm, "loss"), rel(cm, "grad_norm")
    flat = lambda g: torch.cat([g[p].reshape(-1) for p in ref64])
    total = ((flat(gpu) - flat(ref64)).norm() / flat(ref64).norm()).item()
    total_cpu = ((flat(cpu32) - flat(ref64)).norm() / flat(ref64).norm()).item()
    if (loss_rel > max(1e-4, 3 * cpu_loss_rel) or norm_rel > max(1e-3, 3 * cpu_norm_rel)
            or not total <= max(3e-3, 3 * total_cpu)):
        raise AssertionError(f"6i dss: loss rel {loss_rel:.3e} (CPU f32 {cpu_loss_rel:.3e}), "
                             f"grad_norm rel {norm_rel:.3e} (CPU f32 {cpu_norm_rel:.3e}), the "
                             f"whole gradient {total:.3e} (CPU f32 {total_cpu:.3e})")
    g_all = max(g.abs().max().item() for g in ref64.values())
    worst, worst_cpu = (0.0, ""), (0.0, "")
    for p, g64 in ref64.items():
        gmax = g64.abs().max().item()
        if gmax > 1e-6 * g_all:
            worst = max(worst, ((gpu[p] - g64).abs().max().item() / gmax, p))
            worst_cpu = max(worst_cpu, ((cpu32[p] - g64).abs().max().item() / gmax, p))
    log("6i dss train step", f"{DSS_NAME} B={NS_CHECK_B} x {NS_CHECK_SECONDS:g} s, sasisnr "
        f"with one inactive far side, dropout 0, f32 on the card vs f64 on the CPU: loss "
        f"{gm['loss']:.6f} / {rm['loss']:.6f} (rel {loss_rel:.2e}; CPU f32 {cpu_loss_rel:.2e}), "
        f"grad_norm rel {norm_rel:.2e} (CPU f32 {cpu_norm_rel:.2e}), the whole gradient by "
        f"relative L2 {total:.2e} (CPU f32 {total_cpu:.2e}); worst tensor max|d|/max|ref| "
        f"(not gated) card {worst[0]:.2e} ({worst[1]}), CPU f32 {worst_cpu[0]:.2e} "
        f"({worst_cpu[1]}); LSTM launches fwd/bwd {gl} on the card [{card}]", t)
    return {"loss_rel": loss_rel, "norm_rel": norm_rel, "grad_l2": total,
            "grad_l2_cpu_f32": total_cpu, "worst_grad_rel": worst[0], "launches": gl}


def dss_recipe_phase(lk, tk, dev, card, keep: str, backend: str = "cuda") -> dict:
    """Phase 6i: `python -m puresound_tpu_torch.egs.dss.main
    egs/dss/conf/dss_dparn_1a.yaml --action train` read from the file with
    the paths, epochs, workers and seed overridden, on a synthetic manifest
    with silent near and far references: DSS_RECIPE_STEPS steps of B=8 x 3 s
    + 1 dev batch, finite sasisnr losses, exact launches (2 inter LSTMs a
    forward), epoch_0.ckpt reloading equal, step p50, host gap and peak
    memory; then `dss_card_vs_cpu`. The run's checkpoints go to
    <keep>/<model name> for 7c."""
    import tempfile

    from puresound_tpu_torch.egs.dss.main import build_model
    from puresound_tpu_torch.src.utils import load_hparam

    t = time.perf_counter()
    steps = DSS_RECIPE_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        path = shipped_config(SHIPPED_DSS, tmp,
                              write_dss_manifest(os.path.join(tmp, "train"), 8 * steps,
                                                 SEED + 140),
                              write_dss_manifest(os.path.join(tmp, "dev"), 8, SEED + 141))
        hp = load_hparam(path)
        torch.cuda.reset_peak_memory_stats()
        res = run_recipe(lk, tk, "puresound_tpu_torch.egs.dss.main", path, backend)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = res["launches"]
        expect_launches(got, (2 * (steps + 1), 2 * steps, 0, 0),
                        "6i dss recipe, LSTM and TCN (fwd, bwd)")
        info = recipe_checks(res, steps, dev, build_model(hp, device=dev), "6i dss recipe")
        keep_checkpoints(res["trainer"], os.path.join(keep, DSS_NAME))
    g = step_gaps(res, steps, 1)
    losses = res["losses"]
    log("6i dss recipe", f"python -m puresound_tpu_torch.egs.dss.main {SHIPPED_DSS} --action "
        f"train (paths, epochs, workers 4, seed overridden): {DSS_NAME}, "
        f"{hp['LOSS']['sig_loss']}, B={hp['TRAIN']['batch_size']} x "
        f"{hp['DATASET']['max_length']} s with silent near / far references, {steps} steps + "
        f"1 dev batch on {res['trainer'].device}: losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"dev {res['dev_loss'][0]:.4f}; " + gap_text(g, steps, 1, hp["TRAIN"]["batch_size"] * 3)
        + f"; peak memory {peak:.2f} GiB; launches LSTM fwd/bwd {got[:2]}, TCN {got[2:]}, "
        f"serving kernels {res['serving']}; epoch_0.ckpt reloads equal ({info[0]}, {info[1]}) "
        f"[{card}]", t)
    check = dss_card_vs_cpu(lk, dev, card)
    return dict(g, launches=tuple(a + b for a, b in zip(got, check["launches"] + (0, 0))),
                peak_gib=peak, steps=steps, check=check)


def eval_7c_phase(lk, tk, dev, card, keep: str, backend: str = "cuda") -> dict:
    """Phase 7c: the DSS CLI's evaluation actions (runpy) on 6i's checkpoints
    (TRAIN.model_average 2), DSS_EVAL_UTTS mixtures of EVAL_SECONDS s:
    `dev` (every printed SI-SNR, near and far, equal to `Metrics.sisnr` of
    the outputs), `eval` (RTF), `eval --batch_eval 2` (>= 60 dB from B=1),
    `eval --backend cpu` on the first EVAL_SUBSET (the card's f32 wavs >= 60
    dB from the CPU's), `stream_eval` (the dev set, as JAX's DSS recipe: the
    first EVAL_SUBSET) on the stock, `--fused` and `--mk_kernel` routes, each
    source >= 60 dB from the offline inference of the zero-primed input,
    and `--half` >= DSS_HALF_BAR; exact launches; `export_model` writes
    JAX's artifact set for a SIMO model and its loaded FullModel equals the
    eager inference (`held_to_eager`)."""
    import tempfile

    from puresound_tpu_torch.egs.dss import main as dss_cli
    from puresound_tpu_torch.src.audio import AudioIO
    from puresound_tpu_torch.src.metrics import Metrics
    from puresound_tpu_torch.src.utils import dump_hparam, load_hparam, load_text_as_dict

    module = "puresound_tpu_torch.egs.dss.main"
    out = {"launches": [0, 0, 0, 0], "serving": [0] * 5}
    probe = EvalProbe()
    t = time.perf_counter()
    n, L = DSS_EVAL_UTTS, int(16000 * EVAL_SECONDS)
    with tempfile.TemporaryDirectory() as tmp, probe:
        full = write_dss_manifest(os.path.join(tmp, "full"), n, SEED + 150, (EVAL_SECONDS,),
                                  silent=False)
        subset = write_dss_manifest(os.path.join(tmp, "subset"), EVAL_SUBSET, SEED + 150,
                                    (EVAL_SECONDS,), silent=False)
        hp = load_hparam(SHIPPED_DSS)
        hp["TRAIN"].update(model_save_dir=os.path.join(keep, DSS_NAME), model_average=2,
                           log_dir=os.path.join(tmp, "logs"))
        cfgs = {}
        for label, folder in (("full", full), ("subset", subset)):
            hp["DATASET"].update(dev=folder, eval=folder, train=folder)
            cfgs[label] = os.path.join(tmp, f"{label}.yaml")
            dump_hparam(hp, cfgs[label])
        ck = ["--ckpt", "epoch_1.ckpt"]
        cli = lambda cfg, *args, on=backend: run_cli(module, cfgs[cfg],
                                                     [*args, *ck, "--backend", on], probe, lk, tk)
        res = {"dev": cli("full", "--action", "dev"), "eval": cli("full", "--action", "eval"),
               "batch": cli("full", "--action", "eval", "--batch_eval", "2"),
               "cpu": cli("subset", "--action", "eval", on="cpu")}
        for key, calls in (("dev", n), ("eval", n), ("batch", -(-n // 2))):
            expect_launches((res[key]["launches"], res[key]["serving"]),
                            ((2 * calls, 0, 0, 0), (0,) * 5),
                            f"7c dss {key}: training (LSTM fwd/bwd, TCN fwd/bwd), serving")
            check_models(res[key], dev, f"7c dss {key}")
        expect_launches((res["cpu"]["launches"], res["cpu"]["serving"]), ((0,) * 4, (0,) * 5),
                        "7c dss eval --backend cpu")
        check_models(res["cpu"], torch.device("cpu"), "7c dss eval --backend cpu")
        # dev: the printed rows are Metrics.sisnr of the outputs, near and far
        scp = load_text_as_dict(os.path.join(full, "wav2scp.txt"))
        refs = {s: load_text_as_dict(os.path.join(full, f"ref2{s}.txt")) for s in ("near", "far")}
        want = {k: [float(Metrics.sisnr(AudioIO.open(refs[s][k][0])[0], o[:, m]))
                    for m, s in enumerate(("near", "far"))]
                for k, o in zip(sorted(scp), res["dev"]["outputs"])}
        printed = {}
        for line in res["dev"]["stdout"].splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 3 and parts[0].startswith("mix_"):
                printed[parts[0]] = [float(p) for p in parts[1:]]
        if printed != want or len(printed) != n or not np.isfinite(list(want.values())).all():
            raise AssertionError(f"7c dss dev: printed {printed}, Metrics of the outputs {want}")
        means = np.mean(list(want.values()), axis=0)
        saved = lambda key: res[key]["saved"]
        names = [f"mix_{i}_{s}" for i in range(n) for s in ("near", "far")]
        if sorted(saved("eval")) != sorted(names):
            raise AssertionError(f"7c dss eval wrote {sorted(saved('eval'))}")
        batch = min(snr_np(saved("batch")[k], saved("eval")[k]) for k in names)
        card_cpu = min(snr_np(saved("eval")[k], saved("cpu")[k]) for k in saved("cpu"))
        if not (batch >= EVAL_BAR_DB and card_cpu >= EVAL_BAR_DB):
            raise AssertionError(f"7c dss: batch_eval {batch:.1f} dB, card vs CPU "
                                 f"{card_cpu:.1f} dB")
        # stream_eval on the subset (DATASET.dev) against the offline inference
        # of the zero-primed input, each source
        model = res["eval"]["models"][0]
        sub = load_text_as_dict(os.path.join(subset, "wav2scp.txt"))
        with torch.inference_mode():
            offline = {k: model.inference(torch.nn.functional.pad(
                torch.from_numpy(AudioIO.open(sub[k][0])[0]).to(dev), (384, 0)))[0]
                .float().cpu().numpy() for k in sorted(sub)}
        ticks = (-(-(L + 384) // 256) + 1) * EVAL_SUBSET
        lo, hi, shift = 512, L - 1024, 384
        streams = {}
        for flags, bar, per_tick in (((), EVAL_BAR_DB, (2, (0, 0, 0, 0, 0))),
                                     (("--fused",), EVAL_BAR_DB, (0, (0, 2, 0, 0, 0))),
                                     (("--mk_kernel",), EVAL_BAR_DB, (0, (0, 0, 0, 0, 1))),
                                     (("--half",), DSS_HALF_BAR, (2, (0, 0, 0, 0, 0)))):
            r = cli("subset", "--action", "stream_eval", *flags)
            expect_launches((r["launches"], r["serving"]),
                            ((per_tick[0] * ticks, 0, 0, 0),
                             tuple(v * ticks for v in per_tick[1])),
                            f"7c dss stream_eval {' '.join(flags) or 'stock'}")
            check_models(r, dev, "7c dss stream_eval")
            got = min(snr_np(r["saved"][f"{k}_{s}"][lo:hi], offline[k][m, lo + shift:hi + shift])
                      for k in offline for m, s in enumerate(("near", "far")))
            if not got >= bar:
                raise AssertionError(f"7c dss stream_eval {flags}: {got:.1f} dB from offline "
                                     f"(bar {bar:g})")
            streams[" ".join(flags) or "stock"] = (got, float(np.mean(r["rtfs"])), r["wall_s"],
                                                  r["launches"], r["serving"])
            out["launches"] = [a + b for a, b in zip(out["launches"], r["launches"])]
            out["serving"] = [a + b for a, b in zip(out["serving"], r["serving"])]
        # export_model (outside the probe, whose timed inference would see the
        # trace's fake tensors): the artifacts JAX's export writes for a SIMO
        # model; the loaded FullModel against the eager inference on the
        # first mixture
        probe.__exit__(None, None, None)
        try:
            r = export_cli(dss_cli, cfgs["full"], lk, tk, backend, ckpt="epoch_1.ckpt")
        finally:
            probe.__enter__()
        expect_launches(r["launches"], (2, 0, 0, 0), "7c dss export_model (the eager masker "
                        "call on the dummy input)")
        written = sorted(r["paths"])
        if written != ["EncoderNet", "FullModel", "MaskNet", "StreamStep", "decoderNet"]:
            raise AssertionError(f"7c dss export_model wrote {written}")
        full = torch.export.load(r["paths"]["FullModel"])
        wav = torch.from_numpy(AudioIO.open(scp[sorted(scp)[0]][0])[0]).to(dev)[:, :16000 * 5]
        wav = torch.nn.functional.pad(wav, (0, 16000 * 5 - wav.shape[-1]))
        with torch.no_grad():
            exported = held_to_eager("7c dss FullModel", lambda: model.inference(wav),
                                     lambda: full.module()(wav), lk, tk)
    for key in ("dev", "eval", "batch"):
        out["launches"] = [a + b for a, b in zip(out["launches"], res[key]["launches"])]
    audio_s = n * EVAL_SECONDS
    d, e = res["dev"], res["eval"]
    out.update(dev_means={"near": float(means[0]), "far": float(means[1])},
               eval_rtf=audio_s / e["wall_s"], eval_model_rtf=audio_s / e["model_s"],
               batch_rtf=audio_s / res["batch"]["wall_s"], card_vs_cpu_db=card_cpu,
               batch_db=batch, streams=streams)
    log("7c dss eval actions", f"python -m {module} {SHIPPED_DSS} (--ckpt epoch_1.ckpt, "
        f"model_average 2) on {n} mixtures of {EVAL_SECONDS:g} s: dev {d['wall_s']:.2f} s "
        f"(model {d['model_s']:.3f} s synced, Metrics {d['metric_s']:.2f} s), SI-SNR near "
        f"{means[0]:.4f} / far {means[1]:.4f}, every row equal to Metrics.sisnr of the "
        f"outputs; eval B=1 {e['wall_s']:.2f} s (RTF {out['eval_rtf']:.1f}, model alone "
        f"{out['eval_model_rtf']:.1f}), --batch_eval 2 RTF {out['batch_rtf']:.1f} and "
        f"{batch:.1f} dB from B=1; card vs --backend cpu {card_cpu:.1f} dB; stream_eval on "
        f"{EVAL_SUBSET} mixtures: " + "; ".join(
            f"{s} {v[2]:.2f} s, RTF {v[1]:.2f}, {v[0]:.1f} dB from the offline inference of "
            f"the zero-primed input (each source), launches (LSTM fwd) {v[3][0]}, serving "
            f"{v[4]}" for s, v in streams.items())
        + f"; export_model {r['wall_s']:.2f} s (export / save s "
        + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in r["seconds"].items())
        + f"), its artifacts {written}, the loaded FullModel "
        f"{exported['rel_err']:.2e} of max|ref| from the eager inference "
        f"({'bit-equal' if exported['bit_equal'] else UNEQUAL}, launches "
        f"{exported['launches']} as eager) [{card}]", t)
    return out


# ------------------------------------------------------------ phase 6j
#: phase 6j's shipped configs, read from their files
SHIPPED_6J = {"ns": "egs/ns/conf/vctk_dpcrn_1a.yaml", "tse": SHIPPED_TSE[0],
              "dss": SHIPPED_DSS}
AUG_STEPS = 3                    # train steps a run (step_gaps needs three)
AUG_VOL = "0.5,1.5"              # vol_perturbed's range
AUG_DEVICE_BAR = 1e-5            # card vs CPU apply, max|d| / max|ref|
#: the runs' launches a step (LSTM, TCN), forward and backward alike
AUG_LAUNCHES = {"ns": (6, 0), "tse": (0, 26), "dss": (2, 0)}
REMAT_TASNET_B, REMAT_TASNET_SECONDS = 12, 3.0   # the causal Conv-TasNet's step
REMAT_TIMED = 3                  # timed steps a remat mode, after the compared one
RESUME_STEPS = 2                 # train batches an epoch in the resume check
DP_B, DP_SECONDS = 16, 3.0       # the world-of-one step (vctk_dpcrn_1a's batch)


def write_noise_corpus(folder: str, seed: int, n: int = 8) -> str:
    """n files of 2-6 s of coloured noise at 16 kHz: white noise through a
    one-pole low-pass whose pole is drawn per file."""
    from scipy.io import wavfile
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        a = rng.uniform(0.5, 0.98)
        x = lfilter([1 - a], [1, -a], rng.standard_normal(int(16000 * rng.uniform(2, 6))))
        wavfile.write(os.path.join(folder, f"noise_{i}.wav"), 16000,
                      (0.3 * x / np.abs(x).max() * 32767).astype(np.int16))
    return folder


def write_rir_corpus(folder: str, seed: int, n: int = 8) -> str:
    """n impulse responses of 0.3 s at 16 kHz: a direct-path peak after a
    drawn delay, then an exponentially decaying noise tail."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    L = int(0.3 * 16000)
    for i in range(n):
        peak = int(rng.integers(20, 200))
        h = np.zeros(L)
        h[peak] = 0.9
        t = np.arange(L - peak - 1)
        h[peak + 1:] = 0.3 * rng.standard_normal(t.size) * np.exp(-t / rng.uniform(400, 1600))
        wavfile.write(os.path.join(folder, f"rir_{i}.wav"), 16000,
                      (np.clip(h, -1, 1) * 32767).astype(np.int16))
    return folder


def aug_dataset(kind: str, mode: str, corpora) -> dict:
    """The DATASET keys of a 6j run: every host option of the kind on
    (`host`), RIR / noise / volume in the step (`device`), or none (`off`)."""
    noise, rir = corpora
    off = {"noise_folder": None, "vol_perturbed": None, "speed_perturbed": False}
    if kind != "dss":
        off.update(rir_folder=None, rir_mode=None, perturb_frequency_response=False,
                   augment_on_device=False)
    if kind == "tse":    # inactive draws in every mode: only augmentation differs
        off.update(enroll_augment=False, inactive_training=0.2)
    if mode == "off":
        return off
    on = {"noise_folder": noise, "vol_perturbed": AUG_VOL}
    if kind == "dss":
        return dict(off, **on, speed_perturbed=True)
    on.update(rir_folder=rir, rir_mode="early")
    if mode == "device":
        return dict(off, **on, augment_on_device=True)
    on.update(speed_perturbed=True, perturb_frequency_response=True)
    if kind == "tse":
        on.update(enroll_augment=True, inactive_training=0.2)
    return dict(off, **on)


def aug_run(lk, tk, kind: str, mode: str, corpora, dev, backend: str) -> dict:
    """One 6j recipe run (AUG_STEPS steps + 1 dev batch) through its CLI:
    finite losses, exact launches, the checkpoint reloading; its step p50
    and host gap."""
    import tempfile

    from puresound_tpu_torch.src.utils import load_hparam

    conf = SHIPPED_6J[kind]
    steps = AUG_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        if kind == "ns":
            mk, module = write_ns_manifest, "puresound_tpu_torch.egs.ns.main"
        elif kind == "tse":
            mk, module = write_tse_manifest, "puresound_tpu_torch.egs.tse.main"
        else:
            mk, module = write_dss_manifest, "puresound_tpu_torch.egs.dss.main"
        B = load_hparam(conf)["TRAIN"]["batch_size"]
        path = shipped_config(conf, tmp, mk(os.path.join(tmp, "train"), B * steps, SEED + 150),
                              mk(os.path.join(tmp, "dev"), B, SEED + 151),
                              dataset=aug_dataset(kind, mode, corpora))
        hp = load_hparam(path)
        res = run_recipe(lk, tk, module, path, backend)
        lstm, tcn = AUG_LAUNCHES[kind]
        got = res["launches"]
        expect_launches(got, (lstm * (steps + 1), lstm * steps, tcn * (steps + 1),
                              tcn * steps), f"6j {kind} {mode}, LSTM and TCN (fwd, bwd)")
        if kind == "ns":
            from puresound_tpu_torch.zoo.ns import init_model

            fresh = init_model(hp["MODEL"]["type"], device=dev)
        elif kind == "tse":
            from puresound_tpu_torch.zoo.tse import init_loss, init_model

            fresh = init_model(hp["MODEL"]["type"], *init_loss(hp, device=dev), device=dev)
        else:
            from puresound_tpu_torch.egs.dss.main import build_model

            fresh = build_model(hp, device=dev)
        recipe_checks(res, steps, dev, fresh, f"6j {kind} {mode}")
    g = step_gaps(res, steps, 1)
    return dict(g, launches=got, trainer=res["trainer"], losses=res["losses"], hp=hp,
                audio_s=B * hp["DATASET"]["max_length"])


def device_chain_check(trainer, dev) -> dict:
    """One batch's draws from the task's generator, applied on the card and
    by the plain path on the CPU in float64: max|d| / max|ref| of the input,
    the target and (TSE) the enrollment."""
    from puresound_tpu_torch.src.augment_torch import DeviceAugmentor

    aug = trainer.device_augmentor
    ds = trainer.hparam["DATASET"]
    B, L = trainer.hparam["TRAIN"]["batch_size"], int(16000 * ds["max_length"])
    rng = np.random.default_rng(SEED + 152)
    clean = 0.1 * rng.standard_normal((B, L))
    sig = {"noisy": clean + 0.05 * rng.standard_normal((B, L)), "clean": clean,
           "enroll": 0.1 * rng.standard_normal((B, L))}
    draws = aug.draw(trainer.augment_generator, B)
    inactive = torch.from_numpy(rng.random(B) < 0.3)
    card = aug.apply(*(torch.from_numpy(sig[k]).float().to(dev) for k in ("noisy", "clean")),
                     draws, vol_extra=[torch.from_numpy(sig["enroll"]).float().to(dev)],
                     inactive=inactive.to(dev))
    cpu_aug = DeviceAugmentor(**dict(trainer._augmentor_kwargs(), device="cpu"))
    ref = cpu_aug.apply(*(torch.from_numpy(sig[k]) for k in ("noisy", "clean")),
                        {k: v.cpu() for k, v in draws.items()},
                        vol_extra=[torch.from_numpy(sig["enroll"])], inactive=inactive)
    rel = {name: ((a.double().cpu() - b).abs().max() / b.abs().max()).item()
           for name, a, b in (("input", card[0], ref[0]), ("target", card[1], ref[1]),
                              ("enroll", card[2][0], ref[2][0]))}
    if not all(r <= AUG_DEVICE_BAR for r in rel.values()):
        raise AssertionError(f"6j device chain: card vs CPU {rel} > {AUG_DEVICE_BAR}")
    used = {k: int(v.sum()) for k, v in draws.items() if v.dtype == torch.bool}
    return {"rel": rel, "used": used, "B": B, "L": L}


def augmentation_phase(lk, tk, dev, card, backend: str = "cuda") -> dict:
    """Phase 6j (augmentation): each config without augmentation and with
    every host option on (the loader's chain, 4 fork'd workers), then NS and
    TSE with augment_on_device (RIR, noise, volume in the step), and one
    batch of the device chain on the card against the CPU."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpora = (write_noise_corpus(os.path.join(tmp, "noise"), SEED + 153),
                   write_rir_corpus(os.path.join(tmp, "rir"), SEED + 154))
        for kind, modes in (("ns", ("off", "host", "device")), ("tse", ("off", "host", "device")),
                            ("dss", ("off", "host"))):
            for mode in modes:
                t = time.perf_counter()
                r = aug_run(lk, tk, kind, mode, corpora, dev, backend)
                hp, trainer = r.pop("hp"), r.pop("trainer")
                extra = ""
                if mode == "device":
                    r["check"] = device_chain_check(trainer, dev)
                    extra = (f"; one batch's draws (B={r['check']['B']} x "
                             f"{r['check']['L']}, used {r['check']['used']}) applied on the "
                             f"card vs the CPU's float64: max|d|/max|ref| " + ", ".join(
                                 f"{k} {v:.2e}" for k, v in r["check"]["rel"].items())
                             + f" (bar {AUG_DEVICE_BAR:g})")
                share = r["wait_p50"] / r["gap_p50"] if r["gap_p50"] > 0 else float("nan")
                opts = [k for k, v in aug_dataset(kind, mode, corpora).items() if v]
                log("6j augmentation", f"{SHIPPED_6J[kind]} ({hp['MODEL']['type']}), "
                    f"augmentation {mode} ({', '.join(opts) or 'none'}), B="
                    f"{hp['TRAIN']['batch_size']} x {hp['DATASET']['max_length']} s, "
                    f"{AUG_STEPS} steps + 1 dev batch, 4 loader workers: "
                    f"losses {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; "
                    + gap_text(r, AUG_STEPS, 1, r["audio_s"])
                    + f"; the loader's share of the gap {100 * share:.1f} %; launches "
                    f"LSTM fwd/bwd {r['launches'][:2]}, TCN {r['launches'][2:]}{extra} [{card}]",
                    t)
                out[(kind, mode)] = r
    return out


def tasnet_remat_model(dev, gen):
    """The causal Conv-TasNet TSE model (BatchNorm blocks) on SI-SNR, its
    masker's TCN blocks at dropout 0.1 (no zoo model sets one; the speaker
    net's gLN blocks keep none, so they stay on tcn_block_train)."""
    from puresound_tpu_torch.nnet.conv_tasnet import TCN
    from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
    from puresound_tpu_torch.zoo import init_tse_model

    model = init_tse_model("td_tse_conv_tasnet_v0_causal", sig_loss=SDRLoss.init_mode("sisnr"),
                           device=dev, generator=gen)
    for block in model.masker.modules():
        if isinstance(block, TCN):
            block.drop.p = 0.1
    return model


def remat_phase(lk, tk, dev, card) -> dict:
    """Phase 6j (remat): the flagship's B=64 x 2 s step and the causal
    Conv-TasNet's B=12 x 3 s step (BatchNorm, dropout 0.1) under remat
    False / True / "dots" (the blocks recomputed one at a time in the
    backward), cuDNN held to its deterministic algorithms: one step from the
    same state a mode, its gradients and new BatchNorm statistics bit-equal
    to remat=False's, the kernels' forwards twice a step under
    recomputation, remat=True's peak below remat=False's; then the step p50
    and peak memory a mode."""
    from puresound_tpu_torch.parallel import TrainState, make_train_step

    cases = (("flagship", lambda: train_parts(dev, torch.Generator().manual_seed(SEED))[0],
              lambda: train_batch(TRAIN_B, TRAIN_SECONDS, dev), (10, 10, 5, 5)),
             ("causal Conv-TasNet", lambda: tasnet_remat_model(
                 dev, torch.Generator().manual_seed(SEED + 155)),
              lambda: train_batch(REMAT_TASNET_B, REMAT_TASNET_SECONDS, dev), (0, 0, 5, 5)))
    out = {}
    with deterministic_cudnn():
        for label, build, batch_of, per_step in cases:
            t = time.perf_counter()
            batch = batch_of()
            runs = {}
            for mode in (False, True, "dots"):
                model = build()
                state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
                step = make_train_step(model, grad_clip=10.0, remat=mode)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_counts(lk, tk)
                state, m = step(state, batch)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                got = counts(lk, tk)
                grads = [p.grad.clone() for p in model.parameters()]
                stats = [b.clone() for b in model.buffers()]
                times = []
                for _ in range(REMAT_TIMED):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    step(state, batch)
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t1))
                total = counts(lk, tk)
                want = per_step if mode is False else (2 * per_step[0], per_step[1],
                                                       2 * per_step[2], per_step[3])
                expect_launches(got, want, f"6j remat {label} {mode}, LSTM and TCN (fwd, bwd)")
                runs[mode] = {"loss": float(m["loss"]), "grads": grads, "stats": stats,
                              "peak_gib": peak / 2 ** 30, "step_p50": float(np.median(times)),
                              "step_launches": got, "launches": total}
                del model, state, step
                torch.cuda.empty_cache()
            base = runs[False]
            for mode in (True, "dots"):
                r = runs[mode]
                if not (all(map(torch.equal, r["grads"], base["grads"]))
                        and all(map(torch.equal, r["stats"], base["stats"]))):
                    raise AssertionError(f"6j remat {label} {mode}: gradients or statistics "
                                         "differ from remat=False")
            if not runs[True]["peak_gib"] < base["peak_gib"]:
                raise AssertionError(f"6j remat {label}: remat=True peak "
                                     f"{runs[True]['peak_gib']:.2f} GiB not below "
                                     f"{base['peak_gib']:.2f}")
            n_stats = sum(s.numel() for s in base["stats"])
            log("6j remat", f"{label} B={batch['noisy'].shape[0]} x "
                f"{batch['noisy'].shape[1] / 16000:g} s, cuDNN deterministic: remat True / "
                f"'dots' gradients ({len(base['grads'])} tensors) and new BatchNorm "
                f"statistics ({n_stats} values) bit-equal to remat=False; " + "; ".join(
                    f"remat {mode}: step p50 {r['step_p50']:.3f} ms, peak "
                    f"{r['peak_gib']:.2f} GiB, launches in the compared step LSTM fwd/bwd "
                    f"{r['step_launches'][:2]}, TCN {r['step_launches'][2:]}"
                    for mode, r in runs.items()) + f" [{card}]", t)
            out[label] = {str(k): {kk: v for kk, v in r.items() if kk not in ("grads", "stats")}
                          for k, r in runs.items()}
            del runs, batch
    return out


def resume_phase(lk, tk, dev, card, backend: str = "cuda") -> dict:
    """Phase 6j (resume): vctk_dpcrn_1a.yaml through the NS CLI for 2 epochs
    straight, and for 1 epoch then resumed from epoch_0.ckpt for the second,
    cuDNN deterministic: parameters, buffers, Adam's moments and steps, the
    scheduler and the bookkeeping bit-equal after epoch 2."""
    import tempfile

    conf = SHIPPED_6J["ns"]
    t = time.perf_counter()
    with deterministic_cudnn():
        with tempfile.TemporaryDirectory() as tmp:
            train = write_ns_manifest(os.path.join(tmp, "train"), 16 * RESUME_STEPS, SEED + 156)
            dv = write_ns_manifest(os.path.join(tmp, "dev"), 16, SEED + 157)
            runs = {}
            for label, sub, kw in (("straight", "a", dict(num_epochs=2)),
                                   ("first", "b", dict(num_epochs=1)),
                                   ("resumed", "b", dict(num_epochs=2, resume_epoch=1))):
                os.makedirs(os.path.join(tmp, sub), exist_ok=True)
                path = shipped_config(conf, os.path.join(tmp, sub), train, dv, **kw)
                runs[label] = run_recipe(lk, tk, "puresound_tpu_torch.egs.ns.main", path,
                                         backend)
    a, b = runs["straight"]["trainer"], runs["resumed"]["trainer"]
    diff = [n for (n, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values())
            if not torch.equal(x, y)]
    moments = 0
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.state.optimizer.state[pa], b.state.optimizer.state[pb]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            moments += 1
            if not torch.equal(sa[k].cpu(), sb[k].cpu()):
                diff.append(f"adam {k}")
    if diff or a.scheduler.state_dict() != b.scheduler.state_dict() \
            or (a.overall_step, a.state.step) != (b.overall_step, b.state.step):
        raise AssertionError(f"6j resume: the resumed run differs: {diff[:5]}, scheduler "
                             f"{a.scheduler.state_dict()} vs {b.scheduler.state_dict()}")
    # the resumed run appends to the first run's metrics.jsonl
    losses = {k: r["losses"] for k, r in runs.items()}
    if losses["resumed"] != losses["straight"] or len(losses["first"]) != RESUME_STEPS:
        raise AssertionError(f"6j resume: losses {losses}")
    n = NS_TRAIN_LAUNCHES[a.hparam["MODEL"]["type"]]
    got = [runs[k]["launches"] for k in ("straight", "first", "resumed")]
    expect_launches(got[0], (2 * n * (RESUME_STEPS + 1), 2 * n * RESUME_STEPS, 0, 0),
                    "6j resume straight, LSTM and TCN (fwd, bwd)")
    log("6j resume", f"python -m puresound_tpu_torch.egs.ns.main {conf} --action train, "
        f"{RESUME_STEPS} steps + 1 dev batch an epoch, cuDNN deterministic: 2 epochs "
        f"straight == 1 epoch then TRAIN.resume_epoch 1 from epoch_0.ckpt: "
        f"{len(a.model.state_dict())} state tensors, {moments} Adam tensors, the scheduler "
        f"{a.scheduler.state_dict()}, step {a.state.step}, the {len(losses['straight'])} "
        f"logged losses bit-equal; launches straight / first / resumed {got} [{card}]", t)
    return {"launches": tuple(map(sum, zip(*got))), "losses": losses["straight"]}


def data_parallel_phase(lk, tk, dev, card) -> dict:
    """Phase 6j (data parallelism): `multihost.initialize` joins a NCCL
    group of one process on the card, and the data-parallel step (BatchNorm
    and the loss on the global batch, the gradients all-reduced) of the NS
    model of vctk_dpcrn_1a (ns_dpcrn_v0_causal, B=16 x 3 s, dropout 0.1,
    stft_ov) equals the
    plain step bit for bit over 2 steps. A two-process run needs two
    cards."""
    import socket

    from puresound_tpu_torch.parallel import make_train_step, multihost

    t = time.perf_counter()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"localhost:{port}", 1, 0, dev)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        import torch.distributed as dist

        backend = dist.get_backend()
        if backend != "nccl" or multihost.process_count() != 1:
            raise AssertionError(f"6j data parallel: backend {backend}, world "
                                 f"{multihost.process_count()}")
        batch = ns_batch(DP_B, DP_SECONDS, dev)
        runs = []
        for dp in (False, True):
            model, state, step = ns_train_parts("ns_dpcrn_v0_causal", dev,
                                                torch.Generator().manual_seed(SEED + 158))
            if dp:
                step = make_train_step(model, grad_clip=10.0, data_parallel=True)
            zero_counts(lk, tk)
            losses = []
            for _ in range(2):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            runs.append((losses, [p.detach().clone() for p in model.parameters()],
                         [b.clone() for b in model.buffers()], counts(lk, tk)))
        (l0, p0, b0, c0), (l1, p1, b1, c1) = runs
        n = NS_TRAIN_LAUNCHES["ns_dpcrn_v0_causal"]
        expect_launches(c1, (2 * n, 2 * n, 0, 0), "6j data-parallel step, LSTM and TCN (fwd, bwd)")
        if l0 != l1 or not all(map(torch.equal, p0, p1)) or not all(map(torch.equal, b0, b1)):
            raise AssertionError(f"6j data parallel: losses {l0} vs {l1}, or parameters / "
                                 "statistics differ")
    finally:
        torch.backends.cudnn.deterministic = prev
        multihost.shutdown()
    log("6j data parallel", f"multihost.initialize: NCCL group of 1 process on {dev}; "
        f"ns_dpcrn_v0_causal B={DP_B} x {DP_SECONDS:g} s, stft_ov, dropout 0.1, 2 steps through "
        f"make_train_step(data_parallel=True) == the plain step bit for bit (losses {l1}, "
        f"{len(p1)} parameters, {len(b1)} buffers); launches {c1} [{card}]", t)
    log("6j data parallel", f"two processes not run: this machine has "
        f"{torch.cuda.device_count()} card(s) and NCCL takes one process per card; the "
        "two-process step is held against one process on the CPU (gloo) by "
        "tests/test_torch_multiprocess.py", time.perf_counter())
    return {"launches": tuple(a + b for a, b in zip(c0, c1)), "losses": l1}


def trainer_phase(lk, tk, dev, card, backend: str = "cuda") -> dict:
    """Phase 6j: the rest of the trainer (augmentation, remat, resume, data
    parallelism); returns each kernel's launches over it."""
    aug = augmentation_phase(lk, tk, dev, card, backend)
    rem = remat_phase(lk, tk, dev, card)
    res = resume_phase(lk, tk, dev, card, backend)
    dp = data_parallel_phase(lk, tk, dev, card)
    total = [0, 0, 0, 0]
    for r in list(aug.values()) + [res, dp] + [m for c in rem.values() for m in c.values()]:
        for i, v in enumerate(r["launches"]):
            total[i] += v
    return {"augmentation": aug, "remat": rem, "resume": res, "data_parallel": dp,
            "launches": {"lstm_scan_train_fp fwd": total[0], "lstm_scan_train_fp bwd": total[1],
                         "tcn_block_train fwd": total[2], "tcn_block_train bwd": total[3]}}


# ------------------------------------------------------------ phases 2l, 4m, 6k, 7d
#: the time-domain rest of the TSE zoo and its parameter counts (JAX's)
ZOO_PARAMS = {"tse_skim_v0": 15_575_568, "tse_skim_v1_causal": 6_249_217,
              "tse_skim_v2_causal": 6_221_552, "veve_dprnn_v0_causal": 723_585}
#: (lstm_scan_train_fp, tcn_block_train) launches of one forward: v0's 4
#: bidirectional SegLSTMs (8 scans) and 3 bidirectional MemLSTMs (h and c:
#: 12); v1's 4 SegLSTMs, 3 x 2 MemLSTM scans and its speaker BiLSTM (2);
#: v2's 10 masker scans and 5 TCN blocks; veve's 6 blocks of an intra and an
#: inter scan over the mixture and again over the enrollment
ZOO_LAUNCHES = {"tse_skim_v0": (20, 5), "tse_skim_v1_causal": (12, 0),
                "tse_skim_v2_causal": (10, 5), "veve_dprnn_v0_causal": (24, 0)}
TSE_LAUNCHES.update(ZOO_LAUNCHES)
#: lstm_scan_train_fp at the zoo's new scans (B=12 x 3 s, 5 s enrollments):
#: (name, rows, steps, C, H, reverse, reps). v0's SegLSTM (backward
#: direction), its MemLSTM at C = 2H = 512 both ways, v1's speaker BiLSTM
#: over 4,999 frames at H = 192 (24 units a CTA), DPRNN's intra (20 steps)
#: and inter (150) scans at H = 64, and its streaming inter step (256
#: streams x 20 positions, one step)
ZOO_LSTM_CASES = [("v0 SegLSTM reverse", 240, 150, 128, 256, True, 10),
                  ("v0 MemLSTM C=512", 12, 20, 512, 256, False, 20),
                  ("v0 MemLSTM C=512 reverse", 12, 20, 512, 256, True, 20),
                  ("v1 speaker BiLSTM", 12, 4999, 128, 192, False, 3),
                  ("DPRNN intra", 1800, 20, 128, 64, False, 20),
                  ("DPRNN inter", 240, 150, 128, 64, False, 10),
                  ("DPRNN stream inter", 5120, 1, 128, 64, False, 20)]
#: tcn_block_train at v2's speaker net: 5 s enrollments through FbankEnc
#: (VALID 512-sample frames at hop 128: 622 frames, 80 mel banks)
ZOO_TCN_CASES = [("v2 speaker C=80 d=1", 12, 80, 256, 622, 1, 10),
                 ("v2 speaker C=80 d=16", 12, 80, 256, 622, 16, 10)]
ZOO_SEEDS = {name: SEED + 120 + i for i, (name, *_) in enumerate(
    ZOO_LSTM_CASES + ZOO_TCN_CASES)}
#: the cases whose plain version is timed by the check's own call: the
#: speaker BiLSTM's 4,999-step Python loop (about 55 s of repeats before)
ZOO_PLAIN_ONCE = {"v1 speaker BiLSTM"}
ZOO_SLOTS, ZOO_TICKS = 256, 100     # phase 4m: bf16 fused serving
ZOO_HELD = 8                        # phase 4m: slots held against the f32 engine
ZOO_DVEC_COS = 0.999                # phase 4m: bf16 d-vector vs the f32 embed, cosine bar
ZOO_F32_SLOTS, ZOO_F32_TICKS = 8, 20
VEVE_STREAMS, VEVE_TICKS = 256, 20  # phase 4m: the embedding-free cohort, 20 ms chunks
ZOO_RECIPE_STEPS = 3                # phase 6k
ZOO_EVAL_UTTS = 4                   # phase 7d: mixtures of EVAL_SECONDS
ZOO_EVAL_BATCH, ZOO_EVAL_QUANTUM = 2, 0.25    # the 4 s mixtures and 3 s enrollments on the grid
ZOO_DRAWS = ((0.6, 0.3), (0.0, 0.0))          # SpecAugment's uniforms in 6k's card vs CPU step


def zoo_shapes_phase(lk, tk, dev, card) -> dict:
    """Phase 2l: `lstm_scan_train_fp` and `tcn_block_train` at the new zoo
    models' shapes against their plain versions (phase 2b / 2c's bars, two
    calls bit-equal, CUDA-event times, the bounds, cuDNN's LSTM or the stock
    TCN module beside); "launches": each kernel's launches in the phase."""
    gen = lambda name: torch.Generator().manual_seed(ZOO_SEEDS[name])
    out = {"lstm": {}, "tcn": {}}
    zero_counts(lk, tk)
    fmt = lambda v: "n/a" if v is None else f"{v:.3f}"
    for name, B, T, C, H, reverse, reps in ZOO_LSTM_CASES:
        t = time.perf_counter()
        r = lstm_kernel_case(lk, name, B, T, C, H, reverse, gen(name), dev, reps,
                             plain_once=name in ZOO_PLAIN_ONCE)
        r["plans"] = {lb: (lambda pl: f"CL={pl.CL} U={pl.U} fwd M={pl.fwd.M} nbuf="
                           f"{pl.fwd.nbuf} xproj={pl.fwd.xproj} smem={pl.fwd.smem}, bwd M="
                           f"{pl.bwd.M} smem={pl.bwd.smem}")(lk._plan_on(dev, B, C, H, dt))
                      for lb, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        out["lstm"][name] = r
        log("2l lstm", f"{r['shape']}: plans {r['plans']}; two calls of each kernel bit-equal; "
            f"clusters in flight (fwd, bwd) f32 "
            f"{lk.clusters_in_flight(B, T, C, H, torch.float32, dev)}, bf16 "
            f"{lk.clusters_in_flight(B, T, C, H, torch.bfloat16, dev)}; f32 max|d|/max|ref| "
            f"values {r['f32_val_rel']:.2e}, grads {r['f32_grad_rel']:.2e}; bf16 SNR values "
            f"{r['bf16_val_snr']:.1f} dB, grads {r['bf16_grad_snr']:.1f} dB; " + "; ".join(
                f"{lb} ms fwd/bwd kernel {r[f'{lb}_fwd_ms']:.3f}/{r[f'{lb}_bwd_ms']:.3f}, "
                f"plain {r[f'{lb}_plain_fwd_ms']:.3f}/{r[f'{lb}_plain_bwd_ms']:.3f}, cuDNN"
                f"{' (forward direction)' if reverse else ''} "
                f"{fmt(r[f'{lb}_lib_fwd_ms'])}/{fmt(r[f'{lb}_lib_bwd_ms'])}, bound "
                f"{r[f'{lb}_fwd_bound'][0]:.4g}/{r[f'{lb}_bwd_bound'][0]:.4g} "
                f"({r[f'{lb}_fwd_bound'][1]}/{r[f'{lb}_bwd_bound'][1]})"
                for lb in ("f32", "bf16")) + f" [{card}]", t)
    for name, B, C, Ch, T, dilation, reps in ZOO_TCN_CASES:
        t = time.perf_counter()
        r = tcn_kernel_case(tk, name, B, C, Ch, T, dilation, gen(name), dev, reps)
        if (r["f32_route"], r["bf16_route"]) != ("cuda_cores", "cuda_cores"):
            raise AssertionError(f"2l {name}: routes f32 {r['f32_route']}, bf16 "
                                 f"{r['bf16_route']}, not the CUDA cores (_plan: wgmma at "
                                 "C, Ch in {64, 128, 256} only)")
        out["tcn"][name] = r
        log("2l tcn", f"{r['shape']}: f32 max|d|/max|ref| y {r['f32_val_rel']:.2e}, dx and "
            f"grads {r['f32_grad_rel']:.2e}; bf16 SNR y {r['bf16_val_snr']:.1f} dB, dx and "
            f"grads {r['bf16_grad_snr']:.1f} dB; L2 vs the exact reference kernel / plain: f32 "
            f"{r['f32_l2_vs_exact']:.2e} / {r['f32_plain_l2_vs_exact']:.2e}, bf16 "
            f"{r['bf16_l2_vs_exact']:.2e} / {r['bf16_plain_l2_vs_exact']:.2e}; held by the L2 "
            f"bar: f32 {[x[0] for x in r['f32_l2_fallback']] or 'none'}, bf16 "
            f"{[x[0] for x in r['bf16_l2_fallback']] or 'none'}; routes f32 / bf16 "
            f"{r['f32_route']} / {r['bf16_route']}, two calls bit-equal; " + "; ".join(
                f"{lb} ms fwd/bwd kernel {r[f'{lb}_fwd_ms']:.3f}/{r[f'{lb}_bwd_ms']:.3f}, "
                f"plain {r[f'{lb}_plain_fwd_ms']:.3f}/{r[f'{lb}_plain_bwd_ms']:.3f}, stock "
                f"module fwd+bwd {r[f'{lb}_stock_ms']:.3f}, bound "
                f"{r[f'{lb}_fwd_bound'][0]:.3f}/{r[f'{lb}_bwd_bound'][0]:.3f} "
                f"({r[f'{lb}_fwd_bound'][1]})" for lb in ("f32", "bf16")) + f" [{card}]", t)
    out["launches"] = counts(lk, tk)
    if 0 in out["launches"]:
        raise AssertionError(f"2l: launches (LSTM fwd, bwd, TCN fwd, bwd) {out['launches']}")
    return out


def zoo_model(name, dev, seed):
    """The zoo model at full width from a seed, its parameter count JAX's."""
    from puresound_tpu_torch.zoo.tse import init_model

    model = init_model(name, device=dev, generator=torch.Generator().manual_seed(seed))
    n = sum(p.numel() for p in model.parameters())
    if n != ZOO_PARAMS[name]:
        raise AssertionError(f"{name}: {n:,} parameters, JAX counts {ZOO_PARAMS[name]:,}")
    return model


def zoo_bf16_serving(ops, lk, tk, name, dev, card) -> dict:
    """Phase 4m: `name` through make_session_server(half=True, fused=True) at
    ZOO_SLOTS sessions, 15 ms ticks, each session attached by its 1 s
    enrollment (embedded on the card in bf16: v1's speaker BiLSTM, 2
    lstm_scan_train_fp launches; v2's FbankEnc + 5 tcn_block_train), every
    d-vector within cosine ZOO_DVEC_COS of the f32 embed; the engine step
    alone, then NS_WARM + ZOO_TICKS ticks: every launch of fused_skim_frames
    on the tensor cores, the MemLSTM's 6 scans at each segment end, no plain
    version, 0 underruns, tick p50 / p99; ZOO_HELD slots spread over the
    server against the f32 engine on the same audio and the f32 embed of the
    same enrollments (>= 35 dB each), so the bf16 embed is held too."""
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.streaming.engine import StreamingTSE
    from puresound_tpu_torch.streaming.server import ServeStats

    t = time.perf_counter()
    bf = torch.bfloat16
    model = zoo_model(name, dev, SEED + 130)
    engine32 = StreamingTSE.from_offline(model).eval()
    bundle = make_session_server(model, None, n_slots=ZOO_SLOTS, chunk_ms=15.0, half=True,
                                 fused=True, lockstep=True, enroll_len=16000)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    n_ticks = NS_WARM + ZOO_TICKS
    rng = np.random.default_rng(SEED + 131)
    enrolls = (0.1 * rng.standard_normal((ZOO_SLOTS, 16000))).astype(np.float32)
    feed = (0.1 * rng.standard_normal((ZOO_SLOTS, chunk * n_ticks))).astype(np.float32)
    lf, tf = (2, 0) if name.endswith("v1_causal") else (0, 5)
    zero_counts(lk, tk)
    ta = time.perf_counter()
    sids = [server.attach(enroll=enrolls[i]) for i in range(ZOO_SLOTS)]
    torch.cuda.synchronize()
    t_attach = time.perf_counter() - ta
    expect_launches(counts(lk, tk), (lf * ZOO_SLOTS, 0, tf * ZOO_SLOTS, 0),
                    f"4m {name} attaches, LSTM and TCN (fwd, bwd)")
    dvecs = torch.from_numpy(server._dvec.copy()).to(dev)
    with torch.no_grad():
        d32 = engine32.embed(torch.from_numpy(enrolls).to(dev))
    cos = torch.nn.functional.cosine_similarity(d32, dvecs).min().item()
    if not cos >= ZOO_DVEC_COS:
        raise AssertionError(f"4m {name}: bf16 d-vector cosine to the f32 embed {cos:.6f} "
                             f"< {ZOO_DVEC_COS:g}")
    x = torch.from_numpy(feed[:, :chunk]).to(dev, bf)
    state, step_ms = engine.init_state(ZOO_SLOTS, bf), []
    with torch.no_grad():
        for k in range(NS_WARM + NS_TICKS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, state = engine.step(x, dvecs.to(bf), state, fused=True, dot_dtype=bf)
            torch.cuda.synchronize()
            if k >= NS_WARM:
                step_ms.append(1e3 * (time.perf_counter() - t1))
    served = np.zeros_like(feed)
    with PlainCalls() as plain:
        for k in range(n_ticks):
            if k == NS_WARM:
                torch.cuda.synchronize()
                server.stats = ServeStats()
                ops.LAUNCHES = 0
                ops.LAUNCHES_BY_ROUTE.clear()
                zero_counts(lk, tk)
                plain.calls = 0
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
            if server.tick() != ZOO_SLOTS:
                raise AssertionError(f"4m {name} tick {k}: not every slot served")
            for i, sid in enumerate(sids):
                got = server.hub.pop_output(sid, chunk)
                if len(got) != chunk or not np.isfinite(got).all():
                    raise AssertionError(f"4m {name} tick {k} slot {sid}: bad output")
                served[i, k * chunk:(k + 1) * chunk] = got
        torch.cuda.synchronize()
    frames = chunk // 16
    ends = sum(((k + 1) * frames) % 150 == 0 for k in range(NS_WARM, n_ticks))
    routes = dict(ops.LAUNCHES_BY_ROUTE)
    expect_launches((ops.LAUNCHES, routes, counts(lk, tk), plain.calls),
                    (ZOO_TICKS, {"mma": ZOO_TICKS}, (6 * ends, 0, 0, 0), 0),
                    f"4m {name} serving ticks: fused_skim_frames, by route, LSTM / TCN "
                    "(the MemLSTM at segment ends), plain versions")
    stats = server.stats.snapshot()
    if stats["underrun_slot_ticks"]:
        raise AssertionError(f"4m {name}: {stats['underrun_slot_ticks']} underruns")
    held = np.linspace(0, ZOO_SLOTS - 1, ZOO_HELD).round().astype(int)
    st, ref = engine32.init_state(ZOO_HELD), []
    with torch.no_grad():
        for k in range(n_ticks):
            y, st = engine32.step(torch.from_numpy(feed[held, k * chunk:(k + 1) * chunk]).to(dev),
                                  d32[held], st, fused=True)
            ref.append(y)
    ref = torch.cat(ref, -1).cpu()
    snrs = [snr_db(torch.from_numpy(served[i]), ref[j]) for j, i in enumerate(held)]
    snr = min(snrs)
    if not snr >= GATE_BF16_BAR:
        raise AssertionError(f"4m {name} bf16 vs f32: SNR by slot {dict(zip(held, snrs))} dB, "
                             f"under {GATE_BF16_BAR:g}")
    log("4m zoo serving", f"{name} ({ZOO_PARAMS[name]:,} params), make_session_server(half="
        f"True, fused=True), {ZOO_SLOTS} sessions attached by 1 s enrollments in {t_attach:.2f} "
        f"s (embedded on the card in bf16: LSTM / TCN launches {lf * ZOO_SLOTS} / "
        f"{tf * ZOO_SLOTS}; d-vector cosine to the f32 embed, worst of {ZOO_SLOTS}, {cos:.6f}, "
        f"bar {ZOO_DVEC_COS:g}); engine "
        f"step alone p50 {float(np.median(step_ms)):.3f} ms (min {min(step_ms):.3f}); "
        f"{ZOO_TICKS} ticks of {chunk} samples after {NS_WARM} warm-up: every output finite, "
        f"fused_skim_frames launches {ZOO_TICKS} (by route {routes}), MemLSTM scans {6 * ends} "
        f"at {ends} segment ends, plain-version calls 0, 0 underruns; tick p50 "
        f"{stats['tick_ms_p50']:.3f} ms, p99 {stats['tick_ms_p99']:.3f} ms; slots "
        f"{held.tolist()} vs the f32 engine on the f32 embed: worst {snr:.1f} dB, best "
        f"{max(snrs):.1f} (bar {GATE_BF16_BAR:g}) [{card}]", t)
    res = {"launches": ZOO_TICKS, "lstm": lf * ZOO_SLOTS + 6 * ends, "tcn": tf * ZOO_SLOTS,
           "tick_p50": stats["tick_ms_p50"], "tick_p99": stats["tick_ms_p99"],
           "step_p50": float(np.median(step_ms)), "snr": snr, "dvec_cos": cos,
           "attach_s": t_attach}
    res["f32"] = zoo_f32_serving(lk, tk, name, model, dev, card)
    return res


def zoo_f32_serving(lk, tk, name, model, dev, card) -> dict:
    """Phase 4m: the f32 unfused server (fused=False) at ZOO_F32_SLOTS
    sessions attached by 3 s enrollments, ZOO_F32_TICKS ticks of 15 ms: exact
    launches (4 SegLSTM one-frame scans a frame, 6 MemLSTM scans a segment
    end), each slot >= 60 dB from the offline inference of its zero-primed
    input."""
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.streaming.engine import offline_equivalent_input

    t = time.perf_counter()
    bundle = make_session_server(model, None, n_slots=ZOO_F32_SLOTS, chunk_ms=15.0,
                                 fused=False, lockstep=True, enroll_len=16000)
    server, chunk = bundle.server, bundle.chunk_samples
    rng = np.random.default_rng(SEED + 132)
    enrolls = (0.1 * rng.standard_normal((ZOO_F32_SLOTS, 48000))).astype(np.float32)
    feed = (0.1 * rng.standard_normal((ZOO_F32_SLOTS, chunk * ZOO_F32_TICKS))).astype(np.float32)
    lf, tf = (2, 0) if name.endswith("v1_causal") else (0, 5)
    zero_counts(lk, tk)
    sids = [server.attach(enroll=enrolls[i]) for i in range(ZOO_F32_SLOTS)]
    served = np.zeros_like(feed)
    with PlainCalls() as plain:
        for k in range(ZOO_F32_TICKS):
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
            if server.tick() != ZOO_F32_SLOTS:
                raise AssertionError(f"4m {name} f32 tick {k}: not every slot served")
            for i, sid in enumerate(sids):
                served[i, k * chunk:(k + 1) * chunk] = server.hub.pop_output(sid, chunk)
        torch.cuda.synchronize()
    frames = ZOO_F32_TICKS * chunk // 16
    want = (lf * ZOO_F32_SLOTS + 4 * frames + 6 * (frames // 150), 0, tf * ZOO_F32_SLOTS, 0)
    got = counts(lk, tk)
    expect_launches((got, plain.calls), (want, 0), f"4m {name} f32 server, LSTM / TCN, plain")
    stats = server.stats.snapshot()
    with torch.no_grad():
        x = torch.from_numpy(feed).to(dev)
        offline = model.inference(offline_equivalent_input(x, 32, 16),
                                  torch.from_numpy(enrolls).to(dev))[:, :feed.shape[1]]
    snr = min(snr_np(served[i], offline[i].cpu().numpy()) for i in range(ZOO_F32_SLOTS))
    if snr < EVAL_BAR_DB or stats["underrun_slot_ticks"] or not np.isfinite(served).all():
        raise AssertionError(f"4m {name} f32: streamed vs offline {snr:.1f} dB (bar "
                             f"{EVAL_BAR_DB:g}), underruns {stats['underrun_slot_ticks']}")
    log("4m zoo serving", f"{name} f32, make_session_server(fused=False): {ZOO_F32_SLOTS} "
        f"sessions attached by 3 s enrollments, {ZOO_F32_TICKS} ticks of {chunk} samples: "
        f"launches LSTM / TCN fwd {got[0]} / {got[2]} (as the path predicts), plain-version "
        f"calls 0, 0 underruns, tick p50 {stats['tick_ms_p50']:.3f} ms, p99 "
        f"{stats['tick_ms_p99']:.3f} ms; each slot vs the offline inference of its "
        f"zero-primed input: worst {snr:.1f} dB (bar {EVAL_BAR_DB:g}) [{card}]", t)
    return {"lstm": got[0], "tcn": got[2], "snr": snr, "tick_p50": stats["tick_ms_p50"],
            "tick_p99": stats["tick_ms_p99"]}


def veve_cohort(lk, dev, card) -> dict:
    """Phase 4m: `veve_dprnn_v0_causal` in f32, a fixed cohort of VEVE_STREAMS
    streams through the port's StreamingServer (20 ms chunks, one segment of
    20 frames a tick), their states from `init_state(enroll_feats=)` of their
    3 s enrollments: exact launches (12 a tick: each block's intra scan over
    [B, 20] and its one-step inter scan over [B * 20, 1]; 12 for the
    conditioning), every stream >= 60 dB from the offline inference of its
    zero-primed input with its enrollment; tick p50 / p99. A 16 ms chunk is
    refused at build, naming the lengths that work."""
    from puresound_tpu_torch.streaming.engine import StreamingTSE, offline_equivalent_input
    from puresound_tpu_torch.streaming.file_eval import check_chunk_frames
    from puresound_tpu_torch.streaming.server import StreamingServer

    t = time.perf_counter()
    model = zoo_model("veve_dprnn_v0_causal", dev, SEED + 133)
    engine = StreamingTSE.from_offline(model).eval()
    try:
        check_chunk_frames(engine, 256, 16000)
        raise AssertionError("4m veve: a 16 ms chunk passed the segment check")
    except ValueError as e:
        refused = str(e)
    chunk, n, ticks = 320, VEVE_STREAMS, VEVE_TICKS
    rng = np.random.default_rng(SEED + 134)
    enrolls = (0.1 * rng.standard_normal((n, 48000))).astype(np.float32)
    feed = (0.1 * rng.standard_normal((n, chunk * ticks))).astype(np.float32)
    zero_counts(lk)
    with torch.no_grad():
        e = torch.from_numpy(enrolls).to(dev)
        state = {"s": engine.init_state(n, enroll_feats=engine.embed(e))}
    torch.cuda.synchronize()
    cond = count_of(lk, "FWD_BY_ENTRY")

    def step_fn(batch):
        with torch.no_grad():
            y, state["s"] = engine.step(torch.from_numpy(batch).to(dev), None, state["s"])
        return y

    server = StreamingServer(step_fn, n, chunk, lockstep=True)
    served = np.zeros_like(feed)
    zero_counts(lk)
    with PlainCalls() as plain:
        for k in range(ticks):
            for i in range(n):
                server.hub.push_input(i, feed[i, k * chunk:(k + 1) * chunk])
            if server.tick() != n:
                raise AssertionError(f"4m veve tick {k}: not every stream served")
            for i in range(n):
                served[i, k * chunk:(k + 1) * chunk] = server.hub.pop_output(i, chunk)
        torch.cuda.synchronize()
    expect_launches((cond, count_of(lk, "FWD_BY_ENTRY"), count_of(lk, "BWD_BY_ENTRY"),
                     plain.calls), (12, 12 * ticks, 0, 0),
                    "4m veve: conditioning and ticks, lstm_scan_train_fp fwd / bwd, plain")
    stats = server.stats.snapshot()
    with torch.no_grad():
        offline = model.inference(offline_equivalent_input(torch.from_numpy(feed).to(dev), 32, 16),
                                  e)[:, :feed.shape[1]].cpu().numpy()
    snr = min(snr_np(served[i], offline[i]) for i in range(n))
    if snr < EVAL_BAR_DB or not np.isfinite(served).all():
        raise AssertionError(f"4m veve: streamed vs offline {snr:.1f} dB (bar {EVAL_BAR_DB:g})")
    log("4m zoo serving", f"veve_dprnn_v0_causal ({ZOO_PARAMS['veve_dprnn_v0_causal']:,} "
        f"params) f32: {n} streams through StreamingServer, states from init_state(enroll_"
        f"feats=) of 3 s enrollments ({cond} LSTM launches), {ticks} ticks of {chunk} samples: "
        f"launches {12 * ticks} (12 a tick), plain-version calls 0, tick p50 "
        f"{stats['tick_ms_p50']:.3f} ms, p99 {stats['tick_ms_p99']:.3f} ms; each stream vs the "
        f"offline inference of its zero-primed input with its enrollment: worst {snr:.1f} dB "
        f"(bar {EVAL_BAR_DB:g}); a 16 ms chunk refused: {refused} [{card}]", t)
    return {"lstm": cond + 12 * ticks, "snr": snr, "tick_p50": stats["tick_ms_p50"],
            "tick_p99": stats["tick_ms_p99"]}


def zoo_serving_phase(ops, lk, tk, dev, card) -> dict:
    """Phase 4m: v1 / v2 served fused in bf16 and unfused in f32, and the
    veve cohort."""
    out = {name: zoo_bf16_serving(ops, lk, tk, name, dev, card)
           for name in ("tse_skim_v1_causal", "tse_skim_v2_causal")}
    out["veve_dprnn_v0_causal"] = veve_cohort(lk, dev, card)
    return out


def zoo_step_prepare(model):
    """6k's card vs CPU step: dropout 0 (v1's speaker BiLSTM), SpecAugment's
    draws fixed (v2), on both sides."""
    for m in model.modules():
        if type(m).__name__ == "Dropout":
            m.p = 0.0
        if type(m).__name__ == "SpecAugment":
            m.draw = lambda g: torch.tensor(ZOO_DRAWS, device=g.device)


def zoo_recipe_phase(lk, tk, dev, card, keep: str, backend: str = "cuda") -> dict:
    """Phase 6k: each of the four through `python -m
    puresound_tpu_torch.egs.tse.main` on a copy of the shipped 1a config
    with MODEL.type swapped (SI-SNR + 10 x AAM-softmax, B=12 x 3 s, 5 s
    enrollments), ZOO_RECIPE_STEPS steps + 1 dev batch: finite losses, exact
    launches, step p50, host gap, peak memory, epoch_0.ckpt reloading equal;
    then one f32 step (B=2 x 0.5 s, dropout 0, SpecAugment's draws fixed) on
    the card against the CPU's f64 step, gated as phase 6g. Checkpoints go
    to <keep>/<name> for 7d."""
    import tempfile

    from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
    from puresound_tpu_torch.zoo.tse import init_loss, init_model

    out = {}
    for name in ZOO_PARAMS:
        t = time.perf_counter()
        steps = ZOO_RECIPE_STEPS
        with tempfile.TemporaryDirectory() as tmp:
            path = shipped_config(
                SHIPPED_TSE[0], tmp,
                write_tse_manifest(os.path.join(tmp, "train"), 12 * steps, 9),
                write_tse_manifest(os.path.join(tmp, "dev"), 12, 10))
            hp = load_hparam(path)
            hp["MODEL"]["type"] = name
            dump_hparam(hp, path)
            torch.cuda.reset_peak_memory_stats()
            res = run_recipe(lk, tk, "puresound_tpu_torch.egs.tse.main", path, backend)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            lf, tf = ZOO_LAUNCHES[name]
            got = res["launches"]
            expect_launches(got, (lf * (steps + 1), lf * steps, tf * (steps + 1), tf * steps),
                            f"6k {name} recipe, LSTM and TCN (fwd, bwd)")
            model = res["trainer"].model
            w0 = init_loss(hp, device=dev, generator=torch.Generator().manual_seed(0))[1]
            moved = (model.loss_func_spk.weight - w0.weight).abs().max().item()
            if (moved > 0) != (model.task != 4):
                raise AssertionError(f"6k {name}: task {model.task}, AAM-softmax weight "
                                     f"moved {moved}")
            fresh = init_model(name, *init_loss(hp, device=dev), device=dev)
            info = recipe_checks(res, steps, dev, fresh, f"6k {name} recipe")
            keep_checkpoints(res["trainer"], os.path.join(keep, name))
        g = step_gaps(res, steps, 1)
        losses = res["losses"]
        log("6k zoo recipe", f"python -m puresound_tpu_torch.egs.tse.main {SHIPPED_TSE[0]} "
            f"with MODEL.type {name} ({ZOO_PARAMS[name]:,} params; task {model.task}), "
            f"B={hp['TRAIN']['batch_size']} x 3 s, 5 s enrollments, {steps} steps + 1 dev batch "
            f"on {res['trainer'].device}: losses {losses[0]:.4f} -> {losses[-1]:.4f}, dev "
            f"{res['dev_loss'][0]:.4f}, AAM-softmax weight moved by max {moved:.3e}; "
            + gap_text(g, steps, 1, hp["TRAIN"]["batch_size"] * 3)
            + f"; peak memory {peak:.2f} GiB; launches LSTM fwd/bwd {got[:2]}, TCN fwd/bwd "
            f"{got[2:]}, serving kernels {res['serving']}; epoch_0.ckpt reloads equal "
            f"({info[0]}, {info[1]}) [{card}]", t)
        check = tse_card_vs_cpu(name, hp, lk, tk, dev, card, zoo_step_prepare,
                                "6k zoo train step")
        out[name] = dict(g, launches=tuple(a + b for a, b in zip(got, check["launches"])),
                         peak_gib=peak, steps=steps, check=check, aam_moved=moved)
    return out


def eval_7d_phase(lk, tk, dev, card, keep: str, backend: str = "cuda") -> dict:
    """Phase 7d: the four models' evaluation actions through the TSE CLI on
    6k's checkpoints (model_average 2), ZOO_EVAL_UTTS mixtures of 4 s with 3
    s enrollments: `dev --metrics detail` (every row equal to Metrics of the
    outputs), `eval`, `eval --batch_eval 2` (on the grid: >= 60 dB from B=1),
    and `stream_eval` at 15 ms for v1 / v2 (>= 60 dB from the offline
    inference of the zero-primed input, exact launches); v0 (non-causal) and
    veve (embedding-free) refuse to stream with a ValueError."""
    import tempfile

    from puresound_tpu_torch.src.audio import AudioIO
    from puresound_tpu_torch.src.utils import dump_hparam, load_hparam, load_text_as_dict

    module = "puresound_tpu_torch.egs.tse.main"
    out = {"launches": [0, 0, 0, 0], "serving": [0] * 5, "by_model": {}}
    probe = EvalProbe()
    with tempfile.TemporaryDirectory() as tmp, probe:
        for name in ZOO_PARAMS:
            t = time.perf_counter()
            lf, tf = ZOO_LAUNCHES[name]
            full = write_eval_manifest(os.path.join(tmp, name, "full"), ZOO_EVAL_UTTS,
                                       SEED + 140, True)
            stream = write_eval_manifest(os.path.join(tmp, name, "stream"), TSE_STREAM[0],
                                         SEED + 141, True, TSE_STREAM[1])
            hp = load_hparam(SHIPPED_TSE[0])
            hp["MODEL"]["type"] = name
            hp["TRAIN"].update(model_save_dir=os.path.join(keep, name), model_average=2,
                               log_dir=os.path.join(tmp, name, "logs"))
            cfgs = {}
            for label, folder in (("full", full), ("stream", stream)):
                hp["DATASET"].update(dev=folder, eval=folder, train=folder)
                cfgs[label] = os.path.join(tmp, name, f"{label}.yaml")
                dump_hparam(hp, cfgs[label])
            ck = ["--ckpt", "epoch_1.ckpt", "--backend", backend]
            cli = lambda cfg, *args: run_cli(module, cfgs[cfg], [*args, *ck], probe, lk, tk)
            res = {"dev": cli("full", "--action", "dev", "--metrics", "detail"),
                   "eval": cli("full", "--action", "eval"),
                   "batch": cli("full", "--action", "eval", "--batch_eval",
                                str(ZOO_EVAL_BATCH), "--eval_quantum", str(ZOO_EVAL_QUANTUM))}
            n = ZOO_EVAL_UTTS
            n_b = -(-n // ZOO_EVAL_BATCH)
            for key, calls in (("dev", n), ("eval", n), ("batch", n_b)):
                expect_launches((res[key]["launches"], res[key]["serving"]),
                                ((lf * calls, 0, tf * calls, 0), (0,) * 5),
                                f"7d {name} {key}: LSTM fwd/bwd, TCN fwd/bwd; serving")
                check_models(res[key], dev, f"7d {name} {key}")
            want = rescore(full, res["dev"]["outputs"], True)
            printed = dev_rows(res["dev"]["stdout"], 6)
            if printed != want or len(printed) != n or not np.isfinite(
                    list(want.values())).all():
                raise AssertionError(f"7d {name} dev: printed {printed}, Metrics {want}")
            keys = sorted(res["eval"]["saved"])
            batch = min(snr_np(res["batch"]["saved"][k], res["eval"]["saved"][k]) for k in keys)
            if not batch >= EVAL_BAR_DB:
                raise AssertionError(f"7d {name}: batched vs unbatched {batch:.1f} dB")
            streams, refused = {}, None
            n_s, L_s = stream_set(True)
            if name in ("tse_skim_v0", "veve_dprnn_v0_causal"):
                try:
                    cli("stream", "--action", "stream_eval", "--chunk_ms", "15")
                    raise AssertionError(f"7d {name}: stream_eval ran")
                except ValueError as e:
                    refused = str(e)
            else:
                r = cli("stream", "--action", "stream_eval", "--chunk_ms", "15")
                per_utt = -(-L_s // 240) + 1
                ticks = per_utt * n_s
                mem = 6 * ((per_utt - 1) * 15 // 150) * n_s
                spk = 2 if name.endswith("v1_causal") else 0
                expect_launches((r["launches"], r["serving"]),
                                ((4 * 15 * ticks + mem + spk * n_s, 0, tf * n_s, 0), (0,) * 5),
                                f"7d {name} stream_eval")
                check_models(r, dev, f"7d {name} stream_eval")
                model = res["eval"]["models"][0]
                scp = load_text_as_dict(os.path.join(stream, "wav2scp.txt"))
                enr = load_text_as_dict(os.path.join(stream, "ref2list.txt"))
                got = []
                with torch.inference_mode():
                    for k in sorted(scp):
                        x = torch.from_numpy(AudioIO.open(scp[k][0])[0]).to(dev)
                        e = torch.from_numpy(AudioIO.open(enr[k][0], target_lvl=-28)[0]).to(dev)
                        off = model.inference(torch.nn.functional.pad(x, (16, 0)), e)
                        got.append(snr_np(r["saved"][k][:L_s], off[0, :L_s].float().cpu().numpy()))
                streams = {"db": min(got), "rtf": float(np.mean(r["rtfs"])),
                           "launches": r["launches"]}
                if not streams["db"] >= EVAL_BAR_DB:
                    raise AssertionError(f"7d {name} stream_eval: {streams['db']:.1f} dB")
                out["launches"] = [a + b for a, b in zip(out["launches"], r["launches"])]
            for key in ("dev", "eval", "batch"):
                out["launches"] = [a + b for a, b in zip(out["launches"], res[key]["launches"])]
            d, e, b = res["dev"], res["eval"], res["batch"]
            audio_s = n * EVAL_SECONDS
            means = dict(zip(("PESQ", "STOI", "SDR", "SiSNR", "SiSNRi", "NSR"),
                             map(float, np.mean(list(want.values()), axis=0))))
            out["by_model"][name] = {"dev_wall_s": d["wall_s"], "eval_rtf": audio_s / e["wall_s"],
                                     "eval_model_rtf": audio_s / e["model_s"],
                                     "batch_rtf": audio_s / b["wall_s"], "batch_db": batch,
                                     "streams": streams, "refused": refused, "dev_means": means}
            log("7d zoo eval", f"python -m {module} (1a with MODEL.type {name}; --ckpt "
                f"epoch_1.ckpt, model_average 2) on {n} mixtures of {EVAL_SECONDS:g} s: dev "
                f"--metrics detail {d['wall_s']:.2f} s, means " + ", ".join(
                    f"{c} {v:.4f}" for c, v in means.items())
                + f", every row equal to Metrics of the outputs; eval B=1 {e['wall_s']:.2f} s "
                f"(RTF {audio_s / e['wall_s']:.1f}, model alone {audio_s / e['model_s']:.1f}); "
                f"--batch_eval {ZOO_EVAL_BATCH} --eval_quantum {ZOO_EVAL_QUANTUM} "
                f"{b['wall_s']:.2f} s (RTF {audio_s / b['wall_s']:.1f}), {batch:.1f} dB from B=1; "
                + (f"stream_eval 15 ms on {n_s} mixture of {L_s / 16000:g} s: RTF "
                   f"{streams['rtf']:.2f}, {streams['db']:.1f} dB from the offline inference of "
                   f"the zero-primed input, launches (LSTM fwd, TCN fwd) "
                   f"{streams['launches'][::2]}" if streams else f"stream_eval refused: {refused}")
                + f"; launches dev / eval / batch (LSTM fwd, TCN fwd) {d['launches'][::2]} / "
                f"{e['launches'][::2]} / {b['launches'][::2]}, no backward, no serving kernel "
                f"[{card}]", t)
    return out


def zoo_phases(ops, lk, tk, dev, card) -> dict:
    """Phases 2l, 4m, 6k and 7d; each kernel's launches by phase."""
    import tempfile

    shapes = zoo_shapes_phase(lk, tk, dev, card)
    serving = zoo_serving_phase(ops, lk, tk, dev, card)
    keep = tempfile.mkdtemp(prefix="chip_smoke_ckpt_7d_")
    try:
        recipes = zoo_recipe_phase(lk, tk, dev, card, keep)
        evals = eval_7d_phase(lk, tk, dev, card, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    bf = [serving[n] for n in ("tse_skim_v1_causal", "tse_skim_v2_causal")]
    l4m = sum(r["lstm"] + r["f32"]["lstm"] for r in bf) + serving["veve_dprnn_v0_causal"]["lstm"]
    t4m = sum(r["tcn"] + r["f32"]["tcn"] for r in bf)
    r6k = [sum(r["launches"][i] for r in recipes.values()) for i in range(4)]
    table = lambda v: {"lstm_scan_train_fp fwd": v[0], "lstm_scan_train_fp bwd": v[1],
                       "tcn_block_train fwd": v[2], "tcn_block_train bwd": v[3]}
    launches = {"2l": table(shapes["launches"]),
                "4m": dict(table((l4m, 0, t4m, 0)),
                           fused_skim_frames=sum(r["launches"] for r in bf)),
                "6k": table(r6k), "7d": table(evals["launches"])}
    log("8 zoo launches", f"2l {launches['2l']}; 4m {launches['4m']}; 6k {launches['6k']}; "
        f"7d {launches['7d']}", time.perf_counter())
    return {"shapes": shapes, "serving": serving, "recipes": recipes, "evals": evals,
            "launches": launches}


# ------------------------------------------------------------ phases 4n, 6l, 7e
#: the STFT-domain TSE models and their parameter counts (JAX's, from
#: `jax.eval_shape` of init; with the 1a config's AAM-softmax 48,192 more)
UNET_PARAMS = {"tse_unet_tcn_v0": 13_324_533, "tse_unet_tcn_v0_causal": 13_324_533,
               "tse_unet_tcn_v1": 13_177_077}
#: the Unet path launches none of the port's kernels: no LSTM, and its
#: GatedTCN blocks have no kernel (JAX's have no Pallas call either)
TSE_LAUNCHES.update({name: (0, 0) for name in UNET_PARAMS})
UNET_SERVED = "tse_unet_tcn_v0_causal"   # the one that streams
UNET_CHUNK_MS = 16.0                # 2 hop frames a tick
UNET_SLOTS, UNET_TICKS = 256, 100   # phase 4n: bf16 serving
UNET_HALF_BAR = 35.0                # bf16 vs the f32 engine, dB (read 43.1 on an H100)
UNET_F32_SLOTS, UNET_F32_TICKS = 8, 40
UNET_LOOKAHEAD = 1152               # 6 frames of transpose_delay + the 384-sample overlap-add
UNET_RECIPE_STEPS = 3               # phase 6l
UNET_EVAL_UTTS = 4                  # phase 7e: mixtures of EVAL_SECONDS


def unet_model(name, dev, seed):
    """The STFT-domain zoo model at full width from a seed, its parameter
    count JAX's."""
    from puresound_tpu_torch.zoo.tse import init_model

    model = init_model(name, device=dev, generator=torch.Generator().manual_seed(seed))
    n = sum(p.numel() for p in model.parameters())
    if n != UNET_PARAMS[name]:
        raise AssertionError(f"{name}: {n:,} parameters, JAX counts {UNET_PARAMS[name]:,}")
    return model


def no_launches(lk, tk, serving, plain, label: str):
    """The Unet path's rule: no training kernel, no serving kernel and no
    plain version of a kernel ran."""
    expect_launches((counts(lk, tk), counter_values(serving), plain),
                    ((0, 0, 0, 0), (0,) * len(serving), 0),
                    f"{label}: LSTM / TCN (fwd, bwd), serving kernels, plain versions")


def unet_f32_serving(lk, tk, model, dev, card) -> dict:
    """Phase 4n: the f32 server at UNET_F32_SLOTS sessions attached by 3 s
    enrollments, UNET_F32_TICKS ticks of 16 ms: each slot >= 60 dB from the
    offline inference of its zero-primed input, UNET_LOOKAHEAD samples
    behind (past the first analysis window)."""
    from puresound_tpu_torch.streaming.deploy import make_session_server

    t = time.perf_counter()
    bundle = make_session_server(model, None, n_slots=UNET_F32_SLOTS, chunk_ms=UNET_CHUNK_MS,
                                 lockstep=True, enroll_len=16000)
    server, chunk = bundle.server, bundle.chunk_samples
    rng = np.random.default_rng(SEED + 151)
    enrolls = (0.1 * rng.standard_normal((UNET_F32_SLOTS, 48000))).astype(np.float32)
    feed = (0.1 * rng.standard_normal((UNET_F32_SLOTS, chunk * UNET_F32_TICKS))).astype(
        np.float32)
    serving = serving_counters()
    zero_counts(lk, tk)
    zero_counters(serving)
    sids = [server.attach(enroll=enrolls[i]) for i in range(UNET_F32_SLOTS)]
    served = np.zeros_like(feed)
    with PlainCalls() as plain:
        for k in range(UNET_F32_TICKS):
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
            if server.tick() != UNET_F32_SLOTS:
                raise AssertionError(f"4n f32 tick {k}: not every slot served")
            for i, sid in enumerate(sids):
                served[i, k * chunk:(k + 1) * chunk] = server.hub.pop_output(sid, chunk)
        torch.cuda.synchronize()
    no_launches(lk, tk, serving, plain.calls, "4n f32 server")
    stats = server.stats.snapshot()
    n_fft, hop = model.encoder.fft_length, model.encoder.hop_length
    shift = model.masker.stream_delay_frames * hop
    if n_fft - hop + shift != UNET_LOOKAHEAD:
        raise AssertionError(f"4n: lookahead {n_fft - hop + shift}, not {UNET_LOOKAHEAD}")
    with torch.no_grad():
        x = torch.nn.functional.pad(torch.from_numpy(feed).to(dev), (n_fft - hop, 0))
        offline = model.inference(x, torch.from_numpy(enrolls).to(dev)).cpu().numpy()
    L = feed.shape[1]
    snr = min(snr_np(served[i, n_fft + shift:], offline[i, n_fft:L - shift])
              for i in range(UNET_F32_SLOTS))
    if snr < EVAL_BAR_DB or stats["underrun_slot_ticks"] or not np.isfinite(served).all():
        raise AssertionError(f"4n f32: streamed vs offline {snr:.1f} dB (bar {EVAL_BAR_DB:g}), "
                             f"underruns {stats['underrun_slot_ticks']}")
    log("4n unet serving", f"{UNET_SERVED} f32, make_session_server: {UNET_F32_SLOTS} sessions "
        f"attached by 3 s enrollments, {UNET_F32_TICKS} ticks of {chunk} samples: no kernel "
        f"launched and no plain version (the Unet path has none), 0 underruns, tick p50 "
        f"{stats['tick_ms_p50']:.3f} ms, p99 {stats['tick_ms_p99']:.3f} ms; each slot vs the "
        f"offline inference of its zero-primed input, {UNET_LOOKAHEAD} samples behind: worst "
        f"{snr:.1f} dB (bar {EVAL_BAR_DB:g}) [{card}]", t)
    return {"snr": snr, "tick_p50": stats["tick_ms_p50"], "tick_p99": stats["tick_ms_p99"]}


def unet_serving_phase(lk, tk, dev, card) -> dict:
    """Phase 4n: `tse_unet_tcn_v0_causal` through make_session_server(half=
    True) at UNET_SLOTS sessions, 16 ms ticks (2 hop frames), each session
    attached by its 1 s enrollment (embedded on the card in bf16, every
    d-vector within cosine ZOO_DVEC_COS of the f32 embed); the engine step
    alone, then NS_WARM + UNET_TICKS ticks: no kernel and no plain version
    launched, 0 underruns, tick p50 / p99; ZOO_HELD slots against the f32
    engine on the f32 embed (>= UNET_HALF_BAR); then the f32 server at
    UNET_F32_SLOTS (>= 60 dB from offline)."""
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.streaming.ns_engine import StreamingNS
    from puresound_tpu_torch.streaming.server import ServeStats

    t = time.perf_counter()
    bf = torch.bfloat16
    model = unet_model(UNET_SERVED, dev, SEED + 150)
    engine32 = StreamingNS.from_offline(model).eval()
    bundle = make_session_server(model, None, n_slots=UNET_SLOTS, chunk_ms=UNET_CHUNK_MS,
                                 half=True, lockstep=True, enroll_len=16000)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    if chunk != 2 * model.encoder.hop_length or bundle.embed_dim != 192:
        raise AssertionError(f"4n: chunk {chunk}, embed_dim {bundle.embed_dim}")
    n_ticks = NS_WARM + UNET_TICKS
    rng = np.random.default_rng(SEED + 152)
    enrolls = (0.1 * rng.standard_normal((UNET_SLOTS, 16000))).astype(np.float32)
    feed = (0.1 * rng.standard_normal((UNET_SLOTS, chunk * n_ticks))).astype(np.float32)
    serving = serving_counters()
    zero_counts(lk, tk)
    zero_counters(serving)
    ta = time.perf_counter()
    sids = [server.attach(enroll=enrolls[i]) for i in range(UNET_SLOTS)]
    torch.cuda.synchronize()
    t_attach = time.perf_counter() - ta
    dvecs = torch.from_numpy(server._dvec.copy()).to(dev)
    with torch.no_grad():
        d32 = engine32.embed(torch.from_numpy(enrolls).to(dev))
    cos = torch.nn.functional.cosine_similarity(d32, dvecs).min().item()
    if not cos >= ZOO_DVEC_COS:
        raise AssertionError(f"4n: bf16 d-vector cosine to the f32 embed {cos:.6f} < "
                             f"{ZOO_DVEC_COS:g}")
    x = torch.from_numpy(feed[:, :chunk]).to(dev, bf)
    state, step_ms = engine.init_state(UNET_SLOTS, bf), []
    with torch.no_grad():
        for k in range(NS_WARM + NS_TICKS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, state = engine.step(x, state, dvecs.to(bf))
            torch.cuda.synchronize()
            if k >= NS_WARM:
                step_ms.append(1e3 * (time.perf_counter() - t1))
    served = np.zeros_like(feed)
    with PlainCalls() as plain:
        for k in range(n_ticks):
            if k == NS_WARM:
                torch.cuda.synchronize()
                server.stats = ServeStats()
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
            if server.tick() != UNET_SLOTS:
                raise AssertionError(f"4n tick {k}: not every slot served")
            for i, sid in enumerate(sids):
                got = server.hub.pop_output(sid, chunk)
                if len(got) != chunk or not np.isfinite(got).all():
                    raise AssertionError(f"4n tick {k} slot {sid}: bad output")
                served[i, k * chunk:(k + 1) * chunk] = got
        torch.cuda.synchronize()
    no_launches(lk, tk, serving, plain.calls, "4n bf16 attaches, engine steps and ticks")
    stats = server.stats.snapshot()
    if stats["underrun_slot_ticks"]:
        raise AssertionError(f"4n: {stats['underrun_slot_ticks']} underruns")
    held = np.linspace(0, UNET_SLOTS - 1, ZOO_HELD).round().astype(int)
    st, ref = engine32.init_state(ZOO_HELD), []
    with torch.no_grad():
        for k in range(n_ticks):
            y, st = engine32.step(torch.from_numpy(feed[held, k * chunk:(k + 1) * chunk]).to(dev),
                                  st, d32[held])
            ref.append(y)
    ref = torch.cat(ref, -1).cpu()
    snrs = [snr_db(torch.from_numpy(served[i]), ref[j]) for j, i in enumerate(held)]
    snr = min(snrs)
    if not snr >= UNET_HALF_BAR:
        raise AssertionError(f"4n bf16 vs f32: SNR by slot {dict(zip(held, snrs))} dB, under "
                             f"{UNET_HALF_BAR:g}")
    log("4n unet serving", f"{UNET_SERVED} ({UNET_PARAMS[UNET_SERVED]:,} params), "
        f"make_session_server(half=True), {UNET_SLOTS} sessions attached by 1 s enrollments in "
        f"{t_attach:.2f} s (embedded on the card in bf16; d-vector cosine to the f32 embed, "
        f"worst of {UNET_SLOTS}, {cos:.6f}, bar {ZOO_DVEC_COS:g}); engine step alone p50 "
        f"{float(np.median(step_ms)):.3f} ms (min {min(step_ms):.3f}); {UNET_TICKS} ticks of "
        f"{chunk} samples after {NS_WARM} warm-up: every output finite, no kernel launched and "
        f"no plain version (the Unet path has none), 0 underruns; tick p50 "
        f"{stats['tick_ms_p50']:.3f} ms, p99 {stats['tick_ms_p99']:.3f} ms; slots "
        f"{held.tolist()} vs the f32 engine on the f32 embed: worst {snr:.1f} dB, best "
        f"{max(snrs):.1f} (bar {UNET_HALF_BAR:g}) [{card}]", t)
    return {"tick_p50": stats["tick_ms_p50"], "tick_p99": stats["tick_ms_p99"],
            "step_p50": float(np.median(step_ms)), "snr": snr, "dvec_cos": cos,
            "attach_s": t_attach, "f32": unet_f32_serving(lk, tk, model, dev, card)}


def unet_recipe_phase(lk, tk, dev, card, keep: str, backend: str = "cuda") -> dict:
    """Phase 6l: each STFT-domain model through `python -m
    puresound_tpu_torch.egs.tse.main` on a copy of the shipped 1a config with
    MODEL.type swapped (SI-SNR + 10 x AAM-softmax, B=12 x 3 s, 5 s
    enrollments), UNET_RECIPE_STEPS steps + 1 dev batch: finite losses, no
    kernel launched, step p50, host gap, peak memory, epoch_0.ckpt reloading
    equal; then one f32 step (B=2 x 0.5 s, dropout 0) on the card against
    the CPU's f64 step, gated as phase 6g. Checkpoints go to <keep>/<name>
    for 7e."""
    import tempfile

    from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
    from puresound_tpu_torch.zoo.tse import init_loss, init_model

    out = {}
    for name in UNET_PARAMS:
        t = time.perf_counter()
        steps = UNET_RECIPE_STEPS
        with tempfile.TemporaryDirectory() as tmp:
            path = shipped_config(
                SHIPPED_TSE[0], tmp,
                write_tse_manifest(os.path.join(tmp, "train"), 12 * steps, 9),
                write_tse_manifest(os.path.join(tmp, "dev"), 12, 10))
            hp = load_hparam(path)
            hp["MODEL"]["type"] = name
            dump_hparam(hp, path)
            torch.cuda.reset_peak_memory_stats()
            res = run_recipe(lk, tk, "puresound_tpu_torch.egs.tse.main", path, backend)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            expect_launches(res["launches"], (0, 0, 0, 0), f"6l {name} recipe, LSTM and TCN")
            model = res["trainer"].model
            w0 = init_loss(hp, device=dev, generator=torch.Generator().manual_seed(0))[1]
            moved = (model.loss_func_spk.weight - w0.weight).abs().max().item()
            if not moved > 0:
                raise AssertionError(f"6l {name}: the AAM-softmax weight did not move")
            fresh = init_model(name, *init_loss(hp, device=dev), device=dev)
            info = recipe_checks(res, steps, dev, fresh, f"6l {name} recipe")
            keep_checkpoints(res["trainer"], os.path.join(keep, name))
        g = step_gaps(res, steps, 1)
        losses = res["losses"]
        log("6l unet recipe", f"python -m puresound_tpu_torch.egs.tse.main {SHIPPED_TSE[0]} "
            f"with MODEL.type {name} ({UNET_PARAMS[name]:,} params), "
            f"B={hp['TRAIN']['batch_size']} x 3 s, 5 s enrollments, {steps} steps + 1 dev batch "
            f"on {res['trainer'].device}: losses {losses[0]:.4f} -> {losses[-1]:.4f}, dev "
            f"{res['dev_loss'][0]:.4f}, AAM-softmax weight moved by max {moved:.3e}; "
            + gap_text(g, steps, 1, hp["TRAIN"]["batch_size"] * 3)
            + f"; peak memory {peak:.2f} GiB; no kernel launched (LSTM / TCN "
            f"{res['launches']}, serving {res['serving']}); epoch_0.ckpt reloads equal "
            f"({info[0]}, {info[1]}) [{card}]", t)
        check = tse_card_vs_cpu(name, hp, lk, tk, dev, card, zoo_step_prepare,
                                "6l unet train step")
        out[name] = dict(g, peak_gib=peak, steps=steps, check=check, aam_moved=moved)
    return out


def eval_7e_phase(lk, tk, dev, card, keep: str, backend: str = "cuda") -> dict:
    """Phase 7e: the three models' evaluation actions through the TSE CLI on
    6l's checkpoints (model_average 2), UNET_EVAL_UTTS mixtures of 4 s with 3
    s enrollments: `dev --metrics detail` (every row equal to Metrics of the
    outputs) and `eval` (RTF); `stream_eval` at 16 ms for the causal model
    (>= 60 dB from the offline inference of the zero-primed input past the
    first window, RTF); v0 and v1 (non-causal) refuse to stream with the
    engine's ValueError. No kernel is launched."""
    import tempfile

    from puresound_tpu_torch.src.audio import AudioIO
    from puresound_tpu_torch.src.utils import dump_hparam, load_hparam, load_text_as_dict

    module = "puresound_tpu_torch.egs.tse.main"
    out = {}
    probe = EvalProbe()
    with tempfile.TemporaryDirectory() as tmp, probe:
        for name in UNET_PARAMS:
            t = time.perf_counter()
            full = write_eval_manifest(os.path.join(tmp, name, "full"), UNET_EVAL_UTTS,
                                       SEED + 155, True)
            stream = write_eval_manifest(os.path.join(tmp, name, "stream"), TSE_STREAM[0],
                                         SEED + 156, True, TSE_STREAM[1])
            hp = load_hparam(SHIPPED_TSE[0])
            hp["MODEL"]["type"] = name
            hp["TRAIN"].update(model_save_dir=os.path.join(keep, name), model_average=2,
                               log_dir=os.path.join(tmp, name, "logs"))
            cfgs = {}
            for label, folder in (("full", full), ("stream", stream)):
                hp["DATASET"].update(dev=folder, eval=folder, train=folder)
                cfgs[label] = os.path.join(tmp, name, f"{label}.yaml")
                dump_hparam(hp, cfgs[label])
            ck = ["--ckpt", "epoch_1.ckpt", "--backend", backend]
            cli = lambda cfg, *args: run_cli(module, cfgs[cfg], [*args, *ck], probe, lk, tk)
            res = {"dev": cli("full", "--action", "dev", "--metrics", "detail"),
                   "eval": cli("full", "--action", "eval")}
            n = UNET_EVAL_UTTS
            for key in ("dev", "eval"):
                expect_launches((res[key]["launches"], res[key]["serving"]),
                                ((0, 0, 0, 0), (0,) * 5), f"7e {name} {key}: no kernel")
                check_models(res[key], dev, f"7e {name} {key}")
            want = rescore(full, res["dev"]["outputs"], True)
            printed = dev_rows(res["dev"]["stdout"], 6)
            if printed != want or len(printed) != n or not np.isfinite(
                    list(want.values())).all():
                raise AssertionError(f"7e {name} dev: printed {printed}, Metrics {want}")
            streams, refused = {}, None
            n_s, L_s = stream_set(True)
            if name != UNET_SERVED:
                try:
                    cli("stream", "--action", "stream_eval", "--chunk_ms", str(UNET_CHUNK_MS))
                    raise AssertionError(f"7e {name}: stream_eval ran")
                except ValueError as e:
                    refused = str(e)
            else:
                r = cli("stream", "--action", "stream_eval", "--chunk_ms", str(UNET_CHUNK_MS))
                expect_launches((r["launches"], r["serving"]), ((0, 0, 0, 0), (0,) * 5),
                                f"7e {name} stream_eval: no kernel")
                check_models(r, dev, f"7e {name} stream_eval")
                model = res["eval"]["models"][0]
                scp = load_text_as_dict(os.path.join(stream, "wav2scp.txt"))
                enr = load_text_as_dict(os.path.join(stream, "ref2list.txt"))
                pad = model.encoder.fft_length - model.encoder.hop_length
                lo, hi = 512, L_s - 1024
                got = []
                with torch.inference_mode():
                    for k in sorted(scp):
                        x = torch.from_numpy(AudioIO.open(scp[k][0])[0]).to(dev)
                        e = torch.from_numpy(AudioIO.open(enr[k][0], target_lvl=-28)[0]).to(dev)
                        off = model.inference(torch.nn.functional.pad(x, (pad, 0)), e)
                        off = off[0].float().cpu().numpy()
                        got.append(snr_np(r["saved"][k][lo:hi], off[lo + pad:hi + pad]))
                streams = {"db": min(got), "rtf": float(np.mean(r["rtfs"])),
                           "wall_s": r["wall_s"]}
                if not streams["db"] >= EVAL_BAR_DB:
                    raise AssertionError(f"7e {name} stream_eval: {streams['db']:.1f} dB")
            d, e = res["dev"], res["eval"]
            audio_s = n * EVAL_SECONDS
            means = dict(zip(("PESQ", "STOI", "SDR", "SiSNR", "SiSNRi", "NSR"),
                             map(float, np.mean(list(want.values()), axis=0))))
            out[name] = {"dev_wall_s": d["wall_s"], "eval_rtf": audio_s / e["wall_s"],
                         "eval_model_rtf": audio_s / e["model_s"], "streams": streams,
                         "refused": refused, "dev_means": means}
            log("7e unet eval", f"python -m {module} (1a with MODEL.type {name}; --ckpt "
                f"epoch_1.ckpt, model_average 2) on {n} mixtures of {EVAL_SECONDS:g} s: dev "
                f"--metrics detail {d['wall_s']:.2f} s, means " + ", ".join(
                    f"{c} {v:.4f}" for c, v in means.items())
                + f", every row equal to Metrics of the outputs; eval B=1 {e['wall_s']:.2f} s "
                f"(RTF {audio_s / e['wall_s']:.1f}, model alone {audio_s / e['model_s']:.1f}); "
                + (f"stream_eval {UNET_CHUNK_MS:g} ms on {n_s} mixture of {L_s / 16000:g} s: "
                   f"{streams['wall_s']:.2f} s, RTF {streams['rtf']:.2f}, {streams['db']:.1f} dB "
                   "from the offline inference of the zero-primed input past the first window"
                   if streams else f"stream_eval refused: {refused}")
                + f"; no kernel launched [{card}]", t)
    return out


def unet_phases(lk, tk, dev, card) -> dict:
    """Phases 4n, 6l and 7e: the STFT-domain TSE zoo (UnetTcn), which
    launches none of the port's kernels."""
    import tempfile

    serving = unet_serving_phase(lk, tk, dev, card)
    keep = tempfile.mkdtemp(prefix="chip_smoke_ckpt_7e_")
    try:
        recipes = unet_recipe_phase(lk, tk, dev, card, keep)
        evals = eval_7e_phase(lk, tk, dev, card, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    return {"serving": serving, "recipes": recipes, "evals": evals}


# ------------------------------------------------------------ phase 7f
EXPORT_CHUNKS = 40         # StreamStep's 4-hop chunks: 160 frames, past a 150-frame segment
EXPORT_TSNE = (6, 2)       # the tSNE dev set: mixtures, speakers
EXPORT_DVEC_COS = 0.9999   # tSNE's d-vectors, card against CPU, each utterance
EXPORT_PROBE = 16000       # probe_lookahead_receptive's signal, samples
EXPORT_BAR = 1e-5          # a loaded artifact against the eager module, of max|ref|
#: why an STFT model's artifact is not bit-equal to its eager module: two
#: eager calls are not either (phase 4l, scripts/socket_diverge.py)
UNEQUAL = "not bit-equal: cuDNN's default algorithm for the Unet's up-convolution"
DISPATCH_STEPS = 10        # unfused B=1 streaming steps a turn of the op-cost timing
DISPATCH_CALLS = 400       # one-row scans a turn of the op-cost timing
DISPATCH_TURNS = 4         # turns op, direct, direct, op


def write_port_ckpt(model, path: str) -> str:
    """An eval checkpoint of `model` in the port's format (its state_dict,
    read back by `load_eval_model`)."""
    torch.save({"params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "batch_stats": {}}, path)
    return path


@contextlib.contextmanager
def timed_exports(seconds: list):
    """Every `torch.export.export` and `torch.export.save` inside appends
    (its kind, seconds) to `seconds`, in call order."""
    export, save = torch.export.export, torch.export.save

    def timed(kind, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            seconds.append((kind, time.perf_counter() - t))
            return out
        return call

    torch.export.export, torch.export.save = timed("export", export), timed("save", save)
    try:
        yield
    finally:
        torch.export.export, torch.export.save = export, save


def export_cli(module, cfg: str, lk, tk, backend: str = "cuda",
               ckpt: str = "epoch_0.ckpt") -> dict:
    """`--action export_model --ckpt <ckpt>` through a recipe CLI in this
    process: the paths by artifact name, each artifact's export and
    save seconds, the launches (LSTM fwd, bwd, TCN fwd, bwd) of the eager
    calls on the dummy input that export makes first, the wall seconds."""
    seconds = []
    before = counts(lk, tk)
    t = time.perf_counter()
    with timed_exports(seconds):
        paths = module.main(module.parse_args([cfg, "--action", "export_model", "--ckpt",
                                               ckpt, "--backend", backend]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    names = [os.path.basename(p).split(".")[-2] for p in paths]
    ex_s = [s for k, s in seconds if k == "export"]
    sv_s = [s for k, s in seconds if k == "save"]
    if not (len(ex_s) == len(sv_s) == len(names)):
        raise AssertionError(f"export_model: {len(names)} artifacts, {seconds}")
    return {"paths": dict(zip(names, paths)), "launches": since(before, lk, tk), "wall_s": wall,
            "seconds": {n: (e, s) for n, e, s in zip(names, ex_s, sv_s)}}


def since(before, lk, tk) -> tuple:
    """The launches (LSTM fwd, bwd, TCN fwd, bwd) since `counts` read `before`."""
    return tuple(a - b for a, b in zip(counts(lk, tk), before))


def held_to_eager(label, eager_fn, artifact_fn, lk, tk):
    """One call of the eager module and one of the loaded artifact on the
    same inputs: (max|d| / max|ref|, bit-equal, launches of each), failing
    beyond EXPORT_BAR, on a launch count that differs or on no launch of a
    kernel the eager call made."""
    before = counts(lk, tk)
    ref = eager_fn()
    torch.cuda.synchronize()
    eager = since(before, lk, tk)
    before = counts(lk, tk)
    got = artifact_fn()
    torch.cuda.synchronize()
    art = since(before, lk, tk)
    # on the host: the eager engine's state keeps SkiM's clock as an int
    leaves = lambda tree: [torch.as_tensor(x).detach().cpu()
                           for x in torch.utils._pytree.tree_leaves(tree)]
    refs, gots = leaves(ref), leaves(got)
    if len(refs) != len(gots) or any(a.shape != b.shape for a, b in zip(refs, gots)):
        raise AssertionError(f"7f {label}: outputs {[tuple(g.shape) for g in gots]}, eager "
                             f"{[tuple(r.shape) for r in refs]}")
    peak = max(r.double().abs().max().item() for r in refs)
    err = max((g.double() - r.double()).abs().max().item() for g, r in zip(gots, refs))
    equal = all(torch.equal(g, r) for g, r in zip(gots, refs))
    if not (err <= EXPORT_BAR * peak and all(torch.isfinite(g).all() for g in gots)):
        raise AssertionError(f"7f {label}: artifact max|d| {err:.3e} > {EXPORT_BAR:g} * "
                             f"max|ref| ({peak:.3e})")
    expect_launches(art, eager, f"7f {label}: the artifact's launches (LSTM fwd, bwd, TCN "
                    "fwd, bwd) against the eager call's")
    return {"rel_err": err / max(peak, 1e-30), "bit_equal": equal, "launches": art}


def dispatch_cost(lk, model, dev) -> dict:
    """What the torch.library op costs `lstm_scan_train_fp` on the host, in
    turns op, direct, direct, op (DISPATCH_TURNS of them; direct:
    `lk._fp_op` swapped for its body `lk._fp_forward` for the turn):
    DISPATCH_CALLS one-row, one-step scans (B=1, C=128, H=256, the
    flagship's unfused streaming shape) a turn, host microseconds a call
    without a sync; and the flagship's unfused streaming step at B = 1 (16 ms
    chunks: 64 such scans), DISPATCH_STEPS synced steps a turn on the host
    clock, the same input state every step."""
    from puresound_tpu_torch.streaming.engine import StreamingTSE

    engine = StreamingTSE.from_offline(model)
    g = torch.Generator().manual_seed(SEED + 171)
    r = lambda *shape: (0.1 * torch.randn(*shape, generator=g)).to(dev)
    scan = (r(1, 1, 128), r(1, 256), r(1, 256), r(128, 1024), r(1024), r(256, 1024),
            False, False)
    chunk = r(1, 256)
    op = lk._fp_op
    kinds = ["op", "direct", "direct", "op"] * (DISPATCH_TURNS // 4)
    calls, steps = {"op": [], "direct": []}, {"op": [], "direct": []}
    with torch.no_grad():
        dvec = engine.embed(r(1, 16000))
        state = engine.init_state(1)
        for kind in kinds:
            lk._fp_op = op if kind == "op" else lk._fp_forward
            try:
                before = count_of(lk, "FWD_BY_ENTRY")
                for _ in range(3):
                    engine.step(chunk, dvec, state)
                    lk._scan_fp(*scan)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(DISPATCH_CALLS):
                    lk._scan_fp(*scan)
                calls[kind].append(1e6 * (time.perf_counter() - t) / DISPATCH_CALLS)
                torch.cuda.synchronize()
                for _ in range(DISPATCH_STEPS):
                    t = time.perf_counter()
                    engine.step(chunk, dvec, state)
                    torch.cuda.synchronize()
                    steps[kind].append(1e3 * (time.perf_counter() - t))
                launched = count_of(lk, "FWD_BY_ENTRY") - before
            finally:
                lk._fp_op = op
            expect_launches(launched, 65 * 3 + DISPATCH_CALLS + 64 * DISPATCH_STEPS,
                            f"7f dispatch ({kind}): LSTM launches")
    med = lambda v: float(np.median(v))
    return {"op_call_us": med(calls["op"]), "direct_call_us": med(calls["direct"]),
            "per_op_us": med(calls["op"]) - med(calls["direct"]),
            "op_ms": med(steps["op"]), "direct_ms": med(steps["direct"]),
            "op_min_ms": min(steps["op"]), "direct_min_ms": min(steps["direct"]),
            "calls_by_turn": calls}


def export_phase(lk, tk, dev, card, backend: str = "cuda") -> dict:
    """Phase 7f: the recipes' last actions. The flagship (f32 eval, seed
    SEED) through the TSE CLI's `export_model`: each artifact's export and
    save seconds; each loaded with `torch.export.load` (importing the port
    registers its ops), the graphs naming the `puresound_tpu_torch::` ops;
    FullModel, SpeakerNet, MaskNet, EncoderNet and decoderNet on seeded card
    inputs and StreamStep over EXPORT_CHUNKS carried chunks (a 150-frame
    segment boundary crossed) against the eager module and engine: within
    EXPORT_BAR of max|ref|, bit-equality printed, the same LSTM / TCN
    launches as the eager calls; eager and artifact ms (CUDA events). Then
    `ns_dpcrn_v0_causal` through the NS CLI's export_model (its FullModel
    the same way; DSS's export runs in 7c); the op's dispatch cost
    (`dispatch_cost`); tSNE's d-vectors (`tsne_dvecs`) on EXPORT_TSNE
    mixtures on the card and on the CPU (each within cosine
    EXPORT_DVEC_COS) and `--action tSNE` through the CLI on the card (where
    scikit-learn or matplotlib is missing it must raise ModuleNotFoundError
    after embedding the set); and `probe_lookahead_receptive` of the
    flagship, card against CPU."""
    import copy
    import importlib.util
    import io
    import random
    import tempfile

    from puresound_tpu_torch.egs.ns import main as ns_cli
    from puresound_tpu_torch.egs.tse import main as tse_cli
    from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
    from puresound_tpu_torch.streaming.engine import StreamingTSE
    from puresound_tpu_torch.utils import export as ex
    from puresound_tpu_torch.utils.model_info import probe_lookahead_receptive
    from puresound_tpu_torch.zoo.ns import init_model as init_ns
    from puresound_tpu_torch.zoo.tse import init_model

    t0 = time.perf_counter()
    out, start = {}, counts(lk, tk)
    g = torch.Generator().manual_seed(SEED + 170)
    with tempfile.TemporaryDirectory() as tmp:
        # ------------------------------------------------ the flagship's export
        t = time.perf_counter()
        model = init_model("tse_skim_v0_causal", device=dev,
                           generator=torch.Generator().manual_seed(SEED)).eval()
        tse_dir = os.path.join(tmp, "tse")
        os.makedirs(tse_dir)
        write_port_ckpt(model, os.path.join(tse_dir, "epoch_0.ckpt"))
        n_utt, n_spk = EXPORT_TSNE
        dev_set = write_tse_manifest(os.path.join(tmp, "dev"), n_utt, SEED + 172, n_spk=n_spk)
        hp = load_hparam(SHIPPED_1C)
        hp["DATASET"].update(train=dev_set, dev=dev_set, eval=dev_set)
        hp["TRAIN"].update(model_save_dir=tse_dir, log_dir=os.path.join(tmp, "logs"),
                           model_average=1)
        cfg = os.path.join(tmp, "tse.yaml")
        dump_hparam(hp, cfg)
        res = export_cli(tse_cli, cfg, lk, tk, backend)
        want = {"EncoderNet", "decoderNet", "SpeakerNet", "MaskNet", "FullModel", "StreamStep"}
        if set(res["paths"]) != want:
            raise AssertionError(f"7f export_model wrote {sorted(res['paths'])}")
        programs = {n: torch.export.load(p) for n, p in res["paths"].items()}
        ops = {n: ex.op_nodes(p) for n, p in programs.items()}
        want_ops = {"EncoderNet": {}, "decoderNet": {}, "SpeakerNet": {"tcn_block_train": 5},
                    "MaskNet": {"lstm_scan_train_fp": 10},
                    "FullModel": {"tcn_block_train": 5, "lstm_scan_train_fp": 10}}
        if ({n: ops[n] for n in want_ops} != want_ops
                or set(ops["StreamStep"]) != {"lstm_scan_train_fp"}):
            raise AssertionError(f"7f: the ops in the exported graphs {ops}")
        log("7f export", f"tse_skim_v0_causal (f32, seed {SEED}) through python -m "
            f"puresound_tpu_torch.egs.tse.main {SHIPPED_1C} --action export_model: "
            f"{res['wall_s']:.2f} s; export / save s by artifact " + ", ".join(
                f"{n} {e:.2f} / {s:.2f} ({os.path.getsize(res['paths'][n]) / 1e6:.1f} MB)"
                for n, (e, s) in res["seconds"].items())
            + f"; its eager dummy calls' launches {res['launches']}; puresound_tpu_torch:: ops "
            f"by graph {ops} [{card}]", t)
        out["export_s"] = res["seconds"]

        # ------------------------------- each artifact against the eager module
        t = time.perf_counter()
        mods = {n: p.module() for n, p in programs.items()}
        wav = (0.1 * torch.randn(1, 80000, generator=g)).to(dev)
        enroll = (0.1 * torch.randn(1, 80000, generator=g)).to(dev)
        checks, timing = {}, {}
        with torch.no_grad():
            feats = model._encode(wav)
            dvec = model.inference_tse_embedding(enroll)
            calls = {"FullModel": (lambda: model.inference(wav, enroll), (wav, enroll)),
                     "SpeakerNet": (lambda: model.inference_tse_embedding(enroll), (enroll,)),
                     "MaskNet": (lambda: model.masker(feats, dvec.squeeze(-1)),
                                 (feats, dvec.squeeze(-1))),
                     "EncoderNet": (lambda: model._encode(wav), (wav,)),
                     "decoderNet": (lambda: model._decode(feats), (feats,))}
            for name, (eager_fn, args) in calls.items():
                checks[name] = held_to_eager(name, eager_fn, lambda: mods[name](*args), lk, tk)
                if name in ("FullModel", "SpeakerNet"):
                    timing[name] = (cuda_ms(eager_fn, reps=5, warmup=1),
                                    cuda_ms(lambda: mods[name](*args), reps=5, warmup=1))
            # StreamStep over carried chunks, across a segment boundary
            engine = StreamingTSE.from_offline(model)
            dv = engine.embed(enroll[:, :16000])
            chunks = (0.1 * torch.randn(EXPORT_CHUNKS, 1, 64, generator=g)).to(dev)
            st, st_x = engine.init_state(1), ex.stream_state(engine)
            step = mods["StreamStep"]
            ys, ys_x = [], []

            def eager_run():
                s = st
                for c in chunks:
                    y, s = engine.step(c, dv, s)
                    ys.append(y)
                return torch.cat(ys, -1), s

            def artifact_run():
                s = st_x
                for c in chunks:
                    y, s = step(c, dv, s)
                    ys_x.append(y)
                return torch.cat(ys_x, -1), s

            checks["StreamStep"] = held_to_eager(
                f"StreamStep over {EXPORT_CHUNKS} chunks", eager_run, artifact_run, lk, tk)
            frames = int(ex.stream_state(engine)["skim"]["frame_count"]) + 4 * EXPORT_CHUNKS
            if frames <= model.masker.seg_size or checks["StreamStep"]["launches"][0] != (
                    16 * EXPORT_CHUNKS + 6 * (frames // model.masker.seg_size)):
                raise AssertionError(f"7f StreamStep: {frames} frames, launches "
                                     f"{checks['StreamStep']['launches']}")
            timing["StreamStep"] = (cuda_ms(lambda: engine.step(chunks[0], dv, st), reps=10),
                                    cuda_ms(lambda: step(chunks[0], dv, st_x), reps=10))
        log("7f export", "loaded artifacts against the eager module on seeded card inputs "
            f"(bar {EXPORT_BAR:g} of max|ref|): " + "; ".join(
                f"{n} {c['rel_err']:.2e} ({'bit-equal' if c['bit_equal'] else 'not bit-equal'}"
                f", launches {c['launches']} as eager)" for n, c in checks.items())
            + f"; StreamStep over {EXPORT_CHUNKS} chunks of 64 samples crosses the 150-frame "
            "segment boundary (its cond branch); ms eager / artifact (CUDA events): "
            + ", ".join(f"{n} {a:.3f} / {b:.3f}" for n, (a, b) in timing.items())
            + f" [{card}]", t)
        out.update(checks=checks, timing=timing)

        # ------------------------------------------- the NS CLI's export_model
        t = time.perf_counter()
        ns = init_ns("ns_dpcrn_v0_causal", device=dev,
                     generator=torch.Generator().manual_seed(SEED + 173)).eval()
        ns_dir = os.path.join(tmp, "ns")
        os.makedirs(ns_dir)
        write_port_ckpt(ns, os.path.join(ns_dir, "epoch_0.ckpt"))
        hp = load_hparam(SHIPPED_NS[0])
        hp["TRAIN"].update(model_save_dir=ns_dir, log_dir=os.path.join(tmp, "logs"),
                           model_average=1)
        ns_cfg = os.path.join(tmp, "ns.yaml")
        dump_hparam(hp, ns_cfg)
        ns_res = export_cli(ns_cli, ns_cfg, lk, tk, backend)
        if set(ns_res["paths"]) != {"EncoderNet", "MaskNet", "decoderNet", "FullModel",
                                    "StreamStep"}:
            raise AssertionError(f"7f ns export_model wrote {sorted(ns_res['paths'])}")
        full = torch.export.load(ns_res["paths"]["FullModel"])
        with torch.no_grad():
            ns_check = held_to_eager("ns FullModel", lambda: ns.inference(wav),
                                     lambda: full.module()(wav), lk, tk)
        log("7f export", f"ns_dpcrn_v0_causal through python -m puresound_tpu_torch.egs.ns.main "
            f"{SHIPPED_NS[0]} --action export_model: {ns_res['wall_s']:.2f} s; export / save s "
            + ", ".join(f"{n} {e:.2f} / {s:.2f}" for n, (e, s) in ns_res["seconds"].items())
            + f"; FullModel ops {ex.op_nodes(full)}, against eager {ns_check['rel_err']:.2e} "
            f"({'bit-equal' if ns_check['bit_equal'] else UNEQUAL}), launches "
            f"{ns_check['launches']} as eager [{card}]", t)
        out["ns"] = {"seconds": ns_res["seconds"], "check": ns_check}

        # ------------------------------------------------ the op's dispatch cost
        t = time.perf_counter()
        out["dispatch"] = d = dispatch_cost(lk, model, dev)
        log("7f dispatch", f"lstm_scan_train_fp through its torch.library op against the op's "
            f"body called directly, {DISPATCH_TURNS} turns op, direct, direct, op: one-row "
            f"one-step scans (B=1, C=128, H=256), {DISPATCH_CALLS} calls a turn, host us a "
            f"call (no sync) op p50 {d['op_call_us']:.1f} / direct {d['direct_call_us']:.1f}: "
            f"{d['per_op_us']:.1f} us an op (by turn {d['calls_by_turn']}); the flagship's "
            f"unfused StreamingTSE.step at B=1, 16 ms chunks (64 scans a step), "
            f"{DISPATCH_STEPS} synced steps a turn: op p50 {d['op_ms']:.3f} ms (min "
            f"{d['op_min_ms']:.3f}), direct p50 {d['direct_ms']:.3f} ms (min "
            f"{d['direct_min_ms']:.3f}) [{card}]", t)

        # ---------------------------------------------------------------- tSNE
        # its model half (`tsne_dvecs`, what `--action tSNE` runs first) on the
        # card and on the CPU; then the action through the CLI on the card,
        # which imports scikit-learn and matplotlib after the d-vectors, as
        # JAX's does: where this machine lacks them it raises there
        # (the dev loader draws its enrollments' levels from a seed it takes
        # from Python's RNG: seeded alike, the three runs embed one set)
        t = time.perf_counter()
        hp_tse = load_hparam(cfg)
        before = counts(lk, tk)
        random.seed(SEED + 174)
        a, spk, _ = tse_cli.tsne_dvecs(hp_tse, dev, "epoch_0.ckpt")
        torch.cuda.synchronize()
        dvec_launches = since(before, lk, tk)
        random.seed(SEED + 174)
        b, _, _ = tse_cli.tsne_dvecs(hp_tse, torch.device("cpu"), "epoch_0.ckpt")
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        if not (a.shape == b.shape == (n_utt, 192) and cos.min() >= EXPORT_DVEC_COS):
            raise AssertionError(f"7f tSNE: d-vectors {a.shape}, cosine card vs CPU {cos}")
        expect_launches(dvec_launches, (0, 0, 5 * n_utt, 0), "7f tSNE d-vectors on the card "
                        "(LSTM fwd, bwd, TCN fwd, bwd)")
        missing = [m for m in ("sklearn", "matplotlib") if importlib.util.find_spec(m) is None]
        argv = [cfg, "--action", "tSNE", "--ckpt", "epoch_0.ckpt", "--backend", backend]
        before = counts(lk, tk)
        random.seed(SEED + 174)
        if missing:
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    tse_cli.main(tse_cli.parse_args(argv))
                raise AssertionError(f"7f tSNE ran without {missing}")
            except ModuleNotFoundError as e:
                if e.name not in missing:
                    raise
                action = (f"scikit-learn / matplotlib are not installed on this machine "
                          f"({missing}): --action tSNE embedded the set on the card, then "
                          f"raised {e!r} where JAX's action imports them (its silhouette, "
                          "t-SNE, PNG and HTML are held on the CPU by "
                          "tests/test_torch_periphery.py)")
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                res_tsne = tse_cli.main(tse_cli.parse_args(argv))
            for ext in ("png", "html"):
                if os.path.getsize(os.path.join(tse_dir, f"Speaker_dev_tSNE.{ext}")) < 1000:
                    raise AssertionError(f"7f tSNE: Speaker_dev_tSNE.{ext}")
            if not np.array_equal(res_tsne["dvecs"], a):
                raise AssertionError("7f tSNE: the action's d-vectors are not tsne_dvecs'")
            action = (f"--action tSNE on the card: silhouette {res_tsne['silhouette']:.6f}, "
                      "Speaker_dev_tSNE.png / .html written")
        torch.cuda.synchronize()
        expect_launches(since(before, lk, tk), dvec_launches, "7f --action tSNE on the card")
        log("7f tSNE", f"{n_utt} mixtures of {n_spk} speakers ({sorted(set(spk))}): d-vectors "
            f"[{n_utt}, 192] through inference_tse_embedding, cosine card vs CPU min "
            f"{cos.min():.7f} (bar {EXPORT_DVEC_COS}), launches {dvec_launches}; {action} "
            f"[{card}]", t)
        out["tsne_cos"] = float(cos.min())

        # --------------------------------------------------------------- probe
        t = time.perf_counter()
        cpu_model = copy.deepcopy(model).cpu()
        e16 = enroll[:, :16000]
        before = counts(lk, tk)
        card_probe = probe_lookahead_receptive(lambda x: model.inference(x, e16),
                                               length=EXPORT_PROBE, device=dev)
        torch.cuda.synchronize()
        probe_launches = since(before, lk, tk)
        cpu_probe = probe_lookahead_receptive(lambda x: cpu_model.inference(x, e16.cpu()),
                                              length=EXPORT_PROBE, device="cpu")
        if card_probe != cpu_probe or card_probe[0] != 16:
            raise AssertionError(f"7f probe: (lookahead, receptive) card {card_probe}, CPU "
                                 f"{cpu_probe}")
        expect_launches(probe_launches, (20, 0, 10, 0), "7f probe on the card")
        log("7f probe", f"probe_lookahead_receptive(tse_skim_v0_causal, {EXPORT_PROBE} samples, "
            f"inf from sample {EXPORT_PROBE // 2}): card {card_probe} == CPU {cpu_probe} (the "
            f"kernels' __expf gates give the plain path's NaN pattern); launches "
            f"{probe_launches} [{card}]", t)
        out["probe"] = card_probe
    out["launches"] = since(start, lk, tk)
    log("7f export and periphery", f"phase 7f in all, launches (LSTM fwd, bwd, TCN fwd, bwd) "
        f"{out['launches']}", t0)
    return out


# ------------------------------------------------------------------ phase 8
SEQPAR_SECONDS, SEQPAR_ENROLL = 60.0, 1.0   # 8a: one recording at B=1
SEQPAR_HALOS = (0.5, 1.0, 2.0)              # the flagship's left halos, seconds
SEQPAR_BAR = 1e-4                           # finite receptive field: max|d| / max|ref|
SEQPAR_EDGE = 16000                         # the recording's last second left out
MESH_SLOTS, MESH_TICKS, MESH_WARM = 16, 20, 3
MESH_BAR = 1e-4                             # mesh vs one device where not bit-equal
TP_B, TP_SECONDS = 16, 2.0
ATTN_ROWS, ATTN_T, ATTN_C, ATTN_HEADS = 4096, 64, 128, 8
# the demos step the flagship's unfused step, host-bound (a final run's
# 8e took 33 + 27 s at 4 s / 3 s on one host, 41 + 71 s on another)
DEMO_SECONDS, LIVE_MICS, LIVE_SECONDS = 1.0, 4, 1.0
PROF_SLOTS, PROF_STEPS = 1024, 3
PROF_KERNEL = "skim_tc_kernel"              # fused_skim_frames' bf16 kernel in a trace


def _wall(fn):
    """(fn(), seconds) with the card synchronised on both ends."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def seqpar_phase(lk, tk, dev, card) -> dict:
    """Phase 8a: `seq_parallel_infer` of one SEQPAR_SECONDS recording at
    B=1 over meshes of [dev] * 2 and [dev] * 4. The flagship
    (tse_skim_v0_causal, seed SEED, chunks aligned to its 2,400-sample
    segment grid, a right halo of a segment and a window): each chunk's
    interior equals `inference` on that halo-extended chunk bit for bit, and
    the SNR against the unsharded run (from the first chunk boundary to the
    recording's last second) at left halos SEQPAR_HALOS, the burn-in curve.
    td_tse_conv_tasnet_v0_causal (finite receptive field) with the halo its
    `probe_lookahead_receptive` measures: within SEQPAR_BAR of max|ref| past
    a receptive field and a lookahead from either end of the recording.
    Launches and wall seconds of sharded against unsharded (one card: no
    speed-up expected)."""
    from puresound_tpu_torch.parallel import make_mesh, overlapped_chunks, seq_parallel_infer
    from puresound_tpu_torch.utils.model_info import probe_lookahead_receptive
    from puresound_tpu_torch.zoo.tse import init_model

    rng = np.random.default_rng(SEED + 220)
    r = lambda n: torch.from_numpy((0.1 * rng.standard_normal((1, n))).astype(np.float32))
    x, enroll = r(int(16000 * SEQPAR_SECONDS)).to(dev), r(int(16000 * SEQPAR_ENROLL)).to(dev)
    meshes = {n: make_mesh(n_dp=n, devices=[dev] * n) for n in (2, 4)}
    out, launches = {}, [0, 0, 0, 0]
    for name in ("tse_skim_v0_causal", "td_tse_conv_tasnet_v0_causal"):
        t = time.perf_counter()
        model = init_model(name, device=dev, generator=torch.Generator().manual_seed(SEED))

        def fn(c):
            with torch.no_grad():
                return model.inference(c, enroll)

        hop = model.encoder.hop_length
        if name == "tse_skim_v0_causal":
            align = hop * model.masker.seg_size
            halo_r = align + 2 * hop
            halos = [int(16000 * h) for h in SEQPAR_HALOS]
            look = recep = None
        else:
            look, recep = probe_lookahead_receptive(fn, length=160000, device=dev)
            if look is None or recep is None:
                raise AssertionError(f"8a {name}: lookahead {look}, receptive field {recep}")
            align, halo_r, halos = hop, look, [recep]
        fn(x[:, :32000])
        zero_counts(lk, tk)
        ref, wall_ref = _wall(lambda: fn(x))
        ref_launches = counts(lk, tk)
        res = {"unsharded_s": wall_ref, "launches_unsharded": ref_launches,
               "halos": halos, "align": align, "halo_right": halo_r,
               "lookahead": look, "receptive": recep}
        peak = ref.abs().max().item()
        for n, mesh in meshes.items():
            for h in halos:
                zero_counts(lk, tk)
                y, wall = _wall(lambda: seq_parallel_infer(fn, x, mesh, h, halo_r, align))
                c = counts(lk, tk)
                expect_launches(c, tuple(n * v for v in ref_launches),
                                f"8a {name} over {n}: LSTM and TCN (fwd, bwd)")
                launches = [a + b for a, b in zip(launches, c)]
                chunks, Lc, T = overlapped_chunks(x, n, h, halo_r, align)
                hl = chunks.shape[-1] - Lc - halo_r
                for i in range(n):
                    piece = fn(chunks[i])[..., hl:hl + Lc][..., :max(0, T - i * Lc)]
                    if not torch.equal(piece, y[..., i * Lc:i * Lc + piece.shape[-1]]):
                        raise AssertionError(f"8a {name} over {n}, halo {h}: chunk {i}'s "
                                             "interior is not its own inference")
                # the flagship from the first chunk boundary on (chunk 0's start
                # burns in on the zero halo the whole-signal run never sees,
                # whatever the halo); the finite receptive field past its reach
                # of the recording's edges
                lo, hi = ((Lc, T - SEQPAR_EDGE) if recep is None
                          else (recep + look + 16, T - recep - look - 16))
                a, b = ref[:, lo:hi], y[:, lo:hi]
                err = (a - b).abs().max().item() / max(peak, 1e-30)
                res[(n, h)] = {"snr_db": snr_db(b, a), "rel_err": err, "wall_s": wall,
                               "launches": c}
                if recep is not None and not err <= SEQPAR_BAR:
                    raise AssertionError(f"8a {name} over {n}: max|d| / max|ref| {err:.3e} > "
                                         f"{SEQPAR_BAR:g} at halo {h} (its receptive field)")
        if recep is None and not res[(2, halos[-1])]["snr_db"] >= 25.0:
            raise AssertionError(f"8a {name}: {res[(2, halos[-1])]['snr_db']:.1f} dB at the "
                                 f"{SEQPAR_HALOS[-1]:g} s halo (bar 25)")
        out[name] = res
        log("8a seqpar", f"{name}, {SEQPAR_SECONDS:g} s at B=1 over make_mesh(devices=[{dev}] * "
            f"n), align {align}, right halo {halo_r}" + (
                f", probed lookahead {look} / receptive field {recep}" if recep else "")
            + f": every chunk's interior == its own inference bit for bit; unsharded "
            f"{wall_ref:.3f} s, launches {ref_launches}; " + "; ".join(
                f"n={n} halo {h}: SNR {res[(n, h)]['snr_db']:.1f} dB, max|d|/max|ref| "
                f"{res[(n, h)]['rel_err']:.2e}, {res[(n, h)]['wall_s']:.3f} s"
                for n in meshes for h in halos) + f" [{card}]", t)
        del model
    return {"launches": tuple(launches), "models": out}


def _mesh_server_run(make, kind, dev, chunk_rng_seed):
    """Attach MESH_SLOTS sessions (TSE by 1 s enrollments from a seed), then
    MESH_WARM + MESH_TICKS ticks of every slot: (outputs [slots, L], tick
    ms of the timed ticks, launches of the timed ticks, of the attaches)."""
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import tcn_train_kernel as tk

    bundle = make()
    server, chunk = bundle.server, bundle.chunk_samples
    rng = np.random.default_rng(chunk_rng_seed)
    zero_counts(lk, tk)
    if kind == "tse":
        sids = [server.attach(enroll=(0.1 * rng.standard_normal(16000)).astype(np.float32))
                for _ in range(MESH_SLOTS)]
    else:
        sids = [server.attach() for _ in range(MESH_SLOTS)]
    attach_launches = counts(lk, tk)
    n = MESH_WARM + MESH_TICKS
    audio = (0.1 * rng.standard_normal((MESH_SLOTS, n * chunk))).astype(np.float32)
    outs, ticks = [[] for _ in sids], []
    for k in range(n):
        if k == MESH_WARM:
            torch.cuda.synchronize()
            zero_counts(lk, tk)
        for i, sid in enumerate(sids):
            server.hub.push_input(sid, audio[i, k * chunk:(k + 1) * chunk])
        t = time.perf_counter()
        server.tick()
        if k >= MESH_WARM:
            ticks.append(1e3 * (time.perf_counter() - t))
        for i, sid in enumerate(sids):
            avail = server.hub.output_available(sid)
            if avail:
                outs[i].append(server.hub.pop_output(sid, avail))
    torch.cuda.synchronize()
    tick_launches = counts(lk, tk)
    server.flush()
    for i, sid in enumerate(sids):
        avail = server.hub.output_available(sid)
        if avail:
            outs[i].append(server.hub.pop_output(sid, avail))
    return (np.stack([np.concatenate(o) for o in outs]), ticks, tick_launches,
            attach_launches)


def mesh_serving_phase(lk, tk, dev, card) -> dict:
    """Phase 8b: `make_session_server(mesh=make_mesh(n_dp=2, devices=[dev] *
    2))` against the one-device server on the same weights and audio,
    MESH_SLOTS slots, MESH_WARM + MESH_TICKS ticks: the flagship's stock
    step in f32 (15 ms ticks, attached by 1 s enrollments) and
    ns_dpcrn_v0_causal's under `cudnn.deterministic` (16 ms). Every slot's
    output bit-equal or within MESH_BAR of max|ref| (said which); each
    replica launches the one-device step's scans over half the rows, so a
    mesh tick launches twice as many; the TSE mesh pipelined == unpipelined;
    mesh + fused=True raises."""
    from puresound_tpu_torch.parallel import make_mesh
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.zoo import ns as zns
    from puresound_tpu_torch.zoo import tse as ztse

    mesh = make_mesh(n_dp=2, devices=[dev, dev])
    res, launches = {}, [0, 0, 0, 0]
    for name, kind in (("tse_skim_v0_causal", "tse"), ("ns_dpcrn_v0_causal", "ns")):
        t = time.perf_counter()
        zoo = ztse if kind == "tse" else zns
        model = zoo.init_model(name, device=dev, generator=torch.Generator().manual_seed(SEED))
        kw = (dict(chunk_ms=15.0, enroll_len=16000, fused=False) if kind == "tse"
              else dict(chunk_ms=16.0))
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = kind == "ns"
        try:
            runs = {}
            for label, m, extra in (("one", None, {}), ("mesh", mesh, {}),
                                    ("mesh pipelined", mesh, dict(pipelined=True))):
                # every session attaches before the first tick: the SkiM
                # segment clock's mid-serving warning does not apply
                warnings.filterwarnings("ignore", message="chunk of 15 frames")
                runs[label] = _mesh_server_run(
                    lambda: make_session_server(model, None, MESH_SLOTS, mesh=m, lockstep=True,
                                                **kw, **extra), kind, dev, SEED + 221)
        finally:
            torch.backends.cudnn.deterministic = prev
        (want, t1, c1, a1), (got, tm, cm, am), (piped, _, cp, _) = (
            runs["one"], runs["mesh"], runs["mesh pipelined"])
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"8b {name}: mesh output {got.shape}, one device {want.shape}")
        equal = np.array_equal(got, want)
        err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
        if not err <= MESH_BAR:
            raise AssertionError(f"8b {name}: mesh vs one device max|d|/max|ref| {err:.3e}")
        if not np.array_equal(piped, got):
            raise AssertionError(f"8b {name}: pipelined mesh server != unpipelined")
        expect_launches(cm, tuple(2 * v for v in c1),
                        f"8b {name}: a mesh tick's launches against twice the one device's")
        expect_launches(am, a1, f"8b {name}: the attaches' launches (the first replica embeds)")
        if not c1[0]:
            raise AssertionError(f"8b {name}: the stock step launched no LSTM kernel")
        launches = [a + b + c + d + e for a, b, c, d, e in zip(launches, cm, am, cp, a1)]
        p = lambda v, q: float(np.percentile(v, q))
        res[name] = {"bit_equal": equal, "rel_err": err, "one_p50": p(t1, 50),
                     "one_p99": p(t1, 99), "mesh_p50": p(tm, 50), "mesh_p99": p(tm, 99),
                     "launches_tick": tuple(v / MESH_TICKS for v in cm),
                     "one_launches_tick": tuple(v / MESH_TICKS for v in c1)}
        log("8b mesh serving", f"{name} stock step f32, {MESH_SLOTS} slots over dp=2 on "
            f"[{dev}] * 2 against one device, {MESH_TICKS} ticks after {MESH_WARM}"
            + (", cudnn.deterministic" if kind == "ns" else ", attached by 1 s enrollments")
            + f": every slot {'bit-equal' if equal else f'within {err:.2e} of max|ref| (not bit-equal)'}; "
            f"pipelined == unpipelined; tick p50 / p99 one device {p(t1, 50):.3f} / "
            f"{p(t1, 99):.3f} ms, mesh {p(tm, 50):.3f} / {p(tm, 99):.3f} ms; LSTM / TCN "
            f"launches a tick {res[name]['one_launches_tick']} -> "
            f"{res[name]['launches_tick']}, attaches {a1} [{card}]", t)
    model = ztse.init_model("tse_skim_v0_causal", device=dev)
    try:
        make_session_server(model, None, 4, mesh=mesh, fused=True)
    except ValueError as e:
        log("8b mesh serving", f"mesh + fused=True raises JAX's ValueError: {e}",
            time.perf_counter())
    else:
        raise AssertionError("8b: mesh + fused=True served")
    return {"launches": tuple(launches), "models": res}


def tp_phase(lk, tk, dev, card) -> dict:
    """Phase 8c: `multihost.initialize` joins a NCCL group of one process;
    `make_train_step(mesh=make_mesh(1, 1), tp=True)` on the flagship
    (B=TP_B x TP_SECONDS s, SI-SNR, clip 10) over 2 steps == the plain step
    bit for bit under `cudnn.deterministic`, the same launches; then one
    `NsTask` epoch of one batch with TRAIN.mp_devices 1 under multi_gpu.
    mp = 2 needs two cards (NCCL takes one process a card)."""
    import socket

    from puresound_tpu_torch.parallel import (make_mesh, make_train_step, multihost,
                                              shard_state_to_mesh)
    from puresound_tpu_torch.tasks.ns import NsTask
    from puresound_tpu_torch.zoo.ns import init_loss
    from puresound_tpu_torch.zoo.ns import init_model as ns_model

    t = time.perf_counter()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"localhost:{port}", 1, 0, dev)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = train_batch(TP_B, TP_SECONDS, dev)
        runs = []
        for tp in (False, True):
            model, state, step = train_parts(dev, torch.Generator().manual_seed(SEED + 230))
            if tp:
                mesh = make_mesh(1, 1)
                if not mesh.over_ranks or mesh.shape != {"dp": 1, "mp": 1}:
                    raise AssertionError(f"8c: {mesh}")
                shard_state_to_mesh(mesh, state, tp=True)
                step = make_train_step(model, grad_clip=10.0, mesh=mesh, tp=True)
            zero_counts(lk, tk)
            losses = []
            for _ in range(2):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            runs.append((losses, [p.detach().clone() for p in model.parameters()],
                         counts(lk, tk)))
        (l0, p0, c0), (l1, p1, c1) = runs
        expect_launches(c1, c0, "8c tp step against the plain step, LSTM and TCN (fwd, bwd)")
        if not c1[0] or l0 != l1 or not all(map(torch.equal, p0, p1)):
            raise AssertionError(f"8c tp: losses {l0} vs {l1}, launches {c1}, or parameters "
                                 "differ")
        hp = {"DATASET": {"sample_rate": 16000},
              "OPTIMIZER": {"lr": 1e-3, "lr_scheduler": "Plateau", "gradiend_clip": 10.0,
                            "weight_decay": 1e-5},
              "TRAIN": {"multi_gpu": True, "mp_devices": 1, "seed": SEED}}
        nb = ns_batch(4, 1.0, dev)
        loader = [{"process_wav": nb["noisy"].cpu().numpy(),
                   "clean_wav": nb["ref_clean"].cpu().numpy()}]
        task = NsTask(hp, ns_model("ns_dpcrn_v0_causal",
                                   init_loss({"LOSS": {"sig_loss": "stft_ov"}}), device=dev,
                                   generator=torch.Generator().manual_seed(SEED)),
                      dev, loader, [])
        zero_counts(lk, tk)
        loss = task.train_one_epoch(0)["total_loss"]
        torch.cuda.synchronize()
        c2 = counts(lk, tk)
        n = NS_TRAIN_LAUNCHES["ns_dpcrn_v0_causal"]
        expect_launches(c2, (n, n, 0, 0), "8c NsTask step (mp_devices 1), LSTM and TCN")
    finally:
        torch.backends.cudnn.deterministic = prev
        multihost.shutdown()
    log("8c tensor parallel", f"NCCL group of 1 on {dev}; flagship B={TP_B} x {TP_SECONDS:g} s, "
        f"2 steps through make_train_step(mesh=make_mesh(1, 1), tp=True) == the plain step "
        f"bit for bit (losses {l1}), launches {c1} both; NsTask (mp_devices 1, multi_gpu) "
        f"one step of ns_dpcrn_v0_causal B=4 x 1 s, loss {loss:.4f}, launches {c2} [{card}]", t)
    log("8c tensor parallel", f"mp = 2 not run: this machine has {torch.cuda.device_count()} "
        "card(s) and NCCL takes one process a card; (dp, mp) = (1, 2) and (2, 2) are held "
        "against one process on the CPU (gloo) by tests/test_torch_tp.py", time.perf_counter())
    return {"launches": tuple(a + b + c for a, b, c in zip(c0, c1, c2))}


@contextlib.contextmanager
def plain_f64(lk):
    """Inside, a float64 scan on the card takes `lstm_scan_train_fp`'s
    plain version (the kernels run f32 and bf16); launches nothing."""
    on_card = lk._on_card
    lk._on_card = lambda x: on_card(x) and x.dtype != torch.float64
    try:
        yield
    finally:
        lk._on_card = on_card


def _improved_f64(lk, ref, x, w, mask=None) -> dict:
    """y, dx and the parameter gradients of sum(ref(x) * w) in float64 on
    the card; with `mask`, the LSTM's ReLU takes those decisions (the card
    run's) instead of its own."""
    if mask is not None:
        def ff(a):
            y, _ = ref.recurrent(a)
            return ref.ff_drop2(ref.ff2(ref.ff_drop1(y * mask)))
        ref._feedforward = ff
    for p in ref.parameters():
        p.grad = None
    xr = x.clone().requires_grad_()
    try:
        with plain_f64(lk):
            yr = ref(xr)
            (yr * w).sum().backward()
    finally:
        ref.__dict__.pop("_feedforward", None)
    return {"y": yr.detach(), "dx": xr.grad,
            **{n: p.grad.clone() for n, p in ref.named_parameters()}}


def improved_attention_phase(lk, tk, dev, card) -> dict:
    """Phase 8d: `MhaSelfAttenLayer(improved=True)` at DPARN's intra widths
    (C=128, hidden 128, 8 heads; ATTN_ROWS rows x ATTN_T tokens), uni- and
    bidirectional, f32 and bf16: forward and backward of sum(y * w) on the
    card against the same layer in float64 (on the card, its LSTM through
    the plain version: on the CPU the reference takes 12-13 s a direction,
    `scripts/periphery_diverge.py`) that
    takes the card run's ReLU decisions after the LSTM (output, input and
    parameter gradients: f32 within 1e-4 of max|ref|, bf16 >= 30 dB); the
    readings against the float64 layer's own decisions beside them (an
    LSTM output near 0 that f32 puts on the other side of the ReLU moves
    the LSTM's gradients by up to ~5e-3 of max|ref|, bf16's by ~25 dB); one
    `lstm_scan_train_fp` forward and one backward launch a direction."""
    import copy

    from puresound_tpu_torch.nnet.lobe.attention import MhaSelfAttenLayer

    rng = np.random.default_rng(SEED + 240)
    shape = (ATTN_ROWS, ATTN_C, ATTN_T)
    x64 = torch.from_numpy(rng.standard_normal(shape)).to(dev)
    w64 = torch.from_numpy(rng.standard_normal(shape)).to(dev)
    res, launches = {}, [0, 0, 0, 0]
    for bi in (False, True):
        t = time.perf_counter()
        ref = MhaSelfAttenLayer(ATTN_C, ATTN_C, ATTN_HEADS, improved=True, bidirectional=bi,
                                dtype=torch.float64,
                                generator=torch.Generator().manual_seed(SEED)).eval().to(dev)
        zero_counts(lk, tk)
        own = _improved_f64(lk, ref, x64, w64)
        expect_launches(counts(lk, tk), (0, 0, 0, 0), "8d the float64 reference (plain)")
        d = 2 if bi else 1
        for dt in (torch.float32, torch.bfloat16):
            layer = copy.deepcopy(ref).to(dt)
            for p in layer.parameters():
                p.grad = None
            x = x64.to(dt).requires_grad_()
            layer(x[:2].detach())      # warm-up on two rows
            signs = []
            hook = layer.recurrent.register_forward_hook(
                lambda m, i, o: signs.append((o[0] > 0).to(torch.float64)))
            zero_counts(lk, tk)
            y = layer(x)
            (y * w64.to(dt)).sum().backward()
            torch.cuda.synchronize()
            c = counts(lk, tk)
            hook.remove()
            expect_launches(c, (d, d, 0, 0), f"8d improved layer bi={bi} {dt}: LSTM (fwd, bwd)")
            launches = [a + b for a, b in zip(launches, c)]
            got = {"y": y.detach(), "dx": x.grad,
                   **{n: p.grad for n, p in layer.named_parameters()}}
            want = _improved_f64(lk, ref, x64, w64, signs[0])
            f32 = dt == torch.float32
            read = ((lambda g, v: (g.double() - v).abs().max().item()
                     / max(v.abs().max().item(), 1e-30)) if f32
                    else (lambda g, v: snr_db(g, v)))
            readings = {k: read(got[k], v) for k, v in want.items()}
            bad = {k: r for k, r in readings.items() if not (r <= 1e-4 if f32 else r >= 30.0)}
            if bad:
                raise AssertionError(f"8d improved layer bi={bi} {dt}: {bad} (all {readings})")
            own_read = {k: read(got[k], v) for k, v in own.items()}
            pick = max if f32 else min
            res[(bi, "f32" if f32 else "bf16")] = {
                "worst": pick(readings.values()), "y": readings["y"],
                "own_worst": pick(own_read.values()), "launches": c}
        r32, r16 = res[(bi, "f32")], res[(bi, "bf16")]
        log("8d improved attention", f"MhaSelfAttenLayer(improved=True, bidirectional={bi}), "
            f"{ATTN_ROWS} rows x {ATTN_T} tokens, C=hidden={ATTN_C}, {ATTN_HEADS} heads: y, dx "
            f"and {len(own) - 2} parameter gradients against float64 (on the card, plain LSTM) "
            f"with the card's ReLU decisions: f32 worst max|d|/max|ref| {r32['worst']:.2e} (y "
            f"{r32['y']:.2e}), bf16 worst {r16['worst']:.1f} dB (y {r16['y']:.1f}); with its "
            f"own decisions f32 {r32['own_worst']:.2e}, bf16 {r16['own_worst']:.1f} dB; "
            f"launches {r32['launches']} a forward + backward [{card}]", t)
    return {"launches": tuple(launches), "readings": res}


def _write_wav(path: str, sig: np.ndarray) -> str:
    from scipy.io import wavfile

    wavfile.write(path, 16000, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
    return path


def demo_phase(lk, tk, dev, card) -> dict:
    """Phase 8e: `demo_app` on a DEMO_SECONDS mixture from a seed (the
    flagship, random weights from SEED, 20 ms chunks, real-time cadence
    off): its enhanced output equals StreamingTSE stepped over the same
    chunks bit for bit; per-chunk latency p50 / p99 and RTF. `live_demo`:
    LIVE_MICS simulated mics at real-time cadence for LIVE_SECONDS through
    the ring hub and `StreamingServer` (lockstep) on the card: each sink
    equals the engine on the same [LIVE_MICS, chunk] batches bit for bit;
    per-stream latency p50 / p99, pieces later than a chunk. Then
    `mic_demo.check_environment()`'s report."""
    from puresound_tpu_torch.egs.tse.demo import demo_app, live_demo, mic_demo

    tmp = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    try:
        t = time.perf_counter()
        rng = np.random.default_rng(SEED + 250)
        enroll = _write_wav(os.path.join(tmp, "enroll.wav"), 0.1 * rng.standard_normal(16000))
        noisy = _write_wav(os.path.join(tmp, "noisy.wav"),
                           0.1 * rng.standard_normal(int(16000 * DEMO_SECONDS)))
        zero_counts(lk, tk)
        res = demo_app.main(demo_app.parse_args(
            ["--enroll", enroll, "--input", noisy, "--output", os.path.join(tmp, "out.wav"),
             "--device", str(dev), "--seed", str(SEED), "--no-realtime"]))
        torch.cuda.synchronize()
        c_app = counts(lk, tk)
        engine = demo_app.load_or_init(demo_app.build_flagship_engine, None, dev, SEED)
        chunk = res["chunk"]
        x = torch.from_numpy(demo_app.read_mono(noisy)[0]).to(dev)
        with torch.no_grad():
            dvec = torch.from_numpy(res["dvec"]).to(dev)
            st, outs = engine.init_state(1), []
            for i in range(x.shape[0] // chunk):
                y, st = engine.step(x[None, i * chunk:(i + 1) * chunk], dvec, st)
                outs.append(y[0])
        want = torch.cat(outs).cpu().numpy()
        if not np.array_equal(res["enhanced"], want):
            raise AssertionError("8e demo_app: its output != StreamingTSE over the same chunks")
        lat = res["latency_ms"][1:]
        app = {"p50": float(np.percentile(lat, 50)), "p99": float(np.percentile(lat, 99)),
               "rtf": res["rtf"], "launches": c_app}
        log("8e demos", f"demo_app --device {dev} --no-realtime, {DEMO_SECONDS:g} s in "
            f"{len(res['latency_ms'])} chunks of {chunk} samples: == StreamingTSE bit for bit; "
            f"per-chunk ms p50 {app['p50']:.3f} / p99 {app['p99']:.3f}, compute / real time "
            f"{app['rtf']:.3f}; launches {c_app} [{card}]", t)
        t = time.perf_counter()
        zero_counts(lk, tk)
        live = live_demo.run(live_demo.parse_args(
            ["--enroll", enroll, "--input", noisy, "--n-mics", str(LIVE_MICS), "--seconds",
             str(LIVE_SECONDS), "--device", str(dev), "--seed", str(SEED),
             "--out-dir", os.path.join(tmp, "live")]))
        torch.cuda.synchronize()
        c_live = counts(lk, tk)
        chunk, wav = live["chunk"], live["wav"]
        n = len(wav) // chunk
        with torch.no_grad():
            st, outs = live["engine"].init_state(LIVE_MICS), []
            for i in range(n):
                xb = torch.from_numpy(np.repeat(wav[None, i * chunk:(i + 1) * chunk],
                                                LIVE_MICS, 0)).to(dev)
                y, st = live["engine"].step(xb, live["dvec"], st)
                outs.append(y)
        want = torch.cat(outs, 1).cpu().numpy()
        for i, audio in enumerate(live["sinks"]):
            if not np.array_equal(audio[:n * chunk], want[i]):
                raise AssertionError(f"8e live_demo: sink {i} != the engine")
        per = live["per_stream"]
        log("8e demos", f"live_demo: {LIVE_MICS} mics at real-time cadence for "
            f"{LIVE_SECONDS:g} s, {live['ticks']} lockstep ticks of {chunk} samples on {dev}: "
            f"every sink == the engine bit for bit; per-stream latency p50 / p99 ms "
            + ", ".join(f"{p['p50_ms']:.1f} / {p['p99_ms']:.1f}" for p in per)
            + f"; pieces later than a chunk {[p['late_pieces'] for p in per]}; all complete "
            f"{live['ok']}; launches {c_live} [{card}]", t)
        ok, missing = mic_demo.check_environment()
        log("8e demos", f"mic_demo.check_environment(): ok {ok}, missing {missing}",
            time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": tuple(a + b for a, b in zip(c_app, c_live)), "app": app,
            "live": per}


def kernel_events(prof, pattern: str) -> int:
    """How many device events of kernels whose name holds `pattern` a
    torch.profiler window recorded."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and pattern in e.key
               and not getattr(e, "is_user_annotation", False))


def profiling_phase(ops, dev, card) -> dict:
    """Phase 8f: `utils.profiling.timed` on the flagship's fused bf16
    serving step (`StreamingTSE.step(fused=True)`, B=PROF_SLOTS, 15 frames);
    `profiler_trace` of PROF_STEPS steps, whose kernels include
    fused_skim_frames' (`skim_tc_kernel`), its device ms; `roofline.summarize`
    of `fused_skim_kernel_cost` at that shape (56.4 GFLOP, 0.057 ms at the
    bf16 peak) against the kernel's device ms."""
    from puresound_tpu_torch.streaming.engine import StreamingTSE
    from puresound_tpu_torch.streaming.halfprec import to_half
    from puresound_tpu_torch.utils import profiling, roofline
    from puresound_tpu_torch.zoo.tse import init_model

    t = time.perf_counter()
    model = init_model("tse_skim_v0_causal", device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    to_half(model)
    engine = StreamingTSE.from_offline(model).eval()
    g = torch.Generator().manual_seed(SEED + 260)
    x = (0.1 * torch.randn(PROF_SLOTS, 240, generator=g)).to(dev, torch.bfloat16)
    dvec = torch.randn(PROF_SLOTS, 192, generator=g).to(dev, torch.bfloat16)
    state = engine.init_state(PROF_SLOTS, torch.bfloat16)

    def step():
        with torch.no_grad():
            return engine.step(x, dvec, state, fused=True, dot_dtype=torch.bfloat16)[0]

    ops.LAUNCHES = 0
    tm = profiling.timed(step, iters=20, warmup=3)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with profiling.profiler_trace(tmp) as prof:
            for _ in range(PROF_STEPS):
                step()
        trace = os.path.join(tmp, "trace.json")
        with open(trace) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = ops.LAUNCHES
    expect_launches(launched, 1 + 2 + 20 + PROF_STEPS, "8f fused_skim_frames")
    if not any(PROF_KERNEL in n for n in names):
        raise AssertionError(f"8f: no {PROF_KERNEL} in the trace's events")
    kernel_ms, total_ms, top = device_share(prof, PROF_KERNEL)
    if kernel_ms is None:
        raise AssertionError("8f: the profiler recorded no device time")
    # a call's device ms from the launches the window recorded (a window
    # after others in one process has kept only its last step's events)
    recorded = kernel_events(prof, PROF_KERNEL)
    if not 1 <= recorded <= PROF_STEPS:
        raise AssertionError(f"8f: {recorded} {PROF_KERNEL} events for {PROF_STEPS} steps")
    kernel_ms /= recorded
    flag = roofline.summarize(1.0, **{k: v for k, v in zip(("flops", "bytes_hbm"), (
        roofline.fused_skim_kernel_cost(1024, 15, 128, 256, 4, ("film",) * 4).values()))})
    if abs(flag["gflops_per_step"] - 56.4) > 0.05 or abs(flag["bound_ms"] - 0.057) > 5e-4:
        raise AssertionError(f"8f: the roofline of the flagship's fused call at 1024 {flag}")
    cost = roofline.fused_skim_kernel_cost(PROF_SLOTS, 15, 128, 256, 4, ("film",) * 4)
    s = roofline.summarize(kernel_ms, cost["flops"], cost["bytes"])
    log("8f profiling", f"timed(fused bf16 step, B={PROF_SLOTS}, 15 frames): {tm}; "
        f"profiler_trace of {PROF_STEPS} steps ({recorded} recorded): {PROF_KERNEL} "
        f"{kernel_ms:.3f} device ms a step of {total_ms / recorded:.3f}; "
        f"summarize(fused_skim_kernel_cost(...)): "
        f"{s['gflops_per_step']} GFLOP, bound {s['bound_ms']:.4f} ms, "
        f"{s['tflops']} TFLOP/s = {s['mfu_pct_bf16peak']} % of the H100's bf16 peak, "
        f"{s['hbm_gbps']} GB/s [{card}]", t)
    return {"launches": launched, "timing": tm, "kernel_ms": kernel_ms, "summary": s}


def periphery_phase(ops, lk, tk, dev, card) -> dict:
    """Phase 8: the multi-device and demo periphery, 8a-8f; returns the
    launches by kernel (the kernels line's `launches_8`)."""
    t = time.perf_counter()
    parts = {"8a": seqpar_phase(lk, tk, dev, card),
             "8b": mesh_serving_phase(lk, tk, dev, card),
             "8c": tp_phase(lk, tk, dev, card),
             "8d": improved_attention_phase(lk, tk, dev, card),
             "8e": demo_phase(lk, tk, dev, card)}
    prof = profiling_phase(ops, dev, card)
    total = [sum(p["launches"][i] for p in parts.values()) for i in range(4)]
    launches = {"lstm_scan_train_fp fwd": total[0], "lstm_scan_train_fp bwd": total[1],
                "tcn_block_train fwd": total[2], "tcn_block_train bwd": total[3],
                "fused_skim_frames": prof["launches"]}
    log("8 periphery", f"launches by kernel {launches}; by sub-phase "
        + "; ".join(f"{k} {v['launches']}" for k, v in parts.items()), t)
    return {"launches": launches, "parts": parts, "profiling": prof}


# ------------------------------------------------------------------ phase 9
CHUNK_STREAMS = 64          # 9a: streams of the flagship
#: 9a: segments of 150 frames a stream (3.45 s at 16 kHz); the f32 streams'
#: segments after the first CHUNK_WARM are B = CHUNK_STREAMS's timing
CHUNK_WARM, CHUNK_TIMED = 3, 20
CHUNK_SEGMENTS = CHUNK_WARM + CHUNK_TIMED
CHUNK_MIXED = ("chunk", "frames")  # 9a: the mixed stream's turns, a segment each
CHUNK_MIXED_SEGMENTS = 6    # 9a: the mixed stream's length, held against step_frames'
CHUNK_BAR = 1e-4            # 9a / 9b f32: max|d| / max|ref|
HALF_BAR_DB = 30.0          # 9a / 9b bf16, dB
FFC_SHAPE = (8, 64, 257, 300)      # 9b: N, CH, F, T
FFC_ALPHA, FFC_KERNEL = 0.3, (3, 3)
FFC_CUT = 150               # 9b: the causal FFC's frames kept when the later ones change
FFC_CPU_BAR = 1e-9          # 9b: the card's f64 against the CPU's f64 (one sample, eval)


def scan_fwd_work(B, T, C, H, dt):
    """(flops, bytes) of one `lstm_scan_train_fp` forward without a gradient:
    x, h0 / c0 and the weights read once, y and hT / cT written once (no
    residuals)."""
    e = torch.finfo(dt).bits // 8
    G = 4 * H
    flops = 2.0 * B * T * (C + H) * G
    nbytes = (B * T * C + (C + H + 1) * G + 4 * B * H + B * T * H) * e
    return flops, nbytes


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


def event_ms(fn):
    """(fn(), the ms between two CUDA events around it, synchronised)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def hold_f32_bf16(label, f32, bf16, want, res, key):
    """f32 within CHUNK_BAR of max|want|, bf16 at least HALF_BAR_DB from it;
    the readings go to res[key]."""
    for name, t in (("f32", f32), ("bf16", bf16)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{label}: non-finite {name} output")
    err, snr = rel_err(f32, want), snr_db(bf16.float(), want)
    res[key] = {"f32_rel": err, "bf16_snr_db": snr}
    if err > CHUNK_BAR or snr < HALF_BAR_DB:
        raise AssertionError(f"{label}: f32 max|d| / max|ref| {err:.3e} (bar {CHUNK_BAR:g}), "
                             f"bf16 {snr:.1f} dB (bar {HALF_BAR_DB:g})")


def step_chunk_kernel_case(lk, dev, card) -> dict:
    """9a's launch shape of `lstm_scan_train_fp` alone: CHUNK_STREAMS rows x
    150 steps, C=128, H=256, no gradient (residuals off, as the op launches
    it), against its plain version on the same inputs (f32 within 1e-4, bf16
    >= 30 dB), two calls bit-equal, CUDA-event ms beside the plain version's,
    the bound and cuDNN's forward at the shape."""
    B, T, C, H = CHUNK_STREAMS, 150, 128, 256
    gen = torch.Generator().manual_seed(SEED + 241)
    k = 1.0 / math.sqrt(H)
    uni = lambda *s: (torch.rand(s, generator=gen) * 2 - 1) * k
    x = 0.5 * torch.randn(B, T, C, generator=gen)
    h0, c0 = 0.3 * torch.randn(B, H, generator=gen), 0.3 * torch.randn(B, H, generator=gen)
    w_ih, bias, w_hh = uni(C, 4 * H), uni(4 * H), uni(H, 4 * H)
    res = {"shape": f"B={B} T={T} C={C} H={H}, no gradient"}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = [a.to(dev, dt) for a in (x, h0, c0, w_ih, bias, w_hh)]
        kern = lambda: lk._launch_fwd(*args, False, residuals=False)
        got, again = kern(), kern()
        plain = lambda: lk.lstm_scan_train_fp_ref(*args, False)
        want = plain()
        torch.cuda.synchronize()
        for a, b in zip(got[:3], again[:3]):
            if not torch.equal(a, b):
                raise AssertionError(f"9a kernel {label}: two calls not bit-equal")
        if label == "f32":
            res["f32_rel"] = max(rel_err(g, w) for g, w in zip(got[:3], want[:3]))
            res["f32_max_abs_err"] = max((g - w).abs().max().item()
                                         for g, w in zip(got[:3], want[:3]))
            if res["f32_rel"] > CHUNK_BAR:
                raise AssertionError(f"9a kernel f32: {res['f32_rel']:.3e} of max|ref|")
        else:
            res["bf16_snr_db"] = min(snr_db(g.float(), w.float())
                                     for g, w in zip(got[:3], want[:3]))
            if res["bf16_snr_db"] < HALF_BAR_DB:
                raise AssertionError(f"9a kernel bf16: {res['bf16_snr_db']:.1f} dB")
        res[f"{label}_ms"] = cuda_ms(kern, 20)
        res[f"{label}_plain_ms"] = cuda_ms(plain, 3, 1)
        res[f"{label}_bound"] = bound_ms(*scan_fwd_work(B, T, C, H, dt), dt)
        res[f"{label}_lib_ms"] = cudnn_lstm_fwd_ms(B, T, C, H, dt, dev, 20)
    return res


def step_chunk_phase(lk, tk, dev, card) -> dict:
    """Phase 9a: `SkiM.step_chunk` at full width. The flagship
    (tse_skim_v0_causal, seed SEED) on CHUNK_STREAMS streams x CHUNK_SEGMENTS
    segments of 150 frames (the encoder's frames of the zero-primed audio),
    conditioned by 1 s enrollments: the f32 `step_chunk` stream against the
    f32 `step_frames` stream and against the offline `inference` of the
    zero-primed input (its masker's output, and the waveform decoded from
    the streamed masks), within CHUNK_BAR of max|ref|; the bf16 (`to_half`)
    `step_chunk` stream >= HALF_BAR_DB from the same f32 references; two
    `step_chunk` streams bit-equal in each dtype; a stream taking turns
    (CHUNK_MIXED) over CHUNK_MIXED_SEGMENTS against the `step_frames` one.
    Every part's `lstm_scan_train_fp` forward launches exactly as the code
    makes them: a segment through `step_chunk` n_blocks SegLSTM scans of B
    rows x 150 steps plus 2 (n_blocks - 1) MemLSTM one-step scans; through
    `step_frames` 150 n_blocks one-step scans plus the same MemLSTM ones.
    The wall ms of a segment through each step (CUDA events, CHUNK_WARM
    warm-up, the median of CHUNK_TIMED): at B = CHUNK_STREAMS the f32
    streams' own segments, at B = 1 two streams of their own. Then the
    kernel alone at the segment's shape."""
    import copy

    from puresound_tpu_torch.nnet.base_nn import apply_tf_masks, get_mask, wav_output_constrain
    from puresound_tpu_torch.streaming.engine import offline_equivalent_input
    from puresound_tpu_torch.streaming.halfprec import to_half
    from puresound_tpu_torch.zoo.tse import init_model

    t = time.perf_counter()
    model = init_model("tse_skim_v0_causal", device=dev,
                       generator=torch.Generator().manual_seed(SEED)).eval()
    half = to_half(copy.deepcopy(model))
    masker = model.masker
    K, n = masker.seg_size, masker.n_blocks
    mem = 2 * (n - 1)
    per_seg = {"chunk": n + mem, "frames": K * n + mem}
    B, S = CHUNK_STREAMS, CHUNK_SEGMENTS
    win, hop = model.encoder.win_length, model.encoder.hop_length
    rng = np.random.default_rng(SEED + 240)
    audio = torch.from_numpy((0.1 * rng.standard_normal((B, S * K * hop))).astype(np.float32)
                             ).to(dev)
    enroll = torch.from_numpy((0.1 * rng.standard_normal((B, 16000))).astype(np.float32)
                              ).to(dev)
    primed = offline_equivalent_input(audio, win, hop)
    res, launches = {}, [0, 0]

    def counted(fn, want_lstm, want_tcn, what):
        zero_counts(lk, tk)
        out = fn()
        torch.cuda.synchronize()
        c = counts(lk, tk)
        expect_launches(c, (want_lstm, 0, want_tcn, 0), f"9a {what}, LSTM and TCN (fwd, bwd)")
        launches[0] += c[0]
        launches[1] += c[2]
        return out

    def stream(m, frames, dvec, turns, dt, segments, times=None):
        """The streams through `turns`, a segment a call; each call's
        CUDA-event ms appended to `times` where given."""
        state, outs = m.init_state(frames.shape[0], dt, dev), []
        for s in range(segments):
            step = m.step_chunk if turns[s % len(turns)] == "chunk" else m.step_frames
            call = lambda: step(frames[:, s * K:(s + 1) * K], dvec, state)
            if times is None:
                y, state = call()
            else:
                (y, state), ms = event_ms(call)
                times.append(ms)
            outs.append(y)
        if state["frame_count"] != segments * K:
            raise AssertionError(f"9a: the clock reads {state['frame_count']} after "
                                 f"{segments} segments")
        return torch.cat(outs, -1)

    def decoded(mdl, feats, mask):
        enh = apply_tf_masks(feats, get_mask(mask, mdl.mask_constraint), mdl.mask_type,
                             mdl.f_type)
        return wav_output_constrain(mdl._decode(enh), mdl.output_constraint)

    want = lambda turns, segments=S: sum(per_seg[turns[s % len(turns)]]
                                         for s in range(segments))
    outs, times = {}, {("chunk", B): [], ("frames", B): []}
    with torch.no_grad():
        for label, mdl, dt in (("f32", model, torch.float32), ("bf16", half, torch.bfloat16)):
            x, e = primed.to(dt), enroll.to(dt)
            feats = mdl._encode(x)
            if feats.shape[-1] != S * K:
                raise AssertionError(f"9a: {feats.shape[-1]} frames, not {S * K}")
            dvec = counted(lambda: mdl._condition(e), 0, 5, f"{label} d-vectors")
            frames = feats.transpose(1, 2).contiguous()
            o = {"offline": counted(lambda: mdl.inference(x, e), n + mem, 5,
                                    f"{label} inference"),
                 "offline_mask": counted(lambda: mdl.masker(feats, dvec), n + mem, 0,
                                         f"{label} offline masker")}
            timed = times[("chunk", B)] if label == "f32" else None
            o["chunk"] = counted(lambda: stream(mdl.masker, frames, dvec, ("chunk",), dt, S,
                                                timed),
                                 want(("chunk",)), 0, f"{label} step_chunk")
            again = counted(lambda: stream(mdl.masker, frames, dvec, ("chunk",), dt, S),
                            want(("chunk",)), 0, f"{label} step_chunk again")
            if not torch.equal(o["chunk"], again):
                raise AssertionError(f"9a {label}: two step_chunk streams not bit-equal")
            o["wave"] = decoded(mdl, feats, o["chunk"])
            if label == "f32":
                o["frames"] = counted(
                    lambda: stream(mdl.masker, frames, dvec, ("frames",), dt, S,
                                   times[("frames", B)]),
                    want(("frames",)), 0, "f32 step_frames")
                o["mixed"] = counted(
                    lambda: stream(mdl.masker, frames, dvec, CHUNK_MIXED, dt,
                                   CHUNK_MIXED_SEGMENTS),
                    want(CHUNK_MIXED, CHUNK_MIXED_SEGMENTS), 0, "f32 mixed stream")
            outs[label] = o
        # B = 1: a stream of each step on frames of its own
        fr = torch.from_numpy((0.1 * rng.standard_normal((1, S * K, masker.input_size))
                               ).astype(np.float32)).to(dev)
        dv = torch.from_numpy(rng.standard_normal((1, masker.embed_dim)).astype(np.float32)
                              ).to(dev)
        for kind in ("chunk", "frames"):
            times[(kind, 1)] = []
            counted(lambda: stream(masker, fr, dv, (kind,), torch.float32, S, times[(kind, 1)]),
                    want((kind,)), 0, f"B=1 {kind} stream")
    f, h = outs["f32"], outs["bf16"]
    hold_f32_bf16("9a step_chunk vs step_frames", f["chunk"], h["chunk"], f["frames"], res,
                  "vs_frames")
    hold_f32_bf16("9a step_chunk vs offline masker", f["chunk"], h["chunk"], f["offline_mask"],
                  res, "vs_offline_mask")
    hold_f32_bf16("9a step_chunk vs offline inference", f["wave"], h["wave"], f["offline"],
                  res, "vs_offline")
    res["mixed_rel"] = rel_err(f["mixed"], f["frames"][..., :f["mixed"].shape[-1]])
    if res["mixed_rel"] > CHUNK_BAR:
        raise AssertionError(f"9a mixed stream vs step_frames: {res['mixed_rel']:.3e}")
    timing = {k: float(np.median(v[CHUNK_WARM:])) for k, v in times.items()}
    res["timing_ms"] = {f"B={b} {kind}": v for (kind, b), v in timing.items()}
    log("9a step_chunk", f"tse_skim_v0_causal, {B} streams x {S} segments of {K} frames, "
        f"{n} blocks: f32 step_chunk vs step_frames {res['vs_frames']['f32_rel']:.2e}, vs the "
        f"offline masker {res['vs_offline_mask']['f32_rel']:.2e}, decoded vs inference "
        f"{res['vs_offline']['f32_rel']:.2e} of max|ref|; bf16 step_chunk "
        f"{res['vs_frames']['bf16_snr_db']:.1f} / {res['vs_offline_mask']['bf16_snr_db']:.1f} / "
        f"{res['vs_offline']['bf16_snr_db']:.1f} dB from them; two streams bit-equal in each "
        f"dtype; mixed {CHUNK_MIXED} over {CHUNK_MIXED_SEGMENTS} segments "
        f"{res['mixed_rel']:.2e}; LSTM fwd a segment {per_seg['chunk']} (step_chunk) / "
        f"{per_seg['frames']} (step_frames), exact; one segment's wall ms (CUDA events, "
        f"{CHUNK_WARM} warm-up, median of {CHUNK_TIMED}), step_chunk / step_frames: " + "; ".join(
            f"B={b} {timing[('chunk', b)]:.3f} / {timing[('frames', b)]:.3f} "
            f"({timing[('frames', b)] / timing[('chunk', b)]:.1f}x)" for b in (1, B))
        + f" [{card}]", t)
    t = time.perf_counter()
    res["kernel"] = kc = step_chunk_kernel_case(lk, dev, card)
    log("9a step_chunk kernel", f"lstm_scan_train_fp at {kc['shape']}: f32 {kc['f32_ms']:.3f} ms "
        f"(plain {kc['f32_plain_ms']:.3f}, bound {kc['f32_bound'][0]:.4f} by "
        f"{kc['f32_bound'][1]}, cuDNN {kc['f32_lib_ms']}), {kc['f32_rel']:.2e} of max|ref|; "
        f"bf16 {kc['bf16_ms']:.3f} (plain {kc['bf16_plain_ms']:.3f}, bound "
        f"{kc['bf16_bound'][0]:.4f} by {kc['bf16_bound'][1]}, cuDNN {kc['bf16_lib_ms']}), "
        f"{kc['bf16_snr_db']:.1f} dB; two calls bit-equal [{card}]", t)
    res["launches"] = tuple(launches)
    res["per_segment"] = per_seg
    return res


def _flax_conv(i, o, k, rng) -> dict:
    """A flax `Conv2d`'s {w, b}, U(+-1/sqrt(fan-in)) from `rng`."""
    b = 1.0 / math.sqrt(i * k[0] * k[1])
    return {"w": rng.uniform(-b, b, (o, i, *k)).astype(np.float32),
            "b": rng.uniform(-b, b, (o,)).astype(np.float32)}


def _flax_bn(c, rng) -> tuple:
    """A flax `BatchNorm`'s params and batch_stats, off their init (scales
    near 1, running variances positive)."""
    n = lambda: rng.standard_normal(c).astype(np.float32)
    return ({"scale": 1 + 0.1 * n(), "bias": 0.1 * n()},
            {"mean": 0.1 * n(), "var": 0.5 + np.abs(n())})


def spectral_variables(cin, cout, kernel, rng) -> tuple:
    """JAX's SpectralTransform variables in flax's layout (params,
    batch_stats), drawn from `rng`."""
    params, stats = {}, {}
    for name, c in (("in_bn", cout), ("fft_bn", 2 * cout)):
        params[name], stats[name] = _flax_bn(c, rng)
    params.update(in_conv=_flax_conv(cin, cout, kernel, rng),
                  fft_conv=_flax_conv(2 * cout, 2 * cout, (1, 1), rng),
                  out_conv=_flax_conv(cout, cout, (1, 1), rng))
    return params, stats


def ffc_variables(cin, cout, alpha, kernel, rng) -> tuple:
    """JAX's FFC variables in flax's layout (params, batch_stats), drawn
    from `rng`."""
    g_in, g_out = int(cin * alpha), int(cout * alpha)
    st_p, st_s = spectral_variables(g_in, g_out, kernel, rng)
    params = {"global_spec_trans": st_p,
              "global_conv": _flax_conv(g_in, cout - g_out, kernel, rng),
              "local_global_conv": _flax_conv(cin - g_in, g_out, kernel, rng),
              "local_local_conv": _flax_conv(cin - g_in, cout - g_out, kernel, rng)}
    stats = {"global_spec_trans": st_s}
    for name, c in (("global_bn", g_out), ("local_bn", cout - g_out)):
        params[name], stats[name] = _flax_bn(c, rng)
    return params, stats


def ffc_phase(dev, card) -> dict:
    """Phase 9b: the FFC family on the card. `LayerNorm2D(CH, F)`,
    `SpectralTransform(CH, CH)` (causal) and `FFC(CH, CH, alpha=FFC_ALPHA)`
    (causal and not) at FFC_SHAPE with JAX-layout variables drawn from a seed
    and loaded through `utils.from_jax` (`layer_norm_2d`,
    `spectral_transform`, `ffc`), in eval and training mode: the card's f32
    within CHUNK_BAR of max|ref| of the same module's f64 run, in training
    the running statistics too, and the card's bf16 >= HALF_BAR_DB from it
    (its FFT in f32). The f64 reference runs on the card (cuDNN and cuFFT in
    f64; the CPU took most of a minute for the eight of them), and is held
    to the CPU's f64 run of the same module on the first sample in eval mode
    (within FFC_CPU_BAR); the causal FFC's first FFC_CUT frames unchanged
    when the later ones change. Plain PyTorch and cuFFT: no kernel of the
    port."""
    from puresound_tpu_torch.nnet.lobe.cnn import FFC, SpectralTransform
    from puresound_tpu_torch.nnet.lobe.norm import LayerNorm2D
    from puresound_tpu_torch.utils import from_jax as fj

    t = time.perf_counter()
    N, CH, F, T = FFC_SHAPE
    rng = np.random.default_rng(SEED + 250)
    x = torch.from_numpy(rng.standard_normal((N, CH, F, T)).astype(np.float32))
    ffc_vars = ffc_variables(CH, CH, FFC_ALPHA, FFC_KERNEL, rng)
    st_vars = spectral_variables(CH, CH, FFC_KERNEL, rng)
    ln = {"w": 1 + 0.1 * rng.standard_normal((1, CH, F, 1)).astype(np.float32),
          "b": 0.1 * rng.standard_normal((1, CH, F, 1)).astype(np.float32)}
    cases = {
        "LayerNorm2D": (lambda: LayerNorm2D(CH, F), fj.layer_norm_2d(ln)),
        "SpectralTransform causal": (
            lambda: SpectralTransform(CH, CH, FFC_KERNEL, causal=True),
            fj.spectral_transform(*st_vars)),
        **{f"FFC {'causal' if c else 'non-causal'}": (
            functools.partial(FFC, CH, CH, alpha=FFC_ALPHA, kernel_size=FFC_KERNEL, causal=c),
            fj.ffc(*ffc_vars)) for c in (True, False)}}
    res, cpu_s = {}, 0.0
    with torch.no_grad():
        for name, (make, flat) in cases.items():
            sd = fj.to_torch(flat)
            for train in (False, True):
                if train and name == "LayerNorm2D":
                    continue
                mods = {}
                for dt in (torch.float64, torch.float32, torch.bfloat16):
                    m = make()
                    m.load_state_dict(sd, strict=True)
                    mods[dt] = m.to(device=dev, dtype=dt).train(train)
                label = f"{name} {'train' if train else 'eval'}"
                want = mods[torch.float64](x.to(dev, torch.float64))
                f32 = mods[torch.float32](x.to(dev))
                bf16 = mods[torch.bfloat16](x.to(dev, torch.bfloat16))
                hold_f32_bf16(f"9b {label}", f32, bf16.float(), want, res, label)
                if bf16.dtype != torch.bfloat16:
                    raise AssertionError(f"9b {label}: bf16 in, {bf16.dtype} out")
                if train:
                    ref = mods[torch.float64].state_dict()
                    err = max(rel_err(v, ref[k]) for k, v in
                              mods[torch.float32].state_dict().items() if "running" in k)
                    res[label]["running_rel"] = err
                    if err > CHUNK_BAR:
                        raise AssertionError(f"9b {label}: running statistics {err:.3e}")
                else:
                    t_cpu = time.perf_counter()
                    cpu = make()
                    cpu.load_state_dict(sd, strict=True)
                    on_cpu = cpu.double().eval()(x[:1].double())
                    cpu_s += time.perf_counter() - t_cpu
                    res[label]["card_f64_vs_cpu_f64"] = err = rel_err(want[:1].cpu(), on_cpu)
                    if err > FFC_CPU_BAR:
                        raise AssertionError(f"9b {label}: the card's f64 {err:.3e} of max|ref| "
                                             f"from the CPU's (bar {FFC_CPU_BAR:g})")
        causal = cases["FFC causal"][0]().to(dev).eval()
        causal.load_state_dict(fj.to_torch(fj.ffc(*ffc_vars)), strict=True)
        x2 = x.clone()
        x2[..., FFC_CUT:] = torch.from_numpy(
            rng.standard_normal((N, CH, F, T - FFC_CUT)).astype(np.float32))
        base, pert = causal(x.to(dev)), causal(x2.to(dev))
        early = rel_err(pert[..., :FFC_CUT], base[..., :FFC_CUT])
        late = rel_err(pert[..., FFC_CUT:], base[..., FFC_CUT:])
    res["causal_early_rel"], res["causal_late_rel"] = early, late
    if early > 1e-5 or late < 1e-2:
        raise AssertionError(f"9b causal FFC: frames before {FFC_CUT} moved {early:.2e} of max|y|"
                             f" when later frames changed (bar 1e-5), later ones {late:.2e}")
    log("9b ffc", f"N, CH, F, T = {FFC_SHAPE}, alpha {FFC_ALPHA}, kernel {FFC_KERNEL}, JAX-layout "
        "variables through from_jax: card f32 vs card f64 / card bf16: " + "; ".join(
            f"{k} {v['f32_rel']:.2e} / {v['bf16_snr_db']:.1f} dB"
            + (f" (running stats {v['running_rel']:.2e})" if "running_rel" in v else "")
            + (f" (card f64 vs CPU f64 {v['card_f64_vs_cpu_f64']:.1e})"
               if "card_f64_vs_cpu_f64" in v else "")
            for k, v in res.items() if isinstance(v, dict))
        + f"; causal FFC: frames < {FFC_CUT} moved {early:.2e}, later {late:.2e} of max|y|; "
        f"the CPU's one-sample f64 runs {cpu_s:.1f} s [{card}]", t)
    return res


def chunk_ffc_phase(lk, tk, dev, card) -> dict:
    """Phase 9: 9a `step_chunk_phase` and 9b `ffc_phase`; returns 9a's
    launches by kernel (the kernels line's `launches_9`) and both results."""
    chunk = step_chunk_phase(lk, tk, dev, card)
    ffc = ffc_phase(dev, card)
    launches = {"lstm_scan_train_fp fwd": chunk["launches"][0],
                "tcn_block_train fwd": chunk["launches"][1]}
    return {"launches": launches, "chunk": chunk, "ffc": ffc}


def phase9_alone() -> int:
    """Phase 9 alone on one CUDA card, after building the two sources it
    launches (`lstm_train`, `tcn_train`): `python3 -c "import chip_smoke,
    sys; sys.exit(chip_smoke.phase9_alone())"` from the repo root."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import tcn_train_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = torch.device("cuda", 0), card_line()
    t = time.perf_counter()
    _build.build(("lstm_train", "tcn_train"))
    for mod in (lk, tk):
        mod._lib()
    log("1 build", "lstm_train, tcn_train built", t)
    out = chunk_ffc_phase(lk, tk, dev, card)
    print(json.dumps({"launches_9": out["launches"],
                      "lstm_scan_train_fp step_chunk shape": kernel_line(out["chunk"]["kernel"])}))
    print(card)
    return 0


def kernel_line(kc: dict) -> dict:
    """9a's kernel case in the kernels line's format."""
    return {"shape": kc["shape"], "ms": kc["f32_ms"], "plain_ms": kc["f32_plain_ms"],
            "bound_ms": kc["f32_bound"][0], "bound_by": kc["f32_bound"][1],
            "library_ms": kc["f32_lib_ms"], "max_abs_err": kc["f32_max_abs_err"],
            "bf16_ms": kc["bf16_ms"], "bf16_plain_ms": kc["bf16_plain_ms"],
            "bf16_bound_ms": kc["bf16_bound"][0], "bf16_library_ms": kc["bf16_lib_ms"],
            "bf16_snr_db": kc["bf16_snr_db"]}


def run(dev: torch.device) -> int:
    t0 = time.perf_counter()
    from puresound_tpu_torch.ops import _build
    from puresound_tpu_torch.ops import dparn_attention_kernel as dak
    from puresound_tpu_torch.ops import dual_path_kernel as dpk
    from puresound_tpu_torch.ops import masker_kernel as mkk
    from puresound_tpu_torch.ops import lstm_scan_kernel as lsk
    from puresound_tpu_torch.ops import lstm_train_kernel as lk
    from puresound_tpu_torch.ops import skim_stream_kernel as ops
    from puresound_tpu_torch.ops import tcn_train_kernel as tk
    from puresound_tpu_torch.nnet.skim import SkiM
    from puresound_tpu_torch.streaming.deploy import make_session_server
    from puresound_tpu_torch.streaming.engine import (StreamingTSE,
                                                      offline_equivalent_input)
    from puresound_tpu_torch.zoo.tse import init_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("0 device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; TF32 off for "
        "matmuls and cuDNN convolutions", t0)

    # ------------------------------------------------------------ 1. build
    t = time.perf_counter()
    sources = ("skim_stream", "lstm_train", "tcn_train", "lstm_scan", "dual_path",
               "dparn_attention", "masker")
    _build.build(sources)       # one nvcc per source, in parallel
    for mod in (ops, lk, tk, lsk, dpk, dak, mkk):
        mod._lib()
    for name in sources:
        regs = "; ".join(f"{k}: {r} registers, spills {st}/{ld} B"
                         for k, r, st, ld in _build.ptxas_report(name))
        log("1 build", f"{name}.cu built in {_build.build_seconds[name]:.1f} s "
            f"(nvcc, sm_90a); ptxas: {regs}", t)
    # tensor cores where bf16 wants them (the LSTM training kernels: mma.sync;
    # the TCN block's wgmma route, the bf16 attention route and the wide
    # center's resident convs: wgmma) and none in any kernel with float32 dots
    sass = sass_dumps(_build.BUILD_DIR, sources)
    for lib, want in (("lstm_train", lambda k: "<bf16>" in k and "reduce" not in k),
                      ("tcn_train", lambda k: k.startswith("tcn_wg_")),
                      ("lstm_scan", lambda k: k.startswith("lstm_scan_tc_kernel")),
                      ("dparn_attention", None), ("masker", None), ("dual_path", None),
                      ("skim_stream", None)):
        hmma = hmma_counts(_build.BUILD_DIR, lib, sass.get(lib)) if sass else {}
        if not hmma:
            log("1 build", f"cuobjdump not found: {lib} HMMA / HGMMA / IMMA not read", t)
            continue
        log("1 build", f"{lib}.cu tensor-core instructions by kernel, HMMA (mma.sync) / "
            "HGMMA (wgmma) / IMMA (int8 mma.sync) (cuobjdump -sass): " + "; ".join(
                f"{k} {a}/{b}/{i}" for k, (a, b, i) in sorted(hmma.items())), t)
        if want is not None:
            bad = [k for k, v in hmma.items() if want(k) != (sum(v) > 0)]
            if not any(want(k) for k in hmma):
                bad.append("no kernel of the tensor-core route")
        elif lib == "skim_stream":
            # fused_skim_frames: every build of the tensor-core kernel HMMA,
            # its int8 builds (<1> int8_hh, <3> int8_full) IMMA too; the
            # CUDA-core kernel and the probes none
            tc = sorted(k for k in hmma if k.startswith("skim_tc::skim_tc_kernel"))
            bad = [] if tc == [f"skim_tc::skim_tc_kernel<{q}>" for q in (0, 1, 3)] else [
                f"the tensor-core kernels {tc}"]
            for k, (a, b, i) in hmma.items():
                if k in tc and not (a and (i > 0) == (not k.endswith("<0>"))):
                    bad.append(f"{k}: HMMA {a}, IMMA {i}")
                elif k not in tc and a + b + i:
                    bad.append(f"{k}: tensor cores in a CUDA-core kernel")
        elif lib == "dparn_attention":
            # wgmma in the bf16 route and tensor cores nowhere else
            bad = [k for k, v in hmma.items()
                   if (sum(v) > 0) != (k == "dparn_wgmma::attn_kernel")]
            if not hmma.get("dparn_wgmma::attn_kernel", (0, 0, 0))[1]:
                bad.append("no HGMMA in the wgmma route")
        else:
            # float32 dots: the dtype-templated kernels without <db>
            bad = [k for k, v in hmma.items()
                   if ("<f32>" in k or "<bf16>" in k) and "<db>" not in k and sum(v)]
            if lib == "masker":
                convs = [b for k, (a, b, i) in hmma.items() if "conv_tc_kernel" in k]
                if not convs or not all(convs):
                    bad.append(f"HGMMA in the conv_tc_kernels: {convs}")
            # the dual-path passes (both libraries): the tensor-core route's
            # chains HMMA, and IMMA under int8_hh, its projection HGMMA; the
            # CUDA-core passes none
            for k, (a, b, i) in hmma.items():
                if k.startswith("dual_path_passes::") and a + b + i:
                    bad.append(f"{k}: tensor cores in a CUDA-core pass")
                elif k.startswith("dp_tc::dp_chain_kernel") and not (
                        a and (i if "<q8>" in k else not i)):
                    bad.append(f"{k}: HMMA {a}, IMMA {i}")
                elif k.startswith("dp_tc::dp_proj_tc_kernel") and not b:
                    bad.append(f"{k}: no HGMMA")
            if sum(k.startswith("dp_tc::") for k in hmma) != 6:
                bad.append("not the 6 kernels of the dual-path tensor-core route")
        if bad:
            raise AssertionError(f"{lib}: tensor cores where they should not be, or "
                                 f"none where they should: {bad}")

    # --------------------------------------------------- 2. kernel vs plain
    gen = torch.Generator().manual_seed(SEED)
    results = []
    for name, n, C, H, B, F, modes in SKIM_CASES:
        t = time.perf_counter()
        g = torch.Generator().manual_seed(SERVE_SEEDS[name]) if name in SERVE_SEEDS else gen
        r = kernel_case(ops, SkiM, name, n, C, H, B, F, modes, 20, g, dev)
        results.append(r)
        log("2 kernel", f"{name}: f32 max|d|/max|ref| {r['f32_rel_err']:.3e} "
            f"(max|d| {r['f32_max_abs_err']:.3e}), bf16 SNR "
            f"{r['bf16_snr_db']:.1f} dB; bf16 plan {r['bf16_plan']}; launches by route f32 "
            f"{r['f32_routes']}, bf16 {r['bf16_routes']}; two calls bit-equal; median ms "
            "kernel/plain: f32 "
            f"{r['f32_ms']:.3f}/{r['f32_plain_ms']:.3f}, bf16 "
            f"{r['bf16_ms']:.3f}/{r['bf16_plain_ms']:.3f}; one call's device ms by "
            f"kernel (profiler): f32 {split_line(r['f32_split'])}, bf16 "
            f"{split_line(r['bf16_split'])} [{card}]", t)

    # --------------------------------------- 2i. the Gate mode vs plain
    # phases 2i and 2j draw from generators of their own, so the data of
    # the phases around them stay as they were
    gate_gen = torch.Generator().manual_seed(SEED + 1)
    gate_results = {}
    for name, n, C, H, B, F, modes in GATE_CASES:
        t = time.perf_counter()
        g = (torch.Generator().manual_seed(SERVE_SEEDS[name]) if name in SERVE_SEEDS
             else gate_gen)
        r = kernel_case(ops, SkiM, name, n, C, H, B, F, modes, GATE_CHUNKS, g, dev,
                        GATE_BARS)
        gate_results[name] = r
        flag_ms = (f"; FiLM flagship (phase 2) f32 {results[0]['f32_ms']:.3f} / bf16 "
                   f"{results[0]['bf16_ms']:.3f}" if B == 1024 else "")
        log("2i gate", f"{name}, modes {modes}, {GATE_CHUNKS} carried chunks: f32 "
            f"max|d|/max|ref| {r['f32_rel_err']:.3e} (bar {GATE_BARS[0]:g}; max|d| "
            f"{r['f32_max_abs_err']:.3e}), bf16 SNR {r['bf16_snr_db']:.1f} dB (bar "
            f"{GATE_BARS[1]:g}); bf16 plan {r['bf16_plan']}; launches by route f32 "
            f"{r['f32_routes']}, bf16 "
            f"{r['bf16_routes']}; two calls bit-equal; median ms kernel/plain: f32 "
            f"{r['f32_ms']:.3f}/{r['f32_plain_ms']:.3f}, bf16 {r['bf16_ms']:.3f}/"
            f"{r['bf16_plain_ms']:.3f}{flag_ms}; one call's device ms by kernel (profiler): "
            f"f32 {split_line(r['f32_split'])}, bf16 {split_line(r['bf16_split'])} [{card}]", t)

    # ------------------------------------- 2b. LSTM training kernel vs plain
    lstm_results = {}
    for name, B, T, C, H, reverse, reps in LSTM_CASES:
        t = time.perf_counter()
        g = torch.Generator().manual_seed(LSTM_SEEDS[name]) if name in LSTM_SEEDS else gen
        r = lstm_kernel_case(lk, name, B, T, C, H, reverse, g, dev, reps)
        lstm_results[name] = r
        fmt = lambda v: "n/a" if v is None else f"{v:.3f}"
        split = ""
        if name == "SegLSTM":   # its own data, so the phases after keep theirs
            r["split"] = {lb: lstm_split(lk, B, T, C, H, dt, dev)
                          for lb, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
            split = "; device ms by kernel (profiler): " + "; ".join(
                f"{lb} {split_text(v)}" for lb, v in r["split"].items())
        log("2b lstm", f"{r['shape']}: two calls of each kernel bit-equal; "
            f"clusters in flight (fwd, bwd) f32 "
            f"{lk.clusters_in_flight(B, T, C, H, torch.float32, dev)}, bf16 "
            f"{lk.clusters_in_flight(B, T, C, H, torch.bfloat16, dev)}; "
            f"f32 max|d|/max|ref| values "
            f"{r['f32_val_rel']:.2e}, grads {r['f32_grad_rel']:.2e}; bf16 SNR "
            f"values {r['bf16_val_snr']:.1f} dB, grads {r['bf16_grad_snr']:.1f} dB; "
            + "; ".join(
                f"{lb} ms fwd/bwd kernel {r[f'{lb}_fwd_ms']:.3f}/{r[f'{lb}_bwd_ms']:.3f}, "
                f"plain {r[f'{lb}_plain_fwd_ms']:.3f}/{r[f'{lb}_plain_bwd_ms']:.3f}, "
                f"cuDNN {fmt(r[f'{lb}_lib_fwd_ms'])}/{fmt(r[f'{lb}_lib_bwd_ms'])} "
                f"(fwd+bwd {fmt(r[f'{lb}_lib_fwdbwd_ms'])}), "
                f"bound {r[f'{lb}_fwd_bound'][0]:.3f}/{r[f'{lb}_bwd_bound'][0]:.3f}"
                for lb in ("f32", "bf16")) + f"{split} [{card}]", t)

    # ------------- 2j. lstm_scan_train(_tm), lstm_scan_train_fp_tm vs plain
    unfused_results = {}
    unfused_gen = torch.Generator().manual_seed(SEED + 2)
    for name, B, T, C, H, reverse, reps in UNFUSED_CASES:
        t = time.perf_counter()
        r = lstm_unfused_case(lk, name, B, T, C, H, reverse, unfused_gen, dev, reps)
        unfused_results[name] = r
        fmt = lambda v: "n/a" if v is None else f"{v:.3f}"
        split = ""
        if name == "SegLSTM":
            r["split"] = {lb: lstm_split(lk, B, T, C, H, dt, dev, hoisted=True)
                          for lb, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
            split = "; lstm_scan_train_tm device ms by kernel (profiler): " + "; ".join(
                f"{lb} {split_text(v)}" for lb, v in r["split"].items())
        log("2j lstm unfused", f"{r['shape']}: lstm_scan_train_tm f32 max|d|/max|ref| "
            f"values {r['f32_val_rel']:.2e}, grads {r['f32_grad_rel']:.2e}; bf16 SNR values "
            f"{r['bf16_val_snr']:.1f} dB, grads {r['bf16_grad_snr']:.1f} dB; "
            + "; ".join(
                f"{lb} ms fwd/bwd kernel {r[f'{lb}_fwd_ms']:.3f}/{r[f'{lb}_bwd_ms']:.3f}, "
                f"plain {r[f'{lb}_plain_fwd_ms']:.3f}/{r[f'{lb}_plain_bwd_ms']:.3f}, bound "
                f"{r[f'{lb}_fwd_bound'][0]:.3f} ({r[f'{lb}_fwd_bound'][1]})/"
                f"{r[f'{lb}_bwd_bound'][0]:.3f} ({r[f'{lb}_bwd_bound'][1]}), batch-major "
                f"lstm_scan_train forward with its xp swap {r[f'{lb}_batch_major_fwd_ms']:.3f}"
                for lb in ("f32", "bf16"))
            + "; two calls of each kernel bit-equal; lstm_scan_train_fp_tm == the "
            "batch-major launches bit for bit, vs plain "
            f"f32 values {r['fp_tm_f32_val_rel']:.2e} grads {r['fp_tm_f32_grad_rel']:.2e}, "
            f"bf16 SNR {r['fp_tm_bf16_val_snr']:.1f} / {r['fp_tm_bf16_grad_snr']:.1f} dB; "
            + "; ".join(
                f"{lb} ms fwd/bwd kernel {r[f'fp_tm_{lb}_fwd_ms']:.3f}/"
                f"{r[f'fp_tm_{lb}_bwd_ms']:.3f}, plain {r[f'fp_tm_{lb}_plain_fwd_ms']:.3f}/"
                f"{r[f'fp_tm_{lb}_plain_bwd_ms']:.3f}, bound "
                f"{r[f'fp_tm_{lb}_fwd_bound'][0]:.3f}/{r[f'fp_tm_{lb}_bwd_bound'][0]:.3f}; "
                f"cuDNN LSTM (it projects the input too) fwd/bwd "
                f"{fmt(r[f'{lb}_lib_fwd_ms'])}/{fmt(r[f'{lb}_lib_bwd_ms'])}"
                for lb in ("f32", "bf16")) + f"{split} [{card}]", t)

    # -------------------------------------- 2c. TCN training kernel vs plain
    tcn_results = tcn_phase(tk, gen, dev, card)
    tcn_seed_sweep(tk, dev, card)

    # ------------------------------------------- 2d. the serving LSTM scan
    lscan_results = {}
    for name, B, T, H, reverse, carries, bf16_dot, bf16_state, reps in LSCAN_CASES:
        t = time.perf_counter()
        g = torch.Generator().manual_seed(LSCAN_SEEDS[name]) if name in LSCAN_SEEDS else gen
        r = lstm_scan_case(lsk, name, B, T, H, reverse, carries, bf16_dot, bf16_state, g,
                           dev, reps)
        lscan_results[name] = r
        fmt = lambda v: "n/a" if v is None else f"{v:.3f}"
        state = ("" if r["bf16_f32_state_rel"] is None else
                 f", its f32 hT / cT max|d|/max|ref| {r['bf16_f32_state_rel']:.2e} (bar 1e-4)")
        log("2d lstm_scan", f"{r['shape']}: launches by route f32 {r['f32_route']} / bf16 "
            f"{r['bf16_route']} (2 each), two calls bit-equal; f32 max|d|/max|ref| "
            f"{r['f32_rel']:.2e} (bar 1e-4), bf16 SNR {r['bf16_snr_db']:.1f} dB (bar 40)"
            f"{state}; " + "; ".join(
                f"{lb} device ms of one call {r[f'{lb}_ms']:.3f}, plain "
                f"{r[f'{lb}_plain_ms']:.3f}, bound {r[f'{lb}_bound'][0]:.3f} "
                f"({r[f'{lb}_bound'][1]}; {r[f'{lb}_bound_rule']}), "
                f"cuDNN LSTM forward with C=128 (it also projects the input) "
                f"{fmt(r[f'{lb}_lib_ms'])}" for lb in ("f32", "bf16")) + f" [{card}]", t)

    # --------------------------------------- 2e. the dual-path bottleneck
    dp_results = {}
    for name, B, F, K, CH, H, reps in DP_CASES:
        t = time.perf_counter()
        r = dual_path_case(dpk, name, B, F, K, CH, H, reps, gen, dev)
        dp_results[name] = r
        log("2e dual_path", f"{r['shape']}, {DP_CHUNKS} carried chunks: two calls "
            f"bit-equal; passes by route {r['passes']}; f32 "
            f"max|d|/max|ref| (y, carries) {r['f32_rel']:.2e} (bar 1e-4), bf16 SNR "
            f"{r['bf16_snr_db']:.1f} dB (bar 30); " + "; ".join(
                f"{lb} ms per chunk kernel {r[f'{lb}_ms']:.3f} (device ms by pass, profiler: "
                f"{split_line(r[f'{lb}_split'])}), plain "
                f"{r[f'{lb}_plain_ms']:.3f}, bound {r[f'{lb}_bound'][0]:.3f} "
                f"({r[f'{lb}_bound'][1]})" for lb in ("f32", "bf16")) + f" [{card}]", t)
    # the model geometry's bf16 chunk took the tensor cores, f32 the CUDA cores
    for name, _, _, _, CH, H, _ in DP_CASES:
        r = dp_results[name]
        if CH == H == 128 and (r["f32_route"], r["bf16_route"]) != ("cuda", "mma"):
            raise AssertionError(f"2e {name}: routes f32 {r['f32_route']}, bf16 "
                                 f"{r['bf16_route']}, not cuda, mma")

    # ------------------------------------ 2f. the DPARN intra attention pass
    attn_results = {}
    for name, R, F, C, heads, FFD, reps in ATTN_CASES:
        t = time.perf_counter()
        r = attn_case(dak, name, R, F, C, heads, FFD, reps, gen, dev)
        attn_results[name] = r
        log("2f dparn_intra_pass", f"{r['shape']}: two calls bit-equal; launches by path "
            f"{r['paths']}; f32 max|d|/max|ref| {r['f32_rel']:.2e} "
            f"(bar 1e-4), bf16 SNR {r['bf16_snr_db']:.1f} dB (bar 30); " + "; ".join(
                f"{lb} ms kernel {r[f'{lb}_ms']:.3f}, plain {r[f'{lb}_plain_ms']:.3f}, "
                f"stock nn.TransformerEncoder x2 + Linear + LayerNorm "
                f"{r[f'{lb}_stock_ms']:.3f}, bound {r[f'{lb}_bound'][0]:.3f} "
                f"({r[f'{lb}_bound'][1]})" for lb in ("f32", "bf16")) + f" [{card}]", t)
    # both routes of the kernel were held against the plain version under bf16
    routes = {p for r in attn_results.values() for p in r["paths"].get("bf16", {})}
    if routes != set(dak.PATHS):
        raise AssertionError(f"2f ran the bf16 routes {sorted(routes)}, not {dak.PATHS}")

    # --------------------------------------------- 2g. the wide-center masker
    center_results = {}
    for name, zoo_name, B, reps in CENTER_CASES + [CENTER_RAGGED]:
        t = time.perf_counter()
        r = center_case(mkk, name, zoo_name, B, reps, dev)
        if (name, zoo_name, B, reps) != CENTER_RAGGED:
            center_results[name] = r
        log("2g center", f"{name}, {r['shape']}, {DP_CHUNKS} carried chunks: two calls "
            f"bit-equal; launches by path {r['paths']}; dual-path passes by route "
            f"{r.get('passes')}; f32 "
            f"max|d|/max|ref| (y, 11 carries) {r['f32_rel']:.2e} (bar 1e-4), bf16 SNR "
            f"{r['bf16_snr_db']:.1f} dB (bar 30); " + "; ".join(
                f"{lb} ms per chunk kernel {r[f'{lb}_ms']:.3f} (device ms by pass, profiler: "
                f"{split_line(r[f'{lb}_split'])}), plain "
                f"{r[f'{lb}_plain_ms']:.3f}, the port's cuDNN convs + bottleneck kernels "
                f"{r[f'{lb}_stock_ms']:.3f}, bound {r[f'{lb}_bound'][0]:.3f} "
                f"({r[f'{lb}_bound'][1]})" for lb in ("f32", "bf16")) + f" [{card}]", t)

    # ------------------------- 2h. the int8 and bf16-scratch kernel variants
    dp2048 = dp_results["2048 streams"]
    gate_flag = gate_results[GATE_CASES[0][0]]
    base = {"fused_skim_frames": (results[0]["f32_ms"], results[0]["bf16_ms"]),
            "fused_skim_frames gate": (gate_flag["f32_ms"], gate_flag["bf16_ms"]),
            "dual_path_chunk": (dp2048["f32_ms"], dp2048["bf16_ms"]),
            **{n: (r["f32_ms"], r["bf16_ms"]) for n, r in center_results.items()}}
    quant_results = quant_phase(ops, SkiM, dpk, mkk, gen, dev, card, base)

    # ------------------------------------------------------- 3. flagship
    t = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    model = init_model("tse_skim_v0_causal", device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 6_375_440:
        raise AssertionError(f"flagship has {n_params} parameters")
    engine = StreamingTSE.from_offline(model).eval()
    S, ticks, n_str = 240, 20, 4
    audio = (0.1 * torch.randn(n_str, S * ticks, generator=gen)).to(dev)
    enroll = (0.1 * torch.randn(n_str, 16000, generator=gen)).to(dev)
    with torch.no_grad():
        zero_counts(tk)
        dvec = engine.embed(enroll)
        torch.cuda.synchronize()
        expect_launches((tk.FWD_LAUNCHES, tk.BWD_LAUNCHES), (5, 0),
                        "StreamingTSE.embed, TCN (fwd, bwd)")
        state = engine.init_state(n_str)
        ops.LAUNCHES = 0
        ops.LAUNCHES_BY_ROUTE.clear()
        outs = []
        for k in range(ticks):
            y, state = engine.step(audio[:, k * S:(k + 1) * S], dvec, state,
                                   fused=True)
            outs.append(y)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES
        # float32 dots: the CUDA-core kernel
        expect_launches(dict(ops.LAUNCHES_BY_ROUTE), {"cuda": ticks},
                        "streamed f32 ticks, fused_skim_frames launches by route")
        streamed = torch.cat(outs, -1)
        zero_counts(lk, tk)
        offline = model.inference(offline_equivalent_input(audio, 32, 16),
                                  enroll)[:, :streamed.shape[-1]]
        torch.cuda.synchronize()
        offline_launches = counts(lk, tk)
    expect_launches(offline_launches, (10, 0, 5, 0),
                    "offline inference, LSTM and TCN (fwd, bwd)")
    expect_launches(launches, ticks, "streamed ticks, fused_skim_frames")
    err = (streamed - offline).abs().max().item()
    peak = offline.abs().max().item()
    if not torch.isfinite(streamed).all() or err > 1e-4 * peak:
        raise AssertionError(f"streamed vs offline max|d| {err:.3e} > "
                             f"1e-4 * max|y| ({peak:.3e})")
    log("3 flagship", f"{n_params:,} params; {ticks} ticks x {S} samples x "
        f"{n_str} streams fused == offline inference: max|d| {err:.3e}, "
        f"max|y| {peak:.3e}; fused_skim_frames launches {launches}; offline "
        f"inference's LSTM and TCN kernel launches (fwd, bwd) {offline_launches}; "
        f"embed's TCN launches 5; fused_skim_frames launches by route {{'cuda': {ticks}}}", t)

    # -------------------------------------------------------- 4. serving
    t = time.perf_counter()
    n_slots, n_ticks = 256, 25
    bundle = make_session_server(model, None, n_slots=n_slots, chunk_ms=15.0,
                                 half=True, fused=True, lockstep=True,
                                 enroll_len=16000)
    server = bundle.server
    chunk = bundle.chunk_samples
    rng = np.random.default_rng(SEED)
    enrolls = (0.1 * rng.standard_normal((n_slots, 16000))).astype(np.float32)
    feed = (0.1 * rng.standard_normal((n_slots, chunk * n_ticks))
            ).astype(np.float32)
    zero_counts(tk)
    tk.LAUNCHES_BY_ROUTE.clear()
    sids = [server.attach(enroll=enrolls[i]) for i in range(n_slots)]
    torch.cuda.synchronize()
    expect_launches((tk.FWD_LAUNCHES, tk.BWD_LAUNCHES), (5 * n_slots, 0),
                    "session attaches, TCN (fwd, bwd)")
    # the bf16 attach (B=1 x 1 s of enrollment) runs the TCN block's wgmma route
    expect_launches(dict(tk.LAUNCHES_BY_ROUTE), {("fwd", "wgmma"): 5 * n_slots},
                    "session attaches, TCN launches by route")
    t_attach = time.perf_counter() - t
    served = np.zeros((n_slots, chunk * n_ticks), np.float32)
    ops.LAUNCHES = 0
    ops.LAUNCHES_BY_ROUTE.clear()
    for k in range(n_ticks):
        for i, sid in enumerate(sids):
            server.hub.push_input(sid, feed[i, k * chunk:(k + 1) * chunk])
        n_out = server.tick()
        if n_out != n_slots:
            raise AssertionError(f"tick {k}: {n_out} outputs, not {n_slots}")
        for i, sid in enumerate(sids):
            got = server.hub.pop_output(sid, chunk)
            if len(got) != chunk or not np.isfinite(got).all():
                raise AssertionError(f"tick {k} slot {sid}: bad output")
            served[i, k * chunk:(k + 1) * chunk] = got
    torch.cuda.synchronize()
    serve_launches = ops.LAUNCHES
    stats = server.stats.snapshot()
    expect_launches(serve_launches, n_ticks, "serving ticks, fused_skim_frames")
    serve_routes = dict(ops.LAUNCHES_BY_ROUTE)
    expect_launches(serve_routes, {"mma": n_ticks},
                    "bf16 serving ticks, fused_skim_frames launches by route")
    if stats["underrun_slot_ticks"] != 0:
        raise AssertionError(f"{stats['underrun_slot_ticks']} underruns")
    # slot 0 served in bf16 against the f32 engine on the same audio
    with torch.no_grad():
        d0 = engine.embed(torch.from_numpy(enrolls[:1]).to(dev))
        st0 = engine.init_state(1)
        ref0 = []
        for k in range(n_ticks):
            y, st0 = engine.step(torch.from_numpy(
                feed[:1, k * chunk:(k + 1) * chunk]).to(dev), d0, st0,
                fused=True)
            ref0.append(y)
        ref0 = torch.cat(ref0, -1)[0].float().cpu()
    half_snr = snr_db(torch.from_numpy(served[0]), ref0)
    log("4 serving", f"{n_slots} sessions (attach {t_attach:.2f} s, "
        f"{5 * n_slots} TCN launches), "
        f"{n_ticks} ticks of {chunk} samples: {n_slots} finite outputs per "
        f"tick, 0 underruns, launches {serve_launches} (by route {serve_routes}); tick p50 "
        f"{stats['tick_ms_p50']:.3f} ms, p99 {stats['tick_ms_p99']:.3f} ms; "
        f"bf16 slot 0 vs f32 engine SNR {half_snr:.1f} dB [{card}]", t)

    # ------------------------------------- 4e. quantized flagship serving
    tse_q = {opt: tse_quant_serving(ops, model, opt, TSE_Q_SLOTS, dev, card)
             for opt in ("int8_hh", "int8_full")}
    # ------------------------------- 4f. pipelined and pcm16 flagship serving
    transport = transport_phase(ops, model, TRANSPORT_SLOTS, dev, card)
    log("4f transport", f"phase 4 (the same server, float32 transport, unpipelined, no "
        f"warm-up ticks) read tick p50 {stats['tick_ms_p50']:.3f} ms, p99 "
        f"{stats['tick_ms_p99']:.3f} at {n_slots} sessions [{card}]", time.perf_counter())

    # --------------------------- 3g, 4i. the Gate model, streamed and served
    gate = gate_full_width(ops, lk, tk, dev, card)
    gate_serve = {n: tse_quant_serving(ops, gate, None, n, dev, card, "Gate model",
                                       "4i gate serving", GATE_BF16_BAR)
                  for n in GATE_SLOTS}
    gate_q = {opt: tse_quant_serving(ops, gate, opt, GATE_SLOTS[-1], dev, card,
                                     "Gate model", "4i gate serving")
              for opt in ("int8_hh", "int8_full")}
    del gate

    # ------------------------------------- 3b, 4b. NS: ns_dpcrn_v0_causal
    counters = [("lstm_scan_train_fp", lk, "FWD_BY_ENTRY"), ("lstm_scan", lsk, "LAUNCHES"),
                ("dual_path_chunk", dpk, "LAUNCHES"), ("center_chunk", mkk, "LAUNCHES")]
    ns = ns_full_width("ns_dpcrn_v0_causal", 1_380_043, [
        ("stock", {}, (6, 0, 0, 0)), ("fused", {"fused": True}, (0, 6, 0, 0)),
        ("dp_kernel", {"dp_kernel": True}, (0, 0, 1, 0)),
        ("mk_kernel", {"mk_kernel": True}, (0, 0, 0, 1))], counters, (6, 0, 0, 0),
        dev, card, "3b ns")
    ns_serve = {n: ns_serving(ns, "ns_dpcrn_v0_causal", {"dp_kernel": True}, counters,
                              (0, 0, 1, 0), 35.0, n, dev, card, "4b ns serving",
                              by_pass=DPCRN_TC_PASSES)
                for n in NS_SLOTS}
    ns_routes = ns["routes"]
    # ------------------------------- 4d. the wide-center route of DPCRN serving
    mk_serve = {n: ns_serving(ns, "ns_dpcrn_v0_causal", {"mk_kernel": True}, counters,
                              (0, 0, 0, 1), 25.0, n, dev, card, "4d ns mk_kernel",
                              by_pass=DPCRN_TC_PASSES)
                for n in NS_SLOTS}
    log("4d ns mk_kernel", "tick p50 / engine step p50 ms, dp_kernel (4b) against mk_kernel: "
        + "; ".join(f"{n} slots {ns_serve[n]['tick_p50']:.3f} / {ns_serve[n]['step_p50']:.3f} "
                    f"against {mk_serve[n]['tick_p50']:.3f} / {mk_serve[n]['step_p50']:.3f}"
                    for n in NS_SLOTS) + f" [{card}]", time.perf_counter())
    # ------------------------- 4j. the fused route of DPCRN serving (lstm_scan)
    fused_serve = ns_serving(ns, "ns_dpcrn_v0_causal", {"fused": True}, counters, (0, 6, 0, 0),
                             35.0, NS_SLOTS[-1], dev, card, "4j ns fused",
                             by_route=(lsk, "tc", 6))
    # ------------------- 4g. DPCRN serving with the int8 and bf16-scratch options
    ns_q = {}
    for route, opt, bar, per_tick, mod in (
            ("dp_kernel", "int8_hh", 20.0, (0, 0, 1, 0), dpk),
            ("mk_kernel", "int8_hh", 30.0, (0, 0, 0, 1), mkk),
            ("dp_kernel", "xscr_half", 35.0, (0, 0, 1, 0), dpk),
            ("mk_kernel", "xscr_half", 35.0, (0, 0, 0, 1), mkk),
            ("dp_kernel", "int8_hh+xscr_half", 20.0, (0, 0, 1, 0), dpk)):
        ns_q[(route, opt)] = ns_serving(
            ns, "ns_dpcrn_v0_causal", {route: True}, counters, per_tick, bar, NS_SLOTS[-1],
            dev, card, "4g ns quantized", options=opts_of(opt), by_option=(mod, opt),
            by_pass=DPCRN_TC_PASSES)
    del ns

    # ------------------------------------- 3c, 4c. NS: ns_dparn_v0_causal
    counters = [("lstm_scan_train_fp", lk, "FWD_BY_ENTRY"), ("lstm_scan", lsk, "LAUNCHES"),
                ("dparn_intra_pass", dak, "LAUNCHES"), ("dparn_center_chunk", mkk, "LAUNCHES")]
    dparn = ns_full_width("ns_dparn_v0_causal", 1_215_179, [
        ("stock", {}, (2, 0, 0, 0)), ("fused", {"fused": True}, (0, 2, 0, 0)),
        ("attn_kernel", {"attn_kernel": True}, (2, 0, 2, 0)),
        ("fused+attn_kernel", {"fused": True, "attn_kernel": True}, (0, 2, 2, 0)),
        ("mk_kernel", {"mk_kernel": True}, (0, 0, 0, 1))], counters, (2, 0, 0, 0),
        dev, card, "3c dparn")
    dparn_serve = {n: ns_serving(dparn, "ns_dparn_v0_causal",
                                 {"fused": True, "attn_kernel": True}, counters,
                                 (0, 2, 2, 0), 25.0, n, dev, card, "4c dparn serving",
                                 by_path=(dak, "wgmma", 2), by_route=(lsk, "tc", 2))
                   for n in DPARN_SLOTS}
    dparn_routes = dparn["routes"]
    # -------------------------- 4h. DPARN wide-center serving with xscr_half
    dparn_q = ns_serving(dparn, "ns_dparn_v0_causal", {"mk_kernel": True}, counters,
                         (0, 0, 0, 1), 25.0, DPARN_SLOTS[-1], dev, card, "4h dparn xscr_half",
                         options={"xscr_half": True}, by_option=(mkk, "xscr_half"),
                         by_path=(mkk, "attn=wgmma,conv=resident", 1),
                         by_pass=DPARN_TC_PASSES)
    del dparn

    # ----------------------------------------------- 5. card vs CPU step
    card_vs_cpu_step(lk, tk, dev, card)

    # ------------------------------------------ 6. full-width training
    train = {label: full_width_training(lk, tk, dev, card, dt)
             for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}

    # ------------------- 6c. the training step under the LSTM path's switches
    settings = train_settings_phase(lk, tk, dev, card)
    determinism = step_determinism(dev, card)

    # ------------------------------------------- 6b. the recipe's trainer
    recipe = recipe_phase(lk, tk, dev, card)

    # --------------------------------------- 6d. NS training at full width
    ns_train = ns_training_phase(lk, tk, dev, card)
    keep = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # -------------------------- 6e. the flagship's shipped GE2E recipe
        recipe_1c = shipped_1c_phase(lk, tk, dev, card, keep=keep)
        # ------------------------------------------- 6f. the NS recipes
        ns_recipes = ns_recipe_phase(lk, tk, dev, card, keep=keep)
        # ------------------- 7. the recipes' evaluation actions on 6e / 6f's
        t = time.perf_counter()
        evals = eval_actions_phase(lk, tk, dev, card, keep)
        log("7 eval actions", "phase 7 in all, launches (LSTM fwd, LSTM bwd, TCN fwd, TCN "
            f"bwd) {evals['launches']}, serving (fused_skim_frames, lstm_scan, "
            f"dual_path_chunk, dparn_intra_pass, the centers) {evals['serving']}", t)
    finally:
        shutil.rmtree(keep, ignore_errors=True)

    # ------- the remaining shipped recipes: Conv-TasNet, PVAD, lookahead NS
    # 2k. their kernels at the new shapes against the plain versions
    new_shapes = new_shapes_phase(ops, SkiM, lk, tk, dev, card)
    # 4k. PVAD and Conv-TasNet serving
    pvad_serve = pvad_serving(ops, dev, card)
    tasnet_serve = conv_tasnet_serving(tk, dev, card)
    keep = tempfile.mkdtemp(prefix="chip_smoke_ckpt_7b_")
    try:
        # 6g. the shipped 1a / 1b / PVAD recipes' train
        tse_recipes = shipped_tse_phase(lk, tk, dev, card, keep)
        # 6h. the lookahead NS recipes' train
        ns_1b = ns_recipe_phase(lk, tk, dev, card, keep=keep, confs=SHIPPED_NS_1B,
                                phase="6h ns lookahead recipe")
        # 7b. the five configs' evaluation actions on 6g / 6h's checkpoints
        t = time.perf_counter()
        evals_7b = eval_7b_phase(lk, tk, dev, card, keep)
        log("7b eval actions", "phase 7b in all, launches (LSTM fwd, LSTM bwd, TCN fwd, TCN "
            f"bwd) {evals_7b['launches']}, serving (fused_skim_frames, lstm_scan, "
            f"dual_path_chunk, dparn_intra_pass, the centers) {evals_7b['serving']}", t)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    # ------------------------------------------------- DSS and the socket front
    # 4l. DSS serving, then run_serve's socket front for three models
    dss_serve = dss_serving_phase(ops, lk, tk, model, dev, card)
    keep = tempfile.mkdtemp(prefix="chip_smoke_ckpt_7c_")
    try:
        # 6i. the shipped DSS recipe's train
        dss_train = dss_recipe_phase(lk, tk, dev, card, keep)
        # 7c. its evaluation actions on 6i's checkpoints
        evals_7c = eval_7c_phase(lk, tk, dev, card, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    # 6j. the rest of the trainer: augmentation, remat, resume, data parallelism
    launches_6j = trainer_phase(lk, tk, dev, card)["launches"]
    # ------------------- the time-domain rest of the TSE zoo: 2l, 4m, 6k, 7d
    zoo = zoo_phases(ops, lk, tk, dev, card)
    # ------------------- the STFT-domain TSE zoo: 4n, 6l, 7e (no kernel launched)
    unet_phases(lk, tk, dev, card)
    launches_late = {"4n": {}, "6l": {}, "7e": {}}
    # ---------- 7f. export_model on torch.export, tSNE, the inf-injection probe
    export = export_phase(lk, tk, dev, card)
    launches_late["7f"] = {"lstm_scan_train_fp fwd": export["launches"][0],
                           "tcn_block_train fwd": export["launches"][2]}
    # ---- 8. the multi-device and demo periphery: seqpar, mesh serving, tp,
    # the improved attention layer, the demos, profiling and roofline
    launches_late["8"] = periphery_phase(ops, lk, tk, dev, card)["launches"]
    # ---- 9. SkiM.step_chunk at full width; FFC / SpectralTransform / LayerNorm2D
    phase9 = chunk_ffc_phase(lk, tk, dev, card)
    launches_late["9"] = phase9["launches"]
    sock = dss_serve["socket"]
    dss_by_slots = dss_serve["serving"]
    # each kernel's launches in phases 4l / 6i / 7c
    launches_4l = {
        "fused_skim_frames": sock["tse_skim_v0_causal"]["launches"][0],
        "tcn_block_train fwd": sock["tse_skim_v0_causal"]["launches"][1],
        "lstm_scan_train_fp fwd": dss_serve["f32"]["launches"][0],
        "lstm_scan": sum(r["launches"][1] for r in dss_by_slots.values()),
        "dparn_intra_pass": sum(r["launches"][2] for r in dss_by_slots.values()),
        "center_chunk": sum(sock["ns_dpcrn_v0_causal" + tag]["launches"][0]
                            for tag in ("", " deterministic")),
        "dparn_center_chunk": (sum(r["launches"][3] for r in dss_by_slots.values())
                               + sum(sock[DSS_NAME + tag]["launches"][3]
                                     for tag in ("", " deterministic")))}
    launches_6i = {"lstm_scan_train_fp fwd": dss_train["launches"][0],
                   "lstm_scan_train_fp bwd": dss_train["launches"][1]}
    launches_7c = {"lstm_scan_train_fp fwd": evals_7c["launches"][0],
                   "lstm_scan": evals_7c["serving"][1],
                   "dparn_center_chunk": evals_7c["serving"][4]}
    log("8 dss launches", f"4l {launches_4l}; 6i {launches_6i}; 7c {launches_7c}",
        time.perf_counter())

    launches_6g = [sum(r["launches"][i] for r in tse_recipes.values()) for i in range(4)]
    launches_6h = [sum(r["launches"][i] for r in ns_1b.values()) for i in range(4)]
    # the training launches of phases 6d-6f, (LSTM fwd, bwd, TCN fwd, bwd)
    new_training = [r["launches"] for k, r in ns_train.items() if k[1] != "check"]
    new_training += [recipe_1c["launches"]] + [r["launches"] for r in ns_recipes.values()]
    new_launches = [sum(c[i] for c in new_training) for i in range(4)]

    def case_line(r, half):
        """One phase 2b / 2c case's times beside its bound and yardsticks."""
        lib = "lib" if f"f32_lib_{half}_ms" in r else None
        return {"shape": r["shape"], "ms": r[f"f32_{half}_ms"],
                "plain_ms": r[f"f32_plain_{half}_ms"], "bound_ms": r[f"f32_{half}_bound"][0],
                "bound_by": r[f"f32_{half}_bound"][1],
                "library_ms": r[f"f32_lib_{half}_ms"] if lib else None,
                "bf16_ms": r[f"bf16_{half}_ms"], "bf16_plain_ms": r[f"bf16_plain_{half}_ms"],
                "bf16_bound_ms": r[f"bf16_{half}_bound"][0],
                "bf16_library_ms": r[f"bf16_lib_{half}_ms"] if lib else None}

    def skim_line(r):
        """One phase 2k fused_skim_frames case's times beside its bound."""
        return {"shape": r["name"], "ms": r["f32_ms"], "plain_ms": r["f32_plain_ms"],
                "bound_ms": r["f32_bound"][0], "bound_by": r["f32_bound"][1],
                "library_ms": None, "max_abs_err": r["f32_max_abs_err"],
                "bf16_ms": r["bf16_ms"], "bf16_plain_ms": r["bf16_plain_ms"],
                "bf16_bound_ms": r["bf16_bound"][0], "bf16_snr_db": r["bf16_snr_db"],
                "bf16_plan": r["bf16_plan"], "routes": {"f32": r["f32_routes"],
                                                        "bf16": r["bf16_routes"]}}

    # ---------------------------------------------------- 8. the kernels line
    flag = results[0]
    skim_bound = bound_ms(*skim_work(4, 128, 256, 15, 1024, torch.float32),
                          torch.float32)
    kernels = [{
        "name": "fused_skim_frames", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": serve_launches + pvad_serve["launches"],
        "launches_4k": pvad_serve["launches"],
        "new_shapes": {n: skim_line(r) for n, r in new_shapes["skim"].items()},
        "max_abs_err": flag["f32_max_abs_err"], "ms": flag["f32_ms"],
        "plain_ms": flag["f32_plain_ms"], "bound_ms": skim_bound[0],
        "bound_by": skim_bound[1], "library_ms": None,
        "bf16_ms": flag["bf16_ms"], "bf16_plain_ms": flag["bf16_plain_ms"],
        "bf16_bound_ms": bound_ms(*skim_work(4, 128, 256, 15, 1024, torch.bfloat16),
                                  torch.bfloat16)[0],
        "bf16_snr_db": flag["bf16_snr_db"],
        "launches_by_route": serve_routes, "bf16_route": "mma (skim_stream_tc.cuh)",
        "device_ms_by_kernel": {lb: flag[f"{lb}_split"] for lb in ("f32", "bf16")},
        "shape": "n=4 C=128 H=256 F=15 B=1024"}]
    seg = lstm_results["SegLSTM"]
    # phase 6c's launches by entry
    by_entry = lambda half, e: sum(r[f"{half}_launches"].get(e, 0) for r in settings.values())
    for half, replaces in (("fwd", LSTM_REPLACES[0]), ("bwd", LSTM_REPLACES[1])):
        i = 0 if half == "fwd" else 1
        kernels.append({
            "name": f"lstm_scan_train_fp ({'forward' if i == 0 else 'backward'})",
            "route": "cuda", "source": LSTM_SOURCE, "replaces": replaces,
            "launches": (train["f32"]["launches"][i] + train["bf16"]["launches"][i]
                         + recipe["launches"][i] + by_entry(half, "fp") + new_launches[i]
                         + evals["launches"][i] + launches_6g[i] + launches_6h[i]
                         + evals_7b["launches"][i]),
            "launches_6d_6f": new_launches[i], "launches_7": evals["launches"][i],
            "launches_6g": launches_6g[i], "launches_6h": launches_6h[i],
            "launches_7b": evals_7b["launches"][i],
            "new_shapes": {**{n: case_line(lstm_results[n], half) for n in LSTM_SEEDS},
                           **{n: case_line(r, half) for n, r in new_shapes["lstm"].items()},
                           **{n: case_line(r, half) for n, r in zoo["shapes"]["lstm"].items()}},
            "max_abs_err": seg["f32_max_abs_err"], "ms": seg[f"f32_{half}_ms"],
            "plain_ms": seg[f"f32_plain_{half}_ms"],
            "bound_ms": seg[f"f32_{half}_bound"][0],
            "bound_by": seg[f"f32_{half}_bound"][1],
            "library_ms": seg[f"f32_lib_{half}_ms"],
            "bf16_ms": seg[f"bf16_{half}_ms"],
            "bf16_plain_ms": seg[f"bf16_plain_{half}_ms"],
            "bf16_bound_ms": seg[f"bf16_{half}_bound"][0],
            "bf16_library_ms": seg[f"bf16_lib_{half}_ms"],
            "device_ms_by_kernel": {lb: v.get(half) for lb, v in seg["split"].items()},
            "two_calls_bit_equal": True, "shape": seg["shape"]})
    gb = bound_ms(*skim_work(4, 128, 256, 15, 1024, torch.float32, "gate"), torch.float32)
    kernels.append({
        "name": "fused_skim_frames gate", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "entry": "puresound_tpu/ops/skim_stream_kernel.py:148-165",
        "launches": sum(r["launches"] for r in gate_serve.values()),
        "max_abs_err": gate_flag["f32_max_abs_err"], "ms": gate_flag["f32_ms"],
        "plain_ms": gate_flag["f32_plain_ms"], "bound_ms": gb[0], "bound_by": gb[1],
        "library_ms": None, "bf16_ms": gate_flag["bf16_ms"],
        "bf16_plain_ms": gate_flag["bf16_plain_ms"],
        "bf16_bound_ms": bound_ms(*skim_work(4, 128, 256, 15, 1024, torch.bfloat16, "gate"),
                                  torch.bfloat16)[0],
        "bf16_snr_db": gate_flag["bf16_snr_db"], "film_ms": flag["f32_ms"],
        "launches_by_route": {n: r["routes"] for n, r in gate_serve.items()},
        "device_ms_by_kernel": {lb: gate_flag[f"{lb}_split"] for lb in ("f32", "bf16")},
        "shape": "n=4 C=128 H=256 Hg=128 F=15 B=1024, every block a Gate"})
    seg_u = unfused_results["SegLSTM"]
    for half, i in (("fwd", 0), ("bwd", 1)):
        word = "forward" if i == 0 else "backward"
        hoisted, fp_tm = by_entry(half, "hoisted"), by_entry(half, "fp_tm")
        kernels.append({
            "name": f"lstm_scan_train ({word})", "route": "cuda", "source": LSTM_SOURCE,
            "replaces": UNFUSED_REPLACES[i],
            "entry": "lstm_scan_train_tm (puresound_tpu/ops/lstm_train_kernel.py:264) and "
                     "its batch-major lstm_scan_train (:357)",
            "launches": hoisted, "max_abs_err": seg_u["f32_max_abs_err"],
            "ms": seg_u[f"f32_{half}_ms"], "plain_ms": seg_u[f"f32_plain_{half}_ms"],
            "bound_ms": seg_u[f"f32_{half}_bound"][0],
            "bound_by": seg_u[f"f32_{half}_bound"][1],
            "library_ms": seg_u[f"f32_lib_{half}_ms"],
            "library": "cuDNN nn.LSTM, C=128 (also projects the input)",
            "bf16_ms": seg_u[f"bf16_{half}_ms"],
            "bf16_plain_ms": seg_u[f"bf16_plain_{half}_ms"],
            "bf16_bound_ms": seg_u[f"bf16_{half}_bound"][0],
            "bf16_library_ms": seg_u[f"bf16_lib_{half}_ms"],
            "device_ms_by_kernel": {lb: v.get(half) for lb, v in seg_u["split"].items()},
            "two_calls_bit_equal": True, "shape": seg_u["shape"]})
        kernels.append({
            "name": f"lstm_scan_train_fp_tm ({word})", "route": "cuda",
            "source": LSTM_SOURCE, "replaces": LSTM_REPLACES[i], "entry": FP_TM_ENTRY,
            "launches": fp_tm, "max_abs_err": seg_u["fp_tm_f32_max_abs_err"],
            "ms": seg_u[f"fp_tm_f32_{half}_ms"],
            "plain_ms": seg_u[f"fp_tm_f32_plain_{half}_ms"],
            "bound_ms": seg_u[f"fp_tm_f32_{half}_bound"][0],
            "bound_by": seg_u[f"fp_tm_f32_{half}_bound"][1],
            "library_ms": seg_u[f"f32_lib_{half}_ms"],
            "library": "cuDNN nn.LSTM, C=128", "bit_equal_to_batch_major": True,
            "bf16_ms": seg_u[f"fp_tm_bf16_{half}_ms"],
            "bf16_plain_ms": seg_u[f"fp_tm_bf16_plain_{half}_ms"],
            "bf16_bound_ms": seg_u[f"fp_tm_bf16_{half}_bound"][0],
            "bf16_library_ms": seg_u[f"bf16_lib_{half}_ms"], "shape": seg_u["shape"]})
    spk = tcn_results["speaker d=1"]
    for half, replaces in (("fwd", TCN_REPLACES[0]), ("bwd", TCN_REPLACES[1])):
        i = 2 if half == "fwd" else 3
        kernels.append({
            "name": f"tcn_block_train ({'forward' if half == 'fwd' else 'backward'})",
            "route": "cuda", "source": TCN_SOURCE, "replaces": replaces,
            "launches": (train["f32"]["launches"][i] + train["bf16"]["launches"][i]
                         + recipe["launches"][i] + new_launches[i] + evals["launches"][i]
                         + (tasnet_serve["launches"] if half == "fwd" else 0)
                         + launches_6g[i] + evals_7b["launches"][i]),
            "launches_6d_6f": new_launches[i], "launches_7": evals["launches"][i],
            "launches_4k": tasnet_serve["launches"] if half == "fwd" else 0,
            "launches_6g": launches_6g[i], "launches_7b": evals_7b["launches"][i],
            "new_shapes": {**{n: case_line(tcn_results[n], half) for n in TCN_SEEDS},
                           **{n: case_line(r, half) for n, r in new_shapes["tcn"].items()},
                           **{n: case_line(r, half) for n, r in zoo["shapes"]["tcn"].items()}},
            "max_abs_err": spk["f32_max_abs_err"], "ms": spk[f"f32_{half}_ms"],
            "plain_ms": spk[f"f32_plain_{half}_ms"],
            "bound_ms": spk[f"f32_{half}_bound"][0],
            "bound_by": spk[f"f32_{half}_bound"][1], "library_ms": None,
            "stock_fwd_bwd_ms": spk["f32_stock_ms"],
            "bf16_ms": spk[f"bf16_{half}_ms"],
            "bf16_plain_ms": spk[f"bf16_plain_{half}_ms"],
            "bf16_bound_ms": spk[f"bf16_{half}_bound"][0],
            "bf16_stock_fwd_bwd_ms": spk["bf16_stock_ms"], "bf16_route": spk["bf16_route"],
            "bf16_device_ms_by_kernel": spk.get("bf16_split", {}).get(half),
            "shape": spk["shape"]})
    intra = lscan_results["intra"]
    kernels.append({
        "name": "lstm_scan", "route": "cuda", "source": LSCAN_SOURCE,
        "replaces": LSCAN_REPLACES,
        "launches": (ns_routes["fused"][1][1] + fused_serve["launches"][1]
                     + sum(r["launches"][1] for r in dparn_serve.values())
                     + evals["serving"][1] + evals_7b["serving"][1]),
        "launches_7": evals["serving"][1], "launches_7b": evals_7b["serving"][1],
        "launches_by_phase": {"3b fused (f32, cuda)": ns_routes["fused"][1][1],
                              "4j DPCRN fused serving": fused_serve["routes"],
                              "4c DPARN serving": {n: r["routes"]
                                                   for n, r in dparn_serve.items()}},
        "max_abs_err": intra["f32_max_abs_err"], "ms": intra["f32_ms"],
        "plain_ms": intra["f32_plain_ms"], "bound_ms": intra["f32_bound"][0],
        "bound_by": intra["f32_bound"][1], "library_ms": intra["f32_lib_ms"],
        "library": "cuDNN nn.LSTM forward, C=128 (also projects the input)",
        "bf16_route": f"{intra['bf16_route']} ({intra['bf16_pieces']} bf16 piece(s) of h)",
        "bf16_ms": intra["bf16_ms"], "bf16_plain_ms": intra["bf16_plain_ms"],
        "bf16_bound_ms": intra["bf16_bound"][0], "bf16_bound_by": intra["bf16_bound"][1],
        "bf16_bound_rule": intra["bf16_bound_rule"], "bf16_library_ms": intra["bf16_lib_ms"],
        "bf16_snr_db": intra["bf16_snr_db"],
        "two_calls_bit_equal": all(r[f"{lb}_bit_equal"] for r in lscan_results.values()
                                   for lb in ("f32", "bf16")),
        "inter_ms": lscan_results["inter"]["f32_ms"],
        "inter_bf16_ms": lscan_results["inter"]["bf16_ms"],
        "inter_bf16_bound_ms": lscan_results["inter"]["bf16_bound"][0],
        "dparn_inter_bf16_ms": lscan_results["DPARN inter"]["bf16_ms"],
        "f32_state_hT_cT_rel": lscan_results["f32 state"]["bf16_f32_state_rel"],
        "shape": intra["shape"]})
    dp = dp_results["2048 streams"]
    kernels.append({
        "name": "dual_path_chunk", "route": "cuda", "source": DP_SOURCE,
        "replaces": DP_REPLACES,
        "launches": (sum(r["launches"][2] for r in ns_serve.values()) + evals["serving"][2]
                     + evals_7b["serving"][2]),
        "launches_7": evals["serving"][2], "launches_7b": evals_7b["serving"][2],
        "max_abs_err": dp["f32_max_abs_err"], "ms": dp["f32_ms"],
        "plain_ms": dp["f32_plain_ms"], "bound_ms": dp["f32_bound"][0],
        "bound_by": dp["f32_bound"][1], "library_ms": None,
        "bf16_ms": dp["bf16_ms"], "bf16_plain_ms": dp["bf16_plain_ms"],
        "bf16_bound_ms": dp["bf16_bound"][0], "bf16_snr_db": dp["bf16_snr_db"],
        "bf16_route": dp["bf16_route"], "device_ms_by_pass": {
            lb: dp[f"{lb}_split"] for lb in ("f32", "bf16")},
        "serving_passes_by_route": {n: r["passes"] for n, r in ns_serve.items()},
        "shape": dp["shape"]})
    at = attn_results["2048 streams"]
    kernels.append({
        "name": "dparn_intra_pass", "route": "cuda", "source": DPARN_SOURCE,
        "replaces": DPARN_REPLACES,
        "launches": (sum(r["launches"][2] for r in dparn_serve.values()) + evals["serving"][3]
                     + evals_7b["serving"][3]),
        "launches_7": evals["serving"][3], "launches_7b": evals_7b["serving"][3],
        "max_abs_err": at["f32_max_abs_err"], "ms": at["f32_ms"],
        "plain_ms": at["f32_plain_ms"], "bound_ms": at["f32_bound"][0],
        "bound_by": at["f32_bound"][1], "library_ms": None,
        "stock_ms": at["f32_stock_ms"],
        "stock": "nn.TransformerEncoder (2 post-norm ReLU layers, bias=False) + Linear + "
                 "LayerNorm, no single call computes the pass",
        "bf16_ms": at["bf16_ms"], "bf16_plain_ms": at["bf16_plain_ms"],
        "bf16_bound_ms": at["bf16_bound"][0], "bf16_stock_ms": at["bf16_stock_ms"],
        "bf16_snr_db": at["bf16_snr_db"], "shape": at["shape"]})
    center_7 = {"center_chunk": evals["by_model"]["ns_dpcrn_v0_causal"]["serving"][4],
                "dparn_center_chunk": evals["by_model"]["ns_dparn_v0_causal"]["serving"][4]}
    center_launches = {"center_chunk": sum(r["launches"][3] for r in mk_serve.values())
                       + center_7["center_chunk"],
                       "dparn_center_chunk": dparn_routes["mk_kernel"][1][3]
                       + center_7["dparn_center_chunk"]}
    for name, r in center_results.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CENTER_SOURCE,
            "replaces": CENTER_REPLACES[name], "entry": CENTER_ENTRY[name],
            "launches": center_launches[name], "launches_7": center_7[name],
            "max_abs_err": r["f32_max_abs_err"], "ms": r["f32_ms"],
            "plain_ms": r["f32_plain_ms"], "bound_ms": r["f32_bound"][0],
            "bound_by": r["f32_bound"][1], "library_ms": None,
            "stock_ms": r["f32_stock_ms"],
            "stock": "the port's route for the same layers: cuDNN convs + "
                     + ("dual_path_chunk" if name == "center_chunk"
                        else "dparn_intra_pass + lstm_scan"),
            "bf16_ms": r["bf16_ms"], "bf16_plain_ms": r["bf16_plain_ms"],
            "bf16_bound_ms": r["bf16_bound"][0], "bf16_stock_ms": r["bf16_stock_ms"],
            "bf16_snr_db": r["bf16_snr_db"], "passes_by_route": r.get("passes"),
            "device_ms_by_pass": {lb: r[f"{lb}_split"] for lb in ("f32", "bf16")},
            "shape": r["shape"]})
    q_launches = {
        "fused_skim_frames int8_hh": tse_q["int8_hh"]["launches"],
        "fused_skim_frames int8_full": tse_q["int8_full"]["launches"],
        "fused_skim_frames gate int8_hh": gate_q["int8_hh"]["launches"],
        "fused_skim_frames gate int8_full": gate_q["int8_full"]["launches"],
        "dual_path_chunk int8_hh": ns_q[("dp_kernel", "int8_hh")]["launches"][2],
        "dual_path_chunk xscr_half": ns_q[("dp_kernel", "xscr_half")]["launches"][2],
        "dual_path_chunk int8_hh+xscr_half":
            ns_q[("dp_kernel", "int8_hh+xscr_half")]["launches"][2],
        "center_chunk int8_hh": ns_q[("mk_kernel", "int8_hh")]["launches"][3],
        "center_chunk xscr_half": ns_q[("mk_kernel", "xscr_half")]["launches"][3],
        "dparn_center_chunk xscr_half": dparn_q["launches"][3]}
    where = {"fused_skim_frames": (SOURCE, REPLACES), "dual_path_chunk": (DP_SOURCE, DP_REPLACES),
             "center_chunk": (CENTER_SOURCE, CENTER_REPLACES["center_chunk"]),
             "dparn_center_chunk": (CENTER_SOURCE, CENTER_REPLACES["dparn_center_chunk"])}
    for name, r in quant_results.items():
        kernel = name.split()[0]
        base_key = "fused_skim_frames gate" if " gate " in name else kernel
        kernels.append({
            "name": name, "route": "cuda", "source": where[kernel][0],
            "replaces": where[kernel][1], "launches": q_launches[name],
            "max_abs_err": r["f32_max_abs_err"], "ms": r["f32_ms"],
            "plain_ms": r["f32_plain_ms"], "bound_ms": r["f32_bound"][0],
            "bound_by": r["f32_bound"][1], "library_ms": None,
            "int8_peak": ("CUDA cores (__dp4a), int8_core_ops measured by phase 2h's "
                          "dp4a loop" if "int8" in name else None),
            "int8_core_ops": INT8_CORE_OPS if "int8" in name else None,
            "bf16_int8_peak": ("tensor cores (mma.sync m16n8k32), int8_tc_ops"
                               if "int8" in name else None),
            "int8_tc_ops": INT8_TC_OPS if "int8" in name else None,
            "without_option_ms": base[base_key][0], "snr_db": r["f32_snr_db"],
            "snr_bar_db": r["f32_bar_db"], "control_snr_db": r["f32_control_snr_db"],
            "floor_snr_db": r["f32_floor_snr_db"],
            "bf16_ms": r["bf16_ms"], "bf16_plain_ms": r["bf16_plain_ms"],
            "bf16_bound_ms": r["bf16_bound"][0], "bf16_without_option_ms": base[base_key][1],
            "bf16_snr_db": r["bf16_snr_db"], "bf16_control_snr_db": r["bf16_control_snr_db"],
            "shape": r["shape"]})
    kernels[1]["op_dispatch_us"] = export["dispatch"]["per_op_us"]
    kernels[1]["new_shapes"]["9a step_chunk segment"] = kernel_line(phase9["chunk"]["kernel"])
    for k in kernels:
        # the DSS phases' and 6j's launches, by the kernel's name ("... (forward)" /
        # "(backward)" as fwd / bwd)
        key = k["name"].replace(" (forward)", " fwd").replace(" (backward)", " bwd")
        for phase, table in (("4l", launches_4l), ("6i", launches_6i), ("7c", launches_7c),
                             ("6j", launches_6j), ("4m", zoo["launches"]["4m"]),
                             ("6k", zoo["launches"]["6k"]), ("7d", zoo["launches"]["7d"]),
                             *launches_late.items()):
            k[f"launches_{phase}"] = table.get(key, 0)
            k["launches"] += table.get(key, 0)
        # phase 2l's launches hold each kernel against its plain version: counted
        # apart, not as launches of a main path
        k["launches_2l"] = zoo["launches"]["2l"].get(key, 0)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this test runs on an NVIDIA card only", file=sys.stderr)
        return 2
    return run(torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
